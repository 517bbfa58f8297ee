"""ctypes surface over the port's native C++ wire client (counterpart of
``ray_tpu/cpp_client.py``).

``csrc/cpp_client.cc`` speaks the port's RPC wire directly (the head's KV,
a daemon's object plane, ``daemon_ping`` and the cross-language calls of
``ray_tpu_torch.xlang``); this module is the loader and a pythonic wrapper
that tests use to prove cross-language interop: bytes written by Python
read back by C++, and the reverse. The cross-language arguments and
results are the wire's own frame encoding (``rpc.dumps_frame`` and
``rpc.loads_frame``; JAX's are msgpack).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

from ray_tpu_torch._private import rpc

_lib = None
_lib_lock = threading.Lock()


def _load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        from ray_tpu_torch._build import load_host_library
        lib = load_host_library("cpp_client")
        if lib is None:
            return None
        vp, cp, i, i64 = (ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
                          ctypes.c_int64)
        out = [ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
               ctypes.POINTER(i64)]
        for name, restype, argtypes in (
                ("rtc_connect", vp, [cp, i]),
                ("rtc_close", None, [vp]),
                ("rtc_free", None, [vp]),
                ("rtc_kv_put", i, [vp, cp, i, cp, i]),
                ("rtc_kv_get", i, [vp, cp, i, *out]),
                ("rtc_put_object", i, [vp, cp, i, cp, i64]),
                ("rtc_get_object", i, [vp, cp, i, *out]),
                ("rtc_ping", ctypes.c_long, [vp]),
                ("rtc_submit_task", i, [vp, cp, cp, i, *out]),
                ("rtc_create_actor", i, [vp, cp, cp, cp, i]),
                ("rtc_call_actor", i, [vp, cp, cp, cp, i, *out]),
                ("rtc_last_error", cp, [vp]),
                ("rtc_frame_encode_test", i, [i64, *out]),
                ("rtc_frame_roundtrip", i, [cp, i64, *out])):
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = lib
        return _lib


def _library():
    lib = _load()
    if lib is None:
        raise RuntimeError("native cpp client unavailable (no g++)")
    return lib


def _call_out(fn, *args) -> Tuple[int, bytes]:
    """Call an ``rtc_*`` function whose last two arguments are an output
    buffer and its length; returns (rc, the buffer's bytes)."""
    out = ctypes.POINTER(ctypes.c_uint8)()
    n = ctypes.c_int64()
    rc = fn(*args, ctypes.byref(out), ctypes.byref(n))
    if not out:
        return rc, b""
    try:
        return rc, ctypes.string_at(out, n.value)
    finally:
        _library().rtc_free(out)


def frame_encode_test(n_blob: int) -> bytes:
    """The C++ writer's pickle of its fixed test value (``n_blob`` bytes of
    ``Z`` under ``"blob"``)."""
    lib = _library()
    return _call_out(lib.rtc_frame_encode_test, n_blob)[1]


def frame_roundtrip(blob: bytes) -> bytes:
    """Decode ``blob`` in C++ and encode the value again; raises ValueError
    with the decoder's reason on a refused pickle."""
    lib = _library()
    rc, out = _call_out(lib.rtc_frame_roundtrip, blob, len(blob))
    if rc != 0:
        raise ValueError(out.decode(errors="replace"))
    return out


class CppClient:
    """One native TCP connection to a head or a daemon."""

    def __init__(self, addr: Tuple[str, int]):
        self._lib = _library()
        self._h = self._lib.rtc_connect(addr[0].encode(), int(addr[1]))
        if not self._h:
            raise ConnectionError(f"cpp client: connect to {addr} failed")

    def _handle(self):
        if not self._h:
            raise ValueError("cpp client is closed")
        return self._h

    # head KV ------------------------------------------------------------
    def kv_put(self, key: bytes, value: bytes) -> None:
        rc = self._lib.rtc_kv_put(self._handle(), key, len(key), value,
                                  len(value))
        if rc != 0:
            raise IOError(self.last_error())

    def kv_get(self, key: bytes) -> Optional[bytes]:
        rc, out = _call_out(self._lib.rtc_kv_get, self._handle(), key,
                            len(key))
        if rc == 1:
            return None
        if rc != 0:
            raise IOError(self.last_error())
        return out

    # daemon object plane -------------------------------------------------
    def put_object(self, oid: bytes, blob) -> None:
        blob = bytes(blob)
        rc = self._lib.rtc_put_object(self._handle(), oid, len(oid), blob,
                                      len(blob))
        if rc != 0:
            raise IOError(self.last_error())

    def get_object(self, oid: bytes) -> Optional[bytes]:
        rc, out = _call_out(self._lib.rtc_get_object, self._handle(), oid,
                            len(oid))
        if rc == 1:
            return None
        if rc != 0:
            raise IOError(self.last_error())
        return out

    def ping(self) -> int:
        pid = self._lib.rtc_ping(self._handle())
        if pid < 0:
            raise IOError(self.last_error())
        return int(pid)

    # cross-language tasks and actors (daemon) ----------------------------
    # Python exports by name (ray_tpu_torch.xlang); the native library
    # speaks the whole protocol; this wrapper only encodes the arguments
    # and decodes the result.
    def _xlang_out(self, rc: int, out: bytes):
        if rc == -1:
            raise IOError(self.last_error())
        if rc == 1:
            raise RuntimeError(out.decode(errors="replace"))
        return rpc.loads_frame(out)

    def submit_task(self, name: str, *args):
        blob = rpc.dumps_frame(list(args))
        return self._xlang_out(*_call_out(
            self._lib.rtc_submit_task, self._handle(), name.encode(), blob,
            len(blob)))

    def create_actor(self, cls_name: str, actor_name: str, *args) -> None:
        blob = rpc.dumps_frame(list(args))
        rc = self._lib.rtc_create_actor(self._handle(), cls_name.encode(),
                                        actor_name.encode(), blob,
                                        len(blob))
        if rc == -1:
            raise IOError(self.last_error())
        if rc == 1:
            raise RuntimeError(self.last_error())

    def call_actor(self, actor_name: str, method: str, *args):
        blob = rpc.dumps_frame(list(args))
        return self._xlang_out(*_call_out(
            self._lib.rtc_call_actor, self._handle(), actor_name.encode(),
            method.encode(), blob, len(blob)))

    def last_error(self) -> str:
        return self._lib.rtc_last_error(self._h).decode(errors="replace")

    def close(self) -> None:
        if self._h:
            self._lib.rtc_close(self._h)
            self._h = None
