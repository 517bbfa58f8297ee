"""ctypes binding to the native shared-memory object store (counterpart of
``ray_tpu/native_store.py``).

Builds ``csrc/shm_store.cc`` on first use (g++, under
``build/ray_tpu_torch/``, keyed by the source's hash: ``_build.py``). Falls
back gracefully (``available() == False``) where no compiler exists —
callers keep the pure-Python tier.

Reference parity: plasma client API surface (create/seal/get/release/
delete, zero-copy buffers) — `src/ray/object_manager/plasma/client.h`.
Two handle kinds:

- **owner** (``ShmObjectStore(name, capacity)``): creates/initializes
  the segment, owns the metadata (allocator, LRU, object table);
- **attached** (``ShmObjectStore.attach(name)``): maps an existing
  segment by name (plasma's fd-passing role); may only read raw ranges,
  write into reserved ranges (direct put), and take/release the
  process-shared per-object refcounts in the segment's slot table.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np

_lib = None
_lib_lock = threading.Lock()


def _load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        from ray_tpu_torch._build import load_host_library
        lib = load_host_library("shm_store")
        if lib is None:
            return None
        lib.rtpu_store_open.restype = ctypes.c_void_p
        lib.rtpu_store_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.rtpu_store_attach.restype = ctypes.c_void_p
        lib.rtpu_store_attach.argtypes = [ctypes.c_char_p]
        lib.rtpu_store_close.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.rtpu_store_close.restype = None
        lib.rtpu_store_unlink.argtypes = [ctypes.c_void_p]
        lib.rtpu_store_unlink.restype = None
        lib.rtpu_store_base.restype = ctypes.c_void_p
        lib.rtpu_store_base.argtypes = [ctypes.c_void_p]
        lib.rtpu_store_capacity.restype = ctypes.c_uint64
        lib.rtpu_store_capacity.argtypes = [ctypes.c_void_p]
        lib.rtpu_store_used.restype = ctypes.c_uint64
        lib.rtpu_store_used.argtypes = [ctypes.c_void_p]
        lib.rtpu_store_num_objects.restype = ctypes.c_uint64
        lib.rtpu_store_num_objects.argtypes = [ctypes.c_void_p]
        u64p = ctypes.POINTER(ctypes.c_uint64)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        intp = ctypes.POINTER(ctypes.c_int)
        lib.rtpu_create.restype = ctypes.c_int
        lib.rtpu_create.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_uint64, u64p]
        lib.rtpu_seal.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.rtpu_stat.restype = ctypes.c_int
        lib.rtpu_stat.argtypes = [ctypes.c_void_p, ctypes.c_char_p, u64p,
                                  u64p, intp]
        lib.rtpu_pin.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.rtpu_get.restype = ctypes.c_int
        lib.rtpu_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p, u64p,
                                 u64p]
        lib.rtpu_ext_get.restype = ctypes.c_int
        lib.rtpu_ext_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     u64p, u64p, u32p]
        lib.rtpu_ext_release.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
        lib.rtpu_ext_release.restype = None
        # bulk decrement (crash reclamation)
        lib.rtpu_ext_release_n.restype = ctypes.c_uint32
        lib.rtpu_ext_release_n.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                                           ctypes.c_uint32]
        lib.rtpu_ext_refs.restype = ctypes.c_uint32
        lib.rtpu_ext_refs.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
        lib.rtpu_release.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.rtpu_contains.restype = ctypes.c_int
        lib.rtpu_contains.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.rtpu_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.rtpu_evict_bytes.restype = ctypes.c_uint64
        lib.rtpu_evict_bytes.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.rtpu_reap.restype = ctypes.c_uint64
        lib.rtpu_reap.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def available() -> bool:
    return _load() is not None


class ShmStoreFull(Exception):
    pass


class ShmObjectStore:
    """One shared-memory arena; objects are immutable byte buffers."""

    def __init__(self, name: str, capacity_bytes: int,
                 _handle: Optional[int] = None):
        lib = _load()
        if lib is None:
            raise RuntimeError("native store unavailable (no g++?)")
        self._lib = lib
        self.name = name
        if _handle is not None:         # attach() path
            self._handle = _handle
            self.attached = True
        else:
            self._handle = lib.rtpu_store_open(
                name.encode(), ctypes.c_uint64(capacity_bytes))
            self.attached = False
        if not self._handle:
            raise RuntimeError(f"shm_open failed for {name}")
        capacity = lib.rtpu_store_capacity(self._handle)
        base = lib.rtpu_store_base(self._handle)
        self._buf = (ctypes.c_char * capacity).from_address(base)
        self._capacity = capacity
        self._closed = False

    @classmethod
    def attach(cls, name: str) -> "ShmObjectStore":
        """Map an EXISTING arena by name (never creates). Attached
        handles read ranges, write reserved ranges, and manage slot
        refs — the segment's owner keeps all metadata."""
        lib = _load()
        if lib is None:
            raise RuntimeError("native store unavailable (no g++?)")
        handle = lib.rtpu_store_attach(name.encode())
        if not handle:
            raise RuntimeError(f"no arena named {name!r} to attach")
        return cls(name, 0, _handle=handle)

    # -- plasma-like client API -----------------------------------------
    def put(self, object_id: bytes, payload, pin: bool = False) -> None:
        """create + write + seal. With ``pin`` the creator's ref is kept:
        the object is not LRU-evictable until delete (used when a host
        refcounting layer owns the lifetime)."""
        payload = memoryview(payload).cast("B")
        size = payload.nbytes
        off = ctypes.c_uint64()
        rc = self._lib.rtpu_create(self._handle, object_id,
                                   ctypes.c_uint64(size),
                                   ctypes.byref(off))
        if rc == -3:
            raise KeyError(f"object {object_id!r} already exists")
        if rc != 0:
            # RTPU_ERR_FULL: no room in the arena, or the mount cannot
            # back the range (csrc/shm_store.cc's back_range)
            raise ShmStoreFull(
                f"cannot allocate {size} bytes (rc={rc})")
        dst = np.frombuffer(self._buf, np.uint8, count=size,
                            offset=off.value)
        dst[:] = np.frombuffer(payload, np.uint8)
        self._lib.rtpu_seal(self._handle, object_id)
        if pin:
            # Keep the creator ref and tell the store so that delete()
            # consumes it (instead of deferring deallocation forever).
            self._lib.rtpu_pin(self._handle, object_id)
        else:
            self._lib.rtpu_release(self._handle, object_id)

    def reserve(self, object_id: bytes, size: int) -> int:
        """Reserve an UNSEALED buffer and return its offset; the writer
        (possibly another process via an attached handle) fills the
        range and then seal()s. Idempotent: a retried reserve of an
        existing entry of the same size returns the original offset."""
        off = ctypes.c_uint64()
        rc = self._lib.rtpu_create(self._handle, object_id,
                                   ctypes.c_uint64(size),
                                   ctypes.byref(off))
        if rc == 0:
            return off.value
        if rc == -3:    # exists: idempotent retry of a lost reply
            size_c = ctypes.c_uint64()
            sealed = ctypes.c_int()
            rc2 = self._lib.rtpu_stat(self._handle, object_id,
                                      ctypes.byref(off),
                                      ctypes.byref(size_c),
                                      ctypes.byref(sealed))
            if rc2 == 0 and size_c.value == size:
                return off.value
            raise KeyError(f"object {object_id!r} already exists "
                           f"with different size")
        raise ShmStoreFull(f"cannot allocate {size} bytes (rc={rc})")

    def seal(self, object_id: bytes, pin: bool = True) -> None:
        """Seal a reserved buffer (idempotent). ``pin`` keeps the
        creator ref so the host refcounting layer owns lifetime,
        matching put(pin=True)."""
        rc = self._lib.rtpu_seal(self._handle, object_id)
        if rc != 0:
            raise KeyError(f"object {object_id!r} not in store (rc={rc})")
        if pin:
            self._lib.rtpu_pin(self._handle, object_id)
        else:
            self._lib.rtpu_release(self._handle, object_id)

    def stat(self, object_id: bytes) -> Tuple[int, int, bool]:
        """(offset, size, sealed) regardless of seal state."""
        off = ctypes.c_uint64()
        size = ctypes.c_uint64()
        sealed = ctypes.c_int()
        rc = self._lib.rtpu_stat(self._handle, object_id,
                                 ctypes.byref(off), ctypes.byref(size),
                                 ctypes.byref(sealed))
        if rc != 0:
            raise KeyError(f"object {object_id!r} not in store (rc={rc})")
        return off.value, size.value, bool(sealed.value)

    def get_view(self, object_id: bytes) -> np.ndarray:
        """Zero-copy read-only view into the shm arena (increfs)."""
        off = ctypes.c_uint64()
        size = ctypes.c_uint64()
        rc = self._lib.rtpu_get(self._handle, object_id,
                                ctypes.byref(off), ctypes.byref(size))
        if rc != 0:
            raise KeyError(f"object {object_id!r} not in store (rc={rc})")
        view = np.frombuffer(self._buf, np.uint8, count=size.value,
                             offset=off.value)
        view.flags.writeable = False
        return view

    def get_ref(self, object_id: bytes) -> Tuple[int, int]:
        """(offset, size) of the sealed object, holding a ref so the range
        stays valid until release(). A client of another process attaches
        the arena by name and reads the range directly."""
        off = ctypes.c_uint64()
        size = ctypes.c_uint64()
        rc = self._lib.rtpu_get(self._handle, object_id,
                                ctypes.byref(off), ctypes.byref(size))
        if rc != 0:
            raise KeyError(f"object {object_id!r} not in store (rc={rc})")
        return off.value, size.value

    def get_ext(self, object_id: bytes) -> Tuple[int, int, int]:
        """(offset, size, slot) with the object's PROCESS-SHARED slot
        refcount incremented on the caller's behalf: an attached client
        reads the range through its own mapping and drops the ref with
        ``ext_release(slot)`` — no store round trip, and LRU eviction is
        blocked until the slot count reaches zero. Raises KeyError when
        absent/unsealed/slotless (caller takes the blob path)."""
        off = ctypes.c_uint64()
        size = ctypes.c_uint64()
        slot = ctypes.c_uint32()
        rc = self._lib.rtpu_ext_get(self._handle, object_id,
                                    ctypes.byref(off), ctypes.byref(size),
                                    ctypes.byref(slot))
        if rc != 0:
            raise KeyError(f"object {object_id!r} has no ext ref "
                           f"(rc={rc})")
        return off.value, size.value, slot.value

    def ext_release(self, slot: int) -> None:
        if self._closed:
            return  # view finalizer racing close(): never touch a
            #         freed handle (the owner's reap tolerates the
            #         leaked count; a closed client is gone anyway)
        self._lib.rtpu_ext_release(self._handle, ctypes.c_uint32(slot))

    def ext_release_n(self, slot: int, n: int) -> int:
        """Drop up to ``n`` external refs from ``slot`` in one atomic op.

        Returns the count actually dropped (the slot floors at zero, so
        reclaiming a dead client's grants can never wrap the count or
        steal refs that were already released locally).
        """
        if self._closed or n <= 0:
            return 0
        return int(self._lib.rtpu_ext_release_n(
            self._handle, ctypes.c_uint32(slot), ctypes.c_uint32(n)))

    def ext_refs(self, slot: int) -> int:
        if self._closed:
            return 0
        return self._lib.rtpu_ext_refs(self._handle,
                                       ctypes.c_uint32(slot))

    def read_range(self, offset: int, size: int) -> memoryview:
        """Read-only view of raw arena bytes (attach-side of get_ref)."""
        view = np.frombuffer(self._buf, np.uint8, count=size, offset=offset)
        view.flags.writeable = False
        return memoryview(view)

    def view_range(self, offset: int, size: int) -> np.ndarray:
        """Read-only uint8 ndarray over raw arena bytes."""
        view = np.frombuffer(self._buf, np.uint8, count=size,
                             offset=offset)
        view.flags.writeable = False
        return view

    def write_range(self, offset: int, payload) -> None:
        """Fill a reserved (unsealed) range — the direct-put write."""
        payload = memoryview(payload).cast("B")
        size = payload.nbytes
        dst = np.frombuffer(self._buf, np.uint8, count=size,
                            offset=offset)
        dst[:] = np.frombuffer(payload, np.uint8)

    def release(self, object_id: bytes) -> None:
        self._lib.rtpu_release(self._handle, object_id)

    def contains(self, object_id: bytes) -> bool:
        return bool(self._lib.rtpu_contains(self._handle, object_id))

    def delete(self, object_id: bytes) -> None:
        self._lib.rtpu_delete(self._handle, object_id)

    def used_bytes(self) -> int:
        return self._lib.rtpu_store_used(self._handle)

    def capacity(self) -> int:
        return self._capacity

    def num_objects(self) -> int:
        return self._lib.rtpu_store_num_objects(self._handle)

    def evict(self, nbytes: int) -> int:
        return self._lib.rtpu_evict_bytes(self._handle,
                                          ctypes.c_uint64(nbytes))

    def reap(self) -> int:
        """Free deleted entries whose last (internal + external) ref is
        gone — external releases are silent atomic decrements, so the
        owner sweeps periodically."""
        return self._lib.rtpu_reap(self._handle)

    def close(self, unlink: bool = True) -> None:
        if not self._closed:
            self._closed = True
            self._lib.rtpu_store_close(self._handle, 1 if unlink else 0)

    def unlink_only(self) -> None:
        """Remove the /dev/shm name but keep the mapping alive: used at
        shutdown while zero-copy views into the arena are still held by
        user code (munmap would turn them into SIGSEGVs)."""
        if not self._closed:
            self._closed = True
            self._lib.rtpu_store_unlink(self._handle)

    def detach_leak(self) -> None:
        """Attached-handle shutdown while views may still be live:
        deliberately LEAK the mapping (and fd) so outstanding
        np.frombuffer views stay valid — munmap would turn them into
        SIGSEGVs and a freed handle would make a late view finalizer a
        use-after-free. The handle just stops answering."""
        self._closed = True
