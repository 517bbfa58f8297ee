"""Pre-allocated shared-memory channels for compiled DAGs (counterpart of
``ray_tpu/dag/shm_channel.py``).

Reference capability: the accelerated-DAG mutable-object channels
(`src/ray/core_worker/experimental_mutable_object_manager.h:44`,
`python/ray/experimental/channel/shared_memory_channel.py`) — a fixed
shm buffer per DAG edge, written in place every execution, never
touching the object store or the RPC plane.

Protocol (single producer, single consumer, capacity 1 — the compiled
DAG executes in rounds, so depth-1 double-buffering is the reference's
shape too):

    header:  seq  u64 | ack  u64 | len  u64
    payload: [24, 24+capacity)

  write: wait seq == ack (previous value consumed) -> payload, len,
         then publish seq += 1
  read:  wait seq == ack + 1 -> value, then publish ack += 1

Both sides poll with spin-then-sleep backoff (the reference spins on a
seqno too); payload order is guaranteed by writing data before the seq
publish. Values are (status, value) tuples pickled by the port's wire
pickler (``device_objects.wire_dumps``: by value, tensors as host bytes)
so stage errors
propagate THROUGH the channel chain instead of deadlocking readers.
"""

from __future__ import annotations

import struct
import time
from multiprocessing import shared_memory
from typing import Any, Optional, Tuple

from ray_tpu_torch._private.device_objects import wire_dumps, wire_loads

_HDR = struct.Struct("<QQQ")          # seq, ack, len
HEADER_SIZE = _HDR.size
DEFAULT_CAPACITY = 1 << 20            # 1 MiB per edge

_TSO_ARCHS = ("x86_64", "AMD64", "i686", "x86")
_arch_warned = False


def _check_arch() -> None:
    """The lock-free publish order is only guaranteed under x86-TSO
    (the card's x86 hosts). Warn once elsewhere instead of silently
    racing."""
    global _arch_warned
    import platform
    if _arch_warned or platform.machine() in _TSO_ARCHS:
        return
    _arch_warned = True
    import warnings
    warnings.warn(
        f"shm channels assume x86-TSO store ordering; on "
        f"{platform.machine()} a reader may observe the seq bump "
        f"before the payload bytes", RuntimeWarning, stacklevel=3)


class ChannelClosed(Exception):
    pass


class ChannelFull(Exception):
    """Value exceeds the channel's pre-allocated capacity."""


class ShmChannel:
    """One DAG edge. ``create=True`` allocates and owns the segment;
    ``create=False`` attaches by name (the worker side)."""

    def __init__(self, name: Optional[str] = None, *,
                 capacity: int = DEFAULT_CAPACITY, create: bool = False):
        _check_arch()
        if create:
            self._shm = shared_memory.SharedMemory(
                create=True, size=HEADER_SIZE + capacity)
            self._shm.buf[:HEADER_SIZE] = b"\x00" * HEADER_SIZE
        else:
            self._shm = shared_memory.SharedMemory(name=name)
        self.capacity = len(self._shm.buf) - HEADER_SIZE
        self._owner = create

    @property
    def name(self) -> str:
        return self._shm.name

    # -- header accessors -------------------------------------------------
    # Memory-model note: the seq/ack protocol publishes payload+len
    # BEFORE bumping seq (slot 0) and relies on CPython's byte-store
    # ordering plus x86-TSO for the reader to observe them in that
    # order. On weakly-ordered hosts (ARM) a reader could in principle
    # see the new seq before the payload bytes; the card's hosts are x86, so
    # this is asserted at import in _check_arch() rather than paying a
    # lock per message on the hot path.
    def _get(self, idx: int) -> int:
        return struct.unpack_from("<Q", self._shm.buf, idx * 8)[0]

    def _set(self, idx: int, value: int) -> None:
        struct.pack_into("<Q", self._shm.buf, idx * 8, value)

    # -- data plane -------------------------------------------------------
    def _wait(self, cond, stop=None,
              timeout: Optional[float] = 300.0) -> None:
        """``timeout=None`` waits forever (idle DAG loops gate on the
        stop event alone)."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        spins = 0
        while not cond():
            if stop is not None and stop.is_set():
                raise ChannelClosed("channel stopped")
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError("shm channel wait timed out")
            spins += 1
            if spins < 200:
                continue              # brief spin: same-round handoff
            time.sleep(0.0005 if spins < 2000 else 0.002)

    def write(self, status: str, value: Any, *, stop=None,
              timeout: float = 300.0) -> None:
        blob = wire_dumps((status, value))
        if len(blob) > self.capacity:
            raise ChannelFull(
                f"value of {len(blob)} bytes exceeds channel capacity "
                f"{self.capacity}; recompile with a larger "
                f"buffer_size_bytes")
        self._wait(lambda: self._get(0) == self._get(1), stop=stop,
                   timeout=timeout)
        self._shm.buf[HEADER_SIZE:HEADER_SIZE + len(blob)] = blob
        self._set(2, len(blob))
        self._set(0, self._get(0) + 1)     # publish

    def read(self, *, stop=None, timeout: float = 300.0
             ) -> Tuple[str, Any]:
        self._wait(lambda: self._get(0) == self._get(1) + 1, stop=stop,
                   timeout=timeout)
        n = self._get(2)
        status, value = wire_loads(
            bytes(self._shm.buf[HEADER_SIZE:HEADER_SIZE + n]))
        self._set(1, self._get(1) + 1)     # consume
        return status, value

    # -- lifecycle --------------------------------------------------------
    def close(self) -> None:
        try:
            self._shm.close()
        except Exception:
            pass

    def unlink(self) -> None:
        if self._owner:
            try:
                self._shm.unlink()
            except Exception:
                pass
