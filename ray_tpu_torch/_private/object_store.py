"""Per-node object store with host and device tiers plus disk spilling
(counterpart of ``ray_tpu/_private/object_store.py``).

Immutable objects, size-accounted capacity, spill-to-disk under pressure with
transparent restore, per-object pinning while referenced.

- A **device tier**: values that are CUDA tensors (or lists, tuples and dicts
  holding one) stay resident in the card's memory and are handed to
  consumers zero-copy — the same storage, never serialized or copied through
  host memory. They do not count toward the host capacity and are never
  spilled. (JAX's package keeps ``jax.Array`` values there the same way.)
- Host-tier numpy payloads are stored as read-only views so consumers cannot
  mutate shared state.
- A **native tier** (``native_store`` flag, on by default, as in JAX's):
  each node's store opens a shared-memory arena (``native_store.py`` over
  ``csrc/shm_store.cc``, the plasma equivalent), parks contiguous numpy
  arrays of 64 KiB or more there, pinned, and hands out zero-copy read-only
  views whose finalizer releases the arena's ref. Where the arena is full,
  or the mount cannot back the object, the put takes the Python tier
  instead, as JAX's does on ``RTPU_ERR_FULL``.

In the one-process topology the arena holds the driver's arrays: no worker
attaches it (JAX's workers do so only under its daemons, through
``objectplane/``, which comes with them).
"""

from __future__ import annotations

import os
import pickle
import sys
import threading
import weakref
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, Optional

from ray_tpu_torch._private.ids import NodeID, ObjectID
from ray_tpu_torch.exceptions import OutOfMemoryError


# Values of these exact types need no deep walk.
_TRIVIAL_TYPES = (type(None), bool, int, float)


def _nbytes_of(value: Any) -> int:
    """Best-effort deep size estimate without serializing."""
    t = type(value)
    if t in _TRIVIAL_TYPES:
        # int is arbitrary-precision — getsizeof keeps a huge int honestly
        # accounted; the others are fixed-size
        return sys.getsizeof(value) if t is int else 32
    import numpy as np

    # a tensor can exist only once torch has been imported
    torch = sys.modules.get("torch")
    seen = set()

    def sz(v) -> int:
        vid = id(v)
        if vid in seen:
            return 0
        seen.add(vid)
        if isinstance(v, np.ndarray):
            return int(v.nbytes)
        if torch is not None and isinstance(v, torch.Tensor):
            return int(v.numel() * v.element_size())
        if isinstance(v, (bytes, bytearray, memoryview)):
            return len(v)
        if isinstance(v, str):
            return len(v)
        if isinstance(v, (list, tuple, set, frozenset)):
            return sys.getsizeof(v) + sum(sz(x) for x in v)
        if isinstance(v, dict):
            return sys.getsizeof(v) + sum(sz(k) + sz(x) for k, x in v.items())
        return sys.getsizeof(v, 64)

    return sz(value)


def _is_device_value(value: Any) -> bool:
    """True if the value is a CUDA tensor, or a list, tuple or dict (at any
    depth) that holds one."""
    if type(value) in _TRIVIAL_TYPES or isinstance(value, (str, bytes,
                                                           bytearray)):
        return False    # never a tensor; skip the walk
    torch = sys.modules.get("torch")
    if torch is None:
        return False    # no torch imported -> no tensor can exist
    stack = [value]
    while stack:
        v = stack.pop()
        if isinstance(v, torch.Tensor):
            if v.is_cuda:
                return True
        elif isinstance(v, (list, tuple)):
            stack.extend(v)
        elif isinstance(v, dict):
            stack.extend(v.values())
    return False


def _freeze_numpy(value: Any) -> Any:
    """Make top-level numpy arrays read-only (immutability guarantee)."""
    import numpy as np

    if isinstance(value, np.ndarray):
        v = value.view()
        v.flags.writeable = False
        return v
    return value


@dataclass
class ObjectEntry:
    value: Any
    nbytes: int
    device_tier: bool = False
    spilled_path: Optional[str] = None
    pinned: int = 0  # pin count: >0 means not spillable
    # native shm tier: (dtype, shape) of the array parked in the C++ store
    native_meta: Optional[tuple] = None
    # the explicit tier (host-shm | device-hbm | spilled): drives the
    # ray_tpu_object_store_bytes{tier} occupancy accounting
    tier: str = "host-shm"


# numpy arrays at least this large go to the native shm arena when built
NATIVE_TIER_MIN_BYTES = 64 * 1024


def _native_key(object_id: ObjectID) -> bytes:
    """The arena's key for an object: its hex id. The C store takes a
    NUL-terminated key, and a zero byte cuts a raw binary id short (JAX
    passes ``binary()``; ~1 random 20-byte id in 13 has one)."""
    return object_id.hex().encode()


def arena_name(node_id: NodeID) -> str:
    """The /dev/shm name of a node's arena: per process and node."""
    return f"rtpt_{os.getpid()}_{node_id.hex()[:8]}"


class LocalObjectStore:
    """Size-accounted object store for one (virtual) node."""

    def __init__(self, node_id: NodeID, capacity_bytes: int,
                 spill_dir: Optional[str] = None):
        self.node_id = node_id
        self.capacity_bytes = capacity_bytes
        self._spill_dir = spill_dir
        self._lock = threading.RLock()
        # insertion-ordered for LRU-ish spilling
        #: guarded by self._lock
        self._entries: "OrderedDict[ObjectID, ObjectEntry]" = OrderedDict()
        self._used = 0                  #: guarded by self._lock
        self.stats = {"puts": 0, "gets": 0, "spills": 0, "restores": 0,
                      "native_puts": 0}
        # (tier -> bytes) ledger chained into the process aggregate, which
        # feeds the ray_tpu_object_store_bytes{tier} gauge
        from ray_tpu_torch.objectplane.tiers import store_accounting
        self.tiers = store_accounting()
        # Outstanding zero-copy views into the native arena, per object.
        # The C++ store defers deallocation while refs are held; this
        # count decides whether close() may munmap (see close()).
        self._native_views: Dict[bytes, int] = {}
        # Native C++ shm tier: holds large numpy payloads as zero-copy mmap
        # views. Optional — absent without g++, or where the arena cannot
        # be mapped (the owner memory store's 2**62 bytes, as in JAX).
        self._native = None
        from ray_tpu_torch._private.config import cfg
        if cfg().native_store:
            try:
                from ray_tpu_torch.native_store import (ShmObjectStore,
                                                        available)
                if available():
                    self._native = ShmObjectStore(arena_name(node_id),
                                                  capacity_bytes)
            except Exception:
                self._native = None

    # -- basic ops ---------------------------------------------------------
    def put(self, object_id: ObjectID, value: Any,
            nbytes: Optional[int] = None) -> int:
        with self._lock:
            if object_id in self._entries:
                return self._entries[object_id].nbytes
            size = nbytes if nbytes is not None else _nbytes_of(value)
            device = _is_device_value(value)
            if not device:
                value = _freeze_numpy(value)
            if not device and size > self.capacity_bytes:
                raise OutOfMemoryError(
                    f"object of {size} bytes exceeds store capacity "
                    f"{self.capacity_bytes}")
            entry = ObjectEntry(value=value, nbytes=size, device_tier=device)
            if device:
                entry.tier = "device-hbm"
            if not device:
                native_meta = self._try_native_put(object_id, value, size)
                if native_meta is not None:
                    entry.value = None
                    entry.native_meta = native_meta
                    self.stats["native_puts"] += 1
                else:
                    self._ensure_space(size)
                    self._used += size
            self._entries[object_id] = entry
            self.tiers.add(entry.tier, size)
            self.stats["puts"] += 1
            return size

    def _try_native_put(self, object_id: ObjectID, value: Any,
                        size: int) -> Optional[tuple]:
        """Park a large contiguous numpy array in the C++ shm arena."""
        import numpy as np

        if (self._native is None or not isinstance(value, np.ndarray)
                or size < NATIVE_TIER_MIN_BYTES
                or value.dtype == object
                or not value.flags.c_contiguous):
            return None
        from ray_tpu_torch.native_store import ShmStoreFull
        try:
            # pin: this layer's refcounting owns lifetime; native LRU must
            # not evict behind our back (falls back to the Python tier and
            # disk spill when the arena is full)
            self._native.put(_native_key(object_id), value, pin=True)
            return (value.dtype, value.shape)
        except (ShmStoreFull, KeyError):
            return None

    def get(self, object_id: ObjectID) -> Any:
        with self._lock:
            entry = self._entries.get(object_id)
            if entry is None:
                raise KeyError(object_id)
            self._entries.move_to_end(object_id)
            if entry.spilled_path is not None:
                self._restore(object_id, entry)
            self.stats["gets"] += 1
            if entry.native_meta is not None:
                import numpy as np
                dtype, shape = entry.native_meta
                key = _native_key(object_id)
                # Zero-copy view; the native ref is held for the lifetime
                # of the returned array (released by a finalizer), so a
                # later delete() defers deallocation instead of freeing
                # memory user code still reads (plasma client semantics).
                view = self._native.get_view(key)  # increfs
                arr = np.frombuffer(view, dtype=dtype).reshape(shape)
                arr.flags.writeable = False
                self._native_views[key] = self._native_views.get(key, 0) + 1
                weakref.finalize(arr, self._release_native_view,
                                 self._native, key)
                return arr
            return entry.value

    def _release_native_view(self, native, key: bytes) -> None:
        """Finalizer for zero-copy native-tier arrays."""
        with self._lock:
            n = self._native_views.get(key, 0) - 1
            if n <= 0:
                self._native_views.pop(key, None)
            else:
                self._native_views[key] = n
            if native is self._native:
                native.release(key)

    def contains(self, object_id: ObjectID) -> bool:
        with self._lock:
            return object_id in self._entries

    def delete(self, object_id: ObjectID) -> None:
        with self._lock:
            entry = self._entries.pop(object_id, None)
            if entry is None:
                return
            if entry.spilled_path:
                try:
                    os.unlink(entry.spilled_path)
                except OSError:
                    pass    # already gone with the session's spill dir
            elif entry.native_meta is not None:
                self._native.delete(_native_key(object_id))
            elif not entry.device_tier:
                self._used -= entry.nbytes
            self.tiers.add(entry.tier, -entry.nbytes)

    def tier_bytes(self) -> Dict[str, int]:
        """Occupancy by (host-shm | device-hbm | spilled) tier."""
        return self.tiers.snapshot()

    def pin(self, object_id: ObjectID) -> None:
        with self._lock:
            e = self._entries.get(object_id)
            if e is not None:
                e.pinned += 1

    def unpin(self, object_id: ObjectID) -> None:
        with self._lock:
            e = self._entries.get(object_id)
            if e is not None and e.pinned > 0:
                e.pinned -= 1

    def nbytes_of(self, object_id: ObjectID) -> int:
        """Size cached on the entry at insert time (the same number the
        spill accounting uses) — never re-walks the value."""
        with self._lock:
            e = self._entries.get(object_id)
            return e.nbytes if e is not None else 0

    def used_bytes(self) -> int:
        with self._lock:
            return self._used

    def object_ids(self):
        with self._lock:
            return list(self._entries.keys())

    def clear(self) -> None:
        with self._lock:
            for oid in list(self._entries):
                self.delete(oid)

    def native_capacity(self) -> int:
        """The arena's bytes (0 without one)."""
        return self._native.capacity() if self._native is not None else 0

    def native_used_bytes(self) -> int:
        """Bytes the arena holds (outside ``used_bytes``, which counts the
        Python tier)."""
        native = self._native
        return native.used_bytes() if native is not None else 0

    def close(self) -> None:
        """Release the native shm arena (unlinks its /dev/shm segment).

        If zero-copy views are still held by user code, only the segment
        name is removed — the mapping is left alive so those arrays stay
        valid (munmap would SIGSEGV them)."""
        self.clear()
        with self._lock:
            native, self._native = self._native, None
            if native is not None:
                if self._native_views:
                    native.unlink_only()
                else:
                    native.close(unlink=True)

    # -- pressure handling -------------------------------------------------
    def _ensure_space(self, size: int) -> None:
        """Spill unpinned host-tier entries until ``size`` fits. Callers
        hold self._lock (re-entrant) and so does this: the spill scan must
        see a stable entry table."""
        with self._lock:
            if self._used + size <= self.capacity_bytes:
                return
            # spill least-recently-used spillable entries to disk; device
            # and native entries do not count toward _used (the C++ arena
            # accounts for the latter) and pinned ones are in use
            for oid, entry in list(self._entries.items()):
                if self._used + size <= self.capacity_bytes:
                    break
                if (entry.device_tier or entry.spilled_path is not None
                        or entry.native_meta is not None
                        or entry.pinned > 0):
                    continue
                if self._spill_dir is not None:
                    self._spill(oid, entry)
            if self._used + size > self.capacity_bytes:
                raise OutOfMemoryError(
                    f"object store on node {self.node_id.hex()[:8]} "
                    f"full: need {size}, used "
                    f"{self._used}/{self.capacity_bytes} "
                    f"and nothing left to spill")

    def _spill(self, object_id: ObjectID, entry: ObjectEntry) -> None:
        with self._lock:    # re-entrant: callers already hold it
            os.makedirs(self._spill_dir, exist_ok=True)
            path = os.path.join(self._spill_dir, object_id.hex())
            with open(path, "wb") as f:
                pickle.dump(entry.value, f, protocol=5)
            entry.spilled_path = path
            entry.value = None
            self._used -= entry.nbytes
            self.tiers.move(entry.tier, "spilled", entry.nbytes)
            entry.tier = "spilled"
            self.stats["spills"] += 1

    def _restore(self, object_id: ObjectID, entry: ObjectEntry) -> None:
        with self._lock:    # re-entrant: callers already hold it
            # Make room first, while the entry is still spilled: the scan
            # skips spilled entries, so it can never pick the one being
            # restored, and a failure here leaves the store untouched —
            # spill file intact, _used consistent, a later retry can
            # succeed once pressure drops.
            self._ensure_space(entry.nbytes)
            with open(entry.spilled_path, "rb") as f:
                entry.value = pickle.load(f)
            try:
                os.unlink(entry.spilled_path)
            except OSError:
                pass    # the value is back in memory either way
            entry.spilled_path = None
            self._used += entry.nbytes
            self.tiers.move("spilled", "host-shm", entry.nbytes)
            entry.tier = "host-shm"
            self.stats["restores"] += 1
