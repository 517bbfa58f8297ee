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

The reference's native shared-memory tier comes with the daemon topology;
here every host value lives in this process's dict.
"""

from __future__ import annotations

import os
import pickle
import sys
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Optional

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
        self.stats = {"puts": 0, "gets": 0, "spills": 0, "restores": 0}

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
            if not device:
                self._ensure_space(size)
                self._used += size
            self._entries[object_id] = entry
            self.stats["puts"] += 1
            return size

    def get(self, object_id: ObjectID) -> Any:
        with self._lock:
            entry = self._entries.get(object_id)
            if entry is None:
                raise KeyError(object_id)
            self._entries.move_to_end(object_id)
            if entry.spilled_path is not None:
                self._restore(object_id, entry)
            self.stats["gets"] += 1
            return entry.value

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
            elif not entry.device_tier:
                self._used -= entry.nbytes

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

    def close(self) -> None:
        self.clear()

    # -- pressure handling -------------------------------------------------
    def _ensure_space(self, size: int) -> None:
        """Spill unpinned host-tier entries until ``size`` fits. Callers
        hold self._lock (re-entrant) and so does this: the spill scan must
        see a stable entry table."""
        with self._lock:
            if self._used + size <= self.capacity_bytes:
                return
            # spill least-recently-used spillable entries to disk; device
            # entries do not count toward _used and pinned ones are in use
            for oid, entry in list(self._entries.items()):
                if self._used + size <= self.capacity_bytes:
                    break
                if (entry.device_tier or entry.spilled_path is not None
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
            self.stats["restores"] += 1
