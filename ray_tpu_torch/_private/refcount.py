"""Reference counting and lineage tracking (counterpart of
``ray_tpu/_private/refcount.py``).

An object stays alive while any of these hold: local Python handles, pending
tasks that take it as an argument, or nested containment inside another live
object. When the count reaches zero the value is freed from every store and
its lineage entry released. Lineage (the task that produced each object) is
kept while the object is alive, so that a lost object can be recomputed.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Set

from ray_tpu_torch._private.ids import ObjectID


@dataclass
class Reference:
    local_refs: int = 0
    submitted_task_refs: int = 0
    # objects whose stored value contains this one (containment pins)
    contained_in: Set[ObjectID] = field(default_factory=set)
    contains: Set[ObjectID] = field(default_factory=set)
    # never collect (e.g. detached-actor state, named objects)
    pinned: bool = False

    def total(self) -> int:
        return (self.local_refs + self.submitted_task_refs
                + len(self.contained_in) + (1 if self.pinned else 0))


class ReferenceCounter:
    def __init__(self, on_zero: Optional[Callable[[ObjectID], None]] = None):
        self._lock = threading.RLock()
        self._refs: Dict[ObjectID, Reference] = {}  #: guarded by self._lock
        self._on_zero = on_zero
        # Per-thread deferral queue: freeing an object can drop values whose
        # ObjectRef.__del__ re-enters this counter from inside on_zero (and
        # from inside store/lineage locks). Cascaded decrements are queued
        # and drained iteratively by the outermost call — no recursion, no
        # lock re-entry.
        self._tls = threading.local()

    def set_on_zero(self, cb: Callable[[ObjectID], None]) -> None:
        self._on_zero = cb

    def _get(self, oid: ObjectID) -> Reference:
        with self._lock:
            ref = self._refs.get(oid)
            if ref is None:
                ref = self._refs[oid] = Reference()
            return ref

    # -- local handles -----------------------------------------------------
    def add_local_ref(self, oid: ObjectID) -> None:
        with self._lock:
            self._get(oid).local_refs += 1

    def remove_local_ref(self, oid: ObjectID) -> None:
        self._dec(oid, "local_refs")

    # -- task argument pins ------------------------------------------------
    def add_submitted_task_refs(self, oids: List[ObjectID]) -> None:
        with self._lock:
            for oid in oids:
                self._get(oid).submitted_task_refs += 1

    def remove_submitted_task_refs(self, oids: List[ObjectID]) -> None:
        """Drop one submitted-task pin per listed oid, the whole batch under
        one lock acquisition; frees cascade outside the lock through the
        same deferral queue as single decrements."""
        pending = getattr(self._tls, "pending", None)
        if pending is not None:     # nested call: defer to outermost
            pending.extend((oid, "submitted_task_refs") for oid in oids)
            return
        self._tls.pending = pending = []
        try:
            zeroed: List[ObjectID] = []
            with self._lock:
                for oid in oids:
                    ref = self._refs.get(oid)
                    if ref is None:
                        continue
                    if ref.submitted_task_refs > 0:
                        ref.submitted_task_refs -= 1
                    if ref.total() == 0 and oid not in zeroed:
                        # a duplicated oid in the batch zeroes once
                        zeroed.append(oid)
            for oid in zeroed:
                self._maybe_free(oid)
            while pending:
                nxt_oid, nxt_attr = pending.pop(0)
                self._dec_now(nxt_oid, nxt_attr)
        finally:
            self._tls.pending = None

    # -- containment (nested refs inside stored values) --------------------
    def add_nested_refs(self, outer: ObjectID, inner: List[ObjectID]) -> None:
        with self._lock:
            for oid in inner:
                self._get(oid).contained_in.add(outer)
                self._get(outer).contains.add(oid)

    # -- pinning -----------------------------------------------------------
    def pin(self, oid: ObjectID) -> None:
        with self._lock:
            self._get(oid).pinned = True

    def unpin(self, oid: ObjectID) -> None:
        with self._lock:
            ref = self._refs.get(oid)
            if ref is None or not ref.pinned:
                return
            ref.pinned = False
        self._maybe_free(oid)

    # -- internals ---------------------------------------------------------
    def _dec(self, oid: ObjectID, attr: str) -> None:
        pending = getattr(self._tls, "pending", None)
        if pending is not None:     # nested call: defer to outermost frame
            pending.append((oid, attr))
            return
        self._tls.pending = pending = []
        try:
            self._dec_now(oid, attr)
            while pending:
                nxt_oid, nxt_attr = pending.pop(0)
                self._dec_now(nxt_oid, nxt_attr)
        finally:
            self._tls.pending = None

    def _dec_now(self, oid: ObjectID, attr: str) -> None:
        with self._lock:
            ref = self._refs.get(oid)
            if ref is None:
                return
            cur = getattr(ref, attr)
            if cur > 0:
                setattr(ref, attr, cur - 1)
        self._maybe_free(oid)

    def _maybe_free(self, oid: ObjectID) -> None:
        to_free: List[ObjectID] = []
        with self._lock:
            ref = self._refs.get(oid)
            if ref is None or ref.total() > 0:
                return
            del self._refs[oid]
            to_free.append(oid)
            # release containment pins held by this object
            stack = list(ref.contains)
            while stack:
                inner_id = stack.pop()
                inner = self._refs.get(inner_id)
                if inner is None:
                    continue
                inner.contained_in.discard(oid)
                if inner.total() == 0:
                    del self._refs[inner_id]
                    to_free.append(inner_id)
                    stack.extend(inner.contains)
        if self._on_zero is not None:
            for freed in to_free:
                try:
                    self._on_zero(freed)
                except Exception:
                    pass    # a failed free must not stop the others

    def ref_count(self, oid: ObjectID) -> int:
        with self._lock:
            ref = self._refs.get(oid)
            return 0 if ref is None else ref.total()

    def num_tracked(self) -> int:
        with self._lock:
            return len(self._refs)


class LineageTable:
    """object → producing-task map used for reconstruction after loss."""

    def __init__(self, max_entries: int = 1_000_000):
        self._lock = threading.Lock()
        #: guarded by self._lock
        self._producers: Dict[ObjectID, Any] = {}  # oid -> TaskSpec
        self._max_entries = max_entries

    def record(self, return_ids: List[ObjectID], spec: Any) -> None:
        with self._lock:
            if len(self._producers) >= self._max_entries:
                return  # lineage cap
            for oid in return_ids:
                self._producers[oid] = spec

    def producer_of(self, oid: ObjectID) -> Optional[Any]:
        with self._lock:
            return self._producers.get(oid)

    def release(self, oid: ObjectID) -> None:
        with self._lock:
            spec = self._producers.pop(oid, None)
        # The spec's arg ObjectRefs are dropped outside the lock: their
        # __del__ can cascade back into refcounting/lineage.
        del spec

    def num_entries(self) -> int:
        with self._lock:
            return len(self._producers)
