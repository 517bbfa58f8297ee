"""ObjectRef: a first-class handle to a (possibly not-yet-created) value
(counterpart of ``ray_tpu/_private/object_ref.py``).

Refs are created by ``put`` and by task submission; every live Python handle
holds a local reference that is released on ``__del__``; deserializing a ref
inside another value creates a borrowed reference. The reference counter
lives in :mod:`ray_tpu_torch._private.refcount`.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

from ray_tpu_torch._private.ids import ObjectID


class ObjectRef:
    """Handle to an immutable distributed value."""

    __slots__ = ("id", "_owner_hex", "_task_name", "_registered", "__weakref__")

    def __init__(self, object_id: ObjectID, owner_hex: str = "",
                 task_name: str = "", _register: bool = True):
        self.id = object_id
        self._owner_hex = owner_hex
        self._task_name = task_name
        self._registered = False
        if _register:
            self._add_local_ref()

    # -- refcounting hooks -------------------------------------------------
    def _add_local_ref(self):
        from ray_tpu_torch._private import worker
        rt = worker.global_runtime()
        if rt is not None:
            rt.refcounter.add_local_ref(self.id)
            self._registered = True

    def __del__(self):
        if not self._registered:
            return
        try:
            from ray_tpu_torch._private import worker
            rt = worker.global_runtime()
            if rt is not None:
                rt.refcounter.remove_local_ref(self.id)
        except Exception:  # interpreter teardown
            pass

    @staticmethod
    def _rehydrate(object_id: ObjectID, owner_hex: str) -> "ObjectRef":
        """Reconstruct a ref during deserialization (borrower side)."""
        return ObjectRef(object_id, owner_hex)

    # -- identity ----------------------------------------------------------
    def hex(self) -> str:
        return self.id.hex()

    def binary(self) -> bytes:
        return self.id.binary()

    def owner_hex(self) -> str:
        return self._owner_hex

    def task_name(self) -> str:
        return self._task_name

    def __hash__(self):
        return hash(self.id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other.id == self.id

    def __repr__(self):
        return f"ObjectRef({self.id.hex()})"

    def __reduce__(self):
        # borrowers re-register on rehydrate
        return (ObjectRef._rehydrate, (self.id, self._owner_hex))

    # -- await support -----------------------------------------------------
    def __await__(self):
        return self.as_future().__await__()

    def as_future(self):
        """Return an asyncio.Future resolved with the object's value."""
        import asyncio

        loop = asyncio.get_event_loop()
        fut = loop.create_future()

        def _resolve():
            from ray_tpu_torch._private import worker
            try:
                val = worker.global_worker().get([self])[0]
            except BaseException as e:  # noqa: BLE001 - propagate to future
                loop.call_soon_threadsafe(
                    lambda: fut.cancelled() or fut.set_exception(e))
            else:
                loop.call_soon_threadsafe(
                    lambda: fut.cancelled() or fut.set_result(val))

        threading.Thread(target=_resolve, daemon=True).start()
        return fut


class FutureTable:
    """Tracks completion events for in-flight objects.

    The execution side calls :meth:`complete` exactly once per object; waiters
    block in :meth:`wait_for`. Completion is sticky — late waiters return
    immediately.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._events: dict = {}
        self._done: set = set()
        self._callbacks: dict = {}

    def register(self, object_id: ObjectID) -> None:
        with self._lock:
            if object_id not in self._done:
                self._events.setdefault(object_id, threading.Event())

    def complete(self, object_id: ObjectID) -> None:
        with self._lock:
            self._done.add(object_id)
            ev = self._events.pop(object_id, None)
            cbs = self._callbacks.pop(object_id, [])
        if ev is not None:
            ev.set()
        for cb in cbs:
            try:
                cb(object_id)
            except Exception:
                pass    # one waiter's fault must not starve the others

    def reset(self, object_id: ObjectID) -> None:
        """Forget completion (object lost; reconstruction will re-complete)."""
        with self._lock:
            self._done.discard(object_id)
            self._events.setdefault(object_id, threading.Event())

    def is_done(self, object_id: ObjectID) -> bool:
        with self._lock:
            return object_id in self._done

    def add_done_callback(self, object_id: ObjectID,
                          cb: Callable[[ObjectID], None]) -> None:
        with self._lock:
            if object_id in self._done:
                fire = True
            else:
                fire = False
                self._callbacks.setdefault(object_id, []).append(cb)
        if fire:
            cb(object_id)

    def wait_for(self, object_id: ObjectID,
                 timeout: Optional[float] = None) -> bool:
        with self._lock:
            if object_id in self._done:
                return True
            ev = self._events.setdefault(object_id, threading.Event())
        return ev.wait(timeout)

    def wait_any(self, object_ids: List[ObjectID], num_returns: int,
                 timeout: Optional[float] = None) -> List[ObjectID]:
        """Block until >= num_returns of object_ids are done (or timeout)."""
        cond = threading.Condition()
        ready: List[ObjectID] = []
        seen = set()

        def on_done(oid):
            with cond:
                if oid not in seen:
                    seen.add(oid)
                    ready.append(oid)
                    cond.notify_all()

        for oid in object_ids:
            self.add_done_callback(oid, on_done)

        deadline = None if timeout is None else time.monotonic() + timeout
        with cond:
            while len(ready) < num_returns:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                cond.wait(remaining)
            return list(ready)
