"""``@serve.batch`` dynamic batching (counterpart of
``ray_tpu/serve/batching.py``; reference: `serve/batching.py:104` —
queue requests, flush at max_batch_size or batch_wait_timeout_s, fan
results back out). Thread-based here because replicas execute requests on
a thread pool (max_concurrency), not an asyncio loop."""

from __future__ import annotations

import functools
import threading
from typing import Any, Callable, List, Optional


class _BatchQueue:
    def __init__(self, fn: Callable[[List[Any]], List[Any]],
                 max_batch_size: int, timeout_s: float):
        self.fn = fn
        self.max_batch_size = max_batch_size
        self.timeout_s = timeout_s
        self._lock = threading.Lock()
        self._items: List[Any] = []
        self._events: List[threading.Event] = []
        self._results: List[Any] = []
        self._flusher: Optional[threading.Timer] = None

    def submit(self, item: Any) -> Any:
        ev = threading.Event()
        to_run = None
        with self._lock:
            self._items.append(item)
            self._events.append(ev)
            if len(self._items) >= self.max_batch_size:
                to_run = self._take_locked()
            elif self._flusher is None:
                self._flusher = threading.Timer(self.timeout_s, self._flush)
                self._flusher.daemon = True
                self._flusher.start()
        if to_run is not None:   # run the user fn OUTSIDE the lock
            self._run_batch(*to_run)
        ev.wait()
        return ev.result

    def _take_locked(self):
        items, events = self._items, self._events
        self._items, self._events = [], []
        if self._flusher is not None:
            self._flusher.cancel()
            self._flusher = None
        return items, events

    def _flush(self):
        with self._lock:
            if not self._items:
                self._flusher = None
                return
            items, events = self._take_locked()
        self._run_batch(items, events)

    def _run_batch(self, items, events):
        try:
            results = self.fn(items)
            if len(results) != len(items):
                raise ValueError(
                    f"@serve.batch fn returned {len(results)} results for "
                    f"{len(items)} inputs")
        except Exception as e:
            results = [e] * len(items)
        for ev, res in zip(events, results):
            ev.result = res
            ev.set()


def batch(_fn=None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01):
    """Decorator: the wrapped fn receives a LIST of inputs and must return
    a list of outputs; callers invoke it with single items."""
    def wrap(fn):
        queues = {}
        qlock = threading.Lock()

        @functools.wraps(fn)
        def wrapper(*args):
            # methods: (self, item); functions: (item,)
            if len(args) == 2:
                owner, item = args
                key = id(owner)
                call = lambda items: fn(owner, items)  # noqa: E731
            elif len(args) == 1:
                item = args[0]
                key = None
                call = fn
            else:
                raise TypeError("@serve.batch methods take one argument")
            with qlock:
                q = queues.get(key)
                if q is None:
                    q = queues[key] = _BatchQueue(
                        call, max_batch_size, batch_wait_timeout_s)
            out = q.submit(item)
            if isinstance(out, Exception):
                raise out
            return out
        return wrapper
    if _fn is not None:
        return wrap(_fn)
    return wrap
