"""Reusable daemon-thread work pool (counterpart of
``ray_tpu/_private/thread_pool.py``).

Per-task ``threading.Thread`` spawn costs ~1ms under GIL contention and
dominates small-task throughput; stdlib ThreadPoolExecutor
reuses threads but makes them non-daemon, so one blocked user task would
hang interpreter exit. This pool keeps the daemon-thread semantics of
the code it replaces: threads are reused when idle, spawned on demand up
to ``max_workers``, and die with the process.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable


class DaemonThreadPool:
    def __init__(self, max_workers: int, name: str = "pool"):
        self._q: "queue.SimpleQueue[Callable[[], None]]" = queue.SimpleQueue()
        self._max = max(1, max_workers)
        self._name = name
        self._lock = threading.Lock()
        self._count = 0
        self._idle = 0      # threads blocked in _q.get()
        self._pending = 0   # queued items not yet taken by a thread

    def submit(self, fn: Callable[[], None]) -> None:
        # Spawn when queued work exceeds waiting threads — comparing
        # pending against idle (not idle > 0) closes the TOCTOU where a
        # thread that just took a long task still counts as idle and the
        # new task would starve behind it. Stale counters only ever
        # over-spawn (bounded by _max), never under-spawn.
        with self._lock:
            self._pending += 1
            spawn = self._pending > self._idle and self._count < self._max
            if spawn:
                self._count += 1
                n = self._count
        self._q.put(fn)
        if spawn:
            threading.Thread(target=self._work, daemon=True,
                             name=f"{self._name}-{n}").start()

    def _work(self) -> None:
        try:
            while True:
                with self._lock:
                    self._idle += 1
                fn = self._q.get()
                with self._lock:
                    self._idle -= 1
                    self._pending = max(0, self._pending - 1)
                try:
                    fn()
                except BaseException:  # noqa: BLE001 — submitted fns own
                    # their errors; a KeyboardInterrupt delivered to user
                    # task code must not kill the pool thread
                    pass
        finally:
            # If this thread ever dies anyway, keep capacity honest so
            # the pool respawns instead of running under phantom count.
            with self._lock:
                self._count -= 1
