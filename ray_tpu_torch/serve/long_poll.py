"""Long-poll config propagation: push, not periodic pull (counterpart of
``ray_tpu/serve/long_poll.py``).

Reference: ``serve/_private/long_poll.py`` — ``LongPollHost`` (:222) holds
listeners' requests open and completes them the moment a key's snapshot
changes; ``LongPollClient`` (:70) keeps one in-flight listen per host and
applies updates via callbacks. This removes the staleness window of
poll-on-interval: a deploy/scale/death is visible to every router at
publish time + one actor-call latency.

Host side lives inside the ServeController actor (its ``max_concurrency``
bounds concurrently parked listens); client side is a daemon thread per
DeploymentHandle.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

LISTEN_TIMEOUT_S = 30.0  # parked listens return empty after this (keeps
                         # actor slots cycling; client listens again at once)


class LongPollHost:
    """Versioned key/snapshot store with blocking listens."""

    def __init__(self):
        self._cond = threading.Condition()
        self._state: Dict[str, Tuple[int, Any]] = {}

    def publish(self, key: str, snapshot: Any) -> None:
        with self._cond:
            version = self._state.get(key, (0, None))[0] + 1
            self._state[key] = (version, snapshot)
            self._cond.notify_all()

    def get(self, key: str) -> Optional[Any]:
        with self._cond:
            entry = self._state.get(key)
            return entry[1] if entry else None

    def listen(self, keys_to_versions: Dict[str, int],
               timeout_s: float = LISTEN_TIMEOUT_S) -> Dict[str, Any]:
        """Block until any watched key moves past the caller's version;
        returns {key: {"version": v, "snapshot": s}} for changed keys
        (empty dict on timeout — the client just re-listens)."""
        deadline = time.monotonic() + timeout_s
        with self._cond:
            while True:
                changed = {
                    key: {"version": v, "snapshot": snap}
                    for key, (v, snap) in self._state.items()
                    if key in keys_to_versions
                    and v > keys_to_versions[key]}
                if changed:
                    return changed
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return {}
                self._cond.wait(remaining)


class LongPollClient:
    """One daemon thread keeps a listen open against the host actor and
    applies snapshot updates through callbacks."""

    def __init__(self, host_actor,
                 key_callbacks: Dict[str, Callable[[Any, int], None]]):
        import weakref

        from ray_tpu_torch._private import worker
        # the runtime the host actor lives in: once it is gone, so is the
        # host, and a later runtime knows nothing of it
        self._runtime = weakref.ref(worker.global_runtime())
        self._host = host_actor
        self._callbacks = dict(key_callbacks)
        self._versions = {key: -1 for key in key_callbacks}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="serve-long-poll")
        self._thread.start()

    def _loop(self) -> None:
        import ray_tpu_torch
        from ray_tpu_torch._private import worker

        while not self._stop.is_set():
            if worker.global_runtime() is not self._runtime():
                return  # runtime shut down (or replaced) under us
            try:
                updates = ray_tpu_torch.get(
                    self._host.listen_for_change.remote(
                        dict(self._versions)),
                    timeout=LISTEN_TIMEOUT_S + 15)
            except Exception:
                if self._stop.wait(0.5):
                    return
                continue
            for key, update in updates.items():
                self._versions[key] = update["version"]
                try:
                    self._callbacks[key](update["snapshot"],
                                         update["version"])
                except Exception:
                    pass

    def stop(self) -> None:
        self._stop.set()
