"""Replica actor: hosts the user callable (counterpart of
``ray_tpu/serve/replica.py``; reference: `serve/_private/replica.py:918,1028`
ReplicaActor + UserCallableWrapper).

Runs with ``max_concurrency = max_ongoing_requests`` so concurrent
requests interleave; tracks ongoing/total counters that feed autoscaling.
"""

from __future__ import annotations

import inspect
import threading
import time
from typing import Any, Dict, Optional


class Replica:
    def __init__(self, func_or_class, init_args, init_kwargs,
                 user_config: Optional[Dict] = None,
                 report_to: Optional[str] = None,
                 deployment: Optional[str] = None,
                 slot: Optional[int] = None,
                 report_interval_s: float = 1.0):
        self._lock = threading.Lock()
        self._ongoing = 0
        self._total = 0
        self._user_config = user_config
        if inspect.isclass(func_or_class):
            self._callable = func_or_class(*init_args, **init_kwargs)
            if user_config is not None and hasattr(
                    self._callable, "reconfigure"):
                self._callable.reconfigure(user_config)
        else:
            self._callable = func_or_class
        # Push-based metrics (reference: autoscaling_state.py — replicas
        # REPORT running/queued counts; the controller never polls): a
        # reporter thread pushes ongoing/total to the named controller,
        # doubling as the liveness heartbeat for health checks.
        if report_to is not None:
            import ray_tpu_torch
            self._actor_id = ray_tpu_torch.get_runtime_context().get_actor_id()
            self._generation = self._own_restart_count()
            threading.Thread(
                target=self._report_loop,
                args=(report_to, deployment, slot,
                      max(0.1, report_interval_s)),
                daemon=True, name=f"replica-report-{deployment}-{slot}",
            ).start()

    def _actor_info(self):
        """This actor's GCS entry; None once the runtime that hosts it is
        gone (in one process, that runtime's actors are gone with it)."""
        from ray_tpu_torch._private import worker
        from ray_tpu_torch._private.ids import ActorID
        rt = worker.global_runtime()
        if rt is None:
            return None
        return rt.gcs.get_actor_info(ActorID.from_hex(self._actor_id))

    def _own_restart_count(self) -> Optional[int]:
        info = self._actor_info()
        return info.num_restarts if info is not None else None

    def _still_current(self) -> bool:
        """False once THIS incarnation's actor is dead or restarted —
        the instance's threads outlive an in-process actor kill, and a
        zombie heartbeat would keep a dead slot looking healthy (and the
        user callable, an LLM engine's weights among it, alive)."""
        from ray_tpu_torch._private.gcs import ActorState
        if self._actor_id is None:
            return True   # no identity available: report unconditionally
        info = self._actor_info()
        if info is None or info.state == ActorState.DEAD:
            return False
        if self._generation is None:
            # generation unknown at construction: state alone decides
            return True
        return info.num_restarts == self._generation

    def _report_loop(self, controller_name: str, deployment: str,
                     slot: int, interval: float) -> None:
        import ray_tpu_torch
        controller = None
        while True:
            time.sleep(interval)
            if not self._still_current():
                return
            try:
                if controller is None:
                    controller = ray_tpu_torch.get_actor(controller_name)
                controller.report_metrics.remote(
                    deployment, slot, self.metrics(),
                    actor_id=self._actor_id)
            except Exception:
                controller = None  # controller restarting: re-resolve

    def reconfigure(self, user_config: Dict) -> None:
        if hasattr(self._callable, "reconfigure"):
            self._callable.reconfigure(user_config)
        self._user_config = user_config

    def handle_request(self, method_name: str, args, kwargs) -> Any:
        with self._lock:
            self._ongoing += 1
            self._total += 1
        try:
            if method_name == "__call__":
                target = self._callable   # function, or instance __call__
            else:
                target = getattr(self._callable, method_name)
            return target(*args, **kwargs)
        finally:
            with self._lock:
                self._ongoing -= 1

    def handle_request_streaming(self, method_name: str, args, kwargs):
        """Generator variant (reference: replica.py:1028
        ``handle_request_streaming``): invoked with
        ``num_returns="streaming"`` so each yielded chunk is sealed as
        its own object and reported to the caller as it is produced —
        the consumer sees chunk 1 before the handler returns. A
        non-generator result degrades to a single-chunk stream."""
        with self._lock:
            self._ongoing += 1
            self._total += 1
        try:
            if method_name == "__call__":
                target = self._callable
            else:
                target = getattr(self._callable, method_name)
            result = target(*args, **kwargs)
            # Stream generators/iterators chunk-wise; any plain value —
            # including iterables like ndarray/list — stays ONE chunk.
            if inspect.isgenerator(result) or (
                    hasattr(result, "__next__")
                    and hasattr(result, "__iter__")):
                yield from result
            else:
                yield result
        finally:
            with self._lock:
                self._ongoing -= 1

    def metrics(self) -> Dict[str, float]:
        """Pushed to the controller by the reporter thread. ``ongoing``
        counts requests inside the replica; ``queue_depth`` is extra
        backlog the user callable reports through an optional
        ``queue_depth()`` method (e.g. an LLM engine's waiting queue —
        requests admitted but not yet holding a decode slot). The
        controller publishes ``ongoing + queue_depth`` to routers and
        feeds both to autoscaling."""
        with self._lock:
            ongoing, total = self._ongoing, self._total
        queue_depth = 0.0
        probe = getattr(self._callable, "queue_depth", None)
        if callable(probe):
            try:
                queue_depth = float(probe())
            except Exception:
                queue_depth = 0.0   # a broken probe must not kill reports
        return {"ongoing": ongoing, "total": total,
                "queue_depth": queue_depth, "ts": time.time()}

    def ping(self) -> bool:
        return True
