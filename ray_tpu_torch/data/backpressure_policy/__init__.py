"""Streaming-executor backpressure policies (counterpart of
``ray_tpu/data/backpressure_policy/__init__.py``, the same code over the
port's runtime: its nodes' object stores report used bytes and capacity).

Reference: ``data/_internal/execution/backpressure_policy/`` — pluggable
policies consulted by the scheduling loop before admitting new work to an
operator (``ConcurrencyCapBackpressurePolicy``,
``StreamingOutputBackpressurePolicy``); plus a store-usage policy that
throttles UPSTREAM operators when the object store fills, so the pipeline
drains instead of spilling (the role of the reference's resource-manager
budgets in ``streaming_executor_state.py``).

A policy's ``can_launch(op, executor)`` returns False to veto launching
one more task on ``op`` this tick.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, List

if TYPE_CHECKING:
    from ray_tpu_torch.data.execution import PhysicalOperator, StreamingExecutor


class BackpressurePolicy:
    def can_launch(self, op: "PhysicalOperator",
                   executor: "StreamingExecutor") -> bool:
        return True


class ConcurrencyCapBackpressurePolicy(BackpressurePolicy):
    """At most ``max_in_flight`` concurrent tasks per operator."""

    def can_launch(self, op, executor) -> bool:
        return len(op.active) < op.max_in_flight


class StreamingOutputBackpressurePolicy(BackpressurePolicy):
    """Bound each operator's output queue: a slow consumer stalls its
    producer instead of buffering unboundedly."""

    def can_launch(self, op, executor) -> bool:
        return (len(op.outqueue) + len(op.active)
                < executor.max_out_queue)


class ObjectStoreMemoryBackpressurePolicy(BackpressurePolicy):
    """Throttle upstream work when the cluster object stores pass a
    usage fraction: only the most-downstream runnable operator may launch
    (draining makes room; reading makes pressure)."""

    def __init__(self, threshold: float = 0.8):
        self.threshold = threshold

    def _store_pressure(self) -> float:
        from ray_tpu_torch._private import worker

        rt = worker.global_runtime()
        if rt is None:
            return 0.0
        used = cap = 0
        for node in rt.alive_nodes():
            store = node.store
            try:
                used += store.used_bytes()
                cap += getattr(store, "capacity_bytes", 0)
            except Exception:
                continue
        return used / cap if cap else 0.0

    def can_launch(self, op, executor) -> bool:
        if self._store_pressure() < self.threshold:
            return True
        # under pressure: permit only the most-downstream op with input
        for candidate in reversed(executor.ops):
            if candidate.inqueue and len(candidate.active) \
                    < candidate.max_in_flight:
                return candidate is op
        return True


def default_policies() -> List[BackpressurePolicy]:
    from ray_tpu_torch.data.context import DataContext

    ctx = DataContext.get_current()
    threshold = getattr(ctx, "object_store_backpressure_threshold", 0.8)
    return [ConcurrencyCapBackpressurePolicy(),
            StreamingOutputBackpressurePolicy(),
            ObjectStoreMemoryBackpressurePolicy(threshold)]
