"""Per-task runtime context (counterpart of
``ray_tpu/_private/runtime_context.py``)."""

from __future__ import annotations

import contextvars
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

_ctx: contextvars.ContextVar = contextvars.ContextVar("ray_tpu_torch_ctx",
                                                      default=None)


@dataclass
class _TaskContext:
    job_id: Any = None
    task_id: Any = None
    node_id: Any = None
    actor_id: Any = None
    task_name: str = ""
    resources: Dict[str, float] = field(default_factory=dict)
    placement_group_id: Any = None
    pg_capture: bool = False  # placement_group_capture_child_tasks


def _set_context(**kwargs):
    return _ctx.set(_TaskContext(**kwargs))


def _reset_context(token) -> None:
    try:
        _ctx.reset(token)
    except ValueError:
        # context transfer across threads (async actor paths): best-effort
        _ctx.set(None)


class RuntimeContext:
    """User-facing view of the current execution context."""

    @property
    def _task_ctx(self) -> Optional[_TaskContext]:
        return _ctx.get()

    def _runtime(self):
        from ray_tpu_torch._private import worker
        return worker.global_worker()

    def get_job_id(self) -> str:
        return self._runtime().job_id.hex()

    def get_task_id(self) -> Optional[str]:
        c = self._task_ctx
        return c.task_id.hex() if c and c.task_id else None

    def get_task_name(self) -> Optional[str]:
        c = self._task_ctx
        return c.task_name if c else None

    def get_actor_id(self) -> Optional[str]:
        c = self._task_ctx
        return c.actor_id.hex() if c and c.actor_id else None

    def get_node_id(self) -> str:
        c = self._task_ctx
        if c and c.node_id:
            return c.node_id.hex()
        return self._runtime().head_node().node_id.hex()

    def get_assigned_resources(self) -> Dict[str, float]:
        c = self._task_ctx
        return dict(c.resources) if c else {}

    @property
    def namespace(self) -> str:
        return self._runtime().namespace

    @property
    def was_current_actor_reconstructed(self) -> bool:
        c = self._task_ctx
        if not (c and c.actor_id):
            return False
        info = self._runtime().gcs.get_actor_info(c.actor_id)
        return bool(info and info.num_restarts > 0)


def get_runtime_context() -> RuntimeContext:
    return RuntimeContext()
