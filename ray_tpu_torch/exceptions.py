"""User-facing exception hierarchy (counterpart of ``ray_tpu/exceptions.py``).

Task errors wrap the remote traceback, actor errors carry their death cause,
and object loss is its own condition. The classes keep the reference's names
so that code written against ``ray_tpu`` catches the same errors here.
"""

from __future__ import annotations

import traceback
from typing import Optional


class RayTpuError(Exception):
    """Base class for all framework errors."""


class TaskError(RayTpuError):
    """A remote task raised an exception.

    Returned to ``get()`` callers; carries the remote traceback string so the
    caller sees the executing side's stack.
    """

    def __init__(self, cause: BaseException, task_name: str = "",
                 remote_traceback: Optional[str] = None):
        self.cause = cause
        self.task_name = task_name
        self.remote_traceback = remote_traceback or "".join(
            traceback.format_exception(type(cause), cause, cause.__traceback__)
        )
        super().__init__(
            f"Task {task_name or '<unknown>'} failed:\n{self.remote_traceback}"
        )

    def as_instanceof_cause(self) -> BaseException:
        """Return an exception that isinstance-matches the original cause."""
        cause_cls = type(self.cause)
        if cause_cls in (TaskError, ActorError):
            return self.cause
        try:
            class _Wrapped(TaskError, cause_cls):  # type: ignore[misc]
                def __init__(self, te: "TaskError"):
                    self.cause = te.cause
                    self.task_name = te.task_name
                    self.remote_traceback = te.remote_traceback
                    Exception.__init__(self, str(te))

            _Wrapped.__name__ = f"TaskError({cause_cls.__name__})"
            _Wrapped.__qualname__ = _Wrapped.__name__
            return _Wrapped(self)
        except TypeError:
            return self


class ActorError(TaskError):
    """An actor task failed because the actor is dead or dying."""

    def __init__(self, cause: BaseException, task_name: str = "",
                 actor_id=None, remote_traceback: Optional[str] = None):
        self.actor_id = actor_id
        super().__init__(cause, task_name, remote_traceback)


class ActorDiedError(RayTpuError):
    """The actor is dead; pending and future calls fail."""

    def __init__(self, actor_id=None, cause: str = "actor died"):
        self.actor_id = actor_id
        super().__init__(cause)


class ActorUnavailableError(RayTpuError):
    """The actor is temporarily unreachable (restarting)."""


class ObjectLostError(RayTpuError):
    """An object's value was lost from the store and could not be recovered."""

    def __init__(self, object_id=None, message: str = "object lost"):
        self.object_id = object_id
        super().__init__(message)


class ObjectReconstructionFailedError(ObjectLostError):
    """Lineage reconstruction was attempted but failed (e.g. retries exhausted)."""


class OwnerDiedError(ObjectLostError):
    """The owner of an object died, so the object is unrecoverable."""


class GetTimeoutError(RayTpuError, TimeoutError):
    """``get()`` exceeded its timeout."""


class TaskCancelledError(RayTpuError):
    """The task was cancelled before or during execution."""

    def __init__(self, task_id=None):
        self.task_id = task_id
        super().__init__("task was cancelled")


class PendingCallsLimitExceeded(RayTpuError):
    """Actor's max_pending_calls limit was hit."""


class RuntimeEnvSetupError(RayTpuError):
    """Runtime environment failed to materialize."""


class WorkerCrashedError(RayTpuError):
    """The worker executing the task died unexpectedly."""


class NodeDiedError(RayTpuError):
    """The node hosting the task died."""


class OutOfMemoryError(RayTpuError):
    """Object store or host memory exhausted."""


class MemoryPressureError(RayTpuError):
    """A node under hard memory pressure rejected a new object (retriable
    backpressure; raised by the object plane, which comes with the daemon
    topology)."""


class PlacementGroupUnschedulableError(RayTpuError):
    """The placement group cannot fit in the cluster."""


class AdmissionRejectedError(RayTpuError):
    """Admission control rejected the submit (raised by the multi-tenant
    fair-share layer)."""
