"""Driver-side job context: which tenant owns the work being submitted
(counterpart of ``ray_tpu/tenancy/context.py``).

Resolution order for stamping ``TaskSpec.job_id`` at submit time:

1. an explicit :func:`job_context` scope (multi-job drivers — loadgen
   ``--jobs``, the job manager supervisor);
2. the executing task's own ``job_id`` from the runtime task context —
   this is what makes children of an actor task inherit the root job
   instead of falling back to the driver's ambient id;
3. the runtime's ambient ``job_id``.

Contextvars do not cross ``threading.Thread`` boundaries, so thread
pools that submit on behalf of a job must re-enter :func:`job_context`
per call (the loadgen multi-job runner wraps its per-request target).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Iterator, Optional

from ray_tpu_torch._private import runtime_context
from ray_tpu_torch._private.ids import JobID

_job_ctx: contextvars.ContextVar = contextvars.ContextVar(
    "ray_tpu_tenancy_job", default=None)


def _coerce(job_id: Any) -> JobID:
    if isinstance(job_id, JobID):
        return job_id
    if isinstance(job_id, bytes):
        return JobID(job_id)
    s = str(job_id)
    try:
        return JobID.from_hex(s)
    except ValueError:
        # human-readable tenant name ("tenant-a", "raysubmit_..."):
        # derive a stable JobID so the same name always maps to the
        # same tenant across drivers and restarts
        import hashlib
        return JobID(hashlib.blake2b(
            s.encode(), digest_size=JobID.SIZE).digest())


def canonical_job(job_id: Any):
    """``(canonical_hex, name)`` for any job designator: JobID / raw
    bytes / hex string pass through (name ``None``); a human-readable
    tenant name hashes to its stable hex and comes back as the name.
    Quota/weight APIs use this so ``set_quota("tenant-a", ...)`` keys
    the same ledger row that submits under ``job_context("tenant-a")``
    are stamped with."""
    jid = _coerce(job_id)
    name = None
    if not isinstance(job_id, (JobID, bytes)):
        s = str(job_id)
        if jid.hex() != s.lower():
            name = s
    return jid.hex(), name


@contextlib.contextmanager
def job_context(job_id: Any, weight: Optional[float] = None,
                runtime: Any = None) -> Iterator[JobID]:
    """Run a ``with`` block as tenant ``job_id``; submits inside stamp
    it. Registers the job (and optional weight) with the runtime's
    tenancy manager when one is active."""
    jid = _coerce(job_id)
    if runtime is None:
        from ray_tpu_torch._private import worker
        runtime = worker.global_runtime()
    ten = getattr(runtime, "tenancy", None)
    if ten is not None:
        name = None
        if not isinstance(job_id, (JobID, bytes)):
            name = str(job_id)
        ten.ensure_job(jid.hex(), weight=weight, name=name)
    token = _job_ctx.set(jid)
    try:
        yield jid
    finally:
        _job_ctx.reset(token)


def current_job_id(runtime: Any = None) -> Optional[JobID]:
    """The job the current code path is acting for (see module doc)."""
    jid = _job_ctx.get()
    if jid is not None:
        return jid
    task_ctx = runtime_context._ctx.get()
    if task_ctx is not None and task_ctx.job_id is not None:
        return task_ctx.job_id
    return getattr(runtime, "job_id", None)
