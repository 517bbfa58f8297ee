"""Per-job quotas: hard/soft caps over the schedulable resource axes
(counterpart of ``ray_tpu/tenancy/quota.py``; the card's axis is ``GPU``
where JAX's is ``TPU``, as in ``_private/task_spec.py``).

A *hard* cap is enforced at dispatch: a job at its cap has further
tasks held in the node backlog (verdict QUEUED) until its own releases
free headroom. A *soft* cap only demotes the job's placement (spread
instead of pack) and its deficit priority — work still runs when the
cluster is idle. ``object_store_bytes`` is accounted driver-side at
``put()`` time and checked at admission rather than at dispatch (the
dispatch ledger deals in task resource vectors, not object payloads).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

#: the quota axes; "memory" and "object_store_bytes" are byte counts,
#: CPU/GPU are slot counts (same units as TaskSpec.resources).
QUOTA_RESOURCES = ("CPU", "GPU", "memory", "object_store_bytes")


def _clean(caps: Optional[Dict[str, float]]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for key, val in (caps or {}).items():
        if key not in QUOTA_RESOURCES:
            raise ValueError(
                f"unknown quota resource {key!r}; "
                f"expected one of {QUOTA_RESOURCES}")
        out[key] = float(val)
    return out


@dataclass
class JobQuota:
    """Caps for one job. Missing keys mean unlimited."""

    hard: Dict[str, float] = field(default_factory=dict)
    soft: Dict[str, float] = field(default_factory=dict)

    def __post_init__(self) -> None:
        self.hard = _clean(self.hard)
        self.soft = _clean(self.soft)

    def hard_cap(self, resource: str) -> Optional[float]:
        return self.hard.get(resource)

    def soft_cap(self, resource: str) -> Optional[float]:
        return self.soft.get(resource)

    def to_wire(self) -> Dict[str, Any]:
        return {"hard": dict(self.hard), "soft": dict(self.soft)}

    @classmethod
    def from_wire(cls, wire: Optional[Dict[str, Any]]) -> "JobQuota":
        wire = wire or {}
        return cls(hard=dict(wire.get("hard") or {}),
                   soft=dict(wire.get("soft") or {}))
