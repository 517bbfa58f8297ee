"""Task specifications and option validation (counterpart of
``ray_tpu/_private/task_spec.py``).

What a task *is*, and the validated option surface of ``@remote``. The
options are the reference's; where JAX's package aliases ``num_gpus`` and
``num_tpus`` onto its ``TPU`` chip resource, the port aliases both onto
``GPU``, the card.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private.ids import (ActorID, JobID, ObjectID,
                                        PlacementGroupID, TaskID)


class TaskKind(enum.Enum):
    NORMAL = "normal"
    ACTOR_CREATION = "actor_creation"
    ACTOR_TASK = "actor_task"


# ---------------------------------------------------------------------------
# Option validation
# ---------------------------------------------------------------------------

COMMON_OPTIONS = {
    "num_cpus", "num_gpus", "num_tpus", "memory", "resources",
    "accelerator_type", "label_selector", "name", "runtime_env",
    "scheduling_strategy", "placement_group", "placement_group_bundle_index",
    "enable_task_events", "_metadata", "_in_process",
}
TASK_ONLY_OPTIONS = {
    "max_calls", "max_retries", "retry_exceptions", "num_returns",
    "_generator_backpressure_num_objects",
}
ACTOR_ONLY_OPTIONS = {
    "concurrency_groups", "lifetime", "max_concurrency", "max_restarts",
    "max_task_retries", "max_pending_calls", "namespace", "get_if_exists",
    "object_store_memory",
}
DEFAULT_TASK_OPTIONS = {"num_cpus": 1, "max_retries": 3, "num_returns": 1}
DEFAULT_ACTOR_OPTIONS = {"num_cpus": 0, "max_restarts": 0,
                         "max_task_retries": 0, "max_concurrency": 1,
                         "max_pending_calls": -1, "lifetime": None}


def validate_options(options: Dict[str, Any], for_actor: bool) -> Dict[str, Any]:
    allowed = COMMON_OPTIONS | (ACTOR_ONLY_OPTIONS if for_actor
                                else TASK_ONLY_OPTIONS)
    for k in options:
        if k not in allowed:
            kind = "actor" if for_actor else "task"
            raise ValueError(f"invalid option {k!r} for a {kind}")
    lifetime = options.get("lifetime")
    if lifetime not in (None, "detached", "non_detached"):
        raise ValueError(f"lifetime must be 'detached'|'non_detached', "
                         f"got {lifetime!r}")
    if options.get("get_if_exists") and not options.get("name"):
        raise ValueError("get_if_exists requires a `name` option")
    nr = options.get("num_returns")
    if nr is not None and not (
            (isinstance(nr, int) and nr >= 0) or nr in ("dynamic", "streaming")):
        raise ValueError(f"num_returns must be int>=0|'dynamic'|'streaming', "
                         f"got {nr!r}")
    for res_opt in ("num_cpus", "num_gpus", "num_tpus", "memory"):
        v = options.get(res_opt)
        if v is not None and (not isinstance(v, (int, float)) or v < 0):
            raise ValueError(f"{res_opt} must be a non-negative number")
    return options


def resources_from_options(options: Dict[str, Any]) -> Dict[str, float]:
    """Flatten option fields into a single resource-demand dict."""
    resources: Dict[str, float] = {}
    if options.get("num_cpus"):
        resources["CPU"] = float(options["num_cpus"])
    # num_gpus and num_tpus alias onto the card's GPU resource.
    gpus = options.get("num_tpus", options.get("num_gpus"))
    if gpus:
        resources["GPU"] = float(gpus)
    if options.get("memory"):
        resources["memory"] = float(options["memory"])
    for k, v in (options.get("resources") or {}).items():
        if k in ("CPU", "GPU", "memory") and k in resources:
            raise ValueError(f"resource {k} specified twice")
        resources[k] = float(v)
    return resources


# ---------------------------------------------------------------------------
# Scheduling strategies
# ---------------------------------------------------------------------------

@dataclass
class PlacementGroupSchedulingStrategy:
    placement_group: Any
    placement_group_bundle_index: int = -1
    placement_group_capture_child_tasks: bool = False


@dataclass
class NodeAffinitySchedulingStrategy:
    node_id: str  # hex
    soft: bool = False


@dataclass
class NodeLabelSchedulingStrategy:
    hard: Optional[Dict[str, Any]] = None
    soft: Optional[Dict[str, Any]] = None


# "DEFAULT" | "SPREAD" | one of the strategy classes
SchedulingStrategyT = Any


def strategy_from_options(options: Dict[str, Any]) -> SchedulingStrategyT:
    """The ``scheduling_strategy`` option; without one, the reference's
    legacy ``placement_group`` / ``placement_group_bundle_index`` options
    name the group (JAX's package accepts them and drops them)."""
    strategy = options.get("scheduling_strategy")
    if strategy is None and options.get("placement_group") is not None:
        strategy = PlacementGroupSchedulingStrategy(
            options["placement_group"],
            placement_group_bundle_index=options.get(
                "placement_group_bundle_index", -1))
    return strategy or "DEFAULT"


# ---------------------------------------------------------------------------
# Task spec
# ---------------------------------------------------------------------------

@dataclass
class TaskSpec:
    task_id: TaskID
    kind: TaskKind
    name: str
    # The callable: for NORMAL, the function; for ACTOR_CREATION, the class;
    # for ACTOR_TASK, unused (the method is resolved on the actor by name).
    func: Any
    args: Tuple = ()
    kwargs: Dict[str, Any] = field(default_factory=dict)
    resources: Dict[str, float] = field(default_factory=dict)
    num_returns: Any = 1
    return_ids: List[ObjectID] = field(default_factory=list)
    max_retries: int = 0
    retry_exceptions: Any = False  # bool | list of exception types
    scheduling_strategy: SchedulingStrategyT = "DEFAULT"
    job_id: Optional[JobID] = None
    # actor fields
    actor_id: Optional[ActorID] = None
    method_name: str = ""
    seqno: int = 0
    concurrency_group: str = ""
    # actor creation fields
    max_restarts: int = 0
    max_task_retries: int = 0
    max_concurrency: int = 1
    max_pending_calls: int = -1
    concurrency_groups: Optional[Dict[str, int]] = None
    lifetime: Optional[str] = None
    actor_name: Optional[str] = None
    namespace: Optional[str] = None
    # per-method option defaults declared via @ray_tpu_torch.method
    method_options: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    # lineage/retry accounting
    attempt_number: int = 0
    # generator backpressure
    backpressure_num_objects: int = -1
    enable_task_events: bool = True
    # run in the caller's process; every task of the in-process core does
    in_process: bool = False
    label_selector: Optional[Dict[str, Any]] = None
    # the prepared runtime env (runtime_env.py): directories packaged into
    # pkg:// URIs at submit, applied around the execution wherever it runs
    runtime_env: Optional[Dict[str, Any]] = None
    # placement group capture
    placement_group_id: Optional[PlacementGroupID] = None
    # the demand before it was rewritten onto bundle-scoped resource
    # names, so that a retry re-matches the bundles
    pg_demand: Optional[Dict[str, float]] = None
    pg_capture: bool = False  # propagate the group to child tasks
    # trace context, stamped by events.stamp_trace at submit; it rides the
    # spec to daemons and workers, so every process records its spans for
    # the same trace
    trace_id: str = ""
    trace_sampled: bool = False
    submit_mono: float = 0.0
    submit_wall: float = 0.0

    def dependencies(self) -> List[ObjectID]:
        """ObjectIDs this task's args depend on (top-level refs only)."""
        from ray_tpu_torch._private.object_ref import ObjectRef

        deps = []
        for a in list(self.args) + list(self.kwargs.values()):
            if isinstance(a, ObjectRef):
                deps.append(a.id)
        return deps
