"""Cluster-level scheduling policies (counterpart of
``ray_tpu/_private/scheduler.py``).

Hybrid top-k (pack up to a utilization threshold, then spread), SPREAD,
node affinity (hard/soft) and node-label selection. The two-level split is
kept: this module only picks a node; admission happens in the node's
dispatch pass (:mod:`ray_tpu_torch._private.node`).

A DRAINING node takes no new placement while another alive node can hold
the demand; a hard affinity pin still lands on it, and a label selector's
fallback never widens past the selector.
"""

from __future__ import annotations

import random
import threading
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private.node import Node
from ray_tpu_torch._private.task_spec import (
    NodeAffinitySchedulingStrategy,
    NodeLabelSchedulingStrategy,
    TaskSpec,
)

# Hybrid policy knobs: pack while the best node's utilization is at most
# SPREAD_THRESHOLD, choosing among the top-k fraction.
SPREAD_THRESHOLD = 0.5
TOP_K_FRACTION = 0.2

# ---------------------------------------------------------------------------
# Cluster epoch: a process-wide version of cluster membership and static
# capacity, bumped on node add/remove. The feasibility cache below keys on
# it, so a burst of identically-shaped submissions scans all nodes once per
# epoch instead of once per task.
# ---------------------------------------------------------------------------

_EPOCH = 0
_EPOCH_LOCK = threading.Lock()


def bump_cluster_epoch() -> int:
    """Invalidate cached feasibility (node add/remove/drain). Cheap and
    safe to over-call."""
    global _EPOCH
    with _EPOCH_LOCK:
        _EPOCH += 1
        return _EPOCH


def cluster_epoch() -> int:
    return _EPOCH


class SchedulingError(Exception):
    """Task is infeasible: no alive node can ever satisfy it."""


def _soft_excluded(n: Any) -> bool:
    """Alive but taking no NEW placements: DRAINING, or under HARD memory
    pressure (the node is shedding load). Soft: when every alive node is
    excluded, callers fall back to them (running somewhere beats failing
    a feasible demand)."""
    return bool(getattr(n, "draining", False)
                or getattr(n, "pressure_level", "ok") == "hard")


_INFEASIBLE = object()      # negative-cache sentinel
_FEAS_CACHE_MAX = 512       # distinct resource shapes per epoch


class ClusterScheduler:
    def __init__(self):
        from ray_tpu_torch._private.lock_sanitizer import tracked_lock
        self._lock = tracked_lock("scheduler", reentrant=False)
        self._spread_rr = 0  #: guarded by self._lock
        # (resource-shape, cluster-epoch) -> feasible candidate nodes
        self._feas_cache: Dict[tuple, Any] = {}  #: guarded by self._lock
        self._feas_epoch = -1                    #: guarded by self._lock
        # the fair-share consult (set by the runtime when ``fairshare`` is
        # on): an over-cap job spreads its queued work instead of packing,
        # so per-node quota gates free evenly
        self.tenancy = None

    def pick_node(self, spec: TaskSpec, nodes: List[Node],
                  preferred: Optional[Node] = None) -> Optional[Node]:
        """Choose a node for the task, or None if feasible-but-busy.

        Raises SchedulingError if no node can ever fit the demand.
        """
        strategy = spec.scheduling_strategy
        if (strategy == "DEFAULT" and self.tenancy is not None
                and self.tenancy.prefers_spread(
                    spec.job_id.hex() if spec.job_id is not None
                    else "")):
            # the feasibility cache is keyed on the resource shape only,
            # so demoting pack to spread cannot pollute it
            strategy = "SPREAD"
        if strategy == "DEFAULT" or strategy == "SPREAD":
            # hot path: plain strategies share one feasibility scan per
            # (resource shape, cluster epoch)
            feasible = self._feasible_cached(spec, nodes)
            if strategy == "SPREAD":
                return self._pick_spread(spec, feasible)
            return self._pick_hybrid(spec, feasible, preferred)

        alive = [n for n in nodes if n.alive]
        if not alive:
            raise SchedulingError("no alive nodes in cluster")
        # DRAINING nodes take no new placements while their running work
        # finishes; when every alive node drains, fall back to them
        schedulable = [n for n in alive if not _soft_excluded(n)] or alive
        if isinstance(strategy, NodeAffinitySchedulingStrategy):
            return self._pick_affinity(spec, strategy, alive, schedulable)
        if isinstance(strategy, NodeLabelSchedulingStrategy):
            # filter BOTH pools: the draining fallback must never widen
            # past the label selector, and a selector whose only match is
            # draining still runs there rather than failing
            alive = self._filter_labels(strategy, alive)
            if not alive:
                raise SchedulingError("no node matches label selector")
            schedulable = [n for n in alive
                           if not _soft_excluded(n)] or alive
            strategy = "DEFAULT"

        feasible = self._compute_feasible(spec, alive, schedulable)
        if strategy == "SPREAD":
            return self._pick_spread(spec, feasible)
        return self._pick_hybrid(spec, feasible, preferred)

    # -- feasibility cache -------------------------------------------------
    @staticmethod
    def _compute_feasible(spec: TaskSpec, alive: List[Node],
                          schedulable: List[Node]) -> List[Node]:
        feasible = [n for n in schedulable
                    if n.ledger.can_fit_total(spec.resources)]
        if not feasible:
            # a demand only a draining node can hold still runs there
            feasible = [n for n in alive
                        if n.ledger.can_fit_total(spec.resources)]
        if not feasible:
            raise SchedulingError(
                f"resource demand {spec.resources} is infeasible on every "
                f"alive node")
        return feasible

    def _feasible_cached(self, spec: TaskSpec,
                         nodes: List[Node]) -> List[Node]:
        epoch = _EPOCH
        key = tuple(sorted(spec.resources.items()))
        with self._lock:
            if self._feas_epoch != epoch:
                self._feas_cache.clear()
                self._feas_epoch = epoch
                entry = None
            else:
                entry = self._feas_cache.get(key)
        if entry is _INFEASIBLE:
            raise SchedulingError(
                f"resource demand {spec.resources} is infeasible on every "
                f"alive node")
        if entry is not None:
            # epoch bumps cover membership and drain changes; this cheap
            # re-check makes a missed bump degrade to a recompute instead
            # of a placement on a dead or draining node
            if all(n.alive and not _soft_excluded(n) for n in entry):
                return entry
        alive = [n for n in nodes if n.alive]
        if not alive:
            raise SchedulingError("no alive nodes in cluster")
        schedulable = [n for n in alive if not _soft_excluded(n)] or alive
        try:
            feasible = self._compute_feasible(spec, alive, schedulable)
        except SchedulingError:
            self._feas_store(epoch, key, _INFEASIBLE)
            raise
        # only clean candidate sets are cached: a draining-fallback pick
        # is re-evaluated per task (a last resort, not a steady state)
        if all(not _soft_excluded(n) for n in feasible):
            self._feas_store(epoch, key, feasible)
        return feasible

    def _feas_store(self, epoch: int, key: tuple, value: Any) -> None:
        with self._lock:
            if self._feas_epoch != epoch or _EPOCH != epoch:
                return      # the cluster moved underneath the scan
            if len(self._feas_cache) >= _FEAS_CACHE_MAX:
                self._feas_cache.clear()
            self._feas_cache[key] = value

    # -- policies ----------------------------------------------------------
    def _pick_hybrid(self, spec: TaskSpec, feasible: List[Node],
                     preferred: Optional[Node]) -> Optional[Node]:
        """Pack onto low-utilization nodes first; break ties toward preferred
        (locality) node; randomize among top-k to avoid herding."""
        scored = []
        for n in feasible:
            avail = n.effective_available()
            if not all(avail.get(k, 0.0) >= v - 1e-9
                       for k, v in spec.resources.items()):
                continue
            util = self._utilization(n)
            bias = -0.1 if (preferred is not None
                            and n.node_id == preferred.node_id) else 0.0
            scored.append((util + bias, n))
        if not scored:
            # All feasible nodes currently busy: queue on the least loaded
            # (its dispatch loop admits when resources free up).
            return min(feasible, key=self._utilization)
        scored.sort(key=lambda t: t[0])
        if scored[0][0] <= SPREAD_THRESHOLD:
            k = max(1, int(len(scored) * TOP_K_FRACTION))
            return random.choice(scored[:k])[1]
        return scored[0][1]

    def _pick_spread(self, spec: TaskSpec, feasible: List[Node]) -> Node:
        with self._lock:
            self._spread_rr += 1
            start = self._spread_rr
        # Prefer a currently-available node in round-robin order.
        order = [feasible[(start + i) % len(feasible)]
                 for i in range(len(feasible))]
        for n in order:
            avail = n.effective_available()
            if all(avail.get(k, 0.0) >= v - 1e-9
                   for k, v in spec.resources.items()):
                return n
        return order[0]

    def _pick_affinity(self, spec: TaskSpec,
                       strategy: NodeAffinitySchedulingStrategy,
                       alive: List[Node],
                       schedulable: Optional[List[Node]] = None) -> Node:
        if schedulable is None:
            schedulable = alive
        target = None
        for n in alive:
            if n.node_id.hex() == strategy.node_id:
                target = n
                break
        if target is not None and target.ledger.can_fit_total(spec.resources):
            # a hard pin still lands on a draining target (the user chose
            # the node); soft affinity prefers a node that will live
            if not (strategy.soft and getattr(target, "draining", False)):
                return target
        if strategy.soft:
            return self._pick_hybrid(spec, [
                n for n in schedulable
                if n.ledger.can_fit_total(spec.resources)
            ] or schedulable, None)
        raise SchedulingError(
            f"node {strategy.node_id[:8]} is dead or cannot fit "
            f"{spec.resources} (hard affinity)")

    def _filter_labels(self, strategy: NodeLabelSchedulingStrategy,
                       alive: List[Node]) -> List[Node]:
        def matches(node: Node, selector: Dict) -> bool:
            for key, expected in (selector or {}).items():
                actual = node.labels.get(key)
                if isinstance(expected, (list, tuple, set)):
                    if actual not in expected:
                        return False
                elif actual != expected:
                    return False
            return True

        hard = [n for n in alive if matches(n, strategy.hard)]
        if strategy.soft:
            soft = [n for n in hard if matches(n, strategy.soft)]
            if soft:
                return soft
        return hard

    @staticmethod
    def _utilization(node: Node) -> float:
        total = node.ledger.total
        avail = node.effective_available()
        utils = [1.0 - avail.get(k, 0.0) / v
                 for k, v in total.items() if v > 0]
        return max(utils) if utils else 0.0
