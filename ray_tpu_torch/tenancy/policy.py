"""Fair-share ledger: weighted DRF shares plus deficit accounting
(counterpart of ``ray_tpu/tenancy/policy.py``).

Policy (reference: DRF, Ghodsi et al., adapted to batch dispatch per
arXiv 2002.07062): each job j has a weight w_j; its *dominant share*
is max_r usage_j[r] / capacity[r]. Node dispatch asks the ledger to
order the ready same-shape task groups; each ordering round every job
with pending work accrues a deficit quantum proportional to its weight
share, and admitting n tasks of demand d spends
``n * dominant_cost(d)`` of that deficit. Groups are then admitted
whole, highest deficit first — a light job's small groups cut ahead of
a saturating job's backlog without preempting anything, and a job's
same-shape batch is never interleaved task-at-a-time.

Hard quota caps clamp how many tasks of a group may admit
(:meth:`FairShareLedger.admit_cap`); clamped groups stay in the node
backlog (verdict semantics: QUEUED, not lost).

Thread model: dispatch loops (one per node), the driver submit path,
and the federation ticker all call in. All state is guarded by one
non-reentrant lock; the per-task completion path stays lock-free by
appending to ``_done_log`` (a GIL-atomic list append) which is folded
into usage at the next locked entry point.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from ray_tpu_torch._private.lock_sanitizer import tracked_lock
from ray_tpu_torch.tenancy.quota import JobQuota

#: deficit credit granted per ordering round, split by weight share.
QUANTUM = 1.0
#: deficit is clamped to ±CAP quanta so an idle-then-bursty job cannot
#: bank unbounded credit (and a greedy one cannot dig an endless hole).
DEFICIT_CAP = 4.0
#: seconds the cluster-capacity callable result is cached.
_CAPACITY_TTL_S = 2.0
_EPS = 1e-9


class _JobShare:
    """Ledger row for one job (all fields guarded by the ledger lock)."""

    __slots__ = ("weight", "usage", "running", "deficit", "queued",
                 "object_bytes", "quota")

    def __init__(self, weight: float) -> None:
        self.weight = weight
        self.usage: Dict[str, float] = {}
        self.running = 0
        self.deficit = 0.0
        self.queued = 0
        self.object_bytes = 0.0
        self.quota = JobQuota()


class FairShareLedger:
    """Weighted-DRF usage accounting with deficit-ordered admission."""

    def __init__(self,
                 capacity: "Callable[[], Dict[str, float]] | Dict[str, float]",
                 default_weight: float = 1.0) -> None:
        self._capacity_fn = (capacity if callable(capacity)
                             else (lambda: capacity))
        self._default_weight = max(float(default_weight), _EPS)
        self._lock = tracked_lock("tenancy.ledger", reentrant=False)
        #: guarded by self._lock
        self._jobs: Dict[str, _JobShare] = {}
        #: guarded by self._lock
        self._queued_by_node: Dict[str, Dict[str, int]] = {}
        #: guarded by self._lock
        self._capacity: Dict[str, float] = {}
        #: guarded by self._lock
        self._capacity_at = 0.0
        # completion log: appended WITHOUT the lock (list.append is
        # GIL-atomic), folded into usage under the lock. Keeps the
        # per-task drain path at one append instead of a lock acquire.
        self._done_log: List[Tuple[str, Dict[str, float]]] = []
        # lock-free fast-path flag: False until ANY job declares a hard
        # or soft cap. Quota checks read it before taking the lock so a
        # fairshare-on cluster with no quotas configured pays no lock
        # traffic per submit/dispatch (a set_quota racing a check takes
        # effect on the next check — same staleness as losing the lock
        # race). Written only under self._lock.
        self._any_caps = False

    # ------------------------------------------------------------------
    # registration / configuration
    # ------------------------------------------------------------------
    def ensure(self, job: str, weight: Optional[float] = None) -> None:
        with self._lock:
            self._ensure_locked(job, weight)

    def set_weight(self, job: str, weight: float) -> None:
        with self._lock:
            self._ensure_locked(job).weight = max(float(weight), _EPS)

    def set_quota(self, job: str, quota: JobQuota) -> None:
        with self._lock:
            self._ensure_locked(job).quota = quota
            self._any_caps = any(
                s.quota.hard or s.quota.soft
                for s in self._jobs.values())

    def get_quota(self, job: str) -> JobQuota:
        with self._lock:
            return self._ensure_locked(job).quota

    def get_weight(self, job: str) -> float:
        with self._lock:
            return self._ensure_locked(job).weight

    def _ensure_locked(self, job: str,
                       weight: Optional[float] = None) -> _JobShare:
        # caller holds self._lock (lexical check can't see through the
        # _locked-suffix convention)
        share = self._jobs.get(job)      # raylint: disable=guarded-by
        if share is None:
            share = _JobShare(self._default_weight)
            self._jobs[job] = share      # raylint: disable=guarded-by
        if weight is not None:
            share.weight = max(float(weight), _EPS)
        return share

    # ------------------------------------------------------------------
    # DRF math
    # ------------------------------------------------------------------
    def _capacity_locked(self) -> Dict[str, float]:
        # caller holds self._lock
        now = time.monotonic()
        stale = now - self._capacity_at > _CAPACITY_TTL_S  # raylint: disable=guarded-by
        if stale or not self._capacity:  # raylint: disable=guarded-by
            try:
                self._capacity = dict(self._capacity_fn() or {})  # raylint: disable=guarded-by
            except Exception:
                self._capacity = self._capacity or {}  # raylint: disable=guarded-by
            self._capacity_at = now    # raylint: disable=guarded-by
        return self._capacity          # raylint: disable=guarded-by

    def _dominant_cost_locked(self, demand: Dict[str, float]) -> float:
        cap = self._capacity_locked()
        cost = 0.0
        for res, need in demand.items():
            total = cap.get(res, 0.0)
            if total > _EPS and need > 0:
                cost = max(cost, need / total)
        # a demand entirely off the capacity map still costs something,
        # or deficits would never be spent and ordering would freeze
        return cost if cost > _EPS else _EPS

    def _dominant_share_locked(self, share: _JobShare) -> float:
        cap = self._capacity_locked()
        dom = 0.0
        for res, used in share.usage.items():
            total = cap.get(res, 0.0)
            if total > _EPS and used > 0:
                dom = max(dom, used / total)
        return dom

    def dominant_cost(self, demand: Dict[str, float]) -> float:
        with self._lock:
            return self._dominant_cost_locked(demand)

    def dominant_share(self, job: str) -> float:
        with self._lock:
            self._fold_done_locked()
            return self._dominant_share_locked(self._ensure_locked(job))

    # ------------------------------------------------------------------
    # quota checks
    # ------------------------------------------------------------------
    def any_caps(self) -> bool:
        """Lock-free: has ANY job declared a hard/soft cap? Admission
        reads this to skip inflight bookkeeping on quota-free clusters
        (same staleness contract as the quota checks below)."""
        return self._any_caps

    def over_hard_cap(self, job: str, demand: Dict[str, float]) -> bool:
        """Would one more task of ``demand`` put ``job`` over a hard cap?
        Also true while the job's tracked object-store bytes exceed a
        hard ``object_store_bytes`` cap."""
        if not self._any_caps:
            return False
        with self._lock:
            self._fold_done_locked()
            share = self._ensure_locked(job)
            obj_cap = share.quota.hard_cap("object_store_bytes")
            if obj_cap is not None and share.object_bytes > obj_cap + _EPS:
                return True
            for res, need in demand.items():
                cap = share.quota.hard_cap(res)
                if cap is not None and (share.usage.get(res, 0.0) + need
                                        > cap + _EPS):
                    return True
            return False

    def at_hard_cap(self, job: str) -> bool:
        """Is the job's current usage at (or past) any hard cap?"""
        if not self._any_caps:
            return False
        with self._lock:
            self._fold_done_locked()
            share = self._ensure_locked(job)
            obj_cap = share.quota.hard_cap("object_store_bytes")
            if obj_cap is not None and share.object_bytes > obj_cap + _EPS:
                return True
            for res, cap in share.quota.hard.items():
                if res == "object_store_bytes":
                    continue
                if share.usage.get(res, 0.0) >= cap - _EPS:
                    return True
            return False

    def over_soft_cap(self, job: str) -> bool:
        if not self._any_caps:
            return False
        with self._lock:
            self._fold_done_locked()
            share = self._ensure_locked(job)
            obj_cap = share.quota.soft_cap("object_store_bytes")
            if obj_cap is not None and share.object_bytes > obj_cap + _EPS:
                return True
            for res, used in share.usage.items():
                cap = share.quota.soft_cap(res)
                if cap is not None and used > cap + _EPS:
                    return True
            return False

    def admit_cap(self, job: str, demand: Dict[str, float],
                  want: int) -> int:
        """Clamp a same-shape group of ``want`` tasks to the job's hard
        caps given its current usage. 0 means the whole group stays
        queued until the job's own releases free headroom."""
        if want <= 0:
            return 0
        if not self._any_caps:
            return want
        with self._lock:
            self._fold_done_locked()
            share = self._ensure_locked(job)
            obj_cap = share.quota.hard_cap("object_store_bytes")
            if obj_cap is not None and share.object_bytes > obj_cap + _EPS:
                return 0
            allowed = want
            for res, need in demand.items():
                cap = share.quota.hard_cap(res)
                if cap is None or need <= 0:
                    continue
                head = cap - share.usage.get(res, 0.0)
                allowed = min(allowed, int((head + _EPS) // need))
                if allowed <= 0:
                    return 0
            return allowed

    # ------------------------------------------------------------------
    # deficit-ordered admission
    # ------------------------------------------------------------------
    def order(self, items: Iterable[Tuple[Tuple[str, Any], int]]
              ) -> List[Tuple[str, Any]]:
        """Order ready groups for one dispatch round.

        ``items`` is ``[((job, shape_key), n_pending), ...]``. Every job
        present accrues a weight-proportional deficit quantum, then keys
        come back sorted highest deficit first (ties: lowest weighted
        dominant share, then job id; FIFO order is preserved within a
        job — Python's sort is stable).
        """
        items = list(items)
        if not items:
            return []
        pending: Dict[str, int] = {}
        for (job, _shape), n in items:
            pending[job] = pending.get(job, 0) + max(int(n), 0)
        with self._lock:
            self._fold_done_locked()
            total_w = 0.0
            for job in pending:
                total_w += self._ensure_locked(job).weight
            prio: Dict[str, Tuple[float, float, str]] = {}
            for job in pending:
                share = self._jobs[job]
                share.deficit = min(
                    DEFICIT_CAP,
                    share.deficit + QUANTUM * share.weight / total_w)
                # soft-cap demotion: an over-soft job only runs after
                # every within-soft job's groups were considered
                demote = 1.0 if self._over_soft_locked(share) else 0.0
                prio[job] = (demote, -share.deficit,
                             self._dominant_share_locked(share)
                             / share.weight)
        return [key for key, _n in
                sorted(items, key=lambda kv: prio[kv[0][0]] + (kv[0][0],))]

    def _over_soft_locked(self, share: _JobShare) -> bool:
        obj_cap = share.quota.soft_cap("object_store_bytes")
        if obj_cap is not None and share.object_bytes > obj_cap + _EPS:
            return True
        for res, used in share.usage.items():
            cap = share.quota.soft_cap(res)
            if cap is not None and used > cap + _EPS:
                return True
        return False

    # ------------------------------------------------------------------
    # usage accounting
    # ------------------------------------------------------------------
    def note_admitted(self, job: str, demand: Dict[str, float],
                      n: int) -> None:
        if n <= 0:
            return
        with self._lock:
            share = self._ensure_locked(job)
            for res, need in demand.items():
                share.usage[res] = share.usage.get(res, 0.0) + need * n
            share.running += n
            share.deficit = max(
                -DEFICIT_CAP,
                share.deficit - n * self._dominant_cost_locked(demand))

    def note_done(self, job: str, resources: Dict[str, float]) -> None:
        """Per-task completion; lock-free (folded at next locked call)."""
        self._done_log.append((job, resources))

    def _fold_done_locked(self) -> None:
        # caller holds self._lock
        if not self._done_log:
            return
        log, self._done_log = self._done_log, []
        for job, resources in log:
            share = self._jobs.get(job)  # raylint: disable=guarded-by
            if share is None:
                continue
            for res, need in resources.items():
                left = share.usage.get(res, 0.0) - need
                share.usage[res] = left if left > _EPS else 0.0
            if share.running > 0:
                share.running -= 1
            if share.running == 0 and share.queued == 0:
                # queue-empty deficit forfeit applied here too: nodes
                # skip observe_queued when their backlog counts are
                # unchanged, so the last completion (not the next
                # dispatch round) must land the DRR reset
                share.deficit = 0.0

    def note_object_bytes(self, job: str, delta: float) -> None:
        with self._lock:
            share = self._ensure_locked(job)
            share.object_bytes = max(0.0, share.object_bytes + delta)

    def observe_queued(self, node: str, counts: Dict[str, int]) -> None:
        """One node's per-job backlog depth after a dispatch round. A
        job with nothing queued or running anywhere forfeits its banked
        deficit (standard deficit-round-robin queue-empty reset)."""
        with self._lock:
            self._fold_done_locked()
            self._queued_by_node[node] = dict(counts)
            totals: Dict[str, int] = {}
            for per_node in self._queued_by_node.values():
                for job, n in per_node.items():
                    totals[job] = totals.get(job, 0) + n
            for job, share in self._jobs.items():
                share.queued = totals.get(job, 0)
                if share.queued == 0 and share.running == 0:
                    share.deficit = 0.0

    # ------------------------------------------------------------------
    # views
    # ------------------------------------------------------------------
    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            self._fold_done_locked()
            out: Dict[str, Dict[str, Any]] = {}
            for job, share in self._jobs.items():
                out[job] = {
                    "weight": share.weight,
                    "usage": dict(share.usage),
                    "running": share.running,
                    "queued": share.queued,
                    "object_bytes": share.object_bytes,
                    "deficit": round(share.deficit, 6),
                    "dominant_share": round(
                        self._dominant_share_locked(share), 6),
                    "quota": share.quota.to_wire(),
                }
            return out
