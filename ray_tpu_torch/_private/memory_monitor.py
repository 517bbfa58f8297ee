"""Memory monitor and worker-killing policies, the OOM defense
(counterpart of ``ray_tpu/_private/memory_monitor.py``).

The monitor samples the host's memory (the cgroup's accounting, else the
processes' PSS) against a threshold of its limit; on a breach it applies a
worker-killing policy: ``retriable-FIFO`` prefers the newest retriable
work, ``group-by-owner`` trims the owner with the most running work.
Killing a retriable task's worker turns an imminent host OOM (which would
take the whole node down, driver included) into a task retry; once retries
are exhausted the task fails with :class:`OutOfMemoryError`.

It guards host memory only. The card's memory is the driver's: the caching
allocator's own failure inside the one process that owns the card, and the
object store's device tier. Only worker processes are candidates, never
the driver. The driver runs one monitor over its own workers, and each
daemon one over its node's (``DaemonService.start_memory_monitor``).

Each kill counts into ``ray_tpu_oom_preemptions_total{reason}``
(``pressure.count_oom_preemption``). ``TenantAwarePolicy`` points the
kills at over-quota tenants' workers first (a daemon wraps its policy in
it under ``memory_pressure``).
"""

from __future__ import annotations

import os
import signal
import threading
import time
from typing import Any, List, Optional

def _flag(name):
    from ray_tpu_torch._private.config import cfg
    return getattr(cfg(), name)



def _cgroup_limit() -> Optional[int]:
    for path in ("/sys/fs/cgroup/memory.max",
                 "/sys/fs/cgroup/memory/memory.limit_in_bytes"):
        try:
            raw = open(path).read().strip()
            if raw and raw != "max":
                val = int(raw)
                if 0 < val < 1 << 60:
                    return val
        except (OSError, ValueError):
            continue
    return None


def system_memory_limit() -> int:
    limit = _cgroup_limit()
    if limit is not None:
        return limit
    try:
        for line in open("/proc/meminfo"):
            if line.startswith("MemTotal:"):
                return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 1 << 62


def _cgroup_reclaimable() -> int:
    """inactive file-backed pages: the kernel reclaims these before
    OOMing, so they must not count as pressure (the reference monitor
    subtracts cache/available for the same reason)."""
    for path in ("/sys/fs/cgroup/memory.stat",
                 "/sys/fs/cgroup/memory/memory.stat"):
        try:
            for line in open(path):
                if line.startswith("inactive_file "):
                    return int(line.split()[1])
        except (OSError, ValueError):
            continue
    return 0


def _cgroup_current() -> Optional[int]:
    for path in ("/sys/fs/cgroup/memory.current",
                 "/sys/fs/cgroup/memory/memory.usage_in_bytes"):
        try:
            used = int(open(path).read().strip())
            return max(used - _cgroup_reclaimable(), 0)
        except (OSError, ValueError):
            continue
    return None


def process_rss(pid: int) -> int:
    """Proportional set size when available (shared pages — the shm
    object arena, forkserver template — counted once per sharer), RSS
    as fallback."""
    try:
        with open(f"/proc/{pid}/smaps_rollup") as f:
            for line in f:
                if line.startswith("Pss:"):
                    return int(line.split()[1]) * 1024
    except (OSError, IndexError, ValueError):
        pass
    try:
        with open(f"/proc/{pid}/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, IndexError, ValueError):
        return 0


class _Candidate:
    __slots__ = ("pid", "kind", "task_id", "actor_id", "retriable",
                 "started_at", "owner_key")

    def __init__(self, pid, kind, task_id=None, actor_id=None,
                 retriable=True, started_at=0.0, owner_key=""):
        self.pid = pid
        self.kind = kind                # "task" | "actor"
        self.task_id = task_id
        self.actor_id = actor_id
        self.retriable = retriable
        self.started_at = started_at
        self.owner_key = owner_key


class RetriableFIFOPolicy:
    """Prefer the NEWEST retriable task (cheapest progress to lose);
    fall back to the newest restartable actor, then anything
    (reference: worker_killing_policy_retriable_fifo.h)."""

    def pick(self, candidates: List[_Candidate]) -> Optional[_Candidate]:
        for pool in (
                [c for c in candidates if c.kind == "task" and c.retriable],
                [c for c in candidates if c.kind == "actor"
                 and c.retriable],
                candidates):
            if pool:
                return max(pool, key=lambda c: c.started_at)
        return None


class GroupByOwnerPolicy:
    """Penalize the owner group with the most running work; newest first
    within the group (reference: worker_killing_policy_group_by_owner.h).
    Here every task shares one owner (the single controller), so groups
    are keyed by task name — a fan-out that floods memory gets trimmed
    before unrelated singleton work dies."""

    def pick(self, candidates: List[_Candidate]) -> Optional[_Candidate]:
        groups: dict = {}
        for c in candidates:
            groups.setdefault(c.owner_key, []).append(c)
        if not groups:
            return None
        biggest = max(groups.values(), key=len)
        retriable = [c for c in biggest if c.retriable]
        pool = retriable or biggest
        return max(pool, key=lambda c: c.started_at)


class TenantAwarePolicy:
    """Point preemption at over-quota tenants first: when the driver's
    fair-share ledger marks jobs at or over a hard cap (synced to daemons
    with ``tenancy_sync``), their workers are the preferred victims; the
    wrapped policy still orders within the preferred pool, and the full
    pool backstops when no over-quota worker runs here. ``last_reason``
    feeds the ``ray_tpu_oom_preemptions_total{reason}`` counter."""

    def __init__(self, inner: Any, over_quota_fn: Any):
        self.inner = inner
        self.over_quota_fn = over_quota_fn
        self.last_reason = "host"

    def pick(self, candidates: List[_Candidate]) -> Optional[_Candidate]:
        over = set()
        try:
            over = set(self.over_quota_fn() or ())
        except Exception:
            pass
        if over:
            preferred = [c for c in candidates if c.owner_key in over]
            if preferred:
                victim = self.inner.pick(preferred)
                if victim is not None:
                    self.last_reason = "tenant_quota"
                    return victim
        self.last_reason = "host"
        return self.inner.pick(candidates)


class MemoryMonitor:
    """Samples driver+worker RSS; on threshold breach kills one worker
    process per tick using the configured policy."""

    def __init__(self, runtime, limit_bytes: Optional[int] = None,
                 threshold: Optional[float] = None,
                 policy: Optional[Any] = None,
                 interval_s: Optional[float] = None,
                 candidates_fn: Optional[Any] = None):
        self.runtime = runtime
        # custom candidate source (the daemon-side monitor: its worker
        # pool is not a driver Runtime; reference: the raylet's monitor
        # watches ITS node's workers, node_manager-side)
        self.candidates_fn = candidates_fn
        self.limit = limit_bytes or _flag("memory_limit_bytes") or \
            system_memory_limit()
        self.threshold = threshold if threshold is not None \
            else _flag("memory_usage_threshold")
        self.policy = policy or (
            GroupByOwnerPolicy()
            if _flag("worker_killing_policy") == "group_by_owner"
            else RetriableFIFOPolicy())
        self.interval_s = (interval_s if interval_s is not None
                           else _flag("memory_monitor_interval"))
        self.kills = 0
        self.oom_killed_tasks: set = set()
        self.oom_killed_actors: set = set()
        self.kill_log: List[Any] = []   # (pid, wall ts) per OOM kill
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="memory-monitor")

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def set_limit(self, limit_bytes: int) -> None:
        self.limit = limit_bytes
        self._explicit_limit = limit_bytes   # replayed to late joiners
        # cluster-wide: node daemons enforce on THEIR workers (the
        # raylet-side monitor); forward the new limit to each
        backend = getattr(self.runtime, "cluster_backend", None) \
            if self.runtime is not None else None
        if backend is not None:
            for handle in list(backend.daemons.values()):
                try:
                    handle.client.call("set_memory_limit",
                                       limit=limit_bytes, timeout=5.0)
                except Exception:
                    pass

    # -- sampling ---------------------------------------------------------
    def _worker_pids(self):
        """(pid, candidate) for every live worker process."""
        if self.candidates_fn is not None:
            return list(self.candidates_fn())
        router = self.runtime.process_router
        out: List[_Candidate] = []
        with router._lock:
            running = dict(router._running)
            actors = dict(router._actor_workers)
        with self.runtime._tasks_lock:
            tasks = dict(self.runtime._tasks)
        for task_id, (client, _rid) in running.items():
            inflight = tasks.get(task_id)
            spec = inflight.spec if inflight else None
            retriable = bool(spec is not None
                             and (spec.max_retries != 0))
            out.append(_Candidate(
                client.proc.pid, "task", task_id=task_id,
                retriable=retriable,
                started_at=getattr(spec, "_enqueued_at", 0.0) or 0.0,
                owner_key=getattr(spec, "name", "")))
        for actor_id, client in actors.items():
            info = self.runtime.gcs.get_actor_info(actor_id)
            restartable = bool(info is not None
                               and (info.max_restarts == -1
                                    or info.num_restarts
                                    < info.max_restarts))
            out.append(_Candidate(
                client.proc.pid, "actor", actor_id=actor_id,
                retriable=restartable,
                started_at=getattr(client, "actor_since", 0.0),
                owner_key=getattr(info, "class_name", "") or ""))
        # driver-local fast-lane workers: their task ids live in the
        # native core, so kills are un-attributed (time-window
        # attribution in the crash handler, like the daemon's lane)
        for w in list(getattr(router, "_fast_workers", [])):
            if w.alive():
                out.append(_Candidate(
                    w.proc.pid, "task", retriable=True,
                    started_at=0.0, owner_key="fast-lane"))
        return out

    def usage_bytes(self, candidates=None) -> int:
        # Prefer the cgroup's own accounting (one number, shared pages
        # counted once — reference memory_monitor.h samples system used
        # memory for exactly this reason); PSS summation is the
        # fallback outside a memory cgroup.
        current = _cgroup_current()
        if current is not None:
            return current
        total = process_rss(os.getpid())
        for cand in candidates or self._worker_pids():
            total += process_rss(cand.pid)
        return total

    # -- enforcement ------------------------------------------------------
    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self._tick()
            except Exception:
                pass

    def _tick(self) -> None:
        candidates = self._worker_pids()
        used = self.usage_bytes(candidates)
        if used < self.limit * self.threshold:
            return
        victim = self.policy.pick(candidates)
        if victim is None:
            return
        self.kills += 1
        import time as _time
        attributed = (victim.task_id is not None
                      or victim.actor_id is not None)
        self.kill_log.append((victim.pid, _time.time(), attributed))
        del self.kill_log[:-100]          # bounded
        if victim.task_id is not None:
            self.oom_killed_tasks.add(victim.task_id)
        if victim.actor_id is not None:
            self.oom_killed_actors.add(victim.actor_id)
        try:
            from ray_tpu_torch._private.pressure import count_oom_preemption
            count_oom_preemption(
                getattr(self.policy, "last_reason", "host") or "host")
        except Exception:
            pass
        try:
            os.kill(victim.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass

    def was_oom_killed(self, task_id) -> bool:
        return task_id in self.oom_killed_tasks

    def consume_unattributed_kill(self, window_s: float = 60.0) -> bool:
        """Claim ONE un-attributed OOM kill (fast-lane workers — their
        task ids live in the native core) within the window. Consuming
        the entry means one kill explains one crash; it cannot keep
        painting later, unrelated crashes as OOM."""
        import time as _time
        now = _time.time()
        for i in range(len(self.kill_log) - 1, -1, -1):
            pid, ts, attributed = self.kill_log[i]
            if not attributed and now - ts < window_s:
                self.kill_log[i] = (pid, ts, True)   # claimed
                return True
        return False
