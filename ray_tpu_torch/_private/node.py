"""Per-node runtime: resource accounting, task dispatch, actor hosting
(counterpart of ``ray_tpu/_private/node.py``).

Each node owns a resource ledger, a backlog of tasks gated on resource
availability, a pool of threads that executes them, and the actor executors
living on the node. The scheduler (:mod:`ray_tpu_torch._private.scheduler`)
assigns a task to a node, the node's dispatch pass admits it when
resources free up, and a pooled thread runs it. With ``cfg().async_core``
(the default) the dispatch pass is a callback on the process event loop
(``_private/eventloop.py``); with the threaded core it is a thread of the
node's own.

Graceful drain (``start_drain``): a draining node takes no new placements,
hands its queued and admitted-but-unstarted tasks back to the runtime, and
lets its running work finish.

Every task runs in the process that called ``init``, as the reference's
does with process workers off: the card's kernels and torch's host ops
release the GIL, so a thread pool gives real parallelism to accelerator
work, while CPU-bound Python tasks interleave.
"""

from __future__ import annotations

import asyncio
import heapq
import queue
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch._private import events as _events
from ray_tpu_torch._private.gcs import NodeInfo
from ray_tpu_torch._private.ids import ActorID, NodeID
from ray_tpu_torch._private.lock_sanitizer import tracked_lock
from ray_tpu_torch._private.object_store import LocalObjectStore
from ray_tpu_torch._private.task_spec import TaskKind, TaskSpec
from ray_tpu_torch.util import metrics as _metrics

_DISPATCH_POLL_S = 5.0

# Queue sentinel that only wakes the dispatch pass (None means exit).
_WAKE = object()


def _bump_cluster_epoch() -> None:
    # lazy import: scheduler.py imports this module at top level
    from ray_tpu_torch._private.scheduler import bump_cluster_epoch
    bump_cluster_epoch()


class ResourceLedger:
    """Tracks total/available resources with blocking acquire."""

    def __init__(self, total: Dict[str, float]):
        self.total = dict(total)
        self._available = dict(total)
        self._cond = threading.Condition()
        # availability-grew hook (loop-hosted dispatch): fired outside the
        # condition lock after release, release_many and add_total, so the
        # pass wakes at once instead of polling; the threaded dispatch
        # thread waits on the condition and never sets it
        self.on_change: Optional[Callable[[], None]] = None

    def _fire_on_change(self) -> None:
        cb = self.on_change
        if cb is not None:
            try:
                cb()
            except Exception:
                pass    # a wake hook must never fail a release

    def can_fit_total(self, demand: Dict[str, float]) -> bool:
        return all(self.total.get(k, 0.0) >= v for k, v in demand.items())

    def try_acquire(self, demand: Dict[str, float]) -> bool:
        with self._cond:
            if all(self._available.get(k, 0.0) >= v - 1e-9
                   for k, v in demand.items()):
                for k, v in demand.items():
                    self._available[k] = self._available.get(k, 0.0) - v
                return True
            return False

    def add_total(self, extra: Dict[str, float]) -> None:
        """Grow capacity in place (a placement group's bundle resources)."""
        with self._cond:
            for k, v in extra.items():
                self.total[k] = self.total.get(k, 0.0) + v
                self._available[k] = self._available.get(k, 0.0) + v
            self._cond.notify_all()
        self._fire_on_change()
        _bump_cluster_epoch()   # can_fit_total's answers changed

    def remove_total(self, extra: Dict[str, float]) -> None:
        with self._cond:
            for k, v in extra.items():
                left = self.total.get(k, 0.0) - v
                if left <= 1e-12:    # a bundle's own name: gone with it
                    self.total.pop(k, None)
                    self._available.pop(k, None)
                    continue
                self.total[k] = left
                self._available[k] = max(self._available.get(k, 0.0) - v,
                                         0.0)
            self._cond.notify_all()
        _bump_cluster_epoch()

    def release(self, demand: Dict[str, float]) -> None:
        with self._cond:
            for k, v in demand.items():
                if k in self.total:     # else a removed bundle's name
                    self._available[k] = min(
                        self._available.get(k, 0.0) + v, self.total[k])
            self._cond.notify_all()
        self._fire_on_change()

    def wait_for_change(self, timeout: float) -> None:
        with self._cond:
            self._cond.wait(timeout)

    def available(self) -> Dict[str, float]:
        with self._cond:
            return dict(self._available)

    def try_acquire_many(self, demand: Dict[str, float],
                         max_n: int) -> int:
        """Admit as many identically-shaped demands as fit, computed and
        deducted under one lock acquisition (the dispatch loop's batch
        admission)."""
        if max_n <= 0:
            return 0
        with self._cond:
            n = max_n
            for k, v in demand.items():
                if v <= 0:
                    continue
                have = self._available.get(k, 0.0)
                n = min(n, int((have + 1e-9) // v))
                if n <= 0:
                    return 0
            for k, v in demand.items():
                self._available[k] = self._available.get(k, 0.0) - v * n
            return n

    def release_many(self, groups) -> None:
        """Release a batch of completions' demands under one lock
        acquisition and one notify. ``groups`` is an iterable of
        ``(demand, count)`` pairs."""
        with self._cond:
            for demand, count in groups:
                for k, v in demand.items():
                    if k in self.total:
                        self._available[k] = min(
                            self._available.get(k, 0.0) + v * count,
                            self.total[k])
            self._cond.notify_all()
        self._fire_on_change()


class _DirectOp:
    """A closure queued on an ActorExecutor by a compiled DAG.
    ``on_dead(cause)`` runs when the actor dies with the op still queued,
    so the DAG's channel fails at once instead of timing out."""

    __slots__ = ("fn", "on_dead")

    def __init__(self, fn: Callable[[Any], None],
                 on_dead: Optional[Callable[[str], None]] = None):
        self.fn = fn
        self.on_dead = on_dead


class ActorExecutor:
    """Executes one actor's tasks: FIFO by seqno, optional concurrency,
    async actors and concurrency groups."""

    def __init__(self, actor_id: ActorID, max_concurrency: int,
                 run_task: Callable[[TaskSpec, Any], None],
                 run_task_async: Optional[Callable] = None,
                 concurrency_groups: Optional[Dict[str, int]] = None):
        self.actor_id = actor_id
        self.max_concurrency = max(1, max_concurrency)
        self._run_task = run_task
        self._run_task_async = run_task_async
        self.instance: Any = None
        self.is_async = False
        # each named group gets its own queue and thread pool; methods
        # route by spec.concurrency_group, "" = the default group
        self._groups: Dict[str, Dict[str, Any]] = {}
        for name, limit in {"": self.max_concurrency,
                            **(concurrency_groups or {})}.items():
            self._groups[name] = {"heap": [], "limit": max(1, int(limit))}
        self._cond = threading.Condition()
        self._push_seq = 0
        self._dead = False
        self.death_cause: Optional[str] = None
        self._threads: List[threading.Thread] = []
        self._loop = None  # asyncio loop for async actors
        self.num_pending = 0

    def start(self, instance: Any, is_async: bool) -> None:
        self.instance = instance
        self.is_async = is_async
        if is_async:
            t = threading.Thread(target=self._async_main, daemon=True,
                                 name=f"actor-{self.actor_id.hex()[:8]}-loop")
            t.start()
            self._threads.append(t)
        else:
            for gname, group in self._groups.items():
                for i in range(group["limit"]):
                    t = threading.Thread(
                        target=self._sync_main, args=(gname,), daemon=True,
                        name=(f"actor-{self.actor_id.hex()[:8]}"
                              f"-{gname or 'default'}-{i}"))
                    t.start()
                    self._threads.append(t)

    def _group_of(self, spec: TaskSpec) -> str:
        name = getattr(spec, "concurrency_group", "") or ""
        return name if name in self._groups else ""

    def submit_direct(self, fn: Callable[[Any], None],
                      on_dead: Optional[Callable[[str], None]] = None
                      ) -> bool:
        """A compiled DAG's channel op: run ``fn(instance)`` on this
        actor's executor thread, in FIFO order with its method calls, with
        none of the task machinery (no TaskSpec, scheduler, futures or
        refcounting on the per-call path)."""
        from ray_tpu_torch._private.ids import next_seqno
        with self._cond:
            if self._dead or self.is_async:
                return False
            self._push_seq += 1
            heapq.heappush(self._groups[""]["heap"],
                           (next_seqno(), self._push_seq,
                            _DirectOp(fn, on_dead)))
            self.num_pending += 1
            self._cond.notify_all()
        return True

    def submit(self, spec: TaskSpec) -> bool:
        with self._cond:
            if self._dead:
                return False
            # tiebreaker: TaskSpec is not orderable
            self._push_seq += 1
            heapq.heappush(self._groups[self._group_of(spec)]["heap"],
                           (spec.seqno, self._push_seq, spec))
            self.num_pending += 1
            self._cond.notify_all()
        return True

    def kill(self, cause: str) -> List[TaskSpec]:
        """Mark dead; return tasks that were still pending."""
        with self._cond:
            if self._dead:
                return []
            self._dead = True
            self.death_cause = cause
            dropped = [spec for g in self._groups.values()
                       for _, _, spec in g["heap"]]
            pending = [s for s in dropped if not isinstance(s, _DirectOp)]
            direct_ops = [s for s in dropped if isinstance(s, _DirectOp)]
            for g in self._groups.values():
                g["heap"].clear()
            self.num_pending = 0
            self._cond.notify_all()
        for op in direct_ops:   # fail the compiled DAG's channels now
            if op.on_dead is not None:
                try:
                    op.on_dead(cause)
                except Exception:
                    pass
        if self._loop is not None:
            try:
                self._loop.call_soon_threadsafe(self._loop.stop)
            except RuntimeError:
                pass    # the loop already closed
        return pending

    def _next(self, group: str = "") -> Optional[TaskSpec]:
        heap = self._groups[group]["heap"]
        with self._cond:
            while not heap and not self._dead:
                self._cond.wait()
            if self._dead:
                return None
            _, _, spec = heapq.heappop(heap)
            self.num_pending -= 1
            return spec

    def _next_any(self) -> Optional[TaskSpec]:
        """Async actors: one pump across all groups (semaphores bound
        per-group concurrency there)."""
        with self._cond:
            while not self._dead:
                for g in self._groups.values():
                    if g["heap"]:
                        _, _, spec = heapq.heappop(g["heap"])
                        self.num_pending -= 1
                        return spec
                self._cond.wait()
            return None

    def _sync_main(self, group: str = "") -> None:
        while True:
            spec = self._next(group)
            if spec is None:
                return
            if isinstance(spec, _DirectOp):
                try:
                    spec.fn(self.instance)
                except Exception:   # the op delivers errors on its channel
                    pass
                spec = None
                continue
            self._run_task(spec, self.instance)
            # drop the finished spec before waiting for the next: its args
            # hold ObjectRefs whose values would stay pinned until then
            spec = None

    def _async_main(self) -> None:
        loop = asyncio.new_event_loop()
        self._loop = loop
        asyncio.set_event_loop(loop)
        sems = {name: asyncio.Semaphore(g["limit"])
                for name, g in self._groups.items()}

        # asyncio holds only weak references to tasks: an unretained
        # handle() task can be collected mid-await, silently dropping the
        # actor call — keep strong refs until done
        inflight: set = set()

        def track(task):  #: loop-only
            inflight.add(task)
            task.add_done_callback(inflight.discard)

        async def handle(spec):
            async with sems[self._group_of(spec)]:
                await self._run_task_async(spec, self.instance)

        async def pump():
            while True:
                spec = await loop.run_in_executor(None, self._next_any)
                if spec is None:
                    loop.stop()
                    return
                track(loop.create_task(handle(spec)))
                spec = None     # the task holds it while it runs

        # the local binding retains the pump task for the whole run
        pump_task = loop.create_task(pump())  # noqa: F841
        try:
            loop.run_forever()
        finally:
            for task in asyncio.all_tasks(loop):
                task.cancel()
            # let cancellations unwind before closing the loop
            loop.run_until_complete(
                asyncio.gather(*asyncio.all_tasks(loop),
                               return_exceptions=True))
            loop.close()


class _ExecPool:
    """Sized task-execution pool fed by the dispatch loop: admitted batches
    are handed over in one lock acquisition and wakeup, the dispatch loop
    never blocks on a full pool, and threads are reused."""

    def __init__(self, size: int, run_spec: Callable[[TaskSpec], None],
                 name: str):
        self._run_spec = run_spec
        self._size = max(1, size)
        self._name = name
        self._cv = threading.Condition()
        self._q: deque = deque()    #: guarded by self._cv
        self._spawned = 0           #: guarded by self._cv
        self._idle = 0              #: guarded by self._cv
        self._stopped = False       #: guarded by self._cv

    def submit_batch(self, specs) -> None:
        with self._cv:
            self._q.extend(specs)
            # spawn only to cover queued work not already matched by an
            # idle worker; stale counters over-spawn (bounded by _size),
            # never under-spawn
            spawn = min(len(self._q) - self._idle,
                        self._size - self._spawned)
            spawn = max(0, spawn)
            self._spawned += spawn
            base = self._spawned
            self._cv.notify(len(specs))
        for i in range(spawn):
            threading.Thread(target=self._work, daemon=True,
                             name=f"{self._name}-{base - i}").start()

    def steal_pending(self) -> List[TaskSpec]:
        """Take every admitted-but-unstarted spec at once (drain handback,
        node death). Specs in flight finish on their threads."""
        with self._cv:
            out = list(self._q)
            self._q.clear()
        return out

    def has_handback_pending(self) -> bool:
        """Whether a queued spec could still be handed back. A spec the
        scheduler bounced back (nowhere else fits) stays and runs here:
        without this filter the drain pass would steal and requeue it at
        every pass until a thread freed up."""
        with self._cv:
            return any(not getattr(s, "_drain_bounced", False)
                       for s in self._q)

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify_all()

    def _work(self) -> None:
        try:
            while True:
                with self._cv:
                    self._idle += 1
                    while not self._q and not self._stopped:
                        self._cv.wait()
                    self._idle -= 1
                    if not self._q:
                        return      # stopped and drained
                    spec = self._q.popleft()
                try:
                    self._run_spec(spec)
                except BaseException:   # noqa: BLE001 — task errors are
                    # delivered through the runtime's finish paths; a
                    # stray escape must not kill a pool worker
                    pass
                # drop the finished spec before waiting for the next: its
                # args hold ObjectRefs whose values would stay pinned
                spec = None
        finally:
            with self._cv:
                self._spawned -= 1


def _bucket_job(key: tuple) -> str:
    """Job hex of a backlog bucket key. Tenancy-keyed buckets are
    ``(job_hex, shape_tuple)``; plain ones are the shape tuple itself
    (possible around an enablement toggle) and attribute to the
    anonymous driver job."""
    return key[0] if (len(key) == 2 and isinstance(key[0], str)) else ""


class Node:
    """One (virtual) node: resources + store + dispatch pass + actors."""

    def __init__(self, node_id: NodeID, resources: Dict[str, float],
                 labels: Dict[str, str], store: LocalObjectStore,
                 execute_task: Callable[[TaskSpec, "Node"], None],
                 max_worker_threads: int = 256):
        self.node_id = node_id
        self.ledger = ResourceLedger(resources)
        self.labels = dict(labels)
        self.store = store
        self._execute_task = execute_task
        self.alive = True
        # Graceful drain: alive + draining = running work finishes, no new
        # placements; the dispatch pass hands queued-but-unstarted tasks
        # back to the runtime for resubmission elsewhere.
        self.draining = False
        # memory-pressure level ("ok"/"soft"/"hard"), mirrored from the
        # daemon's node_pressure pushes; pick_node soft-excludes "hard"
        # nodes as it does draining ones
        self.pressure_level = "ok"
        # a daemon-backed node (cluster="daemons"): its DaemonHandle, and
        # the dependency-staging hook called at enqueue
        self.daemon = None
        self.prefetch: Optional[Callable[[TaskSpec], None]] = None
        # multi-tenant fair share (set by the runtime when the
        # ``fairshare`` flag is on): backlog buckets become (job, shape)
        # keyed, admission runs in deficit order under per-job quota
        # gates. None keeps this dispatch path the single-tenant one.
        self.tenancy = None
        # the last per-job backlog counts pushed to the tenancy ledger
        # (dispatch side only): an unchanged round skips the call
        self._tenancy_qcounts: Dict[str, int] = {}
        self.actors: Dict[ActorID, ActorExecutor] = {}  #: guarded by self._actors_lock
        self._actors_lock = tracked_lock("node.actors", reentrant=False)
        self._queue: "queue.Queue[Optional[TaskSpec]]" = queue.Queue()
        # Backlog bucketed by exact resource shape: one dispatch pass is
        # O(#shapes), not O(#queued tasks). FIFO order holds within a
        # shape; across shapes there is no ordering contract.
        self._backlog: "OrderedDict[tuple, deque]" = OrderedDict()
        self._backlog_n = 0
        # Demand of enqueued-but-not-yet-admitted tasks; lets the cluster
        # scheduler see load before the dispatch pass acquires resources.
        self._pending_demand: Dict[str, float] = {}  #: guarded by self._pending_lock
        self._pending_lock = tracked_lock("node.pending_demand",
                                          reentrant=False)
        # admitted tasks not yet finished (the drain waits for these)
        self._running: set = set()      #: guarded by self._running_lock
        self._running_lock = tracked_lock("node.running", reentrant=False)
        # Coalesced ledger-release staging (flat combining): completing
        # tasks append here; whichever thread finds no flush in progress
        # drains the whole batch with one release_many call.
        self._release_stage: List[Dict[str, float]] = []  #: guarded by self._stage_lock
        self._stage_flushing = False    #: guarded by self._stage_lock
        self._stage_lock = tracked_lock("node.release_stage",
                                        reentrant=False)
        from ray_tpu_torch._private.config import cfg
        pool_size = int(cfg().exec_pool_size) or max_worker_threads
        self._exec_pool = _ExecPool(pool_size, self._run_spec,
                                    name=f"task-{node_id.hex()[:8]}")
        # dispatch instrumentation (debug_state's loop=), filled by both
        # dispatchers
        self.loop_stats = {"dispatch_iterations": 0, "tasks_launched": 0,
                           "max_queue_lag_ms": 0.0, "launch_ms_total": 0.0}
        # async core: the dispatch pass is a callback on the process event
        # loop. Producers stage on a plain deque and arm one
        # call_soon_threadsafe per burst behind a dirty flag; ledger
        # releases wake the pass through the ledger's on_change hook.
        # Threaded core: the dispatch thread below.
        if cfg().async_core:
            from ray_tpu_torch._private import eventloop
            self._aloop = eventloop.get_loop()
            self._inbox: deque = deque()     # GIL-atomic append/popleft
            self._wake_armed = False         # dirty flag (benign races)
            self._stopped = False            #: loop-only
            self._stopped_evt = threading.Event()
            self._retry_timer = None         #: loop-only
            self._dispatcher = None
            self.ledger.on_change = self._wake_loop
        else:
            self._aloop = None
            self._dispatcher = threading.Thread(
                target=self._dispatch_loop, daemon=True,
                name=f"dispatch-{node_id.hex()[:8]}")
            self._dispatcher.start()

    def info(self) -> NodeInfo:
        return NodeInfo(node_id=self.node_id, alive=self.alive,
                        resources=dict(self.ledger.total),
                        labels=dict(self.labels))

    # -- normal task path --------------------------------------------------
    def enqueue(self, spec: TaskSpec) -> None:
        spec._enqueued_at = time.perf_counter()
        if self.prefetch is not None and spec.dependencies():
            # stage remote deps toward this node while the task waits for
            # admission (a cheap no-op when every dep is local)
            try:
                self.prefetch(spec)
            except Exception:
                pass    # staging is best-effort
        with self._pending_lock:
            for k, v in spec.resources.items():
                self._pending_demand[k] = self._pending_demand.get(k, 0.0) + v
        self._post(spec)

    def _post(self, item) -> None:
        """Dispatch-input hand-off. Threaded core: the blocking queue (one
        futex wake an item). Async core: stage on a plain deque and arm one
        call_soon_threadsafe per burst of submissions."""
        if self._aloop is None:
            self._queue.put(item)
            return
        self._inbox.append(item)
        self._wake_loop()

    def _wake_loop(self) -> None:
        # a benign race on the flag: two producers may both arm (the
        # second pass finds empty stages); a producer that sees the flag
        # already set is covered by the armed pass, which drains AFTER
        # clearing the flag
        if self._wake_armed or self._aloop is None:
            return
        self._wake_armed = True
        try:
            self._aloop.call_soon_threadsafe(self._loop_pass)
        except RuntimeError:
            pass    # the loop is gone (interpreter exit)

    def _drop_pending_many(self, specs) -> None:
        """One pending-lock round-trip for a whole admitted batch."""
        with self._pending_lock:
            for spec in specs:
                for k, v in spec.resources.items():
                    left = max(self._pending_demand.get(k, 0.0) - v, 0.0)
                    if left <= 1e-12:
                        self._pending_demand.pop(k, None)
                    else:
                        self._pending_demand[k] = left

    def effective_available(self) -> Dict[str, float]:
        """Available capacity minus demand already queued here."""
        avail = self.ledger.available()
        with self._pending_lock:
            for k, v in self._pending_demand.items():
                avail[k] = avail.get(k, 0.0) - v
        return avail

    def _dispatch_loop(self) -> None:
        while True:
            # Move newly queued tasks into the backlog buckets.
            try:
                timeout = 0.0 if self._backlog_n else _DISPATCH_POLL_S
                while True:
                    spec = self._queue.get(timeout=timeout)
                    if spec is None:
                        return
                    timeout = 0.0
                    if spec is _WAKE:
                        continue
                    self._ingest(spec)
                    spec = None     # the backlog holds it now
            except queue.Empty:
                pass
            progressed = self._dispatch_pass()
            if self._backlog_n and not progressed:
                self.ledger.wait_for_change(0.05)

    def _ingest(self, spec: TaskSpec) -> None:
        """Bucket one submitted spec into the backlog (the dispatch thread
        or the event loop, whichever owns the backlog in this mode)."""
        # re-read per spec: the runtime attaches the tenancy manager right
        # after construction
        ten = self.tenancy
        key = tuple(sorted(spec.resources.items()))
        if ten is not None:
            key = (spec.job_id.hex() if spec.job_id is not None else "",
                   key)
        bucket = self._backlog.get(key)
        if bucket is None:
            bucket = self._backlog[key] = deque()
        bucket.append(spec)
        self._backlog_n += 1

    def _loop_pass(self) -> None:  #: loop-only
        """One dispatch round on the process event loop (async core).

        The dirty flag is cleared first: a wake staged after the clear
        schedules a fresh pass, one staged before it is drained below (an
        occasional extra no-op pass is cheaper than a lost wake)."""
        self._wake_armed = False
        if self._retry_timer is not None:
            self._retry_timer.cancel()
            self._retry_timer = None
        if self._stopped:
            return
        inbox = self._inbox
        while inbox:
            item = inbox.popleft()
            if item is None:
                # node shutdown: the pass stops; shutdown() takes the
                # backlog once it sees this
                self._stopped = True
                self._stopped_evt.set()
                return
            if item is _WAKE:
                continue
            self._ingest(item)
        progressed = self._dispatch_pass()
        if self._backlog_n and not progressed and not self._stopped:
            # blocked on resources with no release in flight: poll-retry,
            # the threaded loop's wait_for_change(0.05); a real release
            # cancels this timer through the ledger's on_change wake
            self._retry_timer = self._aloop.call_later(0.05,
                                                       self._retry_pass)

    def _retry_pass(self) -> None:  #: loop-only
        self._retry_timer = None
        self._loop_pass()

    def _dispatch_pass(self) -> bool:
        """One admission pass over the backlog buckets (shared by both
        dispatchers). Returns whether any bucket made progress; the caller
        decides how to wait when blocked."""
        ten = self.tenancy
        if self.draining and (self._backlog_n
                              or self._exec_pool.has_handback_pending()):
            # hand queued-but-unstarted work back to the cluster scheduler
            # (no retry consumed): backlog entries AND specs already
            # admitted into the exec pool's queue. Whatever bounces back
            # (nowhere else fits) falls through and dispatches here.
            self._resubmit_backlog()
        progressed = False
        self.loop_stats["dispatch_iterations"] += 1
        if ten is not None and self._backlog:
            # deficit-ordered batch admission: a job's same-shape ready
            # group is taken whole, highest fair-share deficit first, so
            # a light job's small groups cut ahead of a saturating job's
            # backlog
            keys = [k for _job, k in ten.order_buckets(
                [((_bucket_job(k), k), len(b))
                 for k, b in self._backlog.items()])]
        else:
            keys = list(self._backlog)
        for key in keys:
            bucket = self._backlog.get(key)
            if bucket is None:
                continue
            while bucket:
                demand = bucket[0].resources
                want = len(bucket)
                if ten is not None:
                    # the per-job hard-cap gate: a clamped group stays
                    # QUEUED in the backlog (never lost) until the job's
                    # own completions free quota headroom
                    want = ten.admit_cap(_bucket_job(key), demand, want)
                    if want <= 0:
                        break
                # every task in a bucket shares one resource shape, so one
                # ledger round-trip admits as many as currently fit
                n = self.ledger.try_acquire_many(demand, want)
                if n <= 0:
                    break
                admitted = [bucket.popleft() for _ in range(n)]
                self._backlog_n -= n
                self._drop_pending_many(admitted)
                t0 = time.perf_counter()
                for spec in admitted:
                    # pairs this admission's ledger acquire with exactly
                    # one release: the runtime may release early (see
                    # worker._release_task_resources) or _run_spec's
                    # `finally` does
                    spec._resources_released = False
                    enq = getattr(spec, "_enqueued_at", 0.0)
                    if enq:
                        lag_ms = (t0 - enq) * 1000
                        if lag_ms > self.loop_stats["max_queue_lag_ms"]:
                            self.loop_stats["max_queue_lag_ms"] = lag_ms
                        _metrics.note_queue_dwell("node.dispatch",
                                                  lag_ms / 1000.0)
                        if spec.trace_sampled:
                            # the queue phase: backlog enqueue -> this
                            # admission; t0 doubles as the span's end
                            _events.record_phase_rt(
                                spec, "queue", lag_ms / 1000.0,
                                self.node_id.hex(),
                                start_wall=_events.wall_at(enq),
                                end_mono=t0)
                # counted before the pool takes them: a task may finish
                # (and a get observe it) before control returns here
                self.loop_stats["tasks_launched"] += n
                if ten is not None:
                    ten.note_admitted(_bucket_job(key), demand, n)
                with self._running_lock:
                    self._running.update(s.task_id for s in admitted)
                self._exec_pool.submit_batch(admitted)
                self.loop_stats["launch_ms_total"] += (
                    time.perf_counter() - t0) * 1000
                progressed = True
            if not bucket:
                self._backlog.pop(key, None)
        if ten is not None:
            counts: Dict[str, int] = {}
            for k, b in self._backlog.items():
                job = _bucket_job(k)
                counts[job] = counts.get(job, 0) + len(b)
            # unchanged since the last round: the ledger already saw this
            # state (its idle deficit reset included)
            if counts != self._tenancy_qcounts:
                self._tenancy_qcounts = counts
                ten.observe_queued(self.node_id.hex(), counts)
        return progressed

    def _run_spec(self, spec: TaskSpec) -> None:
        """One task's execution on an exec-pool worker thread."""
        try:
            self._execute_task(spec, self)
        finally:
            with self._running_lock:
                self._running.discard(spec.task_id)
            if (spec.kind != TaskKind.ACTOR_CREATION
                    and not getattr(spec, "_resources_released", True)):
                # Actors hold their resources for their whole lifetime;
                # the runtime releases them on actor death.
                spec._resources_released = True
                self.stage_release(spec.resources)
            ten = self.tenancy
            if ten is not None and spec.kind != TaskKind.ACTOR_CREATION:
                # per-job usage (a lock-free append); an actor creation
                # settles when the runtime releases its lifetime hold
                ten.note_done(spec.job_id.hex()
                              if spec.job_id is not None else "",
                              spec.resources)

    def is_idle(self) -> bool:
        """No task running, admitted or queued here (the drain's clean
        departure test)."""
        with self._running_lock:
            if self._running:
                return False
        if self._aloop is not None:
            return self._backlog_n == 0 and not self._inbox
        return self._backlog_n == 0 and self._queue.empty()

    # -- coalesced ledger release (flat combining) -----------------------
    def stage_release(self, resources: Dict[str, float]) -> None:
        """Release ledger resources, coalescing concurrent completions: if
        another thread is already flushing, this release rides its drain;
        otherwise this thread flushes inline. Async core: the completing
        thread releases into the ledger itself, whose on_change hook wakes
        the loop's dispatch pass, so a task's resources are back before
        its result is delivered (JAX's async core stages the release for
        the loop's next pass, and a read of the available resources right
        after a get could miss it)."""
        if self._aloop is not None:
            self.ledger.release(resources)
            return
        with self._stage_lock:
            self._release_stage.append(resources)
            if self._stage_flushing:
                return      # the in-flight flusher drains us too
            self._stage_flushing = True
        self._drain_release_stage()

    def _drain_release_stage(self) -> None:
        while True:
            with self._stage_lock:
                batch = self._release_stage
                if not batch:
                    self._stage_flushing = False
                    return
                self._release_stage = []
            try:
                self._release_batch(batch)
            except BaseException:
                # never leave the flusher flag stuck: staged entries
                # appended meanwhile drain on the next stage_release
                with self._stage_lock:
                    self._stage_flushing = False
                raise

    def _release_batch(self, batch) -> None:
        if len(batch) == 1:
            self.ledger.release(batch[0])
            return
        # group same-shape demands: one release_many call covers the batch
        groups: "OrderedDict[tuple, list]" = OrderedDict()
        for res in batch:
            key = tuple(sorted(res.items()))
            entry = groups.get(key)
            if entry is None:
                groups[key] = [res, 1]
            else:
                entry[1] += 1
        self.ledger.release_many(groups.values())

    # -- graceful drain ----------------------------------------------------
    def start_drain(self) -> None:
        """Enter the DRAINING state: running tasks finish, the dispatch
        pass returns queued work to the runtime, the scheduler stops
        placing here. Any thread; the backlog itself stays the
        dispatcher's (woken by the sentinel)."""
        self.draining = True
        # DRAINING must leave cached pick_node candidate sets now
        _bump_cluster_epoch()
        self._post(_WAKE)

    @staticmethod
    def _notify_off_loop(fn: Callable[[], None]) -> None:
        """Run runtime notifications off the event loop: the lost and
        drained callbacks resubmit through the scheduler and may make
        blocking RPCs (which raise on the loop by design)."""
        from ray_tpu_torch._private import eventloop
        if eventloop.on_loop():
            threading.Thread(target=fn, daemon=True,
                             name="node-notify").start()
        else:
            fn()

    def _resubmit_backlog(self) -> None:
        """Graceful-drain pass (dispatcher only): queued tasks not bounced
        before go back to the cluster scheduler; a task the scheduler sent
        back here (nothing else fits) keeps its spot and runs locally."""
        from ray_tpu_torch._private import worker
        rt = worker.global_runtime()
        if rt is None:
            return
        keep: "OrderedDict[tuple, deque]" = OrderedDict()
        moved: List[TaskSpec] = []
        for key, bucket in self._backlog.items():
            stay: deque = deque()
            for spec in bucket:
                if getattr(spec, "_drain_bounced", False):
                    stay.append(spec)
                else:
                    moved.append(spec)
            if stay:
                keep[key] = stay
        self._backlog = keep
        self._backlog_n = sum(len(b) for b in keep.values())
        self._drop_pending_many(moved)
        drained = moved + self._steal_drain_handback()
        if drained:
            def _notify() -> None:
                for spec in drained:
                    rt.on_node_task_drained(spec, self)
            self._notify_off_loop(_notify)

    def _steal_drain_handback(self) -> List[TaskSpec]:
        """Admitted-but-unstarted specs still in the exec pool's queue are
        stolen back and their ledger admission undone, to be handed to the
        scheduler like backlog entries (no retry consumed). Bounced-back
        specs (nothing else fits) re-feed the pool and run here."""
        stolen = self._exec_pool.steal_pending()
        if not stolen:
            return []
        requeue = [s for s in stolen if getattr(s, "_drain_bounced", False)]
        handback = [s for s in stolen
                    if not getattr(s, "_drain_bounced", False)]
        if requeue:
            self._exec_pool.submit_batch(requeue)
        with self._running_lock:
            for spec in handback:
                self._running.discard(spec.task_id)
        for spec in handback:
            # undo the admission's ledger acquire before rescheduling
            if not getattr(spec, "_resources_released", True):
                spec._resources_released = True
                self.stage_release(spec.resources)
                if self.tenancy is not None:
                    self.tenancy.note_done(
                        spec.job_id.hex()
                        if spec.job_id is not None else "",
                        spec.resources)
        return handback

    # -- actor hosting -----------------------------------------------------
    def host_actor(self, executor: ActorExecutor) -> None:
        with self._actors_lock:
            self.actors[executor.actor_id] = executor

    def evict_actor(self, actor_id: ActorID) -> None:
        with self._actors_lock:
            self.actors.pop(actor_id, None)

    # -- lifecycle ---------------------------------------------------------
    def shutdown(self) -> Dict[ActorID, List[TaskSpec]]:
        """Stop the node; returns per-actor pending tasks. Tasks still
        queued here (not yet admitted, or admitted and not started) go back
        to the runtime as lost to the node's death: retried elsewhere, or
        failed."""
        self.alive = False
        _bump_cluster_epoch()
        self._post(None)
        pending_by_actor: Dict[ActorID, List[TaskSpec]] = {}
        with self._actors_lock:
            actors = dict(self.actors)
            self.actors.clear()
        for aid, ex in actors.items():
            pending_by_actor[aid] = ex.kill("node died")
        # the backlog is the dispatcher's: take it once the dispatcher has
        # stopped (the dispatch thread joined, or the loop pass that saw
        # the sentinel)
        if self._aloop is not None:
            from ray_tpu_torch._private import eventloop
            if eventloop.on_loop():
                self._stopped = True
            else:
                self._stopped_evt.wait(timeout=5.0)
            self._fail_backlog()
        elif threading.current_thread() is not self._dispatcher:
            self._dispatcher.join(timeout=5.0)
            self._fail_backlog()
        self._fail_pool_pending()
        # let in-flight pool work unwind, then retire the idle threads
        self._exec_pool.stop()
        return pending_by_actor

    def _fail_backlog(self) -> None:
        backlog = [spec for bucket in self._backlog.values()
                   for spec in bucket]
        self._backlog = OrderedDict()
        self._backlog_n = 0
        while True:
            try:
                spec = self._queue.get_nowait()
            except queue.Empty:
                break
            if spec is not None and spec is not _WAKE:
                backlog.append(spec)
        if self._aloop is not None:
            while self._inbox:
                spec = self._inbox.popleft()
                if spec is not None and spec is not _WAKE:
                    backlog.append(spec)
        if not backlog:
            return
        self._drop_pending_many(backlog)
        self._notify_lost(backlog)

    def _fail_pool_pending(self) -> None:
        """Node death with specs admitted but not started: the same
        lost-task flow as the backlog."""
        stolen = self._exec_pool.steal_pending()
        if not stolen:
            return
        with self._running_lock:
            for spec in stolen:
                self._running.discard(spec.task_id)
        self._notify_lost(stolen)

    def _notify_lost(self, specs: List[TaskSpec]) -> None:
        from ray_tpu_torch._private import worker
        rt = worker.global_runtime()
        if rt is None:
            return

        def _notify() -> None:
            for spec in specs:
                rt.on_node_task_lost(spec, self)
        self._notify_off_loop(_notify)
