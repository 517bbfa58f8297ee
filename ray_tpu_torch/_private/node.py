"""Per-node runtime: resource accounting, task dispatch, actor hosting
(counterpart of ``ray_tpu/_private/node.py``).

Each node owns a resource ledger, a backlog of tasks gated on resource
availability, a pool of threads that executes them, and the actor executors
living on the node. The scheduler (:mod:`ray_tpu_torch._private.scheduler`)
assigns a task to a node, the node's dispatch thread admits it when
resources free up, and a pooled thread runs it.

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
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch._private.gcs import NodeInfo
from ray_tpu_torch._private.ids import ActorID, NodeID
from ray_tpu_torch._private.object_store import LocalObjectStore
from ray_tpu_torch._private.task_spec import TaskKind, TaskSpec

_DISPATCH_POLL_S = 5.0


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
            pending = [spec for g in self._groups.values()
                       for _, _, spec in g["heap"]]
            for g in self._groups.values():
                g["heap"].clear()
            self.num_pending = 0
            self._cond.notify_all()
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


class Node:
    """One (virtual) node: resources + store + dispatch loop + actors."""

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
        # a daemon-backed node (cluster="daemons"): its DaemonHandle, and
        # the dependency-staging hook called at enqueue
        self.daemon = None
        self.prefetch: Optional[Callable[[TaskSpec], None]] = None
        self.actors: Dict[ActorID, ActorExecutor] = {}  #: guarded by self._actors_lock
        self._actors_lock = threading.Lock()
        self._queue: "queue.Queue[Optional[TaskSpec]]" = queue.Queue()
        # Backlog bucketed by exact resource shape: one dispatch pass is
        # O(#shapes), not O(#queued tasks). FIFO order holds within a
        # shape; across shapes there is no ordering contract.
        self._backlog: "OrderedDict[tuple, deque]" = OrderedDict()
        self._backlog_n = 0
        # Demand of enqueued-but-not-yet-admitted tasks; lets the cluster
        # scheduler see load before the dispatch loop acquires resources.
        self._pending_demand: Dict[str, float] = {}  #: guarded by self._pending_lock
        self._pending_lock = threading.Lock()
        # Coalesced ledger-release staging (flat combining): completing
        # tasks append here; whichever thread finds no flush in progress
        # drains the whole batch with one release_many call.
        self._release_stage: List[Dict[str, float]] = []  #: guarded by self._stage_lock
        self._stage_flushing = False    #: guarded by self._stage_lock
        self._stage_lock = threading.Lock()
        from ray_tpu_torch._private.config import cfg
        pool_size = int(cfg().exec_pool_size) or max_worker_threads
        self._exec_pool = _ExecPool(pool_size, self._run_spec,
                                    name=f"task-{node_id.hex()[:8]}")
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
        self._queue.put(spec)

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
                    self._ingest(spec)
                    spec = None     # the backlog holds it now
                    timeout = 0.0
            except queue.Empty:
                pass
            progressed = self._dispatch_pass()
            if self._backlog_n and not progressed:
                self.ledger.wait_for_change(0.05)

    def _ingest(self, spec: TaskSpec) -> None:
        """Bucket one submitted spec into the backlog (dispatch thread)."""
        key = tuple(sorted(spec.resources.items()))
        bucket = self._backlog.get(key)
        if bucket is None:
            bucket = self._backlog[key] = deque()
        bucket.append(spec)
        self._backlog_n += 1

    def _dispatch_pass(self) -> bool:
        """One admission pass over the backlog buckets. Returns whether any
        bucket made progress."""
        progressed = False
        for key in list(self._backlog):
            bucket = self._backlog.get(key)
            if bucket is None:
                continue
            while bucket:
                demand = bucket[0].resources
                # every task in a bucket shares one resource shape, so one
                # ledger round-trip admits as many as currently fit
                n = self.ledger.try_acquire_many(demand, len(bucket))
                if n <= 0:
                    break
                admitted = [bucket.popleft() for _ in range(n)]
                self._backlog_n -= n
                self._drop_pending_many(admitted)
                for spec in admitted:
                    # pairs this admission's ledger acquire with exactly
                    # one release: the runtime may release early (see
                    # worker._release_task_resources) or _run_spec's
                    # `finally` does
                    spec._resources_released = False
                self._exec_pool.submit_batch(admitted)
                progressed = True
            if not bucket:
                self._backlog.pop(key, None)
        return progressed

    def _run_spec(self, spec: TaskSpec) -> None:
        """One task's execution on an exec-pool worker thread."""
        try:
            self._execute_task(spec, self)
        finally:
            if (spec.kind != TaskKind.ACTOR_CREATION
                    and not getattr(spec, "_resources_released", True)):
                # Actors hold their resources for their whole lifetime;
                # the runtime releases them on actor death.
                spec._resources_released = True
                self.stage_release(spec.resources)

    # -- coalesced ledger release (flat combining) -----------------------
    def stage_release(self, resources: Dict[str, float]) -> None:
        """Release ledger resources, coalescing concurrent completions: if
        another thread is already flushing, this release rides its drain;
        otherwise this thread flushes inline."""
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
        queued here (not yet admitted) go back to the runtime as lost to
        the node's death: retried elsewhere, or failed."""
        self.alive = False
        _bump_cluster_epoch()
        self._queue.put(None)
        pending_by_actor: Dict[ActorID, List[TaskSpec]] = {}
        with self._actors_lock:
            actors = dict(self.actors)
            self.actors.clear()
        for aid, ex in actors.items():
            pending_by_actor[aid] = ex.kill("node died")
        if threading.current_thread() is not self._dispatcher:
            # the backlog is the dispatch thread's: take it once that
            # thread has stopped
            self._dispatcher.join(timeout=5.0)
            self._fail_backlog()
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
            if spec is not None:
                backlog.append(spec)
        if not backlog:
            return
        self._drop_pending_many(backlog)
        from ray_tpu_torch._private import worker
        rt = worker.global_runtime()
        if rt is not None:
            for spec in backlog:
                rt.on_node_task_lost(spec, self)
