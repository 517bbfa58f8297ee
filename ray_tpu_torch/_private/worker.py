"""The Runtime: task submission, execution, objects, actors (counterpart of
``ray_tpu/_private/worker.py``).

The core-worker role: task submission, the dependency resolver, result
storage (an inline memory store for small values, node object stores for
large ones), reference-counting hooks, task retries, streaming generators
and the actor lifecycle driven through GCS state.

Topology: one Runtime per process hosts N virtual nodes, and a
``ProcessRouter`` (``_private/worker_process.py``) sends host work to
worker processes, as the reference's runtime does by default: a normal task
or a synchronous actor runs in a pooled worker process that cannot see the
card. The accelerator plane stays in this process, on the nodes' pooled
threads (``_execute_inline``): a task or actor with a ``GPU`` demand, an
``_in_process`` actor (serve's replicas, the train worker group), a task
or actor whose payload names the card (a CUDA tensor or ``torch.device``
in its arguments or its function's closure), an asyncio actor, and
anything the wire cannot pickle. The card is owned by this one process, and CUDA tensors
stay in the object store's device tier with no copy. The switch is the
reference's ``RAY_TPU_PROCESS_WORKERS`` (``_system_config``'s
``process_workers``); ``0`` runs every task and actor here.

The daemon cluster (``init(cluster="daemons")``, JAX's ``RAY_TPU_CLUSTER``):
a head and node-daemon OS processes (``_private/cluster.py``); each daemon
is a schedulable node whose store is a ``RemoteStore`` and whose host work
runs in the daemon's workers (``_execute_on_remote_node``). The driver
stays the single controller, the owner of every object and the one process
on the card. A node that dies (a SIGKILLed daemon, or ``remove_node``)
loses its objects, which lineage reconstructs on the next get, wait or
dependent task (``_lost``, ``_ensure_available``); its tasks retry and its
actors restart elsewhere.

Observability (``_private/events.py``): every task's state transitions and,
for traced tasks (the ``task_trace`` flag, on by default), its per-phase
spans go into ``Runtime.task_events``; a daemon cluster's backend flushes
them to the head's task-event store. The driver also runs the log monitor
(its workers' output, prefixed), the memory monitor over its workers, and,
with ``profiling_hz`` set, a continuous stack sampler.
"""

from __future__ import annotations

import copy
import inspect
import os
import shutil
import sys
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from ray_tpu_torch import exceptions as exc
from ray_tpu_torch._private import failpoints as _fp
from ray_tpu_torch._private import events as trace_events
from ray_tpu_torch._private import runtime_context
from ray_tpu_torch._private.gcs import GCS, ActorInfo, ActorState
from ray_tpu_torch._private.ids import (ActorID, JobID, NodeID, ObjectID,
                                        TaskID, WorkerID)
from ray_tpu_torch._private.node import ActorExecutor, Node
from ray_tpu_torch._private.object_ref import FutureTable, ObjectRef
from ray_tpu_torch._private.object_store import LocalObjectStore, _nbytes_of
from ray_tpu_torch._private.refcount import LineageTable, ReferenceCounter
from ray_tpu_torch._private.scheduler import (ClusterScheduler,
                                              SchedulingError,
                                              bump_cluster_epoch)
from ray_tpu_torch._private.task_spec import (
    PlacementGroupSchedulingStrategy, TaskKind, TaskSpec)
from ray_tpu_torch.util.placement_group import (PlacementGroupManager,
                                                scoped_resource)

# Values at or below this go to the owner's in-process memory store
# (the reference's max_direct_call_object_size, 100 KiB).
INLINE_OBJECT_SIZE = 100 * 1024

_global_runtime: Optional["Runtime"] = None
_global_lock = threading.Lock()


def global_runtime() -> Optional["Runtime"]:
    return _global_runtime


def global_worker() -> "Runtime":
    if _global_runtime is None:
        raise RuntimeError(
            "ray_tpu_torch has not been initialized; call "
            "ray_tpu_torch.init() first")
    return _global_runtime


class TaskState:
    PENDING_DEPS = "PENDING_ARGS_AVAIL"
    QUEUED = "PENDING_NODE_ASSIGNMENT"
    RUNNING = "RUNNING"
    FINISHED = "FINISHED"
    FAILED = "FAILED"
    CANCELLED = "CANCELLED"


class _InFlightTask:
    __slots__ = ("spec", "state", "node_id", "cancelled", "deps_remaining",
                 "lock")

    def __init__(self, spec: TaskSpec):
        self.spec = spec
        self.state = TaskState.PENDING_DEPS
        self.node_id: Optional[NodeID] = None
        self.cancelled = False
        self.deps_remaining = 0
        self.lock = threading.Lock()


class GeneratorState:
    """Producer/consumer state for a streaming-generator task: items are
    reported as they are produced, and an optional backpressure bound
    parks the producer until the consumer catches up."""

    def __init__(self, backpressure_num_objects: int = -1):
        self.cond = threading.Condition()
        self.items: List[ObjectRef] = []
        self.produced = 0
        self.consumed = 0
        self.finished = False
        self.error: Optional[BaseException] = None
        self.backpressure = backpressure_num_objects

    def report_item(self, ref: ObjectRef) -> None:
        with self.cond:
            self.items.append(ref)
            self.produced += 1
            self.cond.notify_all()
            if self.backpressure > 0:
                while (not self.finished
                       and self.produced - self.consumed >= self.backpressure):
                    self.cond.wait(1.0)

    def finish(self, error: Optional[BaseException] = None) -> None:
        with self.cond:
            self.finished = True
            self.error = error
            self.cond.notify_all()

    def next_ref(self, index: int, timeout: Optional[float] = None):
        deadline = None if timeout is None else time.monotonic() + timeout
        with self.cond:
            while True:
                if index < len(self.items):
                    ref = self.items[index]
                    # handed out once: the consumer's ref keeps the item
                    # alive from here, and this table must not pin it
                    self.items[index] = None
                    self.consumed = max(self.consumed, index + 1)
                    self.cond.notify_all()
                    return ref
                if self.finished:
                    if self.error is not None:
                        raise self.error
                    raise StopIteration
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise exc.GetTimeoutError("generator item timeout")
                self.cond.wait(remaining)


class Runtime:
    def __init__(self, num_nodes: int = 1,
                 resources_per_node: Optional[Dict[str, float]] = None,
                 object_store_memory: int = 2 * 1024 ** 3,
                 namespace: Optional[str] = None,
                 session_dir: Optional[str] = None,
                 cluster: Optional[str] = None,
                 address: Optional[str] = None,
                 job_config=None):
        self.job_id = JobID.from_random()
        self.worker_id = WorkerID.from_random()
        self.namespace = namespace or self.job_id.hex()
        # the per-job config: its runtime env is the job's default one
        # (prepare_runtime_env). The code search path rides that env as
        # py_modules, so pooled workers forked before this init see it
        # too; it also joins this process's sys.path for local imports.
        self.job_config = job_config
        self._job_default_env = None
        if job_config is not None:
            env = dict(job_config.runtime_env or {})
            if job_config.code_search_path:
                paths = [os.path.abspath(p)
                         for p in job_config.code_search_path]
                env["py_modules"] = (list(env.get("py_modules") or [])
                                     + paths)
                for p in paths:
                    if p not in sys.path:
                        sys.path.insert(0, p)
            self._job_default_env = env or None
        # spilled objects land here; created on the first spill only
        self.session_dir = session_dir or os.path.join(
            tempfile.gettempdir(), "ray_tpu_torch",
            f"session_{self.job_id.hex()}")

        # Worker log capture and the tail to the driver. The log dir is
        # process-stable, not per session: pooled workers outlive a
        # runtime and keep writing there; start_at_end skips an earlier
        # session's lines.
        self._log_monitor = None
        from ray_tpu_torch._private import log_monitor as _lm
        if _lm.log_to_driver_enabled():
            self._log_monitor = _lm.LogMonitor(
                _lm.session_log_dir(), _lm.make_driver_printer(),
                start_at_end=True)

        self.gcs = GCS()
        self.scheduler = ClusterScheduler()
        # multi-tenant fair share (tenancy/): submit-time verdicts and
        # deficit-ordered dispatch. The manager always exists (job records
        # and /api/jobs work either way); it hooks into the scheduler and
        # the nodes only when the ``fairshare`` flag is on.
        from ray_tpu_torch.tenancy import TenancyManager
        self.tenancy = TenancyManager(runtime=self)
        if self.tenancy.enabled:
            self.scheduler.tenancy = self.tenancy
        self.futures = FutureTable()
        self.lineage = LineageTable()
        self.refcounter = ReferenceCounter(on_zero=self._free_object)

        # Owner memory store: inline values and error objects.
        self.memory_store = LocalObjectStore(
            NodeID.nil(), capacity_bytes=1 << 62)

        from ray_tpu_torch._private.lock_sanitizer import tracked_lock
        self._nodes: Dict[NodeID, Node] = {}  #: guarded by self._nodes_lock
        self._nodes_lock = tracked_lock("worker.nodes")     # reentrant
        #: guarded by self._loc_lock
        self._locations: Dict[ObjectID, Set[NodeID]] = {}
        # reentrant: a cyclic GC pass may run an ObjectRef's __del__ (and
        # so _free_object) on a thread that already holds it
        self._loc_lock = tracked_lock("worker.locations")

        self._tasks: Dict[TaskID, _InFlightTask] = {}  #: guarded by self._tasks_lock
        self._tasks_lock = tracked_lock("worker.tasks", reentrant=False)
        # objects whose every copy died with a node: reconstructed from
        # lineage on the next get, wait or dependent submit
        self._lost: Set[ObjectID] = set()  #: guarded by self._loc_lock
        # actor_id -> DaemonHandle of actors hosted in node daemons
        self._remote_actors: Dict[ActorID, Any] = {}
        # (dep, dest node) pushes in flight (driver-side prefetch dedupe)
        self._prefetch_inflight: Set[Tuple[ObjectID, NodeID]] = set()
        self._prefetch_lock = threading.Lock()
        self._prefetch_pool = None
        self.stats: Dict[str, int] = {"tasks_submitted": 0,
                                      "tasks_finished": 0,
                                      "objects_reconstructed": 0,
                                      "objects_push_prefetched": 0,
                                      "tasks_retried": 0,
                                      "actor_restarts": 0,
                                      # graceful drain, JAX's keys
                                      "drains_total": 0,
                                      "drain_objects_migrated": 0,
                                      "drain_actors_migrated": 0,
                                      "drain_escalations_total": 0}

        self.task_events = trace_events.TaskEventBuffer()
        # the continuous profiler (profiling_hz, off by default): the
        # driver's lane of util.state.cluster_profile
        from ray_tpu_torch.util import profiling
        profiling.maybe_start_from_config("driver")

        #: guarded by self._actor_lock
        self._actor_pending_tasks: Dict[ActorID, List[TaskSpec]] = {}
        self._actor_lock = tracked_lock("worker.actors")    # reentrant
        self._actor_executors: Dict[ActorID, ActorExecutor] = {}

        self._generators: Dict[TaskID, GeneratorState] = {}
        self._shutdown = False
        # the declared TPU slice (the tpu_topology flag): placement groups
        # that hold chips claim contiguous sub-slices of it. On one card
        # the slice is virtual: it binds the nodes to torus hosts.
        from ray_tpu_torch._private.config import cfg as _cfg
        self.tpu_topology = None
        if _cfg().tpu_topology:
            from ray_tpu_torch.parallel.topology import TpuTopologyManager
            self.tpu_topology = TpuTopologyManager.from_spec(
                _cfg().tpu_topology)
        self.pg_manager = PlacementGroupManager(self)
        # deterministic fault injection and network chaos: the flags arm
        # this process and export their env form, so the daemons, head
        # and workers it spawns arm the same seams and links
        from ray_tpu_torch._private import failpoints as _failpoints
        from ray_tpu_torch._private import netchaos as _netchaos
        _failpoints.maybe_activate_from_config(_cfg())
        _netchaos.maybe_activate_from_config(_cfg())
        _netchaos.set_local_role("driver")
        from ray_tpu_torch._private import eventloop
        eventloop.set_proc_label("driver")

        # Process workers: the default path for host-plane tasks and
        # actors. Accelerator-plane work stays in this process, which owns
        # the card.
        from ray_tpu_torch._private.worker_process import ProcessRouter
        self.process_router = ProcessRouter(self)

        # OOM defense: sample the host's memory, kill a worker by policy
        # on a breach. The driver, which owns the card, is never a victim.
        from ray_tpu_torch._private.config import cfg
        from ray_tpu_torch._private.memory_monitor import MemoryMonitor
        self.memory_monitor = MemoryMonitor(self)
        if cfg().memory_monitor:
            self.memory_monitor.start()

        # a driver that joins a running cluster takes the nodes' resources
        # from its head: it detects none (detection imports torch, seconds
        # of a CLI command's or a CPU driver's start)
        if resources_per_node is None and not address:
            resources_per_node = self._detect_resources()
        self.cluster_backend = None
        if cluster is None:
            cluster = cfg().cluster or None
        if address:
            # join a running cluster (`ray-tpu start`) as a new driver:
            # nothing is spawned, and shutdown leaves the cluster up
            from ray_tpu_torch._private.cluster import ClusterBackend
            backend = ClusterBackend.attach(self, address)
            self.cluster_backend = backend
            for node_id, handle in list(backend.daemons.items()):
                self.add_remote_node(handle,
                                     dict(backend.node_resources[node_id]))
        elif cluster == "daemons":
            # a head and node-daemon OS processes behind the wire; every
            # schedulable node is a daemon. Accelerator-plane work still
            # runs here, on the node's dispatch thread (_execute_inline).
            from ray_tpu_torch._private.cluster import ClusterBackend
            backend = ClusterBackend(self, num_nodes,
                                     dict(resources_per_node),
                                     object_store_bytes=object_store_memory)
            self.cluster_backend = backend
            for handle in list(backend.daemons.values()):
                self.add_remote_node(handle, dict(resources_per_node))
        elif cluster:
            raise ValueError(f"cluster={cluster!r}: expected None, '' or "
                             f"'daemons'")
        else:
            for _ in range(num_nodes):
                self.add_node(dict(resources_per_node),
                              object_store_memory=object_store_memory)
        if self.cluster_backend is not None and self.tenancy.enabled:
            # quota records persisted at the head (another driver, or an
            # earlier incarnation of this one, may have set them)
            self.tenancy.load_from_head(self.cluster_backend.head)

    # ------------------------------------------------------------------
    # cluster topology
    # ------------------------------------------------------------------
    @staticmethod
    def _detect_resources() -> Dict[str, float]:
        """This host's CPUs, and its CUDA cards as ``GPU`` when it has any:
        a host without a card has no ``GPU`` key, so a ``num_gpus`` demand
        fails there instead of running on the CPU."""
        res: Dict[str, float] = {"CPU": float(os.cpu_count() or 1)}
        if os.environ.get("CUDA_VISIBLE_DEVICES") == "":
            return res      # the card is hidden: no torch import to learn it
        import torch
        if torch.cuda.is_available():
            res["GPU"] = float(torch.cuda.device_count())
        return res

    def add_node(self, resources: Dict[str, float],
                 labels: Optional[Dict[str, str]] = None,
                 object_store_memory: int = 2 * 1024 ** 3) -> Node:
        node_id = NodeID.from_random()
        store = LocalObjectStore(
            node_id, object_store_memory,
            spill_dir=os.path.join(self.session_dir, "spill",
                                   node_id.hex()[:8]))
        node = Node(node_id, resources, labels or {}, store,
                    execute_task=self._execute_on_node)
        if self.tenancy.enabled:
            node.tenancy = self.tenancy
        with self._nodes_lock:
            self._nodes[node_id] = node
        self.gcs.register_node(node.info())
        bump_cluster_epoch()
        return node

    def add_remote_node(self, handle, resources: Dict[str, float]) -> Node:
        """Register a node daemon process as a schedulable node. The Node
        machinery (ledger, dispatch queue) runs here, as the single
        controller's placement; execution, workers and the object payloads
        live in the daemon."""
        from ray_tpu_torch._private.cluster import RemoteStore
        store = RemoteStore(handle)
        node = Node(handle.node_id, resources, {}, store,
                    execute_task=self._execute_on_remote_node)
        if self.tenancy.enabled:
            node.tenancy = self.tenancy
        node.daemon = handle
        handle.runtime = self
        # dependency staging: enqueue-time pushes overlap the transfer
        # with the task's queue wait (the PushManager dedupes)
        node.prefetch = (lambda spec, _node=node:
                         self._push_prefetch_deps(spec, _node))
        with self._nodes_lock:
            self._nodes[handle.node_id] = node
        self.gcs.register_node(node.info())
        bump_cluster_epoch()
        return node

    def _push_prefetch_deps(self, spec: TaskSpec, node: Node) -> None:
        """Push task deps that live only on OTHER daemon nodes to ``node``:
        by the time the task (or a same-node consumer) needs them, a local
        copy exists. Failures are harmless (the on-demand path still
        serves the object)."""
        deps = spec.dependencies()
        if not deps or getattr(node, "daemon", None) is None:
            return
        from ray_tpu_torch._private.config import cfg
        if not cfg().push_prefetch:
            return
        if getattr(node, "pressure_level", "ok") != "ok":
            # soft or hard memory pressure: stage no optional copies onto
            # the node; the demand pull still serves the task's arguments
            # when it runs
            return
        with self._loc_lock:
            locs = {dep: list(self._locations.get(dep, ()))
                    for dep in deps}
        work = []
        for dep, node_ids in locs.items():
            if not node_ids or node.node_id in node_ids:
                continue
            src = self.get_node(node_ids[0])
            src_daemon = getattr(src, "daemon", None)
            meta_of = getattr(getattr(src, "store", None), "meta_of",
                              None)
            if (src is None or not src.alive or src_daemon is None
                    or meta_of is None or node.store.contains(dep)):
                continue
            # driver-side (dep, dest) dedupe: a fan-out of tasks sharing
            # one dep stages it once
            fly = (dep, node.node_id)
            with self._prefetch_lock:
                if fly in self._prefetch_inflight:
                    continue
                self._prefetch_inflight.add(fly)
            try:
                key, nbytes, raw = meta_of(dep)
            except KeyError:
                with self._prefetch_lock:
                    self._prefetch_inflight.discard(fly)
                continue
            work.append((dep, fly, src_daemon, key, nbytes, raw))

        def run_one(dep, fly, src_daemon, key, nbytes, raw) -> None:
            try:
                out = src_daemon.push_object(
                    key, node.daemon.addr, ref=dep.binary())
                if out.get("ok"):
                    node.store.register_remote(dep, key, nbytes, raw=raw)
                    with self._loc_lock:
                        self._locations.setdefault(dep, set()).add(
                            node.node_id)
                    self.stats["objects_push_prefetched"] += 1
            except Exception:
                pass            # the on-demand path covers it
            finally:
                with self._prefetch_lock:
                    self._prefetch_inflight.discard(fly)

        if work and self._prefetch_pool is None:
            from ray_tpu_torch._private.thread_pool import DaemonThreadPool
            self._prefetch_pool = DaemonThreadPool(4, name="push-prefetch")
        for item in work:
            # a small shared pool, never a thread a task: a fan-out of
            # tasks with remote deps must not park a thread each in a push
            self._prefetch_pool.submit(lambda it=item: run_one(*it))

    def pull_to_node(self, oid: ObjectID, node: Node,
                     priority: int = 2) -> bool:
        """Copy an object that lives on another daemon to ``node``'s daemon
        by one chunked daemon-to-daemon pull (the pull twin of the push
        prefetch), indexed there for the node's workers and recorded as a
        location. False when no daemon holds it or the pull failed."""
        if getattr(node, "daemon", None) is None:
            return False
        if node.store.contains(oid):
            return True
        with self._loc_lock:
            node_ids = list(self._locations.get(oid, ()))
        for node_id in node_ids:
            src = self.get_node(node_id)
            if src is None or not src.alive or src.daemon is None:
                continue
            key, nbytes, raw = src.store.meta_of(oid)
            if node.daemon.pull_object(key, src.daemon.addr, priority,
                                       ref=oid.binary(), raw=raw):
                node.store.register_remote(oid, key, nbytes, raw=raw)
                with self._loc_lock:
                    self._locations.setdefault(oid, set()).add(node.node_id)
                return True
        return False

    def remove_node(self, node: Node, _from_cluster: bool = False) -> None:
        """Node failure: its objects are lost, its tasks retry and its
        actors die (and may restart). A daemon-backed node's process is
        killed (``_from_cluster``: the cluster already saw it die)."""
        bump_cluster_epoch()    # before the pop: no stale cache window
        with self._nodes_lock:
            present = self._nodes.pop(node.node_id, None) is not None
        if not present:
            return      # already removed: the death flow runs once
        handle = getattr(node, "daemon", None)
        if handle is not None and not _from_cluster:
            handle.sigkill()
            if self.cluster_backend is not None:
                try:
                    self.cluster_backend.head.mark_node_dead(
                        node.node_id.hex(), "removed")
                except Exception:
                    pass
        pending_by_actor = node.shutdown()
        self.gcs.mark_node_dead(node.node_id)
        # the node's objects are lost: a copy elsewhere serves them, else
        # lineage reconstructs them on demand
        lost = node.store.object_ids()
        with self._loc_lock:
            for oid in lost:
                locs = self._locations.get(oid)
                if locs is not None:
                    locs.discard(node.node_id)
                    if not locs:
                        del self._locations[oid]
                        self.futures.reset(oid)
                        self._lost.add(oid)
        node.store.close()
        self.pg_manager.on_node_death(node.node_id)
        # actors on this node die (and may restart)
        for actor_id, pending in pending_by_actor.items():
            self._handle_actor_death(actor_id, "node died",
                                     pending_tasks=pending,
                                     may_restart=True)

    def _ensure_available(self, oid: ObjectID) -> None:
        """Start lineage reconstruction if every copy of ``oid`` was lost."""
        with self._loc_lock:
            was_lost = oid in self._lost
            self._lost.discard(oid)
        if was_lost:
            self._recover_object(ObjectRef(oid, _register=False))

    def nodes(self) -> List[Node]:
        with self._nodes_lock:
            return list(self._nodes.values())

    def alive_nodes(self) -> List[Node]:
        return [n for n in self.nodes() if n.alive]

    def schedulable_nodes(self) -> List[Node]:
        """Live nodes that accept new placements (draining ones left out);
        every live node when all of them are draining."""
        alive = self.alive_nodes()
        return [n for n in alive if not n.draining] or alive

    def get_node(self, node_id: NodeID) -> Optional[Node]:
        with self._nodes_lock:
            return self._nodes.get(node_id)

    def head_node(self) -> Node:
        nodes = self.alive_nodes()
        if not nodes:
            raise RuntimeError("cluster has no alive nodes")
        return nodes[0]

    def cluster_resources(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for n in self.alive_nodes():
            for k, v in n.ledger.total.items():
                out[k] = out.get(k, 0.0) + v
        return out

    def available_resources(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for n in self.alive_nodes():
            for k, v in n.ledger.available().items():
                out[k] = out.get(k, 0.0) + v
        return out

    # ------------------------------------------------------------------
    # graceful node drain (preemption / downscale / maintenance)
    # ------------------------------------------------------------------
    def drain_node(self, node, deadline_s: Optional[float] = None,
                   reason: str = "preemption") -> bool:
        """Gracefully drain a node: no new placements land on it, its
        queued tasks resubmit elsewhere, primary object replicas and actors
        migrate off it, and once its running work completes it leaves the
        cluster. If the deadline expires first, the drain escalates into
        the ordinary node-death path (lineage covers what did not migrate).

        ``node`` is a Node, NodeID or node-id hex string. Returns True if
        a drain was started (False: unknown, dead or already draining)."""
        if not isinstance(node, Node):
            node_id = (NodeID.from_hex(node) if isinstance(node, str)
                       else node)
            node = self.get_node(node_id)
            if node is None:
                return False
        if deadline_s is None:
            from ray_tpu_torch._private.config import cfg
            deadline_s = cfg().drain_deadline_s
        backend = self.cluster_backend
        if backend is not None and node.daemon is not None:
            # publish through the head: the DRAINING state (and its
            # deadline escalation) outlives this driver and a head restart
            try:
                backend.head.drain_node(node.node_id.hex(), deadline_s,
                                        reason)
            except Exception:
                pass        # head unreachable: drain locally anyway
        started = self.begin_node_drain(node, deadline_s, reason)
        # the head's own drain event may have won the race to start the
        # migration: that still counts as "draining now"
        return started or node.draining

    def begin_node_drain(self, node: Node, deadline_s: float,
                         reason: str) -> bool:
        """Idempotent driver-side entry (also fed by the head's ``drain``
        event): flips the node to DRAINING and starts the migration."""
        with self._nodes_lock:
            if (not node.alive or node.draining
                    or self._nodes.get(node.node_id) is not node):
                return False
            node.start_drain()
        self.stats["drains_total"] += 1
        threading.Thread(target=self._drain_node_worker,
                         args=(node, deadline_s, reason), daemon=True,
                         name=f"drain-{node.node_id.hex()[:8]}").start()
        return True

    def _drain_node_worker(self, node: Node, deadline_s: float,
                           reason: str) -> None:
        deadline = time.monotonic() + max(0.0, deadline_s)
        # flush coalesced frees first: the draining daemon should not
        # migrate (or hold) objects the driver already released
        for n in [node] + self.alive_nodes():
            if n.daemon is not None:
                try:
                    n.daemon.flush_frees()
                except Exception:
                    pass
        moved: List[ActorID] = []
        try:
            self._migrate_node_objects(node)
            moved += self._migrate_node_actors(node, reason,
                                               deadline=deadline)
        except Exception:
            pass    # the escalation still bounds the drain
        while time.monotonic() < deadline:
            if node.is_idle():
                # clean drain: sweep again (results stored and actors
                # created while draining live here too), then leave with
                # no reconstruction debt
                try:
                    moved += self._migrate_node_actors(node, reason,
                                                       deadline=deadline)
                    self._migrate_node_objects(node)
                except Exception:
                    pass
                self._await_restarts(moved, deadline)
                self._finish_drain(node, reason)
                return
            time.sleep(0.05)
        self._escalate_drain(node, reason)

    def _await_restarts(self, actor_ids: List[ActorID],
                        deadline: float) -> None:
        """Hold a clean drain's departure until the actors it moved have
        left RESTARTING (their new worker may take seconds to start on a
        loaded host), so the node leaves with its actors ALIVE elsewhere
        (ROADMAP C27; JAX's drain leaves at once). The drain's deadline
        bounds the wait; a restart still pending then finishes after the
        node is gone."""
        while time.monotonic() < deadline:
            infos = [self.gcs.get_actor_info(a) for a in actor_ids]
            if not any(i is not None and i.state == ActorState.RESTARTING
                       for i in infos):
                return
            time.sleep(0.05)

    def _migrate_node_objects(self, node: Node) -> int:
        """Copy sole-replica objects off the draining node so its
        departure loses nothing: daemon to daemon (a push, a pull as the
        fallback, then indexed on the target), or between in-process
        stores."""
        targets = [n for n in self.alive_nodes()
                   if n.node_id != node.node_id and not n.draining]
        if not targets:
            return 0
        moved = 0
        i = 0
        for oid in node.store.object_ids():
            with self._loc_lock:
                if self._locations.get(oid, set()) - {node.node_id}:
                    continue        # a replica already lives elsewhere
            target = targets[i % len(targets)]
            i += 1
            if _fp.ENABLED:
                try:
                    _fp.fire("drain.migrate_object", oid=oid.hex())
                except Exception:
                    continue    # this object stays; lineage covers it
            try:
                src, dst = node.daemon, target.daemon
                if src is not None and dst is not None:
                    # bytes move daemon to daemon, never through the
                    # driver: the chunked push first, a pull as fallback
                    key, nbytes, raw = node.store.meta_of(oid)
                    try:
                        ok = src.push_object(key, dst.addr,
                                             ref=oid.binary()).get("ok",
                                                                   False)
                    except Exception:
                        ok = False
                    if not ok and not dst.pull_object(
                            key, src.addr, 1, ref=oid.binary(), raw=raw):
                        continue
                    target.store.register_remote(oid, key, nbytes, raw=raw)
                else:
                    value = node.store.get(oid)
                    # the size cached at insert: a large pytree pays no
                    # fresh walk
                    target.store.put(oid, value,
                                     nbytes=node.store.nbytes_of(oid)
                                     or _nbytes_of(value))
            except Exception:
                continue        # this object stays; lineage covers it
            with self._loc_lock:
                self._locations.setdefault(oid, set()).add(target.node_id)
            moved += 1
        if moved:
            self.stats["drain_objects_migrated"] += moved
        return moved

    def _migrate_node_actors(self, node: Node, reason: str,
                             deadline: Optional[float] = None
                             ) -> List[ActorID]:
        """Restart the draining node's actors on surviving nodes through
        the restart machinery, gracefully: pending tasks replay on the new
        incarnation and the planned move does not consume max_restarts.
        Returns the ids of the actors it moved."""
        from ray_tpu_torch._private.task_spec import (
            NodeAffinitySchedulingStrategy)
        with node._actors_lock:
            actors = dict(node.actors)
        migrate: Dict[ActorID, ActorExecutor] = {}
        for actor_id, executor in actors.items():
            info = self.gcs.get_actor_info(actor_id)
            strat = getattr(getattr(info, "creation_spec", None),
                            "scheduling_strategy", None)
            if (isinstance(strat, NodeAffinitySchedulingStrategy)
                    and not strat.soft
                    and strat.node_id == node.node_id.hex()):
                # hard-pinned here: it cannot live anywhere else; it works
                # on until the node departs
                continue
            migrate[actor_id] = executor
        with node._actors_lock:
            for actor_id in migrate:
                node.actors.pop(actor_id, None)
        moved: List[ActorID] = []
        cause = f"node draining ({reason})"
        for actor_id, executor in migrate.items():
            pending = executor.kill(cause)
            # let an in-flight method finish before the actor's worker is
            # recycled: kill() stops dispatch, so the executor threads end
            # after the current call (bounded by the drain deadline)
            for t in executor._threads:
                budget = 1.0
                if deadline is not None:
                    budget = min(budget, max(0.0,
                                             deadline - time.monotonic()))
                t.join(timeout=budget)
            try:
                self._handle_actor_death(actor_id, cause,
                                         pending_tasks=pending,
                                         may_restart=True, graceful=True)
                moved.append(actor_id)
            except Exception:
                continue
        if moved:
            self.stats["drain_actors_migrated"] += len(moved)
        return moved

    def _finish_drain(self, node: Node, reason: str) -> None:
        """Clean completion: the node leaves through the normal removal
        flow, with its objects replicated and its actors elsewhere."""
        if self.get_node(node.node_id) is None:
            return      # a death event won the race
        backend = self.cluster_backend
        if backend is not None and node.daemon is not None:
            try:
                backend.head.mark_node_dead(node.node_id.hex(),
                                            f"drained ({reason})")
            except Exception:
                pass
            try:
                node.daemon.stop()
            except Exception:
                pass
        try:
            self.remove_node(node, _from_cluster=True)
        except Exception:
            pass

    def count_drain_escalation(self, node: Node) -> None:
        """Exactly-once escalation accounting: the driver's deadline timer
        and the head's death event race to escalate one drain; whichever
        wins counts, the loser is a no-op."""
        with self._nodes_lock:
            if getattr(node, "_drain_escalated", False):
                return
            node._drain_escalated = True
        self.stats["drain_escalations_total"] += 1

    def _escalate_drain(self, node: Node, reason: str) -> None:
        """The deadline expired with work still on the node: the ordinary
        node-death path (retries and lineage reconstruction recover what
        did not migrate in time)."""
        if self.get_node(node.node_id) is None:
            return      # drained cleanly, or the head escalated first
        self.count_drain_escalation(node)
        if _fp.ENABLED:
            try:
                # a delay arm stretches the escalation window; an error
                # arm must NOT suppress the escalation (the node would
                # linger draining for ever)
                _fp.fire("drain.deadline", node=node.node_id.hex())
            except Exception:
                pass
        try:
            self.remove_node(node)
        except Exception:
            pass

    def on_node_task_drained(self, spec: TaskSpec, node: Node) -> None:
        """A queued-but-unstarted task handed back by a draining node:
        reschedule it elsewhere without consuming a retry (a planned
        departure, not a failure)."""
        with self._tasks_lock:
            inflight = self._tasks.get(spec.task_id)
        if inflight is None:
            return
        with inflight.lock:
            if inflight.cancelled:
                return
        # one bounce only: if the scheduler sends it back (nothing else
        # fits), the draining node's dispatch pass runs it there
        spec._drain_bounced = True
        self._schedule(spec, inflight)

    # ------------------------------------------------------------------
    # objects
    # ------------------------------------------------------------------
    def put(self, value: Any) -> ObjectRef:
        if isinstance(value, ObjectRef):
            raise TypeError("put() of an ObjectRef is not allowed "
                            "(pass the ref itself instead)")
        oid = ObjectID.from_random()
        ref = ObjectRef(oid, owner_hex=self.worker_id.hex(), task_name="put")
        self._store_value(oid, value)
        self.futures.complete(oid)
        return ref

    def put_stored(self, oid_bin: bytes, key: bytes, nbytes: int,
                   raw, node_hex: str) -> ObjectRef:
        """Owner-side registration of a daemon worker's DIRECT put: the
        payload is already written and sealed in ``node``'s arena under
        ``key``; record ownership, location and the raw tier's
        dtype/shape. No value reaches the driver."""
        oid = ObjectID(bytes(oid_bin))
        node = self.get_node(NodeID.from_hex(node_hex))
        store = getattr(node, "store", None) if node is not None else None
        register = getattr(store, "register_remote", None)
        if node is None or not node.alive or register is None:
            # an unknown, dead or in-process node: the worker falls back
            # to the classic put (its arena entry is aborted)
            raise RuntimeError(f"no daemon store on node {node_hex!r}")
        register(oid, bytes(key), int(nbytes),
                 raw=tuple(raw) if raw else None)
        if self.tenancy.enabled:
            from ray_tpu_torch.tenancy import current_job_id
            jid = current_job_id(self)
            self.tenancy.note_put(
                oid.hex(), jid.hex() if jid is not None else "",
                int(nbytes))
        with self._loc_lock:
            self._locations.setdefault(oid, set()).add(node.node_id)
        ref = ObjectRef(oid, owner_hex=self.worker_id.hex(),
                        task_name="put")
        self.futures.complete(oid)
        return ref

    def locate_object(self, key: bytes) -> List[List[Any]]:
        """The owner's object directory: the addresses of the live daemons
        that hold a copy under the store key ``key``."""
        addrs = []
        for node in self.nodes():
            handle = getattr(node, "daemon", None)
            has = getattr(node.store, "has_daemon_key", None)
            if (handle is not None and not handle.dead
                    and has is not None and has(key)):
                addrs.append(list(handle.addr))
        return addrs

    def _store_value(self, oid: ObjectID, value: Any,
                     prefer_node: Optional[Node] = None) -> None:
        nested = _find_nested_refs(value)
        if nested:
            self.refcounter.add_nested_refs(oid, [r.id for r in nested])
        size = _nbytes_of(value)
        if self.tenancy.enabled:
            from ray_tpu_torch.tenancy import current_job_id
            jid = current_job_id(self)
            self.tenancy.note_put(
                oid.hex(), jid.hex() if jid is not None else "", size)
        if size <= INLINE_OBJECT_SIZE or prefer_node is None:
            self.memory_store.put(oid, value, nbytes=size)
            return
        prefer_node.store.put(oid, value, nbytes=size)
        with self._loc_lock:
            self._locations.setdefault(oid, set()).add(prefer_node.node_id)
            # a fresh copy is not lost: a node removal that marked the old
            # copy lost after a get had already started rebuilding it must
            # not send the next get into a second reconstruction
            self._lost.discard(oid)

    def _free_object(self, oid: ObjectID) -> None:
        """Refcount hit zero: drop the value everywhere + its lineage."""
        if self.tenancy.enabled:
            self.tenancy.note_free(oid.hex())
        self.memory_store.delete(oid)
        with self._loc_lock:
            locs = self._locations.pop(oid, set())
        for node_id in locs:
            node = self.get_node(node_id)
            if node is not None:
                node.store.delete(oid)
        self.lineage.release(oid)

    def _fetch_value(self, oid: ObjectID) -> Tuple[bool, Any]:
        """Return (found, value) looking across memory store + node stores."""
        if self.memory_store.contains(oid):
            return True, self.memory_store.get(oid)
        with self._loc_lock:
            locs = list(self._locations.get(oid, ()))
        for node_id in locs:
            node = self.get_node(node_id)
            if node is not None and node.alive and node.store.contains(oid):
                return True, node.store.get(oid)
        return False, None

    def get(self, refs: Sequence[ObjectRef],
            timeout: Optional[float] = None) -> List[Any]:
        deadline = None if timeout is None else time.monotonic() + timeout
        out: List[Any] = []
        for ref in refs:
            self._ensure_available(ref.id)
            remaining = None
            if deadline is not None:
                remaining = max(deadline - time.monotonic(), 0.0)
            if not self.futures.wait_for(ref.id, remaining):
                raise exc.GetTimeoutError(
                    f"get() timed out waiting for {ref}")
            value = self._get_one(ref, deadline)
            if isinstance(value, exc.TaskError):
                raise value.as_instanceof_cause()
            if isinstance(value, exc.RayTpuError):
                raise value
            out.append(value)
        return out

    def _get_one(self, ref: ObjectRef, deadline: Optional[float],
                 _depth: int = 0) -> Any:
        self._ensure_available(ref.id)
        found, value = self._fetch_value(ref.id)
        if found:
            return value
        # The value is gone: recompute it from its lineage.
        if _depth > 100:
            raise exc.ObjectReconstructionFailedError(
                ref.id, "reconstruction recursion limit hit")
        self._recover_object(ref)
        remaining = None
        if deadline is not None:
            remaining = max(deadline - time.monotonic(), 0.0)
        if not self.futures.wait_for(ref.id, remaining):
            raise exc.GetTimeoutError(
                f"get() timed out waiting for reconstruction of {ref}")
        return self._get_one(ref, deadline, _depth + 1)

    def _recover_object(self, ref: ObjectRef) -> None:
        """Resubmit the producing task of a lost object (lineage recovery)."""
        spec = self.lineage.producer_of(ref.id)
        if spec is None:
            err = exc.ObjectLostError(
                ref.id, f"object {ref.id.hex()[:12]} was lost and has no "
                        f"lineage to reconstruct it (e.g. created by put())")
            self._store_value(ref.id, err)
            self.futures.complete(ref.id)
            return
        with self._tasks_lock:
            inflight = self._tasks.get(spec.task_id)
            if inflight is not None and inflight.state in (
                    TaskState.PENDING_DEPS, TaskState.QUEUED,
                    TaskState.RUNNING):
                return  # already being recomputed
        self.stats["objects_reconstructed"] += 1
        respec = _clone_spec_for_retry(spec)
        for oid in respec.return_ids:
            self.futures.reset(oid)
        self.submit_task(respec, record_lineage=False)

    def wait(self, refs: Sequence[ObjectRef], num_returns: int = 1,
             timeout: Optional[float] = None,
             fetch_local: bool = True) -> Tuple[List[ObjectRef],
                                                List[ObjectRef]]:
        if num_returns > len(refs):
            raise ValueError("num_returns exceeds the number of refs")
        for r in refs:
            self._ensure_available(r.id)
        ids = [r.id for r in refs]
        # cap at num_returns even if more completed (API contract)
        done_list = self.futures.wait_any(ids, num_returns, timeout)
        done_ids = set(done_list[:num_returns])
        ready = [r for r in refs if r.id in done_ids]
        not_ready = [r for r in refs if r.id not in done_ids]
        return ready, not_ready

    # ------------------------------------------------------------------
    # task submission
    # ------------------------------------------------------------------
    def submit_task(self, spec: TaskSpec,
                    record_lineage: bool = True) -> List[ObjectRef]:
        if self.tenancy.enabled:
            # the fair-share verdict; REJECTED raises AdmissionRejectedError
            # here, before any future or lineage state exists
            self.tenancy.admit(spec)
        self.stats["tasks_submitted"] += 1
        trace_events.stamp_trace(spec)
        refs = [ObjectRef(oid, owner_hex=self.worker_id.hex(),
                          task_name=spec.name) for oid in spec.return_ids]
        for oid in spec.return_ids:
            self.futures.register(oid)
        deps = spec.dependencies()
        if deps:
            self.refcounter.add_submitted_task_refs(deps)
        if record_lineage and spec.max_retries != 0:
            self.lineage.record(spec.return_ids, spec)
        if spec.num_returns in ("streaming", "dynamic"):
            # Pre-create the generator state so the configured backpressure
            # applies even if the consumer races the producer to it.
            self._generators.setdefault(
                spec.task_id, GeneratorState(spec.backpressure_num_objects))

        inflight = _InFlightTask(spec)
        with self._tasks_lock:
            self._tasks[spec.task_id] = inflight

        if spec.kind == TaskKind.ACTOR_TASK:
            self._submit_actor_task(spec, inflight, deps)
        else:
            self._submit_with_deps(spec, inflight, deps)
        return refs

    def _submit_with_deps(self, spec: TaskSpec, inflight: _InFlightTask,
                          deps: List[ObjectID]) -> None:
        for d in deps:
            self._ensure_available(d)
        pending = [d for d in deps if not self.futures.is_done(d)]
        inflight.deps_remaining = len(pending)
        if not pending:
            self._schedule(spec, inflight)
            return
        counter_lock = threading.Lock()

        def on_dep_done(_oid):
            with counter_lock:
                inflight.deps_remaining -= 1
                ready = inflight.deps_remaining == 0
            if ready:
                self._schedule(spec, inflight)

        for d in pending:
            self.futures.add_done_callback(d, on_dep_done)

    def _schedule(self, spec: TaskSpec, inflight: _InFlightTask) -> None:
        with inflight.lock:
            if inflight.cancelled:
                return
            inflight.state = TaskState.QUEUED
        if isinstance(spec.scheduling_strategy,
                      PlacementGroupSchedulingStrategy):
            self._schedule_into_pg(spec, inflight)
            return
        try:
            node = self.scheduler.pick_node(spec, self.nodes(),
                                            preferred=self._locality_node(spec))
        except SchedulingError as e:
            self._fail_unschedulable(spec, exc.TaskError(e, spec.name))
            return
        inflight.node_id = node.node_id
        self._record_submit_phase(spec, node)
        node.enqueue(spec)

    def _record_submit_phase(self, spec: TaskSpec, node: Node) -> None:
        """The submit phase: submit_task's entry to the node's backlog
        (dependency waits and the scheduler's placement)."""
        if spec.trace_sampled and spec.submit_mono:
            now = time.perf_counter()
            trace_events.record_phase_rt(
                spec, "submit", now - spec.submit_mono,
                node.node_id.hex(), start_wall=spec.submit_wall,
                end_mono=now)

    def _schedule_into_pg(self, spec: TaskSpec,
                          inflight: _InFlightTask) -> None:
        """Rewrite the demand onto bundle-scoped resources and enqueue on
        the bundle's node."""
        strat = spec.scheduling_strategy
        pg = strat.placement_group
        # the strategy may carry a copy of the group (a handle that went
        # through the object store): bind the live one by id
        live = self.pg_manager.get(pg.id)
        if live is not None and live is not pg:
            strat.placement_group = pg = live
        if not pg._ready_event.is_set():
            # queue behind placement: the manager sets the event once the
            # group is placed or removed. (JAX's test is `not is_ready()`,
            # which a removed group also meets: its task re-queues on a new
            # thread for ever and never fails.)
            def wait_then_schedule():
                pg._ready_event.wait()
                self._schedule_into_pg(spec, inflight)
            threading.Thread(target=wait_then_schedule, daemon=True,
                             name="pg-wait").start()
            return
        if pg.state != "CREATED":
            self._fail_unschedulable(spec, exc.TaskError(
                exc.PlacementGroupUnschedulableError(
                    f"placement group is {pg.state}"), spec.name))
            return
        idx = strat.placement_group_bundle_index
        if idx != -1 and not (0 <= idx < len(pg.bundles)):
            self._fail_unschedulable(spec, exc.TaskError(
                ValueError(
                    f"placement_group_bundle_index={idx} out of range for "
                    f"{len(pg.bundles)} bundles"), spec.name))
            return
        # a retry's resources are already bundle-scoped: match bundles
        # against the original demand
        if spec.pg_demand is None:
            spec.pg_demand = dict(spec.resources)
        demand = spec.pg_demand
        candidates = pg.bundles if idx == -1 else [pg.bundles[idx]]
        if idx == -1 and len(candidates) > 1:
            # a bundle on a draining node is the last resort (the group
            # re-places when the node leaves)
            def _bundle_draining(b) -> int:
                n = self.get_node(b.node_id) if b.node_id else None
                return 1 if getattr(n, "draining", False) else 0
            candidates = sorted(candidates, key=_bundle_draining)
        chosen = None
        for bundle in candidates:
            if not all(bundle.resources.get(k, 0.0) >= v - 1e-9
                       for k, v in demand.items()):
                continue
            node = self.get_node(bundle.node_id)
            if node is None or not node.alive:
                continue
            scoped = {scoped_resource(pg.id, bundle.index, k): v
                      for k, v in demand.items()}
            avail = node.ledger.available()
            fits_now = all(avail.get(k, 0.0) >= v - 1e-9
                           for k, v in scoped.items())
            if chosen is None or fits_now:
                chosen = (bundle, node, scoped)
                if fits_now:
                    break
        if chosen is None:
            self._fail_unschedulable(spec, exc.TaskError(
                SchedulingError(
                    f"demand {demand} does not fit any bundle of "
                    f"the placement group"), spec.name))
            return
        _, node, scoped = chosen
        spec.resources = scoped
        spec.placement_group_id = pg.id
        spec.pg_capture = bool(strat.placement_group_capture_child_tasks)
        inflight.node_id = node.node_id
        self._record_submit_phase(spec, node)
        node.enqueue(spec)

    def _fail_unschedulable(self, spec: TaskSpec,
                            error: exc.TaskError) -> None:
        """An infeasible placement fails the actor too, not just its
        creation task (else it would stay pending with its calls
        buffering)."""
        if spec.kind == TaskKind.ACTOR_CREATION:
            self._actor_creation_failed(spec, error)
        else:
            self._fail_task(spec, error)

    def _locality_node(self, spec: TaskSpec) -> Optional[Node]:
        """Prefer the node holding the largest dependency (locality-aware)."""
        with self._nodes_lock:
            nodes = dict(self._nodes)
        deps = spec.dependencies()
        with self._loc_lock:
            dep_locs = [(dep, list(self._locations.get(dep, ())))
                        for dep in deps]
        best, best_size = None, 0
        for dep, node_ids in dep_locs:
            for node_id in node_ids:
                node = nodes.get(node_id)
                if node is None or not node.alive:
                    continue
                size = node.store.nbytes_of(dep)
                if size > best_size:
                    best, best_size = node, size
        return best

    # ------------------------------------------------------------------
    # task execution (runs on node worker threads)
    # ------------------------------------------------------------------
    def _execute_on_node(self, spec: TaskSpec, node: Node) -> None:
        with self._tasks_lock:
            inflight = self._tasks.get(spec.task_id)
        if inflight is not None:
            with inflight.lock:
                if inflight.cancelled:
                    return
                inflight.state = TaskState.RUNNING
        if spec.kind == TaskKind.ACTOR_CREATION:
            self._execute_actor_creation(spec, node)
            return
        self.task_events.record(
            task_id=spec.task_id.hex(), name=spec.name, event="RUNNING",
            node_id=node.node_id.hex())
        from ray_tpu_torch.util import tracing
        with tracing.span(f"task::{spec.name}",
                          task_id=spec.task_id.hex()[:16]):
            self._execute_on_node_traced(spec, node)

    def _execute_on_node_traced(self, spec: TaskSpec, node: Node) -> None:
        try:
            args, kwargs = self._resolve_args(spec)
        except exc.TaskError as te:
            self._finish_task(spec, node, error=te)
            return
        if self._try_process_execute(spec, node, args, kwargs):
            return
        self._execute_inline(spec, node, args, kwargs)

    def _execute_on_remote_node(self, spec: TaskSpec, node: Node) -> None:
        """Task execution on a node-daemon process (the wire's fused lease
        and push). Work that must stay in the driver (a GPU demand, an
        ``_in_process`` task, a payload naming the card or one the wire
        cannot pickle) runs here on the node's dispatch thread, its
        resources accounted on this node."""
        from ray_tpu_torch._private.cluster import (DaemonCrashed,
                                                    RemoteWorkerCrashed)
        from ray_tpu_torch._private.fast_lane import join_parts
        if spec.kind == TaskKind.ACTOR_CREATION:
            self._execute_actor_creation(spec, node)
            return
        with self._tasks_lock:
            inflight = self._tasks.get(spec.task_id)
        if inflight is not None:
            with inflight.lock:
                if inflight.cancelled:
                    return
                inflight.state = TaskState.RUNNING
        # the same RUNNING transition the in-process path records: the
        # timeline pairs it with FINISHED/FAILED
        self.task_events.record(
            task_id=spec.task_id.hex(), name=spec.name, event="RUNNING",
            node_id=node.node_id.hex())
        try:
            args, kwargs = self._resolve_args(spec)
        except exc.TaskError as te:
            self._finish_task(spec, node, error=te)
            return
        payload = self.process_router.eligible_task(spec, args, kwargs)
        if payload is None:
            self._execute_inline(spec, node, args, kwargs)
            return
        fid, args_parts = payload
        try:
            kind, value = node.daemon.execute_task(
                spec, fid, bytes(join_parts(args_parts)))
        except RemoteWorkerCrashed as crash:
            # one worker died; the daemon (the node) is fine: plain retry
            self._on_process_task_crash(spec, node, crash)
            return
        except DaemonCrashed as crash:
            self._on_daemon_crash(node)
            self._on_process_task_crash(spec, node, crash)
            return
        self._finish_remote_outcome(spec, node, kind, value)

    def _finish_remote_outcome(self, spec: TaskSpec, node: Node,
                               kind: str, value) -> None:
        if kind == "err":
            with self._tasks_lock:
                inflight = self._tasks.get(spec.task_id)
            if (inflight is not None and inflight.cancelled
                    and isinstance(value, KeyboardInterrupt)):
                self._release_task_resources(spec, node)
                self._fail_task(spec, exc.TaskError(
                    exc.TaskCancelledError(spec.task_id), spec.name))
                return
            self._finish_task(spec, node, error=exc.TaskError(
                value, spec.name))
            return
        if kind == "gen" or spec.num_returns in ("streaming", "dynamic"):
            self._drain_generator(spec, node, value)
            return
        if kind == "stored":
            daemon_key, nbytes = value
            n = spec.num_returns
            if n == 1 or not isinstance(n, int):
                if not node.alive:
                    self.on_node_task_lost(spec, node)
                    return
                t_result = time.perf_counter() if spec.trace_sampled else 0.0
                oid = spec.return_ids[0]
                node.store.register_remote(oid, daemon_key, nbytes)
                with self._loc_lock:
                    self._locations.setdefault(oid, set()).add(
                        node.node_id)
                    self._lost.discard(oid)     # a fresh copy
                self.task_events.record(task_id=spec.task_id.hex(),
                                        name=spec.name, event="FINISHED")
                self._release_task_resources(spec, node)
                self.futures.complete(oid)
                if t_result:
                    now = time.perf_counter()
                    trace_events.record_phase_rt(
                        spec, "result", now - t_result, node.node_id.hex(),
                        start_wall=trace_events.wall_at(t_result),
                        end_mono=now)
                self._on_task_done(spec, TaskState.FINISHED)
                return
            # a multi-return tuple stored in the daemon: fetch once, split,
            # and free the tuple's blob once each return is stored on its
            # own (kept, the node would hold every large return twice)
            from ray_tpu_torch._private.cluster import _load_blob
            value = _load_blob(node.daemon.get_object_blob(daemon_key))
            self._finish_task(spec, node, result=value)
            node.daemon.queue_free(daemon_key)
            return
        self._finish_task(spec, node, result=value)

    def _on_daemon_crash(self, node: Node) -> None:
        """A daemon's RPC failure seen first-hand: report it to the head and
        run the node-death flow (objects lost, actors restart)."""
        backend = self.cluster_backend
        handle = getattr(node, "daemon", None)
        if backend is None or handle is None:
            return
        backend.report_daemon_dead(handle, "rpc failure")
        if self.get_node(node.node_id) is not None:
            try:
                self.remove_node(node, _from_cluster=True)
            except Exception:
                pass

    def _try_process_execute(self, spec: TaskSpec, node: Node,
                             args: tuple, kwargs: dict) -> bool:
        """Route an eligible normal task to a worker process. Returns False
        if the task must run in this process (accelerator-plane work, or a
        payload the wire cannot pickle)."""
        from ray_tpu_torch._private.worker_process import WorkerCrashed
        router = self.process_router
        payload = router.eligible_task(spec, args, kwargs)
        if payload is None:
            return False
        try:
            kind, value = router.execute_task(spec, node, payload)
        except WorkerCrashed as crash:
            self._on_process_task_crash(spec, node, crash)
            return True
        if kind == "err":
            with self._tasks_lock:
                inflight = self._tasks.get(spec.task_id)
            if (inflight is not None and inflight.cancelled
                    and isinstance(value, KeyboardInterrupt)):
                # a non-force cancel's injected KeyboardInterrupt is the
                # cancellation surfacing, not an application error
                self._release_task_resources(spec, node)
                self._fail_task(spec, exc.TaskError(
                    exc.TaskCancelledError(spec.task_id), spec.name))
                return True
            self._finish_task(spec, node,
                              error=exc.TaskError(value, spec.name))
        elif spec.num_returns in ("streaming", "dynamic") or kind == "gen":
            self._drain_generator(spec, node, value)
        else:
            self._finish_task(spec, node, result=value)
        return True

    def _on_process_task_crash(self, spec: TaskSpec, node: Node,
                               crash: Exception) -> None:
        """A worker process died under a task: a cancelled task fails as
        cancelled; otherwise a system failure, retried up to
        max_retries."""
        with self._tasks_lock:
            inflight = self._tasks.get(spec.task_id)
        cancelled = inflight is not None and inflight.cancelled
        self._release_task_resources(spec, node)
        if cancelled:
            self._fail_task(spec, exc.TaskError(
                exc.TaskCancelledError(spec.task_id), spec.name))
            return
        oom = self.memory_monitor.was_oom_killed(spec.task_id)
        fast_lane = bool(getattr(crash, "fast_lane", False))
        if not oom and fast_lane:
            # lane workers' task ids live in the native core: attribute by
            # claiming one recent unattributed kill, for lane crashes only
            oom = self.memory_monitor.consume_unattributed_kill()
        daemon = getattr(node, "daemon", None)
        if not oom and daemon is not None and not daemon.dead:
            # a daemon's workers are policed by that node's monitor: ask
            # whether this crash was its OOM kill
            try:
                oom = daemon.client.call(
                    "oom_check", task_id=spec.task_id.hex(),
                    fast_lane=fast_lane, timeout=5.0)["oom"]
            except Exception:
                pass
        if _retries_left(spec):
            self.task_events.record(task_id=spec.task_id.hex(),
                                    name=spec.name,
                                    event="RETRY_OOM" if oom else "RETRY")
            self._retry(spec)
            return
        if oom:
            self._fail_task(spec, exc.TaskError(
                exc.OutOfMemoryError(
                    f"task {spec.name} was killed by the memory monitor "
                    f"({self.memory_monitor.kills} kills; limit "
                    f"{self.memory_monitor.limit >> 20} MiB) and "
                    f"exhausted its retries"), spec.name))
            return
        self._fail_task(spec, exc.TaskError(
            exc.WorkerCrashedError(str(crash)), spec.name))

    def _execute_inline(self, spec: TaskSpec, node: Node, args: tuple,
                        kwargs: dict) -> None:
        """In-process execution on the node's pooled thread."""
        token = runtime_context._set_context(
            job_id=spec.job_id or self.job_id, task_id=spec.task_id,
            node_id=node.node_id, actor_id=None, resources=spec.resources,
            task_name=spec.name, placement_group_id=spec.placement_group_id,
            pg_capture=spec.pg_capture)
        t_exec0 = time.perf_counter() if spec.trace_sampled else 0.0
        from ray_tpu_torch.runtime_env import apply_runtime_env
        from ray_tpu_torch.util.rpdb import post_mortem_on_error
        try:
            with apply_runtime_env(spec.runtime_env), \
                    post_mortem_on_error():
                result = spec.func(*args, **kwargs)
        except BaseException as e:  # noqa: BLE001
            self._finish_task(spec, node,
                              error=exc.TaskError(e, spec.name))
            return
        finally:
            runtime_context._reset_context(token)
            if t_exec0:
                # the exec phase in the driver's lane: work on the card
                # runs in this process, not in a worker
                now = time.perf_counter()
                trace_events.record_phase_rt(
                    spec, "exec", now - t_exec0, node.node_id.hex(),
                    start_wall=trace_events.wall_at(t_exec0),
                    end_mono=now)
        if spec.num_returns in ("streaming", "dynamic") or inspect.isgenerator(
                result):
            self._drain_generator(spec, node, result)
            return
        self._finish_task(spec, node, result=result)

    def _resolve_args(self, spec: TaskSpec) -> Tuple[tuple, dict]:
        def resolve(a):
            if isinstance(a, ObjectRef):
                value = self._get_one(a, deadline=None)
                if isinstance(value, exc.TaskError):
                    raise value
                if isinstance(value, exc.RayTpuError):
                    raise exc.TaskError(value, spec.name)
                return value
            return a

        try:
            args = tuple(resolve(a) for a in spec.args)
            kwargs = {k: resolve(v) for k, v in spec.kwargs.items()}
        except exc.TaskError:
            raise
        except exc.RayTpuError as e:
            raise exc.TaskError(e, spec.name)
        return args, kwargs

    def _finish_task(self, spec: TaskSpec, node: Optional[Node],
                     result: Any = None,
                     error: Optional[exc.TaskError] = None) -> None:
        if node is not None and not node.alive:
            # the node was shut down under the running thread: its results
            # are lost with it
            self.on_node_task_lost(spec, node)
            return
        if error is not None:
            self.task_events.record(task_id=spec.task_id.hex(),
                                    name=spec.name, event="FAILED")
            if self._maybe_retry_app_error(spec, error):
                return
            self._fail_task(spec, error)
            return
        t_result = time.perf_counter() if spec.trace_sampled else 0.0
        self.task_events.record(task_id=spec.task_id.hex(),
                                name=spec.name, event="FINISHED")
        # Release the task's resources before completing the futures: a
        # caller unblocked by get() must observe the node's ledger already
        # freed (the node's dispatch `finally` skips the release via the
        # spec flag).
        self._release_task_resources(spec, node)
        values: List[Any]
        n = spec.num_returns
        if n == 1 or not isinstance(n, int):
            values = [result]
        elif n == 0:
            values = []
        else:
            if not isinstance(result, (tuple, list)) or len(result) != n:
                self._fail_task(spec, exc.TaskError(
                    ValueError(f"task declared num_returns={n} but returned "
                               f"{type(result).__name__}"), spec.name))
                return
            values = list(result)
        for oid, value in zip(spec.return_ids, values):
            self._store_value(oid, value, prefer_node=node)
            self.futures.complete(oid)
        if t_result:
            # the result phase: outcome in hand -> return futures completed
            now = time.perf_counter()
            trace_events.record_phase_rt(
                spec, "result", now - t_result,
                node.node_id.hex() if node is not None else "",
                start_wall=trace_events.wall_at(t_result), end_mono=now)
        self._on_task_done(spec, TaskState.FINISHED)

    def _fail_task(self, spec: TaskSpec, error: exc.TaskError) -> None:
        for oid in spec.return_ids:
            self._store_value(oid, error)
            self.futures.complete(oid)
        gen = self._generators.get(spec.task_id)
        if gen is not None:
            gen.finish(error.as_instanceof_cause())
        self._on_task_done(spec, TaskState.FAILED)

    def _on_task_done(self, spec: TaskSpec, state: str) -> None:
        self.stats["tasks_finished"] += 1
        # per-task borrow release: refs created on this task's behalf by a
        # lane worker (nested put/submit) un-pin now; results are already
        # stored, so containment keeps anything the task returned alive
        self.process_router.release_borrows("t:" + spec.task_id.hex())
        # the same per-task release for the daemons' workers, whose holds
        # the owner service keeps
        svc = getattr(self.cluster_backend, "owner_service", None)
        if svc is not None:
            svc.holder.release("t:" + spec.task_id.hex())
        from ray_tpu_torch._private.export_events import emit_export
        emit_export("TASK", task_id=spec.task_id.hex(), name=spec.name,
                    state=state, kind=str(spec.kind),
                    job_id=self.job_id.hex())
        deps = spec.dependencies()
        if deps:
            self.refcounter.remove_submitted_task_refs(deps)
        with self._tasks_lock:
            inflight = self._tasks.get(spec.task_id)
            if inflight is not None:
                inflight.state = state
                # drop terminal entries so the in-flight table doesn't
                # leak specs and their arg pins
                del self._tasks[spec.task_id]

    def _maybe_retry_app_error(self, spec: TaskSpec,
                               error: exc.TaskError) -> bool:
        retry_on = spec.retry_exceptions
        if retry_on is False or not _retries_left(spec):
            return False
        if retry_on is not True:
            try:
                if not isinstance(error.cause, tuple(retry_on)):
                    return False
            except TypeError:
                return False
        self._retry(spec)
        return True

    def on_node_task_lost(self, spec: TaskSpec, node: Node) -> None:
        """A node went away holding this queued/running task."""
        if spec.kind == TaskKind.ACTOR_CREATION:
            # the actor's creation: restart semantics, not task retries
            err = exc.NodeDiedError(
                f"actor creation lost to death of node "
                f"{node.node_id.hex()[:8]}")
            if self._shutdown:
                self._actor_creation_failed(spec, exc.TaskError(
                    err, spec.name))
            else:
                self._retry_or_fail_creation(spec, node, err)
            return
        if _retries_left(spec) and not self._shutdown:
            self._retry(spec)
        else:
            self._fail_task(spec, exc.TaskError(
                exc.NodeDiedError(
                    f"task {spec.name} lost to death of node "
                    f"{node.node_id.hex()[:8]} and retries exhausted"),
                spec.name))

    def _retry(self, spec: TaskSpec) -> None:
        """Resubmit the task under its own task id, one attempt later,
        after ``TASK_RETRY``'s backoff. The wait is deferred on the shared
        timer, never a blocking sleep: a node's death fans retries for a
        whole backlog out on one thread."""
        if self._shutdown:
            return
        self.stats["tasks_retried"] += 1
        from ray_tpu_torch._private.retry import (TASK_RETRY, defer,
                                                  record_retry)
        if _fp.ENABLED:
            # ANY injected error turns the would-be retry into a terminal
            # failure (an escape here would leave the task neither
            # retried nor failed); a delay arm stretches the retry storm
            try:
                _fp.fire("worker.retry", task=spec.task_id.hex(),
                         attempt=spec.attempt_number)
            except Exception as e:  # noqa: BLE001 — routed to the task
                self._fail_task(spec, exc.TaskError(e, spec.name))
                return
        backoff = TASK_RETRY.backoff_s(spec.attempt_number)
        record_retry("worker.task_retry", backoff)
        if backoff >= 0.01:
            def fire_retry(spec=spec):
                # a resubmit that raises fails the task: the timer's own
                # backstop would drop it and leave its futures hanging
                try:
                    self._resubmit_retry(spec)
                except Exception as e:  # noqa: BLE001 — routed to task
                    try:
                        self._fail_task(spec, exc.TaskError(e, spec.name))
                    except Exception:
                        pass

            defer(backoff, fire_retry)
            return
        self._resubmit_retry(spec)

    def _resubmit_retry(self, spec: TaskSpec) -> None:
        if self._shutdown:
            return
        respec = _clone_spec_for_retry(spec)
        # one critical section for check + replace: a gap between the pop
        # and the reinsert would hide the task from a concurrent cancel()
        with self._tasks_lock:
            old = self._tasks.get(spec.task_id)
            if old is None:
                # terminal state reached meanwhile (a force cancel already
                # failed it): do not re-run a cancelled or failed body
                return
            if not old.cancelled:
                inflight = _InFlightTask(respec)
                self._tasks[respec.task_id] = inflight
        if old.cancelled:
            self._fail_task(spec, exc.TaskError(
                exc.TaskCancelledError(spec.task_id), spec.name))
            return
        deps = respec.dependencies()
        if respec.kind == TaskKind.ACTOR_TASK:
            # replay on the actor, not the task path
            self._submit_actor_task(respec, inflight, deps)
        else:
            self._submit_with_deps(respec, inflight, deps)

    def _release_task_resources(self, spec: TaskSpec,
                                node: Optional[Node]) -> None:
        """Idempotent early release (on the worker thread, strictly before
        the exec pool's own `finally` release)."""
        if (node is not None and spec.kind != TaskKind.ACTOR_CREATION
                and not getattr(spec, "_resources_released", False)):
            spec._resources_released = True
            node.stage_release(spec.resources)

    # -- streaming generators ----------------------------------------------
    def _drain_generator(self, spec: TaskSpec, node: Node, gen) -> None:
        state = self._generators.setdefault(
            spec.task_id, GeneratorState(spec.backpressure_num_objects))
        # On a retry, skip items already reported by the previous attempt
        # (streams are assumed deterministic, as in lineage reconstruction).
        skip = len(state.items)
        try:
            for item in gen:
                if _fp.ENABLED:
                    # a per-item seam: an error arm kills the stream
                    # midway (the consumer sees a typed error); a delay
                    # arm throttles it
                    _fp.fire("worker.generator_stream",
                             task=spec.task_id.hex())
                if skip > 0:
                    skip -= 1
                    continue
                oid = ObjectID.from_random()
                self._store_value(oid, item, prefer_node=node)
                self.futures.complete(oid)
                ref = ObjectRef(oid, owner_hex=self.worker_id.hex(),
                                task_name=spec.name)
                state.report_item(ref)
        except BaseException as e:  # noqa: BLE001
            from ray_tpu_torch._private.cluster import (DaemonCrashed,
                                                        RemoteWorkerCrashed)
            from ray_tpu_torch._private.worker_process import WorkerCrashed
            if isinstance(e, DaemonCrashed):
                self._on_daemon_crash(node)
            if isinstance(e, (WorkerCrashed, DaemonCrashed,
                              RemoteWorkerCrashed)):
                # a system failure mid-stream: retried like any worker
                # crash; the replay skips the items already reported
                self._on_process_task_crash(spec, node, e)
                return
            te = exc.TaskError(e, spec.name)
            state.finish(te.as_instanceof_cause())
            self._fail_task(spec, te)
            return
        state.finish()
        # The task's own return value is the generator handle sentinel.
        for oid in spec.return_ids:
            self._store_value(oid, _StreamingGeneratorSentinel(spec.task_id))
            self.futures.complete(oid)
        self._on_task_done(spec, TaskState.FINISHED)

    def generator_state(self, task_id: TaskID) -> GeneratorState:
        return self._generators.setdefault(task_id, GeneratorState())

    # ------------------------------------------------------------------
    # actors
    # ------------------------------------------------------------------
    def create_actor(self, spec: TaskSpec,
                     get_if_exists: bool = False) -> ActorID:
        actor_id = spec.actor_id
        info = ActorInfo(
            actor_id=actor_id, name=spec.actor_name,
            namespace=spec.namespace or self.namespace,
            max_restarts=spec.max_restarts,
            max_task_retries=spec.max_task_retries,
            detached=(spec.lifetime == "detached"),
            creation_spec=spec,
            class_name=getattr(spec.func, "__name__", "Actor"),
            method_options=dict(spec.method_options))
        if get_if_exists and spec.actor_name:
            actor_id, created = self.gcs.register_actor_or_get_existing(info)
            if not created:
                return actor_id
        else:
            self.gcs.register_actor(info)
        with self._actor_lock:
            self._actor_pending_tasks[actor_id] = []
        self.submit_task(spec, record_lineage=False)
        return actor_id

    def _execute_actor_creation(self, spec: TaskSpec, node: Node) -> None:
        """The actor's instance is built in a worker process when the
        router takes it, else in this process on the node's pooled thread;
        either way it holds its resources for its lifetime."""
        actor_id = spec.actor_id
        try:
            args, kwargs = self._resolve_args(spec)
        except exc.TaskError as te:
            self._actor_creation_failed(spec, te, node)
            return
        from ray_tpu_torch._private.worker_process import WorkerCrashed
        instance = None
        payload = self.process_router.eligible_actor(spec, args, kwargs)
        if payload is not None and node.daemon is not None:
            from ray_tpu_torch._private.cluster import (DaemonCrashed,
                                                        RemoteWorkerCrashed)
            from ray_tpu_torch._private.fast_lane import join_parts
            fid, args_parts = payload
            try:
                instance = node.daemon.create_actor(
                    spec, fid, bytes(join_parts(args_parts)))
                self._remote_actors[spec.actor_id] = node.daemon
            except RemoteWorkerCrashed as e:
                self._retry_or_fail_creation(spec, node, e)
                return
            except DaemonCrashed as e:
                self._on_daemon_crash(node)
                self._retry_or_fail_creation(spec, node, e)
                return
            except BaseException as e:  # noqa: BLE001
                self._actor_creation_failed(
                    spec, exc.TaskError(e, spec.name), node)
                return
        elif payload is not None:
            try:
                instance = self.process_router.create_actor(spec, node,
                                                            payload)
            except WorkerCrashed as e:
                self._retry_or_fail_creation(spec, node, e)
                return
            except BaseException as e:  # noqa: BLE001
                self._actor_creation_failed(
                    spec, exc.TaskError(e, spec.name), node)
                return
        if instance is None:
            token = runtime_context._set_context(
                job_id=spec.job_id or self.job_id, task_id=spec.task_id,
                node_id=node.node_id, actor_id=actor_id,
                resources=spec.resources, task_name=spec.name,
                placement_group_id=spec.placement_group_id,
                pg_capture=spec.pg_capture)
            from ray_tpu_torch.runtime_env import apply_runtime_env
            try:
                with apply_runtime_env(spec.runtime_env):
                    instance = spec.func(*args, **kwargs)
            except BaseException as e:  # noqa: BLE001
                self._actor_creation_failed(
                    spec, exc.TaskError(e, spec.name), node)
                return
            finally:
                runtime_context._reset_context(token)

        # The actor may have been killed while __init__ was running; do not
        # resurrect it (install nothing, free the lifetime resources).
        info = self.gcs.get_actor_info(actor_id)
        if info is not None and info.state == ActorState.DEAD:
            self.process_router.discard_actor(actor_id)
            remote = self._remote_actors.pop(actor_id, None)
            if remote is not None:
                remote.kill_actor(actor_id, expected=True)
            if node.alive:
                node.ledger.release(spec.resources)
            for oid in spec.return_ids:
                self._store_value(oid, exc.ActorDiedError(
                    actor_id, info.death_cause or "actor killed"))
                self.futures.complete(oid)
            self._on_task_done(spec, TaskState.FAILED)
            return

        is_async = _class_is_async(type(instance))
        executor = ActorExecutor(
            actor_id, spec.max_concurrency,
            run_task=lambda s, inst: self._execute_actor_task(s, inst, node),
            run_task_async=lambda s, inst: self._execute_actor_task_async(
                s, inst, node),
            concurrency_groups=spec.concurrency_groups)
        executor.start(instance, is_async)
        node.host_actor(executor)
        with self._actor_lock:
            self._actor_executors[actor_id] = executor
            pending = self._actor_pending_tasks.pop(actor_id, [])
        self.gcs.update_actor_state(actor_id, ActorState.ALIVE,
                                    node_id=node.node_id)
        # Creation-task return: the actor handle's readiness object.
        for oid in spec.return_ids:
            self._store_value(oid, actor_id)
            self.futures.complete(oid)
        self._on_task_done(spec, TaskState.FINISHED)
        for pspec in pending:
            executor.submit(pspec)

    def _retry_or_fail_creation(self, spec: TaskSpec, node: Node,
                                e: BaseException) -> None:
        """A worker process died during __init__: a system failure with
        restart semantics, as after creation."""
        actor_id = spec.actor_id
        info = self.gcs.get_actor_info(actor_id)
        if (info is None or not (info.max_restarts == -1
                                 or info.num_restarts < info.max_restarts)):
            self._actor_creation_failed(spec, exc.TaskError(e, spec.name),
                                        node)
            return
        if node.alive:
            node.ledger.release(spec.resources)
        info.num_restarts += 1
        self.stats["actor_restarts"] += 1
        self.gcs.update_actor_state(actor_id, ActorState.RESTARTING)
        respec = _clone_spec_for_retry(spec)
        respec.actor_id = actor_id
        with self._tasks_lock:
            inflight = _InFlightTask(respec)
            self._tasks[respec.task_id] = inflight
        self._submit_with_deps(respec, inflight, respec.dependencies())

    def _actor_creation_failed(self, spec: TaskSpec, error: exc.TaskError,
                               node: Optional[Node] = None) -> None:
        actor_id = spec.actor_id
        if node is not None and node.alive:
            node.ledger.release(spec.resources)
        self.gcs.update_actor_state(actor_id, ActorState.DEAD,
                                    death_cause=str(error.cause))
        with self._actor_lock:
            pending = self._actor_pending_tasks.pop(actor_id, [])
        self._fail_task(spec, error)
        died = exc.ActorError(
            exc.ActorDiedError(actor_id,
                               f"actor __init__ failed: {error.cause!r}"),
            spec.name, actor_id)
        for pspec in pending:
            self._fail_task(pspec, died)

    def _submit_actor_task(self, spec: TaskSpec, inflight: _InFlightTask,
                           deps: List[ObjectID]) -> None:
        actor_id = spec.actor_id
        info = self.gcs.get_actor_info(actor_id)
        if info is None:
            self._fail_task(spec, exc.TaskError(
                ValueError(f"unknown actor {actor_id}"), spec.name))
            return
        if info.state == ActorState.DEAD:
            self._fail_task(spec, exc.ActorError(
                exc.ActorDiedError(actor_id, info.death_cause or "actor died"),
                spec.name, actor_id))
            return

        pending = [d for d in deps if not self.futures.is_done(d)]
        if not pending:
            self._enqueue_actor_task_when_ready(spec)
            return
        inflight.deps_remaining = len(pending)
        counter_lock = threading.Lock()

        def on_dep_done(_oid):
            with counter_lock:
                inflight.deps_remaining -= 1
                ready = inflight.deps_remaining == 0
            if ready:
                self._enqueue_actor_task_when_ready(spec)

        for d in pending:
            self.futures.add_done_callback(d, on_dep_done)

    def _enqueue_actor_task_when_ready(self, spec: TaskSpec) -> None:
        actor_id = spec.actor_id
        with self._actor_lock:
            executor = self._actor_executors.get(actor_id)
            if executor is None:
                info = self.gcs.get_actor_info(actor_id)
                if info is None or info.state == ActorState.DEAD:
                    self._fail_task(spec, exc.ActorError(
                        exc.ActorDiedError(
                            actor_id,
                            (info.death_cause if info else None)
                            or "actor is dead"),
                        spec.name, actor_id))
                    return
                # PENDING or RESTARTING: buffer until alive.
                self._actor_pending_tasks.setdefault(actor_id, []).append(spec)
                return
        if not executor.submit(spec):
            # The executor died but _handle_actor_death has not unregistered
            # it yet: drop the stale executor and re-evaluate against GCS
            # state (buffered if pending/restarting, failed on death).
            with self._actor_lock:
                if self._actor_executors.get(actor_id) is executor:
                    self._actor_executors.pop(actor_id, None)
            self._enqueue_actor_task_when_ready(spec)

    def _execute_actor_task(self, spec: TaskSpec, instance: Any,
                            node: Node) -> None:
        with self._tasks_lock:
            inflight = self._tasks.get(spec.task_id)
        if inflight is not None:
            with inflight.lock:
                if inflight.cancelled:
                    return
                inflight.state = TaskState.RUNNING
        try:
            args, kwargs = self._resolve_args(spec)
        except exc.TaskError as te:
            self._finish_task(spec, node, error=te)
            return
        token = runtime_context._set_context(
            job_id=spec.job_id or self.job_id, task_id=spec.task_id,
            node_id=node.node_id, actor_id=spec.actor_id,
            resources=spec.resources, task_name=spec.name,
            placement_group_id=spec.placement_group_id,
            pg_capture=spec.pg_capture)
        from ray_tpu_torch._private.worker_process import (
            _ProcessActorInstance)
        from ray_tpu_torch._private.cluster import (DaemonCrashed,
                                                    RemoteActorInstance,
                                                    RemoteWorkerCrashed)
        try:
            if isinstance(instance, RemoteActorInstance):
                from ray_tpu_torch._private.fast_lane import join_parts
                from ray_tpu_torch._private.worker_process import _pack
                try:
                    args_blob = bytes(join_parts(_pack((args, kwargs),
                                                       host_only=True)))
                except Exception as e:  # noqa: BLE001
                    raise ValueError(
                        f"an argument cannot go to the actor's worker "
                        f"process ({e}): an actor that takes the card's "
                        f"values is created with num_gpus or "
                        f"_in_process=True") from None
                try:
                    kind, result = instance.call_actor_method(spec,
                                                              args_blob)
                except (DaemonCrashed, RemoteWorkerCrashed) as e:
                    raise exc.ActorDiedError(spec.actor_id, str(e))
                if kind == "err":
                    raise result
                if kind == "stored":
                    daemon_key, nbytes = result
                    oid = spec.return_ids[0]
                    node.store.register_remote(oid, daemon_key, nbytes)
                    with self._loc_lock:
                        self._locations.setdefault(oid, set()).add(
                            node.node_id)
                        self._lost.discard(oid)     # a fresh copy
                    self.task_events.record(task_id=spec.task_id.hex(),
                                            name=spec.name,
                                            event="FINISHED")
                    self._release_task_resources(spec, node)
                    self.futures.complete(oid)
                    self._on_task_done(spec, TaskState.FINISHED)
                    return
            elif isinstance(instance, _ProcessActorInstance):
                kind, result = self.process_router.call_actor_method(
                    instance, spec, node, args, kwargs)
                if kind == "err":
                    raise result
            else:
                method = getattr(instance, spec.method_name)
                result = method(*args, **kwargs)
        except _ExitActor:
            self._finish_task(spec, node, result=None)
            self.kill_actor(spec.actor_id, no_restart=True,
                            cause="exit_actor() called")
            return
        except BaseException as e:  # noqa: BLE001
            if (isinstance(e, exc.ActorDiedError) and node.draining
                    and self._resubmit_drained_actor_task(spec)):
                # the drain's worker recycle caught this call mid-flight:
                # a planned migration replays it on the new incarnation
                return
            self._finish_task(spec, node, error=exc.ActorError(
                e, spec.name, spec.actor_id))
            return
        finally:
            runtime_context._reset_context(token)
        if inspect.isgenerator(result) or spec.num_returns in (
                "streaming", "dynamic"):
            self._drain_generator(spec, node, result)
            return
        self._finish_task(spec, node, result=result)

    def _resubmit_drained_actor_task(self, spec: TaskSpec) -> bool:
        """Replay an actor task whose worker a graceful drain recycled,
        only while the actor can still restart (a DEAD actor keeps the
        normal failure)."""
        info = self.gcs.get_actor_info(spec.actor_id)
        if info is None or info.state == ActorState.DEAD:
            return False
        with self._tasks_lock:
            inflight = self._tasks.get(spec.task_id)
        if inflight is None:
            return False
        with inflight.lock:
            if inflight.cancelled:
                return False
        self._submit_actor_task(spec, inflight, spec.dependencies())
        return True

    async def _execute_actor_task_async(self, spec: TaskSpec, instance: Any,
                                        node: Node) -> None:
        with self._tasks_lock:
            inflight = self._tasks.get(spec.task_id)
        if inflight is not None:
            with inflight.lock:
                if inflight.cancelled:
                    return
                inflight.state = TaskState.RUNNING
        try:
            args, kwargs = self._resolve_args(spec)
        except exc.TaskError as te:
            self._finish_task(spec, node, error=te)
            return
        token = runtime_context._set_context(
            job_id=spec.job_id or self.job_id, task_id=spec.task_id,
            node_id=node.node_id, actor_id=spec.actor_id,
            resources=spec.resources, task_name=spec.name,
            placement_group_id=spec.placement_group_id,
            pg_capture=spec.pg_capture)
        try:
            method = getattr(instance, spec.method_name)
            result = method(*args, **kwargs)
            if inspect.iscoroutine(result):
                result = await result
        except _ExitActor:
            runtime_context._reset_context(token)
            self._finish_task(spec, node, result=None)
            self.kill_actor(spec.actor_id, no_restart=True,
                            cause="exit_actor() called")
            return
        except BaseException as e:  # noqa: BLE001
            runtime_context._reset_context(token)
            self._finish_task(spec, node, error=exc.ActorError(
                e, spec.name, spec.actor_id))
            return
        runtime_context._reset_context(token)
        self._finish_task(spec, node, result=result)

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True,
                   cause: str = "ray_tpu_torch.kill() called") -> None:
        # stop the executor first so no queued spec can still be dispatched
        with self._actor_lock:
            executor = self._actor_executors.pop(actor_id, None)
        pending = executor.kill(cause) if executor is not None else []
        self.process_router.discard_actor(actor_id)
        remote = self._remote_actors.pop(actor_id, None)
        if remote is not None and not remote.dead:
            remote.kill_actor(actor_id, expected=True)
        info = self.gcs.get_actor_info(actor_id)
        if info is not None and info.node_id is not None:
            node = self.get_node(info.node_id)
            if node is not None:
                node.evict_actor(actor_id)
        self._handle_actor_death(actor_id, cause, pending_tasks=pending,
                                 may_restart=not no_restart)

    def on_actor_worker_died(self, actor_id: ActorID, cause: str) -> None:
        """An actor's worker process died unexpectedly (a crash, a
        SIGKILL): actor death, with restarts."""
        with self._actor_lock:
            executor = self._actor_executors.pop(actor_id, None)
        pending = executor.kill(cause) if executor is not None else []
        info = self.gcs.get_actor_info(actor_id)
        if info is not None and info.node_id is not None:
            node = self.get_node(info.node_id)
            if node is not None:
                node.evict_actor(actor_id)
        self._handle_actor_death(actor_id, cause, pending_tasks=pending,
                                 may_restart=True)

    def _handle_actor_death(self, actor_id: ActorID, cause: str,
                            pending_tasks: List[TaskSpec],
                            may_restart: bool,
                            graceful: bool = False) -> None:
        """``graceful=True`` is the planned-migration variant (a node
        drain): the restart neither consumes the actor's max_restarts nor
        fails its pending tasks, which replay on the new incarnation
        whatever max_task_retries says."""
        self.process_router.discard_actor(actor_id)
        # actor-lifetime borrows die with the incarnation
        svc = getattr(self.cluster_backend, "owner_service", None)
        if svc is not None:
            svc.holder.release("a:" + actor_id.hex())
        remote = self._remote_actors.pop(actor_id, None)
        if remote is not None and not remote.dead:
            remote.kill_actor(actor_id, expected=True)
        info = self.gcs.get_actor_info(actor_id)
        if info is None:
            return
        with self._actor_lock:
            self._actor_executors.pop(actor_id, None)
        # Release the actor's lifetime resource hold on its (alive) node.
        if info.node_id is not None and info.creation_spec is not None:
            host = self.get_node(info.node_id)
            if host is not None and host.alive:
                host.ledger.release(info.creation_spec.resources)
                if host.tenancy is not None:
                    # settle the creation's per-job usage, held for the
                    # actor's whole lifetime (node._run_spec)
                    host.tenancy.note_done(
                        info.creation_spec.job_id.hex()
                        if info.creation_spec.job_id is not None else "",
                        info.creation_spec.resources)
            info.node_id = None
        can_restart = (may_restart and info.creation_spec is not None
                       and (graceful or info.max_restarts == -1
                            or info.num_restarts < info.max_restarts))
        if can_restart:
            self.stats["actor_restarts"] += 1
            if not graceful:    # a planned move burns no budget
                info.num_restarts += 1
            self.gcs.update_actor_state(actor_id, ActorState.RESTARTING)
            if graceful or info.max_task_retries != 0:
                # pending tasks survive the restart and replay on the new
                # incarnation
                with self._actor_lock:
                    self._actor_pending_tasks.setdefault(
                        actor_id, []).extend(pending_tasks)
            else:
                for spec in pending_tasks:
                    self._fail_task(spec, exc.ActorError(
                        exc.ActorUnavailableError(
                            f"actor restarting: {cause}"),
                        spec.name, actor_id))
            respec = _clone_spec_for_retry(info.creation_spec)
            respec.actor_id = actor_id
            with self._tasks_lock:
                inflight = _InFlightTask(respec)
                self._tasks[respec.task_id] = inflight
            self._submit_with_deps(respec, inflight, respec.dependencies())
        else:
            self.gcs.update_actor_state(actor_id, ActorState.DEAD,
                                        death_cause=cause)
            # no restart can come: the creation spec's arguments (a
            # server's weights on the card) must not outlive the actor
            info.creation_spec = None
            err_base = exc.ActorDiedError(actor_id, cause)
            with self._actor_lock:
                buffered = self._actor_pending_tasks.pop(actor_id, [])
            for spec in list(pending_tasks) + buffered:
                self._fail_task(spec, exc.ActorError(err_base, spec.name,
                                                     actor_id))

    # ------------------------------------------------------------------
    # cancellation
    # ------------------------------------------------------------------
    def cancel(self, ref: ObjectRef, force: bool = False,
               recursive: bool = True) -> None:
        """Cancel the task producing ``ref``. A task not yet running fails
        with TaskCancelledError. One running in a worker process gets a
        KeyboardInterrupt in its thread, or with ``force`` loses its
        process. One running on the driver's threads is failed only with
        ``force``: its thread runs on, and its result is dropped."""
        while True:
            with self._tasks_lock:
                target = None
                for inflight in self._tasks.values():
                    if ref.id in inflight.spec.return_ids:
                        target = inflight
                        break
            if target is None:
                return
            with target.lock:
                if target.state in (TaskState.FINISHED,
                                    TaskState.FAILED):
                    return
                target.cancelled = True
                was_running = target.state == TaskState.RUNNING
            # a retry replaces the _tasks entry (same task_id, fresh
            # _InFlightTask): if that happened between the lookup and the
            # flag set, cancel the live incarnation
            with self._tasks_lock:
                if self._tasks.get(target.spec.task_id) is target:
                    break
        if was_running and self.process_router.cancel_task(
                target.spec.task_id, force):
            # running in a worker process: force terminates the process
            # (the crash handler reports TaskCancelledError); non-force
            # raises KeyboardInterrupt in the task's thread
            return
        if was_running:
            # a daemon-executed task: forward over the wire
            node = (self.get_node(target.node_id)
                    if target.node_id else None)
            daemon = getattr(node, "daemon", None) if node else None
            if daemon is not None and daemon.cancel_task(
                    target.spec.task_id, force):
                return
        if not was_running or force:
            self._fail_task(target.spec, exc.TaskError(
                exc.TaskCancelledError(target.spec.task_id),
                target.spec.name))

    # ------------------------------------------------------------------
    # debug state (JAX's raylet-style dump with the dispatch stats)
    # ------------------------------------------------------------------
    def debug_state(self) -> str:
        lines = [f"session: {self.session_dir}",
                 f"stats: {self.stats}",
                 f"tracked refs: {self.refcounter.num_tracked()}",
                 f"lineage entries: {self.lineage.num_entries()}"]
        for node in self.nodes():
            with node._running_lock:
                running = len(node._running)
            lines.append(
                f"node {node.node_id.hex()[:8]}: alive={node.alive} "
                f"running={running} backlog={node._backlog_n} "
                f"actors={len(node.actors)} "
                f"store_used={node.store.used_bytes()} "
                f"loop={node.loop_stats}")
        if self.cluster_backend is not None:
            # which control-plane core each daemon advertised in hello
            lines.extend(self.cluster_backend.describe_peers())
        return "\n".join(lines)

    # ------------------------------------------------------------------
    # shutdown
    # ------------------------------------------------------------------
    def shutdown(self) -> None:
        self._shutdown = True
        from ray_tpu_torch.util import profiling
        profiling.stop_process_sampler()
        self.memory_monitor.stop()
        if self._log_monitor is not None:
            self._log_monitor.stop()  # joins; its loop drains once more
        self.process_router.shutdown()
        self.pg_manager.stop()
        for node in self.nodes():
            node.shutdown()
            node.store.close()
        with self._nodes_lock:
            self._nodes.clear()
        self.memory_store.clear()
        if self.cluster_backend is not None:
            self.cluster_backend.owner_service.holder.clear()
            self.cluster_backend.shutdown()
        shutil.rmtree(self.session_dir, ignore_errors=True)


class _StreamingGeneratorSentinel:
    def __init__(self, task_id: TaskID):
        self.task_id = task_id


class _ExitActor(BaseException):
    pass


def _class_is_async(cls) -> bool:
    return any(inspect.iscoroutinefunction(m)
               for _, m in inspect.getmembers(cls,
                                              predicate=inspect.isfunction))


def _clone_spec_for_retry(spec: TaskSpec) -> TaskSpec:
    # The task_id stays stable across attempts (attempt_number grows), so
    # streaming generator consumers and in-flight bookkeeping stay bound.
    respec = copy.copy(spec)
    respec.attempt_number = spec.attempt_number + 1
    return respec


def _retries_left(spec: TaskSpec) -> bool:
    """max_retries < 0 means unlimited retries."""
    return spec.max_retries < 0 or spec.attempt_number < spec.max_retries


def _find_nested_refs(value: Any, _depth: int = 0) -> List[ObjectRef]:
    """Shallow recursive scan for ObjectRefs inside standard containers."""
    if _depth > 6:
        return []
    if isinstance(value, ObjectRef):
        return [value]
    out: List[ObjectRef] = []
    if isinstance(value, (list, tuple, set, frozenset)):
        for v in value:
            out.extend(_find_nested_refs(v, _depth + 1))
    elif isinstance(value, dict):
        for k, v in value.items():
            out.extend(_find_nested_refs(k, _depth + 1))
            out.extend(_find_nested_refs(v, _depth + 1))
    return out


def capture_parent_pg_strategy(strategy):
    """Inherit the caller's placement group when it asked to capture child
    tasks."""
    if strategy != "DEFAULT":
        return strategy
    ctx = runtime_context._ctx.get()
    if (ctx is None or not ctx.pg_capture
            or ctx.placement_group_id is None):
        return strategy
    rt = global_runtime()
    if rt is None:
        return strategy
    pg = rt.pg_manager.get(ctx.placement_group_id)
    if pg is None:
        return strategy
    return PlacementGroupSchedulingStrategy(
        pg, placement_group_bundle_index=-1,
        placement_group_capture_child_tasks=True)


def init_runtime(**kwargs) -> Runtime:
    global _global_runtime
    with _global_lock:
        if _global_runtime is not None:
            raise RuntimeError("ray_tpu_torch is already initialized")
        _global_runtime = Runtime(**kwargs)
        return _global_runtime


def shutdown_runtime() -> None:
    from ray_tpu_torch._private.config import reset as _cfg_reset
    from ray_tpu_torch._private.export_events import reset_export_logger
    _cfg_reset()
    reset_export_logger()  # the next session binds its own dir
    global _global_runtime
    with _global_lock:
        if _global_runtime is not None:
            _global_runtime.shutdown()
            _global_runtime = None
