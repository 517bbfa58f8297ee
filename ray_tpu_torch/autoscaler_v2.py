"""Autoscaler v2: a GCS-state reconciler over an instance lifecycle
(counterpart of ``ray_tpu/autoscaler_v2.py``).

The reconciler (1) reads the autoscaler state the runtime assembles
(pending resource demand and the cluster's shape), (2) tracks every
instance through an explicit state machine (QUEUED -> REQUESTED ->
ALLOCATED -> RAY_RUNNING -> RAY_STOPPING -> TERMINATED), and (3) drives a
provider toward the desired count, picking the smallest node type that
covers the largest single unmet ask.

The node-type catalog is JAX's data, unchanged (``TPU_SLICE_TYPES``):
resources are names, so a catalog of GPU host types is data of the same
shape (ROADMAP A12). ``GkeTpuProvider`` is the cloud-API-shaped stub;
``RuntimeBackedTpuProvider`` materializes instances as in-process runtime
nodes; ``ProcessHostProvider`` spawns a real node daemon through the
cluster launcher, which registers at the head and joins the driver.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
import math
import threading
import time
from typing import Any, Dict, List, Optional


class InstanceStatus(enum.Enum):
    QUEUED = "QUEUED"
    REQUESTED = "REQUESTED"
    ALLOCATED = "ALLOCATED"
    RAY_RUNNING = "RAY_RUNNING"
    RAY_STOPPING = "RAY_STOPPING"
    TERMINATING = "TERMINATING"
    TERMINATED = "TERMINATED"
    ALLOCATION_FAILED = "ALLOCATION_FAILED"


@dataclasses.dataclass
class Instance:
    instance_id: str
    node_type: str
    status: InstanceStatus = InstanceStatus.QUEUED
    cloud_instance_id: Optional[str] = None
    node: Any = None                       # runtime node once RAY_RUNNING
    history: List[str] = dataclasses.field(default_factory=list)
    updated_at: float = 0.0

    def transition(self, status: InstanceStatus) -> None:
        self.history.append(f"{self.status.value}->{status.value}")
        self.status = status
        self.updated_at = time.time()


class InstanceManager:
    """The instance table + legal transitions (instance_manager/)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instances: Dict[str, Instance] = {}
        self._counter = itertools.count()

    def create(self, node_type: str) -> Instance:
        with self._lock:
            inst = Instance(f"inst-{next(self._counter)}", node_type)
            self._instances[inst.instance_id] = inst
            return inst

    def list(self, *statuses: InstanceStatus) -> List[Instance]:
        with self._lock:
            out = list(self._instances.values())
        if statuses:
            out = [i for i in out if i.status in statuses]
        return out

    def active(self) -> List[Instance]:
        return self.list(InstanceStatus.QUEUED, InstanceStatus.REQUESTED,
                         InstanceStatus.ALLOCATED,
                         InstanceStatus.RAY_RUNNING)


class CloudProvider:
    """Cloud API seam. ``node_types`` maps a slice/host type to its
    resource shape; launch/terminate talk to the cloud."""

    node_types: Dict[str, Dict[str, float]] = {}

    def launch(self, node_type: str) -> str:
        raise NotImplementedError

    def terminate(self, cloud_instance_id: str) -> None:
        raise NotImplementedError

    def poll_allocated(self, cloud_instance_id: str) -> bool:
        """Has the cloud finished provisioning this instance?"""
        raise NotImplementedError


# Slice catalog: TPU capacity comes in whole ICI slices.
TPU_SLICE_TYPES: Dict[str, Dict[str, float]] = {
    "cpu-host": {"CPU": 16.0},
    "v5e-4": {"TPU": 4.0, "CPU": 8.0},
    "v5e-8": {"TPU": 8.0, "CPU": 16.0},
    "v5p-8": {"TPU": 8.0, "CPU": 32.0},
    "v5p-16": {"TPU": 16.0, "CPU": 64.0},
}


class GkeTpuProvider(CloudProvider):
    """GKE / TPU-VM provider STUB: the shape of the real provider (node
    pools keyed by slice topology; create/delete node-pool members via
    the cloud API) with the API calls left unimplemented — this build is
    zero-egress. Use RuntimeBackedTpuProvider to exercise the reconciler.
    """

    node_types = TPU_SLICE_TYPES

    def __init__(self, project: str = "", zone: str = "",
                 cluster: str = ""):
        self.project, self.zone, self.cluster = project, zone, cluster

    def launch(self, node_type: str) -> str:
        raise NotImplementedError(
            "GKE/TPU-VM API is unavailable in this environment; "
            "implement launch() against container.googleapis.com / "
            "tpu.googleapis.com (node pool per slice type)")

    def terminate(self, cloud_instance_id: str) -> None:
        raise NotImplementedError

    def poll_allocated(self, cloud_instance_id: str) -> bool:
        raise NotImplementedError


class RuntimeBackedTpuProvider(CloudProvider):
    """Materializes instances as runtime nodes (the v2 analogue of the
    reference's fake_multi_node provider): full lifecycle, no cloud."""

    node_types = TPU_SLICE_TYPES

    def __init__(self, runtime, provision_delay_s: float = 0.0):
        self.runtime = runtime
        self.provision_delay_s = provision_delay_s
        self._counter = itertools.count()
        self._launched: Dict[str, Dict[str, Any]] = {}

    def launch(self, node_type: str) -> str:
        cid = f"cloud-{next(self._counter)}"
        self._launched[cid] = {"node_type": node_type,
                               "at": time.time(), "node": None}
        return cid

    def poll_allocated(self, cloud_instance_id: str) -> bool:
        entry = self._launched[cloud_instance_id]
        return time.time() - entry["at"] >= self.provision_delay_s

    def materialize(self, cloud_instance_id: str):
        entry = self._launched[cloud_instance_id]
        if entry["node"] is None:
            entry["node"] = self.runtime.add_node(
                dict(self.node_types[entry["node_type"]]),
                labels={"ray_tpu.io/slice-type": entry["node_type"]},
                object_store_memory=256 * 1024 * 1024)
        return entry["node"]

    def terminate(self, cloud_instance_id: str) -> None:
        entry = self._launched.pop(cloud_instance_id, None)
        if entry and entry["node"] is not None and entry["node"].alive:
            self.runtime.remove_node(entry["node"])


class ProcessHostProvider(CloudProvider):
    """A provider that creates hosts: each launch spawns a real node
    daemon through the cluster launcher (a subprocess of this machine, or
    an SSH bootstrap with an ``SshProvider``), which registers at the
    head; the driver's node-event subscription then adds it as a live
    remote node. Demand -> a new process -> head registration -> a
    schedulable node."""

    node_types = TPU_SLICE_TYPES

    def __init__(self, runtime, launcher=None):
        from ray_tpu_torch.cluster_launcher import SubprocessProvider
        self.runtime = runtime
        self.launcher = launcher or SubprocessProvider()
        self._launched: Dict[str, Dict[str, Any]] = {}

    def _head_address(self) -> str:
        backend = getattr(self.runtime, "cluster_backend", None)
        if backend is None:
            raise RuntimeError(
                "ProcessHostProvider needs a daemons-cluster runtime")
        host, port = backend.head.addr
        return f"{host}:{port}"

    def launch(self, node_type: str) -> str:
        rec = self.launcher.create_worker(
            self._head_address(),
            {"resources": dict(self.node_types[node_type])})
        self._launched[rec["node_id"]] = rec
        return rec["node_id"]

    def poll_allocated(self, cloud_instance_id: str) -> bool:
        return True      # the OS process exists the moment spawn returns

    def materialize(self, cloud_instance_id: str):
        """The node is 'running' once the daemon registered at the head
        and the driver's subscription added it; None keeps the instance
        ALLOCATED until then."""
        from ray_tpu_torch._private.ids import NodeID
        return self.runtime.get_node(
            NodeID.from_hex(cloud_instance_id))

    def terminate(self, cloud_instance_id: str) -> None:
        rec = self._launched.pop(cloud_instance_id, None)
        if rec is not None:
            self.launcher.terminate(rec)


def gcs_autoscaler_state(runtime) -> Dict[str, Any]:
    """The cluster-state snapshot the reconciler consumes (the role of
    GcsAutoscalerStateManager): pending demand + per-node shape, derived
    from GCS-visible state rather than runtime internals."""
    demand: Dict[str, float] = {}
    max_chunk: Dict[str, float] = {}   # largest SINGLE task/bundle ask
    for node in runtime.nodes():
        with node._pending_lock:
            for k, v in node._pending_demand.items():
                if k.startswith("_pg_"):
                    k = k.split("_", 4)[-1]
                demand[k] = demand.get(k, 0.0) + v
    # per-task chunk sizes come from the queued specs, NOT the per-node
    # aggregate (10 one-chip tasks must not demand a 10-chip slice)
    with runtime._tasks_lock:
        queued = [t.spec for t in runtime._tasks.values()
                  if t.state in ("PENDING_ARGS_AVAIL",
                                 "PENDING_NODE_ASSIGNMENT")]
    for spec in queued:
        for k, v in (spec.resources or {}).items():
            if k.startswith("_pg_"):
                k = k.split("_", 4)[-1]
            max_chunk[k] = max(max_chunk.get(k, 0.0), v)
    for pg in list(getattr(runtime.pg_manager, "_pending", [])):
        for bundle in pg.bundles:
            for k, v in bundle.resources.items():
                demand[k] = demand.get(k, 0.0) + v
                max_chunk[k] = max(max_chunk.get(k, 0.0), v)
    nodes = []
    for info in runtime.gcs.alive_nodes():
        node = runtime.get_node(info.node_id)
        if node is None or not node.alive:
            continue
        with node._running_lock:
            running = len(node._running)
        nodes.append({"node_id": info.node_id, "running": running,
                      "available": node.ledger.available(),
                      "total": dict(node.ledger.total),
                      "has_actors": bool(node.actors)})
    return {"pending_demand": demand, "max_chunk_demand": max_chunk,
            "nodes": nodes}


class Reconciler:
    """One reconcile pass = sync instance states with the provider and
    the GCS view, then close the gap between desired and actual."""

    def __init__(self, runtime, provider: CloudProvider, *,
                 max_instances: int = 16, idle_timeout_s: float = 5.0,
                 drain_deadline_s: float = 5.0):
        self.runtime = runtime
        self.provider = provider
        self.instance_manager = InstanceManager()
        self.max_instances = max_instances
        self.idle_timeout_s = idle_timeout_s
        self.drain_deadline_s = drain_deadline_s
        self._idle_since: Dict[str, float] = {}
        self.stats = {"reconciles": 0, "launched": 0, "terminated": 0,
                      "drained": 0}

    # -- helpers ----------------------------------------------------------
    def _pick_node_type(self, unmet: Dict[str, float],
                        max_chunk: Dict[str, float]) -> Optional[str]:
        """Smallest slice type that could host the LARGEST single
        task/bundle demand for each unmet resource (TPU comes in whole
        slices; a type smaller than the biggest bundle would launch
        nodes the bundle can never fit on)."""
        best = None
        for node_type, shape in self.provider.node_types.items():
            if not all(shape.get(k, 0.0) >= max(max_chunk.get(k, 0.0),
                                                1e-9)
                       for k in unmet):
                continue
            size = sum(shape.values())
            if best is None or size < best[0]:
                best = (size, node_type)
        return best[1] if best else None

    # -- the pass ---------------------------------------------------------
    def reconcile(self) -> None:
        self.stats["reconciles"] += 1
        im = self.instance_manager

        # 1. advance lifecycle: QUEUED -> REQUESTED
        for inst in im.list(InstanceStatus.QUEUED):
            try:
                inst.cloud_instance_id = self.provider.launch(
                    inst.node_type)
                inst.transition(InstanceStatus.REQUESTED)
                self.stats["launched"] += 1
            except Exception:
                inst.transition(InstanceStatus.ALLOCATION_FAILED)

        # 2. REQUESTED -> ALLOCATED (cloud finished provisioning)
        for inst in im.list(InstanceStatus.REQUESTED):
            try:
                if self.provider.poll_allocated(inst.cloud_instance_id):
                    inst.transition(InstanceStatus.ALLOCATED)
            except Exception:
                inst.transition(InstanceStatus.ALLOCATION_FAILED)

        # 3. ALLOCATED -> RAY_RUNNING (node joined the cluster)
        for inst in im.list(InstanceStatus.ALLOCATED):
            materialize = getattr(self.provider, "materialize", None)
            if materialize is not None:
                inst.node = materialize(inst.cloud_instance_id)
            if inst.node is not None and inst.node.alive:
                inst.transition(InstanceStatus.RAY_RUNNING)

        # 4. desired-state gap from the GCS snapshot
        state = gcs_autoscaler_state(self.runtime)
        demand = state["pending_demand"]
        avail: Dict[str, float] = {}
        for node in state["nodes"]:
            for k, v in node["available"].items():
                if not k.startswith("_pg_"):
                    avail[k] = avail.get(k, 0.0) + v
        unmet = {k: v - avail.get(k, 0.0) for k, v in demand.items()
                 if v > avail.get(k, 0.0) + 1e-9}
        pending_supply = im.list(InstanceStatus.QUEUED,
                                 InstanceStatus.REQUESTED,
                                 InstanceStatus.ALLOCATED)
        if unmet and not pending_supply \
                and len(im.active()) < self.max_instances:
            node_type = self._pick_node_type(
                unmet, state.get("max_chunk_demand", {}))
            if node_type is not None:
                shape = self.provider.node_types[node_type]
                count = max(math.ceil(v / shape[k])
                            for k, v in unmet.items()
                            for k2 in [k] if shape.get(k, 0.0) > 0)
                count = min(count,
                            self.max_instances - len(im.active()))
                for _ in range(max(1, count)):
                    im.create(node_type)

        # 5. drain idle RAY_RUNNING instances
        now = time.time()
        if not unmet:
            for inst in im.list(InstanceStatus.RAY_RUNNING):
                node = inst.node
                idle = (node is not None and node.alive
                        and not node.actors
                        and not self._node_busy(node))
                if idle:
                    since = self._idle_since.setdefault(
                        inst.instance_id, now)
                    if now - since >= self.idle_timeout_s:
                        inst.transition(InstanceStatus.RAY_STOPPING)
                else:
                    self._idle_since.pop(inst.instance_id, None)

        # 6. RAY_STOPPING: graceful drain first, then TERMINATED. The
        # drain migrates any leftover primary object replicas off the
        # idle node BEFORE it disappears — a downscale must never pay
        # lineage reconstruction for data that was sitting on a node we
        # chose to remove. The drain's own deadline escalation bounds
        # how long an instance can linger here.
        for inst in im.list(InstanceStatus.RAY_STOPPING):
            node = inst.node
            still_in = (node is not None
                        and self.runtime.get_node(node.node_id)
                        is not None)
            if still_in and node.alive:
                if self.runtime.begin_node_drain(
                        node, self.drain_deadline_s, "idle downscale"):
                    self.stats["drained"] += 1
                continue        # re-check next pass: drain in flight
            inst.transition(InstanceStatus.TERMINATING)
            try:
                self.provider.terminate(inst.cloud_instance_id)
            except Exception:
                pass
            self.stats["terminated"] += 1
            inst.transition(InstanceStatus.TERMINATED)
            self._idle_since.pop(inst.instance_id, None)

    @staticmethod
    def _node_busy(node) -> bool:
        with node._running_lock:
            if node._running:
                return True
        with node._pending_lock:
            return bool(node._pending_demand)

    # -- loop -------------------------------------------------------------
    def start(self, interval_s: float = 0.5) -> threading.Event:
        stop = threading.Event()

        def loop():
            while not stop.wait(interval_s):
                try:
                    self.reconcile()
                except Exception:
                    pass

        threading.Thread(target=loop, daemon=True,
                         name="autoscaler-v2").start()
        return stop
