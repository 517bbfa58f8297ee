"""Autoscaler v1: the legacy monitor loop (counterpart of
``ray_tpu/autoscaler.py``), superseded by
:mod:`ray_tpu_torch.autoscaler_v2`.

Use ``autoscaler_v2.Reconciler`` for anything new: the GCS-state
reconciler with the instance state machine, the node-type catalog and the
provider seam. This module keeps the v1-shaped surface
(``StandardAutoscaler``, ``NodeProvider``) and the fake provider that adds
and removes virtual nodes in the running runtime. Resources are names:
``node_resources`` carries whatever the nodes offer.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Dict, List, Optional


class NodeProvider:
    """Minimal provider interface (create/terminate/list)."""

    def create_node(self) -> Any:
        raise NotImplementedError

    def terminate_node(self, node) -> None:
        raise NotImplementedError

    def non_terminated_nodes(self) -> List[Any]:
        raise NotImplementedError


class FakeNodeProvider(NodeProvider):
    """Adds/removes virtual nodes in the running runtime (test fixture)."""

    def __init__(self, runtime, node_resources: Dict[str, float],
                 object_store_memory: int = 256 * 1024 * 1024):
        self.runtime = runtime
        self.node_resources = dict(node_resources)
        self.object_store_memory = object_store_memory
        self._created: List[Any] = []

    def create_node(self):
        node = self.runtime.add_node(dict(self.node_resources),
                                     object_store_memory=
                                     self.object_store_memory)
        self._created.append(node)
        return node

    def terminate_node(self, node) -> None:
        if node in self._created:
            self._created.remove(node)
        self.runtime.remove_node(node)

    def non_terminated_nodes(self):
        return [n for n in self._created if n.alive]


class StandardAutoscaler:
    """Demand-driven reconciler over a NodeProvider."""

    def __init__(self, runtime, provider: NodeProvider, *,
                 min_nodes: int = 0, max_nodes: int = 8,
                 idle_timeout_s: float = 5.0,
                 upscaling_speed: int = 2):
        self.runtime = runtime
        self.provider = provider
        self.min_nodes = min_nodes
        self.max_nodes = max_nodes
        self.idle_timeout_s = idle_timeout_s
        self.upscaling_speed = upscaling_speed
        self._idle_since: Dict[Any, float] = {}
        self.stats = {"launched": 0, "terminated": 0, "updates": 0}

    # -- load metrics ----------------------------------------------------
    def pending_demand(self) -> Dict[str, float]:
        """Unserved resource demand (queued tasks + pending PG bundles)."""
        demand: Dict[str, float] = {}
        for node in self.runtime.nodes():
            with node._pending_lock:
                for k, v in node._pending_demand.items():
                    if k.startswith("_pg_"):
                        k = k.split("_", 4)[-1]  # unscope bundle resources
                    demand[k] = demand.get(k, 0.0) + v
        for pg in list(getattr(self.runtime.pg_manager, "_pending", [])):
            for bundle in pg.bundles:
                for k, v in bundle.resources.items():
                    demand[k] = demand.get(k, 0.0) + v
        return demand

    def available(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for node in self.runtime.nodes():
            if not node.alive:
                continue
            for k, v in node.ledger.available().items():
                if k.startswith("_pg_"):
                    continue
                out[k] = out.get(k, 0.0) + v
        return out

    # -- reconcile -------------------------------------------------------
    def update(self) -> None:
        self.stats["updates"] += 1
        demand = self.pending_demand()
        avail = self.available()
        unmet = {k: v - avail.get(k, 0.0) for k, v in demand.items()
                 if v > avail.get(k, 0.0) + 1e-9}
        managed = self.provider.non_terminated_nodes()
        total_nodes = sum(1 for n in self.runtime.nodes() if n.alive)

        if unmet and total_nodes < self.max_nodes:
            # bin-pack: nodes needed to cover the biggest unmet dimension
            per_node = getattr(self.provider, "node_resources", {})
            need = 1
            for k, miss in unmet.items():
                if per_node.get(k, 0.0) > 0:
                    need = max(need, math.ceil(miss / per_node[k]))
            need = min(need, self.upscaling_speed,
                       self.max_nodes - total_nodes)
            for _ in range(max(need, 0)):
                self.provider.create_node()
                self.stats["launched"] += 1
            return

        # scale down idle managed nodes
        now = time.time()
        for node in managed:
            if self._is_idle(node):
                since = self._idle_since.setdefault(node, now)
                if (now - since >= self.idle_timeout_s
                        and total_nodes > self.min_nodes
                        and len(managed) > 0):
                    self.provider.terminate_node(node)
                    self._idle_since.pop(node, None)
                    self.stats["terminated"] += 1
                    total_nodes -= 1
            else:
                self._idle_since.pop(node, None)

    def _is_idle(self, node) -> bool:
        with node._running_lock:
            running = len(node._running)
        with node._pending_lock:
            pending = sum(node._pending_demand.values())
        return running == 0 and pending == 0 and not node.actors

    # -- monitor loop ----------------------------------------------------
    def start(self, interval_s: float = 1.0) -> threading.Event:
        stop = threading.Event()

        def loop():
            while not stop.wait(interval_s):
                try:
                    self.update()
                except Exception:
                    pass

        threading.Thread(target=loop, daemon=True,
                         name="autoscaler").start()
        return stop
