"""Placement groups: gang scheduling of resource bundles (counterpart of
``ray_tpu/util/placement_group.py``).

A placement group reserves a list of resource bundles across the nodes
atomically, with the PACK / SPREAD / STRICT_PACK / STRICT_SPREAD strategies;
tasks and actors are then scheduled into the reservations through
``PlacementGroupSchedulingStrategy``.

Each placed bundle turns node capacity into bundle-scoped resources
(``_pg_<id>_<index>_<name>``) on the node's ledger, and a task placed in the
group has its demand rewritten onto those names, so bundle accounting rides
the node's own dispatch. A bundle holding ``GPU`` holds the card: nothing
outside the group can take it while the group lives.

Left out, with the parts of the runtime they serve: the TPU-topology
sub-slice allocator (ROADMAP A12), the daemon's two-phase bundle commit and
the re-placement of bundles on node death (A11c), export events (A11e).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional

from ray_tpu_torch import exceptions as exc
from ray_tpu_torch._private.ids import NodeID, ObjectID, PlacementGroupID

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


def scoped_resource(pg_id: PlacementGroupID, index: int,
                    resource: str) -> str:
    return f"_pg_{pg_id.hex()[:16]}_{index}_{resource}"


@dataclass
class Bundle:
    index: int
    resources: Dict[str, float]
    node_id: Optional[NodeID] = None

    def scoped_resources(self, pg_id: PlacementGroupID) -> Dict[str, float]:
        return {scoped_resource(pg_id, self.index, k): v
                for k, v in self.resources.items()}


class PlacementGroup:
    """Handle to a (possibly still placing) placement group."""

    def __init__(self, pg_id: PlacementGroupID, bundles: List[Bundle],
                 strategy: str, name: str = ""):
        self.id = pg_id
        self.bundles = bundles
        self.strategy = strategy
        self.name = name
        self.state = "PENDING"
        self._ready_event = threading.Event()
        self._ready_ref: Optional[ObjectID] = None

    def __getstate__(self):
        """A handle that goes through the object store: the wait machinery
        is rebuilt on unpickle (the runtime binds the live group by id)."""
        d = dict(self.__dict__)
        d["_ready_event"] = None
        d["_ready_ref"] = None
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self._ready_event = threading.Event()
        if self.state in ("CREATED", "REMOVED"):
            self._ready_event.set()

    @property
    def bundle_specs(self) -> List[Dict[str, float]]:
        return [dict(b.resources) for b in self.bundles]

    def bundle_nodes(self) -> List[Optional[NodeID]]:
        return [b.node_id for b in self.bundles]

    def is_ready(self) -> bool:
        return self.state == "CREATED"

    def ready(self):
        """ObjectRef that resolves to this group once it is placed."""
        from ray_tpu_torch._private import worker
        return worker.global_worker().pg_manager.ready_ref(self.id)

    def wait(self, timeout_seconds: float = 30) -> bool:
        """Wait until the group is placed (or removed, or the timeout);
        True once it is placed. A handle that came through the object
        store takes the placed group's node assignments."""
        from ray_tpu_torch._private import worker
        rt = worker.global_runtime()
        placed = (rt.pg_manager.wait(self.id, timeout_seconds)
                  if rt is not None else None)
        if placed is not None:
            self.state, self.bundles = placed
        return self.is_ready()

    def __repr__(self):
        return (f"PlacementGroup({self.id.hex()[:12]}, {self.strategy}, "
                f"{self.state}, {len(self.bundles)} bundles)")


class PlacementGroupManager:
    """Places bundles onto nodes and retries pending groups, on a thread
    that ends with its runtime."""

    def __init__(self, runtime):
        self._rt = runtime
        self._lock = threading.Lock()
        self._pending: List[PlacementGroup] = []  #: guarded by self._lock
        #: guarded by self._lock
        self._groups: Dict[PlacementGroupID, PlacementGroup] = {}
        self._wake = threading.Event()
        self._stopped = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="pg-manager")
        self._thread.start()
        runtime.gcs.pubsub.subscribe("node", lambda msg: self._wake.set())

    def create(self, bundles: List[Dict[str, float]], strategy: str,
               name: str = "") -> PlacementGroup:
        if strategy not in VALID_STRATEGIES:
            raise ValueError(f"invalid strategy {strategy!r}; "
                             f"one of {VALID_STRATEGIES}")
        if not bundles:
            raise ValueError("placement group needs at least one bundle")
        for b in bundles:
            if not b or any(v < 0 for v in b.values()):
                raise ValueError(f"invalid bundle {b!r}")
        pg = PlacementGroup(
            PlacementGroupID.from_random(),
            [Bundle(i, dict(b)) for i, b in enumerate(bundles)],
            strategy, name)
        with self._lock:
            self._groups[pg.id] = pg
            self._pending.append(pg)
        self._wake.set()
        return pg

    def _release_bundles(self, pg: PlacementGroup) -> None:
        """Return every placed bundle's reservation to its node."""
        for b in pg.bundles:
            node = self._rt.get_node(b.node_id) if b.node_id else None
            if node is not None and node.alive:
                node.ledger.remove_total(b.scoped_resources(pg.id))
                node.ledger.release(b.resources)
                daemon = getattr(node, "daemon", None)
                if daemon is not None:
                    daemon.cancel_bundle(pg.id.hex(), b.index)
            b.node_id = None

    def remove(self, pg: PlacementGroup) -> None:
        with self._lock:
            if pg.state == "REMOVED":
                return
            was_created = pg.state == "CREATED"
            pg.state = "REMOVED"
            if pg in self._pending:
                self._pending.remove(pg)
        if was_created:
            self._release_bundles(pg)
        pg._ready_event.set()

    def get(self, pg_id: PlacementGroupID) -> Optional[PlacementGroup]:
        with self._lock:
            return self._groups.get(pg_id)

    def ready_ref(self, pg_id: PlacementGroupID):
        """The ObjectRef that resolves to the group once it is placed (an
        error once it is removed); one per group."""
        from ray_tpu_torch._private.object_ref import ObjectRef

        pg = self.get(pg_id)
        if pg is None:
            raise ValueError("unknown placement group")
        rt = self._rt
        with self._lock:
            fresh = pg._ready_ref is None
            if fresh:
                pg._ready_ref = ObjectID.from_random()
                rt.futures.register(pg._ready_ref)
        if fresh:
            def on_ready():
                pg._ready_event.wait()
                if pg.state == "CREATED":
                    rt._store_value(pg._ready_ref, pg)
                else:
                    rt._store_value(pg._ready_ref, exc.TaskError(
                        exc.PlacementGroupUnschedulableError(
                            "placement group removed"),
                        "placement_group.ready"))
                rt.futures.complete(pg._ready_ref)

            threading.Thread(target=on_ready, daemon=True,
                             name="pg-ready").start()
        return ObjectRef(pg._ready_ref, task_name="pg.ready")

    def wait(self, pg_id: PlacementGroupID, timeout: float):
        """(state, bundles) of the group once it is placed or removed, or
        at the timeout; None for a group this runtime does not hold."""
        pg = self.get(pg_id)
        if pg is None:
            return None
        pg._ready_event.wait(timeout)
        return pg.state, pg.bundles

    def on_node_death(self, node_id: NodeID) -> None:
        """Re-place the groups that had a bundle on a dead node: every
        surviving bundle's reservation is released and the group goes
        back to the pending queue (RESCHEDULING; waiters block again)."""
        with self._lock:
            for pg in self._groups.values():
                if pg.state != "CREATED":
                    continue
                if any(b.node_id == node_id for b in pg.bundles):
                    for b in pg.bundles:
                        if b.node_id is not None and b.node_id != node_id:
                            node = self._rt.get_node(b.node_id)
                            if node is not None and node.alive:
                                node.ledger.remove_total(
                                    b.scoped_resources(pg.id))
                                node.ledger.release(b.resources)
                                daemon = getattr(node, "daemon", None)
                                if daemon is not None:
                                    daemon.cancel_bundle(pg.id.hex(),
                                                         b.index)
                        b.node_id = None
                    pg.state = "RESCHEDULING"
                    pg._ready_event.clear()
                    self._pending.append(pg)
        self._wake.set()

    def table(self) -> Dict[str, Dict]:
        with self._lock:
            return {pg.id.hex(): {
                "name": pg.name, "strategy": pg.strategy, "state": pg.state,
                "bundles": {b.index: dict(b.resources) for b in pg.bundles},
                "bundle_nodes": [b.node_id.hex() if b.node_id else None
                                 for b in pg.bundles],
            } for pg in self._groups.values()}

    def stop(self) -> None:
        """End the placement thread with the runtime, and wake every waiter
        on a group that will now never be placed."""
        self._stopped = True
        self._wake.set()
        self._thread.join(timeout=5)
        with self._lock:
            groups = list(self._groups.values())
        for pg in groups:
            pg._ready_event.set()

    # -- placement ---------------------------------------------------------
    def _loop(self) -> None:
        while not self._stopped:
            self._wake.wait(1.0)
            self._wake.clear()
            with self._lock:
                pending = list(self._pending)
            for pg in pending:
                if self._stopped:
                    return
                if not self._try_place(pg):
                    continue
                with self._lock:
                    if pg.state == "REMOVED":
                        # lost the race with remove(): undo the reservation
                        self._release_bundles(pg)
                        continue
                    if pg in self._pending:
                        self._pending.remove(pg)
                    pg.state = "CREATED"
                pg._ready_event.set()

    def _try_place(self, pg: PlacementGroup) -> bool:
        nodes = self._rt.alive_nodes()
        if not nodes:
            return False
        assignment = self._assign(pg, nodes)
        if assignment is None:
            return False
        acquired: List[tuple] = []
        ok = True
        for bundle, node in assignment:
            if not node.ledger.try_acquire(bundle.resources):
                ok = False
                break
            # a daemon-backed node: phase 1, PREPARE on the wire (the
            # raylet's PrepareBundleResources)
            daemon = getattr(node, "daemon", None)
            if daemon is not None and not daemon.prepare_bundle(
                    pg.id.hex(), bundle.index, dict(bundle.resources)):
                node.ledger.release(bundle.resources)
                ok = False
                break
            acquired.append((bundle, node))
        if not ok:  # roll back the partial reservation (the abort)
            for bundle, node in acquired:
                node.ledger.release(bundle.resources)
                daemon = getattr(node, "daemon", None)
                if daemon is not None:
                    daemon.cancel_bundle(pg.id.hex(), bundle.index)
            return False
        for bundle, node in acquired:
            node.ledger.add_total(bundle.scoped_resources(pg.id))
            bundle.node_id = node.node_id
            # phase 2: COMMIT
            daemon = getattr(node, "daemon", None)
            if daemon is not None:
                daemon.commit_bundle(pg.id.hex(), bundle.index)
        return True

    @staticmethod
    def _assign(pg: PlacementGroup, nodes) -> Optional[List[tuple]]:
        """Map bundles to nodes per strategy using *available* capacity."""
        avail = {n.node_id: n.effective_available() for n in nodes}

        def fits(node, bundle) -> bool:
            a = avail[node.node_id]
            return all(a.get(k, 0.0) >= v - 1e-9
                       for k, v in bundle.resources.items())

        def charge(node, bundle) -> None:
            a = avail[node.node_id]
            for k, v in bundle.resources.items():
                a[k] = a.get(k, 0.0) - v

        out: List[tuple] = []
        strategy = pg.strategy
        ordered = sorted(nodes, key=lambda n: -sum(avail[n.node_id].values()))
        if strategy in ("PACK", "STRICT_PACK"):
            # greedy: fewest nodes, the nodes already used first;
            # STRICT_PACK demands exactly one node
            for bundle in pg.bundles:
                used = [n for n in ordered if any(x[1] is n for x in out)]
                for node in used + ordered:
                    if fits(node, bundle):
                        charge(node, bundle)
                        out.append((bundle, node))
                        break
                else:
                    return None
            if strategy == "STRICT_PACK" and len({id(n) for _, n in out}) != 1:
                return None
            return out
        # SPREAD / STRICT_SPREAD: round-robin across distinct nodes
        used_nodes: List = []
        for bundle in pg.bundles:
            candidates = ([n for n in ordered if n not in used_nodes]
                          + ([] if strategy == "STRICT_SPREAD"
                             else used_nodes))
            for node in candidates:
                if fits(node, bundle):
                    charge(node, bundle)
                    out.append((bundle, node))
                    used_nodes.append(node)
                    break
            else:
                return None
        return out


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def placement_group(bundles: List[Dict[str, float]],
                    strategy: str = "PACK",
                    name: str = "") -> PlacementGroup:
    """Create a placement group (async; use ``.ready()`` / ``.wait()``)."""
    from ray_tpu_torch._private import worker
    return worker.global_worker().pg_manager.create(bundles, strategy, name)


def remove_placement_group(pg: PlacementGroup) -> None:
    from ray_tpu_torch._private import worker
    worker.global_worker().pg_manager.remove(pg)


def placement_group_table() -> Dict[str, Dict]:
    from ray_tpu_torch._private import worker
    return worker.global_worker().pg_manager.table()


def get_current_placement_group() -> Optional[PlacementGroup]:
    from ray_tpu_torch._private import runtime_context, worker
    rt = worker.global_worker()
    ctx = runtime_context._ctx.get()
    pg_id = ctx.placement_group_id if ctx else None
    return rt.pg_manager.get(pg_id) if pg_id else None
