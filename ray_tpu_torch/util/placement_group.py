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
outside the group can take it while the group lives. A daemon-backed node
takes its bundles in two phases (prepare, then commit or cancel), and a
group with a bundle on a dead node is placed again.

Under a declared ``tpu_topology`` a group's chips (``GPU``, the port's chip
resource, where JAX reads ``TPU``) claim one axis-aligned contiguous
sub-slice of the torus (``parallel/topology.py``), and its bundles land on
that sub-slice's hosts. Draining nodes take no new bundle.
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
    # the torus coords this bundle's chips claimed (the topology path)
    tpu_chips: Optional[List[tuple]] = None

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
        # the contiguous sub-slice the group's chips claimed under a
        # declared topology; freed on remove, node death and abort
        self.subslice = None
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
        topo = self._rt.tpu_topology
        if topo is not None:
            cap = topo.topology.chips_per_host
            for b in bundles:
                t = b.get("GPU", 0)
                if t != int(t):
                    raise ValueError(
                        f"fractional TPU bundle {b!r}: chips are whole "
                        "torus nodes under a declared topology")
                if t > cap:
                    raise ValueError(
                        f"bundle {b!r} wants {int(t)} chips but hosts of "
                        f"{topo.topology!r} have {cap}; a bundle is one "
                        "node's reservation — split it across bundles")
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
        self._free_subslice(pg)

    def _free_subslice(self, pg: PlacementGroup) -> None:
        """Return the group's sub-slice to the allocator."""
        topo = self._rt.tpu_topology
        if pg.subslice is not None and topo is not None:
            topo.free(pg.subslice)
        pg.subslice = None
        for b in pg.bundles:
            b.tpu_chips = None

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
        back to the pending queue (RESCHEDULING; waiters block again). The
        dead node's torus host is unbound, and its group's sub-slice freed:
        a replacement node binds to that host on the next placement."""
        topo = self._rt.tpu_topology
        if topo is not None:
            topo.unbind_node(node_id)
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
                    self._free_subslice(pg)
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
                **({"subslice": {"origin": sub.origin, "shape": sub.shape},
                    "bundle_chips": [b.tpu_chips for b in pg.bundles]}
                   # a snapshot: _free_subslice clears the field unlocked
                   if (sub := pg.subslice) is not None else {}),
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
        # draining nodes take no new bundle (their capacity is on its way
        # out); schedulable_nodes falls back to them only when every live
        # node drains
        nodes = self._rt.schedulable_nodes()
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
            self._free_subslice(pg)
            return False
        for bundle, node in acquired:
            node.ledger.add_total(bundle.scoped_resources(pg.id))
            bundle.node_id = node.node_id
            # phase 2: COMMIT
            daemon = getattr(node, "daemon", None)
            if daemon is not None:
                daemon.commit_bundle(pg.id.hex(), bundle.index)
        return True

    def _assign(self, pg: PlacementGroup, nodes) -> Optional[List[tuple]]:
        """Map bundles to nodes per strategy using *available* capacity; a
        group that holds chips under a declared topology takes
        ``_assign_tpu``."""
        topo = self._rt.tpu_topology
        if topo is not None and any(
                b.resources.get("GPU", 0) > 0 for b in pg.bundles):
            return self._assign_tpu(pg, nodes, topo)
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

    @staticmethod
    def _assign_tpu(pg: PlacementGroup, nodes, topo) -> Optional[List[tuple]]:
        """The topology path: the group's chips claim ONE axis-aligned
        contiguous sub-slice of the torus and its bundles land on that
        sub-slice's hosts. The claim goes on the group (``pg.subslice`` and
        each bundle's chip coords) and is freed on remove, node death and
        the two-phase commit's abort."""
        chips = [int(b.resources.get("GPU", 0)) for b in pg.bundles]
        total = sum(chips)
        # bind the nodes that hold chips to torus hosts (first seen, stable)
        chip_nodes = [n for n in nodes if n.ledger.total.get("GPU", 0) > 0]
        topo.bind_nodes([n.node_id for n in chip_nodes])
        node_by_id = {n.node_id: n for n in chip_nodes}
        host_node = {h: topo.node_of_host(h)
                     for h in range(topo.topology.num_hosts)}
        avail = {n.node_id: n.effective_available() for n in nodes}
        strategy = pg.strategy

        chip_items = [(b, c) for b, c in zip(pg.bundles, chips) if c > 0]
        plain_items = [b for b, c in zip(pg.bundles, chips) if c == 0]

        def try_pack(cand) -> Optional[List[tuple]]:
            """Greedy bundle -> host packing for one candidate box, the
            largest bundles first (fewer fragments a host). Chip-less
            bundles place by the generic strategy on ANY node: they must
            not be forced onto, or burn, the sub-slice's hosts. Returns
            [(bundle, node, chip coords)] or None."""
            remaining = topo.chips_by_host(cand)
            trial = {nid: dict(a) for nid, a in avail.items()}
            packed: List[tuple] = []
            used_hosts: set = set()
            used_nodes: List = []

            def fits(node, bundle) -> bool:
                a = trial[node.node_id]
                return all(a.get(k, 0.0) >= v - 1e-9
                           for k, v in bundle.resources.items())

            def charge(node, bundle) -> None:
                a = trial[node.node_id]
                for k, v in bundle.resources.items():
                    a[k] = a.get(k, 0.0) - v

            for bundle, c in sorted(chip_items, key=lambda t: -t[1]):
                hosts = sorted(remaining)
                if strategy in ("SPREAD", "STRICT_SPREAD"):
                    # fresh hosts first (STRICT_SPREAD: fresh hosts only)
                    order = [h for h in hosts if h not in used_hosts]
                    if strategy == "SPREAD":
                        order += [h for h in hosts if h in used_hosts]
                else:
                    order = hosts
                for h in order:
                    if len(remaining[h]) < c:
                        continue
                    node = node_by_id.get(host_node.get(h))
                    if (node is None or not node.alive
                            or not fits(node, bundle)):
                        continue
                    charge(node, bundle)
                    taken = [remaining[h].pop(0) for _ in range(c)]
                    used_hosts.add(h)
                    if node not in used_nodes:
                        used_nodes.append(node)
                    packed.append((bundle, node, taken))
                    break
                else:
                    return None
            for bundle in plain_items:
                if strategy == "STRICT_PACK":
                    cands = used_nodes[:1] or list(nodes)
                elif strategy == "STRICT_SPREAD":
                    cands = [n for n in nodes if n not in used_nodes]
                elif strategy == "SPREAD":
                    cands = ([n for n in nodes if n not in used_nodes]
                             + used_nodes)
                else:  # PACK
                    cands = (used_nodes
                             + [n for n in nodes if n not in used_nodes])
                for node in cands:
                    if not node.alive or not fits(node, bundle):
                        continue
                    charge(node, bundle)
                    if node not in used_nodes:
                        used_nodes.append(node)
                    packed.append((bundle, node, []))
                    break
                else:
                    return None
            return packed

        plan: Dict[str, List[tuple]] = {}

        def accept(cand) -> bool:
            p = try_pack(cand)
            if p is None:
                return False
            plan["packed"] = p
            return True

        # STRICT_PACK is one node, so the box must fit one host's block
        sub = topo.allocate(total,
                            max_hosts=1 if strategy == "STRICT_PACK" else None,
                            accept=accept)
        if sub is None:
            return None      # the slice is full or fragmented: stay pending
        out: List[tuple] = []
        for bundle, node, taken in plan["packed"]:
            bundle.tpu_chips = taken or None
            out.append((bundle, node))
        pg.subslice = sub
        return out


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def placement_group(bundles: List[Dict[str, float]],
                    strategy: str = "PACK",
                    name: str = "") -> PlacementGroup:
    """Create a placement group (async; use ``.ready()`` / ``.wait()``)."""
    from ray_tpu_torch._private import worker
    from ray_tpu_torch._private.export_events import emit_export
    pg = worker.global_worker().pg_manager.create(bundles, strategy, name)
    emit_export("PLACEMENT_GROUP", pg_id=pg.id.hex(), state="CREATED",
                strategy=strategy, bundles=bundles)
    return pg


def remove_placement_group(pg: PlacementGroup) -> None:
    from ray_tpu_torch._private import worker
    from ray_tpu_torch._private.export_events import emit_export
    worker.global_worker().pg_manager.remove(pg)
    emit_export("PLACEMENT_GROUP", pg_id=pg.id.hex(), state="REMOVED")


def placement_group_table() -> Dict[str, Dict]:
    from ray_tpu_torch._private import worker
    return worker.global_worker().pg_manager.table()


def get_current_placement_group() -> Optional[PlacementGroup]:
    from ray_tpu_torch._private import runtime_context, worker
    rt = worker.global_worker()
    ctx = runtime_context._ctx.get()
    pg_id = ctx.placement_group_id if ctx else None
    return rt.pg_manager.get(pg_id) if pg_id else None
