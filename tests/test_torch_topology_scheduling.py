"""Topology-aware gang scheduling on the port: placement groups claim
contiguous sub-slices of a declared ``tpu_topology``.

JAX's nine tests (``tests/test_topology_scheduling.py``) run on
``ray_tpu_torch``, with ``GPU`` (the port's chip resource) where JAX writes
``TPU``; then one group script runs on both packages and each bundle's
sub-slice, claimed chips and torus host are compared (host indices, not
node ids, which are random).
"""

import importlib

import pytest

import ray_tpu_torch
from ray_tpu_torch.util.placement_group import (placement_group,
                                                placement_group_table,
                                                remove_placement_group)


@pytest.fixture
def tpu_cluster():
    """4 virtual hosts of a v5p 2x2x4 slice (16 chips, 4 chips/host)."""
    rt = ray_tpu_torch.init(
        num_nodes=4, resources={"CPU": 4, "GPU": 4},
        _system_config={"tpu_topology": "v5p:2x2x4"})
    yield rt
    ray_tpu_torch.shutdown()


def _entry(pg):
    return placement_group_table()[pg.id.hex()]


def _is_contiguous_box(chips):
    """The claimed chip coords form exactly one axis-aligned box."""
    lo = tuple(min(c[i] for c in chips) for i in range(len(chips[0])))
    hi = tuple(max(c[i] for c in chips) for i in range(len(chips[0])))
    volume = 1
    for a, b in zip(lo, hi):
        volume *= (b - a + 1)
    return volume == len(chips) and len(set(chips)) == len(chips)


def test_pg_claims_contiguous_subslice(tpu_cluster):
    pg = placement_group([{"GPU": 4}, {"GPU": 4}], strategy="PACK")
    assert pg.wait(10)
    e = _entry(pg)
    assert "subslice" in e, e
    all_chips = [tuple(c) for chips in e["bundle_chips"] for c in chips]
    assert len(all_chips) == 8
    assert _is_contiguous_box(all_chips)
    # 8 chips at 4/host -> exactly two distinct hosts/nodes
    assert len(set(e["bundle_nodes"])) == 2
    remove_placement_group(pg)
    assert tpu_cluster.tpu_topology.topology._allocated == []


def test_strict_pack_stays_inside_one_host_block(tpu_cluster):
    pg = placement_group([{"GPU": 2}, {"GPU": 2}], strategy="STRICT_PACK")
    assert pg.wait(10)
    e = _entry(pg)
    nodes = e["bundle_nodes"]
    assert len(set(nodes)) == 1          # one node...
    topo = tpu_cluster.tpu_topology.topology
    hosts = topo.hosts_of_subslice(pg.subslice)
    assert len(hosts) == 1               # ...backed by one torus host block
    remove_placement_group(pg)


def test_strict_spread_uses_distinct_hosts(tpu_cluster):
    pg = placement_group([{"GPU": 2}] * 3, strategy="STRICT_SPREAD")
    assert pg.wait(10)
    e = _entry(pg)
    assert len(set(e["bundle_nodes"])) == 3


def test_spread_prefers_distinct_hosts(tpu_cluster):
    """SPREAD must not collapse onto one host just because the cube-like
    box fits a single host block (fault isolation is the point)."""
    pg = placement_group([{"GPU": 2}, {"GPU": 2}], strategy="SPREAD")
    assert pg.wait(10)
    assert len(set(_entry(pg)["bundle_nodes"])) == 2
    remove_placement_group(pg)


def test_mixed_cpu_bundle_not_forced_onto_subslice_hosts():
    """A chip-less bundle in a chip group places by generic semantics:
    a big CPU bundle lands on the fat CPU node, not a 4-CPU chip host."""
    rt = ray_tpu_torch.init(
        num_nodes=1, resources={"CPU": 4, "GPU": 4},
        _system_config={"tpu_topology": "v5e:2x2"})
    try:
        cpu_node = rt.add_node({"CPU": 64})
        pg = placement_group([{"GPU": 4}, {"CPU": 16}], strategy="PACK")
        assert pg.wait(10)
        e = _entry(pg)
        assert e["bundle_nodes"][1] == cpu_node.node_id.hex()
        assert e["bundle_chips"][0] is not None
        assert e["bundle_chips"][1] is None
    finally:
        ray_tpu_torch.shutdown()


def test_fragmentation_blocks_then_release_unblocks(tpu_cluster):
    """A full slice leaves a later group pending; freeing a sub-slice
    lets it place (the allocator is consulted, not just chip counts)."""
    pg_a = placement_group([{"GPU": 4}, {"GPU": 4}], strategy="PACK")
    pg_b = placement_group([{"GPU": 4}, {"GPU": 4}], strategy="PACK")
    assert pg_a.wait(10) and pg_b.wait(10)

    pg_c = placement_group([{"GPU": 4}], strategy="PACK")
    assert not pg_c.wait(1.5)            # 16/16 chips claimed
    assert pg_c.state in ("PENDING", "RESCHEDULING")

    remove_placement_group(pg_a)
    assert pg_c.wait(10)
    chips = [tuple(c) for c in _entry(pg_c)["bundle_chips"][0]]
    assert _is_contiguous_box(chips)
    remove_placement_group(pg_b)
    remove_placement_group(pg_c)


def test_oversized_bundle_rejected_up_front(tpu_cluster):
    with pytest.raises(ValueError, match="split it across bundles"):
        placement_group([{"GPU": 8}])
    with pytest.raises(ValueError, match="fractional"):
        placement_group([{"GPU": 0.5}])


def test_node_death_frees_and_replaces_subslice(tpu_cluster):
    rt = tpu_cluster
    pg = placement_group([{"GPU": 4}, {"GPU": 4}], strategy="SPREAD")
    assert pg.wait(10)
    first_slice = pg.subslice
    victim = pg.bundles[0].node_id
    rt.remove_node(rt.get_node(victim))
    assert pg.wait(15)                   # re-placed on surviving hosts
    e = _entry(pg)
    assert victim.hex() not in e["bundle_nodes"]
    all_chips = [tuple(c) for chips in e["bundle_chips"] for c in chips]
    assert _is_contiguous_box(all_chips)
    # the first claim was released: allocator holds exactly one slice
    assert len(rt.tpu_topology.topology._allocated) == 1
    assert rt.tpu_topology.topology._allocated[0] is not first_slice


def test_tasks_schedule_into_topology_bundles(tpu_cluster):
    """PG-scheduled work runs on the bundle's sub-slice node (the scoped
    resource rewrite rides the existing ledger machinery)."""
    pg = placement_group([{"CPU": 1, "GPU": 4}], strategy="PACK")
    assert pg.wait(10)

    @ray_tpu_torch.remote(num_cpus=1)
    def where():
        import ray_tpu_torch
        return ray_tpu_torch.get_runtime_context().get_node_id()

    strat = ray_tpu_torch.PlacementGroupSchedulingStrategy(
        placement_group=pg, placement_group_bundle_index=0)
    node_hex = ray_tpu_torch.get(
        where.options(scheduling_strategy=strat).remote(), timeout=30)
    assert node_hex == pg.bundles[0].node_id.hex()
    remove_placement_group(pg)


# -- one group script on both packages ---------------------------------------

# ("create", bundles with "CHIP" for the package's chip key, strategy),
# ("remove", i) the script's i-th group, ("kill", i) the node under the
# i-th group's first bundle; each with the groups that must then be
# pending, every other live group placed. At most one group waits to be
# placed at a time, so no placement races the next step.
SCRIPT = [
    ("create", [{"CHIP": 4}, {"CHIP": 4}], "PACK", ()),
    ("create", [{"CHIP": 2}, {"CHIP": 2}], "SPREAD", ()),
    ("create", [{"CHIP": 2}, {"CHIP": 2, "CPU": 1}], "STRICT_PACK", (2,)),
    ("remove", 0, ()),
    ("create", [{"CHIP": 1}, {"CPU": 2}], "PACK", ()),
    ("create", [{"CHIP": 2}, {"CHIP": 2}], "STRICT_SPREAD", ()),
    ("kill", 1, (4,)),
    ("remove", 2, ()),
    ("create", [{"CHIP": 4}], "PACK", (5,)),
    ("remove", 3, (5,)),
    ("remove", 4, ()),
]


def _run_script(pkg: str, chip: str):
    """The script on ``pkg`` over a v5p 2x2x4 slice of four 4-chip hosts:
    after each step, each live group's state and, bundle by bundle, its
    sub-slice origin and shape, claimed chips and torus host; at the end,
    the allocator's boxes."""
    api = importlib.import_module(pkg)
    pgm = importlib.import_module(f"{pkg}.util.placement_group")
    rt = api.init(num_nodes=4, resources={"CPU": 4, chip: 4},
                  _system_config={"tpu_topology": "v5p:2x2x4"})
    try:
        mgr = rt.tpu_topology
        groups, out = [], []

        def host_of(node_id):
            hosts = [h for h in range(mgr.topology.num_hosts)
                     if node_id is not None
                     and mgr.node_of_host(h) == node_id]
            return hosts[0] if hosts else None

        def snapshot(pg):
            sub = pg.subslice
            if sub is None:
                return pg.state
            return [(tuple(sub.origin), tuple(sub.shape),
                     [tuple(c) for c in b.tpu_chips or []],
                     host_of(b.node_id)) for b in pg.bundles]

        for step in SCRIPT:
            if step[0] == "create":
                _, bundles, strategy, pending = step
                groups.append(pgm.placement_group(
                    [{(chip if k == "CHIP" else k): v for k, v in b.items()}
                     for b in bundles], strategy))
            else:
                verb, i, pending = step
                pg = groups[i]
                if verb == "remove":
                    pgm.remove_placement_group(pg)
                else:
                    out.append(("killed host", host_of(pg.bundles[0].node_id)))
                    rt.remove_node(rt.get_node(pg.bundles[0].node_id))
            live = [g for g in groups if g.state != "REMOVED"]
            for g in live:
                if groups.index(g) not in pending:
                    assert g.wait(10), (step, g)
            for i in pending:
                assert not groups[i].wait(1.0), (step, groups[i])
            out.append((step[:2], [snapshot(g) for g in live]))
        out.append(sorted((tuple(s.origin), tuple(s.shape))
                          for s in mgr.topology._allocated))
        return out
    finally:
        api.shutdown()


def test_group_script_places_as_jax():
    """Bundle by bundle, the port claims JAX's sub-slices, chips and hosts,
    through removals, pending groups and a node's death."""
    port = _run_script("ray_tpu_torch", "GPU")
    assert port == _run_script("ray_tpu", "TPU")
