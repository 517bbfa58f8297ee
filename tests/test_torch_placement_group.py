"""Placement groups on the port's runtime: the JAX package's placement-group
tests (``tests/test_placement_group.py``) on ``ray_tpu_torch``, and the
legacy ``placement_group`` options.

Left uncopied, with the node removal they need (ROADMAP A11c):
``test_pg_reschedules_after_node_death`` and
``test_pg_task_retry_after_node_death``.
"""

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.util import (placement_group, placement_group_table,
                                remove_placement_group)


@pytest.fixture
def ray_start_cluster():
    rt = ray_tpu_torch.init(num_nodes=4, resources={"CPU": 4})
    yield rt
    ray_tpu_torch.shutdown()


@ray_tpu_torch.remote
def where():
    return ray_tpu_torch.get_runtime_context().get_node_id()


def test_pg_create_ready(ray_start_cluster):
    pg = placement_group([{"CPU": 2}, {"CPU": 2}], strategy="PACK")
    assert pg.wait(10)
    assert pg.is_ready()
    assert all(n is not None for n in pg.bundle_nodes())


def test_pg_ready_ref(ray_start_cluster):
    pg = placement_group([{"CPU": 1}], strategy="PACK")
    got = ray_tpu_torch.get(pg.ready(), timeout=10)
    assert got.is_ready()


def test_strict_pack_same_node(ray_start_cluster):
    pg = placement_group([{"CPU": 1}, {"CPU": 1}, {"CPU": 1}],
                         strategy="STRICT_PACK")
    assert pg.wait(10)
    nodes = {n.hex() for n in pg.bundle_nodes()}
    assert len(nodes) == 1


def test_strict_spread_distinct_nodes(ray_start_cluster):
    pg = placement_group([{"CPU": 1}] * 4, strategy="STRICT_SPREAD")
    assert pg.wait(10)
    nodes = {n.hex() for n in pg.bundle_nodes()}
    assert len(nodes) == 4


def test_strict_spread_infeasible_pending(ray_start_cluster):
    # 5 bundles, only 4 nodes -> cannot place.
    pg = placement_group([{"CPU": 1}] * 5, strategy="STRICT_SPREAD")
    assert not pg.wait(1.0)
    assert pg.state in ("PENDING", "RESCHEDULING")


def test_task_into_pg_bundle(ray_start_cluster):
    pg = placement_group([{"CPU": 2}, {"CPU": 2}], strategy="STRICT_SPREAD")
    assert pg.wait(10)
    strat = ray_tpu_torch.PlacementGroupSchedulingStrategy(
        placement_group=pg, placement_group_bundle_index=1)
    got = ray_tpu_torch.get(where.options(
        scheduling_strategy=strat, num_cpus=1).remote())
    assert got == pg.bundle_nodes()[1].hex()


def test_pg_bundle_capacity_enforced(ray_start_cluster):
    pg = placement_group([{"CPU": 1}], strategy="PACK")
    assert pg.wait(10)
    strat = ray_tpu_torch.PlacementGroupSchedulingStrategy(placement_group=pg)

    @ray_tpu_torch.remote(num_cpus=1, scheduling_strategy=strat)
    def hold():
        time.sleep(0.4)
        return time.monotonic()

    t0 = time.monotonic()
    # Two 1-CPU tasks into a 1-CPU bundle -> must serialize.
    times = ray_tpu_torch.get([hold.remote(), hold.remote()])
    assert max(times) - t0 >= 0.75


def test_pg_task_demand_exceeding_bundle_fails(ray_start_cluster):
    pg = placement_group([{"CPU": 1}], strategy="PACK")
    assert pg.wait(10)
    strat = ray_tpu_torch.PlacementGroupSchedulingStrategy(placement_group=pg)
    with pytest.raises(Exception):
        ray_tpu_torch.get(where.options(scheduling_strategy=strat,
                                        num_cpus=4).remote(), timeout=10)


def test_actor_in_pg(ray_start_cluster):
    pg = placement_group([{"CPU": 2}], strategy="PACK")
    assert pg.wait(10)

    @ray_tpu_torch.remote(num_cpus=2, scheduling_strategy=(
        ray_tpu_torch.PlacementGroupSchedulingStrategy(
            placement_group=pg, placement_group_bundle_index=0)))
    class Pinned:
        def node(self):
            return ray_tpu_torch.get_runtime_context().get_node_id()

    a = Pinned.remote()
    assert ray_tpu_torch.get(a.node.remote()) == pg.bundle_nodes()[0].hex()


def test_remove_pg_frees_resources(ray_start_cluster):
    before = ray_tpu_torch.available_resources()["CPU"]
    pg = placement_group([{"CPU": 4}, {"CPU": 4}], strategy="SPREAD")
    assert pg.wait(10)
    during = ray_tpu_torch.available_resources()["CPU"]
    assert during == before - 8
    remove_placement_group(pg)
    time.sleep(0.2)
    after = ray_tpu_torch.available_resources()["CPU"]
    assert after == before


def test_pg_table(ray_start_cluster):
    pg = placement_group([{"CPU": 1}], strategy="PACK", name="mypg")
    pg.wait(10)
    table = placement_group_table()
    assert pg.id.hex() in table
    assert table[pg.id.hex()]["name"] == "mypg"
    assert table[pg.id.hex()]["state"] == "CREATED"


def test_pending_pg_places_when_resources_free(ray_start_cluster):
    # Fill the cluster, create a PG that can't fit, then free resources.
    @ray_tpu_torch.remote(num_cpus=4)
    def hog():
        time.sleep(1.0)

    hogs = [hog.remote() for _ in range(4)]  # consumes all 16 CPUs
    time.sleep(0.2)
    pg = placement_group([{"CPU": 4}], strategy="PACK")
    assert not pg.wait(0.3)  # can't place yet
    ray_tpu_torch.get(hogs)
    assert pg.wait(10)


def test_capture_child_tasks(ray_start_cluster):
    pg = placement_group([{"CPU": 3}], strategy="PACK")
    assert pg.wait(10)
    strat = ray_tpu_torch.PlacementGroupSchedulingStrategy(
        placement_group=pg, placement_group_capture_child_tasks=True)

    @ray_tpu_torch.remote(num_cpus=1)
    def child():
        return ray_tpu_torch.get_runtime_context().get_node_id()

    @ray_tpu_torch.remote(num_cpus=1, scheduling_strategy=strat)
    def parent():
        from ray_tpu_torch.util.placement_group import \
            get_current_placement_group
        me = ray_tpu_torch.get_runtime_context().get_node_id()
        kid = ray_tpu_torch.get(child.remote())
        return me, kid, get_current_placement_group() is not None

    me, kid, has_pg = ray_tpu_torch.get(parent.remote())
    assert me == kid  # child captured into the same bundle's node
    assert has_pg


def test_bundle_index_out_of_range(ray_start_cluster):
    pg = placement_group([{"CPU": 1}], strategy="PACK")
    assert pg.wait(10)
    strat = ray_tpu_torch.PlacementGroupSchedulingStrategy(
        placement_group=pg, placement_group_bundle_index=5)
    with pytest.raises(ValueError):
        ray_tpu_torch.get(where.options(scheduling_strategy=strat).remote(),
                          timeout=10)


# ---------------------------------------------------------------------------
# the port's own
# ---------------------------------------------------------------------------

def test_legacy_placement_group_options_name_the_group(ray_start_cluster):
    """``placement_group=`` and ``placement_group_bundle_index=`` place the
    task in that bundle (the reference's legacy options; JAX's package
    accepts them and drops them), with its runtime env around the body."""
    pg = placement_group([{"CPU": 1}, {"CPU": 1}], strategy="STRICT_SPREAD")
    assert pg.wait(10)
    for i in (0, 1):
        got = ray_tpu_torch.get(where.options(
            placement_group=pg, placement_group_bundle_index=i,
            num_cpus=1).remote(), timeout=10)
        assert got == pg.bundle_nodes()[i].hex()

    @ray_tpu_torch.remote
    def flag_and_node():
        import os
        return (os.environ.get("PG_FLAG"),
                ray_tpu_torch.get_runtime_context().get_node_id())

    flag, node = ray_tpu_torch.get(flag_and_node.options(
        placement_group=pg, placement_group_bundle_index=1, num_cpus=1,
        runtime_env={"env_vars": {"PG_FLAG": "on"}}).remote(), timeout=10)
    assert (flag, node) == ("on", pg.bundle_nodes()[1].hex())


def test_bundle_holding_gpu_keeps_other_tasks_off_the_card():
    """A ``GPU`` bundle holds the card: a ``num_gpus=1`` task outside the
    group stays pending until the group is removed, and the removed bundle's
    scoped names leave the node's resources."""
    ray_tpu_torch.init(num_nodes=1, resources={"CPU": 4, "GPU": 1})
    try:
        pg = placement_group([{"CPU": 1, "GPU": 1}])
        assert pg.wait(10)

        @ray_tpu_torch.remote(num_gpus=1)
        def on_card():
            return "ran"

        ref = on_card.remote()
        ready, _ = ray_tpu_torch.wait([ref], timeout=0.5)
        assert not ready
        remove_placement_group(pg)
        assert ray_tpu_torch.get(ref, timeout=10) == "ran"
        assert set(ray_tpu_torch.cluster_resources()) == {"CPU", "GPU"}
    finally:
        ray_tpu_torch.shutdown()


def test_placement_thread_ends_with_its_runtime():
    rt = ray_tpu_torch.init(num_nodes=1, resources={"CPU": 2})
    thread = rt.pg_manager._thread
    pg = placement_group([{"CPU": 8}])        # never placeable
    ray_tpu_torch.shutdown()
    assert pg.wait(1.0) is False
    thread.join(timeout=5)
    assert not thread.is_alive()
