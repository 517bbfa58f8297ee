"""The port's autoscalers (copies of ``tests/test_ops_shell.py``'s three
autoscaler tests and ``tests/test_cluster_daemons.py``'s
``test_autoscaler_provisions_real_daemon_process`` against
``ray_tpu_torch``, and the node-type choice held to JAX's).

v1 (``autoscaler.py``): ``StandardAutoscaler`` over a fake provider that
adds runtime nodes. v2 (``autoscaler_v2.py``): the ``Reconciler`` walks
each instance through its state machine; ``ProcessHostProvider`` spawns a
real node daemon that registers at the head and joins the driver.
"""

import itertools
import time

import pytest

import ray_tpu_torch as rt_api


@pytest.fixture
def ray_start_regular():
    if rt_api.is_initialized():
        pytest.fail("a runtime is already up")
    rt = rt_api.init(num_nodes=1, resources={"CPU": 8})
    yield rt
    rt_api.shutdown()


def test_autoscaler_scales_up_and_down(ray_start_regular):
    from ray_tpu_torch.autoscaler import FakeNodeProvider, StandardAutoscaler

    rt = ray_start_regular
    provider = FakeNodeProvider(rt, {"CPU": 4})
    scaler = StandardAutoscaler(rt, provider, min_nodes=1, max_nodes=4,
                                idle_timeout_s=0.5)

    # more parallel work than one 8-CPU node can run
    @rt_api.remote(num_cpus=4)
    def slow():
        time.sleep(1.5)
        return 1

    refs = [slow.remote() for _ in range(6)]  # 24 CPUs of demand
    time.sleep(0.2)
    scaler.update()
    assert scaler.stats["launched"] >= 1
    scaler.update()
    assert scaler.stats["launched"] >= 2
    assert rt_api.get(refs, timeout=60) == [1] * 6
    # idle: scale back down
    deadline = time.time() + 15
    while time.time() < deadline and provider.non_terminated_nodes():
        scaler.update()
        time.sleep(0.3)
    assert not provider.non_terminated_nodes()


def test_autoscaler_v2_scales_up_for_tpu_demand(ray_start_regular):
    """A pending group that asks for 4 TPU drives the reconciler to the
    smallest covering node type, with the state machine recorded; removing
    the group drains and ends the instance."""
    from ray_tpu_torch.autoscaler_v2 import (InstanceStatus, Reconciler,
                                             RuntimeBackedTpuProvider)
    from ray_tpu_torch.util.placement_group import (placement_group,
                                                    remove_placement_group)

    rt = ray_start_regular
    rec = Reconciler(rt, RuntimeBackedTpuProvider(rt), idle_timeout_s=0.2)

    pg = placement_group([{"TPU": 4}], strategy="PACK")  # unschedulable now
    assert not pg.wait(0.5)
    for _ in range(4):
        rec.reconcile()
    assert pg.wait(10), "slice node never provisioned"
    running = rec.instance_manager.list(InstanceStatus.RAY_RUNNING)
    assert len(running) == 1
    assert running[0].node_type == "v5e-4"  # smallest covering type
    assert "QUEUED->REQUESTED" in running[0].history[0]

    remove_placement_group(pg)
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline:
        rec.reconcile()
        if rec.instance_manager.list(InstanceStatus.TERMINATED):
            break
        time.sleep(0.1)
    assert len(rec.instance_manager.list(InstanceStatus.TERMINATED)) == 1
    assert rec.stats["terminated"] == 1


def test_autoscaler_v2_gke_provider_is_explicit_stub():
    from ray_tpu_torch.autoscaler_v2 import GkeTpuProvider

    provider = GkeTpuProvider(project="p", zone="z", cluster="c")
    with pytest.raises(NotImplementedError, match="zero-egress|GKE|API"):
        provider.launch("v5e-4")


def test_pick_node_type_matches_jax():
    """The node type chosen for each unmet demand on a grid equals JAX's
    (the catalog is JAX's data)."""
    from ray_tpu import autoscaler_v2 as jax_v2

    from ray_tpu_torch import autoscaler_v2 as port_v2

    assert port_v2.TPU_SLICE_TYPES == jax_v2.TPU_SLICE_TYPES
    jax_rec = jax_v2.Reconciler(None, jax_v2.GkeTpuProvider())
    port_rec = port_v2.Reconciler(None, port_v2.GkeTpuProvider())
    sizes = (0.0, 1.0, 4.0, 8.0, 12.0, 16.0, 32.0, 64.0, 65.0)
    picked = set()
    for tpu, cpu in itertools.product(sizes, sizes):
        unmet = {k: v for k, v in (("TPU", tpu), ("CPU", cpu)) if v}
        for chunk in ({}, dict(unmet), {k: v / 2 for k, v in unmet.items()}):
            want = jax_rec._pick_node_type(unmet, chunk)
            assert port_rec._pick_node_type(unmet, chunk) == want, (
                unmet, chunk)
            picked.add(want)
    assert {"cpu-host", "v5e-4", "v5p-16", None} <= picked


def test_autoscaler_provisions_real_daemon_process():
    """ProcessHostProvider end to end: unmet demand drives the reconciler
    to spawn a real node daemon, which registers at the head and becomes
    schedulable; a task lands there; idle, the node is drained and its
    process ends."""
    import os

    from ray_tpu_torch.autoscaler_v2 import (InstanceStatus,
                                             ProcessHostProvider, Reconciler)
    from ray_tpu_torch.util.placement_group import (placement_group,
                                                    remove_placement_group)

    if rt_api.is_initialized():
        pytest.fail("a runtime is already up")
    rt = rt_api.init(num_nodes=2, resources={"CPU": 4}, cluster="daemons",
                     object_store_memory=128 << 20)
    try:
        before = {n.node_id for n in rt.alive_nodes()}
        provider = ProcessHostProvider(rt)
        rec = Reconciler(rt, provider, idle_timeout_s=0.5)

        # two daemons of CPU 4: a CPU 16 bundle needs a cpu-host
        pg = placement_group([{"CPU": 16}], strategy="PACK")
        assert not pg.wait(0.5)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            rec.reconcile()
            if pg.wait(0.5):
                break
        assert pg.wait(5), "real daemon never provisioned"
        rec.reconcile()   # ALLOCATED -> RAY_RUNNING once joined
        new_nodes = {n.node_id for n in rt.alive_nodes()} - before
        assert len(new_nodes) == 1
        running = rec.instance_manager.list(InstanceStatus.RAY_RUNNING)
        assert running and running[0].node_type == "cpu-host"
        pid = next(iter(provider._launched.values()))["pid"]

        @rt_api.remote(num_cpus=9)   # only fits the new CPU 16 host
        def where():
            return rt_api.get_runtime_context().get_node_id()

        remove_placement_group(pg)
        assert rt_api.get(where.remote(), timeout=60) == \
            next(iter(new_nodes)).hex()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            rec.reconcile()
            if rec.instance_manager.list(InstanceStatus.TERMINATED):
                break
            time.sleep(0.2)
        assert rec.instance_manager.list(InstanceStatus.TERMINATED)
        assert not os.path.exists(f"/proc/{pid}") or _zombie(pid)
    finally:
        rt_api.shutdown()


def _zombie(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except OSError:
        return True
