"""Node death on the port's in-process runtime: lineage reconstruction,
task retry and actor restart (copies of the six node-death tests of
``tests/test_fault_tolerance.py``, the two dead-node affinity tests of
``tests/test_scheduling.py`` and the two node-death tests of
``tests/test_placement_group.py``, against ``ray_tpu_torch``).

``Runtime.remove_node`` is the same death flow a SIGKILLed daemon reaches
through the head (``tests/test_torch_cluster_daemons.py``).
"""

import time

import pytest

import ray_tpu_torch as rt_api
from ray_tpu_torch import exceptions as exc
from ray_tpu_torch._private.scheduler import SchedulingError
from ray_tpu_torch.util.placement_group import placement_group


@pytest.fixture
def cluster():
    """A 4-node virtual cluster (JAX's ``ray_start_cluster``)."""
    rt = rt_api.init(num_nodes=4, resources={"CPU": 4})
    yield rt
    rt_api.shutdown()


@rt_api.remote
def where():
    return rt_api.get_runtime_context().get_node_id()


def _node_of(rt, ref):
    """The node whose store holds an object."""
    for node in rt.nodes():
        if node.store.contains(ref.id):
            return node
    return None


def test_object_lost_reconstruction(cluster):
    rt = cluster

    @rt_api.remote(max_retries=3)
    def big():
        import numpy as np
        return np.ones((1000, 1000))  # 8 MB -> a node store, not inline

    ref = big.remote()
    rt_api.get(ref)
    victim = _node_of(rt, ref)
    assert victim is not None
    rt.remove_node(victim)
    # the value was lost with the node: get() reconstructs it from lineage
    val = rt_api.get(ref, timeout=30)
    assert val.shape == (1000, 1000)
    assert rt.stats["objects_reconstructed"] >= 1


def test_put_object_lost_is_unrecoverable(cluster):
    rt = cluster
    import numpy as np
    big_val = np.ones((1000, 1000))
    ref = rt.put(big_val)  # a driver put: no lineage
    # put() values live in the owner memory store: they survive node death
    victim = rt.nodes()[0]
    rt.remove_node(victim)
    assert rt_api.get(ref).shape == (1000, 1000)


def test_chained_reconstruction(cluster):
    rt = cluster

    @rt_api.remote(max_retries=5)
    def step(x):
        import numpy as np
        return x + np.ones((600, 600))

    @rt_api.remote(max_retries=5)
    def base():
        import numpy as np
        return np.zeros((600, 600))

    a = base.remote()
    b = step.remote(a)
    c = step.remote(b)
    rt_api.get(c)
    # kill every node that holds any of the intermediate values
    for ref in (a, b, c):
        n = _node_of(rt, ref)
        if n is not None and n.alive:
            rt.remove_node(n)
    assert rt_api.get(c, timeout=60)[0][0] == 2.0


def test_task_retry_on_node_death(cluster):
    rt = cluster

    @rt_api.remote(max_retries=3)
    def slow():
        time.sleep(1.0)
        return "done"

    ref = slow.remote()
    time.sleep(0.2)
    # find the node running it and kill it mid-flight
    with rt._tasks_lock:
        inflight = [t for t in rt._tasks.values()
                    if t.spec.name.endswith("slow")]
    assert inflight
    node = rt.get_node(inflight[0].node_id)
    rt.remove_node(node)
    assert rt_api.get(ref, timeout=30) == "done"
    assert rt.stats["tasks_retried"] >= 1


def test_actor_restart_on_node_death(cluster):
    rt = cluster

    @rt_api.remote(max_restarts=2, max_task_retries=2)
    class Stateful:
        def __init__(self):
            self.n = 0

        def inc(self):
            self.n += 1
            return self.n

        def node(self):
            return rt_api.get_runtime_context().get_node_id()

    a = Stateful.remote()
    assert rt_api.get(a.inc.remote()) == 1
    node_hex = rt_api.get(a.node.remote())
    victim = rt.get_node(
        next(n.node_id for n in rt.nodes() if n.node_id.hex() == node_hex))
    rt.remove_node(victim)
    # the actor restarts on another node; its state resets (a new __init__)
    val = rt_api.get(a.inc.remote(), timeout=30)
    assert val == 1
    assert rt.stats["actor_restarts"] == 1


def test_actor_no_restart_when_limit_zero(cluster):
    rt = cluster

    @rt_api.remote(max_restarts=0)
    class Fragile:
        def node(self):
            return rt_api.get_runtime_context().get_node_id()

    a = Fragile.remote()
    node_hex = rt_api.get(a.node.remote())
    victim = next(n for n in rt.nodes() if n.node_id.hex() == node_hex)
    rt.remove_node(victim)
    with pytest.raises((exc.ActorDiedError, exc.ActorError)):
        rt_api.get(a.node.remote(), timeout=10)


# ---------------------------------------------------------------------------
# scheduling onto a dead node
# ---------------------------------------------------------------------------

def test_node_affinity_dead_node_fails(cluster):
    rt = cluster
    victim = rt.nodes()[3]
    rt.remove_node(victim)
    strat = rt_api.NodeAffinitySchedulingStrategy(
        node_id=victim.node_id.hex(), soft=False)
    with pytest.raises(SchedulingError):
        rt_api.get(where.options(scheduling_strategy=strat).remote(),
                   timeout=10)


def test_node_affinity_soft_falls_back(cluster):
    rt = cluster
    victim = rt.nodes()[3]
    victim_hex = victim.node_id.hex()
    rt.remove_node(victim)
    strat = rt_api.NodeAffinitySchedulingStrategy(node_id=victim_hex,
                                                  soft=True)
    got = rt_api.get(where.options(scheduling_strategy=strat).remote(),
                     timeout=10)
    assert got != victim_hex


# ---------------------------------------------------------------------------
# placement groups across a node's death
# ---------------------------------------------------------------------------

def test_pg_reschedules_after_node_death(cluster):
    rt = cluster
    pg = placement_group([{"CPU": 2}, {"CPU": 2}], strategy="STRICT_SPREAD")
    assert pg.wait(10)
    victim_id = pg.bundle_nodes()[0]
    victim = rt.get_node(victim_id)
    rt.remove_node(victim)
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline:
        if pg.is_ready() and all(
                n is not None and n != victim_id
                for n in pg.bundle_nodes()):
            break
        time.sleep(0.1)
    assert pg.is_ready()
    assert victim_id not in pg.bundle_nodes()


def test_pg_task_retry_after_node_death(cluster):
    """A retry of a group's task re-matches bundles (the scoped-resource
    regression)."""
    rt = cluster
    pg = placement_group([{"CPU": 2}], strategy="PACK")
    assert pg.wait(10)
    strat = rt_api.PlacementGroupSchedulingStrategy(placement_group=pg)

    @rt_api.remote(num_cpus=1, scheduling_strategy=strat, max_retries=3)
    def slow():
        time.sleep(1.0)
        return "ok"

    ref = slow.remote()
    time.sleep(0.3)
    victim = rt.get_node(pg.bundle_nodes()[0])
    rt.remove_node(victim)
    assert rt_api.get(ref, timeout=30) == "ok"
