"""Graceful node drain on the port (``ray_tpu_torch.drain_node``): copies of
the seven drain tests of ``tests/test_fault_tolerance.py``, of
``tests/test_review_regressions.py``'s pool-handback test and of the head's
drain tests in ``tests/test_failure_detection.py``, against
``ray_tpu_torch``; then a drain across daemons (an arena object pushed to
the survivor, no reconstruction) and the daemon's ``PreemptionWatcher``
(the notice file and SIGTERM each give one drain at the head).
"""

import json
import os
import signal
import time

import pytest

import ray_tpu_torch as rt_api
from ray_tpu_torch._private.gcs import ActorState
from ray_tpu_torch._private.ids import NodeID


@pytest.fixture
def cluster():
    """A 4-node virtual cluster (JAX's ``ray_start_cluster``)."""
    rt = rt_api.init(num_nodes=4, resources={"CPU": 4})
    yield rt
    rt_api.shutdown()


@pytest.fixture
def one_node():
    """JAX's ``ray_start_regular``."""
    rt = rt_api.init(num_nodes=1, resources={"CPU": 8})
    yield rt
    rt_api.shutdown()


def _node_of(rt, ref):
    for node in rt.nodes():
        if node.store.contains(ref.id):
            return node
    return None


def _wait_node_gone(rt, node_id, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if rt.get_node(node_id) is None:
            return True
        time.sleep(0.05)
    return False


def test_drain_migrates_objects_without_reconstruction(cluster):
    """A clean drain copies the node's primary object replicas off it
    before departure: the value survives with objects_reconstructed 0."""
    rt = cluster

    @rt_api.remote(max_retries=3)
    def big():
        import numpy as np
        return np.ones((1000, 1000))  # 8 MB -> a node store, not inline

    ref = big.remote()
    rt_api.get(ref)
    victim = _node_of(rt, ref)
    assert victim is not None
    assert rt_api.drain_node(victim.node_id.hex(), deadline_s=15,
                             reason="unit test")
    assert victim.draining
    assert _wait_node_gone(rt, victim.node_id)
    assert rt_api.get(ref, timeout=10).shape == (1000, 1000)
    assert rt.stats["objects_reconstructed"] == 0
    assert rt.stats["drain_objects_migrated"] >= 1
    assert rt.stats["drains_total"] == 1
    assert rt.stats["drain_escalations_total"] == 0


def test_drain_restarts_actors_elsewhere_pending_replayed(cluster):
    """A drained node's actors come back ALIVE on surviving nodes with
    their pending tasks replayed, even with max_restarts=0 and
    max_task_retries=0: a planned migration consumes no fault budget."""
    rt = cluster

    @rt_api.remote(max_restarts=0, max_task_retries=0)
    class Counter:
        def __init__(self):
            self.n = 0

        def inc(self):
            self.n += 1
            return self.n

        def node(self):
            return rt_api.get_runtime_context().get_node_id()

    a = Counter.remote()
    assert rt_api.get(a.inc.remote()) == 1
    victim_hex = rt_api.get(a.node.remote())
    victim = next(n for n in rt.nodes() if n.node_id.hex() == victim_hex)
    pending = [a.inc.remote() for _ in range(3)]
    assert rt_api.drain_node(victim_hex, deadline_s=15, reason="drill")
    assert rt_api.get(pending, timeout=30)
    assert _wait_node_gone(rt, victim.node_id)
    info = rt.gcs.get_actor_info(a._ray_actor_id)
    assert info.state == ActorState.ALIVE
    assert info.node_id != victim.node_id
    assert rt_api.get(a.node.remote(), timeout=10) != victim_hex
    assert info.num_restarts == 0      # a planned move: budget untouched
    assert rt.stats["drain_actors_migrated"] >= 1


def test_drain_resubmits_queued_tasks_without_retry(cluster):
    """Queued-but-unstarted tasks on the draining node reschedule onto
    other nodes without consuming a retry (max_retries=0 completes)."""
    rt = cluster

    @rt_api.remote(num_cpus=4, max_retries=0)
    def task(i):
        time.sleep(0.4)
        return i

    victim = rt.alive_nodes()[0]
    strat = rt_api.NodeAffinitySchedulingStrategy(victim.node_id.hex(),
                                                  soft=True)
    refs = [task.options(scheduling_strategy=strat).remote(i)
            for i in range(6)]
    time.sleep(0.2)     # the first task starts, the backlog builds
    assert rt_api.drain_node(victim.node_id.hex(), deadline_s=20,
                             reason="downscale")
    assert sorted(rt_api.get(refs, timeout=30)) == list(range(6))
    assert rt.stats["tasks_retried"] == 0
    assert _wait_node_gone(rt, victim.node_id)


def test_drain_deadline_escalates_to_node_death(cluster):
    """A drain whose deadline expires with work still running escalates
    into the node-death path: the task retries elsewhere and the
    escalation is counted."""
    rt = cluster

    @rt_api.remote(max_retries=3)
    def slow():
        time.sleep(2.0)
        return "done"

    ref = slow.remote()
    time.sleep(0.3)
    with rt._tasks_lock:
        inflight = [t for t in rt._tasks.values()
                    if t.spec.name.endswith("slow")]
    assert inflight
    victim = rt.get_node(inflight[0].node_id)
    assert rt_api.drain_node(victim.node_id.hex(), deadline_s=0.3,
                             reason="spot reclaim")
    assert rt_api.get(ref, timeout=30) == "done"
    assert rt.stats["drain_escalations_total"] >= 1
    assert rt.stats["tasks_retried"] >= 1
    assert _wait_node_gone(rt, victim.node_id)


def test_drain_under_combined_load_integration(cluster):
    """A node under task and actor load is drained: in-flight work
    completes or resubmits, its actors come back ALIVE elsewhere with
    pending tasks replayed, objects migrate and none is reconstructed."""
    rt = cluster

    @rt_api.remote(max_retries=3)
    def produce(i):
        import numpy as np
        return np.full((600, 600), i)

    @rt_api.remote(max_retries=3)
    def chew(x):
        time.sleep(0.2)
        return float(x[0][0])

    @rt_api.remote(max_restarts=0, max_task_retries=0)
    class Stateful:
        def __init__(self):
            self.seen = 0

        def hit(self):
            self.seen += 1
            time.sleep(0.05)
            return self.seen

        def node(self):
            return rt_api.get_runtime_context().get_node_id()

    blobs = [produce.remote(i) for i in range(8)]
    rt_api.get(blobs)
    actors = [Stateful.remote() for _ in range(4)]
    for a in actors:
        rt_api.get(a.hit.remote())
    victim = _node_of(rt, blobs[0]) or rt.alive_nodes()[0]
    victim_hex = victim.node_id.hex()
    on_victim = [a for a in actors
                 if rt_api.get(a.node.remote()) == victim_hex]

    downstream = [chew.remote(b) for b in blobs]
    actor_pending = [a.hit.remote() for a in actors for _ in range(2)]
    assert rt_api.drain_node(victim_hex, deadline_s=20,
                             reason="preemption notice")
    assert rt_api.get(downstream, timeout=40) == list(range(8))
    assert all(v >= 1 for v in rt_api.get(actor_pending, timeout=40))
    assert _wait_node_gone(rt, victim.node_id, timeout=30)
    for a in on_victim:
        info = rt.gcs.get_actor_info(a._ray_actor_id)
        assert info.state == ActorState.ALIVE
        assert rt_api.get(a.node.remote(), timeout=10) != victim_hex
    assert rt_api.get(blobs, timeout=20)[3][0][0] == 3
    assert rt.stats["objects_reconstructed"] == 0
    assert rt.stats["drain_objects_migrated"] > 0
    assert rt.stats["drain_escalations_total"] == 0


def test_drained_node_leaves_with_its_actors_alive_elsewhere(cluster,
                                                             tmp_path):
    """C27: an actor whose new worker takes 1.5 s to come up (a loaded
    host's process start) is ALIVE on another node by the time its drained
    node is gone; JAX's drain leaves at once, with the actor RESTARTING."""
    rt = cluster

    @rt_api.remote(max_restarts=0, max_task_retries=0)
    class Slow:
        def __init__(self, mark):
            if os.path.exists(mark):
                time.sleep(1.5)     # the incarnation after the move
            open(mark, "w").close()

        def node(self):
            return rt_api.get_runtime_context().get_node_id()

    actor = Slow.remote(str(tmp_path / "created"))
    victim_hex = rt_api.get(actor.node.remote(), timeout=30)
    victim = rt.get_node(NodeID.from_hex(victim_hex))
    assert rt_api.drain_node(victim_hex, deadline_s=20)
    assert _wait_node_gone(rt, victim.node_id, timeout=30)
    assert rt.gcs.get_actor_info(actor._ray_actor_id).state \
        == ActorState.ALIVE
    assert rt_api.get(actor.node.remote(), timeout=10) != victim_hex
    assert rt.stats["drain_escalations_total"] == 0


def test_drain_excluded_from_new_placements(cluster):
    """While DRAINING, the scheduler routes new tasks to other nodes."""
    rt = cluster
    victim = rt.alive_nodes()[0]
    victim.draining = True      # the flag only: no migration machinery
    try:
        @rt_api.remote
        def where():
            return rt_api.get_runtime_context().get_node_id()

        spots = rt_api.get([where.remote() for _ in range(12)], timeout=20)
        assert victim.node_id.hex() not in spots
    finally:
        victim.draining = False


def _bundle_beside_a_drain(pkg, marker):
    """A 2-CPU node and a 16-CPU node; a 6 s task pinned to the 16-CPU
    node, which then drains with a 30 s deadline; a PACK group of one CPU
    bundle. Returns (the bundle's node, the draining node)."""
    import importlib
    api = importlib.import_module(pkg)
    pg_mod = importlib.import_module(f"{pkg}.util.placement_group")
    rt = api.init(num_nodes=1, resources={"CPU": 2})
    try:
        big = rt.add_node({"CPU": 16})

        @api.remote
        def hold(path):
            open(path, "w").close()
            time.sleep(6)
            return 1

        ref = hold.options(scheduling_strategy=api.NodeAffinitySchedulingStrategy(
            big.node_id.hex(), soft=False)).remote(marker)
        deadline = time.monotonic() + 30
        while not os.path.exists(marker) and time.monotonic() < deadline:
            time.sleep(0.02)
        assert os.path.exists(marker), "the pinned task never started"
        assert api.drain_node(big.node_id.hex(), deadline_s=30)
        pg = pg_mod.placement_group([{"CPU": 1}], "PACK")
        assert pg.wait(10)
        placed = pg.bundle_nodes()[0]
        assert api.get(ref, timeout=30) == 1
        return placed, big.node_id
    finally:
        api.shutdown()


@pytest.mark.parametrize("pkg", ["ray_tpu", "ray_tpu_torch"])
def test_new_bundle_avoids_a_draining_node(pkg, tmp_path):
    """A placement group created while a node drains lands elsewhere, as
    JAX's ``_try_place`` does through ``schedulable_nodes``: the group's
    reservation would go down with the node at the end of its drain. The
    draining node has the most free capacity, so PACK's order alone would
    pick it."""
    placed, draining = _bundle_beside_a_drain(pkg, str(tmp_path / "started"))
    assert placed is not None and placed != draining


def test_drain_label_selector_never_widens(one_node):
    """A hard label selector is honored even when its only match is
    draining: the task runs on the draining matching node rather than
    leaking onto a non-matching one (or failing)."""
    rt = one_node
    labeled = rt.add_node({"CPU": 2}, labels={"accel": "gpu"})
    labeled.draining = True     # the flag only: no migration machinery
    try:
        from ray_tpu_torch.util.scheduling_strategies import (
            NodeLabelSchedulingStrategy)

        @rt_api.remote(scheduling_strategy=NodeLabelSchedulingStrategy(
            hard={"accel": "gpu"}))
        def where():
            return rt_api.get_runtime_context().get_node_id()

        assert rt_api.get(where.remote(),
                          timeout=15) == labeled.node_id.hex()
    finally:
        labeled.draining = False
        rt.remove_node(labeled)


def test_drain_steals_pool_pending_when_backlog_empty():
    """Ample ledger capacity admits every queued task straight into the
    exec pool's queue (the backlog is EMPTY); the drain must still steal
    the unstarted specs back without a retry, or they burn down serially
    on the tiny pool, the deadline escalates, and max_retries=0 tasks
    that never started fail."""
    rt = rt_api.init(num_nodes=2, resources={"CPU": 64},
                     _system_config={"exec_pool_size": 2})
    try:
        @rt_api.remote(max_retries=0)
        def slowish(i):
            time.sleep(0.4)
            return i

        refs = [slowish.remote(i) for i in range(40)]
        time.sleep(0.3)     # dispatch admits everything into the pools
        victim = rt_api.nodes()[0]["NodeID"]
        # a deadline far below the serial burn-down of the pool's queue
        # (20 specs x 0.4 s / 2 threads = 4 s)
        rt_api.drain_node(victim, deadline_s=3.0)
        assert rt_api.get(refs, timeout=120) == list(range(40))
        assert rt.stats["tasks_retried"] == 0
    finally:
        rt_api.shutdown()


# ---------------------------------------------------------------------------
# the head's drain state (copies of tests/test_failure_detection.py)
# ---------------------------------------------------------------------------

class _FakeConn:
    def __init__(self):
        self.meta = {}
        self.closed = False
        self.replies = []

    def reply(self, rid, **kw):
        self.replies.append((rid, kw))

    def link(self, peer_role, link_id=""):
        return self         # registration tags the chaos-link identity


def _register(svc, node_id="n1", port=7001):
    return svc.handle_register_node(_FakeConn(), 1, {
        "node_id": node_id, "resources": {"CPU": 4.0}, "labels": {},
        "addr": ["127.0.0.1", port]})


def test_head_drain_state_and_deadline_escalation():
    """drain_node moves the node to alive+DRAINING (publishing drain, not
    death); the health loop escalates into the death path once the
    deadline expires."""
    from ray_tpu_torch._private.head import HeadService

    svc = HeadService()
    try:
        assert _register(svc)["ok"]
        out = svc.handle_drain_node(_FakeConn(), 2, {
            "node_id": "n1", "deadline_s": 0.2, "reason": "preempt"})
        assert out["ok"]
        view = svc.handle_list_nodes(_FakeConn(), 3, {})["nodes"][0]
        assert view["alive"] and view["draining"]
        assert view["drain_reason"] == "preempt"
        events = svc._events.get("node", [])
        assert any(e.get("kind") == "drain" for e in events)
        assert not any(e.get("kind") == "death" for e in events)
        # the heartbeat keeps the node alive; only the deadline ends it
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            svc.handle_heartbeat(_FakeConn(), 4, {
                "node_id": "n1", "available": {"CPU": 4.0}, "epoch": 1})
            view = svc.handle_list_nodes(_FakeConn(), 5, {})["nodes"][0]
            if not view["alive"]:
                break
            time.sleep(0.05)
        assert not view["alive"]
        assert view["reason"] == "drain deadline expired"
        assert any(e.get("kind") == "death" and e.get("was_draining")
                   and e.get("drain_expired")
                   for e in svc._events["node"])
    finally:
        svc._stop.set()


def test_head_drain_survives_restart(tmp_path):
    """With a state path, a drain outlives a head restart: when the
    draining daemon re-registers at the fresh head, the DRAINING state
    (and its remaining deadline) re-attaches and is re-announced. The
    record is a row of the wire's encoding."""
    from ray_tpu_torch._private import rpc
    from ray_tpu_torch._private.head import _DRAIN_KEY, HeadService

    state = str(tmp_path / "head_state.db")
    svc = HeadService(state_path=state)
    try:
        _register(svc)
        svc.handle_drain_node(_FakeConn(), 2, {
            "node_id": "n1", "deadline_s": 60.0, "reason": "maint"})
        row = svc._store._db.execute(
            "SELECT value FROM kv WHERE key = ?",
            (_DRAIN_KEY + b"n1",)).fetchone()[0]
        assert rpc.loads_frame(row)["reason"] == "maint"
    finally:
        svc._stop.set()
    svc._store._db.close()

    svc2 = HeadService(state_path=state)    # the respawned head
    try:
        # membership is not persisted (daemons re-register themselves)
        assert svc2.handle_list_nodes(_FakeConn(), 1, {})["nodes"] == []
        out = _register(svc2)
        assert out["ok"] and out["draining"]
        view = svc2.handle_list_nodes(_FakeConn(), 2, {})["nodes"][0]
        assert view["draining"] and view["drain_reason"] == "maint"
        assert 0 < view["drain_deadline_s"] <= 60.0
        assert any(e.get("kind") == "drain"
                   for e in svc2._events.get("node", []))
    finally:
        svc2._stop.set()


# ---------------------------------------------------------------------------
# a drain across daemons
# ---------------------------------------------------------------------------

def test_daemon_drain_pushes_arena_object_to_the_survivor(monkeypatch):
    """An object in the drained daemon's arena is pushed daemon to
    daemon: after the node leaves, the driver's get reads it as a
    read-only view in the survivor's arena, and nothing was rebuilt from
    lineage. The head showed the node DRAINING and marked it dead at the
    clean finish."""
    import numpy as np
    for var in ("RAY_TPU_PROCESS_WORKERS", "RAY_TPU_FAST_LANE",
                "RAY_TPU_NATIVE_STORE", "RAY_TPU_CLUSTER"):
        monkeypatch.delenv(var, raising=False)
    rt = rt_api.init(num_nodes=2, resources={"CPU": 2}, cluster="daemons",
                     object_store_memory=64 << 20)
    try:
        handles = list(rt.cluster_backend.daemons.values())
        victim = handles[0].node_id
        survivor = handles[1]

        @rt_api.remote(max_retries=3)
        def make():
            import numpy as np
            return np.arange(1 << 20, dtype=np.float32)   # 4 MiB

        ref = make.options(
            scheduling_strategy=rt_api.NodeAffinitySchedulingStrategy(
                victim.hex(), soft=False)).remote()
        rt_api.wait([ref], timeout=30)
        assert rt.get_node(victim).store.contains(ref.id)
        assert rt_api.drain_node(victim.hex(), deadline_s=20,
                                 reason="unit test")
        views = {n["node_id"]: n
                 for n in rt.cluster_backend.head.list_nodes()}
        assert views[victim.hex()]["draining"]
        assert _wait_node_gone(rt, victim)
        views = {n["node_id"]: n
                 for n in rt.cluster_backend.head.list_nodes()}
        assert not views[victim.hex()]["alive"]
        assert views[victim.hex()]["reason"].startswith("drained")
        val = rt_api.get(ref, timeout=30)
        np.testing.assert_array_equal(
            val, np.arange(1 << 20, dtype=np.float32))
        assert not val.flags.writeable      # a view in the survivor's arena
        assert rt.stats["objects_reconstructed"] == 0
        assert rt.stats["drain_objects_migrated"] >= 1
        assert survivor.client.call("daemon_stats")["store_used"] >= 4 << 20
    finally:
        rt_api.shutdown()


# ---------------------------------------------------------------------------
# the daemon's preemption watcher
# ---------------------------------------------------------------------------

def test_preemption_watcher_notice_file_and_sigterm(tmp_path, monkeypatch):
    """A daemon whose notice file appears, and a daemon that gets
    SIGTERM, each announce exactly one drain at the head (with the file's
    content, or "sigterm", as the reason) and keep serving."""
    from ray_tpu_torch._private import daemon as _daemon_schemas  # noqa: F401
    from ray_tpu_torch._private import rpc
    from ray_tpu_torch._private.cluster import _spawn
    from ray_tpu_torch._private.head import HeadClient
    notice = tmp_path / "notice"
    monkeypatch.setenv("RAY_TPU_DRAIN_NOTICE_FILE", str(notice))
    monkeypatch.setenv("RAY_TPU_DRAIN_DEADLINE_S", "120")
    head_proc, port = _spawn("ray_tpu_torch._private.head", [])
    head = HeadClient(("127.0.0.1", port))
    daemons = []
    try:
        ids = [NodeID.from_random().hex() for _ in range(2)]
        for node_id in ids:
            proc, dport = _spawn("ray_tpu_torch._private.daemon", [
                "--head", f"127.0.0.1:{port}", "--node-id", node_id,
                "--resources", json.dumps({"CPU": 1}),
                "--object-store-bytes", str(16 << 20)])
            daemons.append((proc, dport))
        deadline = time.monotonic() + 20
        while (len([n for n in head.list_nodes() if n["alive"]]) < 2
               and time.monotonic() < deadline):
            time.sleep(0.05)

        def drains():
            out = head._client.call("subscribe", channel="node", cursor=0)
            return [e for e in out["events"] if e.get("kind") == "drain"]

        # one daemon reads the notice file (both watch the same path: the
        # second is given SIGTERM first, so it has announced already)
        os.kill(daemons[1][0].pid, signal.SIGTERM)
        while len(drains()) < 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        notice.write_text("maintenance window")
        while len(drains()) < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
        time.sleep(0.5)     # a second announce would land by now
        got = {e["node_id"]: e["reason"] for e in drains()}
        assert len(drains()) == 2
        assert got == {ids[0]: "maintenance window", ids[1]: "sigterm"}
        views = {n["node_id"]: n for n in head.list_nodes()}
        assert all(views[i]["alive"] and views[i]["draining"] for i in ids)
        assert daemons[1][0].poll() is None     # SIGTERM did not end it
    finally:
        for proc, dport in daemons:
            try:
                client = rpc.connect(("127.0.0.1", dport), timeout=5.0)
                client.call("daemon_stop", timeout=5.0)
                client.close()
            except (OSError, rpc.RpcError):
                proc.kill()
            try:
                proc.wait(timeout=10)
            except Exception:
                proc.kill()
        head.stop_head()
        head.close()
        head_proc.wait(timeout=10)
