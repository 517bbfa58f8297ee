"""The port's chaos tier (copies of ``tests/test_chaos.py``): seeded
failpoint and network-chaos schedules replayed across topologies.

Run with ``pytest -m chaos``. Every test here is also marked slow, as
JAX's are, so the tier-1 sweep (``-m 'not slow'``) never pays for cluster
boots and fault windows.

Each schedule is deterministic for a given seed: probabilistic arms draw
from the registry's seeded RNG, hit-count arms count per seam, and every
assertion on fault counts reads the registry's thread-safe hit log, never
timing heuristics.
"""

import os
import threading
import time

import pytest

import ray_tpu_torch as ray_tpu
from ray_tpu_torch import exceptions as exc
from ray_tpu_torch._private import failpoints as fp
from ray_tpu_torch._private import rpc
from ray_tpu_torch._private.retry import RetryPolicy

pytestmark = [pytest.mark.chaos, pytest.mark.slow]

SEEDS = [101, 202, 303]


@pytest.fixture(autouse=True)
def _reset_failpoints():
    yield
    fp.reset()
    if ray_tpu.is_initialized():
        ray_tpu.shutdown()


@pytest.fixture
def ray_start_regular():
    rt = ray_tpu.init(num_nodes=1, resources={"CPU": 8})
    yield rt
    ray_tpu.shutdown()


# ---------------------------------------------------------------------------
# in-process topology: strict exact-count replays
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_chaos_every_nth_rpc_drop_converges(seed):
    """Every-Nth-request drop on a live RPC server: every call converges
    under RetryPolicy and the drop count is exact (no background
    traffic shares this in-process server)."""

    class Svc:
        def __init__(self):
            self.served = 0

        def handle_bump(self, conn, rid, msg):
            self.served += 1
            return {"n": self.served}

    rpc.declare("bump", "k")
    svc = Svc()
    server = rpc.Server(svc).start()
    client = rpc.Client(server.addr, timeout=0.25)
    fp.activate("rpc.server.recv=drop:every=3", seed=seed)
    policy = RetryPolicy(max_attempts=6, base_s=0.005,
                         max_backoff_s=0.02)
    try:
        for k in range(12):
            policy.run(lambda: client.call("bump", k=k),
                       loop="chaos.rpc_drop", retry_on=(rpc.RpcError,))
        # 12 successes with every 3rd arrival dropped: the 12th success
        # lands on arrival 17 (drops at 3,6,9,12,15) => 17 hits, 5 drops
        assert svc.served == 12
        assert fp.fire_count("rpc.server.recv") == 5
        assert fp.hit_count("rpc.server.recv") == 17
        drops = fp.hit_log("rpc.server.recv")
        assert [e["fire"] for e in drops] == list(range(1, 6))
        assert all(e["method"] == "bump" for e in drops)
    finally:
        client.close()
        server.stop()


@pytest.mark.parametrize("seed", SEEDS)
def test_chaos_probabilistic_drop_is_seed_deterministic(seed):
    """The same seed replays the same probabilistic fault schedule —
    run the identical workload twice and compare the hit logs."""

    def run_once():
        fp.activate("chaos.coin=drop:p=0.5", seed=seed)
        outcomes = [fp.fire("chaos.coin") is fp.DROP for _ in range(40)]
        fired = fp.fire_count("chaos.coin")
        return outcomes, fired

    first, fired1 = run_once()
    second, fired2 = run_once()
    assert first == second and fired1 == fired2
    assert 0 < fired1 < 40


def test_chaos_stream_error_mid_generator(ray_start_regular):
    """A failpoint killing the stream after 2 items surfaces as a typed
    error on the consumer, never a hang or a silent truncation."""
    fp.activate("worker.generator_stream=error():after=2")

    @ray_tpu.remote(max_retries=0)
    def gen():
        yield from range(5)

    it = gen.remote()
    assert ray_tpu.get(next(it)) == 0
    assert ray_tpu.get(next(it)) == 1
    with pytest.raises(Exception):
        for _ in range(3):
            ray_tpu.get(next(it))
    assert fp.fire_count("worker.generator_stream") == 1


# ---------------------------------------------------------------------------
# daemons topology: whole-cluster seeded schedules
# ---------------------------------------------------------------------------

@pytest.fixture
def daemon_cluster():
    rt = ray_tpu.init(num_nodes=2, resources={"CPU": 4},
                      cluster="daemons")
    yield rt
    ray_tpu.shutdown()


@pytest.mark.parametrize("seed", SEEDS)
def test_chaos_seeded_schedule_daemons(seed, daemon_cluster):
    """The acceptance schedule: every-Nth lane-submit fault + one head
    kill mid-KV-traffic + retried tasks — converges to success for
    every seed, with exact fault counts from the registry log and
    retry counters visible in the Prometheus registry."""
    rt = daemon_cluster
    fp.activate("fast_lane.submit=error(OSError):every=3:max=5",
                seed=seed)

    @ray_tpu.remote
    def f(x):
        return x * 3

    out = ray_tpu.get([f.remote(i) for i in range(30)])
    assert out == [i * 3 for i in range(30)]

    # head respawn mid-put: kill the head, keep writing through the
    # redial window, and verify the persisted KV survived the restart
    backend = rt.cluster_backend
    backend.head.kv_put(b"chaos:key", b"v0")
    backend.head_proc.kill()
    backend.head.kv_put(b"chaos:key", b"v1")     # rides the redial
    assert backend.head.kv_get(b"chaos:key") == b"v1"

    # the cluster still runs tasks after the respawn
    out = ray_tpu.get([f.remote(i) for i in range(10)])
    assert out == [i * 3 for i in range(10)]

    # exact fault accounting from the registry log
    assert fp.fire_count("fast_lane.submit") == 5
    lane_log = fp.hit_log("fast_lane.submit")
    assert [e["fire"] for e in lane_log] == [1, 2, 3, 4, 5]

    # migrated retry loops surface in the Prometheus exposition
    from ray_tpu_torch.util import metrics
    text = metrics.prometheus_text()
    assert "ray_tpu_retries_total" in text
    assert 'loop="head.redial"' in text


@pytest.mark.parametrize("seed", SEEDS)
def test_chaos_generator_body_exactly_once(seed, daemon_cluster,
                                           tmp_path):
    """Exactly-once-per-attempt: a PLAIN function with a side effect
    that returns a generator object must run its body once per attempt
    even while lane submits are failing over to the classic path
    (regression for the KIND_GEN_FALLBACK double-run)."""
    fp.activate("fast_lane.submit=error(OSError):p=0.4", seed=seed)
    marker_dir = str(tmp_path)

    @ray_tpu.remote
    def gen_with_side_effect(i):
        with open(os.path.join(marker_dir, f"{i}.ran"), "a") as fh:
            fh.write("x")
        return (j * 2 for j in range(3))

    refs = [gen_with_side_effect.remote(i) for i in range(12)]
    for r in refs:
        ray_tpu.get(r)
    for i in range(12):
        with open(os.path.join(marker_dir, f"{i}.ran")) as fh:
            assert fh.read() == "x", f"task {i} body ran != once"
    # the schedule actually exercised both paths
    assert 0 < fp.fire_count("fast_lane.submit") < fp.hit_count(
        "fast_lane.submit")


@pytest.mark.parametrize("seed", SEEDS)
def test_chaos_lane_death_mid_stream_daemons(seed, daemon_cluster):
    """Kill a daemon mid-stream: the consumer gets a typed error or the
    retried stream completes — never a wedge (deterministic per seed
    because the kill lands between two acked items)."""
    rt = daemon_cluster

    @ray_tpu.remote(max_retries=2)
    def slow_gen():
        for i in range(6):
            time.sleep(0.05)
            yield i

    it = slow_gen.remote()
    assert ray_tpu.get(next(it)) == 0
    # node death under a streaming task -> lineage replay skips acked
    # items (deterministic streams) or surfaces NodeDiedError
    victim = list(rt.cluster_backend.daemons.values())[0]
    try:
        rest = []
        mid_kill = {"done": False}

        def killer():
            victim.sigkill()
            mid_kill["done"] = True

        t = threading.Thread(target=killer)
        t.start()
        try:
            for ref in it:
                rest.append(ray_tpu.get(ref, timeout=30))
        except (exc.RayTpuError, exc.TaskError):
            pass        # typed error (incl. get timeout) is accepted
        t.join()
        assert mid_kill["done"]
        # convergence: whatever survived is a prefix-consistent stream
        assert rest == list(range(1, 1 + len(rest)))
    finally:
        # the second daemon keeps the cluster serviceable (generous
        # timeout: this tier runs on loaded CI boxes mid node-death)
        @ray_tpu.remote(max_retries=2)
        def ping():
            return "up"

        assert ray_tpu.get(ping.remote(), timeout=90) == "up"


@pytest.mark.parametrize("seed", SEEDS)
def test_chaos_push_task_delay_schedule(seed):
    """Env-activated schedule reaches SPAWNED daemon processes: delay
    arms on the daemon's push path slow leases without losing tasks."""
    os.environ["RAY_TPU_FAILPOINTS"] = (
        "daemon.push_task=delay(30):every=2")
    os.environ["RAY_TPU_FAILPOINTS_SEED"] = str(seed)
    try:
        rt = ray_tpu.init(num_nodes=1, resources={"CPU": 2},
                          cluster="daemons")
        try:
            @ray_tpu.remote(num_returns="streaming")
            def gen():
                yield from range(4)

            # streaming tasks ride the classic push path (the delayed
            # seam); the stream must still arrive complete and ordered
            assert [ray_tpu.get(r) for r in gen.remote()] == [0, 1, 2, 3]
        finally:
            ray_tpu.shutdown()
    finally:
        os.environ.pop("RAY_TPU_FAILPOINTS", None)
        os.environ.pop("RAY_TPU_FAILPOINTS_SEED", None)


# ---------------------------------------------------------------------------
# graceful drain under chaos: migration faults + crashes racing the drain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_chaos_drain_migration_faults_fall_back_to_lineage(seed):
    """Seeded error arm on drain.migrate_object: objects whose
    migration is injected to fail still survive the departure — lineage
    reconstruction covers exactly what migration could not move, and
    every get() converges."""
    import numpy as np

    rt = ray_tpu.init(num_nodes=4, resources={"CPU": 4})
    try:
        @ray_tpu.remote(max_retries=5)
        def blob(i):
            return np.full((600, 600), i)

        refs = [blob.remote(i) for i in range(8)]
        ray_tpu.get(refs)
        victim = next(n for n in rt.nodes()
                      if any(n.store.contains(r.id) for r in refs))
        n_victim = sum(1 for r in refs if victim.store.contains(r.id))

        fp.activate("drain.migrate_object=error:p=0.5", seed=seed)
        assert rt.drain_node(victim.node_id, deadline_s=20,
                             reason="chaos")
        deadline = time.monotonic() + 25
        while (rt.get_node(victim.node_id) is not None
               and time.monotonic() < deadline):
            time.sleep(0.05)
        assert rt.get_node(victim.node_id) is None

        vals = ray_tpu.get(refs, timeout=60)
        assert all(vals[i][0][0] == i for i in range(8))
        # accounting: every sole copy either migrated (counted once —
        # retried copies are location-deduped) or was lost with the
        # node and lazily reconstructed by the get() above
        moved = rt.stats["drain_objects_migrated"]
        rebuilt = rt.stats["objects_reconstructed"]
        assert moved + rebuilt == n_victim, (moved, rebuilt, n_victim)
        # each sole copy reached the failpoint at least once
        assert fp.hit_count("drain.migrate_object") >= n_victim
    finally:
        ray_tpu.shutdown()


@pytest.mark.parametrize("seed", SEEDS)
def test_chaos_drain_races_worker_crashes_daemons(seed, daemon_cluster):
    """Drain one daemon while seeded lane faults crash/deny submits
    across the cluster: every task converges (completed, resubmitted
    off the draining node, or retried through the crash machinery) and
    the drained node leaves — drain and chaos never wedge each other."""
    rt = daemon_cluster
    fp.activate("fast_lane.submit=error(OSError):every=4:max=6",
                seed=seed)

    @ray_tpu.remote(max_retries=3)
    def work(i):
        time.sleep(0.02)
        return i * 7

    refs = [work.remote(i) for i in range(24)]
    victim = rt.alive_nodes()[0]
    assert rt.drain_node(victim.node_id, deadline_s=10, reason="chaos")
    refs += [work.remote(i) for i in range(24, 36)]

    out = ray_tpu.get(refs, timeout=120)
    assert out == [i * 7 for i in range(36)]
    deadline = time.monotonic() + 30
    while (rt.get_node(victim.node_id) is not None
           and time.monotonic() < deadline):
        time.sleep(0.1)
    assert rt.get_node(victim.node_id) is None
    # the surviving node keeps serving
    assert ray_tpu.get(work.remote(99), timeout=60) == 693
    # head membership reflects the drained departure
    views = {n["node_id"]: n
             for n in rt.cluster_backend.head.list_nodes()}
    assert not views[victim.node_id.hex()]["alive"]


@pytest.mark.parametrize("seed", SEEDS)
def test_chaos_drain_exec_pool_inflight_vs_pending(seed, tmp_path):
    """Drain a node whose sized exec pool is saturated (PR 10 pooled
    execution): pooled IN-FLIGHT tasks finish where they run, admitted-
    but-unstarted specs still in the pool queue are stolen back and
    handed to the scheduler WITHOUT consuming a retry (max_retries=0
    throughout — a burned retry would fail the task), and every body
    runs exactly once, under seeded lane-submit delay noise. Topology
    comes from the run_chaos.sh sweep (in-process + daemons)."""
    rt = ray_tpu.init(num_nodes=2, resources={"CPU": 8},
                      # pool far smaller than the ledger's admission
                      # width: admitted specs QUEUE in the pool, so the
                      # drain finds both in-flight and pending work
                      _system_config={"exec_pool_size": 2})
    try:
        fp.activate("fast_lane.submit=delay(10):p=0.25", seed=seed)
        marker_dir = str(tmp_path)

        @ray_tpu.remote(max_retries=0)
        def slow(i):
            with open(os.path.join(marker_dir, f"{i}.ran"), "a") as fh:
                fh.write("x")
            time.sleep(0.2)
            return i * 5

        refs = [slow.remote(i) for i in range(16)]
        time.sleep(0.15)    # let admission fill the pools mid-flood
        victim = rt.alive_nodes()[0]
        assert rt.drain_node(victim.node_id, deadline_s=30,
                             reason="chaos")
        out = ray_tpu.get(refs, timeout=120)
        assert out == [i * 5 for i in range(16)]
        # exactly once each: the pool-queue handback resubmits specs
        # that never started — a double run (or a retry-burning failure)
        # shows up as a doubled marker / missing result
        for i in range(16):
            with open(os.path.join(marker_dir, f"{i}.ran")) as fh:
                assert fh.read() == "x", f"task {i} body ran != once"
        assert rt.stats["tasks_retried"] == 0
        # clean drain: the node left via completion, not escalation
        deadline = time.monotonic() + 30
        while (rt.get_node(victim.node_id) is not None
               and time.monotonic() < deadline):
            time.sleep(0.1)
        assert rt.get_node(victim.node_id) is None
        assert rt.stats["drain_escalations_total"] == 0
        # the survivor keeps serving pooled work
        assert ray_tpu.get(slow.remote(99), timeout=60) == 495
    finally:
        ray_tpu.shutdown()


@pytest.mark.parametrize("seed", SEEDS)
def test_chaos_drain_deadline_races_escalation_daemons(seed,
                                                      daemon_cluster):
    """A drain whose window closes mid-load escalates into the node-
    death path while the driver's own timer races the head's: the
    escalation runs exactly once, tasks recover via retries, and the
    cluster converges."""
    rt = daemon_cluster

    @ray_tpu.remote(max_retries=3)
    def slow(i):
        time.sleep(0.5)
        return i

    refs = [slow.remote(i) for i in range(8)]
    time.sleep(0.2)
    victim = rt.alive_nodes()[0]
    fp.activate("drain.deadline=delay(25)", seed=seed)
    assert rt.drain_node(victim.node_id, deadline_s=0.3, reason="chaos")
    assert sorted(ray_tpu.get(refs, timeout=120)) == list(range(8))
    deadline = time.monotonic() + 30
    while (rt.get_node(victim.node_id) is not None
           and time.monotonic() < deadline):
        time.sleep(0.1)
    assert rt.get_node(victim.node_id) is None
    # the escalation was counted once (driver timer or head deadline —
    # whichever won; the loser found the node already gone)
    assert rt.stats["drain_escalations_total"] == 1


# ---------------------------------------------------------------------------
# multi-tenant fair-share under fault injection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS[:1])
def test_chaos_quota_exceeded_job_degrades_others_unharmed(seed):
    """A tenant that blows through its CPU quota while the
    ``admission.verdict`` seam is erroring degrades gracefully (its
    submits fall back to QUEUED — delayed, never lost) and the
    well-behaved tenant on the same cluster is unharmed: every task
    from BOTH jobs completes and the seam's hit log shows the faults
    actually fired."""
    from ray_tpu_torch.tenancy import job_context

    rt = ray_tpu.init(num_nodes=1, resources={"CPU": 2},
                      _system_config={"fairshare": True})
    try:
        # the greedy tenant gets a 1-CPU hard cap on a 2-CPU cluster
        rt.tenancy.set_quota("greedy", hard={"CPU": 1.0})

        @ray_tpu.remote
        def work(i):
            time.sleep(0.02)
            return i

        # every 2nd admission decision errors: those submits must
        # degrade to QUEUED (dispatch gate re-decides), not crash
        fp.activate("admission.verdict=error(RuntimeError):every=2:max=20",
                    seed=seed)
        with job_context("greedy"):
            greedy_refs = [work.remote(i) for i in range(20)]
        with job_context("polite"):
            polite_refs = [work.remote(i) for i in range(10)]
        fired = fp.fire_count("admission.verdict")
        assert fired > 0     # the schedule actually cut the seam
        # the polite job is unharmed: all results arrive
        assert sorted(ray_tpu.get(polite_refs, timeout=60)) == \
            list(range(10))
        # the degraded job is delayed, never lost: all results arrive
        # even though half its verdicts came from the error arm and its
        # quota held it to 1 CPU throughout
        assert sorted(ray_tpu.get(greedy_refs, timeout=120)) == \
            list(range(20))
        assert fp.hit_count("admission.verdict") >= fired
    finally:
        ray_tpu.shutdown()


# ---------------------------------------------------------------------------
# process-death reclamation campaign: SIGKILL'd clients leak nothing
# ---------------------------------------------------------------------------
# The object-plane crash-safety contract (docs/object_plane.md "Crash
# reclamation"): every slot ref / reservation charged to a client that
# dies — worker SIGKILL mid-view, writer SIGKILL between reserve and
# seal, external attacher SIGKILL holding live grants — is reclaimed by
# the SAME daemon (death signal or heartbeat sweep), the leak gauge
# returns to zero, and the evicted bytes become re-allocatable. No
# daemon restart, no task failures attributable to reclamation.

def _first_daemon(rt):
    return list(rt.cluster_backend.daemons.values())[0]


def _slot_refs(handle):
    return handle.client.call("daemon_stats")["slot_refs"]


def _wait_refs_zero(handle, timeout=20.0):
    """Poll the per-client attributed leak gauge until every externally
    granted slot ref has been reclaimed (registry truth, not timing)."""
    deadline = time.monotonic() + timeout
    last = None
    while time.monotonic() < deadline:
        last = _slot_refs(handle)
        if last["refs"] == 0:
            return last
        time.sleep(0.1)
    raise AssertionError(f"slot refs never reclaimed: {last}")


def _wait_store_used(handle, at_most, timeout=20.0):
    deadline = time.monotonic() + timeout
    last = None
    while time.monotonic() < deadline:
        last = handle.client.call("daemon_stats")["store_used"]
        if last <= at_most:
            return last
        time.sleep(0.1)
    raise AssertionError(f"store_used stuck at {last} > {at_most}")


def _needs_arena(handle):
    if not handle.objectplane:
        pytest.skip("no native arena on this box (dict-only store)")


@pytest.mark.parametrize("seed", SEEDS)
def test_chaos_sigkill_worker_mid_view_reclaims_grants(seed):
    """SIGKILL an actor's worker while it holds a live zero-copy view:
    the worker-pipe EOF funnels into reclaim_client, the leak gauge
    (ray_tpu_arena_slot_refs{state=refs}) returns to zero, and the
    freed bytes are re-allocatable — without a daemon restart."""
    import signal
    import numpy as np

    rt = ray_tpu.init(num_nodes=1, resources={"CPU": 4},
                      cluster="daemons")
    try:
        handle = _first_daemon(rt)
        _needs_arena(handle)
        daemon_pid = handle.proc.pid

        # produced WORKER-side so the result direct-puts into the
        # daemon's arena raw-tier (c-contiguous, > direct_put_min_
        # bytes): the consumer's get is then a zero-copy view whose
        # finalizer is the ONLY releaser — exactly what a SIGKILL
        # strands. (A driver-side put stays in the driver's store and
        # the consumer would get shipped bytes, not a slot grant.)
        nbytes = 96 * 1024 * 8                          # 768 KiB

        @ray_tpu.remote
        def produce(n):
            return np.arange(n, dtype=np.float64)

        ref = produce.remote(96 * 1024)

        @ray_tpu.remote
        class Holder:
            def hold(self, refs):
                import os as _os
                self.view = ray_tpu.get(refs)[0]
                return _os.getpid(), float(self.view[7])

        h = Holder.remote()
        victim_pid, v = ray_tpu.get(h.hold.remote([ref]), timeout=60)
        assert v == 7.0
        before = _slot_refs(handle)
        assert before["refs"] >= 1, before
        # attribution names a live worker client holding the grant
        workers = [c for c in before["clients"]
                   if c["client"].startswith("w:")]
        assert workers and any(c["alive"] for c in workers), before

        os.kill(victim_pid, signal.SIGKILL)
        after = _wait_refs_zero(handle)
        assert after["refs"] == 0 and after["clients"] == []

        # the daemon never restarted
        assert handle.proc.poll() is None
        assert handle.proc.pid == daemon_pid

        # freed bytes are re-allocatable: drop the driver ref, then the
        # deferred delete (its last ext ref died with the worker) frees
        # on reap and the same-size reservation succeeds
        del ref
        import gc
        gc.collect()
        handle.flush_frees()
        out = None
        deadline = time.monotonic() + 20
        while out is None and time.monotonic() < deadline:
            out = handle.arena_reserve(b"chaos:realloc:%d" % seed, nbytes)
            if out is None:
                time.sleep(0.1)
        assert out is not None and "off" in out, "bytes not re-allocatable"
        handle.free_objects([b"chaos:realloc:%d" % seed])

        # zero task failures attributable to reclamation
        @ray_tpu.remote
        def ping():
            return "up"

        assert ray_tpu.get(ping.remote(), timeout=60) == "up"
    finally:
        ray_tpu.shutdown()


@pytest.mark.parametrize("seed", SEEDS)
def test_chaos_sigkill_worker_mid_direct_put_aborts_reservation(seed):
    """SIGKILL a worker between reserve and seal (the direct-put write
    window): the death signal aborts the unsealed reservation and the
    reserved bytes return to the arena — no TTL wait, no restart."""
    import signal

    rt = ray_tpu.init(num_nodes=1, resources={"CPU": 4},
                      cluster="daemons")
    try:
        handle = _first_daemon(rt)
        _needs_arena(handle)
        baseline = handle.client.call("daemon_stats")["store_used"]

        @ray_tpu.remote
        def reserve_and_stall(seed):
            # reserve arena space exactly like a direct put, then return
            # WITHOUT sealing: the daemon now carries an unsealed
            # reservation charged to this worker's identity
            import os as _os
            from ray_tpu_torch._private import worker as worker_mod
            st = worker_mod._global_runtime._state
            key = b"chaos:stall:%d:%d" % (seed, _os.getpid())
            out = st.call_host("shm_put_reserve", key=key, size=1 << 20)
            assert isinstance(out, dict) and "off" in out, out
            return _os.getpid()

        victim_pid = ray_tpu.get(reserve_and_stall.remote(seed),
                                 timeout=60)
        used = handle.client.call("daemon_stats")["store_used"]
        assert used >= baseline + (1 << 20), (used, baseline)

        os.kill(victim_pid, signal.SIGKILL)
        # pipe EOF -> reclaim_client aborts the reservation; the bytes
        # come back without any daemon restart (small slack: stored
        # task results share the same table)
        _wait_store_used(handle, baseline + 64 * 1024)
        assert handle.proc.poll() is None

        # the same key reserves cleanly afterwards (the abort deleted
        # the unsealed entry, it did not poison the key)
        out = handle.arena_reserve(b"chaos:stall:again:%d" % seed, 1 << 20)
        assert out is not None and "off" in out
        handle.free_objects([b"chaos:stall:again:%d" % seed])

        @ray_tpu.remote
        def ping():
            return "ok"

        assert ray_tpu.get(ping.remote(), timeout=60) == "ok"
    finally:
        ray_tpu.shutdown()


def _external_attacher_script():
    """Source for a subprocess that plays a driver-like external
    attacher: grabs a slot grant + an unsealed reservation over raw
    RPC, reports READY, then blocks until SIGKILLed."""
    return r"""
import sys, time
host, port, oid_hex = sys.argv[1], int(sys.argv[2]), sys.argv[3]
from ray_tpu_torch._private import rpc
rpc.declare("get_object", "oid", "prefer_shm")
rpc.declare("create_object", "oid", "size")
c = rpc.Client((host, port), timeout=10)
out = c.call("get_object", oid=bytes.fromhex(oid_hex),
             prefer_shm=True, slot_ok=True)
assert out.get("slot") is not None, out
res = c.call("create_object", oid=b"chaos:ext:res", size=256 * 1024)
assert res.get("ok"), res
print("READY", flush=True)
time.sleep(120)
"""


@pytest.mark.parametrize("seed", SEEDS)
def test_chaos_sigkill_external_client_holding_views(seed):
    """SIGKILL an external attacher (driver-protocol client) that holds
    a slot grant on a deferred-deleted object PLUS an unsealed
    reservation: the RPC disconnect reclaims both, the deferred delete
    frees on the very next reap (NOT at daemon restart), and an
    allocation that could not fit while the leak lived succeeds."""
    import subprocess
    import sys

    # arena sized so the seeded blob + a leaked copy cannot coexist:
    # re-reserving the blob's size FAILS while the dead client's grant
    # pins the deferred delete, and SUCCEEDS once reclaimed
    rt = ray_tpu.init(num_nodes=1, resources={"CPU": 2},
                      cluster="daemons",
                      object_store_memory=4 * 1024 * 1024)
    try:
        handle = _first_daemon(rt)
        _needs_arena(handle)
        daemon_pid = handle.proc.pid
        key = b"chaos:ext:%d" % seed
        blob = os.urandom(int(2.5 * 1024 * 1024))
        handle.put_object_blob(key, blob)

        proc = subprocess.Popen(
            [sys.executable, "-c", _external_attacher_script(),
             handle.addr[0], str(handle.addr[1]), key.hex()],
            stdout=subprocess.PIPE, text=True)
        try:
            assert proc.stdout.readline().strip() == "READY"
            before = _slot_refs(handle)
            assert before["refs"] >= 1, before
            assert any(c["client"].startswith("c:")
                       for c in before["clients"]), before

            # delete while the external grant pins it: deferred delete,
            # bytes still held -> a same-size reservation cannot fit
            handle.free_objects([key])
            assert handle.arena_reserve(b"chaos:ext:probe", len(blob)) \
                is None, "leak did not pin the arena (test inert)"

            proc.kill()     # SIGKILL: no release, no goodbye
            proc.wait(timeout=10)

            # conn EOF -> on_disconnect -> reclaim_client: grant dropped,
            # reservation aborted, reap frees the deferred delete
            after = _wait_refs_zero(handle)
            assert after["refs"] == 0
            out = None
            deadline = time.monotonic() + 20
            while out is None and time.monotonic() < deadline:
                out = handle.arena_reserve(b"chaos:ext:re", len(blob))
                if out is None:
                    time.sleep(0.1)
            assert out is not None and "off" in out, \
                "deferred delete not freed by reap after reclaim"
            handle.free_objects([b"chaos:ext:re"])

            # same daemon process throughout — reclamation, not restart
            assert handle.proc.poll() is None
            assert handle.proc.pid == daemon_pid
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)

        @ray_tpu.remote
        def ping():
            return 1

        assert ray_tpu.get(ping.remote(), timeout=60) == 1
    finally:
        ray_tpu.shutdown()


@pytest.mark.parametrize("seed", SEEDS)
def test_chaos_sweep_backstop_when_event_reclaim_dropped(seed):
    """arena.grant_reclaim drop arm (env-activated so it arms the
    SPAWNED daemon): the death-signal reclaim is LOST once; the
    heartbeat orphan sweep must still converge the leak gauge to zero
    (dead-pid ledger reclaim), and the reclaimed grants surface on the
    federated ray_tpu_arena_grants_reclaimed_total counter."""
    import signal
    import numpy as np

    os.environ["RAY_TPU_FAILPOINTS"] = "arena.grant_reclaim=drop:max=1"
    os.environ["RAY_TPU_FAILPOINTS_SEED"] = str(seed)
    os.environ["RAY_TPU_ARENA_RESERVE_TTL_S"] = "1"
    try:
        rt = ray_tpu.init(num_nodes=1, resources={"CPU": 4},
                          cluster="daemons")
        try:
            handle = _first_daemon(rt)
            _needs_arena(handle)

            @ray_tpu.remote
            def produce(n):
                return np.arange(n, dtype=np.float64)

            ref = produce.remote(96 * 1024)   # lands raw in the arena

            @ray_tpu.remote
            class Holder:
                def hold(self, refs):
                    import os as _os
                    self.view = ray_tpu.get(refs)[0]
                    return _os.getpid()

            h = Holder.remote()
            victim_pid = ray_tpu.get(h.hold.remote([ref]), timeout=60)
            assert _slot_refs(handle)["refs"] >= 1

            os.kill(victim_pid, signal.SIGKILL)
            # event path suppressed by the drop arm (max=1); the sweep
            # (every daemon heartbeat) finds the dead pid in the ledger
            # and reclaims through the now-exhausted seam
            after = _wait_refs_zero(handle, timeout=30.0)
            assert after["refs"] == 0
            assert handle.proc.poll() is None

            # a driver-side reservation never sealed: the TTL sweep
            # (RAY_TPU_ARENA_RESERVE_TTL_S=1) aborts it while this
            # connection stays OPEN — stale-reservation path, not the
            # disconnect path
            used0 = handle.client.call("daemon_stats")["store_used"]
            out = handle.arena_reserve(b"chaos:ttl:%d" % seed, 512 * 1024)
            assert out is not None and "off" in out
            _wait_store_used(handle, used0 + 64 * 1024, timeout=30.0)

            # federated accounting: the daemon's reclaim counters reach
            # the driver's cluster view (per-node rows)
            from ray_tpu_torch.util import metrics
            deadline = time.monotonic() + 30
            names = set()
            while time.monotonic() < deadline:
                names = {(r["name"],
                          dict(r.get("labels") or {}).get("reason"))
                         for r in metrics.cluster_metrics_json()["metrics"]}
                if ("ray_tpu_arena_grants_reclaimed_total",
                        "sweep") in names and \
                   ("ray_tpu_arena_stale_reservations_total",
                        None) in names:
                    break
                time.sleep(0.25)
            assert ("ray_tpu_arena_grants_reclaimed_total",
                    "sweep") in names, sorted(names)
            assert ("ray_tpu_arena_stale_reservations_total",
                    None) in names, sorted(names)
        finally:
            ray_tpu.shutdown()
    finally:
        os.environ.pop("RAY_TPU_FAILPOINTS", None)
        os.environ.pop("RAY_TPU_FAILPOINTS_SEED", None)
        os.environ.pop("RAY_TPU_ARENA_RESERVE_TTL_S", None)


# ---------------------------------------------------------------------------
# network partitions: one-way splits, death-mark + heal fencing, flapping
# links, partition racing a graceful drain (docs/fault_tolerance.md
# "Partitions, epochs & fencing"). These boot their own daemons cluster
# (the run_chaos.sh `network` tier sweeps the surrounding driver
# topology env, like the process-kill tier).
# ---------------------------------------------------------------------------

from ray_tpu_torch._private import netchaos as nc  # noqa: E402


def _fenced_results_total(kind=None):
    """Sum of ray_tpu_fenced_results_total in THIS driver's registry
    (optionally one kind) — the fencing layer is driver-side."""
    from ray_tpu_torch.util import metrics
    total = 0.0
    for line in metrics.prometheus_text().splitlines():
        if not line.startswith("ray_tpu_fenced_results_total"):
            continue
        if kind is not None and f'kind="{kind}"' not in line:
            continue
        total += float(line.rsplit(" ", 1)[1])
    return total


@pytest.mark.parametrize("seed", SEEDS)
def test_netchaos_partition_one_way_driver_daemon_mid_burst(seed):
    """One-way driver->daemon partition opened MID-BURST against one
    node (requests vanish; replies and result pushes still flow). The
    wedge-proof contract: the bounded batch-flush deadline surfaces the
    silent link as a typed RpcError -> node death -> retries on the
    survivor; lane submits swallowed by the partition unwedge through
    the same death mark. Every task converges exactly once."""
    rt = ray_tpu.init(num_nodes=2, resources={"CPU": 4},
                      cluster="daemons",
                      _system_config={"control_call_timeout_s": 1.5})
    try:
        victim = _first_daemon(rt)
        vh = victim.node_id.hex()

        @ray_tpu.remote(max_retries=5, num_returns=2)
        def pair(i):
            time.sleep(0.05)
            return i, i * 11

        @ray_tpu.remote(max_retries=5)
        def plain(i):
            time.sleep(0.05)
            return i * 7

        # pre-partition traffic on both planes (pump + fast lane)
        pre = [pair.remote(i) for i in range(6)]
        pre_plain = [plain.remote(i) for i in range(6)]
        time.sleep(0.3)
        # one-way split: everything the driver sends toward the victim
        # (control client AND its node-scoped lane) is dropped
        nc.activate(f"driver>daemon@{vh}=partition;"
                    f"driver>daemon@lane:{vh}=partition", seed=seed)
        post = [pair.remote(i) for i in range(6, 14)]
        post_plain = [plain.remote(i) for i in range(6, 14)]

        flat = [r for pr in pre + post for r in pr]
        vals = ray_tpu.get(flat, timeout=120)
        assert vals == [x for i in range(14) for x in (i, i * 11)]
        assert ray_tpu.get(pre_plain + post_plain, timeout=120) == [
            i * 7 for i in range(14)]

        # the partition actually ate frames, deterministically logged
        assert nc.injected_count("drop") > 0
        dropped_links = {e["policy"] for e in nc.hit_log()}
        assert f"driver>daemon@{vh}" in dropped_links
        # typed-timeout contract: the victim was declared dead (flush
        # deadline -> RpcError -> mark_dead), never a wedged thread
        assert victim.dead
        # the survivor keeps serving new work
        assert ray_tpu.get(plain.remote(99), timeout=60) == 693
    finally:
        nc.reset()
        ray_tpu.shutdown()


@pytest.mark.parametrize("seed", SEEDS)
def test_netchaos_partition_death_mark_then_heal_fences_results(seed):
    """Daemon<->head partition long enough for the head's liveness
    timer to death-mark the node, then heal. In-flight work finishes on
    the superseded node and its late result pushes arrive at the driver
    AFTER the death mark: the fence rejects them (counter > 0), the
    retried attempts complete exactly once on the survivor, and the
    fenced daemon exits via the {"dead": True} re-register contract."""
    rt = ray_tpu.init(num_nodes=2, resources={"CPU": 4},
                      cluster="daemons")
    try:
        victim = _first_daemon(rt)
        vh = victim.node_id.hex()
        fenced_before = _fenced_results_total()

        @ray_tpu.remote(max_retries=5, num_returns=2)
        def slow(i):
            time.sleep(2.5)
            return i, i * 13

        refs = [slow.remote(i) for i in range(8)]
        time.sleep(0.4)     # let the burst dispatch across both nodes
        # partition THIS daemon's head link (programmatic per-node
        # activation inside the spawned process); window outlives the
        # node_dead_after_s liveness deadline, then heals
        out = victim.client.call(
            "net_chaos", spec="daemon>head=partition:dur=3500",
            seed=seed, timeout=5.0)
        assert out["active"]

        vals = ray_tpu.get([r for pr in refs for r in pr], timeout=120)
        # exactly once per ref: each task resolves to ONE value even
        # though the superseded node also ran (and pushed) it
        assert vals == [x for i in range(8) for x in (i, i * 13)]
        # the dead-marked node's work was re-run through retries
        assert rt.stats["tasks_retried"] >= 1
        # the fence engaged: stamped frames from the superseded
        # incarnation were rejected, not double-delivered
        deadline = time.monotonic() + 30
        while (_fenced_results_total() <= fenced_before
               and time.monotonic() < deadline):
            time.sleep(0.1)
        assert _fenced_results_total() > fenced_before
        # heal: the partition window closes, the daemon re-registers,
        # learns it was fenced, and drains via the dead-exit contract
        victim.proc.wait(timeout=40)
        views = {n["node_id"]: n
                 for n in rt.cluster_backend.head.list_nodes()}
        assert not views[vh]["alive"]

        @ray_tpu.remote
        def ping():
            return "up"

        assert ray_tpu.get(ping.remote(), timeout=60) == "up"
    finally:
        nc.reset()
        ray_tpu.shutdown()


@pytest.mark.parametrize("seed", SEEDS)
def test_netchaos_flapping_link_under_queued_drain(seed):
    """Flapping latency bursts (150ms impaired / 150ms clean, seeded
    jitter) on one node's control link + lane while that node drains
    with a queue of admitted work: every queued task converges exactly
    once, the drained node departs, and the flap's off-transitions fire
    the net.partition_heal seam."""
    rt = ray_tpu.init(num_nodes=2, resources={"CPU": 4},
                      cluster="daemons")
    try:
        fp.activate("net.partition_heal=delay(0);net.link_drop=delay(0)",
                    seed=seed)
        victim = _first_daemon(rt)
        vh = victim.node_id.hex()

        @ray_tpu.remote(max_retries=2)
        def work(i):
            time.sleep(0.15)
            return i * 9

        # queue depth > cluster CPU: the drain finds admitted-but-
        # unstarted work behind the stuttering link
        refs = [work.remote(i) for i in range(12)]
        # 200ms impaired / 100ms clean: the second half of the burst and
        # the drain's migration chatter cross the flap's on-phase
        nc.activate(f"driver>daemon@{vh}=lat=120:jitter=40:"
                    f"flap=200/100:sym;"
                    f"driver>daemon@lane:{vh}=lat=120:flap=200/100",
                    seed=seed)
        refs += [work.remote(i) for i in range(12, 24)]
        time.sleep(0.1)
        assert rt.drain_node(victim.node_id, deadline_s=20,
                             reason="netchaos-flap")
        assert ray_tpu.get(refs, timeout=120) == [
            i * 9 for i in range(24)]
        deadline = time.monotonic() + 30
        while (rt.get_node(victim.node_id) is not None
               and time.monotonic() < deadline):
            time.sleep(0.1)
        assert rt.get_node(victim.node_id) is None
        # the stutter really ran: seeded delays were injected and at
        # least one impaired->clear flap transition reported a heal
        assert nc.injected_count("delay") > 0
        assert fp.fire_count("net.partition_heal") >= 1
        assert ray_tpu.get(work.remote(50), timeout=60) == 450
    finally:
        nc.reset()
        ray_tpu.shutdown()


@pytest.mark.parametrize("seed", SEEDS)
def test_netchaos_partition_during_graceful_drain(seed):
    """A daemon<->head partition opens DURING a graceful drain of that
    node. Whichever side wins the race — the drain finishing its
    migration, or the head's liveness timer escalating to node death —
    every task converges exactly once, the node departs, and the
    partitioned daemon process exits instead of lingering as a zombie."""
    rt = ray_tpu.init(num_nodes=2, resources={"CPU": 4},
                      cluster="daemons")
    try:
        victim = _first_daemon(rt)
        vh = victim.node_id.hex()

        @ray_tpu.remote(max_retries=5)
        def work(i):
            time.sleep(0.6)
            return i * 4

        refs = [work.remote(i) for i in range(24)]
        time.sleep(0.2)
        assert rt.drain_node(victim.node_id, deadline_s=15,
                             reason="netchaos-drain")
        # permanent split from the head, mid-drain: heartbeats vanish
        victim.client.call("net_chaos", spec="daemon>head=partition",
                           seed=seed, timeout=5.0)

        assert ray_tpu.get(refs, timeout=120) == [
            i * 4 for i in range(24)]
        deadline = time.monotonic() + 30
        while (rt.get_node(victim.node_id) is not None
               and time.monotonic() < deadline):
            time.sleep(0.1)
        assert rt.get_node(victim.node_id) is None
        views = {n["node_id"]: n
                 for n in rt.cluster_backend.head.list_nodes()}
        assert not views[vh]["alive"]
        # drained OR death-marked, the daemon process must EXIT (clean
        # drain completion, or the fenced re-register dead reply)
        victim.proc.wait(timeout=40)
        assert ray_tpu.get(work.remote(99), timeout=60) == 396
    finally:
        nc.reset()
        ray_tpu.shutdown()

# ---------------------------------------------------------------------------
# memory pressure: graceful degradation under OOM chaos
# (docs/fault_tolerance.md "Memory pressure & graceful degradation").
# Ballast scenarios — worker host-memory ballast, arena overfill, and
# both at once — assert the degradation ladder end to end: zero lost
# tasks, spill/restore counters rise, a held zero-copy view is NEVER
# spilled out from under its reader, slot refs return to zero, and the
# node converges back to level ok after relief. The run_chaos.sh
# `memory` tier sweeps these over both driver topologies.
# ---------------------------------------------------------------------------

def _wait_pressure(handle, level, timeout=20.0):
    deadline = time.monotonic() + timeout
    last = None
    while time.monotonic() < deadline:
        last = handle.client.call("daemon_stats")["pressure"]
        if last == level:
            return
        time.sleep(0.05)
    raise AssertionError(f"pressure stuck at {last!r}, wanted {level!r}")


def _spill_stats(handle):
    return handle.client.call("daemon_stats")["spill"]


@pytest.mark.parametrize("seed", SEEDS)
def test_chaos_memory_arena_fill_spills_restores_pins_hold(seed,
                                                           tmp_path):
    """Arena overfill ballast: blob puts far past the arena's capacity
    all land (spill_for makes room off cold entries instead of failing
    over), every byte reads back exactly (restore on demand), the entry
    under a HELD zero-copy view is never spilled, and after relief the
    grants reclaim to zero and the node returns to level ok."""
    import numpy as np

    os.environ["RAY_TPU_MEMORY_PRESSURE"] = "1"
    os.environ["RAY_TPU_PRESSURE_TICK_S"] = "0.1"
    os.environ["RAY_TPU_ARENA_SPILL_DIR"] = str(tmp_path)
    try:
        rt = ray_tpu.init(num_nodes=1, resources={"CPU": 4},
                          cluster="daemons",
                          object_store_memory=4 * 1024 * 1024)
        try:
            handle = _first_daemon(rt)
            _needs_arena(handle)
            daemon_pid = handle.proc.pid

            # a worker-produced raw-tier entry, pinned by a held view:
            # it must survive every spill pass bit-for-bit
            @ray_tpu.remote
            def produce(n):
                return np.arange(n, dtype=np.float64)

            ref = produce.remote(96 * 1024)             # 768 KiB

            @ray_tpu.remote
            class Holder:
                def hold(self, refs):
                    self.view = ray_tpu.get(refs)[0]
                    return float(self.view[7])

                def check(self):
                    return float(self.view[7]), float(self.view[-1])

                def drop(self):
                    del self.view
                    return True

            h = Holder.remote()
            assert ray_tpu.get(h.hold.remote([ref]), timeout=60) == 7.0
            assert _slot_refs(handle)["refs"] >= 1

            # ballast: 8 MiB of puts through a 4 MiB arena — every one
            # must land (spill_for + the typed-backpressure retry ride)
            from ray_tpu_torch.exceptions import MemoryPressureError
            rng = __import__("random").Random(seed)
            blobs = {}
            for i in range(8):
                key = b"chaos:mem:%d:%d" % (seed, i)
                blobs[key] = bytes([rng.randrange(256)]) * (1 << 20)
                RetryPolicy.default(deadline_s=60.0).run(
                    lambda k=key: handle.put_object_blob(k, blobs[k]),
                    loop="chaos.mem_put",
                    retry_on=(MemoryPressureError,))
            stats = _spill_stats(handle)
            assert stats["spills"] >= 1, stats
            assert stats["spilled_now_bytes"] > 0, stats
            # the pass walked past the pinned entry, never spilled it
            assert stats["spill_skipped_pinned"] >= 1, stats

            # reads never miss: every ballast byte restores (or serves
            # off its spill file) exactly
            for key, blob in blobs.items():
                got = handle.get_object_blob(key)
                assert got == blob, f"{key} corrupted"
            assert _spill_stats(handle)["restores"] >= 1

            # the held view stayed valid AND exact through the storm
            v7, vlast = ray_tpu.get(h.check.remote(), timeout=60)
            assert (v7, vlast) == (7.0, float(96 * 1024 - 1))

            # relief: drop the view + ballast, grants reclaim to zero,
            # the level converges back to ok, the daemon never restarted
            assert ray_tpu.get(h.drop.remote(), timeout=60) is True
            del ref
            import gc
            gc.collect()
            handle.flush_frees()
            handle.free_objects(list(blobs))
            _wait_refs_zero(handle)
            _wait_pressure(handle, "ok")
            assert handle.proc.poll() is None
            assert handle.proc.pid == daemon_pid

            @ray_tpu.remote
            def ping():
                return "up"

            assert ray_tpu.get(ping.remote(), timeout=60) == "up"
        finally:
            ray_tpu.shutdown()
    finally:
        os.environ.pop("RAY_TPU_MEMORY_PRESSURE", None)
        os.environ.pop("RAY_TPU_PRESSURE_TICK_S", None)
        os.environ.pop("RAY_TPU_ARENA_SPILL_DIR", None)


@pytest.mark.parametrize("seed", SEEDS)
def test_chaos_memory_worker_ballast_oom_preemption(seed):
    """Worker host-memory ballast: a hog task blows the (lowered)
    memory limit, the node's monitor SIGKILLs it, and with retries
    exhausted it surfaces as the typed retriable OutOfMemoryError —
    while every innocent task converges (zero lost tasks) and the
    preemption lands on the federated
    ray_tpu_oom_preemptions_total{reason} counter."""
    os.environ["RAY_TPU_MEMORY_PRESSURE"] = "1"
    os.environ["RAY_TPU_MEMORY_MONITOR_INTERVAL"] = "0.1"
    try:
        rt = ray_tpu.init(num_nodes=1, resources={"CPU": 4},
                          cluster="daemons")
        try:
            mon = rt.memory_monitor
            mon.interval_s = 0.1
            if not mon._thread.is_alive():
                mon.start()
            baseline = mon.usage_bytes()
            mon.set_limit(baseline + 150 * 1024 * 1024)

            @ray_tpu.remote(max_retries=1)
            def hog(s):
                import numpy as np
                import time as _t
                blob = np.ones(400 * 1024 * 1024 // 8)   # ~400 MB
                _t.sleep(20)
                return blob.sum() + s

            # innocents carry generous retries: the RetriableFIFO
            # policy shoots the NEWEST retriable task, so any light
            # task scheduled after the hog's (re)start can catch a
            # stray bullet — it must retry through, never get lost
            @ray_tpu.remote(max_retries=8)
            def light(i):
                time.sleep(0.05)
                return i * 5

            light_refs = [light.remote(i) for i in range(16)]
            hog_ref = hog.remote(seed)

            with pytest.raises(exc.OutOfMemoryError):
                ray_tpu.get(hog_ref, timeout=120)
            # zero lost tasks: every innocent task converges exactly
            assert ray_tpu.get(light_refs, timeout=120) == [
                i * 5 for i in range(16)]

            kills = mon.kills
            backend = getattr(rt, "cluster_backend", None)
            if backend is not None:
                for h in backend.daemons.values():
                    kills += h.client.call("oom_check", task_id="",
                                           fast_lane=False)["kills"]
            assert kills >= 1

            # the preemption federates with its reason tag
            from ray_tpu_torch.util import metrics
            deadline = time.monotonic() + 30
            reasons = set()
            while time.monotonic() < deadline:
                reasons = {
                    dict(r.get("labels") or {}).get("reason")
                    for r in metrics.cluster_metrics_json()["metrics"]
                    if r["name"] == "ray_tpu_oom_preemptions_total"}
                if reasons:
                    break
                time.sleep(0.25)
            assert "host" in reasons or "tenant_quota" in reasons, reasons

            # post-relief convergence: limit restored, the cluster runs
            mon.set_limit(1 << 62)
            assert ray_tpu.get(light.remote(99), timeout=60) == 495
        finally:
            ray_tpu.shutdown()
    finally:
        os.environ.pop("RAY_TPU_MEMORY_PRESSURE", None)
        os.environ.pop("RAY_TPU_MEMORY_MONITOR_INTERVAL", None)


@pytest.mark.parametrize("seed", SEEDS)
def test_chaos_memory_combined_hard_window_backpressure(seed, tmp_path):
    """Both ballasts at once: a forced host-hard window (the
    pressure.level seam, armed per-node through the fail_points hook —
    the deterministic stand-in for RSS ballast) OVER an arena overfill.
    While hard: the level propagates to the driver's Node view (so
    pick_node soft-excludes the victim), NEW puts reject with the typed
    retriable error, and reads still pass. Store-level puts ride
    RetryPolicy through the window; after relief every task and byte
    has converged and the level returns to ok."""
    from ray_tpu_torch._private.ids import ObjectID
    from ray_tpu_torch.exceptions import MemoryPressureError

    os.environ["RAY_TPU_MEMORY_PRESSURE"] = "1"
    os.environ["RAY_TPU_PRESSURE_TICK_S"] = "0.1"
    os.environ["RAY_TPU_ARENA_SPILL_DIR"] = str(tmp_path)
    try:
        rt = ray_tpu.init(num_nodes=2, resources={"CPU": 4},
                          cluster="daemons",
                          object_store_memory=4 * 1024 * 1024)
        try:
            victim = _first_daemon(rt)
            _needs_arena(victim)
            node = rt.get_node(victim.node_id)

            # a pre-pressure object on the victim: reads must pass
            # through the whole hard window
            pre = ObjectID.from_random()
            node.store.put(pre, b"pre-pressure", nbytes=12)

            # ~4s of forced hard pressure on the victim only
            out = victim.client.call(
                "fail_points",
                spec="pressure.level=return(hard):max=40",
                seed=seed, timeout=5.0)
            assert out["active"]
            _wait_pressure(victim, "hard")

            # the level rode the push/gossip to the driver's Node view
            deadline = time.monotonic() + 10
            while (getattr(node, "pressure_level", "ok") != "hard"
                   and time.monotonic() < deadline):
                time.sleep(0.05)
            assert node.pressure_level == "hard"

            # typed rejection of a NEW put; reads still pass
            with pytest.raises(MemoryPressureError):
                victim.put_object_blob(b"chaos:rejected", b"x" * 1024)
            assert node.store.get(pre) == b"pre-pressure"

            # tasks submitted DURING the window all converge (the other
            # node takes them; the fallback would run them regardless)
            @ray_tpu.remote(max_retries=2)
            def work(i):
                return i * 6

            refs = [work.remote(i) for i in range(12)]

            # arena overfill through the window: store-level puts ride
            # RetryPolicy across the hard ticks, then spill keeps every
            # one landing
            rng = __import__("random").Random(seed)
            oids = {}
            for i in range(6):
                oid = ObjectID.from_random()
                blob = bytes([rng.randrange(256)]) * (1 << 20)
                oids[oid] = blob
                node.store.put(oid, blob, nbytes=len(blob))
            assert ray_tpu.get(refs, timeout=120) == [
                i * 6 for i in range(12)]
            for oid, blob in oids.items():
                assert node.store.get(oid) == blob
            stats = _spill_stats(victim)
            assert stats["spills"] >= 1, stats

            # relief: the arm exhausts, the level converges to ok and
            # the driver's view follows
            _wait_pressure(victim, "ok", timeout=30.0)
            deadline = time.monotonic() + 10
            while (node.pressure_level != "ok"
                   and time.monotonic() < deadline):
                time.sleep(0.05)
            assert node.pressure_level == "ok"
            assert ray_tpu.get(work.remote(50), timeout=60) == 300
        finally:
            ray_tpu.shutdown()
    finally:
        os.environ.pop("RAY_TPU_MEMORY_PRESSURE", None)
        os.environ.pop("RAY_TPU_PRESSURE_TICK_S", None)
        os.environ.pop("RAY_TPU_ARENA_SPILL_DIR", None)
