"""The port's failpoint registry and RetryPolicy (copies of
``tests/test_failpoints.py``): the registry contract (arms, determinism,
hit log, spec grammar), the RetryPolicy schedule (full jitter, budgets,
Prometheus counters), the catalogue of wired seams, and the cheap seam
behaviours that need no daemon cluster.
"""

import random
import threading
import time

import pytest

import ray_tpu_torch as ray_tpu
from ray_tpu_torch._private import failpoints as fp
from ray_tpu_torch._private import rpc
from ray_tpu_torch._private.retry import RetryPolicy, record_retry


@pytest.fixture(autouse=True)
def _reset_failpoints():
    yield
    fp.reset()
    if ray_tpu.is_initialized():    # tests/conftest.py shuts down JAX's
        ray_tpu.shutdown()


@pytest.fixture
def ray_start_regular():
    rt = ray_tpu.init(num_nodes=1, resources={"CPU": 8})
    yield rt
    ray_tpu.shutdown()


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def test_inactive_registry_is_noop():
    assert not fp.ENABLED
    assert fp.fire("anything.at.all") is None
    assert fp.hit_count("anything.at.all") == 0


def test_spec_parsing_arms():
    fp.activate("a.b=drop:every=2:max=2;c.d=delay(1);"
                "e.f=error(OSError):after=1;g.h=return(42)")
    desc = fp.describe()
    assert desc["a.b"]["action"] == "drop" and desc["a.b"]["every"] == 2
    assert desc["c.d"]["action"] == "delay" and desc["c.d"]["arg"] == 1.0
    # exception names resolve lazily at fire() time (import-order safe)
    assert desc["e.f"]["arg"] == "OSError" and desc["e.f"]["after"] == 1
    assert desc["g.h"]["action"] == "return" and desc["g.h"]["arg"] == 42


def test_every_and_max_arms():
    fp.activate("s=drop:every=2:max=2")
    outcomes = [fp.fire("s") for _ in range(8)]
    assert [o is fp.DROP for o in outcomes] == [
        False, True, False, True, False, False, False, False]
    assert fp.hit_count("s") == 8
    assert fp.fire_count("s") == 2


def test_after_arm_skips_first_hits():
    fp.activate("s=drop:after=3")
    outcomes = [fp.fire("s") is fp.DROP for _ in range(5)]
    assert outcomes == [False, False, False, True, True]


def test_error_arm_raises_resolved_class():
    fp.activate("s=error(RpcError)")
    with pytest.raises(rpc.RpcError):
        fp.fire("s")
    fp.activate("t=error()")
    with pytest.raises(fp.FailpointError):
        fp.fire("t")


def test_return_arm_short_circuits():
    fp.configure("s", "return", arg={"x": 1})
    out = fp.fire("s")
    assert isinstance(out, fp.Return) and out.value == {"x": 1}


def test_seeded_probability_is_deterministic():
    fp.activate("s=drop:p=0.5", seed=321)
    first = [fp.fire("s") is fp.DROP for _ in range(32)]
    fp.activate("s=drop:p=0.5", seed=321)
    replay = [fp.fire("s") is fp.DROP for _ in range(32)]
    assert first == replay
    assert any(first) and not all(first)   # it's actually probabilistic
    fp.activate("s=drop:p=0.5", seed=99)
    other = [fp.fire("s") is fp.DROP for _ in range(32)]
    assert other != first                  # seed changes the schedule


def test_per_arm_rng_isolation():
    """One arm's probability draws must not perturb another's: the
    per-seam schedule replays identically whether or not other seams'
    hits interleave (per-arm RNG derived from (seed, name))."""
    fp.activate("a=drop:p=0.5;b=drop:p=0.5", seed=77)
    a_alone = [fp.fire("a") is fp.DROP for _ in range(20)]
    fp.activate("a=drop:p=0.5;b=drop:p=0.5", seed=77)
    a_interleaved = []
    for _ in range(20):
        a_interleaved.append(fp.fire("a") is fp.DROP)
        fp.fire("b")
    assert a_interleaved == a_alone


def test_hit_log_carries_context():
    fp.activate("s=delay(0)")
    fp.fire("s", method="kv_put")
    fp.fire("s", method="publish")
    log = fp.hit_log("s")
    assert [e["method"] for e in log] == ["kv_put", "publish"]
    assert [e["fire"] for e in log] == [1, 2]


def test_hit_log_thread_safety():
    fp.activate("s=delay(0)")
    n_threads, per_thread = 8, 50

    def worker():
        for _ in range(per_thread):
            fp.fire("s")

    threads = [threading.Thread(target=worker) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert fp.hit_count("s") == n_threads * per_thread
    assert len(fp.hit_log("s")) == n_threads * per_thread


def test_malformed_specs_rejected():
    with pytest.raises(ValueError):
        fp.parse_spec("no_equals_sign")
    with pytest.raises(ValueError):
        fp.parse_spec("a=explode")
    with pytest.raises(ValueError):
        fp.parse_spec("a=drop:bogus=1")
    # unknown exception names parse (resolution is lazy so runtime
    # error classes work from env activation at import time) but fail
    # LOUDLY at the seam
    fp.activate("a=error(NoSuchExceptionClass)")
    with pytest.raises(ValueError):
        fp.fire("a")


def test_error_arm_resolves_at_fire_time_not_import_time():
    """Env activation runs while rpc.py/fast_lane.py are mid-import;
    specs naming their error classes must not crash the process then
    (regression: parse-time _resolve_exc raised ValueError and killed
    every process at startup)."""
    import os
    import subprocess
    import sys
    out = subprocess.run(
        [sys.executable, "-c",
         "import ray_tpu_torch._private.rpc as rpc\n"
         "from ray_tpu_torch._private import failpoints as fp\n"
         "assert fp.ENABLED\n"
         "try:\n"
         "    fp.fire('rpc.client.send')\n"
         "except rpc.RpcError:\n"
         "    print('RESOLVED_OK')\n"],
        capture_output=True, text=True,
        env={**os.environ, "JAX_PLATFORMS": "cpu",
             "RAY_TPU_FAILPOINTS": "rpc.client.send=error(RpcError)"})
    assert "RESOLVED_OK" in out.stdout, (out.stdout, out.stderr)


# ---------------------------------------------------------------------------
# RetryPolicy
# ---------------------------------------------------------------------------

def test_retry_policy_attempt_budget():
    calls = []

    def boom():
        calls.append(1)
        raise OSError("down")

    policy = RetryPolicy(max_attempts=4, base_s=0.0, max_backoff_s=0.0)
    with pytest.raises(OSError):
        policy.run(boom, loop="t.budget", retry_on=(OSError,))
    assert len(calls) == 4     # the LAST exception re-raises


def test_retry_policy_overall_deadline():
    t0 = time.monotonic()
    policy = RetryPolicy(deadline_s=0.15, base_s=0.02,
                         max_backoff_s=0.05)
    with pytest.raises(OSError):
        policy.run(lambda: (_ for _ in ()).throw(OSError("x")),
                   loop="t.deadline", retry_on=(OSError,))
    assert time.monotonic() - t0 < 2.0


def test_retry_policy_full_jitter_bounds_and_determinism():
    policy = RetryPolicy(base_s=0.05, max_backoff_s=0.4)
    rng = random.Random(7)
    seq = [policy.backoff_s(i, rng) for i in range(10)]
    for i, s in enumerate(seq):
        assert 0.0 <= s <= min(0.4, 0.05 * 2 ** i)
    # same rng seed => same jitter draws
    rng2 = random.Random(7)
    assert seq == [RetryPolicy(base_s=0.05, max_backoff_s=0.4).backoff_s(
        i, rng2) for i in range(10)]
    # huge attempt numbers must not overflow float pow
    assert policy.backoff_s(10_000) <= 0.4


def test_retry_policy_succeeds_midway_and_counts():
    from ray_tpu_torch.util import metrics
    state = {"n": 0}

    def flaky():
        state["n"] += 1
        if state["n"] < 3:
            raise OSError("flap")
        return "ok"

    policy = RetryPolicy(max_attempts=10, base_s=0.0, max_backoff_s=0.0)
    assert policy.run(flaky, loop="t.flaky", retry_on=(OSError,)) == "ok"
    counter = metrics.registry()["ray_tpu_retries_total"]
    samples = dict(counter.samples())
    assert samples[(("loop", "t.flaky"),)] == 2.0


def test_retry_policy_non_retryable_escapes_immediately():
    calls = []

    def wrong():
        calls.append(1)
        raise ValueError("not transient")

    policy = RetryPolicy(max_attempts=5, base_s=0.0)
    with pytest.raises(ValueError):
        policy.run(wrong, loop="t.escape", retry_on=(OSError,))
    assert len(calls) == 1


def test_retry_policy_abort_hook():
    stop = threading.Event()
    stop.set()
    policy = RetryPolicy(max_attempts=100, base_s=0.0)
    calls = []

    def boom():
        calls.append(1)
        raise OSError("x")

    with pytest.raises(OSError):
        policy.run(boom, loop="t.abort", retry_on=(OSError,),
                   abort=stop.is_set)
    assert len(calls) == 1


def test_record_retry_exports_prometheus_text():
    from ray_tpu_torch.util import metrics
    record_retry("t.prom", 0.123)
    text = metrics.prometheus_text()
    assert "ray_tpu_retries_total" in text
    assert 'loop="t.prom"' in text
    assert "ray_tpu_retry_backoff_seconds_total" in text


# ---------------------------------------------------------------------------
# wired seams (cheap: no daemon cluster)
# ---------------------------------------------------------------------------

def test_rpc_server_recv_drop_times_out_then_recovers():
    """A dropped request vanishes on the wire: the caller times out,
    a retry goes through, and the hit log shows exactly one drop."""

    class Svc:
        def handle_echo(self, conn, rid, msg):
            return {"v": msg["v"]}

    rpc.declare("echo", "v")
    server = rpc.Server(Svc()).start()
    client = rpc.Client(server.addr, timeout=0.3)
    try:
        assert client.call("echo", v=1)["v"] == 1
        fp.activate("rpc.server.recv=drop:max=1")
        with pytest.raises(rpc.RpcError):
            client.call("echo", v=2)
        # convergence: the next attempt is not dropped
        assert client.call("echo", v=3)["v"] == 3
        assert fp.fire_count("rpc.server.recv") == 1
    finally:
        client.close()
        server.stop()


def test_rpc_client_send_drop_with_retry_policy_converges():
    class Svc:
        def handle_echo(self, conn, rid, msg):
            return {"v": msg["v"]}

    rpc.declare("echo", "v")
    server = rpc.Server(Svc()).start()
    client = rpc.Client(server.addr, timeout=0.2)
    try:
        fp.activate("rpc.client.send=drop:max=2")
        policy = RetryPolicy(max_attempts=5, base_s=0.0)
        out = policy.run(lambda: client.call("echo", v=7),
                         loop="t.rpc_drop", retry_on=(rpc.RpcError,))
        assert out["v"] == 7
        # exactly the configured drops fired before convergence
        assert fp.fire_count("rpc.client.send") == 2
        assert fp.hit_count("rpc.client.send") == 3
    finally:
        client.close()
        server.stop()


def test_worker_retry_seam_fires(ray_start_regular, tmp_path):
    """The worker.retry failpoint observes every task retry (wiring
    smoke for the retry seam + hit log assertions). The marker lives in
    tmp_path: the port makes its session dir only when something needs
    it."""
    fp.activate("worker.retry=delay(0)")
    state_dir = str(tmp_path)

    @ray_tpu.remote(max_retries=2, retry_exceptions=True)
    def flaky():
        import os
        marker = os.path.join(state_dir, "flaky_ran")
        if not os.path.exists(marker):
            open(marker, "w").close()
            raise RuntimeError("first attempt fails")
        return "done"

    assert ray_tpu.get(flaky.remote()) == "done"
    assert fp.fire_count("worker.retry") == 1
    log = fp.hit_log("worker.retry")
    assert log[0]["attempt"] == 0


def test_worker_retry_error_arm_fails_task(ray_start_regular):
    """An error arm on worker.retry converts a retryable failure into a
    terminal typed error (retry suppression)."""
    from ray_tpu_torch import exceptions as exc
    fp.activate("worker.retry=error()")

    @ray_tpu.remote(max_retries=5, retry_exceptions=True)
    def always_fails():
        raise RuntimeError("app error")

    with pytest.raises(exc.TaskError):
        ray_tpu.get(always_fails.remote())
    assert fp.fire_count("worker.retry") == 1


def test_fast_lane_ping_send_failure_is_typed_and_slot_free():
    """Regression (fast_lane.py ping): a send failure must pop the
    pending slot, mark the lane dead, and raise FastLaneError — not
    leak the slot and surface a raw OSError."""
    import socket

    from ray_tpu_torch._private import fast_lane as fle

    # a real listener so the client connects; we never accept frames
    srv = socket.create_server(("127.0.0.1", 0))
    client = fle.FastLaneClient(srv.getsockname())
    try:
        # arm the seam INSIDE _submit_op, which fires after the pending
        # slot is installed — so this actually exercises the
        # pop-on-send-failure cleanup (the bug leaked that slot)
        fp.activate("fast_lane.submit=error(OSError)")
        with pytest.raises(fle.FastLaneError):
            client.ping(timeout=0.5)
        assert client.dead
        assert not client._pending      # no leaked slot
        # a dead lane refuses further ops with the typed error
        with pytest.raises(fle.FastLaneError):
            client.submit(b"x")
    finally:
        client.close()
        srv.close()


def test_fast_lane_submit_failure_pops_slot():
    import socket

    from ray_tpu_torch._private import fast_lane as fle

    srv = socket.create_server(("127.0.0.1", 0))
    client = fle.FastLaneClient(srv.getsockname())
    try:
        fp.activate("fast_lane.submit=error(OSError)")
        with pytest.raises(fle.FastLaneError):
            client.submit(b"payload")
        assert client.dead
        assert not client._pending
    finally:
        client.close()
        srv.close()


def test_config_flag_activation(monkeypatch):
    """ray_tpu.init activates failpoints from the config flag."""
    fp.reset()
    rt = ray_tpu.init(num_nodes=1, resources={"CPU": 2},
                      _system_config={
                          "failpoints": "test.flag_seam=delay(0)",
                          "failpoints_seed": 5})
    try:
        assert fp.ENABLED
        fp.fire("test.flag_seam")
        assert fp.hit_count("test.flag_seam") == 1
    finally:
        ray_tpu.shutdown()


# ---------------------------------------------------------------------------
# seam registry coverage (raylint failpoint-registry contract: every
# wired seam name is unique, documented, and exercised here or in a
# deeper suite)
# ---------------------------------------------------------------------------

# The canonical seam catalogue: the port's counterparts of JAX's wired
# seams (tests/test_failpoints.py), held to the port's fire() sites by
# test_every_wired_seam_has_a_site_in_the_port.
WIRED_SEAMS = [
    "rpc.client.send",
    "rpc.client.recv",
    "rpc.server.recv",
    "fast_lane.submit",
    "fast_lane.ping",
    "fast_lane.reconnect",
    "cluster.lane_reconnect",
    "cluster.cancel",
    "daemon.lease",
    "daemon.push_task",
    "daemon.pull_transfer",
    "daemon.oom_check",
    "head.kv_put",
    "head.pubsub_publish",
    "head.respawn",
    "worker.retry",
    "worker.generator_stream",
    "drain.announce",
    "drain.migrate_object",
    "drain.deadline",
    "daemon.push_transfer",
    "shm.attach",
    "shm.seal",
    "batch.submit_flush",
    "batch.free_flush",
    "batch.result_flush",
    "trace.flush",
    "profile.flush",
    "arena.grant_reclaim",
    "arena.reservation_sweep",
    "net.link_drop",
    "net.partition_heal",
    "arena.spill",
    "arena.restore",
    "pressure.level",
    "admission.verdict",
    "tenancy.quota_sync",
]


def _fire_sites():
    """seam name -> the port's source files that fire it."""
    import pathlib
    import re
    root = pathlib.Path(__file__).resolve().parents[1] / "ray_tpu_torch"
    sites = {}
    for path in root.rglob("*.py"):
        text = path.read_text()
        for name in re.findall(r'\bfire\(\s*"([a-z_]+(?:\.[a-z_]+)+)"', text):
            sites.setdefault(name, set()).add(path.name)
    return sites


def test_every_wired_seam_has_a_site_in_the_port():
    """Each of JAX's 37 catalogued seams is fired somewhere in
    ``ray_tpu_torch/`` and no site fires a name outside the catalogue."""
    sites = _fire_sites()
    assert len(WIRED_SEAMS) == len(set(WIRED_SEAMS)) == 37
    assert sorted(sites) == sorted(WIRED_SEAMS), (
        set(WIRED_SEAMS) ^ set(sites))


def test_every_wired_seam_activates_and_fires():
    """One spec string arming EVERY wired seam parses, arms each name
    independently, and fires deterministically — a renamed seam that
    drifts from the catalogue shows up here (and in raylint) instead of
    silently never firing in a chaos schedule."""
    fp.activate(";".join(f"{name}=delay(0)" for name in WIRED_SEAMS))
    desc = fp.describe()
    assert sorted(desc) == sorted(WIRED_SEAMS)
    for name in WIRED_SEAMS:
        assert desc[name]["action"] == "delay"
        assert fp.fire(name) is None        # delay(0): benign arm
        assert fp.hit_count(name) == 1, name
        assert fp.fire_count(name) == 1, name


def test_rpc_client_recv_drop_loses_reply_then_recovers():
    """rpc.client.recv seam: a dropped incoming reply frame leaves the
    caller waiting (timeout), and the connection recovers afterwards."""

    class Svc:
        def handle_echo2(self, conn, rid, msg):
            return {"v": msg["v"]}

    rpc.declare("echo2", "v")
    server = rpc.Server(Svc()).start()
    client = rpc.Client(server.addr, timeout=0.3)
    try:
        assert client.call("echo2", v=1)["v"] == 1
        fp.activate("rpc.client.recv=drop:max=1")
        with pytest.raises(rpc.RpcError):
            client.call("echo2", v=2)
        assert client.call("echo2", v=3)["v"] == 3
        assert fp.fire_count("rpc.client.recv") == 1
    finally:
        client.close()
        server.stop()


def test_fast_lane_ping_drop_marks_lane_dead():
    """fast_lane.ping seam: the drop arm surfaces as the typed
    FastLaneError and marks the lane dead (health probes must never
    leak raw OSErrors into daemon stats paths)."""
    import socket

    from ray_tpu_torch._private import fast_lane as fle

    srv = socket.create_server(("127.0.0.1", 0))
    client = fle.FastLaneClient(srv.getsockname())
    try:
        fp.activate("fast_lane.ping=drop")
        with pytest.raises(fle.FastLaneError):
            client.ping(timeout=0.5)
        assert client.dead
        assert fp.fire_count("fast_lane.ping") == 1
    finally:
        client.close()
        srv.close()


def test_head_pubsub_publish_drop_starves_the_log():
    """head.pubsub_publish seam: a dropped publish never reaches the
    channel log (subscribers starve); the next publish lands."""
    from ray_tpu_torch._private.head import HeadService

    svc = HeadService()
    try:
        fp.activate("head.pubsub_publish=drop:max=1")
        svc._publish("t", {"kind": "lost"})
        svc._publish("t", {"kind": "kept"})
        with svc._lock:
            kinds = [e["kind"] for e in svc._events.get("t", [])]
        assert kinds == ["kept"]
        # both publishes HIT the seam; only the first FIRED (max=1)
        assert fp.hit_count("head.pubsub_publish") == 2
        assert fp.fire_count("head.pubsub_publish") == 1
    finally:
        svc._stop.set()


def test_drain_announce_drop_loses_the_notice():
    """drain.announce seam: the drop arm means the self-announced drain
    never reaches the head (the crash path is the backstop); without
    the arm the same announce lands as a DRAINING membership state."""
    from ray_tpu_torch._private.daemon import PreemptionWatcher
    from ray_tpu_torch._private.head import HeadService

    import types

    svc = HeadService()
    server = rpc.Server(svc).start()
    try:
        # register through the handler directly: an rpc.Client would
        # mark the node dead on disconnect (conn.meta fencing)
        svc.handle_register_node(
            types.SimpleNamespace(meta={}, link=lambda *a: None), 1,
            {"node_id": "n1", "resources": {}, "labels": {},
             "addr": ["127.0.0.1", 1]})

        fp.activate("drain.announce=drop")
        w = PreemptionWatcher("n1", server.addr, deadline_s=30.0)
        w.notify("preempted")
        w._announce()
        with svc._lock:
            assert not svc._nodes["n1"].draining   # notice lost
        assert fp.fire_count("drain.announce") == 1

        fp.reset()
        w2 = PreemptionWatcher("n1", server.addr, deadline_s=30.0)
        w2.notify("preempted")
        w2._announce()
        with svc._lock:
            assert svc._nodes["n1"].draining       # notice landed
    finally:
        svc._stop.set()
        server.stop()
