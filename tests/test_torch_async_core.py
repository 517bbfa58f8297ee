"""The port's asyncio control-plane core (``cfg().async_core``, the
default): copies of ``tests/test_async_core.py``'s loop-affinity sanitizer,
coalesced-write, mixed-cluster hello, lag-watchdog and registry re-attach
tests against ``ray_tpu_torch``, its failpoint and netchaos parity tests
(the threaded core's seam names, chaos below the frame layer, delays on
``call_later`` chains), and the capability table held against a live hello
reply, and the registry-pollution pair run back to back.
"""

import os
import subprocess
import sys
import time

import pytest

import ray_tpu_torch as rt_api
from ray_tpu_torch._private import eventloop, rpc
from ray_tpu_torch._private.aio import AsyncClient, AsyncServer, _WriteBatcher


# ---------------------------------------------------------------------------
# loop-affinity sanitizer
# ---------------------------------------------------------------------------

def test_assert_loop_sanitizer(monkeypatch):
    """Armed by lock_sanitizer: loop-only code on a plain thread raises;
    the same check ON the loop passes; disarmed it is a no-op."""
    from ray_tpu_torch._private import config
    monkeypatch.setenv("RAY_TPU_LOCK_SANITIZER", "1")
    config.reset()
    try:
        eventloop.get_loop()    # the loop thread must exist to compare to
        with pytest.raises(RuntimeError, match="call_soon_threadsafe"):
            eventloop.assert_loop("test handler")

        async def on_loop_ok():
            eventloop.assert_loop("test handler")
            return True

        assert eventloop.run_coro(on_loop_ok(), timeout=5.0)
    finally:
        monkeypatch.delenv("RAY_TPU_LOCK_SANITIZER")
        config.reset()
    eventloop.assert_loop("disarmed")   # sanitizer off: no raise


# ---------------------------------------------------------------------------
# coalesced writes
# ---------------------------------------------------------------------------

class _FakeLoop:
    """Synchronous stand-in: callbacks run when the test drains them."""

    def __init__(self):
        self.pending = []

    def call_soon(self, fn, *args):
        self.pending.append((fn, args))

    def call_later(self, delay, fn, *args):
        self.pending.append((fn, args))

    def time(self):
        return 0.0

    def drain(self):
        while self.pending:
            fn, args = self.pending.pop(0)
            fn(*args)


class _FakeTransport:
    def __init__(self):
        self.chunks = []

    def is_closing(self):
        return False

    def write(self, data):
        self.chunks.append(bytes(data))


def test_write_batcher_coalesces_small_frames():
    """N frames staged in one loop iteration leave in ONE write."""
    loop, transport = _FakeLoop(), _FakeTransport()
    b = _WriteBatcher(loop, transport, object())
    blobs = [bytes([i]) * (i + 1) for i in range(5)]
    for blob in blobs:
        b.send(blob)
    assert transport.chunks == []       # nothing written until the flush
    loop.drain()
    assert b.frames == 5
    assert b.writes == 1
    assert transport.chunks == [
        b"".join(rpc._LEN.pack(len(x)) + x for x in blobs)]


def test_write_batcher_big_payload_skips_join_copy():
    """A frame over SEND_CONCAT_MAX never rides the join: the pending small
    run flushes first (stream order holds), then header and payload go as
    writes of their own."""
    loop, transport = _FakeLoop(), _FakeTransport()
    b = _WriteBatcher(loop, transport, object())
    big = b"B" * (rpc.SEND_CONCAT_MAX + 1)
    b.send(b"s1")
    b.send(big)
    b.send(b"s2")
    loop.drain()
    assert b.frames == 3
    assert transport.chunks == [
        rpc._LEN.pack(2) + b"s1",       # the small run before the big one
        rpc._LEN.pack(len(big)),        # the big header, a write of its own
        big,                            # the big payload, no join copy
        rpc._LEN.pack(2) + b"s2"]       # the trailing small run


# ---------------------------------------------------------------------------
# the async wire against the threaded one: frames are byte-identical
# ---------------------------------------------------------------------------

rpc.declare("ac_echo", "v")


class _EchoSvc:
    def __init__(self):
        self.calls = 0

    def handle_ac_echo(self, conn, rid, msg):
        self.calls += 1
        return {"v": msg["v"]}


@pytest.mark.parametrize("server_core", ["async", "threaded"])
def test_cores_interoperate_on_one_socket(server_core):
    """An async client against either server core, and a threaded client
    against the async server: same replies, unplain frames refused."""
    server = (AsyncServer(_EchoSvc()) if server_core == "async"
              else rpc.Server(_EchoSvc())).start()
    clients = [AsyncClient(server.addr, timeout=5.0),
               rpc.Client(server.addr, timeout=5.0)]
    try:
        for client in clients:
            assert client.call("ac_echo", v=[1, b"x", {"k": 2.5}])["v"] == \
                [1, b"x", {"k": 2.5}]
            with pytest.raises(rpc.RpcError, match="plain data"):
                client.call("ac_echo", v=object())
    finally:
        for client in clients:
            client.close()
        server.stop()


# ---------------------------------------------------------------------------
# failpoint parity on the async wire (the threaded core's seam names)
# ---------------------------------------------------------------------------

@pytest.fixture
def chaos_reset():
    from ray_tpu_torch._private import failpoints as fp
    from ray_tpu_torch._private import netchaos as nc
    yield fp, nc
    nc.reset()
    fp.reset()


def _async_pair(svc, timeout=0.5, chaos_roles=None):
    from ray_tpu_torch._private import netchaos as nc
    server = AsyncServer(svc).start()
    client = AsyncClient(server.addr, timeout=timeout)
    if chaos_roles:
        local_role, peer_role = chaos_roles
        nc.register_link(client._sock, peer_role, local_role=local_role)
    return server, client


def test_failpoint_server_recv_drop_parity(chaos_reset):
    fp, _ = chaos_reset
    svc = _EchoSvc()
    server, client = _async_pair(svc, timeout=0.3)
    try:
        assert client.call("ac_echo", v=1)["v"] == 1
        fp.activate("rpc.server.recv=drop:max=1")
        with pytest.raises(rpc.RpcError):
            client.call("ac_echo", v=2)
        assert client.call("ac_echo", v=3)["v"] == 3
        assert fp.fire_count("rpc.server.recv") == 1
    finally:
        client.close()
        server.stop()


def test_failpoint_client_send_drop_parity(chaos_reset):
    fp, _ = chaos_reset
    svc = _EchoSvc()
    server, client = _async_pair(svc, timeout=0.2)
    try:
        fp.activate("rpc.client.send=drop:max=1")
        with pytest.raises(rpc.RpcError):
            client.call("ac_echo", v=1)
        assert client.call("ac_echo", v=2)["v"] == 2
        assert fp.fire_count("rpc.client.send") == 1
    finally:
        client.close()
        server.stop()


# ---------------------------------------------------------------------------
# netchaos parity on the async wire (below the frame layer; the loop never
# sleeps, delays ride call_later chains)
# ---------------------------------------------------------------------------

def test_netchaos_partition_and_heal_parity(chaos_reset):
    _, nc = chaos_reset
    svc = _EchoSvc()
    server, client = _async_pair(svc, chaos_roles=("t", "svc"))
    try:
        assert client.call("ac_echo", v=1)["v"] == 1
        nc.activate("t>svc=partition")
        with pytest.raises(rpc.RpcError):
            client.call("ac_echo", v=2)
        assert svc.calls == 1           # request never arrived
        assert nc.injected_count("drop") >= 1
        nc.reset()
        assert client.call("ac_echo", v=3)["v"] == 3    # link healed
    finally:
        client.close()
        server.stop()


def test_netchaos_duplicate_suppressed_at_caller_parity(chaos_reset):
    _, nc = chaos_reset
    svc = _EchoSvc()
    server, client = _async_pair(svc, timeout=2.0,
                                 chaos_roles=("t", "svc"))
    try:
        nc.activate("t>svc=dup=1.0")
        assert client.call("ac_echo", v=7)["v"] == 7
        deadline = time.monotonic() + 2.0
        while svc.calls < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert svc.calls == 2           # the wire really duplicated
        assert nc.injected_count("dup") >= 1
    finally:
        client.close()
        server.stop()


def test_netchaos_latency_delays_without_blocking_loop(chaos_reset):
    """lat=120 delays the round trip, but a SECOND connection's traffic
    must not stall behind it: the delay is a call_later chain on the
    chaotic link, not a sleep on the shared loop."""
    import threading
    _, nc = chaos_reset
    svc = _EchoSvc()
    server, client = _async_pair(svc, timeout=5.0,
                                 chaos_roles=("t", "svc"))
    clean = AsyncClient(server.addr, timeout=5.0)   # no chaos role
    try:
        nc.activate("t>svc=lat=120")
        done = {}

        def slow():
            t0 = time.monotonic()
            out = client.call("ac_echo", v=1)
            done["slow"] = (time.monotonic() - t0, out["v"])

        th = threading.Thread(target=slow)
        th.start()
        time.sleep(0.01)                # slow call is now in flight
        t0 = time.monotonic()
        assert clean.call("ac_echo", v=2)["v"] == 2
        clean_elapsed = time.monotonic() - t0
        th.join(timeout=5.0)
        assert done["slow"][0] >= 0.110 and done["slow"][1] == 1
        # the clean link did not pay the chaotic link's delay
        assert clean_elapsed < 0.110
    finally:
        client.close()
        clean.close()
        server.stop()


def test_blocking_call_raises_on_the_loop():
    """AsyncClient.call and run_coro on the loop thread raise instead of
    deadlocking the wire they wait on."""
    server = AsyncServer(_EchoSvc()).start()
    client = AsyncClient(server.addr, timeout=5.0)
    try:
        async def on_loop():
            errors = []
            for fn in (lambda: client.call("ac_echo", v=1),
                       lambda: eventloop.run_coro(on_loop_nop())):
                try:
                    fn()
                except RuntimeError as e:
                    errors.append(str(e))
            return errors

        async def on_loop_nop():
            return None

        errors = eventloop.run_coro(on_loop(), timeout=5.0)
        assert len(errors) == 2 and "event loop" in errors[0]
        assert client.call("ac_echo", v=7)["v"] == 7
    finally:
        client.close()
        server.stop()


# ---------------------------------------------------------------------------
# mixed-cluster interop through the hello bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("daemon_core", ["0", "1"])
def test_mixed_cluster_hello_bit(monkeypatch, daemon_core):
    """Daemon processes inherit RAY_TPU_ASYNC_CORE from the driver's
    environment; the driver's own core is pinned the opposite way through
    _system_config (which wins locally and is not inherited). Both mixes
    run tasks, and the hello bit reports the daemon's actual core."""
    monkeypatch.setenv("RAY_TPU_ASYNC_CORE", daemon_core)
    driver_async = daemon_core == "0"   # always the opposite core
    rt = rt_api.init(num_nodes=1, resources={"CPU": 2}, cluster="daemons",
                     object_store_memory=64 << 20,
                     _system_config={"async_core": driver_async})
    try:
        handles = list(rt.cluster_backend.daemons.values())
        assert len(handles) == 1
        assert handles[0]._async_core_remote is (daemon_core == "1")
        want = "async" if daemon_core == "1" else "threaded"
        peers = rt.cluster_backend.describe_peers()
        assert any(f"core={want}" in line for line in peers)
        assert "loop=" in rt.debug_state()

        @rt_api.remote
        def f(x):
            return x + 1

        assert rt_api.get([f.remote(i) for i in range(8)],
                          timeout=60) == list(range(1, 9))
    finally:
        rt_api.shutdown()


def test_capability_table_matches_the_hello_reply(monkeypatch):
    """Every bit of ``capabilities.CAPABILITY_FLAGS`` is in a live hello
    reply, and its guard attribute exists on ``DaemonHandle`` and reads
    the reply's value."""
    from ray_tpu_torch._private.capabilities import CAPABILITY_FLAGS
    monkeypatch.delenv("RAY_TPU_ASYNC_CORE", raising=False)
    rt = rt_api.init(num_nodes=1, resources={"CPU": 1}, cluster="daemons",
                     object_store_memory=64 << 20)
    try:
        handle = next(iter(rt.cluster_backend.daemons.values()))
        reply = handle.client.call(
            "hello_driver", owner_addr=list(
                rt.cluster_backend.owner_server.addr),
            job_id=__import__("pickle").dumps(rt.job_id),
            namespace=rt.namespace, sys_path=[])
        assert CAPABILITY_FLAGS
        for bit, spec in CAPABILITY_FLAGS.items():
            assert spec["kind"] == "hello"
            assert bit in reply, bit
            assert hasattr(handle, spec["guard"]), spec["guard"]
            assert getattr(handle, spec["guard"]) == bool(reply[bit]), bit
    finally:
        rt_api.shutdown()


@pytest.mark.parametrize("core", [True, False], ids=["async", "threaded"])
def test_resources_are_back_when_the_get_returns(core):
    """On either core a finished task's resources are back in the ledger
    by the time its get returns (the asyncio core's loop must not hold the
    release for its next pass)."""
    rt_api.init(num_nodes=1, resources={"CPU": 2},
                _system_config={"async_core": core})
    try:
        f = rt_api.remote(_in_process=True)(lambda: 1)
        for _ in range(100):
            rt_api.get(f.remote())
            assert rt_api.available_resources()["CPU"] == 2.0
    finally:
        rt_api.shutdown()


# ---------------------------------------------------------------------------
# loop-lag gauge + slow-callback watchdog
# ---------------------------------------------------------------------------

def test_loop_lag_gauge_and_watchdog(monkeypatch):
    """Blocking the loop past loop_slow_callback_s surfaces in the lag
    gauge and bumps the slow-callback counter, without asyncio debug mode
    (the always-on probe leg of the watchdog)."""
    from ray_tpu_torch._private import config
    from ray_tpu_torch.util import metrics
    monkeypatch.setenv("RAY_TPU_LOOP_LAG_PROBE_S", "0.02")
    monkeypatch.setenv("RAY_TPU_LOOP_SLOW_CALLBACK_S", "0.01")
    config.reset()
    eventloop.shutdown_for_tests()      # a fresh loop with this config
    try:
        eventloop.set_proc_label("lagtest")
        loop = eventloop.get_loop()
        loop.call_soon_threadsafe(time.sleep, 0.1)  # stall the loop
        deadline = time.monotonic() + 5.0
        hits = 0.0
        while time.monotonic() < deadline:
            counter = metrics.registry().get(
                "ray_tpu_event_loop_slow_callbacks_total")
            if counter is not None:
                hits = sum(v for k, v in counter.samples()
                           if ("proc", "lagtest") in k)
                if hits >= 1:
                    break
            time.sleep(0.02)
        assert hits >= 1, "a stalled loop never hit the watchdog counter"
        gauge = metrics.registry().get("ray_tpu_event_loop_lag_seconds")
        assert gauge is not None and any(
            ("proc", "lagtest") in k for k, _ in gauge.samples())
    finally:
        eventloop.shutdown_for_tests()  # next get_loop: default config
        monkeypatch.delenv("RAY_TPU_LOOP_LAG_PROBE_S")
        monkeypatch.delenv("RAY_TPU_LOOP_SLOW_CALLBACK_S")
        config.reset()
        eventloop.set_proc_label("")


# ---------------------------------------------------------------------------
# metric-registry re-attach
# ---------------------------------------------------------------------------

def test_metric_write_survives_registry_clear():
    """A module that cached a Metric instance before clear_registry() must
    not write into the void: the next write re-attaches the instance to
    the live registry."""
    from ray_tpu_torch.util import metrics
    c = metrics.Counter("pollution_pin_total", "pin")
    c.inc(1)
    metrics.clear_registry()            # orphans the cached instance
    try:
        c.inc(2)                        # must re-attach, not vanish
        assert "pollution_pin_total 3.0" in metrics.prometheus_text()
    finally:
        metrics.clear_registry()


@pytest.mark.slow
def test_polluting_pair_back_to_back():
    """The original failure order, pinned end to end: an observability
    test that clears the registry, then the tenancy test asserting
    ray_tpu_admission_total appears in the exposition — back to back
    in one fresh interpreter, no other tests in between."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q",
         "-p", "no:cacheprovider", "-p", "no:randomly",
         "tests/test_torch_observability.py::test_prometheus_label_escaping",
         "tests/test_torch_tenancy.py::"
         "test_queued_is_delayed_never_lost_and_resumes"],
        cwd=repo, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
