"""The port's network-chaos layer and partition fencing (copies of
``tests/test_netchaos.py``): the LinkPolicy registry contract (spec
grammar, seeded determinism, window and flap schedules, hit log, the
disarmed fast path), whole-frame behaviour on a real rpc Client/Server
pair, the driver's epoch and attempt fencing with fake result frames, the
head's epoch minting across a restart, and the timeout and monotonic-clock
audits of ``ray_tpu_torch/_private``.
"""

import ast
import os
import threading
import time

import pytest

from ray_tpu_torch._private import failpoints as fp
from ray_tpu_torch._private import netchaos as nc
from ray_tpu_torch._private import rpc

_PRIVATE = os.path.dirname(os.path.abspath(nc.__file__))


@pytest.fixture(autouse=True)
def _reset_chaos():
    yield
    nc.reset()
    fp.reset()


# ---------------------------------------------------------------------------
# registry / policy contract
# ---------------------------------------------------------------------------

def test_disarmed_by_default_and_zero_overhead(monkeypatch):
    """With RAY_TPU_NET_CHAOS unset the wire helpers must never consult
    the registry: the disarmed path is the pre-existing code path.
    Poisoning the registry proves no hook runs during a round trip."""
    assert not nc.ENABLED

    class _Poison:
        def apply(self, *a, **k):
            raise AssertionError("registry consulted while disarmed")

    monkeypatch.setattr(nc, "_registry", _Poison())

    class Svc:
        def handle_nc_echo(self, conn, rid, msg):
            return {"v": msg["v"]}

    rpc.declare("nc_echo", "v")
    server = rpc.Server(Svc()).start()
    client = rpc.Client(server.addr, timeout=2.0).link("daemon")
    try:
        assert client.call("nc_echo", v=5)["v"] == 5
    finally:
        client.close()
        server.stop()


def test_spec_grammar():
    pols = nc.parse_spec(
        "driver>daemon=drop=0.25:lat=10:jitter=5;"
        "daemon>head@n1=partition:start=500:dur=2000;"
        "a>b=flap=100/300:bw=1000;"
        "x>y=dup=0.5:sym")
    keys = [p.key for p in pols]
    assert keys == ["driver>daemon@*", "daemon>head@n1", "a>b@*",
                    "x>y@*", "y>x@*"]      # sym installs the mirror
    assert pols[0].drop_p == 0.25 and pols[0].lat_ms == 10.0
    assert pols[0].jitter_ms == 5.0
    assert pols[1].partition and pols[1].start_ms == 500.0
    assert pols[1].dur_ms == 2000.0
    assert pols[2].flap_on_ms == 100.0 and pols[2].flap_off_ms == 300.0
    assert pols[2].bw_bps == 1000.0
    assert pols[3].dup_p == 0.5 and pols[4].dup_p == 0.5
    with pytest.raises(ValueError):
        nc.parse_spec("no-arrow=drop=1")
    with pytest.raises(ValueError):
        nc.parse_spec("a>b=warp=9")


def test_seeded_drop_schedule_is_deterministic():
    def schedule(seed):
        reg = nc.Registry(seed)
        pol = nc.LinkPolicy("a", "b", drop_p=0.5)
        reg.install(pol)
        return [pol.decide(100, now=1.0)[0] == "drop"
                for _ in range(64)]

    first = schedule(42)
    assert schedule(42) == first
    assert any(first) and not all(first)    # actually probabilistic
    assert schedule(43) != first            # seed changes the draws


def test_per_link_rng_isolation():
    """One link's draws must not perturb another's (RNG derived from
    (seed, src>dst@link)) — schedules replay under interleaving."""
    def a_schedule(interleave):
        reg = nc.Registry(7)
        a = nc.LinkPolicy("a", "b", drop_p=0.5)
        b = nc.LinkPolicy("c", "d", drop_p=0.5)
        reg.install(a)
        reg.install(b)
        out = []
        for _ in range(32):
            out.append(a.decide(10, now=0.0)[0] == "drop")
            if interleave:
                b.decide(10, now=0.0)
        return out

    assert a_schedule(False) == a_schedule(True)


def test_window_start_dur_and_heal_transition():
    pol = nc.LinkPolicy("a", "b", partition=True,
                        start_ms=500.0, dur_ms=2000.0)
    t0 = 100.0
    # before the window opens: clean, no heal
    assert pol.decide(10, now=t0) == (None, 0.0, False)
    assert pol.decide(10, now=t0 + 0.2) == (None, 0.0, False)
    # inside the window: hard partition
    assert pol.decide(10, now=t0 + 0.6)[0] == "drop"
    assert pol.decide(10, now=t0 + 2.0)[0] == "drop"
    # window elapsed: clean again, heal reported exactly once
    assert pol.decide(10, now=t0 + 3.0) == (None, 0.0, True)
    assert pol.decide(10, now=t0 + 3.1) == (None, 0.0, False)


def test_flap_schedule_cycles():
    pol = nc.LinkPolicy("a", "b", partition=True,
                        flap_on_ms=100.0, flap_off_ms=300.0)
    t0 = 50.0
    pattern = [pol.decide(1, now=t0 + ms / 1000.0)[0]
               for ms in (0, 50, 150, 250, 350, 450, 550, 850)]
    # 100ms on / 300ms off, measured from first consult
    assert pattern == ["drop", "drop", None, None, None,
                       "drop", None, "drop"]


def test_bandwidth_and_latency_delay():
    pol = nc.LinkPolicy("a", "b", lat_ms=20.0, bw_bps=10000.0)
    effect, delay_s, healed = pol.decide(500, now=1.0)
    assert effect is None and not healed
    assert delay_s == pytest.approx(0.02 + 500 / 10000.0)
    assert pol.delays == 1


def test_partition_heal_seam_fires():
    fp.activate("net.partition_heal=delay(0);net.link_drop=delay(0)")
    reg = nc.activate("a>b=partition:dur=100")
    pol_now = time.monotonic()
    assert reg.apply("a", "b", "*", 10) is nc.DROP_FRAME
    assert fp.fire_count("net.link_drop") == 1
    # force the window shut, then one more consult reports the heal
    with reg._lock:
        reg._policies[0].first_use = pol_now - 10.0
    assert reg.apply("a", "b", "*", 10) is None
    assert fp.fire_count("net.partition_heal") == 1
    log = fp.hit_log("net.link_drop")
    assert log[0]["src"] == "a" and log[0]["dst"] == "b"


def test_hit_log_and_injected_counters():
    nc.activate("a>b=drop=1.0")
    reg = nc._registry
    for _ in range(3):
        reg.apply("a", "b", "*", 64)
    reg.apply("other", "b", "*", 64)        # no match: clean
    assert nc.injected_count("drop") == 3
    assert nc.injected_count() == 3
    entries = [e for e in rpc.wire_metric_entries()
               if e["name"] == "ray_tpu_link_chaos_injected_total"]
    assert entries and entries[0]["samples"] == [[[["effect", "drop"]], 3]]
    log = nc.hit_log("a>b@*")
    assert len(log) == 3
    assert all(e["effect"] == "drop" and e["nbytes"] == 64 for e in log)


def test_config_flag_activation_exports_env():
    class _Cfg:
        net_chaos = "driver>daemon=drop=0.1"
        net_chaos_seed = 9

    try:
        nc.maybe_activate_from_config(_Cfg())
        assert nc.ENABLED
        assert os.environ["RAY_TPU_NET_CHAOS"] == _Cfg.net_chaos
        assert os.environ["RAY_TPU_NET_CHAOS_SEED"] == "9"
    finally:
        nc.reset()
    assert "RAY_TPU_NET_CHAOS" not in os.environ
    assert not nc.ENABLED


# ---------------------------------------------------------------------------
# frame-level behavior on a real rpc pair
# ---------------------------------------------------------------------------

class _CountingSvc:
    def __init__(self):
        self.calls = 0

    def handle_nc_count(self, conn, rid, msg):
        self.calls += 1
        return {"v": msg["v"]}


rpc.declare("nc_count", "v")


def _pair(svc, timeout=0.5, local_role="t", peer_role="svc"):
    server = rpc.Server(svc).start()
    client = rpc.Client(server.addr, timeout=timeout)
    # per-socket role override: this test process plays role ``t``
    nc.register_link(client._sock, peer_role, local_role=local_role)
    return server, client


def test_one_way_partition_request_direction():
    """t>svc partition: requests vanish, the handler never runs, the
    caller gets a TYPED timeout (never a wedged thread)."""
    svc = _CountingSvc()
    server, client = _pair(svc)
    try:
        assert client.call("nc_count", v=1)["v"] == 1
        nc.activate("t>svc=partition")
        with pytest.raises(rpc.RpcError):
            client.call("nc_count", v=2)
        assert svc.calls == 1               # request never arrived
        assert nc.injected_count("drop") >= 1
        nc.reset()
        assert client.call("nc_count", v=3)["v"] == 3   # link healed
    finally:
        client.close()
        server.stop()


def test_one_way_partition_reply_direction():
    """svc>t partition (the REVERSE edge): the request goes through and
    EXECUTES — only the reply is lost. This is the half-open failure
    fencing exists for: work ran, the caller saw a timeout."""
    svc = _CountingSvc()
    server, client = _pair(svc)
    try:
        nc.activate("svc>t=partition")
        with pytest.raises(rpc.RpcError):
            client.call("nc_count", v=1)
        deadline = time.monotonic() + 2.0
        while svc.calls == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert svc.calls == 1               # the handler DID run
    finally:
        client.close()
        server.stop()


def test_symmetric_partition_blocks_both_directions():
    svc = _CountingSvc()
    server, client = _pair(svc)
    try:
        nc.activate("t>svc=partition:sym")
        with pytest.raises(rpc.RpcError):
            client.call("nc_count", v=1)
        assert svc.calls == 0
    finally:
        client.close()
        server.stop()


def test_duplicate_delivery_is_suppressed_at_the_caller():
    """dup=1.0 delivers every request frame twice: the handler runs
    twice (the wire really duplicated), but the caller observes exactly
    one reply — the second reply's rid finds no pending slot."""
    svc = _CountingSvc()
    server, client = _pair(svc, timeout=2.0)
    try:
        nc.activate("t>svc=dup=1.0")
        assert client.call("nc_count", v=7)["v"] == 7
        deadline = time.monotonic() + 2.0
        while svc.calls < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert svc.calls == 2
        assert nc.injected_count("dup") >= 1
    finally:
        client.close()
        server.stop()


def test_latency_policy_delays_round_trip():
    svc = _CountingSvc()
    server, client = _pair(svc, timeout=5.0)
    try:
        nc.activate("t>svc=lat=60")
        t0 = time.monotonic()
        assert client.call("nc_count", v=1)["v"] == 1
        assert time.monotonic() - t0 >= 0.055
    finally:
        client.close()
        server.stop()


# ---------------------------------------------------------------------------
# epoch / attempt fencing (fake frames against a real DaemonHandle)
# ---------------------------------------------------------------------------

class _NullSvc:
    def handle_nc_never(self, conn, rid, msg):
        return rpc.HOLD     # park forever: the reply is never sent


rpc.declare("nc_never")


def _fresh_handle():
    from ray_tpu_torch._private.cluster import ArenaCache, DaemonHandle
    from ray_tpu_torch._private.ids import NodeID
    server = rpc.Server(_NullSvc()).start()
    handle = DaemonHandle(NodeID.from_random(), server.addr, None,
                          ArenaCache())
    handle._fence_supported = True
    return server, handle


def _fenced_total(kind):
    from ray_tpu_torch.util import metrics
    text = metrics.prometheus_text()
    for line in text.splitlines():
        if (line.startswith("ray_tpu_fenced_results_total")
                and f'kind="{kind}"' in line):
            return float(line.rsplit(" ", 1)[1])
    return 0.0


def test_stale_epoch_frame_is_fenced():
    server, handle = _fresh_handle()
    try:
        handle.epoch = 2
        slot = [threading.Event(), None, 0]
        handle._batch_waiters["t1"] = slot
        before = _fenced_total("epoch")
        # epoch 1 outcome from the superseded incarnation: fenced, and
        # the waiter stays armed for the live incarnation's outcome
        handle._ingest_batch([{"task": "t1", "ep": 1, "att": 0,
                               "outcome": "ok"}])
        assert not slot[0].is_set()
        assert "t1" in handle._batch_waiters
        assert _fenced_total("epoch") == before + 1
        # the live epoch's outcome resolves normally
        handle._ingest_batch([{"task": "t1", "ep": 2, "att": 0,
                               "outcome": "ok"}])
        assert slot[0].is_set() and slot[1]["ep"] == 2
        assert "t1" not in handle._batch_waiters
    finally:
        handle.mark_dead()
        server.stop()


def test_stale_attempt_outcome_is_fenced():
    server, handle = _fresh_handle()
    try:
        handle.epoch = 1
        slot = [threading.Event(), None, 1]     # live attempt = 1
        handle._batch_waiters["t2"] = slot
        before = _fenced_total("attempt")
        handle._ingest_batch([{"task": "t2", "ep": 1, "att": 0,
                               "outcome": "ok"}])
        assert not slot[0].is_set()             # attempt 0 replay fenced
        assert _fenced_total("attempt") == before + 1
        handle._ingest_batch([{"task": "t2", "ep": 1, "att": 1,
                               "outcome": "ok"}])
        assert slot[0].is_set() and slot[1]["att"] == 1
    finally:
        handle.mark_dead()
        server.stop()


def test_unfenced_daemon_frames_pass_through():
    """Frames from a pre-fence daemon carry no stamps and must resolve
    exactly as before (capability negotiation keeps old peers working).
    Frames are also never fenced when the hello lacked the capability,
    even if something resembling a stamp appears."""
    server, handle = _fresh_handle()
    try:
        handle._fence_supported = False
        handle.epoch = 5
        slot = [threading.Event(), None, 1]
        handle._batch_waiters["t3"] = slot
        handle._ingest_batch([{"task": "t3", "ep": 1, "outcome": "ok"}])
        assert slot[0].is_set()
    finally:
        handle.mark_dead()
        server.stop()


def test_stale_stream_push_is_fenced():
    server, handle = _fresh_handle()
    try:
        handle.epoch = 3

        class _Q:
            def __init__(self):
                self.items = []

            def put(self, x):
                self.items.append(x)

        class _Stream:
            def __init__(self):
                self.q = _Q()

        stream = _Stream()
        handle._streams["s1"] = stream
        handle._on_push("task_yield", {"task": "s1", "ep": 2, "v": 1})
        assert stream.q.items == []         # stale incarnation: dropped
        handle._on_push("task_yield", {"task": "s1", "ep": 3, "v": 2})
        assert len(stream.q.items) == 1
    finally:
        handle._streams.clear()
        handle.mark_dead()
        server.stop()


def test_late_stamped_frame_after_death_counts_dead():
    server, handle = _fresh_handle()
    try:
        handle.epoch = 1
        handle.mark_dead()
        before = _fenced_total("dead")
        handle._ingest_batch([{"task": "tX", "ep": 1, "att": 0,
                               "outcome": "ok"}])
        assert _fenced_total("dead") == before + 1
    finally:
        server.stop()


def test_mark_dead_fails_inflight_rpc():
    """Timeout audit: a one-way partition leaves classic timeout=None
    callers blocked — mark_dead (driven by the head's death-mark) must
    fail them with a typed error instead of wedging the thread."""
    from ray_tpu_torch._private.cluster import DaemonCrashed
    server, handle = _fresh_handle()
    try:
        got = {}

        def call():
            try:
                handle._call("nc_never")    # no handler: blocks forever
            except (DaemonCrashed, rpc.RpcError, rpc.RemoteError) as e:
                got["err"] = e

        t = threading.Thread(target=call, daemon=True)
        t.start()
        time.sleep(0.2)                     # let the call get in flight
        handle.mark_dead()
        t.join(timeout=3.0)
        assert not t.is_alive()
        assert isinstance(got.get("err"), DaemonCrashed)
    finally:
        server.stop()


# ---------------------------------------------------------------------------
# head-side epoch minting + persistence
# ---------------------------------------------------------------------------

class _FakeConn:
    def __init__(self):
        self.meta = {}

    def link(self, *a, **kw):
        return self


def _register(svc, node_id="n1"):
    return svc.handle_register_node(
        _FakeConn(), 0, {"node_id": node_id,
                         "resources": {"CPU": 1.0}, "labels": {},
                         "addr": ["127.0.0.1", 1]})


def test_head_mints_monotonic_epochs(tmp_path):
    from ray_tpu_torch._private.head import HeadService
    path = str(tmp_path / "head_state.db")
    svc = HeadService(state_path=path)
    try:
        out1 = _register(svc)
        out2 = _register(svc)
        assert out1["epoch"] == 1 and out2["epoch"] == 2
        # stale-epoch heartbeat: the zombie incarnation is told to exit
        # and must NOT refresh the live incarnation's liveness
        beat = svc.handle_heartbeat(
            _FakeConn(), 0, {"node_id": "n1", "epoch": 1,
                             "available": {"CPU": 1.0}, "wall_ts": 0.0})
        assert beat.get("dead") and beat.get("stale_epoch")
        live = svc.handle_heartbeat(
            _FakeConn(), 0, {"node_id": "n1", "epoch": 2,
                             "available": {"CPU": 1.0}, "wall_ts": 0.0})
        assert live.get("ok")
    finally:
        svc._stop.set()

    # epochs survive a head restart: the next mint is STRICTLY higher
    svc2 = HeadService(state_path=path)
    try:
        assert _register(svc2)["epoch"] == 3
    finally:
        svc2._stop.set()


def test_membership_view_carries_epoch(tmp_path):
    from ray_tpu_torch._private.head import HeadService
    svc = HeadService(state_path=str(tmp_path / "h.db"))
    try:
        _register(svc, "nA")
        view = svc._nodes["nA"].view()
        assert view["epoch"] == 1
    finally:
        svc._stop.set()


# ---------------------------------------------------------------------------
# audits: unbounded control-plane round trips + wall-clock liveness
# ---------------------------------------------------------------------------

# Every explicit `timeout=None` .call/._call round trip in
# ray_tpu/_private must be justified here. Entries are
# (file, method-or-None-for-dynamic): a new unbounded site fails this
# test; so does removing one (keep the list honest).
_UNBOUNDED_ALLOWLIST = {
    # (JAX's ("cluster.py", "submit_task") entry has no counterpart: the
    # port's classic submit_task is acked at once and its outcome rides
    # the result pump, through DaemonHandle._call below)
    # DaemonHandle._call forwards arbitrary methods, some of which
    # (classic submit) are task-duration; same death-mark bound
    ("cluster.py", None),
    # daemon -> driver core_op forwarding: object-availability waits
    # are data-dependent (ray.get semantics); the owner connection's
    # reader exit fails all pending slots on transport death
    ("daemon.py", "core_op"),
    # head pubsub long-poll: parks at the head until an event arrives,
    # unbounded by design; subscriber threads are torn down via close()
    ("head.py", "subscribe"),
}


def _call_sites_with_timeout_none(path):
    """(file, first-positional-literal-or-None) for every X.call/_call
    with an explicit timeout=None keyword."""
    with open(path, "r", encoding="utf-8") as f:
        tree = ast.parse(f.read())
    sites = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        if not (isinstance(func, ast.Attribute)
                and func.attr in ("call", "_call")):
            continue
        has_none = any(
            kw.arg == "timeout" and isinstance(kw.value, ast.Constant)
            and kw.value.value is None for kw in node.keywords)
        if not has_none:
            continue
        method = None
        if node.args and isinstance(node.args[0], ast.Constant):
            method = node.args[0].value
        sites.add((os.path.basename(path), method))
    return sites


def test_no_unbounded_control_plane_round_trips():
    found = set()
    for name in sorted(os.listdir(_PRIVATE)):
        if name.endswith(".py"):
            found |= _call_sites_with_timeout_none(
                os.path.join(_PRIVATE, name))
    assert found == _UNBOUNDED_ALLOWLIST, (
        f"unjustified timeout=None round trips: "
        f"{found - _UNBOUNDED_ALLOWLIST}; "
        f"stale allowlist entries: {_UNBOUNDED_ALLOWLIST - found}")


def test_liveness_paths_never_compare_wall_clock():
    """head.py/daemon.py liveness (heartbeat expiry, drain deadlines)
    must compare time.monotonic(), never time.time(): a wall-clock step
    (NTP slew, VM migration) must not mass-expire heartbeats. Wall
    clock is allowed in arithmetic (clock-offset estimates, persisted
    deadlines) but never inside a comparison."""
    def wall_compares(path):
        with open(path, "r", encoding="utf-8") as f:
            tree = ast.parse(f.read())
        bad = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.Compare):
                continue
            for sub in ast.walk(node):
                if (isinstance(sub, ast.Call)
                        and isinstance(sub.func, ast.Attribute)
                        and sub.func.attr == "time"
                        and isinstance(sub.func.value, ast.Name)
                        and sub.func.value.id == "time"):
                    bad.append(node.lineno)
        return bad

    for name in ("head.py", "daemon.py"):
        assert wall_compares(os.path.join(_PRIVATE, name)) == [], name
