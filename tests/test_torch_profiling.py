"""The port's cluster-wide profiling and lock-contention meters (copies of
``tests/test_profiling.py`` against ``ray_tpu_torch``): the sampler
(collapse format, thread attribution, burst and continuous, pruning), the
daemon's heartbeat gate, ``MeteredLock``'s wait and hold histograms, the
queue-dwell gauges, and the 2-node federation path (daemon profiles at the
head, ``cluster_profile``'s merged speedscope view, lock, queue and arena
metrics in the federated exposition, with each daemon's first two profile
flushes dropped at the ``profile.flush`` seam).
"""

import json
import threading
import time
from collections import Counter

import pytest

import ray_tpu_torch as rt_api
from ray_tpu_torch.util import profiling


# ---------------------------------------------------------------------------
# sampler units
# ---------------------------------------------------------------------------

def test_collapse_format_and_thread_attribution():
    """A burst attributes a parked thread's stack to its NAME, frames
    collapsed leaf-last as ``thread;file:func;...`` (FlameGraph
    format)."""
    stop = threading.Event()

    def _parked_beacon():
        stop.wait(10.0)

    t = threading.Thread(target=_parked_beacon, daemon=True,
                         name="prof-beacon")
    t.start()
    try:
        rec = profiling.burst_record("unit", duration_s=0.2, hz=50.0)
    finally:
        stop.set()
        t.join()
    assert rec["proc"] == "unit" and rec["mode"] == "burst"
    assert rec["samples"] > 0 and rec["counts"]
    beacon = [s for s in rec["counts"] if s.startswith("prof-beacon;")]
    assert beacon, f"no stack attributed to the beacon: {rec['counts']}"
    # leaf-last ordering: the parked function is the innermost frame
    assert any("test_profiling.py:_parked_beacon" in s.split(";")[-2]
               or "_parked_beacon" in s for s in beacon)
    for stack in rec["counts"]:
        for tok in stack.split(";")[1:]:
            assert ":" in tok or tok == profiling.PRUNED_STACK


def test_prune_caps_stacks_and_preserves_total_weight():
    counts = Counter({f"t;f.py:fn{i}": i + 1
                      for i in range(profiling.MAX_STACKS + 500)})
    total = sum(counts.values())
    profiling._prune(counts)
    assert len(counts) <= profiling.MAX_STACKS
    assert sum(counts.values()) == total    # weight folded, not lost
    assert counts[profiling.PRUNED_STACK] > 0
    # pruning again is monotonic: totals still preserved
    profiling._prune(counts)
    assert sum(counts.values()) == total


def test_continuous_sampler_snapshot_cumulative():
    s = profiling.ContinuousSampler("unit-cont", hz=100.0).start()
    try:
        deadline = time.monotonic() + 5.0
        snap = None
        while snap is None and time.monotonic() < deadline:
            snap = s.snapshot()
            time.sleep(0.02)
        assert snap is not None, "sampler never produced a snapshot"
        assert snap["mode"] == "continuous" and snap["hz"] == 100.0
        first_total = sum(snap["counts"].values())
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            snap2 = s.snapshot()
            if snap2["samples"] > snap["samples"]:
                break
            time.sleep(0.02)
        assert snap2["samples"] > snap["samples"]
        assert sum(snap2["counts"].values()) >= first_total  # cumulative
    finally:
        s.stop()


def test_process_sampler_gating_and_idempotence():
    profiling.stop_process_sampler()
    try:
        # hz <= 0 (the profiling_hz default) leaves sampling OFF
        assert profiling.start_process_sampler("unit", hz=0.0) is None
        assert profiling.process_profile() is None
        s1 = profiling.start_process_sampler("unit", hz=50.0)
        s2 = profiling.start_process_sampler("unit", hz=200.0)
        assert s1 is not None and s2 is s1      # idempotent
    finally:
        profiling.stop_process_sampler()
    assert profiling.process_profile() is None


def test_ingest_profile_tolerant_and_node_profile_merges():
    before = {r["proc"] for r in profiling.remote_profiles()}
    # bad payloads are dropped silently (result hot path)
    profiling.ingest_profile(None)
    profiling.ingest_profile({"counts": {}})            # no proc
    profiling.ingest_profile({"proc": "w", "counts": 3})  # bad counts
    assert {r["proc"] for r in profiling.remote_profiles()} == before
    rec = {"proc": "worker:test-ingest", "pid": 1, "mode": "continuous",
           "hz": 5.0, "samples": 3, "counts": {"t;a.py:f": 3}}
    profiling.ingest_profile(rec)
    try:
        node = profiling.node_profile()
        assert node is not None
        mine = [r for r in node["procs"]
                if r["proc"] == "worker:test-ingest"]
        assert mine == [rec]
        # a later record REPLACES the earlier one (cumulative shipping)
        rec2 = dict(rec, samples=9, counts={"t;a.py:f": 9})
        profiling.ingest_profile(rec2)
        assert [r for r in profiling.remote_profiles()
                if r["proc"] == "worker:test-ingest"] == [rec2]
    finally:
        with profiling._REMOTE_LOCK:
            profiling._REMOTE.pop("worker:test-ingest", None)


def test_speedscope_document_and_merged_collapsed():
    records = [
        {"proc": "driver", "pid": 1, "mode": "burst", "samples": 4,
         "counts": {"main;a.py:f;a.py:g": 3, "main;a.py:f": 1}},
        {"proc": "worker:2", "pid": 2, "mode": "continuous",
         "samples": 2, "counts": {"main;a.py:f": 2}},
    ]
    doc = profiling.speedscope_document(records)
    assert doc["$schema"].startswith("https://www.speedscope.app/")
    assert len(doc["profiles"]) == 2        # one lane per process
    names = {p["name"] for p in doc["profiles"]}
    assert any(n.startswith("driver (burst") for n in names)
    assert any(n.startswith("worker:2 (continuous") for n in names)
    frames = [f["name"] for f in doc["shared"]["frames"]]
    assert frames.count("a.py:f") == 1      # shared frame table dedupes
    for p in doc["profiles"]:
        assert p["type"] == "sampled"
        assert len(p["samples"]) == len(p["weights"])
        assert p["endValue"] == sum(p["weights"])
        for sample in p["samples"]:
            assert all(0 <= i < len(frames) for i in sample)
    # heaviest stack first per lane; collapsed lines carry the proc
    lines = profiling.merged_collapsed(records).splitlines()
    assert lines[0] == "driver;main;a.py:f;a.py:g 3"
    assert "worker:2;main;a.py:f 2" in lines


# ---------------------------------------------------------------------------
# profile.flush seam (unit: deterministic drop -> retry discipline)
# ---------------------------------------------------------------------------

def test_gate_profile_flush_cadence():
    """The daemon's heartbeat gate: off cadence -> None; on cadence the
    node's cumulative payload, the same again on the next period (the
    caller advances its stamp only on an acknowledged beat)."""
    from ray_tpu_torch._private.daemon import _gate_profile_flush

    rec = {"proc": "worker:gate-test", "pid": 1, "mode": "continuous",
           "hz": 5.0, "samples": 1, "counts": {"t;a.py:f": 1}}
    profiling.ingest_profile(rec)
    try:
        now = time.monotonic()
        assert _gate_profile_flush(last_push=now, now=now) is None
        payload = _gate_profile_flush(last_push=now - 10.0, now=now)
        assert payload is not None
        assert any(r["proc"] == "worker:gate-test"
                   for r in payload["procs"])
        again = _gate_profile_flush(last_push=now - 10.0, now=now)
        assert any(r["proc"] == "worker:gate-test"
                   for r in again["procs"])
    finally:
        with profiling._REMOTE_LOCK:
            profiling._REMOTE.pop("worker:gate-test", None)


def test_gate_profile_flush_drop_then_retry():
    """The daemon's heartbeat gate: off-cadence -> None; a drop arm
    nulls the payload (so the caller's push stamp never advances and
    the FULL cumulative snapshot re-sends next period); disarmed, the
    same snapshot flows again."""
    from ray_tpu_torch._private import failpoints as fp
    from ray_tpu_torch._private.daemon import _gate_profile_flush

    rec = {"proc": "worker:gate-test", "pid": 1, "mode": "continuous",
           "hz": 5.0, "samples": 1, "counts": {"t;a.py:f": 1}}
    profiling.ingest_profile(rec)
    try:
        now = time.monotonic()
        assert _gate_profile_flush(last_push=now, now=now) is None
        payload = _gate_profile_flush(last_push=now - 10.0, now=now)
        assert payload is not None
        assert any(r["proc"] == "worker:gate-test"
                   for r in payload["procs"])
        fp.activate("profile.flush=drop:p=1")
        try:
            assert _gate_profile_flush(last_push=now - 10.0,
                                       now=now) is None
            assert fp.fire_count("profile.flush") >= 1
        finally:
            fp.reset()
        retried = _gate_profile_flush(last_push=now - 10.0, now=now)
        assert retried is not None      # same cumulative data, re-sent
        assert any(r["proc"] == "worker:gate-test"
                   for r in retried["procs"])
    finally:
        with profiling._REMOTE_LOCK:
            profiling._REMOTE.pop("worker:gate-test", None)


# ---------------------------------------------------------------------------
# lock-contention observatory (units)
# ---------------------------------------------------------------------------

@pytest.fixture
def _fresh_config():
    """Env flips in these tests must not leak through the cfg() cache
    (a cached Config resolved while RAY_TPU_LOCK_METRICS was set would
    keep metering on after monkeypatch undoes the env)."""
    from ray_tpu_torch._private import config as _config
    _config.reset()
    yield
    _config.reset()


def test_metered_lock_wait_hold_and_contended(monkeypatch, _fresh_config):
    monkeypatch.setenv("RAY_TPU_LOCK_METRICS", "1")
    monkeypatch.delenv("RAY_TPU_LOCK_SANITIZER", raising=False)
    from ray_tpu_torch._private import lock_sanitizer as ls

    lock = ls.tracked_lock("unit.meter", reentrant=False)
    assert isinstance(lock, ls.MeteredLock)
    with lock:
        time.sleep(0.002)               # measurable hold
    held = threading.Event()

    def holder():
        with lock:
            held.set()
            time.sleep(0.05)

    t = threading.Thread(target=holder)
    t.start()
    held.wait(5.0)
    with lock:                          # contended: waits ~50ms
        pass
    t.join()
    assert lock.contended >= 1
    assert lock.wait_total >= 2 and lock.hold_total >= 2
    assert lock.wait_sum > 0.01         # the blocked acquire's wait

    entries = {e["name"]: e for e in ls.lock_metric_entries()}
    wait = entries["ray_tpu_lock_wait_seconds"]
    assert wait["kind"] == "histogram"
    assert wait["boundaries"] == list(ls.METER_BOUNDS)
    rows = {tuple(map(tuple, labels)): (counts, s, total)
            for labels, counts, s, total in wait["hist"]}
    counts, wsum, total = rows[(("lock", "unit.meter"),)]
    assert sum(counts) == total and wsum > 0.01
    assert "ray_tpu_lock_hold_seconds" in entries
    cont = entries["ray_tpu_lock_contended_total"]
    assert any(labels == [["lock", "unit.meter"]] and v >= 1
               for labels, v in cont["samples"])
    # the entries ride the shared registry snapshot (federation path)
    from ray_tpu_torch.util.metrics import export_snapshot
    assert any(e["name"] == "ray_tpu_lock_wait_seconds"
               for e in export_snapshot())


def test_metered_rlock_reentrant_measures_outermost(monkeypatch,
                                                    _fresh_config):
    monkeypatch.setenv("RAY_TPU_LOCK_METRICS", "1")
    monkeypatch.delenv("RAY_TPU_LOCK_SANITIZER", raising=False)
    from ray_tpu_torch._private import lock_sanitizer as ls

    lock = ls.tracked_lock("unit.meter.rlock", reentrant=True)
    assert isinstance(lock, ls.MeteredLock)
    with lock:
        with lock:                      # inner acquire: depth only
            pass
        time.sleep(0.002)
    # one outermost acquire -> exactly one wait + one hold observation
    assert lock.wait_total == 1 and lock.hold_total == 1
    assert lock.hold_sum >= 0.002


def test_tracked_lock_stays_plain_without_opt_in(monkeypatch,
                                                 _fresh_config):
    monkeypatch.delenv("RAY_TPU_LOCK_METRICS", raising=False)
    monkeypatch.delenv("RAY_TPU_LOCK_SANITIZER", raising=False)
    from ray_tpu_torch._private import lock_sanitizer as ls
    assert type(ls.tracked_lock("unit.plain", reentrant=False)) \
        is type(threading.Lock())


def test_queue_dwell_gauge_in_snapshot():
    from ray_tpu_torch.util import metrics
    metrics.note_queue_dwell("unit.test_queue", 0.25)
    entries = [e for e in metrics.export_snapshot()
               if e["name"] == "ray_tpu_queue_dwell_seconds"]
    assert len(entries) == 1 and entries[0]["kind"] == "gauge"
    samples = {tuple(map(tuple, labels)): v
               for labels, v in entries[0]["samples"]}
    assert samples[(("queue", "unit.test_queue"),)] == 0.25


# ---------------------------------------------------------------------------
# 2-node federation e2e: daemon profiles at the head over heartbeats
# (surviving the profile.flush drop arm), cluster_profile's merged
# speedscope view, lock/queue/arena metrics in the federated /metrics
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def profiled_daemon_cluster():
    mp = pytest.MonkeyPatch()
    mp.setenv("RAY_TPU_PROFILING_HZ", "20")
    mp.setenv("RAY_TPU_LOCK_METRICS", "1")
    # each daemon drops its first 2 profile flushes: federation below only
    # passes because the unadvanced push stamp re-sends them
    mp.setenv("RAY_TPU_FAILPOINTS", "profile.flush=drop:max=2")
    rt = rt_api.init(num_nodes=2, resources={"CPU": 4},
                     cluster="daemons", object_store_memory=128 << 20)
    yield rt
    rt_api.shutdown()
    profiling.stop_process_sampler()
    mp.undo()
    from ray_tpu_torch._private import failpoints as fp
    fp.reset()
    from ray_tpu_torch._private import config
    config.reset()


def _run_batched_workload(n=40):
    @rt_api.remote(num_returns=2)
    def duo(i):
        return i, i + 1

    refs = [duo.remote(i) for i in range(n)]
    rt_api.get([r for ab in refs for r in ab])


def test_profiles_federate_to_head_and_merged_speedscope(
        profiled_daemon_cluster, tmp_path):
    rt = profiled_daemon_cluster
    backend = rt.cluster_backend
    node_hexes = {h.node_id.hex() for h in backend.daemons.values()}

    # 1) continuous profiles from both daemons reach the head on
    # heartbeats
    deadline = time.monotonic() + 30.0
    nodes = {}
    while time.monotonic() < deadline:
        _run_batched_workload(10)
        fed = backend.head.profile_get()
        nodes = {nid: p for nid, p in (fed.get("nodes") or {}).items()
                 if p and p.get("procs")}
        if set(nodes) >= node_hexes:
            break
        time.sleep(0.3)
    assert set(nodes) >= node_hexes, (
        f"head saw profiles from {set(nodes)}, wanted {node_hexes}")
    for nid in node_hexes:
        procs = {r["proc"] for r in nodes[nid]["procs"]}
        assert any(p.startswith("daemon:") for p in procs), procs
    # driver sampler runs too (profiling_hz picked up at init)
    assert profiling.process_profile() is not None

    # 2) the `ray-tpu profile --all` backend: burst fan-out + merge —
    # lanes for driver, both daemons, and at least one worker
    from ray_tpu_torch.util.state import cluster_profile
    out_path = str(tmp_path / "prof.json")
    out = cluster_profile(duration_s=0.5, path=out_path)
    procs = {r["proc"] for r in out["records"]}
    assert "driver" in procs
    assert sum(1 for p in procs if p.startswith("daemon:")) >= 2, procs
    assert any(p.startswith("worker:") for p in procs), procs
    doc = out["speedscope"]
    assert len(doc["profiles"]) == len(out["records"]) >= 4
    assert doc["shared"]["frames"]
    with open(out_path) as f:
        on_disk = json.load(f)
    assert on_disk["$schema"] == doc["$schema"]
    assert out["collapsed"]


def test_contention_and_object_plane_metrics_federate(
        profiled_daemon_cluster):
    """Acceptance: ray_tpu_lock_wait_seconds appears in the federated
    exposition with a tracked-lock label under a queued burst; queue
    dwell + arena-slot-ref + push gauges federate alongside."""
    from ray_tpu_torch.util.metrics import cluster_prometheus_text

    rt = profiled_daemon_cluster
    assert rt is not None
    wanted = ("ray_tpu_lock_wait_seconds_bucket",
              "ray_tpu_lock_hold_seconds_bucket",
              "ray_tpu_queue_dwell_seconds",
              "ray_tpu_arena_slot_refs",
              "ray_tpu_push_inflight")
    deadline = time.monotonic() + 30.0
    text = ""
    while time.monotonic() < deadline:
        _run_batched_workload(20)
        text = cluster_prometheus_text()
        if all(w in text for w in wanted):
            break
        time.sleep(0.3)
    for w in wanted:
        assert w in text, f"{w} missing from the federated exposition"
    wait_lines = [ln for ln in text.splitlines()
                  if ln.startswith("ray_tpu_lock_wait_seconds_bucket")
                  and 'lock="' in ln]
    assert wait_lines, "no tracked-lock label on the wait histogram"
    dwell = [ln for ln in text.splitlines()
             if ln.startswith("ray_tpu_queue_dwell_seconds")
             and 'queue="' in ln]
    assert any('queue="rpc.lane"' in ln or 'queue="node.dispatch"' in ln
               or 'queue="daemon.reply_pump"' in ln for ln in dwell)
    assert 'state="held"' in text and 'state="refs"' in text
