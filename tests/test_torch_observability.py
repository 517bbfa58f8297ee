"""The port's observability (copies of ``tests/test_observability.py``,
``tests/test_ops_shell.py``'s state/metrics/dashboard/CLI/profiling tests,
``tests/test_cluster_daemons.py``'s task-event store and agent tests and
``tests/test_failure_detection.py``'s memory-monitor tests, against
``ray_tpu_torch``), and its parity with JAX's package on the same scripts:
the task states and the trace's names, phases and lanes on both daemon
clusters, the Prometheus rendering and the delta merge, the speedscope
document, the export events, and the observability flags.
"""

import contextlib
import gc
import json
import os
import re
import time
import urllib.error
import urllib.request

import pytest
import torch

import ray_tpu_torch as rt_api
from ray_tpu_torch import exceptions as exc


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def runtime():
    rt = rt_api.init(num_nodes=1, resources={"CPU": 8})
    yield rt
    rt_api.shutdown()


# ---------------------------------------------------------------------------
# export events
# ---------------------------------------------------------------------------

def test_export_events_lifecycle():
    from ray_tpu_torch._private.export_events import (get_export_logger,
                                                      reset_export_logger)

    reset_export_logger()
    rt_api.init(num_nodes=1, resources={"CPU": 4},
                _system_config={"export_events": True})
    try:
        @rt_api.remote
        def f():
            return 1

        @rt_api.remote
        class A:
            def ping(self):
                return "pong"

        assert rt_api.get(f.remote()) == 1
        a = A.remote()
        assert rt_api.get(a.ping.remote()) == "pong"
        rt_api.kill(a)

        from ray_tpu_torch.util.placement_group import (
            placement_group, remove_placement_group)
        pg = placement_group([{"CPU": 1}])
        rt_api.get(pg.ready())
        remove_placement_group(pg)

        logger = get_export_logger()
        tasks = logger.read("TASK")
        assert any(e["state"] == "FINISHED" for e in tasks)
        assert all("task_id" in e and "timestamp" in e for e in tasks)
        actors = logger.read("ACTOR")
        states = {e["state"] for e in actors}
        assert any("ALIVE" in s for s in states)
        assert any("DEAD" in s for s in states)
        nodes = logger.read("NODE")
        assert any(e["state"] == "ALIVE" for e in nodes)
        pgs = logger.read("PLACEMENT_GROUP")
        assert {e["state"] for e in pgs} >= {"CREATED", "REMOVED"}
    finally:
        rt_api.shutdown()
        reset_export_logger()


def test_export_events_from_a_worker_process():
    """A job's supervisor actor runs in a worker process: its JOB events
    reach the driver's JSONL, in the order they were emitted."""
    from ray_tpu_torch._private.export_events import (get_export_logger,
                                                      reset_export_logger)
    from ray_tpu_torch.job import JobSubmissionClient

    reset_export_logger()
    rt_api.init(num_nodes=1, resources={"CPU": 4},
                _system_config={"export_events": True})
    try:
        client = JobSubmissionClient()
        job = client.submit_job(entrypoint="echo exported")
        assert client.wait_until_finished(job, timeout=60) == "SUCCEEDED"
        logger = get_export_logger()
        deadline = time.monotonic() + 10
        states = []
        while time.monotonic() < deadline:
            states = [e["state"] for e in logger.read("JOB")
                      if e["job_id"] == job]
            if "SUCCEEDED" in states:
                break
            time.sleep(0.02)
        assert states == ["RUNNING", "SUCCEEDED"]
    finally:
        rt_api.shutdown()
        reset_export_logger()


def test_export_events_disabled_by_default():
    from ray_tpu_torch._private.export_events import (get_export_logger,
                                                      reset_export_logger)

    reset_export_logger()
    rt_api.init(num_nodes=1, resources={"CPU": 2})
    try:
        @rt_api.remote
        def f():
            return 1

        assert rt_api.get(f.remote()) == 1
        logger = get_export_logger()
        assert logger.read("TASK") == []   # flag off: no writes
    finally:
        rt_api.shutdown()
        reset_export_logger()


# ---------------------------------------------------------------------------
# the task-event buffer
# ---------------------------------------------------------------------------

def test_event_buffer_extend_and_from_events():
    from ray_tpu_torch._private.events import TaskEventBuffer

    src = TaskEventBuffer()
    src.record(task_id="t1", name="a", event="RUNNING")
    src.record(task_id="t1", name="a", event="FINISHED")
    buf = TaskEventBuffer.from_events(src.events())
    assert [e["task_id"] for e in buf.events()] == ["t1", "t1"]
    # extend re-assigns seqs locally so cursors stay monotonic
    buf.extend([{"task_id": "t2", "name": "b", "event": "RUNNING",
                 "wall_ts": time.time(), "seq": 999}])
    seqs = [e["seq"] for e in buf.events()]
    assert seqs == sorted(seqs) and seqs[-1] == 3
    assert buf.events()[-1]["task_id"] == "t2"


def test_events_after_tail_indexed():
    from ray_tpu_torch._private.events import TaskEventBuffer

    buf = TaskEventBuffer(capacity=10)
    for i in range(25):
        buf.record(task_id=f"t{i}", name="n", event="RUNNING")
    # only the last 10 survive the ring (seqs 16..25)
    assert [e["seq"] for e in buf.events_after(20)] == [21, 22, 23, 24, 25]
    assert [e["seq"] for e in buf.events_after(0)] == list(range(16, 26))
    assert buf.events_after(25) == []
    assert buf.events_after(99) == []


def test_chrome_trace_retry_pairing():
    """A retry's second RUNNING supersedes the dead attempt's start, so
    FINISHED pairs with the retry's own start."""
    from ray_tpu_torch._private.events import TaskEventBuffer

    buf = TaskEventBuffer()
    buf.record(task_id="t1", name="f", event="RUNNING", node_id="aa" * 8)
    buf.record(task_id="t1", name="f", event="RETRY")
    buf.record(task_id="t1", name="f", event="RUNNING", node_id="bb" * 8)
    buf.record(task_id="t1", name="f", event="FINISHED",
               node_id="bb" * 8)
    # second task: two RUNNINGs with no retry marker (a lost transition)
    buf.record(task_id="t2", name="g", event="RUNNING")
    buf.record(task_id="t2", name="g", event="RUNNING")
    buf.record(task_id="t2", name="g", event="FINISHED")
    events = buf.events()
    trace = buf.chrome_trace()
    t1 = [s for s in trace if s["tid"] == "t1"]
    assert len(t1) == 1
    second_running = [e for e in events if e["task_id"] == "t1"
                      and e["event"] == "RUNNING"][1]
    assert t1[0]["ts"] == second_running["ts_us"]
    t2 = [s for s in trace if s["tid"] == "t2"]
    assert len(t2) == 1


def test_merged_chrome_trace_lanes():
    from ray_tpu_torch._private.events import merged_chrome_trace

    now = time.time()
    events = [
        {"task_id": "t1", "name": "f", "event": "SPAN", "phase": "submit",
         "proc": "driver", "wall_ts": now, "start_wall": now - 0.01,
         "dur_s": 0.01},
        {"task_id": "t1", "name": "f", "event": "SPAN",
         "phase": "dispatch", "proc": "daemon:aabbccdd",
         "wall_ts": now + 0.02, "start_wall": now + 0.01, "dur_s": 0.01},
        {"task_id": "t1", "name": "f", "event": "SPAN", "phase": "exec",
         "proc": "worker:123", "wall_ts": now + 0.05,
         "start_wall": now + 0.02, "dur_s": 0.03},
    ]
    trace = merged_chrome_trace(events)
    lanes = {s["pid"] for s in trace}
    assert lanes == {"driver", "daemon:aabbccdd", "worker:123"}
    by_phase = {s["args"]["phase"]: s["ts"] for s in trace}
    assert by_phase["submit"] <= by_phase["dispatch"] <= by_phase["exec"]


def test_clock_offset_is_the_least_of_recent_beats():
    """The head shifts a daemon's spans by the least head-minus-daemon
    offset of its recent beats: a beat delayed in transit (20 ms here)
    does not move its spans later than an earlier, prompt beat's."""
    from ray_tpu_torch._private.head import HeadService

    class _Conn:
        meta = {}

        def link(self, peer_role, link_id=""):
            return self     # registration tags the chaos-link identity

    svc = HeadService()
    try:
        svc.handle_register_node(_Conn(), 0, {
            "node_id": "n1", "resources": {"CPU": 1}, "labels": {},
            "addr": ["127.0.0.1", 1]})
        for phase, late in (("dispatch", 0.0001), ("exec", 0.020)):
            span = {"task_id": "t", "name": "f", "event": "SPAN",
                    "phase": phase, "wall_ts": 100.0, "start_wall": 99.0,
                    "dur_s": 1.0}
            out = svc.handle_heartbeat(None, 0, {
                "node_id": "n1", "available": {}, "events": [span],
                "wall_ts": time.time() - late})
            assert out["ok"]
        events = svc.handle_task_events_get(None, 0, {})["events"]
        offs = {e["phase"]: e["clock_off"] for e in events}
        assert offs["exec"] == offs["dispatch"] < 0.010
        assert all(e["wall_ts"] == 100.0 + e["clock_off"] for e in events)
    finally:
        svc._stop.set()


# ---------------------------------------------------------------------------
# the Prometheus exposition
# ---------------------------------------------------------------------------

def test_prometheus_label_escaping():
    """Label values with quotes, backslashes and newlines are escaped."""
    from ray_tpu_torch.util import metrics

    metrics.clear_registry()
    try:
        c = metrics.Counter("esc_test_total", "escaping", ("name",))
        c.inc(1, tags={"name": 'he said "hi"\nback\\slash'})
        text = metrics.prometheus_text()
        assert ('esc_test_total{name="he said \\"hi\\"\\nback'
                '\\\\slash"} 1.0') in text
        line = [ln for ln in text.splitlines()
                if ln.startswith("esc_test_total{")]
        assert len(line) == 1
    finally:
        metrics.clear_registry()


def test_render_prometheus_federated_labels():
    """Snapshots from several processes merge into one exposition with one
    TYPE block a metric and a node_id label a source."""
    from ray_tpu_torch.util import metrics

    metrics.clear_registry()
    try:
        metrics.Counter("fed_reqs_total", "reqs").inc(2)
        local = metrics.export_snapshot()
        remote = [{"name": "fed_reqs_total", "kind": "counter",
                   "description": "reqs", "samples": [[[], 5.0]]}]
        text = metrics.render_prometheus(
            [({}, local), ({"node_id": "aa" * 16}, remote)])
        assert text.count("# TYPE fed_reqs_total counter") == 1
        assert "fed_reqs_total 2.0" in text
        assert f'fed_reqs_total{{node_id="{"aa" * 16}"}} 5.0' in text
    finally:
        metrics.clear_registry()


def test_worker_metrics_flow_to_driver(runtime):
    """User metrics made inside worker processes reach the driver's
    exposition: counters merge across workers, histograms merge their
    bucket counts."""
    from ray_tpu_torch.util.metrics import clear_registry, prometheus_text

    @rt_api.remote
    def work(i):
        from ray_tpu_torch.util.metrics import Counter, Histogram
        Counter("xproc_events", "events").inc(5)
        Histogram("xproc_lat", "lat", boundaries=(1, 10)).observe(i)
        return 1

    assert rt_api.get([work.remote(i) for i in range(3)],
                      timeout=60) == [1, 1, 1]
    deadline = time.time() + 20
    while time.time() < deadline:
        text = prometheus_text()
        lines = [ln for ln in text.splitlines()
                 if ln.startswith("xproc_events ")]
        if lines and lines[0].endswith("15.0"):
            break
        time.sleep(0.2)
    assert lines and lines[0].endswith("15.0"), lines
    assert "xproc_lat_count 3" in text
    clear_registry()


def test_timeline_chrome_trace(runtime, tmp_path):
    @rt_api.remote
    def work():
        time.sleep(0.01)
        return 1

    from ray_tpu_torch.util import state as state_api
    rt_api.get([work.remote() for _ in range(3)])
    trace = state_api.timeline()
    named = [s for s in trace if "work" in s["name"]]
    assert len(named) >= 3
    assert all(s["ph"] == "X" and s["dur"] > 0 for s in named)
    path = state_api.timeline(str(tmp_path / "trace.json"))
    assert json.load(open(path))


def test_metrics_prometheus_text(runtime):
    from ray_tpu_torch.util import metrics as rt_metrics

    rt_metrics.clear_registry()
    c = rt_metrics.Counter("my_requests", "test counter", ("route",))
    c.inc(3, tags={"route": "/a"})
    g = rt_metrics.Gauge("my_depth", "test gauge")
    g.set(7.5)
    h = rt_metrics.Histogram("my_lat", "test hist", boundaries=(1, 10))
    h.observe(0.5)
    h.observe(5)
    h.observe(50)
    text = rt_metrics.prometheus_text()
    assert 'my_requests{route="/a"} 3.0' in text
    assert "my_depth 7.5" in text
    assert "my_lat_count 3" in text
    assert "ray_tpu_tasks_finished" in text
    rt_metrics.clear_registry()


def test_dashboard_endpoints(runtime):
    from ray_tpu_torch.dashboard.server import start_dashboard, stop_dashboard

    @rt_api.remote
    def f():
        return 1

    rt_api.get(f.remote())
    host, port = start_dashboard(port=0)
    try:
        def get(path):
            with urllib.request.urlopen(
                    f"http://{host}:{port}{path}", timeout=10) as r:
                return r.read().decode()
        nodes = json.loads(get("/api/nodes"))
        assert len(nodes) == 1
        status = json.loads(get("/api/cluster_status"))
        assert status["stats"]["tasks_finished"] >= 1
        assert "ray_tpu_tasks_finished" in get("/metrics")
        assert json.loads(get("/api/timeline"))
        from ray_tpu_torch._private.config import cfg
        config = json.loads(get("/api/config"))
        assert config["pull_chunk"]["value"] == cfg().pull_chunk
        assert "source" in config["memory_monitor"]
        from ray_tpu_torch import data as _data
        (_data.from_items([{"x": i} for i in range(6)])
         .map(lambda r: r).take_all())   # the executor records stats
        ds_stats = json.loads(get("/api/data"))
        assert ds_stats["datasets"], "dataset stats not surfaced"
        train = json.loads(get("/api/train"))
        assert "train_runs" in train
        serve_state = json.loads(get("/api/serve"))
        assert "applications" in serve_state or serve_state == {}
    finally:
        stop_dashboard()


def test_cli_status_and_summary(runtime, capsys):
    from ray_tpu_torch.scripts.cli import main

    assert main(["status"]) == 0
    out = capsys.readouterr().out
    assert "cluster_resources" in out
    assert main(["summary"]) == 0


def test_microbenchmark_harness(runtime):
    from ray_tpu_torch._private.perf import run_microbenchmarks

    results = run_microbenchmarks(duration_s=0.3)
    names = {r["name"] for r in results}
    assert "tasks_per_second" in names
    assert all(r["throughput_per_s"] > 0 for r in results)


def test_tqdm_ray(capsys):
    from ray_tpu_torch.experimental.tqdm_ray import tqdm

    out = []
    for x in tqdm(range(5), desc="test", flush_period_s=0):
        out.append(x)
    assert out == [0, 1, 2, 3, 4]


def test_dashboard_web_ui_and_profiling(runtime):
    """The dashboard serves an HTML page at / and on-demand profiling."""
    import threading

    from ray_tpu_torch.dashboard.server import start_dashboard, stop_dashboard

    host, port = start_dashboard(port=0)
    base = f"http://{host}:{port}"
    try:
        html = urllib.request.urlopen(f"{base}/").read().decode()
        assert "<html>" in html and "ray_tpu" in html

        stop = threading.Event()

        def burn():
            while not stop.is_set():
                sum(i * i for i in range(2000))

        t = threading.Thread(target=burn, daemon=True, name="burner")
        t.start()
        prof = json.loads(urllib.request.urlopen(
            f"{base}/api/profile/cpu?duration=0.5").read())
        stop.set()
        assert prof["samples"] > 10
        assert any("burn" in row["frame"] for row in prof["top"]) or any(
            "burner" in line for line in prof["collapsed"])

        json.loads(urllib.request.urlopen(
            f"{base}/api/profile/memory").read())
        blob = [bytearray(1024 * 1024) for _ in range(4)]
        mem2 = json.loads(urllib.request.urlopen(
            f"{base}/api/profile/memory").read())
        assert mem2.get("total_traced_bytes", 0) > 0
        del blob
    finally:
        stop_dashboard()
        from ray_tpu_torch.util.profiling import stop_memory_tracing
        stop_memory_tracing()


# ---------------------------------------------------------------------------
# the memory monitor
# ---------------------------------------------------------------------------

def test_memory_monitor_kills_and_retries(runtime):
    """A task that blows past the memory limit is SIGKILLed by the monitor
    and retried; with retries exhausted it fails with OutOfMemoryError."""
    mon = runtime.memory_monitor
    mon.interval_s = 0.1
    if not mon._thread.is_alive():
        mon.start()
    baseline = mon.usage_bytes()
    mon.set_limit(baseline + 150 * 1024 * 1024)  # headroom: ~150 MB
    try:
        @rt_api.remote(max_retries=1)
        def hog():
            import time as _t

            import numpy as np
            blob = np.ones(400 * 1024 * 1024 // 8)  # ~400 MB
            _t.sleep(20)
            return blob.sum()

        with pytest.raises(exc.OutOfMemoryError):
            rt_api.get(hog.remote(), timeout=60)
        assert mon.kills >= 1
    finally:
        mon.set_limit(1 << 62)


def test_memory_monitor_policy_prefers_retriable():
    from ray_tpu_torch._private.memory_monitor import (GroupByOwnerPolicy,
                                                       RetriableFIFOPolicy,
                                                       _Candidate)

    cands = [
        _Candidate(1, "task", task_id="a", retriable=False, started_at=5),
        _Candidate(2, "task", task_id="b", retriable=True, started_at=3),
        _Candidate(3, "task", task_id="c", retriable=True, started_at=4),
        _Candidate(4, "actor", actor_id="x", retriable=True,
                   started_at=9),
    ]
    # the newest retriable task first, not the non-retriable or the actor
    assert RetriableFIFOPolicy().pick(cands).task_id == "c"
    grouped = [
        _Candidate(1, "task", task_id="a", retriable=True, started_at=1,
                   owner_key="flood"),
        _Candidate(2, "task", task_id="b", retriable=True, started_at=2,
                   owner_key="flood"),
        _Candidate(3, "task", task_id="c", retriable=True, started_at=9,
                   owner_key="singleton"),
    ]
    assert GroupByOwnerPolicy().pick(grouped).owner_key == "flood"


# ---------------------------------------------------------------------------
# the 2-node daemon cluster: spans flushed to the head, the breakdown,
# federation, the dashboard, the head's store, the agents
# ---------------------------------------------------------------------------

def _run_batched_workload(n=40):
    """num_returns=2 keeps tasks off the fast lane: they ride the batched
    submit path (coalescer -> push_task_batch)."""
    @rt_api.remote(num_returns=2)
    def duo(i):
        return i, i + 1

    refs = [duo.remote(i) for i in range(n)]
    rt_api.get([r for ab in refs for r in ab])


def _head_span_events(backend, phases, deadline_s=20.0):
    """Read the head store until spans of every wanted phase landed
    (daemon flushes ride ~0.2 s heartbeats)."""
    deadline = time.monotonic() + deadline_s
    got = set()
    while time.monotonic() < deadline:
        events = backend.head.task_events_get()
        spans = [e for e in events if e.get("event") == "SPAN"]
        got = {e.get("phase") for e in spans}
        if phases <= got:
            return events
        time.sleep(0.2)
    raise AssertionError(
        f"head store never saw phases {phases - got}; got {got}")


@pytest.fixture(scope="class")
def daemon_cluster():
    rt = rt_api.init(num_nodes=2, resources={"CPU": 4}, cluster="daemons",
                     object_store_memory=128 << 20)
    yield rt
    rt_api.shutdown()


@pytest.mark.usefixtures("daemon_cluster")
class TestDaemonCluster:
    def test_spans_flush_to_head_and_breakdown(self, daemon_cluster):
        """Driver submit/linger/queue/result spans, daemon dispatch spans
        and worker exec spans all reach the head; task_breakdown returns
        the eight-phase vector; the merged chrome trace has one lane a
        process in phase order."""
        rt = daemon_cluster
        backend = rt.cluster_backend
        _run_batched_workload()
        backend._flush_task_events()
        events = _head_span_events(
            backend, {"submit", "queue", "dispatch", "exec", "result"})

        spans = [e for e in events if e.get("event") == "SPAN"]
        node_hexes = {h.node_id.hex() for h in backend.daemons.values()}
        dispatch = [e for e in spans if e["phase"] == "dispatch"]
        assert {e["node_id"] for e in dispatch} <= node_hexes
        assert all(e["proc"].startswith("daemon:") for e in dispatch)
        execs = [e for e in spans if e["phase"] == "exec"]
        assert any(e["proc"].startswith("worker:") for e in execs)
        # the clock correction was applied on ingestion
        assert all("clock_off" in e for e in dispatch)

        by_task = {}
        for e in spans:
            by_task.setdefault(e["task_id"], set()).add(e["phase"])
        full = [t for t, ph in by_task.items()
                if {"submit", "dispatch", "exec"} <= ph]
        assert full, f"no task with cross-process spans: {by_task}"
        from ray_tpu_torch.util.state import cluster_timeline, task_breakdown
        bd = task_breakdown(full[0])
        assert set(bd) == {"submit", "linger", "queue", "dispatch", "exec",
                           "result_flush", "result_ingest", "result"}
        assert bd["exec"] > 0.0 and bd["dispatch"] > 0.0

        trace = cluster_timeline()
        task_slices = [s for s in trace
                       if s.get("args", {}).get("task_id") == full[0]]
        lanes = {s["pid"] for s in task_slices}
        assert "driver" in lanes
        assert any(p.startswith("daemon:") for p in lanes)
        assert any(p.startswith("worker:") for p in lanes)
        ts = {s["args"]["phase"]: s["ts"] for s in task_slices
              if s["args"].get("phase")}
        slack = 2000.0  # µs of clock-estimate tolerance (same host: ~0)
        assert ts["submit"] <= ts["dispatch"] + slack
        assert ts["dispatch"] <= ts["exec"] + slack

    def test_cluster_metrics_federation(self, daemon_cluster):
        """The cluster-wide exposition: phase histograms carry node_id
        labels for both daemons, and daemon-process metrics (rpc server
        counters) federate through the head's heartbeats."""
        from ray_tpu_torch.util.metrics import cluster_prometheus_text
        backend = daemon_cluster.cluster_backend
        _run_batched_workload()
        node_hexes = {h.node_id.hex() for h in backend.daemons.values()}
        deadline = time.monotonic() + 25
        ok = False
        while time.monotonic() < deadline and not ok:
            text = cluster_prometheus_text()
            ok = ("ray_tpu_task_phase_seconds_bucket" in text
                  and all(f'node_id="{h}"' in text for h in node_hexes)
                  and "ray_tpu_rpc_server_requests_total" in text)
            if not ok:
                time.sleep(0.3)
        assert "ray_tpu_task_phase_seconds_bucket" in text
        for h in node_hexes:
            assert f'node_id="{h}"' in text
        lines = [ln for ln in text.splitlines()
                 if ln.startswith("ray_tpu_rpc_server_requests_total")
                 and "node_id=" in ln]
        assert lines, "daemon rpc counters did not federate"
        assert text.count(
            "# TYPE ray_tpu_task_phase_seconds histogram") == 1

    def test_dashboard_endpoints_live_cluster(self, daemon_cluster):
        from ray_tpu_torch.dashboard.server import (start_dashboard,
                                                    stop_dashboard)
        _run_batched_workload(10)
        daemon_cluster.cluster_backend._flush_task_events()
        host, port = start_dashboard(port=0)
        base = f"http://{host}:{port}"
        try:
            with urllib.request.urlopen(f"{base}/api/timeline",
                                        timeout=30) as r:
                trace = json.loads(r.read())
            assert isinstance(trace, list) and trace
            assert any(s.get("ph") == "X" for s in trace)
            with urllib.request.urlopen(f"{base}/api/cluster_status",
                                        timeout=30) as r:
                status = json.loads(r.read())
            assert "cluster_resources" in status and "stats" in status
            assert status["task_summary"].get("FINISHED", 0) >= 1
            with urllib.request.urlopen(f"{base}/metrics",
                                        timeout=30) as r:
                assert r.status == 200
                text = r.read().decode()
            assert "ray_tpu_task_phase_seconds" in text
            assert "ray_tpu_tasks_finished" in text
            with urllib.request.urlopen(f"{base}/api/metrics",
                                        timeout=30) as r:
                payload = json.loads(r.read())
            assert any(row["name"] == "ray_tpu_task_phase_seconds"
                       for row in payload["metrics"])
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(f"{base}/api/no_such_thing",
                                       timeout=30)
            assert err.value.code == 404
        finally:
            stop_dashboard()

    def test_head_task_event_store(self, daemon_cluster):
        """Task state transitions are kept at the head, so the state reads
        outlive the driver's buffer."""
        rt = daemon_cluster
        backend = rt.cluster_backend

        @rt_api.remote
        def marked():
            return 1

        rt_api.get([marked.remote() for _ in range(5)])
        backend._flush_task_events()
        saved = rt.task_events.events()
        rt.task_events.clear()   # the reads below must come from the head
        try:
            events = backend.head.task_events_get()
            finished = [e for e in events
                        if e["event"] == "FINISHED" and "marked" in e["name"]]
            assert len(finished) == 5, events
            assert all(e["job_id"] == rt.job_id.hex() for e in finished)
            exact = backend.head.task_events_get(name=finished[0]["name"])
            assert len([e for e in exact if e["event"] == "FINISHED"]) == 5
            assert backend.head.task_events_get(job_id="deadbeef") == []
        finally:
            rt.task_events.extend(saved)

    def test_post_mortem_state_from_head(self, daemon_cluster):
        """list_tasks_from_head / timeline_from_head answer from the head's
        store alone."""
        backend = daemon_cluster.cluster_backend

        @rt_api.remote
        def traced():
            return 1

        rt_api.get([traced.remote() for _ in range(3)])
        backend._flush_task_events()
        addr = f"{backend.head.addr[0]}:{backend.head.addr[1]}"
        from ray_tpu_torch.util.state.api import (list_tasks_from_head,
                                                  timeline_from_head)
        rows = list_tasks_from_head(addr)
        done = [r for r in rows
                if "traced" in r["name"] and r["state"] == "FINISHED"]
        assert len(done) == 3
        assert isinstance(timeline_from_head(addr), list)

    def test_trace_flush_failpoint_retries(self, daemon_cluster):
        """trace.flush drop arm: a lost driver flush keeps its cursor, so
        the next interval re-sends the same batch (no span ever lost)."""
        from ray_tpu_torch._private import failpoints as _fp

        backend = daemon_cluster.cluster_backend
        _run_batched_workload(6)
        cursor_before = backend._task_event_cursor
        _fp.activate("trace.flush=drop:p=1")
        try:
            backend._flush_task_events()
            assert backend._task_event_cursor == cursor_before
        finally:
            _fp.reset()
        backend._flush_task_events()
        assert backend._task_event_cursor > cursor_before
        events = backend.head.task_events_get()
        assert any(e.get("event") == "FINISHED" for e in events)

    def test_per_node_agent_endpoints(self, daemon_cluster):
        """Each daemon serves its own HTTP endpoint: /api/stats,
        /api/profile/cpu and /metrics."""
        for h in daemon_cluster.cluster_backend.daemons.values():
            port = h.client.call("daemon_stats")["agent_port"]
            assert port, "agent not started"
            base = f"http://127.0.0.1:{port}"
            with urllib.request.urlopen(f"{base}/api/stats",
                                        timeout=30) as r:
                stats = json.loads(r.read())
            assert stats["node_id"] == h.node_id.hex()
            assert stats["pid"] == h.proc.pid
            with urllib.request.urlopen(
                    f"{base}/api/profile/cpu?duration=0.3",
                    timeout=30) as r:
                prof = json.loads(r.read())
            assert "collapsed" in prof and prof["samples"] > 0
            with urllib.request.urlopen(f"{base}/metrics", timeout=30) as r:
                assert r.status == 200


# ---------------------------------------------------------------------------
# parity with JAX's package
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _jax_without_cyclic_gc():
    """JAX's runtime deadlocks when a cyclic GC pass runs an old ref's
    ``__del__`` inside its non-reentrant locations lock (ROADMAP C): its
    runs here collect first and hold the collector off."""
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


def _state_script(pkg) -> dict:
    """One task-and-actor script on a 2-daemon cluster: per-task lifecycle
    sequences, list_tasks' final states, summarize_tasks, and the merged
    trace's (name, phase, lane kind) set, ids aside."""
    from importlib import import_module
    state = import_module(f"{pkg.__name__}.util.state")

    @pkg.remote
    def plain(x):
        return x + 1

    @pkg.remote(num_returns=2)
    def duo(i):
        return i, i * 2

    @pkg.remote
    def boom():
        raise ValueError("no")

    @pkg.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def add(self, k):
            self.n += k
            return self.n

    assert pkg.get([plain.remote(i) for i in range(4)]) == [1, 2, 3, 4]
    refs = [duo.remote(i) for i in range(6)]
    pkg.get([r for ab in refs for r in ab])
    with pytest.raises(Exception):
        pkg.get(boom.remote())
    c = Counter.remote()
    assert pkg.get([c.add.remote(1) for _ in range(3)]) == [1, 2, 3]
    rt = import_module(f"{pkg.__name__}._private.worker").global_runtime()
    rt.cluster_backend._flush_task_events()
    seqs = {}
    for ev in rt.task_events.events():
        if ev["event"] != "SPAN":
            seqs.setdefault(ev["task_id"], [ev["name"]]).append(ev["event"])
    rows = sorted((r["name"], r["state"]) for r in state.list_tasks())

    def read_trace():
        out = set()
        for s in state.cluster_timeline():
            phase = s.get("args", {}).get("phase")
            if phase:
                out.add((s["name"].split(":", 1)[1], phase,
                         s["pid"].split(":")[0]))
        return out

    # the daemons' spans reach the head on their heartbeats: read until
    # the worker and daemon lanes are in and two reads agree
    duo = "_state_script.<locals>.duo"
    want = {(duo, "dispatch", "daemon"), (duo, "exec", "worker"),
            (duo, "result_flush", "daemon")}
    deadline = time.monotonic() + 20
    prev, trace = None, read_trace()
    while (not want <= trace or trace != prev) \
            and time.monotonic() < deadline:
        time.sleep(0.6)
        prev, trace = trace, read_trace()
    return {"sequences": sorted(tuple(v) for v in seqs.values()),
            "list_tasks": rows, "summary": state.summarize_tasks(),
            "trace": sorted(trace)}


def test_task_states_and_trace_as_in_jax():
    import ray_tpu
    with _jax_without_cyclic_gc():
        ray_tpu.init(num_nodes=2, resources={"CPU": 4}, cluster="daemons")
        try:
            jax_out = _state_script(ray_tpu)
        finally:
            ray_tpu.shutdown()
    rt_api.init(num_nodes=2, resources={"CPU": 4}, cluster="daemons",
                object_store_memory=128 << 20)
    try:
        port_out = _state_script(rt_api)
    finally:
        rt_api.shutdown()
    assert port_out == jax_out


def test_prometheus_rendering_and_delta_merge_as_in_jax():
    """render_prometheus of the same snapshots and merge_deltas of the
    same drained deltas give byte-equal expositions."""
    from ray_tpu.util import metrics as jax_metrics
    from ray_tpu_torch.util import metrics as port_metrics

    def drive(m):
        m.clear_registry()
        try:
            m.Counter("par_req_total", "requests", ("route",)).inc(
                2, tags={"route": "/a"})
            m.Gauge("par_depth", 'depth "q"\nline').set(
                3.5, tags={"slot": "0"})
            h = m.Histogram("par_seconds", "latency", boundaries=(0.1, 1))
            for v in (0.05, 0.5, 5.0):
                h.observe(v, tags={"phase": "exec"})
            deltas = m.drain_deltas()
            m.clear_registry()
            m.merge_deltas(deltas)
            m.merge_deltas(deltas)      # counters and histograms add up
            snap = [e for e in m.export_snapshot()
                    if e["name"].startswith("par_")]
            remote = [{"name": "par_req_total", "kind": "counter",
                       "description": "requests",
                       "samples": [[[["route", "/b"]], 7.0]]}]
            return m.render_prometheus([({}, snap),
                                        ({"node_id": "n1"}, remote)])
        finally:
            m.clear_registry()

    port_text = drive(port_metrics)
    assert port_text == drive(jax_metrics)
    assert 'par_req_total{route="/a"} 4.0' in port_text
    assert 'par_seconds_count{phase="exec"} 6' in port_text


def test_speedscope_and_collapsed_as_in_jax():
    from ray_tpu.util import profiling as jax_profiling
    from ray_tpu_torch.util import profiling

    records = [
        {"proc": "driver", "pid": 1, "mode": "burst", "samples": 4,
         "counts": {"main;a.py:f;a.py:g": 3, "main;a.py:f": 1}},
        {"proc": "worker:2", "pid": 2, "mode": "continuous", "samples": 2,
         "counts": {"main;a.py:f": 2, "main;b.py:h": 2,
                    profiling.PRUNED_STACK: 1}},
    ]
    port_doc = profiling.speedscope_document(records)
    jax_doc = jax_profiling.speedscope_document(records)
    # the exporter names the producing package; the rest is equal
    assert port_doc.pop("exporter") == "ray_tpu_torch.util.profiling"
    jax_doc.pop("exporter")
    assert port_doc == jax_doc
    assert (profiling.merged_collapsed(records)
            == jax_profiling.merged_collapsed(records))


def _export_script(pkg) -> dict:
    """Kinds and fields, in order, of each object's export events."""
    from importlib import import_module
    ee = import_module(f"{pkg.__name__}._private.export_events")
    pgmod = import_module(f"{pkg.__name__}.util.placement_group")

    @pkg.remote
    def f():
        return 1

    @pkg.remote
    class A:
        def ping(self):
            return "pong"

    assert pkg.get(f.remote()) == 1
    a = A.remote()
    assert pkg.get(a.ping.remote()) == "pong"
    pkg.kill(a)
    pg = pgmod.placement_group([{"CPU": 1}])
    pkg.get(pg.ready())
    pgmod.remove_placement_group(pg)
    deadline = time.monotonic() + 10
    logger = ee.get_export_logger()
    while (time.monotonic() < deadline
           and not any("DEAD" in e["state"] for e in logger.read("ACTOR"))):
        time.sleep(0.05)
    out = {}
    for kind in ee.EXPORT_TYPES:
        per_object = {}
        for e in logger.read(kind):
            key = next(v for k, v in e.items() if k.endswith("_id"))
            per_object.setdefault(key, []).append(
                (list(e), e.get("state")))
        out[kind] = sorted(per_object.values())
    return out


def test_export_events_as_in_jax(monkeypatch):
    import ray_tpu
    from ray_tpu._private import export_events as jax_ee
    from ray_tpu_torch._private import export_events as port_ee

    monkeypatch.setenv("RAY_TPU_PROCESS_WORKERS", "0")
    jax_ee.reset_export_logger()
    with _jax_without_cyclic_gc():
        ray_tpu.init(num_nodes=1, resources={"CPU": 4},
                     _system_config={"export_events": True})
        try:
            jax_out = _export_script(ray_tpu)
        finally:
            ray_tpu.shutdown()
            jax_ee.reset_export_logger()
    monkeypatch.delenv("RAY_TPU_PROCESS_WORKERS")
    port_ee.reset_export_logger()
    rt_api.init(num_nodes=1, resources={"CPU": 4},
                _system_config={"export_events": True})
    try:
        port_out = _export_script(rt_api)
    finally:
        rt_api.shutdown()
        port_ee.reset_export_logger()
    assert port_out["TASK"] and port_out["ACTOR"] and port_out["NODE"]
    assert port_out["PLACEMENT_GROUP"]
    assert port_out == jax_out


def test_cli_read_commands_against_a_cluster(daemon_cluster_for_cli):
    """``status``, ``summary``, ``memory``, ``timeline`` and ``profile``
    exit 0 against a running cluster's address (each joins it as a
    second driver); ``debug`` still exits 2 naming its item."""
    import subprocess
    import sys
    backend = daemon_cluster_for_cli.cluster_backend
    env = dict(os.environ, RAY_TPU_ADDRESS=f"127.0.0.1:{backend._head_port}",
               PYTHONPATH=os.path.dirname(os.path.dirname(
                   os.path.abspath(__file__))))
    tl = os.path.join(backend.session_dir, "cli_timeline.json")
    prof = os.path.join(backend.session_dir, "cli_profile.json")
    for argv in (["status"], ["summary"], ["memory"],
                 ["timeline", "--output", tl],
                 ["profile", "--duration", "0.3", "--output", prof]):
        out = subprocess.run(
            [sys.executable, "-m", "ray_tpu_torch.scripts.cli", *argv],
            capture_output=True, text=True, timeout=120, env=env)
        assert out.returncode == 0, (argv, out.stderr[-2000:])
    assert json.load(open(tl))
    assert len(json.load(open(prof))["profiles"]) >= 3
    later = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts.cli", "debug"],
        capture_output=True, text=True, timeout=60, env=env)
    # debug lists the debugger sessions the cluster's KV advertises
    assert later.returncode == 0, later.stderr[-2000:]
    assert "no active debugger sessions" in later.stdout


@pytest.fixture
def daemon_cluster_for_cli():
    rt = rt_api.init(num_nodes=2, resources={"CPU": 2}, cluster="daemons",
                     object_store_memory=64 << 20)

    @rt_api.remote(num_returns=2)
    def duo(i):
        return i, i

    rt_api.get([r for ab in [duo.remote(i) for i in range(4)] for r in ab])
    yield rt
    rt_api.shutdown()
