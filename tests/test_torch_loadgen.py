"""loadgen and the serving bench on the port: the JAX package's loadgen
tests (``tests/test_loadgen.py``) on ``ray_tpu_torch.loadgen``, the same
specs through both packages, the serving test of
``tests/test_bench_smoke.py`` on ``ray_tpu_torch.llm.bench`` with
``device="cpu"``, and the serve example.

Left uncopied: ``test_ray_tpu_cli_dispatches_loadgen_after_global_flags``
(the ``ray-tpu`` CLI comes with ROADMAP A11c).
"""

import json
import os
import random
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.loadgen import (SLO, LatencyRecorder, LengthSampler,
                                   LoadSpec, RequestRecord, arrival_times,
                                   build_payloads, percentile, run_load)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# arrival schedules + length distributions
# ---------------------------------------------------------------------------

def test_poisson_schedule_deterministic_for_seed():
    a = arrival_times("poisson", 50, 4, seed=7)
    assert a == arrival_times("poisson", 50, 4, seed=7)
    assert a != arrival_times("poisson", 50, 4, seed=8)
    assert a == sorted(a)
    assert all(0 <= t < 4 for t in a)
    # E[n] = rate * duration = 200, sd ~14: loose 4-sigma bounds
    assert 140 < len(a) < 260


def test_constant_schedule_exact_spacing():
    assert arrival_times("constant", 10, 1.0) == [
        i / 10 for i in range(10)]


def test_arrival_validation():
    with pytest.raises(ValueError, match="unknown arrival"):
        arrival_times("bursty", 1, 1)
    with pytest.raises(ValueError, match="rate"):
        arrival_times("poisson", 0, 1)
    with pytest.raises(ValueError, match="duration"):
        arrival_times("poisson", 1, 0)


def test_length_sampler_forms():
    r = random.Random(0)
    assert LengthSampler.parse(32).sample(r) == 32
    assert LengthSampler.parse("16").sample(r) == 16
    uni = LengthSampler.parse("uniform:4:9")
    assert {uni.sample(r) for _ in range(300)} == set(range(4, 10))
    lgn = LengthSampler.parse("lognormal:64:0.5")
    vals = sorted(lgn.sample(r) for _ in range(301))
    assert all(v >= 1 for v in vals)
    assert 40 < vals[150] < 100          # median ~64
    with pytest.raises(ValueError):
        LengthSampler.parse("uniform:9:4")
    with pytest.raises(ValueError):
        LengthSampler.parse("zipf:1:2")


def test_payloads_deterministic_with_shared_prefix():
    spec = LoadSpec(prompt_len="uniform:4:8", output_len=5,
                    prefix_len=6, seed=9)
    a = build_payloads(spec, 20)
    assert a == build_payloads(spec, 20)
    prefix = a[0]["prompt"][:6]
    assert all(p["prompt"][:6] == prefix for p in a)
    assert all(4 <= len(p["prompt"]) - 6 <= 8 for p in a)
    assert all(p["max_tokens"] == 5 for p in a)


# ---------------------------------------------------------------------------
# percentile / goodput math (hand-checkable synthetic trace)
# ---------------------------------------------------------------------------

def test_percentile_nearest_rank():
    vals = [float(i) for i in range(1, 11)]
    assert percentile(vals, 50) == 5.0
    assert percentile(vals, 90) == 9.0
    assert percentile(vals, 99) == 10.0
    assert percentile(vals, 100) == 10.0
    assert percentile([3.0], 99) == 3.0
    assert percentile([], 50) == 0.0


def test_recorder_summary_math_on_synthetic_trace():
    rec = LatencyRecorder()
    # request i (1..4): ttft = 0.1*i, e2e = 0.2*i, 3 output tokens
    # => tpot = (e2e - ttft) / 2 = 0.05*i
    for i in range(1, 5):
        rec.add(RequestRecord(scheduled_at=0.0, sent_at=1.0,
                              first_token_at=1.0 + i * 0.1,
                              finished_at=1.0 + i * 0.2,
                              output_tokens=3))
    rec.add(RequestRecord(scheduled_at=0.0, sent_at=1.0, error="boom"))
    rep = rec.summary(slo=SLO(ttft_s=0.25, e2e_s=1.0), wall_s=2.0)
    assert rep["requests"] == {"total": 5, "completed": 4, "errors": 1}
    assert rep["requests_per_second"] == 2.0
    assert rep["output_tokens"] == 12
    assert rep["ttft_s"]["p50"] == pytest.approx(0.2)
    assert rep["ttft_s"]["p99"] == pytest.approx(0.4)
    assert rep["e2e_s"]["max"] == pytest.approx(0.8)
    assert rep["tpot_s"]["p50"] == pytest.approx(0.1)
    good = rep["goodput"]
    assert good["completed_within_slo"] == 2     # ttft 0.1, 0.2 pass
    assert good["fraction"] == 0.5
    assert good["requests_per_second"] == 1.0
    assert rep["error_samples"] == ["boom"]


def test_slo_unbounded_dimensions():
    ok = RequestRecord(scheduled_at=0, sent_at=0, first_token_at=5.0,
                       finished_at=9.0, output_tokens=1)
    assert SLO().met_by(ok)                      # no bounds: any done
    assert not SLO(e2e_s=1.0).met_by(ok)
    assert SLO(e2e_s=10.0).met_by(ok)
    err = RequestRecord(scheduled_at=0, sent_at=0, error="x")
    assert not SLO().met_by(err)                 # errors never count


# ---------------------------------------------------------------------------
# run_load: report schema + open-loop semantics (no cluster needed)
# ---------------------------------------------------------------------------

def test_run_load_report_schema_and_open_loop_lateness():
    """One slow client vs a 100/s constant schedule: open loop keeps
    the arrivals on schedule and books the lag as queue time."""

    def slow_target(payload, rec, t0):
        time.sleep(0.05)
        now = time.perf_counter() - t0
        rec.first_token_at = now
        rec.finished_at = now
        rec.output_tokens = 1

    spec = LoadSpec(rate=100, duration_s=0.2, clients=1,
                    arrival="constant", seed=0, slo=SLO(ttft_s=5.0))
    rep = run_load(slow_target, spec)
    for key in ("requests", "wall_s", "requests_per_second", "ttft_s",
                "tpot_s", "e2e_s", "queue_s", "goodput", "spec",
                "target", "scheduled_requests"):
        assert key in rep, key
    assert rep["scheduled_requests"] == 20
    assert rep["requests"]["completed"] == 20
    # 20 requests x 50ms serial vs a 0.2s window: the tail waited
    assert rep["queue_s"]["max"] > 0.5
    json.dumps(rep)          # JSON-serializable end to end


def test_run_load_records_target_errors():
    def flaky(payload, rec, t0):
        raise RuntimeError("nope")

    spec = LoadSpec(rate=50, duration_s=0.1, clients=2,
                    arrival="constant", seed=0)
    rep = run_load(flaky, spec)
    assert rep["requests"]["total"] == 5
    assert rep["requests"]["errors"] == 5
    assert rep["goodput"]["completed_within_slo"] == 0
    assert any("nope" in s for s in rep["error_samples"])


def test_handle_target_stream_enforces_timeout():
    """A wedged streaming replica must surface as a counted timeout
    error, not an eternal client hang: the per-request deadline bounds
    every chunk wait (regression — timeout_s was unary-only)."""
    from ray_tpu_torch.loadgen import HandleTarget

    class _SlowGen:
        def next(self, timeout=None):
            # honors the per-chunk budget the target hands down, but
            # the stream never finishes
            time.sleep(min(timeout or 0.05, 0.05) + 0.02)
            return "tok"

    class _FakeHandle:
        def options(self, **kw):
            return self

        def remote(self, payload):
            return _SlowGen()

    target = HandleTarget(_FakeHandle(), stream=True, timeout_s=0.1)
    rec = RequestRecord(scheduled_at=0.0)
    with pytest.raises(TimeoutError):
        target({}, rec, time.perf_counter())

    spec = LoadSpec(rate=30, duration_s=0.1, clients=2,
                    arrival="constant", seed=0, timeout_s=0.1,
                    drain_timeout_s=5.0)
    rep = run_load(target, spec)
    assert rep["requests"]["errors"] == rep["requests"]["total"] > 0
    assert any("timeout" in s.lower() for s in rep["error_samples"])


# ---------------------------------------------------------------------------
# CLI smoke against a self-hosted debug-model serve app
# ---------------------------------------------------------------------------

def test_cli_smoke_debug_app(tmp_path):
    out_json = tmp_path / "report.json"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.loadgen", "--clients", "4",
         "--rate", "15", "--duration", "1.5", "--prompt-len", "8",
         "--output-len", "4", "--replicas", "2", "--seed", "1",
         "--device", "cpu", "--json", str(out_json)],
        capture_output=True, text=True, timeout=300, env=env,
        cwd=REPO_ROOT)
    assert proc.returncode == 0, (proc.stdout[-500:], proc.stderr[-800:])
    assert "== loadgen report ==" in proc.stdout
    assert "goodput" in proc.stdout
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("{")]
    rep = json.loads(lines[-1])
    assert rep["requests"]["completed"] > 0
    assert rep["requests"]["errors"] == 0
    assert rep["ttft_s"]["p50"] > 0
    assert rep["spec"]["clients"] == 4
    disk = json.loads(out_json.read_text())
    assert disk["requests"] == rep["requests"]


def test_cli_runs_tenant_jobs(tmp_path):
    """``--jobs 2 --job-weights 2,1`` drives the self-hosted app as two
    tenants and prints the multi-job report and one JSON line."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.loadgen", "--clients", "2",
         "--rate", "8", "--duration", "1.0", "--prompt-len", "8",
         "--output-len", "4", "--replicas", "1", "--seed", "1",
         "--jobs", "2", "--job-weights", "2,1", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, env=env,
        cwd=REPO_ROOT)
    assert proc.returncode == 0, (proc.stdout[-500:], proc.stderr[-800:])
    assert "== loadgen multi-job report ==" in proc.stdout
    rep = json.loads([ln for ln in proc.stdout.splitlines()
                      if ln.startswith("{")][-1])
    assert sorted(rep["jobs"]) == ["loadgen-job-0", "loadgen-job-1"]
    assert rep["multitenancy"]["weights"] == {"loadgen-job-0": 2.0,
                                              "loadgen-job-1": 1.0}
    for job in rep["jobs"].values():
        assert job["requests"]["errors"] == 0
        assert job["requests"]["completed"] > 0


# ---------------------------------------------------------------------------
# the same specs through both packages
# ---------------------------------------------------------------------------

SPECS = [
    LoadSpec(rate=6.0, duration_s=16.0, clients=64,
             prompt_len="uniform:32:256", output_len=64, vocab=32_000,
             seed=0, slo=SLO(ttft_s=2.0, e2e_s=30.0)),
    LoadSpec(rate=50, duration_s=4, arrival="constant",
             prompt_len="lognormal:64:0.5", output_len="uniform:4:9",
             prefix_len=6, seed=9),
    LoadSpec(rate=12.0, duration_s=2.5, clients=8,
             prompt_len="uniform:8:24", output_len=8, vocab=500, seed=3),
]


@pytest.mark.parametrize("idx", range(len(SPECS)))
def test_arrivals_and_payloads_equal_jax(idx):
    """The same ``LoadSpec`` gives the same arrival times (exactly) and
    the same payloads in both packages."""
    import ray_tpu.loadgen as jl
    spec = SPECS[idx]
    jspec = jl.LoadSpec(**{k: getattr(spec, k) for k in (
        "rate", "duration_s", "clients", "arrival", "prompt_len",
        "output_len", "prefix_len", "vocab", "seed", "stream")})
    times = arrival_times(spec.arrival, spec.rate, spec.duration_s,
                          spec.seed)
    assert times == jl.arrival_times(jspec.arrival, jspec.rate,
                                     jspec.duration_s, jspec.seed)
    assert len(times) > 0
    assert build_payloads(spec, len(times)) == jl.build_payloads(
        jspec, len(times))
    assert spec.to_dict() == {**jspec.to_dict(),
                              "slo": spec.to_dict()["slo"]}


def test_recorder_summary_equals_jax():
    """One synthetic trace (seeded: times, errors, token counts) into both
    recorders gives the same summary, and both reports format alike."""
    import ray_tpu.loadgen as jl
    from ray_tpu.loadgen.runner import format_report as jformat
    from ray_tpu_torch.loadgen import format_report

    rng = np.random.default_rng(4)
    recs = {"port": LatencyRecorder(), "jax": jl.LatencyRecorder()}
    for _ in range(200):
        sched = float(rng.uniform(0, 10))
        sent = sched + float(rng.exponential(0.05))
        kw = dict(scheduled_at=sched, sent_at=sent)
        if rng.random() < 0.05:
            kw["error"] = f"err{int(rng.integers(3))}"
        else:
            first = sent + float(rng.exponential(0.3))
            kw.update(first_token_at=first,
                      finished_at=first + float(rng.exponential(2.0)),
                      output_tokens=int(rng.integers(1, 65)))
        recs["port"].add(RequestRecord(**kw))
        recs["jax"].add(jl.RequestRecord(**kw))
    for slo_kw in ({}, {"ttft_s": 0.5}, {"ttft_s": 0.5, "e2e_s": 3.0}):
        port = recs["port"].summary(slo=SLO(**slo_kw), wall_s=12.5)
        jax = recs["jax"].summary(slo=jl.SLO(**slo_kw), wall_s=12.5)
        assert port == jax
        extra = {"spec": SPECS[0].to_dict(), "target": "t",
                 "scheduled_requests": 200}
        assert format_report({**port, **extra}) == jformat({**jax, **extra})
    assert recs["port"].summary() == recs["jax"].summary()


def test_multi_job_load_waits_for_tenancy():
    """``run_multi_job_load`` (the tenancy layer's ``job_context`` around
    each request) on both packages with one synthetic target: each job's
    requests run as that job's tenant, the reports have JAX's shape and
    request counts, and ``format_multi_report``/``jain_fairness`` are
    JAX's."""
    from ray_tpu_torch.loadgen import (format_multi_report, jain_fairness,
                                       run_multi_job_load)
    from ray_tpu_torch.tenancy import current_job_id
    from ray_tpu_torch.tenancy.context import canonical_job
    import ray_tpu.loadgen as jl
    from ray_tpu.tenancy import current_job_id as j_current_job_id

    def make_target(current):
        seen = []

        def target(payload, rec, t0):
            seen.append(current().hex())
            now = time.perf_counter() - t0
            rec.sent_at = now
            rec.first_token_at = now + 0.001
            rec.finished_at = now + 0.002
            rec.output_tokens = 4
        return target, seen

    spec = dict(rate=40.0, duration_s=0.5, clients=2, seed=3)
    port_target, port_seen = make_target(current_job_id)
    jax_target, jax_seen = make_target(j_current_job_id)
    port = run_multi_job_load(port_target, LoadSpec(**spec), jobs=2,
                              weights=[2.0])
    jax = jl.run_multi_job_load(jax_target, jl.LoadSpec(**spec), jobs=2,
                                weights=[2.0])
    assert sorted(port["jobs"]) == sorted(jax["jobs"])
    assert port["multitenancy"]["weights"] == jax["multitenancy"]["weights"]
    assert set(port["multitenancy"]) == set(jax["multitenancy"])
    for name in port["jobs"]:
        assert (port["jobs"][name]["requests"]
                == jax["jobs"][name]["requests"])
    # every request ran inside its own job's context
    expected = {canonical_job(n)[0] for n in port["jobs"]}
    assert set(port_seen) == expected == set(jax_seen)
    # the formatter on one fixed report
    fixed = {"jobs": {n: {"requests": {"completed": 3, "total": 4},
                          "e2e_s": {"p99": 0.25}}
                      for n in ("job-a", "job-b")},
             "multitenancy": {"weights": {"job-a": 2.0, "job-b": 1.0},
                              "goodput_per_job": {"job-a": 1.5,
                                                  "job-b": 0.5},
                              "fairness_index": 0.8,
                              "isolation_p99_ratio": 1.0}}
    assert format_multi_report(fixed) == jl.format_multi_report(fixed)
    for shares in ([1.0, 1.0], [3.0, 1.0, 0.0], []):
        assert jain_fairness(shares) == jl.jain_fairness(shares)


# ---------------------------------------------------------------------------
# the serving bench (tests/test_bench_smoke.py) and the serve example
# ---------------------------------------------------------------------------

@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_serving_bench_cpu_smoke(one_thread):
    """The bench's open-loop run through the whole serve data plane, with
    ``device="cpu"``: JAX's CPU row, the paged kernel's plain version."""
    from ray_tpu_torch.llm.bench import run_serving_bench

    out = run_serving_bench("cpu")
    assert out["metric"] == "llm_serve_requests_per_second"
    assert out["value"] > 0
    s = out["serving"]
    assert s["requests_per_second"] > 0
    assert s["open_loop"] is True and s["replicas"] == 2
    assert s["errors"] == 0 and s["completed"] > 0
    assert np.isfinite(s["ttft_p50_s"]) and s["ttft_p50_s"] > 0
    assert s["ttft_p99_s"] >= s["ttft_p50_s"]
    assert s["e2e_p99_s"] >= s["e2e_p50_s"] >= s["ttft_p50_s"]
    assert 0.0 <= s["goodput_fraction"] <= 1.0
    assert out["device"] == "cpu"
    detail = out["detail"]
    assert detail["spec"]["stream"] is True
    assert detail["decode_attention"] == "kernel"
    assert detail["scheduled_requests"] == s["completed"]
    assert "abandoned_clients" not in detail
    # every request's engine TTFT came back, under its client TTFT
    assert detail["engine_ttft_s"]["p50"] <= s["ttft_p50_s"]
    assert sum(st["requests"] for st in detail["engine_stats"]) == \
        s["completed"] + 2 * 2        # two warm-up prompts a replica
    assert not ray_tpu_torch.is_initialized()


def test_serving_bench_unary_and_http_cpu(one_thread):
    from ray_tpu_torch.llm.bench import run_http_proxy_bench, \
        run_serving_bench

    out = run_serving_bench("cpu", stream=False)
    s = out["serving"]
    assert s["errors"] == 0 and s["completed"] == \
        out["detail"]["scheduled_requests"]
    assert out["detail"]["spec"]["stream"] is False
    assert s["ttft_p50_s"] == s["e2e_p50_s"]        # unary: first == last
    http = run_http_proxy_bench("cpu")
    d = http["detail"]
    assert http["metric"] == "llm_serve_http_output_tokens_per_sec"
    assert http["value"] > 0 and http["device"] == "cpu"
    assert d["streams_done"] == d["requests"] == 8
    assert d["output_tokens"] == 8 * 8
    assert 0 < d["ttft_p50_ms"] <= d["ttft_p90_ms"]


@pytest.mark.parametrize("name", ["bench_setup", "http_setup"])
def test_bench_setup_cuts_depth_only(name):
    """``n_layers`` (chip_smoke.py's depth cut) changes the bench model's
    depth and nothing else of its config."""
    import dataclasses
    from ray_tpu_torch.llm import bench

    setup = getattr(bench, name)
    whole = setup(torch.device("cpu"))["model_config"]
    cut = setup(torch.device("cpu"), n_layers=1)["model_config"]
    assert whole.n_layers > 1 and cut.n_layers == 1
    assert dataclasses.replace(cut, n_layers=whole.n_layers) == whole


def test_direct_bench_cpu_smoke(one_thread):
    """The bench's streaming load straight into an ``LLMServer``: every
    scheduled request completes, with the bench's result keys."""
    from ray_tpu_torch.llm.bench import run_direct_bench

    out = run_direct_bench("cpu")
    s, detail = out["serving"], out["detail"]
    assert s["errors"] == 0 and s["completed"] == \
        detail["scheduled_requests"] > 0
    assert 0 < s["ttft_p50_s"] <= s["e2e_p50_s"] and s["tpot_p50_s"] > 0
    assert detail["engine_stats"][0]["requests"] == s["completed"] + 2
    assert detail["engine_ttft_s"]["p50"] > 0 and out["device"] == "cpu"
    assert not ray_tpu_torch.is_initialized()


def test_serve_llama_example_on_the_cpu(one_thread):
    from ray_tpu_torch.examples import serve_llama
    ray_tpu_torch.init(num_nodes=1, resources={"CPU": 8})
    try:
        out = serve_llama.main(["--device", "cpu"])
        assert out["usage"]["completion_tokens"] == 8
        rep = serve_llama.main(["--load", "--rate", "6", "--duration", "1.5",
                                "--clients", "4", "--device", "cpu"])
        assert rep["requests"]["errors"] == 0
        assert rep["requests"]["completed"] == rep["scheduled_requests"] > 0
        assert rep["goodput"]["slo"] == {"ttft_s": 1.0, "e2e_s": 5.0}
    finally:
        ray_tpu_torch.shutdown()


def test_bench_and_cli_default_to_the_card():
    """Without ``device`` the bench and the CLI's app resolve the card, and
    raise on a host without one."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from ray_tpu_torch import profile_serving
    from ray_tpu_torch.llm.bench import run_direct_bench, run_serving_bench
    for entry in (run_serving_bench, run_direct_bench,
                  lambda: profile_serving.main([])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()
    assert not ray_tpu_torch.is_initialized()


def test_http_target_sees_the_first_event_when_it_arrives():
    """An SSE server sends one event at once and three more 0.3 s apart:
    the port's client sees the first event when it arrives. JAX's
    ``read(4096)`` waits for 4 KiB, which these short events never reach,
    so its TTFT is the whole request's (ROADMAP C9)."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    import ray_tpu.loadgen as jl
    from ray_tpu_torch.loadgen import HTTPTarget

    class SSE(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *args):
            pass

        def do_POST(self):
            self.rfile.read(int(self.headers["Content-Length"]))
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            for i in range(4):
                if i:
                    time.sleep(0.3)
                data = f"data: {json.dumps({'token_id': i})}\n\n".encode()
                self.wfile.write(b"%x\r\n%s\r\n" % (len(data), data))
                self.wfile.flush()
            done = b"data: [DONE]\n\n"
            self.wfile.write(b"%x\r\n%s\r\n0\r\n\r\n" % (len(done), done))
            self.wfile.flush()

    server = ThreadingHTTPServer(("127.0.0.1", 0), SSE)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    recs = {}
    try:
        for name, cls in (("port", HTTPTarget), ("jax", jl.HTTPTarget)):
            target = cls("127.0.0.1", server.server_address[1], timeout_s=10)
            rec = recs[name] = RequestRecord(scheduled_at=0.0)
            target({"prompt": [1], "stream": True}, rec, time.perf_counter())
    finally:
        server.shutdown()
        server.server_close()
    for rec in recs.values():
        assert rec.output_tokens == 4 and rec.e2e_s > 0.8
    assert recs["port"].ttft_s < 0.25, recs["port"]
    assert recs["jax"].ttft_s > 0.8, recs["jax"]
