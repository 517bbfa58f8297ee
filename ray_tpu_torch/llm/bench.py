"""Serving benchmark: open-loop requests/s and TTFT percentiles (counterpart
of ``ray_tpu/llm/bench.py``).

An open-loop load (``ray_tpu_torch.loadgen``: seeded Poisson arrivals,
concurrent client workers, streaming TTFT at the client) against a serve app
over the continuous-batching engine, through the whole data plane: handle,
P2C router, replica, engine. Closed-loop bursts hide queueing collapse, so
every row reports the offered rate's requests/s, TTFT/E2E percentiles and
goodput under an SLO (``serving_section``).

Departures from JAX's module:

- the functions run on the card unless given ``device="cpu"``; JAX's CPU
  fallback (a debug model, two replicas) is what ``device="cpu"`` selects,
  and the bench never picks it by itself;
- the decode attention is an argument, ``decode_attention="kernel"`` by
  default: the hand-written paged kernel (its plain version on CPU tensors).
  JAX's bench reads ``BENCH_DECODE`` and runs its XLA decode without it;
  this module reads no environment variables;
- JAX's ``"platform"`` / ``"tpu_fallback"`` keys become ``"device"``: the
  card's name and power limit as ``nvidia-smi`` gives them, or ``"cpu"``;
- the HTTP client reads the SSE stream with ``read1`` (what has arrived);
  JAX's ``read(4096)`` waits for 4 KiB, about 30 events, before it sees
  the first token, so its TTFT is most of the request's time;
- the run also records the engine's own ``ttft_s`` of each request (from a
  stream's last chunk or a unary result) beside the client's TTFT, and
  ``stream=False`` sends the same load as unary calls.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import subprocess
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.loadgen.recorder import _dist


def _percentile(vals, q: float) -> float:
    """q in [0, 100]."""
    if not vals:
        return 0.0
    return float(np.percentile(vals, q, method="nearest"))


def card(dev) -> str:
    """The card's name and power limit (``nvidia-smi``), or ``"cpu"``."""
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def serving_section(report: dict) -> dict:
    """Flatten a loadgen report into the stable ``serving.*`` keys."""
    good = report.get("goodput", {})
    return {
        "requests_per_second": report["requests_per_second"],
        "ttft_p50_s": report["ttft_s"]["p50"],
        "ttft_p99_s": report["ttft_s"]["p99"],
        "e2e_p50_s": report["e2e_s"]["p50"],
        "e2e_p99_s": report["e2e_s"]["p99"],
        "tpot_p50_s": report["tpot_s"]["p50"],
        "output_tokens_per_second": report["output_tokens_per_second"],
        "goodput_requests_per_second": good.get("requests_per_second",
                                                0.0),
        "goodput_fraction": good.get("fraction", 0.0),
        "slo": good.get("slo", {}),
        "offered_rate": report["spec"]["rate"],
        "arrival": report["spec"]["arrival"],
        "clients": report["spec"]["clients"],
        "completed": report["requests"]["completed"],
        "errors": report["requests"]["errors"],
        "open_loop": True,
    }


def bench_setup(dev, decode_attention: str = "kernel",
                n_layers: Optional[int] = None) -> Dict[str, Any]:
    """The bench's model, engine and load: on the card JAX's TPU row
    (``bench_400m`` at max_seq 1024, random from seed 0; one replica of 32
    slots; 6 requests/s for 16 s from 64 clients, prompts of 32-256 tokens,
    64 new tokens, SLO TTFT 2 s / E2E 30 s; every prefill bucket warmed);
    on the CPU its fallback (the debug model, two replicas of 4 slots, 12
    requests/s for 2.5 s). ``n_layers`` cuts the model's depth."""
    from ray_tpu_torch.loadgen import SLO, LoadSpec
    from ray_tpu_torch.models.llama import LlamaConfig

    if dev.type == "cuda":
        model_cfg = LlamaConfig.bench_400m(max_seq_len=1024)
        replicas, max_slots, max_seq = 1, 32, 1024
        spec = LoadSpec(rate=6.0, duration_s=16.0, clients=64,
                        prompt_len="uniform:32:256", output_len=64,
                        vocab=model_cfg.vocab_size, seed=0,
                        slo=SLO(ttft_s=2.0, e2e_s=30.0))
        # every prefill bucket a uniform:32:256 prompt can land in
        warm_lens = (32, 64, 128, 256)
        config = "llama_400m"
    else:
        replicas, max_slots, max_seq = 2, 4, 128
        model_cfg = LlamaConfig.debug(vocab_size=512, max_seq_len=max_seq)
        spec = LoadSpec(rate=12.0, duration_s=2.5, clients=8,
                        prompt_len="uniform:8:24", output_len=8,
                        vocab=500, seed=0,
                        slo=SLO(ttft_s=1.0, e2e_s=5.0))
        warm_lens = (8, 24)
        config = "debug"
    model_cfg = dataclasses.replace(model_cfg,
                                    decode_attention=decode_attention,
                                    n_layers=n_layers or model_cfg.n_layers)
    return {"model_config": model_cfg, "replicas": replicas,
            "max_slots": max_slots, "max_seq": max_seq, "spec": spec,
            "warm_lens": warm_lens, "config": config}


def http_setup(dev, decode_attention: str = "kernel",
               n_layers: Optional[int] = None) -> Dict[str, Any]:
    """The proxy bench's model and load: on the card ``bench_400m`` at
    max_seq 1024 and 64 requests of 64 prompt tokens, 16 at a time, 64 new
    tokens each; on the CPU the debug model and 8 requests of 12, 4 at a
    time, 8 new tokens. ``n_layers`` cuts the model's depth."""
    from ray_tpu_torch.models.llama import LlamaConfig

    if dev.type == "cuda":
        out = {"model_config": LlamaConfig.bench_400m(max_seq_len=1024),
               "requests": 64, "concurrency": 16, "max_tokens": 64,
               "prompt_len": 64, "max_seq": 1024}
    else:
        out = {"model_config": LlamaConfig.debug(vocab_size=512,
                                                 max_seq_len=128),
               "requests": 8, "concurrency": 4, "max_tokens": 8,
               "prompt_len": 12, "max_seq": 128}
    out["model_config"] = dataclasses.replace(
        out["model_config"], decode_attention=decode_attention,
        n_layers=n_layers or out["model_config"].n_layers)
    return out


class _EngineTTFT:
    """A handle that passes every response through and keeps the engine's
    ``ttft_s`` of each request: a stream's last chunk carries it, as does
    a unary result."""

    def __init__(self, handle):
        self._handle = handle
        self.ttft_s: List[float] = []
        self._lock = threading.Lock()

    def options(self, **kwargs):
        self._handle = self._handle.options(**kwargs)
        return self

    def remote(self, payload):
        return _Response(self, self._handle.remote(payload))

    def _keep(self, value) -> None:
        if isinstance(value, dict) and value.get("ttft_s") is not None:
            with self._lock:
                self.ttft_s.append(value["ttft_s"])


class _Response:
    def __init__(self, owner: _EngineTTFT, response):
        self._owner, self._response = owner, response

    def next(self, timeout=None):
        chunk = self._response.next(timeout=timeout)
        self._owner._keep(chunk)
        return chunk

    def result(self, timeout=None):
        value = self._response.result(timeout=timeout)
        self._owner._keep(value)
        return value


def warm_replicas(rt, model_id: str, warm_lens) -> list:
    """Every replica of ``model_id`` serves one request of each prompt
    length before the timed window; returns the replicas."""
    controller = rt.get_actor("serve_controller")
    reps = rt.get(controller.get_replicas.remote(model_id))["replicas"]
    warm = [{"prompt": [1] * n, "max_tokens": 2} for n in warm_lens]
    rt.get([r.handle_request.remote("__call__", (w,), {})
            for r in reps for w in warm], timeout=600)
    return reps


def run_serving_bench(device: DeviceLike = None, *,
                      decode_attention: str = "kernel",
                      stream: bool = True,
                      n_layers: Optional[int] = None) -> dict:
    """Open-loop serving bench through the whole serve data plane, measured
    at the client. ``stream=False`` sends the same load as unary calls (the
    router's waiter path); TTFT then equals E2E. ``n_layers`` cuts the
    model's depth."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm.serving import (LLMConfig, build_llm_app,
                                           join_engine_threads)
    from ray_tpu_torch.loadgen import HandleTarget, run_load

    dev = resolve_device(device)
    setup = bench_setup(dev, decode_attention, n_layers)
    spec = dataclasses.replace(setup["spec"], stream=stream)
    own = not rt.is_initialized()
    if own:
        rt.init(num_nodes=1, resources={"CPU": 8})
    try:
        cfg = LLMConfig(model_id="bench-serving",
                        model_config=setup["model_config"],
                        max_slots=setup["max_slots"],
                        max_seq=setup["max_seq"],
                        num_replicas=setup["replicas"])
        handle = serve.run(build_llm_app(cfg, device=dev))
        reps = warm_replicas(rt, cfg.model_id, setup["warm_lens"])
        engine = _EngineTTFT(handle)
        report = run_load(HandleTarget(engine, stream=stream,
                                       timeout_s=spec.timeout_s), spec)
        engine_stats = [rt.get(r.handle_request.remote("stats", (), {}),
                               timeout=30) for r in reps]
    finally:
        serve.shutdown()
        if own:
            rt.shutdown()
        join_engine_threads()

    serving = serving_section(report)
    serving["replicas"] = setup["replicas"]
    out = {
        "metric": "llm_serve_requests_per_second",
        "value": serving["requests_per_second"],
        "unit": "req/s",
        "vs_baseline": round(serving["ttft_p50_s"], 4),
        "serving": serving,
        "detail": {
            **report,
            "max_slots": setup["max_slots"],
            "config": setup["config"],
            "decode_attention": decode_attention,
            "engine_stats": engine_stats,
            "engine_ttft_s": _dist(engine.ttft_s),
        },
        "device": card(dev),
    }
    return out


def run_direct_bench(device: DeviceLike = None, *,
                     decode_attention: str = "kernel") -> dict:
    """``run_serving_bench``'s streaming load straight into one
    ``LLMServer`` (no runtime, no serve): the same engine, spec and
    warm-up, each client reading ``server.stream``. The yardstick of what
    serve adds to a token; the same result keys."""
    from ray_tpu_torch.llm.serving import LLMConfig, LLMServer
    from ray_tpu_torch.loadgen import run_load

    dev = resolve_device(device)
    setup = bench_setup(dev, decode_attention)
    server = LLMServer(LLMConfig(model_id="bench-direct",
                                 model_config=setup["model_config"],
                                 max_slots=setup["max_slots"],
                                 max_seq=setup["max_seq"]), device=dev)
    engine = _EngineTTFT(None)

    def target(payload, rec, t0):
        for chunk in server.stream(payload):
            now = time.perf_counter() - t0
            if rec.first_token_at is None:
                rec.first_token_at = now
            if chunk.get("done"):
                engine._keep(chunk)
            else:
                rec.output_tokens += 1
        rec.finished_at = time.perf_counter() - t0

    try:
        for n in setup["warm_lens"]:
            server({"prompt": [1] * n, "max_tokens": 2})
        report = run_load(target, setup["spec"])
        engine_stats = [server.stats()]
    finally:
        server.shutdown()
    serving = serving_section(report)
    serving["replicas"] = 1
    return {
        "metric": "llm_direct_requests_per_second",
        "value": serving["requests_per_second"],
        "unit": "req/s",
        "serving": serving,
        "detail": {
            **report,
            "max_slots": setup["max_slots"],
            "config": setup["config"],
            "decode_attention": decode_attention,
            "engine_stats": engine_stats,
            "engine_ttft_s": _dist(engine.ttft_s),
        },
        "device": card(dev),
    }


def run_http_proxy_bench(device: DeviceLike = None, *,
                         decode_attention: str = "kernel",
                         n_layers: Optional[int] = None) -> dict:
    """Proxy-level serving bench: TTFT and output tokens/s measured at the
    HTTP client through the asyncio ingress, serve's data plane and the
    engine. On the card: 64 requests of 64 prompt tokens, 16 at a time,
    64 new tokens each; on the CPU 8 of 12, 4 at a time, 8 new tokens.
    ``n_layers`` cuts the model's depth."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm.serving import (LLMConfig, build_llm_app,
                                           join_engine_threads)

    dev = resolve_device(device)
    setup = http_setup(dev, decode_attention, n_layers)
    model_cfg, max_seq = setup["model_config"], setup["max_seq"]
    n_requests, concurrency = setup["requests"], setup["concurrency"]
    max_tokens, prompt_len = setup["max_tokens"], setup["prompt_len"]
    vocab = model_cfg.vocab_size

    own = not rt.is_initialized()
    if own:
        rt.init(num_nodes=1, resources={"CPU": 8})
    rng = np.random.default_rng(0)
    results: dict = {}
    try:
        cfg = LLMConfig(model_id="bench-http", model_config=model_cfg,
                        max_slots=16, max_seq=max_seq)
        serve.run(build_llm_app(cfg, device=dev))
        port = serve.start_http_proxy(port=0, max_ongoing_requests=256)

        def one_request(out, idx):
            prompt = [int(x) for x in rng.integers(1, vocab, prompt_len)]
            body = json.dumps({"prompt": prompt, "stream": True,
                               "max_tokens": max_tokens})
            conn = http.client.HTTPConnection("127.0.0.1", port,
                                              timeout=300)
            t0 = time.perf_counter()
            ttft, tokens, done = None, 0, False
            try:
                conn.request("POST", "/", body=body,
                             headers={"Content-Type": "application/json",
                                      "Accept": "text/event-stream"})
                resp = conn.getresponse()
                buf = b""
                while not done:
                    chunk = resp.read1(4096)
                    if not chunk:
                        break
                    buf += chunk
                    while b"\n\n" in buf:
                        event, buf = buf.split(b"\n\n", 1)
                        if not event.startswith(b"data: "):
                            continue
                        data = event[6:]
                        if data == b"[DONE]":
                            done = True
                            break
                        if ttft is None:
                            ttft = time.perf_counter() - t0
                        try:
                            if "token_id" in json.loads(data):
                                tokens += 1
                        except json.JSONDecodeError:
                            pass
            finally:
                conn.close()
            out[idx] = (ttft, tokens, done)

        # a warm-up burst outside the timing
        warm: dict = {}
        warm_threads = [threading.Thread(target=one_request, args=(warm, i))
                        for i in range(min(concurrency, 4))]
        for t in warm_threads:
            t.start()
        for t in warm_threads:
            t.join()

        t0 = time.perf_counter()
        sem = threading.Semaphore(concurrency)

        def gated(idx):
            with sem:
                one_request(results, idx)

        threads = [threading.Thread(target=gated, args=(i,))
                   for i in range(n_requests)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        reps = rt.get(rt.get_actor("serve_controller").get_replicas.remote(
            cfg.model_id))["replicas"]
        engine_stats = [rt.get(r.handle_request.remote("stats", (), {}),
                               timeout=30) for r in reps]
    finally:
        serve.shutdown()
        if own:
            rt.shutdown()
        join_engine_threads()

    ttfts = sorted(t for t, _, _ in results.values() if t is not None)
    total_tokens = sum(n for _, n, _ in results.values())
    out = {
        "metric": "llm_serve_http_output_tokens_per_sec",
        "value": round(total_tokens / wall, 1) if wall else 0.0,
        "unit": "tokens/s",
        "vs_baseline": round(_percentile(ttfts, 50), 4),
        "detail": {
            "ttft_p50_ms": round(_percentile(ttfts, 50) * 1e3, 2),
            "ttft_p90_ms": round(_percentile(ttfts, 90) * 1e3, 2),
            "ttft_p99_ms": round(_percentile(ttfts, 99) * 1e3, 2),
            "requests": n_requests,
            "concurrency": concurrency,
            "output_tokens": total_tokens,
            "streams_done": sum(d for _, _, d in results.values()),
            "wall_s": round(wall, 3),
            "plane": "asyncio-http-proxy",
            "decode_attention": decode_attention,
            "engine_stats": engine_stats,
        },
        "device": card(dev),
    }
    return out
