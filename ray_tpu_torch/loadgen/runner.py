"""Open-loop many-client load runner over serve handles or HTTP
(counterpart of ``ray_tpu/loadgen/runner.py``).

``run_load(target, spec)`` drives the target with ``spec.clients``
concurrent client workers pulling from one precomputed arrival schedule:
each request fires at its scheduled offset (workers sleep until then), and
when every worker is busy the schedule keeps advancing. The lateness lands
in the request's ``queue_s`` instead of thinning the offered load.

Targets are callables ``(payload, rec, t0)`` that run one request and stamp
``rec.sent_at / first_token_at / finished_at / output_tokens`` relative to
``t0``. Two adapters:

- :class:`HandleTarget` drives a ``DeploymentHandle``, streaming (a chunk a
  token; TTFT = the first chunk) or unary;
- :class:`HTTPTarget` drives the HTTP proxy, SSE-aware.

``run_multi_job_load`` drives several tenants at once, each request in its
job's ``tenancy.job_context``, and reports per-job goodput, Jain's fairness
index and the isolation ratio of the jobs' E2E p99s.

One departure: ``HTTPTarget`` reads the SSE stream with ``read1``, which
returns what has arrived. JAX's ``read(4096)`` waits for 4 KiB or the end
of the body, about 30 token events, so its TTFT is most of the E2E time.
"""

from __future__ import annotations

import dataclasses
import json
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Union

from ray_tpu_torch.loadgen.arrival import LengthSampler, arrival_times
from ray_tpu_torch.loadgen.recorder import SLO, LatencyRecorder, RequestRecord

Target = Callable[[Any, RequestRecord, float], None]


@dataclasses.dataclass
class LoadSpec:
    """One reproducible open-loop workload (seeded end to end)."""

    rate: float = 10.0            # offered requests/s
    duration_s: float = 5.0       # arrival window (drain may run longer)
    clients: int = 8              # concurrent client workers
    arrival: str = "poisson"      # or "constant"
    prompt_len: Union[int, str] = 32    # LengthSampler spec
    output_len: Union[int, str] = 16    # LengthSampler spec (max_tokens)
    prefix_len: int = 0           # common prompt prefix shared by ALL
    #                               requests (exercises prefix caching)
    vocab: int = 500              # prompt token id range [1, vocab)
    seed: int = 0
    stream: bool = True           # streaming responses (real TTFT)
    timeout_s: float = 120.0      # per-request client timeout
    drain_timeout_s: float = 300.0  # wait for in-flight after last arrival
    slo: SLO = dataclasses.field(
        default_factory=lambda: SLO(ttft_s=2.0, e2e_s=30.0))

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["prompt_len"] = str(self.prompt_len)
        d["output_len"] = str(self.output_len)
        return d


def build_payloads(spec: LoadSpec, n: int) -> List[Dict[str, Any]]:
    """Deterministic completion-shaped payloads for ``n`` arrivals.

    Prompt tokens, prompt lengths and output lengths come from three
    independent seeded streams so changing one knob (say the output
    distribution) does not reshuffle the others.
    """
    import random

    prompt_lens = LengthSampler.parse(spec.prompt_len)
    output_lens = LengthSampler.parse(spec.output_len)
    rng_plen = random.Random(f"{spec.seed}:prompt_len")
    rng_olen = random.Random(f"{spec.seed}:output_len")
    rng_toks = random.Random(f"{spec.seed}:tokens")
    prefix = [rng_toks.randint(1, spec.vocab - 1)
              for _ in range(max(0, spec.prefix_len))]
    payloads = []
    for _ in range(n):
        plen = prompt_lens.sample(rng_plen)
        body = [rng_toks.randint(1, spec.vocab - 1) for _ in range(plen)]
        payloads.append({
            "prompt": prefix + body,
            "max_tokens": output_lens.sample(rng_olen),
            "stream": spec.stream,
        })
    return payloads


class HandleTarget:
    """Drive a Serve ``DeploymentHandle`` (the in-cluster data plane)."""

    def __init__(self, handle, stream: bool = True,
                 timeout_s: float = 120.0):
        self._handle = (handle.options(stream=True) if stream
                        else handle)
        self._stream = stream
        self._timeout_s = timeout_s

    def __call__(self, payload, rec: RequestRecord, t0: float) -> None:
        if self._stream:
            gen = self._handle.remote(payload)
            deadline = (time.perf_counter() + self._timeout_s
                        if self._timeout_s else None)
            while True:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        raise TimeoutError(
                            f"no chunk within timeout_s={self._timeout_s}")
                try:
                    chunk = (gen.next(timeout=remaining)
                             if hasattr(gen, "next") else next(gen))
                except StopIteration:
                    break
                now = time.perf_counter() - t0
                if rec.first_token_at is None:
                    rec.first_token_at = now
                if isinstance(chunk, dict):
                    if chunk.get("done"):
                        continue    # terminal summary chunk, not a token
                    rec.output_tokens += 1
                else:
                    rec.output_tokens += 1
            rec.finished_at = time.perf_counter() - t0
            return
        result = self._handle.remote(payload).result(
            timeout=self._timeout_s)
        now = time.perf_counter() - t0
        rec.first_token_at = now     # unary: first byte == last byte
        rec.finished_at = now
        usage = (result.get("usage")
                 if isinstance(result, dict) else None)
        rec.output_tokens = (int(usage["completion_tokens"])
                             if usage else 1)

    def __repr__(self):
        return f"HandleTarget(stream={self._stream})"


class HTTPTarget:
    """Drive the HTTP proxy; SSE streaming when the payload asks."""

    def __init__(self, host: str, port: int, path: str = "/",
                 timeout_s: float = 120.0):
        self.host, self.port, self.path = host, port, path
        self._timeout_s = timeout_s

    @classmethod
    def from_url(cls, url: str, timeout_s: float = 120.0) -> "HTTPTarget":
        from urllib.parse import urlparse

        p = urlparse(url if "//" in url else f"http://{url}")
        return cls(p.hostname or "127.0.0.1", p.port or 80,
                   p.path or "/", timeout_s)

    def __call__(self, payload, rec: RequestRecord, t0: float) -> None:
        import http.client

        stream = isinstance(payload, dict) and payload.get("stream")
        body = json.dumps(payload)
        headers = {"Content-Type": "application/json"}
        if stream:
            headers["Accept"] = "text/event-stream"
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=self._timeout_s)
        try:
            conn.request("POST", self.path, body=body, headers=headers)
            resp = conn.getresponse()
            if resp.status != 200:
                resp.read()
                raise RuntimeError(f"HTTP {resp.status}")
            if not stream:
                raw = resp.read()
                now = time.perf_counter() - t0
                rec.first_token_at = now
                rec.finished_at = now
                try:
                    usage = json.loads(raw).get("usage")
                    rec.output_tokens = (int(usage["completion_tokens"])
                                         if usage else 1)
                except (ValueError, AttributeError, KeyError):
                    rec.output_tokens = 1
                return
            buf = b""
            while True:
                chunk = resp.read1(4096)
                if not chunk:
                    break
                buf += chunk
                now = time.perf_counter() - t0
                while b"\n\n" in buf:
                    event, buf = buf.split(b"\n\n", 1)
                    if not event.startswith(b"data: "):
                        continue
                    data = event[6:]
                    if data == b"[DONE]":
                        continue
                    if rec.first_token_at is None:
                        rec.first_token_at = now
                    try:
                        parsed = json.loads(data)
                    except ValueError:
                        continue
                    if isinstance(parsed, dict) and parsed.get("done"):
                        continue
                    rec.output_tokens += 1
            rec.finished_at = time.perf_counter() - t0
        finally:
            conn.close()

    def __repr__(self):
        return f"HTTPTarget({self.host}:{self.port}{self.path})"


def run_load(target: Target, spec: LoadSpec,
             payloads: Optional[List[Any]] = None) -> Dict[str, Any]:
    """Run one open-loop load against ``target``; returns the report.

    The report is the recorder summary plus run metadata — JSON-
    serializable end to end (the BENCH/CLI contract).
    """
    from ray_tpu_torch.util.metrics import Counter

    times = arrival_times(spec.arrival, spec.rate, spec.duration_s,
                          spec.seed)
    if payloads is None:
        payloads = build_payloads(spec, len(times))
    if len(payloads) < len(times):
        raise ValueError(
            f"{len(payloads)} payloads for {len(times)} arrivals")
    recorder = LatencyRecorder()
    requests_total = Counter(
        "ray_tpu_loadgen_requests_total",
        "loadgen client requests by outcome")
    work: "queue.Queue" = queue.Queue()
    for sched, payload in zip(times, payloads):
        work.put((sched, payload))
    t0 = time.perf_counter()

    def client_worker() -> None:
        while True:
            try:
                sched, payload = work.get_nowait()
            except queue.Empty:
                return
            delay = t0 + sched - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            rec = RequestRecord(scheduled_at=sched)
            rec.sent_at = time.perf_counter() - t0
            try:
                target(payload, rec, t0)
                requests_total.inc(tags={"status": "ok"})
            except Exception as e:
                rec.error = repr(e)[:200]
                rec.finished_at = time.perf_counter() - t0
                requests_total.inc(tags={"status": "error"})
            recorder.add(rec)

    workers = [threading.Thread(target=client_worker, daemon=True,
                                name=f"loadgen-client-{i}")
               for i in range(max(1, spec.clients))]
    for w in workers:
        w.start()
    deadline = time.monotonic() + spec.duration_s + spec.drain_timeout_s
    abandoned = 0
    for w in workers:
        w.join(timeout=max(0.0, deadline - time.monotonic()))
        if w.is_alive():
            abandoned += 1
    wall_s = time.perf_counter() - t0
    report = recorder.summary(slo=spec.slo, wall_s=wall_s)
    report["spec"] = spec.to_dict()
    report["target"] = repr(target)
    report["scheduled_requests"] = len(times)
    if abandoned:
        # loud, not silent: these workers still held a request when the
        # drain window closed — the completed counts under-report load
        report["abandoned_clients"] = abandoned
    return report


def jain_fairness(shares: List[float]) -> float:
    """Jain's fairness index over per-job allocations: ``(Σx)²/(n·Σx²)``
    — 1.0 when every job gets the same (weight-normalized) share, → 1/n
    when one job takes everything."""
    xs = [max(0.0, float(x)) for x in shares]
    if not xs or not any(xs):
        return 0.0
    return (sum(xs) ** 2) / (len(xs) * sum(x * x for x in xs))


def run_multi_job_load(target: Target, spec: LoadSpec, jobs: int = 2,
                       weights: Optional[List[float]] = None,
                       job_prefix: str = "loadgen-job"
                       ) -> Dict[str, Any]:
    """Drive ``jobs`` concurrent tenants through one target.

    Each job runs its own open-loop :func:`run_load` (offered rate
    split evenly, independent arrival/payload seeds) with every request
    wrapped in that job's :func:`ray_tpu_torch.tenancy.job_context` — the
    wrapper re-enters the scope inside the client worker thread because
    contextvars do not cross thread boundaries. The combined report
    carries per-job reports plus a ``multitenancy`` section:

    - ``fairness_index`` — Jain's index over weight-normalized goodput
      (``goodput_j / weight_j``);
    - ``isolation_p99_ratio`` — max/min per-job E2E p99: 1.0 means no
      job's tail is inflated by its neighbors.
    """
    from ray_tpu_torch.tenancy import job_context

    n = max(1, int(jobs))
    ws = [float(w) for w in (weights or [])][:n]
    ws += [1.0] * (n - len(ws))
    reports: Dict[str, Dict[str, Any]] = {}
    errors: List[BaseException] = []

    def one_job(idx: int) -> None:
        name = f"{job_prefix}-{idx}"
        jspec = dataclasses.replace(
            spec, rate=spec.rate / n, seed=spec.seed + 1000 * idx)

        def wrapped(payload, rec, t0, _name=name, _w=ws[idx]):
            with job_context(_name, weight=_w):
                target(payload, rec, t0)

        try:
            reports[name] = run_load(wrapped, jspec)
        except BaseException as e:   # surfaced after join
            errors.append(e)

    runners = [threading.Thread(target=one_job, args=(i,), daemon=True,
                                name=f"loadgen-job-{i}")
               for i in range(n)]
    t0 = time.perf_counter()
    for r in runners:
        r.start()
    for r in runners:
        r.join()
    if errors:
        raise errors[0]
    wall_s = time.perf_counter() - t0

    names = sorted(reports)
    goodput = {
        name: float((reports[name].get("goodput") or {})
                    .get("requests_per_second", 0.0))
        for name in names}
    weights_by_job = {f"{job_prefix}-{i}": ws[i] for i in range(n)}
    shares = [goodput[name] / max(weights_by_job[name], 1e-9)
              for name in names]
    p99s = [float(reports[name]["e2e_s"]["p99"] or 0.0)
            for name in names]
    iso = (max(p99s) / max(min(p99s), 1e-9)) if p99s else 0.0
    return {
        "jobs": reports,
        "wall_s": wall_s,
        "multitenancy": {
            "num_jobs": n,
            "weights": weights_by_job,
            "goodput_per_job": goodput,
            "fairness_index": jain_fairness(shares),
            "isolation_p99_ratio": iso,
        },
        "spec": spec.to_dict(),
        "target": repr(target),
    }


def format_multi_report(report: Dict[str, Any]) -> str:
    """Human-readable summary of a :func:`run_multi_job_load` report."""
    mt = report["multitenancy"]
    lines = ["== loadgen multi-job report =="]
    for name in sorted(report["jobs"]):
        rep = report["jobs"][name]
        req = rep["requests"]
        lines.append(
            f"{name} (w={mt['weights'][name]:g}): "
            f"{req['completed']}/{req['total']} done, "
            f"goodput {mt['goodput_per_job'][name]:.2f} req/s, "
            f"E2E p99 {rep['e2e_s']['p99'] * 1e3:.1f} ms")
    lines.append(
        f"fairness index (Jain, weight-normalized goodput): "
        f"{mt['fairness_index']:.3f}")
    lines.append(
        f"isolation p99 ratio (max/min across jobs): "
        f"{mt['isolation_p99_ratio']:.2f}")
    return "\n".join(lines)


def format_report(report: Dict[str, Any]) -> str:
    """Human-readable summary of a :func:`run_load` report."""
    req = report["requests"]
    lines = [
        "== loadgen report ==",
        f"offered: {report['spec']['arrival']} "
        f"{report['spec']['rate']:g} req/s x "
        f"{report['spec']['duration_s']:g}s, "
        f"{report['spec']['clients']} clients "
        f"({report['scheduled_requests']} requests)",
        f"completed: {req['completed']}/{req['total']} "
        f"({req['errors']} errors) in {report['wall_s']:.2f}s",
        f"requests/s: {report['requests_per_second']:.2f}   "
        f"output tok/s: {report['output_tokens_per_second']:.1f}",
        f"TTFT  p50/p99: {report['ttft_s']['p50'] * 1e3:.1f} / "
        f"{report['ttft_s']['p99'] * 1e3:.1f} ms",
        f"E2E   p50/p99: {report['e2e_s']['p50'] * 1e3:.1f} / "
        f"{report['e2e_s']['p99'] * 1e3:.1f} ms",
        f"TPOT  p50:     {report['tpot_s']['p50'] * 1e3:.2f} ms",
        f"queue p50/p99: {report['queue_s']['p50'] * 1e3:.1f} / "
        f"{report['queue_s']['p99'] * 1e3:.1f} ms",
    ]
    good = report.get("goodput")
    if good:
        slo = good["slo"]
        bounds = ", ".join(
            f"{k}<={v:g}" for k, v in slo.items() if v is not None)
        lines.append(
            f"goodput ({bounds or 'no bounds'}): "
            f"{good['requests_per_second']:.2f} req/s "
            f"({good['fraction'] * 100:.1f}% of completed)")
    if report.get("abandoned_clients"):
        lines.append(
            f"WARNING: {report['abandoned_clients']} client(s) still "
            f"in flight at drain timeout")
    return "\n".join(lines)
