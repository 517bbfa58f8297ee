"""CLI: ``python -m ray_tpu_torch.loadgen`` (counterpart of
``ray_tpu/loadgen/__main__.py``).

Self-contained by default: starts the runtime, deploys a debug-model LLM app
with ``--replicas`` replicas on the card (``--device cpu``: on the CPU),
drives it open-loop through serve handles, and prints the human summary and
one machine-readable JSON line. ``--url`` drives an HTTP proxy that is
already running instead; ``--http`` serves the self-hosted app through the
HTTP proxy and measures at the client. ``--jobs`` above 1 runs that many
tenants at once (``--job-weights`` gives their fair-share weights) and
reports per-job goodput, Jain's fairness index and the isolation ratio.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch.loadgen",
        description="open-loop serving load generator (SLO benchmark)")
    p.add_argument("--clients", type=int, default=16,
                   help="concurrent client workers (default 16)")
    p.add_argument("--rate", type=float, default=20.0,
                   help="offered requests/s (default 20)")
    p.add_argument("--duration", type=float, default=5.0,
                   help="arrival window seconds (default 5)")
    p.add_argument("--arrival", choices=("poisson", "constant"),
                   default="poisson")
    p.add_argument("--prompt-len", default="uniform:8:24",
                   help="tokens: N | uniform:lo:hi | "
                        "lognormal:median:sigma (default uniform:8:24)")
    p.add_argument("--output-len", default="8",
                   help="max_tokens distribution (same forms, default 8)")
    p.add_argument("--prefix-len", type=int, default=0,
                   help="common prompt prefix tokens shared by all "
                        "requests (exercises prefix caching)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-stream", action="store_true",
                   help="unary requests (TTFT == E2E)")
    p.add_argument("--slo-ttft-s", type=float, default=2.0,
                   help="TTFT bound for goodput (default 2.0)")
    p.add_argument("--slo-e2e-s", type=float, default=30.0,
                   help="E2E bound for goodput (default 30.0)")
    p.add_argument("--timeout-s", type=float, default=120.0,
                   help="per-request client timeout")
    p.add_argument("--drain-timeout-s", type=float, default=300.0,
                   help="wait for in-flight requests after last arrival")
    p.add_argument("--url", default="",
                   help="drive an EXISTING HTTP endpoint "
                        "(host:port[/path]) instead of self-hosting")
    p.add_argument("--http", action="store_true",
                   help="self-host, but drive through the HTTP proxy")
    p.add_argument("--replicas", type=int, default=2,
                   help="replicas for the self-hosted debug app "
                        "(default 2)")
    p.add_argument("--max-slots", type=int, default=4,
                   help="engine slots per replica (self-hosted)")
    p.add_argument("--max-seq", type=int, default=128,
                   help="engine max sequence length (self-hosted)")
    p.add_argument("--device", default=None,
                   help="the self-hosted app's device: the card by "
                        "default, 'cpu' off it")
    p.add_argument("--jobs", type=int, default=1,
                   help="run N concurrent tenant jobs (offered rate "
                        "split evenly); reports per-job goodput plus "
                        "Jain fairness + isolation p99 ratio")
    p.add_argument("--job-weights", default="", metavar="W1,W2,...",
                   help="per-job fair-share weights for --jobs "
                        "(default: all 1.0)")
    p.add_argument("--json", default="", metavar="PATH",
                   help="also write the full JSON report to PATH")
    return p


def _self_hosted_target(args, spec):
    """Start the runtime and the debug LLM app; returns (target, cleanup)."""
    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm.serving import (LLMConfig, build_llm_app,
                                           join_engine_threads)
    from ray_tpu_torch.loadgen.runner import HTTPTarget, HandleTarget

    own = not ray_tpu_torch.is_initialized()
    if own:
        ray_tpu_torch.init(num_nodes=1, resources={"CPU": 8},
                           ignore_reinit_error=True)
    cfg = LLMConfig(model_id="loadgen-debug",
                    max_slots=args.max_slots, max_seq=args.max_seq,
                    num_replicas=args.replicas)
    handle = serve.run(build_llm_app(cfg, device=args.device))

    # warm every replica's engine before the timed window
    controller = ray_tpu_torch.get_actor("serve_controller")
    replicas = ray_tpu_torch.get(
        controller.get_replicas.remote(cfg.model_id))["replicas"]
    warm = {"prompt": [1] * 8, "max_tokens": 2}
    ray_tpu_torch.get([r.handle_request.remote("__call__", (warm,), {})
                       for r in replicas], timeout=300)

    if args.http:
        port = serve.start_http_proxy(port=0)
        target = HTTPTarget("127.0.0.1", port,
                            timeout_s=spec.timeout_s)
    else:
        target = HandleTarget(handle, stream=spec.stream,
                              timeout_s=spec.timeout_s)

    def cleanup():
        serve.shutdown()
        if own:
            ray_tpu_torch.shutdown()
        join_engine_threads()

    return target, cleanup


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    from ray_tpu_torch.loadgen.recorder import SLO
    from ray_tpu_torch.loadgen.runner import (HTTPTarget, LoadSpec,
                                              format_multi_report,
                                              format_report, run_load,
                                              run_multi_job_load)

    spec = LoadSpec(
        rate=args.rate, duration_s=args.duration, clients=args.clients,
        arrival=args.arrival, prompt_len=args.prompt_len,
        output_len=args.output_len, prefix_len=args.prefix_len,
        seed=args.seed, stream=not args.no_stream,
        timeout_s=args.timeout_s, drain_timeout_s=args.drain_timeout_s,
        slo=SLO(ttft_s=args.slo_ttft_s, e2e_s=args.slo_e2e_s))

    cleanup = None
    if args.url:
        target = HTTPTarget.from_url(args.url, timeout_s=spec.timeout_s)
    else:
        target, cleanup = _self_hosted_target(args, spec)
    try:
        if args.jobs > 1:
            weights = [float(w) for w in args.job_weights.split(",")
                       if w.strip()]
            report = run_multi_job_load(target, spec, jobs=args.jobs,
                                        weights=weights)
        else:
            report = run_load(target, spec)
    finally:
        if cleanup is not None:
            cleanup()

    if args.jobs > 1:
        print(format_multi_report(report))
    else:
        print(format_report(report))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")
        print(f"report written to {args.json}")
    print(json.dumps(report))
    if args.jobs > 1:
        reqs = [r["requests"] for r in report["jobs"].values()]
        done = sum(r["completed"] for r in reqs)
        errs = sum(r["errors"] for r in reqs)
    else:
        done = report["requests"]["completed"]
        errs = report["requests"]["errors"]
    return 0 if done > 0 and not errs else 1


if __name__ == "__main__":
    sys.exit(main())
