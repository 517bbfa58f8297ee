"""Core-op microbenchmarks, the harness behind the CLI's
``microbenchmark`` (counterpart of ``ray_tpu/_private/perf.py``): task,
actor-call, put, put/get and compiled-DAG round rates of the port's
runtime, timed on the host's clock.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List

import numpy as np


def _timeit(name: str, fn: Callable[[], int],
            duration_s: float = 2.0) -> Dict:
    # warmup
    fn()
    t0 = time.perf_counter()
    count = 0
    while time.perf_counter() - t0 < duration_s:
        count += fn()
    dt = time.perf_counter() - t0
    return {"name": name, "throughput_per_s": round(count / dt, 1),
            "count": count, "seconds": round(dt, 3)}


def run_microbenchmarks(duration_s: float = 2.0) -> List[Dict]:
    """Boot a runtime and measure core-op throughputs."""
    import ray_tpu_torch

    own = not ray_tpu_torch.is_initialized()
    if own:
        ray_tpu_torch.init(num_nodes=1, resources={"CPU": 8})
    results: List[Dict] = []

    @ray_tpu_torch.remote
    def noop():
        return None

    def tasks_batch():
        ray_tpu_torch.get([noop.remote() for _ in range(100)])
        return 100
    results.append(_timeit("tasks_per_second", tasks_batch, duration_s))

    @ray_tpu_torch.remote
    class A:
        def m(self):
            return None

    a = A.remote()

    def actor_batch():
        ray_tpu_torch.get([a.m.remote() for _ in range(100)])
        return 100
    results.append(_timeit("actor_calls_per_second", actor_batch,
                           duration_s))

    small = np.zeros(8, np.float64)

    def put_small():
        refs = [ray_tpu_torch.put(small) for _ in range(100)]
        del refs
        return 100
    results.append(_timeit("puts_small_per_second", put_small, duration_s))

    big = np.zeros(1024 * 1024, np.uint8)  # 1 MiB

    def put_get_1mb():
        for _ in range(10):
            ray_tpu_torch.get(ray_tpu_torch.put(big))
        return 10
    results.append(_timeit("put_get_1MiB_per_second", put_get_1mb,
                           duration_s))

    # compiled-DAG rounds over shm channels (no RPC in the steady state)
    # through a two-stage process-worker pipeline; on a daemon cluster the
    # actors live in daemons and the DAG takes the dynamic schedule, which
    # the row then measures
    from ray_tpu_torch.dag import InputNode

    @ray_tpu_torch.remote
    class _Stage:
        def f(self, x):
            return x + 1

    s1, s2 = _Stage.remote(), _Stage.remote()
    ray_tpu_torch.get([s1.f.remote(0), s2.f.remote(0)])
    with InputNode() as inp:
        dag = s2.f.bind(s1.f.bind(inp))
    compiled = dag.experimental_compile()

    def dag_rounds():
        refs = [compiled.execute(i) for i in range(50)]
        for r in refs:
            ray_tpu_torch.get(r)
        return 50
    results.append(_timeit("compiled_dag_execs_per_second", dag_rounds,
                           duration_s))
    compiled.teardown()

    if own:
        ray_tpu_torch.shutdown()
    return results


def queued_task_drain(n: int = 10_000) -> Dict:
    """Scale envelope probe (reference: release/benchmarks/README.md:25-31
    — 1M+ tasks queued on one node): submit ``n`` no-op tasks without
    consuming, then drain them all."""
    import ray_tpu_torch

    own = not ray_tpu_torch.is_initialized()
    if own:
        ray_tpu_torch.init(num_nodes=1, resources={"CPU": 8})

    @ray_tpu_torch.remote
    def noop():
        return None

    t0 = time.perf_counter()
    refs = [noop.remote() for _ in range(n)]
    t_submit = time.perf_counter() - t0
    ray_tpu_torch.get(refs)
    t_total = time.perf_counter() - t0
    if own:
        ray_tpu_torch.shutdown()
    return {"name": f"queued_{n}_task_drain",
            "n": n,
            "submit_seconds": round(t_submit, 3),
            "total_seconds": round(t_total, 3),
            "submit_per_s": round(n / t_submit, 1),
            "drain_per_s": round(n / t_total, 1)}


def burst_submit_batched(n: int = 3000) -> Dict:
    """Burst-submit tasks on the CLASSIC wire path (two returns keeps
    them off the native fast lane), so the daemons topology measures the
    submit coalescer end to end: push_task_batch frames out, batched
    task_batch_done completions back."""
    import ray_tpu_torch

    own = not ray_tpu_torch.is_initialized()
    if own:
        ray_tpu_torch.init(num_nodes=1, resources={"CPU": 8})

    @ray_tpu_torch.remote(num_returns=2)
    def duo():
        return None, None

    t0 = time.perf_counter()
    refs = [duo.remote() for _ in range(n)]
    t_submit = time.perf_counter() - t0
    ray_tpu_torch.get([r for ab in refs for r in ab])
    t_total = time.perf_counter() - t0
    if own:
        ray_tpu_torch.shutdown()
    return {"name": "burst_submit_batched", "n": n,
            "submit_seconds": round(t_submit, 3),
            "total_seconds": round(t_total, 3),
            "submit_per_s": round(n / t_submit, 1),
            "drain_per_s": round(n / t_total, 1)}


def main() -> int:
    """Emit one JSON line a benchmark for the current mode (set
    RAY_TPU_CLUSTER=daemons for the daemon cluster): ``python -m
    ray_tpu_torch._private.perf``."""
    import json
    import os
    import sys

    duration = float(os.environ.get("PERF_DURATION_S", "2.0"))
    drain_n = int(os.environ.get("PERF_DRAIN_N", "10000"))
    for row in run_microbenchmarks(duration_s=duration):
        print(json.dumps(row))
        sys.stdout.flush()
    print(json.dumps(burst_submit_batched()))
    sys.stdout.flush()
    print(json.dumps(queued_task_drain(drain_n)))
    sys.stdout.flush()
    # scaling TREND: does the drain rate hold at 3x the backlog?
    print(json.dumps(queued_task_drain(3 * drain_n)))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
