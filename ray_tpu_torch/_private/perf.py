"""Core-op microbenchmarks, the harness behind the CLI's
``microbenchmark`` (counterpart of ``ray_tpu/_private/perf.py``): task,
actor-call, put, put/get and compiled-DAG round rates of the port's
runtime, timed on the host's clock; with ``PERF_ENVELOPE=1`` the scale
envelope's rows too.
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
    if os.environ.get("PERF_ENVELOPE") == "1":
        for row in envelope_rows():
            print(json.dumps(row))
            sys.stdout.flush()
    return 0


def envelope_rows() -> List[Dict]:
    """The scale envelope's single-host slices (the reference's 1M+
    queued tasks, 40k actors, 2,000 nodes): a backlog ladder of 100k, 300k
    and 1M queued tasks, 5,000 live actors created and called, 256 tasks
    spread over 64 virtual nodes. Leaves no runtime up."""
    import os
    import ray_tpu_torch

    rows: List[Dict] = []
    if not ray_tpu_torch.is_initialized():
        ray_tpu_torch.init(num_nodes=1, resources={"CPU": 8})

    @ray_tpu_torch.remote(_in_process=True)
    def val(i):
        return i

    # climb the ladder until the host cannot hold the next rung (memory,
    # threads, pids) or a rung outlasts the budget (the next would take
    # ~3x as long); every rung that held is a row
    budget_s = float(os.environ.get("PERF_ENVELOPE_DRAIN_BUDGET_S", "120"))
    for n in (100_000, 300_000, 1_000_000):
        t0 = time.perf_counter()
        try:
            refs = [val.remote(i) for i in range(n)]
            submit_s = time.perf_counter() - t0
            out = ray_tpu_torch.get(refs)
            total_s = time.perf_counter() - t0
            assert out[-1] == n - 1
            del refs, out
        except Exception:
            break       # the rung below is the host's envelope
        rows.append({"name": f"queued_{n}_task_drain", "n": n,
                     "submit_seconds": round(submit_s, 3),
                     "total_seconds": round(total_s, 3),
                     "submit_per_s": round(n / submit_s, 1),
                     "drain_per_s": round(n / total_s, 1)})
        if total_s > budget_s:
            break

    @ray_tpu_torch.remote(_in_process=True)
    class Cell:
        def __init__(self, i):
            self.i = i

        def get(self):
            return self.i

    t0 = time.perf_counter()
    cells = [Cell.remote(i) for i in range(5000)]
    out = ray_tpu_torch.get([c.get.remote() for c in cells])
    total_s = time.perf_counter() - t0
    assert out[-1] == 4999
    rows.append({"name": "actors_5000_create_and_call",
                 "throughput_per_s": round(5000 / total_s, 1),
                 "count": 5000, "seconds": round(total_s, 3)})
    for c in cells:
        ray_tpu_torch.kill(c)

    # the node count is an init argument: the spread has its own runtime
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_nodes=64, resources={"CPU": 2})

    @ray_tpu_torch.remote(_in_process=True, scheduling_strategy="SPREAD")
    def where():
        return ray_tpu_torch.get_runtime_context().get_node_id()

    t0 = time.perf_counter()
    nodes = set(ray_tpu_torch.get([where.remote() for _ in range(256)]))
    total_s = time.perf_counter() - t0
    rows.append({"name": "spread_256_tasks_64_nodes",
                 "throughput_per_s": round(256 / total_s, 1),
                 "count": len(nodes), "seconds": round(total_s, 3)})
    ray_tpu_torch.shutdown()
    return rows


if __name__ == "__main__":
    raise SystemExit(main())
