"""The host plane's lane rates in the forms ``chip_smoke.py`` measures them,
for two trees of the repo side by side on one host.

Each child process imports ``chip_smoke`` and ``ray_tpu_torch`` from one
tree, holds the card as ``chip_smoke.py``'s driver does, and measures:

* 19(a), the driver's lane: a fresh ``init()``, 100 no-op tasks to start
  the lane, then ``chip_smoke.noop_rate`` (1,000 tasks after 100 more),
  ``--reps`` times;
* 20(a), the daemons' lanes: ``init(cluster="daemons", num_nodes=2,
  resources={"CPU": 4})``, ``chip_smoke.noop_rate``, ``--reps`` times;
* 22(a), the lane-bound actor: a fresh cluster of the same shape, the
  lane-bound actor and its ``max_concurrency=2`` twin,
  ``chip_smoke.lane_rates`` (1,000 calls a path in ``--reps`` alternated
  pairs).

A child's figure for each rate is the median of its reps.

A round runs one child per tree in the order first, second, second,
first. Each rate's round ratio is the second tree's mean over the first's;
the summary gives each rate's median ratio over the rounds and a 95%
bootstrap interval of the mean ratio. Run from the repo's root:

    python3 chip_lane_ab.py --trees PARENT_DIR . --rounds 6 \\
        --out lane_ab.json

``--device cpu`` hides the card from every child (a CPU-only host).
``--added-cost`` instead times, in this process, the per-call code that
the owner routing adds on those paths (``added_cost``).
"""

from __future__ import annotations

import argparse
import json
import os
import random
import statistics
import subprocess
import sys
import time

RATES = ("driver_lane", "daemon_lane", "actor_lane", "actor_classic")


def child(tree: str, device: str, reps: int) -> dict:
    """One tree's four rates, in this process."""
    sys.path.insert(0, tree)
    import torch
    import chip_smoke as cs
    import ray_tpu_torch as rt
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no card: pass --device cpu")
        torch.ones(1, device="cuda").sum().item()     # the driver's context
    out = {"tree": os.path.abspath(tree),
           "package": os.path.dirname(os.path.abspath(rt.__file__))}
    rt.init()
    try:
        fn = cs.noop()
        rt.get([fn.remote() for _ in range(100)])      # starts the lane
        out["driver_lane_reps"] = [cs.noop_rate(fn)[0] for _ in range(reps)]
    finally:
        rt.shutdown()
    cluster = dict(cluster="daemons", num_nodes=2, resources={"CPU": 4})
    rt.init(**cluster)
    try:
        fn = cs.noop()
        out["daemon_lane_reps"] = [cs.noop_rate(fn)[0] for _ in range(reps)]
    finally:
        rt.shutdown()
    runtime = rt.init(**cluster)
    try:
        handles = list(runtime.cluster_backend.daemons.values())
        Lane = cs.lane_actor_class()
        lane = Lane.remote()
        classic = Lane.options(max_concurrency=2).remote()
        rt.get([lane.pid.remote(), classic.pid.remote()])
        rates = cs.lane_rates(handles, lane, classic, pairs=reps)["rates"]
        out["actor_lane_reps"] = rates["lane"]
        out["actor_classic_reps"] = rates["classic"]
    finally:
        rt.shutdown()
    for key in RATES:
        out[key] = statistics.median(out[f"{key}_reps"])
    return out


def added_cost(n: int = 20000) -> dict:
    """Microseconds a call of what the owner routing adds to one driver's
    lane and classic paths, timed in this process on the package that
    ``import ray_tpu_torch`` finds: the lane frame with and without its
    token (built by the driver, decoded by the worker), the worker's bind
    and reset of the token, and the owner lookup each thread start does."""
    import pickle
    import timeit
    from types import SimpleNamespace
    from ray_tpu_torch._private import fast_lane as fl
    from ray_tpu_torch._private import worker_process as wp
    ident = SimpleNamespace(binary=lambda: os.urandom(16))
    spec = SimpleNamespace(method_name="pid", task_id=ident, actor_id=ident,
                           name="Lane.pid", resources={},
                           placement_group_id=None, pg_capture=False)
    args, token = os.urandom(64), "c:0123456789ab"

    def us(fn):
        return min(timeit.repeat(fn, number=n, repeat=5)) / n * 1e6

    frames = {own: fl.build_actor_payload(spec, args, ident, ident, own)
              for own in (None, token)}
    build = {own: us(lambda o=own: fl.build_actor_payload(
        spec, args, ident, ident, o)) for own in frames}
    decode = {own: us(lambda f=f: pickle.loads(f))
              for own, f in frames.items()}

    def bind():
        wp._set_owner(token)
        wp._current_rid.own = None

    out = {"frame_bytes": len(frames[token]) - len(frames[None]),
           "build_us": build[token] - build[None],
           "decode_us": decode[token] - decode[None],
           "bind_us": us(bind), "thread_start_us": us(wp._current_owner)}
    out["total_us"] = sum(out[k] for k in ("build_us", "decode_us",
                                           "bind_us", "thread_start_us"))
    return out


def run_child(tree: str, device: str, reps: int, timeout: float) -> dict:
    env = dict(os.environ)
    if device == "cpu":
        env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--child", tree,
         "--device", device, "--reps", str(reps)],
        cwd=tree, env=env, capture_output=True, text=True, timeout=timeout)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"the child on {tree} exited {proc.returncode}:\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return json.loads(lines[-1])


def interval(ratios: list, draws: int = 10000, seed: int = 0) -> list:
    """A 95% bootstrap interval of the mean of ``ratios``."""
    rng = random.Random(seed)
    means = sorted(statistics.fmean(rng.choices(ratios, k=len(ratios)))
                   for _ in range(draws))
    return [means[int(0.025 * draws)], means[int(0.975 * draws) - 1]]


def summary(rounds: list) -> dict:
    out = {}
    for key in RATES:
        first = [[r[0][key], r[3][key]] for r in rounds]
        second = [[r[1][key], r[2][key]] for r in rounds]
        ratios = [statistics.fmean(b) / statistics.fmean(a)
                  for a, b in zip(first, second)]
        out[key] = {"first": first, "second": second,
                    "first_median": statistics.median(sum(first, [])),
                    "second_median": statistics.median(sum(second, [])),
                    "ratios": ratios,
                    "median_ratio": statistics.median(ratios),
                    "mean_ratio_95": interval(ratios)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs=2, metavar=("FIRST", "SECOND"))
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", help="also write the summary here")
    ap.add_argument("--added-cost", action="store_true",
                    help="only time the code the owner routing adds")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds a child may take")
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(child(args.child, args.device, args.reps)),
              flush=True)
        return 0
    if args.added_cost:
        print(json.dumps(added_cost()), flush=True)
        return 0
    if not args.trees:
        ap.error("--trees FIRST SECOND is required")
    trees = [os.path.abspath(t) for t in args.trees]
    t0 = time.perf_counter()
    rounds = []
    for i in range(args.rounds):
        row = []
        for tree in (trees[0], trees[1], trees[1], trees[0]):
            rates = run_child(tree, args.device, args.reps, args.timeout)
            print(json.dumps({"round": i, **rates}), flush=True)
            row.append(rates)
        rounds.append(row)
    out = {"trees": trees, "rounds": args.rounds, "reps": args.reps,
           "device": args.device,
           "seconds": time.perf_counter() - t0, "rates": summary(rounds)}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
