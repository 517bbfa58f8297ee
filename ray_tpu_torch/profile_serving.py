"""What serve adds to a token under open-loop load, on the card.

    python -m ray_tpu_torch.profile_serving [--pairs 3]

Runs the serving bench's load (``llm.bench``'s card row: bench_400m, one
engine of 32 slots, the paged kernel, seeded Poisson arrivals at 6
requests/s for 16 s, 64 clients, 64 new tokens) straight into an
``LLMServer`` (``run_direct_bench``) and streamed through serve's handle
(``run_serving_bench``), in turns: direct, serve, serve, direct, and so on
for ``--pairs`` pairs, so that neither side always runs first. It prints
one JSON line a run (TPOT, E2E and TTFT p50/p99, decode steps) and a last
line with each side's medians, serve's TPOT over direct's in each pair,
and the card's name and power limit. It needs a card.
"""

from __future__ import annotations

import argparse
import json
import statistics


def main(argv=None) -> int:
    from ray_tpu_torch._device import resolve_device
    from ray_tpu_torch.llm.bench import (card, run_direct_bench,
                                         run_serving_bench)

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=3)
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    runs = {"direct": [], "serve": []}
    for i in range(args.pairs):
        order = ("direct", "serve") if i % 2 == 0 else ("serve", "direct")
        for side in order:
            out = (run_direct_bench(dev) if side == "direct"
                   else run_serving_bench(dev))
            s = out["serving"]
            row = {"pair": i, "side": side, "tpot_p50_s": s["tpot_p50_s"],
                   "e2e_p50_s": s["e2e_p50_s"], "e2e_p99_s": s["e2e_p99_s"],
                   "ttft_p50_s": s["ttft_p50_s"],
                   "ttft_p99_s": s["ttft_p99_s"],
                   "completed": s["completed"], "errors": s["errors"],
                   "decode_steps": sum(st["decode_steps"] for st in
                                       out["detail"]["engine_stats"])}
            runs[side].append(row)
            print(json.dumps(row), flush=True)
    ratios = [s["tpot_p50_s"] / d["tpot_p50_s"]
              for d, s in zip(runs["direct"], runs["serve"])]
    print(json.dumps({
        "device": card(dev),
        "median_tpot_p50_s": {k: statistics.median(r["tpot_p50_s"]
                                                   for r in v)
                              for k, v in runs.items()},
        "median_e2e_p50_s": {k: statistics.median(r["e2e_p50_s"] for r in v)
                             for k, v in runs.items()},
        "serve_over_direct_tpot_by_pair": ratios}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
