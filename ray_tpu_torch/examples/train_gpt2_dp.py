"""BASELINE config 2: GPT-2 data-parallel training on an all-dp mesh
(counterpart of ``examples/train_gpt2_dp.py``).

The data parallelism is a mesh axis: the params are replicated DTensors, the
batch is sharded over dp, and DTensor all-reduces the gradients; no wrapper
module.

Run on the cards, one process a card:
  torchrun --nproc-per-node 4 -m ray_tpu_torch.examples.train_gpt2_dp --full
On the CPU, four gloo ranks (debug widths):
  python -m ray_tpu_torch.examples.train_gpt2_dp --cpu --ranks 4
"""

import argparse
import time
from typing import Optional

import numpy as np
import torch.distributed as dist

from ray_tpu_torch.models import GPT2Config, GPT2Model
from ray_tpu_torch.parallel import (MeshSpec, build_mesh,
                                    initialize_multihost, spawn_ranks)
from ray_tpu_torch.train import make_train_step, shard_batch


def main(debug: bool = True, steps: int = 5, device: Optional[str] = None,
         batch: Optional[int] = None, seq: Optional[int] = None) -> dict:
    """Train for ``steps`` steps on one batch; returns the losses and the
    mean step time of the steps after the first two (host clock, device
    synchronised)."""
    initialize_multihost()
    n = dist.get_world_size() if dist.is_initialized() else 1
    mesh = build_mesh(MeshSpec.auto(n), device=device)   # all-dp mesh
    cfg = GPT2Config.debug() if debug else GPT2Config.gpt2_125m()
    model = GPT2Model(cfg, mesh=mesh)
    ts = make_train_step(model, mesh=mesh)
    params, opt = ts.init_fn(0)

    rng = np.random.default_rng(0)
    B = batch or max(4, n)
    S = seq or min(128, cfg.max_seq_len)
    toks = rng.integers(0, cfg.vocab_size, (B, S))
    data = shard_batch((toks, np.roll(toks, -1, 1)), ts)

    losses, times = [], []
    for step in range(steps):
        t0 = time.perf_counter()
        params, opt, m = ts.step_fn(params, opt, data)
        losses.append(float(m["loss"]))          # waits for the step
        times.append(time.perf_counter() - t0)
        if not dist.is_initialized() or dist.get_rank() == 0:
            print(f"step {step}: loss={losses[-1]:.4f}", flush=True)
    timed = times[2:] or times
    return {"losses": losses, "step_ms": 1e3 * sum(timed) / len(timed),
            "batch": B, "seq": S, "mesh": str(mesh)}


def _rank(debug, steps):
    return main(debug=debug, steps=steps, device="cpu")


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--debug", action="store_true", default=True)
    p.add_argument("--full", dest="debug", action="store_false")
    p.add_argument("--cpu", action="store_true",
                   help="gloo ranks on the CPU instead of the cards")
    p.add_argument("--ranks", type=int, default=4,
                   help="with --cpu: how many ranks to spawn")
    args = p.parse_args()
    if args.cpu:
        spawn_ranks(args.ranks, _rank, args.debug, 5)
    else:
        main(debug=args.debug)
