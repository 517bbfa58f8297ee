"""BASELINE config 3: Llama-3 sharded training on an fsdp x tp x sp mesh
(counterpart of ``examples/train_llama_fsdp.py``).

FSDP is the sharding: the params carry fsdp/tp logical axes and DTensor
all-gathers them and reduce-scatters their gradients; ring attention takes
the sp axis. On 8 ranks the mesh is JAX's demo shape, fsdp 2 x tp 2 x sp 2;
on any other rank count it is all dp.

Run on the cards, one process a card:
  torchrun --nproc-per-node 8 -m ray_tpu_torch.examples.train_llama_fsdp
On the CPU, eight gloo ranks (debug widths):
  python -m ray_tpu_torch.examples.train_llama_fsdp --cpu --ranks 8
"""

import argparse
from typing import Optional

import numpy as np
import torch.distributed as dist

from ray_tpu_torch.models import LlamaConfig, LlamaModel
from ray_tpu_torch.parallel import (MeshSpec, build_mesh,
                                    initialize_multihost, spawn_ranks)
from ray_tpu_torch.train import make_train_step, shard_batch


def main(debug: bool = True, steps: int = 3,
         device: Optional[str] = None) -> list:
    """Train for ``steps`` steps on one batch; returns the losses."""
    initialize_multihost()
    n = dist.get_world_size() if dist.is_initialized() else 1
    # demo shape: fsdp=2, tp=2, sp=2
    spec = (MeshSpec.auto(n, fsdp=2, tp=2, sp=2) if n % 8 == 0
            else MeshSpec.auto(n))
    mesh = build_mesh(spec, device=device)
    cfg = (LlamaConfig.debug(vocab_size=512, max_seq_len=128) if debug
           else LlamaConfig.llama3_8b())
    model = LlamaModel(cfg, mesh=mesh)
    ts = make_train_step(model, mesh=mesh)
    params, opt = ts.init_fn(0)

    rng = np.random.default_rng(0)
    B, S = 4, min(128, cfg.max_seq_len)
    toks = rng.integers(0, cfg.vocab_size, (B, S))
    batch = shard_batch((toks, np.roll(toks, -1, 1)), ts)

    losses = []
    for step in range(steps):
        params, opt, m = ts.step_fn(params, opt, batch)
        losses.append(float(m["loss"]))
        if not dist.is_initialized() or dist.get_rank() == 0:
            print(f"step {step}: loss={losses[-1]:.4f} mesh={mesh}",
                  flush=True)
    return losses


def _rank(debug, steps):
    return main(debug=debug, steps=steps, device="cpu")


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--debug", action="store_true", default=True)
    p.add_argument("--full", dest="debug", action="store_false")
    p.add_argument("--cpu", action="store_true",
                   help="gloo ranks on the CPU instead of the cards")
    p.add_argument("--ranks", type=int, default=8,
                   help="with --cpu: how many ranks to spawn")
    args = p.parse_args()
    if args.cpu:
        spawn_ranks(args.ranks, _rank, args.debug, 3)
    else:
        main(debug=args.debug)
