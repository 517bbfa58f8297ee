"""Training benchmark of the port (counterpart of ``_run_train`` in the repo's
root ``bench.py``): tokens/s and MFU of the single-device train step.

    python -m ray_tpu_torch.bench            # bench_400m on the card

``bench_400m`` at batch 8 x seq 2048, 2 warm-up and 10 timed steps of the
same batch, full remat, the flash kernel: the root ``bench.py``'s own shapes.
MFU follows that file's convention: 6 N useful FLOPs a token (forward 2N,
backward 4N; no attention FLOPs, remat recompute not counted), over the
H100 SXM's dense bf16 tensor-core rate of 989 TFLOP/s (NVIDIA's data
sheet). The root file's ``BENCH_*`` environment knobs are not carried over:
this entry reads no environment variables.
"""

from __future__ import annotations

import json
import time
from typing import Optional

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models.llama import LlamaConfig, LlamaModel
from ray_tpu_torch.ops.attention import flash_attention_kernel
from ray_tpu_torch.train import make_train_step, shard_batch

H100_BF16_FLOPS = 989e12


def run_train(device: DeviceLike = None, *, batch: int = 8, seq: int = 2048,
              steps: int = 10, warmup: int = 2, seed: int = 0,
              config: Optional[LlamaConfig] = None) -> dict:
    """Train ``config`` (default ``LlamaConfig.bench_400m``) for ``warmup``
    + ``steps`` steps on one batch of random tokens and time the last
    ``steps``. MFU is reported on the card only ("not measured" elsewhere:
    a CPU rate is no device metric)."""
    dev = resolve_device(device)
    cfg = config or LlamaConfig.bench_400m(max_seq_len=max(2048, seq))
    model = LlamaModel(cfg, device=dev)
    ts = make_train_step(model)
    params, opt_state = ts.init_fn(seed)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int64)
    batch_t = shard_batch((tokens, np.roll(tokens, -1, axis=1)), ts)
    launches0 = flash_attention_kernel.launches

    losses = []
    for _ in range(warmup):
        params, opt_state, metrics = ts.step_fn(params, opt_state, batch_t)
        losses.append(metrics["loss"])
    sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        params, opt_state, metrics = ts.step_fn(params, opt_state, batch_t)
        losses.append(metrics["loss"])
    sync()
    dt = time.perf_counter() - t0

    tokens_per_sec = batch * seq * steps / dt
    n_params = cfg.num_params()
    on_card = dev.type == "cuda"
    return {
        "metric": "llama_train_tokens_per_sec",
        "tokens_per_sec": tokens_per_sec,
        "step_ms": dt / steps * 1e3,
        "mfu": (tokens_per_sec * 6 * n_params / H100_BF16_FLOPS
                if on_card else "not measured"),
        "loss_first": float(losses[0]),
        "loss_last": float(losses[-1]),
        "grad_norm": float(metrics["grad_norm"]),
        "model_params": n_params,
        "attention_impl": cfg.attention_impl,
        "remat": cfg.remat_policy if cfg.remat else None,
        "batch": batch, "seq": seq, "steps": steps, "warmup": warmup,
        "device": (torch.cuda.get_device_name(dev) if on_card
                   else str(dev)),
        "flash_launches": flash_attention_kernel.launches - launches0,
    }


if __name__ == "__main__":
    print(json.dumps(run_train()))
