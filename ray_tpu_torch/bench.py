"""Training benchmarks of the port (counterpart of ``_run_train`` in the repo's
root ``bench.py``): step time, throughput and MFU of the single-device train
step, for Llama and for the other model families.

    python -m ray_tpu_torch.bench            # bench_400m on the card

``run_train``: ``bench_400m`` at batch 8 x seq 2048, 2 warm-up and 10 timed
steps of the same batch, full remat, the flash kernel: the root
``bench.py``'s own shapes. ``run_family``: each family's run (``WORKLOADS``)
at its published widths, from seed 0, one batch of random data made with
numpy. MFU follows the root file's convention: 6 N useful FLOPs a token
(forward 2N, backward 4N; no attention FLOPs, remat recompute not counted),
over the H100 SXM's dense bf16 tensor-core rate of 989 TFLOP/s (NVIDIA's
data sheet); a ViT image is 197 tokens (196 patches and the class token).
It is left out for the MoE, where 6N would count experts that do not run,
and for the f32 MLP. The root file's ``BENCH_*`` environment knobs are not
carried over: this module reads no environment variables.
"""

from __future__ import annotations

import json
import time
from typing import Optional

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models import (GPT2Config, GPT2Model, LlamaConfig,
                                  LlamaModel, MLPConfig, MLPModel, MoEConfig,
                                  MoEModel, ViTConfig, ViTModel)
from ray_tpu_torch.ops.attention import flash_attention_kernel
from ray_tpu_torch.train import make_train_step, shard_batch
from ray_tpu_torch.train.spmd import param_leaves

H100_BF16_FLOPS = 989e12


def time_train_steps(model, batch, *, steps: int, warmup: int,
                     seed: int = 0) -> dict:
    """``make_train_step(model, mesh=model.mesh)`` (f32 params from
    ``seed``, the default AdamW) for ``warmup`` + ``steps`` steps on one
    host ``batch``; the last ``steps`` are timed by the host clock around
    work ended by a device synchronise. Params and optimizer state are freed
    on return."""
    dev = model.device
    ts = make_train_step(model, mesh=getattr(model, "mesh", None))
    params, opt_state = ts.init_fn(seed)
    batch_t = shard_batch(batch, ts)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    launches0 = flash_attention_kernel.launches
    losses, norms = [], []
    for _ in range(warmup):
        params, opt_state, metrics = ts.step_fn(params, opt_state, batch_t)
        losses.append(metrics["loss"])
        norms.append(metrics["grad_norm"])
    sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        params, opt_state, metrics = ts.step_fn(params, opt_state, batch_t)
        losses.append(metrics["loss"])
    sync()
    dt = time.perf_counter() - t0
    return {"step_ms": dt / steps * 1e3,
            "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
            "grad_norm": float(metrics["grad_norm"]),
            "grad_norm_first": float((norms or [metrics["grad_norm"]])[0]),
            "params": sum(p.numel() for p in param_leaves(params)),
            "steps": steps, "warmup": warmup,
            "flash_launches": flash_attention_kernel.launches - launches0}


def _on_card(dev: torch.device) -> bool:
    return dev.type == "cuda"


def run_train(device: DeviceLike = None, *, batch: int = 8, seq: int = 2048,
              steps: int = 10, warmup: int = 2, seed: int = 0,
              config: Optional[LlamaConfig] = None, mesh=None) -> dict:
    """Train ``config`` (default ``LlamaConfig.bench_400m``) for ``warmup``
    + ``steps`` steps on one batch of random tokens and time the last
    ``steps``; with ``mesh``, the sharded step on that mesh (the same
    numbers, placed as DTensors). MFU is reported on the card only ("not
    measured" elsewhere: a CPU rate is no device metric)."""
    dev = resolve_device(device)
    cfg = config or LlamaConfig.bench_400m(max_seq_len=max(2048, seq))
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int64)
    out = time_train_steps(LlamaModel(cfg, device=dev, mesh=mesh),
                           (tokens, np.roll(tokens, -1, axis=1)),
                           steps=steps, warmup=warmup, seed=seed)
    tokens_per_sec = batch * seq / (out["step_ms"] / 1e3)
    n_params = cfg.num_params()
    return {
        "metric": "llama_train_tokens_per_sec",
        "tokens_per_sec": tokens_per_sec,
        "step_ms": out["step_ms"],
        "mfu": (tokens_per_sec * 6 * n_params / H100_BF16_FLOPS
                if _on_card(dev) else "not measured"),
        "loss_first": out["loss_first"],
        "loss_last": out["loss_last"],
        "grad_norm": out["grad_norm"],
        "grad_norm_first": out["grad_norm_first"],
        "model_params": n_params,
        "attention_impl": cfg.attention_impl,
        "remat": cfg.remat_policy if cfg.remat else None,
        "batch": batch, "seq": seq, "steps": steps, "warmup": warmup,
        "device": (torch.cuda.get_device_name(dev) if _on_card(dev)
                   else str(dev)),
        "flash_launches": out["flash_launches"],
        "mesh": None if mesh is None else str(mesh),
    }


def moe_bench_config() -> MoEConfig:
    """``MoEConfig`` at ``bench_400m``'s widths (the flash kernel, full
    remat) with MoEConfig's own expert defaults: 8 experts, top-2,
    capacity 1.25, einsum dispatch. The JAX package has no MoE preset."""
    base = LlamaConfig.bench_400m()
    return MoEConfig(vocab_size=base.vocab_size, dim=base.dim,
                     n_layers=base.n_layers, n_heads=base.n_heads,
                     n_kv_heads=base.n_kv_heads, ffn_dim=base.ffn_dim,
                     max_seq_len=base.max_seq_len,
                     attention_impl=base.attention_impl)


# name -> (batch rows, sequence or None, warm-up, timed steps, unit,
#          tokens per unit for MFU or None)
WORKLOADS = {
    "mlp": (256, None, 2, 50, "images", None),
    "gpt2": (8, 1024, 2, 10, "tokens", 1),
    "vit": (32, None, 2, 10, "images", 197),
    "moe": (2, 2048, 2, 5, "tokens", None),
}


def family_workload(name: str, device: DeviceLike = None, seed: int = 0):
    """(model, host batch) of a family's run: ``MLPConfig()`` (784 -> 512 ->
    512 -> 10, f32) on 256 rows labelled by a random linear map, as
    ``examples/train_mnist_mlp.py`` makes its data; ``gpt2_125m`` on 8 x 1024
    tokens; ``vit_l16`` on 32 normal 224 x 224 x 3 images with 1000-class
    labels; ``moe_bench_config()`` on 2 x 2048 tokens."""
    dev = resolve_device(device)
    rows, seq = WORKLOADS[name][:2]
    rng = np.random.default_rng(seed)
    if name == "mlp":
        cfg = MLPConfig()
        x = rng.normal(size=(rows, cfg.in_dim)).astype(np.float32)
        w = rng.normal(size=(cfg.in_dim, cfg.num_classes)).astype(np.float32)
        return MLPModel(cfg, device=dev), (x, (x @ w).argmax(1))
    if name == "vit":
        cfg = ViTConfig.vit_l16()
        images = rng.normal(size=(rows, cfg.image_size, cfg.image_size, 3))
        return ViTModel(cfg, device=dev), (
            images.astype(np.float32),
            rng.integers(0, cfg.num_classes, rows))
    model = (GPT2Model(GPT2Config.gpt2_125m(), device=dev) if name == "gpt2"
             else MoEModel(moe_bench_config(), device=dev))
    tokens = rng.integers(0, model.cfg.vocab_size, (rows, seq))
    return model, (tokens, np.roll(tokens, -1, axis=1))


def run_family(name: str, device: DeviceLike = None, seed: int = 0) -> dict:
    """Train one family's workload (``WORKLOADS``) and time it."""
    model, batch = family_workload(name, device, seed)
    _, _, warmup, steps, unit, tokens_per_unit = WORKLOADS[name]
    out = time_train_steps(model, batch, steps=steps, warmup=warmup,
                           seed=seed)
    shape = batch[0].shape
    rows, seq = shape[0], (shape[1] if unit == "tokens" else None)
    rate = rows * (seq or 1) / (out["step_ms"] / 1e3)
    on_card = _on_card(model.device)
    if tokens_per_unit is None:
        mfu = None
    elif on_card:
        mfu = rate * tokens_per_unit * 6 * out["params"] / H100_BF16_FLOPS
    else:
        mfu = "not measured"
    out.update(family=name, unit=unit, per_sec=rate, mfu=mfu,
               batch=rows, seq=seq,
               device=(torch.cuda.get_device_name(model.device) if on_card
                       else str(model.device)))
    return out


if __name__ == "__main__":
    print(json.dumps(run_train()))
