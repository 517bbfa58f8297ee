"""Where the train step's time goes on the card.

    python -m ray_tpu_torch.profile_train [--attention kernel|blockwise]
                                          [--remat full|dots|none]
    python -m ray_tpu_torch.profile_train --family mlp|gpt2|vit|moe

Builds ``LlamaConfig.bench_400m()`` (random f32 params from seed 0) and the
train step of ``ray_tpu_torch.train`` on the CUDA device, one batch of 8 x
2048 random tokens — or, with ``--family``, that family's model and batch of
``ray_tpu_torch.bench.WORKLOADS`` — and after two warm-up steps prints:

- the wall time of a synchronised step (median of 3) and its split into
  forward (``loss``), backward (with the gradient norm) and optimizer, from
  CUDA events that ``step_fn`` records at its phase ends;
- for Llama, one layer's attention at the step's shapes, from CUDA events:
  the forward (the flash kernel, or the blockwise path) and the backward
  (the blockwise recompute and its gradient, which the flash path's
  backward is);
- from ``torch.profiler`` over 2 more steps, the device time of each kernel
  per step and the device's busy share of that window;
- the peak of allocated device memory.

It needs a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

BATCH, SEQ, STEPS = 8, 2048, 3


def _self_device_us(evt) -> float:
    """An averaged profiler event's own device time in µs, across torch
    versions (``device_time`` superseded ``cuda_time``)."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _event():
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


def _attention_ms(model, impl: str, dev) -> dict:
    """One layer's attention forward and backward at the step's shapes."""
    from ray_tpu_torch.ops.attention import (blockwise_attention,
                                             flash_attention)
    cfg = model.cfg
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(h):
        return torch.randn((BATCH, SEQ, h, cfg.head_dim), generator=gen,
                           device=dev).to(cfg.dtype).requires_grad_()

    q, k, v = rand(cfg.n_heads), rand(cfg.n_kv_heads), rand(cfg.n_kv_heads)
    if impl == "kernel":
        def fwd():
            return flash_attention(q, k, v, True)
    else:
        def fwd():
            return blockwise_attention(q, k, v, causal=True)
    out = {}
    for label in ("forward", "backward"):
        times = []
        for i in range(4):
            o = fwd()
            g = torch.ones_like(o)
            torch.cuda.synchronize()
            t0 = _event()
            if label == "forward":
                fwd()
            else:
                torch.autograd.grad(o, (q, k, v), g)
            t1 = _event()
            torch.cuda.synchronize()
            if i:
                times.append(t0.elapsed_time(t1))
        out[label] = float(np.median(times))
    return out


def main(argv=None) -> int:
    from ray_tpu_torch._device import resolve_device
    from ray_tpu_torch.bench import WORKLOADS, family_workload
    from ray_tpu_torch.models.llama import LlamaConfig, LlamaModel
    from ray_tpu_torch.train import make_train_step, shard_batch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--family", choices=("llama",) + tuple(WORKLOADS),
                    default="llama")
    ap.add_argument("--attention", choices=("kernel", "blockwise"),
                    default="kernel", help="llama only")
    ap.add_argument("--remat", choices=("full", "dots", "none"),
                    default="full", help="llama only")
    args = ap.parse_args(argv)

    dev = resolve_device(None)
    if args.family == "llama":
        cfg = dataclasses.replace(
            LlamaConfig.bench_400m(), attention_impl=args.attention,
            remat=args.remat != "none",
            remat_policy="full" if args.remat == "none" else args.remat)
        model = LlamaModel(cfg, device=dev)
        rng = np.random.default_rng(0)
        tokens = rng.integers(0, cfg.vocab_size, (BATCH, SEQ))
        host_batch = (tokens, np.roll(tokens, -1, axis=1))
        unit, label = "tokens", (f"bench_400m, batch {BATCH} x seq {SEQ}, "
                                 f"attention {args.attention}, remat "
                                 f"{args.remat}")
    else:
        model, host_batch = family_workload(args.family, dev)
        unit = WORKLOADS[args.family][4]
        shape = " x ".join(map(str, host_batch[0].shape))
        label = f"{args.family}, batch {shape}"
    units = (host_batch[0].shape[0] * host_batch[0].shape[1]
             if unit == "tokens" else host_batch[0].shape[0])
    ts = make_train_step(model)
    params, opt = ts.init_fn(0)
    batch = shard_batch(host_batch, ts)

    for _ in range(2):
        ts.step_fn(params, opt, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    walls, phases = [], []
    for _ in range(STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        events = [_event()]
        ts.step_fn(params, opt, batch,
                   on_phase=lambda name: events.append(_event()))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        phases.append([a.elapsed_time(b) for a, b in zip(events, events[1:])])
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    wall = float(np.median(walls))
    fwd_ms, bwd_ms, opt_ms = (float(np.median(p)) for p in zip(*phases))

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    n_prof = 2
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_prof):
            ts.step_fn(params, opt, batch)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3 / n_prof
    kernels = []
    for evt in prof.key_averages():
        us = _self_device_us(evt)
        # a user annotation ("Optimizer.step#AdamW.step") spans kernels that
        # are counted on their own
        if getattr(evt, "is_user_annotation", False):
            continue
        if us > 0 and evt.device_type != torch.autograd.DeviceType.CPU:
            kernels.append((evt.key, us / 1e3 / n_prof, evt.count // n_prof))
    kernels.sort(key=lambda k: -k[1])
    device_ms = sum(k[1] for k in kernels)

    attn = (_attention_ms(model, args.attention, dev)
            if args.family == "llama" else None)
    name = torch.cuda.get_device_name(0)
    rate = units / (wall / 1e3)
    print(f"{name}; {label}")
    print(f"step wall {wall:.2f} ms (median of {STEPS}; {rate:.1f} "
          f"{unit}/s): forward {fwd_ms:.2f} ms, backward {bwd_ms:.2f} ms, "
          f"optimizer {opt_ms:.2f} ms; peak allocated {peak_gib:.2f} GiB")
    if attn:
        print(f"one layer's attention: forward {attn['forward']:.3f} ms, "
              f"backward {attn['backward']:.3f} ms (x {cfg.n_layers} layers)")
    print(f"profiled window {window_ms:.2f} ms/step, device busy "
          f"{device_ms:.2f} ms/step ({100 * device_ms / window_ms:.1f} %), "
          f"{sum(k[2] for k in kernels)} kernel launches/step")
    for kname, ms, count in kernels[:20]:
        print(f"  {ms:9.3f} ms/step  {count:6d}x  {kname[:90]}")
    print(json.dumps({
        "device": name, "family": args.family, "workload": label,
        "step_wall_ms": wall, f"{unit}_per_sec": rate,
        "forward_ms": fwd_ms, "backward_ms": bwd_ms, "optimizer_ms": opt_ms,
        "attention_layer_ms": attn, "profiled_step_ms": window_ms,
        "device_busy_ms": device_ms, "peak_allocated_gib": peak_gib,
        "top": [{"kernel": n, "ms_per_step": ms, "per_step": c}
                for n, ms, c in kernels[:10]]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
