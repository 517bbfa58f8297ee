"""Where the decode step's time goes on the card.

    python -m ray_tpu_torch.profile_decode [--decode kernel|reference]

Builds the Llama-3-8B-width model (random weights from seed 0) on the CUDA
device, a block pool in which 32 slots each hold 512 cached tokens (block
size 32), and runs ``decode_step_paged`` with ``--decode`` attention
(default: the hand-written kernel). It prints the wall time of a
synchronised step (median of 5), and, from ``torch.profiler`` over 5 more
steps, the device time of each kernel per step and the device's busy share
of that window. It needs a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

SLOTS, CONTEXT, STEPS = 32, 512, 5


def _self_device_us(evt) -> float:
    """An averaged profiler event's own device time in µs, across torch
    versions (``device_time`` superseded ``cuda_time``)."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main(argv=None) -> int:
    from ray_tpu_torch._device import resolve_device
    from ray_tpu_torch.models.llama import LlamaConfig, LlamaModel

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--decode", choices=("kernel", "reference"),
                    default="kernel")
    args = ap.parse_args(argv)

    dev = resolve_device(None)
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(),
                              decode_attention=args.decode)
    model = LlamaModel(cfg, device=dev)
    params = model.init(0)
    bs = 32
    maxb = -(-(CONTEXT + 1) // bs)
    pool = model.init_kv_pool(SLOTS * maxb + 1, bs)
    tables = torch.arange(SLOTS * maxb, device=dev,
                          dtype=torch.int32).view(SLOTS, maxb)
    offsets = torch.full((SLOTS,), CONTEXT, dtype=torch.int32,
                         device=dev)
    tokens = torch.zeros(SLOTS, dtype=torch.int32, device=dev)

    def step():
        model.decode_step_paged(params, tokens, pool, tables, offsets)

    for _ in range(2):
        step()
    walls = []
    for _ in range(STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    walls.sort()

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            step()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    kernels = []
    for evt in prof.key_averages():
        us = _self_device_us(evt)
        if us > 0 and evt.device_type != torch.autograd.DeviceType.CPU:
            kernels.append((evt.key, us / 1e3 / STEPS, evt.count))
    kernels.sort(key=lambda k: -k[1])
    device_ms = sum(k[1] for k in kernels)
    step_window = window_ms / STEPS
    print(f"{torch.cuda.get_device_name(0)}; llama3_8b widths, "
          f"{SLOTS} slots x {CONTEXT} cached tokens, decode="
          f"{args.decode}")
    print(f"step wall {walls[len(walls) // 2]:.3f} ms (median of "
          f"{STEPS}); profiled window {step_window:.3f} ms/step, "
          f"device busy {device_ms:.3f} ms/step "
          f"({100 * device_ms / step_window:.1f} %)")
    for name, ms, count in kernels[:15]:
        print(f"  {ms:9.4f} ms/step  {count // STEPS:5d}x  {name[:90]}")
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "slots": SLOTS,
        "context": CONTEXT, "decode": args.decode,
        "step_wall_ms": walls[len(walls) // 2],
        "profiled_step_ms": step_window, "device_busy_ms": device_ms,
        "launches_per_step": sum(k[2] for k in kernels) // STEPS,
        "top": [{"kernel": n, "ms_per_step": ms} for n, ms, _ in
                kernels[:8]]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
