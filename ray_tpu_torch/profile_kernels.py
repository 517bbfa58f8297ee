"""Device time of the decode kernels against their chunk size, on the card.

    python -m ray_tpu_torch.profile_kernels [--split-rows 64 128 256 512]

At ``chip_smoke.py``'s decode shapes (32 slots, 32 query / 8 KV heads,
head_dim 128, block 32, lengths spread over 1..1024, bf16; random from
seed 0) it times one call of the paged and of the ragged kernel for each
chunk size of the split-KV plan (``decode_attention.SPLIT_ROWS``): the
device time of 20 calls captured in a CUDA graph and replayed, and the time
of back-to-back calls from Python, host included. For the default chunk it
also prints, from ``torch.profiler``, the device time of the split and the
merge kernel apart. It needs a card.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess

import numpy as np
import torch


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Mean device time of ``fn``: ``iters`` calls captured in one CUDA
    graph, replayed ``replays`` times, so the host's cost between launches
    (Python, the wrappers' checks, ctypes) is not counted. For the decode
    kernels that cost can exceed their device time, and back-to-back calls
    (``eager_ms``) then time the host."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def eager_ms(fn, iters: int = 50, warmup: int = 2) -> float:
    """Mean time of ``fn`` over back-to-back calls from Python, timed with
    CUDA events: the host's cost counts where it exceeds the device's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _kernel_ms(fn, iters: int = 20) -> dict:
    """Device ms a call of each kernel ``fn`` launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        us = float(getattr(evt, "device_time_total",
                           getattr(evt, "cuda_time_total", 0.0)))
        name = re.search(r"(\w+_kernel)\b", evt.key)
        if us and name:
            out[name[1]] = out.get(name[1], 0.0) + us / iters / 1e3
    return out


def main(argv=None) -> int:
    from ray_tpu_torch import _build
    from ray_tpu_torch._device import resolve_device
    from ray_tpu_torch.ops import decode_attention as dec
    from ray_tpu_torch.ops import paged_attention as paged

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--split-rows", type=int, nargs="+",
                    default=[64, 128, 256, 512])
    args = ap.parse_args(argv)

    dev = resolve_device(None)
    _build.load_library("decode_attention")
    gen = torch.Generator(device=dev).manual_seed(0)
    B, H, Hkv, D, bs, maxb = 32, 32, 8, 128, 32, 32
    NB = B * maxb + 1

    def rand(shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    lens = torch.from_numpy(np.linspace(1, maxb * bs, B).round()
                            .astype(np.int32)).to(dev)
    q = rand((B, H, D))
    kp, vp = rand((NB, bs, Hkv, D)), rand((NB, bs, Hkv, D))
    tables = torch.randperm(NB - 1, generator=gen, device=dev) \
        .view(B, maxb).int()
    k = kp[tables.long()].reshape(B, maxb * bs, Hkv, D).contiguous()
    v = vp[tables.long()].reshape(B, maxb * bs, Hkv, D).contiguous()
    scale = D ** -0.5
    calls = {"paged": lambda: paged._launch_paged(q, kp, vp, tables, lens,
                                                  scale),
             "ragged": lambda: dec._launch_ragged(q, k, v, lens, scale)}
    default = dec.SPLIT_ROWS
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print(f"{smi[0] if smi else torch.cuda.get_device_name(0)}; sum(len) "
          f"{int(lens.sum())}; default split_rows {default}")
    try:
        for rows in args.split_rows:
            dec.SPLIT_ROWS = rows
            line = {"split_rows": rows}
            for name, fn in calls.items():
                line[f"{name}_graph_ms"] = graph_ms(fn)
                line[f"{name}_eager_ms"] = eager_ms(fn)
            print(json.dumps(line), flush=True)
    finally:
        dec.SPLIT_ROWS = default
    for name, fn in calls.items():
        print(json.dumps({name: _kernel_ms(fn)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
