"""What DTensor's sharding propagation costs by mesh rank.

    python -m ray_tpu_torch.profile_mesh [--max-dims 6]

One process, a world-size-1 gloo group, and a ``DeviceMesh`` of ``n`` axes
all of size 1 for n = 1 .. max-dims. On each, the host time of the first
and second ``x @ w`` (16 x 32 @ 32 x 64, f32) with ``x`` sharded on dim 0
over the first two axes and ``w`` on dim 0 and dim 1 over two others, as a
batch-sharded activation meets an fsdp x tp weight. The first call runs
DTensor's sharding propagation, the second reads its cache; nothing moves
between ranks. Why ``parallel.mesh.active_mesh`` drops the size-1 axes.
Prints one line a mesh rank and a JSON line; host times of the CPU this
runs on.
"""

from __future__ import annotations

import argparse
import json
import time

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard


def first_matmul_s(ndim: int) -> tuple:
    """(first, second) host seconds of ``x @ w`` on an ``ndim``-axis mesh
    of size-1 axes."""
    mesh = DeviceMesh("cpu", torch.zeros([1] * ndim, dtype=torch.int64),
                      mesh_dim_names=tuple(f"a{i}" for i in range(ndim)))
    px = [Replicate()] * ndim
    pw = [Replicate()] * ndim
    px[0] = Shard(0)
    if ndim > 1:
        px[1] = Shard(0)
        pw[1] = Shard(0)
    pw[-1] = Shard(1)
    x = DTensor.from_local(torch.randn(16, 32), mesh, px)
    w = DTensor.from_local(torch.randn(32, 64), mesh, pw)
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        x @ w
        times.append(time.perf_counter() - t0)
    return tuple(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--max-dims", type=int, default=6)
    args = ap.parse_args(argv)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        out = {}
        for ndim in range(1, args.max_dims + 1):
            first, second = first_matmul_s(ndim)
            out[ndim] = {"first_s": first, "second_s": second}
            print(f"{ndim} axes: first x @ w {first:.3f} s, second "
                  f"{second * 1e3:.3f} ms", flush=True)
        print(json.dumps({"device": "cpu", "torch": torch.__version__,
                          "first_matmul": out}))
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
