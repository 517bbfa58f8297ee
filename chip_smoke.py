#!/usr/bin/env python3
"""Drive the PyTorch port (``ray_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the port's CUDA kernels from ``ray_tpu_torch/csrc`` with nvcc,
   one compiler per source, all at once, and checks with ``cuobjdump`` that
   the flash library holds wgmma and TMA loads and the decode library
   cp.async.
2. Holds each kernel against its plain PyTorch version on the card: bf16 at
   the shapes its main path gives it and f32 at the repo's test shapes, and
   times kernel, plain version and a library yardstick
   (``scaled_dot_product_attention``; the port never calls it) beside the
   least time the card could take, printing each kernel's rate (TFLOP/s or
   TB/s), its share of the bound and its factor behind the yardstick. Kernel
   and yardstick times are device time (CUDA-graph replay); the time of
   back-to-back calls from Python is printed beside. Decode kernels: 32
   slots, 32 query / 8 KV heads, head_dim 128, block 32, lengths spread
   over 1..1024. Flash kernel: bench_400m's attention, batch 8 x seq 2048,
   8 query / 4 KV heads, head_dim 128, causal (and batch 2, the MoE path's
   shapes); and its gradient (the blockwise recompute) against autograd
   through the reference.
3. Serving path: ``LLMServer`` on the card with Llama-3-8B's widths (random
   weights from seed 0) answers one lone greedy request (96 prompt tokens,
   32 new; its token ids are kept for phases 12 and 13), then, every launch
   counter at 0, 16 requests through ``__call__`` and ``stream`` (prompts
   of 32-256 tokens, four sharing a 64-token prefix, 32 new tokens each),
   then one ``forward_step`` with T=1 on a dense cache. The paged kernel
   must have run once per layer per decode step, the ragged kernel once per
   layer.
4. Compares ``decode_step_paged`` through the kernel with the reference
   implementation on identical (cloned) live pools at the repo's bf16 bar.
5. Training path, every launch counter at 0 (the server freed first):
   ``run_train`` on ``LlamaConfig.bench_400m()`` (443 M params, random from
   seed 0), batch 8 x seq 2048, 2 warm-up + 10 timed AdamW steps of one
   batch, full remat. The flash kernel must have run twice per layer per
   step (forward and remat recompute), and the loss must fall.
6. The loss through the flash kernel against the blockwise path on the
   same f32 params and batch, at the repo's bar (rtol 1e-3, atol 1e-4).
7. The other model families train on the card, one after another, each
   from seed 0 through ``make_train_step`` with the default AdamW
   (``ray_tpu_torch.bench.run_family``), the flash counter at 0 before each
   and each freed before the next: the f32 MLP (784-512-512-10) on 256 rows
   for 2 + 50 steps; GPT-2 125M on 8 x 1024 tokens, ViT-L/16 on 32 images of
   224 x 224 x 3, both bf16 with remat, 2 + 10 steps; the einsum-dispatch
   MoE at bench_400m's widths (8 experts, top-2) on 2 x 2048 tokens, 2 + 5
   steps. Each prints step time, tokens/s or images/s, the first and last
   loss and its params (MFU for GPT-2 and ViT); the loss must fall. The MoE
   path must launch the flash kernel twice per layer per step, GPT-2 and
   ViT (head_dim 64: the dispatcher's reference attention, JAX's rule) never.
8. The MoE loss through the flash kernel against the blockwise path (f32
   params, batch 2 x 2048) at phase 6's bar; GPT-2 125M and ViT-L/16 in
   f32 on the card against the same port model on the CPU (GPT-2 1 x 256
   tokens, ViT 2 images), rtol 1e-3.

9. The mesh path (``ray_tpu_torch.parallel``): ``build_mesh(MeshSpec())``
   starts a world-size-1 NCCL group and a mesh with all six axes of size 1
   (NCCL refuses two ranks on one card, so one card holds no mesh of more
   than one rank; the sharded numbers are held against JAX on CPU meshes by
   tests/test_torch_spmd.py). Every counter at 0: ``run_train(mesh=...)``
   on bench_400m at phase 5's shapes, every leaf a DTensor and the flash
   kernel run on each rank's local shards, twice per layer per step; its
   first loss and grad norm must equal phase 5's (same seed and batch) at
   rtol 1e-3, and its loss must fall. Step time, tokens/s, MFU and kernel
   launches a step (one profiled step) are printed beside phase 5's. Then
   the GPT-2 DP example at full width (GPT-2 125M, 8 x 1024 tokens, 2 + 5
   steps, the all-dp mesh): the loss must fall; and phase 7's GPT-2 run on
   the mesh, its first loss held to phase 7's. Last, the sharded bench_400m
   params and AdamW state after one step are saved (``train.checkpoint``)
   and restored onto the mesh and with no mesh: every leaf bit for bit.
10. Sequence, expert and pipeline parallelism, every counter at 0 before
   each run: (a) phase 7's MoE workload with the expert all-to-all
   (``moe_dispatch="alltoall"``) on the one-rank mesh: at ep 1 it is the
   einsum scheme's math, so its first loss must equal phase 7's at rtol
   1e-3; the loss must fall and flash launch twice per layer per step;
   (b) ring and Ulysses attention at sp 1 (no exchange runs) at
   bench_400m's attention shapes: bf16 against the flash kernel at the
   bf16 bar, f32 gradients against autograd through the reference at the
   gradient bar, each timed; (c) the GPipe schedule (``pipelined``) over
   the mesh's one stage of bench_400m's 24 layers, ``PipelinedLlama``'s
   stage body and apply, 4 microbatches of 2 x 2048, remat: first loss
   against phase 5's at rtol 1e-3, flash launched 2 x 24 x 4 times a
   step, step time beside phase 5's; (d) ``dryrun_mesh(8)``: one step of
   each parallel layout on 8 gloo ranks of this machine's CPU (NCCL holds
   one rank a card, so meshes of more ranks meet this torch here), each
   loss against the port's one-device loss.
11. The RL learners (``ray_tpu_torch.rl``) on the port's runtime, every
   kernel counter at 0 before and read after (they launch none of the
   port's kernels): ``rl.Algorithm`` drives EnvRunner actors of
   ``ray_tpu_torch.init()`` on CartPole with the learner and the runners'
   policies on the card (sample, update, send the weights back through the
   object store's device tier; IMPALA and APPO one fragment an update, the
   weights to the runner that delivered it). (a) Each learner at the CPU
   tests' configurations (``RL_CASES``) takes one update on the card and
   on the CPU from the same state (``load_learner_state``), held to the
   tests' bars; (b) the JAX tests' learning bars on the card (PPO, IMPALA,
   SAC, DQN through ``Algorithm``; BC and CQL from logged batches); (c) the
   five tuned CartPole contracts through ``rl.tuned_examples.run`` (JAX's
   full-width RL configurations), reported and not gated: best return and
   iterations, update ms on the card and on this machine's CPU (median of
   5), gradient steps a second, one profiled update's launches a step and
   device-busy share, and an iteration split into the learner's update,
   the runners' work and the runtime's own cost; (d) ``LearnerGroup`` on
   the one-rank NCCL mesh, PPO's and IMPALA's update against the plain
   learner's at rtol 1e-6.
12. The runtime on the card (``ray_tpu_torch.init()``): (a) the card is
   detected as ``GPU``, a ``num_gpus=1`` task runs in this process on it
   and gives the resource back; (b) a 256 MiB bf16 CUDA tensor through
   ``put``/``get`` keeps its storage and allocates nothing, a
   ``num_gpus=1`` task's sum of it equals this process's, and it is freed on
   ``del``; (c) ``LLMServer`` as a ``num_gpus=1``, ``max_concurrency=16``
   actor with phase 3's config: the lone request gives phase 3's token ids
   and, every counter at 0, phase 3's 16 requests go through
   ``__call__.remote`` and streaming ``stream`` calls, collected with
   ``wait``; the prefix path runs, the paged kernel once per layer per
   decode step and no other kernel; a ``num_gpus=1`` task submitted while
   the actor lives stays pending until ``kill``; tokens/s beside phase 3's;
   (d) no-op tasks, actor calls and 1 MiB put/get round trips a second;
   (e) phase 11's iteration split, printed with the card's power limit.
13. Serve on the card (``ray_tpu_torch.serve``), on a fresh ``init()``
   once phase 12's runtime and its server are gone, with phase 3's config
   and mix: (a) ``serve.run(build_llm_app(config))`` (one replica, weights
   from seed 0 in the replica): the lone request through the handle gives
   phase 3's token ids; every counter at 0, phase 3's 16 requests, 8
   unary and 8 streams (``handle.options(stream=True)``) in phase 12's
   order; the prefix path runs, the paged kernel once per layer per decode
   step of the replica's engine and no other kernel; tokens/s beside
   phases 3 and 12, the client's time to each stream's first chunk and the
   engine's ``ttft_s``; (b) ``serve.start_http_proxy``: the lone request as
   JSON and as SSE gives phase 3's token ids, then ``[DONE]``; (c)
   ``serve.delete``: no engine thread is left and the card's allocated
   bytes are back within 256 MiB of the base; (d)
   ``build_pd_disagg_app`` (one prefill, one decode replica, about 37 GB):
   the lone request through the orchestrator gives phase 3's token ids,
   then phase 3's 16 prompts at once, the paged kernel once per layer per
   decode step of the decode engine; tokens/s, the KV handoff's bytes and
   ms a request; freed on ``serve.shutdown`` as in (c); (e) the serve data
   plane's own cost on this host: 1,000 sequential handle calls and 1,000
   in flight at once on 2 no-op replicas, a second each, beside phase 12's
   actor calls. Alone: ``python -c "import chip_smoke, torch;
   chip_smoke.serve_path(torch.device('cuda'))"``.
14. The open-loop serving bench (``ray_tpu_torch.llm.bench``) on a fresh
   ``init()``, every counter at 0 before each run: (a)
   ``run_serving_bench()`` (``bench_400m`` at max_seq 1024, random from
   seed 0, one replica of 32 slots, the paged kernel; seeded Poisson
   arrivals at 6 requests/s for 16 s, 64 clients, prompts of 32-256 tokens,
   64 new tokens, every prefill bucket warmed first), streams through the
   handle: every scheduled request completes with no error and no
   abandoned client, the paged kernel once per layer per decode step of the
   replica's engine and no other kernel; ``serving_section`` with the
   client's TTFT/E2E/TPOT percentiles, goodput and the engine's own
   ``ttft_s``; (b) the same load as unary calls (the router's waiter path),
   beside (a); (c) ``run_http_proxy_bench()``: 64 requests, 16 at a time,
   64 tokens, every SSE stream ending in ``[DONE]``; then the card's
   allocated bytes are back within 256 MiB of the base. Before (a), the
   paged kernel is held to its plain version at the bench's shapes (B 32,
   8 query / 4 KV heads, D 128, block 32, lengths 32-320 across the
   128-row chunk edges, bf16). Alone:
   ``python -c "import chip_smoke, torch;
   chip_smoke.serving_bench_path(torch.device('cuda'))"``.
15. The train driver (``ray_tpu_torch.train.JaxTrainer``) on a fresh
   ``init()``, the flash counter at 0 before each run: (a) one worker in a
   placement group whose bundle holds the card (``ScalingConfig(use_gpu=
   True)``) trains bench_400m for 6 AdamW steps at phase 5's batch (8 x
   2048, seed 0, full remat) through ``make_train_step``: the flash kernel
   2 x 24 times a step, the first loss held to phase 5's, a ``num_gpus=1``
   task submitted during ``fit()`` pending until the group is gone, the
   step time beside phase 5's; (b) the same with
   ``FailureConfig(max_failures=1)``: rank 0 checkpoints params and AdamW
   state after step 3 (5.3 GB in f32), the loop raises once before step 4,
   the group re-forms from the checkpoint and steps 4-5 are held to (a)'s;
   the checkpoint's write and restore seconds; (c) no train worker thread
   left and the card's allocated bytes back within 256 MiB of the base.
   Alone (it runs phase 5 first): ``python -c "import chip_smoke, torch;
   chip_smoke.train_driver_path(torch.device('cuda'))"``.
16. Tune and the utilities (``ray_tpu_torch.tune``, ``ray_tpu_torch.util``)
   on a fresh ``init()``, the flash counter at 0 before each part: (a) a
   ``Tuner`` over a function trainable (bench_400m at phase 5's batch, up
   to 6 AdamW steps at the trial's lr, each reported) with
   ``AsyncHyperBandScheduler(grace_period=2, reduction_factor=2,
   max_t=6)`` over lr 1e-3, 0.0 and 3e-4, one trial at a time: every
   first loss is phase 5's, the lr 0.0 trial is stopped at iteration 2
   with the initial loss, the best lr is 1e-3, the scheduler's decisions
   replay on a fresh one, flash 2 x 24 times a reported step, and each
   trial starts with the card's bytes within 256 MiB of the base (a
   stopped trial's model is freed, ROADMAP C11); (b) Train-on-Tune: a
   ``Tuner`` over a ``JaxTrainer`` of phase 15's loop (3 steps,
   ``ScalingConfig(use_gpu=True)``) over two lrs, both trial actors at
   once: the second group's bundle waits until the first is gone, so the
   step windows do not overlap, each trial's metrics are its rank 0's last
   report, the peak bytes are one trial's; (c) ``util.collective`` between
   two ``num_gpus=0.5`` actors on 64 MiB bf16 CUDA tensors (allreduce
   against the sum in torch, allgather, broadcast, reducescatter,
   send/recv; every result on the card, in bf16, the parts uncopied),
   ``ActorPool.map`` and ``Queue`` handing a CUDA tensor over uncopied;
   after ``shutdown()`` no trial, train-worker, queue or collective thread
   is left and the card's bytes are back within 256 MiB of the base.
   Alone (it runs phase 5 first): ``python -c "import chip_smoke, torch;
   chip_smoke.tune_path(torch.device('cuda'))"``.
17. The data layer and the device feed (``ray_tpu_torch.data``) on a fresh
   ``init()``, the flash counter at 0: (a) ``JaxTrainer(datasets={"train":
   ds})`` with one worker holding the card, ``ds`` 64 x 2048 tokens from
   seed 0 (its first 8 rows phase 5's batch), targets added by
   ``map_batches``, 8 blocks; the loop feeds
   ``get_dataset_shard("train").to_jax(batch_size=8, prefetch=2)`` (pinned
   staging, a side-stream copy) into bench_400m's step for 6 AdamW steps
   (full remat): the flash kernel 2 x 24 x 6 times, the first batch phase
   5's and the first loss phase 5's to every printed digit, the step
   median beside phase 5's; (b) BASELINE config 4 at ImageNet's widths:
   2,048 records of a 224 x 224 x 3 uint8 image, a label and an index
   (seed 0, 308 MB; the count cut to the run's time) written with
   ``write_numpy`` as 16 shards, read back with ``read_numpy``,
   normalised to f32 by an actor pool, ``streaming_split(1)``; pass 1
   feeds the card alone (images/s, GB/s beside a plain pinned ``copy_`` of
   one batch, the object store's peak, the first batch held to its
   records' values), pass 2 feeds ViT-L/16's train step at 32 images
   (images/s beside the bare step on a resident batch, the device-busy
   share of one profiled window; head_dim 64 runs the reference
   attention, so no kernel of the port); (c) TFRecord and Avro round
   trips, ``iter_torch_batches`` onto the card, the feed's pinned staging
   and side stream checked directly; after ``shutdown()`` no prefetch,
   map-pool, shuffle or train-worker thread is left and the card's bytes
   are back within 256 MiB of the base. Alone (it runs phase 5 first):
   ``python -c "import chip_smoke, torch;
   chip_smoke.data_path(torch.device('cuda'))"``.

It prints the card's name and power limit, a ``{"kernels": [...]}`` line,
and last ``{"ok": true, "device": {...}}``. Any failed phase raises, and the
script then exits non-zero; without a CUDA device it exits 2 and prints no
result.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_OPS = {"bfloat16": 989e12,    # dense tensor-core rate
            "float32": 67e12}      # outside the tensor cores
# kernel vs plain, bf16 output: mostly relative, two bf16 ulps (2**-6); the
# atol covers outputs near 0, whose magnitude is ~1/sqrt(length)
BF16_TOL = dict(atol=5e-3, rtol=1.6e-2)
STEP_TOL = dict(atol=0.15, rtol=0.05)   # tests/test_llm_paged.py bf16 bar
F32_FLASH_TOL = dict(atol=2e-5, rtol=2e-4)   # tests/test_ops.py:324
GRAD_TOL = dict(atol=5e-4, rtol=5e-3)        # tests/test_ops.py:359
LOSS_TOL = dict(atol=1e-4, rtol=1e-3)        # tests/test_ops.py:378


def log(msg: str) -> None:
    print(msg, flush=True)


def tol_ratio(a, b, tol=BF16_TOL) -> float:
    """max |a - b| / (atol + rtol |b|): above 1 fails ``tol``."""
    a, b = a.float(), b.float()
    return ((a - b).abs() / (tol["atol"] + tol["rtol"] * b.abs())) \
        .max().item()


def bound_ms(bytes_moved: float, ops: float, dtype) -> tuple:
    dname = str(dtype).replace("torch.", "")
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dname]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def decode_work(lengths, H, Hkv, D, elt, tables_read=0):
    """Bytes and operations one decode-attention call needs for these
    lengths: K and V of the live context, q, out, lengths and the table
    entries it reads; two multiply-adds per (head, row, d)."""
    live = int(sum(lengths))
    B = len(lengths)
    nbytes = (2 * live * Hkv * D * elt + 2 * B * H * D * elt + 4 * B
              + 4 * tables_read)
    return nbytes, 4 * H * D * live


def sdpa_ms(q, k_dense, v_dense, lengths, iters):
    """The library yardstick: one SDPA call on the dense [B, S, Hkv, D]
    view with a length mask and grouped heads."""
    import torch
    import torch.nn.functional as F
    from ray_tpu_torch.profile_kernels import graph_ms
    S = k_dense.shape[1]
    qq = q[:, :, None, :]                                   # [B, H, 1, D]
    kk = k_dense.transpose(1, 2)                            # [B, Hkv, S, D]
    vv = v_dense.transpose(1, 2)
    mask = (torch.arange(S, device=q.device)[None, :]
            < lengths[:, None])[:, None, None, :]
    return graph_ms(lambda: F.scaled_dot_product_attention(
        qq, kk, vv, attn_mask=mask, enable_gqa=True), iters)


# the Hopper instructions each library must hold: wgmma (HGMMA) fed by TMA
# (UTMALDG) for the flash kernel, cp.async (LDGSTS) for the decode kernels
SASS_NEEDS = {"flash_attention": ("HGMMA", "UTMALDG", "SYNCS"),
              "decode_attention": ("LDGSTS",)}


def check_sass(name: str, lib_path) -> None:
    """Count the instructions of ``SASS_NEEDS`` in the built library with
    the toolkit's ``cuobjdump -sass``; raise if one is missing."""
    from pathlib import Path
    from ray_tpu_torch import _build
    tool = Path(_build.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    counts = {op: sass.count(op) for op in SASS_NEEDS[name]}
    log(f"  sass of {lib_path.name}: {counts}")
    if not all(counts.values()):
        raise RuntimeError(f"{name}: instructions missing from the build: "
                           f"{counts}")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_kernels(dev, gen) -> list:
    import torch
    from ray_tpu_torch.ops import decode_attention as dec
    from ray_tpu_torch.ops import paged_attention as paged
    from ray_tpu_torch.profile_kernels import eager_ms, graph_ms

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # f32 at the repo's test shapes, the repo's own tolerances
    q, kp, vp = (rand((4, 8, 128), torch.float32),
                 rand((32, 16, 4, 128), torch.float32),
                 rand((32, 16, 4, 128), torch.float32))
    tables = torch.randperm(32, generator=gen, device=dev)[:24] \
        .view(4, 6).int()
    lens = torch.tensor([1, 16, 37, 96], dtype=torch.int32, device=dev)
    out = paged.paged_decode_attention_kernel(q, kp, vp, tables, lens)
    plain = paged._paged_decode_plain(q, kp, vp, tables, lens,
                                      scale=128 ** -0.5)
    torch.testing.assert_close(out, plain, atol=1e-4, rtol=1e-4)
    err_paged_f32 = (out - plain).abs().max().item()
    errs_ragged_f32 = []
    for B, S, H, Hkv, D, lengths in ((4, 256, 8, 2, 32, [1, 100, 200, 256]),
                                     (2, 96, 4, 4, 16, [37, 96])):
        q = rand((B, H, D), torch.float32)
        k = rand((B, S, Hkv, D), torch.float32)
        v = rand((B, S, Hkv, D), torch.float32)
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        out = dec.ragged_decode_attention_kernel(q, k, v, lens)
        plain = dec._ragged_decode_plain(q, k, v, lens, block_k=64,
                                         scale=D ** -0.5)
        torch.testing.assert_close(out, plain, atol=2e-6, rtol=2e-5)
        errs_ragged_f32.append((out - plain).abs().max().item())
    log(f"f32 at the repo's test shapes: paged max_abs_err "
        f"{err_paged_f32:.3e} (tol 1e-4), ragged {errs_ragged_f32} "
        f"(rtol 2e-5 atol 2e-6)")

    # bf16 at the slice's shapes
    B, H, Hkv, D, bs, maxb = 32, 32, 8, 128, 32, 32
    NB = B * maxb + 1                          # + the engine's scratch block
    dt = torch.bfloat16
    scale = D ** -0.5
    lengths = np.linspace(1, maxb * bs, B).round().astype(np.int32)
    lens = torch.from_numpy(lengths).to(dev)
    # a wrong kernel to hold the bound against: each slot longer than 512
    # loses its last 32-row tile
    long_slots = torch.from_numpy(np.flatnonzero(lengths > 512)).to(dev)
    short = torch.from_numpy(lengths - ((lengths - 1) % 32 + 1)).to(dev)
    q = rand((B, H, D), dt)
    kp, vp = rand((NB, bs, Hkv, D), dt), rand((NB, bs, Hkv, D), dt)
    tables = torch.randperm(NB - 1, generator=gen, device=dev) \
        .view(B, maxb).int()
    rows = []

    # paged
    out = paged.paged_decode_attention_kernel(q, kp, vp, tables, lens)
    plain = paged._paged_decode_plain(q, kp, vp, tables, lens, scale=scale)
    torch.testing.assert_close(out.float(), plain.float(), **BF16_TOL)
    wrong = paged._paged_decode_plain(q, kp, vp, tables, short, scale=scale)
    skip_ratio = tol_ratio(wrong[long_slots], plain[long_slots])
    call = (lambda: paged._launch_paged(q, kp, vp, tables, lens, scale))
    ms, host_ms = graph_ms(call), eager_ms(call)
    plain_ms = eager_ms(lambda: paged._paged_decode_plain(
        q, kp, vp, tables, lens, scale=scale), 5)
    dense_k = kp[tables.long()].reshape(B, maxb * bs, Hkv, D)
    dense_v = vp[tables.long()].reshape(B, maxb * bs, Hkv, D)
    lib_ms = sdpa_ms(q, dense_k, dense_v, lens, 20)
    nbytes, ops = decode_work(lengths, H, Hkv, D, 2,
                              tables_read=int(np.sum(-(-lengths // bs))))
    b_ms, b_by = bound_ms(nbytes, ops, dt)
    rows.append({"name": "paged_decode_attention",
                 "route": "cuda",
                 "source": "ray_tpu_torch/csrc/decode_attention.cu",
                 "replaces": "ray_tpu/ops/paged_attention.py:55",
                 "max_abs_err": (out.float() - plain.float()).abs().max()
                 .item(),
                 "tol_ratio": tol_ratio(out, plain), "skip_ratio": skip_ratio,
                 "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                 "bound_by": b_by, "library_ms": lib_ms, "bytes": nbytes,
                 "host_ms": host_ms})

    # ragged, dense cache [B, S, Hkv, D] with S = 1024
    S = maxb * bs
    k, v = dense_k.contiguous(), dense_v.contiguous()
    out = dec.ragged_decode_attention_kernel(q, k, v, lens)
    plain = dec._ragged_decode_plain(q, k, v, lens, block_k=128, scale=scale)
    torch.testing.assert_close(out.float(), plain.float(), **BF16_TOL)
    wrong = dec._ragged_decode_plain(q, k, v, short, block_k=128,
                                     scale=scale)
    skip_ratio = tol_ratio(wrong[long_slots], plain[long_slots])
    call = (lambda: dec._launch_ragged(q, k, v, lens, scale))
    ms, host_ms = graph_ms(call), eager_ms(call)
    plain_ms = eager_ms(lambda: dec._ragged_decode_plain(
        q, k, v, lens, block_k=128, scale=scale), 5)
    lib_ms = sdpa_ms(q, k, v, lens, 20)
    nbytes, ops = decode_work(lengths, H, Hkv, D, 2)
    b_ms, b_by = bound_ms(nbytes, ops, dt)
    rows.append({"name": "ragged_decode_attention",
                 "route": "cuda",
                 "source": "ray_tpu_torch/csrc/decode_attention.cu",
                 "replaces": "ray_tpu/ops/decode_attention.py:49",
                 "max_abs_err": (out.float() - plain.float()).abs().max()
                 .item(),
                 "tol_ratio": tol_ratio(out, plain), "skip_ratio": skip_ratio,
                 "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                 "bound_by": b_by, "library_ms": lib_ms, "bytes": nbytes,
                 "host_ms": host_ms})
    for r in rows:
        log(f"{r['name']}: bf16 B={B} H={H} Hkv={Hkv} D={D} "
            f"sum(len)={int(lengths.sum())}: kernel {r['ms']:.4f} ms "
            f"({r['bytes'] / r['ms'] / 1e9:.3f} TB/s, "
            f"{100 * r['bound_ms'] / r['ms']:.1f} % of the bound, "
            f"{r['ms'] / r['library_ms']:.2f}x the sdpa time; "
            f"{r['host_ms']:.4f} ms a call back to back, host included), "
            f"plain "
            f"{r['plain_ms']:.3f} ms, sdpa {r['library_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), max_abs_err "
            f"{r['max_abs_err']:.3e}, {r['tol_ratio']:.2f}x the tolerance "
            f"{BF16_TOL}; a version that skips the last tile of the slots "
            f"longer than 512 reads {r['skip_ratio']:.2f}x it")
        if r["skip_ratio"] <= 1:
            raise RuntimeError(f"{r['name']}: the bf16 tolerance does not "
                               f"tell a skipped last tile from the kernel")
    return rows


def check_flash(dev, gen) -> dict:
    import torch
    import torch.nn.functional as F
    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.profile_kernels import eager_ms, graph_ms

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # f32 at the repo's test shapes (tests/test_ops.py:318, 334)
    errs_f32 = []
    for B, S, H, Hkv, D, causal in ((2, 256, 4, 2, 32, True),
                                    (2, 256, 4, 2, 32, False),
                                    (1, 192, 2, 2, 16, True)):
        q = rand((B, S, H, D), torch.float32)
        k, v = rand((B, S, Hkv, D), torch.float32), \
            rand((B, S, Hkv, D), torch.float32)
        out = attn.flash_attention_kernel(q, k, v, causal)
        plain = attn._flash_forward_plain(q, k, v, causal=causal)
        torch.testing.assert_close(out, plain, **F32_FLASH_TOL)
        errs_f32.append((out - plain).abs().max().item())
    # the Function's gradient against autograd through the reference
    q, k, v = (rand((1, 128, 2, 16), torch.float32).requires_grad_()
               for _ in range(3))
    grads = torch.autograd.grad(
        (attn.flash_attention(q, k, v, True) ** 2).sum(), (q, k, v))
    ref = torch.autograd.grad(
        (attn.reference_attention(q, k, v) ** 2).sum(), (q, k, v))
    grad_err = 0.0
    for a, b in zip(grads, ref):
        torch.testing.assert_close(a, b, **GRAD_TOL)
        grad_err = max(grad_err, (a - b).abs().max().item())
    log(f"flash f32 at the repo's test shapes: max_abs_err {errs_f32} "
        f"(rtol 2e-4 atol 2e-5); gradients vs the reference {grad_err:.3e} "
        f"(rtol 5e-3 atol 5e-4)")

    # bf16 at the training slice's shapes
    B, S, H, Hkv, D = 8, 2048, 8, 4, 128
    dt = torch.bfloat16
    scale = D ** -0.5
    q = rand((B, S, H, D), dt)
    k, v = rand((B, S, Hkv, D), dt), rand((B, S, Hkv, D), dt)
    out = attn.flash_attention_kernel(q, k, v, True)
    plain = attn._flash_forward_plain(q, k, v, causal=True)
    torch.testing.assert_close(out.float(), plain.float(), **BF16_TOL)
    # a wrong kernel to hold the bound against: each 128-row block of
    # queries (the kernel's tile) drops its last (diagonal) K tile; rows
    # 128.. compared
    rows = torch.arange(S, device=dev)
    wrong = attn.reference_attention(q, k, v,
                                     positions_q=rows // 128 * 128 - 1,
                                     positions_k=rows)
    skip_ratio = tol_ratio(wrong[:, 128:], plain[:, 128:])
    del wrong
    # the MoE path's shapes (phase 7): batch 2 of the same widths
    q2, k2, v2 = (t[:2].contiguous() for t in (q, k, v))
    out2 = attn.flash_attention_kernel(q2, k2, v2, True).float()
    plain2 = attn._flash_forward_plain(q2, k2, v2, causal=True).float()
    torch.testing.assert_close(out2, plain2, **BF16_TOL)
    moe_err = (out2 - plain2).abs().max().item()
    del q2, k2, v2, out2, plain2
    call = (lambda: attn._launch_flash(q, k, v, True, scale))
    ms, host_ms = graph_ms(call), eager_ms(call)
    plain_ms = eager_ms(lambda: attn._flash_forward_plain(q, k, v,
                                                         causal=True), 3, 1)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_ms = graph_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    elt = 2
    nbytes = (2 * B * S * H * D + 2 * B * S * Hkv * D) * elt   # q, o, k, v
    ops = 4 * B * H * D * (S * (S + 1) // 2)       # causal (row, col) pairs
    b_ms, b_by = bound_ms(nbytes, ops, dt)
    row = {"name": "flash_attention", "route": "cuda",
           "source": "ray_tpu_torch/csrc/flash_attention.cu",
           "replaces": "ray_tpu/ops/attention.py:128",
           "max_abs_err": (out.float() - plain.float()).abs().max().item(),
           "tol_ratio": tol_ratio(out, plain), "skip_ratio": skip_ratio,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": lib_ms}
    log(f"flash_attention: bf16 B={B} S={S} H={H} Hkv={Hkv} D={D} causal: "
        f"kernel {ms:.4f} ms ({ops / ms / 1e9:.1f} TFLOP/s, "
        f"{100 * b_ms / ms:.1f} % of the bound, {ms / lib_ms:.2f}x the sdpa "
        f"time; {host_ms:.4f} ms a call back to back, host included), plain "
        f"{plain_ms:.3f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}; {ops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB), "
        f"max_abs_err {row['max_abs_err']:.3e}, {row['tol_ratio']:.2f}x the "
        f"tolerance {BF16_TOL}; a version that drops each row block's "
        f"diagonal K tile reads {skip_ratio:.2f}x it; at the MoE path's "
        f"batch 2, max_abs_err {moe_err:.3e}")
    if skip_ratio <= 1:
        raise RuntimeError("flash_attention: the bf16 tolerance does not "
                           "tell a dropped K tile from the kernel")
    return row


# ---------------------------------------------------------------------------
# phase 3: the serving path
# ---------------------------------------------------------------------------

def request_mix(vocab: int, rng) -> dict:
    """The serving mix: 12 plain prompts of 32-256 tokens and four sharing a
    64-token prefix; then one lone prompt of 96 tokens."""
    prefix = [int(t) for t in rng.integers(0, vocab, 64)]
    plain_lens = rng.integers(32, 257, 12)
    prompts = [[int(t) for t in rng.integers(0, vocab, n)]
               for n in plain_lens]
    sharers = [prefix + [int(t) for t in rng.integers(0, vocab, n)]
               for n in (20, 60, 120, 192)]
    lone = [int(t) for t in rng.integers(0, vocab, 96)]
    return {"prompts": prompts, "sharers": sharers, "lone": lone,
            "prompt_tokens": int(plain_lens.sum()) + sum(map(len, sharers))}


def serve_requests(server, mix: dict) -> dict:
    """16 requests through ``__call__`` and ``stream``; four share a
    64-token prefix and arrive once the first of them has its first token
    (its prompt blocks are sealed at admission), so the prefix path runs."""
    prompts, sharers = mix["prompts"], mix["sharers"]
    results = {}
    lock = threading.Lock()

    def call(i, prompt):
        out = server({"prompt": prompt, "max_tokens": 32})
        with lock:
            results[i] = (out["finish_reason"], len(out["token_ids"]))

    def stream(i, prompt, first=None):
        n = 0
        reason = None
        for chunk in server.stream({"prompt": prompt, "max_tokens": 32}):
            if chunk.get("done"):
                reason = chunk["finish_reason"]
            else:
                n += 1
                if first is not None:
                    first.set()
        with lock:
            results[i] = (reason, n)

    t0 = time.perf_counter()
    first = threading.Event()
    threads = [threading.Thread(target=stream, args=(0, sharers[0], first))]
    for i, p in enumerate(prompts):
        fn = call if i % 2 else stream
        threads.append(threading.Thread(target=fn, args=(i + 1, p)))
    for t in threads:
        t.start()
    if not first.wait(600):
        raise RuntimeError(f"no first token from the prefix owner "
                           f"(server error: {server.error!r})")
    late = [threading.Thread(target=call if j % 2 else stream,
                             args=(13 + j, p))
            for j, p in enumerate(sharers[1:])]
    for t in late:
        t.start()
    for t in threads + late:
        t.join(900)
        if t.is_alive():
            raise RuntimeError("a request did not finish in 900 s")
    wall = time.perf_counter() - t0
    if server.error is not None:
        raise RuntimeError("the engine thread failed") from server.error
    if len(results) != 16:
        raise RuntimeError(f"{len(results)} of 16 requests answered")
    for i, (reason, n) in sorted(results.items()):
        if reason not in ("length", "stop") or not 1 <= n <= 32:
            raise RuntimeError(f"request {i}: finish {reason!r}, {n} tokens")
    tokens = sum(n for _, n in results.values())
    return {"wall_s": wall, "tokens": tokens,
            "prompt_tokens": mix["prompt_tokens"]}


def dense_decode(model, params, gen, B: int, S: int, rng) -> None:
    """One ``forward_step`` with T=1 against a dense cache filled with
    random K/V, lengths spread over 1..S: the ragged kernel's path."""
    import torch
    cfg = model.cfg
    cache = model.init_kv_cache(B, S)
    for name in ("k", "v"):
        for layer in cache[name]:
            layer.copy_(torch.randn(layer.shape, generator=gen,
                                    device=model.device))
    offsets = torch.from_numpy(
        np.linspace(0, S - 1, B).round().astype(np.int32)).to(model.device)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)) \
        .to(model.device)
    logits, cache = model.forward_step(params, tokens, cache, offsets)
    torch.cuda.synchronize()
    if logits.shape != (B, 1, cfg.vocab_size) or \
            not torch.isfinite(logits).all():
        raise RuntimeError("forward_step(T=1) logits not finite/shaped")


def live_pool_compare(server, rng) -> dict:
    """decode_step_paged through the kernel and through the reference on
    two clones of one live pool; returns the decode step times."""
    import torch
    from ray_tpu_torch.llm import SamplingParams
    from ray_tpu_torch.models.llama import LlamaModel

    eng = server.engine
    vocab = eng.model.cfg.vocab_size
    for n in (100, 180, 260, 300):
        eng.submit([int(t) for t in rng.integers(0, vocab, n)],
                   SamplingParams(max_tokens=64))
    for _ in range(8):
        eng.step()
    active = [i for i, r in enumerate(eng.slots) if r is not None]
    if len(active) < 4 or (eng.offsets[active] <= eng.block_size).any():
        raise RuntimeError("live pool not set up: slots "
                           f"{active}, offsets {eng.offsets[active]}")
    ker = eng.model
    ref = LlamaModel(dataclasses.replace(ker.cfg,
                                         decode_attention="reference"),
                     device=ker.device)
    tokens = torch.from_numpy(
        rng.integers(0, vocab, eng.max_slots).astype(np.int32)).to(ker.device)
    tables = torch.from_numpy(eng._tables.copy()).to(ker.device)
    offsets = torch.from_numpy(eng.offsets.copy()).to(ker.device)
    pools = [{k: v.clone() for k, v in eng.kv.items()} for _ in range(2)]
    lk, pk = ker.decode_step_paged(eng.params, tokens, pools[0], tables,
                                   offsets)
    lr, pr = ref.decode_step_paged(eng.params, tokens, pools[1], tables,
                                   offsets)
    torch.cuda.synchronize()
    rows = torch.tensor(active, device=ker.device)
    err = (lk[rows] - lr[rows]).abs().max().item()
    torch.testing.assert_close(lk[rows], lr[rows], **STEP_TOL)
    # the step's only pool writes outside the scratch block: each active
    # slot's new row in every layer
    off = offsets[rows].long()
    blk = tables[rows, off // eng.block_size].long()
    for name in ("k", "v"):
        torch.testing.assert_close(
            pk[name][:, blk, off % eng.block_size].float(),
            pr[name][:, blk, off % eng.block_size].float(), **STEP_TOL)
    del pr
    # decode step time, kernel and reference, on the clones
    times = {}
    for label, model, pool in (("kernel", ker, pk), ("reference", ref,
                                                     pools[1])):
        samples = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.decode_step_paged(eng.params, tokens, pool, tables,
                                    offsets)
            torch.cuda.synchronize()
            samples.append((time.perf_counter() - t0) * 1e3)
        times[label] = float(np.median(samples[1:]))
    del pools, pk
    return {"logits_max_abs_err": err, "step_ms": times,
            "active_slots": len(active),
            "live_tokens": int(eng.offsets[active].sum())}


def prefix_logits_compare(server, prompt: list) -> dict:
    """The last-token logits of ``prompt`` through a full prefill and
    through the prefix path (its first whole blocks but one token taken
    from that prefill's K/V, the rest prefilled over them: the path a
    repeated prompt takes) at the repo's bf16 step bar."""
    import torch
    eng = server.engine
    n, bs = len(prompt), eng.block_size
    shared = (n - 1) // bs * bs

    def bucketed(seq):
        toks = np.zeros((1, eng._bucket_for(len(seq))), np.int32)
        toks[0, :len(seq)] = seq
        return eng._dev(toks)

    def count(k):
        return eng._dev(np.asarray([k], np.int32))

    full, small = eng._prefill(eng.params, bucketed(prompt), count(n))
    part, _ = eng.model.prefill_with_prefix(
        eng.params, bucketed(prompt[shared:]), small["k"][:, :, :shared],
        small["v"][:, :, :shared], count(shared), count(n - shared))
    torch.cuda.synchronize()
    err = (part - full).abs().max().item()
    torch.testing.assert_close(part, full, **STEP_TOL)
    top2 = full[0].topk(2).values
    return {"shared": shared, "max_abs_err": err,
            "argmax_equal": bool(part.argmax() == full.argmax()),
            "top2_gap": (top2[0] - top2[1]).item()}


# ---------------------------------------------------------------------------
# phases 5 and 6: the training path
# ---------------------------------------------------------------------------

def train_path(dev, n_layers: int) -> dict:
    from ray_tpu_torch.bench import run_train
    from ray_tpu_torch.ops import attention as attn
    attn.flash_attention_kernel.launches = 0
    out = run_train(dev, batch=8, seq=2048, steps=10, warmup=2, seed=0)
    launches = attn.flash_attention_kernel.launches
    steps = out["steps"] + out["warmup"]
    log(f"run_train(bench_400m, {out['model_params']} params, batch 8 x seq "
        f"2048, remat {out['remat']}): {out['tokens_per_sec']:.1f} tokens/s, "
        f"step {out['step_ms']:.2f} ms, MFU {out['mfu']:.4f} (6N over 989 "
        f"TFLOP/s), loss {out['loss_first']:.4f} -> {out['loss_last']:.4f}, "
        f"grad_norm {out['grad_norm']:.4f}; flash launches {launches} "
        f"({steps} steps x {n_layers} layers x 2)")
    if launches != 2 * n_layers * steps:
        raise RuntimeError(f"flash kernel launches {launches} != 2 x "
                           f"{n_layers} layers x {steps} steps")
    if not out["loss_last"] < out["loss_first"]:
        raise RuntimeError(f"the loss did not fall: {out}")
    out["launches"] = launches
    return out


def kernel_vs_blockwise_loss(dev, model_cls, cfg, batch: int) -> tuple:
    """``loss`` through the flash kernel and through the blockwise path on
    the same f32 params and batch (``batch`` x 2048 tokens)."""
    import torch
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (batch, 2048)).astype(np.int64)) \
        .to(dev)
    targets = torch.roll(tokens, -1, dims=1)
    params = model_cls(cfg, device=dev).init(1, param_dtype=torch.float32)
    losses = []
    with torch.no_grad():
        for impl in ("kernel", "blockwise"):
            model = model_cls(dataclasses.replace(cfg, attention_impl=impl),
                              device=dev)
            losses.append(model.loss(params, tokens, targets))
    torch.testing.assert_close(losses[0], losses[1], **LOSS_TOL)
    return losses[0].item(), losses[1].item()


# ---------------------------------------------------------------------------
# phases 7 and 8: the other model families
# ---------------------------------------------------------------------------

def free_card() -> None:
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def train_families(dev, moe_layers: int) -> dict:
    """Each family's run of ``bench.WORKLOADS`` on the card, the flash
    counter set to 0 just before and read just after."""
    import torch
    from ray_tpu_torch import bench
    from ray_tpu_torch.ops import attention as attn
    runs = {}
    for name in bench.WORKLOADS:
        attn.flash_attention_kernel.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        out = bench.run_family(name, dev)
        out["launches"] = attn.flash_attention_kernel.launches
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        free_card()
        steps = out["steps"] + out["warmup"]
        want = 2 * moe_layers * steps if name == "moe" else 0
        mfu = ("" if out["mfu"] is None
               else f", MFU {out['mfu']} (6N over 989 TFLOP/s)")
        shape = (f"{out['batch']} x {out['seq']}" if out["seq"]
                 else f"{out['batch']}")
        log(f"{name}: {out['params']:,} params, batch {shape}, "
            f"{out['warmup']} + {out['steps']} steps: step "
            f"{out['step_ms']:.2f} ms, {out['per_sec']:.1f} {out['unit']}/s"
            f"{mfu}, loss {out['loss_first']:.4f} -> {out['loss_last']:.4f},"
            f" grad_norm {out['grad_norm']:.4f}, peak allocated "
            f"{out['peak_gib']:.2f} GiB; flash launches {out['launches']} "
            f"(want {want})")
        if out["launches"] != want:
            raise RuntimeError(f"{name}: flash kernel launches "
                               f"{out['launches']} != {want}")
        if not out["loss_last"] < out["loss_first"]:
            raise RuntimeError(f"{name}: the loss did not fall: {out}")
        runs[name] = out
    return runs


def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, dev) for v in tree]
    return tree.to(dev)


def card_vs_cpu_loss(dev, name: str) -> tuple:
    """The f32 loss of GPT-2 125M (1 x 256 tokens) or ViT-L/16 (2 images)
    on the card against the same port model and params on the CPU."""
    import torch
    from ray_tpu_torch.models import GPT2Config, GPT2Model, ViTConfig, \
        ViTModel
    rng = np.random.default_rng(2)
    if name == "gpt2":
        cfg = dataclasses.replace(GPT2Config.gpt2_125m(), dtype=torch.float32)
        model_cls = GPT2Model
        tokens = rng.integers(0, cfg.vocab_size, (1, 256))
        batch = (tokens, np.roll(tokens, -1, axis=1))
    else:
        cfg = dataclasses.replace(ViTConfig.vit_l16(), dtype=torch.float32)
        model_cls = ViTModel
        batch = (rng.normal(size=(2, 224, 224, 3)).astype(np.float32),
                 rng.integers(0, cfg.num_classes, 2))
    batch = tuple(torch.from_numpy(b) for b in batch)
    cpu = model_cls(cfg, device="cpu")
    params = cpu.init(2, param_dtype=torch.float32)
    with torch.no_grad():
        want = cpu.loss(params, *batch)
        got = model_cls(cfg, device=dev).loss(to_device(params, dev), *batch)
    if got.device.type != "cuda":
        raise RuntimeError(f"{name}: the card's loss came from {got.device}")
    got = got.cpu()
    torch.testing.assert_close(got, want, rtol=1e-3, atol=0)
    return got.item(), want.item()


# ---------------------------------------------------------------------------
# phase 9: the mesh path
# ---------------------------------------------------------------------------

def step_profile(model, batch) -> dict:
    """CUDA kernel launches and their summed device time in one train step
    of ``model`` on the host ``batch`` (one warm step, then one under the
    profiler), beside the step's wall time under the profiler."""
    import torch
    from ray_tpu_torch.train import make_train_step, shard_batch
    ts = make_train_step(model, mesh=getattr(model, "mesh", None))
    params, opt = ts.init_fn(0)
    data = shard_batch(batch, ts)
    ts.step_fn(params, opt, data)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        ts.step_fn(params, opt, data)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    del params, opt
    free_card()
    return {"launches": sum(e.count for e in kernels),
            "device_ms": sum(e.self_device_time_total for e in kernels)
            / 1e3, "profiled_wall_ms": wall}


def bench_batch(cfg, rows: int = 8):
    """Phase 5's batch: ``rows`` x 2048 tokens from seed 0."""
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                               (rows, 2048))
    return tokens, np.roll(tokens, -1, axis=1)


def launches_per_step(dev, mesh) -> dict:
    """One bench_400m train step (batch 8 x 2048) on ``mesh`` or with
    none, profiled (``step_profile``)."""
    from ray_tpu_torch.models import LlamaConfig, LlamaModel
    cfg = LlamaConfig.bench_400m()
    return step_profile(LlamaModel(cfg, device=dev, mesh=mesh),
                        bench_batch(cfg))


def mesh_train(dev, mesh, plain: dict, n_layers: int) -> dict:
    """bench_400m through ``run_train(mesh=...)``, the flash counter at 0
    just before and read just after, held against phase 5's run."""
    from ray_tpu_torch.bench import run_train
    from ray_tpu_torch.ops import attention as attn
    attn.flash_attention_kernel.launches = 0
    out = run_train(dev, batch=8, seq=2048, steps=10, warmup=2, seed=0,
                    mesh=mesh)
    out["launches"] = attn.flash_attention_kernel.launches
    steps = out["steps"] + out["warmup"]
    gaps = {k: abs(out[k] / plain[k] - 1)
            for k in ("loss_first", "grad_norm_first")}
    log(f"run_train(bench_400m, mesh {out['mesh']}): "
        f"{out['tokens_per_sec']:.1f} tokens/s, step {out['step_ms']:.2f} ms, "
        f"MFU {out['mfu']:.4f}, loss {out['loss_first']:.6f} -> "
        f"{out['loss_last']:.6f}, first grad_norm "
        f"{out['grad_norm_first']:.6f}; flash launches {out['launches']} "
        f"({steps} steps x {n_layers} layers x 2)")
    log(f"  against phase 5 (no mesh): step {plain['step_ms']:.2f} ms, "
        f"{plain['tokens_per_sec']:.1f} tokens/s, MFU {plain['mfu']:.4f}; "
        f"step time ratio mesh / no mesh "
        f"{out['step_ms'] / plain['step_ms']:.4f}; first loss "
        f"{plain['loss_first']:.6f} (relative gap {gaps['loss_first']:.2e}),"
        f" first grad_norm {plain['grad_norm_first']:.6f} (relative gap "
        f"{gaps['grad_norm_first']:.2e}); bar rtol 1e-3")
    if out["launches"] != 2 * n_layers * steps:
        raise RuntimeError(f"mesh path: flash kernel launches "
                           f"{out['launches']} != 2 x {n_layers} x {steps}")
    if not out["loss_last"] < out["loss_first"]:
        raise RuntimeError(f"mesh path: the loss did not fall: {out}")
    if max(gaps.values()) > 1e-3:
        raise RuntimeError(f"mesh path: first step off phase 5's: {gaps}")
    return out


def mesh_checkpoint(dev, mesh) -> dict:
    """The sharded bench_400m params and AdamW state after one step, saved
    and restored onto the mesh and with no mesh: every leaf bit for bit."""
    import os
    import shutil
    import tempfile
    import torch
    from ray_tpu_torch.models import LlamaConfig, LlamaModel
    from ray_tpu_torch.train import make_train_step, shard_batch
    from ray_tpu_torch.train.checkpoint import Checkpoint
    from ray_tpu_torch.train.spmd import mirror_shardings
    cfg = LlamaConfig.bench_400m()
    ts = make_train_step(LlamaModel(cfg, device=dev, mesh=mesh), mesh=mesh)
    params, opt = ts.init_fn(0)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (8, 2048))
    ts.step_fn(params, opt, shard_batch((tokens, np.roll(tokens, -1, 1)),
                                        ts))
    state = {"params": params, "opt": opt.state_dict()}
    pl = {"params": ts.param_shardings,
          "opt": mirror_shardings(state["opt"], ts.param_shardings)}
    path = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt = Checkpoint.from_pytree(state, path)
        save_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(path, f))
                     for f in os.listdir(path))
        flat = []
        compared = 0
        for restored in (ckpt.to_pytree(pl, mesh), ckpt.to_pytree()):
            compared += _same_tree(state, restored, flat)
            del restored
    finally:
        shutil.rmtree(path, ignore_errors=True)
    del params, opt, state
    free_card()
    return {"save_s": save_s, "bytes": nbytes, "leaves": compared // 2,
            "restored_dtensors": sum(flat)}


def _same_tree(a, b, dtensors: list) -> int:
    """Leaves compared; raises unless ``b`` equals ``a`` bit for bit (a
    DTensor against its full value)."""
    import torch
    from torch.distributed.tensor import DTensor
    if isinstance(a, torch.Tensor):
        dtensors.append(isinstance(b, DTensor))
        fa = a.full_tensor() if isinstance(a, DTensor) else a
        fb = b.full_tensor() if isinstance(b, DTensor) else b
        if fa.dtype != fb.dtype or not torch.equal(fa.detach().cpu(),
                                                   fb.detach().cpu()):
            raise RuntimeError("checkpoint: a restored leaf differs")
        return 1
    if isinstance(a, dict):
        if list(a) != list(b):
            raise RuntimeError(f"checkpoint: keys {list(a)} != {list(b)}")
        return sum(_same_tree(a[k], b[k], dtensors) for k in a)
    if isinstance(a, (list, tuple)):
        return sum(_same_tree(x, y, dtensors) for x, y in zip(a, b))
    if a != b:
        raise RuntimeError(f"checkpoint: {a!r} != {b!r}")
    return 0


def mesh_gpt2(dev, mesh, plain: dict) -> dict:
    """Phase 7's GPT-2 workload and timing on ``mesh``: its first loss
    against phase 7's (same seed and batch) and its step time beside it."""
    from ray_tpu_torch import bench
    from ray_tpu_torch.models import GPT2Config, GPT2Model
    _, batch = bench.family_workload("gpt2", dev)
    out = bench.time_train_steps(
        GPT2Model(GPT2Config.gpt2_125m(), device=dev, mesh=mesh), batch,
        steps=plain["steps"], warmup=plain["warmup"])
    gap = abs(out["loss_first"] / plain["loss_first"] - 1)
    log(f"gpt2 on the mesh (phase 7's workload and timing): step "
        f"{out['step_ms']:.2f} ms against {plain['step_ms']:.2f} ms without "
        f"(ratio {out['step_ms'] / plain['step_ms']:.4f}); first loss "
        f"{out['loss_first']:.6f} against {plain['loss_first']:.6f} "
        f"(relative gap {gap:.2e}, bar 1e-3), last {out['loss_last']:.4f}")
    if gap > 1e-3 or not out["loss_last"] < out["loss_first"]:
        raise RuntimeError(f"gpt2 on the mesh: {out}")
    return out


def mesh_path(dev, plain: dict, gpt2_plain: dict, n_layers: int) -> dict:
    """Phase 9: the one-rank mesh, bench_400m on it, the GPT-2 DP example
    and phase 7's GPT-2 run on it, the sharded checkpoint."""
    import torch.distributed as dist
    from ray_tpu_torch.examples import train_gpt2_dp
    from ray_tpu_torch.parallel import MeshSpec, build_mesh
    mesh = build_mesh(MeshSpec())
    log(f"mesh {mesh}: world size {dist.get_world_size()}, backend "
        f"{dist.get_backend()}")
    if dist.get_world_size() != 1 or dist.get_backend() != "nccl" \
            or mesh.mesh_dim_names != ("pp", "dp", "fsdp", "sp", "tp", "ep"):
        raise RuntimeError(f"mesh path: not a one-rank NCCL mesh: {mesh}")
    out = mesh_train(dev, mesh, plain, n_layers)
    free_card()
    per_step = {"no mesh": launches_per_step(dev, None),
                "mesh": launches_per_step(dev, mesh)}
    ratio = per_step["mesh"]["launches"] / per_step["no mesh"]["launches"]
    log(f"one profiled bench_400m step (CUDA kernel launches, their device "
        f"ms, wall ms): {per_step} (launch ratio {ratio:.4f})")
    gpt2 = train_gpt2_dp.main(debug=False, steps=7, batch=8, seq=1024)
    free_card()
    log(f"GPT-2 DP example (gpt2_125m, {gpt2['batch']} x {gpt2['seq']}, "
        f"mesh {gpt2['mesh']}): loss {gpt2['losses'][0]:.4f} -> "
        f"{gpt2['losses'][-1]:.4f}, step {gpt2['step_ms']:.2f} ms "
        f"(mean of the last 5)")
    if not gpt2["losses"][-1] < gpt2["losses"][0]:
        raise RuntimeError(f"GPT-2 DP example: the loss did not fall: {gpt2}")
    gpt2_timed = mesh_gpt2(dev, mesh, gpt2_plain)
    free_card()
    ck = mesh_checkpoint(dev, mesh)
    log(f"checkpoint of the sharded bench_400m params + AdamW state: "
        f"{ck['leaves']} leaves, {ck['bytes'] / 1e9:.3f} GB saved in "
        f"{ck['save_s']:.2f} s ({ck['bytes'] / 1e9 / ck['save_s']:.3f} GB/s);"
        f" restored onto the mesh ({ck['restored_dtensors']} DTensors) and "
        f"with no mesh: bit for bit")
    if ck["restored_dtensors"] == 0:
        raise RuntimeError("checkpoint: nothing was restored onto the mesh")
    out.update(per_step=per_step, gpt2=gpt2, gpt2_timed=gpt2_timed,
               checkpoint=ck)
    return out


# ---------------------------------------------------------------------------
# phase 10: sequence, expert and pipeline parallelism
# ---------------------------------------------------------------------------

def moe_alltoall(dev, mesh, plain: dict, n_layers: int) -> dict:
    """(a) Phase 7's MoE workload with the expert all-to-all on ``mesh``:
    the same seed and batch, so at ep 1 the same first loss."""
    import torch
    from ray_tpu_torch import bench
    from ray_tpu_torch.models import MoEModel
    from ray_tpu_torch.ops import attention as attn
    cfg = dataclasses.replace(bench.moe_bench_config(),
                              moe_dispatch="alltoall")
    _, batch = bench.family_workload("moe", dev)
    torch.cuda.reset_peak_memory_stats(dev)
    attn.flash_attention_kernel.launches = 0
    out = bench.time_train_steps(MoEModel(cfg, device=dev, mesh=mesh), batch,
                                 steps=plain["steps"], warmup=plain["warmup"])
    out["launches"] = attn.flash_attention_kernel.launches
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    free_card()
    out["profile"] = {
        "einsum, no mesh": step_profile(MoEModel(bench.moe_bench_config(),
                                                 device=dev), batch),
        "alltoall, mesh": step_profile(MoEModel(cfg, device=dev, mesh=mesh),
                                       batch)}
    log(f"  one profiled MoE step (CUDA kernel launches, their device ms, "
        f"wall ms): {out['profile']}")
    steps = out["steps"] + out["warmup"]
    tokens = batch[0].size
    gap = abs(out["loss_first"] / plain["loss_first"] - 1)
    log(f"moe[alltoall] on the mesh (phase 7's workload): step "
        f"{out['step_ms']:.2f} ms, {tokens / out['step_ms'] * 1e3:.1f} "
        f"tokens/s, against phase 7's einsum {plain['step_ms']:.2f} ms, "
        f"{plain['per_sec']:.1f} tokens/s (ratio "
        f"{out['step_ms'] / plain['step_ms']:.4f}); first loss "
        f"{out['loss_first']:.6f} against {plain['loss_first']:.6f} "
        f"(relative gap {gap:.2e}, bar 1e-3), last {out['loss_last']:.4f}; "
        f"peak allocated {out['peak_gib']:.2f} GiB; flash launches "
        f"{out['launches']} ({steps} steps x {n_layers} layers x 2)")
    if out["launches"] != 2 * n_layers * steps:
        raise RuntimeError(f"moe[alltoall]: flash launches "
                           f"{out['launches']} != 2 x {n_layers} x {steps}")
    if gap > 1e-3 or not out["loss_last"] < out["loss_first"]:
        raise RuntimeError(f"moe[alltoall]: {out}")
    return out


def context_parallel_sp1(dev, gen) -> dict:
    """(b) Ring and Ulysses attention at sp 1 at bench_400m's attention
    shapes: bf16 forward against the flash kernel, f32 gradients against
    autograd through the reference, bf16 forward and forward+backward
    times."""
    import torch
    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.ops.ring_attention import ring_attention
    from ray_tpu_torch.ops.ulysses import ulysses_attention
    from ray_tpu_torch.profile_kernels import eager_ms
    B, S, H, Hkv, D = 8, 2048, 8, 4, 128
    shapes = ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D))
    q, k, v = (torch.randn(sh, generator=gen, device=dev).to(torch.bfloat16)
               for sh in shapes)
    flash = attn.flash_attention_kernel(q, k, v, True)
    out = {}
    for name, fn in (("ring", ring_attention), ("ulysses",
                                                 ulysses_attention)):
        got = fn(q, k, v)
        torch.testing.assert_close(got.float(), flash.float(), **BF16_TOL)
        qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))

        def fwd_bwd():
            fn(qg, kg, vg).float().sum().backward()
        out[name] = {"max_abs_err": (got.float() - flash.float()).abs()
                     .max().item(), "tol_ratio": tol_ratio(got, flash),
                     "ms": eager_ms(lambda: fn(q, k, v), 5, 1),
                     "fwd_bwd_ms": eager_ms(fwd_bwd, 3, 1)}
        del got, qg, kg, vg
        free_card()
    q32, k32, v32 = (t.float().requires_grad_() for t in (q, k, v))
    cot = torch.randn((B, S, H, D), generator=gen, device=dev)
    ref = torch.autograd.grad((attn.reference_attention(q32, k32, v32)
                               * cot).sum(), (q32, k32, v32))
    for name, fn in (("ring", ring_attention), ("ulysses",
                                                 ulysses_attention)):
        grads = torch.autograd.grad((fn(q32, k32, v32) * cot).sum(),
                                    (q32, k32, v32))
        for a, b in zip(grads, ref):
            torch.testing.assert_close(a, b, **GRAD_TOL)
        out[name]["grad_err"] = max((a - b).abs().max().item()
                                    for a, b in zip(grads, ref))
        del grads
        free_card()
    del ref, flash
    free_card()
    for name, r in out.items():
        log(f"{name}_attention at sp 1, bf16 B={B} S={S} H={H} Hkv={Hkv} "
            f"D={D} causal: forward {r['ms']:.3f} ms, forward+backward "
            f"{r['fwd_bwd_ms']:.3f} ms; against the flash kernel max_abs_err "
            f"{r['max_abs_err']:.3e} ({r['tol_ratio']:.2f}x the tolerance "
            f"{BF16_TOL}); f32 gradients against the reference "
            f"{r['grad_err']:.3e} ({GRAD_TOL})")
    return out


def pipeline_one_stage(dev, mesh, plain: dict, n_layers: int) -> dict:
    """(c) bench_400m through ``pipelined`` over the mesh's one pp stage:
    ``PipelinedLlama``'s init, stage body and apply, 4 microbatches of
    2 x 2048 (phase 5's batch and seed), remat."""
    from ray_tpu_torch import bench
    from ray_tpu_torch.models import LlamaConfig, LlamaModel, PipelinedLlama
    from ray_tpu_torch.ops import attention as attn

    class OneStage(PipelinedLlama):
        """PipelinedLlama over one stage: the class refuses pp < 2, as
        JAX's does, while ``pipelined`` takes one stage."""

        def __init__(self, cfg, mesh, num_microbatches, device):
            self.cfg, self.mesh, self.rules = cfg, mesh, None
            self.num_microbatches, self.num_stages = num_microbatches, 1
            self.device = device
            self._base = LlamaModel(cfg, device=device, mesh=mesh)

    cfg = LlamaConfig.bench_400m()
    micro = 4
    attn.flash_attention_kernel.launches = 0
    out = bench.time_train_steps(OneStage(cfg, mesh, micro, dev),
                                 bench_batch(cfg), steps=3, warmup=2)
    out["launches"] = attn.flash_attention_kernel.launches
    free_card()
    out["profile"] = step_profile(OneStage(cfg, mesh, micro, dev),
                                  bench_batch(cfg))
    log(f"  one profiled pipelined step (CUDA kernel launches, their device "
        f"ms, wall ms): {out['profile']}")
    steps = out["steps"] + out["warmup"]
    want = 2 * n_layers * micro * steps
    gap = abs(out["loss_first"] / plain["loss_first"] - 1)
    log(f"pipelined bench_400m over one stage ({micro} microbatches of "
        f"2 x 2048, remat): step {out['step_ms']:.2f} ms against phase 5's "
        f"{plain['step_ms']:.2f} ms (ratio "
        f"{out['step_ms'] / plain['step_ms']:.4f}); first loss "
        f"{out['loss_first']:.6f} against {plain['loss_first']:.6f} "
        f"(relative gap {gap:.2e}, bar 1e-3), last {out['loss_last']:.4f}; "
        f"flash launches {out['launches']} ({steps} steps x {n_layers} "
        f"layers x {micro} microbatches x 2)")
    if out["launches"] != want:
        raise RuntimeError(f"pipeline: flash launches {out['launches']} != "
                           f"{want}")
    if gap > 1e-3 or not out["loss_last"] < out["loss_first"]:
        raise RuntimeError(f"pipeline: {out}")
    return out


def parallel_layouts(dev, gen, plain: dict, moe_plain: dict,
                     n_layers: int) -> dict:
    """Phase 10 on the one-rank mesh of phase 9, then ``dryrun_mesh(8)``
    on this machine's CPU."""
    from ray_tpu_torch.dryrun import dryrun_mesh
    from ray_tpu_torch.parallel import MeshSpec, build_mesh
    mesh = build_mesh(MeshSpec())
    out = {"moe": moe_alltoall(dev, mesh, moe_plain, n_layers)}
    out["context"] = context_parallel_sp1(dev, gen)
    out["pipeline"] = pipeline_one_stage(dev, mesh, plain, n_layers)
    log("dryrun_mesh(8): 8 gloo ranks on this machine's CPU, by design: "
        "NCCL holds one rank a card, so the multi-rank meshes meet this "
        "torch here")
    t0 = time.perf_counter()
    out["dryrun"] = dryrun_mesh(8)
    log(f"dryrun_mesh(8): {len(out['dryrun'])} layouts in "
        f"{time.perf_counter() - t0:.1f} s, each at its one-device loss "
        f"(rtol 1e-4)")
    return out


# ---------------------------------------------------------------------------
# phase 11: the RL learners
# ---------------------------------------------------------------------------

# The CPU tests' configurations (tests/test_torch_rl.py holds the port's
# learners to JAX's with each): the learner's keywords, what one update
# takes (``rl_case_data``) and the bar, JAX's own for learner equality
# (tests/test_rl.py:259-264 for PPO; :284-289, IMPALA's, for the other
# Adam and RMSprop learners; the SGD learners at the first-step bar).
IMPALA_BAR = dict(rtol=5e-4, atol=5e-5)
RL_CASES = {
    "PPO": (dict(epochs=1, minibatch_size=128), "fragment",
            dict(rtol=2e-4, atol=2e-5)),
    "IMPALA": ({}, "fragment", IMPALA_BAR),
    "APPO": ({}, "fragment", IMPALA_BAR),
    "DQN": (dict(batch_size=64, updates_per_iter=4, target_update_every=2),
            "fragments", IMPALA_BAR),
    "SAC": (dict(batch_size=128, updates_per_call=4), "fragments",
            IMPALA_BAR),
    "BC": ({}, "batches", dict(rtol=1e-5, atol=1e-6)),
    "OfflineDQN": (dict(target_update_every=2), "batches",
                   dict(rtol=1e-5, atol=1e-6)),
}

# The repo's full-width RL configurations (ray_tpu/rl/tuned_examples.py:29-58,
# targets :105-121), run through the port's copy of the registry
# (ray_tpu_torch/rl/tuned_examples.py): each trains until its target return
# or its 40 iterations.
TUNED = {"PPO": "ppo-cartpole", "DQN": "dqn-cartpole",
         "IMPALA": "impala-cartpole", "APPO": "appo-cartpole",
         "SAC": "sac-cartpole"}


def transitions(fragments) -> dict:
    """EnvRunner fragments as (obs, next_obs, action, reward, done) rows, as
    the JAX package's ``write_experiences`` flattens them
    (``rl/offline.py:42-53``)."""
    def cat(key):
        return np.concatenate([f[key] for f in fragments])
    return {"obs": cat("obs"),
            "next_obs": np.concatenate([np.concatenate(
                [f["obs"][1:], f["next_obs_last"][None]])
                for f in fragments]),
            "actions": cat("actions").astype(np.int64),
            "rewards": cat("rewards"), "dones": cat("dones")}


class Transitions:
    """An experience dataset in memory: ``iter_batches`` over transition
    rows in order, as the JAX package's parquet reader yields them."""

    def __init__(self, rows: dict):
        self.rows = rows

    def iter_batches(self, batch_size: int):
        n = len(self.rows["rewards"])
        for lo in range(0, n, batch_size):
            yield {k: v[lo:lo + batch_size] for k, v in self.rows.items()}


def rl_case_data(seed: int = 0) -> dict:
    """The inputs of ``RL_CASES``' updates, numpy only: two CartPole
    fragments of 256 steps (runners seeded ``seed`` + 1 and + 2, each with
    a seed-``seed`` ``ActorCriticPolicy`` on the host), and four batches of
    64 of their transitions."""
    from ray_tpu_torch import rl
    frags = [rl.EnvRunner(rl.CartPoleEnv, lambda: rl.ActorCriticPolicy(
        4, 2, seed=seed, device="cpu"), seed=seed + 1 + i).sample(256)
        for i in range(2)]
    rows = transitions(frags)
    return {"fragment": frags[:1], "fragments": frags,
            "batches": [{k: v[i * 64:(i + 1) * 64] for k, v in rows.items()}
                        for i in range(4)]}


def rl_case_update(learner, name: str, data: dict) -> dict:
    """One update of case ``name`` on a learner of either package."""
    kind = RL_CASES[name][1]
    if kind != "batches":
        return learner.update(data[kind])
    for batch in data["batches"]:
        metrics = learner.update(batch)
    return metrics


def make_learner(name: str, dev, seed: int = 0, **kwargs):
    """The port's learner of algorithm ``name`` on CartPole."""
    from ray_tpu_torch import rl
    cls = {"PPO": rl.PPOLearner, "DQN": rl.DQNLearner,
           "IMPALA": rl.ImpalaLearner, "APPO": rl.APPOLearner,
           "SAC": rl.SACLearner, "BC": rl.BCLearner,
           "OfflineDQN": rl.OfflineDQNLearner}[name]
    return cls(4, 2, seed=seed, device=dev, **kwargs)


def algorithm(name: str, dev, *, runners: int = 2, fragment: int = 256,
              seed: int = 0, **learner_kwargs):
    """The port's ``rl.Algorithm`` of ``name`` on CartPole through the
    port's runtime: ``runners`` EnvRunner actors (runner i seeded ``seed +
    1 + i``), the learner and the runners' policies on ``dev``."""
    from ray_tpu_torch import rl
    return (rl.AlgorithmConfig(algo=name, seed=seed)
            .environment("CartPole-v1")
            .env_runners(runners, rollout_fragment_length=fragment)
            .training(device=dev, **learner_kwargs).build())


def flat_tree(tree, path: str = "") -> dict:
    """{path: numpy array} of a tree of dicts and lists (tensor, JAX or
    numpy leaves)."""
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items()
                for p, v in flat_tree(sub, f"{path}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {p: v for i, sub in enumerate(tree)
                for p, v in flat_tree(sub, f"{path}/{i}").items()}
    if hasattr(tree, "detach"):
        tree = tree.detach().cpu()
    return {path: np.asarray(tree)}


def flat_state(learner) -> dict:
    """``learner_state`` as {path: array}."""
    from ray_tpu_torch.rl import learner_state
    return flat_tree(learner_state(learner))


def state_ratio(a, b, bar: dict) -> float:
    """The worst ``tol_ratio`` over two learners' states."""
    import torch
    sa, sb = flat_state(a), flat_state(b)
    if set(sa) != set(sb):
        raise RuntimeError(f"states differ in keys: {sorted(sa)} "
                           f"{sorted(sb)}")
    return max(tol_ratio(torch.from_numpy(sa[k]), torch.from_numpy(sb[k]),
                         bar) for k in sa)


def rl_card_vs_cpu(dev) -> dict:
    """(a) Each case's learner on the CPU and on ``dev`` from the same state
    (``load_learner_state``) takes the same update; params and metrics are
    held to the case's bar."""
    import torch
    from ray_tpu_torch.rl import learner_state, load_learner_state
    data = rl_case_data()
    worst = {}
    for name, (kw, _, bar) in RL_CASES.items():
        cpu, card = (make_learner(name, d, **kw) for d in ("cpu", dev))
        load_learner_state(card, learner_state(cpu))
        m_cpu, m_card = (rl_case_update(x, name, data) for x in (cpu, card))
        ratio = state_ratio(card, cpu, bar)
        for k, v in m_cpu.items():
            ratio = max(ratio, tol_ratio(torch.tensor(float(m_card[k])),
                                         torch.tensor(float(v)), bar))
        worst[name] = ratio
        if ratio > 1:
            raise RuntimeError(f"RL {name}: the card's update is off the "
                               f"CPU's by {ratio:.3f}x the bar {bar}")
    log("RL card vs CPU, one update each from the same state, worst "
        "|card - cpu| / (atol + rtol |cpu|) at the CPU tests' bars: "
        + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))
    return worst


def rl_learning(dev) -> dict:
    """(b) The JAX package's learning bars (tests/test_rl.py) through the
    port's ``Algorithm``, learners on ``dev``."""
    from ray_tpu_torch import rl
    out = {}
    # PPO, tests/test_rl.py:24-43
    algo = algorithm("PPO", dev, runners=2, fragment=256, lr=1e-3,
                     epochs=4, minibatch_size=128)
    rets = [algo.train()["episode_return_mean"] for _ in range(12)]
    algo.stop()
    rets = [r for r in rets if np.isfinite(r)]
    out["PPO"] = (rets[0], rets[-1])
    if not (rets[-1] > rets[0] and rets[-1] > 40):
        raise RuntimeError(f"PPO did not learn: returns {rets}")
    # IMPALA, :193-216
    algo = algorithm("IMPALA", dev, runners=2, fragment=256, lr=1e-3,
                     ent_coef=0.01)
    rets = []
    for _ in range(12):
        m = algo.train()
        if not np.isnan(m["episode_return_mean"]):
            rets.append(m["episode_return_mean"])
    algo.stop()
    leading, trailing = float(np.mean(rets[:3])), float(np.mean(rets[-3:]))
    out["IMPALA"] = (leading, trailing, m["num_learner_updates"])
    if not (m["num_learner_updates"] >= 24 and trailing > 35
            and trailing > leading * 0.7):
        raise RuntimeError(f"IMPALA did not learn: {out['IMPALA']} {rets}")
    # SAC, :218-233
    algo = algorithm("SAC", dev, runners=1, fragment=256, batch_size=128,
                     updates_per_call=8)
    for _ in range(4):
        m = algo.train()
    algo.stop()
    out["SAC"] = (m["alpha"], m["entropy"], m["num_learner_updates"])
    if not (m["num_learner_updates"] >= 16 and np.isfinite(m["q_loss"])
            and m["alpha"] > 0 and 0 < m["entropy"] <= np.log(2) + 1e-5):
        raise RuntimeError(f"SAC off its bars: {m}")
    # DQN, :46-61
    algo = algorithm("DQN", dev, runners=2, fragment=128, lr=1e-3,
                     updates_per_iter=16)
    eps = []
    for _ in range(4):
        m = algo.train()
        eps.append(m["epsilon"])
    algo.stop()
    out["DQN"] = (eps[0], eps[-1], m["td_loss"])
    if not (eps[-1] < eps[0] and np.isfinite(m["td_loss"])):
        raise RuntimeError(f"DQN off its bars: {eps} {m}")
    # BC and CQL from the runner's logged batches, :130-162 without the
    # parquet IO
    runner = rl.EnvRunner(rl.CartPoleEnv, lambda: rl.ActorCriticPolicy(
        4, 2, seed=0, device="cpu"), seed=0)
    ds = Transitions(transitions([runner.sample(128) for _ in range(2)]))
    bc = rl.BCLearner(4, 2, seed=0, lr=3e-3, device=dev)
    first = next(ds.iter_batches(batch_size=256))
    before = bc.evaluate_accuracy(first)
    m = rl.train_offline(ds, bc, batch_size=64, epochs=10)
    after = bc.evaluate_accuracy(first)
    out["BC"] = (before, after)
    if not (np.isfinite(m["bc_loss"]) and after >= before and after > 0.45):
        raise RuntimeError(f"BC off its bars: {before} -> {after}, {m}")
    cql = rl.OfflineDQNLearner(4, 2, seed=0, cql_alpha=1.0, device=dev)
    m = rl.train_offline(ds, cql, batch_size=64, epochs=2)
    out["CQL"] = (m["loss"], m["cql_penalty"])
    if not (np.isfinite(m["loss"]) and m["cql_penalty"] >= 0.0
            and cql.act(np.zeros(4, np.float32)) in (0, 1)):
        raise RuntimeError(f"CQL off its bars: {m}")
    log(f"RL learning bars on {dev} (tests/test_rl.py): PPO return "
        f"{out['PPO'][0]:.1f} -> {out['PPO'][1]:.1f} (> first, > 40); "
        f"IMPALA leading {leading:.1f}, trailing {trailing:.1f} (> 35) "
        f"after {out['IMPALA'][2]} updates; SAC alpha {out['SAC'][0]:.4f}, "
        f"entropy {out['SAC'][1]:.4f} (0 < H <= ln 2); DQN epsilon "
        f"{eps[0]:.4f} -> {eps[-1]:.4f}, td_loss {out['DQN'][2]:.4f}; BC "
        f"accuracy {before:.4f} -> {after:.4f} (> 0.45); CQL loss "
        f"{out['CQL'][0]:.4f}, penalty {out['CQL'][1]:.4f}")
    return out


def sync(dev) -> None:
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def tuned_config(name: str):
    """The registry's config of tuned contract ``name`` (ray_tpu_torch.rl.
    tuned_examples, JAX's configs)."""
    from ray_tpu_torch.rl.tuned_examples import TUNED as registry
    return registry[TUNED[name]].make_config()


def rl_update_profile(name: str, dev) -> dict:
    """A fresh learner of a tuned config on ``dev`` and on the CPU, on the
    same rollouts (sampled by the config's ``Algorithm`` on the CPU; IMPALA
    and APPO: one fragment, their update's input): update ms, the median of
    5 after a warm-up update (which fills DQN's and SAC's replay buffers);
    gradient steps an update; and one profiled update on ``dev``: kernel
    launches, their device time and its share of the update's wall
    time."""
    import torch
    import ray_tpu_torch as rt
    cfg = tuned_config(name)
    kw = dict(cfg.learner_kwargs)
    sampler = cfg.training(device="cpu").build()
    rollouts = rt.get([r.sample.remote(cfg.rollout_fragment_length)
                       for r in sampler.runners])
    sampler.stop()
    if name in ("IMPALA", "APPO"):
        rollouts = rollouts[:1]
    out = {}
    for key, where in (("card_ms", dev), ("cpu_ms", "cpu")):
        learner = make_learner(name, where, **kw)
        learner.update(rollouts)
        times = []
        for _ in range(5):
            sync(where)
            t0 = time.perf_counter()
            learner.update(rollouts)
            sync(where)
            times.append((time.perf_counter() - t0) * 1e3)
        out[key] = float(np.median(times))
        if key == "card_ms":
            card = learner
    rows = sum(len(r["rewards"]) for r in rollouts)
    if name == "PPO":
        out["steps"] = card.epochs * -(-rows // card.minibatch_size)
    else:
        out["steps"] = {"DQN": getattr(card, "updates_per_iter", 1),
                        "SAC": getattr(card, "updates_per_call", 1)}.get(
                            name, 1)
    sync(dev)
    t0 = time.perf_counter()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        card.update(rollouts)
        sync(dev)
    wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    out["launches"] = sum(e.count for e in kernels)
    out["device_ms"] = sum(e.self_device_time_total for e in kernels) / 1e3
    out["profiled_wall_ms"] = wall
    return out


def iteration_split(algo, iterations: int = 3) -> dict:
    """Where ``iterations`` calls of ``algo.train()`` spend their time, in
    ms an iteration: the wall time; the learner's update; the runners' own
    work (their sample, set_weights and episode_returns bodies, summed
    over the runners' threads); and the main thread's calls into the runtime —
    submits (``.remote``), ``wait``, ``get`` (both include waiting for the
    runners) and the weight ``put``. ``runtime_ms`` is the runtime's own
    cost as the main thread feels it: submits and puts, plus the time blocked in
    ``get`` and ``wait`` beyond the runners' work (none where the runners
    sample while the learner updates, as IMPALA's and APPO's do)."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import actor as actor_mod
    from ray_tpu_torch._private import worker
    spent = dict.fromkeys(("update", "runners", "submit", "wait", "get",
                           "put"), 0.0)
    lock = threading.Lock()

    def timed(key, fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                with lock:
                    spent[key] += time.perf_counter() - t0
        return wrapper

    instances = [worker.global_worker()._actor_executors[
        h._ray_actor_id].instance for h in algo.runners]
    saved_api = {k: getattr(rt, k) for k in ("wait", "get", "put")}
    saved_remote = actor_mod.ActorMethod.remote
    try:
        for k, fn in saved_api.items():
            setattr(rt, k, timed(k, fn))
        actor_mod.ActorMethod.remote = timed("submit", saved_remote)
        algo.learner.update = timed("update", algo.learner.update)
        for inst in instances:
            for m in ("sample", "set_weights", "episode_returns"):
                setattr(inst, m, timed("runners", getattr(inst, m)))
        sync(algo.learner.device)
        t0 = time.perf_counter()
        for _ in range(iterations):
            algo.train()
        sync(algo.learner.device)
        wall = time.perf_counter() - t0
    finally:
        for k, fn in saved_api.items():
            setattr(rt, k, fn)
        actor_mod.ActorMethod.remote = saved_remote
        del algo.learner.update
        for inst in instances:
            for m in ("sample", "set_weights", "episode_returns"):
                delattr(inst, m)
    out = {f"{k}_ms": v * 1e3 / iterations for k, v in spent.items()}
    out["wall_ms"] = wall * 1e3 / iterations
    blocked = out["get_ms"] + out["wait_ms"] - out["runners_ms"]
    out["runtime_ms"] = out["submit_ms"] + out["put_ms"] + max(blocked, 0.0)
    return out


def rl_contracts(dev) -> dict:
    """(c) The tuned CartPole contracts on ``dev`` through
    ``rl.tuned_examples.run``, reported and not gated: each trains until
    its target return or its 40 iterations; then its update's time on the
    card and on this machine's CPU, one profiled update, and where an
    iteration of the runtime-driven loop spends its time."""
    from ray_tpu_torch.rl.tuned_examples import TUNED as registry
    from ray_tpu_torch.rl.tuned_examples import run
    out = {}
    for name, key in TUNED.items():
        t0 = time.perf_counter()
        m = run(key, device=dev)
        wall = time.perf_counter() - t0
        best, its = m["best_return"], m["training_iteration"]
        target = registry[key].target_return
        prof = rl_update_profile(name, dev)
        algo = tuned_config(name).training(device=dev).build()
        algo.train()        # warm-up: fills the replay buffers
        split = iteration_split(algo)
        algo.stop()
        out[name] = dict(prof, best=best, iterations=its, target=target,
                         wall_s=wall, split=split)
        log(f"RL tuned {name} ({key}): best return {best:.1f} in {its} "
            f"iterations (target {target:g}: "
            f"{'met' if best >= target else 'NOT met'}; {wall:.1f} s); "
            f"update {prof['card_ms']:.2f} ms on the card, "
            f"{prof['cpu_ms']:.2f} ms on the CPU ({prof['steps']} gradient "
            f"steps: {prof['steps'] / prof['card_ms'] * 1e3:.1f} steps/s on "
            f"the card, {prof['steps'] / prof['cpu_ms'] * 1e3:.1f} on the "
            f"CPU); profiled update: {prof['launches']} launches "
            f"({prof['launches'] / prof['steps']:.1f} a step), "
            f"{prof['device_ms']:.3f} ms of device time: busy "
            f"{prof['device_ms'] / prof['card_ms']:.1%} of the update's "
            f"{prof['card_ms']:.2f} ms, "
            f"{prof['device_ms'] / prof['profiled_wall_ms']:.1%} of its "
            f"{prof['profiled_wall_ms']:.2f} ms under the profiler")
        log(f"  an iteration through the runtime ({key}, learner on {dev}; "
            f"ms, mean of 3): wall {split['wall_ms']:.2f}, learner update "
            f"{split['update_ms']:.2f}, runners' own work "
            f"{split['runners_ms']:.2f}, the runtime's own "
            f"{split['runtime_ms']:.2f} "
            f"({split['runtime_ms'] / split['wall_ms']:.1%}); calls into the runtime: "
            f"submit {split['submit_ms']:.3f}, wait {split['wait_ms']:.2f}, "
            f"get {split['get_ms']:.2f}, weight put {split['put_ms']:.3f}")
    return out


def rl_group_one_rank(dev, mesh) -> dict:
    """(d) ``LearnerGroup`` on the one-rank mesh: PPO's and IMPALA's update
    against the plain learner's at rtol 1e-6."""
    from ray_tpu_torch.rl import LearnerGroup
    data = rl_case_data()
    out = {}
    for name in ("PPO", "IMPALA"):
        kw, kind, _ = RL_CASES[name]
        plain, grouped = (make_learner(name, dev, **kw) for _ in range(2))
        group = LearnerGroup(grouped, mesh=mesh)
        plain.update(data[kind])
        group.update(data[kind])
        out[name] = state_ratio(grouped, plain, dict(rtol=1e-6, atol=0.0))
        if out[name] > 1:
            raise RuntimeError(f"LearnerGroup {name} on the one-rank mesh is "
                               f"off the plain learner: {out[name]:.3f}x "
                               "rtol 1e-6")
    log(f"LearnerGroup on the one-rank mesh (dp {group.num_learners}) "
        f"against the plain learner, rtol 1e-6: " + ", ".join(
            f"{k} {v:.3g}x the bar" for k, v in out.items()))
    return out


def rl_path(dev) -> dict:
    """Phase 11 on the port's runtime (its EnvRunner actors sample, the
    learner is on the card), every kernel counter at 0 before and read
    after: the RL learners launch none of the port's kernels."""
    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.ops import decode_attention as dec
    from ray_tpu_torch.ops import paged_attention as paged
    from ray_tpu_torch.parallel import MeshSpec, build_mesh
    counters = (attn.flash_attention_kernel,
                dec.ragged_decode_attention_kernel,
                paged.paged_decode_attention_kernel)
    import ray_tpu_torch as rt
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    rt.init()
    try:
        out = {"card_vs_cpu": rl_card_vs_cpu(dev),
               "learning": rl_learning(dev), "contracts": rl_contracts(dev),
               "group": rl_group_one_rank(dev, build_mesh(MeshSpec()))}
    finally:
        rt.shutdown()
    launches = [c.launches for c in counters]
    if any(launches):
        raise RuntimeError(f"the RL path launched the port's kernels: "
                           f"{launches}")
    log(f"phase 11 (RL) in {time.perf_counter() - t0:.1f} s; kernel "
        f"launches {launches}")
    return out


# ---------------------------------------------------------------------------
# phases 12 and 13: what both check
# ---------------------------------------------------------------------------

def kernel_counters() -> tuple:
    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.ops import decode_attention as dec
    from ray_tpu_torch.ops import paged_attention as paged
    return (paged.paged_decode_attention_kernel,
            dec.ragged_decode_attention_kernel, attn.flash_attention_kernel)


def read_launches() -> dict:
    return {c.__name__.replace("_kernel", ""): c.launches
            for c in kernel_counters()}


def check_paged_only(what: str, launches: dict, steps: int,
                     n_layers: int) -> None:
    """The paged kernel once per layer per decode step, no other kernel."""
    if steps < 1 or launches["paged_decode_attention"] != n_layers * steps:
        raise RuntimeError(f"{what}: paged kernel launches {launches} != "
                           f"{n_layers} x {steps} decode steps")
    if launches["ragged_decode_attention"] or launches["flash_attention"]:
        raise RuntimeError(f"{what}: other kernels launched: {launches}")


def finished_ok(reason, n: int) -> bool:
    """Phase 3's bar: 32 tokens, or fewer ending on the stop token."""
    return reason == "length" and n == 32 or \
        reason == "stop" and 1 <= n <= 32


# ---------------------------------------------------------------------------
# phase 12: the runtime on the card
# ---------------------------------------------------------------------------

def runtime_resources() -> dict:
    """(a) ``init()`` detects the card as ``GPU``; a ``num_gpus=1`` task runs
    in this process on the card and gives its resource back."""
    import os
    import torch
    import ray_tpu_torch as rt
    total = rt.cluster_resources()
    if total.get("GPU") != torch.cuda.device_count():
        raise RuntimeError(f"GPU not detected: {total}")

    @rt.remote(num_gpus=1)
    def where():
        return os.getpid(), torch.cuda.current_device()

    pid, current = rt.get(where.remote(), timeout=120)
    if pid != os.getpid():
        raise RuntimeError(f"a num_gpus task ran in process {pid}, not the "
                           f"caller's {os.getpid()}")
    avail = rt.available_resources()
    if avail.get("GPU") != total["GPU"]:
        raise RuntimeError(f"GPU not given back: {avail} of {total}")
    log(f"runtime resources {total}; a num_gpus=1 task ran in this process "
        f"(pid {pid}) on cuda:{current}; available afterwards {avail}")
    return {"total": total, "device": current}


def runtime_device_tier(gen) -> dict:
    """(b) A 256 MiB bf16 CUDA tensor through ``put``/``get`` keeps its
    storage and allocates nothing; a ``num_gpus=1`` task sums it on the
    card; dropping the ref and the tensor frees it."""
    import torch
    import ray_tpu_torch as rt
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    x = torch.randn(128 << 20, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    nbytes = x.numel() * x.element_size()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    ref = rt.put(x)
    got = rt.get(ref)
    round_trip_ms = (time.perf_counter() - t0) * 1e3
    after = torch.cuda.memory_allocated()
    if got.data_ptr() != x.data_ptr() or after > held:
        raise RuntimeError(f"device tier copied: data_ptr {got.data_ptr()} "
                           f"vs {x.data_ptr()}, allocated {after} vs {held}")

    @rt.remote(num_gpus=1)
    def total(t):
        return t.float().sum()

    remote_sum = rt.get(total.remote(ref), timeout=120)
    local_sum = x.float().sum()
    if not torch.equal(remote_sum, local_sum):
        raise RuntimeError(f"sum in the task {remote_sum.item()} != the "
                           f"caller's {local_sum.item()}")
    del ref, got, x, remote_sum, local_sum
    # the task's bookkeeping finishes on the runtime's threads: allow it
    # a moment to drop the last pin (other objects the collector frees
    # meanwhile may take the total below the base: released means the
    # tensor's bytes are gone)
    deadline = time.perf_counter() + 10.0
    while True:
        gc.collect()
        torch.cuda.synchronize()
        freed = torch.cuda.memory_allocated()
        if held - freed >= nbytes or time.perf_counter() > deadline:
            break
        time.sleep(0.01)
    if held - freed < nbytes:
        raise RuntimeError(f"device-tier object not released: {freed} "
                           f"bytes allocated, {held} with it, {base} "
                           f"before")
    log(f"device tier: put/get of a {nbytes} byte bf16 tensor in "
        f"{round_trip_ms:.3f} ms, same storage, allocated {after - held} "
        f"more bytes; a num_gpus=1 task's sum equal to the caller's; "
        f"released on del ({freed} bytes allocated, {base} before)")
    return {"bytes": nbytes, "round_trip_ms": round_trip_ms}


def actor_requests(server, mix: dict) -> dict:
    """Phase 3's mix through the ``LLMServer`` actor: the 12 plain prompts
    through ``__call__.remote``, the four prefix sharers through
    ``stream.options(num_returns="streaming").remote``, the last three once
    the first sharer's first token is out; everything collected with
    ``wait``."""
    import ray_tpu_torch as rt
    t0 = time.perf_counter()
    streams = [server.stream.options(num_returns="streaming").remote(
        {"prompt": mix["sharers"][0], "max_tokens": 32})]
    calls = [server.__call__.remote({"prompt": p, "max_tokens": 32})
             for p in mix["prompts"]]
    first = streams[0].next(timeout=600)
    streams += [server.stream.options(num_returns="streaming").remote(
        {"prompt": p, "max_tokens": 32}) for p in mix["sharers"][1:]]
    ready, pending = rt.wait(calls, num_returns=len(calls), timeout=900)
    if pending:
        raise RuntimeError(f"{len(pending)} calls not back in 900 s")
    # each stream's chunk refs, as the actor reports them
    chunk_refs = [first] + [ref for gen in streams for ref in gen]
    ready, pending = rt.wait(chunk_refs, num_returns=len(chunk_refs),
                             timeout=900)
    if pending:
        raise RuntimeError(f"{len(pending)} chunks not back in 900 s")
    wall = time.perf_counter() - t0
    results = [(out["finish_reason"], len(out["token_ids"]))
               for out in rt.get(calls)]
    by_request = {}
    for c in rt.get(chunk_refs):
        by_request.setdefault(c["id"], []).append(c)
    for cs in by_request.values():
        done = [c for c in cs if c.get("done")]
        results.append((done[0]["finish_reason"] if done else None,
                        len(cs) - len(done)))
    if len(results) != 16:
        raise RuntimeError(f"{len(results)} of 16 requests answered")
    for i, (reason, n) in enumerate(results):
        if not finished_ok(reason, n):
            raise RuntimeError(f"request {i}: finish {reason!r}, {n} tokens")
    return {"wall_s": wall, "tokens": sum(n for _, n in results),
            "full": sum(n == 32 for _, n in results)}


def runtime_serving(llm_config, mix: dict, lone_ids: list,
                    phase3: dict) -> dict:
    """(c) ``LLMServer`` as a ``num_gpus=1`` actor with phase 3's config:
    the lone request gives phase 3's token ids, phase 3's mix goes through
    it, the paged kernel runs once a layer a decode step; a ``num_gpus=1``
    task waits for the card until the actor is killed."""
    import torch
    import ray_tpu_torch as rt
    from ray_tpu_torch.llm import LLMServer
    n_layers = llm_config.model_config.n_layers
    t0 = time.perf_counter()
    server = rt.remote(LLMServer).options(
        num_gpus=1, max_concurrency=16).remote(llm_config)
    stats0 = rt.get(server.stats.remote(), timeout=900)
    torch.cuda.synchronize()    # the actor's weight init is queued work
    up_s = time.perf_counter() - t0
    for c in kernel_counters():
        c.launches = 0
    lone = rt.get(server.__call__.remote(
        {"prompt": mix["lone"], "max_tokens": 32}), timeout=600)
    if lone["token_ids"] != lone_ids:
        raise RuntimeError(f"the lone request through the actor gave "
                           f"{lone['token_ids']}, phase 3 {lone_ids}")
    served = actor_requests(server, mix)
    stats = rt.get(server.stats.remote())
    launches = read_launches()
    steps = stats["decode_steps"] - stats0["decode_steps"]
    if stats["prefix_prefills"] < 3 or stats["prefix_tokens_reused"] < 192:
        raise RuntimeError(f"the prefix path did not run: {stats}")
    check_paged_only("the actor's path", launches, steps, n_layers)

    @rt.remote(num_gpus=1)
    def on_card():
        return torch.cuda.current_device()

    probe = on_card.remote()
    ready, _ = rt.wait([probe], timeout=2.0)
    if ready:
        raise RuntimeError("a num_gpus=1 task ran while the actor held the "
                           "card")
    rt.get(server.shutdown.remote(), timeout=120)   # stop its engine thread
    rt.kill(server)
    rt.get(probe, timeout=120)
    del server
    free_card()
    rate, rate3 = (served["tokens"] / served["wall_s"],
                   phase3["tokens"] / phase3["wall_s"])
    log(f"LLMServer actor (num_gpus=1, max_concurrency=16) up in "
        f"{up_s:.1f} s; the lone request's 32 token ids equal phase 3's; "
        f"phase 3's 16 requests ({served['full']} of 16 gave 32 tokens): "
        f"{served['tokens']} tokens in "
        f"{served['wall_s']:.2f} s ({rate:.1f} tokens/s against phase 3's "
        f"direct {rate3:.1f}: x{rate / rate3:.3f}); engine stats {stats}; "
        f"launches {launches} ({steps} decode steps x {n_layers} layers); "
        f"a num_gpus=1 task stayed pending until kill(), then ran")
    return {"launches": launches, "steps": steps, "tokens": served["tokens"],
            "wall_s": served["wall_s"], "up_s": up_s}


def runtime_rates(smi: str) -> dict:
    """(d) The runtime's own cost on this host: no-op tasks, calls on one
    actor and put/get round trips of a 1 MiB numpy array, a second each."""
    import ray_tpu_torch as rt

    @rt.remote
    def noop():
        return None

    @rt.remote
    class Pinger:
        def ping(self):
            return None

    out = {}
    rt.get([noop.remote() for _ in range(100)])           # warm-up
    t0 = time.perf_counter()
    rt.get([noop.remote() for _ in range(1000)])
    out["tasks_per_s"] = 1000 / (time.perf_counter() - t0)
    actor = Pinger.remote()
    rt.get([actor.ping.remote() for _ in range(100)])     # warm-up
    t0 = time.perf_counter()
    rt.get([actor.ping.remote() for _ in range(1000)])
    out["actor_calls_per_s"] = 1000 / (time.perf_counter() - t0)
    rt.kill(actor)
    arr = np.arange(1 << 20, dtype=np.uint8)
    t0 = time.perf_counter()
    for _ in range(100):
        got = rt.get(rt.put(arr))
    out["put_get_per_s"] = 100 / (time.perf_counter() - t0)
    if not np.array_equal(got, arr):
        raise RuntimeError("put/get changed the array")
    log(f"runtime cost on this host ({smi}): {out['tasks_per_s']:.0f} "
        f"no-op tasks/s, {out['actor_calls_per_s']:.0f} actor calls/s, "
        f"{out['put_get_per_s']:.0f} put/get round trips/s of 1 MiB")
    return out


def runtime_path(gen, llm_config, mix: dict, lone_ids: list, phase3: dict,
                 rl: dict, smi: str) -> dict:
    """Phase 12: the runtime on the card, (a)-(d), then (e) phase 11's
    RL-through-the-runtime figures."""
    import ray_tpu_torch as rt
    t0 = time.perf_counter()
    rt.init()
    try:
        out = {"resources": runtime_resources(),
               "device_tier": runtime_device_tier(gen),
               "serving": runtime_serving(llm_config, mix, lone_ids,
                                          phase3),
               "rates": runtime_rates(smi)}
    finally:
        rt.shutdown()
    for name, c in rl["contracts"].items():
        split = c["split"]
        log(f"RL through the runtime ({name}, phase 11): an iteration "
            f"{split['wall_ms']:.2f} ms, the learner's update "
            f"{split['update_ms']:.2f} ms, the runtime's share "
            f"{split['runtime_ms']:.2f} ms ({smi})")
    log(f"phase 12 (runtime) in {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 13: serve on the card
# ---------------------------------------------------------------------------

def serving_config(rng=None):
    """Phase 3's server config and request mix: Llama-3-8B widths (random
    weights from seed 0), the paged kernel, 32 slots, max_seq 1024; the mix
    drawn from ``rng`` (a fresh generator of seed 0 by default)."""
    from ray_tpu_torch.llm import LLMConfig
    from ray_tpu_torch.models import LlamaConfig
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(),
                              decode_attention="kernel")
    llm_config = LLMConfig(model_id="llama3-8b", model_config=cfg,
                           max_slots=32, max_seq=1024, seed=0)
    rng = np.random.default_rng(0) if rng is None else rng
    return llm_config, request_mix(cfg.vocab_size, rng)


def engine_threads() -> list:
    return [t for t in threading.enumerate()
            if t.name == "llm-engine" and t.is_alive()]


def wait_freed(base: int, what: str, timeout: float = 10.0,
               threads=engine_threads) -> tuple:
    """Poll with ``gc.collect()`` until ``threads()`` (the engine threads by
    default) is empty and the card's allocated bytes are back within 256 MiB
    of ``base``. Each poll first clears torch's cuBLAS workspaces (one a
    thread that ran a matmul, 32 MiB on Hopper, kept by torch for the
    process's life): torch's cache, not the app's. Returns (allocated
    bytes, bytes the clearing released)."""
    import torch
    deadline = time.perf_counter() + timeout
    workspaces = 0
    while True:
        gc.collect()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch._C._cuda_clearCublasWorkspaces()
        left, alloc = threads(), torch.cuda.memory_allocated()
        workspaces += held - alloc
        if not left and alloc - base <= 256 << 20:
            return alloc, workspaces
        if time.perf_counter() > deadline:
            raise RuntimeError(f"{what}: threads {[t.name for t in left]} "
                               f"left, {alloc - base} bytes above the base "
                               f"after {timeout} s")
        time.sleep(0.05)


def handle_requests(handle, mix: dict) -> dict:
    """Phase 3's mix through a serve handle, in phase 12's order: the first
    prefix sharer, then the 12 plain prompts at once, then, once the first
    sharer's first chunk is out, the other three. Eight stream through
    ``handle.options(stream=True)`` (sharers 0 and 2, the even plain
    prompts), eight are unary (the odd plain prompts, sharers 1 and 3)."""
    prompts, sharers = mix["prompts"], mix["sharers"]
    lock = threading.Lock()
    streams = {}                # index -> (reason, tokens, first s, ttft)

    def stream(i, prompt, first=None):
        t0 = time.perf_counter()
        gen = handle.options(stream=True).remote(
            {"prompt": prompt, "max_tokens": 32, "stream": True})
        n, t_first, last = 0, None, None
        for chunk in gen:
            if chunk.get("done"):
                last = chunk
                continue
            n += 1
            if t_first is None:
                t_first = time.perf_counter() - t0
                if first is not None:
                    first.set()
        with lock:
            streams[i] = (last and last["finish_reason"], n, t_first,
                          last and last["ttft_s"])

    def start_stream(i, prompt, first=None):
        t = threading.Thread(target=stream, args=(i, prompt, first))
        t.start()
        return t

    t0 = time.perf_counter()
    first = threading.Event()
    threads = [start_stream(0, sharers[0], first)]
    threads += [start_stream(1 + i, p)
                for i, p in enumerate(prompts) if i % 2 == 0]
    unary = [handle.remote({"prompt": p, "max_tokens": 32})
             for i, p in enumerate(prompts) if i % 2]
    if not first.wait(600):
        raise RuntimeError("no first chunk from the prefix owner")
    unary.append(handle.remote({"prompt": sharers[1], "max_tokens": 32}))
    threads.append(start_stream(13, sharers[2]))
    unary.append(handle.remote({"prompt": sharers[3], "max_tokens": 32}))
    outs = [r.result(timeout=900) for r in unary]
    for t in threads:
        t.join(900)
        if t.is_alive():
            raise RuntimeError("a stream did not finish in 900 s")
    wall = time.perf_counter() - t0
    results = [(o["finish_reason"], len(o["token_ids"])) for o in outs]
    results += [(r, n) for r, n, _, _ in streams.values()]
    if len(results) != 16:
        raise RuntimeError(f"{len(results)} of 16 requests answered")
    for i, (reason, n) in enumerate(results):
        if not finished_ok(reason, n):
            raise RuntimeError(f"request {i}: finish {reason!r}, {n} tokens")
    return {"wall_s": wall, "tokens": sum(n for _, n in results),
            "first_chunk_s": sorted(f for _, _, f, _ in streams.values()),
            "ttft_s": sorted([o["ttft_s"] for o in outs]
                             + [t for _, _, _, t in streams.values()])}


def http_lone(port: int, prompt: list, lone_ids: list) -> None:
    """(b) The lone prompt through the HTTP proxy: one JSON ``POST`` gives
    ``lone_ids``, and so do the ``data:`` chunks of one SSE request, then
    ``[DONE]``."""
    import urllib.request
    url = f"http://127.0.0.1:{port}/"

    def post(payload):
        return urllib.request.urlopen(urllib.request.Request(
            url, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"}), timeout=600)

    with post({"prompt": prompt, "max_tokens": 32}) as resp:
        out = json.loads(resp.read())
    if out.get("token_ids") != lone_ids:
        raise RuntimeError(f"HTTP JSON gave {out}, the handle {lone_ids}")
    ids, done = [], False
    with post({"prompt": prompt, "max_tokens": 32, "stream": True}) as resp:
        if resp.headers["Content-Type"] != "text/event-stream":
            raise RuntimeError(f"SSE content type {resp.headers}")
        for raw in resp:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            body = line[len("data: "):]
            if body == "[DONE]":
                done = True
                break
            chunk = json.loads(body)
            if "token_id" in chunk:
                ids.append(chunk["token_id"])
    if not done or ids != lone_ids:
        raise RuntimeError(f"SSE gave {ids} (done {done}), the handle "
                           f"{lone_ids}")


def serve_llm_app(config, mix: dict, lone_ids: list, smi: str,
                  base: int) -> dict:
    """(a) the LLM app through a serve handle, (b) over HTTP, (c) freed on
    ``serve.delete``."""
    import torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm import build_llm_app
    n_layers = config.model_config.n_layers
    t0 = time.perf_counter()
    handle = serve.run(build_llm_app(config))
    torch.cuda.synchronize()    # the replica's weight init is queued work
    up_s = time.perf_counter() - t0
    lone = handle.remote({"prompt": mix["lone"], "max_tokens": 32}) \
        .result(timeout=900)
    if lone["token_ids"] != lone_ids:
        raise RuntimeError(f"the lone request through the handle gave "
                           f"{lone['token_ids']}, phase 3 {lone_ids}")
    stats0 = handle.stats.remote().result(timeout=60)
    for c in kernel_counters():
        c.launches = 0
    served = handle_requests(handle, mix)
    launches = read_launches()
    stats = handle.stats.remote().result(timeout=60)
    steps = stats["decode_steps"] - stats0["decode_steps"]
    if stats["prefix_prefills"] < 3:
        raise RuntimeError(f"the prefix path did not run: {stats}")
    check_paged_only("serve handle", launches, steps, n_layers)
    first, ttft = served["first_chunk_s"], served["ttft_s"]
    log(f"serve LLM app (one replica) up in {up_s:.1f} s; the lone "
        f"request's 32 token ids equal phase 3's; phase 3's 16 requests "
        f"(8 unary, 8 streams): {served['tokens']} tokens in "
        f"{served['wall_s']:.2f} s ({served['tokens'] / served['wall_s']:.1f}"
        f" tokens/s); client time to the first chunk of the 8 streams "
        f"median {np.median(first) * 1e3:.1f} ms, max {first[-1] * 1e3:.1f}"
        f" ms; engine ttft_s median {np.median(ttft) * 1e3:.1f} ms, max "
        f"{ttft[-1] * 1e3:.1f} ms; launches {launches} ({steps} decode "
        f"steps x {n_layers} layers); engine stats {stats} ({smi})")

    # The lone prompt's blocks are in the engine's prefix cache since its
    # first request: asked again, it takes the prefix path (2 of its 3
    # blocks reused), whose bf16 numbers differ from a full prefill's, so
    # its ids are held to the handle's answer in the same state, not to
    # phase 3's cold request.
    warm = handle.remote({"prompt": mix["lone"], "max_tokens": 32}) \
        .result(timeout=900)
    stats_warm = handle.stats.remote().result(timeout=60)
    if stats_warm["prefix_prefills"] != stats["prefix_prefills"] + 1:
        raise RuntimeError(f"the repeated lone prompt missed the prefix "
                           f"cache: {stats} then {stats_warm}")
    same = next((i for i, (a, b) in enumerate(zip(warm["token_ids"],
                                                  lone_ids)) if a != b), 32)
    port = serve.start_http_proxy(port=0)
    http_lone(port, mix["lone"], warm["token_ids"])
    log(f"HTTP proxy (port {port}): the lone prompt again (a prefix hit, "
        f"{stats_warm['prefix_tokens_reused'] - stats['prefix_tokens_reused']}"
        f" tokens reused) as JSON and as SSE gave the handle's 32 token ids "
        f"for it, then [DONE]; those equal phase 3's cold ids for the first "
        f"{same} tokens ({smi})")

    serve.delete("default")
    del handle
    freed, workspaces = wait_freed(base, "serve.delete of the LLM app")
    log(f"serve.delete: no engine thread left, {freed} bytes allocated "
        f"({base} before the app; {workspaces} bytes of cuBLAS workspaces "
        f"cleared) ({smi})")
    return {"launches": launches["paged_decode_attention"], "steps": steps,
            "tokens": served["tokens"], "wall_s": served["wall_s"],
            "first_chunk_s": first, "ttft_s": ttft, "up_s": up_s}


def serve_pd_app(config, mix: dict, lone_ids: list, smi: str,
                 base: int) -> dict:
    """(d) the prefill/decode graph: the lone request, then phase 3's 16
    prompts at once through the orchestrator; freed on ``serve.shutdown``."""
    import torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.llm.disagg import build_pd_disagg_app
    n_layers = config.model_config.n_layers
    t0 = time.perf_counter()
    handle = serve.run(build_pd_disagg_app(config, num_prefill=1,
                                           num_decode=1), name="pd")
    torch.cuda.synchronize()
    up_s = time.perf_counter() - t0
    peak = torch.cuda.memory_allocated()
    lone = handle.remote({"prompt": mix["lone"], "max_tokens": 32}) \
        .result(timeout=900)
    if lone["token_ids"] != lone_ids:
        raise RuntimeError(f"the lone request through prefill/decode gave "
                           f"{lone['token_ids']}, phase 3 {lone_ids}")
    decode = serve.get_deployment_handle(f"{config.model_id}-decode")
    prefill = serve.get_deployment_handle(f"{config.model_id}-prefill")
    stats0 = decode.stats.remote().result(timeout=60)
    for c in kernel_counters():
        c.launches = 0
    t0 = time.perf_counter()
    outs = [handle.remote({"prompt": p, "max_tokens": 32})
            for p in mix["prompts"] + mix["sharers"]]
    outs = [o.result(timeout=900) for o in outs]
    wall = time.perf_counter() - t0
    launches = read_launches()
    stats = decode.stats.remote().result(timeout=60)
    pre = prefill.stats.remote().result(timeout=60)
    steps = stats["decode_steps"] - stats0["decode_steps"]
    for i, o in enumerate(outs):
        if not finished_ok(o["finish_reason"], len(o["token_ids"])):
            raise RuntimeError(f"request {i}: {o}")
    check_paged_only("prefill/decode", launches, steps, n_layers)
    tokens = sum(len(o["token_ids"]) for o in outs)
    handoffs = stats["handoffs"][-16:]
    kv_mb = np.median([b for b, _ in handoffs]) / 1e6
    copy_ms = np.median([s for _, s in handoffs]) * 1e3
    prefill_ms = np.median(pre["prefill_s"][-16:]) * 1e3
    log(f"prefill/decode graph (1 prefill + 1 decode replica, "
        f"{peak / 2**30:.1f} GiB allocated) up in {up_s:.1f} s; the lone "
        f"request's 32 token ids equal phase 3's; phase 3's 16 prompts at "
        f"once: {tokens} tokens in {wall:.2f} s ({tokens / wall:.1f} "
        f"tokens/s); KV handoff a request, median: {kv_mb:.2f} MB, its "
        f"copy onto the card {copy_ms:.2f} ms (host time, the stream's "
        f"queued work first), the prefill and its copy to the host "
        f"{prefill_ms:.2f} ms; launches "
        f"{launches} ({steps} decode steps x {n_layers} layers) ({smi})")
    del handle, decode, prefill
    serve.shutdown()
    freed, workspaces = wait_freed(
        base, "serve.shutdown of the prefill/decode graph")
    log(f"serve.shutdown: no engine thread left, {freed} bytes allocated "
        f"({base} before the apps; {workspaces} bytes of cuBLAS workspaces "
        f"cleared) ({smi})")
    return {"launches": launches["paged_decode_attention"], "steps": steps,
            "tokens": tokens, "wall_s": wall, "kv_mb": kv_mb,
            "copy_ms": copy_ms, "prefill_ms": prefill_ms}


def serve_rates(smi: str, actor_calls_per_s=None) -> dict:
    """(e) The serve data plane's own cost on this host: a no-op function
    deployment with 2 replicas, 1,000 sequential calls and 1,000 in flight
    at once, a second each."""
    from ray_tpu_torch import serve

    @serve.deployment(num_replicas=2)
    def noop(x):
        return x

    handle = serve.run(noop.bind(), name="noop")
    for i in range(100):                                  # warm-up
        handle.remote(i).result(timeout=60)
    t0 = time.perf_counter()
    for i in range(1000):
        handle.remote(i).result(timeout=60)
    seq = 1000 / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    resps = [handle.remote(i) for i in range(1000)]
    got = [r.result(timeout=120) for r in resps]
    burst = 1000 / (time.perf_counter() - t0)
    if got != list(range(1000)):
        raise RuntimeError("the no-op deployment changed its inputs")
    beside = (f"phase 12's actor calls {actor_calls_per_s:.0f}/s"
              if actor_calls_per_s else "phase 12 not run")
    log(f"serve data plane on this host ({smi}): {seq:.0f} sequential "
        f"handle calls/s, {burst:.0f} calls/s with 1,000 in flight "
        f"(2 no-op replicas), beside {beside}")
    serve.shutdown()
    return {"sequential_per_s": seq, "in_flight_per_s": burst}


def log_prefix_compare(server, prompt: list) -> None:
    cmp = prefix_logits_compare(server, prompt)
    log(f"the lone prompt's last logits through the prefix path "
        f"({cmp['shared']} tokens cached) against a full prefill: max abs "
        f"err {cmp['max_abs_err']:.3e} (atol 0.15 rtol 0.05), argmax equal "
        f"{cmp['argmax_equal']}, top-2 gap of the full prefill "
        f"{cmp['top2_gap']:.3e}")


def serve_path(dev, llm_config=None, mix=None, lone_ids=None, phase3=None,
               phase12=None, smi=None) -> dict:
    """Phase 13: serve on the card, (a)-(e), on a fresh ``init()``. Alone
    (``python -c "import chip_smoke, torch;
    chip_smoke.serve_path(torch.device('cuda'))"``) it first runs phase 3's
    lone request on a direct ``LLMServer`` for the token ids to hold."""
    import torch
    import ray_tpu_torch as rt
    from ray_tpu_torch.llm import LLMServer
    t0 = time.perf_counter()
    if smi is None:
        smi = card_name()
    if llm_config is None:
        llm_config, mix = serving_config()
    if lone_ids is None:
        server = LLMServer(llm_config, device=dev)
        try:
            lone_ids = server({"prompt": mix["lone"],
                               "max_tokens": 32})["token_ids"]
            log_prefix_compare(server, mix["lone"])
        finally:
            server.shutdown()
        del server
    if rt.is_initialized() or engine_threads():
        raise RuntimeError("phase 12's runtime or an engine thread is "
                           "still up")
    free_card()
    torch._C._cuda_clearCublasWorkspaces()
    base = torch.cuda.memory_allocated()
    log(f"phase 13: no runtime and no engine thread up (phase 12's server "
        f"is gone); {base} bytes allocated as the base ({smi})")
    rt.init()
    try:
        app = serve_llm_app(llm_config, mix, lone_ids, smi, base)
        pd = serve_pd_app(llm_config, mix, lone_ids, smi, base)
        rates = serve_rates(smi, phase12 and phase12["rates"][
            "actor_calls_per_s"])
    finally:
        rt.shutdown()
    rate = app["tokens"] / app["wall_s"]
    beside = []
    if phase3:
        beside.append(f"phase 3's direct server "
                      f"{phase3['tokens'] / phase3['wall_s']:.1f}")
    if phase12:
        served = phase12["serving"]
        beside.append(f"phase 12's actor "
                      f"{served['tokens'] / served['wall_s']:.1f}")
    log(f"phase 13 (serve) in {time.perf_counter() - t0:.1f} s: the LLM "
        f"app {rate:.1f} tokens/s beside {', '.join(beside) or 'nothing'};"
        f" prefill/decode {pd['tokens'] / pd['wall_s']:.1f} tokens/s "
        f"({smi})")
    return {"app": app, "pd": pd, "rates": rates,
            "launches": app["launches"] + pd["launches"]}


# ---------------------------------------------------------------------------
# phase 14: the open-loop serving bench
# ---------------------------------------------------------------------------

def bench_row(what: str, out: dict, smi: str) -> dict:
    """Check one ``run_serving_bench`` result: every scheduled request
    completed, no error, no abandoned client; the paged kernel once per
    layer per decode step of the replica's engine (counters at 0 before the
    run) and no other kernel. Prints ``serving_section``."""
    from ray_tpu_torch.llm.bench import serving_section
    detail, s = out["detail"], out["serving"]
    if (s["completed"] != detail["scheduled_requests"] or s["errors"]
            or detail.get("abandoned_clients")):
        raise RuntimeError(f"{what}: {s['completed']} of "
                           f"{detail['scheduled_requests']} completed, "
                           f"{s['errors']} errors, "
                           f"{detail.get('abandoned_clients', 0)} clients "
                           f"abandoned")
    from ray_tpu_torch.models import LlamaConfig
    n_layers = LlamaConfig.bench_400m().n_layers
    launches = read_launches()
    steps = sum(st["decode_steps"] for st in detail["engine_stats"])
    check_paged_only(what, launches, steps, n_layers)
    log(f"{what}: serving {json.dumps(serving_section(detail))}; engine "
        f"ttft_s {json.dumps(detail['engine_ttft_s'])}; e2e "
        f"{json.dumps(detail['e2e_s'])}; queue "
        f"{json.dumps(detail['queue_s'])}; wall {detail['wall_s']} s; "
        f"launches {launches} ({steps} decode steps x {n_layers} layers); "
        f"engine stats {detail['engine_stats']} ({smi})")
    return {"serving": s, "launches": launches["paged_decode_attention"],
            "steps": steps, "engine_ttft_s": detail["engine_ttft_s"]}


def check_bench_paged(dev, smi: str) -> dict:
    """The paged kernel against its plain version at the bench engine's
    shapes: 32 slots of ``bench_400m`` (8 query / 4 KV heads, D 128), block
    32, a 32-block table (max_seq 1024, 8 chunks of 128 rows), bf16, at
    lengths from 32 to 320 that sit on and beside every chunk edge those
    lengths reach. A version that drops the last 32-row tile of the slots
    longer than 128 must read above the tolerance."""
    import torch
    from ray_tpu_torch.models import LlamaConfig
    from ray_tpu_torch.ops import paged_attention as paged
    cfg = LlamaConfig.bench_400m(max_seq_len=1024)
    B, H, Hkv, D, bs = 32, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 32
    maxb = 1024 // bs
    NB = B * maxb + 1                          # + the engine's scratch block
    dt, scale = torch.bfloat16, D ** -0.5
    gen = torch.Generator(device=dev).manual_seed(14)
    edges = [32, 33, 63, 64, 65, 96, 127, 128, 129, 160, 191, 192, 193,
             224, 255, 256, 257, 288, 319, 320]
    rng = np.random.default_rng(14)
    lengths = np.array(edges + list(rng.integers(32, 321, B - len(edges))),
                       dtype=np.int32)
    lens = torch.from_numpy(lengths).to(dev)
    short = torch.from_numpy(lengths - ((lengths - 1) % bs + 1)).to(dev)
    long_slots = torch.from_numpy(np.flatnonzero(lengths > 128)).to(dev)

    def rand(shape):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    q, kp, vp = rand((B, H, D)), rand((NB, bs, Hkv, D)), \
        rand((NB, bs, Hkv, D))
    tables = torch.randperm(NB - 1, generator=gen, device=dev) \
        .view(B, maxb).int()
    out = paged.paged_decode_attention_kernel(q, kp, vp, tables, lens)
    plain = paged._paged_decode_plain(q, kp, vp, tables, lens, scale=scale)
    torch.testing.assert_close(out.float(), plain.float(), **BF16_TOL)
    wrong = paged._paged_decode_plain(q, kp, vp, tables, short, scale=scale)
    row = {"max_abs_err": (out.float() - plain.float()).abs().max().item(),
           "tol_ratio": tol_ratio(out, plain),
           "skip_ratio": tol_ratio(wrong[long_slots], plain[long_slots])}
    log(f"paged kernel at the bench's shapes (bf16 B={B} H={H} Hkv={Hkv} "
        f"D={D} block {bs}, lengths {lengths.min()}-{lengths.max()} across "
        f"the 128-row chunk edges): max_abs_err {row['max_abs_err']:.3e}, "
        f"{row['tol_ratio']:.2f}x the tolerance {BF16_TOL}; a version that "
        f"skips the last tile of the slots longer than 128 reads "
        f"{row['skip_ratio']:.2f}x it ({smi})")
    if row["skip_ratio"] <= 1:
        raise RuntimeError("paged kernel at the bench's shapes: the bf16 "
                           "tolerance does not tell a skipped last tile "
                           "from the kernel")
    return row


def serving_bench_path(dev, smi=None) -> dict:
    """Phase 14: ``ray_tpu_torch.llm.bench`` on a fresh ``init()``, the
    paged kernel first held to its plain version at the bench's shapes,
    then every counter at 0 before each run: (a) ``run_serving_bench()``
    streaming through the handle, (b) the same load unary (the router's
    waiter path), (c) ``run_http_proxy_bench()``; then the card's allocated
    bytes are back within 256 MiB of the base. Alone: ``python -c "import
    chip_smoke, torch; chip_smoke.serving_bench_path(torch.device('cuda'))"``.
    ``python -m ray_tpu_torch.profile_serving`` compares the streams with
    the same load straight into an ``LLMServer``."""
    import torch
    import ray_tpu_torch as rt
    from ray_tpu_torch.llm.bench import run_http_proxy_bench, \
        run_serving_bench
    from ray_tpu_torch.models import LlamaConfig
    t0 = time.perf_counter()
    smi = smi or card_name()
    kernel_check = check_bench_paged(dev, smi)
    if rt.is_initialized() or engine_threads():
        raise RuntimeError("a runtime or an engine thread is still up")
    free_card()
    torch._C._cuda_clearCublasWorkspaces()
    base = torch.cuda.memory_allocated()
    rt.init()
    try:
        rows = {}
        for key, stream in (("stream", True), ("unary", False)):
            for c in kernel_counters():
                c.launches = 0
            out = run_serving_bench(dev, stream=stream)
            if out["device"] != smi:
                raise RuntimeError(f"the bench names {out['device']!r}")
            rows[key] = bench_row(
                f"open-loop bench ({'streams' if stream else 'unary'}, "
                f"bench_400m, 6 requests/s for 16 s, 64 clients)", out, smi)
        a, b = rows["stream"]["serving"], rows["unary"]["serving"]
        log(f"unary beside streams: {b['requests_per_second']} / "
            f"{a['requests_per_second']} requests/s, ttft p99 "
            f"{b['ttft_p99_s']} / {a['ttft_p99_s']} s, e2e p99 "
            f"{b['e2e_p99_s']} / {a['e2e_p99_s']} s, goodput "
            f"{b['goodput_requests_per_second']} / "
            f"{a['goodput_requests_per_second']} requests/s ({smi})")
        for c in kernel_counters():
            c.launches = 0
        http = run_http_proxy_bench(dev)
        launches = read_launches()
        d = http["detail"]
        steps = sum(st["decode_steps"] for st in d["engine_stats"])
        if d["streams_done"] != d["requests"] or d["requests"] != 64 \
                or d["output_tokens"] != 64 * 64:
            raise RuntimeError(f"HTTP bench: {d}")
        n_layers = LlamaConfig.bench_400m().n_layers
        check_paged_only("HTTP bench", launches, steps, n_layers)
        log(f"HTTP bench (64 requests, 16 at a time, 64 tokens, SSE): "
            f"every stream ended in [DONE]; {http['value']} tokens/s, ttft "
            f"p50 / p90 / p99 {d['ttft_p50_ms']} / {d['ttft_p90_ms']} / "
            f"{d['ttft_p99_ms']} ms, wall {d['wall_s']} s; launches "
            f"{launches} ({steps} decode steps x {n_layers} layers) ({smi})")
        rows["http"] = {"launches": launches["paged_decode_attention"],
                        "tokens_per_s": http["value"], "detail": d}
        freed, workspaces = wait_freed(base, "serve.shutdown of the bench")
        log(f"after the bench's serve.shutdown: no engine thread left, "
            f"{freed} bytes allocated ({base} before; {workspaces} bytes of "
            f"cuBLAS workspaces cleared) ({smi})")
    finally:
        rt.shutdown()
    rows["launches"] = sum(rows[k]["launches"]
                           for k in ("stream", "unary", "http"))
    rows["kernel_check"] = kernel_check
    log(f"phase 14 (open-loop bench) in {time.perf_counter() - t0:.1f} s; "
        f"paged launches {rows['launches']} ({smi})")
    return rows


# ---------------------------------------------------------------------------
# phase 15: the train driver
# ---------------------------------------------------------------------------

def bench_step(dev, lr=None) -> tuple:
    """bench_400m's train step on ``dev`` through ``make_train_step``
    (AdamW at ``lr``; None: the default, 3e-4) and phase 5's batch (8 x
    2048, seed 0)."""
    import torch
    from ray_tpu_torch import train
    from ray_tpu_torch.models import LlamaConfig, LlamaModel
    cfg = LlamaConfig.bench_400m()
    optimizer = None
    if lr is not None:
        def optimizer(leaves):
            return torch.optim.AdamW(leaves, lr=lr, betas=(0.9, 0.999),
                                     eps=1e-8, weight_decay=0.1)
    ts = train.make_train_step(LlamaModel(cfg, device=dev),
                               optimizer=optimizer)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (8, 2048)).astype(np.int64)
    return ts, train.shard_batch((tokens, np.roll(tokens, -1, axis=1)), ts)


def bench_train_loop(config: dict) -> None:
    """One rank of phases 15 and 16(b): ``bench_step`` at ``config["lr"]``
    on the card, ``config["steps"]`` AdamW steps, each reported with its
    loss, its time and its wall-clock window; rank 0 checkpoints params and
    AdamW state after step ``ckpt_at`` and raises once before step
    ``fail_at`` (the marker file says it did); a restarted group resumes
    from the checkpoint."""
    import os
    import torch
    from ray_tpu_torch import train
    loop_t0 = time.time()
    dev = torch.device(config["device"])
    ts, batch = bench_step(dev, config.get("lr"))
    prev, start, restore_s = train.get_checkpoint(), 0, None
    if prev is None:
        params, opt = ts.init_fn(0)
    else:
        t0 = time.perf_counter()
        state = prev.to_pytree(device=dev)
        params = state["params"]
        opt = ts.opt_init(params)
        opt.load_state_dict(state["opt"])
        start = state["step"] + 1
        del state
        torch.cuda.synchronize(dev)
        restore_s = time.perf_counter() - t0
    rank0 = train.get_context().get_world_rank() == 0
    for step in range(start, config["steps"]):
        if step == config.get("fail_at") and \
                not os.path.exists(config["marker"]):
            open(config["marker"], "w").close()
            raise RuntimeError(f"injected failure before step {step}")
        t0, wall0 = time.perf_counter(), time.time()
        params, opt, m = ts.step_fn(params, opt, batch)
        metrics = {"step": step, "loss": m["loss"].item(),
                   "step_s": time.perf_counter() - t0, "lr": config.get("lr"),
                   "window": (wall0, time.time()), "loop_t0": loop_t0}
        if restore_s is not None:
            metrics["restore_s"], restore_s = restore_s, None
        ck = None
        if rank0 and step == config.get("ckpt_at"):
            t0 = time.perf_counter()
            ck = train.Checkpoint.from_pytree(
                {"params": params, "opt": opt.state_dict(), "step": step},
                os.path.join(config["dir"], f"step{step}"))
            metrics["write_s"] = time.perf_counter() - t0
        train.report(metrics, checkpoint=ck)


def actor_threads(class_names):
    """A function listing the live executor threads of the runtime's
    actors of these classes (their ids are read now, while the runtime is
    up)."""
    from ray_tpu_torch._private import worker
    rt = worker.global_runtime()
    ids = {aid.hex()[:8] for aid, info in rt.gcs.actors.items()
           if info.class_name in class_names}
    return lambda: [t for t in threading.enumerate() if t.is_alive()
                    and t.name.startswith("actor-") and t.name[6:14] in ids]


def train_driver_path(dev, phase5=None, smi=None) -> dict:
    """Phase 15: ``JaxTrainer`` on a fresh ``init()``, the flash counter at 0
    before each run: (a) one worker, ``ScalingConfig(use_gpu=True)``, 6
    steps of ``bench_train_loop``; a ``num_gpus=1`` task submitted at the
    first report stays pending until the group's bundle is gone; the first
    loss held to phase 5's; (b) the same with ``FailureConfig(max_failures=
    1)``: a checkpoint after step 3, a failure before step 4, the group
    re-formed from the checkpoint, steps 4-5 held to (a)'s; (c) no train
    worker thread left and the card's bytes back within 256 MiB of the
    base. Alone (it first runs phase 5 for its loss and step time):
    ``python -c "import chip_smoke, torch;
    chip_smoke.train_driver_path(torch.device('cuda'))"``."""
    import os
    import shutil
    import tempfile
    import torch
    import ray_tpu_torch as rt
    from ray_tpu_torch import train
    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.train.callbacks import Callback
    from ray_tpu_torch.models import LlamaConfig
    t0 = time.perf_counter()
    smi = smi or card_name()
    n_layers = LlamaConfig.bench_400m().n_layers
    if phase5 is None:
        phase5 = train_path(dev, n_layers)
        free_card()
    if rt.is_initialized():
        raise RuntimeError("a runtime is still up")
    free_card()
    torch._C._cuda_clearCublasWorkspaces()
    base = torch.cuda.memory_allocated()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    rt.init()
    try:
        if rt.available_resources().get("GPU") != 1.0:
            raise RuntimeError(f"init() found {rt.cluster_resources()}")

        @rt.remote(num_gpus=1)
        def on_card():
            return "ran"

        class CardHeld(Callback):
            """At the first report, submit a ``num_gpus=1`` task; at every
            report, note whether it has run."""

            def __init__(self):
                self.ref, self.ran_during_fit = None, []

            def on_report(self, metrics, iteration, rank=0, trial_id=""):
                if self.ref is None:
                    self.ref = on_card.remote()
                ready, _ = rt.wait([self.ref], timeout=0)
                self.ran_during_fit.append(bool(ready))

        runs = {}
        for key, extra in (("a", {}), ("b", {"ckpt_at": 3, "fail_at": 4})):
            attn.flash_attention_kernel.launches = 0
            held = CardHeld()
            config = {"device": str(dev), "steps": 6,
                      "marker": os.path.join(tmp, f"failed_{key}"),
                      "dir": os.path.join(tmp, f"ckpt_{key}"), **extra}
            t1 = time.perf_counter()
            result = train.JaxTrainer(
                bench_train_loop, train_loop_config=config,
                scaling_config=train.ScalingConfig(use_gpu=True),
                run_config=train.RunConfig(
                    name=f"phase15{key}", storage_path=tmp,
                    callbacks=[held] if key == "a" else [],
                    failure_config=train.FailureConfig(
                        max_failures=1 if extra else 0))).fit()
            fit_s = time.perf_counter() - t1
            launches = attn.flash_attention_kernel.launches
            if result.error is not None:
                raise RuntimeError(f"phase 15({key}): {result.error}")
            hist = [e["metrics"] for e in result.metrics_history]
            if [m["step"] for m in hist] != list(range(6)):
                raise RuntimeError(f"phase 15({key}) steps: {hist}")
            if launches != 2 * n_layers * 6:
                raise RuntimeError(f"phase 15({key}): flash launches "
                                   f"{launches} != 2 x {n_layers} x 6")
            runs[key] = {"losses": [m["loss"] for m in hist],
                         "step_s": [m["step_s"] for m in hist],
                         "launches": launches, "fit_s": fit_s, "hist": hist}
            if key == "a":
                if not held.ran_during_fit or any(held.ran_during_fit):
                    raise RuntimeError(f"a num_gpus=1 task ran while the "
                                       f"group held the card: "
                                       f"{held.ran_during_fit}")
                if rt.get(held.ref, timeout=60) != "ran":
                    raise RuntimeError("the num_gpus=1 task did not run")
                runs[key]["pending_reports"] = len(held.ran_during_fit)
        a, b = runs["a"], runs["b"]
        torch.testing.assert_close(torch.tensor(a["losses"][0]),
                                   torch.tensor(phase5["loss_first"]),
                                   **LOSS_TOL)
        torch.testing.assert_close(torch.tensor(b["losses"][4:]),
                                   torch.tensor(a["losses"][4:]), **LOSS_TOL)
        write_s = next(m["write_s"] for m in b["hist"] if "write_s" in m)
        restore_s = next(m["restore_s"] for m in b["hist"]
                         if "restore_s" in m)
        ck_bytes = sum(os.path.getsize(os.path.join(dp, f))
                       for dp, _, fs in os.walk(
                           os.path.join(tmp, "ckpt_b")) for f in fs)
        step_ms = float(np.median(a["step_s"][1:])) * 1e3
        log(f"JaxTrainer, one worker in a placement group holding the card "
            f"(ScalingConfig(use_gpu=True)), bench_400m 8 x 2048, 6 AdamW "
            f"steps: losses {a['losses']}; first loss against phase 5's "
            f"{phase5['loss_first']:.6f} (rtol 1e-3 atol 1e-4); step "
            f"median {step_ms:.2f} ms (steps 1-5, host clock around each "
            f"step and its loss's .item()) beside phase 5's "
            f"{phase5['step_ms']:.2f} ms; a num_gpus=1 task stayed pending "
            f"through {a['pending_reports']} reports and ran once the "
            f"group was gone; fit {a['fit_s']:.1f} s; flash launches "
            f"{a['launches']} ({smi})")
        log(f"with FailureConfig(max_failures=1): checkpoint of params and "
            f"AdamW state after step 3, {ck_bytes / 1e9:.2f} GB, written "
            f"in {write_s:.2f} s (device to host and np.savez); failure "
            f"before step 4; the group re-formed and restored it in "
            f"{restore_s:.2f} s (np.load and host to device); losses "
            f"{b['losses']}, steps 4-5 against the uninterrupted run's "
            f"(rtol 1e-3 atol 1e-4); fit {b['fit_s']:.1f} s; flash "
            f"launches {b['launches']} ({smi})")
        freed, workspaces = wait_freed(
            base, "after fit()", threads=actor_threads({"_TrainWorker"}))
        log(f"after fit(): no train worker thread left, {freed} bytes "
            f"allocated ({base} before; {workspaces} bytes of cuBLAS "
            f"workspaces cleared) ({smi})")
    finally:
        rt.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    out = {"launches": a["launches"] + b["launches"], "step_ms": step_ms,
           "write_s": write_s, "restore_s": restore_s,
           "ck_bytes": ck_bytes, "runs": runs}
    log(f"phase 15 (train driver) in {time.perf_counter() - t0:.1f} s; "
        f"flash launches {out['launches']} ({smi})")
    return out


# ---------------------------------------------------------------------------
# phase 16: tune and the utilities
# ---------------------------------------------------------------------------

def tune_trainable(config: dict, device: str) -> None:
    """One trial of phase 16(a): the card's allocated bytes before the model
    is built, then ``bench_step`` at the trial's lr for up to 6 steps, each
    reported with its loss, its time and the card's peak bytes since the
    trial began (one trial runs at a time)."""
    import torch
    from ray_tpu_torch import tune
    dev = torch.device(device)
    start_bytes = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ts, batch = bench_step(dev, config["lr"])
    params, opt = ts.init_fn(0)
    for i in range(6):
        t0 = time.perf_counter()
        params, opt, m = ts.step_fn(params, opt, batch)
        metrics = {"training_iteration": i + 1, "loss": m["loss"].item(),
                   "step_s": time.perf_counter() - t0,
                   "peak": torch.cuda.max_memory_allocated(dev)}
        if i == 0:
            metrics["start_bytes"] = start_bytes
        tune.report(metrics)


def tune_asha(dev, phase5: dict, base: int, n_layers: int, smi: str):
    """Phase 16(a): ASHA over three lrs of bench_400m, one trial at a
    time."""
    from ray_tpu_torch import tune
    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.tune import AsyncHyperBandScheduler

    class Recording(AsyncHyperBandScheduler):
        """ASHA noting each result it was fed and its decision."""

        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            self.fed = []

        def on_result(self, trial, result):
            decision = super().on_result(trial, result)
            self.fed.append((trial.config["lr"], dict(result), decision))
            return decision

    asha = dict(grace_period=2, reduction_factor=2, max_t=6)
    sched = Recording(**asha)
    attn.flash_attention_kernel.launches = 0
    t0 = time.perf_counter()
    grid = tune.Tuner(
        tune.with_parameters(tune_trainable, device=str(dev)),
        param_space={"lr": tune.grid_search([1e-3, 0.0, 3e-4])},
        tune_config=tune.TuneConfig(metric="loss", mode="min",
                                    max_concurrent_trials=1,
                                    scheduler=sched)).fit()
    fit_s = time.perf_counter() - t0
    launches = attn.flash_attention_kernel.launches
    if grid.errors:
        raise RuntimeError(f"phase 16(a) trials failed: {grid.errors}")
    trials = {t.config["lr"]: t for t in grid.trials}
    first = phase5["loss_first"]
    for lr, t in trials.items():
        torch_close(t.results[0]["loss"], first)
        if t.results[0]["start_bytes"] - base > 256 << 20:
            raise RuntimeError(f"trial lr {lr} started with "
                               f"{t.results[0]['start_bytes']} bytes, "
                               f"{base} at the phase's start")
    zero, best = trials[0.0], trials[1e-3]
    stops = [(lr, r["training_iteration"]) for lr, r, d in sched.fed
             if d == "STOP"]
    # stopped at the rung: the one report after it is the one that raised
    if zero.status != "STOPPED" or \
            min(t for lr, t in stops if lr == 0.0) != 2 or \
            len(zero.results) > 3:
        raise RuntimeError(f"the lr 0.0 trial was not stopped at its rung: "
                           f"{zero.status}, stops {stops}, "
                           f"{len(zero.results)} reports")
    torch_close(zero.results[1]["loss"], first)
    if not best.results[1]["loss"] < zero.results[1]["loss"]:
        raise RuntimeError(f"rung 2: lr 0.0 {zero.results[1]['loss']}, "
                           f"lr 1e-3 {best.results[1]['loss']}")
    if grid.get_best_result().config["lr"] != 1e-3:
        raise RuntimeError(f"best {grid.get_best_result().config}")
    replay = AsyncHyperBandScheduler(**asha)
    again = [replay.on_result(None, r) for _, r, _ in sched.fed]
    if again != [d for _, _, d in sched.fed]:
        raise RuntimeError(f"decisions {sched.fed} replay as {again}")
    steps = sum(len(t.results) for t in grid.trials)
    if launches != 2 * n_layers * steps:
        raise RuntimeError(f"phase 16(a): flash launches {launches} != "
                           f"2 x {n_layers} x {steps} reported steps")
    step_s = [r["step_s"] for t in grid.trials for r in t.results[1:]]
    out = {"part": "16a", "trials": [
        {"lr": lr, "status": t.status,
         "iterations": [r["training_iteration"] for r in t.results],
         "losses": [r["loss"] for r in t.results],
         "start_bytes": t.results[0]["start_bytes"],
         "peak_bytes": max(r["peak"] for r in t.results)}
        for lr, t in trials.items()],
        "stops": stops, "best_lr": 1e-3, "phase5_loss_first": first,
        "step_ms_median": float(np.median(step_s)) * 1e3,
        "phase5_step_ms": phase5["step_ms"], "base_bytes": base,
        "flash_launches": launches, "reported_steps": steps,
        "fit_s": fit_s, "card": smi}
    log(json.dumps(out))
    return out


def torch_close(a: float, b: float) -> None:
    import torch
    torch.testing.assert_close(torch.tensor(a), torch.tensor(b), **LOSS_TOL)


def tune_trainer(dev, phase5: dict, asha: dict, tmp: str, n_layers: int,
                 smi: str) -> dict:
    """Phase 16(b): Train-on-Tune, two trials of a one-worker JaxTrainer
    holding the card, both trial actors started at once."""
    import torch
    from ray_tpu_torch import train, tune
    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.train.callbacks import Callback

    class Reports(Callback):
        """Every worker report of both trials (they share the trainer's
        run config)."""

        def __init__(self):
            self.seen = []

        def on_report(self, metrics, iteration, rank=0, trial_id=""):
            self.seen.append(dict(metrics))

    reports = Reports()
    attn.flash_attention_kernel.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    wall0, t0 = time.time(), time.perf_counter()
    grid = tune.Tuner(
        train.JaxTrainer(
            bench_train_loop,
            train_loop_config={"device": str(dev), "steps": 3},
            scaling_config=train.ScalingConfig(use_gpu=True),
            run_config=train.RunConfig(name="phase16b", storage_path=tmp,
                                       callbacks=[reports])),
        param_space={"train_loop_config": {
            "lr": tune.grid_search([1e-3, 3e-4])}},
        tune_config=tune.TuneConfig(max_concurrent_trials=2)).fit()
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    launches = attn.flash_attention_kernel.launches
    if grid.errors or [t.status for t in grid.trials] != ["TERMINATED"] * 2:
        raise RuntimeError(f"phase 16(b): {[t.status for t in grid.trials]}"
                           f" {grid.errors}")
    windows, waits, losses = [], {}, {}
    for t in grid.trials:
        lr = t.config["lr"]
        mine = [m for m in reports.seen if m["lr"] == lr]
        if [m["step"] for m in mine] != [0, 1, 2] or \
                t.last_result["step"] != 2 or \
                t.last_result["loss"] != mine[-1]["loss"]:
            raise RuntimeError(f"phase 16(b) lr {lr}: reports {mine}, "
                               f"result {t.last_result}")
        torch_close(mine[0]["loss"], phase5["loss_first"])
        windows.append((mine[0]["window"][0], mine[-1]["window"][1]))
        waits[lr] = mine[0]["loop_t0"] - wall0
        losses[lr] = [m["loss"] for m in mine]
    (a0, a1), (b0, b1) = sorted(windows)
    if not a1 <= b0:
        raise RuntimeError(f"phase 16(b): the trials' step windows overlap "
                           f"({windows}): two groups held the card at once")
    if launches != 2 * 3 * 2 * n_layers:
        raise RuntimeError(f"phase 16(b): flash launches {launches} != "
                           f"2 x 3 x 2 x {n_layers}")
    one = max(tr["peak_bytes"] for tr in asha["trials"])
    if peak > 1.25 * one:
        raise RuntimeError(f"phase 16(b) peak {peak} bytes, one trial's "
                           f"peak in (a) {one}")
    out = {"part": "16b", "trials": [
        {"lr": t.config["lr"], "status": t.status,
         "metrics_step": t.last_result["step"],
         "losses": losses[t.config["lr"]]} for t in grid.trials],
        "loop_start_after_fit_start_s": waits,
        "gap_between_step_windows_s": b0 - a1, "peak_bytes": peak,
        "one_trial_peak_bytes_16a": one, "flash_launches": launches,
        "fit_s": fit_s, "card": smi}
    log(json.dumps(out))
    return out


def tune_utilities(dev, smi: str) -> dict:
    """Phase 16(c): ``util.collective`` between two ``num_gpus=0.5`` actors
    on 64 MiB bf16 CUDA tensors, ``ActorPool`` and ``Queue`` on the card."""
    import torch
    import ray_tpu_torch as rt
    from ray_tpu_torch.util import ActorPool, Queue
    from ray_tpu_torch.util import collective as col

    @rt.remote(num_gpus=0.5)
    class Rank:
        def __init__(self, rank: int, device: str):
            col.init_collective_group(2, rank, group_name="g")
            self.rank, self.dev = rank, torch.device(device)
            g = torch.Generator(device=self.dev).manual_seed(rank)
            self.part = torch.randn(32 << 20, generator=g, device=self.dev,
                                    dtype=torch.bfloat16)

        def get_part(self):
            return self.part

        def allreduce(self):
            out = col.allreduce(self.part, group_name="g")
            torch.cuda.synchronize(self.dev)
            return out

        def ops(self):
            gathered = col.allgather(self.part, group_name="g")
            bc = col.broadcast(self.part, src_rank=1, group_name="g")
            chunk = col.reducescatter(self.part, group_name="g")
            if self.rank == 0:
                col.send(self.part, 1, group_name="g")
                got = None
            else:
                got = col.recv(0, group_name="g")
            col.barrier(group_name="g")
            return gathered, bc, chunk, got

        def echo(self, x):
            return x

        def destroy(self):
            col.destroy_collective_group("g")

    ranks = [Rank.remote(r, str(dev)) for r in range(2)]
    parts = rt.get([r.get_part.remote() for r in ranks])
    want = parts[0] + parts[1]
    t0 = time.perf_counter()
    outs = rt.get([r.allreduce.remote() for r in ranks])
    allreduce_ms = (time.perf_counter() - t0) * 1e3
    for o in outs:
        if not (o.is_cuda and o.dtype == torch.bfloat16
                and torch.equal(o, want)):
            raise RuntimeError(f"allreduce gave {o.device} {o.dtype}, "
                               f"equal {torch.equal(o.cpu(), want.cpu())}")
    one_result = outs[0].data_ptr() == outs[1].data_ptr()
    chunks = torch.tensor_split(want, 2)
    for rank, (gathered, bc, chunk, got) in enumerate(
            rt.get([r.ops.remote() for r in ranks])):
        if [g.data_ptr() for g in gathered] != \
                [p.data_ptr() for p in parts] or \
                bc.data_ptr() != parts[1].data_ptr():
            raise RuntimeError("allgather or broadcast copied a part")
        if not (chunk.is_cuda and chunk.dtype == torch.bfloat16
                and torch.equal(chunk, chunks[rank])):
            raise RuntimeError(f"reducescatter's chunk {rank} is wrong")
        if rank == 1 and got.data_ptr() != parts[0].data_ptr():
            raise RuntimeError("recv did not get rank 0's tensor")
    rt.get([r.destroy.remote() for r in ranks])
    x = torch.arange(1 << 20, device=dev, dtype=torch.float32)
    pool = ActorPool(ranks)
    pooled = list(pool.map(lambda a, v: a.echo.remote(v), [x, x]))
    q = Queue()
    q.put(x)
    queued = q.get()
    q.shutdown()
    if any(p.data_ptr() != x.data_ptr() for p in pooled) or \
            queued.data_ptr() != x.data_ptr():
        raise RuntimeError("ActorPool or Queue copied the tensor")
    for r in ranks:
        rt.kill(r)
    out = {"part": "16c", "allreduce_bytes": want.numel() * 2,
           "allreduce_ms_host": allreduce_ms,
           "ranks_share_one_result": one_result,
           "checked": ["allreduce", "allgather", "broadcast",
                       "reducescatter", "send/recv", "ActorPool.map",
                       "Queue"], "card": smi}
    log(json.dumps(out))
    return out


def tune_path(dev, phase5=None, smi=None) -> dict:
    """Phase 16: tune and the utilities on a fresh ``init()`` (see the
    module's docstring). Alone (it first runs phase 5 for its loss and step
    time): ``python -c "import chip_smoke, torch;
    chip_smoke.tune_path(torch.device('cuda'))"``."""
    import shutil
    import tempfile
    import torch
    import ray_tpu_torch as rt
    from ray_tpu_torch.models import LlamaConfig
    t0 = time.perf_counter()
    smi = smi or card_name()
    n_layers = LlamaConfig.bench_400m().n_layers
    if phase5 is None:
        phase5 = train_path(dev, n_layers)
    if rt.is_initialized():
        raise RuntimeError("a runtime is still up")
    free_card()
    torch._C._cuda_clearCublasWorkspaces()
    base = torch.cuda.memory_allocated()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    rt.init()
    try:
        if rt.available_resources().get("GPU") != 1.0:
            raise RuntimeError(f"init() found {rt.cluster_resources()}")
        asha = tune_asha(dev, phase5, base, n_layers, smi)
        trainer = tune_trainer(dev, phase5, asha, tmp, n_layers, smi)
        util = tune_utilities(dev, smi)
        threads = actor_threads({"_TrialActor", "_TrainWorker",
                                 "_QueueActor", "_Coordinator", "Rank"})
    finally:
        rt.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    freed, workspaces = wait_freed(base, "after shutdown()", threads=threads)
    out = {"part": "16", "launches": asha["flash_launches"]
           + trainer["flash_launches"], "bytes_after_shutdown": freed,
           "base_bytes": base, "cublas_workspaces_cleared": workspaces,
           "seconds": time.perf_counter() - t0, "card": smi}
    log(json.dumps(out))
    out.update(asha=asha, trainer=trainer, util=util)
    return out


# ---------------------------------------------------------------------------
# phase 17: the data layer and the device feed
# ---------------------------------------------------------------------------

# ImageNet's per-channel mean and std, on the 0-255 scale
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32) * 255
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32) * 255


def token_dataset(rdata, vocab: int, rows: int = 64, blocks: int = 8):
    """Phase 17(a)'s dataset: ``rows`` x 2048 tokens from seed 0 (its first
    8 rows are ``bench_batch``'s), targets added by ``map_batches``, then
    ``blocks`` blocks in row order."""
    tokens = np.random.default_rng(0).integers(0, vocab, (rows, 2048))
    return rdata.from_numpy(tokens, "tokens").map_batches(
        lambda b: {"tokens": b["tokens"],
                   "targets": np.roll(b["tokens"], -1, axis=1)}
    ).repartition(blocks)


def data_train_loop(config: dict) -> None:
    """One rank of phase 17(a): the train step of ``config["cfg"]``
    (bench_400m on the card) on ``config["device"]``, fed by
    ``get_dataset_shard("train").to_jax(batch_size=8, prefetch=2)``, for
    ``config["steps"]`` AdamW steps, each reported with its loss and time;
    the first batch is held to ``bench_batch``'s rows."""
    import torch
    from ray_tpu_torch import train
    from ray_tpu_torch.models import LlamaModel
    dev = torch.device(config["device"])
    cfg = config["cfg"]
    ts = train.make_train_step(LlamaModel(cfg, device=dev))
    params, opt = ts.init_fn(0)
    want = bench_batch(cfg)
    it = train.get_dataset_shard("train").to_jax(batch_size=8, prefetch=2,
                                                 device=dev)
    try:
        for step, b in enumerate(it):
            if step == config["steps"]:
                break
            batch = (b["tokens"], b["targets"])
            metrics = {"step": step, "device": b["tokens"].device.type}
            if step == 0:
                metrics["first_batch_is_bench_batch"] = all(
                    torch.equal(t.cpu(), torch.from_numpy(w))
                    for t, w in zip(batch, want))
            t0 = time.perf_counter()
            params, opt, m = ts.step_fn(params, opt, batch)
            metrics.update(loss=m["loss"].item(),
                           step_s=time.perf_counter() - t0)
            train.report(metrics)
    finally:
        it.close()


def data_llama(dev, phase5: dict, cfg, tmp: str, smi: str) -> dict:
    """Phase 17(a): ``JaxTrainer(datasets={"train": token_dataset})``, one
    worker holding the card, 6 steps of ``data_train_loop``: the flash
    kernel 2 x layers x 6 times, the first batch phase 5's, its loss phase
    5's to every printed digit, the step median beside phase 5's."""
    from ray_tpu_torch import data as rdata
    from ray_tpu_torch import train
    from ray_tpu_torch.ops import attention as attn
    steps = 6
    attn.flash_attention_kernel.launches = 0
    t0 = time.perf_counter()
    result = train.JaxTrainer(
        data_train_loop,
        train_loop_config={"device": str(dev), "steps": steps, "cfg": cfg},
        scaling_config=train.ScalingConfig(use_gpu=dev.type == "cuda"),
        run_config=train.RunConfig(name="phase17a", storage_path=tmp),
        datasets={"train": token_dataset(rdata, cfg.vocab_size)}).fit()
    fit_s = time.perf_counter() - t0
    launches = attn.flash_attention_kernel.launches
    if result.error is not None:
        raise RuntimeError(f"phase 17(a): {result.error}")
    hist = [e["metrics"] for e in result.metrics_history]
    if [m["step"] for m in hist] != list(range(steps)):
        raise RuntimeError(f"phase 17(a) steps: {hist}")
    if not hist[0]["first_batch_is_bench_batch"]:
        raise RuntimeError("phase 17(a): the first batch is not phase 5's")
    if {m["device"] for m in hist} != {dev.type}:
        raise RuntimeError(f"phase 17(a): batches on {hist}")
    want = 2 * cfg.n_layers * steps if dev.type == "cuda" else 0
    if launches != want:
        raise RuntimeError(f"phase 17(a): flash launches {launches} != "
                           f"{want}")
    losses = [m["loss"] for m in hist]
    if f"{losses[0]:.6f}" != f"{phase5['loss_first']:.6f}":
        raise RuntimeError(f"phase 17(a): first loss {losses[0]!r} is not "
                           f"phase 5's {phase5['loss_first']!r}")
    step_ms = float(np.median([m["step_s"] for m in hist[1:]])) * 1e3
    log(f"phase 17(a): JaxTrainer(datasets=...) over 64 x 2048 tokens in 8 "
        f"blocks (seed 0, targets by map_batches), to_jax(batch_size=8, "
        f"prefetch=2) into bench_400m's step, one worker holding the card, "
        f"{steps} AdamW steps: losses {losses}; first loss "
        f"{losses[0]:.6f} against phase 5's {phase5['loss_first']:.6f}; "
        f"step median {step_ms:.2f} ms (steps 1-5, host clock around each "
        f"step and its loss's .item()) beside phase 5's "
        f"{phase5['step_ms']:.2f} ms; fit {fit_s:.1f} s; flash launches "
        f"{launches} ({smi})")
    return {"losses": losses, "step_ms": step_ms, "fit_s": fit_s,
            "launches": launches}


def image_records(n: int, size: int, seed: int = 0) -> np.ndarray:
    """``n`` records of an HWC uint8 image, a label of 1,000 classes and
    the record's index, from ``seed``."""
    rng = np.random.default_rng(seed)
    rec = np.empty(n, dtype=[("image", np.uint8, (size, size, 3)),
                             ("label", np.int64), ("index", np.int64)])
    rec["image"] = rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
    rec["label"] = rng.integers(0, 1000, n)
    rec["index"] = np.arange(n)
    return rec


class Normalize:
    """The actor pool's preprocessing: records to f32 images normalised by
    ImageNet's mean and std, labels and indices."""

    def __call__(self, batch):
        rec = batch["record"]
        images = rec["image"].astype(np.float32)
        images -= IMAGENET_MEAN
        images /= IMAGENET_STD
        return {"image": images,
                "label": np.ascontiguousarray(rec["label"]),
                "index": np.ascontiguousarray(rec["index"])}


def store_used() -> int:
    from ray_tpu_torch._private import worker
    return sum(node.store.used_bytes()
               for node in worker.global_runtime().alive_nodes())


def pinned_copy_ms(dev, nbytes: int, iters: int = 20) -> float:
    """Device time of one plain ``copy_`` of ``nbytes`` from pinned host
    memory to the card (CUDA events around ``iters`` copies)."""
    import torch
    src = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    for _ in range(3):
        dst.copy_(src, non_blocking=True)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        dst.copy_(src, non_blocking=True)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def busy_share(prof, wall_ms: float) -> tuple:
    """The union of the device's kernel and copy intervals in a profiled
    window over its wall time, and the window's host-to-device copies by
    kind."""
    import torch
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    copies = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                "HtoD" in e.name:
            copies[e.name] = copies.get(e.name, 0) + 1
    return busy / 1e3 / wall_ms, copies


def vit_pass(ts, params, opt, batches, dev, profile_at=None) -> dict:
    """Train steps over ``batches`` (dicts of ``image`` and ``label`` on
    the card): images/s from the second step to the end (one sync at each
    end), the losses, the last batch, and with ``profile_at`` the
    device-busy share and host-to-device copies of 3 steps from there under
    the CUDA profiler."""
    import torch

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    losses, out = [], {"busy": float("nan"), "copies": {},
                       "window_ms": float("nan")}
    for i, b in enumerate(batches):
        if i == 1:
            sync()
            t0 = time.perf_counter()
        if i == profile_at and dev.type == "cuda":
            sync()
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            prof.start()
            w0 = time.perf_counter()
        last = (b["image"], b["label"])
        params, opt, m = ts.step_fn(params, opt, last)
        losses.append(m["loss"])
        if profile_at is not None and i == profile_at + 2 and \
                dev.type == "cuda":
            sync()
            out["window_ms"] = (time.perf_counter() - w0) * 1e3
            prof.stop()
            out["busy"], out["copies"] = busy_share(prof, out["window_ms"])
    sync()
    steps = len(losses)
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"phase 17(b): losses {losses}")
    out.update(steps=steps, losses=losses, last=last,
               images_s=(steps - 1) * last[1].shape[0]
               / (time.perf_counter() - t0))
    return out


def data_stream(dev, tmp: str, smi: str, n: int = 2048, size: int = 224,
                batch: int = 32, vit_cfg=None) -> dict:
    """Phase 17(b): ``n`` records of ``size`` x ``size`` x 3 uint8 images
    written as 16 ``.npy`` shards, read back with ``read_numpy``,
    normalised by an actor pool (``Normalize``) and ``streaming_split(1)``;
    pass 1 streams them to the card alone (images/s, GB/s beside a plain
    pinned copy, the object store's peak), pass 2 into ViT-L/16's train
    step (images/s beside the bare step on a resident batch and beside the
    same steps fed from the normalised blocks held in the store, the
    device-busy share of one profiled window)."""
    import os
    import torch
    from ray_tpu_torch import data as rdata
    from ray_tpu_torch.models import ViTConfig, ViTModel
    from ray_tpu_torch.train import make_train_step
    vit_cfg = vit_cfg or ViTConfig.vit_l16()
    t0 = time.perf_counter()
    rec = image_records(n, size)
    path = os.path.join(tmp, "images")
    rdata.from_numpy(rec, "record").repartition(16).write_numpy(path,
                                                                 "record")
    write_s = time.perf_counter() - t0
    shards = sorted(os.listdir(path))
    if len(shards) != 16:
        raise RuntimeError(f"phase 17(b): {len(shards)} shards written")
    mib = rec.nbytes / 2**20
    del rec
    ds = rdata.read_numpy(path, column="record").map_batches(
        Normalize, concurrency=(2, 4))
    shard = ds.streaming_split(1)[0]
    want = image_records(n, size)    # the expected values, by index

    def expect(index):
        images = want["image"][index].astype(np.float32)
        images -= IMAGENET_MEAN
        images /= IMAGENET_STD
        return images, want["label"][index]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # pass 1: the data alone
    seen, peak, labels = 0, 0, 0
    t0 = time.perf_counter()
    for i, b in enumerate(shard.to_jax(batch_size=batch, prefetch=2,
                                       device=dev)):
        if i == 0:
            images, lab = expect(b["index"].cpu().numpy())
            if not (torch.equal(b["image"].cpu(), torch.from_numpy(images))
                    and torch.equal(b["label"].cpu(),
                                    torch.from_numpy(lab))):
                raise RuntimeError("phase 17(b): a batch on the card is "
                                   "not its records' normalised values")
        seen += b["label"].shape[0]
        labels += int(b["label"].sum())
        peak = max(peak, store_used())
    sync()
    pass1_s = time.perf_counter() - t0
    if seen != n or labels != int(want["label"].sum()):
        raise RuntimeError(f"phase 17(b): {seen} images, label sum "
                           f"{labels} (want {n}, {want['label'].sum()})")
    batch_bytes = batch * (size * size * 3 * 4 + 8 + 8)
    fed_gbs = n / batch * batch_bytes / pass1_s / 1e9
    copy_ms = pinned_copy_ms(dev, batch_bytes) if dev.type == "cuda" \
        else float("nan")
    link_gbs = batch_bytes / copy_ms / 1e6
    log(f"phase 17(b) pass 1: {n} images ({mib:.1f} MiB of uint8 records "
        f"in 16 .npy shards, written in {write_s:.1f} s) read, normalised "
        f"by an actor pool and fed to {dev} in batches of {batch}: "
        f"{n / pass1_s:.1f} images/s, {fed_gbs:.2f} GB/s onto the card "
        f"beside {link_gbs:.2f} GB/s of a plain pinned copy_ of one batch's "
        f"{batch_bytes / 1e6:.2f} MB ({copy_ms:.3f} ms); the object store's "
        f"peak {peak / 2**20:.1f} MiB of its "
        f"{store_capacity() / 2**20:.0f} MiB ({smi})")

    # pass 2: into ViT-L/16's train step; then the same steps on one
    # resident batch, and fed from the normalised blocks held in the store
    model = ViTModel(vit_cfg, device=dev)
    ts = make_train_step(model)
    params, opt = ts.init_fn(0)
    streamed = vit_pass(ts, params, opt, shard.to_jax(
        batch_size=batch, prefetch=2, device=dev), dev,
        profile_at=min(30, n // batch - 4))
    if streamed["steps"] != n // batch:
        raise RuntimeError(f"phase 17(b): {streamed['steps']} steps")
    resident = streamed.pop("last")
    sync()
    t1 = time.perf_counter()
    for _ in range(20):
        ts.step_fn(params, opt, resident)
    sync()
    bare_ms = (time.perf_counter() - t1) / 20 * 1e3
    held = ds.materialize()
    from_store = vit_pass(ts, params, opt, held.streaming_split(1)[0].to_jax(
        batch_size=batch, prefetch=2, device=dev), dev)
    from_store.pop("last")
    del held
    losses = streamed["losses"]
    log(f"phase 17(b) pass 2: the same stream into ViT-L/16's train step "
        f"({streamed['steps']} steps of {batch} images, AdamW, bf16 with "
        f"remat): {streamed['images_s']:.1f} images/s from step 1 (one "
        f"sync at each end), beside {batch / bare_ms * 1e3:.1f} images/s "
        f"of the bare step on one resident batch ({bare_ms:.2f} ms, 20 "
        f"steps back to back) and {from_store['images_s']:.1f} images/s fed "
        f"from the normalised blocks held in the store (no reading or "
        f"normalising beside the steps); loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; device busy {streamed['busy'] * 100:.1f} % of a "
        f"window of 3 streamed steps under the CUDA profiler "
        f"({streamed['window_ms']:.1f} ms); its host-to-device copies "
        f"{streamed['copies']} ({smi})")
    del model, ts, params, opt, resident
    free_card()
    return {"pass1_images_s": n / pass1_s, "fed_gbs": fed_gbs,
            "link_gbs": link_gbs, "store_peak": peak,
            "streamed_images_s": streamed["images_s"],
            "from_store_images_s": from_store["images_s"],
            "bare_step_ms": bare_ms, "busy": streamed["busy"],
            "copies": streamed["copies"]}


def store_capacity() -> int:
    from ray_tpu_torch._private import worker
    return sum(node.store.capacity_bytes
               for node in worker.global_runtime().alive_nodes())


def data_formats(dev, tmp: str) -> dict:
    """Phase 17(c): a TFRecord and an Avro round trip of a small table (the
    stdlib codecs, on the card's machine), ``iter_torch_batches`` onto the
    card, and the feed's own contract: pinned staging, the copy on a side
    stream, the consumer's stream waiting for it."""
    import os
    import torch
    from ray_tpu_torch import data as rdata
    from ray_tpu_torch.data.iterator import _CudaFeed
    rows = [{"name": f"r{i}", "score": i * 0.5, "labels": [i, i * 2]}
            for i in range(12)]
    tfr = os.path.join(tmp, "tfr")
    rdata.from_items(rows).write_tfrecords(tfr)
    back = {r["name"][0]: r for r in rdata.read_tfrecords(tfr).take_all()}
    if set(back) != {f"r{i}".encode() for i in range(12)} or \
            back[b"r3"] != {"name": [b"r3"], "score": [1.5],
                            "labels": [3, 6]}:
        raise RuntimeError(f"phase 17(c): TFRecord round trip gave {back}")
    avro = os.path.join(tmp, "avro")
    flat = [{"name": r["name"], "score": r["score"], "raw": bytes([i])}
            for i, r in enumerate(rows)]
    rdata.from_items(flat).write_avro(avro)
    got = sorted(rdata.read_avro(avro).take_all(), key=lambda r: r["name"])
    if got != sorted(flat, key=lambda r: r["name"]):
        raise RuntimeError(f"phase 17(c): Avro round trip gave {got}")
    batches = list(rdata.range(64, parallelism=4).iter_torch_batches(
        batch_size=16, device=str(dev)))
    if {b["id"].device.type for b in batches} != {dev.type} or \
            sorted(int(x) for b in batches for x in b["id"]) != \
            list(range(64)):
        raise RuntimeError("phase 17(c): iter_torch_batches off the card")
    checked = {}
    if dev.type == "cuda":
        feed = _CudaFeed(dev, 2)
        batch = {"x": np.arange(4096, dtype=np.float32).reshape(64, 64)}
        slot, staged = feed.stage(batch, {})
        out, done = feed.launch(slot, staged, {"x": torch.bfloat16}, None)
        out = feed.hand_over(out, done)
        checked = {"pinned": staged["x"].is_pinned(),
                   "side_stream": feed.stream != torch.cuda.current_stream(),
                   "equal": torch.equal(out["x"], torch.from_numpy(
                       batch["x"]).to(dev, torch.bfloat16))}
        if not all(checked.values()):
            raise RuntimeError(f"phase 17(c): the feed {checked}")
    log(f"phase 17(c): TFRecord and Avro round trips of 12 rows, "
        f"iter_torch_batches onto {dev} ({len(batches)} batches), the "
        f"feed's staging and side-stream copy: {checked}")
    return checked


def data_threads():
    """The data layer's threads still alive: prefetch threads, shuffle
    reapers, and the executors of its map-pool, shuffle and train-worker
    actors."""
    actors = actor_threads({"_MapWorker", "ShuffleAggregator",
                            "_TrainWorker"})
    return lambda: actors() + [
        t for t in threading.enumerate() if t.is_alive() and t.name in (
            "data-prefetch", "shuffle-aggregator-reaper")]


def data_path(dev, phase5=None, smi=None) -> dict:
    """Phase 17: the data layer and the device feed on a fresh ``init()``
    (see the module's docstring). Alone (it first runs phase 5 for its
    loss and step time): ``python -c "import chip_smoke, torch;
    chip_smoke.data_path(torch.device('cuda'))"``."""
    import shutil
    import tempfile
    import torch
    import ray_tpu_torch as rt
    from ray_tpu_torch.models import LlamaConfig
    t0 = time.perf_counter()
    smi = smi or card_name()
    cfg = LlamaConfig.bench_400m()
    if phase5 is None:
        phase5 = train_path(dev, cfg.n_layers)
    if rt.is_initialized():
        raise RuntimeError("a runtime is still up")
    free_card()
    torch._C._cuda_clearCublasWorkspaces()
    base = torch.cuda.memory_allocated()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_data_")
    rt.init()
    try:
        if rt.available_resources().get("GPU") != 1.0:
            raise RuntimeError(f"init() found {rt.cluster_resources()}")
        llama = data_llama(dev, phase5, cfg, tmp, smi)
        free_card()
        stream = data_stream(dev, tmp, smi)
        formats = data_formats(dev, tmp)
        threads = data_threads()
    finally:
        rt.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    freed, workspaces = wait_freed(base, "after shutdown()", threads=threads)
    out = {"part": "17", "launches": llama["launches"],
           "bytes_after_shutdown": freed, "base_bytes": base,
           "cublas_workspaces_cleared": workspaces,
           "seconds": time.perf_counter() - t0, "card": smi}
    log(json.dumps(out))
    out.update(llama=llama, stream=stream, formats=formats)
    return out


def card_name() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from ray_tpu_torch import _build
    from ray_tpu_torch.bench import moe_bench_config
    from ray_tpu_torch.llm import LLMServer
    from ray_tpu_torch.models import LlamaConfig, LlamaModel, MoEModel
    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.ops import decode_attention as dec
    from ray_tpu_torch.ops import paged_attention as paged

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    smi = card_name()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    log(smi)

    # 1. build, one nvcc per source, all at once
    t0 = time.perf_counter()
    names = ("decode_attention", "flash_attention")
    with ThreadPoolExecutor(len(names)) as pool:
        lib_paths = list(pool.map(_build.build, names))
    for name, lib_path in zip(names, lib_paths):
        _build.load_library(name)
        log(f"build: {lib_path.name}")
        for line in lib_path.with_suffix(".log").read_text().splitlines():
            if "Compiling entry" in line or "registers" in line \
                    or "spill" in line:
                log(f"  ptxas: {line.strip()}")
    log(f"built {len(names)} sources in {time.perf_counter() - t0:.1f} s")
    for name, lib_path in zip(names, lib_paths):
        check_sass(name, lib_path)

    # 2. kernels against their plain versions
    rows = check_kernels(dev, gen)
    rows.append(check_flash(dev, gen))

    # 3. the serving path, every counter at 0
    llm_config, mix = serving_config(rng)
    cfg = llm_config.model_config
    t0 = time.perf_counter()
    server = LLMServer(llm_config, device=dev)
    torch.cuda.synchronize()
    log(f"LLMServer(llama3_8b, {cfg.num_params() / 1e9:.2f} B params, "
        f"{server.engine.num_blocks + 1} pool blocks of "
        f"{server.engine.block_size}) up in {time.perf_counter() - t0:.1f} s;"
        f" {torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    try:
        # the lone greedy request that phase 12 repeats through the actor
        lone = server({"prompt": mix["lone"], "max_tokens": 32})
        if len(lone["token_ids"]) != 32:
            raise RuntimeError(f"the lone request gave {lone}")
        steps0 = server.engine.stats["decode_steps"]
        paged.paged_decode_attention_kernel.launches = 0
        dec.ragged_decode_attention_kernel.launches = 0
        attn.flash_attention_kernel.launches = 0
        serving = serve_requests(server, mix)
        server.shutdown()
        dense_decode(server.model, server.engine.params, gen, 32, 1024, rng)
        launches = {"paged_decode_attention":
                    paged.paged_decode_attention_kernel.launches,
                    "ragged_decode_attention":
                    dec.ragged_decode_attention_kernel.launches,
                    "flash_attention": attn.flash_attention_kernel.launches}
    finally:
        server.shutdown()
    stats = server.stats()
    steps = stats["decode_steps"] - steps0
    log(f"served 16 requests: {serving['tokens']} tokens in "
        f"{serving['wall_s']:.2f} s ({serving['tokens'] / serving['wall_s']:.1f}"
        f" tokens/s, {serving['prompt_tokens']} prompt tokens), engine stats "
        f"{stats}")
    log(f"launches on the main path: {launches} ({steps} decode steps x "
        f"{cfg.n_layers} layers; one dense T=1 step x {cfg.n_layers})")
    if stats["prefix_prefills"] < 3 or stats["prefix_tokens_reused"] < 192:
        raise RuntimeError(f"the prefix path did not run: {stats}")
    if steps < 1 or launches["paged_decode_attention"] != \
            cfg.n_layers * steps:
        raise RuntimeError(f"paged kernel launches {launches} != "
                           f"{cfg.n_layers} x {steps} decode steps")
    if launches["ragged_decode_attention"] != cfg.n_layers:
        raise RuntimeError(f"ragged kernel launches {launches} != "
                           f"{cfg.n_layers}")
    if launches["flash_attention"]:
        raise RuntimeError(f"the serving path launched the flash kernel: "
                           f"{launches}")
    for r in rows[:2]:
        r["launches"] = launches[r["name"]]

    # 4. kernel decode against reference decode on a live pool
    live = live_pool_compare(server, rng)
    log(f"decode_step_paged kernel vs reference on a live pool "
        f"({live['active_slots']} slots, {live['live_tokens']} cached "
        f"tokens, max_slots 32): logits max_abs_err "
        f"{live['logits_max_abs_err']:.3e} (atol 0.15 rtol 0.05); decode "
        f"step {live['step_ms']['kernel']:.2f} ms with the kernel, "
        f"{live['step_ms']['reference']:.2f} ms with the reference")
    log_prefix_compare(server, mix["lone"])
    del server, live
    gc.collect()
    torch.cuda.empty_cache()

    # 5. the training path
    train = train_path(dev, LlamaConfig.bench_400m().n_layers)
    rows[2]["launches"] = train["launches"]

    # 6. the flash kernel's loss against the blockwise path
    loss_k, loss_b = kernel_vs_blockwise_loss(dev, LlamaModel,
                                              LlamaConfig.bench_400m(), 8)
    log(f"loss through the flash kernel {loss_k:.6f}, through the blockwise "
        f"path {loss_b:.6f} (rtol 1e-3 atol 1e-4; bench_400m, f32 params, "
        f"bf16 compute, batch 8 x seq 2048)")
    free_card()

    # 7. the other model families train, every counter at 0 before each
    moe_cfg = moe_bench_config()
    runs = train_families(dev, moe_cfg.n_layers)
    rows[2]["launches"] += runs["moe"]["launches"]

    # 8. the MoE's flash path against its blockwise path; GPT-2 and ViT on
    # the card against the CPU
    loss_k, loss_b = kernel_vs_blockwise_loss(dev, MoEModel, moe_cfg, 2)
    log(f"MoE loss through the flash kernel {loss_k:.6f}, through the "
        f"blockwise path {loss_b:.6f} (rtol 1e-3 atol 1e-4; f32 params, "
        f"bf16 compute, batch 2 x seq 2048)")
    free_card()
    for name in ("gpt2", "vit"):
        card, cpu = card_vs_cpu_loss(dev, name)
        log(f"{name} f32 loss on the card {card:.6f}, on the CPU {cpu:.6f} "
            f"(rtol 1e-3; relative difference {abs(card / cpu - 1):.2e})")
        free_card()

    # 9. the mesh path, every counter at 0
    mesh = mesh_path(dev, train, runs["gpt2"],
                     LlamaConfig.bench_400m().n_layers)
    rows[2]["launches"] += mesh["launches"]

    # 10. sequence, expert and pipeline parallelism, every counter at 0
    par = parallel_layouts(dev, gen, train, runs["moe"],
                           LlamaConfig.bench_400m().n_layers)
    rows[2]["launches"] += par["moe"]["launches"] + \
        par["pipeline"]["launches"]

    # 11. the RL learners on the runtime, every counter at 0: no kernel of
    # the port runs
    rl = rl_path(dev)

    # 12. the runtime on the card: resources, the device tier, phase 3's
    # serving through an LLMServer actor (counters at 0), its own cost
    runtime = runtime_path(gen, llm_config, mix, lone["token_ids"], serving,
                           rl, smi)
    rows[0]["launches"] += runtime["serving"]["launches"][rows[0]["name"]]

    # 13. serve on the card: the LLM app through a handle and over HTTP,
    # freed on delete, the prefill/decode graph, the data plane's cost
    served = serve_path(dev, llm_config, mix, lone["token_ids"], serving,
                        runtime, smi)
    rows[0]["launches"] += served["launches"]

    # 14. the open-loop serving bench, every counter at 0 before each run
    bench = serving_bench_path(dev, smi)
    rows[0]["launches"] += bench["launches"]

    # 15. the train driver: JaxTrainer in a placement group holding the
    # card, the flash counter at 0 before each run
    driver = train_driver_path(dev, train, smi)
    rows[2]["launches"] += driver["launches"]

    # 16. tune and the utilities: Tune trials and Train-on-Tune on the
    # card, the flash counter at 0 before each part; util.collective,
    # ActorPool and Queue on CUDA tensors
    tuned = tune_path(dev, train, smi)
    rows[2]["launches"] += tuned["launches"]

    # 17. the data layer and the device feed: datasets on the runtime,
    # streamed through the pinned-memory prefetcher into bench_400m's step
    # (the flash counter at 0) and ViT-L/16
    fed = data_path(dev, train, smi)
    rows[2]["launches"] += fed["launches"]

    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    log(smi)
    log(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
