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
3. Serving path, every launch counter at 0: ``LLMServer`` on the card with
   Llama-3-8B's widths (random weights from seed 0) answers 16 requests
   through ``__call__`` and ``stream`` (prompts of 32-256 tokens, four
   sharing a 64-token prefix, 32 new tokens each), then one
   ``forward_step`` with T=1 on a dense cache. The paged kernel must have
   run once per layer per decode step, the ragged kernel once per layer.
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
11. The RL learners (``ray_tpu_torch.rl``), every kernel counter at 0
   before and read after (they launch none of the port's kernels), in
   this process: ``LocalAlgorithm`` does what the JAX package's
   ``Algorithm.train`` does with two host ``EnvRunner``s on CartPole and
   the learner on the card (sample, update, send the weights back; IMPALA
   and APPO one fragment an update, the weights to the runner that
   delivered it). (a) Each learner at the CPU tests' configurations
   (``RL_CASES``) takes one update on the card and on the CPU from the
   same state (``load_learner_state``), held to the tests' bars; (b) the
   JAX tests' learning bars on the card (PPO, IMPALA, SAC, DQN, BC and
   CQL from logged batches); (c) the tuned CartPole contracts
   (``TUNED``, the repo's full-width RL configurations), reported and not
   gated: best return and iterations, update ms on the card and on this
   machine's CPU (median of 5), gradient steps a second, and one profiled
   update's launches a step and device-busy share; (d) ``LearnerGroup`` on
   the one-rank NCCL mesh, PPO's and IMPALA's update against the plain
   learner's at rtol 1e-6.

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

def serve_requests(server, vocab: int, rng) -> dict:
    """16 requests through ``__call__`` and ``stream``; four share a
    64-token prefix and arrive once the first of them has its first token
    (its prompt blocks are sealed at admission), so the prefix path runs."""
    prefix = [int(t) for t in rng.integers(0, vocab, 64)]
    plain_lens = rng.integers(32, 257, 12)
    prompts = [[int(t) for t in rng.integers(0, vocab, n)]
               for n in plain_lens]
    sharers = [prefix + [int(t) for t in rng.integers(0, vocab, n)]
               for n in (20, 60, 120, 192)]
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
            "prompt_tokens": int(plain_lens.sum()) + sum(map(len, sharers))}


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

# ray_tpu/rl/tuned_examples.py:29-58 and :105-121: the repo's full-width RL
# configurations, each with its target return within 40 iterations
TUNED = {
    "PPO": (dict(runners=2, fragment=512, lr=3e-4, epochs=6,
                 minibatch_size=128, ent_coef=0.01), 200.0),
    "DQN": (dict(runners=2, fragment=256), 80.0),
    "IMPALA": (dict(runners=2, fragment=256), 100.0),
    "APPO": (dict(runners=2, fragment=256), 100.0),
    "SAC": (dict(runners=2, fragment=256), 40.0),
}


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


class LocalAlgorithm:
    """What ``ray_tpu.rl.Algorithm.train`` does (``rl/algorithm.py:237-306``)
    in this process, with the port's ``EnvRunner``s on the host (runner i
    seeded ``seed + 1 + i``, its policy on the CPU) and the learner on
    ``dev``. PPO, DQN and SAC sample every runner, update once and send the
    weights to all. IMPALA and APPO keep one fragment in flight a runner and
    update once a fragment, the weights going back to the runner that
    delivered it (``_run_async_loop``): one update a runner a ``train()``."""

    def __init__(self, name: str, dev, *, runners: int = 2,
                 fragment: int = 256, seed: int = 0, **learner_kwargs):
        from ray_tpu_torch import rl
        self.name = name
        self.fragment = fragment
        self.learner = make_learner(name, dev, seed, **learner_kwargs)
        policy = {"DQN": rl.QPolicy, "SAC": rl.SACPolicy}.get(
            name, rl.ActorCriticPolicy)
        self.runners = [rl.EnvRunner(rl.CartPoleEnv, lambda: policy(
            4, 2, seed=seed, device="cpu"), seed=seed + 1 + i)
            for i in range(runners)]
        weights = self.learner.get_weights()
        for r in self.runners:
            r.set_weights(weights)
        self._in_flight = []

    def train(self) -> dict:
        if self.name in ("IMPALA", "APPO"):
            if not self._in_flight:
                self._in_flight = [(r, r.sample(self.fragment))
                                   for r in self.runners]
            metrics = {}
            for _ in self.runners:
                runner, rollout = self._in_flight.pop(0)
                metrics.update(self.learner.update([rollout]))
                runner.set_weights(self.learner.get_weights())
                self._in_flight.append((runner, runner.sample(self.fragment)))
        else:
            metrics = self.learner.update(
                [r.sample(self.fragment) for r in self.runners])
            weights = self.learner.get_weights()
            for r in self.runners:
                r.set_weights(weights)
        returns = [x for r in self.runners for x in r.episode_returns()]
        metrics["episode_return_mean"] = (float(np.mean(returns)) if returns
                                          else float("nan"))
        metrics["num_episodes"] = len(returns)
        return metrics


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
    """(b) The JAX package's learning bars (tests/test_rl.py), learners on
    ``dev``."""
    from ray_tpu_torch import rl
    out = {}
    # PPO, tests/test_rl.py:24-43
    algo = LocalAlgorithm("PPO", dev, runners=2, fragment=256, lr=1e-3,
                          epochs=4, minibatch_size=128)
    rets = [algo.train()["episode_return_mean"] for _ in range(12)]
    rets = [r for r in rets if np.isfinite(r)]
    out["PPO"] = (rets[0], rets[-1])
    if not (rets[-1] > rets[0] and rets[-1] > 40):
        raise RuntimeError(f"PPO did not learn: returns {rets}")
    # IMPALA, :193-216
    algo = LocalAlgorithm("IMPALA", dev, runners=2, fragment=256, lr=1e-3,
                          ent_coef=0.01)
    rets = []
    for _ in range(12):
        m = algo.train()
        if not np.isnan(m["episode_return_mean"]):
            rets.append(m["episode_return_mean"])
    leading, trailing = float(np.mean(rets[:3])), float(np.mean(rets[-3:]))
    out["IMPALA"] = (leading, trailing, m["num_learner_updates"])
    if not (m["num_learner_updates"] >= 24 and trailing > 35
            and trailing > leading * 0.7):
        raise RuntimeError(f"IMPALA did not learn: {out['IMPALA']} {rets}")
    # SAC, :218-233
    algo = LocalAlgorithm("SAC", dev, runners=1, fragment=256,
                          batch_size=128, updates_per_call=8)
    for _ in range(4):
        m = algo.train()
    out["SAC"] = (m["alpha"], m["entropy"], m["num_learner_updates"])
    if not (m["num_learner_updates"] >= 16 and np.isfinite(m["q_loss"])
            and m["alpha"] > 0 and 0 < m["entropy"] <= np.log(2) + 1e-5):
        raise RuntimeError(f"SAC off its bars: {m}")
    # DQN, :46-61
    algo = LocalAlgorithm("DQN", dev, runners=2, fragment=128, lr=1e-3,
                          updates_per_iter=16)
    eps = []
    for _ in range(4):
        m = algo.train()
        eps.append(m["epsilon"])
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


def rl_update_profile(name: str, cfg: dict, dev) -> dict:
    """A fresh learner of a tuned config on ``dev`` and on the CPU, on the
    same rollouts (IMPALA and APPO: one fragment, their update's input):
    update ms, the median of 5 after a warm-up update (which fills DQN's
    and SAC's replay buffers); gradient steps an update; and one profiled
    update on ``dev``: kernel launches, their device time and its share of
    the update's wall time."""
    import torch
    kw = {k: v for k, v in cfg.items() if k not in ("runners", "fragment")}
    sampler = LocalAlgorithm(name, "cpu", runners=cfg["runners"],
                             fragment=cfg["fragment"], **kw)
    rollouts = [r.sample(cfg["fragment"]) for r in sampler.runners]
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


def rl_contracts(dev) -> dict:
    """(c) The tuned CartPole contracts on ``dev``, reported and not gated:
    each trains until its target return or its 40 iterations; then its
    update's time on the card and on this machine's CPU, and one profiled
    update."""
    out = {}
    for name, (cfg, target) in TUNED.items():
        algo = LocalAlgorithm(name, dev, **cfg)
        best, its = float("-inf"), 0
        t0 = time.perf_counter()
        for its in range(1, 41):
            ret = algo.train()["episode_return_mean"]
            if np.isfinite(ret):
                best = max(best, float(ret))
            if best >= target:
                break
        wall = time.perf_counter() - t0
        prof = rl_update_profile(name, cfg, dev)
        out[name] = dict(prof, best=best, iterations=its, target=target,
                         wall_s=wall)
        log(f"RL tuned {name} ({cfg}): best return {best:.1f} in {its} "
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
    """Phase 11, every kernel counter at 0 before and read after: the RL
    learners launch none of the port's kernels."""
    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.ops import decode_attention as dec
    from ray_tpu_torch.ops import paged_attention as paged
    from ray_tpu_torch.parallel import MeshSpec, build_mesh
    counters = (attn.flash_attention_kernel,
                dec.ragged_decode_attention_kernel,
                paged.paged_decode_attention_kernel)
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    out = {"card_vs_cpu": rl_card_vs_cpu(dev), "learning": rl_learning(dev),
           "contracts": rl_contracts(dev),
           "group": rl_group_one_rank(dev, build_mesh(MeshSpec()))}
    launches = [c.launches for c in counters]
    if any(launches):
        raise RuntimeError(f"the RL path launched the port's kernels: "
                           f"{launches}")
    log(f"phase 11 (RL) in {time.perf_counter() - t0:.1f} s; kernel "
        f"launches {launches}")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from ray_tpu_torch import _build
    from ray_tpu_torch.bench import moe_bench_config
    from ray_tpu_torch.llm import LLMConfig, LLMServer
    from ray_tpu_torch.models import LlamaConfig, LlamaModel, MoEModel
    from ray_tpu_torch.ops import attention as attn
    from ray_tpu_torch.ops import decode_attention as dec
    from ray_tpu_torch.ops import paged_attention as paged

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
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
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(),
                              decode_attention="kernel")
    t0 = time.perf_counter()
    server = LLMServer(LLMConfig(model_id="llama3-8b", model_config=cfg,
                                 max_slots=32, max_seq=1024, seed=0),
                       device=dev)
    torch.cuda.synchronize()
    log(f"LLMServer(llama3_8b, {cfg.num_params() / 1e9:.2f} B params, "
        f"{server.engine.num_blocks + 1} pool blocks of "
        f"{server.engine.block_size}) up in {time.perf_counter() - t0:.1f} s;"
        f" {torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    try:
        steps0 = server.engine.stats["decode_steps"]
        paged.paged_decode_attention_kernel.launches = 0
        dec.ragged_decode_attention_kernel.launches = 0
        attn.flash_attention_kernel.launches = 0
        serving = serve_requests(server, cfg.vocab_size, rng)
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

    # 11. the RL learners, every counter at 0: no kernel of the port runs
    rl_path(dev)

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
