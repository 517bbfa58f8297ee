"""Ragged decode attention: one query token vs a length-bounded KV cache.

Counterpart of ``ray_tpu/ops/decode_attention.py``:

- ``ragged_decode_attention_reference`` — the masked fallback, with the same
  numerics as the JAX XLA version (f32 scores and softmax, ``p`` cast to
  ``v``'s dtype before the value product);
- ``ragged_decode_attention_kernel`` — for CUDA tensors it launches the
  hand-written kernel of ``csrc/decode_attention.cu`` (which replaces the
  Pallas ``_decode_kernel``); for CPU tensors it runs
  ``_ragged_decode_plain``, a plain PyTorch version of the Pallas kernel's
  numerics (f32 throughout, online softmax over KV blocks);
- ``split_decode_plain`` / ``_merge_splits_plain`` — the split-KV kernels'
  arithmetic (per-chunk partials, log-sum-exp merge) in plain PyTorch, and
  ``decode_split_plan``, the host-side chunking both decode kernels use;
- ``ragged_decode_attention`` — the dispatcher (``impl="reference"`` is JAX's
  ``"xla"``, ``impl="kernel"`` is JAX's ``"pallas"``).

Shapes: q [B, H, D]; k/v [B, S, Hkv, D]; lengths [B] int.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ray_tpu_torch.ops.attention import (DTYPE_CODES, NEG_INF,
                                         check_kernel_tensors, repeat_kv)


def ragged_decode_attention_reference(q, k, v, lengths, *,
                                      scale: Optional[float] = None):
    """Masked fallback: attends over all S with positions >= length masked
    out. [B,H,D] x [B,S,Hkv,D] -> [B,H,D]."""
    head_dim = q.shape[-1]
    scale = scale if scale is not None else head_dim ** -0.5
    k = repeat_kv(k, q.shape[1])
    v = repeat_kv(v, q.shape[1])
    s = torch.einsum("bhd,bshd->bhs", q.float(), k.float()) * scale
    pos = torch.arange(k.shape[1], device=q.device)
    mask = pos[None, :] < lengths.to(q.device)[:, None]            # [B,S]
    s = torch.where(mask[:, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhs,bshd->bhd", p.to(v.dtype), v)


# context rows per chunk of the split-KV kernels (a multiple of their
# 32-row tile); `python -m ray_tpu_torch.profile_kernels` sweeps it on the
# card (PERF.md, PR 4: 64-256 rows within noise of each other, 512 slower)
SPLIT_ROWS = 128


def decode_split_plan(width: int) -> Tuple[int, int]:
    """``(split_rows, n_split)``: how the split-KV kernels cut a table
    ``width`` rows wide (``max_blocks * block_size`` paged, ``S`` ragged)
    into chunks. Computed on the host from shapes alone; the lengths stay
    on the device, and a chunk that starts past its slot's length costs one
    block that exits at once."""
    return SPLIT_ROWS, max(1, -(-width // SPLIT_ROWS))


def split_scratch(B: int, n_split: int, H: int, D: int, device):
    """The kernels' f32 partials: ``acc`` [B, n_split, H, D] and
    ``(m, l)`` [B, n_split, H, 2]."""
    n = B * n_split * H
    flat = torch.empty(n * (D + 2), dtype=torch.float32, device=device)
    return (flat[:n * D].view(B, n_split, H, D),    # one allocation for both
            flat[n * D:].view(B, n_split, H, 2))


def online_decode_state(q, lengths, num_blocks: int, block: int,
                        kv_block: Callable, scale: float, lo: int = 0,
                        hi: Optional[int] = None):
    """The Pallas decode kernels' loop in plain PyTorch: f32 online softmax
    over ``num_blocks`` KV blocks of ``block`` rows, over context rows
    ``[lo, hi)`` below each slot's length; ``kv_block(i)`` returns block
    i's (k, v) as [B, block, Hkv, D]. A block with no such row leaves that
    slot's state untouched (``pl.when``). Returns the running max ``m`` and
    sum ``l`` [B, H, 1] and the unnormalised accumulator [B, H, D]."""
    B, H, D = q.shape
    qf = q.float()
    lengths = lengths.to(device=q.device, dtype=torch.int64)
    end = lengths if hi is None else lengths.clamp(max=hi)
    m = torch.full((B, H, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, D), dtype=torch.float32, device=q.device)
    for i in range(num_blocks):
        start = i * block
        if start + block <= lo or (hi is not None and start >= hi):
            continue
        k, v = kv_block(i)
        k = repeat_kv(k.float(), H)                                # [B,bk,H,D]
        v = repeat_kv(v.float(), H)
        s = torch.einsum("bhd,bkhd->bhk", qf, k) * scale
        idx = start + torch.arange(block, device=q.device)
        valid = (idx[None, :] < end[:, None]) & (idx[None, :] >= lo)
        s = torch.where(valid[:, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l_new = alpha * l + p.sum(dim=-1, keepdim=True)
        acc_new = acc * alpha + torch.einsum("bhk,bkhd->bhd", p, v)
        live = valid.any(dim=-1)[:, None, None]
        m = torch.where(live, m_new, m)
        l = torch.where(live, l_new, l)
        acc = torch.where(live, acc_new, acc)
    return m, l, acc


def online_decode_plain(q, lengths, num_blocks: int, block: int,
                        kv_block: Callable, scale: float):
    """``online_decode_state`` over the whole context, normalised:
    ``l == 0 -> 1`` (an empty slot gives 0), cast to q's dtype."""
    _, l, acc = online_decode_state(q, lengths, num_blocks, block, kv_block,
                                    scale)
    denom = torch.where(l == 0.0, 1.0, l)
    return (acc / denom).to(q.dtype)


def _merge_splits_plain(part_acc, part_ml, lengths, split_rows: int,
                        dtype) -> torch.Tensor:
    """Plain version of the kernels' merge: combine the chunks of each slot
    that start below its length (``part_acc`` [B, n, H, D], ``part_ml``
    [B, n, H, 2] = (m, l)) with the log-sum-exp rescale; chunks past the
    length are never read. ``l == 0 -> 1``, so an empty slot gives 0."""
    n = part_acc.shape[1]
    lengths = lengths.to(device=part_acc.device, dtype=torch.int64)
    n_live = (lengths.clamp(0, n * split_rows) + split_rows - 1) \
        // split_rows
    live = (torch.arange(n, device=part_acc.device)[None, :]
            < n_live[:, None])[..., None]                          # [B,n,1]
    m = torch.where(live, part_ml[..., 0], NEG_INF)                # [B,n,H]
    w = torch.where(live, torch.exp(m - m.amax(dim=1, keepdim=True)), 0.0)
    l = (w * torch.where(live, part_ml[..., 1], 0.0)).sum(dim=1)   # [B,H]
    o = (w[..., None] * torch.where(live[..., None], part_acc, 0.0)).sum(1)
    l = torch.where(l == 0.0, 1.0, l)
    return (o / l[..., None]).to(dtype)


def split_decode_plain(q, lengths, num_blocks: int, block: int,
                       kv_block: Callable, scale: float) -> torch.Tensor:
    """The split-KV kernels' arithmetic in plain PyTorch: the online
    softmax run per chunk of ``decode_split_plan(num_blocks * block)``,
    then ``_merge_splits_plain``."""
    split_rows, n_split = decode_split_plan(num_blocks * block)
    parts = [online_decode_state(q, lengths, num_blocks, block, kv_block,
                                 scale, lo=c * split_rows,
                                 hi=(c + 1) * split_rows)
             for c in range(n_split)]
    part_ml = torch.stack([torch.cat([m, l], dim=-1) for m, l, _ in parts],
                          dim=1)
    part_acc = torch.stack([acc for _, _, acc in parts], dim=1)
    return _merge_splits_plain(part_acc, part_ml, lengths, split_rows,
                               q.dtype)


def _ragged_decode_plain(q, k, v, lengths, *, block_k: int, scale: float):
    """Plain version of the Pallas ``_decode_kernel``: S is padded up to a
    multiple of ``bk = min(block_k, S)`` and walked block by block."""
    S = k.shape[1]
    bk = min(block_k, S)
    num_kb = -(-S // bk)
    pad = num_kb * bk - S
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    return online_decode_plain(
        q, lengths, num_kb, bk,
        lambda i: (k[:, i * bk:(i + 1) * bk], v[:, i * bk:(i + 1) * bk]),
        scale)


def check_cuda_operands(name: str, q, k, v, lengths, *, extra=()):
    """What the decode launchers take: ``check_kernel_tensors``, plus
    head_dim a multiple of 8 up to 256, H a multiple of Hkv and int32
    lengths [B]. Raises ValueError on anything else."""
    check_kernel_tensors(name, q, k, v, lengths, *extra)
    B, H, D = q.shape
    Hkv = k.shape[-2]
    if D % 8 or D > 256 or k.shape[-1] != D:
        raise ValueError(f"{name}: head_dim must be a multiple of 8 up to "
                         f"256 and equal in q and k, got {D}/{k.shape[-1]}")
    if Hkv < 1 or H % Hkv:
        raise ValueError(f"{name}: {H} query heads not a multiple of "
                         f"{Hkv} kv heads")
    if B > 65535:
        raise ValueError(f"{name}: batch {B} exceeds 65535")
    if lengths.dtype != torch.int32 or lengths.shape != (B,):
        raise ValueError(f"{name}: lengths must be int32 [{B}]")


def _launch_ragged(q, k, v, lengths, scale: float, scratch=None):
    """One call of the entry point: the split kernel, then the merge.
    ``scratch`` (``split_scratch``'s pair) receives the partials; by default
    it is allocated here."""
    from ray_tpu_torch import _build
    name = "ragged_decode_attention_kernel"
    lengths = lengths.to(torch.int32).contiguous()
    check_cuda_operands(name, q, k, v, lengths)
    B, H, D = q.shape
    _, S, Hkv, _ = k.shape
    split_rows, n_split = decode_split_plan(S)
    part_acc, part_ml = scratch or split_scratch(B, n_split, H, D, q.device)
    lib = _build.load_library("decode_attention")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rt_ragged_decode_attention(
            DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), part_acc.data_ptr(),
            part_ml.data_ptr(), B, H, Hkv, D, S, n_split, split_rows,
            float(scale), stream)
    _build.check(err, name)
    return out


def ragged_decode_attention_kernel(q, k, v, lengths, *,
                                   scale: Optional[float] = None):
    """The hand-written ragged-decode kernel for CUDA tensors, the plain
    version of the Pallas kernel (at its default ``block_k`` of 128) for CPU
    tensors. No fallback between the two: a CUDA tensor the kernel cannot
    take raises."""
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0]:
        raise ValueError("ragged_decode_attention_kernel: expected q [B,H,D] "
                         "and k/v [B,S,Hkv,D]")
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return _ragged_decode_plain(q, k, v, lengths, block_k=128,
                                    scale=scale)
    out = _launch_ragged(q, k, v, lengths, scale)
    ragged_decode_attention_kernel.launches += 1
    return out


ragged_decode_attention_kernel.launches = 0


def ragged_decode_attention(q, k, v, lengths, *, impl: str = "reference",
                            scale: Optional[float] = None):
    if impl == "kernel":
        return ragged_decode_attention_kernel(q, k, v, lengths, scale=scale)
    return ragged_decode_attention_reference(q, k, v, lengths, scale=scale)
