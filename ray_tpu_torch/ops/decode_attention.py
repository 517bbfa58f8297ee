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
- ``ragged_decode_attention`` — the dispatcher (``impl="reference"`` is JAX's
  ``"xla"``, ``impl="kernel"`` is JAX's ``"pallas"``).

Shapes: q [B, H, D]; k/v [B, S, Hkv, D]; lengths [B] int.
"""

from __future__ import annotations

from typing import Callable, Optional

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


def online_decode_plain(q, lengths, num_blocks: int, block: int,
                        kv_block: Callable, scale: float):
    """The Pallas decode kernels' loop in plain PyTorch: f32 online softmax
    over ``num_blocks`` KV blocks of ``block`` rows; ``kv_block(i)`` returns
    block i's (k, v) as [B, block, Hkv, D]. A block that starts at or past a
    slot's length leaves that slot's state untouched (``pl.when``)."""
    B, H, D = q.shape
    qf = q.float()
    lengths = lengths.to(device=q.device, dtype=torch.int64)
    m = torch.full((B, H, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, D), dtype=torch.float32, device=q.device)
    for i in range(num_blocks):
        start = i * block
        k, v = kv_block(i)
        k = repeat_kv(k.float(), H)                                # [B,bk,H,D]
        v = repeat_kv(v.float(), H)
        s = torch.einsum("bhd,bkhd->bhk", qf, k) * scale
        idx = start + torch.arange(block, device=q.device)
        s = torch.where(idx[None, None, :] < lengths[:, None, None], s,
                        NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l_new = alpha * l + p.sum(dim=-1, keepdim=True)
        acc_new = acc * alpha + torch.einsum("bhk,bkhd->bhd", p, v)
        live = (start < lengths)[:, None, None]
        m = torch.where(live, m_new, m)
        l = torch.where(live, l_new, l)
        acc = torch.where(live, acc_new, acc)
    denom = torch.where(l == 0.0, 1.0, l)
    return (acc / denom).to(q.dtype)


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


def _launch_ragged(q, k, v, lengths, scale: float):
    from ray_tpu_torch import _build
    name = "ragged_decode_attention_kernel"
    lengths = lengths.to(torch.int32).contiguous()
    check_cuda_operands(name, q, k, v, lengths)
    B, H, D = q.shape
    _, S, Hkv, _ = k.shape
    lib = _build.load_library("decode_attention")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rt_ragged_decode_attention(
            DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), B, H, Hkv, D, S,
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
