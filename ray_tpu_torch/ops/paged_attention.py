"""Paged decode attention: one query token vs a block-pool KV cache.

Counterpart of ``ray_tpu/ops/paged_attention.py``. K/V live in a shared
block pool ``[num_blocks, block_size, Hkv, D]``; each slot's logical
sequence is a row of physical block ids (its block table).

- ``paged_decode_attention_reference`` — gathers each slot's blocks into a
  dense view and runs the masked ragged reference (JAX's XLA fallback);
- ``paged_decode_attention_kernel`` — for CUDA tensors it launches the
  hand-written kernel of ``csrc/decode_attention.cu`` (which replaces the
  Pallas ``_paged_kernel``); for CPU tensors it runs ``_paged_decode_plain``,
  a plain PyTorch version of the Pallas kernel's numerics;
- ``paged_decode_attention`` — the dispatcher (``"reference"`` or
  ``"kernel"``).

Table entries outside the pool are read as JAX's gather reads them
(``ops/indexing.py``); the engine never produces one (its padding points at
its scratch block).

Shapes: q [B, H, D]; k_pool/v_pool [NB, bs, Hkv, D]; block_tables [B, MAXB]
int (entries past a slot's length are ignored); lengths [B] int.
"""

from __future__ import annotations

from typing import Optional

import torch

from ray_tpu_torch.ops.attention import DTYPE_CODES
from ray_tpu_torch.ops.decode_attention import (
    check_cuda_operands, decode_split_plan, online_decode_plain,
    ragged_decode_attention_reference, split_scratch)
from ray_tpu_torch.ops.indexing import gather_index


def _checked_shapes(q, k_pool, v_pool, block_tables, lengths):
    if q.dim() != 3 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape \
            or block_tables.dim() != 2 \
            or block_tables.shape[0] != q.shape[0] \
            or lengths.shape != (q.shape[0],):
        raise ValueError("paged decode attention: expected q [B,H,D], "
                         "k/v pool [NB,bs,Hkv,D], block_tables [B,MAXB], "
                         "lengths [B]")


def paged_decode_attention_reference(q, k_pool, v_pool, block_tables,
                                     lengths, *,
                                     scale: Optional[float] = None):
    """Gather the slot's blocks into a dense view, then run the masked
    ragged reference: one extra round trip of the context through device
    memory against the kernel."""
    _checked_shapes(q, k_pool, v_pool, block_tables, lengths)
    B, maxb = block_tables.shape
    NB, bs = k_pool.shape[:2]
    tables = gather_index(block_tables.long(), NB)
    k = k_pool[tables].reshape(B, maxb * bs, *k_pool.shape[2:])
    v = v_pool[tables].reshape(B, maxb * bs, *v_pool.shape[2:])
    return ragged_decode_attention_reference(q, k, v, lengths, scale=scale)


def _paged_decode_plain(q, k_pool, v_pool, block_tables, lengths, *,
                        scale: float):
    """Plain version of the Pallas ``_paged_kernel``: walks each slot's
    logical blocks through its table, f32 online softmax."""
    NB, bs = k_pool.shape[:2]
    tables = gather_index(block_tables.long(), NB)
    return online_decode_plain(
        q, lengths, tables.shape[1], bs,
        lambda i: (k_pool[tables[:, i]], v_pool[tables[:, i]]), scale)


def _launch_paged(q, k_pool, v_pool, block_tables, lengths, scale: float,
                  scratch=None):
    """One call of the entry point: the split kernel, then the merge.
    ``scratch`` (``split_scratch``'s pair) receives the partials; by default
    it is allocated here."""
    from ray_tpu_torch import _build
    name = "paged_decode_attention_kernel"
    lengths = lengths.to(torch.int32).contiguous()
    tables = block_tables.to(torch.int32).contiguous()
    check_cuda_operands(name, q, k_pool, v_pool, lengths, extra=(tables,))
    B, H, D = q.shape
    NB, bs, Hkv, _ = k_pool.shape
    maxb = tables.shape[1]
    split_rows, n_split = decode_split_plan(maxb * bs)
    part_acc, part_ml = scratch or split_scratch(B, n_split, H, D, q.device)
    lib = _build.load_library("decode_attention")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rt_paged_decode_attention(
            DTYPE_CODES[q.dtype], q.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), tables.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(), B, H,
            Hkv, D, NB, bs, maxb, n_split, split_rows, float(scale), stream)
    _build.check(err, name)
    return out


def paged_decode_attention_kernel(q, k_pool, v_pool, block_tables, lengths,
                                  *, scale: Optional[float] = None):
    """The hand-written paged-decode kernel for CUDA tensors, the plain
    version of the Pallas kernel for CPU tensors. No fallback between the
    two: a CUDA tensor the kernel cannot take raises."""
    _checked_shapes(q, k_pool, v_pool, block_tables, lengths)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return _paged_decode_plain(q, k_pool, v_pool, block_tables, lengths,
                                   scale=scale)
    out = _launch_paged(q, k_pool, v_pool, block_tables, lengths, scale)
    paged_decode_attention_kernel.launches += 1
    return out


paged_decode_attention_kernel.launches = 0


def paged_decode_attention(q, k_pool, v_pool, block_tables, lengths, *,
                           impl: str = "reference",
                           scale: Optional[float] = None):
    if impl == "kernel":
        return paged_decode_attention_kernel(q, k_pool, v_pool, block_tables,
                                             lengths, scale=scale)
    return paged_decode_attention_reference(q, k_pool, v_pool, block_tables,
                                            lengths, scale=scale)
