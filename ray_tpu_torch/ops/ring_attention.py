"""Ring attention: context parallelism over the ``sp`` axis (counterpart of
``ray_tpu/ops/ring_attention.py``).

Each rank of the ``sp`` axis holds a contiguous chunk of the sequence of
q/k/v. The K/V chunks go round the ring (``parallel.collectives.ppermute``)
while each rank folds every chunk into an online softmax for its own
queries: O(S/sp) memory a rank. As in JAX, the body is plain tensor math
(``_block_attn``), no kernel.

The rotation moves K and V together, stacked into one tensor: one exchange
a step, forward and backward, so the gradients of a step's K and V always
travel as one pair. The step order is JAX's (the diagonal chunk first, then
the chunk of rank ``(idx - step) % sp``); JAX's last rotation, whose result
nothing reads, is left out.
"""

from __future__ import annotations

from typing import Optional

import torch

from ray_tpu_torch.ops.attention import NEG_INF, repeat_kv
from ray_tpu_torch.parallel.collectives import axis_index, ppermute
from ray_tpu_torch.parallel.mesh import axis_size, placements, \
    shard_map_compat


def _block_attn(q, k, v, q_offset: int, k_offset: int, scale: float,
                causal: bool):
    """One blockwise step: (unnormalised acc [B, S, H, D] f32, row max m and
    row sum l [B, H, S, 1]). No detach on ``m``: the merge differentiates
    through it and the terms cancel, as in JAX."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        rows = q_offset + torch.arange(q.shape[1], device=q.device)
        cols = k_offset + torch.arange(k.shape[1], device=q.device)
        s = torch.where((rows[:, None] >= cols[None, :])[None, None], s,
                        NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return acc, m, l


def ring_attention(q, k, v, mesh=None, *, axis_name: str = "sp",
                   causal: bool = True,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Attention over a sequence sharded on ``axis_name`` of ``mesh``: call
    on each rank's local chunks q [B, S_local, H, D], k/v [B, S_local, Hkv,
    D] (inside ``shard_map_compat``, or via ``ring_attention_sharded``).
    With no mesh, or an axis of one rank, it is one blockwise step over the
    whole sequence."""
    head_dim = q.shape[-1]
    scale = scale if scale is not None else head_dim ** -0.5
    k = repeat_kv(k, q.shape[-2])
    v = repeat_kv(v, q.shape[-2])
    sp = axis_size(mesh, axis_name)
    idx = axis_index(mesh, axis_name)
    batch, chunk, heads, _ = q.shape
    q_offset = idx * chunk

    acc = torch.zeros(q.shape[:3] + (head_dim,), dtype=torch.float32,
                      device=q.device)
    m = torch.full((batch, heads, chunk, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((batch, heads, chunk, 1), dtype=torch.float32,
                    device=q.device)
    kc, vc = k, v
    for step in range(sp):
        if step:
            # the chunk of rank (idx - step) % sp arrives from the left
            kc, vc = ppermute(torch.stack((kc, vc)), mesh, axis_name,
                              1).unbind(0)
        k_offset = ((idx - step) % sp) * chunk
        a, m_c, l_c = _block_attn(q, kc, vc, q_offset, k_offset, scale,
                                  causal)
        m_new = torch.maximum(m, m_c)
        alpha = torch.exp(m - m_new)
        beta = torch.exp(m_c - m_new)
        l = alpha * l + beta * l_c
        acc = acc * alpha.transpose(1, 2) + a * beta.transpose(1, 2)
        m = m_new
    l = torch.where(l == 0.0, 1.0, l)
    return (acc / l.transpose(1, 2)).to(q.dtype)


def ring_attention_sharded(q, k, v, mesh, *, axis_name: str = "sp",
                           causal: bool = True,
                           batch_axes=("dp", "fsdp"),
                           head_axis: Optional[str] = "tp"):
    """``ring_attention`` on each rank's local shards of DTensor q/k/v, laid
    out as JAX's ``P(batch_axes, axis_name, head_axis, None)``."""
    spec = (tuple(batch_axes) or None, axis_name, head_axis, None)
    pl = placements(mesh, spec, q.shape)

    def ring(a, b, c):
        return ring_attention(a, b, c, mesh, axis_name=axis_name,
                              causal=causal)

    return shard_map_compat(ring, mesh, (pl, pl, pl), pl)(q, k, v)
