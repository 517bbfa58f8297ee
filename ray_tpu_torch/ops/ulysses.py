"""Ulysses (DeepSpeed-style) sequence parallelism: the all-to-all head and
sequence swap (counterpart of ``ray_tpu/ops/ulysses.py``).

Ring attention (``ops/ring_attention.py``) passes K/V round the ``sp``
ring; Ulysses instead trades each rank's sequence chunk for a block of heads
with one all-to-all (``parallel.collectives.all_to_all``), runs ordinary
attention over the whole sequence on those heads (``blockwise_attention``,
as in JAX), and swaps back. It needs the head count divisible by ``sp``;
grouped K/V heads too few for the swap are first repeated up to
``lcm(Hkv, sp)``, so each rank's query heads still meet exactly the kv heads
it receives.
"""

from __future__ import annotations

import math
from typing import Optional

from ray_tpu_torch.ops.attention import blockwise_attention, repeat_kv
from ray_tpu_torch.parallel.collectives import all_to_all
from ray_tpu_torch.parallel.mesh import axis_size, placements, \
    shard_map_compat


def ulysses_attention(q, k, v, mesh=None, *, axis_name: str = "sp",
                      causal: bool = True, scale: Optional[float] = None):
    """Attention over a sequence sharded on ``axis_name`` of ``mesh``: call
    on each rank's local chunks q [B, S_local, H, D], k/v [B, S_local, Hkv,
    D] (inside ``shard_map_compat``, or via ``ulysses_attention_sharded``).
    Raises ValueError when ``sp`` does not divide the head count."""
    sp = axis_size(mesh, axis_name)
    heads = q.shape[2]
    if sp == 1:
        return blockwise_attention(q, repeat_kv(k, heads),
                                   repeat_kv(v, heads), causal=causal,
                                   scale=scale)
    if heads % sp:
        raise ValueError(
            f"ulysses needs n_heads ({heads}) divisible by sp ({sp}); "
            f"use attention_impl='ring' for this shape")
    if k.shape[2] % sp:
        target = math.lcm(k.shape[2], sp)
        k = repeat_kv(k, target)
        v = repeat_kv(v, target)

    def swap(x):       # [B, S/sp, H, D] -> [B, S, H/sp, D]
        return all_to_all(x, mesh, axis_name, split_dim=2, concat_dim=1)

    q_full, k_full, v_full = swap(q), swap(k), swap(v)
    out = blockwise_attention(q_full, repeat_kv(k_full, q_full.shape[2]),
                              repeat_kv(v_full, q_full.shape[2]),
                              causal=causal, scale=scale)
    # [B, S, H/sp, D] -> [B, S/sp, H, D]
    return all_to_all(out, mesh, axis_name, split_dim=1, concat_dim=2)


def ulysses_attention_sharded(q, k, v, mesh, *, axis_name: str = "sp",
                              causal: bool = True,
                              batch_axes=("dp", "fsdp"),
                              head_axis: Optional[str] = "tp"):
    """``ulysses_attention`` on each rank's local shards of DTensor q/k/v,
    laid out as JAX's ``P(batch_axes, axis_name, head_axis, None)``."""
    spec = (tuple(batch_axes) or None, axis_name, head_axis, None)
    pl = placements(mesh, spec, q.shape)

    def ulysses(a, b, c):
        return ulysses_attention(a, b, c, mesh, axis_name=axis_name,
                                 causal=causal)

    return shard_map_compat(ulysses, mesh, (pl, pl, pl), pl)(q, k, v)
