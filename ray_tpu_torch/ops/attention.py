"""Attention helpers shared by the decode kernels and the model.

Counterpart of ``ray_tpu/ops/attention.py`` (``NEG_INF``, ``_repeat_kv``).
``reference_attention``, ``blockwise_attention`` and the flash-attention
kernel belong to the training slice and are not ported yet.
Shapes follow the JAX package: [batch, seq, heads, head_dim].
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def repeat_kv(k: torch.Tensor, num_q_heads: int) -> torch.Tensor:
    """GQA: repeat kv heads to match q heads. [B,S,Hkv,D] -> [B,S,H,D]
    (kv head g serves q heads g*G .. g*G+G-1, as ``jnp.repeat``)."""
    num_kv = k.shape[-2]
    if num_kv == num_q_heads:
        return k
    return torch.repeat_interleave(k, num_q_heads // num_kv, dim=-2)
