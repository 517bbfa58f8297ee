"""Rotary position embeddings (counterpart of ``ray_tpu/ops/rope.py``).

Llama-3 split-halves rotation, computed in float32.
"""

from __future__ import annotations

from typing import Optional

import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.ops.indexing import gather_index


def rope_frequencies(head_dim: int, max_seq_len: int, *,
                     theta: float = 500_000.0,
                     scaling_factor: Optional[float] = None,
                     device: DeviceLike = None) -> torch.Tensor:
    """[max_seq_len, head_dim//2] f32 rotation angles, on ``device``
    (``None`` is the card, as for every entry point of the port)."""
    device = resolve_device(device)
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim
    inv_freq = 1.0 / (theta ** exponent)
    pos = torch.arange(max_seq_len, dtype=torch.float32)
    if scaling_factor is not None:
        pos = pos / scaling_factor
    return torch.outer(pos, inv_freq).to(device)


def apply_rope(x: torch.Tensor, angles: torch.Tensor,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rotate q or k. x: [..., S, H, D]; angles: [max_S, D/2].

    positions: optional [..., S] absolute positions; defaults to 0..S-1.
    Positions outside the table are read as JAX's gather reads them (the
    engine's padded prefill rows can reach past ``max_seq_len``).
    """
    seq_len = x.shape[-3]
    if positions is None:
        ang = angles[:seq_len][None, :, None, :]          # [1, S, 1, D/2]
    else:
        idx = gather_index(positions, angles.shape[0])
        ang = angles[idx][..., :, None, :]                # [..., S, 1, D/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
