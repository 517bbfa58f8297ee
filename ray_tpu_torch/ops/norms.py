"""Normalization ops (counterpart of ``ray_tpu/ops/norms.py``).

Computed in float32 regardless of input dtype, cast back on the way out.
"""

from __future__ import annotations

from typing import Optional

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, *, eps: float = 1e-5,
             upcast: bool = True) -> torch.Tensor:
    """RMSNorm (Llama-family). weight shape [dim]."""
    dtype = x.dtype
    if upcast:
        x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.to(x.dtype)).to(dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor] = None, *,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm (GPT-2/ViT-family)."""
    dtype = x.dtype
    x = x.float()
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    x = (x - mean) * torch.rsqrt(var + eps)
    x = x * weight.to(x.dtype)
    if bias is not None:
        x = x + bias.to(x.dtype)
    return x.to(dtype)
