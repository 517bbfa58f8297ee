"""Vision Transformer — BASELINE.md config 4 (ViT-L/16), counterpart of
``ray_tpu/models/vit.py``.

The patch embedding is JAX's reshape + one matmul (not a convolution), so
``patch_w [3·p², d]`` keeps its layout. Every leaf but the LayerNorm weights
and biases and the head bias is cast to ``cfg.dtype`` at use; the f32 head
bias promotes the logits to f32, as in JAX. GELU is ``jax.nn.gelu``'s tanh
approximation as JAX computes it (``common.gelu_tanh``). Attention is the
dispatcher's, full (not causal); at ViT-L's head_dim 64 it is the reference
attention.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ray_tpu_torch._device import DeviceLike
from ray_tpu_torch.models.common import (Leaf, gelu_tanh, init_params,
                                         layer_views, model_device, remat,
                                         token_nll)
from ray_tpu_torch.ops.attention import attention
from ray_tpu_torch.ops.norms import layer_norm

Params = Dict[str, object]


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_classes: int = 1000
    dim: int = 1024
    n_layers: int = 24
    n_heads: int = 16
    ffn_dim: int = 4096
    norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @staticmethod
    def vit_l16() -> "ViTConfig":
        return ViTConfig()

    @staticmethod
    def debug() -> "ViTConfig":
        return ViTConfig(image_size=32, patch_size=8, num_classes=10,
                         dim=64, n_layers=2, n_heads=4, ffn_dim=128,
                         remat=False)


class ViTModel:
    F32_LEAVES = ("ln1_w", "ln1_b", "ln2_w", "ln2_b", "lnf_w", "lnf_b",
                  "head_b")

    def __init__(self, cfg: ViTConfig, device: DeviceLike = None,
                 mesh=None, rules: Optional[Dict] = None):
        """``mesh``/``rules`` are kept, as JAX keeps them; ViT declares no
        param shardings, so ``make_train_step`` trains it on one device
        even when given a mesh, as JAX does."""
        self.cfg = cfg
        self.mesh = mesh
        self.rules = rules
        self.device = model_device(device, mesh)

    @staticmethod
    def param_spec(cfg: ViTConfig) -> Params:
        d, f, L = cfg.dim, cfg.ffn_dim, cfg.n_layers
        H, hd = cfg.n_heads, cfg.head_dim
        patch_dim = 3 * cfg.patch_size ** 2
        return {
            "patch_w": Leaf((patch_dim, d), patch_dim ** -0.5),
            "patch_b": Leaf((d,)),
            "cls": Leaf((1, 1, d)),
            "pos": Leaf((cfg.num_patches + 1, d), 0.1 * d ** -0.5),
            "layers": {
                "ln1_w": Leaf((L, d), fill=1.0), "ln1_b": Leaf((L, d)),
                "wqkv": Leaf((L, d, 3, H, hd), d ** -0.5),
                "wo": Leaf((L, H, hd, d), d ** -0.5),
                "ln2_w": Leaf((L, d), fill=1.0), "ln2_b": Leaf((L, d)),
                "w_up": Leaf((L, d, f), d ** -0.5), "b_up": Leaf((L, f)),
                "w_down": Leaf((L, f, d), f ** -0.5),
                "b_down": Leaf((L, d)),
            },
            "lnf_w": Leaf((d,), fill=1.0), "lnf_b": Leaf((d,)),
            "head_w": Leaf((d, cfg.num_classes), d ** -0.5),
            "head_b": Leaf((cfg.num_classes,)),
        }

    def init(self, seed: int = 0,
             param_dtype: Optional[torch.dtype] = None) -> Params:
        """Random params after ``param_spec``; ``F32_LEAVES`` f32, the
        others in ``param_dtype`` (``None``: ``cfg.dtype``)."""
        return init_params(self.param_spec(self.cfg), seed, self.device,
                           param_dtype or self.cfg.dtype, self.F32_LEAVES)

    def _patchify(self, images: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] -> [B, N, patch_dim]: patch rows in raster order,
        each patch's pixels row by row, channels innermost."""
        B, H, W, C = images.shape
        p = self.cfg.patch_size
        x = images.reshape(B, H // p, p, W // p, p, C)
        x = x.permute(0, 1, 3, 2, 4, 5)
        return x.reshape(B, (H // p) * (W // p), p * p * C)

    def _block(self, x, layer):
        cfg = self.cfg
        B, S, d = x.shape
        h = layer_norm(x, layer["ln1_w"], layer["ln1_b"], eps=cfg.norm_eps)
        qkv = (h @ layer["wqkv"].reshape(d, -1)).view(
            B, S, 3, cfg.n_heads, cfg.head_dim)
        q, k, v = qkv.unbind(2)
        o = attention(q, k, v, causal=False)
        x = x + o.reshape(B, S, d) @ layer["wo"].reshape(d, d)
        h = layer_norm(x, layer["ln2_w"], layer["ln2_b"], eps=cfg.norm_eps)
        up = gelu_tanh(h @ layer["w_up"] + layer["b_up"])
        return x + up @ layer["w_down"] + layer["b_down"]

    def apply(self, params: Params, images: torch.Tensor) -> torch.Tensor:
        """images [B, H, W, 3] float -> logits [B, num_classes] (f32)."""
        cfg = self.cfg
        dt = cfg.dtype
        patches = self._patchify(images.to(self.device).to(dt))
        x = patches @ params["patch_w"].to(dt) + params["patch_b"].to(dt)
        cls = params["cls"].to(dt).expand(x.shape[0], 1, cfg.dim)
        x = torch.cat([cls, x], dim=1)
        x = x + params["pos"].to(dt)[None]
        block = remat(self._block) if cfg.remat else self._block
        for layer in layer_views(params["layers"], dt, self.F32_LEAVES):
            x = block(x, layer)
        x = layer_norm(x[:, 0], params["lnf_w"], params["lnf_b"],
                       eps=cfg.norm_eps)
        logits = x @ params["head_w"].to(dt) + params["head_b"]
        return logits.float()

    def loss(self, params: Params, images: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
        return token_nll(self.apply(params, images), labels).mean()

    def accuracy(self, params: Params, images: torch.Tensor,
                 labels: torch.Tensor) -> torch.Tensor:
        pred = self.apply(params, images).argmax(-1)
        return (pred == labels.to(self.device)).float().mean()
