"""GPT-2 family — BASELINE.md config 2 (GPT-2 125M), counterpart of
``ray_tpu/models/gpt2.py``: pre-LN, learned positions, tied embeddings,
GELU MLP.

The param layout is the JAX one (``wqkv [L, d, 3, H, hd]``, ``bqkv
[L, 3, H, hd]``, ``wo [L, H, hd, d]``, ...). Every leaf but the LayerNorm
weights and biases is cast to ``cfg.dtype`` at use. GELU is
``jax.nn.gelu``'s tanh approximation, computed as JAX computes it
(``common.gelu_tanh``). Attention goes through the dispatcher, whose rule is
JAX's: at GPT-2's head_dim 64 it is the reference attention on the card
too.

On a mesh (``mesh=``) the leaves take the placements of
``param_logical_axes`` (``param_shardings``); JAX constrains no activation
of GPT-2, so DTensor's propagation alone places them. The token gather is
the vocab-parallel lookup with JAX's clamp (``common.embed_lookup``), and
attention runs on each rank's local rows and heads.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from ray_tpu_torch._device import DeviceLike
from ray_tpu_torch.models.common import (Leaf, embed_lookup, gelu_tanh,
                                         init_params, layer_views,
                                         leaf_shardings, model_device, remat,
                                         token_nll)
from ray_tpu_torch.ops.attention import attention
from ray_tpu_torch.ops.indexing import gather_index
from ray_tpu_torch.ops.norms import layer_norm

Params = Dict[str, object]


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50_257
    dim: int = 768
    n_layers: int = 12
    n_heads: int = 12
    max_seq_len: int = 1024
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def ffn_dim(self) -> int:
        return 4 * self.dim

    @staticmethod
    def gpt2_125m() -> "GPT2Config":
        return GPT2Config()

    @staticmethod
    def debug() -> "GPT2Config":
        return GPT2Config(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                          max_seq_len=128, remat=False)

    def num_params(self) -> int:
        """The JAX package's count (it leaves out 2·dim a layer of the
        biases and LayerNorms that the param tree holds)."""
        d, f = self.dim, self.ffn_dim
        per_layer = 4 * d * d + 2 * d * f + 4 * d + d + f + 2 * d
        return (self.vocab_size * d + self.max_seq_len * d
                + self.n_layers * per_layer + 2 * d)


def param_logical_axes(cfg: GPT2Config) -> Params:
    return {
        "wte": ("vocab", "embed_in"),
        "wpe": (None, "embed_in"),
        "layers": {
            "ln1_w": (None, "embed_in"), "ln1_b": (None, "embed_in"),
            "wqkv": (None, "embed_in", None, "heads", None),
            "bqkv": (None, None, "heads", None),
            "wo": (None, "heads", None, "embed_in"),
            "bo": (None, "embed_in"),
            "ln2_w": (None, "embed_in"), "ln2_b": (None, "embed_in"),
            "w_up": (None, "embed_in", "mlp"), "b_up": (None, "mlp"),
            "w_down": (None, "mlp", "embed_in"),
            "b_down": (None, "embed_in"),
        },
        "lnf_w": ("embed_in",), "lnf_b": ("embed_in",),
    }


class GPT2Model:
    F32_LEAVES = ("ln1_w", "ln1_b", "ln2_w", "ln2_b", "lnf_w", "lnf_b")
    param_logical_axes = staticmethod(param_logical_axes)

    def __init__(self, cfg: GPT2Config, device: DeviceLike = None,
                 mesh=None, rules: Optional[Dict] = None):
        self.cfg = cfg
        self.mesh = mesh
        self.rules = rules
        self.device = model_device(device, mesh)

    @staticmethod
    def param_spec(cfg: GPT2Config) -> Params:
        d, f, L = cfg.dim, cfg.ffn_dim, cfg.n_layers
        H, hd = cfg.n_heads, cfg.head_dim
        return {
            "wte": Leaf((cfg.vocab_size, d), d ** -0.5),
            "wpe": Leaf((cfg.max_seq_len, d), 0.1 * d ** -0.5),
            "layers": {
                "ln1_w": Leaf((L, d), fill=1.0), "ln1_b": Leaf((L, d)),
                "wqkv": Leaf((L, d, 3, H, hd), d ** -0.5),
                "bqkv": Leaf((L, 3, H, hd)),
                "wo": Leaf((L, H, hd, d), d ** -0.5),
                "bo": Leaf((L, d)),
                "ln2_w": Leaf((L, d), fill=1.0), "ln2_b": Leaf((L, d)),
                "w_up": Leaf((L, d, f), d ** -0.5), "b_up": Leaf((L, f)),
                "w_down": Leaf((L, f, d), f ** -0.5),
                "b_down": Leaf((L, d)),
            },
            "lnf_w": Leaf((d,), fill=1.0), "lnf_b": Leaf((d,)),
        }

    def init(self, seed: int = 0,
             param_dtype: Optional[torch.dtype] = None) -> Params:
        """Random params after ``param_spec``; LayerNorm leaves f32, the
        others in ``param_dtype`` (``None``: ``cfg.dtype``). On a mesh each
        whole leaf is placed as it is drawn (``param_shardings``)."""
        return init_params(self.param_spec(self.cfg), seed, self.device,
                           param_dtype or self.cfg.dtype, self.F32_LEAVES,
                           self.mesh, None if self.mesh is None
                           else self.param_shardings())

    def param_shardings(self):
        """The tree of DTensor placements of the params on the mesh."""
        return leaf_shardings(self.param_spec(self.cfg),
                              param_logical_axes(self.cfg), self.mesh,
                              self.rules)

    def _block(self, x, layer):
        cfg = self.cfg
        B, S, d = x.shape
        h = layer_norm(x, layer["ln1_w"], layer["ln1_b"], eps=cfg.norm_eps)
        # one product per q/k/v: on a mesh, DTensor cannot flatten
        # (3, H, hd) with H sharded over tp
        q, k, v = ((h @ w.reshape(d, -1)).view(B, S, cfg.n_heads,
                                               cfg.head_dim) + b
                   for w, b in zip(layer["wqkv"].unbind(1),
                                   layer["bqkv"].unbind(0)))
        o = attention(q, k, v, causal=True)
        x = x + o.reshape(B, S, d) @ layer["wo"].reshape(d, d) + layer["bo"]
        h = layer_norm(x, layer["ln2_w"], layer["ln2_b"], eps=cfg.norm_eps)
        up = gelu_tanh(h @ layer["w_up"] + layer["b_up"])
        return x + up @ layer["w_down"] + layer["b_down"]

    def apply(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, S] int -> logits [B, S, V] (f32)."""
        cfg = self.cfg
        dt = cfg.dtype
        wte = params["wte"]
        # gather, then cast (JAX casts, then gathers: the same numbers)
        if self.mesh is not None:
            x = embed_lookup(wte, tokens, self.mesh, self.rules, clamp=True,
                             dtype=dt)
        else:
            tokens = tokens.to(self.device)
            x = wte[gather_index(tokens, wte.shape[0])].to(dt)
        x = x + params["wpe"][:tokens.shape[1]].to(dt)[None]
        block = remat(self._block) if cfg.remat else self._block
        for layer in layer_views(params["layers"], dt, self.F32_LEAVES):
            x = block(x, layer)
        x = layer_norm(x, params["lnf_w"], params["lnf_b"], eps=cfg.norm_eps)
        return (x @ wte.to(dt).t()).float()                      # tied head

    def loss(self, params: Params, tokens: torch.Tensor,
             targets: torch.Tensor) -> torch.Tensor:
        return token_nll(self.apply(params, tokens), targets).mean()
