"""Mixture-of-Experts Llama, counterpart of ``ray_tpu/models/moe.py``.

GShard/Switch-style top-k routing with capacity-based dispatch in the
``"einsum"`` scheme: the router math of ``ops/moe_dispatch.py`` gives dense
one-hot dispatch/combine tensors [T, E, C], and plain matrix products move
tokens into expert slots and back; tokens past an expert's capacity are
dropped. Attention, norms and the embedding are Llama's (``LlamaModel``).

As in JAX, the router stays f32 (its product is f32) while the expert
weights are cast to ``cfg.dtype`` at use; the aux loss (router z-loss plus
load balance) is summed over layers and added to the cross-entropy. With
``remat`` every layer is recomputed in the backward, whatever
``remat_policy`` says (JAX's MoE checkpoints the whole block).

On a mesh the experts are sharded over ``ep`` (``moe_param_logical_axes``)
and the einsum scheme's products run as DTensor ops; the router math runs
whole on every rank (its slot positions are a cumsum over every token of
the batch), on the tokens gathered from the batch axes. The ``"alltoall"``
scheme (``ops/moe_dispatch.expert_alltoall_ffn``) routes each rank's own
tokens and moves the expert slots over ``ep`` with two all-to-alls; it
needs a mesh, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from torch.distributed.tensor import DTensor

from ray_tpu_torch.models.common import Leaf, remat
from ray_tpu_torch.models.llama import (NORM_LEAVES, LlamaConfig, LlamaModel,
                                        Params, param_logical_axes)
from ray_tpu_torch.ops.moe_dispatch import expert_alltoall_ffn, topk_dispatch
from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.parallel.mesh import (active_mesh, replicated,
                                         shard_map_compat)


@dataclasses.dataclass(frozen=True)
class MoEConfig(LlamaConfig):
    num_experts: int = 8
    expert_top_k: int = 2
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    load_balance_loss: float = 1e-2
    # "einsum" = dense one-hot dispatch; "alltoall" = explicit expert
    # all-to-all over a mesh's ep axis
    moe_dispatch: str = "einsum"

    def __post_init__(self):
        super().__post_init__()
        if self.moe_dispatch not in ("einsum", "alltoall"):
            raise ValueError(
                f"moe_dispatch must be 'einsum' or 'alltoall', "
                f"got {self.moe_dispatch!r}")

    @staticmethod
    def debug_moe(num_experts: int = 4) -> "MoEConfig":
        return MoEConfig(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                         n_kv_heads=2, ffn_dim=128, max_seq_len=128,
                         remat=False, num_experts=num_experts)


def moe_param_logical_axes(cfg: MoEConfig) -> Params:
    axes = param_logical_axes(cfg)
    layers = dict(axes["layers"])
    for key in ("w_gate", "w_up", "w_down"):
        del layers[key]
    layers["router"] = (None, "embed_in", "experts")
    layers["e_gate"] = (None, "experts", "embed_in", "mlp")
    layers["e_up"] = (None, "experts", "embed_in", "mlp")
    layers["e_down"] = (None, "experts", "mlp", "embed_in")
    axes["layers"] = layers
    return axes


class MoEModel(LlamaModel):
    """Llama with MoE FFN blocks; ``apply_with_aux`` returns the aux loss
    beside the logits."""

    F32_LEAVES = NORM_LEAVES + ("router",)
    param_logical_axes = staticmethod(moe_param_logical_axes)

    @staticmethod
    def param_spec(cfg: MoEConfig) -> Params:
        """Llama's tree with the dense MLP replaced, in JAX's order: the
        router N(0, 0.02²), the experts N(0, 1/fan_in)."""
        spec = LlamaModel.param_spec(cfg)
        d, f, E, L = cfg.dim, cfg.ffn_dim, cfg.num_experts, cfg.n_layers
        layers = spec["layers"]
        for key in ("w_gate", "w_up", "w_down"):
            del layers[key]
        layers["router"] = Leaf((L, d, E), 0.02)
        layers["e_gate"] = Leaf((L, E, d, f), d ** -0.5)
        layers["e_up"] = Leaf((L, E, d, f), d ** -0.5)
        layers["e_down"] = Leaf((L, E, f, d), f ** -0.5)
        return spec

    # -- MoE FFN -----------------------------------------------------------
    def _moe_ffn(self, h: torch.Tensor, layer
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """h [B, S, D] -> (out [B, S, D], aux scalar f32)."""
        cfg: MoEConfig = self.cfg
        if cfg.moe_dispatch == "alltoall":
            if self.mesh is None:
                raise ValueError(
                    "moe_dispatch='alltoall' needs a device mesh (pass mesh= "
                    "to MoEModel)")
            out, aux = expert_alltoall_ffn(
                h, layer["router"], layer["e_gate"], layer["e_up"],
                layer["e_down"], self.mesh, num_experts=cfg.num_experts,
                top_k=cfg.expert_top_k, capacity_factor=cfg.capacity_factor,
                z_coef=cfg.router_z_loss, lb_coef=cfg.load_balance_loss,
                dtype=cfg.dtype)
            return out, aux.mean()
        dt = cfg.dtype
        B, S, D = h.shape
        E, K = cfg.num_experts, cfg.expert_top_k
        T = B * S
        C = max(1, int(cfg.capacity_factor * T * K / E))
        x = h.reshape(T, D)

        def route(x, router):
            return topk_dispatch(x, router, E, K, C, cfg.router_z_loss,
                                 cfg.load_balance_loss)
        if isinstance(x, DTensor):
            # the router and the slots take every token, gathered once
            rep = replicated(self.mesh)
            x = x.redistribute(active_mesh(self.mesh), rep)
            route = shard_map_compat(route, self.mesh, (rep, rep),
                                     (rep, rep, rep))
        dispatch, combine, aux = route(x, layer["router"])
        # "tec,td->ecd": each expert slot takes its token
        expert_in = (dispatch.to(dt).reshape(T, E * C).t() @ x.to(dt)) \
            .view(E, C, D)
        gate = expert_in @ layer["e_gate"]                         # [E,C,F]
        up = expert_in @ layer["e_up"]
        expert_out = (F.silu(gate) * up) @ layer["e_down"]         # [E,C,D]
        # "tec,ecd->td": each token sums its slots, weighted by its gates
        out = combine.to(dt).reshape(T, E * C) @ expert_out.reshape(E * C, D)
        return out.view(B, S, D), aux

    def _moe_block(self, x, layer, positions):
        """Returns (x, aux): Llama's attention half, then the MoE FFN."""
        q, k, v = self._qkv(layer, x, positions)
        x = self._attn_out(layer, x, self._attention(q, k, v, positions))
        h = rms_norm(x, layer["mlp_norm"], eps=self.cfg.norm_eps)
        ffn, aux = self._moe_ffn(h, layer)
        # laid out as the residual stream, forward and backward: the
        # tokens otherwise come back (or their gradient arrives) sharded on
        # more than one mesh axis, which the flattening reshapes turn into
        # strided shards that DTensor takes minutes an op to plan on three
        # mesh axes
        return x + self._constrain(ffn, "batch", "seq", "embed"), aux

    def apply_with_aux(self, params: Params, tokens: torch.Tensor,
                       positions: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens [B, S] -> (logits [B, S, V] f32, aux summed over
        layers)."""
        cfg = self.cfg
        block = remat(self._moe_block) if cfg.remat else self._moe_block
        x = self._embed(params, self._tokens(tokens))
        positions = self._positions(positions)
        aux = None          # JAX starts from 0.0: the same sum
        for layer in self._layers(params):
            x, aux_i = block(x, layer, positions)
            aux = aux_i if aux is None else aux + aux_i
        x = rms_norm(x, params["norm_f"], eps=cfg.norm_eps)
        return self._lm_head(params, x), aux

    def apply(self, params: Params, tokens: torch.Tensor,
              positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.apply_with_aux(params, tokens, positions)[0]

    def loss(self, params: Params, tokens: torch.Tensor,
             targets: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Cross-entropy (masked mean with ``mask``) plus the aux loss."""
        logits, aux = self.apply_with_aux(params, tokens)
        return self._cross_entropy(logits, targets, mask) + aux
