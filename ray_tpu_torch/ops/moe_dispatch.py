"""MoE router math and the explicit expert all-to-all (counterpart of
``ray_tpu/ops/moe_dispatch.py``).

``topk_dispatch``: GShard-style top-k routing into capacity-bounded expert
slots, as dense one-hot tensors that ``models/moe.py``'s einsum scheme
contracts with plain matrix products. ``expert_alltoall_ffn``: the
``"alltoall"`` scheme. Each rank routes its own tokens into slots of every
expert (the capacity from its local token count), the slots cross the
``ep`` axis in one all-to-all (``parallel.collectives.all_to_all``), each
rank's experts run where their weights live, and a second all-to-all
brings the results back: 2 x E x C_local x D elements a rank and layer,
whatever the routing.

Differences of idiom: ``jax.nn.one_hot`` of an index past the last class is a
zero row, where ``F.one_hot`` raises (and device-asserts on CUDA); here every
one-hot is a comparison against ``arange``, which gives JAX's zero row for a
slot past the capacity. ``torch.topk`` makes no promise on the order of tied
values, where ``lax.top_k`` takes the lower index first; ties in f32 router
probabilities need equal logits.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch.parallel.collectives import all_to_all, pmean, pvary
from ray_tpu_torch.parallel.mesh import (placements, shard_map_compat,
                                         summed_over)


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot rows of ``idx`` over ``n`` classes; an index outside
    ``[0, n)`` gives a zero row, as ``jax.nn.one_hot``."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def topk_dispatch(xf: torch.Tensor, router: torch.Tensor, num_experts: int,
                  top_k: int, capacity: int, z_coef: float, lb_coef: float
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Route tokens ``xf`` [T, D] through ``router`` [D, E]: returns
    (dispatch [T, E, C] bool, combine [T, E, C] f32, aux scalar f32), aux
    the router z-loss plus the load-balance loss. The router product is in
    f32 (``xf`` upcast, the router as given: f32 in the models)."""
    logits = xf.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    z = torch.logsumexp(logits, dim=-1)
    z_loss = torch.mean(z ** 2) * z_coef
    me = torch.mean(probs, dim=0)
    ce = torch.mean(_one_hot(torch.argmax(probs, dim=-1), num_experts), dim=0)
    aux = z_loss + lb_coef * num_experts * torch.sum(me * ce)

    gate_vals, gate_idx = torch.topk(probs, top_k, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    T = xf.shape[0]
    combine = torch.zeros((T, num_experts, capacity), dtype=torch.float32,
                          device=xf.device)
    dispatch = torch.zeros((T, num_experts, capacity), dtype=torch.bool,
                           device=xf.device)
    # Slot positions are unique per expert ACROSS the k passes: a choice-k
    # token starts after every earlier pass's tokens for the same expert
    # (GShard's top-2 priority order). The positions are a cumsum of f32
    # one-hots, exact below 2**24 tokens, as in JAX.
    expert_count = torch.zeros((num_experts,), dtype=torch.float32,
                               device=xf.device)
    for j in range(top_k):
        onehot = _one_hot(gate_idx[:, j], num_experts)              # [T, E]
        pos_in_pass = torch.cumsum(onehot, dim=0) - onehot
        pos = torch.sum((pos_in_pass + expert_count[None, :]) * onehot,
                        dim=-1)
        expert_count = expert_count + onehot.sum(dim=0)
        in_cap = (pos < capacity).float()
        pos_oh = _one_hot(pos.long(), capacity)                     # [T, C]
        slot = onehot[:, :, None] * pos_oh[:, None, :]
        slot = slot * in_cap[:, None, None]
        dispatch = dispatch | (slot > 0)
        combine = combine + slot * gate_vals[:, j][:, None, None]
    return dispatch, combine, aux


def expert_alltoall_ffn(h, router, e_gate, e_up, e_down, mesh, *,
                        num_experts: int, top_k: int,
                        capacity_factor: float, z_coef: float,
                        lb_coef: float, dtype: torch.dtype,
                        axis_name: str = "ep"):
    """MoE FFN with an explicit expert all-to-all over ``axis_name``.

    h: DTensor [B, S, D]; router [D, E]; e_gate/e_up [E, D, F]; e_down
    [E, F, D]. Laid out as JAX's specs: x ``P(batch, (sp, ep), None)``,
    the experts ``P(ep, None, None)``, the router whole. Returns (out
    [B, S, D], aux [n_shards], one entry a rank of the batch and sequence
    axes: its mean is the loss term)."""
    E = num_experts

    def body(x, rtr, eg, eu, ed):
        B_l, S_l, D = x.shape
        T_l = B_l * S_l
        C = max(1, int(capacity_factor * T_l * top_k / E))
        xf = x.reshape(T_l, D)
        dispatch, combine, aux = topk_dispatch(xf, rtr, E, top_k, C,
                                               z_coef, lb_coef)
        # the ep mean is the same on every ep rank, and the output holds
        # one entry a rank: its gradient is summed over ep (pvary)
        aux = pvary(pmean(aux, mesh, axis_name), mesh, axis_name)
        # "tec,td->ecd": each global expert's slots, [E, C, D]
        expert_in = (dispatch.to(dtype).reshape(T_l, E * C).t()
                     @ xf.to(dtype)).view(E, C, D)
        # dispatch: [E = ep x E_l, C, D] -> [E_l, ep x C, D]
        expert_in = all_to_all(expert_in, mesh, axis_name, split_dim=0,
                               concat_dim=1)
        gate = expert_in @ eg.to(dtype)
        up = expert_in @ eu.to(dtype)
        out = (F.silu(gate) * up) @ ed.to(dtype)
        # return: [E_l, ep x C, D] -> [E, C, D]
        out = all_to_all(out, mesh, axis_name, split_dim=1, concat_dim=0)
        y = combine.to(dtype).reshape(T_l, E * C) @ out.reshape(E * C, D)
        return y.view(B_l, S_l, D), aux.reshape(1)

    batch, seq = ("dp", "fsdp"), ("sp", axis_name)
    x_pl = placements(mesh, (batch, seq, None), h.shape)
    r_pl = placements(mesh, (None, None))
    w_pl = placements(mesh, (axis_name, None, None), e_gate.shape)
    aux_pl = placements(mesh, (batch + seq,))
    # the gradients of the router and the experts: a sum over the ranks
    # that routed other tokens (the batch and sequence axes); tp ranks saw
    # the same ones
    r_grad = summed_over(mesh, r_pl, batch + seq)
    w_grad = summed_over(mesh, w_pl, batch + seq)
    fn = shard_map_compat(body, mesh, (x_pl, r_pl, w_pl, w_pl, w_pl),
                          (x_pl, aux_pl),
                          in_grad_specs=(x_pl, r_grad, w_grad, w_grad,
                                         w_grad))
    return fn(h, router, e_gate, e_up, e_down)
