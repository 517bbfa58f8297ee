"""MoE router math (counterpart of ``ray_tpu/ops/moe_dispatch.py``).

``topk_dispatch`` is the one-device part of the JAX module: GShard-style
top-k routing into capacity-bounded expert slots, as dense one-hot tensors
that ``models/moe.py``'s einsum scheme contracts with plain matrix products.
The JAX module's other half, ``expert_alltoall_ffn`` (explicit expert
all-to-all inside ``shard_map``), waits for the port's expert all-to-all
(ROADMAP A7b).

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
