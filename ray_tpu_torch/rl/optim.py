"""Optax's two optimizers as the RL learners use them.

It has no JAX module of its own: the JAX learners call ``optax.adam(lr)``
(PPO, DQN, SAC) and ``optax.rmsprop(lr, decay=0.99, eps=0.1)`` (IMPALA,
APPO).

- ``adam``: ``torch.optim.Adam`` with optax's defaults, the same
  ``lr·m̂/(√v̂+ε)``; both start from zero moments.
- ``RMSprop``: optax 0.2.6's ``rmsprop`` at its defaults
  (``eps_in_sqrt=True``, ``initial_scale=0``, no momentum, not centered):
  ``ν ← (1−decay)·g² + decay·ν``, ``p ← p − lr·g·rsqrt(ν+ε)``.
  ``torch.optim.RMSprop`` divides by ``√ν+ε`` instead, which at ε = 0.1
  differs from the first step.
"""

from __future__ import annotations

from typing import Iterable

import torch


def adam(params: Iterable[torch.Tensor], lr: float) -> torch.optim.Adam:
    """``optax.adam(lr)``."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


class RMSprop(torch.optim.Optimizer):
    """``optax.rmsprop(lr, decay, eps)``, each product in optax's order."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float,
                 decay: float = 0.9, eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            nus = [self.state[p].setdefault("nu", torch.zeros_like(p))
                   for p in params]
            decay = group["decay"]
            torch._foreach_mul_(nus, decay)
            torch._foreach_add_(nus, torch._foreach_mul(
                torch._foreach_mul(grads, grads), 1 - decay))
            updates = torch._foreach_mul(torch._foreach_rsqrt(
                torch._foreach_add(nus, group["eps"])), grads)
            torch._foreach_mul_(updates, -group["lr"])
            torch._foreach_add_(params, updates)
        return loss
