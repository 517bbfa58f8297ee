"""Single-device train step (counterpart of ``ray_tpu/train/spmd.py`` with
``mesh=None``).

JAX builds a jitted, donated ``step(params, opt_state, batch)`` over an optax
optimizer. Here:

- ``optimizer`` is a factory ``params list -> torch.optim.Optimizer`` (a
  torch optimizer binds its params when it is made), and ``opt_state`` is
  that optimizer: it holds the moments. The default is
  ``torch.optim.AdamW(lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
  weight_decay=0.1)``, which is ``optax.adamw(3e-4, weight_decay=0.1)``: the
  same bias-corrected moments and the same decoupled decay on every leaf;
- JAX's donated ``(params, opt_state)`` become an in-place update of the
  same tensors: ``step_fn`` returns the objects it was given, updated;
- a mesh (sharded data parallelism) waits for the parallel layer.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Mapping, Optional, Sequence

import torch


def adamw(params: Sequence[torch.Tensor]) -> torch.optim.Optimizer:
    """The default optimizer: ``optax.adamw(3e-4, weight_decay=0.1)``."""
    return torch.optim.AdamW(params, lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=0.1)


def param_leaves(params) -> List[torch.Tensor]:
    """The tensors of a param tree of nested dicts and lists (the MLP's
    layers are a list), in insertion order."""
    if isinstance(params, torch.Tensor):
        return [params]
    children = params.values() if isinstance(params, Mapping) else params
    return [t for v in children for t in param_leaves(v)]


@dataclasses.dataclass
class TrainStep:
    """The train step and its companion state tools."""

    step_fn: Callable      # (params, opt_state, batch) -> (p, o, metrics)
    init_fn: Callable      # (seed) -> (params, opt_state)
    opt_init: Callable     # (params) -> opt_state, for params made elsewhere
    device: torch.device


def make_train_step(model, optimizer: Optional[Callable] = None,
                    mesh=None) -> TrainStep:
    """Build the train step for a model exposing ``init(seed,
    param_dtype=...)``, ``loss(params, *batch)`` and ``device`` (every
    family of ``ray_tpu_torch.models``). Params are f32 leaves; the forward
    casts them to the model's compute dtype."""
    if mesh is not None:
        raise NotImplementedError(
            "ray_tpu_torch.train: a mesh (sharded training) is not ported "
            "yet (ROADMAP A7); pass mesh=None for one device")
    make_opt = optimizer or adamw

    def opt_init(params):
        leaves = param_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        return make_opt(leaves)

    def init_fn(seed: int = 0):
        params = model.init(seed, param_dtype=torch.float32)
        return params, opt_init(params)

    def step_fn(params, opt_state, batch, on_phase: Optional[Callable] = None):
        """One step. ``on_phase(name)``, when given, is called as each phase
        has been issued: "forward" (the loss), "backward" (the gradients
        and their norm) and "optimizer"; ``profile_train`` records a CUDA
        event there to split the step's device time."""
        mark = on_phase or (lambda name: None)
        opt_state.zero_grad(set_to_none=True)
        loss = model.loss(params, *batch)
        mark("forward")
        loss.backward()
        grads = [p.grad for p in param_leaves(params) if p.grad is not None]
        # optax.global_norm, before the update
        gnorm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
        mark("backward")
        opt_state.step()
        mark("optimizer")
        return params, opt_state, {"loss": loss.detach(), "grad_norm": gnorm}

    return TrainStep(step_fn=step_fn, init_fn=init_fn, opt_init=opt_init,
                     device=model.device)


def shard_batch(batch, train_step: TrainStep):
    """Place a host batch on the step's device (with no mesh there is
    nothing to shard)."""
    return tuple(torch.as_tensor(x).to(train_step.device) for x in batch)
