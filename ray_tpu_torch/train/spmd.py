"""Train step on one device or a mesh (counterpart of
``ray_tpu/train/spmd.py``).

JAX builds a jitted ``step(params, opt_state, batch)`` over an optax
optimizer; with a mesh, params get NamedShardings from logical axes, batches
shard over (dp, fsdp), and jit emits the collectives. Here:

- ``optimizer`` is a factory ``params list -> torch.optim.Optimizer`` (a
  torch optimizer binds its params when it is made), and ``opt_state`` is
  that optimizer: it holds the moments. The default is
  ``torch.optim.AdamW(lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
  weight_decay=0.1)``, which is ``optax.adamw(3e-4, weight_decay=0.1)``: the
  same bias-corrected moments and the same decoupled decay on every leaf;
- JAX's donated ``(params, opt_state)`` (``donate=True``) become an in-place
  update of the same tensors: ``step_fn`` returns the objects it was given,
  updated. With ``donate=False`` the step leaves its inputs as they were and
  returns new params and a new optimizer, as JAX's undonated step does;
- with a mesh (a ``DeviceMesh`` of ``ray_tpu_torch.parallel``) and a model
  that declares ``param_shardings``, every param leaf is a DTensor with its
  family's placements, the optimizer's moments take the placements of their
  params (JAX's ``_mirror_shardings``), batches are placed with ``Shard(0)``
  over ``batch_axes``, and DTensor inserts the collectives. A model without
  ``param_shardings`` (ViT, the MLP) takes the one-device path, as in JAX;
  ``PipelinedLlama`` (``models/llama_pp.py``) trains through the same step,
  its stages' collectives inside its loss.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Mapping, Optional, Sequence

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Placement

from ray_tpu_torch.parallel.mesh import distribute, placements


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


def map_leaves(fn: Callable, params):
    """A tree of ``params``' nesting holding ``fn(leaf)`` at each tensor."""
    if isinstance(params, torch.Tensor):
        return fn(params)
    if isinstance(params, Mapping):
        return {k: map_leaves(fn, v) for k, v in params.items()}
    return [map_leaves(fn, v) for v in params]


def _full(x: torch.Tensor) -> torch.Tensor:
    return x.full_tensor() if isinstance(x, DTensor) else x


@dataclasses.dataclass
class TrainStep:
    """The train step and its companion state tools."""

    step_fn: Callable      # (params, opt_state, batch) -> (p, o, metrics)
    init_fn: Callable      # (seed) -> (params, opt_state) [sharded]
    opt_init: Callable     # (params) -> opt_state, for params made elsewhere
    device: torch.device
    mesh: Any = None
    param_shardings: Any = None   # a tree of DTensor placements
    batch_sharding: Any = None    # the placements of a batch leaf


def make_train_step(model, optimizer: Optional[Callable] = None,
                    mesh: Optional[DeviceMesh] = None, *, donate: bool = True,
                    batch_axes=("dp", "fsdp")) -> TrainStep:
    """Build the train step for a model exposing ``init(seed,
    param_dtype=...)``, ``loss(params, *batch)``, ``device`` and
    (optionally) ``param_shardings()`` (every family of
    ``ray_tpu_torch.models``). Params are f32 leaves; the forward casts them
    to the model's compute dtype. ``mesh=None`` runs on one device (the
    bench path on one card); a sharded model is built with the same
    ``mesh=``."""
    if mesh is not None and not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a DeviceMesh "
                        f"(ray_tpu_torch.parallel.build_mesh), got "
                        f"{type(mesh).__name__}")
    make_opt = optimizer or adamw
    p_sh = batch_sh = None
    if mesh is not None and hasattr(model, "param_shardings"):
        if getattr(model, "mesh", None) is not mesh:
            raise ValueError("make_train_step: build the model with the "
                             "same mesh= to train it sharded")
        p_sh = model.param_shardings()
        batch_sh = placements(mesh, (tuple(batch_axes),))
    else:
        mesh = None

    def opt_init(params):
        leaves = param_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        return make_opt(leaves)

    def init_fn(seed: int = 0):
        # on a mesh, model.init places each leaf as it is drawn, and the
        # moments are made like their params (zeros_like keeps placements)
        params = model.init(seed, param_dtype=torch.float32)
        return params, opt_init(params)

    def undonated(params, opt_state):
        """Copies of params and optimizer (moments and step counts too)
        for a step that must leave its inputs as they were."""
        new = map_leaves(lambda p: p.detach().clone(), params)
        new_opt = opt_init(new)
        state = opt_state.state_dict()
        state["state"] = {i: {k: v.clone() if torch.is_tensor(v) else v
                              for k, v in s.items()}
                          for i, s in state["state"].items()}
        new_opt.load_state_dict(state)
        return new, new_opt

    def step_fn(params, opt_state, batch, on_phase: Optional[Callable] = None):
        """One step. ``on_phase(name)``, when given, is called as each phase
        has been issued: "forward" (the loss), "backward" (the gradients
        and their norm) and "optimizer"; ``profile_train`` records a CUDA
        event there to split the step's device time. The metrics are plain
        tensors (gathered from the mesh)."""
        mark = on_phase or (lambda name: None)
        if not donate:
            params, opt_state = undonated(params, opt_state)
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
        return params, opt_state, {"loss": _full(loss.detach()),
                                   "grad_norm": _full(gnorm)}

    return TrainStep(step_fn=step_fn, init_fn=init_fn, opt_init=opt_init,
                     device=model.device, mesh=mesh, param_shardings=p_sh,
                     batch_sharding=batch_sh)


def _placement_leaves(tree) -> list:
    """The placement lists of a ``param_shardings`` tree, in
    ``param_leaves`` order."""
    if isinstance(tree, Mapping):
        return [p for v in tree.values() for p in _placement_leaves(v)]
    if tree and all(isinstance(p, Placement) for p in tree):
        return [tree]
    return [p for v in tree for p in _placement_leaves(v)]


def mirror_shardings(opt_state: dict, param_shardings) -> dict:
    """Placements for an optimizer's ``state_dict()`` in the shape
    ``Checkpoint.to_pytree`` takes: each moment takes the placements of its
    param (JAX's ``_mirror_shardings``; a torch optimizer numbers its state
    in ``param_leaves`` order), the step counts and the param groups stay
    plain."""
    pl = _placement_leaves(param_shardings)
    return {"state": {i: {k: (pl[i] if torch.is_tensor(v) and v.dim()
                              else None)
                          for k, v in s.items()}
                      for i, s in opt_state["state"].items()},
            "param_groups": None}


def shard_batch(batch, train_step: TrainStep):
    """Place a host batch on the step's device; on a mesh, with ``Shard(0)``
    over the batch axes (each rank keeps its rows)."""
    leaves = tuple(torch.as_tensor(x).to(train_step.device) for x in batch)
    if train_step.batch_sharding is None:
        return leaves
    return tuple(distribute(x, train_step.mesh, train_step.batch_sharding)
                 for x in leaves)
