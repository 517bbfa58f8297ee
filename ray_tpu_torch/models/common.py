"""What the port's model families share.

- ``Leaf`` and ``build_tree``: each family declares its param tree once
  (``param_spec``: the JAX package's nesting of dicts and lists, each leaf's
  shape and how JAX's ``init`` draws it), and both ``init`` and the converter
  (``models/convert.py``) walk that declaration;
- ``layer_views``: ``lax.scan`` over stacked layers becomes a Python loop over
  per-layer views, each leaf cast to the compute dtype once a call (JAX's
  ``.astype(dt)`` at use), the leaves a family keeps in f32 left as they are;
- ``gelu_tanh``: ``jax.nn.gelu`` as JAX computes it;
- ``remat``: JAX's ``jax.checkpoint`` of a layer is
  ``torch.utils.checkpoint`` of it: the layer's forward runs again in the
  backward;
- ``token_nll``: ``-log_softmax(logits)[target]`` under JAX's
  ``take_along_axis`` rules (a target outside the classes reads NaN).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Collection, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.ops.indexing import wrap_index


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One param leaf: its shape, and how ``init`` draws it — N(0, std²)
    when ``std`` is set, else every element ``fill`` (JAX's zeros/ones)."""

    shape: Tuple[int, ...]
    std: Optional[float] = None
    fill: float = 0.0


def build_tree(spec, make: Callable, path: Tuple = ()):
    """A tree of ``spec``'s nesting (dicts and lists) holding ``make(path,
    leaf)`` at each leaf; ``path`` is the keys and indices down to it."""
    if isinstance(spec, Leaf):
        return make(path, spec)
    if isinstance(spec, dict):
        return {k: build_tree(v, make, path + (k,)) for k, v in spec.items()}
    return [build_tree(v, make, path + (i,)) for i, v in enumerate(spec)]


def init_params(spec, seed: int, device: torch.device, dtype: torch.dtype,
                f32_leaves: Collection[str]):
    """Random params after ``spec``, drawn one leaf at a time on ``device``
    (the peak stays at one f32 leaf) from one generator in the spec's order.
    Leaves named in ``f32_leaves`` are stored in f32, the others in
    ``dtype``. (``jax.random`` streams cannot be reproduced: to compare with
    the JAX package, convert its params with ``models.convert``.)"""
    gen = torch.Generator(device=device).manual_seed(int(seed))

    def make(path, leaf: Leaf):
        out = torch.float32 if path[-1] in f32_leaves else dtype
        if leaf.std is None:
            return torch.full(leaf.shape, leaf.fill, dtype=out, device=device)
        x = torch.randn(leaf.shape, generator=gen, dtype=torch.float32,
                        device=device)
        x.mul_(leaf.std)
        return x.to(out)

    return build_tree(spec, make)


def layer_views(stacked: Dict[str, torch.Tensor], dtype: torch.dtype,
                f32_leaves: Collection[str]) -> List[Dict[str, torch.Tensor]]:
    """One dict of views per layer of the stacked ``[L, ...]`` leaves: one
    cast per leaf and call (a no-op on leaves already in ``dtype``), then
    one ``unbind``, so the backward stacks each leaf's gradient once. Leaves
    in ``f32_leaves`` stay f32."""
    names = list(stacked)
    per_leaf = [(stacked[n] if n in f32_leaves else stacked[n].to(dtype))
                .unbind(0) for n in names]
    return [dict(zip(names, leaves)) for leaves in zip(*per_leaf)]


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` with its default ``approximate=True``, computed as JAX
    computes it: the tanh formula op by op in ``x``'s dtype, its constants
    rounded to that dtype. In f32 this is ``F.gelu(x, approximate="tanh")``;
    in bf16 that function differs from JAX in ~40 % of elements (it works in
    f32 with exact constants, while JAX's sqrt(2/pi) alone rounds to
    0.796875)."""
    def const(v):
        return torch.tensor(v, dtype=x.dtype, device=x.device)
    inner = const(math.sqrt(2 / math.pi)) * (x + const(0.044715) * x ** 3)
    return x * (0.5 * (1.0 + torch.tanh(inner)))


def remat(fn: Callable, **kwargs) -> Callable:
    """``fn`` recomputed in the backward instead of saving its insides
    (``jax.checkpoint``); ``kwargs`` go to ``torch.utils.checkpoint``."""
    return functools.partial(checkpoint, fn, use_reentrant=False,
                             preserve_rng_state=False, **kwargs)


def token_nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """``-log_softmax(logits)[..., target]`` per position (f32 logits in,
    same shape as ``targets`` out); NaN where a target lies outside the
    classes, as JAX's ``take_along_axis`` fills it."""
    logp = torch.log_softmax(logits, dim=-1)
    idx, valid = wrap_index(targets.to(logp.device, torch.int64),
                            logp.shape[-1])
    nll = -logp.gather(-1, idx[..., None])[..., 0]
    return torch.where(valid, nll, float("nan"))
