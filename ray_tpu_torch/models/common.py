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
  ``take_along_axis`` rules (a target outside the classes reads NaN);
- on a mesh (``ray_tpu_torch.parallel``): ``model_device`` (a model on a
  mesh runs on the mesh's device type), ``leaf_shardings`` (a family's
  ``param_logical_axes`` as a tree of DTensor placements, JAX's
  ``param_shardings``), ``as_global`` (a host tensor placed on the mesh) and
  ``embed_lookup``, the vocab-parallel embedding.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Collection, Dict, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.ops.indexing import gather_index, wrap_index
from ray_tpu_torch.parallel.mesh import (active_mesh, distribute,
                                         named_sharding, shard_map_compat)


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


def at_path(tree, path: Tuple):
    """The node of ``tree`` at ``path`` (keys and indices, ``build_tree``'s
    paths)."""
    for key in path:
        tree = tree[key]
    return tree


def init_params(spec, seed: int, device: torch.device, dtype: torch.dtype,
                f32_leaves: Collection[str], mesh=None, shardings=None):
    """Random params after ``spec``, drawn one leaf at a time on ``device``
    (the peak stays at one f32 leaf) from one generator in the spec's order.
    Leaves named in ``f32_leaves`` are stored in f32, the others in
    ``dtype``. With a ``mesh``, each whole leaf is distributed with its
    placements in ``shardings`` (a tree of ``spec``'s shape) as soon as it
    is drawn: a sharded init draws the same numbers. (``jax.random``
    streams cannot be reproduced: to compare with the JAX package, convert
    its params with ``models.convert``.)"""
    gen = torch.Generator(device=device).manual_seed(int(seed))

    def make(path, leaf: Leaf):
        out = torch.float32 if path[-1] in f32_leaves else dtype
        if leaf.std is None:
            x = torch.full(leaf.shape, leaf.fill, dtype=out, device=device)
        else:
            x = torch.randn(leaf.shape, generator=gen, dtype=torch.float32,
                            device=device)
            x = x.mul_(leaf.std).to(out)
        return x if mesh is None else distribute(x, mesh,
                                                 at_path(shardings, path))

    return build_tree(spec, make)


def model_device(device: DeviceLike, mesh) -> torch.device:
    """A model's device: ``device`` as given, else the device type of its
    mesh, else the card."""
    if device is None and mesh is not None:
        device = mesh.device_type
    return resolve_device(device)


def leaf_shardings(spec, axes, mesh, rules=None):
    """The tree of ``spec`` holding each leaf's placements on ``mesh``: the
    logical names at the same path of ``axes`` (the family's
    ``param_logical_axes``) under ``rules``; raises where a mesh axis does
    not divide its dim."""
    def make(path, leaf: Leaf):
        return named_sharding(mesh, *at_path(axes, path), rules=rules,
                              shape=leaf.shape)
    return build_tree(spec, make)


def as_global(x, mesh, *names: Optional[str], rules=None,
              device: DeviceLike = None) -> DTensor:
    """``x`` on ``mesh`` with the placements of ``names``: a DTensor is
    moved there, a host or local tensor is taken as the global value (the
    same on every rank) and each rank keeps its chunk."""
    want = named_sharding(mesh, *names, rules=rules, shape=x.shape)
    if isinstance(x, DTensor):
        if tuple(x.placements) == tuple(want):
            return x
        return x.redistribute(active_mesh(mesh), want)
    return distribute(torch.as_tensor(x, device=device), mesh, want)


def embed_lookup(table, tokens, mesh, rules=None, *, clamp: bool,
                 dtype: torch.dtype):
    """Vocab-parallel embedding lookup on a mesh (JAX's ``shard_map`` of a
    gather and a ``psum`` in ``LlamaModel._embed_lookup``): ``table`` [V, D]
    keeps its placements (vocab over tp, D over fsdp) and never moves; each
    tp rank looks up the ids in its vocab range for its dp share of
    ``tokens`` [B, S], zeroes the others, and the sum over tp is left to the
    next constraint (``Partial``), one all-reduce of [B, S, D] activations.
    ``clamp``: ids are first clamped into the table (JAX's plain gather);
    otherwise an id outside every rank's range reads zeros (JAX's lookup
    with tp > 1). Returns [B, S, D] in ``dtype``, batch over dp, D over
    fsdp, and the sequence over sp where sp (above 1) divides it, as JAX
    shards it."""
    V = table.shape[0]
    mesh = active_mesh(mesh)
    names = mesh.mesh_dim_names
    table_pl = named_sharding(mesh, "vocab", "embed_in", rules=rules,
                              shape=table.shape)
    vocab_dims = [i for i, p in enumerate(table_pl) if p == Shard(0)]
    if len(vocab_dims) > 1:
        raise NotImplementedError("embed_lookup: the vocabulary sharded "
                                  "over more than one mesh axis")
    if vocab_dims:
        vshard = V // mesh.size(vocab_dims[0])
        start = mesh.get_local_rank(vocab_dims[0]) * vshard
    else:
        vshard, start = V, 0
    # tokens: batch over dp only (each fsdp rank looks up its D-slice of
    # the same rows), the sequence over sp where sp divides it (a decode
    # step's one token does not); out: [B, S, D] batch over dp, sequence
    # over sp, D where the table's D is, the vocab axis a sum still to do
    split = {"dp": 0}
    if "sp" in names and tokens.shape[1] % mesh.size(names.index("sp")) == 0:
        split["sp"] = 1
    tok_pl = [Shard(split[n]) if n in split else Replicate() for n in names]
    out_pl = [Shard(split[n]) if n in split else Partial() if p == Shard(0)
              else Shard(2) if p == Shard(1) else Replicate()
              for n, p in zip(names, table_pl)]
    # each dp (and sp) rank saw its share of the tokens: the table's
    # gradient is a sum over those axes
    grad_pl = [Partial() if n in split else p
               for n, p in zip(names, table_pl)]
    if not isinstance(tokens, DTensor):
        tokens = distribute(torch.as_tensor(tokens).to(table.device), mesh,
                            tok_pl)
    if clamp:
        tokens = gather_index(tokens, V)

    def lookup(table_local, tok):
        local = tok - start
        valid = (local >= 0) & (local < vshard)
        safe = torch.where(valid, local, 0)
        return (table_local[safe] * valid[..., None]).to(dtype)

    fn = shard_map_compat(lookup, mesh, (table_pl, tok_pl), out_pl,
                          in_grad_specs=(grad_pl, tok_pl))
    return fn(table, tokens)


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
    def const(v):      # v rounded to x's dtype, as a Python scalar
        return torch.tensor(v, dtype=x.dtype).item()
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
    classes, as JAX's ``take_along_axis`` fills it. On DTensor logits the
    class dim is gathered whole first (an all-gather over tp where the
    vocabulary is sharded, an all-reduce where it is a sum still to do) and
    each rank works on its rows."""
    if isinstance(logits, DTensor):
        mesh, last = logits.device_mesh, logits.ndim - 1
        pl = [Replicate() if p.is_shard(last) or p.is_partial() else p
              for p in logits.placements]
        if not isinstance(targets, DTensor):
            targets = distribute(torch.as_tensor(targets).to(logits.device),
                                 mesh, pl)
        return shard_map_compat(token_nll, mesh, (pl, pl), pl)(logits,
                                                                targets)
    logp = torch.log_softmax(logits, dim=-1)
    idx, valid = wrap_index(targets.to(logp.device, torch.int64),
                            logp.shape[-1])
    nll = -logp.gather(-1, idx[..., None])[..., 0]
    return torch.where(valid, nll, float("nan"))
