"""Differentiable collectives over one axis of a mesh: the port's
counterparts of the ``jax.lax`` primitives that sequence, expert and
pipeline parallelism call inside ``shard_map``.

Each runs on plain local tensors (inside ``shard_map_compat``) over the
process group of one named axis of ``active_mesh(mesh)``; on an axis of one
rank (or with no mesh) each is the identity and launches nothing. Their
backward is JAX's transpose under ``shard_map``, where a value is either the
same on every rank of an axis or differs between them:

- ``ppermute(x, mesh, axis, shift)``: rank ``i`` sends to ``(i + shift) %
  n`` and receives from ``(i - shift) % n`` in one ``batch_isend_irecv``;
  the backward is the reverse shift;
- ``all_to_all(x, mesh, axis, split_dim, concat_dim)``: ``jax.lax.all_to_all
  (..., tiled=True)`` on ``all_to_all_single``; the backward is the inverse
  all-to-all (split and concat dims swapped);
- ``psum``/``pmean``: an all-reduce whose result is the same on every rank
  of the axis; the backward passes the gradient through (divided by the
  axis size for ``pmean``). ``torch.distributed.nn.functional.all_reduce``
  all-reduces the gradient instead, which gives n-fold gradients in
  Megatron's psums;
- ``pvary``: the identity forward, the all-reduce backward: where a value
  that is the same on every rank of the axis enters work that differs
  between them (the input of a tensor-parallel block, a mean handed out as
  one entry per rank), its gradient is the sum of the ranks' gradients.

Every rank of a group must call the same collectives in the same order, in
the forward and in the backward: the caller keeps rank-dependent choices in
tensors (``torch.where``), never in Python branches that drop a collective's
output from one rank's graph.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ray_tpu_torch.parallel.mesh import active_mesh, axis_size


def axis_group(mesh, axis: str) -> Optional[Tuple[object, int, int]]:
    """(process group, size, this rank's index) of mesh axis ``axis``;
    ``None`` for an axis of one rank or no mesh."""
    n = axis_size(mesh, axis)
    if n == 1:
        return None
    sub = active_mesh(mesh)
    return sub.get_group(axis), n, sub.get_local_rank(axis)


def axis_index(mesh, axis: str) -> int:
    """This rank's index along ``axis`` (``jax.lax.axis_index``)."""
    g = axis_group(mesh, axis)
    return 0 if g is None else g[2]


def _shift(x: torch.Tensor, group, n: int, i: int, shift: int):
    x = x.contiguous()
    if shift % n == 0:
        return x.clone()
    out = torch.empty_like(x)
    dst = dist.get_global_rank(group, (i + shift) % n)
    src = dist.get_global_rank(group, (i - shift) % n)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, x, dst, group),
                                   dist.P2POp(dist.irecv, out, src, group)])
    for r in reqs:
        r.wait()
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, i, shift):
        ctx.args = (group, n, i, shift)
        return _shift(x, group, n, i, shift)

    @staticmethod
    def backward(ctx, grad):
        group, n, i, shift = ctx.args
        return _shift(grad, group, n, i, -shift), None, None, None, None


def ppermute(x: torch.Tensor, mesh, axis: str, shift: int = 1
             ) -> torch.Tensor:
    """``x`` of rank ``(i - shift) % n`` on rank ``i`` of ``axis``
    (``jax.lax.ppermute`` with ``perm=[(i, (i + shift) % n)]``)."""
    g = axis_group(mesh, axis)
    return x if g is None else _PPermute.apply(x, *g, shift)


def _all_to_all(x: torch.Tensor, group, n: int, split_dim: int,
                concat_dim: int) -> torch.Tensor:
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} "
                         f"is not divisible by the axis size {n}")
    send = torch.stack(x.chunk(n, dim=split_dim)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, split_dim, concat_dim):
        ctx.args = (group, n, concat_dim, split_dim)
        return _all_to_all(x, group, n, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, grad):
        return _all_to_all(grad, *ctx.args), None, None, None, None


def all_to_all(x: torch.Tensor, mesh, axis: str, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)``:
    ``x`` cut into n blocks along ``split_dim``, block j sent to rank j, the
    blocks received joined along ``concat_dim`` in rank order."""
    g = axis_group(mesh, axis)
    if g is None:
        return x
    return _AllToAll.apply(x, g[0], g[1], split_dim, concat_dim)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, scale):
        ctx.scale = scale
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out if scale == 1 else out * scale

    @staticmethod
    def backward(ctx, grad):
        return (grad if ctx.scale == 1 else grad * ctx.scale), None, None


def psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis``, the same on each; the
    gradient passes through (JAX's transpose of a psum whose result is
    replicated)."""
    g = axis_group(mesh, axis)
    return x if g is None else _PSum.apply(x, g[0], 1)


def pmean(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The mean of ``x`` over the ranks of ``axis``; the gradient is
    divided by the axis size."""
    g = axis_group(mesh, axis)
    return x if g is None else _PSum.apply(x, g[0], 1.0 / g[1])


class _PVary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        out = grad.contiguous().clone()
        dist.all_reduce(out, group=ctx.group)
        return out, None


def pvary(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``x`` as it is, its gradient summed over the ranks of ``axis``
    (``jax.lax.pvary``; Megatron's "f" operator)."""
    g = axis_group(mesh, axis)
    return x if g is None else _PVary.apply(x, g[0])
