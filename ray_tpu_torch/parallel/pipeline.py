"""Pipeline parallelism as one SPMD program (counterpart of
``ray_tpu/parallel/pipeline.py``).

As in JAX, the pipeline is a program every rank runs, not a set of actors:
each group of ranks along the ``pp`` axis holds one stage's weights, the
microbatch activations move to the next stage with
``parallel.collectives.ppermute``, and autograd through the schedule is
the backward pipeline. The schedule is GPipe's fill and drain:
``num_microbatches + num_stages - 1`` ticks; at tick t stage 0 takes
microbatch t and the last stage emits microbatch ``t - (num_stages - 1)``.

Every rank runs the same exchanges in the same order, forward and
backward: which input a stage takes and whether it keeps an output are
tensor conditions (``torch.where``, JAX's ``jnp.where``), so the received
activation stays in stage 0's graph too and its exchange runs backward on
every rank. A Python ``if`` on the stage index would drop it from stage 0's
graph, and stage 1 would then wait for a gradient that never comes.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from ray_tpu_torch.parallel.collectives import axis_index, ppermute, psum
from ray_tpu_torch.parallel.mesh import (axis_size, placements,
                                         shard_map_compat, summed_over)


def pipeline_apply(stage_fn: Callable, local_params: Any,
                   microbatches: torch.Tensor, *, mesh,
                   axis_name: str = "pp", num_stages: int,
                   num_microbatches: int) -> torch.Tensor:
    """Run ``microbatches`` [M, ...] (the same on every stage) through the
    stage pipeline, on this rank's local tensors (inside
    ``shard_map_compat``). ``stage_fn(params, x) -> y`` keeps the shape of
    ``x``. Returns the last stage's outputs [M, ...], on every stage (a sum
    over pp of the outputs masked to the last stage)."""
    stage = axis_index(mesh, axis_name)
    dev = microbatches.device
    first = torch.tensor(stage == 0, device=dev)
    last = torch.tensor(stage == num_stages - 1, device=dev)
    n_ticks = num_microbatches + num_stages - 1
    act = torch.zeros_like(microbatches[0])
    outputs = [torch.zeros_like(microbatches[0])] * num_microbatches
    for t in range(n_ticks):
        fresh = microbatches[min(t, num_microbatches - 1)]
        y = stage_fn(local_params, torch.where(first, fresh, act))
        out_idx = t - (num_stages - 1)
        if out_idx >= 0:
            outputs[out_idx] = torch.where(last, y, outputs[out_idx])
        if t < n_ticks - 1:        # JAX's last exchange: nothing reads it
            act = ppermute(y, mesh, axis_name, 1)
    out = torch.stack(outputs)
    return psum(out * last.to(out.dtype), mesh, axis_name)


def pipelined(stage_fn: Callable, mesh, *, num_microbatches: int,
              axis_name: str = "pp", param_specs: Optional[Any] = None,
              batch_axes: Tuple[str, ...] = ("dp", "fsdp")) -> Callable:
    """Wrap a stage function into a full-batch pipelined forward
    ``f(stacked_params, batch) -> outputs``:

    - ``stacked_params``: a tensor or a dict of tensors (DTensors on
      ``mesh``), each with a leading ``num_stages`` dim over ``axis_name``;
    - ``batch``: [global_batch, ...] over ``batch_axes``, cut into
      ``num_microbatches`` microbatches of each rank's rows;
    - ``param_specs``: the params' specs, a tree of their shape whose
      leaves are spec tuples with ``axis_name`` first (default: the stage
      dim over ``axis_name``, the rest whole), so stage weights may also
      shard over other axes (Megatron tp): ``stage_fn`` sees its local
      shards and runs the matching collectives.

    A param's gradient is a sum over ``batch_axes`` (each rank saw other
    rows); the batch's gradient a sum over ``axis_name`` (only stage 0
    reads it)."""
    num_stages = axis_size(mesh, axis_name)

    def run(stacked_params, batch):
        leaves, tree = pytree.tree_flatten(stacked_params)
        if param_specs is None:
            specs = [(axis_name,) + (None,) * (p.dim() - 1) for p in leaves]
        else:
            specs = pytree.tree_leaves(
                param_specs, is_leaf=lambda s: isinstance(s, tuple))
            if len(specs) != len(leaves):
                raise ValueError(f"param_specs: {len(specs)} specs for "
                                 f"{len(leaves)} params")
        if batch.shape[0] % num_microbatches:
            raise ValueError(f"batch {batch.shape[0]} not divisible by "
                             f"num_microbatches={num_microbatches}")

        def inner(x, *local):
            # the stage dim of each local param has size 1
            params = pytree.tree_unflatten([p[0] for p in local], tree)
            mb = x.reshape((num_microbatches, -1) + tuple(x.shape[1:]))
            out = pipeline_apply(stage_fn, params, mb, mesh=mesh,
                                 axis_name=axis_name, num_stages=num_stages,
                                 num_microbatches=num_microbatches)
            return out.reshape((-1,) + tuple(out.shape[2:]))

        if mesh is None:
            return inner(batch, *leaves)
        p_pl = [placements(mesh, s, p.shape) for s, p in zip(specs, leaves)]
        x_pl = placements(mesh, (tuple(batch_axes),)
                          + (None,) * (batch.dim() - 1), batch.shape)
        grads = [summed_over(mesh, pl, batch_axes) for pl in p_pl]
        fn = shard_map_compat(
            inner, mesh, (x_pl, *p_pl), x_pl,
            in_grad_specs=(summed_over(mesh, x_pl, (axis_name,)), *grads))
        return fn(batch, *leaves)

    return run
