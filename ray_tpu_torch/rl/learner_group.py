"""LearnerGroup: data-parallel learner updates over a device mesh
(counterpart of ``ray_tpu/rl/learner_group.py``).

Reference capability: ``rllib/core/learner/learner_group.py:234`` — N
DDP learner workers, each on its own GPU, gradients all-reduced by NCCL.
JAX's group is one SPMD update over a ``dp`` mesh axis, XLA's gradient
``psum`` where DDP runs its all-reduce. Here each rank of the mesh's
``dp`` axis (one process a rank: NCCL on the cards, gloo on the CPU) holds
the same learner, built from the same seed with the same numpy rngs, and
sees the same rollouts; the rebound step runs the learner's loss on the
rank's equal share of the batch-major rows, averages the gradients (and
the loss terms it reports) over ``dp`` in one all-reduce before the
learner's own gradient transforms (IMPALA's ±40 clip acts on the global
gradient, as in JAX), and every rank then takes the same optimizer step,
so the params stay replicated.

Works with any learner whose step ``impl_attr(batch, reduce_grads=None)``
takes a dict of device tensors and whose ``update`` calls it through
``step_attr`` — PPO and IMPALA/APPO in-tree. Batch-major leaves (dim 0 ==
the batch/time length) are split; side inputs (IMPALA's bootstrap
observation) stay whole. IMPALA's V-trace targets arrive in the batch,
computed over the whole fragment before the split (the recursion runs
along the split axis). SAC's and DQN's steps are not wrapped, as in JAX.
"""

from __future__ import annotations

from typing import Any, List, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh


class LearnerGroup:
    """Wrap a learner so its gradient step runs data-parallel over a
    mesh. The learner's host-side logic (GAE, replay, minibatching) is
    untouched; only its step is re-bound."""

    def __init__(self, learner: Any, *, mesh: Optional[DeviceMesh] = None,
                 num_learners: Optional[int] = None,
                 step_attr: str = "_update",
                 impl_attr: str = "_update_impl",
                 ragged: str = "replicate"):
        if ragged not in ("replicate", "truncate"):
            raise ValueError(f"ragged must be 'replicate' or 'truncate', "
                             f"got {ragged!r}")
        self.ragged = ragged
        if mesh is None:
            # the ranks of the process group are JAX's devices
            world = dist.get_world_size() if dist.is_initialized() else 1
            n = num_learners or world
            if world < n:
                raise ValueError(
                    f"num_learners={n} but only {world} devices")
            mesh = build_mesh(MeshSpec(dp=n), list(range(n)),
                              device=learner.device)
        names = tuple(mesh.mesh_dim_names or ())
        if "dp" not in names:
            raise ValueError(
                f"LearnerGroup needs a 'dp' mesh axis; mesh has {names}")
        dp = mesh.size(names.index("dp"))
        if num_learners is not None and dp != num_learners:
            raise ValueError(
                f"num_learners={num_learners} conflicts with the "
                f"mesh's dp={dp}")
        if mesh.device_type != learner.device.type:
            raise ValueError(f"the mesh is on {mesh.device_type}, the "
                             f"learner on {learner.device}")
        self.mesh = mesh
        self.num_learners = dp
        self.learner = learner
        group = mesh.get_group("dp")
        rank = mesh.get_local_rank("dp")
        impl = getattr(learner, impl_attr)

        def reduce_grads(tensors: List[torch.Tensor]) -> None:
            # the mean over dp, in place, in one all-reduce
            flat = torch.cat([t.reshape(-1) for t in tensors])
            dist.all_reduce(flat, group=group)
            flat /= dp
            for t, part in zip(tensors, flat.split([t.numel()
                                                    for t in tensors])):
                t.copy_(part.view_as(t))

        def step(batch):
            # A ragged tail (rows % dp != 0) runs whole on every rank by
            # default: truncating is unsound for time-major learners whose
            # side inputs bootstrap from the step AFTER the last row
            # (IMPALA's next_obs_last). ``ragged="truncate"`` opts
            # i.i.d.-minibatch learners (PPO) into dropping the tail,
            # where the epoch permutation re-covers those rows.
            rows = max((x.shape[0] for x in batch.values() if x.ndim >= 1),
                       default=0)
            usable = (rows // dp) * dp
            if usable == 0 or (usable != rows
                               and self.ragged == "replicate"):
                return impl(batch)

            def share(x):
                if x.ndim >= 1 and x.shape[0] == rows:
                    return x[:usable].chunk(dp)[rank]
                return x

            return impl({k: share(v) for k, v in batch.items()},
                        reduce_grads=reduce_grads)

        setattr(learner, step_attr, step)

    # the group IS the learner for the algorithm control loop
    def update(self, rollouts):
        return self.learner.update(rollouts)

    def get_weights(self):
        return self.learner.get_weights()

    def set_weights(self, weights):
        return self.learner.set_weights(weights)


def wrap_learner_data_parallel(learner: Any,
                               num_learners: Optional[int] = None,
                               ragged: str = "replicate") -> Any:
    """Convenience: in-place rebind (returns the same learner)."""
    LearnerGroup(learner, num_learners=num_learners, ragged=ragged)
    return learner
