"""Utilities of the port (counterpart of ``ray_tpu/util``, with its names):
placement groups, the scheduling strategies, the in-process metrics
registry (``util.metrics``), ``ActorPool`` and ``Queue`` (imported on first
use, as in JAX's package), ``util.multiprocessing.Pool`` and the host-level
collectives of ``util.collective``."""

from ray_tpu_torch.util.placement_group import (PlacementGroup,
                                                placement_group,
                                                placement_group_table,
                                                remove_placement_group)

__all__ = [
    "PlacementGroup", "placement_group", "remove_placement_group",
    "placement_group_table", "ActorPool", "Queue",
]


def __getattr__(name):
    if name == "ActorPool":
        from ray_tpu_torch.util.actor_pool import ActorPool
        return ActorPool
    if name == "Queue":
        from ray_tpu_torch.util.queue import Queue
        return Queue
    raise AttributeError(name)
