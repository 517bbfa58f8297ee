"""Host-level collectives between actors (counterpart of
``ray_tpu.util.collective``, with its names)."""

from ray_tpu_torch.util.collective.collective import (
    allgather,
    allreduce,
    barrier,
    broadcast,
    create_collective_group,
    destroy_collective_group,
    get_rank,
    get_collective_group_size,
    init_collective_group,
    recv,
    reducescatter,
    send,
)

__all__ = [
    "init_collective_group", "create_collective_group",
    "destroy_collective_group", "allreduce", "allgather", "reducescatter",
    "broadcast", "send", "recv", "barrier", "get_rank",
    "get_collective_group_size",
]
