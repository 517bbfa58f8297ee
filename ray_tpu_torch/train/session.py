"""Per-worker train session (counterpart of ``ray_tpu/train/session.py``):
``report``, ``get_context``, ``get_checkpoint`` and ``get_dataset_shard``.
Thread-local, because every worker of the in-process runtime is a thread of
one process.

One departure: JAX's ``report`` raises ``StopIteration`` once the rank's stop
event is set, but nothing of JAX's sets it. Here the worker group sets it
when it shuts a group down, so a rank that runs on after its group failed
(a thread cannot be stopped from outside) ends at its next ``report``
instead of training on with its model on the card.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint

_local = threading.local()


class TrainContext:
    def __init__(self, world_rank: int, world_size: int,
                 local_rank: int = 0, node_rank: int = 0,
                 mesh_spec=None, experiment_name: str = "",
                 latest_checkpoint: Optional[Checkpoint] = None,
                 dataset_shards: Optional[Dict[str, Any]] = None):
        self._world_rank = world_rank
        self._world_size = world_size
        self._local_rank = local_rank
        self._node_rank = node_rank
        self._mesh_spec = mesh_spec
        self._experiment_name = experiment_name
        self._latest_checkpoint = latest_checkpoint
        self._dataset_shards = dataset_shards or {}
        self._report_cb = None
        self._stop_event = threading.Event()

    def get_world_rank(self) -> int:
        return self._world_rank

    def get_world_size(self) -> int:
        return self._world_size

    def get_local_rank(self) -> int:
        return self._local_rank

    def get_node_rank(self) -> int:
        return self._node_rank

    def get_experiment_name(self) -> str:
        return self._experiment_name

    def get_mesh_spec(self):
        return self._mesh_spec


def get_context() -> TrainContext:
    ctx = getattr(_local, "ctx", None)
    if ctx is None:
        raise RuntimeError("ray_tpu_torch.train session: not inside a train "
                           "worker (get_context() called outside fit())")
    return ctx


def _set_context(ctx: Optional[TrainContext]) -> None:
    _local.ctx = ctx


def report(metrics: Dict[str, Any],
           checkpoint: Optional[Checkpoint] = None) -> None:
    """Report metrics (and a checkpoint) from a train worker: every rank
    calls it each iteration; rank 0's checkpoint is kept."""
    ctx = get_context()
    entry = {"metrics": dict(metrics), "checkpoint": checkpoint,
             "rank": ctx._world_rank}
    if ctx._report_cb is not None:
        ctx._report_cb(entry)
    if ctx._stop_event.is_set():
        raise StopIteration("train run stopped by controller")


def get_checkpoint() -> Optional[Checkpoint]:
    """The latest kept checkpoint (to resume inside the train function)."""
    return get_context()._latest_checkpoint


def get_dataset_shard(name: str = "train"):
    """This worker's shard of a dataset passed to the trainer."""
    ctx = get_context()
    shard = ctx._dataset_shards.get(name)
    if shard is None:
        raise KeyError(f"no dataset shard named {name!r} "
                       f"(have {list(ctx._dataset_shards)})")
    return shard
