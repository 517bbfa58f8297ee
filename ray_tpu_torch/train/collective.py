"""Worker-group collectives (counterpart of ``ray_tpu/train/collective.py``):
barrier, broadcast from rank 0, allreduce and allgather across the worker
group, met through a named rendezvous actor.

These are host-level collectives (config exchange, barriers, metric
reduction). Tensor collectives run inside the train step over the mesh's
process group (``ray_tpu_torch.parallel.collectives``).

One departure: the rendezvous actor of JAX's module outlives its group, so
a re-formed group of the same run meets the old actor, with the old world
size and the old results under the same keys. Here ``WorkerGroup.shutdown``
kills it (``kill_rendezvous``).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.train.session import get_context


class _Rendezvous:
    """Actor: collects world_size contributions per (op, seq) key."""

    def __init__(self, world_size: int):
        self.world_size = world_size
        self._slots: Dict[str, Dict[int, Any]] = {}
        self._done: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def contribute(self, key: str, rank: int, value: Any) -> None:
        with self._lock:
            slot = self._slots.setdefault(key, {})
            slot[rank] = value

    def poll(self, key: str, reducer: str) -> Any:
        """Returns (ready, result)."""
        with self._lock:
            if key in self._done:
                return True, self._done[key]
            slot = self._slots.get(key, {})
            if len(slot) < self.world_size:
                return False, None
            values = [slot[r] for r in sorted(slot)]
            if reducer == "list":
                out = values
            elif reducer == "sum":
                out = values[0]
                for v in values[1:]:
                    out = out + v
            elif reducer == "max":
                out = max(values)
            elif reducer == "min":
                out = min(values)
            elif reducer.startswith("rank:"):
                out = slot[int(reducer.split(":")[1])]
            else:
                raise ValueError(f"unknown reducer {reducer}")
            self._done[key] = out
            del self._slots[key]
            return True, out


_local = threading.local()

RENDEZVOUS_NAME = "train_collective"


def kill_rendezvous(experiment_name: str) -> None:
    """Kill a run's rendezvous actor, if one was made."""
    try:
        handle = ray_tpu_torch.get_actor(
            f"{RENDEZVOUS_NAME}_{experiment_name}")
    except ValueError:
        return
    ray_tpu_torch.kill(handle)


def _rendezvous(name: str = RENDEZVOUS_NAME):
    ctx = get_context()
    handle = getattr(_local, "rdv", None)
    if handle is None:
        full_name = f"{name}_{ctx.get_experiment_name()}"
        try:
            handle = ray_tpu_torch.get_actor(full_name)
        except Exception:
            cls = ray_tpu_torch.remote(_Rendezvous)
            try:
                # beside the ranks, which are the driver's threads: a
                # contribution may be a tensor on the card
                handle = cls.options(name=full_name,
                                     get_if_exists=True,
                                     max_concurrency=64,
                                     _in_process=True).remote(
                    ctx.get_world_size())
            except Exception:
                handle = ray_tpu_torch.get_actor(full_name)
        _local.rdv = handle
    return handle


def _collective(op: str, value: Any, reducer: str,
                timeout: float = 120.0) -> Any:
    ctx = get_context()
    seq = getattr(_local, "seq", {})
    _local.seq = seq
    seq[op] = seq.get(op, 0) + 1
    key = f"{op}:{seq[op]}"
    rdv = _rendezvous()
    ray_tpu_torch.get(rdv.contribute.remote(key, ctx.get_world_rank(), value))
    deadline = time.time() + timeout
    while time.time() < deadline:
        ready, result = ray_tpu_torch.get(rdv.poll.remote(key, reducer))
        if ready:
            return result
        time.sleep(0.005)
    raise TimeoutError(f"collective {key} timed out "
                       f"({ctx.get_world_size()} ranks expected)")


def barrier(timeout: float = 120.0) -> None:
    """All ranks block until every rank arrives."""
    _collective("barrier", None, "list", timeout)


def broadcast_from_rank_zero(value: Any = None,
                             timeout: float = 120.0) -> Any:
    """Rank 0's value is returned on every rank."""
    return _collective("broadcast", value, "rank:0", timeout)


def allreduce(value: Any, op: str = "sum", timeout: float = 120.0) -> Any:
    """Reduce a (numeric / numpy) value across ranks."""
    return _collective("allreduce", value, op, timeout)


def allgather(value: Any, timeout: float = 120.0) -> List[Any]:
    """Every rank receives the rank-ordered list of contributions."""
    return _collective("allgather", value, "list", timeout)
