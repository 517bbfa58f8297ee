"""Host-level collective communication between tasks/actors (counterpart of
``ray_tpu/util/collective/collective.py``).

Parity contract (reference ``python/ray/util/collective/collective.py:150,
187,295-660``): named groups with world_size/rank, allreduce / allgather /
reducescatter / broadcast / send / recv / barrier, met through a detached
rendezvous actor (the analogue of the reference's NCCLUniqueID exchange
through the internal KV store, ``nccl_collective_group.py:29``) that matches
ops by sequence number and performs the reduction.

Collectives inside the train step run over the mesh's process group
(:mod:`ray_tpu_torch.parallel.collectives`); this module is the
orchestration plane between actors. JAX's backend names and their check are
kept; every backend is this rendezvous. One departure (ROADMAP C): JAX's
reduction takes ``np.asarray`` of every part, which a CUDA tensor refuses;
here ``torch.Tensor`` parts reduce with torch on their own device and keep
their dtype (``reducescatter`` splits with ``torch.tensor_split``), while
numpy parts reduce as in JAX. On the in-process runtime the parts and the
result are held, not copied: a CUDA tensor stays on the card.
"""

from __future__ import annotations

import sys
import threading
from typing import Any, Dict, List, Optional

import numpy as np

import ray_tpu_torch

_local = threading.local()
_actor_groups: Dict[str, Dict[str, "GroupState"]] = {}
_actor_groups_lock = threading.Lock()


def _group_states() -> Dict[str, "GroupState"]:
    """Group registry for the calling context.

    Actors run __init__ and methods on different threads, so their groups
    are keyed by actor id; driver/task code falls back to thread-local.
    """
    from ray_tpu_torch._private import runtime_context
    ctx = runtime_context._ctx.get()
    actor_id = ctx.actor_id.hex() if (ctx and ctx.actor_id) else None
    if actor_id is not None:
        with _actor_groups_lock:
            return _actor_groups.setdefault(actor_id, {})
    if not hasattr(_local, "groups"):
        _local.groups = {}
    return _local.groups


class GroupState:
    def __init__(self, name: str, world_size: int, rank: int, coordinator):
        self.name = name
        self.world_size = world_size
        self.rank = rank
        self.coordinator = coordinator
        self.seq = 0
        self.p2p_seq: Dict[tuple, int] = {}

    def next_seq(self) -> int:
        self.seq += 1
        return self.seq

    def next_p2p_seq(self, src: int, dst: int) -> int:
        key = (src, dst)
        self.p2p_seq[key] = self.p2p_seq.get(key, 0) + 1
        return self.p2p_seq[key]


@ray_tpu_torch.remote(max_concurrency=256)
class _Coordinator:
    """Matches collective ops across ranks and computes reductions."""

    def __init__(self, world_size: int):
        import asyncio
        self.world_size = world_size
        self.ops: Dict = {}
        self.lock = asyncio.Lock()

    async def _slot(self, key):
        import asyncio
        async with self.lock:
            slot = self.ops.get(key)
            if slot is None:
                slot = self.ops[key] = {
                    "parts": {}, "event": asyncio.Event(), "result": None}
            return slot

    async def contribute(self, op: str, seq: int, rank: int, data):
        """Generic all-to-one-to-all: returns the op result for this rank."""
        import asyncio
        key = (op, seq)
        slot = await self._slot(key)
        slot["parts"][rank] = data
        if len(slot["parts"]) == self.world_size:
            slot["result"] = self._compute(op, slot["parts"])
            slot["event"].set()
        await slot["event"].wait()
        result = slot["result"]
        async with self.lock:
            slot.setdefault("consumed", 0)
            slot["consumed"] += 1
            if slot["consumed"] == self.world_size:
                self.ops.pop(key, None)
        if op.startswith(("reducescatter", "allgather_scatter")):
            return result[rank]
        return result

    def _compute(self, op: str, parts: Dict[int, Any]):
        ordered = [parts[r] for r in sorted(parts)]
        if op.startswith("allreduce"):
            reduce_op = op.split(":", 1)[1]
            return _reduce(ordered, reduce_op)
        if op.startswith("allgather"):
            return list(ordered)
        if op.startswith("reducescatter"):
            reduce_op = op.split(":", 1)[1]
            reduced = _reduce(ordered, reduce_op)
            if _is_tensor(reduced):
                import torch
                return list(torch.tensor_split(reduced, len(ordered)))
            return np.array_split(np.asarray(reduced), len(ordered))
        if op.startswith("broadcast"):
            src = int(op.split(":", 1)[1])
            return parts[src]
        if op.startswith("barrier"):
            return True
        raise ValueError(f"unknown collective op {op!r}")

    async def p2p_put(self, seq: int, dst: int, data):
        import asyncio
        key = ("p2p", seq, dst)
        slot = await self._slot(key)
        slot["result"] = data
        slot["event"].set()
        return True

    async def p2p_get(self, seq: int, dst: int):
        key = ("p2p", seq, dst)
        slot = await self._slot(key)
        await slot["event"].wait()
        result = slot["result"]
        async with self.lock:
            self.ops.pop(key, None)
        return result


def _is_tensor(x) -> bool:
    # a tensor can exist only once torch has been imported
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(x, torch.Tensor)


def _reduce(arrays: List[Any], op: str):
    if _is_tensor(arrays[0]):
        import torch
        acc = arrays[0].clone()
        take, minimum, maximum = (lambda a: a.to(acc.device),
                                  torch.minimum, torch.maximum)
    else:
        acc = np.asarray(arrays[0]).copy()
        take, minimum, maximum = np.asarray, np.minimum, np.maximum
    for a in arrays[1:]:
        a = take(a)
        if op == "sum":
            acc = acc + a
        elif op == "product":
            acc = acc * a
        elif op == "min":
            acc = minimum(acc, a)
        elif op == "max":
            acc = maximum(acc, a)
        else:
            raise ValueError(f"unknown reduce op {op!r}")
    return acc


# ---------------------------------------------------------------------------
# public API (shape-parity with ray.util.collective)
# ---------------------------------------------------------------------------

def init_collective_group(world_size: int, rank: int,
                          backend: str = "host",
                          group_name: str = "default") -> None:
    """Join a named collective group from the calling task/actor."""
    if backend not in ("host", "gloo", "xla"):
        raise ValueError(f"unknown backend {backend!r}")
    if not (0 <= rank < world_size):
        raise ValueError(f"rank {rank} out of range for world {world_size}")
    coordinator = _Coordinator.options(
        name=f"_collective_{group_name}", get_if_exists=True,
        lifetime="detached").remote(world_size)
    _group_states()[group_name] = GroupState(group_name, world_size, rank,
                                             coordinator)


def create_collective_group(actors: List, world_size: int, ranks: List[int],
                            backend: str = "host",
                            group_name: str = "default") -> None:
    """Declare a group for a set of actors (driver-side convenience).

    Each actor must still call ``init_collective_group`` (same contract as
    the reference's declarative path).
    """
    refs = [a._init_collective.remote(world_size, r, backend, group_name)
            for a, r in zip(actors, ranks)]
    ray_tpu_torch.get(refs)


def destroy_collective_group(group_name: str = "default") -> None:
    state = _group_states().pop(group_name, None)
    if state is not None and state.rank == 0:
        try:
            ray_tpu_torch.kill(state.coordinator)
        except Exception:
            pass


def _state(group_name: str) -> GroupState:
    state = _group_states().get(group_name)
    if state is None:
        raise RuntimeError(
            f"collective group {group_name!r} is not initialized in this "
            f"task/actor; call init_collective_group first")
    return state


def get_rank(group_name: str = "default") -> int:
    return _state(group_name).rank


def get_collective_group_size(group_name: str = "default") -> int:
    return _state(group_name).world_size


def allreduce(tensor, op: str = "sum", group_name: str = "default"):
    s = _state(group_name)
    return ray_tpu_torch.get(s.coordinator.contribute.remote(
        f"allreduce:{op}", s.next_seq(), s.rank, tensor))


def allgather(tensor, group_name: str = "default") -> List:
    s = _state(group_name)
    return ray_tpu_torch.get(s.coordinator.contribute.remote(
        "allgather", s.next_seq(), s.rank, tensor))


def reducescatter(tensor, op: str = "sum", group_name: str = "default"):
    s = _state(group_name)
    return ray_tpu_torch.get(s.coordinator.contribute.remote(
        f"reducescatter:{op}", s.next_seq(), s.rank, tensor))


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    s = _state(group_name)
    return ray_tpu_torch.get(s.coordinator.contribute.remote(
        f"broadcast:{src_rank}", s.next_seq(), s.rank, tensor))


def barrier(group_name: str = "default") -> None:
    s = _state(group_name)
    ray_tpu_torch.get(s.coordinator.contribute.remote(
        "barrier", s.next_seq(), s.rank, None))


def send(tensor, dst_rank: int, group_name: str = "default") -> None:
    """Point-to-point send; matched with the peer's recv by a per-(src,dst)
    channel sequence (parity: reference collective.py:567-660)."""
    s = _state(group_name)
    seq = s.next_p2p_seq(s.rank, dst_rank)
    ray_tpu_torch.get(s.coordinator.p2p_put.remote(
        (s.rank, dst_rank, seq), dst_rank, tensor))


def recv(src_rank: int, group_name: str = "default"):
    s = _state(group_name)
    seq = s.next_p2p_seq(src_rank, s.rank)
    return ray_tpu_torch.get(s.coordinator.p2p_get.remote(
        (src_rank, s.rank, seq), s.rank))
