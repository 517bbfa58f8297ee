"""Actor-based streaming hash shuffle (counterpart of
``ray_tpu/data/hash_shuffle.py``, the same code on the port's actors).

Reference capability: `python/ray/data/_internal/execution/operators/
hash_shuffle.py:339` — stateful aggregator actors receive partition
shards AS THEY STREAM from the map side and finalize each partition,
instead of a barrier reduce task that takes every map's output as one
call's arguments.

Shape here: ``n_aggregators`` actors each own ``n_out / n_aggregators``
partitions. Every upstream block runs one partition task; each of its
``n_out`` shards is immediately forwarded to the owning aggregator
(``add_shard``), so accumulation overlaps with the remaining partition
work and no task ever materializes O(num_blocks) arguments. Actor calls
execute in submission order, so a ``finalize`` submitted after all
``add_shard`` calls sees the complete partition. Aggregators are killed
once every finalized partition has materialized.

All shuffle-family operators ride this path: repartition, random
shuffle, sort (after the sampling pass picks range bounds), hash
aggregate, and hash join (two tagged input sides into the same
aggregators).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Sequence, Tuple


class ShuffleAggregator:
    """Stateful reducer actor: accumulates shards per (partition, tag)
    and finalizes one partition at a time."""

    def __init__(self):
        self._shards: Dict[Tuple[int, str], List[Any]] = {}
        self._rows_in = 0

    def add_shard(self, part: int, tag: str, shard) -> int:
        self._shards.setdefault((part, tag), []).append(shard)
        self._rows_in += shard.num_rows
        return shard.num_rows

    def finalize(self, part: int, fin: Callable, args: tuple, *deps):
        """Reduce everything received for ``part``. ``fin`` gets a
        {tag: [blocks]} dict (tags matter only for joins). ``deps`` are
        the partition's add_shard results — passing them as ARGUMENTS
        makes the dataflow explicit, so finalize cannot run until every
        shard for this partition has been delivered (actor submission
        order alone does not gate on calls whose args are in flight)."""
        mine = {tag: blocks
                for (p, tag), blocks in self._shards.items() if p == part}
        for tag in mine:
            del self._shards[(part, tag)]
        return fin(mine, *args)

    def stats(self) -> Dict[str, int]:
        return {"rows_in": self._rows_in,
                "pending_partitions": len(self._shards)}


def run_streaming_shuffle(
        sides: Sequence[Tuple[str, Sequence[Any], Callable, tuple]],
        n_out: int,
        finalize_fn: Callable,
        finalize_args: Callable[[int], tuple],
        num_aggregators: int = 8) -> List[Any]:
    """Drive a full streaming shuffle.

    sides: [(tag, block_refs, partition_task_fn, partition_args)] —
        one entry for most operators, two for joins. The partition task
        is called as ``fn(block, *partition_args)`` and must return
        ``n_out`` blocks (or one when n_out == 1).
    finalize_fn(shards_by_tag, *finalize_args(p)) -> Block.
    Returns one output ref per partition, in partition order.
    """
    import ray_tpu_torch

    n_agg = max(1, min(num_aggregators, n_out))
    agg_cls = ray_tpu_torch.remote(ShuffleAggregator)
    actors = [agg_cls.remote() for _ in range(n_agg)]

    def owner(p: int):
        return actors[p % n_agg]

    adds: List[List[Any]] = [[] for _ in range(n_out)]
    for tag, refs, ptask, pargs in sides:
        remote_p = ray_tpu_torch.remote(ptask)
        for r in refs:
            parts = remote_p.options(num_returns=n_out).remote(r, *pargs)
            if not isinstance(parts, list):
                parts = [parts]
            for p, shard in enumerate(parts):
                adds[p].append(owner(p).add_shard.remote(p, tag, shard))
    outs = [owner(p).finalize.remote(p, finalize_fn, finalize_args(p),
                                     *adds[p])
            for p in range(n_out)]
    _kill_when_done(actors, list(outs))
    return outs


def _kill_when_done(actors: List[Any], outs: List[Any]) -> None:
    """Reap the per-shuffle aggregator actors once every finalized
    partition block has materialized (results live in the object store
    independently of the actor)."""
    import ray_tpu_torch

    def reap():
        # kill ONLY once every output has actually materialized — a
        # shuffle slower than any fixed timeout must never lose its
        # aggregators mid-computation. (Daemon thread: abandoned runs
        # die with the process.)
        pending = list(outs)
        while pending:
            try:
                done, pending = ray_tpu_torch.wait(
                    pending, num_returns=len(pending), timeout=60)
            except Exception:
                return   # runtime shut down: actors are gone anyway
        for a in actors:
            try:
                ray_tpu_torch.kill(a)
            except Exception:
                pass

    threading.Thread(target=reap, daemon=True,
                     name="shuffle-aggregator-reaper").start()
