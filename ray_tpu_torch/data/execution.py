"""Streaming execution: physical operators over the port's tasks and actors
(counterpart of ``ray_tpu/data/execution.py``: the same operators, on
``ray_tpu_torch``'s runtime and the port's numpy blocks).

Reference: `data/_internal/execution/streaming_executor.py:52,99,271,325`
(scheduling loop, `select_operator_to_run` hot loop
`streaming_executor_state.py:643`, backpressure policies, actor-pool map
operator). The shape is preserved — pull-based streaming topology with
per-operator in-flight caps and bounded output queues — on the runtime's tasks;
all-to-all ops (shuffle/sort/repartition/aggregate) are materialization
barriers exactly as in the reference.
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import (Block, BlockAccessor, block_from_batch,
                                block_from_rows, concat_blocks, split_block)
from ray_tpu_torch.data import logical as L

DEFAULT_MAX_IN_FLIGHT = 8       # concurrent tasks per operator
DEFAULT_MAX_OUT_QUEUE = 16      # blocks buffered between operators


# ---------------------------------------------------------------------------
# Block transform payloads (run inside remote tasks; must be picklable)
# ---------------------------------------------------------------------------

def _apply_stage(block: Block, stage) -> Block:
    acc = BlockAccessor(block)
    if isinstance(stage, L.MapBatches):
        batch = acc.to_batch(stage.batch_format)
        out = stage.fn(batch)
        return block_from_batch(out)
    if isinstance(stage, L.MapRows):
        rows = acc.to_rows()
        if stage.kind == "map":
            return block_from_rows([stage.fn(r) for r in rows])
        if stage.kind == "filter":
            return block_from_rows([r for r in rows if stage.fn(r)])
        if stage.kind == "flat_map":
            return block_from_rows(
                [o for r in rows for o in stage.fn(r)])
    raise TypeError(f"unknown stage {stage!r}")


def _map_block_task(block: Block, stages) -> Block:
    for stage in stages:
        block = _apply_stage(block, stage)
    return block


def _read_task(read_fn: Callable) -> Block:
    return read_fn()


class _MapWorker:
    """Actor for stateful (fn_constructor) map_batches."""

    def __init__(self, ctor, batch_format: str):
        self.fn = ctor()
        self.batch_format = batch_format

    def apply(self, block: Block) -> Block:
        batch = BlockAccessor(block).to_batch(self.batch_format)
        return block_from_batch(self.fn(batch))


# ---------------------------------------------------------------------------
# Physical operators
# ---------------------------------------------------------------------------

class PhysicalOperator:
    """One stage of the streaming topology."""

    def __init__(self, name: str, max_in_flight: int = DEFAULT_MAX_IN_FLIGHT):
        self.name = name
        self.inqueue: collections.deque = collections.deque()
        self.outqueue: collections.deque = collections.deque()
        self.active: Dict[Any, bool] = {}   # ref -> True
        self.max_in_flight = max_in_flight
        self.inputs_done = False
        self.downstream: Optional[PhysicalOperator] = None

    # -- scheduling hooks --
    def can_launch(self, max_out: int) -> bool:
        return (bool(self.inqueue) and len(self.active) < self.max_in_flight
                and len(self.outqueue) + len(self.active) < max_out)

    def launch(self) -> None:
        raise NotImplementedError

    def on_task_done(self, ref, error: Optional[Exception],
                     value: Any = None) -> None:
        self.active.pop(ref, None)
        if error is not None:
            raise error
        self.outqueue.append(ref)

    def maybe_autoscale(self) -> None:
        """Hook: operators with elastic resources resize here per tick."""

    def done(self) -> bool:
        return (self.inputs_done and not self.inqueue and not self.active)

    def shutdown(self) -> None:
        pass


class SourceOperator(PhysicalOperator):
    """Feeds read tasks / pre-materialized refs."""

    def __init__(self, name: str, read_fns: List[Callable] = None,
                 refs: List[Any] = None, owner=None):
        super().__init__(name)
        self._read_fns = list(read_fns or [])
        self._refs = list(refs or [])
        self.inqueue.extend(range(len(self._read_fns)) if self._read_fns
                            else [])
        if not self._read_fns:
            self.outqueue.extend(self._refs)
        self.inputs_done = True
        self._task = ray_tpu_torch.remote(_read_task)

    def can_launch(self, max_out: int) -> bool:
        return (bool(self.inqueue) and len(self.active) < self.max_in_flight
                and len(self.outqueue) + len(self.active) < max_out)

    def launch(self) -> None:
        idx = self.inqueue.popleft()
        ref = self._task.remote(self._read_fns[idx])
        self.active[ref] = True


class MapOperator(PhysicalOperator):
    def __init__(self, name: str, stages: List[L.LogicalOp]):
        super().__init__(name)
        self.stages = stages
        self._task = ray_tpu_torch.remote(_map_block_task)

    def launch(self) -> None:
        block_ref = self.inqueue.popleft()
        ref = self._task.remote(block_ref, self.stages)
        self.active[ref] = True


class ActorPoolMapOperator(PhysicalOperator):
    """Stateful map over an ELASTIC pool of actors (reference:
    `execution/operators/actor_pool_map_operator.py` + per-op actor-pool
    autoscaling): concurrency=(min, max) or n. The pool grows while the
    input queue outruns the workers and shrinks (idle kill) when input
    dries up — per-operator dynamic sizing, not a static cap."""

    _IDLE_TICKS_BEFORE_SHRINK = 40

    def __init__(self, name: str, op: L.MapBatches):
        if op.concurrency:
            self.min_size, self.max_size = op.concurrency
        else:
            self.min_size, self.max_size = 2, 2
        super().__init__(name, max_in_flight=self.max_size)
        self._op = op
        self._worker_cls = ray_tpu_torch.remote(_MapWorker)
        self.workers = [self._make_worker()
                        for _ in range(self.min_size)]
        self._next = 0
        self._idle_ticks = 0

    def _make_worker(self):
        return self._worker_cls.remote(self._op.fn_constructor,
                                       self._op.batch_format)

    def launch(self) -> None:
        block_ref = self.inqueue.popleft()
        w = self._next % len(self.workers)
        self._next += 1
        worker = self.workers[w]
        ref = worker.apply.remote(block_ref)
        self.active[ref] = worker   # ref -> owning worker (shrink safety)

    def can_launch(self, max_out: int) -> bool:
        return (bool(self.inqueue)
                and len(self.active) < len(self.workers)
                and len(self.outqueue) + len(self.active) < max_out)

    def maybe_autoscale(self) -> None:
        backlog = len(self.inqueue)
        busy = len(self.active)
        if (backlog > 0 and busy == len(self.workers)
                and len(self.workers) < self.max_size):
            # the POOL is the binding constraint (all workers busy and
            # work queuing — not a downstream-backpressure veto): grow
            self.workers.append(self._make_worker())
            self._idle_ticks = 0
            return
        if backlog == 0 and busy < len(self.workers):
            self._idle_ticks += 1
            if (self._idle_ticks >= self._IDLE_TICKS_BEFORE_SHRINK
                    and len(self.workers) > self.min_size):
                # only shrink a worker with NO in-flight task
                busy_workers = set(id(w) for w in self.active.values())
                for i in range(len(self.workers) - 1, -1, -1):
                    if id(self.workers[i]) not in busy_workers:
                        victim = self.workers.pop(i)
                        self._idle_ticks = 0
                        try:
                            ray_tpu_torch.kill(victim)
                        except Exception:
                            pass
                        break
        else:
            self._idle_ticks = 0

    def shutdown(self) -> None:
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass


def _limit_slice_task(block: Block, remaining: int):
    n = block.num_rows
    taken = min(n, remaining)
    out = block if taken == n else block.slice(0, taken)
    return out, taken


class LimitOperator(PhysicalOperator):
    """Streaming limit WITHOUT blocking the scheduling loop: each block
    is sliced by a remote task (num_returns=2: block + rows-taken); the
    loop learns the consumed count from the tiny inline second return.
    Sequential (max_in_flight=1) so the budget is exact."""

    def __init__(self, limit: int):
        super().__init__(f"limit={limit}", max_in_flight=1)
        self.remaining = limit
        self._slice = ray_tpu_torch.remote(_limit_slice_task).options(
            num_returns=2)
        self._taken_refs: Dict[Any, Any] = {}

    def can_launch(self, max_out: int) -> bool:
        return (bool(self.inqueue) and not self.active
                and self.remaining > 0)

    def launch(self) -> None:
        ref = self.inqueue.popleft()
        block_ref, taken_ref = self._slice.remote(ref, self.remaining)
        self.active[block_ref] = True
        self._taken_refs[block_ref] = taken_ref

    def on_task_done(self, ref, error: Optional[Exception],
                     value: Any = None) -> None:
        self.active.pop(ref, None)
        taken_ref = self._taken_refs.pop(ref, None)
        if error is not None:
            raise error
        if taken_ref is not None:
            self.remaining -= int(ray_tpu_torch.get(taken_ref))
        self.outqueue.append(ref)

    def done(self) -> bool:
        return super().done() or (self.remaining <= 0
                                  and not self.active)


# ---------------------------------------------------------------------------
# All-to-all barriers (materializing)
# ---------------------------------------------------------------------------

def _split_task(block: Block, n: int):
    out = split_block(block, n)
    return out if n > 1 else out[0]


def _sort_block_task(block: Block, key: str, descending: bool) -> Block:
    return block.sort_by([(key, "descending" if descending
                           else "ascending")])


def _range_partition_task(block: Block, key: str, bounds: List,
                          descending: bool) -> List[Block]:
    col = block.to_numpy(key)
    idx = np.searchsorted(np.asarray(bounds), col, side="right")
    out = [block.take(np.nonzero(idx == p)[0])
           for p in range(len(bounds) + 1)]
    return out if len(out) > 1 else out[0]


def _stable_hash(x) -> int:
    """Deterministic across interpreters/hosts (builtin hash() is salted
    by PYTHONHASHSEED for str/bytes — two join sides running in different
    worker processes would partition differently and drop matches).

    Preserves builtin hash()'s equality invariant for keys that compare
    equal across numeric types: True == 1 == 1.0 and -0.0 == 0.0 must all
    land in the same partition."""
    import math
    import zlib
    if isinstance(x, bytes):
        b = x
    elif isinstance(x, str):
        b = x.encode()
    elif isinstance(x, (bool, np.bool_, int, np.integer)) or (
            isinstance(x, (float, np.floating)) and math.isfinite(x)
            and float(x).is_integer() and abs(x) < 2**63):
        # one canonical encoding for all integral numerics (incl. -0.0)
        b = int(x).to_bytes(16, "little", signed=True)
    elif isinstance(x, (float, np.floating)):
        b = np.float64(x).tobytes()
    else:
        b = repr(x).encode()
    return zlib.crc32(b)


def _hash_partition_task(block: Block, key: str, n: int) -> List[Block]:
    col = block.to_numpy(key)
    h = np.asarray([_stable_hash(x) % n for x in col], np.int64)
    out = [block.take(np.nonzero(h == p)[0]) for p in range(n)]
    return out if n > 1 else out[0]


def _perm_partition_task(block: Block, n: int, seed) -> List[Block]:
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, block.num_rows)
    out = [block.take(np.nonzero(idx == p)[0]) for p in range(n)]
    return out if n > 1 else out[0]


def _shuffle_reduce_task(seed, part_idx, *blocks: Block) -> Block:
    block = concat_blocks(blocks)
    rng = np.random.default_rng(None if seed is None else seed + part_idx)
    return block.take(rng.permutation(block.num_rows))


def _fin_concat(shards: Dict) -> Block:
    return concat_blocks(shards.get("d", []))


def _fin_shuffle(shards: Dict, seed, part_idx: int) -> Block:
    return _shuffle_reduce_task(seed, part_idx, *shards.get("d", []))


def _fin_sort(shards: Dict, key: str, descending: bool) -> Block:
    return _sort_block_task(concat_blocks(shards.get("d", [])),
                            key, descending)


def run_all_to_all(op: L.AllToAll, block_refs: List[Any]) -> List[Any]:
    """Execute an all-to-all over already-computed blocks: partition
    shards stream into stateful aggregator actors as they land
    (data/hash_shuffle.py), no barrier reduce with O(blocks) args."""
    from ray_tpu_torch.data.hash_shuffle import run_streaming_shuffle
    if not block_refs:
        return []
    n_out = op.num_outputs or len(block_refs)
    n_out = max(1, n_out)

    if op.kind == "repartition":
        return run_streaming_shuffle(
            [("d", block_refs, _split_task, (n_out,))], n_out,
            _fin_concat, lambda p: ())

    if op.kind == "shuffle":
        return run_streaming_shuffle(
            [("d", block_refs, _perm_partition_task, (n_out, op.seed))],
            n_out, _fin_shuffle, lambda p: (op.seed, p))

    if op.kind == "sort":
        # Sample → pick boundaries → stream range partitions into
        # per-range aggregators that sort on finalize.
        blocks = ray_tpu_torch.get(list(block_refs))
        col = np.concatenate([
            b.to_numpy(op.key) for b in blocks if b.num_rows > 0])
        if col.size == 0:
            return block_refs
        quantiles = np.linspace(0, 1, n_out + 1)[1:-1]
        bounds = list(np.quantile(col, quantiles, method="nearest"))
        nparts = len(bounds) + 1
        out = run_streaming_shuffle(
            [("d", block_refs, _range_partition_task,
              (op.key, bounds, op.descending))], nparts,
            _fin_sort, lambda p: (op.key, op.descending))
        return out[::-1] if op.descending else out

    raise ValueError(f"unknown all-to-all kind {op.kind!r}")


def _agg_partition_task(key, aggs, map_groups_fn, batch_format,
                        *blocks: Block) -> Block:
    """Reduce one hash partition: group rows by key, apply aggs/fn."""
    block = concat_blocks(blocks)
    if block.num_rows == 0:
        return block
    if key is None:
        groups = {None: block}
    else:
        col = block.to_numpy(key)
        groups = {}
        for val in np.unique(col):
            groups[val] = block.take(np.nonzero(col == val)[0])
    rows = []
    for val, sub in sorted(groups.items(),
                           key=lambda kv: (kv[0] is None, kv[0])):
        if map_groups_fn is not None:
            out = map_groups_fn(
                BlockAccessor(sub).to_batch(batch_format))
            rows.extend(block_from_batch(out).to_pylist())
            continue
        row = {} if key is None else {key: val}
        for agg in aggs:
            row[agg.name] = agg.compute(sub)
        rows.append(row)
    return block_from_rows(rows)


def _join_partition_task(key: str, how: str, n_left: int,
                         *blocks: Block) -> Block:
    """Join one hash partition: first n_left blocks are the left side."""
    left = concat_blocks(blocks[:n_left])
    right = concat_blocks(blocks[n_left:])
    if left.num_rows == 0 and right.num_rows == 0:
        return left
    return left.join(right, keys=key, join_type=how,
                     right_suffix="_r")


def _fin_join(shards: Dict, key: str, how: str) -> Block:
    left = shards.get("l", [])
    right = shards.get("r", [])
    return _join_partition_task(key, how, len(left), *left, *right)


def _fin_agg(shards: Dict, key, aggs, map_groups_fn,
             batch_format) -> Block:
    return _agg_partition_task(key, aggs, map_groups_fn, batch_format,
                               *shards.get("d", []))


def run_join(key: str, how: str, left_refs: List[Any],
             right_refs: List[Any],
             num_partitions: Optional[int] = None) -> List[Any]:
    """Streaming hash join (reference: `data/_internal/execution/
    operators/join.py` — both sides hash-partition into the SAME
    aggregator actors, tagged, each partition joined on finalize)."""
    from ray_tpu_torch.data.hash_shuffle import run_streaming_shuffle
    nparts = num_partitions or max(1, min(
        8, max(len(left_refs), len(right_refs))))
    return run_streaming_shuffle(
        [("l", left_refs, _hash_partition_task, (key, nparts)),
         ("r", right_refs, _hash_partition_task, (key, nparts))],
        nparts, _fin_join, lambda p: (key, how))


def run_aggregate(op: L.Aggregate, block_refs: List[Any],
                  num_partitions: Optional[int] = None) -> List[Any]:
    """Streaming hash-shuffle aggregation (reference: SURVEY.md §8.7 —
    `hash_shuffle.py` partition shards stream into stateful
    aggregators that reduce on finalize)."""
    from ray_tpu_torch.data.hash_shuffle import run_streaming_shuffle
    if not block_refs:
        return []
    if op.key is None:
        agg = ray_tpu_torch.remote(_agg_partition_task)
        return [agg.remote(None, op.aggs, op.map_groups_fn, op.batch_format,
                           *block_refs)]
    nparts = num_partitions or min(len(block_refs), 8)
    return run_streaming_shuffle(
        [("d", block_refs, _hash_partition_task, (op.key, nparts))],
        nparts, _fin_agg,
        lambda p: (op.key, op.aggs, op.map_groups_fn, op.batch_format))


# ---------------------------------------------------------------------------
# Streaming executor
# ---------------------------------------------------------------------------

class StreamingExecutor:
    """Drives a linear operator topology; yields output block refs as they
    become available (true streaming: a downstream consumer sees block 0
    while upstream still reads block N)."""

    def __init__(self, operators: List[PhysicalOperator],
                 max_out_queue: Optional[int] = None, stats=None,
                 backpressure_policies=None):
        from ray_tpu_torch.data.backpressure_policy import default_policies
        from ray_tpu_torch.data.context import DataContext
        ctx = DataContext.get_current()
        self.ops = operators
        self.max_out_queue = (max_out_queue if max_out_queue is not None
                              else ctx.max_operator_output_queue)
        self.stats = stats
        self.policies = (backpressure_policies
                         if backpressure_policies is not None
                         else default_policies())
        for op in operators:
            op.max_in_flight = min(op.max_in_flight,
                                   ctx.max_in_flight_tasks_per_operator)
        for a, b in zip(operators[:-1], operators[1:]):
            a.downstream = b

    def _admit(self, op: PhysicalOperator) -> bool:
        return (op.can_launch(self.max_out_queue)
                and all(p.can_launch(op, self) for p in self.policies))

    def execute(self) -> Iterator[Any]:
        ops = self.ops
        sink = ops[-1]
        try:
            while True:
                # route outputs downstream
                for op in ops[:-1]:
                    while op.outqueue:
                        op.downstream.inqueue.append(op.outqueue.popleft())
                    if op.done():
                        op.downstream.inputs_done = True
                # yield whatever reached the sink
                while sink.outqueue:
                    yield sink.outqueue.popleft()
                if all(op.done() for op in ops):
                    break
                # launch work: prefer operators furthest downstream
                # (select_operator_to_run heuristic — drain before read)
                launched = False
                for op in reversed(ops):
                    while self._admit(op):
                        op.launch()
                        launched = True
                    op.maybe_autoscale()
                # poll in-flight tasks
                in_flight = [r for op in ops for r in op.active]
                if in_flight:
                    done, _ = ray_tpu_torch.wait(
                        in_flight, num_returns=1, timeout=0.5)
                    for ref in done:
                        owner = next(o for o in ops if ref in o.active)
                        try:
                            value = ray_tpu_torch.get(ref)
                            owner.on_task_done(ref, None, value=value)
                            if self.stats is not None:
                                self.stats.record(owner.name, blocks=1)
                        except Exception as e:
                            owner.active.pop(ref, None)
                            raise
                elif not launched and not any(
                        op.outqueue for op in ops[:-1]):
                    # nothing running, nothing to move: avoid spin
                    if all(op.done() for op in ops):
                        break
            while sink.outqueue:
                yield sink.outqueue.popleft()
        finally:
            for op in ops:
                op.shutdown()


def plan_chain(chain: List[L.LogicalOp]) -> List[PhysicalOperator]:
    """Lower a logical chain to physical operators."""
    phys: List[PhysicalOperator] = []
    for op in chain:
        if isinstance(op, L.InputData):
            phys.append(SourceOperator("input", refs=op.block_refs))
        elif isinstance(op, L.Read):
            phys.append(SourceOperator("read", read_fns=op.read_tasks))
        elif isinstance(op, L.FusedMap):
            phys.append(MapOperator(op.name, op.stages))
        elif isinstance(op, L.MapBatches) and op.fn_constructor is not None:
            phys.append(ActorPoolMapOperator(op.name, op))
        elif isinstance(op, (L.MapBatches, L.MapRows)):
            phys.append(MapOperator(op.name, [op]))
        elif isinstance(op, L.Limit):
            phys.append(LimitOperator(op.limit))
        else:
            raise TypeError(f"cannot stream {op!r}; requires materialization")
    return phys
