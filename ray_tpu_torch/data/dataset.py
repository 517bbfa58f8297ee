"""Dataset: lazy distributed data (counterpart of ``ray_tpu/data/dataset.py``;
reference: `python/ray/data/dataset.py`).

Lazy logical plan → optimizer → streaming executor (execution.py). Barrier
ops (shuffle/sort/repartition/aggregate/zip) materialize; map chains
stream. Blocks are the port's numpy tables (``block.py``) in the runtime's
object store; the column operations JAX runs as ``"pyarrow"`` batches run
on those blocks, and only the parquet, csv and orc writers import pyarrow.
"""

from __future__ import annotations

import threading
from typing import (Any, Callable, Dict, Iterator, List, Optional, Tuple,
                    Union as TUnion)

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data import logical as L
from ray_tpu_torch.data.aggregate import (AggregateFn, Count, Max, Mean, Min, Std,
                                    Sum)
from ray_tpu_torch.data.block import (Block, BlockAccessor, Schema,
                                      block_from_batch, block_from_rows,
                                      concat_blocks)
from ray_tpu_torch.data.execution import (StreamingExecutor, plan_chain,
                                    run_aggregate, run_all_to_all,
                                    run_join)
from ray_tpu_torch.data.iterator import DataIterator


def _json_default(o):
    """numpy scalars/arrays inside rows -> plain JSON values. bytes are
    REJECTED: lossy replace-decoding would silently corrupt binary
    columns (use write_parquet or write_webdataset for those)."""
    import numpy as _np
    if isinstance(o, _np.integer):
        return int(o)
    if isinstance(o, _np.floating):
        return float(o)
    if isinstance(o, _np.ndarray):
        return o.tolist()
    if isinstance(o, bytes):
        raise TypeError(
            "binary column in write_json — bytes do not round-trip "
            "through JSON; use write_parquet or write_webdataset")
    raise TypeError(f"not JSON serializable: {type(o).__name__}")


class Dataset:
    def __init__(self, root: L.LogicalOp):
        self._root = root
        from ray_tpu_torch.data.context import DatasetStats
        self._stats = DatasetStats()

    # ------------------------------------------------------------------
    # transforms (lazy)
    # ------------------------------------------------------------------
    def _derive(self, op: L.LogicalOp) -> "Dataset":
        return Dataset(op)

    def map(self, fn: Callable[[Dict], Dict]) -> "Dataset":
        return self._derive(L.MapRows("map", [self._root], fn=fn,
                                      kind="map"))

    def filter(self, fn: Callable[[Dict], bool]) -> "Dataset":
        return self._derive(L.MapRows("filter", [self._root], fn=fn,
                                      kind="filter"))

    def flat_map(self, fn: Callable[[Dict], List[Dict]]) -> "Dataset":
        return self._derive(L.MapRows("flat_map", [self._root], fn=fn,
                                      kind="flat_map"))

    def map_batches(self, fn: TUnion[Callable, type], *,
                    batch_format: str = "numpy",
                    batch_size: Optional[int] = None,
                    concurrency: Optional[TUnion[int, Tuple[int, int]]]
                    = None, **kwargs) -> "Dataset":
        if isinstance(fn, type):  # stateful class → actor pool
            conc = (concurrency if isinstance(concurrency, tuple)
                    else (1, concurrency or 2))
            return self._derive(L.MapBatches(
                f"map_batches({fn.__name__})", [self._root], fn=fn,
                fn_constructor=fn, batch_format=batch_format,
                concurrency=conc, batch_size=batch_size))
        return self._derive(L.MapBatches(
            "map_batches", [self._root], fn=fn, batch_format=batch_format,
            batch_size=batch_size))

    def add_column(self, name: str, fn: Callable[[Any], Any]) -> "Dataset":
        def add(batch):
            batch[name] = fn(batch)
            return batch
        return self.map_batches(add)

    def drop_columns(self, cols: List[str]) -> "Dataset":
        def drop(t: Block):
            return t.drop_columns([c for c in cols if c in t.column_names])
        return self.map_batches(drop, batch_format="block")

    def select_columns(self, cols: List[str]) -> "Dataset":
        return self.map_batches(lambda t: t.select(cols),
                                batch_format="block")

    def rename_columns(self, mapping: Dict[str, str]) -> "Dataset":
        def rename(t: Block):
            return t.rename_columns(
                [mapping.get(c, c) for c in t.column_names])
        return self.map_batches(rename, batch_format="block")

    def limit(self, n: int) -> "Dataset":
        return self._derive(L.Limit("limit", [self._root], limit=n))

    def repartition(self, num_blocks: int) -> "Dataset":
        return self._derive(L.AllToAll("repartition", [self._root],
                                       kind="repartition",
                                       num_outputs=num_blocks))

    def random_shuffle(self, *, seed: Optional[int] = None,
                       num_blocks: Optional[int] = None) -> "Dataset":
        return self._derive(L.AllToAll("random_shuffle", [self._root],
                                       kind="shuffle", seed=seed,
                                       num_outputs=num_blocks))

    def sort(self, key: str, descending: bool = False) -> "Dataset":
        return self._derive(L.AllToAll("sort", [self._root], kind="sort",
                                       key=key, descending=descending))

    def union(self, *others: "Dataset") -> "Dataset":
        return self._derive(L.Union(
            "union", [self._root] + [o._root for o in others]))

    def zip(self, other: "Dataset") -> "Dataset":
        return self._derive(L.Zip("zip", [self._root, other._root]))

    def join(self, other: "Dataset", *, on: str, how: str = "inner",
             num_partitions: Optional[int] = None) -> "Dataset":
        """Distributed hash join (reference: Dataset.join /
        `execution/operators/join.py`)."""
        return self._derive(L.Join("join", [self._root, other._root],
                                   key=on, how=how,
                                   num_partitions=num_partitions))

    def random_sample(self, fraction: float,
                      seed: Optional[int] = None) -> "Dataset":
        rng_seed = seed

        def sample(batch: Block):
            rng = np.random.default_rng(rng_seed)
            keep = rng.random(batch.num_rows) < fraction
            return batch.take(np.nonzero(keep)[0])
        return self.map_batches(sample, batch_format="block")

    def groupby(self, key: Optional[str]) -> "GroupedData":
        return GroupedData(self, key)

    # ------------------------------------------------------------------
    # execution
    # ------------------------------------------------------------------
    def _execute_refs(self) -> List[Any]:
        """Materialize: run the plan to completion, return block refs."""
        return list(self._stream_refs())

    def _stream_refs(self) -> Iterator[Any]:
        """Streaming execution; barrier prefixes materialize first."""
        root = L.optimize(self._root)
        yield from _stream_node(root, stats=self._stats)

    def materialize(self) -> "Dataset":
        refs = self._execute_refs()
        return Dataset(L.InputData("input", [], block_refs=refs))

    def iter_blocks(self) -> Iterator[Block]:
        for ref in self._stream_refs():
            yield ray_tpu_torch.get(ref)

    # ------------------------------------------------------------------
    # consumption
    # ------------------------------------------------------------------
    def iter_rows(self) -> Iterator[Dict]:
        return DataIterator(self.iter_blocks).iter_rows()

    def iter_batches(self, **kwargs) -> Iterator[Any]:
        return DataIterator(self.iter_blocks).iter_batches(**kwargs)

    def iterator(self) -> DataIterator:
        return DataIterator(self.iter_blocks)

    def to_jax(self, **kwargs) -> Iterator[Any]:
        """Batches as tensors on the card, prefetched through pinned memory
        (``DataIterator.to_jax``)."""
        return DataIterator(self.iter_blocks).to_jax(**kwargs)

    def iter_torch_batches(self, **kwargs) -> Iterator[Any]:
        return DataIterator(self.iter_blocks).iter_torch_batches(**kwargs)

    def take(self, n: int = 20) -> List[Dict]:
        out: List[Dict] = []
        for ref in self.limit(n)._stream_refs():
            out.extend(BlockAccessor(ray_tpu_torch.get(ref)).to_rows())
            if len(out) >= n:
                break
        return out[:n]

    def take_all(self) -> List[Dict]:
        out: List[Dict] = []
        for block in self.iter_blocks():
            out.extend(BlockAccessor(block).to_rows())
        return out

    def count(self) -> int:
        return sum(b.num_rows for b in self.iter_blocks())

    def schema(self) -> Optional[Schema]:
        for block in self.iter_blocks():
            if block.num_rows or block.column_names:
                return block.schema
        return None

    def columns(self) -> List[str]:
        s = self.schema()
        return list(s.names) if s is not None else []

    def num_blocks(self) -> int:
        return len(self._execute_refs())

    def to_pandas(self):
        return concat_blocks(list(self.iter_blocks())).to_pandas()

    def to_arrow_refs(self) -> List[Any]:
        return self._execute_refs()

    def unique(self, column: str) -> List[Any]:
        vals: set = set()
        for block in self.iter_blocks():
            vals.update(block.to_numpy(column).tolist())
        return sorted(vals)

    def _scalar_agg(self, agg: AggregateFn):
        table = self.groupby(None).aggregate(agg).take_all()
        return table[0][agg.name] if table else None

    def sum(self, on: Optional[str] = None):
        return self._scalar_agg(Sum(on))

    def min(self, on: Optional[str] = None):
        return self._scalar_agg(Min(on))

    def max(self, on: Optional[str] = None):
        return self._scalar_agg(Max(on))

    def mean(self, on: Optional[str] = None):
        return self._scalar_agg(Mean(on))

    def std(self, on: Optional[str] = None):
        return self._scalar_agg(Std(on))

    # ------------------------------------------------------------------
    # splits
    # ------------------------------------------------------------------
    def split(self, n: int, *, equal: bool = False) -> List["Dataset"]:
        refs = self._execute_refs()
        if equal:
            blocks = [ray_tpu_torch.get(r) for r in refs]
            whole = concat_blocks(blocks)
            total = whole.num_rows
            out = []
            for i in range(n):
                lo, hi = i * total // n, (i + 1) * total // n
                out.append(Dataset(L.InputData(
                    "input", [],
                    block_refs=[ray_tpu_torch.put(whole.slice(lo, hi - lo))])))
            return out
        return [Dataset(L.InputData("input", [], block_refs=refs[i::n]))
                for i in range(n)]

    def streaming_split(self, n: int, *, equal: bool = False,
                        locality_hints=None) -> List[DataIterator]:
        """n iterators fed by ONE shared streaming execution per epoch
        (reference: `dataset.py:1731` — Train ingest, SURVEY.md §8.13).
        Repeated iteration re-executes the plan: when a shard that already
        consumed the current pass asks for a new iterator, a fresh shared
        pass starts (epoch semantics for SPMD training loops)."""
        lock = threading.Lock()
        dataset = self

        class _Gen:
            def __init__(self):
                self.stream = dataset._stream_refs()
                self.queues: List[List] = [[] for _ in range(n)]
                self.next = 0
                self.done = False
                self.joined: set = set()

        state = {"gen_id": 0, "gens": {0: _Gen()}}

        def join(idx: int) -> "_Gen":
            with lock:
                gen = state["gens"][state["gen_id"]]
                if idx in gen.joined:       # this shard starts a new epoch
                    state["gen_id"] += 1
                    gen = state["gens"][state["gen_id"]] = _Gen()
                gen.joined.add(idx)
                return gen

        def pull_for(idx: int) -> Iterator[Block]:
            gen = join(idx)
            while True:
                with lock:
                    if gen.queues[idx]:
                        ref = gen.queues[idx].pop(0)
                    elif gen.done:
                        return
                    else:
                        try:
                            ref = next(gen.stream)
                        except StopIteration:
                            gen.done = True
                            return
                        owner = gen.next % n
                        gen.next += 1
                        if owner != idx:
                            gen.queues[owner].append(ref)
                            continue
                yield ray_tpu_torch.get(ref)

        return [DataIterator(lambda i=i: pull_for(i),
                             pickle_recipe=(self, n, i))
                for i in range(n)]

    def train_test_split(self, test_size: float, *,
                         shuffle: bool = False,
                         seed: Optional[int] = None
                         ) -> Tuple["Dataset", "Dataset"]:
        ds = self.random_shuffle(seed=seed) if shuffle else self
        whole = concat_blocks(list(ds.iter_blocks()))
        n_test = int(whole.num_rows * test_size)
        n_train = whole.num_rows - n_test
        train = Dataset(L.InputData(
            "input", [], block_refs=[ray_tpu_torch.put(whole.slice(0, n_train))]))
        test = Dataset(L.InputData(
            "input", [],
            block_refs=[ray_tpu_torch.put(whole.slice(n_train, n_test))]))
        return train, test

    # ------------------------------------------------------------------
    # writes
    # ------------------------------------------------------------------
    def write_parquet(self, path: str) -> None:
        import pyarrow.parquet as pq

        from ray_tpu_torch.data.filesystem import resolve_filesystem
        fs, local = resolve_filesystem(path)
        fs.makedirs(local)
        for i, block in enumerate(self.iter_blocks()):
            if block.num_rows:
                with fs.open_output(
                        f"{local}/part-{i:05d}.parquet") as f:
                    pq.write_table(block.to_arrow(), f)

    def write_csv(self, path: str) -> None:
        import pyarrow.csv as pacsv

        from ray_tpu_torch.data.filesystem import resolve_filesystem
        fs, local = resolve_filesystem(path)
        fs.makedirs(local)
        for i, block in enumerate(self.iter_blocks()):
            if block.num_rows:
                with fs.open_output(f"{local}/part-{i:05d}.csv") as f:
                    pacsv.write_csv(block.to_arrow(), f)

    def write_json(self, path: str) -> None:
        """One JSONL file per block (reference: Dataset.write_json)."""
        import json as _json

        from ray_tpu_torch.data.filesystem import resolve_filesystem
        fs, local = resolve_filesystem(path)
        fs.makedirs(local)
        for i, block in enumerate(self.iter_blocks()):
            if block.num_rows:
                lines = "\n".join(
                    _json.dumps(row, default=_json_default)
                    for row in block.to_pylist())
                with fs.open_output(f"{local}/part-{i:05d}.json") as f:
                    f.write((lines + "\n").encode())

    def write_numpy(self, path: str, column: str) -> None:
        """One .npy file per block from ``column`` (reference:
        Dataset.write_numpy)."""
        import io as _io

        import numpy as _np

        from ray_tpu_torch.data.filesystem import resolve_filesystem
        fs, local = resolve_filesystem(path)
        fs.makedirs(local)
        for i, block in enumerate(self.iter_blocks()):
            if block.num_rows:
                arr = _np.asarray(block.to_numpy(column))
                buf = _io.BytesIO()
                _np.save(buf, arr)
                with fs.open_output(f"{local}/part-{i:05d}.npy") as f:
                    f.write(buf.getvalue())

    def write_avro(self, path: str) -> None:
        """One Avro Object Container File per block (reference:
        Dataset.write_avro via fastavro; here data/avro.py's native
        codec, deflate blocks, schema inferred per dataset)."""
        from ray_tpu_torch.data.avro import infer_schema, write_container
        from ray_tpu_torch.data.filesystem import resolve_filesystem
        fs, local = resolve_filesystem(path)
        fs.makedirs(local)
        for i, block in enumerate(self.iter_blocks()):
            if block.num_rows:
                rows = block.to_pylist()
                blob = write_container(infer_schema(rows), rows)
                with fs.open_output(f"{local}/part-{i:05d}.avro") as f:
                    f.write(blob)

    def write_orc(self, path: str) -> None:
        """One ORC file per block (reference: Dataset.write_orc)."""
        from pyarrow import orc as _orc

        from ray_tpu_torch.data.filesystem import resolve_filesystem
        fs, local = resolve_filesystem(path)
        fs.makedirs(local)
        for i, block in enumerate(self.iter_blocks()):
            if block.num_rows:
                with fs.open_output(f"{local}/part-{i:05d}.orc") as f:
                    _orc.write_table(block.to_arrow(), f)

    def write_tfrecords(self, path: str) -> None:
        """One TFRecord shard per block, rows as tf.train.Example
        (crc32c-framed; no TensorFlow — data/tfrecords.py)."""
        from ray_tpu_torch.data.filesystem import resolve_filesystem
        from ray_tpu_torch.data.tfrecords import (encode_example,
                                            write_tfrecord_frame)
        fs, local = resolve_filesystem(path)
        fs.makedirs(local)
        for i, block in enumerate(self.iter_blocks()):
            if not block.num_rows:
                continue
            frames = b"".join(
                write_tfrecord_frame(encode_example(row))
                for row in block.to_pylist())
            with fs.open_output(f"{local}/part-{i:05d}.tfrecord") as f:
                f.write(frames)

    def write_webdataset(self, path: str) -> None:
        """One WebDataset tar shard per block: each row becomes a
        sample keyed by its ``__key__`` column (or the row index), with
        every other column written as ``<key>.<column>`` (bytes/str
        raw, everything else JSON — reference: Dataset.write_webdataset)."""
        import io as _io
        import json as _json
        import tarfile

        from ray_tpu_torch.data.filesystem import resolve_filesystem
        fs, local = resolve_filesystem(path)
        fs.makedirs(local)
        for i, block in enumerate(self.iter_blocks()):
            if not block.num_rows:
                continue
            buf = _io.BytesIO()
            with tarfile.open(fileobj=buf, mode="w") as tar:
                for j, row in enumerate(block.to_pylist()):
                    key = str(row.pop("__key__", f"{i:05d}{j:06d}"))
                    for col, val in row.items():
                        if isinstance(val, bytes):
                            payload = val
                        elif isinstance(val, str):
                            payload = val.encode()
                        else:
                            payload = _json.dumps(
                                val, default=_json_default).encode()
                        info = tarfile.TarInfo(f"{key}.{col}")
                        info.size = len(payload)
                        tar.addfile(info, _io.BytesIO(payload))
            with fs.open_output(f"{local}/shard-{i:05d}.tar") as f:
                f.write(buf.getvalue())

    def stats(self) -> str:
        """Execution statistics summary (reference: Dataset.stats())."""
        return self._stats.summary()

    def __repr__(self):
        return f"Dataset(plan={self._root.name})"


# ---------------------------------------------------------------------------
# plan execution helpers
# ---------------------------------------------------------------------------

def _stream_node(node: L.LogicalOp, stats=None) -> Iterator[Any]:
    """Yield block refs for a (possibly barrier-containing) plan node."""
    if isinstance(node, L.Union):
        for inp in node.inputs:
            yield from _stream_node(L.optimize(inp))
        return
    if isinstance(node, L.Zip):
        left = [ray_tpu_torch.get(r) for r in _stream_node(L.optimize(
            node.inputs[0]))]
        right = [ray_tpu_torch.get(r) for r in _stream_node(L.optimize(
            node.inputs[1]))]
        lt, rt = concat_blocks(left), concat_blocks(right)
        if lt.num_rows != rt.num_rows:
            raise ValueError(f"zip row mismatch {lt.num_rows} vs "
                             f"{rt.num_rows}")
        for name in rt.column_names:
            col_name = name
            if col_name in lt.column_names:
                col_name = f"{name}_1"
            lt = lt.append_column(col_name, rt.column(name))
        yield ray_tpu_torch.put(lt)
        return
    if isinstance(node, L.Join):
        left = list(_stream_node(L.optimize(node.inputs[0])))
        right = list(_stream_node(L.optimize(node.inputs[1])))
        yield from run_join(node.key, node.how, left, right,
                            node.num_partitions)
        return
    if isinstance(node, L.AllToAll):
        upstream = list(_stream_node(L.optimize(node.inputs[0])))
        yield from run_all_to_all(node, upstream)
        return
    if isinstance(node, L.Aggregate):
        upstream = list(_stream_node(L.optimize(node.inputs[0])))
        yield from run_aggregate(node, upstream)
        return

    # linear streaming chain; find the deepest barrier, materialize it
    chain = node.chain()
    barrier_idx = None
    for i, op in enumerate(chain):
        if isinstance(op, (L.AllToAll, L.Aggregate, L.Union, L.Zip,
                           L.Join)):
            barrier_idx = i
    if barrier_idx is not None:
        refs = list(_stream_node(chain[barrier_idx]))
        suffix = chain[barrier_idx + 1:]
        if not suffix:
            yield from refs
            return
        source: L.LogicalOp = L.InputData("input", [], block_refs=refs)
        for op in suffix:
            op = _clone_with_input(op, source)
            source = op
        chain = source.chain()
    executor = StreamingExecutor(plan_chain(chain), stats=stats)
    yield from executor.execute()


def _clone_with_input(op: L.LogicalOp, inp: L.LogicalOp) -> L.LogicalOp:
    import copy
    clone = copy.copy(op)
    clone.inputs = [inp]
    return clone


class GroupedData:
    """Reference: `python/ray/data/grouped_data.py`."""

    def __init__(self, ds: Dataset, key: Optional[str]):
        self._ds = ds
        self._key = key

    def aggregate(self, *aggs: AggregateFn) -> Dataset:
        return Dataset(L.Aggregate("aggregate", [self._ds._root],
                                   key=self._key, aggs=list(aggs)))

    def map_groups(self, fn: Callable, *, batch_format: str = "numpy"
                   ) -> Dataset:
        return Dataset(L.Aggregate("map_groups", [self._ds._root],
                                   key=self._key, map_groups_fn=fn,
                                   batch_format=batch_format))

    def count(self) -> Dataset:
        return self.aggregate(Count())

    def sum(self, on: Optional[str] = None) -> Dataset:
        return self.aggregate(Sum(on))

    def min(self, on: Optional[str] = None) -> Dataset:
        return self.aggregate(Min(on))

    def max(self, on: Optional[str] = None) -> Dataset:
        return self.aggregate(Max(on))

    def mean(self, on: Optional[str] = None) -> Dataset:
        return self.aggregate(Mean(on))

    def std(self, on: Optional[str] = None) -> Dataset:
        return self.aggregate(Std(on))
