"""The port's data layer on its runtime: the JAX package's
``tests/test_data.py`` (datasets, transforms, shuffles, groupby,
iteration), ``tests/test_ops_shell.py::test_iter_torch_batches`` and
``tests/test_review_regressions.py::test_stable_hash_partition_deterministic``
copied, ``to_jax`` asserting CPU tensors (``device="cpu"``); then the
feed's own rules: no device means the card, and an iterator closed early
stops its prefetch thread (ROADMAP C12)."""

import threading
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import data as rdata
from ray_tpu_torch.data import Count, Max, Mean, Min, Sum


@pytest.fixture
def ray4():
    rt = ray_tpu_torch.init(num_nodes=1, resources={"CPU": 8})
    yield rt
    ray_tpu_torch.shutdown()


def test_range_count_take(ray4):
    ds = rdata.range(100)
    assert ds.count() == 100
    assert [r["id"] for r in ds.take(5)] == [0, 1, 2, 3, 4]


def test_from_items_and_map(ray4):
    ds = rdata.from_items([1, 2, 3, 4]).map(
        lambda r: {"item": r["item"] * 10})
    assert sorted(r["item"] for r in ds.take_all()) == [10, 20, 30, 40]


def test_map_batches_numpy(ray4):
    ds = rdata.range(10).map_batches(
        lambda b: {"id": b["id"], "sq": b["id"] ** 2})
    rows = ds.take_all()
    assert all(r["sq"] == r["id"] ** 2 for r in rows)


def test_fused_map_chain_streams(ray4):
    ds = (rdata.range(100, parallelism=10)
          .map(lambda r: {"id": r["id"] + 1})
          .filter(lambda r: r["id"] % 2 == 0)
          .map_batches(lambda b: {"id": b["id"] * 2}))
    vals = sorted(r["id"] for r in ds.take_all())
    assert vals == [x * 2 for x in range(2, 101, 2)]


def test_flat_map(ray4):
    ds = rdata.from_items([1, 2]).flat_map(
        lambda r: [{"v": r["item"]}, {"v": r["item"] * 100}])
    assert sorted(r["v"] for r in ds.take_all()) == [1, 2, 100, 200]


def test_limit_streaming(ray4):
    ds = rdata.range(1000, parallelism=20).limit(37)
    assert ds.count() == 37


def test_repartition(ray4):
    ds = rdata.range(100, parallelism=10).repartition(3)
    assert ds.num_blocks() == 3
    assert ds.count() == 100


def test_random_shuffle_preserves_multiset(ray4):
    ds = rdata.range(50).random_shuffle(seed=42)
    vals = [r["id"] for r in ds.take_all()]
    assert sorted(vals) == list(range(50))
    assert vals != list(range(50))  # overwhelmingly likely


def test_sort(ray4):
    rng = np.random.default_rng(0)
    items = [{"k": int(x)} for x in rng.permutation(100)]
    ds = rdata.from_items(items, parallelism=7).sort("k")
    assert [r["k"] for r in ds.take_all()] == list(range(100))
    ds2 = rdata.from_items(items, parallelism=7).sort("k", descending=True)
    assert [r["k"] for r in ds2.take_all()] == list(range(99, -1, -1))


def test_union_zip(ray4):
    a = rdata.from_items([{"x": 1}, {"x": 2}])
    b = rdata.from_items([{"x": 3}])
    assert sorted(r["x"] for r in a.union(b).take_all()) == [1, 2, 3]
    c = rdata.from_items([{"y": 10}, {"y": 20}])
    z = a.zip(c).take_all()
    assert z == [{"x": 1, "y": 10}, {"x": 2, "y": 20}]


def test_groupby_aggregate(ray4):
    items = [{"k": i % 3, "v": i} for i in range(30)]
    ds = rdata.from_items(items, parallelism=5)
    out = ds.groupby("k").aggregate(Sum("v"), Count()).take_all()
    by_k = {r["k"]: r for r in out}
    assert by_k[0]["sum(v)"] == sum(i for i in range(30) if i % 3 == 0)
    assert by_k[1]["count()"] == 10


def test_groupby_map_groups(ray4):
    items = [{"k": i % 2, "v": float(i)} for i in range(10)]
    ds = rdata.from_items(items, parallelism=3)
    out = ds.groupby("k").map_groups(
        lambda b: {"k": b["k"][:1], "vmax": [b["v"].max()]}).take_all()
    assert {r["k"]: r["vmax"] for r in out} == {0: 8.0, 1: 9.0}


def test_scalar_aggregates(ray4):
    ds = rdata.range(10)
    assert ds.sum("id") == 45
    assert ds.min("id") == 0
    assert ds.max("id") == 9
    assert ds.mean("id") == 4.5


def test_iter_batches_sizes(ray4):
    ds = rdata.range(25, parallelism=4)
    batches = list(ds.iter_batches(batch_size=10))
    sizes = [len(b["id"]) for b in batches]
    assert sizes == [10, 10, 5]
    batches = list(ds.iter_batches(batch_size=10, drop_last=True))
    assert [len(b["id"]) for b in batches] == [10, 10]


def test_iter_batches_local_shuffle(ray4):
    ds = rdata.range(40, parallelism=4)
    vals = []
    for b in ds.iter_batches(batch_size=10, local_shuffle_buffer_size=20,
                             local_shuffle_seed=0):
        vals.extend(b["id"].tolist())
    assert sorted(vals) == list(range(40))
    assert vals != list(range(40))


def test_actor_pool_map_batches(ray4):
    class AddConst:
        def __init__(self):
            self.c = 1000

        def __call__(self, batch):
            return {"id": batch["id"] + self.c}

    ds = rdata.range(20, parallelism=4).map_batches(AddConst, concurrency=2)
    assert sorted(r["id"] for r in ds.take_all()) == \
        list(range(1000, 1020))


def test_split_and_streaming_split(ray4):
    ds = rdata.range(20, parallelism=4)
    parts = ds.split(2)
    assert sum(p.count() for p in parts) == 20
    its = ds.streaming_split(2)
    seen = []
    for it in its:
        for b in it.iter_batches(batch_size=None):
            seen.extend(b["id"].tolist())
    assert sorted(seen) == list(range(20))


def test_parquet_roundtrip(ray4, tmp_path):
    pytest.importorskip("pyarrow")
    ds = rdata.range(50, parallelism=3)
    ds.write_parquet(str(tmp_path / "pq"))
    back = rdata.read_parquet(str(tmp_path / "pq"))
    assert sorted(r["id"] for r in back.take_all()) == list(range(50))


def test_csv_and_text(ray4, tmp_path):
    pytest.importorskip("pyarrow")
    ds = rdata.from_items([{"a": 1, "b": "x"}, {"a": 2, "b": "y"}])
    ds.write_csv(str(tmp_path / "csv"))
    back = rdata.read_csv(str(tmp_path / "csv"))
    assert sorted(r["a"] for r in back.take_all()) == [1, 2]
    (tmp_path / "t.txt").write_text("hello\nworld\n")
    txt = rdata.read_text(str(tmp_path / "t.txt"))
    assert [r["text"] for r in txt.take_all()] == ["hello", "world"]


def test_column_ops(ray4):
    ds = rdata.range(5).add_column("double", lambda b: b["id"] * 2)
    assert ds.take(1)[0]["double"] == 0
    assert set(ds.select_columns(["double"]).columns()) == {"double"}
    renamed = ds.rename_columns({"double": "d2"})
    assert "d2" in renamed.columns()
    dropped = ds.drop_columns(["double"])
    assert dropped.columns() == ["id"]


def test_to_jax_device_iterator(ray4):
    ds = rdata.range(32, parallelism=2)
    batches = list(ds.to_jax(batch_size=16, device="cpu"))
    assert len(batches) == 2
    assert isinstance(batches[0]["id"], torch.Tensor)
    assert batches[0]["id"].device.type == "cpu"


def test_dataset_feeds_trainer(ray4, tmp_path):
    """Data → Train ingest path (reference SURVEY.md §8.13)."""
    from ray_tpu_torch import train
    from ray_tpu_torch.train import JaxTrainer, RunConfig, ScalingConfig

    ds = rdata.range(40, parallelism=4)

    def train_fn(config):
        shard = train.get_dataset_shard("train")
        total = 0
        for batch in shard.iter_batches(batch_size=5):
            total += int(batch["id"].sum())
        train.report({"total": total})

    result = JaxTrainer(
        train_fn, scaling_config=ScalingConfig(num_workers=2),
        run_config=RunConfig(name="ingest", storage_path=str(tmp_path)),
        datasets={"train": ds}).fit()
    assert result.error is None
    assert sum(e["metrics"]["total"]
               for e in result.metrics_history) == sum(range(40))


def test_hash_join(ray4):
    left = rdata.from_items(
        [{"k": i % 5, "lv": i} for i in range(20)], parallelism=4)
    right = rdata.from_items(
        [{"k": k, "rv": k * 100} for k in range(3)], parallelism=2)
    joined = left.join(right, on="k").take_all()
    assert all(r["rv"] == r["k"] * 100 for r in joined)
    assert len(joined) == 12  # k in {0,1,2}: 4 left rows each x 1 right
    outer = left.join(right, on="k", how="left outer").take_all()
    assert len(outer) == 20


# ---------------------------------------------------------------------------
# tests/test_ops_shell.py, tests/test_review_regressions.py
# ---------------------------------------------------------------------------

def test_iter_torch_batches(ray4):
    ds = rdata.range(20, parallelism=2)
    batches = list(ds.iter_torch_batches(batch_size=10))
    assert len(batches) == 2
    assert isinstance(batches[0]["id"], torch.Tensor)
    vals = sorted(int(x) for b in batches for x in b["id"])
    assert vals == list(range(20))


def test_stable_hash_partition_deterministic():
    """join/aggregate partitioning must not depend on PYTHONHASHSEED
    (ADVICE r1 low)."""
    import subprocess
    import sys

    code = ("from ray_tpu_torch.data.execution import _stable_hash;"
            "print([_stable_hash(x) for x in"
            " ['key-a', b'key-b', 42, 3.5, True, None]])")
    outs = {
        subprocess.run(
            [sys.executable, "-c", code], capture_output=True, text=True,
            env={**__import__('os').environ, "PYTHONHASHSEED": seed},
        ).stdout.strip()
        for seed in ("0", "1", "12345")}
    assert len(outs) == 1 and "[" in next(iter(outs))


# ---------------------------------------------------------------------------
# the feed's rules
# ---------------------------------------------------------------------------

def test_to_jax_without_a_device_means_the_card(ray4, monkeypatch):
    """``device=None`` is the card: a host without one raises, and never
    falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    it = rdata.range(8).to_jax(batch_size=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(it)


def test_to_jax_dtypes_on_the_host_and_on_the_device(ray4):
    """A numpy dtype is cast on the host before the copy, a torch dtype
    (bf16, which numpy lacks) on the device after it."""
    ds = rdata.from_numpy(np.arange(12, dtype=np.int64).reshape(6, 2), "x")
    ds = ds.map_batches(lambda b: {"x": b["x"], "y": b["x"][:, 0] * 0.5})
    out = list(ds.to_jax(batch_size=3, device="cpu",
                         dtypes={"x": np.int32, "y": torch.bfloat16}))
    assert [b["x"].dtype for b in out] == [torch.int32, torch.int32]
    assert out[1]["y"].dtype == torch.bfloat16
    np.testing.assert_array_equal(out[1]["x"].numpy(),
                                  np.arange(6, 12).reshape(3, 2))


def _prefetch_threads():
    return [t for t in threading.enumerate()
            if t.name == "data-prefetch" and t.is_alive()]


def test_closed_iterator_stops_its_prefetch_thread(ray4):
    """A loop that leaves its epoch early (a fixed number of steps) closes
    the iterator: its prefetch threads end, where JAX's block on their
    full queues for the process's life (ROADMAP C12)."""
    before = len(_prefetch_threads())
    ds = rdata.range(4000, parallelism=40).map_batches(lambda b: b)
    for it in (ds.iter_batches(batch_size=10, prefetch_batches=1),
               ds.to_jax(batch_size=10, prefetch=1, device="cpu")):
        next(it)
        assert len(_prefetch_threads()) > before
        it.close()
        deadline = time.time() + 10
        while len(_prefetch_threads()) > before and time.time() < deadline:
            time.sleep(0.05)
        assert len(_prefetch_threads()) == before


def test_data_package_imports_no_torch_and_no_pyarrow():
    """``import ray_tpu_torch.data`` needs neither torch (the feed imports
    it when called) nor pyarrow (the card's machine has none)."""
    import subprocess
    import sys
    code = ("import sys, ray_tpu_torch.data;"
            "print(sorted(m for m in ('torch', 'pyarrow', 'pandas', 'jax')"
            " if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[]"
