"""The port's data layer against the JAX package's, on the same numpy
inputs made from a seed.

- Pipelines (``map``, ``map_batches``, ``filter``, ``flat_map``, ``limit``,
  ``repartition``, ``random_shuffle(seed)``, ``sort``, ``groupby``,
  joins, ``union``/``zip``, splits, ``iter_batches`` with a local shuffle
  seed) give JAX's rows exactly: in JAX's order where JAX's order is
  deterministic (one upstream block, materialized inputs, sorts, groupby
  partitions), as a multiset where blocks race through tasks (JAX's
  shuffle shards reach their aggregator in completion order) and for
  joins (pyarrow's hash-join order).
- Batches have JAX's dtypes and shapes; every file format written by one
  package is read back by the other; ``to_jax(device="cpu")`` gives JAX's
  values and dtypes (``dtypes=`` included).
- ``JaxTrainer(datasets=...)`` over a debug Llama gives JAX's losses
  (``tests/test_torch_train_driver.py``'s bar, rtol 1e-4), the params
  carried across by ``params_from_numpy``; offline RL's parquet IO crosses
  packages and BC trains to JAX's losses (``tests/test_torch_rl.py``'s
  first-step bar).
- A ``map_batches`` function that writes into its batch raises as in JAX
  and leaves the stored block as it was; a block reports its columns' bytes
  to the object store and survives a pickle (spilling) read-only.

JAX's runtime runs with process workers off, as in the other parity tests.
"""

import pickle

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu import data as jdata
from ray_tpu_torch import data as tdata

PKGS = (("jax", ray_tpu, jdata), ("port", ray_tpu_torch, tdata))


@pytest.fixture
def both(monkeypatch):
    monkeypatch.setenv("RAY_TPU_PROCESS_WORKERS", "0")
    for _, pkg, _ in PKGS:
        pkg.init(num_nodes=1, resources={"CPU": 8})
    yield
    for _, pkg, _ in PKGS:
        pkg.shutdown()


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _items(n=60, seed=0):
    rng = np.random.default_rng(seed)
    return [{"k": int(k), "v": int(v), "f": float(f), "s": f"s{i}"}
            for i, (k, v, f) in enumerate(zip(
                rng.integers(0, 5, n), rng.integers(-50, 50, n),
                rng.normal(size=n)))]


def _row_key(row):
    return tuple((k, repr(row[k])) for k in sorted(row))


def _both(build, ordered: bool = True):
    """``build(data)`` run on both packages; their rows compared."""
    out = {name: build(data).take_all() for name, _, data in PKGS}
    if ordered:
        assert out["port"] == out["jax"]
    else:
        assert sorted(out["port"], key=_row_key) == sorted(
            out["jax"], key=_row_key)
    assert out["port"]
    return out["port"]


PIPELINES = {
    "map": (lambda d: d.from_items(_items(), parallelism=1).map(
        lambda r: {"k": r["k"], "v2": r["v"] * 2, "s": r["s"] + "!"}), True),
    "map_batches": (lambda d: d.from_numpy(
        np.arange(24.0).reshape(6, 2, 2), "x").map_batches(
        lambda b: {"x": b["x"] * 2, "m": b["x"].mean(axis=(1, 2))}), True),
    "filter": (lambda d: d.from_items(_items(), parallelism=1).filter(
        lambda r: r["v"] % 3 == 0), True),
    "flat_map": (lambda d: d.from_items(_items(20), parallelism=1).flat_map(
        lambda r: [{"v": r["v"]}, {"v": -r["v"]}]), True),
    "limit": (lambda d: d.range(100, parallelism=1).limit(37), True),
    "chain_many_blocks": (lambda d: d.range(400, parallelism=8)
                          .map(lambda r: {"id": r["id"] + 1})
                          .filter(lambda r: r["id"] % 2 == 0)
                          .map_batches(lambda b: {"id": b["id"] * 3}), False),
    "repartition": (lambda d: d.from_numpy(np.arange(50), "a")
                    .repartition(4), True),
    "random_shuffle_one_block": (lambda d: d.from_numpy(
        np.arange(200), "a").random_shuffle(seed=7), True),
    "random_shuffle_many_blocks": (lambda d: d.from_items(
        _items(), parallelism=4).random_shuffle(seed=7), False),
    "sort": (lambda d: d.from_items(
        [{"k": int(x)} for x in np.random.default_rng(1).permutation(90)],
        parallelism=6).sort("k"), True),
    "sort_descending": (lambda d: d.from_items(
        [{"k": int(x), "t": str(x)}
         for x in np.random.default_rng(2).permutation(90)],
        parallelism=6).sort("k", descending=True), True),
    "groupby_aggregate": (lambda d: d.from_items(_items(), parallelism=1)
                          .groupby("k").aggregate(
        d.Sum("v"), d.Count(), d.Min("f"), d.Max("f"), d.Mean("v"),
        d.Std("f")), True),
    "groupby_many_blocks": (lambda d: d.from_items(_items(), parallelism=5)
                            .groupby("k").aggregate(
        d.Sum("v"), d.Count(), d.Min("v"), d.Max("v")), True),
    "map_groups": (lambda d: d.from_items(_items(), parallelism=1)
                   .groupby("k").map_groups(
        lambda b: {"k": b["k"][:1], "top": [b["v"].max()],
                   "n": [len(b["v"])]}), True),
    "union": (lambda d: d.from_items(_items(10), parallelism=2).union(
        d.from_items(_items(7, seed=1), parallelism=3)), True),
    "zip": (lambda d: d.from_items(_items(12), parallelism=3).zip(
        d.from_numpy(np.arange(24).reshape(12, 2), "t")), True),
    "column_ops": (lambda d: d.from_items(_items(), parallelism=1)
                   .add_column("w", lambda b: b["v"] + b["k"])
                   .drop_columns(["f"]).rename_columns({"s": "name"})
                   .select_columns(["name", "w", "k"]), True),
    "random_sample": (lambda d: d.from_numpy(np.arange(300), "a")
                      .random_sample(0.3, seed=4), True),
}


@pytest.mark.parametrize("name", list(PIPELINES))
def test_pipeline_rows_match_jax(both, name):
    build, ordered = PIPELINES[name]
    _both(build, ordered)


@pytest.mark.parametrize("how", ["inner", "left outer", "right outer",
                                 "full outer", "left semi", "left anti",
                                 "right semi", "right anti"])
def test_join_rows_match_jax(both, how):
    def build(d):
        left = d.from_items([{"k": i % 6, "lv": i, "s": f"l{i}"}
                             for i in range(30)], parallelism=4)
        right = d.from_items([{"k": k, "rv": k * 100, "lv": -k}
                              for k in (0, 1, 2, 3, 9)], parallelism=2)
        return left.join(right, on="k", how=how)
    rows = _both(build, ordered=False)
    assert len(rows) == {"inner": 20, "left outer": 30, "right outer": 21,
                         "full outer": 31, "left semi": 20, "left anti": 10,
                         "right semi": 4, "right anti": 1}[how]
    if how in ("left outer", "full outer"):
        assert any(r["rv"] is None for r in rows)


def test_dataset_queries_match_jax(both):
    """The consuming queries: counts, scalar aggregates, ``unique``,
    columns, ``take``, ``num_blocks`` and ``train_test_split``."""
    def queries(d):
        ds = d.from_items(_items(), parallelism=3)
        train, test = ds.train_test_split(0.25)
        return {"count": ds.count(), "sum": ds.sum("v"),
                "min": ds.min("f"), "max": ds.max("v"),
                "mean": ds.mean("v"), "std": ds.std("f"),
                "unique": ds.unique("k"), "columns": ds.columns(),
                "take": ds.take(5), "blocks": ds.num_blocks(),
                "split": (train.take_all(), test.take_all()),
                "limit": d.range(1000, parallelism=10).limit(123).count()}
    out = {name: queries(data) for name, _, data in PKGS}
    assert out["port"] == out["jax"]


def test_splits_match_jax(both):
    def shards(d):
        ds = d.from_items(_items(40), parallelism=4)
        split = [p.take_all() for p in ds.split(2)]
        equal = [p.take_all() for p in ds.split(3, equal=True)]
        streamed = [[r for b in it.iter_batches(batch_size=None)
                     for r in _batch_rows(b)]
                    for it in ds.streaming_split(2)]
        return split, equal, streamed
    out = {name: shards(data) for name, _, data in PKGS}
    assert out["port"] == out["jax"]


def _batch_rows(batch):
    keys = list(batch)
    return [{k: (batch[k][i].tolist() if hasattr(batch[k][i], "tolist")
                 else batch[k][i]) for k in keys}
            for i in range(len(batch[keys[0]]))]


def _batches(d, **kw):
    ds = d.from_items(_items(50), parallelism=4)
    return list(ds.iter_batches(**kw))


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            assert g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k])


def test_iter_batches_match_jax(both):
    for kw in (dict(batch_size=8), dict(batch_size=8, drop_last=True),
               dict(batch_size=10, local_shuffle_buffer_size=20,
                    local_shuffle_seed=3)):
        _assert_batches_equal(_batches(tdata, **kw), _batches(jdata, **kw))


def test_batch_dtypes_and_shapes_match_jax(both):
    """Every column kind: int, float, bool, string, bytes, tensor, equal
    and ragged lists, a numeric column with a null."""
    rows = [{"i": i, "f": i * 0.5, "b": i % 2 == 0, "s": f"x{i}",
             "y": bytes([i]), "l": [i, i + 1], "r": list(range(i + 1)),
             "n": None if i == 2 else i}
            for i in range(5)]
    tensor = np.arange(5 * 3 * 2, dtype=np.float32).reshape(5, 3, 2)
    for build in (lambda d: d.from_items(rows, parallelism=1),
                  lambda d: d.from_numpy(tensor, "t")):
        got, want = (list(build(d).iter_batches(batch_size=None))
                     for d in (tdata, jdata))
        assert len(got) == len(want) == 1
        g, w = got[0], want[0]
        assert list(g) == list(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            assert g[k].shape == w[k].shape, k
            if w[k].dtype == object:
                assert [np.asarray(x).tolist() for x in g[k]] == \
                    [np.asarray(x).tolist() for x in w[k]], k
            else:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        assert build(tdata).take_all() == build(jdata).take_all()


# ---------------------------------------------------------------------------
# the task functions: the same block and seed give the same rows
# ---------------------------------------------------------------------------

def test_shuffle_and_hash_tasks_match_jax():
    from ray_tpu.data import execution as jex
    from ray_tpu.data.block import BlockAccessor as JAcc
    from ray_tpu.data.block import block_from_batch as jbatch
    from ray_tpu_torch.data import execution as tex
    from ray_tpu_torch.data.block import block_from_batch as tbatch
    cols = {"a": np.arange(64), "k": np.arange(64) % 7,
            "t": np.arange(128.0).reshape(64, 2)}
    jb, tb = jbatch(cols), tbatch(cols)

    def rows(b, acc=None):
        return (JAcc(b).to_rows() if acc == "jax" else b.to_pylist())

    for n in (1, 4):
        jp = jex._perm_partition_task(jb, n, 11)
        tp = tex._perm_partition_task(tb, n, 11)
        jp, tp = ([jp], [tp]) if n == 1 else (jp, tp)
        assert [rows(b) for b in tp] == [rows(b, "jax") for b in jp]
        jh = jex._hash_partition_task(jb, "k", n)
        th = tex._hash_partition_task(tb, "k", n)
        jh, th = ([jh], [th]) if n == 1 else (jh, th)
        assert [rows(b) for b in th] == [rows(b, "jax") for b in jh]
    assert rows(tex._shuffle_reduce_task(5, 2, tb, tb)) == rows(
        jex._shuffle_reduce_task(5, 2, jb, jb), "jax")
    keys = ["key-a", b"key-b", 42, 3.5, True, None, -0.0, np.int32(7)]
    assert [tex._stable_hash(x) for x in keys] == [
        jex._stable_hash(x) for x in keys]


# ---------------------------------------------------------------------------
# file formats across packages
# ---------------------------------------------------------------------------

FORMATS = {
    "parquet": ("write_parquet", "read_parquet", True),
    "csv": ("write_csv", "read_csv", True),
    "json": ("write_json", "read_json", True),
    "tfrecords": ("write_tfrecords", "read_tfrecords", False),
    "avro": ("write_avro", "read_avro", False),
    "webdataset": ("write_webdataset", "read_webdataset", False),
}


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_file_formats_cross_packages(both, tmp_path, fmt):
    write, read, needs_arrow = FORMATS[fmt]
    if needs_arrow:
        pytest.importorskip("pyarrow")
    rows = [{"a": i, "b": f"x{i}", "c": i * 0.25} for i in range(9)]
    if fmt == "webdataset":
        rows = [{"__key__": f"k{i}", "img": bytes([i, i]), "cls": str(i)}
                for i in range(9)]
    back = {}
    for (wname, _, wdata), (rname, _, rdata) in (
            (PKGS[0], PKGS[1]), (PKGS[1], PKGS[0]), (PKGS[1], PKGS[1])):
        path = str(tmp_path / f"{wname}_to_{rname}")
        getattr(wdata.from_items(rows, parallelism=3), write)(path)
        back[(wname, rname)] = sorted(
            getattr(rdata, read)(path).take_all(), key=_row_key)
    assert back[("jax", "port")] == back[("port", "jax")] == \
        back[("port", "port")]
    assert len(back[("port", "port")]) == 9


def test_numpy_files_cross_packages(both, tmp_path):
    """A 1-D column crosses both ways. A tensor column written by the port
    is one N-D ``.npy`` that both packages read back; JAX's writer saves a
    pickled object array of flat rows there, which its own reader refuses
    (ROADMAP C13)."""
    vec = np.random.default_rng(0).normal(size=10)
    for (_, _, wdata), (_, _, rdata) in ((PKGS[0], PKGS[1]),
                                          (PKGS[1], PKGS[0])):
        path = str(tmp_path / f"vec_{wdata.__name__}")
        wdata.from_numpy(vec, "v").write_numpy(path, "v")
        got = np.concatenate([b["v"] for b in rdata.read_numpy(
            path, column="v").iter_batches(batch_size=None)])
        np.testing.assert_array_equal(got, vec)
    arr = np.random.default_rng(1).normal(size=(10, 3, 2)).astype(np.float32)
    path = str(tmp_path / "tensor_port")
    tdata.from_numpy(arr, "v").write_numpy(path, "v")
    for rdata in (tdata, jdata):
        got = np.concatenate([b["v"] for b in rdata.read_numpy(
            path, column="v").iter_batches(batch_size=None)])
        assert got.dtype == arr.dtype
        np.testing.assert_array_equal(got, arr)
    path = str(tmp_path / "tensor_jax")
    jdata.from_numpy(arr, "v").write_numpy(path, "v")
    with pytest.raises(Exception, match="allow_pickle"):
        jdata.read_numpy(path, column="v").take_all()


# ---------------------------------------------------------------------------
# to_jax on the CPU
# ---------------------------------------------------------------------------

def test_to_jax_values_and_dtypes_match_jax(both):
    """With ``dtypes=`` both give the same dtypes and values (a bf16 cast
    on the device in the port, numpy's ml_dtypes cast in JAX). Without it,
    JAX's 32-bit default narrows int64 and float64; the port keeps them,
    with the same values."""
    import jax.numpy as jnp
    x = np.random.default_rng(0).normal(size=(12, 4)).astype(np.float32)

    def build(d):
        return d.from_numpy(x, "x").map_batches(
            lambda b: {"x": b["x"], "id": np.arange(len(b["x"])),
                       "h": b["x"][:, 0]})
    port = list(build(tdata).to_jax(
        batch_size=4, device="cpu",
        dtypes={"id": np.int32, "h": torch.bfloat16}))
    ref = list(build(jdata).to_jax(
        batch_size=4, dtypes={"id": np.int32, "h": jnp.bfloat16}))
    assert len(port) == len(ref) == 3
    for p, j in zip(port, ref):
        assert p["x"].dtype == torch.float32 and str(j["x"].dtype) == \
            "float32"
        assert p["id"].dtype == torch.int32 and str(j["id"].dtype) == \
            "int32"
        assert p["h"].dtype == torch.bfloat16 and str(j["h"].dtype) == \
            "bfloat16"
        np.testing.assert_array_equal(p["x"].numpy(), np.asarray(j["x"]))
        np.testing.assert_array_equal(p["id"].numpy(), np.asarray(j["id"]))
        np.testing.assert_array_equal(
            p["h"].float().numpy(),
            np.asarray(j["h"]).astype(np.float32))
    plain = next(iter(build(tdata).to_jax(batch_size=4, device="cpu")))
    assert plain["id"].dtype == torch.int64


# ---------------------------------------------------------------------------
# JaxTrainer(datasets=...) and offline RL IO
# ---------------------------------------------------------------------------

def test_trainer_datasets_llama_losses_match_jax(monkeypatch, tmp_path,
                                                 one_thread):
    """Both packages' ``JaxTrainer`` train ``LlamaConfig.debug()`` for 3
    AdamW steps on ``get_dataset_shard("train").to_jax(batch_size=2)`` of
    the same token dataset (targets added by ``map_batches``), from JAX's
    initial params."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    import ray_tpu.train as jtrain
    from ray_tpu.models.llama import LlamaConfig as JConfig
    from ray_tpu.models.llama import LlamaModel as JModel
    from ray_tpu_torch import train
    from ray_tpu_torch.models import (LlamaConfig, LlamaModel,
                                      params_from_numpy)

    monkeypatch.setenv("RAY_TPU_PROCESS_WORKERS", "0")
    kw = dict(vocab_size=256, max_seq_len=64)
    jcfg = dataclasses.replace(JConfig.debug(**kw), attention_impl="flash",
                               remat=True, dtype=jnp.float32)
    tcfg = dataclasses.replace(LlamaConfig.debug(**kw),
                               attention_impl="kernel", remat=True,
                               dtype=torch.float32)
    tokens = np.random.default_rng(3).integers(0, 256, (6, 64))
    start = jax.tree.map(
        np.array, jtrain.make_train_step(JModel(jcfg)).init_fn(
            jax.random.key(0))[0])

    def add_targets(b):
        return {"tokens": b["tokens"],
                "targets": np.roll(b["tokens"], -1, axis=1)}

    def jax_loop(config):
        ts = jtrain.make_train_step(JModel(jcfg))
        params, opt = ts.init_fn(jax.random.key(0))
        shard = jtrain.get_dataset_shard("train")
        for step, b in enumerate(shard.to_jax(batch_size=2)):
            params, opt, m = ts.step_fn(params, opt,
                                        (b["tokens"], b["targets"]))
            jtrain.report({"step": step, "loss": float(m["loss"])})

    def port_loop(config):
        ts = train.make_train_step(LlamaModel(tcfg, device="cpu"))
        params = params_from_numpy(config["params"], tcfg, device="cpu",
                                   param_dtype=torch.float32)
        opt = ts.opt_init(params)
        shard = train.get_dataset_shard("train")
        for step, b in enumerate(shard.to_jax(batch_size=2, device="cpu")):
            params, opt, m = ts.step_fn(params, opt,
                                        (b["tokens"], b["targets"]))
            train.report({"step": step, "loss": m["loss"].item()})

    losses = {}
    for (name, pkg, data), tr, loop, config in (
            (PKGS[0], jtrain, jax_loop, None),
            (PKGS[1], train, port_loop, {"params": start})):
        pkg.init(num_nodes=1, resources={"CPU": 4})
        try:
            ds = data.from_numpy(tokens, "tokens").map_batches(add_targets)
            result = tr.JaxTrainer(
                loop, train_loop_config=config,
                scaling_config=tr.ScalingConfig(num_workers=1),
                run_config=tr.RunConfig(
                    name="llama", storage_path=str(tmp_path / name)),
                datasets={"train": ds}).fit()
        finally:
            pkg.shutdown()
        assert result.error is None, result.error
        losses[name] = [e["metrics"]["loss"]
                        for e in result.metrics_history]
    assert len(losses["port"]) == 3
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=1e-4)


def test_offline_experience_io_and_bc_match_jax(both, tmp_path):
    """``write_experiences`` of either package is read by the other's
    ``read_experiences``; ``train_offline``-style BC over the port's
    dataset gives JAX's losses step by step (FIRST_STEP bar of
    tests/test_torch_rl.py), the port's learner seeded with JAX's state."""
    pytest.importorskip("pyarrow")
    import chip_smoke
    from ray_tpu.rl import offline as joff
    from ray_tpu_torch import rl
    from ray_tpu_torch.rl import offline as toff

    frags = chip_smoke.rl_case_data()["fragments"]
    paths = {}
    for name, mod in (("jax", joff), ("port", toff)):
        paths[name] = str(tmp_path / f"{name}.parquet")
        assert mod.write_experiences(frags, paths[name]) == 512
    want = chip_smoke.transitions(frags)
    for reader, path in ((toff, paths["jax"]), (joff, paths["port"])):
        batches = list(reader.read_experiences(path).iter_batches(
            batch_size=None))
        got = {k: np.concatenate([b[k] for b in batches]) for k in want}
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    jl = joff.BCLearner(4, 2, seed=0)
    pl = chip_smoke.make_learner("BC", "cpu")
    rl.load_learner_state(pl, rl.learner_state(jl))
    losses = {"jax": [], "port": []}
    for name, mod, learner, path in (("jax", joff, jl, paths["jax"]),
                                     ("port", toff, pl, paths["jax"])):
        ds = mod.read_experiences(path)
        for batch in mod.iter_transition_batches(ds, batch_size=64):
            losses[name].append(learner.update(batch)["bc_loss"])
    assert len(losses["port"]) == 8
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# immutability and size accounting
# ---------------------------------------------------------------------------

def _write_in_place(batch):
    for v in batch.values():
        v += 1
    return batch


@pytest.mark.parametrize("source", ["range", "tensor"])
def test_in_place_write_raises_and_leaves_the_block(both, source):
    """JAX's batches are read-only views of Arrow buffers: a function that
    writes into one fails with ``TaskError(ValueError)``. The port's raise
    the same, and the stored block (a second pass, another consumer) is
    unchanged after it."""
    def build(d):
        return (d.range(16, parallelism=2) if source == "range" else
                d.from_numpy(np.arange(24.0).reshape(6, 2, 2), "t"))
    errors = {}
    for name, pkg, data in PKGS:
        ds = build(data).materialize()
        before = ds.take_all()
        with pytest.raises(Exception) as info:
            ds.map_batches(_write_in_place).take_all()
        cause = getattr(info.value, "cause", None)
        errors[name] = (type(info.value).__name__, type(cause).__name__,
                        "read-only" in str(cause))
        assert ds.take_all() == before
        batch = next(iter(ds.iter_batches(batch_size=None)))
        with pytest.raises(ValueError, match="read-only"):
            _write_in_place(batch)
        assert ds.take_all() == before
    assert errors["port"] == errors["jax"]
    assert errors["port"][0].startswith("TaskError")
    assert errors["port"][1:] == ("ValueError", True)


def test_block_size_accounting_and_pickle(both):
    """A block reports its columns' bytes to the store (its accounting,
    spilling and the backpressure policy read them) and pickles read-only,
    as the store's spill path does."""
    from ray_tpu_torch._private import object_store, worker
    from ray_tpu_torch.data.block import Block, block_from_rows
    tensor = np.zeros((64, 32, 32), np.float32)
    block = Block({"t": tensor, "id": np.arange(64)})
    assert block.nbytes == tensor.nbytes + 64 * 8
    assert object_store._nbytes_of(block) >= block.nbytes
    store = worker.global_runtime().alive_nodes()[0].store
    used = store.used_bytes()
    ref = ray_tpu_torch.remote(lambda: block).remote()   # a task's result
    ray_tpu_torch.wait([ref], timeout=60)
    assert store.used_bytes() - used >= block.nbytes
    del ref
    text = block_from_rows([{"s": "x" * 1000, "b": b"y" * 500}] * 4)
    assert text.nbytes >= 6000
    back = pickle.loads(pickle.dumps(block, protocol=5))
    assert back.column_names == ["t", "id"]
    np.testing.assert_array_equal(back.column("t"), tensor)
    assert not back.column("t").flags.writeable
