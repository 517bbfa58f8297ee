"""The port's data plane depth on its runtime: the JAX package's
``tests/test_data_backpressure.py`` copied (backpressure policies, elastic
actor pools, non-blocking limit, filesystem-seamed datasources).

Reference: ``data/_internal/execution/backpressure_policy/`` and
``data/tests/test_backpressure_e2e.py`` (small store, big dataset);
``actor_pool_map_operator.py`` autoscaling; 41-datasource read_api
behind one path/filesystem seam.
"""

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import data as rdata


@pytest.fixture
def ray_small_store():
    rt = ray_tpu_torch.init(num_nodes=1, resources={"CPU": 8},
                            object_store_memory=24 * 1024 * 1024)
    yield rt
    ray_tpu_torch.shutdown()


@pytest.fixture
def ray_start_regular():
    rt = ray_tpu_torch.init(num_nodes=1, resources={"CPU": 8})
    yield rt
    ray_tpu_torch.shutdown()


def test_backpressure_e2e_small_store(ray_small_store):
    """A dataset far larger than the object store streams through to
    completion — the store-usage policy throttles upstream reads so the
    pipeline drains instead of dying on allocation."""
    from ray_tpu_torch.data.context import DataContext

    ctx = DataContext.get_current()
    old = ctx.object_store_backpressure_threshold
    ctx.object_store_backpressure_threshold = 0.5
    try:
        n_blocks, rows = 24, 40_000  # ~24 x 320KB of int64 ≈ 7.7MB live

        def make(i):
            def read():
                from ray_tpu_torch.data.block import Block
                return Block({"x": np.full(rows, i, np.int64)})
            return read

        from ray_tpu_torch.data.dataset import Dataset
        from ray_tpu_torch.data import logical as L

        ds = Dataset(L.Read("read_big", [],
                            read_tasks=[make(i) for i in range(n_blocks)]))
        total = 0
        for batch in ds.iter_batches(batch_size=None):
            total += int(len(batch["x"]))
        assert total == n_blocks * rows
    finally:
        ctx.object_store_backpressure_threshold = old


def test_object_store_policy_throttles_upstream(ray_small_store):
    from ray_tpu_torch.data.backpressure_policy import \
        ObjectStoreMemoryBackpressurePolicy

    class _Op:
        def __init__(self, inq, active, cap):
            self.inqueue = inq
            self.active = active
            self.max_in_flight = cap

    class _Exec:
        pass

    up, down = _Op([1], [], 4), _Op([1], [], 4)
    ex = _Exec()
    ex.ops = [up, down]
    policy = ObjectStoreMemoryBackpressurePolicy(threshold=0.5)
    policy._store_pressure = lambda: 0.9  # force pressure
    assert policy.can_launch(down, ex)      # downstream-most may drain
    assert not policy.can_launch(up, ex)    # upstream throttled
    policy._store_pressure = lambda: 0.1
    assert policy.can_launch(up, ex)


def test_actor_pool_autoscales(ray_start_regular):
    """concurrency=(1, 3): the pool grows under backlog and shrinks back
    toward min when input dries up."""
    from ray_tpu_torch.data import logical as L
    from ray_tpu_torch.data.execution import ActorPoolMapOperator

    class Slow:
        def __call__(self, b):
            import time
            time.sleep(0.05)
            return b

    op = L.MapBatches("mb", [], fn=None, fn_constructor=Slow,
                      batch_format="numpy", concurrency=(1, 3))
    phys = ActorPoolMapOperator("pool", op)
    assert len(phys.workers) == 1
    # grow ONLY when the pool is the binding constraint: all workers
    # busy AND input queued
    phys.inqueue.extend([object(), object(), object(), object()])
    phys.maybe_autoscale()
    assert len(phys.workers) == 1  # nothing busy: no growth
    phys.active["ref-a"] = phys.workers[0]
    phys.maybe_autoscale()
    assert len(phys.workers) == 2
    phys.active["ref-b"] = phys.workers[1]
    phys.maybe_autoscale()
    assert len(phys.workers) == 3  # grew to max
    # shrink skips BUSY workers: with workers 0 and 1 busy, the idle
    # worker 2 is reclaimed after the idle window
    phys.inqueue.clear()
    for _ in range(phys._IDLE_TICKS_BEFORE_SHRINK + 1):
        phys.maybe_autoscale()
    assert len(phys.workers) == 2
    assert all(id(w) in {id(x) for x in phys.active.values()}
               for w in phys.workers)
    phys.shutdown()


def test_actor_pool_e2e_with_range(ray_start_regular):
    class Add(object):
        def __init__(self):
            self.c = 5

        def __call__(self, b):
            return {"id": b["id"] + self.c}

    ds = rdata.range(30, parallelism=6).map_batches(
        Add, concurrency=(1, 2))
    assert sorted(r["id"] for r in ds.take_all()) == list(
        np.arange(5, 35))


def test_limit_is_nonblocking_and_exact(ray_start_regular):
    ds = rdata.range(1000, parallelism=10).limit(123)
    rows = ds.take_all()
    # exactly 123 distinct rows (blocks stream in completion order)
    ids = [r["id"] for r in rows]
    assert len(ids) == 123
    assert len(set(ids)) == 123


def test_read_images_roundtrip(ray_start_regular, tmp_path):
    Image = pytest.importorskip("PIL.Image")

    for i in range(3):
        arr = np.full((8, 6, 3), i * 40, np.uint8)
        Image.fromarray(arr).save(tmp_path / f"img{i}.png")
    ds = rdata.read_images(str(tmp_path), size=(4, 3))
    batches = list(ds.iter_batches(batch_size=None))
    imgs = np.concatenate([b["image"] for b in batches])
    assert imgs.shape == (3, 4, 3, 3)
    assert sorted(int(im[0, 0, 0]) for im in imgs) == [0, 40, 80]


def test_read_numpy(ray_start_regular, tmp_path):
    np.save(tmp_path / "a.npy", np.arange(5))
    np.save(tmp_path / "b.npy", np.arange(5, 10))
    ds = rdata.read_numpy(str(tmp_path))
    vals = sorted(v for b in ds.iter_batches(batch_size=None)
                  for v in b["data"].tolist())
    assert vals == list(range(10))


def test_filesystem_scheme_errors(ray_start_regular):
    from ray_tpu_torch.data.filesystem import resolve_filesystem

    with pytest.raises(NotImplementedError, match="S3"):
        resolve_filesystem("s3://bucket/key")
    fs, path = resolve_filesystem("/tmp/x")
    assert path == "/tmp/x"


def test_filesystem_registration(ray_start_regular, tmp_path):
    from ray_tpu_torch.data.filesystem import (LocalFileSystem,
                                         register_filesystem,
                                         resolve_filesystem)

    class Prefixed(LocalFileSystem):
        def open_input(self, path):
            return super().open_input(str(tmp_path / path))

    register_filesystem("mem", Prefixed())
    (tmp_path / "f.txt").write_text("hello")
    fs, rest = resolve_filesystem("mem://f.txt")
    assert fs.open_input(rest).read() == b"hello"
