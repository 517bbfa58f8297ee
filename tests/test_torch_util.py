"""The port's utilities on its runtime: the JAX package's ActorPool and Queue
tests (``tests/test_util.py``), its Pool tests
(``tests/test_util_extras.py``) and its two host-collective tests
(``tests/test_parallel.py``), then the same collectives on CPU
``torch.Tensor``s, whose results keep their type and dtype (ROADMAP C:
JAX's reduction takes ``np.asarray`` of every part)."""

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch.util import ActorPool, Queue
from ray_tpu_torch.util.multiprocessing import Pool


@pytest.fixture
def ray_start_regular():
    rt = ray_tpu_torch.init(num_nodes=1, resources={"CPU": 8})
    yield rt
    ray_tpu_torch.shutdown()


# ---------------------------------------------------------------------------
# tests/test_util.py
# ---------------------------------------------------------------------------

@ray_tpu_torch.remote
class Doubler:
    def double(self, x):
        return 2 * x


def test_actor_pool_map(ray_start_regular):
    pool = ActorPool([Doubler.remote() for _ in range(2)])
    out = list(pool.map(lambda a, v: a.double.remote(v), range(6)))
    assert out == [0, 2, 4, 6, 8, 10]


def test_actor_pool_unordered(ray_start_regular):
    pool = ActorPool([Doubler.remote() for _ in range(2)])
    out = sorted(pool.map_unordered(lambda a, v: a.double.remote(v),
                                    range(6)))
    assert out == [0, 2, 4, 6, 8, 10]


def test_queue_basic(ray_start_regular):
    q = Queue(maxsize=4)
    q.put("a")
    q.put("b")
    assert q.qsize() == 2
    assert q.get() == "a"
    assert q.get() == "b"
    assert q.empty()


def test_queue_nowait_errors(ray_start_regular):
    from ray_tpu_torch.util.queue import Empty, Full
    q = Queue(maxsize=1)
    q.put_nowait(1)
    with pytest.raises(Full):
        q.put_nowait(2)
    assert q.get_nowait() == 1
    with pytest.raises(Empty):
        q.get_nowait()


def test_queue_cross_task(ray_start_regular):
    q = Queue()

    @ray_tpu_torch.remote
    def producer(queue, n):
        for i in range(n):
            queue.put(i)
        return "done"

    @ray_tpu_torch.remote
    def consumer(queue, n):
        return [queue.get() for _ in range(n)]

    p = producer.remote(q, 5)
    c = consumer.remote(q, 5)
    assert ray_tpu_torch.get(c) == [0, 1, 2, 3, 4]
    assert ray_tpu_torch.get(p) == "done"


# ---------------------------------------------------------------------------
# tests/test_util_extras.py
# ---------------------------------------------------------------------------

def _sq(x):
    return x * x


def test_pool_map(ray_start_regular):
    with Pool() as p:
        assert p.map(_sq, range(6)) == [0, 1, 4, 9, 16, 25]


def test_pool_starmap_apply_imap(ray_start_regular):
    with Pool() as p:
        assert p.starmap(lambda a, b: a + b, [(1, 2), (3, 4)]) == [3, 7]
        assert p.apply(_sq, (7,)) == 49
        r = p.apply_async(_sq, (8,))
        assert r.get(timeout=10) == 64
        assert list(p.imap(_sq, [1, 2, 3])) == [1, 4, 9]
        assert sorted(p.imap_unordered(_sq, [1, 2, 3])) == [1, 4, 9]


# ---------------------------------------------------------------------------
# tests/test_parallel.py: host-level collectives
# ---------------------------------------------------------------------------

def test_collective_allreduce(ray_start_regular):
    from ray_tpu_torch.util import collective as col

    @ray_tpu_torch.remote
    class Worker:
        def __init__(self, rank, world):
            col.init_collective_group(world, rank, group_name="g1")
            self.rank = rank

        def allreduce(self):
            out = col.allreduce(np.full(4, self.rank + 1.0),
                                group_name="g1")
            return out

        def gather_bcast(self):
            gathered = col.allgather(np.array([self.rank]), group_name="g1")
            bc = col.broadcast(np.array([self.rank * 10]), src_rank=1,
                               group_name="g1")
            return gathered, bc

    workers = [Worker.remote(i, 3) for i in range(3)]
    outs = ray_tpu_torch.get([w.allreduce.remote() for w in workers])
    for o in outs:
        np.testing.assert_array_equal(o, np.full(4, 6.0))  # 1+2+3
    results = ray_tpu_torch.get([w.gather_bcast.remote() for w in workers])
    gathered, bc = results[0]
    assert [int(g[0]) for g in gathered] == [0, 1, 2]
    assert int(bc[0]) == 10


def test_collective_send_recv(ray_start_regular):
    from ray_tpu_torch.util import collective as col

    @ray_tpu_torch.remote
    class P2P:
        def __init__(self, rank):
            col.init_collective_group(2, rank, group_name="p2p")
            self.rank = rank

        def run(self):
            if self.rank == 0:
                col.send(np.array([42.0]), dst_rank=1, group_name="p2p")
                return None
            return col.recv(src_rank=0, group_name="p2p")

    a, b = P2P.remote(0), P2P.remote(1)
    r0, r1 = ray_tpu_torch.get([a.run.remote(), b.run.remote()])
    assert int(r1[0]) == 42


# ---------------------------------------------------------------------------
# the same collectives on torch tensors
# ---------------------------------------------------------------------------

@ray_tpu_torch.remote
class TensorRank:
    """One rank of a collective group over CPU tensors of ``dtype``."""

    def __init__(self, rank, world, dtype, group="t"):
        from ray_tpu_torch.util import collective as col
        col.init_collective_group(world, rank, group_name=group)
        self.col, self.rank, self.world = col, rank, world
        self.dtype, self.group = dtype, group

    def part(self, n=6):
        g = torch.Generator().manual_seed(self.rank)
        return torch.randn(n, generator=g).to(self.dtype)

    def allreduce(self, op):
        return self.col.allreduce(self.part(), op=op, group_name=self.group)

    def reducescatter(self):
        return self.col.reducescatter(self.part(7), group_name=self.group)

    def allgather(self):
        return self.col.allgather(self.part(), group_name=self.group)

    def broadcast(self):
        return self.col.broadcast(self.part(), src_rank=self.world - 1,
                                  group_name=self.group)

    def ring(self):
        """Send this rank's part to the next rank, receive the previous's."""
        nxt, prev = (self.rank + 1) % self.world, \
            (self.rank - 1) % self.world
        if self.rank == 0:
            self.col.send(self.part(), nxt, group_name=self.group)
            got = self.col.recv(prev, group_name=self.group)
        else:
            got = self.col.recv(prev, group_name=self.group)
            self.col.send(self.part(), nxt, group_name=self.group)
        self.col.barrier(group_name=self.group)
        return got

    def destroy(self):
        self.col.destroy_collective_group(self.group)


def _parts(dtype, world, n=6):
    return [torch.randn(n, generator=torch.Generator().manual_seed(r))
            .to(dtype) for r in range(world)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["sum", "product", "min", "max"])
def test_collective_allreduce_of_tensors(ray_start_regular, dtype, op):
    ranks = [TensorRank.remote(r, 3, dtype, f"t-{op}") for r in range(3)]
    outs = ray_tpu_torch.get([r.allreduce.remote(op) for r in ranks])
    parts = _parts(dtype, 3)
    fn = {"sum": torch.add, "product": torch.mul, "min": torch.minimum,
          "max": torch.maximum}[op]
    want = fn(fn(parts[0], parts[1]), parts[2])
    for o in outs:
        assert isinstance(o, torch.Tensor) and o.dtype == dtype
        assert torch.equal(o, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_collective_gather_scatter_p2p_of_tensors(ray_start_regular, dtype):
    world = 3
    ranks = [TensorRank.remote(r, world, dtype) for r in range(world)]
    parts = _parts(dtype, world)
    gathered = ray_tpu_torch.get([r.allgather.remote() for r in ranks])
    for g in gathered:
        assert all(torch.equal(a, b) for a, b in zip(g, parts))
    for b in ray_tpu_torch.get([r.broadcast.remote() for r in ranks]):
        assert b.dtype == dtype and torch.equal(b, parts[-1])
    scattered = ray_tpu_torch.get([r.reducescatter.remote()
                                   for r in ranks])
    total = sum(_parts(dtype, world, 7)[1:], _parts(dtype, world, 7)[0])
    for s, want in zip(scattered, torch.tensor_split(total, world)):
        assert isinstance(s, torch.Tensor) and s.dtype == dtype
        assert torch.equal(s, want)
    assert [len(s) for s in scattered] == [3, 2, 2]   # np.array_split's
    ring = ray_tpu_torch.get([r.ring.remote() for r in ranks])
    for rank, got in enumerate(ring):
        assert torch.equal(got, parts[(rank - 1) % world])
    ray_tpu_torch.get([r.destroy.remote() for r in ranks])
    with pytest.raises(ValueError):
        ray_tpu_torch.get_actor("_collective_t")


def test_collective_numpy_parts_stay_numpy(ray_start_regular):
    """numpy parts reduce as in JAX's package, to numpy."""
    from ray_tpu_torch.util.collective import collective as impl
    parts = [np.arange(5, dtype=np.float32) + r for r in range(2)]
    out = impl._reduce(parts, "sum")
    assert isinstance(out, np.ndarray) and out.dtype == np.float32
    np.testing.assert_array_equal(out, parts[0] + parts[1])
    with pytest.raises(ValueError, match="unknown reduce op"):
        impl._reduce([torch.ones(2), torch.ones(2)], "mean")
    with pytest.raises(ValueError, match="unknown backend"):
        impl.init_collective_group(2, 0, backend="nccl")


@pytest.fixture
def in_process_runtime(monkeypatch):
    """A runtime with process workers off (JAX's RAY_TPU_PROCESS_WORKERS=0):
    every actor runs on the driver's threads."""
    monkeypatch.setenv("RAY_TPU_PROCESS_WORKERS", "0")
    rt = ray_tpu_torch.init(num_nodes=1, resources={"CPU": 8})
    yield rt
    ray_tpu_torch.shutdown()


def test_actor_pool_and_queue_hand_tensors_over_uncopied(in_process_runtime):
    """On the in-process runtime a tensor through ``ActorPool.map`` and
    through ``Queue`` is the same tensor (chip_smoke.py phase 16 holds a
    CUDA tensor to the same). With process workers on, the actors run in
    worker processes and a tensor is copied (JAX's path)."""

    @ray_tpu_torch.remote
    class Echo:
        def echo(self, x):
            return x

    t = torch.arange(8.0)
    pool = ActorPool([Echo.remote() for _ in range(2)])
    outs = list(pool.map(lambda a, v: a.echo.remote(v), [t, t]))
    assert all(o.data_ptr() == t.data_ptr() for o in outs)
    q = Queue()
    q.put(t)
    assert q.get().data_ptr() == t.data_ptr()
    q.shutdown()


# ---------------------------------------------------------------------------
# tests/test_util_extras.py: the serializability inspector and the joblib
# backend
# ---------------------------------------------------------------------------

def test_inspect_serializability():
    import threading

    from ray_tpu_torch.util.check_serialize import inspect_serializability

    ok, failures = inspect_serializability(lambda x: x + 1)
    assert ok and not failures

    lock = threading.Lock()

    def bad():
        return lock

    ok, failures = inspect_serializability(bad, name="bad")
    assert not ok
    assert any("lock" in f.name for f in failures)


def test_inspect_serializability_follows_the_by_value_pickler():
    """A class defined in a function and a closure over it go by value
    (what a worker process receives), and a leaf deep in an attribute is
    named; the verdicts equal JAX's inspector's over ``cloudpickle``."""
    import threading

    from ray_tpu.util.check_serialize import \
        inspect_serializability as jax_inspect

    from ray_tpu_torch.util.check_serialize import inspect_serializability

    class Local:
        def __init__(self):
            self.scale = 3

    class Holder:
        def __init__(self):
            self.inner = {"ok": 1, "cond": threading.Condition()}

    local = Local()
    cases = [(lambda x: x * local.scale, "closure"), (Holder(), "holder"),
             (Local, "cls")]
    for obj, name in cases:
        ok, failures = inspect_serializability(obj, name=name)
        jok, jfailures = jax_inspect(obj, name=name)
        assert ok == jok, name
        assert sorted(f.name for f in failures) == \
            sorted(f.name for f in jfailures), name
    ok, failures = inspect_serializability(Holder(), name="holder")
    assert not ok and "_lock" in [f.name for f in failures]
    assert inspect_serializability(lambda x: x * local.scale)[0]


def test_joblib_backend(ray_start_regular):
    from joblib import Parallel, delayed, parallel_backend

    from ray_tpu_torch.util.joblib_backend import register_ray

    register_ray()
    with parallel_backend("ray_tpu"):
        out = Parallel(n_jobs=4)(delayed(lambda x: x * x)(i)
                                 for i in range(8))
    assert out == [i * i for i in range(8)]
