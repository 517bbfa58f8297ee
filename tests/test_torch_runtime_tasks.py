"""Core task/object API tests of the port's runtime: the tests of
``tests/test_core_tasks.py`` on ``ray_tpu_torch``'s API, each on a fresh
one-node runtime of 8 CPUs. Every task runs in this process, as the JAX
runtime's do with process workers off."""

import time

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import exceptions as exc


@pytest.fixture
def runtime():
    """A one-node runtime of 8 CPUs per test."""
    r = rt.init(num_nodes=1, resources={"CPU": 8})
    yield r
    rt.shutdown()


def test_put_get(runtime):
    ref = rt.put(42)
    assert rt.get(ref) == 42
    ref2 = rt.put({"a": [1, 2, 3]})
    assert rt.get(ref2) == {"a": [1, 2, 3]}


def test_put_numpy_zero_copy_readonly(runtime):
    arr = np.arange(10)
    ref = rt.put(arr)
    got = rt.get(ref)
    np.testing.assert_array_equal(got, arr)
    with pytest.raises(ValueError):
        got[0] = 99  # store values are immutable


def test_simple_task(runtime):
    @rt.remote
    def add(a, b):
        return a + b

    assert rt.get(add.remote(1, 2)) == 3


def test_task_with_ref_args(runtime):
    @rt.remote
    def add(a, b):
        return a + b

    x = rt.put(10)
    y = add.remote(x, 5)
    z = add.remote(y, y)
    assert rt.get(z) == 30


def test_task_chain_parallel(runtime):
    @rt.remote
    def sq(x):
        return x * x

    refs = [sq.remote(i) for i in range(20)]
    assert rt.get(refs) == [i * i for i in range(20)]


def test_multiple_returns(runtime):
    @rt.remote(num_returns=3)
    def three():
        return 1, 2, 3

    a, b, c = three.remote()
    assert rt.get([a, b, c]) == [1, 2, 3]


def test_task_error_propagation(runtime):
    @rt.remote(max_retries=0)
    def boom():
        raise ValueError("bad")

    with pytest.raises(ValueError, match="bad"):
        rt.get(boom.remote())


def test_error_propagates_through_dependency(runtime):
    @rt.remote(max_retries=0)
    def boom():
        raise KeyError("first")

    @rt.remote
    def consume(x):
        return x

    with pytest.raises(exc.TaskError):
        rt.get(consume.remote(boom.remote()))


def test_get_timeout(runtime):
    @rt.remote
    def slow():
        time.sleep(5)
        return 1

    with pytest.raises(exc.GetTimeoutError):
        rt.get(slow.remote(), timeout=0.2)


def test_wait(runtime):
    @rt.remote
    def fast():
        return 1

    @rt.remote
    def slow():
        time.sleep(10)
        return 2

    f, s = fast.remote(), slow.remote()
    ready, not_ready = rt.wait([f, s], num_returns=1, timeout=5)
    assert ready == [f]
    assert not_ready == [s]


def test_wait_timeout_empty(runtime):
    @rt.remote
    def slow():
        time.sleep(10)

    ready, not_ready = rt.wait([slow.remote()], num_returns=1,
                                    timeout=0.1)
    assert ready == []
    assert len(not_ready) == 1


def test_options_override(runtime):
    @rt.remote(num_cpus=1)
    def f():
        return rt.get_runtime_context().get_assigned_resources()

    res = rt.get(f.options(num_cpus=2).remote())
    assert res.get("CPU") == 2


def test_nested_tasks(runtime):
    @rt.remote
    def inner(x):
        return x + 1

    @rt.remote
    def outer(x):
        return rt.get(inner.remote(x)) + 10

    assert rt.get(outer.remote(1)) == 12


def test_nested_refs_in_containers(runtime):
    @rt.remote
    def make():
        return 7

    @rt.remote
    def consume(refs):
        return sum(rt.get(r) for r in refs)

    refs = [make.remote() for _ in range(3)]
    # Passing refs inside a list does NOT auto-resolve (parity with ray).
    assert rt.get(consume.remote(refs)) == 21


def test_retry_on_app_error(runtime, tmp_path):
    # Attempts counted out-of-band (a file), as in the reference test.
    counter = str(tmp_path / "attempts")

    @rt.remote(max_retries=3, retry_exceptions=True)
    def flaky():
        import os
        n = len(os.listdir(os.path.dirname(counter)))
        open(f"{counter}.{n}", "w").close()
        if n + 1 < 3:
            raise RuntimeError("transient")
        return "ok"

    assert rt.get(flaky.remote()) == "ok"
    import os
    assert len(os.listdir(tmp_path)) == 3


def test_retry_exceptions_allowlist(runtime, tmp_path):
    counter = str(tmp_path / "attempts")

    @rt.remote(max_retries=5, retry_exceptions=[KeyError])
    def flaky():
        import os
        n = len(os.listdir(os.path.dirname(counter)))
        open(f"{counter}.{n}", "w").close()
        raise ValueError("not retryable")

    with pytest.raises(ValueError):
        rt.get(flaky.remote())
    import os
    assert len(os.listdir(tmp_path)) == 1


def test_cancel_pending(runtime):
    @rt.remote(num_cpus=8)
    def hog():
        time.sleep(3)
        return 1

    @rt.remote(num_cpus=8)
    def queued():
        return 2

    h = hog.remote()
    q = queued.remote()  # stuck behind hog
    time.sleep(0.1)
    rt.cancel(q)
    with pytest.raises(exc.TaskCancelledError):
        rt.get(q)
    assert rt.get(h) == 1


def test_runtime_context(runtime):
    @rt.remote
    def ctx():
        c = rt.get_runtime_context()
        return c.get_task_id(), c.get_node_id(), c.get_job_id()

    task_id, node_id, job_id = rt.get(ctx.remote())
    assert task_id and node_id and job_id


def test_cluster_resources(runtime):
    res = rt.cluster_resources()
    assert res["CPU"] == 8


def test_large_object_roundtrip(runtime):
    arr = np.random.rand(1000, 1000)  # 8 MB -> node store

    @rt.remote
    def identity(x):
        return x

    got = rt.get(identity.remote(arr))
    np.testing.assert_array_equal(got, arr)


def test_streaming_generator(runtime):
    @rt.remote
    def gen(n):
        for i in range(n):
            yield i * 10

    out = [rt.get(ref) for ref in gen.remote(5)]
    assert out == [0, 10, 20, 30, 40]


def test_streaming_generator_early_consumption(runtime):
    @rt.remote
    def gen():
        yield "first"
        time.sleep(3)
        yield "second"

    it = gen.remote()
    t0 = time.monotonic()
    first = rt.get(next(it))
    assert first == "first"
    assert time.monotonic() - t0 < 2.0  # did not wait for task completion


def test_generator_error_propagates(runtime):
    @rt.remote(max_retries=0)
    def gen():
        yield 1
        raise RuntimeError("mid-stream failure")

    it = gen.remote()
    assert rt.get(next(it)) == 1
    with pytest.raises(Exception, match="mid-stream"):
        next(it)
        next(it)


def test_free_while_the_locations_lock_is_held(runtime):
    """A ref dropped on a thread that holds the runtime's locations lock
    (what a cyclic GC pass inside a locked section does: it runs the ref's
    ``__del__`` there) frees the object instead of deadlocking."""
    import threading

    @rt.remote
    def big():
        return np.ones(1 << 18)

    ref = big.remote()
    rt.get(ref)
    oid = ref.id

    def drop_under_lock(box):
        with runtime._loc_lock:
            box.pop()       # the last handle: __del__ -> _free_object

    box = [ref]
    del ref
    t = threading.Thread(target=drop_under_lock, args=(box,), daemon=True)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive(), "the free deadlocked on the locations lock"
    with runtime._loc_lock:
        assert oid not in runtime._locations
