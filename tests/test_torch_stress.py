"""Stress and concurrency on the port: the nine tier-1 tests of JAX's
``tests/test_stress.py`` on ``ray_tpu_torch``. They hammer the dispatch
loop, the refcount's ``__del__`` cascades and a generator's backpressure
under consumers that race, and take the CI-sized slices of the reference's
scale envelopes (10,000 queued tasks, 1,000 actors, 1,000 object
arguments). The three ``envelope`` tests are in
``test_torch_stress_envelope.py``.
"""

import threading
import time

import numpy as np
import pytest

import ray_tpu_torch


@pytest.fixture
def ray_start_regular():
    """JAX's fixture: a 1-node runtime of 8 CPUs a test."""
    rt = ray_tpu_torch.init(num_nodes=1, resources={"CPU": 8})
    yield rt
    ray_tpu_torch.shutdown()


def test_dispatch_loop_many_small_tasks(ray_start_regular):
    """A burst of small tasks through the process-worker plane."""

    @ray_tpu_torch.remote
    def inc(x):
        return x + 1

    t0 = time.monotonic()
    refs = [inc.remote(i) for i in range(300)]
    out = ray_tpu_torch.get(refs)
    elapsed = time.monotonic() - t0
    assert out == list(range(1, 301))
    assert elapsed < 60  # sanity bound, not a perf SLA


def test_concurrent_submitters(ray_start_regular):
    """Many driver threads submitting in parallel must not corrupt
    dispatch/refcount state."""

    @ray_tpu_torch.remote
    def work(tid, i):
        return tid * 1000 + i

    errors = []
    results = {}

    def submitter(tid):
        try:
            refs = [work.remote(tid, i) for i in range(40)]
            results[tid] = ray_tpu_torch.get(refs)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=submitter, args=(t,))
               for t in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors
    for tid, vals in results.items():
        assert vals == [tid * 1000 + i for i in range(40)]


def test_refcount_del_cascade(ray_start_regular):
    """Dropping thousands of refs (and chains of dependent refs) from
    multiple threads must not deadlock the refcounter (a __del__ cascade
    deadlock was fixed once; keep it dead)."""

    @ray_tpu_torch.remote
    def blob():
        return np.zeros(64 * 1024)

    @ray_tpu_torch.remote
    def passthrough(x):
        return x.sum()

    def churn():
        for _ in range(10):
            refs = [blob.remote() for _ in range(20)]
            mids = [passthrough.remote(r) for r in refs]
            del refs          # parent refs die while children in flight
            ray_tpu_torch.get(mids)
            del mids

    threads = [threading.Thread(target=churn) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
        assert not t.is_alive(), "refcount churn deadlocked"


def test_generator_backpressure_multi_consumer(ray_start_regular):
    """Multiple threads consuming one backpressured stream: every item
    is delivered exactly once across consumers, producer never deadlocks."""

    @ray_tpu_torch.remote(_generator_backpressure_num_objects=4)
    def gen(n):
        for i in range(n):
            yield i

    it = gen.remote(60)
    seen = []
    lock = threading.Lock()

    def consume():
        while True:
            try:
                ref = next(it)
            except StopIteration:
                return
            value = ray_tpu_torch.get(ref)
            with lock:
                seen.append(value)

    threads = [threading.Thread(target=consume) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive(), "consumer hung"
    assert sorted(seen) == list(range(60))


def test_many_actors_concurrent_calls(ray_start_regular):
    @ray_tpu_torch.remote
    class Cell:
        def __init__(self, base):
            self.base = base
            self.n = 0

        def bump(self):
            self.n += 1
            return self.base + self.n

    actors = [Cell.remote(i * 100) for i in range(8)]
    refs = [a.bump.remote() for a in actors for _ in range(10)]
    out = ray_tpu_torch.get(refs)
    assert len(out) == 80
    final = ray_tpu_torch.get([a.bump.remote() for a in actors])
    assert final == [i * 100 + 11 for i in range(8)]


def test_wait_under_churn(ray_start_regular):
    """ray_tpu_torch.wait over a moving set while tasks finish concurrently."""

    @ray_tpu_torch.remote
    def sleepy(ms):
        time.sleep(ms / 1000.0)
        return ms

    refs = [sleepy.remote((i % 7) * 15) for i in range(60)]
    remaining = list(refs)
    collected = []
    while remaining:
        done, remaining = ray_tpu_torch.wait(remaining, num_returns=1,
                                       timeout=30)
        assert done, "wait() starved despite pending work"
        collected.extend(ray_tpu_torch.get(done))
    assert len(collected) == 60


def test_queued_task_backlog_10000(ray_start_regular):
    """Scale envelope, CI-sized slice of the reference's 1M-queued-task
    target (release/benchmarks/README.md:25-31): 10,000 no-op tasks
    queued before any get, then fully drained, results in order — and
    the drain rate must hold vs a 1,000-task run (no superlinear
    degradation as the backlog deepens)."""

    @ray_tpu_torch.remote
    def val(i):
        return i

    t0 = time.perf_counter()
    out = ray_tpu_torch.get([val.remote(i) for i in range(1000)], timeout=300)
    small_rate = 1000 / (time.perf_counter() - t0)
    assert out == list(range(1000))

    t0 = time.perf_counter()
    refs = [val.remote(i) for i in range(10_000)]
    out = ray_tpu_torch.get(refs, timeout=900)
    big_rate = 10_000 / (time.perf_counter() - t0)
    assert out == list(range(10_000))
    # 10x backlog may not drain >3x slower per task (generous CI margin)
    assert big_rate > small_rate / 3, (
        f"superlinear degradation: {small_rate:.0f}/s @1k vs "
        f"{big_rate:.0f}/s @10k")


def test_many_actors_1000(ray_start_regular):
    """1,000 live actors (reference envelope: 40k cluster-wide; this is
    the single-host CI slice), every one answering."""

    @ray_tpu_torch.remote(_in_process=True)
    class Cell:
        def __init__(self, i):
            self.i = i

        def get(self):
            return self.i

    cells = [Cell.remote(i) for i in range(1000)]
    out = ray_tpu_torch.get([c.get.remote() for c in cells], timeout=600)
    assert out == list(range(1000))
    for c in cells:
        ray_tpu_torch.kill(c)


def test_many_object_args_one_task(ray_start_regular):
    """1,000 object arguments to a single task (reference envelope:
    10k+ on a 64-core box; CI slice on 1 CPU)."""

    @ray_tpu_torch.remote
    def total(*parts):
        return sum(parts)

    refs = [ray_tpu_torch.put(i) for i in range(1000)]
    assert ray_tpu_torch.get(total.remote(*refs), timeout=300) == sum(
        range(1000))
