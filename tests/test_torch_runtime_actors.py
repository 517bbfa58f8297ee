"""Actor, object store and reference-counting tests of the port's runtime:
the tests of ``tests/test_actors.py`` and ``tests/test_objects.py`` on
``ray_tpu_torch``'s API, each on a fresh one-node runtime of 8 CPUs."""

import asyncio
import gc
import time

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import exceptions as exc
from ray_tpu_torch._private.ids import NodeID, ObjectID
from ray_tpu_torch._private.object_store import LocalObjectStore
from ray_tpu_torch.exceptions import OutOfMemoryError


@pytest.fixture
def runtime():
    """A one-node runtime of 8 CPUs per test."""
    r = rt.init(num_nodes=1, resources={"CPU": 8})
    yield r
    rt.shutdown()


@rt.remote
class Counter:
    def __init__(self, start=0):
        self.n = start

    def inc(self, by=1):
        self.n += by
        return self.n

    def read(self):
        return self.n


def test_actor_basic(runtime):
    c = Counter.remote()
    assert rt.get(c.inc.remote()) == 1
    assert rt.get(c.inc.remote(5)) == 6
    assert rt.get(c.read.remote()) == 6


def test_actor_init_args(runtime):
    c = Counter.remote(100)
    assert rt.get(c.read.remote()) == 100


def test_actor_ordering(runtime):
    c = Counter.remote()
    refs = [c.inc.remote() for _ in range(50)]
    # FIFO per-caller ordering: results are 1..50 in submission order.
    assert rt.get(refs) == list(range(1, 51))


def test_actor_method_error(runtime):
    @rt.remote
    class Bad:
        def boom(self):
            raise ValueError("actor method error")

        def ok(self):
            return "fine"

    b = Bad.remote()
    with pytest.raises(ValueError, match="actor method error"):
        rt.get(b.boom.remote())
    # Actor survives method errors.
    assert rt.get(b.ok.remote()) == "fine"


def test_actor_init_failure(runtime):
    @rt.remote
    class Broken:
        def __init__(self):
            raise RuntimeError("init failed")

        def m(self):
            return 1

    b = Broken.remote()
    with pytest.raises(Exception):
        rt.get(b.m.remote(), timeout=10)


def test_named_actor(runtime):
    Counter.options(name="counter1").remote(7)
    h = rt.get_actor("counter1")
    assert rt.get(h.read.remote()) == 7


def test_named_actor_get_if_exists(runtime):
    h1 = Counter.options(name="c", get_if_exists=True).remote(1)
    h2 = Counter.options(name="c", get_if_exists=True).remote(999)
    rt.get(h1.inc.remote())
    assert rt.get(h2.read.remote()) == 2  # same actor


def test_named_actor_duplicate_raises(runtime):
    Counter.options(name="dup").remote()
    time.sleep(0.2)
    with pytest.raises(ValueError):
        Counter.options(name="dup").remote()


def test_get_actor_missing(runtime):
    with pytest.raises(ValueError):
        rt.get_actor("nope")


def test_kill_actor(runtime):
    c = Counter.remote()
    rt.get(c.inc.remote())
    rt.kill(c)
    with pytest.raises((exc.ActorDiedError, exc.ActorError)):
        rt.get(c.inc.remote())


def test_actor_handle_serialization(runtime):
    c = Counter.remote()

    @rt.remote
    def use(handle):
        return rt.get(handle.inc.remote(10))

    assert rt.get(use.remote(c)) == 10
    assert rt.get(c.read.remote()) == 10


def test_actor_max_concurrency(runtime):
    @rt.remote(max_concurrency=4)
    class Sleeper:
        def nap(self):
            time.sleep(0.3)
            return 1

    s = Sleeper.remote()
    t0 = time.monotonic()
    rt.get([s.nap.remote() for _ in range(4)])
    elapsed = time.monotonic() - t0
    assert elapsed < 1.0  # ran concurrently, not 1.2s serial


def test_async_actor(runtime):
    @rt.remote(max_concurrency=8)
    class AsyncActor:
        async def work(self, i):
            await asyncio.sleep(0.2)
            return i * 2

    a = AsyncActor.remote()
    t0 = time.monotonic()
    out = rt.get([a.work.remote(i) for i in range(8)])
    elapsed = time.monotonic() - t0
    assert out == [i * 2 for i in range(8)]
    assert elapsed < 1.0  # concurrent awaits


def test_exit_actor(runtime):
    @rt.remote
    class Quitter:
        def quit(self):
            rt.exit_actor()

        def m(self):
            return 1

    q = Quitter.remote()
    rt.get(q.quit.remote())
    with pytest.raises((exc.ActorDiedError, exc.ActorError)):
        rt.get(q.m.remote())


def test_actor_resource_accounting(runtime):
    @rt.remote(num_cpus=4)
    class Big:
        def ping(self):
            return "pong"

    b1 = Big.remote()
    b2 = Big.remote()
    assert rt.get(b1.ping.remote()) == "pong"
    assert rt.get(b2.ping.remote()) == "pong"
    avail = rt.available_resources()
    assert avail.get("CPU", 0) == 0  # 2 actors x 4 CPUs on an 8-CPU node


def test_detached_actor_namespace(runtime):
    Counter.options(name="d1", lifetime="detached",
                    namespace="other").remote(3)
    h = rt.get_actor("d1", namespace="other")
    assert rt.get(h.read.remote()) == 3


def test_concurrency_groups(runtime):
    """Named groups get isolated thread pools with their own limits
    (reference: concurrency_group_manager.h, SURVEY.md §8.4)."""
    import threading
    import time

    @rt.remote(concurrency_groups={"io": 2, "compute": 1})
    class Worker:
        def __init__(self):
            self.events = []
            self.lock = threading.Lock()

        def io_task(self, i):
            with self.lock:
                self.events.append(("io_start", i))
            time.sleep(0.2)
            with self.lock:
                self.events.append(("io_end", i))
            return i

        def compute_task(self, i):
            time.sleep(0.05)
            return i

        def get_events(self):
            with self.lock:
                return list(self.events)

    w = Worker.remote()
    t0 = time.time()
    io_refs = [w.io_task.options(concurrency_group="io").remote(i)
               for i in range(2)]
    comp_refs = [w.compute_task.options(
        concurrency_group="compute").remote(i) for i in range(2)]
    assert sorted(rt.get(io_refs)) == [0, 1]
    io_time = time.time() - t0
    # 2 io tasks of 0.2s overlapped in the io group (limit 2)
    assert io_time < 0.39
    assert sorted(rt.get(comp_refs)) == [0, 1]
    events = rt.get(w.get_events.remote())
    starts = [e for e in events if e[0] == "io_start"]
    assert len(starts) == 2


# -- objects and reference counting (tests/test_objects.py) ---------------

def test_refcount_frees_on_del(runtime):
    ref = rt.put(np.ones((500, 500)))
    oid = ref.id
    assert runtime.refcounter.ref_count(oid) >= 1
    del ref
    gc.collect()
    time.sleep(0.1)
    assert runtime.refcounter.ref_count(oid) == 0
    assert not runtime.memory_store.contains(oid)


def test_refcount_pinned_by_pending_task(runtime):

    @rt.remote
    def slow(x):
        time.sleep(0.5)
        return x

    ref = rt.put(123)
    oid = ref.id
    out = slow.remote(ref)
    del ref
    gc.collect()
    # Task argument pin keeps it alive while the task runs.
    assert rt.get(out) == 123


def test_nested_ref_containment(runtime):
    inner = rt.put("inner-value")
    outer = rt.put([inner])
    inner_id = inner.id
    del inner
    gc.collect()
    time.sleep(0.05)
    # Containment pin: inner survives because outer holds it.
    assert runtime.refcounter.ref_count(inner_id) >= 1
    got = rt.get(outer)
    assert rt.get(got[0]) == "inner-value"


def test_store_eviction_spill_roundtrip(tmp_path):
    store = LocalObjectStore(NodeID.from_random(), capacity_bytes=1_000_000,
                             spill_dir=str(tmp_path))
    oids = []
    for i in range(10):
        oid = ObjectID.from_random()
        store.put(oid, np.full((200, 200), i))  # 320KB each
        oids.append(oid)
    assert store.stats["spills"] > 0
    # Every object still readable (restored from disk transparently).
    for i, oid in enumerate(oids):
        assert store.get(oid)[0][0] == i


def test_store_capacity_error():
    store = LocalObjectStore(NodeID.from_random(), capacity_bytes=1000)
    with pytest.raises(OutOfMemoryError):
        store.put(ObjectID.from_random(), np.ones(10_000))


def test_object_immutability(runtime):
    arr = np.zeros(5)
    ref = rt.put(arr)
    got = rt.get(ref)
    with pytest.raises(ValueError):
        got[0] = 1


def test_shared_value_across_consumers(runtime):
    big = np.random.rand(400, 400)
    ref = rt.put(big)

    @rt.remote
    def reader(x):
        return float(x.sum())

    outs = rt.get([reader.remote(ref) for _ in range(4)])
    assert all(abs(o - big.sum()) < 1e-6 for o in outs)


def test_store_restore_does_not_respill_itself(tmp_path):
    """Regression: _restore cleared spilled_path BEFORE the pressure
    scan, so _ensure_space could pick the very entry being restored,
    re-spill it, and hand the caller value=None while _used
    double-counted it. The entry is now pinned across the scan: with a
    spillable neighbor the restore succeeds; with everything pinned the
    infeasible restore raises OutOfMemoryError LOUDLY instead of
    silently corrupting the read."""
    store = LocalObjectStore(NodeID.from_random(), capacity_bytes=100_000,
                             spill_dir=str(tmp_path))
    a, b = ObjectID.from_random(), ObjectID.from_random()
    store.put(a, np.full(60_000, 1, dtype=np.uint8))
    store.put(b, np.full(60_000, 2, dtype=np.uint8))     # spills a
    assert store.stats["spills"] >= 1
    # feasible: the scan spills b (unpinned), never the restoring a
    val = store.get(a)
    assert val is not None and val[0] == 1
    # infeasible: b pinned, a shielded -> loud OOM, not value=None
    store2 = LocalObjectStore(NodeID.from_random(),
                              capacity_bytes=100_000,
                              spill_dir=str(tmp_path / "s2"))
    store2.put(a, np.full(60_000, 1, dtype=np.uint8))
    store2.put(b, np.full(60_000, 2, dtype=np.uint8))
    with store2._lock:
        store2._entries[b].pinned += 1
    with pytest.raises(OutOfMemoryError):
        store2.get(a)
    # the failed restore consumed NOTHING: accounting intact, spill
    # file intact, and the restore succeeds once pressure drops
    with store2._lock:
        assert store2._used == 60_000          # b only; a uncounted
        assert store2._entries[a].spilled_path is not None
        store2._entries[b].pinned -= 1
    val = store2.get(a)
    assert val is not None and val[0] == 1
    with store2._lock:
        assert store2._used == 60_000          # b spilled, a resident


# -- values freed once nothing holds them (the port's repairs) --------------

def _freed(runtime, oid, timeout=10.0) -> bool:
    """Poll until the runtime has dropped ``oid`` everywhere: frees run on
    the runtime's threads once a task's bookkeeping is done."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        gc.collect()
        if (runtime.refcounter.ref_count(oid) == 0
                and not runtime.memory_store.contains(oid)):
            return True
        time.sleep(0.01)
    return False


def test_task_and_actor_args_freed_after_the_call(runtime):
    """A finished task's spec (which holds its ObjectRef args) is dropped by
    the thread that ran it; it does not pin the args' values until that
    thread's next task."""
    @rt.remote
    def total(x):
        return float(x.sum())

    @rt.remote
    class Holder:
        def total(self, x):
            return float(x.sum())

    h = Holder.remote()
    for call in (total.remote, h.total.remote):
        ref = rt.put(np.ones((512, 512)))
        oid = ref.id
        assert rt.get(call(ref)) == 512 * 512
        del ref
        assert _freed(runtime, oid)


def test_streamed_items_freed_once_consumed(runtime):
    """A streamed item is pinned by its consumer's ref only, not by the
    generator's table once handed out."""
    @rt.remote
    def gen(n):
        for i in range(n):
            yield np.full((256, 256), i)

    oids = []
    for ref in gen.remote(3):
        oids.append(ref.id)
        assert rt.get(ref)[0, 0] == len(oids) - 1
        del ref
    assert all(_freed(runtime, oid) for oid in oids)


def test_concurrent_submitters_lose_no_update(runtime):
    """Many threads submit tasks and actor calls at once under a short
    switch interval: the actor's ordered counter sees every call, every
    task's result comes back, and the ledger returns to its total."""
    import sys
    import threading

    @rt.remote
    def square(x):
        return x * x

    c = Counter.remote()
    n_threads, per_thread = 16, 40
    results, errors = {}, []

    def submit(t):
        try:
            refs = [square.remote(t * per_thread + i)
                    for i in range(per_thread)]
            incs = [c.inc.remote() for _ in range(per_thread)]
            results[t] = (rt.get(refs, timeout=60), rt.get(incs, timeout=60))
        except Exception as e:  # noqa: BLE001 - reported by the assert
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=submit, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    for t, (squares, _) in results.items():
        assert squares == [(t * per_thread + i) ** 2
                           for i in range(per_thread)]
    seen = sorted(v for _, incs in results.values() for v in incs)
    assert seen == list(range(1, n_threads * per_thread + 1))
    assert rt.get(c.read.remote()) == n_threads * per_thread
    # a completion's release may still ride another thread's flush of the
    # ledger just after its get() returned
    deadline = time.monotonic() + 10.0
    while (rt.available_resources() != rt.cluster_resources()
           and time.monotonic() < deadline):
        time.sleep(0.01)
    assert rt.available_resources() == rt.cluster_resources()
