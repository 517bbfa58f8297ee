"""The port's control-plane batching and pipelined dispatch (copies of
``tests/test_batching.py``; its ``test_recv_exact_shared_implementation``
is copied in tests/test_torch_fast_lane.py):

- batched submit is semantically transparent (results, streams,
  multi-return, errors identical to the per-task protocol), and
  ``submit_batch=False`` sends one classic submit a task whose completion
  still rides the result pump;
- a dropped/errored batch flush (``batch.submit_flush`` failpoint)
  retries idempotently: no double execution, per-actor ordering
  preserved;
- the free buffer coalesces, retries on ``batch.free_flush`` faults,
  and flushes synchronously (shutdown/drain contract);
- the daemon's result pump requeues frames lost at
  ``batch.result_flush``;
- the feasibility cache invalidates on node add / remove / drain.
"""

import time

import pytest

import ray_tpu_torch as ray_tpu
from ray_tpu_torch._private import failpoints as fp
from ray_tpu_torch._private.ids import TaskID
from ray_tpu_torch._private.task_spec import TaskKind, TaskSpec


@pytest.fixture(autouse=True)
def _reset_failpoints():
    yield
    fp.reset()
    if ray_tpu.is_initialized():
        ray_tpu.shutdown()


@pytest.fixture
def daemon_cluster():
    rt = ray_tpu.init(num_nodes=2, resources={"CPU": 4},
                      cluster="daemons")
    yield rt
    ray_tpu.shutdown()


# Two returns force the classic wire path (the native fast lane only
# carries single-return plain tasks), which is exactly the path the
# submit coalescer batches.
@ray_tpu.remote(num_returns=2)
def pair(x):
    return x, x + 1


# ---------------------------------------------------------------------------
# batched submit: transparency
# ---------------------------------------------------------------------------

def test_batched_submit_transparent():
    """Every classic-path submission rides push_task_batch frames and
    completes with identical semantics."""
    ray_tpu.init(num_nodes=2, resources={"CPU": 4}, cluster="daemons",
                 # generous linger: concurrent submissions coalesce
                 # deterministically even on a loaded 2-core box
                 _system_config={"submit_linger_us": 5000})
    try:
        fp.configure("batch.submit_flush", "delay", 0)   # pure observer
        refs = [pair.remote(i) for i in range(40)]
        flat = [r for ab in refs for r in ab]
        out = ray_tpu.get(flat)
        assert out == [v for i in range(40) for v in (i, i + 1)]
        log = fp.hit_log("batch.submit_flush")
        assert log, "no batch flush fired: coalescer not engaged"
        assert sum(e["n"] for e in log) == 40   # all rode the coalescer
        # at least one frame actually coalesced multiple tasks
        assert max(e["n"] for e in log) > 1
    finally:
        ray_tpu.shutdown()


def test_batched_submit_stream_and_error(daemon_cluster):
    @ray_tpu.remote
    def gen(n):
        for i in range(n):
            yield i

    @ray_tpu.remote(num_returns=2, max_retries=0)
    def boom():
        raise ValueError("nope")

    assert [ray_tpu.get(r) for r in gen.remote(4)] == [0, 1, 2, 3]
    a, _b = boom.remote()
    with pytest.raises(ValueError, match="nope"):
        ray_tpu.get(a)


def test_batching_can_be_disabled():
    rt = ray_tpu.init(num_nodes=1, resources={"CPU": 4},
                      cluster="daemons",
                      _system_config={"submit_batch": False})
    try:
        fp.configure("batch.submit_flush", "delay", 0)
        refs = pair.remote(7)
        assert ray_tpu.get(list(refs)) == [7, 8]
        assert fp.hit_count("batch.submit_flush") == 0
        for handle in rt.cluster_backend.daemons.values():
            assert handle._submit_coalescer() is None
    finally:
        ray_tpu.shutdown()


# ---------------------------------------------------------------------------
# batched submit: fault injection / idempotency
# ---------------------------------------------------------------------------

def test_dropped_batch_flush_retries_exactly_once(daemon_cluster,
                                                  tmp_path):
    """Every second flush attempt is 'lost in transit'; the coalescer
    resends and the daemon dedupes by task id — each task body runs
    exactly once."""
    marker = tmp_path / "runs.txt"

    @ray_tpu.remote(num_returns=2)
    def record(i, path):
        with open(path, "a") as fh:
            fh.write(f"{i}\n")
        return i, -i

    fp.configure("batch.submit_flush", "drop", every=2)
    refs = [record.remote(i, str(marker)) for i in range(30)]
    out = ray_tpu.get([r for ab in refs for r in ab])
    assert out == [v for i in range(30) for v in (i, -i)]
    assert fp.fire_count("batch.submit_flush") > 0, "no drop injected"
    lines = sorted(int(x) for x in marker.read_text().split())
    assert lines == list(range(30))     # exactly once each


def test_errored_batch_flush_retries(daemon_cluster):
    fp.configure("batch.submit_flush", "error", every=3)
    refs = [pair.remote(i) for i in range(12)]
    assert ray_tpu.get([a for a, _ in (r for r in refs)]) == list(range(12))
    assert fp.fire_count("batch.submit_flush") > 0


def test_batched_retry_reexecutes_not_replays(tmp_path):
    """A task RETRY reuses the task id; the daemon's duplicate-frame
    dedupe must key on (task, attempt) — replaying the first attempt's
    recorded 'crashed' outcome would burn every retry without ever
    re-running the body."""
    rt = ray_tpu.init(num_nodes=1, resources={"CPU": 4},
                      cluster="daemons")
    try:
        marker = tmp_path / "attempts.txt"

        @ray_tpu.remote(num_returns=2, max_retries=3)
        def crash_once(path):
            import os
            with open(path, "a") as fh:
                fh.write("x")
            if len(open(path).read()) == 1:
                os._exit(1)     # worker crash on the FIRST attempt only
            return "ok", "ok2"

        a, b = crash_once.remote(str(marker))
        assert ray_tpu.get([a, b], timeout=60) == ["ok", "ok2"]
        # first attempt crashed, retry actually EXECUTED (two runs)
        assert marker.read_text() == "xx"
        assert rt.stats["tasks_retried"] >= 1
    finally:
        ray_tpu.shutdown()


def test_sub_batch_frees_flush_within_bound(daemon_cluster):
    """A trickle of frees far below free_batch_max still leaves within
    the free_flush_ms bound — the flusher must wake on every append,
    not only on a full batch."""
    rt = daemon_cluster
    handle = next(iter(rt.cluster_backend.daemons.values()))
    for round_no in range(2):       # 2nd round hits the idle-parked loop
        key = b"tst:trickle" + bytes([round_no])
        handle.put_object_blob(key, b"w" * 2048)
        before = _store_used(handle)
        handle.queue_free(key)
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            if _store_used(handle) < before:
                break
            time.sleep(0.05)
        assert _store_used(handle) < before, (
            f"round {round_no}: single queued free never flushed")


def test_actor_ordering_preserved_under_batch_faults(daemon_cluster):
    """Actor calls keep strict submission order while the batched plain
    task path is dropping/retrying flushes around them."""
    @ray_tpu.remote
    class Log:
        def __init__(self):
            self.seen = []

        def add(self, i):
            self.seen.append(i)
            return i

        def all(self):
            return list(self.seen)

    fp.configure("batch.submit_flush", "drop", every=2)
    log = Log.remote()
    noise = [pair.remote(i) for i in range(10)]
    calls = [log.add.remote(i) for i in range(25)]
    ray_tpu.get(calls)
    ray_tpu.get([r for ab in noise for r in ab])
    assert ray_tpu.get(log.all.remote()) == list(range(25))


# ---------------------------------------------------------------------------
# coalesced frees
# ---------------------------------------------------------------------------

def _store_used(handle):
    return handle.client.call("daemon_stats", timeout=10.0)["store_used"]


def test_free_buffer_coalesces_and_flushes(daemon_cluster):
    rt = daemon_cluster
    handle = next(iter(rt.cluster_backend.daemons.values()))
    fp.configure("batch.free_flush", "delay", 0)     # observer
    keys = []
    for i in range(8):
        key = b"tst:" + bytes([i]) * 8
        handle.put_object_blob(key, b"x" * 4096)
        keys.append(key)
    before = _store_used(handle)
    assert before >= 8 * 4096
    for key in keys:
        handle.queue_free(key)
    handle.flush_frees()        # synchronous drain (shutdown contract)
    assert _store_used(handle) < before
    log = fp.hit_log("batch.free_flush")
    assert log and sum(e["n"] for e in log) == 8
    # size-bounded coalescing: 8 queued frees left in ≤ a few frames,
    # not one RPC per oid
    assert len(log) < 8


def test_free_flush_fault_retries_idempotently(daemon_cluster):
    rt = daemon_cluster
    handle = next(iter(rt.cluster_backend.daemons.values()))
    key = b"tst:retry"
    handle.put_object_blob(key, b"y" * 4096)
    before = _store_used(handle)
    fp.configure("batch.free_flush", "error", max_fires=1)
    handle.queue_free(key)
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        if _store_used(handle) < before:
            break
        time.sleep(0.05)
    assert _store_used(handle) < before, "free lost to injected fault"
    assert fp.fire_count("batch.free_flush") == 1


def test_zero_ref_frees_are_batched(daemon_cluster):
    """End to end: dropping many result refs coalesces their frees
    instead of firing one single-oid RPC per object."""
    rt = daemon_cluster

    @ray_tpu.remote(num_returns=2)
    def big(i):
        return b"z" * 200_000, i      # > inline: lives in daemon store

    fp.configure("batch.free_flush", "delay", 0)
    refs = [big.remote(i) for i in range(10)]
    ray_tpu.get([b for _a, b in (r for r in refs)])
    del refs
    import gc
    gc.collect()
    for handle in rt.cluster_backend.daemons.values():
        handle.flush_frees()
    log = fp.hit_log("batch.free_flush")
    freed = sum(e["n"] for e in log)
    assert freed >= 10
    assert len(log) < freed     # coalesced: fewer frames than oids


# ---------------------------------------------------------------------------
# pick_node feasibility cache
# ---------------------------------------------------------------------------

def _spec(resources):
    return TaskSpec(task_id=TaskID.from_random(), kind=TaskKind.NORMAL,
                    name="t", func=None, resources=resources)


def test_feasibility_cache_hit_same_shape():
    rt = ray_tpu.init(num_nodes=3, resources={"CPU": 4})
    sched = rt.scheduler
    nodes = rt.nodes()
    sched.pick_node(_spec({"CPU": 1}), nodes)
    key = (("CPU", 1.0),)
    assert key in sched._feas_cache
    assert len(sched._feas_cache[key]) == 3
    # identical specs in a burst reuse the cached candidate set
    epoch_before = sched._feas_epoch
    for _ in range(10):
        sched.pick_node(_spec({"CPU": 1}), nodes)
    assert sched._feas_epoch == epoch_before


def test_feasibility_cache_drain_invalidation():
    """DRAINING nodes leave the cached candidate set immediately
    (regression vs PR 2 drain semantics)."""
    rt = ray_tpu.init(num_nodes=2, resources={"CPU": 4})
    sched = rt.scheduler
    nodes = rt.nodes()
    for _ in range(5):
        sched.pick_node(_spec({"CPU": 1}), nodes)
    victim = nodes[0]
    rt.begin_node_drain(victim, deadline_s=30.0, reason="test")
    for _ in range(20):
        picked = sched.pick_node(_spec({"CPU": 1}), nodes)
        assert picked.node_id != victim.node_id


def test_feasibility_cache_add_remove_invalidation():
    rt = ray_tpu.init(num_nodes=1, resources={"CPU": 2})
    sched = rt.scheduler
    from ray_tpu_torch._private.scheduler import SchedulingError
    with pytest.raises(SchedulingError):
        sched.pick_node(_spec({"CPU": 8}), rt.nodes())
    # negative result is cached for the shape...
    with pytest.raises(SchedulingError):
        sched.pick_node(_spec({"CPU": 8}), rt.nodes())
    # ...until membership changes: an added node invalidates it
    big = rt.add_node({"CPU": 16})
    assert sched.pick_node(
        _spec({"CPU": 8}), rt.nodes()).node_id == big.node_id
    rt.remove_node(big)
    with pytest.raises(SchedulingError):
        sched.pick_node(_spec({"CPU": 8}), rt.nodes())


def test_pg_capacity_change_invalidates_cache():
    """Placement-group bundle capacity rides the same epoch: add_total
    must invalidate cached infeasibility."""
    rt = ray_tpu.init(num_nodes=1, resources={"CPU": 2})
    sched = rt.scheduler
    from ray_tpu_torch._private.scheduler import SchedulingError
    with pytest.raises(SchedulingError):
        sched.pick_node(_spec({"widget": 1}), rt.nodes())
    rt.nodes()[0].ledger.add_total({"widget": 2})
    assert sched.pick_node(_spec({"widget": 1}), rt.nodes()) is not None


# ---------------------------------------------------------------------------
# ledger batch admission + shared wire helpers
# ---------------------------------------------------------------------------

def test_try_acquire_many():
    from ray_tpu_torch._private.node import ResourceLedger
    led = ResourceLedger({"CPU": 4, "TPU": 2})
    assert led.try_acquire_many({"CPU": 1}, 10) == 4
    assert led.try_acquire_many({"CPU": 1}, 10) == 0
    led.release({"CPU": 4})
    assert led.try_acquire_many({"CPU": 2, "TPU": 1}, 5) == 2
    assert led.available() == {"CPU": 0.0, "TPU": 0.0}
    led.release({"CPU": 4, "TPU": 2})
    assert led.try_acquire_many({}, 7) == 7     # zero-demand shape
    assert led.try_acquire_many({"CPU": 0.5}, 3) == 3
    assert led.available()["CPU"] == pytest.approx(2.5)


# ---------------------------------------------------------------------------
# drain-side result pipeline (batched completion delivery)
# ---------------------------------------------------------------------------

class _FakeConn:
    """Stand-in for a daemon Connection on the reply pump: records every
    pushed frame; hashable (dict key in the pump buffer)."""

    def __init__(self):
        self.frames = []
        self.closed = False

    def push(self, method, **kw):
        assert method == "task_batch_done"
        self.frames.append(kw["outcomes"])


def test_result_pump_drop_requeues_and_resends():
    """batch.result_flush drop arm: a lost task_batch_done frame's
    entries requeue in order and leave on the next pump pass — nothing
    is dropped, nothing is duplicated."""
    from ray_tpu_torch._private.daemon import _BatchReplyPump
    fp.configure("batch.result_flush", "drop", every=2)
    pump = _BatchReplyPump()
    conn = _FakeConn()
    for i in range(40):
        pump.add(conn, {"task": f"t{i}", "outcome": "ok"})
        if i % 10 == 9:
            time.sleep(0.02)    # several pump passes → several frames
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        if sum(len(f) for f in conn.frames) >= 40:
            break
        time.sleep(0.02)
    got = [out["task"] for frame in conn.frames for out in frame]
    assert sorted(got) == sorted(f"t{i}" for i in range(40)), (
        "drop arm lost or duplicated completions")
    assert fp.fire_count("batch.result_flush") > 0, "no drop injected"


def test_result_pump_zero_linger_drops_still_deliver():
    """result_linger_us=0 is documented ('flush immediately'); with the
    drop arm armed the retry path must still converge — the failure
    backoff floor keeps the pump off a busy-spin while resending."""
    from ray_tpu_torch._private.config import apply_system_config
    from ray_tpu_torch._private.daemon import _BatchReplyPump
    apply_system_config({"result_linger_us": 0})
    try:
        fp.configure("batch.result_flush", "drop", every=2)
        pump = _BatchReplyPump()
        assert pump.linger_s == 0.0
        conn = _FakeConn()
        for i in range(10):
            pump.add(conn, {"task": f"z{i}", "outcome": "ok"})
            time.sleep(0.005)   # several passes → several drop fires
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            if sum(len(f) for f in conn.frames) >= 10:
                break
            time.sleep(0.02)
        got = [o["task"] for f in conn.frames for o in f]
        assert sorted(got) == sorted(f"z{i}" for i in range(10))
        assert fp.fire_count("batch.result_flush") > 0
    finally:
        apply_system_config(None)


def test_result_pump_error_arm_is_a_loss_not_a_crash():
    """The error arm at the flush seam behaves like a transport loss:
    the pump thread survives and the entries still arrive."""
    from ray_tpu_torch._private.daemon import _BatchReplyPump
    fp.configure("batch.result_flush", "error", max_fires=1)
    pump = _BatchReplyPump()
    conn = _FakeConn()
    pump.add(conn, {"task": "only", "outcome": "ok"})
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        if conn.frames:
            break
        time.sleep(0.02)
    assert [o["task"] for f in conn.frames for o in f] == ["only"]
    assert fp.fire_count("batch.result_flush") == 1


def test_ingest_batch_out_of_order_and_duplicates():
    """Driver-side ingest idempotency: a resent frame arriving after
    (or interleaved with) its successor wakes each waiter exactly once;
    duplicates find no slot and are dropped silently."""
    import queue
    import threading
    from types import SimpleNamespace

    from ray_tpu_torch._private.cluster import DaemonHandle
    h = DaemonHandle.__new__(DaemonHandle)
    h._bw_lock = threading.Lock()
    h._slock = threading.Lock()
    h.dead = False
    h._fence_supported = False
    slots = {name: [threading.Event(), None] for name in ("t1", "t2", "t3")}
    h._batch_waiters = dict(slots)
    stream = SimpleNamespace(q=queue.Queue())
    h._streams = {"s1": stream}

    # frame 2 arrives FIRST (out of order), carrying t2+t3 and a stream
    # termination
    h._ingest_batch([{"task": "t2", "outcome": "ok", "v": 2},
                     {"task": "t3", "outcome": "ok", "v": 3},
                     {"task": "s1", "stream": "task_stream_end"}])
    assert slots["t2"][0].is_set() and slots["t2"][1]["v"] == 2
    assert slots["t3"][0].is_set() and slots["t3"][1]["v"] == 3
    assert not slots["t1"][0].is_set()
    assert stream.q.get_nowait()["m"] == "task_stream_end"

    # the resent frame 1 lands late: t1 completes now; the duplicate t2
    # (and a duplicate stream end) are no-ops
    h._ingest_batch([{"task": "t1", "outcome": "ok", "v": 1},
                     {"task": "t2", "outcome": "ok", "v": 99},
                     {"task": "s1", "stream": "task_stream_end"}])
    assert slots["t1"][0].is_set() and slots["t1"][1]["v"] == 1
    assert slots["t2"][1]["v"] == 2, "duplicate overwrote the outcome"
    assert h._batch_waiters == {}


def test_result_flush_drop_end_to_end_exactly_once(tmp_path):
    """Daemon-side batch.result_flush drop arm (env-armed so the
    spawned daemon inherits it): completions are 'lost in transit'
    every other frame, the pump resends, and every task body still runs
    exactly once with every result delivered."""
    import os
    marker = tmp_path / "runs.txt"
    os.environ["RAY_TPU_FAILPOINTS"] = "batch.result_flush=drop:every=2"
    try:
        ray_tpu.init(num_nodes=1, resources={"CPU": 4},
                     cluster="daemons")

        @ray_tpu.remote(num_returns=2)
        def record(i, path):
            with open(path, "a") as fh:
                fh.write(f"{i}\n")
            return i, -i

        refs = [record.remote(i, str(marker)) for i in range(30)]
        out = ray_tpu.get([r for ab in refs for r in ab], timeout=120)
        assert out == [v for i in range(30) for v in (i, -i)]
        lines = sorted(int(x) for x in marker.read_text().split())
        assert lines == list(range(30))     # exactly once each
    finally:
        os.environ.pop("RAY_TPU_FAILPOINTS", None)
        ray_tpu.shutdown()


def test_mixed_classic_and_batched_submitters_one_daemon(daemon_cluster):
    """Both completion entry points share one daemon's dedupe tables
    and one reply pump: a thread of batched (push_task_batch)
    submissions races classic via_pump submissions on the SAME daemon —
    every result lands, none twice."""
    import threading
    rt = daemon_cluster
    handles = list(rt.cluster_backend.daemons.values())
    # (JAX checks its result_batch hello bit here: the port's daemons
    # always answer a classic submit on the pump and advertise no bit)

    batched_out = {}

    def batched_submitter():
        refs = [pair.remote(i) for i in range(20)]
        batched_out["v"] = ray_tpu.get([r for ab in refs for r in ab])

    t = threading.Thread(target=batched_submitter)
    t.start()
    # classic path on the same daemons: flip batch support off so new
    # submissions take the per-task submit_task RPC, whose completion
    # rides the shared task_batch_done pump (via_pump)
    for h in handles:
        h._batch_supported = False
    try:
        refs = [pair.remote(100 + i) for i in range(20)]
        classic = ray_tpu.get([r for ab in refs for r in ab], timeout=60)
    finally:
        for h in handles:
            h._batch_supported = True
    t.join(timeout=60)
    assert not t.is_alive()
    assert classic == [v for i in range(100, 120) for v in (i, i + 1)]
    assert batched_out["v"] == [v for i in range(20) for v in (i, i + 1)]


def test_classic_submit_rides_result_pump():
    """submit_batch=False still gets coalesced completion delivery:
    the daemon acks via_pump submissions immediately and the outcome
    returns on a task_batch_done frame."""
    rt = ray_tpu.init(num_nodes=1, resources={"CPU": 4},
                      cluster="daemons",
                      _system_config={"submit_batch": False})
    try:
        from ray_tpu_torch._private.rpc import _WIRE_CLIENT_REQS
        handle = next(iter(rt.cluster_backend.daemons.values()))
        assert handle._submit_coalescer() is None   # batching disabled
        before = {m: _WIRE_CLIENT_REQS.get(m, 0)
                  for m in ("submit_task", "push_task_batch")}
        refs = [pair.remote(i) for i in range(15)]
        assert ray_tpu.get([r for ab in refs for r in ab],
                           timeout=60) == [
            v for i in range(15) for v in (i, i + 1)]
        # one classic submit a task, and no batch frame (the port's
        # daemons always answer it on the pump: no result_batch bit)
        assert _WIRE_CLIENT_REQS.get("submit_task", 0) - \
            before["submit_task"] == 15
        assert _WIRE_CLIENT_REQS.get("push_task_batch", 0) == \
            before["push_task_batch"]
    finally:
        ray_tpu.shutdown()


# ---------------------------------------------------------------------------
# coalesced ledger release (release_many)
# ---------------------------------------------------------------------------

def test_release_many_matches_n_single_releases():
    from ray_tpu_torch._private.node import ResourceLedger
    a = ResourceLedger({"CPU": 8.0, "TPU": 4.0})
    b = ResourceLedger({"CPU": 8.0, "TPU": 4.0})
    for led in (a, b):
        assert led.try_acquire_many({"CPU": 1.0}, 6) == 6
        assert led.try_acquire_many({"CPU": 0.5, "TPU": 2.0}, 2) == 2
    a.release_many([({"CPU": 1.0}, 6), ({"CPU": 0.5, "TPU": 2.0}, 2)])
    for _ in range(6):
        b.release({"CPU": 1.0})
    for _ in range(2):
        b.release({"CPU": 0.5, "TPU": 2.0})
    assert a.available() == b.available()
    assert a.available() == {"CPU": 8.0, "TPU": 4.0}


def test_release_many_clamps_at_total_like_release():
    from ray_tpu_torch._private.node import ResourceLedger
    led = ResourceLedger({"CPU": 2.0})
    # over-release (e.g. a shape released twice across a retry seam)
    # clamps at capacity exactly like the single-release path
    led.release_many([({"CPU": 5.0}, 3)])
    assert led.available() == {"CPU": 2.0}
    single = ResourceLedger({"CPU": 2.0})
    single.release({"CPU": 15.0})
    assert led.available() == single.available()


def test_release_many_wakes_dispatch_waiter():
    """release_many must notify the ledger condition — a dispatch loop
    parked in wait_for_change wakes when a batch of completions lands."""
    import threading
    from ray_tpu_torch._private.node import ResourceLedger
    led = ResourceLedger({"CPU": 1.0})
    assert led.try_acquire_many({"CPU": 1.0}, 1) == 1
    woke = threading.Event()

    def waiter():
        led.wait_for_change(5.0)
        woke.set()

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.1)
    led.release_many([({"CPU": 1.0}, 1)])
    assert woke.wait(2.0), "release_many never notified the condition"
    t.join()
