"""The port's fast lane (``ray_tpu_torch/_private/fast_lane.py`` over
``csrc/daemon_core.cc``) in the one-process topology: plain tasks through
the driver-hosted core to dedicated lane workers, asserted through the
core's stats as ``tests/test_fast_lane.py`` asserts on the daemons; nested
tasks, cancels, a killed worker's retry; copies of the lane's regression
tests (``tests/test_review_regressions.py``, ``tests/test_batching.py``);
and a large argument's out-of-band buffers in one lane frame."""

import os
import shutil
import signal
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import exceptions as exc
from ray_tpu_torch._private import fast_lane as fle
from ray_tpu_torch._private import rpc, worker_process
from ray_tpu_torch._private.worker import global_runtime

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no g++ on this host")


@pytest.fixture
def lane_runtime():
    rt = ray_tpu_torch.init(num_nodes=1, resources={"CPU": 8})
    yield rt
    ray_tpu_torch.shutdown()


def _submitted(rt) -> int:
    return rt.process_router.fast_stats().get("submitted", 0)


def _alive(pid: int) -> bool:
    """Whether ``pid`` is a live process (a zombie is not)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


def _wait_for(path: str, timeout: float = 30.0) -> str:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            with open(path) as f:
                text = f.read().strip()
            if text:
                return text
        except FileNotFoundError:
            pass
        time.sleep(0.02)
    raise TimeoutError(path)


# ---------------------------------------------------------------------------
# tests/test_fast_lane.py, on the driver-local lane
# ---------------------------------------------------------------------------

def test_plain_tasks_ride_the_lane(lane_runtime):
    rt = lane_runtime

    @ray_tpu_torch.remote
    def add(a, b):
        return a + b, os.getpid()

    assert ray_tpu_torch.get(add.remote(0, 0))[0] == 0     # starts the core
    before = _submitted(rt)
    calls = worker_process.calls_sent()
    out = ray_tpu_torch.get([add.remote(i, 1) for i in range(20)])
    assert [v for v, _ in out] == [i + 1 for i in range(20)]
    assert _submitted(rt) - before == 20
    assert worker_process.calls_sent() - calls == 20
    lane_pids = {w.pid for w in rt.process_router._fast_workers}
    assert {pid for _, pid in out} <= lane_pids
    assert os.getpid() not in lane_pids
    assert all(w.fast_lane for w in rt.process_router._fast_workers)
    assert not set(worker_process._IDLE) & set(
        rt.process_router._fast_workers)
    fl = rt.process_router._fast_client()
    assert fl.ping()["completed"] >= 21


def test_errors_and_ref_args(lane_runtime):
    @ray_tpu_torch.remote
    def boom():
        raise ValueError("expected")

    @ray_tpu_torch.remote
    def add(a, b):
        return a + b

    with pytest.raises(exc.TaskError) as ei:
        ray_tpu_torch.get(boom.remote())
    assert isinstance(ei.value.cause, ValueError)
    r = add.remote(1, 1)
    assert ray_tpu_torch.get(add.remote(r, 10)) == 12


def test_nested_tasks_from_lane_worker(lane_runtime):
    """A lane task submitting child tasks exercises the worker's host
    channel (core ops) while dedicated to the lane; the driver's holds for
    the child refs are released when the parent ends."""
    rt = lane_runtime

    @ray_tpu_torch.remote
    def child(x):
        return x * 2

    @ray_tpu_torch.remote
    def parent(n):
        refs = [child.remote(i) for i in range(n)]
        return sum(ray_tpu_torch.get(refs)), \
            ray_tpu_torch.get(ray_tpu_torch.put(n))

    before = _submitted(rt)
    assert ray_tpu_torch.get(parent.remote(5)) == (20, 5)
    assert _submitted(rt) - before == 6
    deadline = time.monotonic() + 5
    while any(w._holds for w in rt.process_router._fast_workers) and \
            time.monotonic() < deadline:
        time.sleep(0.02)
    assert not any(w._holds for w in rt.process_router._fast_workers)


def test_generator_returning_plain_function_runs_once(lane_runtime,
                                                       tmp_path):
    """tests/test_review_regressions.py:196: a plain function with a side
    effect that RETURNS a generator runs its body once; the worker drains
    the generator and the driver replays it as a stream."""
    rt = lane_runtime
    marker = str(tmp_path / "ran.log")

    @ray_tpu_torch.remote
    def gen_side_effect():
        with open(marker, "a") as fh:
            fh.write("x")
        return (i * 10 for i in range(4))

    from ray_tpu_torch._private.worker import _StreamingGeneratorSentinel
    from ray_tpu_torch.remote_function import ObjectRefGenerator

    before = _submitted(rt)
    sentinel = ray_tpu_torch.get(gen_side_effect.remote())
    assert isinstance(sentinel, _StreamingGeneratorSentinel)
    out = [ray_tpu_torch.get(r) for r in ObjectRefGenerator(sentinel.task_id)]
    assert out == [0, 10, 20, 30]
    assert _submitted(rt) - before == 1
    with open(marker) as fh:
        assert fh.read() == "x", "generator-returning body ran twice"


def test_generator_functions_and_multi_returns_keep_the_pipe(lane_runtime):
    rt = lane_runtime

    @ray_tpu_torch.remote
    def gen(n):
        for i in range(n):
            yield i

    @ray_tpu_torch.remote(num_returns=2)
    def two():
        return 1, 2

    @ray_tpu_torch.remote
    def one():
        return 0

    ray_tpu_torch.get(one.remote())
    before = _submitted(rt)
    assert [ray_tpu_torch.get(r) for r in gen.remote(3)] == [0, 1, 2]
    assert ray_tpu_torch.get(list(two.remote())) == [1, 2]
    assert _submitted(rt) == before


def test_cancel_soft_and_forced(lane_runtime, tmp_path):
    rt = lane_runtime

    @ray_tpu_torch.remote(max_retries=0)
    def spin(path):
        with open(path, "w") as f:
            f.write(str(os.getpid()))
        while True:             # an interruptible (looped) sleep
            time.sleep(0.01)

    before = _submitted(rt)
    soft = spin.remote(str(tmp_path / "soft"))
    pid = int(_wait_for(str(tmp_path / "soft")))
    ray_tpu_torch.cancel(soft)
    with pytest.raises(exc.TaskCancelledError):
        ray_tpu_torch.get(soft, timeout=30)
    # a soft cancel interrupts the task, not the worker
    assert any(w.pid == pid and w.alive()
               for w in rt.process_router._fast_workers)

    forced = spin.remote(str(tmp_path / "forced"))
    fpid = int(_wait_for(str(tmp_path / "forced")))
    ray_tpu_torch.cancel(forced, force=True)
    with pytest.raises(exc.TaskCancelledError):
        ray_tpu_torch.get(forced, timeout=30)
    deadline = time.monotonic() + 10
    while _alive(fpid) and time.monotonic() < deadline:
        time.sleep(0.02)
    assert not _alive(fpid)
    assert _submitted(rt) - before == 2

    @ray_tpu_torch.remote
    def after():
        return "ok"

    assert ray_tpu_torch.get(after.remote(), timeout=30) == "ok"


def test_killed_lane_worker_retries(lane_runtime, tmp_path):
    rt = lane_runtime
    marker = str(tmp_path / "attempt")

    @ray_tpu_torch.remote(max_retries=2)
    def slow():
        n = len([f for f in os.listdir(tmp_path) if f.startswith("attempt")])
        with open(f"{marker}.{n}", "w") as f:
            f.write(str(os.getpid()))
        if n == 0:
            time.sleep(60)      # the first attempt is killed
        return os.getpid(), n

    before = _submitted(rt)
    ref = slow.remote()
    first = int(_wait_for(f"{marker}.0"))
    os.kill(first, signal.SIGKILL)
    pid, attempt = ray_tpu_torch.get(ref, timeout=60)
    assert attempt == 1 and pid not in (first, os.getpid())
    assert _submitted(rt) - before == 2     # the retry rode the lane too


def test_lane_death_is_a_retryable_crash(lane_runtime, tmp_path):
    """A crash the lane reports carries ``fast_lane``; with no retries
    left it fails as WorkerCrashedError."""
    @ray_tpu_torch.remote(max_retries=0)
    def die():
        os._exit(3)

    with pytest.raises(exc.TaskError) as ei:
        ray_tpu_torch.get(die.remote(), timeout=60)
    assert isinstance(ei.value.cause, exc.WorkerCrashedError)


def test_large_argument_out_of_band_in_one_frame(lane_runtime):
    """An argument of several MiB: numpy arrays and a CPU tensor go as
    protocol 5's out-of-band buffers inside the frame's one blob, arrive
    bit-equal and writable, and the result comes back the same way."""
    rt = lane_runtime
    rng = np.random.default_rng(0)
    a = rng.standard_normal(1 << 20).astype(np.float32)        # 4 MiB
    b = rng.integers(0, 255, 3 << 20, dtype=np.uint8)          # 3 MiB
    t = torch.from_numpy(rng.standard_normal((512, 1024))
                         .astype(np.float32))                  # 2 MiB

    @ray_tpu_torch.remote
    def echo(arrs, tensor):
        x, y = arrs
        x[0] = 1.0               # buffers arrive writable
        return x, y, tensor * 2, float(x[1:].sum()), int(y.sum())

    parts = worker_process._pack((([a, b], t), {}))
    assert len(parts) == 4                  # in-band + 3 buffers
    blob = fle.join_parts(parts)
    assert len(blob) > 9 << 20
    args, kwargs = fle.loads_joined(blob)
    assert np.array_equal(args[0][0], a) and torch.equal(args[1], t)

    before = _submitted(rt)
    x, y, t2, xs, ys = ray_tpu_torch.get(echo.remote([a, b], t))
    assert _submitted(rt) - before == 1
    assert x[0] == 1.0 and np.array_equal(x[1:], a[1:])
    assert np.array_equal(y, b) and torch.equal(t2, t * 2)
    assert xs == float(a[1:].sum()) and ys == int(b.sum())


def test_lane_off_takes_the_pipe():
    ray_tpu_torch.init(num_nodes=1, resources={"CPU": 4},
                       _system_config={"fast_lane": False})
    try:
        rt = global_runtime()

        @ray_tpu_torch.remote
        def pid():
            return os.getpid()

        assert ray_tpu_torch.get(pid.remote()) != os.getpid()
        assert rt.process_router._fast_core is None
        assert rt.process_router.fast_stats() == {}
    finally:
        ray_tpu_torch.shutdown()


def test_shutdown_stops_the_core_and_its_workers():
    rt = ray_tpu_torch.init(num_nodes=1, resources={"CPU": 4})
    try:
        @ray_tpu_torch.remote
        def pid():
            return os.getpid()

        ray_tpu_torch.get([pid.remote() for _ in range(8)])
        port = rt.process_router._fast_core.port
        lane = list(rt.process_router._fast_workers)
        assert lane
    finally:
        ray_tpu_torch.shutdown()
    for w in lane:
        w.proc.join(timeout=5)
        assert not w.alive()
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", port), timeout=1).close()
    # the core is process-global: a new runtime starts a new one
    rt = ray_tpu_torch.init(num_nodes=1, resources={"CPU": 4})
    try:
        assert ray_tpu_torch.get(pid.remote()) != os.getpid()
        assert rt.process_router.fast_stats()["submitted"] == 1
    finally:
        ray_tpu_torch.shutdown()


# ---------------------------------------------------------------------------
# tests/test_review_regressions.py: the lane's fault paths
# ---------------------------------------------------------------------------

class _FakeLane:
    def __init__(self, dead=False):
        self.dead = dead
        self.cancelled = []

    def cancel(self, rid, force=False):
        self.cancelled.append((rid, force))


def test_cancel_uses_submitting_lane_generation_process_router(
        monkeypatch):
    """:296 — ProcessRouter.cancel_task sends the cancel to the lane client
    the task was submitted on; a reconnected client restarts its rids."""
    monkeypatch.setenv("RAY_TPU_PROCESS_WORKERS", "0")
    from ray_tpu_torch._private import config
    from ray_tpu_torch._private.ids import TaskID
    from ray_tpu_torch._private.worker_process import ProcessRouter

    config.reset()
    try:
        router = ProcessRouter(runtime=None)
    finally:
        config.reset()
    old_lane, new_lane = _FakeLane(), _FakeLane()
    task_id = TaskID.from_random()
    router._fast_rids = {task_id.hex(): (old_lane, 3)}
    router._fast = new_lane
    assert router.cancel_task(task_id, force=True) is True
    assert old_lane.cancelled == [(3, True)]
    assert new_lane.cancelled == []
    # a dead submitting lane: no cancel bytes anywhere, no crash
    old_lane.dead = True
    old_lane.cancelled.clear()
    assert router.cancel_task(task_id, force=False) is True
    assert old_lane.cancelled == [] and new_lane.cancelled == []


def _lane_client_with_sendall(srv, sendall_fn):
    """FastLaneClient against a dummy server, with sendall intercepted
    (socket objects reject attribute assignment, so proxy the sock)."""
    client = fle.FastLaneClient(srv.getsockname())

    class _SockProxy:
        def __init__(self, sock):
            self._s = sock

        def __getattr__(self, name):
            return getattr(self._s, name)

        def sendall(self, data):
            return sendall_fn(self._s, data)

    client._sock = _SockProxy(client._sock)
    return client


def test_fast_lane_ping_slot_leak():
    """:314, through the sendall proxy in place of a failpoint: a ping
    whose send fails pops its pending slot, marks the lane dead and raises
    the typed FastLaneError (not a raw OSError)."""
    srv = socket.create_server(("127.0.0.1", 0))

    def sendall_fail(sock, data):
        raise OSError("connection lost")

    client = _lane_client_with_sendall(srv, sendall_fail)
    try:
        with pytest.raises(fle.FastLaneError):
            client.ping(timeout=0.5)
        assert client.dead and not client._pending
        with pytest.raises(fle.FastLaneError):
            client.submit(b"payload")     # a dead lane refuses at once
    finally:
        client.close()
        srv.close()


def test_send_stage_later_pass_failure_is_post_submit():
    """:336 — a flusher whose own frame already hit the wire must not see a
    later pass's send failure as a submit error: submit() returns and the
    slot surfaces lane death via wait()."""
    srv = socket.create_server(("127.0.0.1", 0))
    calls = []
    holder = {}

    def sendall(sock, data):
        calls.append(bytes(data))
        if len(calls) == 1:
            with holder["c"]._stage_lock:
                holder["c"]._send_stage.append(
                    (b"other-thread-frame", None))
            return sock.sendall(data)
        raise OSError("connection lost mid-burst")

    client = holder["c"] = _lane_client_with_sendall(srv, sendall)
    try:
        rid, slot = client.submit(b"payload")   # must NOT raise
        assert len(calls) == 2 and client.dead
        with pytest.raises(fle.FastLaneError):
            client.wait(slot, timeout=0.5)
    finally:
        client.close()
        srv.close()


def test_send_stage_sole_frame_failure_still_raises_to_submitter():
    """:370 — a sole-frame failed write raises to the submitter (the
    classic fallback stays safe); an own frame sharing a failed
    multi-frame write must not raise."""
    srv = socket.create_server(("127.0.0.1", 0))

    def sendall_fail(sock, data):
        raise OSError("connection lost")

    client = _lane_client_with_sendall(srv, sendall_fail)
    try:
        with pytest.raises(fle.FastLaneError):
            client.submit(b"payload")
        assert client.dead and not client._pending
    finally:
        client.close()
        srv.close()

    srv = socket.create_server(("127.0.0.1", 0))
    client = _lane_client_with_sendall(srv, sendall_fail)
    try:
        with client._stage_lock:        # rides the first write too
            client._send_stage.append((b"earlier-staged-frame", None))
        rid, slot = client.submit(b"payload")   # must NOT raise
        assert client.dead
        with pytest.raises(fle.FastLaneError):
            client.wait(slot, timeout=0.5)
    finally:
        client.close()
        srv.close()


def test_send_stage_unwritten_frame_resolves_unsubmitted():
    """:400 — a frame still staged when another thread's flush fails never
    reached the wire: its slot resolves FastLaneUnsubmitted (the classic
    path, retry-free), not lane death."""
    srv = socket.create_server(("127.0.0.1", 0))
    holder = {}

    def sendall(sock, data):
        c = holder["c"]
        rid2 = next(c._rids)
        slot2 = [threading.Event(), None, None]
        with c._plock:
            c._pending[rid2] = slot2
        with c._stage_lock:
            c._send_stage.append((b"unwritten-frame", rid2))
        holder["slot2"] = slot2
        raise OSError("connection lost")

    client = holder["c"] = _lane_client_with_sendall(srv, sendall)
    try:
        with pytest.raises(fle.FastLaneError):
            client.submit(b"payload")   # sole own frame: submit raises
        with pytest.raises(fle.FastLaneUnsubmitted):
            client.wait(holder["slot2"], timeout=0.5)
        assert client.dead and not client._pending
    finally:
        client.close()
        srv.close()


def test_large_frames_keep_fifo_order_through_the_stage():
    """A large two-part entry is written in its FIFO position, its
    payload never concatenated."""
    srv = socket.create_server(("127.0.0.1", 0))
    writes = []

    def sendall(sock, data):
        writes.append(len(data))
        return sock.sendall(data)

    client = _lane_client_with_sendall(srv, sendall)
    peer, _ = srv.accept()
    try:
        big = b"z" * (rpc.SEND_CONCAT_MAX + 1)
        with client._stage_lock:
            client._send_stage.append((b"\x01\x00\x00\x00\x01", None))
        client.submit(big)
        assert len(big) in writes           # the payload's own sendall
        got = bytearray()
        want = 5 + 4 + 1 + 8 + len(big)
        while len(got) < want:
            got += peer.recv(1 << 20)
        assert bytes(got[:5]) == b"\x01\x00\x00\x00\x01"
        assert got[9] == fle.OP_SUBMIT and bytes(got[18:]) == big
    finally:
        client.close()
        peer.close()
        srv.close()


def test_recv_exact_shared_implementation():
    """tests/test_batching.py:628: one recv helper (rpc.recv_exact) and the
    two-phase large-frame send; the lane defines no recv helper of its own
    and shares rpc's concat bound."""
    assert not hasattr(fle, "recv_exact") and not hasattr(fle, "_recv_exact")
    assert fle._SEND_CONCAT_MAX is rpc.SEND_CONCAT_MAX
    a, b = socket.socketpair()
    lock = threading.Lock()
    big = b"q" * (rpc.SEND_CONCAT_MAX + 1000)
    sender = threading.Thread(
        target=lambda: (rpc.send_frame_bytes(a, b"small", lock),
                        rpc.send_frame_bytes(a, big, lock)))
    sender.start()
    (n1,) = struct.unpack("!I", rpc.recv_exact(b, 4))
    assert bytes(rpc.recv_exact(b, n1)) == b"small"
    (n2,) = struct.unpack("!I", rpc.recv_exact(b, 4))
    assert bytes(rpc.recv_exact(b, n2)) == big
    sender.join()
    a.close()
    with pytest.raises(OSError):    # EOF surfaces as ConnectionError
        rpc.recv_exact(b, 1)
    b.close()


def test_gen_drain_is_capped(monkeypatch):
    monkeypatch.setattr(fle, "GEN_DRAIN_MAX_ITEMS", 5)
    assert fle._drain_capped(iter(range(5))) == [0, 1, 2, 3, 4]
    with pytest.raises(RuntimeError, match="num_returns='streaming'"):
        fle._drain_capped(i for i in range(100))
    assert list(fle.replay_gen_list(fle.join_parts(
        worker_process._pack([1, "a", None])))) == [1, "a", None]


def test_port_reads_nothing_of_jax_native_dir():
    """The port builds its own copies of the C++ sources and never reads
    ``native/`` or loads the libraries JAX builds there."""
    from ray_tpu_torch import _build
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for name in ("shm_store", "daemon_core", "cpp_client"):
        assert (_build.CSRC / f"{name}.cc").exists()
        assert _build.host_library_path(name).parent == _build.BUILD_DIR
    for dirpath, _, files in os.walk(os.path.join(root, "ray_tpu_torch")):
        for f in files:
            if f.endswith((".py", ".cc", ".cu")):
                text = open(os.path.join(dirpath, f)).read()
                assert "native/lib" not in text and "NATIVE_DIR" not in text
