"""Compiled-DAG cross-process shm channels on the port (a copy of
``tests/test_dag_shm_channels.py`` against ``ray_tpu_torch``): after
compile, values flow worker to worker through pre-allocated shared memory
with no per-execute RPC or object-store traffic. JAX's ``cluster="local"``
is the port's default topology (``cluster=None``).
"""

import threading

import pytest

import ray_tpu_torch
from ray_tpu_torch.dag import InputNode
from ray_tpu_torch.dag.shm_channel import ChannelFull, ShmChannel


# ---------------------------------------------------------------------------
# channel protocol
# ---------------------------------------------------------------------------

def test_channel_roundtrip_and_backpressure():
    ch = ShmChannel(create=True, capacity=4096)
    try:
        reader = ShmChannel(name=ch.name)
        ch.write("ok", {"x": 1})
        assert reader.read() == ("ok", {"x": 1})
        # depth-1 backpressure: a second write blocks until consumed
        ch.write("ok", 2)
        done = threading.Event()

        def writer():
            ch.write("ok", 3, timeout=30)
            done.set()

        t = threading.Thread(target=writer, daemon=True)
        t.start()
        assert not done.wait(0.3)          # blocked on unconsumed slot
        assert reader.read() == ("ok", 2)
        assert done.wait(10)
        assert reader.read() == ("ok", 3)
        reader.close()
    finally:
        ch.close()
        ch.unlink()


def test_channel_capacity_guard():
    ch = ShmChannel(create=True, capacity=128)
    try:
        with pytest.raises(ChannelFull, match="buffer_size_bytes"):
            ch.write("ok", b"x" * 1024)
    finally:
        ch.close()
        ch.unlink()


# ---------------------------------------------------------------------------
# compiled DAG over process workers
# ---------------------------------------------------------------------------

@ray_tpu_torch.remote
class Stage:
    def __init__(self, add):
        self.add = add
        self.calls = 0

    def f(self, x):
        self.calls += 1
        return x + self.add

    def mix(self, x, y):
        self.calls += 1
        return x * 100 + y

    def boom(self, x):
        raise RuntimeError("stage exploded")

    def calls_seen(self):
        return self.calls


@pytest.fixture
def local_pool_runtime():
    """The shm-channel fast path binds DRIVER-POOL actor workers (the
    channels are wired through the driver's WorkerClient dag ops). In
    the daemons topology actors live in daemon-hosted workers and
    compile falls back to the dynamic path — correct behavior, covered
    by test_daemons_mode_falls_back_to_dynamic below — so the channel
    tests pin the local topology explicitly."""
    rt = ray_tpu_torch.init(num_nodes=1, resources={"CPU": 8})
    yield rt
    ray_tpu_torch.shutdown()


def test_cross_process_pipeline(local_pool_runtime):
    """Two process-worker actors pipeline through shm channels; per
    execute() NO RPC reaches either worker (call counters frozen)."""
    a, b = Stage.remote(1), Stage.remote(10)
    ray_tpu_torch.get([a.calls_seen.remote(), b.calls_seen.remote()])
    with InputNode() as inp:
        dag = b.f.bind(a.f.bind(inp))
    c = dag.experimental_compile()
    assert c._proc is not None, "process-channel mode did not engage"

    from ray_tpu_torch._private import worker
    rt = worker.global_runtime()
    clients = [rt._actor_executors[x._actor_id].instance._client
               for x in (a, b)]
    calls_before = [cl.calls for cl in clients]
    for i in range(5):
        assert ray_tpu_torch.get(c.execute(i), timeout=60) == i + 11
    assert [cl.calls for cl in clients] == calls_before   # zero RPCs
    # actor state advanced exactly once per execute (no free-running)
    assert ray_tpu_torch.get(a.calls_seen.remote()) == 5
    assert ray_tpu_torch.get(b.calls_seen.remote()) == 5
    c.teardown()
    # workers survive teardown and still serve normal calls
    assert ray_tpu_torch.get(a.f.remote(100)) == 101


def test_fan_out_and_constants(local_pool_runtime):
    """One upstream feeding two consumers plus a mixed-arg stage."""
    from ray_tpu_torch.dag import MultiOutputNode
    a, b, c2 = Stage.remote(1), Stage.remote(2), Stage.remote(0)
    with InputNode() as inp:
        up = a.f.bind(inp)
        dag = MultiOutputNode([b.f.bind(up), c2.mix.bind(up, inp)])
    c = dag.experimental_compile()
    assert c._proc is not None
    out = ray_tpu_torch.get(c.execute(5), timeout=60)
    assert out == [8, 605]            # (5+1)+2 and (5+1)*100+5
    out = ray_tpu_torch.get(c.execute(7), timeout=60)
    assert out == [10, 807]
    c.teardown()


def test_pipelined_rounds_in_order(local_pool_runtime):
    """Back-to-back execute() calls resolve in round order through the
    single ordered finisher (no racing readers on the channels)."""
    a, b = Stage.remote(1), Stage.remote(10)
    with InputNode() as inp:
        dag = b.f.bind(a.f.bind(inp))
    c = dag.experimental_compile()
    assert c._proc is not None
    refs = [c.execute(i) for i in range(4)]
    assert [ray_tpu_torch.get(r, timeout=60) for r in refs] == [11, 12, 13, 14]
    c.teardown()


def test_superseding_compile_and_gc(local_pool_runtime):
    """Recompiling over the same actors supersedes the old loop; GC of
    the STALE CompiledDAG must not kill the new binding."""
    import gc

    a = Stage.remote(5)
    with InputNode() as inp:
        dag = a.f.bind(inp)
    c1 = dag.experimental_compile()
    assert c1._proc is not None
    assert ray_tpu_torch.get(c1.execute(1), timeout=60) == 6
    c2 = dag.experimental_compile()     # supersedes c1's worker loop
    del c1
    gc.collect()                         # stale teardown: generation-scoped no-op
    assert ray_tpu_torch.get(c2.execute(2), timeout=60) == 7
    assert ray_tpu_torch.get(c2.execute(3), timeout=60) == 8
    c2.teardown()


def test_dead_stage_worker_fails_round_promptly(local_pool_runtime):
    """SIGKILL a stage's worker process mid-DAG: the pending round must
    fail with ActorDiedError within seconds, not a 300s channel
    timeout."""
    import os
    import signal
    import time

    from ray_tpu_torch._private import worker as _w

    a, b = Stage.remote(1), Stage.remote(10)
    with InputNode() as inp:
        dag = b.f.bind(a.f.bind(inp))
    c = dag.experimental_compile()
    assert c._proc is not None
    assert ray_tpu_torch.get(c.execute(1), timeout=60) == 12

    rt = _w.global_runtime()
    client = rt._actor_executors[a._actor_id].instance._client
    os.kill(client.proc.pid, signal.SIGKILL)
    t0 = time.time()
    ref = c.execute(2)
    with pytest.raises(Exception, match="died"):
        ray_tpu_torch.get(ref, timeout=120)
    assert time.time() - t0 < 60          # prompt, not channel-timeout
    c.teardown()


def test_stage_error_propagates(local_pool_runtime):
    a, b = Stage.remote(1), Stage.remote(2)
    with InputNode() as inp:
        dag = b.f.bind(a.boom.bind(inp))
    c = dag.experimental_compile()
    assert c._proc is not None
    with pytest.raises(Exception, match="stage exploded"):
        ray_tpu_torch.get(c.execute(1), timeout=60)
    c.teardown()


def test_daemons_mode_falls_back_to_dynamic():
    """Under the wire topology the compiled DAG cannot pre-wire driver
    shm channels to daemon-hosted workers; compile must DEGRADE to the
    dynamic execution path and still produce correct results."""
    rt = ray_tpu_torch.init(num_nodes=1, resources={"CPU": 4},
                            cluster="daemons")
    try:
        a, b = Stage.remote(1), Stage.remote(10)
        with InputNode() as inp:
            dag = b.f.bind(a.f.bind(inp))
        c = dag.experimental_compile()
        assert ray_tpu_torch.get(c.execute(5)) == (5 + 1) + 10
        assert ray_tpu_torch.get(c.execute(7)) == 18
    finally:
        ray_tpu_torch.shutdown()
