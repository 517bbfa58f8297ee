"""The targeted actor lane of the port's daemon cluster (copies of the
targeted-lane tests of ``tests/test_fast_lane.py`` against
``ray_tpu_torch``, and one actor script run on both packages).

A serialized daemon actor (``max_concurrency == 1``, no concurrency
groups) gets a tag in its daemon's native core; its plain method calls go
from the driver straight to the actor's worker through the core, strictly
FIFO, and the core's ``submitted`` count proves it. A concurrent actor
stays on the classic path; a SIGKILLed lane actor restarts with a fresh
tag. The tests share one module-scoped cluster: none kills a daemon.
"""

import os
import signal
import time

import pytest

import ray_tpu_torch as rt_api


@pytest.fixture(scope="module")
def daemon_cluster():
    if rt_api.is_initialized():
        pytest.fail("a runtime is already up")
    rt = rt_api.init(num_nodes=2, resources={"CPU": 4}, cluster="daemons",
                     object_store_memory=128 << 20)
    yield rt
    rt_api.shutdown()


def _instance(rt, actor_id, timeout=15.0):
    """Actor creation is async: wait for the driver-side executor."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        ex = rt._actor_executors.get(actor_id)
        if ex is not None and ex.instance is not None:
            return ex.instance
        time.sleep(0.05)
    raise AssertionError("actor executor never appeared")


def _submitted(rt) -> int:
    return sum(h.client.call("daemon_stats")["fast_lane"]["submitted"]
               for h in rt.cluster_backend.daemons.values())


def test_targeted_actor_lane(daemon_cluster):
    """Serialized actors are lane-bound; their calls keep strict FIFO
    order and raise the core's submit count. A generator-returning method
    drains in the worker and replays as a stream: its body runs once."""
    rt = daemon_cluster
    before = _submitted(rt)

    @rt_api.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def inc(self, k=1):
            self.n += k
            return self.n

    c = Counter.remote()
    vals = rt_api.get([c.inc.remote() for _ in range(20)])
    inst = _instance(rt, c._actor_id)
    assert getattr(inst, "fast_tag", None), "actor not lane-bound"
    assert vals == list(range(1, 21))        # strict ordering
    assert _submitted(rt) - before >= 20

    @rt_api.remote
    class Gen:
        def __init__(self):
            self.calls = 0

        def stream3(self):
            self.calls += 1
            yield from ("a", "b", "c")

        def count(self):
            return self.calls

    g = Gen.remote()
    out = rt_api.get(g.stream3.remote())
    # parity with the classic path: a generator-returning method under
    # num_returns=1 resolves to the streaming sentinel
    assert type(out).__name__ == "_StreamingGeneratorSentinel"
    assert rt_api.get(g.count.remote()) == 1
    # a streaming call keeps the classic path and still sees the state
    items = [rt_api.get(r) for r in
             g.stream3.options(num_returns="streaming").remote()]
    assert items == ["a", "b", "c"]
    assert rt_api.get(g.count.remote()) == 2


def test_concurrent_actors_keep_classic_path(daemon_cluster):
    """max_concurrency > 1 actors are not lane-bound (serialization would
    break their concurrency) and still work."""
    rt = daemon_cluster

    @rt_api.remote(max_concurrency=4)
    class Par:
        def ping(self):
            return "pong"

    p = Par.remote()
    before = _submitted(rt)
    assert rt_api.get(p.ping.remote()) == "pong"
    inst = _instance(rt, p._actor_id)
    assert getattr(inst, "fast_tag", "unset") is None
    assert _submitted(rt) == before


def test_lane_actor_worker_sigkill_restarts(daemon_cluster):
    """Killing a lane-bound actor's worker restarts the actor; the new
    incarnation gets a fresh tag and keeps serving."""
    rt = daemon_cluster

    @rt_api.remote(max_restarts=1)
    class P:
        def pid(self):
            import os
            return os.getpid()

    a = P.remote()
    pid1 = rt_api.get(a.pid.remote())
    tag1 = _instance(rt, a._actor_id).fast_tag
    assert tag1
    os.kill(pid1, signal.SIGKILL)
    deadline = time.monotonic() + 30
    pid2 = None
    while time.monotonic() < deadline:
        try:
            pid2 = rt_api.get(a.pid.remote(), timeout=10)
            break
        except Exception:
            time.sleep(0.3)
    assert pid2 is not None and pid2 != pid1
    tag2 = _instance(rt, a._actor_id).fast_tag
    assert tag2 and tag2 != tag1


def _actor_script(pkg, rt) -> dict:
    """One actor surface on a daemon cluster: ordered calls, keyword
    arguments, an error, a generator-returning method and a concurrent
    actor beside a lane-bound one."""
    @pkg.remote
    class Acc:
        def __init__(self, start):
            self.total = start
            self.log = []

        def add(self, x, scale=1):
            self.total += x * scale
            self.log.append(x)
            return self.total

        def history(self):
            return list(self.log)

        def fail(self):
            raise ValueError("bad call")

        def pairs(self, n):
            for i in range(n):
                yield (i, i * i)

    @pkg.remote(max_concurrency=2)
    class Echo:
        def echo(self, x):
            return x

    a = Acc.remote(100)
    out = {"adds": pkg.get([a.add.remote(i, scale=2) for i in range(12)])}
    out["history"] = pkg.get(a.history.remote())
    try:
        pkg.get(a.fail.remote())
        out["error"] = None
    except Exception as e:  # noqa: BLE001 - the class names are compared
        out["error"] = type(e).__name__
    out["after_error"] = pkg.get(a.add.remote(1))
    out["streamed"] = [pkg.get(r) for r in
                       a.pairs.options(num_returns="streaming").remote(3)]
    e = Echo.remote()
    out["echo"] = pkg.get([e.echo.remote(i) for i in range(4)])
    out["tags"] = (bool(_instance(rt, a._actor_id).fast_tag),
                   _instance(rt, e._actor_id).fast_tag is None)
    return out


def test_actor_script_parity_with_jax(daemon_cluster):
    """The same actor script on JAX's daemon cluster and the port's gives
    the same results in order, with the serialized actor lane-bound on
    both and the concurrent one on neither."""
    import ray_tpu

    port = _actor_script(rt_api, daemon_cluster)
    jrt = ray_tpu.init(num_nodes=1, resources={"CPU": 4},
                       cluster="daemons")
    try:
        jax = _actor_script(ray_tpu, jrt)
    finally:
        ray_tpu.shutdown()
    assert port == jax
    assert port["tags"] == (True, True)
    assert port["adds"] == [100 + sum(2 * j for j in range(i + 1))
                            for i in range(12)]
