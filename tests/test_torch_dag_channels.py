"""Compiled-graph channels on the port (a copy of
``tests/test_dag_channels.py`` against ``ray_tpu_torch``): pre-allocated
in-process channels between in-process actors; per-call execution skips
the scheduler."""

import time

import pytest

import ray_tpu_torch
from ray_tpu_torch.dag import InputNode, MultiOutputNode


@pytest.fixture
def ray_start_regular():
    """A one-node runtime of 8 CPUs per test."""
    rt = ray_tpu_torch.init(num_nodes=1, resources={"CPU": 8})
    yield rt
    ray_tpu_torch.shutdown()


@pytest.fixture(autouse=True)
def _cleanup_runtime():
    yield
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()


@ray_tpu_torch.remote(_in_process=True)
class Stage:
    def __init__(self, add, delay=0.0):
        self.add = add
        self.delay = delay
        self.calls = 0

    def work(self, x):
        self.calls += 1
        if self.delay:
            time.sleep(self.delay)
        return x + self.add

    def count(self):
        return self.calls


def test_channel_mode_engages_and_is_correct(ray_start_regular):
    a, b = Stage.remote(1), Stage.remote(10)
    with InputNode() as inp:
        dag = b.work.bind(a.work.bind(inp))
    compiled = dag.experimental_compile()
    assert compiled._executors is not None  # channel mode, not fallback
    assert ray_tpu_torch.get(compiled.execute(5)) == 16
    assert ray_tpu_torch.get(compiled.execute(100)) == 111
    # ops went through the real actor instances, in order
    assert ray_tpu_torch.get(a.count.remote()) == 2
    compiled.teardown()
    with pytest.raises(RuntimeError):
        compiled.execute(1)


def test_channel_mode_pipelines_across_stages(ray_start_regular):
    """Two executions in flight overlap stage-wise: total wall clock is
    well under 2x the sequential path (the point of compiled channels)."""
    a, b = Stage.remote(0, delay=0.3), Stage.remote(0, delay=0.3)
    with InputNode() as inp:
        dag = b.work.bind(a.work.bind(inp))
    compiled = dag.experimental_compile()
    assert compiled._executors is not None
    t0 = time.monotonic()
    r1 = compiled.execute(1)
    r2 = compiled.execute(2)
    assert ray_tpu_torch.get([r1, r2]) == [1, 2]
    elapsed = time.monotonic() - t0
    # sequential would be 4 x 0.3 = 1.2s; pipelined ~3 x 0.3 = 0.9s
    assert elapsed < 1.15, elapsed


def test_channel_mode_error_propagates(ray_start_regular):
    @ray_tpu_torch.remote(_in_process=True)
    class Bad:
        def boom(self, x):
            raise ValueError("channel boom")

    bad = Bad.remote()
    with InputNode() as inp:
        dag = bad.boom.bind(inp)
    compiled = dag.experimental_compile()
    assert compiled._executors is not None
    with pytest.raises(ValueError, match="channel boom"):
        ray_tpu_torch.get(compiled.execute(1))


def test_multi_output_channels(ray_start_regular):
    a, b = Stage.remote(1), Stage.remote(2)
    with InputNode() as inp:
        dag = MultiOutputNode([a.work.bind(inp), b.work.bind(inp)])
    compiled = dag.experimental_compile()
    assert compiled._executors is not None
    assert ray_tpu_torch.get(compiled.execute(10)) == [11, 12]


def test_task_node_falls_back_to_dynamic(ray_start_regular):
    @ray_tpu_torch.remote
    def double(x):
        return 2 * x

    with InputNode() as inp:
        dag = double.bind(inp)
    compiled = dag.experimental_compile()
    assert compiled._executors is None   # fallback path
    assert ray_tpu_torch.get(compiled.execute(4)) == 8


def test_process_actor_falls_back(ray_start_regular):
    @ray_tpu_torch.remote
    class P:
        def m(self, x):
            return x + 1

    p = P.remote()
    ray_tpu_torch.get(p.m.remote(0))   # ensure created
    with InputNode() as inp:
        dag = p.m.bind(inp)
    compiled = dag.experimental_compile()
    assert compiled._executors is None
    assert ray_tpu_torch.get(compiled.execute(1)) == 2
