"""The scale-envelope tier on the port: the three ``envelope`` tests of
JAX's ``tests/test_stress.py`` on ``ray_tpu_torch`` (100,000 queued tasks,
5,000 actors, 64 virtual nodes), the single-host slices of the reference's
``release/benchmarks`` envelopes. A file of their own, so that
``--dist loadfile`` runs them beside the tier-1 stress tests.
"""

import time

import pytest

import ray_tpu_torch


@pytest.fixture
def ray_start_regular():
    """JAX's fixture: a 1-node runtime of 8 CPUs a test."""
    rt = ray_tpu_torch.init(num_nodes=1, resources={"CPU": 8})
    yield rt
    ray_tpu_torch.shutdown()


@pytest.mark.envelope
def test_queued_task_backlog_100k(ray_start_regular):
    """100,000 no-op tasks queued before any get, fully drained, with
    drain-rate parity vs a 10k run — the flat-degradation evidence for
    the reference's 1M-queued envelope (shape-bucketed dispatch keeps
    each completion O(#shapes), not O(backlog))."""

    @ray_tpu_torch.remote(_in_process=True)
    def val(i):
        return i

    t0 = time.perf_counter()
    out = ray_tpu_torch.get([val.remote(i) for i in range(10_000)],
                      timeout=900)
    rate_10k = 10_000 / (time.perf_counter() - t0)
    assert out == list(range(10_000))

    t0 = time.perf_counter()
    refs = [val.remote(i) for i in range(100_000)]
    submit_s = time.perf_counter() - t0
    out = ray_tpu_torch.get(refs, timeout=3600)
    rate_100k = 100_000 / (time.perf_counter() - t0)
    assert out == list(range(100_000))
    assert rate_100k > rate_10k / 3, (
        f"superlinear degradation: {rate_10k:.0f}/s @10k vs "
        f"{rate_100k:.0f}/s @100k (submit {submit_s:.1f}s)")


@pytest.mark.envelope
def test_many_actors_5000(ray_start_regular):
    """5,000 live actors all answering (reference envelope: 40k
    cluster-wide on 64 hosts; this is the one-host slice)."""

    @ray_tpu_torch.remote(_in_process=True)
    class Cell:
        def __init__(self, i):
            self.i = i

        def get(self):
            return self.i

    cells = [Cell.remote(i) for i in range(5000)]
    out = ray_tpu_torch.get([c.get.remote() for c in cells], timeout=1800)
    assert out == list(range(5000))
    for c in cells:
        ray_tpu_torch.kill(c)


@pytest.mark.envelope
def test_64_virtual_node_scheduling():
    """64 virtual nodes: spread tasks land on >= 32 distinct nodes and
    a STRICT_SPREAD placement group claims 16 distinct nodes (the
    many-node scheduling slice of the 2,000-node reference envelope)."""
    import ray_tpu_torch
    from ray_tpu_torch.util.placement_group import placement_group

    rt = ray_tpu_torch.init(num_nodes=64, resources={"CPU": 2})
    try:
        @ray_tpu_torch.remote(_in_process=True,
                        scheduling_strategy="SPREAD")
        def where():
            ctx = ray_tpu_torch.get_runtime_context()
            return ctx.get_node_id()

        nodes = set(ray_tpu_torch.get([where.remote() for _ in range(256)],
                                timeout=600))
        assert len(nodes) >= 32, f"spread reached only {len(nodes)} nodes"

        pg = placement_group([{"CPU": 1}] * 16, strategy="STRICT_SPREAD")
        assert pg.wait(60)
        pg_nodes = {b.node_id for b in pg.bundles}
        assert len(pg_nodes) == 16
    finally:
        ray_tpu_torch.shutdown()
