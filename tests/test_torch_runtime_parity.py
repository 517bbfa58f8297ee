"""The port's runtime against the JAX package's runtime on the CPU.

One script runs on both packages' public API and must give equal results
and equal exception class names: once with JAX's process workers off
(``RAY_TPU_PROCESS_WORKERS=0``, every task in the calling process), and
once with both packages at their defaults (process workers, and plain tasks
through each one's native fast lane). The in-process and the daemons
scripts run on each control-plane core (``RAY_TPU_ASYNC_CORE``: the
asyncio core, both packages' default, and the threaded one).
"""

import contextlib
import gc

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu._private import object_store as jax_store
from ray_tpu._private import task_spec as jax_spec
from ray_tpu_torch._private import object_store as port_store
from ray_tpu_torch._private import task_spec as port_spec


@contextlib.contextmanager
def _jax_without_cyclic_gc():
    """JAX's runtime deadlocks when a cyclic GC pass runs an old ref's
    ``__del__`` inside its locations lock (``_locality_node`` holds a
    non-reentrant lock that ``_free_object`` takes again; ROADMAP C). Its
    runs here collect first and hold the collector off; the port's runs
    keep it on (the port's lock is reentrant)."""
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


def _error_name(fn) -> str:
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the class name is the result
        return type(e).__name__
    return "no error"


def _script(pkg) -> dict:
    """Ref args, nested tasks, multiple returns, a failing task and its
    error through a dependency, actor ordering, named and detached lookup
    across namespaces, wait over ready refs and a streaming generator."""
    out = {}

    @pkg.remote
    def add(a, b):
        return a + b

    @pkg.remote
    def outer(x):
        return pkg.get(add.remote(x, 1)) + 10

    @pkg.remote(num_returns=3)
    def three(x):
        return x, x * 2, x * 3

    @pkg.remote(max_retries=0)
    def boom():
        raise KeyError("first")

    @pkg.remote
    def consume(x):
        return x

    @pkg.remote
    def gen(n):
        for i in range(n):
            yield i * 10

    @pkg.remote
    class Counter:
        def __init__(self, start=0):
            self.n = start

        def inc(self, by=1):
            self.n += by
            return self.n

        def read(self):
            return self.n

    x = pkg.put(10)
    y = add.remote(x, 5)
    out["ref_args"] = pkg.get(add.remote(y, y))
    out["nested"] = pkg.get(outer.remote(1))
    out["multiple_returns"] = pkg.get(list(three.remote(7)))
    bad = boom.remote()
    out["failing_task"] = _error_name(lambda: pkg.get(bad))
    out["through_dependency"] = _error_name(
        lambda: pkg.get(consume.remote(boom.remote())))
    out["dependency_is_task_error"] = _error_name(
        lambda: pkg.get(consume.remote(bad))) != "no error"

    c = Counter.remote()
    out["ordering"] = pkg.get([c.inc.remote() for _ in range(30)])
    Counter.options(name="d1", lifetime="detached",
                    namespace="other").remote(3)
    named = pkg.get_actor("d1", namespace="other")
    out["detached_lookup"] = pkg.get(named.read.remote())
    out["lookup_other_namespace"] = _error_name(lambda: pkg.get_actor("d1"))
    Counter.options(name="n1").remote(5)
    out["named_lookup"] = pkg.get(pkg.get_actor("n1").inc.remote(2))
    out["duplicate_name"] = _error_name(
        lambda: Counter.options(name="n1").remote())
    pkg.kill(c)
    out["killed_actor"] = _error_name(lambda: pkg.get(c.read.remote()))

    refs = [add.remote(i, i) for i in range(6)]
    pkg.get(refs)
    ready, not_ready = pkg.wait(refs, num_returns=len(refs), timeout=30)
    out["wait"] = ([pkg.get(r) for r in ready], len(not_ready))
    ready, not_ready = pkg.wait(refs, num_returns=2, timeout=30)
    out["wait_capped"] = (len(ready), len(not_ready))
    out["streaming"] = [pkg.get(r) for r in gen.remote(5)]
    out["cluster_resources"] = pkg.cluster_resources()
    out["node_keys"] = sorted(pkg.nodes()[0])
    return out


@pytest.fixture
def jax_in_process(monkeypatch):
    monkeypatch.setenv("RAY_TPU_PROCESS_WORKERS", "0")
    yield
    ray_tpu.shutdown()


@pytest.mark.parametrize("core", ["1", "0"], ids=["async", "threaded"])
def test_one_script_gives_equal_results(jax_in_process, monkeypatch, core):
    monkeypatch.setenv("RAY_TPU_ASYNC_CORE", core)
    with _jax_without_cyclic_gc():
        ray_tpu.init(num_nodes=1, resources={"CPU": 8})
        try:
            jax_out = _script(ray_tpu)
        finally:
            ray_tpu.shutdown()
    ray_tpu_torch.init(num_nodes=1, resources={"CPU": 8})
    try:
        port_out = _script(ray_tpu_torch)
    finally:
        ray_tpu_torch.shutdown()
    assert port_out == jax_out
    # the script saw what the tests of each package say it should
    assert port_out["ref_args"] == 30 and port_out["nested"] == 12
    assert port_out["failing_task"] == "TaskError(KeyError)"
    assert port_out["ordering"] == list(range(1, 31))
    assert port_out["streaming"] == [0, 10, 20, 30, 40]


def test_one_script_at_both_defaults_through_both_lanes(monkeypatch):
    """Process workers and the fast lane on in both packages (their
    defaults): equal results and exception names, and each package's lane
    core counted the script's plain tasks, the same number in both."""
    import shutil
    if shutil.which("g++") is None:
        pytest.skip("no g++: neither package builds its lane")
    for var in ("RAY_TPU_PROCESS_WORKERS", "RAY_TPU_FAST_LANE",
                "RAY_TPU_NATIVE_STORE"):
        monkeypatch.delenv(var, raising=False)
    from ray_tpu._private import worker as jax_worker
    with _jax_without_cyclic_gc():
        ray_tpu.init(num_nodes=1, resources={"CPU": 8})
        try:
            jax_out = _script(ray_tpu)
            jax_lane = jax_worker.global_runtime().process_router \
                ._fast_core.stats()["submitted"]
        finally:
            ray_tpu.shutdown()
    rt = ray_tpu_torch.init(num_nodes=1, resources={"CPU": 8})
    try:
        port_out = _script(ray_tpu_torch)
        port_lane = rt.process_router.fast_stats()["submitted"]
    finally:
        ray_tpu_torch.shutdown()
    assert port_out == jax_out
    assert port_out["ordering"] == list(range(1, 31))
    assert port_out["failing_task"] == "TaskError(KeyError)"
    # ref_args' 2 adds, nested's outer and inner add, the 2 boom tasks and
    # wait's 6 adds; the consumers of a failed dependency never run
    assert port_lane == jax_lane == 12


def test_all_names_but_the_later_items():
    """Every name of ``ray_tpu.__all__``: no later item is left."""
    assert set(ray_tpu_torch.__all__) == set(ray_tpu.__all__)
    for name in ray_tpu_torch.__all__:
        assert hasattr(ray_tpu_torch, name), name


def test_system_config_flags_as_in_jax(jax_in_process):
    for pkg in (ray_tpu, ray_tpu_torch):
        with pytest.raises(ValueError, match="unknown _system_config"):
            pkg.init(_system_config={"no_such_flag": 1})
        pkg.init(num_nodes=1, resources={"CPU": 2},
                 _system_config={"exec_pool_size": 3})
        try:
            @pkg.remote
            def one():
                return 1
            assert pkg.get(one.remote()) == 1
        finally:
            pkg.shutdown()


def test_num_gpus_maps_to_the_card(jax_in_process):
    """``num_gpus`` is the card's ``GPU`` in the port where JAX's package
    gives ``TPU``; on a host without either, the demand fails at ``get``
    with ``TaskError(SchedulingError)`` in both."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    assert port_spec.resources_from_options({"num_gpus": 1}) == {"GPU": 1.0}
    assert port_spec.resources_from_options({"num_tpus": 2}) == {"GPU": 2.0}
    assert jax_spec.resources_from_options({"num_gpus": 1}) == {"TPU": 1.0}
    with pytest.raises(ValueError, match="GPU specified twice"):
        port_spec.resources_from_options({"num_gpus": 1,
                                          "resources": {"GPU": 1}})
    names = {}
    for pkg in (ray_tpu, ray_tpu_torch):
        pkg.init(num_nodes=1)      # this host's own resources
        try:
            res = pkg.cluster_resources()
            assert "GPU" not in res and "TPU" not in res, res

            @pkg.remote(num_gpus=1)
            def on_card():
                return 1

            with pytest.raises(pkg.exceptions.TaskError) as err:
                pkg.get(on_card.remote(), timeout=30)
            names[pkg.__name__] = (type(err.value).__name__,
                                   type(err.value.cause).__name__)
        finally:
            pkg.shutdown()
    assert names["ray_tpu_torch"] == names["ray_tpu"] == (
        "TaskError(SchedulingError)", "SchedulingError")


def test_device_tier_check_on_the_cpu():
    """CPU tensors, and containers of them, are host values; a tensor's
    size is its numpy array's."""
    t = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    for value in (t, [t, {"a": (t, 1)}], {"w": [t]}, (t,), 3, "s", None):
        assert port_store._is_device_value(value) is False
    # numpy has no bf16; float16 has its width
    widths = {torch.float32: np.float32, torch.bfloat16: np.float16,
              torch.int64: np.int64, torch.uint8: np.uint8}
    for dtype, np_dtype in widths.items():
        x = torch.zeros(5, 7, dtype=dtype)
        assert port_store._nbytes_of(x) == np.zeros((5, 7), np_dtype).nbytes
    arr = np.ones((3, 4))
    assert port_store._nbytes_of(arr) == jax_store._nbytes_of(arr)
    nested = {"a": [np.ones(8), b"xyz"], "b": "text"}
    assert port_store._nbytes_of(nested) == jax_store._nbytes_of(nested)


class _Point:
    def __init__(self, x, y):
        self.x, self.y = x, y


def _point_out(p):
    return (p.x, p.y)


def _point_in(t):
    return _Point(t[0] * 10, t[1])


@pytest.mark.parametrize("pkg", ["ray_tpu", "ray_tpu_torch"])
def test_serialization_round_trip(pkg):
    """Both serializers keep numpy payloads out of band, record nested refs
    and apply registered serializers. Only the pickler differs: cloudpickle
    in JAX's, the stdlib's in the port, which pickles functions by
    reference (so the serializers here are module-level functions)."""
    import importlib
    ser = importlib.import_module(f"{pkg}._private.serialization")
    ids = importlib.import_module(f"{pkg}._private.ids")
    refs = importlib.import_module(f"{pkg}._private.object_ref")
    ref = refs.ObjectRef(ids.ObjectID.from_random(), _register=False)
    ctx = ser.SerializationContext()
    ctx.register_custom_serializer(_Point, _point_out, _point_in)
    value = {"a": np.arange(1000, dtype=np.float32), "refs": [ref],
             "p": _Point(1, 2), "s": "text"}
    sv = ctx.serialize(value)
    assert len(sv.buffers) == 1              # the array, out of band
    assert [r.id for r in sv.nested_refs] == [ref.id]
    assert sv.total_bytes >= 4000
    back = ctx.deserialize(sv)
    np.testing.assert_array_equal(back["a"], value["a"])
    assert back["refs"][0].id == ref.id and back["s"] == "text"
    assert (back["p"].x, back["p"].y) == (10, 2)
    ctx.deregister_custom_serializer(_Point)
    assert ctx.deserialize(ctx.serialize(_Point(1, 2))).x == 1
    import threading
    assert ser.check_serializable({"ok": 1}) is None
    assert ser.check_serializable(threading.Lock()).startswith("TypeError")


@pytest.mark.parametrize("pkg", ["ray_tpu", "ray_tpu_torch"])
def test_named_actors_per_namespace(pkg):
    """The GCS's named-actor table: a name is unique per namespace while
    its actor lives, and free again once it is dead."""
    import importlib
    gcs = importlib.import_module(f"{pkg}._private.gcs")
    ids = importlib.import_module(f"{pkg}._private.ids")
    table = gcs.GCS()

    def info(name, ns):
        return gcs.ActorInfo(actor_id=ids.ActorID.from_random(), name=name,
                             namespace=ns)

    a = info("svc", "ns1")
    table.register_actor(a)
    table.register_actor(info("svc", "ns2"))
    with pytest.raises(ValueError, match="already taken"):
        table.register_actor(info("svc", "ns1"))
    got, created = table.register_actor_or_get_existing(info("svc", "ns1"))
    assert got == a.actor_id and not created
    assert table.get_named_actor("svc", "ns1") == a.actor_id
    assert table.get_named_actor("svc", "ns3") is None
    assert sorted(d["namespace"] for d in table.list_named_actors(
        all_namespaces=True)) == ["ns1", "ns2"]
    table.update_actor_state(a.actor_id, gcs.ActorState.DEAD,
                             death_cause="killed")
    assert table.get_named_actor("svc", "ns1") is None
    b = info("svc", "ns1")
    got, created = table.register_actor_or_get_existing(b)
    assert got == b.actor_id and created
    assert table.kv_put(b"k", b"v") and not table.kv_put(
        b"k", b"w", overwrite=False)
    assert table.kv_get(b"k") == b"v" and table.kv_keys(b"") == [b"k"]


def test_serve_exports_jax_names():
    import ray_tpu.serve
    import ray_tpu_torch.serve
    assert ray_tpu_torch.serve.__all__ == ray_tpu.serve.__all__
    for name in ray_tpu_torch.serve.__all__:
        assert hasattr(ray_tpu_torch.serve, name), name


def _serve_script(pkg) -> dict:
    """Composition, ``@serve.batch``, ``@serve.multiplexed``, streaming,
    status and ``local_testing_mode`` on one package's serve."""
    import importlib
    serve = importlib.import_module(pkg.__name__ + ".serve")
    out = {}

    @serve.deployment
    class Pre:
        def __call__(self, x):
            return x * 2

    @serve.deployment
    class Model:
        def __init__(self, pre):
            self.pre = pre

        def __call__(self, x):
            return self.pre.remote(x).result() + 1

    handle = serve.run(Model.bind(Pre.bind()))
    out["composition"] = [handle.remote(i).result(timeout=30)
                          for i in range(4)]

    @serve.deployment(max_ongoing_requests=16)
    class Batched:
        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.05)
        def handle(self, items):
            return [i * 10 for i in items]

        def __call__(self, x):
            return self.handle(x)

    handle = serve.run(Batched.bind(), name="batched")
    out["batch"] = sorted(r.result(timeout=30)
                          for r in [handle.remote(i) for i in range(8)])

    @serve.deployment
    class Multi:
        @serve.multiplexed(max_num_models_per_replica=2)
        def get_model(self, model_id):
            return f"model-{model_id}"

        def __call__(self, model_id):
            return (self.get_model(model_id),
                    self.get_model._model_cache.ids(),
                    serve.get_multiplexed_model_id())

    handle = serve.run(Multi.bind(), name="multi")
    out["multiplexed"] = [handle.remote(m).result(timeout=30)
                          for m in ("a", "b", "a", "c")]

    @serve.deployment
    def count(n):
        for i in range(n):
            yield {"i": i}

    handle = serve.run(count.bind(), name="stream")
    out["streaming"] = list(handle.options(stream=True).remote(4))
    out["unary_of_stream"] = type(
        handle.remote(2).result(timeout=30)).__name__
    status = serve.status()
    out["status"] = {name: (st["num_replicas"], st["target_replicas"],
                            st["autoscaling"])
                     for name, st in status.items()}
    serve.delete("stream")
    out["after_delete"] = sorted(serve.status())
    local = serve.run(Model.bind(Pre.bind()), local_testing_mode=True)
    out["local_testing"] = [local.remote(i).result() for i in range(4)]
    serve.shutdown()
    return out


def test_one_serve_script_gives_equal_results(jax_in_process):
    ray_tpu.init(num_nodes=1, resources={"CPU": 8})
    try:
        jax_out = _serve_script(ray_tpu)
    finally:
        ray_tpu.shutdown()
    ray_tpu_torch.init(num_nodes=1, resources={"CPU": 8})
    try:
        port_out = _serve_script(ray_tpu_torch)
    finally:
        ray_tpu_torch.shutdown()
    assert port_out == jax_out
    assert port_out["composition"] == [1, 3, 5, 7]
    assert port_out["batch"] == [i * 10 for i in range(8)]
    assert port_out["multiplexed"][-1] == ("model-c", ["a", "c"], "")
    assert port_out["streaming"] == [{"i": i} for i in range(4)]
    assert port_out["local_testing"] == [1, 3, 5, 7]


def test_train_and_util_export_jax_names():
    import ray_tpu.train
    import ray_tpu.util.scheduling_strategies
    import ray_tpu_torch.train
    import ray_tpu_torch.util.scheduling_strategies
    assert ray_tpu_torch.train.__all__ == ray_tpu.train.__all__
    assert ray_tpu_torch.util.scheduling_strategies.__all__ == \
        ray_tpu.util.scheduling_strategies.__all__
    for name in ray_tpu_torch.train.__all__:
        assert hasattr(ray_tpu_torch.train, name), name


def test_tune_util_and_collective_export_jax_names():
    import ray_tpu.tune
    import ray_tpu.util
    import ray_tpu.util.collective
    import ray_tpu_torch.tune
    import ray_tpu_torch.util
    import ray_tpu_torch.util.collective
    for jax_mod, port_mod in (
            (ray_tpu.tune, ray_tpu_torch.tune),
            (ray_tpu.util, ray_tpu_torch.util),
            (ray_tpu.util.collective, ray_tpu_torch.util.collective)):
        assert port_mod.__all__ == jax_mod.__all__
        for name in port_mod.__all__:
            assert hasattr(port_mod, name), (port_mod.__name__, name)


def _pg_train_script(pkg, tmp) -> dict:
    """A placement group with a task and an actor placed into its bundles,
    the errors of a demand too big for a bundle, a bad bundle index and a
    removed group; then ``JaxTrainer`` on two workers whose rank 0 fails
    once at step 2, and a run that fails for good."""
    import importlib
    util = importlib.import_module(pkg.__name__ + ".util")
    train = importlib.import_module(pkg.__name__ + ".train")
    out = {}

    @pkg.remote
    def where():
        return pkg.get_runtime_context().get_node_id()

    @pkg.remote
    class Where:
        def node(self):
            return pkg.get_runtime_context().get_node_id()

    before = pkg.available_resources()["CPU"]
    pg = util.placement_group([{"CPU": 2}, {"CPU": 2}],
                              strategy="STRICT_SPREAD", name="g")
    out["ready"] = pkg.get(pg.ready(), timeout=10).is_ready()
    out["distinct_nodes"] = len({n.hex() for n in pg.bundle_nodes()})
    out["reserved"] = before - pkg.available_resources()["CPU"]
    in_b1 = pkg.PlacementGroupSchedulingStrategy(
        pg, placement_group_bundle_index=1)
    out["task_in_bundle"] = pkg.get(where.options(
        scheduling_strategy=in_b1, num_cpus=1).remote()) == \
        pg.bundle_nodes()[1].hex()
    actor = Where.options(num_cpus=2, scheduling_strategy=(
        pkg.PlacementGroupSchedulingStrategy(
            pg, placement_group_bundle_index=0))).remote()
    out["actor_in_bundle"] = pkg.get(actor.node.remote()) == \
        pg.bundle_nodes()[0].hex()
    out["too_big"] = _error_name(lambda: pkg.get(where.options(
        scheduling_strategy=in_b1, num_cpus=4).remote(), timeout=10))
    out["bad_index"] = _error_name(lambda: pkg.get(where.options(
        scheduling_strategy=pkg.PlacementGroupSchedulingStrategy(
            pg, placement_group_bundle_index=5)).remote(), timeout=10))
    out["table"] = {k: v for k, v in util.placement_group_table()[
        pg.id.hex()].items() if k in ("name", "strategy", "state",
                                      "bundles")}
    pkg.kill(actor)
    util.remove_placement_group(pg)
    out["removed"] = _error_name(lambda: pkg.get(where.options(
        scheduling_strategy=in_b1).remote(), timeout=2))
    out["freed"] = pkg.available_resources()["CPU"] == before

    # rank 0 takes the failure: when rank 1 does, JAX's trainer can return
    # rank 1's older report as the result's metrics
    marker = tmp / f"{pkg.__name__}_crashed"

    def train_fn(config):
        ctx = train.get_context()
        prev = train.get_checkpoint()
        start = 0 if prev is None else int(prev.to_pytree()["step"]) + 1
        for step in range(start, 4):
            if (step == 2 and ctx.get_world_rank() == 0
                    and not marker.exists()):
                marker.write_text("x")
                raise RuntimeError("injected failure at step 2")
            ck = (train.Checkpoint.from_pytree({"step": step})
                  if ctx.get_world_rank() == 0 else None)
            train.report({"step": step, "world": ctx.get_world_size()},
                         checkpoint=ck)

    result = train.JaxTrainer(
        train_fn, scaling_config=train.ScalingConfig(num_workers=2),
        run_config=train.RunConfig(
            name="retry", storage_path=str(tmp / pkg.__name__),
            failure_config=train.FailureConfig(max_failures=1))).fit()
    out["retry"] = (result.error, result.metrics,
                    [e["metrics"]["step"] for e in result.metrics_history
                     if e["rank"] == 0],
                    result.checkpoint.to_pytree())

    def always_fails(config):
        raise ValueError("always fails")

    result = train.JaxTrainer(
        always_fails, scaling_config=train.ScalingConfig(num_workers=1),
        run_config=train.RunConfig(
            name="fail", storage_path=str(tmp / pkg.__name__))).fit()
    out["exhausted"] = result.error.split(":")[0]
    return out


def test_one_placement_and_train_script_gives_equal_results(
        jax_in_process, tmp_path):
    outs = {}
    for pkg in (ray_tpu, ray_tpu_torch):
        pkg.init(num_nodes=4, resources={"CPU": 4})
        try:
            outs[pkg.__name__] = _pg_train_script(pkg, tmp_path)
        finally:
            pkg.shutdown()
    port_out, jax_out = outs["ray_tpu_torch"], outs["ray_tpu"]
    # a task into a removed group: JAX's re-queues itself on a new thread
    # for ever (its wait is `not pg.is_ready()`), so get() times out; the
    # port's fails at once (ROADMAP C8)
    assert jax_out.pop("removed") == "GetTimeoutError"
    assert port_out.pop("removed") == \
        "TaskError(PlacementGroupUnschedulableError)"
    assert port_out == jax_out
    assert port_out["ready"] and port_out["distinct_nodes"] == 2
    assert port_out["bad_index"] == "TaskError(ValueError)"
    assert port_out["retry"] == (None, {"step": 3, "world": 2},
                                 [0, 1, 2, 3], {"step": 3})


def _daemons_script(pkg, marker) -> dict:
    """The daemon cluster's surface: tasks, actors, nested ops, errors, a
    16 MiB array through a daemon's arena, a two-bundle group, and a
    SIGKILLed daemon with a task retry and a lineage reconstruction."""
    import os
    import signal
    import time

    from importlib import import_module
    pg_mod = import_module(pkg.__name__ + ".util.placement_group")
    rt = pkg.init(num_nodes=2, resources={"CPU": 4}, cluster="daemons",
                  object_store_memory=128 << 20)
    out = {}
    try:
        handles = list(rt.cluster_backend.daemons.values())
        out["processes"] = (rt.cluster_backend.head_proc.poll() is None,
                            [h.proc.poll() is None for h in handles])

        @pkg.remote
        def add(a, b):
            return a + b

        @pkg.remote
        def outer(x):
            return pkg.get(add.remote(x, 1)) + 10

        @pkg.remote(max_retries=0)
        def boom():
            raise KeyError("first")

        @pkg.remote
        def consume(x):
            return x

        @pkg.remote(max_retries=3)
        def make(seed):
            import numpy as np
            rng = np.random.default_rng(seed)
            return rng.standard_normal(4 << 20).astype(np.float32)

        @pkg.remote
        def total(refs):
            return float(pkg.get(refs)[0].sum())

        @pkg.remote
        class Counter:
            def __init__(self, start=0):
                self.n = start

            def inc(self, by=1):
                self.n += by
                return self.n

        out["ref_args"] = pkg.get(add.remote(add.remote(1, 2), 4))
        out["nested"] = pkg.get(outer.remote(1))
        bad = boom.remote()
        out["failing_task"] = _error_name(lambda: pkg.get(bad))
        out["through_dependency"] = _error_name(
            lambda: pkg.get(consume.remote(bad)))
        c = Counter.remote(5)
        out["actor"] = pkg.get([c.inc.remote() for _ in range(3)])
        # 16 MiB made in a daemon's worker, left in its arena, read by the
        # driver and by a consumer task in a worker
        node0 = handles[0].node_id.hex()
        big = make.options(scheduling_strategy=pkg.NodeAffinitySchedulingStrategy(
            node_id=node0, soft=True)).remote(7)
        arr = pkg.get(big)
        out["array"] = (arr.shape, str(arr.dtype), float(arr.sum()),
                        bool(arr.flags.writeable))
        out["array_in_worker"] = pkg.get(total.remote([big]))
        out["arena_used"] = max(h.client.call("daemon_stats")["store_used"]
                                for h in handles) >= 16 << 20
        # a group of two bundles, one on each daemon
        pg = pg_mod.placement_group([{"CPU": 1}, {"CPU": 1}],
                                    strategy="STRICT_SPREAD")
        out["pg_ready"] = pg.wait(15)
        out["pg_nodes"] = len({n for n in pg.bundle_nodes()})
        strat = pkg.PlacementGroupSchedulingStrategy(placement_group=pg)
        out["pg_task"] = pkg.get(add.options(
            scheduling_strategy=strat).remote(20, 1))
        pg_mod.remove_placement_group(pg)

        # a SIGKILLed daemon: its running task retries on the survivor and
        # the 16 MiB object it held is rebuilt from lineage
        @pkg.remote(max_retries=2)
        def slow():
            import os as _os
            import time as _time
            n = len(_os.listdir(marker))
            open(_os.path.join(marker, str(n)), "w").close()
            if n == 0:
                _time.sleep(30)
            return "recovered"

        ref = slow.options(scheduling_strategy=pkg.NodeAffinitySchedulingStrategy(
            node_id=node0, soft=True)).remote()
        deadline = time.monotonic() + 15
        while (not os.listdir(marker)
               and time.monotonic() < deadline):
            time.sleep(0.05)
        del arr
        os.kill(handles[0].proc.pid, signal.SIGKILL)
        out["retry"] = pkg.get(ref, timeout=30)
        deadline = time.monotonic() + 10
        while (any(n.node_id.hex() == node0 for n in rt.alive_nodes())
               and time.monotonic() < deadline):
            time.sleep(0.05)
        out["victim_gone"] = not any(n.node_id.hex() == node0
                                     for n in rt.alive_nodes())
        again = pkg.get(big, timeout=60)
        out["reconstructed"] = float(again.sum()) == out["array"][2]
        out["attempts"] = len(os.listdir(marker))
    finally:
        pkg.shutdown()
    return out


def _jax_daemons_reference(tmp_path) -> dict:
    """JAX's side of the daemons script. JAX's daemons lose the task
    retried after the SIGKILL in about a third of runs on an 8-core host
    (its get times out, or the retry goes back to the dead daemon and
    fails with ``WorkerCrashedError``; the port's does neither: ROADMAP C),
    so a JAX run that fails so runs again in a fresh marker dir, at most
    three times."""
    for attempt in range(3):
        marker = tmp_path / f"jax{attempt}"
        marker.mkdir()
        try:
            with _jax_without_cyclic_gc():
                return _daemons_script(ray_tpu, str(marker))
        except (ray_tpu.exceptions.GetTimeoutError,
                ray_tpu.exceptions.TaskError):
            if attempt == 2:
                raise


@pytest.mark.parametrize("core", ["1", "0"], ids=["async", "threaded"])
def test_one_daemons_script_gives_equal_results(tmp_path, monkeypatch, core):
    """cluster="daemons" in both packages: the same results and exception
    class names, on each package's own head, daemons and wire, with the
    driver, head and daemons on each control-plane core."""
    for var in ("RAY_TPU_PROCESS_WORKERS", "RAY_TPU_FAST_LANE",
                "RAY_TPU_NATIVE_STORE", "RAY_TPU_CLUSTER"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("RAY_TPU_ASYNC_CORE", core)
    (tmp_path / "port").mkdir()
    jax_out = _jax_daemons_reference(tmp_path)
    port_out = _daemons_script(ray_tpu_torch, str(tmp_path / "port"))
    assert port_out == jax_out
    assert port_out["processes"] == (True, [True, True])
    assert port_out["failing_task"] == "TaskError(KeyError)"
    assert port_out["actor"] == [6, 7, 8]
    assert port_out["array"][:2] == ((4 << 20,), "float32")
    assert port_out["array_in_worker"] == port_out["array"][2]
    assert port_out["pg_ready"] and port_out["pg_nodes"] == 2
    assert port_out["retry"] == "recovered" and port_out["victim_gone"]
    assert port_out["reconstructed"] and port_out["attempts"] == 2
