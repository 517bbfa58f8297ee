"""Process workers on the port's runtime: the tests of
``tests/test_process_workers.py`` on ``ray_tpu_torch``'s API (isolation,
recycling, crash handling), the accelerator-plane rule, and the by-value
pickler that carries driver code to a worker
(``ray_tpu_torch/_private/serialization.py``)."""

import dataclasses
import gc
import os
import pickle
import signal
import subprocess
import sys
import textwrap
import threading
import time
import weakref

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import exceptions as exc
from ray_tpu_torch._private import serialization, worker_process
from ray_tpu_torch._private.device_objects import DeviceValue, wire_dumps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def ray_start_regular():
    rt = ray_tpu_torch.init(num_nodes=1, resources={"CPU": 8})
    yield rt
    ray_tpu_torch.shutdown()


@pytest.fixture
def ray_start_cluster():
    rt = ray_tpu_torch.init(num_nodes=4, resources={"CPU": 4})
    yield rt
    ray_tpu_torch.shutdown()


# ---------------------------------------------------------------------------
# tests/test_process_workers.py
# ---------------------------------------------------------------------------

def test_tasks_run_in_separate_process(ray_start_regular):
    @ray_tpu_torch.remote
    def worker_pid():
        return os.getpid()

    pid = ray_tpu_torch.get(worker_pid.remote())
    assert pid != os.getpid()


def test_result_immutability_across_consumers(ray_start_regular):
    """A consumer mutating a task result must not affect other consumers
    (every value crosses a serialization boundary)."""

    @ray_tpu_torch.remote
    def make():
        return {"xs": [1, 2, 3]}

    @ray_tpu_torch.remote
    def mutate(d):
        d["xs"].append(99)
        return len(d["xs"])

    ref = make.remote()
    assert ray_tpu_torch.get(mutate.remote(ref)) == 4
    assert ray_tpu_torch.get(ref)["xs"] == [1, 2, 3]

    @ray_tpu_torch.remote
    def make_arr():
        return np.arange(10)

    arr = ray_tpu_torch.get(make_arr.remote())
    with pytest.raises(ValueError):
        arr[0] = 5


def test_driver_closure_mutation_does_not_leak(ray_start_regular):
    state = {"n": 0}

    @ray_tpu_torch.remote
    def bump():
        state["n"] += 1
        return state["n"]

    ray_tpu_torch.get(bump.remote())
    assert state["n"] == 0  # the driver's copy is untouched


def test_worker_sigkill_triggers_task_retry(ray_start_regular, tmp_path):
    """kill -9 of the worker process mid-task: retried on a new process."""
    marker = str(tmp_path / "attempt")

    @ray_tpu_torch.remote(max_retries=2)
    def slow():
        import os as _os
        import time as _time
        n = len(_os.listdir(_os.path.dirname(marker)))
        with open(f"{marker}.{n}", "w") as f:
            f.write(str(_os.getpid()))
        if n == 0:
            _time.sleep(30)  # the first attempt is killed mid-flight
        return _os.getpid()

    ref = slow.remote()
    deadline = time.monotonic() + 10
    pid = None
    while pid is None and time.monotonic() < deadline:
        try:
            with open(f"{marker}.0") as f:
                content = f.read().strip()
            if content:
                pid = int(content)
        except (FileNotFoundError, ValueError):
            pass
        time.sleep(0.05)
    assert pid is not None, "task never landed on a worker process"
    os.kill(pid, signal.SIGKILL)
    out = ray_tpu_torch.get(ref, timeout=30)
    assert out != pid  # retried on a different process
    assert len(os.listdir(tmp_path)) == 2


def test_actor_sigkill_restart(ray_start_regular):
    @ray_tpu_torch.remote(max_restarts=1)
    class P:
        def __init__(self):
            self.boot = time.monotonic()

        def pid(self):
            return os.getpid()

    a = P.remote()
    pid1 = ray_tpu_torch.get(a.pid.remote())
    os.kill(pid1, signal.SIGKILL)
    deadline = time.monotonic() + 20
    pid2 = None
    while time.monotonic() < deadline:
        try:
            pid2 = ray_tpu_torch.get(a.pid.remote(), timeout=10)
            break
        except (exc.ActorError, exc.ActorUnavailableError, exc.TaskError,
                exc.GetTimeoutError):
            time.sleep(0.2)
    assert pid2 is not None and pid2 != pid1


def test_dirty_actor_worker_not_recycled(ray_start_regular):
    """An actor that leaks a reference to itself (a background thread) must
    not poison the pool: its process is killed on actor death, and later
    tasks run correctly on clean workers."""

    @ray_tpu_torch.remote
    class Leaky:
        def __init__(self):
            import threading

            self.stop = False

            def loop(me=self):
                while not me.stop:
                    time.sleep(0.01)

            self.t = threading.Thread(target=loop, daemon=True)
            self.t.start()

        def pid(self):
            return os.getpid()

    a = Leaky.remote()
    leaky_pid = ray_tpu_torch.get(a.pid.remote())
    ray_tpu_torch.kill(a)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        try:
            os.kill(leaky_pid, 0)
        except ProcessLookupError:
            break
        time.sleep(0.1)
    else:
        pytest.fail(f"dirty actor worker {leaky_pid} still alive")

    @ray_tpu_torch.remote
    def ok():
        return "fine"

    assert ray_tpu_torch.get(ok.remote()) == "fine"


def test_function_table_ships_code_once(ray_start_regular):
    """The same remote function reuses its exported blob."""
    from ray_tpu_torch._private.worker_process import _FN_TABLE

    @ray_tpu_torch.remote
    def fn(x):
        return x + 1

    before = len(_FN_TABLE)
    ray_tpu_torch.get([fn.remote(i) for i in range(5)])
    added = len(_FN_TABLE) - before
    assert added <= 1


def test_nested_submission_from_worker(ray_start_regular):
    """Tasks submitted from inside a worker process work transparently."""

    @ray_tpu_torch.remote
    def inner(x):
        return x * 2

    @ray_tpu_torch.remote
    def outer(xs):
        return sum(ray_tpu_torch.get([inner.remote(x) for x in xs]))

    assert ray_tpu_torch.get(outer.remote([1, 2, 3])) == 12


def test_placement_group_from_worker(ray_start_cluster):
    """Workers can create placement groups and schedule into them."""

    @ray_tpu_torch.remote
    def with_pg():
        from ray_tpu_torch.util.placement_group import (
            placement_group, remove_placement_group)
        from ray_tpu_torch._private.task_spec import \
            PlacementGroupSchedulingStrategy

        pg = placement_group([{"CPU": 1}], strategy="PACK")
        assert pg.wait(15)

        @ray_tpu_torch.remote(num_cpus=1, scheduling_strategy=
                              PlacementGroupSchedulingStrategy(
                                  placement_group=pg,
                                  placement_group_bundle_index=0))
        def inside():
            return "placed"

        out = ray_tpu_torch.get(inside.remote(), timeout=20)
        remove_placement_group(pg)
        return out

    assert ray_tpu_torch.get(with_pg.remote(), timeout=60) == "placed"


# ---------------------------------------------------------------------------
# the accelerator-plane rule and the worker's platform
# ---------------------------------------------------------------------------

def test_workers_cannot_see_the_card(ray_start_regular):
    @ray_tpu_torch.remote
    def probe():
        import torch as _torch
        return (os.environ.get("CUDA_VISIBLE_DEVICES"),
                _torch.cuda.is_available())

    assert ray_tpu_torch.get(probe.remote()) == ("", False)


def test_accelerator_plane_stays_in_the_driver():
    """A GPU demand and an ``_in_process`` actor stay in the driver; other
    tasks and actors run in worker processes."""
    ray_tpu_torch.init(num_nodes=1, resources={"CPU": 8, "GPU": 1})
    try:
        @ray_tpu_torch.remote
        def pid():
            return os.getpid()

        assert ray_tpu_torch.get(pid.remote()) != os.getpid()
        assert ray_tpu_torch.get(
            pid.options(num_gpus=1).remote()) == os.getpid()

        @ray_tpu_torch.remote
        class A:
            def pid(self):
                return os.getpid()

        assert ray_tpu_torch.get(A.remote().pid.remote()) != os.getpid()
        assert ray_tpu_torch.get(A.options(
            _in_process=True).remote().pid.remote()) == os.getpid()
        assert ray_tpu_torch.get(A.options(
            num_gpus=1).remote().pid.remote()) == os.getpid()
    finally:
        ray_tpu_torch.shutdown()


@dataclasses.dataclass
class _Placed:
    name: str
    device: torch.device


# A tensor off the CPU, made without a card: the ``meta`` device stands in
# for ``cuda`` here (a worker process can hold neither), and
# ``torch.device("cuda")`` needs no card to exist.
_OFF_HOST_ARGS = {
    "module": lambda: (torch.nn.Linear(4, 2, device="meta"),),
    "tensor in a dict": lambda: ({"w": torch.ones(3, device="meta")},),
    "device in a dataclass": lambda: (_Placed("x", torch.device("cuda")),),
    "device in a closure": lambda: (
        (lambda dev=torch.device("cuda:0"): str(dev)),),
}


@pytest.mark.parametrize("case", sorted(_OFF_HOST_ARGS))
def test_a_value_off_the_cpu_keeps_its_task_in_the_driver(
        ray_start_regular, case):
    """The rule is read off the payload as the wire pickles it: a tensor or
    a ``torch.device`` off the CPU anywhere in the arguments (a module's
    parameters, a dataclass, a function's defaults) keeps the task in the
    driver, and its result keeps its device."""
    @ray_tpu_torch.remote
    def run(value):
        if isinstance(value, torch.nn.Module):
            out = value(torch.ones(1, 4, device="meta"))
        elif isinstance(value, dict):
            out = value["w"] * 2
        else:
            out = torch.zeros(1, device="meta")
        return os.getpid(), out

    args = _OFF_HOST_ARGS[case]()
    # the wire refuses it as off the CPU (a meta tensor could not be copied
    # to the host either; a CUDA tensor could, and would be)
    with pytest.raises(DeviceValue):
        wire_dumps(args, host_only=True)
    got_pid, out = ray_tpu_torch.get(run.remote(*args))
    assert got_pid == os.getpid()
    assert out.device.type == "meta"


def test_a_closure_over_a_tensor_off_the_cpu_runs_in_the_driver(
        ray_start_regular):
    """The function itself: a closure (and a global of a by-value
    function) holding a tensor off the CPU keeps its task in the driver,
    each time it is submitted; the same closure over a CPU tensor goes to a
    worker."""
    def make(t):
        def twice():
            return os.getpid(), t * 2
        return twice

    held = torch.ones(2, device="meta")
    fn, probe = make(held), weakref.ref(held)
    for _ in range(2):
        with pytest.raises(DeviceValue):
            worker_process.export_function(fn)
    del fn, held
    gc.collect()
    assert probe() is None      # the function table's memo let go of it
    fn = make(torch.ones(2, device="meta"))
    on_meta = ray_tpu_torch.remote(fn)
    on_cpu = ray_tpu_torch.remote(make(torch.ones(2)))
    for _ in range(2):
        got_pid, out = ray_tpu_torch.get(on_meta.remote())
        assert got_pid == os.getpid() and out.device.type == "meta"
    got_pid, out = ray_tpu_torch.get(on_cpu.remote())
    assert got_pid != os.getpid() and torch.equal(out, torch.full((2,), 2.))


def test_an_actor_given_the_cards_device_stays_in_the_driver(
        ray_start_regular):
    """An actor whose constructor gets a factory closing over a CUDA
    device (the shape of an RL runner's policy factory) is built in the
    driver; a process actor's method refuses a tensor off the CPU rather
    than copy it to the host."""
    @ray_tpu_torch.remote
    class Runner:
        def __init__(self, factory):
            self.factory = factory

        def pid(self):
            return os.getpid()

        def device_of(self, t):
            return str(t.device)

    dev = torch.device("cuda")
    on_card = Runner.remote(lambda: dev)
    assert ray_tpu_torch.get(on_card.pid.remote()) == os.getpid()
    assert ray_tpu_torch.get(on_card.device_of.remote(
        torch.ones(1, device="meta"))) == "meta"
    on_host = Runner.remote(lambda: torch.device("cpu"))
    assert ray_tpu_torch.get(on_host.pid.remote()) != os.getpid()
    with pytest.raises(exc.TaskError, match="num_gpus or _in_process"):
        ray_tpu_torch.get(on_host.device_of.remote(
            torch.ones(1, device="meta")))
    assert ray_tpu_torch.get(on_host.device_of.remote(
        torch.ones(1))) == "cpu"


def _trial_pid(config, device):
    from ray_tpu_torch import tune
    tune.report({"pid": os.getpid(), "device": str(device)})


def test_tuner_trials_that_name_the_card_run_in_the_driver(
        ray_start_regular):
    """``with_parameters(fn, device=torch.device("cuda"))``: the trials run
    in the driver, which owns the card; on the CPU device in worker
    processes."""
    from ray_tpu_torch import tune

    def pids(device):
        grid = tune.Tuner(
            tune.with_parameters(_trial_pid, device=device),
            param_space={"x": tune.grid_search([0, 1])}).fit()
        assert not grid.errors
        return {t.last_result["pid"] for t in grid.trials}

    assert pids(torch.device("cuda")) == {os.getpid()}
    assert os.getpid() not in pids(torch.device("cpu"))


def test_pyarrow_is_preloaded_in_the_template(tmp_path):
    """Workers start with pyarrow imported, as JAX's do: pyarrow first
    imported in one task's thread and used from another's after it ended
    segfaults the worker."""
    pytest.importorskip("pyarrow")
    ray_tpu_torch.init(num_nodes=1, resources={"CPU": 1},
                       _system_config={"process_pool_size": 1})
    try:
        @ray_tpu_torch.remote(max_retries=0)
        def read_json(path):
            preloaded = "pyarrow" in sys.modules
            import pyarrow.json as pj
            with open(path, "w") as f:
                f.write('{"a": 1}\n{"a": 2}\n')
            return preloaded, pj.read_json(path).num_rows

        @ray_tpu_torch.remote(max_retries=0)
        def parquet_round_trip(path):
            import pyarrow as pa
            import pyarrow.parquet as pq
            pq.write_table(pa.table({"id": [1, 2, 3]}), path)
            return pq.read_table(path).num_rows

        for i in range(3):
            assert ray_tpu_torch.get(read_json.remote(
                str(tmp_path / f"{i}.json"))) == (True, 2)
            assert ray_tpu_torch.get(parquet_round_trip.remote(
                str(tmp_path / f"{i}.parquet"))) == 3
    finally:
        ray_tpu_torch.shutdown()


def test_unpicklable_task_runs_in_the_driver(ray_start_regular):
    """A value the wire cannot pickle keeps its task in the driver (JAX's
    path for a value cloudpickle refuses)."""
    lock = threading.Lock()

    @ray_tpu_torch.remote
    def holds(lk):
        with lk:
            return os.getpid()

    assert ray_tpu_torch.get(holds.remote(lock)) == os.getpid()


def test_switch_off_runs_everything_in_the_driver(monkeypatch):
    monkeypatch.setenv("RAY_TPU_PROCESS_WORKERS", "0")
    ray_tpu_torch.init(num_nodes=1, resources={"CPU": 4})
    try:
        @ray_tpu_torch.remote
        def pid():
            return os.getpid()

        @ray_tpu_torch.remote
        class A:
            def pid(self):
                return os.getpid()

        assert ray_tpu_torch.get(pid.remote()) == os.getpid()
        assert ray_tpu_torch.get(A.remote().pid.remote()) == os.getpid()
    finally:
        ray_tpu_torch.shutdown()


def test_streaming_generator_and_cancel_in_a_worker(ray_start_regular):
    @ray_tpu_torch.remote
    def gen(n):
        for i in range(n):
            yield i * 10

    assert [ray_tpu_torch.get(r) for r in gen.remote(5)] == [
        0, 10, 20, 30, 40]

    @ray_tpu_torch.remote(max_retries=0)
    def forever():
        while True:
            time.sleep(0.01)

    ref = forever.remote()
    time.sleep(0.5)
    ray_tpu_torch.cancel(ref)
    with pytest.raises(exc.TaskCancelledError):
        ray_tpu_torch.get(ref, timeout=20)


def test_tensors_cross_as_host_bytes(ray_start_regular):
    """A CPU tensor argument and result cross the process through the
    device-object wire, bit for bit (bf16 included)."""
    @ray_tpu_torch.remote
    def twice(t):
        return t * 2, os.getpid()

    x = torch.arange(12, dtype=torch.bfloat16).reshape(3, 4)
    out, pid = ray_tpu_torch.get(twice.remote(x))
    assert pid != os.getpid()
    assert out.dtype == torch.bfloat16 and torch.equal(out, x * 2)


def test_shutdown_leaves_no_worker_or_template():
    ray_tpu_torch.init(num_nodes=1, resources={"CPU": 4})
    try:
        @ray_tpu_torch.remote
        def pid():
            return os.getpid()

        pids = set(ray_tpu_torch.get([pid.remote() for _ in range(8)]))
        assert os.getpid() not in pids
        assert worker_process.forkserver_pid() is not None
    finally:
        ray_tpu_torch.shutdown()
    worker_process.stop_worker_plane()
    assert worker_process.live_workers() == []
    assert worker_process.forkserver_pid() is None
    for pid in pids:
        with pytest.raises((ProcessLookupError, ChildProcessError)):
            os.kill(pid, 0)


# ---------------------------------------------------------------------------
# the by-value pickler
# ---------------------------------------------------------------------------

def _roundtrip_in_fresh_process(blob: bytes, call: str) -> str:
    """Load ``blob`` in a fresh interpreter that imports no test module and
    has no ``__main__`` of ours, then run ``call`` on the loaded object."""
    code = textwrap.dedent(f"""
        import pickle, sys
        sys.path.insert(0, {REPO!r})
        obj = pickle.loads(sys.stdin.buffer.read())
        print(repr({call}))
    """)
    out = subprocess.run([sys.executable, "-c", code], input=blob,
                         capture_output=True, timeout=60, check=True)
    return out.stdout.decode().strip()


def _make_closure():
    base = 10

    def add(x):
        return x + base
    return add


def _make_recursive():
    def fib(n):
        return n if n < 2 else fib(n - 1) + fib(n - 2)
    return fib


@pytest.mark.parametrize("case", ["lambda", "closure", "recursive"])
def test_pickler_carries_functions_by_value(case):
    fn = {"lambda": lambda x: x * 3 + len("ab"),
          "closure": _make_closure(),
          "recursive": _make_recursive()}[case]
    want = {"lambda": 11, "closure": 13, "recursive": 2}[case]
    blob = serialization.dumps(fn)
    assert _roundtrip_in_fresh_process(blob, "obj(3)") == repr(want)


def test_pickler_carries_a_main_class_by_value():
    """A class defined in ``__main__`` (a script's) reaches another process
    by value, methods, properties and class attributes included."""
    script = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {REPO!r})
        from ray_tpu_torch._private import serialization

        class Counter:
            step = 2

            def __init__(self, n):
                self.n = n

            @property
            def next(self):
                return self.n + self.step

            @staticmethod
            def name():
                return "counter"

        sys.stdout.buffer.write(serialization.dumps(Counter(5)))
    """)
    blob = subprocess.run([sys.executable, "-c", script],
                          capture_output=True, timeout=60,
                          check=True).stdout
    out = _roundtrip_in_fresh_process(
        blob, "(type(obj).__name__, obj.next, obj.name())")
    assert out == "('Counter', 7, 'counter')"


def test_pickler_refuses_what_it_cannot_carry():
    with pytest.raises(TypeError):
        serialization.dumps(threading.Lock())
    gen = (i for i in range(3))
    with pytest.raises(TypeError):
        serialization.dumps(gen)


def test_pickler_keeps_importables_by_reference():
    blob = serialization.dumps((np.add, os.path.join, exc.TaskError))
    assert pickle.loads(blob) == (np.add, os.path.join, exc.TaskError)
    # a module-level function of an importable module goes by name
    assert b"_make_closure" in serialization.dumps(_make_closure)
    assert len(serialization.dumps(_make_closure)) < 200
