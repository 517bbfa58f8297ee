"""Compiled DAGs and runtime environments on the port (a copy of
``tests/test_dag_runtime_env.py`` against ``ray_tpu_torch``)."""

import os

import pytest

import ray_tpu_torch
from ray_tpu_torch.dag import InputNode, MultiOutputNode
from ray_tpu_torch.runtime_env import RuntimeEnv


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


def test_function_dag_execute(ray_start_regular):
    @ray_tpu_torch.remote
    def double(x):
        return x * 2

    @ray_tpu_torch.remote
    def inc(x):
        return x + 1

    with InputNode() as inp:
        dag = inc.bind(double.bind(inp))
    assert ray_tpu_torch.get(dag.execute(5)) == 11
    assert ray_tpu_torch.get(dag.execute(10)) == 21


def test_actor_dag_and_compile(ray_start_regular):
    @ray_tpu_torch.remote
    class Adder:
        def __init__(self, c):
            self.c = c

        def add(self, x):
            return x + self.c

    a = Adder.remote(100)
    b = Adder.remote(1000)
    with InputNode() as inp:
        dag = b.add.bind(a.add.bind(inp))
    compiled = dag.experimental_compile()
    assert ray_tpu_torch.get(compiled.execute(5)) == 1105
    assert ray_tpu_torch.get(compiled.execute(6)) == 1106
    compiled.teardown()
    with pytest.raises(RuntimeError):
        compiled.execute(1)


def test_multi_output_dag(ray_start_regular):
    @ray_tpu_torch.remote
    def square(x):
        return x * x

    @ray_tpu_torch.remote
    def cube(x):
        return x ** 3

    with InputNode() as inp:
        dag = MultiOutputNode([square.bind(inp), cube.bind(inp)])
    refs = dag.execute(3)
    assert ray_tpu_torch.get(refs) == [9, 27]


def test_dag_diamond(ray_start_regular):
    @ray_tpu_torch.remote
    def left(x):
        return x + 1

    @ray_tpu_torch.remote
    def right(x):
        return x * 10

    @ray_tpu_torch.remote
    def join(a, b):
        return a + b

    with InputNode() as inp:
        dag = join.bind(left.bind(inp), right.bind(inp))
    assert ray_tpu_torch.get(dag.execute(4)) == 45


def test_runtime_env_env_vars(ray_start_regular):
    @ray_tpu_torch.remote(runtime_env={"env_vars": {"RTPU_TEST_VAR": "42"}})
    def read_env():
        return os.environ.get("RTPU_TEST_VAR")

    assert ray_tpu_torch.get(read_env.remote()) == "42"
    assert os.environ.get("RTPU_TEST_VAR") is None  # restored


def test_runtime_env_actor(ray_start_regular):
    @ray_tpu_torch.remote(runtime_env={"env_vars": {"RTPU_ACTOR_VAR": "x1"}})
    class EnvActor:
        def __init__(self):
            self.seen = os.environ.get("RTPU_ACTOR_VAR")

        def get(self):
            return self.seen

    a = EnvActor.remote()
    assert ray_tpu_torch.get(a.get.remote()) == "x1"


def test_runtime_env_validation():
    with pytest.raises(ValueError):
        RuntimeEnv(bogus_field=1)
    with pytest.raises(TypeError):
        RuntimeEnv(env_vars={"A": 1})
    env = RuntimeEnv(env_vars={"A": "1"}, working_dir=".")
    assert env["env_vars"] == {"A": "1"}


def test_runtime_env_py_modules(ray_start_regular, tmp_path):
    mod_dir = tmp_path / "mods"
    mod_dir.mkdir()
    (mod_dir / "rtpu_testmod.py").write_text("VALUE = 'imported'\n")

    @ray_tpu_torch.remote(runtime_env={"py_modules": [str(mod_dir)]})
    def use_module():
        import rtpu_testmod
        return rtpu_testmod.VALUE

    assert ray_tpu_torch.get(use_module.remote()) == "imported"
