"""pip runtime-env materialization on the port (a copy of
``tests/test_runtime_env_pip.py`` against ``ray_tpu_torch``): tasks
declaring ``runtime_env={"pip": ...}`` run with those packages importable,
installed from an offline wheelhouse the test rolls by hand (no network,
no build backend).
"""

import os
import zipfile

import pytest

import ray_tpu_torch
from ray_tpu_torch._private.runtime_env_pip import env_dir_for, materialize_pip


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


def _make_wheel(wheelhouse: str, name: str, version: str,
                source: str) -> str:
    """Hand-roll a minimal pure-python wheel (a wheel is a zip with
    dist-info metadata) so the test needs no network and no build
    backend."""
    os.makedirs(wheelhouse, exist_ok=True)
    whl = os.path.join(wheelhouse, f"{name}-{version}-py3-none-any.whl")
    info = f"{name}-{version}.dist-info"
    with zipfile.ZipFile(whl, "w") as z:
        z.writestr(f"{name}/__init__.py", source)
        z.writestr(f"{info}/METADATA",
                   f"Metadata-Version: 2.1\nName: {name}\n"
                   f"Version: {version}\n")
        z.writestr(f"{info}/WHEEL",
                   "Wheel-Version: 1.0\nGenerator: test\nRoot-Is-Purelib:"
                   " true\nTag: py3-none-any\n")
        z.writestr(f"{info}/RECORD", "")
    return whl


@pytest.fixture
def wheelhouse(tmp_path):
    wh = str(tmp_path / "wheels")
    _make_wheel(wh, "rtpu_demo_pkg", "1.0",
                "MAGIC = 'from-the-wheel'\n\n"
                "def double(x):\n    return x * 2\n")
    return wh


def test_materialize_pip_offline(wheelhouse):
    spec = {"packages": ["rtpu_demo_pkg"], "find_links": wheelhouse}
    env_dir = materialize_pip(spec)
    assert os.path.isdir(os.path.join(env_dir, "rtpu_demo_pkg"))
    # cached: second call is a no-op returning the same dir
    assert materialize_pip(spec) == env_dir == env_dir_for(spec)


def test_task_imports_pip_package(ray_start_regular, wheelhouse):
    """A task declaring the pip env imports the wheel's package; the
    driver process does NOT have it importable outside the env."""
    with pytest.raises(ImportError):
        import rtpu_demo_pkg  # noqa: F401

    @ray_tpu_torch.remote(runtime_env={"pip": {
        "packages": ["rtpu_demo_pkg"], "find_links": wheelhouse}})
    def use_pkg(x):
        import rtpu_demo_pkg
        return rtpu_demo_pkg.MAGIC, rtpu_demo_pkg.double(x)

    magic, doubled = ray_tpu_torch.get(use_pkg.remote(21), timeout=120)
    assert magic == "from-the-wheel"
    assert doubled == 42


def test_pip_failure_is_loud(ray_start_regular, tmp_path):
    """A package that cannot be materialized fails the task with pip's
    error — never a silent no-op."""
    @ray_tpu_torch.remote(runtime_env={"pip": {
        "packages": ["definitely-not-a-real-pkg-xyz"],
        "find_links": str(tmp_path / "empty")}})
    def f():
        return 1

    with pytest.raises(Exception, match="pip runtime_env"):
        ray_tpu_torch.get(f.remote(), timeout=120)


def test_uv_spec_materializes_like_pip(ray_start_regular, wheelhouse):
    """uv package specs ride the same installer (reference: uv.py
    agent; no uv binary in this image)."""
    @ray_tpu_torch.remote(runtime_env={"uv": {
        "packages": ["rtpu_demo_pkg"], "find_links": wheelhouse}})
    def use():
        import rtpu_demo_pkg
        return rtpu_demo_pkg.MAGIC

    assert ray_tpu_torch.get(use.remote(), timeout=120) == "from-the-wheel"
