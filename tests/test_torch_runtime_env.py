"""Runtime-env materialization on the port (a copy of
``tests/test_runtime_env.py`` against ``ray_tpu_torch``): working_dir and
py_modules packaged into content-addressed pkg:// URIs and extracted in
the worker process."""

import pytest

import ray_tpu_torch


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


# ---------------------------------------------------------------------------
# working_dir / py_modules packaging (reference:
# _private/runtime_env/packaging.py — upload-to-GCS + per-node cache)
# ---------------------------------------------------------------------------

def test_working_dir_packaged_to_worker_process(ray_start_regular,
                                                tmp_path):
    """A module in working_dir imports inside a WORKER PROCESS that never
    saw the original path (content-addressed pkg:// materialization)."""
    proj = tmp_path / "proj"
    proj.mkdir()
    (proj / "my_helper_mod.py").write_text(
        "MAGIC = 'packaged-and-shipped'\n")

    @ray_tpu_torch.remote(runtime_env={"working_dir": str(proj)})
    def use_helper():
        import os
        import sys
        import my_helper_mod
        # the import came from the extracted package cache, not the
        # original path
        loaded_from = my_helper_mod.__file__
        return my_helper_mod.MAGIC, loaded_from, os.getpid()

    magic, loaded_from, pid = ray_tpu_torch.get(use_helper.remote())
    assert magic == "packaged-and-shipped"
    assert "pkg_cache" in loaded_from
    import os as _os
    assert pid != _os.getpid()   # really ran in a worker process


def test_py_modules_packaged(ray_start_regular, tmp_path):
    mod_dir = tmp_path / "libs"
    pkg = mod_dir / "shipped_pkg"
    pkg.mkdir(parents=True)
    (pkg / "__init__.py").write_text("VALUE = 41\n")

    @ray_tpu_torch.remote(runtime_env={"py_modules": [str(mod_dir)]})
    def use_pkg():
        import shipped_pkg
        return shipped_pkg.VALUE + 1

    assert ray_tpu_torch.get(use_pkg.remote()) == 42


def test_package_content_addressing(tmp_path):
    from ray_tpu_torch._private.runtime_env_packaging import (
        fetch_pkg_blob, package_directory)

    d = tmp_path / "d"
    d.mkdir()
    (d / "f.txt").write_text("hello")
    uri1 = package_directory(str(d))
    uri2 = package_directory(str(d))
    assert uri1 == uri2             # unchanged dir -> same uri, no rezip
    assert fetch_pkg_blob(uri1)
    import time
    time.sleep(0.02)
    (d / "f.txt").write_text("changed")
    uri3 = package_directory(str(d))
    assert uri3 != uri1             # content change -> new uri
