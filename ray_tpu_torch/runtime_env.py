"""Runtime environments (counterpart of ``ray_tpu/runtime_env.py``).

In this single-image runtime the meaningful fields are ``env_vars``
(applied around execution), ``working_dir``/``py_modules`` (paths put on
sys.path), and validation of the full reference schema. Package
materialization (pip/conda/container) requires per-process workers and
network; those fields validate and no-op with a warning. ``pip`` installs
from a local wheelhouse (``_private/runtime_env_pip.py``).
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import warnings
from typing import Any, Dict, List, Optional

_KNOWN_FIELDS = {
    "env_vars", "working_dir", "py_modules", "pip", "uv", "conda",
    "container", "image_uri", "excludes", "config",
}

_env_lock = threading.RLock()


class RuntimeEnv(dict):
    """Validated runtime-env dict (reference: RuntimeEnv class)."""

    def __init__(self, **kwargs):
        for key in kwargs:
            if key not in _KNOWN_FIELDS:
                raise ValueError(
                    f"unknown runtime_env field {key!r} "
                    f"(known: {sorted(_KNOWN_FIELDS)})")
        env_vars = kwargs.get("env_vars")
        if env_vars is not None:
            if not isinstance(env_vars, dict) or not all(
                    isinstance(k, str) and isinstance(v, str)
                    for k, v in env_vars.items()):
                raise TypeError("env_vars must be Dict[str, str]")
        super().__init__(**kwargs)


@contextlib.contextmanager
def apply_runtime_env(runtime_env: Optional[Dict[str, Any]]):
    """Apply env_vars/py_modules for the duration of a task execution.

    Process-global env mutation is serialized under a lock; the reference
    applies env at worker-process start (`worker_pool.h` runtime-env hash
    keying) — virtual in-process workers approximate it per-task.
    """
    if not runtime_env:
        yield
        return
    if any(runtime_env.get(k) for k in
           ("conda", "container", "image_uri")):
        warnings.warn(
            "runtime_env materialization for conda/container is a "
            "no-op in the single-image runtime (pip and uv ARE "
            "materialized — see _private/runtime_env_pip.py)",
            stacklevel=2)
    env_vars: Dict[str, str] = runtime_env.get("env_vars") or {}

    def _local(p: str) -> str:
        # pkg:// URIs (packaged working_dir/py_modules) materialize from
        # the content-addressed table / node cache
        if isinstance(p, str) and p.startswith("pkg://"):
            from ray_tpu_torch._private.runtime_env_packaging import \
                resolve_local
            return resolve_local(p)
        return os.path.abspath(p)

    paths: List[str] = []
    wd = runtime_env.get("working_dir")
    if wd:
        paths.append(_local(wd))
    for mod in runtime_env.get("py_modules") or []:
        paths.append(_local(mod))
    pkgs = runtime_env.get("pip") or runtime_env.get("uv")
    if pkgs:
        # materialized package env = an import path (same interpreter;
        # the reference swaps worker interpreters instead — pip.py/
        # uv.py agents). uv specs are the same package list and
        # materialize through the same installer.
        from ray_tpu_torch._private.runtime_env_pip import materialize_pip
        paths.append(materialize_pip(pkgs))

    with _env_lock:
        saved = {k: os.environ.get(k) for k in env_vars}
        os.environ.update(env_vars)
        added = [p for p in paths if p not in sys.path]
        for p in added:
            sys.path.insert(0, p)
    try:
        yield
    finally:
        with _env_lock:
            for k, old in saved.items():
                if old is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = old
            for p in added:
                try:
                    sys.path.remove(p)
                except ValueError:
                    pass
