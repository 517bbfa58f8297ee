"""pip runtime-env materialization (counterpart of
``ray_tpu/_private/runtime_env_pip.py``).

Reference capability: `python/ray/_private/runtime_env/pip.py` — a
per-node agent materializes ``runtime_env={"pip": [...]}`` into an
isolated environment before the worker starts. Here workers share the
driver's interpreter (or a pooled process with the same one), so the environment is materialized as an import PATH, not
a separate interpreter: ``pip install --target`` into a content-
addressed cache directory which ``apply_runtime_env`` prepends to
``sys.path`` for the task's duration.

Offline-first: ``{"pip": {"packages": [...], "find_links": DIR}}`` (or
the ``RAY_TPU_PIP_FIND_LINKS`` env var) installs with ``--no-index``
from a local wheelhouse — no network required. A bare package list
without a wheelhouse falls through to a normal index install, which in
an air-gapped environment fails with pip's own error (honest, not a
silent no-op).
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import tempfile
import threading
from typing import Any, List, Optional, Tuple

_CACHE_ROOT = os.path.join(tempfile.gettempdir(), "ray_tpu_torch", "pip_envs")
_lock = threading.Lock()


def _normalize(pip_spec: Any) -> Tuple[List[str], Optional[str]]:
    if isinstance(pip_spec, (list, tuple)):
        packages, find_links = list(pip_spec), None
    elif isinstance(pip_spec, dict):
        packages = list(pip_spec.get("packages", []))
        find_links = pip_spec.get("find_links")
    else:
        raise TypeError(
            f"runtime_env['pip'] must be a list or dict, "
            f"got {type(pip_spec).__name__}")
    find_links = find_links or os.environ.get("RAY_TPU_PIP_FIND_LINKS")
    return packages, find_links


def env_dir_for(pip_spec: Any) -> str:
    packages, find_links = _normalize(pip_spec)
    key = hashlib.sha1(json.dumps(
        [sorted(packages), find_links, sys.version_info[:2]],
        default=str).encode()).hexdigest()[:16]
    return os.path.join(_CACHE_ROOT, key)


def materialize_pip(pip_spec: Any) -> str:
    """Install the requested packages into a cached target dir; returns
    the directory to put on sys.path. Raises RuntimeError with pip's
    output on failure.

    Cross-process safe: each installer works in a private temp dir and
    atomically renames it into place — concurrent workers racing on the
    same env either win the rename or discover the winner's completed
    dir; nobody ever imports from a half-written install."""
    import shutil
    import tempfile

    packages, find_links = _normalize(pip_spec)
    env_dir = env_dir_for(pip_spec)
    marker = os.path.join(env_dir, ".ray_tpu_pip_done")
    with _lock:                       # one installer per process
        if os.path.exists(marker):
            return env_dir
        os.makedirs(_CACHE_ROOT, exist_ok=True)
        tmp = tempfile.mkdtemp(prefix=".install-", dir=_CACHE_ROOT)
        try:
            if packages:
                cmd = [sys.executable, "-m", "pip", "install",
                       "--target", tmp, "--quiet",
                       "--disable-pip-version-check",
                       "--no-warn-script-location"]
                if find_links:
                    cmd += ["--no-index", "--find-links", find_links]
                cmd += packages
                proc = subprocess.run(cmd, capture_output=True,
                                      text=True, timeout=600)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"pip runtime_env materialization failed "
                        f"(rc={proc.returncode}):\n"
                        f"{proc.stderr.strip()[-2000:]}")
            open(os.path.join(tmp, ".ray_tpu_pip_done"), "w").close()
            try:
                os.rename(tmp, env_dir)       # atomic publish
                tmp = None
            except OSError:
                # another process won the race; its completed env wins
                if not os.path.exists(marker):
                    raise
        finally:
            if tmp is not None:
                shutil.rmtree(tmp, ignore_errors=True)
        return env_dir
