"""Runtime-env package materialization (working_dir / py_modules;
counterpart of ``ray_tpu/_private/runtime_env_packaging.py``).

Reference capability: ``_private/runtime_env/{packaging,working_dir,
py_modules}.py`` — the driver zips the directory, publishes it under a
content-addressed ``gcs://`` URI, and every worker downloads + extracts
it once into a node-local cache before running tasks.

Same shape here: the driver packages a directory into an in-memory zip
registered in a content-addressed table (the function-table pattern);
workers fetch the blob through the owner core-op channel
(``fetch_runtime_pkg``) and extract into ``<tmp>/ray_tpu_torch/pkg_cache/<hash>``
— so a ``runtime_env={"working_dir": ...}`` works even when the worker
process (or daemon host) never saw the original path.
"""

from __future__ import annotations

import hashlib
import io
import os
import tempfile
import threading
import zipfile
from typing import Dict, List, Optional, Tuple

PKG_SCHEME = "pkg://"
_CACHE_ROOT = os.path.join(tempfile.gettempdir(), "ray_tpu_torch", "pkg_cache")

_TABLE: Dict[str, bytes] = {}
_TABLE_LOCK = threading.Lock()
_DIR_MEMO: Dict[Tuple[str, float], str] = {}   # (path, mtime) -> uri


def _should_exclude(rel: str, excludes: List[str]) -> bool:
    import fnmatch

    return any(fnmatch.fnmatch(rel, pat) or fnmatch.fnmatch(
        os.path.basename(rel), pat) for pat in excludes)


def package_directory(path: str,
                      excludes: Optional[List[str]] = None) -> str:
    """Zip ``path`` and register the blob; returns its ``pkg://`` URI.
    Content-addressed: identical trees share one entry; an unchanged
    directory (same newest mtime) skips re-zipping."""
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        raise ValueError(f"runtime_env directory not found: {path}")
    excludes = list(excludes or []) + ["__pycache__", "*.pyc"]
    newest = os.path.getmtime(path)
    entries = []
    for root, dirs, files in os.walk(path):
        dirs[:] = [d for d in dirs if not _should_exclude(
            os.path.relpath(os.path.join(root, d), path), excludes)]
        # directory mtimes catch DELETIONS inside subdirs (removing a
        # file bumps only its parent dir's mtime)
        newest = max(newest, os.path.getmtime(root))
        for f in sorted(files):
            full = os.path.join(root, f)
            rel = os.path.relpath(full, path)
            if _should_exclude(rel, excludes):
                continue
            entries.append((rel, full))
            newest = max(newest, os.path.getmtime(full))
    memo_key = (path, newest)
    cached = _DIR_MEMO.get(memo_key)
    if cached is not None:
        return cached

    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for rel, full in entries:
            zf.write(full, rel)
    blob = buf.getvalue()
    digest = hashlib.sha1(blob).hexdigest()
    uri = PKG_SCHEME + digest
    with _TABLE_LOCK:
        _TABLE[digest] = blob
    _DIR_MEMO[memo_key] = uri
    return uri


def fetch_pkg_blob(uri: str) -> bytes:
    """Driver-side lookup (served to workers via the core-op channel)."""
    digest = uri[len(PKG_SCHEME):]
    with _TABLE_LOCK:
        blob = _TABLE.get(digest)
    if blob is None:
        raise KeyError(f"runtime-env package {uri} not in table")
    return blob


def cached_dir(uri: str) -> Optional[str]:
    """Already-extracted local directory for ``uri``, if any."""
    digest = uri[len(PKG_SCHEME):]
    target = os.path.join(_CACHE_ROOT, digest)
    return target if os.path.isdir(target) else None


def extract_blob(uri: str, blob: bytes) -> str:
    """Extract into the node-local cache (idempotent, atomic rename)."""
    digest = uri[len(PKG_SCHEME):]
    target = os.path.join(_CACHE_ROOT, digest)
    if os.path.isdir(target):
        return target
    tmp = target + f".tmp{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    with zipfile.ZipFile(io.BytesIO(blob)) as zf:
        zf.extractall(tmp)
    try:
        os.rename(tmp, target)
    except OSError:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)  # concurrent extractor won
    return target


def resolve_local(uri: str) -> str:
    """pkg:// URI -> local dir, for processes holding the table (driver)
    or with a warm cache (workers resolve via their host channel first)."""
    local = cached_dir(uri)
    if local is not None:
        return local
    return extract_blob(uri, fetch_pkg_blob(uri))


_PREPARED: Dict[int, Tuple[tuple, dict, float]] = {}
_PREPARED_TTL = 0.25   # seconds between tree re-validations


def _job_default_runtime_env():
    from ray_tpu_torch._private import worker

    rt = worker.global_runtime()
    return getattr(rt, "_job_default_env", None)


def prepare_runtime_env(runtime_env):
    """Driver-side, at submission: package directory-valued
    working_dir/py_modules into pkg:// URIs so the env materializes on
    any worker anywhere (reference: upload_package_to_gcs).

    Submission hot path: the prepared result is memoized per
    runtime_env dict (a decorator's options dict is stable across
    .remote() calls) — but only for ``_PREPARED_TTL``: edits to a
    working_dir between submissions must be re-packaged, and only the
    tree walk in ``package_directory`` (which fingerprints by newest
    mtime and skips re-zipping when unchanged) can see them. The TTL
    amortizes that walk over hot submission loops without letting
    workers run stale code for the process lifetime."""
    if not runtime_env:
        # job-level default (reference: JobConfig.runtime_env applied
        # when a task/actor declares none — job_config.py serialize ->
        # worker.py connect)
        runtime_env = _job_default_runtime_env()
    if not runtime_env:
        return runtime_env
    import time as _time

    fingerprint = (runtime_env.get("working_dir"),
                   tuple(runtime_env.get("py_modules") or ()))
    now = _time.monotonic()
    cached = _PREPARED.get(id(runtime_env))
    if (cached is not None and cached[0] == fingerprint
            and now - cached[2] < _PREPARED_TTL):
        return cached[1]
    out = dict(runtime_env)
    excludes = out.get("excludes") or []
    wd = out.get("working_dir")
    if wd and not str(wd).startswith(PKG_SCHEME) and os.path.isdir(wd):
        out["working_dir"] = package_directory(wd, excludes)
    mods = out.get("py_modules")
    if mods:
        out["py_modules"] = [
            package_directory(m, excludes)
            if not str(m).startswith(PKG_SCHEME) and os.path.isdir(m)
            else m for m in mods]
    if len(_PREPARED) > 256:
        _PREPARED.clear()   # unbounded decorator churn backstop
    _PREPARED[id(runtime_env)] = (fingerprint, out, now)
    return out
