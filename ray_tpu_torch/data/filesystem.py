"""One filesystem seam for every datasource (counterpart of
``ray_tpu/data/filesystem.py``, the same code).

Reference capability: the reference's 41 datasources all resolve paths
through one ``pyarrow.fs``-shaped abstraction
(``python/ray/data/read_api.py`` / ``datasource/path_util.py``); readers
and writers never touch ``open()`` directly. Same seam here: a tiny
protocol (open/list/exists/makedirs) with a local implementation, scheme
dispatch (``s3://``, ``gs://`` raise an actionable error in this
zero-egress build — the seam is where a cloud impl plugs in), and glob/
directory expansion shared by all ``read_*``/``write_*`` APIs.
"""

from __future__ import annotations

import glob as _glob
import os
from typing import IO, List, Sequence, Union

Paths = Union[str, Sequence[str]]


class FileSystem:
    """Minimal filesystem protocol (pyarrow.fs-shaped)."""

    scheme = ""

    def open_input(self, path: str) -> IO[bytes]:
        raise NotImplementedError

    def open_output(self, path: str) -> IO[bytes]:
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def isdir(self, path: str) -> bool:
        raise NotImplementedError

    def listdir(self, path: str) -> List[str]:
        raise NotImplementedError

    def glob(self, pattern: str) -> List[str]:
        raise NotImplementedError

    def makedirs(self, path: str) -> None:
        raise NotImplementedError


class LocalFileSystem(FileSystem):
    scheme = "file"

    def open_input(self, path: str) -> IO[bytes]:
        return open(path, "rb")

    def open_output(self, path: str) -> IO[bytes]:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        return open(path, "wb")

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def isdir(self, path: str) -> bool:
        return os.path.isdir(path)

    def listdir(self, path: str) -> List[str]:
        return sorted(os.path.join(path, f) for f in os.listdir(path))

    def glob(self, pattern: str) -> List[str]:
        return sorted(_glob.glob(pattern))

    def makedirs(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)


_CLOUD_SCHEMES = {
    "s3": "S3 (install/enable an S3 filesystem implementation and "
          "register it with register_filesystem('s3', fs))",
    "gs": "GCS (register_filesystem('gs', fs))",
    "gcs": "GCS (register_filesystem('gcs', fs))",
    "hdfs": "HDFS (register_filesystem('hdfs', fs))",
}

_REGISTRY = {"": LocalFileSystem(), "file": LocalFileSystem()}


def register_filesystem(scheme: str, fs: FileSystem) -> None:
    """Plug in a filesystem implementation for a URI scheme."""
    _REGISTRY[scheme] = fs


def resolve_filesystem(path: str) -> "tuple[FileSystem, str]":
    """(filesystem, path-without-scheme) for one path."""
    if "://" in path:
        scheme, rest = path.split("://", 1)
        fs = _REGISTRY.get(scheme)
        if fs is not None:
            return fs, rest
        hint = _CLOUD_SCHEMES.get(
            scheme, f"unknown scheme {scheme!r}")
        raise NotImplementedError(
            f"no filesystem registered for {scheme}:// — {hint}")
    return _REGISTRY[""], path


def expand_paths(paths: Paths, suffix: str = "") -> List[str]:
    """Expand files/dirs/globs into a sorted file list (scheme-aware).
    Results KEEP their URI scheme so downstream readers resolve to the
    same filesystem."""
    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        scheme = p.split("://", 1)[0] + "://" if "://" in p else ""
        fs, local = resolve_filesystem(p)
        if fs.exists(local) and fs.isdir(local):
            out.extend(scheme + f for f in fs.listdir(local)
                       if not suffix or f.endswith(suffix))
        elif "*" in local:
            out.extend(scheme + f for f in fs.glob(local))
        else:
            out.append(p)
    return out
