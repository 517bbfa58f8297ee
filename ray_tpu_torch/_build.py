"""Build and load the port's native libraries.

On first use each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface under
``build/ray_tpu_torch/`` at the root of the checkout, keyed by a hash of the
source and the flags, and loaded with ``ctypes``. The runtime's host
libraries, ``csrc/<name>.cc`` (the shared-memory object store, the fast
lane's core and the C++ client; counterpart of
``ray_tpu/_private/native_build.py``), are
compiled the same way by ``g++``. Nothing is built when a module is
imported: the CPU tests import every module on hosts without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "ray_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "decode_attention": {
        "rt_paged_decode_attention": (
            _I, [_I, *[_P] * 8, *[_I] * 9, ctypes.c_float, _P]),
        "rt_ragged_decode_attention": (
            _I, [_I, *[_P] * 7, *[_I] * 7, ctypes.c_float, _P]),
    },
    "flash_attention": {
        "rt_flash_attention_forward": (
            _I, [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                 ctypes.c_float, _P]),
    },
}

# host C++ libraries: JAX's g++ line, and the libraries each source needs
HOST_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17", "-Wall")
HOST_LIBS = {"shm_store": ("-lpthread", "-lrt"),
             "daemon_core": ("-lpthread",),
             "cpp_client": ("-lpthread",)}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_host_libs: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("ray_tpu_torch: nvcc not found (put the CUDA "
                       "toolkit's bin/ on PATH or set CUDA_HOME)")


def _keyed_path(src: Path, flags) -> Path:
    """The library of ``src`` built with ``flags``, keyed by both."""
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    return BUILD_DIR / f"lib{src.stem}-{digest.hexdigest()[:16]}.so"


def _compile(cmd, src: Path, out: Path,
             libs=()) -> subprocess.CompletedProcess:
    """Run ``cmd`` (a compiler and its flags) on ``src`` into ``out``, the
    ``libs`` after the source, where the linker looks for them; raises with
    the compiler's errors."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([*cmd, "-o", str(tmp), str(src), *libs],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cmd[0]} failed for {src.name}:\n{proc.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent build never sees half a file
    return proc


def library_path(name: str) -> Path:
    return _keyed_path(CSRC / f"{name}.cu", NVCC_FLAGS)


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a build of this exact source exists.
    The compiler's report (registers, shared memory, spills) is kept beside
    the library as ``<lib>.log``."""
    out = library_path(name)
    if not out.exists():
        proc = _compile([find_nvcc(), *NVCC_FLAGS], CSRC / f"{name}.cu", out)
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    return out


def host_library_path(name: str) -> Path:
    return _keyed_path(CSRC / f"{name}.cc", HOST_FLAGS + HOST_LIBS[name])


def build_host(name: str) -> Path:
    """Compile ``csrc/<name>.cc`` with g++ unless a build of this exact
    source exists; raises on a compiler error."""
    out = host_library_path(name)
    if not out.exists():
        _compile(["g++", *HOST_FLAGS], CSRC / f"{name}.cc", out,
                 HOST_LIBS[name])
    return out


def load_host_library(name: str) -> Optional[ctypes.CDLL]:
    """Build (once per source hash) and load ``csrc/<name>.cc``; None where
    this host has no g++ (callers keep their pure-Python path, as JAX's
    do)."""
    with _lock:
        lib = _host_libs.get(name)
        if lib is None:
            if shutil.which("g++") is None:
                return None
            lib = ctypes.CDLL(str(build_host(name)))
            _host_libs[name] = lib
        return lib


def load_library(name: str = "decode_attention") -> ctypes.CDLL:
    """Build (once per source hash) and load ``csrc/<name>.cu``."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            for fn, (restype, argtypes) in _SIGNATURES[name].items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launcher."""
    if err != 0:
        hint = (" (invalid value: a shape or a shared-memory size the "
                "kernel does not take)" if err == 1 else "")
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError "
                           f"{err}{hint}")
