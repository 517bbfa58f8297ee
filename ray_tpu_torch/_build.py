"""Build and load the port's CUDA kernels.

On first use each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface under
``build/ray_tpu_torch/`` at the root of the checkout, keyed by a hash of the
source and the flags, and loaded with ``ctypes``. Nothing is built when a
module is imported: the CPU tests import every module on hosts without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

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

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("ray_tpu_torch: nvcc not found (put the CUDA "
                       "toolkit's bin/ on PATH or set CUDA_HOME)")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a build of this exact source exists.
    The compiler's report (registers, shared memory, spills) is kept beside
    the library as ``<lib>.log``."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)   # atomic: a concurrent build never sees half a file
    return out


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
