"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each kernel source compiles with nvcc for sm_90a into its own shared library
with a plain C interface, loaded with ctypes. The build happens at first use
(or through `build_kernels()`), never at import, so the CPU tests import this
module without a CUDA toolkit. All sources build in parallel, one nvcc each.
Libraries land in `build/kernels/` at the repository root (git-ignored),
named by a hash of their sources so an edited kernel is rebuilt.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
KERNEL_SOURCES = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
# ptxas resource report (registers, spills, shared memory) of the last build
BUILD_LOG: Dict[str, str] = {}


class FlashStrides(ctypes.Structure):
    _fields_ = [("b", ctypes.c_longlong), ("h", ctypes.c_longlong), ("l", ctypes.c_longlong)]


class FlashArgs(ctypes.Structure):
    """Mirror of `FlashArgs` in csrc/flash_common.cuh (field order matters)."""

    _fields_ = [
        ("q", ctypes.c_void_p),
        ("k", ctypes.c_void_p),
        ("v", ctypes.c_void_p),
        ("dout", ctypes.c_void_p),
        ("out_a", ctypes.c_void_p),
        ("out_b", ctypes.c_void_p),
        ("lse", ctypes.c_void_p),
        ("di", ctypes.c_void_p),
        ("sq", FlashStrides),
        ("sk", FlashStrides),
        ("sv", FlashStrides),
        ("sdo", FlashStrides),
        ("sa", FlashStrides),
        ("sb", FlashStrides),
        ("batch", ctypes.c_int),
        ("heads", ctypes.c_int),
        ("len", ctypes.c_int),
        ("head_dim", ctypes.c_int),
        ("sm_scale", ctypes.c_float),
        ("valid_len", ctypes.c_int),
        ("dtype", ctypes.c_int),
    ]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in (CSRC / f"{name}.cu", CSRC / "flash_common.cuh"):
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_kernels() -> float:
    """Compile every kernel library that is missing; returns wall seconds."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in KERNEL_SOURCES:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def kernel_lib(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, building all of them at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_kernels()
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(FlashArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib
