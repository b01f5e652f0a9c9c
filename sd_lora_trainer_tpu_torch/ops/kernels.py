"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each kernel source builds with nvcc for sm_90a into its own shared library
with a plain C interface, loaded with ctypes. A source compiles as one
translation unit per padded head dim (`-DFLASH_DP=<DP>`, DP in HEAD_DIM_TILES)
plus one for its exported dispatch function (csrc/flash_common.cuh); every
unit of every kernel compiles at once, one nvcc each, and each kernel's
objects are then linked into its library. The build happens at first use (or
through `build_kernels()`), never at import, so the CPU tests import this
module without a CUDA toolkit. Libraries land in `build/kernels/` at the
repository root (git-ignored), named by a hash of their sources and headers,
so an edited kernel or header is rebuilt. Beside each library lies its
ptxas report (`lib<name>-<hash>.ptxas.txt`, every unit's in turn), read back
when the library is cached.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
KERNEL_SOURCES = ("flash_fwd", "flash_bwd")
# padded head dims round_up(d, 16) the kernels are instantiated for
# (FLASH_HEAD_DIMS in csrc/flash_common.cuh)
HEAD_DIM_TILES = tuple(range(16, 257, 16))
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = (*ARCH, "-shared")

_LIBS: Dict[str, ctypes.CDLL] = {}
# ptxas resource report (registers, spills, shared memory) of each library,
# from this build or the report kept beside a cached library
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
        ("out_c", ctypes.c_void_p),
        ("sc", FlashStrides),
        ("acc", ctypes.c_void_p),
        ("sem", ctypes.c_void_p),
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
    """The library's path, named by a hash of its source, every header under
    csrc/ (a shared header's edit rebuilds each kernel) and the flags."""
    h = hashlib.sha256()
    for src in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    h.update(" ".join(map(str, HEAD_DIM_TILES)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _report_path(lib: Path) -> Path:
    return lib.with_suffix(".ptxas.txt")


def _units(name: str):
    """(label, nvcc defines) of each translation unit of one kernel source."""
    return [(f"dp{dp}", [f"-DFLASH_DP={dp}"]) for dp in HEAD_DIM_TILES] + [("dispatch", [])]


def build_kernels() -> float:
    """Compile every kernel library that is missing; returns wall seconds.

    Every translation unit of every missing library starts at once (one nvcc
    each); a library is linked from its objects once all of them are built.
    """
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in KERNEL_SOURCES:
        out = _lib_path(name)
        if out.exists():
            report = _report_path(out)
            if report.exists():
                BUILD_LOG[name] = report.read_text()
            continue
        objdir = out.with_suffix(f".{os.getpid()}.obj")
        objdir.mkdir(exist_ok=True)
        units = []
        for label, defines in _units(name):
            obj = objdir / f"{label}.o"
            cmd = [_nvcc(), *NVCC_FLAGS, *defines, "-c", "-o", str(obj), str(CSRC / f"{name}.cu")]
            units.append((label, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        jobs[name] = (units, objdir, out)
    failed = []
    for name, (units, objdir, out) in jobs.items():
        report, ok = [], True
        for label, _, proc in units:
            log, _ = proc.communicate()
            report.append(f"== {name}.cu {label}\n{log}")
            if proc.returncode != 0:
                ok = False
                failed.append(f"{name} ({label}):\n{log}")
        BUILD_LOG[name] = "".join(report)
        if ok:
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            link = subprocess.run([_nvcc(), *LINK_FLAGS, "-o", str(tmp),
                                   *(str(obj) for _, obj, _ in units)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if link.returncode != 0:
                failed.append(f"{name} (link):\n{link.stdout}")
            else:
                _report_path(out).write_text(BUILD_LOG[name])
                os.replace(tmp, out)
        shutil.rmtree(objdir, ignore_errors=True)
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


def ptxas_summary(report: str) -> list:
    """'kernel<dtype, DP>: N registers, S bytes spilled' for each bf16 entry
    function in an `nvcc -Xptxas -v` report (the fp32 instances match them),
    by kernel name and then DP. For a kernel that hands registers to its
    consumers with setmaxnreg, N is the launch's budget, not the consumers'."""
    out, entry, spill = [], None, "0"
    for line in report.splitlines():
        m = re.search(r"entry function '_Z\d+(\w+?)I(13__nv_bfloat16|f)Li(\d+)E", line)
        if m:
            entry = (m.group(1), int(m.group(3))) if m.group(2) != "f" else None
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out.append((*entry, f"{m.group(1)} registers, {spill} bytes spilled"))
        if m:
            entry, spill = None, "0"
    return [f"{name}<bf16, {dp}>: {text}" for name, dp, text in sorted(out)]
