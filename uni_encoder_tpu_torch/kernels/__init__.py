"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface. It is compiled by `nvcc` for
Hopper (`sm_90a`) into `build/kernels/lib<name>.so` at the repository root the
first time a kernel is needed (or when the source is newer than the library),
and loaded with `ctypes`. Nothing here runs at import time, so the package
imports on machines without `nvcc` or a GPU; there, only the plain PyTorch
versions beside each kernel can run.

`build()` compiles several sources at once, one `nvcc` process per source,
all started together.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "build", "kernels"
)
SOURCES = ("fused_postprocess", "ms_deform_attn", "ms_deform_attn_backward", "neighborhood_attention",
           "neighborhood_attention_backward")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels can only be built where the CUDA toolkit is installed")
    return path


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def build_log_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"{name}.log")


def _stale(name: str) -> bool:
    lib = library_path(name)
    src = os.path.join(CSRC, f"{name}.cu")
    return not os.path.exists(lib) or os.path.getmtime(lib) < os.path.getmtime(src)


def build(names: Iterable[str] = SOURCES, force: bool = False) -> Dict[str, float]:
    """Compile the named sources in parallel; return seconds per source
    (0.0 for a library that was already up to date)."""
    names = list(names)
    todo = [n for n in names if force or _stale(n)]
    times = {n: 0.0 for n in names}
    if not todo:
        return times
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        tmp = library_path(n) + f".tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        times[n] = time.perf_counter() - t0
        with open(build_log_path(n), "wb") as f:
            f.write(out)
        if proc.returncode != 0:
            failed.append(f"{n} (nvcc exit {proc.returncode}):\n{out.decode(errors='replace')}")
            continue
        os.replace(tmp, library_path(n))
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return times


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, building it first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(library_path(name))
        _LIBS[name] = lib
    return lib
