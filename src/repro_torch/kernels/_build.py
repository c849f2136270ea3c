"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one process
per source, all started together), then linked into one shared library
with a plain C interface, loaded with ``ctypes``.  The library lands in
``build/`` at the repository root under a name carrying the hash of the
sources, so an unchanged tree loads the existing build and an edited one
rebuilds.  Nothing is built at import: the first kernel launch calls
``library()``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C entry points and their argument types (every pointer and the stream
# as c_void_p: anything else would cut a 64-bit address)
SIGNATURES = {
    "rt_flash_decode_paged": [_P] * 8 + [_I] * 8 + [_F, _I, _I, _P],
    "rt_flash_decode": [_P] * 7 + [_I] * 5 + [_F, _I, _I, _P],
    "rt_flash_attention": [_P] * 4 + [_I] * 8 + [_F, _I, _P],
    "rt_decode_view_attend": [_P] * 7 + [_I] * 6 + [_F, _I, _I, _P],
    "rt_greedy_sample": [_P, _P, _I, _I, _I, _P],
    "rt_gumbel_sample": [_P] * 3 + [_I] * 5 + [_F, _P],
    "rt_fused_sgd_update": [_P] * 3 + [_I, _P, _F, _P] + [_I] * 3
    + [_F, _F, _I, _I, _P],
    "rt_lars_norms": [_P] * 3 + [_I, _P, _I, _I, _I, _P],
    "rt_lars_trust": [_P] * 3 + [_I, _P, _P, _F, _F, _F, _P],
    "rt_slot_gather": [_P, _P, _P, _I, _P, _I, _I, _I, _L, _I, _I, _P],
    "rt_slot_scatter": [_P, _P, _P, _I, _P, _I, _I, _I, _L, _I, _P],
    "rt_ssd_chunk": [_P] * 7 + [_I] * 6 + [_P],
    "rt_mla_decode_views": [_P] * 4 + [_I] + [_P] * 4 + [_I] * 3
    + [_F, _I, _I, _P],
    "rt_mla_decode_paged": [_P] * 5 + [_I, _I] + [_P] * 4 + [_I] * 3
    + [_F, _I, _I, _P],
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit to build")


def sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                     r"(\w+)\s*\(")


def kernel_names():
    """The ``__global__`` functions of the sources, sorted: the names a
    profiler shows for the port's own kernels."""
    return sorted({m.group(1) for p in sources()
                   for m in _GLOBAL.finditer(p.read_text())})


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile (if the sources changed) and return the library's path."""
    out = BUILD_DIR / f"repro_torch_kernels_{source_hash()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    cus = sorted(CSRC.glob("*.cu"))
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for cu in cus:
            obj = Path(tmp) / (cu.stem + ".o")
            objs.append(obj)
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(cu), "-o", str(obj)]
            if verbose:
                cmd.insert(1, "-Xptxas=-v")
            procs.append((cu, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        errors = []
        for cu, proc in procs:
            log, _ = proc.communicate()
            if verbose and log:
                print(f"[nvcc {cu.name}]\n{log}", flush=True)
            if proc.returncode:
                errors.append(f"{cu.name}:\n{log}")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        tmp_so = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o",
             str(tmp_so)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        if link.returncode:
            raise RuntimeError("nvcc link failed:\n" + link.stdout)
        os.replace(tmp_so, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error at launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {rc})")
