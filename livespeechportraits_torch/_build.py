"""Build the CUDA kernels in ``csrc/`` into one shared library and load it.

The library is compiled by nvcc at first use for ``sm_90a`` (Hopper), one
nvcc process per source, all started together, then linked, and bound
with ctypes: each entry point has a plain C signature, takes device
pointers and a CUDA stream as ``void*``, and returns its
``cudaGetLastError()``.  The file name carries a hash of the sources and
flags, so an edit rebuilds and an unchanged tree reuses the build.
``build_logs`` keeps each source's nvcc output of a build (``ptxas -v``:
registers, shared memory and spills of every kernel).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
# the git-ignored build/ of the repository; utils/compile_cache.enable moves it
DEFAULT_BUILD_DIR = BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None
build_logs: Dict[str, str] = {}


def _sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"liblsp_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def build() -> Path:
    """Compile the kernels unless a build of these exact sources exists."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in _sources():
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        objs.append(obj)
        procs.append(subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    logs = [(p.communicate()[0], p.returncode) for p in procs]
    try:
        for (log, rc), src in zip(logs, _sources()):
            build_logs[src.name] = log
            if rc != 0:
                raise RuntimeError(f"nvcc failed on {src.name} ({rc}):\n{log}")
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stdout}\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.lsp_rasterize.argtypes = [p, i, i, p, i, i, f, p]
        lib.lsp_render_input.argtypes = [p, i, p, i, p, i, p, i, i, p, i, i, i, f, p]
        lib.lsp_gru.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
        lib.lsp_lstm.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, p]
        lib.lsp_q8conv.argtypes = [p, i, p, i, i, i, i, i, i, i, i, i, i, i, p, p, p, p, p, i, i,
                                   i, p, i, i, i, i, i, i, p]
        lib.lsp_smem_optin.argtypes = []
        lib.lsp_headpose_decode.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i, f, p]
        for fn in (lib.lsp_rasterize, lib.lsp_render_input, lib.lsp_gru, lib.lsp_lstm,
                   lib.lsp_q8conv, lib.lsp_smem_optin, lib.lsp_headpose_decode):
            fn.restype = ctypes.c_int
        lib.lsp_error_string.argtypes = [i]
        lib.lsp_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by an entry point."""
    if err != 0:
        msg = library().lsp_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
