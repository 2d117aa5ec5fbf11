"""The host codec: a C++ decoder of the compressed frame transfers.

Counterpart of ``livespeechportraits_tpu/native`` with its own copy of
``framecodec.cpp``, less JAX's standalone I420 conversion (the yuv420
transfer converts in torch, ``compress.i420_to_rgb``: PERF.md).  The source is compiled by g++ on first use into the
repo's git-ignored ``build/`` directory, under a hash of the source, the
flags and the CPU that ``-march=native`` resolves to, and bound with ctypes
(which releases the GIL for the whole decode, so a decode thread overlaps
the device and the pushing thread).  A failed build raises with g++'s output:
nothing falls back to the numpy decoders, which ``pipeline/compress.py``
keeps by name as the tests' reference.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().with_name("framecodec.cpp")
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build"
# -ffp-contract=off: no multiply-add is fused, so each float expression
# rounds as numpy's does (the decoders' I420 conversion is bitwise equal to it)
CXXFLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-std=c++17", "-fPIC", "-shared")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _native_arch() -> str:
    """What -march=native resolves to on this host: a build for one CPU is
    not loaded on another that shares the build directory."""
    out = subprocess.run(["g++", *CXXFLAGS[:2], "-Q", "--help=target"],
                         capture_output=True, text=True, check=True).stdout
    return next((line.split()[-1] for line in out.splitlines()
                 if line.strip().startswith("-march=")), "unknown")


def library_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes() + " ".join(CXXFLAGS).encode()
                       + _native_arch().encode())
    return BUILD_DIR / f"libframecodec_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the codec unless a build of this source, these flags and this
    CPU exists; raises with g++'s output on failure."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run(["g++", *CXXFLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {SRC.name} ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic against a concurrent build
    return out


def library() -> ctypes.CDLL:
    """The loaded codec (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            u8p = ctypes.POINTER(ctypes.c_uint8)
            i8p = ctypes.POINTER(ctypes.c_int8)
            f32p = ctypes.POINTER(ctypes.c_float)
            ci = ctypes.c_int
            lib.lsp_decode_p4.argtypes = [u8p, ci, ci, ci, ci, ci, f32p, f32p, u8p, u8p]
            lib.lsp_decode_p4.restype = None
            lib.lsp_decode_zonal.argtypes = [i8p, ci, ci, ci, ci, ci, f32p, f32p, u8p, u8p]
            lib.lsp_decode_zonal.restype = None
            lib.lsp_decode_p4e.argtypes = [u8p, ctypes.c_long, ci, ci, ci, ci, ci,
                                           f32p, f32p, u8p, u8p]
            lib.lsp_decode_p4e.restype = ctypes.c_long
            _lib = lib
    return _lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _basis(b: np.ndarray, k: int) -> np.ndarray:
    b = np.ascontiguousarray(b, np.float32)
    if b.shape != (k, 64):
        raise ValueError(f"basis has shape {b.shape}, expected ({k}, 64)")
    return b


def _check_frame(h: int, w: int, k_y: int, k_c: int) -> None:
    if h % 16 or w % 16:
        raise ValueError(f"frames of {h}x{w}: the codes need multiples of 16")
    if not (1 <= k_y <= 64 and 1 <= k_c <= 64):
        raise ValueError(f"k_y={k_y}, k_c={k_c} must lie in [1, 64]")


def _decode_fixed(fn, ctype, packed: np.ndarray, seg_bytes: int, h: int, w: int,
                  k_y: int, k_c: int, basis_y: np.ndarray, basis_c: np.ndarray) -> np.ndarray:
    _check_frame(h, w, k_y, k_c)
    if packed.ndim != 2 or packed.shape[1] != seg_bytes:
        raise ValueError(f"code has shape {packed.shape}, expected [B, {seg_bytes}]")
    by, bc = _basis(basis_y, k_y), _basis(basis_c, k_c)
    B = packed.shape[0]
    out = np.empty((B, h, w, 3), np.uint8)
    scratch = np.empty(h * w + 2 * (h // 2) * (w // 2), np.uint8)
    fn(_ptr(packed, ctype), B, h, w, k_y, k_c, _ptr(by, ctypes.c_float),
       _ptr(bc, ctypes.c_float), _ptr(scratch, ctypes.c_uint8), _ptr(out, ctypes.c_uint8))
    return out


def decode_p4(packed: np.ndarray, h: int, w: int, k_y: int, k_c: int,
              basis_y: np.ndarray, basis_c: np.ndarray) -> np.ndarray:
    """pack4 code [B, bytes] uint8 -> [B, h, w, 3] uint8 RGB."""
    if (k_y - 1) % 2 or (k_c - 1) % 2:
        raise ValueError(f"pack4 K must be odd, got k_y={k_y}, k_c={k_c}")

    def seg(nb: int, k: int) -> int:
        return nb + nb // 2 + nb * (k - 1) // 2

    nb_y, nb_c = (h // 8) * (w // 8), (h // 16) * (w // 16)
    packed = np.ascontiguousarray(packed, np.uint8)
    return _decode_fixed(library().lsp_decode_p4, ctypes.c_uint8, packed,
                         seg(nb_y, k_y) + 2 * seg(nb_c, k_c), h, w, k_y, k_c, basis_y, basis_c)


def decode_zonal(packed: np.ndarray, h: int, w: int, k_y: int, k_c: int,
                 basis_y: np.ndarray, basis_c: np.ndarray) -> np.ndarray:
    """int8 zonal code [B, bytes] -> [B, h, w, 3] uint8 RGB."""
    nb_y, nb_c = (h // 8) * (w // 8), (h // 16) * (w // 16)
    packed = np.ascontiguousarray(packed).view(np.int8)
    return _decode_fixed(library().lsp_decode_zonal, ctypes.c_int8, packed,
                         nb_y * k_y + 2 * nb_c * k_c, h, w, k_y, k_c, basis_y, basis_c)


def decode_p4e(flat: np.ndarray, B: int, h: int, w: int, k_y: int, k_c: int,
               basis_y: np.ndarray, basis_c: np.ndarray):
    """pack4e stream prefix [n] uint8 -> ([B, h, w, 3] uint8 RGB, bytes
    consumed).  Raises IndexError when the prefix is truncated (the stream
    is self-delimiting; the caller fetches a longer prefix)."""
    _check_frame(h, w, k_y, k_c)
    if k_y > 15 or k_c > 15:
        raise ValueError(f"pack4e K must be <= 15, got k_y={k_y}, k_c={k_c}")
    flat = np.ascontiguousarray(flat, np.uint8).reshape(-1)
    by, bc = _basis(basis_y, k_y), _basis(basis_c, k_c)
    out = np.empty((B, h, w, 3), np.uint8)
    scratch = np.empty(h * w + 2 * (h // 2) * (w // 2), np.uint8)
    consumed = library().lsp_decode_p4e(
        _ptr(flat, ctypes.c_uint8), ctypes.c_long(flat.shape[0]), B, h, w, k_y, k_c,
        _ptr(by, ctypes.c_float), _ptr(bc, ctypes.c_float),
        _ptr(scratch, ctypes.c_uint8), _ptr(out, ctypes.c_uint8))
    if consumed < 0:
        raise IndexError("pack4e stream truncated")
    return out, int(consumed)
