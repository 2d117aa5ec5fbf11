"""The edge-map rasteriser and the renderer's input stage as one CUDA kernel (K1).

Counterpart of ``livespeechportraits_tpu/ops/rasterize_pallas.py`` and of
the render loop's input around it.  The kernel (``csrc/rasterize.cu``) has
two entry points, each bitwise equal to its plain twin in
``ops/rasterize.py``:

- ``rasterize_segments``: segment table -> f32 edge planes (the Pallas
  kernel's function);
- ``render_input``: landmarks, shoulders and the candidate stack -> the
  U-Net's NHWC input [T, H, W, 13] in the compute dtype, with the segment
  table built on chip from the index pairs of ``segment_pairs``, which
  reach each device once; without the candidates, the edge-only form
  [T, H, W, 1] that the split_cand renderer reads (one launch as well).

Dispatch is on the tensor's device: a CPU tensor takes the twin, a CUDA
tensor the kernel, anything else raises.  ``LAUNCHES`` counts kernel
launches.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from livespeechportraits_torch import _build
from livespeechportraits_torch.ops import rasterize

Tensor = torch.Tensor

# The kernel keeps one frame's segment list in shared memory.
MAX_SEGMENTS = 128
# A thread rasterises 8 consecutive pixels of one row.
WIDTH_MULTIPLE = 8
N_LANDMARKS = 73

LAUNCHES = 0

_PAIRS: Dict[Tuple[str, int], Tensor] = {}


def segment_pairs(device, n_shoulders: int) -> Tensor:
    """[S, 2] int32 point indices of every segment on ``device``: the pairs
    of ``face_segments()``, then those of ``shoulder_segments(n_shoulders)``
    offset by the 73 landmarks.  Built once per (device, n_shoulders): the
    upload is a synchronizing copy, so the render loop never makes one."""
    key = (str(torch.device(device)), int(n_shoulders))
    if key not in _PAIRS:
        pairs = np.concatenate([rasterize.face_segments(),
                                rasterize.shoulder_segments(n_shoulders) + N_LANDMARKS])
        _PAIRS[key] = torch.as_tensor(pairs.astype(np.int32), device=device)
    return _PAIRS[key]


def _check_cuda(t: Tensor, name: str, dtypes=(torch.float32,)) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_width(width: int) -> None:
    if width % WIDTH_MULTIPLE:
        raise ValueError(f"the kernel needs a width that is a multiple of {WIDTH_MULTIPLE}, "
                         f"got {width}")


def _stream(t: Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def rasterize_segments(segments: Tensor, height: int = 512, width: int = 512,
                       radius: float = 1.5) -> Tensor:
    """segments [T, S, 4] f32 (ax, ay, bx, by), S <= 128 -> [T, H, W] f32.
    On the card the width must be a multiple of 8."""
    global LAUNCHES
    if segments.device.type == "cpu":
        return rasterize.rasterize_segments(segments, height, width, radius)
    _check_cuda(segments, "segments")
    if segments.dim() != 3 or segments.shape[2] != 4:
        raise ValueError(f"segments must be [T, S, 4], got {tuple(segments.shape)}")
    if segments.shape[1] > MAX_SEGMENTS:
        raise ValueError(f"{segments.shape[1]} segments exceed the kernel's {MAX_SEGMENTS}")
    if segments.data_ptr() % 16:
        raise ValueError("segments must be 16-byte aligned")
    _check_width(width)
    T, S, _ = segments.shape
    out = torch.empty(T, height, width, device=segments.device, dtype=torch.float32)
    lib = _build.library()
    with torch.cuda.device(segments.device):
        err = lib.lsp_rasterize(segments.data_ptr(), T, S, out.data_ptr(), height, width,
                                radius, _stream(segments))
    _build.check(err, "lsp_rasterize")
    LAUNCHES += 1
    return out


def render_input(landmarks: Tensor, shoulders: Optional[Tensor], cand: Optional[Tensor] = None,
                 size: Tuple[int, int] = (512, 512),
                 dtype: Optional[torch.dtype] = None) -> Tensor:
    """[T, 73, 2] landmarks (+ [T, S2, 2] shoulders), f32, and the [H, W, 12]
    candidate stack in the compute dtype (bf16 or f32) -> the renderer's
    input [T, H, W, 13] in that dtype, NHWC-contiguous: the edge maps as
    channel 0, then the candidates.  With cand None, the edge-only form
    [T, H, W, 1] in ``dtype`` (bf16 or f32; f32 when None), split_cand's
    input.  On the card: one launch, no host round trip; the width must be
    a multiple of 8."""
    global LAUNCHES
    h, w = size
    if landmarks.device.type == "cpu":
        return rasterize.render_input(landmarks, shoulders, cand, size, dtype)
    _check_cuda(landmarks, "landmarks")
    if landmarks.dim() != 3 or tuple(landmarks.shape[1:]) != (N_LANDMARKS, 2):
        raise ValueError(f"landmarks must be [T, 73, 2], got {tuple(landmarks.shape)}")
    T = landmarks.shape[0]
    if cand is None:
        channels, out_dtype = 1, dtype or torch.float32
        if out_dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"the edge-only form is bf16 or f32, got {out_dtype}")
    else:
        _check_cuda(cand, "cand", (torch.bfloat16, torch.float32))
        if dtype is not None and dtype != cand.dtype:
            raise ValueError(f"dtype {dtype} differs from the candidates' {cand.dtype}")
        if tuple(cand.shape) != (h, w, 12):
            raise ValueError(f"cand must be [{h}, {w}, 12], got {tuple(cand.shape)}")
        if cand.device != landmarks.device or cand.data_ptr() % 16:
            raise ValueError("cand must be 16-byte aligned, on the landmarks' device")
        channels, out_dtype = 13, cand.dtype
    n_sh = 0
    sh = landmarks
    if shoulders is not None:
        _check_cuda(shoulders, "shoulders")
        if shoulders.device != landmarks.device or shoulders.dim() != 3 \
                or shoulders.shape[0] != T or shoulders.shape[2] != 2:
            raise ValueError(f"shoulders must be [{T}, S2, 2] on the landmarks' device, got "
                             f"{tuple(shoulders.shape)} on {shoulders.device}")
        n_sh, sh = shoulders.shape[1], shoulders
    pairs = segment_pairs(landmarks.device, n_sh)
    if pairs.shape[0] > MAX_SEGMENTS:
        raise ValueError(f"{pairs.shape[0]} segments exceed the kernel's {MAX_SEGMENTS}")
    _check_width(w)
    out = torch.empty(T, h, w, channels, device=landmarks.device, dtype=out_dtype)
    lib = _build.library()
    with torch.cuda.device(landmarks.device):
        err = lib.lsp_render_input(landmarks.data_ptr(), N_LANDMARKS, sh.data_ptr(), n_sh,
                                   pairs.data_ptr(), pairs.shape[0],
                                   None if cand is None else cand.data_ptr(),
                                   out.element_size(), channels, out.data_ptr(), T, h, w, 1.5,
                                   _stream(landmarks))
    _build.check(err, "lsp_render_input")
    LAUNCHES += 1
    return out
