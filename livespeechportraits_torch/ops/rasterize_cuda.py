"""The edge-map rasteriser as one CUDA kernel (K1).

Counterpart of ``livespeechportraits_tpu/ops/rasterize_pallas.py``.  The
kernel (``csrc/rasterize.cu``) is bitwise equal to the plain twin
``ops/rasterize.rasterize_segments``.  Dispatch is on the tensor's device:
a CPU tensor takes the twin, a CUDA tensor the kernel, anything else
raises.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from livespeechportraits_torch import _build
from livespeechportraits_torch.ops import rasterize

Tensor = torch.Tensor

# The kernel keeps one frame's segment table in shared memory.
MAX_SEGMENTS = 128

LAUNCHES = 0


def rasterize_segments(segments: Tensor, height: int = 512, width: int = 512,
                       radius: float = 1.5) -> Tensor:
    """segments [T, S, 4] f32 (ax, ay, bx, by), S <= 128 -> [T, H, W] f32."""
    global LAUNCHES
    if segments.device.type == "cpu":
        return rasterize.rasterize_segments(segments, height, width, radius)
    if segments.device.type != "cuda":
        raise ValueError(f"unsupported device {segments.device}")
    if segments.dtype != torch.float32:
        raise TypeError(f"segments must be float32, got {segments.dtype}")
    if segments.dim() != 3 or segments.shape[2] != 4:
        raise ValueError(f"segments must be [T, S, 4], got {tuple(segments.shape)}")
    if segments.shape[1] > MAX_SEGMENTS:
        raise ValueError(f"{segments.shape[1]} segments exceed the kernel's {MAX_SEGMENTS}")
    if not segments.is_contiguous():
        raise ValueError("segments must be contiguous")
    T, S, _ = segments.shape
    out = torch.empty(T, height, width, device=segments.device, dtype=torch.float32)
    lib = _build.library()
    with torch.cuda.device(segments.device):
        stream = torch.cuda.current_stream(segments.device).cuda_stream
        err = lib.lsp_rasterize(segments.data_ptr(), T, S, out.data_ptr(), height, width,
                                radius, stream)
    _build.check(err, "lsp_rasterize")
    LAUNCHES += 1
    return out


def rasterize_feature_maps(landmarks: Tensor, shoulders: Optional[Tensor] = None,
                           size: Tuple[int, int] = (512, 512)) -> Tensor:
    """[T, 73, 2] landmarks (+ shoulders) -> [T, H, W] edge maps."""
    h, w = size
    return rasterize_segments(rasterize.segment_table(landmarks, shoulders), h, w)
