"""The int8 3x3 convolution, s8 x s8 -> s32, as one CUDA kernel (K4).

Counterpart of the int8 ``lax.conv`` in ``livespeechportraits_tpu/models/
nn_core.py::_conv2d_q8``.  Tensors are NCHW in ``channels_last`` memory (the
renderer's layout), so the kernel (``csrc/q8conv.cu``) reads NHWC int8
activations and OHWI int8 weights.  ``conv_s8`` returns the exact int32 sums;
``conv_s8_rescale`` fuses the rescale epilogue ``acc.to(dt) * scale + b``.

The plain twin, ``conv_s8_plain``, is a float64 conv on the integer values:
exact, since |acc| <= 127^2 * 9 * 1024 < 2^53.  Dispatch is on the tensor's
device: a CPU tensor takes the twin, a CUDA tensor the kernel, anything else
raises.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from livespeechportraits_torch import _build

Tensor = torch.Tensor

LAUNCHES = 0

_OUT_KIND = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2}


def conv_s8_plain(x_q: Tensor, w_q: Tensor, stride: int, padding: int = 1) -> Tensor:
    """x_q [B, Cin, H, W] int8, w_q [Cout, Cin, 3, 3] int8 -> [B, Cout, Ho, Wo]
    int32, by a float64 conv (exact on integers; the round before the cast
    is a no-op then, and guards the cast against a conv algorithm that is
    not)."""
    y = F.conv2d(x_q.double(), w_q.double(), stride=stride, padding=padding)
    return y.round().to(torch.int32)


def rescale_plain(acc: Tensor, scale: Tensor, bias: Optional[Tensor]) -> Tensor:
    """acc.to(dt) * scale + bias over channel axis 1, dt = scale's dtype."""
    y = acc.to(scale.dtype) * scale.view(1, -1, 1, 1)
    return y if bias is None else y + bias.view(1, -1, 1, 1)


def _device_kind(x: Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type


def _launch(x_q: Tensor, w_q: Tensor, stride: int, padding: int, out_dtype: torch.dtype,
            scale: Optional[Tensor], bias: Optional[Tensor]) -> Tensor:
    global LAUNCHES
    dev = x_q.device
    cl = torch.channels_last
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"x_q and w_q must be int8, got {x_q.dtype} and {w_q.dtype}")
    if x_q.dim() != 4 or w_q.dim() != 4 or tuple(w_q.shape[2:]) != (3, 3):
        raise ValueError(f"expected x_q [B, C, H, W] and w_q [O, C, 3, 3], got "
                         f"{tuple(x_q.shape)} and {tuple(w_q.shape)}")
    B, Cin, H, W = x_q.shape
    Cout = w_q.shape[0]
    if w_q.shape[1] != Cin:
        raise ValueError(f"w_q has {w_q.shape[1]} input channels, x_q {Cin}")
    if Cin % 16:
        raise ValueError(f"the int8 conv kernel needs Cin % 16 == 0, got {Cin}")
    if w_q.device != dev:
        raise ValueError(f"w_q is on {w_q.device}, x_q on {dev}")
    if not (x_q.is_contiguous(memory_format=cl) and w_q.is_contiguous(memory_format=cl)):
        raise ValueError("x_q and w_q must be contiguous in channels_last memory")
    for name, t in (("scale", scale), ("bias", bias)):
        if t is not None and (t.device != dev or t.dtype != out_dtype
                              or tuple(t.shape) != (Cout,) or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous [{Cout}] {out_dtype} tensor on "
                             f"{dev}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    Ho = (H + 2 * padding - 3) // stride + 1
    Wo = (W + 2 * padding - 3) // stride + 1
    out = torch.empty(B, Cout, Ho, Wo, device=dev, dtype=out_dtype, memory_format=cl)
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lsp_q8conv(x_q.data_ptr(), w_q.data_ptr(), B, H, W, Cin, Cout, stride,
                             padding, Ho, Wo, out.data_ptr(), _OUT_KIND[out_dtype],
                             None if scale is None else scale.data_ptr(),
                             None if bias is None else bias.data_ptr(), stream)
    _build.check(err, "lsp_q8conv")
    LAUNCHES += 1
    return out


def conv_s8(x_q: Tensor, w_q: Tensor, stride: int, padding: int = 1) -> Tensor:
    """Exact int32 sums of the int8 conv, [B, Cout, Ho, Wo]."""
    if _device_kind(x_q) == "cpu":
        return conv_s8_plain(x_q, w_q, stride, padding)
    return _launch(x_q, w_q, stride, padding, torch.int32, None, None)


def conv_s8_rescale(x_q: Tensor, w_q: Tensor, stride: int, padding: int, scale: Tensor,
                    bias: Optional[Tensor] = None) -> Tensor:
    """conv_s8(...).to(dt) * scale + bias with dt = scale's dtype (float32
    or bfloat16); on the card the epilogue is fused into the kernel."""
    if _device_kind(x_q) == "cpu":
        return rescale_plain(conv_s8_plain(x_q, w_q, stride, padding), scale, bias)
    if scale.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the fused epilogue runs in float32 or bfloat16, got {scale.dtype}")
    return _launch(x_q, w_q, stride, padding, scale.dtype, scale.contiguous(),
                   None if bias is None else bias.contiguous())
