"""The int8 3x3 or 4x4 convolution with the activation quantize folded in (K4).

Counterpart of ``livespeechportraits_tpu/models/nn_core.py::_conv2d_q8``
given its activation scale s_x: ``conv_q8(x, r, w_q, stride, padding, scale,
bias)`` computes, with dt = x's dtype (bfloat16 or float32),

    x_q = clamp(round_half_even((x * r).to(dt)), -127, 127)   r = reciprocal(s_x).to(dt)
    y   = conv_s8(x_q, w_q).to(dt) * scale + bias              scale = (w_scale * s_x).to(dt)

in one CUDA kernel (``csrc/q8conv.cu``) that reads the activation once and
quantizes it in registers; ``r`` is a device scalar, so nothing synchronises
with the host.  The renderer's convs are 3x3; the discriminator's interior
convs, which quantization-aware training runs here too, are 4x4 (padding 2).  ``conv_s8`` is the kernel's int8-in, int32-out mode: the
exact integer sums.  Tensors are NCHW in ``channels_last`` memory (the
renderer's layout), so the kernel reads NHWC activations and OHWI weights.

The plain twins: ``quantize_plain``, ``conv_s8_plain`` (a float64 conv on the
integer values, exact since |acc| <= 127^2 * 16 * Cin < 2^53) and
``rescale_plain``, chained by ``conv_q8_plain``.  Dispatch is on the
tensor's device: a CPU tensor takes the twin, a CUDA tensor the kernel,
anything else raises.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from livespeechportraits_torch import _build

Tensor = torch.Tensor

LAUNCHES = 0

_IN_KIND = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2}
BLOCK_M = 128  # output pixels per block (csrc/q8conv.cu kBM)
BLOCK_K = 64  # input channels per K iteration (kBK)
SMS = 132  # H100 SXM streaming multiprocessors: the split-K target
MIN_SPLIT_ITERS = 4  # K iterations per split, at least
KERNEL_SIZES = (3, 4)  # square kernels the launch takes
HALO_TW, HALO_TR = 16, 8  # the halo kernel's output patch (kHaloTW, kHaloTR)


def quantize_plain(x: Tensor, r: Tensor) -> Tensor:
    """clamp(round(x * r), -127, 127) as int8, x * r in x's dtype, round
    half to even."""
    return torch.clamp(torch.round(x * r), -127, 127).to(torch.int8)


def conv_s8_plain(x_q: Tensor, w_q: Tensor, stride: int, padding: int = 1) -> Tensor:
    """x_q [B, Cin, H, W] int8, w_q [Cout, Cin, k, k] int8 (any square k) ->
    [B, Cout, Ho, Wo] int32, by a float64 conv (exact on integers; the round before the cast
    is a no-op then, and guards the cast against a conv algorithm that is
    not)."""
    y = F.conv2d(x_q.double(), w_q.double(), stride=stride, padding=padding)
    return y.round().to(torch.int32)


def rescale_plain(acc: Tensor, scale: Tensor, bias: Optional[Tensor]) -> Tensor:
    """acc.to(dt) * scale + bias over channel axis 1, dt = scale's dtype."""
    y = acc.to(scale.dtype) * scale.view(1, -1, 1, 1)
    return y if bias is None else y + bias.view(1, -1, 1, 1)


def conv_q8_plain(x: Tensor, r: Tensor, w_q: Tensor, stride: int, padding: int, scale: Tensor,
                  bias: Optional[Tensor] = None) -> Tensor:
    """The plain twin of conv_q8: quantize, exact int8 conv, rescale."""
    return rescale_plain(conv_s8_plain(quantize_plain(x, r), w_q, stride, padding), scale, bias)


def uses_halo(H: int, W: int, stride: int, padding: int, ksize: int = 3) -> bool:
    """Whether csrc/q8conv.cu runs its halo kernel (8 x 16 output patches,
    each 64-channel slice of the 10 x 18 input halo quantized once): a 3x3
    conv of stride 1 and padding 1 on a map with W % 16 == 0 and H % 8 == 0.
    Every 4x4 conv takes the gather kernel."""
    return (ksize == 3 and stride == 1 and padding == 1 and W % HALO_TW == 0
            and H % HALO_TR == 0)


def split_k(m: int, cout: int, cin: int, halo: bool = False, ksize: int = 3
            ) -> Tuple[int, int]:
    """(K iterations per split, splits) for an [m, cout] output with cin
    input channels and a ksize x ksize kernel.  When the 128 x BN output
    tiles fall short of the SMs, the ksize^2 * ceil(cin / 64) K iterations
    are split so that about two blocks run per SM, each with at least
    MIN_SPLIT_ITERS iterations; the halo kernel splits whole 64-channel
    slices (9 iterations each)."""
    bn = 64 if cout <= 64 else 128
    tiles = math.ceil(m / BLOCK_M) * math.ceil(cout / bn)
    n_ci = math.ceil(cin / BLOCK_K)
    n_iter = ksize * ksize * n_ci
    if tiles >= SMS:
        return n_iter, 1
    want = math.ceil(2 * SMS / tiles)
    if halo:
        per = 9 * math.ceil(n_ci / min(want, n_ci))
    else:
        per = max(MIN_SPLIT_ITERS, math.ceil(n_iter / want))
    return per, math.ceil(n_iter / per)


def _device_kind(x: Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type


def _launch(x: Tensor, w_q: Tensor, stride: int, padding: int, out_dtype: torch.dtype,
            r: Optional[Tensor], scale: Optional[Tensor], bias: Optional[Tensor]) -> Tensor:
    global LAUNCHES
    dev = x.device
    cl = torch.channels_last
    if (w_q.dtype != torch.int8 or w_q.dim() != 4 or w_q.shape[2] != w_q.shape[3]
            or w_q.shape[2] not in KERNEL_SIZES):
        raise ValueError(f"w_q must be an int8 [O, C, k, k] tensor with k 3 or 4, got "
                         f"{tuple(w_q.shape)} {w_q.dtype}")
    B, Cin, H, W = x.shape
    Cout = w_q.shape[0]
    if w_q.shape[1] != Cin:
        raise ValueError(f"w_q has {w_q.shape[1]} input channels, x {Cin}")
    if Cin % 16:
        raise ValueError(f"the int8 conv kernel needs Cin % 16 == 0, got {Cin}")
    if w_q.device != dev:
        raise ValueError(f"w_q is on {w_q.device}, x on {dev}")
    if not w_q.is_contiguous(memory_format=cl):
        raise ValueError("w_q must be contiguous in channels_last memory")
    if x.data_ptr() % 16 or w_q.data_ptr() % 16:
        raise ValueError("x and w_q must start on a 16-byte boundary")
    for name, t in (("scale", scale), ("bias", bias)):
        if t is not None and (t.device != dev or t.dtype != out_dtype
                              or tuple(t.shape) != (Cout,) or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous [{Cout}] {out_dtype} tensor on "
                             f"{dev}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    ks = w_q.shape[2]
    Ho = (H + 2 * padding - ks) // stride + 1
    Wo = (W + 2 * padding - ks) // stride + 1
    out = torch.empty(B, Cout, Ho, Wo, device=dev, dtype=out_dtype, memory_format=cl)
    per, splits = split_k(B * Ho * Wo, Cout, Cin, uses_halo(H, W, stride, padding, ks), ks)
    ws = (torch.empty(splits * B * Ho * Wo * Cout, device=dev, dtype=torch.int32)
          if splits > 1 else None)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lsp_q8conv(x.data_ptr(), _IN_KIND[x.dtype], w_q.data_ptr(), B, H, W, Cin, Cout,
                             ks, stride, padding, Ho, Wo, out.data_ptr(), ptr(r), ptr(scale),
                             ptr(bias), ptr(ws), per, splits, stream)
    _build.check(err, "lsp_q8conv")
    LAUNCHES += 1
    return out


def _check_activation(x: Tensor, dtypes) -> None:
    if x.dtype not in dtypes:
        raise TypeError(f"expected an activation of dtype {dtypes}, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"x must be a [B, C, H, W] tensor in channels_last memory, got "
                         f"{tuple(x.shape)} with strides {x.stride()}")


def conv_s8(x_q: Tensor, w_q: Tensor, stride: int, padding: int = 1) -> Tensor:
    """Exact int32 sums of the int8 conv, [B, Cout, Ho, Wo]."""
    if _device_kind(x_q) == "cpu":
        return conv_s8_plain(x_q, w_q, stride, padding)
    _check_activation(x_q, (torch.int8,))
    return _launch(x_q, w_q, stride, padding, torch.int32, None, None, None)


def conv_q8(x: Tensor, r: Tensor, w_q: Tensor, stride: int, padding: int, scale: Tensor,
            bias: Optional[Tensor] = None) -> Tensor:
    """The int8 layer: x [B, Cin, H, W] bfloat16 or float32 in channels_last
    memory, r the [] reciprocal activation scale and scale / bias [Cout],
    all of x's dtype and on its device -> [B, Cout, Ho, Wo] of x's dtype.
    On the card one kernel launch; x_q never exists in memory."""
    kind = _device_kind(x)
    _check_activation(x, (torch.float32, torch.bfloat16))
    if r.device != x.device or r.dtype != x.dtype or r.numel() != 1:
        raise ValueError(f"r must be a one-element {x.dtype} tensor on {x.device}, got "
                         f"{tuple(r.shape)} {r.dtype} on {r.device}")
    if kind == "cpu":
        return conv_q8_plain(x, r, w_q, stride, padding, scale, bias)
    return _launch(x, w_q, stride, padding, x.dtype, r, scale.contiguous(),
                   None if bias is None else bias.contiguous())
