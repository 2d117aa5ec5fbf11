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

The renderer's inference rewrites (``nn_core.py:471-800`` of the JAX package)
run their int8 forms on the same kernel (its gather path), each with the
activation quantize and the rescale folded in as above, or in the int32
mode on int8 input:

- ``subpixel_q8``: the four 2x2 phase convs at the coarse resolution, one
  launch a phase with padding (1 - a, a) by (1 - b, b), each writing its
  pixels (2i + a, 2j + b) of the fine map;
- ``dilated_q8``: one 4x4 conv over the input dilated by 2, padding 2, the
  dilated map read through the kernel's row map;
- ``split_q8``: the 3x3 conv over the nearest-2x upsample of cat(a, b),
  upsample and concat read through the row map (never written), both
  quantized with the one r and summed in one int32 accumulator, so it
  equals the unsplit conv bit for bit.  It needs a's channels % 64 == 0.

(The single-conv subpixel form is ``conv_q8`` at 4 * Co outputs.)  Their
twins, ``subpixel_plain``, ``dilated_plain`` and ``split_plain``, run
``conv_s8_plain`` over the explicitly padded, dilated or upsampled input.
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
KERNEL_SIZES = (2, 3, 4)  # square kernels the launch takes
# How the conv reads its source (csrc/q8conv.cu SrcMode): as it is, through a
# nearest 2x upsample, or dilated by 2 (zeros between the rows and columns)
SRC_PLAIN, SRC_UP2, SRC_DIL2 = 0, 1, 2
# The four output phases (a, b) of the subpixel forms, in JAX's order a * 2 + b
PHASES = ((0, 0), (0, 1), (1, 0), (1, 1))
HALO_TW, HALO_TR = 16, 8  # the halo kernel's output patch (kHaloTW, kHaloTR)


def quantize_plain(x: Tensor, r: Tensor) -> Tensor:
    """clamp(round(x * r), -127, 127) as int8, x * r in x's dtype, round
    half to even."""
    return torch.clamp(torch.round(x * r), -127, 127).to(torch.int8)


def _pads(padding) -> Tuple[int, int, int, int]:
    """(top, bottom, left, right) of an int or of such a 4-tuple."""
    return (padding,) * 4 if isinstance(padding, int) else tuple(padding)


def source_map(x: Tensor, src: int) -> Tensor:
    """The map a conv reads under src: x itself, its nearest 2x upsample, or
    x dilated by 2 ([2H - 1, 2W - 1], x at the even rows and columns)."""
    if src == SRC_UP2:
        return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    if src == SRC_DIL2:
        B, C, H, W = x.shape
        d = x.new_zeros(B, C, 2 * H - 1, 2 * W - 1)
        d[:, :, ::2, ::2] = x
        return d
    return x


def conv_s8_plain(x_q: Tensor, w_q: Tensor, stride: int, padding=1, src: int = SRC_PLAIN,
                  x2_q: Optional[Tensor] = None) -> Tensor:
    """x_q [B, Cin, H, W] int8, w_q [Cout, Cin, k, k] int8 (any square k) ->
    [B, Cout, Ho, Wo] int32, by a float64 conv (exact on integers; the round before the cast
    is a no-op then, and guards the cast against a conv algorithm that is
    not).  padding: an int or (top, bottom, left, right), applied to the
    source map (src: SRC_PLAIN, SRC_UP2, SRC_DIL2) of cat(x_q, x2_q)."""
    x = x_q.double() if x2_q is None else torch.cat([x_q.double(), x2_q.double()], 1)
    t, b, l, r = _pads(padding)
    x = F.pad(source_map(x, src), (l, r, t, b))
    y = F.conv2d(x, w_q.double(), stride=stride)
    return y.round().to(torch.int32)


def rescale_plain(acc: Tensor, scale: Tensor, bias: Optional[Tensor]) -> Tensor:
    """acc.to(dt) * scale + bias over channel axis 1, dt = scale's dtype."""
    y = acc.to(scale.dtype) * scale.view(1, -1, 1, 1)
    return y if bias is None else y + bias.view(1, -1, 1, 1)


def conv_q8_plain(x: Tensor, r: Tensor, w_q: Tensor, stride: int, padding: int, scale: Tensor,
                  bias: Optional[Tensor] = None) -> Tensor:
    """The plain twin of conv_q8: quantize, exact int8 conv, rescale."""
    return rescale_plain(conv_s8_plain(quantize_plain(x, r), w_q, stride, padding), scale, bias)


def interleave(phases) -> Tensor:
    """Four [B, C, h, w] maps, phase (a, b) in PHASES order -> [B, C, 2h, 2w]
    in channels_last memory, phase (a, b) at the pixels (2i + a, 2j + b)."""
    B, C, h, w = phases[0].shape
    out = phases[0].new_empty(B, h, 2, w, 2, C)
    for y, (a, b) in zip(phases, PHASES):
        out[:, :, a, :, b, :] = y.permute(0, 2, 3, 1)
    return out.view(B, 2 * h, 2 * w, C).permute(0, 3, 1, 2)


def shuffle_phases(y: Tensor, bias: Optional[Tensor] = None) -> Tensor:
    """[B, 4 * C, h, w] (phase-major channels: phase a * 2 + b, then c) ->
    [B, C, 2h, 2w] in channels_last memory, with bias [C] added in the same
    pass (JAX's interleave, then + b)."""
    B, C4, h, w = y.shape
    src = y.permute(0, 2, 3, 1).reshape(B, h, w, 2, 2, C4 // 4).permute(0, 1, 3, 2, 4, 5)
    out = y.new_empty(B, h, 2, w, 2, C4 // 4)
    if bias is None:
        out.copy_(src)
    else:
        torch.add(src, bias, out=out)
    return out.view(B, 2 * h, 2 * w, C4 // 4).permute(0, 3, 1, 2)


def _quantized(x: Tensor, r: Optional[Tensor]) -> Tensor:
    return x if r is None else quantize_plain(x, r)


def _rescaled(acc: Tensor, scale: Optional[Tensor], bias: Optional[Tensor]) -> Tensor:
    return acc if scale is None else rescale_plain(acc, scale, bias)


def subpixel_plain(x: Tensor, w_ph_q: Tensor, r: Optional[Tensor] = None,
                   scale: Optional[Tensor] = None, bias: Optional[Tensor] = None) -> Tensor:
    """The plain twin of subpixel_q8: each phase's 2x2 conv over the input
    padded (1 - a, a) by (1 - b, b), rescaled by its row of scale [4, Co],
    then interleaved; int32 sums when r is None (int8 x)."""
    x_q = _quantized(x, r)
    co = w_ph_q.shape[0] // 4
    return interleave([
        _rescaled(conv_s8_plain(x_q, w_ph_q[p * co:(p + 1) * co], 1, (1 - a, a, 1 - b, b)),
                  None if scale is None else scale[p], bias)
        for p, (a, b) in enumerate(PHASES)])


def dilated_plain(x: Tensor, w_dl_q: Tensor, r: Optional[Tensor] = None,
                  scale: Optional[Tensor] = None, bias: Optional[Tensor] = None) -> Tensor:
    """The plain twin of dilated_q8: the 4x4 conv over the dilated input
    padded by 2."""
    return _rescaled(conv_s8_plain(_quantized(x, r), w_dl_q, 1, 2, SRC_DIL2), scale, bias)


def split_plain(a: Tensor, b: Tensor, w_q: Tensor, r: Optional[Tensor] = None,
                scale: Optional[Tensor] = None, bias: Optional[Tensor] = None) -> Tensor:
    """The plain twin of split_q8: the 3x3 conv over the nearest 2x upsample
    of cat(a, b), padding 1, both quantized with r."""
    acc = conv_s8_plain(_quantized(a, r), w_q, 1, 1, SRC_UP2, _quantized(b, r))
    return _rescaled(acc, scale, bias)


def uses_halo(H: int, W: int, stride: int, padding, ksize: int = 3) -> bool:
    """Whether csrc/q8conv.cu runs its halo kernel (8 x 16 output patches,
    each 64-channel slice of the 10 x 18 input halo quantized once): a 3x3
    conv of stride 1 and padding 1 on a map with W % 16 == 0 and H % 8 == 0,
    read as it is and written as it is.  Every 2x2 and 4x4 conv, and each
    rewrite's form, takes the gather kernel."""
    return (ksize == 3 and stride == 1 and _pads(padding) == (1, 1, 1, 1)
            and W % HALO_TW == 0 and H % HALO_TR == 0)


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


def out_size(n: int, pad_lo: int, pad_hi: int, ksize: int, stride: int,
             src: int = SRC_PLAIN) -> int:
    """The output rows (or columns) of a conv reading n source rows under src."""
    n_in = {SRC_PLAIN: n, SRC_UP2: 2 * n, SRC_DIL2: 2 * n - 1}[src]
    return (n_in + pad_lo + pad_hi - ksize) // stride + 1


def _launch(x: Tensor, w_q: Tensor, stride: int, padding, out_dtype: torch.dtype,
            r: Optional[Tensor], scale: Optional[Tensor], bias: Optional[Tensor],
            src: int = SRC_PLAIN, x2: Optional[Tensor] = None, out: Optional[Tensor] = None,
            phase: Optional[Tuple[int, int]] = None) -> Tensor:
    """One K4 launch.  padding: an int or (top, bottom, left, right); src:
    how the conv reads x; x2: a second source whose channels follow x's
    (x's channels % 64 == 0); out and phase (a, b): write the [Ho, Wo]
    result into out [B, Cout, 2 Ho, 2 Wo] at the pixels (2i + a, 2j + b)."""
    global LAUNCHES
    dev = x.device
    cl = torch.channels_last
    if (w_q.dtype != torch.int8 or w_q.dim() != 4 or w_q.shape[2] != w_q.shape[3]
            or w_q.shape[2] not in KERNEL_SIZES):
        raise ValueError(f"w_q must be an int8 [O, C, k, k] tensor with k 2, 3 or 4, got "
                         f"{tuple(w_q.shape)} {w_q.dtype}")
    B, n_a, H, W = x.shape
    Cin = n_a
    if x2 is not None:
        if (x2.dtype != x.dtype or x2.device != dev or x2.dim() != 4
                or (x2.shape[0], x2.shape[2], x2.shape[3]) != (B, H, W)
                or not x2.is_contiguous(memory_format=cl)):
            raise ValueError(f"x2 must be a [{B}, C, {H}, {W}] {x.dtype} tensor on {dev} in "
                             f"channels_last memory, got {tuple(x2.shape)} {x2.dtype}")
        if n_a % BLOCK_K:
            raise ValueError(f"a second source needs the first's channels % {BLOCK_K} == 0 "
                             f"(a K slice must not straddle the two), got {n_a}")
        Cin += x2.shape[1]
    Cout = w_q.shape[0]
    if w_q.shape[1] != Cin:
        raise ValueError(f"w_q has {w_q.shape[1]} input channels, x {Cin}")
    if Cin % 16:
        raise ValueError(f"the int8 conv kernel needs Cin % 16 == 0, got {Cin}")
    if w_q.device != dev:
        raise ValueError(f"w_q is on {w_q.device}, x on {dev}")
    if not w_q.is_contiguous(memory_format=cl):
        raise ValueError("w_q must be contiguous in channels_last memory")
    if x.data_ptr() % 16 or w_q.data_ptr() % 16 or (x2 is not None and x2.data_ptr() % 16):
        raise ValueError("x, x2 and w_q must start on a 16-byte boundary")
    for name, t in (("scale", scale), ("bias", bias)):
        if t is not None and (t.device != dev or t.dtype != out_dtype
                              or tuple(t.shape) != (Cout,) or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous [{Cout}] {out_dtype} tensor on "
                             f"{dev}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    ks = w_q.shape[2]
    pt, pb, pl, pr = _pads(padding)
    Ho, Wo = out_size(H, pt, pb, ks, stride, src), out_size(W, pl, pr, ks, stride, src)
    step, dy, dx = (1, 0, 0) if phase is None else (2, *phase)
    if out is None:
        if phase is not None:
            raise ValueError("a phase launch writes into a given out")
        out = torch.empty(B, Cout, Ho, Wo, device=dev, dtype=out_dtype, memory_format=cl)
    elif (out.dtype != out_dtype or out.device != dev or tuple(out.shape) != (
            B, Cout, step * Ho, step * Wo) or not out.is_contiguous(memory_format=cl)):
        raise ValueError(f"out must be a [{B}, {Cout}, {step * Ho}, {step * Wo}] {out_dtype} "
                         f"tensor on {dev} in channels_last memory, got {tuple(out.shape)}")
    halo = (src == SRC_PLAIN and x2 is None and phase is None
            and uses_halo(H, W, stride, padding, ks))
    per, splits = split_k(B * Ho * Wo, Cout, Cin, halo, ks)
    ws = (torch.empty(splits * B * Ho * Wo * Cout, device=dev, dtype=torch.int32)
          if splits > 1 else None)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lsp_q8conv(x.data_ptr(), _IN_KIND[x.dtype], w_q.data_ptr(), B, H, W, Cin, Cout,
                             ks, stride, pt, pl, Ho, Wo, out.data_ptr(), ptr(r), ptr(scale),
                             ptr(bias), ptr(ws), per, splits, src, ptr(x2), n_a, step, dy, dx,
                             step * Ho, step * Wo, stream)
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


def _form_operands(x: Tensor, r: Optional[Tensor], scale: Optional[Tensor],
                   bias: Optional[Tensor]) -> Tuple[torch.dtype, Optional[Tensor],
                                                    Optional[Tensor]]:
    """The output dtype, scale and bias of a rewrite's launch: int32 sums for
    int8 x (r None), else x's dtype with the quantize and rescale fused."""
    if x.dtype == torch.int8:
        return torch.int32, None, None
    if r is None or r.device != x.device or r.dtype != x.dtype or r.numel() != 1:
        raise ValueError(f"r must be a one-element {x.dtype} tensor on {x.device}")
    return x.dtype, scale, None if bias is None else bias.contiguous()


def subpixel_q8(x: Tensor, w_ph_q: Tensor, r: Optional[Tensor] = None,
                scale: Optional[Tensor] = None, bias: Optional[Tensor] = None) -> Tensor:
    """The four-phase subpixel up conv: x [B, Ci, h, w] (int8 for the int32
    sums, or bfloat16 / float32 with r, scale [4, Co] and bias [Co] of its
    dtype) in channels_last memory, w_ph_q [4 * Co, Ci, 2, 2] int8 (phase
    a * 2 + b major) -> [B, Co, 2h, 2w].  On the card four K4 launches, phase
    (a, b) padded (1 - a, a) by (1 - b, b), each writing its pixels of the
    interleaved map."""
    kind = _device_kind(x)
    _check_activation(x, (torch.int8, torch.float32, torch.bfloat16))
    if kind == "cpu":
        return subpixel_plain(x, w_ph_q, r, scale, bias)
    dt, scale, bias = _form_operands(x, r, scale, bias)
    B, _, h, w = x.shape
    co = w_ph_q.shape[0] // 4
    if scale is not None and (tuple(scale.shape) != (4, co) or not scale.is_contiguous()):
        raise ValueError(f"scale must be a contiguous [4, {co}] tensor, got {tuple(scale.shape)}")
    out = torch.empty(B, co, 2 * h, 2 * w, device=x.device, dtype=dt,
                      memory_format=torch.channels_last)
    for p, (a, b) in enumerate(PHASES):
        _launch(x, w_ph_q[p * co:(p + 1) * co], 1, (1 - a, a, 1 - b, b), dt, r,
                None if scale is None else scale[p], bias, out=out, phase=(a, b))
    return out


def dilated_q8(x: Tensor, w_dl_q: Tensor, r: Optional[Tensor] = None,
               scale: Optional[Tensor] = None, bias: Optional[Tensor] = None) -> Tensor:
    """The dilated up conv: the 4x4 conv w_dl_q [Co, Ci, 4, 4] over x [B, Ci,
    h, w] dilated by 2, padding 2 -> [B, Co, 2h, 2w]; one K4 launch."""
    kind = _device_kind(x)
    _check_activation(x, (torch.int8, torch.float32, torch.bfloat16))
    if kind == "cpu":
        return dilated_plain(x, w_dl_q, r, scale, bias)
    dt, scale, bias = _form_operands(x, r, scale, bias)
    return _launch(x, w_dl_q, 1, 2, dt, r, scale, bias, src=SRC_DIL2)


def split_q8(a: Tensor, b: Tensor, w_q: Tensor, r: Optional[Tensor] = None,
             scale: Optional[Tensor] = None, bias: Optional[Tensor] = None) -> Tensor:
    """The split up conv: the 3x3 conv w_q [Co, Ca + Cb, 3, 3] over the
    nearest 2x upsample of cat(a, b) (a [B, Ca, h, w], b [B, Cb, h, w], one
    dtype), padding 1 -> [B, Co, 2h, 2w]; one K4 launch, which needs Ca % 64
    == 0 on the card."""
    kind = _device_kind(a)
    for t in (a, b):
        _check_activation(t, (torch.int8, torch.float32, torch.bfloat16))
    if kind == "cpu":
        return split_plain(a, b, w_q, r, scale, bias)
    dt, scale, bias = _form_operands(a, r, scale, bias)
    return _launch(a, w_q, 1, 1, dt, r, scale, bias, src=SRC_UP2, x2=b)
