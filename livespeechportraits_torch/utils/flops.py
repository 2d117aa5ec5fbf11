"""The Feature2Face generator's FLOPs, and the card's peak rates.

Counterpart of ``livespeechportraits_tpu/utils/flops.py``.
``generator_flops`` walks the port's ``Feature2FaceG`` by shapes alone (a
model on the ``meta`` device will do) and counts what the JAX package's
analytic walk counts:

- a convolution: 2 FLOPs a multiply-accumulate, counting only the taps
  that land on real input (not on zero padding, nor on the holes of a
  transposed conv's dilated input);
- BatchNorm in inference: 4 FLOPs an element and 1 a channel;
- ReLU and the residual add: 1 an element; leaky ReLU: 3;
- the tanh is not counted, nor the nearest upsample and the concat.

The weights' kind does not change the count: an int8 or a QAT-tagged
generator does the float one's arithmetic, so its count is the work one
frame represents, for a model FLOPs utilization (MFU).

``PEAKS`` holds the card's published dense rates and memory rate (NVIDIA's
H100 data sheet): the one table that ``render_peak_flops``, the tools and
``chip_smoke.py``'s bounds read.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from torch import nn

from livespeechportraits_torch.models import feature2face as f2f
from livespeechportraits_torch.models import nn_core

# NVIDIA's H100 data sheet, dense rates (no sparsity): operations a second by
# type, and the memory rate in bytes a second.  Keys are substrings of the
# name the card reports (torch.cuda.get_device_name, nvidia-smi): the SXM5
# part names itself "NVIDIA H100 80GB HBM3".
PEAKS: Dict[str, Dict[str, float]] = {
    "H100 PCIe": {"bf16": 756e12, "int8": 1513e12, "f32": 51e12, "bytes_per_s": 2.0e12},
    "H100 80GB HBM3": {"bf16": 989.4e12, "int8": 1978.9e12, "f32": 67e12,
                       "bytes_per_s": 3.35e12},
    "H100 SXM": {"bf16": 989.4e12, "int8": 1978.9e12, "f32": 67e12, "bytes_per_s": 3.35e12},
}
# The part the bounds of chip_smoke.py and the tools assume: the H100 SXM5
H100_SXM = PEAKS["H100 80GB HBM3"]


def device_peaks(device_name: str) -> Tuple[Optional[Dict[str, float]], Optional[str]]:
    """(the rates of PEAKS, the key that matched) for a card's name, or
    (None, None) for a card the table does not hold."""
    for key, rates in PEAKS.items():
        if key.lower() in device_name.lower():
            return rates, key
    return None, None


def render_peak_flops(device_name: str, kind: str = "bf16"
                      ) -> Tuple[Optional[float], Optional[str]]:
    """(peak operations a second, label) of the card's ``kind`` ("bf16",
    "int8" or "f32") for an MFU, or (None, None) for an unknown card."""
    rates, key = device_peaks(device_name)
    if rates is None:
        return None, None
    return rates[kind], f"{key} {kind} dense"


def _taps_1d(in_size: int, k: int, stride: int, pad: int, out_size: int,
             lhs_dilation: int = 1) -> int:
    """(output position, kernel offset) pairs along one axis whose tap lands
    on a real input element."""
    dil_size = (in_size - 1) * lhs_dilation + 1
    total = 0
    for o in range(out_size):
        base = o * stride - pad
        for u in range(k):
            d = base + u
            if 0 <= d < dil_size and d % lhs_dilation == 0:
                total += 1
    return total


def _conv_flops(k: int, cin: int, cout: int, in_res: int, out_res: int, stride: int,
                pad: int, bias: bool, lhs_dilation: int = 1) -> float:
    taps = _taps_1d(in_res, k, stride, pad, out_res, lhs_dilation)
    f = 2.0 * taps * taps * cin * cout
    if bias:
        f += float(cout) * out_res * out_res
    return f


def _conv_shape(conv: nn.Module) -> Tuple[int, int, int, int, int, bool]:
    """(k, cin, cout, stride, padding, bias) of a float, int8 or QAT conv."""
    if isinstance(conv, nn_core.QConv2d):
        cout, cin, k, _ = conv.w_q.shape
        return k, cin, cout, conv.stride[0], conv.padding[0], conv.b is not None
    cout, cin, k, _ = conv.weight.shape
    return k, cin, cout, conv.stride[0], conv.padding[0], conv.bias is not None


def _bn_flops(res: int, ch: int) -> float:
    return 4.0 * res * res * ch + ch


def _resblock_flops(block: f2f.ResnetBlock, res: int) -> float:
    f = 0.0
    for conv in (block.block[0], block.block[3]):
        k, cin, cout, stride, pad, bias = _conv_shape(conv)
        f += _conv_flops(k, cin, cout, res, res, stride, pad, bias)
        f += _bn_flops(res, cout)
    return f + 3.0 * res * res * cout  # inner ReLU, the residual add, outer ReLU


def _resunet_stage_flops(stage: f2f.ResUnetBlock, res: int) -> float:
    """One ResUNet stage whose input is res^2: the stride-2 down conv (+BN),
    ReLU, residual blocks at res/2, the inner stage at res/2, the up conv at
    res on the upsampled map (+BN, ReLU, residual blocks)."""
    f, cur, ch = 0.0, res, 0
    for m in stage.model:
        if isinstance(m, (nn.Conv2d, nn_core.QConv2d)):
            k, cin, ch, stride, pad, bias = _conv_shape(m)
            out = (cur + 2 * pad - k) // stride + 1
            f += _conv_flops(k, cin, ch, cur, out, stride, pad, bias)
            cur = out
        elif isinstance(m, nn.BatchNorm2d):
            f += _bn_flops(cur, ch)
        elif isinstance(m, nn.ReLU):
            f += 1.0 * cur * cur * ch
        elif isinstance(m, f2f.ResnetBlock):
            f += _resblock_flops(m, cur)
        elif isinstance(m, f2f.ResUnetBlock):
            f += _resunet_stage_flops(m, cur)
        elif isinstance(m, nn.Upsample):
            cur *= 2
    return f


def _unet_stage_flops(stage: f2f.UnetBlock, res: int) -> float:
    """One stage of the 'small' U-Net: leaky ReLU (not outermost), the 4x4
    stride-2 down conv (+BN), the inner stage, ReLU, the 4x4 stride-2
    transposed conv back to res (its taps on the dilated input's real
    elements only, as JAX counts the lhs-dilated conv), BN."""
    layers = list(stage.model)
    down = next(m for m in layers if isinstance(m, nn.Conv2d))
    up = next(m for m in layers if isinstance(m, nn.ConvTranspose2d))
    half = res // 2
    f = 0.0
    for m in layers:
        if isinstance(m, nn.LeakyReLU):
            f += 3.0 * res * res * down.weight.shape[1]
        elif m is down:
            k, cin, cout, stride, pad, bias = _conv_shape(m)
            f += _conv_flops(k, cin, cout, res, half, stride, pad, bias)
        elif isinstance(m, nn.BatchNorm2d):
            at_down = layers.index(m) < layers.index(up)
            f += _bn_flops(half, down.weight.shape[0]) if at_down else _bn_flops(
                res, up.weight.shape[1])
        elif isinstance(m, f2f.UnetBlock):
            f += _unet_stage_flops(m, half)
        elif isinstance(m, nn.ReLU):
            f += 1.0 * half * half * up.weight.shape[0]
        elif m is up:
            cin, cout, k, _ = m.weight.shape
            # k=4, s=2, p=1 transposed: a stride-1 conv over the input
            # dilated by 2, with padding k - 1 - p = 2
            f += _conv_flops(k, cin, cout, half, res, 1, k - 1 - m.padding[0],
                             m.bias is not None, lhs_dilation=2)
    return f


def generator_flops(model: f2f.Feature2FaceG, image_size: int, batch: int = 1) -> float:
    """The forward FLOPs of ``batch`` frames at image_size^2 (the tanh not
    counted), from the module's shapes alone."""
    root = model.netG.model
    if model.size == "small":
        f = _unet_stage_flops(root, image_size)
    else:
        f = _resunet_stage_flops(root, image_size)
    return f * batch
