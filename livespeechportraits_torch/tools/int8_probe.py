#!/usr/bin/env python3
"""K4 against cuDNN's bf16 convolution at every distinct conv shape of the
512^2 'large' ResUNet.

    python -m livespeechportraits_torch.tools.int8_probe [batch] [--image_size 512] \\
        [--device cuda]

Counterpart of ``tools/int8_probe.py``: the same 14 shapes (NHWC 3x3, the
up convs on the 2x-upsampled concat), one JSON line each after the card's
name and power limit: K4 (``q8conv_cuda.conv_q8``, the int8 renderer's
layer: bf16 in, the activation quantized inside, s8 x s8 -> s32, rescaled
to bf16) and the bf16 cuDNN conv (``F.conv2d`` in channels_last, the float
renderer's), each its ms a call (CUDA-graph replay), TFLOP/s (2 * 9 * Cin *
Cout * Ho^2 * batch, int8 operations counted as FLOPs) and its share of the
card's int8 and bf16 dense peaks.  ``outer.down`` (Cin 13) and
``outer.up`` (Cout 3) stay float in the int8 renderer
(``feature2face.quantize_generator``): their K4 column reads "not_taken".
``--image_size`` scales the spatial sizes (a CPU run at a tiny size; there
the times are the plain twin's and cuDNN's stand-in's, by the host clock).
"""

from __future__ import annotations

import argparse
import sys

import torch
import torch.nn.functional as F

from livespeechportraits_torch.ops import q8conv_cuda
from livespeechportraits_torch.tools import _common
from livespeechportraits_torch.utils import flops

# (label, input size at 512^2, Cin, Cout, stride): every distinct conv shape of
# the 'large' forward (JAX tools/int8_probe.py:38-53)
SHAPES = (
    ("outer.down", 512, 13, 64, 2),
    ("s0.res256x64", 256, 64, 64, 1),
    ("outer.up", 512, 128, 3, 1),
    ("s1.down", 256, 64, 128, 2),
    ("s1.res128x128", 128, 128, 128, 1),
    ("s1.up", 256, 256, 64, 1),
    ("s2.down", 128, 128, 256, 2),
    ("s2.res64x256", 64, 256, 256, 1),
    ("s2.up", 128, 512, 128, 1),
    ("s3.down", 64, 256, 512, 2),
    ("s3.res32x512", 32, 512, 512, 1),
    ("s3.up", 64, 1024, 256, 1),
    ("s4.res16x512", 16, 512, 512, 1),
    ("s4.up", 32, 1024, 512, 1),
)
NOT_TAKEN = {"outer.down": "the outermost down conv (13 input planes) stays float in the int8 "
                           "renderer; K4 needs Cin % 16 == 0 and is not padded to reach it",
             "outer.up": "the outermost up conv (3 output planes) stays float in the int8 "
                         "renderer"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("batch", nargs="?", type=int, default=16)
    p.add_argument("--image_size", type=int, default=512)
    _common.add_device_arg(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev = _common.device(args.device)
    card = _common.emit_card("int8_probe", dev)
    peak8, _ = flops.render_peak_flops(card, "int8")
    peak16, _ = flops.render_peak_flops(card, "bf16")
    B, cl = args.batch, torch.channels_last
    g = torch.Generator().manual_seed(0)
    for label, size, ci, co, stride in SHAPES:
        H = max(2, size * args.image_size // 512)
        Ho = H // stride
        gflop = 2 * 9 * ci * co * Ho * Ho * B / 1e9
        x = torch.randn(B, ci, H, H, generator=g).to(dev, torch.bfloat16).contiguous(
            memory_format=cl)
        w = (torch.randn(co, ci, 3, 3, generator=g) * 0.05).to(dev, torch.bfloat16).contiguous(
            memory_format=cl)
        row = {"conv": label, "shape": f"{B}x{H}x{H}x{ci}->{co}/s{stride}", "gflop": gflop}

        def rates(name, t, peak_name_pairs):
            row[f"{name}_ms"] = t["ms"]
            row["clock"] = t["clock"]
            if dev.type == "cuda":
                row[f"{name}_tflops"] = gflop / t["ms"]
                for pname, peak in peak_name_pairs:
                    if peak:
                        row[f"{name}_share_of_{pname}_peak"] = gflop * 1e9 / (t["ms"] / 1e3) / peak

        rates("cudnn_bf16", _common.kernel_ms(lambda: F.conv2d(x, w, stride=stride, padding=1),
                                              dev), (("bf16", peak16),))
        if label in NOT_TAKEN:
            row["k4"] = "not_taken"
            row["k4_reason"] = NOT_TAKEN[label]
        else:
            w_q = torch.randint(-127, 128, (co, ci, 3, 3), generator=g, dtype=torch.int8).to(
                dev).contiguous(memory_format=cl)
            r = torch.tensor(4.0, dtype=torch.bfloat16, device=dev)
            scale = torch.full((co,), 1e-4, dtype=torch.bfloat16, device=dev)
            bias = torch.zeros(co, dtype=torch.bfloat16, device=dev)
            before = q8conv_cuda.LAUNCHES
            rates("k4", _common.kernel_ms(
                lambda: q8conv_cuda.conv_q8(x, r, w_q, stride, 1, scale, bias), dev),
                (("int8", peak8), ("bf16", peak16)))
            row["k4_launches"] = q8conv_cuda.LAUNCHES - before  # 0 on the CPU: the twin
            row["speedup_k4_vs_cudnn_bf16"] = row["cudnn_bf16_ms"] / row["k4_ms"]
        row["card"] = card
        _common.emit(**row)
    return 0


if __name__ == "__main__":
    sys.exit(main())
