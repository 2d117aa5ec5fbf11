#!/usr/bin/env python3
"""A profiler trace of the port's render half (``animate.render_frames``) at
512^2, with a device-time table by operation family.

    python -m livespeechportraits_torch.tools.trace_render [batch] [quantize] [iters] \\
        [--size large] [--transfer rgb] [--image_size 512] [--ngf 64] [--device cuda]

Counterpart of ``tools/trace_render.py``.  The synthetic subject (random
weights, seed 0) with the 'large' ResUNet (ngf 64, 8 downsamplings, 2
residual blocks a stage) by default, bf16; ``quantize`` 1 (the default)
also renders with the int8 renderer (interior convs on K4, BatchNorm
folded, static activation scales calibrated in bf16 on a 1 s tone, as
``serve.Predictor`` builds it).  The frames are the motion of a test tone,
``batch * iters`` of them, rendered in ``iters`` batches.  Rows (one JSON
line each, after the card's name and power limit):

- ``render``, per renderer: ``render_device_ms`` a call and a batch (the
  median of three unprofiled calls), K1 and K4 launches a batch, the
  generator's FLOPs a frame (utils/flops.generator_flops, the float count)
  and the MFU of the render against the card's bf16 (and for int8, int8)
  dense peak; under int8, the PSNR of its frames against the bf16 ones;
- ``families``: the traced call's device ms a batch by family (K4, K1, the
  coder, cuDNN's convs, the nearest upsample and concat, BatchNorm,
  elementwise, copies and padding, other), the trace's busy time beside the
  CUDA-event wall of the same window (``utils.profiling.coverage``: a trace
  that lost device records says so) and the MFU of the traced device time.

On the CPU the walls are host-clock times and the trace rows read
"not_measured".
"""

from __future__ import annotations

import argparse
import statistics
import sys

import torch

from livespeechportraits_torch.models import feature2face as f2f
from livespeechportraits_torch.ops import q8conv_cuda, rasterize_cuda
from livespeechportraits_torch.pipeline import animate, assets, video
from livespeechportraits_torch.tools import _common
from livespeechportraits_torch.utils import flops, profiling

# Device-time families of the render half, matched in order: a kernel's
# name holds one of the substrings, or its launching op sits under the label.
FAMILIES = (
    ("K4 (int8 conv)", ("q8conv_",)),
    ("K1 (render input)", ("rasterize_kernel",)),
    ("coder", (animate.CODER_LABEL,)),
    ("copies and padding", ("nhwcAddPadding", "Memcpy", "Memset", "copy", "pad")),
    ("nearest upsample and concat", ("upsample", "CatArray", "cat_")),
    ("BatchNorm", ("batch_norm", "batchnorm", "bn_fw")),
    ("cuDNN convs", ("xmma", "implicit", "conv", "gemm", "cutlass", "sm90_", "cudnn")),
    ("elementwise", ("elementwise", "reduce", "tanh", "relu", "clamp")),
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("batch", nargs="?", type=int, default=16)
    p.add_argument("quantize", nargs="?", type=int, default=1)
    p.add_argument("iters", nargs="?", type=int, default=3)
    p.add_argument("--size", default="large", choices=["small", "normal", "large"])
    p.add_argument("--transfer", default="rgb", choices=animate.TRANSFERS)
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--ngf", type=int, default=64)
    p.add_argument("--split_cand", action="store_true")
    _common.add_device_arg(p)
    return p


def renderers(cfg, person, models, quantize: bool):
    """{name: PersonModels}: bf16 (the config's float renderer), and the
    int8 one calibrated on a 1 s tone in bf16, as serve.Predictor builds it."""
    out = {"bf16": models}
    if quantize:
        calib = animate.build_render_inputs(cfg, person, models, video.make_test_tone(1.0),
                                            max_frames=16)
        out["int8"] = assets.quantize_person_models(models, calibrate_inputs=calib,
                                                    calibrate_dtype=animate.compute_dtype(cfg))
    for m in out.values():
        m.feature2face = f2f.cast_generator(m.feature2face, animate.compute_dtype(cfg))
    return out


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev = _common.device(args.device)
    card = _common.emit_card("trace_render", dev)
    H, B = args.image_size, args.batch
    cfg = _common.person_config(args.size, H, args.ngf)
    person, models = assets.make_synthetic_person(cfg, image_size=H, device=dev)
    n = B * args.iters
    audio = video.make_test_tone((n + cfg.audio2headpose.frame_future + 2) / 60.0)
    lm, sh, _, _, nframe = animate.compute_motion(cfg, person, models, audio)
    lm, sh = lm[:n], sh[:n]
    flop_frame = flops.generator_flops(models.feature2face, H)
    frames = {}
    for name, m in renderers(cfg, person, models, bool(args.quantize) and args.size != "small"
                             ).items():
        def render(stage_ms=None):
            return animate.render_frames(cfg, person, m, lm, sh, render_batch=B,
                                         transfer=args.transfer, stage_ms=stage_ms,
                                         split_cand=args.split_cand)[0]

        render()
        k1, k4 = rasterize_cuda.LAUNCHES, q8conv_cuda.LAUNCHES
        walls = []
        for _ in range(3):
            sm = {}
            frames[name] = render(sm)
            walls.append(sm["render_device"])
        batches = 3 * args.iters
        wall = statistics.median(walls)
        row = {"row": "render", "renderer": name, "size": args.size, "image_size": H,
               "batch": B, "batches": args.iters, "transfer": args.transfer,
               "split_cand": args.split_cand,
               "render_device_ms": wall, "render_device_ms_runs": walls,
               "ms_per_batch": wall / args.iters,
               "clock": "host wall to the device's end" if dev.type == "cuda" else "host",
               "k1_launches_per_batch": (rasterize_cuda.LAUNCHES - k1) / batches,
               "k4_launches_per_batch": (q8conv_cuda.LAUNCHES - k4) / batches,
               "gflop_per_frame": flop_frame / 1e9, "card": card}
        if dev.type == "cuda":
            peak, label = flops.render_peak_flops(card)
            rate = flop_frame * B / (wall / args.iters / 1e3)
            row.update(tflops=rate / 1e12, peak=label,
                       mfu_bf16_peak=None if peak is None else rate / peak)
            if name == "int8":
                peak8, _ = flops.render_peak_flops(card, "int8")
                row["mfu_int8_peak"] = None if peak8 is None else rate / peak8
        else:
            row.update(tflops=_common.NOT_MEASURED, mfu_bf16_peak=_common.NOT_MEASURED)
        if name == "int8":
            row["psnr_int8_vs_bf16_db"] = _common.psnr_db(torch.from_numpy(frames["int8"]),
                                                          torch.from_numpy(frames["bf16"]), 255.0)
        _common.emit(**row)
        fam = {"row": "families", "renderer": name, "batch": B}
        if dev.type == "cuda":
            events, ev_wall = profiling.traced(render, dev)
            table = profiling.family_ms(events, FAMILIES)
            cov = profiling.coverage(events, ev_wall)
            peak, _ = flops.render_peak_flops(card)
            busy = cov["trace_busy_ms"] / args.iters
            fam.update(device_ms_per_batch={k: v / args.iters for k, v in table.items()},
                       device_ms_total_per_batch=sum(table.values()) / args.iters,
                       mfu_of_device_time=(None if peak is None or busy <= 0
                                           else flop_frame * B / (busy / 1e3) / peak),
                       **cov)
        else:
            fam.update(device_ms_per_batch=_common.NOT_MEASURED)
        _common.emit(**fam)
    return 0


if __name__ == "__main__":
    sys.exit(main())
