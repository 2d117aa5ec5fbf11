#!/usr/bin/env python3
"""A profiler trace of the fused 512^2 GAN training step
(``train.steps.f2f_fused_step``), with a device-time table by operation
family.

    python -m livespeechportraits_torch.tools.trace_train [batch] [remat] [iters] \\
        [--size large] [--image_size 512] [--ngf 64] [--qat_int8] [--qat_d] \\
        [--vgg none|random] [--device cuda]

Counterpart of ``tools/trace_train.py``.  The 'large' generator (bf16 under
autocast) and the multiscale D (f32), seed-0 weights, Adam at 2e-4 (0.5,
0.999), on one batch of the synthetic face data whose edge maps K1 draws
at every step (``trainer.device_rasterize_batch``).  remat: 0 none, 1 the
whole G recomputed in the backward, K > 1 the outer K stages; a "d"
suffix ("0d") recomputes the D towers too.  ``--qat_int8`` runs G's
interior convs on K4 with straight-through gradients, ``--qat_d`` D's
4x4 interior convs.  Rows after the card's name and power limit: ``step``
(ms a step by CUDA events, the mean of ``iters`` after 2 warm-ups, the
launches of K1 and K4 a step, the losses) and ``families`` (the device ms
a step of one traced window of ``iters`` steps by family: K4, K1, Adam,
copies and padding, the nearest upsample and concat, BatchNorm, the bf16
convs (G under autocast), the f32 / TF32 convs (D, and the VGG loss with
``--vgg random``), elementwise, other; beside it the trace's busy time and
the CUDA-event wall of the same window, ``utils.profiling.coverage``).
On the CPU the step runs in f32 by the host clock, and the trace rows read
"not_measured".
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from livespeechportraits_torch.models import feature2face as f2f
from livespeechportraits_torch.models import losses
from livespeechportraits_torch.ops import q8conv_cuda, rasterize_cuda
from livespeechportraits_torch.tools import _common
from livespeechportraits_torch.train import state, steps, trainer
from livespeechportraits_torch.train.__main__ import synthetic_face_data
from livespeechportraits_torch.utils import profiling

FAMILIES = (
    ("K4 (int8 conv)", ("q8conv_",)),
    ("K1 (edge maps)", ("rasterize_kernel",)),
    ("Adam", ("multi_tensor_apply", "adam", "Adam")),
    ("copies and padding", ("nhwcAddPadding", "Memcpy", "Memset", "copy", "pad")),
    ("nearest upsample and concat", ("upsample", "CatArray", "cat_")),
    ("BatchNorm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw", "welford")),
    ("convs bf16 (G under autocast)", ("bf16",)),
    ("convs f32/TF32 (D, VGG)", ("xmma", "implicit", "conv", "gemm", "cutlass", "sm90_",
                                 "cudnn", "dgrad", "wgrad")),
    ("elementwise", ("elementwise", "reduce", "tanh", "relu", "clamp", "sum")),
)


def parse_remat(arg: str):
    """(remat, remat_d) of "0", "1", "K" and their "d"-suffixed forms."""
    k = int(arg.rstrip("d") or "0")
    return (k == 1) if k <= 1 else k, arg.endswith("d")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("batch", nargs="?", type=int, default=16)
    p.add_argument("remat", nargs="?", default="0")
    p.add_argument("iters", nargs="?", type=int, default=3)
    p.add_argument("--size", default="large", choices=["normal", "large"])
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--ngf", type=int, default=64)
    p.add_argument("--qat_int8", action="store_true")
    p.add_argument("--qat_d", action="store_true")
    p.add_argument("--vgg", default="none", choices=["none", "random"])
    _common.add_device_arg(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev = _common.device(args.device)
    card = _common.emit_card("trace_train", dev)
    remat, remat_d = parse_remat(args.remat)
    H, B = args.image_size, args.batch
    cfg = _common.f2f_config(args.size, H, args.ngf)
    gen = torch.Generator().manual_seed(0)
    g = trainer._init(f2f.Feature2FaceG(cfg), gen=gen)
    d = trainer._init(f2f.Feature2FaceD(cfg), gen=gen).to(dev)
    if args.qat_int8:
        g = f2f.qat_generator(g, int8_forward=True)
    g = g.to(dev)
    d_run = f2f.qat_discriminator(d) if args.qat_d else d
    opt_g = state.adam(g.parameters(), 2e-4, 0.5, 0.999)
    opt_d = state.adam(d.parameters(), 2e-4, 0.5, 0.999)
    vgg = losses.init_vgg19(0).to(dev) if args.vgg == "random" else None
    compute_dtype = torch.bfloat16 if dev.type == "cuda" else None
    sampler = synthetic_face_data(max(B, 8), H)
    b = next(sampler.batches(B, np.random.default_rng(1), shuffle=False))
    raw = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in b.items()}
    metrics = []

    def step():
        batch = trainer.device_rasterize_batch(raw)
        metrics.append(steps.f2f_fused_step(cfg, g, d_run, opt_g, opt_d, batch, vgg,
                                            compute_dtype, remat, remat_d=remat_d))

    k1, k4 = rasterize_cuda.LAUNCHES, q8conv_cuda.LAUNCHES
    t = _common.time_ms(step, dev, args.iters, warmup=2)
    n = args.iters + 2
    last = {k: float(v) for k, v in metrics[-1].items()}
    _common.emit(row="step", size=args.size, image_size=H, batch=B, remat=remat,
                 remat_d=remat_d, qat_int8=args.qat_int8, qat_d=args.qat_d, vgg=args.vgg,
                 step_ms=t["ms"], clock=t["clock"],
                 k1_launches_per_step=(rasterize_cuda.LAUNCHES - k1) / n,
                 k4_launches_per_step=(q8conv_cuda.LAUNCHES - k4) / n,
                 losses_finite=bool(np.isfinite(list(last.values())).all()), losses=last,
                 card=card)
    fam = {"row": "families", "batch": B, "iters": args.iters}
    if dev.type == "cuda":
        events, wall = profiling.traced(step, dev, args.iters)
        table = profiling.family_ms(events, FAMILIES)
        fam.update(device_ms_per_step={k: v / args.iters for k, v in table.items()},
                   device_ms_total_per_step=sum(table.values()) / args.iters,
                   **profiling.coverage(events, wall))
    else:
        fam["device_ms_per_step"] = _common.NOT_MEASURED
    _common.emit(**fam)
    return 0


if __name__ == "__main__":
    sys.exit(main())
