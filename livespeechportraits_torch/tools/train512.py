#!/usr/bin/env python3
"""The 512^2 Feature2Face GAN campaign on the card: the 'large' U-Net and
the multiscale D on the synthetic face data, then a timed step.

    python -m livespeechportraits_torch.tools.train512 --steps 400 --batch 4 --vgg random
    python -m livespeechportraits_torch.tools.train512 --steps 20 --batch 4 --fused_step \\
        --remat_depth 2 [--qat_int8 --qat_d] [--bench_only] [--device cuda]

Counterpart of ``tools/train512.py``, on the port's trainer
(``train.trainer.train_feature2face``: the alternating pair of steps, or
``--fused_step``; G in bf16 under autocast, D in f32; remat, the VGG loss
and its chunks, QAT, K1 drawing each batch's edge maps).  The synthetic
data's targets are a stylisation of the landmarks' edge maps, so a falling
L1 shows learning.  Outputs under ``--checkpoints_dir/<name>/`` (the
trainer's checkpoints, logs and epoch panels).  It ends with a timed step
microbenchmark on one batch and prints one JSON line (after the card's
name and power limit): ``step_time_ms`` (CUDA events, the mean of
``--bench_steps`` steps after one warm-up; the host clock on the CPU),
``steps_per_s``, ``train_tflops_per_step`` (the FLOPs of one step, forward
and backward, counted by ``torch.utils.flop_counter.FlopCounterMode``: the
aten ops' own count; K1 and K4, launched by hand, are not in it) and
``mfu`` against the card's bf16 dense peak; with training, the deployed
int8 renderer's PSNR against the float one and against the target.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from livespeechportraits_torch.models import feature2face as f2f
from livespeechportraits_torch.models import losses
from livespeechportraits_torch.tools import _common
from livespeechportraits_torch.train import state, steps, trainer
from livespeechportraits_torch.train.__main__ import synthetic_face_data
from livespeechportraits_torch.utils import flops


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--size", default="large", choices=["small", "normal", "large"])
    p.add_argument("--ngf", type=int, default=64)
    p.add_argument("--vgg", default="random", choices=["none", "random"])
    p.add_argument("--vgg_microbatch", type=int, default=0)
    p.add_argument("--frames", type=int, default=160)
    p.add_argument("--name", default="train512")
    p.add_argument("--checkpoints_dir", default="./checkpoints")
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--decay", action="store_true",
                   help="hold the rate for the first half of the epochs, then decay it "
                        "linearly to 0 (the reference's 30 + 30 epochs)")
    p.add_argument("--no_remat", action="store_true")
    p.add_argument("--remat_depth", type=int, default=0,
                   help="recompute only the outer N U-Net stages; 0: --no_remat decides "
                        "(all of G unless --no_remat)")
    p.add_argument("--fused_step", action="store_true")
    p.add_argument("--bench_only", action="store_true",
                   help="skip the campaign: the timed step on fresh weights")
    p.add_argument("--bench_steps", type=int, default=20)
    p.add_argument("--qat", action="store_true")
    p.add_argument("--qat_int8", action="store_true")
    p.add_argument("--qat_d", action="store_true")
    _common.add_device_arg(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev = _common.device(args.device)
    card = _common.emit_card("train512", dev)
    H = args.image_size
    cfg = _common.f2f_config(args.size, H, args.ngf)
    remat = args.remat_depth or (not args.no_remat)
    sampler = synthetic_face_data(args.frames, H)
    steps_per_epoch = len(sampler) // args.batch
    if steps_per_epoch < 1:
        raise SystemExit(f"--batch {args.batch} exceeds --frames {args.frames}: no full batch "
                         "fits an epoch")
    n_total = max(1, -(-args.steps // steps_per_epoch))
    n_decay = n_total // 2 if args.decay else 0
    loop = trainer.TrainLoopConfig(
        n_epochs=n_total - n_decay, n_epochs_decay=n_decay, lr=args.lr, batch_size=args.batch,
        print_freq=10, checkpoints_dir=args.checkpoints_dir, name=args.name, ttur=True,
        remat=remat, save_epoch_freq=max(1, n_total // 2), validate_epoch=max(1, n_total // 16),
        fused_step=args.fused_step, qat=args.qat, qat_int8=args.qat_int8, qat_d=args.qat_d,
        vgg_microbatch=args.vgg_microbatch, device=str(dev))
    vgg = losses.init_vgg19(0).to(dev) if args.vgg == "random" else None
    compute_dtype = torch.bfloat16 if dev.type == "cuda" else None
    (lr_g, bg), (lr_d, bd) = steps.ttur_learning_rates(args.lr, True)
    train_wall, fidelity = 0.0, None
    if args.bench_only:
        gen = torch.Generator().manual_seed(loop.seed)
        g = trainer._init(f2f.Feature2FaceG(cfg), gen=gen)
        d = trainer._init(f2f.Feature2FaceD(cfg), gen=gen).to(dev)
        if args.qat or args.qat_int8:
            g = f2f.qat_generator(g, int8_forward=args.qat_int8)
        g = g.to(dev)
        opt_g, opt_d = state.adam(g.parameters(), lr_g, *bg), state.adam(d.parameters(), lr_d, *bd)
        steps_trained = 0
    else:
        t0 = time.perf_counter()
        result = trainer.train_feature2face(cfg, loop, sampler, val_sampler=sampler, vgg=vgg)
        train_wall = time.perf_counter() - t0
        g, d = result.models["G"], result.models["D"]
        opt_g, opt_d = result.optimizers["G"], result.optimizers["D"]
        steps_trained = len(result.step_ms)
    move = trainer._Mover(dev)
    batch = move(next(iter(sampler.batches(args.batch, np.random.default_rng(0)))))
    if not args.bench_only and args.size != "small":
        # the deployed int8 renderer against the float one, on a fixed batch
        float_g = f2f.strip_qat_generator(g) if f2f.is_qat_generator(g) else g
        inp, tgt = steps.f2f_g_input(batch), steps.f2f_target(batch)
        deployed = f2f.calibrate_generator(
            f2f.fold_bn_generator(f2f.quantize_generator(float_g.eval())), inp,
            compute_dtype=compute_dtype)
        dtype = compute_dtype or torch.float32
        with torch.no_grad():
            y_f = f2f.apply_generator(f2f.cast_generator(float_g, dtype), inp)
            y_q = f2f.apply_generator(f2f.cast_generator(deployed, dtype), inp)
        fidelity = {"psnr_float_vs_target": _common.psnr_db(y_f, tgt),
                    "psnr_int8_vs_target": _common.psnr_db(y_q, tgt),
                    "psnr_int8_vs_float": _common.psnr_db(y_q, y_f)}
        g.train()
    d_run = f2f.qat_discriminator(d) if args.qat_d else d
    mb = args.vgg_microbatch or None
    losses_seen = []

    def step():
        b = trainer.device_rasterize_batch(batch) if "landmarks" in batch else batch
        if args.fused_step:
            m = steps.f2f_fused_step(cfg, g, d_run, opt_g, opt_d, b, vgg, compute_dtype, remat,
                                     vgg_microbatch=mb)
        else:
            m = steps.f2f_d_step(cfg, g, d_run, opt_d, b, compute_dtype)
            m |= steps.f2f_g_step(cfg, g, d_run, opt_g, b, vgg, compute_dtype, remat, mb)
        losses_seen.append(float(m["loss_G"].detach()))

    t = _common.time_ms(step, dev, args.bench_steps, warmup=1)
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        step()
    step_flops = float(counter.get_total_flops())
    step_s = t["ms"] / 1e3
    peak, label = flops.render_peak_flops(card)
    _common.emit(metric=f"{H}^2 GAN train step (D+G), 1 device", size=args.size,
                 batch=args.batch, vgg=args.vgg, vgg_microbatch=args.vgg_microbatch, remat=remat,
                 fused_step=args.fused_step, qat=args.qat, qat_int8=args.qat_int8,
                 qat_d=args.qat_d, fidelity=fidelity, steps_trained=steps_trained,
                 train_wall_s=train_wall, step_time_ms=t["ms"], clock=t["clock"],
                 steps_per_s=1.0 / step_s, pixels_per_s=args.batch * H * H / step_s,
                 train_tflops_per_step=step_flops / 1e12,
                 flops_counted_by="torch.utils.flop_counter.FlopCounterMode (aten ops; not K1/K4)",
                 mfu=(step_flops / step_s / peak if peak and dev.type == "cuda"
                      else _common.NOT_MEASURED),
                 peak=label, losses_finite=bool(np.isfinite(losses_seen).all()),
                 loss_G_last=losses_seen[-1], card=card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
