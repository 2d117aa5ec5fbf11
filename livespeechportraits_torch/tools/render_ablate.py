#!/usr/bin/env python3
"""The render's time by structural ablation: the 512^2 'large' renderer's
forward against variants with given residual blocks removed from the
module.

    python -m livespeechportraits_torch.tools.render_ablate [batch] [quantize] \\
        [--image_size 512] [--ngf 64] [--variants full,minus_256sq_64ch,...] [--device cuda]

Counterpart of ``tools/render_ablate.py``.  A kernel timed alone
(``int8_probe``) does not show a block's cost inside the net, where the
neighbouring passes (BatchNorm, ReLU, the residual add, the copies) come
with it; this removes the blocks and times what is left.  A variant drops
the ResnetBlocks of the named stages (depth 0 the outermost; ``res_down``
before the inner stage, ``res_up`` after the up conv), so its frames are
garbage and only its time counts.  One JSON line a variant, after the
card's name and power limit: ms a batch of the forward and the uint8 cast
(CUDA events, the mean of 10 calls after 2 warm-ups; the host clock on the
CPU) and ``in_net_cost_ms``, the full net's ms less the variant's.
``quantize`` 1 (the default) ablates the int8 renderer (K4's convs; BN
folded, scales calibrated in bf16 on the batch).
"""

from __future__ import annotations

import argparse
import copy
import sys

import torch
from torch import nn

from livespeechportraits_torch.models import feature2face as f2f
from livespeechportraits_torch.tools import _common
from livespeechportraits_torch.train import trainer

# variant -> [(depth, "res_down" | "res_up")] removed.  depth 0 res_down and
# depth 1 res_up sit at 256^2 x 64 channels at 512^2; depth 1 res_down and
# depth 2 res_up at 128^2 x 128; depth 2 res_down and depth 3 res_up at 64^2 x
# 256; the rest at 32^2 and below.
VARIANTS = {
    "full": lambda d, k: False,
    "minus_256sq_64ch": lambda d, k: (d, k) in ((0, "res_down"), (1, "res_up")),
    "minus_128sq_128ch": lambda d, k: (d, k) in ((1, "res_down"), (2, "res_up")),
    "minus_64sq_256ch": lambda d, k: (d, k) in ((2, "res_down"), (3, "res_up")),
    "minus_leq32sq": lambda d, k: (d >= 3 and k == "res_down") or (d >= 4 and k == "res_up"),
}


def strip(model: f2f.Feature2FaceG, drop) -> f2f.Feature2FaceG:
    """A copy without the ResnetBlocks that drop(depth, key) names."""
    out = copy.deepcopy(model)
    for depth, stage in enumerate(f2f._stages(out)):
        layers = list(stage.model)
        cut = next(i for i, m in enumerate(layers) if isinstance(m, nn.Upsample))
        stage.model = nn.Sequential(*[
            m for i, m in enumerate(layers)
            if not (isinstance(m, f2f.ResnetBlock)
                    and drop(depth, "res_down" if i < cut else "res_up"))])
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("batch", nargs="?", type=int, default=16)
    p.add_argument("quantize", nargs="?", type=int, default=1)
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--ngf", type=int, default=64)
    p.add_argument("--variants", default=",".join(VARIANTS))
    p.add_argument("--reps", type=int, default=10)
    _common.add_device_arg(p)
    return p


@torch.no_grad()
def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev = _common.device(args.device)
    card = _common.emit_card("render_ablate", dev)
    H, B = args.image_size, args.batch
    cfg = _common.f2f_config("large", H, args.ngf)
    gen = torch.Generator().manual_seed(0)
    model = trainer._init(f2f.Feature2FaceG(cfg), gen=gen).eval().to(dev)
    x = torch.rand(B, H, H, cfg.input_nc, generator=gen).to(dev)
    if args.quantize:
        model = f2f.calibrate_generator(f2f.fold_bn_generator(f2f.quantize_generator(model)),
                                        x, compute_dtype=torch.bfloat16)
    xb = x.to(torch.bfloat16)
    base = None
    for name in args.variants.split(","):
        net = f2f.cast_generator(strip(model, VARIANTS[name]), torch.bfloat16)
        t = _common.time_ms(lambda: f2f.to_uint8(f2f.apply_generator(net, xb)), dev, args.reps,
                            warmup=2)
        row = {"variant": name, "ms_per_batch": t["ms"], "clock": t["clock"],
               "quantize": bool(args.quantize), "batch": B, "image_size": H,
               "resnet_blocks": sum(isinstance(m, f2f.ResnetBlock) for m in net.modules())}
        if base is None:
            base = t["ms"]
        row["in_net_cost_ms"] = base - t["ms"]
        row["card"] = card
        _common.emit(**row)
    return 0


if __name__ == "__main__":
    sys.exit(main())
