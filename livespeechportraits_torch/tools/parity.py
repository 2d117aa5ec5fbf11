#!/usr/bin/env python3
"""Score one pipeline run against another: landmarks, videos and, where
given, the canonical 3D tracks, the head poses and a trained
discriminator's feature space.

    python -m livespeechportraits_torch.tools.parity \\
        --landmarks_a a/landmarks.npy --landmarks_b b/landmarks.npy \\
        --video_a a/out.avi --video_b b/out.avi [--device cuda]

Counterpart of ``tools/parity.py``, with its CLI and its output: one JSON
object (indented) of ``utils/metrics.fidelity_report``, the report the
from-scratch subject run (``tools/e2e_subject.py``) prints too, so both
score on one scale, and where it ran (``device``, and the card's name and
power limit).  Videos are compared frame by frame (PSNR and the
VGG perceptual distance, a random VGG unless ``--vgg_weights`` names an
.npz), landmark tracks by their mean per-point L2 in pixels.  The demo's
``--save_intermediates 1`` (either package's) writes the inputs.  The VGG
and the discriminator run on ``--device`` (the card unless ``cpu``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from livespeechportraits_torch.tools import _common


def load_video(path: str, max_frames: int = 0) -> np.ndarray:
    """[T, H, W, 3] uint8 RGB frames of a video; no frame is an error."""
    import cv2

    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        if max_frames and len(frames) >= max_frames:
            break
    cap.release()
    if not frames:
        raise SystemExit(f"no frames decoded from {path!r} (missing file or unreadable codec) - "
                         "refusing to report an empty parity comparison as success")
    return np.stack(frames)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--landmarks_a")
    p.add_argument("--landmarks_b")
    p.add_argument("--video_a")
    p.add_argument("--video_b")
    p.add_argument("--max_frames", type=int, default=0)
    p.add_argument("--vgg_weights", default="", help="optional VGG19 .npz (losses.load_vgg19_npz)")
    p.add_argument("--pts3d_a", help="optional canonical [T, 73, 3] tracks: the mouth rows")
    p.add_argument("--pts3d_b")
    p.add_argument("--pose_a", help="optional [T, 6] head poses: the pose-realism rows")
    p.add_argument("--pose_b")
    p.add_argument("--f2f_ckpt", default="",
                   help="a Feature2Face trainer run's checkpoint directory: the "
                        "d_feature_distance row in its discriminator's feature space")
    p.add_argument("--person_yaml", default="",
                   help="the person YAML of --f2f_ckpt's architecture (default: the 512^2 "
                        "'large' renderer)")
    _common.add_device_arg(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev = _common.device(args.device)
    from livespeechportraits_torch import config as config_mod
    from livespeechportraits_torch.models import losses
    from livespeechportraits_torch.pipeline import assets
    from livespeechportraits_torch.utils import metrics

    def arr(path):
        return np.load(path) if path else None

    d = None
    if args.f2f_ckpt:
        if args.person_yaml:
            name = os.path.splitext(os.path.basename(args.person_yaml))[0]
            cfg = config_mod.load_person_config(args.person_yaml, name)
        else:
            cfg = _common.person_config("large", 512, 64, name="Parity")
        d = assets.load_trained_discriminator(cfg, args.f2f_ckpt, device=dev)
    vgg = losses.load_vgg19_npz(args.vgg_weights).to(dev) if args.vgg_weights else None
    out = metrics.fidelity_report(
        frames_a=load_video(args.video_a, args.max_frames) if args.video_a else None,
        frames_b=load_video(args.video_b, args.max_frames) if args.video_b else None,
        landmarks_a=arr(args.landmarks_a), landmarks_b=arr(args.landmarks_b), vgg=vgg,
        pts3d_a=arr(args.pts3d_a), pts3d_b=arr(args.pts3d_b),
        pose_a=arr(args.pose_a), pose_b=arr(args.pose_b), d=d, device=dev)
    out["device"], out["card"] = str(dev), _common.card(dev)
    print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
