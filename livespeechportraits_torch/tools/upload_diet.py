#!/usr/bin/env python3
"""The host -> device bytes and seconds a training batch spends in the
port's batch placement (``train.trainer._Mover``), a row per task and
batch format.

    python -m livespeechportraits_torch.tools.upload_diet [--image_size 512] \\
        [--batch 16] [--reps 3] [--tasks feature2face,audio2headpose] [--device cuda]

Counterpart of ``tools/upload_diet.py``.  The formats the port's samplers
have:

- feature2face ``diet`` (``FaceFrameSampler``'s defaults with
  ``device_rasterize``: the subject's candidate stack moved once and
  reused, uint8 targets, raw landmarks whose edge maps K1 draws on the
  card, no weight mask) against ``legacy`` (a candidate stack a sample, f32
  targets, edge maps drawn on the host, the weight mask);
- audio2headpose ``diet`` (``AudioVisualSampler(device_audio=True)``: the
  clip's audio feature bank moved once, a batch carries row indices)
  against ``legacy`` (each batch's audio windows).

Each row, after the card's name and power limit: the bytes a step crosses
the link (the shared candidates and the bank counted apart, once), and the
median seconds of ``reps`` placements after one warm-up (the host clock
around the placement and a synchronize; K1's launch included).
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time

import numpy as np

from livespeechportraits_torch.tools import _common
from livespeechportraits_torch.train import datasets, trainer
from livespeechportraits_torch.train.__main__ import synthetic_face_data


def _time_place(batches, move, dev, reps: int, once_key=None):
    """(median s, bytes a step, bytes once) of moving batches 1..reps; batch
    0 is the warm-up that moves the shared candidates."""
    times, nbytes, once = [], 0, 0
    for i, b in enumerate(batches):
        if i > reps:
            break
        per_step = dict(b)
        if once_key and per_step.get(once_key) is not None and per_step[once_key].shape[0] == 1:
            once = per_step.pop(once_key).nbytes
        t0 = time.perf_counter()
        move(b)
        _common.sync(dev)
        if i > 0:
            times.append(time.perf_counter() - t0)
            nbytes = sum(v.nbytes for v in per_step.values())
    return statistics.median(times), nbytes, once


def bench_f2f(dev, image_size: int, batch: int, reps: int):
    rows = []
    for fmt, kw in (("diet", {"device_rasterize": True}),
                    ("legacy", {"device_rasterize": False, "shared_cand": False,
                                "u8_targets": False})):
        sampler = synthetic_face_data(batch * (reps + 1) + 62, image_size,
                                      device_rasterize=kw.pop("device_rasterize"))
        sampler.emit_weight_mask = fmt == "legacy"
        for k, v in kw.items():
            setattr(sampler, k, v)
        it = sampler.batches(batch, np.random.default_rng(0))
        med, nbytes, once = _time_place(it, trainer._Mover(dev), dev, reps,
                                        once_key="cand_image" if fmt == "diet" else None)
        rows.append({"task": "feature2face", "format": fmt, "image_size": image_size,
                     "batch": batch, "bytes_per_step": int(nbytes),
                     "upload_s_per_step": med, "cand_bytes_once": int(once)})
    return rows


def bench_a2h(dev, batch: int, reps: int, T: int = 3600, F: int = 1024):
    rng = np.random.default_rng(0)
    clip = datasets.make_clip(
        audio_features=rng.normal(size=(2 * T, F // 2)).astype(np.float32),
        pts3d=rng.normal(size=(T, 73, 3)).astype(np.float32),
        rot_angles=rng.uniform(-10, 10, (T, 3)).astype(np.float32),
        trans=rng.normal(size=(T, 3)).astype(np.float32))
    rows = []
    for fmt, dev_audio in (("diet", True), ("legacy", False)):
        s = datasets.AudioVisualSampler([clip], task="audio2headpose", target_length=240,
                                        receptive_field=255, frame_future=15,
                                        device_audio=dev_audio)
        bank_s, bank_bytes = 0.0, 0
        if dev_audio:
            t0 = time.perf_counter()
            trainer._audio_bank(s, dev)
            _common.sync(dev)
            bank_s, bank_bytes = time.perf_counter() - t0, int(s.audio_bank.nbytes)
        med, nbytes, _ = _time_place(s.batches(batch, np.random.default_rng(1)),
                                     trainer._Mover(dev), dev, reps)
        rows.append({"task": "audio2headpose", "format": fmt, "batch": batch,
                     "bytes_per_step": int(nbytes), "upload_s_per_step": med,
                     "bank_upload_once_s": bank_s, "bank_bytes_once": bank_bytes})
    return rows


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--tasks", default="feature2face,audio2headpose")
    p.add_argument("--a2h_frames", type=int, default=3600)
    _common.add_device_arg(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev = _common.device(args.device)
    card = _common.emit_card("upload_diet", dev)
    rows = []
    if "feature2face" in args.tasks:
        rows += bench_f2f(dev, args.image_size, args.batch, args.reps)
    if "audio2headpose" in args.tasks:
        rows += bench_a2h(dev, args.batch, args.reps, T=args.a2h_frames)
    for r in rows:
        _common.emit(**r, clock="host", card=card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
