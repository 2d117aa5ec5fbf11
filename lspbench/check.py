"""What decides ``correct``: the frames the caller received, held against
the plain float32 reference of the same subject files and audio.

For each checked request the reference runs the whole motion half on the
request's own (unpadded) audio and renders the frames the run kept, through
the mix's transfer as the caller receives them (``reference/transfer.py``);
each kept frame's squared error against the program's, in uint8 levels, is
averaged over its pixels.  ``frame_mse_max`` is the worst frame's.  The
limit of each number compared lives in the configuration's ``limits``;
``lspbench/control.py`` measures the readings it is set from.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from lspbench.reference import motion, nets, render

BLOCK = 4  # frames a reference forward


def reference_frames(c: dict, A: dict, sd: dict, audio: np.ndarray, seed: int,
                     keep: np.ndarray, runner: Optional[nets.ConvRunner] = None,
                     transform: Callable = nets.to_uint8) -> np.ndarray:
    """The reference's uint8 frames ``keep`` of ``audio`` decoded with
    ``seed``: float32 with TF32 off, the renderer in blocks of frames, its
    output turned into frames by the mix's ``transform``
    (``reference/transfer.py``)."""
    with torch.no_grad(), nets.f32_strict():
        lm, sh = motion.motion(c, A, sd, audio, seed, A["bank"].device)
        out = []
        for i in range(0, len(keep), BLOCK):
            rows = keep[i:i + BLOCK]
            x = render.render_input(lm[rows], sh[rows], A["candidates"])
            out.append(transform(nets.generator(sd["f2f"], c, x, runner)).cpu().numpy())
    return np.concatenate(out)


def calibrated_runner(c: dict, A: dict, sd: dict, levels: int) -> nets.ConvRunner:
    """The renderer quantized with ``levels`` steps a side and calibrated as
    the serving set-up calibrates: on the first 16 frames of a 1 s 220 Hz
    tone at 3 Hz, decoded with seed 0."""
    t = np.arange(16000) / 16000
    tone = (0.3 * np.sin(2 * np.pi * 220 * t) * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))
            ).astype(np.float32)
    runner = nets.ConvRunner(sd["f2f"], c, levels=levels)
    with torch.no_grad(), nets.f32_strict():
        lm, sh = motion.motion(c, A, sd, tone, 0, A["bank"].device)
        runner.calibrate(c, render.render_input(lm[:16], sh[:16], A["candidates"]))
    return runner


def numbers(pairs) -> Dict[str, float]:
    """The comparison of (program, reference) pairs of [N, H, W, 3] uint8
    frames, frame by frame: the worst frame's and the mean frame's squared
    error (levels^2), the worst frame's share of values off by more than 8,
    16 and 32 levels, and the share over all frames off by more than 8."""
    mse, off = [], {8: [], 16: [], 32: []}
    for prog, ref in pairs:
        if prog.shape != ref.shape:  # frames missing or of another size
            return {k: math.inf for k in NUMBERS}
        for i in range(0, len(prog), 16):
            d = np.abs(prog[i:i + 16].astype(np.int16) - ref[i:i + 16].astype(np.int16))
            d = d.reshape(len(d), -1)
            mse.extend((d.astype(np.int32) ** 2).mean(axis=1).tolist())
            for t in off:
                off[t].extend((d > t).mean(axis=1).tolist())
    return {"frame_mse_max": float(max(mse)), "frame_mse_mean": float(np.mean(mse)),
            "frame_off8_max": float(max(off[8])), "frame_off16_max": float(max(off[16])),
            "frame_off32_max": float(max(off[32])), "pixels_off8": float(np.mean(off[8]))}


NUMBERS = ("frame_mse_max", "frame_mse_mean", "frame_off8_max", "frame_off16_max",
           "frame_off32_max", "pixels_off8")


def judge(nums: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, List[str]]:
    """Whether every number with a limit lies at or under it, and one line
    a number: name, value, limit."""
    lines = [f"{k} {nums[k]!r} limit {limits[k]!r}" for k in limits]
    return bool(limits) and all(nums[k] <= v for k, v in limits.items()), lines
