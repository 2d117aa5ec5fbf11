"""Fidelity metrics: landmark L2, PSNR, pose-factored geometry, pose realism
and feature-space perceptual distances.

Counterpart of ``livespeechportraits_tpu/utils/metrics.py``: the same
functions, keys and rounding.  ``perceptual_distance`` (an LPIPS-style
distance in a VGG19's channel-normalised features, unit weights: the
learned LPIPS weights are not shipped) and ``d_feature_distance`` (the same
in a trained discriminator's features) run on the device of the module
they are given; the rest is numpy.

One departure, on purpose (``ADVICE.md``): ``pose_realism_w1`` picks the
channels it scores per block, rotation (degrees) and translation (its own
units) apart, each against its own block's most dynamic channel.  JAX
compares every channel with the most dynamic of all six, so a translation
that moves in earnest but by less than a thousandth of the rotation's
spread in degrees drops out of the score.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from livespeechportraits_torch.models import feature2face as f2f
from livespeechportraits_torch.models import losses as losses_mod

Tensor = torch.Tensor

MOUTH_SLICE = slice(46, 64)  # the 73-point layout's mouth block (demo.py:242)
POSE_BLOCK = 3  # a pose row is rotation (3, degrees), then translation (3)


def landmark_l2(pred: np.ndarray, ref: np.ndarray) -> float:
    """Mean per-landmark L2 distance in pixels of [T, N, 2] tracks over their
    common length."""
    pred, ref = np.asarray(pred), np.asarray(ref)
    T = min(pred.shape[0], ref.shape[0])
    return float(np.linalg.norm(pred[:T] - ref[:T], axis=-1).mean())


def psnr(a: np.ndarray, b: np.ndarray, max_val: float = 255.0) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(max_val ** 2 / mse))


def fidelity_report(frames_a: Optional[np.ndarray] = None,
                    frames_b: Optional[np.ndarray] = None,
                    landmarks_a: Optional[np.ndarray] = None,
                    landmarks_b: Optional[np.ndarray] = None,
                    vgg: Optional[losses_mod.VGG19] = None,
                    pts3d_a: Optional[np.ndarray] = None,
                    pts3d_b: Optional[np.ndarray] = None,
                    pose_a: Optional[np.ndarray] = None,
                    pose_b: Optional[np.ndarray] = None,
                    d: Optional[f2f.Feature2FaceD] = None,
                    device: torch.device | str = "cuda") -> dict:
    """The one fidelity report (JAX metrics.py:37-88): landmark L2 (px),
    frame PSNR (dB) and the VGG perceptual distance, and, given their
    inputs, the canonical mouth rows (pts3d_*), the pose-realism rows
    (pose_*) and the trained discriminator's feature distance (d).  Without
    a vgg, one is drawn at random (seed 0) onto ``device`` (JAX's fallback
    when it is given no pretrained weights)."""
    out: dict = {}
    if landmarks_a is not None and landmarks_b is not None:
        out["landmark_l2_px"] = round(landmark_l2(landmarks_a, landmarks_b), 3)
    if pts3d_a is not None and pts3d_b is not None:
        out.update(canonical_mouth_metrics(pts3d_a, pts3d_b))
    if pose_a is not None and pose_b is not None:
        out.update(pose_realism_w1(pose_a, pose_b))
    if frames_a is not None and frames_b is not None:
        n = min(len(frames_a), len(frames_b))
        out["frames_compared"] = n
        if n:
            out["psnr_db"] = round(psnr(frames_a[:n], frames_b[:n]), 2)
            if vgg is None:
                vgg = losses_mod.init_vgg19().to(device)
                out["perceptual_note"] = "random-VGG (relative comparisons only)"
            out["perceptual_distance"] = round(
                perceptual_distance(vgg, frames_a[:n], frames_b[:n]), 6)
            if d is not None:
                out["d_feature_distance"] = round(
                    d_feature_distance(d, frames_a[:n], frames_b[:n]), 6)
    return out


def canonical_mouth_metrics(pred_pts3d: np.ndarray, gt_pts3d: np.ndarray) -> dict:
    """Mouth-shape errors in the canonical 3D frame, before the head pose
    enters (JAX metrics.py:94-120): canon_mouth_l2, the mean per-landmark
    L2 of the mouth points, and canon_mouth_delta_l2, the same after each
    track's own time-mean mouth is subtracted."""
    p = np.asarray(pred_pts3d, np.float64)[:, MOUTH_SLICE]
    g = np.asarray(gt_pts3d, np.float64)[:, MOUTH_SLICE]
    T = min(p.shape[0], g.shape[0])
    p, g = p[:T], g[:T]
    l2 = np.linalg.norm(p - g, axis=-1).mean()
    pd = p - p.mean(axis=0, keepdims=True)
    gd = g - g.mean(axis=0, keepdims=True)
    dl2 = np.linalg.norm(pd - gd, axis=-1).mean()
    return {"canon_mouth_l2": round(float(l2), 5),
            "canon_mouth_delta_l2": round(float(dl2), 5)}


def _w1(a: np.ndarray, b: np.ndarray) -> float:
    """1-Wasserstein distance between two equal-size 1-D samples."""
    n = min(len(a), len(b))
    if n == 0:
        return 0.0
    return float(np.abs(np.sort(a)[:n] - np.sort(b)[:n]).mean())


def live_channels(stds: np.ndarray) -> np.ndarray:
    """The channels a pose-realism row scores: within each block of
    POSE_BLOCK channels (rotation, translation), those whose ground-truth
    spread exceeds a thousandth of the block's largest.  A block that does
    not move at all (a tracker that locks translation, the synthetic
    subject's constant translation) scores no channel."""
    live = np.zeros(stds.shape, bool)
    for lo in range(0, len(stds), POSE_BLOCK):
        block = stds[lo:lo + POSE_BLOCK]
        live[lo:lo + POSE_BLOCK] = block > 1e-3 * block.max()
    return live


def pose_realism_w1(pred_pose: np.ndarray, gt_pose: np.ndarray) -> dict:
    """Head-pose realism (JAX metrics.py:131-168): per channel, the
    1-Wasserstein distance between the predicted and the ground-truth
    velocity (pose_vel_w1) and acceleration (pose_acc_w1) distributions,
    each divided by the ground truth's spread, averaged over the live
    channels (live_channels; the departure from JAX's cross-channel
    threshold, see the module's docstring).  No live channel at all: the
    mean of the unnormalised distances."""
    p = np.asarray(pred_pose, np.float64)
    g = np.asarray(gt_pose, np.float64)
    T = min(p.shape[0], g.shape[0])
    p, g = p[:T], g[:T]
    out = {}
    for name, order in (("pose_vel_w1", 1), ("pose_acc_w1", 2)):
        pv = np.diff(p, n=order, axis=0)
        gv = np.diff(g, n=order, axis=0)
        stds = gv.std(axis=0)
        live = live_channels(stds)
        if not live.any():
            out[name] = round(float(np.mean([_w1(pv[:, c], gv[:, c])
                                             for c in range(p.shape[1])])), 4)
            continue
        per = [_w1(pv[:, c], gv[:, c]) / stds[c] for c in range(p.shape[1]) if live[c]]
        out[name] = round(float(np.mean(per)), 4)
    return out


def _normalised_sq_diff(fa, fb) -> float:
    """The mean over the feature maps of mean((a / |a| - b / |b|)^2), each
    map normalised over its channels (the last axis)."""
    total = 0.0
    for ya, yb in zip(fa, fb):
        na = ya / (torch.linalg.vector_norm(ya, dim=-1, keepdim=True) + 1e-10)
        nb = yb / (torch.linalg.vector_norm(yb, dim=-1, keepdim=True) + 1e-10)
        total = total + torch.mean((na - nb) ** 2)
    return float(total) / len(fa)


def _chunks(a: np.ndarray, b: np.ndarray, chunk: int, dev: torch.device):
    """uint8 frames [T, H, W, 3] -> (the chunk's first frame, a's and b's
    chunk in [-1, 1] f32 on dev), ``chunk`` frames at a time."""
    for i in range(0, a.shape[0], chunk):
        xa = torch.from_numpy(np.asarray(a[i:i + chunk], np.float32)).to(dev) / 127.5 - 1.0
        xb = torch.from_numpy(np.asarray(b[i:i + chunk], np.float32)).to(dev) / 127.5 - 1.0
        yield i, xa, xb


@torch.no_grad()
def d_feature_distance(d: f2f.Feature2FaceD, a: np.ndarray, b: np.ndarray,
                       cond: Optional[np.ndarray] = None, chunk: int = 8) -> float:
    """The perceptual distance in a trained multiscale discriminator's
    features (every layer but the logits), the space its feature-matching
    loss measures (JAX metrics.py:171-227).  cond [T, H, W, C - 3] is the
    conditioning both sides see (edge map and candidates), zeros when None.
    The eval-mode D runs on its own device, ``chunk`` frames at a time; the
    chunks' distances are averaged by their sizes (JAX pads the last chunk
    to a fixed compile shape and undoes the padding's dilution, which is
    the same mean)."""
    a, b = np.asarray(a), np.asarray(b)
    dev = next(d.parameters()).device
    cond_ch = d.scale_layers(0)[0][0].in_channels - 3

    def feats(img: Tensor, c: Tensor) -> list:
        res = f2f.apply_discriminator(d, torch.cat([c, img], dim=-1))
        return [f for scale in res for f in scale[:-1]]

    vals, weights = [], []
    for i, xa, xb in _chunks(a, b, chunk, dev):
        n = xa.shape[0]
        if cond is not None:
            c = torch.from_numpy(np.asarray(cond[i:i + n], np.float32)).to(dev)
        else:
            c = xa.new_zeros(*xa.shape[:3], cond_ch)
        vals.append(_normalised_sq_diff(feats(xa, c), feats(xb, c)))
        weights.append(n)
    return float(np.average(vals, weights=weights))


@torch.no_grad()
def perceptual_distance(vgg: losses_mod.VGG19, a: np.ndarray, b: np.ndarray,
                        chunk: int = 8) -> float:
    """An LPIPS-style distance between uint8 RGB frames [T, H, W, 3]: the
    VGG19's five taps normalised over their channels, the mean squared
    difference a tap, averaged over the taps (JAX metrics.py:230-257).  The
    frames run through the VGG on its device ``chunk`` at a time (a whole
    clip's first tap would take ~25 GB at 512^2); the chunks are averaged by
    their sizes."""
    dev = next(vgg.parameters()).device
    vals, weights = [], []
    for _, xa, xb in _chunks(np.asarray(a), np.asarray(b), chunk, dev):
        vals.append(_normalised_sq_diff(losses_mod.vgg19_features(vgg, xa),
                                        losses_mod.vgg19_features(vgg, xb)))
        weights.append(xa.shape[0])
    return float(np.average(vals, weights=weights))
