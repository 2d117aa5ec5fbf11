"""The audio -> video inference pipeline on PyTorch.

Counterpart of ``livespeechportraits_tpu/pipeline/animate.py``: the staged
``compute_motion`` (without ``fused`` and ``valid_frames``), ``_jit_post``
as a plain function, ``render_frames`` with the exact RGB transfer, and
``animate``.  Stages:

    1. mel + APC features  (ops/mel.py, models/apc.py: GRU kernel K2)
    2. LLE manifold projection (ops/manifold.py)
    3. Audio2Mouth (models/audio2feature.py: LSTM kernel K3)
    4. Audio2Headpose decode (models/audio2headpose.py)
    5. post-processing: smoothing, AMP, projection (_post)
    6. rendering: rasteriser kernel K1 + Feature2Face U-Net, frames batched

Every stage runs on the device of the models.  ``stage_ms`` holds host
wall-clock per stage; with ``profile=True`` each stage ends in
``torch.cuda.synchronize()`` so the attribution is true.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from livespeechportraits_tpu.config import EYE_BROW_INDICES, MOUTH_INDICES, PersonConfig
from livespeechportraits_torch.models import apc as apc_model
from livespeechportraits_torch.models import audio2feature as a2f_model
from livespeechportraits_torch.models import audio2headpose as a2h_model
from livespeechportraits_torch.models import feature2face as f2f_model
from livespeechportraits_torch.ops import (geometry, manifold, mel, rasterize_cuda,
                                           smoothing)
from livespeechportraits_torch.pipeline.assets import PersonAssets, PersonModels

Tensor = torch.Tensor


@dataclass
class AnimateResult:
    frames: np.ndarray  # [T, H, W, 3] uint8
    feature_maps: Optional[np.ndarray]  # [T, H, W] uint8 edge maps (if kept)
    landmarks: np.ndarray  # [T, 73, 2]
    headpose: np.ndarray  # [T, 6]
    pts3d: np.ndarray  # [T, 73, 3]
    nframe: int
    # Host wall-clock per stage (device-true only with profile=True).
    stage_ms: Dict[str, float] = field(default_factory=dict)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_of(models: PersonModels) -> torch.device:
    return next(models.apc.parameters()).device


@torch.no_grad()
def compute_motion(cfg: PersonConfig, assets: PersonAssets, models: PersonModels,
                   audio: np.ndarray, seed: int = 0,
                   stage_ms: Optional[Dict[str, float]] = None, profile: bool = False,
                   headpose_noise: Optional[Tuple[Tensor, Tensor]] = None):
    """Stages 1-5: audio -> (landmarks2d [N, 73, 2], shoulders2d [N, S, 2],
    head [N, 6], pts3d [N, 73, 3], N), tensors on the models' device.

    headpose_noise: (gumbel, eps) for the head-pose decode; drawn from
    ``seed`` when None (models/audio2headpose.generate_sequence)."""
    sm = stage_ms if stage_ms is not None else {}
    dev = _device_of(models)

    t0 = time.perf_counter()
    mel80 = mel.compute_mel_sequence(audio, device=dev)  # [2T, 80]
    feats = apc_model.encode_fast(models.apc, mel80, residual=cfg.apc.residual)
    if profile:
        _sync(dev)
    sm["mel_apc"] = (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    if cfg.apc.use_LLE:
        feats = manifold.lle_project(feats, assets.tensor("apc_feature_base", dev),
                                     K=cfg.apc.Knear, percent=cfg.apc.LLE_percent)
        if profile:
            _sync(dev)
    sm["lle"] = (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    pred_feat = a2f_model.generate_sequence(models.audio2feature, feats,
                                            frame_future=cfg.audio2feature.frame_future)
    if profile:
        _sync(dev)
    sm["audio2mouth"] = (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    a2h_cfg = cfg.audio2headpose
    pre_headpose = torch.zeros(a2h_cfg.wavenet.input_channels, device=dev)
    pred_head = a2h_model.generate_sequence(
        models.audio2headpose, a2h_cfg, feats, pre_headpose, seed=seed,
        sigma_scale=a2h_cfg.sample_sigma_scale, noise=headpose_noise)
    if profile:
        _sync(dev)
    sm["headpose"] = (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    nframe = int(min(pred_feat.shape[0], pred_head.shape[0]))
    brow_idx = torch.as_tensor(np.arange(nframe) % assets.candidate_eye_brow.shape[0],
                               device=dev)
    landmarks2d, shoulders2d, head, final = _post(
        cfg, pred_feat[:nframe], pred_head[:nframe],
        *(assets.tensor(k, dev) for k in ("mean_pts3d", "std_mean_pts3d",
                                          "mean_translation", "candidate_eye_brow")),
        brow_idx,
        *(assets.tensor(k, dev) for k in ("camera_intrinsic", "shoulder3D", "ref_trans")),
        assets.scale)
    if profile:
        _sync(dev)
    sm["post"] = (time.perf_counter() - t0) * 1e3
    return landmarks2d, shoulders2d, head, final, nframe


def _post(cfg: PersonConfig, pred_feat: Tensor, pred_head: Tensor, mean_pts3d: Tensor,
          std_mean_pts3d: Tensor, mean_translation: Tensor, candidate_eye_brow: Tensor,
          brow_idx: Tensor, K: Tensor, shoulder3D: Tensor, ref_trans: Tensor, scale: float):
    """Stage 5: smoothing, mouth AMP, lip de-intersection, head-pose
    conditioning, eyebrow cycling, landmark and shoulder projection."""
    a2f_cfg = cfg.audio2feature
    a2h_cfg = cfg.audio2headpose
    nframe = pred_feat.shape[0]
    dev = pred_feat.device
    mouth_idx = torch.as_tensor(MOUTH_INDICES, device=dev)
    brow_rows = torch.as_tensor(EYE_BROW_INDICES, device=dev)

    pts3d = pred_feat.new_zeros(nframe, 73, 3)
    pts3d[:, mouth_idx] = pred_feat.reshape(nframe, 25, 3)
    pts3d = smoothing.landmark_smooth_3d(pts3d, a2f_cfg.smooth_sigma, "only_mouth")
    pts3d = smoothing.mouth_amp(pts3d, True, a2f_cfg.amp_method, a2f_cfg.amp_params)
    pts3d = smoothing.solve_intersect_mouth(pts3d + mean_pts3d)

    head = pred_head[:, :6].clone()
    head[:, :3] *= a2h_cfg.rot_amp
    head[:, 3:] *= a2h_cfg.trans_amp
    head = smoothing.headpose_smooth(head, a2h_cfg.smooth_sigmas)
    head[:, 3:] += mean_translation
    head[:, 0] += 180.0  # x-axis convention flip (reference demo.py:232)

    final = std_mean_pts3d.expand(nframe, 73, 3).clone()
    final[:, 46:64] = pts3d[:, 46:64]
    final[:, brow_rows] = candidate_eye_brow[brow_idx] + mean_pts3d[brow_rows]

    eye = torch.eye(3, device=dev)
    landmarks2d = geometry.project_landmarks(K, eye, torch.zeros(3, device=dev), scale,
                                             head, final)
    shoulders2d, _ = geometry.project_shoulders(K, shoulder3D, head[:, 3:], ref_trans,
                                                a2h_cfg.shoulder_amp)
    return landmarks2d, shoulders2d, head, final


@torch.no_grad()
def render_frames(cfg: PersonConfig, assets: PersonAssets, models: PersonModels,
                  landmarks2d: Tensor, shoulders2d: Tensor, render_batch: int = 8,
                  keep_feature_maps: bool = False,
                  stage_ms: Optional[Dict[str, float]] = None):
    """Stage 6: rasterise + U-Net, ``render_batch`` frames at a time.
    Returns (frames [N, H, W, 3] uint8, edge maps [N, H, W] uint8 or None)."""
    sm = stage_ms if stage_ms is not None else {}
    dev = landmarks2d.device
    t0 = time.perf_counter()
    nframe = landmarks2d.shape[0]
    H = W = cfg.feature2face.load_size
    if assets.image_pad is not None:
        top, bottom, left, right = assets.image_pad
        shoulders2d = shoulders2d + torch.tensor([right - left, top - bottom],
                                                 device=dev, dtype=torch.float32)
    dtype = torch.bfloat16 if cfg.feature2face.precision == "bfloat16" else torch.float32
    net = f2f_model.cast_generator(models.feature2face, dtype)
    cand = assets.tensor("candidate_images", dev)  # [4, H, W, 3]
    cand_stack = cand.permute(1, 2, 0, 3).reshape(H, W, 12)  # JAX's concat on channels

    pad_to = -(-nframe // render_batch) * render_batch
    lm = torch.cat([landmarks2d, landmarks2d[-1:].expand(pad_to - nframe, 73, 2)])
    sh = torch.cat([shoulders2d,
                    shoulders2d[-1:].expand(pad_to - nframe, *shoulders2d.shape[1:])])
    frames, maps = [], []
    for start in range(0, pad_to, render_batch):
        edge = rasterize_cuda.rasterize_feature_maps(
            lm[start:start + render_batch], sh[start:start + render_batch], (H, W))
        inp = torch.cat([edge[..., None], cand_stack.expand(render_batch, H, W, 12)], dim=-1)
        frames.append(f2f_model.to_uint8(f2f_model.apply_generator(net, inp)))
        if keep_feature_maps:
            maps.append(edge)
    _sync(dev)
    sm["render_device"] = (time.perf_counter() - t0) * 1e3
    frames_u8 = torch.cat(frames)[:nframe].cpu().numpy()
    sm["render"] = (time.perf_counter() - t0) * 1e3 - sm["render_device"]
    fmap_u8 = None
    if keep_feature_maps:
        fmap_u8 = (torch.cat(maps)[:nframe] * 255).to(torch.uint8).cpu().numpy()
    return frames_u8, fmap_u8


def animate(cfg: PersonConfig, assets: PersonAssets, models: PersonModels, audio: np.ndarray,
            seed: int = 0, render_batch: int = 8, keep_feature_maps: bool = False,
            profile: bool = False,
            headpose_noise: Optional[Tuple[Tensor, Tensor]] = None) -> AnimateResult:
    """audio [-1, 1] float32 at 16 kHz -> frames at 60 FPS, on the models'
    device."""
    stage_ms: Dict[str, float] = {}
    landmarks2d, shoulders2d, head, final, nframe = compute_motion(
        cfg, assets, models, audio, seed=seed, stage_ms=stage_ms, profile=profile,
        headpose_noise=headpose_noise)
    frames, fmaps = render_frames(cfg, assets, models, landmarks2d[:nframe],
                                  shoulders2d[:nframe], render_batch=render_batch,
                                  keep_feature_maps=keep_feature_maps, stage_ms=stage_ms)
    return AnimateResult(
        frames=frames,
        feature_maps=fmaps,
        landmarks=landmarks2d[:nframe].cpu().numpy(),
        headpose=head[:nframe].cpu().numpy(),
        pts3d=final[:nframe].cpu().numpy(),
        nframe=nframe,
        stage_ms=stage_ms,
    )
