"""Optical-flow -> RGB visualisation (Baker et al. colorwheel).

The port's copy of ``livespeechportraits_tpu/utils/flow_viz.py`` (numpy):
the reference's util/flow_viz.py:20-132 and its ``tensor2flow`` helper
(util/util.py), vestigial there (inherited from vid2vid) but part of its
public util surface.
"""

from __future__ import annotations

import numpy as np


def make_colorwheel() -> np.ndarray:
    """[55, 3] RY/YG/GC/CB/BM/MR colorwheel (flow_viz.py:20-58)."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[0:RY, 0] = 255
    wheel[0:RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    wheel[col : col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col : col + YG, 1] = 255
    col += YG
    wheel[col : col + GC, 1] = 255
    wheel[col : col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    wheel[col : col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col : col + CB, 2] = 255
    col += CB
    wheel[col : col + BM, 2] = 255
    wheel[col : col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    wheel[col : col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col : col + MR, 0] = 255
    return wheel


_WHEEL = make_colorwheel()


def flow_uv_to_colors(u: np.ndarray, v: np.ndarray,
                      convert_to_bgr: bool = False) -> np.ndarray:
    """Map normalised flow components to RGB (flow_viz.py:62-96)."""
    img = np.zeros((u.shape[0], u.shape[1], 3), np.uint8)
    ncols = _WHEEL.shape[0]
    rad = np.sqrt(u**2 + v**2)
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(np.int32)
    k1 = (k0 + 1) % ncols
    f = fk - k0
    for i in range(3):
        col0 = _WHEEL[k0, i] / 255.0
        col1 = _WHEEL[k1, i] / 255.0
        col = (1 - f) * col0 + f * col1
        idx = rad <= 1
        col[idx] = 1 - rad[idx] * (1 - col[idx])
        col[~idx] = col[~idx] * 0.75
        ch = 2 - i if convert_to_bgr else i
        img[:, :, ch] = np.floor(255 * col)
    return img


def flow_to_image(flow_uv: np.ndarray, clip_flow: float | None = None,
                  convert_to_bgr: bool = False) -> np.ndarray:
    """[H, W, 2] flow -> [H, W, 3] uint8 (flow_viz.py:100-132)."""
    if flow_uv.ndim != 3 or flow_uv.shape[2] != 2:
        raise ValueError(f"flow must be [H, W, 2], got {flow_uv.shape}")
    if clip_flow is not None:
        flow_uv = np.clip(flow_uv, 0, clip_flow)
    u, v = flow_uv[:, :, 0], flow_uv[:, :, 1]
    rad_max = max(np.sqrt(u**2 + v**2).max(), 1e-5)
    return flow_uv_to_colors(u / rad_max, v / rad_max, convert_to_bgr)


def tensor2flow(flow: np.ndarray) -> np.ndarray:
    """[2, H, W] or [H, W, 2] flow array -> RGB (util/util.py tensor2flow)."""
    flow = np.asarray(flow)
    if flow.ndim == 4:
        flow = flow[0]
    if flow.shape[0] == 2:
        flow = flow.transpose(1, 2, 0)
    return flow_to_image(flow)
