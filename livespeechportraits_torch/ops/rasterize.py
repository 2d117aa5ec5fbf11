"""Landmark -> edge feature-map rasterisation, plain PyTorch.

Counterpart of ``livespeechportraits_tpu/ops/rasterize.py``: the 73 facial
landmarks are joined into the reference's part polylines plus two shoulder
polylines, and a pixel lights up when its distance to any segment is
<= 1.5 px.  ``rasterize_segments`` and ``render_input`` are the plain twins
of the two entry points of the CUDA kernel K1 (``ops/rasterize_cuda.py``);
every elementwise op rounds on its own, which is what the kernel reproduces
bit for bit.  ``rasterize_feature_map_host`` and ``facial_weight_mask`` are
the port's copies of JAX's host (cv2) drawers, which the training samplers
use.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

Tensor = torch.Tensor

# Facial part polylines (datasets/face_dataset.py:34-42 of the reference).
MOUTH_OUTER: Tuple[int, ...] = (46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 46)
PART_LIST: Tuple[Tuple[Tuple[int, ...], ...], ...] = (
    (tuple(range(0, 15)),),  # contour
    ((15, 16, 17, 18, 18, 19, 20, 15),),  # right eyebrow
    ((21, 22, 23, 24, 24, 25, 26, 21),),  # left eyebrow
    (tuple(range(35, 44)),),  # nose
    ((27, 65, 28, 68, 29), (29, 67, 30, 66, 27)),  # right eye
    ((33, 69, 32, 72, 31), (31, 71, 34, 70, 33)),  # left eye
    (tuple(range(46, 53)), (52, 53, 54, 55, 56, 57, 46)),  # mouth
    ((46, 63, 62, 61, 52), (52, 60, 59, 58, 46)),  # tongue
)


def face_segments() -> np.ndarray:
    """[S, 2] landmark-index pairs for every face line segment."""
    segs: List[Tuple[int, int]] = []
    for group in PART_LIST:
        for edge in group:
            for a, b in zip(edge[:-1], edge[1:]):
                segs.append((a, b))
    return np.asarray(segs, dtype=np.int64)


def shoulder_segments(n_points: int) -> np.ndarray:
    """[S, 2] index pairs for the two shoulder polylines (the points split
    into two rows of n/2)."""
    half = n_points // 2
    segs = [(i * half + j, i * half + j + 1) for i in range(2) for j in range(half - 1)]
    return np.asarray(segs, dtype=np.int64).reshape(-1, 2)


_FACE_SEGMENTS = face_segments()


def _segment_endpoints(landmarks: Tensor, shoulders: Optional[Tensor]
                       ) -> Tuple[Tensor, Tensor]:
    """Per-frame segment endpoints [T, S, 2], truncated toward zero like
    cv2's int cast (a -0.5 endpoint becomes 0, not -1)."""
    lm = torch.trunc(landmarks).float()
    idx = torch.as_tensor(_FACE_SEGMENTS, device=lm.device)
    p1, p2 = lm[:, idx[:, 0]], lm[:, idx[:, 1]]
    if shoulders is not None and shoulders.shape[1] > 1:
        sidx = torch.as_tensor(shoulder_segments(shoulders.shape[1]), device=lm.device)
        sh = torch.trunc(shoulders).float()
        p1 = torch.cat([p1, sh[:, sidx[:, 0]]], dim=1)
        p2 = torch.cat([p2, sh[:, sidx[:, 1]]], dim=1)
    return p1, p2


def segment_table(landmarks: Tensor, shoulders: Optional[Tensor]) -> Tensor:
    """[T, 73, 2] (+ shoulders) -> [T, S, 4] (ax, ay, bx, by) endpoint table."""
    p1, p2 = _segment_endpoints(landmarks, shoulders)
    return torch.cat([p1, p2], dim=-1).contiguous()


def rasterize_segments(segments: Tensor, height: int = 512, width: int = 512,
                       radius: float = 1.5) -> Tensor:
    """segments [T, S, 4] -> [T, H, W] float32 in {0, 1}: one pass over the
    segments, each folded into the whole canvas with max."""
    T = segments.shape[0]
    dev = segments.device
    ys = torch.arange(height, device=dev, dtype=torch.float32)[None, :, None]
    xs = torch.arange(width, device=dev, dtype=torch.float32)[None, None, :]
    r2 = radius * radius
    canvas = torch.zeros(T, height, width, device=dev, dtype=torch.float32)
    for s in range(segments.shape[1]):
        seg = segments[:, s, :, None, None]  # [T, 4, 1, 1]
        ax, ay, bx, by = seg[:, 0], seg[:, 1], seg[:, 2], seg[:, 3]
        dx, dy = bx - ax, by - ay
        len2 = dx * dx + dy * dy
        px, py = xs - ax, ys - ay
        t = torch.where(len2 > 0, (px * dx + py * dy) / torch.clamp(len2, min=1e-12),
                        torch.zeros((), device=dev))
        t = torch.clamp(t, 0.0, 1.0)
        ex, ey = px - t * dx, py - t * dy
        d2 = ex * ex + ey * ey
        canvas = torch.maximum(canvas, (d2 <= r2).float())
    return canvas


def rasterize_feature_maps(landmarks: Tensor, shoulders: Optional[Tensor] = None,
                           size: Tuple[int, int] = (512, 512)) -> Tensor:
    """[T, 73, 2] landmarks (+ [T, S2, 2] shoulders) -> [T, H, W] edge maps."""
    h, w = size
    return rasterize_segments(segment_table(landmarks, shoulders), height=h, width=w)


def render_input(landmarks: Tensor, shoulders: Optional[Tensor], cand: Optional[Tensor] = None,
                 size: Tuple[int, int] = (512, 512),
                 dtype: Optional[torch.dtype] = None) -> Tensor:
    """The renderer's input [T, H, W, 13] in ``cand``'s dtype: the edge maps
    of [T, 73, 2] landmarks (+ [T, S2, 2] shoulders) as channel 0, then the
    [H, W, 12] candidate stack; concatenated in f32, then cast (round to
    nearest even): what K1's render-input entry computes in one launch.
    With cand None, the edge-only form [T, H, W, 1] in ``dtype`` (f32 when
    None), the split_cand renderer's input: channel 0 of the 13-channel
    form."""
    h, w = size
    edge = rasterize_feature_maps(landmarks, shoulders, size)[..., None]
    if cand is None:
        return edge.to(dtype or torch.float32)
    if dtype is not None and dtype != cand.dtype:
        raise ValueError(f"dtype {dtype} differs from the candidates' {cand.dtype}")
    inp = torch.cat([edge, cand.float().expand(edge.shape[0], h, w, 12)], dim=-1)
    return inp.to(cand.dtype)


# ---------------------------------------------------------------------------
# Host (cv2) drawers, copies of JAX ops/rasterize.py's
# ---------------------------------------------------------------------------


def rasterize_feature_map_host(landmarks: np.ndarray, shoulders: Optional[np.ndarray] = None,
                               size: Tuple[int, int] = (512, 512)) -> np.ndarray:
    """One frame drawn with cv2.line, thickness 2 (the reference's
    FaceDataset.draw_face_feature_maps): [H, W] uint8 in {0, 255}; size is
    cv2's (w, h).  Without cv2, the plain rasteriser."""
    w, h = size
    try:
        import cv2
    except ImportError:  # pragma: no cover
        on = rasterize_feature_maps(torch.as_tensor(landmarks)[None],
                                    None if shoulders is None
                                    else torch.as_tensor(shoulders)[None], (h, w))[0]
        return (on.numpy() * 255).astype(np.uint8)
    img = np.zeros((h, w), np.uint8)
    pairs = [(landmarks, _FACE_SEGMENTS)]
    if shoulders is not None:
        pairs.append((shoulders, shoulder_segments(shoulders.shape[0])))
    for pts, segs in pairs:
        for a, b in segs:
            img = cv2.line(img, tuple(int(v) for v in pts[a]), tuple(int(v) for v in pts[b]),
                           255, 2)
    return img


def facial_weight_mask(points: np.ndarray, h: int = 512, w: int = 512) -> np.ndarray:
    """The mouth region's training weight mask [h, w, 1] float32: the outer
    mouth polygon filled, dilated by a 45x45 box (without cv2: the polygon's
    box grown by 22 px, [h, w])."""
    poly = np.int32(points[list(MOUTH_OUTER)])
    try:
        import cv2
    except ImportError:  # pragma: no cover
        x0, y0 = poly.min(axis=0) - 22
        x1, y1 = poly.max(axis=0) + 22
        out = np.zeros((h, w), np.float32)
        out[max(y0, 0):max(y1, 0), max(x0, 0):max(x1, 0)] = 1.0
        return out
    mask = cv2.fillPoly(np.zeros((h, w, 1), np.float32), [poly], (255, 0, 0))
    return (cv2.dilate(mask, np.ones((45, 45))) / 255.0).astype(np.float32)
