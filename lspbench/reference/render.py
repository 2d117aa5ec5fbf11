"""The renderer's input stage as plain PyTorch: landmarks and shoulders ->
binary edge maps (a pixel is on within 1.5 px of a part's polyline, its
endpoints truncated as cv2's int cast does) stacked with the subject's four
candidate images: the Feature2Face input [B, H, W, 13]."""

from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor

PART_LIST = (
    (tuple(range(0, 15)),),
    ((15, 16, 17, 18, 18, 19, 20, 15),),
    ((21, 22, 23, 24, 24, 25, 26, 21),),
    (tuple(range(35, 44)),),
    ((27, 65, 28, 68, 29), (29, 67, 30, 66, 27)),
    ((33, 69, 32, 72, 31), (31, 71, 34, 70, 33)),
    (tuple(range(46, 53)), (52, 53, 54, 55, 56, 57, 46)),
    ((46, 63, 62, 61, 52), (52, 60, 59, 58, 46)),
)


def _segments(landmarks: np.ndarray, shoulders: np.ndarray) -> np.ndarray:
    """[T, S, 4] (ax, ay, bx, by) of every face and shoulder segment."""
    pairs = [(a, b) for group in PART_LIST for edge in group for a, b in zip(edge[:-1], edge[1:])]
    lm = np.trunc(landmarks)
    sh = np.trunc(shoulders)
    half = shoulders.shape[1] // 2
    spairs = [(i * half + j, i * half + j + 1) for i in range(2) for j in range(half - 1)]
    p1 = np.concatenate([lm[:, [a for a, _ in pairs]], sh[:, [a for a, _ in spairs]]], 1)
    p2 = np.concatenate([lm[:, [b for _, b in pairs]], sh[:, [b for _, b in spairs]]], 1)
    return np.concatenate([p1, p2], -1).astype(np.float32)


def edge_maps(landmarks: np.ndarray, shoulders: np.ndarray, size: int, device) -> Tensor:
    """[T, size, size] float32 in {0, 1}."""
    seg = torch.as_tensor(_segments(landmarks, shoulders), device=device)
    ys = torch.arange(size, device=device, dtype=torch.float32)[None, :, None]
    xs = torch.arange(size, device=device, dtype=torch.float32)[None, None, :]
    canvas = torch.zeros(seg.shape[0], size, size, device=device)
    for s in range(seg.shape[1]):
        ax, ay, bx, by = (seg[:, s, j, None, None] for j in range(4))
        dx, dy = bx - ax, by - ay
        len2 = dx * dx + dy * dy
        px, py = xs - ax, ys - ay
        t = torch.where(len2 > 0, (px * dx + py * dy) / torch.clamp(len2, min=1e-12),
                        torch.zeros((), device=device)).clamp(0.0, 1.0)
        ex, ey = px - t * dx, py - t * dy
        canvas = torch.maximum(canvas, (ex * ex + ey * ey <= 2.25).float())
    return canvas


def render_input(landmarks: np.ndarray, shoulders: np.ndarray, candidates: Tensor) -> Tensor:
    """candidates [4, H, W, 3] float32 -> [T, H, W, 13]: the edge map, then
    the four candidates on channels."""
    size = candidates.shape[1]
    edge = edge_maps(landmarks, shoulders, size, candidates.device)[..., None]
    stack = candidates.permute(1, 2, 0, 3).reshape(size, size, 12)
    return torch.cat([edge, stack.expand(edge.shape[0], size, size, 12)], dim=-1)
