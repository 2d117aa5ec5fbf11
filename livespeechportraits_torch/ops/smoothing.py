"""Motion post-processing: temporal smoothing, amplitude scaling, lip
de-intersection.

Counterpart of ``livespeechportraits_tpu/ops/smoothing.py``.
``gaussian_filter1d`` reproduces
scipy.ndimage.gaussian_filter1d's defaults (truncate 4.0, mode 'reflect',
which repeats the edge sample: [d c b a | a b c d]); the padding is an index
map, since ``F.pad(mode='reflect')`` is the other reflection.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

Tensor = torch.Tensor

# Landmark-group index constants (funcs/utils.py:267-273 of the reference).
MOUTH_RANGE = (46, 64)
UPPER_OUTER_LIP = tuple(range(47, 52))
UPPER_INNER_LIP = (63, 62, 61)
LOWER_INNER_LIP = (58, 59, 60)
LOWER_OUTER_LIP = tuple(range(57, 52, -1))
LOWER_MOUTH = (53, 54, 55, 56, 57, 58, 59, 60)
UPPER_MOUTH = (46, 47, 48, 49, 50, 51, 52, 61, 62, 63)


def _gaussian_kernel(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """scipy.ndimage-compatible discrete Gaussian kernel."""
    radius = int(truncate * float(sigma) + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_filter1d(x: Tensor, sigma: float, truncate: float = 4.0,
                      valid_len: Optional[int] = None) -> Tensor:
    """Gaussian smoothing along axis 0 of [T, D] (scipy 'reflect' mode).

    valid_len: treat only rows [0, valid_len) as the signal (the rest is
    bucket padding, serve.py); the reflection is built from those rows, so
    rows >= valid_len are never read and outputs [0, valid_len) equal
    filtering the unpadded signal bit for bit."""
    if sigma <= 0:
        return x
    kernel = _gaussian_kernel(sigma, truncate)
    radius = kernel.shape[0] // 2
    T = x.shape[0]
    n = T if valid_len is None else int(valid_len)
    if n < 1:
        raise ValueError(f"valid_len must be >= 1, got {valid_len}")
    # closed form of the repeated reflection: a period-2n triangle
    m = np.mod(np.arange(-radius, T + radius), 2 * n)
    idx = torch.as_tensor(np.where(m < n, m, 2 * n - 1 - m), device=x.device)
    xp = x[idx].float()  # [T + 2r, D]
    # correlate each column, out[t] = sum_j k[j] * xp[t + j], tap by tap in
    # the order of j, as the stream's smoother sums: elementwise f32 ops, so
    # row t does not depend on T (a matmul over the sliding windows lets
    # BLAS pick its summation order by the row count, and a bucket-padded
    # run then differs from the unpadded one in the last bit), and no TF32
    # on the card
    out = float(kernel[0]) * xp[:T]
    for j in range(1, kernel.shape[0]):
        out = out + float(kernel[j]) * xp[j:j + T]
    return out.to(x.dtype)


def landmark_smooth_3d(pts3d: Tensor, smooth_sigma: float = 0.0,
                       area: str = "only_mouth", valid_len: Optional[int] = None) -> Tensor:
    """Temporal smoothing of [T, 73, 3] landmarks; 'only_mouth' smooths the
    mouth block on its own and puts it back over the global pass.
    valid_len: see gaussian_filter1d."""
    if smooth_sigma == 0:
        return pts3d
    T = pts3d.shape[0]
    if area == "all":
        return gaussian_filter1d(pts3d.reshape(T, -1), smooth_sigma,
                                 valid_len=valid_len).reshape(pts3d.shape)
    if area != "only_mouth":
        raise ValueError(f"unknown smoothing area {area!r}")
    m0, m1 = MOUTH_RANGE
    mouth = gaussian_filter1d(pts3d[:, m0:m1, :].reshape(T, -1), smooth_sigma,
                              valid_len=valid_len)
    smoothed = gaussian_filter1d(pts3d.reshape(T, -1), smooth_sigma,
                                 valid_len=valid_len).reshape(pts3d.shape)
    smoothed = smoothed.clone()
    smoothed[:, m0:m1, :] = mouth.reshape(T, m1 - m0, 3)
    return smoothed


def mouth_amp(pts3d: Tensor, is_delta: bool = True, method: str = "XY",
              params: Sequence[float] = (1.0, 1.0)) -> Tensor:
    """Mouth-region amplitude scaling of [T, 73, 3] (funcs/utils.py:274-325)."""
    m0, m1 = MOUTH_RANGE
    p = list(params)
    out = pts3d.clone()
    dev = pts3d.device
    if method == "XY":
        ax, ay = p
        if is_delta:
            out[:, m0:m1, 0] *= ax
            out[:, m0:m1, 1] *= ay
        else:
            mean_xy = pts3d[:, m0:m1, :2].mean(dim=0)
            out[:, m0:m1, 0] += (ax - 1) * (pts3d[:, m0:m1, 0] - mean_xy[:, 0])
            out[:, m0:m1, 1] += (ay - 1) * (pts3d[:, m0:m1, 1] - mean_xy[:, 1])
    elif method == "delta":
        if is_delta:
            out[1:, m0:m1] += p[0] * (pts3d[1:, m0:m1] - pts3d[:-1, m0:m1])
    elif method == "XYZ":
        if is_delta:
            out[:, m0:m1, :] *= torch.tensor(p, device=dev, dtype=out.dtype)
    elif method == "LowerMore":
        if is_delta:
            up = torch.tensor(UPPER_MOUTH, device=dev)
            lo = torch.tensor(LOWER_MOUTH, device=dev)
            out[:, up, :] *= torch.tensor(p[:3], device=dev, dtype=out.dtype)
            out[:, lo, :] *= torch.tensor(p[3:], device=dev, dtype=out.dtype)
    elif method == "CloseSmall":
        up = torch.tensor(UPPER_MOUTH, device=dev)
        lo = torch.tensor(LOWER_MOUTH, device=dev)
        open_score = (pts3d[:, up, 1] > 0).sum(1) + (pts3d[:, lo, 1] < 0).sum(1)
        is_open = (open_score > 16 * 0.3)[:, None, None]
        scale = torch.where(is_open, torch.tensor(p[:3], device=dev, dtype=out.dtype),
                            torch.tensor(p[3:], device=dev, dtype=out.dtype))
        out[:, m0:m1, :] *= scale
    else:
        raise ValueError(f"unknown AMP method {method!r}")
    return out


def solve_intersect_mouth(pts3d: Tensor, valid: Optional[Tensor] = None) -> Tensor:
    """De-intersect flipped lips (funcs/utils.py:330-357): a frame whose
    three inner lower-lip points all sit above the inner upper lip gets half
    the overlap pushed back into each inner lip, and the outer lips move by
    the mean overlap over all flipped frames.  ``valid`` ([T] bool) keeps
    bucket-padding rows out of that statistic."""
    dev = pts3d.device
    ui = torch.tensor(UPPER_INNER_LIP, device=dev)
    li = torch.tensor(LOWER_INNER_LIP, device=dev)
    uo = torch.tensor(UPPER_OUTER_LIP, device=dev)
    lo = torch.tensor(LOWER_OUTER_LIP, device=dev)
    upper_y = pts3d[:, ui, 1]
    lower_y = pts3d[:, li, 1]
    flip = (lower_y > upper_y).sum(1) == 3  # [T]
    if valid is not None:
        flip = flip & valid
    diff_half = (lower_y - upper_y) * 0.5
    n_flip = torch.clamp(flip.sum(), min=1)
    global_mean = (diff_half * flip[:, None]).sum() / (n_flip * diff_half.shape[1])
    fmask = flip[:, None]
    zero = torch.zeros((), device=dev, dtype=pts3d.dtype)
    out = pts3d.clone()
    out[:, ui, 1] += torch.where(fmask, diff_half, zero)
    out[:, li, 1] += torch.where(fmask, -diff_half, zero)
    out[:, uo, 1] += torch.where(fmask, global_mean, zero)
    out[:, lo, 1] += torch.where(fmask, -global_mean, zero)
    return out


def headpose_smooth(headpose: Tensor, smooth_sigmas: Tuple[float, float] = (0.0, 0.0),
                    valid_len: Optional[int] = None) -> Tensor:
    """Smooth [T, 6] head pose: rotation with sigma[0], translation with
    sigma[1].  valid_len: see gaussian_filter1d."""
    rot = gaussian_filter1d(headpose[:, :3], smooth_sigmas[0], valid_len=valid_len)
    trans = gaussian_filter1d(headpose[:, 3:], smooth_sigmas[1], valid_len=valid_len)
    return torch.cat([rot, trans], dim=1)
