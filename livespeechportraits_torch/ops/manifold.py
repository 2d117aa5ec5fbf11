"""Manifold projection: KNN + locally-linear-embedding reconstruction.

Counterpart of ``livespeechportraits_tpu/ops/manifold.py`` (``knn_indices``,
``knn_chunked``, ``solve_lle_weights``, ``lle_project``).  KNN is one
distance matmul and ``topk`` (``knn_chunked`` streams a bank too large for
one [T, N] matrix); the LLE weights are one batched solve of [T, K-1, K-1]
systems.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import torch

Tensor = torch.Tensor


def knn_indices(feats: Tensor, feat_database: Tensor, K: int = 10) -> Tensor:
    """[T, D] queries, [N, D] bank -> [T, K] indices of the nearest rows
    (squared L2 by |a|^2 + |b|^2 - 2ab, nearest first)."""
    K = min(K, feat_database.shape[0])
    q_norm = (feats * feats).sum(-1, keepdim=True)
    b_norm = (feat_database * feat_database).sum(-1)
    dist = q_norm + b_norm[None, :] - 2.0 * (feats @ feat_database.t())
    return torch.topk(-dist, K, dim=-1).indices


def knn_chunked(feats: Tensor, feat_database: Tensor, K: int = 10,
                chunk: int = 16384) -> Tensor:
    """knn_indices over a bank read ``chunk`` rows at a time with a running
    top-k, so the distances held at once are [T, chunk + K], not [T, N].
    The running best starts as K sentinels at +inf distance (index 0), which
    the first K real rows displace; K = min(K, N) as in knn_indices, whose
    indices it returns."""
    T, N = feats.shape[0], feat_database.shape[0]
    K = min(K, N)
    q_norm = (feats * feats).sum(-1, keepdim=True)
    best_neg = feats.new_full((T, K), -float("inf"))
    best_idx = torch.zeros(T, K, dtype=torch.int64, device=feats.device)
    for base in range(0, N, chunk):
        rows = feat_database[base:base + chunk]
        dist = q_norm + (rows * rows).sum(-1)[None, :] - 2.0 * (feats @ rows.t())
        idx = torch.arange(base, base + rows.shape[0], device=feats.device)
        cand_neg = torch.cat([best_neg, -dist], dim=1)
        cand_idx = torch.cat([best_idx, idx[None].expand(T, -1)], dim=1)
        best_neg, pos = torch.topk(cand_neg, K, dim=-1)
        best_idx = torch.gather(cand_idx, 1, pos)
    return best_idx


@contextlib.contextmanager
def _cusolver(device: torch.device):
    """torch.linalg on cuSOLVER for a CUDA device (the preference restored
    after); nothing on the CPU."""
    if device.type != "cuda":
        yield
        return
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)


def solve_lle_weights(feats: Tensor, neighbors: Tensor) -> Tuple[Tensor, Tensor]:
    """Sum-to-one constrained least squares per frame: feats [T, D],
    neighbors [T, K, D] -> (weights [T, K], reconstruction [T, D]).

    A singular Gram matrix (duplicate neighbours) gives non-finite weights,
    which fall back to uniform 1/K, as in JAX.  ``solve_ex`` with
    ``check_errors=False`` neither raises nor synchronises with the device.
    On the card the solve runs on cuSOLVER (``_cusolver``), whatever
    backend torch's heuristics or build would pick: the staged and the
    fused motion half solve alike, on the backend whose batched LU the
    fused program's CUDA graph captures (chip_smoke.py phase 15).
    """
    f1 = neighbors[:, 0, :]
    A = neighbors[:, 1:, :] - f1[:, None, :]  # [T, K-1, D]
    B = feats - f1
    gram = A @ A.transpose(1, 2)  # [T, K-1, K-1]
    rhs = (A @ B[:, :, None])  # [T, K-1, 1]
    with _cusolver(gram.device):
        w_rest = torch.linalg.solve_ex(gram, rhs, check_errors=False).result[..., 0]
    w0 = 1.0 - w_rest.sum(-1, keepdim=True)
    w = torch.cat([w0, w_rest], dim=-1)
    finite = torch.isfinite(w).all(dim=-1, keepdim=True)
    w = torch.where(finite, w, torch.full_like(w, 1.0 / w.shape[-1]))
    recon = (w[:, None, :] @ neighbors)[:, 0, :]
    return w, recon


def lle_project(feats: Tensor, feat_database: Tensor, K: int = 10,
                percent: float = 1.0) -> Tensor:
    """KNN + LLE + blend: feats * (1 - percent) + reconstruction * percent."""
    idx = knn_indices(feats, feat_database, K)
    _, recon = solve_lle_weights(feats, feat_database[idx])
    return feats * (1.0 - percent) + recon * percent
