"""Manifold projection: KNN + locally-linear-embedding reconstruction.

Counterpart of ``livespeechportraits_tpu/ops/manifold.py`` (``knn_indices``,
``solve_lle_weights``, ``lle_project``).  KNN is one distance matmul and
``topk``; the LLE weights are one batched solve of [T, K-1, K-1] systems.
"""

from __future__ import annotations

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


def solve_lle_weights(feats: Tensor, neighbors: Tensor) -> Tuple[Tensor, Tensor]:
    """Sum-to-one constrained least squares per frame: feats [T, D],
    neighbors [T, K, D] -> (weights [T, K], reconstruction [T, D]).

    A singular Gram matrix (duplicate neighbours) gives non-finite weights,
    which fall back to uniform 1/K, as in JAX.  ``solve_ex`` with
    ``check_errors=False`` neither raises nor synchronises with the device.
    """
    f1 = neighbors[:, 0, :]
    A = neighbors[:, 1:, :] - f1[:, None, :]  # [T, K-1, D]
    B = feats - f1
    gram = A @ A.transpose(1, 2)  # [T, K-1, K-1]
    rhs = (A @ B[:, :, None])  # [T, K-1, 1]
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
