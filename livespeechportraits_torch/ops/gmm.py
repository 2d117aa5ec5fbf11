"""Diagonal-GMM sampling with the noise passed in, and the GMM loss.

Counterpart of ``livespeechportraits_tpu/ops/gmm.py`` (``sample_gmm``,
``gmm_log_loss``).  JAX draws
the noise inside the sampler from a key; PyTorch's generators cannot give
the same numbers, so here the caller hands in the standard Gumbel draws that
pick the component and the standard normal draws of the sample.  Feeding
both versions the same draws makes them comparable sample for sample.

Layout (as in the reference): per row, [weight logits (ncenter),
means (ncenter*ndim), -log sigma (ncenter*ndim)].
"""

from __future__ import annotations

import math

import numpy as np
import torch

Tensor = torch.Tensor

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def gmm_log_loss(output: Tensor, target: Tensor, ncenter: int, ndim: int,
                 sigma_min: float = 0.03) -> Tensor:
    """Mean negative log-likelihood of a diagonal GMM, as the reference's
    GMMLogLoss: output [b, T, (2*ndim+1)*ncenter], target [b, T, ndim]; the
    mean over b, T, the components and the dims of each component's NLL
    (the weight logits do not enter), sigma clamped at sigma_min."""
    b, T, _ = target.shape
    mus = output[:, :, ncenter:ncenter + ncenter * ndim].reshape(b, T, ncenter, ndim)
    neg_log_sigma = output[:, :, ncenter + ncenter * ndim:].reshape(b, T, ncenter, ndim)
    # sigma >= sigma_min  <=>  -log sigma <= log(1 / sigma_min)
    neg_log_sigma = torch.clamp(neg_log_sigma, max=math.log(1.0 / sigma_min))
    diff = target[:, :, None, :] - mus
    nll = _HALF_LOG_2PI - neg_log_sigma + 0.5 * (diff * torch.exp(neg_log_sigma)) ** 2
    return nll.mean()


def sample_gmm(gmm_params: Tensor, ncenter: int, ndim: int, gumbel: Tensor, eps: Tensor,
               sigma_scale: float = 0.0) -> Tensor:
    """[..., (2*ndim+1)*ncenter] -> [..., ndim] samples.

    gumbel: [n, ncenter] standard Gumbel draws; the component is
    argmax(logits + gumbel), i.e. a categorical draw from softmax(logits).
    eps: [n, ndim] standard normal draws; the sample is mu + sigma *
    sigma_scale * eps.  n is the number of rows (the product of the
    leading dims)."""
    lead = gmm_params.shape[:-1]
    flat = gmm_params.reshape(-1, gmm_params.shape[-1])
    n = flat.shape[0]
    logits = flat[:, :ncenter]
    mu = flat[:, ncenter:ncenter + ncenter * ndim].reshape(n, ncenter, ndim)
    sigma = torch.exp(-flat[:, ncenter + ncenter * ndim:]).reshape(n, ncenter, ndim)
    sigma = sigma * sigma_scale
    comp = torch.argmax(logits + gumbel.reshape(n, ncenter), dim=-1)  # [n]
    sel = comp[:, None, None].expand(n, 1, ndim)
    sel_mu = torch.gather(mu, 1, sel)[:, 0]
    sel_sigma = torch.gather(sigma, 1, sel)[:, 0]
    sample = sel_mu + sel_sigma * eps.reshape(n, ndim)
    return sample.reshape(*lead, ndim)


def _mix64(z: np.ndarray) -> np.ndarray:
    """SplitMix64's finaliser on uint64 arrays (wrapping arithmetic)."""
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def step_uniforms(seed: int, n: int, width: int, start: int = 0) -> np.ndarray:
    """[n, width] float64 uniforms in (0, 1) of the steps start .. start+n-1.
    Row i is a hash of (seed, start + i, column) alone - a counter-based
    generator - so the draws of decode step i do not depend on how many
    steps are drawn, or from where."""
    key = _mix64(np.array([seed % 2**64], np.uint64) + np.uint64(0x9E3779B97F4A7C15))
    ctr = (np.arange(start, start + n, dtype=np.uint64)[:, None] * np.uint64(width)
           + np.arange(width, dtype=np.uint64)[None, :])
    bits = _mix64(_mix64(ctr ^ key) + key)
    return ((bits >> np.uint64(11)).astype(np.float64) + 0.5) * 2.0 ** -53


def draw_noise(n: int, ncenter: int, ndim: int, seed: int, start: int = 0):
    """(gumbel [n, ncenter], eps [n, ndim]) float32 on the CPU for the n
    decode steps from ``start`` (a stream draws its chunks so).  Step i's
    Gumbel and normal draws come together from one row of
    ``step_uniforms(seed, ...)``, so they depend only on (seed, i), as
    JAX's fold_in(key, i) draws do: a clip and its bucket-padded copy share
    the draws of every frame they share, on any device."""
    pairs = -(-ndim // 2)
    u = step_uniforms(seed, n, ncenter + 2 * pairs, start)
    gumbel = -np.log(-np.log(u[:, :ncenter]))
    u1, u2 = u[:, ncenter::2], u[:, ncenter + 1::2]  # Box-Muller pairs
    r = np.sqrt(-2.0 * np.log(u1))
    eps = np.concatenate([r * np.cos(2 * np.pi * u2), r * np.sin(2 * np.pi * u2)], axis=1)
    return (torch.from_numpy(gumbel.astype(np.float32)),
            torch.from_numpy(eps[:, :ndim].astype(np.float32)))
