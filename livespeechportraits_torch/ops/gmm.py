"""Diagonal-GMM sampling with the noise passed in.

Counterpart of ``livespeechportraits_tpu/ops/gmm.py::sample_gmm``.  JAX draws
the noise inside the sampler from a key; PyTorch's generators cannot give
the same numbers, so here the caller hands in the standard Gumbel draws that
pick the component and the standard normal draws of the sample.  Feeding
both versions the same draws makes them comparable sample for sample.

Layout (as in the reference): per row, [weight logits (ncenter),
means (ncenter*ndim), -log sigma (ncenter*ndim)].
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


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


def draw_noise(n: int, ncenter: int, ndim: int, generator: torch.Generator):
    """(gumbel [n, ncenter], eps [n, ndim]) drawn on the CPU from
    ``generator``, so a run draws the same noise whatever its device."""
    u = torch.rand(n, ncenter, generator=generator, dtype=torch.float64)
    u = u.clamp(min=torch.finfo(torch.float64).tiny)
    gumbel = (-torch.log(-torch.log(u))).float()
    eps = torch.randn(n, ndim, generator=generator)
    return gumbel, eps
