"""Optimizer state of the trainers.

Counterpart of ``livespeechportraits_tpu/train/state.py``.  JAX keeps
(params, opt_state, step) pytrees and splices the training forward's
BatchNorm running stats back into the params after each update
(``merge_bn_stats``); here the parameters live in ``nn.Module``s, the
running stats in their buffers (updated in place by the training forward),
and the Adam moments in a ``torch.optim.Adam`` (or its ZeRO-1 partition,
``parallel.mesh.Zero1``).  In a process group every gradient is the ranks'
mean (``parallel.mesh.allreduce_gradients``): the gradient of the global
batch, as JAX's data-parallel step computes it.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import torch

from livespeechportraits_torch.parallel import mesh

Tensor = torch.Tensor


def adam(params: Iterable[Tensor], lr: float, b1: float = 0.9, b2: float = 0.99,
         eps: float = 1e-8) -> torch.optim.Adam:
    """optax.adam's update (eps outside the square root, no weight decay):
    betas (0.9, 0.99) for the audio models, (0.5, 0.999) or TTUR's (0, 0.9)
    for the GAN."""
    return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=eps)


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    """The epoch's learning rate on every parameter group."""
    for group in opt.param_groups:
        group["lr"] = float(lr)


def apply_gradients(opt: "torch.optim.Optimizer | mesh.Zero1", params: Sequence[Tensor],
                    loss: Tensor) -> None:
    """One optimizer step on d loss / d params (torch.autograd.grad: no other
    tensor in the graph, the other network of a GAN step included, gets a
    gradient).  A parameter the loss does not reach (the WaveNet's last
    residual conv) gets a zero gradient, as in JAX."""
    for p, g in zip(params, gradients(loss, params)):
        p.grad = g
    opt.step()


def gradients(loss: Tensor, params: Sequence[Tensor],
              retain_graph: bool = False) -> Sequence[Tensor]:
    """d loss / d params, zeros where the loss does not reach a parameter,
    averaged over the ranks in a process group; retain_graph keeps the graph
    for another gradient of the same forward."""
    grads = torch.autograd.grad(loss, params, allow_unused=True, retain_graph=retain_graph)
    return mesh.allreduce_gradients([torch.zeros_like(p) if g is None else g
                                     for p, g in zip(params, grads)])
