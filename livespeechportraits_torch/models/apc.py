"""APC (Autoregressive Predictive Coding) speech encoder: a stack of
single-layer GRUs, 80 mel -> hidden -> hidden.

Counterpart of ``livespeechportraits_tpu/models/apc.py`` (``apply_apc``,
``encode_fast``, the pretraining head: ``init_apc_pretrain``,
``apply_apc_pretrain``, and ``load_pretrained_encoder``) and of the streaming
path's chunked GRU (``encode_chunk``).
Parameter names follow the reference's ``rnns.{i}.weight_ih_l0`` layout.
On the card every layer's time loop runs in the GRU kernel K2
(ops/recurrent_cuda.py); the optional residual add sits outside the
recurrence, so both settings take the kernel.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
from torch import nn

from livespeechportraits_torch.config import APCConfig
from livespeechportraits_torch.models import nn_core
from livespeechportraits_torch.ops import recurrent_cuda

Tensor = torch.Tensor


class APCEncoder(nn.Module):
    def __init__(self, cfg: APCConfig):
        super().__init__()
        self.rnns = nn.ModuleList([
            nn_core.RNNWeights(cfg.mel_dim if i == 0 else cfg.hidden_size,
                               cfg.hidden_size, 1, gates=3)
            for i in range(cfg.num_layers)
        ])

    def reset_parameters(self, gen: torch.Generator) -> None:
        for rnn in self.rnns:
            nn_core.init_rnn_(rnn, gen)


class APCPretrain(nn.Module):
    """The encoder and a linear head that predicts the log-mel frame
    ``time_shift`` steps ahead from each GRU state: the self-supervised
    pretraining model (JAX init_apc_pretrain).  Serving keeps ``encoder``."""

    def __init__(self, cfg: APCConfig):
        super().__init__()
        self.encoder = APCEncoder(cfg)
        self.head = nn.Linear(cfg.hidden_size, cfg.mel_dim)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """The encoder's RNN init, then a xavier-normal (gain 1) head."""
        self.encoder.reset_parameters(gen)
        out_dim, in_dim = self.head.weight.shape
        std = math.sqrt(2.0 / (in_dim + out_dim))
        self.head.weight.copy_(torch.randn(self.head.weight.shape, generator=gen) * std)
        self.head.bias.zero_()


def _stack(model: APCEncoder, x: Tensor, residual: bool,
           h0: Optional[List[Tensor]] = None, batched: bool = False
           ) -> Tuple[Tensor, List[Tensor]]:
    """The GRU layers over x [B, T, in] from h0 (zeros when None) -> (the top
    layer's states [B, T, H], each layer's last state [B, H]).  batched:
    torch's differentiable RNN operator at any batch (training), from zero
    state."""
    n = len(model.rnns)
    h_last = []
    for i, rnn in enumerate(model.rnns):
        if batched:
            y, h_t = nn_core.gru_batched(x, *rnn.layer(0))
        else:
            y, h_t = recurrent_cuda.gru_layer(x, *rnn.layer(0),
                                              h0=None if h0 is None else h0[i])
        h_last.append(h_t)
        if i + 1 < n and residual and x.shape[-1] == y.shape[-1]:
            y = y + x
        x = y
    return x, h_last


def apply_apc(model: APCEncoder, mels: Tensor, residual: bool = False) -> Tensor:
    """[B, T, mel_dim] -> [B, T, hidden] top-layer GRU states.  The residual
    adds a layer's input when the widths match, except after the top layer.
    A CUDA tensor runs each layer in K2, which takes batch 1; a CPU tensor
    takes the plain loop at any batch."""
    return _stack(model, mels, residual)[0]


def encode_fast(model: APCEncoder, mels: Tensor, residual: bool = False) -> Tensor:
    """[T, mel] -> [T, H], the batch-1 inference path: the GRU kernel on a
    CUDA tensor, the plain loop on a CPU tensor."""
    return apply_apc(model, mels[None], residual=residual)[0]


def encode_chunk(model: APCEncoder, mels: Tensor, h: List[Tensor],
                 residual: bool = False) -> Tuple[Tensor, List[Tensor]]:
    """A stream's chunk: [n, mel] and each layer's carried hidden state [H]
    -> ([n, H], the new states); every layer in K2 on a CUDA tensor, from
    the carried state."""
    y, h_last = _stack(model, mels[None], residual, h)
    return y[0], [h_t.reshape(-1) for h_t in h_last]


def apply_apc_pretrain(model: APCPretrain, mels: Tensor, residual: bool = False) -> Tensor:
    """[B, T, mel] -> [B, T, mel] predicted future frames (row t predicts
    input row t + time_shift; the loss aligns them), through the batched,
    differentiable recurrence."""
    h = _stack(model.encoder, mels, residual, batched=True)[0]
    return nn_core.dense(h, model.head)


def load_pretrained_encoder(ckpt_dir: str, cfg: APCConfig,
                            device: torch.device | str = "cuda") -> APCEncoder:
    """The encoder half of a port ``--task apc`` run's checkpoint directory
    (``<checkpoints_dir>/<name>/ckpt``; its ``ckpt_best`` when the run kept
    one, else its latest step), on ``device`` in eval mode; the pretraining
    head is dropped.  A reference ``.model`` file loads through
    utils/convert.load_state_dict instead."""
    from livespeechportraits_torch.utils import checkpoint as ckpt

    sd = ckpt.load_checkpoint(ckpt.prefer_best(ckpt_dir))["models"]["params"]
    enc = APCEncoder(cfg)
    enc.load_state_dict({k[len("encoder."):]: v for k, v in sd.items()
                         if k.startswith("encoder.")}, strict=True)
    return enc.to(device).eval().requires_grad_(False)
