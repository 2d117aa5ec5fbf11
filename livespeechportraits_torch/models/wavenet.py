"""Conditional dilated-causal WaveNet with exact incremental decoding.

Counterpart of ``livespeechportraits_tpu/models/wavenet.py`` (``forward``,
``stream_init``, ``stream_step``, ``precompute_cond_projections``).  The
public functions keep the JAX layout [B, T, C]; ``forward`` runs its
convolutions in [B, C, T].  Parameter names follow the reference
(``start_conv1``, ``residual_blocks.{i}.filter_conv``, ``end_conv_2``...).

Streaming keeps, per layer, a ring buffer of the layer's last ``dilation``
trunk inputs, so a decode step costs O(layers) instead of re-running the
receptive field.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from livespeechportraits_torch.config import WaveNetConfig
from livespeechportraits_torch.models import nn_core

Tensor = torch.Tensor


class ResidualBlock(nn.Module):
    def __init__(self, cfg: WaveNetConfig):
        super().__init__()
        res, dil, k = cfg.residual_channels, cfg.dilation_channels, cfg.kernel_size
        self.filter_conv = nn.Conv1d(res, dil, k, bias=cfg.use_bias)
        self.gate_conv = nn.Conv1d(res, dil, k, bias=cfg.use_bias)
        self.residual_conv = nn.Conv1d(dil, res, 1, bias=cfg.use_bias)
        self.skip_conv = nn.Conv1d(dil, cfg.skip_channels, 1, bias=cfg.use_bias)
        if cfg.cond:
            self.cond_filter_conv = nn.Conv1d(cfg.cond_channels, dil, 1)
            self.cond_gate_conv = nn.Conv1d(cfg.cond_channels, dil, 1)


class WaveNet(nn.Module):
    def __init__(self, cfg: WaveNetConfig, output_channels: int):
        super().__init__()
        self.cfg = cfg
        self.start_conv1 = nn.Conv1d(cfg.input_channels, cfg.residual_channels, 1)
        self.start_conv2 = nn.Conv1d(cfg.residual_channels, cfg.residual_channels, 1)
        self.residual_blocks = nn.ModuleList(
            [ResidualBlock(cfg) for _ in range(cfg.residual_blocks * cfg.residual_layers)])
        self.end_conv_1 = nn.Conv1d(cfg.skip_channels, output_channels, 1)
        self.end_conv_2 = nn.Conv1d(output_channels, output_channels, 1)

    def reset_parameters(self, gen: torch.Generator) -> None:
        nn_core.init_normal_(self, gen)


def _activation(cfg: WaveNetConfig, x: Tensor) -> Tensor:
    if cfg.activation == "relu":
        return torch.relu(x)
    return nn_core.leaky_relu(x, 0.2)


def dropout_keep(gen: torch.Generator, batch: int, channels: int,
                 device: torch.device | str) -> Tensor:
    """A channel-dropout keep mask [B, 1, C], p = 0.5, drawn on the CPU from
    ``gen`` (so a seed gives the same masks on any device) and moved to
    ``device``.  JAX draws its mask from a key; the two are not the same
    numbers."""
    return (torch.rand(batch, 1, channels, generator=gen) < 0.5).to(device)


def forward(net: WaveNet, x: Tensor, cond: Optional[Tensor] = None,
            return_layer_inputs: bool = False, output_length: Optional[int] = None,
            dropout_keep: Optional[Tensor] = None):
    """Whole-window forward: x [B, T, input_channels], cond [B, T, cond_ch]
    -> [B, T, output_channels] (and each gated layer's trunk input,
    [B, T, residual_channels], when asked).  output_length keeps the trailing
    frames; dropout_keep [B, 1, input_channels] is the input's channel
    dropout in training (kept channels scaled by 2, p = 0.5)."""
    cfg = net.cfg
    if dropout_keep is not None:
        x = torch.where(dropout_keep, x / 0.5, torch.zeros((), dtype=x.dtype, device=x.device))
    if cond is None and cfg.cond:
        raise ValueError("cfg.cond=True but no conditioning was passed")
    h = x.transpose(1, 2)
    c = None if cond is None else cond.transpose(1, 2)
    h = _activation(cfg, nn_core.conv1d(h, net.start_conv1))
    h = _activation(cfg, nn_core.conv1d(h, net.start_conv2))
    skip = 0.0
    layer_inputs: List[Tensor] = []
    for blk, dilation in zip(net.residual_blocks, cfg.dilations):
        if return_layer_inputs:
            layer_inputs.append(h.transpose(1, 2))
        pad = ((cfg.kernel_size - 1) * dilation, 0)
        f = nn_core.conv1d(h, blk.filter_conv, dilation=dilation, padding=pad)
        g = nn_core.conv1d(h, blk.gate_conv, dilation=dilation, padding=pad)
        if c is not None and hasattr(blk, "cond_filter_conv"):
            f = f + nn_core.conv1d(c, blk.cond_filter_conv)
            g = g + nn_core.conv1d(c, blk.cond_gate_conv)
        z = torch.tanh(f) * torch.sigmoid(g)
        h = nn_core.conv1d(z, blk.residual_conv) + h
        skip = skip + nn_core.conv1d(z, blk.skip_conv)
    out = nn_core.conv1d(_activation(cfg, skip), net.end_conv_1)
    out = nn_core.conv1d(_activation(cfg, out), net.end_conv_2).transpose(1, 2)
    if output_length is not None:
        out = out[:, -output_length:]
    if return_layer_inputs:
        return out, layer_inputs
    return out


@dataclass
class StreamState:
    """Per-layer ring buffers [B, d_l, residual_channels] and the number of
    steps taken, an int64 tensor [1] on the buffers' device.  Slot (step %
    d_l) of layer l holds that layer's trunk input from d_l steps ago;
    stream_step reads it and overwrites it in place with the current input.
    The slot is device arithmetic on the step, so a CUDA graph of a step
    replays with the step it finds.  (JAX shifts each buffer by one and
    appends, which copies the whole buffer every step; the circular index is
    the same sequence of values.)"""

    buffers: List[Tensor]
    step: Tensor


def stream_init(net: WaveNet, x_hist: Tensor, cond_hist: Optional[Tensor] = None
                ) -> StreamState:
    """Prime the ring buffers from a history window x_hist [B, L, C], L >= 1
    (missing history is zero, like the convolution's padding)."""
    cfg = net.cfg
    _, layer_inputs = forward(net, x_hist, cond_hist, return_layer_inputs=True)
    B, L, _ = x_hist.shape
    buffers = []
    for trunk, dilation in zip(layer_inputs, cfg.dilations):
        d = dilation * (cfg.kernel_size - 1)
        if L >= d:
            buf = trunk[:, L - d:, :]
        else:
            buf = torch.cat([trunk.new_zeros(B, d - L, trunk.shape[2]), trunk], dim=1)
        buffers.append(buf.contiguous())
    return StreamState(buffers, torch.zeros(1, dtype=torch.int64, device=x_hist.device))


def _pointwise(x: Tensor, conv: nn.Conv1d) -> Tensor:
    """A 1x1 Conv1d applied to [..., C] rows."""
    return F.linear(x, conv.weight[:, :, 0], conv.bias)


def _tap(conv: nn.Conv1d, k: int) -> Tensor:
    """Kernel tap k of a conv as an [in, out] matrix."""
    return conv.weight[:, :, k].t()


def stream_step(net: WaveNet, state: StreamState, x_t: Tensor,
                cond_proj_t: Optional[Sequence[Tuple[Tensor, Tensor]]] = None
                ) -> Tuple[StreamState, Tensor]:
    """One causal step: x_t [B, input_channels] -> [B, output_channels].

    Conditioning comes as this step's per-layer (filter, gate) projections
    (cond_proj_t, from precompute_cond_projections).  The ring buffers and
    the step are updated in place, by device ops only (no host read), so the
    step can be captured in a CUDA graph."""
    cfg = net.cfg
    if cfg.kernel_size != 2:
        raise NotImplementedError("streaming decode supports kernel_size=2")
    h = _activation(cfg, _pointwise(x_t, net.start_conv1))
    h = _activation(cfg, _pointwise(h, net.start_conv2))
    skip = 0.0
    slots = {}  # ring length -> this step's slot [1]
    for li, (blk, buf) in enumerate(zip(net.residual_blocks, state.buffers)):
        d = buf.shape[1]
        if d not in slots:
            slots[d] = torch.remainder(state.step, d)
        slot = slots[d]
        x_old = buf.index_select(1, slot)[:, 0]  # trunk input at t - dilation
        f = x_old @ _tap(blk.filter_conv, 0) + h @ _tap(blk.filter_conv, 1)
        g = x_old @ _tap(blk.gate_conv, 0) + h @ _tap(blk.gate_conv, 1)
        if blk.filter_conv.bias is not None:
            f = f + blk.filter_conv.bias
            g = g + blk.gate_conv.bias
        if cond_proj_t is not None:
            f = f + cond_proj_t[li][0]
            g = g + cond_proj_t[li][1]
        z = torch.tanh(f) * torch.sigmoid(g)
        s = _pointwise(z, blk.skip_conv)
        skip = skip + s
        buf.index_copy_(1, slot, h[:, None, :])
        h = _pointwise(z, blk.residual_conv) + h
    out = _pointwise(_activation(cfg, skip), net.end_conv_1)
    out = _pointwise(_activation(cfg, out), net.end_conv_2)
    state.step.add_(1)
    return state, out


def precompute_cond_projections(net: WaveNet, cond: Tensor) -> List[Tuple[Tensor, Tensor]]:
    """All layers' 1x1 conditioning projections over a whole sequence:
    cond [B, T, cond_ch] -> per layer ([B, T, dil_ch], [B, T, dil_ch]), in
    fixed row blocks (nn_core.linear_row_blocks), so step t's projection
    does not depend on T."""
    out = []
    for blk in net.residual_blocks:
        if not hasattr(blk, "cond_filter_conv"):
            raise ValueError("the WaveNet has no conditioning projections")
        out.append(tuple(nn_core.linear_row_blocks(cond, c.weight[:, :, 0], c.bias)
                         for c in (blk.cond_filter_conv, blk.cond_gate_conv)))
    return out
