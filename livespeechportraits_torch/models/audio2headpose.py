"""Audio2Headpose: autoregressive conditional WaveNet + GMM head pose.

Counterpart of ``livespeechportraits_tpu/models/audio2headpose.py``
(``_audio_downsample``, ``apply_audio2headpose``, ``_decode_scan``,
``generate_sequence``).  The decode
primes the WaveNet ring buffers on R-1 warm-up frames, hoists every layer's
audio projection over all frames into one matmul each, then steps frame by
frame: stream_step, then one GMM sample that becomes the next input.

With ``frame_future`` f and receptive field R, decode step i reads audio row
i+f (rows < 0 clamp to row 0) and the history starts as ``pre_headpose``
repeated.  The decode is a plain Python loop over frames.  Its noise is
drawn up front on the CPU (ops/gmm.draw_noise), so a run draws the same
noise on any device.

The LSTM variant (JAX audio2headpose.py:223-287, the reference's
audio2headpose.py:57-102) is ``Audio2HeadposeLSTM``: the same audio MLP,
three LSTM layers of 256 and an MLP to the GMM parameters, one forward for
the whole utterance (``apply_audio2headpose_lstm``), each frame then
sampled (``generate_sequence_lstm``).  Its recurrence follows Audio2Feature's:
torch's RNN operator when batched (training), kernel K3 (batch 1, H = 256)
on a CUDA tensor at inference, the plain loop on the CPU.  JAX keeps the
variant in its model registry and does not serve it; nor does the port.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from livespeechportraits_torch.config import Audio2HeadposeConfig
from livespeechportraits_torch.models import nn_core, wavenet
from livespeechportraits_torch.ops import gmm, recurrent_cuda

Tensor = torch.Tensor


class Audio2Headpose(nn.Module):
    def __init__(self, cfg: Audio2HeadposeConfig):
        super().__init__()
        if cfg.decoder != "wavenet":
            raise NotImplementedError(f"Audio2Headpose decoder {cfg.decoder!r}: this is the "
                                      "WaveNet decoder; the LSTM variant is "
                                      "Audio2HeadposeLSTM, which the pipeline does not serve "
                                      "(nor does JAX's)")
        H = cfg.apc_hidden_size
        self.audio_downsample = nn.Sequential(nn.Linear(2 * H, H), nn.BatchNorm1d(H),
                                              nn.LeakyReLU(0.2), nn.Linear(H, H))
        self.WaveNet = wavenet.WaveNet(cfg.wavenet, cfg.gmm_output_dim)

    def reset_parameters(self, gen: torch.Generator) -> None:
        nn_core.init_normal_(self.audio_downsample, gen)
        self.WaveNet.reset_parameters(gen)
        nn_core.init_batchnorm_(self)


def _audio_downsample(model: nn.Module, audio: Tensor, training: bool = False) -> Tensor:
    """[B, T, 2H] paired APC frames -> [B, T, H] conditioning (BatchNorm over
    the [B*T, C] rows, in eval mode unless training).  Inference runs the
    two GEMMs in fixed row blocks (nn_core.linear_row_blocks), so row t does
    not depend on T."""
    B, T, D = audio.shape
    d = model.audio_downsample

    def dense(x, layer):
        if training:
            return nn_core.dense(x, layer)
        return nn_core.linear_row_blocks(x, layer.weight, layer.bias)

    x = nn_core.leaky_relu(nn_core.batchnorm(dense(audio.reshape(B * T, D), d[0]), d[1],
                                             training=training))
    return dense(x, d[3]).reshape(B, T, -1)


def apply_audio2headpose(model: Audio2Headpose, history: Tensor, audio_feats: Tensor,
                         output_length: Optional[int] = None, training: bool = False,
                         dropout_keep: Optional[Tensor] = None) -> Tensor:
    """The training / batch forward (JAX apply_audio2headpose): history [B,
    L, 12] pose + velocity and audio_feats [B, L, 2H] paired APC frames ->
    [B, output_length, gmm_output_dim] GMM parameters of the trailing
    output_length frames.  training: batch-statistic BatchNorm, running
    stats updated; dropout_keep: the WaveNet's input dropout mask [B, 1, 12]
    (wavenet.dropout_keep)."""
    cond = _audio_downsample(model, audio_feats, training)
    return wavenet.forward(model.WaveNet, history, cond, output_length=output_length,
                           dropout_keep=dropout_keep)


def _decode_scan(model: Audio2Headpose, cfg: Audio2HeadposeConfig, audio_ds: Tensor,
                 pre_headpose: Tensor, gumbel: Tensor, eps: Tensor, nframe: int,
                 sigma_scale: float) -> Tensor:
    """audio_ds [T, cond_ch] -> [nframe, ndim] sampled poses; gumbel
    [nframe, ncenter] and eps [nframe, ndim] are the per-step noise."""
    net = model.WaveNet
    R = cfg.wavenet.receptive_field
    f = cfg.frame_future
    dev = audio_ds.device

    warm_idx = torch.as_tensor(np.maximum(np.arange(-(R - 1), 0) + f, 0), device=dev)
    x_warm = pre_headpose.expand(1, R - 1, pre_headpose.shape[-1])
    state = wavenet.stream_init(net, x_warm, audio_ds[warm_idx][None])

    step_idx = torch.arange(nframe, device=dev) + f
    cond_proj = wavenet.precompute_cond_projections(net, audio_ds[step_idx][None])

    x_prev = pre_headpose[None]
    samples = []
    for i in range(nframe):
        proj_t = [(fp[:, i], gp[:, i]) for fp, gp in cond_proj]
        state, out = wavenet.stream_step(net, state, x_prev, cond_proj_t=proj_t)
        x_prev = gmm.sample_gmm(out, cfg.ncenter, cfg.ndim, gumbel[i:i + 1], eps[i:i + 1],
                                sigma_scale=sigma_scale)
        samples.append(x_prev)
    return torch.cat(samples, dim=0)


def generate_sequence(model: Audio2Headpose, cfg: Audio2HeadposeConfig, audio_feats: Tensor,
                      pre_headpose: Tensor, seed: int = 0, sigma_scale: float = 0.3,
                      noise: Optional[Tuple[Tensor, Tensor]] = None) -> Tensor:
    """Full-utterance decode: [2T, H] APC features -> [T - frame_future, ndim].

    noise: (gumbel [n, ncenter], eps [n, ndim]) for the n = T - frame_future
    steps; ``gmm.draw_noise(n, ..., seed)`` when None, whose step-i draws
    depend on (seed, i) alone."""
    T = audio_feats.shape[0] // 2
    paired = audio_feats[:2 * T].reshape(T, -1)[None]
    audio_ds = _audio_downsample(model, paired)[0]
    nframe = T - cfg.frame_future
    if nframe <= 0:
        raise ValueError(f"utterance too short: {T} frames <= frame_future {cfg.frame_future}")
    if noise is None:
        noise = gmm.draw_noise(nframe, cfg.ncenter, cfg.ndim, seed)
    gumbel, eps = (n.to(audio_ds.device, torch.float32) for n in noise)
    return _decode_scan(model, cfg, audio_ds, pre_headpose, gumbel, eps, nframe,
                        float(sigma_scale))


# ---------------------------------------------------------------------------
# The LSTM variant (JAX audio2headpose.py:223-287)
# ---------------------------------------------------------------------------

LSTM_HIDDEN = 256  # the reference's fixed width, whatever the config


class Audio2HeadposeLSTM(nn.Module):
    """``audio_downsample.*`` as the WaveNet model's, ``LSTM.*`` (three
    layers of 256) and ``fc.*`` (256 -> 512 -> 512 -> gmm_output_dim, with
    BatchNorm and LeakyReLU): the reference's key names."""

    def __init__(self, cfg: Audio2HeadposeConfig):
        super().__init__()
        self.cfg = cfg
        H, L = cfg.apc_hidden_size, LSTM_HIDDEN
        self.audio_downsample = nn.Sequential(nn.Linear(2 * H, H), nn.BatchNorm1d(H),
                                              nn.LeakyReLU(0.2), nn.Linear(H, H))
        self.LSTM = nn_core.RNNWeights(H, L, 3, gates=4)
        self.fc = nn.Sequential(nn.Linear(L, 512), nn.BatchNorm1d(512), nn.LeakyReLU(0.2),
                                nn.Linear(512, 512), nn.BatchNorm1d(512), nn.LeakyReLU(0.2),
                                nn.Linear(512, cfg.gmm_output_dim))

    def reset_parameters(self, gen: torch.Generator) -> None:
        nn_core.init_normal_(self.audio_downsample, gen)
        nn_core.init_rnn_(self.LSTM, gen)
        nn_core.init_normal_(self.fc, gen)
        nn_core.init_batchnorm_(self)


def apply_audio2headpose_lstm(model: Audio2HeadposeLSTM, audio_feats: Tensor,
                              training: bool = False, batched: bool = False) -> Tensor:
    """[B, T, 2H] paired APC frames -> [B, T, gmm_output_dim], one forward
    (not autoregressive).  As Audio2Feature's forward: batched runs each
    LSTM layer through torch's RNN operator (the trainers' path) and, with
    training, the BatchNorms on batch statistics; otherwise a CUDA tensor
    runs each layer in K3 (batch 1) and a CPU tensor the plain loop."""
    y = _audio_downsample(model, audio_feats, training)
    for k in range(model.LSTM.num_layers):
        if batched:
            y, _ = nn_core.lstm_batched(y, *model.LSTM.layer(k))
        else:
            y, _ = recurrent_cuda.lstm_layer(y, *model.LSTM.layer(k))
    B, T, _ = y.shape
    f = model.fc
    z = y.reshape(B * T, -1)
    z = nn_core.leaky_relu(nn_core.batchnorm(nn_core.dense(z, f[0]), f[1], training=training))
    z = nn_core.leaky_relu(nn_core.batchnorm(nn_core.dense(z, f[3]), f[4], training=training))
    return nn_core.dense(z, f[6]).reshape(B, T, -1)


def generate_sequence_lstm(model: Audio2HeadposeLSTM, audio_feats: Tensor, seed: int = 0,
                           sigma_scale: float = 0.3,
                           noise: Optional[Tuple[Tensor, Tensor]] = None) -> Tensor:
    """Whole-utterance inference: [2T, H] APC features -> [T, ndim], frame i
    sampled from its GMM with the noise of step i (gmm.draw_noise(T, ...,
    seed) unless ``noise`` is given).  On the card the recurrence is K3."""
    cfg = model.cfg
    T = audio_feats.shape[0] // 2
    preds = apply_audio2headpose_lstm(model, audio_feats[:2 * T].reshape(T, -1)[None])[0]
    if noise is None:
        noise = gmm.draw_noise(T, cfg.ncenter, cfg.ndim, seed)
    gumbel, eps = (n.to(preds.device, torch.float32) for n in noise)
    return gmm.sample_gmm(preds, cfg.ncenter, cfg.ndim, gumbel, eps, sigma_scale=float(sigma_scale))
