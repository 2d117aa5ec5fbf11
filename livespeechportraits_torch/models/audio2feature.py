"""Audio2Feature ("Audio2Mouth"): APC features -> mouth 3D-landmark deltas.

Counterpart of the LSTM path of ``livespeechportraits_tpu/models/
audio2feature.py`` (``apply_audio2feature``, ``generate_sequence``):

    pair two 120 Hz APC frames -> [T, 1024]
    -> downsample MLP (1024 -> 512, BatchNorm + LeakyReLU, 512 -> 512)
    -> 3-layer LSTM (512 -> 256)
    -> fc MLP (256 -> 512 -> 512 -> 75) with BatchNorm + LeakyReLU

Parameter names follow the reference (``downsample.0``, ``LSTM.weight_ih_l0``,
``fc.6``...).  On the card the LSTM layers run in kernel K3.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
from torch import nn

from livespeechportraits_torch.config import Audio2FeatureConfig
from livespeechportraits_torch.models import nn_core
from livespeechportraits_torch.ops import recurrent_cuda

Tensor = torch.Tensor


class Audio2Feature(nn.Module):
    def __init__(self, cfg: Audio2FeatureConfig):
        super().__init__()
        if cfg.decoder != "lstm" or cfg.loss != "L2":
            raise NotImplementedError(
                f"Audio2Feature decoder={cfg.decoder!r} loss={cfg.loss!r}: only the "
                "LSTM decoder with the L2 head is ported")
        H, L = cfg.apc_hidden_size, cfg.lstm_hidden_size
        self.downsample = nn.Sequential(nn.Linear(2 * H, H), nn.BatchNorm1d(H),
                                        nn.LeakyReLU(0.2), nn.Linear(H, H))
        self.LSTM = nn_core.RNNWeights(H, L, cfg.lstm_layers, gates=4)
        self.fc = nn.Sequential(nn.Linear(L, 512), nn.BatchNorm1d(512), nn.LeakyReLU(0.2),
                                nn.Linear(512, 512), nn.BatchNorm1d(512), nn.LeakyReLU(0.2),
                                nn.Linear(512, cfg.output_dim))

    def reset_parameters(self, gen: torch.Generator) -> None:
        # the JAX init's key order: downsample, LSTM layers, fc
        nn_core.init_normal_(self.downsample, gen)
        nn_core.init_rnn_(self.LSTM, gen)
        nn_core.init_normal_(self.fc, gen)
        nn_core.init_batchnorm_(self)


def _downsample(model: Audio2Feature, pairs: Tensor) -> Tensor:
    """[N, 2H] paired APC frames -> [N, H] (eval-mode BatchNorm)."""
    d = model.downsample
    y = nn_core.leaky_relu(nn_core.batchnorm(nn_core.dense(pairs, d[0]), d[1]))
    return nn_core.dense(y, d[3])


def _fc(model: Audio2Feature, z: Tensor) -> Tensor:
    """[N, lstm_hidden] -> [N, output_dim] (eval-mode BatchNorm)."""
    f = model.fc
    z = nn_core.leaky_relu(nn_core.batchnorm(nn_core.dense(z, f[0]), f[1]))
    z = nn_core.leaky_relu(nn_core.batchnorm(nn_core.dense(z, f[3]), f[4]))
    return nn_core.dense(z, f[6])


def apply_audio2feature(model: Audio2Feature, audio_feats: Tensor) -> Tensor:
    """[B, 2T, H] APC features -> [B, T, output_dim] (eval-mode BatchNorm).
    Pairs of consecutive 120 Hz frames become one 2H vector per frame.  A
    CUDA tensor runs each LSTM layer in K3, which takes batch 1; a CPU tensor
    takes the plain loop at any batch."""
    B, T2, H = audio_feats.shape
    T = T2 // 2
    y = _downsample(model, audio_feats.reshape(B * T, 2 * H)).reshape(B, T, H)
    for k in range(model.LSTM.num_layers):
        y, _ = recurrent_cuda.lstm_layer(y, *model.LSTM.layer(k))
    return _fc(model, y.reshape(B * T, -1)).reshape(B, T, -1)


def apply_chunk(model: Audio2Feature, pairs: Tensor,
                state: List[Tuple[Tensor, Tensor]]) -> Tuple[Tensor, List[Tuple[Tensor, Tensor]]]:
    """A stream's chunk: [n, 2H] paired APC frames and each LSTM layer's
    carried (h, c) [H] -> ([n, output_dim], the new states); every layer in
    K3 on a CUDA tensor, from the carried state."""
    y = _downsample(model, pairs)[None]
    new_state = []
    for k, (h, c) in enumerate(state):
        y, (h, c) = recurrent_cuda.lstm_layer(y, *model.LSTM.layer(k), state=(h, c))
        new_state.append((h.reshape(-1), c.reshape(-1)))
    return _fc(model, y[0]), new_state


def generate_sequence(model: Audio2Feature, audio_feats: Tensor,
                      frame_future: int = 18) -> Tensor:
    """Whole-utterance inference: [2T, H] APC features -> [T, output_dim].

    The tail is padded with the last feature for ``frame_future`` frames and
    the first ``frame_future`` predictions are dropped, since the model
    predicts that far ahead."""
    T = audio_feats.shape[0] // 2
    feats = audio_feats[:2 * T]
    if frame_future > 0:
        pad = feats[-1:].expand(2 * frame_future, feats.shape[1])
        feats = torch.cat([feats, pad], dim=0)
    preds = apply_audio2feature(model, feats[None])[0]
    if frame_future > 0:
        preds = preds[frame_future:]
    return preds[:T]
