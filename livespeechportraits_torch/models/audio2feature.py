"""Audio2Feature ("Audio2Mouth"): APC features -> mouth 3D-landmark deltas.

Counterpart of the LSTM path of ``livespeechportraits_tpu/models/
audio2feature.py`` (``apply_audio2feature``, ``generate_sequence``):

    pair two 120 Hz APC frames -> [T, 1024]
    -> downsample MLP (1024 -> 512, BatchNorm + LeakyReLU, 512 -> 512)
    -> 3-layer LSTM (512 -> 256)
    -> fc MLP (256 -> 512 -> 512 -> head_dim) with BatchNorm + LeakyReLU

The head is the L2 head (75 = 25 mouth points x 3) or the GMM head, whose
last projection packs [weight logits | means | -log sigma] of
``gmm_ncenter`` components (``head_dim``); inference decodes it to the
chosen component's mean (``decode``).  Parameter names follow the reference
(``downsample.0``, ``LSTM.weight_ih_l0``, ``fc.6``...).  On the card the LSTM
layers run in kernel K3.

The WaveNet decoder variant (JAX audio2feature.py:107-141; the reference
declares it but never defines its options) is ``Audio2FeatureWaveNet``: an
unconditioned WaveNet (``a2f_wavenet_config``) reading the APC features as
its input stream, applied by ``apply_audio2feature_wavenet``.  JAX keeps it
in its model registry and neither trains nor serves it; so does the port
(``models.REGISTRY``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from livespeechportraits_torch.config import Audio2FeatureConfig, WaveNetConfig
from livespeechportraits_torch.models import nn_core, wavenet
from livespeechportraits_torch.ops import gmm, recurrent_cuda

Tensor = torch.Tensor

# Added to the seed of the component draws, so they are not the head-pose
# decode's draws (gmm.draw_noise) of the same seed.
_COMPONENT_STREAM = 0xA2F << 32


def head_dim(cfg: Audio2FeatureConfig) -> int:
    """Width of the last projection: the landmarks for L2, the packed
    [weights | means | -log sigma] block for the GMM head."""
    if cfg.loss == "GMM":
        return (2 * cfg.output_dim + 1) * cfg.gmm_ncenter
    return cfg.output_dim


class Audio2Feature(nn.Module):
    def __init__(self, cfg: Audio2FeatureConfig):
        super().__init__()
        if cfg.decoder != "lstm" or cfg.loss not in ("L2", "GMM"):
            raise NotImplementedError(
                f"Audio2Feature decoder={cfg.decoder!r} loss={cfg.loss!r}: this is the LSTM "
                "decoder with the L2 or GMM head; the WaveNet decoder is "
                "Audio2FeatureWaveNet, which the pipeline does not serve (nor does JAX's)")
        self.cfg = cfg
        H, L = cfg.apc_hidden_size, cfg.lstm_hidden_size
        self.downsample = nn.Sequential(nn.Linear(2 * H, H), nn.BatchNorm1d(H),
                                        nn.LeakyReLU(0.2), nn.Linear(H, H))
        self.LSTM = nn_core.RNNWeights(H, L, cfg.lstm_layers, gates=4)
        self.fc = nn.Sequential(nn.Linear(L, 512), nn.BatchNorm1d(512), nn.LeakyReLU(0.2),
                                nn.Linear(512, 512), nn.BatchNorm1d(512), nn.LeakyReLU(0.2),
                                nn.Linear(512, head_dim(cfg)))

    def reset_parameters(self, gen: torch.Generator) -> None:
        # the JAX init's key order: downsample, LSTM layers, fc
        nn_core.init_normal_(self.downsample, gen)
        nn_core.init_rnn_(self.LSTM, gen)
        nn_core.init_normal_(self.fc, gen)
        nn_core.init_batchnorm_(self)


def _downsample(model: Audio2Feature, pairs: Tensor, training: bool = False) -> Tensor:
    """[N, 2H] paired APC frames -> [N, H] (BatchNorm in eval mode unless
    training)."""
    d = model.downsample
    y = nn_core.leaky_relu(nn_core.batchnorm(nn_core.dense(pairs, d[0]), d[1],
                                             training=training))
    return nn_core.dense(y, d[3])


def _fc(model: Audio2Feature, z: Tensor, training: bool = False) -> Tensor:
    """[N, lstm_hidden] -> [N, output_dim] (BatchNorm as _downsample)."""
    f = model.fc
    z = nn_core.leaky_relu(nn_core.batchnorm(nn_core.dense(z, f[0]), f[1], training=training))
    z = nn_core.leaky_relu(nn_core.batchnorm(nn_core.dense(z, f[3]), f[4], training=training))
    return nn_core.dense(z, f[6])


def apply_audio2feature(model: Audio2Feature, audio_feats: Tensor, training: bool = False,
                        batched: bool = False) -> Tensor:
    """[B, 2T, H] APC features -> [B, T, head_dim]: the head's raw output,
    the GMM block undecoded.
    Pairs of consecutive 120 Hz frames become one 2H vector per frame; the
    BatchNorms run over the [B*T, C] rows.  Inference: a CUDA tensor runs
    each LSTM layer in K3, which takes batch 1; a CPU tensor takes the plain
    loop at any batch.  batched: the trainers' forward, each LSTM layer
    through torch's differentiable RNN operator at any batch, and with
    training the BatchNorms normalise with batch statistics and update their
    running stats (JAX apply_audio2feature(training=True))."""
    B, T2, H = audio_feats.shape
    T = T2 // 2
    y = _downsample(model, audio_feats.reshape(B * T, 2 * H), training).reshape(B, T, H)
    for k in range(model.LSTM.num_layers):
        if batched:
            y, _ = nn_core.lstm_batched(y, *model.LSTM.layer(k))
        else:
            y, _ = recurrent_cuda.lstm_layer(y, *model.LSTM.layer(k))
    return _fc(model, y.reshape(B * T, -1), training).reshape(B, T, -1)


def apply_chunk(model: Audio2Feature, pairs: Tensor,
                state: List[Tuple[Tensor, Tensor]]) -> Tuple[Tensor, List[Tuple[Tensor, Tensor]]]:
    """A stream's chunk: [n, 2H] paired APC frames and each LSTM layer's
    carried (h, c) [H] -> ([n, head_dim], the new states); every layer in
    K3 on a CUDA tensor, from the carried state.  The GMM block comes
    undecoded (see decode)."""
    y = _downsample(model, pairs)[None]
    new_state = []
    for k, (h, c) in enumerate(state):
        y, (h, c) = recurrent_cuda.lstm_layer(y, *model.LSTM.layer(k), state=(h, c))
        new_state.append((h.reshape(-1), c.reshape(-1)))
    return _fc(model, y[0]), new_state


def component_gumbel(n: int, ncenter: int, seed: int, start: int = 0) -> Tensor:
    """[n, ncenter] standard Gumbel draws of the output rows start ..
    start+n-1, each row from the counter hash of (seed, row) alone
    (gmm.step_uniforms), so a stream's chunks draw what the whole clip
    draws."""
    u = gmm.step_uniforms(seed + _COMPONENT_STREAM, n, ncenter, start)
    return torch.from_numpy(-np.log(-np.log(u)).astype(np.float32))


def decode(cfg: Audio2FeatureConfig, preds: Tensor, seed: int = 0, start: int = 0,
           gumbel: Optional[Tensor] = None) -> Tensor:
    """The head's rows [n, head_dim] -> [n, output_dim].  L2 rows pass as they
    are.  A GMM row decodes to its chosen component's mean
    (gmm.sample_gmm at sigma_scale 0): with one component that is its mean;
    with more, row i takes argmax(logits + gumbel[i]), the Gumbel draws of
    output row start + i (component_gumbel) unless ``gumbel`` is given."""
    if cfg.loss != "GMM":
        return preds
    n, C, D = preds.shape[0], cfg.gmm_ncenter, cfg.output_dim
    if gumbel is None:
        gumbel = (preds.new_zeros(n, C) if C == 1
                  else component_gumbel(n, C, seed, start).to(preds.device))
    return gmm.sample_gmm(preds, C, D, gumbel, preds.new_zeros(n, D), sigma_scale=0.0)


def generate_sequence(model: Audio2Feature, audio_feats: Tensor,
                      frame_future: int = 18, seed: int = 0,
                      gumbel: Optional[Tensor] = None) -> Tensor:
    """Whole-utterance inference: [2T, H] APC features -> [T, output_dim].

    The tail is padded with the last feature for ``frame_future`` frames and
    the first ``frame_future`` predictions are dropped, since the model
    predicts that far ahead.  A GMM head decodes every row before the drop
    (decode, with row j's draws those of padded row j; ``gumbel`` [T +
    frame_future, gmm_ncenter] passes them in, as the fused motion program
    does from its device buffer)."""
    T = audio_feats.shape[0] // 2
    feats = audio_feats[:2 * T]
    if frame_future > 0:
        pad = feats[-1:].expand(2 * frame_future, feats.shape[1])
        feats = torch.cat([feats, pad], dim=0)
    preds = decode(model.cfg, apply_audio2feature(model, feats[None])[0], seed=seed,
                   gumbel=gumbel)
    if frame_future > 0:
        preds = preds[frame_future:]
    return preds[:T]


# ---------------------------------------------------------------------------
# The WaveNet decoder variant (JAX audio2feature.py:107-141)
# ---------------------------------------------------------------------------


def a2f_wavenet_config(cfg: Audio2FeatureConfig) -> WaveNetConfig:
    """The variant's WaveNet: 7 layers x 2 blocks, 128 channels, 256 skip,
    kernel 2, no conditioning, the APC features as input."""
    return WaveNetConfig(residual_layers=7, residual_blocks=2, dilation_channels=128,
                         residual_channels=128, skip_channels=256, kernel_size=2,
                         use_bias=True, cond=False, cond_channels=0,
                         input_channels=cfg.apc_hidden_size)


class Audio2FeatureWaveNet(nn.Module):
    """The WaveNet decoder: ``WaveNet.*`` keys, output_dim outputs a frame."""

    def __init__(self, cfg: Audio2FeatureConfig):
        super().__init__()
        self.cfg = cfg
        self.WaveNet = wavenet.WaveNet(a2f_wavenet_config(cfg), cfg.output_dim)

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.WaveNet.reset_parameters(gen)


def apply_audio2feature_wavenet(model: Audio2FeatureWaveNet, audio_feats: Tensor,
                                output_length: Optional[int] = None,
                                dropout_keep: Optional[Tensor] = None) -> Tensor:
    """[B, T, H] APC features -> [B, T (or output_length), output_dim];
    dropout_keep is the input's channel-dropout mask in training
    (wavenet.dropout_keep)."""
    return wavenet.forward(model.WaveNet, audio_feats, None, output_length=output_length,
                           dropout_keep=dropout_keep)
