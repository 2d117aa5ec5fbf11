"""Audio2Headpose: autoregressive conditional WaveNet + GMM head pose.

Counterpart of ``livespeechportraits_tpu/models/audio2headpose.py``
(``_audio_downsample``, ``apply_audio2headpose``, ``_decode_scan``,
``generate_sequence``, and its slow oracle
``generate_sequence_sliding_window``).  The decode
primes the WaveNet ring buffers on R-1 warm-up frames, hoists every layer's
audio projection over all frames into one matmul each, then steps frame by
frame: stream_step, then one GMM sample that becomes the next input.

With ``frame_future`` f and receptive field R, decode step i reads audio row
i+f (rows < 0 clamp to row 0) and the history starts as ``pre_headpose``
repeated.  The decode's state lives in ``DecodeBuffers`` and one step is
``decode_step``, device ops only.  Every decode (the staged path, the
fused motion program of pipeline/motion_graph.py, the stream) runs its
steps through ``decode_steps``: on the card one launch of kernel K5
(ops/decode_cuda.py), which takes the published WaveNet alone, on the
CPU ``decode_step`` in a loop, its plain twin.  Its noise is drawn up
front on the CPU (ops/gmm.draw_noise), so a run draws the same noise on
any device.

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

import torch
from torch import nn

from livespeechportraits_torch.config import Audio2HeadposeConfig
from livespeechportraits_torch.models import nn_core, wavenet
from livespeechportraits_torch.ops import decode_cuda, gmm, recurrent_cuda

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


class DecodeBuffers:
    """The device state of the head-pose decode, which ``decode_step``
    reads and writes in place: the WaveNet's ring buffers (views of one
    tensor, ``ring_flat``), the steps taken (``step``, int64 [1]: the rings'
    slot), the previous sample ``x_prev`` [1, input_channels], and ``rows``
    rows of per-step inputs and outputs: each layer's conditioning
    projections ``fproj`` / ``gproj`` [layers, rows, dilation_channels], the
    noise ``gumbel`` [rows, ncenter] and ``eps`` [rows, ndim], and the
    ``samples`` [rows, ndim]; ``row`` (int64 [1]) is the row the next step
    reads and writes.  The fused motion program keeps one set a subject and
    device."""

    def __init__(self, model: Audio2Headpose, cfg: Audio2HeadposeConfig, rows: int,
                 device: torch.device | str):
        wn = cfg.wavenet
        lens = [d * (wn.kernel_size - 1) for d in wn.dilations]
        dev = torch.device(device)
        self.rows = rows
        self.ring_flat = torch.zeros(sum(lens), wn.residual_channels, device=dev)
        self.ring = [r[None] for r in self.ring_flat.split(lens)]
        self.step = torch.zeros(1, dtype=torch.int64, device=dev)
        self.row = torch.zeros(1, dtype=torch.int64, device=dev)
        self.x_prev = torch.zeros(1, wn.input_channels, device=dev)
        n_layers = len(model.WaveNet.residual_blocks)
        self.fproj = torch.zeros(n_layers, rows, wn.dilation_channels, device=dev)
        self.gproj = torch.zeros_like(self.fproj)
        self.gumbel = torch.zeros(rows, cfg.ncenter, device=dev)
        self.eps = torch.zeros(rows, cfg.ndim, device=dev)
        self.samples = torch.zeros(rows, cfg.ndim, device=dev)

    def state(self) -> Tuple[Tensor, Tensor, Tensor]:
        """(ring_flat, step, x_prev): what a decode carries from step to step."""
        return self.ring_flat, self.step, self.x_prev

    def load_state(self, state: Tuple[Tensor, Tensor, Tensor]) -> None:
        """Copy a carried state (``state()`` of another set) in."""
        for dst, src in zip(self.state(), state):
            dst.copy_(src)

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (
            self.ring_flat, self.step, self.row, self.x_prev, self.fproj, self.gproj,
            self.gumbel, self.eps, self.samples))


def downsample_sequence(model: Audio2Headpose, audio_feats: Tensor) -> Tensor:
    """[2T, H] APC features -> [T, cond] conditioning rows (pairs of rows,
    then the downsample MLP)."""
    T = audio_feats.shape[0] // 2
    return _audio_downsample(model, audio_feats[:2 * T].reshape(T, -1)[None])[0]


def prime_decode(model: Audio2Headpose, cfg: Audio2HeadposeConfig, audio_ds: Tensor,
                 x_warm: Tensor, dec: DecodeBuffers, first: int, nframe: int) -> None:
    """Ready ``dec`` for decode steps ``first`` .. ``first + nframe - 1`` of
    an utterance whose conditioning rows are ``audio_ds`` [T, cond]: with
    first == 0 the ring buffers are primed on R-1 warm-up frames of
    ``x_warm`` [input_channels] (conditioning rows < 0 clamp to row 0), the
    steps taken and x_prev are reset; then the steps' conditioning
    projections (step i reads row i + frame_future) fill rows 0 ..
    nframe - 1 and ``row`` is reset.  Device ops only."""
    net = model.WaveNet
    R = cfg.wavenet.receptive_field
    f = cfg.frame_future
    dev = audio_ds.device
    if first == 0:
        warm_idx = torch.clamp(torch.arange(-(R - 1), 0, device=dev) + f, min=0)
        st = wavenet.stream_init(net, x_warm.expand(1, R - 1, x_warm.shape[-1]),
                                 audio_ds[warm_idx][None])
        for dst, src in zip(dec.ring, st.buffers):
            dst.copy_(src)
        dec.step.zero_()
        dec.x_prev.copy_(x_warm[None])
    write_cond_projections(net, audio_ds[first + f:first + f + nframe], dec)


def write_cond_projections(net: wavenet.WaveNet, cond: Tensor, dec: DecodeBuffers) -> None:
    """The conditioning projections of the rows ``cond`` [n, cond_ch] into
    rows 0 .. n-1 of ``dec``; the next step reads row 0."""
    n = cond.shape[0]
    for li, (fp, gp) in enumerate(wavenet.precompute_cond_projections(net, cond[None])):
        dec.fproj[li, :n].copy_(fp[0])
        dec.gproj[li, :n].copy_(gp[0])
    dec.row.zero_()


def decode_step(model: Audio2Headpose, cfg: Audio2HeadposeConfig, dec: DecodeBuffers,
                sigma_scale: float) -> None:
    """One decode step on ``dec``: the WaveNet step from x_prev with row
    ``row``'s projections, then one GMM sample with row ``row``'s noise,
    written to row ``row`` of the samples and to x_prev; row and step move
    on by one.  Device ops only (no host read); K5's plain twin."""
    row = dec.row
    fsel = dec.fproj.index_select(1, row)  # [layers, 1, dil]
    gsel = dec.gproj.index_select(1, row)
    state = wavenet.StreamState(dec.ring, dec.step)
    _, out = wavenet.stream_step(model.WaveNet, state, dec.x_prev,
                                 cond_proj_t=list(zip(fsel, gsel)))
    x = gmm.sample_gmm(out, cfg.ncenter, cfg.ndim, dec.gumbel.index_select(0, row),
                       dec.eps.index_select(0, row), sigma_scale=sigma_scale)
    dec.samples.index_copy_(0, row, x)
    dec.x_prev.copy_(x)
    dec.row.add_(1)


def decode_steps(model: Audio2Headpose, cfg: Audio2HeadposeConfig, dec: DecodeBuffers, n: int,
                 sigma_scale: float) -> None:
    """n consecutive decode steps on ``dec``, from row ``row``: every decode
    of the port runs here.  The rule: CUDA buffers run in one launch of K5
    (ops/decode_cuda.py), which takes the published A2H WaveNet, 12 GMM
    dimensions and 1 or 2 components and raises on any other config
    (``decode_cuda.unsupported`` says why); CPU buffers run ``decode_step``
    n times."""
    if dec.ring_flat.device.type == "cuda":
        decode_cuda.decode(model, cfg, dec, n, sigma_scale)
        return
    for _ in range(n):
        decode_step(model, cfg, dec, sigma_scale)


def generate_sequence(model: Audio2Headpose, cfg: Audio2HeadposeConfig, audio_feats: Tensor,
                      pre_headpose: Tensor, seed: int = 0, sigma_scale: float = 0.3,
                      noise: Optional[Tuple[Tensor, Tensor]] = None) -> Tensor:
    """Full-utterance decode: [2T, H] APC features -> [T - frame_future, ndim].

    The decode primes the WaveNet ring buffers on R-1 warm-up frames, hoists
    every layer's audio projection over all frames, then steps frame by frame
    (decode_step: stream_step, then one GMM sample that becomes the next
    input); step i reads audio row i + frame_future.

    noise: (gumbel [n, ncenter], eps [n, ndim]) for the n = T - frame_future
    steps; ``gmm.draw_noise(n, ..., seed)`` when None, whose step-i draws
    depend on (seed, i) alone."""
    T = audio_feats.shape[0] // 2
    nframe = T - cfg.frame_future
    if nframe <= 0:
        raise ValueError(f"utterance too short: {T} frames <= frame_future {cfg.frame_future}")
    audio_ds = downsample_sequence(model, audio_feats)
    if noise is None:
        noise = gmm.draw_noise(nframe, cfg.ncenter, cfg.ndim, seed)
    dec = DecodeBuffers(model, cfg, nframe, audio_ds.device)
    prime_decode(model, cfg, audio_ds, pre_headpose, dec, 0, nframe)
    dec.gumbel.copy_(noise[0][:nframe])
    dec.eps.copy_(noise[1][:nframe])
    decode_steps(model, cfg, dec, nframe, float(sigma_scale))
    return dec.samples


def generate_sequence_sliding_window(model: Audio2Headpose, cfg: Audio2HeadposeConfig,
                                     audio_feats: Tensor, pre_headpose: Tensor, seed: int = 0,
                                     sigma_scale: float = 0.3,
                                     noise: Optional[Tuple[Tensor, Tensor]] = None) -> Tensor:
    """The reference's O(T * R) decode loop (JAX
    generate_sequence_sliding_window, audio2headpose.py:189-220), a slow
    oracle: each output frame feeds the whole R-frame history and audio
    window through the WaveNet (apply_audio2headpose, output_length 1).
    Step i samples with step i's draws (gmm.draw_noise(n, ..., seed), or
    ``noise``), as generate_sequence does, so the two are comparable sample
    for sample.  [2T, H] APC features -> [T - frame_future, ndim]."""
    R, f = cfg.wavenet.receptive_field, cfg.frame_future
    T = audio_feats.shape[0] // 2
    nframe = T - f
    if nframe <= 0:
        raise ValueError(f"utterance too short: {T} frames <= frame_future {f}")
    paired = audio_feats[:2 * T].reshape(T, -1)
    audio_pad = torch.cat([paired[:1].expand(R - 1, -1), paired])
    if noise is None:
        noise = gmm.draw_noise(nframe, cfg.ncenter, cfg.ndim, seed)
    gumbel, eps = (n.to(paired.device, torch.float32) for n in noise)
    history = pre_headpose.reshape(1, 1, -1).expand(1, R, -1)
    out = []
    for i in range(nframe):
        preds = apply_audio2headpose(model, history, audio_pad[i + f:i + f + R][None],
                                     output_length=1)
        sample = gmm.sample_gmm(preds, cfg.ncenter, cfg.ndim, gumbel[i:i + 1], eps[i:i + 1],
                                sigma_scale=float(sigma_scale))  # [1, 1, ndim]
        out.append(sample[0, 0])
        history = torch.cat([history[:, 1:], sample], dim=1)
    return torch.stack(out)


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
