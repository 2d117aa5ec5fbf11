"""Log-mel audio front-end: 120 Hz, 80-d normalised log-mel frames.

Counterpart of ``livespeechportraits_tpu/ops/mel.py`` (``_mel_sequence_impl``
/ ``compute_mel_sequence``): one gather frames the whole utterance, then one
``torch.fft.rfft`` and one mel-filterbank matmul, all in f32.  Each frame is
a 266-sample clip reflect-padded by 189 samples, windowed by a periodic Hann
window zero-padded to n_fft = 512, clips past the end of the audio are
zero-padded, and the log-mel is clamped at 1e-5 and scaled to [0, 1].
"""

from __future__ import annotations

import math

import numpy as np
import torch

from livespeechportraits_torch.config import FPS, MEL_RATE, SAMPLE_RATE
from livespeechportraits_torch.ops import device_consts

LOG_MEL_MIN = math.log(1e-5)
MEL_STEP = SAMPLE_RATE * 0.5 / FPS  # 133.33 samples a 120 Hz mel frame
MEL_WIN = SAMPLE_RATE // FPS  # 266 samples a clip


def _hz_to_mel(f) -> np.ndarray:
    """Slaney mel scale: linear below 1 kHz, log above."""
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                    f / f_sp)


def _mel_to_hz(m) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    m * f_sp)


def mel_filterbank(sr: int = SAMPLE_RATE, n_fft: int = 512, n_mels: int = 80,
                   fmin: float = 90.0, fmax: float = 7600.0) -> np.ndarray:
    """[n_mels, 1 + n_fft//2] triangular filterbank, slaney-normalised
    (librosa.filters.mel with the reference's arguments)."""
    fftfreqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_pts = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2:n_mels + 2] - mel_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def _hann_periodic(n: int) -> np.ndarray:
    """torch.hann_window default (periodic=True)."""
    k = np.arange(n, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * k / n))).astype(np.float32)


def _reflect_index(p: np.ndarray, n: int) -> np.ndarray:
    """'reflect' padding index map (edge excluded), valid for |pad| < n."""
    p = np.where(p < 0, -p, p)
    return np.where(p >= n, 2 * (n - 1) - p, p)


def _frame_consts(device: torch.device):
    """(col [512] int64, window [512] f32, basis [80, 257] f32) on
    ``device``, uploaded once: a frame's reflect-padded sample offsets, the
    Hann window zero-padded to n_fft and the mel filterbank."""
    sr, n_fft, n_mels = SAMPLE_RATE, 512, 80
    win_length = sr // FPS  # 266
    pad = (n_fft - sr // MEL_RATE) // 2  # 189

    def window():
        w = np.zeros(n_fft, dtype=np.float32)
        lpad = (n_fft - win_length) // 2
        w[lpad:lpad + win_length] = _hann_periodic(win_length)
        return w

    return (device_consts.const("mel.col", device,
                                lambda: _reflect_index(np.arange(n_fft) - pad, win_length)),
            device_consts.const("mel.window", device, window),
            device_consts.const("mel.basis", device,
                                lambda: mel_filterbank(sr, n_fft, n_mels, 90.0, 7600.0)))


def mel_frames(audio: torch.Tensor, starts) -> torch.Tensor:
    """The normalised log-mel frames [len(starts), 80] whose clips begin at
    ``starts`` (sample indices into ``audio``: an int64 tensor on audio's
    device, or a numpy array, which is uploaded); each clip reads samples
    [start, start + 266), so ``audio`` must hold them.  With ``starts`` on
    the device the frames make no host round trip."""
    dev = audio.device
    col, window, basis = _frame_consts(dev)
    if not isinstance(starts, torch.Tensor):
        starts = torch.as_tensor(np.asarray(starts, np.int64), device=dev)
    idx = starts[:, None] + col[None, :]
    frames = audio.float()[idx] * window  # [n, n_fft]
    mag = torch.fft.rfft(frames, n=512, dim=-1).abs()
    melspec = mag @ basis.t()
    log_mel = torch.log(torch.clamp(melspec, min=1e-5))
    return (log_mel - LOG_MEL_MIN) / -LOG_MEL_MIN


def frame_starts(first: int, stop: int) -> np.ndarray:
    """The first sample of mel frames first .. stop-1 (a fractional hop of
    133.33 samples, floored per frame)."""
    return np.floor(np.arange(first, stop) * MEL_STEP).astype(np.int64)


def frame_start_tensor(first: int, stop: int, device: torch.device) -> torch.Tensor:
    """frame_starts on ``device`` by device arithmetic (the same float64
    product and floor), so no host data is uploaded."""
    i = torch.arange(first, stop, dtype=torch.float64, device=device)
    return torch.floor(i * MEL_STEP).to(torch.int64)


def samples_read(n_frames: int) -> int:
    """The samples that mel frames 0 .. n_frames-1 read: the last clip ends
    there."""
    return int(np.floor((n_frames - 1) * MEL_STEP)) + MEL_WIN


def _mel_sequence_impl(audio: torch.Tensor, n_frames: int) -> torch.Tensor:
    """[N] audio -> [n_frames, 80] normalised log-mel, on audio's device;
    clips past the end of the audio read zeros."""
    padded = torch.cat([audio.float(),
                        audio.new_zeros(SAMPLE_RATE // FPS, dtype=torch.float32)])
    return mel_frames(padded, frame_start_tensor(0, n_frames, audio.device))


def compute_mel_sequence(audio, device: torch.device | str = "cuda") -> torch.Tensor:
    """Frame an utterance into [2 * floor(len/sr*60), 80] log-mel features:
    video frame i yields mel frames 2i and 2i+1.  Empty audio gives [0, 80]."""
    audio = torch.as_tensor(np.asarray(audio, dtype=np.float32), device=device)
    n_frames = 2 * int(audio.shape[0] / SAMPLE_RATE * FPS)
    if n_frames == 0:
        return torch.zeros(0, 80, device=device)
    return _mel_sequence_impl(audio, n_frames)
