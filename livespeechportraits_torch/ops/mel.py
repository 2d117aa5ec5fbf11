"""Log-mel audio front-end: 120 Hz, 80-d normalised log-mel frames.

Counterpart of ``livespeechportraits_tpu/ops/mel.py`` (``_mel_sequence_impl``
/ ``compute_mel_sequence``): one gather frames the whole utterance, then one
``torch.fft.rfft`` and one mel-filterbank matmul, all in f32.  Each frame is
a 266-sample clip reflect-padded by 189 samples, windowed by a periodic Hann
window zero-padded to n_fft = 512, clips past the end of the audio are
zero-padded, and the log-mel is clamped at 1e-5 and scaled to [0, 1].

The reference's generic Audio2Mel front-end and its companions, which only
tests and tools call (JAX's ``audio_to_mel``, ``mel_energy``,
``mu_law_encode`` / ``mu_law_decode``, ``frame_energy`` and the
Griffin-Lim ``mel_to_audio``), follow at the end, on the same framing.
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


# ---------------------------------------------------------------------------
# The generic Audio2Mel front-end and its companions (the reference's
# audio_funcs.py:56-152; JAX mel.py:113-390)
# ---------------------------------------------------------------------------


def _padded_window(win_length: int, n_fft: int) -> np.ndarray:
    """The periodic Hann window of win_length zero-padded symmetrically to
    n_fft (torch.stft's window when win_length < n_fft)."""
    w = np.zeros(n_fft, dtype=np.float32)
    lpad = (n_fft - win_length) // 2
    w[lpad:lpad + win_length] = _hann_periodic(win_length)
    return w


def _reflect_frames(T: int, n_frames: int, hop: int, width: int, pad: int) -> np.ndarray:
    """[n_frames, width] sample indices of frames hop apart over a signal of T
    samples reflect-padded by pad at both ends."""
    return _reflect_index(np.arange(n_frames)[:, None] * hop + np.arange(width)[None, :] - pad,
                          T)


def audio_to_mel(audio: torch.Tensor, n_fft: int = 512, hop_length: int = 256,
                 win_length: int = 1024, sr: int = SAMPLE_RATE, n_mels: int = 80,
                 fmin: float = 90.0, fmax: float = 7600.0, normalize: bool = True
                 ) -> torch.Tensor:
    """[B, T] (or [T]) audio in [-1, 1] -> [B, n_mels, T'] log-mel (the
    reference's Audio2Mel.forward): reflect padding by (n_fft - hop) // 2,
    frames n_fft long and hop apart windowed by the padded Hann window of
    win_length, |rfft| through the mel filterbank, log clamped at 1e-5 and,
    with normalize, scaled to [0, 1]."""
    if win_length > n_fft:
        raise ValueError(f"win_length ({win_length}) must be <= n_fft ({n_fft}); torch.stft "
                         "imposes the same constraint")
    if audio.dim() == 1:
        audio = audio[None]
    T = audio.shape[1]
    pad = (n_fft - hop_length) // 2
    if T <= pad:
        raise ValueError(f"audio too short for the mel front-end: {T} samples <= reflect pad "
                         f"{pad} (~{pad / sr * 1000:.0f} ms minimum)")
    n_frames = 1 + (T + 2 * pad - n_fft) // hop_length
    dev = audio.device
    idx = torch.as_tensor(_reflect_frames(T, n_frames, hop_length, n_fft, pad), device=dev)
    window = torch.as_tensor(_padded_window(win_length, n_fft), device=dev)
    basis = torch.as_tensor(mel_filterbank(sr, n_fft, n_mels, fmin, fmax), device=dev)
    mag = torch.fft.rfft(audio.float()[:, idx] * window, n=n_fft, dim=-1).abs()
    log_mel = torch.log(torch.clamp(torch.einsum("btf,mf->bmt", mag, basis), min=1e-5))
    return (log_mel - LOG_MEL_MIN) / -LOG_MEL_MIN if normalize else log_mel


def mel_energy(mels: torch.Tensor) -> torch.Tensor:
    """Each frame's energy of a log-mel spectrogram [B, n_mels, T]:
    log(mean(exp(mel))) over the bins (Audio2Mel.get_energy_mel)."""
    return torch.log(torch.exp(mels).mean(dim=1))


def mu_law_encode(x: torch.Tensor, mu: int = 255) -> torch.Tensor:
    """mu-law companding quantised to [0, mu], int32."""
    x = torch.clamp(x, -1.0, 1.0)
    fx = torch.sign(x) * torch.log1p(mu * x.abs()) / math.log1p(float(mu))
    return torch.floor((fx + 1) / 2 * mu + 0.5).to(torch.int32)


def mu_law_decode(y: torch.Tensor, mu: int = 255) -> torch.Tensor:
    """The inverse of mu_law_encode, f32.  The power is taken in float64 and
    rounded once to f32 (torch's f32 pow is off by an ulp at some codes)."""
    fy = 2.0 * (y.float() / mu) - 1.0
    power = torch.pow(float(1 + mu), fy.abs().double()).float()
    return torch.sign(fy) / mu * (power - 1.0)


def frame_energy(audio: torch.Tensor, n_fft: int = 512, hop_length: int = 256,
                 win_length: int = 1024, normalize: bool = True) -> torch.Tensor:
    """Each frame's log-RMS energy [B, T'] (the reference's
    audio_funcs.py:94-104): win_length-sample frames of the reflect-padded
    signal, clamped at 1e-5 before the log."""
    if audio.dim() == 1:
        audio = audio[None]
    T = audio.shape[1]
    pad = (n_fft - hop_length) // 2
    if T <= pad:
        raise ValueError(f"audio too short for frame_energy: {T} samples <= reflect pad {pad}")
    n_frames = 1 + (T + 2 * pad - win_length) // hop_length
    idx = torch.as_tensor(_reflect_frames(T, n_frames, hop_length, win_length, pad),
                          device=audio.device)
    energy = torch.sqrt(torch.mean(audio[:, idx] ** 2, dim=-1))
    energy = torch.log(torch.clamp(energy, min=1e-5))
    return (energy - LOG_MEL_MIN) / -LOG_MEL_MIN if normalize else energy


def mel_to_audio(mel: torch.Tensor, n_fft: int = 512, hop_length: int = 256,
                 win_length: int = 512, sr: int = SAMPLE_RATE, fmin: float = 90.0,
                 fmax: float = 7600.0, n_iter: int = 32, length: int | None = None,
                 normalized: bool = True) -> torch.Tensor:
    """A waveform [length or hop * T'] from a log-mel spectrogram [n_mels, T']
    (normalised, or raw with normalized=False) by Griffin-Lim (the
    reference's Audio2Mel.mel_to_audio): the power spectrum through the
    filterbank's pseudo-inverse clipped at 0, zero phase, then n_iter rounds
    of iSTFT (irfft, window, overlap-add divided by the summed squared
    window) and STFT (reflect-padded frames, rfft) keeping the phase."""
    log_mel = mel * (-LOG_MEL_MIN) + LOG_MEL_MIN if normalized else mel
    power = torch.exp(log_mel) ** 2
    dev = mel.device
    pinv = torch.as_tensor(np.linalg.pinv(mel_filterbank(sr, n_fft, mel.shape[0], fmin, fmax)),
                           device=dev)
    mag = torch.sqrt(torch.clamp(pinv @ power, min=0.0))  # [F, T']
    T_frames = mel.shape[1]
    full = hop_length * T_frames
    length = full if length is None else length
    pad = (n_fft - hop_length) // 2
    window_np = _padded_window(win_length, n_fft)
    window = torch.as_tensor(window_np, device=dev)
    ola = np.arange(T_frames)[:, None] * hop_length + np.arange(n_fft)[None, :]
    wsum = np.zeros(full + 2 * pad, np.float64)
    np.add.at(wsum, ola, np.broadcast_to(window_np.astype(np.float64) ** 2, ola.shape))
    ola_idx = torch.as_tensor(ola.reshape(-1), device=dev)
    inv_wsum = torch.as_tensor(1.0 / np.maximum(wsum, 1e-8), dtype=torch.float32, device=dev)
    n_stft = 1 + (full + 2 * pad - n_fft) // hop_length
    stft_idx = torch.as_tensor(_reflect_frames(full, n_stft, hop_length, n_fft, pad), device=dev)

    def istft(spec: torch.Tensor) -> torch.Tensor:
        frames = torch.fft.irfft(spec, n=n_fft, dim=0).t() * window  # [T', n_fft]
        y = torch.zeros(full + 2 * pad, device=dev).index_add_(0, ola_idx, frames.reshape(-1))
        return (y * inv_wsum)[pad:pad + full]

    angles = torch.ones_like(mag, dtype=torch.complex64)  # zero phase
    for _ in range(n_iter):
        y = istft(mag * angles)
        spec = torch.fft.rfft(y[stft_idx] * window, n=n_fft, dim=-1).t()[:, :T_frames]
        angles = spec / torch.clamp(spec.abs(), min=1e-16)
    y = istft(mag * angles)
    if length <= full:
        return y[:length]
    return torch.nn.functional.pad(y, (0, length - full))
