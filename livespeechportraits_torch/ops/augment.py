"""Audio augmentations for training.

The port's own copy of ``livespeechportraits_tpu/ops/augment.py`` (numpy and
scipy, no JAX; the reference's funcs/audio_funcs.py:145-426).  The
reference's sox / pyworld branches cannot run there (their imports are
commented out); the live ones are implemented with self-contained DSP
(scipy's polyphase resampling, an STFT phase vocoder for time stretching),
so no external binaries are needed:

    inject_gaussian_noise  - audio_funcs.py:152-163
    add_gauss_noise        - the clipped variant, audio_funcs.py:373-381
    pitch_shift            - audio_funcs.py:167-172 (stretch, then resample)
    speed_change           - audio_funcs.py:175-190 (returns the rate, for
                             resampling landmarks or video alike)
    time_mask              - the runnable op of world_augment (op == 3)
    add_background_noise   - SNR-matched mixing, audio_funcs.py:385-418
    random_gain            - the gain branch of sox_augment
    noise_augment          - gaussian or background noise, audio_funcs.py:420-426

Same seeds, same draws, same samples as the JAX package's functions.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
from scipy.signal import resample_poly


def inject_gaussian_noise(data: np.ndarray, noise_factor: float,
                          rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """data + noise_factor * N(0, 1); reasonable factors are [0, 0.01]."""
    rng = rng or np.random.default_rng()
    return (data + noise_factor * rng.normal(0, 1, len(data))).astype(data.dtype)


def add_gauss_noise(wav: np.ndarray, noise_std: float = 0.03,
                    max_wav_value: float = 1.0,
                    rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """audio_funcs.py:373-382: the effective std is U(0,1) * noise_std
    (the reference scales the drawn std by another uniform draw)."""
    rng = rng or np.random.default_rng()
    real_std = float(rng.uniform()) * noise_std
    out = wav + rng.normal(0, real_std, wav.shape)
    return np.clip(out, -max_wav_value, max_wav_value).astype(np.float32)


def _stft_stretch(data: np.ndarray, rate: float, n_fft: int = 2048,
                  hop: int = 512) -> np.ndarray:
    """Phase-vocoder time stretch (librosa.effects.time_stretch semantics:
    rate > 1 speeds up)."""
    if rate == 1.0:
        return data.astype(np.float32)
    window = np.hanning(n_fft).astype(np.float64)
    pad = n_fft // 2
    x = np.pad(data.astype(np.float64), (pad, pad), mode="reflect")
    n_frames = 1 + (len(x) - n_fft) // hop
    frames = np.lib.stride_tricks.sliding_window_view(x, n_fft)[::hop][:n_frames]
    D = np.fft.rfft(frames * window, axis=-1)  # [T, F]

    time_steps = np.arange(0, D.shape[0], rate)
    phi_advance = np.linspace(0, np.pi * hop, D.shape[1])
    out = np.zeros((len(time_steps), D.shape[1]), dtype=complex)
    phase_acc = np.angle(D[0])
    for t, step in enumerate(time_steps):
        i = int(step)
        frac = step - i
        s0 = D[min(i, D.shape[0] - 1)]
        s1 = D[min(i + 1, D.shape[0] - 1)]
        mag = (1 - frac) * np.abs(s0) + frac * np.abs(s1)
        out[t] = mag * np.exp(1j * phase_acc)
        dphase = np.angle(s1) - np.angle(s0) - phi_advance
        dphase -= 2 * np.pi * np.round(dphase / (2 * np.pi))
        phase_acc += phi_advance + dphase

    # overlap-add inverse
    y = np.zeros(n_fft + hop * (out.shape[0] - 1))
    wsum = np.zeros_like(y)
    frames_t = np.fft.irfft(out, n=n_fft, axis=-1)
    for t in range(out.shape[0]):
        y[t * hop : t * hop + n_fft] += frames_t[t] * window
        wsum[t * hop : t * hop + n_fft] += window**2
    y = y / np.maximum(wsum, 1e-8)
    return y[pad : pad + int(round(len(data) / rate))].astype(np.float32)


def speed_change(data: np.ndarray, rate: Optional[float] = None,
                 rng: Optional[np.random.Generator] = None) -> Tuple[np.ndarray, float]:
    """Time-stretch by a random rate in [0.7, 1.3] (higher = faster);
    returns (audio, rate) so landmarks/video can be resampled to match
    (audio_funcs.py:175-190)."""
    rng = rng or np.random.default_rng()
    if rate is None:
        rate = float(rng.uniform(0.7, 1.3))
    return _stft_stretch(data, rate), rate


def pitch_shift(data: np.ndarray, sr: int = 16000, n_steps: Optional[float] = None,
                factor: float = 5.0,
                rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Shift pitch by n_steps semitones (random in [-factor, factor] when
    unset), preserving duration: stretch then resample."""
    rng = rng or np.random.default_rng()
    if n_steps is None:
        n_steps = float(rng.uniform(-factor, factor))
    rate = 2.0 ** (-n_steps / 12.0)
    # librosa semantics: slow down by `rate` (longer for n_steps > 0), then
    # reinterpret at the original length - duration preserved, pitch scaled
    # by 1/rate.
    stretched = _stft_stretch(data, rate)
    # Resample by a factor of `rate` (sr/rate -> sr): the 1/rate-long
    # stretched signal compresses back to the original length, scaling
    # pitch by 1/rate.
    g = math.gcd(int(round(rate * 1000)), 1000)
    up, down = int(round(rate * 1000)) // g, 1000 // g
    out = resample_poly(stretched, up, down)
    if len(out) < len(data):
        out = np.pad(out, (0, len(data) - len(out)))
    return out[: len(data)].astype(np.float32)


def time_mask(wav: np.ndarray, max_mask: int = 1024,
              rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Zero a random span (the only runnable branch of world_augment,
    audio_funcs.py:216-221 op==3)."""
    rng = rng or np.random.default_rng()
    mask_len = int(rng.integers(0, max_mask))
    if mask_len == 0 or mask_len >= wav.shape[0]:
        return wav.copy()
    pos = int(rng.integers(0, wav.shape[0] - mask_len + 1))
    out = wav.copy()
    out[pos : pos + mask_len] = 0
    return out


def random_gain(wav: np.ndarray, low_db: float = -20.0, high_db: float = 5.0,
                rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Peak-normalise then apply a random gain (sox_augment branch 3)."""
    rng = rng or np.random.default_rng()
    peak = np.abs(wav).max()
    normed = wav / peak if peak > 0 else wav
    gain_db = float(rng.uniform(low_db, high_db))
    return (normed * 10.0 ** (gain_db / 20.0)).astype(np.float32)


def _voice_energy(wav: np.ndarray) -> float:
    return float(np.mean(wav.astype(np.float64) ** 2))


def add_background_noise(wav: np.ndarray, noises: Sequence[np.ndarray],
                         min_snr: float = 2.0, max_snr: float = 15.0,
                         rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Mix a random noise clip at a random SNR (dB) like
    audio_funcs.py:385-418."""
    rng = rng or np.random.default_rng()
    noise = noises[int(rng.integers(len(noises)))]
    if len(noise) > len(wav):
        start = int(rng.integers(0, len(noise) - len(wav)))
        noise = noise[start : start + len(wav)]
    else:
        # reference semantics (audio_funcs.py:405-411): a SHORT noise clip
        # is zero-padded and inserted ONCE at a random offset - the rest
        # of the utterance stays clean - not tiled over the whole wav
        n = np.zeros(len(wav), noise.dtype)
        start = int(rng.integers(0, len(wav) - len(noise) + 1))
        n[start : start + len(noise)] = noise
        noise = n
    snr_db = float(rng.uniform(min_snr, max_snr))
    e_w, e_n = _voice_energy(wav), _voice_energy(noise)
    if e_n <= 0:
        return wav.astype(np.float32)
    # sqrt is an intended fix of a reference bug: audio_funcs.py:394-399
    # applies the ENERGY ratio as an AMPLITUDE scale, which lands the mix
    # at twice the requested SNR in dB (README divergences)
    scale = math.sqrt(e_w / (e_n * 10.0 ** (snr_db / 10.0)))
    return np.clip(wav + scale * noise, -1.0, 1.0).astype(np.float32)


def noise_augment(wav: np.ndarray, wav_noises: Optional[Sequence[np.ndarray]] = None,
                  gaussian_prob: float = 0.5,
                  rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Randomly pick gaussian vs background noise (audio_funcs.py:420-426)."""
    rng = rng or np.random.default_rng()
    if wav_noises is None or rng.uniform() < gaussian_prob:
        # reference draw: std ~ U(0.001, 0.02), further scaled by U(0,1)
        # inside add_gauss_noise (audio_funcs.py:421-422)
        return add_gauss_noise(wav, noise_std=float(rng.uniform(0.001, 0.02)),
                               rng=rng)
    return add_background_noise(wav, wav_noises, rng=rng)
