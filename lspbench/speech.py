"""Speech-like audio from a seed: a glottal pulse train at a gliding pitch
through three formant resonators, syllables at about 4 a second with an
attack-decay envelope, a little aspiration noise, and pauses between
phrases.  The pipeline's cost does not depend on what is said; the
comparison that decides ``correct`` should judge speech-like input, not a
tone."""

from __future__ import annotations

import numpy as np
import scipy.signal

SAMPLE_RATE = 16000


def _resonator(f: float, bw: float):
    """(b, a) of a second-order all-pole resonance at f Hz with bandwidth
    bw."""
    r = np.exp(-np.pi * bw / SAMPLE_RATE)
    a = [1.0, -2.0 * r * np.cos(2 * np.pi * f / SAMPLE_RATE), r * r]
    return [1.0 - r], a


def speech(seconds: float, rng: np.random.Generator) -> np.ndarray:
    """``seconds`` of float32 audio in [-1, 1] at 16 kHz."""
    n = int(round(seconds * SAMPLE_RATE))
    out = np.zeros(n, np.float64)
    t = 0
    phrase_left = rng.uniform(1.0, 2.5) * SAMPLE_RATE
    f0 = rng.uniform(95.0, 210.0)
    while t < n:
        if phrase_left <= 0:  # a pause between phrases
            t += int(rng.uniform(0.08, 0.35) * SAMPLE_RATE)
            phrase_left = rng.uniform(1.0, 2.5) * SAMPLE_RATE
            f0 = float(np.clip(f0 * rng.uniform(0.85, 1.15), 85.0, 240.0))
            continue
        m = min(int(rng.uniform(0.12, 0.32) * SAMPLE_RATE), n - t)
        # the pitch glides over the syllable; phase-accumulated pulse train
        pitch = f0 * np.linspace(1.0, rng.uniform(0.9, 1.12), m)
        phase = np.cumsum(pitch / SAMPLE_RATE)
        src = np.diff(np.floor(phase), prepend=0.0)  # one impulse a period
        src = scipy.signal.lfilter([1.0], [1.0, -0.95], src)  # glottal tilt
        src += 0.02 * rng.standard_normal(m)  # aspiration
        y = np.zeros(m)
        for f, bw in ((rng.uniform(300, 850), 90.0), (rng.uniform(850, 2300), 120.0),
                      (rng.uniform(2300, 3200), 180.0)):
            b, a = _resonator(f, bw)
            y += scipy.signal.lfilter(b, a, src)
        k = np.arange(m) / m
        env = np.minimum(1.0, k / 0.15) * np.exp(-2.5 * k)
        out[t:t + m] += y * env * rng.uniform(0.5, 1.0)
        t += m
        phrase_left -= m
    peak = np.abs(out).max()
    return (0.6 * out / peak if peak > 0 else out).astype(np.float32)
