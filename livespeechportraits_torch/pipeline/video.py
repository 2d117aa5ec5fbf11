"""Host-side audio and video IO of the PyTorch port.

The port's copy of what it uses from the JAX package's
``pipeline/video.py``: ``load_wav`` (scipy, resampled to 16 kHz mono),
``save_wav``, ``write_video`` (a cv2 DIVX .avi at 60 FPS, muxed with the
audio by ffmpeg when it is on PATH, else the .wav is left beside it),
``save_frames`` (numbered jpgs) and ``make_test_tone``.  cv2 is optional:
``write_video`` raises without it, and ``save_frames`` writes the frames as
one .npy, as the demo does for the video.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from math import gcd
from typing import List, Optional

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly

from livespeechportraits_torch.config import FPS, SAMPLE_RATE

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def load_wav(path: str, target_sr: int = SAMPLE_RATE) -> np.ndarray:
    """A wav file as float32 mono in [-1, 1] at target_sr."""
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        audio = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        audio = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        audio = (data.astype(np.float32) - 128.0) / 128.0
    else:
        audio = data.astype(np.float32)
    if audio.ndim == 2:
        audio = audio.mean(axis=1)
    if sr != target_sr:
        g = gcd(sr, target_sr)
        audio = resample_poly(audio, target_sr // g, sr // g).astype(np.float32)
    return audio


def save_wav(path: str, audio: np.ndarray, sr: int = SAMPLE_RATE) -> None:
    wavfile.write(path, sr, (np.clip(audio, -1, 1) * 32767).astype(np.int16))


def write_video(frames: np.ndarray, output_path: str, audio: Optional[np.ndarray] = None,
                fps: int = FPS, sr: int = SAMPLE_RATE) -> str:
    """frames [T, H, W, 3] uint8 RGB -> .avi (or .mp4 by extension), with the
    audio muxed in when ffmpeg is present, else saved beside the video.
    Returns the video path."""
    if cv2 is None:  # pragma: no cover
        raise RuntimeError("cv2 unavailable; cannot write video")
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    T, H, W, _ = frames.shape
    mp4 = output_path.lower().endswith(".mp4")
    tmp_path = output_path + ".tmp" + os.path.splitext(output_path)[1]
    out = cv2.VideoWriter(tmp_path, cv2.VideoWriter_fourcc(*("mp4v" if mp4 else "DIVX")),
                          fps, (W, H))
    for t in range(T):
        out.write(cv2.cvtColor(frames[t], cv2.COLOR_RGB2BGR))
    out.release()

    if audio is not None:
        wav_path = os.path.splitext(output_path)[0] + ".wav"
        save_wav(wav_path, audio[: int(T * sr / fps)], sr)
        ffmpeg = shutil.which("ffmpeg")
        if ffmpeg is not None:
            # mp4 cannot carry pcm_s16le under a stream copy: aac there
            acodec = ["-c:a", "aac"] if mp4 else ["-c:a", "copy"]
            rc = subprocess.call([ffmpeg, "-y", "-i", tmp_path, "-i", wav_path, "-c:v", "copy",
                                  *acodec, "-shortest", output_path],
                                 stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
            if rc == 0 and os.path.getsize(output_path) > 0:
                os.remove(tmp_path)
                os.remove(wav_path)
                return output_path
            # a failed mux keeps the rendered video, with the wav beside it
            print(f"ffmpeg mux failed (rc={rc}); writing video without embedded audio, "
                  f"wav kept at {wav_path}")
    os.replace(tmp_path, output_path)
    return output_path


def make_test_tone(seconds: float = 3.0, sr: int = SAMPLE_RATE) -> np.ndarray:
    """A 220 Hz tone, amplitude-modulated at 3 Hz: the no-audio fallback."""
    t = np.arange(int(seconds * sr)) / sr
    return (0.3 * np.sin(2 * np.pi * 220 * t)
            * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))).astype(np.float32)


def save_frames(frames: np.ndarray, save_root: str, prefix: str = "pred_") -> List[str]:
    """Numbered jpgs ``<prefix><i>.jpg``, i from 1 (the reference's
    Visualizer.save_images); a [T, H, W] frame is written as grey RGB.
    Without cv2 the frames go to one ``<prefix>frames.npy``.  Returns the
    paths written."""
    os.makedirs(save_root, exist_ok=True)
    if cv2 is None:
        path = os.path.join(save_root, f"{prefix}frames.npy")
        np.save(path, frames)
        return [path]
    paths = []
    for i, frame in enumerate(frames):
        img = frame if frame.ndim == 3 else np.repeat(frame[..., None], 3, axis=-1)
        path = os.path.join(save_root, f"{prefix}{i + 1}.jpg")
        if not cv2.imwrite(path, cv2.cvtColor(img, cv2.COLOR_RGB2BGR)):
            raise OSError(f"cv2 could not write {path}")
        paths.append(path)
    return paths
