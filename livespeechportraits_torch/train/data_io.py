"""Reference-format training-data ingestion.

Counterpart of ``livespeechportraits_tpu/train/data_io.py``, itself the
data-loading halves of the reference's datasets/audiovisual_dataset.py:114-208
and datasets/face_dataset.py:70-159:

* ``compute_apc_features``: a clip's wav -> mel -> APC features, each GRU
  layer in kernel K2 on the card (onboarding's bank and the trainers'
  features alike);
* ``prepare_clip``: a clip's wav (the denoised one when present), its APC
  features computed once and cached next to it as
  ``<clip>_APC_feature_torch_<digest>.npy`` (the port's own tag: a cache the
  JAX package wrote is never taken for the port's), its ``3d_fit_data.npz``
  and tracked points, as a ``datasets.ClipData``;
* ``LazyH5Frames``: the clip's h5 JPEG frame store decoded a frame at a time
  through ``utils/h5vlen`` (the card's machine has no h5py), with a bounded
  LRU cache;
* ``load_face_clip``: frames, landmarks, shoulders and the four candidates
  (normalised and cached on first run) as a ``datasets.FaceFrameSampler``;
* ``make_change_paras_normalise``: the clip's frame normalisation.
"""

from __future__ import annotations

import io
import os
import zlib
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch
from torch import nn

from livespeechportraits_torch.config import APCConfig
from livespeechportraits_torch.models import apc as apc_model
from livespeechportraits_torch.models.apc import APCEncoder
from livespeechportraits_torch.ops import mel as mel_ops
from livespeechportraits_torch.pipeline import video as video_mod
from livespeechportraits_torch.train import datasets
from livespeechportraits_torch.utils import h5vlen

FRAME_SIZE = 512  # the normalised crop every clip's frames are cut to
CACHE_FRAMES = 64  # decoded frames LazyH5Frames keeps (~50 MB at 512^2)


@torch.no_grad()
def compute_apc_features(audio: np.ndarray, apc: APCEncoder,
                         residual: bool = False) -> np.ndarray:
    """wav [-1, 1] at 16 kHz -> [2T, hidden] float32 APC features, on the
    encoder's device: each GRU layer in kernel K2 on the card
    (apc.encode_fast).  ``residual`` must match the encoder's training flag
    (cfg.apc.residual)."""
    dev = next(apc.parameters()).device
    mel80 = mel_ops.compute_mel_sequence(audio, device=dev)
    return apc_model.encode_fast(apc, mel80, residual=residual).cpu().numpy()


def _params_digest(model: nn.Module) -> str:
    """A cheap stable digest of a model's weights: crc32 over the bytes of
    its state dict's tensors, in order."""
    crc = 0
    for v in model.state_dict().values():
        crc = zlib.crc32(np.ascontiguousarray(v.detach().cpu().numpy()).tobytes(), crc)
    return f"{crc:08x}"


def clip_wav_path(clip_root: str, clip_name: str) -> str:
    """The clip's wav: <clip_name>_denoise.wav when present, else
    <clip_name>.wav."""
    den = os.path.join(clip_root, clip_name + "_denoise.wav")
    return den if os.path.exists(den) else os.path.join(clip_root, clip_name + ".wav")


def prepare_clip(clip_root: str, clip_name: str, apc: APCEncoder,
                 apc_cfg: APCConfig) -> datasets.ClipData:
    """One reference-format clip directory as a ClipData.

    Reads <clip_root>/<clip_name>{_denoise,}.wav (the denoised one first),
    3d_fit_data.npz and, when present, tracked3D_normalized_pts_fix_contour.npy
    (else the fit's pts_3d); the points are taken about the subject's
    <data root>/mean_pts3d.npy (JAX's default use_delta_pts, the only
    setting its training CLI uses).  The APC features are computed on the
    encoder's device (K2 on the card) and cached next to the wav as
    <clip>_APC_feature_torch_<digest>.npy, the digest over the encoder's
    weights, so switching encoders computes them anew."""
    cache = os.path.join(clip_root, f"{clip_name}_APC_feature_torch_{_params_digest(apc)}.npy")
    if os.path.exists(cache):
        feats = np.load(cache).astype(np.float32)
    else:
        audio = video_mod.load_wav(clip_wav_path(clip_root, clip_name))
        feats = compute_apc_features(audio, apc, residual=apc_cfg.residual)
        np.save(cache, feats)

    fit = np.load(os.path.join(clip_root, "3d_fit_data.npz"))
    tracked_path = os.path.join(clip_root, "tracked3D_normalized_pts_fix_contour.npy")
    if os.path.exists(tracked_path):
        pts3d = np.load(tracked_path).astype(np.float32)
    else:
        pts3d = fit["pts_3d"].astype(np.float32)
    pts3d = pts3d - np.load(os.path.join(os.path.dirname(os.path.normpath(clip_root)),
                                         "mean_pts3d.npy"))
    return datasets.make_clip(audio_features=feats, pts3d=pts3d,
                              rot_angles=fit["rot_angles"].astype(np.float32),
                              trans=fit["trans"][:, :, 0].astype(np.float32))


class LazyH5Frames:
    """A clip's h5 JPEG frame store, decoded a frame at a time.

    The reference decodes a frame per ``__getitem__`` (face_dataset.py:190-
    193); a real clip is ~18k frames of 512^2 RGB (~14 GB decoded), too much
    to hold.  This holds the store (memory-mapped by utils/h5vlen, opened at
    first access) and the crop normalisation; frames decode on access
    through an LRU cache of the last CACHE_FRAMES.  ``len()``, ``[i]`` and
    ``.shape`` mirror an [N, 512, 512, 3] uint8 array, so FaceFrameSampler
    takes either."""

    def __init__(self, h5_path: str, key: str, normalise):
        self._path, self._key, self._normalise = h5_path, key, normalise
        self._reader: Optional[h5vlen.Reader] = None
        self._n = h5vlen.length(h5_path, key)
        self._cache: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self.shape = (self._n, FRAME_SIZE, FRAME_SIZE, 3)

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i) -> np.ndarray:
        from PIL import Image

        i = int(i)
        if i < 0:
            i += self._n
        if i in self._cache:
            self._cache.move_to_end(i)
            return self._cache[i]
        if self._reader is None:
            self._reader = h5vlen.Reader(self._path, self._key)
        img = self._normalise(np.asarray(Image.open(io.BytesIO(self._reader[i]))))
        self._cache[i] = img
        if len(self._cache) > CACHE_FRAMES:
            self._cache.popitem(last=False)
        return img

    def close(self) -> None:
        """Unmap the store (a later access maps it again)."""
        if self._reader is not None:
            self._reader.close()
            self._reader = None


def make_change_paras_normalise(clip_root: str):
    """The clip's frame normalisation as a function of a uint8 frame: resize
    by change_paras.npz's scale, then the 512 x 512 crop around (xc, yc),
    zero-padded where it leaves the frame."""
    from PIL import Image

    paras = np.load(os.path.join(clip_root, "change_paras.npz"))
    scale, xc, yc = float(paras["scale"]), int(paras["xc"]), int(paras["yc"])
    half = FRAME_SIZE // 2

    def normalise(img: np.ndarray) -> np.ndarray:
        im = Image.fromarray(img)
        w, h = im.size
        arr = np.asarray(im.resize((int(w * scale), int(h * scale))))
        x0, x1, y0, y1 = xc - half, xc + half, yc - half, yc + half
        out = np.zeros((FRAME_SIZE, FRAME_SIZE, 3), arr.dtype)
        sx0, sx1 = max(x0, 0), min(x1, arr.shape[1])
        sy0, sy1 = max(y0, 0), min(y1, arr.shape[0])
        out[sy0 - y0:sy1 - y0, sx0 - x0:sx1 - x0] = arr[sy0:sy1, sx0:sx1]
        return out

    return normalise


def load_face_clip(clip_root: str, clip_name: str, load_size: int = 512,
                   frame_jump: int = 1) -> datasets.FaceFrameSampler:
    """A reference-format renderer-training clip as a FaceFrameSampler: the
    h5 frames (LazyH5Frames), tracked2D_normalized_pts_fix_contour.npy,
    normalized_shoulder_points.npy and candidates/normalized_full_{0..3}.jpg.
    A candidate missing there is normalised from candidates/full_{j}.jpg,
    saved, and read back from the JPEG, so the first run trains on the
    pixels every later run (and serving) reads.  No training step uses the
    weight mask (the reference's MaskedL1 call is commented out), so the
    sampler emits none.  frame_jump samples every n-th frame."""
    from PIL import Image

    normalise = make_change_paras_normalise(clip_root)
    images = LazyH5Frames(os.path.join(clip_root, clip_name + ".h5"), clip_name, normalise)
    landmarks = np.load(os.path.join(clip_root, "tracked2D_normalized_pts_fix_contour.npy"))
    shoulders = np.load(os.path.join(clip_root, "normalized_shoulder_points.npy"))
    cands = []
    for j in range(4):
        norm_path = os.path.join(clip_root, "candidates", f"normalized_full_{j}.jpg")
        if not os.path.exists(norm_path):
            raw = np.asarray(Image.open(os.path.join(clip_root, "candidates", f"full_{j}.jpg")))
            Image.fromarray(normalise(raw)).save(norm_path)
        img = np.asarray(Image.open(norm_path))
        cands.append((img.astype(np.float32) / 255.0 - 0.5) / 0.5)
    return datasets.FaceFrameSampler(
        images=images, landmarks=landmarks.astype(np.float32),
        shoulders=shoulders.astype(np.float32), candidates=np.stack(cands),
        load_size=load_size, frame_jump=frame_jump, emit_weight_mask=False)
