"""Training data samplers: windowed audio-visual sequences and face frames.

The port's own copy of ``livespeechportraits_tpu/train/datasets.py``
(the reference's datasets/audiovisual_dataset.py and face_dataset.py):
plain-numpy samplers on the host that yield NHWC / feature-last batches,
drawn from a ``np.random.Generator``, so that from the same generator they
give JAX's batches bit for bit.  The trainer moves them to the device.

Notes on reference divergences (documented, intended behaviour built):

* The A2H `predict_len != 0` target branch is incoherent as shipped
  (it reads head poses where velocities are intended and produces a
  [T, predict_length*12] target that can never match the GMM's ndim=12 -
  audiovisual_dataset.py:252-270); only `predict_length=1` trains.  We
  implement that runnable configuration.
* start_point is 300 for Audio2Headpose and 0 for Audio2Feature
  (audiovisual_dataset.py:138-141), kept as defaults.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from livespeechportraits_torch.config import MOUTH_INDICES
from livespeechportraits_torch.ops import rasterize


@dataclass
class ClipData:
    """One training clip's precomputed features and tracking data."""

    audio_features: np.ndarray  # [2T, 512] APC features (120 Hz)
    pts3d: np.ndarray  # [T, 73, 3] (delta from mean when use_delta_pts)
    headpose: np.ndarray  # [T, 6] rot(deg, x remapped) + delta-trans
    velocity: np.ndarray  # [T, 6] first difference (zeros row 0)

    @property
    def n_frames(self) -> int:
        return self.pts3d.shape[0]


def make_clip(audio_features: np.ndarray, pts3d: np.ndarray, rot_angles: np.ndarray,
              trans: np.ndarray, remap_rot_x: bool = True) -> ClipData:
    """Assemble a ClipData from raw fit data, applying the reference's
    conventions (audiovisual_dataset.py:156-170): x rotation remapped
    -180..180 -> 0..360 -> -180, translation centred on its mean,
    velocity = first difference with a zero first row."""
    rot = rot_angles.astype(np.float32).copy()
    if remap_rot_x:
        rot[rot[:, 0] < 0, 0] += 360.0
        rot[:, 0] -= 180.0
    tr = trans.astype(np.float32)
    tr = tr - tr.mean(axis=0)
    headpose = np.concatenate([rot, tr], axis=1)
    velocity = np.concatenate([np.zeros((1, 6), np.float32), np.diff(headpose, axis=0)])
    return ClipData(
        audio_features=audio_features.astype(np.float32),
        pts3d=pts3d.astype(np.float32),
        headpose=headpose,
        velocity=velocity.astype(np.float32),
    )


class AudioVisualSampler:
    """Windowed sampler for the two audio tasks.

    task='audio2feature': returns {'audio': [2*seq_len, 512],
                                   'target': [seq_len, 75]}
    task='audio2headpose': returns {'audio': [item_len, 1024],
                                    'history': [item_len, 12],
                                    'target': [target_length, 12]}
    """

    def __init__(
        self,
        clips: Sequence[ClipData],
        task: str = "audio2feature",
        seq_len: int = 240,
        target_length: int = 240,
        receptive_field: int = 255,
        frame_future: int = 15,
        frame_jump_stride: int = 1,
        start_point: Optional[int] = None,
        tail_margin: int = 460,
        mouth_only: bool = True,
        device_audio: bool = False,
    ):
        self.clips = list(clips)
        self.task = task
        self.seq_len = seq_len
        self.target_length = target_length
        self.receptive_field = receptive_field
        self.item_length = receptive_field + target_length - 1
        self.frame_future = frame_future
        self.stride = frame_jump_stride
        self.indices = np.asarray(MOUTH_INDICES) if mouth_only else np.arange(73)
        if start_point is None:
            start_point = 300 if task == "audio2headpose" else 0
        self.start_point = start_point

        # Per-clip valid range bookkeeping (audiovisual_dataset.py:172-208:
        # total-60 frames, minus start_point, minus a 400-frame tail guard).
        self.sample_start: List[int] = []
        self.len_: List[int] = []
        total = 0
        for clip in self.clips:
            usable = clip.n_frames - 60 - self.start_point - (tail_margin - 60)
            need = self._min_frames_needed()
            # the reference's FIXED 400-frame tail guard
            # (audiovisual_dataset.py:172-208) under-guards any window
            # longer than 400 frames (e.g. the A2H receptive_field 255 +
            # target 240 = 495): its last starts would slice out of range
            # mid-epoch.  Intended behaviour: admit only starts whose
            # whole window fits, and fail at construction only when NO
            # start does.
            usable = min(usable,
                         clip.n_frames - self.start_point - need + 1)
            if usable < 1:
                raise ValueError(
                    f"clip too short for the window: {clip.n_frames} frames "
                    f"(start_point {self.start_point}, each start needs "
                    f"{need} forward frames plus the tail guard)"
                )
            # Divergence from the reference's cumulative-start layout
            # (audiovisual_dataset.py:204-216, `... + len_[-1] - 1`): the
            # inherited `- 1` overlaps each clip's LAST start with the next
            # clip's first, so with >=2 clips the final clip's top global
            # indices map one past its admitted range and slice out of
            # bounds mid-epoch (and every earlier clip's last start is
            # unreachable).  Intended behaviour: clip i owns exactly
            # len_[i] consecutive global starts.
            self.sample_start.append(
                0 if not self.sample_start else self.sample_start[-1] + self.len_[-1]
            )
            self.len_.append(usable)
            total += int(np.floor(usable / self.stride))
        self.total_len = total

        # Host-link diet: with device_audio the (large) audio feature rows
        # never cross per batch.  All clips' features concatenate into ONE
        # bank that the trainer uploads once and keeps device-resident;
        # sample() then emits a scalar `audio_start` row index and the
        # train step gathers the fixed-length window ON DEVICE
        # (steps._batch_audio).  At B=16 x [494, 1024] f32 this turns a
        # ~32 MB/step upload into 64 bytes.
        self.device_audio = device_audio
        self.audio_bank: Optional[np.ndarray] = None
        if device_audio:
            feats = [np.asarray(c.audio_features) for c in self.clips]
            self._bank_row0 = np.concatenate(
                [[0], np.cumsum([len(f) for f in feats])[:-1]]).astype(np.int64)
            self.audio_bank = feats[0] if len(feats) == 1 else \
                np.concatenate(feats, axis=0)
            # rows per window (static gather length for the device slice)
            self.audio_rows = (2 * self.seq_len if self.task == "audio2feature"
                               else 2 * self.item_length)

    def _min_frames_needed(self) -> int:
        if self.task == "audio2feature":
            return self.seq_len
        return self.item_length + 1

    def __len__(self) -> int:
        return self.total_len

    def sample(self, index: int) -> Dict[str, np.ndarray]:
        index_real = int(index * self.stride)
        file_index = bisect.bisect_right(self.sample_start, index_real) - 1
        clip = self.clips[file_index]
        cf = index_real - self.sample_start[file_index] + self.start_point

        if self.task == "audio2feature":
            target = clip.pts3d[cf : cf + self.seq_len, self.indices].reshape(self.seq_len, -1)
            if self.device_audio:
                start = self._bank_row0[file_index] + cf * 2
                return {"audio_start": np.int32(start), "target": target}
            audio = clip.audio_features[cf * 2 : (cf + self.seq_len) * 2]
            return {"audio": audio, "target": target}

        # audio2headpose (WaveNet branch, predict_len=0 semantics)
        hs = cf - self.receptive_field
        L = self.item_length
        a_lo = 2 * (hs + self.frame_future)
        pose_vel = np.concatenate([clip.headpose, clip.velocity], axis=1)  # [T, 12]
        history = pose_vel[hs : hs + L]
        target = pose_vel[hs + self.receptive_field : hs + L + 1]
        if self.device_audio:
            start = self._bank_row0[file_index] + a_lo
            return {"audio_start": np.int32(start),
                    "history": history, "target": target}
        audio = clip.audio_features[a_lo : a_lo + 2 * L].reshape(L, -1)
        return {"audio": audio, "history": history, "target": target}

    def batches(self, batch_size: int, rng: np.random.Generator,
                shuffle: bool = True, drop_last: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(self.total_len)
        if shuffle:
            rng.shuffle(order)
        for lo in range(0, self.total_len - (batch_size - 1 if drop_last else 0), batch_size):
            idx = order[lo : lo + batch_size]
            if drop_last and len(idx) < batch_size:
                break
            samples = [self.sample(int(i)) for i in idx]
            yield {k: np.stack([s[k] for s in samples]) for k in samples[0]}


# ---------------------------------------------------------------------------
# Mel windows (APC self-supervised pretraining).  No reference
# counterpart: the reference consumes a frozen pretrained APC encoder
# (demo.py:145-160) and ships no pretraining data path at all.
# ---------------------------------------------------------------------------


class MelWindowSampler:
    """Fixed-length windows over per-utterance log-mel sequences.

    Windows never straddle utterance boundaries (prediction across a
    file seam is meaningless); `stride` < `window` gives overlapping
    training windows.
    """

    def __init__(self, mels: Sequence[np.ndarray], window: int = 480,
                 stride: Optional[int] = None):
        stride = stride or window
        self.window = int(window)
        self._index: List[tuple[int, int]] = []
        self.mels = [np.asarray(m, np.float32) for m in mels]
        for u, m in enumerate(self.mels):
            if m.ndim != 2:
                raise ValueError(f"mel sequence {u} must be [T, mel_dim]")
            for lo in range(0, m.shape[0] - self.window + 1, int(stride)):
                self._index.append((u, lo))
        if not self._index:
            raise ValueError(
                f"no utterance has >= {self.window} mel frames "
                f"(lengths: {[m.shape[0] for m in self.mels]})")

    def __len__(self) -> int:
        return len(self._index)

    def sample(self, index: int) -> Dict[str, np.ndarray]:
        u, lo = self._index[index]
        return {"mels": self.mels[u][lo : lo + self.window]}

    def batches(self, batch_size: int, rng: np.random.Generator,
                shuffle: bool = True, drop_last: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self._index))
        if shuffle:
            rng.shuffle(order)
        for lo in range(0, len(order) - (batch_size - 1 if drop_last else 0), batch_size):
            idx = order[lo : lo + batch_size]
            if drop_last and len(idx) < batch_size:
                break
            yield {"mels": np.stack([self.sample(int(i))["mels"] for i in idx])}


# ---------------------------------------------------------------------------
# Face frames (renderer training) - datasets/face_dataset.py
# ---------------------------------------------------------------------------


class FaceFrameSampler:
    """Per-frame renderer training data.

    Yields {'feature_map': [H, W, 1], 'cand_image': [H, W, 12],
    'tgt_image': [H, W, 3], 'weight_mask': [H, W, 1]} per sample (NHWC
    batches via `batches`).  Images/landmarks are taken pre-normalised to
    the 512-crop frame (the reference's change_paras/albumentations resize
    pipeline is a host preprocessing step; `crop_jitter` reproduces the
    online random-translation augment of face_dataset.py:326-352 as a
    random crop-and-resize around the face).
    """

    def __init__(
        self,
        images: np.ndarray,  # [N, H, W, 3] uint8 or float [-1, 1]
        landmarks: np.ndarray,  # [N, 73, 2]
        shoulders: np.ndarray,  # [N, S, 2] (or [S, 2] shared)
        candidates: np.ndarray,  # [4, H, W, 3] float [-1, 1]
        load_size: int = 512,
        frame_jump: int = 1,
        crop_jitter: float = 0.0,
        device_rasterize: bool = False,
        shared_cand: bool = True,
        u8_targets: bool = True,
        emit_weight_mask: bool = True,
    ):
        self.images = images
        self.landmarks = landmarks.astype(np.float32)
        self.shoulders = shoulders.astype(np.float32)
        self.candidates = candidates
        self.load_size = load_size
        self.frame_jump = frame_jump
        self.crop_jitter = crop_jitter
        # Host-link diet (the reference loads candidates ONCE per subject,
        # face_dataset.py:119-129, and reads uint8 jpgs,
        # face_dataset.py:190-193 - shipping per-sample f32 copies is a
        # rebuild artifact, not parity):
        # - shared_cand: batches() emits the per-subject candidate tensor
        #   with leading dim 1; the train step broadcasts ON DEVICE and the
        #   trainer uploads it once per process (~12.6 MB saved per sample
        #   at 512^2).
        # - u8_targets: tgt_image crosses the host link as uint8 when the
        #   frame store is uint8 (4x fewer bytes); steps normalise on
        #   device.  Crop-resize then runs in uint8 (cv2 rounds), a
        #   deliberate <=1/510 divergence from the f32-resize path.
        # - emit_weight_mask=False skips the cv2 fillPoly+dilate mask -
        #   nothing in the training step consumes it (the reference's own
        #   MaskedL1 call is commented out, feature2face_model.py:139).
        self.shared_cand = shared_cand
        self.u8_targets = u8_targets
        self.emit_weight_mask = emit_weight_mask
        # the candidate tensor is identical for every sample: build it once
        cand = np.concatenate(
            [self._to_float(c) for c in candidates], axis=-1)
        if cand.shape[0] != load_size:
            import cv2

            cand = cv2.resize(cand, (load_size, load_size))
        self._cand_full = np.ascontiguousarray(cand, np.float32)
        # device_rasterize: emit raw landmark/shoulder coords instead of a
        # host-cv2 feature map; the trainer rasterises the whole batch ON
        # DEVICE (same kernel as the inference pipeline) - removes the
        # most expensive host step from the GAN input path AND makes
        # train-time edge maps pixel-identical to inference-time ones
        # (the host cv2 and device rasterisers agree only to IoU ~0.95).
        self.device_rasterize = device_rasterize
        n = len(images)  # ndarray or lazy frame store (data_io.LazyH5Frames)
        self.sample_len = int(np.floor((n - 60) / frame_jump) + 1) if n > 60 else n

    def __len__(self) -> int:
        return self.sample_len

    def _to_float(self, img: np.ndarray) -> np.ndarray:
        if img.dtype == np.uint8:
            return (img.astype(np.float32) / 255.0 - 0.5) / 0.5
        return img.astype(np.float32)

    @staticmethod
    def crop_coords(keypoints: np.ndarray, size: Tuple[int, int],
                    jitter: float = 0.0,
                    rng: Optional[np.random.Generator] = None) -> Tuple[int, int, int, int]:
        """Face-centred square crop window (face_dataset.py:326-352):
        centre x at the landmark mid-x, centre y at (3*min_y + max_y)/4,
        side = 2x the landmark width clamped to the frame, optional random
        translation, clamped back into the frame."""
        w_ori, h_ori = size
        min_y, max_y = keypoints[:, 1].min(), keypoints[:, 1].max()
        min_x, max_x = keypoints[:, 0].min(), keypoints[:, 0].max()
        xc = (min_x + max_x) // 2
        yc = (min_y * 3 + max_y) // 4
        hw = min((max_x - min_x) * 2, w_ori, h_ori)
        if rng is not None and jitter > 0:
            xb, yb = rng.uniform(-jitter, jitter, 2)
            xc, yc = xc + xb, yc + yb
        xc = min(max(0, xc - hw // 2) + hw, w_ori) - hw // 2
        yc = min(max(0, yc - hw // 2) + hw, h_ori) - hw // 2
        return int(xc - hw // 2), int(yc - hw // 2), int(xc + hw // 2), int(yc + hw // 2)

    def sample(self, index: int, rng: Optional[np.random.Generator] = None) -> Dict[str, np.ndarray]:
        jump = self.frame_jump
        base = index * jump
        if rng is not None and jump > 1:
            base += int(rng.integers(jump))
        idx = min(base + 1, len(self.images) - 1)  # target_ind = i+1

        lm = self.landmarks[idx].copy()
        sh = (self.shoulders[idx] if self.shoulders.ndim == 3 else self.shoulders).copy()
        raw = self.images[idx]
        keep_u8 = self.u8_targets and raw.dtype == np.uint8
        img = raw if keep_u8 else self._to_float(raw)

        H = W = self.load_size
        h_ori, w_ori = img.shape[:2]

        # face-centred crop + resize with keypoint sync (the reference's
        # A.Crop + A.Resize pipeline, face_dataset.py:203-208/265-273); the
        # reference draws shoulders in *uncropped* coordinates (its
        # __getitem__ never transforms them) - kept for parity.
        x0, y0, x1, y1 = self.crop_coords(lm, (w_ori, h_ori), self.crop_jitter, rng)
        if x1 > x0 and y1 > y0 and (x1 - x0) != W:
            crop = img[y0:y1, x0:x1]
            try:
                import cv2

                img = cv2.resize(crop, (W, H), interpolation=cv2.INTER_LINEAR)
            except ImportError:  # pragma: no cover
                from PIL import Image

                crop_u8 = crop if keep_u8 else \
                    ((crop * 0.5 + 0.5) * 255).astype(np.uint8)
                img = np.asarray(Image.fromarray(crop_u8).resize((W, H)))
                if not keep_u8:
                    img = (img.astype(np.float32) / 255.0 - 0.5) / 0.5
            s = W / float(x1 - x0)
            lm = (lm - np.array([x0, y0], np.float32)) * s
        elif img.shape[0] != H:
            import cv2

            sy = H / float(img.shape[0])
            sx = W / float(img.shape[1])
            img = cv2.resize(img, (W, H))
            # landmarks live in source-pixel coordinates; a whole-frame
            # resize must rescale them too or the mask/feature map are
            # built misaligned with the target image
            lm = lm * np.array([sx, sy], np.float32)

        out = {
            "cand_image": self._cand_full,
            "tgt_image": img,
        }
        if self.emit_weight_mask:
            mask = rasterize.facial_weight_mask(lm, H, W)
            if mask.ndim == 2:
                mask = mask[..., None]
            out["weight_mask"] = mask[..., :1]
        if self.device_rasterize:
            out["landmarks"] = lm.astype(np.float32)
            out["shoulders"] = sh.astype(np.float32)
        else:
            fmap = rasterize.rasterize_feature_map_host(
                lm, sh, (W, H)).astype(np.float32) / 255.0
            out["feature_map"] = fmap[..., None]
        return out

    def shared_cand_array(self) -> Optional[np.ndarray]:
        """The per-subject candidate tensor [H, W, 12] when every sample
        of this sampler shares it (always true here), else None."""
        return self._cand_full if self.shared_cand else None

    def batches(self, batch_size: int, rng: np.random.Generator,
                shuffle: bool = True,
                drop_last: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        yield from _face_batches(self, batch_size, rng, shuffle, drop_last)


def _face_batches(sampler, batch_size: int, rng: np.random.Generator,
                  shuffle: bool = True,
                  drop_last: bool = True) -> Iterator[Dict[str, np.ndarray]]:
    shared = sampler.shared_cand_array()
    # one [1, H, W, 12] view per epoch, not per batch: the trainer's
    # device cache keys on the view's base array, and every batch sharing
    # one view object keeps even an id()-keyed cache from churning
    shared_b = shared[None] if shared is not None else None
    order = np.arange(len(sampler))
    if shuffle:
        rng.shuffle(order)
    stop = len(sampler) - (batch_size - 1 if drop_last else 0)
    for lo in range(0, stop, batch_size):
        samples = [sampler.sample(int(i), rng) for i in order[lo : lo + batch_size]]
        batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]
                 if not (shared is not None and k == "cand_image")}
        if shared_b is not None:
            # leading dim 1: uploaded once per process (trainer caches the
            # device copy), broadcast on device inside the step
            batch["cand_image"] = shared_b
        yield batch


class ConcatFaceSampler:
    """Multi-clip renderer dataset.

    The reference's FaceDataset spans every clip of a subject with
    cumulative-length indexing (face_dataset.py:36-77); this concatenates
    per-clip FaceFrameSamplers behind the same sample()/batches() API so
    trainers are clip-count agnostic."""

    def __init__(self, samplers: Sequence["FaceFrameSampler"]):
        self.samplers = list(samplers)
        if not self.samplers:
            raise ValueError("ConcatFaceSampler needs at least one clip")
        self.cum = np.cumsum([len(s) for s in self.samplers])
        # shared-cand emission is safe across clips only when every clip
        # carries the SAME subject candidates (build_person writes one set
        # per subject); checked once here, per-sample fallback otherwise
        c0 = self.samplers[0].shared_cand_array()
        self._shared_cand = c0
        for s in self.samplers[1:]:
            c = s.shared_cand_array()
            if c is None or (c is not c0 and not np.array_equal(c, c0)):
                self._shared_cand = None
                break

    def shared_cand_array(self) -> Optional[np.ndarray]:
        return self._shared_cand

    def __len__(self) -> int:
        return int(self.cum[-1])

    def sample(self, index: int, rng: Optional[np.random.Generator] = None) -> Dict[str, np.ndarray]:
        k = int(bisect.bisect_right(self.cum, index))
        base = 0 if k == 0 else int(self.cum[k - 1])
        return self.samplers[k].sample(index - base, rng)

    def batches(self, batch_size: int, rng: np.random.Generator,
                shuffle: bool = True,
                drop_last: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        yield from _face_batches(self, batch_size, rng, shuffle, drop_last)
