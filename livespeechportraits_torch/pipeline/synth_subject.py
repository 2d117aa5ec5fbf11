"""Synthesize a reference-format raw-clip subject with learnable structure.

Counterpart of ``livespeechportraits_tpu/pipeline/synth_subject.py``: it
writes the raw training clips of a subject that has no released data (a tone
whose amplitude envelope opens the inner mouth and sways the head, and
frames that stylise the subject's own edge maps), in exactly the files and
layouts the JAX package writes, which ``pipeline/build_person.py`` turns
into a servable pack.

The numpy parts (``envelope``, ``lowpass``, ``make_audio``,
``subject_pts3d``, ``subject_headpose``, ``camera_matrix``,
``default_shoulders``) are the JAX package's.  ``project_clip`` runs the
port's geometry, and ``render_clip_frames`` the port's rasteriser: on the
card kernel K1's f32-plane entry (``rasterize_cuda.rasterize_segments``) on
each batch's segment table, on the CPU its plain twin.  ``stylise_edges``
blurs with scipy's Gaussian filter, the kernel and border of JAX's
``cv2.GaussianBlur(e, (0, 0), 3)`` (25 taps, reflect-101), so the frames do
not depend on whether cv2 is installed.

Conventions (see the JAX module): raw rot_x sits near -180 deg, the
translation is constant [0, 0, 1], the face spans more than half the frame,
and only the inner-mouth rows 46:64 animate.
"""

from __future__ import annotations

import io
import os
from typing import Dict

import numpy as np
import torch

from livespeechportraits_torch.ops import geometry, rasterize, rasterize_cuda
from livespeechportraits_torch.pipeline.assets import _synthetic_face_landmarks
from livespeechportraits_torch.utils import h5vlen

FPS = 60
SR = 16000
FACE_SCALE = 1.8  # projected face width ~440 px of 512
TRANS = np.array([0.0, 0.0, 1.0], np.float32)


def envelope(n_frames: int, seed: int = 0) -> np.ndarray:
    """Smooth amplitude envelope in [0.05, 1] at frame rate: a product of
    incommensurate sinusoids with a floor, so the carrier never vanishes."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_frames, dtype=np.float64) / FPS
    p1, p2, p3 = rng.uniform(0, 2 * np.pi, 3)
    e = (0.5 + 0.5 * np.sin(2 * np.pi * 0.43 * t + p1)
         * np.cos(2 * np.pi * 0.091 * t + p2))
    e = 0.7 * e + 0.3 * (0.5 + 0.5 * np.sin(2 * np.pi * 0.17 * t + p3))
    return np.clip(e, 0.05, 1.0).astype(np.float32)


def lowpass(x: np.ndarray, sigma: float) -> np.ndarray:
    """Gaussian lowpass with reflect padding."""
    r = max(1, int(3 * sigma))
    k = np.exp(-0.5 * (np.arange(-r, r + 1) / sigma) ** 2)
    k /= k.sum()
    xp = np.pad(x, r, mode="reflect")
    return np.convolve(xp, k, mode="valid").astype(np.float32)


def make_audio(env: np.ndarray, seed: int = 0) -> np.ndarray:
    """Envelope at frame rate -> [-1, 1] float wav at 16 kHz: a carrier with
    a slowly wobbling pitch, its sample amplitude the interpolated
    envelope."""
    rng = np.random.default_rng(seed + 1)
    n = int(len(env) / FPS * SR)
    ts = np.arange(n, dtype=np.float64) / SR
    amp = np.interp(ts, np.arange(len(env)) / FPS, env.astype(np.float64))
    freq = 220.0 + 40.0 * np.sin(2 * np.pi * 0.073 * ts + rng.uniform(0, 2 * np.pi))
    phase = 2 * np.pi * np.cumsum(freq) / SR
    wav = amp * (0.8 * np.sin(phase) + 0.2 * np.sin(2 * phase))
    return (0.95 * wav / np.abs(wav).max()).astype(np.float32)


def stylise_edges(edges: np.ndarray) -> np.ndarray:
    """[B, H, W] edge maps in [0, 1] -> [B, H, W, 3] uint8 frames: an edge
    glow (Gaussian blur, sigma 3) over a radial vignette."""
    from scipy import ndimage

    B, H, W = edges.shape
    e = edges.astype(np.float32) * 255.0
    g = ndimage.gaussian_filter(e, sigma=(0, 3, 3), mode="mirror", truncate=4.0)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    r = np.hypot(xx - W / 2, yy - H / 2) / max(H, W)
    vign = (np.clip(1.2 - 1.4 * r, 0.0, 1.0) * 70.0 + 30.0)[None]
    return np.stack([
        np.clip(vign + 0.7 * g, 0, 255),
        np.clip(0.8 * vign + 0.9 * e, 0, 255),
        np.clip(0.6 * vign + 0.5 * g, 0, 255),
    ], axis=-1).astype(np.uint8)


def subject_pts3d(n_frames: int, seed: int = 0, env=None) -> np.ndarray:
    """[T, 73, 3] tracked (head-pose-free) landmarks: a static face whose
    inner mouth (rows 46:64) opens with the envelope."""
    if env is None:
        env = envelope(n_frames, seed)
    base = _synthetic_face_landmarks()
    pts = np.repeat(base[None], n_frames, axis=0)
    m = slice(46, 64)
    c = -0.05  # the mouth's vertical centre
    pts[:, m, 1] = c + (base[None, m, 1] - c) * (1.0 + 1.5 * env[:, None])
    return (pts * FACE_SCALE).astype(np.float32)


def subject_headpose(n_frames: int, seed: int = 0, env=None):
    """(rot_angles [T, 3] deg, trans [T, 3, 1]): a rotation of a few degrees
    following the low-passed envelope; a constant translation."""
    if env is None:
        env = envelope(n_frames, seed)
    slow = lowpass(env, 30.0)
    slow = slow - slow.mean()
    rot = np.stack([
        -180.0 + 3.0 * slow,
        2.0 * lowpass(env, 45.0) - 2.0 * np.mean(lowpass(env, 45.0)),
        np.zeros(n_frames, np.float32),
    ], axis=1).astype(np.float32)
    trans = np.repeat(TRANS[None, :, None], n_frames, axis=0)
    return rot, trans.astype(np.float32)


def camera_matrix(image_size: int = 512) -> np.ndarray:
    """The pinhole build_person_pack falls back to (f = 2.4 * size)."""
    f, c = image_size * 2.4, image_size / 2.0
    return np.array([[f, 0, c], [0, f, c], [0, 0, 1]], np.float32)


def default_shoulders(image_size: int = 512) -> np.ndarray:
    """[18, 2] static shoulder rows (the layout of make_synthetic_person)."""
    xs = np.linspace(image_size * 0.2, image_size * 0.8, 9, dtype=np.float32)
    y = image_size * 0.8
    return np.concatenate([
        np.stack([xs, np.full(9, y, np.float32)], 1),
        np.stack([xs, np.full(9, y + 14, np.float32)], 1),
    ])


def project_clip(pts3d: np.ndarray, rot: np.ndarray, trans: np.ndarray,
                 image_size: int = 512, device: torch.device | str = "cuda") -> np.ndarray:
    """[T, 73, 2] ground-truth 2D landmarks by the serving pipeline's own
    projection (geometry.project_landmarks), on ``device``."""
    K = torch.as_tensor(camera_matrix(image_size), device=device)
    head = torch.as_tensor(np.concatenate([rot, trans[:, :, 0]], axis=1), device=device)
    lm = geometry.project_landmarks(K, torch.eye(3, device=device),
                                    torch.zeros(3, device=device), 1.0, head,
                                    torch.as_tensor(pts3d, device=device))
    return lm.cpu().numpy().astype(np.float32)


def render_clip_frames(landmarks2d: np.ndarray, shoulders: np.ndarray, image_size: int = 512,
                       batch: int = 32, device: torch.device | str = "cuda") -> np.ndarray:
    """Ground-truth frames [T, H, W, 3] uint8: each batch's edge maps drawn
    by the renderer's rasteriser from its segment table (kernel K1 on a CUDA
    device, one launch a batch; the plain twin on the CPU), stylised."""
    T = landmarks2d.shape[0]
    sh = torch.as_tensor(shoulders, device=device)
    out = []
    for lo in range(0, T, batch):
        lm = torch.as_tensor(landmarks2d[lo:lo + batch], device=device)
        table = rasterize.segment_table(lm, sh[None].expand(lm.shape[0], -1, -1))
        edges = rasterize_cuda.rasterize_segments(table, image_size, image_size)
        out.append(stylise_edges(edges.cpu().numpy()))
    return np.concatenate(out)


def write_raw_clip(person_root: str, name: str, n_frames: int, seed: int = 0,
                   image_size: int = 512, with_face: bool = True, jpg_quality: int = 97,
                   device: torch.device | str = "cuda") -> Dict:
    """Write one reference-format raw training clip under
    <person_root>/<name>/: <name>.wav, 3d_fit_data.npz, the tracked 3D
    points, camera_intrinsic.npy, the per-frame shoulders and, with a face,
    the tracked 2D landmarks, the h5 JPEG frame store <name>.h5 (q97,
    4:4:4; written by utils/h5vlen, which h5py reads) and change_paras.npz;
    file names and layouts are the JAX package's.  Returns the ground truth {env, pts3d, rot, trans,
    landmarks2d, shoulders, wav}."""
    from PIL import Image
    from scipy.io import wavfile

    root = os.path.join(person_root, name)
    os.makedirs(root, exist_ok=True)

    env = envelope(n_frames, seed)
    wav = make_audio(env, seed)
    wavfile.write(os.path.join(root, name + ".wav"), SR, (wav * 32767).astype(np.int16))

    pts3d = subject_pts3d(n_frames, seed, env)
    rot, trans = subject_headpose(n_frames, seed, env)
    np.savez(os.path.join(root, "3d_fit_data.npz"), pts_3d=pts3d, rot_angles=rot, trans=trans)
    np.save(os.path.join(root, "tracked3D_normalized_pts_fix_contour.npy"), pts3d)
    np.save(os.path.join(root, "camera_intrinsic.npy"), camera_matrix(image_size))

    shoulders = default_shoulders(image_size)
    lm2d = project_clip(pts3d, rot, trans, image_size, device)
    gt = {"env": env, "pts3d": pts3d, "rot": rot, "trans": trans,
          "landmarks2d": lm2d, "shoulders": shoulders, "wav": wav}
    np.save(os.path.join(root, "normalized_shoulder_points.npy"),
            np.repeat(shoulders[None], n_frames, axis=0))
    if not with_face:
        return gt

    np.save(os.path.join(root, "tracked2D_normalized_pts_fix_contour.npy"), lm2d)
    frames = render_clip_frames(lm2d, shoulders, image_size, device=device)
    jpegs = []
    for frame in frames:
        buf = io.BytesIO()
        # 4:4:4: 4:2:0 chroma would cost ~14 dB on these sharp edges
        Image.fromarray(frame).save(buf, format="JPEG", quality=jpg_quality, subsampling=0)
        jpegs.append(buf.getvalue())
    h5vlen.write(os.path.join(root, name + ".h5"), name, jpegs)
    # the frames are authored at the serving resolution: identity normalise
    np.savez(os.path.join(root, "change_paras.npz"), scale=np.float32(512.0 / image_size),
             xc=np.int32(256), yc=np.int32(256))
    return gt
