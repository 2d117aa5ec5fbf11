"""Assemble a servable person pack from per-clip training data.

Counterpart of ``livespeechportraits_tpu/pipeline/build_person.py``.  Given
reference-format training clips (wav + 3d_fit_data.npz + tracked points + h5
frames, as ``pipeline/synth_subject.write_raw_clip`` writes them) and an APC
encoder, it writes every file ``assets.load_person`` reads: the mean and
concatenated 3D landmarks, the fit track, the APC feature bank of the LLE
projection (each clip's features through ``train/data_io.
compute_apc_features``: kernel K2 on the card), the camera, the shoulders,
four candidate frames and a reference-format ``<name>.yaml``, so

    build_person_pack -> demo --id <name>

serves a subject that has no released data.
"""

from __future__ import annotations

import io
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from livespeechportraits_torch.config import MOUTH_INDICES
from livespeechportraits_torch.models.apc import APCEncoder


def _concat_fit_data(person_root: str, clip_names: Sequence[str]):
    """Each clip's 3d_fit_data.npz (and tracked points, where present)
    concatenated in clip order: (pts, rots, trans [T, 3, 1], tracked)."""
    pts, rots, trans, tracked = [], [], [], []
    for name in clip_names:
        clip_root = os.path.join(person_root, name)
        fit = np.load(os.path.join(clip_root, "3d_fit_data.npz"))
        p = fit["pts_3d"].astype(np.float32)
        t = fit["trans"].astype(np.float32)
        if t.ndim == 2:  # [T, 3] -> the reference's [T, 3, 1]
            t = t[:, :, None]
        pts.append(p)
        rots.append(fit["rot_angles"].astype(np.float32))
        trans.append(t)
        tr_path = os.path.join(clip_root, "tracked3D_normalized_pts_fix_contour.npy")
        tracked.append(np.load(tr_path).astype(np.float32) if os.path.exists(tr_path) else p)
    return (np.concatenate(pts), np.concatenate(rots), np.concatenate(trans),
            np.concatenate(tracked))


def select_candidate_frames(landmarks2d: np.ndarray, n: int = 4) -> List[int]:
    """``n`` spread-out frames for the candidate images: the extremes of the
    mouth's vertical extent and of the contour's horizontal offset (a yaw
    proxy), without repeats; a clip of fewer frames repeats them in turn."""
    lm = np.asarray(landmarks2d, np.float32)
    mouth = lm[:, list(MOUTH_INDICES), 1]
    openness = mouth.max(axis=1) - mouth.min(axis=1)
    yaw = lm[:, :15, 0].mean(axis=1) - lm[:, 35:46, 0].mean(axis=1)
    picks: List[int] = []
    for order in (np.argsort(-openness), np.argsort(openness),
                  np.argsort(-yaw), np.argsort(yaw)):
        fresh = next((int(i) for i in order if int(i) not in picks), None)
        if fresh is not None:
            picks.append(fresh)
        if len(picks) == n:
            break
    while len(picks) < n:
        picks.append(picks[len(picks) % len(lm)])
    return picks[:n]


def _build_candidates(person_root: str, clip_names: Sequence[str],
                      out_dir: str) -> Optional[str]:
    """Write candidates/normalized_full_{0..3}.jpg from the longest clip with
    an h5 frame store and tracked 2D landmarks; returns its name."""
    from PIL import Image

    from livespeechportraits_torch.train import data_io
    from livespeechportraits_torch.utils import h5vlen

    best = None
    for name in clip_names:
        clip_root = os.path.join(person_root, name)
        lm_path = os.path.join(clip_root, "tracked2D_normalized_pts_fix_contour.npy")
        if os.path.exists(os.path.join(clip_root, name + ".h5")) and os.path.exists(lm_path):
            lm = np.load(lm_path).astype(np.float32)
            if best is None or len(lm) > len(best[2]):
                best = (clip_root, name, lm)
    if best is None:
        return None
    clip_root, name, lm = best
    normalise = data_io.make_change_paras_normalise(clip_root)
    os.makedirs(out_dir, exist_ok=True)
    h5 = os.path.join(clip_root, name + ".h5")
    picks = select_candidate_frames(lm[:h5vlen.length(h5, name)])
    for j, jpeg in enumerate(h5vlen.read(h5, name, picks)):
        with Image.open(io.BytesIO(jpeg)) as im:
            frame = normalise(np.asarray(im))
        Image.fromarray(frame).save(os.path.join(out_dir, f"normalized_full_{j}.jpg"))
    return name


def build_person_pack(person_root: str, clip_names: Sequence[str],
                      apc: Optional[APCEncoder] = None, image_size: int = 512,
                      bank_stride: int = 1) -> Dict[str, str]:
    """Write the serving-level subject files into ``person_root``; returns a
    manifest {file: how it was made}.  Existing candidate images are kept
    (they may be hand-picked); everything else is derived from the clips.
    ``apc`` builds the LLE feature bank on its own device and must be the
    encoder used at inference (None skips the bank, for use_LLE false);
    ``bank_stride`` keeps every n-th bank row."""
    from livespeechportraits_torch.pipeline import synth_subject
    from livespeechportraits_torch.pipeline import video as video_mod
    from livespeechportraits_torch.train import data_io

    manifest: Dict[str, str] = {}
    pts, rots, trans, tracked = _concat_fit_data(person_root, clip_names)

    np.save(os.path.join(person_root, "mean_pts3d.npy"), tracked.mean(axis=0).astype(np.float32))
    manifest["mean_pts3d.npy"] = f"mean of {len(tracked)} tracked frames"
    np.savez(os.path.join(person_root, "3d_fit_data.npz"), pts_3d=pts, rot_angles=rots,
             trans=trans)
    manifest["3d_fit_data.npz"] = f"concatenated {len(clip_names)} clips"
    np.save(os.path.join(person_root, "tracked3D_normalized_pts_fix_contour.npy"), tracked)
    manifest["tracked3D_normalized_pts_fix_contour.npy"] = "concatenated"

    # the LLE feature bank: the subject's speech manifold
    if apc is not None:
        feats = []
        for name in clip_names:
            wav = data_io.clip_wav_path(os.path.join(person_root, name), name)
            feats.append(data_io.compute_apc_features(video_mod.load_wav(wav), apc))
        bank = np.concatenate(feats)[::max(1, int(bank_stride))]
        np.save(os.path.join(person_root, "APC_feature_base.npy"), bank)
        manifest["APC_feature_base.npy"] = f"[{bank.shape[0]}, {bank.shape[1]}]"
    else:
        manifest["APC_feature_base.npy"] = "SKIPPED (no APC encoder given)"

    # the camera: a clip's, else a pinhole at the serving resolution
    cam_out = os.path.join(person_root, "camera_intrinsic.npy")
    for name in clip_names:
        src = os.path.join(person_root, name, "camera_intrinsic.npy")
        if os.path.exists(src):
            np.save(cam_out, np.load(src).astype(np.float32))
            manifest["camera_intrinsic.npy"] = f"copied from clip {name}"
            break
    else:
        if not os.path.exists(cam_out):
            np.save(cam_out, synth_subject.camera_matrix(image_size))
            manifest["camera_intrinsic.npy"] = "SYNTHESIZED pinhole fallback"
        else:
            manifest["camera_intrinsic.npy"] = "kept existing"

    # shoulders: the 2D reference row (frame 1 of a per-frame track) and the
    # 3D points (load_person reads row 1 of shoulder_points3D)
    sh2d = None
    for name in clip_names:
        src = os.path.join(person_root, name, "normalized_shoulder_points.npy")
        if os.path.exists(src):
            sh2d = np.load(src).astype(np.float32)
            if sh2d.ndim == 3:
                sh2d = sh2d[1 if len(sh2d) > 1 else 0]
            break
    if sh2d is None:
        sh2d = synth_subject.default_shoulders(image_size)
        manifest["normalized_shoulder_points.npy"] = "SYNTHESIZED fallback"
    else:
        manifest["normalized_shoulder_points.npy"] = "from clip data"
    np.save(os.path.join(person_root, "normalized_shoulder_points.npy"), sh2d)

    sh3d_out = os.path.join(person_root, "shoulder_points3D.npy")
    for name in clip_names:
        src = os.path.join(person_root, name, "shoulder_points3D.npy")
        if os.path.exists(src):
            np.save(sh3d_out, np.load(src).astype(np.float32))
            manifest["shoulder_points3D.npy"] = f"copied from clip {name}"
            break
    else:
        # the 2D shoulders back-projected at the mean head depth
        cam = np.load(cam_out)
        z = float(abs(trans[:, 2, 0].mean())) or 1.0
        x = (sh2d[:, 0] - cam[0, 2]) / cam[0, 0] * z
        y = (sh2d[:, 1] - cam[1, 2]) / cam[1, 1] * z
        sh3d = np.stack([x, y, np.full_like(x, z)], axis=1).astype(np.float32)
        np.save(sh3d_out, np.stack([sh3d, sh3d]))  # [2, 18, 3]; row 1 is read
        manifest["shoulder_points3D.npy"] = "BACK-PROJECTED from 2D fallback"

    cand_dir = os.path.join(person_root, "candidates")
    if all(os.path.exists(os.path.join(cand_dir, f"normalized_full_{j}.jpg"))
           for j in range(4)):
        manifest["candidates/"] = "kept existing"
    else:
        src = _build_candidates(person_root, clip_names, cand_dir)
        manifest["candidates/"] = (f"4 spread frames from clip {src}" if src
                                   else "MISSING (no clip has an h5 frame store + 2D landmarks)")

    name = os.path.basename(os.path.normpath(person_root))
    write_person_yaml(os.path.join(person_root, name + ".yaml"), person_root,
                      use_lle=apc is not None)
    manifest[name + ".yaml"] = "person config (copy into ./config/)"
    return manifest


def write_person_yaml(path: str, person_root: str, use_lle: bool = True,
                      size: str = "large") -> None:
    """The reference-format per-person YAML of a built pack, the JAX
    package's text (config.load_person_config reads it back)."""
    root = person_root.rstrip("/")
    text = f"""# Generated by pipeline/build_person.py - reference config/<id>.yaml format.
# ckp_path fields are empty: pass this framework's trainer checkpoints to
# demo.py via --apc_ckpt/--a2f_ckpt/--a2h_ckpt/--f2f_ckpt, or fill in
# converted reference .pkl paths.
model_params:
    APC:
        ckp_path: ''
        mel_dim: 80
        hidden_size: 512
        num_layers: 3
        residual: false
        use_LLE: {1 if use_lle else 0}
        Knear: 10
        LLE_percent: 1
    Audio2Mouth:
        ckp_path: ''
        smooth: 1.5
        AMP: ['XYZ', 2, 2, 2]
    Headpose:
        ckp_path: ''
        sigma: 0.3
        smooth: [5, 10]
        AMP: [1, 0.5]
        shoulder_AMP: 0.5
    Image2Image:
        ckp_path: ''
        size: '{size}'
        save_input: 0

dataset_params:
    root: '{root}/'
    fit_data_path: '{root}/3d_fit_data.npz'
    pts3d_path: '{root}/tracked3D_normalized_pts_fix_contour.npy'
"""
    with open(path, "w") as f:
        f.write(text)
