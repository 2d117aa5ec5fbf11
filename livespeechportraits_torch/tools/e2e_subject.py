"""A subject made from nothing, end to end, on the PyTorch port: raw clips ->
APC pretraining -> the servable pack -> Audio2Feature and Audio2Headpose ->
the Feature2Face GAN (the fused step, each batch's edge maps drawn by K1)
-> serving -> scores on held-out audio.

    python -m livespeechportraits_torch.tools.e2e_subject                 # on the card
    python -m livespeechportraits_torch.tools.e2e_subject --phases eval   # re-score a run
    python -m livespeechportraits_torch.tools.e2e_subject --device cpu --image_size 32 \\
        --train_frames 800 --val_frames 240 --apc_window 60 --a2f_seq_len 32 \\
        --a2h_target_length 8 --tail_margin 60 \\
        --apc_epochs 1 --a2f_epochs 1 --a2h_epochs 1 --f2f_epochs 1 --eval_seconds 1

The port of the JAX package's tools/e2e_subject.py, phase for phase
(clips, apc, pack, a2f, a2h, f2f, eval, rescore; --phases picks and
restarts them).  The subject is pipeline/synth_subject.py's, whose every
mapping is deterministic and learnable, and the eval phase scores the served
held-out clip against its ground truth through utils/metrics.py.  Artifacts
under --root: the raw clips with gt_<clip>.npz, the pack and its YAML,
ckpt/<stage>/ (checkpoints, scalars.csv, the GAN's web/ panels),
e2e_heldout.avi, eval_outputs.npz and e2e_metrics.json (JAX's keys).

Defaults are JAX's (3600 + 1440 frames at 512^2; about half an hour on
one card).  A shorter run cuts the windows with the clips: --apc_window,
--a2f_seq_len, --a2h_target_length, --tail_margin.  The head-pose windows
start 300 frames into a clip (the reference's) and span the WaveNet's
255-frame field and the target, so a train clip needs 555 + target frames;
a held-out clip shorter than that trains Audio2Headpose without
validation.  --device cpu with a small
--image_size runs every phase on the CPU (the renderer then computes in f32).

Beyond JAX: a stored clip is reused only when its gt_<clip>.npz records the
same seed and face flag and it has its frame store where it should
(ADVICE.md: JAX checks the frame count alone).  No compile cache.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import time
from dataclasses import replace

import numpy as np
import torch

TRAIN_CLIP = "clip1"
VAL_CLIP = "val1"
DEFAULT_ROOT = os.path.join("e2e_subject", "E2ESynth")


def train_clip_names(n_clips: int):
    return [f"clip{i + 1}" for i in range(n_clips)]


def _clip_is_current(root: str, name: str, n: int, seed: int, with_face: bool) -> bool:
    """gt_<name>.npz records this clip: n frames, the seed, the face flag;
    and the clip directory holds the h5 store exactly when it has a face."""
    gt_path = os.path.join(root, f"gt_{name}.npz")
    if not (os.path.exists(gt_path) and os.path.isdir(os.path.join(root, name))):
        return False
    with np.load(gt_path) as gt:
        if "seed" not in gt or "with_face" not in gt:
            return False
        same = (len(gt["rot"]) == n and int(gt["seed"]) == seed
                and bool(gt["with_face"]) == with_face)
    has_store = os.path.exists(os.path.join(root, name, name + ".h5"))
    return same and has_store == with_face


def phase_clips(root: str, train_frames: int, val_frames: int, seed: int = 0,
                n_clips: int = 1, image_size: int = 512, device: str = "cuda") -> None:
    """Author the train clips and the held-out clip (the reference's clip
    layout).  Clip i of the train corpus draws its dynamics from seed +
    7 i, the held-out clip from seed + 100; only clip1 (the renderer's
    training clip and the candidates' source) and the held-out clip (the
    eval's ground-truth frames) get a frame store, K1 drawing their edge
    maps on the card."""
    from livespeechportraits_torch.pipeline import synth_subject

    jobs = [(name, train_frames, seed + 7 * i)
            for i, name in enumerate(train_clip_names(n_clips))]
    jobs.append((VAL_CLIP, val_frames, seed + 100))
    for name, n, s in jobs:
        with_face = name in (TRAIN_CLIP, VAL_CLIP)
        if _clip_is_current(root, name, n, s, with_face):
            print(f"clip {name}: exists ({n} frames, seed {s}), skipped")
            continue
        clip_dir = os.path.join(root, name)
        if os.path.isdir(clip_dir):  # another seed's or face flag's files
            shutil.rmtree(clip_dir)
        gt = synth_subject.write_raw_clip(root, name, n, seed=s, image_size=image_size,
                                          with_face=with_face, device=device)
        np.savez(os.path.join(root, f"gt_{name}.npz"), seed=np.int64(s),
                 with_face=np.bool_(with_face), **gt)
        print(f"clip {name}: {n} frames written"
              + ("" if with_face else " (motion only, no frame store)"))


def phase_apc(root: str, epochs: int = 30, window: int = 480, stride: int = 60,
              batch: int = 8, lr: float = 1e-3, n_clips: int = 1,
              device: str = "cuda") -> str:
    """Self-supervised APC pretraining on the train clips' mels only; the
    first eighth of clip1 validates."""
    from livespeechportraits_torch.config import APCConfig
    from livespeechportraits_torch.ops import mel as mel_ops
    from livespeechportraits_torch.pipeline import video as video_mod
    from livespeechportraits_torch.train import datasets, trainer

    all_mels = []
    for name in train_clip_names(n_clips):
        wav = video_mod.load_wav(os.path.join(root, name, name + ".wav"))
        all_mels.append(mel_ops.compute_mel_sequence(wav, device=device).cpu().numpy())
    n_val = len(all_mels[0]) // 8
    train_mels = [all_mels[0][n_val:]] + all_mels[1:]
    sampler = datasets.MelWindowSampler(train_mels, window=window, stride=stride)
    val = datasets.MelWindowSampler([all_mels[0][:n_val]], window=window)
    loop = trainer.TrainLoopConfig(
        n_epochs=epochs, n_epochs_decay=0, lr=lr, batch_size=batch,
        checkpoints_dir=os.path.join(root, "ckpt"), name="apc", device=device,
        save_epoch_freq=max(1, epochs // 2), validate_epoch=max(1, epochs // 4))
    trainer.train_apc(APCConfig(), loop, sampler, val)
    return os.path.join(root, "ckpt", "apc", "ckpt")


def _encoder(apc_ckpt: str, device: str):
    from livespeechportraits_torch.config import APCConfig
    from livespeechportraits_torch.models import apc as apc_model

    return apc_model.load_pretrained_encoder(apc_ckpt, APCConfig(), device=device)


def phase_pack(root: str, apc_ckpt: str, unet_size: str = "normal", bank_stride: int = 2,
               n_clips: int = 1, image_size: int = 512, device: str = "cuda") -> None:
    """The servable pack from the train clips and the pretrained APC, and its
    YAML naming the U-Net size this run trains."""
    from livespeechportraits_torch.pipeline import build_person

    manifest = build_person.build_person_pack(
        root, train_clip_names(n_clips), apc=_encoder(apc_ckpt, device),
        image_size=image_size, bank_stride=bank_stride)
    name = os.path.basename(os.path.normpath(root))
    build_person.write_person_yaml(os.path.join(root, name + ".yaml"), root, use_lle=True,
                                   size=unet_size)
    print(json.dumps(manifest, indent=1))


def _clips(root: str, apc_ckpt: str, names, device: str):
    from livespeechportraits_torch.config import APCConfig
    from livespeechportraits_torch.train import data_io

    enc = _encoder(apc_ckpt, device)
    return [data_io.prepare_clip(os.path.join(root, n), n, enc, APCConfig()) for n in names]


def phase_a2f(root: str, apc_ckpt: str, epochs: int = 12, batch: int = 32, lr: float = 1e-4,
              decay_epochs: int = 0, n_clips: int = 1, seq_len: int = 240,
              tail_margin: int = 460, device: str = "cuda") -> str:
    from livespeechportraits_torch.config import Audio2FeatureConfig
    from livespeechportraits_torch.train import datasets, trainer

    clips = _clips(root, apc_ckpt, train_clip_names(n_clips) + [VAL_CLIP], device)
    tr, va = clips[:-1], [clips[-1]]

    def mk(c):
        return datasets.AudioVisualSampler(c, task="audio2feature", seq_len=seq_len,
                                           frame_jump_stride=4, tail_margin=tail_margin,
                                           device_audio=True)

    loop = trainer.TrainLoopConfig(
        n_epochs=epochs, n_epochs_decay=decay_epochs, lr=lr, batch_size=batch,
        checkpoints_dir=os.path.join(root, "ckpt"), name="a2f", device=device,
        save_epoch_freq=max(1, epochs // 2), validate_epoch=1)
    trainer.train_audio2feature(Audio2FeatureConfig(), loop, mk(tr), mk(va))
    return os.path.join(root, "ckpt", "a2f", "ckpt")


def phase_a2h(root: str, apc_ckpt: str, epochs: int = 10, batch: int = 16, lr: float = 1e-4,
              decay_epochs: int = 0, n_clips: int = 1, target_length: int = 240,
              tail_margin: int = 460, device: str = "cuda") -> str:
    from livespeechportraits_torch.config import Audio2HeadposeConfig
    from livespeechportraits_torch.train import datasets, trainer

    cfg = Audio2HeadposeConfig()
    clips = _clips(root, apc_ckpt, train_clip_names(n_clips) + [VAL_CLIP], device)
    tr, va = clips[:-1], [clips[-1]]

    def mk(c):
        return datasets.AudioVisualSampler(
            c, task="audio2headpose", target_length=target_length,
            receptive_field=cfg.wavenet.receptive_field, frame_future=cfg.frame_future,
            tail_margin=tail_margin, device_audio=True)

    try:
        val = mk(va)
    except ValueError as e:  # a held-out clip shorter than one window
        print(f"NOTE: Audio2Headpose trains without validation: {e}")
        val = None
    loop = trainer.TrainLoopConfig(
        n_epochs=epochs, n_epochs_decay=decay_epochs, lr=lr, batch_size=batch,
        checkpoints_dir=os.path.join(root, "ckpt"), name="a2h", device=device,
        save_epoch_freq=max(1, epochs // 2), validate_epoch=1)
    trainer.train_audio2headpose(cfg, loop, mk(tr), val)
    return os.path.join(root, "ckpt", "a2h", "ckpt")


def _f2f_config(unet_size: str, image_size: int, device: str):
    """The renderer's config: the U-Net's depth from the size (8
    downsamplings at 512^2), bf16 on the card, f32 on the CPU."""
    from livespeechportraits_torch.config import Feature2FaceConfig

    return Feature2FaceConfig(size=unet_size, load_size=image_size,
                              n_downsample=min(8, int(math.log2(image_size))),
                              precision="bfloat16" if device != "cpu" else "float32")


def phase_f2f(root: str, unet_size: str = "normal", epochs: int = 2, batch: int = 4,
              lr: float = 2e-4, frame_jump: int = 2, image_size: int = 512,
              device: str = "cuda") -> str:
    """The renderer: TTUR, the fused GAN step, each batch's edge maps drawn
    on the device, trained against the same candidate images serving reads
    (the pack's candidates/ copied into each clip directory, as the
    reference keeps them per clip); validated and panelled each epoch."""
    from livespeechportraits_torch.train import data_io, trainer

    for clip in (TRAIN_CLIP, VAL_CLIP):
        dst = os.path.join(root, clip, "candidates")
        if not os.path.isdir(dst):
            shutil.copytree(os.path.join(root, "candidates"), dst)
    cfg = _f2f_config(unet_size, image_size, device)
    sampler = data_io.load_face_clip(os.path.join(root, TRAIN_CLIP), TRAIN_CLIP,
                                     load_size=image_size, frame_jump=frame_jump)
    val = data_io.load_face_clip(os.path.join(root, VAL_CLIP), VAL_CLIP, load_size=image_size)
    for s in (sampler, val):
        s.device_rasterize = True  # train-time edges are serve-time edges
    loop = trainer.TrainLoopConfig(
        n_epochs=epochs, n_epochs_decay=0, lr=lr, batch_size=batch,
        checkpoints_dir=os.path.join(root, "ckpt"), name="f2f", ttur=True, fused_step=True,
        save_epoch_freq=1, validate_epoch=1, device=device)
    trainer.train_feature2face(cfg, loop, sampler, val_sampler=val, vgg=None)
    return os.path.join(root, "ckpt", "f2f", "ckpt")


def _eval_config(root: str, unet_size: str, image_size: int, device: str):
    """The pack's serving config with deterministic knobs: mouth amp 1 (the
    x2 liveliness amp would double the ground truth's motion), head-pose
    GMM at sigma 0 (the mean) with amp 1."""
    from livespeechportraits_torch import config as config_mod

    name = os.path.basename(os.path.normpath(root))
    cfg = config_mod.load_person_config(os.path.join(root, name + ".yaml"), name)
    return replace(
        cfg,
        audio2feature=replace(cfg.audio2feature, amp_params=(1.0, 1.0, 1.0)),
        audio2headpose=replace(cfg.audio2headpose, sample_sigma_scale=0.0, rot_amp=1.0,
                               trans_amp=1.0),
        feature2face=_f2f_config(unet_size, image_size, device))


def _gt_val_frames(root: str, n: int) -> np.ndarray:
    """The held-out clip's first n stored frames.  The synthetic clips are
    authored at the serving resolution (their change_paras crop is the
    identity), so the stored frame is the one to compare."""
    from livespeechportraits_torch.train import data_io

    frames = data_io.LazyH5Frames(os.path.join(root, VAL_CLIP, VAL_CLIP + ".h5"), VAL_CLIP,
                                  lambda img: img)
    try:
        return np.stack([frames[i] for i in range(n)])
    finally:
        frames.close()


def _openness(lm: np.ndarray) -> np.ndarray:
    """Frame-wise mouth opening from [T, 73, 2] px landmarks."""
    m = lm[:, 46:64, 1]
    return m.max(axis=1) - m.min(axis=1)


def _angdiff(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs((a - b + 180.0) % 360.0 - 180.0)


def _gt_pose(gt: dict, n: int) -> np.ndarray:
    # the ground truth's trans is stored [T, 3, 1] (the reference's 3d_fit_data layout)
    return np.concatenate([gt["rot"][:n], np.asarray(gt["trans"])[:n].reshape(n, 3)], axis=1)


def _motion_rows(lm: np.ndarray, gt_lm: np.ndarray) -> dict:
    op_p, op_g = _openness(lm), _openness(gt_lm)
    return {"mouth_l2_px": round(float(np.linalg.norm(
                lm[:, 46:64] - gt_lm[:, 46:64], axis=-1).mean()), 3),
            "mouth_open_corr": round(float(np.corrcoef(op_p, op_g)[0, 1]), 4)}


def phase_eval(root: str, unet_size: str = "normal", render_batch: int = 8, seed: int = 0,
               eval_seconds: float = 0.0, image_size: int = 512,
               device: str = "cuda") -> dict:
    """Serve the trained subject on the held-out audio and score it: the
    trained models, then the ground-truth landmarks through the trained
    renderer (teacher forced: the renderer's generalisation apart from the
    motion's error), then the random-init models (the floor).
    eval_seconds > 0 scores the first N seconds only."""
    from livespeechportraits_torch.models import losses as losses_mod
    from livespeechportraits_torch.pipeline import animate as animate_mod
    from livespeechportraits_torch.pipeline import assets as assets_mod
    from livespeechportraits_torch.pipeline import video as video_mod
    from livespeechportraits_torch.utils.metrics import fidelity_report, psnr

    cfg = _eval_config(root, unet_size, image_size, device)
    assets = assets_mod.load_person(cfg, data_root=root, image_size=image_size)
    ck = os.path.join(root, "ckpt")

    def _have(stage: str) -> str:  # a partly trained run still scores
        path = os.path.join(ck, stage, "ckpt")
        if not os.path.isdir(path):
            print(f"NOTE: no {stage} checkpoint at {path}; random init")
            return ""
        return path

    models = assets_mod.load_trained_person_models(
        cfg, assets_mod.load_person_models(cfg, device), f2f_ckpt=_have("f2f"),
        a2f_ckpt=_have("a2f"), a2h_ckpt=_have("a2h"), apc_ckpt=_have("apc"))
    gt = dict(np.load(os.path.join(root, f"gt_{VAL_CLIP}.npz")))
    wav = video_mod.load_wav(os.path.join(root, VAL_CLIP, VAL_CLIP + ".wav"))
    if eval_seconds > 0:
        wav = wav[:int(eval_seconds * 16000)]

    out = animate_mod.animate(cfg, assets, models, wav, seed=seed, render_batch=render_batch)
    n = out.nframe
    gt_lm = gt["landmarks2d"][:n]
    gt_frames = _gt_val_frames(root, n)
    vgg = losses_mod.init_vgg19().to(device)  # one VGG for every row: comparable rows
    d = (assets_mod.load_trained_discriminator(cfg, _have("f2f"), device)
         if _have("f2f") else None)
    gt_pose = _gt_pose(gt, n)

    def _scores(res) -> dict:
        lm = res.landmarks[:n]
        rot_err = _angdiff(res.headpose[:n, 0], gt["rot"][:n, 0] + 360.0)
        rows = fidelity_report(frames_a=res.frames[:n], frames_b=gt_frames, landmarks_a=lm,
                               landmarks_b=gt_lm, vgg=vgg, pts3d_a=res.pts3d[:n],
                               pts3d_b=gt["pts3d"][:n], pose_a=res.headpose[:n],
                               pose_b=gt_pose, d=d, device=device)
        rows["perceptual_note"] = "random-VGG (relative comparisons only)"
        rows.update(_motion_rows(lm, gt_lm))
        rows["rot_x_mae_deg"] = round(float(rot_err.mean()), 3)
        return rows

    metrics = {"trained": _scores(out)}
    dev = torch.device(device)
    tf_frames, _ = animate_mod.render_frames(
        cfg, assets, models, torch.as_tensor(gt_lm, dtype=torch.float32, device=dev),
        torch.as_tensor(np.repeat(gt["shoulders"][None], n, axis=0), dtype=torch.float32,
                        device=dev), render_batch=render_batch)
    metrics["teacher_forced_psnr_db"] = round(float(psnr(tf_frames, gt_frames)), 2)
    rnd = animate_mod.animate(cfg, assets, assets_mod.load_person_models(cfg, device), wav,
                              seed=seed, render_batch=render_batch)
    metrics["random_init"] = _scores(rnd)

    video_path = os.path.join(root, "e2e_heldout.avi")
    try:
        metrics["video"] = video_mod.write_video(out.frames, video_path, audio=wav)
    except Exception as e:  # a host without cv2 still gets the metrics
        metrics["video"] = f"unwritten ({e})"
    metrics["n_frames_scored"] = n
    # the motion arrays (small beside the frames): 'rescore' recomputes the
    # geometry and pose rows from them without serving again
    np.savez(os.path.join(root, "eval_outputs.npz"),
             trained_landmarks=out.landmarks[:n], trained_headpose=out.headpose[:n],
             trained_pts3d=out.pts3d[:n], random_landmarks=rnd.landmarks[:n],
             random_headpose=rnd.headpose[:n], random_pts3d=rnd.pts3d[:n])
    with open(os.path.join(root, "e2e_metrics.json"), "w") as f:
        json.dump(metrics, f, indent=1)
    print(json.dumps(metrics))
    return metrics


def phase_rescore(root: str) -> dict:
    """Recompute the geometry and pose-realism rows of e2e_metrics.json from
    eval_outputs.npz, with no device and no serving; the frame rows stay."""
    from livespeechportraits_torch.utils.metrics import fidelity_report

    gt = dict(np.load(os.path.join(root, f"gt_{VAL_CLIP}.npz")))
    outs = dict(np.load(os.path.join(root, "eval_outputs.npz")))
    path = os.path.join(root, "e2e_metrics.json")
    with open(path) as f:
        metrics = json.load(f)
    n = int(metrics["n_frames_scored"])
    gt_lm = gt["landmarks2d"][:n]
    for arm, key in (("trained", "trained"), ("random", "random_init")):
        lm = outs[f"{arm}_landmarks"][:n]
        rows = fidelity_report(landmarks_a=lm, landmarks_b=gt_lm,
                               pts3d_a=outs[f"{arm}_pts3d"][:n], pts3d_b=gt["pts3d"][:n],
                               pose_a=outs[f"{arm}_headpose"][:n], pose_b=_gt_pose(gt, n))
        rows.update(_motion_rows(lm, gt_lm))
        metrics[key].update(rows)
    with open(path, "w") as f:
        json.dump(metrics, f, indent=1)
    print(json.dumps(metrics))
    return metrics


PHASES = ("clips", "apc", "pack", "a2f", "a2h", "f2f", "eval", "rescore")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m livespeechportraits_torch.tools.e2e_subject",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=DEFAULT_ROOT)
    p.add_argument("--train_frames", type=int, default=3600)
    p.add_argument("--val_frames", type=int, default=1440)
    p.add_argument("--unet_size", default="normal", choices=["small", "normal", "large"])
    p.add_argument("--phases", default="clips,apc,pack,a2f,a2h,f2f,eval",
                   help=f"comma-separated, of {', '.join(PHASES)}")
    p.add_argument("--train_clips", type=int, default=1,
                   help="train clips of --train_frames each (the corpus for the motion "
                        "models; the renderer trains on clip1)")
    p.add_argument("--apc_epochs", type=int, default=30)
    p.add_argument("--a2f_epochs", type=int, default=12)
    p.add_argument("--a2h_epochs", type=int, default=10)
    p.add_argument("--a2f_decay", type=int, default=0,
                   help="linearly decaying epochs after --a2f_epochs")
    p.add_argument("--a2h_decay", type=int, default=0)
    p.add_argument("--f2f_epochs", type=int, default=2)
    p.add_argument("--f2f_batch", type=int, default=4)
    p.add_argument("--f2f_frame_jump", type=int, default=2,
                   help="the renderer trains on every n-th frame of clip1")
    p.add_argument("--eval_seconds", type=float, default=0.0,
                   help="score the first N s of the held-out clip (0 = all of it)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--image_size", type=int, default=512,
                   help="clips, pack, renderer and serving resolution")
    p.add_argument("--apc_window", type=int, default=480, help="APC windows, 120 Hz rows")
    p.add_argument("--a2f_seq_len", type=int, default=240)
    p.add_argument("--a2h_target_length", type=int, default=240)
    p.add_argument("--tail_margin", type=int, default=460,
                   help="the audio samplers' tail guard (the reference's 400 + 60)")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return p


def main(argv=None) -> dict:
    """Run the phases asked for; returns {"walls": seconds a phase, and
    "metrics" when eval or rescore ran}."""
    args = build_parser().parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device} was asked for but torch sees no CUDA "
                         "device; pass --device cpu")
    phases = args.phases.split(",")
    unknown = sorted(set(phases) - set(PHASES))
    if unknown:
        raise SystemExit(f"unknown phases {unknown}; of {PHASES}")
    os.makedirs(args.root, exist_ok=True)
    apc_ckpt = os.path.join(args.root, "ckpt", "apc", "ckpt")
    dev, root, n = args.device, args.root, args.train_clips
    run = {
        "clips": lambda: phase_clips(root, args.train_frames, args.val_frames, args.seed,
                                     n_clips=n, image_size=args.image_size, device=dev),
        "apc": lambda: phase_apc(root, epochs=args.apc_epochs, window=args.apc_window,
                                 n_clips=n, device=dev),
        "pack": lambda: phase_pack(root, apc_ckpt, unet_size=args.unet_size, n_clips=n,
                                   image_size=args.image_size, device=dev),
        "a2f": lambda: phase_a2f(root, apc_ckpt, epochs=args.a2f_epochs,
                                 decay_epochs=args.a2f_decay, n_clips=n,
                                 seq_len=args.a2f_seq_len, tail_margin=args.tail_margin,
                                 device=dev),
        "a2h": lambda: phase_a2h(root, apc_ckpt, epochs=args.a2h_epochs,
                                 decay_epochs=args.a2h_decay, n_clips=n,
                                 target_length=args.a2h_target_length,
                                 tail_margin=args.tail_margin, device=dev),
        "f2f": lambda: phase_f2f(root, unet_size=args.unet_size, epochs=args.f2f_epochs,
                                 batch=args.f2f_batch, frame_jump=args.f2f_frame_jump,
                                 image_size=args.image_size, device=dev),
        "eval": lambda: phase_eval(root, unet_size=args.unet_size, seed=args.seed,
                                   eval_seconds=args.eval_seconds,
                                   image_size=args.image_size, device=dev),
        "rescore": lambda: phase_rescore(root),
    }
    out: dict = {"walls": {}}
    for name in PHASES:
        if name in phases:
            t0 = time.perf_counter()
            res = run[name]()
            out["walls"][name] = time.perf_counter() - t0
            if name in ("eval", "rescore"):
                out["metrics"] = res
    print(json.dumps({"phase_walls_s": out["walls"]}))
    return out


if __name__ == "__main__":
    main()
