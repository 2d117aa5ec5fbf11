"""Training CLI of the PyTorch port, the counterpart of the JAX package's
root ``train.py``:

    python -m livespeechportraits_torch.train --task apc            --synthetic
    python -m livespeechportraits_torch.train --task audio2feature  --synthetic
    python -m livespeechportraits_torch.train --task audio2headpose --synthetic
    python -m livespeechportraits_torch.train --task feature2face   --synthetic
    python -m livespeechportraits_torch.train --task feature2face   --synthetic --qat_int8 --qat_d
    python -m livespeechportraits_torch.train --task feature2face   --synthetic --fused_step \
        --remat --vgg random --vgg_microbatch 2
    python -m livespeechportraits_torch.train --task apc --dataroot R --clip_names c0,c1
    python -m livespeechportraits_torch.train --task audio2feature --dataroot R \
        --clip_names c0 --apc_ckpt checkpoints/apc/ckpt
    torchrun --nproc_per_node=N -m livespeechportraits_torch.train --task feature2face \
        --synthetic --data_parallel [--zero1]

It trains on the card at the default full width; ``--device cpu`` trains on
the CPU (a small --image_size / window keeps that short).  ``--synthetic``
fabricates the data (``synthetic_clips``, ``synthetic_face_data``,
``synthetic_mels``, the port's copies of train.py's); without it the data
are a subject's reference-layout clips under ``--dataroot`` (the mels of
their wavs for APC, ``data_io.prepare_clip`` for the motion models, with
the features of the ``--apc_ckpt`` encoder, ``data_io.load_face_clip`` for
the renderer).  Feature2Face draws each batch's edge maps on the device (K1
on the card), so ``--device_rasterize`` is the port's default; ``--qat``,
``--qat_int8`` and ``--qat_d`` train it quantization-aware, ``--fused_step``
with one step from shared forwards, ``--remat`` and ``--vgg_microbatch``
with less activation memory (trainer.TrainLoopConfig).  Each run writes
``<checkpoints_dir>/<name>/ckpt/<epoch>.pt`` (and ``ckpt_best``), which
``serve.Predictor.setup(f2f_ckpt=..., a2f_ckpt=..., a2h_ckpt=...,
apc_ckpt=...)`` serves.  ``--data_parallel`` makes the run one rank of a
process group (torchrun's, else a group of one rank on one card, JAX's
one-device mesh), ``--batch_size`` the global batch, and ``--zero1``
partitions the Adam moments over the ranks (trainer.TrainLoopConfig).
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def synthetic_clips(n_clips: int, frames: int, feat_dim: int = 512):
    """Training clips with random audio features and smooth random head
    motion (the JAX train.py's, draw for draw)."""
    from livespeechportraits_torch.train import datasets

    rng = np.random.default_rng(0)
    clips = []
    for _ in range(n_clips):
        t = np.arange(frames)
        pose = np.stack([5 * np.sin(t / (13 + 3 * i)) for i in range(3)] +
                        [0.02 * np.cos(t / (17 + 2 * i)) for i in range(3)], axis=1)
        clips.append(datasets.make_clip(
            audio_features=rng.normal(0, 1, (2 * frames, feat_dim)).astype(np.float32),
            pts3d=rng.normal(0, 0.01, (frames, 73, 3)).astype(np.float32),
            rot_angles=pose[:, :3].astype(np.float32) + np.array([170.0, 0, 0], np.float32),
            trans=pose[:, 3:].astype(np.float32),
        ))
    return clips


def synthetic_face_data(n_frames: int, H: int, device_rasterize: bool = True):
    """Renderer data with a learnable mapping: landmarks of a 73-point face
    in smooth sway with the mouth opening and closing, and as the target the
    stylised rendering of those landmarks' edge map (edge glow over a
    vignette).  The JAX train.py's, frame for frame."""
    from livespeechportraits_torch.config import MOUTH_INDICES
    from livespeechportraits_torch.ops import rasterize
    from livespeechportraits_torch.pipeline.assets import _synthetic_face_landmarks
    from livespeechportraits_torch.pipeline.synth_subject import stylise_edges
    from livespeechportraits_torch.train import datasets

    pts = _synthetic_face_landmarks()
    f = H * 2.4
    t = np.arange(n_frames, dtype=np.float32)
    sway = np.stack([0.02 * np.sin(t / 11.0), 0.015 * np.cos(t / 17.0), np.zeros_like(t)],
                    axis=1)
    mouth_open = 0.5 + 0.5 * np.sin(t / 3.0)
    mouth = np.asarray(MOUTH_INDICES)
    xs = np.linspace(H * 0.2, H * 0.8, 9, dtype=np.float32)
    shoulders = np.concatenate([np.stack([xs, np.full(9, H * 0.8)], 1),
                                np.stack([xs, np.full(9, H * 0.8 + 14)], 1)]).astype(np.float32)
    lms, edges = [], []
    for i in range(n_frames):
        p = pts + sway[i]
        p[mouth, 1] = -0.05 + (pts[mouth, 1] + 0.05) * (1.0 + 1.5 * mouth_open[i]) + sway[i, 1]
        X = p + np.array([0.0, 0.05, 1.0], np.float32)
        lm = np.stack([f * X[:, 0] / X[:, 2] + H / 2, f * X[:, 1] / X[:, 2] + H / 2],
                      axis=1).astype(np.float32)
        lms.append(lm)
        edges.append(rasterize.rasterize_feature_map_host(lm, shoulders, (H, H)))
    images = stylise_edges(np.stack(edges).astype(np.float32) / 255.0)
    cand = np.repeat(((images[0].astype(np.float32) / 255.0 - 0.5) / 0.5)[None], 4, 0)
    return datasets.FaceFrameSampler(images, np.stack(lms), shoulders, cand, load_size=H,
                                     device_rasterize=device_rasterize)


def synthetic_mels(n_utts: int, frames: int, mel_dim: int = 80):
    """Log-mel sequences with a predictable future: smooth wandering formant
    tracks plus a little noise (the JAX train.py's, draw for draw)."""
    rng = np.random.default_rng(0)
    t = np.arange(frames, dtype=np.float32)[:, None]
    bins = np.arange(mel_dim, dtype=np.float32)[None, :]
    utts = []
    for _ in range(n_utts):
        m = np.zeros((frames, mel_dim), np.float32)
        for _ in range(4):
            centre = (mel_dim / 2) * (1 + np.sin(t / rng.uniform(40, 120) + rng.uniform(0, 6)))
            width = rng.uniform(3, 8)
            m += np.exp(-((bins - centre) ** 2) / (2 * width * width))
        m += rng.normal(0, 0.02, m.shape)
        utts.append(np.clip(m, 0.0, 1.0).astype(np.float32))
    return utts


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m livespeechportraits_torch.train",
                                description="Train one model of the PyTorch port")
    p.add_argument("--task", required=True,
                   choices=["apc", "audio2feature", "audio2headpose", "feature2face"])
    p.add_argument("--name", default=None)
    p.add_argument("--checkpoints_dir", default="./checkpoints")
    p.add_argument("--synthetic", action="store_true", help="train on fabricated data")
    p.add_argument("--dataroot", default="",
                   help="subject data root (reference layout: <root>/<clip>/...)")
    p.add_argument("--clip_names", default="",
                   help="comma-separated clip directory names under --dataroot")
    p.add_argument("--apc_ckpt", default="",
                   help="APC encoder for the clips' features: a reference .model file or "
                        "a `--task apc` run's checkpoint directory")
    p.add_argument("--mel_window", type=int, default=480,
                   help="apc: training window length in 120 Hz mel frames")
    p.add_argument("--print_freq", type=int, default=10)
    p.add_argument("--n_epochs", type=int, default=2)
    p.add_argument("--n_epochs_decay", type=int, default=2)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--continue_train", action="store_true")
    p.add_argument("--data_parallel", action="store_true",
                   help="train as one rank of a process group (launch with torchrun; plain "
                        "python is a group of one rank); --batch_size is the global batch")
    p.add_argument("--zero1", action="store_true",
                   help="partition the optimizers' state over the ranks (ZeRO-1; needs "
                        "--data_parallel)")
    p.add_argument("--smooth_loss", type=float, default=0.0)
    p.add_argument("--loss", default="L2", choices=["L2", "GMM"],
                   help="audio2feature loss: MSE or the GMM NLL")
    p.add_argument("--TTUR", action="store_true")
    p.add_argument("--fused_step", action="store_true",
                   help="feature2face: one step updating D and G from one G forward and two "
                        "D forwards (steps.f2f_fused_step)")
    p.add_argument("--remat", action="store_true",
                   help="feature2face: recompute the generator's forward in the backward "
                        "(less activation memory, more time)")
    p.add_argument("--qat", action="store_true",
                   help="feature2face: quantization-aware training, the generator's forward "
                        "running the deployed int8 arithmetic (f32 emulation)")
    p.add_argument("--qat_int8", action="store_true",
                   help="feature2face: QAT with the generator's int8 convs on the int8 "
                        "kernel (implies --qat)")
    p.add_argument("--qat_d", action="store_true",
                   help="feature2face: the discriminator's interior convs on the int8 "
                        "kernel, straight-through gradients (checkpoints stay float)")
    p.add_argument("--vgg", default="none",
                   help="feature2face perceptual/style loss: 'none', 'random' (a seeded "
                        "random VGG19) or a torchvision VGG19 .npz (losses.load_vgg19_npz)")
    p.add_argument("--vgg_microbatch", type=int, default=0,
                   help="feature2face: run the VGG loss's tower in chunks of N samples, "
                        "recomputed in the backward (0 = the whole batch at once)")
    p.add_argument("--device_rasterize", action="store_true",
                   help="feature2face: edge maps drawn on the device (the port's default)")
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--sequence_length", type=int, default=240)
    p.add_argument("--time_frame_length", type=int, default=240)
    p.add_argument("--no_save_best", action="store_true",
                   help="do not keep <name>/ckpt_best (the lowest-validation epoch)")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return p


def _need_clips(args) -> list:
    if not args.dataroot or not args.clip_names:
        raise SystemExit("real-data training needs --dataroot and --clip_names "
                         "(or use --synthetic)")
    return args.clip_names.split(",")


def _load_mels(args) -> list:
    """120 Hz log-mel sequences of the clips' wavs (the denoised one first),
    computed on --device."""
    from livespeechportraits_torch.ops import mel as mel_ops
    from livespeechportraits_torch.pipeline import video
    from livespeechportraits_torch.train import data_io

    mels = []
    for name in _need_clips(args):
        wav = video.load_wav(data_io.clip_wav_path(os.path.join(args.dataroot, name), name))
        mels.append(mel_ops.compute_mel_sequence(wav, device=args.device).cpu().numpy())
    return mels


def _load_real_clips(args) -> list:
    """The clips as ClipData (data_io.prepare_clip), their APC features from
    the --apc_ckpt encoder (a `--task apc` run's directory or a reference
    .model file; a seeded random encoder, with a warning, without one),
    computed once on --device and cached beside each wav."""
    from livespeechportraits_torch.config import APCConfig
    from livespeechportraits_torch.models import apc as apc_model
    from livespeechportraits_torch.train import data_io, trainer
    from livespeechportraits_torch.utils import convert

    names = _need_clips(args)
    cfg = APCConfig()
    if args.apc_ckpt and os.path.isdir(args.apc_ckpt):
        enc = apc_model.load_pretrained_encoder(args.apc_ckpt, cfg, device=args.device)
    else:
        enc = apc_model.APCEncoder(cfg)
        if args.apc_ckpt:
            enc.load_state_dict(convert.load_state_dict(args.apc_ckpt), strict=True)
        else:
            print("WARNING: no --apc_ckpt; using random-init APC features "
                  "(pretrain one: --task apc)")
            trainer._init(enc, 0)
        enc = enc.to(args.device).eval().requires_grad_(False)
    return [data_io.prepare_clip(os.path.join(args.dataroot, n), n, enc, cfg) for n in names]


def _load_real_face_data(args):
    """The clips' renderer data (data_io.load_face_clip, frames decoded as
    sampled), spanning every clip (datasets.ConcatFaceSampler), the edge
    maps drawn on the device."""
    from livespeechportraits_torch.train import data_io, datasets

    samplers = [data_io.load_face_clip(os.path.join(args.dataroot, n), n,
                                       load_size=args.image_size)
                for n in _need_clips(args)]
    for s in samplers:
        s.device_rasterize = True
    return samplers[0] if len(samplers) == 1 else datasets.ConcatFaceSampler(samplers)


def main(argv=None):
    """Train one task as the arguments say; returns its trainer.TrainResult.
    A --data_parallel run ends the process group it joined."""
    args = build_parser().parse_args(argv)
    from livespeechportraits_torch.parallel import multihost

    try:
        return _train(args)
    finally:
        if args.data_parallel:
            multihost.shutdown()


def _train(args):
    from livespeechportraits_torch.config import (APCConfig, Audio2FeatureConfig,
                                                  Audio2HeadposeConfig, Feature2FaceConfig)
    from livespeechportraits_torch.train import datasets, trainer

    loop = trainer.TrainLoopConfig(
        n_epochs=args.n_epochs, n_epochs_decay=args.n_epochs_decay, lr=args.lr,
        batch_size=args.batch_size, print_freq=args.print_freq,
        checkpoints_dir=args.checkpoints_dir, name=args.name or args.task,
        continue_train=args.continue_train, smooth_loss=args.smooth_loss, ttur=args.TTUR,
        save_best=not args.no_save_best, device=args.device, qat=args.qat,
        qat_int8=args.qat_int8, qat_d=args.qat_d, fused_step=args.fused_step,
        remat=args.remat, vgg_microbatch=args.vgg_microbatch, data_parallel=args.data_parallel,
        zero1=args.zero1)
    # no card for a card's run, or a group that cannot start: raise before reading any data
    loop.device = args.device = str(trainer._device(loop))
    if args.task == "apc":
        mels = synthetic_mels(4, 2400) if args.synthetic else _load_mels(args)
        # one clip trains on itself, without validation; more hold out an eighth
        n_val = max(1, len(mels) // 8) if len(mels) > 1 else 0
        sampler = datasets.MelWindowSampler(mels[n_val:] or mels, window=args.mel_window,
                                            stride=args.mel_window // 2)
        val_sampler = (datasets.MelWindowSampler(mels[:n_val], window=args.mel_window)
                       if n_val else None)
        res = trainer.train_apc(APCConfig(), loop, sampler, val_sampler)
    elif args.task == "audio2feature":
        clips = synthetic_clips(2, 1400) if args.synthetic else _load_real_clips(args)
        sampler = datasets.AudioVisualSampler(
            clips, task="audio2feature", seq_len=args.sequence_length,
            frame_jump_stride=4, device_audio=True)
        res = trainer.train_audio2feature(Audio2FeatureConfig(loss=args.loss), loop, sampler)
    elif args.task == "audio2headpose":
        cfg = Audio2HeadposeConfig()
        clips = synthetic_clips(2, 1800) if args.synthetic else _load_real_clips(args)
        sampler = datasets.AudioVisualSampler(
            clips, task="audio2headpose",
            target_length=args.time_frame_length, receptive_field=cfg.wavenet.receptive_field,
            frame_future=cfg.frame_future, device_audio=True)
        res = trainer.train_audio2headpose(cfg, loop, sampler)
    else:
        from livespeechportraits_torch.models import losses

        cfg = Feature2FaceConfig(load_size=args.image_size,
                                 n_downsample=min(8, int(np.log2(args.image_size))))
        vgg = None
        if args.vgg == "random":
            vgg = losses.init_vgg19(0)
        elif args.vgg != "none":
            vgg = losses.load_vgg19_npz(args.vgg)
        sampler = (synthetic_face_data(80, args.image_size) if args.synthetic
                   else _load_real_face_data(args))
        res = trainer.train_feature2face(cfg, loop, sampler, vgg=vgg)
    print("training done")
    return res


if __name__ == "__main__":
    main()
