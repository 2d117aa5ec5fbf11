"""Offline inference CLI of the PyTorch port.

    python -m livespeechportraits_torch.demo --id Synthetic --driving_audio tone.wav
    python -m livespeechportraits_torch.demo --quantize --artifact serving_int8.npz \\
        --bucket_seconds 1 --save_intermediates 1

Runs audio -> frames at 60 FPS on one device (``--device``, default
``cuda``), offline or, with ``--streaming``, through the live path (audio
pushed 100 ms at a time, frames as they are determined), with any
``--transfer``; prints the per-stage ms and the frame rate, and writes
``<results_dir>/<id>/<audio name>/<audio name>.avi`` when cv2 is importable,
otherwise ``frames.npy`` plus the ``.wav`` there.  ``--id Synthetic`` (or an
id whose ``<config_dir>/<id>.yaml`` names no data root) fabricates an asset
pack and random-init models, so no data or checkpoint is needed; any other
id reads the subject its YAML points at (a pack made by
``python -m livespeechportraits_torch.tools.build_person``) with its
checkpoints.  A missing audio file falls back to a 3 s test tone.

The flags of the JAX package's demo.py: ``--f2f_ckpt`` / ``--a2f_ckpt`` /
``--a2h_ckpt`` / ``--apc_ckpt`` serve the port trainer's checkpoints;
``--quantize`` runs the renderer in int8 (on the kernel K4 on the card),
with static activation scales calibrated on this clip's first render batch
unless ``--no_calibrate``; ``--artifact`` boots the models from a serving
.npz when it exists and writes the models built here to it when it does
not; ``--bucket_seconds`` pads the audio to a multiple of that length (the
result is the unpadded run's); ``--save_intermediates`` also writes the
frames as numbered jpgs and ``landmarks.npy`` / ``headpose.npy``; a config
with ``Image2Image: {save_input: true}`` writes the renderer's edge maps as
``<audio name>_feature_maps.avi``; ``--fused`` runs the motion half as
one fused program (on the card two CUDA graphs and one launch of the
head-pose decode kernel, pipeline/motion_graph.py; the same results, one
"motion" stage entry).
"""

from __future__ import annotations

import argparse
import json
import os
import time
from os.path import join

import numpy as np


def _write_video(video_mod, frames: np.ndarray, save_root: str, name: str, npy: str,
                 audio: np.ndarray) -> None:
    """``<name>.avi`` with the audio, or without cv2 the frames as ``npy``
    and the ``.wav``; says what it wrote."""
    if video_mod.cv2 is not None:
        print(f"wrote video {video_mod.write_video(frames, join(save_root, name + '.avi'), audio)}")
        return
    npy, wav = join(save_root, npy), join(save_root, name + ".wav")
    np.save(npy, frames)
    video_mod.save_wav(wav, audio[: int(len(frames) * 16000 / 60)])
    print(f"cv2 is not importable: wrote frames {npy} and audio {wav}")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--id", default="Synthetic",
                        help="person id: <config_dir>/<id>.yaml names its data and "
                             "checkpoints; 'Synthetic' needs neither")
    parser.add_argument("--config_dir", default="./config",
                        help="directory of the per-person YAML files")
    parser.add_argument("--driving_audio", default="./data/input/00083.wav")
    parser.add_argument("--save_intermediates", type=int, default=0,
                        help="also write the frames as numbered pred_<i>.jpg files and the "
                             "landmarks and head poses as .npy")
    parser.add_argument("--results_dir", default="./results")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--render_batch", type=int, default=8)
    parser.add_argument("--image_size", type=int, default=0,
                        help="render resolution, a power of two (0 = config, 512)")
    parser.add_argument("--duration", type=float, default=0.0,
                        help="cap on driving-audio seconds (0 = full)")
    parser.add_argument("--device", default="cuda", help="torch device, e.g. cuda or cpu")
    parser.add_argument("--transfer", default="rgb",
                        choices=["rgb", "yuv420", "jpeg", "jpeg4", "pack4e"],
                        help="the frames' transfer to the host: yuv420 halves the bytes; "
                             "jpeg, jpeg4 and pack4e are DCT codes made on the device "
                             "(pack4e fetches only its coded prefix)")
    parser.add_argument("--streaming", action="store_true",
                        help="drive the live streaming path (audio pushed in 100 ms "
                             "chunks, frames emitted as they are determined)")
    parser.add_argument("--bucket_seconds", type=float, default=0.0,
                        help="pad the audio up to the next multiple of this many seconds, "
                             "so clips of nearby lengths run the same shapes; the result is "
                             "the unpadded run's (serve.py semantics). 0 = exact length")
    parser.add_argument("--f2f_ckpt", default="",
                        help="checkpoint directory of a feature2face training run "
                             "(<checkpoints_dir>/<name>/ckpt): serve the trained renderer")
    parser.add_argument("--a2f_ckpt", default="",
                        help="checkpoint directory of an audio2feature training run")
    parser.add_argument("--a2h_ckpt", default="",
                        help="checkpoint directory of an audio2headpose training run")
    parser.add_argument("--apc_ckpt", default="",
                        help="checkpoint directory of an apc pretraining run (the LLE "
                             "feature bank must come from the same encoder)")
    parser.add_argument("--quantize", action="store_true",
                        help="int8-quantize the renderer (BN folded into the convs; on the "
                             "card its convs run on the int8 kernel K4)")
    parser.add_argument("--artifact", default="",
                        help="serving-model .npz: load the models from it if it exists "
                             "(skips the checkpoints, quantization and calibration), else "
                             "save the models built by this run to it")
    parser.add_argument("--no_calibrate", action="store_true",
                        help="with --quantize: keep dynamic per-conv activation scales "
                             "instead of static ones calibrated on this clip's first frames")
    parser.add_argument("--pipeline_depth", type=int, default=0,
                        help="with --streaming: hand each push's frames back up to N "
                             "pushes later, so their fetch overlaps the next pushes")
    parser.add_argument("--fused", action="store_true",
                        help="run the motion half (mel->APC->LLE->mouth->head-pose->post) as "
                             "the fused program: CUDA graphs on the card and one kernel "
                             "launch for the head-pose decode (same results; one 'motion' "
                             "stage entry)")
    args = parser.parse_args(argv)

    import torch

    from livespeechportraits_torch.config import PersonConfig, load_person_config
    from livespeechportraits_torch.pipeline import animate as animate_mod
    from livespeechportraits_torch.pipeline import assets as assets_mod
    from livespeechportraits_torch.pipeline import video as video_mod

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda was asked for but torch sees no CUDA device")
    if args.image_size & (args.image_size - 1):
        raise SystemExit(f"--image_size {args.image_size} must be a power of two")
    ckpts = {"f2f_ckpt": args.f2f_ckpt, "a2f_ckpt": args.a2f_ckpt, "a2h_ckpt": args.a2h_ckpt,
             "apc_ckpt": args.apc_ckpt}
    boot_artifact = bool(args.artifact) and os.path.exists(args.artifact)
    if any(ckpts.values()) and boot_artifact:
        # never silently serve stale artifact weights over a freshly named checkpoint
        raise SystemExit(f"--artifact {args.artifact} already exists and would shadow the "
                         "--*_ckpt weights; delete it (it will be rebuilt from the "
                         "checkpoints) or drop the ckpt flags")
    cfg_path = join(args.config_dir, args.id + ".yaml")
    cfg = (load_person_config(cfg_path, name=args.id) if os.path.exists(cfg_path)
           else PersonConfig(name=args.id))
    # with an existing artifact the subject's checkpoints are not read
    cfg, person_assets, person_models = assets_mod.load_subject(
        cfg, args.image_size or None, skip_models=boot_artifact, device=device)

    if os.path.exists(args.driving_audio):
        audio = video_mod.load_wav(args.driving_audio)
    else:
        print(f"driving audio {args.driving_audio!r} not found; using a 3 s test tone")
        audio = video_mod.make_test_tone(3.0)
    if args.duration > 0:
        audio = audio[: int(args.duration * 16000)]
    min_seconds = (cfg.audio2headpose.frame_future + 1) / 60.0
    if len(audio) < int(min_seconds * 16000) + 16000 // 60:
        raise SystemExit(f"driving audio too short: {len(audio) / 16000:.2f}s; needs > "
                         f"{min_seconds:.2f}s")

    if boot_artifact:
        person_models = assets_mod.load_models_artifact(args.artifact, cfg, device)
    else:
        if any(ckpts.values()):
            # the trainers' checkpoints replace their stages before
            # quantization and before the artifact is written
            person_models = assets_mod.load_trained_person_models(cfg, person_models, **ckpts)
        if args.quantize:
            calib = calib_dtype = None
            if not args.no_calibrate:
                calib = animate_mod.build_render_inputs(
                    cfg, person_assets, person_models, audio, seed=args.seed,
                    max_frames=max(args.render_batch, 8))
                if cfg.feature2face.precision == "bfloat16":
                    calib_dtype = torch.bfloat16
            person_models = assets_mod.quantize_person_models(
                person_models, calibrate_inputs=calib, calibrate_dtype=calib_dtype)
        if args.artifact:
            os.makedirs(os.path.dirname(os.path.abspath(args.artifact)), exist_ok=True)
            print(f"wrote artifact {assets_mod.save_models_artifact(person_models, args.artifact)}")

    audio_name = os.path.splitext(os.path.basename(args.driving_audio))[0]
    save_root = join(args.results_dir, args.id, audio_name)
    os.makedirs(save_root, exist_ok=True)
    print(f"Animating {len(audio) / 16000:.2f}s of audio for '{args.id}' on {device} ...")
    t0 = time.perf_counter()
    if args.streaming:
        ignored = [n for n, v in (("--save_intermediates", args.save_intermediates),
                                  ("--bucket_seconds", args.bucket_seconds),
                                  ("--fused", args.fused)) if v]
        if ignored:
            print(f"note: {', '.join(ignored)} have no effect with --streaming "
                  "(offline-path flags)")
        from livespeechportraits_torch.pipeline.streaming import StreamingAnimator

        stream = StreamingAnimator(cfg, person_assets, person_models, seed=args.seed,
                                   render_batch=args.render_batch, transfer=args.transfer,
                                   pipeline_depth=args.pipeline_depth)
        chunks, first_at = [], None
        for out in stream.run(audio):  # 100 ms pushes
            if first_at is None:
                first_at = time.perf_counter() - t0
            chunks.append(out)
        frames = np.concatenate(chunks)
        wall = time.perf_counter() - t0
        print(f"stages (ms): {json.dumps({k: round(v, 1) for k, v in stream.stage_ms.items()})}")
        print(f"streaming: first frame after {first_at:.2f}s (algorithmic latency "
              f"{stream.latency_frames} frames); {len(frames)} frames in {wall:.2f}s -> "
              f"{len(frames) / wall:.1f} fps")
        _write_video(video_mod, frames, save_root, audio_name, "frames.npy", audio)
        return

    true_audio, valid_frames = audio, None
    if args.bucket_seconds > 0:
        bucket = int(args.bucket_seconds * 16000)
        audio = np.pad(audio, (0, -(-len(audio) // bucket) * bucket - len(audio)))
        valid_frames = int(len(true_audio) / 16000 * 60)
    result = animate_mod.animate(cfg, person_assets, person_models, audio, seed=args.seed,
                                 render_batch=args.render_batch,
                                 keep_feature_maps=bool(cfg.feature2face.save_input),
                                 transfer=args.transfer, valid_frames=valid_frames,
                                 fused=args.fused)
    wall = time.perf_counter() - t0
    print(f"stages (ms): {json.dumps({k: round(v, 1) for k, v in result.stage_ms.items()})}")
    print(f"{result.nframe} frames in {wall:.2f}s -> {result.nframe / wall:.1f} fps end-to-end")
    _write_video(video_mod, result.frames, save_root, audio_name, "frames.npy", true_audio)
    if result.feature_maps is not None:
        _write_video(video_mod, np.repeat(result.feature_maps[..., None], 3, axis=-1),
                     save_root, audio_name + "_feature_maps", "feature_maps.npy", true_audio)
    if args.save_intermediates:
        written = video_mod.save_frames(result.frames, save_root, "pred_")
        np.save(join(save_root, "landmarks.npy"), result.landmarks)
        np.save(join(save_root, "headpose.npy"), result.headpose)
        print(f"wrote {len(written)} frame file(s) ({os.path.basename(written[0])} ..), "
              f"landmarks.npy and headpose.npy in {save_root}")
    print("Finish!")


if __name__ == "__main__":
    main()
