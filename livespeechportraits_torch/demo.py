"""Offline inference CLI of the PyTorch port.

    python -m livespeechportraits_torch.demo --id Synthetic --driving_audio tone.wav

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
"""

from __future__ import annotations

import argparse
import json
import os
import time
from os.path import join

import numpy as np


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--id", default="Synthetic",
                        help="person id: <config_dir>/<id>.yaml names its data and "
                             "checkpoints; 'Synthetic' needs neither")
    parser.add_argument("--config_dir", default="./config",
                        help="directory of the per-person YAML files")
    parser.add_argument("--driving_audio", default="./data/input/00083.wav")
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
    parser.add_argument("--pipeline_depth", type=int, default=0,
                        help="with --streaming: hand each push's frames back up to N "
                             "pushes later, so their fetch overlaps the next pushes")
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
    cfg_path = join(args.config_dir, args.id + ".yaml")
    cfg = (load_person_config(cfg_path, name=args.id) if os.path.exists(cfg_path)
           else PersonConfig(name=args.id))
    cfg, person_assets, person_models = assets_mod.load_subject(
        cfg, args.image_size or None, device=device)

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

    print(f"Animating {len(audio) / 16000:.2f}s of audio for '{args.id}' on {device} ...")
    t0 = time.perf_counter()
    if args.streaming:
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
    else:
        result = animate_mod.animate(cfg, person_assets, person_models, audio,
                                     seed=args.seed, render_batch=args.render_batch,
                                     transfer=args.transfer)
        wall = time.perf_counter() - t0
        frames = result.frames
        print(f"stages (ms): {json.dumps({k: round(v, 1) for k, v in result.stage_ms.items()})}")
        print(f"{result.nframe} frames in {wall:.2f}s -> {result.nframe / wall:.1f} fps "
              "end-to-end")

    audio_name = os.path.splitext(os.path.basename(args.driving_audio))[0]
    save_root = join(args.results_dir, args.id, audio_name)
    os.makedirs(save_root, exist_ok=True)
    if video_mod.cv2 is not None:
        out_path = video_mod.write_video(frames, join(save_root, audio_name + ".avi"), audio)
        print(f"wrote video {out_path}")
    else:
        np.save(join(save_root, "frames.npy"), frames)
        wav_path = join(save_root, audio_name + ".wav")
        video_mod.save_wav(wav_path, audio[: int(len(frames) * 16000 / 60)])
        print(f"cv2 is not importable: wrote frames {join(save_root, 'frames.npy')} "
              f"and audio {wav_path}")


if __name__ == "__main__":
    main()
