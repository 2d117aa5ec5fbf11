#!/usr/bin/env python3
"""The live path's latency a push: ``StreamingAnimator`` on the synthetic
subject at 512^2, for several chunk sizes and pipeline depths.

    python -m livespeechportraits_torch.tools.stream_latency [seconds] [image_size] \\
        [--quantize] [--chunks 8,16,32] [--depths 0,1] [--transfer rgb] \\
        [--render_batch 0] [--size large] [--ngf 64] [--device cuda]

Counterpart of ``tools/stream_latency.py``.  One warm-up stream (JAX's
tool warms each chunk size, whose programs it compiles; the port compiles
nothing per size), then each (chunk, depth) streams the test tone once,
measured: one push a chunk of audio (chunk / 60 s), then the flush; the
first two pushes are left out of the walls.  One JSON line each, after the
card's name and power limit: the per-push host walls after the first two
(median, p95, max, mean; the latency a live caller sees a push), the
flush's, the frames, the real-time budget of a chunk, the algorithmic
latency, each stage's median ms a push, and the launches a push: the K1-K5
counters over the measured pass, and the CUDA kernel launches the profiler
counts in a traced stream of the first second (the host's launch calls,
flush included; the counterpart of JAX's dispatch count).  On the card the row also carries the device ->
host link's round trip and rate (``utils.profiling.link_probe``); on the
CPU the launch counts of the card read "not_measured".
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from livespeechportraits_torch.pipeline import animate, assets, video
from livespeechportraits_torch.pipeline.streaming import StreamingAnimator
from livespeechportraits_torch.tools import _common
from livespeechportraits_torch.utils import profiling

LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cudaLaunchCooperativeKernel", "cudaGraphLaunch")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("seconds", nargs="?", type=float, default=4.0)
    p.add_argument("image_size", nargs="?", type=int, default=512)
    p.add_argument("--quantize", action="store_true")
    p.add_argument("--chunks", default="8,16,32")
    p.add_argument("--depths", default="0,1")
    p.add_argument("--transfer", default="rgb", choices=animate.TRANSFERS)
    p.add_argument("--render_batch", type=int, default=0,
                   help="frames a render batch (0: max(4, chunk // 2), as JAX's tool)")
    p.add_argument("--size", default="large", choices=["small", "normal", "large"])
    p.add_argument("--ngf", type=int, default=64)
    _common.add_device_arg(p)
    return p


def stream_once(cfg, person, models, audio, chunk, batch, depth, transfer):
    """One stream: (push walls ms, flush ms, frames, each push's stage ms,
    latency frames)."""
    push = int(chunk / 60 * 16000) + 1  # one chunk of audio a push
    times, stages, frames = [], [], 0
    with StreamingAnimator(cfg, person, models, seed=0, chunk=chunk, render_batch=batch,
                           pipeline_depth=depth, transfer=transfer) as st:
        for lo in range(0, len(audio), push):
            before = dict(st.stage_ms)
            t0 = time.perf_counter()
            frames += len(st.push_audio(audio[lo:lo + push]))
            times.append((time.perf_counter() - t0) * 1e3)
            stages.append({k: st.stage_ms.get(k, 0.0) - before.get(k, 0.0) for k in st.stage_ms})
        t0 = time.perf_counter()
        frames += len(st.flush())
        flush = (time.perf_counter() - t0) * 1e3
        latency = st.latency_frames
    return times, flush, frames, stages, latency


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev = _common.device(args.device)
    card = _common.emit_card("stream_latency", dev)
    H = args.image_size
    cfg = _common.person_config(args.size, H, args.ngf, name="StreamBench")
    person, models = assets.make_synthetic_person(cfg, image_size=H, bank_size=4096, device=dev)
    audio = video.make_test_tone(args.seconds)
    if args.quantize:
        calib = animate.build_render_inputs(cfg, person, models, audio, max_frames=8)
        models = assets.quantize_person_models(models, calibrate_inputs=calib,
                                               calibrate_dtype=animate.compute_dtype(cfg))
    link = profiling.link_probe(dev) if dev.type == "cuda" else {}
    warm = False
    for chunk in (int(c) for c in args.chunks.split(",")):
        batch = args.render_batch or max(4, chunk // 2)
        for depth in (int(d) for d in args.depths.split(",")):
            run = (cfg, person, models, audio, chunk, batch, depth, args.transfer)
            if not warm:  # one warm-up stream: the port compiles nothing per chunk size
                stream_once(*run)
                warm = True
            before = _common.launch_counts()
            times, flush, frames, stages, latency = stream_once(*run)
            after = _common.launch_counts()
            pushes = len(times)
            row = {"chunk_frames": chunk, "pipeline_depth": depth, "render_batch": batch,
                   "quantize_int8": args.quantize, "transfer": args.transfer,
                   "image_size": H, "pushes": pushes, "frames": frames,
                   "realtime_budget_ms": chunk / 60 * 1e3, "flush_ms": flush,
                   "latency_frames_algorithmic": latency,
                   "kernel_launches_per_push": {k: (after[k] - before[k]) / pushes
                                                for k in after}}
            steady = np.asarray(times[2:])  # the stream's start-up pushes left out
            if steady.size:
                row.update(push_ms_p50=float(np.percentile(steady, 50)),
                           push_ms_p95=float(np.percentile(steady, 95)),
                           push_ms_max=float(steady.max()), push_ms_mean=float(steady.mean()),
                           realtime=bool(np.percentile(steady, 95) < chunk / 60 * 1e3))
                row["stage_ms_p50"] = {k: float(np.median([s.get(k, 0.0) for s in stages[2:]]))
                                       for k in stages[-1]}
            else:
                row["note"] = f"{pushes} pushes: too short for a steady-state measurement"
            if dev.type == "cuda":
                # the launches of a traced stream of the first second (the
                # profiler stretches the host side several times over)
                short = run[:3] + (audio[:16000],) + run[4:]
                with profiling.trace() as prof:
                    traced_pushes = len(stream_once(*short)[0])
                calls = sum(1 for e in prof.events() if e.name in LAUNCH_CALLS)
                row["cuda_launches_per_push"] = calls / traced_pushes
            else:
                row["cuda_launches_per_push"] = _common.NOT_MEASURED
            row.update(link, clock="host", card=card)
            _common.emit(**row)
    return 0


if __name__ == "__main__":
    sys.exit(main())
