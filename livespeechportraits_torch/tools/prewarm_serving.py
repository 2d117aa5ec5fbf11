#!/usr/bin/env python3
"""Cold boot to first frame of the port's serving stack.

    python -m livespeechportraits_torch.tools.prewarm_serving [--quantize 1] \\
        [--transfer pack4e] [--image_size 512] [--artifact auto] [--device cuda]

Counterpart of ``tools/prewarm_serving.py``.  The JAX package pays minutes
of XLA compilation on a first boot and keeps a compile cache; the port has
none.  What it builds once is the CUDA kernels (nvcc into the git-ignored
``build/``, keyed by a hash of the sources, see ``_build.py``) and, with
``--artifact``, the int8 serving models (quantized and calibrated once,
then loaded).  One JSON line, after the card's name and power limit:

- ``kernel_build_s``: the first ``_build.library()`` call (a build, or
  loading a build already in ``build_dir``: ``kernel_build_cached``);
- ``setup_s``: ``serve.Predictor.setup`` (subject, models, quantize and
  calibrate or the artifact's load, the renderer's cast);
- ``capture_s``: ``Predictor.prewarm``: the fused motion half's CUDA graphs
  of every bucket up to the Predictor's 10 s and the decode step's,
  captured before the first request, with ``graphs`` (their count),
  ``graph_nodes``,
  ``graph_capture_ms``, ``graph_instantiate_ms`` and ``graph_pool_bytes``
  summed over them (none on the CPU);
- ``predict_first_s``: the first bucketed request on a ``--seconds`` tone;
- ``stream_first_frame_s``: from ``Predictor.stream``'s start to its first
  non-empty frame batch;
- ``total_s`` from the start of main, and ``build_dir``.

Run it twice (each in its own process) to see the cold figures and then
the warm ones.  On the CPU (``--device cpu``) no kernel is built
(``kernel_build_s`` reads "not_built") and the walls are the CPU's.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from livespeechportraits_torch import _build
from livespeechportraits_torch.pipeline import animate, video
from livespeechportraits_torch.serve import Predictor
from livespeechportraits_torch.tools import _common


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--id", default="Synthetic")
    p.add_argument("--config_dir", default="./config")
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--quantize", type=int, default=1)
    p.add_argument("--transfer", default="pack4e", choices=animate.TRANSFERS)
    p.add_argument("--render_batch", type=int, default=16)
    p.add_argument("--seconds", type=float, default=1.0, help="test-tone length (one bucket)")
    p.add_argument("--streaming", type=int, default=1)
    p.add_argument("--stream_depth", type=int, default=1)
    p.add_argument("--skip_video", type=int, default=1,
                   help="predict(write_video=False): the device work, not the muxer")
    p.add_argument("--artifact", default="auto",
                   help="serving models .npz, written on the first boot and read on later "
                        "ones; 'auto' is build/serve_<id>_<size>[_int8].npz, '' none")
    _common.add_device_arg(p)
    return p


def main(argv=None) -> int:
    t0 = time.perf_counter()
    args = build_parser().parse_args(argv)
    dev = _common.device(args.device)
    card = _common.emit_card("prewarm_serving", dev)
    build = {"kernel_build_s": "not_built", "kernel_build_cached": None}
    if dev.type == "cuda":
        cached = _build.library_path().exists()
        t = time.perf_counter()
        _build.library()
        build = {"kernel_build_s": time.perf_counter() - t, "kernel_build_cached": cached}
    artifact = args.artifact
    if artifact == "auto":
        artifact = str(_build.BUILD_DIR / (f"serve_{args.id}_{args.image_size}"
                                           f"{'_int8' if args.quantize else ''}.npz"))
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
    from_artifact = bool(artifact) and os.path.exists(artifact)
    t = time.perf_counter()
    pred = Predictor(device=dev)
    pred.setup(person_id=args.id, config_dir=args.config_dir, image_size=args.image_size,
               quantize=bool(args.quantize), artifact=artifact or None)
    _common.sync(dev)
    setup_s = time.perf_counter() - t
    t = time.perf_counter()
    graphs = pred.prewarm()
    _common.sync(dev)
    capture = {"capture_s": time.perf_counter() - t, "graphs": len(graphs)}
    for k in ("nodes", "capture_ms", "instantiate_ms", "pool_bytes"):
        vals = [g[k] for g in graphs.values()]
        capture[f"graph_{k}"] = None if None in vals else sum(vals)
    audio = video.make_test_tone(args.seconds)
    t = time.perf_counter()
    pred.predict(audio, render_batch=args.render_batch, transfer=args.transfer,
                 write_video=not args.skip_video)
    predict_first_s = time.perf_counter() - t
    stream_first = None
    if args.streaming:
        t = time.perf_counter()
        for frames in pred.stream(audio, render_batch=args.render_batch, transfer=args.transfer,
                                  pipeline_depth=args.stream_depth):
            if stream_first is None and len(frames):
                stream_first = time.perf_counter() - t
    _common.emit(**build, setup_s=setup_s, **capture, predict_first_s=predict_first_s,
                 boot_to_first_frame_s=setup_s + predict_first_s,
                 stream_first_frame_s=stream_first, total_s=time.perf_counter() - t0,
                 build_dir=str(_build.BUILD_DIR), artifact=artifact,
                 artifact_existed=from_artifact, quantize=bool(args.quantize),
                 transfer=args.transfer, image_size=args.image_size, card=card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
