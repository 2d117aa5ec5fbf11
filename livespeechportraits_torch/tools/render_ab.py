#!/usr/bin/env python3
"""K1, K4 and the render half of the port on one NVIDIA GPU, for several
checkouts side by side.

    python3 livespeechportraits_torch/tools/render_ab.py ROOT [ROOT ...] \\
        [--rounds 2] [--cases k1,k4,render]

Each ROOT is a checkout of the repo (e.g. a parent commit unpacked with
``git archive`` next to this one).  Runs go A, B, ..., then back (B, A) for
the next round, each in its own process that imports
``livespeechportraits_torch`` from its ROOT (and builds that ROOT's
kernels), so versions compare on the same card in one call.  A run takes
the full-width synthetic subject (random weights, seed 0) and the motion
of 3 s of test tone (165 frames at 512^2), then prints one JSON line a
case, with the card's name and power limit:

- ``k1``: device ms by CUDA events around CUDA-graph replays of K1's table
  entry (``rasterize_segments`` on 8 frames' segment table) and of the
  U-Net's bf16 input at B = 16 and 8 (``render_input`` where the ROOT has
  it, else rasterize_segments + cat + cast on a prebuilt table, the
  sequence it replaced);
- ``k4``: device ms by CUDA-graph replays of ``q8conv_cuda.conv_q8`` (fused
  bf16, B = 16) at each distinct int8 conv shape of one 'normal' 512^2
  forward (``feature2face.int8_conv_shapes``), with the kernel it takes
  (halo or gather), and their sum over the 44 convs of the forward;
- ``render``: ``render_frames`` with the bf16 renderer (batch 8, rgb: the
  offline slice) and the int8 renderer calibrated on a 1 s tone (batch 16,
  yuv420: serve.Predictor's request): ``render_device_ms`` (host wall from
  the first batch to the device's end, median of 5 warm calls), the device
  busy time of one traced call (union of torch.profiler's device records,
  which may drop records) and ``busy_share`` = busy / render_device.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time


def graph_ms(torch, fn, calls: int = 5, replays: int = 4) -> float:
    """Device ms per fn() call: CUDA events around replays of a CUDA graph
    of `calls` calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def k4_case(torch, emit) -> None:
    """The ``k4`` case (see the module's note); the same inputs in every
    ROOT (a CPU generator from one seed a shape)."""
    from livespeechportraits_torch.config import Feature2FaceConfig
    from livespeechportraits_torch.models import feature2face as f2f
    from livespeechportraits_torch.ops import q8conv_cuda as q8

    cl, B = torch.channels_last, 16
    shapes = f2f.int8_conv_shapes(Feature2FaceConfig())
    rows, total = [], 0.0
    for j, (size, cin, cout, stride) in enumerate(dict.fromkeys(shapes)):
        g = torch.Generator().manual_seed(300 + j)
        x = (torch.round(torch.randn(B, cin, size, size, generator=g) * 96) / 8).to(
            "cuda", torch.bfloat16).contiguous(memory_format=cl)
        w = torch.randint(-127, 128, (cout, cin, 3, 3), generator=g, dtype=torch.int8).to(
            "cuda").contiguous(memory_format=cl)
        r = torch.tensor(4.0, device="cuda", dtype=torch.bfloat16)
        scale = (torch.rand(cout, generator=g) * 1e-5).to("cuda", torch.bfloat16)
        bias = torch.randn(cout, generator=g).to("cuda", torch.bfloat16)
        ms = graph_ms(torch, lambda: q8.conv_q8(x, r, w, stride, 1, scale, bias))
        n = shapes.count((size, cin, cout, stride))
        total += n * ms
        rows.append({"shape": f"{size}^2:{cin}->{cout}/s{stride}", "convs": n,
                     "kernel": "halo" if q8.uses_halo(size, size, stride, 1) else "gather",
                     "device_ms": ms})
    emit(case="k4", batch=B, shapes=rows, forward_device_ms=total, convs=len(shapes))


def one(root: str, cases) -> None:
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from livespeechportraits_torch import serve
    from livespeechportraits_torch.ops import rasterize, rasterize_cuda
    from livespeechportraits_torch.pipeline import animate, video

    if not torch.cuda.is_available():
        raise SystemExit("render_ab: no CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    audio = video.make_test_tone(3.0)

    def emit(**kv):
        print(json.dumps({"root": root, **kv, "card": card}), flush=True)

    if "k4" in cases:
        k4_case(torch, emit)
    if not {"k1", "render"} & set(cases):
        return

    for quantize, batch, transfer in ((False, 8, "rgb"), (True, 16, "yuv420")):
        if quantize and "render" not in cases:
            break
        p = serve.Predictor(device=dev)
        p.setup("Synthetic", image_size=512, quantize=quantize, calibrate=quantize)
        args = (p._cfg, p._assets, p._models)
        lm, sh, _, _, n = animate.compute_motion(*args, audio, seed=0)
        lm, sh = lm[:n], animate._shift_shoulders(p._assets, sh[:n])
        if "k1" in cases and not quantize:
            cand = p._assets.tensor("candidate_images", dev).permute(1, 2, 0, 3).reshape(
                512, 512, 12)
            table = rasterize.segment_table(lm[:8], sh[:8])
            ms = {"table_entry_8": graph_ms(torch, lambda: rasterize_cuda.rasterize_segments(
                table, 512, 512))}
            for B in (16, 8):
                tab = rasterize.segment_table(lm[:B], sh[:B])

                def replaced(B=B, tab=tab):
                    edge = rasterize_cuda.rasterize_segments(tab, 512, 512)
                    return torch.cat([edge[..., None], cand.expand(B, 512, 512, 12)],
                                     -1).to(torch.bfloat16)

                ms[f"replaced_{B}"] = graph_ms(torch, replaced)
                if hasattr(rasterize_cuda, "render_input"):
                    cb = cand.to(torch.bfloat16)
                    ms[f"render_input_{B}"] = graph_ms(
                        torch, lambda B=B, cb=cb: rasterize_cuda.render_input(
                            lm[:B], sh[:B], cb, (512, 512)))
            emit(case="k1", device_ms=ms)
        if "render" not in cases:
            continue

        def render():
            sm = {}
            animate.render_frames(*args, lm, sh, render_batch=batch, stage_ms=sm,
                                  transfer=transfer)
            return sm["render_device"]

        render()
        walls = [render() for _ in range(5)]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            render()
            torch.cuda.synchronize()
        spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        busy, cur = 0.0, None
        for s, e in spans:
            if cur is None or s > cur[1]:
                busy += 0 if cur is None else cur[1] - cur[0]
                cur = [s, e]
            else:
                cur[1] = max(cur[1], e)
        busy = (busy + (0 if cur is None else cur[1] - cur[0])) / 1e3
        wall = statistics.median(walls)
        emit(case="serving_int8" if quantize else "offline_bf16", frames=int(n), batch=batch,
             render_device_ms=wall, render_device_ms_runs=walls, device_busy_ms=busy,
             device_records=len(spans), busy_share=busy / wall)


def main() -> int:
    args = sys.argv[1:]
    if len(args) == 3 and args[0] == "--one":
        one(args[1], args[2].split(","))
        return 0
    opts = {"--rounds": "2", "--cases": "k1,render"}
    for key in opts:
        if key in args:
            i = args.index(key)
            opts[key] = args[i + 1]
            del args[i:i + 2]
    if not args:
        raise SystemExit(__doc__)
    for r in range(int(opts["--rounds"])):
        for root in (args if r % 2 == 0 else args[::-1]):
            t0 = time.perf_counter()
            subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root,
                            opts["--cases"]], check=True, timeout=900)
            print(json.dumps({"root": root, "process_s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
