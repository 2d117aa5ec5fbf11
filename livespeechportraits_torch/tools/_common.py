"""What the port's measurement tools share.

Every tool runs on the card unless ``--device cpu`` is given (at a tiny
width, for the tests), and a run that asks for the card and finds none
fails.  Each tool first prints one JSON line naming where it ran: on the
card, its name and power limit as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` gives them.  Times are CUDA events on the card and
the host clock on the CPU; every timed row names its clock, and a figure
only a card can give (a trace's device time) is "not_measured" on the CPU.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import time
from typing import Callable, Dict

import torch

from livespeechportraits_torch.config import Feature2FaceConfig, PersonConfig

NOT_MEASURED = "not_measured"


def add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="the card (default); 'cpu' runs the plain twins at a tiny width")


def device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(f"--device {name}: torch sees no CUDA device (pass --device cpu "
                             "for a run on the CPU)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def card(dev: torch.device) -> str:
    """nvidia-smi's name and power limit of the card, or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", str(dev.index or 0)], capture_output=True, text=True, timeout=60)
    return out.stdout.strip() or torch.cuda.get_device_name(dev)


def emit(**row) -> None:
    print(json.dumps(row, default=str), flush=True)


def emit_card(tool: str, dev: torch.device) -> str:
    name = card(dev)
    emit(tool=tool, device=str(dev), card=name,
         torch=torch.__version__, cuda=torch.version.cuda)
    return name


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_ms(fn: Callable[[], object], dev: torch.device, reps: int, warmup: int = 1
            ) -> Dict[str, object]:
    """fn()'s mean time over reps calls after warmup: {"ms", "clock"}, CUDA
    events on the card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    sync(dev)
    if dev.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(dev)
        return {"ms": start.elapsed_time(end) / reps, "clock": "cuda_events"}
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return {"ms": (time.perf_counter() - t0) * 1e3 / reps, "clock": "host"}


def f2f_config(size: str = "large", image_size: int = 512, ngf: int = 64,
               precision: str = "bfloat16") -> Feature2FaceConfig:
    """The renderer of the JAX tools ('large', ngf 64, 8 downsamplings at
    512^2), with the depth cut below 256^2 so the innermost map stays >= 1
    px."""
    return Feature2FaceConfig(size=size, ngf=ngf, n_downsample=min(8, int(math.log2(image_size))),
                              load_size=image_size, precision=precision)


def person_config(size: str = "large", image_size: int = 512, ngf: int = 64,
                  name: str = "Synthetic") -> PersonConfig:
    """The default subject (full-width motion models) with that renderer."""
    return PersonConfig(name=name, feature2face=f2f_config(size, image_size, ngf))


def psnr_db(a: torch.Tensor, b: torch.Tensor, peak: float = 2.0) -> float:
    """PSNR of two [-1, 1] images (peak 2) or uint8 ones (peak 255)."""
    mse = float(torch.mean((a.double() - b.double()) ** 2))
    return 10.0 * math.log10(peak * peak / max(mse, 1e-12))


def graph_ms(fn: Callable[[], object], calls: int = 5, replays: int = 4) -> float:
    """Device ms per fn() call on the card: CUDA events around replays of a
    CUDA graph of `calls` calls, so no host dispatch gap is counted."""
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
    del graph
    return start.elapsed_time(end) / (calls * replays)


def kernel_ms(fn: Callable[[], object], dev: torch.device, reps: int = 20) -> Dict[str, object]:
    """One call's time: CUDA-graph replay on the card, the host clock on the
    CPU ({"ms", "clock"})."""
    if dev.type == "cuda":
        return {"ms": graph_ms(fn), "clock": "cuda_graph_replay"}
    return time_ms(fn, dev, reps)


def launch_counts() -> Dict[str, int]:
    """The kernels' launches, K1-K5: the wrappers' counters, and for K2 / K3
    also the launches inside replays of the fused motion program's CUDA
    graphs (motion_graph.REPLAYED_LAUNCHES)."""
    from livespeechportraits_torch.ops import (decode_cuda, q8conv_cuda, rasterize_cuda,
                                               recurrent_cuda)
    from livespeechportraits_torch.pipeline import motion_graph

    replayed = motion_graph.REPLAYED_LAUNCHES
    return {"K1": rasterize_cuda.LAUNCHES, "K2": recurrent_cuda.GRU_LAUNCHES + replayed["K2"],
            "K3": recurrent_cuda.LSTM_LAUNCHES + replayed["K3"], "K4": q8conv_cuda.LAUNCHES,
            "K5": decode_cuda.LAUNCHES}
