"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 lspbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  A run writes the cell's subject once per
checkout (``build/lspbench/subjects/<config>``), builds one
``serve.Predictor`` on the card, ``setup()``s it on that subject, warms up
the buckets the cell's traffic uses with one request each, then sends the
traffic's requests back to back for ``--seconds`` (one caller, closed
loop), as a served subject answers them under the server's device lock.
With ``--trace 1`` a few more requests follow under torch.profiler, for
the per-layer metrics that read the device.  Then the program is freed and
the plain float32 reference (``lspbench/reference``) checks the frames of a
sample of the window's requests, its own through the mix's transfer.  The
last line of standard output is the result; the numbers compared, beside
their limits, are the last lines of standard error.
"""

from __future__ import annotations

import time

T0 = time.time()  # set-up is measured from here: before torch is imported

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from typing import Dict, List, Optional, Tuple  # noqa: E402

import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from lspbench import check, counts, devtrace, manifest, speech, traffic  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "livespeechportraits_tpu")
BUILD = os.path.join("build", "lspbench")  # inside the checkout, a fixed path


@dataclass
class Record:
    """One request of the window."""
    position: int
    seconds: float
    wall_ms: float
    nframe: int = 0
    stage_ms: Dict[str, float] = field(default_factory=dict)
    frames: Optional[np.ndarray] = None  # all of them, for a checked request
    error: Optional[str] = None


@dataclass
class Context:
    """What a per-layer metric's reader reads."""
    config: dict
    mix: dict
    records: List[Record]  # the measured window's
    window_s: float
    rates: Optional[dict]
    trace: Optional[devtrace.Trace] = None
    traced: List[Record] = field(default_factory=list)


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def p90(values: List[float]) -> float:
    """The nearest-rank 90th percentile of every value (inf counts)."""
    v = sorted(values)
    return v[max(0, math.ceil(0.9 * len(v)) - 1)]


def _read(metric: str, ctx: Context):
    spec = importlib.util.spec_from_file_location(f"lspbench_metric_{metric}",
                                                  manifest.reader_path(metric))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def request_seed(seed: int, position: int) -> int:
    """The head-pose decode's seed of the window's request ``position``."""
    return seed + position


def send(pred, req: traffic.Request, audio: np.ndarray, seed: int, position: int, mix: dict,
         keep: bool = False) -> Record:
    """One request; ``keep`` keeps its frames for the check."""
    kw = dict(render_batch=mix["render_batch"], transfer=mix["transfer"], write_video=False)
    t = time.perf_counter()
    try:
        res = pred.predict(audio, seed=request_seed(seed, position), **kw)
    except Exception as e:  # a failed request counts as failed and missing
        return Record(position, req.seconds, math.inf, error=f"{type(e).__name__}: {e}")
    wall = (time.perf_counter() - t) * 1e3
    return Record(position, req.seconds, wall, res.nframe, dict(res.stage_ms),
                  res.frames if keep else None)


def start(cell: manifest.Cell, device: str, program=None, quantize: Optional[bool] = None):
    """The cell's subject (written once per checkout), the program set up on
    it, and one warm-up request for each bucket the cell's traffic uses:
    (the Predictor, the subject's directory)."""
    import torch

    c, mix = cell.config, cell.traffic
    root = os.path.join(BUILD, "subjects", c["name"])
    from lspbench.reference import subject
    if subject.ensure_subject(c, root, device):
        log(f"wrote the subject {root}")
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    if program is None:
        from livespeechportraits_torch.serve import Predictor as program
    pred = program(max_audio_seconds=mix["max_audio_seconds"],
                   results_dir=os.path.join(BUILD, "results"),
                   bucket_seconds=mix["bucket_seconds"], device=device)
    pred.setup(person_id=c["name"], config_dir=root, image_size=c["image_size"],
               quantize=c["precision"] == "int8" if quantize is None else quantize)
    for s in traffic.warm_seconds(mix):
        warm = send(pred, traffic.Request(0, s, 0), speech.speech(s, np.random.default_rng(0)),
                    0, 0, mix)
        if warm.error:
            raise RuntimeError(f"warm-up of a {s} s request failed: {warm.error}")
    if device == "cuda":
        torch.cuda.synchronize()
    return pred, root


def run_cell(cell: manifest.Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t0: float = T0, program=None) -> Tuple[dict, List[str]]:
    """One run: (the result line's object, the forbidden modules the process
    held once the window had closed).  ``program`` replaces the Predictor's
    class (the fault tests)."""
    import torch

    c, mix = cell.config, cell.traffic
    pred, root = start(cell, device, program)
    reqs = traffic.pool(mix, seed)
    audios = [r.audio() for r in reqs]
    gc.collect()
    setup_s = time.time() - t0

    # the measured window: one caller, each request sent when the last returned
    checked = set(traffic.checked_positions(seed, reqs, mix["check_requests"]))
    records: List[Record] = []
    opened = time.perf_counter()
    # (a window always reaches the checked positions, all in the pool's first
    # pass: 45 s holds several passes)
    while len(records) <= max(checked) or time.perf_counter() - opened < seconds:
        j = len(records)
        r = reqs[j % len(reqs)]
        records.append(send(pred, r, audios[r.index], seed, j, mix, j in checked))
    window_s = time.perf_counter() - opened
    ok = [r for r in records if r.error is None]
    log(f"window: {len(records)} requests, {len(records) - len(ok)} failed, "
        f"{sum(r.nframe for r in ok)} frames in {window_s:.3f} s")
    for r in records:
        if r.error:
            log(f"request {r.position} failed: {r.error}")

    ctx = Context(c, mix, records, window_s, None)
    if trace:
        ctx.trace, ctx.traced = _traced(pred, reqs, audios, seed, len(records), mix)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    name = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    ctx.rates = counts.peaks(name)
    forbidden = forbidden_modules()
    del pred
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    if trace:
        metrics = {}
        for p in cell.per_layer:
            v = _read(p["name"], ctx)
            if v is not None:
                metrics[p["name"]] = {"value": v, "unit": p["unit"]}
            else:
                log(f"{p['name']}: nothing to read in this run")
    else:
        metrics = _end_to_end(cell, records, window_s, setup_s)

    nums, limits = _check(c, mix, seed, records, root, device)
    correct, lines = check.judge(nums, limits)
    failed = len(records) - len(ok)
    result = {"correct": correct and failed == 0 and not forbidden,
              "attempted": len(records), "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if device == "cuda" else "cpu", "kind": name,
                         "count": 1, "memory_peak_bytes": peak}}
    if trace and ctx.trace is not None:
        result["device"]["busy_s"] = ctx.trace.busy_s
        result["device"]["window_s"] = ctx.trace.window_s
        result["breakdown"] = {"device_ops": [list(x) for x in ctx.trace.device_ops()],
                               "idle_gaps": [list(x) for x in ctx.trace.idle_gaps]}
    result["check"] = {k: {"value": nums[k], "limit": limits[k]} for k in limits}
    log("compared: " + ", ".join(f"{k} {v!r}" for k, v in nums.items()))
    for line in lines:
        log(line)
    return result, forbidden


def _end_to_end(cell: manifest.Cell, records: List[Record], window_s: float,
                setup_s: float) -> dict:
    out = {}
    for x in cell.end_to_end:
        n = x["name"]
        if n == "setup_s":
            v = setup_s
        elif n == "fps":
            v = sum(r.nframe for r in records if r.error is None) / window_s
        elif n == "request_p90_ms":
            v = p90([r.wall_ms for r in records])
            log(f"request_p90_ms over {len(records)} requests")
        else:
            raise ValueError(f"no end-to-end metric {n!r} in this harness")
        out[n] = {"value": v, "unit": x["unit"]}
    return out


def _traced(pred, reqs, audios, seed: int, first: int, mix: dict):
    """``trace_requests`` more requests under torch.profiler, timed by CUDA
    events: (the reduced trace, their records)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    traced = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        a.record()
        for k in range(int(mix["trace_requests"])):
            j = first + k
            r = reqs[j % len(reqs)]
            traced.append(send(pred, r, audios[r.index], seed, j, mix))
        b.record()
        torch.cuda.synchronize()
    t = time.perf_counter()
    tr = devtrace.reduce(prof.events(), a.elapsed_time(b) / 1e3)
    log(f"trace: {tr.device_records} device records, busy {tr.busy_s:.6f} s of "
        f"{tr.window_s:.6f} s ({tr.coverage:.1%}); reduced in {time.perf_counter() - t:.1f} s"
        + ("" if tr.device_records else "; no device records: the profiler dropped them"))
    return tr, traced


def _check(c: dict, mix: dict, seed: int, records: List[Record], root: str, device: str):
    """The reference's frames of the checked requests against the program's,
    every frame: (numbers, limits)."""
    from lspbench.reference import subject, transfer

    done = [r for r in records if r.frames is not None]
    if not done:
        return {k: math.inf for k in c["limits"]}, c["limits"]
    A, sd = subject.read_subject(root, c, device)
    reqs = traffic.pool(mix, seed)
    t = time.perf_counter()
    ref = []
    for r in done:
        audio = reqs[r.position % len(reqs)].audio()
        frames = int(len(audio) / 16000 * 60) - c["a2h_frame_future"]
        ref.append(check.reference_frames(c, A, sd, audio, request_seed(seed, r.position),
                                          np.arange(frames),
                                          transform=transfer.TRANSFORMS[mix["transfer"]]))
    log(f"reference: requests {[r.position for r in done]}, "
        f"{sum(r.nframe for r in done)} frames, {time.perf_counter() - t:.1f} s")
    return check.numbers(zip([r.frames for r in done], ref)), c["limits"]


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    os.chdir(ROOT)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_ext")):
        os.environ[var] = os.path.join(ROOT, BUILD, sub)
    os.environ["USE_FLAX"] = os.environ["USE_JAX"] = "0"
    if importlib.util.find_spec("livespeechportraits_torch") is None:
        log("the program (livespeechportraits_torch) is not beside the benchmark")
        return 2
    m = manifest.load()
    errors = manifest.validate(m)
    if errors:
        log("BENCHMARK.json: " + "; ".join(errors))
        return 2
    cell = manifest.cell(m, args.workload)
    if cell is None:
        log(f"no cell {args.workload!r} in BENCHMARK.json")
        return 2
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} CUDA device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    result, forbidden = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    if forbidden:
        log(f"the process holds {forbidden} after the window: the port must not load them")
        return 4
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
