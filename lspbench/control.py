"""The readings that a cell's limits are set from, in one process.

    python3 lspbench/control.py --workload <cell> --seeds 1,2,... --control-seeds 7,8,9

For each seed of ``--seeds`` the program answers the seed's checked
requests back to back, at the cell's own load (one caller), and the check's
numbers against the float32 reference are printed: the lower readings.
Then the control, the configuration's ``control``, answers the control
seeds' and is held against the same reference: the upper readings.  Both
sides' frames come through the mix's transfer, the reference's through its
transform (``reference/transfer.py``).

- ``int8_program``: the program with its own int8 path switched on
  (``setup(quantize=True)``): the step below a bf16 renderer.
- ``int4_reference``: the reference in the program's place, its renderer
  quantized to int4 (7 steps a side) with the same folding and calibration
  rule as the int8 renderer's: the step below an int8 renderer.

Benchmark runs do not run this.  Each line is one JSON object.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from lspbench import check, manifest, run, traffic  # noqa: E402


def readings(cell: manifest.Cell, seeds, device: str, pred=None, runner=None):
    """Yield (seed, numbers) of the program ``pred`` or, with ``runner``, of
    the reference with that conv runner in its place."""
    from lspbench.reference import subject, transfer

    c, mix = cell.config, cell.traffic
    transform = transfer.TRANSFORMS[mix["transfer"]]
    A, sd = subject.read_subject(os.path.join(run.BUILD, "subjects", c["name"]), c, device)
    for seed in seeds:
        reqs = traffic.pool(mix, seed)
        prog, ref = [], []
        for p in traffic.checked_positions(seed, reqs, mix["check_requests"]):
            audio = reqs[p].audio()
            frames = np.arange(int(len(audio) / 16000 * 60) - c["a2h_frame_future"])
            if pred is not None:
                rec = run.send(pred, reqs[p], audio, seed, p, mix, keep=True)
                if rec.error:
                    raise RuntimeError(rec.error)
                prog.append(rec.frames)
                frames = np.arange(rec.nframe)
            else:
                prog.append(check.reference_frames(c, A, sd, audio, run.request_seed(seed, p),
                                                   frames, runner, transform))
            ref.append(check.reference_frames(c, A, sd, audio, run.request_seed(seed, p),
                                              frames, transform=transform))
        yield seed, check.numbers(zip(prog, ref))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    os.chdir(ROOT)
    cell = manifest.cell(manifest.load(), args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = [int(s) for s in args.control_seeds.split(",") if s]
    device = "cuda"
    pred, _ = run.start(cell, device)
    for seed, nums in readings(cell, seeds, device, pred=pred):
        print(json.dumps({"side": "program", "seed": seed, **nums}), flush=True)
    del pred
    gc.collect()
    kind = cell.config["control"]
    if kind == "int8_program":
        pred, _ = run.start(cell, device, quantize=True)
        for seed, nums in readings(cell, control, device, pred=pred):
            print(json.dumps({"side": "control", "kind": kind, "seed": seed, **nums}), flush=True)
    elif kind == "int4_reference":
        from lspbench.reference import subject
        c = cell.config
        A, sd = subject.read_subject(os.path.join(run.BUILD, "subjects", c["name"]), c, device)
        runner = check.calibrated_runner(c, A, sd, levels=7)
        del A, sd
        for seed, nums in readings(cell, control, device, runner=runner):
            print(json.dumps({"side": "control", "kind": kind, "seed": seed, **nums}), flush=True)
    else:
        raise ValueError(f"unknown control {kind!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
