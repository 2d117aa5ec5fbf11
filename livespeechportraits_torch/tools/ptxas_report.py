#!/usr/bin/env python3
"""Registers, spills and shared memory of every kernel in CUDA sources, as
``ptxas -v`` reports them.

    python -m livespeechportraits_torch.tools.ptxas_report [source.cu ...]

Compiles each source (by default the port's ``csrc/*.cu``) with the flags
the port builds with (``_build.NVCC_FLAGS``: sm_90a, -O3, -Xptxas -v) into a
temporary object, all sources at once, and prints, after the line naming the
card, one JSON row a kernel: the source, the kernel's mangled name,
registers, spill stores and loads (bytes), static shared memory.  Handing it
another checkout's source (a parent commit's ``csrc/q8conv.cu``) gives the
before of a kernel change beside the after.  Needs nvcc: it runs on the
machine with the card.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import tempfile
from typing import Dict, List

from livespeechportraits_torch import _build
from livespeechportraits_torch.tools import _common


def parse(log: str) -> List[Dict[str, object]]:
    """One dict a kernel of an nvcc -Xptxas -v log: name, registers,
    spill_stores, spill_loads, smem (bytes)."""
    rows: List[Dict[str, object]] = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            rows.append({"name": m.group(1), "registers": None, "spill_stores": 0,
                         "spill_loads": 0, "smem": 0})
            continue
        if not rows:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            rows[-1]["spill_stores"], rows[-1]["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rows[-1]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            rows[-1]["smem"] = int(m.group(1))
    return rows


def summary(log: str, label) -> Dict[str, Dict[str, int]]:
    """{label(name): {registers, spill_stores, spill_loads}} of the kernels
    of parse(log) that ``label`` names (it returns None for the others)."""
    out = {}
    for row in parse(log):
        name = label(row["name"])
        if name is not None:
            out[name] = {k: row[k] for k in ("registers", "spill_stores", "spill_loads")}
    return out


def report(sources) -> Dict[str, List[Dict[str, object]]]:
    """{source: parse(its nvcc log)}, the sources compiled in parallel."""
    with tempfile.TemporaryDirectory() as tmp:
        procs = {src: subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-c", "-o",
             os.path.join(tmp, f"{i}.o"), src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for i, src in enumerate(sources)}
        out = {}
        for src, p in procs.items():
            log = p.communicate()[0]
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src} ({p.returncode}):\n{log}")
            out[src] = parse(log)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("sources", nargs="*", help="the .cu files (default: the port's csrc/*.cu)")
    args = p.parse_args(argv)
    _common.emit_card("ptxas_report", _common.device("cuda"))
    sources = args.sources or [str(s) for s in _build._sources()]
    for src, rows in report(sources).items():
        for row in rows:
            _common.emit(source=src, **row)
    return 0


if __name__ == "__main__":
    sys.exit(main())
