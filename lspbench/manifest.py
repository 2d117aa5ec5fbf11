"""BENCHMARK.json: reading it, checking it, and finding each cell's parts by
name.

A cell is an entry of ``workloads``; its configuration is
``lspbench/configs/<config>.json``, its traffic mix
``lspbench/traffic/<traffic>.json`` and each per-layer metric's reader
``lspbench/metrics/<metric>.py``.  A later change adds a cell, a
configuration, a mix or a metric by adding files and entries; nothing here
names one.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass
from typing import List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def traffic_path(name: str) -> str:
    return os.path.join(HERE, "traffic", f"{name}.json")


def reader_path(metric: str) -> str:
    return os.path.join(HERE, "metrics", f"{metric}.py")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def validate(m: dict, root: str = ROOT) -> List[str]:
    """Every breach of BENCHMARK.json's format that can be seen from the files;
    empty when there is none."""
    from lspbench.reference.transfer import TRANSFORMS

    err: List[str] = []
    if set(m) != KEYS:
        err.append(f"keys {sorted(m)} are not {sorted(KEYS)}")
        return err
    names = set()
    configs = {c.get("name") for c in m["configs"]}
    cells = {w.get("name") for w in m["workloads"]}
    e2e = {x.get("name") for x in m["end_to_end"]}
    for group, allowed in (("configs", {"name", "source", "file", "reduced", "why"}),
                           ("workloads", {"name", "config", "traffic", "chips", "why"}),
                           ("end_to_end", {"name", "unit", "better", "bound", "source",
                                           "workloads"}),
                           ("per_layer", {"name", "unit", "better", "source", "layer", "moves",
                                          "workloads"})):
        for e in m[group]:
            name = e.get("name", "")
            if set(e) - allowed:
                err.append(f"{group} {name}: unknown keys {sorted(set(e) - allowed)}")
            if not NAME.match(name):
                err.append(f"{group}: bad name {name!r}")
            if (group, name) in names:
                err.append(f"{group}: {name} twice")
            names.add((group, name))
            if "unit" in e and not UNIT.match(e["unit"]):
                err.append(f"{name}: bad unit {e['unit']!r}")
            if "better" in e and e["better"] not in ("lower", "higher"):
                err.append(f"{name}: better must be lower or higher")
            if "source" in e and group != "configs" and e["source"] not in SOURCES:
                err.append(f"{name}: bad source {e['source']!r}")
            for key in ("why", "layer", "source"):
                v = e.get(key)
                if isinstance(v, str) and not (1 <= len(v) <= 200 and "\n" not in v
                                              and "\t" not in v):
                    err.append(f"{name}: {key} must be one line of 1-200 characters")
            for w in e.get("workloads", []):
                if w not in cells:
                    err.append(f"{name}: workload {w} is not a cell")
    for c in m["configs"]:
        if not os.path.exists(os.path.join(root, c["file"])):
            err.append(f"config {c['name']}: {c['file']} missing")
        if any(not NAME.match(k) for k in c.get("reduced", [])):
            err.append(f"config {c['name']}: bad key in reduced")
    for x in m["end_to_end"]:
        if x["source"] not in ("host_clock", "device_trace"):
            err.append(f"{x['name']}: an end-to-end metric comes from host_clock or device_trace")
        if not 0 < x.get("bound", 0) <= 0.25:
            err.append(f"{x['name']}: bound must be in (0, 0.25]")
    if "setup_s" not in e2e:
        err.append("no setup_s")
    for p in m["per_layer"]:
        if p["moves"] not in e2e:
            err.append(f"{p['name']}: moves {p['moves']!r}, not an end-to-end metric")
        if not os.path.exists(reader_path(p["name"])):
            err.append(f"{p['name']}: no reader {reader_path(p['name'])}")
    pairs = set()
    for w in m["workloads"]:
        if w["config"] not in configs:
            err.append(f"{w['name']}: unknown config {w['config']}")
        if not os.path.exists(traffic_path(w["traffic"])):
            err.append(f"{w['name']}: no traffic file for {w['traffic']}")
        else:
            with open(traffic_path(w["traffic"])) as f:
                transfer = json.load(f).get("transfer")
            if transfer not in TRANSFORMS:
                err.append(f"{w['name']}: the reference has no transform for the transfer "
                           f"{transfer!r}, so its frames cannot be checked")
        if (w["config"], w["traffic"]) in pairs:
            err.append(f"{w['name']}: its config and traffic are another cell's")
        pairs.add((w["config"], w["traffic"]))
        if w["chips"] not in (1, 4):
            err.append(f"{w['name']}: chips must be 1 or 4")
        mine = [x["name"] for x in m["end_to_end"] if _applies(x, w["name"])]
        if "setup_s" not in mine or len(mine) < 2:
            err.append(f"{w['name']}: needs setup_s and another end-to-end metric")
        layer = [p for p in m["per_layer"] if _applies(p, w["name"])]
        if not layer:
            err.append(f"{w['name']}: no per-layer metric")
        for p in layer:
            if p["moves"] not in mine:
                err.append(f"{p['name']}: moves {p['moves']}, which {w['name']} does not report")
    return err


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def cell(m: dict, name: str) -> Optional[Cell]:
    """The cell ``name`` with its configuration and traffic read, or None."""
    w = next((w for w in m["workloads"] if w["name"] == name), None)
    if w is None:
        return None
    entry = next(c for c in m["configs"] if c["name"] == w["config"])
    with open(os.path.join(ROOT, entry["file"])) as f:
        config = json.load(f)
    with open(traffic_path(w["traffic"])) as f:
        traffic = json.load(f)
    return Cell(name, w["chips"], config, traffic,
                [x for x in m["end_to_end"] if _applies(x, name)],
                [p for p in m["per_layer"] if _applies(p, name)])
