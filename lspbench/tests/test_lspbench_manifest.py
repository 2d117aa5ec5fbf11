"""BENCHMARK.json against its format, and finding a cell's parts
by name alone."""

from __future__ import annotations

import copy
import json
import os
import shutil

import pytest

from lspbench import manifest


def test_the_manifest_is_valid():
    assert manifest.validate(manifest.load()) == []


@pytest.mark.parametrize("group,key,value,expect", [
    ("per_layer", "name", "bad name", "bad name"),
    ("per_layer", "unit", "ms per frame", "bad unit"),
    ("end_to_end", "unit", "µs", "bad unit"),
    ("per_layer", "moves", "no_such_metric", "not an end-to-end metric"),
    ("per_layer", "workloads", ["no.such.cell"], "is not a cell"),
    ("end_to_end", "bound", 0.3, "bound must be"),
    ("per_layer", "why", "a key the format does not have", "unknown keys"),
    ("workloads", "chips", 2, "chips must be"),
])
def test_a_breach_is_named(group, key, value, expect):
    m = copy.deepcopy(manifest.load())
    m[group][0][key] = value
    assert any(expect in e for e in manifest.validate(m))


def test_each_cell_reports_setup_another_end_to_end_and_a_layer():
    m = manifest.load()
    for w in m["workloads"]:
        cell = manifest.cell(m, w["name"])
        names = [x["name"] for x in cell.end_to_end]
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        assert all(p["moves"] in names for p in cell.per_layer)


def test_a_metric_moved_to_a_cell_that_does_not_report_it_is_refused():
    m = copy.deepcopy(manifest.load())
    k4 = next(p for p in m["per_layer"] if p["name"] == "k4_roofline.offline")
    k4["workloads"] = ["may_large_int8.serve_short"]  # serve cells report no fps
    assert any("does not report" in e for e in manifest.validate(m))


def test_a_new_traffic_file_is_found_by_name(tmp_path, monkeypatch):
    for sub in ("traffic", "metrics"):
        shutil.copytree(os.path.join(manifest.HERE, sub), tmp_path / sub)
    mix = {"loop": "closed", "callers": 1, "lengths": {"dist": "fixed", "seconds": 2.0},
           "pool": 2, "render_batch": 16, "transfer": "rgb", "bucket_seconds": 1.0,
           "max_audio_seconds": 10.0, "check_requests": 1, "trace_requests": 1}
    (tmp_path / "traffic" / "dummy_2s.json").write_text(json.dumps(mix))
    monkeypatch.setattr(manifest, "HERE", str(tmp_path))
    m = copy.deepcopy(manifest.load())
    new = "obama_normal_bf16.dummy_2s"
    m["workloads"].append({"name": new, "config": "obama_normal_bf16", "traffic": "dummy_2s",
                           "chips": 1, "why": "a test's cell"})
    for metric in m["end_to_end"] + m["per_layer"]:
        if "obama_normal_bf16.offline_10s" in metric.get("workloads", []):
            metric["workloads"].append(new)
    assert manifest.validate(m) == []
    cell = manifest.cell(m, "obama_normal_bf16.dummy_2s")
    assert cell.traffic == mix and cell.config["name"] == "obama_normal_bf16"
