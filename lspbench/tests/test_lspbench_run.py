"""Runs of the harness on the CPU at 32 px: a sound program is correct; a
program broken underneath is not; the control is not; no card, no result.

The limits here are the tiny subjects' (32 px frames err otherwise than
512 px ones); the cells' own limits are set from readings on the H100
(lspbench/control.py, PERF.md)."""

from __future__ import annotations

import math
import time

import numpy as np
import pytest
import torch

from lspbench import check, control, manifest, run
from lspbench.reference import subject
from lspbench.tests.conftest import tiny_config, tiny_mix

SEED = 2 ** 31 + 4242
# the subject's head and mouth move enough that a frozen decode shows at 32 px
MOTION = dict(head_std=[6.0, 6.0, 6.0, 0.03, 0.03, 0.03], mouth_std=0.01)
# the numbers each configuration compares, set from these tiny subjects'
# readings (3 seeds): bf16 program mean 1.97-2.01, pixels off by > 8 levels
# 0-1.5e-5, its int8 control 17.8 / 0.051; int8 program max 64.8-82.6, mean
# 41.6-44.5, its int4 control 6248 / 4551
LIMITS = {"obama_normal_bf16": {"frame_mse_mean": 6.0, "pixels_off8": 0.001},
          "may_large_int8": {"frame_mse_max": 600.0, "frame_mse_mean": 300.0}}


def _cell(name: str, **mix) -> manifest.Cell:
    """A tiny cell of configuration ``name`` under ``serve_short`` cut to
    1-2 s requests, with the mix's keys ``mix`` changed."""
    m = manifest.load()
    mix = tiny_mix("serve_short", **{"lengths": {"dist": "stratified_uniform", "low": 1.0,
                                                 "high": 2.0}, **mix})
    c = tiny_config(name, limits=LIMITS[name], **MOTION)
    return manifest.Cell(f"tiny.{name}", 1, c, mix,
                         [x for x in m["end_to_end"] if x["name"] in ("setup_s", "request_p90_ms")],
                         [p for p in m["per_layer"] if p["name"].endswith(".serve")
                          and p["source"] != "device_trace"])


def _run(in_workdir, name, program=None):
    result, forbidden = run.run_cell(_cell(name), SEED, 1.0, trace=False, device="cpu",
                                     t0=time.time(), program=program)
    assert forbidden == []
    return result


def test_a_sound_run_is_correct(in_workdir):
    r = _run(in_workdir, "obama_normal_bf16")
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) == {"setup_s", "request_p90_ms"}
    assert list(r)[-1] == "check"
    assert all(v["value"] <= v["limit"] for v in r["check"].values())


def _predictor():
    from livespeechportraits_torch.serve import Predictor
    return Predictor


class FrameAltered:
    """A frame altered where it is produced: the middle one inverted."""

    def __new__(cls, **kw):
        class P(_predictor()):
            def predict(self, *a, **k):
                r = super().predict(*a, **k)
                r.frames[len(r.frames) // 2] = 255 - r.frames[len(r.frames) // 2]
                return r
        return P(**kw)


class HalfBatch:
    """Half of each render batch left out: its frames never written."""

    def __new__(cls, **kw):
        class P(_predictor()):
            def predict(self, *a, render_batch=16, **k):
                r = super().predict(*a, render_batch=render_batch, **k)
                for s in range(0, len(r.frames), render_batch):
                    r.frames[s + render_batch // 2:s + render_batch] = 0
                return r
        return P(**kw)


def _stuck(model, cfg, dec, sigma_scale):
    """A head-pose decode step that returns its state unchanged."""
    dec.samples.index_copy_(0, dec.row, dec.x_prev[:, :cfg.ndim])
    dec.row.add_(1)


@pytest.mark.parametrize("fault", ["frame_altered", "half_batch", "state_unchanged"])
def test_a_fault_underneath_is_not_correct(in_workdir, monkeypatch, fault):
    program = {"frame_altered": FrameAltered, "half_batch": HalfBatch}.get(fault)
    if fault == "state_unchanged":
        from livespeechportraits_torch.models import audio2headpose
        monkeypatch.setattr(audio2headpose, "decode_step", _stuck)
    r = _run(in_workdir, "obama_normal_bf16", program)
    assert not r["correct"]
    assert any(v["value"] > v["limit"] for v in r["check"].values())


@pytest.mark.parametrize("name", ["obama_normal_bf16", "may_large_int8"])
def test_the_control_is_not_correct(in_workdir, name):
    cell = _cell(name)
    c = cell.config
    pred, root = run.start(cell, "cpu")
    sound = dict(control.readings(cell, [SEED], "cpu", pred=pred))[SEED]
    if c["control"] == "int8_program":
        pred, _ = run.start(cell, "cpu", quantize=True)
        ctl = dict(control.readings(cell, [SEED], "cpu", pred=pred))[SEED]
    else:
        A, sd = subject.read_subject(root, c, "cpu")
        runner = check.calibrated_runner(c, A, sd, levels=7)
        ctl = dict(control.readings(cell, [SEED], "cpu", runner=runner))[SEED]
    assert check.judge(sound, c["limits"])[0]
    assert not check.judge(ctl, c["limits"])[0]
    assert ctl["frame_mse_mean"] >= 3 * sound["frame_mse_mean"]


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "may_large_int8.offline_10s", "--seed", str(SEED),
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_a_missing_frame_is_not_equal():
    a = np.zeros((3, 4, 4, 3), np.uint8)
    assert check.numbers([(a[:2], a)])["frame_mse_mean"] == math.inf
    assert check.numbers([(a, a)])["frame_mse_mean"] == 0.0
    b = a.copy()
    b[1, :2] = 255  # half of one frame far off
    n = check.numbers([(b, a)])
    assert n["frame_off8_max"] == 0.5 and n["frame_mse_max"] == 255 ** 2 / 2


@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card(capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    assert run.main(["--workload", "obama_normal_bf16.serve_short", "--seed", str(SEED),
                     "--seconds", "5", "--trace", "0"]) == 0
    import json
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["correct"]
