"""The readers of the program's request trace (``profiling.REQUESTS``) on a
context and a ring built by hand: what they read, where they find the
measured window, and when they find nothing to read."""

from __future__ import annotations

import collections
import math

import pytest

from livespeechportraits_torch.utils import profiling
from lspbench import counts, run
from lspbench.tests.conftest import tiny_config, tiny_mix

H100 = counts.PEAKS["H100 80GB HBM3"]

REQUEST_READERS = ("motion_device_ms_per_frame", "render_device_ms_per_frame",
                   "decode_useful_share", "render_useful_share")


def _request(nframe, motion_ms=10.0, render_ms=300.0, steps=165, rendered=112, error=None):
    """A program's request trace as Predictor.predict leaves it."""
    tr = profiling.RequestTrace(0, error=error)
    if error is None:
        tr.add("motion", "predict", 0, 1).device_ms = motion_ms
        tr.add("render", "predict", 1, 2).device_ms = render_ms
        tr.counters.update(frames_returned=nframe, decode_steps=steps, frames_rendered=rendered)
    return tr


def _request_ctx(monkeypatch, window, before=1, after=1):
    """Four records of 105 frames, the third failed, one traced request, and
    a ring of ``before`` warm-ups, the window, and the traced request, each
    of those others reading other numbers."""
    recs = [run.Record(i, 2.0, 500.0, nframe=105,
                       stage_ms={"motion": 100.0, "render_device": 300.0, "render": 20.0})
            for i in range(4)]
    recs[2] = run.Record(2, 2.0, math.inf, error="ValueError: audio too short")
    ctx = run.Context(tiny_config("may_large_int8"), tiny_mix("serve_short"), recs, 2.0, H100,
                      None, [run.Record(4, 1.0, 300.0, nframe=45)])
    other = [_request(45, 99.0, 99.0, 99, 99)]
    ring = other * before + window + other * after
    monkeypatch.setattr(profiling, "REQUESTS", collections.deque(ring, maxlen=1024))
    return ctx


def _window():
    window = [_request(105) for _ in range(4)]
    window[2] = _request(0, error="ValueError: audio too short")
    return window


@pytest.mark.parametrize("kind", ["offline", "serve"])
def test_the_request_readers_read_the_window(monkeypatch, kind):
    window = _window()
    ctx = _request_ctx(monkeypatch, window)
    assert run._read(f"motion_device_ms_per_frame.{kind}", ctx) == 30.0 / 315
    assert run._read(f"render_device_ms_per_frame.{kind}", ctx) == 900.0 / 336
    if kind == "serve":
        assert run._read("decode_useful_share.serve", ctx) == 100.0 * 315 / 495
        assert run._read("render_useful_share.serve", ctx) == 100.0 * 315 / 336
    # no warm-up before the window reads the same
    assert run._read(f"motion_device_ms_per_frame.{kind}",
                     _request_ctx(monkeypatch, window, before=0)) == 30.0 / 315


@pytest.mark.parametrize("case", ["short ring", "nframe differs", "error differs", "no ring",
                                  "no device time"])
def test_the_request_readers_find_nothing_to_read(monkeypatch, case):
    window = _window()
    before, after = 1, 1
    if case == "short ring":
        before, after = 0, 0  # the traced request's trace is missing
    elif case == "nframe differs":
        window[1] = _request(104)
    elif case == "error differs":
        window[2] = _request(0)
    elif case == "no device time":
        window[0] = _request(105, motion_ms=None, render_ms=None)
    ctx = _request_ctx(monkeypatch, window, before, after)
    if case == "no ring":  # a program that predates the request trace
        monkeypatch.delattr(profiling, "REQUESTS")
    for name in REQUEST_READERS:
        for kind in ("offline", "serve"):
            if name in ("decode_useful_share", "render_useful_share") and kind == "offline":
                continue
            value = run._read(f"{name}.{kind}", ctx)
            if case == "no device time" and "useful" in name:
                assert value is not None  # the counters stand without device times
            else:
                assert value is None, (name, kind)
