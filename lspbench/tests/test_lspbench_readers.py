"""Each per-layer metric's reader on a context built by hand: what it reads
and when it finds nothing to read."""

from __future__ import annotations

import importlib.util

import pytest

from lspbench import counts, devtrace, manifest, run
from lspbench.tests.conftest import tiny_config, tiny_mix

H100 = counts.PEAKS["H100 80GB HBM3"]


def _ctx(precision="int8", trace=None, traced=()):
    c = tiny_config("may_large_int8" if precision == "int8" else "obama_normal_bf16")
    recs = [run.Record(i, 2.0, 500.0, nframe=105,
                       stage_ms={"motion": 100.0, "render_device": 300.0, "render": 20.0})
            for i in range(4)]
    return run.Context(c, tiny_mix("serve_short"), recs, 2.0, H100, trace, list(traced))


def test_the_span_readers():
    ctx = _ctx()
    assert run._read("entry_overhead_ms.serve", ctx) == 80.0
    assert run._read("motion_ms_per_frame.serve", ctx) == 400.0 / 420
    assert run._read("render_ms_per_frame.serve", ctx) == 4 * 320.0 / (4 * 112)  # 7 batches
    assert run._read("transfer_tail_ms.serve", ctx) == 20.0
    mfu = run._read("mfu.offline", ctx)
    assert mfu == pytest.approx(100 * counts.frame_flops(ctx.config) * 420 / 2.0 / H100["int8"])


def _trace(k4_records, k4_seconds):
    return devtrace.Trace(busy_s=0.75, window_s=1.0,
                          kernel_s={"void q8conv_halo_kernel<bf16>": k4_seconds, "other": 0.5},
                          kernel_count={"void q8conv_halo_kernel<bf16>": k4_records, "other": 9},
                          device_records=k4_records + 9)


def test_the_trace_readers():
    traced = [run.Record(0, 2.0, 500.0, nframe=105)]  # 7 batches
    convs = sum(cv.int8 for cv in counts.generator_convs(tiny_config("may_large_int8")))
    ctx = _ctx(trace=_trace(7 * convs, 0.01), traced=traced)
    assert run._read("device_idle_share.offline", ctx) == pytest.approx(25.0)
    k4 = run._read("k4_roofline.offline", ctx)
    assert k4 == pytest.approx(100 * 7 * counts.int8_bound_s(ctx.config, 16, H100) / 0.01)
    # records dropped, a float renderer, or no trace: nothing to read
    assert run._read("k4_roofline.offline", _ctx(trace=_trace(5, 0.01), traced=traced)) is None
    assert run._read("k4_roofline.offline", _ctx("bf16", _trace(500, 0.01), traced)) is None
    assert run._read("device_idle_share.serve", _ctx()) is None


def test_every_reader_named_in_the_manifest_exists():
    for p in manifest.load()["per_layer"]:
        spec = importlib.util.spec_from_file_location(p["name"], manifest.reader_path(p["name"]))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert callable(mod.read)


def test_idle_gaps_are_named_by_the_host_record_that_spans_them():
    class E:
        def __init__(self, name, s, t, dev):
            self.name, self.device_type = name, "DeviceType.CUDA" if dev else "DeviceType.CPU"
            self.time_range = type("R", (), {"start": s, "end": t})()
    ev = [E("k", 0, 10, True), E("k", 30, 40, True), E("k", 35, 50, True), E("k", 60, 70, True),
          E("outer", 0, 100, False), E("cudaGraphLaunch", 12, 28, False)]
    tr = devtrace.reduce(ev, window_s=100e-6)
    assert tr.busy_s == pytest.approx(40e-6) and tr.device_records == 4
    assert dict(tr.idle_gaps) == pytest.approx({"cudaGraphLaunch": 20e-6, "outer": 10e-6})
