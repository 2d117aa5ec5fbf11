"""PyTorch port, the request trace (utils/profiling.py): the spans and
counters serve.Predictor.predict, the fused motion half and the renderer
record, the ring of requests, and program.json beside the profiler's
trace.json, on the CPU at 32^2 and test widths; one case on the card."""

import json

import numpy as np
import pytest
import torch

from livespeechportraits_torch import serve
from livespeechportraits_torch.models import feature2face as f2f
from livespeechportraits_torch.utils import profiling
from torch_parity import card_person_config, small_person_config, torch_config

SPANS = {"predict": None, "motion": "predict", "motion.g1": "motion",
         "motion.decode": "motion", "motion.g3": "motion", "render": "predict",
         "render.tail": "render"}
BATCH = 16
LABEL = "test::predict"


def _chirp(seconds: float) -> np.ndarray:
    n = int(seconds * 16000)
    f = 120 + 400 * np.linspace(0, seconds, n)
    return (0.3 * np.sin(2 * np.pi * f * np.arange(n) / 16000)).astype(np.float32)


def _predictor(device: str, tmp_path_factory, quantize: bool = False) -> serve.Predictor:
    """A float (or, with quantize, an int8, folded and calibrated) Predictor
    at 32^2 and test widths (on the card the head-pose WaveNet at its
    published shape, the one K5 takes), 1 s buckets up to 2 s."""
    with pytest.MonkeyPatch.context() as mp:
        small = (card_person_config() if device == "cuda"
                 else torch_config(small_person_config()))
        mp.setattr(serve, "PersonConfig", lambda name="Synthetic": small)
        p = serve.Predictor(max_audio_seconds=2.0, bucket_seconds=1.0, device=device,
                            results_dir=str(tmp_path_factory.mktemp("trace_srv")))
        p.setup("Synthetic", image_size=32, quantize=quantize)
    return p


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """One 1.4 s request (padded to the 2 s bucket) under profiling.trace,
    inside a profiler label, with the steps G2 decoded counted: (the
    predictor, the result, G2's steps, the directory of trace.json and
    program.json)."""
    torch.set_num_threads(1)
    pred = _predictor("cpu", tmp_path_factory)
    mg = pred._motion()
    calls = []
    g2 = mg.g2
    mg.g2 = lambda n: (calls.append(n), g2(n))
    log_dir = tmp_path_factory.mktemp("trace_log")
    audio = _chirp(1.4)
    try:
        with profiling.trace(str(log_dir)):
            with torch.profiler.record_function("test::warm"):  # a label's first entry is slow
                pass
            with torch.profiler.record_function(LABEL):
                res = pred.predict(audio, render_batch=BATCH, transfer="rgb",
                                   write_video=False)
    finally:
        del mg.g2
    return pred, res, sum(calls), log_dir


def test_spans_nest_under_one_request_and_time_stage_ms(traced):
    _, res, _, _ = traced
    tr = res.trace
    assert any(r is tr for r in profiling.REQUESTS) and tr.error is None
    assert {s.name: s.parent for s in tr.spans} == SPANS
    pred_span = tr.find("predict")
    for s in tr.spans:
        assert pred_span.start_ns <= s.start_ns <= s.end_ns <= pred_span.end_ns
        assert s.device_ms is None and not s.events  # the CPU: no events
    motion = tr.find("motion")
    g1, decode, g3 = (tr.find(n) for n in ("motion.g1", "motion.decode", "motion.g3"))
    assert motion.start_ns <= g1.start_ns <= g1.end_ns == decode.start_ns
    assert decode.end_ns == g3.start_ns <= g3.end_ns <= motion.end_ns
    assert tr.find("render").end_ns <= tr.find("render.tail").start_ns
    assert res.stage_ms == {"motion": motion.host_ms, "render_device": tr.find("render").host_ms,
                            "render": tr.find("render.tail").host_ms}


def test_counters_count_the_padding(traced):
    pred, res, g2_steps, _ = traced
    c = res.trace.counters
    # 1.4 s: 84 - 15 frames returned; its 2 s bucket decodes 120 - 15 steps
    assert c["frames_returned"] == res.nframe == 84 - 15
    assert c["frames_rendered"] == -(-res.nframe // BATCH) * BATCH == 80
    assert c["decode_steps"] == g2_steps == 120 - 15
    assert c["graph_captures"] == 0  # the CPU runs the functions eagerly


@pytest.mark.parametrize("quantize", [False, True])
def test_folded_bn_skipped_counts_the_skipped_layers(traced, tmp_path_factory, quantize):
    """folded_bn_skipped: the folded BNs of the renderer (all 25 of the
    int8 ResUNet's, none of the float one's) times the render batches, in
    the request's counters and in program.json."""
    pred, res, _, log_dir = traced
    if quantize:
        pred = _predictor("cpu", tmp_path_factory, quantize=True)
        log_dir = tmp_path_factory.mktemp("trace_log_int8")
        with profiling.trace(str(log_dir)):
            res = pred.predict(_chirp(1.4), render_batch=BATCH, transfer="rgb",
                               write_video=False)
    marked = f2f.folded_bn_count(pred._models.feature2face)
    assert marked == (25 if quantize else 0)
    assert res.trace.counters["folded_bn_skipped"] == marked * 80 // BATCH
    program = json.loads((log_dir / "program.json").read_text())
    counters = next(e["args"]["counters"] for e in program["traceEvents"]
                    if e["name"] == "predict" and e["tid"] == f"request {res.trace.id}")
    assert counters["folded_bn_skipped"] == marked * 80 // BATCH


def test_failed_calls_leave_one_record_each_and_the_ring_stays_bounded(traced):
    pred = traced[0]
    first = profiling.REQUESTS[-1].id + 1
    n = profiling.REQUESTS.maxlen + 3
    for _ in range(n):
        with pytest.raises(ValueError, match="audio too short"):
            pred.predict(_chirp(0.1), write_video=False)
    ring = list(profiling.REQUESTS)
    assert len(ring) == profiling.REQUESTS.maxlen
    assert [r.id for r in ring] == list(range(first + 3, first + n))
    last = ring[-1]
    assert last.error.startswith("ValueError: audio too short")
    assert [s.name for s in last.spans] == ["predict"] and last.find("predict").end_ns
    assert not last.counters


def test_program_json_shares_the_profilers_timeline(traced):
    _, res, _, log_dir = traced
    program = json.loads((log_dir / "program.json").read_text())
    prof = json.loads((log_dir / "trace.json").read_text())
    assert program["baseTimeNanoseconds"] == prof["baseTimeNanoseconds"]
    tid = f"request {res.trace.id}"
    spans = {e["name"]: e for e in program["traceEvents"] if e["ph"] == "X"}
    assert set(spans) == set(SPANS) and all(e["tid"] == tid for e in spans.values())
    assert spans["predict"]["args"]["counters"]["frames_returned"] == res.nframe
    assert spans["motion"]["args"] == {"parent": "predict", "device_ms": None}
    label = next(e for e in prof["traceEvents"] if e.get("name") == LABEL)
    assert abs(spans["predict"]["ts"] - label["ts"]) < 1e3  # µs
    # the program's spans are no profiler ranges: only the coder's label
    names = {e.get("name", "") for e in prof["traceEvents"]}
    assert {n for n in names if n.startswith("lsp::")} == {"lsp::coder"}


@pytest.mark.cuda
def test_device_spans_and_no_capture_in_a_warm_bucket(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    pred = _predictor("cuda", tmp_path_factory)
    first, second = (pred.predict(_chirp(s), transfer="rgb", write_video=False).trace
                     for s in (1.4, 1.2))
    assert first.counters["graph_captures"] == 2  # the bucket's G1 and G3
    assert second.counters["graph_captures"] == 0
    for tr in (first, second):
        ms = {s.name: s.device_ms for s in tr.spans if s.name in SPANS}
        assert all(v is not None and v > 0 for k, v in ms.items()
                   if k not in ("predict", "render.tail")), ms
        assert ms["motion"] == pytest.approx(ms["motion.g1"] + ms["motion.decode"]
                                             + ms["motion.g3"], rel=1e-3, abs=5e-3)
        assert ms["motion"] + ms["render"] <= tr.find("predict").host_ms
        assert not any(s.events for s in tr.spans)
