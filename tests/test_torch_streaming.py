"""PyTorch port, the live path (pipeline/streaming.py, serve.Predictor.stream
and the server's /stream) on the CPU at test widths: the stream against the
JAX package's stream on the same weights and noise, and against the port's
own offline pipeline."""

import io
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import numpy as np
import pytest
import torch
from scipy.io import wavfile
from scipy.ndimage import gaussian_filter1d

from livespeechportraits_tpu.pipeline import assets as jassets
from livespeechportraits_tpu.pipeline import streaming as jstreaming
from livespeechportraits_torch import serve, server
from livespeechportraits_torch.pipeline import animate, assets, streaming, video
from torch_parity import jax_headpose_noise, small_person_config, torch_config

# The stream against the offline pipeline (JAX test_streaming.py's bound):
# uint8 frames may differ by one level where a float lands on a rounding
# edge in another batch shape, on under 1 % of the values.  Measured on the
# CPU: equal.
MAX_LEVELS = 1
DIFF_SHARE = 0.01


def _chirp(seconds: float) -> np.ndarray:
    n = int(seconds * 16000)
    f = 120 + 400 * np.linspace(0, seconds, n)
    return (0.3 * np.sin(2 * np.pi * f * np.arange(n) / 16000)).astype(np.float32)


def _run(st, audio, push):
    """Push ``audio`` in pieces of ``push`` samples, then flush -> (frames,
    the frame count each call returned)."""
    outs = [st.push_audio(audio[lo:lo + push]) for lo in range(0, len(audio), push)]
    outs.append(st.flush())
    return np.concatenate(outs), [len(o) for o in outs]


def _assert_close(a, b):
    assert a.shape == b.shape, (a.shape, b.shape)
    d = np.abs(a.astype(int) - b.astype(int))
    assert d.max() <= MAX_LEVELS and (d > 0).mean() < DIFF_SHARE, (d.max(), (d > 0).mean())


@pytest.fixture(scope="module")
def person():
    cfg = torch_config(small_person_config(image_size=64))
    person, models = assets.make_synthetic_person(cfg, image_size=64, device="cpu")
    return cfg, person, models


@pytest.mark.parametrize("sigma,T,push", [(2.0, 50, 7), (10.0, 13, 4), (10.0, 25, 4),
                                          (5.0, 3, 4), (2.0, 1, 4), (10.0, 41, 3)])
def test_stream_smoother_matches_gaussian_filter1d(sigma, T, push):
    """Odd push sizes and clips shorter than the radius (the repeated
    reflection at both ends)."""
    x = np.random.default_rng(int(T)).normal(size=(T, 3)).astype(np.float32)
    sm = streaming._StreamSmoother(sigma)
    outs = [sm.push(x[lo:lo + push]) for lo in range(0, T, push)]
    outs.append(sm.flush((3,)))
    ours = np.concatenate(outs)
    np.testing.assert_allclose(ours, gaussian_filter1d(x, sigma, axis=0), atol=1e-5)
    assert sm.emitted == T and len(sm.buf) <= sm.radius + push


def test_stream_smoother_latency_cap():
    """A capped look-ahead emits rows while fewer than the radius exist:
    finite, one row per input, the latency cut to the cap."""
    x = np.random.default_rng(2).normal(size=(30, 2)).astype(np.float32)
    sm = streaming._StreamSmoother(10.0, max_radius=5)
    assert sm.radius == 40 and sm.future == 5
    first = sm.push(x[:16])
    assert len(first) == 11
    ours = np.concatenate([first, sm.push(x[16:]), sm.flush((2,))])
    assert ours.shape == x.shape and np.isfinite(ours).all()


def test_row_buffer_retirement():
    buf = streaming._RowBuffer((2,))
    buf.append(torch.arange(10.0).reshape(5, 2))
    buf.append(torch.zeros(0, 2))
    buf.retire(3)
    assert len(buf) == 5 and buf.resident == 2 and buf.base == 3
    assert torch.equal(buf.slice(3, 5), torch.tensor([[6.0, 7.0], [8.0, 9.0]]))
    with pytest.raises(IndexError, match="retired"):
        buf.slice(2, 4)
    buf.retire(99)  # clamped to what exists
    assert len(buf) == 5 and buf.resident == 0


def test_stream_matches_the_jax_stream():
    """The same weights (from_jax), the JAX decode's own noise, pushed in
    3001-sample pieces: the same frame count and frames within one level.
    Measured: equal."""
    jcfg = small_person_config(image_size=64)
    j_assets, j_models = jassets.make_synthetic_person(jcfg, key=jax.random.PRNGKey(5),
                                                       image_size=64)
    cfg = torch_config(jcfg)
    person, _ = assets.make_synthetic_person(cfg, image_size=64, skip_models=True,
                                             device="cpu")
    models = assets.from_jax(cfg, j_models, device="cpu")
    audio = video.make_test_tone(1.2)
    a2h = cfg.audio2headpose
    noise = jax_headpose_noise(4, 72 - a2h.frame_future, a2h.ncenter, a2h.ndim)
    ref, _ = _run(jstreaming.StreamingAnimator(jcfg, j_assets, j_models, seed=4, chunk=16,
                                               render_batch=4), audio, 3001)
    ours, counts = _run(streaming.StreamingAnimator(cfg, person, models, chunk=16,
                                                    render_batch=4, headpose_noise=noise),
                        audio, 3001)
    assert ours.shape == ref.shape == (72 - a2h.frame_future, 64, 64, 3)
    assert sum(counts[:-1]) > 0  # frames before the flush
    _assert_close(ours, ref)


@pytest.mark.parametrize("seconds,push", [(1.2, 3001), (0.9, 2559)])
def test_stream_matches_offline_animate(person, seconds, push):
    """0.9 s is shorter than the head-pose smoothing's reach: the flush's
    repeated reflection through the whole pipeline."""
    cfg, person_assets, models = person
    audio = _chirp(seconds)
    offline = animate.animate(cfg, person_assets, models, audio, seed=5, render_batch=4)
    st = streaming.StreamingAnimator(cfg, person_assets, models, seed=5, chunk=16,
                                     render_batch=4)
    frames, _ = _run(st, audio, push)
    assert frames.shape[0] == offline.nframe == int(seconds * 60) - 15
    _assert_close(frames, offline.frames)
    # the per-stage path's stages and the fused advances' attempts; the
    # counts of fused chunks when they engaged
    assert set(st.stage_ms) - {"mega_chunks", "fused_chunks"} == {
        "mel_apc", "a2f", "a2h", "post", "finalize_render", "stream_fused", "motion_fused"}
    assert st.latency_frames == max(cfg.audio2feature.frame_future + 8,
                                    cfg.audio2headpose.frame_future + 40)


def test_pipeline_depth_hands_the_same_frames_back_later(person):
    cfg, person_assets, models = person
    audio = _chirp(1.2)

    def run(depth):
        st = streaming.StreamingAnimator(cfg, person_assets, models, seed=7, chunk=16,
                                         render_batch=4, pipeline_depth=depth)
        frames, counts = _run(st, audio, 4000)
        assert not st._render_inflight
        return frames, counts

    ref, ref_counts = run(0)
    out, counts = run(1)
    np.testing.assert_array_equal(out, ref)
    first = next(i for i, c in enumerate(ref_counts) if c)
    assert next(i for i, c in enumerate(counts) if c) > first
    assert sum(counts) == sum(ref_counts)


@pytest.mark.parametrize("transfer,offline_transfer", [("yuv420", "yuv420"),
                                                       ("pack4e", "jpeg4")])
def test_stream_transfers(person, transfer, offline_transfer):
    """The stream under a coder equals the offline pipeline under the same
    code (pack4e: a lossless recoding of jpeg4), pipelined one push deep."""
    cfg, person_assets, models = person
    audio = _chirp(1.0)
    offline = animate.animate(cfg, person_assets, models, audio, seed=4, render_batch=4,
                              transfer=offline_transfer)
    st = streaming.StreamingAnimator(cfg, person_assets, models, seed=4, chunk=16,
                                     render_batch=4, transfer=transfer, pipeline_depth=1)
    frames, _ = _run(st, audio, 4000)
    _assert_close(frames, offline.frames)


def test_push_after_flush_or_close_raises(person):
    cfg, person_assets, models = person
    st = streaming.StreamingAnimator(cfg, person_assets, models)
    st.push_audio(_chirp(0.5))
    st.flush()
    with pytest.raises(RuntimeError, match="flushed"):
        st.push_audio(np.zeros(100, np.float32))
    with pytest.raises(RuntimeError, match="flushed"):
        st.flush()
    with streaming.StreamingAnimator(cfg, person_assets, models) as st2:
        st2.push_audio(_chirp(0.3))
    with pytest.raises(RuntimeError, match="closed"):
        st2.push_audio(np.zeros(100, np.float32))


def test_run_yields_each_push_and_closes(person):
    """run() is the push loop of Predictor.stream and the demo: the frames
    of pushing by hand, in non-empty batches; an abandoned run closes its
    stream."""
    cfg, person_assets, models = person
    audio = _chirp(0.7)
    want, _ = _run(streaming.StreamingAnimator(cfg, person_assets, models, seed=2), audio, 2000)
    batches = list(streaming.StreamingAnimator(cfg, person_assets, models, seed=2)
                   .run(audio, push_samples=2000))
    assert all(len(b) for b in batches)
    np.testing.assert_array_equal(np.concatenate(batches), want)
    st = streaming.StreamingAnimator(cfg, person_assets, models, seed=2)
    gen = st.run(audio, push_samples=2000)
    next(gen)
    gen.close()
    with pytest.raises(RuntimeError, match="closed"):
        st.push_audio(np.zeros(100, np.float32))


def test_soak_keeps_resident_buffers_bounded():
    """An unbounded live stream must not grow: every buffer retires what
    it consumed, so the resident rows at 6 s equal those at 3 s."""
    cfg = torch_config(small_person_config(image_size=32))
    person_assets, models = assets.make_synthetic_person(cfg, image_size=32, device="cpu")
    st = streaming.StreamingAnimator(cfg, person_assets, models, seed=1, chunk=8,
                                     render_batch=4)

    def residents():
        return {"feats": st._feats.resident, "a2f_raw": st._a2f_raw.resident,
                "head_raw": st._head_raw.resident, "down_rows": st._down_rows.resident,
                "mouth_smooth": len(st._mouth_smooth.buf),
                "rot_smooth": len(st._rot_smooth.buf),
                "ready": st._mouth_ready.resident + st._rot_ready.resident
                + st._trans_ready.resident}

    audio = _chirp(6.0)
    step = 2000
    frames, mid = 0, None
    for lo in range(0, len(audio), step):
        frames += len(st.push_audio(audio[lo:lo + step]))
        if lo == len(audio) // 2 // step * step:
            mid = residents()
    end = residents()
    st.close()
    assert frames > 250
    assert mid == end
    assert end["feats"] <= 8 * st.chunk and len(st._audio) <= 3 * step
    assert all(v <= 200 for v in end.values()), end


@pytest.fixture(scope="module")
def predictor(tmp_path_factory):
    """An int8, calibrated Predictor on the CPU at 32^2 and test widths."""
    with pytest.MonkeyPatch.context() as mp:
        small = torch_config(small_person_config())
        mp.setattr(serve, "PersonConfig", lambda name="Synthetic": small)
        p = serve.Predictor(max_audio_seconds=3.0, device="cpu",
                            results_dir=str(tmp_path_factory.mktemp("srv")))
        p.setup("Synthetic", image_size=32, quantize=True)
    return p


def test_predictor_stream_matches_predict(predictor):
    """Predictor.stream as /stream calls it: non-empty batches, the frame
    count of predict() on the same (capped) audio, the frames within the
    stream's bound of predict's."""
    audio = _chirp(3.3)  # the 3 s cap applies to both
    ref = predictor.predict(audio, transfer="yuv420", write_video=False)
    batches = list(predictor.stream(audio, transfer="yuv420", render_batch=8,
                                    push_samples=1600, pipeline_depth=1))
    assert all(len(b) for b in batches) and len(batches) > 1
    _assert_close(np.concatenate(batches), ref.frames)
    assert ref.nframe == 180 - 15


def test_server_stream_sends_a_part_a_frame(predictor):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), server.make_handler(predictor))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        buf = io.BytesIO()
        wavfile.write(buf, 16000, (_chirp(0.8) * 32767).astype(np.int16))
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/stream?latency_cap=5",
            data=buf.getvalue(), method="POST", headers={"Content-Type": "audio/wav"})
        with urllib.request.urlopen(req, timeout=600) as r:
            assert r.status == 200
            assert r.headers["Content-Type"].startswith("multipart/x-mixed-replace")
            body = r.read()
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=30)
    assert body.endswith(b"--frame--\r\n")
    parts = body.split(b"--frame\r\n")[1:]
    assert len(parts) == 48 - 15
    assert all(p.startswith(b"Content-Type: image/jpeg\r\n") for p in parts)
    import cv2

    first = parts[0].split(b"\r\n\r\n", 1)[1]
    img = cv2.imdecode(np.frombuffer(first, np.uint8), cv2.IMREAD_COLOR)
    assert img.shape == (32, 32, 3)
