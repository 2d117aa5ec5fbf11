"""PyTorch port, the fused motion half (pipeline/motion_graph.py) on the CPU
at test widths: ``compute_motion(fused=True)`` / ``animate(fused=True)``,
``Predictor.predict`` (which serves fused) and the stream's fused
steady-state advances, held against the port's staged path and against the
JAX package's ``fused=True``.  On the CPU the fused program's three
functions (G1, G2's decode steps, G3) run eagerly; the card replays G1 and
G3 from CUDA graphs and decodes in kernel K5 (chip_smoke.py phase 15)."""

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from livespeechportraits_tpu.pipeline import animate as janimate
from livespeechportraits_tpu.pipeline import assets as jassets
from livespeechportraits_torch import serve
from livespeechportraits_torch.config import replace
from livespeechportraits_torch.pipeline import animate, assets, motion_graph, streaming, video
from torch_parity import jax_headpose_noise, small_person_config, torch_config


def _chirp(seconds: float) -> np.ndarray:
    n = int(seconds * 16000)
    f = 120 + 400 * np.linspace(0, seconds, n)
    return (0.3 * np.sin(2 * np.pi * f * np.arange(n) / 16000)).astype(np.float32)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: bitwise comparisons need one summation order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _subject(gmm_head: bool = False):
    cfg = torch_config(small_person_config(image_size=32))
    if gmm_head:  # A2F's GMM head of 3 components: its component draws go in too
        cfg = replace(cfg, audio2feature=replace(cfg.audio2feature, loss="GMM", gmm_ncenter=3))
    person, models = assets.make_synthetic_person(cfg, image_size=32, device="cpu")
    return cfg, person, models


@pytest.fixture(scope="module")
def person():
    return _subject()


@pytest.mark.parametrize("gmm_head", [False, True])
def test_fused_equals_staged(person, gmm_head):
    """Landmarks and head pose bit for bit, frames within one level (JAX's
    tests/test_pipeline.py:148-165 allows 1e-4), one "motion" entry."""
    cfg, p, m = _subject(True) if gmm_head else person
    audio = video.make_test_tone(0.9)
    staged = animate.animate(cfg, p, m, audio, seed=11, render_batch=4)
    fused = animate.animate(cfg, p, m, audio, seed=11, render_batch=4, fused=True)
    assert fused.nframe == staged.nframe == 54 - 15
    np.testing.assert_array_equal(fused.landmarks, staged.landmarks)
    np.testing.assert_array_equal(fused.headpose, staged.headpose)
    np.testing.assert_array_equal(fused.pts3d, staged.pts3d)
    assert np.abs(fused.frames.astype(int) - staged.frames.astype(int)).max() <= 1
    assert set(fused.stage_ms) == {"motion", "render_device", "render"}
    # profile=True runs staged, as JAX's does
    prof = {}
    animate.compute_motion(cfg, p, m, audio, seed=11, stage_ms=prof, profile=True, fused=True)
    assert "headpose" in prof and "motion" not in prof


def test_fused_matches_jax_fused():
    """The same weights (from_jax) and the JAX decode's own noise: the
    tolerances tests/test_torch_slice.py holds the staged path to
    (landmarks 1e-3 px, head pose 1e-4, 3D points 1e-5, f32 frames within
    one level)."""
    jcfg = small_person_config(image_size=32)
    j_assets, j_models = jassets.make_synthetic_person(jcfg, key=jax.random.PRNGKey(5),
                                                       image_size=32)
    cfg = torch_config(jcfg)
    p, _ = assets.make_synthetic_person(cfg, image_size=32, skip_models=True, device="cpu")
    models = assets.from_jax(cfg, j_models, device="cpu")
    audio = video.make_test_tone(1.0)
    ref = janimate.animate(jcfg, j_assets, j_models, audio, seed=2, render_batch=4, fused=True)
    noise = jax_headpose_noise(2, ref.nframe, cfg.audio2headpose.ncenter,
                               cfg.audio2headpose.ndim)
    ours = animate.animate(cfg, p, models, audio, seed=2, render_batch=4,
                           headpose_noise=noise, fused=True)
    assert ours.nframe == ref.nframe == 45
    np.testing.assert_allclose(ours.landmarks, ref.landmarks, atol=1e-3)
    np.testing.assert_allclose(ours.headpose, ref.headpose, atol=1e-4)
    np.testing.assert_allclose(ours.pts3d, ref.pts3d, atol=1e-5)
    assert np.abs(ours.frames.astype(int) - ref.frames.astype(int)).max() <= 1
    assert "motion" in ours.stage_ms and "motion" in ref.stage_ms


def test_fused_bucketed_chirp_is_bitwise_exact(person):
    """A bucket-padded chirp with valid_frames equals the unpadded fused run
    bit for bit (JAX's tests/test_pipeline.py:167-183): the feature
    repeat-pad and the valid length are device scalars of one bucket's
    program."""
    cfg, p, m = person
    audio = _chirp(0.9)
    exact = animate.animate(cfg, p, m, audio, seed=11, render_batch=4, fused=True)
    bucketed = animate.animate(cfg, p, m, np.pad(audio, (0, 16000 - len(audio))), seed=11,
                               render_batch=4, fused=True,
                               valid_frames=int(len(audio) / 16000 * 60))
    assert bucketed.nframe == exact.nframe == 54 - 15
    for k in ("landmarks", "headpose", "pts3d", "frames"):
        np.testing.assert_array_equal(getattr(bucketed, k), getattr(exact, k), err_msg=k)
    # the bucket's buffers and functions served both lengths' shapes once each
    mg = motion_graph.for_models(cfg, p, m)
    assert {54 * 2, 60 * 2} <= set(mg.buckets)


class _OpRecorder(TorchDispatchMode):
    """Every aten op a block dispatches, with a flag for an index by a
    boolean mask."""

    def __init__(self):
        super().__init__()
        self.ops = []
        self.mask_index = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        self.ops.append(name)
        if name.startswith(("aten.index.", "aten.index_put", "aten._index_put")):
            idx = args[1] if len(args) > 1 else []
            if any(isinstance(t, torch.Tensor) and t.dtype == torch.bool for t in idx or []):
                self.mask_index.append(name)
        return func(*args, **(kwargs or {}))


FORBIDDEN = ("aten.lift_fresh", "aten._local_scalar_dense", "aten.nonzero")


def test_g1_g2_g3_make_no_host_read_and_build_no_host_tensor(person):
    """The capture-safety check: the second call of each fused function (G1,
    G2, G3 and the stream's chunk functions) records no tensor built from
    host data (lift_fresh), no host read (_local_scalar_dense: .item()), no
    nonzero and no boolean-mask index, any of which a CUDA graph cannot
    hold."""
    cfg, p, m = person
    audio = _chirp(1.0)
    animate.compute_motion(cfg, p, m, audio, seed=3, valid_frames=55, fused=True)
    mg = motion_graph.for_models(cfg, p, m)
    b = mg.bucket(120)
    # and the stream's two chunk functions (the first calls upload constants)
    ch = motion_graph.ChunkGraphs(mg, 16)
    with torch.no_grad():
        ch.front()
        ch.motion()
    for name, fn in (("G1", lambda: mg.g1(b)), ("G2", lambda: mg.g2(1)),
                     ("G3", lambda: mg.g3(b)), ("stream_front", ch.front),
                     ("stream_motion", ch.motion)):
        with torch.no_grad(), _OpRecorder() as rec:
            fn()
        assert rec.ops, name
        bad = [op for op in rec.ops if op.startswith(FORBIDDEN)]
        assert not bad and not rec.mask_index, (name, bad, rec.mask_index)
    # the recorded calls left a consistent state: a new request is unchanged
    again = animate.compute_motion(cfg, p, m, audio, seed=3, valid_frames=55, fused=True)
    staged = animate.compute_motion(cfg, p, m, audio, seed=3, valid_frames=55)
    assert again[-1] == staged[-1] == 55 - 15
    for x, y in zip(again[:4], staged[:4]):
        assert torch.equal(x, y)


def _stream(cfg, p, m, audio, mega: bool, motion: bool):
    s = streaming.StreamingAnimator(cfg, p, m, seed=7, chunk=16, render_batch=4)
    if not mega:
        s._advance_stream_fused = lambda: False
    if not motion:
        s._advance_motion_fused = lambda: False
    push = int(16 / 60 * 16000) + 1  # chunk-sized pushes: the steady state
    outs = [s.push_audio(audio[lo:lo + push]) for lo in range(0, len(audio), push)]
    outs.append(s.flush())
    return np.concatenate(outs), s.stage_ms


@pytest.mark.parametrize("gmm_head", [False, True])
def test_stream_fused_advances_engage_and_are_bitwise(person, gmm_head):
    """JAX's tests/test_streaming.py:62-126: on chunk-sized pushes the
    whole-half advance engages (mega_chunks), and with it off the motion
    advance does (fused_chunks); the frames equal the per-stage stream's
    bit for bit, and the offline pipeline's."""
    cfg, p, m = _subject(True) if gmm_head else person
    audio = video.make_test_tone(2.0)
    ref, sm_ref = _stream(cfg, p, m, audio, mega=False, motion=False)
    mega, sm_mega = _stream(cfg, p, m, audio, mega=True, motion=True)
    motion, sm_motion = _stream(cfg, p, m, audio, mega=False, motion=True)
    assert "mega_chunks" not in sm_ref and "fused_chunks" not in sm_ref
    assert sm_mega.get("mega_chunks", 0) >= 3
    assert sm_motion.get("fused_chunks", 0) >= 3 and "mega_chunks" not in sm_motion
    np.testing.assert_array_equal(mega, ref)
    np.testing.assert_array_equal(motion, ref)
    offline = animate.animate(cfg, p, m, audio, seed=7, render_batch=4, fused=True)
    np.testing.assert_array_equal(ref, offline.frames)


def test_predictor_predict_serves_fused(person, tmp_path):
    """Predictor.predict runs the motion half fused (one "motion" entry) and
    its bucketed request still equals the exact staged run bit for bit
    (tests/test_torch_serve.py::test_bucketed_chirp_is_bitwise_exact's
    property, through the Predictor); prewarm() captures nothing on the
    CPU."""
    cfg, p, m = person
    pred = serve.Predictor(max_audio_seconds=2.0, device="cpu", results_dir=str(tmp_path))
    pred._cfg, pred._assets, pred._models = cfg, p, m
    assert pred.bucket_lengths() == [120, 240]
    assert pred.prewarm() == {}
    audio = _chirp(0.9)
    got = pred.predict(audio, seed=11, render_batch=4, transfer="rgb", write_video=False)
    exact = animate.animate(cfg, p, m, audio, seed=11, render_batch=4)
    assert set(got.stage_ms) == {"motion", "render_device", "render"}
    assert got.nframe == exact.nframe == 54 - 15
    np.testing.assert_array_equal(got.frames, exact.frames)
