"""The port's demo CLI (livespeechportraits_torch/demo.py) with the JAX
demo's flags, on the CPU at 64^2 (full-width motion models, the synthetic
subject, 0.5 s of the test tone).

Each flag group runs once, and the results are held against the port's
``animate()`` (a spy keeps each run's AnimateResult), which
tests/test_torch_slice.py holds against JAX:
- ``--quantize --artifact A --bucket_seconds 1 --save_intermediates 1`` from
  scratch writes A; the same command reads it: equal landmarks and frames;
- bucketed against unbucketed (``--fused``, which changes nothing): the
  landmarks, frames and head pose bitwise equal on the CPU, as JAX's
  tests/test_pipeline.py:131-178 holds;
- the ``--save_intermediates`` files and their counts;
- ``--quantize --no_calibrate`` and a ``save_input: true`` YAML: dynamic
  activation scales, and the feature-map video;
- ``--*_ckpt`` with an existing artifact exits non-zero, as JAX's does;
- the streaming note for the offline-path flags;
- ``video.save_frames`` and its fallback without cv2.
"""

from __future__ import annotations

import contextlib
import glob
import io
import os

import numpy as np
import pytest
import torch

from livespeechportraits_torch import demo
from livespeechportraits_torch.config import PersonConfig
from livespeechportraits_torch.pipeline import animate, assets, video

BASE = ["--device", "cpu", "--image_size", "64", "--duration", "0.5",
        "--driving_audio", "missing.wav"]
NFRAME = 30 - 15  # 0.5 s at 60 FPS less the head-pose lookahead


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the bucketed and the exact run sum in one order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Spy:
    """Records every animate() result and every quantize call of the demo."""

    def __init__(self, mp):
        self.results, self.quantized = [], []
        real_animate, real_quantize = animate.animate, assets.quantize_person_models

        def spy_animate(*a, **kw):
            self.results.append(real_animate(*a, **kw))
            return self.results[-1]

        def spy_quantize(models, **kw):
            self.quantized.append(kw)
            return real_quantize(models, **kw)

        mp.setattr(animate, "animate", spy_animate)
        mp.setattr(assets, "quantize_person_models", spy_quantize)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The demo's runs, in one process: {name: (AnimateResult, stdout, dir)}."""
    root = tmp_path_factory.mktemp("demo")
    art = str(root / "serving.npz")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        spy = _Spy(mp)

        def run(name, *flags):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                demo.main(BASE + ["--results_dir", str(root / name), *flags])
            out[name] = (spy.results[-1], buf.getvalue(),
                         root / name / "Synthetic" / "missing")

        bucketed = ("--quantize", "--artifact", art, "--bucket_seconds", "1",
                    "--save_intermediates", "1")
        run("scratch", *bucketed)
        out["scratch_quantize"] = spy.quantized[-1]
        run("artifact", *bucketed)
        run("exact", "--artifact", art, "--save_intermediates", "1", "--fused")
        n_quantize = len(spy.quantized)
        (root / "cfg").mkdir()
        (root / "cfg" / "Synthetic.yaml").write_text(
            "model_params:\n  Image2Image:\n    save_input: true\n")
        run("dynamic", "--quantize", "--no_calibrate", "--config_dir", str(root / "cfg"))
        out["dynamic_quantize"] = spy.quantized[n_quantize:]
        out["art"] = art
    return out


def test_artifact_written_then_read_gives_the_same_frames(runs):
    scratch, log, _ = runs["scratch"]
    again, log2, _ = runs["artifact"]
    assert "wrote artifact" in log and "wrote artifact" not in log2
    assert os.path.exists(runs["art"])
    # the calibration batch: max(render_batch, 8) frames in the compute dtype
    calib = runs["scratch_quantize"]["calibrate_inputs"]
    assert calib.shape == (8, 64, 64, 13) and calib.dtype == torch.bfloat16
    assert runs["scratch_quantize"]["calibrate_dtype"] == torch.bfloat16
    np.testing.assert_array_equal(again.landmarks, scratch.landmarks)
    np.testing.assert_array_equal(again.frames, scratch.frames)
    # held against animate() on the artifact's models, the demo's arguments
    cfg, person, _ = assets.load_subject(PersonConfig(name="Synthetic"), 64, skip_models=True,
                                         device="cpu")
    models = assets.load_models_artifact(runs["art"], cfg, "cpu")
    audio = video.make_test_tone(3.0)[:8000]
    ref = animate.animate(cfg, person, models, audio, render_batch=8)
    np.testing.assert_array_equal(runs["exact"][0].frames, ref.frames)


def test_bucketed_equals_exact_and_fused_changes_nothing(runs):
    bucketed, _, _ = runs["artifact"]
    exact, log, _ = runs["exact"]
    assert "note: --fused has no effect" in log
    assert bucketed.nframe == exact.nframe == NFRAME
    np.testing.assert_array_equal(bucketed.landmarks, exact.landmarks)
    np.testing.assert_array_equal(bucketed.frames, exact.frames)
    # bitwise, as JAX holds it (the smoother sums tap by tap, whatever the
    # padded length)
    np.testing.assert_array_equal(bucketed.headpose, exact.headpose)


def test_save_intermediates_files_and_counts(runs):
    result, log, where = runs["artifact"]
    jpgs = sorted(glob.glob(str(where / "pred_*.jpg")))
    names = {os.path.basename(p) for p in jpgs}
    assert names == {f"pred_{i}.jpg" for i in range(1, NFRAME + 1)}
    np.testing.assert_array_equal(np.load(where / "landmarks.npy"), result.landmarks)
    np.testing.assert_array_equal(np.load(where / "headpose.npy"), result.headpose)
    assert np.load(where / "landmarks.npy").shape == (NFRAME, 73, 2)
    assert f"wrote {NFRAME} frame file(s)" in log
    cap = video.cv2.VideoCapture(str(where / "missing.avi"))
    assert int(cap.get(video.cv2.CAP_PROP_FRAME_COUNT)) == NFRAME
    cap.release()
    first = video.cv2.cvtColor(video.cv2.imread(jpgs[0]), video.cv2.COLOR_BGR2RGB)
    assert np.abs(first.astype(int) - result.frames[0]).mean() < 8  # jpeg-close
    assert not os.path.exists(runs["exact"][2] / "missing_feature_maps.avi")


def test_no_calibrate_and_the_feature_map_video(runs):
    result, log, where = runs["dynamic"]
    (kw,) = runs["dynamic_quantize"]
    assert kw["calibrate_inputs"] is None
    assert result.feature_maps is not None and result.feature_maps.shape == (NFRAME, 64, 64)
    path = where / "missing_feature_maps.avi"
    assert path.exists() and f"wrote video {path}" in log
    cap = video.cv2.VideoCapture(str(path))
    assert int(cap.get(video.cv2.CAP_PROP_FRAME_COUNT)) == NFRAME
    cap.release()
    assert np.isfinite(result.landmarks).all() and result.frames.shape == (NFRAME, 64, 64, 3)


def test_ckpt_flags_with_an_existing_artifact_exit(runs, tmp_path):
    for flag in ("--f2f_ckpt", "--a2f_ckpt", "--a2h_ckpt", "--apc_ckpt"):
        with pytest.raises(SystemExit, match="would shadow the --\\*_ckpt weights") as e:
            demo.main(BASE + ["--results_dir", str(tmp_path), "--artifact", runs["art"],
                              flag, str(tmp_path / "ckpt")])
        assert e.value.code != 0


def test_streaming_notes_the_offline_flags(runs, tmp_path, capsys):
    demo.main(BASE + ["--results_dir", str(tmp_path), "--artifact", runs["art"], "--streaming",
                      "--save_intermediates", "1", "--bucket_seconds", "1", "--fused"])
    log = capsys.readouterr().out
    assert ("note: --save_intermediates, --bucket_seconds, --fused have no effect with "
            "--streaming (offline-path flags)") in log
    assert f"{NFRAME} frames" in log
    assert not glob.glob(str(tmp_path / "Synthetic" / "missing" / "pred_*.jpg"))


def test_save_frames_and_its_fallback_without_cv2(tmp_path, monkeypatch):
    frames = np.random.default_rng(0).integers(0, 256, (3, 16, 16, 3), dtype=np.uint8)
    paths = video.save_frames(frames, str(tmp_path / "a"), "pred_")
    assert [os.path.basename(p) for p in paths] == ["pred_1.jpg", "pred_2.jpg", "pred_3.jpg"]
    grey = video.save_frames(frames[..., 0], str(tmp_path / "g"), "map_")
    assert video.cv2.imread(grey[0]).shape == (16, 16, 3)
    monkeypatch.setattr(video, "cv2", None)
    (path,) = video.save_frames(frames, str(tmp_path / "b"), "pred_")
    assert path.endswith("pred_frames.npy")
    np.testing.assert_array_equal(np.load(path), frames)
