"""The port's tools/e2e_subject.py on the CPU: the clips phase at the sizes of
the JAX package's tests/test_e2e_subject.py:144 (600 + 60 frames, two
train clips), cut to 32 px frames (a 512 px face store takes minutes on the
CPU); its clip reuse, which checks the seed and the face flag where JAX's
checks the frame count alone (ADVICE.md); then every phase of the tool,
clips to rescore, at a tiny length and 32 px, writing JAX's artifacts and
the keys of JAX's e2e_metrics.json, and the rescore phase against JAX's
phase_rescore on the same artifacts.

Tolerances: the clips' ground truth equal to the JAX package's
synth_subject draw for draw (float32 equality); the rescored rows equal to
JAX's after both round them (the same numpy metrics; the synthetic
subject's translation does not move, so the pose rows' per-block channel
choice picks JAX's channels).
"""

from __future__ import annotations

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from livespeechportraits_torch.config import APCConfig, Audio2HeadposeConfig, WaveNetConfig
from livespeechportraits_torch.models import apc as apc_model
from livespeechportraits_torch.tools import e2e_subject as e2e
from livespeechportraits_torch.train import data_io, datasets, trainer
from livespeechportraits_tpu.pipeline import synth_subject as j_synth

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread (see test_torch_trainer.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_tool():
    """The JAX package's tools/e2e_subject.py, imported as its own test does."""
    if TOOLS not in sys.path:
        sys.path.insert(0, TOOLS)
    import e2e_subject as j_e2e

    return j_e2e


def test_clips_phase_authors_a_corpus_jax_draws(tmp_path):
    root = str(tmp_path / "MC")
    os.makedirs(root)
    e2e.phase_clips(root, train_frames=600, val_frames=60, n_clips=2, image_size=32,
                    device="cpu")
    for name in ("clip1", "clip2", "val1"):
        assert os.path.exists(os.path.join(root, name, name + ".wav")), name
    assert os.path.exists(os.path.join(root, "clip1", "clip1.h5"))
    assert not os.path.exists(os.path.join(root, "clip2", "clip2.h5"))  # motion only
    g1 = dict(np.load(os.path.join(root, "gt_clip1.npz")))
    g2 = dict(np.load(os.path.join(root, "gt_clip2.npz")))
    assert not np.allclose(g1["rot"], g2["rot"]) and not np.allclose(g1["env"], g2["env"])
    # seed + 7 i a train clip, seed + 100 the held-out one: JAX's draws
    for gt, n, s in ((g1, 600, 0), (g2, 600, 7),
                     (dict(np.load(os.path.join(root, "gt_val1.npz"))), 60, 100)):
        assert int(gt["seed"]) == s
        env = j_synth.envelope(n, s)
        np.testing.assert_array_equal(gt["env"], env)
        np.testing.assert_array_equal(gt["pts3d"], j_synth.subject_pts3d(n, s, env))
        rot, trans = j_synth.subject_headpose(n, s, env)
        np.testing.assert_array_equal(gt["rot"], rot)
        np.testing.assert_array_equal(gt["trans"], trans)
        np.testing.assert_array_equal(gt["wav"], j_synth.make_audio(env, s))
    # the samplers take the two-clip corpus (JAX's test_multi_clip_corpus_phases)
    enc = trainer._init(apc_model.APCEncoder(APCConfig()), 0).eval().requires_grad_(False)
    np.save(os.path.join(root, "mean_pts3d.npy"), g1["pts3d"].mean(axis=0).astype(np.float32))
    clips = [data_io.prepare_clip(os.path.join(root, n), n, enc, APCConfig())
             for n in e2e.train_clip_names(2)]
    wn = WaveNetConfig(residual_layers=2, residual_blocks=1, dilation_channels=8,
                       residual_channels=8, skip_channels=16, cond_channels=512)
    cfg = Audio2HeadposeConfig(wavenet=wn, frame_future=5)

    def sampler(c):
        return datasets.AudioVisualSampler(c, task="audio2headpose", target_length=24,
                                           receptive_field=wn.receptive_field,
                                           frame_future=cfg.frame_future, start_point=28)

    s = sampler(clips)
    assert list(s.batches(batch_size=4, rng=np.random.default_rng(0)))
    assert len(s) == 2 * len(sampler(clips[:1]))


def test_clips_are_reused_only_with_their_seed_and_face_flag(tmp_path, capsys):
    """The departure from JAX's skip (ADVICE.md, tools/e2e_subject.py:70):
    JAX reuses a stored clip of the right length whatever seed made it; the
    port re-authors it, and reuses a clip only when the seed and the face
    flag match."""
    root = str(tmp_path / "R")
    os.makedirs(root)
    e2e.phase_clips(root, 80, 60, seed=0, image_size=32, device="cpu")
    stamp = os.path.getmtime(os.path.join(root, "gt_clip1.npz"))
    e2e.phase_clips(root, 80, 60, seed=0, image_size=32, device="cpu")
    assert "clip1: exists" in capsys.readouterr().out
    assert os.path.getmtime(os.path.join(root, "gt_clip1.npz")) == stamp
    # JAX's tool on the same root and another seed keeps the seed-0 clips
    j_e2e = _jax_tool()
    j_e2e.phase_clips(root, 80, 60, seed=3)
    assert "clip1: exists (80 frames), skipped" in capsys.readouterr().out
    assert int(np.load(os.path.join(root, "gt_clip1.npz"))["seed"]) == 0
    # the port's tool re-authors them with the new seed's dynamics
    e2e.phase_clips(root, 80, 60, seed=3, image_size=32, device="cpu")
    gt = dict(np.load(os.path.join(root, "gt_clip1.npz")))
    assert int(gt["seed"]) == 3
    np.testing.assert_array_equal(gt["env"], j_synth.envelope(80, 3))
    # a ground truth without the seed (JAX's format) is not trusted either
    np.savez(os.path.join(root, "gt_val1.npz"),
             **{k: v for k, v in np.load(os.path.join(root, "gt_val1.npz")).items()
                if k not in ("seed", "with_face")})
    capsys.readouterr()
    e2e.phase_clips(root, 80, 60, seed=3, image_size=32, device="cpu")
    out = capsys.readouterr().out
    assert "val1: 60 frames written" in out and "clip1: exists" in out


# every phase of the tool at a tiny length: 600 train frames (the head-pose
# windows need the clip to reach 300 + 263 frames), 120 held out, 32 px,
# one epoch a stage, short windows, the renderer on every 8th frame
TINY = ("--device cpu --image_size 32 --train_frames 600 --val_frames 120 --apc_window 60 "
        "--a2f_seq_len 32 --a2h_target_length 8 --tail_margin 60 --apc_epochs 1 "
        "--a2f_epochs 1 --a2h_epochs 1 --f2f_epochs 1 --f2f_frame_jump 8 --eval_seconds 1 "
        "--phases clips,apc,pack,a2f,a2h,f2f,eval,rescore")


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("e2e") / "E2ETiny")
    out = e2e.main(["--root", root] + TINY.split())
    return root, out


def _jax_metric_keys() -> tuple:
    """The keys of JAX's e2e_metrics.json: its fidelity_report's with every
    input, and the tool's own rows (tools/e2e_subject.py:253-380)."""
    from livespeechportraits_tpu.models import feature2face as j_f2f
    from livespeechportraits_tpu.config import Feature2FaceConfig
    from livespeechportraits_tpu.models import losses as j_losses
    from livespeechportraits_tpu.utils import metrics as j_metrics
    import jax

    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    lm, pts, pose = rng.normal(size=(4, 73, 2)), rng.normal(size=(4, 73, 3)), rng.normal(
        size=(4, 6))
    cfg = Feature2FaceConfig(ngf=8, n_downsample=5, load_size=32, ndf=8, n_layers_D=2,
                             num_D=2)
    rows = j_metrics.fidelity_report(frames, frames, lm, lm, j_losses.init_vgg19(), "",
                                     pts, pts, pose, pose,
                                     j_f2f.init_discriminator(jax.random.PRNGKey(0), cfg))
    arm = set(rows) | {"perceptual_note", "mouth_l2_px", "mouth_open_corr", "rot_x_mae_deg"}
    top = {"trained", "teacher_forced_psnr_db", "random_init", "video", "n_frames_scored"}
    return top, arm


def test_every_phase_runs_and_writes_jax_artifacts_and_keys(tiny_run):
    root, out = tiny_run
    assert set(out["walls"]) == set(e2e.PHASES)
    with open(os.path.join(root, "e2e_metrics.json")) as f:
        metrics = json.load(f)
    top, arm = _jax_metric_keys()
    assert set(metrics) == top
    for k in ("trained", "random_init"):
        assert set(metrics[k]) == arm, k
        assert all(np.isfinite(v) for v in metrics[k].values() if isinstance(v, float))
    assert metrics["n_frames_scored"] == 45  # 1 s of 60 fps less the 15-frame lookahead
    for stage in ("apc", "a2f", "a2h", "f2f"):
        assert os.listdir(os.path.join(root, "ckpt", stage, "ckpt")), stage
    assert os.path.exists(os.path.join(root, "ckpt", "f2f", "web", "index.html"))
    for f in ("E2ETiny.yaml", "mean_pts3d.npy", "APC_feature_base.npy", "eval_outputs.npz",
              "e2e_heldout.avi", os.path.join("clip1", "candidates", "normalized_full_0.jpg")):
        assert os.path.exists(os.path.join(root, f)), f
    # the GAN trained with the fused step: JAX's fused metric keys
    header = open(os.path.join(root, "ckpt", "f2f", "scalars.csv")).readline().strip()
    assert header.split(",")[1:] == ["loss_G_GAN", "L1", "VGG", "Style", "loss_G_FM", "loss_G",
                                     "D_real", "D_fake", "loss_D"]


def test_rescore_matches_jax_on_the_same_artifacts(tiny_run, tmp_path):
    root, _ = tiny_run
    copy = str(tmp_path / "E2ETiny")
    shutil.copytree(root, copy)
    ours = e2e.phase_rescore(root)
    theirs = _jax_tool().phase_rescore(copy)
    assert ours == theirs
