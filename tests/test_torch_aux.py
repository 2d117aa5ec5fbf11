"""The port's auxiliary training modules and decoder variants against the JAX
package's, on the CPU: ops/augment.py, the visualizer's tensor2im,
HTMLReport and image panels, utils/metrics.py (with the one documented
departure, the pose-W1 channel choice), the Audio2Feature WaveNet decoder,
the Audio2Headpose LSTM variant (the plain LSTM on the CPU; K3 on the
card), their weight bridge and the model registry.  The counterpart of the
JAX package's tests/test_utils_aux.py:31-136.

Tolerances: the augmentations equal to JAX's bit for bit (the same numpy
and scipy code on the same seeded draws); the HTML page equal as text; the
numpy metrics equal; the feature-space distances within rtol 1e-4 (float
sums over the VGG19 and the discriminator, which JAX runs padded to a fixed
chunk); the decoders' forwards within 1e-5 of the largest output (1e-4 for
the LSTM variant's batch-statistic training forward, whose BatchNorms
divide by small spreads).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livespeechportraits_torch import models as t_models
from livespeechportraits_torch.models import audio2feature as t_a2f
from livespeechportraits_torch.models import audio2headpose as t_a2h
from livespeechportraits_torch.models import feature2face as t_f2f
from livespeechportraits_torch.models import losses as t_losses
from livespeechportraits_torch.ops import augment as t_aug
from livespeechportraits_torch.utils import convert, metrics as t_metrics
from livespeechportraits_torch.utils import visualizer as t_vis
from livespeechportraits_tpu import models as j_models
from livespeechportraits_tpu.config import (Audio2FeatureConfig, Audio2HeadposeConfig,
                                            Feature2FaceConfig)
from livespeechportraits_tpu.models import audio2feature as j_a2f
from livespeechportraits_tpu.models import audio2headpose as j_a2h
from livespeechportraits_tpu.models import feature2face as j_f2f
from livespeechportraits_tpu.models import losses as j_losses
from livespeechportraits_tpu.models import nn_core as j_nn
from livespeechportraits_tpu.ops import augment as j_aug
from livespeechportraits_tpu.utils import metrics as j_metrics
from livespeechportraits_tpu.utils import visualizer as j_vis
from torch_parity import to_np, torch_config


@pytest.fixture(autouse=True)
def two_pass_bn(monkeypatch):
    monkeypatch.setattr(j_nn, "BN_ONEPASS", False)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# ops/augment.py
# ---------------------------------------------------------------------------

WAV = (0.5 * np.sin(2 * np.pi * 220 * np.arange(16000) / 16000)).astype(np.float32)
NOISE = np.random.default_rng(9).normal(0, 0.1, 8000).astype(np.float32)
AUGMENTS = {
    "inject_gaussian_noise": lambda m, rng: m.inject_gaussian_noise(WAV, 0.01, rng),
    "add_gauss_noise": lambda m, rng: m.add_gauss_noise(WAV, 0.03, rng=rng),
    "speed_change_fast": lambda m, rng: m.speed_change(WAV, rate=1.25)[0],
    "speed_change_drawn": lambda m, rng: np.concatenate(
        [m.speed_change(WAV, rng=rng)[0], [m.speed_change(WAV[:4000], rng=rng)[1]]]),
    "pitch_shift": lambda m, rng: m.pitch_shift(WAV, 16000, n_steps=4.0),
    "pitch_shift_drawn": lambda m, rng: m.pitch_shift(WAV, 16000, rng=rng),
    "time_mask": lambda m, rng: m.time_mask(WAV, 512, rng),
    "random_gain": lambda m, rng: m.random_gain(WAV, rng=rng),
    "background_short_noise": lambda m, rng: m.add_background_noise(WAV, [NOISE], rng=rng),
    "background_long_noise": lambda m, rng: m.add_background_noise(
        WAV[:4000], [NOISE], min_snr=5, max_snr=5, rng=rng),
    "noise_augment": lambda m, rng: np.concatenate(
        [m.noise_augment(WAV, [NOISE], rng=rng) for _ in range(4)]),
}


@pytest.mark.parametrize("name", list(AUGMENTS))
def test_augmentations_equal_jax(name):
    got = AUGMENTS[name](t_aug, np.random.default_rng(0))
    want = AUGMENTS[name](j_aug, np.random.default_rng(0))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_augmentations_shapes_ranges_and_snr():
    """JAX's own checks (tests/test_utils_aux.py:31-77) on the port."""
    rng = np.random.default_rng(0)
    fast, _ = t_aug.speed_change(WAV, rate=1.25)
    assert abs(len(fast) - int(round(len(WAV) / 1.25))) <= 2
    shifted = t_aug.pitch_shift(WAV, 16000, n_steps=4.0)
    f_orig, f_new = (np.abs(np.fft.rfft(w)).argmax() for w in (WAV, shifted))
    assert abs(f_new - f_orig * 2 ** (4 / 12)) / (f_orig * 2 ** (4 / 12)) < 0.1
    assert np.abs(t_aug.add_gauss_noise(WAV, 0.03, rng=rng)).max() <= 1.0
    wav = (0.5 * np.sin(2 * np.pi * 100 * np.arange(32000) / 16000)).astype(np.float32)
    noise = np.random.default_rng(1).normal(0, 1.0, 32000).astype(np.float32)
    mixed = t_aug.add_background_noise(wav, [noise], min_snr=10, max_snr=10,
                                       rng=np.random.default_rng(1))
    snr = 10 * np.log10(np.mean(wav ** 2) / np.mean((mixed - wav) ** 2))
    assert 8.0 < snr < 12.0


# ---------------------------------------------------------------------------
# the visualizer: tensor2im, HTMLReport, the epoch panels, save_images
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(4, 4, 3), (3, 4, 4), (4, 4), (4, 4, 1)],
                         ids=["hwc", "chw", "hw", "hw1"])
def test_tensor2im_equals_jax(shape):
    img = np.random.default_rng(2).uniform(-1.2, 1.2, shape).astype(np.float32)
    np.testing.assert_array_equal(t_vis.tensor2im(img), j_vis.tensor2im(img))


def test_html_report_and_panels_equal_jax(tmp_path):
    for mod, d in ((t_vis, "t"), (j_vis, "j")):
        rep = mod.HTMLReport(str(tmp_path / d / "web"), "title")
        rep.add_header("epoch [1]")
        rep.add_images(["a.jpg", "b.jpg"], ["a", "b"], ["a.jpg", "b.jpg"], width=256)
        rep.save()
        vis = mod.Visualizer(str(tmp_path / d), "exp")
        ramp = np.linspace(-0.8, 0.8, 16, dtype=np.float32)  # smooth: both JPEGs near exact
        img = np.stack([ramp[:, None] + 0 * ramp, 0 * ramp[:, None] + ramp,
                        0.5 * (ramp[:, None] + ramp)], axis=-1)
        for epoch in (1, 2):
            vis.display_current_results({"synthesized": img, "target": -img}, epoch, 10)
        vis.save_images(str(tmp_path / d / "dump"), {"pred": img}, "7")
    page = (tmp_path / "t" / "web" / "index.html").read_text()
    assert page == (tmp_path / "j" / "web" / "index.html").read_text()
    page = (tmp_path / "t" / "exp" / "web" / "index.html").read_text()
    assert page == (tmp_path / "j" / "exp" / "web" / "index.html").read_text()
    assert page.index("epoch [2]") < page.index("epoch [1]")  # newest first
    from PIL import Image

    for name in ("epoch001_synthesized.jpg", "epoch002_target.jpg"):
        ours = np.asarray(Image.open(tmp_path / "t" / "exp" / "web" / "images" / name))
        theirs = np.asarray(Image.open(tmp_path / "j" / "exp" / "web" / "images" / name))
        assert ours.shape == theirs.shape == (16, 16, 3)
        assert np.abs(ours.astype(int) - theirs.astype(int)).mean() < 3  # two JPEG encoders
    assert os.path.exists(tmp_path / "t" / "dump" / "pred_7.jpg")


# ---------------------------------------------------------------------------
# utils/metrics.py
# ---------------------------------------------------------------------------


def _motion(seed: int, T: int = 50):
    rng = np.random.default_rng(seed)
    lm = rng.uniform(0, 512, (T, 73, 2))
    pts = rng.normal(0, 0.1, (T, 73, 3))
    t = np.arange(T)[:, None]
    pose = np.concatenate([np.sin(t / (5 + seed) + np.arange(3)) * 3.0,
                           np.zeros((T, 3))], axis=1) + rng.normal(0, 0.01, (T, 6))
    pose[:, 3:] = 0.0  # a subject whose translation does not move
    return lm, pts, pose


def test_numpy_metrics_equal_jax():
    lm_a, pts_a, pose_a = _motion(0)
    lm_b, pts_b, pose_b = _motion(1, T=45)
    assert t_metrics.landmark_l2(lm_a, lm_b) == j_metrics.landmark_l2(lm_a, lm_b)
    frames = np.random.default_rng(4).integers(0, 256, (2, 3, 32, 32, 3), dtype=np.uint8)
    assert t_metrics.psnr(*frames) == j_metrics.psnr(*frames)
    assert t_metrics.psnr(frames[0], frames[0]) == float("inf")
    assert (t_metrics.canonical_mouth_metrics(pts_a, pts_b)
            == j_metrics.canonical_mouth_metrics(pts_a, pts_b))
    # every channel that moves is in one block, or each block has one that
    # moves: the per-block choice is JAX's choice
    assert t_metrics.pose_realism_w1(pose_a, pose_b) == j_metrics.pose_realism_w1(pose_a, pose_b)
    still = np.zeros_like(pose_a)
    assert t_metrics.pose_realism_w1(pose_a, still) == j_metrics.pose_realism_w1(pose_a, still)


def test_pose_w1_scores_a_slow_translation_jax_drops():
    """The departure (ADVICE.md, JAX metrics.py:156): rotation in degrees
    moving with spread ~1, translation moving in earnest with spread ~1e-4
    of its own units.  JAX's cross-channel threshold drops the translation,
    so a sampler whose translation velocity is ten times too wide scores as
    well as a faithful one; the port thresholds each block against its own
    and scores it."""
    rng = np.random.default_rng(5)
    T = 400
    gt = np.concatenate([np.cumsum(rng.normal(0, 1.0, (T, 3)), 0),
                         np.cumsum(rng.normal(0, 1e-4, (T, 3)), 0)], axis=1)
    faithful = np.concatenate([np.cumsum(rng.normal(0, 1.0, (T, 3)), 0),
                               np.cumsum(rng.normal(0, 1e-4, (T, 3)), 0)], axis=1)
    wide = faithful.copy()
    wide[:, 3:] = np.cumsum(rng.normal(0, 1e-3, (T, 3)), 0)
    stds = np.diff(gt, axis=0).std(axis=0)
    assert not (stds[3:] > 1e-3 * stds.max()).any()  # JAX drops all three
    assert t_metrics.live_channels(stds).all()  # the port keeps all six
    j_f, j_w = (j_metrics.pose_realism_w1(p, gt)["pose_vel_w1"] for p in (faithful, wide))
    t_f, t_w = (t_metrics.pose_realism_w1(p, gt)["pose_vel_w1"] for p in (faithful, wide))
    assert abs(j_w - j_f) < 0.05  # JAX cannot tell them apart
    assert t_w > t_f + 1.0  # the port can
    pv, gv = np.diff(wide, axis=0), np.diff(gt, axis=0)
    want = np.mean([t_metrics._w1(pv[:, c], gv[:, c]) / gv[:, c].std() for c in range(6)])
    assert t_w == round(float(want), 4)


@pytest.fixture(scope="module")
def vgg_pair(tmp_path_factory):
    params = j_losses.init_vgg19(0)
    convs = [c for c in params["convs"] if not isinstance(c, str)]
    path = tmp_path_factory.mktemp("vgg") / "vgg.npz"
    np.savez(path, **{f"conv{i}_{k}": (np.asarray(c["w"]).transpose(3, 2, 0, 1) if k == "w"
                                        else np.asarray(c["b"]))
                      for i, c in enumerate(convs) for k in ("w", "b")})
    return params, t_losses.load_vgg19_npz(str(path))


D_CFG = Feature2FaceConfig(ngf=8, n_downsample=5, load_size=32, ndf=8, n_layers_D=2, num_D=2)


def test_feature_distances_and_the_report_match_jax(vgg_pair):
    """10 frames in chunks of 8 (JAX pads the last chunk of 2)."""
    params, vgg = vgg_pair
    rng = np.random.default_rng(6)
    a, b = rng.integers(0, 256, (2, 10, 32, 32, 3), dtype=np.uint8)
    d_j = j_f2f.init_discriminator(jax.random.PRNGKey(3), D_CFG)
    d = t_f2f.Feature2FaceD(torch_config(D_CFG))
    d.load_state_dict(convert.params_from_jax(to_np(d_j)), strict=True)
    d.eval()
    np.testing.assert_allclose(t_metrics.perceptual_distance(vgg, a, b),
                               j_metrics.perceptual_distance(params, a, b), rtol=1e-4)
    cond = rng.uniform(-1, 1, (10, 32, 32, 13)).astype(np.float32)
    for c in (None, cond):
        np.testing.assert_allclose(t_metrics.d_feature_distance(d, a, b, cond=c),
                                   j_metrics.d_feature_distance(d_j, a, b, cond=c), rtol=1e-4)
    lm, pts, pose = _motion(7, T=10)
    kw = dict(landmarks_a=lm, landmarks_b=lm[::-1], pts3d_a=pts, pts3d_b=pts[::-1],
              pose_a=pose, pose_b=pose[::-1])
    ours = t_metrics.fidelity_report(a, b, vgg=vgg, d=d, device="cpu", **kw)
    theirs = j_metrics.fidelity_report(a, b, vgg_params=params, d_params=d_j, **kw)
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-3, atol=1e-6, err_msg=k)
    rnd = t_metrics.fidelity_report(a, b, device="cpu")
    assert rnd["perceptual_note"].startswith("random-VGG") and rnd["frames_compared"] == 10


# ---------------------------------------------------------------------------
# the decoder variants, their weights and the registry
# ---------------------------------------------------------------------------

A2F_CFG = Audio2FeatureConfig(apc_hidden_size=16)
A2H_CFG = Audio2HeadposeConfig(apc_hidden_size=16)


def _rel_close(got: torch.Tensor, want, tol: float, what: str = "") -> None:
    want = np.asarray(want)
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= tol * float(np.abs(want).max()), (what, err)


@pytest.mark.parametrize("output_length", [None, 7])
def test_a2f_wavenet_decoder_matches_jax(output_length):
    params = j_a2f.init_audio2feature_wavenet(jax.random.PRNGKey(1), A2F_CFG)
    model = t_a2f.Audio2FeatureWaveNet(torch_config(A2F_CFG))
    model.load_state_dict(convert.params_from_jax(to_np(params)), strict=True)
    x = np.random.default_rng(1).normal(size=(2, 40, 16)).astype(np.float32)
    want = j_a2f.apply_audio2feature_wavenet(params, A2F_CFG, jnp.asarray(x),
                                             output_length=output_length)
    with torch.no_grad():
        got = t_a2f.apply_audio2feature_wavenet(model, torch.from_numpy(x),
                                                output_length=output_length)
    assert got.shape == want.shape == (2, output_length or 40, A2F_CFG.output_dim)
    _rel_close(got, want, 1e-5)
    tree = convert.params_to_jax(model)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(to_np(params))):
        np.testing.assert_array_equal(a, b)


def _a2h_lstm_pair(seed: int = 2):
    params = j_a2h.init_audio2headpose_lstm(jax.random.PRNGKey(seed), A2H_CFG)
    # nonzero BatchNorm statistics, so eval mode is not the identity
    rng = np.random.default_rng(seed)
    for bn in ("down_bn", "fc1_bn", "fc2_bn"):
        n = params[bn]["mean"].shape[0]
        params[bn] = dict(params[bn], mean=jnp.asarray(rng.normal(0, 0.1, n), jnp.float32),
                          var=jnp.asarray(rng.uniform(0.5, 1.5, n), jnp.float32))
    model = t_a2h.Audio2HeadposeLSTM(torch_config(A2H_CFG))
    model.load_state_dict(convert.audio2headpose_lstm_from_jax(to_np(params)), strict=True)
    return params, model


def test_a2h_lstm_variant_matches_jax():
    params, model = _a2h_lstm_pair()
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 20, 32)).astype(np.float32)
    want, _ = j_a2h.apply_audio2headpose_lstm(params, jnp.asarray(x), training=False)
    with torch.no_grad():
        got = t_a2h.apply_audio2headpose_lstm(model, torch.from_numpy(x))
        batched = t_a2h.apply_audio2headpose_lstm(model, torch.from_numpy(x), batched=True)
    assert got.shape == want.shape == (3, 20, A2H_CFG.gmm_output_dim)
    _rel_close(got, want, 1e-5, "plain")
    _rel_close(batched, want, 1e-5, "batched")
    # the training forward: batch statistics, running stats moved as JAX's
    want_t, new = j_a2h.apply_audio2headpose_lstm(params, jnp.asarray(x), training=True)
    got_t = t_a2h.apply_audio2headpose_lstm(model, torch.from_numpy(x), training=True,
                                            batched=True)
    _rel_close(got_t, want_t, 1e-4, "training")
    moved = convert.audio2headpose_lstm_from_jax(to_np(new))
    for k, v in model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), moved[k].numpy(), atol=1e-5, err_msg=k)
    # generate_sequence_lstm at sigma 0 with one component is the mean (the
    # running stats the training forward moved on both sides)
    feats = rng.normal(size=(41, 16)).astype(np.float32)  # an odd row drops
    want_s = j_a2h.generate_sequence_lstm(new, A2H_CFG, jnp.asarray(feats),
                                          jax.random.PRNGKey(0), sigma_scale=0.0)
    with torch.no_grad():
        model.eval()
        got_s = t_a2h.generate_sequence_lstm(model, torch.from_numpy(feats), sigma_scale=0.0)
    assert got_s.shape == want_s.shape == (20, A2H_CFG.ndim)
    _rel_close(got_s, want_s, 1e-5, "sequence")
    tree = convert.params_to_jax(model)
    assert tree.keys() == params.keys()


def test_registry_names_jax_families_and_builds_them():
    assert set(j_models.REGISTRY) <= set(t_models.REGISTRY)
    assert t_models.create_model("Audio2Headpose_LSTM").build is t_a2h.Audio2HeadposeLSTM
    with pytest.raises(KeyError, match="available"):
        t_models.create_model("nope")
    cfg = torch_config(A2H_CFG)
    for name, c in (("audio2headpose_lstm", cfg), ("audio2feature_wavenet",
                                                   torch_config(A2F_CFG))):
        m = t_models.create_model(name).build(c)
        m.reset_parameters(torch.Generator().manual_seed(0))
        assert sum(p.numel() for p in m.parameters()) > 0
    with pytest.raises(NotImplementedError, match="Audio2HeadposeLSTM"):
        t_a2h.Audio2Headpose(torch_config(Audio2HeadposeConfig(decoder="lstm")))
    with pytest.raises(NotImplementedError, match="Audio2FeatureWaveNet"):
        t_a2f.Audio2Feature(torch_config(Audio2FeatureConfig(decoder="wavenet")))


# ---------------------------------------------------------------------------
# utils/profiling.py, flow_viz.py, image_pool.py and get_data.py (JAX
# tests/test_utils_aux.py:97-118, 200-247)
# ---------------------------------------------------------------------------


def test_stopwatch_and_trace_on_the_cpu(tmp_path):
    from livespeechportraits_torch.utils import profiling
    from livespeechportraits_tpu.utils import profiling as j_profiling

    sw, jsw = profiling.Stopwatch(), j_profiling.Stopwatch()
    assert sw.report() == jsw.report() == "no stages recorded"
    for w in (sw, jsw):
        for name in ("a", "b", "a"):
            with w.stage(name):
                pass
    assert list(sw.ms) == list(jsw.ms) == ["a", "b"]
    assert sw.report().endswith("ms") and "total" in sw.report()
    with profiling.trace(str(tmp_path / "tr")) as prof:
        torch.ones(4) @ torch.ones(4)
    assert any(e.name == "aten::dot" or e.name == "aten::matmul" for e in prof.events())
    assert (tmp_path / "tr" / "trace.json").exists()
    # no device events on the CPU: busy 0, and the coverage says the table is partial
    cov = profiling.coverage(list(prof.events()), 1.0)
    assert cov["device_records"] == 0 and not cov["trace_whole"] and "partial" in cov["note"]


def test_link_probe_refuses_a_cpu_device():
    from livespeechportraits_torch.utils import profiling

    with pytest.raises(ValueError, match="no CPU stand-in"):
        profiling.link_probe("cpu")
    with pytest.raises(ValueError):
        profiling.traced(lambda: None, "cpu")


def test_flow_viz_matches_jax():
    from livespeechportraits_torch.utils import flow_viz
    from livespeechportraits_tpu.utils import flow_viz as j_flow_viz

    np.testing.assert_array_equal(flow_viz.make_colorwheel(), j_flow_viz.make_colorwheel())
    flow = np.random.default_rng(0).normal(size=(12, 10, 2)).astype(np.float32)
    for bgr in (False, True):
        np.testing.assert_array_equal(flow_viz.flow_to_image(flow, convert_to_bgr=bgr),
                                      j_flow_viz.flow_to_image(flow, convert_to_bgr=bgr))
    np.testing.assert_array_equal(flow_viz.flow_to_image(flow, clip_flow=0.5),
                                  j_flow_viz.flow_to_image(flow, clip_flow=0.5))
    np.testing.assert_array_equal(flow_viz.tensor2flow(flow.transpose(2, 0, 1)[None]),
                                  j_flow_viz.tensor2flow(flow.transpose(2, 0, 1)[None]))
    with pytest.raises(ValueError):
        flow_viz.flow_to_image(flow[..., :1])


def test_image_pool_matches_jax():
    from livespeechportraits_torch.utils.image_pool import ImagePool
    from livespeechportraits_tpu.utils.image_pool import ImagePool as JImagePool

    rng = np.random.default_rng(1)
    pool, jpool = ImagePool(3, np.random.default_rng(7)), JImagePool(3, np.random.default_rng(7))
    for _ in range(5):
        batch = rng.normal(size=(2, 4, 4, 3)).astype(np.float32)
        np.testing.assert_array_equal(pool.query(batch), jpool.query(batch))
    assert pool.num_imgs == jpool.num_imgs == 3
    passthrough = rng.normal(size=(2, 4, 4, 3))
    np.testing.assert_array_equal(ImagePool(0).query(passthrough), passthrough)


def test_get_data_offline(tmp_path, monkeypatch):
    """Index parsing, the non-interactive choice, the download, the
    checksum and the extraction, with urlopen mocked: nothing downloads."""
    import hashlib
    import io
    import tarfile
    import urllib.request
    import zipfile

    from livespeechportraits_torch.utils import get_data

    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        z.writestr("mini/a.txt", "hello")
    payload = buf.getvalue()
    tbuf = io.BytesIO()
    with tarfile.open(fileobj=tbuf, mode="w:gz") as t:
        info = tarfile.TarInfo("big/b.txt")
        info.size = 3
        t.addfile(info, io.BytesIO(b"abc"))
    tar_payload = tbuf.getvalue()
    html = ('<html><a href="x/mini.zip">mini.zip</a><a href="notes.txt">notes.txt</a>'
            '<a href="y/big.tar.gz">big.tar.gz</a></html>')
    urls = []

    class _Resp(io.BytesIO):
        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    def fake_urlopen(url):
        urls.append(url)
        if url.endswith("mini.zip"):
            return _Resp(payload)
        if url.endswith("big.tar.gz"):
            return _Resp(tar_payload)
        return _Resp(html.encode())

    monkeypatch.setattr(urllib.request, "urlopen", fake_urlopen)
    assert get_data.parse_archive_options(html) == ["mini.zip", "big.tar.gz"]
    gd = get_data.GetData(technique="pix2pix", verbose=False)
    assert gd.options() == ["mini.zip", "big.tar.gz"]
    out = gd.get(str(tmp_path / "ds"), choice=0, sha256=hashlib.sha256(payload).hexdigest())
    assert out == str(tmp_path / "ds" / "mini")
    assert (tmp_path / "ds" / "mini" / "a.txt").read_text() == "hello"
    assert not (tmp_path / "ds" / "mini.zip").exists()
    assert gd.get(str(tmp_path / "ds3"), dataset="big.tar.gz") == str(tmp_path / "ds3" / "big")
    assert (tmp_path / "ds3" / "big" / "b.txt").read_text() == "abc"
    with pytest.raises(ValueError, match="checksum mismatch"):
        gd.get(str(tmp_path / "ds2"), dataset="mini.zip", sha256="0" * 64)
    assert all(u.startswith(get_data.URL_DICT["pix2pix"].rstrip("/")) for u in urls)
