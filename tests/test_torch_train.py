"""The port's training pieces against the JAX package's, on the CPU at test
widths: training-mode BatchNorm, the discriminator, the losses, one batch's
losses and gradients through each trainer's step, Adam, the schedules and
the samplers.

Weights cross through utils/convert.py; inputs are made with numpy from a
seed; everything runs in f32 on both sides.  JAX's training BatchNorm is
run with its one-pass variance off (``BN_ONEPASS = False``, set here, on the
test side): the port computes the two-pass form.

Tolerances: forwards within 1e-5 (1e-4 for the U-Net's 32^2 output and the
VGG taps, whose sums run long); a step's gradients per tensor within 1e-4
of the JAX tensor's norm, and a tensor whose true gradient is zero (a
conv's or a dense layer's bias in front of a training BatchNorm: both sides
hold rounding noise) within 1e-5 of the largest gradient norm of its
model; Adam's parameters within 1e-6; the schedules exactly; the samplers'
batches bit for bit.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from livespeechportraits_torch.models import apc as t_apc
from livespeechportraits_torch.models import audio2feature as t_a2f
from livespeechportraits_torch.models import audio2headpose as t_a2h
from livespeechportraits_torch.models import feature2face as t_f2f
from livespeechportraits_torch.models import losses as t_losses
from livespeechportraits_torch.models import nn_core as t_nn
from livespeechportraits_torch.train import datasets as t_ds
from livespeechportraits_torch.train import schedulers as t_sched
from livespeechportraits_torch.train import state as t_state
from livespeechportraits_torch.train import steps as t_steps
from livespeechportraits_torch.utils.convert import params_from_jax
from livespeechportraits_tpu.config import (APCConfig, Audio2FeatureConfig,
                                            Audio2HeadposeConfig, Feature2FaceConfig,
                                            WaveNetConfig)
from livespeechportraits_tpu.models import apc as j_apc
from livespeechportraits_tpu.models import audio2feature as j_a2f
from livespeechportraits_tpu.models import audio2headpose as j_a2h
from livespeechportraits_tpu.models import feature2face as j_f2f
from livespeechportraits_tpu.models import losses as j_losses
from livespeechportraits_tpu.models import nn_core as j_nn
from livespeechportraits_tpu.train import datasets as j_ds
from livespeechportraits_tpu.train import schedulers as j_sched
from livespeechportraits_tpu.train import steps as j_steps
from torch_parity import to_np, torch_config


@pytest.fixture(autouse=True)
def two_pass_bn(monkeypatch):
    monkeypatch.setattr(j_nn, "BN_ONEPASS", False)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread, so the sums run in one order whatever the
    machine (see test_torch_trainer.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _load(model: torch.nn.Module, tree) -> torch.nn.Module:
    model.load_state_dict(params_from_jax(to_np(tree)), strict=True)
    return model


def _close(got, want, atol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=atol, err_msg=what)


F2F_CFG = Feature2FaceConfig(ngf=8, n_downsample=5, load_size=32, ndf=8, n_layers_D=2,
                             num_D=2, precision="float32")


# ---------------------------------------------------------------------------
# training-mode BatchNorm, the generator and the discriminator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(40, 6), (3, 5, 7, 6)], ids=["rows", "nhwc"])
def test_batchnorm_training_matches_jax(shape):
    rng = np.random.default_rng(0)
    x = rng.normal(2.0, 3.0, shape).astype(np.float32)
    p = {"scale": rng.normal(1, 0.1, 6).astype(np.float32),
         "bias": rng.normal(0, 0.1, 6).astype(np.float32),
         "mean": rng.normal(0, 0.1, 6).astype(np.float32),
         "var": rng.uniform(0.5, 2, 6).astype(np.float32)}
    y_j, new_p = j_nn.batchnorm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                                training=True)
    bn = torch.nn.BatchNorm1d(6) if len(shape) == 2 else torch.nn.BatchNorm2d(6)
    with torch.no_grad():
        bn.weight.copy_(_t(p["scale"]))
        bn.bias.copy_(_t(p["bias"]))
        bn.running_mean.copy_(_t(p["mean"]))
        bn.running_var.copy_(_t(p["var"]))
    xt = _t(x) if len(shape) == 2 else _t(x).permute(0, 3, 1, 2)
    y = t_nn.batchnorm(xt, bn, training=True)
    if len(shape) == 4:
        y = y.permute(0, 2, 3, 1)
    _close(y, y_j, 1e-5)
    _close(bn.running_mean, new_p["mean"], 1e-6)
    _close(bn.running_var, new_p["var"], 1e-6)
    # update_stats=False normalises the same and leaves the stats
    before = bn.running_var.clone()
    t_nn.batchnorm(xt, bn, training=True, update_stats=False)
    assert torch.equal(bn.running_var, before)


def _bn_stats(sd: dict) -> dict:
    return {k: v for k, v in sd.items() if k.endswith(("running_mean", "running_var"))}


@pytest.mark.parametrize("size", ["normal", "small"])
def test_generator_training_forward_matches_jax(size):
    cfg = dataclasses.replace(F2F_CFG, size=size)
    g = j_f2f.init_generator(jax.random.PRNGKey(0), cfg)
    x = np.random.default_rng(1).normal(size=(2, 32, 32, cfg.input_nc)).astype(np.float32)
    y_j, aux = j_f2f.apply_generator(g, jnp.asarray(x), training=True)
    model = _load(t_f2f.Feature2FaceG(torch_config(cfg)), g)
    with torch.no_grad():
        y = t_f2f.apply_generator(model, _t(x), training=True)
    _close(y, y_j, 1e-4)
    want = _bn_stats(params_from_jax(to_np({"net": aux["net"], "size": size})))
    got = _bn_stats(model.state_dict())
    assert got.keys() == want.keys() and got
    for k in want:
        _close(got[k], want[k], 1e-5, k)


@pytest.mark.parametrize("training", [False, True])
def test_discriminator_outputs_and_features_match_jax(training):
    d = j_f2f.init_discriminator(jax.random.PRNGKey(2), F2F_CFG)
    x = np.random.default_rng(3).normal(size=(2, 32, 32, 16)).astype(np.float32)
    feats_j, new_d = j_f2f.apply_discriminator(d, jnp.asarray(x), training=training)
    model = _load(t_f2f.Feature2FaceD(torch_config(F2F_CFG)), d)
    with torch.no_grad():
        feats = t_f2f.apply_discriminator(model, _t(x), training=training)
    assert [len(f) for f in feats] == [len(f) for f in feats_j] == [4, 4]
    for fs, fs_j in zip(feats, feats_j):
        for f, f_j in zip(fs, fs_j):
            assert tuple(f.shape) == f_j.shape
            _close(f, f_j, 1e-5)
    want = _bn_stats(params_from_jax(to_np(new_d)))
    for k, v in _bn_stats(model.state_dict()).items():
        _close(v, want[k], 1e-6, k)


def test_discriminator_state_dict_round_trips_through_jax():
    from livespeechportraits_torch.utils.convert import params_to_jax

    d = j_f2f.init_discriminator(jax.random.PRNGKey(2), F2F_CFG)
    model = _load(t_f2f.Feature2FaceD(torch_config(F2F_CFG)), d)
    back = t_f2f.Feature2FaceD(torch_config(F2F_CFG))
    back.load_state_dict(params_from_jax(params_to_jax(model)), strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(v, back.state_dict()[k]), k


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def _feats(seed: int):
    rng = np.random.default_rng(seed)
    return [[rng.normal(size=(2, s, s, c)).astype(np.float32) for s, c in ((8, 4), (4, 8), (3, 1))]
            for _ in range(2)]


@pytest.mark.parametrize("mode", ["ls", "original", "hinge"])
@pytest.mark.parametrize("real,for_d", [(True, True), (False, True), (True, False)])
def test_gan_loss_matches_jax(mode, real, for_d):
    preds = _feats(0)
    want = j_losses.gan_loss([[jnp.asarray(f) for f in s] for s in preds], real, mode, for_d)
    got = t_losses.gan_loss([[_t(f) for f in s] for s in preds], real, mode, for_d)
    _close(got, want, 1e-5)


def test_feature_matching_and_masked_l1_match_jax():
    fake, real = _feats(1), _feats(2)
    want = j_losses.feature_matching_loss([[jnp.asarray(f) for f in s] for s in fake],
                                          [[jnp.asarray(f) for f in s] for s in real], 2, 2, 10.0)
    got = t_losses.feature_matching_loss([[_t(f) for f in s] for s in fake],
                                         [[_t(f) for f in s] for s in real], 2, 2, 10.0)
    _close(got, want, 1e-5)
    rng = np.random.default_rng(3)
    x, y = rng.normal(size=(2, 2, 8, 8, 3)).astype(np.float32)
    mask = (rng.uniform(size=(2, 8, 8, 1)) > 0.5).astype(np.float32)
    _close(t_losses.masked_l1_loss(_t(x), _t(y), _t(mask)),
           j_losses.masked_l1_loss(jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask)), 1e-6)


def _vgg_pair(tmp_path):
    """JAX's random VGG19 and the port's, loaded through load_vgg19_npz."""
    params = j_losses.init_vgg19(0)
    convs = [c for c in params["convs"] if not isinstance(c, str)]
    path = tmp_path / "vgg.npz"
    np.savez(path, **{f"conv{i}_{k}": (np.asarray(c["w"]).transpose(3, 2, 0, 1) if k == "w"
                                        else np.asarray(c["b"]))
                      for i, c in enumerate(convs) for k in ("w", "b")})
    return params, t_losses.load_vgg19_npz(str(path))


def test_vgg_features_gram_and_style_loss_match_jax(tmp_path):
    params, vgg = _vgg_pair(tmp_path)
    rng = np.random.default_rng(4)
    x, y = np.tanh(rng.normal(size=(2, 2, 32, 32, 3))).astype(np.float32)
    feats_j = j_losses.vgg19_features(params, jnp.asarray(x))
    feats = t_losses.vgg19_features(vgg, _t(x))
    assert len(feats) == 5
    for f, f_j in zip(feats, feats_j):
        scale = float(np.abs(np.asarray(f_j)).max())
        _close(f, f_j, 1e-5 * max(scale, 1.0))
        _close(t_losses.gram_matrix(f), j_losses.gram_matrix(f_j), 1e-5 * max(scale, 1.0) ** 2)
    p_j, s_j = j_losses.vgg_style_loss(params, jnp.asarray(x), jnp.asarray(y))
    p, s = t_losses.vgg_style_loss(vgg, _t(x), _t(y))
    np.testing.assert_allclose(float(p), float(p_j), rtol=1e-5)
    np.testing.assert_allclose(float(s), float(s_j), rtol=1e-4)
    # random init at the kaiming scale
    rand = t_losses.init_vgg19(0)
    w = rand.convs[4].weight
    assert abs(float(w.std()) - np.sqrt(2.0 / w[0].numel())) < 0.01 and not w.requires_grad


# ---------------------------------------------------------------------------
# one batch through each step: losses and gradients against JAX's
# ---------------------------------------------------------------------------


def _capture():
    """An optax transformation that makes no update and keeps the gradient as
    its state: JAX's own step then hands back its gradients exactly."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def _before_training_bn(name: str, state: dict) -> bool:
    """A bias ``X.k.bias`` followed by the BatchNorm ``X.{k+1}``: the batch
    mean removes it, so its true gradient is zero."""
    head, _, leaf = name.rpartition(".")
    parent, _, k = head.rpartition(".")
    return leaf == "bias" and k.isdigit() and f"{parent}.{int(k) + 1}.running_mean" in state


def _check_grads(model: torch.nn.Module, loss: torch.Tensor, jax_grads_tree) -> None:
    names, params = zip(*model.named_parameters())
    grads = dict(zip(names, t_state.gradients(loss, params)))
    want = params_from_jax(to_np(jax_grads_tree))
    largest = max(float(np.linalg.norm(want[n].numpy())) for n in names)
    state = model.state_dict()
    for n in names:
        ref = want[n].numpy()
        err = float(np.linalg.norm(grads[n].numpy() - ref))
        tol = (1e-5 * largest if _before_training_bn(n, state)
               else 1e-4 * float(np.linalg.norm(ref)))
        assert err <= tol, (n, err, np.linalg.norm(ref))


def _check_bn(model: torch.nn.Module, jax_params_tree) -> None:
    want = _bn_stats(params_from_jax(to_np(jax_params_tree)))
    got = _bn_stats(model.state_dict())
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k], want[k], 1e-5, k)


def _state(params, tx):
    from livespeechportraits_tpu.train.state import create_state

    return create_state(params, tx)


def test_apc_step_matches_jax():
    cfg = APCConfig(mel_dim=8, hidden_size=16, num_layers=3)
    p = j_apc.init_apc_pretrain(jax.random.PRNGKey(0), cfg)
    mels = np.random.default_rng(0).uniform(0, 1, (3, 24, 8)).astype(np.float32)
    new, metrics = j_steps.make_apc_step(cfg, _capture(), donate=False)(
        _state(p, _capture()), {"mels": jnp.asarray(mels)})
    model = _load(t_apc.APCPretrain(torch_config(cfg)), p)
    loss = t_steps.apc_loss(torch_config(cfg), model, {"mels": _t(mels)})
    np.testing.assert_allclose(loss.item(), float(metrics["loss"]), rtol=1e-5)
    _check_grads(model, loss, new.opt_state)


def _a2f_case(loss_kind: str):
    cfg = Audio2FeatureConfig(apc_hidden_size=16, lstm_hidden_size=12, output_dim=9,
                              frame_future=3, loss=loss_kind, gmm_ncenter=2)
    rng = np.random.default_rng(1)
    batch = {"audio": rng.normal(size=(3, 20, 16)).astype(np.float32),
             "target": rng.normal(0, 0.1, (3, 10, 9)).astype(np.float32)}
    return cfg, batch


@pytest.mark.parametrize("loss_kind", ["L2", "GMM"])
def test_audio2feature_step_matches_jax(loss_kind):
    cfg, batch = _a2f_case(loss_kind)
    p = j_a2f.init_audio2feature(jax.random.PRNGKey(1), cfg)
    new, metrics = j_steps.make_a2f_step(cfg, _capture(), donate=False)(
        _state(p, _capture()), {k: jnp.asarray(v) for k, v in batch.items()})
    model = _load(t_a2f.Audio2Feature(torch_config(cfg)), p)
    loss = t_steps.a2f_loss(torch_config(cfg), model, {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(loss.item(), float(metrics["loss"]), rtol=1e-5)
    _check_grads(model, loss, new.opt_state)
    _check_bn(model, new.params)
    # validation: eval-mode BatchNorm
    val_j = j_steps.a2f_validate(cfg)(new.params, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        val = t_steps.a2f_loss(torch_config(cfg), model, {k: _t(v) for k, v in batch.items()},
                               training=False)
    np.testing.assert_allclose(float(val), float(val_j), rtol=1e-5)


def test_device_audio_bank_gathers_the_shipped_windows():
    clips = _clips(2, 400, feat=6)
    for task in ("audio2feature", "audio2headpose"):
        kw = dict(task=task, seq_len=16, target_length=8, receptive_field=9, frame_future=2,
                  start_point=20, tail_margin=60)
        shipped = next(t_ds.AudioVisualSampler(clips, **kw).batches(4, np.random.default_rng(0)))
        banked = t_ds.AudioVisualSampler(clips, device_audio=True, **kw)
        b = next(banked.batches(4, np.random.default_rng(0)))
        win = t_steps._batch_audio({"audio_start": torch.from_numpy(b["audio_start"])},
                                   torch.from_numpy(banked.audio_bank), banked.audio_rows,
                                   fold_pairs=task == "audio2headpose")
        assert torch.equal(win, torch.from_numpy(shipped["audio"]))


@pytest.mark.parametrize("smooth", [0.0, 0.5])
def test_audio2headpose_step_matches_jax(smooth):
    wn = WaveNetConfig(residual_layers=3, residual_blocks=1, dilation_channels=8,
                       residual_channels=8, skip_channels=16, cond_channels=16)
    cfg = Audio2HeadposeConfig(apc_hidden_size=16, wavenet=wn)
    rng = np.random.default_rng(2)
    L, T = 14, 7
    batch = {"audio": rng.normal(size=(3, L, 32)).astype(np.float32),
             "history": rng.normal(0, 0.3, (3, L, 12)).astype(np.float32),
             "target": rng.normal(0, 0.3, (3, T, 12)).astype(np.float32)}
    p = j_a2h.init_audio2headpose(jax.random.PRNGKey(2), cfg)
    key = jax.random.PRNGKey(5)
    new, metrics = j_steps.make_a2h_step(cfg, _capture(), smooth_loss_weight=smooth,
                                         donate=False)(
        _state(p, _capture()), {k: jnp.asarray(v) for k, v in batch.items()}, key)
    # the dropout mask JAX's wavenet.forward draws from the step's key
    keep = np.asarray(jax.random.bernoulli(key, 0.5, (3, 1, 12)))
    model = _load(t_a2h.Audio2Headpose(torch_config(cfg)), p)
    loss, tm = t_steps.a2h_loss(torch_config(cfg), model, {k: _t(v) for k, v in batch.items()},
                                dropout_keep=torch.from_numpy(keep.copy()), smooth_loss_weight=smooth)
    for k in metrics:
        np.testing.assert_allclose(tm[k].item(), float(metrics[k]), rtol=1e-5, err_msg=k)
    _check_grads(model, loss, new.opt_state)
    _check_bn(model, new.params)


def _face_batch(seed: int = 3, size: int = 32, batch: int = 2, shared_cand: bool = True):
    rng = np.random.default_rng(seed)
    n_cand = 1 if shared_cand else batch
    return {"feature_map": (rng.uniform(size=(batch, size, size, 1)) > 0.8).astype(np.float32),
            "cand_image": rng.uniform(-1, 1, (n_cand, size, size, 12)).astype(np.float32),
            "tgt_image": rng.integers(0, 256, (batch, size, size, 3), dtype=np.uint8)}


# The GAN step tests compare gradients in float64 on both sides (JAX under
# enable_x64, the trees and the port's modules cast): the U-Net's gradient
# crosses some 30 training BatchNorms, and in f32 each side is only about
# 1e-4 from the float64 gradient (measured at 32^2, B = 6: JAX 8.4e-5, the
# port 6.0e-5), and moves with the thread count, so the stated 1e-4 cannot
# be held in f32.  They also take a candidate stack a sample: with one
# stack shared by a small batch the inner stages see channels of almost no
# variance, and 1 / sqrt(var + eps) magnifies rounding (10 % at 64^2, B = 2,
# in f32).  Their losses are held in f32 as well.
STEP_CFG = F2F_CFG


def test_shared_candidates_broadcast_to_the_batch():
    batch = _tb(_face_batch(2))
    inp = t_steps.f2f_g_input(batch)
    want = torch.cat([batch["feature_map"], batch["cand_image"].expand(2, -1, -1, -1)], -1)
    assert torch.equal(inp, want)
    j = j_steps.f2f_g_input({k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    assert np.array_equal(inp.numpy(), np.asarray(j))


def _tb(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def _f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


def _gan_step(which: str, cfg, g, d, batch, x64: bool):
    """JAX's d_step or g_step on one batch with the gradient-capturing
    transformation: (new state, metrics), in float64 when x64."""
    jb = {k: jnp.asarray(v.astype(np.float64) if x64 and v.dtype == np.float32 else v)
          for k, v in batch.items()}
    g_net, d_p = (_f64(g["net"]), _f64(d)) if x64 else (g["net"], d)
    d_step, g_step = j_steps.make_f2f_steps(cfg, _capture(), _capture(), donate=False)
    if which == "d":
        new, metrics = d_step(_state(d_p, _capture()), g_net, jb)
    else:
        new, metrics = g_step(_state(g_net, _capture()), d_p, jb)
    return new, {k: float(v) for k, v in metrics.items()}


def _gan_models(cfg, g, d, dtype):
    tg = _load(t_f2f.Feature2FaceG(torch_config(cfg)), g).to(dtype)
    td = _load(t_f2f.Feature2FaceD(torch_config(cfg)), d).to(dtype)
    return tg, td


def _tb_as(batch, dtype):
    return {k: (v.to(dtype) if v.is_floating_point() else v) for k, v in _tb(batch).items()}


@pytest.mark.parametrize("mode", ["ls", "hinge"])
def test_feature2face_d_step_matches_jax(mode):
    cfg = dataclasses.replace(STEP_CFG, gan_mode=mode)
    g = j_f2f.init_generator(jax.random.PRNGKey(0), cfg)
    d = j_f2f.init_discriminator(jax.random.PRNGKey(1), cfg)
    batch = _face_batch(3, 32, 6, shared_cand=False)
    _, metrics = _gan_step("d", cfg, g, d, batch, x64=False)
    tg, td = _gan_models(cfg, g, d, torch.float32)
    with torch.no_grad():
        _, tm = t_steps.f2f_d_loss(torch_config(cfg), tg, td, _tb(batch))
    for k in metrics:
        np.testing.assert_allclose(tm[k].item(), metrics[k], rtol=1e-5, err_msg=k)
    with jax.enable_x64(True):
        new_d, metrics = _gan_step("d", cfg, g, d, batch, x64=True)
    tg, td = _gan_models(cfg, g, d, torch.float64)
    g_before = {k: v.clone() for k, v in tg.state_dict().items()}
    loss, tm = t_steps.f2f_d_loss(torch_config(cfg), tg, td, _tb_as(batch, torch.float64))
    for k in metrics:
        np.testing.assert_allclose(tm[k].item(), metrics[k], rtol=1e-5, err_msg=k)
    _check_grads(td, loss, new_d.opt_state)
    _check_bn(td, new_d.params)  # the real pair's statistics only
    # G ran in eval mode: its running stats did not move
    for k, v in tg.state_dict().items():
        assert torch.equal(v, g_before[k]), k


def test_feature2face_g_step_matches_jax():
    """Without the VGG terms, which test_vgg_style_loss_gradient_matches_jax
    holds on their own (their gradient is of the order of 1e6 here)."""
    g = j_f2f.init_generator(jax.random.PRNGKey(0), STEP_CFG)
    d = j_f2f.init_discriminator(jax.random.PRNGKey(1), STEP_CFG)
    batch = _face_batch(4, 32, 6, shared_cand=False)
    _, metrics = _gan_step("g", STEP_CFG, g, d, batch, x64=False)
    tg, td = _gan_models(STEP_CFG, g, d, torch.float32)
    with torch.no_grad():
        _, tm = t_steps.f2f_g_loss(torch_config(STEP_CFG), tg, td, _tb(batch))
    for k in metrics:
        np.testing.assert_allclose(tm[k].item(), metrics[k], rtol=1e-5, atol=1e-6, err_msg=k)
    with jax.enable_x64(True):
        new_g, metrics = _gan_step("g", STEP_CFG, g, d, batch, x64=True)
    tg, td = _gan_models(STEP_CFG, g, d, torch.float64)
    d_before = {k: v.clone() for k, v in td.state_dict().items()}
    loss, tm = t_steps.f2f_g_loss(torch_config(STEP_CFG), tg, td, _tb_as(batch, torch.float64))
    for k in metrics:
        np.testing.assert_allclose(tm[k].item(), metrics[k], rtol=1e-5, atol=1e-6, err_msg=k)
    _check_grads(tg, loss, {"net": new_g.opt_state, "size": "normal"})
    _check_bn(tg, {"net": new_g.params, "size": "normal"})
    # D ran in eval mode and gets no gradient from G's loss
    for k, v in td.state_dict().items():
        assert torch.equal(v, d_before[k]), k
    assert all(p.grad is None for p in td.parameters())


def test_vgg_style_loss_gradient_matches_jax(tmp_path):
    """The G step's perceptual and style terms: the losses with the VGG
    the step takes, and their gradient with respect to the fake frame."""
    params, vgg = _vgg_pair(tmp_path)
    rng = np.random.default_rng(12)
    x, y = np.tanh(rng.normal(size=(2, 3, 32, 32, 3))).astype(np.float32)
    g_j = jax.grad(lambda v: sum(j_losses.vgg_style_loss(params, v, jnp.asarray(y))))(
        jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    (g,) = torch.autograd.grad(sum(t_losses.vgg_style_loss(vgg, xt, _t(y))), xt)
    err = np.linalg.norm(g.numpy() - np.asarray(g_j))
    assert err <= 1e-4 * np.linalg.norm(np.asarray(g_j))
    batch = _face_batch(6, 32, 2, shared_cand=False)
    g_p = j_f2f.init_generator(jax.random.PRNGKey(0), STEP_CFG)
    d_p = j_f2f.init_discriminator(jax.random.PRNGKey(1), STEP_CFG)
    _, g_step = j_steps.make_f2f_steps(STEP_CFG, _capture(), _capture(), vgg_params=params,
                                       donate=False)
    _, metrics = g_step(_state(g_p["net"], _capture()), d_p,
                        {k: jnp.asarray(v) for k, v in batch.items()})
    tg = _load(t_f2f.Feature2FaceG(torch_config(STEP_CFG)), g_p)
    td = _load(t_f2f.Feature2FaceD(torch_config(STEP_CFG)), d_p)
    with torch.no_grad():
        _, tm = t_steps.f2f_g_loss(torch_config(STEP_CFG), tg, td, _tb(batch), vgg=vgg)
    for k in ("VGG", "Style", "loss_G"):
        np.testing.assert_allclose(tm[k].item(), float(metrics[k]), rtol=1e-5, err_msg=k)


def test_feature2face_validate_matches_jax():
    g = j_f2f.init_generator(jax.random.PRNGKey(0), F2F_CFG)
    batch = _face_batch(5)
    fake_j, m_j = j_steps.f2f_validate(F2F_CFG)(g["net"],
                                                {k: jnp.asarray(v) for k, v in batch.items()})
    tg = _load(t_f2f.Feature2FaceG(torch_config(F2F_CFG)), g)
    fake, m = t_steps.f2f_validate(tg, _tb(batch))
    _close(fake, fake_j, 1e-5)
    for k in m_j:
        np.testing.assert_allclose(float(m[k]), float(m_j[k]), rtol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# Adam and the schedules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("betas", [(0.9, 0.99), (0.5, 0.999), (0.0, 0.9)])
def test_adam_update_matches_optax(betas):
    rng = np.random.default_rng(6)
    p0 = rng.normal(0, 0.02, (5, 7)).astype(np.float32)
    grads = rng.normal(0, 1e-2, (4, 5, 7)).astype(np.float32)
    tx = optax.adam(1e-3, b1=betas[0], b2=betas[1])
    p_j, s = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    w = torch.nn.Parameter(_t(p0))
    opt = t_state.adam([w], 1e-3, *betas)
    for g in grads:
        u, s = tx.update(jnp.asarray(g), s, p_j)
        p_j = optax.apply_updates(p_j, u)
        w.grad = _t(g)
        opt.step()
        _close(w, p_j, 1e-6)
    t_state.set_lr(opt, 5e-4)
    assert opt.param_groups[0]["lr"] == 5e-4


@pytest.mark.parametrize("policy", ["linear", "step", "cosine", "plateau"])
def test_schedules_match_jax_at_every_epoch(policy):
    kw = dict(n_epochs=5, n_epochs_decay=4, step_size=3, gamma=0.5)
    ours, ref = (t_sched.make_schedule(policy, 2e-4, **kw), j_sched.make_schedule(policy, 2e-4, **kw))
    vals = [1.0, 0.9, 0.95, 0.95, 0.95, 0.95, 0.95, 0.95, 0.95, 0.5]
    for epoch in range(12):
        assert ours(epoch) == ref(epoch), epoch
        if policy == "plateau" and epoch < len(vals):
            assert ours.update(vals[epoch]) == ref.update(vals[epoch])
    if policy == "plateau":
        back = t_sched.make_schedule(policy, 2e-4)
        back.load_state_dict(ours.state_dict())
        assert back == ours


# ---------------------------------------------------------------------------
# samplers: the same batches as JAX's from the same generator
# ---------------------------------------------------------------------------


def _clips(n: int, frames: int, feat: int = 8, pkg=t_ds):
    rng = np.random.default_rng(7)
    out = []
    for _ in range(n):
        out.append(pkg.make_clip(
            audio_features=rng.normal(size=(2 * frames, feat)).astype(np.float32),
            pts3d=rng.normal(0, 0.01, (frames, 73, 3)).astype(np.float32),
            rot_angles=rng.uniform(-170, 170, (frames, 3)).astype(np.float32),
            trans=rng.normal(size=(frames, 3)).astype(np.float32)))
    return out


def _same_batches(ours, ref, *args, **kw):
    a = list(ours.batches(*args[:1], np.random.default_rng(11), *args[1:], **kw))
    b = list(ref.batches(*args[:1], np.random.default_rng(11), *args[1:], **kw))
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), k
    return a


@pytest.mark.parametrize("device_audio", [False, True])
@pytest.mark.parametrize("task", ["audio2feature", "audio2headpose"])
def test_audio_visual_sampler_batches_equal_jax(task, device_audio):
    kw = dict(task=task, seq_len=16, target_length=8, receptive_field=9, frame_future=2,
              frame_jump_stride=3, start_point=20, tail_margin=60, device_audio=device_audio)
    ours = t_ds.AudioVisualSampler(_clips(2, 300), **kw)
    ref = j_ds.AudioVisualSampler(_clips(2, 300, pkg=j_ds), **kw)
    assert len(ours) == len(ref)
    _same_batches(ours, ref, 5)
    _same_batches(ours, ref, 5, shuffle=False, drop_last=False)
    if device_audio:
        assert np.array_equal(ours.audio_bank, ref.audio_bank)
        assert ours.audio_rows == ref.audio_rows
    with pytest.raises(ValueError, match="too short"):
        t_ds.AudioVisualSampler(_clips(1, 40), task=task)


def test_mel_window_sampler_batches_equal_jax():
    rng = np.random.default_rng(8)
    mels = [rng.uniform(size=(n, 8)).astype(np.float32) for n in (100, 61, 20)]
    _same_batches(t_ds.MelWindowSampler(mels, window=30, stride=15),
                  j_ds.MelWindowSampler(mels, window=30, stride=15), 3)
    with pytest.raises(ValueError, match="no utterance"):
        t_ds.MelWindowSampler(mels, window=200)


def _face_args(n: int = 70, H: int = 48, seed: int = 9):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, 64, 64, 3), dtype=np.uint8)
    lms = rng.uniform(12, 52, (n, 73, 2)).astype(np.float32)
    sh = rng.uniform(0, 64, (18, 2)).astype(np.float32)
    cand = rng.uniform(-1, 1, (4, 64, 64, 3)).astype(np.float32)
    return images, lms, sh, cand


@pytest.mark.parametrize("kw", [
    dict(),
    dict(device_rasterize=True, crop_jitter=3.0, frame_jump=2),
    dict(u8_targets=False, emit_weight_mask=False, shared_cand=False),
], ids=["host", "device_rasterize_jitter", "f32_no_mask"])
def test_face_frame_sampler_batches_equal_jax(kw):
    args = _face_args()
    ours = t_ds.FaceFrameSampler(*args, load_size=48, **kw)
    ref = j_ds.FaceFrameSampler(*args, load_size=48, **kw)
    assert len(ours) == len(ref)
    batches = _same_batches(ours, ref, 4)
    assert ("landmarks" in batches[0]) == bool(kw.get("device_rasterize"))
    # two clips behind one sampler
    other = _face_args(65, seed=10)
    cat = t_ds.ConcatFaceSampler([ours, t_ds.FaceFrameSampler(*other, load_size=48, **kw)])
    cat_j = j_ds.ConcatFaceSampler([ref, j_ds.FaceFrameSampler(*other, load_size=48, **kw)])
    _same_batches(cat, cat_j, 4, shuffle=False, drop_last=False)
