"""The port's fused GAN step, rematerialisation and the chunked VGG loss on
the CPU at test widths, against the JAX package's and against their own
unfused, unrematerialised, unchunked forms; the GAN trainer's fused loop
with a resume; the CLI with --fused_step --remat --vgg_microbatch.  The
counterpart of the JAX package's tests/test_train.py:289-384,
tests/test_losses_vgg.py and tests/test_trainer_loop.py:192.

Tolerances:
- the fused step against JAX's make_f2f_fused_step under SGD (lr 1e-2), in
  f32 (JAX's step casts the generator's output to f32, so it does not run
  in float64): the post-step parameters within JAX's own atol 2e-5, rtol
  1e-4, the BatchNorm running stats within 1e-6, the losses within rtol
  1e-5;
- the fused step against its own two-loss oracle, float64: 1e-9 on the
  post-step parameters and running stats;
- remat (True, and K = 1, 2, 5 stages) and remat_d against no remat in f32:
  every gradient and running stat within 1e-6 of the largest magnitude of
  its tensor (the recompute runs the same operations on the same inputs;
  measured: equal bit for bit);
- the chunked VGG loss against the unchunked one: JAX's rtol 2e-5 on the
  perceptual term and 2e-4 on the style term, the input gradient within
  rtol 5e-4, atol 1e-6; the port's chunked loss against JAX's chunked loss
  within rtol 1e-5.
"""

from __future__ import annotations

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from livespeechportraits_torch.models import feature2face as t_f2f
from livespeechportraits_torch.models import losses as t_losses
from livespeechportraits_torch.train import __main__ as cli
from livespeechportraits_torch.train import datasets, steps as t_steps, trainer
from livespeechportraits_torch.utils import checkpoint as ckpt
from livespeechportraits_torch.utils.convert import params_from_jax
from livespeechportraits_tpu.config import Feature2FaceConfig
from livespeechportraits_tpu.models import feature2face as j_f2f
from livespeechportraits_tpu.models import losses as j_losses
from livespeechportraits_tpu.models import nn_core as j_nn
from livespeechportraits_tpu.train import state as j_state
from livespeechportraits_tpu.train import steps as j_steps
from torch_parity import to_np, torch_config

CFG = Feature2FaceConfig(ngf=8, n_downsample=5, load_size=32, ndf=8, n_layers_D=2, num_D=2,
                         precision="float32")


@pytest.fixture(autouse=True)
def two_pass_bn(monkeypatch):
    """JAX's training BatchNorm in its two-pass form, which the port computes."""
    monkeypatch.setattr(j_nn, "BN_ONEPASS", False)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread, so the sums run in one order whatever the
    machine (see test_torch_trainer.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed: int, batch: int = 6, size: int = 32) -> dict:
    """A candidate stack a sample (one shared stack over a small batch
    leaves inner channels almost without variance: test_torch_train.py)."""
    rng = np.random.default_rng(seed)
    return {"feature_map": (rng.uniform(size=(batch, size, size, 1)) > 0.8).astype(np.float32),
            "cand_image": rng.uniform(-1, 1, (batch, size, size, 12)).astype(np.float32),
            "tgt_image": rng.integers(0, 256, (batch, size, size, 3), dtype=np.uint8)}


def _tb(batch: dict, dtype=torch.float32) -> dict:
    return {k: (torch.from_numpy(v.copy()).to(dtype) if v.dtype == np.float32
                else torch.from_numpy(v.copy())) for k, v in batch.items()}


def _models(cfg, g, d, dtype=torch.float32):
    tg = t_f2f.Feature2FaceG(torch_config(cfg))
    tg.load_state_dict(params_from_jax(to_np(g)), strict=True)
    td = t_f2f.Feature2FaceD(torch_config(cfg))
    td.load_state_dict(params_from_jax(to_np(d)), strict=True)
    return tg.to(dtype), td.to(dtype)


def _jax_models(seed: int, cfg=CFG):
    kg, kd = jax.random.split(jax.random.PRNGKey(seed))
    return j_f2f.init_generator(kg, cfg), j_f2f.init_discriminator(kd, cfg)


def _sgd(*models, lr: float = 1e-2):
    return [torch.optim.SGD(m.parameters(), lr=lr) for m in models]


def _close_state(got: dict, want: dict, atol: float, rtol: float, only=None) -> None:
    for k in want:
        if only is not None and not only(k):
            continue
        np.testing.assert_allclose(got[k].double().numpy(), want[k].double().numpy(),
                                   atol=atol, rtol=rtol, err_msg=k)


def _is_stat(k: str) -> bool:
    return k.endswith(("running_mean", "running_var"))


# ---------------------------------------------------------------------------
# the fused step against JAX's
# ---------------------------------------------------------------------------


def test_fused_step_matches_jax_under_sgd():
    """JAX's own test's comparison (tests/test_train.py:289-384): SGD makes
    the post-step parameters linear in the gradients, so atol 2e-5, rtol
    1e-4 holds the step to its gradients."""
    g, d = _jax_models(5)
    batch = _batch(5)
    tx = optax.sgd(1e-2)
    step = j_steps.make_f2f_fused_step(CFG, tx, tx, donate=False)
    new_g, new_d, metrics = step(j_state.create_state(g["net"], tx),
                                 j_state.create_state(d, tx),
                                 {k: jnp.asarray(v) for k, v in batch.items()})
    tg, td = _models(CFG, g, d)
    tm = t_steps.f2f_fused_step(torch_config(CFG), tg, td, *_sgd(tg, td), _tb(batch))
    assert set(tm) == set(metrics)  # JAX's keys
    # detached: loss_D's graph would keep the real pair's D tower alive
    assert not any(v.requires_grad for v in tm.values())
    for k in metrics:
        np.testing.assert_allclose(tm[k].item(), float(metrics[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    want_g = params_from_jax(to_np({"net": new_g.params, "size": CFG.size}))
    want_d = params_from_jax(to_np(new_d.params))
    for got, want in ((tg.state_dict(), want_g), (td.state_dict(), want_d)):
        _close_state(got, want, 2e-5, 1e-4, only=lambda k: not _is_stat(k))
        # G's stats from its one forward, D's from the real pair only
        _close_state(got, want, 1e-6, 0, only=_is_stat)


def _oracle_step(cfg, g, d, batch, opt_g, opt_d):
    """The fused step's declared semantics (JAX tests/test_train.py:289):
    the D loss with the fake detached and the G loss with D's real features
    detached, both at the pre-update parameters from training-mode
    forwards, each differentiated alone."""
    inp, tgt = t_steps.f2f_g_input(batch), t_steps.f2f_target(batch)
    # each network's running stats move once: G's in the G loss's forward,
    # D's in the D loss's real pair
    fake = t_f2f.apply_generator(copy.deepcopy(g), inp, training=True).detach()
    pr = t_f2f.apply_discriminator(d, torch.cat([inp, tgt], -1), training=True)
    pf = t_f2f.apply_discriminator(d, torch.cat([inp, fake], -1), training=True,
                                   update_stats=False)
    loss_d = (t_losses.gan_loss(pr, True, cfg.gan_mode) * 2.0
              + t_losses.gan_loss(pf, False, cfg.gan_mode)) * 0.5
    d_grads = torch.autograd.grad(loss_d, list(d.parameters()))
    fake = t_f2f.apply_generator(g, inp, training=True)
    pr = [[f.detach() for f in scale] for scale in t_f2f.apply_discriminator(
        d, torch.cat([inp, tgt], -1), training=True, update_stats=False)]
    pf = t_f2f.apply_discriminator(d, torch.cat([inp, fake], -1), training=True,
                                   update_stats=False)
    loss_g = (t_losses.gan_loss(pf, True, cfg.gan_mode, for_discriminator=False)
              + torch.mean((fake - tgt).abs()) * cfg.lambda_L1
              + t_losses.feature_matching_loss(pf, pr, cfg.num_D, cfg.n_layers_D,
                                               cfg.lambda_feat))
    g_grads = torch.autograd.grad(loss_g, list(g.parameters()), allow_unused=True)
    for m, grads, opt in ((d, d_grads, opt_d), (g, g_grads, opt_g)):
        for p, gr in zip(m.parameters(), grads):
            p.grad = torch.zeros_like(p) if gr is None else gr
        opt.step()


def test_fused_step_equals_its_two_loss_oracle():
    g, d = _jax_models(6)
    batch = _tb(_batch(6), torch.float64)
    cfg = torch_config(CFG)
    tg, td = _models(CFG, g, d, torch.float64)
    og, od = copy.deepcopy(tg), copy.deepcopy(td)
    t_steps.f2f_fused_step(cfg, tg, td, *_sgd(tg, td), batch)
    _oracle_step(cfg, og, od, batch, *_sgd(og, od))
    for a, b in ((tg, og), (td, od)):
        _close_state(a.state_dict(), b.state_dict(), 1e-9, 0)
    before = _models(CFG, g, d, torch.float64)
    for m, m0 in zip((tg, td), before):
        assert any(not torch.equal(v, m0.state_dict()[k]) for k, v in m.state_dict().items())


# ---------------------------------------------------------------------------
# rematerialisation
# ---------------------------------------------------------------------------


def _grads_and_stats(cfg, g, d, batch, **kw):
    """d loss_D / d D's parameters, d loss_G / d G's and the running stats
    after the fused step's forwards (VGG, chunked or not, included)."""
    g, d = copy.deepcopy(g), copy.deepcopy(d)
    vgg = t_losses.init_vgg19(0)
    loss_d, loss_g, _ = t_steps.f2f_fused_losses(cfg, g, d, batch, vgg, **kw)
    gd = torch.autograd.grad(loss_d, list(d.parameters()), retain_graph=True)
    gg = torch.autograd.grad(loss_g, list(g.parameters()))
    stats = {f"{n}.{k}": v.clone() for n, m in (("G", g), ("D", d))
             for k, v in m.state_dict().items() if _is_stat(k)}
    return list(gd) + list(gg), stats, (loss_d.item(), loss_g.item())


REMAT = {"full": {"remat": True}, "outer1": {"remat": 1}, "outer2": {"remat": 2},
         "all_stages": {"remat": 5}, "remat_d": {"remat_d": True},
         "outer2_and_d": {"remat": 2, "remat_d": True}}


@pytest.mark.parametrize("qat", [None, "fq8"], ids=["float", "qat_fq8"])
@pytest.mark.parametrize("mode", list(REMAT))
def test_remat_gives_the_gradients_and_stats_of_no_remat(mode, qat):
    """Each checkpointed region runs its forward again in the backward; the
    training BatchNorms' running stats still move once (the recompute
    updates copies), and the fq8 convs' straight-through backward is
    unchanged under recompute (on the CPU their forward is K4's twin)."""
    g, d = _jax_models(7)
    tg, td = _models(CFG, g, d)
    if qat:
        tg = t_f2f.qat_generator(tg, int8_forward=True)
        td = t_f2f.qat_discriminator(td)
    batch = _tb(_batch(7, batch=4))
    cfg = torch_config(CFG)
    ref_grads, ref_stats, ref_losses = _grads_and_stats(cfg, tg, td, batch)
    grads, stats, got_losses = _grads_and_stats(cfg, tg, td, batch, **REMAT[mode])
    assert got_losses == ref_losses
    for a, b in zip(grads, ref_grads):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max()), mode
    for k in ref_stats:
        assert float((stats[k] - ref_stats[k]).abs().max()) <= 1e-6 * float(
            ref_stats[k].abs().max()), k
    assert any(not torch.equal(stats[k], v) for k, v in
               {f"G.{k}": v for k, v in tg.state_dict().items() if _is_stat(k)}.items())


def test_remat_stages_checkpoint_the_outer_halves_only(monkeypatch):
    """remat=K wraps 2 K stage halves; remat=True the whole forward once."""
    calls = []
    real = t_f2f.checkpointed
    monkeypatch.setattr(t_f2f, "checkpointed",
                        lambda fn, x, upd=True: calls.append(tuple(x.shape)) or real(fn, x, upd))
    g, _ = _jax_models(8)
    tg, _ = _models(CFG, g, _jax_models(8)[1])
    x = torch.from_numpy(np.random.default_rng(8).uniform(-1, 1, (2, 32, 32, 13))
                         .astype(np.float32))
    for remat, n in ((True, 1), (1, 2), (2, 4), (5, 10)):
        calls.clear()
        t_f2f.apply_generator(tg, x, training=True, remat=remat)
        assert len(calls) == n, (remat, calls)
    assert calls[0] == (2, 13, 32, 32) and calls[1] == (2, 8, 16, 16)  # outermost first


# ---------------------------------------------------------------------------
# the chunked VGG loss
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def vgg_pair(tmp_path_factory):
    """JAX's random VGG19 and the port's, loaded through load_vgg19_npz."""
    params = j_losses.init_vgg19(0)
    convs = [c for c in params["convs"] if not isinstance(c, str)]
    path = tmp_path_factory.mktemp("vgg") / "vgg.npz"
    np.savez(path, **{f"conv{i}_{k}": (np.asarray(c["w"]).transpose(3, 2, 0, 1) if k == "w"
                                        else np.asarray(c["b"]))
                      for i, c in enumerate(convs) for k in ("w", "b")})
    return params, t_losses.load_vgg19_npz(str(path))


def _pair(b: int = 4, hw: int = 32, seed: int = 0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (b, hw, hw, 3)).astype(np.float32),
            rng.uniform(-1, 1, (b, hw, hw, 3)).astype(np.float32))


@pytest.mark.parametrize("m", [1, 2, 4])
def test_microbatch_matches_unchunked_and_jax(vgg_pair, m):
    params, vgg = vgg_pair
    x, y = _pair()
    with torch.no_grad():
        p0, s0 = t_losses.vgg_style_loss(vgg, torch.from_numpy(x), torch.from_numpy(y))
        p1, s1 = t_losses.vgg_style_loss(vgg, torch.from_numpy(x), torch.from_numpy(y),
                                         microbatch=m)
    np.testing.assert_allclose(float(p1), float(p0), rtol=2e-5)
    np.testing.assert_allclose(float(s1), float(s0), rtol=2e-4)
    pj, sj = j_losses.vgg_style_loss(params, jnp.asarray(x), jnp.asarray(y), microbatch=m)
    np.testing.assert_allclose(float(p1), float(pj), rtol=1e-5)
    np.testing.assert_allclose(float(s1), float(sj), rtol=1e-5)


@pytest.mark.parametrize("style", [True, False], ids=["style", "style_off"])
def test_microbatch_gradient_matches_unchunked(vgg_pair, style):
    _, vgg = vgg_pair
    x, y = _pair(b=4, hw=16, seed=3)
    grads = []
    for m in (None, 2):
        xt = torch.from_numpy(x).requires_grad_(True)
        p, s = t_losses.vgg_style_loss(vgg, xt, torch.from_numpy(y), style=style,
                                       microbatch=m)
        if not style:
            assert float(s) == 0.0
        (gx,) = torch.autograd.grad(p + s, xt)
        grads.append(gx.numpy())
    np.testing.assert_allclose(grads[1], grads[0], rtol=5e-4, atol=1e-6)


def test_microbatch_must_divide_the_batch(vgg_pair):
    _, vgg = vgg_pair
    x, y = _pair(b=6, hw=16)
    with pytest.raises(ValueError, match="divide"):
        t_losses.vgg_style_loss(vgg, torch.from_numpy(x), torch.from_numpy(y), microbatch=4)


def test_fused_step_with_vgg_microbatch_matches_jax(vgg_pair):
    """One fused step with the chunked perceptual loss: its losses against
    JAX's make_f2f_fused_step(vgg_microbatch=2) on the same weights (f32)."""
    params, vgg = vgg_pair
    g, d = _jax_models(9)
    batch = _batch(9, batch=4)
    tx = optax.sgd(1e-2)
    step = j_steps.make_f2f_fused_step(CFG, tx, tx, vgg_params=params, donate=False,
                                       vgg_microbatch=2)
    _, _, metrics = step(j_state.create_state(g["net"], tx), j_state.create_state(d, tx),
                         {k: jnp.asarray(v) for k, v in batch.items()})
    tg, td = _models(CFG, g, d)
    tm = t_steps.f2f_fused_step(torch_config(CFG), tg, td, *_sgd(tg, td), _tb(batch), vgg,
                                vgg_microbatch=2)
    for k in ("VGG", "Style", "loss_G", "loss_D"):
        np.testing.assert_allclose(tm[k].item(), float(metrics[k]), rtol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# the trainer and the CLI
# ---------------------------------------------------------------------------

TCFG = torch_config(dataclasses.replace(CFG, ngf=4, ndf=4))


def _face_sampler(n: int = 64, H: int = 32):
    rng = np.random.default_rng(3)
    return datasets.FaceFrameSampler(
        rng.integers(0, 255, (n, H, H, 3), dtype=np.uint8),
        rng.uniform(5, 27, (n, 73, 2)).astype(np.float32),
        rng.uniform(5, 27, (18, 2)).astype(np.float32),
        rng.uniform(-1, 1, (4, H, H, 3)).astype(np.float32), load_size=H,
        device_rasterize=True)


def _train(tmp_path, name, n_epochs_decay, continue_train=False, **kw):
    loop = trainer.TrainLoopConfig(n_epochs=1, n_epochs_decay=n_epochs_decay, lr=1e-3,
                                   batch_size=2, print_freq=2, checkpoints_dir=str(tmp_path),
                                   name=name, continue_train=continue_train, device="cpu",
                                   fused_step=True, **kw)
    return trainer.train_feature2face(TCFG, loop, _face_sampler(), _face_sampler(),
                                      vgg=t_losses.init_vgg19(0))


def _same_state(a: trainer.TrainResult, b: trainer.TrainResult) -> None:
    for k in a.models:
        sa, sb = a.models[k].state_dict(), b.models[k].state_dict()
        for n in sa:
            assert torch.equal(sa[n], sb[n]), (k, n)
        oa, ob = a.optimizers[k].state_dict()["state"], b.optimizers[k].state_dict()["state"]
        for i in oa:
            for m in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(oa[i][m], ob[i][m]), (k, i, m)


@pytest.mark.parametrize("kw", [{}, {"remat": 2, "vgg_microbatch": 1},
                                {"qat_int8": True, "qat_d": True}],
                         ids=["fused", "remat_microbatch", "qat_int8_d"])
def test_fused_loop_and_resume_equal_the_uninterrupted_run(kw, tmp_path):
    """Two epochs of fused steps, and one epoch then a resume, end in the same
    models and Adam moments; the metrics carry JAX's keys; the epoch panel
    is written; --qat_d's D stays untagged in the checkpoint."""
    whole = _train(tmp_path, "whole", 1, **kw)
    assert whole.epochs == 2 and whole.step_ms
    first = _train(tmp_path, "split", 0, **kw)
    resumed = _train(tmp_path, "split", 1, continue_train=True, **kw)
    assert first.epochs == 1 and resumed.epochs == 2
    _same_state(whole, resumed)
    header = (tmp_path / "whole" / "scalars.csv").read_text().splitlines()[0].split(",")
    assert header == ["step", "loss_G_GAN", "L1", "VGG", "Style", "loss_G_FM", "loss_G",
                      "D_real", "D_fake", "loss_D"]
    web = tmp_path / "whole" / "web"
    assert {f"epoch{e:03d}_{v}.jpg" for e in (1, 2)
            for v in ("input_feature_map", "synthesized", "target")} <= set(
        p.name for p in (web / "images").iterdir())
    assert "epoch [2]" in (web / "index.html").read_text()
    st = ckpt.load_checkpoint(str(tmp_path / "whole" / "ckpt"))
    assert st["models"]["D"].keys() == t_f2f.Feature2FaceD(TCFG).state_dict().keys()


def test_fused_and_alternating_steps_differ_as_jax_documents(tmp_path):
    """The fused step is not the alternating pair: G sees the pre-update D
    and training-mode D forwards, so one epoch ends elsewhere."""
    fused = _train(tmp_path, "fused", 0)
    loop = trainer.TrainLoopConfig(n_epochs=1, n_epochs_decay=0, lr=1e-3, batch_size=2,
                                   checkpoints_dir=str(tmp_path), name="pair", device="cpu")
    pair = trainer.train_feature2face(TCFG, loop, _face_sampler(), _face_sampler(),
                                      vgg=t_losses.init_vgg19(0))
    assert any(not torch.equal(v, pair.models["G"].state_dict()[n])
               for n, v in fused.models["G"].state_dict().items())


def test_cli_trains_with_fused_step_remat_and_vgg_microbatch(tmp_path):
    res = cli.main(["--task", "feature2face", "--synthetic", "--device", "cpu",
                    "--image_size", "32", "--batch_size", "4", "--n_epochs", "1",
                    "--n_epochs_decay", "0", "--fused_step", "--remat", "--vgg", "random",
                    "--vgg_microbatch", "2", "--checkpoints_dir", str(tmp_path),
                    "--print_freq", "1"])
    assert res.epochs == 1 and ckpt.latest_step(str(tmp_path / "feature2face" / "ckpt")) == 1
    rows = [r.split(",") for r in (tmp_path / "feature2face" / "scalars.csv")
            .read_text().splitlines()]
    vgg_col = rows[0].index("VGG")
    assert all(float(r[vgg_col]) > 0 for r in rows[1:] if r[0] != "step" and len(r) > vgg_col)
