"""Data parallelism in the PyTorch port, on the CPU.

Two real processes (tests/_torch_dp_worker.py) form a gloo group through
``parallel.multihost`` and run, on their own rows of each global batch of 4,
one APC and one Audio2Feature step, the fused GAN step (float64) and two
epochs of the Audio2Feature trainer with and without ZeRO-1.  One pair of
processes serves every check here.  Held against:
- one process on the global batch (no group): the reduced gradients, the
  mean of the ranks' losses and the BatchNorm running statistics (the
  global batch's, through nn_core._global_batchnorm);
- JAX's single-device step on the same weights (A2F, APC), as
  tests/test_multihost.py holds JAX's two-process step;
- replicated Adam on the same gradients, bitwise, for ZeRO-1 (JAX
  tests/test_parallel.py:287), each rank holding about half the state.

Tolerances: the f32 steps' gradients within 2e-5 of the one-process
gradient's norm, each tensor (sums in another order across two ranks), and
within 1e-4 of JAX's (tests/test_torch_train.py's rule); the float64 GAN
step within 1e-9.  A bias that a training BatchNorm follows has a true
gradient of zero, and its error is floored at a share of its network's
largest gradient norm (the PR rule of tests/test_torch_train.py).

Then the render split (``animate(render_devices=)``, JAX's ``mesh=``) and
``Predictor(data_parallel=True)`` on the CPU.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _torch_dp_worker as W
from livespeechportraits_torch import serve
from livespeechportraits_torch.config import APCConfig, Audio2FeatureConfig, Feature2FaceConfig
from livespeechportraits_torch.models import apc as t_apc
from livespeechportraits_torch.models import audio2feature as t_a2f
from livespeechportraits_torch.models import feature2face as t_f2f
from livespeechportraits_torch.models import losses as t_losses
from livespeechportraits_torch.parallel import mesh, multihost
from livespeechportraits_torch.pipeline import animate, assets, video
from livespeechportraits_torch.train import __main__ as cli
from livespeechportraits_torch.train import datasets
from livespeechportraits_torch.train import state as t_state
from livespeechportraits_torch.train import steps as t_steps
from livespeechportraits_torch.train import trainer
from livespeechportraits_torch.utils import checkpoint as ckpt
from livespeechportraits_torch.utils.convert import params_from_jax
from livespeechportraits_tpu import config as jconfig
from livespeechportraits_tpu.models import apc as j_apc
from livespeechportraits_tpu.models import audio2feature as j_a2f
from livespeechportraits_tpu.models import nn_core as j_nn
from livespeechportraits_tpu.train import steps as j_steps
from livespeechportraits_tpu.train.state import create_state
from torch_parity import small_person_config, to_np, torch_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_dp_worker.py")
F32_TOL = 2e-5  # two ranks against one process, f32, relative to each gradient's norm
JAX_TOL = 1e-4  # against JAX's single-device step (tests/test_torch_train.py)
F64_TOL = 1e-9  # the GAN step in float64
ZERO_GRAD_FLOOR = 1e-5  # a zero-true-gradient tensor: share of the largest norm


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _t(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def _inputs() -> dict:
    """The weights and the global batches every process starts from: the
    A2F and APC weights are JAX's init, converted; the GAN's the port's."""
    rng = np.random.default_rng(7)
    a2f_j = j_a2f.init_audio2feature(jax.random.PRNGKey(0), jconfig.Audio2FeatureConfig(**W.A2F))
    apc_j = j_apc.init_apc_pretrain(jax.random.PRNGKey(1), jconfig.APCConfig(**W.APC))
    f2f_cfg = Feature2FaceConfig(**W.F2F)
    gen = torch.Generator().manual_seed(9)
    g = trainer._init(t_f2f.Feature2FaceG(f2f_cfg), gen=gen)
    d = trainer._init(t_f2f.Feature2FaceD(f2f_cfg), gen=gen)
    B, H = W.GLOBAL_BATCH, W.F2F["load_size"]
    return {
        "a2f": params_from_jax(to_np(a2f_j)), "a2f_jax": a2f_j,
        "a2f_batch": {"audio": rng.normal(size=(B, 24, 8)).astype(np.float32),
                      "target": rng.normal(0, 0.1, (B, 12, 6)).astype(np.float32)},
        "apc": params_from_jax(to_np(apc_j)), "apc_jax": apc_j,
        "apc_batch": {"mels": rng.uniform(0, 1, (B, 24, 8)).astype(np.float32)},
        "vgg_batch": {"x": rng.uniform(-1, 1, (B, 32, 32, 3)),
                      "y": rng.uniform(-1, 1, (B, 32, 32, 3))},
        "gan_g": g.state_dict(), "gan_d": d.state_dict(),
        "gan_batch": {"feature_map": (rng.uniform(size=(B, H, H, 1)) > 0.8).astype(np.float32),
                      "cand_image": rng.uniform(-1, 1, (B, H, H, 12)).astype(np.float32),
                      "tgt_image": rng.uniform(-1, 1, (B, H, H, 3)).astype(np.float32)},
        "qat_batch": _uneven_halves(rng, B, H),
    }


def _uneven_halves(rng, B: int, H: int) -> dict:
    """A GAN batch whose second half (rank 1's rows) has twice the first
    half's amplitude: its activations, and so their int8 scale, are larger."""
    amp = np.repeat([0.5, 1.0], B // 2)[:, None, None, None].astype(np.float32)
    return {"feature_map": (rng.uniform(size=(B, H, H, 1)) > 0.8).astype(np.float32) * amp,
            "cand_image": rng.uniform(-1, 1, (B, H, H, 12)).astype(np.float32) * amp,
            "tgt_image": rng.uniform(-1, 1, (B, H, H, 3)).astype(np.float32) * amp}


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """(work directory, inputs, [rank 0's results, rank 1's])."""
    work = tmp_path_factory.mktemp("dp")
    inp = _inputs()
    torch.save({k: v for k, v in inp.items() if not k.endswith("_jax")}, work / "inputs.pt")
    port = _free_port()
    procs = []
    for r in range(2):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
                   MASTER_ADDR="localhost", MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, WORKER, str(work)], env=env, cwd=REPO,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    try:
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return work, inp, [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(2)]


def _before_training_bn(name: str, state: dict) -> bool:
    """A bias ``X.k.bias`` followed by the BatchNorm ``X.{k+1}``: the batch
    mean removes it, so its true gradient is zero."""
    head, _, leaf = name.rpartition(".")
    parent, _, k = head.rpartition(".")
    return leaf == "bias" and k.isdigit() and f"{parent}.{int(k) + 1}.running_mean" in state


def _check_grads(got: dict, want: dict, state: dict, tol: float, floor: float) -> float:
    """Each gradient within tol of its reference's norm (floored for the
    zero-true-gradient biases); returns the largest relative error."""
    want = {n: want[n] for n in got}  # the parameters (a JAX tree also carries BN stats)
    largest = max(float(torch.linalg.vector_norm(w)) for w in want.values())
    worst = 0.0
    for n, w in want.items():
        err = float(torch.linalg.vector_norm(got[n].to(w.dtype) - w))
        ref = float(torch.linalg.vector_norm(w))
        bound = floor * largest if _before_training_bn(n, state) else tol * ref
        assert err <= bound, (n, err, ref)
        if not _before_training_bn(n, state):
            worst = max(worst, err / max(ref, 1e-30))
    return worst


def _one_process(model, loss_fn, batch) -> dict:
    """step_case of the worker, in this process without a group, on the
    global batch."""
    assert not torch.distributed.is_initialized()
    return W.step_case(model, loss_fn, batch)


def _capture():
    """An optax transformation that keeps the gradient as its state."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def _jax_grads(make_step, params, batch):
    new, metrics = make_step(_capture())(create_state(params, _capture()),
                                         {k: jnp.asarray(v) for k, v in batch.items()})
    return params_from_jax(to_np(new.opt_state)), float(metrics["loss"])


def _check_step(name, ranks, model, loss_fn, batch, jax_grads, jax_loss):
    one = _one_process(model, loss_fn, batch)
    r0, r1 = ranks[0][name], ranks[1][name]
    # the ranks' mean loss is the global batch's; the reduced gradients and
    # the updated parameters are the same bytes on both ranks
    np.testing.assert_allclose((r0["loss"] + r1["loss"]) / 2, one["loss"], rtol=1e-6)
    for k in r0["grads"]:
        assert torch.equal(r0["grads"][k], r1["grads"][k]), k
    for k in r0["state"]:
        assert torch.equal(r0["state"][k], r1["state"][k]), k
    sd = model.state_dict()
    _check_grads(r0["grads"], one["grads"], sd, F32_TOL, ZERO_GRAD_FLOOR)
    _check_grads(r0["grads"], jax_grads, sd, JAX_TOL, ZERO_GRAD_FLOOR)
    np.testing.assert_allclose(one["loss"], jax_loss, rtol=1e-5)
    # parameters and running statistics after Adam, less the zero-true-gradient
    # biases (Adam's first step moves them by +-lr whatever the noise's size)
    for k, v in one["state"].items():
        if not _before_training_bn(k, sd):
            np.testing.assert_allclose(r0["state"][k].numpy(), v.numpy(), rtol=0, atol=1e-6,
                                       err_msg=k)


def test_audio2feature_step_two_ranks_match_one_process_and_jax(dp, monkeypatch):
    monkeypatch.setattr(j_nn, "BN_ONEPASS", False)  # the port's two-pass variance
    _, inp, ranks = dp
    cfg = Audio2FeatureConfig(**W.A2F)
    model = t_a2f.Audio2Feature(cfg)
    model.load_state_dict(inp["a2f"])
    jcfg = jconfig.Audio2FeatureConfig(**W.A2F)
    jg, jl = _jax_grads(lambda tx: j_steps.make_a2f_step(jcfg, tx, donate=False),
                        inp["a2f_jax"], inp["a2f_batch"])
    _check_step("a2f", ranks, model, lambda m, b: t_steps.a2f_loss(cfg, m, b),
                inp["a2f_batch"], jg, jl)


def test_apc_step_two_ranks_match_one_process_and_jax(dp):
    _, inp, ranks = dp
    cfg = APCConfig(**W.APC)
    model = t_apc.APCPretrain(cfg)
    model.load_state_dict(inp["apc"])
    jcfg = jconfig.APCConfig(**W.APC)
    jg, jl = _jax_grads(lambda tx: j_steps.make_apc_step(jcfg, tx, donate=False),
                        inp["apc_jax"], inp["apc_batch"])
    _check_step("apc", ranks, model, lambda m, b: t_steps.apc_loss(cfg, m, b),
                inp["apc_batch"], jg, jl)


def test_fused_gan_step_two_ranks_match_one_process(dp):
    """JAX tests/test_parallel.py:178-219's step (ngf 4, 5 downsamplings,
    32^2, num_D 2), in float64: losses, both networks' reduced gradients and
    every training BatchNorm's running statistics (the global batch's)."""
    _, inp, ranks = dp
    cfg = Feature2FaceConfig(**W.F2F)
    g, d = t_f2f.Feature2FaceG(cfg), t_f2f.Feature2FaceD(cfg)
    g.load_state_dict(inp["gan_g"])
    d.load_state_dict(inp["gan_d"])
    g, d = g.double(), d.double()
    batch = {k: v.double() for k, v in _t(inp["gan_batch"]).items()}
    loss_d, loss_g, metrics = t_steps.f2f_fused_losses(cfg, g, d, batch)
    d_grads = t_state.gradients(loss_d, list(d.parameters()), retain_graph=True)
    g_grads = t_state.gradients(loss_g, list(g.parameters()))
    r0, r1 = ranks[0]["gan"], ranks[1]["gan"]
    for k, v in metrics.items():
        np.testing.assert_allclose((r0["metrics"][k] + r1["metrics"][k]) / 2, v.item(),
                                   rtol=1e-12, atol=1e-15, err_msg=k)
    for net, grads, key in ((d, d_grads, "d_grads"), (g, g_grads, "g_grads")):
        want = dict(zip([n for n, _ in net.named_parameters()], grads))
        _check_grads(r0[key], want, net.state_dict(), F64_TOL, 1e-12)
        for k in want:
            assert torch.equal(r0[key][k], r1[key][k]), k
    stats = {**{f"G.{k}": v for k, v in g.state_dict().items() if "running" in k},
             **{f"D.{k}": v for k, v in d.state_dict().items() if "running" in k}}
    assert stats.keys() == r0["stats"].keys() and len(stats) > 40
    for k, v in stats.items():
        np.testing.assert_allclose(r0["stats"][k].numpy(), v.numpy(), rtol=1e-12, atol=1e-14,
                                   err_msg=k)


@pytest.mark.parametrize("mode", ["qat", "qat_int8"])
def test_qat_step_two_ranks_use_one_activation_scale(dp, mode):
    """--data_parallel --qat / --qat_int8: the "fq" / "fq8" generator's
    dynamic activation scale is the amax of the global batch
    (nn_core.activation_scale reduces it over the ranks, as JAX's jnp.max
    over the global array), so two ranks whose halves differ twofold in
    amplitude take the one process's step on the global batch: the ranks'
    mean metrics, both networks' reduced gradients and the running
    statistics at _check_step's f32 tolerances.  With a scale per rank, each
    half snaps to its own int8 grid and the step is another one."""
    _, inp, ranks = dp
    cfg = Feature2FaceConfig(**W.F2F)
    g, d = t_f2f.Feature2FaceG(cfg), t_f2f.Feature2FaceD(cfg)
    g.load_state_dict(inp["gan_g"])
    d.load_state_dict(inp["gan_d"])
    one = W.gan_grads(cfg, t_f2f.qat_generator(g, int8_forward=mode == "qat_int8"), d,
                      _t(inp["qat_batch"]))
    r0, r1 = ranks[0][mode], ranks[1][mode]
    for k, v in one["metrics"].items():
        np.testing.assert_allclose((r0["metrics"][k] + r1["metrics"][k]) / 2, v, rtol=1e-6,
                                   err_msg=k)
    for net, key in ((d, "d_grads"), (g, "g_grads")):
        _check_grads(r0[key], one[key], net.state_dict(), F32_TOL, ZERO_GRAD_FLOOR)
        for k in r0[key]:
            assert torch.equal(r0[key][k], r1[key][k]), k
    for k, v in one["stats"].items():
        np.testing.assert_allclose(r0["stats"][k].numpy(), v.numpy(), rtol=0, atol=1e-6,
                                   err_msg=k)


def test_qat_gan_trainer_two_ranks_writes_its_panel(dp):
    """One epoch of the GAN trainer with data_parallel and qat: every rank
    runs the epoch panel's forward (a lone rank would wait forever in the
    activation scale's all-reduce), rank 0 writes it."""
    work, _, _ = dp
    web = work / "qat" / "f2f" / "web"
    assert any(web.rglob("*.png")) or any(web.rglob("*.jpg")), sorted(web.rglob("*"))


def test_vgg_style_loss_two_ranks_match_one_process(dp):
    """The style term's Gram matrices are batch means: two ranks average
    them (mesh.all_reduce_sum) before the difference, so the style term is
    the global batch's on both ranks, the perceptual term's mean over the
    ranks is the global one, and each rank's gradient toward its rows is
    the global gradient's rows times the rank count (its backward carries
    the other rank's terms; the ranks' parameter gradients are averaged).
    A random VGG19 at 32^2, float64."""
    _, inp, ranks = dp
    vgg = t_losses.init_vgg19(0).double()
    x = torch.from_numpy(inp["vgg_batch"]["x"]).double().requires_grad_(True)
    p, s = t_losses.vgg_style_loss(vgg, x, torch.from_numpy(inp["vgg_batch"]["y"]).double())
    (gx,) = torch.autograd.grad(p + s, x)
    assert s.item() > 0
    np.testing.assert_allclose((ranks[0]["vgg"]["p"] + ranks[1]["vgg"]["p"]) / 2, p.item(),
                               rtol=1e-12)
    for r, rows in zip(ranks, (slice(0, 2), slice(2, 4))):
        np.testing.assert_allclose(r["vgg"]["s"], s.item(), rtol=1e-12)
        np.testing.assert_allclose(r["vgg"]["gx"].numpy(), 2 * gx[rows].numpy(), rtol=1e-9,
                                   atol=1e-9 * float(gx.abs().max()))


def test_zero1_is_replicated_adam_bitwise_on_half_the_state(dp):
    _, _, ranks = dp
    for r in ranks:
        gan = r["gan"]
        for net in ("G", "D"):
            for k, v in gan["replicated"][net].items():
                assert torch.equal(gan["zero1"][net][k], v), (net, k)
            share = gan["state_bytes"][net] / gan["replicated_state_bytes"][net]
            assert 0.4 < share < 0.6, (net, share)
            # the consolidated state dict is replicated Adam's, in its format
            z, p = gan["zero1_opt"][net], gan["replicated_opt"][net]
            assert z["param_groups"] == p["param_groups"]
            assert z["state"].keys() == p["state"].keys()
            for i in p["state"]:
                for k, v in p["state"][i].items():
                    assert torch.equal(z["state"][i][k], v), (net, i, k)
    for net in ("G", "D"):
        assert (ranks[0]["gan"]["state_bytes"][net] + ranks[1]["gan"]["state_bytes"][net]
                == ranks[0]["gan"]["replicated_state_bytes"][net])
        for k, v in ranks[0]["gan"]["zero1"][net].items():
            assert torch.equal(ranks[1]["gan"]["zero1"][net][k], v), (net, k)


def test_trainer_zero1_checkpoint_resumes_without_zero1(dp):
    """Two epochs of the A2F trainer on two ranks (global batch 4, a
    validation set of 5 windows whose tail batch of 1 does not divide over
    the ranks and runs on both, as JAX replicates its evaluation batches):
    the ZeRO-1 run's checkpoints equal the replicated run's bitwise, only
    rank 0 logged, and the ZeRO-1 checkpoint resumes in one process without
    a group or ZeRO-1, as the replicated one does."""
    work, _, _ = dp
    a, b = (ckpt.load_checkpoint(str(work / k / "a2f" / "ckpt")) for k in ("zero1", "replicated"))
    assert a["epoch"] == b["epoch"] == 2 and a["best_val"] == b["best_val"]
    assert np.isfinite(a["best_val"])
    for k, v in b["models"]["params"].items():
        assert torch.equal(a["models"]["params"][k], v), k
    for i, s in b["optimizers"]["params"]["state"].items():
        for k, v in s.items():
            assert torch.equal(a["optimizers"]["params"]["state"][i][k], v), (i, k)
    iters = [line for line in (work / "zero1" / "a2f" / "loss_log.txt").read_text().splitlines()
             if line.startswith("(epoch")]
    assert len(iters) == 2 * (11 // W.GLOBAL_BATCH)  # one line a step, from rank 0 alone
    resumed = {}
    for k in ("zero1", "replicated"):
        clips = cli.synthetic_clips(1, 200)
        sampler = datasets.AudioVisualSampler(clips, task="audio2feature", seq_len=32,
                                              frame_jump_stride=12, tail_margin=60,
                                              device_audio=True)
        loop = trainer.TrainLoopConfig(n_epochs=2, n_epochs_decay=1, batch_size=W.GLOBAL_BATCH,
                                       checkpoints_dir=str(work / k), name="a2f",
                                       device="cpu", prefetch=0, continue_train=True)
        cfg = Audio2FeatureConfig(apc_hidden_size=512, lstm_hidden_size=16, output_dim=75)
        res = trainer.train_audio2feature(cfg, loop, sampler)
        assert res.epochs == 3 and len(res.step_ms) == 11 // W.GLOBAL_BATCH
        resumed[k] = res.models["params"].state_dict()
    for k, v in resumed["replicated"].items():
        assert torch.equal(resumed["zero1"][k], v), k


def test_ranks_refuse_what_does_not_divide(dp):
    _, _, ranks = dp
    assert [r["primary"] for r in ranks] == [True, False]
    for r in ranks:
        assert r["refusal"] == ("global_batch=3 must be a positive multiple of process_count=2: "
                                "truncating would silently drop rows and break the mesh's "
                                "data-axis layout")
    with pytest.raises(ValueError, match="needs data_parallel=True"):
        trainer._device(trainer.TrainLoopConfig(zero1=True, device="cpu"))


def test_one_rank_group_equals_no_group(monkeypatch):
    """A group of one rank (no torchrun environment: JAX's one-device mesh)
    runs the all-reduce and F.batch_norm, and changes no bit."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    inp = _inputs()
    cfg = Audio2FeatureConfig(**W.A2F)

    def run():
        model = t_a2f.Audio2Feature(cfg)
        model.load_state_dict(inp["a2f"])
        return W.step_case(mesh.replicate(model), lambda m, b: t_steps.a2f_loss(cfg, m, b),
                           multihost.shard_batch(inp["a2f_batch"], W.GLOBAL_BATCH))

    want = run()
    assert multihost.initialize("cpu") == torch.device("cpu")
    try:
        assert multihost.world_size() == 1 and multihost.is_primary()
        got = run()
    finally:
        multihost.shutdown()
    assert got["loss"] == want["loss"]
    for k in want["grads"]:
        assert torch.equal(got["grads"][k], want["grads"][k]), k
    for k in want["state"]:
        assert torch.equal(got["state"][k], want["state"][k]), k


# ---------------------------------------------------------------------------
# the render split and the data-parallel Predictor
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def person():
    cfg = torch_config(small_person_config(image_size=32))
    return (cfg, *assets.make_synthetic_person(cfg, image_size=32, device="cpu"))


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_render_split_over_two_devices(person, int8):
    """animate(render_devices=["cpu", "cpu"]) splits each batch of 8 into
    two shares of 4 (JAX tests/test_parallel.py:118-139, and :222-243 with
    the calibrated int8 renderer): frames within one level of one device's;
    a batch that does not divide raises."""
    cfg, a, m = person
    audio = video.make_test_tone(0.7)
    if int8:
        calib = animate.build_render_inputs(cfg, a, m, audio, max_frames=8)
        m = assets.quantize_person_models(m, calibrate_inputs=calib)
    ref = animate.animate(cfg, a, m, audio, render_batch=8, keep_feature_maps=True)
    out = animate.animate(cfg, a, m, audio, render_batch=8, keep_feature_maps=True,
                          render_devices=["cpu", "cpu"])
    assert out.frames.shape == ref.frames.shape and out.nframe == ref.nframe
    assert np.abs(out.frames.astype(int) - ref.frames.astype(int)).max() <= 1
    np.testing.assert_array_equal(out.feature_maps, ref.feature_maps)
    np.testing.assert_array_equal(out.landmarks, ref.landmarks)
    with pytest.raises(ValueError, match="must divide over the data axis"):
        animate.animate(cfg, a, m, audio, render_batch=3, render_devices=["cpu", "cpu"])


def test_data_parallel_predictor_equals_one_device(person, tmp_path, monkeypatch):
    """Predictor.setup(data_parallel=True) on the CPU: the data axis is the
    one device (mesh.make_mesh), the split the identity, the frames the same
    bytes as data_parallel=False, int8 from one artifact."""
    cfg = person[0]
    monkeypatch.setattr(serve, "PersonConfig", lambda name="Synthetic": cfg)
    art = str(tmp_path / "model.npz")
    serve.Predictor(device="cpu").setup(image_size=32, quantize=True, artifact=art)
    results = []
    for data_parallel in (True, False):
        p = serve.Predictor(max_audio_seconds=1.0, device="cpu",
                            results_dir=str(tmp_path / str(data_parallel)))
        p.setup(image_size=32, artifact=art, data_parallel=data_parallel)
        assert p._render_devices == ([torch.device("cpu")] if data_parallel else None)
        results.append(p.predict(video.make_test_tone(0.8), write_video=False, render_batch=8))
    assert results[0].nframe == results[1].nframe == 48 - 15
    np.testing.assert_array_equal(results[0].frames, results[1].frames)
    assert mesh.make_mesh("cpu") == [torch.device("cpu")]
