"""The model axis of the PyTorch port on the CPU: a (data, model) grid of
four gloo ranks, 2 x 2 (parallel.mesh.make_grid), channel and spatial
partitioning (parallel.sharding) and the dry run (parallel.dryrun).

One module-scoped launch of four processes (tests/_torch_mp_worker.py)
serves every case that needs ranks.  The references are the JAX package's
sharded programs on the 8 virtual CPU devices of this process
(tests/conftest.py), at JAX's own sizes and tolerances
(tests/test_parallel.py:86-116, 246-283, 384-430):
- the channel-sharded generator's forward (ngf 8, 5 downsamplings, 32^2)
  against JAX's, its parameters sharded over a 2 x 4 mesh, atol 2e-5;
- the spatial forward (64^2) against JAX's shard_spatial forward over
  ("data", "model"), atol 2e-5, each rank holding only its rows; its int8
  form (dynamic scales) against the one-device int8 forward, each int8
  conv's rows bit for bit;
- the QAT fused GAN step on the 2 x 2 grid against JAX's
  make_f2f_fused_step under make_mesh(2): losses rel 1e-4, every
  parameter and BatchNorm statistic after the SGD step atol 5e-4 (JAX's
  training BatchNorm in its two-pass form, which the port computes);
- ZeRO-1 over the data group bitwise against replicated Adam on half the
  state; the replicated leaves equal on both model ranks; the gathered
  state dicts load strictly into one-device networks.
"""

from __future__ import annotations

import ast
import copy
import os
import re
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import _torch_mp_worker as W
from livespeechportraits_torch.config import Feature2FaceConfig as TConfig
from livespeechportraits_torch.models import feature2face as t_f2f
from livespeechportraits_torch.parallel import dryrun as t_dryrun
from livespeechportraits_torch.parallel import mesh as t_mesh
from livespeechportraits_torch.parallel import sharding as t_sharding
from livespeechportraits_torch.pipeline.assets import REWRITE_FORMS
from livespeechportraits_torch.utils.convert import params_from_jax
from livespeechportraits_tpu.config import Feature2FaceConfig
from livespeechportraits_tpu.models import feature2face as j_f2f
from livespeechportraits_tpu.models import nn_core as j_nn
from livespeechportraits_tpu.parallel import mesh as j_mesh
from livespeechportraits_tpu.parallel import sharding as j_sharding
from livespeechportraits_tpu.train import state as j_state
from livespeechportraits_tpu.train import steps as j_steps
from torch_parity import to_np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_mp_worker.py")
FWD_ATOL = 2e-5  # JAX's sharded forwards against one device
LOSS_RTOL = 1e-4  # JAX's QAT step under a mesh against one device
PARAM_ATOL = 5e-4
QAT64_TOL = 1e-7  # the float64 "fq" step's gradients against one process, of their norm
ZERO_GRAD_FLOOR = 1e-3  # a zero-true-gradient tensor: share of its network's largest norm


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_net(cfg: Feature2FaceConfig, seed: int) -> dict:
    return j_f2f.init_generator(jax.random.PRNGKey(seed), cfg)


def _inputs() -> dict:
    rng = np.random.default_rng(21)
    qcfg = Feature2FaceConfig(**W.QAT)
    kg, kd = jax.random.split(jax.random.PRNGKey(11))
    B, H = W.QAT_BATCH, W.QAT["load_size"]
    return {
        "tp_jax": _jax_net(Feature2FaceConfig(**W.TP), 0),
        "tp_x": rng.normal(size=(2, 32, 32, 13)).astype(np.float32),
        "sp_jax": _jax_net(Feature2FaceConfig(**W.SPATIAL), 4),
        "sp_x": rng.normal(size=(2, 64, 64, 13)).astype(np.float32),
        "qat_jax_g": j_f2f.init_generator(kg, qcfg),
        "qat_jax_d": j_f2f.init_discriminator(kd, qcfg),
        "qat_batch": {"feature_map": rng.uniform(0, 1, (B, H, H, 1)).astype(np.float32),
                      "cand_image": rng.uniform(-1, 1, (B, H, H, 12)).astype(np.float32),
                      "tgt_image": rng.uniform(-1, 1, (B, H, H, 3)).astype(np.float32)},
    }


@pytest.fixture(scope="module")
def grid_run(tmp_path_factory):
    """(inputs, [the four ranks' results])."""
    work = tmp_path_factory.mktemp("mp")
    inp = _inputs()
    torch.save({"tp_g": params_from_jax(to_np(inp["tp_jax"])), "tp_x": inp["tp_x"],
                "sp_g": params_from_jax(to_np(inp["sp_jax"])), "sp_x": inp["sp_x"],
                "qat_g": params_from_jax(to_np(inp["qat_jax_g"])),
                "qat_d": params_from_jax(to_np(inp["qat_jax_d"])),
                "qat_batch": inp["qat_batch"]}, work / "inputs.pt")
    port = _free_port()
    procs = []
    for r in range(4):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="4",
                   MASTER_ADDR="localhost", MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, WORKER, str(work)], env=env, cwd=REPO,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return inp, [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(4)]


@pytest.mark.parametrize("shape,want,jax_spec", [
    ((16, 8, 3, 3), 0, P(None, None, None, "model")),  # conv [O, I, kh, kw]
    ((16,), 0, P("model")),  # a per-channel vector
    ((6, 8, 3, 3), None, P()),  # 6 output channels over 4: replicated
    ((), None, P()),  # a scalar
], ids=["conv", "vector", "not_divisible", "scalar"])
def test_param_partition_spec_is_jaxs_rule_in_torch_layout(shape, want, jax_spec):
    """JAX's four cases (tests/test_parallel.py:108-115), each leaf in torch's
    layout (a conv's output channels in dim 0, JAX's last axis)."""
    t = torch.zeros(shape)
    assert t_sharding.param_partition_spec("w", t, 4) == want
    jax_shape = shape[2:] + shape[1::-1] if len(shape) == 4 else shape
    assert j_sharding.param_partition_spec((), np.zeros(jax_shape), 4) == jax_spec


def test_grid_lays_ranks_as_jax_reshapes_devices(grid_run):
    """Rank r at data index r // 2 and model index r % 2, JAX's
    reshape(n // mp, mp); each rank's groups are its column and its row."""
    _, ranks = grid_run
    for r, res in enumerate(ranks):
        assert res["grid"]["data"] == (2, r // 2, (r % 2, r % 2 + 2))
        assert res["grid"]["model"] == (2, r % 2, (r // 2 * 2, r // 2 * 2 + 1))
    with pytest.raises(ValueError, match="not divisible by model_parallel_size=2"):
        t_mesh.make_grid(2)  # one rank outside a group


def test_channel_sharded_generator_forward_matches_jax(grid_run):
    """JAX's test_model_parallel_generator_forward_matches (its weights
    sharded over a 2 x 4 mesh) against the port's over 2 x 2: each data
    rank's rows within 2e-5, every divisible leaf held as its half."""
    inp, ranks = grid_run
    m = j_mesh.make_mesh(4)
    net = j_sharding.shard_params(m, inp["tp_jax"]["net"], model_size=4)
    x = jax.device_put(jnp.asarray(inp["tp_x"]), NamedSharding(m, P("data", None, None, None)))
    y_ref = np.asarray(jax.jit(lambda n, v: j_f2f.apply_generator(
        {"net": n, "size": "normal"}, v)[0])(net, x))
    full = t_f2f.Feature2FaceG(TConfig(**W.TP)).state_dict()
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["tp"]["y"].numpy(), y_ref[r // 2:r // 2 + 1],
                                   atol=FWD_ATOL, rtol=0)
        shapes = res["tp"]["shapes"]
        assert res["tp"]["sharded_keys"]
        for k, v in full.items():
            want = ((v.shape[0] // 2, *v.shape[1:]) if k in res["tp"]["sharded_keys"]
                    else tuple(v.shape))
            assert shapes[k] == want, k
        # the to-RGB conv's 3 channels do not divide: replicated
        assert "netG.model.model.5.weight" not in res["tp"]["sharded_keys"]


def test_spatial_forward_matches_jax_and_stays_sharded(grid_run):
    """JAX's test_spatial_partitioned_renderer_matches_single_device, the
    height over "model" composed with the batch over "data": each rank
    holds 32 of the 64 rows of its data rank's one sample, and its output
    rows are JAX's within 2e-5."""
    inp, ranks = grid_run
    m = j_mesh.make_mesh(4)
    net = j_mesh.replicate(m, inp["sp_jax"]["net"])
    xds = jax.device_put(jnp.asarray(inp["sp_x"]), NamedSharding(m, P("data", "model", None,
                                                                      None)))
    y = jax.jit(lambda n, v: j_f2f.apply_generator({"net": n, "size": "normal"}, v)[0])(net, xds)
    assert "model" in jax.tree.leaves(tuple(y.sharding.spec))
    y_ref = np.asarray(y)
    for r, res in enumerate(ranks):
        sp = res["spatial"]
        b, j = r // 2, r % 2
        assert sp["x_rows"] == (1, 32, 64, 13) and tuple(sp["y"].shape) == (1, 32, 64, 3)
        np.testing.assert_allclose(sp["y"].numpy(), y_ref[b:b + 1, 32 * j:32 * (j + 1)],
                                   atol=FWD_ATOL, rtol=0)
        np.testing.assert_allclose(sp["gathered"].numpy(), y_ref[b:b + 1], atol=FWD_ATOL,
                                   rtol=0)
        assert sp["exchanged"] > 0
        # the int8 renderer with dynamic scales: the amax over the data and the
        # model ranks is the whole batch's, so every int8 conv's rows are the
        # one-device forward's bit for bit (the exact int32 sums of K4's twin)
        q = sp["int8"]
        assert q["layers"] == q["one_device_layers"] == q["bitwise"] == 26


def _jax_rewritten(tree: dict, form: str) -> dict:
    """JAX assets.transform_person_models' rewrites of one generator tree."""
    kw = REWRITE_FORMS[form]
    if kw.get("subpixel"):
        tree = j_f2f.subpixel_generator(tree, mode=kw["subpixel"])
    if kw.get("s2d_input"):
        tree = j_f2f.s2d_input_generator(tree)
    if kw.get("split_skip"):
        tree = j_f2f.split_skip_generator(tree)
    return tree


@pytest.mark.parametrize("form", W.SPATIAL_FORMS)
def test_rewritten_spatial_forward_matches_jax_and_one_device(grid_run, form):
    """The rewritten trees under spatial partitioning, as JAX's GSPMD forward
    takes them: each rank's 32 rows of the float tree within 2e-5 of JAX's
    jitted forward of JAX's own rewrite, its height over "model" and its
    batch over "data"; and in int8 with dynamic scales every int8 layer's
    rows, the rewritten up convs' included, bitwise the port's one-device
    forward's, as many layers tapped as that forward runs."""
    inp, ranks = grid_run
    m = j_mesh.make_mesh(4)
    tree = _jax_rewritten({"net": inp["sp_jax"]["net"], "size": "normal"}, form)
    net = j_mesh.replicate(m, tree["net"])
    xds = jax.device_put(jnp.asarray(inp["sp_x"]), NamedSharding(m, P("data", "model", None,
                                                                      None)))
    y_ref = np.asarray(jax.jit(lambda n, v: j_f2f.apply_generator(
        {"net": n, "size": "normal"}, v)[0])(net, xds))
    up = t_f2f.int8_up_convs(TConfig(**W.SPATIAL))
    n_rewritten = sum(1 for *_, n_a in up if n_a) if "split" in form else len(up)
    for r, res in enumerate(ranks):
        got = res["spatial"]["forms"][form]
        b, j = r // 2, r % 2
        np.testing.assert_allclose(got["y"].numpy(), y_ref[b:b + 1, 32 * j:32 * (j + 1)],
                                   atol=FWD_ATOL, rtol=0)
        q = got["int8"]
        assert q["layers"] == q["one_device_layers"] == q["bitwise"] == 26, q
        assert q["rewritten_layers"] == n_rewritten


def test_spatial_forward_refuses_what_it_does_not_take():
    """A channel-sharded tree and rows that do not divide raise before any
    collective; shard_params refuses the 'small' U-Net."""
    g = t_f2f.Feature2FaceG(TConfig(**W.TP))
    one = t_mesh.make_grid(1)
    x = torch.zeros(1, 32, 32, 13)
    two = t_mesh.Grid(1, 2, 0, 0, None, None, (0,), (0, 1))
    with pytest.raises(ValueError, match="whole channels"):
        t_sharding.apply_generator_spatial(t_sharding.shard_params(copy.deepcopy(g), two), x,
                                           one)
    with pytest.raises(ValueError, match="divisible by the model axis"):
        t_sharding.shard_spatial(torch.zeros(1, 13, 33, 32), two)
    small = t_f2f.Feature2FaceG(TConfig(size="small", ngf=8, n_downsample=5, load_size=32))
    with pytest.raises(ValueError, match="'small'"):
        t_sharding.shard_params(small, two)


def _jax_qat_step(inp):
    cfg = Feature2FaceConfig(**W.QAT)
    g = j_f2f.qat_generator(inp["qat_jax_g"])
    tx = optax.sgd(W.LR)
    step = j_steps.make_f2f_fused_step(cfg, tx, tx, donate=False)
    mesh = j_mesh.make_mesh(2)  # 4 data x 2 model
    gp = j_state.create_state(j_sharding.shard_params(mesh, g["net"], model_size=2), tx)
    dp = j_state.create_state(j_sharding.shard_params(mesh, inp["qat_jax_d"], model_size=2), tx)
    return step(gp, dp, j_mesh.shard_batch(mesh, inp["qat_batch"]))


def test_qat_gan_step_on_the_grid_matches_jax(grid_run, monkeypatch):
    """JAX's test_qat_gan_step_dp_tp_matches_single_device: the fused QAT
    step with G and D channel-sharded over the model axis and the batch over
    the data axis (4 rows a data rank), its losses and, after SGD, every
    parameter and running statistic of both networks (gathered) within
    JAX's tolerances; each rank holds half of every divisible leaf, and the
    replicated leaves are the same bytes on both model ranks."""
    monkeypatch.setattr(j_nn, "BN_ONEPASS", False)
    inp, ranks = grid_run
    g1, d1, m1 = _jax_qat_step(inp)
    q = ranks[0]["qat"]
    assert q["rows"] == 4
    assert q["loss_G"] == pytest.approx(float(m1["loss_G"]), rel=LOSS_RTOL)
    assert q["loss_D"] == pytest.approx(float(m1["loss_D"]), rel=LOSS_RTOL)
    want = {"G": params_from_jax(to_np(j_f2f.strip_qat_generator(
                {"net": g1.params, "size": "normal"}))),
            "D": params_from_jax(to_np(d1.params))}
    for net in ("G", "D"):
        got = q[f"{net}_full"]
        assert set(got) == set(want[net])
        for k, v in want[net].items():
            np.testing.assert_allclose(got[k].double().numpy(), v.double().numpy(),
                                       atol=PARAM_ATOL, rtol=0, err_msg=f"{net} {k}")
        for a, b in ((0, 1), (2, 3)):  # the model ranks of each data index
            ra, rb = ranks[a]["qat"], ranks[b]["qat"]
            assert ra[f"{net}_slices"] and ra[f"{net}_slices"] == rb[f"{net}_slices"]
            for k, v in ra[f"{net}_replicated"].items():
                assert torch.equal(v, rb[f"{net}_replicated"][k]), (net, k)
        for k, shape in q[f"{net}_slices"].items():
            assert shape[0] * 2 == want[net][k].shape[0], (net, k)
    for r in ranks[1:]:  # the data ranks reduced the same gradients
        for net in ("G", "D"):
            for k, v in q[f"{net}_full"].items():
                assert torch.equal(r["qat"][f"{net}_full"][k], v), (net, k)


def test_qat_step_grads_on_the_grid_match_one_process_in_float64(grid_run):
    """The channel-sharded "fq" fused step in float64: each network's
    gradients, reduced over the data axis and gathered over the model axis,
    within 1e-7 of their norm of one process's on the global batch, for G
    and D alike (a tensor whose true gradient is zero held to 1e-3 of its
    network's largest norm).  In float64 an int8 code tips only where a
    value lies within ~1e-15 of a rounding boundary, so a wider gap is a
    fault of the sharded path, not rounding.  Both data ranks reduce the
    same gradients."""
    _, ranks = grid_run
    one = ranks[0]["qat64"]["one_process"]
    for net in ("G", "D"):
        got, want = ranks[0]["qat64"]["grid"][net], one[net]
        assert len(got) == len(want)
        floor = ZERO_GRAD_FLOOR * max(float(w.norm()) for w in want)
        err = max(float((a - b).norm()) / max(float(b.norm()), floor)
                  for a, b in zip(got, want))
        assert err <= QAT64_TOL, (net, err)
        assert all(a.dtype == torch.float64 for a in got)
        for r in ranks[1:]:
            for a, b in zip(r["qat64"]["grid"][net], got):
                assert torch.equal(a, b), net


def test_full_state_dict_loads_strictly_into_one_device_networks(grid_run):
    """A state dict written under the grid is the one-device networks'."""
    _, ranks = grid_run
    q = ranks[0]["qat"]
    g = t_f2f.Feature2FaceG(TConfig(**W.QAT))
    g.load_state_dict(q["G_full"], strict=True)
    d = t_f2f.Feature2FaceD(TConfig(**W.QAT))
    d.load_state_dict(q["D_full"], strict=True)


def test_zero1_over_the_data_group_is_replicated_adam_on_half_the_state(grid_run):
    """JAX's zero1_place composed with the channel sharding
    (tests/test_parallel.py:384-401): each model rank partitions its slices'
    moments over its data group, bitwise replicated Adam, the two data ranks
    of one model index holding the slices' state between them."""
    _, ranks = grid_run
    for r, res in enumerate(ranks):
        for net in ("G", "D"):
            z = res["zero1"][net]
            assert z["equal"], (r, net)
            assert z["owners"] == [r % 2, r % 2 + 2]
            assert 0.4 < z["state_bytes"] / z["replicated_state_bytes"] < 0.6, (r, net)
    for a, b in ((0, 2), (1, 3)):
        for net in ("G", "D"):
            za, zb = ranks[a]["zero1"][net], ranks[b]["zero1"][net]
            assert za["state_bytes"] + zb["state_bytes"] == za["replicated_state_bytes"]


def test_dryrun_multichip_on_four_cpu_ranks(grid_run):
    """parallel.dryrun's grid on the four ranks of a group (run_rank, what
    dryrun_multichip runs under torchrun): the mesh rule's 2 x 2 and JAX's
    line."""
    _, ranks = grid_run
    line = ranks[0]["dryrun"]
    assert line.startswith("dryrun_multichip ok: mesh=(2x2) loss_D=")
    assert line.endswith("sp_render=ok int8_dp_serve=ok")
    assert all(r["dryrun"] == line for r in ranks)


DRYRUN_LINE = re.compile(r"dryrun_multichip ok: mesh=\((\d+)x(\d+)\) loss_D=(-?\d+\.\d{4}) "
                         r"loss_G=(-?\d+\.\d{4}) sp_render=ok int8_dp_serve=ok$")


def test_dryrun_multichip_scales_to_two_and_four_times_the_ranks():
    """dryrun_multichip(1, device="cpu") as JAX's dryrun_multichip(1): the
    requested (1x1) grid, then (1x2) and (2x2) on 2 and 4 CPU ranks that the
    call spawns, one line each in JAX's format; (1x1) and (1x2) train on the
    same rows, so their losses agree within 1e-4 relative."""
    code = ("from livespeechportraits_torch.parallel import dryrun; "
            "print(repr(dryrun.dryrun_multichip(1, 'cpu')))")
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert run.returncode == 0, run.stderr[-3000:]
    lines = ast.literal_eval(run.stdout.strip().splitlines()[-1])
    found = [DRYRUN_LINE.match(line) for line in lines]
    assert all(found), lines
    assert [(m[1], m[2]) for m in found] == [("1", "1"), ("1", "2"), ("2", "2")]
    for k in (3, 4):
        assert float(found[1][k]) == pytest.approx(float(found[0][k]), rel=1e-4)


@pytest.mark.parametrize("n,want", [(1, [2, 4]), (2, [4, 8]), (4, [8, 16]), (8, [16, 32]),
                                    (16, [32]), (32, [])])
def test_dryrun_larger_grids_are_jaxs(n, want):
    """JAX's n < n_big <= 32 over (2n, 4n) (__graft_entry__.py:94-96)."""
    assert t_dryrun.larger_grids(n) == want


def test_dryrun_holds_grids_of_one_data_axis_to_one_loss():
    """(4x2) and (4x4) train on the same rows: a gap above 1e-4 relative
    raises; grids of another data axis or another device are not
    compared."""
    t_dryrun._check_same_rows([(8, "cpu", (3.7414, 55.3569)), (16, "cpu", (3.7414, 55.3570)),
                               (4, "cpu", (5.9, 56.4)), (16, "cuda", (6.0, 60.0))])
    with pytest.raises(AssertionError, match="same rows"):
        t_dryrun._check_same_rows([(8, "cpu", (3.7414, 55.3569)), (16, "cpu", (3.75, 55.3569))])
