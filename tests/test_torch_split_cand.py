"""PyTorch port, split_cand: the U-Net's first conv split into its edge and
candidate halves (feature2face.precompute_cand_down / apply_generator_edge),
K1's edge-only render input and ``animate(split_cand=True)``, on the CPU
against the port's unsplit forward and against the JAX package, at test
widths (ngf 8, 5 downsamplings, 32^2 and 64^2)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livespeechportraits_tpu.config import Feature2FaceConfig
from livespeechportraits_tpu.models import feature2face as jf2f
from livespeechportraits_tpu.pipeline import animate as janimate
from livespeechportraits_tpu.pipeline import assets as jassets
from livespeechportraits_torch.models import feature2face as f2f
from livespeechportraits_torch.ops import rasterize, rasterize_cuda
from livespeechportraits_torch.pipeline import animate, assets, video
from livespeechportraits_torch.utils.convert import params_from_jax
from torch_parity import jax_headpose_noise, small_person_config, to_np, torch_config


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(size: str, seed: int = 1):
    """A JAX generator tree and the port's model on the same weights."""
    cfg = Feature2FaceConfig(size=size, ngf=8, n_downsample=5, load_size=32)
    params = to_np(jf2f.init_generator(jax.random.PRNGKey(seed), cfg))
    model = f2f.Feature2FaceG(torch_config(cfg))
    model.load_state_dict(params_from_jax(params), strict=True)
    return params, f2f.cast_generator(model.eval().requires_grad_(False), torch.float32)


def _edge_cand(seed: int = 0):
    rng = np.random.default_rng(seed)
    edge = rng.uniform(0, 1, (2, 32, 32, 1)).astype(np.float32)
    cand = rng.uniform(-1, 1, (32, 32, 12)).astype(np.float32)
    return edge, cand


def _split(model, edge, cand):
    with torch.no_grad():
        down = f2f.precompute_cand_down(model, torch.tensor(cand))
        return f2f.apply_generator_edge(model, torch.tensor(edge), down).numpy()


def _fused(model, edge, cand):
    x = np.concatenate([edge, np.broadcast_to(cand, (edge.shape[0],) + cand.shape)], -1)
    with torch.no_grad():
        return f2f.apply_generator(model, torch.tensor(x)).numpy()


def _psnr(a, b):
    return 10 * np.log10(4.0 / max(float(np.mean((a - b) ** 2)), 1e-12))  # [-1, 1] range


@pytest.mark.parametrize("size", ["small", "normal", "large"])
def test_split_matches_the_fused_forward(size):
    """The split forward against apply_generator on the concatenated 13
    planes, f32: atol 1e-5 (JAX tests/test_feature2face.py:95-120); the
    candidate half has the first conv's stride-2 shape."""
    _, model = _pair(size)
    edge, cand = _edge_cand()
    with torch.no_grad():
        down = f2f.precompute_cand_down(model, torch.tensor(cand))
    assert tuple(down.shape) == (1, 16, 16, 8)
    np.testing.assert_allclose(_split(model, edge, cand), _fused(model, edge, cand),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("size", ["small", "normal", "large"])
def test_split_matches_jax(size):
    """The port's split forward against JAX's apply_generator_edge on the
    same weights, atol 1e-5.  JAX's 'small' U-Net takes 23 input planes:
    its 22 candidate planes are the port's 12 and 10 zero ones (the port's
    'small' narrows its first conv to 13 planes)."""
    params, model = _pair(size, seed=2)
    edge, cand = _edge_cand(1)
    jcand = cand if size != "small" else np.concatenate([cand, np.zeros((32, 32, 10),
                                                                        np.float32)], -1)
    jparams = jax.tree.map(jnp.asarray, params["net"])
    jtree = {"net": jparams, "size": size}
    down = jf2f.precompute_cand_down(jtree, jnp.asarray(jcand))
    ref = jf2f.apply_generator_edge(jtree, jnp.asarray(edge), down)
    np.testing.assert_allclose(_split(model, edge, cand), np.asarray(ref), atol=1e-5, rtol=0)


def test_split_on_the_quantized_and_calibrated_trees():
    """The int8 trees keep their outermost convs float (quantize_generator),
    so they split: split against unsplit above 40 dB on the quantized tree
    and on the calibrated one (JAX tests/test_feature2face.py:160-175,
    265-280); a first conv with a bias refuses, as JAX's rewritten one
    does."""
    _, model = _pair("normal", seed=3)
    edge, cand = _edge_cand(2)
    q = f2f.fold_bn_generator(f2f.quantize_generator(model))
    x = np.concatenate([edge, np.broadcast_to(cand, (2, 32, 32, 12))], -1)
    c = f2f.calibrate_generator(q, torch.tensor(x))
    for tree in (q, c):
        y_split, y_fused = _split(tree, edge, cand), _fused(tree, edge, cand)
        assert _psnr(y_split, y_fused) > 40.0
        assert np.isfinite(y_split).all()
    biased = copy.deepcopy(model)
    first = biased.netG.model.model[0]
    first.bias = torch.nn.Parameter(torch.zeros(first.out_channels))
    with pytest.raises(ValueError, match="split_cand requires the plain outermost down conv"):
        f2f.precompute_cand_down(biased, torch.tensor(cand))


def test_edge_only_twin_is_channel_0_of_the_render_input():
    """The plain twin's edge-only form [T, H, W, 1] equals channel 0 of its
    13-channel form, bitwise, in f32 and bf16; the wrapper takes the twin on
    a CPU tensor and counts no launch."""
    rng = np.random.default_rng(4)
    lm = torch.tensor(rng.uniform(4, 60, (3, 73, 2)), dtype=torch.float32)
    sh = torch.tensor(rng.uniform(4, 60, (3, 18, 2)), dtype=torch.float32)
    launches = rasterize_cuda.LAUNCHES
    for dtype in (torch.float32, torch.bfloat16):
        cand = torch.tensor(rng.uniform(-1, 1, (64, 64, 12)), dtype=dtype)
        full = rasterize_cuda.render_input(lm, sh, cand, (64, 64))
        edge = rasterize_cuda.render_input(lm, sh, None, (64, 64), dtype=dtype)
        assert edge.shape == (3, 64, 64, 1) and edge.dtype == dtype
        assert torch.equal(edge[..., 0], full[..., 0])
        assert edge.sum() > 0
    assert rasterize.render_input(lm, sh, None, (64, 64)).dtype == torch.float32
    with pytest.raises(ValueError, match="differs from the candidates"):
        rasterize.render_input(lm, sh, cand, (64, 64), dtype=torch.float32)
    assert rasterize_cuda.LAUNCHES == launches


@pytest.fixture(scope="module")
def persons():
    """The synthetic person at 64^2, test widths, in both packages on the
    same weights, and the JAX int8 trees (quantized, then calibrated on the
    person's own render inputs) converted to the port."""
    cfg = small_person_config(image_size=64)
    j_assets, j_models = jassets.make_synthetic_person(cfg, key=jax.random.PRNGKey(5),
                                                       image_size=64)
    tcfg = torch_config(cfg)
    person, _ = assets.make_synthetic_person(tcfg, image_size=64, skip_models=True,
                                             device="cpu")
    audio = video.make_test_tone(1.0)
    calib = janimate.build_render_inputs(cfg, j_assets, j_models, audio, seed=2, max_frames=8)
    j_trees = {"float": j_models,
               "quantized": jassets.quantize_person_models(j_models),
               "calibrated": jassets.quantize_person_models(j_models, calibrate_inputs=calib)}
    ports = {k: assets.from_jax(tcfg, v, device="cpu") for k, v in j_trees.items()}
    return cfg, tcfg, j_assets, j_trees, person, ports, audio


@pytest.mark.parametrize("renderer,transfer", [
    ("float", "rgb"), ("float", "yuv420"), ("float", "jpeg"), ("float", "jpeg4"),
    ("float", "pack4e"), ("quantized", "rgb"), ("calibrated", "rgb")])
def test_animate_split_cand_matches_jax(persons, renderer, transfer):
    """animate(split_cand=True) against JAX's on the same weights and
    head-pose noise, under each transfer: landmarks within 1e-3 px, frames
    within one uint8 level (the int8 renderers' trees agree to 1e-7 before
    the cast, tests/test_torch_q8.py; the coders' frames measured equal)."""
    cfg, tcfg, j_assets, j_trees, person, ports, audio = persons
    ref = janimate.animate(cfg, j_assets, j_trees[renderer], audio, seed=2, render_batch=8,
                           split_cand=True, transfer=transfer)
    noise = jax_headpose_noise(2, ref.nframe, cfg.audio2headpose.ncenter,
                               cfg.audio2headpose.ndim)
    ours = animate.animate(tcfg, person, ports[renderer], audio, seed=2, render_batch=8,
                           headpose_noise=noise, split_cand=True, transfer=transfer)
    assert ours.frames.shape == ref.frames.shape == (45, 64, 64, 3)
    np.testing.assert_allclose(ours.landmarks, ref.landmarks, atol=1e-3)
    assert np.abs(ours.frames.astype(int) - ref.frames.astype(int)).max() <= 1


def test_split_cand_under_every_transfer(persons):
    """Each transfer renders the split frames: rgb within one level of the
    unsplit rgb frames, every lossy transfer >= 30 dB against the split rgb
    frames (the serving gate), pack4e equal to jpeg4 frame for frame (a
    lossless recoding; JAX tests/test_compress.py:316-329), and the render
    split over ["cpu", "cpu"] equal to one device."""
    _, tcfg, _, _, person, ports, audio = persons
    models = ports["float"]
    lm, sh, _, _, n = animate.compute_motion(tcfg, person, models, audio, seed=2)
    lm, sh = lm[:n], sh[:n]
    out = {}
    for transfer in animate.TRANSFERS:
        out[transfer], _ = animate.render_frames(tcfg, person, models, lm, sh, render_batch=4,
                                                 transfer=transfer, split_cand=True)
    unsplit, _ = animate.render_frames(tcfg, person, models, lm, sh, render_batch=4)
    assert np.abs(out["rgb"].astype(int) - unsplit.astype(int)).max() <= 1
    for transfer in ("yuv420", "jpeg", "jpeg4", "pack4e"):
        mse = np.mean((out[transfer].astype(float) - out["rgb"]) ** 2)
        assert 10 * np.log10(255.0 ** 2 / max(mse, 1e-12)) >= 30.0, transfer
    np.testing.assert_array_equal(out["pack4e"], out["jpeg4"])
    split, fmaps = animate.render_frames(tcfg, person, models, lm, sh, render_batch=4,
                                         split_cand=True, render_devices=["cpu", "cpu"],
                                         keep_feature_maps=True)
    np.testing.assert_array_equal(split, out["rgb"])
    _, fmaps_unsplit = animate.render_frames(tcfg, person, models, lm, sh, render_batch=4,
                                             keep_feature_maps=True)
    np.testing.assert_array_equal(fmaps, fmaps_unsplit)
