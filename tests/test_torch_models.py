"""PyTorch port, models/: WaveNet, Audio2Headpose, Audio2Feature and the
Feature2Face generator against their JAX counterparts, with the JAX
weights loaded through params_from_jax (strict)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livespeechportraits_tpu.config import (Audio2FeatureConfig, Audio2HeadposeConfig,
                                            Feature2FaceConfig, WaveNetConfig)
from livespeechportraits_tpu.models import audio2feature as ja2f
from livespeechportraits_tpu.models import audio2headpose as ja2h
from livespeechportraits_tpu.models import feature2face as jf2f
from livespeechportraits_tpu.models import wavenet as jwn
from livespeechportraits_torch.models import audio2feature, audio2headpose, feature2face, wavenet
from livespeechportraits_torch.utils.convert import params_from_jax
from torch_parity import jax_headpose_noise, to_np, torch_config

H = 32
WN = WaveNetConfig(residual_layers=3, residual_blocks=2, dilation_channels=8,
                   residual_channels=8, skip_channels=16, cond_channels=H)
A2H = Audio2HeadposeConfig(apc_hidden_size=H, wavenet=WN, frame_future=5)
T_A2H = torch_config(A2H)  # the same config as the port's class


def _a2h_pair(seed=0):
    params = ja2h.init_audio2headpose(jax.random.PRNGKey(seed), A2H)
    # non-trivial BatchNorm statistics, so the eval-mode BN is exercised
    rng = np.random.default_rng(seed)
    params = to_np(params)
    params["down_bn"] = {k: (rng.uniform(0.5, 1.5, H) if k in ("scale", "var")
                             else rng.normal(0, 0.1, H)).astype(np.float32)
                         for k in ("scale", "bias", "mean", "var")}
    model = audio2headpose.Audio2Headpose(T_A2H)
    model.load_state_dict(params_from_jax(params), strict=True)
    return params, model.eval()


def _wavenet_pair():
    params, model = _a2h_pair()
    return params["wavenet"], model.WaveNet


def test_wavenet_forward_matches_jax():
    p, net = _wavenet_pair()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 20, 12)).astype(np.float32)
    cond = rng.standard_normal((2, 20, H)).astype(np.float32)
    ref = jwn.forward(p, WN, jnp.asarray(x), jnp.asarray(cond), output_length=7)
    with torch.no_grad():
        ours = wavenet.forward(net, torch.tensor(x), torch.tensor(cond))
    np.testing.assert_allclose(ours[:, -7:].numpy(), np.asarray(ref), atol=1e-5)


def test_wavenet_streaming_matches_jax():
    """stream_init on a history, then steps with precomputed conditioning
    (JAX alternates raw and precomputed); the ring buffers are circular in
    place here and shifted in JAX, so every output must agree (atol 1e-5)."""
    p, net = _wavenet_pair()
    rng = np.random.default_rng(2)
    hist = rng.standard_normal((1, 5, 12)).astype(np.float32)  # shorter than dilation 4
    cond_hist = rng.standard_normal((1, 5, H)).astype(np.float32)
    xs = rng.standard_normal((9, 1, 12)).astype(np.float32)
    cs = rng.standard_normal((1, 9, H)).astype(np.float32)
    j_state = jwn.stream_init(p, WN, jnp.asarray(hist), jnp.asarray(cond_hist))
    j_proj = jwn.precompute_cond_projections(p, jnp.asarray(cs))
    with torch.no_grad():
        state = wavenet.stream_init(net, torch.tensor(hist), torch.tensor(cond_hist))
        proj = wavenet.precompute_cond_projections(net, torch.tensor(cs))
        for (f, g), (jf, jg) in zip(proj, j_proj):
            np.testing.assert_allclose(f.numpy(), np.asarray(jf), atol=1e-5)
            np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-5)
        for i in range(9):
            if i % 2:
                j_state, j_out = jwn.stream_step(p, WN, j_state, jnp.asarray(xs[i]),
                                                 cond_t=jnp.asarray(cs[:, i]))
            else:
                j_state, j_out = jwn.stream_step(
                    p, WN, j_state, jnp.asarray(xs[i]),
                    cond_proj_t=[(f[:, i], g[:, i]) for f, g in j_proj])
            state, out = wavenet.stream_step(net, state, torch.tensor(xs[i]),
                                             cond_proj_t=[(f[:, i], g[:, i]) for f, g in proj])
            np.testing.assert_allclose(out.numpy(), np.asarray(j_out), atol=1e-5)


def test_audio2headpose_generate_sequence_matches_jax():
    """The whole autoregressive decode with the JAX decode's own per-step
    noise passed in: atol 1e-4 (f32 noise fed back through 25 steps)."""
    params, model = _a2h_pair(3)
    feats = np.random.default_rng(4).standard_normal((60, H)).astype(np.float32)
    pre = np.zeros(12, np.float32)
    ref = ja2h.generate_sequence(params, A2H, jnp.asarray(feats), jnp.asarray(pre),
                                 jax.random.PRNGKey(7), sigma_scale=0.3)
    noise = jax_headpose_noise(7, 30 - A2H.frame_future, A2H.ncenter, A2H.ndim)
    with torch.no_grad():
        ours = audio2headpose.generate_sequence(model, T_A2H, torch.tensor(feats),
                                                torch.tensor(pre), sigma_scale=0.3,
                                                noise=noise)
    assert ours.shape == (25, 12)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4)
    with pytest.raises(ValueError, match="too short"):
        audio2headpose.generate_sequence(model, T_A2H, torch.tensor(feats[:10]),
                                         torch.tensor(pre))


def test_audio2feature_generate_sequence_matches_jax():
    cfg = Audio2FeatureConfig(apc_hidden_size=H, lstm_hidden_size=16)
    params = ja2f.init_audio2feature(jax.random.PRNGKey(8), cfg)
    model = audio2feature.Audio2Feature(torch_config(cfg))
    model.load_state_dict(params_from_jax(to_np(params)), strict=True)
    feats = np.random.default_rng(9).standard_normal((41, H)).astype(np.float32)
    ref = ja2f.generate_sequence(params, jnp.asarray(feats), frame_future=3, cfg=cfg)
    with torch.no_grad():
        ours = audio2feature.generate_sequence(model, torch.tensor(feats), frame_future=3)
    assert ours.shape == (20, 75)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)


def _f2f_pair(size, seed=10):
    cfg = Feature2FaceConfig(size=size, ngf=4, n_downsample=5, load_size=32)
    params = jf2f.init_generator(jax.random.PRNGKey(seed), cfg)
    model = feature2face.Feature2FaceG(torch_config(cfg))
    model.load_state_dict(params_from_jax(to_np(params)), strict=True)
    x = np.random.default_rng(seed).uniform(-1, 1, (2, 32, 32, 13)).astype(np.float32)
    return params, model, x


@pytest.mark.parametrize("size", ["normal", "large"])
def test_generator_float_matches_jax(size):
    """f32 forward, atol 1e-5 on the tanh output."""
    params, model, x = _f2f_pair(size)
    ref, _ = jf2f.apply_generator(params, jnp.asarray(x))
    with torch.no_grad():
        ours = feature2face.apply_generator(
            feature2face.cast_generator(model, torch.float32), torch.tensor(x))
    assert ours.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)


def test_generator_bf16_matches_jax():
    """bf16 compute on both sides (weights and BN stats cast like
    _cast_net): bf16 rounds at other places in the two frameworks, so the
    bound is a few bf16 ulps at O(0.1) outputs, atol 2e-2, and the mean
    difference stays below 2e-3."""
    params, model, x = _f2f_pair("normal", seed=11)
    ref, _ = jf2f.apply_generator(params, jnp.asarray(x), compute_dtype=jnp.bfloat16)
    with torch.no_grad():
        ours = feature2face.apply_generator(
            feature2face.cast_generator(model, torch.bfloat16), torch.tensor(x))
    diff = np.abs(ours.numpy() - np.asarray(ref))
    assert diff.max() <= 2e-2 and diff.mean() <= 2e-3
    np.testing.assert_array_equal(
        feature2face.to_uint8(torch.tensor([-1.5, -1.0, 0.0, 0.999, 1.0, 2.0])).numpy(),
        np.asarray(((jnp.asarray([-1.5, -1.0, 0.0, 0.999, 1.0, 2.0]) + 1.0) * 127.5)
                   .clip(0, 255).astype(jnp.uint8)))
