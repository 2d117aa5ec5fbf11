"""PyTorch port, the inference variants a subject can name, on the CPU against
the JAX package: the 'small' pix2pix U-Net, the Audio2Feature GMM head (the
offline and the streaming decode) and the chunked KNN of the LLE bank."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livespeechportraits_tpu.config import Audio2FeatureConfig, Feature2FaceConfig
from livespeechportraits_tpu.models import audio2feature as ja2f
from livespeechportraits_tpu.models import feature2face as jf2f
from livespeechportraits_tpu.ops import manifold as jmanifold
from livespeechportraits_torch.models import audio2feature, feature2face
from livespeechportraits_torch.ops import gmm, manifold
from livespeechportraits_torch.pipeline import animate, assets, streaming, video
from livespeechportraits_torch.utils.convert import params_from_jax, params_to_jax
from torch_parity import small_person_config, to_np, torch_config

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the test workers share the machine's cores, and
    a BLAS free to pick its thread count by load may split a reduction
    differently from run to run (the bitwise comparisons here)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SMALL = Feature2FaceConfig(size="small", ngf=4, n_downsample=5, load_size=32)


def _small_pair(seed=12):
    params = to_np(jf2f.init_generator(jax.random.PRNGKey(seed), SMALL))
    # non-trivial BatchNorm statistics, so the eval-mode BN is exercised
    rng = np.random.default_rng(seed)

    def stats(p):
        if isinstance(p, dict):
            if "mean" in p:
                n = p["mean"].shape[0]
                return dict(p, mean=rng.normal(0, 0.1, n).astype(np.float32),
                            var=rng.uniform(0.5, 1.5, n).astype(np.float32))
            return {k: stats(v) for k, v in p.items()}
        return p

    params = stats(params)
    model = feature2face.Feature2FaceG(torch_config(SMALL))
    model.load_state_dict(params_from_jax(params), strict=True)
    return params, model.eval()


def test_small_unet_matches_jax():
    """f32 forward within 1e-4 of JAX's, on the reference's 23 input
    channels, and on the renderer's 13, which equal JAX's forward on those
    13 padded with zeros to 23."""
    params, model = _small_pair()
    x = np.random.default_rng(1).uniform(-1, 1, (2, 32, 32, 23)).astype(np.float32)
    net = feature2face.cast_generator(model, torch.float32)
    with torch.no_grad():
        ours = feature2face.apply_generator(net, torch.tensor(x))
        ours13 = feature2face.apply_generator(net, torch.tensor(x[..., :13]))
    ref, _ = jf2f.apply_generator(params, jnp.asarray(x))
    x0 = x.copy()
    x0[..., 13:] = 0
    ref13, _ = jf2f.apply_generator(params, jnp.asarray(x0))
    assert ours.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4)
    np.testing.assert_allclose(ours13.numpy(), np.asarray(ref13), atol=1e-4)
    assert np.abs(np.asarray(ref) - np.asarray(ref13)).max() > 1e-3  # the 10 planes count


def test_small_unet_bf16_and_its_tree():
    """The bf16 forward (cast_generator) within bf16 rounding of the f32
    one; params_to_jax inverts params_from_jax on the 'small' tree; the int8
    transforms refuse it with JAX's reasons."""
    params, model = _small_pair(13)
    x = torch.tensor(np.random.default_rng(2).uniform(-1, 1, (1, 32, 32, 13)), dtype=torch.float32)
    with torch.no_grad():
        y32 = feature2face.apply_generator(feature2face.cast_generator(model, torch.float32), x)
        y16 = feature2face.apply_generator(feature2face.cast_generator(model, torch.bfloat16), x)
    assert (y16 - y32).abs().max() < 0.1 and (y16 - y32).abs().mean() < 1e-2
    back = params_to_jax(model)
    assert back["size"] == "small"
    jax.tree.map(np.testing.assert_array_equal, back["net"], params["net"])
    for fn, match in ((feature2face.quantize_generator, "ConvTranspose layers that keep"),
                      (feature2face.fold_bn_generator, "left unfolded"),
                      (lambda m: feature2face.calibrate_generator(m, x), "quantize the generator")):
        with pytest.raises(NotImplementedError, match=match):
            fn(model)


def _a2f_pair(ncenter, seed=8):
    cfg = Audio2FeatureConfig(apc_hidden_size=32, lstm_hidden_size=16, loss="GMM",
                              gmm_ncenter=ncenter)
    params = to_np(ja2f.init_audio2feature(jax.random.PRNGKey(seed), cfg))
    model = audio2feature.Audio2Feature(torch_config(cfg))
    model.load_state_dict(params_from_jax(params), strict=True)
    return cfg, params, model.eval()


@pytest.mark.parametrize("ncenter", [1, 3])
def test_gmm_head_matches_jax(ncenter):
    """The raw parameter block within 1e-5 of JAX's apply_audio2feature.
    One component: the decoded means equal JAX's generate_sequence(cfg=)
    within 1e-5.  Three: each decoded row is the mean JAX's block holds at
    the component the port drew for that row (JAX's key stream is not the
    port's, so the draws themselves are not compared)."""
    cfg, params, model = _a2f_pair(ncenter)
    feats = np.random.default_rng(9).standard_normal((41, 32)).astype(np.float32)
    ff = 3
    with torch.no_grad():
        block = audio2feature.apply_audio2feature(model, torch.tensor(feats[:40])[None])[0]
        ours = audio2feature.generate_sequence(model, torch.tensor(feats), frame_future=ff,
                                               seed=5)
    ref_block, _ = ja2f.apply_audio2feature(params, jnp.asarray(feats[:40])[None])
    ref_block = np.asarray(ref_block[0])
    assert block.shape == (20, (2 * 75 + 1) * ncenter)
    np.testing.assert_allclose(block.numpy(), ref_block, atol=1e-5)
    assert ours.shape == (20, 75)
    if ncenter == 1:
        ref = ja2f.generate_sequence(params, jnp.asarray(feats), frame_future=ff, cfg=cfg)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)
        return
    # the JAX block of the padded sequence, rows ff.. as generate_sequence keeps them
    padded = np.concatenate([feats[:40], np.repeat(feats[39:40], 2 * ff, 0)])
    jblock = np.asarray(ja2f.apply_audio2feature(params, jnp.asarray(padded)[None])[0][0])
    g = audio2feature.component_gumbel(23, ncenter, 5).numpy()
    comp = np.argmax(jblock[:, :ncenter] + g, axis=1)
    assert len(set(comp.tolist())) > 1  # the draws pick more than one component
    means = jblock[:, ncenter:ncenter * 76].reshape(23, ncenter, 75)
    np.testing.assert_allclose(ours.numpy(), means[np.arange(23), comp][ff:], atol=1e-5)


def test_gmm_decode_is_position_stable():
    """Row i's component depends on (seed, i) alone: a chunk decoded from
    ``start`` equals the same rows of the whole decode; injected draws
    override the seed."""
    cfg = torch_config(Audio2FeatureConfig(loss="GMM", gmm_ncenter=4, output_dim=6))
    block = torch.randn(30, 13 * 4, generator=torch.Generator().manual_seed(0))
    whole = audio2feature.decode(cfg, block, seed=9)
    parts = torch.cat([audio2feature.decode(cfg, block[a:b], seed=9, start=a)
                       for a, b in ((0, 7), (7, 8), (8, 30))])
    torch.testing.assert_close(parts, whole, rtol=0, atol=0)
    g = torch.zeros(30, 4)
    g[:, 2] = 1e9
    np.testing.assert_array_equal(audio2feature.decode(cfg, block, gumbel=g).numpy(),
                                  block[:, 4 + 12:4 + 18].numpy())
    u = gmm.step_uniforms(9, 30, 4)
    assert not np.allclose(audio2feature.component_gumbel(30, 4, 9).numpy(),
                           -np.log(-np.log(u)))  # not the head-pose draws of the seed


@pytest.mark.parametrize("ncenter", [1, 3])
def test_gmm_head_streams_like_offline(ncenter):
    """A subject with the GMM head: the stream decodes its chunks as the
    offline pipeline decodes the clip (frames within the stream's bound:
    one level on under 1 % of the values; measured equal)."""
    cfg = small_person_config(image_size=32)
    cfg = torch_config(dataclasses.replace(cfg, audio2feature=dataclasses.replace(
        cfg.audio2feature, loss="GMM", gmm_ncenter=ncenter)))
    person, models = assets.make_synthetic_person(cfg, image_size=32, device="cpu")
    audio = video.make_test_tone(1.0)
    offline = animate.animate(cfg, person, models, audio, seed=6, render_batch=4)
    st = streaming.StreamingAnimator(cfg, person, models, seed=6, chunk=16, render_batch=4)
    frames = np.concatenate([st.push_audio(audio[lo:lo + 2000])
                             for lo in range(0, len(audio), 2000)] + [st.flush()])
    assert frames.shape == offline.frames.shape == (45, 32, 32, 3)
    d = np.abs(frames.astype(int) - offline.frames.astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 0.01


@pytest.mark.parametrize("N,chunk,K", [(100, 16, 10), (97, 32, 10), (6, 4, 10), (64, 64, 5)])
def test_knn_chunked_matches_knn_indices_and_jax(N, chunk, K):
    """Chunks smaller than the bank, a bank that is not a multiple of the
    chunk, and a bank smaller than K (K = min(K, N)): the indices equal
    knn_indices' and JAX's knn_chunked's."""
    rng = np.random.default_rng(N)
    feats = rng.standard_normal((40, 16)).astype(np.float32)
    bank = rng.standard_normal((N, 16)).astype(np.float32)
    ours = manifold.knn_chunked(torch.tensor(feats), torch.tensor(bank), K=K, chunk=chunk)
    want = manifold.knn_indices(torch.tensor(feats), torch.tensor(bank), K=K)
    ref = jmanifold.knn_chunked(jnp.asarray(feats), jnp.asarray(bank), K=K, chunk=chunk)
    assert ours.shape == (40, min(K, N))
    np.testing.assert_array_equal(ours.numpy(), want.numpy())
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
