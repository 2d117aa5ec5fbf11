"""PyTorch port, ops/: mel, manifold, gmm, smoothing and geometry against
their JAX counterparts on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livespeechportraits_tpu.ops import geometry as jgeom
from livespeechportraits_tpu.ops import gmm as jgmm
from livespeechportraits_tpu.ops import manifold as jman
from livespeechportraits_tpu.ops import mel as jmel
from livespeechportraits_tpu.ops import smoothing as jsmooth
from livespeechportraits_torch.ops import geometry, gmm, manifold, mel, smoothing
from livespeechportraits_torch.pipeline import video


def test_mel_filterbank_and_window_match_jax():
    np.testing.assert_array_equal(mel.mel_filterbank(), jmel.mel_filterbank())
    np.testing.assert_array_equal(mel._hann_periodic(266), jmel._hann_periodic(266))
    p = np.arange(-5, 20)
    np.testing.assert_array_equal(mel._reflect_index(p, 12), jmel._reflect_index(p, 12))


def test_mel_sequence_matches_jax():
    """atol 1e-5 on [0, 1]-scaled log-mel: the two FFTs and the f32 mel
    matmul differ in summation order only."""
    audio = video.make_test_tone(0.7) + np.random.default_rng(0).normal(
        0, 0.05, 11200).astype(np.float32)
    ref = np.asarray(jmel.compute_mel_sequence(audio))
    ours = mel.compute_mel_sequence(audio, device="cpu").numpy()
    assert ours.shape == ref.shape == (84, 80)
    np.testing.assert_allclose(ours, ref, atol=1e-5)
    assert mel.compute_mel_sequence(np.zeros(100, np.float32), device="cpu").shape == (0, 80)


def _bank(seed=0, T=40, N=64, D=24):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((T, D)).astype(np.float32),
            rng.standard_normal((N, D)).astype(np.float32))


def test_knn_indices_match_jax():
    feats, bank = _bank()
    ref = np.asarray(jman.knn_indices(jnp.asarray(feats), jnp.asarray(bank), K=10))
    ours = manifold.knn_indices(torch.tensor(feats), torch.tensor(bank), K=10).numpy()
    np.testing.assert_array_equal(ours, ref)
    small = manifold.knn_indices(torch.tensor(feats), torch.tensor(bank[:4]), K=10)
    assert small.shape == (40, 4)


def test_lle_matches_jax():
    """atol 1e-4: the 9x9 Gram systems are solved by different LU codes,
    and the Gram matrix of neighbour differences is not well conditioned
    in f32; the reconstruction is O(1)."""
    feats, bank = _bank(1)
    ref = np.asarray(jman.lle_project(jnp.asarray(feats), jnp.asarray(bank), K=10,
                                      percent=0.8))
    ours = manifold.lle_project(torch.tensor(feats), torch.tensor(bank), K=10,
                                percent=0.8).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-4)


def test_lle_singular_gram_falls_back_to_uniform_like_jax():
    feats, bank = _bank(2, T=3, N=4, D=8)
    neighbors = np.repeat(bank[None, :1], 3, axis=1).repeat(3, axis=0)  # duplicates
    w_ref, r_ref = jman.solve_lle_weights(jnp.asarray(feats), jnp.asarray(neighbors))
    w, r = manifold.solve_lle_weights(torch.tensor(feats), torch.tensor(neighbors))
    np.testing.assert_allclose(w.numpy(), np.asarray(w_ref), atol=1e-6)
    np.testing.assert_allclose(r.numpy(), np.asarray(r_ref), atol=1e-6)
    np.testing.assert_allclose(w.numpy(), 1 / 3)


@pytest.mark.parametrize("ncenter,sigma_scale", [(1, 0.3), (3, 1.0), (3, 0.0)])
def test_sample_gmm_with_injected_noise_matches_jax(ncenter, sigma_scale):
    """JAX draws its noise from a key; the port takes the same draws."""
    ndim, n = 12, 7
    params = np.random.default_rng(3).standard_normal((n, (2 * ndim + 1) * ncenter))
    params = params.astype(np.float32)
    key = jax.random.PRNGKey(4)
    ref = jgmm.sample_gmm(key, jnp.asarray(params), ncenter, ndim, sigma_scale=sigma_scale)
    k_cat, k_norm = jax.random.split(key)
    gumbel = np.asarray(jax.random.gumbel(k_cat, (n, ncenter)))
    eps = np.asarray(jax.random.normal(k_norm, (n, ndim)))
    ours = gmm.sample_gmm(torch.tensor(params), ncenter, ndim, torch.tensor(gumbel),
                          torch.tensor(eps), sigma_scale=sigma_scale)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6)


def test_draw_noise_is_seeded_and_standard():
    a = gmm.draw_noise(4000, 2, 12, 1)
    b = gmm.draw_noise(4000, 2, 12, 1)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[1], gmm.draw_noise(4000, 2, 12, 2)[1])
    gumbel, eps = a
    assert gumbel.dtype == eps.dtype == torch.float32
    assert abs(gumbel.mean().item() - 0.5772) < 0.05  # Euler-Mascheroni
    assert abs(eps.mean().item()) < 0.02 and abs(eps.std().item() - 1.0) < 0.05


@pytest.mark.parametrize("T,sigma", [(50, 1.5), (30, 5.0), (12, 10.0)])
def test_gaussian_filter1d_matches_jax(T, sigma):
    """Reflect padding that repeats the edge sample, even when the kernel
    is wider than the signal; atol 1e-6."""
    x = np.random.default_rng(5).standard_normal((T, 4)).astype(np.float32)
    ref = np.asarray(jsmooth.gaussian_filter1d(jnp.asarray(x), sigma))
    ours = smoothing.gaussian_filter1d(torch.tensor(x), sigma).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-6)


def test_landmark_smoothing_and_headpose_match_jax():
    pts = np.random.default_rng(6).standard_normal((40, 73, 3)).astype(np.float32)
    head = np.random.default_rng(7).standard_normal((40, 6)).astype(np.float32)
    for area in ("only_mouth", "all"):
        ref = jsmooth.landmark_smooth_3d(jnp.asarray(pts), 1.5, area)
        ours = smoothing.landmark_smooth_3d(torch.tensor(pts), 1.5, area)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6)
    ref = jsmooth.headpose_smooth(jnp.asarray(head), (5.0, 10.0))
    ours = smoothing.headpose_smooth(torch.tensor(head), (5.0, 10.0))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("method,params,is_delta", [
    ("XY", (2.0, 1.5), True), ("XY", (2.0, 1.5), False), ("delta", (0.5,), True),
    ("XYZ", (2.0, 2.0, 2.0), True), ("LowerMore", (1, 2, 3, 4, 5, 6), True),
    ("CloseSmall", (1, 2, 3, 4, 5, 6), True)])
def test_mouth_amp_matches_jax(method, params, is_delta):
    pts = np.random.default_rng(8).standard_normal((10, 73, 3)).astype(np.float32)
    ref = jsmooth.mouth_amp(jnp.asarray(pts), is_delta, method, params)
    ours = smoothing.mouth_amp(torch.tensor(pts), is_delta, method, params)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6)


def test_solve_intersect_mouth_matches_jax():
    pts = np.random.default_rng(9).standard_normal((12, 73, 3)).astype(np.float32)
    pts[::3, [58, 59, 60], 1] = 5.0  # lower inner lip above the upper: flipped
    pts[::3, [63, 62, 61], 1] = -5.0
    ref = jsmooth.solve_intersect_mouth(jnp.asarray(pts))
    ours = smoothing.solve_intersect_mouth(torch.tensor(pts))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-6)
    assert not np.allclose(ours.numpy(), pts)


def test_geometry_matches_jax():
    """atol 1e-4 px on ~500 px coordinates (f32 relative noise)."""
    rng = np.random.default_rng(10)
    angles = rng.uniform(-30, 30, (6, 3)).astype(np.float32)
    np.testing.assert_allclose(geometry.euler_to_rotation(torch.tensor(angles)).numpy(),
                               np.asarray(jgeom.euler_to_rotation(jnp.asarray(angles))),
                               atol=1e-6)
    K = np.array([[1228.8, 0, 256], [0, 1228.8, 256], [0, 0, 1]], np.float32)
    head = np.concatenate([angles + [180, 0, 0], rng.uniform(-0.05, 0.05, (6, 3)) + [0, 0, 1]],
                          axis=1).astype(np.float32)
    pts = rng.uniform(-0.1, 0.1, (6, 73, 3)).astype(np.float32)
    ref = jgeom.project_landmarks(jnp.asarray(K), jnp.eye(3), jnp.zeros(3), 1.0,
                                  jnp.asarray(head), jnp.asarray(pts))
    ours = geometry.project_landmarks(torch.tensor(K), torch.eye(3), torch.zeros(3), 1.0,
                                      torch.tensor(head), torch.tensor(pts))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4)
    sh = (rng.uniform(-0.1, 0.1, (18, 3)) + [0, 0, 1]).astype(np.float32)
    ref_t = np.array([0, 0.05, 1], np.float32)
    r2, r3 = jgeom.project_shoulders(jnp.asarray(K), jnp.asarray(sh), jnp.asarray(head[:, 3:]),
                                     jnp.asarray(ref_t), 0.5)
    o2, o3 = geometry.project_shoulders(torch.tensor(K), torch.tensor(sh),
                                        torch.tensor(head[:, 3:]), torch.tensor(ref_t), 0.5)
    np.testing.assert_allclose(o2.numpy(), np.asarray(r2), atol=1e-4)
    np.testing.assert_allclose(o3.numpy(), np.asarray(r3), atol=1e-6)
