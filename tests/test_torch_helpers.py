"""The helpers the port took last from the JAX package, on the CPU against
the JAX functions on the same seeded numpy inputs: ops/mel.py's generic
front-end (audio_to_mel, mel_energy, frame_energy, mu-law, the Griffin-Lim
mel_to_audio), ops/geometry.py's Camera and euler_to_rotation_grad,
audio2headpose.generate_sequence_sliding_window and
utils/compile_cache.enable.

Tolerances: the log-mel and the energies 2e-5 (f32 FFTs and the filterbank
product in other summation orders; JAX's own bound against torch.stft is
2e-4); mu-law exactly; mel_to_audio after 4 Griffin-Lim rounds 1e-4 of the
waveform's peak (each round renormalises the phase, which carries the
FFTs' rounding on); Camera exactly; euler_to_rotation_grad 1e-6; the
sliding-window oracle against generate_sequence 2e-4 (JAX's own bound for
the same pair) and against JAX's oracle with JAX's draws 1e-4 (f32 noise
fed back through the steps, tests/test_torch_models.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livespeechportraits_torch import _build, native
from livespeechportraits_torch.models import audio2headpose as t_a2h
from livespeechportraits_torch.ops import geometry as t_geo
from livespeechportraits_torch.ops import mel as t_mel
from livespeechportraits_torch.utils import compile_cache
from livespeechportraits_torch.utils.convert import params_from_jax
from livespeechportraits_tpu.config import Audio2HeadposeConfig, WaveNetConfig
from livespeechportraits_tpu.models import audio2headpose as j_a2h
from livespeechportraits_tpu.ops import geometry as j_geo
from livespeechportraits_tpu.ops import mel as j_mel
from torch_parity import jax_headpose_noise, to_np, torch_config

MEL_TOL = 2e-5


def _audio(T: int, seed: int = 0, batch: int = 0) -> np.ndarray:
    shape = (batch, T) if batch else (T,)
    return np.random.default_rng(seed).uniform(-1, 1, size=shape).astype(np.float32)


@pytest.mark.parametrize("T,params", [
    (4000, dict(n_fft=512, hop=133, win=266)),  # test_mel.py's live 120 Hz framing
    (16000, dict(n_fft=512, hop=256, win=512)),  # and its generic STFT
])
def test_audio_to_mel_mel_energy_and_frame_energy_match_jax(T, params):
    audio = _audio(T, batch=2)
    kw = dict(n_fft=params["n_fft"], hop_length=params["hop"], win_length=params["win"])
    want = np.asarray(j_mel.audio_to_mel(jnp.asarray(audio), **kw))
    got = t_mel.audio_to_mel(torch.from_numpy(audio), **kw)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=MEL_TOL, rtol=0)
    np.testing.assert_allclose(t_mel.mel_energy(got).numpy(),
                               np.asarray(j_mel.mel_energy(jnp.asarray(want))), atol=MEL_TOL)
    raw = t_mel.audio_to_mel(torch.from_numpy(audio[0]), normalize=False, **kw)
    np.testing.assert_allclose(raw.numpy(), np.asarray(j_mel.audio_to_mel(
        jnp.asarray(audio[0]), normalize=False, **kw)), atol=MEL_TOL * 12, rtol=0)  # x -log(1e-5)
    for normalize in (True, False):
        np.testing.assert_allclose(
            t_mel.frame_energy(torch.from_numpy(audio), normalize=normalize).numpy(),
            np.asarray(j_mel.frame_energy(jnp.asarray(audio), normalize=normalize)),
            atol=MEL_TOL, rtol=0)


def test_short_audio_and_wide_windows_raise_as_in_jax():
    with pytest.raises(ValueError, match="win_length"):
        t_mel.audio_to_mel(torch.zeros(4000), n_fft=512, hop_length=256, win_length=1024)
    with pytest.raises(ValueError, match="too short"):
        t_mel.audio_to_mel(torch.zeros(100), win_length=512)
    with pytest.raises(ValueError, match="too short"):
        t_mel.frame_energy(torch.zeros(100))


def test_mu_law_equals_jax_exactly():
    x = np.concatenate([np.linspace(-1.2, 1.2, 1001), _audio(4096, 3)]).astype(np.float32)
    enc = t_mel.mu_law_encode(torch.from_numpy(x))
    want = np.asarray(j_mel.mu_law_encode(jnp.asarray(x)))
    assert enc.dtype == torch.int32
    np.testing.assert_array_equal(enc.numpy(), want)
    codes = np.arange(256, dtype=np.int32)  # every code the decoder takes
    np.testing.assert_array_equal(t_mel.mu_law_decode(torch.from_numpy(codes)).numpy(),
                                  np.asarray(j_mel.mu_law_decode(jnp.asarray(codes))))
    np.testing.assert_array_equal(t_mel.mu_law_decode(enc).numpy(),
                                  np.asarray(j_mel.mu_law_decode(jnp.asarray(want))))


@pytest.mark.parametrize("length", [None, 1000, 4160], ids=["full", "short", "longer"])
def test_mel_to_audio_matches_jax_at_four_rounds(length):
    audio = _audio(4000, 5)
    m = np.asarray(j_mel.audio_to_mel(jnp.asarray(audio), win_length=512))[0]
    want = np.asarray(j_mel.mel_to_audio(jnp.asarray(m), n_iter=4, length=length))
    got = t_mel.mel_to_audio(torch.from_numpy(m.copy()), n_iter=4, length=length).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), rtol=0)


def test_camera_equals_jax():
    cam = t_geo.Camera(fx=1000, fy=1010, cx=256, cy=250)
    ref = j_geo.Camera(fx=1000, fy=1010, cx=256, cy=250)
    M = np.array([[0.5, 0, 10], [0, 0.5, 20], [0, 0, 1]], np.float32)
    np.testing.assert_array_equal(cam.intrinsic, ref.intrinsic)
    assert cam.intrinsic.dtype == np.float32
    assert vars(cam.scaled(M)) == vars(ref.scaled(M))
    assert cam.scaled(M).fx == 500 and cam.scaled(M).cx == 138


@pytest.mark.parametrize("shape", [(3,), (7, 3)], ids=["one_frame", "batched"])
def test_euler_to_rotation_grad_matches_jax(shape):
    a = np.random.default_rng(6).uniform(-40, 40, shape).astype(np.float32)
    R, grads = t_geo.euler_to_rotation_grad(torch.from_numpy(a))
    R_ref, g_ref = j_geo.euler_to_rotation_grad(jnp.asarray(a))
    np.testing.assert_allclose(R.numpy(), np.asarray(R_ref), atol=1e-6)
    assert len(grads) == 3
    for g, w in zip(grads, g_ref):
        assert tuple(g.shape) == shape[:-1] + (3, 3)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


H = 8
A2H = Audio2HeadposeConfig(apc_hidden_size=H, frame_future=5,
                           wavenet=WaveNetConfig(residual_layers=3, residual_blocks=2,
                                                 dilation_channels=8, residual_channels=8,
                                                 skip_channels=16, cond_channels=H))


def test_sliding_window_oracle_matches_generate_sequence_and_jax():
    """JAX's test_ar_decode_matches_sliding_window_oracle in the port: the
    slow oracle against the fast decode on the same draws (step i's), and
    against JAX's oracle fed the same draws by its key."""
    params = j_a2h.init_audio2headpose(jax.random.PRNGKey(0), A2H)
    model = t_a2h.Audio2Headpose(torch_config(A2H))
    model.load_state_dict(params_from_jax(to_np(params)), strict=True)
    model.eval()
    T = A2H.frame_future + 10
    feats = np.random.default_rng(1).standard_normal((2 * T, H)).astype(np.float32)
    pre = np.zeros(12, np.float32)
    noise = jax_headpose_noise(42, 10, A2H.ncenter, A2H.ndim)
    cfg = torch_config(A2H)
    with torch.no_grad():
        slow = t_a2h.generate_sequence_sliding_window(model, cfg, torch.from_numpy(feats),
                                                      torch.from_numpy(pre), noise=noise)
        fast = t_a2h.generate_sequence(model, cfg, torch.from_numpy(feats),
                                       torch.from_numpy(pre), noise=noise)
        seeded = t_a2h.generate_sequence_sliding_window(model, cfg, torch.from_numpy(feats),
                                                        torch.from_numpy(pre), seed=3)
        seeded_fast = t_a2h.generate_sequence(model, cfg, torch.from_numpy(feats),
                                              torch.from_numpy(pre), seed=3)
    assert tuple(slow.shape) == (10, 12)
    np.testing.assert_allclose(slow.numpy(), fast.numpy(), atol=2e-4)
    np.testing.assert_allclose(seeded.numpy(), seeded_fast.numpy(), atol=2e-4)
    ref = j_a2h.generate_sequence_sliding_window(params, A2H, jnp.asarray(feats),
                                                 jnp.asarray(pre), jax.random.PRNGKey(42))
    np.testing.assert_allclose(slow.numpy(), np.asarray(ref), atol=1e-4)
    with pytest.raises(ValueError, match="too short"):
        t_a2h.generate_sequence_sliding_window(model, cfg, torch.from_numpy(feats[:10]),
                                               torch.from_numpy(pre))


def test_compile_cache_enable_directory_rules(tmp_path, monkeypatch):
    """An explicit directory, else $LSP_COMPILE_CACHE_DIR (set and not
    empty), else the repository's build/; the kernels' and the host
    codec's builds both move there."""
    default = _build.DEFAULT_BUILD_DIR
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    monkeypatch.setattr(native, "BUILD_DIR", native.BUILD_DIR)
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    assert native.BUILD_DIR == default and default.name == "build"
    got = compile_cache.enable(str(tmp_path / "a"))
    assert got == str(tmp_path / "a") and (tmp_path / "a").is_dir()
    assert _build.BUILD_DIR == native.BUILD_DIR == tmp_path / "a"
    assert _build.library_path().parent == tmp_path / "a"
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path / "env"))
    assert compile_cache.enable() == str(tmp_path / "env")
    assert native.library_path().parent == tmp_path / "env"
    monkeypatch.setenv(compile_cache.ENV, "")
    assert compile_cache.enable() == str(default)
    assert _build.BUILD_DIR == default
