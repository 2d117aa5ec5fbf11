"""PyTorch port, the whole slice: JAX animate() against the port's animate()
on the CPU, the synthetic person at 64^2 and test widths, the same weights
(the JAX models loaded through params_from_jax) and the JAX decode's own
head-pose noise passed in."""

import jax
import numpy as np
import pytest

from livespeechportraits_tpu.pipeline import animate as janimate
from livespeechportraits_tpu.pipeline import assets as jassets
from livespeechportraits_torch.pipeline import animate, assets, video
from torch_parity import jax_headpose_noise, small_person_config, torch_config


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_animate_matches_jax(precision):
    """Tolerances: landmarks 1e-3 px (f32 noise through mel, GRU, LLE, LSTM
    and the 45-step decode is ~1e-5 px); head pose 1e-4; 3D points 1e-5.
    Edge maps bitwise.  Frames: the f32 renderer within one uint8 level;
    bf16 rounds at other places in the two frameworks, so within two levels
    on under 1% of the values."""
    cfg = small_person_config(image_size=64, precision=precision)
    j_assets, j_models = jassets.make_synthetic_person(cfg, key=jax.random.PRNGKey(5),
                                                       image_size=64)
    tcfg = torch_config(cfg)
    person, _ = assets.make_synthetic_person(tcfg, image_size=64, skip_models=True,
                                             device="cpu")
    models = assets.from_jax(tcfg, j_models, device="cpu")
    audio = video.make_test_tone(1.0)
    ref = janimate.animate(cfg, j_assets, j_models, audio, seed=2, keep_feature_maps=True)
    noise = jax_headpose_noise(2, ref.nframe, cfg.audio2headpose.ncenter,
                               cfg.audio2headpose.ndim)
    ours = animate.animate(tcfg, person, models, audio, seed=2, keep_feature_maps=True,
                           headpose_noise=noise)
    assert ours.nframe == ref.nframe == 45
    assert ours.frames.shape == ref.frames.shape == (45, 64, 64, 3)
    assert ours.frames.dtype == np.uint8
    np.testing.assert_allclose(ours.landmarks, ref.landmarks, atol=1e-3)
    np.testing.assert_allclose(ours.headpose, ref.headpose, atol=1e-4)
    np.testing.assert_allclose(ours.pts3d, ref.pts3d, atol=1e-5)
    np.testing.assert_array_equal(ours.feature_maps, ref.feature_maps)
    diff = np.abs(ours.frames.astype(int) - ref.frames.astype(int))
    if precision == "float32":
        assert diff.max() <= 1
    else:
        assert diff.max() <= 2 and (diff > 0).mean() < 0.01
    assert set(ours.stage_ms) == {"mel_apc", "lle", "audio2mouth", "headpose", "post",
                                  "render_device", "render"}
