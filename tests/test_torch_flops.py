"""PyTorch port, utils/flops.py: the generator's analytic FLOPs against the
JAX package's walk (which tests/test_flops.py pins to XLA's cost model),
and the card's peak table."""

import jax
import pytest
import torch

from livespeechportraits_tpu.config import Feature2FaceConfig
from livespeechportraits_tpu.models import feature2face as jf2f
from livespeechportraits_tpu.utils import flops as jflops
from livespeechportraits_torch.models import feature2face as f2f
from livespeechportraits_torch.utils import flops
from torch_parity import torch_config


def _meta_generator(cfg: Feature2FaceConfig) -> f2f.Feature2FaceG:
    """The port's generator on the meta device: shapes, no storage."""
    with torch.device("meta"):
        return f2f.Feature2FaceG(torch_config(cfg))


@pytest.mark.parametrize("size,n_down,img", [("small", 6, 64), ("normal", 6, 64),
                                             ("large", 6, 64), ("large", 8, 256)])
def test_equals_the_jax_count(size, n_down, img):
    """The configurations of tests/test_flops.py:30-35, exactly equal: every
    term is an integer below 2^53, so the sums are exact in any order."""
    cfg = Feature2FaceConfig(size=size, ngf=64, n_downsample=n_down, load_size=img)
    params = jf2f.init_generator(jax.random.PRNGKey(0), cfg)
    assert flops.generator_flops(_meta_generator(cfg), img) == jflops.generator_flops(
        params["net"], size, img)


def test_linear_in_batch_and_the_int8_tree_counts_the_float_one():
    cfg = Feature2FaceConfig(size="normal", ngf=32, n_downsample=6, load_size=64)
    model = _meta_generator(cfg)
    one = flops.generator_flops(model, 64, batch=1)
    assert flops.generator_flops(model, 64, batch=4) == 4 * one
    cpu = f2f.Feature2FaceG(torch_config(cfg))
    q = f2f.quantize_generator(cpu)
    # quantize keeps the convs' shapes; fold_bn gives the int8 convs a bias
    assert flops.generator_flops(q, 64) == one
    assert flops.generator_flops(f2f.fold_bn_generator(q), 64) > one


def test_flagship_large_at_512_on_the_meta_device():
    """The 'large' ResUNet (ngf 64, 8 downsamplings) at 512^2: 243-246 GFLOP
    a frame (tests/test_flops.py:54-61)."""
    cfg = Feature2FaceConfig(size="large", ngf=64, n_downsample=8, load_size=512)
    g = flops.generator_flops(_meta_generator(cfg), 512) / 1e9
    assert 243.0 < g < 246.0


@pytest.mark.parametrize("name,kind,peak", [
    ("NVIDIA H100 80GB HBM3", "bf16", 989.4e12),
    ("NVIDIA H100 80GB HBM3, 700.00 W", "int8", 1978.9e12),
    ("NVIDIA H100 PCIe", "bf16", 756e12),
    ("NVIDIA H100 PCIe", "int8", 1513e12),
])
def test_h100_peaks(name, kind, peak):
    got, label = flops.render_peak_flops(name, kind)
    assert got == peak and kind in label


def test_unknown_cards_and_the_memory_rate():
    for name in ("cpu", "Tesla T4", "TPU v5 lite"):
        assert flops.render_peak_flops(name) == (None, None)
        assert flops.device_peaks(name) == (None, None)
    assert flops.device_peaks("NVIDIA H100 80GB HBM3")[0]["bytes_per_s"] == 3.35e12
    assert flops.H100_SXM["bytes_per_s"] == 3.35e12 and flops.H100_SXM["f32"] == 67e12
    # the table holds no TPU rate
    assert all("H100" in k for k in flops.PEAKS)
