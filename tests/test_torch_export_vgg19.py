"""The port's VGG19 exporter (livespeechportraits_torch/tools/export_vgg19.py)
against the JAX package's (repo-root tools/export_vgg19.py) on state dicts in
torchvision's key layouts that the test writes itself (random weights, a
seed): the .npz array for array, and the features the port's
losses.load_vgg19_npz + vgg19_features computes from it against JAX's
load_vgg19_npz + vgg19_features on one seeded input (1e-5 of the tap's
largest magnitude, at least 1e-5: tests/test_torch_train.py's VGG rule).
Nothing is downloaded."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livespeechportraits_torch.models import losses as t_losses
from livespeechportraits_torch.tools import export_vgg19 as t_export
from livespeechportraits_tpu.models import losses as j_losses

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from tools import export_vgg19 as j_export  # noqa: E402  (the JAX package's tool)

FEATURE_TOL = 1e-5


def _features_state_dict(seed: int) -> dict:
    """VGG19's features in torchvision's layout: '<i>.weight' / '<i>.bias'
    at the conv indices (0, 2, 5, ..., 34), torch's default conv init."""
    torch.manual_seed(seed)
    sd, index, cin = {}, 0, 3
    for spec in t_losses._VGG19_PLAN:
        if spec == "M":
            index += 1
            continue
        conv = torch.nn.Conv2d(cin, spec, 3, padding=1)
        sd[f"{index}.weight"], sd[f"{index}.bias"] = conv.weight.detach(), conv.bias.detach()
        index, cin = index + 2, spec
    return sd


def _full_model_state_dict(features: dict) -> dict:
    """The whole model's layout: 'features.' before each key, and the
    classifier's keys (small here: the exporter reads none of them)."""
    sd = {f"features.{k}": v for k, v in features.items()}
    for i in (0, 3, 6):
        sd[f"classifier.{i}.weight"] = torch.randn(8, 16)
        sd[f"classifier.{i}.bias"] = torch.randn(8)
    return sd


@pytest.mark.parametrize("layout", ["features", "full_model"])
def test_export_matches_jax_tool_and_loads_to_jax_features(tmp_path, layout):
    """A features-only .pth: the port's .npz equals the JAX tool's array for
    array.  A full-model .pth (torchvision's own file layout): the port
    exports the same arrays, where the JAX tool raises on the classifier's
    keys.  Then the port's load_vgg19_npz of the port's .npz gives JAX's
    five feature taps on a seeded input."""
    features = _features_state_dict(7)
    pth = tmp_path / f"{layout}.pth"
    torch.save(features if layout == "features" else _full_model_state_dict(features), pth)
    ours, want = tmp_path / "ours.npz", tmp_path / "jax.npz"
    assert t_export.main([str(ours), "--state_dict", str(pth)]) == 0
    if layout == "features":
        assert j_export.export(str(want), str(pth)) == 16
    else:
        with pytest.raises(ValueError, match="classifier"):
            j_export.export(str(tmp_path / "refused.npz"), str(pth))
        assert j_export.export(str(want), features) == 16  # the same convs, features-only
    with np.load(ours) as got, np.load(want) as ref:
        assert sorted(got.files) == sorted(ref.files) == sorted(
            f"conv{k}_{p}" for k in range(16) for p in "wb")
        for name in ref.files:
            assert got[name].dtype == np.float32
            np.testing.assert_array_equal(got[name], ref[name], err_msg=name)
    x = np.tanh(np.random.default_rng(3).normal(size=(2, 32, 32, 3))).astype(np.float32)
    taps = t_losses.vgg19_features(t_losses.load_vgg19_npz(str(ours)), torch.from_numpy(x))
    taps_j = j_losses.vgg19_features(j_losses.load_vgg19_npz(str(want)), jnp.asarray(x))
    assert len(taps) == len(taps_j) == 5
    for t, t_j in zip(taps, taps_j):
        t_j = np.asarray(t_j)
        tol = FEATURE_TOL * max(float(np.abs(t_j).max()), 1.0)
        np.testing.assert_allclose(t.detach().numpy(), t_j, atol=tol, rtol=0)


def test_export_refuses_what_is_not_vgg19s_features():
    """A key outside the two layouts, or a conv count other than 16."""
    features = _features_state_dict(0)
    with pytest.raises(ValueError, match="not a key of VGG19"):
        t_export.conv_arrays({**features, "head.weight": torch.zeros(1)})
    with pytest.raises(ValueError, match="16 convs"):
        t_export.conv_arrays({k: v for k, v in features.items() if not k.startswith("34.")})
