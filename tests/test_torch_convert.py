"""PyTorch port: the weights bridge, the synthetic person, and the rule that
the port imports no JAX."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from livespeechportraits_tpu.config import PersonConfig, replace
from livespeechportraits_tpu.pipeline import assets as jassets
from livespeechportraits_tpu.utils import torch_convert
from livespeechportraits_torch.pipeline import assets
from livespeechportraits_torch.utils.convert import params_from_jax
from torch_parity import small_person_config, to_np, torch_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_models():
    cfg = small_person_config(image_size=32)
    _, models = jassets.make_synthetic_person(cfg, key=jax.random.PRNGKey(1), image_size=32)
    large = replace(cfg.feature2face, size="large")
    from livespeechportraits_tpu.models import feature2face as jf2f

    return cfg, models, jf2f.init_generator(jax.random.PRNGKey(2), large)


@pytest.mark.parametrize("which", ["apc", "audio2feature", "audio2headpose", "feature2face",
                                   "feature2face_large"])
def test_params_from_jax_matches_torch_convert_export(jax_models, which):
    """Key for key and bit for bit the reference-format state dict that
    torch_convert.export_* writes."""
    _, models, large = jax_models
    tree = large if which == "feature2face_large" else getattr(models, which)
    export = {"apc": torch_convert.export_apc,
              "audio2feature": torch_convert.export_audio2feature,
              "audio2headpose": torch_convert.export_audio2headpose}.get(
                  which, torch_convert.export_feature2face_g)
    ref = export(tree)
    ours = params_from_jax(to_np(tree))
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        got = ours[k].numpy()
        assert got.dtype == np.asarray(v).dtype or k.endswith("num_batches_tracked")
        np.testing.assert_array_equal(got, np.asarray(v), err_msg=k)


def test_from_jax_loads_every_model_strictly(jax_models):
    cfg, models, _ = jax_models
    ported = assets.from_jax(torch_config(cfg), models, device="cpu")
    w = ported.apc.rnns[1].weight_hh_l0
    np.testing.assert_array_equal(w.numpy(), np.asarray(models.apc["layers"][1]["w_hh"]).T)
    assert not any(p.requires_grad for p in ported.feature2face.parameters())
    with pytest.raises(ValueError, match="unrecognised"):
        params_from_jax({"foo": 1})


def test_synthetic_assets_bitwise_equal_to_jax():
    cfg = PersonConfig()
    ref, _ = jassets.make_synthetic_person(cfg, image_size=64, skip_models=True)
    ours, _ = assets.make_synthetic_person(torch_config(cfg), image_size=64,
                                           skip_models=True, device="cpu")
    for name in ("mean_pts3d", "std_mean_pts3d", "mean_translation", "candidate_eye_brow",
                 "candidate_images", "shoulders", "shoulder3D", "ref_trans",
                 "camera_intrinsic", "apc_feature_base"):
        a, b = getattr(ours, name), getattr(ref, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert ours.scale == ref.scale and ours.image_pad == ref.image_pad
    np.testing.assert_array_equal(assets._synthetic_face_landmarks(),
                                  jassets._synthetic_face_landmarks())


def test_synthetic_models_are_seeded_at_jax_scales():
    cfg = torch_config(small_person_config(image_size=32))
    a = assets.init_models(cfg, assets.synthetic_seed(cfg))
    b = assets.init_models(cfg, assets.synthetic_seed(cfg))
    for x, y in zip(a.feature2face.state_dict().values(), b.feature2face.state_dict().values()):
        assert torch.equal(x, y)
    conv = a.feature2face.netG.model.model[0].weight
    assert abs(conv.std().item() - 0.02) < 0.004
    bn = a.feature2face.netG.model.model[2].block[1].weight
    assert abs(bn.mean().item() - 1.0) < 0.02 and bn.std().item() > 0
    gru = a.apc.rnns[0].weight_hh_l0
    assert gru.abs().max().item() <= 1 / np.sqrt(cfg.apc.hidden_size)
    assert assets.synthetic_seed(replace(cfg, name="May")) != 0


def _run_jax_free(code: str, tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_port_imports_no_jax(tmp_path):
    code = (
        "import importlib, pkgutil, sys\n"
        "import livespeechportraits_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "from livespeechportraits_torch import demo\n"
        "try:\n"
        "    demo.main(['--help'])\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "print('ok')\n")
    assert _run_jax_free(code, tmp_path).strip().endswith("ok")


def test_demo_runs_on_cpu_without_jax(tmp_path):
    """The entry point end to end on the CPU at 32^2 (full-width motion
    models, a small renderer), with a missing audio file."""
    code = (
        "import sys\n"
        "from livespeechportraits_torch import demo\n"
        "demo.main(['--device', 'cpu', '--image_size', '32', '--duration', '0.5',\n"
        "           '--driving_audio', 'missing.wav', '--results_dir', 'out'])\n"
        "assert 'jax' not in sys.modules\n")
    stdout = _run_jax_free(code, tmp_path)
    assert "15 frames" in stdout and "fps" in stdout
    written = os.listdir(tmp_path / "out" / "Synthetic" / "missing")
    assert "missing.avi" in written or "frames.npy" in written


def test_kernel_library_is_keyed_by_its_sources():
    """The build's file name carries a hash of the CUDA sources and flags,
    so an edit rebuilds; it lands in the git-ignored build/ directory."""
    from livespeechportraits_torch import _build
    from livespeechportraits_torch.ops import rasterize_cuda

    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR and path.name.startswith("liblsp_kernels_")
    assert path == _build.library_path()
    assert {s.name for s in _build._sources()} >= {"rasterize.cu", "recurrent.cu"}
    with pytest.raises(ValueError, match="unsupported device"):
        rasterize_cuda.rasterize_segments(torch.zeros(1, 4, 4, device="meta"), 8, 8)
