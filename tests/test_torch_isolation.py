"""The PyTorch port stands alone: it imports nothing of the JAX package, keeps
its own copy of the configuration (equal to the JAX package's, field by
field), and its entry points run on the card unless asked for the CPU."""

import ast
import dataclasses
import importlib
import inspect
import os
import subprocess
import sys
from pathlib import Path

import pytest

from livespeechportraits_torch import config as tconfig
from livespeechportraits_torch.ops import mel
from livespeechportraits_torch.parallel import dryrun
from livespeechportraits_torch.pipeline import assets
from livespeechportraits_torch.utils import profiling
from livespeechportraits_tpu import config as jconfig
from torch_parity import small_person_config, torch_config

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "livespeechportraits_torch"
CONFIGS = ("PersonConfig", "APCConfig", "Audio2FeatureConfig", "Audio2HeadposeConfig",
           "WaveNetConfig", "Feature2FaceConfig", "MeshConfig")


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_imports_no_module_of_the_jax_package(tmp_path):
    """In a fresh interpreter where any import of livespeechportraits_tpu
    raises, every module of the port and chip_smoke.py import, and a
    PersonConfig builds."""
    code = (
        "import importlib, pkgutil, sys\n"
        "class Refuse:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] == 'livespeechportraits_tpu':\n"
        "            raise ImportError('the port imported ' + name)\n"
        "sys.meta_path.insert(0, Refuse())\n"
        "import livespeechportraits_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "from livespeechportraits_torch.config import PersonConfig\n"
        "cfg = PersonConfig()\n"
        "assert cfg.feature2face.load_size == 512\n"
        "assert not any(k.startswith('livespeechportraits_tpu') for k in sys.modules)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def _jax_package_imports(path: Path):
    """(line, module) of every import of livespeechportraits_tpu in a file;
    comments and docstrings may name it."""
    found = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        elif isinstance(node, ast.Call) and node.args and isinstance(node.args[0], ast.Constant):
            fn = node.func
            fname = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            if fname in ("import_module", "__import__") and isinstance(node.args[0].value, str):
                names = [node.args[0].value]
        found += [(node.lineno, n) for n in names if n.split(".")[0] == "livespeechportraits_tpu"]
    return found


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_source_of_the_port_imports_the_jax_package(path):
    assert _jax_package_imports(path) == []


def test_the_import_scan_finds_an_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text('"""livespeechportraits_tpu in a docstring"""\n'
                 "import os  # livespeechportraits_tpu in a comment\n"
                 "from livespeechportraits_tpu.config import FPS\n"
                 "import livespeechportraits_tpu.pipeline\n"
                 "importlib.import_module('livespeechportraits_tpu')\n")
    assert [n for _, n in _jax_package_imports(f)] == [
        "livespeechportraits_tpu.config", "livespeechportraits_tpu.pipeline",
        "livespeechportraits_tpu"]


@pytest.mark.parametrize("name", CONFIGS)
def test_config_defaults_equal_the_jax_package(name):
    """The port's copy of each config class has the JAX package's fields
    and defaults, so the two cannot drift apart unseen."""
    ours, ref = getattr(tconfig, name)(), getattr(jconfig, name)()
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    for prop in ("receptive_field", "dilations", "gmm_output_dim", "input_nc"):
        if hasattr(ref, prop):
            assert getattr(ours, prop) == getattr(ref, prop)


def test_config_constants_and_yaml_overlay_equal_the_jax_package(tmp_path):
    for name in ("SAMPLE_RATE", "FPS", "MEL_RATE", "IMAGE_SIZE", "MOUTH_INDICES",
                 "EYE_BROW_INDICES"):
        assert getattr(tconfig, name) == getattr(jconfig, name), name
    yaml_text = ("model_params:\n  APC: {hidden_size: 256, Knear: 7}\n"
                 "  Audio2Mouth: {smooth: 2.0, AMP: [XYZ, 1.5, 1.5, 2.5]}\n"
                 "  Headpose: {sigma: 0.2, smooth: [3, 6], AMP: [0.8, 0.4]}\n"
                 "  Image2Image: {size: large}\ndataset_params: {root: /data/May}\n")
    path = tmp_path / "May.yaml"
    path.write_text(yaml_text)
    ours, ref = tconfig.load_person_config(str(path)), jconfig.load_person_config(str(path))
    assert isinstance(ours, tconfig.PersonConfig) and ours.name == "May"
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    small = small_person_config()
    assert dataclasses.asdict(torch_config(small)) == dataclasses.asdict(small)
    assert type(torch_config(small).audio2headpose.wavenet) is tconfig.WaveNetConfig


@pytest.mark.parametrize("fn", [assets.make_synthetic_person, assets.from_jax,
                                assets.load_models_artifact, mel.compute_mel_sequence,
                                profiling.link_probe, dryrun.dryrun_multichip],
                         ids=lambda f: f.__name__)
def test_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_dryrun_command_defaults_to_the_card(monkeypatch):
    """python -m livespeechportraits_torch.parallel.dryrun runs on the card
    unless --device cpu."""
    seen = {}
    monkeypatch.setattr(dryrun, "dryrun_multichip",
                        lambda n, device: seen.update(n=n, device=device) or "line")
    assert dryrun.main(["--ranks", "2"]) == 0 and seen == {"n": 2, "device": "cuda"}


TOOLS = ("trace_render", "int8_probe", "render_ablate", "trace_train", "stream_latency",
         "prewarm_serving", "parity", "train512", "upload_diet")


@pytest.mark.parametrize("name", TOOLS)
def test_tools_default_to_the_card(name):
    """Each measurement tool's main runs on the card unless --device cpu."""
    tool = importlib.import_module(f"livespeechportraits_torch.tools.{name}")
    assert tool.build_parser().parse_args([]).device == "cuda"
    assert "argv" in inspect.signature(tool.main).parameters
