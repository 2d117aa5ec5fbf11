"""Typed configuration of the PyTorch port.

The port's own copy of the JAX package's configuration tree
(``livespeechportraits_tpu/config.py``): ``PersonConfig`` and the four
model configs it nests, the pipeline constants, the reference-format YAML
overlay (``load_person_config``) and ``replace``.  The defaults are the JAX
package's, field by field (``tests/test_torch_isolation.py`` holds the two
copies together), so a config describes the same model in either package.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import List, Tuple

try:  # PyYAML is optional: only load_person_config needs it
    import yaml
except ImportError:  # pragma: no cover
    yaml = None

# Pipeline constants (reference demo.py:73-75)
SAMPLE_RATE = 16000
FPS = 60
MEL_RATE = 120  # 2 mel frames per video frame
IMAGE_SIZE = 512
# mouth-region landmark indices consumed by the mouth stage
MOUTH_INDICES: Tuple[int, ...] = tuple(range(4, 11)) + tuple(range(46, 64))
EYE_BROW_INDICES: Tuple[int, ...] = (
    27, 65, 28, 68, 29, 67, 30, 66, 31, 72, 32, 69, 33, 70, 34, 71,
)


@dataclass(frozen=True)
class APCConfig:
    """APC (Autoregressive Predictive Coding) GRU encoder and the LLE
    projection knobs."""

    mel_dim: int = 80
    hidden_size: int = 512
    num_layers: int = 3
    residual: bool = False
    ckpt_path: str = ""
    time_shift: int = 3  # pretraining target offset (not used at inference)
    use_LLE: bool = True
    Knear: int = 10
    LLE_percent: float = 1.0


@dataclass(frozen=True)
class Audio2FeatureConfig:
    """Audio2Feature ("Audio2Mouth") decoder head."""

    decoder: str = "lstm"  # 'lstm' | 'wavenet'
    apc_hidden_size: int = 512
    lstm_hidden_size: int = 256
    lstm_layers: int = 3
    output_dim: int = 75  # 25 mouth points x 3
    frame_future: int = 18
    loss: str = "L2"  # 'L2' | 'GMM'
    gmm_ncenter: int = 1
    gmm_sigma_min: float = 0.03
    ckpt_path: str = ""
    smooth_sigma: float = 1.5
    amp_method: str = "XYZ"
    amp_params: Tuple[float, ...] = (2.0, 2.0, 2.0)


@dataclass(frozen=True)
class WaveNetConfig:
    """Conditional WaveNet core with the Audio2Headpose defaults."""

    residual_layers: int = 7
    residual_blocks: int = 2
    dilation_channels: int = 128
    residual_channels: int = 128
    skip_channels: int = 256
    kernel_size: int = 2
    use_bias: bool = True
    cond: bool = True
    cond_channels: int = 512
    input_channels: int = 12  # pose(6) + velocity(6)
    activation: str = "leakyrelu"

    @property
    def receptive_field(self) -> int:
        """1 + blocks * (2**layers - 1) for kernel_size=2."""
        rf = 1
        scope = self.kernel_size - 1
        for _ in range(self.residual_blocks):
            s = scope
            for _ in range(self.residual_layers):
                rf += s
                s *= 2
        return rf

    @property
    def dilations(self) -> Tuple[int, ...]:
        out: List[int] = []
        for _ in range(self.residual_blocks):
            d = 1
            for _ in range(self.residual_layers):
                out.append(d)
                d *= 2
        return tuple(out)


@dataclass(frozen=True)
class Audio2HeadposeConfig:
    """Audio2Headpose conditional WaveNet + GMM head."""

    decoder: str = "wavenet"  # 'wavenet' | 'lstm'
    apc_hidden_size: int = 512
    wavenet: WaveNetConfig = field(default_factory=WaveNetConfig)
    ndim: int = 12  # 6-DoF pose + velocities
    ncenter: int = 1
    sigma_min: float = 0.03
    frame_future: int = 15
    loss: str = "GMM"
    ckpt_path: str = ""
    sample_sigma_scale: float = 0.3
    smooth_sigmas: Tuple[float, float] = (5.0, 10.0)  # rot, trans
    rot_amp: float = 1.0
    trans_amp: float = 0.5
    shoulder_amp: float = 0.5

    @property
    def gmm_output_dim(self) -> int:
        return (2 * self.ndim + 1) * self.ncenter


@dataclass(frozen=True)
class Feature2FaceConfig:
    """Feature2Face renderer (pix2pixHD-flavoured U-Net)."""

    size: str = "normal"  # 'small' | 'normal' | 'large'
    ngf: int = 64
    n_downsample: int = 8
    output_nc: int = 3
    load_size: int = IMAGE_SIZE
    # discriminator and loss weights: kept so the copy stays field-for-field
    # equal to the JAX package's; the port's inference path does not read them
    ndf: int = 64
    n_layers_D: int = 3
    num_D: int = 2
    lambda_L1: float = 100.0
    lambda_feat: float = 10.0
    gan_mode: str = "ls"
    ckpt_path: str = ""
    save_input: bool = False
    precision: str = "bfloat16"  # the renderer's compute dtype

    @property
    def input_nc(self) -> int:
        """1-ch edge map + 4 candidate RGB images = 13 ('small' variant: 23)."""
        return 23 if self.size == "small" else 13


@dataclass(frozen=True)
class MeshConfig:
    """The (data, model) grid of ranks (parallel.mesh.mesh_from_config): the
    data axis splits the batch, the model axis a renderer's channels or its
    rows (parallel.sharding)."""

    data_axis: str = "data"
    model_axis: str = "model"
    model_parallel_size: int = 1


@dataclass(frozen=True)
class PersonConfig:
    """Per-subject asset and knob pack: the surface of config/*.yaml."""

    name: str = "Synthetic"
    data_root: str = ""
    fit_data_path: str = ""
    pts3d_path: str = ""
    apc: APCConfig = field(default_factory=APCConfig)
    audio2feature: Audio2FeatureConfig = field(default_factory=Audio2FeatureConfig)
    audio2headpose: Audio2HeadposeConfig = field(default_factory=Audio2HeadposeConfig)
    feature2face: Feature2FaceConfig = field(default_factory=Feature2FaceConfig)


def person_config_from_dict(cfg: dict, name: str = "") -> PersonConfig:
    """A PersonConfig from a reference-format YAML dict.  Beyond the
    reference's keys, Audio2Mouth may name ``loss: GMM`` and
    ``gmm_ncenter``: the head of its checkpoint."""
    mp = cfg.get("model_params", {})
    dp = cfg.get("dataset_params", {})

    apc_d = mp.get("APC", {})
    apc = APCConfig(
        mel_dim=int(apc_d.get("mel_dim", 80)),
        hidden_size=int(apc_d.get("hidden_size", 512)),
        num_layers=int(apc_d.get("num_layers", 3)),
        residual=bool(apc_d.get("residual", False)),
        ckpt_path=str(apc_d.get("ckp_path", "")),
        use_LLE=bool(apc_d.get("use_LLE", True)),
        Knear=int(apc_d.get("Knear", 10)),
        LLE_percent=float(apc_d.get("LLE_percent", 1.0)),
    )

    a2m = mp.get("Audio2Mouth", {})
    amp = list(a2m.get("AMP", ["XYZ", 2, 2, 2]))
    a2f = Audio2FeatureConfig(
        apc_hidden_size=apc.hidden_size,
        ckpt_path=str(a2m.get("ckp_path", "")),
        # the head a subject's checkpoint was trained with; the reference's
        # YAMLs (and the JAX package) know only the L2 head
        loss=str(a2m.get("loss", "L2")),
        gmm_ncenter=int(a2m.get("gmm_ncenter", 1)),
        smooth_sigma=float(a2m.get("smooth", 1.5)),
        amp_method=str(amp[0]),
        amp_params=tuple(float(x) for x in amp[1:]),
    )

    hp = mp.get("Headpose", {})
    smooth = hp.get("smooth", [5, 10])
    hp_amp = hp.get("AMP", [1, 0.5])
    a2h = Audio2HeadposeConfig(
        apc_hidden_size=apc.hidden_size,
        ckpt_path=str(hp.get("ckp_path", "")),
        sample_sigma_scale=float(hp.get("sigma", 0.3)),
        smooth_sigmas=(float(smooth[0]), float(smooth[1])),
        rot_amp=float(hp_amp[0]),
        trans_amp=float(hp_amp[1]),
        shoulder_amp=float(hp.get("shoulder_AMP", 0.5)),
    )

    i2i = mp.get("Image2Image", {})
    f2f = Feature2FaceConfig(
        size=str(i2i.get("size", "normal")),
        ckpt_path=str(i2i.get("ckp_path", "")),
        save_input=bool(i2i.get("save_input", False)),
    )

    return PersonConfig(
        name=name or str(cfg.get("name", "")),
        data_root=str(dp.get("root", "")),
        fit_data_path=str(dp.get("fit_data_path", "")),
        pts3d_path=str(dp.get("pts3d_path", "")),
        apc=apc,
        audio2feature=a2f,
        audio2headpose=a2h,
        feature2face=f2f,
    )


def load_person_config(path: str, name: str = "") -> PersonConfig:
    """Load a per-person YAML (reference config/<id>.yaml format)."""
    if yaml is None:  # pragma: no cover
        raise RuntimeError("PyYAML unavailable; cannot load YAML person config")
    with open(path) as f:
        cfg = yaml.safe_load(f)
    if not name:
        name = os.path.splitext(os.path.basename(path))[0]
    return person_config_from_dict(cfg, name=name)


def replace(cfg, **kwargs):
    """Functional update of a frozen config dataclass."""
    return dataclasses.replace(cfg, **kwargs)
