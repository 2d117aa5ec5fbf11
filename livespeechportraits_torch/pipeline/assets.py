"""Per-person asset packs and the four models, on PyTorch.

Counterpart of ``livespeechportraits_tpu/pipeline/assets.py``
(``PersonAssets``, ``PersonModels``, ``load_person``, ``load_person_models``,
``load_trained_person_models``, ``make_synthetic_person``,
``quantize_person_models`` and the serving artifact).  ``load_subject`` is the choice between a reference-format
subject directory and the synthetic subject that the JAX package's
``serve.py`` and ``demo.py`` each make.  The asset
arrays stay numpy; ``PersonAssets.tensor`` uploads one to a device once and
caches it.  ``make_synthetic_person`` builds the same numpy asset pack as the
JAX package, bit for bit (same ``default_rng`` draws in the same order); its
random-init models come from a ``torch.Generator`` at the JAX init scales,
so they are not the JAX package's weights - ``from_jax`` loads those.
"""

from __future__ import annotations

import json
import math
import os
import types
import zlib
from dataclasses import dataclass, replace
from typing import Any, Optional, Tuple

import numpy as np
import torch

from livespeechportraits_torch.config import EYE_BROW_INDICES, PersonConfig
from livespeechportraits_torch.config import replace as replace_cfg
from livespeechportraits_torch.models.apc import APCEncoder
from livespeechportraits_torch.models.audio2feature import Audio2Feature
from livespeechportraits_torch.models.audio2headpose import Audio2Headpose
from livespeechportraits_torch.models import feature2face as f2f
from livespeechportraits_torch.models.feature2face import Feature2FaceG
from livespeechportraits_torch.utils.convert import (load_state_dict, params_from_jax,
                                                     params_to_jax)

MODEL_FIELDS = ("apc", "audio2feature", "audio2headpose", "feature2face")


@dataclass
class PersonAssets:
    """Numpy-side per-subject data."""

    mean_pts3d: np.ndarray  # [73, 3]
    std_mean_pts3d: np.ndarray  # [73, 3] mean of tracked pts3d
    mean_translation: np.ndarray  # [3]
    candidate_eye_brow: np.ndarray  # [Ncand, 16, 3]
    candidate_images: np.ndarray  # [4, H, W, 3] float32 in [-1, 1]
    shoulders: np.ndarray  # [18, 2]
    shoulder3D: np.ndarray  # [18, 3]
    ref_trans: np.ndarray  # [3]
    camera_intrinsic: np.ndarray  # [3, 3]
    apc_feature_base: np.ndarray  # [N, 512] LLE bank
    scale: float
    image_pad: Optional[tuple] = None  # (top, bottom, left, right)

    def tensor(self, name: str, device: torch.device | str) -> torch.Tensor:
        """A field as a tensor on ``device``, uploaded once and cached (the
        LLE bank and the candidate images are megabytes)."""
        cache = self.__dict__.setdefault("_tensor_cache", {})
        key = (name, str(torch.device(device)))
        if key not in cache:
            cache[key] = torch.as_tensor(np.asarray(getattr(self, name)), device=device)
        return cache[key]


@dataclass
class PersonModels:
    """The four learned stages as modules, in eval mode, without gradients."""

    apc: APCEncoder
    audio2feature: Audio2Feature
    audio2headpose: Audio2Headpose
    feature2face: Feature2FaceG

    def to(self, device: torch.device | str) -> "PersonModels":
        for m in self._modules():
            m.to(device)
        return self

    def _modules(self):
        return tuple(getattr(self, name) for name in MODEL_FIELDS)


def build_models(cfg: PersonConfig) -> PersonModels:
    """Modules for ``cfg`` with uninitialised weights."""
    models = PersonModels(
        apc=APCEncoder(cfg.apc),
        audio2feature=Audio2Feature(cfg.audio2feature),
        audio2headpose=Audio2Headpose(cfg.audio2headpose),
        feature2face=Feature2FaceG(cfg.feature2face),
    )
    for m in models._modules():
        m.eval().requires_grad_(False)
    return models


def init_models(cfg: PersonConfig, seed: int) -> PersonModels:
    """Random-init models at the JAX init scales, drawn on the CPU from one
    ``torch.Generator`` so the weights are the same whatever the device."""
    gen = torch.Generator().manual_seed(seed)
    models = build_models(cfg)
    for m in models._modules():
        m.reset_parameters(gen)
    return models


def from_jax(cfg: PersonConfig, models_np: Any, device: torch.device | str = "cuda"
             ) -> PersonModels:
    """Load a JAX ``PersonModels`` (pytrees of numpy-convertible leaves)
    through ``params_from_jax``; every module loads with strict=True.  A
    quantized, folded or calibrated generator tree loads into the matching
    int8 module tree, its folded BatchNorms marked (f2f.mark_folded_bn)."""
    models = build_models(cfg)
    for name in MODEL_FIELDS:
        sd = params_from_jax(getattr(models_np, name))
        if name == "feature2face":
            f2f.conform_to_state_dict(models.feature2face, sd)
        getattr(models, name).load_state_dict(sd, strict=True)
    f2f.mark_folded_bn(models.feature2face)
    return models.to(device)


def load_person(cfg: PersonConfig, data_root: Optional[str] = None,
                image_size: Optional[int] = None) -> PersonAssets:
    """Read a reference-format subject directory (the reference's
    demo.py:80-108; JAX assets.load_person): mean and tracked 3D landmarks,
    the fit track's translations, the four candidate images, the shoulders,
    the camera, the APC feature bank and id_scale.mat's scale (1.0 when the
    file is absent).

    image_size: the render size.  The candidates of a pack are normalised to
    512 px (change_paras); a pack built from clips of image_size px has them
    512 / image_size times larger, and every such k-th pixel is kept.  None
    keeps them as they are, as JAX does."""
    from PIL import Image

    root = data_root or cfg.data_root
    mean_pts3d = np.load(os.path.join(root, "mean_pts3d.npy"))
    fit_data = np.load(cfg.fit_data_path or os.path.join(root, "3d_fit_data.npz"))
    tracked = np.load(cfg.pts3d_path
                      or os.path.join(root, "tracked3D_normalized_pts_fix_contour.npy"))
    pts3d = tracked - mean_pts3d
    trans = fit_data["trans"][:, :, 0].astype(np.float32)

    cands = []
    for j in range(4):
        with Image.open(os.path.join(root, "candidates", f"normalized_full_{j}.jpg")) as im:
            img = np.asarray(im).astype(np.float32)
        cands.append((img / 255.0 - 0.5) / 0.5)
    candidate_images = np.stack(cands)
    if image_size is not None and candidate_images.shape[1] != image_size:
        k = candidate_images.shape[1] // image_size
        if k * image_size != candidate_images.shape[1] or candidate_images.shape[2] % image_size:
            raise ValueError(f"candidates of {candidate_images.shape[1:3]} px do not reduce "
                             f"to {image_size} px by a whole stride")
        candidate_images = np.ascontiguousarray(candidate_images[:, ::k, ::k])

    try:
        import scipy.io as sio

        scale = float(sio.loadmat(os.path.join(root, "id_scale.mat"))["scale"][0, 0])
    except FileNotFoundError:
        scale = 1.0

    return PersonAssets(
        mean_pts3d=mean_pts3d.astype(np.float32),
        std_mean_pts3d=tracked.mean(axis=0).astype(np.float32),
        mean_translation=trans.mean(axis=0),
        candidate_eye_brow=pts3d[10:, list(EYE_BROW_INDICES)].astype(np.float32),
        candidate_images=candidate_images,
        shoulders=np.load(os.path.join(root, "normalized_shoulder_points.npy")
                          ).astype(np.float32),
        shoulder3D=np.load(os.path.join(root, "shoulder_points3D.npy"))[1].astype(np.float32),
        ref_trans=trans[1],
        camera_intrinsic=np.load(os.path.join(root, "camera_intrinsic.npy")
                                 ).astype(np.float32),
        apc_feature_base=np.load(os.path.join(root, "APC_feature_base.npy")
                                 ).astype(np.float32),
        scale=scale,
    )


def load_person_models(cfg: PersonConfig, device: torch.device | str = "cuda"
                       ) -> PersonModels:
    """The subject's four models from its reference .pkl checkpoints (the
    reference's demo.py:144-171), each loaded with strict=True.  A stage
    whose ``ckpt_path`` is empty keeps its random init (seed 0), with a
    printed note, as a pack built by pipeline/build_person.py has no
    checkpoints; a path that fails to load raises."""
    models = init_models(cfg, 0)
    paths = {"apc": (cfg.apc.ckpt_path, "APC"),
             "audio2feature": (cfg.audio2feature.ckpt_path, "Audio2Feature"),
             "audio2headpose": (cfg.audio2headpose.ckpt_path, "Audio2Headpose"),
             "feature2face": (cfg.feature2face.ckpt_path, "Feature2Face")}
    missing = [what for path, what in paths.values() if not path]
    if missing:
        print(f"no torch checkpoint configured for {', '.join(missing)}; "
              "random-init (override with --apc_ckpt/--a2f_ckpt/--a2h_ckpt/"
              "--f2f_ckpt trainer checkpoints)")
    for name, (path, _) in paths.items():
        if path:
            getattr(models, name).load_state_dict(load_state_dict(path), strict=True)
    return models.to(device)


def load_trained_person_models(cfg: PersonConfig, base: PersonModels, f2f_ckpt: str = "",
                               a2f_ckpt: str = "", a2h_ckpt: str = "", apc_ckpt: str = "",
                               step: Optional[int] = None) -> PersonModels:
    """``base`` with the stages the port's trainers wrote swapped in, each
    loaded with strict=True (a checkpoint of another architecture raises).
    Each ``*_ckpt`` is a trainer run's ``<checkpoints_dir>/<name>/ckpt``;
    ``step`` picks an epoch there, else the run's ``ckpt_best`` is read when
    it kept one, else its latest epoch.  From a Feature2Face checkpoint the
    generator is kept, from an APC one the encoder (the LLE bank of the
    subject must come from the same encoder).  A QAT generator (its file's
    ``qat_mode``) loads through a tagged template and is stripped to the
    plain float model (JAX assets.py:300-310), which serving quantizes,
    folds and calibrates as any other.  The modules land on base's device,
    in eval mode, without gradients."""
    from livespeechportraits_torch.utils import checkpoint as ckpt

    def read_state(path: str) -> dict:
        if step is None:
            path = ckpt.prefer_best(path)
        return ckpt.load_checkpoint(path, step)

    def read(path: str) -> dict:
        return read_state(path)["models"]

    def swap(name: str, sd: dict) -> None:
        module = getattr(base, name)
        dev = next(module.parameters()).device
        module.load_state_dict(sd, strict=True)
        module.to(dev)

    if f2f_ckpt:
        st = read_state(f2f_ckpt)
        mode = ckpt.qat_mode(st)
        if mode is None:
            swap("feature2face", st["models"]["G"])
        else:
            tagged = f2f.qat_generator(base.feature2face, int8_forward=mode == "fq8")
            tagged.load_state_dict(st["models"]["G"], strict=True)
            base.feature2face = f2f.strip_qat_generator(tagged)
    if a2f_ckpt:
        swap("audio2feature", read(a2f_ckpt)["params"])
    if a2h_ckpt:
        swap("audio2headpose", read(a2h_ckpt)["params"])
    if apc_ckpt:
        sd = read(apc_ckpt)["params"]
        swap("apc", {k[len("encoder."):]: v for k, v in sd.items()
                     if k.startswith("encoder.")})
    return base


def load_trained_discriminator(cfg: PersonConfig, f2f_ckpt: str,
                               device: torch.device | str = "cuda") -> f2f.Feature2FaceD:
    """The discriminator of a Feature2Face trainer run (``f2f_ckpt`` as in
    load_trained_person_models; its ckpt_best when it kept one), loaded with
    strict=True into cfg.feature2face's architecture, in eval mode on
    ``device`` (JAX assets.py:335-369): the learned feature space of
    utils/metrics.d_feature_distance."""
    from livespeechportraits_torch.utils import checkpoint as ckpt

    d = f2f.Feature2FaceD(cfg.feature2face)
    try:
        d.load_state_dict(ckpt.load_checkpoint(ckpt.prefer_best(f2f_ckpt))["models"]["D"],
                          strict=True)
    except RuntimeError as e:
        raise ValueError("the discriminator checkpoint does not match the person config's "
                         "architecture (ndf / num_D / n_layers_D); pass the config it was "
                         f"trained with: {e}") from e
    return d.to(device).eval().requires_grad_(False)


def load_subject(cfg: PersonConfig, image_size: Optional[int] = 512, skip_models: bool = False,
                 device: torch.device | str = "cuda"
                 ) -> Tuple[PersonConfig, PersonAssets, Optional[PersonModels]]:
    """(cfg, assets, models) of the subject ``cfg`` describes, chosen as the
    JAX package's serve.py:96-117 and demo.py:123-138 choose: 'Synthetic',
    or a config without a data_root, is the synthetic subject; any other is
    read from its data_root (load_person) with the models of its
    checkpoints (load_person_models).  image_size sets the render size (and
    the U-Net's depth, down to 1 px) of either; None keeps the config's.
    skip_models returns no models (the caller loads a serving artifact)."""
    if image_size:
        n_down = min(8, int(math.log2(image_size)))
        cfg = replace_cfg(cfg, feature2face=replace_cfg(cfg.feature2face, load_size=image_size,
                                                        n_downsample=n_down))
    size = cfg.feature2face.load_size
    if cfg.name == "Synthetic" or not cfg.data_root:
        person, models = make_synthetic_person(cfg, image_size=size, skip_models=skip_models,
                                               device=device)
        return cfg, person, models
    person = load_person(cfg, image_size=size)
    return cfg, person, None if skip_models else load_person_models(cfg, device)


def quantize_person_models(models: PersonModels, fold_bn: bool = True,
                           calibrate_inputs=None, calibrate_dtype: Optional[torch.dtype] = None,
                           calibrate_margin: float = 1.0, subpixel: bool | str = False,
                           s2d_input: bool = False, split_skip: bool = False) -> PersonModels:
    """A copy with the renderer int8-quantized for inference
    (feature2face.quantize_generator), its BN folded into the convs
    (fold_bn) and, given ``calibrate_inputs`` (a [B, H, W, input_nc]
    renderer batch or a list, e.g. animate.build_render_inputs), static
    activation scales measured in ``calibrate_dtype`` with
    ``calibrate_margin``; then transform_person_models' rewrites, which come
    after the calibration.  The motion models are shared, unchanged."""
    net = f2f.quantize_generator(models.feature2face)
    if fold_bn:
        net = f2f.fold_bn_generator(net)
    if calibrate_inputs is not None:
        net = f2f.calibrate_generator(net, calibrate_inputs, compute_dtype=calibrate_dtype,
                                      margin=calibrate_margin)
    return transform_person_models(replace(models, feature2face=net), subpixel=subpixel,
                                   s2d_input=s2d_input, split_skip=split_skip)


# transform_person_models' arguments of each named rewrite and of the
# compositions the tests, the tools and chip_smoke.py run
REWRITE_FORMS = {"four": {"subpixel": "four"}, "single": {"subpixel": "single"},
                 "single_outermost": {"subpixel": "single_outermost"},
                 "dilated": {"subpixel": "dilated"}, "s2d": {"s2d_input": True},
                 "split": {"split_skip": True},
                 "s2d+four": {"subpixel": "four", "s2d_input": True},
                 "s2d+split": {"s2d_input": True, "split_skip": True}}


def transform_person_models(models: PersonModels, subpixel: bool | str = False,
                            s2d_input: bool = False, split_skip: bool = False) -> PersonModels:
    """The renderer's structural rewrites, exact on float and int8 models
    (JAX assets.transform_person_models), applied in JAX's order:

    subpixel: True or "four" (four 2x2 phase convs), "single" (one 3x3 conv
    with 4x the outputs), "dilated" (one 4x4 conv over the dilated input),
    each with "_outermost" to rewrite only the to-RGB up conv
    (feature2face.subpixel_generator); on an int8 model after calibration.
    s2d_input: the 13-channel input conv over the space-to-depth packed
    input (split_cand then refuses the model).  split_skip: the concat-free
    split up convs; with subpixel it raises (the same up convs)."""
    net = models.feature2face
    if subpixel:
        mode = "four" if subpixel is True else str(subpixel)
        net = f2f.subpixel_generator(net, mode=mode.replace("_outermost", ""),
                                     outermost_only=mode.endswith("_outermost"))
    if s2d_input:
        net = f2f.s2d_input_generator(net)
    if split_skip:
        net = f2f.split_skip_generator(net)
    return replace(models, feature2face=net)


# ---------------------------------------------------------------------------
# Serving artifact in the JAX package's format (assets.py:485-553 there): one
# .npz holding every leaf of the four JAX parameter trees plus a JSON
# manifest of their structure, so an artifact written by either package boots
# the other.
# ---------------------------------------------------------------------------


def _flatten_tree(tree, prefix: str, out: dict, bf16: bool):
    """bf16: the tree's float leaves hold bfloat16 values (a cast module);
    they are stored as float32 and marked "dt": "bfloat16", as JAX does."""
    if isinstance(tree, dict):
        return {"t": "d", "k": {k: _flatten_tree(v, f"{prefix}.{k}", out, bf16)
                                for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        return {"t": "l" if isinstance(tree, list) else "u",
                "i": [_flatten_tree(v, f"{prefix}.{n}", out, bf16)
                      for n, v in enumerate(tree)]}
    if isinstance(tree, (str, int, float, bool)) or tree is None:
        return {"t": "p", "v": tree}
    out[prefix] = np.asarray(tree)
    spec = {"t": "a", "key": prefix}
    if bf16 and out[prefix].dtype == np.float32:
        spec["dt"] = "bfloat16"
    return spec


def _unflatten_tree(spec, arrays):
    t = spec["t"]
    if t == "d":
        return {k: _unflatten_tree(v, arrays) for k, v in spec["k"].items()}
    if t in ("l", "u"):
        seq = [_unflatten_tree(v, arrays) for v in spec["i"]]
        return seq if t == "l" else tuple(seq)
    if t == "p":
        return spec["v"]
    # a leaf marked "dt": "bfloat16" is stored as the float32 of the same
    # value; the port's modules load it as float32, exactly
    return arrays[spec["key"]]


def save_models_artifact(models: PersonModels, path: str) -> str:
    """Write the four models (int8 weights and calibrated scales included)
    as one .npz with a JSON manifest.  Returns the path written."""
    arrays: dict = {}
    manifest = {}
    for name in MODEL_FIELDS:
        model = getattr(models, name)
        bf16 = next(model.parameters()).dtype == torch.bfloat16
        manifest[name] = _flatten_tree(params_to_jax(model), name, arrays, bf16)
    arrays["__manifest__"] = np.frombuffer(json.dumps(manifest).encode(), dtype=np.uint8)
    with open(path, "wb") as f:  # a file handle: np.savez appends no .npz
        np.savez(f, **arrays)
    return path


def load_models_artifact(path: str, cfg: PersonConfig, device: torch.device | str = "cuda"
                         ) -> PersonModels:
    """Inverse of save_models_artifact, onto ``device``."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    manifest = json.loads(bytes(arrays.pop("__manifest__")).decode())
    trees = {name: _unflatten_tree(spec, arrays) for name, spec in manifest.items()}
    return from_jax(cfg, types.SimpleNamespace(**trees), device)


def _synthetic_face_landmarks() -> np.ndarray:
    """A plausible 73-point 3D face in the tracker's frame: about 0.2 units
    across, centred at the origin, mouth on rows 46-63."""
    rng = np.random.default_rng(1234)
    pts = np.zeros((73, 3), np.float32)
    ang = np.linspace(-np.pi * 0.8, np.pi * 0.8, 15)
    pts[0:15] = np.stack([0.1 * np.sin(ang), -0.1 * np.cos(ang), np.zeros(15)], 1)
    pts[15:21] = [[0.02 + 0.008 * i, 0.06, 0.01] for i in range(6)]
    pts[21:27] = [[-0.02 - 0.008 * i, 0.06, 0.01] for i in range(6)]
    pts[27:31] = [[0.04 - 0.005 * i, 0.03, 0.012] for i in range(4)]
    pts[31:35] = [[-0.04 + 0.005 * i, 0.03, 0.012] for i in range(4)]
    pts[65:73] = pts[27:35] + np.array([0.0, 0.005, 0.0], np.float32)
    pts[35:46] = [[0.0, 0.02 - 0.006 * i, 0.02] for i in range(11)]
    mang = np.linspace(0, 2 * np.pi, 18, endpoint=False)
    pts[46:64] = np.stack(
        [0.03 * np.cos(mang), -0.05 + 0.015 * np.sin(mang), np.full(18, 0.015)], 1)
    pts[64] = [0.0, -0.05, 0.015]
    pts += rng.normal(0, 1e-3, pts.shape)
    return pts


def synthetic_seed(cfg: PersonConfig) -> int:
    """The deterministic per-name seed of the synthetic person."""
    return 0 if cfg.name == "Synthetic" else zlib.crc32(cfg.name.encode()) % 2**31


def make_synthetic_person(cfg: PersonConfig, image_size: int = 512, bank_size: int = 256,
                          skip_models: bool = False, device: torch.device | str = "cuda"
                          ) -> Tuple[PersonAssets, Optional[PersonModels]]:
    """Fabricate an asset pack and random-init models.  The camera sits at
    fx = fy = 2.4 * image_size with the face at z ~ 1, so the projected face
    lands inside the image."""
    rng = np.random.default_rng(0)
    mean_pts3d = _synthetic_face_landmarks()
    tracked = mean_pts3d[None] + rng.normal(0, 2e-3, (40, 73, 3)).astype(np.float32)

    f = image_size * 2.4
    K = np.array([[f, 0, image_size / 2], [0, f, image_size / 2], [0, 0, 1]], np.float32)
    mean_translation = np.array([0.0, 0.05, 1.0], np.float32)

    cands = rng.uniform(-0.3, 0.3, (4, image_size, image_size, 3)).astype(np.float32)
    shoulder_y = image_size * 0.8
    xs = np.linspace(image_size * 0.2, image_size * 0.8, 9, dtype=np.float32)
    shoulders2d = np.concatenate([np.stack([xs, np.full(9, shoulder_y)], 1),
                                  np.stack([xs, np.full(9, shoulder_y + 14)], 1)])
    sh3 = np.concatenate([
        np.stack([(xs - image_size / 2) / f, np.full(9, (shoulder_y - image_size / 2) / f),
                  np.ones(9)], 1),
        np.stack([(xs - image_size / 2) / f,
                  np.full(9, (shoulder_y + 14 - image_size / 2) / f), np.ones(9)], 1),
    ]).astype(np.float32)

    assets = PersonAssets(
        mean_pts3d=mean_pts3d,
        std_mean_pts3d=tracked.mean(axis=0),
        mean_translation=mean_translation,
        candidate_eye_brow=(tracked - mean_pts3d)[10:, list(EYE_BROW_INDICES)],
        candidate_images=cands,
        shoulders=shoulders2d,
        shoulder3D=sh3,
        ref_trans=mean_translation.copy(),
        camera_intrinsic=K,
        apc_feature_base=rng.normal(0, 1, (bank_size, cfg.apc.hidden_size)).astype(np.float32),
        scale=1.0,
    )
    if skip_models:
        return assets, None
    return assets, init_models(cfg, synthetic_seed(cfg)).to(device)
