"""JAX parameter pytrees <-> the port's state dicts.

The port's modules use the reference's state-dict key names (those that
``livespeechportraits_tpu/utils/torch_convert.export_*`` emit), so a JAX tree
converted here loads with ``load_state_dict(strict=True)``, and so will the
reference's released ``.pkl`` checkpoints.  Layout maps:

    JAX dense   [in, out]          -> Linear [out, in]
    JAX conv1d  [k, in, out]       -> Conv1d [out, in, k]
    JAX conv2d  [kh, kw, in, out]  -> Conv2d [out, in, kh, kw]
    JAX conv_transpose2d [kh, kw, in, out] -> ConvTranspose2d [in, out, kh, kw]
    JAX RNN     [in, G*H]          -> weight_*_l{k} [G*H, in]
    JAX int8 conv2d {w_q [kh, kw, in, out] int8, w_scale, b?, x_scale?}
                                   -> QConv2d {w_q [out, in, kh, kw], ...}
    JAX's renderer rewrites (nn_core.py:471-800 there), float or int8, each
    with b? and x_scale?:
        {w_ph(_q) [4, 2, 2, in, out], w_ph_scale [4, out]}
                                   -> UpConvSubpixel {w_ph(_q) [4*out, in, 2, 2], ...}
        {w_sp1(_q) [3, 3, in, 4*out], w_sp1_scale} -> UpConvSubpixel1 (OIHW)
        {w_dl(_q) [4, 4, in, out], w_dl_scale}    -> UpConvDilated (OIHW)
        {w_a(_q), w_b(_q) [3, 3, in_a|in_b, out], w_scale} -> UpConvSplit (OIHW)
        {w_s2d [2, 2, 4*in, out]}                 -> ConvS2DDown (OIHW)

The trainers' two extra trees convert too: the APC pretraining tree
({"encoder", "head"} -> ``encoder.rnns.*``, ``head.*``) and the
Feature2Face discriminator ({"scales"} -> the reference's
``scale{i}_layer{j}.{0,1}`` keys, JAX's scale k being the reference's
scale num_D-1-k).  So do the two decoder variants: Audio2Feature's WaveNet
({"wavenet"} alone -> ``WaveNet.*``) and the Audio2Headpose LSTM, whose tree
has Audio2Feature's keys and converts through
``audio2headpose_lstm_from_jax``.  ``params_to_jax`` is the inverse, for
these eight models; its leaves are numpy arrays (int8 weights stay int8, float leaves become float32).
Leaves may be numpy arrays or anything ``np.asarray`` accepts; this module
imports no JAX.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from livespeechportraits_torch.models import feature2face as f2f
from livespeechportraits_torch.models import nn_core
from livespeechportraits_torch.models.apc import APCEncoder, APCPretrain
from livespeechportraits_torch.models.audio2feature import Audio2Feature, Audio2FeatureWaveNet
from livespeechportraits_torch.models.audio2headpose import Audio2Headpose, Audio2HeadposeLSTM

StateDict = Dict[str, torch.Tensor]


def load_state_dict(path: str) -> StateDict:
    """A reference-format torch checkpoint (.pkl / .model) as {name: tensor}
    on the CPU: a saved module is unwrapped to its state_dict(), the
    DataParallel "module." prefixes are stripped and non-tensor entries
    dropped (the JAX package's torch_convert.load_state_dict_numpy, keeping
    tensors).  Only tensors and containers are unpickled (weights_only)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    out: StateDict = {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if isinstance(v, torch.Tensor):
            out[k] = v.detach()
    return out


def _t(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x, dtype=np.float32))


def _linear(p, out: StateDict, name: str) -> None:
    out[f"{name}.weight"] = _t(np.asarray(p["w"]).T)
    if "b" in p:
        out[f"{name}.bias"] = _t(p["b"])


def _conv1d(p, out: StateDict, name: str) -> None:
    out[f"{name}.weight"] = _t(np.asarray(p["w"]).transpose(2, 1, 0))
    if "b" in p:
        out[f"{name}.bias"] = _t(p["b"])


# The weight keys of JAX's rewritten layers (every other key of such a layer
# - a scale, b, x_scale - crosses as it is)
_REWRITE_WEIGHTS = ("w_ph", "w_ph_q", "w_sp1", "w_sp1_q", "w_dl", "w_dl_q", "w_a", "w_b",
                    "w_a_q", "w_b_q", "w_s2d")


def _rewrite_from_jax(p, out: StateDict, name: str) -> None:
    for k, v in p.items():
        a = np.asarray(v)
        if k in ("w_ph", "w_ph_q"):  # [4, 2, 2, in, out] -> [4 * out, in, 2, 2]
            a = a.transpose(0, 4, 3, 1, 2)
            a = a.reshape(-1, *a.shape[2:])
        elif k in _REWRITE_WEIGHTS:
            a = a.transpose(3, 2, 0, 1)
        out[f"{name}.{k}"] = (torch.tensor(np.ascontiguousarray(a)) if a.dtype == np.int8
                              else _t(a))


def _conv2d(p, out: StateDict, name: str) -> None:
    if any(k in p for k in _REWRITE_WEIGHTS):  # an inference rewrite of the renderer
        _rewrite_from_jax(p, out, name)
        return
    if "w_q" in p:  # int8 conv (nn_core.quantize_conv)
        out[f"{name}.w_q"] = torch.tensor(np.asarray(p["w_q"], np.int8).transpose(3, 2, 0, 1))
        out[f"{name}.w_scale"] = _t(p["w_scale"])
        for k in ("b", "x_scale"):
            if k in p:
                out[f"{name}.{k}"] = _t(p[k])
        return
    out[f"{name}.weight"] = _t(np.asarray(p["w"]).transpose(3, 2, 0, 1))
    for k, key in (("b", "bias"), ("x_scale", "x_scale")):  # x_scale: a calibrated QAT conv
        if k in p:
            out[f"{name}.{key}"] = _t(p[k])


def _conv_transpose2d(p, out: StateDict, name: str) -> None:
    out[f"{name}.weight"] = _t(np.asarray(p["w"]).transpose(2, 3, 0, 1))
    if "b" in p:
        out[f"{name}.bias"] = _t(p["b"])


def _batchnorm(p, out: StateDict, name: str) -> None:
    out[f"{name}.weight"] = _t(p["scale"])
    out[f"{name}.bias"] = _t(p["bias"])
    out[f"{name}.running_mean"] = _t(p["mean"])
    out[f"{name}.running_var"] = _t(p["var"])
    out[f"{name}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def _rnn(p, out: StateDict, prefix: str, layer: int = 0) -> None:
    out[f"{prefix}.weight_ih_l{layer}"] = _t(np.asarray(p["w_ih"]).T)
    out[f"{prefix}.weight_hh_l{layer}"] = _t(np.asarray(p["w_hh"]).T)
    out[f"{prefix}.bias_ih_l{layer}"] = _t(p["b_ih"])
    out[f"{prefix}.bias_hh_l{layer}"] = _t(p["b_hh"])


def _wavenet(p, out: StateDict, pre: str) -> None:
    _conv1d(p["start1"], out, f"{pre}.start_conv1")
    _conv1d(p["start2"], out, f"{pre}.start_conv2")
    _conv1d(p["end1"], out, f"{pre}.end_conv_1")
    _conv1d(p["end2"], out, f"{pre}.end_conv_2")
    for i, blk in enumerate(p["blocks"]):
        b = f"{pre}.residual_blocks.{i}"
        _conv1d(blk["filter"], out, f"{b}.filter_conv")
        _conv1d(blk["gate"], out, f"{b}.gate_conv")
        _conv1d(blk["res"], out, f"{b}.residual_conv")
        _conv1d(blk["skip"], out, f"{b}.skip_conv")
        if "cond_filter" in blk:
            _conv1d(blk["cond_filter"], out, f"{b}.cond_filter_conv")
            _conv1d(blk["cond_gate"], out, f"{b}.cond_gate_conv")


def _resblock(p, out: StateDict, name: str) -> None:
    _conv2d(p["conv1"], out, f"{name}.block.0")
    _batchnorm(p["bn1"], out, f"{name}.block.1")
    _conv2d(p["conv2"], out, f"{name}.block.3")
    _batchnorm(p["bn2"], out, f"{name}.block.4")


def _res_stage(p, out: StateDict, block: str) -> None:
    """One ResUNet stage; child layout of the reference's Sequential:
    [down, (bn), relu, res x n, (sub), upsample, up, (bn, relu, res x n)]."""
    seq = f"{block}.model"
    idx = 0
    _conv2d(p["down"], out, f"{seq}.{idx}")
    idx += 1
    if "down_bn" in p:
        _batchnorm(p["down_bn"], out, f"{seq}.{idx}")
        idx += 1
    idx += 1  # ReLU
    for rp in p["res_down"]:
        _resblock(rp, out, f"{seq}.{idx}")
        idx += 1
    if "sub" in p:
        _res_stage(p["sub"], out, f"{seq}.{idx}")
        idx += 1
    idx += 1  # Upsample
    _conv2d(p["up"], out, f"{seq}.{idx}")
    idx += 1
    if "up_bn" in p:
        _batchnorm(p["up_bn"], out, f"{seq}.{idx}")
        idx += 2  # BatchNorm, ReLU
        for rp in p["res_up"]:
            _resblock(rp, out, f"{seq}.{idx}")
            idx += 1


def _unet_stage(p, out: StateDict, block: str) -> None:
    """One 'small' U-Net stage; child layout of the reference's Sequential:
    outermost [down, sub, relu, upT, tanh], innermost [lrelu, down, relu,
    upT, bn], middle [lrelu, down, bn, sub, relu, upT, bn]."""
    seq = f"{block}.model"
    if "up_bn" not in p:  # outermost
        _conv2d(p["down"], out, f"{seq}.0")
        _unet_stage(p["sub"], out, f"{seq}.1")
        _conv_transpose2d(p["up"], out, f"{seq}.3")
    elif "sub" not in p:  # innermost
        _conv2d(p["down"], out, f"{seq}.1")
        _conv_transpose2d(p["up"], out, f"{seq}.3")
        _batchnorm(p["up_bn"], out, f"{seq}.4")
    else:
        _conv2d(p["down"], out, f"{seq}.1")
        _batchnorm(p["down_bn"], out, f"{seq}.2")
        _unet_stage(p["sub"], out, f"{seq}.3")
        _conv_transpose2d(p["up"], out, f"{seq}.5")
        _batchnorm(p["up_bn"], out, f"{seq}.6")


def params_from_jax(tree: Dict[str, Any]) -> StateDict:
    """Convert one model's JAX pytree (APC, its pretraining tree,
    Audio2Feature, Audio2Headpose, the Feature2Face generator or its
    discriminator, told apart by their top-level keys) into the port's state
    dict."""
    out: StateDict = {}
    if "layers" in tree:  # APC encoder
        for i, layer in enumerate(tree["layers"]):
            _rnn(layer, out, f"rnns.{i}")
    elif "encoder" in tree:  # APC with its pretraining head
        out.update({f"encoder.{k}": v for k, v in params_from_jax(tree["encoder"]).items()})
        _linear(tree["head"], out, "head")
    elif "scales" in tree:  # Feature2Face discriminator
        n = len(tree["scales"])
        for k, scale in enumerate(tree["scales"]):
            for j, layer in enumerate(scale["layers"]):
                name = f"scale{n - 1 - k}_layer{j}"
                _conv2d(layer["conv"], out, f"{name}.0")
                if "bn" in layer:
                    _batchnorm(layer["bn"], out, f"{name}.1")
    elif "lstm" in tree:  # Audio2Feature (LSTM decoder)
        _lstm_mlp(tree, out, "downsample")
    elif "wavenet" in tree and "down1" not in tree:  # Audio2Feature's WaveNet decoder
        _wavenet(tree["wavenet"], out, "WaveNet")
    elif "wavenet" in tree:  # Audio2Headpose (WaveNet decoder)
        _linear(tree["down1"], out, "audio_downsample.0")
        _batchnorm(tree["down_bn"], out, "audio_downsample.1")
        _linear(tree["down2"], out, "audio_downsample.3")
        _wavenet(tree["wavenet"], out, "WaveNet")
    elif "net" in tree:  # Feature2Face generator
        if tree.get("size") == "small":
            _unet_stage(tree["net"], out, "netG.model")
        elif tree.get("size") in ("normal", "large"):
            _res_stage(tree["net"], out, "netG.model")
        else:
            raise ValueError(f"unknown generator size {tree.get('size')!r}")
    else:
        raise ValueError(f"unrecognised parameter tree with keys {sorted(tree)}")
    return out


def _lstm_mlp(tree: Dict[str, Any], out: StateDict, down: str) -> None:
    """The audio MLP ``{down}.*``, the LSTM layers and the fc MLP that
    Audio2Feature and the Audio2Headpose LSTM variant share."""
    _linear(tree["down1"], out, f"{down}.0")
    _batchnorm(tree["down_bn"], out, f"{down}.1")
    _linear(tree["down2"], out, f"{down}.3")
    for i, layer in enumerate(tree["lstm"]):
        _rnn(layer, out, "LSTM", i)
    _linear(tree["fc1"], out, "fc.0")
    _batchnorm(tree["fc1_bn"], out, "fc.1")
    _linear(tree["fc2"], out, "fc.3")
    _batchnorm(tree["fc2_bn"], out, "fc.4")
    _linear(tree["fc3"], out, "fc.6")


def audio2headpose_lstm_from_jax(tree: Dict[str, Any]) -> StateDict:
    """The Audio2Headpose LSTM variant's JAX tree (init_audio2headpose_lstm)
    as the reference's state dict (``audio_downsample.*``, ``LSTM.*``,
    ``fc.*``; JAX torch_convert.py:179).  Its tree has Audio2Feature's keys,
    so params_from_jax cannot tell the two apart."""
    out: StateDict = {}
    _lstm_mlp(tree, out, "audio_downsample")
    return out


# ---------------------------------------------------------------------------
# The port's modules -> JAX parameter pytrees (numpy leaves)
# ---------------------------------------------------------------------------


def _a(sd: StateDict, key: str) -> np.ndarray:
    t = sd[key].detach().cpu()
    return t.numpy() if t.dtype == torch.int8 else t.float().numpy()


def _weight_to(sd: StateDict, name: str, *axes: int) -> Dict[str, np.ndarray]:
    """{"w": the weight with its axes permuted, "b": the bias if any}."""
    p = {"w": _a(sd, f"{name}.weight").transpose(*axes)}
    if f"{name}.bias" in sd:
        p["b"] = _a(sd, f"{name}.bias")
    return p


def _linear_to(sd: StateDict, name: str) -> Dict[str, np.ndarray]:
    return _weight_to(sd, name, 1, 0)


def _conv1d_to(sd: StateDict, name: str) -> Dict[str, np.ndarray]:
    return _weight_to(sd, name, 2, 1, 0)


def _conv2d_to(sd: StateDict, name: str) -> Dict[str, np.ndarray]:
    if f"{name}.w_q" not in sd:
        p = _weight_to(sd, name, 2, 3, 1, 0)
        if f"{name}.x_scale" in sd:
            p["x_scale"] = _a(sd, f"{name}.x_scale")
        return p
    p = {"w_q": _a(sd, f"{name}.w_q").transpose(2, 3, 1, 0),
         "w_scale": _a(sd, f"{name}.w_scale")}
    for k in ("b", "x_scale"):
        if f"{name}.{k}" in sd:
            p[k] = _a(sd, f"{name}.{k}")
    return p


def _rewrite_to(layer: nn_core.UpConv, sd: StateDict, name: str) -> Dict[str, np.ndarray]:
    """A rewritten layer's entries in JAX's layouts (inverse of
    _rewrite_from_jax)."""
    p = {}
    for k, _ in layer.named_buffers():
        a = _a(sd, f"{name}.{k}")
        if k in ("w_ph", "w_ph_q"):  # [4 * out, in, 2, 2] -> [4, 2, 2, in, out]
            a = a.reshape(4, -1, *a.shape[1:]).transpose(0, 3, 4, 2, 1)
        elif k in _REWRITE_WEIGHTS:
            a = a.transpose(2, 3, 1, 0)
        p[k] = np.array(a)
    return p


def _batchnorm_to(sd: StateDict, name: str) -> Dict[str, np.ndarray]:
    return {"scale": _a(sd, f"{name}.weight"), "bias": _a(sd, f"{name}.bias"),
            "mean": _a(sd, f"{name}.running_mean"), "var": _a(sd, f"{name}.running_var")}


def _rnn_to(sd: StateDict, prefix: str, layer: int = 0) -> Dict[str, np.ndarray]:
    return {"w_ih": _a(sd, f"{prefix}.weight_ih_l{layer}").T,
            "w_hh": _a(sd, f"{prefix}.weight_hh_l{layer}").T,
            "b_ih": _a(sd, f"{prefix}.bias_ih_l{layer}"),
            "b_hh": _a(sd, f"{prefix}.bias_hh_l{layer}")}


def _wavenet_to(sd: StateDict, pre: str, n_blocks: int) -> Dict[str, Any]:
    p: Dict[str, Any] = {"start1": _conv1d_to(sd, f"{pre}.start_conv1"),
                         "start2": _conv1d_to(sd, f"{pre}.start_conv2"),
                         "end1": _conv1d_to(sd, f"{pre}.end_conv_1"),
                         "end2": _conv1d_to(sd, f"{pre}.end_conv_2"), "blocks": []}
    for i in range(n_blocks):
        b = f"{pre}.residual_blocks.{i}"
        blk = {"filter": _conv1d_to(sd, f"{b}.filter_conv"),
               "gate": _conv1d_to(sd, f"{b}.gate_conv"),
               "res": _conv1d_to(sd, f"{b}.residual_conv"),
               "skip": _conv1d_to(sd, f"{b}.skip_conv")}
        if f"{b}.cond_filter_conv.weight" in sd:
            blk["cond_filter"] = _conv1d_to(sd, f"{b}.cond_filter_conv")
            blk["cond_gate"] = _conv1d_to(sd, f"{b}.cond_gate_conv")
        p["blocks"].append(blk)
    return p


def _resblock_to(sd: StateDict, name: str) -> Dict[str, Any]:
    return {"conv1": _conv2d_to(sd, f"{name}.block.0"), "bn1": _batchnorm_to(sd, f"{name}.block.1"),
            "conv2": _conv2d_to(sd, f"{name}.block.3"), "bn2": _batchnorm_to(sd, f"{name}.block.4")}


def _res_stage_to(sd: StateDict, stage: f2f.ResUnetBlock, block: str) -> Dict[str, Any]:
    """Inverse of _res_stage, walking the stage's Sequential."""
    seq = stage.model
    p: Dict[str, Any] = {"res_down": []}
    for i, m in enumerate(seq):
        name = f"{block}.model.{i}"
        if isinstance(m, (nn.Conv2d, nn_core.QConv2d)):
            p["up" if "down" in p else "down"] = _conv2d_to(sd, name)
        elif isinstance(m, nn_core.REWRITES):
            p["up" if "down" in p else "down"] = _rewrite_to(m, sd, name)
        elif isinstance(m, nn.BatchNorm2d):
            p["up_bn" if "up" in p else "down_bn"] = _batchnorm_to(sd, name)
        elif isinstance(m, f2f.ResnetBlock):
            p.setdefault("res_up" if "up" in p else "res_down", []).append(
                _resblock_to(sd, name))
        elif isinstance(m, f2f.ResUnetBlock):
            p["sub"] = _res_stage_to(sd, m, name)
    return p


def _unet_stage_to(sd: StateDict, stage: f2f.UnetBlock, block: str) -> Dict[str, Any]:
    """Inverse of _unet_stage, walking the stage's Sequential."""
    p: Dict[str, Any] = {}
    for i, m in enumerate(stage.model):
        name = f"{block}.model.{i}"
        if isinstance(m, nn.Conv2d):
            p["down"] = _weight_to(sd, name, 2, 3, 1, 0)
        elif isinstance(m, nn.ConvTranspose2d):
            p["up"] = _weight_to(sd, name, 2, 3, 0, 1)
        elif isinstance(m, nn.BatchNorm2d):
            p["up_bn" if "up" in p else "down_bn"] = _batchnorm_to(sd, name)
        elif isinstance(m, f2f.UnetBlock):
            p["sub"] = _unet_stage_to(sd, m, name)
    return p


def params_to_jax(model: nn.Module) -> Dict[str, Any]:
    """One of the port's eight models as the JAX package's parameter tree
    (the inverse of params_from_jax)."""
    sd = model.state_dict()
    if isinstance(model, APCEncoder):
        return {"layers": [_rnn_to(sd, f"rnns.{i}") for i in range(len(model.rnns))]}
    if isinstance(model, APCPretrain):
        return {"encoder": params_to_jax(model.encoder), "head": _linear_to(sd, "head")}
    if isinstance(model, f2f.Feature2FaceD):
        scales = []
        for k in range(model.num_D):
            layers = []
            for j in range(model.n_layers + 2):
                name = f"scale{model.num_D - 1 - k}_layer{j}"
                layer = {"conv": _conv2d_to(sd, f"{name}.0")}
                if f"{name}.1.running_mean" in sd:
                    layer["bn"] = _batchnorm_to(sd, f"{name}.1")
                layers.append(layer)
            scales.append({"layers": layers})
        return {"scales": scales}
    if isinstance(model, (Audio2Feature, Audio2HeadposeLSTM)):
        down = "downsample" if isinstance(model, Audio2Feature) else "audio_downsample"
        return {"down1": _linear_to(sd, f"{down}.0"),
                "down_bn": _batchnorm_to(sd, f"{down}.1"),
                "down2": _linear_to(sd, f"{down}.3"),
                "lstm": [_rnn_to(sd, "LSTM", i) for i in range(model.LSTM.num_layers)],
                "fc1": _linear_to(sd, "fc.0"), "fc1_bn": _batchnorm_to(sd, "fc.1"),
                "fc2": _linear_to(sd, "fc.3"), "fc2_bn": _batchnorm_to(sd, "fc.4"),
                "fc3": _linear_to(sd, "fc.6")}
    if isinstance(model, Audio2FeatureWaveNet):
        return {"wavenet": _wavenet_to(sd, "WaveNet", len(model.WaveNet.residual_blocks))}
    if isinstance(model, Audio2Headpose):
        return {"down1": _linear_to(sd, "audio_downsample.0"),
                "down_bn": _batchnorm_to(sd, "audio_downsample.1"),
                "down2": _linear_to(sd, "audio_downsample.3"),
                "wavenet": _wavenet_to(sd, "WaveNet", len(model.WaveNet.residual_blocks))}
    if isinstance(model, f2f.Feature2FaceG):
        walk = _unet_stage_to if model.size == "small" else _res_stage_to
        return {"net": walk(sd, model.netG.model, "netG.model"), "size": model.size}
    raise TypeError(f"no JAX tree for {type(model).__name__}")
