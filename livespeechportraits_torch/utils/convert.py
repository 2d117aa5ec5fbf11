"""JAX parameter pytrees -> the port's state dicts.

The port's modules use the reference's state-dict key names (those that
``livespeechportraits_tpu/utils/torch_convert.export_*`` emit), so a JAX tree
converted here loads with ``load_state_dict(strict=True)``, and so will the
reference's released ``.pkl`` checkpoints.  Layout maps:

    JAX dense   [in, out]          -> Linear [out, in]
    JAX conv1d  [k, in, out]       -> Conv1d [out, in, k]
    JAX conv2d  [kh, kw, in, out]  -> Conv2d [out, in, kh, kw]
    JAX RNN     [in, G*H]          -> weight_*_l{k} [G*H, in]

Leaves may be numpy arrays or anything ``np.asarray`` accepts; this module
imports no JAX.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


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


def _conv2d(p, out: StateDict, name: str) -> None:
    out[f"{name}.weight"] = _t(np.asarray(p["w"]).transpose(3, 2, 0, 1))
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


def params_from_jax(tree: Dict[str, Any]) -> StateDict:
    """Convert one model's JAX pytree (APC, Audio2Feature, Audio2Headpose or
    the Feature2Face generator, told apart by their top-level keys) into the
    port's state dict."""
    out: StateDict = {}
    if "layers" in tree:  # APC encoder
        for i, layer in enumerate(tree["layers"]):
            _rnn(layer, out, f"rnns.{i}")
    elif "lstm" in tree:  # Audio2Feature (LSTM decoder)
        _linear(tree["down1"], out, "downsample.0")
        _batchnorm(tree["down_bn"], out, "downsample.1")
        _linear(tree["down2"], out, "downsample.3")
        for i, layer in enumerate(tree["lstm"]):
            _rnn(layer, out, "LSTM", i)
        _linear(tree["fc1"], out, "fc.0")
        _batchnorm(tree["fc1_bn"], out, "fc.1")
        _linear(tree["fc2"], out, "fc.3")
        _batchnorm(tree["fc2_bn"], out, "fc.4")
        _linear(tree["fc3"], out, "fc.6")
    elif "wavenet" in tree:  # Audio2Headpose (WaveNet decoder)
        _linear(tree["down1"], out, "audio_downsample.0")
        _batchnorm(tree["down_bn"], out, "audio_downsample.1")
        _linear(tree["down2"], out, "audio_downsample.3")
        _wavenet(tree["wavenet"], out, "WaveNet")
    elif "net" in tree:  # Feature2Face generator
        if tree.get("size") not in ("normal", "large"):
            raise NotImplementedError(f"generator size {tree.get('size')!r} is not ported")
        _res_stage(tree["net"], out, "netG.model")
    else:
        raise ValueError(f"unrecognised parameter tree with keys {sorted(tree)}")
    return out
