"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both the JAX function
and its PyTorch counterpart; weights cross through
``livespeechportraits_torch.utils.convert.params_from_jax``.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np
import pytest
import torch

from livespeechportraits_torch import config as tconfig
from livespeechportraits_tpu.config import (APCConfig, Audio2FeatureConfig,
                                            Audio2HeadposeConfig, Feature2FaceConfig,
                                            PersonConfig, WaveNetConfig)


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips where there is none (the CUDA kernels
    have no CPU mode - their plain twins carry the CPU tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels do not run on the CPU")
    return torch.device("cuda", 0)


def small_person_config(image_size: int = 64, precision: str = "float32",
                        hidden: int = 32) -> PersonConfig:
    """The default PersonConfig cut to test widths: APC 2 x 32, LSTM H=16,
    WaveNet 3 x 1 layers with 8 channels, U-Net ngf 8 with 5 downsamplings."""
    wn = WaveNetConfig(residual_layers=3, residual_blocks=1, dilation_channels=8,
                       residual_channels=8, skip_channels=16, cond_channels=hidden)
    return PersonConfig(
        apc=APCConfig(hidden_size=hidden, num_layers=2),
        audio2feature=Audio2FeatureConfig(apc_hidden_size=hidden, lstm_hidden_size=16),
        audio2headpose=Audio2HeadposeConfig(apc_hidden_size=hidden, wavenet=wn),
        feature2face=Feature2FaceConfig(ngf=8, n_downsample=5, load_size=image_size,
                                        precision=precision),
    )


def card_person_config(image_size: int = 64, precision: str = "float32"):
    """The port's small_person_config for a run on the card: test widths
    but for the head-pose WaveNet, which keeps its published shape (on the
    32-wide APC features): the decode kernel K5 takes that shape alone, and
    a decode on the card of any other raises."""
    cfg = torch_config(small_person_config(image_size=image_size, precision=precision))
    a2h = cfg.audio2headpose
    wn = tconfig.WaveNetConfig(cond_channels=a2h.apc_hidden_size)
    return tconfig.replace(cfg, audio2headpose=tconfig.replace(a2h, wavenet=wn))


def torch_config(cfg):
    """The port's config (livespeechportraits_torch.config) equal to a JAX
    package config of the same class name, through dataclasses.asdict and
    back: the port's code is handed its own config classes."""
    return _config_from_dict(getattr(tconfig, type(cfg).__name__), dataclasses.asdict(cfg))


def _config_from_dict(cls, d: dict):
    hints = typing.get_type_hints(cls)
    kw = {}
    for f in dataclasses.fields(cls):
        t = hints[f.name]
        kw[f.name] = _config_from_dict(t, d[f.name]) if dataclasses.is_dataclass(t) else d[f.name]
    return cls(**kw)


def to_np(tree):
    """A JAX pytree with numpy leaves."""
    if isinstance(tree, dict):
        return {k: to_np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_np(v) for v in tree)
    if isinstance(tree, str):
        return tree
    return np.asarray(tree)


def jax_headpose_noise(seed: int, nframe: int, ncenter: int, ndim: int):
    """The per-step draws of the JAX head-pose decode (step i: fold_in(key,
    i), split into the categorical's Gumbel key and the normal's key), as
    (gumbel [n, ncenter], eps [n, ndim]) tensors for the port."""
    import jax

    key = jax.random.PRNGKey(seed)
    gumbel, eps = [], []
    for i in range(nframe):
        k_cat, k_norm = jax.random.split(jax.random.fold_in(key, i))
        gumbel.append(np.asarray(jax.random.gumbel(k_cat, (1, ncenter))))
        eps.append(np.asarray(jax.random.normal(k_norm, (1, ndim))))
    return torch.tensor(np.concatenate(gumbel)), torch.tensor(np.concatenate(eps))
