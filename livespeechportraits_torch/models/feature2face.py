"""Feature2Face generator: the ResUNet renderer ('normal' and 'large').

Counterpart of the float generator path of ``livespeechportraits_tpu/models/
feature2face.py`` (``_resblock``, ``_resunet_stage``, ``apply_generator``).
The modules mirror the reference's nested ``nn.Sequential`` so that its
state-dict keys (``netG.model.model.0.weight`` ...) load unchanged; the
forward walks each Sequential with the nn_core functions.  The public
``apply_generator`` keeps JAX's NHWC layout; inside, activations are NCHW in
``channels_last`` memory.  ``n_res`` residual blocks per stage: 1 is
'normal', 2 is 'large'.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch
from torch import nn

from livespeechportraits_tpu.config import Feature2FaceConfig
from livespeechportraits_torch.models import nn_core

Tensor = torch.Tensor

N_RES = {"normal": 1, "large": 2}


class ResnetBlock(nn.Module):
    """conv-BN-ReLU-conv-BN plus the skip, then ReLU."""

    def __init__(self, ch: int):
        super().__init__()
        self.block = nn.Sequential(
            nn.Conv2d(ch, ch, 3, padding=1, bias=False), nn.BatchNorm2d(ch), nn.ReLU(),
            nn.Conv2d(ch, ch, 3, padding=1, bias=False), nn.BatchNorm2d(ch))

    def forward(self, x: Tensor) -> Tensor:
        b = self.block
        y = torch.relu(nn_core.batchnorm(nn_core.conv2d(x, b[0], padding=1), b[1]))
        y = nn_core.batchnorm(nn_core.conv2d(y, b[3], padding=1), b[4])
        return torch.relu(x + y)


class ResUnetBlock(nn.Module):
    """One U-Net stage: stride-2 down conv (+BN), ReLU, res blocks, the
    inner stage, nearest 2x upsample, up conv (+BN, ReLU, res blocks).  A
    non-outermost stage returns cat([input, output]) over channels."""

    def __init__(self, outer_nc: int, inner_nc: int, input_nc: Optional[int], n_res: int,
                 submodule: Optional["ResUnetBlock"] = None, outermost: bool = False):
        super().__init__()
        innermost = submodule is None
        self.outermost = outermost
        input_nc = outer_nc if input_nc is None else input_nc
        layers = [nn.Conv2d(input_nc, inner_nc, 3, stride=2, padding=1, bias=False)]
        if not outermost and not innermost:
            layers.append(nn.BatchNorm2d(inner_nc))
        layers.append(nn.ReLU())
        layers += [ResnetBlock(inner_nc) for _ in range(n_res)]
        if not innermost:
            layers.append(submodule)
        layers.append(nn.Upsample(scale_factor=2, mode="nearest"))
        up_in = inner_nc if innermost else inner_nc * 2
        layers.append(nn.Conv2d(up_in, outer_nc, 3, padding=1, bias=False))
        if not outermost:
            layers += [nn.BatchNorm2d(outer_nc), nn.ReLU()]
            layers += [ResnetBlock(outer_nc) for _ in range(n_res)]
        self.model = nn.Sequential(*layers)

    def forward(self, x: Tensor) -> Tensor:
        y = x
        for m in self.model:
            if isinstance(m, nn.Conv2d):
                y = nn_core.conv2d(y, m, stride=m.stride[0], padding=m.padding[0])
            elif isinstance(m, nn.BatchNorm2d):
                y = nn_core.batchnorm(y, m)
            elif isinstance(m, nn.ReLU):
                y = torch.relu(y)
            elif isinstance(m, nn.Upsample):
                y = nn_core.upsample_nearest_2x(y)
            else:  # ResnetBlock or the inner ResUnetBlock
                y = m(y)
        return y if self.outermost else torch.cat([x, y], dim=1)


class ResUnetGenerator(nn.Module):
    def __init__(self, input_nc: int, output_nc: int, num_downs: int, ngf: int, n_res: int):
        super().__init__()
        if num_downs < 5:
            raise ValueError(f"the ResUNet needs num_downs >= 5, got {num_downs}")
        block = ResUnetBlock(ngf * 8, ngf * 8, None, n_res)
        for _ in range(num_downs - 5):
            block = ResUnetBlock(ngf * 8, ngf * 8, None, n_res, block)
        block = ResUnetBlock(ngf * 4, ngf * 8, None, n_res, block)
        block = ResUnetBlock(ngf * 2, ngf * 4, None, n_res, block)
        block = ResUnetBlock(ngf, ngf * 2, None, n_res, block)
        self.model = ResUnetBlock(output_nc, ngf, input_nc, n_res, block, outermost=True)


class Feature2FaceG(nn.Module):
    def __init__(self, cfg: Feature2FaceConfig):
        super().__init__()
        if cfg.size not in N_RES:
            raise NotImplementedError(f"generator size {cfg.size!r}: only the ResUNet "
                                      "('normal', 'large') is ported")
        self.netG = ResUnetGenerator(cfg.input_nc, cfg.output_nc, cfg.n_downsample, cfg.ngf,
                                     N_RES[cfg.size])

    def reset_parameters(self, gen: torch.Generator) -> None:
        """normal(0, 0.02) convs and N(1, 0.02) BatchNorm scales, the JAX
        init's scales."""
        nn_core.init_normal_(self, gen)
        nn_core.init_batchnorm_(self, gen)


def cast_generator(model: Feature2FaceG, dtype: torch.dtype) -> Feature2FaceG:
    """A copy with every float tensor (weights, BN statistics) in ``dtype``,
    like JAX's _cast_net for the bf16 compute path, and conv weights in
    channels_last memory."""
    return copy.deepcopy(model).to(dtype=dtype, memory_format=torch.channels_last)


def apply_generator(model: Feature2FaceG, x: Tensor) -> Tensor:
    """x [B, H, W, input_nc] (NHWC) -> [B, H, W, 3] in [-1, 1], f32.

    Computes in the model's dtype (see cast_generator); the tanh runs in
    f32."""
    dtype = next(model.parameters()).dtype
    x = x.permute(0, 3, 1, 2).to(dtype).contiguous(memory_format=torch.channels_last)
    y = model.netG.model(x)
    return torch.tanh(y.float()).permute(0, 2, 3, 1)


def to_uint8(y: Tensor) -> Tensor:
    """[-1, 1] -> uint8, truncating like JAX's astype after the clip."""
    return ((y + 1.0) * 127.5).clamp(0, 255).to(torch.uint8)
