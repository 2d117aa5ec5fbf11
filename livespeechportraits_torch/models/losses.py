"""GAN, feature-matching, masked L1 and VGG19 perceptual / style losses of
the renderer's training.

Counterpart of ``livespeechportraits_tpu/models/losses.py``: ``gan_loss``
(LSGAN, vanilla BCE-with-logits, hinge), ``feature_matching_loss``,
``masked_l1_loss``, ``init_vgg19`` / ``load_vgg19_npz`` / ``vgg19_features``,
``gram_matrix`` (the per-sample [C, C] Gram averaged over the batch, JAX's
documented divergence from the reference's cross-batch Gram) and
``vgg_style_loss`` (with JAX's ``microbatch``: the tower chunked over the
batch and recomputed in the backward).  Images and features keep JAX's NHWC layout at these
functions.  The VGG19 has no pretrained weights here: ``init_vgg19`` draws a
random one from a seed, ``load_vgg19_npz`` reads torchvision's weights
exported to an .npz by the caller.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from livespeechportraits_torch.parallel import mesh

Tensor = torch.Tensor


def _final_logits(preds) -> List[Tensor]:
    """Raw logits, a per-scale list, or a list of per-scale feature lists ->
    the final logits of each scale."""
    if isinstance(preds, (list, tuple)):
        if preds and isinstance(preds[0], (list, tuple)):
            return [p[-1] for p in preds]
        return list(preds)
    return [preds]


def gan_loss(preds, target_is_real: bool, mode: str = "ls",
             for_discriminator: bool = True) -> Tensor:
    """LSGAN (MSE), vanilla (BCE with logits) or hinge loss, summed over the
    discriminator's scales."""
    total = 0.0
    for logits in _final_logits(preds):
        if mode == "ls":
            target = 1.0 if target_is_real else 0.0
            total = total + torch.mean((logits - target) ** 2)
        elif mode == "original":
            target = 1.0 if target_is_real else 0.0
            total = total + torch.mean(torch.clamp(logits, min=0) - logits * target
                                       + torch.log1p(torch.exp(-logits.abs())))
        elif mode == "hinge":
            if not for_discriminator:
                total = total - torch.mean(logits)
            elif target_is_real:
                total = total + torch.mean(torch.relu(1.0 - logits))
            else:
                total = total + torch.mean(torch.relu(1.0 + logits))
        else:
            raise ValueError(f"unknown gan mode {mode!r}")
    return total


def feature_matching_loss(pred_fake, pred_real, num_D: int, n_layers_D: int,
                          lambda_feat: float = 10.0) -> Tensor:
    """pix2pixHD's feature matching: L1 between the discriminator's features
    of the fake and of the (detached) real, weighted 4 / (n_layers + 1) a
    feature and 1 / num_D a scale, times lambda_feat."""
    feat_w = 4.0 / (n_layers_D + 1)
    d_w = 1.0 / num_D
    loss = 0.0
    for i in range(min(len(pred_fake), num_D)):
        for j in range(len(pred_fake[i])):
            loss = loss + d_w * feat_w * torch.mean(
                (pred_fake[i][j] - pred_real[i][j].detach()).abs()) * lambda_feat
    return loss


def masked_l1_loss(x: Tensor, y: Tensor, mask: Tensor) -> Tensor:
    """L1 restricted to a (broadcast) mask."""
    return torch.mean((x * mask - y * mask).abs())


# ---------------------------------------------------------------------------
# VGG19 perceptual + style loss
# ---------------------------------------------------------------------------

# torchvision's vgg19.features: conv output channels, "M" a 2x2 max pool
_VGG19_PLAN = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
               512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]
# the feature taps after relu1_1, relu2_1, relu3_1, relu4_1, relu5_1, counted
# in convolutions
_SLICE_ENDS = (1, 3, 5, 9, 13)

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


class VGG19(nn.Module):
    """VGG19's 16 3x3 convolutions (``convs.{i}``, torch's OIHW layout); the
    pools sit where _VGG19_PLAN puts them."""

    def __init__(self):
        super().__init__()
        convs, in_ch = [], 3
        for spec in _VGG19_PLAN:
            if spec != "M":
                convs.append(nn.Conv2d(in_ch, spec, 3, padding=1))
                in_ch = spec
        self.convs = nn.ModuleList(convs)


def init_vgg19(seed: int = 0) -> VGG19:
    """A VGG19 with kaiming-normal weights (std sqrt(2 / fan_in)) and zero
    biases, drawn from ``seed`` on the CPU, without gradients."""
    gen = torch.Generator().manual_seed(seed)
    vgg = VGG19()
    with torch.no_grad():
        for conv in vgg.convs:
            fan_in = conv.weight[0].numel()
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen)
                              * np.sqrt(2.0 / fan_in))
            conv.bias.zero_()
    return vgg.requires_grad_(False)


def load_vgg19_npz(path: str) -> VGG19:
    """torchvision's VGG19 conv weights from an .npz holding ``conv{i}_w``
    (OIHW) and ``conv{i}_b``, i = 0 .. 15."""
    vgg = VGG19()
    with np.load(path) as data, torch.no_grad():
        for i, conv in enumerate(vgg.convs):
            conv.weight.copy_(torch.from_numpy(data[f"conv{i}_w"]))
            conv.bias.copy_(torch.from_numpy(data[f"conv{i}_b"]))
    return vgg.requires_grad_(False)


def vgg19_features(vgg: VGG19, x: Tensor, from_tanh_range: bool = True) -> List[Tensor]:
    """[B, H, W, 3] -> the five relu taps, each [B, h, w, C] (NHWC views).
    from_tanh_range: the input is in [-1, 1] (the generator's output) and is
    mapped to ImageNet-normalised RGB first."""
    if from_tanh_range:
        mean = x.new_tensor(_IMAGENET_MEAN)
        std = x.new_tensor(_IMAGENET_STD)
        x = ((x + 1.0) * 0.5 - mean) / std
    h = x.permute(0, 3, 1, 2)
    feats: List[Tensor] = []
    convs = iter(vgg.convs)
    n_conv = 0
    for spec in _VGG19_PLAN:
        if spec == "M":
            h = F.max_pool2d(h, 2, 2)
            continue
        conv = next(convs)
        h = torch.relu(F.conv2d(h, conv.weight, conv.bias, padding=1))
        n_conv += 1
        if n_conv in _SLICE_ENDS:
            feats.append(h.permute(0, 2, 3, 1))
            if len(feats) == len(_SLICE_ENDS):
                break
    return feats


def gram_matrix(feat: Tensor) -> Tensor:
    """[B, h, w, C] -> [C, C]: the per-sample Gram / (C h w), averaged over
    the batch."""
    b, h, w, c = feat.shape
    f = feat.reshape(b * h * w, c)
    return (f.t() @ f) / (b * c * h * w)


def vgg_style_loss(vgg: VGG19, x: Tensor, y: Tensor,
                   weights: Sequence[float] = (1.0, 1.0, 1.0, 1.0, 1.0),
                   style_weights: Sequence[float] = (1.0, 1.0, 1.0, 1.0, 1.0),
                   style: bool = True, microbatch: Optional[int] = None
                   ) -> Tuple[Tensor, Tensor]:
    """(perceptual, style): the weighted L1 between x's and y's taps, and the
    weighted MSE between their Gram matrices x 3e7; y is the detached
    target.

    microbatch=m (JAX losses.py:195-270) bounds the tower's activation
    memory to one m-sample chunk: each chunk's towers run under
    torch.utils.checkpoint, so the backward recomputes them instead of
    keeping them.  The chunks' per-slice L1 means and Gram matrices are
    summed and divided by the number of chunks, as JAX's scan does, which
    equals the unchunked loss (equal chunks).  m must divide the batch;
    m >= B is the unchunked path.  In a process group the Gram matrices are
    averaged over the data ranks before the difference (mesh.all_reduce_sum
    over the data group), so the style term is the global batch's, as are
    its gradients; the model ranks of a grid hold the same rows and compute
    the same loss."""
    if microbatch is None or x.shape[0] <= microbatch:
        p_loss, gx, gy = _vgg_chunk_stats(vgg, x, y.detach(), weights, style)
        n = 1
    else:
        b = x.shape[0]
        if b % microbatch:
            raise ValueError(f"vgg microbatch {microbatch} must divide the batch ({b})")
        n = b // microbatch
        p_loss, gx, gy = 0.0, None, None
        for xc, yc in zip(x.split(microbatch), y.detach().split(microbatch)):
            p, cx, cy = checkpoint(_vgg_chunk_stats, vgg, xc, yc, weights, style,
                                   use_reentrant=False)
            p_loss = p_loss + p
            gx = cx if gx is None else [a + c for a, c in zip(gx, cx)]
            gy = cy if gy is None else [a + c for a, c in zip(gy, cy)]
        p_loss = p_loss / n
    world = mesh.data_size()
    if world > 1:  # the Gram matrices are batch means: the global batch's
        gx = [mesh.all_reduce_sum(g) / world for g in gx]
        gy = [mesh.all_reduce_sum(g) / world for g in gy]
    s_loss = 0.0
    for i in range(len(gx)):
        g = gx[i] / n - gy[i] / n if n > 1 else gx[i] - gy[i]
        s_loss = s_loss + style_weights[i] * torch.mean(g ** 2) * 3e7
    return p_loss, s_loss


def _vgg_chunk_stats(vgg: VGG19, x: Tensor, y: Tensor, weights: Sequence[float],
                     style: bool) -> Tuple[Tensor, List[Tensor], List[Tensor]]:
    """One chunk's weighted perceptual L1 and, with style, each tap's Gram
    matrix of x and of y (empty lists without)."""
    fx = vgg19_features(vgg, x)
    fy = vgg19_features(vgg, y)
    p_loss = 0.0
    gx: List[Tensor] = []
    gy: List[Tensor] = []
    for i in range(len(fx)):
        p_loss = p_loss + weights[i] * torch.mean((fx[i] - fy[i]).abs())
        if style:
            gx.append(gram_matrix(fx[i]))
            gy.append(gram_matrix(fy[i]))
    return p_loss, gx, gy
