"""Feature2Face generator: the ResUNet renderer ('normal' and 'large') and
the pix2pix U-Net ('small').

Counterpart of the generator path of ``livespeechportraits_tpu/models/
feature2face.py`` (``_resblock``, ``_resunet_stage``, ``_unet_stage``,
``apply_generator``, and split_cand's ``precompute_cand_down`` /
``apply_generator_edge``) and its int8 inference transforms
(``quantize_generator``, ``fold_bn_generator``, ``calibrate_generator``,
which refuse 'small' as JAX does), the structural inference rewrites
(``subpixel_generator``, ``s2d_input_generator``, ``split_skip_generator``),
and quantization-aware training's tags
(``qat_generator``, ``strip_qat_generator``, ``qat_discriminator``).
The modules mirror the reference's nested ``nn.Sequential`` so that its
state-dict keys (``netG.model.model.0.weight`` ...) load unchanged; the
forward walks each Sequential with the nn_core functions.  The public
``apply_generator`` keeps JAX's NHWC layout; inside, activations are NCHW in
``channels_last`` memory.  ``n_res`` residual blocks per stage: 1 is
'normal', 2 is 'large'.  The 'small' U-Net (k=4 stride-2 convs down,
ConvTranspose up, BatchNorm, tanh) keeps the reference's own nesting.
"""

from __future__ import annotations

import copy
from typing import Iterator, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from livespeechportraits_torch.config import Feature2FaceConfig
from livespeechportraits_torch.models import nn_core
from livespeechportraits_torch.parallel import mesh

Tensor = torch.Tensor

N_RES = {"normal": 1, "large": 2}


def _conv_in(x: Tensor, conv: nn.Module) -> Tensor:
    """x as the input of ``conv``: when the conv's output channels are split
    over a grid's model axis (parallel.sharding.shard_params tags it with
    ``tp_grid``), mesh.to_model_slices (its backward sums the model ranks'
    shares of d loss / d x); else x itself, no op."""
    grid = getattr(conv, "tp_grid", None)
    return x if grid is None else mesh.to_model_slices(x, grid)


def _whole(y: Tensor, conv: Optional[nn.Module]) -> Tensor:
    """y, the output of ``conv`` after its per-channel BatchNorm and
    activation, with all its channels: gathered over the model axis when
    the conv is channel-sharded; else y itself, no op.  What reads the
    gathered map (the next conv's input, a residual add, a concat, the
    replicated to-RGB conv) is replicated over the model ranks, so its
    gradient arrives whole on each of them and ordinary autograd carries
    it: only the conv inputs' shares are summed (_conv_in)."""
    grid = None if conv is None else getattr(conv, "tp_grid", None)
    return y if grid is None else mesh.from_model_slices(y, grid)


class ResnetBlock(nn.Module):
    """conv-BN-ReLU-conv-BN plus the skip, then ReLU."""

    def __init__(self, ch: int):
        super().__init__()
        self.block = nn.Sequential(
            nn.Conv2d(ch, ch, 3, padding=1, bias=False), nn.BatchNorm2d(ch), nn.ReLU(),
            nn.Conv2d(ch, ch, 3, padding=1, bias=False), nn.BatchNorm2d(ch))

    def forward(self, x: Tensor, training: bool = False, update_stats: bool = True) -> Tensor:
        b = self.block
        # conv2d runs nn.Conv2d or an int8 QConv2d alike; _conv_in / _whole
        # are no ops unless the convs are channel-sharded
        y = torch.relu(nn_core.batchnorm(nn_core.conv2d(_conv_in(x, b[0]), b[0], padding=1),
                                         b[1], training=training, update_stats=update_stats))
        y = _whole(y, b[0])
        y = nn_core.batchnorm(nn_core.conv2d(_conv_in(y, b[3]), b[3], padding=1), b[4],
                              training=training, update_stats=update_stats)
        return torch.relu(x + _whole(y, b[3]))


def checkpointed(fn, x: Tensor, update_stats: bool = True) -> Tensor:
    """fn(x, update_stats) under torch.utils.checkpoint (non-reentrant): its
    activations are not kept, and the backward runs fn again.  Only the
    first run may move the training BatchNorms' running stats: the
    recompute normalises with the same batch statistics and passes
    update_stats=False, so the stats move once a step, as without
    rematerialisation.  The RNG and autocast states are replayed (the
    default); the generator and the discriminator draw no random numbers."""
    runs = []

    def run(t: Tensor) -> Tensor:
        runs.append(None)
        return fn(t, update_stats and len(runs) == 1)

    return checkpoint(run, x, use_reentrant=False)


class UpsampleAbsorbed(nn.Identity):
    """Where a stage's nearest 2x upsample stood before a rewrite absorbed it
    into the up conv that follows (subpixel_generator, split_skip_generator):
    the layer indices, and so the state-dict keys, stay those of the
    unrewritten stage."""


class ResUnetBlock(nn.Module):
    """One U-Net stage: stride-2 down conv (+BN), ReLU, res blocks, the
    inner stage, nearest 2x upsample, up conv (+BN, ReLU, res blocks).  A
    non-outermost stage returns the pair (input, output); its parent's up
    conv reads cat(pair) over channels, or the pair itself when it is split
    (nn_core.UpConvSplit), as JAX's _resunet_stage does."""

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

    def forward(self, x: Tensor, training: bool = False, update_stats: bool = True,
                remat: int = 0, depth: int = 0, y_down: Optional[Tensor] = None) -> Tensor:
        """remat: the number of outermost stages whose down half (down conv
        .. res blocks) and up half (upsample .. res blocks) each run under
        ``checkpointed``; depth is this stage's (0 = outermost).  The inner
        stages keep their activations.  y_down: the down conv's output,
        computed by the caller (apply_generator_edge, outermost stage only);
        the stage then starts after its down conv and reads no x."""
        layers = list(self.model)
        cut = next(i for i, m in enumerate(layers)
                   if isinstance(m, (nn.Upsample, UpsampleAbsorbed)))
        inner = layers[cut - 1] if isinstance(layers[cut - 1], ResUnetBlock) else None
        down, up = layers[:cut - 1 if inner is not None else cut], layers[cut:]
        if y_down is not None:
            if not self.outermost:
                raise ValueError("y_down replaces the outermost stage's down conv")
            down, x = down[1:], y_down

        def half(seq):
            return lambda t, upd: self._run(seq, t, training, upd)

        if depth < remat:
            y = checkpointed(half(down), x, update_stats)
        else:
            y = self._run(down, x, training, update_stats)
        if inner is not None:
            y = inner(y, training, update_stats, remat, depth + 1)
            if isinstance(up[1], nn_core.UpConvSplit):  # the concat-free up conv
                y, up = up[1](*y), up[2:]
            else:
                y = torch.cat(y, dim=1)
        if depth < remat:
            y = checkpointed(half(up), y, update_stats)
        else:
            y = self._run(up, y, training, update_stats)
        return y if self.outermost else (x, y)

    @staticmethod
    def _run(layers, y: Tensor, training: bool, update_stats: bool) -> Tensor:
        last = None  # the conv whose output y is, while only per-channel ops follow it
        for m in layers:
            if isinstance(m, nn.BatchNorm2d):
                y = nn_core.batchnorm(y, m, training=training, update_stats=update_stats)
                continue
            if isinstance(m, nn.ReLU):
                y = torch.relu(y)
                continue
            y, last = _whole(y, last), None
            if isinstance(m, (nn.Conv2d, nn_core.QConv2d)):
                y = nn_core.conv2d(_conv_in(y, m), m, stride=m.stride[0], padding=m.padding[0])
                last = m
            elif isinstance(m, nn.Upsample):
                y = nn_core.upsample_nearest_2x(y)
            elif isinstance(m, nn_core.REWRITES):
                y = m(y)
            elif not isinstance(m, UpsampleAbsorbed):  # ResnetBlock
                y = m(y, training, update_stats)
        return _whole(y, last)


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


class UnetBlock(nn.Module):
    """One stage of the 'small' pix2pix U-Net, in the reference's Sequential
    layout (so its state-dict keys load unchanged):

        outermost: [down, sub, ReLU, upT, Tanh]
        innermost: [LeakyReLU, down, ReLU, upT, BN]
        middle:    [LeakyReLU, down, BN, sub, ReLU, upT, BN]

    down is a k=4 stride-2 conv without bias, upT a k=4 stride-2
    ConvTranspose (with a bias only in the outermost stage).  A
    non-outermost stage returns cat([input, output]) over channels, the
    input taken before its LeakyReLU, as in JAX."""

    def __init__(self, outer_nc: int, inner_nc: int, input_nc: Optional[int],
                 submodule: Optional["UnetBlock"] = None, outermost: bool = False):
        super().__init__()
        innermost = submodule is None
        self.outermost = outermost
        input_nc = outer_nc if input_nc is None else input_nc
        down = nn.Conv2d(input_nc, inner_nc, 4, stride=2, padding=1, bias=False)
        up = nn.ConvTranspose2d(inner_nc if innermost else 2 * inner_nc, outer_nc, 4,
                                stride=2, padding=1, bias=outermost)
        if outermost:
            layers = [down, submodule, nn.ReLU(), up, nn.Tanh()]
        elif innermost:
            layers = [nn.LeakyReLU(0.2), down, nn.ReLU(), up, nn.BatchNorm2d(outer_nc)]
        else:
            layers = [nn.LeakyReLU(0.2), down, nn.BatchNorm2d(inner_nc), submodule, nn.ReLU(),
                      up, nn.BatchNorm2d(outer_nc)]
        self.model = nn.Sequential(*layers)

    def forward(self, x: Tensor, training: bool = False, update_stats: bool = True,
                y_down: Optional[Tensor] = None) -> Tensor:
        """y_down: the outermost down conv's output, computed by the caller
        (apply_generator_edge); the stage then starts after that conv."""
        y, layers = x, list(self.model)
        if y_down is not None:
            if not self.outermost:
                raise ValueError("y_down replaces the outermost stage's down conv")
            y, layers = y_down, layers[1:]
        for m in layers:
            if isinstance(m, nn.Conv2d):
                y = F.conv2d(y, _narrow_input(m.weight, y.shape[1]), stride=2, padding=1)
            elif isinstance(m, nn.ConvTranspose2d):
                y = F.conv_transpose2d(y, m.weight, m.bias, stride=2, padding=1)
            elif isinstance(m, nn.BatchNorm2d):
                y = nn_core.batchnorm(y, m, training=training, update_stats=update_stats)
            elif isinstance(m, nn.LeakyReLU):
                y = nn_core.leaky_relu(y, 0.2)
            elif isinstance(m, nn.ReLU):
                y = torch.relu(y)
            elif isinstance(m, UnetBlock):
                y = m(y, training, update_stats)
            # Tanh: apply_generator applies it in f32
        return y if self.outermost else torch.cat([x, y], dim=1)


def _narrow_input(w: Tensor, channels: int) -> Tensor:
    """The first ``channels`` input planes of a conv weight.  The 'small'
    U-Net was built for 23 input channels (the reference's ``input_nc``)
    while the renderer's input stage (kernel K1's render_input) draws 13:
    the edge map and the four candidates fill the first 13, and the other 10
    count as zero, which is the weight narrowed to its first 13 planes.
    cuDNN then runs a 13-channel bf16 NHWC conv and pads the channels itself,
    as for the ResUNet's first layer: a traced 16-frame forward at 512^2
    shows its padding kernels in both (chip_smoke.py, onboard_small)."""
    return w if w.shape[1] == channels else w[:, :channels]


class UnetGenerator(nn.Module):
    def __init__(self, input_nc: int, output_nc: int, num_downs: int, ngf: int):
        super().__init__()
        if num_downs < 5:
            raise ValueError(f"the U-Net needs num_downs >= 5, got {num_downs}")
        block = UnetBlock(ngf * 8, ngf * 8, None)
        for _ in range(num_downs - 5):
            block = UnetBlock(ngf * 8, ngf * 8, None, block)
        block = UnetBlock(ngf * 4, ngf * 8, None, block)
        block = UnetBlock(ngf * 2, ngf * 4, None, block)
        block = UnetBlock(ngf, ngf * 2, None, block)
        self.model = UnetBlock(output_nc, ngf, input_nc, block, outermost=True)


class Feature2FaceG(nn.Module):
    def __init__(self, cfg: Feature2FaceConfig):
        super().__init__()
        self.size = cfg.size
        if cfg.size == "small":
            self.netG = UnetGenerator(cfg.input_nc, cfg.output_nc, cfg.n_downsample, cfg.ngf)
        elif cfg.size in N_RES:
            self.netG = ResUnetGenerator(cfg.input_nc, cfg.output_nc, cfg.n_downsample,
                                         cfg.ngf, N_RES[cfg.size])
        else:
            raise ValueError(f"unknown generator size {cfg.size!r}")

    def reset_parameters(self, gen: torch.Generator) -> None:
        """normal(0, 0.02) convs and N(1, 0.02) BatchNorm scales, the JAX
        init's scales."""
        nn_core.init_normal_(self, gen)
        nn_core.init_batchnorm_(self, gen)


def cast_generator(model: Feature2FaceG, dtype: torch.dtype) -> Feature2FaceG:
    """A copy with every float tensor (weights, BN statistics, int8 scales
    and biases) in ``dtype``, like JAX's _cast_net for the bf16 compute
    path, and 4-d weights in channels_last memory; int8 weights stay int8.
    A model already cast so is returned as it is (a server casts once)."""
    w = next(model.parameters())
    if w.dtype == dtype and w.is_contiguous(memory_format=torch.channels_last):
        return model
    return copy.deepcopy(model).to(dtype=dtype, memory_format=torch.channels_last)


def apply_generator(model: Feature2FaceG, x: Tensor, training: bool = False,
                    remat: bool | int = False) -> Tensor:
    """x [B, H, W, input_nc] (NHWC) -> [B, H, W, 3] in [-1, 1], f32.

    Computes in the model's dtype (see cast_generator), or in bf16 under
    torch.autocast (training); the tanh runs in f32.  training=True
    normalises every BatchNorm with the batch's statistics and updates the
    running stats.  The 'small' U-Net also takes the renderer's 13 channels
    (see _narrow_input).

    remat (JAX steps._remat_wrap): True recomputes the whole forward in the
    backward (one ``checkpointed`` region); an int K >= 1 recomputes only
    the outermost K ResUNet stages' halves, the high-resolution ones that
    hold most of the activation bytes, and keeps the inner stages'
    activations.  The result, the gradients and the running stats are those
    of remat=False."""
    dtype = next(model.parameters()).dtype
    x = x.permute(0, 3, 1, 2).to(dtype).contiguous(memory_format=torch.channels_last)
    net = model.netG.model
    with mesh.use_grid(getattr(model, "grid", None)):  # a channel-sharded model's grid
        if remat is True:
            y = checkpointed(lambda t, upd: net(t, training, upd), x)
        elif remat:
            if model.size not in N_RES:
                raise NotImplementedError("remat=K names ResUNet stages; the 'small' U-Net "
                                          "takes remat=True")
            y = net(x, training, remat=int(remat))
        else:
            y = net(x, training)
    return torch.tanh(y.float()).permute(0, 2, 3, 1)


def _first_conv(model: Feature2FaceG) -> nn.Conv2d:
    """The outermost down conv, which split_cand splits into the edge's and
    the candidates' halves: it must be a plain float conv without a bias
    (linear, so conv(cat(edge, cand)) = conv(edge; w[:, :1]) + conv(cand;
    w[:, 1:13])), as JAX's precompute_cand_down requires."""
    conv = model.netG.model.model[0]
    if isinstance(conv, nn_core.ConvS2DDown):
        # JAX precompute_cand_down's refusal: the packed kernel's channels
        # interleave the phases, so the edge / candidate split is gone
        raise ValueError(
            "split_cand requires the plain outermost down conv; this generator's input conv "
            "was rewritten (s2d_input_generator). Disable one of split_cand / s2d_input.")
    if type(conv) is not nn.Conv2d or conv.bias is not None:
        raise ValueError(
            "split_cand requires the plain outermost down conv (float, no bias); this "
            f"generator's first layer is {type(conv).__name__}"
            f"{' with a bias' if getattr(conv, 'bias', None) is not None else ''}")
    return conv


def precompute_cand_down(model: Feature2FaceG, cand_stack: Tensor,
                         dtype: Optional[torch.dtype] = None) -> Tensor:
    """The candidates' constant contribution to the outermost down conv
    (JAX feature2face.precompute_cand_down): 12 of the renderer's 13 input
    planes are the subject's candidate images, the same in every frame, and
    the first conv is linear and bias-free, so its candidate half is
    computed once a render call.  cand_stack [H, W, 12] -> [1, H/2, W/2,
    ngf] (NHWC, JAX's layout) in ``dtype`` (the model's when None), with the
    conv's own kernel size, stride and padding ('small': 4x4; 'normal' and
    'large': 3x3, stride 2, padding 1)."""
    conv = _first_conv(model)
    dtype = dtype or conv.weight.dtype
    w = conv.weight[:, 1:1 + cand_stack.shape[-1]].to(dtype)
    x = cand_stack.permute(2, 0, 1)[None].to(dtype).contiguous(
        memory_format=torch.channels_last)
    y = F.conv2d(x, w, stride=conv.stride, padding=conv.padding)
    return y.permute(0, 2, 3, 1)


def apply_generator_edge(model: Feature2FaceG, edge: Tensor, cand_down: Tensor) -> Tensor:
    """The inference forward on the edge channel alone (JAX
    apply_generator_edge): edge [B, H, W, 1] (K1's edge-only form) and
    cand_down [1, H/2, W/2, ngf] (precompute_cand_down) -> [B, H, W, 3] in
    [-1, 1], f32.  The first conv runs on the edge plane with its weight's
    first input plane and adds the candidates' half; every other layer is
    apply_generator's.  The sum rounds once more than the fused conv (in the
    compute dtype), so frames agree with apply_generator within rounding,
    not bit for bit."""
    conv = _first_conv(model)
    dtype = next(model.parameters()).dtype
    x = edge.permute(0, 3, 1, 2).to(dtype).contiguous(memory_format=torch.channels_last)
    y_down = F.conv2d(x, conv.weight[:, :1], stride=conv.stride, padding=conv.padding)
    y_down = y_down + cand_down.permute(0, 3, 1, 2).to(dtype)
    y = model.netG.model(None, False, y_down=y_down)
    return torch.tanh(y.float()).permute(0, 2, 3, 1)


def to_uint8(y: Tensor) -> Tensor:
    """[-1, 1] -> uint8, truncating like JAX's astype after the clip."""
    return ((y + 1.0) * 127.5).clamp(0, 255).to(torch.uint8)


# ---------------------------------------------------------------------------
# int8 inference transforms (feature2face.py:330-371, 491-636 of the JAX
# package).  Each returns a new model and leaves its argument unchanged.
# ---------------------------------------------------------------------------


def int8_conv_shapes(cfg: Feature2FaceConfig) -> list:
    """(input size, Cin, Cout, stride) of each int8 conv of the quantized
    ResUNet at cfg.load_size, in the order the forward runs them: each
    stage's down conv, its residual convs, the inner stages, its up conv
    (on the upsampled, concatenated map) and the residual convs after it.
    The outermost stage's own down and up convs stay float."""
    n_res = N_RES[cfg.size]
    inner = [cfg.ngf, cfg.ngf * 2, cfg.ngf * 4] + [cfg.ngf * 8] * (cfg.n_downsample - 3)

    def stage(k: int, size: int) -> list:
        c, half = inner[k], size // 2
        shapes = [(size, inner[k - 1], c, 2)] if k else []
        shapes += [(half, c, c, 1)] * (2 * n_res)
        if k + 1 < len(inner):
            shapes += stage(k + 1, half)
        if k:
            up_in = c if k + 1 == len(inner) else 2 * c
            shapes += [(size, up_in, inner[k - 1], 1)]
            shapes += [(size, inner[k - 1], inner[k - 1], 1)] * (2 * n_res)
        return shapes

    return stage(0, cfg.load_size)


def int8_up_convs(cfg: Feature2FaceConfig) -> list:
    """(fine size, Cin, Cout, n_a) of each int8 up conv of the quantized
    ResUNet at cfg.load_size (stages 1 .., outermost first; the outermost
    stage's up conv stays float): the 3x3 conv on the nearest-2x-upsampled
    map of cat(skip, inner output), n_a the skip's channels (0 for the
    innermost stage, whose up conv reads its own map alone).  The shapes the
    rewrites' int8 forms run at (subpixel_generator, split_skip_generator)."""
    inner = [cfg.ngf, cfg.ngf * 2, cfg.ngf * 4] + [cfg.ngf * 8] * (cfg.n_downsample - 3)
    out = []
    for k in range(1, len(inner)):
        innermost = k + 1 == len(inner)
        out.append((cfg.load_size >> k, inner[k] if innermost else 2 * inner[k],
                    inner[k - 1], 0 if innermost else inner[k]))
    return out


def k4_launches(model: nn.Module) -> int:
    """K4 launches of one forward of ``model``: one an int8 conv or int8
    rewritten layer, four a four-phase subpixel one; float layers none."""
    n = 0
    for m in model.modules():
        if isinstance(m, nn_core.QConv2d):
            n += 1
        elif isinstance(m, nn_core.REWRITES) and m.quantized:
            n += 4 if isinstance(m, nn_core.UpConvSubpixel) else 1
    return n


# JAX's refusals of the 'small' U-Net (feature2face.py:349-353, 511-514, 632-635)
_SMALL_REFUSED = {
    "quantize": "int8 quantization targets the ResUNet variants ('normal'/'large'); the "
                "legacy pix2pix 'small' U-Net upsamples with ConvTranspose layers that keep "
                "the float path",
    "calibrate": "int8 calibration targets the ResUNet variants; quantize the generator "
                 "first (quantize_generator)",
    "fold_bn": "BN folding targets the ResUNet variants; the 'small' U-Net applies BN "
               "after ConvTranspose upsampling, left unfolded",
    "subpixel": "the 'small' pix2pix U-Net upsamples with ConvTranspose, not nearest+conv; "
                "subpixel rewrite targets the ResUNet variants",
    "s2d": "s2d input rewrite targets the ResUNet variants",
    "split_skip": "split-skip rewrite targets the ResUNet variants ('small' uses "
                  "ConvTranspose ups)",
}


def _resunet_only(model: Feature2FaceG, what: str) -> None:
    if model.size not in N_RES:
        raise NotImplementedError(_SMALL_REFUSED[what])


def _stages(model: Feature2FaceG) -> Iterator[ResUnetBlock]:
    """The U-Net stages, outermost first."""
    stage: Optional[ResUnetBlock] = model.netG.model
    while stage is not None:
        yield stage
        stage = next((m for m in stage.model if isinstance(m, ResUnetBlock)), None)


def _replace_interior_convs(model: Feature2FaceG, fn) -> Feature2FaceG:
    """A copy whose interior convs (every conv but the outermost stage's down
    (13 -> ngf) and up (-> 3) convs; the outermost stage's residual blocks
    included) are fn(conv): quantize_generator's subset, which qat_generator
    tags."""
    q = copy.deepcopy(model)
    for stage in _stages(q):
        seq = stage.model
        for i, m in enumerate(seq):
            if isinstance(m, nn.Conv2d) and not stage.outermost:
                seq[i] = fn(m)
            elif isinstance(m, ResnetBlock):
                m.block[0] = fn(m.block[0])
                m.block[3] = fn(m.block[3])
    return q


def quantize_generator(model: Feature2FaceG) -> Feature2FaceG:
    """Every interior conv becomes an int8 QConv2d with per-output-channel
    weight scales.  A QAT-tagged model quantizes as its float twin does, and
    a baked x_scale rides into the int8 layer."""
    _resunet_only(model, "quantize")
    return _replace_interior_convs(model, nn_core.QConv2d.from_conv)


def qat_generator(model: Feature2FaceG, int8_forward: bool = False) -> Feature2FaceG:
    """A copy tagged for quantization-aware fine-tuning: exactly the convs
    quantize_generator quantizes become QATConv2d, "fq8" (their forward on
    the int8 kernel K4, bit-identical to deployment) with int8_forward, else
    "fq" (the f32 emulation); both with straight-through gradients.  The
    model stays float and trainable, with the float model's state-dict keys;
    it deploys through quantize_generator -> fold_bn_generator ->
    calibrate_generator.  A conv already tagged raises (strip first)."""
    if model.size not in N_RES:
        raise NotImplementedError("QAT targets the ResUNet variants ('normal'/'large'), "
                                  "matching quantize_generator")
    return _replace_interior_convs(
        model, lambda c: nn_core.fake_quant_conv(c, int8_forward=int8_forward))


def qat_tag_mode(model: nn.Module) -> Optional[str]:
    """The QAT tag a model's convs carry ("fq" or "fq8"), or None."""
    return next((m.mode for m in model.modules() if isinstance(m, nn_core.QATConv2d)), None)


def is_qat_generator(model: nn.Module) -> bool:
    """True iff any conv of the model carries a QAT tag (either mode)."""
    return qat_tag_mode(model) is not None


def strip_qat_generator(model: Feature2FaceG) -> Feature2FaceG:
    """A copy with every QAT tag removed: plain float convs, a baked x_scale
    kept (quantize_generator carries it into the int8 layer)."""
    q = copy.deepcopy(model)
    for parent in list(q.modules()):
        for name, child in list(parent.named_children()):
            if isinstance(child, nn_core.QATConv2d):
                setattr(parent, name, nn_core.strip_qat_conv(child))
    return q


@torch.no_grad()
def _fold_pair(conv, bn: nn.BatchNorm2d, eps: float) -> None:
    """Fold bn's running stats into conv (w' = w*k or w_scale' = w_scale*k,
    b' = b*k + bias - mean*k, k = scale * rsqrt(var + eps)) and leave bn at
    JAX's identity values (1, 0, 0, 1 - eps)."""
    k = bn.weight * torch.rsqrt(bn.running_var + eps)
    b = bn.bias - bn.running_mean * k
    if isinstance(conv, nn_core.QConv2d):
        conv.w_scale = conv.w_scale * k
        conv.b = (torch.zeros_like(k) if conv.b is None else conv.b) * k + b
    else:
        conv.weight.copy_(conv.weight * k.view(-1, 1, 1, 1))
        old = torch.zeros_like(k) if conv.bias is None else conv.bias
        conv.bias = nn.Parameter(old * k + b, requires_grad=False)
    bn.weight.fill_(1.0)
    bn.bias.zero_()
    bn.running_mean.zero_()
    bn.running_var.fill_(1.0 - eps)


def fold_bn_generator(model: Feature2FaceG, eps: float = nn_core.BN_EPS) -> Feature2FaceG:
    """Eval-only: fold every conv -> BN pair into the conv, on a float or an
    int8 model (for an int8 conv the fold lands on w_scale), and mark the
    BNs it leaves at the identity (mark_folded_bn), which the eval forward
    then skips."""
    _resunet_only(model, "fold_bn")
    q = copy.deepcopy(model)
    for m in q.modules():
        if isinstance(m, ResnetBlock):
            _fold_pair(m.block[0], m.block[1], eps)
            _fold_pair(m.block[3], m.block[4], eps)
        elif isinstance(m, ResUnetBlock):
            seq = m.model
            for i in range(len(seq) - 1):
                if isinstance(seq[i + 1], nn.BatchNorm2d):
                    _fold_pair(seq[i], seq[i + 1], eps)
    return mark_folded_bn(q)


def _is_identity_bn(bn: nn.modules.batchnorm._BatchNorm) -> bool:
    """Whether bn's eval forward is the identity: scale 1, bias 0, mean 0 and
    rsqrt(var + eps) exactly 1 in f32, as JAX's 1 - eps gives (and so in
    bf16 and f16, where var rounds to 1)."""
    var = bn.running_var.float()
    return bool(torch.all(bn.weight == 1) and torch.all(bn.bias == 0)
                and torch.all(bn.running_mean == 0)
                and torch.all(torch.rsqrt(var + nn_core.BN_EPS) == 1))


def mark_folded_bn(model: nn.Module) -> nn.Module:
    """Mark, in place, each BatchNorm of ``model`` that holds the identity
    BN folding leaves (``folded`` True; every other BatchNorm False), and
    return the model.  One host-side check of the values, made where a tree
    is folded (fold_bn_generator) or loaded (assets.from_jax, so also a
    serving artifact); the mark goes with the module through copy.deepcopy
    and .to().  nn_core.batchnorm's eval mode returns a marked BN's input
    unchanged, the same frames bit for bit; training mode ignores the
    mark."""
    for m in model.modules():
        if isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.folded = _is_identity_bn(m)
    return model


def folded_bn_count(model: nn.Module) -> int:
    """The BatchNorms of ``model`` that an eval forward skips."""
    return sum(getattr(m, "folded", False) for m in model.modules()
               if isinstance(m, nn.modules.batchnorm._BatchNorm))


def _convs_in_order(stage: ResUnetBlock) -> Iterator[nn.Module]:
    """A stage's convs in the order the forward consumes them: down,
    res_down (conv1, conv2 each), the inner stage, up, res_up - JAX's
    calibration walk."""
    for m in stage.model:
        if isinstance(m, ResUnetBlock):
            yield from _convs_in_order(m)
        elif isinstance(m, ResnetBlock):
            yield m.block[0]
            yield m.block[3]
        elif isinstance(m, (nn.Conv2d, nn_core.QConv2d) + nn_core.REWRITES):
            yield m


def _calibrated(conv: nn.Module) -> bool:
    """Whether JAX's calibration walk gives this conv a scale: the int8 and
    QAT-tagged convs and an int8 split up conv (one joint amax).  Its walk
    skips the subpixel and dilated rewrites, whose forwards record all the
    same, so calibrating such a tree raises, as it does there: they apply
    after calibration."""
    return (isinstance(conv, (nn_core.QConv2d, nn_core.QATConv2d))
            or isinstance(conv, nn_core.UpConvSplit) and conv.quantized)


def _assign_x_scales(model: Feature2FaceG, scales: np.ndarray) -> None:
    """Give the quantized and the QAT-tagged convs, in consumption order, one
    scale each."""
    it = iter(scales)
    for conv in _convs_in_order(model.netG.model):
        if _calibrated(conv):
            try:
                s = next(it)
            except StopIteration:
                raise RuntimeError("parameter walk visited more quantized convs than the "
                                   "forward recorded - forward/walk order mismatch") from None
            dev = next(conv.parameters(), None)
            dev = (dev if dev is not None else next(conv.buffers())).device
            conv.x_scale = torch.tensor(s, dtype=torch.float32, device=dev)
    leftovers = sum(1 for _ in it)
    if leftovers:
        raise RuntimeError(f"calibration recorded {leftovers} more conv activations than the "
                           "parameter walk visited - forward/walk order mismatch")


@torch.no_grad()
def calibrate_generator(model: Feature2FaceG, inputs, compute_dtype: Optional[torch.dtype] = None,
                        margin: float = 1.0) -> Feature2FaceG:
    """Static activation scales for an int8 or a QAT-tagged model: run the
    forward on ``inputs`` (one [B, H, W, input_nc] batch or a list), record
    each quantized or tagged conv's input amax in call order (a split up
    conv one joint amax of its pair), and store x_scale =
    max(max-over-batches(amax) * margin, 1e-12) / 127 (f32) on each of
    them."""
    _resunet_only(model, "calibrate")
    batches = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    net = model if compute_dtype is None else cast_generator(model, compute_dtype)
    amax = None
    for x in batches:
        with nn_core.recording_amax(net) as record:
            apply_generator(net, x)
        if not record:
            raise ValueError("calibration recorded no activations: the model has no "
                             "quantized or QAT-tagged convs - run quantize_generator or "
                             "qat_generator first")
        a = torch.stack(record).cpu().numpy()
        amax = a if amax is None else np.maximum(amax, a)
    out = copy.deepcopy(model)
    _assign_x_scales(out, np.maximum(amax * margin, 1e-12) / 127.0)
    return out


# ---------------------------------------------------------------------------
# The structural inference rewrites (feature2face.py:639-720 of the JAX
# package).  Exact maps, float up to summation order; each returns a copy and
# applies after quantize, fold and calibrate, as in JAX.
# ---------------------------------------------------------------------------


def _rewrite_up(stage: ResUnetBlock, fn) -> None:
    """Replace the stage's upsample + up conv by UpsampleAbsorbed + fn(conv)."""
    seq = stage.model
    i = next(i for i, m in enumerate(seq) if isinstance(m, nn.Upsample))
    seq[i + 1] = fn(seq[i + 1])
    seq[i] = UpsampleAbsorbed()


def subpixel_generator(model: Feature2FaceG, mode: str = "four",
                       outermost_only: bool = False) -> Feature2FaceG:
    """Every nearest-2x upsample + 3x3 up conv (only the outermost, to-RGB
    one with outermost_only) rewritten into an exact subpixel conv at the
    coarse resolution: mode "four" (four 2x2 phase convs, 4/9 the
    multiply-adds; int8: four K4 launches), "single" (one 3x3 conv with 4 *
    Co outputs; int8: one K4 launch) or "dilated" (one 4x4 conv over the
    input dilated by 2; int8: one K4 launch).  Float and int8 models alike."""
    _resunet_only(model, "subpixel")
    rewrite = {"four": nn_core.subpixel_from_conv3x3, "single": nn_core.subpixel1_from_conv3x3,
               "dilated": nn_core.dilated_from_conv3x3}[mode]
    q = copy.deepcopy(model)
    for stage in _stages(q):
        if stage.outermost or not outermost_only:
            _rewrite_up(stage, rewrite)
    return q


def s2d_input_generator(model: Feature2FaceG) -> Feature2FaceG:
    """The outermost down conv (the [64, 13, 3, 3] stride-2 conv reading the
    edge and candidate input) as a 2x2 stride-1 conv over the space-to-depth
    packed input (nn_core.s2d_from_conv3x3s2), 4x the input channels for
    16/9 the nominal multiply-adds.  split_cand then refuses the model
    (precompute_cand_down)."""
    _resunet_only(model, "s2d")
    q = copy.deepcopy(model)
    seq = q.netG.model.model
    seq[0] = nn_core.s2d_from_conv3x3s2(seq[0])
    return q


def split_skip_generator(model: Feature2FaceG) -> Feature2FaceG:
    """Every skip-consuming up conv (every stage's but the innermost's) as
    the concat-free split form (nn_core.split_from_concat_conv): no stage
    writes its cat(skip, inner output), nor its upsample.  Exact: float up to
    summation order, int8 bit for bit on K4 (one x_scale, one int32 sum).
    Instead of the subpixel rewrites (both take the same up convs): a model
    that holds one raises."""
    _resunet_only(model, "split_skip")
    q = copy.deepcopy(model)
    for stage in _stages(q):
        seq = list(stage.model)
        if not any(isinstance(m, ResUnetBlock) for m in seq):
            continue  # the innermost up conv reads a single tensor
        i = next(i for i, m in enumerate(seq) if isinstance(m, (nn.Upsample, UpsampleAbsorbed)))
        up = seq[i + 1]
        if not isinstance(up, (nn.Conv2d, nn_core.QConv2d)):
            raise ValueError("split_skip_generator needs plain 3x3 'up' convs; this tree already "
                             "carries a subpixel/dilated rewrite "
                             f"({sorted(n for n, _ in up.named_buffers())})")
        n_a = (up.w_q if isinstance(up, nn_core.QConv2d) else up.weight).shape[1] // 2
        _rewrite_up(stage, lambda c: nn_core.split_from_concat_conv(c, n_a))
    return q


def conform_to_state_dict(model: Feature2FaceG, sd) -> None:
    """Shape the module tree, in place, for a state dict of a transformed
    generator: a conv whose entry is int8 (``w_q``) becomes a QConv2d, one
    whose entry holds a rewrite's weights that rewrite's layer (an up conv's
    upsample then UpsampleAbsorbed), and a float conv that carries a bias
    after BN folding gets one."""
    for prefix, parent in list(model.named_modules()):
        for name, child in list(parent.named_children()):
            if not isinstance(child, nn.Conv2d):
                continue
            key = f"{prefix}.{name}" if prefix else name
            cls = next((c for c in nn_core.REWRITES if c.rewrites(sd, key)), None)
            if cls is not None:
                shape = (child.kernel_size[0], child.in_channels, child.out_channels,
                         child.stride[0], child.padding[0])
                setattr(parent, name, cls.shaped_like(sd, key, shape))
                if cls is not nn_core.ConvS2DDown:
                    setattr(parent, str(int(name) - 1), UpsampleAbsorbed())
            elif f"{key}.w_q" in sd:
                w_q = torch.zeros(sd[f"{key}.w_q"].shape, dtype=torch.int8)
                setattr(parent, name, nn_core.QConv2d(
                    w_q, torch.zeros(w_q.shape[0]), child.stride[0], child.padding[0]))
            elif f"{key}.bias" in sd and child.bias is None:
                child.bias = nn.Parameter(torch.zeros(child.out_channels), requires_grad=False)


# ---------------------------------------------------------------------------
# Multiscale PatchGAN discriminator (init_discriminator / apply_discriminator,
# feature2face.py:820-877 of the JAX package), the training-only half of the
# GAN.
# ---------------------------------------------------------------------------


class Feature2FaceD(nn.Module):
    """``num_D`` PatchGANs in the reference's MultiscaleDiscriminator layout
    (``getIntermFeat``): scale i, layer j is ``scale{i}_layer{j}``, a
    Sequential of a k=4 conv with a bias, then BatchNorm on the interior
    layers, then LeakyReLU(0.2) on all but the last.  Layers 0 .. n_layers-1
    have stride 2, the last two stride 1, all padding 2.  Its input is the G
    input with the frame beside it (input_nc + 3 channels).  The reference
    runs scale num_D-1 at full resolution (its forward walks the scales
    from the last), so scale num_D-1-k sees the input pooled k times."""

    def __init__(self, cfg: Feature2FaceConfig):
        super().__init__()
        self.num_D, self.n_layers = cfg.num_D, cfg.n_layers_D
        n = cfg.n_layers_D
        widths = ([cfg.input_nc + 3] + [min(cfg.ndf * 2 ** j, 512) for j in range(n + 1)]
                  + [1])
        for i in range(cfg.num_D):
            for j in range(n + 2):
                layers = [nn.Conv2d(widths[j], widths[j + 1], 4, stride=2 if j < n else 1,
                                    padding=2)]
                if 0 < j <= n:
                    layers.append(nn.BatchNorm2d(widths[j + 1]))
                if j <= n:
                    layers.append(nn.LeakyReLU(0.2))
                setattr(self, f"scale{i}_layer{j}", nn.Sequential(*layers))

    def reset_parameters(self, gen: torch.Generator) -> None:
        """normal(0, 0.02) convs, zero biases, N(1, 0.02) BatchNorm scales."""
        nn_core.init_normal_(self, gen)
        nn_core.init_batchnorm_(self, gen)

    def scale_layers(self, k: int) -> list:
        """The layers that see the input pooled k times, first to last."""
        i = self.num_D - 1 - k
        return [getattr(self, f"scale{i}_layer{j}") for j in range(self.n_layers + 2)]


def apply_discriminator(model: Feature2FaceD, x: Tensor, training: bool = False,
                        update_stats: bool = True) -> list:
    """x [B, H, W, input_nc + 3] (NHWC) -> one list a scale, full resolution
    first, of every layer's output [B, h, w, C] (NHWC views), the final
    logits last: the features of the feature-matching loss.  Between scales
    the input is average-pooled (3, stride 2, pad 1, padding not counted).
    training=True normalises with batch statistics, and updates the running
    stats unless update_stats is False.  Every conv goes through
    nn_core.conv2d, so a qat_discriminator view runs its interior convs on
    K4."""
    dtype = next(model.parameters()).dtype
    inp = x.permute(0, 3, 1, 2).to(dtype).contiguous(memory_format=torch.channels_last)
    results = []
    with mesh.use_grid(getattr(model, "grid", None)):  # a channel-sharded model's grid
        for k in range(model.num_D):
            feats, y = [], inp
            for seq in model.scale_layers(k):
                conv = seq[0]
                y = nn_core.conv2d(_conv_in(y, conv), conv, stride=conv.stride[0],
                                   padding=conv.padding[0])
                if len(seq) > 1 and isinstance(seq[1], nn.BatchNorm2d):
                    y = nn_core.batchnorm(y, seq[1], training=training,
                                          update_stats=update_stats)
                if isinstance(seq[-1], nn.LeakyReLU):
                    y = nn_core.leaky_relu(y, 0.2)
                y = _whole(y, conv)
                feats.append(y.permute(0, 2, 3, 1))
            results.append(feats)
            if k + 1 < model.num_D:
                inp = F.avg_pool2d(inp, 3, stride=2, padding=1, count_include_pad=False)
    return results


def qat_discriminator(model: Feature2FaceD, int8_forward: bool = True) -> Feature2FaceD:
    """A view of ``model`` whose interior convs (layers 1 .. n_layers_D of
    every scale) are QAT-tagged, "fq8" by default: their forward runs on the
    int8 kernel K4 while every gradient, the one reaching the generator
    through D included, is the straight-through float one.  Each scale's
    first conv (the image pair) and its logits conv stay float.  The view
    shares the model's parameters and BatchNorm modules, so it is made
    inside each training step (JAX applies the tags there too) and the
    checkpoints and optimizer state never see a tag."""
    view = copy.copy(model)
    view._modules = dict(model._modules)
    for i in range(model.num_D):
        for j in range(1, model.n_layers + 1):
            name = f"scale{i}_layer{j}"
            seq = model._modules[name]
            view._modules[name] = nn.Sequential(
                nn_core.fake_quant_conv(seq[0], int8_forward=int8_forward), *seq[1:])
    return view
