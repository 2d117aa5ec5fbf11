"""The model axis: channel (tensor) and spatial partitioning of the renderer.

Counterpart of ``livespeechportraits_tpu/parallel/sharding.py``.  JAX places
the parameters and the batch with a ``PartitionSpec`` over a (data, model)
mesh and GSPMD inserts the collectives; here each rank of a
``mesh.Grid`` keeps its share and the forward runs the collectives itself.

Channel partitioning (``param_partition_spec``, ``shard_params``,
``full_state_dict``): every conv's output channels, and every per-channel
vector of that length, split over the model axis; each rank computes its
slice of a conv's outputs from the whole input, runs the per-channel ops on
it (BatchNorm, ReLU, LeakyReLU) and gathers the whole map for what follows
(``feature2face._conv_in`` / ``_whole``: Megatron's pair, identity forward
and all-reduce backward at a sharded conv's input, all-gather forward and
own-slice backward after its per-channel ops).  What is not divisible (the
to-RGB conv's 3 channels, the discriminator's 1-channel logits) is
replicated and runs whole on every model rank.  The BatchNorm statistics,
the gradients and the optimizer (ZeRO-1 included) reduce over the data axis
only (``mesh.use_grid``): the model ranks of one data index hold other
channels of the same rows.

Spatial partitioning (``shard_spatial``, ``apply_generator_spatial``,
``gather_spatial``): the inference renderer on each model rank's slab of
rows.  A 3x3 stride-1 conv takes one halo row from each neighbour (zeros at
the image's true top and bottom), a stride-2 down conv two rows from above;
the nearest 2x upsample, the concat, the residual add and the eval
BatchNorm are local.  A stage whose input slab is below SPATIAL_MIN_ROWS
rows (or odd) gathers its rows, runs whole on every rank with every stage
inside it, and keeps its own rows of the result.  The output stays sharded,
as JAX's does (tests/test_parallel.py:427); ``gather_spatial`` joins it.

The halo exchange and the gathers are all-gathers (gloo takes them on CUDA
tensors, so two ranks can share one card, where NCCL refuses them).
``EXCHANGED_BYTES`` counts the bytes this rank contributes to them.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from livespeechportraits_torch.models import feature2face as f2f
from livespeechportraits_torch.models import nn_core
from livespeechportraits_torch.parallel import mesh

Tensor = torch.Tensor

# A stage of the spatial forward runs on slabs when its input slab has at
# least this many rows (and an even count, for its stride-2 down conv):
# below it the inner stages' halo exchanges cost more than the 2-8 rows
# they save, so the stage runs whole
SPATIAL_MIN_ROWS = 8

# Bytes this rank contributed to the spatial forward's all-gathers (halo
# rows and stage gathers); the caller zeroes it
EXCHANGED_BYTES = 0


def param_partition_spec(name: str, tensor: Tensor, model_size: int) -> Optional[int]:
    """The dim of a parameter or buffer that the model axis splits, or None
    (replicated): JAX's rule (sharding.py:23-35) in torch's layout.

    A conv weight [O, I, kh, kw] or a dense weight [O, I] splits its output
    channels, dim 0, when O % model_size == 0 (JAX's kernel [kh, kw, I, O]
    or [I, O]: ``P(None, ..., 'model')``); a vector whose length divides
    splits dim 0 (``P('model')``); anything else, a 0-d tensor included, is
    replicated (``P()``).  ``name`` is the leaf's key, as JAX's path."""
    shape = tuple(tensor.shape)
    if model_size <= 1 or not shape or shape[0] % model_size:
        return None
    return 0


def _check_shardable(module: nn.Module) -> None:
    if isinstance(module, f2f.Feature2FaceG) and module.size not in f2f.N_RES:
        raise ValueError(f"channel partitioning takes the ResUNet ('normal', 'large'), not "
                         f"{module.size!r}: the 'small' U-Net's transposed convs hold their "
                         "output channels in dim 1")
    if not isinstance(module, (f2f.Feature2FaceG, f2f.Feature2FaceD)):
        raise ValueError(f"shard_params takes a Feature2FaceG or Feature2FaceD, got "
                         f"{type(module).__name__}")
    for m in module.modules():
        if isinstance(m, (nn_core.QConv2d, *nn_core.REWRITES)):
            raise ValueError("shard_params takes a float (or QAT-tagged) network; quantize "
                             "or rewrite it after full_state_dict")


@torch.no_grad()
def shard_params(module: nn.Module, grid: mesh.Grid) -> nn.Module:
    """Keep this rank's slice of every leaf that param_partition_spec splits
    (in place; returns the module).  Each channel-sharded conv is tagged
    with the grid (``tp_grid``: its forward gathers over the model axis) and
    the module carries it (``grid``: the steps and the forward reduce over
    its data axis); ``sharded_keys`` names the split state-dict entries.
    Build the optimizer after this call: the Parameters are new."""
    _check_shardable(module)
    mp, j = grid.model_size, grid.model_index
    sharded = []
    prefix = {m: n for n, m in module.named_modules()}
    for m in module.modules():
        for kind in ("_parameters", "_buffers"):
            for name, t in list(getattr(m, kind).items()):
                if t is None or param_partition_spec(name, t, mp) is None:
                    continue
                n = t.shape[0] // mp
                part = t.detach()[j * n:(j + 1) * n].clone(memory_format=torch.preserve_format)
                if kind == "_parameters":
                    part = nn.Parameter(part, requires_grad=t.requires_grad)
                getattr(m, kind)[name] = part
                sharded.append(f"{prefix[m]}.{name}" if prefix[m] else name)
        if isinstance(m, nn.Conv2d) and m.out_channels % mp == 0 and mp > 1:
            m.out_channels //= mp
            m.tp_grid = grid
        if isinstance(m, nn.modules.batchnorm._BatchNorm) and m.num_features % mp == 0:
            m.num_features //= mp
    module.grid = grid
    module.sharded_keys = frozenset(sharded)
    return module


def full_state_dict(module: nn.Module) -> Dict[str, Tensor]:
    """The one-device state dict of a channel-sharded module: each split
    entry gathered over its grid's model axis in model-index order (a
    collective: every model rank calls it), the rest as they are.  It
    loads, strict, into the unsharded module."""
    grid = module.grid
    out = {}
    for k, v in module.state_dict().items():
        if k in module.sharded_keys:
            parts = [torch.empty_like(v.contiguous()) for _ in range(grid.model_size)]
            dist.all_gather(parts, v.contiguous(), group=grid.model_group)
            v = torch.cat(parts, dim=0)
        out[k] = v.detach().clone()
    return out


# ---------------------------------------------------------------------------
# spatial partitioning
# ---------------------------------------------------------------------------


def shard_spatial(x: Tensor, grid: mesh.Grid, axis: int = 2) -> Tensor:
    """This model rank's slab of rows of x along ``axis`` (NCHW: 2; the
    renderer's NHWC input: 1), JAX's shard_spatial.  The rows must divide
    over the model axis."""
    H, mp = x.shape[axis], grid.model_size
    if H % mp:
        raise ValueError(f"spatial partitioning needs the rows ({H}) divisible by the model "
                         f"axis ({mp})")
    h = H // mp
    return x.narrow(axis, grid.model_index * h, h)


def gather_spatial(y: Tensor, grid: mesh.Grid, axis: int = 2) -> Tensor:
    """The whole image from each model rank's slab along ``axis`` (the
    inverse of shard_spatial; an all-gather)."""
    global EXCHANGED_BYTES
    d = y.contiguous()
    parts = [torch.empty_like(d) for _ in range(grid.model_size)]
    dist.all_gather(parts, d, group=grid.model_group)
    EXCHANGED_BYTES += d.numel() * d.element_size()
    return torch.cat(parts, dim=axis)


def _slab_of(y: Tensor, grid: mesh.Grid) -> Tensor:
    """This model rank's rows (dim 2) of a whole NCHW map, as a new map."""
    h = y.shape[2] // grid.model_size
    return y[:, :, grid.model_index * h:(grid.model_index + 1) * h].contiguous(
        memory_format=torch.channels_last)


class _Slabs:
    """The spatial forward's state: the grid, whether the current stage runs
    whole on every rank, and the taps (conv, output rows, first row) when a
    caller collects them."""

    def __init__(self, grid: mesh.Grid, taps: Optional[list]):
        self.grid, self.whole, self.taps = grid, False, taps

    def halo(self, x: Tensor, top: int, bottom: int) -> Tuple[Tensor, Tensor]:
        """(the ``top`` rows above this slab, the ``bottom`` rows below it):
        the neighbours' edge rows, zeros at the image's true top and bottom;
        one all-gather of every rank's edges."""
        global EXCHANGED_BYTES
        g = self.grid
        edges = torch.cat([x[:, :, :bottom], x[:, :, x.shape[2] - top:]], dim=2)
        d = edges.permute(0, 2, 3, 1).contiguous()  # NHWC: the channels_last bytes
        parts = [torch.empty_like(d) for _ in range(g.model_size)]
        dist.all_gather(parts, d, group=g.model_group)
        EXCHANGED_BYTES += d.numel() * d.element_size()
        parts = [p.permute(0, 3, 1, 2) for p in parts]
        j = g.model_index
        above = parts[j - 1][:, :, bottom:] if j > 0 else x.new_zeros(
            x.shape[0], x.shape[1], top, x.shape[3])
        below = parts[j + 1][:, :, :bottom] if j + 1 < g.model_size else x.new_zeros(
            x.shape[0], x.shape[1], bottom, x.shape[3])
        return above, below

    def row0(self, rows: int) -> int:
        return 0 if self.whole else self.grid.model_index * rows

    def conv(self, x: Tensor, conv: nn.Module) -> Tensor:
        """A 3x3 conv (padding 1, stride 1 or 2) of this slab: its output rows.

        Stride 1: the slab with a halo row on each side, padded with zero rows
        to a multiple of 8 (K4's halo kernel wants H % 8 == 0), convolved at
        the conv's own padding and cropped to the slab's rows.  Stride 2: the
        slab with two rows from above (the window of output row r0 / 2 starts
        at r0 - 1), convolved at padding 1 and cropped past the first row.
        The kept rows read the same inputs as the one-device conv's: an int8
        conv's rows equal its rows bit for bit."""
        stride = conv.stride[0]
        k = (conv.w_q if isinstance(conv, nn_core.QConv2d) else conv.weight).shape[-1]
        if conv.padding[0] != 1 or k != 3 or stride not in (1, 2):
            raise ValueError(f"the spatial forward takes 3x3 convs of padding 1, got "
                             f"{k}x{k} / {conv.padding} / {conv.stride}")
        h = x.shape[2]
        if self.whole:
            y = nn_core.conv2d(x, conv, stride=stride, padding=1)
        elif stride == 1:
            above, below = self.halo(x, 1, 1)
            pad = -(h + 2) % 8
            zt, zb = pad // 2, pad - pad // 2
            parts = [above, x, below]
            if pad:
                parts = [x.new_zeros(x.shape[0], x.shape[1], zt, x.shape[3]), *parts,
                         x.new_zeros(x.shape[0], x.shape[1], zb, x.shape[3])]
            xh = torch.cat(parts, dim=2).contiguous(memory_format=torch.channels_last)
            y = nn_core.conv2d(xh, conv, stride=1, padding=1)[:, :, zt + 1:zt + 1 + h]
        else:
            above, _ = self.halo(x, 2, 0)
            xh = torch.cat([above, x], dim=2).contiguous(memory_format=torch.channels_last)
            y = nn_core.conv2d(xh, conv, stride=2, padding=1)[:, :, 1:1 + h // 2]
        if self.taps is not None:
            self.taps.append((conv, y, self.row0(y.shape[2])))
        return y

    def run(self, layers, y: Tensor) -> Tensor:
        for m in layers:
            if isinstance(m, (nn.Conv2d, nn_core.QConv2d)):
                y = self.conv(y, m)
            elif isinstance(m, nn.BatchNorm2d):
                y = nn_core.batchnorm(y, m)
            elif isinstance(m, nn.ReLU):
                y = torch.relu(y)
            elif isinstance(m, nn.Upsample):
                y = nn_core.upsample_nearest_2x(y)
            else:  # ResnetBlock
                b = m.block
                r = torch.relu(nn_core.batchnorm(self.conv(y, b[0]), b[1]))
                y = torch.relu(y + nn_core.batchnorm(self.conv(r, b[3]), b[4]))
        return y

    def stage(self, stage: f2f.ResUnetBlock, x: Tensor):
        """One ResUNet stage on this rank's slab x (or on the whole map once a
        stage has gathered): its output, or (x, output) below the outermost
        stage, as ResUnetBlock.forward returns."""
        h = x.shape[2]
        if not self.whole and (h < SPATIAL_MIN_ROWS or h % 2):
            self.whole = True
            try:
                y = self.stage(stage, gather_spatial(x, self.grid))
            finally:
                self.whole = False
            y = _slab_of(y if stage.outermost else y[1], self.grid)
            return y if stage.outermost else (x, y)
        layers = list(stage.model)
        cut = next(i for i, m in enumerate(layers) if isinstance(m, nn.Upsample))
        inner = layers[cut - 1] if isinstance(layers[cut - 1], f2f.ResUnetBlock) else None
        down, up = layers[:cut - 1 if inner is not None else cut], layers[cut:]
        y = self.run(down, x)
        if inner is not None:
            y = torch.cat(self.stage(inner, y), dim=1)
        y = self.run(up, y)
        return y if stage.outermost else (x, y)


def _check_spatial(model: f2f.Feature2FaceG) -> None:
    if model.size not in f2f.N_RES:
        raise ValueError(f"the spatial forward takes the ResUNet ('normal', 'large'), not "
                         f"{model.size!r}")
    for m in model.modules():
        if isinstance(m, (*nn_core.REWRITES, f2f.UpsampleAbsorbed)):
            raise ValueError(
                f"a rewritten generator (subpixel, s2d input or split skip: "
                f"{type(m).__name__}) under spatial partitioning is not ported; spatially "
                "partition the unrewritten tree")
        if getattr(m, "tp_grid", None) is not None:
            raise ValueError("the spatial forward takes a model with whole channels "
                             "(full_state_dict of a channel-sharded one)")


@torch.no_grad()
def apply_generator_spatial(model: f2f.Feature2FaceG, x: Tensor, grid: mesh.Grid,
                            taps: Optional[list] = None) -> Tensor:
    """The inference renderer (apply_generator, training=False) on this model
    rank's slab of rows: x [B, H / mp, W, input_nc] NHWC (``shard_spatial(x,
    grid, axis=1)``) -> its rows of the frames [B, H / mp, W, 3] in [-1, 1],
    f32 (``gather_spatial(y, grid, axis=1)`` joins them).  Float or int8
    (QConv2d on K4) unrewritten ResUNets; a dynamic int8 activation scale is
    the max over the data and model ranks.  ``taps``: a list that collects
    each conv's (layer, output rows, first global row)."""
    _check_spatial(model)
    dtype = next(model.parameters()).dtype
    y = x.permute(0, 3, 1, 2).to(dtype).contiguous(memory_format=torch.channels_last)
    with mesh.use_grid(grid, spatial=True):
        y = _Slabs(grid, taps).stage(model.netG.model, y)
    return torch.tanh(y.float()).permute(0, 2, 3, 1)

