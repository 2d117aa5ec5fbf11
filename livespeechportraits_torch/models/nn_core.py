"""The layer functions the offline path uses, on PyTorch tensors.

Counterpart of ``livespeechportraits_tpu/models/nn_core.py``.  Weights are
in torch's layouts (Linear ``[out, in]``, Conv ``[out, in, k...]``, RNN
``[G*H, in]``), so the reference's state dicts load unchanged; activations
are NCHW / NCW inside the networks.

``gru_layer`` and ``lstm_layer`` are the plain PyTorch twins of the CUDA
recurrence kernels (``ops/recurrent_cuda.py``): a Python loop over time with
the input projection hoisted out of it, as in JAX.  ``gru_batched`` and
``lstm_batched`` are the trainers' recurrences (torch's RNN operator), and
``batchnorm`` has the training mode the trainers use.  ``QATConv2d`` is a
float conv tagged for quantization-aware training: ``"fq"`` emulates the
int8 arithmetic in f32 (``conv2d_fakequant``), ``"fq8"`` runs it on the
int8 kernel K4 with straight-through gradients (``conv2d_fakequant_int8``).
"""

from __future__ import annotations

import contextlib
import math
import warnings
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from livespeechportraits_torch.ops import q8conv_cuda
from livespeechportraits_torch.parallel import mesh

Tensor = torch.Tensor


def dense(x: Tensor, layer: nn.Linear) -> Tensor:
    """x @ W^T + b over the last axis."""
    return F.linear(x, layer.weight, layer.bias)


# Rows of one GEMM in linear_row_blocks
ROW_BLOCK = 64


def linear_row_blocks(x: Tensor, weight: Tensor, bias: Optional[Tensor]) -> Tensor:
    """F.linear over the rows of x [..., K], ROW_BLOCK rows a GEMM (the last
    block zero-padded).  Every GEMM has one shape, so BLAS runs one kernel
    whatever the row count, and row i does not depend on how many rows
    follow it: the inference GEMMs of a bucket-padded request give its
    first rows bit for bit as the unpadded request's (one GEMM over all the
    rows lets BLAS pick its summation order by the row count)."""
    rows = x.reshape(-1, x.shape[-1])
    n = rows.shape[0]
    pad = -n % ROW_BLOCK
    if pad:
        rows = torch.cat([rows, rows.new_zeros(pad, rows.shape[1])])
    out = torch.cat([F.linear(b, weight, bias) for b in rows.split(ROW_BLOCK)])
    return out[:n].reshape(*x.shape[:-1], -1)


def conv1d(x: Tensor, layer: nn.Conv1d, dilation: int = 1,
           padding: Union[int, Tuple[int, int]] = 0) -> Tensor:
    """x: [N, C, W]; padding is symmetric, or (left, right) for causal
    convolutions."""
    if isinstance(padding, int):
        padding = (padding, padding)
    if padding != (0, 0):
        x = F.pad(x, padding)
    return F.conv1d(x, layer.weight, layer.bias, dilation=dilation)


def conv2d(x: Tensor, layer: Union[nn.Conv2d, "QConv2d"], stride: int = 1,
           padding: int = 0) -> Tensor:
    """x: [N, C, H, W] -> [N, C', H', W']; symmetric integer zero padding.
    A QConv2d layer runs the int8 convolution (conv2d_q8); a QATConv2d the
    int8 kernel with straight-through gradients ("fq8") or its f32
    emulation ("fq")."""
    if isinstance(layer, QConv2d):
        return conv2d_q8(x, layer, stride, padding)
    if isinstance(layer, QATConv2d):
        if layer.mode == "fq8":
            return conv2d_fakequant_int8(x, layer, stride, padding)
        return conv2d_fakequant(x, layer, stride, padding)
    return F.conv2d(x, layer.weight, layer.bias, stride=stride, padding=padding)


# ---------------------------------------------------------------------------
# int8 convolution (nn_core.quantize_weight_int8 / quantize_conv /
# _quantize_activation / _conv2d_q8 of the JAX package)
# ---------------------------------------------------------------------------


def quantize_weight_int8(w: Tensor, dims: Tuple[int, ...] = (1, 2, 3)) -> Tuple[Tensor, Tensor]:
    """Symmetric int8 weights with one scale per index of the dims not
    reduced: (w_q int8 in [-127, 127], scale) with scale = amax over ``dims``
    / 127, floored at 1e-12 / 127, in JAX's operation order, squeezed over
    ``dims`` (JAX's ``axes``).  The default reduces a conv weight [O, I, kh,
    kw] to one scale an output channel; the rewrites below quantize in JAX's
    layouts with JAX's axes.  Every int8 form quantizes through this one
    expression, so their weights equal JAX's bit for bit."""
    w = w.detach().float()
    s_k = torch.clamp(w.abs().amax(dim=dims, keepdim=True), min=1e-12) / 127.0
    w_q = torch.clamp(torch.round(w / s_k), -127, 127).to(torch.int8)
    return w_q, s_k.squeeze(dims)


class QConv2d(nn.Module):
    """A 3x3 conv with int8 weights and per-tensor int8 activations.

    Buffers: ``w_q`` [O, I, 3, 3] int8, ``w_scale`` [O], and optionally
    ``b`` [O] (after BN folding) and ``x_scale`` [] (after calibration; the
    activation scale is dynamic without it).  The float buffers follow the
    module's dtype like any float leaf; ``w_q`` stays int8."""

    def __init__(self, w_q: Tensor, w_scale: Tensor, stride: int, padding: int,
                 b: Optional[Tensor] = None, x_scale: Optional[Tensor] = None):
        super().__init__()
        self.stride, self.padding = (stride, stride), (padding, padding)  # as nn.Conv2d
        self.register_buffer("w_q", w_q)
        self.register_buffer("w_scale", w_scale)
        self.register_buffer("b", b)
        self.register_buffer("x_scale", x_scale)
        # the list calibration appends this conv's input amax to (see
        # recording_amax); None outside calibration
        self.amax_record: Optional[list] = None
        # (dtype, x_scale, w_scale, their versions, r, scale) of the last
        # static_operands call
        self._static: Optional[tuple] = None

    @classmethod
    def from_conv(cls, conv: nn.Conv2d) -> "QConv2d":
        """The int8 layer of a float conv; a static activation scale the
        conv carries (``x_scale``, calibrated on a QAT-tagged tree) rides
        along, as JAX's quantize_conv carries it."""
        w_q, scale = quantize_weight_int8(conv.weight)
        b = None if conv.bias is None else conv.bias.detach().float().clone()
        x_scale = getattr(conv, "x_scale", None)
        if x_scale is not None:
            x_scale = x_scale.detach().float().clone()
        return cls(w_q, scale, conv.stride[0], conv.padding[0], b=b, x_scale=x_scale)

    def static_operands(self, dt: torch.dtype) -> Tuple[Tensor, Tensor]:
        """rescale_operands of the calibrated x_scale for activations of
        dtype dt, kept until x_scale or w_scale is replaced (a cast or a
        move) or changed in place, so a calibrated conv launches no kernel
        but K4."""
        return static_operands(self, self.w_scale, dt)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # the optional buffers exist when the state dict carries them
        for name in ("b", "x_scale"):
            if getattr(self, name) is None and prefix + name in state_dict:
                setattr(self, name, torch.empty_like(state_dict[prefix + name]))
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


@contextlib.contextmanager
def recording_amax(module: nn.Module):
    """Calibration: within the block every QConv2d, QATConv2d and int8
    rewritten layer of ``module`` appends its input's |x| max (f32) to the
    yielded list, in call order (a split up conv one joint amax of its two
    inputs), and quantizes with that amax (an "fq8" conv through the f32
    emulation, as JAX's does)."""
    record: list = []
    convs = [m for m in module.modules() if isinstance(m, (QConv2d, QATConv2d))
             or isinstance(m, REWRITES) and m.quantized]
    for c in convs:
        c.amax_record = record
    try:
        yield record
    finally:
        for c in convs:
            c.amax_record = None


def activation_scale(layer: nn.Module, x: Tensor, *more: Tensor) -> Tensor:
    """s_x, the per-tensor activation scale (f32 scalar) of an int8 or a
    QAT-tagged conv: the recorded amax / 127 during calibration, the
    calibrated x_scale (cast to x's dtype first, as the deployed model's
    buffers are), or the dynamic amax / 127 (JAX's _quantize_activation).
    The amax is the joint one of x and ``more`` (a split conv's two
    halves, one scale and one record for both), and in a process group the
    max over every rank that holds a part of the conv's input
    (mesh.split_groups: the data group, and the model group under a spatial
    forward), as JAX's jnp.max over the global array: one all-reduce of a
    scalar.  The calibrated x_scale takes none.  Computed without
    gradient."""
    if layer.amax_record is None and layer.x_scale is not None:
        return layer.x_scale.detach().to(x.dtype).float()
    amax = x.detach().abs().amax()
    for t in more:
        amax = torch.maximum(amax, t.detach().abs().amax())
    amax = mesh.all_reduce_max_(amax.float())
    if layer.amax_record is not None:
        layer.amax_record.append(amax)
    return torch.clamp(amax, min=1e-12) / 127.0


def rescale_operands(w_scale: Tensor, s_x: Tensor, dt: torch.dtype) -> Tuple[Tensor, Tensor]:
    """(r, scale) = (reciprocal(s_x).to(dt), (w_scale * s_x).to(dt)), the
    quantize and rescale factors in JAX's cast order."""
    return torch.reciprocal(s_x).to(dt), (w_scale.float() * s_x).to(dt)


def static_operands(layer: nn.Module, w_scale: Tensor, dt: torch.dtype) -> Tuple[Tensor, Tensor]:
    """rescale_operands of an int8 layer's calibrated x_scale and its weight
    scale w_scale, kept on the layer (``_static``) until either is replaced
    or changed in place."""
    versions = (layer.x_scale._version, w_scale._version)
    c = layer._static
    if (c is None or c[0] != dt or c[1] is not layer.x_scale or c[2] is not w_scale
            or c[3] != versions):
        r, scale = rescale_operands(w_scale, layer.x_scale.float(), dt)
        c = layer._static = (dt, layer.x_scale, w_scale, versions, r, scale)
    return c[4], c[5]


def int8_operands(layer: nn.Module, w_scale: Tensor, x: Tensor,
                  *more: Tensor) -> Tuple[Tensor, Tensor]:
    """(r, scale) of an int8 layer for the activation x (and ``more``, read
    with x's one scale): those of the calibrated x_scale, kept
    (static_operands), or of this call's activation scale (activation_scale:
    the dynamic amax, or the amax recorded during calibration)."""
    if layer.amax_record is None and layer.x_scale is not None:
        return static_operands(layer, w_scale, x.dtype)
    return rescale_operands(w_scale, activation_scale(layer, x, *more), x.dtype)


def conv2d_q8(x: Tensor, layer: QConv2d, stride: int, padding: int) -> Tensor:
    """y = conv_s8(clamp(round(x * r), -127, 127), w_q).to(dt) * scale + b
    with (r, scale) from rescale_operands: one launch of kernel K4 on the
    card (ops/q8conv_cuda.conv_q8), the int32 sums exact.  A calibrated
    layer's (r, scale) are computed once (QConv2d.static_operands)."""
    r, scale = int8_operands(layer, layer.w_scale, x)
    # a no-op for the renderer's activations; a 1-pixel-wide map may lose the format
    x = x.contiguous(memory_format=torch.channels_last)
    return q8conv_cuda.conv_q8(x, r, layer.w_q, stride, padding, scale, layer.b)


# ---------------------------------------------------------------------------
# Quantization-aware training (nn_core.fake_quant_conv / _round_ste /
# _conv2d_fakequant / _q8_ste / _conv2d_fakequant_int8 of the JAX package)
# ---------------------------------------------------------------------------

QAT_MODES = ("fq", "fq8")


class QATConv2d(nn.Conv2d):
    """A float conv tagged for quantization-aware training.

    ``mode`` "fq": the forward emulates the deployed int8 layer in f32
    (conv2d_fakequant); "fq8": it runs the deployed arithmetic itself on
    K4, with the emulation's straight-through gradients (conv2d_fakequant_int8).
    The parameters stay ``weight`` and ``bias`` (f32 masters, trainable),
    with an optional ``x_scale`` buffer (a static activation scale baked by
    calibrate_generator), so state dicts and optimizer state keep the float
    conv's keys; the tag itself is not state (a checkpoint names it,
    utils/checkpoint's ``qat_mode``)."""

    def __init__(self, *args, mode: str = "fq", **kwargs):
        super().__init__(*args, **kwargs)
        if mode not in QAT_MODES:
            raise ValueError(f"QAT mode must be one of {QAT_MODES}, got {mode!r}")
        self.mode = mode
        self.register_buffer("x_scale", None)
        self.amax_record: Optional[list] = None  # see recording_amax

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        if self.x_scale is None and prefix + "x_scale" in state_dict:
            self.x_scale = torch.empty_like(state_dict[prefix + "x_scale"])
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


def _shared_conv(cls, conv: nn.Conv2d, **kw) -> nn.Conv2d:
    """A ``cls`` conv of conv's geometry holding conv's own Parameters (and
    its x_scale, when it has one): no new weights are allocated.  A
    channel-sharded conv's grid (``tp_grid``, parallel.sharding) rides
    along."""
    out = cls(conv.in_channels, conv.out_channels, conv.kernel_size, stride=conv.stride,
              padding=conv.padding, dilation=conv.dilation, groups=conv.groups,
              bias=conv.bias is not None, device="meta", **kw)
    if getattr(conv, "tp_grid", None) is not None:
        out.tp_grid = conv.tp_grid
    out.weight = conv.weight
    if conv.bias is not None:
        out.bias = conv.bias
    x_scale = getattr(conv, "x_scale", None)
    if x_scale is not None:
        if isinstance(out, QATConv2d):
            out.x_scale = x_scale
        else:
            out.register_buffer("x_scale", x_scale)
    return out


def fake_quant_conv(conv: nn.Conv2d, int8_forward: bool = False) -> QATConv2d:
    """Tag a float conv for quantization-aware training: a QATConv2d of mode
    "fq8" (int8_forward) or "fq" sharing conv's parameters.  Refuses an
    int8 layer and a conv that already carries a tag (a double tag would
    make the dispatch and qat_tag_mode disagree)."""
    if isinstance(conv, QConv2d):
        raise ValueError("fake_quant_conv expects a float conv (got int8)")
    if isinstance(conv, QATConv2d):
        raise ValueError("conv already carries a QAT tag; strip it first (a double tag "
                         "would make the dispatch and qat_tag_mode disagree)")
    return _shared_conv(QATConv2d, conv, mode="fq8" if int8_forward else "fq")


def strip_qat_conv(conv: QATConv2d) -> nn.Conv2d:
    """The plain float conv of a tagged one, sharing its parameters; a baked
    ``x_scale`` stays as a buffer (QConv2d.from_conv carries it)."""
    return _shared_conv(nn.Conv2d, conv)


def _round_ste(v: Tensor) -> Tensor:
    """round() that is the identity to the gradient (straight-through)."""
    return v + (torch.round(v) - v).detach()


def _clip127(v: Tensor) -> Tensor:
    """clip(v, -127, 127) as JAX's jnp.clip computes it, min of max: at a
    value exactly on the grid's edge the gradient splits in half, as it
    does there (torch.clamp would pass it whole)."""
    lim = v.new_tensor(127.0)
    return torch.minimum(torch.maximum(v, -lim), lim)


def conv2d_fakequant(x: Tensor, layer: QATConv2d, stride: int, padding: int) -> Tensor:
    """The "fq" forward: y = conv(fq(x), fq(w)) + b in f32 (in float64 for a
    float64 x: the precision checks of the sharded steps, where a code tips
    only within ~1e-15 of a rounding boundary), fq snapping to the int8 grid
    at the deployment scales (weights: per-output-channel amax / 127 of the
    master weights; activations: the calibrated x_scale, else the dynamic
    amax / 127), the scales stop-gradiented and the rounding
    straight-through.  Autocast is off inside (under the trainer's bf16
    autocast a bare conv would run in bf16); the result takes x's dtype.
    On the card cuDNN runs this f32 conv, and its gradients, in TF32 while
    torch.backends.cudnn.allow_tf32 is on (PyTorch's default), as it runs
    the float discriminator's.  Calibration records the activation amax
    here, for "fq8" convs too."""
    dt = x.dtype if x.is_floating_point() else torch.float32
    cdt = torch.float64 if dt == torch.float64 else torch.float32
    with torch.autocast(x.device.type, enabled=False):
        w = layer.weight.to(cdt)
        s_w = (torch.clamp(w.abs().amax(dim=(1, 2, 3), keepdim=True), min=1e-12)
               / 127.0).detach()
        w_fq = _clip127(_round_ste(w / s_w)) * s_w
        xf = x.to(cdt)
        s_x = activation_scale(layer, xf)
        x_fq = _clip127(_round_ste(xf / s_x)) * s_x
        y = F.conv2d(x_fq, w_fq, stride=stride, padding=padding)
        if layer.bias is not None:
            y = y + layer.bias.to(cdt).view(1, -1, 1, 1)
    return y.to(dt)


class _Q8STE(torch.autograd.Function):
    """The deployed int8 conv forward (one K4 launch on the card) with the
    float emulation's straight-through gradients: JAX's _q8_ste custom_vjp.

    Forward, in x's dtype dt: (w_q, s_w) from the f32 master weights,
    r = reciprocal(s_x).to(dt), scale = (s_w.to(dt).float() * s_x).to(dt),
    y = conv_q8(x, r, w_q, scale, b.to(dt)): the deployed QConv2d's operands,
    so the output equals its output bit for bit.  Backward: rebuild u =
    round(x * r) in dt from the saved x and r, then the f32 gradients of
    conv(clip(u) * s_x, w_q * s_w) with respect to x (masked where |u| >
    127: the clip passes no gradient there) and w, the bias's, and none for
    s_x.  Autocast is off inside both: it must neither recast K4's operands
    nor run the backward's convolutions in bf16 (they run in TF32 on the
    card while torch.backends.cudnn.allow_tf32 is on, as conv2d_fakequant's
    do)."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, x, w, s_x, bias, stride: int, padding: int):
        dt = x.dtype
        with torch.autocast(x.device.type, enabled=False):
            w_q, s_w = quantize_weight_int8(w)
            w_q = w_q.contiguous(memory_format=torch.channels_last)
            r = torch.reciprocal(s_x).to(dt)
            scale = (s_w.to(dt).float() * s_x).to(dt)
            b = None if bias is None else bias.detach().to(dt)
            y = q8conv_cuda.conv_q8(x.contiguous(memory_format=torch.channels_last), r, w_q,
                                    stride, padding, scale, b)
        ctx.save_for_backward(x, r, w_q, s_w, s_x)
        ctx.conf = (stride, padding, w.shape, w.dtype, bias is not None)
        return y

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, g):
        x, r, w_q, s_w, s_x = ctx.saved_tensors
        stride, padding, w_shape, w_dtype, has_bias = ctx.conf
        gx = gw = gb = None
        with torch.autocast(x.device.type, enabled=False):
            g = g.float()
            u = torch.round(x * r)
            if ctx.needs_input_grad[0]:
                w_fq = w_q.float() * s_w.view(-1, 1, 1, 1)
                gx = torch.nn.grad.conv2d_input(x.shape, w_fq, g, stride, padding)
                gx = (gx * (u.abs() <= 127)).to(x.dtype)
            if ctx.needs_input_grad[1]:
                x_fq = torch.clamp(u, -127, 127).float() * s_x
                gw = torch.nn.grad.conv2d_weight(x_fq, w_shape, g, stride, padding).to(w_dtype)
            if has_bias and ctx.needs_input_grad[3]:
                gb = g.sum(dim=(0, 2, 3))
        return gx, gw, None, gb, None, None


def conv2d_fakequant_int8(x: Tensor, layer: QATConv2d, stride: int, padding: int) -> Tensor:
    """The "fq8" forward: the deployed int8 conv (K4 on the card, its plain
    twin on the CPU) with straight-through gradients (_Q8STE).  The
    activation scale is chosen as the deployed layer chooses it, in x's
    dtype: the calibrated x_scale cast to dt, else the dynamic amax / 127.
    During calibration the f32 emulation computes the layer and records its
    amax (JAX's own rule)."""
    if layer.amax_record is not None:
        return conv2d_fakequant(x, layer, stride, padding)
    if not x.is_floating_point():
        x = x.float()
    return _Q8STE.apply(x, layer.weight, activation_scale(layer, x), layer.bias, stride,
                        padding)


# ---------------------------------------------------------------------------
# The renderer's inference rewrites (nn_core.py:471-800 of the JAX package:
# subpixel_from_conv3x3 / upconv_subpixel, subpixel1_from_conv3x3 /
# upconv_subpixel1, dilated_from_conv3x3 / upconv_dilated,
# split_from_concat_conv / upconv_split, s2d_from_conv3x3s2 / conv_s2d_down).
# Each rewrite builds its weights in JAX's layout with JAX's expressions, in
# JAX's summation order (w0 + w1, then + w2 ...), so the int8 weights equal
# JAX's bit for bit, and stores them in torch's layouts.  A float layer runs
# through cuDNN, an int8 one through K4 (ops/q8conv_cuda).
# ---------------------------------------------------------------------------


class UpConv(nn.Module):
    """A conv rewritten for inference: its weights (``FLOAT`` names for a
    float layer; ``INT8`` for an int8 one, the int8 weights first and their
    scale last, empty for a float-only form), an optional bias ``b`` [Co] and calibrated ``x_scale`` [],
    as buffers.  ``shape`` is (k, cin, cout, stride, padding) of the conv it
    replaced (utils/flops counts that conv's work)."""

    FLOAT: Tuple[str, ...] = ()
    INT8: Tuple[str, ...] = ()

    def __init__(self, weights: dict, shape: Tuple[int, int, int, int, int],
                 b: Optional[Tensor] = None, x_scale: Optional[Tensor] = None):
        super().__init__()
        for name, t in weights.items():
            self.register_buffer(name, t)
        self.register_buffer("b", b)
        self.register_buffer("x_scale", x_scale)
        self.shape = tuple(shape)
        self.amax_record: Optional[list] = None  # see recording_amax
        self._static: Optional[tuple] = None  # see static_operands

    @property
    def quantized(self) -> bool:
        return bool(self.INT8) and self.INT8[0] in self._buffers

    @classmethod
    def rewrites(cls, sd, prefix: str) -> bool:
        """Whether state dict entry ``prefix`` holds a layer of this class."""
        return any(f"{prefix}.{names[0]}" in sd for names in (cls.FLOAT, cls.INT8) if names)

    @classmethod
    def shaped_like(cls, sd, prefix: str, shape) -> "UpConv":
        """An empty layer of the state dict's shapes (load_state_dict fills it)."""
        names = cls.INT8 if cls.INT8 and f"{prefix}.{cls.INT8[0]}" in sd else cls.FLOAT
        return cls({n: torch.empty_like(sd[f"{prefix}.{n}"]) for n in names}, shape)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        for name in ("b", "x_scale"):
            if getattr(self, name) is None and prefix + name in state_dict:
                setattr(self, name, torch.empty_like(state_dict[prefix + name]))
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def _bias(self, y: Tensor) -> Tensor:
        return y if self.b is None else y + self.b.view(1, -1, 1, 1)


def _rewrite_source(conv: nn.Module) -> Tuple[Tensor, dict]:
    """The f32 weight of a float or int8 3x3 conv in JAX's HWIO layout (an
    int8 one dequantized as JAX does, w_q * w_scale), and what the rewritten
    layer carries over: its bias, an int8 layer's x_scale, the float dtype
    and the replaced conv's shape."""
    if isinstance(conv, QConv2d):
        w = conv.w_q.float() * conv.w_scale.float().view(-1, 1, 1, 1)
        dt, b, x_scale = conv.w_scale.dtype, conv.b, conv.x_scale
    else:
        w = conv.weight.detach().float()
        dt, b, x_scale = conv.weight.dtype, conv.bias, None
    carry = {"dt": dt, "int8": isinstance(conv, QConv2d),
             "b": None if b is None else b.detach().clone().to(dt),
             "x_scale": None if x_scale is None else x_scale.detach().clone(),
             "shape": (conv.w_q.shape[2] if isinstance(conv, QConv2d) else conv.kernel_size[0],
                       w.shape[1], w.shape[0], conv.stride[0], conv.padding[0])}
    return w.permute(2, 3, 1, 0), carry


def _to_torch_layout(w: Tensor) -> Tensor:
    """HWIO -> OIHW, contiguous in channels_last memory (OHWI: K4's layout)."""
    return w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)


def _rewritten(cls, w: Tensor, carry: dict, dims: Tuple[int, ...], layout) -> UpConv:
    """The layer of class cls holding w (JAX layout, f32): quantized over
    dims (JAX's axes) when the source was int8, else in the source's dtype;
    layout maps the JAX-layout weight to torch's."""
    if carry["int8"]:
        w_q, s = quantize_weight_int8(w, dims)
        weights = {cls.INT8[0]: layout(w_q), cls.INT8[-1]: s.to(carry["dt"])}
    else:
        weights = {cls.FLOAT[0]: layout(w).to(carry["dt"])}
    return cls(weights, carry["shape"], b=carry["b"], x_scale=carry["x_scale"])


def _phase_layout(w: Tensor) -> Tensor:
    """[4, 2, 2, Ci, Co] (phase, JAX HWIO) -> [4 * Co, Ci, 2, 2], phase-major
    over the output channels, channels_last: each phase's [Co, Ci, 2, 2]
    slice is a K4 weight."""
    p, kh, kw, ci, co = w.shape
    return w.permute(0, 4, 3, 1, 2).reshape(p * co, ci, kh, kw).contiguous(
        memory_format=torch.channels_last)


class UpConvSubpixel(UpConv):
    """Four 2x2 phase convs at the coarse resolution (JAX upconv_subpixel):
    ``w_ph`` / ``w_ph_q`` [4 * Co, Ci, 2, 2] (phase a * 2 + b major),
    ``w_ph_scale`` [4, Co].  [B, Ci, h, w] -> [B, Co, 2h, 2w], the map of the
    3x3 conv on the nearest-2x-upsampled input.  int8: four K4 launches
    writing the interleaved map."""

    FLOAT, INT8 = ("w_ph",), ("w_ph_q", "w_ph_scale")

    def forward(self, x: Tensor) -> Tensor:
        if self.quantized:
            r, scale = int8_operands(self, self.w_ph_scale, x)
            x = x.contiguous(memory_format=torch.channels_last)
            return q8conv_cuda.subpixel_q8(x, self.w_ph_q, r, scale, self.b)
        # one conv of all four phases' kernels with padding 1, each phase's
        # outputs offset by its (a, b): phase (a, b) reads coarse rows i - 1 + a, i + a
        co, (h, w) = self.w_ph.shape[0] // 4, x.shape[2:]
        y = F.conv2d(x, self.w_ph, padding=1)
        return self._bias(q8conv_cuda.interleave(
            [y[:, p * co:(p + 1) * co, a:a + h, b:b + w]
             for p, (a, b) in enumerate(q8conv_cuda.PHASES)]))


class UpConvSubpixel1(UpConv):
    """One 3x3 conv with 4 * Co outputs at the coarse resolution, the
    uncovered taps zero (JAX upconv_subpixel1): ``w_sp1`` / ``w_sp1_q`` [4 *
    Co, Ci, 3, 3] (phase-major outputs), ``w_sp1_scale`` [4 * Co]; then the
    phases interleaved and the Co bias added (one pass).  int8: one K4
    launch."""

    FLOAT, INT8 = ("w_sp1",), ("w_sp1_q", "w_sp1_scale")

    def forward(self, x: Tensor) -> Tensor:
        if self.quantized:
            r, scale = int8_operands(self, self.w_sp1_scale, x)
            y = q8conv_cuda.conv_q8(x.contiguous(memory_format=torch.channels_last), r,
                                    self.w_sp1_q, 1, 1, scale)
        else:
            y = F.conv2d(x, self.w_sp1, padding=1)
        return q8conv_cuda.shuffle_phases(y, self.b)


class UpConvDilated(UpConv):
    """One 4x4 conv over the input dilated by 2 with padding 2 (JAX
    upconv_dilated): ``w_dl`` / ``w_dl_q`` [Co, Ci, 4, 4], ``w_dl_scale``
    [Co].  Float: cuDNN's transposed conv (stride 2, padding 1) with the
    kernel flipped and its in and out axes swapped, the same map; int8: one
    K4 launch reading the dilated input through its row map."""

    FLOAT, INT8 = ("w_dl",), ("w_dl_q", "w_dl_scale")

    def forward(self, x: Tensor) -> Tensor:
        if self.quantized:
            r, scale = int8_operands(self, self.w_dl_scale, x)
            x = x.contiguous(memory_format=torch.channels_last)
            return q8conv_cuda.dilated_q8(x, self.w_dl_q, r, scale, self.b)
        w_t = self.w_dl.flip(2, 3).transpose(0, 1)
        return self._bias(F.conv_transpose2d(x, w_t, stride=2, padding=1))


class UpConvSplit(UpConv):
    """The concat-free up conv over the U-Net's (skip, submodule) pair (JAX
    upconv_split): ``w_a`` / ``w_a_q`` [Co, n_a, 3, 3] for the skip's
    channels, ``w_b`` / ``w_b_q`` for the rest, ``w_scale`` [Co].
    forward(a, b) is the 3x3 conv of the nearest-2x-upsampled cat(a, b).
    Float: two cuDNN convs summed; int8: one activation scale for both
    halves (the joint amax, or x_scale), one K4 launch whose int32 sums cover
    both sources, so the result equals the unsplit int8 conv's bit for
    bit."""

    FLOAT, INT8 = ("w_a", "w_b"), ("w_a_q", "w_b_q", "w_scale")

    def weight_q(self) -> Tensor:
        """cat(w_a_q, w_b_q) over the input channels, channels_last (K4's
        one weight), kept until either half is replaced or changed."""
        a, b = self.w_a_q, self.w_b_q
        c = getattr(self, "_wcat", None)
        if c is None or c[0] is not a or c[1] is not b or c[2] != (a._version, b._version):
            w = torch.cat([a, b], 1).contiguous(memory_format=torch.channels_last)
            c = self._wcat = (a, b, (a._version, b._version), w)
        return c[3]

    def forward(self, a: Tensor, b: Tensor) -> Tensor:
        if not self.quantized:
            up = upsample_nearest_2x
            return self._bias(F.conv2d(up(a), self.w_a, padding=1)
                              + F.conv2d(up(b), self.w_b, padding=1))
        r, scale = int8_operands(self, self.w_scale, a, b)
        cl = torch.channels_last
        return q8conv_cuda.split_q8(a.contiguous(memory_format=cl),
                                    b.contiguous(memory_format=cl), self.weight_q(), r, scale,
                                    self.b)


class ConvS2DDown(UpConv):
    """The stride-2 3x3 input conv as a 2x2 stride-1 conv over the
    space-to-depth(2) packed input (JAX conv_s2d_down): ``w_s2d`` [Co, 4 *
    Ci, 2, 2] (input channels phase-major, the uncovered phase slots zero).
    [B, Ci, H, W] -> [B, Co, H/2, W/2].  Float only, through cuDNN (the
    outermost down conv stays float)."""

    FLOAT = ("w_s2d",)

    def forward(self, x: Tensor) -> Tensor:
        B, C, H, W = x.shape
        xp = x.reshape(B, C, H // 2, 2, W // 2, 2).permute(0, 3, 5, 1, 2, 4)
        xp = xp.reshape(B, 4 * C, H // 2, W // 2).contiguous(memory_format=torch.channels_last)
        return self._bias(F.conv2d(F.pad(xp, (1, 0, 1, 0)), self.w_s2d))


REWRITES = (UpConvSubpixel, UpConvSubpixel1, UpConvDilated, UpConvSplit, ConvS2DDown)


def subpixel_from_conv3x3(conv: nn.Module) -> UpConvSubpixel:
    """A float or int8 3x3 up conv (consuming a nearest-2x-upsampled map)
    rewritten into its four 2x2 phase convs at the coarse resolution: phase
    (a, b) covers coarse rows [i - 1, i] (a = 0; taps w0, w1 + w2) or [i,
    i + 1] (a = 1; w0 + w1, w2), the same per column.  An int8 layer is
    dequantized, rewritten and requantized per (phase, out channel), its
    x_scale kept (the input is the same coarse map)."""
    w, carry = _rewrite_source(conv)
    rows = [torch.stack([w[0], w[1] + w[2]]),  # a=0: coarse [i-1, i]
            torch.stack([w[0] + w[1], w[2]])]  # a=1: coarse [i, i+1]
    phases = []
    for a in range(2):
        r = rows[a]  # [2, 3, Ci, Co]
        phases.append(torch.stack([r[:, 0], r[:, 1] + r[:, 2]], dim=1))  # b=0
        phases.append(torch.stack([r[:, 0] + r[:, 1], r[:, 2]], dim=1))  # b=1
    return _rewritten(UpConvSubpixel, torch.stack(phases), carry, (1, 2, 3), _phase_layout)


def subpixel1_from_conv3x3(conv: nn.Module) -> UpConvSubpixel1:
    """The single-conv form: one 3x3 conv with 4 * Co outputs (phase-major),
    each phase's two coarse taps a dimension placed in a 3-tap kernel whose
    uncovered tap is zero; int8 requantized per output channel."""
    w, carry = _rewrite_source(conv)
    z = torch.zeros_like(w[0])
    rows = [torch.stack([w[0], w[1] + w[2], z]),  # a=0: taps {-1, 0}
            torch.stack([z, w[0] + w[1], w[2]])]  # a=1: taps {0, +1}
    phases = []
    for a in range(2):
        r = rows[a]  # [3, 3, Ci, Co]
        zc = torch.zeros_like(r[:, 0])
        phases.append(torch.stack([r[:, 0], r[:, 1] + r[:, 2], zc], dim=1))
        phases.append(torch.stack([zc, r[:, 0] + r[:, 1], r[:, 2]], dim=1))
    w4 = torch.stack(phases, dim=-1)  # [3, 3, Ci, Co, 4]
    kh, kw, ci, co, _ = w4.shape
    w4 = w4.permute(0, 1, 2, 4, 3).reshape(kh, kw, ci, 4 * co)
    return _rewritten(UpConvSubpixel1, w4, carry, (0, 1, 2), _to_torch_layout)


def dilated_from_conv3x3(conv: nn.Module) -> UpConvDilated:
    """The four phase kernels packed into one 4x4 kernel applied to the input
    dilated by 2 with padding 2: even kernel rows serve phase a = 0 (w0,
    then w1 + w2), odd ones a = 1 (w0 + w1, then w2), the same per column."""
    w, carry = _rewrite_source(conv)
    k0 = [w[0], w[1] + w[2]]  # a=0: coarse rows {i-1, i}
    k1 = [w[0] + w[1], w[2]]  # a=1: coarse rows {i, i+1}

    def tap(u):
        return k0[u // 2] if u % 2 == 0 else k1[(u - 1) // 2]

    rows = []
    for u in range(4):
        r = tap(u)  # [3, Ci, Co]
        c0 = [r[0], r[1] + r[2]]
        c1 = [r[0] + r[1], r[2]]
        rows.append(torch.stack([c0[v // 2] if v % 2 == 0 else c1[(v - 1) // 2]
                                 for v in range(4)]))
    return _rewritten(UpConvDilated, torch.stack(rows), carry, (0, 1, 2), _to_torch_layout)


def split_from_concat_conv(conv: nn.Module, n_a: int) -> UpConvSplit:
    """A conv on cat(a, b) (a the first n_a channels) as the concat-free
    pair: the kernel sliced over its input channels; int8 weights and
    w_scale as they are (one scale per output channel, shared x_scale)."""
    if isinstance(conv, QConv2d):
        w = conv.w_q
        weights = {"w_a_q": w[:, :n_a].contiguous(memory_format=torch.channels_last),
                   "w_b_q": w[:, n_a:].contiguous(memory_format=torch.channels_last),
                   "w_scale": conv.w_scale.detach().clone()}
        b, x_scale = conv.b, conv.x_scale
    else:
        w = conv.weight.detach()
        weights = {"w_a": w[:, :n_a].contiguous(memory_format=torch.channels_last),
                   "w_b": w[:, n_a:].contiguous(memory_format=torch.channels_last)}
        b, x_scale = conv.bias, None
    shape = (w.shape[2], w.shape[1], w.shape[0], conv.stride[0], conv.padding[0])
    return UpConvSplit(weights, shape, b=None if b is None else b.detach().clone(),
                       x_scale=None if x_scale is None else x_scale.detach().clone())


def s2d_from_conv3x3s2(conv: nn.Conv2d) -> ConvS2DDown:
    """A float [Co, Ci, 3, 3] stride-2 conv as a 2x2 stride-1 conv over the
    space-to-depth(2) input: coarse tap s and phase a cover fine kernel row
    u by row_map {(0, 1): 0, (1, 0): 1, (1, 1): 2}, the same per column;
    the other phase slots stay zero."""
    if not isinstance(conv, nn.Conv2d) or isinstance(conv, QATConv2d):
        raise ValueError(f"s2d_from_conv3x3s2 takes a float conv, got {type(conv).__name__}")
    w, carry = _rewrite_source(conv)  # [3, 3, Ci, Co]
    ci, co = w.shape[2], w.shape[3]
    w2 = w.new_zeros(2, 2, 4, ci, co)
    row_map = {(0, 1): 0, (1, 0): 1, (1, 1): 2}
    for (s, a), u in row_map.items():
        for (t, b), v in row_map.items():
            w2[s, t, a * 2 + b] = w[u, v]
    w_s2d = _to_torch_layout(w2.reshape(2, 2, 4 * ci, co)).to(carry["dt"])
    return ConvS2DDown({"w_s2d": w_s2d}, carry["shape"], b=carry["b"])


def batchnorm(x: Tensor, bn: nn.modules.batchnorm._BatchNorm, eps: float = 1e-5,
              training: bool = False, update_stats: bool = True) -> Tensor:
    """BatchNorm over channel axis 1.

    Eval mode (the default) uses the running stats: (x - mean) * rsqrt(var +
    eps) * scale + bias, in x's dtype.  Training mode normalises with the
    batch's own statistics over every axis but the channel axis (two passes:
    the mean, then the biased variance about it) and, with update_stats,
    moves the running stats as torch does: momentum 0.1, the biased batch
    mean and the unbiased batch variance (JAX's nn_core.batchnorm with
    BN_ONEPASS off; the one-pass variance, clamped at 0, is not copied).
    update_stats=False leaves them as they are (the discriminator's second
    forward of a step, whose statistics JAX discards, and a rematerialised
    forward's recompute): the update lands on copies, so the operator and
    the tensors it saves for the backward are those of update_stats=True,
    as torch.utils.checkpoint's recompute requires.

    When the batch is split over more than one rank (mesh.data_size: the
    active grid's data axis, else the world) the training statistics are the
    global batch's (_global_batchnorm), as JAX's data-parallel step is the
    one-device program on the global batch; one rank runs F.batch_norm.  The
    model ranks of a grid hold other channels of the same rows, so they take
    no part in the statistics."""
    if training:
        mean, var = bn.running_mean, bn.running_var
        if not update_stats:
            mean, var = mean.clone(), var.clone()
        if mesh.data_size() > 1:
            return _global_batchnorm(x, bn, mean, var, eps)
        return F.batch_norm(x, mean, var, bn.weight, bn.bias, training=True, momentum=0.1,
                            eps=eps)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    mean = bn.running_mean.to(x.dtype).view(shape)
    var = bn.running_var.to(x.dtype).view(shape)
    scale = bn.weight.to(x.dtype).view(shape)
    bias = bn.bias.to(x.dtype).view(shape)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def _global_batchnorm(x: Tensor, bn: nn.modules.batchnorm._BatchNorm, running_mean: Tensor,
                      running_var: Tensor, eps: float, momentum: float = 0.1) -> Tensor:
    """Training BatchNorm on the statistics of every data rank's rows, in f32
    (or x's dtype, if wider) and in F.batch_norm's two-pass order: the global
    mean (an all-reduce of the sums over the data group), then the biased
    variance about it (an all-reduce of the squared deviations).  Both
    all-reduces are differentiable (mesh.all_reduce_sum), so each rank's
    gradient carries the other ranks' terms.  The running variance is
    unbiased over the global count (the ranks' slices are equal:
    multihost.local_batch_slice)."""
    dims = [0] + list(range(2, x.dim()))
    shape = (1, -1) + (1,) * (x.dim() - 2)
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    n = xf.numel() // xf.shape[1] * mesh.data_size()
    mean = mesh.all_reduce_sum(xf.sum(dims)) / n
    d = xf - mean.view(shape)
    var = mesh.all_reduce_sum((d * d).sum(dims)) / n
    y = d * torch.rsqrt(var + eps).view(shape) * bn.weight.view(shape) + bn.bias.view(shape)
    with torch.no_grad():
        running_mean.mul_(1 - momentum).add_(mean, alpha=momentum)
        running_var.mul_(1 - momentum).add_(var * (n / (n - 1)), alpha=momentum)
    return y.to(x.dtype)


def leaky_relu(x: Tensor, slope: float = 0.2) -> Tensor:
    return torch.where(x >= 0, x, slope * x)


def upsample_nearest_2x(x: Tensor) -> Tensor:
    """[N, C, H, W] -> [N, C, 2H, 2W] nearest neighbour (keeps the
    channels_last memory format)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def gru_layer(x: Tensor, w_ih: Tensor, w_hh: Tensor, b_ih: Tensor, b_hh: Tensor,
              h0: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """GRU over [B, T, I] -> ([B, T, H], h_T [B, H]); gates r, z, n."""
    B, T, _ = x.shape
    H = w_hh.shape[1]
    h = x.new_zeros(B, H) if h0 is None else h0.reshape(B, H)
    xp = x @ w_ih.t() + b_ih  # [B, T, 3H]
    ys = []
    for t in range(T):
        hp = h @ w_hh.t() + b_hh
        xr, xz, xn = xp[:, t].split(H, dim=-1)
        hr, hz, hn = hp.split(H, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1 - z) * n + z * h
        ys.append(h)
    return torch.stack(ys, dim=1) if ys else x.new_zeros(B, 0, H), h


def lstm_layer(x: Tensor, w_ih: Tensor, w_hh: Tensor, b_ih: Tensor, b_hh: Tensor,
               state: Optional[Tuple[Tensor, Tensor]] = None
               ) -> Tuple[Tensor, Tuple[Tensor, Tensor]]:
    """LSTM over [B, T, I] -> ([B, T, H], (h_T, c_T)); gates i, f, g, o."""
    B, T, _ = x.shape
    H = w_hh.shape[1]
    if state is None:
        h, c = x.new_zeros(B, H), x.new_zeros(B, H)
    else:
        h, c = state[0].reshape(B, H), state[1].reshape(B, H)
    xp = x @ w_ih.t() + b_ih  # [B, T, 4H]
    ys = []
    for t in range(T):
        gates = xp[:, t] + h @ w_hh.t() + b_hh
        i, f, g, o = gates.split(H, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        g = torch.tanh(g)
        c = f * c + i * g
        h = o * torch.tanh(c)
        ys.append(h)
    return torch.stack(ys, dim=1) if ys else x.new_zeros(B, 0, H), (h, c)


def gru_batched(x: Tensor, w_ih: Tensor, w_hh: Tensor, b_ih: Tensor, b_hh: Tensor
                ) -> Tuple[Tensor, Tensor]:
    """GRU over [B, T, I] at any batch -> ([B, T, H], h_T [B, H]), from zero
    state, through torch's own RNN operator (cuDNN on the card) and
    differentiable: what the trainers run (JAX trains with
    nn_core.gru_layer's lax.scan, outside any Pallas kernel).  K2 stays the
    batch-1 inference kernel."""
    h0 = x.new_zeros(1, x.shape[0], w_hh.shape[1])
    with _packed_weights_warning_off():
        y, h = torch._VF.gru(x, h0, [w_ih, w_hh, b_ih, b_hh], True, 1, 0.0,
                             torch.is_grad_enabled(), False, True)
    return y, h[0]


def lstm_batched(x: Tensor, w_ih: Tensor, w_hh: Tensor, b_ih: Tensor, b_hh: Tensor
                 ) -> Tuple[Tensor, Tuple[Tensor, Tensor]]:
    """LSTM over [B, T, I] at any batch -> ([B, T, H], (h_T, c_T)), from zero
    state, as gru_batched (K3 stays the batch-1 inference kernel)."""
    z = x.new_zeros(1, x.shape[0], w_hh.shape[1])
    with _packed_weights_warning_off():
        y, h, c = torch._VF.lstm(x, (z, z), [w_ih, w_hh, b_ih, b_hh], True, 1, 0.0,
                                 torch.is_grad_enabled(), False, True)
    return y, (h[0], c[0])


@contextlib.contextmanager
def _packed_weights_warning_off():
    """cuDNN warns that the layer's four weights are not one packed buffer:
    they are separate parameters (the reference's key names), so it packs a
    copy each call, one layer's weights (a few MB)."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="RNN module weights are not part")
        yield


class RNNWeights(nn.Module):
    """Parameter holder for a stack of GRU (gates=3) or LSTM (gates=4)
    layers with ``torch.nn.GRU`` / ``torch.nn.LSTM`` parameter names
    (``weight_ih_l{k}``, ...), so reference state dicts load unchanged.
    The recurrence itself runs in ops/recurrent_cuda.py, not in cuDNN."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int, gates: int):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        for k in range(num_layers):
            in_dim = input_size if k == 0 else hidden_size
            G = gates * hidden_size
            self.register_parameter(f"weight_ih_l{k}", nn.Parameter(torch.empty(G, in_dim)))
            self.register_parameter(f"weight_hh_l{k}", nn.Parameter(torch.empty(G, hidden_size)))
            self.register_parameter(f"bias_ih_l{k}", nn.Parameter(torch.empty(G)))
            self.register_parameter(f"bias_hh_l{k}", nn.Parameter(torch.empty(G)))

    def layer(self, k: int) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
        """(w_ih, w_hh, b_ih, b_hh) of layer k."""
        return (getattr(self, f"weight_ih_l{k}"), getattr(self, f"weight_hh_l{k}"),
                getattr(self, f"bias_ih_l{k}"), getattr(self, f"bias_hh_l{k}"))


# ---------------------------------------------------------------------------
# Random init at the JAX package's scales, from an explicit torch.Generator
# ---------------------------------------------------------------------------


@torch.no_grad()
def init_normal_(module: nn.Module, gen: torch.Generator, gain: float = 0.02) -> None:
    """normal(0, gain) weights and zero biases for every Linear / Conv /
    ConvTranspose in ``module`` (nn_core.dense_init / conv*_init), in
    registration order."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d)):
            m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * gain)
            if m.bias is not None:
                m.bias.zero_()


@torch.no_grad()
def init_batchnorm_(module: nn.Module, gen: Optional[torch.Generator] = None,
                    gain: float = 0.02) -> None:
    """Running stats (0, 1), bias 0, and scale 1 - or N(1, gain) when a
    generator is given (nn_core.batchnorm_init with init_scale_noise)."""
    for m in module.modules():
        if isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.reset_running_stats()
            m.bias.zero_()
            if gen is None:
                m.weight.fill_(1.0)
            else:
                m.weight.copy_(1.0 + gain * torch.randn(m.weight.shape, generator=gen))


@torch.no_grad()
def init_rnn_(rnn: RNNWeights, gen: torch.Generator) -> None:
    """torch's RNN default: U(-1/sqrt(H), 1/sqrt(H)) (uniform_fan_init)."""
    bound = 1.0 / math.sqrt(rnn.hidden_size)
    for p in rnn.parameters():
        p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1) * bound)
