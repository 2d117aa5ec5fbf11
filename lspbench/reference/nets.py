"""The four networks of LiveSpeechPortraits as plain float32 PyTorch.

A frozen reference of the published architectures (the reference repo's
``models/networks.py``, ``audio2feature.py``, ``audio2headpose.py`` and
``Feature2FaceGenerator_normal`` / ``_large``), independent of the program
under test: it imports nothing of it.  Each network is a state dict in the
reference's key names (``spec_*`` lists every key with its shape) and a
function over that dict.  ``f32_strict`` turns TF32 off for the block.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
StateDict = Dict[str, Tensor]
BN_EPS = 1e-5


@contextlib.contextmanager
def f32_strict() -> Iterator[None]:
    """Float32 matmuls and convolutions without TF32 inside the block; the
    previous settings come back after it."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


# ---------------------------------------------------------------------------
# Key specs: (key, shape, kind), kind one of "rnn", "w", "b", "bn_w", "bn_b",
# "bn_mean", "bn_var", "count"
# ---------------------------------------------------------------------------

Spec = List[Tuple[str, Tuple[int, ...], str]]


def _linear(name: str, cin: int, cout: int) -> Spec:
    return [(f"{name}.weight", (cout, cin), "w"), (f"{name}.bias", (cout,), "b")]


def _bn(name: str, ch: int) -> Spec:
    return [(f"{name}.weight", (ch,), "bn_w"), (f"{name}.bias", (ch,), "bn_b"),
            (f"{name}.running_mean", (ch,), "bn_mean"), (f"{name}.running_var", (ch,), "bn_var"),
            (f"{name}.num_batches_tracked", (), "count")]


def _rnn(prefix: str, cin: int, hidden: int, layers: int, gates: int) -> Spec:
    out: Spec = []
    for k in range(layers):
        i = cin if k == 0 else hidden
        out += [(f"{prefix}weight_ih_l{k}", (gates * hidden, i), "rnn"),
                (f"{prefix}weight_hh_l{k}", (gates * hidden, hidden), "rnn"),
                (f"{prefix}bias_ih_l{k}", (gates * hidden,), "rnn"),
                (f"{prefix}bias_hh_l{k}", (gates * hidden,), "rnn")]
    return out


def spec_apc(c: dict) -> Spec:
    out: Spec = []
    for i in range(c["apc_layers"]):
        out += _rnn(f"rnns.{i}.", c["mel_dim"] if i == 0 else c["apc_hidden"], c["apc_hidden"],
                    1, 3)
    return out


def spec_a2f(c: dict) -> Spec:
    H, L = c["apc_hidden"], c["a2f_lstm_hidden"]
    return (_linear("downsample.0", 2 * H, H) + _bn("downsample.1", H)
            + _linear("downsample.3", H, H) + _rnn("LSTM.", H, L, c["a2f_lstm_layers"], 4)
            + _linear("fc.0", L, 512) + _bn("fc.1", 512) + _linear("fc.3", 512, 512)
            + _bn("fc.4", 512) + _linear("fc.6", 512, c["a2f_output_dim"]))


def gmm_dim(c: dict) -> int:
    return (2 * c["a2h_ndim"] + 1) * c["a2h_ncenter"]


def _conv1d(name: str, cin: int, cout: int, k: int) -> Spec:
    return [(f"{name}.weight", (cout, cin, k), "w"), (f"{name}.bias", (cout,), "b")]


def spec_a2h(c: dict) -> Spec:
    H = c["apc_hidden"]
    res, dil, skip = c["wn_residual_channels"], c["wn_dilation_channels"], c["wn_skip_channels"]
    out = _linear("audio_downsample.0", 2 * H, H) + _bn("audio_downsample.1", H)
    out += _linear("audio_downsample.3", H, H)
    out += _conv1d("WaveNet.start_conv1", c["wn_input_channels"], res, 1)
    out += _conv1d("WaveNet.start_conv2", res, res, 1)
    for i in range(c["wn_blocks"] * c["wn_layers"]):
        p = f"WaveNet.residual_blocks.{i}."
        out += _conv1d(p + "filter_conv", res, dil, c["wn_kernel_size"])
        out += _conv1d(p + "gate_conv", res, dil, c["wn_kernel_size"])
        out += _conv1d(p + "residual_conv", dil, res, 1)
        out += _conv1d(p + "skip_conv", dil, skip, 1)
        out += _conv1d(p + "cond_filter_conv", H, dil, 1)
        out += _conv1d(p + "cond_gate_conv", H, dil, 1)
    g = gmm_dim(c)
    return out + _conv1d("WaveNet.end_conv_1", skip, g, 1) + _conv1d("WaveNet.end_conv_2", g, g, 1)


# ---------------------------------------------------------------------------
# The ResUNet generator ('normal': one residual block a stage; 'large': two)
# ---------------------------------------------------------------------------


def stage_widths(c: dict) -> List[Tuple[int, int, int]]:
    """(outer, inner, input) channels of each U-Net stage, outermost first."""
    ngf, n = c["ngf"], c["n_downsample"]
    inner = [ngf, 2 * ngf, 4 * ngf] + [8 * ngf] * (n - 3)
    outer = [c["output_nc"]] + inner[:-1]
    return [(outer[k], inner[k], c["input_nc"] if k == 0 else outer[k]) for k in range(n)]


def stage_layers(c: dict, k: int) -> List[Tuple[str, tuple]]:
    """Stage k's layers in order, as the reference's nn.Sequential holds them:
    ("down", (cin, cout)), ("bn", ch), ("relu",), ("res", ch), ("sub",),
    ("up2",), ("up", (cin, cout))."""
    widths = stage_widths(c)
    outer, inner, cin = widths[k]
    outermost, innermost = k == 0, k == len(widths) - 1
    n_res = c["n_res"]
    layers: List[Tuple[str, tuple]] = [("down", (cin, inner))]
    if not outermost and not innermost:
        layers.append(("bn", (inner,)))
    layers.append(("relu", ()))
    layers += [("res", (inner,))] * n_res
    if not innermost:
        layers.append(("sub", ()))
    layers.append(("up2", ()))
    layers.append(("up", (inner if innermost else 2 * inner, outer)))
    if not outermost:
        layers += [("bn", (outer,)), ("relu", ())] + [("res", (outer,))] * n_res
    return layers


def _conv2d_spec(name: str, cin: int, cout: int) -> Spec:
    return [(f"{name}.weight", (cout, cin, 3, 3), "w")]


def conv_plan(c: dict) -> List[Tuple[str, int, int, int, bool, Optional[str]]]:
    """Every 3x3 conv of the generator in forward order: (key, cin, cout,
    stride, int8 in the quantized renderer, the key of the BatchNorm that
    follows it or None)."""
    out = []

    def walk(k: int) -> None:
        layers = stage_layers(c, k)
        p = _prefix(c, k)
        for i, (kind, a) in enumerate(layers):
            nxt = layers[i + 1][0] if i + 1 < len(layers) else None
            bn = f"{p}{i + 1}" if nxt == "bn" else None
            if kind == "down":
                out.append((f"{p}{i}", a[0], a[1], 2, k > 0, bn))
            elif kind == "up":
                out.append((f"{p}{i}", a[0], a[1], 1, k > 0, bn))
            elif kind == "res":
                out.append((f"{p}{i}.block.0", a[0], a[0], 1, True, f"{p}{i}.block.1"))
                out.append((f"{p}{i}.block.3", a[0], a[0], 1, True, f"{p}{i}.block.4"))
            elif kind == "sub":
                walk(k + 1)

    walk(0)
    return out


def _prefix(c: dict, k: int) -> str:
    p = "netG.model.model."
    for j in range(k):
        idx = [name for name, _ in stage_layers(c, j)].index("sub")
        p += f"{idx}.model."
    return p


def spec_f2f(c: dict) -> Spec:
    out: Spec = []

    def walk(k: int) -> None:
        nonlocal out
        p = _prefix(c, k)
        for i, (kind, a) in enumerate(stage_layers(c, k)):
            if kind in ("down", "up"):
                out += _conv2d_spec(f"{p}{i}", a[0], a[1])
            elif kind == "bn":
                out += _bn(f"{p}{i}", a[0])
            elif kind == "res":
                out += _conv2d_spec(f"{p}{i}.block.0", a[0], a[0]) + _bn(f"{p}{i}.block.1", a[0])
                out += _conv2d_spec(f"{p}{i}.block.3", a[0], a[0]) + _bn(f"{p}{i}.block.4", a[0])
            elif kind == "sub":
                walk(k + 1)

    walk(0)
    return out


def batchnorm(x: Tensor, sd: StateDict, name: str) -> Tensor:
    """Eval-mode BatchNorm over axis 1 with the running statistics."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    k = sd[f"{name}.weight"] / torch.sqrt(sd[f"{name}.running_var"] + BN_EPS)
    return (x - sd[f"{name}.running_mean"].view(shape)) * k.view(shape) + sd[
        f"{name}.bias"].view(shape)


class ConvRunner:
    """How the generator's 3x3 convs run: plain float convs (``levels`` None), or
    the quantized renderer emulated in float32: per-output-channel
    symmetric weights with ``levels`` steps a side, the following BatchNorm
    folded into the weight scale and a bias, and a per-tensor activation
    scale, static (calibrated) or, while ``record`` is a list, the input's
    own amax, which is appended to it."""

    def __init__(self, sd: StateDict, c: dict, levels: Optional[int] = None):
        self.sd, self.levels = sd, levels
        self.convs = {key: (stride, q8, bn) for key, _, _, stride, q8, bn in conv_plan(c)}
        self.folded: Dict[str, Tuple[Tensor, Tensor, Tensor]] = {}
        self.x_scale: Dict[str, float] = {}
        self.record: Optional[List[float]] = None
        self.order: List[str] = []
        if levels is not None:
            for key, (stride, q8, bn) in self.convs.items():
                if q8:
                    self.folded[key] = self._quantize(key, bn)

    def _quantize(self, key: str, bn: Optional[str]) -> Tuple[Tensor, Tensor, Tensor]:
        w = self.sd[f"{key}.weight"].float()
        s = torch.clamp(w.abs().amax(dim=(1, 2, 3)), min=1e-12) / self.levels
        w_q = torch.clamp(torch.round(w / s.view(-1, 1, 1, 1)), -self.levels, self.levels)
        b = torch.zeros_like(s)
        if bn is not None:
            k = self.sd[f"{bn}.weight"] / torch.sqrt(self.sd[f"{bn}.running_var"] + BN_EPS)
            s = s * k
            b = self.sd[f"{bn}.bias"] - self.sd[f"{bn}.running_mean"] * k
        return w_q, s, b

    def norm(self, y: Tensor, conv_key: str, bn: str) -> Tensor:
        """The BatchNorm ``bn`` after conv ``conv_key``: none when it is
        folded into the conv."""
        if conv_key in self.folded:
            return y
        return batchnorm(y, self.sd, bn)

    def __call__(self, x: Tensor, key: str) -> Tensor:
        stride = self.convs[key][0]
        if key not in self.folded:
            return F.conv2d(x, self.sd[f"{key}.weight"], None, stride=stride, padding=1)
        w_q, s_w, b = self.folded[key]
        if self.record is not None:
            amax = float(x.abs().amax())
            self.record.append(amax)
            self.order.append(key)
            s_x = max(amax, 1e-12) / self.levels
        else:
            s_x = self.x_scale[key]
        q = torch.clamp(torch.round(x * (1.0 / s_x)), -self.levels, self.levels)
        y = F.conv2d(q, w_q, None, stride=stride, padding=1)
        return y * (s_w * s_x).view(1, -1, 1, 1) + b.view(1, -1, 1, 1)

    def calibrate(self, c: dict, inputs: Tensor) -> None:
        """Static activation scales: one forward over ``inputs`` with each
        conv's own amax, then x_scale = max(amax, 1e-12) / levels."""
        self.record, self.order = [], []
        generator(self.sd, c, inputs, self)
        self.x_scale = {k: max(a, 1e-12) / self.levels for k, a in zip(self.order, self.record)}
        self.record = None


def _resblock(x: Tensor, sd: StateDict, name: str, conv: ConvRunner) -> Tensor:
    y = torch.relu(conv.norm(conv(x, f"{name}.block.0"), f"{name}.block.0", f"{name}.block.1"))
    y = conv.norm(conv(y, f"{name}.block.3"), f"{name}.block.3", f"{name}.block.4")
    return torch.relu(x + y)


def _stage(x: Tensor, sd: StateDict, c: dict, k: int, conv: ConvRunner):
    p = _prefix(c, k)
    y, last = x, None
    for i, (kind, a) in enumerate(stage_layers(c, k)):
        if kind in ("down", "up"):
            last = f"{p}{i}"
            y = conv(y, last)
        elif kind == "bn":
            y = conv.norm(y, last, f"{p}{i}")
        elif kind == "relu":
            y = torch.relu(y)
        elif kind == "res":
            y = _resblock(y, sd, f"{p}{i}", conv)
        elif kind == "sub":
            skip, inner = _stage(y, sd, c, k + 1, conv)
            y = torch.cat([skip, inner], dim=1)
        elif kind == "up2":
            y = F.interpolate(y, scale_factor=2, mode="nearest")
    return y if k == 0 else (x, y)


def generator(sd: StateDict, c: dict, x: Tensor, conv: Optional[ConvRunner] = None) -> Tensor:
    """x [B, H, W, input_nc] -> [B, H, W, 3] in [-1, 1], in x's dtype."""
    conv = conv or ConvRunner(sd, c)
    y = _stage(x.permute(0, 3, 1, 2), sd, c, 0, conv)
    return torch.tanh(y).permute(0, 2, 3, 1)


def to_uint8(y: Tensor) -> Tensor:
    """[-1, 1] -> uint8, truncating after the clip."""
    return ((y + 1.0) * 127.5).clamp(0, 255).to(torch.uint8)
