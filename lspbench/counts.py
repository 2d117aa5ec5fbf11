"""The yardstick's arithmetic: the Feature2Face generator's operations and
bytes, counted from a configuration's published widths, and the card's
peak rates.

Frozen here so that a later rewrite of the program (subpixel forms, split
skips, fused epilogues) is judged against the same work.  The FLOP rule is
the one the repository's ``utils/flops.py`` counts by:

- a convolution: 2 FLOPs a multiply-accumulate, counting only the taps that
  land on real input (not on the zero padding);
- BatchNorm in inference: 4 FLOPs an element and 1 a channel;
- ReLU and the residual add: 1 an element;
- the nearest upsample, the concat and the tanh: none.

An int8 3x3 conv's roofline bound is the larger of 2 x its MACs over the
int8 peak and its bytes over the memory rate, the bytes being its true
inputs read once (for an up conv the sources before the upsample and the
concat), its int8 weights and bf16 scale and bias, and its bf16 output
written once.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

from lspbench.reference.nets import stage_layers

# NVIDIA's H100 SXM5 data sheet, dense rates without sparsity (the part names
# itself "NVIDIA H100 80GB HBM3").
PEAKS: Dict[str, Dict[str, float]] = {
    "H100 80GB HBM3": {"bf16": 989.4e12, "int8": 1978.9e12, "bytes_per_s": 3.35e12},
}
BF16 = 2  # bytes an activation element


def peaks(device_name: str) -> Optional[Dict[str, float]]:
    """The rates of the card named ``device_name`` (torch.cuda's name), or
    None for a card the table does not hold."""
    return next((v for k, v in PEAKS.items() if k.lower() in device_name.lower()), None)


def _taps(in_size: int, stride: int, out_size: int, k: int = 3, pad: int = 1) -> int:
    """(output position, kernel offset) pairs along one axis that land on a
    real input element."""
    return sum(1 for o in range(out_size) for u in range(k) if 0 <= o * stride - pad + u < in_size)


class Conv(NamedTuple):
    """One 3x3 conv of the generator: its MACs and activation bytes a frame,
    and its weight bytes a forward (int8 weights, bf16 scale and bias)."""
    stage: int
    kind: str  # "down", "up" or "res"
    cin: int
    cout: int
    out_res: int
    int8: bool
    macs: float
    act_bytes: float
    weight_bytes: float


def generator_convs(c: dict) -> List[Conv]:
    """Every 3x3 conv of one frame's forward, in order; the outermost
    stage's down and up convs are float, every other is int8."""
    out: List[Conv] = []

    def conv(k: int, kind: str, cin: int, cout: int, in_res: int, src_res: int, stride: int):
        res = in_res // stride
        macs = _taps(in_res, stride, res) ** 2 * cin * cout
        act = (src_res * src_res * cin + res * res * cout) * BF16
        out.append(Conv(k, kind, cin, cout, res, k > 0 or kind == "res", macs, act,
                        cout * cin * 9 + 2 * cout * BF16))

    def stage(k: int, res: int) -> None:
        cur = res
        for kind, a in stage_layers(c, k):
            if kind == "down":
                conv(k, "down", a[0], a[1], cur, cur, 2)
                cur //= 2
            elif kind == "res":
                conv(k, "res", a[0], a[0], cur, cur, 1)
                conv(k, "res", a[0], a[0], cur, cur, 1)
            elif kind == "sub":
                stage(k + 1, cur)
            elif kind == "up2":
                cur *= 2
            elif kind == "up":
                # the sources before the nearest 2x upsample and the concat
                conv(k, "up", a[0], a[1], cur, cur // 2, 1)

    stage(0, c["image_size"])
    return out


def frame_flops(c: dict) -> float:
    """The generator's FLOPs for one frame at c["image_size"] (utils/flops.py's
    rule)."""
    f = 0.0

    def stage(k: int, res: int) -> None:
        nonlocal f
        cur, ch = res, 0
        for kind, a in stage_layers(c, k):
            if kind == "down":
                ch, out = a[1], cur // 2
                f += 2.0 * _taps(cur, 2, out) ** 2 * a[0] * ch
                cur = out
            elif kind == "up":
                ch = a[1]
                f += 2.0 * _taps(cur, 1, cur) ** 2 * a[0] * ch
            elif kind == "bn":
                f += 4.0 * cur * cur * ch + ch
            elif kind == "relu":
                f += 1.0 * cur * cur * ch
            elif kind == "res":
                f += 2 * (2.0 * _taps(cur, 1, cur) ** 2 * ch * ch + 4.0 * cur * cur * ch + ch)
                f += 3.0 * cur * cur * ch  # the inner ReLU, the add, the outer ReLU
            elif kind == "sub":
                stage(k + 1, cur)
            elif kind == "up2":
                cur *= 2

    stage(0, c["image_size"])
    return f


def int8_bound_s(c: dict, batch: int, rates: Dict[str, float]) -> float:
    """The sum over the int8 convs of one forward of ``batch`` frames of each
    conv's roofline bound, in seconds."""
    return sum(max(2.0 * cv.macs * batch / rates["int8"],
                   (cv.act_bytes * batch + cv.weight_bytes) / rates["bytes_per_s"])
               for cv in generator_convs(c) if cv.int8)
