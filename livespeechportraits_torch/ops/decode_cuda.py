"""The head-pose decode's steps in one CUDA kernel (K5).

``decode`` runs n consecutive steps of ``audio2headpose.decode_step`` (the
WaveNet stream step, the GMM sample, the ring, row and step updates) on a
``DecodeBuffers`` in one launch of ``csrc/headpose.cu``: one thread-block
cluster of 16 blocks keeps the weights on the step's critical path in
shared memory and hands each stage's vector to every block through
distributed shared memory (see the note at the top of that file).  It
replaces no Pallas kernel: JAX's decode is a ``lax.scan``.

What the kernel takes (``unsupported`` says why not): the published A2H
WaveNet (kernel size 2, 7 layers x 2 blocks, 128 residual and dilation
channels, 256 skip channels, 12 inputs, biases, conditioning, leaky ReLU),
12 GMM dimensions and 1 or 2 components, on f32 CUDA tensors.  The
conditioning width is not read: the projections come in ``fproj`` /
``gproj``.  ``audio2headpose.decode_steps`` is the dispatch: the kernel for
CUDA buffers (which raises on a config it does not take), ``decode_step``
n times for CPU buffers.

The weights go to the kernel packed into one f32 tensor
(``pack_weights``: per layer the two taps of the filter and gate convs, the
residual and skip convs, their biases, then the start and end convs), kept
on the model and packed again when a parameter moves or changes
(``packed_weights``).  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from livespeechportraits_torch import _build

Tensor = torch.Tensor

LAUNCHES = 0

# The kernel's shape (csrc/headpose.cu)
LAYERS, BLOCKS, RES, SKIP, INPUT, KERNEL = 7, 2, 128, 256, 12, 2
MAX_NCENTER = 2


def unsupported(cfg) -> Optional[str]:
    """Why the kernel does not take this Audio2Headpose config, or None
    when it does (``decode`` raises with this reason)."""
    wn = cfg.wavenet
    want = {"decoder": (cfg.decoder, "wavenet"), "ndim": (cfg.ndim, INPUT),
            "kernel_size": (wn.kernel_size, KERNEL),
            "residual_layers": (wn.residual_layers, LAYERS),
            "residual_blocks": (wn.residual_blocks, BLOCKS),
            "residual_channels": (wn.residual_channels, RES),
            "dilation_channels": (wn.dilation_channels, RES),
            "skip_channels": (wn.skip_channels, SKIP), "input_channels": (wn.input_channels, INPUT),
            "use_bias": (wn.use_bias, True), "cond": (wn.cond, True),
            "activation": (wn.activation, "leakyrelu")}
    bad = [f"{k}={got!r} (takes {ok!r})" for k, (got, ok) in want.items() if got != ok]
    if not 1 <= cfg.ncenter <= MAX_NCENTER:
        bad.append(f"ncenter={cfg.ncenter} (takes 1..{MAX_NCENTER})")
    return ", ".join(bad) or None


def _pieces(net) -> List[Tuple[str, Tensor]]:
    """The packed tensor's pieces in order, each with the module tensor it
    holds: (state-dict name, the piece as packed)."""
    blocks = net.residual_blocks

    def taps(k):  # [L, R, 2, R]: the filter and gate taps k of each unit
        return torch.stack([torch.stack([b.filter_conv.weight[:, :, k],
                                         b.gate_conv.weight[:, :, k]], 1) for b in blocks])

    return [
        ("taps_h", taps(1)),
        ("residual", torch.stack([b.residual_conv.weight[:, :, 0] for b in blocks])),
        ("taps_x", taps(0)),
        ("skip", torch.stack([b.skip_conv.weight[:, :, 0] for b in blocks])),
        ("bias_fg", torch.stack([torch.stack([b.filter_conv.bias, b.gate_conv.bias], 1)
                                 for b in blocks])),
        ("bias_res", torch.stack([b.residual_conv.bias for b in blocks])),
        ("bias_skip", torch.stack([b.skip_conv.bias for b in blocks])),
        ("start_conv1.weight", net.start_conv1.weight[:, :, 0]),
        ("start_conv1.bias", net.start_conv1.bias),
        ("start_conv2.weight", net.start_conv2.weight[:, :, 0]),
        ("start_conv2.bias", net.start_conv2.bias),
        ("end_conv_1.weight", net.end_conv_1.weight[:, :, 0]),
        ("end_conv_1.bias", net.end_conv_1.bias),
        ("end_conv_2.weight", net.end_conv_2.weight[:, :, 0]),
        ("end_conv_2.bias", net.end_conv_2.bias),
    ]


def pack_weights(net) -> Tensor:
    """The WaveNet's weights as the kernel reads them: one contiguous f32
    tensor on the net's device."""
    with torch.no_grad():
        return torch.cat([p.detach().reshape(-1) for _, p in _pieces(net)]).float().contiguous()


def packed_weights(model) -> Tensor:
    """``pack_weights`` of the model's WaveNet, kept on the model and packed
    again when one of its parameters moves or changes in place."""
    net = model.WaveNet
    key = tuple((p.data_ptr(), p._version) for p in net.parameters())
    cached = model.__dict__.get("_decode_weights")
    if cached is None or cached[0] != key:
        cached = model.__dict__["_decode_weights"] = (key, pack_weights(net))
    return cached[1]


def _check(name: str, t: Tensor, shape, dtype=torch.float32) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def decode(model, cfg, dec, n: int, sigma_scale: float) -> None:
    """Launch K5: n decode steps on ``dec`` (CUDA tensors), as n calls of
    ``audio2headpose.decode_step`` would take them.  Raises on a config the
    kernel does not take, a buffer of another shape, type or layout, and a
    tensor not on one CUDA device.  Steps past ``dec.rows`` are not taken
    (the kernel reads ``row`` on the device)."""
    global LAUNCHES
    why = unsupported(cfg)
    if why is not None:
        raise ValueError(f"the decode kernel does not take this config: {why}")
    if n < 0:
        raise ValueError(f"n = {n} steps")
    L, R, rows = LAYERS * BLOCKS, RES, dec.rows
    ring_rows = BLOCKS * (2 ** LAYERS - 1)
    shapes = {"ring_flat": (dec.ring_flat, (ring_rows, R)), "fproj": (dec.fproj, (L, rows, R)),
              "gproj": (dec.gproj, (L, rows, R)), "gumbel": (dec.gumbel, (rows, cfg.ncenter)),
              "eps": (dec.eps, (rows, INPUT)), "x_prev": (dec.x_prev, (1, INPUT)),
              "samples": (dec.samples, (rows, INPUT))}
    for name, (t, shape) in shapes.items():
        _check(name, t, shape)
    _check("step", dec.step, (1,), torch.int64)
    _check("row", dec.row, (1,), torch.int64)
    tensors = [t for t, _ in shapes.values()] + [dec.step, dec.row]
    dev = dec.ring_flat.device
    if dev.type != "cuda":
        raise ValueError(f"the decode kernel needs CUDA tensors, got {dev}")
    w = packed_weights(model)
    E = cfg.gmm_output_dim
    want = (L * R * (5 * R + 3) + L * SKIP * (R + 1) + R * (INPUT + R + 2)
            + E * (SKIP + E + 2))
    if w.numel() != want:
        raise ValueError(f"the WaveNet's packed weights hold {w.numel()} floats; the config's "
                         f"shape {want}")
    for t in tensors + [w]:
        if t.device != dev:
            raise ValueError(f"the decode's tensors are on {t.device} and {dev}")
    if n == 0:
        return
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.lsp_headpose_decode(
            w.data_ptr(), dec.fproj.data_ptr(), dec.gproj.data_ptr(), dec.gumbel.data_ptr(),
            dec.eps.data_ptr(), dec.ring_flat.data_ptr(), dec.x_prev.data_ptr(),
            dec.samples.data_ptr(), dec.step.data_ptr(), dec.row.data_ptr(), rows, int(n),
            cfg.ncenter, float(sigma_scale), stream)
    _build.check(err, f"lsp_headpose_decode n={n}")
    LAUNCHES += 1
