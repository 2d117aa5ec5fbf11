"""K5, the head-pose decode kernel (ops/decode_cuda.py), on the CPU: its
dispatch ``audio2headpose.decode_steps`` runs ``decode_step`` n times
there, the kernel's wrapper refuses what it does not take before it
launches, and the packed weights it reads round-trip to the module's.  The
kernel itself runs on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import pytest
import torch

from livespeechportraits_torch.config import Audio2HeadposeConfig, WaveNetConfig, replace
from livespeechportraits_torch.models import audio2headpose as a2h
from livespeechportraits_torch.ops import decode_cuda, gmm

PUBLISHED = Audio2HeadposeConfig()
SMALL = Audio2HeadposeConfig(
    apc_hidden_size=16, ncenter=2,
    wavenet=WaveNetConfig(residual_layers=3, residual_blocks=2, dilation_channels=8,
                          residual_channels=8, skip_channels=16, cond_channels=16))


def _primed(cfg, model, rows: int, seed: int) -> a2h.DecodeBuffers:
    """Decode buffers of ``rows`` steps for ``model``, primed from seeded
    conditioning rows and a seeded first input, with seeded noise."""
    g = torch.Generator().manual_seed(seed)
    dec = a2h.DecodeBuffers(model, cfg, rows, "cpu")
    audio_ds = torch.randn(rows + cfg.frame_future, cfg.wavenet.cond_channels, generator=g)
    x_warm = 0.1 * torch.randn(cfg.wavenet.input_channels, generator=g)
    a2h.prime_decode(model, cfg, audio_ds, x_warm, dec, 0, rows)
    gumbel, eps = gmm.draw_noise(rows, cfg.ncenter, cfg.ndim, seed)
    dec.gumbel.copy_(gumbel)
    dec.eps.copy_(eps)
    return dec


@pytest.mark.parametrize("which", ["small", "published"])
@torch.no_grad()
def test_decode_steps_on_the_cpu_is_decode_step_n_times(which):
    """Two calls of decode_steps that split the steps leave the samples,
    the rings, row, step and x_prev bit for bit where the loop of
    decode_step does (SMALL has two GMM components: the Gumbel argmax)."""
    cfg, rows = (SMALL, 24) if which == "small" else (PUBLISHED, 6)
    torch.manual_seed(0)
    model = a2h.Audio2Headpose(cfg).eval()
    got, ref = _primed(cfg, model, rows, 5), _primed(cfg, model, rows, 5)
    split = rows // 3
    a2h.decode_steps(model, cfg, got, split, 0.3)
    a2h.decode_steps(model, cfg, got, rows - split, 0.3)
    for _ in range(rows):
        a2h.decode_step(model, cfg, ref, 0.3)
    for name in ("samples", "ring_flat", "row", "step", "x_prev"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    assert got.row.item() == got.step.item() == rows
    assert got.samples.abs().sum() > 0


def test_the_dispatch_rule_names_what_the_kernel_does_not_take():
    assert decode_cuda.unsupported(PUBLISHED) is None
    assert decode_cuda.unsupported(replace(PUBLISHED, ncenter=2)) is None
    assert "ncenter=3" in decode_cuda.unsupported(replace(PUBLISHED, ncenter=3))
    why = decode_cuda.unsupported(SMALL)
    assert "residual_channels=8" in why and "residual_layers=3" in why
    relu = replace(PUBLISHED, wavenet=replace(PUBLISHED.wavenet, activation="relu"))
    assert "activation" in decode_cuda.unsupported(relu)


@pytest.mark.parametrize("case,match", [("cpu_tensor", "needs CUDA tensors"),
                                        ("non_contiguous", "eps must be contiguous"),
                                        ("unsupported_shape", "does not take this config"),
                                        ("wrong_rows", "fproj has shape")])
def test_the_kernel_wrapper_refuses_what_it_does_not_take(case, match):
    """The wrapper raises before any launch: CPU buffers, a non-contiguous
    buffer, a config of other widths, a buffer of another shape."""
    cfg = SMALL if case == "unsupported_shape" else PUBLISHED
    model = a2h.Audio2Headpose(cfg)
    dec = a2h.DecodeBuffers(model, cfg, 4, "cpu")
    if case == "non_contiguous":
        dec.eps = torch.zeros(cfg.ndim, 4).t()
    if case == "wrong_rows":
        dec.fproj = dec.fproj[:, :3].contiguous()
    before = decode_cuda.LAUNCHES
    with pytest.raises(ValueError, match=match):
        decode_cuda.decode(model, cfg, dec, 4, 0.3)
    assert decode_cuda.LAUNCHES == before


def _unpack(packed: torch.Tensor, net) -> dict:
    """The packed weights read back into the WaveNet's state-dict tensors
    (``residual_blocks.{i}.filter_conv.weight`` [dil, res, 2], ...,
    ``end_conv_2.bias``): what the kernel reads of each."""
    views, at = {}, 0
    for name, p in decode_cuda._pieces(net):
        views[name] = packed[at:at + p.numel()].reshape(p.shape)
        at += p.numel()
    assert at == packed.numel()
    out = {}
    for i in range(len(net.residual_blocks)):
        pre = f"residual_blocks.{i}."
        h, x = views["taps_h"][i], views["taps_x"][i]  # [R, 2, R]: filter, gate
        out[pre + "filter_conv.weight"] = torch.stack([x[:, 0], h[:, 0]], -1)
        out[pre + "gate_conv.weight"] = torch.stack([x[:, 1], h[:, 1]], -1)
        out[pre + "filter_conv.bias"] = views["bias_fg"][i][:, 0]
        out[pre + "gate_conv.bias"] = views["bias_fg"][i][:, 1]
        out[pre + "residual_conv.weight"] = views["residual"][i][:, :, None]
        out[pre + "residual_conv.bias"] = views["bias_res"][i]
        out[pre + "skip_conv.weight"] = views["skip"][i][:, :, None]
        out[pre + "skip_conv.bias"] = views["bias_skip"][i]
    for name in ("start_conv1", "start_conv2", "end_conv_1", "end_conv_2"):
        out[f"{name}.weight"] = views[f"{name}.weight"][:, :, None]
        out[f"{name}.bias"] = views[f"{name}.bias"]
    return out


@pytest.mark.parametrize("ncenter", [1, 2])
def test_packed_weights_round_trip_to_the_module(ncenter):
    """Every tensor the kernel reads, unpacked from the packed weights,
    equals the module's (the conditioning convs are not packed: their
    projections come in the buffers); the kept pack follows the weights."""
    cfg = replace(PUBLISHED, ncenter=ncenter)
    model = a2h.Audio2Headpose(cfg)
    net = model.WaveNet
    net.reset_parameters(torch.Generator().manual_seed(ncenter))
    packed = decode_cuda.packed_weights(model)
    assert packed.dtype == torch.float32 and packed.is_contiguous() and packed.dim() == 1
    back = _unpack(packed, net)
    sd = net.state_dict()
    assert set(back) == {k for k in sd if ".cond_" not in k}
    for k, v in back.items():
        assert torch.equal(v, sd[k]), k
    assert decode_cuda.packed_weights(model) is packed
    with torch.no_grad():
        net.end_conv_2.bias.add_(1.0)
    again = decode_cuda.packed_weights(model)
    assert again is not packed and torch.equal(again[-cfg.gmm_output_dim:],
                                               net.end_conv_2.bias)

