"""The yardstick's counts, tied to the repository's own FLOP walk of the
program's generator."""

from __future__ import annotations

import json
import os

import pytest
import torch

from lspbench import counts, manifest


def _config(name):
    with open(os.path.join(manifest.HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name,gflop", [("may_large_int8", 244.18), ("obama_normal_bf16", 162.51)])
def test_frame_flops_equal_generator_flops(name, gflop):
    from livespeechportraits_torch.config import Feature2FaceConfig
    from livespeechportraits_torch.models import feature2face as f2f
    from livespeechportraits_torch.utils import flops

    c = _config(name)
    with torch.device("meta"):
        g = f2f.Feature2FaceG(Feature2FaceConfig(size=c["size"]))
    assert counts.frame_flops(c) == flops.generator_flops(g, c["image_size"])
    assert round(counts.frame_flops(c) / 1e9, 2) == gflop


@pytest.mark.parametrize("name", ["may_large_int8", "obama_normal_bf16"])
def test_the_int8_convs_are_the_programs(name):
    from livespeechportraits_torch.config import Feature2FaceConfig
    from livespeechportraits_torch.models import feature2face as f2f

    c = _config(name)
    ours = [(cv.cin, cv.cout) for cv in counts.generator_convs(c) if cv.int8]
    theirs = [(cin, cout) for _, cin, cout, _ in
              f2f.int8_conv_shapes(Feature2FaceConfig(size=c["size"]))]
    assert ours == theirs and len(ours) == {"large": 74, "normal": 44}[c["size"]]


def test_an_up_conv_reads_its_sources_before_the_upsample_and_the_concat():
    c = _config("obama_normal_bf16")
    ups = [cv for cv in counts.generator_convs(c) if cv.kind == "up" and cv.int8]
    for cv in ups:
        src = cv.out_res // 2
        assert cv.act_bytes == (src * src * cv.cin + cv.out_res ** 2 * cv.cout) * counts.BF16
    # stage 1 at 512 px: cat(skip 128, inner 128) at 128^2, not 256 channels at 256^2
    first = ups[-1]
    assert (first.cin, first.cout, first.out_res) == (256, 64, 256)
    assert first.act_bytes == (128 * 128 * 256 + 256 * 256 * 64) * 2


def test_the_bound_is_the_larger_of_operations_and_bytes():
    c = _config("may_large_int8")
    rates = counts.PEAKS["H100 80GB HBM3"]
    one = sum(max(2 * cv.macs / rates["int8"], (cv.act_bytes + cv.weight_bytes)
                  / rates["bytes_per_s"]) for cv in counts.generator_convs(c) if cv.int8)
    assert counts.int8_bound_s(c, 1, rates) == pytest.approx(one)
    assert counts.int8_bound_s(c, 16, rates) < 16 * one  # weights read once a forward
    assert counts.peaks("NVIDIA H100 80GB HBM3") is rates and counts.peaks("cpu") is None
