"""The mix's transfer reaches the check (CPU, 32 px): the reference's frames
take the transfer the program's do; ``rgb`` checks exactly as before; and
BENCHMARK.json's validation refuses a transfer the reference cannot take."""

from __future__ import annotations

import copy
import json
import os
import shutil
import time

import numpy as np
import pytest
import torch

from lspbench import check, manifest, run
from lspbench.reference import motion, nets, render, transfer
from lspbench.tests.test_lspbench_run import SEED, FrameAltered, _cell


def _run(cell, monkeypatch, program=None, seconds=1.0):
    """run_cell on the CPU: (the result, (arguments, frames) of each
    reference_frames call the check made)."""
    calls = []
    frames = check.reference_frames

    def record(*a, **k):
        calls.append((a, k, frames(*a, **k)))
        return calls[-1][-1]

    monkeypatch.setattr(check, "reference_frames", record)
    result, forbidden = run.run_cell(cell, SEED, seconds, trace=False, device="cpu",
                                     t0=time.time(), program=program)
    assert forbidden == []
    return result, calls


def _exact_frames(c, A, sd, audio, seed, keep, runner=None):
    """The reference's frames as the check made them before it took the
    mix's transfer: the generator's output through ``nets.to_uint8``."""
    with torch.no_grad(), nets.f32_strict():
        lm, sh = motion.motion(c, A, sd, audio, seed, A["bank"].device)
        out = []
        for i in range(0, len(keep), check.BLOCK):
            rows = keep[i:i + check.BLOCK]
            x = render.render_input(lm[rows], sh[rows], A["candidates"])
            out.append(nets.to_uint8(nets.generator(sd["f2f"], c, x, runner)).cpu().numpy())
    return np.concatenate(out)


@pytest.mark.parametrize("name", ["obama_normal_bf16", "may_large_int8"])
def test_rgb_checks_the_exact_frames_as_before(in_workdir, monkeypatch, name):
    cell = _cell(name)
    assert cell.traffic["transfer"] == "rgb"
    result, calls = _run(cell, monkeypatch, seconds=0.0)
    assert result["correct"] and len(calls) == cell.traffic["check_requests"]
    for a, _, frames in calls:
        assert np.array_equal(frames, _exact_frames(*a))


@pytest.fixture
def tree(tmp_path, monkeypatch):
    """A copy of lspbench's data that ``manifest`` reads in place of the
    real one: (its root, BENCHMARK.json)."""
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(manifest.HERE, sub), tmp_path / "lspbench" / sub)
    monkeypatch.setattr(manifest, "HERE", str(tmp_path / "lspbench"))
    return tmp_path, copy.deepcopy(manifest.load())


@pytest.mark.parametrize("transfer_name", ["jpeg", "jpeg4", "pack4e", "no_such_transfer"])
def test_a_transfer_with_no_reference_transform_is_refused(tree, transfer_name):
    root, m = tree
    path = root / "lspbench" / "traffic" / "serve_short.json"
    mix = json.loads(path.read_text())
    assert manifest.validate(m, root=str(root)) == []
    path.write_text(json.dumps({**mix, "transfer": transfer_name}))
    assert any("no transform for the transfer" in e for e in manifest.validate(m, root=str(root)))


def test_rgb_is_the_exact_transform():
    assert transfer.TRANSFORMS["rgb"] is nets.to_uint8
    assert set(transfer.TRANSFORMS) == {"rgb", "yuv420"}


def _frames(seed: int, n: int = 16, size: int = 64) -> torch.Tensor:
    """Smooth colour fields with texture in [-1, 1], as the renderer gives."""
    g = torch.Generator().manual_seed(seed)
    low = torch.rand(n, 3, 4, 4, generator=g) * 2 - 1
    x = torch.nn.functional.interpolate(low, size=(size, size), mode="bilinear",
                                        align_corners=True).permute(0, 2, 3, 1)
    return (x + 0.1 * torch.randn(x.shape, generator=g)).clamp(-1.05, 1.05)


def test_the_reference_yuv420_round_trip_is_the_programs():
    from livespeechportraits_torch.pipeline import animate, compress

    same = total = 0
    for seed in range(4):
        x = _frames(seed)
        ours = transfer.yuv420(x)
        theirs = compress.i420_to_rgb(animate.rgb_to_yuv420_packed(x), 64, 64)
        d = (ours.int() - theirs.int()).abs()
        # one chroma code at a rounding edge moves a channel by up to 1.772
        assert int(d.max()) <= 2
        same += int((d.flatten(1).amax(1) == 0).sum())
        total += len(x)
    assert same >= 0.9 * total
    # and it is lossy: the exact frames differ
    assert not torch.equal(transfer.yuv420(_frames(0)), nets.to_uint8(_frames(0)))


def test_a_yuv420_run_is_correct_and_an_altered_frame_is_not(in_workdir, monkeypatch):
    cell = _cell("obama_normal_bf16", transfer="yuv420")
    sound, calls = _run(cell, monkeypatch)
    assert sound["correct"] and sound["failed"] == 0
    assert all(k["transform"] is transfer.yuv420 for _, k, _ in calls)
    assert all(v["value"] <= v["limit"] for v in sound["check"].values())
    altered, _ = _run(cell, monkeypatch, program=FrameAltered)
    assert not altered["correct"]
    assert any(v["value"] > v["limit"] for v in altered["check"].values())
