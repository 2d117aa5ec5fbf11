"""The port's measurement tools (livespeechportraits_torch/tools/) run end to
end on the CPU at a tiny width (``--device cpu``, 32^2, ngf 4-8): each
prints the device line and its JSON rows, with the CPU's figures named as
host-clock times and the card's figures "not_measured".  parity's CLI as
tests/test_parity_tool.py:10-44 drives the JAX tool's."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from livespeechportraits_torch.models import feature2face as f2f
from livespeechportraits_torch.tools import (int8_probe, parity, prewarm_serving, render_ablate,
                                             stream_latency, trace_render, trace_train, train512,
                                             upload_diet)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(capsys, tool, argv):
    """Run tool.main(argv) and return its JSON rows after the device line."""
    assert tool.main(argv) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines() if s.startswith("{")]
    head, rows = lines[0], lines[1:]
    assert head["device"] == "cpu" and head["card"] == "cpu"
    assert rows
    return rows


def test_trace_render(capsys):
    rows = _rows(capsys, trace_render, ["2", "1", "2", "--device", "cpu", "--image_size", "32",
                                        "--ngf", "4", "--split_cand"])
    render = {r["renderer"]: r for r in rows if r["row"] == "render"}
    assert set(render) == {"bf16", "int8"}
    assert render["bf16"]["clock"] == "host" and render["bf16"]["mfu_bf16_peak"] == "not_measured"
    assert render["int8"]["psnr_int8_vs_bf16_db"] > 20
    assert render["bf16"]["gflop_per_frame"] > 0
    assert all(r["device_ms_per_batch"] == "not_measured" for r in rows if r["row"] == "families")


def test_int8_probe(capsys):
    rows = _rows(capsys, int8_probe, ["1", "--device", "cpu", "--image_size", "16"])
    assert [r["conv"] for r in rows] == [s[0] for s in int8_probe.SHAPES]
    taken = [r for r in rows if r.get("k4") != "not_taken"]
    assert len(taken) == 12 and all(r["k4_ms"] > 0 and r["cudnn_bf16_ms"] > 0 for r in taken)
    assert {r["conv"] for r in rows if r.get("k4") == "not_taken"} == {"outer.down", "outer.up"}


def test_render_ablate_removes_the_named_blocks(capsys):
    rows = _rows(capsys, render_ablate, ["2", "1", "--device", "cpu", "--image_size", "32",
                                         "--ngf", "4", "--reps", "1",
                                         "--variants", "full,minus_256sq_64ch,minus_leq32sq"])
    blocks = {r["variant"]: r["resnet_blocks"] for r in rows}
    # 'large' at 32^2: five stages, two ResnetBlocks a half, none on the
    # outermost up half and the innermost has no up-half blocks of its own
    assert blocks["full"] == 18 and blocks["minus_256sq_64ch"] == 14
    assert blocks["minus_leq32sq"] == 12
    assert rows[0]["in_net_cost_ms"] == 0.0


def test_trace_train(capsys):
    rows = _rows(capsys, trace_train, ["2", "2d", "1", "--device", "cpu", "--image_size", "32",
                                       "--ngf", "4", "--size", "normal"])
    step = rows[0]
    assert step["remat"] == 2 and step["remat_d"] and step["losses_finite"]
    assert rows[1]["device_ms_per_step"] == "not_measured"


def test_stream_latency(capsys):
    rows = _rows(capsys, stream_latency, ["0.6", "32", "--chunks", "8", "--depths", "1",
                                          "--ngf", "4", "--size", "normal", "--device", "cpu"])
    (row,) = rows
    assert row["frames"] == 36 - 15 and row["pushes"] >= 3
    assert row["cuda_launches_per_push"] == "not_measured"
    assert set(row["kernel_launches_per_push"]) == {"K1", "K2", "K3", "K4"}
    assert row["push_ms_p50"] > 0


def test_prewarm_serving_writes_then_reads_the_artifact(capsys, tmp_path):
    art = str(tmp_path / "serve.npz")
    argv = ["--device", "cpu", "--image_size", "32", "--artifact", art, "--seconds", "0.5",
            "--render_batch", "4", "--transfer", "yuv420"]
    cold = _rows(capsys, prewarm_serving, argv)[0]
    warm = _rows(capsys, prewarm_serving, argv)[0]
    assert not cold["artifact_existed"] and warm["artifact_existed"]
    assert cold["kernel_build_s"] == "not_built"
    assert cold["stream_first_frame_s"] > 0 and warm["predict_first_s"] > 0


def test_train512_bench_only(capsys, tmp_path):
    rows = _rows(capsys, train512, ["--device", "cpu", "--image_size", "32", "--ngf", "4",
                                    "--batch", "2", "--frames", "64", "--vgg", "none",
                                    "--bench_only", "--bench_steps", "1", "--fused_step",
                                    "--checkpoints_dir", str(tmp_path)])
    (row,) = rows
    assert row["losses_finite"] and row["train_tflops_per_step"] > 0
    assert row["mfu"] == "not_measured" and row["clock"] == "host"


def test_train512_trains_and_reports_the_deployed_int8(capsys, tmp_path):
    rows = _rows(capsys, train512, ["--device", "cpu", "--image_size", "32", "--ngf", "4",
                                    "--batch", "2", "--frames", "64", "--vgg", "none",
                                    "--steps", "2", "--bench_steps", "1", "--remat_depth", "2",
                                    "--checkpoints_dir", str(tmp_path)])
    (row,) = rows
    assert row["steps_trained"] >= 2 and row["fidelity"]["psnr_int8_vs_float"] > 20
    assert os.path.isdir(tmp_path / "train512" / "ckpt")


def test_upload_diet(capsys):
    rows = _rows(capsys, upload_diet, ["--device", "cpu", "--image_size", "32", "--batch", "2",
                                       "--reps", "1", "--a2h_frames", "800"])
    by = {(r["task"], r["format"]): r for r in rows}
    assert set(by) == {("feature2face", "diet"), ("feature2face", "legacy"),
                       ("audio2headpose", "diet"), ("audio2headpose", "legacy")}
    assert by["feature2face", "diet"]["bytes_per_step"] < by["feature2face", "legacy"][
        "bytes_per_step"]
    assert by["feature2face", "diet"]["cand_bytes_once"] > 0
    assert by["audio2headpose", "diet"]["bank_bytes_once"] > 0


def test_parity_cli(tmp_path):
    """The JAX tool's CLI test (tests/test_parity_tool.py:10-44) on the
    port's tool, run as a module on the CPU."""
    import cv2

    rng = np.random.default_rng(0)
    la = rng.uniform(0, 512, (20, 73, 2)).astype(np.float32)
    np.save(tmp_path / "a.npy", la)
    np.save(tmp_path / "b.npy", la + 1.0)
    frames = rng.integers(0, 255, (8, 64, 64, 3), dtype=np.uint8)
    for name in ["a.avi", "b.avi"]:
        out = cv2.VideoWriter(str(tmp_path / name), cv2.VideoWriter_fourcc(*"DIVX"), 60,
                              (64, 64))
        for f in frames:
            out.write(f)
        out.release()
    proc = subprocess.run(
        [sys.executable, "-m", "livespeechportraits_torch.tools.parity",
         "--landmarks_a", str(tmp_path / "a.npy"), "--landmarks_b", str(tmp_path / "b.npy"),
         "--video_a", str(tmp_path / "a.avi"), "--video_b", str(tmp_path / "b.avi"),
         "--device", "cpu"],
        capture_output=True, text=True, timeout=600, cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout[proc.stdout.index("{"):])
    assert out["landmark_l2_px"] == pytest.approx(np.sqrt(2), rel=1e-3)
    assert out["frames_compared"] == 8
    assert out["psnr_db"] > 20
    assert out["device"] == "cpu" and out["card"] == "cpu"
    with pytest.raises(SystemExit, match="no frames decoded"):
        parity.load_video(str(tmp_path / "missing.avi"))


def test_render_ablate_strip_keeps_a_valid_net():
    """strip() drops only ResnetBlocks, so the stripped net still runs."""
    from livespeechportraits_torch.tools import _common

    cfg = _common.f2f_config("large", 32, 4, precision="float32")
    model = f2f.Feature2FaceG(cfg).eval()
    out = render_ablate.strip(model, render_ablate.VARIANTS["minus_128sq_128ch"])
    with torch.no_grad():
        y = f2f.apply_generator(out, torch.zeros(1, 32, 32, 13))
    assert y.shape == (1, 32, 32, 3)
    assert sum(isinstance(m, f2f.ResnetBlock) for m in out.modules()) == 14
