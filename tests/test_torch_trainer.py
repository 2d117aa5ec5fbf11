"""The port's trainers end to end on the CPU at test widths: each loop for two
epochs, with a resume that repeats the uninterrupted run bit for bit; the
checkpoint format; ckpt_best across a resume; TTUR; the GMM-loss
Audio2Feature; device rasterisation through the plain rasteriser; the CLI;
and a Predictor serving what the trainers wrote.  Quantization-aware
training: the QAT loops with a resume, JAX's three resume rules, the
tag-free checkpoints of --qat_d, the CLI with each QAT flag and a
Predictor serving its checkpoint; and the CLI on a synth_subject root
(--dataroot, --clip_names, --apc_ckpt).  The counterpart of the JAX
package's tests/test_trainer_loop.py, test_train.py and
test_trained_serving.py."""

from __future__ import annotations

import csv
import os
import shutil

import numpy as np
import pytest
import torch

from livespeechportraits_torch import serve, server
from livespeechportraits_torch.config import (APCConfig, Audio2FeatureConfig,
                                              Audio2HeadposeConfig, Feature2FaceConfig,
                                              WaveNetConfig)
from livespeechportraits_torch.models import feature2face as f2f
from livespeechportraits_torch.pipeline import build_person, synth_subject
from livespeechportraits_torch.ops import rasterize as t_rasterize
from livespeechportraits_torch.train import __main__ as cli
from livespeechportraits_torch.train import datasets, trainer
from livespeechportraits_torch.utils import checkpoint as ckpt

@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the loops run the prefetch thread's torch ops
    beside the main thread's, and two OpenMP teams a process, in several
    test workers at once, spin each other nearly to a standstill (two
    workers with the default thread count ran 8 minutes without finishing
    what one thread each runs in 2)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


WN = WaveNetConfig(residual_layers=3, residual_blocks=1, dilation_channels=8,
                   residual_channels=8, skip_channels=16, cond_channels=8)
CFGS = {
    "apc": APCConfig(mel_dim=8, hidden_size=16, num_layers=2),
    "audio2feature": Audio2FeatureConfig(apc_hidden_size=8, lstm_hidden_size=8, frame_future=2),
    "audio2headpose": Audio2HeadposeConfig(apc_hidden_size=8, wavenet=WN),
    "feature2face": Feature2FaceConfig(ngf=4, n_downsample=5, load_size=32, ndf=4,
                                       n_layers_D=2, num_D=2, precision="float32"),
}


def _clips(frames: int = 600):
    rng = np.random.default_rng(0)
    return [datasets.make_clip(
        audio_features=rng.normal(size=(2 * frames, 8)).astype(np.float32),
        pts3d=rng.normal(size=(frames, 73, 3)).astype(np.float32) * 0.01,
        rot_angles=rng.uniform(-170, 170, (frames, 3)).astype(np.float32),
        trans=rng.normal(size=(frames, 3)).astype(np.float32)) for _ in range(2)]


def _face_sampler(n: int = 64, H: int = 32, device_rasterize: bool = True):
    rng = np.random.default_rng(3)
    return datasets.FaceFrameSampler(
        rng.integers(0, 255, (n, H, H, 3), dtype=np.uint8),
        rng.uniform(5, 27, (n, 73, 2)).astype(np.float32),
        rng.uniform(5, 27, (18, 2)).astype(np.float32),
        rng.uniform(-1, 1, (4, H, H, 3)).astype(np.float32), load_size=H,
        device_rasterize=device_rasterize)


def _samplers(task: str):
    """(train sampler, validation sampler, batch size) at test widths."""
    if task == "apc":
        rng = np.random.default_rng(1)
        mels = [rng.uniform(size=(n, 8)).astype(np.float32) for n in (90, 70, 40)]
        return (datasets.MelWindowSampler(mels[:2], window=20, stride=10),
                datasets.MelWindowSampler(mels[2:], window=20), 4)
    if task == "audio2feature":
        s = datasets.AudioVisualSampler(_clips(), task=task, seq_len=16, frame_jump_stride=16,
                                        device_audio=True)
        return s, s, 4
    if task == "audio2headpose":
        s = datasets.AudioVisualSampler(_clips(), task=task, target_length=8,
                                        receptive_field=WN.receptive_field, frame_future=2,
                                        frame_jump_stride=16, start_point=20, tail_margin=60,
                                        device_audio=True)
        return s, s, 4
    return _face_sampler(), _face_sampler(), 2


TRAIN = {"apc": trainer.train_apc, "audio2feature": trainer.train_audio2feature,
         "audio2headpose": trainer.train_audio2headpose,
         "feature2face": trainer.train_feature2face}


def _train(task, tmp_path, name, n_epochs_decay, continue_train=False, lr=1e-3, **kw):
    sampler, val, bs = _samplers(task)
    loop = trainer.TrainLoopConfig(n_epochs=1, n_epochs_decay=n_epochs_decay, lr=lr,
                                   batch_size=bs, print_freq=2, checkpoints_dir=str(tmp_path),
                                   name=name, continue_train=continue_train, device="cpu", **kw)
    return TRAIN[task](CFGS[task], loop, sampler, val)


def _assert_same_state(a: trainer.TrainResult, b: trainer.TrainResult):
    assert a.models.keys() == b.models.keys()
    for k in a.models:
        sa, sb = a.models[k].state_dict(), b.models[k].state_dict()
        for n in sa:
            assert torch.equal(sa[n], sb[n]), (k, n)
        oa, ob = a.optimizers[k].state_dict()["state"], b.optimizers[k].state_dict()["state"]
        for i in oa:
            for m in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(oa[i][m], ob[i][m]), (k, i, m)


@pytest.mark.parametrize("task", list(TRAIN))
def test_loop_two_epochs_and_resume_equals_the_uninterrupted_run(task, tmp_path):
    whole = _train(task, tmp_path, "whole", 1)
    assert whole.epochs == 2 and whole.step_ms and all(t > 0 for t in whole.step_ms)
    ckpt_dir = tmp_path / "whole" / "ckpt"
    assert ckpt.latest_step(str(ckpt_dir)) == 2 and sorted(os.listdir(ckpt_dir)) == ["1.pt",
                                                                                      "2.pt"]
    assert (tmp_path / "whole" / "loss_log.txt").exists()
    with open(tmp_path / "whole" / "scalars.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0][0] == "step"
    assert all(np.isfinite(float(x)) for r in rows[1:] if r[0] != "step" for x in r)
    first = _train(task, tmp_path, "split", 0)
    resumed = _train(task, tmp_path, "split", 1, continue_train=True)
    assert first.epochs == 1 and resumed.epochs == 2
    _assert_same_state(whole, resumed)
    # the models changed from their init
    init = _train(task, tmp_path, "none", 0, save_best=False)  # one epoch only
    assert any(not torch.equal(v, whole.models[k].state_dict()[n])
               for k, m in init.models.items() for n, v in m.state_dict().items())


def test_trainer_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device trains there")
    sampler, val, bs = _samplers("apc")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer.train_apc(CFGS["apc"], trainer.TrainLoopConfig(batch_size=bs), sampler)


def test_checkpoint_round_trip_refuses_missing_and_extra_keys(tmp_path):
    m = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.BatchNorm1d(4))
    opt = torch.optim.Adam(m.parameters(), lr=1e-3)
    m(torch.randn(5, 3)).sum().backward()
    opt.step()
    ckpt.save_checkpoint(str(tmp_path), 3, {"params": m}, {"params": opt}, best_val=0.5)
    st = ckpt.load_checkpoint(str(tmp_path))
    assert st["epoch"] == 3 and st["best_val"] == 0.5
    m2 = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.BatchNorm1d(4))
    opt2 = torch.optim.Adam(m2.parameters(), lr=1e-3)
    ckpt.restore(st, {"params": m2}, {"params": opt2})
    for k, v in m.state_dict().items():
        assert torch.equal(v, m2.state_dict()[k])
    with pytest.raises(ValueError, match="models do not match"):
        ckpt.restore(st, {"params": m2, "D": m2}, {"params": opt2})
    with pytest.raises(ValueError, match="entries do not match"):
        ckpt.restore(dict(st, extra=1), {"params": m2}, {"params": opt2})
    wider = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.BatchNorm1d(4),
                                torch.nn.Linear(4, 2))
    with pytest.raises(RuntimeError, match="Missing key"):
        ckpt.restore(st, {"params": wider}, {"params": torch.optim.Adam(wider.parameters())})
    narrow = torch.nn.Sequential(torch.nn.Linear(3, 4))
    with pytest.raises(RuntimeError, match="Unexpected key"):
        ckpt.restore(st, {"params": narrow}, {"params": torch.optim.Adam(narrow.parameters())})
    assert ckpt.prefer_best(str(tmp_path)) == str(tmp_path)
    with pytest.raises(FileNotFoundError):
        ckpt.load_checkpoint(str(tmp_path / "none"))


def _val_column(path, key):
    vals = []
    with open(path) as f:
        header = None
        for row in csv.reader(f):
            if row[0] == "step":
                header = row
            elif key in header:
                vals.append(float(row[header.index(key)]))
    return vals


def test_ckpt_best_tracks_the_validation_optimum_across_a_resume(tmp_path):
    """Epoch 1 validates best; the resumed run's huge learning rate makes
    every later epoch worse, and ckpt_best stays at epoch 1 (JAX restarts
    the tracker on resume and would keep a worse epoch)."""
    _train("audio2feature", tmp_path, "a2f", 0)
    best_dir = str(tmp_path / "a2f" / "ckpt_best")
    assert ckpt.latest_step(best_dir) == 1
    run = _train("audio2feature", tmp_path, "a2f", 2, continue_train=True, lr=3.0,
                 lr_policy="step")
    vals = _val_column(tmp_path / "a2f" / "scalars.csv", "val_loss")
    assert len(vals) == 3 and min(vals) == vals[0] < min(vals[1:])
    assert os.listdir(best_dir) == ["1.pt"]  # one file, the optimum
    assert ckpt.load_checkpoint(best_dir)["best_val"] == run.best_val == pytest.approx(vals[0])
    assert ckpt.prefer_best(str(tmp_path / "a2f" / "ckpt")) == best_dir


@pytest.mark.parametrize("ttur", [False, True])
def test_ttur_sets_the_two_optimizers(ttur, tmp_path):
    res = _train("feature2face", tmp_path, "f2f", 0, ttur=ttur, save_best=False)
    want = {"G": (5e-4, (0.0, 0.9)), "D": (2e-3, (0.0, 0.9))} if ttur else \
        {"G": (1e-3, (0.5, 0.999)), "D": (1e-3, (0.5, 0.999))}
    for k, (lr, betas) in want.items():
        group = res.optimizers[k].param_groups[0]
        assert group["lr"] == lr and tuple(group["betas"]) == betas and group["eps"] == 1e-8
    assert not (tmp_path / "f2f" / "ckpt_best").exists()


def test_gmm_loss_audio2feature_trains(tmp_path):
    cfg = Audio2FeatureConfig(apc_hidden_size=8, lstm_hidden_size=8, frame_future=2,
                              loss="GMM", gmm_ncenter=2)
    sampler, val, bs = _samplers("audio2feature")
    loop = trainer.TrainLoopConfig(n_epochs=1, n_epochs_decay=0, lr=1e-3, batch_size=bs,
                                   print_freq=1, checkpoints_dir=str(tmp_path), name="gmm",
                                   device="cpu")
    res = trainer.train_audio2feature(cfg, loop, sampler, val)
    assert res.models["params"].fc[6].out_features == (2 * 75 + 1) * 2
    nll = _val_column(tmp_path / "gmm" / "scalars.csv", "loss")
    assert nll and all(np.isfinite(nll)) and np.isfinite(res.best_val)


def test_device_rasterize_on_the_cpu_equals_the_host_batch():
    """The same generator state gives the same batch with the edge maps drawn
    on the device (here the plain rasteriser, as JAX's device rasteriser
    draws them) as with cv2 on the host, in every other field; the two
    drawings agree as JAX's do (IoU ~0.95, calibrated radius 1.5)."""
    import jax.numpy as jnp
    from livespeechportraits_tpu.ops import rasterize as j_rasterize

    dev, host = _face_sampler(), _face_sampler(device_rasterize=False)
    b_dev = next(dev.batches(2, np.random.default_rng(5)))
    b_host = next(host.batches(2, np.random.default_rng(5)))
    moved = trainer._Mover(torch.device("cpu"))(b_dev)
    assert moved["feature_map"].shape == (2, 32, 32, 1) and "landmarks" not in moved
    for k in ("tgt_image", "cand_image", "weight_mask"):
        assert np.array_equal(moved[k].numpy(), b_host[k]), k
    want = j_rasterize.rasterize_feature_maps(jnp.asarray(b_dev["landmarks"]),
                                              jnp.asarray(b_dev["shoulders"]), (32, 32))
    assert np.array_equal(moved["feature_map"][..., 0].numpy(), np.asarray(want))
    a, b = moved["feature_map"].numpy() > 0.5, b_host["feature_map"] > 0.5
    assert (a & b).sum() / (a | b).sum() > 0.85
    assert t_rasterize.segment_table(torch.from_numpy(b_dev["landmarks"]),
                                     torch.from_numpy(b_dev["shoulders"])).shape == (2, 88, 4)


# ---------------------------------------------------------------------------
# the CLI, and a Predictor serving what it wrote
# ---------------------------------------------------------------------------

CLI_ARGS = {
    "apc": ["--mel_window", "60"],
    "audio2feature": ["--sequence_length", "32", "--batch_size", "64"],
    "audio2headpose": ["--time_frame_length", "8", "--batch_size", "16"],
    "feature2face": ["--image_size", "32", "--batch_size", "4"],
}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The four tasks through the CLI on the CPU, at the default widths and
    a tiny size: the synthetic mels, clips and face frames cut to 600, 780
    and 64 frames (a few steps an epoch)."""
    root = tmp_path_factory.mktemp("ck")
    mels, clips, faces = cli.synthetic_mels, cli.synthetic_clips, cli.synthetic_face_data
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli, "synthetic_mels", lambda n, frames: mels(n, min(frames, 600)))
        mp.setattr(cli, "synthetic_clips", lambda n, frames: clips(n, min(frames, 780)))
        mp.setattr(cli, "synthetic_face_data", lambda n, H: faces(min(n, 64), H))
        for task, extra in CLI_ARGS.items():
            cli.main(["--task", task, "--synthetic", "--device", "cpu", "--n_epochs", "1",
                      "--n_epochs_decay", "1", "--checkpoints_dir", str(root),
                      "--print_freq", "1"] + extra)
    return root


@pytest.mark.parametrize("task", list(CLI_ARGS))
def test_cli_trains_each_task_on_the_cpu(trained, task):
    out = trained / task
    assert ckpt.latest_step(str(out / "ckpt")) == 2
    assert "training done" not in (out / "loss_log.txt").read_text()
    losses = _val_column(out / "scalars.csv", "loss_G" if task == "feature2face" else "loss")
    assert losses and all(np.isfinite(losses))


def test_cli_refuses_what_is_not_ported():
    # ZeRO-1 partitions over the ranks of a data-parallel run (JAX's message)
    with pytest.raises(ValueError, match="needs data_parallel=True"):
        cli.main(["--task", "feature2face", "--synthetic", "--zero1", "--device", "cpu"])
    # real data needs both --dataroot and --clip_names (JAX's message)
    for args in (["--dataroot", "d"], ["--clip_names", "c"], []):
        with pytest.raises(SystemExit, match="needs --dataroot and --clip_names"):
            cli.main(["--task", "audio2feature", "--device", "cpu"] + args)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["--task", "apc", "--synthetic"])


def test_predictor_serves_the_four_checkpoints(trained, tmp_path):
    ckpts = {f"{s}_ckpt": str(trained / task / "ckpt") for s, task in
             (("f2f", "feature2face"), ("a2f", "audio2feature"), ("a2h", "audio2headpose"),
              ("apc", "apc"))}
    p = serve.Predictor(max_audio_seconds=1.0, device="cpu", results_dir=str(tmp_path))
    p.setup("Synthetic", image_size=32, **ckpts)
    # each stage holds its checkpoint's weights (APC's best epoch: ckpt_best)
    a2f_sd = ckpt.load_checkpoint(ckpts["a2f_ckpt"])["models"]["params"]
    for k, v in p._models.audio2feature.state_dict().items():
        assert torch.equal(v, a2f_sd[k]), k
    apc_sd = ckpt.load_checkpoint(ckpt.prefer_best(ckpts["apc_ckpt"]))["models"]["params"]
    for k, v in p._models.apc.state_dict().items():
        assert torch.equal(v, apc_sd["encoder." + k]), k
    g_sd = ckpt.load_checkpoint(ckpts["f2f_ckpt"])["models"]["G"]
    w = p._models.feature2face.state_dict()["netG.model.model.0.weight"]
    assert torch.equal(w, g_sd["netG.model.model.0.weight"].to(w.dtype))
    t = np.arange(16000) / 16000.0
    res = p.predict((0.3 * np.sin(2 * np.pi * (200 + 300 * t) * t)).astype(np.float32),
                    write_video=False)
    assert res.frames.shape == (res.nframe, 32, 32, 3) and res.nframe == 45
    assert res.frames.std() > 0
    with pytest.raises(ValueError, match="shadow"):
        art = str(tmp_path / "art.npz")
        serve.Predictor(device="cpu").setup("Synthetic", image_size=32, artifact=art)
        serve.Predictor(device="cpu").setup("Synthetic", image_size=32, artifact=art, **ckpts)


def test_server_passes_the_checkpoints_through(monkeypatch):
    seen = {}
    monkeypatch.setattr(server, "serve_forever", lambda *a, **kw: seen.update(kw))
    server.main(["--f2f_ckpt", "a", "--a2f_ckpt", "b", "--a2h_ckpt", "c", "--apc_ckpt", "d"])
    assert {k: seen[k] for k in ("f2f_ckpt", "a2f_ckpt", "a2h_ckpt", "apc_ckpt")} == \
        {"f2f_ckpt": "a", "a2f_ckpt": "b", "a2h_ckpt": "c", "apc_ckpt": "d"}


def test_prefetch_order_errors_and_release():
    """The queue keeps the order, hands a worker's exception to the consumer,
    and a consumer that abandons it releases the worker."""
    import threading

    from livespeechportraits_torch.train.prefetch import prefetch

    assert list(prefetch(iter(range(7)), 2, lambda x: x * 10)) == [0, 10, 20, 30, 40, 50, 60]

    def boom():
        yield 1
        raise KeyError("sampler")

    with pytest.raises(KeyError, match="sampler"):
        list(prefetch(boom(), 1))
    with pytest.raises(ValueError, match=">= 1"):
        next(prefetch(iter(range(3)), 0))
    done = threading.Event()

    def endless():
        try:
            i = 0
            while True:
                yield i
                i += 1
        finally:
            done.set()

    it = prefetch(endless(), 2)
    assert next(it) == 0
    it.close()  # the consumer walks away with the queue full
    assert done.wait(timeout=10)


# ---------------------------------------------------------------------------
# quantization-aware training
# ---------------------------------------------------------------------------

QAT = {"qat": {"qat": True}, "qat_int8": {"qat_int8": True},
       "qat_int8_d": {"qat_int8": True, "qat_d": True}}


def _adam_steps(res: trainer.TrainResult, k: str) -> int:
    return int(next(iter(res.optimizers[k].state_dict()["state"].values()))["step"])


def _ckpt(tmp_path, name: str) -> dict:
    return ckpt.load_checkpoint(str(tmp_path / name / "ckpt"))


@pytest.mark.parametrize("mode", list(QAT))
def test_qat_loop_and_resume_equal_the_uninterrupted_run(mode, tmp_path):
    """A QAT run trains the tagged generator, its checkpoints record the tag
    and keep a float run's keys (D's never tagged, --qat_d's view included),
    and a resume repeats the uninterrupted run bit for bit."""
    kw = QAT[mode]
    want = "fq" if mode == "qat" else "fq8"
    whole = _train("feature2face", tmp_path, "whole", 1, **kw)
    assert f2f.qat_tag_mode(whole.models["G"]) == want
    assert not f2f.is_qat_generator(whole.models["D"])
    st = _ckpt(tmp_path, "whole")
    cfg = CFGS["feature2face"]
    assert st["qat_mode"] == want
    assert st["models"]["G"].keys() == f2f.Feature2FaceG(cfg).state_dict().keys()
    assert st["models"]["D"].keys() == f2f.Feature2FaceD(cfg).state_dict().keys()
    first = _train("feature2face", tmp_path, "split", 0, **kw)
    resumed = _train("feature2face", tmp_path, "split", 1, continue_train=True, **kw)
    assert first.epochs == 1 and resumed.epochs == 2
    _assert_same_state(whole, resumed)
    if kw.get("qat_d"):  # D's interior convs ran quantized: D trained otherwise
        plain_d = _train("feature2face", tmp_path, "plain_d", 1, qat_int8=True)
        assert any(not torch.equal(v, plain_d.models["D"].state_dict()[n])
                   for n, v in whole.models["D"].state_dict().items())


def test_qat_warm_start_from_a_float_checkpoint_restarts_the_generators_moments(tmp_path):
    """--qat --continue_train over a float checkpoint: the restored float
    weights are tagged and trained with fresh Adam moments; D's moments go
    on.  Two steps an epoch."""
    float_run = _train("feature2face", tmp_path, "ws", 0)
    assert _ckpt(tmp_path, "ws")["qat_mode"] is None
    g_float = float_run.models["G"].state_dict()
    # a resume with no epoch left: the tagged generator holds the float weights
    restored = _train("feature2face", tmp_path, "ws", 0, continue_train=True, qat=True)
    assert f2f.qat_tag_mode(restored.models["G"]) == "fq"
    for n, v in restored.models["G"].state_dict().items():
        assert torch.equal(v, g_float[n]), n
    assert not restored.optimizers["G"].state_dict()["state"]
    assert _adam_steps(restored, "D") == 2
    res = _train("feature2face", tmp_path, "ws", 1, continue_train=True, qat=True)
    assert f2f.qat_tag_mode(res.models["G"]) == "fq"
    assert _adam_steps(res, "G") == 2 and _adam_steps(res, "D") == 4
    assert _ckpt(tmp_path, "ws")["qat_mode"] == "fq"


def test_qat_resume_in_the_other_mode_retags_and_keeps_the_moments(tmp_path):
    """fq8 -> fq -> fq8: each resume retags the generator and its Adam
    moments go on (the tag is not in the state dicts)."""
    _train("feature2face", tmp_path, "rt", 0, qat_int8=True)
    as_fq = _train("feature2face", tmp_path, "rt", 1, continue_train=True, qat=True)
    assert f2f.qat_tag_mode(as_fq.models["G"]) == "fq" and _adam_steps(as_fq, "G") == 4
    assert _ckpt(tmp_path, "rt")["qat_mode"] == "fq"
    as_fq8 = _train("feature2face", tmp_path, "rt", 2, continue_train=True, qat_int8=True)
    assert f2f.qat_tag_mode(as_fq8.models["G"]) == "fq8" and _adam_steps(as_fq8, "G") == 6
    assert _ckpt(tmp_path, "rt")["qat_mode"] == "fq8"


def test_a_qat_checkpoint_resumed_without_qat_warns_and_trains_in_float(tmp_path):
    _train("feature2face", tmp_path, "off", 0, qat=True)
    with pytest.warns(UserWarning, match="QAT tags but qat=False"):
        res = _train("feature2face", tmp_path, "off", 1, continue_train=True)
    assert not f2f.is_qat_generator(res.models["G"]) and _adam_steps(res, "G") == 4
    assert _ckpt(tmp_path, "off")["qat_mode"] is None


def test_a_checkpoint_without_the_qat_entry_reads_as_float(tmp_path):
    """A file written before the qat_mode entry existed restores as a float
    run's."""
    _train("feature2face", tmp_path, "old", 0)
    path = tmp_path / "old" / "ckpt" / "1.pt"
    st = torch.load(path, weights_only=True)
    del st["qat_mode"]
    torch.save(st, path)
    assert ckpt.qat_mode(ckpt.load_checkpoint(str(path.parent))) is None
    res = _train("feature2face", tmp_path, "old", 1, continue_train=True, qat_int8=True)
    assert _adam_steps(res, "G") == 2  # a float checkpoint under QAT: fresh moments


QAT_CLI = {"qat": ["--qat"], "qat_int8": ["--qat_int8"], "qat_int8_d": ["--qat_int8", "--qat_d"]}


@pytest.mark.parametrize("mode", list(QAT_CLI))
def test_cli_trains_quantization_aware_and_a_predictor_serves_it(mode, tmp_path, monkeypatch):
    """The CLI with each QAT flag at the default widths on 32^2 frames; the
    Predictor loads the tagged checkpoint through a tagged template, strips
    it and serves it, as a float renderer (--qat) or int8 (--qat_int8)."""
    faces = cli.synthetic_face_data
    monkeypatch.setattr(cli, "synthetic_face_data", lambda n, H: faces(min(n, 64), H))
    cli.main(["--task", "feature2face", "--synthetic", "--device", "cpu", "--n_epochs", "1",
              "--n_epochs_decay", "0", "--checkpoints_dir", str(tmp_path), "--print_freq", "1",
              "--image_size", "32", "--batch_size", "4"] + QAT_CLI[mode])
    ck = str(tmp_path / "feature2face" / "ckpt")
    st = ckpt.load_checkpoint(ck)
    assert st["qat_mode"] == ("fq" if mode == "qat" else "fq8")
    quantize = mode != "qat"
    p = serve.Predictor(max_audio_seconds=1.0, device="cpu", results_dir=str(tmp_path))
    p.setup("Synthetic", image_size=32, f2f_ckpt=ck, quantize=quantize)
    g = p._models.feature2face
    assert not f2f.is_qat_generator(g)
    if not quantize:
        for k, v in g.state_dict().items():
            assert torch.equal(v, st["models"]["G"][k].to(v.dtype)), k
    t = np.arange(16000) / 16000.0
    res = p.predict((0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32), write_video=False)
    assert res.frames.shape == (45, 32, 32, 3) and res.frames.std() > 0


# ---------------------------------------------------------------------------
# training on a subject's clips
# ---------------------------------------------------------------------------

REAL_CLIPS = (("c0", 800, 0, False), ("c1", 80, 1, True))  # name, frames, seed, face


@pytest.fixture(scope="module")
def real_subject(tmp_path_factory):
    """A synth_subject root at 32 px: c0, 800 frames of motion (no frame
    store: what the motion models train on), c1, 80 frames with a face;
    build_person_pack's mean_pts3d.npy and candidates, the candidates
    copied into c1 as the reference keeps them per clip; then the four
    trainers through the CLI on it at the default widths."""
    base = tmp_path_factory.mktemp("real")
    root, out = base / "Person", base / "ck"
    for name, n, seed, face in REAL_CLIPS:
        synth_subject.write_raw_clip(str(root), name, n, seed=seed, image_size=32,
                                     with_face=face, device="cpu")
    build_person.build_person_pack(str(root), ["c0", "c1"], apc=None, image_size=32)
    shutil.copytree(root / "candidates", root / "c1" / "candidates")
    common = ["--device", "cpu", "--n_epochs", "1", "--n_epochs_decay", "0",
              "--checkpoints_dir", str(out), "--print_freq", "1", "--dataroot", str(root)]
    apc_dir = str(out / "apc" / "ckpt")
    for task, extra in (
            ("apc", ["--clip_names", "c0,c1", "--mel_window", "60", "--batch_size", "4"]),
            ("audio2feature", ["--clip_names", "c0", "--apc_ckpt", apc_dir,
                               "--sequence_length", "32", "--batch_size", "64"]),
            ("audio2headpose", ["--clip_names", "c0", "--apc_ckpt", apc_dir,
                                "--time_frame_length", "8", "--batch_size", "16"]),
            ("feature2face", ["--clip_names", "c1", "--image_size", "32",
                              "--batch_size", "4", "--qat_int8"])):
        cli.main(["--task", task] + common + extra)
    return root, out


@pytest.mark.parametrize("task", ["apc", "audio2feature", "audio2headpose", "feature2face"])
def test_cli_trains_each_task_on_a_subjects_clips(real_subject, task):
    root, out = real_subject
    assert ckpt.latest_step(str(out / task / "ckpt")) == 1
    losses = _val_column(out / task / "scalars.csv", "loss_G" if task == "feature2face" else
                         "loss")
    assert losses and all(np.isfinite(losses))
    if task == "audio2feature":  # the features of the APC run's encoder, cached
        from livespeechportraits_torch.models import apc as apc_model
        from livespeechportraits_torch.train import data_io

        enc = apc_model.load_pretrained_encoder(str(out / "apc" / "ckpt"), APCConfig(),
                                                device="cpu")
        cache = root / "c0" / f"c0_APC_feature_torch_{data_io._params_digest(enc)}.npy"
        feats = np.load(cache)
        assert feats.shape[1] == 512 and abs(feats.shape[0] - 2 * 800) <= 2  # 120 Hz rows


def test_predictor_serves_the_four_checkpoints_trained_on_a_subject(real_subject, tmp_path):
    _, out = real_subject
    ckpts = {f"{s}_ckpt": str(out / task / "ckpt") for s, task in
             (("f2f", "feature2face"), ("a2f", "audio2feature"), ("a2h", "audio2headpose"),
              ("apc", "apc"))}
    p = serve.Predictor(max_audio_seconds=1.0, device="cpu", results_dir=str(tmp_path))
    p.setup("Synthetic", image_size=32, quantize=True, **ckpts)
    t = np.arange(16000) / 16000.0
    res = p.predict((0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32), write_video=False)
    assert res.frames.shape == (45, 32, 32, 3) and res.frames.std() > 0
