"""PyTorch port, subject onboarding on the CPU: synth_subject's raw clips,
build_person_pack, load_person, load_person_models and a built subject
through animate() and the Predictor, against the JAX package on the same
clips and weights.  Clips of at most 120 frames at 64 px, models at test
widths (the Predictor's at the YAML's full width, rendered at 64 px)."""

import dataclasses
import io
import os
import shutil

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from livespeechportraits_tpu import config as jconfig
from livespeechportraits_tpu.models import apc as japc
from livespeechportraits_tpu.models import audio2feature as ja2f
from livespeechportraits_tpu.models import audio2headpose as ja2h
from livespeechportraits_tpu.models import feature2face as jf2f
from livespeechportraits_tpu.pipeline import animate as janimate
from livespeechportraits_tpu.pipeline import assets as jassets
from livespeechportraits_tpu.pipeline import build_person as jbuild
from livespeechportraits_tpu.pipeline import synth_subject as jsynth
from livespeechportraits_tpu.utils import torch_convert
from livespeechportraits_torch import config as tconfig
from livespeechportraits_torch import serve
from livespeechportraits_torch.models import (apc, audio2feature, audio2headpose, feature2face,
                                              wavenet)
from livespeechportraits_torch.pipeline import animate, assets, build_person, synth_subject
from livespeechportraits_torch.train import data_io
from livespeechportraits_torch.utils import h5vlen
from livespeechportraits_torch.utils.convert import params_from_jax
from torch_parity import jax_headpose_noise, small_person_config, to_np, torch_config

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the test workers share the machine's cores, and
    a BLAS free to pick its thread count by load may split a reduction
    differently from run to run (the bitwise comparisons here)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SIZE = 64
CLIPS = (("clip1", 120, 0, True), ("clip2", 80, 1, False))  # name, frames, seed, face


def _write(writer, root, **kw):
    for name, n, seed, face in CLIPS:
        writer(str(root), name, n, seed=seed, image_size=SIZE, with_face=face, **kw)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """The same two raw clips written by each package."""
    base = tmp_path_factory.mktemp("clips")
    _write(jsynth.write_raw_clip, base / "jax")
    _write(synth_subject.write_raw_clip, base / "port", device="cpu")
    return base / "jax", base / "port"


def _h5_frames(path, key):
    with h5py.File(path, "r") as f:
        return np.stack([np.asarray(Image.open(io.BytesIO(f[key][i].tobytes())))
                         for i in range(len(f[key]))])


def test_write_raw_clip_matches_jax(clips):
    """Every file of each clip: the same names; arrays within 1e-5 (the 2D
    landmarks within 1e-4 px: the projection runs in another framework);
    the wav equal; the h5 frames (read by h5py) within one level on at
    least 99.9 % of the values (the port blurs with scipy, JAX with cv2:
    the same kernel, rounded otherwise, then JPEG)."""
    jroot, troot = clips
    for name, n, _, face in CLIPS:
        files = sorted(os.listdir(jroot / name))
        assert sorted(os.listdir(troot / name)) == files
        for f in files:
            a, b = jroot / name / f, troot / name / f
            if f.endswith(".npy"):
                tol = 1e-4 if f.startswith("tracked2D") else 1e-5
                np.testing.assert_allclose(np.load(b), np.load(a), atol=tol)
            elif f.endswith(".npz"):
                za, zb = np.load(a), np.load(b)
                assert sorted(za.files) == sorted(zb.files)
                for k in za.files:
                    assert za[k].dtype == zb[k].dtype
                    np.testing.assert_allclose(zb[k], za[k], atol=1e-5)
            elif f.endswith(".wav"):
                assert a.read_bytes() == b.read_bytes()
        if face:
            fa, fb = _h5_frames(jroot / name / f"{name}.h5", name), \
                _h5_frames(troot / name / f"{name}.h5", name)
            assert fa.shape == fb.shape == (n, SIZE, SIZE, 3)
            d = np.abs(fa.astype(int) - fb.astype(int))
            assert (d <= 1).mean() >= 0.999, (d.max(), (d > 1).mean())


def test_h5vlen_and_h5py_read_each_others_stores(clips, tmp_path):
    """The port's h5 store is read by h5py, and the port reads h5py's (the
    JAX clip's) byte for byte."""
    jroot, troot = clips
    with h5py.File(jroot / "clip1" / "clip1.h5", "r") as f:
        theirs = [f["clip1"][i].tobytes() for i in range(len(f["clip1"]))]
    assert h5vlen.read(str(jroot / "clip1" / "clip1.h5"), "clip1") == theirs
    assert h5vlen.length(str(jroot / "clip1" / "clip1.h5"), "clip1") == 120
    assert h5vlen.read(str(jroot / "clip1" / "clip1.h5"), "clip1", [7, 7, 3]) == \
        [theirs[7], theirs[7], theirs[3]]
    items = [b"", b"x" * 5000] + theirs[:3]
    h5vlen.write(str(tmp_path / "s.h5"), "s", items)
    with h5py.File(tmp_path / "s.h5", "r") as f:
        assert [f["s"][i].tobytes() for i in range(len(f["s"]))] == items
    with pytest.raises(KeyError):
        h5vlen.read(str(tmp_path / "s.h5"), "t")


APC_CFG = jconfig.APCConfig(hidden_size=32, num_layers=2)


def _apc_pair():
    params = to_np(japc.init_apc(jax.random.PRNGKey(3), APC_CFG))
    model = apc.APCEncoder(torch_config(APC_CFG)).eval().requires_grad_(False)
    model.load_state_dict(params_from_jax(params), strict=True)
    return params, model


@pytest.fixture(scope="module")
def packs(clips, tmp_path_factory):
    """JAX's clips built into a pack by each package (bank_stride 2)."""
    jroot, _ = clips
    base = tmp_path_factory.mktemp("packs")
    params, model = _apc_pair()
    roots = []
    for who, build in (("jax", lambda r: jbuild.build_person_pack(r, ["clip1", "clip2"],
                                                                  apc_params=params,
                                                                  image_size=SIZE,
                                                                  bank_stride=2)),
                       ("port", lambda r: build_person.build_person_pack(
                           r, ["clip1", "clip2"], apc=model, image_size=SIZE, bank_stride=2))):
        root = base / who / "NewFace"
        shutil.copytree(jroot, root)
        build(str(root))
        roots.append(root)
    return tuple(roots)


def test_build_person_pack_matches_jax(packs):
    """The bank within 1e-4 (the GRU in another framework); every other file
    equal, the candidate JPEGs byte for byte; the YAML the same text, read
    back the same by both packages."""
    jroot, troot = packs
    names = sorted(p for p in os.listdir(jroot) if not os.path.isdir(jroot / p)
                   or p == "candidates")
    assert sorted(p for p in os.listdir(troot) if not os.path.isdir(troot / p)
                  or p == "candidates") == names
    bank_j, bank_t = np.load(jroot / "APC_feature_base.npy"), np.load(troot / "APC_feature_base.npy")
    assert bank_t.shape == bank_j.shape == (199, 32)  # (240 + 158) mel rows, stride 2
    np.testing.assert_allclose(bank_t, bank_j, atol=1e-4)
    for f in names:
        if f.endswith(".npy") and f != "APC_feature_base.npy":
            np.testing.assert_array_equal(np.load(troot / f), np.load(jroot / f))
        elif f.endswith(".npz"):
            za, zb = np.load(jroot / f), np.load(troot / f)
            for k in za.files:
                np.testing.assert_array_equal(zb[k], za[k])
    for j in range(4):
        c = f"candidates/normalized_full_{j}.jpg"
        assert (troot / c).read_bytes() == (jroot / c).read_bytes()
    yj, yt = (root / "NewFace.yaml" for root in (jroot, troot))
    assert yt.read_text() == yj.read_text().replace(str(jroot), str(troot))
    ours, ref = tconfig.load_person_config(str(yt)), jconfig.load_person_config(str(yt))
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.data_root == str(troot) + "/"


def test_build_keeps_hand_picked_candidates_and_the_camera_fallback(clips, tmp_path):
    """Existing candidates are kept; with no clip camera a pinhole at the
    serving size is synthesised, as in JAX."""
    jroot, _ = clips
    root = tmp_path / "P"
    shutil.copytree(jroot, root)
    for name, *_ in CLIPS:
        os.remove(root / name / "camera_intrinsic.npy")
    (root / "candidates").mkdir()
    for j in range(4):
        Image.fromarray(np.full((8, 8, 3), j, np.uint8)).save(
            root / "candidates" / f"normalized_full_{j}.jpg")
    manifest = build_person.build_person_pack(str(root), ["clip1", "clip2"], image_size=SIZE)
    assert manifest["candidates/"] == "kept existing"
    assert manifest["camera_intrinsic.npy"] == "SYNTHESIZED pinhole fallback"
    assert manifest["APC_feature_base.npy"].startswith("SKIPPED")
    np.testing.assert_array_equal(np.load(root / "camera_intrinsic.npy"),
                                  synth_subject.camera_matrix(SIZE))


def test_load_person_matches_jax(packs):
    """Every field of the port's load_person equals JAX's on the same pack
    (id_scale.mat absent: scale 1.0); image_size strides the 512 px
    candidates down to the pack's own size."""
    _, troot = packs
    cfg = small_person_config(image_size=SIZE)
    cfg = dataclasses.replace(cfg, data_root=str(troot))
    ref = jassets.load_person(cfg)
    ours = assets.load_person(torch_config(cfg))
    for f in dataclasses.fields(ref):
        a, b = getattr(ref, f.name), getattr(ours, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(b, a, err_msg=f.name)
        else:
            assert a == b, f.name
    assert ours.scale == 1.0 and ours.candidate_images.shape == (4, 512, 512, 3)
    small = assets.load_person(torch_config(cfg), image_size=SIZE)
    np.testing.assert_array_equal(small.candidate_images, ref.candidate_images[:, ::8, ::8])
    with pytest.raises(ValueError, match="whole stride"):
        assets.load_person(torch_config(cfg), image_size=48)


def _tiny_cfg(size="normal", loss="L2", ncenter=1):
    cfg = small_person_config(image_size=SIZE)
    return dataclasses.replace(
        cfg,
        audio2feature=dataclasses.replace(cfg.audio2feature, loss=loss, gmm_ncenter=ncenter),
        feature2face=dataclasses.replace(cfg.feature2face, size=size))


def _save_jax_pkls(cfg, tmp_path, seed=0):
    """The four JAX models exported as reference .pkl files (the
    Audio2Feature one with DataParallel "module." prefixes) -> (params,
    cfg naming the paths)."""
    k = jax.random.split(jax.random.PRNGKey(seed), 4)
    params = {"apc": japc.init_apc(k[0], cfg.apc),
              "a2f": ja2f.init_audio2feature(k[1], cfg.audio2feature),
              "a2h": ja2h.init_audio2headpose(k[2], cfg.audio2headpose),
              "f2f": jf2f.init_generator(k[3], cfg.feature2face)}
    sds = {"apc": torch_convert.export_apc(params["apc"]),
           "a2f": torch_convert.export_audio2feature(params["a2f"]),
           "a2h": torch_convert.export_audio2headpose(params["a2h"]),
           "f2f": torch_convert.export_feature2face_g(params["f2f"])}
    sds["a2f"] = {"module." + key: v for key, v in sds["a2f"].items()}
    paths = {}
    for name, sd in sds.items():
        paths[name] = str(tmp_path / f"{name}.pkl")
        torch_convert.save_state_dict_torch(sd, paths[name])
    r = dataclasses.replace
    cfg = r(cfg, apc=r(cfg.apc, ckpt_path=paths["apc"]),
            audio2feature=r(cfg.audio2feature, ckpt_path=paths["a2f"]),
            audio2headpose=r(cfg.audio2headpose, ckpt_path=paths["a2h"]),
            feature2face=r(cfg.feature2face, ckpt_path=paths["f2f"]))
    return params, cfg


@pytest.mark.parametrize("size,loss,ncenter", [("normal", "L2", 1), ("small", "GMM", 3)])
def test_load_person_models_reads_jax_pkls(tmp_path, size, loss, ncenter):
    """.pkl files from JAX's export_* + save_state_dict_torch load with
    strict=True, and each model's forward matches JAX's within 1e-5."""
    params, cfg = _save_jax_pkls(_tiny_cfg(size, loss, ncenter), tmp_path)
    m = assets.load_person_models(torch_config(cfg), device="cpu")
    rng = np.random.default_rng(1)
    mel = rng.standard_normal((1, 30, 80)).astype(np.float32)
    feats = rng.standard_normal((1, 30, 32)).astype(np.float32)
    history = rng.standard_normal((1, 20, 12)).astype(np.float32)
    paired = rng.standard_normal((1, 20, 64)).astype(np.float32)
    img = rng.uniform(-1, 1, (1, 32, 32, cfg.feature2face.input_nc)).astype(np.float32)
    with torch.no_grad():
        np.testing.assert_allclose(
            apc.apply_apc(m.apc, torch.tensor(mel)).numpy(),
            np.asarray(japc.apply_apc(params["apc"], jnp.asarray(mel))), atol=1e-5)
        np.testing.assert_allclose(
            audio2feature.apply_audio2feature(m.audio2feature, torch.tensor(feats)).numpy(),
            np.asarray(ja2f.apply_audio2feature(params["a2f"], jnp.asarray(feats))[0]),
            atol=1e-5)
        cond = audio2headpose._audio_downsample(m.audio2headpose, torch.tensor(paired))
        pose = wavenet.forward(m.audio2headpose.WaveNet, torch.tensor(history), cond)
        ref, _ = ja2h.apply_audio2headpose(params["a2h"], cfg.audio2headpose,
                                           jnp.asarray(history), jnp.asarray(paired),
                                           output_length=5)
        np.testing.assert_allclose(pose[:, -5:].numpy(), np.asarray(ref), atol=1e-5)
        y = feature2face.apply_generator(
            feature2face.cast_generator(m.feature2face, torch.float32), torch.tensor(img))
    np.testing.assert_allclose(y.numpy(), np.asarray(jf2f.apply_generator(
        params["f2f"], jnp.asarray(img))[0]), atol=1e-5)


def test_load_person_models_random_init_and_bad_paths(tmp_path, capsys):
    """An empty ckpt_path keeps the seed-0 random init with JAX's printed
    note; a path that does not load raises."""
    cfg = torch_config(_tiny_cfg())
    m = assets.load_person_models(cfg, device="cpu")
    assert "no torch checkpoint configured for APC, Audio2Feature, Audio2Headpose, " \
           "Feature2Face; random-init" in capsys.readouterr().out
    ref = assets.init_models(cfg, 0)
    for name in assets.MODEL_FIELDS:
        for (k, a), b in zip(getattr(m, name).state_dict().items(),
                             getattr(ref, name).state_dict().values()):
            assert torch.equal(a, b), (name, k)
    bad = dataclasses.replace(cfg, apc=dataclasses.replace(cfg.apc,
                                                           ckpt_path=str(tmp_path / "none")))
    with pytest.raises(FileNotFoundError):
        assets.load_person_models(bad, device="cpu")


def test_built_pack_animates_like_jax(packs):
    """The port's pack through the port's animate() and JAX's pack through
    JAX's, on the same models (test widths) and head-pose noise: landmarks
    within the slice's 1e-3 px, frames within one level (f32 renderer)."""
    jroot, troot = packs
    cfg = dataclasses.replace(small_person_config(image_size=SIZE), data_root=str(jroot))
    cfg = dataclasses.replace(cfg, apc=APC_CFG)
    j_assets = jassets.load_person(cfg)
    j_assets.candidate_images = j_assets.candidate_images[:, ::8, ::8]
    k = jax.random.split(jax.random.PRNGKey(4), 4)
    j_models = jassets.PersonModels(
        apc=_apc_pair()[0],
        audio2feature=ja2f.init_audio2feature(k[1], cfg.audio2feature),
        audio2headpose=ja2h.init_audio2headpose(k[2], cfg.audio2headpose),
        feature2face=jf2f.init_generator(k[3], cfg.feature2face))
    audio = synth_subject.make_audio(synth_subject.envelope(60, 5), 5)
    ref = janimate.animate(cfg, j_assets, j_models, audio, seed=3)
    tcfg = torch_config(dataclasses.replace(cfg, data_root=str(troot)))
    person = assets.load_person(tcfg, image_size=SIZE)
    models = assets.from_jax(tcfg, j_models, device="cpu")
    noise = jax_headpose_noise(3, ref.nframe, cfg.audio2headpose.ncenter,
                               cfg.audio2headpose.ndim)
    ours = animate.animate(tcfg, person, models, audio, seed=3, headpose_noise=noise)
    assert ours.nframe == ref.nframe == 45
    np.testing.assert_allclose(ours.landmarks, ref.landmarks, atol=1e-3)
    d = np.abs(ours.frames.astype(int) - np.asarray(ref.frames).astype(int))
    assert d.max() <= 1


def _full_cfg(size="normal", loss="L2", ncenter=1):
    """The default PersonConfig with the given head and generator, rendered
    at 64 px: what the Predictor reads from the subject's YAML."""
    r = dataclasses.replace
    cfg = tconfig.PersonConfig()
    return r(cfg, audio2feature=r(cfg.audio2feature, loss=loss, gmm_ncenter=ncenter),
             feature2face=r(cfg.feature2face, size=size, n_downsample=6, load_size=SIZE))


@pytest.fixture(scope="module")
def served_pack(clips, tmp_path_factory):
    """The port's clips built by the port with the full-width APC of the
    seed-7 models the Predictor tests serve."""
    _, troot = clips
    root = tmp_path_factory.mktemp("served") / "NewFace"
    shutil.copytree(troot, root)
    build_person.build_person_pack(str(root), ["clip1", "clip2"],
                                   apc=assets.init_models(_full_cfg(), 7).apc, image_size=SIZE)
    return root


def _subject(root, tmp_path, size="normal", loss="L2", ncenter=1):
    """A YAML naming the pack at ``root`` and the port's own seed-7 models
    at full width, saved as reference .pkl files (the APC one with
    DataParallel "module." prefixes) -> the models."""
    models = assets.init_models(_full_cfg(size, loss, ncenter), 7)
    build_person.write_person_yaml(str(tmp_path / "NewFace.yaml"), str(root), size=size)
    doc = yaml.safe_load((tmp_path / "NewFace.yaml").read_text())
    mp = doc["model_params"]
    for key, name in (("APC", "apc"), ("Audio2Mouth", "audio2feature"),
                      ("Headpose", "audio2headpose"), ("Image2Image", "feature2face")):
        path = str(tmp_path / f"{name}.pkl")
        sd = getattr(models, name).state_dict()
        if name == "apc":
            sd = {"module." + k: v for k, v in sd.items()}
        torch.save(sd, path)
        mp[key]["ckp_path"] = path
    mp["Audio2Mouth"].update(loss=loss, gmm_ncenter=ncenter)
    (tmp_path / "NewFace.yaml").write_text(yaml.safe_dump(doc))
    return models


@pytest.mark.parametrize("size,loss,ncenter", [("normal", "L2", 1), ("small", "L2", 1),
                                               ("normal", "GMM", 3)])
def test_predictor_serves_a_built_subject(served_pack, tmp_path, size, loss, ncenter):
    """Predictor(device="cpu").setup(<built subject>) reads the pack and its
    .pkl checkpoints into the models saved (equal tensors) and predicts; for
    the L2 'normal' subject the frames equal animate()'s on the same models
    built in memory (bitwise: the CPU, bucketing exact).  A 'small' subject
    refuses quantize=True with JAX's reason."""
    troot = served_pack
    models = _subject(troot, tmp_path, size, loss, ncenter)
    p = serve.Predictor(device="cpu")
    p.setup(person_id="NewFace", config_dir=str(tmp_path), image_size=SIZE)
    assert p._cfg.data_root == str(troot) + "/" and p._cfg.feature2face.size == size
    assert p._cfg.audio2feature.loss == loss
    cast = dataclasses.replace(models, feature2face=feature2face.cast_generator(
        models.feature2face, torch.bfloat16))
    for name in assets.MODEL_FIELDS:
        got_sd, want_sd = (getattr(m, name).state_dict() for m in (p._models, cast))
        assert got_sd.keys() == want_sd.keys()
        assert all(torch.equal(got_sd[k], want_sd[k]) for k in got_sd), name
    audio = synth_subject.make_audio(synth_subject.envelope(72, 2), 2)
    got = p.predict(audio, transfer="rgb", write_video=False)
    assert got.frames.shape == (72 - 15, SIZE, SIZE, 3) and got.frames.std() > 0
    if size == "normal" and loss == "L2":
        person = assets.load_person(p._cfg, image_size=SIZE)
        want = animate.animate(p._cfg, person, models, audio, render_batch=16)
        np.testing.assert_array_equal(got.frames, want.frames)
    if size == "small":
        with pytest.raises(NotImplementedError, match="ConvTranspose"):
            serve.Predictor(device="cpu").setup(person_id="NewFace", config_dir=str(tmp_path),
                                                image_size=SIZE, quantize=True)


def test_compute_apc_features_matches_jax(clips):
    """wav -> mel -> APC on the port (plain GRU on the CPU) within 1e-4 of
    JAX's compute_apc_features."""
    from livespeechportraits_tpu.train import data_io as jdata_io

    params, model = _apc_pair()
    audio = synth_subject.make_audio(synth_subject.envelope(50, 1), 1)
    ours = data_io.compute_apc_features(audio, model)
    ref = np.asarray(jdata_io.compute_apc_features(audio, params))
    assert ours.shape == ref.shape == (98, 32)  # 13333 samples: 49 frames
    np.testing.assert_allclose(ours, ref, atol=1e-4)


def test_entry_points_default_to_the_card():
    import inspect

    for fn in (assets.load_person_models, assets.load_subject, synth_subject.write_raw_clip,
               synth_subject.render_clip_frames, synth_subject.project_clip):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__


def test_onboarding_tool_then_demo(tmp_path, monkeypatch, capsys):
    """python -m livespeechportraits_torch.tools.build_person --synth writes
    synthetic clips and builds the pack with the seed-0 random APC; the demo
    then serves that subject by its id (full-width models, 32 px)."""
    from livespeechportraits_torch import demo
    from livespeechportraits_torch.tools import build_person as tool

    monkeypatch.chdir(tmp_path)
    tool.main(["--dataroot", "data/NewFace", "--clip_names", "clip1,clip2", "--synth", "0.5",
               "--image_size", "32", "--apc_random", "--device", "cpu"])
    assert np.load("data/NewFace/APC_feature_base.npy").shape == (120, 512)
    demo.main(["--id", "NewFace", "--config_dir", "data/NewFace", "--device", "cpu",
               "--image_size", "32", "--driving_audio", "data/NewFace/clip1/clip1.wav",
               "--results_dir", "out"])
    out = capsys.readouterr().out
    assert "pack written to data/NewFace" in out and "15 frames" in out
    assert os.listdir(tmp_path / "out" / "NewFace" / "clip1")
