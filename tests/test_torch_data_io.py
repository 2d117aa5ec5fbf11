"""PyTorch port, the trainers' real-data ingestion (train/data_io.py):
prepare_clip's feature cache and its digest, LazyH5Frames, load_face_clip
and ConcatFaceSampler, against the JAX package's data_io on the same clips
(two synth_subject clips of 80-90 frames at 64 px, written by the port and
read by both: h5py reads utils/h5vlen's stores), and utils/h5vlen's
memory-mapped Reader."""

import io
import os
import shutil

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from livespeechportraits_tpu.config import APCConfig
from livespeechportraits_tpu.models import apc as japc
from livespeechportraits_tpu.train import data_io as jdata_io
from livespeechportraits_tpu.train import datasets as jdatasets
from livespeechportraits_torch.models import apc
from livespeechportraits_torch.pipeline import synth_subject, video
from livespeechportraits_torch.train import data_io, datasets
from livespeechportraits_torch.utils import h5vlen
from livespeechportraits_torch.utils.convert import params_from_jax
from torch_parity import to_np, torch_config


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: a BLAS free to pick its thread count by load may
    split a reduction differently from run to run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SIZE = 64
CLIPS = (("c0", 90, 0), ("c1", 80, 1))  # name, frames, seed
APC_CFG = APCConfig(hidden_size=16, num_layers=2)
# wav -> mel -> APC, the plain GRU loop against JAX's (test_torch_subject.py)
APC_TOL = 1e-4


@pytest.fixture(scope="module")
def subject(tmp_path_factory):
    """A subject root with two raw clips with faces, the subject's
    mean_pts3d.npy and four candidate frames (full_{j}.jpg) in each clip."""
    root = tmp_path_factory.mktemp("subject") / "Person"
    rng = np.random.default_rng(5)
    tracked = []
    for name, n, seed in CLIPS:
        gt = synth_subject.write_raw_clip(str(root), name, n, seed=seed, image_size=SIZE,
                                          device="cpu")
        tracked.append(gt["pts3d"])
        os.makedirs(root / name / "candidates")
        for j in range(4):
            Image.fromarray(rng.integers(0, 255, (SIZE, SIZE, 3), dtype=np.uint8)).save(
                str(root / name / "candidates" / f"full_{j}.jpg"))
    np.save(root / "mean_pts3d.npy", np.concatenate(tracked).mean(axis=0).astype(np.float32))
    return root


def _copy(subject, tmp_path, tag: str):
    """A fresh copy of the subject (no caches written in it yet)."""
    dst = tmp_path / tag / "Person"
    shutil.copytree(subject, dst)
    return dst


def _encoders(seed: int):
    params = to_np(japc.init_apc(jax.random.PRNGKey(seed), APC_CFG))
    model = apc.APCEncoder(torch_config(APC_CFG)).eval().requires_grad_(False)
    model.load_state_dict(params_from_jax(params), strict=True)
    return params, model


def test_prepare_clip_matches_jax_and_caches_under_the_encoders_digest(subject, tmp_path,
                                                                       monkeypatch):
    root = _copy(subject, tmp_path, "port")
    jroot = _copy(subject, tmp_path, "jax")
    params, enc = _encoders(3)
    clip = data_io.prepare_clip(str(root / "c0"), "c0", enc, torch_config(APC_CFG))
    ref = jdata_io.prepare_clip(str(jroot / "c0"), "c0", params, APC_CFG)
    assert clip.audio_features.shape == ref.audio_features.shape == (180, 16)
    np.testing.assert_allclose(clip.audio_features, ref.audio_features, atol=APC_TOL)
    for k in ("pts3d", "headpose", "velocity"):
        np.testing.assert_array_equal(getattr(clip, k), getattr(ref, k))
    caches = sorted(p.name for p in (root / "c0").glob("c0_APC_feature_*.npy"))
    assert len(caches) == 1 and caches[0].startswith("c0_APC_feature_torch_")
    # a JAX cache of the same clip is never read as the port's (its own tag)
    shutil.copy(next((jroot / "c0").glob("c0_APC_feature_tpu_*.npy")), root / "c0")
    # the second call reads the cache
    monkeypatch.setattr(data_io, "compute_apc_features",
                        lambda *a, **k: pytest.fail("the cache was not read"))
    again = data_io.prepare_clip(str(root / "c0"), "c0", enc, torch_config(APC_CFG))
    np.testing.assert_array_equal(again.audio_features, clip.audio_features)
    monkeypatch.undo()
    # another encoder writes its own file
    _, other = _encoders(4)
    changed = data_io.prepare_clip(str(root / "c0"), "c0", other, torch_config(APC_CFG))
    assert len(list((root / "c0").glob("c0_APC_feature_torch_*.npy"))) == 2
    assert np.abs(changed.audio_features - clip.audio_features).max() > 0
    assert data_io._params_digest(enc) != data_io._params_digest(other)
    assert data_io._params_digest(enc) == data_io._params_digest(_encoders(3)[1])


def test_prepare_clip_reads_the_denoised_wav_and_a_given_mean(subject, tmp_path):
    """The denoised wav is taken before the plain one beside it, and the
    points are taken about the subject's mean_pts3d.npy."""
    root = _copy(subject, tmp_path, "den")
    _, enc = _encoders(3)
    cfg = torch_config(APC_CFG)
    plain = video.load_wav(str(root / "c1" / "c1.wav"))
    video.save_wav(str(root / "c1" / "c1_denoise.wav"), 0.5 * plain)
    mean = np.full((73, 3), 0.25, np.float32)
    np.save(root / "mean_pts3d.npy", mean)
    clip = data_io.prepare_clip(str(root / "c1"), "c1", enc, cfg)
    np.testing.assert_array_equal(
        clip.audio_features,
        data_io.compute_apc_features(video.load_wav(str(root / "c1" / "c1_denoise.wav")), enc))
    assert np.abs(clip.audio_features - data_io.compute_apc_features(plain, enc)).max() > 0
    np.testing.assert_array_equal(
        clip.pts3d, np.load(root / "c1" / "tracked3D_normalized_pts_fix_contour.npy") - mean)


def test_lazy_frames_equal_the_eager_read_and_jax(subject, tmp_path):
    """Frames decoded on access equal an eager read of the store (h5py, each
    JPEG decoded and normalised) and JAX's LazyH5Frames bit for bit, through
    an LRU that holds the last CACHE_FRAMES of them."""
    import h5py

    root = _copy(subject, tmp_path, "lazy")
    path = str(root / "c0" / "c0.h5")
    norm = data_io.make_change_paras_normalise(str(root / "c0"))
    lazy = data_io.LazyH5Frames(path, "c0", norm)
    ref = jdata_io.LazyH5Frames(path, "c0", jdata_io.make_change_paras_normalise(str(root / "c0")))
    with h5py.File(path, "r") as f:
        eager = np.stack([norm(np.asarray(Image.open(io.BytesIO(bytes(b))))) for b in f["c0"]])
    assert len(lazy) == 90 and lazy.shape == eager.shape == (90, 512, 512, 3)
    for i in (0, 7, 89, -1, 7):
        np.testing.assert_array_equal(lazy[i], ref[i])
        np.testing.assert_array_equal(lazy[i], eager[i])
    for i in range(90):
        np.testing.assert_array_equal(lazy[i], eager[i])
    assert list(lazy._cache) == list(range(90 - data_io.CACHE_FRAMES, 90))
    with pytest.raises(IndexError):
        lazy[90]
    lazy.close()
    np.testing.assert_array_equal(lazy[3], ref[3])  # maps the store again


def test_load_face_clip_batches_equal_jax(subject, tmp_path):
    """The sampler's batches from one np.random.Generator equal JAX's on the
    same clip; the candidates are normalised, cached as JPEGs and read back
    on the first run as on every later one."""
    root = _copy(subject, tmp_path, "port")
    jroot = _copy(subject, tmp_path, "jax")
    ours = data_io.load_face_clip(str(root / "c0"), "c0", load_size=SIZE)
    ref = jdata_io.load_face_clip(str(jroot / "c0"), "c0", load_size=SIZE)
    assert os.path.exists(root / "c0" / "candidates" / "normalized_full_3.jpg")
    np.testing.assert_array_equal(ours.candidates, ref.candidates)
    later = data_io.load_face_clip(str(root / "c0"), "c0", load_size=SIZE)
    np.testing.assert_array_equal(later.candidates, ours.candidates)
    assert len(ours) == len(ref) == 31 and not ours.emit_weight_mask
    b_ours = list(ours.batches(8, np.random.default_rng(7)))
    b_ref = list(ref.batches(8, np.random.default_rng(7)))
    assert len(b_ours) == len(b_ref) == 3
    for a, b in zip(b_ours, b_ref):
        assert a.keys() == b.keys() and "weight_mask" not in a
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_concat_face_sampler_spans_the_clips_as_jax(subject, tmp_path):
    root = _copy(subject, tmp_path, "port")
    jroot = _copy(subject, tmp_path, "jax")
    names = [name for name, _, _ in CLIPS]
    ours = datasets.ConcatFaceSampler([data_io.load_face_clip(str(root / n), n, load_size=SIZE)
                                       for n in names])
    ref = jdatasets.ConcatFaceSampler([jdata_io.load_face_clip(str(jroot / n), n,
                                                               load_size=SIZE) for n in names])
    assert len(ours) == len(ref) == 31 + 21  # (frames - 60) + 1 samples a clip
    first, second = ours.samplers
    np.testing.assert_array_equal(ours.sample(31)["tgt_image"], second.sample(0)["tgt_image"])
    np.testing.assert_array_equal(ours.sample(30)["tgt_image"], first.sample(30)["tgt_image"])
    for a, b in zip(ours.batches(8, np.random.default_rng(1)),
                    ref.batches(8, np.random.default_rng(1))):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_h5vlen_reader_reads_elements_as_read_does(subject):
    path = str(subject / "c1" / "c1.h5")
    r = h5vlen.Reader(path, "c1")
    try:
        assert len(r) == h5vlen.length(path, "c1") == 80
        assert [r[i] for i in (0, 40, 79)] == h5vlen.read(path, "c1", [0, 40, 79])
        with pytest.raises(IndexError):
            r[80]
    finally:
        r.close()
    with pytest.raises(KeyError, match="no dataset"):
        h5vlen.Reader(path, "c0")
