"""PyTorch port, the serving path: position-stable head-pose noise, length
bucketing, the yuv420 transfer, the serving artifact in both directions,
serve.Predictor and the HTTP server, against the JAX package where it has a
counterpart, at test widths on the CPU."""

import io
import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from livespeechportraits_tpu.models import feature2face as jf2f
from livespeechportraits_tpu.pipeline import animate as janimate
from livespeechportraits_tpu.pipeline import assets as jassets
from livespeechportraits_tpu.pipeline import compress as jcompress
from livespeechportraits_torch import serve, server
from livespeechportraits_torch.models import feature2face as f2f
from livespeechportraits_torch.ops import gmm
from livespeechportraits_torch.pipeline import animate, assets, compress, video
from livespeechportraits_torch.utils.convert import params_from_jax, params_to_jax
from torch_parity import jax_headpose_noise, small_person_config, to_np, torch_config

FIELDS = ("apc", "audio2feature", "audio2headpose", "feature2face")


def _chirp(seconds: float) -> np.ndarray:
    n = int(seconds * 16000)
    f = 120 + 400 * np.linspace(0, seconds, n)
    return (0.3 * np.sin(2 * np.pi * f * np.arange(n) / 16000)).astype(np.float32)


def _pad_to_bucket(audio: np.ndarray, bucket: int = 16000):
    return np.pad(audio, (0, -(-len(audio) // bucket) * bucket - len(audio)))


def _assert_trees_equal(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.fixture(scope="module")
def jax_person():
    """The synthetic subject at 64^2 and test widths, its JAX models, and
    the same models int8-quantized and calibrated by the JAX package."""
    cfg = small_person_config(image_size=64)
    j_assets, j_models = jassets.make_synthetic_person(cfg, key=jax.random.PRNGKey(5),
                                                       image_size=64)
    calib = janimate.build_render_inputs(cfg, j_assets, j_models, video.make_test_tone(1.0),
                                         max_frames=8)
    jq = jassets.quantize_person_models(j_models, calibrate_inputs=calib)
    return cfg, j_assets, j_models, jq


@pytest.mark.parametrize("n1,n2,ncenter,ndim", [(165, 225, 1, 12), (1, 60, 2, 12),
                                                (45, 46, 3, 7), (300, 600, 1, 12)])
def test_noise_is_position_stable(n1, n2, ncenter, ndim):
    """The draws of decode step i depend on (seed, i) alone: the first n1
    rows of both draws at length n2 equal the draws at length n1."""
    g1, e1 = gmm.draw_noise(n1, ncenter, ndim, 7)
    g2, e2 = gmm.draw_noise(n2, ncenter, ndim, 7)
    assert g1.shape == (n1, ncenter) and e1.shape == (n1, ndim)
    assert torch.equal(g1, g2[:n1]) and torch.equal(e1, e2[:n1])
    assert not torch.equal(e1, gmm.draw_noise(n1, ncenter, ndim, 8)[1])


@pytest.fixture
def one_thread():
    """One intra-op thread: a BLAS free to pick its thread count by load
    may split a reduction differently from run to run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("transfer", ["rgb", "yuv420"])
def test_bucketed_chirp_is_bitwise_exact(transfer, one_thread):
    """A bucket-padded run with valid_frames equals the exact-length run bit
    for bit on the CPU; a chirp, since a wrong feature repeat-pad (at the
    post-stage count) is invisible on stationary audio."""
    cfg = torch_config(small_person_config(image_size=32))
    person, models = assets.make_synthetic_person(cfg, image_size=32, device="cpu")
    audio = _chirp(0.9)
    exact = animate.animate(cfg, person, models, audio, seed=11, render_batch=4,
                            transfer=transfer)
    bucketed = animate.animate(cfg, person, models, _pad_to_bucket(audio), seed=11,
                               render_batch=4, transfer=transfer,
                               valid_frames=int(len(audio) / 16000 * 60))
    assert bucketed.nframe == exact.nframe == 54 - 15
    for k in ("landmarks", "headpose", "pts3d", "frames"):
        np.testing.assert_array_equal(getattr(bucketed, k), getattr(exact, k), err_msg=k)


def test_valid_frames_guard():
    cfg = torch_config(small_person_config(image_size=32))
    person, models = assets.make_synthetic_person(cfg, image_size=32, device="cpu")
    with pytest.raises(ValueError, match="must exceed the head-pose lookahead"):
        animate.compute_motion(cfg, person, models, _chirp(1.0), valid_frames=15)
    with pytest.raises(ValueError, match="unknown transfer 'bmp'"):
        animate.animate(cfg, person, models, _chirp(0.5), transfer="bmp")


def test_bucketed_int8_yuv420_animate_matches_jax(jax_person):
    """animate(valid_frames=, transfer='yuv420') on the int8 person: the
    JAX package against the port on JAX's quantized and calibrated models,
    with JAX's head-pose noise over the padded length.  Measured: landmarks
    1.1e-5 px, head pose 6.0e-8, 3D points 7.5e-9, frames equal.  Bounds:
    1e-4 px, 1e-6, 1e-7; frames at most 1 level apart, on under 0.1 % of
    the values (an activation at an int8 rounding edge may flip a step)."""
    cfg, j_assets, _, jq = jax_person
    tcfg = torch_config(cfg)
    person, _ = assets.make_synthetic_person(tcfg, image_size=64, skip_models=True,
                                             device="cpu")
    models = assets.from_jax(tcfg, jq, device="cpu")
    audio = _chirp(0.85)
    padded = _pad_to_bucket(audio)
    valid = int(len(audio) / 16000 * 60)
    ref = janimate.animate(cfg, j_assets, jq, padded, seed=2, transfer="yuv420",
                           valid_frames=valid)
    noise = jax_headpose_noise(2, 60 - cfg.audio2headpose.frame_future,
                               cfg.audio2headpose.ncenter, cfg.audio2headpose.ndim)
    ours = animate.animate(tcfg, person, models, padded, seed=2, transfer="yuv420",
                           valid_frames=valid, headpose_noise=noise)
    assert ours.nframe == ref.nframe == valid - 15
    assert ours.frames.shape == ref.frames.shape == (valid - 15, 64, 64, 3)
    np.testing.assert_allclose(ours.landmarks, ref.landmarks, atol=1e-4, rtol=0)
    np.testing.assert_allclose(ours.headpose, ref.headpose, atol=1e-6, rtol=0)
    np.testing.assert_allclose(ours.pts3d, ref.pts3d, atol=1e-7, rtol=0)
    diff = np.abs(ours.frames.astype(int) - ref.frames.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.001


def test_yuv420_pack_matches_jax():
    """The device pack against JAX's _rgb_to_yuv420_packed, bitwise."""
    img = np.random.default_rng(0).uniform(-1.05, 1.05, (3, 16, 24, 3)).astype(np.float32)
    ref = np.asarray(janimate._rgb_to_yuv420_packed(jnp.asarray(img)))
    ours = animate.rgb_to_yuv420_packed(torch.tensor(img))
    assert ours.dtype == torch.uint8 and ours.shape == (3, 16 * 24 * 3 // 2)
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_yuv420_unpack_matches_jax():
    """The host unpack and conversion (numpy, and the packed-buffer torch
    form) against JAX's numpy yuv420_to_rgb and compress.i420_to_rgb,
    bitwise."""
    packed = np.random.default_rng(1).integers(0, 256, (2, 8 * 12 * 3 // 2), dtype=np.uint8)
    ref = janimate.yuv420_to_rgb(*janimate.yuv420_unpack(packed, 8, 12))
    planes = compress.yuv420_unpack(packed, 8, 12)
    for a, b in zip(planes, janimate.yuv420_unpack(packed, 8, 12)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(compress.yuv420_to_rgb(*planes), ref)
    np.testing.assert_array_equal(compress.i420_to_rgb(torch.tensor(packed), 8, 12).numpy(), ref)
    np.testing.assert_array_equal(jcompress.i420_to_rgb(packed, 8, 12), ref)


@pytest.mark.parametrize("field", FIELDS + ("feature2face_int8",))
def test_params_to_jax_inverts_params_from_jax(jax_person, field):
    cfg, _, j_models, jq = jax_person
    tree = to_np(jq.feature2face if field == "feature2face_int8" else getattr(j_models, field))
    ported = assets.from_jax(torch_config(cfg), jq if field == "feature2face_int8" else j_models,
                             device="cpu")
    _assert_trees_equal(params_to_jax(getattr(ported, field.split("_")[0])), tree)


def test_artifact_written_by_the_port_boots_jax(jax_person, tmp_path):
    """The port saves an int8, calibrated person; JAX's
    load_models_artifact reads it to the same trees, and JAX's renderer on
    them matches the port's within 1e-7 (f32)."""
    cfg, _, _, jq = jax_person
    models = assets.from_jax(torch_config(cfg), jq, device="cpu")
    path = assets.save_models_artifact(models, str(tmp_path / "port.npz"))
    loaded = jassets.load_models_artifact(path)
    for name in FIELDS:
        _assert_trees_equal(to_np(getattr(loaded, name)), params_to_jax(getattr(models, name)))
    x = np.random.default_rng(2).uniform(-1, 1, (2, 64, 64, 13)).astype(np.float32)
    ref, _ = jf2f.apply_generator(loaded.feature2face, jnp.asarray(x))
    with torch.no_grad():
        ours = f2f.apply_generator(models.feature2face, torch.tensor(x)).numpy()
    np.testing.assert_allclose(ours, np.asarray(ref), atol=1e-7, rtol=0)


def test_artifact_marks_bf16_leaves(jax_person, tmp_path):
    """A cast (bf16) renderer is stored as float32 marked "dt": "bfloat16";
    JAX loads bf16 leaves with the same values, the port float32 ones."""
    cfg = torch_config(jax_person[0])
    jq = jax_person[3]
    models = assets.from_jax(cfg, jq, device="cpu")
    models.feature2face = f2f.cast_generator(models.feature2face, torch.bfloat16)
    path = assets.save_models_artifact(models, str(tmp_path / "bf16.npz"))
    up = jassets.load_models_artifact(path).feature2face["net"]["sub"]["up"]
    assert str(up["w_scale"].dtype) == "bfloat16" and up["w_q"].dtype == np.int8
    back = assets.load_models_artifact(path, cfg, device="cpu").feature2face.state_dict()
    for k, v in models.feature2face.state_dict().items():
        assert torch.equal(back[k].to(v.dtype), v), k


def test_artifact_written_by_jax_boots_the_port(jax_person, tmp_path):
    cfg, _, _, jq = jax_person
    path = jassets.save_models_artifact(jq, str(tmp_path / "jax.npz"))
    models = assets.load_models_artifact(path, torch_config(cfg), device="cpu")
    for name in FIELDS:
        _assert_trees_equal(params_to_jax(getattr(models, name)), to_np(getattr(jq, name)))
    sd = params_from_jax(to_np(jq.feature2face))
    assert any(k.endswith("x_scale") for k in sd)
    assert set(models.feature2face.state_dict()) == set(sd)


# ---------------------------------------------------------------------------
# serve.Predictor and the HTTP server, on the CPU at test widths
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def predictor(tmp_path_factory):
    """An int8, calibrated Predictor on the CPU at 32^2 and test widths,
    booted once to write its artifact and once from it."""
    art = str(tmp_path_factory.mktemp("art") / "model.npz")
    with pytest.MonkeyPatch.context() as mp:
        small = torch_config(small_person_config())
        mp.setattr(serve, "PersonConfig", lambda name="Synthetic": small)
        first = serve.Predictor(max_audio_seconds=1.0, device="cpu",
                                results_dir=str(tmp_path_factory.mktemp("srv0")))
        first.setup("Synthetic", image_size=32, quantize=True, artifact=art)
        p = serve.Predictor(max_audio_seconds=1.0, device="cpu",
                            results_dir=str(tmp_path_factory.mktemp("srv")))
        p.setup("Synthetic", image_size=32, artifact=art)
    p.first, p.artifact = first, art
    return p


def test_predictor_int8_and_artifact_boot(predictor, one_thread):
    audio = _chirp(0.8)
    a = predictor.first.predict(audio, write_video=False)
    b = predictor.predict(audio, write_video=False)
    assert a.nframe == b.nframe == 48 - 15
    np.testing.assert_array_equal(a.frames, b.frames)
    net = predictor._models.feature2face
    assert any(m.x_scale is not None for m in net.modules() if hasattr(m, "x_scale"))
    assert next(net.parameters()).dtype == torch.float32  # cast once, in setup


def test_predictor_cap_short_audio_and_frame_count(predictor, one_thread):
    assert predictor.predict(_chirp(1.5), write_video=False).nframe == 60 - 15  # 1 s cap
    assert predictor.predict(_chirp(0.7), write_video=False).nframe == 42 - 15
    with pytest.raises(ValueError, match="audio too short"):
        predictor.predict(_chirp(0.2), write_video=False)
    unbucketed = serve.Predictor(device="cpu", bucket_seconds=0)
    unbucketed._cfg, unbucketed._assets, unbucketed._models = (
        predictor._cfg, predictor._assets, predictor._models)
    np.testing.assert_array_equal(unbucketed.predict(_chirp(0.7), write_video=False).frames,
                                  predictor.predict(_chirp(0.7), write_video=False).frames)


def test_predictor_refuses_what_is_not_ported(predictor, tmp_path):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.Predictor(device="cuda")
    p = serve.Predictor(device="cpu", results_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="setup"):
        p.predict(_chirp(0.5))
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        p.setup(f2f_ckpt=str(tmp_path / "ckpt"), image_size=32)
    with pytest.raises(ValueError, match="shadow"):
        p.setup(artifact=predictor.artifact, a2h_ckpt="ckpt")
    with pytest.raises(RuntimeError, match="setup"):
        next(p.stream(_chirp(0.5)))


@pytest.fixture(scope="module")
def server_port(predictor):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), server.make_handler(predictor))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield httpd.server_address[1]
    httpd.shutdown()
    httpd.server_close()
    t.join(timeout=30)


def _wav_bytes(seconds: float) -> bytes:
    buf = io.BytesIO()
    wavfile.write(buf, 16000, (_chirp(seconds) * 32767).astype(np.int16))
    return buf.getvalue()


def test_server_healthz(server_port):
    with urllib.request.urlopen(f"http://127.0.0.1:{server_port}/healthz", timeout=60) as r:
        assert r.status == 200
        info = json.loads(r.read())
    assert info["status"] == "ok" and info["person"] == "Synthetic" and info["device"] == "cpu"


def test_server_animate_returns_a_video(server_port, tmp_path):
    import cv2

    req = urllib.request.Request(f"http://127.0.0.1:{server_port}/animate",
                                 data=_wav_bytes(0.6), method="POST",
                                 headers={"Content-Type": "audio/wav"})
    with urllib.request.urlopen(req, timeout=600) as r:
        assert r.status == 200
        n = int(r.headers["X-Frames"])
        assert float(r.headers["X-Wall-Seconds"]) > 0
        body = r.read()
    assert n == 36 - 15
    path = tmp_path / "resp.avi"
    path.write_bytes(body)
    cap = cv2.VideoCapture(str(path))
    try:
        assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == n
    finally:
        cap.release()


@pytest.mark.parametrize("path,data,code", [("/animate", b"not audio", 400),
                                            ("/nope", b"x", 404), ("/stream", b"x", 400)])
def test_server_errors(server_port, path, data, code):
    req = urllib.request.Request(f"http://127.0.0.1:{server_port}{path}", data=data,
                                 method="POST")
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(req, timeout=60)
    assert exc.value.code == code
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(f"http://127.0.0.1:{server_port}/nope", timeout=60)
    assert exc.value.code == 404
