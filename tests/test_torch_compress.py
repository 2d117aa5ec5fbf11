"""PyTorch port, the frame coders (pipeline/compress.py) and the host codec
(native/): each coder against the JAX package on the CPU, on the same float
YUV planes or the same integer coefficients made with numpy from a seed; the
packers and the numpy decoders bitwise; the native codec against its numpy
twin; and render_frames under each transfer."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livespeechportraits_tpu import native as jnative
from livespeechportraits_tpu.pipeline import compress as J
from livespeechportraits_torch import native
from livespeechportraits_torch.pipeline import animate, assets, compress as C, video
from torch_parity import small_person_config, torch_config

# Quantized coefficients from two f32 DCTs: XLA and torch sum the matmuls in
# other orders, so a coefficient within an ulp of a rounding edge may round
# the other way.  Measured on these planes: none.  Bound: 99.99 % equal, the
# rest one quantization step off.
COEF_EQUAL_SHARE = 0.9999
# The native codec against its numpy twin: the k-term dot sums in another
# order, so a decoded plane value may land 1 LSB off at a rounding edge
# (tests/test_native_codec.py's bound for the JAX package's copy).  Measured
# on these frames: none differ.
NATIVE_LSB = 1
NATIVE_SHARE = 1e-3


def _planes(B, h, w, seed):
    """Float Y [B, h, w] and U, V [B, h/2, w/2] in 0..255: smooth gradients,
    a flat square and noise, so blocks of every kind occur."""
    rng = np.random.default_rng(seed)

    def plane(hh, ww):
        yy, xx = np.meshgrid(np.linspace(0, 1, hh), np.linspace(0, 1, ww), indexing="ij")
        p = np.stack([255 * xx * yy, rng.uniform(0, 255, (hh, ww)),
                      np.full((hh, ww), 17.0)])[:B].copy()
        p[0, hh // 4:hh // 2, ww // 4:ww // 2] = 230.0
        return p.astype(np.float32)

    return plane(h, w), plane(h // 2, w // 2), plane(h // 2, w // 2)


def _frames(B=3, h=64, w=64, seed=0):
    rng = np.random.default_rng(seed)
    img = np.zeros((B, h, w, 3), np.float32)
    yy, xx = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w), indexing="ij")
    img[0] = np.stack([xx * 0.5, yy * 0.5, (xx + yy) * 0.25], -1)
    img[1 % B] = rng.uniform(-1, 1, (h, w, 3))
    img[2 % B, h // 4:h // 2, w // 4:w // 2] = 0.8
    return img


def _t(x):
    return torch.tensor(np.asarray(x))


def _assert_coefs_close(ours, ref, step=1):
    ours, ref = np.asarray(ours).astype(np.int64), np.asarray(ref).astype(np.int64)
    assert ours.shape == ref.shape
    d = np.abs(ours - ref)
    assert d.max() <= step and (d == 0).mean() >= COEF_EQUAL_SHARE, (d.max(), (d == 0).mean())


def _assert_native_close(got, want):
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= NATIVE_LSB and (d > 0).mean() < NATIVE_SHARE, (d.max(), (d > 0).mean())


def test_tables_match_jax():
    np.testing.assert_array_equal(C.zigzag_order(), J.zigzag_order())
    np.testing.assert_array_equal(C.dct_matrix(), J.dct_matrix())
    for q in (10, 50, 75, 100):
        for base in ("_Q_LUMA", "_Q_CHROMA"):
            np.testing.assert_array_equal(C.quant_table(getattr(C, base), q),
                                          J.quant_table(getattr(J, base), q))
    for n, tr in ((64, False), (40, True)):
        np.testing.assert_array_equal(C._bd_dct(n, tr), J._bd_dct(n, tr))
    np.testing.assert_array_equal(C._dequant_idct_basis(True, 75, 13),
                                  J._dequant_idct_basis_cached(True, 75, 13))
    for h, w in ((512, 512), (64, 96)):
        assert C.encoded_bytes_per_frame(h, w) == J.encoded_bytes_per_frame(h, w)
        assert C.encoded_bytes_per_frame_p4(h, w) == J.encoded_bytes_per_frame_p4(h, w)
        assert C.p4e_bytes_per_frame_cap(h, w) == J.p4e_bytes_per_frame_cap(h, w)


@pytest.mark.parametrize("h,w", [(64, 64), (72, 40)])
@pytest.mark.parametrize("luma,k", [(True, 13), (False, 5), (True, 16)])
def test_zigzag_quant_matches_jax(h, w, luma, k):
    """The block DCT, table quantization and zigzag gather of one plane
    (72x40: a block count that is not a power of two)."""
    y = _planes(2, h, w, seed=h + k)[0]
    base = C._Q_LUMA if luma else C._Q_CHROMA
    ours = C._zigzag_quant(_t(y), base, 75, k)
    ref = J._zigzag_quant(jnp.asarray(y), jnp.asarray(J.quant_table(base, 75)), k)
    assert ours.dtype == torch.float32 and ours.shape == (2, (h // 8) * (w // 8), k)
    _assert_coefs_close(ours, ref)


@pytest.mark.parametrize("h,w", [(64, 64), (96, 64)])
def test_zonal_and_pack4_codes_match_jax(h, w):
    """The whole jpeg and jpeg4 codes of the same float planes."""
    y, u, v = _planes(2, h, w, seed=1)
    ours = C.encode_yuv420(_t(y), _t(u), _t(v))
    ref = np.asarray(J.encode_yuv420(*map(jnp.asarray, (y, u, v))))
    assert ours.dtype == torch.int8
    _assert_coefs_close(ours, ref)
    ours4 = C.encode_yuv420_p4(_t(y), _t(u), _t(v)).numpy()
    ref4 = np.asarray(J.encode_yuv420_p4(*map(jnp.asarray, (y, u, v))))
    assert ours4.dtype == np.uint8 and ours4.shape == ref4.shape
    assert (ours4 == ref4).mean() >= COEF_EQUAL_SHARE


def _int_coefs(B, nb, k, seed):
    """Integer zigzag coefficients of every kind: DCs past the int8 range,
    runs of zero ACs, ACs that need each shift, unchanged DCs in a row."""
    rng = np.random.default_rng(seed)
    zz = np.zeros((B, nb, k), np.float32)
    zz[..., 0] = rng.integers(-140, 140, (B, nb))
    zz[:, 1::3, 0] = zz[:, 0:-1:3, 0][:, :zz[:, 1::3, 0].shape[1]]
    scale = 2.0 ** rng.integers(0, 8, (B, nb, 1))
    ac = np.round(rng.uniform(-7.5, 7.5, (B, nb, k - 1)) * scale)
    keep = rng.integers(0, k, (B, nb, 1)) > np.arange(k - 1)
    zz[..., 1:] = np.where(keep, ac, 0.0)
    zz[:, ::5, 1:] = 0.0
    return zz


@pytest.mark.parametrize("k", [5, 13, 15])
def test_p4e_tokens_bitwise(k):
    zz = _int_coefs(2, 45, k, seed=k)
    ours = C._p4e_tokens(_t(zz), k)
    ref = J._p4e_tokens(jnp.asarray(zz), k)
    for a, b, name in zip(ours, ref, ("vals", "valid", "within", "nbytes")):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


@pytest.mark.parametrize("h,w", [(64, 64), (96, 64)])
def test_packers_bitwise_from_the_same_coefficients(monkeypatch, h, w):
    """pack4e's scatter and pack4's nibble packing, each fed the same
    integer coefficients in both packages (the DCT replaced by a table of
    them): the same bytes and the same total."""
    k_y, k_c = C.DEFAULT_P4_K_Y, C.DEFAULT_P4_K_C
    coefs = {}
    for i, (hh, ww, k) in enumerate(((h, w, k_y), (h // 2, w // 2, k_c))):
        coefs[(hh, ww, k)] = _int_coefs(2, (hh // 8) * (ww // 8), k, seed=i)
    monkeypatch.setattr(C, "_zigzag_quant",
                        lambda p, base, q, k: _t(coefs[(p.shape[1], p.shape[2], k)]))
    monkeypatch.setattr(J, "_zigzag_quant",
                        lambda p, qtab, k: jnp.asarray(coefs[(p.shape[1], p.shape[2], k)]))
    y, u, v = _planes(2, h, w, seed=0)
    tplanes, jplanes = (_t(y), _t(u), _t(v)), tuple(map(jnp.asarray, (y, u, v)))
    flat, total = C.encode_yuv420_p4e(*tplanes)
    jflat, jtotal = J.encode_yuv420_p4e(*jplanes)
    assert flat.shape == (2 * C.p4e_bytes_per_frame_cap(h, w),)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    assert int(total) == int(jtotal) and (flat[int(total):] == 0).all()
    np.testing.assert_array_equal(C.encode_yuv420_p4(*tplanes).numpy(),
                                  np.asarray(J.encode_yuv420_p4(*jplanes)))


def test_rgb_to_yuv_planes_matches_jax():
    """The 2x2 chroma mean sums in another order: within 4 ulp of 255."""
    img = np.random.default_rng(3).uniform(-1, 1, (2, 32, 48, 3)).astype(np.float32)
    for ours, ref in zip(C.rgb_to_yuv_planes(_t(img)), J.rgb_to_yuv_planes(jnp.asarray(img))):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=1e-4)


def _jax_streams(img):
    """JAX's three codes of the same frames."""
    x = jnp.asarray(img)
    flat, total = J.encode_rgb_frames_p4e(x)
    return (np.asarray(J.encode_rgb_frames(x)), np.asarray(J.encode_rgb_frames_p4(x)),
            np.asarray(flat)[:int(total)])


@pytest.mark.parametrize("h,w", [(64, 64), (96, 64)])
def test_numpy_decoders_bitwise_on_jax_streams(monkeypatch, h, w):
    img = _frames(3, h, w, seed=1)
    zonal, p4, p4e = _jax_streams(img)
    for ours, ref in zip(C.decode_to_yuv(zonal, h, w), J.decode_to_yuv(zonal, h, w)):
        np.testing.assert_array_equal(ours, ref)
    for ours, ref in zip(C.decode_to_yuv_p4(p4, h, w), J.decode_to_yuv_p4(p4, h, w)):
        np.testing.assert_array_equal(ours, ref)
    monkeypatch.setattr(jnative, "_LIB", None)  # JAX's numpy pack4e decoder
    monkeypatch.setattr(jnative, "_TRIED", True)
    ref, ref_n = J.decode_to_rgb_p4e(p4e, 3, h, w, return_consumed=True)
    ours, n = C.decode_to_rgb_p4e_np(p4e, 3, h, w, return_consumed=True)
    np.testing.assert_array_equal(ours, ref)
    assert n == ref_n == len(p4e)


@pytest.mark.parametrize("h,w", [(64, 64), (96, 64)])
def test_native_codec_matches_numpy_twin(h, w):
    img = _frames(3, h, w, seed=2)
    zonal, p4, p4e = _jax_streams(img)
    _assert_native_close(C.decode_to_rgb(zonal, h, w),
                         C.yuv420_to_rgb(*C.decode_to_yuv(zonal, h, w)))
    _assert_native_close(C.decode_to_rgb_p4(p4, h, w),
                         C.yuv420_to_rgb(*C.decode_to_yuv_p4(p4, h, w)))
    rgb, n = C.decode_to_rgb_p4e(p4e, 3, h, w, return_consumed=True)
    assert n == len(p4e)
    _assert_native_close(rgb, C.decode_to_rgb_p4e_np(p4e, 3, h, w))
    # pack4e is a lossless recoding of pack4: the native codec gives the
    # same frames from either
    np.testing.assert_array_equal(rgb, C.decode_to_rgb_p4(p4, h, w))


def test_the_port_decodes_its_own_codes():
    """The port's encoders on the same frames as JAX's: the decoded frames
    within one level of JAX's decoded frames (a coefficient may round the
    other way, above)."""
    img = _frames(2, 64, 64, seed=5)
    x = _t(img)
    flat, total = C.encode_rgb_frames_p4e(x)
    pairs = ((C.decode_to_rgb(C.encode_rgb_frames(x).numpy(), 64, 64),
              J.decode_to_rgb(np.asarray(J.encode_rgb_frames(jnp.asarray(img))), 64, 64)),
             (C.decode_to_rgb_p4(C.encode_rgb_frames_p4(x).numpy(), 64, 64),
              J.decode_to_rgb_p4(np.asarray(J.encode_rgb_frames_p4(jnp.asarray(img))), 64, 64)),
             (C.decode_to_rgb_p4e(flat.numpy()[:int(total)], 2, 64, 64),
              J.decode_to_rgb_p4(np.asarray(J.encode_rgb_frames_p4(jnp.asarray(img))), 64, 64)))
    for ours, ref in pairs:
        assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 1


@pytest.mark.parametrize("decode", [C.decode_to_rgb_p4e, C.decode_to_rgb_p4e_np],
                         ids=["native", "numpy"])
def test_p4e_truncated_prefix_raises(decode):
    img = _frames(3, 64, 64, seed=6)
    flat, total = C.encode_rgb_frames_p4e(_t(img))
    flat, total = flat.numpy(), int(total)
    for cut in (3, total // 2, total - 1):
        with pytest.raises(IndexError, match="truncated"):
            decode(flat[:cut], 3, 64, 64)
    # a longer prefix than needed decodes the same and consumes the same
    a, n = decode(flat[:total], 3, 64, 64, return_consumed=True)
    b, m = decode(flat, 3, 64, 64, return_consumed=True)
    np.testing.assert_array_equal(a, b)
    assert n == m == total


def test_k_checks():
    zz = torch.zeros(1, 4, 16)
    with pytest.raises(ValueError, match="odd"):
        C._p4e_tokens(zz[..., :14], 14)
    with pytest.raises(ValueError, match="<= 15"):
        C._p4e_tokens(zz[..., :17], 17)
    planes = [torch.zeros(1, 32, 32), torch.zeros(1, 16, 16), torch.zeros(1, 16, 16)]
    with pytest.raises(ValueError, match="<= 15"):
        C.encode_yuv420_p4e(*planes, k_y=17)
    with pytest.raises(ValueError, match="odd"):
        C.encode_yuv420_p4(*planes, k_c=4)
    with pytest.raises(ValueError, match="odd"):
        native.decode_p4(np.zeros((1, 10), np.uint8), 32, 32, 12, 5,
                         np.zeros((12, 64)), np.zeros((5, 64)))
    with pytest.raises(ValueError, match="multiples of 16"):
        native.decode_p4e(np.zeros(10, np.uint8), 1, 24, 32, 13, 5,
                          np.zeros((13, 64)), np.zeros((5, 64)))


def test_a_failed_native_build_raises(monkeypatch, tmp_path):
    """No fallback: a codec that does not compile raises with g++'s
    output."""
    bad = tmp_path / "framecodec.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as exc:
        native.build()
    assert "error" in str(exc.value)
    assert not list((tmp_path / "build").glob("*.so"))


@pytest.fixture(scope="module")
def motion():
    cfg = torch_config(small_person_config(image_size=64))
    person, models = assets.make_synthetic_person(cfg, image_size=64, device="cpu")
    lm, sh, _, _, n = animate.compute_motion(cfg, person, models, video.make_test_tone(0.8),
                                             seed=1)
    return cfg, person, models, lm[:n], sh[:n]


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def test_render_frames_transfers(motion):
    """Every coder through render_frames against the exact rgb transfer at
    the serving gate (PSNR >= 30 dB); pack4e's frames equal jpeg4's (a
    lossless recoding) from fewer bytes; yuv420 halves rgb's bytes."""
    cfg, person, models, lm, sh = motion
    out, links = {}, {}
    for transfer in animate.TRANSFERS:
        links[transfer] = {}
        out[transfer], _ = animate.render_frames(cfg, person, models, lm, sh, render_batch=4,
                                                 transfer=transfer, link=links[transfer])
    n = lm.shape[0]
    for transfer in ("yuv420", "jpeg", "jpeg4", "pack4e"):
        assert out[transfer].shape == out["rgb"].shape == (n, 64, 64, 3)
        assert _psnr(out[transfer], out["rgb"]) >= 30.0, transfer
    np.testing.assert_array_equal(out["pack4e"], out["jpeg4"])
    batches = -(-n // 4)
    assert links["rgb"]["fetch_bytes"] == batches * 4 * 64 * 64 * 3
    assert links["yuv420"]["fetch_bytes"] * 2 == links["rgb"]["fetch_bytes"]
    assert links["jpeg4"]["fetch_bytes"] == batches * 4 * C.encoded_bytes_per_frame_p4(64, 64)
    assert links["pack4e"]["fetch_bytes"] < links["jpeg4"]["fetch_bytes"]


def test_pack4e_prefix_fetch_refetches_a_short_prefix(motion, monkeypatch):
    """A prefix bucket too short for its batch is fetched again whole: one
    refetch a batch while the learned size is forced to one byte, the same
    frames, and the process-level need learned from the decoded sizes."""
    cfg, person, models, lm, sh = motion
    ref, _ = animate.render_frames(cfg, person, models, lm, sh, render_batch=4,
                                   transfer="jpeg4")
    monkeypatch.setattr(animate, "_P4E_NEED", {})
    monkeypatch.setattr(animate, "P4E_MARGIN", 1e-9)  # every learned size rounds to 0
    link = {}
    frames, _ = animate.render_frames(cfg, person, models, lm, sh, render_batch=4,
                                      transfer="pack4e", link=link)
    np.testing.assert_array_equal(frames, ref)
    batches = -(-lm.shape[0] // 4)
    # the first two batches go out before one is decoded and fetch the whole
    # cap; each later one a 1/32 bucket of it
    assert link["p4e_refetches"] == batches - 2
    monkeypatch.setattr(animate, "P4E_MARGIN", 1.15)
    link = {}
    frames, _ = animate.render_frames(cfg, person, models, lm, sh, render_batch=4,
                                      transfer="pack4e", link=link)
    np.testing.assert_array_equal(frames, ref)
    assert animate._P4E_NEED[(64, 64, 4)] > 0
