"""PyTorch port, the renderer's inference rewrites: nn_core's subpixel
(four, single), dilated, split and s2d layers, K4's new forms' plain twins,
feature2face's subpixel / s2d / split-skip transforms, their weights across
utils/convert and the serving artifact, each against the JAX package on the
same numpy inputs at its own test sizes ('normal', ngf 8, 5 downsamplings,
32^2; tests/test_feature2face.py:286-540 there)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livespeechportraits_tpu.config import Feature2FaceConfig
from livespeechportraits_tpu.models import feature2face as jf2f
from livespeechportraits_tpu.models import nn_core as jcore
from livespeechportraits_torch.models import feature2face as f2f
from livespeechportraits_torch.models import nn_core
from livespeechportraits_torch.ops import q8conv_cuda
from livespeechportraits_torch.pipeline.assets import REWRITE_FORMS
from livespeechportraits_torch.utils import convert, flops
from torch_parity import torch_config

CFG = Feature2FaceConfig(size="normal", ngf=8, n_downsample=5, load_size=32)

# The forms, as assets.transform_person_models names them
FORMS = REWRITE_FORMS

# Layer level: JAX's rewrite and apply, the port's rewrite
LAYERS = {"four": (jcore.subpixel_from_conv3x3, jcore.upconv_subpixel,
                   nn_core.subpixel_from_conv3x3),
          "single": (jcore.subpixel1_from_conv3x3, jcore.upconv_subpixel1,
                     nn_core.subpixel1_from_conv3x3),
          "dilated": (jcore.dilated_from_conv3x3, jcore.upconv_dilated,
                      nn_core.dilated_from_conv3x3)}


def _rng(seed):
    return np.random.default_rng(seed)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_transform(tree, subpixel=False, s2d_input=False, split_skip=False):
    """JAX assets.transform_person_models on one generator tree."""
    if subpixel:
        tree = jf2f.subpixel_generator(tree, mode=subpixel.replace("_outermost", ""),
                                       outermost_only=subpixel.endswith("_outermost"))
    if s2d_input:
        tree = jf2f.s2d_input_generator(tree)
    if split_skip:
        tree = jf2f.split_skip_generator(tree)
    return tree


def _port_transform(model, subpixel=False, s2d_input=False, split_skip=False):
    if subpixel:
        model = f2f.subpixel_generator(model, mode=subpixel.replace("_outermost", ""),
                                       outermost_only=subpixel.endswith("_outermost"))
    if s2d_input:
        model = f2f.s2d_input_generator(model)
    if split_skip:
        model = f2f.split_skip_generator(model)
    return model


def _noisy_bn(params, seed):
    rng = _rng(seed)

    def walk(d):
        if isinstance(d, dict):
            if "mean" in d and "var" in d:
                return dict(d, mean=(0.3 * rng.standard_normal(d["mean"].shape)).astype(np.float32),
                            var=np.exp(0.5 * rng.standard_normal(d["var"].shape)).astype(np.float32))
            return {k: walk(v) for k, v in d.items()}
        if isinstance(d, list):
            return [walk(v) for v in d]
        return d

    return walk(params)


def _inputs(seed, n=2):
    return _rng(seed).uniform(-1, 1, (n, 32, 32, CFG.input_nc)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _base_tree(seed: int, quantized: bool):
    """A JAX ResUNet tree at test widths: float, or quantized, folded and
    calibrated (the deployment stack the rewrites follow).  Kept: no test
    changes it."""
    tree = _np_tree(jf2f.init_generator(jax.random.PRNGKey(seed), CFG))
    if quantized:
        tree = _np_tree(jf2f.fold_bn_generator(jf2f.quantize_generator(_noisy_bn(tree, seed))))
        tree = _np_tree(jf2f.calibrate_generator(tree, jnp.asarray(_inputs(seed + 1))))
    return tree


def _port_generator(tree) -> f2f.Feature2FaceG:
    model = f2f.Feature2FaceG(torch_config(CFG)).eval().requires_grad_(False)
    sd = convert.params_from_jax(tree)
    f2f.conform_to_state_dict(model, sd)
    model.load_state_dict(sd, strict=True)
    return model


def _port_apply(model, x, dtype=torch.float32):
    with torch.no_grad():
        return f2f.apply_generator(f2f.cast_generator(model, dtype), torch.tensor(x)).numpy()


@functools.partial(jax.jit, static_argnums=(2, 3))
def _jax_forward(net, x, size, dtype):
    return jf2f.apply_generator({"net": net, "size": size}, x, compute_dtype=dtype)[0]


def _jax_apply(tree, x, dtype=None):
    """JAX's apply_generator, jitted (one compile a tree structure; on these
    inputs it equals the eager forward bit for bit)."""
    return np.asarray(_jax_forward(tree["net"], jnp.asarray(x), str(tree["size"]), dtype),
                      np.float32)


def _ulps(a, b) -> float:
    """max |a - b| in units of f32 spacing at a's magnitude."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b) / np.spacing(np.maximum(np.abs(a), np.abs(b)))))


def _assert_leaves(got, want, float_ulps: float = 2.0):
    """Every leaf of two JAX-layout trees equal: int8 bitwise, float within
    float_ulps f32 ulps (measured below: 0, the same expressions in the same
    order)."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(k for k in want), (sorted(got), sorted(want))
        for k in want:
            _assert_leaves(got[k], want[k], float_ulps)
        return
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_leaves(g, w, float_ulps)
        return
    g, w = np.asarray(got), np.asarray(want)
    if w.dtype.kind in "US":
        assert str(g) == str(w)
        return
    assert g.shape == w.shape, (g.shape, w.shape)
    if w.dtype == np.int8:
        assert g.dtype == np.int8
        np.testing.assert_array_equal(g, w)
    else:
        assert _ulps(g, w) <= float_ulps


def _layer_to_jax(layer) -> dict:
    sd = {f"l.{k}": v for k, v in layer.state_dict().items()}
    return convert._rewrite_to(layer, sd, "l")


def _jax_conv(seed, cin=24, cout=16, quantized=False, static=False):
    """A JAX 3x3 conv with a bias (quantized, with an x_scale if static), and
    the same layer as the port's nn.Conv2d / QConv2d."""
    rng = _rng(seed)
    p = {"w": (rng.standard_normal((3, 3, cin, cout)) * 0.05).astype(np.float32),
         "b": (rng.standard_normal(cout) * 0.1).astype(np.float32)}
    if quantized:
        p = _np_tree(jcore.quantize_conv(jax.tree.map(jnp.asarray, p)))
        if static:
            p["x_scale"] = np.float32(2.5 / 127)
    sd = {}
    convert._conv2d(p, sd, "c")
    if quantized:
        conv = nn_core.QConv2d(sd["c.w_q"], sd["c.w_scale"], 1, 1, b=sd["c.b"],
                               x_scale=sd.get("c.x_scale"))
    else:
        conv = torch.nn.Conv2d(cin, cout, 3, padding=1)
        conv.load_state_dict({"weight": sd["c.weight"], "bias": sd["c.bias"]})
    return p, conv.requires_grad_(False)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form,quant", [
    (f, q) for f in ("four", "single", "dilated", "split") for q in ("float", "int8", "int8_static")
] + [("s2d", "float")])  # JAX's s2d rewrite takes float layers only (the input conv)
def test_rewritten_layer_matches_jax(form, quant):
    """Each rewritten layer's weights equal JAX's (int8 and the scales
    bitwise; float ones measured 0 ulps, bound 2: the same sums in the same
    order), and its forward equals JAX's on the same input: float atol 1e-5
    (JAX's own bound between the forms), int8 atol 1e-7 (measured <= 6e-8:
    XLA:CPU sums int8 convs in float)."""
    cin = 13 if form == "s2d" else 24
    p, conv = _jax_conv(30, cin=cin, quantized=quant != "float", static=quant == "int8_static")
    x = _rng(31).standard_normal((2, 9, 7, cin)).astype(np.float32)
    xt = torch.tensor(x).permute(0, 3, 1, 2)
    if form == "split":
        jp, layer = jcore.split_from_concat_conv(p, 12), nn_core.split_from_concat_conv(conv, 12)
        want = jcore.upconv_split(jp, jnp.asarray(x[..., :12]), jnp.asarray(x[..., 12:]))
        got = layer(xt[:, :12], xt[:, 12:])
    elif form == "s2d":
        x = _rng(31).standard_normal((2, 12, 10, cin)).astype(np.float32)
        xt = torch.tensor(x).permute(0, 3, 1, 2)
        jp, layer = jcore.s2d_from_conv3x3s2(p), nn_core.s2d_from_conv3x3s2(_conv_of(p, 2))
        want = jcore.conv_s2d_down(jp, jnp.asarray(x))
        got = layer(xt)
    else:
        rewrite, apply, port = LAYERS[form]
        jp, layer = rewrite(p), port(conv)
        want = apply(jp, jnp.asarray(x))
        got = layer(xt)
    _assert_leaves(_layer_to_jax(layer), _np_tree(jp), float_ulps=2.0)
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-7 if quant != "float" else 1e-5,
                               rtol=0 if quant != "float" else 1e-5)


def _conv_of(p, stride=1):
    conv = torch.nn.Conv2d(p["w"].shape[2], p["w"].shape[3], 3, stride=stride, padding=1)
    conv.load_state_dict({"weight": torch.tensor(p["w"].transpose(3, 2, 0, 1).copy()),
                          "bias": torch.tensor(p["b"])})
    return conv.requires_grad_(False)


def test_dilated_float_form_is_the_flipped_transposed_conv():
    """The dilated float form runs cuDNN's transposed conv (stride 2, padding
    1, kernel flipped, in / out swapped); that is the 4x4 conv over the
    input dilated by 2 with padding 2: against the explicit float64
    dilation, max 4e-16."""
    w = torch.tensor(_rng(32).standard_normal((16, 24, 4, 4)))
    x = torch.tensor(_rng(33).standard_normal((2, 24, 5, 6)))
    ref = torch.nn.functional.conv2d(
        torch.nn.functional.pad(q8conv_cuda.source_map(x, q8conv_cuda.SRC_DIL2), (2,) * 4), w)
    layer = nn_core.UpConvDilated({"w_dl": w}, (3, 24, 16, 1, 1))
    torch.testing.assert_close(layer(x), ref, rtol=0, atol=1e-12)


@pytest.mark.parametrize("form", ["four", "dilated", "split"])
def test_k4_form_twins_match_jax_int8_conv(form):
    """K4's new forms' plain twins (float64 convs on the integer values over
    the explicitly padded, dilated or upsampled input) against JAX's s8 x s8
    -> s32 lax.conv of the same form: bitwise in int32; and fused (quantize,
    rescale) against the composition of the twin's own parts."""
    rng = _rng(34)
    x = rng.integers(-127, 128, (2, 5, 6, 32), dtype=np.int8)
    xt = torch.tensor(x).permute(0, 3, 1, 2)
    conv = lambda lhs, w, pad, **kw: np.asarray(jax.lax.conv_general_dilated(  # noqa: E731
        jnp.asarray(lhs), jnp.asarray(w), (1, 1), pad, dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32, **kw))
    if form == "four":
        w = rng.integers(-127, 128, (4, 2, 2, 32, 24), dtype=np.int8)
        phases = [conv(x, w[p], [(1 - a, a), (1 - b, b)])
                  for p, (a, b) in enumerate(q8conv_cuda.PHASES)]
        want = np.stack(phases, 3).reshape(2, 5, 6, 2, 2, 24).transpose(0, 1, 3, 2, 4, 5)
        want = want.reshape(2, 10, 12, 24)
        wt = torch.tensor(w.transpose(0, 4, 3, 1, 2).reshape(96, 32, 2, 2).copy())
        got = q8conv_cuda.subpixel_q8(xt, wt)
    elif form == "dilated":
        w = rng.integers(-127, 128, (4, 4, 32, 24), dtype=np.int8)
        want = conv(x, w, [(2, 2), (2, 2)], lhs_dilation=(2, 2))
        got = q8conv_cuda.dilated_q8(xt, torch.tensor(w.transpose(3, 2, 0, 1).copy()))
    else:
        w = rng.integers(-127, 128, (3, 3, 48, 24), dtype=np.int8)
        x2 = rng.integers(-127, 128, (2, 5, 6, 16), dtype=np.int8)
        cat = np.concatenate([x, x2], -1)
        want = conv(np.asarray(jcore.upsample_nearest_2x(jnp.asarray(cat))), w, [(1, 1), (1, 1)])
        got = q8conv_cuda.split_q8(xt, torch.tensor(x2).permute(0, 3, 1, 2),
                                   torch.tensor(w.transpose(3, 2, 0, 1).copy()))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


# ---------------------------------------------------------------------------
# generators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quant", ["float", "int8"])
@pytest.mark.parametrize("form", list(FORMS))
def test_rewritten_generator_matches_jax(form, quant):
    """JAX's rewritten tree converted to the port (the converter takes every
    key a rewrite leaves), and the port's own rewrite of the converted base
    tree: both equal JAX's tree leaf for leaf (int8 bitwise, float within 2
    ulps, measured 0), and the forward equals JAX's in f32 (float atol 1e-5,
    int8 1e-7; measured <= 2.3e-8) and in bf16 with the same bounds where
    the to-RGB up conv is a subpixel form (measured <= 1.5e-8).  Where it
    stays a 3x3 conv on the upsampled map (dilated, s2d, split, and the
    unrewritten tree), the bf16 bound is JAX's own between the forms, 1e-3:
    the unrewritten tree measures 2.2e-4 there and the forms <= 2.5e-4, one
    bf16 rounding of that float conv's output, which torch's CPU conv and
    XLA's round differently."""
    base = _base_tree(40, quant == "int8")
    kw = FORMS[form]
    want = _np_tree(_jax_transform(base, **kw))
    from_jax = _port_generator(want)
    ours = _port_transform(_port_generator(base), **kw)
    _assert_leaves(convert.params_to_jax(from_jax), want)
    _assert_leaves(convert.params_to_jax(ours), want)
    x = _inputs(41)
    tol = 1e-7 if quant == "int8" else 1e-5
    subpixel_rgb = "four" in form or "single" in form
    for dt, jdt, bound in ((torch.float32, None, tol),
                           (torch.bfloat16, jnp.bfloat16, tol if subpixel_rgb else 1e-3)):
        ref = _jax_apply(want, x, jdt)
        for model in (from_jax, ours):
            np.testing.assert_allclose(_port_apply(model, x, dt), ref, atol=bound, rtol=0)
    # and JAX's float forms against its unrewritten forward, as its own tests
    if quant == "float":
        np.testing.assert_allclose(_jax_apply(want, x), _jax_apply(base, x), atol=1e-5)


def _inner_pair(model, x, dtype):
    """The (skip, inner output) pair the outermost up conv reads: the int8
    part of the forward (the outermost stage's down and up convs are
    float)."""
    outer = model.netG.model
    inner = next(m for m in outer.model if isinstance(m, f2f.ResUnetBlock))
    got = []
    handle = inner.register_forward_hook(lambda m, i, o: got.append(o))
    try:
        _port_apply(model, x, dtype)
    finally:
        handle.remove()
    return [t.float().numpy() for t in got[0]]


@pytest.mark.parametrize("form", ["four", "single", "dilated", "split"])
def test_rewritten_int8_generator_close_to_unrewritten(form):
    """The port's rewritten int8 generator against its unrewritten one on
    the same calibrated tree.  split: the int8 part (every int8 split conv:
    one x_scale, one int32 sum over both halves) bit for bit, in f32 and
    bf16; the frame within JAX's 2e-7 (f32) and 1e-3 (bf16), the outermost
    to-RGB up conv being a float conv split into two summed convs, as JAX's
    (measured 8.9e-8 in f32).  The subpixel forms requantize their folded
    weights: measured > 40 dB against the unrewritten int8 frame (JAX's
    gate is 24 dB against the float one, test_feature2face.py:377)."""
    model = _port_generator(_base_tree(40, True))
    rewritten = _port_transform(model, **FORMS[form])
    x = _inputs(43)
    for dt, bound in ((torch.float32, 2e-7), (torch.bfloat16, 1e-3)):
        y, yr = _port_apply(model, x, dt), _port_apply(rewritten, x, dt)
        if form == "split":
            for a, b in zip(_inner_pair(model, x, dt), _inner_pair(rewritten, x, dt)):
                np.testing.assert_array_equal(b, a)
            np.testing.assert_allclose(yr, y, atol=bound, rtol=0)
        else:
            assert 10 * np.log10(4.0 / max(float(np.mean((yr - y) ** 2)), 1e-12)) > 40.0


def test_calibrate_after_split_equals_split_after_calibrate():
    """Calibrating a split tree records one joint amax per split conv: the
    scales equal calibrate-then-split's (rtol 1e-6, JAX's bound; measured
    equal) and the forwards are equal."""
    tree = _np_tree(jf2f.fold_bn_generator(jf2f.quantize_generator(
        _noisy_bn(_np_tree(jf2f.init_generator(jax.random.PRNGKey(44), CFG)), 44))))
    q = _port_generator(tree)
    x = torch.tensor(_inputs(45))
    a = f2f.split_skip_generator(f2f.calibrate_generator(q, x))
    b = f2f.calibrate_generator(f2f.split_skip_generator(q), x)
    sa, sb = convert.params_to_jax(a), convert.params_to_jax(b)
    np.testing.assert_allclose(sb["net"]["sub"]["up"]["x_scale"],
                               sa["net"]["sub"]["up"]["x_scale"], rtol=1e-6)
    assert "w_a_q" in sb["net"]["sub"]["up"]
    np.testing.assert_array_equal(_port_apply(a, _inputs(46)), _port_apply(b, _inputs(46)))
    # and JAX's calibration of its split tree gives the same scales
    jb = jf2f.calibrate_generator(jf2f.split_skip_generator(tree), jnp.asarray(_inputs(45)))
    np.testing.assert_allclose(sb["net"]["sub"]["up"]["x_scale"],
                               np.asarray(jb["net"]["sub"]["up"]["x_scale"]), rtol=1e-6)


@pytest.mark.parametrize("form", ["four", "single", "split"])
def test_edge_path_on_rewritten_trees(form):
    """apply_generator_edge (split_cand) on a rewritten float tree equals
    the full forward on the same edge and candidates (atol 1e-5, JAX's
    bound), and JAX's edge path on its rewritten tree."""
    base = _base_tree(40, False)
    want = _np_tree(_jax_transform(base, **FORMS[form]))
    model = _port_generator(want)
    x = _inputs(48)
    edge, cand = x[..., :1], x[0, ..., 1:]
    x_shared = np.concatenate([edge, np.broadcast_to(cand, (2,) + cand.shape)], -1)
    with torch.no_grad():
        cd = f2f.precompute_cand_down(model, torch.tensor(cand))
        y = f2f.apply_generator_edge(model, torch.tensor(edge), cd).numpy()
    np.testing.assert_allclose(y, _port_apply(model, x_shared), atol=1e-5, rtol=0)
    ref = _jax_edge(want["net"], jnp.asarray(edge), jnp.asarray(cand), str(want["size"]))
    np.testing.assert_allclose(y, np.asarray(ref), atol=1e-5, rtol=0)


@functools.partial(jax.jit, static_argnums=(3,))
def _jax_edge(net, edge, cand, size):
    tree = {"net": net, "size": size}
    return jf2f.apply_generator_edge(tree, edge, jf2f.precompute_cand_down(tree, cand))


@pytest.mark.parametrize("case", ["s2d_split_cand", "small", "split_on_subpixel",
                                  "calibrate_subpixel"])
def test_rewrites_refuse_as_jax_does(case):
    model = _port_generator(_base_tree(40, False))
    if case == "s2d_split_cand":
        with pytest.raises(ValueError, match="s2d_input_generator"):
            f2f.precompute_cand_down(f2f.s2d_input_generator(model), torch.zeros(32, 32, 12))
    elif case == "small":
        model.size = "small"
        for fn in (f2f.subpixel_generator, f2f.s2d_input_generator, f2f.split_skip_generator):
            with pytest.raises(NotImplementedError):
                fn(model)
    elif case == "split_on_subpixel":
        with pytest.raises(ValueError, match="subpixel/dilated rewrite"):
            f2f.split_skip_generator(f2f.subpixel_generator(model, mode="single"))
    else:  # JAX's calibration walk skips the subpixel layers its forward records
        q = f2f.fold_bn_generator(f2f.quantize_generator(model))
        with pytest.raises(RuntimeError, match="more conv activations"):
            f2f.calibrate_generator(f2f.subpixel_generator(q), torch.tensor(_inputs(50)))


@pytest.mark.parametrize("form", list(FORMS))
def test_generator_flops_unchanged_by_rewrites(form):
    """generator_flops of a rewritten model is the unrewritten count (JAX
    counts the float tree: the work one frame represents), on float and
    int8 models."""
    for quant in (False, True):
        model = _port_generator(_base_tree(40, quant))
        want = flops.generator_flops(model, 32)
        assert flops.generator_flops(_port_transform(model, **FORMS[form]), 32) == want


def test_int8_up_convs_and_k4_launches_follow_the_forms():
    """int8_up_convs lists the int8 up convs of int8_conv_shapes, and
    k4_launches counts a forward's launches: one an int8 conv, four a
    four-phase up conv."""
    from livespeechportraits_torch.config import Feature2FaceConfig as TCfg

    cfg = TCfg()
    ups = f2f.int8_up_convs(cfg)
    assert ups == [(256, 256, 64, 128), (128, 512, 128, 256), (64, 1024, 256, 512),
                   (32, 1024, 512, 512), (16, 1024, 512, 512), (8, 1024, 512, 512),
                   (4, 512, 512, 0)]
    shapes = f2f.int8_conv_shapes(cfg)
    assert all((s, ci, co, 1) in shapes for s, ci, co, _ in ups)
    model = f2f.quantize_generator(_port_generator(_base_tree(40, False)))
    assert f2f.k4_launches(model) == 26
    assert f2f.k4_launches(f2f.subpixel_generator(model)) == 26 + 3 * 4
    assert f2f.k4_launches(f2f.split_skip_generator(model)) == 26


# ---------------------------------------------------------------------------
# the serving artifact, across the two packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def served():
    """JAX's tiny subject (tests/test_server.py:146-164) and its int8,
    calibrated models under each rewrite."""
    from livespeechportraits_tpu.pipeline import animate as janimate
    from livespeechportraits_tpu.pipeline import assets as jassets
    from tests.test_pipeline import _sine_audio, tiny_person

    cfg = tiny_person()
    a, m = jassets.make_synthetic_person(cfg, key=jax.random.PRNGKey(5), image_size=64,
                                         bank_size=64)
    calib = janimate.build_render_inputs(cfg, a, m, _sine_audio(0.7), max_frames=4)
    models = {name: jassets.quantize_person_models(m, calibrate_inputs=calib, **kw)
              for name, kw in (("single", {"subpixel": "single"}),
                               ("split", {"split_skip": True}))}
    return cfg, calib, models


@pytest.mark.parametrize("form", ["single", "split"])
def test_jax_artifact_boots_the_port(served, form, tmp_path):
    """JAX's save_models_artifact of an int8 model with a rewrite, read by
    the port's load_models_artifact: the renderer's forward equals JAX's
    (atol 1e-7, as the int8 generator's)."""
    from livespeechportraits_torch.pipeline import assets as tassets
    from livespeechportraits_tpu.pipeline import assets as jassets
    from torch_parity import torch_config as tc

    cfg, calib, models = served
    path = str(tmp_path / "m.npz")
    jassets.save_models_artifact(models[form], path)
    ours = tassets.load_models_artifact(path, tc(cfg), device="cpu")
    x = np.asarray(calib)[:2]
    ref = _jax_apply(_np_tree(models[form].feature2face), x)
    with torch.no_grad():
        y = f2f.apply_generator(f2f.cast_generator(ours.feature2face, torch.float32),
                                torch.tensor(x)).numpy()
    np.testing.assert_allclose(y, np.asarray(ref), atol=1e-7, rtol=0)


@pytest.mark.parametrize("form", ["single", "split"])
def test_port_artifact_loads_in_jax(served, form, tmp_path):
    """The port's save of the same models (converted from JAX's), read by
    JAX's load_models_artifact: every leaf equal to JAX's own in dtype and
    value."""
    from livespeechportraits_torch.pipeline import assets as tassets
    from livespeechportraits_tpu.pipeline import assets as jassets
    from torch_parity import torch_config as tc

    cfg, _, models = served
    src = str(tmp_path / "jax.npz")
    jassets.save_models_artifact(models[form], src)
    path = str(tmp_path / "port.npz")
    tassets.save_models_artifact(tassets.load_models_artifact(src, tc(cfg), device="cpu"), path)
    loaded = jassets.load_models_artifact(path)
    for field in ("apc", "audio2feature", "audio2headpose", "feature2face"):
        got, want = _np_tree(getattr(loaded, field)), _np_tree(getattr(models[form], field))
        jax.tree.map(lambda g, w: (np.testing.assert_array_equal(g, w),
                                   _same_dtype(g, w)), got, want)


def _same_dtype(g, w):
    assert np.asarray(g).dtype == np.asarray(w).dtype, (np.asarray(g).dtype, np.asarray(w).dtype)
