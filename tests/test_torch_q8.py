"""PyTorch port, the int8 renderer: nn_core's int8 layer, the K4 twin
(ops/q8conv_cuda.conv_s8_plain) and feature2face's quantize / fold /
calibrate transforms, each against the JAX package on the same numpy inputs
at test widths (ngf 8, 5 downsamplings, 32^2)."""

import copy
import dataclasses
import types

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
from livespeechportraits_torch.pipeline import assets
from livespeechportraits_torch.utils.convert import params_from_jax, params_to_jax
from torch_parity import small_person_config, torch_config

CFG = Feature2FaceConfig(size="normal", ngf=8, n_downsample=5, load_size=32)


def _rng(seed):
    return np.random.default_rng(seed)


def _jax_generator(seed: int, noisy_bn: bool = False):
    """A JAX ResUNet tree at test widths; noisy_bn gives every BN
    non-trivial running stats, so folding has work to do."""
    params = jax.tree.map(np.asarray, jf2f.init_generator(jax.random.PRNGKey(seed), CFG))
    if not noisy_bn:
        return params
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


def _port_generator(tree) -> f2f.Feature2FaceG:
    model = f2f.Feature2FaceG(torch_config(CFG)).eval().requires_grad_(False)
    sd = params_from_jax(tree)
    f2f.conform_to_state_dict(model, sd)
    model.load_state_dict(sd, strict=True)
    return model


def _inputs(seed, n=2):
    return _rng(seed).uniform(-1, 1, (n, 32, 32, CFG.input_nc)).astype(np.float32)


def _port_apply(model, x, dtype=torch.float32):
    with torch.no_grad():
        return f2f.apply_generator(f2f.cast_generator(model, dtype), torch.tensor(x)).numpy()


def _psnr(a, b):
    return 10 * np.log10(4.0 / max(float(np.mean((a - b) ** 2)), 1e-12))  # [-1, 1] range


@pytest.mark.parametrize("shape,zero_channel", [((3, 3, 16, 24), False), ((3, 3, 8, 5), True),
                                                 ((3, 3, 64, 32), False)])
def test_quantize_weight_int8_bitwise(shape, zero_channel):
    w = (_rng(1).standard_normal(shape) * 0.02).astype(np.float32)  # JAX HWIO
    if zero_channel:
        w[..., 0] = 0.0  # exercises the 1e-12 floor
    q_ref, s_ref = jcore.quantize_weight_int8(jnp.asarray(w))
    q, s = nn_core.quantize_weight_int8(torch.tensor(w.transpose(3, 2, 0, 1).copy()))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy().transpose(2, 3, 1, 0), np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))


@pytest.mark.parametrize("stride,hw", [(1, (13, 7)), (2, (13, 7)), (2, (8, 11)), (1, (1, 2))])
def test_q8_twin_matches_jax_int8_conv(stride, hw):
    """conv_s8 on the CPU (the K4 twin, a float64 conv) against JAX's
    s8 x s8 -> s32 lax.conv: bitwise in int32, ragged H and W."""
    rng = _rng(2)
    x = rng.integers(-127, 128, (2, *hw, 24), dtype=np.int8)  # NHWC
    w = rng.integers(-127, 128, (3, 3, 24, 40), dtype=np.int8)  # HWIO
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), [(1, 1), (1, 1)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32)
    ours = q8conv_cuda.conv_s8(torch.tensor(x).permute(0, 3, 1, 2),
                               torch.tensor(w.transpose(3, 2, 0, 1).copy()), stride)
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.permute(0, 2, 3, 1).numpy(), np.asarray(ref))


def test_int32_to_bf16_matches_jax():
    """The rescale casts the int32 sums to bf16: torch and XLA round alike,
    also past 2^24 where the cast rounds twice (int32 -> f32 -> bf16)."""
    rng = _rng(3)
    v = np.concatenate([rng.integers(-3_000_000, 3_000_000, 20000),
                        rng.integers(-(1 << 28), 1 << 28, 20000),
                        np.arange(-(1 << 25), (1 << 25) + 1, 4099)]).astype(np.int32)
    ref = np.asarray(jnp.asarray(v).astype(jnp.bfloat16).astype(jnp.float32))
    ours = torch.tensor(v).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(ours, ref)


def _q_layer(stride, static, seed=4):
    """A quantized JAX conv 24 -> 40 with a bias (and x_scale if static),
    and the same layer as the port's QConv2d."""
    rng = _rng(seed)
    p = {"w": (rng.standard_normal((3, 3, 24, 40)) * 0.05).astype(np.float32),
         "b": (rng.standard_normal(40) * 0.1).astype(np.float32)}
    if static:
        p["x_scale"] = np.float32(2.5 / 127)
    qp = jax.tree.map(np.asarray, jcore.quantize_conv(jax.tree.map(jnp.asarray, p)))
    sd = params_from_jax({"net": {"down": qp, "res_down": [], "up": qp}, "size": "normal"})
    layer = nn_core.QConv2d(torch.zeros(40, 24, 3, 3, dtype=torch.int8), torch.zeros(40),
                            stride, 1)
    layer.load_state_dict({k.split(".")[-1]: v for k, v in sd.items()
                           if k.startswith("netG.model.model.0.")})
    return qp, layer


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("static", [False, True])
def test_quantized_layer_matches_jax(stride, static):
    """One full int8 layer (quantize, s8 conv, rescale, bias) given the same
    input: bitwise in f32, and in bf16 too (measured: 0 values differ; the
    bound stated for bf16 is 1 bf16 ulp, |y| * 2^-7, since the frameworks
    may round the quantize and rescale chain at other places)."""
    qp, layer = _q_layer(stride, static)
    x = _rng(5).standard_normal((2, 11, 9, 24)).astype(np.float32)
    ref = np.asarray(jcore.conv2d(jax.tree.map(jnp.asarray, qp), jnp.asarray(x), stride, 1))
    ours = nn_core.conv2d(torch.tensor(x).permute(0, 3, 1, 2), layer, stride, 1)
    np.testing.assert_array_equal(ours.permute(0, 2, 3, 1).numpy(), ref)

    qp16 = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16)
                        if np.asarray(a).dtype == np.float32 else jnp.asarray(a), qp)
    ref16 = np.asarray(jcore.conv2d(qp16, jnp.asarray(x).astype(jnp.bfloat16), stride, 1)
                       ).astype(np.float32)
    ours16 = nn_core.conv2d(torch.tensor(x).permute(0, 3, 1, 2).bfloat16(),
                            layer.to(torch.bfloat16), stride, 1)
    ours16 = ours16.float().permute(0, 2, 3, 1).numpy()
    bound = np.abs(ref16) * 2.0 ** -7
    assert (np.abs(ours16 - ref16) <= bound).all()


def test_cast_generator_leaves_int8_weights():
    model = f2f.quantize_generator(_port_generator(_jax_generator(6)))
    cast = f2f.cast_generator(model, torch.bfloat16)
    conv = cast.netG.model.model[2].block[0]
    assert isinstance(conv, nn_core.QConv2d)
    assert conv.w_q.dtype == torch.int8 and conv.w_scale.dtype == torch.bfloat16
    assert conv.w_q.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(conv.w_q, model.netG.model.model[2].block[0].w_q)
    assert f2f.cast_generator(cast, torch.bfloat16) is cast  # already cast: no copy


def test_quantize_generator_structure_matches_jax():
    """The outermost down and up convs stay float, every other conv is int8
    (44 per 'normal' forward at 8 downsamplings, 26 at 5), with JAX's
    weights and scales bit for bit."""
    tree = _jax_generator(7)
    ours = f2f.quantize_generator(_port_generator(tree))
    ref = jax.tree.map(np.asarray, jf2f.quantize_generator(tree))
    assert sum(isinstance(m, nn_core.QConv2d) for m in ours.modules()) == 26
    assert isinstance(ours.netG.model.model[0], torch.nn.Conv2d)
    got = params_to_jax(ours)
    jax.tree.map(np.testing.assert_array_equal, got, ref)


@pytest.mark.parametrize("quantized", [False, True])
def test_fold_bn_matches_unfolded(quantized):
    """Folding is an exact rewrite of the eval forward up to f32 rounding
    (atol 2e-5, as the JAX package's own test), and leaves each BN at JAX's
    identity values; the folded leaves equal JAX's fold within 8 f32 ulps
    (measured 2: torch and XLA round rsqrt differently)."""
    tree = _jax_generator(8, noisy_bn=True)
    model = _port_generator(tree)
    if quantized:
        model = f2f.quantize_generator(model)
    x = _inputs(9)
    folded = f2f.fold_bn_generator(model)
    np.testing.assert_allclose(_port_apply(folded, x), _port_apply(model, x), atol=2e-5)
    bn = folded.netG.model.model[3].model[1]  # the second stage's down BN
    assert torch.equal(bn.running_var, torch.full_like(bn.running_var, 1 - 1e-5))
    assert torch.equal(bn.weight, torch.ones_like(bn.weight))
    jtree = jf2f.quantize_generator(tree) if quantized else tree
    ref = jax.tree.map(np.asarray, jf2f.fold_bn_generator(jtree))
    def close(a, b):
        if a.dtype == np.int8:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_array_max_ulp(a, b, maxulp=8)

    jax.tree.map(close, params_to_jax(folded)["net"], ref["net"])


def test_calibrated_scales_match_jax():
    """calibrate_generator on a quantized, folded tree: every x_scale equals
    JAX's for the same conv (rtol 1e-6), which proves the walk order."""
    tree = jax.tree.map(np.asarray,
                        jf2f.fold_bn_generator(jf2f.quantize_generator(_jax_generator(10))))
    calib = [_inputs(11), _inputs(12)]
    ref = jf2f.calibrate_generator(tree, [jnp.asarray(c) for c in calib])
    ours = f2f.calibrate_generator(_port_generator(tree), [torch.tensor(c) for c in calib])
    got = params_to_jax(ours)
    scales = []

    def check(path, a, b):
        if path[-1].key == "x_scale":
            scales.append(float(a))
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6)

    jax.tree_util.tree_map_with_path(check, got, jax.tree.map(np.asarray, ref))
    assert len(scales) == 26 and len(set(scales)) > 20


def test_quantized_generator_matches_jax():
    """JAX's quantized, folded and calibrated tree converted to the port:
    the same forward in f32 and in bf16.  Measured: max 1.1e-8 over the
    tanh output in both (|y| <= 0.06); bound 1e-7."""
    tree = jax.tree.map(np.asarray,
                        jf2f.fold_bn_generator(jf2f.quantize_generator(_jax_generator(13))))
    tree = jax.tree.map(np.asarray, jf2f.calibrate_generator(tree, jnp.asarray(_inputs(14))))
    model = _port_generator(tree)
    x = _inputs(15)
    ref, _ = jf2f.apply_generator(tree, jnp.asarray(x))
    np.testing.assert_allclose(_port_apply(model, x), np.asarray(ref), atol=1e-7, rtol=0)
    jtree = dict(tree, net=jax.tree.map(jnp.asarray, tree["net"]))
    ref16, _ = jf2f.apply_generator(jtree, jnp.asarray(x), compute_dtype=jnp.bfloat16)
    np.testing.assert_allclose(_port_apply(model, x, torch.bfloat16), np.asarray(ref16),
                               atol=1e-7, rtol=0)


def test_int8_generator_close_to_float():
    """The port's own int8 generator against its float forward: PSNR above
    28 dB, as the JAX package requires of its own."""
    model = _port_generator(_jax_generator(16))
    x = _inputs(17)
    y = _port_apply(model, x)
    yq = _port_apply(f2f.quantize_generator(model), x)
    assert _psnr(yq, y) > 28.0 and np.any(yq != y)


def test_calibration_errors():
    model = _port_generator(_jax_generator(18))
    with pytest.raises(ValueError, match="recorded no activations"):
        f2f.calibrate_generator(model, torch.tensor(_inputs(19)))
    q = f2f.quantize_generator(model)
    with pytest.raises(RuntimeError, match="walk visited more"):
        f2f._assign_x_scales(q, np.ones(25, np.float32))
    with pytest.raises(RuntimeError, match="1 more conv activations"):
        f2f._assign_x_scales(q, np.ones(27, np.float32))
    q.size = "small"
    for fn in (f2f.quantize_generator, f2f.fold_bn_generator):
        with pytest.raises(NotImplementedError):
            fn(q)
    with pytest.raises(NotImplementedError):
        f2f.calibrate_generator(q, torch.tensor(_inputs(19)))


def _bn_names(model) -> set:
    return {n for n, m in model.named_modules() if isinstance(m, torch.nn.BatchNorm2d)}


def _marked(model) -> set:
    return {n for n, m in model.named_modules() if getattr(m, "folded", False)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_skipping_folded_bns_is_bitwise(dtype):
    """A quantized, folded and calibrated tree skips every BN the fold left
    at the identity; its calibration scales and its frames equal, bit for
    bit, those of the same tree with every BN applied (a copy whose marks
    are cleared)."""
    q = f2f.fold_bn_generator(f2f.quantize_generator(_port_generator(
        _jax_generator(23, noisy_bn=True))))
    full = copy.deepcopy(q)
    for m in full.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.folded = False
    assert _marked(q) == _bn_names(q) and len(_bn_names(q)) == f2f.folded_bn_count(q) == 25
    assert f2f.folded_bn_count(full) == 0
    calib = torch.tensor(_inputs(24))
    q, full = (f2f.calibrate_generator(m, calib, compute_dtype=dtype) for m in (q, full))
    scales = [(a, b) for a, b in zip(q.state_dict().items(), full.state_dict().items())
              if a[0].endswith("x_scale")]
    assert len(scales) == 26 and all(torch.equal(a[1], b[1]) for a, b in scales)
    x = torch.tensor(_inputs(25))
    with torch.no_grad():
        y, y_full = (f2f.apply_generator(f2f.cast_generator(m, dtype), x) for m in (q, full))
    assert torch.equal(y, y_full)
    assert torch.equal(f2f.to_uint8(y), f2f.to_uint8(y_full))


def test_a_marked_bn_still_normalises_in_training():
    """The mark is honoured in eval mode only: training normalises with the
    batch's statistics and moves the running stats as before."""
    q = f2f.fold_bn_generator(_port_generator(_jax_generator(26)))
    bn = q.netG.model.model[3].model[1]  # the second stage's down BN
    assert bn.folded
    x = torch.tensor(_rng(27).normal(2.0, 3.0, (4, bn.num_features, 5, 5)).astype(np.float32))
    assert nn_core.batchnorm(x, bn) is x
    plain = torch.nn.BatchNorm2d(bn.num_features)
    plain.load_state_dict(bn.state_dict())
    y = nn_core.batchnorm(x, bn, training=True)
    torch.testing.assert_close(y, nn_core.batchnorm(x, plain, training=True), rtol=0, atol=0)
    assert y.abs().mean() < 1.0 and not torch.allclose(y, x)
    assert torch.equal(bn.running_mean, plain.running_mean) and bn.running_mean.abs().sum() > 0


def _from_jax(f2f_tree):
    """assets.from_jax on a person whose renderer is ``f2f_tree`` (the motion
    models: the port's seed-0 init, through params_to_jax)."""
    cfg = torch_config(dataclasses.replace(small_person_config(image_size=32),
                                           feature2face=CFG))
    base = assets.init_models(cfg, 0)
    trees = {n: params_to_jax(getattr(base, n)) for n in assets.MODEL_FIELDS}
    return cfg, assets.from_jax(cfg, types.SimpleNamespace(**dict(trees, feature2face=f2f_tree)),
                                device="cpu")


@pytest.mark.parametrize("source,marks", [
    ("float", False), ("float_jax", False), ("fold_float", True), ("fold_int8", True),
    ("jax_fold", True), ("artifact", True), ("artifact_bf16", False)])
def test_folded_bns_are_marked_wherever_the_tree_comes_from(source, marks, tmp_path):
    """fold_bn_generator marks every BN of the ResUNet; a folded tree
    converted from JAX (jf2f.fold_bn_generator) or booted from a serving
    artifact marks the same ones; an unfolded tree marks none.  A folded
    tree cast to bf16 and written loads as f32 with var 1, whose BN is not
    the identity in f32: it marks none."""
    tree = _jax_generator(28, noisy_bn=True)
    if source == "float":
        model = f2f.mark_folded_bn(_port_generator(tree))
    elif source == "float_jax":
        model = _from_jax(tree)[1].feature2face
    elif source == "fold_float":
        model = f2f.fold_bn_generator(_port_generator(tree))
    elif source == "fold_int8":
        model = f2f.fold_bn_generator(f2f.quantize_generator(_port_generator(tree)))
    elif source == "jax_fold":
        folded = jf2f.fold_bn_generator(jf2f.quantize_generator(tree))
        model = _from_jax(jax.tree.map(np.asarray, folded))[1].feature2face
        assert any(isinstance(m, nn_core.QConv2d) for m in model.modules())
    else:
        cfg, models = _from_jax(tree)
        net = f2f.fold_bn_generator(f2f.quantize_generator(models.feature2face))
        if source == "artifact_bf16":
            net = f2f.cast_generator(net, torch.bfloat16)
        path = assets.save_models_artifact(dataclasses.replace(models, feature2face=net),
                                           str(tmp_path / "serving.npz"))
        model = assets.load_models_artifact(path, cfg, device="cpu").feature2face
    assert len(_bn_names(model)) == 25
    assert _marked(model) == (_bn_names(model) if marks else set())
    assert f2f.folded_bn_count(model) == len(_marked(model))


def test_recording_is_scoped_to_the_block():
    q = f2f.quantize_generator(_port_generator(_jax_generator(20)))
    with nn_core.recording_amax(q) as record:
        f2f.apply_generator(q, torch.tensor(_inputs(21)))
    assert len(record) == 26
    assert all(m.amax_record is None for m in q.modules() if isinstance(m, nn_core.QConv2d))


def test_q8conv_dispatch_has_no_fallback():
    """A CPU tensor takes the twin; any device but the CPU and CUDA raises
    (a CUDA tensor launches K4 or raises: tests/test_torch_cuda.py)."""
    x = torch.zeros(1, 16, 4, 4, dtype=torch.int8)
    w = torch.zeros(8, 16, 3, 3, dtype=torch.int8)
    assert q8conv_cuda.conv_s8(x, w, 1).shape == (1, 8, 4, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        q8conv_cuda.conv_s8(x.to("meta"), w.to("meta"), 1)


# ---------------------------------------------------------------------------
# the fused K4 path: quantize + int8 conv + rescale in one call (conv_q8)
# ---------------------------------------------------------------------------


def _tie_input(seed: int) -> np.ndarray:
    """NHWC f32 values m / 16 with |m| <= 508: with r = 4 (the dynamic and
    calibrated scale 0.25, amax 31.75 pinned) every m = 2 mod 4 is an exact
    rounding tie; with r = 8 (the static scale 0.125) every odd m is, and
    |x * r| reaches 254, past the clamp."""
    x = _rng(seed).integers(-508, 509, (2, 11, 9, 32)).astype(np.float32) / 16
    x[0, 0, 0, 0], x[1, 3, 2, 1] = 31.75, -31.75
    return x


def _fused_layer(stride: int, x_scale):
    """A quantized JAX conv 32 -> 40 with a bias, and the same QConv2d."""
    rng = _rng(30)
    p = {"w": (rng.standard_normal((3, 3, 32, 40)) * 0.05).astype(np.float32),
         "b": (rng.standard_normal(40) * 0.1).astype(np.float32)}
    qp = jax.tree.map(np.asarray, jcore.quantize_conv(jax.tree.map(jnp.asarray, p)))
    layer = nn_core.QConv2d(torch.tensor(qp["w_q"].transpose(3, 2, 0, 1).copy()),
                            torch.tensor(qp["w_scale"]), stride, 1, b=torch.tensor(qp["b"]))
    if x_scale is not None:
        qp["x_scale"] = np.float32(x_scale)
        layer.x_scale = torch.tensor(x_scale, dtype=torch.float32)
    return qp, layer


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("mode", ["static", "dynamic", "calibration"])
def test_fused_int8_layer_matches_jax_bitwise(dtype, stride, mode):
    """nn_core.conv2d_q8 on the CPU (conv_q8's plain twin: quantize, float64
    conv, rescale) against JAX's _conv2d_q8, bit for bit in f32 and bf16,
    for each of the three activation scales, on inputs with exact rounding
    ties (half to even in both) and, for the static scale, values past
    +-127."""
    qp, layer = _fused_layer(stride, 0.125 if mode == "static" else None)
    x = _tie_input(31)
    r = 8.0 if mode == "static" else 4.0
    assert np.any(np.abs(x * r) % 1 == 0.5)
    if mode == "static":
        assert np.abs(x * r).max() > 127
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq = jax.tree.map(lambda a: jnp.asarray(a).astype(jdt)
                      if np.asarray(a).dtype == np.float32 else jnp.asarray(a), qp)
    xj = jnp.asarray(x).astype(jdt)
    if mode == "calibration":
        jcore.begin_calibration()
    ref = np.asarray(jcore.conv2d(jq, xj, stride, 1).astype(jnp.float32))
    ours_layer = layer.to(tdt)
    xt = torch.tensor(x).permute(0, 3, 1, 2).to(tdt)
    if mode == "calibration":
        j_amax = jcore.end_calibration()
        with nn_core.recording_amax(ours_layer) as record:
            ours = nn_core.conv2d(xt, ours_layer, stride, 1)
        assert float(record[0]) == float(j_amax[0]) == 31.75
    else:
        ours = nn_core.conv2d(xt, ours_layer, stride, 1)
    assert ours.dtype == tdt
    np.testing.assert_array_equal(ours.float().permute(0, 2, 3, 1).numpy(), ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_plain_matches_jax(dtype):
    """The quantize half of the twin against JAX's _quantize_activation
    with a static scale: the same int8 values, ties and clamp included."""
    qp, _ = _fused_layer(1, 0.125)
    x = _tie_input(32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq = dict(qp, x_scale=jnp.asarray(qp["x_scale"]).astype(jdt))
    x_q, s_x, _ = jcore._quantize_activation(jq, jnp.asarray(x).astype(jdt))
    r = torch.reciprocal(torch.tensor(float(s_x))).to(tdt)
    ours = q8conv_cuda.quantize_plain(torch.tensor(x).to(tdt), r)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(x_q))
    assert ours.abs().max() == 127


def test_conv_q8_checks_its_inputs():
    """conv_q8 takes float activations in channels_last memory with r on
    their device; it raises otherwise, on every device (a host r beside a
    CUDA x: tests/test_torch_cuda.py)."""
    cl = torch.channels_last
    x = torch.randn(1, 16, 4, 4).contiguous(memory_format=cl)
    w = torch.zeros(8, 16, 3, 3, dtype=torch.int8)
    r, scale = torch.tensor(2.0), torch.ones(8)
    y = q8conv_cuda.conv_q8(x, r, w, 1, 1, scale)
    assert y.shape == (1, 8, 4, 4) and y.dtype == torch.float32
    with pytest.raises(TypeError, match="dtype"):
        q8conv_cuda.conv_q8(x.to(torch.int8), r, w, 1, 1, scale)
    with pytest.raises(ValueError, match="channels_last"):
        q8conv_cuda.conv_q8(x.contiguous(), r, w, 1, 1, scale)
    with pytest.raises(ValueError, match="unsupported device"):
        q8conv_cuda.conv_q8(x.to("meta"), r.to("meta"), w, 1, 1, scale)
    with pytest.raises(ValueError, match="r must be"):
        q8conv_cuda.conv_q8(x, r.to("meta"), w, 1, 1, scale)
    with pytest.raises(ValueError, match="r must be"):
        q8conv_cuda.conv_q8(x, r.to(torch.bfloat16), w, 1, 1, scale)


def test_static_operands_are_kept_until_the_scales_change():
    """A calibrated conv computes (r, scale) once per dtype; a cast, a new
    buffer or an in-place change of x_scale recomputes them."""
    _, layer = _fused_layer(1, 0.125)
    r, scale = layer.static_operands(torch.float32)
    assert layer.static_operands(torch.float32)[0] is r and float(r) == 8.0
    torch.testing.assert_close(scale, layer.w_scale * 0.125, rtol=0, atol=0)
    assert layer.static_operands(torch.bfloat16)[0].dtype == torch.bfloat16
    layer.x_scale.fill_(0.25)
    assert float(layer.static_operands(torch.float32)[0]) == 4.0
    layer.to(torch.bfloat16)
    r16, _ = layer.static_operands(torch.bfloat16)
    assert r16 is layer.static_operands(torch.bfloat16)[0] and float(r16) == 4.0


def test_int8_conv_shapes_follow_the_forward(monkeypatch):
    """feature2face.int8_conv_shapes lists the shapes conv_q8 receives, in
    call order: 26 at test widths; 44 in the 'normal' 512^2 ResUNet, 2.61
    int8 TOP per 16-frame batch."""
    seen = []
    real = q8conv_cuda.conv_q8

    def spy(x, r, w_q, stride, padding, scale, bias=None):
        seen.append((x.shape[2], x.shape[1], w_q.shape[0], stride))
        return real(x, r, w_q, stride, padding, scale, bias)

    monkeypatch.setattr(q8conv_cuda, "conv_q8", spy)
    _port_apply(f2f.quantize_generator(_port_generator(_jax_generator(33))), _inputs(34))
    assert seen == f2f.int8_conv_shapes(CFG)
    shapes = f2f.int8_conv_shapes(torch_config(Feature2FaceConfig()))
    assert len(shapes) == 44 and shapes[0] == (256, 64, 64, 1) and shapes[-1] == (256, 64, 64, 1)
    ops = sum(2 * 16 * (h // s) ** 2 * ci * co * 9 for h, ci, co, s in shapes)
    assert round(ops / 1e12, 2) == 2.61


@pytest.mark.parametrize("m,cout,cin,halo,want", [
    (64, 512, 512, False, (4, 18)), (1024, 512, 512, False, (8, 9)),
    (4096, 512, 512, False, (24, 3)), (16384, 512, 512, False, (72, 1)),
    (1 << 20, 64, 64, False, (9, 1)), (8, 24, 48, False, (4, 3)),
    (4096, 512, 512, True, (27, 3)), (512, 512, 512, True, (9, 8)),
    (2048, 512, 1024, True, (36, 4)), (1 << 20, 64, 256, True, (36, 1))])
def test_split_k_covers_the_k_loop(m, cout, cin, halo, want):
    """K is split only when the output tiles fall short of the SMs, every
    split has at least one K iteration, and the halo kernel's splits hold
    whole 64-channel slices (9 iterations each)."""
    per, splits = q8conv_cuda.split_k(m, cout, cin, halo)
    n_iter = 9 * -(-cin // 64)
    assert (per, splits) == want
    assert (splits - 1) * per < n_iter <= splits * per
    assert not halo or per % 9 == 0


def test_halo_kernel_takes_the_stride_1_resunet_maps():
    """csrc/q8conv.cu's halo kernel (8 x 16 output patches) takes every
    stride-1 conv of the 'normal' ResUNet from 256^2 to 16^2; stride 2,
    the 8^2 to 2^2 maps and ragged maps take the gather kernel."""
    shapes = f2f.int8_conv_shapes(torch_config(Feature2FaceConfig()))
    halo = [(h, s) for h, _, _, s in shapes if q8conv_cuda.uses_halo(h, h, s, 1)]
    assert halo and all(s == 1 and h >= 16 for h, s in halo)
    assert sum(s == 1 and h >= 16 for h, _, _, s in shapes) == len(halo) == 25
    assert not q8conv_cuda.uses_halo(40, 43, 1, 1) and not q8conv_cuda.uses_halo(16, 16, 1, 0)
    assert q8conv_cuda.uses_halo(8, 32, 1, 1)
