"""PyTorch port, quantization-aware training: nn_core's QAT convs ("fq", the
f32 emulation; "fq8", the int8 kernel's twin with straight-through
gradients), feature2face's qat_generator / strip_qat_generator /
qat_discriminator and calibration on a tagged model, each against the JAX
package on the same numpy inputs at test widths (ngf 8, 5 downsamplings,
32^2; num_D 2, n_layers_D 3), and K4's plain twin at the discriminator's 4x4
taps.  The counterparts of JAX's tests/test_feature2face.py:558-875."""

import copy

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
from livespeechportraits_torch.utils.convert import params_from_jax
from torch_parity import torch_config

CFG = Feature2FaceConfig(size="normal", ngf=8, n_downsample=5, load_size=32, ndf=16,
                         num_D=2, n_layers_D=3)
# The f32 emulation and its gradients: both sides compute the same float
# expressions; their convolutions sum in other orders (~1e-7 relative), so
# each value is held within 1e-5 of the largest magnitude.
REL = 1e-5


def _rng(seed):
    return np.random.default_rng(seed)


def _close(got, want, rel=REL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= rel, f"{what}: {err:.3e} of the largest magnitude > {rel}"


def _conv_case(seed, cin, cout, k, bias=True):
    """A JAX conv's params (HWIO numpy) and the port's nn.Conv2d holding the
    same weights."""
    rng = _rng(seed)
    p = {"w": (rng.standard_normal((k, k, cin, cout)) * 0.05).astype(np.float32)}
    conv = torch.nn.Conv2d(cin, cout, k, bias=bias)
    with torch.no_grad():
        conv.weight.copy_(torch.tensor(p["w"].transpose(3, 2, 0, 1).copy()))
        if bias:
            p["b"] = (rng.standard_normal(cout) * 0.1).astype(np.float32)
            conv.bias.copy_(torch.tensor(p["b"]))
    return p, conv


def _jx(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _nchw(x):
    return torch.tensor(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


# (cin, cout, kernel, stride, padding, input size): the renderer's 3x3 convs
# and the discriminator's 4x4 ones (padding 2, odd output sizes)
CONVS = {"3x3": (16, 24, 3, 1, 1, 10), "3x3_s2": (16, 24, 3, 2, 1, 11),
         "4x4_s2": (16, 32, 4, 2, 2, 13), "4x4_s1": (32, 16, 4, 1, 2, 9)}


def _grads_jax(tagged, x, stride, padding):
    def loss(w, xx, b):
        return jnp.sum(jnp.sin(jcore.conv2d(dict(tagged, w=w, b=b), xx, stride, padding)))

    return jax.grad(loss, argnums=(0, 1, 2))(tagged["w"], jnp.asarray(x), tagged["b"])


def _grads_port(layer, x, stride, padding):
    xt = _nchw(x).requires_grad_()
    y = nn_core.conv2d(xt, layer, stride, padding)
    gw, gx, gb = torch.autograd.grad(torch.sin(y).sum(), (layer.weight, xt, layer.bias))
    return y, gw.permute(2, 3, 1, 0).numpy(), _nhwc(gx), gb.numpy()


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "x_scale"])
@pytest.mark.parametrize("case", list(CONVS))
def test_fq_conv_forward_and_gradients_match_jax(case, static):
    cin, cout, k, stride, pad, size = CONVS[case]
    p, conv = _conv_case(1, cin, cout, k)
    x = (_rng(2).standard_normal((2, size, size, cin))).astype(np.float32)
    if static:  # a scale that clips the largest activations
        p["x_scale"] = np.float32(np.abs(x).max() / 160)
    layer = nn_core.fake_quant_conv(conv)
    if static:
        layer.x_scale = torch.tensor(p["x_scale"])
    tagged = jcore.fake_quant_conv(_jx(p))
    y_ref = jcore.conv2d(tagged, jnp.asarray(x), stride, pad)
    gw_ref, gx_ref, gb_ref = _grads_jax(tagged, x, stride, pad)
    y, gw, gx, gb = _grads_port(layer, x, stride, pad)
    _close(_nhwc(y), y_ref, what="forward")
    _close(gw, gw_ref, what="d/dw")
    _close(gx, gx_ref, what="d/dx")
    _close(gb, gb_ref, what="d/db")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "x_scale"])
@pytest.mark.parametrize("case", list(CONVS))
def test_fq8_forward_equals_jax_and_the_deployed_layer_bitwise(case, static, dtype):
    """An fq8 conv's output is JAX's _conv2d_fakequant_int8's and the
    deployed QConv2d's (a bf16 one: its float buffers cast, as
    cast_generator casts them), bit for bit; the weights are the f32
    masters in both QAT forwards."""
    cin, cout, k, stride, pad, size = CONVS[case]
    p, conv = _conv_case(3, cin, cout, k)
    x = (_rng(4).standard_normal((2, size, size, cin)) * 1.5).astype(np.float32)
    layer = nn_core.fake_quant_conv(conv, int8_forward=True)
    deployed = nn_core.QConv2d.from_conv(conv)
    if static:
        p["x_scale"] = np.float32(0.021)
        layer.x_scale = torch.tensor(p["x_scale"])
        deployed.x_scale = torch.tensor(p["x_scale"])
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                         torch.bfloat16)
    ref = jcore.conv2d(jcore.fake_quant_conv(_jx(p), int8_forward=True),
                       jnp.asarray(x).astype(jdt), stride, pad)
    xt = _nchw(x).to(tdt).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        y = nn_core.conv2d(xt, layer, stride, pad)
        y_dep = nn_core.conv2d(xt, copy.deepcopy(deployed).to(tdt), stride, pad)
    assert y.dtype == tdt and ref.dtype == jdt
    np.testing.assert_array_equal(_nhwc(y), np.asarray(ref, np.float32))
    assert torch.equal(y, y_dep)


@pytest.mark.parametrize("case", list(CONVS))
def test_fq8_gradients_match_jax_custom_vjp(case):
    """The straight-through backward against JAX's _q8_ste_bwd: the f32
    gradients of conv(x_fq, w_fq), dx masked where the quantized value
    clips; and against the emulation's, which passes half the gradient at
    values exactly on the grid's edge (each channel's largest |w|, the
    batch's largest |x|) and the full one elsewhere."""
    cin, cout, k, stride, pad, size = CONVS[case]
    p, conv = _conv_case(5, cin, cout, k)
    x = _rng(6).standard_normal((2, size, size, cin)).astype(np.float32)
    tagged = jcore.fake_quant_conv(_jx(p), int8_forward=True)
    gw_ref, gx_ref, gb_ref = _grads_jax(tagged, x, stride, pad)
    _, gw, gx, gb = _grads_port(nn_core.fake_quant_conv(conv, int8_forward=True), x, stride,
                                pad)
    _close(gw, gw_ref, what="d/dw")
    _close(gx, gx_ref, what="d/dx")
    _close(gb, gb_ref, what="d/db")
    _, gw_f, gx_f, _ = _grads_port(nn_core.fake_quant_conv(conv), x, stride, pad)
    w = p["w"]
    tie_w = np.abs(np.round(w / (np.abs(w).max(axis=(0, 1, 2)) / 127.0))) >= 127
    tie_x = np.abs(np.round(x / (np.abs(x).max() / 127.0))) >= 127
    assert tie_w.any() and tie_x.any()
    _close(gw[~tie_w], gw_f[~tie_w], 1e-4, "d/dw off the edge")
    _close(gw[tie_w], 2 * gw_f[tie_w], 1e-4, "d/dw on the edge")
    _close(gx[~tie_x], gx_f[~tie_x], 1e-4, "d/dx off the edge")


def test_fq8_clip_mask_zeroes_saturated_activations():
    """With a static x_scale that clips, the saturated inputs get no
    gradient, in fq8 and fq alike and as in JAX; elsewhere the two agree
    (but on the grid's edge, where the emulation passes half)."""
    p, conv = _conv_case(7, 16, 8, 3)
    x = _rng(8).standard_normal((1, 8, 8, 16)).astype(np.float32)
    s = float(np.abs(x).max()) / 300.0
    p["x_scale"] = np.float32(s)
    sat = np.abs(np.round(x / np.float32(s))) > 127
    assert sat.any() and not sat.all()
    grads = {}
    for mode in ("fq", "fq8"):
        layer = nn_core.fake_quant_conv(conv, int8_forward=mode == "fq8")
        layer.x_scale = torch.tensor(p["x_scale"])
        xt = _nchw(x).requires_grad_()
        grads[mode] = _nhwc(torch.autograd.grad(nn_core.conv2d(xt, layer, 1, 1).sum(), xt)[0])
        assert np.abs(grads[mode][sat]).max() == 0.0
    ref = jax.grad(lambda xx: jnp.sum(jcore.conv2d(
        jcore.fake_quant_conv(_jx(p), int8_forward=True), xx, 1, 1)))(jnp.asarray(x))
    _close(grads["fq8"], ref, what="fq8 against JAX")
    edge = np.abs(np.round(x / np.float32(s))) == 127
    np.testing.assert_allclose(grads["fq8"][~edge], grads["fq"][~edge], atol=1e-5)


def test_fake_quant_conv_refuses_a_double_tag_and_an_int8_layer():
    conv = torch.nn.Conv2d(4, 6, 3)
    tagged = nn_core.fake_quant_conv(conv)
    assert tagged.weight is conv.weight and tagged.mode == "fq"
    with pytest.raises(ValueError, match="already carries"):
        nn_core.fake_quant_conv(tagged, int8_forward=True)
    with pytest.raises(ValueError, match="got int8"):
        nn_core.fake_quant_conv(nn_core.QConv2d.from_conv(conv))
    with pytest.raises(ValueError, match="QAT mode"):
        nn_core.QATConv2d(4, 6, 3, mode="int4")


# ---------------------------------------------------------------------------
# the generator and the discriminator
# ---------------------------------------------------------------------------


def _generators(seed):
    """(JAX tree with numpy leaves, the port's generator of the same
    weights, in f32)."""
    raw = jf2f.init_generator(jax.random.PRNGKey(seed), CFG)
    tree = {"net": jax.tree.map(np.asarray, raw["net"]), "size": raw["size"]}
    model = f2f.Feature2FaceG(torch_config(CFG)).eval()
    model.load_state_dict(params_from_jax(tree), strict=True)
    return tree, model


def _jtree(tree):
    return {"net": jax.tree.map(jnp.asarray, tree["net"]), "size": tree["size"]}


def _x(seed, n=2):
    return _rng(seed).uniform(-1, 1, (n, 32, 32, CFG.input_nc)).astype(np.float32)


def _tagged(model, cls=nn_core.QATConv2d):
    return [name for name, m in model.named_modules() if isinstance(m, cls)]


def test_qat_generator_tags_exactly_the_quantized_convs():
    """qat_generator tags quantize_generator's convs (the outermost stage's
    own down and up convs stay float), on a copy, keeping the state-dict
    keys; strip_qat_generator restores the float forward exactly; 'small'
    and a double tag are refused."""
    _, model = _generators(10)
    for int8 in (False, True):
        qat = f2f.qat_generator(model, int8_forward=int8)
        assert _tagged(qat) == _tagged(f2f.quantize_generator(model), nn_core.QConv2d)
        assert len(_tagged(qat)) == 26 and not f2f.is_qat_generator(model)
        assert f2f.qat_tag_mode(qat) == ("fq8" if int8 else "fq")
        assert list(qat.state_dict()) == list(model.state_dict())
        assert "netG.model.model.0" not in _tagged(qat)
        with pytest.raises(ValueError, match="already carries"):
            f2f.qat_generator(qat)
        stripped = f2f.strip_qat_generator(qat)
        assert f2f.qat_tag_mode(stripped) is None and _tagged(qat)  # qat itself keeps its tags
        x = torch.tensor(_x(11))
        with torch.no_grad():
            assert torch.equal(f2f.apply_generator(stripped, x), f2f.apply_generator(model, x))
    small = f2f.Feature2FaceG(torch_config(Feature2FaceConfig(size="small", ngf=8,
                                                              n_downsample=5, load_size=32)))
    with pytest.raises(NotImplementedError, match="ResUNet"):
        f2f.qat_generator(small)


@pytest.mark.parametrize("int8", [False, True], ids=["fq", "fq8"])
def test_qat_generator_forward_and_gradients_match_jax(int8):
    """The tagged generator's training forward and its weights' gradients
    against JAX's qat_generator: within the rounding of a few activations to
    the other int8 grid step (the float convs between sum in other orders;
    JAX's own QAT-vs-deployed bound, 2e-4), and the gradients within
    0.5 % of the largest."""
    tree, model = _generators(12)
    x, tgt = _x(13), _rng(14).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    jq = jf2f.qat_generator(_jtree(tree), int8_forward=int8)

    def jloss(net):
        y, _ = jf2f.apply_generator({"net": net, "size": "normal"}, jnp.asarray(x),
                                    training=True)
        return jnp.mean((y - jnp.asarray(tgt)) ** 2), y

    (_, y_ref), g_ref = jax.value_and_grad(jloss, has_aux=True)(jq["net"])
    qat = f2f.qat_generator(model.train(), int8_forward=int8)
    y = f2f.apply_generator(qat, torch.tensor(x), training=True)
    loss = torch.mean((y - torch.tensor(tgt)) ** 2)
    names = ["netG.model.model.3.model.0.weight", "netG.model.model.2.block.0.weight"]
    params = dict(qat.named_parameters())
    grads = torch.autograd.grad(loss, [params[n] for n in names])
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), atol=2e-4)
    want = [g_ref["sub"]["down"]["w"], g_ref["res_down"][0]["conv1"]["w"]]
    for n, g, w in zip(names, grads, want):
        _close(g.permute(2, 3, 1, 0).numpy(), w, 5e-3, n)
        assert float(g.abs().max()) > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qat_int8_generator_equals_its_deployment_bitwise(dtype):
    """An fq8-tagged generator's eval forward is its deployed int8 forward
    (quantize_generator, then cast in bf16) bit for bit: in f32, and in
    bf16 with the f32 master weights under autocast as the trainer runs it
    (JAX test_feature2face.py:797)."""
    _, model = _generators(15)
    qat8 = f2f.qat_generator(model, int8_forward=True)
    deployed = f2f.cast_generator(f2f.quantize_generator(model), dtype)
    x = torch.tensor(_x(16))
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16,
                                         enabled=dtype == torch.bfloat16):
        y_qat = f2f.apply_generator(qat8, x)
    with torch.no_grad():
        y_dep = f2f.apply_generator(deployed, x)
    assert torch.equal(y_qat, y_dep)


def test_calibration_on_a_tagged_generator_carries_its_scales_to_deployment():
    """calibrate_generator records through a tagged tree (an fq8 one through
    the f32 emulation) the scales JAX records; strip + quantize carry them
    into the int8 layers; the calibrated fq8 forward then equals the
    deployed forward bitwise; an untagged float tree is refused."""
    tree, model = _generators(17)
    x = _x(18)
    ref = jf2f.calibrate_generator(jf2f.qat_generator(_jtree(tree), int8_forward=True),
                                   jnp.asarray(x))
    for int8 in (False, True):
        cal = f2f.calibrate_generator(f2f.qat_generator(model, int8_forward=int8),
                                      torch.tensor(x))
        down = cal.netG.model.model[3].model[0]
        assert isinstance(down, nn_core.QATConv2d) and down.x_scale is not None
        np.testing.assert_allclose(float(down.x_scale), float(ref["net"]["sub"]["down"]["x_scale"]),
                                   rtol=1e-6)
        deployed = f2f.quantize_generator(f2f.strip_qat_generator(cal))
        assert float(deployed.netG.model.model[3].model[0].x_scale) == float(down.x_scale)
        assert list(cal.state_dict()) == list(f2f.strip_qat_generator(cal).state_dict())
    with torch.no_grad():
        assert torch.equal(f2f.apply_generator(cal, torch.tensor(x)),
                           f2f.apply_generator(deployed, torch.tensor(x)))
    with pytest.raises(ValueError, match="no quantized or QAT-tagged"):
        f2f.calibrate_generator(model, torch.tensor(x))


def test_weight_bridge_carries_a_calibrated_qat_trees_scales():
    """A JAX QAT tree calibrated on a batch converts into the port's tagged
    generator with its x_scale buffers (the tags are not state), and back."""
    from livespeechportraits_torch.utils.convert import params_to_jax

    tree, model = _generators(19)
    cal = jf2f.calibrate_generator(jf2f.qat_generator(_jtree(tree)), jnp.asarray(_x(19)))
    sd = params_from_jax({"net": jax.tree.map(np.asarray, cal["net"]), "size": "normal"})
    qat = f2f.qat_generator(model)
    qat.load_state_dict(sd, strict=True)
    down = qat.netG.model.model[3].model[0]
    assert float(down.x_scale) == float(cal["net"]["sub"]["down"]["x_scale"])
    back = params_to_jax(qat)
    assert float(back["net"]["sub"]["down"]["x_scale"]) == float(down.x_scale)
    assert "x_scale" not in back["net"]["down"]


def _discriminators(seed):
    tree = jax.tree.map(np.asarray, jf2f.init_discriminator(jax.random.PRNGKey(seed), CFG))
    d = f2f.Feature2FaceD(torch_config(CFG))
    d.load_state_dict(params_from_jax(tree), strict=True)
    return tree, d


def test_qat_discriminator_tags_the_interior_of_every_scale():
    """Layers 1 .. n_layers_D of each scale are tagged (fq8 by default), the
    first and the logits conv stay float; the view shares D's parameters
    and BatchNorms and has D's state-dict keys; D itself is untouched."""
    _, d = _discriminators(20)
    view = f2f.qat_discriminator(d)
    want = [f"scale{i}_layer{j}.0" for i in range(2) for j in (1, 2, 3)]
    assert sorted(_tagged(view)) == want and not _tagged(d)
    assert {m.mode for m in view.modules() if isinstance(m, nn_core.QATConv2d)} == {"fq8"}
    assert f2f.qat_tag_mode(f2f.qat_discriminator(d, int8_forward=False)) == "fq"
    assert list(view.state_dict()) == list(d.state_dict())
    assert [p is q for p, q in zip(view.parameters(), d.parameters())] == [True] * len(
        list(d.parameters()))
    assert view.scale0_layer1[1] is d.scale0_layer1[1]


def test_qat_discriminator_forward_and_input_gradient_match_jax():
    """The tagged D in training mode against JAX's qat_discriminator: every
    scale's features, and the gradient that reaches the fake image through
    D (the straight-through one), within the rounding of a few activations
    to the other grid step."""
    tree, d = _discriminators(21)
    x = _rng(22).uniform(-1, 1, (2, 32, 32, CFG.input_nc + 3)).astype(np.float32)

    def jfeat(xx):
        out, _ = jf2f.apply_discriminator(jf2f.qat_discriminator(
            jax.tree.map(jnp.asarray, tree)), xx, training=True)
        return out

    ref = jfeat(jnp.asarray(x))
    g_ref = jax.grad(lambda xx: sum(jnp.sum(s[-1]) for s in jfeat(xx)))(jnp.asarray(x))
    xt = torch.tensor(x).requires_grad_()
    out = f2f.apply_discriminator(f2f.qat_discriminator(d), xt, training=True,
                                  update_stats=False)
    for k in range(2):
        for j, feat in enumerate(out[k]):
            _close(feat.detach().numpy(), ref[k][j], 2e-3, f"scale {k} layer {j}")
    g = torch.autograd.grad(sum(s[-1].sum() for s in out), xt)[0]
    _close(g.numpy(), g_ref, 5e-3, "d/d input")


# ---------------------------------------------------------------------------
# K4's plain twin at the discriminator's 4x4 taps
# ---------------------------------------------------------------------------


def _int_conv(x, w, stride, pad):
    """An exact integer conv in numpy (int64): x [B, C, H, W], w [O, C, k, k]."""
    k = w.shape[2]
    xp = np.pad(x.astype(np.int64), ((0, 0), (0, 0), (pad, pad), (pad, pad)))
    ho = (xp.shape[2] - k) // stride + 1
    wo = (xp.shape[3] - k) // stride + 1
    out = np.zeros((x.shape[0], w.shape[0], ho, wo), np.int64)
    for i in range(k):
        for j in range(k):
            patch = xp[:, :, i:i + stride * ho:stride, j:j + stride * wo:stride]
            out += np.einsum("bchw,oc->bohw", patch, w[:, :, i, j].astype(np.int64))
    return out


@pytest.mark.parametrize("stride,size", [(2, 13), (2, 14), (1, 9), (1, 8)])
def test_k4_twin_at_4x4_is_the_exact_integer_conv(stride, size):
    """conv_s8 (the K4 twin on the CPU) at 4x4, padding 2, odd and even
    sizes, at the int8 extremes: equal to an int64 numpy conv; and the
    geometry the kernel runs them with: the gather kernel, 16 taps a 64-channel
    slice, the split-K plan covering the loop."""
    rng = _rng(30)
    x = rng.integers(-127, 128, (2, 32, size, size), dtype=np.int8)
    x[0, :, 0] = -127
    w = rng.integers(-127, 128, (24, 32, 4, 4), dtype=np.int8)
    w[0] = 127
    got = q8conv_cuda.conv_s8(torch.tensor(x), torch.tensor(w), stride, 2)
    want = _int_conv(x, w, stride, 2)
    assert got.dtype == torch.int32 and got.shape[2] == (size + 4 - 4) // stride + 1
    np.testing.assert_array_equal(got.numpy(), want)
    assert not q8conv_cuda.uses_halo(size, size, stride, 2, 4)
    assert not q8conv_cuda.uses_halo(16, 16, 1, 1, 4) and q8conv_cuda.uses_halo(16, 16, 1, 1)


# The discriminator's interior convs at 512^2, B = 8, per scale: (input size,
# Cin, Cout, stride) -> output size
D_SHAPES = [((257, 64, 128, 2), 129), ((129, 128, 256, 2), 65), ((65, 256, 512, 1), 66),
            ((129, 64, 128, 2), 65), ((65, 128, 256, 2), 33), ((33, 256, 512, 1), 34)]


@pytest.mark.parametrize("shape,out", D_SHAPES)
def test_split_k_plans_the_discriminator_shapes(shape, out):
    size, cin, cout, stride = shape
    assert (size + 4 - 4) // stride + 1 == out
    per, splits = q8conv_cuda.split_k(8 * out * out, cout, cin, False, 4)
    n_iter = 16 * -(-cin // 64)
    assert (splits - 1) * per < n_iter <= splits * per and per >= 1
    # 127^2 * 16 * Cin sums stay exact in int32
    assert 127 ** 2 * 16 * cin < 2 ** 31


def test_launch_refuses_other_kernel_sizes():
    x = torch.zeros(1, 16, 8, 8, dtype=torch.int8).contiguous(memory_format=torch.channels_last)
    for k in (1, 5):
        w = torch.zeros(8, 16, k, k, dtype=torch.int8).contiguous(memory_format=torch.channels_last)
        with pytest.raises(ValueError, match="k 2, 3 or 4"):
            q8conv_cuda._launch(x, w, 1, 1, torch.int32, None, None, None)
