"""PyTorch port on the card: each CUDA kernel against its plain twin, and
the slice on the GPU against the same slice on the CPU.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU.  The
file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures JAX.)"""

import copy

import numpy as np
import pytest
import torch

from livespeechportraits_torch.config import Feature2FaceConfig, replace
from livespeechportraits_torch.models import feature2face, nn_core
from livespeechportraits_torch.ops import q8conv_cuda, rasterize, rasterize_cuda, recurrent_cuda
from livespeechportraits_torch.pipeline import animate, assets, video
from torch_parity import cuda_device, small_person_config, torch_config  # noqa: F401

pytestmark = pytest.mark.cuda


def _segments(n_frames: int, size: int) -> torch.Tensor:
    """Random integer segments plus block-edge crossings, a zero-length
    segment, off-canvas and negative endpoints and -1e6 padding."""
    rng = np.random.default_rng(0)
    table = np.trunc(rng.uniform(-10, size + 10, (n_frames, 100, 4))).astype(np.float32)
    extra = np.array([[31, 5, 33, size - 8], [0, 63, size - 1, 64], [50, 50, 50, 50],
                      [-20, -3, -1, -1], [size - 2, size - 2, size + 12, size + 70],
                      [-1e6, -1e6, -1e6, -1e6]], np.float32)
    return torch.tensor(np.concatenate([table, np.broadcast_to(extra, (n_frames, 6, 4))], 1))


def test_rasterizer_kernel_matches_plain_bitwise(cuda_device):
    table = _segments(3, 512).to(cuda_device)
    before = rasterize_cuda.LAUNCHES
    out = rasterize_cuda.rasterize_segments(table, 512, 512)
    ref = rasterize.rasterize_segments(table, 512, 512)
    torch.cuda.synchronize()
    assert rasterize_cuda.LAUNCHES == before + 1
    assert torch.equal(out, ref)


def _render_case(B: int, H: int, W: int, dtype, dev, seed: int = 0):
    """Seeded landmarks inside the canvas plus off-canvas, negative
    (truncated toward zero) and fractional points, 18 shoulder points, and a
    candidate stack in ``dtype``."""
    rng = np.random.default_rng(seed)
    lm = rng.uniform(8, min(H, W) - 8, (B, 73, 2)).astype(np.float32)
    lm[0, :6] = [[-0.7, 5.2], [-3.4, -0.2], [W + 4.5, 10.0], [20.0, H + 0.9],
                 [W - 0.5, H - 0.5], [-1e3, 40.0]]
    lm[-1, 40:44] = [[0.4, -5.9], [W - 1.2, -2.0], [-2.6, H - 3.3], [60.5, 60.5]]
    sh = rng.uniform(-5, max(H, W) + 5, (B, 18, 2)).astype(np.float32)
    cand = torch.tensor(rng.uniform(-1, 1, (H, W, 12)).astype(np.float32))
    return (torch.tensor(lm).to(dev), torch.tensor(sh).to(dev), cand.to(dev, dtype))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H,W", [(16, 512, 512), (8, 512, 512), (4, 96, 128), (3, 44, 72)])
def test_render_input_matches_twin_and_replaced_sequence_bitwise(cuda_device, dtype, B, H, W):
    """K1's render-input entry, one launch: bitwise equal to its plain twin
    and to the sequence it replaced (the table, rasterize_segments, cat,
    cast)."""
    lm, sh, cand = _render_case(B, H, W, dtype, cuda_device, seed=B + H)
    before = rasterize_cuda.LAUNCHES
    got = rasterize_cuda.render_input(lm, sh, cand, (H, W))
    assert rasterize_cuda.LAUNCHES == before + 1
    twin = rasterize.render_input(lm, sh, cand, (H, W))
    edge = rasterize_cuda.rasterize_segments(rasterize.segment_table(lm, sh), H, W)
    replaced = torch.cat([edge[..., None], cand.float().expand(B, H, W, 12)], dim=-1).to(dtype)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (B, H, W, 13) and got.is_contiguous()
    assert torch.equal(got, twin)
    assert torch.equal(got, replaced)
    assert got[..., 0].sum() > 100


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H,W", [(16, 512, 512), (8, 512, 512), (3, 44, 72)])
def test_render_input_edge_only_form_bitwise(cuda_device, dtype, B, H, W):
    """K1's edge-only form (no candidates: split_cand's input), one launch:
    [B, H, W, 1] in the asked dtype, bitwise equal to its plain twin and to
    channel 0 of the 13-channel form."""
    lm, sh, cand = _render_case(B, H, W, dtype, cuda_device, seed=B + W)
    before = rasterize_cuda.LAUNCHES
    got = rasterize_cuda.render_input(lm, sh, None, (H, W), dtype=dtype)
    assert rasterize_cuda.LAUNCHES == before + 1
    twin = rasterize.render_input(lm, sh, None, (H, W), dtype)
    full = rasterize_cuda.render_input(lm, sh, cand, (H, W))
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (B, H, W, 1) and got.is_contiguous()
    assert torch.equal(got, twin)
    assert torch.equal(got[..., 0], full[..., 0])
    assert got.sum() > 100


def test_split_cand_render_on_the_card(cuda_device):
    """render_frames(split_cand=True) on the card, bf16, six batches: one K1
    launch a batch (the edge-only form), no synchronizing host call, frames
    within 10 levels of the unsplit render (chip_smoke.py's bf16 rgb bound;
    the first conv's sum rounds once more in bf16)."""
    cfg = torch_config(small_person_config(image_size=64, precision="bfloat16"))
    person, models = assets.make_synthetic_person(cfg, image_size=64, device=cuda_device)
    lm, sh, _, _, n = animate.compute_motion(cfg, person, models, video.make_test_tone(1.0))
    ref, _ = animate.render_frames(cfg, person, models, lm[:n], sh[:n])
    animate.render_frames(cfg, person, models, lm[:n], sh[:n], split_cand=True)
    torch.cuda.synchronize()
    before = rasterize_cuda.LAUNCHES
    torch.cuda.set_sync_debug_mode("error")
    try:
        frames, _ = animate.render_frames(cfg, person, models, lm[:n], sh[:n], split_cand=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert rasterize_cuda.LAUNCHES - before == -(-n // 8) == 6
    assert np.abs(frames.astype(int) - ref.astype(int)).max() <= 10


def test_render_input_makes_no_host_round_trip(cuda_device):
    """After the first call has put the index pairs on the card, a call
    makes no synchronizing host operation; building the table the old way
    (rasterize.segment_table) does, which shows the check sees them."""
    lm, sh, cand = _render_case(4, 64, 64, torch.bfloat16, cuda_device)
    rasterize_cuda.render_input(lm, sh, cand, (64, 64))
    pairs = rasterize_cuda.segment_pairs(cuda_device, 18)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rasterize_cuda.render_input(lm, sh, cand, (64, 64))
        rasterize_cuda.render_input(lm[:2], sh[:2], cand, (64, 64))
        with pytest.raises(RuntimeError, match="synchroniz"):
            rasterize.segment_table(lm, sh)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert rasterize_cuda.segment_pairs(cuda_device, 18) is pairs


def test_render_frames_batches_make_no_sync(cuda_device):
    """render_frames on the card, six batches: no stream-synchronizing call
    (torch's sync debug mode raises on one; the pinned copy's event and the
    closing device synchronize are not such calls), frames as before."""
    cfg = torch_config(small_person_config(image_size=64, precision="bfloat16"))
    person, models = assets.make_synthetic_person(cfg, image_size=64, device=cuda_device)
    lm, sh, _, _, n = animate.compute_motion(cfg, person, models, video.make_test_tone(1.0))
    ref, _ = animate.render_frames(cfg, person, models, lm[:n], sh[:n])
    torch.cuda.synchronize()
    before = rasterize_cuda.LAUNCHES
    torch.cuda.set_sync_debug_mode("error")
    try:
        frames, _ = animate.render_frames(cfg, person, models, lm[:n], sh[:n])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert rasterize_cuda.LAUNCHES - before == -(-n // 8) == 6
    assert np.array_equal(frames, ref)


def test_render_input_refuses_what_the_kernel_does_not_take(cuda_device):
    lm, sh, cand = _render_case(2, 64, 64, torch.bfloat16, cuda_device)
    before = rasterize_cuda.LAUNCHES
    with pytest.raises(ValueError, match="multiple of 8"):
        rasterize_cuda.render_input(lm, sh, torch.zeros(64, 60, 12, device=cuda_device,
                                                        dtype=torch.bfloat16), (64, 60))
    with pytest.raises(TypeError, match="cand must be"):
        rasterize_cuda.render_input(lm, sh, cand.half(), (64, 64))
    with pytest.raises(ValueError, match="contiguous"):
        rasterize_cuda.render_input(lm.transpose(0, 1).contiguous().transpose(0, 1), sh, cand,
                                    (64, 64))
    with pytest.raises(ValueError, match="exceed"):
        rasterize_cuda.render_input(lm, torch.zeros(2, 200, 2, device=cuda_device), cand,
                                    (64, 64))
    assert rasterize_cuda.LAUNCHES == before


@pytest.mark.parametrize("gates,H,I,T", [(3, 512, 80, 64), (4, 256, 512, 64)])
def test_recurrence_kernel_matches_plain(cuda_device, gates, H, I, T):
    g = torch.Generator().manual_seed(0)
    bound = 1 / np.sqrt(H)
    shapes = [(gates * H, I), (gates * H, H), (gates * H,), (gates * H,)]
    w = [((torch.rand(s, generator=g) * 2 - 1) * bound).to(cuda_device) for s in shapes]
    x = torch.randn(1, T, I, generator=g).to(cuda_device)
    plain = nn_core.gru_layer if gates == 3 else nn_core.lstm_layer
    kernel = recurrent_cuda.gru_layer if gates == 3 else recurrent_cuda.lstm_layer
    before = recurrent_cuda.GRU_LAUNCHES + recurrent_cuda.LSTM_LAUNCHES
    ref, _ = plain(x, *w)
    ys, _ = kernel(x, *w)
    torch.cuda.synchronize()
    assert recurrent_cuda.GRU_LAUNCHES + recurrent_cuda.LSTM_LAUNCHES == before + 1
    assert (ys - ref).abs().max().item() <= 1e-5  # f32, summation order only


def _recurrence_inputs(gates, H, T, device, seed):
    """xp, w_hh, b_hh and nonzero h0 (and c0), made with numpy from a seed."""
    rng = np.random.default_rng(seed)
    bound = 1 / np.sqrt(H)
    arrays = [rng.standard_normal((T, gates * H)),
              rng.uniform(-bound, bound, (gates * H, H)),
              rng.uniform(-bound, bound, gates * H), 0.5 * rng.standard_normal(H)]
    if gates == 4:
        arrays.append(0.5 * rng.standard_normal(H))
    out = [torch.tensor(a, dtype=torch.float32, device=device) for a in arrays]
    return out if gates == 4 else out + [None]


def _plain_recurrence(gates, xp, w_hh, b_hh, h0, c0):
    """nn_core's plain layer on a precomputed xp: W_ih = I and b_ih = 0 make
    the input projection exact (each output is one product by 1)."""
    G = xp.shape[1]
    eye, zero = torch.eye(G, device=xp.device), torch.zeros(G, device=xp.device)
    if gates == 3:
        ys, h = nn_core.gru_layer(xp[None], eye, w_hh, zero, b_hh, h0[None])
        return ys[0], h[0], None
    ys, (h, c) = nn_core.lstm_layer(xp[None], eye, w_hh, zero, b_hh, (h0[None], c0[None]))
    return ys[0], h[0], c[0]


def _assert_recurrence_close(gates, got, ref):
    for a, b in zip(got[:2] if gates == 3 else got, ref):
        assert (a - b).abs().max().item() <= 1e-5  # f32, summation order only


@pytest.mark.parametrize("T", [1, 64, 1200])
@pytest.mark.parametrize("gates,H", [(3, 512), (4, 256), (3, 200), (4, 200), (3, 201), (4, 48)])
def test_cluster_recurrence_matches_plain_loop(cuda_device, gates, H, T):
    """K2 / K3's cluster kernel against the plain loop: the main shapes,
    ragged H (H % C != 0, an odd H), nonzero h0 / c0, ys and h_T / c_T."""
    plan = recurrent_cuda.device_plan(gates, H, cuda_device)
    assert plan[0] == "cluster"
    if H in (200, 201):
        assert H % plan[1] != 0
    args = _recurrence_inputs(gates, H, T, cuda_device, seed=H + T)
    got = recurrent_cuda._recurrence(gates, *args)
    _assert_recurrence_close(gates, got, _plain_recurrence(gates, *args))


def test_lstm_cluster_with_two_units_a_warp(cuda_device):
    """K3 on the other cluster size (8 blocks of 32 units), which
    chip_smoke.py times beside the plan's."""
    plan = recurrent_cuda.cluster_plan(4, 256, 32, recurrent_cuda.device_limits(cuda_device)[1])
    args = _recurrence_inputs(4, 256, 64, cuda_device, seed=5)
    got = recurrent_cuda._recurrence(4, *args, plan=plan)
    _assert_recurrence_close(4, got, _plain_recurrence(4, *args))


@pytest.mark.parametrize("gates,H,plan", [(3, 1024, None), (3, 512, ("grid", 4)),
                                          (4, 256, ("grid", 2))])
def test_grid_recurrence_matches_plain_loop(cuda_device, gates, H, plan):
    """The cooperative-grid kernel: the plan at GRU H=1024, and by an
    explicit plan at the main shapes (the design the cluster replaced)."""
    if plan is None:
        assert recurrent_cuda.device_plan(gates, H, cuda_device)[0] == "grid"
    args = _recurrence_inputs(gates, H, 64, cuda_device, seed=H)
    got = recurrent_cuda._recurrence(gates, *args, plan=plan)
    _assert_recurrence_close(gates, got, _plain_recurrence(gates, *args))


def test_recurrence_counts_one_launch_per_call_by_plan(cuda_device):
    args3 = _recurrence_inputs(3, 512, 8, cuda_device, seed=1)
    args4 = _recurrence_inputs(4, 256, 8, cuda_device, seed=2)
    before = (recurrent_cuda.GRU_LAUNCHES, recurrent_cuda.LSTM_LAUNCHES,
              dict(recurrent_cuda.PLAN_LAUNCHES))
    recurrent_cuda._recurrence(3, *args3)
    assert recurrent_cuda.GRU_LAUNCHES == before[0] + 1
    recurrent_cuda._recurrence(4, *args4)
    recurrent_cuda._recurrence(4, *args4, plan=("grid", 2))
    torch.cuda.synchronize()
    assert recurrent_cuda.LSTM_LAUNCHES == before[1] + 2
    counts = {k: recurrent_cuda.PLAN_LAUNCHES[k] - before[2].get(k, 0)
              for k in ("gru/cluster", "lstm/cluster", "lstm/grid", "gru/grid")}
    assert counts == {"gru/cluster": 1, "lstm/cluster": 1, "lstm/grid": 1, "gru/grid": 0}


def test_recurrence_refuses_a_plan_that_does_not_fit(cuda_device):
    """The kernel checks the plan it is given and the wrapper raises; it
    does not launch and nothing retries another kernel."""
    args = _recurrence_inputs(3, 512, 8, cuda_device, seed=3)
    before = recurrent_cuda.GRU_LAUNCHES
    for bad in (("cluster", 16, 32, 3), ("cluster", 8, 64, 4), ("cluster", 32, 16, 4)):
        with pytest.raises(RuntimeError, match="lsp_gru"):
            recurrent_cuda._recurrence(3, *args[:4], None, plan=bad)
    assert recurrent_cuda.GRU_LAUNCHES == before


def _k4_inputs(B, cin, cout, h, w, dtype, device, seed, ksize=3):
    """A float activation on a 1/8 grid with r = 4: exact rounding ties and
    values past +-127; int8 weights, scale and bias of the activation dtype."""
    g = torch.Generator().manual_seed(seed)
    cl = torch.channels_last
    x = (torch.round(torch.randn(B, cin, h, w, generator=g) * 96) / 8).to(device, dtype)
    wq = torch.randint(-127, 128, (cout, cin, ksize, ksize), generator=g, dtype=torch.int8)
    r = torch.tensor(4.0).to(device, dtype)
    scale = (torch.rand(cout, generator=g) * 1e-4).to(device, dtype)
    bias = torch.randn(cout, generator=g).to(device, dtype)
    return (x.contiguous(memory_format=cl), wq.to(device).contiguous(memory_format=cl), r,
            scale, bias)


@pytest.mark.parametrize("cin,cout,size,stride", [(64, 64, 40, 1), (64, 128, 33, 2),
                                                  (1024, 512, 3, 1), (48, 24, 7, 2)])
def test_q8conv_kernel_matches_plain_bitwise(cuda_device, cin, cout, size, stride):
    """K4 against its twins: the int32 sums of int8 input, and the fused
    quantize + conv + rescale of bf16 / f32 input, bit for bit; ragged
    sizes, a partial channel tile, split-K (1024 -> 512 at 3 x 6)."""
    g = torch.Generator().manual_seed(cin + cout)
    cl = torch.channels_last
    x = torch.randint(-127, 128, (3, cin, size, size + 3), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (cout, cin, 3, 3), generator=g, dtype=torch.int8)
    x = x.to(cuda_device).contiguous(memory_format=cl)
    w = w.to(cuda_device).contiguous(memory_format=cl)
    before = q8conv_cuda.LAUNCHES
    ref = q8conv_cuda.conv_s8_plain(x, w, stride)
    assert torch.equal(q8conv_cuda.conv_s8(x, w, stride), ref)
    for dt in (torch.float32, torch.bfloat16):
        xf, _, r, scale, bias = _k4_inputs(3, cin, cout, size, size + 3, dt, cuda_device, cin)
        out = q8conv_cuda.conv_q8(xf, r, w, stride, 1, scale, bias)
        assert torch.equal(out, q8conv_cuda.conv_q8_plain(xf, r, w, stride, 1, scale, bias))
    torch.cuda.synchronize()
    assert q8conv_cuda.LAUNCHES == before + 3
    with pytest.raises(ValueError, match="channels_last"):
        q8conv_cuda.conv_s8(x.contiguous(), w, stride)


@pytest.mark.parametrize("B,cin,cout,h,w", [(3, 48, 24, 16, 32), (2, 64, 64, 24, 48),
                                             (2, 1024, 512, 16, 16)])
def test_q8conv_halo_kernel_matches_plain_bitwise(cuda_device, B, cin, cout, h, w):
    """K4's halo kernel (stride 1, H % 8 == 0, W % 16 == 0) against its
    twins in all three modes: a partial channel tile and Cout < 64, several
    patches per image, split-K over channel slices."""
    assert q8conv_cuda.uses_halo(h, w, 1, 1)
    g = torch.Generator().manual_seed(cin)
    x_q = torch.randint(-127, 128, (B, cin, h, w), generator=g, dtype=torch.int8)
    x_q = x_q.to(cuda_device).contiguous(memory_format=torch.channels_last)
    for dt in (torch.float32, torch.bfloat16):
        x, wq, r, scale, bias = _k4_inputs(B, cin, cout, h, w, dt, cuda_device, cin + cout)
        assert torch.equal(q8conv_cuda.conv_q8(x, r, wq, 1, 1, scale, bias),
                           q8conv_cuda.conv_q8_plain(x, r, wq, 1, 1, scale, bias))
    assert torch.equal(q8conv_cuda.conv_s8(x_q, wq, 1), q8conv_cuda.conv_s8_plain(x_q, wq, 1))


@pytest.mark.parametrize("size,cin,cout,stride",
                         feature2face.int8_conv_shapes(Feature2FaceConfig()))
def test_q8conv_kernel_at_the_resunet_shapes(cuda_device, size, cin, cout, stride):
    """K4 at each of the 44 int8 conv shapes of the 'normal' 512^2 ResUNet,
    B=2: the int32 mode and the fused bf16 mode bit for bit."""
    x, w, r, scale, bias = _k4_inputs(2, cin, cout, size, size, torch.bfloat16, cuda_device,
                                      size + cin + cout)
    x_q = q8conv_cuda.quantize_plain(x, r)
    assert torch.equal(q8conv_cuda.conv_s8(x_q, w, stride),
                       q8conv_cuda.conv_s8_plain(x_q, w, stride))
    assert torch.equal(q8conv_cuda.conv_q8(x, r, w, stride, 1, scale, bias),
                       q8conv_cuda.conv_q8_plain(x, r, w, stride, 1, scale, bias))


# The discriminator's interior convs at 512^2 (input size, Cin, Cout, stride),
# both scales: 4x4, padding 2
D_SHAPES = [(257, 64, 128, 2), (129, 128, 256, 2), (65, 256, 512, 1),
            (129, 64, 128, 2), (65, 128, 256, 2), (33, 256, 512, 1)]


@pytest.mark.parametrize("size,cin,cout,stride", D_SHAPES)
def test_q8conv_kernel_at_the_discriminator_shapes(cuda_device, size, cin, cout, stride):
    """K4's 4x4 taps (quantization-aware training's discriminator, f32) at
    each interior conv shape, B=2: the int32 mode and the fused f32 and
    bf16 modes against the twins, bit for bit."""
    for dt in (torch.float32, torch.bfloat16):
        x, w, r, scale, bias = _k4_inputs(2, cin, cout, size, size, dt, cuda_device,
                                          size + cin, ksize=4)
        assert torch.equal(q8conv_cuda.conv_q8(x, r, w, stride, 2, scale, bias),
                           q8conv_cuda.conv_q8_plain(x, r, w, stride, 2, scale, bias))
    x_q = q8conv_cuda.quantize_plain(x, r)
    out = q8conv_cuda.conv_s8(x_q, w, stride, 2)
    assert out.shape[2] == (size + 4 - 4) // stride + 1
    assert torch.equal(out, q8conv_cuda.conv_s8_plain(x_q, w, stride, 2))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fq8_conv_on_the_card_equals_the_deployed_layer(cuda_device, dtype):
    """A QAT "fq8" conv launches K4 once a forward, its output the deployed
    QConv2d's bit for bit (bf16: the deployed layer cast, the QAT weights the
    f32 masters); its straight-through backward runs in f32 under bf16
    autocast, as the trainer calls it."""
    g = torch.Generator().manual_seed(3)
    conv = torch.nn.Conv2d(64, 64, 3, padding=1, bias=False)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=g) * 0.05)
    conv = conv.to(cuda_device)
    layer = nn_core.fake_quant_conv(conv, int8_forward=True)
    deployed = nn_core.QConv2d.from_conv(conv).to(dtype)
    deployed.w_q = deployed.w_q.contiguous(memory_format=torch.channels_last)
    x = torch.randn(4, 64, 64, 64, generator=g).to(cuda_device, dtype)
    x = x.contiguous(memory_format=torch.channels_last).requires_grad_()
    before = q8conv_cuda.LAUNCHES
    with torch.autocast("cuda", dtype=torch.bfloat16, enabled=dtype == torch.bfloat16):
        y = nn_core.conv2d(x, layer, 1, 1)
    assert q8conv_cuda.LAUNCHES == before + 1 and y.dtype == dtype
    with torch.no_grad():
        assert torch.equal(y, nn_core.conv2d(x, deployed, 1, 1))
    gx, gw = torch.autograd.grad(y.float().square().sum(), (x, conv.weight))
    assert gx.dtype == dtype and gw.dtype == torch.float32
    assert torch.isfinite(gw).all() and gw.abs().max() > 0


def test_qat_gan_steps_on_the_card_launch_k4_for_every_tagged_conv(cuda_device, tmp_path):
    """A --qat_int8 --qat_d GAN run (64^2, bf16 G, f32 D) launches K4 for
    each tagged conv of each forward: two G forwards and four D forwards a
    step, one G forward a validation batch and one for the epoch panel;
    finite losses."""
    from livespeechportraits_torch.train import __main__ as cli
    from livespeechportraits_torch.train import trainer

    cfg = Feature2FaceConfig(ngf=16, n_downsample=6, load_size=64, ndf=16)
    n_g = sum(isinstance(m, nn_core.QATConv2d) for m in
              feature2face.qat_generator(feature2face.Feature2FaceG(cfg)).modules())
    n_d = cfg.num_D * cfg.n_layers_D
    small = cli.synthetic_face_data(70, 64)
    loop = trainer.TrainLoopConfig(n_epochs=1, n_epochs_decay=0, batch_size=4, print_freq=1,
                                   checkpoints_dir=str(tmp_path), name="f2f", qat_int8=True,
                                   qat_d=True)
    before = q8conv_cuda.LAUNCHES
    res = trainer.train_feature2face(cfg, loop, small, small)
    torch.cuda.synchronize()
    steps, val = len(res.step_ms), -(-len(small) // 4)
    assert q8conv_cuda.LAUNCHES - before == steps * (2 * n_g + 4 * n_d) + (val + 1) * n_g
    assert np.isfinite(res.best_val) and all(np.isfinite(res.step_ms))


def _recomputed_tagged_convs(g, remat) -> int:
    """The QAT-tagged convs a rematerialised G forward runs again: all of
    them for remat=True, those of the outer K stages' halves for K."""
    if remat is True:
        return sum(isinstance(m, nn_core.QATConv2d) for m in g.modules())
    n = 0
    for stage in list(feature2face._stages(g))[:int(remat)]:
        for m in stage.model:
            if not isinstance(m, feature2face.ResUnetBlock):
                n += sum(isinstance(c, nn_core.QATConv2d) for c in m.modules())
    return n


@pytest.mark.parametrize("remat,remat_d", [(False, False), (True, False), (2, True)],
                         ids=["plain", "remat", "remat2_d"])
def test_fused_qat_step_on_the_card_runs_k4_in_the_recompute(cuda_device, remat, remat_d):
    """One fused --qat_int8 --qat_d step (64^2, B = 4, bf16 G, f32 D): K4
    launches once a tagged conv of the one G forward and the two D forwards,
    and again for each tagged conv a checkpointed region recomputes (remat_d:
    the real tower once, the fake tower in each of the two gradients); the
    straight-through gradients and the running stats equal the plain step's
    within 1e-2 of each tensor's largest value (bf16 G; cuDNN may pick
    other algorithms in the recompute); the losses finite."""
    from livespeechportraits_torch.train import __main__ as cli
    from livespeechportraits_torch.train import steps, trainer

    cfg = Feature2FaceConfig(ngf=16, n_downsample=6, load_size=64, ndf=16)
    gen = torch.Generator().manual_seed(0)
    g = feature2face.qat_generator(trainer._init(feature2face.Feature2FaceG(cfg), gen=gen),
                                   int8_forward=True).to(cuda_device)
    d = trainer._init(feature2face.Feature2FaceD(cfg), gen=gen).to(cuda_device)
    n_g = sum(isinstance(m, nn_core.QATConv2d) for m in g.modules())
    n_d = cfg.num_D * cfg.n_layers_D
    batch = trainer._Mover(cuda_device)(next(cli.synthetic_face_data(64, 64).batches(
        4, np.random.default_rng(0), shuffle=False)))

    def grads(r, rd):
        gg, dd = copy.deepcopy(g), copy.deepcopy(d)
        before = q8conv_cuda.LAUNCHES
        loss_d, loss_g, m = steps.f2f_fused_losses(cfg, gg, feature2face.qat_discriminator(dd),
                                                   batch, None, torch.bfloat16, r, rd)
        out = (list(torch.autograd.grad(loss_d, list(dd.parameters()), retain_graph=True))
               + list(torch.autograd.grad(loss_g, list(gg.parameters()), allow_unused=True)))
        torch.cuda.synchronize()
        stats = [v for mod in (gg, dd) for k, v in mod.state_dict().items()
                 if k.endswith(("running_mean", "running_var"))]
        assert all(torch.isfinite(v).all() for v in m.values())
        return out, stats, q8conv_cuda.LAUNCHES - before

    ref, ref_stats, n_ref = grads(False, False)
    got, stats, n = grads(remat, remat_d)
    assert n_ref == n_g + 2 * n_d
    extra = (_recomputed_tagged_convs(g, remat) if remat else 0) + (3 * n_d if remat_d else 0)
    assert n == n_ref + extra, (n, n_ref, extra)
    for a, b in zip(got + stats, ref + ref_stats):
        if b is None:
            assert a is None
            continue
        assert float((a - b).abs().max()) <= 1e-2 * float(b.abs().max()) + 1e-12


def test_conv_q8_refuses_a_host_scale(cuda_device):
    x, w, r, scale, bias = _k4_inputs(1, 64, 64, 8, 8, torch.bfloat16, cuda_device, 0)
    with pytest.raises(ValueError, match="r must be"):
        q8conv_cuda.conv_q8(x, r.cpu(), w, 1, 1, scale, bias)


def test_small_slice_gpu_matches_cpu(cuda_device):
    """The whole slice at test widths, f32 renderer and TF32 off: landmarks
    within 1e-3 px and frames within one uint8 level of the CPU run."""
    cfg = torch_config(small_person_config(image_size=64))
    person, models_cpu = assets.make_synthetic_person(cfg, image_size=64, device="cpu")
    _, models_gpu = assets.make_synthetic_person(cfg, image_size=64, device=cuda_device)
    audio = video.make_test_tone(1.0)
    ref = animate.animate(cfg, person, models_cpu, audio, seed=3)
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        out = animate.animate(cfg, person, models_gpu, audio, seed=3)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    assert out.frames.shape == ref.frames.shape == (45, 64, 64, 3)
    assert np.abs(out.landmarks - ref.landmarks).max() <= 1e-3
    assert np.abs(out.frames.astype(int) - ref.frames.astype(int)).max() <= 1


# ---------------------------------------------------------------------------
# The live path and the frame coders
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T", [1, 31, 32, 63, 64])
@pytest.mark.parametrize("gates,H,I", [(3, 512, 80), (4, 256, 512)])
def test_recurrence_wrappers_at_streaming_chunks(cuda_device, gates, H, I, T):
    """K2 / K3 through the wrappers a stream calls, at its chunk lengths,
    from a carried nonzero state: against the plain layer, and two chunks
    carried one into the next against one run over both."""
    rng = np.random.default_rng(T + gates)
    bound = 1 / np.sqrt(H)
    w = [torch.tensor(rng.uniform(-bound, bound, s), dtype=torch.float32, device=cuda_device)
         for s in ((gates * H, I), (gates * H, H), (gates * H,), (gates * H,))]
    x = torch.tensor(rng.standard_normal((1, 2 * T, I)), dtype=torch.float32,
                     device=cuda_device)
    h0 = torch.tensor(0.5 * rng.standard_normal(H), dtype=torch.float32, device=cuda_device)
    c0 = torch.tensor(0.5 * rng.standard_normal(H), dtype=torch.float32, device=cuda_device)
    before = recurrent_cuda.GRU_LAUNCHES + recurrent_cuda.LSTM_LAUNCHES
    if gates == 3:
        ref, ref_h = nn_core.gru_layer(x, *w, h0)
        y1, h1 = recurrent_cuda.gru_layer(x[:, :T], *w, h0=h0)
        y2, h2 = recurrent_cuda.gru_layer(x[:, T:], *w, h0=h1.reshape(H))
        states = [(h2, ref_h)]
    else:
        ref, (ref_h, ref_c) = nn_core.lstm_layer(x, *w, (h0[None], c0[None]))
        y1, (h1, c1) = recurrent_cuda.lstm_layer(x[:, :T], *w, state=(h0, c0))
        y2, (h2, c2) = recurrent_cuda.lstm_layer(x[:, T:], *w, state=(h1, c1))
        states = [(h2, ref_h), (c2, ref_c)]
    torch.cuda.synchronize()
    assert recurrent_cuda.GRU_LAUNCHES + recurrent_cuda.LSTM_LAUNCHES == before + 2
    assert (torch.cat([y1, y2], 1) - ref).abs().max().item() <= 1e-5  # f32, order only
    for got, want in states:
        assert (got.reshape(H) - want.reshape(H)).abs().max().item() <= 1e-5


def test_coders_on_the_card_match_their_cpu_run(cuda_device):
    """The jpeg, jpeg4 and pack4e encoders on the card against the same
    frames on the CPU (TF32 off): at least 99.99 % of the bytes equal
    (a DCT coefficient at a rounding edge may round the other way) and the
    decoded frames within one level."""
    from livespeechportraits_torch.pipeline import compress

    rng = np.random.default_rng(0)
    img = np.tanh(rng.standard_normal((4, 128, 128, 3)).cumsum(axis=2) / 8).astype(np.float32)
    x = torch.tensor(img)
    assert not torch.backends.cuda.matmul.allow_tf32
    for enc, dec in ((compress.encode_rgb_frames, compress.decode_to_rgb),
                     (compress.encode_rgb_frames_p4, compress.decode_to_rgb_p4)):
        cpu, gpu = enc(x).numpy(), enc(x.to(cuda_device)).cpu().numpy()
        assert (cpu == gpu).mean() >= 0.9999
        d = np.abs(dec(cpu, 128, 128).astype(int) - dec(gpu, 128, 128).astype(int))
        assert d.max() <= 1
    flat, total = compress.encode_rgb_frames_p4e(x)
    gflat, gtotal = compress.encode_rgb_frames_p4e(x.to(cuda_device))
    assert gflat.shape == flat.shape and gflat.dtype == torch.uint8
    n, gn = int(total), int(gtotal)
    same = (flat.numpy() == gflat.cpu().numpy()).mean()
    assert same >= 0.9999 or n != gn  # one flipped coefficient shifts the bytes after it
    a = compress.decode_to_rgb_p4e(flat.numpy()[:n], 4, 128, 128)
    b = compress.decode_to_rgb_p4e(gflat.cpu().numpy()[:gn], 4, 128, 128)
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="allow_tf32"):
            compress.encode_rgb_frames_p4e(x.to(cuda_device))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def test_pack4e_prefix_fetch_on_the_card(cuda_device, monkeypatch):
    """render_frames on the card with pack4e: the frames of jpeg4; with the
    learned size forced to nothing, every batch after the first two is
    fetched again whole, with the same frames."""
    cfg = torch_config(small_person_config(image_size=64, precision="bfloat16"))
    person, models = assets.make_synthetic_person(cfg, image_size=64, device=cuda_device)
    lm, sh, _, _, n = animate.compute_motion(cfg, person, models, video.make_test_tone(1.0))
    ref, _ = animate.render_frames(cfg, person, models, lm[:n], sh[:n], transfer="jpeg4")
    monkeypatch.setattr(animate, "_P4E_NEED", {})
    monkeypatch.setattr(animate, "P4E_MARGIN", 1e-9)
    link = {}
    frames, _ = animate.render_frames(cfg, person, models, lm[:n], sh[:n], transfer="pack4e",
                                      link=link)
    np.testing.assert_array_equal(frames, ref)
    assert link["p4e_refetches"] == -(-n // 8) - 2


def test_small_stream_on_the_card(cuda_device):
    """The live path on the card at test widths: every kernel of the path
    launches during the stream, and the frames match the card's offline
    pipeline within the CPU test's bound."""
    cfg = torch_config(small_person_config(image_size=64))
    person, models = assets.make_synthetic_person(cfg, image_size=64, device=cuda_device)
    from livespeechportraits_torch.pipeline import streaming

    audio = video.make_test_tone(1.2)
    offline = animate.animate(cfg, person, models, audio, seed=5, render_batch=4)
    counts = (rasterize_cuda.LAUNCHES, recurrent_cuda.GRU_LAUNCHES,
              recurrent_cuda.LSTM_LAUNCHES)
    st = streaming.StreamingAnimator(cfg, person, models, seed=5, chunk=16, render_batch=4,
                                     transfer="pack4e", pipeline_depth=1)
    outs = [st.push_audio(audio[lo:lo + 1600]) for lo in range(0, len(audio), 1600)]
    outs.append(st.flush())
    frames = np.concatenate(outs)
    after = (rasterize_cuda.LAUNCHES, recurrent_cuda.GRU_LAUNCHES,
             recurrent_cuda.LSTM_LAUNCHES)
    assert all(a > b for a, b in zip(after, counts))
    ref = animate.animate(cfg, person, models, audio, seed=5, render_batch=4,
                          transfer="jpeg4").frames
    assert frames.shape == offline.frames.shape
    d = np.abs(frames.astype(int) - ref.astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 0.01


def test_f32_plane_at_the_onboarding_batch(cuda_device, tmp_path):
    """K1's f32-plane entry on a 32-frame batch of a synthetic subject's
    landmarks at 512^2, bitwise against its twin; write_raw_clip on the card
    launches it once a batch of 32, and its landmarks and stored frames
    equal the CPU's (landmarks within 1e-4 px)."""
    from livespeechportraits_torch.pipeline import synth_subject
    from livespeechportraits_torch.utils import h5vlen

    n = 40
    pts = synth_subject.subject_pts3d(n)
    rot, trans = synth_subject.subject_headpose(n)
    lm = torch.as_tensor(synth_subject.project_clip(pts, rot, trans, 512, cuda_device),
                         device=cuda_device)
    sh = torch.as_tensor(synth_subject.default_shoulders(512), device=cuda_device)
    table = rasterize.segment_table(lm[:32], sh[None].expand(32, -1, -1))
    out = rasterize_cuda.rasterize_segments(table, 512, 512)
    assert torch.equal(out, rasterize.rasterize_segments(table, 512, 512))
    before = rasterize_cuda.LAUNCHES
    gt = synth_subject.write_raw_clip(str(tmp_path / "card"), "c", n, image_size=64,
                                      device=cuda_device)
    assert rasterize_cuda.LAUNCHES == before + 2
    ref = synth_subject.write_raw_clip(str(tmp_path / "cpu"), "c", n, image_size=64,
                                       device="cpu")
    np.testing.assert_allclose(gt["landmarks2d"], ref["landmarks2d"], atol=1e-4)
    assert h5vlen.read(str(tmp_path / "card" / "c" / "c.h5"), "c") == \
        h5vlen.read(str(tmp_path / "cpu" / "c" / "c.h5"), "c")


def test_k2_over_a_whole_clip(cuda_device):
    """The APC stack over a whole clip's mel (T = 1000 rows) on K2, within
    1e-5 of the plain layer on the card, layer by layer; and
    compute_apc_features on the card within 1e-4 of the CPU's."""
    from livespeechportraits_torch.config import APCConfig
    from livespeechportraits_torch.models.apc import APCEncoder
    from livespeechportraits_torch.ops import mel
    from livespeechportraits_torch.pipeline import synth_subject
    from livespeechportraits_torch.train import data_io

    enc = APCEncoder(APCConfig()).eval().requires_grad_(False)
    enc.reset_parameters(torch.Generator().manual_seed(0))
    audio = synth_subject.make_audio(synth_subject.envelope(500))
    cpu = data_io.compute_apc_features(audio, enc)
    enc.to(cuda_device)
    x = mel.compute_mel_sequence(audio, device=cuda_device)[None]
    assert x.shape[1] == 998  # 133333 samples: 499 frames
    before = recurrent_cuda.GRU_LAUNCHES
    with torch.no_grad():
        for rnn in enc.rnns:
            y, h = recurrent_cuda.gru_layer(x, *rnn.layer(0))
            y_ref, h_ref = nn_core.gru_layer(x, *rnn.layer(0))
            assert (y - y_ref).abs().max().item() <= 1e-5
            x = y_ref
        card = data_io.compute_apc_features(audio, enc)
    assert recurrent_cuda.GRU_LAUNCHES == before + 6
    assert np.abs(card - cpu).max() <= 1e-4


def test_gmm_head_on_the_card_matches_cpu(cuda_device):
    """The Audio2Feature GMM head (3 components, full width) on the card: its
    raw block within 1e-5 of the CPU's (K3 against the plain LSTM), and the
    decoded means pick the same components."""
    from livespeechportraits_torch.config import Audio2FeatureConfig
    from livespeechportraits_torch.models import audio2feature

    cfg = Audio2FeatureConfig(loss="GMM", gmm_ncenter=3)
    model = audio2feature.Audio2Feature(cfg).eval().requires_grad_(False)
    model.reset_parameters(torch.Generator().manual_seed(0))
    feats = torch.tensor(np.random.default_rng(0).standard_normal((400, 512)),
                         dtype=torch.float32)
    with torch.no_grad():
        ref = audio2feature.generate_sequence(model, feats, seed=3)
        ref_block = audio2feature.apply_audio2feature(model, feats[None])
        model.to(cuda_device)
        before = recurrent_cuda.LSTM_LAUNCHES
        block = audio2feature.apply_audio2feature(model, feats[None].to(cuda_device))
        out = audio2feature.generate_sequence(model, feats.to(cuda_device), seed=3)
    assert recurrent_cuda.LSTM_LAUNCHES == before + 6
    assert block.shape == (1, 200, 151 * 3)
    assert (block.cpu() - ref_block).abs().max().item() <= 1e-5
    assert (out.cpu() - ref).abs().max().item() <= 1e-5


def test_small_unet_renders_from_one_k1_launch_a_batch(cuda_device):
    """A subject with the 'small' U-Net renders on the card from one K1
    render_input launch a batch, and its f32 frames agree with the CPU's."""
    cfg = torch_config(small_person_config(image_size=64))
    cfg = replace(cfg, feature2face=Feature2FaceConfig(size="small", ngf=8, n_downsample=6,
                                                       load_size=64, precision="float32"))
    person, models = assets.make_synthetic_person(cfg, image_size=64, device="cpu")
    lm, sh, *_ = animate.compute_motion(cfg, person, models, video.make_test_tone(0.6))
    ref, _ = animate.render_frames(cfg, person, models, lm, sh, render_batch=4)
    models.to(cuda_device)
    before = rasterize_cuda.LAUNCHES
    flag = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        out, _ = animate.render_frames(cfg, person, models, lm.to(cuda_device),
                                       sh.to(cuda_device), render_batch=4)
    finally:
        torch.backends.cudnn.allow_tf32 = flag
    assert rasterize_cuda.LAUNCHES == before + -(-lm.shape[0] // 4)
    d = np.abs(out.astype(int) - ref.astype(int))
    assert d.max() <= 1


def test_k1_at_the_training_batch(cuda_device, tmp_path):
    """The Feature2Face trainer's input stage on the card: one synthetic
    512^2 batch of 8 (FaceFrameSampler(device_rasterize=True)) gets its edge
    maps from one K1 launch, bitwise equal to the plain rasteriser on the
    same segment table; then a small GAN run (64^2, bf16) on the card
    launches K1 once a step and once a validation batch, with finite
    losses."""
    from livespeechportraits_torch.config import Feature2FaceConfig
    from livespeechportraits_torch.train import __main__ as cli
    from livespeechportraits_torch.train import trainer

    sampler = cli.synthetic_face_data(24, 512)
    host = next(sampler.batches(8, np.random.default_rng(0)))
    before = rasterize_cuda.LAUNCHES
    batch = trainer._Mover(cuda_device)(host)
    torch.cuda.synchronize()
    assert rasterize_cuda.LAUNCHES == before + 1
    assert batch["feature_map"].shape == (8, 512, 512, 1) and batch["feature_map"].is_cuda
    table = rasterize.segment_table(torch.as_tensor(host["landmarks"], device=cuda_device),
                                    torch.as_tensor(host["shoulders"], device=cuda_device))
    assert table.shape == (8, 88, 4)
    assert torch.equal(batch["feature_map"][..., 0], rasterize.rasterize_segments(table, 512, 512))

    small = cli.synthetic_face_data(70, 64)
    cfg = Feature2FaceConfig(ngf=8, n_downsample=6, load_size=64, ndf=8)
    loop = trainer.TrainLoopConfig(n_epochs=1, n_epochs_decay=0, batch_size=4, print_freq=1,
                                   checkpoints_dir=str(tmp_path), name="f2f")
    before = rasterize_cuda.LAUNCHES
    res = trainer.train_feature2face(cfg, loop, small, small)
    torch.cuda.synchronize()
    # one a step, one a validation batch, one for the epoch panel's batch
    assert rasterize_cuda.LAUNCHES - before == len(res.step_ms) + -(-len(small) // 4) + 1
    assert np.isfinite(res.best_val) and all(np.isfinite(res.step_ms))


# ---------------------------------------------------------------------------
# Data parallelism on the card
# ---------------------------------------------------------------------------


def test_render_split_over_two_shares_of_one_card(cuda_device):
    """animate(render_devices=[cuda:0, cuda:0]) on the int8 renderer at test
    widths (ngf 16): each batch of 8 as two shares of 4, K1 once a share and
    K4 twice as often as on one device; frames within one level of one
    device's (JAX tests/test_parallel.py:118-139)."""
    cfg = torch_config(small_person_config(image_size=64, precision="bfloat16"))
    cfg = replace(cfg, feature2face=replace(cfg.feature2face, ngf=16))
    person, models = assets.make_synthetic_person(cfg, image_size=64, device=cuda_device)
    audio = video.make_test_tone(1.0)
    calib = animate.build_render_inputs(cfg, person, models, audio, max_frames=8)
    models = assets.quantize_person_models(models, calibrate_inputs=calib,
                                           calibrate_dtype=torch.bfloat16)
    k1, k4 = rasterize_cuda.LAUNCHES, q8conv_cuda.LAUNCHES
    ref = animate.animate(cfg, person, models, audio, render_batch=8)
    torch.cuda.synchronize()
    one = (rasterize_cuda.LAUNCHES - k1, q8conv_cuda.LAUNCHES - k4)
    k1, k4 = rasterize_cuda.LAUNCHES, q8conv_cuda.LAUNCHES
    out = animate.animate(cfg, person, models, audio, render_batch=8,
                          render_devices=[cuda_device, cuda_device])
    torch.cuda.synchronize()
    assert one[0] == -(-out.nframe // 8) and one[1] > 0
    assert (rasterize_cuda.LAUNCHES - k1, q8conv_cuda.LAUNCHES - k4) == (2 * one[0], 2 * one[1])
    assert out.frames.shape == ref.frames.shape
    assert np.abs(out.frames.astype(int) - ref.frames.astype(int)).max() <= 1


def test_one_rank_nccl_data_parallel_step_equals_no_group(cuda_device, monkeypatch):
    """--data_parallel on one card is a one-rank NCCL group: the fused GAN
    step's gradients (all-reduced over the one rank) and running stats equal
    the step without a group (64^2, B = 4, f32 G and D, TF32 off, cuDNN's
    deterministic algorithms: its others sum a weight gradient in another
    order from call to call, 3e-7 on a zero-true-gradient bias)."""
    from livespeechportraits_torch.parallel import multihost
    from livespeechportraits_torch.train import __main__ as cli
    from livespeechportraits_torch.train import state, steps, trainer

    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    cfg = Feature2FaceConfig(ngf=16, n_downsample=6, load_size=64, ndf=16, precision="float32")
    gen = torch.Generator().manual_seed(0)
    g = trainer._init(feature2face.Feature2FaceG(cfg), gen=gen).to(cuda_device)
    d = trainer._init(feature2face.Feature2FaceD(cfg), gen=gen).to(cuda_device)
    batch = trainer._Mover(cuda_device)(next(cli.synthetic_face_data(64, 64).batches(
        4, np.random.default_rng(0), shuffle=False)))

    def grads():
        gg, dd = copy.deepcopy(g), copy.deepcopy(d)
        loss_d, loss_g, _ = steps.f2f_fused_losses(cfg, gg, dd, batch)
        out = (state.gradients(loss_d, list(dd.parameters()), retain_graph=True)
               + state.gradients(loss_g, list(gg.parameters())))
        stats = [v for mod in (gg, dd) for k, v in mod.state_dict().items() if "running" in k]
        return out, stats

    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        ref, ref_stats = grads()
        assert multihost.initialize(cuda_device) == cuda_device
        try:
            assert torch.distributed.get_backend() == "nccl" and multihost.world_size() == 1
            got, stats = grads()
        finally:
            multihost.shutdown()
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic) = flags
    for a, b in zip(got + stats, ref + ref_stats):
        assert torch.equal(a, b)
