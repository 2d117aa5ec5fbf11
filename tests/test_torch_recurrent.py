"""PyTorch port, ops/recurrent_cuda.py (kernels K2 / K3) and models/apc.py.

On the CPU the wrappers take their plain twins; those are held against the
JAX Pallas kernels run in interpret mode, as JAX's own tests run them, at
atol 1e-5 (f32 summation-order noise through the recurrence).  The kernels
themselves are held against the twins on the card in test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livespeechportraits_tpu.config import APCConfig
from livespeechportraits_tpu.models import apc as japc
from livespeechportraits_tpu.models import nn_core as jcore
from livespeechportraits_tpu.ops import recurrent_pallas as rp
from livespeechportraits_torch.models import apc
from livespeechportraits_torch.ops import recurrent_cuda
from livespeechportraits_torch.utils.convert import params_from_jax
from torch_parity import to_np, torch_config


def _layer(p):
    return [torch.tensor(np.asarray(p[k]).T.copy()) if k.startswith("w") else
            torch.tensor(np.asarray(p[k])) for k in ("w_ih", "w_hh", "b_ih", "b_hh")]


def test_gru_wrapper_matches_pallas_interpret():
    p = jcore.gru_layer_init(jax.random.PRNGKey(0), 40, 48)
    x = np.random.default_rng(1).standard_normal((1, 37, 40)).astype(np.float32)
    h0 = np.random.default_rng(2).standard_normal((1, 48)).astype(np.float32)
    ref, h_ref = rp.gru_layer_pallas(p, jnp.asarray(x), jnp.asarray(h0), interpret=True)
    ys, hT = recurrent_cuda.gru_layer(torch.tensor(x), *_layer(p), torch.tensor(h0))
    assert hT.shape == (1, 48)
    np.testing.assert_allclose(ys.numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(hT.numpy(), np.asarray(h_ref), atol=1e-5)


def test_lstm_wrapper_matches_pallas_interpret():
    p = jcore.lstm_layer_init(jax.random.PRNGKey(3), 24, 32)
    x = np.random.default_rng(4).standard_normal((1, 29, 24)).astype(np.float32)
    ref, (h_ref, c_ref) = rp.lstm_layer_pallas(p, jnp.asarray(x), interpret=True)
    ys, (h, c) = recurrent_cuda.lstm_layer(torch.tensor(x), *_layer(p))
    assert h.shape == c.shape == (1, 32)
    np.testing.assert_allclose(ys.numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), atol=1e-5)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), atol=1e-5)


@pytest.mark.parametrize("residual", [False, True])
def test_apc_encode_fast_matches_jax(residual):
    cfg = APCConfig(mel_dim=16, hidden_size=32, num_layers=3)
    params = japc.init_apc(jax.random.PRNGKey(5), cfg)
    mels = np.random.default_rng(6).standard_normal((25, 16)).astype(np.float32)
    ref = japc.encode(params, jnp.asarray(mels)[None], residual=residual)[0]
    model = apc.APCEncoder(torch_config(cfg))
    model.load_state_dict(params_from_jax(to_np(params)), strict=True)
    with torch.no_grad():
        ours = apc.encode_fast(model, torch.tensor(mels), residual=residual)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)
    if not residual:
        pallas = rp.apc_encode_pallas(params, jnp.asarray(mels), interpret=True)
        np.testing.assert_allclose(ours.numpy(), np.asarray(pallas), atol=1e-5)


def test_wrappers_reject_other_devices():
    x = torch.zeros(1, 3, 4, device="meta")
    w = [torch.zeros(12, 4), torch.zeros(12, 4), torch.zeros(12), torch.zeros(12)]
    with pytest.raises(ValueError, match="unsupported device"):
        recurrent_cuda.gru_layer(x, *w)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        recurrent_cuda._recurrence(3, torch.zeros(3, 12), w[1], w[3], torch.zeros(4), None)


# plan(): which kernel runs a shape, from the shape alone (H100: 132 SMs,
# 227 KB of opt-in shared memory a block)
H100 = (132, 232448)


@pytest.mark.parametrize("gates,H,want", [(3, 512, ("cluster", 16, 32, 4)),
                                          (4, 256, ("cluster", 16, 16, 4))])
def test_plan_takes_the_cluster_at_the_main_shapes(gates, H, want):
    assert recurrent_cuda.plan(gates, H, *H100) == want
    # GRU H=512: 6 rows a warp, 4 in registers, 2 in shared memory
    assert recurrent_cuda.cluster_smem_bytes(gates, H, want[2], want[3]) == (
        16 + 4 * (1024 + 2 * 16 * 512 + 10 * 3 * 32) if gates == 3 else
        16 + 4 * (512 + 10 * 4 * 16))


def test_plan_takes_the_grid_where_no_cluster_holds_w_hh():
    assert recurrent_cuda.plan(3, 1024, *H100) == ("grid", 8)
    assert recurrent_cuda.grid_smem_bytes(3, 1024, 8) <= H100[1]
    assert recurrent_cuda.cluster_plan(3, 1024, 32, H100[1]) is None
    with pytest.raises(ValueError, match="no recurrence kernel"):
        recurrent_cuda.plan(3, 1024, 4, H100[1])  # 256 units a block: 3 MB


@pytest.mark.parametrize("gates,H", [(3, 48), (4, 48), (3, 200), (4, 200), (3, 201), (4, 1),
                                     (3, 384), (4, 400), (4, 512)])
def test_plan_gives_a_valid_cluster_at_small_and_ragged_sizes(gates, H):
    kind, blocks, units, reg_rows = recurrent_cuda.plan(gates, H, *H100)
    assert kind == "cluster" and 1 <= blocks <= recurrent_cuda.MAX_CLUSTER
    assert (blocks - 1) * units < H <= blocks * units  # every unit owned, no empty block
    if H in (200, 201, 400):
        assert H % blocks != 0  # ragged: the last block owns fewer units
    kv = -(-H // 128)
    rows = gates * units // recurrent_cuda.CLUSTER_WARPS
    assert 1 <= reg_rows <= rows and reg_rows * 4 * kv <= recurrent_cuda.REG_FLOATS
    assert recurrent_cuda.cluster_smem_bytes(gates, H, units, reg_rows) <= H100[1]


def test_cluster_plan_with_two_units_a_warp():
    """The other cluster size (measured beside the plan's by chip_smoke.py)."""
    assert recurrent_cuda.cluster_plan(4, 256, 32, H100[1]) == ("cluster", 8, 32, 8)
    assert recurrent_cuda.cluster_plan(3, 512, 16, H100[1]) is None  # 32 blocks
    assert recurrent_cuda.cluster_plan(3, 64, 24, H100[1]) is None  # not 16 or 32
