"""PyTorch port, models/nn_core.py: each layer function against the JAX one
on the same numpy inputs and weights (JAX layouts converted as in
utils/convert.py).  Tolerances are f32 summation-order noise (atol 1e-5 on
O(1) values) unless stated."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from livespeechportraits_tpu.models import nn_core as jcore
from livespeechportraits_torch.models import nn_core

RNG = np.random.default_rng(0)


def _rand(*shape, scale=1.0):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


def test_dense_matches_jax():
    w, b, x = _rand(24, 16), _rand(16), _rand(5, 24)
    lin = nn.Linear(24, 16)
    lin.weight.data, lin.bias.data = torch.tensor(w.T.copy()), torch.tensor(b)
    ref = np.asarray(jcore.dense({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x)))
    np.testing.assert_allclose(nn_core.dense(torch.tensor(x), lin).detach().numpy(), ref,
                               atol=1e-5)


@pytest.mark.parametrize("dilation,pad", [(1, (0, 0)), (4, (4, 0)), (2, (1, 1))])
def test_conv1d_matches_jax(dilation, pad):
    w, b, x = _rand(2, 6, 5), _rand(5), _rand(2, 17, 6)  # JAX [k, in, out], NWC
    conv = nn.Conv1d(6, 5, 2)
    conv.weight.data = torch.tensor(w.transpose(2, 1, 0).copy())
    conv.bias.data = torch.tensor(b)
    ref = jcore.conv1d({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x),
                       dilation=dilation, padding=[pad])
    ours = nn_core.conv1d(torch.tensor(x).transpose(1, 2), conv, dilation=dilation,
                          padding=pad).transpose(1, 2)
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("stride,padding", [(1, 1), (2, 1), (1, 0)])
def test_conv2d_matches_jax(stride, padding):
    w, x = _rand(3, 3, 4, 6), _rand(2, 9, 9, 4)  # JAX HWIO, NHWC
    conv = nn.Conv2d(4, 6, 3, bias=False)
    conv.weight.data = torch.tensor(w.transpose(3, 2, 0, 1).copy())
    ref = jcore.conv2d({"w": jnp.asarray(w)}, jnp.asarray(x), stride=stride, padding=padding)
    ours = nn_core.conv2d(torch.tensor(x).permute(0, 3, 1, 2), conv, stride=stride,
                          padding=padding).permute(0, 2, 3, 1)
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), atol=1e-5)


def test_batchnorm_eval_matches_jax():
    x = _rand(3, 5, 5, 7)
    p = {"scale": _rand(7), "bias": _rand(7), "mean": _rand(7),
         "var": np.abs(_rand(7)) + 0.1}
    bn = nn.BatchNorm2d(7)
    bn.weight.data, bn.bias.data = torch.tensor(p["scale"]), torch.tensor(p["bias"])
    bn.running_mean.data, bn.running_var.data = torch.tensor(p["mean"]), torch.tensor(p["var"])
    ref, _ = jcore.batchnorm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    ours = nn_core.batchnorm(torch.tensor(x).permute(0, 3, 1, 2), bn).permute(0, 2, 3, 1)
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), atol=1e-5)


def test_activations_and_upsample_match_jax():
    x = _rand(2, 3, 4, 5)  # NHWC
    np.testing.assert_array_equal(nn_core.leaky_relu(torch.tensor(x)).numpy(),
                                  np.asarray(jcore.leaky_relu(jnp.asarray(x))))
    up = nn_core.upsample_nearest_2x(torch.tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(up.numpy(), np.asarray(jcore.upsample_nearest_2x(jnp.asarray(x))))


def _rnn_params(in_dim, H, G):
    s = 1 / np.sqrt(H)
    return {"w_ih": _rand(in_dim, G * H, scale=s), "w_hh": _rand(H, G * H, scale=s),
            "b_ih": _rand(G * H, scale=s), "b_hh": _rand(G * H, scale=s)}


def _torch_rnn(p):
    return [torch.tensor(p["w_ih"].T.copy()), torch.tensor(p["w_hh"].T.copy()),
            torch.tensor(p["b_ih"]), torch.tensor(p["b_hh"])]


def test_gru_layer_matches_jax():
    p = _rnn_params(12, 20, 3)
    x, h0 = _rand(2, 23, 12), _rand(2, 20)
    ref, h_ref = jcore.gru_layer({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                                 jnp.asarray(h0))
    ys, hT = nn_core.gru_layer(torch.tensor(x), *_torch_rnn(p), torch.tensor(h0))
    np.testing.assert_allclose(ys.numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(hT.numpy(), np.asarray(h_ref), atol=1e-5)


def test_lstm_layer_matches_jax():
    p = _rnn_params(12, 20, 4)
    x = _rand(2, 23, 12)
    state = (_rand(2, 20), _rand(2, 20))
    ref, (h_ref, c_ref) = jcore.lstm_layer({k: jnp.asarray(v) for k, v in p.items()},
                                           jnp.asarray(x), tuple(map(jnp.asarray, state)))
    ys, (h, c) = nn_core.lstm_layer(torch.tensor(x), *_torch_rnn(p),
                                    tuple(map(torch.tensor, state)))
    np.testing.assert_allclose(ys.numpy(), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), atol=1e-5)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), atol=1e-5)


def test_rnn_weights_use_torch_parameter_names():
    rnn = nn_core.RNNWeights(8, 4, 2, gates=4)
    assert sorted(rnn.state_dict()) == sorted(torch.nn.LSTM(8, 4, 2).state_dict())
    assert rnn.layer(1)[0].shape == (16, 4)
