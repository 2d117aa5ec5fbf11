"""GRU / LSTM layers whose time loop runs in one CUDA kernel (K2 / K3).

Counterpart of ``livespeechportraits_tpu/ops/recurrent_pallas.py``.  The
input projection x @ W_ih^T + b_ih is one matmul over the whole sequence;
the recurrence runs in ``csrc/recurrent.cu`` (a cooperative persistent grid
with W_hh resident in shared memory, see the note at the top of that file).

Dispatch is on the tensor's device: a CPU tensor takes the plain PyTorch
twin (``models/nn_core.gru_layer`` / ``lstm_layer``), a CUDA tensor takes
the kernel, and any other device raises.  ``GRU_LAUNCHES`` and
``LSTM_LAUNCHES`` count kernel launches.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from livespeechportraits_torch import _build
from livespeechportraits_torch.models import nn_core

Tensor = torch.Tensor

GRU_LAUNCHES = 0
LSTM_LAUNCHES = 0


def _check(name: str, t: Tensor, shape, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _recurrence(gates: int, xp: Tensor, w_hh: Tensor, b_hh: Tensor, h0: Tensor,
                c0: Optional[Tensor]):
    """Launch K2 (gates=3) or K3 (gates=4) on CUDA tensors.

    xp [T, G*H], w_hh [G*H, H], b_hh [G*H], h0 (and c0) [H]."""
    global GRU_LAUNCHES, LSTM_LAUNCHES
    dev = xp.device
    if dev.type != "cuda":
        raise ValueError(f"the recurrence kernel needs CUDA tensors, got {dev}")
    T = xp.shape[0]
    H = w_hh.shape[1]
    _check("xp", xp, (T, gates * H), dev)
    _check("w_hh", w_hh, (gates * H, H), dev)
    _check("b_hh", b_hh, (gates * H,), dev)
    _check("h0", h0, (H,), dev)
    if c0 is not None:
        _check("c0", c0, (H,), dev)
    ys = torch.empty(T, H, device=dev, dtype=torch.float32)
    hT = torch.empty(H, device=dev, dtype=torch.float32)
    if T == 0:
        return ys, h0.clone(), (None if c0 is None else c0.clone())
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if gates == 3:
            err = lib.lsp_gru(xp.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
                              h0.data_ptr(), ys.data_ptr(), hT.data_ptr(), T, H, stream)
            _build.check(err, "lsp_gru")
            GRU_LAUNCHES += 1
            return ys, hT, None
        cT = torch.empty(H, device=dev, dtype=torch.float32)
        err = lib.lsp_lstm(xp.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
                           h0.data_ptr(), c0.data_ptr(), ys.data_ptr(), hT.data_ptr(),
                           cT.data_ptr(), T, H, stream)
        _build.check(err, "lsp_lstm")
        LSTM_LAUNCHES += 1
        return ys, hT, cT


def _device_kind(x: Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type


def gru_layer(x: Tensor, w_ih: Tensor, w_hh: Tensor, b_ih: Tensor, b_hh: Tensor,
              h0: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Drop-in for nn_core.gru_layer on one sequence: x [1, T, I] ->
    ([1, T, H], h_T [1, H])."""
    if _device_kind(x) == "cpu":
        return nn_core.gru_layer(x, w_ih, w_hh, b_ih, b_hh, h0)
    if x.shape[0] != 1:
        raise ValueError("the GRU kernel runs batch 1 (the inference shape)")
    H = w_hh.shape[1]
    xp = torch.addmm(b_ih, x[0], w_ih.t()).contiguous()  # [T, 3H]
    h = x.new_zeros(H) if h0 is None else h0.reshape(H).contiguous()
    ys, hT, _ = _recurrence(3, xp, w_hh.contiguous(), b_hh.contiguous(), h, None)
    return ys[None], hT[None]


def lstm_layer(x: Tensor, w_ih: Tensor, w_hh: Tensor, b_ih: Tensor, b_hh: Tensor,
               state: Optional[Tuple[Tensor, Tensor]] = None
               ) -> Tuple[Tensor, Tuple[Tensor, Tensor]]:
    """Drop-in for nn_core.lstm_layer on one sequence: x [1, T, I] ->
    ([1, T, H], (h_T [1, H], c_T [1, H]))."""
    if _device_kind(x) == "cpu":
        return nn_core.lstm_layer(x, w_ih, w_hh, b_ih, b_hh, state)
    if x.shape[0] != 1:
        raise ValueError("the LSTM kernel runs batch 1 (the inference shape)")
    H = w_hh.shape[1]
    xp = torch.addmm(b_ih, x[0], w_ih.t()).contiguous()  # [T, 4H]
    if state is None:
        h, c = x.new_zeros(H), x.new_zeros(H)
    else:
        h, c = state[0].reshape(H).contiguous(), state[1].reshape(H).contiguous()
    ys, hT, cT = _recurrence(4, xp, w_hh.contiguous(), b_hh.contiguous(), h, c)
    return ys[None], (hT[None], cT[None])
