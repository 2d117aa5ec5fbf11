"""GRU / LSTM layers whose time loop runs in one CUDA kernel (K2 / K3).

Counterpart of ``livespeechportraits_tpu/ops/recurrent_pallas.py``.  The
input projection x @ W_ih^T + b_ih is one matmul over the whole sequence;
the recurrence runs in ``csrc/recurrent.cu``: one thread-block cluster with
W_hh held on chip and h exchanged through distributed shared memory, or,
for shapes a cluster cannot hold, a cooperative persistent grid (see the
note at the top of that file).  ``plan`` makes that choice from the shape
alone and the kernel checks the plan it is given.

Dispatch is on the tensor's device: a CPU tensor takes the plain PyTorch
twin (``models/nn_core.gru_layer`` / ``lstm_layer``), a CUDA tensor takes
the kernel, and any other device raises.  ``GRU_LAUNCHES`` and
``LSTM_LAUNCHES`` count kernel launches, ``PLAN_LAUNCHES`` the same
launches by layer and plan (``"gru/cluster"``, ``"lstm/grid"``, ...).
"""

from __future__ import annotations

import collections
import math
from typing import Dict, Optional, Tuple

import torch

from livespeechportraits_torch import _build
from livespeechportraits_torch.models import nn_core

Tensor = torch.Tensor
Plan = Tuple  # ("cluster", blocks, units, reg_rows) or ("grid", units)

GRU_LAUNCHES = 0
LSTM_LAUNCHES = 0
PLAN_LAUNCHES: collections.Counter = collections.Counter()

# The cluster kernel's tile, as in csrc/recurrent.cu: 16 warps a block, each
# warp 1 or 2 units with all their gates; a lane keeps at most 64 floats of
# W_hh in registers (48 for a warp of 8 rows of 512); h padded to whole
# 128-float columns, H <= 512.
CLUSTER_WARPS = 16
REG_FLOATS = 64
REG_FLOATS_8X512 = 48
RING = 8
MAX_CLUSTER = 16
MAX_CLUSTER_H = 512

_limits: Dict[int, Tuple[int, int]] = {}


def cluster_smem_bytes(gates: int, H: int, units: int, reg_rows: int) -> int:
    """Shared memory of one cluster block: two mbarriers, two h buffers, the
    W_hh rows that are not in registers, the xp ring, the gate sums and b_hh."""
    k = 128 * math.ceil(H / 128)
    smem_rows = gates * units // CLUSTER_WARPS - reg_rows
    return 16 + 4 * (2 * k + smem_rows * CLUSTER_WARPS * k + (RING + 2) * gates * units)


def grid_smem_bytes(gates: int, H: int, units: int) -> int:
    """Shared memory of one grid block: its G*U rows of W_hh, h, the gate
    sums and c."""
    return 4 * (gates * units * H + H + gates * units + units)


def cluster_plan(gates: int, H: int, units: int, smem_optin: int) -> Optional[Plan]:
    """The cluster plan with ``units`` (16 or 32) units a block, or None
    when the shape does not fit it."""
    if H > MAX_CLUSTER_H or units not in (CLUSTER_WARPS, 2 * CLUSTER_WARPS):
        return None
    blocks = math.ceil(H / units)
    rows = gates * units // CLUSTER_WARPS
    kv = math.ceil(H / 128)
    reg_rows = min(rows, (REG_FLOATS_8X512 if rows == 8 and kv == 4 else REG_FLOATS) // (4 * kv))
    if blocks > MAX_CLUSTER or cluster_smem_bytes(gates, H, units, reg_rows) > smem_optin:
        return None
    return ("cluster", blocks, units, reg_rows)


def plan(gates: int, H: int, n_sm: int, smem_optin: int) -> Plan:
    """Which kernel runs a layer of this shape on a card with ``n_sm`` SMs
    and ``smem_optin`` bytes of shared memory a block: the cluster kernel
    with one unit a warp (16 a block) where that holds the shape, else two
    units a warp, else the grid kernel with ceil(H / n_sm) units a block.
    One unit a warp measured faster on an H100 at the LSTM's H=256: 16
    blocks against 8 (PERF.md); the GRU's H=512 fits only two."""
    for units in (CLUSTER_WARPS, 2 * CLUSTER_WARPS):
        p = cluster_plan(gates, H, units, smem_optin)
        if p is not None:
            return p
    units = math.ceil(H / n_sm)
    if grid_smem_bytes(gates, H, units) > smem_optin:
        raise ValueError(f"no recurrence kernel holds W_hh of {gates} gates at H={H}")
    return ("grid", units)


def device_limits(dev: torch.device) -> Tuple[int, int]:
    """(SMs, opt-in shared memory bytes a block) of the card ``dev``."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if index not in _limits:
        with torch.cuda.device(index):
            smem = _build.library().lsp_smem_optin()
        if smem <= 0:
            raise RuntimeError(f"cannot query the shared memory of cuda:{index}")
        _limits[index] = (torch.cuda.get_device_properties(index).multi_processor_count, smem)
    return _limits[index]


def device_plan(gates: int, H: int, dev: torch.device) -> Plan:
    """``plan`` for the card ``dev``."""
    return plan(gates, H, *device_limits(dev))


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
                c0: Optional[Tensor], plan: Optional[Plan] = None):
    """Launch K2 (gates=3) or K3 (gates=4) on CUDA tensors.

    xp [T, G*H], w_hh [G*H, H], b_hh [G*H], h0 (and c0) [H].  ``plan``
    (default: ``device_plan``) names the kernel; the kernel refuses a plan
    that does not fit the shape, and nothing retries another one."""
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
    p = device_plan(gates, H, dev) if plan is None else plan
    if p[0] == "cluster":
        args = (p[1], p[2], p[3])
    elif p[0] == "grid":
        args = (0, p[1], 0)
    else:
        raise ValueError(f"unknown recurrence plan {p!r}")
    layer = "gru" if gates == 3 else "lstm"
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if gates == 3:
            err = lib.lsp_gru(xp.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
                              h0.data_ptr(), ys.data_ptr(), hT.data_ptr(), T, H, *args, stream)
            _build.check(err, f"lsp_gru {p}")
            GRU_LAUNCHES += 1
            PLAN_LAUNCHES[f"{layer}/{p[0]}"] += 1
            return ys, hT, None
        cT = torch.empty(H, device=dev, dtype=torch.float32)
        err = lib.lsp_lstm(xp.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
                           h0.data_ptr(), c0.data_ptr(), ys.data_ptr(), hT.data_ptr(),
                           cT.data_ptr(), T, H, *args, stream)
        _build.check(err, f"lsp_lstm {p}")
        LSTM_LAUNCHES += 1
        PLAN_LAUNCHES[f"{layer}/{p[0]}"] += 1
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
