"""The motion half as plain float32 PyTorch and NumPy: audio -> landmarks
and shoulders a frame.

mel (120 Hz, 80 bins) -> APC GRU stack -> KNN + LLE onto the subject's
feature bank -> Audio2Feature (LSTM, mouth deltas) -> Audio2Headpose
(WaveNet + GMM, decoded autoregressively by the reference's own sliding
window: each step runs the whole receptive field) -> smoothing, mouth
amplitude, lip de-intersection, eyebrow cycling, projection.  Frozen from
the published pipeline (the reference repo's ``demo.py`` and ``funcs/``);
imports nothing of the program under test.  Post-processing runs in
float64 NumPy with scipy's filter.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import scipy.ndimage
import torch
import torch.nn.functional as F

from lspbench.reference.nets import StateDict, batchnorm

Tensor = torch.Tensor
SAMPLE_RATE, FPS = 16000, 60
MOUTH_INDICES = tuple(range(4, 11)) + tuple(range(46, 64))
EYE_BROW_INDICES = (27, 65, 28, 68, 29, 67, 30, 66, 31, 72, 32, 69, 33, 70, 34, 71)
UPPER_INNER_LIP, LOWER_INNER_LIP = (63, 62, 61), (58, 59, 60)
UPPER_OUTER_LIP, LOWER_OUTER_LIP = tuple(range(47, 52)), tuple(range(57, 52, -1))


# -- mel ---------------------------------------------------------------------

def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27),
                    f * 3.0 / 200.0)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    return np.where(m >= 15.0, 1000.0 * np.exp(np.log(6.4) / 27 * (m - 15.0)), m * 200.0 / 3.0)


def mel_basis(n_fft: int = 512, n_mels: int = 80, fmin: float = 90.0, fmax: float = 7600.0):
    """librosa.filters.mel(sr=16000, n_fft, n_mels, fmin, fmax), slaney."""
    freqs = np.linspace(0.0, SAMPLE_RATE / 2.0, 1 + n_fft // 2)
    pts = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(pts)
    ramps = pts[:, None] - freqs[None, :]
    w = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None], ramps[2:] / fdiff[1:, None]))
    return (w * (2.0 / (pts[2:] - pts[:-2]))[:, None]).astype(np.float32)


def log_mel(audio: np.ndarray, device) -> Tensor:
    """[N] audio -> [2 * floor(N / 16000 * 60), 80]: mel frame i is the
    266-sample clip at floor(i * 133.33), reflect-padded by 189 to 512 and
    windowed by a periodic Hann window of 266; clips past the end read
    zeros; log clamped at 1e-5 and scaled to [0, 1]."""
    n = 2 * int(len(audio) / SAMPLE_RATE * FPS)
    win, n_fft = SAMPLE_RATE // FPS, 512
    pad = (n_fft - SAMPLE_RATE // (2 * FPS)) // 2
    padded = np.concatenate([audio.astype(np.float32), np.zeros(win, np.float32)])
    starts = np.floor(np.arange(n) * (SAMPLE_RATE * 0.5 / FPS)).astype(np.int64)
    p = np.arange(n_fft) - pad
    p = np.where(p < 0, -p, p)
    col = np.where(p >= win, 2 * (win - 1) - p, p)
    window = np.zeros(n_fft, np.float32)
    k = np.arange(win)
    window[(n_fft - win) // 2:(n_fft - win) // 2 + win] = 0.5 * (1 - np.cos(2 * np.pi * k / win))
    x = torch.as_tensor(padded, device=device)[torch.as_tensor(starts[:, None] + col[None],
                                                                 device=device)]
    mag = torch.fft.rfft(x * torch.as_tensor(window, device=device), n=n_fft, dim=-1).abs()
    mel = mag @ torch.as_tensor(mel_basis(), device=device).t()
    lo = math.log(1e-5)
    return (torch.log(torch.clamp(mel, min=1e-5)) - lo) / -lo


# -- recurrent stacks -----------------------------------------------------------

def gru_stack(sd: StateDict, prefix: str, layers: int, x: Tensor) -> Tensor:
    """[T, in] through ``layers`` one-layer GRUs (keys rnns.<i>.*_l0)."""
    y = x[None]
    for i in range(layers):
        w = [sd[f"{prefix}{i}.{k}_l0"] for k in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
        gru = torch.nn.GRU(w[0].shape[1], w[1].shape[1], batch_first=True).to(x.device)
        with torch.no_grad():
            for p, t in zip((gru.weight_ih_l0, gru.weight_hh_l0, gru.bias_ih_l0, gru.bias_hh_l0),
                            w):
                p.copy_(t)
        y = gru(y)[0]
    return y[0]


def lstm_stack(sd: StateDict, prefix: str, layers: int, x: Tensor) -> Tensor:
    """[T, in] through a ``layers``-layer LSTM (keys LSTM.*_l<k>)."""
    hidden = sd[f"{prefix}weight_hh_l0"].shape[1]
    lstm = torch.nn.LSTM(x.shape[-1], hidden, num_layers=layers, batch_first=True).to(x.device)
    lstm.load_state_dict({k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)})
    return lstm(x[None])[0][0]


def lle(feats: Tensor, bank: Tensor, K: int, percent: float) -> Tensor:
    """Each row replaced (by ``percent``) with its locally linear
    reconstruction from its K nearest bank rows (sum-to-one weights; a
    singular system falls back to uniform weights)."""
    dist = (feats * feats).sum(-1, keepdim=True) + (bank * bank).sum(-1)[None] \
        - 2.0 * feats @ bank.t()
    idx = torch.topk(-dist, min(K, bank.shape[0]), dim=-1).indices
    nb = bank[idx]
    A = nb[:, 1:] - nb[:, :1]
    gram = A @ A.transpose(1, 2)
    rhs = A @ (feats - nb[:, 0])[:, :, None]
    w_rest = torch.linalg.solve_ex(gram, rhs).result[..., 0]
    w = torch.cat([1.0 - w_rest.sum(-1, keepdim=True), w_rest], dim=-1)
    w = torch.where(torch.isfinite(w).all(-1, keepdim=True), w, torch.full_like(w, 1.0 / w.shape[-1]))
    return feats * (1.0 - percent) + (w[:, None, :] @ nb)[:, 0] * percent


def _mlp_down(sd: StateDict, p: str, x: Tensor) -> Tensor:
    y = F.leaky_relu(batchnorm(F.linear(x, sd[f"{p}.0.weight"], sd[f"{p}.0.bias"]), sd, f"{p}.1"),
                     0.2)
    return F.linear(y, sd[f"{p}.3.weight"], sd[f"{p}.3.bias"])


def apc_features(c: dict, sd_apc: StateDict, bank: Tensor, mel: Tensor) -> Tensor:
    feats = gru_stack(sd_apc, "rnns.", c["apc_layers"], mel)
    return lle(feats, bank, c["lle_k"], c["lle_percent"])


def audio2feature(c: dict, sd: StateDict, feats: Tensor) -> Tensor:
    """[2T, H] -> [T, 75] mouth deltas (L2 head): the tail padded with the
    last row for frame_future frames, the first frame_future dropped."""
    T, ff = feats.shape[0] // 2, c["a2f_frame_future"]
    f = torch.cat([feats[:2 * T], feats[2 * T - 1:2 * T].expand(2 * ff, -1)])
    y = _mlp_down(sd, "downsample", f.reshape(T + ff, -1))
    y = lstm_stack(sd, "LSTM.", c["a2f_lstm_layers"], y)
    fc = lambda i, z: F.linear(z, sd[f"fc.{i}.weight"], sd[f"fc.{i}.bias"])  # noqa: E731
    z = F.leaky_relu(batchnorm(fc(0, y), sd, "fc.1"), 0.2)
    z = F.leaky_relu(batchnorm(fc(3, z), sd, "fc.4"), 0.2)
    return fc(6, z)[ff:][:T]


# -- head pose ------------------------------------------------------------------

def _mix64(z):
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def draw_noise(n: int, ncenter: int, ndim: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """The head-pose decode's draws of steps 0 .. n-1: (Gumbel [n, ncenter],
    normal [n, ndim]) float32, row i a counter hash of (seed, i) alone
    (SplitMix64, then Box-Muller): the pipeline's published draw rule."""
    width = ncenter + 2 * (-(-ndim // 2))
    with np.errstate(over="ignore"):
        key = _mix64(np.array([seed % 2 ** 64], np.uint64) + np.uint64(0x9E3779B97F4A7C15))
        ctr = (np.arange(n, dtype=np.uint64)[:, None] * np.uint64(width)
               + np.arange(width, dtype=np.uint64)[None])
        bits = _mix64(_mix64(ctr ^ key) + key)
    u = ((bits >> np.uint64(11)).astype(np.float64) + 0.5) * 2.0 ** -53
    gumbel = -np.log(-np.log(u[:, :ncenter]))
    u1, u2 = u[:, ncenter::2], u[:, ncenter + 1::2]
    r = np.sqrt(-2.0 * np.log(u1))
    eps = np.concatenate([r * np.cos(2 * np.pi * u2), r * np.sin(2 * np.pi * u2)], axis=1)
    return gumbel.astype(np.float32), eps[:, :ndim].astype(np.float32)


def _wavenet(c: dict, sd: StateDict, x: Tensor, cond: Tensor) -> Tensor:
    """Whole-window WaveNet: x [1, C, L], cond [1, H, L] -> the last frame's
    GMM parameters [gmm_dim]."""
    act = lambda t: F.leaky_relu(t, 0.2)  # noqa: E731
    w = lambda n: sd[f"WaveNet.{n}.weight"]  # noqa: E731
    b = lambda n: sd[f"WaveNet.{n}.bias"]  # noqa: E731
    h = act(F.conv1d(x, w("start_conv1"), b("start_conv1")))
    h = act(F.conv1d(h, w("start_conv2"), b("start_conv2")))
    skip = 0.0
    for i in range(c["wn_blocks"] * c["wn_layers"]):
        d = 2 ** (i % c["wn_layers"])
        p = f"residual_blocks.{i}."
        hp = F.pad(h, ((c["wn_kernel_size"] - 1) * d, 0))
        f = F.conv1d(hp, w(p + "filter_conv"), b(p + "filter_conv"), dilation=d)
        g = F.conv1d(hp, w(p + "gate_conv"), b(p + "gate_conv"), dilation=d)
        f = f + F.conv1d(cond, w(p + "cond_filter_conv"), b(p + "cond_filter_conv"))
        g = g + F.conv1d(cond, w(p + "cond_gate_conv"), b(p + "cond_gate_conv"))
        z = torch.tanh(f) * torch.sigmoid(g)
        h = F.conv1d(z, w(p + "residual_conv"), b(p + "residual_conv")) + h
        skip = skip + F.conv1d(z, w(p + "skip_conv"), b(p + "skip_conv"))
    out = F.conv1d(act(skip), w("end_conv_1"), b("end_conv_1"))
    return F.conv1d(act(out), w("end_conv_2"), b("end_conv_2"))[0, :, -1]


def receptive_field(c: dict) -> int:
    return 1 + c["wn_blocks"] * (2 ** c["wn_layers"] - 1) * (c["wn_kernel_size"] - 1)


def audio2headpose(c: dict, sd: StateDict, feats: Tensor, seed: int) -> Tensor:
    """[2T, H] -> [T - frame_future, 12]: step i feeds the last R poses (zeros
    before the first) and the audio rows i + f - R + 1 .. i + f (rows < 0
    read row 0) through the WaveNet and samples mu + sigma * scale * eps of
    the component argmax(logits + gumbel)."""
    T, ff, R = feats.shape[0] // 2, c["a2h_frame_future"], receptive_field(c)
    n, C, D = T - ff, c["a2h_ncenter"], c["a2h_ndim"]
    cond = _mlp_down(sd, "audio_downsample", feats[:2 * T].reshape(T, -1))
    cond = torch.cat([cond[:1].expand(R - 1, -1), cond]).t()[None]  # [1, H, R - 1 + T]
    gumbel, eps = (torch.as_tensor(a, device=feats.device) for a in draw_noise(n, C, D, seed))
    hist = feats.new_zeros(1, c["wn_input_channels"], R)
    out = []
    for i in range(n):
        p = _wavenet(c, sd, hist, cond[:, :, i + ff:i + ff + R])
        mu = p[C:C + C * D].view(C, D)
        sigma = torch.exp(-p[C + C * D:]).view(C, D) * c["a2h_sigma"]
        k = torch.argmax(p[:C] + gumbel[i])
        x = mu[k] + sigma[k] * eps[i]
        out.append(x)
        hist = torch.cat([hist[:, :, 1:], x.view(1, -1, 1)], dim=2)
    return torch.stack(out)


# -- post-processing and projection -------------------------------------------

def _euler(deg: np.ndarray) -> np.ndarray:
    x, y, z = np.deg2rad(deg).T
    cx, sx, cy, sy, cz, sz = np.cos(x), np.sin(x), np.cos(y), np.sin(y), np.cos(z), np.sin(z)
    return np.stack([
        np.stack([cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx], -1),
        np.stack([sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx], -1),
        np.stack([-sy, cy * sx, cy * cx], -1)], -2)


def post(c: dict, A: dict, pred_feat: np.ndarray, pred_head: np.ndarray):
    """(landmarks2d [n, 73, 2], shoulders2d [n, S, 2]) float64."""
    n = min(len(pred_feat), len(pred_head))
    smooth = lambda x, s: scipy.ndimage.gaussian_filter1d(x, s, axis=0)  # noqa: E731
    pts = np.zeros((n, 73, 3))
    pts[:, list(MOUTH_INDICES)] = pred_feat[:n].reshape(n, 25, 3)
    pts = smooth(pts.reshape(n, -1), c["a2f_smooth"]).reshape(n, 73, 3)
    pts[:, 46:64] *= np.asarray(c["a2f_amp"][1:], np.float64)
    pts = pts + A["mean_pts3d"]
    ui, li, uo, lo = (list(g) for g in (UPPER_INNER_LIP, LOWER_INNER_LIP, UPPER_OUTER_LIP,
                                        LOWER_OUTER_LIP))
    upper, lower = pts[:, ui, 1], pts[:, li, 1]
    flip = (lower > upper).sum(1) == 3
    half = (lower - upper) * 0.5
    gmean = (half * flip[:, None]).sum() / (max(int(flip.sum()), 1) * half.shape[1])
    pts[:, ui, 1] += np.where(flip[:, None], half, 0.0)
    pts[:, li, 1] += np.where(flip[:, None], -half, 0.0)
    pts[:, uo, 1] += np.where(flip[:, None], gmean, 0.0)
    pts[:, lo, 1] += np.where(flip[:, None], -gmean, 0.0)

    head = pred_head[:n, :6].astype(np.float64).copy()
    head[:, :3] *= c["a2h_rot_amp"]
    head[:, 3:] *= c["a2h_trans_amp"]
    head[:, :3] = smooth(head[:, :3], c["a2h_smooth"][0])
    head[:, 3:] = smooth(head[:, 3:], c["a2h_smooth"][1])
    head[:, 3:] += A["mean_translation"]
    head[:, 0] += 180.0

    final = np.repeat(A["std_mean_pts3d"][None].astype(np.float64), n, 0)
    final[:, 46:64] = pts[:, 46:64]
    brows = list(EYE_BROW_INDICES)
    cand = A["candidate_eye_brow"]
    final[:, brows] = cand[np.arange(n) % len(cand)] + A["mean_pts3d"][brows]
    K = A["camera_intrinsic"].astype(np.float64)
    p = A["scale"] * np.einsum("tij,tnj->tni", _euler(head[:, :3]), final) + head[:, None, 3:]
    uvw = np.einsum("ij,tnj->tni", K, p)
    lm = uvw[..., :2] / uvw[..., 2:3]
    s3 = A["shoulder3D"][None] + ((head[:, 3:] - A["ref_trans"][None]) * c["shoulder_amp"])[:, None]
    uvw = np.einsum("ij,tnj->tni", K, s3)
    return lm, uvw[..., :2] / uvw[..., 2:3]


def motion(c: dict, A: dict, sd: dict, audio: np.ndarray, seed: int, device):
    """audio -> (landmarks2d, shoulders2d) of its frames, as float64 numpy."""
    with torch.no_grad():
        mel = log_mel(audio, device)
        feats = apc_features(c, sd["apc"], A["bank"], mel)
        pred_feat = audio2feature(c, sd["a2f"], feats)
        pred_head = audio2headpose(c, sd["a2h"], feats, seed)
    return post(c, A, pred_feat.double().cpu().numpy(), pred_head.double().cpu().numpy())
