"""The audio -> video inference pipeline on PyTorch.

Counterpart of ``livespeechportraits_tpu/pipeline/animate.py``: the staged
``compute_motion`` with ``valid_frames`` bucketing (without ``fused``),
``_jit_post`` as a plain function, ``render_frames`` with every transfer
(``rgb``, ``yuv420`` and the ``jpeg``, ``jpeg4`` and ``pack4e`` codes of
``pipeline/compress.py``, pack4e with its prefix fetch),
``build_render_inputs`` and ``animate``, JAX's ``mesh=`` as
``render_devices``: each render batch split over a list of devices, each
holding a replica of the renderer, and JAX's ``split_cand``: the first
conv's candidate half once a call, K1's edge-only input a batch.  Stages:

    1. mel + APC features  (ops/mel.py, models/apc.py: GRU kernel K2)
    2. LLE manifold projection (ops/manifold.py)
    3. Audio2Mouth (models/audio2feature.py: LSTM kernel K3)
    4. Audio2Headpose decode (models/audio2headpose.py)
    5. post-processing: smoothing, AMP, projection (_post)
    6. rendering: kernel K1 (landmarks -> the U-Net's input) + Feature2Face
       U-Net (the int8 convs on kernel K4), frames batched, then the
       transfer's encoder on the device and its decoder on the host

Every stage runs on the device of the models.  ``stage_ms`` holds host
wall-clock per stage; with ``profile=True`` each stage ends in
``torch.cuda.synchronize()`` so the attribution is true.  The streaming
path (``pipeline/streaming.py``) renders through the same ``FrameLink``.
"""

from __future__ import annotations

import contextlib
import copy
import time
import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from livespeechportraits_torch.config import EYE_BROW_INDICES, MOUTH_INDICES, PersonConfig
from livespeechportraits_torch.models import apc as apc_model
from livespeechportraits_torch.models import audio2feature as a2f_model
from livespeechportraits_torch.models import audio2headpose as a2h_model
from livespeechportraits_torch.models import feature2face as f2f_model
from livespeechportraits_torch.ops import (geometry, manifold, mel, rasterize_cuda,
                                           smoothing)
from livespeechportraits_torch.pipeline import compress
from livespeechportraits_torch.pipeline.assets import PersonAssets, PersonModels

Tensor = torch.Tensor


@dataclass
class AnimateResult:
    frames: np.ndarray  # [T, H, W, 3] uint8
    feature_maps: Optional[np.ndarray]  # [T, H, W] uint8 edge maps (if kept)
    landmarks: np.ndarray  # [T, 73, 2]
    headpose: np.ndarray  # [T, 6]
    pts3d: np.ndarray  # [T, 73, 3]
    nframe: int
    # Host wall-clock per stage (device-true only with profile=True).
    stage_ms: Dict[str, float] = field(default_factory=dict)
    # The frames' transfer to the host: bytes fetched, pack4e refetches.
    link: Dict[str, int] = field(default_factory=dict)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_of(models: PersonModels) -> torch.device:
    return next(models.apc.parameters()).device


TRANSFERS = ("rgb", "yuv420", "jpeg", "jpeg4", "pack4e")


def _check_transfer(transfer: str) -> None:
    if transfer not in TRANSFERS:
        raise ValueError(f"unknown transfer {transfer!r}; choose one of {TRANSFERS}")


# Process-level pack4e prefix sizes, keyed by (H, W, render batch): the last
# decoded batch's coded bytes times P4E_MARGIN.  Content is temporally stable
# within a subject, and a stale value costs one over- or under-fetch: the
# stream delimits itself, and a prefix that proves short is fetched whole.
_P4E_NEED: Dict[Tuple[int, int, int], int] = {}
P4E_BUCKETS = 32  # prefix sizes snap to this many linear steps of the cap
P4E_MARGIN = 1.15
# The profiler label of a batch's encoding on the device
CODER_LABEL = "lsp::coder"


@dataclass
class SentBatch:
    """One rendered batch on its way to the host: the host tensor (pinned
    memory on the card), the event of its copy, and for pack4e the whole
    device stream, kept until the batch is decoded in case the prefix
    proves short."""

    host: Tensor
    copied: Optional["torch.cuda.Event"]
    stream: Optional[Tensor] = None


class FrameLink:
    """The frames' way from the renderer to the host under one transfer.

    ``send`` encodes a rendered batch on its device and queues its copy to
    pinned host memory behind it (on the CPU the tensor is the host copy);
    ``receive`` waits for that copy and decodes it to uint8 RGB on the host.  rgb fetches uint8 RGB; yuv420 the planar 4:2:0 bytes; jpeg and
    jpeg4 their codes; pack4e a prefix of its stream, sized from the last
    decoded batch's coded bytes (the object's own, seeded from
    ``_P4E_NEED``) and snapped to ``P4E_BUCKETS`` steps of the cap.  A
    render loop sends in order and receives in the same order; ``send`` and
    ``receive`` may run on two threads."""

    def __init__(self, transfer: str, H: int, W: int, batch: int):
        _check_transfer(transfer)
        self.transfer, self.H, self.W, self.batch = transfer, H, W, batch
        self.fetch_bytes = 0  # the sending thread's count
        self.refetch_bytes = 0  # the receiving thread's count
        self.refetches = 0
        if transfer == "pack4e":
            self.cap = batch * compress.p4e_bytes_per_frame_cap(H, W)
            self.need = _P4E_NEED.get((H, W, batch), self.cap)

    def _prefix(self) -> int:
        step = -(-self.cap // P4E_BUCKETS)
        want = max(1, min(self.need, self.cap))
        return min(self.cap, -(-want // step) * step)

    def send(self, img: Tensor) -> SentBatch:
        """img [batch, H, W, 3] in [-1, 1] (the generator's output).  The
        encoder runs under the profiler label CODER_LABEL, which traces
        read (tools/trace_render.py)."""
        stream = None
        with torch.profiler.record_function(CODER_LABEL):
            if self.transfer == "rgb":
                out = f2f_model.to_uint8(img)
            elif self.transfer == "yuv420":
                out = rgb_to_yuv420_packed(img)
            elif self.transfer == "jpeg":
                out = compress.encode_rgb_frames(img)
            elif self.transfer == "jpeg4":
                out = compress.encode_rgb_frames_p4(img)
            else:
                stream, _ = compress.encode_rgb_frames_p4e(img)
                out = stream[:self._prefix()]
        copied = None
        if out.device.type == "cuda":
            # the copy to pinned memory queues behind the batch, so the host
            # decodes the previous batch while the device renders this one
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record()
            out = host
        self.fetch_bytes += out.numel() * out.element_size()
        return SentBatch(out, copied, stream)

    def receive(self, sent: SentBatch) -> Tensor:
        """The batch's frames [batch, H, W, 3] uint8 on the CPU."""
        if sent.copied is not None:
            sent.copied.synchronize()
        H, W = self.H, self.W
        if self.transfer == "rgb":
            return sent.host
        if self.transfer == "yuv420":
            return compress.i420_to_rgb(sent.host, H, W)
        if self.transfer == "jpeg":
            return torch.from_numpy(compress.decode_to_rgb(sent.host.numpy(), H, W))
        if self.transfer == "jpeg4":
            return torch.from_numpy(compress.decode_to_rgb_p4(sent.host.numpy(), H, W))
        try:
            rgb, consumed = compress.decode_to_rgb_p4e(sent.host.numpy(), self.batch, H, W,
                                                       return_consumed=True)
        except IndexError:  # the prefix was short: fetch the whole stream
            full = sent.stream.cpu()
            self.refetches += 1
            self.refetch_bytes += full.numel()
            rgb, consumed = compress.decode_to_rgb_p4e(full.numpy(), self.batch, H, W,
                                                       return_consumed=True)
        self.need = int(consumed * P4E_MARGIN)
        _P4E_NEED[(H, W, self.batch)] = self.need
        return torch.from_numpy(rgb)

    def stats(self) -> Dict[str, int]:
        return {"fetch_bytes": self.fetch_bytes + self.refetch_bytes,
                "p4e_refetches": self.refetches}


@torch.no_grad()
def compute_motion(cfg: PersonConfig, assets: PersonAssets, models: PersonModels,
                   audio: np.ndarray, seed: int = 0,
                   stage_ms: Optional[Dict[str, float]] = None, profile: bool = False,
                   headpose_noise: Optional[Tuple[Tensor, Tensor]] = None,
                   valid_frames: Optional[int] = None):
    """Stages 1-5: audio -> (landmarks2d [N', 73, 2], shoulders2d [N', S, 2],
    head [N', 6], pts3d [N', 73, 3], N), tensors on the models' device; the
    first N rows are the frames (N' > N only with valid_frames).

    headpose_noise: (gumbel, eps) for the head-pose decode; drawn from
    ``seed`` when None (models/audio2headpose.generate_sequence), the draws
    of frame i depending on (seed, i) alone.

    valid_frames: the unpadded audio's video-frame count when ``audio``
    carries bucket padding (serve.py).  Features past the true end repeat
    the last true row (what the A2F tail sees on the unpadded run), the
    post stage reflects at the true end, and N = valid_frames -
    frame_future: the first N rows equal the unpadded run's.  Every other
    stage is prefix-causal over the padded audio."""
    sm = stage_ms if stage_ms is not None else {}
    dev = _device_of(models)
    ff = cfg.audio2headpose.frame_future
    if valid_frames is not None and int(valid_frames) <= ff:
        raise ValueError(f"valid_frames={valid_frames} must exceed the head-pose lookahead "
                         f"frame_future={ff} (audio too short for the bucket)")

    t0 = time.perf_counter()
    mel80 = mel.compute_mel_sequence(audio, device=dev)  # [2T, 80]
    feats = apc_model.encode_fast(models.apc, mel80, residual=cfg.apc.residual)
    if profile:
        _sync(dev)
    sm["mel_apc"] = (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    if cfg.apc.use_LLE:
        feats = manifold.lle_project(feats, assets.tensor("apc_feature_base", dev),
                                     K=cfg.apc.Knear, percent=cfg.apc.LLE_percent)
        if profile:
            _sync(dev)
    sm["lle"] = (time.perf_counter() - t0) * 1e3

    if valid_frames is not None:
        # rows at or past the true end become the last true row: at the
        # FRAME count 2*valid_frames-1, not the post-stage count
        last = 2 * int(valid_frames) - 1
        feats = feats[torch.clamp(torch.arange(feats.shape[0], device=dev), max=last)]

    t0 = time.perf_counter()
    pred_feat = a2f_model.generate_sequence(models.audio2feature, feats,
                                            frame_future=cfg.audio2feature.frame_future,
                                            seed=seed)
    if profile:
        _sync(dev)
    sm["audio2mouth"] = (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    a2h_cfg = cfg.audio2headpose
    pre_headpose = torch.zeros(a2h_cfg.wavenet.input_channels, device=dev)
    pred_head = a2h_model.generate_sequence(
        models.audio2headpose, a2h_cfg, feats, pre_headpose, seed=seed,
        sigma_scale=a2h_cfg.sample_sigma_scale, noise=headpose_noise)
    if profile:
        _sync(dev)
    sm["headpose"] = (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    nframe = int(min(pred_feat.shape[0], pred_head.shape[0]))
    brow_idx = torch.as_tensor(np.arange(nframe) % assets.candidate_eye_brow.shape[0],
                               device=dev)
    valid_len = None
    if valid_frames is not None and int(valid_frames) - ff < nframe:
        valid_len = int(valid_frames) - ff
    landmarks2d, shoulders2d, head, final = _post(
        cfg, pred_feat[:nframe], pred_head[:nframe],
        *(assets.tensor(k, dev) for k in ("mean_pts3d", "std_mean_pts3d",
                                          "mean_translation", "candidate_eye_brow")),
        brow_idx,
        *(assets.tensor(k, dev) for k in ("camera_intrinsic", "shoulder3D", "ref_trans")),
        assets.scale, valid_len)
    if valid_frames is not None:
        nframe = min(nframe, int(valid_frames) - ff)
    if profile:
        _sync(dev)
    sm["post"] = (time.perf_counter() - t0) * 1e3
    return landmarks2d, shoulders2d, head, final, nframe


def _post(cfg: PersonConfig, pred_feat: Tensor, pred_head: Tensor, mean_pts3d: Tensor,
          std_mean_pts3d: Tensor, mean_translation: Tensor, candidate_eye_brow: Tensor,
          brow_idx: Tensor, K: Tensor, shoulder3D: Tensor, ref_trans: Tensor, scale: float,
          valid_len: Optional[int] = None):
    """Stage 5: smoothing, mouth AMP, lip de-intersection, head-pose
    conditioning, eyebrow cycling, landmark and shoulder projection.
    valid_len: the true length of bucket-padded inputs; smoothing reflects
    at it and the lip-flip statistic ignores the rows past it, so rows
    [0, valid_len) equal the unpadded run's."""
    a2f_cfg = cfg.audio2feature
    a2h_cfg = cfg.audio2headpose
    nframe = pred_feat.shape[0]
    dev = pred_feat.device
    mouth_idx = torch.as_tensor(MOUTH_INDICES, device=dev)
    brow_rows = torch.as_tensor(EYE_BROW_INDICES, device=dev)
    valid = None if valid_len is None else torch.arange(nframe, device=dev) < valid_len

    pts3d = pred_feat.new_zeros(nframe, 73, 3)
    pts3d[:, mouth_idx] = pred_feat.reshape(nframe, 25, 3)
    pts3d = smoothing.landmark_smooth_3d(pts3d, a2f_cfg.smooth_sigma, "only_mouth",
                                         valid_len=valid_len)
    pts3d = smoothing.mouth_amp(pts3d, True, a2f_cfg.amp_method, a2f_cfg.amp_params)
    pts3d = smoothing.solve_intersect_mouth(pts3d + mean_pts3d, valid)

    head = pred_head[:, :6].clone()
    head[:, :3] *= a2h_cfg.rot_amp
    head[:, 3:] *= a2h_cfg.trans_amp
    head = smoothing.headpose_smooth(head, a2h_cfg.smooth_sigmas, valid_len=valid_len)
    head[:, 3:] += mean_translation
    head[:, 0] += 180.0  # x-axis convention flip (reference demo.py:232)

    final = std_mean_pts3d.expand(nframe, 73, 3).clone()
    final[:, 46:64] = pts3d[:, 46:64]
    final[:, brow_rows] = candidate_eye_brow[brow_idx] + mean_pts3d[brow_rows]

    eye = torch.eye(3, device=dev)
    landmarks2d = geometry.project_landmarks(K, eye, torch.zeros(3, device=dev), scale,
                                             head, final)
    shoulders2d, _ = geometry.project_shoulders(K, shoulder3D, head[:, 3:], ref_trans,
                                                a2h_cfg.shoulder_amp)
    return landmarks2d, shoulders2d, head, final


def _shift_shoulders(assets: PersonAssets, shoulders2d: Tensor) -> Tensor:
    if assets.image_pad is None:
        return shoulders2d
    top, bottom, left, right = assets.image_pad
    return shoulders2d + torch.tensor([right - left, top - bottom],
                                      device=shoulders2d.device, dtype=torch.float32)


def _cand_stack(assets: PersonAssets, size: int, dev: torch.device,
                dtype: torch.dtype) -> Tensor:
    """[H, W, 12] in ``dtype``: the four candidate images on channels, as
    JAX's concat, cast once for a whole render call."""
    cand = assets.tensor("candidate_images", dev)  # [4, H, W, 3]
    return cand.permute(1, 2, 0, 3).reshape(size, size, 12).to(dtype)


def compute_dtype(cfg: PersonConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.feature2face.precision == "bfloat16" else torch.float32


# The renderer's replicas on other devices, kept while the renderer lives:
# {renderer: {device: replica}}.
_REPLICAS: "weakref.WeakKeyDictionary[torch.nn.Module, Dict[torch.device, torch.nn.Module]]" = \
    weakref.WeakKeyDictionary()


def _replica(net: torch.nn.Module, dev: torch.device) -> torch.nn.Module:
    """The renderer on ``dev``: itself on its own device, else a copy made
    once (int8 QConv2d weights and static scales included)."""
    if next(iter(net.state_dict().values())).device == dev:
        return net
    per = _REPLICAS.setdefault(net, {})
    if dev not in per:
        per[dev] = copy.deepcopy(net).to(dev)
    return per[dev]


def _resolved(device: torch.device | str) -> torch.device:
    """The device with its index ("cuda" is the current card)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _on(dev: torch.device):
    """The device's context: a kernel launched by hand (K1, K4) goes to the
    current device's stream."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


@torch.no_grad()
def render_frames(cfg: PersonConfig, assets: PersonAssets, models: PersonModels,
                  landmarks2d: Tensor, shoulders2d: Tensor, render_batch: int = 8,
                  keep_feature_maps: bool = False,
                  stage_ms: Optional[Dict[str, float]] = None, transfer: str = "rgb",
                  link: Optional[Dict[str, int]] = None,
                  render_devices: Optional[List[torch.device | str]] = None,
                  split_cand: bool = False):
    """Stage 6: rasterise + U-Net, ``render_batch`` frames at a time.
    Returns (frames [N, H, W, 3] uint8, edge maps [N, H, W] uint8 or None).

    transfer (see FrameLink): 'rgb' (exact) fetches uint8 RGB; 'yuv420'
    packs each batch on the device as planar 4:2:0 (half the bytes) and
    converts back on the host; 'jpeg', 'jpeg4' and 'pack4e' encode a
    JPEG-class code on the device (pipeline/compress.py), which the native
    codec decodes.  On the card each batch is fetched into pinned memory
    behind its render, and the host decodes it while the device renders the
    next batch: ``render_device`` then covers the device work and the
    overlapped host work, ``render`` the last batch's decode.  A batch's
    U-Net input is one K1 launch (rasterize_cuda.render_input) and no host
    round trip, so the host queues a batch while the device still renders
    the one before.  ``link`` receives FrameLink.stats() (summed over the
    devices).

    render_devices (JAX's ``mesh=``): each batch of render_batch frames is
    split evenly over these devices, each rendering its rows on its replica
    of the renderer (its own K1 launch, U-Net and transfer encoding), and
    the frames are gathered back in order.  render_batch must divide over
    them.  A device listed twice renders two shares on one replica; one
    device (the default: the landmarks') is the plain path.

    split_cand (JAX's): the U-Net's first conv is split into its edge and
    candidate halves.  The candidates' half is computed once a call on each
    render device (f2f_model.precompute_cand_down), and each batch's input is
    K1's edge-only form [B, H, W, 1] (one launch), which
    f2f_model.apply_generator_edge convolves.  The frames agree with the
    unsplit render within rounding (the sum rounds once more)."""
    _check_transfer(transfer)
    sm = stage_ms if stage_ms is not None else {}
    dev = landmarks2d.device
    devices = [_resolved(d) for d in render_devices or [dev]]
    if render_batch % len(devices) != 0:
        raise ValueError(f"render_batch {render_batch} must divide over the data axis "
                         f"({len(devices)} devices)")
    per = render_batch // len(devices)
    t0 = time.perf_counter()
    nframe = landmarks2d.shape[0]
    H = W = cfg.feature2face.load_size
    shoulders2d = _shift_shoulders(assets, shoulders2d)
    # a no-op for a generator already cast (serve.Predictor casts once)
    net = f2f_model.cast_generator(models.feature2face, compute_dtype(cfg))
    cand_stack = _cand_stack(assets, H, dev, compute_dtype(cfg))
    # (device, renderer, candidate stack or, under split_cand, its first-conv
    # half, FrameLink) of each share of a batch
    shares = []
    for d in devices:
        with _on(d):
            replica, cand = _replica(net, d), cand_stack.to(d)
            if split_cand:
                cand = f2f_model.precompute_cand_down(replica, cand)
            shares.append((d, replica, cand, FrameLink(transfer, H, W, per)))

    pad_to = -(-nframe // render_batch) * render_batch
    lm = torch.cat([landmarks2d, landmarks2d[-1:].expand(pad_to - nframe, 73, 2)])
    sh = torch.cat([shoulders2d,
                    shoulders2d[-1:].expand(pad_to - nframe, *shoulders2d.shape[1:])])
    frames = torch.empty(pad_to, H, W, 3, dtype=torch.uint8)
    maps: List[Tensor] = []
    pending = None  # the previous batch: (first frame, SentBatch)

    def finish(batch) -> None:
        start, sent = batch
        for k, ((_, _, _, frame_link), s) in enumerate(zip(shares, sent)):
            frames[start + k * per:start + (k + 1) * per] = frame_link.receive(s)

    for start in range(0, pad_to, render_batch):
        sent = []
        for k, (d, replica, cand, frame_link) in enumerate(shares):
            rows = slice(start + k * per, start + (k + 1) * per)
            lm_k, sh_k = lm[rows], sh[rows]
            if d != dev:
                lm_k, sh_k = lm_k.to(d, non_blocking=True), sh_k.to(d, non_blocking=True)
            with _on(d):
                if split_cand:
                    inp = rasterize_cuda.render_input(lm_k, sh_k, None, (H, W),
                                                      dtype=cand_stack.dtype)
                    img = f2f_model.apply_generator_edge(replica, inp, cand)
                else:
                    inp = rasterize_cuda.render_input(lm_k, sh_k, cand, (H, W))
                    img = f2f_model.apply_generator(replica, inp)
                sent.append(frame_link.send(img))
            if keep_feature_maps:
                maps.append(inp[..., 0].float().to(dev))
        if pending is not None:
            finish(pending)
        pending = (start, sent)
    for d in dict.fromkeys(devices):
        _sync(d)
    sm["render_device"] = (time.perf_counter() - t0) * 1e3
    finish(pending)
    frames_u8 = frames[:nframe].numpy()
    sm["render"] = (time.perf_counter() - t0) * 1e3 - sm["render_device"]
    if link is not None:
        stats = [s[3].stats() for s in shares]
        link.update({k: sum(st[k] for st in stats) for k in stats[0]})
    fmap_u8 = None
    if keep_feature_maps:
        fmap_u8 = (torch.cat(maps)[:nframe] * 255).to(torch.uint8).cpu().numpy()
    return frames_u8, fmap_u8


@torch.no_grad()
def build_render_inputs(cfg: PersonConfig, assets: PersonAssets, models: PersonModels,
                        audio: np.ndarray, seed: int = 0, max_frames: int = 16) -> Tensor:
    """The first ``max_frames`` renderer inputs [N, H, W, 13] (edge channel +
    candidate stack, in the renderer's compute dtype) of ``audio``, exactly
    as render_frames feeds the U-Net (one K1 launch): the batches int8
    calibration measures its scales on."""
    landmarks2d, shoulders2d, _, _, nframe = compute_motion(cfg, assets, models, audio,
                                                            seed=seed)
    n = min(nframe, max_frames)
    H = W = cfg.feature2face.load_size
    cand = _cand_stack(assets, H, landmarks2d.device, compute_dtype(cfg))
    return rasterize_cuda.render_input(landmarks2d[:n],
                                       _shift_shoulders(assets, shoulders2d[:n]), cand, (H, W))


def rgb_to_yuv420_packed(img: Tensor) -> Tensor:
    """[B, H, W, 3] in [-1, 1] -> [B, H*W*3/2] uint8: the Y, U and V planes
    (BT.601 full range, 2x2 chroma mean) packed in one contiguous buffer,
    with the arithmetic of JAX's _rgb_to_yuv420_packed."""
    rgb = (img + 1.0) * 127.5
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    v = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0

    def down2(c):  # 2x2 mean, summed in JAX's reduction order
        return (((c[:, 0::2, 0::2] + c[:, 0::2, 1::2]) + c[:, 1::2, 0::2])
                + c[:, 1::2, 1::2]) / 4.0

    def to_u8(c):
        return torch.clamp(c + 0.5, 0, 255).to(torch.uint8).reshape(c.shape[0], -1)

    return torch.cat([to_u8(y), to_u8(down2(u)), to_u8(down2(v))], dim=1)


def animate(cfg: PersonConfig, assets: PersonAssets, models: PersonModels, audio: np.ndarray,
            seed: int = 0, render_batch: int = 8, keep_feature_maps: bool = False,
            profile: bool = False,
            headpose_noise: Optional[Tuple[Tensor, Tensor]] = None,
            transfer: str = "rgb", valid_frames: Optional[int] = None,
            render_devices: Optional[List[torch.device | str]] = None,
            split_cand: bool = False) -> AnimateResult:
    """audio [-1, 1] float32 at 16 kHz -> frames at 60 FPS, on the models'
    device.  transfer: one of TRANSFERS (see render_frames).
    render_devices: split each render batch over these devices (see
    render_frames); the motion half stays on the models' device.
    split_cand: the first conv's candidate half once a call, K1's edge-only
    input a batch (see render_frames).
    valid_frames: the unpadded audio's frame count when ``audio`` is
    bucket-padded (see compute_motion); the result then equals the unpadded
    run's, trimmed to valid_frames - frame_future frames."""
    _check_transfer(transfer)
    stage_ms: Dict[str, float] = {}
    link: Dict[str, int] = {}
    landmarks2d, shoulders2d, head, final, nframe = compute_motion(
        cfg, assets, models, audio, seed=seed, stage_ms=stage_ms, profile=profile,
        headpose_noise=headpose_noise, valid_frames=valid_frames)
    frames, fmaps = render_frames(cfg, assets, models, landmarks2d[:nframe],
                                  shoulders2d[:nframe], render_batch=render_batch,
                                  keep_feature_maps=keep_feature_maps, stage_ms=stage_ms,
                                  transfer=transfer, link=link,
                                  render_devices=render_devices, split_cand=split_cand)
    return AnimateResult(
        frames=frames,
        feature_maps=fmaps,
        landmarks=landmarks2d[:nframe].cpu().numpy(),
        headpose=head[:nframe].cpu().numpy(),
        pts3d=final[:nframe].cpu().numpy(),
        nframe=nframe,
        stage_ms=stage_ms,
        link=link,
    )
