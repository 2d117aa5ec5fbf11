"""The fused motion half: stages 1-5 as three device functions over
preallocated buffers, two of them replayed from CUDA graphs on the card.

Counterpart of JAX's ``_jit_motion`` (livespeechportraits_tpu/pipeline/
animate.py, one device program for stages 1-5, taken by
``compute_motion(fused=True)`` and by ``serve.Predictor``) and of the
stream's ``_motion_chunk_fused`` / ``_stream_chunk_fused``
(pipeline/streaming.py).  Each function reads and writes only tensors
allocated before it runs, and makes no host read:

- G1 (``MotionGraphs.g1``; one a bucket length n_mel): mel framing, the
  three APC layers (K2), LLE, the feature repeat-pad at a device row index,
  A2F (K3) and its decode, the A2H audio downsample, the conditioning
  projections of every decode step, and the priming of the WaveNet's ring
  buffers (``pre_decode``);
- G2 (``MotionGraphs.g2``): the head-pose decode, n steps from row
  ``row`` of the projections and the noise through
  ``audio2headpose.decode_steps``: on the card one launch of kernel K5
  (ops/decode_cuda.py), which reads row and step on the device; not a
  graph;
- G3 (``MotionGraphs.g3``; one a bucket length): post, with the valid
  length a device scalar (``post``).

On a CUDA device G1 and G3 are captured once, on first use, after one
eager warm-up on the capture stream, into the subject's private memory
pool; a request is then G1's replay, G2's one launch, and G3's replay.
The audio, the noise and two scalars go in through pinned staging buffers
and ``non_blocking`` copies; the outputs are cloned out before the call
returns.  A capture or a replay that fails raises: nothing falls back to
eager work on the card.  On the CPU (the tests) the same three functions
run eagerly, G2's steps in ``decode_step``'s loop.

A request records into its trace (utils/profiling.py) the spans
``motion.g1``, ``motion.decode`` and ``motion.g3`` (the host's enqueue;
on the card the device time between CUDA events recorded before G1, after
G1, after G2 and after G3, the first and last also timing the caller's
span ``motion``), a span ``motion.capture`` a capture, and the
counters ``decode_steps`` (the steps G2 decoded, bucket padding
included) and ``graph_captures``.

A stream's steady state (``ChunkGraphs``, C = its chunk) adds two graphs:
the front (mel at device frame offsets, APC from the carried GRU state,
LLE) and the motion chunk (the A2F chunk from the carried LSTM state, the
downsample, the conditioning window at a device offset, its projections);
the decode is the same G2 over C steps, with the stream's carried WaveNet
state copied in before and out after.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from livespeechportraits_torch.config import (EYE_BROW_INDICES, FPS, MOUTH_INDICES,
                                              SAMPLE_RATE, PersonConfig)
from livespeechportraits_torch.models import apc as apc_model
from livespeechportraits_torch.models import audio2feature as a2f_model
from livespeechportraits_torch.models import audio2headpose as a2h_model
from livespeechportraits_torch.ops import (device_consts, geometry, gmm, manifold, mel,
                                           recurrent_cuda, smoothing)
from livespeechportraits_torch.utils import profiling

Tensor = torch.Tensor

# K2 / K3 launches made by graph replays, keyed "K2" / "K3".  The wrappers'
# counters (recurrent_cuda.GRU_LAUNCHES / LSTM_LAUNCHES) count the wrapper
# calls that launch; a capture records its wrapper calls without launching,
# so it takes them back off those counters, and each replay adds them here
# (and to recurrent_cuda.PLAN_LAUNCHES, by plan).
REPLAYED_LAUNCHES: collections.Counter = collections.Counter()

# Decode rows a subject's buffers hold at first (10 s at 60 FPS: serve.py's
# max_audio_seconds); a longer request grows them and captures again.
DEFAULT_ROWS = 600


def _device_of(models) -> torch.device:
    return next(models.apc.parameters()).device


# ---------------------------------------------------------------------------
# The device functions (the staged path calls the same pieces)
# ---------------------------------------------------------------------------


def repeat_past(feats: Tensor, last: Optional[int | Tensor]) -> Tensor:
    """Rows past ``last`` (an int, or an int64 [1] tensor on feats' device)
    become row ``last``: what the unpadded run's A2F tail sees when
    ``feats`` carries bucket padding.  None leaves feats as they are."""
    if last is None:
        return feats
    return feats[torch.clamp(torch.arange(feats.shape[0], device=feats.device), max=last)]


def features(cfg: PersonConfig, assets, models, mel80: Tensor) -> Tensor:
    """[2T, 80] log-mel -> [2T, H] projected APC features (APC on K2, then
    LLE)."""
    feats = apc_model.encode_fast(models.apc, mel80, residual=cfg.apc.residual)
    if cfg.apc.use_LLE:
        feats = manifold.lle_project(feats, assets.tensor("apc_feature_base", feats.device),
                                     K=cfg.apc.Knear, percent=cfg.apc.LLE_percent)
    return feats


def pre_headpose(cfg: PersonConfig, device: torch.device) -> Tensor:
    """The decode's first input and warm-up history: zeros."""
    return torch.zeros(cfg.audio2headpose.wavenet.input_channels, device=device)


def pre_decode(cfg: PersonConfig, assets, models, audio: Tensor, n_mel: int,
               feat_last: Optional[Tensor], a2f_gumbel: Optional[Tensor],
               dec: a2h_model.DecodeBuffers, pred_feat: Tensor) -> None:
    """G1: audio [>= mel.samples_read(n_mel)] (zeros past the utterance) ->
    A2F's mouth rows into pred_feat [T, 75], and ``dec`` ready for decode
    steps 0 .. T - frame_future - 1 (conditioning projections, primed rings,
    step, row and x_prev reset)."""
    dev = audio.device
    mel80 = mel.mel_frames(audio, mel.frame_start_tensor(0, n_mel, dev))
    feats = repeat_past(features(cfg, assets, models, mel80), feat_last)
    pred_feat.copy_(a2f_model.generate_sequence(models.audio2feature, feats,
                                                frame_future=cfg.audio2feature.frame_future,
                                                gumbel=a2f_gumbel))
    a2h = cfg.audio2headpose
    model = models.audio2headpose
    audio_ds = a2h_model.downsample_sequence(model, feats)
    nframe = audio_ds.shape[0] - a2h.frame_future
    a2h_model.prime_decode(model, a2h, audio_ds, pre_headpose(cfg, dev), dec, 0, nframe)


def brow_index(assets, start: int, n: int, device: torch.device) -> Tensor:
    """Frame start+i's eyebrow candidate: (start + i) % candidates, on the
    device."""
    return torch.remainder(torch.arange(start, start + n, device=device),
                           assets.candidate_eye_brow.shape[0])


def landmark_rows(device: torch.device) -> Tuple[Tensor, Tensor]:
    """The mouth and eyebrow landmark rows as index tensors (uploaded once)."""
    return (device_consts.const("MOUTH_INDICES", device, lambda: np.asarray(MOUTH_INDICES)),
            device_consts.const("EYE_BROW_INDICES", device,
                                lambda: np.asarray(EYE_BROW_INDICES)))


def post(cfg: PersonConfig, assets, pred_feat: Tensor, pred_head: Tensor,
         valid_len: Optional[int | Tensor] = None):
    """Stage 5 (G3): smoothing, mouth AMP, lip de-intersection, head-pose
    conditioning, eyebrow cycling, landmark and shoulder projection ->
    (landmarks2d [n, 73, 2], shoulders2d [n, S, 2], head [n, 6], pts3d
    [n, 73, 3]).  valid_len (an int, or an int64 [1] tensor on the device:
    the fused program's): the true length of bucket-padded inputs;
    smoothing reflects at it and the lip-flip statistic ignores the rows
    past it, so rows [0, valid_len) equal the unpadded run's."""
    a2f_cfg = cfg.audio2feature
    a2h_cfg = cfg.audio2headpose
    nframe = pred_feat.shape[0]
    dev = pred_feat.device
    asset = lambda name: assets.tensor(name, dev)  # noqa: E731
    mouth_idx, brow_rows = landmark_rows(dev)
    valid = None if valid_len is None else torch.arange(nframe, device=dev) < valid_len

    pts3d = pred_feat.new_zeros(nframe, 73, 3)
    pts3d[:, mouth_idx] = pred_feat.reshape(nframe, 25, 3)
    pts3d = smoothing.landmark_smooth_3d(pts3d, a2f_cfg.smooth_sigma, "only_mouth",
                                         valid_len=valid_len)
    pts3d = smoothing.mouth_amp(pts3d, True, a2f_cfg.amp_method, a2f_cfg.amp_params)
    pts3d = smoothing.solve_intersect_mouth(pts3d + asset("mean_pts3d"), valid)

    head = pred_head[:, :6].clone()
    head[:, :3] *= a2h_cfg.rot_amp
    head[:, 3:] *= a2h_cfg.trans_amp
    head = smoothing.headpose_smooth(head, a2h_cfg.smooth_sigmas, valid_len=valid_len)
    head[:, 3:] += asset("mean_translation")
    head[:, 0] += 180.0  # x-axis convention flip (reference demo.py:232)

    final = asset("std_mean_pts3d").expand(nframe, 73, 3).clone()
    final[:, 46:64] = pts3d[:, 46:64]
    final[:, brow_rows] = (asset("candidate_eye_brow")[brow_index(assets, 0, nframe, dev)]
                           + asset("mean_pts3d")[brow_rows])
    K = asset("camera_intrinsic")
    landmarks2d = geometry.project_landmarks(K, torch.eye(3, device=dev),
                                             torch.zeros(3, device=dev), assets.scale, head,
                                             final)
    shoulders2d, _ = geometry.project_shoulders(K, asset("shoulder3D"), head[:, 3:],
                                                asset("ref_trans"), a2h_cfg.shoulder_amp)
    return landmarks2d, shoulders2d, head, final


# ---------------------------------------------------------------------------
# Capture
# ---------------------------------------------------------------------------


def _cudart():
    """The CUDA runtime torch loaded, for cudaGraphGetNodes (None if its
    name is not found)."""
    for name in ("libcudart.so.12", "libcudart.so.13", "libcudart.so"):
        try:
            return ctypes.CDLL(name)
        except OSError:
            continue
    return None


@dataclass
class Graph:
    """One captured CUDA graph and what its capture measured: the wall of
    the capture and of the instantiation (ms), the graph's node count, the
    K2 / K3 launches it holds, and the bytes the subject's memory pool grew
    by (0 when the graph reuses blocks an earlier capture freed there)."""

    name: str
    graph: "torch.cuda.CUDAGraph"
    capture_ms: float
    instantiate_ms: float
    nodes: Optional[int]
    launches: Dict[str, int]
    pool_bytes: int
    plans: Dict[str, int] = field(default_factory=dict)  # the launches by plan

    def replay(self) -> None:
        self.graph.replay()
        REPLAYED_LAUNCHES.update(self.launches)
        recurrent_cuda.PLAN_LAUNCHES.update(self.plans)

    def stats(self) -> dict:
        return {"nodes": self.nodes, "capture_ms": self.capture_ms,
                "instantiate_ms": self.instantiate_ms, "pool_bytes": self.pool_bytes,
                "launches": dict(self.launches)}


def capture(name: str, fn: Callable[[], object], stream: "torch.cuda.Stream", pool,
            device: torch.device) -> Graph:
    """Run ``fn`` once eagerly on ``stream`` (the warm-up: constant uploads,
    library handles, the kernel library), then capture it into a CUDA graph
    in ``pool`` and instantiate it.  Raises if the capture fails.  Inside
    a request, a span ``motion.capture`` and the counter ``graph_captures``:
    a bucket first used while serving stalls the request this long."""
    trace = profiling.current()
    span = trace.begin("motion.capture", "motion")
    trace.count("graph_captures")
    cur = torch.cuda.current_stream(device)
    stream.wait_stream(cur)
    with torch.cuda.stream(stream):
        fn()
    cur.wait_stream(stream)
    k2, k3 = recurrent_cuda.GRU_LAUNCHES, recurrent_cuda.LSTM_LAUNCHES
    plans = collections.Counter(recurrent_cuda.PLAN_LAUNCHES)
    # the capture empties the allocator's cache first: do it here, so the
    # reserved bytes grow by what the graph's pool takes
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device)
    g = torch.cuda.CUDAGraph(keep_graph=True)
    t0 = time.perf_counter()
    # thread_local: the stream's decode thread may wait on a copy meanwhile
    with torch.cuda.graph(g, pool=pool, stream=stream, capture_error_mode="thread_local"):
        fn()
    t1 = time.perf_counter()
    g.instantiate()
    t2 = time.perf_counter()
    nodes = None
    rt = _cudart()
    if rt is not None:
        n = ctypes.c_size_t(0)
        if rt.cudaGraphGetNodes(ctypes.c_void_p(g.raw_cuda_graph()), None, ctypes.byref(n)) == 0:
            nodes = int(n.value)
    # the wrappers counted the calls the capture recorded: not launches
    launches = {"K2": recurrent_cuda.GRU_LAUNCHES - k2, "K3": recurrent_cuda.LSTM_LAUNCHES - k3}
    recurrent_cuda.GRU_LAUNCHES, recurrent_cuda.LSTM_LAUNCHES = k2, k3
    by_plan = recurrent_cuda.PLAN_LAUNCHES - plans
    recurrent_cuda.PLAN_LAUNCHES.subtract(by_plan)
    span.close()
    return Graph(name, g, (t1 - t0) * 1e3, (t2 - t1) * 1e3, nodes,
                 {k: v for k, v in launches.items() if v},
                 torch.cuda.memory_reserved(device) - reserved, dict(by_plan))


# ---------------------------------------------------------------------------
# A subject's buffers and graphs
# ---------------------------------------------------------------------------


@dataclass
class Bucket:
    """One bucket length's static buffers and its G1 / G3 graphs."""

    n_mel: int
    nframe: int
    audio: Tensor  # [mel.samples_read(n_mel)]
    scalars: Tensor  # int64 [2]: the last true feature row, the valid length
    a2f_gumbel: Optional[Tensor]  # [T + frame_future, ncenter] (GMM head, ncenter > 1)
    pred_feat: Tensor  # [T, 75]
    out: Tuple[Tensor, Tensor, Tensor, Tensor]  # landmarks, shoulders, head, pts3d
    host: Dict[str, Tensor] = field(default_factory=dict)  # pinned twins of the inputs
    g1: Optional[Graph] = None
    g3: Optional[Graph] = None

    @property
    def feat_last(self) -> Tensor:
        return self.scalars[0:1]

    @property
    def valid_len(self) -> Tensor:
        return self.scalars[1:2]


class MotionGraphs:
    """The fused motion half of one subject (cfg, assets, models) on the
    models' device: the shared decode buffers, a ``Bucket`` a length, a
    ``ChunkGraphs`` a stream chunk size.  ``for_models`` keeps one a
    subject and device; calls are serialised by ``lock``."""

    def __init__(self, cfg: PersonConfig, assets, models, rows: int = DEFAULT_ROWS):
        self.cfg, self.assets, self.models = cfg, assets, models
        self.device = _device_of(models)
        self.on_card = self.device.type == "cuda"
        self.lock = threading.RLock()
        self.sigma_scale = float(cfg.audio2headpose.sample_sigma_scale)
        self.pool = torch.cuda.graph_pool_handle() if self.on_card else None
        self.stream = torch.cuda.Stream(self.device) if self.on_card else None
        self._staged: Optional["torch.cuda.Event"] = None  # the last pinned copies
        self._weights: Optional[tuple] = None
        self._alloc(rows)

    # -- buffers ----------------------------------------------------------

    def _alloc(self, rows: int) -> None:
        a2h = self.cfg.audio2headpose
        self.dec = a2h_model.DecodeBuffers(self.models.audio2headpose, a2h, rows, self.device)
        self.noise_host = self.pinned((rows, a2h.ncenter)), self.pinned((rows, a2h.ndim))
        self.buckets: Dict[int, Bucket] = {}
        self.chunks: Dict[int, ChunkGraphs] = {}

    def pinned(self, shape, dtype=torch.float32) -> Optional[Tensor]:
        return torch.zeros(shape, dtype=dtype, pin_memory=True) if self.on_card else None

    def reserve(self, rows: int) -> None:
        """Decode buffers of at least ``rows`` rows (whole seconds); growing
        them drops every graph, which the next calls capture again."""
        if rows > self.dec.rows:
            self._alloc(-(-rows // FPS) * FPS)

    def bucket(self, n_mel: int) -> Bucket:
        """The buffers of bucket length ``n_mel`` (allocated on first use)."""
        b = self.buckets.get(n_mel)
        if b is None:
            cfg, dev = self.cfg, self.device
            T = n_mel // 2
            nframe = T - cfg.audio2headpose.frame_future
            a2f = cfg.audio2feature
            zeros = lambda *s: torch.zeros(*s, device=dev)  # noqa: E731
            n_sh = self.assets.shoulder3D.shape[0]
            b = Bucket(n_mel=n_mel, nframe=nframe,
                       audio=zeros(mel.samples_read(n_mel)),
                       # no padding until a request stages its own: the
                       # warm-up before a capture reads them
                       scalars=torch.tensor([n_mel - 1, nframe], dtype=torch.int64,
                                            device=dev),
                       a2f_gumbel=(zeros(T + a2f.frame_future, a2f.gmm_ncenter)
                                   if _a2f_draws(cfg) else None),
                       pred_feat=zeros(T, a2f.output_dim),
                       out=(zeros(nframe, 73, 2), zeros(nframe, n_sh, 2), zeros(nframe, 6),
                            zeros(nframe, 73, 3)))
            if self.on_card:
                b.host = {"audio": self.pinned(b.audio.shape),
                          "scalars": self.pinned((2,), torch.int64)}
                if b.a2f_gumbel is not None:
                    b.host["a2f_gumbel"] = self.pinned(b.a2f_gumbel.shape)
            self.buckets[n_mel] = b
        return b

    def nbytes(self) -> int:
        """Bytes of the static device buffers (the decode's, the buckets',
        the chunks')."""
        ts = [t for b in self.buckets.values()
              for t in (b.audio, b.scalars, b.a2f_gumbel, b.pred_feat, *b.out)]
        ts += [t for c in self.chunks.values() for t in c.tensors()]
        return self.dec.nbytes() + sum(t.numel() * t.element_size() for t in ts
                                       if t is not None)

    # -- the three functions ----------------------------------------------

    def g1(self, b: Bucket) -> None:
        pre_decode(self.cfg, self.assets, self.models, b.audio, b.n_mel, b.feat_last,
                   b.a2f_gumbel, self.dec, b.pred_feat)

    def g2(self, n: int) -> None:
        a2h_model.decode_steps(self.models.audio2headpose, self.cfg.audio2headpose, self.dec, n,
                               self.sigma_scale)

    def g3(self, b: Bucket) -> None:
        outs = post(self.cfg, self.assets, b.pred_feat[:b.nframe], self.dec.samples[:b.nframe],
                    b.valid_len)
        for dst, src in zip(b.out, outs):
            dst.copy_(src)

    # -- graphs -----------------------------------------------------------

    def on_device(self):
        """The models' card as the current device (nothing on the CPU)."""
        return torch.cuda.device(self.device) if self.on_card else contextlib.nullcontext()

    def capture(self, name: str, fn: Callable[[], object]) -> Graph:
        return capture(name, fn, self.stream, self.pool, self.device)

    def check_weights(self) -> None:
        """Drop every graph when a motion model's tensors moved (a graph
        reads them at the addresses of its capture)."""
        ms = (self.models.apc, self.models.audio2feature, self.models.audio2headpose)
        key = tuple(t.data_ptr() for m in ms for t in itertools.chain(m.parameters(),
                                                                      m.buffers()))
        if key != self._weights:
            if self._weights is not None:
                self._alloc(self.dec.rows)
            self._weights = key

    def prepare(self, n_mel: int) -> Bucket:
        """The bucket of length ``n_mel`` with its graphs captured: what a
        request of that length replays.  The card only."""
        if not self.on_card:
            raise ValueError("CUDA graphs need a CUDA device; the CPU runs the functions")
        with self.lock, self.on_device():
            self.check_weights()
            self.reserve(n_mel // 2)
            b = self.bucket(n_mel)
            if b.g1 is None:
                b.g1 = self.capture(f"G1[{n_mel}]", lambda: self.g1(b))
            if b.g3 is None:
                b.g3 = self.capture(f"G3[{n_mel}]", lambda: self.g3(b))
            return b

    def graph_stats(self) -> Dict[str, dict]:
        out = {}
        for b in self.buckets.values():
            for g in (b.g1, b.g3):
                if g is not None:
                    out[g.name] = g.stats()
        for c in self.chunks.values():
            for g in (c.front_graph, c.motion_graph):
                if g is not None:
                    out[g.name] = g.stats()
        return out

    # -- staging ----------------------------------------------------------

    def wait_staged(self) -> None:
        """The pinned buffers are written again only after the copies out of
        them ran (an event wait, not a stream synchronize)."""
        if self._staged is not None:
            self._staged.synchronize()
            self._staged = None

    def mark_staged(self) -> None:
        if self.on_card:
            self._staged = torch.cuda.Event()
            self._staged.record()

    @staticmethod
    def stage(dst: Tensor, host: Optional[Tensor], src: Tensor) -> None:
        """src (a CPU tensor of n <= len(dst) rows) into dst[:n]: through the
        pinned twin and a non_blocking copy on the card, directly on the
        CPU."""
        n = src.shape[0]
        if host is None:
            dst[:n].copy_(src)
            return
        host[:n].copy_(src)
        dst[:n].copy_(host[:n], non_blocking=True)

    def stage_noise(self, gumbel: Tensor, eps: Tensor) -> None:
        self.stage(self.dec.gumbel, self.noise_host[0], gumbel)
        self.stage(self.dec.eps, self.noise_host[1], eps)

    # -- a request ----------------------------------------------------------

    def run(self, audio: np.ndarray, seed: int = 0,
            noise: Optional[Tuple[Tensor, Tensor]] = None,
            valid_frames: Optional[int] = None, graphs: Optional[bool] = None):
        """compute_motion(fused=True): audio -> (landmarks2d, shoulders2d,
        head, pts3d, nframe) on the models' device, as the staged path
        returns them (the tensors are copies: the next request cannot
        overwrite them).  graphs: replay the CUDA graphs (the default on the
        card); False runs the three functions eagerly (on the card only for
        checks: the graphs' warm-up does the same)."""
        cfg = self.cfg
        a2h = cfg.audio2headpose
        graphs = self.on_card if graphs is None else graphs
        if graphs and not self.on_card:
            raise ValueError("CUDA graphs need a CUDA device; the CPU runs the functions")
        audio = np.asarray(audio, np.float32)
        n_mel = 2 * int(audio.shape[0] / SAMPLE_RATE * FPS)
        T = n_mel // 2
        nframe = T - a2h.frame_future
        if nframe <= 0:
            raise ValueError(f"utterance too short: {T} frames <= frame_future "
                             f"{a2h.frame_future}")
        post_valid = None if valid_frames is None else int(valid_frames) - a2h.frame_future
        feat_last, valid_len = n_mel - 1, nframe
        if post_valid is not None and post_valid < nframe:
            feat_last, valid_len = 2 * int(valid_frames) - 1, post_valid
        if noise is None:
            noise = gmm.draw_noise(nframe, a2h.ncenter, a2h.ndim, seed)
        gumbel, eps = (n[:nframe].to("cpu", torch.float32) for n in noise)
        if gumbel.shape[0] < nframe:
            raise ValueError(f"headpose_noise covers {gumbel.shape[0]} steps; the request "
                             f"decodes {nframe}")
        with self.lock, self.on_device():
            if graphs:
                b = self.prepare(n_mel)
            else:
                self.check_weights()
                self.reserve(T)
                b = self.bucket(n_mel)
            self.wait_staged()
            span = np.zeros(b.audio.shape[0], np.float32)
            span[:min(len(audio), len(span))] = audio[:len(span)]
            self.stage(b.audio, b.host.get("audio"), torch.from_numpy(span))
            self.stage(b.scalars, b.host.get("scalars"),
                        torch.tensor([feat_last, valid_len], dtype=torch.int64))
            if b.a2f_gumbel is not None:
                self.stage(b.a2f_gumbel, b.host.get("a2f_gumbel"),
                            a2f_model.component_gumbel(b.a2f_gumbel.shape[0],
                                                       cfg.audio2feature.gmm_ncenter, seed))
            self.stage_noise(gumbel, eps)
            self.mark_staged()
            if graphs:
                g1, g3 = b.g1.replay, b.g3.replay
            else:
                g1, g3 = (lambda: self.g1(b)), (lambda: self.g3(b))
            trace = profiling.current()
            stamps = [(time.time_ns(), trace.mark(self.device))]
            g1()
            stamps.append((time.time_ns(), trace.mark(self.device)))
            self.g2(nframe)
            trace.count("decode_steps", nframe)
            stamps.append((time.time_ns(), trace.mark(self.device)))
            g3()
            stamps.append((time.time_ns(), trace.mark(self.device)))
            for name, (t0, e0), (t1, e1) in zip(("motion.g1", "motion.decode", "motion.g3"),
                                                stamps, stamps[1:]):
                trace.add(name, "motion", t0, t1, (e0, e1))
            motion = trace.open_span("motion")
            if motion is not None:
                motion.time_device(stamps[0][1], stamps[-1][1])
            out = tuple(t.clone() for t in b.out)
        if post_valid is not None:
            nframe = min(nframe, post_valid)
        return (*out, nframe)


def _a2f_draws(cfg: PersonConfig) -> bool:
    """Whether A2F's decode reads component draws (a GMM head of more than
    one component)."""
    a2f = cfg.audio2feature
    return a2f.loss == "GMM" and a2f.gmm_ncenter > 1


def for_models(cfg: PersonConfig, assets, models) -> MotionGraphs:
    """The subject's MotionGraphs on its models' device, kept on the models
    object (one a device, assets and config)."""
    cache = models.__dict__.setdefault("_motion_graphs", {})
    key = (str(_device_of(models)), id(assets), cfg)
    mg = cache.get(key)
    if mg is None:
        mg = cache[key] = MotionGraphs(cfg, assets, models)
    return mg


# ---------------------------------------------------------------------------
# The stream's steady state
# ---------------------------------------------------------------------------


class ChunkGraphs:
    """The static buffers and graphs of a stream's steady-state chunk of C
    frames (JAX's _stream_chunk_fused = ``front`` then ``motion``;
    _motion_chunk_fused = ``motion``), then G2 over C steps."""

    def __init__(self, mg: MotionGraphs, C: int):
        cfg, dev, models = mg.cfg, mg.device, mg.models
        self.mg, self.C = mg, C
        zeros = lambda *s, **kw: torch.zeros(*s, device=dev, **kw)  # noqa: E731
        H = cfg.apc.hidden_size
        lh = cfg.audio2feature.lstm_hidden_size
        D = cfg.audio2headpose.wavenet.cond_channels
        # a fixed span length: the true one wobbles by a sample with the
        # fractional hop; the tail past every frame's last sample is unread
        self.span = int(np.ceil(2 * C * mel.MEL_STEP)) + mel.MEL_WIN
        self.audio = zeros(self.span)
        self.offsets = zeros(2 * C, dtype=torch.int64)
        self.apc_h = zeros(len(models.apc.rnns), H)
        self.lstm = zeros(models.audio2feature.LSTM.num_layers, 2, lh)
        self.feats = zeros(2 * C, H)  # the front's output, the motion chunk's pairs
        self.old_tail = zeros(C, D)
        self.win_off = zeros(1, dtype=torch.int64)
        self.a2f_gumbel = zeros(C, cfg.audio2feature.gmm_ncenter) if _a2f_draws(cfg) else None
        self.new_rows = zeros(C, D)
        # what the host fetches: the A2F rows and, after G2, the samples
        self.out = zeros(C, cfg.audio2feature.output_dim + cfg.audio2headpose.ndim)
        self.host = {}
        if mg.on_card:
            self.host = {"audio": mg.pinned(self.audio.shape),
                         "offsets": mg.pinned(self.offsets.shape, torch.int64),
                         "win_off": mg.pinned((1,), torch.int64)}
            if self.a2f_gumbel is not None:
                self.host["a2f_gumbel"] = mg.pinned(self.a2f_gumbel.shape)
        self.front_graph: Optional[Graph] = None
        self.motion_graph: Optional[Graph] = None

    def tensors(self) -> List[Tensor]:
        return [self.audio, self.offsets, self.apc_h, self.lstm, self.feats, self.old_tail,
                self.win_off, self.a2f_gumbel, self.new_rows, self.out]

    def front(self) -> None:
        """mel at the frame offsets, APC from the carried GRU state, LLE."""
        mg = self.mg
        mels = mel.mel_frames(self.audio, self.offsets)
        feats, h = apc_model.encode_chunk(mg.models.apc, mels, list(self.apc_h),
                                          residual=mg.cfg.apc.residual)
        if mg.cfg.apc.use_LLE:
            feats = manifold.lle_project(
                feats, mg.assets.tensor("apc_feature_base", feats.device), K=mg.cfg.apc.Knear,
                percent=mg.cfg.apc.LLE_percent)
        self.feats.copy_(feats)
        self.apc_h.copy_(torch.stack(h))

    def motion(self) -> None:
        """The A2F chunk from the carried LSTM state and its decode, the
        downsample of the chunk's rows, the decode's conditioning window
        (the last C cached rows and the fresh ones, from the device offset
        win_off) and its projections into the decode buffers."""
        mg, C = self.mg, self.C
        cfg = mg.cfg
        model = mg.models.audio2headpose
        pairs = self.feats.reshape(C, -1)
        out, state = a2f_model.apply_chunk(mg.models.audio2feature, pairs,
                                           [(s[0], s[1]) for s in self.lstm])
        out = a2f_model.decode(cfg.audio2feature, out, gumbel=self.a2f_gumbel)
        self.lstm.copy_(torch.stack([torch.stack(s) for s in state]))
        new_rows = a2h_model._audio_downsample(model, pairs[None])[0]
        self.new_rows.copy_(new_rows)
        rows2c = torch.cat([self.old_tail, new_rows])
        cond = rows2c.index_select(0, self.win_off + torch.arange(C, device=pairs.device))
        a2h_model.write_cond_projections(model.WaveNet, cond, mg.dec)
        self.out[:, :out.shape[1]].copy_(out)

    def ensure_graphs(self, front: bool) -> None:
        mg = self.mg
        if not mg.on_card:
            return
        if front and self.front_graph is None:
            self.front_graph = mg.capture(f"stream_front[{self.C}]", self.front)
        if self.motion_graph is None:
            mg.dec.row.zero_()
            self.motion_graph = mg.capture(f"stream_motion[{self.C}]", self.motion)
