"""Live streaming: push audio chunks in, get video frames out.

Counterpart of ``livespeechportraits_tpu/pipeline/streaming.py``.
``StreamingAnimator.push_audio()`` takes audio of any length and returns
the frames it determines, with the offline pipeline's output (the same
per-step noise, the same smoothing) up to one documented divergence*.
Every sequential stage carries explicit state:

    APC         - the GRU hidden state of each layer (K2 from it, per chunk)
    Audio2Mouth - the LSTM (h, c) of each layer (K3 from it), plus the
                  ``frame_future`` lookahead
    Headpose    - the WaveNet ring buffers and the previous sample; step i's
                  noise is row i of the position-stable draws (ops/gmm.py)
    smoothing   - a delay line of ``radius = int(4 sigma + 0.5)`` frames

so streaming re-chunks the offline stages.  The algorithmic latency is
max(frame_future_mouth + mouth_radius, frame_future_head + head_radius)
frames (``latency_frames``).  Each chunk runs the recurrences on its n
valid rows only (JAX masks a padded chunk with a prefix mask, which is the
same thing), and each render batch's U-Net input is one K1 launch.
Rendered batches go to the host through ``animate.FrameLink`` under any
transfer: a decode thread waits on each batch's copy and decodes it, so a
push returns while its frames are still on their way when
``pipeline_depth`` > 0.

In the steady state (pushes of one chunk) ``push_audio`` tries JAX's two
fused advances first, in JAX's order: ``_advance_stream_fused`` (mel, APC,
LLE, A2F, the downsample and the decode of one chunk: ``stage_ms``'s
``mega_chunks``), then, after a per-stage mel + APC, ``_advance_motion_fused``
(A2F, the downsample and the decode: ``fused_chunks``).  On the card they
replay CUDA graphs of the chunk (pipeline/motion_graph.ChunkGraphs), then
decode the chunk's C head-pose steps (G2: one launch of kernel K5), with
the stream's carried state copied in and out; on the CPU the same
functions run eagerly.  Both run the per-stage path's functions, so the
frames are the same bits; start-up, ragged pushes, catch-up bursts and
flush() run per stage, as in JAX.

*divergence: offline lip de-intersection shifts the outer lips by the mean
overlap over ALL flipped frames of the clip, which is non-causal; streaming
uses each frame's own mean overlap.
"""

from __future__ import annotations

import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from livespeechportraits_torch.config import FPS, MOUTH_INDICES, SAMPLE_RATE, PersonConfig
from livespeechportraits_torch.models import apc as apc_model
from livespeechportraits_torch.models import audio2feature as a2f_model
from livespeechportraits_torch.models import audio2headpose as a2h_model
from livespeechportraits_torch.models import feature2face as f2f_model
from livespeechportraits_torch.ops import (geometry, gmm, manifold, mel, rasterize_cuda,
                                           smoothing)
from livespeechportraits_torch.pipeline import animate, motion_graph
from livespeechportraits_torch.pipeline.assets import PersonAssets, PersonModels

Tensor = torch.Tensor

MEL_STEP, MEL_WIN = mel.MEL_STEP, mel.MEL_WIN


def _mel_sample_end(i: int) -> int:
    """The last raw sample (exclusive) that mel frame i reads."""
    return int(np.floor(i * MEL_STEP)) + MEL_WIN


class _RowBuffer:
    """An append-only stream of rows with a retired prefix (bounded memory
    for unbounded live streams).  Absolute row indices stay valid after
    retirement; only rows >= base are resident."""

    def __init__(self, shape: Tuple[int, ...], device: torch.device | str = "cpu"):
        self.base = 0
        self.buf = torch.zeros((0,) + tuple(shape), device=device)

    def __len__(self) -> int:  # rows ever appended
        return self.base + self.buf.shape[0]

    @property
    def resident(self) -> int:
        return self.buf.shape[0]

    def append(self, rows: Tensor) -> None:
        if rows.shape[0]:
            self.buf = torch.cat([self.buf, rows.to(self.buf.device, torch.float32)])

    def slice(self, a: int, b: int) -> Tensor:
        if a < self.base:
            raise IndexError(f"rows [{a}, {b}) are retired (base={self.base})")
        return self.buf[a - self.base:b - self.base]

    def retire(self, upto: int) -> None:
        """Drop the rows < upto (clamped to what exists)."""
        k = max(0, min(upto, len(self)) - self.base)
        if k:
            self.buf = self.buf[k:]
            self.base += k


class _StreamSmoother:
    """The streaming form of smoothing.gaussian_filter1d (scipy's reflect
    mode): emits output t once the inputs through t + radius exist; the
    left boundary reflects as the offline call does, and flush() reflects
    the right one."""

    def __init__(self, sigma: float, max_radius: Optional[int] = None):
        self.kernel = smoothing._gaussian_kernel(sigma) if sigma > 0 else None
        self.radius = len(self.kernel) // 2 if self.kernel is not None else 0
        if max_radius is not None and self.kernel is not None and self.radius > max_radius:
            # cut the look-ahead half only, and renormalise: the latency
            # falls to max_radius frames for slightly less smoothing right
            # of centre
            k = self.kernel[:self.radius + max_radius + 1]
            self.kernel = (k / k.sum()).astype(np.float32)
            self.future = max_radius
        else:
            self.future = self.radius
        self.buf: List[np.ndarray] = []  # resident rows [base, total)
        self.base = 0
        self.emitted = 0

    @property
    def total(self) -> int:
        """Rows ever pushed."""
        return self.base + len(self.buf)

    def _window(self, t: int) -> np.ndarray:
        if self.kernel is None:
            return self.buf[t - self.base]
        n = self.total
        out = 0.0
        for j, kj in enumerate(self.kernel):
            # the closed form of the repeated reflection (a period-2n
            # triangle), gaussian_filter1d's index map: one reflection is
            # not enough while the radius exceeds the rows that exist
            src = (t + j - self.radius) % (2 * n)
            if src >= n:
                src = 2 * n - src - 1
            out = out + kj * self.buf[src - self.base]
        return out.astype(np.float32)

    def _retire(self) -> None:
        # later windows read rows >= emitted - radius (and so does flush's
        # right reflection): drop everything older
        keep_from = max(self.emitted - self.radius, 0)
        k = keep_from - self.base
        if k > 0:
            del self.buf[:k]
            self.base = keep_from

    def _emit(self, stop: int, shape: Tuple[int, ...]) -> np.ndarray:
        out = [self._window(t) for t in range(self.emitted, max(self.emitted, stop))]
        self.emitted = max(self.emitted, stop)
        self._retire()
        return np.stack(out) if out else np.zeros((0,) + shape, np.float32)

    def push(self, rows: np.ndarray) -> np.ndarray:
        """rows [n, ...] of new raw values -> the newly determined smoothed
        rows (possibly none)."""
        rows = np.asarray(rows, np.float32)
        self.buf.extend(rows)
        return self._emit(self.total - self.future, rows.shape[1:])

    def flush(self, shape: Tuple[int, ...]) -> np.ndarray:
        """The rows still undetermined, with the right boundary reflected."""
        return self._emit(self.total, shape)


def _deintersect_per_frame(pts3d: Tensor) -> Tensor:
    """Causal lip de-intersection: each flipped frame's own mean overlap
    moves its outer lips, where the offline pass uses the clip's mean."""
    dev = pts3d.device
    ui, li, uo, lo = smoothing.lip_rows(dev)
    upper_y = pts3d[:, ui, 1]
    lower_y = pts3d[:, li, 1]
    flip = ((lower_y > upper_y).sum(1) == 3)[:, None]
    diff_half = (lower_y - upper_y) * 0.5
    frame_mean = diff_half.mean(dim=1, keepdim=True)
    zero = torch.zeros((), device=dev, dtype=pts3d.dtype)
    out = pts3d.clone()
    out[:, ui, 1] += torch.where(flip, diff_half, zero)
    out[:, li, 1] += torch.where(flip, -diff_half, zero)
    out[:, uo, 1] += torch.where(flip, frame_mean, zero)
    out[:, lo, 1] += torch.where(flip, -frame_mean, zero)
    return out


class StreamingAnimator:
    """Incremental audio -> frames with the offline pipeline's outputs, on
    the models' device."""

    def __init__(self, cfg: PersonConfig, assets: PersonAssets, models: PersonModels,
                 seed: int = 0, chunk: int = 32, render_batch: int = 4,
                 smooth_latency_cap: Optional[int] = None, pipeline_depth: int = 0,
                 transfer: str = "rgb",
                 headpose_noise: Optional[Tuple[Tensor, Tensor]] = None):
        """chunk: video frames a stage advances by at a time (mel and APC by
        2 * chunk mel rows).

        smooth_latency_cap (frames) cuts the smoothers' look-ahead for a
        lower live latency (the head-pose smoothing alone looks 40 frames
        into the future at the default sigmas); None keeps the offline
        output.

        pipeline_depth > 0: push_audio() renders this push's frames but
        returns those of up to ``pipeline_depth`` pushes ago, so their
        fetch and decode overlap the next pushes' device work; the frames
        are the same, handed back later, and flush() drains.

        transfer: one of animate.TRANSFERS (see animate.FrameLink).

        headpose_noise: (gumbel [n, ncenter], eps [n, ndim]) of the decode's
        first n steps, as animate.compute_motion takes it; drawn per chunk
        from ``seed`` (gmm.draw_noise) when None."""
        animate._check_transfer(transfer)
        self.cfg, self.assets, self.models = cfg, assets, models
        self.seed = seed
        self.chunk = chunk
        self.render_batch = render_batch
        self.pipeline_depth = pipeline_depth
        self.transfer = transfer
        self.noise = headpose_noise
        self.device = dev = animate._device_of(models)

        a2h = cfg.audio2headpose
        self.ff_m = cfg.audio2feature.frame_future
        self.ff_h = a2h.frame_future

        # carried model state, on the device
        H = cfg.apc.hidden_size
        self._apc_h = [torch.zeros(H, device=dev) for _ in models.apc.rnns]
        lh = cfg.audio2feature.lstm_hidden_size
        self._lstm = [(torch.zeros(lh, device=dev), torch.zeros(lh, device=dev))
                      for _ in range(models.audio2feature.LSTM.num_layers)]
        # the head-pose decode's carried state (rings, step, previous
        # sample) and a chunk's rows, primed on the first decode
        self._dec = a2h_model.DecodeBuffers(models.audio2headpose, a2h, chunk, dev)
        self._primed = False
        # the fused steady state's graphs (shared by the subject's streams)
        self._graphs = motion_graph.for_models(cfg, assets, models)

        # stream buffers, each retired as it is consumed so memory stays
        # bounded over an unbounded stream; the model stages' rows stay on
        # the device, the smoothers' on the host
        self._audio = np.zeros(0, np.float32)  # resident samples [audio_base, total)
        self._audio_base = 0
        self._total_samples = 0
        self._mel_done = 0
        self._feats = _RowBuffer((H,), dev)  # 120 Hz projected APC features
        self._a2f_raw = _RowBuffer((cfg.audio2feature.output_dim,))  # before the shift
        self._down_rows = _RowBuffer((a2h.wavenet.cond_channels,), dev)  # A2H conditioning
        self._head_raw = _RowBuffer((a2h.ndim,))  # head-pose samples
        self._decoded = 0

        cap = smooth_latency_cap
        self._mouth_smooth = _StreamSmoother(cfg.audio2feature.smooth_sigma, cap)
        self._rot_smooth = _StreamSmoother(a2h.smooth_sigmas[0], cap)
        self._trans_smooth = _StreamSmoother(a2h.smooth_sigmas[1], cap)
        self._mouth_ready = _RowBuffer((73, 3))
        self._rot_ready = _RowBuffer((3,))
        self._trans_ready = _RowBuffer((3,))
        self._emitted_frames = 0
        self._flushed = False

        size = cfg.feature2face.load_size
        self._net = f2f_model.cast_generator(models.feature2face, animate.compute_dtype(cfg))
        self._cand = animate._cand_stack(assets, size, dev, animate.compute_dtype(cfg))
        self.link = animate.FrameLink(transfer, size, size, render_batch)
        # One decode thread a stream: it waits for each batch's copy to the
        # host and decodes it, so chunk k's decode overlaps chunk k+1's
        # device work; the pushing thread only dispatches and collects futures.
        self._ex_dec = ThreadPoolExecutor(1)
        self._render_inflight: List[Future] = []
        self.stage_ms: Dict[str, float] = {}  # host ms by stage, summed over pushes

    @property
    def latency_frames(self) -> int:
        return max(self.ff_m + self._mouth_smooth.future,
                   self.ff_h + max(self._rot_smooth.future, self._trans_smooth.future))

    # -- stage advancement ------------------------------------------------

    def _advance_mel_apc(self, flush: bool) -> None:
        total_mel = 2 * int(self._total_samples / SAMPLE_RATE * FPS) if flush else None
        while True:
            a = self._mel_done
            b = a + 2 * self.chunk
            if flush:
                b = min(b, total_mel)
                if b <= a:
                    return
            elif _mel_sample_end(b - 1) > self._total_samples:
                return
            start = int(np.floor(a * MEL_STEP))
            end = _mel_sample_end(b - 1)
            span = self._audio[start - self._audio_base:end - self._audio_base]
            if end > self._total_samples:  # the offline frames read zeros past the end
                span = np.concatenate([span, np.zeros(end - self._total_samples, np.float32)])
            mels = mel.mel_frames(torch.as_tensor(span, device=self.device),
                                  mel.frame_starts(a, b) - start)
            feats, self._apc_h = apc_model.encode_chunk(self.models.apc, mels, self._apc_h,
                                                        residual=self.cfg.apc.residual)
            if self.cfg.apc.use_LLE:
                feats = manifold.lle_project(
                    feats, self.assets.tensor("apc_feature_base", self.device),
                    K=self.cfg.apc.Knear, percent=self.cfg.apc.LLE_percent)
            self._feats.append(feats)
            self._mel_done = b
            # nothing before the next mel frame's first sample is read again
            keep_from = int(np.floor(b * MEL_STEP))
            k = keep_from - self._audio_base
            if k > 0:
                self._audio = self._audio[k:]
                self._audio_base = keep_from

    def _advance_a2f(self, flush: bool) -> None:
        """Paired feature rows -> raw A2F outputs; at flush the tail repeats
        the last (even-trimmed) feature row, as the offline
        generate_sequence does."""
        done = len(self._a2f_raw)
        total_rows = len(self._feats)
        avail = total_rows // 2 + (self.ff_m if flush and total_rows else 0)
        while avail - done >= (1 if flush else self.chunk):
            n = min(self.chunk, avail - done)
            lo, hi = 2 * done, 2 * (done + n)
            even_rows = (total_rows // 2) * 2
            real_lo, real_hi = min(lo, even_rows), min(hi, even_rows)
            pairs = self._feats.slice(real_lo, real_hi)
            tile_rows = (hi - lo) - (real_hi - real_lo)
            if tile_rows:
                last = self._feats.slice(even_rows - 1, even_rows)
                pairs = torch.cat([pairs, last.expand(tile_rows, -1)])
            out, self._lstm = a2f_model.apply_chunk(self.models.audio2feature,
                                                    pairs.reshape(n, -1), self._lstm)
            # a GMM head decodes row j with the draws of offline row j
            out = a2f_model.decode(self.cfg.audio2feature, out, seed=self.seed, start=done)
            self._a2f_raw.append(out.cpu())
            done += n
            self._retire_feats()

    def _retire_feats(self) -> None:
        """Feature rows are read by A2F (from 2 * len(_a2f_raw)) and by the
        A2H downsample (from 2 * len(_down_rows)); the flush tail re-reads
        the last row, so the last pair stays."""
        upto = min(2 * len(self._a2f_raw), 2 * len(self._down_rows),
                   max(len(self._feats) - 2, 0))
        self._feats.retire(upto)

    def _step_noise(self, i0: int, n: int) -> Tuple[Tensor, Tensor]:
        """The noise of decode steps i0 .. i0+n-1, on the CPU."""
        a2h = self.cfg.audio2headpose
        if self.noise is not None:
            gumbel, eps = (x[i0:i0 + n] for x in self.noise)
            if gumbel.shape[0] < n:
                raise ValueError(f"headpose_noise covers {self.noise[0].shape[0]} steps; the "
                                 f"stream reached step {i0 + n}")
        else:
            gumbel, eps = gmm.draw_noise(n, a2h.ncenter, a2h.ndim, self.seed, start=i0)
        return gumbel.to("cpu", torch.float32), eps.to("cpu", torch.float32)

    def _advance_a2h(self, flush: bool) -> None:
        T = len(self._feats) // 2
        if T == 0:
            return
        a2h = self.cfg.audio2headpose
        model = self.models.audio2headpose
        total = max(T - self.ff_h, 0)
        if T > len(self._down_rows):  # the downsample MLP is per row: extend it
            lo = len(self._down_rows)
            paired = self._feats.slice(2 * lo, 2 * T).reshape(T - lo, -1)
            self._down_rows.append(a2h_model._audio_downsample(model, paired[None])[0])
            self._retire_feats()

        dec = self._dec
        while total - self._decoded >= (1 if flush else self.chunk):
            n = min(self.chunk, total - self._decoded)
            i0 = self._decoded
            if not self._primed:
                # prime the ring buffers (conditioning rows < 0 clamp to
                # row 0) and this chunk's projections
                rows = self._down_rows.slice(self._down_rows.base, len(self._down_rows))
                a2h_model.prime_decode(model, a2h, rows,
                                       motion_graph.pre_headpose(self.cfg, self.device),
                                       dec, 0, n)
                self._primed = True
            else:
                cond = self._down_rows.slice(i0 + self.ff_h, i0 + n + self.ff_h)
                a2h_model.write_cond_projections(model.WaveNet, cond, dec)
            gumbel, eps = self._step_noise(i0, n)
            dec.gumbel[:n].copy_(gumbel)
            dec.eps[:n].copy_(eps)
            a2h_model.decode_steps(model, a2h, dec, n, float(a2h.sample_sigma_scale))
            self._head_raw.append(dec.samples[:n].cpu())
            self._decoded += n
            self._down_rows.retire(self._decoded + self.ff_h)

    # -- the fused steady state (JAX's _advance_motion_fused and
    # _advance_stream_fused) --------------------------------------------

    def _chunk_graphs(self) -> "motion_graph.ChunkGraphs":
        mg = self._graphs
        mg.reserve(self.chunk)
        ch = mg.chunks.get(self.chunk)
        if ch is None:
            ch = mg.chunks[self.chunk] = motion_graph.ChunkGraphs(mg, self.chunk)
        return ch

    def _run_fused_chunk(self, front: bool, lag: int) -> None:
        """One chunk through the chunk graphs and G2 over C steps, with this
        stream's carried state copied in and out; then the rows into the
        stream's buffers, as the per-stage path appends them."""
        C = self.chunk
        mg = self._graphs
        with mg.lock, mg.on_device():
            mg.check_weights()
            ch = self._chunk_graphs()
            ch.ensure_graphs(front)
            mg.wait_staged()
            if front:
                a = self._mel_done
                start = int(np.floor(a * MEL_STEP))
                end = _mel_sample_end(a + 2 * C - 1)
                span = np.zeros(ch.span, np.float32)
                got = self._audio[start - self._audio_base:end - self._audio_base]
                span[:len(got)] = got
                mg.stage(ch.audio, ch.host.get("audio"), torch.from_numpy(span))
                mg.stage(ch.offsets, ch.host.get("offsets"),
                          torch.from_numpy(mel.frame_starts(a, a + 2 * C) - start))
                ch.apc_h.copy_(torch.stack(self._apc_h))
            else:
                T = len(self._feats) // 2
                ch.feats.copy_(self._feats.slice(2 * len(self._a2f_raw), 2 * T))
            # the un-retired cached rows [decoded + ff_h, lo) are the lag
            # rows the window still needs; they sit below the fresh ones at
            # offset C - lag, and the rows under the offset are never read
            lo = len(self._down_rows)
            if lag:
                ch.old_tail[C - lag:].copy_(self._down_rows.slice(self._decoded + self.ff_h, lo))
            mg.stage(ch.win_off, ch.host.get("win_off"),
                      torch.tensor([C - lag], dtype=torch.int64))
            if ch.a2f_gumbel is not None:
                mg.stage(ch.a2f_gumbel, ch.host.get("a2f_gumbel"),
                          a2f_model.component_gumbel(C, self.cfg.audio2feature.gmm_ncenter,
                                                     self.seed, start=len(self._a2f_raw)))
            mg.stage_noise(*self._step_noise(self._decoded, C))
            mg.mark_staged()
            ch.lstm.copy_(torch.stack([torch.stack(s) for s in self._lstm]))
            mg.dec.load_state(self._dec.state())
            if mg.on_card:
                if front:
                    ch.front_graph.replay()
                ch.motion_graph.replay()
            else:
                if front:
                    ch.front()
                ch.motion()
            mg.g2(C)
            self._dec.load_state(mg.dec.state())
            self._lstm = [(s[0].clone(), s[1].clone()) for s in ch.lstm]
            if front:
                self._apc_h = list(ch.apc_h.clone())
                feats = ch.feats.clone()
            new_rows = ch.new_rows.clone()
            d_out = self.cfg.audio2feature.output_dim
            ch.out[:, d_out:].copy_(mg.dec.samples[:C])
            packed = ch.out.cpu()  # the one fetch of the chunk
        if front:
            # mel bookkeeping (_advance_mel_apc's loop tail)
            self._feats.append(feats)
            self._mel_done += 2 * C
            keep_from = int(np.floor(self._mel_done * MEL_STEP))
            k = keep_from - self._audio_base
            if k > 0:
                self._audio = self._audio[k:]
                self._audio_base = keep_from
        self._a2f_raw.append(packed[:, :d_out])
        self._down_rows.append(new_rows)
        self._head_raw.append(packed[:, d_out:])
        self._decoded += C
        self._down_rows.retire(self._decoded + self.ff_h)
        self._retire_feats()

    def _advance_motion_fused(self) -> bool:
        """The steady-state advance of A2F, the A2H downsample and the A2H
        decode in one go (JAX's _advance_motion_fused, its conditions word
        for word): only when every stage advances by exactly one chunk and
        the decode's conditioning window fits in the last C cached rows and
        the fresh chunk, with the ring buffers already primed; False lets
        push_audio run the per-stage path."""
        C = self.chunk
        T = len(self._feats) // 2
        done = len(self._a2f_raw)
        lo = len(self._down_rows)
        total = T - self.ff_h
        lag = (total - self._decoded) - C  # the decode's trail behind the front
        if (not self._primed or T - done != C or T - lo != C
                or lag < 0 or lag >= C or lo < C):
            return False
        self._run_fused_chunk(False, lag)
        self.stage_ms["fused_chunks"] = self.stage_ms.get("fused_chunks", 0.0) + 1
        return True

    def _advance_stream_fused(self) -> bool:
        """The steady-state advance of the whole motion half (JAX's
        _advance_stream_fused, its conditions word for word): only when the
        pending audio admits exactly one 2*chunk mel block and every stage
        downstream would then advance by exactly one chunk; False
        otherwise."""
        C = self.chunk
        a = self._mel_done
        b = a + 2 * C
        if (_mel_sample_end(b - 1) > self._total_samples
                # 2+ blocks pending: catch up per stage
                or _mel_sample_end(b + 2 * C - 1) <= self._total_samples
                or len(self._feats) % 2):
            return False
        T = len(self._feats) // 2
        done = len(self._a2f_raw)
        lo = len(self._down_rows)
        lag = T - self.ff_h - self._decoded  # the decode's trail after the advance
        if (not self._primed or done != T or lo != T
                or lag < 0 or lag >= C or lo < C):
            return False
        self._run_fused_chunk(True, lag)
        self.stage_ms["mega_chunks"] = self.stage_ms.get("mega_chunks", 0.0) + 1
        return True

    def _advance_post(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Feed new raw predictions to the smoothers -> the newly determined
        (mouth deltas [n, 73, 3], rotation [n, 3], translation [n, 3])."""
        a2h = self.cfg.audio2headpose
        # raw A2F output t + ff_m is the prediction for frame t
        lo = self._mouth_smooth.total
        hi = len(self._a2f_raw) - self.ff_m
        mouth_sm = np.zeros((0, 73, 3), np.float32)
        if hi > lo:
            delta = self._a2f_raw.slice(lo + self.ff_m, hi + self.ff_m).numpy()
            full = np.zeros((hi - lo, 73, 3), np.float32)
            full[:, np.asarray(MOUTH_INDICES)] = delta.reshape(-1, 25, 3)
            mouth_sm = self._mouth_smooth.push(full)
            self._a2f_raw.retire(hi + self.ff_m)

        lo = self._rot_smooth.total
        hi = len(self._head_raw)
        rot_sm = trans_sm = np.zeros((0, 3), np.float32)
        if hi > lo:
            h = self._head_raw.slice(lo, hi)[:, :6].numpy().copy()
            h[:, :3] *= a2h.rot_amp
            h[:, 3:] *= a2h.trans_amp
            rot_sm = self._rot_smooth.push(h[:, :3])
            trans_sm = self._trans_smooth.push(h[:, 3:])
            self._head_raw.retire(hi)
        return mouth_sm, rot_sm, trans_sm

    def _finalize_frames(self, mouth_sm: np.ndarray, rot_sm: np.ndarray,
                         trans_sm: np.ndarray, drain: bool = False) -> np.ndarray:
        """The per-frame tail of the post stage, then the render, of the
        frames all three smoothed streams now cover (rotation and
        translation smooth with other radii, so they become ready at other
        times).  Rendered batches wait in _render_inflight and are collected
        ``pipeline_depth`` pushes later (drain: all of them)."""
        for buf, rows in ((self._mouth_ready, mouth_sm), (self._rot_ready, rot_sm),
                          (self._trans_ready, trans_sm)):
            buf.append(torch.from_numpy(rows))
        n = min(len(self._mouth_ready), len(self._rot_ready),
                len(self._trans_ready)) - self._emitted_frames
        if n > 0:
            self._render(*self._project(n))
        return self._drain_inflight(0 if drain else self.pipeline_depth)

    def _project(self, n: int) -> Tuple[Tensor, Tensor]:
        """Landmarks [n, 73, 2] and shoulders [n, S, 2] of the next n frames
        (motion_graph.post's per-frame part, on the device)."""
        a2f, a2h = self.cfg.audio2feature, self.cfg.audio2headpose
        dev = self.device
        s = self._emitted_frames
        asset = lambda name: self.assets.tensor(name, dev)  # noqa: E731
        mouth = self._mouth_ready.slice(s, s + n).to(dev)
        head = torch.cat([self._rot_ready.slice(s, s + n),
                          self._trans_ready.slice(s, s + n)], dim=1).to(dev)
        self._emitted_frames += n
        for buf in (self._mouth_ready, self._rot_ready, self._trans_ready):
            buf.retire(self._emitted_frames)

        pts = smoothing.mouth_amp(mouth, True, a2f.amp_method, a2f.amp_params)
        pts = _deintersect_per_frame(pts + asset("mean_pts3d"))
        head[:, 3:] += asset("mean_translation")
        head[:, 0] += 180.0  # x-axis convention flip, as motion_graph.post
        _, brow_rows = motion_graph.landmark_rows(dev)
        brow_idx = motion_graph.brow_index(self.assets, s, n, dev)
        final = asset("std_mean_pts3d").expand(n, 73, 3).clone()
        final[:, 46:64] = pts[:, 46:64]
        final[:, brow_rows] = asset("candidate_eye_brow")[brow_idx] + asset("mean_pts3d")[brow_rows]
        K = asset("camera_intrinsic")
        lm2d = geometry.project_landmarks(K, torch.eye(3, device=dev), torch.zeros(3, device=dev),
                                          self.assets.scale, head, final)
        sh2d, _ = geometry.project_shoulders(K, asset("shoulder3D"), head[:, 3:],
                                             asset("ref_trans"), a2h.shoulder_amp)
        return lm2d, animate._shift_shoulders(self.assets, sh2d)

    def _render(self, lm2d: Tensor, sh2d: Tensor) -> None:
        """Dispatch the render of n frames in batches of render_batch (K1's
        render input, the U-Net, the transfer's encoder and the copy to the
        host), then hand their decode to the decode thread."""
        n = lm2d.shape[0]
        size = self.cfg.feature2face.load_size
        B = self.render_batch
        pad_to = -(-n // B) * B
        lm = torch.cat([lm2d, lm2d[-1:].expand(pad_to - n, 73, 2)])
        sh = torch.cat([sh2d, sh2d[-1:].expand(pad_to - n, *sh2d.shape[1:])])
        sent = []
        for s in range(0, pad_to, B):
            inp = rasterize_cuda.render_input(lm[s:s + B], sh[s:s + B], self._cand, (size, size))
            sent.append(self.link.send(f2f_model.apply_generator(self._net, inp)))

        def decode() -> np.ndarray:
            return torch.cat([self.link.receive(x) for x in sent])[:n].numpy()

        self._render_inflight.append(self._ex_dec.submit(decode))

    def _drain_inflight(self, keep: int) -> np.ndarray:
        """Collect all but the newest ``keep`` dispatched renders."""
        size = self.cfg.feature2face.load_size
        ready = []
        while len(self._render_inflight) > keep:
            ready.append(self._render_inflight.pop(0).result())
        if not ready:
            return np.zeros((0, size, size, 3), np.uint8)
        return np.concatenate(ready)

    # -- public API -------------------------------------------------------

    def _timed(self, name: str, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        self.stage_ms[name] = self.stage_ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
        return out

    @torch.no_grad()
    def push_audio(self, samples: np.ndarray) -> np.ndarray:
        """Feed raw 16 kHz samples -> the newly determined frames
        [n, H, W, 3] uint8 (possibly none)."""
        if self._flushed:
            raise RuntimeError("the stream is already flushed or closed")
        samples = np.asarray(samples, np.float32)
        self._audio = np.concatenate([self._audio, samples])
        self._total_samples += len(samples)
        if not self._timed("stream_fused", self._advance_stream_fused):
            self._timed("mel_apc", self._advance_mel_apc, flush=False)
            if not self._timed("motion_fused", self._advance_motion_fused):
                self._timed("a2f", self._advance_a2f, flush=False)
                self._timed("a2h", self._advance_a2h, flush=False)
        mouth_sm, rot_sm, trans_sm = self._timed("post", self._advance_post)
        return self._timed("finalize_render", self._finalize_frames, mouth_sm, rot_sm, trans_sm)

    @torch.no_grad()
    def flush(self) -> np.ndarray:
        """End the stream -> the remaining frames."""
        if self._flushed:
            raise RuntimeError("the stream is already flushed or closed")
        self._flushed = True
        try:
            self._advance_mel_apc(flush=True)
            self._advance_a2f(flush=True)
            self._advance_a2h(flush=True)
            m1, r1, t1 = self._advance_post()
            m2 = self._mouth_smooth.flush((73, 3))
            r2 = self._rot_smooth.flush((3,))
            t2 = self._trans_smooth.flush((3,))
            return self._finalize_frames(np.concatenate([m1, m2]), np.concatenate([r1, r2]),
                                         np.concatenate([t1, t2]), drain=True)
        finally:
            self.close()

    def run(self, audio: np.ndarray, push_samples: int = 1600) -> Iterator[np.ndarray]:
        """Drive the stream over a whole clip as a live caller would: push
        ``push_samples`` (default 100 ms) at a time, yield each non-empty
        batch of frames as it is returned, then flush's; the stream is
        closed when the generator ends or is abandoned."""
        try:
            for lo in range(0, len(audio), push_samples):
                out = self.push_audio(audio[lo:lo + push_samples])
                if len(out):
                    yield out
            out = self.flush()
            if len(out):
                yield out
        finally:
            self.close()

    def close(self) -> None:
        """Release the stream's decode thread.  flush() calls it; a server
        that abandons a stream (a client gone) must call it too.  Idempotent;
        a closed stream refuses pushes."""
        self._flushed = True
        self._ex_dec.shutdown(wait=False)

    def __enter__(self) -> "StreamingAnimator":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
