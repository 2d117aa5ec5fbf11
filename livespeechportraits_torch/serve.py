"""Serving wrapper of the PyTorch port: a Predictor that loads a subject
once and answers many requests.

Counterpart of ``livespeechportraits_tpu/serve.py``: ``setup()`` loads a
reference-format subject (``<config_dir>/<id>.yaml`` naming its data_root and
checkpoints) or builds the synthetic one, or boots the four models from a
serving artifact,
optionally int8-quantizes the renderer with calibrated static activation
scales, and casts the renderer to its compute dtype once; ``predict()`` caps
the audio, pads it to a length bucket, runs ``animate()`` with any transfer
(yuv420 by default) and the motion half fused, as JAX's serves it
(``fused=True``: pipeline/motion_graph.py, CUDA graphs captured on a
bucket's first request, or every bucket up front by ``prewarm()``), and
muxes a video; ``stream()`` pushes the audio through a
``StreamingAnimator`` and yields the frames as they are determined.
``setup(data_parallel=True)`` splits each predict() render batch over every
visible device (``animate(render_devices=)``, JAX's one-axis mesh); with
one card the split is the identity and the frames are the same bytes.

Bucketing does not change a result: every stage before post-processing is
prefix-causal over the zero-padded audio, the head-pose noise of frame i
depends on (seed, i) alone, and the post stage reflects at the true end
(``animate.compute_motion(valid_frames=)``).  On the CPU the bucketed and
the exact request are bitwise equal; on the card cuBLAS may pick another
algorithm for another row count, so they agree within rounding.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from livespeechportraits_torch.config import PersonConfig, load_person_config
from livespeechportraits_torch.models import feature2face as f2f
from livespeechportraits_torch.parallel import mesh
from livespeechportraits_torch.pipeline import animate as animate_mod
from livespeechportraits_torch.pipeline import assets as assets_mod
from livespeechportraits_torch.pipeline import motion_graph
from livespeechportraits_torch.pipeline import video as video_mod
from livespeechportraits_torch.pipeline.streaming import StreamingAnimator
from livespeechportraits_torch.utils import profiling


@dataclass
class PredictResult:
    video_path: str
    nframe: int
    wall_s: float
    stage_ms: dict
    frames: Optional[np.ndarray] = None  # [nframe, H, W, 3] uint8
    link: Optional[dict] = None  # the transfer's bytes fetched and pack4e refetches
    trace: Optional[profiling.RequestTrace] = None  # the request's spans and counters


class Predictor:
    """Load once, predict many, on one device (the render half on every
    visible one with data_parallel)."""

    def __init__(self, max_audio_seconds: float = 10.0, results_dir: Optional[str] = None,
                 bucket_seconds: float = 1.0, device: str | torch.device = "cuda"):
        """bucket_seconds > 0 pads each request's audio to the next multiple
        of it, so requests of nearby lengths run the same shapes (the
        result is the exact request's); 0 runs every length as it is."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} was asked for but torch sees no CUDA device")
        self.max_audio_seconds = max_audio_seconds
        self.bucket_seconds = bucket_seconds
        self.results_dir = results_dir or tempfile.mkdtemp(prefix="lsp_serve_")
        self._person: Optional[str] = None
        self._cfg: Optional[PersonConfig] = None
        self._assets: Optional[assets_mod.PersonAssets] = None
        self._models: Optional[assets_mod.PersonModels] = None
        self._render_devices: Optional[list] = None

    def setup(self, person_id: str = "Synthetic", config_dir: str = "./config",
              image_size: int = 512, quantize: bool = False, calibrate: bool = True,
              artifact: Optional[str] = None, f2f_ckpt: str = "", a2f_ckpt: str = "",
              a2h_ckpt: str = "", apc_ckpt: str = "", data_parallel: bool = False) -> None:
        """Load the subject and its models once (assets.load_subject): a
        subject whose <config_dir>/<id>.yaml names a data_root is read from
        it, with its checkpoints; 'Synthetic' is fabricated.  image_size sets
        the render size of either.

        quantize=True int8-quantizes the renderer (BN folded into the
        convs); with calibrate, static activation scales are measured in
        the compute dtype on the renderer inputs of a 1 s test tone.
        artifact: a serving-model .npz (the JAX package's format).  If it
        exists the four models load from it and quantize/calibrate are
        ignored; otherwise the models built here are written to it.
        f2f_ckpt, a2f_ckpt, a2h_ckpt, apc_ckpt: the port trainer's
        checkpoint directories (``<checkpoints_dir>/<name>/ckpt``; its
        ``ckpt_best`` is preferred), each replacing its stage
        (assets.load_trained_person_models); the config must describe the
        architecture they were trained at.
        data_parallel=True shards each predict() render batch over every
        visible device of the predictor's type (frames are independent: no
        communication but the gather); stream() stays on one device, being
        latency-bound rather than throughput-bound."""
        ckpts = f2f_ckpt or a2f_ckpt or a2h_ckpt or apc_ckpt
        boot_artifact = bool(artifact) and os.path.exists(artifact)
        if boot_artifact and ckpts:
            # never serve stale artifact weights over a freshly named checkpoint
            raise ValueError(f"artifact {artifact!r} already exists and would shadow the "
                             "*_ckpt weights; delete it or drop the ckpt args")
        cfg_path = os.path.join(config_dir, person_id + ".yaml")
        cfg = (load_person_config(cfg_path, name=person_id) if os.path.exists(cfg_path)
               else PersonConfig(name=person_id))
        # the synthetic subject, or a reference-format one from its data_root
        # (with an existing artifact its checkpoints are not read)
        cfg, person, models = assets_mod.load_subject(cfg, image_size, skip_models=boot_artifact,
                                                      device=self.device)
        if boot_artifact:
            models = assets_mod.load_models_artifact(artifact, cfg, self.device)
        else:
            if ckpts:
                # the port trainer's checkpoints replace their stages before
                # quantization and before the artifact is written
                models = assets_mod.load_trained_person_models(
                    cfg, models, f2f_ckpt=f2f_ckpt, a2f_ckpt=a2f_ckpt, a2h_ckpt=a2h_ckpt,
                    apc_ckpt=apc_ckpt)
            if quantize:
                calib = calib_dtype = None
                if calibrate:
                    tone = video_mod.make_test_tone(1.0)
                    calib = animate_mod.build_render_inputs(cfg, person, models, tone,
                                                            max_frames=16)
                    if cfg.feature2face.precision == "bfloat16":
                        calib_dtype = torch.bfloat16
                models = assets_mod.quantize_person_models(
                    models, calibrate_inputs=calib, calibrate_dtype=calib_dtype)
            if artifact:
                assets_mod.save_models_artifact(models, artifact)
        # cast the renderer once here, not per request
        models.feature2face = f2f.cast_generator(models.feature2face,
                                                 animate_mod.compute_dtype(cfg))
        self._cfg, self._assets, self._models, self._person = cfg, person, models, person_id
        self._render_devices = mesh.make_mesh(self.device) if data_parallel else None
        # the fused motion half's decode buffers, sized for the longest
        # bucket (a request never grows them, so never captures again)
        self._motion().reserve(self.bucket_lengths()[-1] // 2 if self.bucket_seconds > 0
                               else int(self.max_audio_seconds * 60))

    def _motion(self) -> motion_graph.MotionGraphs:
        return motion_graph.for_models(self._cfg, self._assets, self._models)

    def bucket_lengths(self) -> list:
        """The mel lengths (n_mel) of the buckets a request can land in, up
        to max_audio_seconds; empty without bucketing."""
        if self.bucket_seconds <= 0:
            return []
        bucket = int(self.bucket_seconds * 16000)
        cap = int(self.max_audio_seconds * 16000)
        return [2 * int(k * bucket / 16000 * 60) for k in range(1, -(-cap // bucket) + 1)]

    def prewarm(self) -> dict:
        """Capture the fused motion graphs of every bucket on the card, so
        no request pays a capture: {graph name: its nodes, capture and
        instantiate ms, pool bytes, K2 / K3 launches}.  Nothing to capture
        on the CPU or without bucketing."""
        if self._cfg is None:
            raise RuntimeError("call setup() first")
        mg = self._motion()
        if mg.on_card:
            for n_mel in self.bucket_lengths():
                mg.prepare(n_mel)
        return mg.graph_stats()

    def predict(self, driving_audio: str | np.ndarray, seed: int = 0, render_batch: int = 16,
                transfer: str = "yuv420", write_video: bool = True) -> PredictResult:
        """audio (a wav path, or float32 in [-1, 1] at 16 kHz) -> a muxed
        video in results_dir (cleaned per request) and its frames.
        write_video=False skips the mux (video_path '').

        Every call, failed ones too, leaves one trace in
        ``profiling.REQUESTS`` (``PredictResult.trace``): the span
        ``predict`` from entry to return, the counter ``frames_returned``,
        and what the motion half and the renderer record below it."""
        with profiling.request() as trace:
            if self._cfg is None:
                raise RuntimeError("call setup() first")
            shutil.rmtree(self.results_dir, ignore_errors=True)
            os.makedirs(self.results_dir, exist_ok=True)
            if isinstance(driving_audio, str):
                audio = video_mod.load_wav(driving_audio)
                name = os.path.splitext(os.path.basename(driving_audio))[0]
            else:
                audio = np.asarray(driving_audio, np.float32)
                name = "request"
            audio = audio[: int(self.max_audio_seconds * 16000)]

            true_audio = audio
            ff = self._cfg.audio2headpose.frame_future
            true_frames = int(len(true_audio) / 16000 * 60) - ff
            if true_frames <= 0:
                raise ValueError(f"audio too short: {len(true_audio) / 16000:.2f}s yields "
                                 f"{true_frames} frames after the head-pose decoder's {ff}-frame "
                                 f"lookahead; send > {(ff + 1) / 60:.2f}s")
            valid_frames = None
            if self.bucket_seconds > 0:
                bucket = int(self.bucket_seconds * 16000)
                audio = np.pad(audio, (0, -(-len(audio) // bucket) * bucket - len(audio)))
                valid_frames = int(len(true_audio) / 16000 * 60)

            t0 = time.perf_counter()
            # the motion half fused, as JAX's serve.py runs it
            result = animate_mod.animate(self._cfg, self._assets, self._models, audio, seed=seed,
                                         render_batch=render_batch, transfer=transfer,
                                         valid_frames=valid_frames,
                                         render_devices=self._render_devices, fused=True)
            wall = time.perf_counter() - t0
            frames = result.frames[:true_frames]
            out_path = ""
            if write_video:
                out_path = os.path.join(self.results_dir, f"{name}.avi")
                video_mod.write_video(frames, out_path, true_audio)
            trace.count("frames_returned", len(frames))
            return PredictResult(video_path=out_path, nframe=len(frames), wall_s=wall,
                                 stage_ms=result.stage_ms, frames=frames, link=result.link,
                                 trace=trace)

    def stream(self, driving_audio: str | np.ndarray, seed: int = 0, render_batch: int = 8,
               push_samples: int = 1600, pipeline_depth: int = 1, transfer: str = "rgb",
               smooth_latency_cap: Optional[int] = None):
        """Incremental serving: yields [n, H, W, 3] uint8 frame batches as
        they are determined, while the audio is still being consumed.

        Pushes ``push_samples`` (default 100 ms) of audio at a time through a
        StreamingAnimator: the offline pipeline's frames, the first after
        the algorithmic latency (``latency_frames``, or less with
        smooth_latency_cap) rather than after the whole clip renders."""
        if self._cfg is None:
            raise RuntimeError("call setup() first")
        if isinstance(driving_audio, str):
            audio = video_mod.load_wav(driving_audio)
        else:
            audio = np.asarray(driving_audio, np.float32)
        audio = audio[: int(self.max_audio_seconds * 16000)]
        st = StreamingAnimator(self._cfg, self._assets, self._models, seed=seed,
                               render_batch=render_batch, pipeline_depth=pipeline_depth,
                               transfer=transfer, smooth_latency_cap=smooth_latency_cap)
        # a consumer that abandons this generator (a client gone) closes
        # run()'s too, which releases the stream's decode thread
        yield from st.run(audio, push_samples)
