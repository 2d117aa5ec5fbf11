#!/usr/bin/env python3
"""Drive the PyTorch port (livespeechportraits_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line; any failure raises and exits non-zero:

1. device: the card's name, torch and CUDA versions, nvidia-smi's name and
   power limit.  No CUDA device is a failure; nothing falls back to the CPU.
2. build: nvcc builds the kernels in livespeechportraits_torch/csrc/; then
   ptxas -v of the recurrence kernels, of K1's instances and of K5 (the
   head-pose decode): registers and spills (none allowed).
2b. the kernels and aten ops that three nn_core.conv2d_q8 calls of a
   calibrated (static x_scale) bf16 layer launch: K4 alone, no quantize
   pass.
3. K1: the table entry (rasteriser, the Pallas kernel's function) on 8
   frames at 512^2 against its plain twin on a hand-made edge-case table,
   bitwise; then the render-input entry (landmarks -> the U-Net's bf16 / f32
   NHWC input, one launch) at B = 16 and 8, bitwise against its twin and
   against the sequence it replaced (rasterize_segments, cat, cast), with
   device time by CUDA-graph replay, bound, share and the replaced
   sequence's time (with and without building the table); and a call under
   torch's sync debug mode makes no synchronizing host call.
4. K2 (GRU time loop) at H=512, in=80, T = 64, 360, 1200; 5. K3 (LSTM) at
   H=256, in=512, T = 64, 198, 600.  At each length: the plan
   (recurrent_cuda.device_plan: the cluster kernel), kernel_ms (CUDA events
   around _recurrence on a precomputed xp with nonzero h0 / c0: the kernel
   alone) and us_per_step, the grid kernel's kernel_ms on the same inputs
   (the design before, same run) and, for K3, the other cluster size; each
   against the plain loop (ys, h_T, c_T); then the wrapper (addmm + kernel)
   ms, plain_ms, cuDNN's library_ms and the bounds.  Then each wrapper as
   the stream calls it: chunk after chunk (K2: 64, 64, 31 rows; K3: 32, 32,
   17) from a nonzero state carried from chunk to chunk, at each layer
   input width, against nn_core's plain layer carried the same way.
6. slice: animate() on the full-width synthetic person, 3 s of test tone,
   512^2 bf16 renderer; 165 frames, K1 launched exactly once a batch of 8,
   3 GRU + 3 LSTM launches, all on the cluster plan.  Then one traced run
   of each half (torch.profiler): the device's busy share and each kernel's
   device time per launch at the main path's shapes; in the render half,
   one K1 call a batch with no cat, cast or copy op before the first
   convolution and no cudaStreamSynchronize in the loop; and the render
   half once more under torch's sync debug mode (no synchronizing call).
   K1's and K4's device times come from CUDA-graph replays, K2/K3's
   kernel_ms from CUDA events; ms is the CUDA-event time per wrapper call.
6c. K4 (the int8 3x3 conv with the activation quantize folded in) at seven
   B=16 shapes, against its plain twin: bitwise in the int32 mode and in
   the fused bf16 mode (inputs with exact rounding ties and values past
   +-127), with device time, bound, share of the bound and the bf16 cuDNN
   conv of the same shape as a yardstick; then the 44 convs of one 'normal'
   ResUNet forward at B=16 (serving) and B=8 (the stream's render batch),
   bitwise, device time beside the bound.
6d. serve: the serving path, serve.Predictor(device="cuda") booted with the
   int8 calibrated renderer (writing an artifact) and prewarm() (every
   bucket's fused motion graphs captured), three predict() requests
   with bucketing and the yuv420 transfer; frame counts, every kernel
   launched (K1 once a 16-frame batch, K4 at least 44 a batch; 3 GRU + 3
   LSTM launches inside the replayed motion graph, all on the cluster
   plan), PSNR against the bf16
   float renderer, bucketed against exact, a second Predictor booted from
   the artifact giving the same frames bit for bit, and one traced request
   (K4's device time and launches, the render loop's K1 check as in 6, the
   int8 and the bf16 float renderer's render_device on the same request).
6e. stream: the live path, Predictor.stream as the server's /stream calls
   it (render batch 8, 100 ms pushes, pipeline depth 1) on the int8
   Predictor, 3.0 s of tone, yuv420 then pack4e: the frame count of
   predict(), K1-K4 all launched during the stream (the counts set to 0 just
   before it; K2/K3 on the cluster plan), the frames against predict()'s
   under the same transfer (PSNR >= 30 dB and >= 99 % of the values within
   one level); the wall from the first push to the first batch,
   latency_frames, each push's wall (median, p95, max), frames a second over
   the stream's wall and each kernel's launches a push.
6f. coders: a 2.0 s request under each transfer (rgb, yuv420, jpeg, jpeg4,
   pack4e) against the rgb one (PSNR >= 30 dB), with the bytes fetched a
   frame, the pack4e refetches and the wall; on one rendered 16-frame batch
   at 512^2: each encoder's ms a call (CUDA events, host dispatch included)
   and device ms (CUDA-graph replay), the host decoder's ms a frame, each
   host decoder
   against its numpy twin (within one level on under 0.1 % of the values),
   and the card's encoders against the CPU's on the same frames (the share
   of equal quantized coefficients; the decoded frames within one level).
7. the motion half, one f32 render input (K1 against its twin, bitwise) and
   one f32 frame on the GPU against the CPU, TF32 off.
8. onboard: a subject with no released data, at full width.  8a: two raw
   clips at 512^2 (synth_subject.write_raw_clip: clip1 600 frames with a
   face, clip2 480 without), K1's f32-plane entry once a 32-frame batch (19
   launches), one batch bitwise against the plain twin on the card, its
   device time beside the bound, the first stored frame against the
   stylised edge map.  8b: build_person_pack with the default APC at random
   init (seed 0, bank_stride 1): 3 K2 launches a clip, the 2160-row bank
   within RNN_TOL of a pack built with the plain recurrence on the card,
   every other file equal.  8c: the pack served from its YAML and four
   reference-format .pkl checkpoints (torch.save; the APC one with
   "module." prefixes) by Predictor(device="cuda").setup(quantize=True),
   3.0 s of tone: setup and first-request walls, stage_ms, fps, launches a
   request; its frames against a Predictor of the same seed-0 state dicts
   built in memory (the YAML without checkpoints), within the bucketing
   share.  8d: the same subject with the 'small' U-Net, bf16 (int8
   refused): its render input bitwise against the twin, the render's device
   ms a 16-frame batch beside the 'normal' ResUNet's (bf16 and int8), and
   cuDNN's channel-padding kernels in a traced forward.  8e: the same
   subject with the Audio2Feature GMM head (3 components, int8 renderer):
   the head's pre-decode output, K3 against the plain LSTM, within RNN_TOL.
10. train: the four trainers at full width through trainer.train_* on the
   synthetic samplers, batch 8, each validated every epoch: APC (3 x GRU
   80 -> 512 + head, windows of 480) and Audio2Feature (3 x LSTM 256,
   sequence 240) and Audio2Headpose (WaveNet 7 x 2, time frame 240) two
   epochs each, finite losses and every model moved; Feature2Face ('normal'
   ResUNet, ngf 64, 8 downsamplings, D num_D 2) at 512^2 in bf16 for three
   epochs, each batch's edge maps from one K1 launch (the counts set to 0
   just before: K1 once a step, once a validation batch and once for the
   epoch panel's batch, no other kernel), the step's ms (CUDA events),
   peak memory, L1 on a fixed batch lower after than before; K1 on that batch's landmarks bitwise against its
   plain twin, its device ms beside the bound and its share of a step; one
   more step unprofiled and traced (busy share, top kernels); then a
   Predictor booted from the four checkpoints (ckpt_best preferred) serves a
   3.0 s request.
11. quantization-aware training at full width.  11a: K4's 4x4 taps at the
   six interior conv shapes of the discriminator (512^2, B = 8, f32 in,
   padding 2, strides 2 and 1, outputs 129^2 .. 34^2) against the plain
   twin, bitwise in the fused f32 and int32 modes, device ms beside the
   bound, the plain twin's ms and the bf16 and f32 cuDNN convs as
   yardsticks.  11b: an fq8 conv (64 -> 64 on 256^2, B = 8, bf16 under
   autocast) against the deployed bf16 QConv2d: one K4 launch, bitwise.
   11c: train_feature2face with qat_int8 and qat_d on the synthetic data
   (two epochs of two steps, validated each epoch; the counts set to 0
   just before: K4 112 a step, 88 G + 24 D, 44 a validation batch and 44
   an epoch panel; K1 once a step and a validation batch and once for the
   panel's batch), a --qat run (no K4), then one GAN
   step in each mode (float, qat, qat_int8, qat_int8 + qat_d; qat and
   qat_int8 again with cuDNN's TF32 off, the emulation in full f32) on one batch:
   ms (CUDA events), peak memory, K4 launches a step, and K4's device time
   in a traced qat_int8 + qat_d step; then a Predictor serves the QAT
   checkpoint (int8 renderer), one 3.0 s request.  11d: the real-data path
   (check_real_data): synth_subject clips, build_person_pack, the CLI's
   --task apc / audio2feature / audio2headpose / feature2face with
   --dataroot, prepare_clip's K2 launches (3, then a cache hit), K1 once a
   GAN step and once for the panel's batch, each trainer's step ms, a
   Predictor serving the four checkpoints.
12. the fused GAN step (steps.f2f_fused_step), rematerialisation and the
   chunked VGG loss, then the whole from-scratch subject run.  12a: at a
   reduced width (64^2, f32, TF32 off) the fused step's gradients against
   its two-loss oracle; at full width (512^2, B = 8, bf16 G, f32 D with
   TF32) remat=True and remat=2 against no remat (gradients, running
   stats) and vgg_microbatch=2 against the unchunked VGG loss, each error
   beside its tolerance.  12b: seven modes (the alternating pair, fused,
   fused with remat=True, remat=2, the VGG loss unchunked and in chunks of
   2, --qat_int8 --qat_d), three steps each on one batch whose edge maps K1
   draws each step: median step ms (CUDA events), peak memory, the busy
   share (a traced step's device busy ms over the median), K1 / K4
   launches a step (K4 56 a fused QAT
   step; 100 with remat=True and 64 with remat=2, the recompute's), losses
   finite and L1 falling.  12d: the Audio2Headpose LSTM variant's
   generate_sequence_lstm on K3 against the CPU.  12c: tools/e2e_subject.py
   at 512^2 cut in length (600 + 240 frames, two epochs a motion stage,
   one of the renderer's fused step, 2 s scored): e2e_metrics.json and each
   phase's wall, K1-K3 all launched (the float renderer: no K4).
13. the demo's flags and data parallelism.  13a: the demo CLI as one
   subprocess on the card (demo.main five times, 1.5 s of tone, 512^2,
   'normal', render batch 16): --quantize --artifact --bucket_seconds 2
   --save_intermediates 1 from scratch (writes the artifact) and again
   (reads it: the same landmarks and jpgs), unbucketed from the artifact
   (landmarks within the bucket tolerance), --quantize --no_calibrate
   serving phase 10's four checkpoints from a save_input YAML (the
   feature-map video), and the checkpoints with the existing artifact
   (exits non-zero); the frame counts of the video, the jpgs and
   landmarks.npy, each run's wall and fps and launches (K1 5, K2 3, K3 3,
   K4 220 from the artifact).  13b: Predictor(data_parallel=True) against
   False on a 3.0 s int8 request, bitwise; render_frames over [cuda:0,
   cuda:0] against one device, within one level, K1 once a share,
   render_device ms beside one device's.  13c: --data_parallel on one card
   (a one-rank NCCL group): the fused GAN step at 512^2, B = 8, its losses
   and gradients against no group, the step ms of each (3 steps).  13d, run
   by phase 17's two spawned ranks: two ranks on the card (gloo on CUDA
   tensors), --zero1, the global batch of 8: the
   ranks' parameters equal, ZeRO-1 bitwise against replicated Adam, each
   rank's optimizer bytes about half, K1 once a rank, the reduced gradients
   and losses against one process on the global batch.
14. the measurement slice.  14a: K1's edge-only form (render_input with no
   candidates: [B, 512, 512, 1], one launch) at B = 16 and 8, bf16 and f32,
   bitwise against its twin and channel 0 of the 13-channel form, device ms
   by CUDA-graph replay beside the bound; animate(split_cand=True) against
   False on 1.5 s of tone ('normal' bf16 under rgb and pack4e, the int8
   renderer under yuv420): frames within SPLIT_BOUNDS (PSNR, levels),
   render_device of both, K1 once a batch and K4 44 a batch in the split
   run (the counts set to 0 just before it); the split render loop under
   torch's sync debug mode.  14b-14k: the tools of
   livespeechportraits_torch/tools/ at full width, each row echoed:
   trace_render ('large', ngf 64, 8 downsamplings, 2 residual blocks a
   stage, B = 16, bf16 and int8: int8 >= INT8_PSNR_DB against bf16, 74 K4
   launches a forward, 243-246 GFLOP a frame, the MFU and the device-time
   table by family), int8_probe (the 14 'large' conv shapes, K4 against
   cuDNN's bf16 conv), render_ablate (three variants), trace_train (the
   fused step, 'large', B = 8, 3 steps), stream_latency (2 s, 'large'
   int8, chunk 16; 6e streams chunk 32), prewarm_serving (twice, each in its own
   process: the first writes the artifact, the second reads it), parity
   (the same seed: landmark error 0 and equal frames; another seed: finite
   scores), train512 (4 steps at B = 4, losses finite), link_probe and
   upload_diet.
15. the fused motion half (pipeline/motion_graph.py) on the int8
   Predictor's subject, 3.0 s of tone: G1, G2 (165 decode steps in one K5
   launch) and G3 eagerly under torch's sync debug mode "error"; the
   bucket's capture (G1 and G3; the decode is no graph), each graph's
   nodes, capture and instantiate ms and pool bytes; fused against staged
   on the card (the landmarks and head pose bitwise or within
   FUSED_*_TOL, the first stage that differs named; frames within one
   level); K2 and K3 in a traced G1 replay and, replayed from a graph at
   the request's shapes, against their plain twins (RNN_TOL); K5 on the
   primed decode against decode_step's loop on a copy of the buffers, at
   the request's bucket (165 steps) and the 10 s bucket (585): samples,
   rings and x_prev within DECODE_TOL, row and step equal, K5's device ms
   beside its bound; G1's, the decode's and G3's device ms; the request
   through predict() against the staged request (median of 3, in turns),
   its K2 / K3 launches inside the replay and its one K5 launch (the
   counts set to 0 just before); a 3.0 s stream (chunk 32, 100 ms pushes):
   at least 3 fused chunks, frames against the per-stage stream; a float
   Predictor's boot and prewarm() capturing every bucket to 10 s.
16. the renderer's inference rewrites: ptxas -v of K4's gather kernel
   (registers of its 20 instances, the plain launches' and the rewrite
   forms', no spills); K4's rewrite forms (four-phase subpixel, single,
   dilated, split) at every int8 up conv of 'normal' at 512^2, B = 16,
   bitwise against their plain twins in the int32 and fused bf16 modes,
   device ms by CUDA-graph replay beside the bound and cuDNN's bf16 float
   form; whole 'normal' generators (B = 16, bf16): the float forms against
   the float renderer, the split int8 tree against the unsplit one (the
   pair the float to-RGB up conv reads bitwise), the subpixel, dilated and
   s2d-composed int8 trees against the float frames, split_cand on the
   split tree, each forward's K4 launches; a 3.0 s request served by
   Predictors booted from artifacts of the int8 Predictor's models under
   split-skip and under subpixel "single" (frames, K1 and K4 launches a
   batch, render_device beside the unrewritten one's); the 'large' int8
   renderer unrewritten, split and single (tools/trace_render --rewrites:
   ms a batch, upsample + concat by family, the same FLOPs).
17. the model axis (parallel.mesh's grid, parallel.sharding), two ranks
   spawned on the one card over gloo (NCCL refuses two ranks on one card;
   gloo moves the CUDA tensors through the host).  17a, spatial: the int8
   Predictor's 'normal' renderer at 512^2, B = 16, K1's render input split
   into 256 rows a rank, the bf16 float and the calibrated int8 renderer,
   the int8 split-skip and single trees rewritten from it and the float
   single tree (SPATIAL_TREES; sharding.apply_generator_spatial), each of
   K4's 44 layers' output rows (the rewritten up convs' included) bitwise
   against the one-device forward, the gathered frames within one
   level on >= GRID_FRAME_SHARE of the values, ms a forward a rank beside
   one device's, K1 / K4 launches and the bytes exchanged a forward.  17b,
   channels: the fused GAN step at 512^2 with G and D channel-sharded over
   the two ranks: the float step and the --qat ("fq") step in float64
   (B = 2) against one process at 13d's tolerances; under qat and qat_int8
   the eval frames (f32) within
   one level of one process's, then one step at B = 8 as phase 12 trains
   (bf16 G, f32 D with TF32, Adam): its ms beside one process's, K1 / K4
   launches, the parameter and optimizer bytes a rank, its losses and
   gathered gradients against one process's (reported).  17d: the
   activation scale of --data_parallel --qat_int8 over two data ranks on a
   batch whose halves differ twofold in range: one scale on both ranks, the
   eval frame's rows against one process with it and with a scale per rank
   (the fault), the step's gradients of both.  17c, beside the two ranks:
   parallel.dryrun --ranks 4, its three lines: (2x2) on the card, then
   (4x2) and (4x4) as CPU ranks over gloo (JAX's larger grids), whose
   losses agree within DRYRUN_SAME_ROWS_RTOL (the same rows).  The two
   ranks also run 13d.
9. the kernels' JSON line (each with its bound: the larger of the bytes it
   must move over 3.35 TB/s and its operations over the peak rate of their
   type, and where one PyTorch call computes the same function, that call's
   time, its launches in 6e's yuv420 stream as stream_launches and on the
   onboard path as onboard_launches; K1's onboard_entry is the f32 plane at
   32 x 512^2, its train_launches those of phase 10's Feature2Face run and
   its train_entry the f32 plane at the training batch, 8 x 512^2, its
   real_data_train_launches those of 11d's GAN run; K2's
   real_data_prepare_clip_launches; K4's d_shapes the six discriminator
   shapes of 11a, its train_launches those of 11c's QAT run and its
   gan_step_by_mode each mode's step; phase 12's e2e_launches for each
   kernel, K1's and K4's fused_step_launches by mode, K4's
   fused_qat_remat_launches and K3's a2h_lstm_variant; phase 13's
   demo_launches for each kernel, K1's and K4's render_split_launches and
   K1's dp_rank_step_launches; phase 14's K1 split_cand_entry (the
   edge-only form) and split_cand_launches, K4's large_launches (a 'large'
   forward), large_ms_per_batch and int8_probe; phase 15's
   motion_graph_launches (K2 / K3 inside the fused request's replayed
   graph) and motion_graph_max_abs_err; phase 16's K4 rewrite_forms (per
   form its shapes, device ms, bound, cuDNN yardstick and launches, the
   generators, the requests, 'large'); phase 17's K1 and K4 ``spatial`` and
   ``channel`` entries (launches a rank, ms beside one device's, bytes
   exchanged)), then
   {"ok": true, "device": {...}} as the last line.
"""

from __future__ import annotations

import copy
import dataclasses
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from livespeechportraits_torch.pipeline.assets import REWRITE_FORMS  # noqa: E402
from livespeechportraits_torch.tools import ptxas_report  # noqa: E402
from livespeechportraits_torch.tools._common import graph_ms, launch_counts  # noqa: E402
from livespeechportraits_torch.utils import flops as _flops  # noqa: E402
from livespeechportraits_torch.utils.profiling import busy_ms  # noqa: E402

# Published H100 SXM peaks (NVIDIA's data sheet, dense), for the bounds: the
# port's one table (livespeechportraits_torch/utils/flops.py)
HBM_BYTES_PER_S = _flops.H100_SXM["bytes_per_s"]
PEAK_OPS_PER_S = {k: _flops.H100_SXM[k] for k in ("int8", "bf16", "f32")}

# Stated tolerances (see PERF.md), each about ten times the error measured
# on an H100 80GB HBM3: the recurrences 9.6e-7 at T=1200/600, the landmarks
# 9.2e-5 px, one frame 1.9e-7.
RNN_TOL = 1e-5  # K2/K3 against the plain loop at every length, f32
LANDMARK_TOL_PX = 1e-3  # motion half, GPU against CPU, TF32 off
FRAME_TOL = 1e-5  # one f32 frame before the uint8 cast, GPU against CPU, TF32 off
INT8_PSNR_DB = 30.0  # int8 frames against the bf16 float renderer (the JAX package's gate)
SERVING_PSNR_DB = 30.0  # a lossy transfer's frames against exact ones (the same gate)
# The stream against predict() on the card: the share of frame values within
# one level.  On the CPU the two are equal (tests/test_torch_streaming.py,
# bound: under 1 % of the values differ, by one level); on the card the
# chunks' GEMMs run other row counts, as the bucketed request's do.
STREAM_FRAME_SHARE = 0.99
# Bucketed against the exact request on the card (measured: landmarks
# 3.05e-5 px, every frame value equal, in two calls)
BUCKET_LANDMARK_TOL_PX = 1e-4
BUCKET_FRAME_SHARE = 0.9999  # share of frame values within 1 level


def log(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() over reps launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def trace(fn):
    """Run fn() once under torch.profiler.  Returns (the device-side events,
    host wall ms of the traced call, the host-side events: aten ops, labels
    and CUDA runtime calls)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    events = list(prof.events())
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    host = [e for e in events if e.device_type != torch.autograd.DeviceType.CUDA]
    return device, wall, host


def kernel_device_ms(events, symbol: str):
    """(mean device ms per launch, launches) of the kernels whose name holds
    symbol; (None, 0) when the trace recorded none."""
    times = [e.time_range.elapsed_us() / 1e3 for e in events if symbol in e.name]
    return (sum(times) / len(times) if times else None), len(times)


def top_kernels(events, n: int):
    """The n kernel names with the most device time, as (name[:60], ms)."""
    total = {}
    for e in events:
        total[e.name] = total.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:n]
    return [(name[:60], round(ms, 3)) for name, ms in ranked]


def kernel_device_total(events, symbol: str):
    """(total device ms, kernel count) of the kernels whose name holds symbol."""
    times = [e.time_range.elapsed_us() / 1e3 for e in events if symbol in e.name]
    return sum(times), len(times)


def fmt(ms) -> str:
    return "not_measured" if ms is None else f"{ms:.4f}"


def bound(nbytes: float, ops: float, kind: str):
    """(bound ms, what sets it): the larger of the bytes over the memory
    rate and the operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# Kernel symbols as the profiler names them (demangled).
# K4 is its main kernel plus, for a split K loop, the reduction pass.
SYMBOLS = {"K1": "rasterize_kernel", "K2": "rnn_cluster_kernel<3", "K3": "rnn_cluster_kernel<4",
           "K4": "q8conv_"}

# K4's main-path shapes at B=16 (512^2 'normal' ResUNet): (name, input
# size, Cin, Cout, stride)
K4_CASES = (("outermost residual conv", 256, 64, 64, 1), ("stage-2 down conv", 256, 64, 128, 2),
            ("stage-2 up conv", 256, 256, 64, 1), ("innermost residual conv", 2, 512, 512, 1),
            ("stage-7 residual conv, split-K", 8, 512, 512, 1),
            ("stage-6 residual conv, split-K", 16, 512, 512, 1),
            ("stage-4 up conv", 64, 1024, 256, 1))


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def rnn_weights(gates: int, H: int, I: int, dev, seed: int):
    g = torch.Generator().manual_seed(seed)
    bound = 1 / math.sqrt(H)
    shapes = [(gates * H, I), (gates * H, H), (gates * H,), (gates * H,)]
    return [((torch.rand(s, generator=g) * 2 - 1) * bound).to(dev) for s in shapes]


def recurrence_inputs(gates: int, H: int, T: int, dev, seed: int):
    """xp [T, G*H], w_hh, b_hh and a nonzero h0 (and c0) for _recurrence."""
    g = torch.Generator().manual_seed(seed)
    bound_w = 1 / math.sqrt(H)
    w_hh = ((torch.rand(gates * H, H, generator=g) * 2 - 1) * bound_w).to(dev)
    b_hh = ((torch.rand(gates * H, generator=g) * 2 - 1) * bound_w).to(dev)
    xp = torch.randn(T, gates * H, generator=g).to(dev)
    h0 = (torch.randn(H, generator=g) * 0.5).to(dev)
    c0 = (torch.randn(H, generator=g) * 0.5).to(dev) if gates == 4 else None
    return xp, w_hh, b_hh, h0, c0


def plain_recurrence(gates: int, xp, w_hh, b_hh, h0, c0):
    """nn_core's plain layer on a precomputed xp: W_ih = I and b_ih = 0 make
    the input projection exact (each output is one product by 1)."""
    from livespeechportraits_torch.models import nn_core

    G = xp.shape[1]
    eye, zero = torch.eye(G, device=xp.device), torch.zeros(G, device=xp.device)
    if gates == 3:
        ys, h = nn_core.gru_layer(xp[None], eye, w_hh, zero, b_hh, h0[None])
        return ys[0], h[0], None
    ys, (h, c) = nn_core.lstm_layer(xp[None], eye, w_hh, zero, b_hh, (h0[None], c0[None]))
    return ys[0], h[0], c[0]


def recurrence_error(gates: int, got, ref) -> float:
    """max |kernel - plain| over ys, h_T and (LSTM) c_T."""
    errs = [(got[0] - ref[0]).abs().max().item(), (got[1] - ref[1]).abs().max().item()]
    if gates == 4:
        errs.append((got[2] - ref[2]).abs().max().item())
    return max(errs)


def check_recurrence(name, gates, H, I, lengths, main_T, dev):
    """K2 / K3 at each length: the kernel alone (_recurrence on a precomputed
    xp, nonzero h0 / c0) on its plan and on the grid kernel, each against the
    plain loop; the wrapper (addmm + kernel) against nn_core's plain layer
    and cuDNN's one-layer GRU / LSTM.  Returns the main length's numbers."""
    from livespeechportraits_torch.models import nn_core
    from livespeechportraits_torch.ops import recurrent_cuda as rc

    plain = nn_core.gru_layer if gates == 3 else nn_core.lstm_layer
    kernel = rc.gru_layer if gates == 3 else rc.lstm_layer
    plan = rc.device_plan(gates, H, dev)
    if plan[0] != "cluster":
        raise AssertionError(f"{name}: the main shape H={H} planned {plan}, not the cluster")
    n_sm, smem_optin = rc.device_limits(dev)
    # the grid kernel (the design before), and the other cluster size (one
    # or two units a warp), each measured beside the plan's in the same run
    others = {"grid": ("grid", math.ceil(H / n_sm))}
    for units in (16, 32):
        other = rc.cluster_plan(gates, H, units, smem_optin)
        if other is not None and other != plan:
            others["cluster_c%d" % other[1]] = other
    w = rnn_weights(gates, H, I, dev, seed=gates)
    # The one PyTorch call that computes the same function: a one-layer
    # cuDNN GRU / LSTM with the same weights, f32, TF32 off.
    library = (torch.nn.GRU if gates == 3 else torch.nn.LSTM)(I, H, 1, batch_first=True).to(dev)
    with torch.no_grad():
        for p, t in zip((library.weight_ih_l0, library.weight_hh_l0, library.bias_ih_l0,
                         library.bias_hh_l0), w):
            p.copy_(t)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    G = gates * H
    try:
        for T in lengths:
            # the kernel alone, against the plain loop on the same xp
            args = recurrence_inputs(gates, H, T, dev, seed=1000 + T)
            ref = plain_recurrence(gates, *args)
            err = recurrence_error(gates, rc._recurrence(gates, *args), ref)
            kernel_ms = cuda_ms(lambda: rc._recurrence(gates, *args), reps=20)
            other_ms, other_err = {}, {}
            for key, p in others.items():
                other_err[key] = recurrence_error(gates, rc._recurrence(gates, *args, plan=p), ref)
                other_ms[key] = cuda_ms(lambda: rc._recurrence(gates, *args, plan=p), reps=20)
            # the recurrence's own bound: xp, W_hh, b_hh, h0 read, ys written once
            k_bound, k_by = bound(4 * (T * G + G * H + G + 2 * H + T * H), 2 * T * G * H, "f32")
            # the wrapper, x -> ys: the input projection and the recurrence
            x = torch.randn(1, T, I, generator=torch.Generator().manual_seed(T)).to(dev)
            wref, _ = plain(x, *w)
            ys, _ = kernel(x, *w)
            wrap_err = (ys - wref).abs().max().item()
            ms = cuda_ms(lambda: kernel(x, *w), reps=10)
            plain_ms = cuda_ms(lambda: plain(x, *w), reps=2, warmup=1)
            with torch.no_grad():
                lib_err = (library(x)[0] - wref).abs().max().item()
                lib_ms = cuda_ms(lambda: library(x), reps=10)
            nbytes = 4 * (T * I + G * I + G * H + 2 * G + T * H)
            bound_ms, bound_by = bound(nbytes, 2 * T * G * (I + H), "f32")
            log(name, H=H, input=I, T=T, plan=json.dumps(plan), kernel_ms=f"{kernel_ms:.4f}",
                us_per_step=f"{kernel_ms * 1e3 / T:.3f}", kernel_max_abs_err=f"{err:.3e}",
                **{f"{k}_kernel_ms": f"{v:.4f}" for k, v in other_ms.items()},
                **{f"{k}_us_per_step": f"{v * 1e3 / T:.3f}" for k, v in other_ms.items()},
                **{f"{k}_max_abs_err": f"{v:.3e}" for k, v in other_err.items()},
                kernel_bound_ms=f"{k_bound:.5f}", kernel_bound_by=k_by,
                kernel_share=f"{k_bound / kernel_ms:.4f}", tol=RNN_TOL,
                ms=f"{ms:.4f}", max_abs_err=f"{wrap_err:.3e}", plain_ms=f"{plain_ms:.4f}",
                library_ms=f"{lib_ms:.4f}", library_max_abs_err=f"{lib_err:.3e}",
                bound_ms=f"{bound_ms:.5f}", bound_by=bound_by)
            worst = max(err, wrap_err, *other_err.values())
            if not worst <= RNN_TOL:
                raise AssertionError(f"{name} at T={T}: max abs error {worst} > {RNN_TOL}")
            if T == main_T:
                out = {"max_abs_err": max(err, wrap_err), "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
                       "kernel_ms": kernel_ms, "grid_kernel_ms": other_ms["grid"]}
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return out


def check_carried(name, gates, H, inputs, chunks, dev) -> float:
    """K2 / K3's wrapper as the stream calls it (apc.encode_chunk,
    audio2feature.apply_chunk): a layer run chunk after chunk from a nonzero
    state, each chunk from the state the last returned (gru_layer(h0=),
    lstm_layer(state=)), against nn_core's plain layer chunked and carried
    the same way, f32, at each layer input width of the stream.  One launch
    a chunk.  Returns the max abs error over every chunk's ys and state."""
    from livespeechportraits_torch.models import nn_core
    from livespeechportraits_torch.ops import recurrent_cuda as rc

    count = (lambda: rc.GRU_LAUNCHES) if gates == 3 else (lambda: rc.LSTM_LAUNCHES)
    worst = 0.0
    for I in inputs:
        w = rnn_weights(gates, H, I, dev, seed=10 * gates + I)
        g = torch.Generator().manual_seed(I)
        x = torch.randn(1, sum(chunks), I, generator=g).to(dev)
        start = [(torch.randn(1, H, generator=g) * 0.5).to(dev) for _ in range(gates - 2)]
        got = ref = start[0] if gates == 3 else tuple(start)
        before, s, err = count(), 0, 0.0
        for T in chunks:
            xs = x[:, s:s + T]
            s += T
            if gates == 3:
                ys, got = rc.gru_layer(xs, *w, h0=got)
                ys_ref, ref = nn_core.gru_layer(xs, *w, ref)
                diffs = [ys - ys_ref, got - ref]
            else:
                ys, got = rc.lstm_layer(xs, *w, state=got)
                ys_ref, ref = nn_core.lstm_layer(xs, *w, ref)
                diffs = [ys - ys_ref, got[0] - ref[0], got[1] - ref[1]]
            err = max(err, *(d.abs().max().item() for d in diffs))
        launched = count() - before
        log(f"{name}_carried", H=H, input=I, chunks=json.dumps(list(chunks)),
            launches=launched, max_abs_err=f"{err:.3e}", tol=RNN_TOL)
        if launched != len(chunks):
            raise AssertionError(f"{name} carried: {launched} launches for {len(chunks)} chunks")
        if not err <= RNN_TOL:
            raise AssertionError(f"{name} carried at input {I}: max abs error {err} > {RNN_TOL}")
        worst = max(worst, err)
    return worst


def check_rnn_plans(launches, plans) -> None:
    """The main path's GRU and LSTM launches (counts K2 / K3) all took the
    cluster plan (plans: recurrent_cuda.PLAN_LAUNCHES read with them)."""
    want = {"gru/cluster": launches["K2"], "lstm/cluster": launches["K3"]}
    got = dict(plans)
    if {k: v for k, v in got.items() if v} != want:
        raise AssertionError(f"recurrence launches by plan {got}, want {want} (all cluster)")


def kernel_label(mangled: str):
    """A short name for a kernel instance of K1-K3 and K5 from its mangled
    name, e.g. 'cluster<3,4,2>' or 'rasterize<LandmarkSrc,InputOut<2,13>>'
    (element bytes, channels), 'headpose_decode'; None for others."""
    import re

    if "headpose_decode_kernel" in mangled:
        return "headpose_decode"
    k = re.search(r"rnn_(cluster|grid)_kernelILi(\d)E(?:Li(\d)ELi(\d)E)?", mangled)
    if k:
        return f"{k.group(1)}<{','.join(g for g in k.groups()[1:] if g)}>"
    k = re.search(r"rasterize_kernelI.*?(TableSrc|LandmarkSrc).*?"
                  r"(PlaneOut|InputOutILi(\d)ELi(\d+)E)", mangled)
    if k:
        out = ("PlaneOut" if k.group(2) == "PlaneOut"
               else f"InputOut<{k.group(3)},{k.group(4)}>")
        return f"rasterize<{k.group(1)},{out}>"
    return None


def gather_label(mangled: str):
    """A short name for an instance of K4's gather kernel, e.g.
    'gather<bf16,128,fused>' or 'gather<int8,64,int32,forms>' (the rewrite
    forms' instance); None for others."""
    import re

    k = re.search(r"q8conv_gather_kernelI(\w+?)Li(\d+)ELb(\d)ELb(\d)E", mangled)
    if k is None:
        return None
    tin = {"a": "int8", "f": "f32", "13__nv_bfloat16": "bf16"}.get(k.group(1), k.group(1))
    mode = "fused" if k.group(3) == "1" else "int32"
    return f"gather<{tin},{k.group(2)},{mode}{',forms' if k.group(4) == '1' else ''}>"


def projected(person, n_frames: int):
    """The synthetic subject's projected landmarks [n, 73, 2] and shoulders
    [n, 18, 2] under a few head poses, on the CPU."""
    from livespeechportraits_torch.ops import geometry

    t = torch.arange(n_frames, dtype=torch.float32)
    head = torch.stack([180 + 3 * torch.sin(t), 4 * torch.cos(t), 2 * torch.sin(2 * t),
                        0.01 * t, 0.05 + 0.005 * t, 1.0 + 0.01 * t], dim=1)
    K = torch.tensor(person.camera_intrinsic)
    lm = geometry.project_landmarks(K, torch.eye(3), torch.zeros(3), person.scale, head,
                                    torch.tensor(person.std_mean_pts3d))
    sh, _ = geometry.project_shoulders(K, torch.tensor(person.shoulder3D), head[:, 3:],
                                       torch.tensor(person.ref_trans), 0.5)
    return lm, sh


def segment_table(person, n_frames: int, dev) -> torch.Tensor:
    """The projected face and shoulders' segments, plus hand-made segments:
    block-edge crossings, zero length, off-canvas and negative endpoints,
    and -1e6 padding to 128 rows."""
    from livespeechportraits_torch.ops import rasterize

    table = rasterize.segment_table(*projected(person, n_frames))
    extra = torch.tensor([[31, 5, 33, 300], [0, 255, 511, 256], [200, 200, 200, 200],
                          [-20, -3, -1, -1], [-5, 100, -5, 400], [505, 510, 530, 700]],
                         dtype=torch.float32)
    pad = torch.full((128 - table.shape[1] - extra.shape[0], 4), -1e6)
    rows = torch.cat([extra, pad])[None].expand(n_frames, -1, -1)
    return torch.cat([table, rows], dim=1).contiguous().to(dev)


def render_case(person, n_frames: int, dev):
    """Landmarks and shoulders for K1's render-input entry: the projected
    subject, with points off the canvas, negative (truncated toward zero)
    and fractional in the first and last frames."""
    lm, sh = projected(person, n_frames)
    lm[0, :4] = torch.tensor([[-0.7, 300.2], [-3.4, -0.2], [515.5, 260.0], [250.0, 530.9]])
    lm[-1, 40:42] = torch.tensor([[0.4, -5.9], [511.6, 511.4]])
    sh[-1, :2] = torch.tensor([[-4.2, 509.0], [520.3, 600.0]])
    return lm.contiguous().to(dev), sh.contiguous().to(dev)


def check_render_input(person, dev):
    """K1's render-input entry (landmarks -> the U-Net's NHWC input, one
    launch) at B = 16 and 8, 512^2, bf16 and f32: bitwise against its plain
    twin and against the sequence it replaced (rasterize_segments on the
    table, cat, cast); device time by CUDA-graph replay beside the bound
    and the replaced sequence's.  Returns the kernels-line numbers (B=16,
    bf16, with B=8 beside)."""
    from livespeechportraits_torch.ops import rasterize, rasterize_cuda
    from livespeechportraits_torch.pipeline import animate

    size = (512, 512)
    out = {}
    for B in (16, 8):
        for dtype in (torch.bfloat16, torch.float32):
            lm, sh = render_case(person, B, dev)
            cand = animate._cand_stack(person, 512, dev, dtype)
            cand32 = cand.float()
            table = rasterize.segment_table(lm, sh)

            def replaced(table=table):
                edge = rasterize_cuda.rasterize_segments(table, *size)
                return torch.cat([edge[..., None], cand32.expand(B, *size, 12)], -1).to(dtype)

            def with_table():
                return replaced(rasterize.segment_table(lm, sh))

            def new():
                return rasterize_cuda.render_input(lm, sh, cand, size)

            got, twin, ref = new(), rasterize.render_input(lm, sh, cand, size), replaced()
            torch.cuda.synchronize()
            n_twin, n_ref = int((got != twin).sum()), int((got != ref).sum())
            err = max((got.float() - twin.float()).abs().max().item(),
                      (got.float() - ref.float()).abs().max().item())
            dev_ms, ref_ms = graph_ms(new), graph_ms(replaced)
            ms = cuda_ms(new, reps=50)
            table_ms = cuda_ms(with_table, reps=10)
            plain_ms = cuda_ms(lambda: rasterize.render_input(lm, sh, cand, size), reps=2,
                               warmup=1)
            pairs = rasterize_cuda.segment_pairs(dev, sh.shape[1])
            nbytes = (got.numel() + cand.numel()) * got.element_size() + 4 * (
                lm.numel() + sh.numel() + pairs.numel())
            bound_ms, bound_by = bound(nbytes, 0, "f32")
            log("K1_render_input", frames=B, size="512x512", dtype=str(dtype)[6:],
                segments=pairs.shape[0], lit=int(got[..., 0].float().sum().item()),
                mismatched_twin=n_twin, mismatched_replaced=n_ref, device_ms=f"{dev_ms:.5f}",
                bound_ms=f"{bound_ms:.5f}", bound_by=bound_by, share=f"{bound_ms / dev_ms:.3f}",
                replaced_device_ms=f"{ref_ms:.5f}", speedup=f"{ref_ms / dev_ms:.2f}",
                replaced_with_table_ms=f"{table_ms:.5f}", ms=f"{ms:.5f}",
                plain_ms=f"{plain_ms:.4f}")
            if n_twin or n_ref:
                raise AssertionError(f"K1 render input B={B} {dtype}: {n_twin} values differ "
                                     f"from the twin, {n_ref} from the replaced sequence")
            nums = {"device_ms": dev_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                    "share": bound_ms / dev_ms, "replaced_device_ms": ref_ms,
                    "replaced_with_table_ms": table_ms, "ms": ms, "plain_ms": plain_ms,
                    "max_abs_err": err}
            if dtype == torch.bfloat16 and B == 16:
                out.update(nums)
            elif dtype == torch.bfloat16:
                out["b8"] = nums
    # no host round trip: under torch's sync debug mode a call raises on a
    # synchronizing operation; building the table the old way does raise
    lm, sh = render_case(person, 4, dev)
    cand = animate._cand_stack(person, 512, dev, torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rasterize_cuda.render_input(lm, sh, cand, size)
        try:
            rasterize.segment_table(lm, sh)
            detected = False
        except RuntimeError:
            detected = True
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log("K1_no_sync", render_input_syncs=0, old_table_build_detected=detected)
    if not detected:
        raise AssertionError("the sync debug mode did not see the old table build's copies")
    return out


K1_LABEL = "K1 render_input"


class labelled_k1:
    """Within the block, each rasterize_cuda.render_input call runs under a
    torch.profiler label (K1_LABEL), so a trace shows where each batch's
    input was made on the host."""

    def __enter__(self):
        from livespeechportraits_torch.ops import rasterize_cuda

        self.orig = orig = rasterize_cuda.render_input

        def labelled(*args, **kwargs):
            with torch.profiler.record_function(K1_LABEL):
                return orig(*args, **kwargs)

        rasterize_cuda.render_input = labelled
        return self

    def __exit__(self, *exc):
        from livespeechportraits_torch.ops import rasterize_cuda

        rasterize_cuda.render_input = self.orig


# host ops that would launch a concat or a cast/copy kernel
COPY_OPS = ("aten::cat", "aten::_to_copy", "aten::copy_", "aten::clone")
CONV_OPS = ("aten::conv2d", "aten::convolution")


def check_render_trace(device, host, batches: int, where: str) -> dict:
    """A traced render under labelled_k1: one K1 call a batch, no aten op
    that copies (cat, cast, clone) between each K1 call and the next
    convolution, and no cudaStreamSynchronize from the first K1 call to the
    last.  The device kernels that follow the first K1 kernel are reported."""
    start = lambda e: e.time_range.start  # noqa: E731
    host = sorted(host, key=start)
    k1 = [e for e in host if e.name == K1_LABEL]
    copies, k1_end = [], None
    for e in host:
        if e.name == K1_LABEL:
            k1_end = e.time_range.end
        elif k1_end is not None and start(e) >= k1_end:
            if e.name in CONV_OPS:
                k1_end = None
            elif e.name in COPY_OPS:
                copies.append(e.name)
    window = (start(k1[0]), k1[-1].time_range.end) if k1 else (0, 0)
    syncs = sum(e.name == "cudaStreamSynchronize" and window[0] <= start(e) <= window[1]
                for e in host)
    runtime = sum(e.name.startswith("cuda") for e in host)
    dev = sorted(device, key=start)
    first = next((j for j, e in enumerate(dev) if SYMBOLS["K1"] in e.name), None)
    following = [] if first is None else [e.name[:50] for e in dev[first + 1:first + 4]]
    info = {"k1_calls": len(k1), "copy_ops_between_k1_and_conv": len(copies),
            "stream_syncs_in_render_loop": syncs, "runtime_records": runtime,
            "kernels_after_first_k1": following}
    log(f"{where}_render_trace", **{k: json.dumps(v) for k, v in info.items()})
    if len(k1) != batches or copies or syncs:
        raise AssertionError(f"{where}: the traced render made {len(k1)} K1 calls (want "
                             f"{batches}), copy ops {copies} before a conv, {syncs} stream syncs")
    return info


def k4_bound(B: int, size: int, cin: int, cout: int, stride: int, in_bytes: int,
             out_bytes: int, ksize: int = 3, pad: int = 1):
    """K4's bound at one shape: the input read once, the weights, the output
    written once; 2 * M * Cout * ksize^2 * Cin int8 operations."""
    ho = (size + 2 * pad - ksize) // stride + 1
    m = B * ho * ho
    taps = ksize * ksize
    nbytes = B * size * size * cin * in_bytes + cout * taps * cin + m * cout * out_bytes
    return bound(nbytes, 2 * m * cout * taps * cin, "int8")


def k4_inputs(B: int, size: int, cin: int, cout: int, dev, seed: int, ksize: int = 3,
              dtype=torch.bfloat16):
    """An activation on a 1/8 grid (randn * 12) with r = 4 (s_x = 0.25):
    every odd multiple of 1/8 lands on x * r = k + 0.5, and ~1 % of the
    values land past +-127; int8 weights, a scale and bias of x's dtype."""
    cl = torch.channels_last
    g = torch.Generator().manual_seed(seed)
    x = torch.round(torch.randn(B, cin, size, size, generator=g) * 96) / 8
    x = x.to(dev, dtype).contiguous(memory_format=cl)
    w = torch.randint(-127, 128, (cout, cin, ksize, ksize), generator=g, dtype=torch.int8)
    w = w.to(dev).contiguous(memory_format=cl)
    r = torch.reciprocal(torch.tensor(0.25)).to(dev, dtype)
    scale = (torch.rand(cout, generator=g) * 1e-5).to(dev, dtype)
    bias = torch.randn(cout, generator=g).to(dev, dtype)
    return x, w, r, scale, bias


def check_q8conv(dev):
    """K4 against conv_s8_plain (int32 mode) and conv_q8_plain (fused bf16
    mode), bitwise, at K4_CASES; returns the first case's numbers."""
    from livespeechportraits_torch.ops import q8conv_cuda as q8

    cl = torch.channels_last
    out = {}
    for i, (name, size, cin, cout, stride) in enumerate(K4_CASES):
        x, w, r, scale, bias = k4_inputs(16, size, cin, cout, dev, 100 + i)
        g = torch.Generator().manual_seed(200 + i)
        x_q = torch.randint(-127, 128, (16, cin, size, size), generator=g, dtype=torch.int8)
        x_q = x_q.to(dev).contiguous(memory_format=cl)
        ref = q8.conv_s8_plain(x_q, w, stride)
        got = q8.conv_s8(x_q, w, stride)
        fused = q8.conv_q8(x, r, w, stride, 1, scale, bias)
        fused_ref = q8.conv_q8_plain(x, r, w, stride, 1, scale, bias)
        torch.cuda.synchronize()
        xr = (x.float() * float(r)).abs()
        ties, clamped = float(((xr % 1) == 0.5).float().mean()), float((xr > 127.5).float().mean())
        int_diff = int((got != ref).sum().item())
        bf16_diff = int((fused != fused_ref).sum().item())
        err = (fused.float() - fused_ref.float()).abs().max().item()
        fn = lambda: q8.conv_q8(x, r, w, stride, 1, scale, bias)  # noqa: E731
        ms = cuda_ms(fn, reps=20)
        plain_ms = cuda_ms(lambda: q8.conv_q8_plain(x, r, w, stride, 1, scale, bias), reps=3,
                           warmup=1)
        dev_ms = graph_ms(fn)
        wb = w.to(torch.bfloat16).contiguous(memory_format=cl)
        conv_ms = cuda_ms(lambda: torch.nn.functional.conv2d(x, wb, stride=stride, padding=1),
                          reps=20)
        bound_ms, bound_by = k4_bound(16, size, cin, cout, stride, 2, 2)
        ops = 2 * ref.numel() * cin * 9
        log("K4", case=repr(name), input=f"16x{cin}x{size}x{size}", cout=cout, stride=stride,
            kernel="halo" if q8.uses_halo(size, size, stride, 1) else "gather",
            split_k=q8.split_k(ref.numel() // cout, cout, cin,
                               q8.uses_halo(size, size, stride, 1))[1],
            int32_mismatched=int_diff, bf16_mismatched=bf16_diff, ties=f"{ties:.3f}",
            past_127=f"{clamped:.4f}", max_abs_acc=int(ref.abs().max()), ms=f"{ms:.4f}",
            device_ms=fmt(dev_ms), bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
            share=f"{bound_ms / dev_ms:.3f}", tops=f"{ops / dev_ms / 1e9:.1f}",
            plain_ms=f"{plain_ms:.4f}", bf16_conv_ms_cudnn_other_function=f"{conv_ms:.4f}")
        if int_diff or bf16_diff:
            raise AssertionError(f"K4 {name}: {int_diff} int32 and {bf16_diff} bf16 values "
                                 "differ from the plain twin")
        if i == 0:
            out = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "library_ms": None}
    return out


def check_k4_forward(dev, B: int):
    """K4 at each of the 44 int8 conv shapes of one 'normal' 512^2 ResUNet
    forward at batch B (each distinct shape once): fused bf16 bitwise
    against the twin, device ms beside the bound; the sums per forward."""
    from livespeechportraits_torch.config import Feature2FaceConfig
    from livespeechportraits_torch.models import feature2face as f2f
    from livespeechportraits_torch.ops import q8conv_cuda as q8

    shapes = f2f.int8_conv_shapes(Feature2FaceConfig())
    total_ms = total_bound = 0.0
    for j, shape in enumerate(dict.fromkeys(shapes)):
        size, cin, cout, stride = shape
        n = shapes.count(shape)
        x, w, r, scale, bias = k4_inputs(B, size, cin, cout, dev, 300 + j)
        got = q8.conv_q8(x, r, w, stride, 1, scale, bias)
        diff = int((got != q8.conv_q8_plain(x, r, w, stride, 1, scale, bias)).sum().item())
        dev_ms = graph_ms(lambda: q8.conv_q8(x, r, w, stride, 1, scale, bias))
        bound_ms, bound_by = k4_bound(B, size, cin, cout, stride, 2, 2)
        total_ms += n * dev_ms
        total_bound += n * bound_ms
        log("K4_forward", B=B, shape=f"{size}^2:{cin}->{cout}/s{stride}", convs=n,
            kernel="halo" if q8.uses_halo(size, size, stride, 1) else "gather",
            bf16_mismatched=diff, device_ms=f"{dev_ms:.4f}", bound_ms=f"{bound_ms:.4f}",
            bound_by=bound_by, share=f"{bound_ms / dev_ms:.3f}")
        if diff:
            raise AssertionError(f"K4 at B={B}, {shape}: {diff} values differ from the "
                                 "plain twin")
    log("K4_forward_total", B=B, convs=len(shapes), device_ms=f"{total_ms:.4f}",
        bound_ms=f"{total_bound:.4f}", share=f"{total_bound / total_ms:.3f}")


def check_conv2d_q8_launches(dev):
    """Three nn_core.conv2d_q8 calls of a calibrated (static x_scale) bf16
    layer: K4 launched once a call (its counter), no aten op but
    aten::empty on the host (no quantize pass), and, from the trace's
    device records, the kernels: K4 and at most the two small kernels of
    the scale product a call.  A trace whose device records the profiler
    dropped is taken again, up to three times."""
    from torch.profiler import ProfilerActivity, profile

    from livespeechportraits_torch.models import nn_core
    from livespeechportraits_torch.ops import q8conv_cuda

    g = torch.Generator().manual_seed(7)
    w_q, w_scale = nn_core.quantize_weight_int8(torch.randn(64, 64, 3, 3, generator=g) * 0.05)
    layer = nn_core.QConv2d(w_q, w_scale, 1, 1, b=torch.zeros(64),
                            x_scale=torch.tensor(4.0 / 127)).to(dev, torch.bfloat16)
    layer.w_q = layer.w_q.contiguous(memory_format=torch.channels_last)
    x = torch.randn(16, 64, 256, 256, generator=g).to(dev, torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    nn_core.conv2d_q8(x, layer, 1, 1)  # the first call computes the static (r, scale)
    calls = 3
    for attempt in range(3):
        torch.cuda.synchronize()
        before = q8conv_cuda.LAUNCHES
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                nn_core.conv2d_q8(x, layer, 1, 1)
            torch.cuda.synchronize()
        launches = q8conv_cuda.LAUNCHES - before
        events = list(prof.events())
        names = [e.name for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    aten = sorted({e.name for e in events if e.name.startswith("aten::")})
    k4 = sum(SYMBOLS["K4"] in nm for nm in names)
    others = [nm for nm in names if SYMBOLS["K4"] not in nm]
    log("K4_layer_launches", calls=calls, k4_launches=launches, device_records=len(names),
        traces=attempt + 1, k4_kernels=k4, other_kernels=len(others),
        kernels=json.dumps(sorted({nm[:60] for nm in names})), aten_ops=json.dumps(aten))
    if launches != calls or set(aten) - {"aten::empty"}:
        raise AssertionError(f"{calls} conv2d_q8 calls: {launches} K4 launches, ops {aten}")
    if names and (k4 != calls or len(others) > 2 * calls):
        raise AssertionError(f"{calls} conv2d_q8 calls with a static scale launched {names}")


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else float(10 * np.log10(255.0 ** 2 / mse))


def chirp(seconds: float) -> np.ndarray:
    n = int(seconds * 16000)
    f = 120 + 400 * np.linspace(0, seconds, n)
    return (0.3 * np.sin(2 * np.pi * f * np.arange(n) / 16000)).astype(np.float32)


def check_serve(dev, tmp: str):
    """The serving path on the card; returns (K4's launches over its
    requests, the int8 Predictor).  Raises on any failed check."""
    from livespeechportraits_torch import serve
    from livespeechportraits_torch.models.nn_core import QConv2d
    from livespeechportraits_torch.ops import gmm, q8conv_cuda, recurrent_cuda
    from livespeechportraits_torch.pipeline import animate, video

    ff = 15
    requests = (("tone 3.0 s", video.make_test_tone(3.0)), ("chirp 1.7 s", chirp(1.7)),
                ("tone 2.5 s", video.make_test_tone(2.5)))
    art = os.path.join(tmp, "serving_int8.npz")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pq = serve.Predictor(device=dev, results_dir=os.path.join(tmp, "q"))
    pq.setup("Synthetic", image_size=512, quantize=True, calibrate=True, artifact=art)
    torch.cuda.synchronize()
    boot_q = time.perf_counter() - t0
    t0 = time.perf_counter()
    pf = serve.Predictor(device=dev, results_dir=os.path.join(tmp, "f"))
    pf.setup("Synthetic", image_size=512)
    torch.cuda.synchronize()
    boot_f = time.perf_counter() - t0
    n_q8 = sum(isinstance(m, QConv2d) for m in pq._models.feature2face.modules())
    if n_q8 != 44:
        raise AssertionError(f"serve: {n_q8} int8 convs in the 'normal' ResUNet, want 44")
    # the fused motion half's graphs of every bucket, as a deployment
    # prewarms them (tools/prewarm_serving.py): each request then replays
    t0 = time.perf_counter()
    graphs = pq.prewarm()
    pf.prewarm()
    torch.cuda.synchronize()
    log("serve_boot", int8_calibrate_and_save_s=f"{boot_q:.3f}", float_s=f"{boot_f:.3f}",
        artifact_mb=f"{os.path.getsize(art) / 2**20:.1f}", int8_convs=n_q8,
        prewarm_both_s=f"{time.perf_counter() - t0:.3f}", motion_graphs=len(graphs))
    pq.predict(requests[0][1][:16000], write_video=False)  # warm
    pf.predict(requests[0][1][:16000], write_video=False)

    k4_launches = 0
    int8_frames = {}
    for name, audio in requests:
        zero_launch_counts()
        torch.cuda.synchronize()
        res = pq.predict(audio, write_video=False)
        torch.cuda.synchronize()
        launches = launch_counts()  # K2 / K3: inside the replayed motion graph
        plans = dict(recurrent_cuda.PLAN_LAUNCHES)
        n = res.nframe
        want = int(len(audio) / 16000 * 60) - ff
        f = res.frames
        ref = pf.predict(audio, write_video=False)
        db = psnr(f, ref.frames)
        log("serve_request", audio=repr(name), nframe=n, wall_s=f"{res.wall_s:.4f}",
            fps=f"{n / res.wall_s:.2f}", launches=json.dumps(launches),
            rnn_plans=json.dumps(plans),
            psnr_vs_bf16_db=f"{db:.2f}", bf16_wall_s=f"{ref.wall_s:.4f}",
            bf16_render_device_ms=f"{ref.stage_ms['render_device']:.3f}",
            stage_ms=json.dumps({k: round(v, 3) for k, v in res.stage_ms.items()}))
        if n != want or f.shape != (want, 512, 512, 3) or f.dtype != np.uint8:
            raise AssertionError(f"serve {name}: {n} frames {f.shape} {f.dtype}, want {want}")
        if f.min() == f.max():
            raise AssertionError(f"serve {name}: the frames are constant")
        if launches["K4"] < n_q8 * math.ceil(n / 16) or min(launches.values()) == 0:
            raise AssertionError(f"serve {name}: launches {launches}")
        if launches["K1"] != math.ceil(n / 16):
            raise AssertionError(f"serve {name}: {launches['K1']} K1 launches for {n} "
                                 f"frames in batches of 16")
        if launches["K2"] != 3 or launches["K3"] != 3:
            raise AssertionError(f"serve {name}: {launches['K2']} GRU and {launches['K3']} "
                                 "LSTM launches, want 3 + 3")
        check_rnn_plans(launches, plans)
        if not db >= INT8_PSNR_DB:
            raise AssertionError(f"serve {name}: int8 PSNR {db:.2f} dB < {INT8_PSNR_DB}")
        k4_launches += launches["K4"]
        int8_frames[name] = f

    # bucketed against exact (the chirp), through animate as predict calls it
    audio = requests[1][1]
    valid = int(len(audio) / 16000 * 60)
    padded = np.pad(audio, (0, 2 * 16000 - len(audio)))
    args = (pq._cfg, pq._assets, pq._models)
    exact = animate.animate(*args, audio, seed=0, render_batch=16, transfer="yuv420",
                            profile=True)
    bucketed = animate.animate(*args, padded, seed=0, render_batch=16, transfer="yuv420",
                               valid_frames=valid, profile=True)
    lm_err = float(np.abs(bucketed.landmarks - exact.landmarks).max())
    d = np.abs(bucketed.frames.astype(int) - exact.frames.astype(int))
    within = float((d <= 1).mean())
    t0 = time.perf_counter()
    gmm.draw_noise(valid + 60, 1, 12, 0)
    noise_ms = (time.perf_counter() - t0) * 1e3
    log("serve_bucket", landmark_max_px=f"{lm_err:.3e}", tol_px=BUCKET_LANDMARK_TOL_PX,
        frame_max_levels=int(d.max()), frames_within_1=f"{within:.6f}",
        frames_equal=f"{float((d == 0).mean()):.6f}", share_tol=BUCKET_FRAME_SHARE,
        headpose_ms_padded=f"{bucketed.stage_ms['headpose']:.3f}",
        headpose_ms_exact=f"{exact.stage_ms['headpose']:.3f}",
        draw_noise_ms=f"{noise_ms:.3f}",
        stage_ms_bucketed=json.dumps({k: round(v, 3) for k, v in bucketed.stage_ms.items()}))
    if not (bucketed.nframe == exact.nframe and lm_err <= BUCKET_LANDMARK_TOL_PX
            and within >= BUCKET_FRAME_SHARE):
        raise AssertionError("serve: the bucketed chirp differs from the exact request")

    # a second Predictor booted from the artifact
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pa = serve.Predictor(device=dev, results_dir=os.path.join(tmp, "a"))
    pa.setup("Synthetic", image_size=512, artifact=art)
    torch.cuda.synchronize()
    boot_a = time.perf_counter() - t0
    same = all(np.array_equal(pa.predict(a, write_video=False).frames, int8_frames[nm])
               for nm, a in requests)
    log("serve_artifact_boot", boot_s=f"{boot_a:.3f}", frames_bitwise=same)
    if not same:
        raise AssertionError("serve: the artifact-booted Predictor gave other frames")

    # one traced request: device busy share and the kernels' device time,
    # and the int8 and bf16 float renderers' render_device on the request
    audio = requests[0][1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = pq.predict(audio, write_video=False)
    wall = (time.perf_counter() - t0) * 1e3
    ref = pf.predict(audio, write_video=False)
    q8conv_cuda.LAUNCHES = 0
    with labelled_k1():
        events, traced_wall, host = trace(lambda: pq.predict(audio, write_video=False))
    check_render_trace(events, host, math.ceil(res.nframe / 16), "serve")
    busy = busy_ms(events)
    per_kernel = {k: kernel_device_ms(events, sym) for k, sym in SYMBOLS.items()}
    k4_ms, k4_kernels = kernel_device_total(events, SYMBOLS["K4"])
    log("profile_serve", wall_ms=f"{wall:.3f}", traced_wall_ms=f"{traced_wall:.3f}",
        device_busy_ms=f"{busy:.3f}", busy_share=f"{busy / wall:.4f}",
        k4_device_ms=f"{k4_ms:.3f}", k4_launches=q8conv_cuda.LAUNCHES,
        k4_device_kernels=k4_kernels,
        int8_render_device_ms=f"{res.stage_ms['render_device']:.3f}",
        bf16_render_device_ms=f"{ref.stage_ms['render_device']:.3f}",
        kernels=json.dumps({k: {"device_ms_per_kernel": v[0], "kernels": v[1],
                                "device_ms_total": None if v[0] is None else v[0] * v[1]}
                            for k, v in per_kernel.items() if v[1]}),
        top=json.dumps(top_kernels(events, 8)))
    return k4_launches, pq


def zero_launch_counts() -> None:
    from livespeechportraits_torch.ops import (decode_cuda, q8conv_cuda, rasterize_cuda,
                                               recurrent_cuda)
    from livespeechportraits_torch.pipeline import motion_graph

    rasterize_cuda.LAUNCHES = recurrent_cuda.GRU_LAUNCHES = recurrent_cuda.LSTM_LAUNCHES = 0
    q8conv_cuda.LAUNCHES = decode_cuda.LAUNCHES = 0
    recurrent_cuda.PLAN_LAUNCHES.clear()
    motion_graph.REPLAYED_LAUNCHES.clear()


def check_stream(pq, dev) -> dict:
    """The live path on the card: Predictor.stream as /stream calls it, on
    the int8 Predictor, yuv420 then pack4e.  Returns the kernels' launches
    of the yuv420 stream.  Raises on any failed check."""
    from livespeechportraits_torch import serve
    from livespeechportraits_torch.ops import recurrent_cuda
    from livespeechportraits_torch.pipeline import streaming, video

    pushes, flushes, animators = [], [], []

    class TimedAnimator(streaming.StreamingAnimator):
        """The host wall of each push and of the flush, for the log."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            animators.append(self)

        def push_audio(self, samples):
            t0 = time.perf_counter()
            out = super().push_audio(samples)
            pushes.append((t0, time.perf_counter()))
            return out

        def flush(self):
            t0 = time.perf_counter()
            out = super().flush()
            flushes.append((time.perf_counter() - t0) * 1e3)
            return out

    audio = video.make_test_tone(3.0)
    kw = dict(render_batch=8, push_samples=1600, pipeline_depth=1)
    serve.StreamingAnimator = TimedAnimator
    try:
        for _ in pq.stream(audio[:16000], transfer="yuv420", **kw):  # warm
            pass
        stream_launches = None
        for transfer in ("yuv420", "pack4e"):
            ref = pq.predict(audio, transfer=transfer, write_video=False)
            pushes.clear()
            flushes.clear()
            animators.clear()
            zero_launch_counts()
            torch.cuda.synchronize()
            batches, first_at = [], None
            for batch in pq.stream(audio, transfer=transfer, **kw):
                if first_at is None:
                    first_at = time.perf_counter()
                batches.append(batch)
            end = time.perf_counter()
            launches = launch_counts()
            plans = dict(recurrent_cuda.PLAN_LAUNCHES)
            st = animators[0]
            frames = np.concatenate(batches)
            walls = np.array([(b - a) * 1e3 for a, b in pushes])
            start = pushes[0][0]
            d = np.abs(frames.astype(int) - ref.frames.astype(int)) if (
                frames.shape == ref.frames.shape) else None
            within = None if d is None else float((d <= 1).mean())
            db = psnr(frames, ref.frames) if d is not None else float("nan")
            log("stream", transfer=transfer, audio_s=3.0, nframe=len(frames),
                predict_nframe=ref.nframe, batches=len(batches),
                first_batch_after_ms=f"{(first_at - start) * 1e3:.3f}",
                latency_frames=st.latency_frames,
                latency_ms=f"{st.latency_frames / 60 * 1e3:.1f}", pushes=len(walls),
                push_ms_median=f"{np.median(walls):.3f}",
                push_ms_p95=f"{np.percentile(walls, 95):.3f}",
                push_ms_max=f"{walls.max():.3f}", flush_ms=f"{flushes[0]:.3f}",
                stream_wall_s=f"{end - start:.4f}", fps=f"{len(frames) / (end - start):.2f}",
                predict_wall_s=f"{ref.wall_s:.4f}",
                launches=json.dumps(launches), rnn_plans=json.dumps(plans),
                launches_per_push=json.dumps({k: round(v / len(walls), 3)
                                              for k, v in launches.items()}),
                vs_predict_psnr_db=f"{db:.2f}",
                vs_predict_max_levels=None if d is None else int(d.max()),
                vs_predict_within_1=within, share_tol=STREAM_FRAME_SHARE,
                link=json.dumps(st.link.stats()),
                stage_ms=json.dumps({k: round(v, 3) for k, v in st.stage_ms.items()}))
            if len(frames) != ref.nframe or frames.shape[1:] != ref.frames.shape[1:]:
                raise AssertionError(f"stream {transfer}: {frames.shape} frames, predict gave "
                                     f"{ref.nframe}")
            if min(launches.values()) == 0:
                raise AssertionError(f"stream {transfer}: a kernel did not launch: {launches}")
            check_rnn_plans(launches, plans)
            if not (db >= SERVING_PSNR_DB and within >= STREAM_FRAME_SHARE):
                raise AssertionError(f"stream {transfer}: {db:.2f} dB, {within} of the values "
                                     "within one level of predict()'s")
            if stream_launches is None:
                stream_launches = launches
    finally:
        serve.StreamingAnimator = streaming.StreamingAnimator
    return stream_launches


def check_coders(pq, dev) -> None:
    """The frame coders on the card: a 2.0 s request under each transfer
    against the rgb one, the encoders' device time and the host decoders'
    time on one rendered 16-frame batch, each decoder against its numpy
    twin, and the card's encoders against the CPU's on the same
    frames.  Raises on any failed check."""
    from livespeechportraits_torch.models import feature2face as f2f
    from livespeechportraits_torch.pipeline import animate, compress, video

    H = W = pq._cfg.feature2face.load_size
    audio = video.make_test_tone(2.0)
    for transfer in animate.TRANSFERS:  # warm (the coders' constants reach the card)
        pq.predict(audio[:16000], transfer=transfer, write_video=False)
    res, launches = {}, {}
    for transfer in animate.TRANSFERS:
        zero_launch_counts()
        torch.cuda.synchronize()
        res[transfer] = pq.predict(audio, transfer=transfer, write_video=False)
        launches[transfer] = launch_counts()
    rgb = res["rgb"].frames
    for transfer, r in res.items():
        rendered = -(-r.nframe // 16) * 16
        db = psnr(r.frames, rgb)
        log("coders_request", transfer=transfer, nframe=r.nframe, wall_s=f"{r.wall_s:.4f}",
            wall_vs_yuv420=f"{r.wall_s / res['yuv420'].wall_s:.3f}",
            bytes_per_frame=f"{r.link['fetch_bytes'] / rendered:.1f}",
            fetch_bytes=r.link["fetch_bytes"], p4e_refetches=r.link["p4e_refetches"],
            psnr_vs_rgb_db=f"{db:.2f}", launches=json.dumps(launches[transfer]),
            render_device_ms=f"{r.stage_ms['render_device']:.3f}",
            render_ms=f"{r.stage_ms['render']:.3f}")
        if r.nframe != res["rgb"].nframe or min(launches[transfer].values()) == 0:
            raise AssertionError(f"coders {transfer}: {r.nframe} frames, {launches[transfer]}")
        if not db >= SERVING_PSNR_DB:
            raise AssertionError(f"coders {transfer}: {db:.2f} dB against rgb")

    # one rendered 16-frame batch at 512^2 of the request's landmarks
    cfg, person, models = pq._cfg, pq._assets, pq._models
    lm, sh, _, _, _ = animate.compute_motion(cfg, person, models, audio)
    cand = animate._cand_stack(person, H, dev, animate.compute_dtype(cfg))
    with torch.no_grad():
        img = f2f.apply_generator(models.feature2face, animate.rasterize_cuda.render_input(
            lm[:16], animate._shift_shoulders(person, sh[:16]), cand, (H, W)))
    img_cpu = img.cpu()
    coders = {
        "rgb": (f2f.to_uint8, lambda c: c),
        "yuv420": (animate.rgb_to_yuv420_packed, lambda c: compress.i420_to_rgb(
            torch.from_numpy(c), H, W).numpy()),
        "jpeg": (compress.encode_rgb_frames, lambda c: compress.decode_to_rgb(c, H, W)),
        "jpeg4": (compress.encode_rgb_frames_p4, lambda c: compress.decode_to_rgb_p4(c, H, W)),
        "pack4e": (lambda x: compress.encode_rgb_frames_p4e(x)[0],
                   lambda c: compress.decode_to_rgb_p4e(c, 16, H, W)),
    }
    twins = {"yuv420": lambda c: compress.yuv420_to_rgb(*compress.yuv420_unpack(c, H, W)),
             "jpeg": lambda c: compress.yuv420_to_rgb(*compress.decode_to_yuv(c, H, W)),
             "jpeg4": lambda c: compress.yuv420_to_rgb(*compress.decode_to_yuv_p4(c, H, W)),
             "pack4e": lambda c: compress.decode_to_rgb_p4e_np(c, 16, H, W)}
    with torch.no_grad():
        for name, (encode, decode) in coders.items():
            enc_ms = cuda_ms(lambda: encode(img), reps=10)
            enc_graph_ms = graph_ms(lambda: encode(img), calls=2, replays=3)
            gpu_code = encode(img).cpu().numpy()
            cpu_code = encode(img_cpu).numpy()
            if name == "pack4e":  # the coded prefix; the rest of the cap is zero
                _, n_gpu = compress.decode_to_rgb_p4e(gpu_code, 16, H, W, return_consumed=True)
                _, n_cpu = compress.decode_to_rgb_p4e(cpu_code, 16, H, W, return_consumed=True)
                gpu_code, cpu_code = gpu_code[:n_gpu], cpu_code[:n_cpu]
            t0 = time.perf_counter()
            for _ in range(3):
                out = decode(gpu_code)
            dec_ms = (time.perf_counter() - t0) * 1e3 / 3 / 16
            d_cpu = np.abs(out.astype(int) - decode(cpu_code).astype(int))
            twin = None
            if name in twins:
                dt = np.abs(out.astype(int) - twins[name](gpu_code).astype(int))
                twin = (int(dt.max()), float((dt > 0).mean()))
            coef_equal = None
            if name in ("jpeg", "jpeg4", "pack4e"):
                k_y, k_c = ((compress.DEFAULT_K_Y, compress.DEFAULT_K_C) if name == "jpeg"
                            else (compress.DEFAULT_P4_K_Y, compress.DEFAULT_P4_K_C))
                same = total = 0
                for pg, pc, base, k in zip(compress.rgb_to_yuv_planes(img),
                                           compress.rgb_to_yuv_planes(img_cpu),
                                           (compress._Q_LUMA, compress._Q_CHROMA,
                                            compress._Q_CHROMA), (k_y, k_c, k_c)):
                    qg = compress._zigzag_quant(pg, base, compress.DEFAULT_QUALITY, k).cpu()
                    qc = compress._zigzag_quant(pc, base, compress.DEFAULT_QUALITY, k)
                    same += int((qg == qc).sum())
                    total += qc.numel()
                coef_equal = same / total
            log("coders_batch", transfer=name, frames=16, size=H,
                encode_ms=f"{enc_ms:.4f}", encode_device_ms=f"{enc_graph_ms:.4f}",
                code_bytes=gpu_code.nbytes,
                bytes_per_frame=f"{gpu_code.nbytes / 16:.1f}",
                host_decode_ms_per_frame=f"{dec_ms:.3f}",
                card_vs_cpu_coef_equal=coef_equal, card_vs_cpu_code_bytes_equal=(
                    gpu_code.shape == cpu_code.shape and bool((gpu_code == cpu_code).all())),
                card_vs_cpu_decoded_max_levels=int(d_cpu.max()),
                decode_vs_numpy=None if twin is None else json.dumps(
                    {"max_levels": twin[0], "share_differing": twin[1]}))
            if d_cpu.max() > 1:
                raise AssertionError(f"coders {name}: the card's code decodes {d_cpu.max()} "
                                     "levels from the CPU's")
            if twin is not None and not (twin[0] <= 1 and twin[1] < 1e-3):
                raise AssertionError(f"coders {name}: native against numpy {twin}")


class plain_recurrences:
    """Within the block the models' GRU and LSTM layers run nn_core's plain
    loop instead of K2 / K3 (on any device), for the onboard phase's
    whole-path comparisons; the plain loop counts no launch."""

    def __enter__(self):
        from livespeechportraits_torch.models import nn_core
        from livespeechportraits_torch.ops import recurrent_cuda

        self.orig = recurrent_cuda.gru_layer, recurrent_cuda.lstm_layer
        recurrent_cuda.gru_layer, recurrent_cuda.lstm_layer = (nn_core.gru_layer,
                                                               nn_core.lstm_layer)
        return self

    def __exit__(self, *exc):
        from livespeechportraits_torch.ops import recurrent_cuda

        recurrent_cuda.gru_layer, recurrent_cuda.lstm_layer = self.orig


def _pack_files(root: str) -> dict:
    """{relative path: bytes} of a built pack's own files (the clips'
    directories left out)."""
    out = {}
    for dirpath, dirs, files in os.walk(root):
        rel = os.path.relpath(dirpath, root)
        if rel != "." and rel != "candidates":
            dirs[:] = []
            continue
        for f in files:
            with open(os.path.join(dirpath, f), "rb") as fh:
                out[os.path.normpath(os.path.join(rel, f))] = fh.read()
    return out


def _save_subject(models, root: str, cfg_dir: str, size: str, loss: str = "L2",
                  ncenter: int = 1) -> None:
    """<cfg_dir>/NewFace.yaml naming the pack at ``root`` and the four
    models saved as reference-format .pkl files with torch.save (the APC
    one with DataParallel "module." prefixes); models None leaves the
    checkpoints out (load_person_models' seed-0 random init)."""
    import yaml

    from livespeechportraits_torch.pipeline import build_person

    os.makedirs(cfg_dir, exist_ok=True)
    path = os.path.join(cfg_dir, "NewFace.yaml")
    build_person.write_person_yaml(path, root, size=size)
    with open(path) as f:
        doc = yaml.safe_load(f)
    mp = doc["model_params"]
    mp["Audio2Mouth"].update(loss=loss, gmm_ncenter=ncenter)
    if models is not None:
        for key, name in (("APC", "apc"), ("Audio2Mouth", "audio2feature"),
                          ("Headpose", "audio2headpose"), ("Image2Image", "feature2face")):
            sd = getattr(models, name).state_dict()
            if name == "apc":
                sd = {"module." + k: v for k, v in sd.items()}
            mp[key]["ckp_path"] = os.path.join(cfg_dir, f"{name}.pkl")
            torch.save(sd, mp[key]["ckp_path"])
    with open(path, "w") as f:
        yaml.safe_dump(doc, f)


def _serve_subject(dev, cfg_dir: str, what: str, quantize: bool, audio) -> tuple:
    """Predictor(device).setup('NewFace') then one predict of ``audio``:
    (the Predictor, the result, {"setup_s", "first_predict_s"}, the
    launches of setup and of the request).  Checks the frames and each
    kernel's launches a request."""
    from livespeechportraits_torch import serve
    from livespeechportraits_torch.ops import recurrent_cuda

    zero_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p = serve.Predictor(device=dev, results_dir=os.path.join(cfg_dir, "out"))
    p.setup("NewFace", config_dir=cfg_dir, quantize=quantize)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_launches = launch_counts()
    zero_launch_counts()
    t0 = time.perf_counter()
    res = p.predict(audio, write_video=False)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = launch_counts()
    plans = dict(recurrent_cuda.PLAN_LAUNCHES)
    n = int(len(audio) / 16000 * 60) - 15
    f = res.frames
    log(f"onboard_{what}", setup_s=f"{setup_s:.3f}", first_predict_s=f"{first_s:.3f}",
        nframe=res.nframe, fps=f"{res.nframe / res.wall_s:.2f}",
        setup_launches=json.dumps(setup_launches), launches=json.dumps(launches),
        rnn_plans=json.dumps(plans),
        stage_ms=json.dumps({k: round(v, 3) for k, v in res.stage_ms.items()}))
    if res.nframe != n or f.shape != (n, 512, 512, 3) or f.dtype != np.uint8 \
            or f.min() == f.max():
        raise AssertionError(f"onboard {what}: frames {f.shape} {f.dtype}, want {n}")
    # a bucket's first request runs G1 once eagerly (the capture's warm-up:
    # 3 GRU + 3 LSTM launches) and then replays it (3 + 3 more)
    want = {"K1": math.ceil(n / 16), "K2": 6, "K3": 6}
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"onboard {what}: launches {launches}, want {want}")
    k4_ok = launches["K4"] >= 44 * want["K1"] if quantize else launches["K4"] == 0
    if not k4_ok:
        raise AssertionError(f"onboard {what}: {launches['K4']} K4 launches")
    check_rnn_plans(launches, plans)
    return p, res, {"setup_s": setup_s, "first_predict_s": first_s}, setup_launches, launches


def check_onboard(dev, tmp: str) -> tuple:
    """Phase 8: subject onboarding at full width on the card.  Returns (each
    kernel's launches on the onboard path, K1's f32-plane row at the
    onboarding batch).  Raises on any failed check."""
    import shutil

    from PIL import Image

    from livespeechportraits_torch.config import PersonConfig, replace
    from livespeechportraits_torch.models import apc as apc_model
    from livespeechportraits_torch.models import audio2feature as a2f_model
    from livespeechportraits_torch.models import feature2face as f2f
    from livespeechportraits_torch.ops import manifold, mel, rasterize, rasterize_cuda
    from livespeechportraits_torch.pipeline import (animate, assets, build_person,
                                                    synth_subject, video)
    from livespeechportraits_torch.utils import h5vlen

    total = {k: 0 for k in ("K1", "K2", "K3", "K4")}

    def add(counts):
        for k in total:
            total[k] += counts[k]

    # 8a. the raw clips: clip1 600 frames with a face, clip2 480 without
    root = os.path.join(tmp, "NewFace")
    zero_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gt = synth_subject.write_raw_clip(root, "clip1", 600, seed=0, image_size=512, device=dev)
    synth_subject.write_raw_clip(root, "clip2", 480, seed=1, image_size=512, with_face=False,
                                 device=dev)
    clips_s = time.perf_counter() - t0
    counts = launch_counts()
    add(counts)
    if counts != {"K1": math.ceil(600 / 32), "K2": 0, "K3": 0, "K4": 0, "K5": 0}:
        raise AssertionError(f"onboard clips: launches {counts}, want K1 {math.ceil(600 / 32)}")
    # K1's f32 plane at the clips' batch: the first batch's table, bitwise
    # against the plain twin on the card, timed beside the bound
    lm = torch.as_tensor(gt["landmarks2d"][:32], device=dev)
    sh = torch.as_tensor(gt["shoulders"], device=dev)[None].expand(32, -1, -1)
    table = rasterize.segment_table(lm, sh)
    edges = rasterize_cuda.rasterize_segments(table, 512, 512)
    plain = rasterize.rasterize_segments(table, 512, 512)
    mismatched = int((edges != plain).sum().item())
    plane = {"frames": 32, "size": 512, "segments": table.shape[1], "launches": counts["K1"],
             "device_ms": graph_ms(lambda: rasterize_cuda.rasterize_segments(table, 512, 512)),
             "ms": cuda_ms(lambda: rasterize_cuda.rasterize_segments(table, 512, 512), reps=20),
             "plain_ms": cuda_ms(lambda: rasterize.rasterize_segments(table, 512, 512), reps=2,
                                 warmup=1),
             "max_abs_err": float((edges - plain).abs().max().item())}
    plane["bound_ms"], plane["bound_by"] = bound(table.numel() * 4 + edges.numel() * 4, 0, "f32")
    plane["share"] = plane["bound_ms"] / plane["device_ms"]
    # the clip's first stored frame against the stylised plain edge map
    first = np.asarray(Image.open(io.BytesIO(h5vlen.read(
        os.path.join(root, "clip1", "clip1.h5"), "clip1", [0])[0])))
    db = psnr(first, synth_subject.stylise_edges(plain[:1].cpu().numpy())[0])
    log("onboard_clips", seconds=f"{clips_s:.3f}", frames="600 + 480", launches=json.dumps(counts),
        k1_mismatched=mismatched, first_frame_psnr_db=f"{db:.2f}",
        k1_f32_plane=json.dumps({k: (round(v, 5) if isinstance(v, float) else v)
                                 for k, v in plane.items()}))
    if mismatched or not db >= 35.0:
        raise AssertionError(f"onboard clips: {mismatched} edge pixels differ from the twin, "
                             f"first frame {db:.2f} dB")

    # 8b. the pack: the default APC at random init (seed 0) on the card
    cfg = PersonConfig()
    models0 = assets.init_models(cfg, 0)
    apc_dev = copy.deepcopy(models0.apc).to(dev)
    zero_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    manifest = build_person.build_person_pack(root, ["clip1", "clip2"], apc=apc_dev,
                                              image_size=512, bank_stride=1)
    build_s = time.perf_counter() - t0
    counts = launch_counts()
    add(counts)
    k2_ms = 0.0
    for name in ("clip1", "clip2"):
        mel80 = mel.compute_mel_sequence(
            video.load_wav(os.path.join(root, name, name + ".wav")), device=dev)
        k2_ms += cuda_ms(lambda: apc_model.encode_fast(apc_dev, mel80), reps=3, warmup=1)
    # the same pack built with the plain recurrence on the card
    plain_root = os.path.join(tmp, "plain", "NewFace")
    for name in ("clip1", "clip2"):
        shutil.copytree(os.path.join(root, name), os.path.join(plain_root, name))
    with plain_recurrences():
        build_person.build_person_pack(plain_root, ["clip1", "clip2"], apc=apc_dev,
                                       image_size=512, bank_stride=1)
    ours, theirs = _pack_files(root), _pack_files(plain_root)
    bank = np.load(os.path.join(root, "APC_feature_base.npy"))
    bank_err = float(np.abs(bank - np.load(os.path.join(plain_root,
                                                         "APC_feature_base.npy"))).max())
    ours["NewFace.yaml"] = ours["NewFace.yaml"].replace(root.encode(), plain_root.encode())
    differ = sorted(k for k in ours if k != "APC_feature_base.npy"
                    and ours[k] != theirs.get(k))
    log("onboard_pack", seconds=f"{build_s:.3f}", k2_ms=f"{k2_ms:.4f}",
        launches=json.dumps(counts), bank_rows=bank.shape[0], bank_max_abs_err=f"{bank_err:.3e}",
        tol=RNN_TOL, files=len(ours), files_differing=json.dumps(differ),
        manifest=json.dumps(manifest))
    if counts != {"K1": 0, "K2": 6, "K3": 0, "K4": 0, "K5": 0} or bank.shape != (2160, 512):
        raise AssertionError(f"onboard pack: launches {counts}, bank {bank.shape}")
    if not bank_err <= RNN_TOL or differ or sorted(ours) != sorted(theirs):
        raise AssertionError(f"onboard pack: bank error {bank_err}, files differing {differ}")

    # 8c. the built subject served from its YAML and .pkl checkpoints, int8;
    # against the same seed-0 state dicts built in memory (no checkpoint:
    # load_person_models' random init)
    tone = video.make_test_tone(3.0)
    _save_subject(models0, root, os.path.join(tmp, "cfg_pkl"), "normal")
    _save_subject(None, root, os.path.join(tmp, "cfg_mem"), "normal")
    pq, res, walls, setup_counts, counts = _serve_subject(dev, os.path.join(tmp, "cfg_pkl"),
                                                          "serve", True, tone)
    add(setup_counts)
    add(counts)
    pm, ref, *_ = _serve_subject(dev, os.path.join(tmp, "cfg_mem"), "serve_in_memory", True,
                                 tone)
    d = np.abs(res.frames.astype(int) - ref.frames.astype(int))
    within = float((d <= 1).mean())
    log("onboard_serve_vs_in_memory", frame_max_levels=int(d.max()),
        frames_within_1=f"{within:.6f}", share_tol=BUCKET_FRAME_SHARE, **walls)
    if not within >= BUCKET_FRAME_SHARE:
        raise AssertionError("onboard: the checkpoint-loaded subject's frames differ from the "
                             "in-memory models'")

    # 8d. the 'small' U-Net (bf16; int8 refused)
    cfg_small = replace(cfg, feature2face=replace(cfg.feature2face, size="small"))
    _save_subject(assets.init_models(cfg_small, 0), root, os.path.join(tmp, "cfg_small"),
                  "small")
    ps, res, walls, setup_counts, counts = _serve_subject(dev, os.path.join(tmp, "cfg_small"),
                                                          "small", False, tone)
    add(setup_counts)
    add(counts)
    try:
        _serve_subject(dev, os.path.join(tmp, "cfg_small"), "small_int8", True, tone)
    except NotImplementedError as e:
        refused = str(e)
    else:
        raise AssertionError("onboard: a 'small' subject was served int8")
    # one render batch's input (K1 render_input) against the plain twin
    lm, sh, *_ = animate.compute_motion(ps._cfg, ps._assets, ps._models, tone)
    sh = animate._shift_shoulders(ps._assets, sh)
    cand = animate._cand_stack(ps._assets, 512, dev, torch.bfloat16)
    inp = rasterize_cuda.render_input(lm[:16], sh[:16], cand, (512, 512))
    inp_equal = torch.equal(inp, rasterize.render_input(lm[:16], sh[:16], cand, (512, 512)))
    # the render's device time a 16-frame batch: 'small' bf16, 'normal' bf16
    # and the 'normal' int8 of 8c, on the same input
    normal16 = f2f.cast_generator(models0.feature2face.to(dev), torch.bfloat16)
    nets = {"small_bf16": ps._models.feature2face, "normal_bf16": normal16,
            "normal_int8": pq._models.feature2face}
    with torch.no_grad():
        batch_ms = {k: cuda_ms(lambda: f2f.apply_generator(net, inp), reps=5)
                    for k, net in nets.items()}
        pads = {}
        for k in ("small_bf16", "normal_bf16"):
            events, _, _ = trace(lambda: f2f.apply_generator(nets[k], inp))
            pads[k] = sum("AddPadding" in e.name for e in events) if events else None
    log("onboard_small", render_input_bitwise=inp_equal, int8_refused=repr(refused[:60]),
        render_batch_device_ms=json.dumps({k: round(v, 4) for k, v in batch_ms.items()}),
        cudnn_padding_kernels=json.dumps(pads), **walls)
    if not inp_equal:
        raise AssertionError("onboard small: the render input differs from the plain twin")

    # 8e. the Audio2Feature GMM head (3 components), int8 renderer
    cfg_gmm = replace(cfg, audio2feature=replace(cfg.audio2feature, loss="GMM", gmm_ncenter=3))
    _save_subject(assets.init_models(cfg_gmm, 0), root, os.path.join(tmp, "cfg_gmm"), "normal",
                  "GMM", 3)
    pg, res, walls, setup_counts, counts = _serve_subject(dev, os.path.join(tmp, "cfg_gmm"),
                                                          "gmm", True, tone)
    add(setup_counts)
    add(counts)
    # the head's pre-decode output, K3 against the plain LSTM on the card
    with torch.no_grad():
        feats = apc_model.encode_fast(pg._models.apc, mel.compute_mel_sequence(tone, device=dev))
        feats = manifold.lle_project(feats, pg._assets.tensor("apc_feature_base", dev))
        block = a2f_model.apply_audio2feature(pg._models.audio2feature, feats[None])
        with plain_recurrences():
            block_plain = a2f_model.apply_audio2feature(pg._models.audio2feature, feats[None])
    head_err = float((block - block_plain).abs().max().item())
    log("onboard_gmm", head_width=block.shape[-1], head_max_abs_err=f"{head_err:.3e}",
        tol=RNN_TOL, **walls)
    if block.shape[-1] != 151 * 3 or not head_err <= RNN_TOL:
        raise AssertionError(f"onboard gmm: head {tuple(block.shape)} error {head_err}")
    log("onboard_launches", **{k: v for k, v in total.items()})
    return total, plane


def _logged(root: str, name: str, key: str) -> list:
    """The values of key in a trainer run's scalars.csv (under each header
    that names it)."""
    import csv

    vals, header = [], None
    with open(os.path.join(root, name, "scalars.csv")) as f:
        for row in csv.reader(f):
            if row[0] == "step":
                header = row
            elif key in header:
                vals.append(float(row[header.index(key)]))
    return vals


def check_training(dev, tmp: str) -> tuple:
    """Phase 10: the four trainers at full width on the card, through
    trainer.train_* on the synthetic samplers, then a Predictor serving what
    they wrote.  Returns (each kernel's launches in the Feature2Face run, K1's
    row at the training batch, the synthetic face sampler).  Raises on any
    failed check."""
    from livespeechportraits_torch.config import (APCConfig, Audio2FeatureConfig,
                                                  Audio2HeadposeConfig, Feature2FaceConfig)
    from livespeechportraits_torch.models import apc as apc_model
    from livespeechportraits_torch.models import audio2feature as a2f_model
    from livespeechportraits_torch.models import audio2headpose as a2h_model
    from livespeechportraits_torch.models import feature2face as f2f
    from livespeechportraits_torch.ops import rasterize, rasterize_cuda
    from livespeechportraits_torch.pipeline import video
    from livespeechportraits_torch.serve import Predictor
    from livespeechportraits_torch.train import __main__ as cli
    from livespeechportraits_torch.train import datasets, steps, trainer
    from livespeechportraits_torch.utils import checkpoint as ckpt

    # the library's defaults, as a user's run has them (phase 7 turned TF32
    # off): cuDNN's f32 convolutions (the discriminator's) in TF32
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False

    def loop(name: str, decay: int = 1) -> "trainer.TrainLoopConfig":
        return trainer.TrainLoopConfig(n_epochs=1, n_epochs_decay=decay, lr=1e-4, batch_size=8,
                                       print_freq=1, checkpoints_dir=tmp, name=name,
                                       device="cuda")

    def changed(model, before: dict) -> bool:
        return any(not torch.equal(v.cpu(), before[k]) for k, v in model.state_dict().items())

    def single(name: str, model, run, key: str) -> None:
        before = {k: v.clone() for k, v in model.state_dict().items()}
        zero_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run(model)
        wall = time.perf_counter() - t0
        losses = _logged(tmp, name, key)
        ms = res.step_ms
        log(f"train_{name}", steps=len(ms), wall_s=f"{wall:.3f}",
            step_ms_median=f"{float(np.median(ms)):.3f}", step_ms_first=f"{ms[0]:.3f}",
            step_ms=json.dumps([round(t, 3) for t in ms]), loss_first=f"{losses[0]:.5f}",
            loss_last=f"{losses[-1]:.5f}", best_val=res.best_val,
            launches=json.dumps(launch_counts()))
        if not (losses and np.isfinite(losses).all() and changed(model, before)
                and res.best_val is not None and np.isfinite(res.best_val)):
            raise AssertionError(f"train {name}: losses {losses[:3]}..., or no parameter moved")

    # 10a-c: APC (3 x GRU 80 -> 512 + head, windows of 480), Audio2Feature
    # (3 x LSTM H=256, sequence 240), Audio2Headpose (WaveNet 7 x 2, time
    # frame 240), batch 8, two epochs each, validated each epoch
    mels = cli.synthetic_mels(4, 2400)
    single("apc", trainer._init(apc_model.APCPretrain(APCConfig())),
           lambda m: trainer.train_apc(
               APCConfig(), loop("apc"), datasets.MelWindowSampler(mels[1:], 480, 240),
               datasets.MelWindowSampler(mels[:1], 480), init=m), "loss")
    a2f_sampler = datasets.AudioVisualSampler(cli.synthetic_clips(2, 1400), seq_len=240,
                                              frame_jump_stride=40, device_audio=True)
    single("audio2feature", trainer._init(a2f_model.Audio2Feature(Audio2FeatureConfig())),
           lambda m: trainer.train_audio2feature(Audio2FeatureConfig(), loop("audio2feature"),
                                                 a2f_sampler, a2f_sampler, init=m), "loss")
    a2h_cfg = Audio2HeadposeConfig()
    a2h_sampler = datasets.AudioVisualSampler(
        cli.synthetic_clips(2, 1800), task="audio2headpose", target_length=240,
        receptive_field=a2h_cfg.wavenet.receptive_field, frame_future=a2h_cfg.frame_future,
        frame_jump_stride=50, device_audio=True)
    single("audio2headpose", trainer._init(a2h_model.Audio2Headpose(a2h_cfg)),
           lambda m: trainer.train_audio2headpose(a2h_cfg, loop("audio2headpose"), a2h_sampler,
                                                  a2h_sampler, init=m), "loss")

    # 10d: Feature2Face at 512^2, B = 8, bf16, the edge maps drawn by K1, three
    # epochs validated each epoch
    cfg = Feature2FaceConfig()
    t0 = time.perf_counter()
    sampler = cli.synthetic_face_data(80, 512)
    data_s = time.perf_counter() - t0
    g, d = seed0_gan(cfg)
    g_before = copy.deepcopy(g).to(dev)
    fixed = next(sampler.batches(8, np.random.default_rng(1), shuffle=False))
    zero_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = trainer.train_feature2face(cfg, loop("feature2face", decay=2), sampler, sampler,
                                     init_g=g, init_d=d)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = res.step_ms
    val_batches = 3 * math.ceil(len(sampler) / 8)
    losses = {k: _logged(tmp, "feature2face", k) for k in ("loss_D", "loss_G", "L1")}
    # L1 of the training-mode forward on one fixed batch, before and after
    move = trainer._Mover(dev)
    batch = move(fixed)
    inp, tgt = steps.f2f_g_input(batch), steps.f2f_target(batch)

    def l1(model) -> float:
        with torch.no_grad():
            fake = steps._g_forward(copy.deepcopy(model), inp, True, torch.bfloat16)
        return float((fake - tgt).abs().mean().item())

    l1_before, l1_after = l1(g_before), l1(res.models["G"])
    # K1 on the training batch's landmarks, bitwise against its plain twin
    lm = torch.as_tensor(fixed["landmarks"], device=dev)
    sh = torch.as_tensor(fixed["shoulders"], device=dev)
    table = rasterize.segment_table(lm, sh)
    edges = rasterize_cuda.rasterize_segments(table, 512, 512)
    plain = rasterize.rasterize_segments(table, 512, 512)
    mismatched = int((edges != plain).sum().item())
    k1 = {"frames": 8, "size": 512, "segments": table.shape[1], "train_launches": counts["K1"],
          "device_ms": graph_ms(lambda: rasterize_cuda.rasterize_segments(table, 512, 512)),
          "ms": cuda_ms(lambda: rasterize_cuda.rasterize_segments(table, 512, 512), reps=20),
          "plain_ms": cuda_ms(lambda: rasterize.rasterize_segments(table, 512, 512), reps=2,
                              warmup=1),
          "max_abs_err": float((edges - plain).abs().max().item()),
          "lit": int(plain.sum().item())}
    k1["bound_ms"], k1["bound_by"] = bound(table.numel() * 4 + edges.numel() * 4, 0, "f32")
    k1["share"] = k1["bound_ms"] / k1["device_ms"]
    k1["step_share"] = k1["device_ms"] / float(np.median(ms))
    log("train_feature2face", size=512, batch=8, precision=cfg.precision, steps=len(ms),
        data_s=f"{data_s:.3f}", wall_s=f"{wall:.3f}",
        step_ms_median=f"{float(np.median(ms)):.3f}", step_ms_first=f"{ms[0]:.3f}",
        step_ms=json.dumps([round(t, 3) for t in ms]), peak_gib=f"{peak_gib:.3f}",
        loss_D=json.dumps([round(v, 4) for v in losses["loss_D"]]),
        loss_G=json.dumps([round(v, 4) for v in losses["loss_G"]]),
        l1_fixed_before=f"{l1_before:.5f}", l1_fixed_after=f"{l1_after:.5f}",
        best_val_l1=res.best_val, launches=json.dumps(counts), val_batches=val_batches,
        k1_mismatched=mismatched, k1=json.dumps({k: (round(v, 5) if isinstance(v, float) else v)
                                                 for k, v in k1.items()}))
    if counts != {"K1": len(ms) + val_batches + 1, "K2": 0, "K3": 0, "K4": 0, "K5": 0}:
        raise AssertionError(f"train feature2face: launches {counts}, want K1 one a step "
                             f"({len(ms)}), one a validation batch ({val_batches}) and one "
                             "for the epoch panel's batch")
    if not all(np.isfinite(v).all() and v for v in losses.values()):
        raise AssertionError(f"train feature2face: losses {losses}")
    if mismatched or not l1_after < l1_before:
        raise AssertionError(f"train feature2face: K1 {mismatched} pixels off, L1 {l1_before} "
                             f"-> {l1_after}")
    # one more D + G step on the fixed batch, unprofiled then traced: the
    # step's wall, the device's busy share and the kernels that take most
    g_t, d_t = res.models["G"], res.models["D"]

    def gan_step():
        steps.f2f_d_step(cfg, g_t, d_t, res.optimizers["D"], batch, torch.bfloat16)
        steps.f2f_g_step(cfg, g_t, d_t, res.optimizers["G"], batch, None, torch.bfloat16)

    gan_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gan_step()
    torch.cuda.synchronize()
    step_wall = (time.perf_counter() - t0) * 1e3
    events, traced_wall, _ = trace(gan_step)
    busy = busy_ms(events)
    log("train_profile", step_wall_ms=f"{step_wall:.3f}", traced_wall_ms=f"{traced_wall:.3f}",
        device_busy_ms=f"{busy:.3f}", busy_share=f"{busy / step_wall:.4f}",
        device_events=len(events), top=json.dumps(top_kernels(events, 8)))

    # 10e: a Predictor serving the four checkpoints, one 3.0 s request
    ckpts = {f"{s}_ckpt": os.path.join(tmp, task, "ckpt") for s, task in
             (("f2f", "feature2face"), ("a2f", "audio2feature"), ("a2h", "audio2headpose"),
              ("apc", "apc"))}
    p = Predictor(device="cuda", results_dir=os.path.join(tmp, "serve"))
    t0 = time.perf_counter()
    p.setup("Synthetic", image_size=512, **ckpts)
    setup_s = time.perf_counter() - t0
    # the served Audio2Feature holds the run's best-validation epoch
    trained = ckpt.load_checkpoint(ckpt.prefer_best(ckpts["a2f_ckpt"]))["models"]["params"]
    same = all(torch.equal(v.cpu(), trained[k])
               for k, v in p._models.audio2feature.state_dict().items())
    t0 = time.perf_counter()
    out = p.predict(video.make_test_tone(3.0), write_video=False)
    req_s = time.perf_counter() - t0
    frames = out.frames
    log("train_serve", setup_s=f"{setup_s:.3f}", request_s=f"{req_s:.3f}", frames=frames.shape,
        fps=f"{out.nframe / req_s:.2f}", a2f_weights_from_ckpt_best=same,
        pixel_std=f"{frames.std():.4f}")
    if frames.shape != (165, 512, 512, 3) or frames.min() == frames.max() or not same:
        raise AssertionError(f"train serve: frames {frames.shape}, weights served {same}")
    return counts, k1, sampler


# The discriminator's interior convs at 512^2 (num_D 2, n_layers_D 3, ndf
# 64): (name, input size, Cin, Cout, stride); 4x4, padding 2
D_SHAPES = (("scale 0 layer 1", 257, 64, 128, 2), ("scale 0 layer 2", 129, 128, 256, 2),
            ("scale 0 layer 3", 65, 256, 512, 1), ("scale 1 layer 1", 129, 64, 128, 2),
            ("scale 1 layer 2", 65, 128, 256, 2), ("scale 1 layer 3", 33, 256, 512, 1))


def check_k4_discriminator(dev, B: int = 8) -> list:
    """K4's 4x4 taps at the six D shapes, B = 8, f32 in (the discriminator's
    dtype): the fused f32 mode and the int32 mode bitwise against the twins;
    device ms (CUDA-graph replay) beside the bound, ms a call, the plain
    twin's ms, and the cuDNN conv of the same shape in bf16 and in f32
    (TF32, what the float discriminator runs) as yardsticks."""
    from livespeechportraits_torch.ops import q8conv_cuda as q8

    F = torch.nn.functional
    rows = []
    for i, (name, size, cin, cout, stride) in enumerate(D_SHAPES):
        x, w, r, scale, bias = k4_inputs(B, size, cin, cout, dev, 500 + i, ksize=4,
                                         dtype=torch.float32)
        fn = lambda: q8.conv_q8(x, r, w, stride, 2, scale, bias)  # noqa: E731
        got = fn()
        ref = q8.conv_q8_plain(x, r, w, stride, 2, scale, bias)
        x_q = q8.quantize_plain(x, r)
        int_diff = int((q8.conv_s8(x_q, w, stride, 2) != q8.conv_s8_plain(x_q, w, stride, 2)
                        ).sum().item())
        diff = int((got != ref).sum().item())
        err = (got - ref).abs().max().item()
        dev_ms = graph_ms(fn)
        ms = cuda_ms(fn, reps=20)
        plain_ms = cuda_ms(lambda: q8.conv_q8_plain(x, r, w, stride, 2, scale, bias), reps=1,
                           warmup=1)
        wf = w.float().contiguous(memory_format=torch.channels_last)
        xb, wb = x.to(torch.bfloat16), wf.to(torch.bfloat16)
        bf16_ms = cuda_ms(lambda: F.conv2d(xb, wb, stride=stride, padding=2), reps=20)
        f32_ms = cuda_ms(lambda: F.conv2d(x, wf, stride=stride, padding=2), reps=20)
        bound_ms, bound_by = k4_bound(B, size, cin, cout, stride, 4, 4, ksize=4, pad=2)
        row = {"case": name, "input": f"{B}x{cin}x{size}x{size}", "cout": cout,
               "stride": stride, "output": got.shape[2], "mismatched": diff,
               "int32_mismatched": int_diff, "max_abs_err": err, "device_ms": dev_ms, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
               "share": bound_ms / dev_ms, "split_k": q8.split_k(got.numel() // cout, cout, cin,
                                                                 False, 4)[1],
               "library_ms": None, "bf16_conv_ms_cudnn_other_function": bf16_ms,
               "f32_conv_ms_cudnn_tf32_other_function": f32_ms}
        log("K4_D", **{k: (f"{v:.4f}" if isinstance(v, float) else repr(v) if k == "case" else v)
                       for k, v in row.items()})
        if diff or int_diff:
            raise AssertionError(f"K4 at D {name}: {diff} f32 and {int_diff} int32 values "
                                 "differ from the plain twin")
        rows.append(row)
    total = sum(r["device_ms"] for r in rows)
    log("K4_D_forward", B=B, convs=len(rows), device_ms=f"{total:.4f}",
        bound_ms=f"{sum(r['bound_ms'] for r in rows):.4f}")
    return rows


def check_fq8_layer(dev) -> None:
    """A QAT fq8 conv on a 256^2 layer (64 -> 64, B = 8, bf16 under
    autocast, the f32 master weights) against the deployed bf16 QConv2d of
    the same weights: one K4 launch, bitwise."""
    from livespeechportraits_torch.models import nn_core
    from livespeechportraits_torch.ops import q8conv_cuda

    g = torch.Generator().manual_seed(11)
    conv = torch.nn.Conv2d(64, 64, 3, padding=1, bias=False)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=g) * 0.05)
    conv = conv.to(dev)
    layer = nn_core.fake_quant_conv(conv, int8_forward=True)
    deployed = nn_core.QConv2d.from_conv(conv).to(torch.bfloat16)
    deployed.w_q = deployed.w_q.contiguous(memory_format=torch.channels_last)
    x = torch.randn(8, 64, 256, 256, generator=g).to(dev, torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    before = q8conv_cuda.LAUNCHES
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        y = nn_core.conv2d(x, layer, 1, 1)
    launches = q8conv_cuda.LAUNCHES - before
    with torch.no_grad():
        ref = nn_core.conv2d(x, deployed, 1, 1)
    diff = int((y != ref).sum().item())
    log("fq8_layer", shape="8x64x256^2 -> 64", dtype=y.dtype, k4_launches=launches,
        mismatched=diff)
    if diff or launches != 1 or y.dtype != torch.bfloat16:
        raise AssertionError(f"fq8 layer: {diff} values differ from the deployed QConv2d, "
                             f"{launches} K4 launches")


QAT_MODES = {"float": {}, "qat": {"qat": True}, "qat_int8": {"qat_int8": True},
             "qat_int8_qat_d": {"qat_int8": True, "qat_d": True},
             # cuDNN runs an f32 conv in TF32 by default: these two time the
             # QAT emulation and the STE backward in full f32 (the whole step
             # with torch.backends.cudnn.allow_tf32 off)
             "qat_tf32_off": {"qat": True, "tf32": False},
             "qat_int8_tf32_off": {"qat_int8": True, "tf32": False}}


def time_gan_modes(dev, batch, steps: int = 3) -> dict:
    """One D + G step at 512^2, B = 8, in each QAT mode, on the same batch
    and the same seed-0 models: CUDA events around each of `steps` steps
    after two warm-up steps, peak memory (absolute, and above what was
    allocated before the mode's models were built), and K4's launches a
    step.  Then one --qat_int8 --qat_d step traced: K4's device time against
    the step's."""
    from livespeechportraits_torch.config import Feature2FaceConfig
    from livespeechportraits_torch.models import feature2face as f2f
    from livespeechportraits_torch.ops import q8conv_cuda
    from livespeechportraits_torch.train import state, steps as tsteps, trainer

    cfg = Feature2FaceConfig()
    out = {}
    for mode, kw in QAT_MODES.items():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        g, d = seed0_gan(cfg)
        d = d.to(dev)
        if kw:
            g = f2f.qat_generator(g, int8_forward=kw.get("qat_int8", False))
        g = g.to(dev)
        opt_g = state.adam(g.parameters(), 1e-4, 0.5, 0.999)
        opt_d = state.adam(d.parameters(), 1e-4, 0.5, 0.999)
        d_run = f2f.qat_discriminator(d) if kw.get("qat_d", False) else d
        torch.backends.cudnn.allow_tf32 = kw.get("tf32", True)

        def step():
            tsteps.f2f_d_step(cfg, g, d_run, opt_d, batch, torch.bfloat16)
            tsteps.f2f_g_step(cfg, g, d_run, opt_g, batch, None, torch.bfloat16)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        before = q8conv_cuda.LAUNCHES
        ms = []
        for _ in range(steps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            step()
            b.record()
            ms.append((a, b))
        torch.cuda.synchronize()
        ms = [a.elapsed_time(b) for a, b in ms]
        out[mode] = {"step_ms_median": float(np.median(ms)), "step_ms": ms,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                     "step_peak_gib": (torch.cuda.max_memory_allocated() - base) / 2 ** 30,
                     "k4_launches_a_step": (q8conv_cuda.LAUNCHES - before) / steps}
        if mode == "qat_int8_qat_d":
            events, traced_wall, _ = trace(step)
            k4_ms, k4_n = kernel_device_total(events, SYMBOLS["K4"])
            busy = busy_ms(events)
            out[mode].update(traced_wall_ms=traced_wall, device_busy_ms=busy,
                             device_events=len(events), k4_device_ms=k4_ms if events else None,
                             k4_kernels=k4_n,
                             k4_share=(k4_ms / out[mode]["step_ms_median"]) if events else None,
                             top=top_kernels(events, 8))
        log("train_qat_mode", mode=mode, **{k: (f"{v:.3f}" if isinstance(v, float)
                                               else json.dumps(v) if isinstance(v, list)
                                               else v)
                                            for k, v in out[mode].items() if k != "step_ms"},
            step_ms=json.dumps([round(t, 3) for t in ms]))
        del g, d, d_run, opt_g, opt_d
        torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = True
    want = {"float": 0, "qat": 0, "qat_int8": 88, "qat_int8_qat_d": 112, "qat_tf32_off": 0,
            "qat_int8_tf32_off": 88}
    got = {k: v["k4_launches_a_step"] for k, v in out.items()}
    if got != want:
        raise AssertionError(f"K4 launches a GAN step by mode: {got}, want {want}")
    return out


def check_qat(dev, tmp: str, sampler) -> dict:
    """Phase 11a-c: quantization-aware training at full width on the card.
    Returns K4's figures for the kernels line (the D shapes, the training
    run's launches, the GAN step by mode)."""
    from livespeechportraits_torch.config import Feature2FaceConfig
    from livespeechportraits_torch.models import feature2face as f2f
    from livespeechportraits_torch.pipeline import video
    from livespeechportraits_torch.serve import Predictor
    from livespeechportraits_torch.train import trainer
    from livespeechportraits_torch.utils import checkpoint as ckpt

    d_rows = check_k4_discriminator(dev)
    check_fq8_layer(dev)

    # 11c: train_feature2face with --qat_int8 --qat_d, two epochs of two
    # steps, validated each epoch (three batches), K1 and K4 counted
    cfg = Feature2FaceConfig()
    loop = trainer.TrainLoopConfig(n_epochs=1, n_epochs_decay=1, lr=1e-4, batch_size=8,
                                   print_freq=1, checkpoints_dir=tmp, name="f2f_qat8",
                                   device="cuda", qat_int8=True, qat_d=True)
    g, d = seed0_gan(cfg)
    before = {k: v.clone() for k, v in g.state_dict().items()}
    zero_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = trainer.train_feature2face(cfg, loop, sampler, sampler, init_g=g, init_d=d)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    n_steps, val = len(res.step_ms), 2 * math.ceil(len(sampler) / 8)
    losses = {k: _logged(tmp, "f2f_qat8", k) for k in ("loss_D", "loss_G")}
    moved = any(not torch.equal(v.cpu(), before[k])
                for k, v in res.models["G"].state_dict().items())
    mode = ckpt.qat_mode(ckpt.load_checkpoint(os.path.join(tmp, "f2f_qat8", "ckpt")))
    log("train_qat_int8", steps=n_steps, val_batches=val, wall_s=f"{wall:.3f}",
        step_ms_median=f"{float(np.median(res.step_ms)):.3f}",
        step_ms=json.dumps([round(t, 3) for t in res.step_ms]), launches=json.dumps(counts),
        k4_a_step=112, k4_a_val_batch=44, ckpt_qat_mode=mode,
        loss_G=json.dumps([round(v, 4) for v in losses["loss_G"]]), params_moved=moved)
    # the epoch panel: its batch's edge maps once a run (K1), G's 44 tagged
    # convs once an epoch (K4)
    want = {"K1": n_steps + val + 1, "K2": 0, "K3": 0,
            "K4": 112 * n_steps + 44 * val + 44 * 2, "K5": 0}
    if counts != want:
        raise AssertionError(f"QAT training launches {counts}, want {want}")
    if not (all(np.isfinite(v).all() and v for v in losses.values()) and moved
            and mode == "fq8"):
        raise AssertionError(f"QAT training: losses {losses}, moved {moved}, mode {mode}")

    # the --qat (f32 emulation) run: one epoch, no K4
    zero_launch_counts()
    res_fq = trainer.train_feature2face(
        cfg, trainer.TrainLoopConfig(n_epochs=1, n_epochs_decay=0, lr=1e-4, batch_size=8,
                                     print_freq=1, checkpoints_dir=tmp, name="f2f_qat",
                                     device="cuda", qat=True), sampler)
    counts_fq = launch_counts()
    log("train_qat_fq", steps=len(res_fq.step_ms),
        step_ms=json.dumps([round(t, 3) for t in res_fq.step_ms]), launches=json.dumps(counts_fq))
    if counts_fq["K4"] or f2f.qat_tag_mode(res_fq.models["G"]) != "fq":
        raise AssertionError(f"--qat run: launches {counts_fq}")

    # each mode's step time and memory on one batch, the runs above freed
    del res, res_fq, g, d
    torch.cuda.empty_cache()
    batch = trainer._Mover(dev)(next(sampler.batches(8, np.random.default_rng(1),
                                                     shuffle=False)))
    modes = time_gan_modes(dev, batch)

    # a Predictor serving the QAT checkpoint (int8 renderer), one 3.0 s request
    p = Predictor(device="cuda", results_dir=os.path.join(tmp, "serve_qat"))
    t0 = time.perf_counter()
    p.setup("Synthetic", image_size=512, quantize=True,
            f2f_ckpt=os.path.join(tmp, "f2f_qat8", "ckpt"))
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = p.predict(video.make_test_tone(3.0), write_video=False)
    req_s = time.perf_counter() - t0
    frames = out.frames
    log("serve_qat", setup_s=f"{setup_s:.3f}", request_s=f"{req_s:.3f}", frames=frames.shape,
        pixel_std=f"{frames.std():.4f}",
        tagged=f2f.is_qat_generator(p._models.feature2face))
    if (frames.shape != (165, 512, 512, 3) or frames.min() == frames.max()
            or f2f.is_qat_generator(p._models.feature2face)):
        raise AssertionError(f"QAT serve: frames {frames.shape}")
    return {"d_shapes": d_rows, "train_launches": counts["K4"], "train_steps": n_steps,
            "train_val_batches": val, "gan_step_by_mode": modes}


def check_real_data(dev, tmp: str) -> dict:
    """Phase 11d: training on a subject's clips at full width, through the
    CLI's real-data path.  A synth_subject root with c0 (1800 frames of
    motion, no frame store) and c1 (260 frames with a face, 512^2), the
    subject's mean_pts3d.npy and candidates from build_person_pack (copied
    into c1, as the reference keeps them per clip); --task apc on c0,c1;
    prepare_clip of c0 with that encoder (K2 on the card, counted, cached);
    --task audio2feature / audio2headpose on c0 (the cache read: no K2) and
    --task feature2face on c1 (K1 once a step, once for the panel's batch).  APC holds out c1 (one
    480-row window) and trains on c0's 13 windows at batch 4 (every clip
    must hold a window).  Then a Predictor from the
    four checkpoints serves one 3.0 s request.  Returns the launches and
    walls."""
    import shutil

    from livespeechportraits_torch.config import APCConfig
    from livespeechportraits_torch.models import apc as apc_model
    from livespeechportraits_torch.pipeline import build_person, synth_subject, video
    from livespeechportraits_torch.serve import Predictor
    from livespeechportraits_torch.train import __main__ as cli
    from livespeechportraits_torch.train import data_io

    root, out = os.path.join(tmp, "Person"), os.path.join(tmp, "ck")
    t0 = time.perf_counter()
    synth_subject.write_raw_clip(root, "c0", 1800, seed=0, with_face=False, device="cuda")
    synth_subject.write_raw_clip(root, "c1", 260, seed=1, device="cuda")
    build_person.build_person_pack(root, ["c0", "c1"], apc=None)
    shutil.copytree(os.path.join(root, "candidates"), os.path.join(root, "c1", "candidates"))
    clips_s = time.perf_counter() - t0
    common = ["--device", "cuda", "--n_epochs", "1", "--n_epochs_decay", "0",
              "--checkpoints_dir", out, "--print_freq", "1", "--dataroot", root]
    walls, launches = {}, {}

    step_ms = {}

    def run(task: str, extra: list) -> None:
        zero_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = cli.main(["--task", task] + common + extra)
        walls[task] = time.perf_counter() - t
        launches[task] = launch_counts()
        step_ms[task] = float(np.median(res.step_ms))

    run("apc", ["--clip_names", "c1,c0", "--batch_size", "4"])
    apc_dir = os.path.join(out, "apc", "ckpt")
    enc = apc_model.load_pretrained_encoder(apc_dir, APCConfig(), device="cuda")
    zero_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    clip = data_io.prepare_clip(os.path.join(root, "c0"), "c0", enc, APCConfig())
    prep_s = time.perf_counter() - t0
    prep = launch_counts()
    run("audio2feature", ["--clip_names", "c0", "--apc_ckpt", apc_dir])
    run("audio2headpose", ["--clip_names", "c0", "--apc_ckpt", apc_dir])
    run("feature2face", ["--clip_names", "c1"])
    losses = {t: _logged(out, t, "loss_G" if t == "feature2face" else "loss")
              for t in walls}
    f2f_steps = len(losses["feature2face"])
    log("real_data", clips_s=f"{clips_s:.3f}", prepare_clip_s=f"{prep_s:.3f}",
        prepare_clip_frames=clip.n_frames, prepare_clip_launches=json.dumps(prep),
        walls=json.dumps({k: round(v, 3) for k, v in walls.items()}),
        step_ms_median=json.dumps({k: round(v, 3) for k, v in step_ms.items()}),
        launches=json.dumps(launches),
        steps=json.dumps({t: len(v) for t, v in losses.items()}),
        loss_first_last=json.dumps({t: [round(v[0], 4), round(v[-1], 4)]
                                    for t, v in losses.items()}))
    if prep["K2"] != 3 or launches["audio2feature"]["K2"] or launches["audio2headpose"]["K2"]:
        raise AssertionError(f"prepare_clip: K2 {prep}, then {launches} (the cache unread)")
    if launches["feature2face"]["K1"] != f2f_steps + 1 or not f2f_steps:  # + the panel's batch
        raise AssertionError(f"real-data GAN: K1 {launches['feature2face']}, {f2f_steps} steps")
    if not all(v and np.isfinite(v).all() for v in losses.values()):
        raise AssertionError(f"real-data training: losses {losses}")

    ckpts = {f"{s}_ckpt": os.path.join(out, task, "ckpt") for s, task in
             (("f2f", "feature2face"), ("a2f", "audio2feature"), ("a2h", "audio2headpose"),
              ("apc", "apc"))}
    p = Predictor(device="cuda", results_dir=os.path.join(tmp, "serve_real"))
    t0 = time.perf_counter()
    p.setup("Synthetic", image_size=512, quantize=True, **ckpts)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = p.predict(video.make_test_tone(3.0), write_video=False)
    req_s = time.perf_counter() - t0
    log("real_data_serve", setup_s=f"{setup_s:.3f}", request_s=f"{req_s:.3f}",
        frames=res.frames.shape, pixel_std=f"{res.frames.std():.4f}")
    if res.frames.shape != (165, 512, 512, 3) or res.frames.min() == res.frames.max():
        raise AssertionError(f"real-data serve: frames {res.frames.shape}")
    return {"prepare_clip_K2": prep["K2"], "train_K1": launches["feature2face"]["K1"],
            "prepare_clip_s": prep_s, "step_ms_median": step_ms}


# Phase 12's tolerances, about ten times the errors this phase measured on an
# H100 80GB HBM3 at 700 W: the fused step against its oracle 3.1e-5, the
# chunked VGG loss 9.1e-8 and its gradient 3.6e-4; remat was bitwise (the
# recompute replays the same kernels), so its tolerance is f32 rounding.
FUSED_GRAD_TOL = 4e-4  # fused step vs its two-loss oracle: |g - g_ref| / |g_ref| a tensor
REMAT_GRAD_TOL = 1e-6  # remat vs no remat: max |g - g_ref| / max |g_ref| a tensor, bf16 G
REMAT_STAT_TOL = 1e-6  # remat vs no remat: the running stats after the forwards, the same
VGG_LOSS_RTOL = 1e-6  # vgg_microbatch=2 vs unchunked: the perceptual and style terms
VGG_GRAD_TOL = 4e-3  # and d loss / d fake, |g - g_ref| / |g_ref| (TF32 convs)

FUSED_MODES = {"pair": {"fused": False}, "fused": {}, "fused_remat": {"remat": True},
               "fused_remat2": {"remat": 2}, "fused_vgg": {"vgg": True},
               "fused_vgg_mb2": {"vgg": True, "vgg_microbatch": 2},
               "fused_qat_int8_qat_d": {"qat_int8": True, "qat_d": True}}


def _rel_norm(a, b) -> float:
    return float((a.float() - b.float()).norm() / (b.float().norm() + 1e-30))


def _rel_max(a, b) -> float:
    return float((a.float() - b.float()).abs().max() / (b.float().abs().max() + 1e-30))


def _fused_grads(cfg, g, d, batch, vgg=None, compute_dtype=None, **kw):
    """The fused step's two gradients (D's, then G's) and the running stats
    after its forwards, on copies of g and d; and its metrics."""
    from livespeechportraits_torch.train import steps as tsteps

    g, d = copy.deepcopy(g), copy.deepcopy(d)
    loss_d, loss_g, metrics = tsteps.f2f_fused_losses(cfg, g, d, batch, vgg, compute_dtype,
                                                      **kw)
    gd = torch.autograd.grad(loss_d, list(d.parameters()), retain_graph=True)
    gg = torch.autograd.grad(loss_g, list(g.parameters()))
    stats = [v.clone() for m in (g, d) for k, v in m.state_dict().items()
             if k.endswith(("running_mean", "running_var"))]
    return list(gd) + list(gg), stats, metrics


def _oracle_grads(cfg, g, d, batch):
    """The fused step's declared semantics as two separate losses (JAX
    tests/test_train.py:289): D's loss on a detached fake, G's loss with D's
    real features detached, training-mode forwards at the same parameters."""
    from livespeechportraits_torch.models import feature2face as f2f
    from livespeechportraits_torch.models import losses
    from livespeechportraits_torch.train import steps as tsteps

    g, d = copy.deepcopy(g), copy.deepcopy(d)
    inp, tgt = tsteps.f2f_g_input(batch), tsteps.f2f_target(batch)
    fake = f2f.apply_generator(copy.deepcopy(g), inp, training=True).detach()
    pr = f2f.apply_discriminator(d, torch.cat([inp, tgt], -1), training=True)
    pf = f2f.apply_discriminator(d, torch.cat([inp, fake], -1), training=True,
                                 update_stats=False)
    loss_d = (losses.gan_loss(pr, True, cfg.gan_mode) * 2.0
              + losses.gan_loss(pf, False, cfg.gan_mode)) * 0.5
    gd = torch.autograd.grad(loss_d, list(d.parameters()))
    fake = f2f.apply_generator(g, inp, training=True)
    pr = [[f.detach() for f in sc] for sc in f2f.apply_discriminator(
        d, torch.cat([inp, tgt], -1), training=True, update_stats=False)]
    pf = f2f.apply_discriminator(d, torch.cat([inp, fake], -1), training=True,
                                 update_stats=False)
    loss_g = (losses.gan_loss(pf, True, cfg.gan_mode, for_discriminator=False)
              + torch.mean((fake - tgt).abs()) * cfg.lambda_L1
              + losses.feature_matching_loss(pf, pr, cfg.num_D, cfg.n_layers_D,
                                             cfg.lambda_feat))
    gg = torch.autograd.grad(loss_g, list(g.parameters()))
    return list(gd) + list(gg)


def _raw_device_batch(sampler, dev, n: int = 8) -> dict:
    """One sampler batch on the device with its landmarks and shoulders, the
    edge maps not drawn yet (trainer.device_rasterize_batch draws them)."""
    b = next(sampler.batches(n, np.random.default_rng(1), shuffle=False))
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in b.items()}


def check_fused_correctness(dev, raw) -> dict:
    """12a.  At a reduced width (ngf 16, 6 downsamplings, 64^2, B = 4, f32,
    TF32 off), the fused step's gradients against the two-loss oracle; at
    full width (512^2, B = 8, bf16 G, f32 D, PyTorch's TF32 default),
    remat=True and remat=2 against no remat (gradients and running stats),
    and vgg_microbatch=2 against the unchunked VGG loss (the terms and
    d loss / d fake).  Returns the errors."""
    from livespeechportraits_torch.config import Feature2FaceConfig
    from livespeechportraits_torch.models import feature2face as f2f
    from livespeechportraits_torch.models import losses
    from livespeechportraits_torch.train import __main__ as cli
    from livespeechportraits_torch.train import trainer

    out = {}
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    small = Feature2FaceConfig(ngf=16, n_downsample=6, load_size=64, ndf=16,
                               precision="float32")
    gen = torch.Generator().manual_seed(0)
    g = trainer._init(f2f.Feature2FaceG(small), gen=gen).to(dev)
    d = trainer._init(f2f.Feature2FaceD(small), gen=gen).to(dev)
    batch = trainer._Mover(dev)(next(cli.synthetic_face_data(70, 64).batches(
        4, np.random.default_rng(0), shuffle=False)))
    got, _, _ = _fused_grads(small, g, d, batch)
    want = _oracle_grads(small, g, d, batch)
    # a tensor is held to its own norm, or to 1e-3 of its network's largest
    # where its true gradient is zero (D's conv biases before a training
    # BatchNorm, which both sides hold as rounding noise)
    n_d = len(list(d.parameters()))
    for lo, hi in ((0, n_d), (n_d, len(want))):
        floor = 1e-3 * max(float(b.norm()) for b in want[lo:hi])
        out["fused_vs_oracle_err"] = max(
            out.get("fused_vs_oracle_err", 0.0),
            max(float((a - b).norm()) / max(float(b.norm()), floor)
                for a, b in zip(got[lo:hi], want[lo:hi])))
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags

    cfg = Feature2FaceConfig()
    g, d = seed0_gan(cfg)
    g, d = g.to(dev), d.to(dev)
    batch = trainer.device_rasterize_batch(raw)
    ref, ref_stats, _ = _fused_grads(cfg, g, d, batch, compute_dtype=torch.bfloat16)
    for name, remat in (("remat", True), ("remat2", 2)):
        got, stats, _ = _fused_grads(cfg, g, d, batch, compute_dtype=torch.bfloat16,
                                     remat=remat)
        out[f"{name}_grad_err"] = max(_rel_max(a, b) for a, b in zip(got, ref))
        out[f"{name}_stat_err"] = max(_rel_max(a, b) for a, b in zip(stats, ref_stats))
        del got, stats
    del ref, ref_stats
    torch.cuda.empty_cache()
    vgg = losses.init_vgg19(0).to(dev)
    fake = torch.tanh(torch.randn(8, 512, 512, 3, generator=torch.Generator().manual_seed(1))
                      ).to(dev)
    terms = []
    for mb in (None, 2):
        x = fake.clone().requires_grad_(True)
        p, s_ = losses.vgg_style_loss(vgg, x, batch["tgt_image"].float() / 127.5 - 1.0,
                                      microbatch=mb)
        (gx,) = torch.autograd.grad(p + s_, x)
        terms.append((p.item(), s_.item(), gx))
    (p0, s0, g0), (p1, s1, g1) = terms
    out["vgg_mb2_loss_err"] = max(abs(p1 - p0) / abs(p0), abs(s1 - s0) / abs(s0))
    out["vgg_mb2_grad_err"] = _rel_norm(g1, g0)
    log("fused_correctness", **{k: f"{v:.3e}" for k, v in out.items()},
        tol=json.dumps({"fused_vs_oracle": FUSED_GRAD_TOL, "remat_grad": REMAT_GRAD_TOL,
                        "remat_stat": REMAT_STAT_TOL, "vgg_loss": VGG_LOSS_RTOL,
                        "vgg_grad": VGG_GRAD_TOL}))
    limits = {"fused_vs_oracle_err": FUSED_GRAD_TOL, "remat_grad_err": REMAT_GRAD_TOL,
              "remat2_grad_err": REMAT_GRAD_TOL, "remat_stat_err": REMAT_STAT_TOL,
              "remat2_stat_err": REMAT_STAT_TOL, "vgg_mb2_loss_err": VGG_LOSS_RTOL,
              "vgg_mb2_grad_err": VGG_GRAD_TOL}
    bad = {k: out[k] for k in limits if not out[k] <= limits[k]}
    if bad:
        raise AssertionError(f"fused step checks over their tolerances: {bad}")
    return out


def time_fused_modes(dev, raw, steps: int = 3) -> dict:
    """12b.  Each mode at full width (512^2, B = 8, bf16 G, f32 D with TF32,
    seed-0 models, Adam at 2e-4): two warm-up steps, then `steps` steps on
    the same device batch, each starting with its edge maps drawn by K1
    (device_rasterize_batch): the median step ms (CUDA events), the peak
    memory above what was allocated before the mode's models were built, K1's
    and K4's launches a step, and one more step traced: its device busy ms
    (the union of its kernels' intervals) over the unprofiled median is the
    busy share.  Losses must be finite, and L1 lower at the end than at the
    start."""
    from livespeechportraits_torch.config import Feature2FaceConfig
    from livespeechportraits_torch.models import feature2face as f2f
    from livespeechportraits_torch.models import losses
    from livespeechportraits_torch.train import state, steps as tsteps, trainer

    cfg = Feature2FaceConfig()
    vgg = losses.init_vgg19(0).to(dev)
    out = {}
    for mode, kw in FUSED_MODES.items():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        g, d = seed0_gan(cfg)
        d = d.to(dev)
        if kw.get("qat_int8"):
            g = f2f.qat_generator(g, int8_forward=True)
        g = g.to(dev)
        d_run = f2f.qat_discriminator(d) if kw.get("qat_d") else d
        opt_g = state.adam(g.parameters(), 2e-4, 0.5, 0.999)
        opt_d = state.adam(d.parameters(), 2e-4, 0.5, 0.999)
        v = vgg if kw.get("vgg") else None
        l1 = []

        def step():
            batch = trainer.device_rasterize_batch(raw)
            if kw.get("fused", True):
                m = tsteps.f2f_fused_step(cfg, g, d_run, opt_g, opt_d, batch, v, torch.bfloat16,
                                          kw.get("remat", False),
                                          vgg_microbatch=kw.get("vgg_microbatch"))
            else:
                m = tsteps.f2f_d_step(cfg, g, d_run, opt_d, batch, torch.bfloat16)
                m |= tsteps.f2f_g_step(cfg, g, d_run, opt_g, batch, v, torch.bfloat16)
            l1.append(m)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        before = launch_counts()
        marks = []
        for _ in range(steps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            step()
            b.record()
            marks.append((a, b))
        torch.cuda.synchronize()
        after = launch_counts()
        ms = [a.elapsed_time(b) for a, b in marks]
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        events, wall, _ = trace(step)
        busy = busy_ms(events)
        k4_ms, _ = kernel_device_total(events, SYMBOLS["K4"])
        metrics = [{k: t.item() for k, t in m.items()} for m in l1]
        finite = all(np.isfinite(list(m.values())).all() for m in metrics)
        l1s = [m["L1"] for m in metrics]
        out[mode] = {"step_ms_median": float(np.median(ms)), "peak_gib": peak,
                     "busy_share": (busy / float(np.median(ms))) if events else None,
                     "device_busy_ms": busy if events else None, "traced_wall_ms": wall,
                     "k1_a_step": (after["K1"] - before["K1"]) / steps,
                     "k4_a_step": (after["K4"] - before["K4"]) / steps,
                     "k4_device_ms": k4_ms if events else None,
                     "l1_first": l1s[0], "l1_last": l1s[-1], "finite": finite}
        log("fused_mode", mode=mode, **{k: (f"{x:.4f}" if isinstance(x, float) else x)
                                        for k, x in out[mode].items()},
            step_ms=json.dumps([round(t, 3) for t in ms]))
        if not (finite and l1s[-1] < l1s[0]):
            raise AssertionError(f"{mode}: losses not finite and falling: L1 {l1s}")
        del g, d, d_run, opt_g, opt_d, l1
    # K1 once a step; K4: the one G forward's 44 tagged convs and the two D
    # forwards' 6 each
    want_k1 = {m: 1.0 for m in FUSED_MODES}
    want_k4 = {m: (56.0 if "qat" in m else 0.0) for m in FUSED_MODES}
    got_k1 = {m: v["k1_a_step"] for m, v in out.items()}
    got_k4 = {m: v["k4_a_step"] for m, v in out.items()}
    if got_k1 != want_k1 or got_k4 != want_k4:
        raise AssertionError(f"launches a step: K1 {got_k1}, K4 {got_k4}")
    return out


def check_fused_remat_k4(dev, raw) -> dict:
    """12b, K4 in the recompute: one fused --qat_int8 --qat_d step's K4
    launches with remat=True (the 44 tagged convs again) and remat=2 (the
    outer two stages' 8), at full width."""
    from livespeechportraits_torch.config import Feature2FaceConfig
    from livespeechportraits_torch.models import feature2face as f2f
    from livespeechportraits_torch.ops import q8conv_cuda
    from livespeechportraits_torch.train import trainer

    cfg = Feature2FaceConfig()
    g, d = seed0_gan(cfg)
    g = f2f.qat_generator(g, int8_forward=True).to(dev)
    d = f2f.qat_discriminator(d.to(dev))
    batch = trainer.device_rasterize_batch(raw)
    out = {}
    for name, remat in (("none", False), ("remat", True), ("remat2", 2)):
        before = q8conv_cuda.LAUNCHES
        _fused_grads(cfg, g, d, batch, compute_dtype=torch.bfloat16, remat=remat)
        torch.cuda.synchronize()
        out[name] = q8conv_cuda.LAUNCHES - before
    log("fused_qat_remat_k4", **out)
    if out != {"none": 56, "remat": 100, "remat2": 64}:
        raise AssertionError(f"K4 launches of a fused QAT step by remat: {out}")
    return out


def check_a2h_lstm_k3(dev) -> dict:
    """12d.  The Audio2Headpose LSTM variant's generate_sequence_lstm on the
    card (K3: 3 launches, H = 256, batch 1) against the same call on the CPU
    (the plain loop), 3 s of features, sigma 0: the poses within RNN_TOL of
    the largest."""
    from livespeechportraits_torch.config import Audio2HeadposeConfig
    from livespeechportraits_torch.models import audio2headpose as a2h
    from livespeechportraits_torch.ops import recurrent_cuda

    cfg = Audio2HeadposeConfig()
    model = a2h.Audio2HeadposeLSTM(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.eval().requires_grad_(False)
    feats = torch.randn(360, cfg.apc_hidden_size, generator=torch.Generator().manual_seed(2))
    want = a2h.generate_sequence_lstm(model, feats, sigma_scale=0.0)
    model.to(dev)
    before = recurrent_cuda.LSTM_LAUNCHES
    got = a2h.generate_sequence_lstm(model, feats.to(dev), sigma_scale=0.0)
    torch.cuda.synchronize()
    launches = recurrent_cuda.LSTM_LAUNCHES - before
    err = float((got.cpu() - want).abs().max() / want.abs().max())
    log("a2h_lstm_k3", frames=tuple(got.shape), launches=launches, max_rel_err=f"{err:.3e}",
        tol=RNN_TOL)
    if launches != 3 or not err <= RNN_TOL:
        raise AssertionError(f"A2H LSTM variant on K3: launches {launches}, error {err}")
    return {"launches": launches, "max_rel_err": err}


def check_e2e(dev, tmp: str) -> dict:
    """12c.  tools/e2e_subject.py, every phase at 512^2 on the card, cut in
    length: a 600-frame train clip and a 240-frame held-out clip, APC
    windows of 120 rows (2 epochs), Audio2Feature sequences of 60 (2
    epochs), Audio2Headpose targets of 16 (2 epochs, no validation: the
    held-out clip is shorter than the WaveNet's 255-frame field), the tail
    guard 60, the renderer 1 epoch of the fused step (B = 4, every 2nd
    frame), eval on the first 2 s.  Prints e2e_metrics.json and each phase's
    wall; K1-K4 counted over the whole run: K1, K2 and K3 must launch (the
    run trains and serves the float bf16 renderer, as JAX's does, so K4
    does not)."""
    from livespeechportraits_torch.tools import e2e_subject as e2e

    root = os.path.join(tmp, "E2ESynth")
    args = ["--root", root, "--train_frames", "600", "--val_frames", "240",
            "--apc_window", "120", "--apc_epochs", "2", "--a2f_seq_len", "60",
            "--a2f_epochs", "2", "--a2h_target_length", "16", "--a2h_epochs", "2",
            "--tail_margin", "60", "--f2f_epochs", "1", "--eval_seconds", "2",
            "--phases", "clips,apc,pack,a2f,a2h,f2f,eval,rescore"]
    zero_launch_counts()
    res = e2e.main(args)
    counts = launch_counts()
    with open(os.path.join(root, "e2e_metrics.json")) as f:
        metrics = json.load(f)
    log("e2e_walls", **{k: f"{v:.3f}" for k, v in res["walls"].items()},
        launches=json.dumps(counts))
    print(json.dumps({"e2e_metrics": metrics}), flush=True)
    arms = [metrics["trained"], metrics["random_init"]]
    if (metrics["n_frames_scored"] != 105 or not all(
            np.isfinite(v) for arm in arms for v in arm.values() if isinstance(v, float))
            or not all(counts[k] for k in ("K1", "K2", "K3"))):
        raise AssertionError(f"e2e run: metrics {metrics}, launches {counts}")
    return {"walls": res["walls"], "launches": counts, "metrics": metrics}


def check_fused(dev, tmp: str, sampler) -> dict:
    """Phase 12: the fused GAN step, rematerialisation, the chunked VGG loss
    and the whole from-scratch subject run."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    raw = _raw_device_batch(sampler, dev)
    errors = check_fused_correctness(dev, raw)
    modes = time_fused_modes(dev, raw)
    remat_k4 = check_fused_remat_k4(dev, raw)
    k3 = check_a2h_lstm_k3(dev)
    torch.cuda.empty_cache()
    e2e = check_e2e(dev, tmp)
    return {"errors": errors, "modes": modes, "remat_k4": remat_k4, "a2h_lstm_k3": k3,
            "e2e": e2e}


# ---------------------------------------------------------------------------
# 13. the demo's flags and data parallelism
# ---------------------------------------------------------------------------

# Stated tolerances of phase 13 (see PERF.md)
DP_ONE_RANK_TOL = 1e-5  # 13c: a one-rank NCCL group against no group, |g - g_ref| / |g_ref|
# 13d runs in float64: in f32 the GAN's gradients of a batch of 4 and of 8
# differ by up to 7.5e-3 of a tensor's norm through rounding alone (the
# training BatchNorms of the inner stages divide by small variances; 32^2 on
# the CPU), which would hide a missing reduce's error as well as show it
DP_TWO_RANK_TOL = 1e-7  # 13d: two ranks of B = 4 against one process of B = 8, float64
# 13d: the ranks' mean loss against the one-process loss (the generator hands
# its output back in f32, so L1 sums in f32: 3.0e-8 measured on the CPU)
DP_LOSS_RTOL = 1e-6
DP_ZERO_FLOOR = 1e-3  # a zero-true-gradient tensor: share of its network's largest norm
SPLIT_LEVELS = 1  # 13b: the render split against one device (JAX tests/test_parallel.py:118-139)

# 13a's runner, one subprocess on the card: each demo.main(argv) in
# turn, its stdout kept, then a DEMO_RUN line (exit code, wall, the demo's
# own fps line, each kernel's launches during the run)
DEMO_RUNNER = r"""
import contextlib, io, json, sys, time
import torch
from chip_smoke import launch_counts, zero_launch_counts
from livespeechportraits_torch import demo
for name, argv in json.loads(sys.argv[1]):
    zero_launch_counts()
    buf, code, t0 = io.StringIO(), 0, time.perf_counter()
    with contextlib.redirect_stdout(buf):
        try:
            demo.main(argv)
        except SystemExit as e:
            code, msg = (0, "") if e.code in (None, 0) else (1, str(e.code))
            print(msg)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    out = buf.getvalue()
    print(out, flush=True)
    fps = [l for l in out.splitlines() if "fps end-to-end" in l]
    print("DEMO_RUN " + json.dumps({"name": name, "exit": code, "wall_s": time.perf_counter() - t0,
                                    "fps_line": fps[0] if fps else "", "launches": launch_counts(),
                                    "tail": out.splitlines()[-1] if out else ""}), flush=True)
"""


def _video_frames(path: str) -> int:
    import cv2

    cap = cv2.VideoCapture(path)
    try:
        return int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    finally:
        cap.release()


def check_demo_cli(tmp: str, train_dir: str) -> dict:
    """13a.  The demo CLI on the card, as one subprocess running demo.main
    five times on 1.5 s of tone at 512^2 ('normal', render batch 16): from
    scratch with --quantize --artifact --bucket_seconds 2 (the 1.5 s padded
    to 2 s) --save_intermediates 1 (writes the artifact); the same
    command again (reads it); unbucketed from the artifact; --quantize
    --no_calibrate serving phase 10's four checkpoints from a save_input
    YAML (the feature-map video); the checkpoints with the existing artifact
    (must exit non-zero).  Returns the launches of the artifact run."""
    art = os.path.join(tmp, "serving_int8.npz")
    cfg_dir = os.path.join(tmp, "cfg")
    os.makedirs(cfg_dir)
    with open(os.path.join(cfg_dir, "Synthetic.yaml"), "w") as f:
        f.write("model_params:\n  Image2Image:\n    save_input: true\n")
    ckpts = [a for s, task in (("f2f", "feature2face"), ("a2f", "audio2feature"),
                               ("a2h", "audio2headpose"), ("apc", "apc"))
             for a in (f"--{s}_ckpt", os.path.join(train_dir, task, "ckpt"))]

    def argv(name, *flags):
        return [name, ["--duration", "1.5", "--render_batch", "16", "--driving_audio",
                       "missing.wav",
                       "--results_dir", os.path.join(tmp, name), *flags]]

    bucketed = ["--quantize", "--artifact", art, "--bucket_seconds", "2", "--save_intermediates",
                "1"]
    runs = [argv("scratch", *bucketed), argv("artifact", *bucketed),
            argv("exact", "--artifact", art, "--save_intermediates", "1"),
            argv("no_calibrate_ckpts", "--quantize", "--no_calibrate", "--config_dir", cfg_dir,
                 *ckpts),
            argv("ckpts_with_artifact", "--artifact", art, *ckpts[:2])]
    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run([sys.executable, "-c", DEMO_RUNNER, json.dumps(runs)], cwd=here,
                          capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, PYTHONPATH=here))
    done = {}
    for line in proc.stdout.splitlines():
        if line.startswith("DEMO_RUN "):
            r = json.loads(line[len("DEMO_RUN "):])
            done[r["name"]] = r
    if proc.returncode != 0 or len(done) != len(runs):
        raise AssertionError(f"demo runner rc {proc.returncode}: {proc.stdout[-3000:]}"
                             f"{proc.stderr[-3000:]}")
    n = 75  # 1.5 s at 60 fps, less frame_future (15)
    out = {}
    for name, r in done.items():
        where = os.path.join(tmp, name, "Synthetic", "missing")
        jpgs = [f for f in os.listdir(where) if f.startswith("pred_")] if os.path.isdir(where) \
            else []
        video = os.path.join(where, "missing.avi")
        counts = {"video": _video_frames(video) if os.path.exists(video) else 0,
                  "jpgs": len(jpgs)}
        if os.path.exists(os.path.join(where, "landmarks.npy")):
            counts["landmarks"] = len(np.load(os.path.join(where, "landmarks.npy")))
        fmap = os.path.join(where, "missing_feature_maps.avi")
        if os.path.exists(fmap):
            counts["feature_map_video"] = _video_frames(fmap)
        out[name] = {**r, "counts": counts}
        log(f"demo_{name}", exit=r["exit"], wall_s=f"{r['wall_s']:.3f}",
            fps_line=repr(r["fps_line"]), launches=json.dumps(r["launches"]),
            counts=json.dumps(counts), tail=repr(r["tail"][:160]))

    def files(name):
        return os.path.join(tmp, name, "Synthetic", "missing")

    lm = {k: np.load(os.path.join(files(k), "landmarks.npy")) for k in ("scratch", "artifact",
                                                                         "exact")}
    same_jpgs = all(open(os.path.join(files("scratch"), f), "rb").read()
                    == open(os.path.join(files("artifact"), f), "rb").read()
                    for f in (f"pred_{i}.jpg" for i in range(1, n + 1)))
    bucket_px = float(np.abs(lm["artifact"] - lm["exact"]).max())
    log("demo_checks", artifact_written=os.path.exists(art),
        scratch_vs_artifact_landmarks_equal=np.array_equal(lm["scratch"], lm["artifact"]),
        scratch_vs_artifact_jpgs_equal=same_jpgs, bucketed_vs_exact_px=f"{bucket_px:.3e}",
        bucket_tol_px=BUCKET_LANDMARK_TOL_PX)
    bad = []
    for name in ("scratch", "artifact", "exact"):
        c = out[name]["counts"]
        if out[name]["exit"] or c != {"video": n, "jpgs": n, "landmarks": n}:
            bad.append(f"{name}: exit {out[name]['exit']}, counts {c}")
    k = out["artifact"]["launches"]
    batches = -(-n // 16)
    if k != {"K1": batches, "K2": 3, "K3": 3, "K4": 44 * batches, "K5": 1}:
        bad.append(f"artifact run launched {k}, expected K1 {batches}, K2 3, K3 3, K4 "
                   f"{44 * batches}, K5 1")
    d = out["no_calibrate_ckpts"]
    if d["exit"] or d["launches"]["K4"] != 44 * batches or d["counts"].get(
            "feature_map_video") != n:
        bad.append(f"no_calibrate / checkpoints run: {d}")
    if not out["ckpts_with_artifact"]["exit"] or "shadow" not in out["ckpts_with_artifact"]["tail"]:
        bad.append(f"checkpoints with an existing artifact did not exit: "
                   f"{out['ckpts_with_artifact']}")
    if not (np.array_equal(lm["scratch"], lm["artifact"]) and same_jpgs
            and bucket_px <= BUCKET_LANDMARK_TOL_PX):
        bad.append("artifact or bucketed runs differ")
    if bad:
        raise AssertionError("; ".join(bad))
    return {"art": art, "demo_launches": out["artifact"]["launches"],
            "walls": {k: v["wall_s"] for k, v in out.items()}}


def check_serving_split(dev, art: str) -> dict:
    """13b.  Predictor(data_parallel=True) against False, booted from 13a's
    int8 artifact, one 3.0 s request each: the same frames, bit for bit (one
    card: the split is the identity).  Then render_frames over [cuda:0,
    cuda:0] (two shares of 8 a batch of 16) against one device, rgb: frames
    within one level, K1 once a share and K4 44 a share, render_device ms
    of each."""
    from livespeechportraits_torch.pipeline import animate, video
    from livespeechportraits_torch.serve import Predictor

    tone = video.make_test_tone(3.0)
    preds = {}
    for dp in (True, False):
        p = Predictor(device="cuda")
        p.setup("Synthetic", image_size=512, artifact=art, data_parallel=dp)
        p.predict(tone, write_video=False)  # warm
        preds[dp] = (p, p.predict(tone, write_video=False))
    same = np.array_equal(preds[True][1].frames, preds[False][1].frames)
    p = preds[False][0]
    cfg, person, models = p._cfg, p._assets, p._models
    lm, sh, _, _, n = animate.compute_motion(cfg, person, models, tone)
    lm, sh = lm[:n], sh[:n]
    res = {}
    for name, devices in (("one_device", None), ("two_shares", [dev, dev])):
        animate.render_frames(cfg, person, models, lm, sh, render_batch=16,
                              render_devices=devices)  # warm
        times = []
        for _ in range(3):
            zero_launch_counts()
            sm = {}
            frames, _ = animate.render_frames(cfg, person, models, lm, sh, render_batch=16,
                                              stage_ms=sm, render_devices=devices)
            times.append(sm["render_device"])
        res[name] = (frames, float(np.median(times)), launch_counts())
    diff = int(np.abs(res["two_shares"][0].astype(int) - res["one_device"][0].astype(int)).max())
    log("serve_data_parallel", frames=preds[True][1].frames.shape, dp_equals_single=same,
        split_max_level_diff=diff, split_tol_levels=SPLIT_LEVELS,
        render_device_ms_one_device=f"{res['one_device'][1]:.3f}",
        render_device_ms_two_shares=f"{res['two_shares'][1]:.3f}",
        launches_one_device=json.dumps(res["one_device"][2]),
        launches_two_shares=json.dumps(res["two_shares"][2]))
    k = res["two_shares"][2]
    if not same or diff > SPLIT_LEVELS or k["K1"] != 22 or k["K4"] != 44 * 22:
        raise AssertionError(f"serving split: equal {same}, level diff {diff}, launches {k}")
    del preds
    torch.cuda.empty_cache()
    return {"render_split_launches": k}


_SEED0_GAN: dict = {}


def seed0_gan(cfg):
    """(G, D) of cfg at the trainers' seed-0 init (G drawn first, then D from
    the same generator), on the CPU: copies of one draw a config, so the
    phases that each start from it do not draw it again."""
    from livespeechportraits_torch.models import feature2face as f2f
    from livespeechportraits_torch.train import trainer

    if cfg not in _SEED0_GAN:
        gen = torch.Generator().manual_seed(0)
        _SEED0_GAN[cfg] = (trainer._init(f2f.Feature2FaceG(cfg), gen=gen),
                           trainer._init(f2f.Feature2FaceD(cfg), gen=gen))
    return tuple(copy.deepcopy(m) for m in _SEED0_GAN[cfg])


def _gan_models(dev, size: int = 512):
    """The default GAN (ngf 64, 'normal', num_D 2) at size^2, seed 0."""
    from livespeechportraits_torch.config import Feature2FaceConfig
    from livespeechportraits_torch.models import feature2face as f2f
    from livespeechportraits_torch.train import trainer

    cfg = Feature2FaceConfig(load_size=size, n_downsample=min(8, int(math.log2(size))))
    g, d = seed0_gan(cfg)
    g, d = g.to(dev), d.to(dev)
    return cfg, g, d


def _reduced_grads(cfg, g, d, batch, compute_dtype=None):
    """The fused step's losses' metrics and both networks' gradients, through
    state.gradients (averaged over the ranks in a process group)."""
    from livespeechportraits_torch.train import state, steps

    loss_d, loss_g, metrics = steps.f2f_fused_losses(cfg, g, d, batch, None, compute_dtype)
    gd = state.gradients(loss_d, list(d.parameters()), retain_graph=True)
    gg = state.gradients(loss_g, list(g.parameters()))
    return {k: v.item() for k, v in metrics.items()}, list(gd), list(gg)


def _grad_err(got, want, floor_share: float) -> float:
    """The largest |g - g_ref| / |g_ref| over a network's tensors, a tensor
    whose true gradient is zero floored at floor_share of the largest norm."""
    floor = floor_share * max(float(w.float().norm()) for w in want)
    return max(float((a.float() - b.float()).norm()) / max(float(b.float().norm()), floor)
               for a, b in zip(got, want))


def check_dp_one_rank(dev, sampler) -> dict:
    """13c.  --data_parallel on one card: a one-rank NCCL group.  The fused
    GAN step at 512^2, B = 8 (bf16 G, f32 D with TF32), its losses and
    gradients against no group; then 3 steps each way (Adam, K1 each step),
    the median step ms (CUDA events): the gap is the price of the
    all-reduces."""
    from livespeechportraits_torch.parallel import multihost
    from livespeechportraits_torch.train import state, steps, trainer

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    raw = _raw_device_batch(sampler, dev)
    cfg, g, d = _gan_models(dev)

    def run(steps_n: int):
        batch = trainer.device_rasterize_batch(raw)
        metrics, gd, gg = _reduced_grads(cfg, copy.deepcopy(g), copy.deepcopy(d), batch,
                                         torch.bfloat16)
        g2, d2 = copy.deepcopy(g), copy.deepcopy(d)
        opt_g, opt_d = state.adam(g2.parameters(), 1e-4, 0.5, 0.999), state.adam(
            d2.parameters(), 1e-4, 0.5, 0.999)
        ms = []
        zero_launch_counts()
        for _ in range(steps_n):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            steps.f2f_fused_step(cfg, g2, d2, opt_g, opt_d, trainer.device_rasterize_batch(raw),
                                 None, torch.bfloat16)
            end.record()
            ms.append((start, end))
        torch.cuda.synchronize()
        k1 = launch_counts()["K1"]
        return metrics, gd, gg, float(np.median([a.elapsed_time(b) for a, b in ms])), k1

    ref = run(3)
    multihost.initialize("cuda:0")
    try:
        backend = torch.distributed.get_backend()
        got = run(3)
    finally:
        multihost.shutdown()
    err = max(_grad_err(got[1], ref[1], DP_ZERO_FLOOR), _grad_err(got[2], ref[2], DP_ZERO_FLOOR))
    loss_err = max(abs(got[0][k] - v) / max(abs(v), 1e-12) for k, v in ref[0].items())
    log("dp_one_rank", backend=backend, grad_err=f"{err:.3e}", loss_rel_err=f"{loss_err:.3e}",
        tol=DP_ONE_RANK_TOL, step_ms_no_group=f"{ref[3]:.3f}", step_ms_one_rank=f"{got[3]:.3f}",
        reduce_ms=f"{got[3] - ref[3]:.3f}", k1_launches_3_steps=got[4])
    if not (err <= DP_ONE_RANK_TOL and loss_err <= DP_ONE_RANK_TOL and got[4] == 3):
        raise AssertionError(f"one-rank DP: grad err {err}, loss err {loss_err}, K1 {got[4]}")
    del g, d
    torch.cuda.empty_cache()
    return {"step_ms": {"no_group": ref[3], "one_rank": got[3]}}


def _dp_case(rank: int, work: str, dev, size: int) -> None:
    """13d on one rank of phase 17's two-rank gloo group on cuda:0 (NCCL
    refuses two ranks on one card; the group is spawned once for 13d and
    17): draws the global batch of 8 and keeps its 4 rows (K1 on them),
    takes the fused step's reduced gradients (float64), then steps ZeRO-1
    Adam and replicated Adam on copies with them; saves rank<r>.pt in
    work."""
    import hashlib

    from livespeechportraits_torch.parallel import mesh, multihost
    from livespeechportraits_torch.train import __main__ as cli
    from livespeechportraits_torch.train import state, trainer

    os.makedirs(work, exist_ok=True)
    cfg, g, d = _gan_models(dev, size)
    g, d = mesh.replicate(g.double()), mesh.replicate(d.double())
    local = next(multihost.global_batch_iter(cli.synthetic_face_data(8, size), 8,
                                             np.random.default_rng(3)))
    zero_launch_counts()
    batch = _double(trainer._Mover(dev)(local))
    k1 = launch_counts()["K1"]
    metrics, gd, gg = _reduced_grads(cfg, g, d, batch)
    out = {"metrics": metrics, "k1": k1, "rows": int(batch["tgt_image"].shape[0])}
    if rank == 0:
        out["grads"] = [t.cpu() for t in gd + gg]
    same, digest = True, hashlib.sha256()
    for name, net, grads in (("G", g, gg), ("D", d, gd)):
        twin = copy.deepcopy(net)
        zero = mesh.Zero1(state.adam(net.parameters(), 1e-4, 0.5, 0.999))
        plain = state.adam(twin.parameters(), 1e-4, 0.5, 0.999)
        for p, q, grad in zip(net.parameters(), twin.parameters(), grads):
            p.grad, q.grad = grad, grad.clone()
        sync(dev)
        t0 = time.perf_counter()
        zero.step()
        sync(dev)
        out[f"zero1_step_ms_{name}"] = (time.perf_counter() - t0) * 1e3
        plain.step()
        same &= all(torch.equal(p, q) for p, q in zip(net.parameters(), twin.parameters()))
        out[f"state_bytes_{name}"] = zero.state_bytes()
        out[f"replicated_state_bytes_{name}"] = sum(
            t.numel() * t.element_size() for s in plain.state.values() for t in s.values()
            if torch.is_tensor(t))
        for p in net.parameters():
            digest.update(p.detach().cpu().numpy().tobytes())
    out["zero1_equals_replicated"] = same
    out["params_sha256"] = digest.hexdigest()
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    del g, d
    torch.cuda.empty_cache()


def _double(batch: dict) -> dict:
    return {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def check_dp_two_ranks(dev, work: str, wall: float, size: int = 512) -> dict:
    """13d.  Two ranks on the one card (gloo on CUDA tensors; run by phase
    17's ranks, _dp_case), --zero1, the fused GAN step at 512^2, global B = 8
    (4 a rank), in float64: both ranks' parameters equal after the step
    (hashes), ZeRO-1 bitwise against replicated Adam on the same gradients,
    each rank's optimizer bytes about half, K1 once a rank, and the reduced
    gradients and the ranks' mean losses against one process on the global
    batch.  ``wall``: the ranks' seconds for the case."""
    from livespeechportraits_torch.train import __main__ as cli
    from livespeechportraits_torch.train import trainer

    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False) for r in range(2)]
    cfg, g, d = _gan_models(dev, size)
    full = next(cli.synthetic_face_data(8, size).batches(8, np.random.default_rng(3)))
    metrics, gd, gg = _reduced_grads(cfg, g.double(), d.double(),
                                     _double(trainer._Mover(dev)(full)))
    got = [t.to(dev) for t in ranks[0]["grads"]]
    n_d = len(gd)
    err = max(_grad_err(got[:n_d], gd, DP_ZERO_FLOOR), _grad_err(got[n_d:], gg, DP_ZERO_FLOOR))
    loss_err = max(abs((ranks[0]["metrics"][k] + ranks[1]["metrics"][k]) / 2 - v)
                   / max(abs(v), 1e-12) for k, v in metrics.items())
    share = {k: ranks[r][f"state_bytes_{k}"] / ranks[r][f"replicated_state_bytes_{k}"]
             for r in range(2) for k in ("G", "D")}
    log("dp_two_ranks", backend="gloo (CUDA tensors)", wall_s=f"{wall:.3f}",
        rows_a_rank=[r["rows"] for r in ranks], k1_a_rank=[r["k1"] for r in ranks],
        params_equal_across_ranks=ranks[0]["params_sha256"] == ranks[1]["params_sha256"],
        zero1_equals_replicated=[r["zero1_equals_replicated"] for r in ranks],
        state_bytes=json.dumps({k: [r[f"state_bytes_{k}"] for r in ranks] for k in ("G", "D")}),
        replicated_state_bytes=json.dumps({k: ranks[0][f"replicated_state_bytes_{k}"]
                                           for k in ("G", "D")}),
        zero1_step_ms=json.dumps({k: [round(r[f"zero1_step_ms_{k}"], 3) for r in ranks]
                                  for k in ("G", "D")}),
        grad_err=f"{err:.3e}", grad_tol=DP_TWO_RANK_TOL, loss_rel_err=f"{loss_err:.3e}",
        loss_tol=DP_LOSS_RTOL)
    if not (ranks[0]["params_sha256"] == ranks[1]["params_sha256"]
            and all(r["zero1_equals_replicated"] for r in ranks)
            and all(0.4 < v < 0.6 for v in share.values())
            and [r["k1"] for r in ranks] == [1, 1] and [r["rows"] for r in ranks] == [4, 4]
            and err <= DP_TWO_RANK_TOL and loss_err <= DP_LOSS_RTOL):
        raise AssertionError(f"two-rank DP: shares {share}, grad err {err}, loss err {loss_err}")
    return {"k1_a_rank_a_step": ranks[0]["k1"], "state_share": share}


def free_port() -> int:
    """A localhost port free now (released for the process group to bind)."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def check_demo_and_parallel(dev, tmp: str, train_dir: str, sampler) -> dict:
    """Phase 13: the demo's flags and data parallelism (13d runs with phase
    17's ranks)."""
    demo = check_demo_cli(tmp, train_dir)
    serve = check_serving_split(dev, demo["art"])
    one = check_dp_one_rank(dev, sampler)
    return {"demo": demo, "serve": serve, "one_rank": one}


# Phase 14's bounds (see PERF.md, PR 12), about ten times the error
# measured on an H100 80GB HBM3: split_cand's frames against the unsplit
# render's rounds once more at the first conv's output (bf16).
# Measured in PR 12's first call: bf16 rgb 70.10 dB, 1 level at most; int8
# pack4e 62.05 dB, 4 levels.  Bounds per case (PSNR 20 dB below, ten times
# the levels); pack4e's lossy coder takes the int8 bound.
SPLIT_BOUNDS = {"bf16_rgb": (50.0, 10), "bf16_pack4e": (42.0, 40), "int8_yuv420": (42.0, 40)}
LARGE_GFLOP = (243.0, 246.0)  # utils/flops.generator_flops of 'large' at 512^2, a frame


def run_tool(name: str, argv: list) -> list:
    """A tool's main(argv) in this process, its output echoed line by line
    under [tool_<name>]; returns its JSON rows after the first, which names
    the card (parity's one object, which names it too)."""
    import contextlib
    import importlib

    tool = importlib.import_module(f"livespeechportraits_torch.tools.{name}")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = tool.main(argv)
    out = buf.getvalue()
    if name == "parity":
        rows = [json.loads(out[out.index("{"):])]
    else:
        rows = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    for row in rows:
        print(f"[tool_{name}] " + json.dumps(row), flush=True)
    log(f"tool_{name}", rc=rc, seconds=f"{time.perf_counter() - t0:.2f}", rows=len(rows))
    if name != "parity":
        head, rows = rows[0], rows[1:]
        if head.get("tool") != name or not head["device"].startswith("cuda") \
                or not head["card"]:
            raise AssertionError(f"tool {name}: the first row does not name the card: {head}")
    if rc != 0 or not rows:
        raise AssertionError(f"tool {name} returned {rc} with {len(rows)} rows")
    return rows


def check_edge_form(person, dev) -> dict:
    """14a.  K1's edge-only form (render_input without candidates: [B, H, W,
    1], one launch) at B = 16 and 8, 512^2, bf16 and f32: bitwise against
    its plain twin and against channel 0 of the 13-channel form; device ms
    by CUDA-graph replay beside the bound (the edge bytes written, the
    landmarks read) and the twin's ms.  Returns B=16 bf16's numbers, B=8's
    beside them."""
    from livespeechportraits_torch.ops import rasterize, rasterize_cuda
    from livespeechportraits_torch.pipeline import animate

    size = (512, 512)
    out = {}
    for B in (16, 8):
        for dtype in (torch.bfloat16, torch.float32):
            lm, sh = render_case(person, B, dev)
            cand = animate._cand_stack(person, 512, dev, dtype)

            def new():
                return rasterize_cuda.render_input(lm, sh, None, size, dtype=dtype)

            got = new()
            twin = rasterize.render_input(lm, sh, None, size, dtype)
            full = rasterize_cuda.render_input(lm, sh, cand, size)
            torch.cuda.synchronize()
            n_twin = int((got != twin).sum())
            n_full = int((got[..., 0] != full[..., 0]).sum())
            err = (got.float() - twin.float()).abs().max().item()
            dev_ms, ms = graph_ms(new), cuda_ms(new, reps=50)
            plain_ms = cuda_ms(lambda: rasterize.render_input(lm, sh, None, size, dtype), reps=2,
                               warmup=1)
            full_ms = graph_ms(lambda: rasterize_cuda.render_input(lm, sh, cand, size))
            pairs = rasterize_cuda.segment_pairs(dev, sh.shape[1])
            nbytes = got.numel() * got.element_size() + 4 * (lm.numel() + sh.numel()
                                                              + pairs.numel())
            bound_ms, bound_by = bound(nbytes, 0, "f32")
            log("K1_edge_only", frames=B, size="512x512", dtype=str(dtype)[6:],
                shape=tuple(got.shape), lit=int(got.float().sum().item()),
                mismatched_twin=n_twin, mismatched_channel0=n_full,
                device_ms=f"{dev_ms:.5f}", bound_ms=f"{bound_ms:.5f}", bound_by=bound_by,
                share=f"{bound_ms / dev_ms:.3f}", ms=f"{ms:.5f}", plain_ms=f"{plain_ms:.4f}",
                thirteen_channel_device_ms=f"{full_ms:.5f}")
            if n_twin or n_full or tuple(got.shape) != (B, 512, 512, 1):
                raise AssertionError(f"K1 edge-only B={B} {dtype}: {n_twin} values differ from "
                                     f"the twin, {n_full} from channel 0 of the full form")
            nums = {"device_ms": dev_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                    "share": bound_ms / dev_ms, "ms": ms, "plain_ms": plain_ms,
                    "max_abs_err": err, "thirteen_channel_device_ms": full_ms}
            if dtype == torch.bfloat16 and B == 16:
                out.update(nums)
            elif dtype == torch.bfloat16:
                out["b8"] = nums
    return out


def check_split_cand(dev, cfg, person, models) -> dict:
    """14a.  K1's edge-only form, then animate(split_cand=True) against
    split_cand=False on 1.5 s of tone at 512^2: the 'normal' bf16 renderer
    under rgb (batch 8) and pack4e, and the int8 renderer (calibrated as
    serve.Predictor builds it, batch 16, yuv420).  Frames within
    SPLIT_BOUNDS, render_device of both (render_frames in
    turns: unsplit, split, split, unsplit; each renderer cast once), the
    launches of the split run, one batch's forward of each form by graph
    replay with the kernels a trace shows after K1 (the counts set to 0 just before it: K1 once a batch,
    K4 44 a batch under int8), then the split render loop under torch's
    sync debug mode."""
    from livespeechportraits_torch.models import feature2face as f2f
    from livespeechportraits_torch.pipeline import animate, assets, video

    entry = {"split_cand_entry": check_edge_form(person, dev)}
    audio = video.make_test_tone(1.5)
    calib = animate.build_render_inputs(cfg, person, models, video.make_test_tone(1.0),
                                        max_frames=16)
    qm = assets.quantize_person_models(models, calibrate_inputs=calib,
                                       calibrate_dtype=torch.bfloat16)
    # each renderer cast once, as serve.Predictor does
    bf = dataclasses.replace(models, feature2face=f2f.cast_generator(models.feature2face,
                                                                     torch.bfloat16))
    qm.feature2face = f2f.cast_generator(qm.feature2face, torch.bfloat16)
    cases = (("bf16_rgb", bf, "rgb", 8), ("bf16_pack4e", bf, "pack4e", 8),
             ("int8_yuv420", qm, "yuv420", 16))
    for name, m, transfer, batch in cases:
        ref = animate.animate(cfg, person, m, audio, render_batch=batch, transfer=transfer)
        zero_launch_counts()
        got = animate.animate(cfg, person, m, audio, render_batch=batch, transfer=transfer,
                              split_cand=True)
        launches = launch_counts()
        # render_device of each form, in turns (unsplit, split, split,
        # unsplit) on the request's motion
        lm, sh, _, _, n = animate.compute_motion(cfg, person, m, audio)
        walls = {False: [], True: []}
        for split in (False, True, True, False):
            sm = {}
            animate.render_frames(cfg, person, m, lm[:n], sh[:n], render_batch=batch,
                                  transfer=transfer, stage_ms=sm, split_cand=split)
            walls[split].append(sm["render_device"])
        d = np.abs(got.frames.astype(int) - ref.frames.astype(int))
        db = psnr(got.frames, ref.frames)
        batches = math.ceil(got.nframe / batch)
        want = {"K1": batches, "K4": 44 * batches if name.startswith("int8") else 0}
        min_db, max_levels = SPLIT_BOUNDS[name]
        log("split_cand", case=name, frames=got.nframe, psnr_db=f"{db:.2f}",
            max_levels=int(d.max()), share_within_1=f"{(d <= 1).mean():.6f}",
            psnr_bound_db=min_db, max_levels_bound=max_levels,
            render_device_ms=json.dumps(walls[True]),
            unsplit_render_device_ms=json.dumps(walls[False]),
            launches=json.dumps(launches))
        if got.frames.shape != ref.frames.shape or not db >= min_db or d.max() > max_levels:
            raise AssertionError(f"split_cand {name}: {db:.2f} dB, {d.max()} levels from the "
                                 "unsplit render")
        if any(launches[k] != v for k, v in want.items()):
            raise AssertionError(f"split_cand {name}: launches {launches}, want {want}")
        entry["split_cand_launches" if name == "bf16_rgb" else
              f"split_cand_{name}_launches"] = launches["K1"] if name == "bf16_rgb" else launches
    lm, sh, _, _, n = animate.compute_motion(cfg, person, models, audio)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        animate.render_frames(cfg, person, models, lm[:n], sh[:n], split_cand=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log("split_cand_sync_debug", batches=math.ceil(n / 8), synchronizing_calls=0)
    entry["split_cand_forward"] = check_split_forward(person, bf.feature2face, lm[:8],
                                                      animate._shift_shoulders(person, sh[:8]))
    return entry


def check_split_forward(person, net, lm, sh) -> dict:
    """One 8-frame batch's input and forward ('normal', bf16, 512^2), split
    against unsplit: device ms by CUDA-graph replay, and in a traced batch
    the kernels that follow K1 (where cuDNN takes the first conv: the
    13-plane input, padded, or the 1-plane edge)."""
    from livespeechportraits_torch.models import feature2face as f2f
    from livespeechportraits_torch.ops import rasterize_cuda
    from livespeechportraits_torch.pipeline import animate

    size = (512, 512)
    cand = animate._cand_stack(person, 512, lm.device, torch.bfloat16)
    down = f2f.precompute_cand_down(net, cand)
    forms = {
        "unsplit": lambda: f2f.apply_generator(
            net, rasterize_cuda.render_input(lm, sh, cand, size)),
        "split": lambda: f2f.apply_generator_edge(
            net, rasterize_cuda.render_input(lm, sh, None, size, dtype=torch.bfloat16), down)}
    out = {}
    with torch.no_grad():
        for name, fn in forms.items():
            ms = graph_ms(fn)
            events, _, _ = trace(fn)
            dev = sorted(events, key=lambda e: e.time_range.start)
            first = next((j for j, e in enumerate(dev) if SYMBOLS["K1"] in e.name), None)
            # without a K1 record (the profiler drops some), the trace's first kernels
            after = [(e.name[:70], round(e.time_range.elapsed_us() / 1e3, 4))
                     for e in (dev[first + 1:first + 5] if first is not None else dev[:5])]
            out[name] = {"device_ms": ms, "k1_in_trace": first is not None,
                         "device_records": len(dev), "kernels_after_k1": after}
            log("split_cand_forward", form=name, batch=lm.shape[0], device_ms=f"{ms:.4f}",
                k1_in_trace=first is not None, device_records=len(dev),
                kernels_after_k1=json.dumps(after))
    return out


def check_tools(dev, tmp: str, cfg, person, models) -> dict:
    """14b-14k.  The measurement tools at full width on the card, in this
    process unless named: trace_render ('large', B = 16, bf16 and int8),
    int8_probe, render_ablate, trace_train, stream_latency, prewarm_serving
    (twice, subprocesses), parity, train512, link_probe, upload_diet."""
    from livespeechportraits_torch.config import Feature2FaceConfig
    from livespeechportraits_torch.models import feature2face as f2f
    from livespeechportraits_torch.pipeline import animate, video
    from livespeechportraits_torch.utils import profiling

    out = {}
    # 14b: 'large' at 512^2, bf16 and int8
    rows = run_tool("trace_render", ["16", "1", "3"])
    render = {r["renderer"]: r for r in rows if r.get("row") == "render"}
    k4_forward = len(f2f.int8_conv_shapes(Feature2FaceConfig(size="large")))
    int8 = render["int8"]
    if not int8["psnr_int8_vs_bf16_db"] >= INT8_PSNR_DB:
        raise AssertionError(f"'large' int8 frames {int8['psnr_int8_vs_bf16_db']:.2f} dB from "
                             f"bf16 < {INT8_PSNR_DB}")
    if int8["k4_launches_per_batch"] != k4_forward or any(
            r["k1_launches_per_batch"] != 1 for r in render.values()):
        raise AssertionError(f"'large': K4 {int8['k4_launches_per_batch']} a forward (want "
                             f"{k4_forward}), K1 {[r['k1_launches_per_batch'] for r in render.values()]}")
    if not LARGE_GFLOP[0] < render["bf16"]["gflop_per_frame"] < LARGE_GFLOP[1]:
        raise AssertionError(f"'large' GFLOP a frame {render['bf16']['gflop_per_frame']}")
    out["large_launches"] = int8["k4_launches_per_batch"]
    out["large"] = {k: {"ms_per_batch": r["ms_per_batch"], "mfu_bf16_peak": r["mfu_bf16_peak"]}
                    for k, r in render.items()}
    # 14c: K4 against cuDNN's bf16 conv at the 14 'large' shapes
    rows = run_tool("int8_probe", ["16"])
    taken = [r for r in rows if r.get("k4") != "not_taken"]
    if len(rows) != 14 or len(taken) != 12 or any(r["k4_launches"] < 1 for r in taken):
        raise AssertionError("int8_probe: expected 14 shapes, K4 launched at 12")
    out["int8_probe"] = {r["conv"]: {"k4_ms": r.get("k4_ms", "not_taken"),
                                     "cudnn_bf16_ms": r["cudnn_bf16_ms"]} for r in rows}
    # 14d: the render with residual blocks removed
    run_tool("render_ablate", ["16", "1", "--variants", "full,minus_256sq_64ch,minus_leq32sq"])
    # 14e: the fused GAN step, 'large', B = 8
    step = run_tool("trace_train", ["8", "0", "3"])[0]
    if not step["losses_finite"] or step["k1_launches_per_step"] != 1:
        raise AssertionError(f"trace_train: {step}")
    # 14f: the live path, 'large' int8, chunk 16 (6e streams chunk 32)
    for r in run_tool("stream_latency", ["2", "512", "--quantize", "--chunks", "16",
                                         "--depths", "1"]):
        if r["frames"] != 105 or r["kernel_launches_per_push"]["K4"] <= 0:
            raise AssertionError(f"stream_latency: {r['frames']} frames, launches "
                                 f"{r['kernel_launches_per_push']}")
    # 14g: cold boot to first frame, then warm, each in its own process
    art = os.path.join(tmp, "serve_int8.npz")
    boots = []
    for _ in range(2):
        proc = subprocess.run([sys.executable, "-m",
                               "livespeechportraits_torch.tools.prewarm_serving",
                               "--artifact", art], capture_output=True, text=True, timeout=600,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
        rows = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
        for row in rows:
            print("[tool_prewarm_serving] " + json.dumps(row), flush=True)
        if proc.returncode != 0 or len(rows) != 2:
            raise AssertionError(f"prewarm_serving: rc {proc.returncode}\n{proc.stderr[-3000:]}")
        boots.append(rows[1])
    if boots[0]["artifact_existed"] or not boots[1]["artifact_existed"]:
        raise AssertionError("prewarm_serving: the first boot should write the artifact, the "
                             "second read it")
    # 14h: parity of two runs: the same seed, then another
    audio = video.make_test_tone(1.0)
    runs = {}
    for tag, seed in (("a", 0), ("b", 0), ("c", 1)):
        r = animate.animate(cfg, person, models, audio, seed=seed)
        np.save(os.path.join(tmp, f"{tag}.npy"), r.landmarks)
        video.write_video(r.frames, os.path.join(tmp, f"{tag}.avi"), audio)
        runs[tag] = r
    same = run_tool("parity", ["--landmarks_a", os.path.join(tmp, "a.npy"),
                               "--landmarks_b", os.path.join(tmp, "b.npy"),
                               "--video_a", os.path.join(tmp, "a.avi"),
                               "--video_b", os.path.join(tmp, "b.avi")])[0]
    other = run_tool("parity", ["--landmarks_a", os.path.join(tmp, "a.npy"),
                                "--landmarks_b", os.path.join(tmp, "c.npy"),
                                "--video_a", os.path.join(tmp, "a.avi"),
                                "--video_b", os.path.join(tmp, "c.avi")])[0]
    equal = np.array_equal(runs["a"].frames, runs["b"].frames)
    log("parity", same_seed_landmark_l2_px=same["landmark_l2_px"], same_seed_frames_equal=equal,
        other_seed_landmark_l2_px=other["landmark_l2_px"], other_seed_psnr_db=other["psnr_db"])
    if same["landmark_l2_px"] != 0 or not equal or not all(
            math.isfinite(other[k]) for k in ("landmark_l2_px", "psnr_db",
                                              "perceptual_distance")):
        raise AssertionError(f"parity: same seed {same}, other seed {other}")
    # 14i: the 512^2 'large' GAN campaign, cut to 8 steps at B = 4
    t512 = run_tool("train512", ["--steps", "4", "--batch", "4", "--frames", "80",
                                 "--fused_step", "--remat_depth", "2", "--vgg", "random",
                                 "--bench_steps", "3", "--checkpoints_dir",
                                 os.path.join(tmp, "t512")])[0]
    if not t512["losses_finite"] or t512["steps_trained"] < 4:
        raise AssertionError(f"train512: {t512}")
    # 14j: the device -> host link
    link = profiling.link_probe(dev)
    log("link_probe", **{k: f"{v:.4f}" if isinstance(v, float) else v for k, v in link.items()})
    # 14k: the training batches' uploads
    run_tool("upload_diet", ["--batch", "16", "--reps", "3"])
    return out


# ---------------------------------------------------------------------------
# 15. the fused motion half
# ---------------------------------------------------------------------------

# Fused against staged on the card, where they are not bitwise (see PERF.md):
# the landmarks in px and the head pose; frames within one level.
FUSED_LANDMARK_TOL_PX = 1e-4
FUSED_HEADPOSE_TOL = 1e-5
FUSED_FRAME_LEVELS = 1
# K5 against decode_step's loop on the same buffers, f32: the kernel sums in
# another order and the decode feeds each sample back (measured on an H100:
# 1.79e-7 on the samples of a 10 s decode of lspbench's may_large_int8
# subject); about 10x that, as tests/test_torch_cuda.py's DECODE_TOL
DECODE_TOL = 2e-6
DECODE_STATE = ("samples", "ring_flat", "x_prev", "row", "step")


def k5_bound(steps: int, ncenter: int):
    """K5's bound for a decode of ``steps`` steps (ms, what sets it): two
    f32 operations a weight of the WaveNet's matrices a step (the filter
    and gate taps on x_old and h, the residual, skip, start and end convs),
    and the bytes of the packed weights read once plus a step's rows (the
    filter and gate projections, the noise read, the sample written)."""
    from livespeechportraits_torch.ops import decode_cuda as dc

    L, R, S, I = dc.LAYERS * dc.BLOCKS, dc.RES, dc.SKIP, dc.INPUT
    E = (2 * I + 1) * ncenter
    weights = L * R * (5 * R + S) + R * (I + R) + E * (S + E)
    biases = L * (3 * R + S) + 2 * R + 2 * E
    nbytes = 4 * (weights + biases + steps * (2 * L * R + ncenter + 2 * I))
    return bound(nbytes, 2 * weights * steps, "f32")


def check_decode_kernel(dev, mg, b, smi: str) -> float:
    """K5 on bucket b's decode, primed by G1's replay (its audio and noise
    staged by the last request of that length), against decode_step's loop
    on a copy of the primed buffers: the samples, rings and x_prev within
    DECODE_TOL, row and step equal.  Logs K5's device ms (CUDA events, the
    compared launch) beside its bound; returns the ms."""
    from livespeechportraits_torch.models import audio2headpose as a2h_model

    model, a2h = mg.models.audio2headpose, mg.cfg.audio2headpose
    with torch.no_grad():
        b.g1.replay()
        twin = a2h_model.DecodeBuffers(model, a2h, mg.dec.rows, dev)
        for name in DECODE_STATE + ("fproj", "gproj", "gumbel", "eps"):
            getattr(twin, name).copy_(getattr(mg.dec, name))
        k5_ms = _event_ms(lambda: mg.g2(b.nframe))
        for _ in range(b.nframe):
            a2h_model.decode_step(model, a2h, twin, mg.sigma_scale)
    torch.cuda.synchronize()
    err = {k: _max_diff(getattr(mg.dec, k), getattr(twin, k)) for k in DECODE_STATE}
    bound_ms, by = k5_bound(b.nframe, a2h.ncenter)
    log("decode_kernel", steps=b.nframe, **{f"{k}_max": f"{v:.3e}" for k, v in err.items()},
        tol=DECODE_TOL, samples_scale=f"{float(twin.samples[:b.nframe].abs().max()):.4f}",
        row=int(mg.dec.row), k5_ms=f"{k5_ms:.4f}", us_per_step=f"{1e3 * k5_ms / b.nframe:.3f}",
        bound_ms=f"{bound_ms:.4f}", bound_by=by, share=f"{bound_ms / k5_ms:.4f}", card=repr(smi))
    if (any(err[k] > DECODE_TOL for k in ("samples", "ring_flat", "x_prev")) or err["row"]
            or err["step"] or int(mg.dec.row) != b.nframe):
        raise AssertionError(f"K5 over {b.nframe} steps against decode_step's loop: {err}")
    return k5_ms


def _max_diff(a, b) -> float:
    return float((a.float() - b.float()).abs().max().item())


def _event_ms(fn) -> float:
    """Device ms of fn() (enqueued work between two CUDA events)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def check_graph_recurrences(dev, mg, cfg, models, mel80, feats) -> dict:
    """K2 and K3 replayed from a CUDA graph at the request's shapes, each
    layer on the plain stack's input to it, against nn_core's plain layers
    on the card (RNN_TOL, phase 4's)."""
    from livespeechportraits_torch.models import audio2feature as a2f_model
    from livespeechportraits_torch.models import nn_core
    from livespeechportraits_torch.ops import recurrent_cuda

    T = feats.shape[0] // 2
    ff = cfg.audio2feature.frame_future
    pad = torch.cat([feats[:2 * T], feats[2 * T - 1:2 * T].expand(2 * ff, feats.shape[1])])
    a2f_in = a2f_model._downsample(models.audio2feature,
                                   pad.reshape(T + ff, -1))[None].contiguous()
    cases = []  # (kernel, wrapper, weights, input, plain output)
    x = mel80[None].contiguous()
    for rnn in models.apc.rnns:
        w = rnn.layer(0)
        y = nn_core.gru_layer(x, *w)[0]
        cases.append(("K2", recurrent_cuda.gru_layer, w, x, y))
        x = y.contiguous()
    x = a2f_in
    for k in range(models.audio2feature.LSTM.num_layers):
        w = models.audio2feature.LSTM.layer(k)
        y = nn_core.lstm_layer(x, *w)[0]
        cases.append(("K3", recurrent_cuda.lstm_layer, w, x, y))
        x = y.contiguous()
    outs = [None] * len(cases)

    def run():
        for i, (_, wrapper, w, xin, _) in enumerate(cases):
            outs[i] = wrapper(xin, *w)[0]

    g = mg.capture("K2_K3_at_request_shapes", run)
    outs_ref = list(outs)  # the graph's output tensors
    g.replay()
    torch.cuda.synchronize()
    err = {"K2": 0.0, "K3": 0.0}
    for (k, _, _, _, ref), got in zip(cases, outs_ref):
        err[k] = max(err[k], _max_diff(got, ref))
    log("fused_graph_recurrences", T_gru=mel80.shape[0], T_lstm=a2f_in.shape[1],
        graph_launches=json.dumps(g.launches), nodes=g.nodes,
        K2_max_abs_err=f"{err['K2']:.3e}", K3_max_abs_err=f"{err['K3']:.3e}", tol=RNN_TOL)
    if g.launches != {"K2": 3, "K3": 3} or max(err.values()) > RNN_TOL:
        raise AssertionError(f"fused: the graph's K2 / K3 {g.launches} differ from their "
                             f"plain twins by {err} > {RNN_TOL}")
    return err


def check_fused_motion(dev, pq, smi: str) -> dict:
    """15.  The fused motion half (pipeline/motion_graph.py) on the int8
    Predictor's subject at full width, 3.0 s of tone: (1) G1, G2 (one K5
    launch) and G3 once eagerly under torch's sync debug mode "error"; (2)
    the bucket's capture of G1 and G3: each graph's nodes, capture and
    instantiate ms and pool bytes (the decode is no graph); (3) fused
    against staged on the card (landmarks and head pose bitwise, or within
    FUSED_*_TOL with the first stage that differs named; frames within one
    level); (4) K2 and K3 in a profiled G1 replay,
    and replayed from a graph against their plain twins; K5 against
    decode_step's loop at the request's bucket and at the 10 s bucket
    (DECODE_TOL), its device ms beside its bound; (5) the request's
    motion ms and wall against the staged stages, median of 3, in turns;
    (6) a 3.0 s stream: its fused chunks engage and equal the per-stage
    stream; (7) a Predictor boot that captures every bucket to 10 s.
    Returns the K2 / K3 launches of the fused request's replays."""
    from livespeechportraits_torch import serve
    from livespeechportraits_torch.pipeline import (animate, motion_graph, streaming,
                                                    video)
    from livespeechportraits_torch.models import audio2headpose as a2h_model
    from livespeechportraits_torch.models import audio2feature as a2f_model
    from livespeechportraits_torch.ops import mel

    t_phase = time.perf_counter()
    cfg, person, models = pq._cfg, pq._assets, pq._models
    mg = motion_graph.for_models(cfg, person, models)
    audio = video.make_test_tone(3.0)
    n_mel = 360

    # (1) the three functions eagerly, then once more under sync debug
    mg.run(audio, graphs=False)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager = mg.run(audio, graphs=False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log("fused_sync_debug", functions="G1,G2(K5x165),G3", synchronizing_calls=0)

    # (2) capture
    mg.buckets.pop(n_mel, None)
    t0 = time.perf_counter()
    b = mg.prepare(n_mel)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    stats = {g.name: g.stats() for g in (b.g1, b.g3)}
    for name, st in stats.items():
        log("fused_graph", name=name, **{k: (json.dumps(v) if isinstance(v, dict) else v)
                                         for k, v in st.items()})
    log("fused_capture", bucket_n_mel=n_mel, seconds=f"{capture_s:.3f}",
        static_buffer_bytes=mg.nbytes(), card=repr(smi))

    # (3) fused against staged, the motion half and the frames
    torch.cuda.synchronize()
    staged_sm, fused_sm = {}, {}
    staged = animate.compute_motion(cfg, person, models, audio, stage_ms=staged_sm)
    fused = animate.compute_motion(cfg, person, models, audio, stage_ms=fused_sm, fused=True)
    names = ("landmarks", "shoulders", "headpose", "pts3d")
    diff = {k: _max_diff(f, s_) for k, f, s_ in zip(names, fused[:4], staged[:4])}
    eager_diff = {k: _max_diff(f, s_) for k, f, s_ in zip(names, eager[:4], staged[:4])}
    # where the first difference arises: G1's outputs against the staged
    # stages (A2F, the decode's conditioning), then the decode's samples
    mel80 = mel.compute_mel_sequence(audio, device=dev)
    feats = motion_graph.features(cfg, person, models, mel80)
    a2h = cfg.audio2headpose
    stage_diff = {
        "a2f": _max_diff(b.pred_feat, a2f_model.generate_sequence(
            models.audio2feature, feats, frame_future=cfg.audio2feature.frame_future)),
        "headpose_samples": _max_diff(mg.dec.samples[:b.nframe], a2h_model.generate_sequence(
            models.audio2headpose, a2h, feats, motion_graph.pre_headpose(cfg, dev),
            sigma_scale=a2h.sample_sigma_scale))}
    first = next((k for k, v in stage_diff.items() if v), "post" if any(diff.values())
                 else None)
    staged_r = animate.animate(cfg, person, models, audio, render_batch=16, transfer="rgb")
    fused_r = animate.animate(cfg, person, models, audio, render_batch=16, transfer="rgb",
                              fused=True)
    levels = int(np.abs(fused_r.frames.astype(int) - staged_r.frames.astype(int)).max())
    log("fused_vs_staged", **{f"{k}_max": f"{v:.3e}" for k, v in diff.items()},
        eager_vs_staged=json.dumps(eager_diff), stage_diff=json.dumps(stage_diff),
        first_differing_stage=first, frame_max_levels=levels,
        tol_px=FUSED_LANDMARK_TOL_PX, tol_headpose=FUSED_HEADPOSE_TOL)
    if fused[4] != staged[4] or any(eager_diff.values()):
        raise AssertionError(f"fused: eager functions differ from the staged path {eager_diff}")
    if not (diff["landmarks"] <= FUSED_LANDMARK_TOL_PX and diff["headpose"] <= FUSED_HEADPOSE_TOL
            and levels <= FUSED_FRAME_LEVELS):
        raise AssertionError(f"fused: the replayed graphs differ from staged: {diff}, "
                             f"{levels} levels (first at {first})")

    # (4) K2 and K3 in a profiled replay of G1, and at its shapes against
    # their twins
    # Three replays a trace: the profiler can miss the kernels at the start
    # of its window (on an H100 a one-replay trace has held K3's launches
    # and none of K2's), so each kernel must show at least one replay's.
    found, events = None, []
    for _ in range(3):  # the profiler may drop a trace's device records
        events, _, _ = trace(lambda: [b.g1.replay() for _ in range(3)])
        counts = {k: kernel_device_ms(events, SYMBOLS[k])[1] for k in ("K2", "K3")}
        if events:
            found = counts
            if all(counts[k] >= b.g1.launches[k] for k in counts):
                break
    log("fused_g1_trace", replays=3, kernels=json.dumps(found) if found else "not_measured",
        g1_launches=json.dumps(b.g1.launches))
    if found is not None and not all(found[k] >= b.g1.launches[k] for k in found):
        raise AssertionError(f"fused: K2 / K3 not in traced G1 replays: {found}; the last "
                             f"trace's {len(events)} device events: "
                             f"{top_kernels(events, 12)}")
    rnn_err = check_graph_recurrences(dev, mg, cfg, models, mel80, feats)

    # K5 against its plain twin at the request's bucket and at the 10 s
    # bucket (585 steps); device ms of G1's and G3's replays and K5's
    g2_ms = check_decode_kernel(dev, mg, b, smi) / b.nframe
    g1_ms = _event_ms(b.g1.replay)
    g3_ms = _event_ms(b.g3.replay)
    log("fused_device_ms", g1=f"{g1_ms:.4f}", g2_per_step=f"{g2_ms:.5f}", g3=f"{g3_ms:.4f}",
        g2_x_nframe=f"{g2_ms * b.nframe:.3f}", nframe=b.nframe)
    mg.run(video.make_test_tone(10.0))
    check_decode_kernel(dev, mg, mg.buckets[1200], smi)

    # (5) the request as predict() runs it (int8, yuv420, batch 16), fused
    # and staged in turns, median of 3
    ff = a2h.frame_future
    valid = int(len(audio) / 16000 * 60)
    zero_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    req = pq.predict(audio, write_video=False)
    torch.cuda.synchronize()
    main_wall = time.perf_counter() - t0
    main_launches = launch_counts()
    main_replayed = dict(motion_graph.REPLAYED_LAUNCHES)
    walls = {"staged": [], "fused": []}
    sms = {"staged": [], "fused": []}
    for mode in ("staged", "fused", "fused", "staged", "staged", "fused"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if mode == "fused":
            res = pq.predict(audio, write_video=False)
        else:
            res = animate.animate(cfg, person, models, audio, render_batch=16,
                                  transfer="yuv420", valid_frames=valid)
        torch.cuda.synchronize()
        walls[mode].append(time.perf_counter() - t0)
        sms[mode].append(res.stage_ms)
    med = {m: float(np.median(v)) for m, v in walls.items()}

    def med_stage(mode, k):
        return float(np.median([sm[k] for sm in sms[mode]]))

    staged_motion = sum(med_stage("staged", k) for k in ("mel_apc", "lle", "audio2mouth",
                                                         "headpose", "post"))
    log("fused_request", audio_s=3.0, nframe=req.nframe, card=repr(smi),
        fused_wall_s=f"{med['fused']:.4f}", staged_wall_s=f"{med['staged']:.4f}",
        fused_fps=f"{req.nframe / med['fused']:.2f}",
        staged_fps=f"{req.nframe / med['staged']:.2f}",
        fused_motion_ms=f"{med_stage('fused', 'motion'):.3f}",
        staged_headpose_ms=f"{med_stage('staged', 'headpose'):.3f}",
        staged_motion_stages_ms=f"{staged_motion:.3f}",
        fused_render_device_ms=f"{med_stage('fused', 'render_device'):.3f}",
        staged_render_device_ms=f"{med_stage('staged', 'render_device'):.3f}",
        walls=json.dumps({m: [round(w, 4) for w in v] for m, v in walls.items()}),
        main_wall_s=f"{main_wall:.4f}", launches=json.dumps(main_launches),
        replayed=json.dumps(main_replayed),
        fused_stage_ms=json.dumps({k: round(v, 3) for k, v in sms["fused"][0].items()}))
    if (req.nframe != valid - ff or main_replayed != {"K2": 3, "K3": 3}
            or main_launches["K5"] != 1):
        raise AssertionError(f"fused request: {req.nframe} frames, replayed {main_replayed}, "
                             f"{main_launches['K5']} K5 launches")

    # (6) a 3.0 s stream (int8, chunk 32, batch 8, 100 ms pushes, depth 1):
    # the fused chunks against the per-stage stream
    def stream(fused_on: bool):
        st = streaming.StreamingAnimator(cfg, person, models, chunk=32, render_batch=8,
                                         pipeline_depth=1, transfer="yuv420")
        if not fused_on:
            st._advance_stream_fused = lambda: False
            st._advance_motion_fused = lambda: False
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames = np.concatenate(list(st.run(audio, push_samples=1600)))
        return frames, time.perf_counter() - t0, st.stage_ms

    stream(True)  # the chunk graphs' capture
    per_stage, per_wall, per_sm = stream(False)
    fused_frames, fused_wall, fused_sm2 = stream(True)
    d = np.abs(fused_frames.astype(int) - per_stage.astype(int))
    within = float((d <= 1).mean())
    log("fused_stream", audio_s=3.0, nframe=len(fused_frames), card=repr(smi),
        mega_chunks=fused_sm2.get("mega_chunks", 0), fused_chunks=fused_sm2.get("fused_chunks", 0),
        bitwise=bool(np.array_equal(fused_frames, per_stage)), max_levels=int(d.max()),
        within_1=f"{within:.6f}", share_tol=STREAM_FRAME_SHARE,
        fused_wall_s=f"{fused_wall:.4f}", per_stage_wall_s=f"{per_wall:.4f}",
        fused_a2h_ms=f"{fused_sm2.get('a2h', 0.0):.3f}",
        fused_stream_fused_ms=f"{fused_sm2.get('stream_fused', 0.0):.3f}",
        per_stage_a2h_ms=f"{per_sm.get('a2h', 0.0):.3f}",
        fused_stage_ms=json.dumps({k: round(v, 3) for k, v in fused_sm2.items()}),
        per_stage_stage_ms=json.dumps({k: round(v, 3) for k, v in per_sm.items()}))
    if (fused_sm2.get("mega_chunks", 0) < 3 or fused_frames.shape != per_stage.shape
            or within < STREAM_FRAME_SHARE):
        raise AssertionError("fused stream: the fused chunks did not engage or differ")

    # (7) a Predictor boot that captures every bucket to 10 s
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pb = serve.Predictor(device=dev, max_audio_seconds=10.0)
    pb.setup("Synthetic", image_size=512)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    graphs = pb.prewarm()
    torch.cuda.synchronize()
    prewarm_s = time.perf_counter() - t0
    total = {k: sum(g[k] or 0 for g in graphs.values())
             for k in ("nodes", "capture_ms", "instantiate_ms", "pool_bytes")}
    log("fused_boot", setup_s=f"{setup_s:.3f}", prewarm_s=f"{prewarm_s:.3f}",
        graphs=len(graphs), buckets=len(pb.bucket_lengths()), card=repr(smi),
        **{f"total_{k}": (f"{v:.3f}" if isinstance(v, float) else v) for k, v in total.items()},
        g1_10s=json.dumps(graphs.get(f"G1[{pb.bucket_lengths()[-1]}]")),
        static_buffer_bytes=motion_graph.for_models(pb._cfg, pb._assets,
                                                    pb._models).nbytes())
    if len(graphs) != 2 * len(pb.bucket_lengths()):
        raise AssertionError(f"fused boot: {len(graphs)} graphs for "
                             f"{len(pb.bucket_lengths())} buckets")
    del pb
    log("phase15", seconds=f"{time.perf_counter() - t_phase:.1f}")
    return {"replayed": main_replayed, "rnn_err": rnn_err, "g1": stats[b.g1.name]}


# ---------------------------------------------------------------------------
# 16. the renderer's inference rewrites
# ---------------------------------------------------------------------------

# the rewrite forms (assets.REWRITE_FORMS) with an int8 up conv of their own on K4
K4_FORMS = ("four", "single", "dilated", "split")
# Phase 16's bounds, set before its first call on the card (PSNR of the
# [-1, 1] frames, 'normal' at 512^2, bf16): a float form against the
# unrewritten float renderer (the forms sum in other orders; a wrong phase
# or tap measures ~10-15 dB); the split int8 renderer against the unsplit one
# (its int8 part is held bitwise; its float to-RGB up conv, split into two
# summed convs as JAX's is, rounds once more in bf16).
REWRITE_FLOAT_PSNR_DB = 30.0
REWRITE_SPLIT_PSNR_DB = 40.0


def k4_up_bound(B: int, size: int, cin: int, cout: int):
    """The least time of one int8 up conv, whatever its form: the coarse
    [B, Cin, size/2, size/2] bf16 input read once, the 3x3 int8 weights, the
    fine [B, Cout, size, size] bf16 output written once; the four-phase
    form's operations, 2 * B * size^2 * Cout * 4 * Cin (each output pixel
    reads 2 x 2 coarse taps: the work the function needs)."""
    h = size // 2
    nbytes = B * h * h * cin * 2 + 9 * cin * cout + B * size * size * cout * 2
    return bound(nbytes, 2 * B * size * size * cout * 4 * cin, "int8")


def k4_form_operands(form: str, B: int, size: int, cin: int, cout: int, n_a: int, dev,
                     seed: int):
    """One int8 up conv of 'normal' under a form: the coarse bf16 activation
    on k4_inputs' 1/8 grid (split: the pair, n_a channels and the rest), an
    int8 one of the same shape, the form's int8 weights (four: [4 Co, Ci,
    2, 2]; single: [4 Co, Ci, 3, 3]; dilated: [Co, Ci, 4, 4]; split: [Co,
    Ci, 3, 3]), r, its scale ([4, Co], [4 Co] or [Co]) and bias ([Co]; none
    for single, whose layer adds it after the phase shuffle)."""
    cl = torch.channels_last
    x, _, r, _, bias = k4_inputs(B, size // 2, cin, cout, dev, seed)
    g = torch.Generator().manual_seed(seed + 1)
    x_q = torch.randint(-127, 128, tuple(x.shape), generator=g, dtype=torch.int8)
    x_q = x_q.to(dev).contiguous(memory_format=cl)
    wshape = {"four": (4 * cout, cin, 2, 2), "single": (4 * cout, cin, 3, 3),
              "dilated": (cout, cin, 4, 4), "split": (cout, cin, 3, 3)}[form]
    w = torch.randint(-127, 128, wshape, generator=g, dtype=torch.int8).to(dev)
    w = w.contiguous(memory_format=cl)
    sshape = {"four": (4, cout), "single": (4 * cout,)}.get(form, (cout,))
    scale = (torch.rand(sshape, generator=g) * 1e-5).to(dev, torch.bfloat16)
    if form == "split":
        x, x_q = [(t[:, :n_a].contiguous(memory_format=cl), t[:, n_a:].contiguous(memory_format=cl))
                  for t in (x, x_q)]
    return x, x_q, w, r, scale, None if form == "single" else bias


def k4_form(form: str, x, w, r=None, scale=None, bias=None, plain: bool = False):
    """The form's K4 wrapper (or its plain twin) on the operands: int32 sums
    for int8 x, else the fused quantize and rescale.  x is the pair for
    split; single is the 3x3 conv at 4 Co outputs."""
    from livespeechportraits_torch.ops import q8conv_cuda as q8

    if form == "four":
        return (q8.subpixel_plain if plain else q8.subpixel_q8)(x, w, r, scale, bias)
    if form == "dilated":
        return (q8.dilated_plain if plain else q8.dilated_q8)(x, w, r, scale, bias)
    if form == "split":
        return (q8.split_plain if plain else q8.split_q8)(x[0], x[1], w, r, scale, bias)
    if r is None:
        return (q8.conv_s8_plain if plain else q8.conv_s8)(x, w, 1, 1)
    return (q8.conv_q8_plain if plain else q8.conv_q8)(x, r, w, 1, 1, scale, bias)


def float_form_layer(form: str, w, n_a: int):
    """The float layer of the form (bf16, the int8 weights' values): the
    cuDNN yardstick of its K4 form."""
    from livespeechportraits_torch.models import nn_core

    cl = torch.channels_last
    wb = w.to(torch.bfloat16).contiguous(memory_format=cl)
    shape = (3, w.shape[1], w.shape[0], 1, 1)
    if form == "split":
        return nn_core.UpConvSplit({"w_a": wb[:, :n_a].contiguous(memory_format=cl),
                                    "w_b": wb[:, n_a:].contiguous(memory_format=cl)}, shape)
    cls = {"four": nn_core.UpConvSubpixel, "single": nn_core.UpConvSubpixel1,
           "dilated": nn_core.UpConvDilated}[form]
    return cls({cls.FLOAT[0]: wb}, shape)


def check_k4_rewrite_forms(dev, B: int = 16) -> dict:
    """16a.  K4's rewrite forms at every int8 up conv of 'normal' at 512^2
    (feature2face.int8_up_convs), B = 16: bitwise against the plain twins in
    the int32 mode and the fused bf16 mode (ties and values past +-127, as
    6c's inputs), device ms a call by CUDA-graph replay (four: its four
    launches) beside the bound (k4_up_bound), the plain twin's ms (CUDA
    events, one call) and cuDNN's bf16 conv of the same float form and of
    the unrewritten upsample + 3x3 conv."""
    from livespeechportraits_torch import _build
    from livespeechportraits_torch.config import Feature2FaceConfig
    from livespeechportraits_torch.models import feature2face as f2f
    from livespeechportraits_torch.models import nn_core
    from livespeechportraits_torch.ops import q8conv_cuda as q8

    regs = ptxas_report.summary(_build.build_logs.get("q8conv.cu", ""), gather_label)
    log("ptxas_gather", instances=json.dumps(regs))
    # 10 instances a side: (int8 | f32 | bf16) x (64 | 128) x (int32 | fused, int8 int32
    # only), without the forms (a plain launch's) and with them (a rewrite's)
    if len(regs) != 20 or any(v["spill_stores"] or v["spill_loads"] for v in regs.values()):
        raise AssertionError(f"K4's gather kernel spills, or ptxas -v listed {len(regs)} "
                             f"instances, not 20: {regs}")
    ups = f2f.int8_up_convs(Feature2FaceConfig())
    out = {}
    for form in K4_FORMS:
        rows = []
        for j, (size, cin, cout, n_a) in enumerate(ups):
            if form == "split" and not n_a:
                continue  # the innermost up conv reads one map: no split
            x, x_q, w, r, scale, bias = k4_form_operands(form, B, size, cin, cout, n_a, dev,
                                                         400 + j)
            before = q8.LAUNCHES
            got32 = k4_form(form, x_q, w)
            launches = q8.LAUNCHES - before
            got = k4_form(form, x, w, r, scale, bias)
            ref32 = k4_form(form, x_q, w, plain=True)
            ref = k4_form(form, x, w, r, scale, bias, plain=True)
            torch.cuda.synchronize()
            n32, nbf = int((got32 != ref32).sum()), int((got != ref).sum())
            dev_ms = graph_ms(lambda: k4_form(form, x, w, r, scale, bias))
            plain_ms = cuda_ms(lambda: k4_form(form, x, w, r, scale, bias, plain=True), reps=1,
                               warmup=1)
            layer = float_form_layer(form, w, n_a)
            xf = x if form == "split" else (x,)
            cudnn_ms = graph_ms(lambda: layer(*xf))
            cat = torch.cat(xf, 1) if form == "split" else x
            w3 = torch.randn(cout, cin, 3, 3, device=dev, dtype=torch.bfloat16).contiguous(
                memory_format=torch.channels_last)
            up_ms = graph_ms(lambda: torch.nn.functional.conv2d(
                nn_core.upsample_nearest_2x(cat), w3, padding=1))
            bound_ms, bound_by = k4_up_bound(B, size, cin, cout)
            log("K4_rewrite", form=form, shape=f"{size // 2}^2->{size}^2:{cin}->{cout}",
                n_a=n_a, launches_per_call=launches, int32_mismatched=n32,
                bf16_mismatched=nbf, device_ms=f"{dev_ms:.4f}", bound_ms=f"{bound_ms:.4f}",
                bound_by=bound_by, share=f"{bound_ms / dev_ms:.3f}", plain_ms=f"{plain_ms:.4f}",
                cudnn_bf16_form_ms=f"{cudnn_ms:.4f}",
                cudnn_bf16_upsample_conv_ms=f"{up_ms:.4f}")
            if n32 or nbf or tuple(got.shape) != (B, cout, size, size) and form != "single":
                raise AssertionError(f"K4 {form} at {size}^2 {cin}->{cout}: {n32} int32 and {nbf} "
                                     f"bf16 values differ from the plain twin, shape "
                                     f"{tuple(got.shape)}")
            rows.append({"shape": [size, cin, cout, n_a], "device_ms": dev_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by, "plain_ms": plain_ms,
                         "cudnn_bf16_form_ms": cudnn_ms, "cudnn_bf16_upsample_conv_ms": up_ms,
                         "launches_per_call": launches})
        out[form] = {"shapes": rows,
                     "device_ms_all_up_convs": sum(r["device_ms"] for r in rows),
                     "bound_ms_all_up_convs": sum(r["bound_ms"] for r in rows),
                     "cudnn_bf16_form_ms_all_up_convs": sum(r["cudnn_bf16_form_ms"]
                                                            for r in rows)}
    # a second source whose first has channels % 64 != 0 is refused on the card
    a = torch.zeros(1, 32, 4, 4, device=dev, dtype=torch.int8).contiguous(
        memory_format=torch.channels_last)
    try:
        q8.split_q8(a, a, torch.zeros(8, 64, 3, 3, device=dev, dtype=torch.int8).contiguous(
            memory_format=torch.channels_last))
    except ValueError:
        pass
    else:
        raise AssertionError("split_q8 took a first source of 32 channels on the card")
    out["ptxas_gather"] = regs
    return out


def _inner_pair(net, x):
    """The (skip, inner output) pair the outermost up conv reads: the int8
    part of a forward."""
    from livespeechportraits_torch.models import feature2face as f2f

    inner = next(m for m in net.netG.model.model if isinstance(m, f2f.ResUnetBlock))
    got = []
    handle = inner.register_forward_hook(lambda m, i, o: got.append(o))
    try:
        y = f2f.apply_generator(net, x)
    finally:
        handle.remove()
    return got[0], y


def _db(a, b) -> float:
    """PSNR of two [-1, 1] frame batches (peak 2)."""
    mse = float(((a.double() - b.double()) ** 2).mean())
    return float("inf") if mse == 0 else 10 * math.log10(4.0 / mse)


def check_rewrite_generators(dev, pq) -> dict:
    """16b.  Whole 'normal' generators at 512^2, B = 16, bf16, on one batch
    of the chirp's render inputs: each float form (four, single, dilated,
    split, s2d) against the unrewritten float renderer; the split int8 tree
    against the unsplit one (the pair its outermost up conv reads bitwise,
    the frame within REWRITE_SPLIT_PSNR_DB); four, single, dilated, s2d +
    four and s2d + split int8 against the float frames (INT8_PSNR_DB);
    apply_generator_edge (split_cand) on the split int8 tree against its full
    forward.  Each forward's K4 launches against feature2face.k4_launches,
    its device ms by CUDA-graph replay."""
    from livespeechportraits_torch.models import feature2face as f2f
    from livespeechportraits_torch.models import nn_core
    from livespeechportraits_torch.ops import q8conv_cuda
    from livespeechportraits_torch.pipeline import animate, assets

    cfg, person, models = pq._cfg, pq._assets, pq._models
    x = animate.build_render_inputs(cfg, person, models, chirp(1.7), max_frames=16)
    fnet = f2f.cast_generator(assets.init_models(cfg, assets.synthetic_seed(cfg)).feature2face
                              .to(dev), torch.bfloat16)
    qnet = models.feature2face
    tr = lambda net, **kw: assets.transform_person_models(  # noqa: E731
        dataclasses.replace(models, feature2face=net), **kw).feature2face
    nets = {"float": fnet, "int8": qnet}
    for form in K4_FORMS + ("s2d",):
        nets[f"float_{form}"] = tr(fnet, **REWRITE_FORMS[form])
    for form in K4_FORMS + ("s2d+four", "s2d+split"):
        nets[f"int8_{form}"] = tr(qnet, **REWRITE_FORMS[form])
    out = {}
    with torch.no_grad():
        ref = {"float": f2f.apply_generator(fnet, x)}
        pair_q, ref["int8"] = _inner_pair(qnet, x)
        for name, net in nets.items():
            q8conv_cuda.LAUNCHES = 0
            if name == "int8_split":
                pair, y = _inner_pair(net, x)
                pair_equal = all(torch.equal(u, v) for u, v in zip(pair, pair_q))
            else:
                y = f2f.apply_generator(net, x)
            launches = q8conv_cuda.LAUNCHES
            ms = graph_ms(lambda: f2f.apply_generator(net, x))
            row = {"device_ms": ms, "k4_launches": launches,
                   "psnr_vs_float_db": _db(y, ref["float"]),
                   "psnr_vs_int8_db": _db(y, ref["int8"]),
                   "max_abs_vs_int8": float((y - ref["int8"]).abs().max())}
            want_db = (REWRITE_FLOAT_PSNR_DB if name.startswith("float_") else
                       INT8_PSNR_DB if name.startswith("int8_") else None)
            ok = launches == f2f.k4_launches(net) and torch.isfinite(y).all()
            if want_db is not None and not row["psnr_vs_float_db"] >= want_db:
                ok = False
            if name == "int8_split":
                row["inner_pair_bitwise"] = pair_equal
                ok = ok and pair_equal and row["psnr_vs_int8_db"] >= REWRITE_SPLIT_PSNR_DB
            log("rewrite_generator", net=name, batch=x.shape[0], psnr_bound_db=want_db,
                **{k: (f"{v:.4f}" if isinstance(v, float) else v) for k, v in row.items()})
            if not ok:
                raise AssertionError(f"rewrite {name}: {row}, K4 launches want "
                                     f"{f2f.k4_launches(net)}")
            out[name] = row
        # split_cand on the split int8 tree
        net = nets["int8_split"]
        cand_down = f2f.precompute_cand_down(net, x[0, ..., 1:])
        y_edge = f2f.apply_generator_edge(net, x[..., :1].contiguous(), cand_down)
        db = _db(y_edge, f2f.apply_generator(net, x))
        log("rewrite_split_cand", net="int8_split", psnr_vs_full_db=f"{db:.2f}",
            bound_db=SPLIT_BOUNDS["int8_yuv420"][0])
        if not db >= SPLIT_BOUNDS["int8_yuv420"][0]:
            raise AssertionError(f"split_cand on the split tree: {db:.2f} dB from its full "
                                 "forward")
        out["int8_split"]["split_cand_psnr_db"] = db
    del nets, fnet
    return out


def check_rewrite_requests(dev, pq, tmp: str) -> dict:
    """16c.  A 3.0 s request served fused by a Predictor booted from an
    artifact the port wrote of the int8 Predictor's models under split-skip,
    then under subpixel "single": frames against the unrewritten Predictor's
    (split within REWRITE_SPLIT_PSNR_DB, single within INT8_PSNR_DB), K1
    once a batch and K4 feature2face.k4_launches a batch (the counts set to
    0 just before), render_device of each beside the unrewritten one's
    (turns: unrewritten, rewritten, rewritten, unrewritten)."""
    from livespeechportraits_torch import serve
    from livespeechportraits_torch.models import feature2face as f2f
    from livespeechportraits_torch.pipeline import assets, video

    audio = video.make_test_tone(3.0)
    ref = pq.predict(audio, write_video=False)
    batches = math.ceil(ref.nframe / 16)
    out = {}
    for form in ("split", "single"):
        art = os.path.join(tmp, f"serving_int8_{form}.npz")
        assets.save_models_artifact(assets.transform_person_models(pq._models,
                                                                   **REWRITE_FORMS[form]), art)
        p = serve.Predictor(device=dev, results_dir=os.path.join(tmp, form))
        p.setup("Synthetic", image_size=512, artifact=art)
        p.predict(audio[:16000], write_video=False)  # warm
        zero_launch_counts()
        torch.cuda.synchronize()
        res = p.predict(audio, write_video=False)
        torch.cuda.synchronize()
        launches = launch_counts()
        per_batch = f2f.k4_launches(p._models.feature2face)
        walls = {"unrewritten": [], form: []}
        for who in ("unrewritten", form, form, "unrewritten"):
            r = (pq if who == "unrewritten" else p).predict(audio, write_video=False)
            walls[who].append(r.stage_ms["render_device"])
        d = np.abs(res.frames.astype(int) - ref.frames.astype(int))
        db = psnr(res.frames, ref.frames)
        want_db = REWRITE_SPLIT_PSNR_DB if form == "split" else INT8_PSNR_DB
        row = {"nframe": res.nframe, "psnr_vs_unrewritten_db": db, "max_levels": int(d.max()),
               "frames_equal": float((d == 0).mean()), "launches": launches,
               "k4_launches_per_batch": per_batch, "render_device_ms": walls[form],
               "unrewritten_render_device_ms": walls["unrewritten"],
               "artifact_mb": os.path.getsize(art) / 2 ** 20}
        log("rewrite_request", form=form, psnr_bound_db=want_db,
            **{k: (json.dumps(v) if isinstance(v, (dict, list)) else
                   f"{v:.4f}" if isinstance(v, float) else v) for k, v in row.items()})
        if (res.nframe != ref.nframe or not db >= want_db or launches["K1"] != batches
                or launches["K4"] != per_batch * batches):
            raise AssertionError(f"rewrite request {form}: {row}, want K1 {batches} and K4 "
                                 f"{per_batch * batches}")
        out[form] = row
        del p
    return out


def check_rewrite_large() -> dict:
    """16d.  The 'large' renderer (ngf 64, 8 downsamplings, 2 residual blocks
    a stage) at 512^2, B = 16: int8 unrewritten, split and single
    (tools/trace_render --rewrites split,single): ms a batch, the device
    table by family with upsample + concat read out, generator_flops the
    same for every renderer.  Records numbers; claims nothing."""
    from livespeechportraits_torch.config import Feature2FaceConfig
    from livespeechportraits_torch.models import feature2face as f2f

    rows = run_tool("trace_render", ["16", "1", "3", "--rewrites", "split,single"])
    render = {r["renderer"]: r for r in rows if r.get("row") == "render"}
    fams = {r["renderer"]: r for r in rows if r.get("row") == "families"}
    k4_forward = len(f2f.int8_conv_shapes(Feature2FaceConfig(size="large")))
    flops_set = {r["gflop_per_frame_of_model"] for k, r in render.items() if k != "bf16"}
    out = {}
    for name in ("int8", "int8_split", "int8_single"):
        r, fam = render[name], fams[name]["device_ms_per_batch"]
        up_cat = fam.get("nearest upsample and concat") if isinstance(fam, dict) else None
        log("rewrite_large", renderer=name, ms_per_batch=f"{r['ms_per_batch']:.4f}",
            upsample_and_concat_device_ms=up_cat, k4_launches_per_batch=r["k4_launches_per_batch"],
            psnr_vs_bf16_db=f"{r['psnr_int8_vs_bf16_db']:.2f}",
            gflop_per_frame_of_model=r["gflop_per_frame_of_model"])
        if (r["k4_launches_per_batch"] != k4_forward or not r["psnr_int8_vs_bf16_db"]
                >= INT8_PSNR_DB):
            raise AssertionError(f"'large' {name}: {r}")
        out[name] = {"ms_per_batch": r["ms_per_batch"], "families_device_ms_per_batch": fam,
                     "upsample_and_concat_device_ms": up_cat}
    if len(flops_set) != 1:
        raise AssertionError(f"generator_flops differs between the renderers: {flops_set}")
    return out


def check_rewrites(dev, pq, tmp: str) -> dict:
    """16.  The renderer's inference rewrites on the card; returns K4's
    rewrite_forms entry."""
    t0 = time.perf_counter()
    forms = check_k4_rewrite_forms(dev)
    gens = check_rewrite_generators(dev, pq)
    reqs = check_rewrite_requests(dev, pq, tmp)
    large = check_rewrite_large()
    entry = {}
    for form in K4_FORMS:
        entry[form] = dict(forms[form], generator_k4_launches=gens[f"int8_{form}"]["k4_launches"],
                           generator_device_ms=gens[f"int8_{form}"]["device_ms"],
                           request_launches=reqs.get(form, {}).get("launches", {}).get("K4"))
    entry["ptxas_gather"] = forms["ptxas_gather"]
    entry["generators"] = gens
    entry["requests"] = reqs
    entry["large"] = large
    log("phase16", seconds=f"{time.perf_counter() - t0:.1f}")
    return entry


# ---------------------------------------------------------------------------
# 17. the model axis: spatial and channel partitioning over a rank grid
# ---------------------------------------------------------------------------

# Phase 17's bounds (see PERF.md)
GRID_FRAME_SHARE = 0.999  # 17a, 17b: share of frame values within one level of one device's
# 17b / 17d compare the QAT steps in f32 with TF32 off, where the training
# BatchNorms of the inner stages (2 x 2 maps) divide by small variances and
# an activation that rounds to the next int8 step moves every layer after it
# (13d's note: f32 gradients of a batch of 4 and of 8 differ by up to 7.5e-3
# of a tensor's norm through rounding alone; on the CPU the two-rank QAT
# step's frames differ from one process's by 0.1 in f32, 1e-18 in float64)
# rounding alone).  The float step is held in float64 at 13d's tolerances;
# the QAT steps by their eval-mode frames (within one level, as 17a's), which
# the BatchNorms' batch statistics do not feed
# 17d, the eval-mode frame of two data ranks against one process: with the
# one scale each rank's rows are one process's up to the convs' other batch
# sizes; with a scale per rank the half of smaller range snaps to another
# int8 grid.  The repaired mean difference must be this many times below the
# fault's, and each eval scale within DATA_QAT_SCALE_RTOL of one process's.
DATA_QAT_FAKE_MARGIN = 10.0
DATA_QAT_SCALE_RTOL = 1e-5
# 17c: the dry run's line (JAX's format) and the loss gap of its grids of one
# data axis, (4x2) and (4x4), which train on the same rows
DRYRUN_LINE = re.compile(r"dryrun_multichip ok: mesh=\((\d+)x(\d+)\) loss_D=(-?\d+\.\d{4}) "
                         r"loss_G=(-?\d+\.\d{4}) sp_render=ok int8_dp_serve=ok$")
DRYRUN_SAME_ROWS_RTOL = 1e-4


def _event_wall(fn, reps: int, warm: bool = True) -> float:
    """ms a call of fn by CUDA events around reps calls (after one warm-up
    call unless warm is False)."""
    if warm:
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# 17a's trees: the unrewritten bf16 and calibrated int8 renderers, the int8
# split-skip and single trees (the forms that cut the 'large' int8 batch's
# time: phase 16) and the float single tree
SPATIAL_TREES = ("float", "int8", "int8_split", "int8_single", "float_single")


def _spatial_rank(dev, work: str) -> dict:
    """17a on one of two model ranks: K1's render input of the 16 frames,
    this rank's 256 rows, each of SPATIAL_TREES (sharding.apply_generator_spatial),
    each K4 layer's output rows (the rewritten ones' included) against the
    one-device forward's (computed here too, on the whole batch), the
    frames gathered, ms a forward beside one device's, K1 / K4 launches and
    the bytes exchanged a forward."""
    import torch.distributed as dist

    from livespeechportraits_torch.models import feature2face as f2f
    from livespeechportraits_torch.models import nn_core
    from livespeechportraits_torch.ops import q8conv_cuda, rasterize_cuda
    from livespeechportraits_torch.parallel import mesh, sharding

    grid = mesh.make_grid(2)
    inp = torch.load(os.path.join(work, "spatial.pt"), map_location=dev, weights_only=False)
    zero_launch_counts()
    size = inp["cand"].shape[-2]
    x = rasterize_cuda.render_input(inp["lm"], inp["sh"], inp["cand"], (size, size))
    out = {"k1_launches": rasterize_cuda.LAUNCHES, "rows": size // grid.model_size}
    slab = sharding.shard_spatial(x, grid, axis=1)
    for name in SPATIAL_TREES:
        model = inp[name]
        ref_out, orig = {}, nn_core.conv2d_q8

        def record(xq, layer, stride, padding):
            y = orig(xq, layer, stride, padding)
            ref_out[id(layer)] = y
            return y

        hooks = [m.register_forward_hook(lambda m, i, o: ref_out.__setitem__(id(m), o))
                 for m in model.modules() if isinstance(m, nn_core.REWRITES) and m.quantized]
        nn_core.conv2d_q8 = record
        try:
            with torch.no_grad(), mesh.use_grid(mesh.LOCAL):
                ref = f2f.apply_generator(model, x)
        finally:
            nn_core.conv2d_q8 = orig
            for h in hooks:
                h.remove()
        taps = []
        q8conv_cuda.LAUNCHES = 0
        sharding.EXCHANGED_BYTES = 0
        y = sharding.apply_generator_spatial(model, slab, grid, taps=taps)
        k4 = q8conv_cuda.LAUNCHES
        exchanged = sharding.EXCHANGED_BYTES
        q8 = [(layer, rows, r0) for layer, rows, r0 in taps  # the int8 layers, on K4
              if isinstance(layer, nn_core.QConv2d)
              or isinstance(layer, nn_core.REWRITES) and layer.quantized]
        equal = sum(torch.equal(ref_out[id(layer)][:, :, r0:r0 + rows.shape[2]], rows)
                    for layer, rows, r0 in q8)
        frames = sharding.gather_spatial(y, grid, axis=1)
        diff = (f2f.to_uint8(frames).int() - f2f.to_uint8(ref).int()).abs()
        ms = _event_wall(lambda: sharding.apply_generator_spatial(model, slab, grid), 3)
        dist.barrier()
        one_ms = None
        if grid.model_index == 0:  # one device alone, the other rank waiting
            with torch.no_grad(), mesh.use_grid(mesh.LOCAL):
                one_ms = _event_wall(lambda: f2f.apply_generator(model, x), 5)
        dist.barrier()
        out[name] = {"k4_layers": len(q8), "k4_layers_bitwise": int(equal),
                     "rewritten_k4_layers": sum(isinstance(layer, nn_core.REWRITES)
                                                for layer, _, _ in q8),
                     "k4_launches_a_forward": k4, "k4_launches_want": f2f.k4_launches(model),
                     "one_device_k4_layers": len(ref_out),
                     "exchanged_bytes_a_forward": exchanged,
                     "frame_share_within_1": float((diff <= 1).float().mean()),
                     "frame_max_levels": int(diff.max()), "ms": ms, "one_device_ms": one_ms,
                     "slab": list(y.shape)}
        del ref_out, taps, q8, ref, y, frames
        torch.cuda.empty_cache()
    return out


def _gathered(grads, params_named, net, grid):
    """Each gradient with its channels gathered over the model axis."""
    import torch.distributed as dist

    out = []
    for (name, _), g in zip(params_named, grads):
        if name in net.sharded_keys:
            parts = [torch.empty_like(g) for _ in range(grid.model_size)]
            dist.all_gather(parts, g.contiguous(), group=grid.model_group)
            g = torch.cat(parts, dim=0)
        out.append(g)
    return out


def _state_bytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _channel_rank(dev, raw, cfg, g0, d0) -> dict:
    """17b on one of two model ranks: the fused GAN step at 512^2 with G and
    D channel-sharded.  The float step and the "fq" QAT step in float64
    (B = 2 of the batch: each of its gathers crosses the host): their
    losses and gathered gradients against one process (model rank 0
    computes the float one's, rank 1 the QAT one's) at 13d's tolerances.
    Under
    qat and qat_int8: the eval-mode frames (f32, TF32 off) against one
    process's; then one step at B = 8 as phase 12 trains (bf16 G under
    autocast, f32 D with TF32, Adam): its ms (CUDA events) beside one
    process's (the mean of 2 after a first), K1 / K4 launches, the parameter and
    optimizer bytes beside one process's, and its losses and gathered
    gradients against one process's step (int8 steps tipped by the
    BatchNorms' rounding carry them apart: reported, as in 17d)."""
    import torch.distributed as dist

    from livespeechportraits_torch.models import feature2face as f2f
    from livespeechportraits_torch.parallel import mesh, sharding
    from livespeechportraits_torch.train import state, steps, trainer

    grid = mesh.make_grid(2)
    first = grid.model_index == 0

    def errors(ref, got, gd, gg):
        return {"grad_err": max(_grad_err(gd, ref[1], DP_ZERO_FLOOR),
                                _grad_err(gg, ref[2], DP_ZERO_FLOOR)),
                "loss_rel_err": max(abs(got[k] - v) / max(abs(v), 1e-12)
                                    for k, v in ref[0].items())}

    def gathered_step(g, d, b):
        with mesh.use_grid(grid):
            m, gd, gg = _reduced_grads(cfg, g, d, b)
        return (m, _gathered(gd, list(d.named_parameters()), d, grid),
                _gathered(gg, list(g.named_parameters()), g, grid))

    # the machinery in float64: the float step, and the --qat ("fq") step,
    # where an int8 code tips only within ~1e-15 of a rounding boundary (a
    # gap is a fault of the sharded path); one process's gradients of each
    # on a rank of its own at once (no collective), then the two grid steps
    t0 = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    b64 = {k: v[:2] if v.shape[0] == 8 else v for k, v in _double(
        trainer.device_rasterize_batch(raw)).items()}
    nets64 = {"float64": lambda: copy.deepcopy(g0).double(),
              "qat_float64": lambda: f2f.qat_generator(copy.deepcopy(g0)).double()}
    mine = list(nets64)[grid.model_index]
    with mesh.use_grid(mesh.LOCAL):
        ref = _reduced_grads(cfg, nets64[mine](), copy.deepcopy(d0).double(), b64)
    dist.barrier()
    out = {}
    for what, make_g64 in nets64.items():
        got = gathered_step(sharding.shard_params(make_g64(), grid),
                            sharding.shard_params(copy.deepcopy(d0).double(), grid), b64)
        if what == mine:
            out[what] = errors(ref, *got)
        del got
    del ref, b64
    torch.cuda.empty_cache()
    out["walls"] = {"float64": time.perf_counter() - t0}
    for mode, int8 in (("qat", False), ("qat_int8", True)):
        def make_g():
            return f2f.qat_generator(copy.deepcopy(g0), int8_forward=int8)

        def eval_frame(g):
            torch.backends.cudnn.allow_tf32 = False
            with torch.no_grad():
                y = f2f.to_uint8(f2f.apply_generator(g, steps.f2f_g_input(
                    trainer.device_rasterize_batch(raw))))
            torch.backends.cudnn.allow_tf32 = True  # phase 12's training settings
            return y

        def trained(g, d, reps: int):
            """(metrics and the D and G gradients of a first step, its ms, or
            the ms a step over reps more, K1 / K4 launches of the first
            step, parameter and optimizer bytes)."""
            opt_g = state.adam(g.parameters(), 2e-4, 0.5, 0.999)
            opt_d = state.adam(d.parameters(), 2e-4, 0.5, 0.999)

            def step():
                return steps.f2f_fused_step(cfg, g, d, opt_g, opt_d,
                                            trainer.device_rasterize_batch(raw), None,
                                            torch.bfloat16)

            zero_launch_counts()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            metrics = step()
            end.record()
            torch.cuda.synchronize()
            counts = launch_counts()
            # the step leaves each parameter's reduced gradient in .grad
            grads = ([p.grad.clone() for p in d.parameters()],
                     [p.grad.clone() for p in g.parameters()])
            ms = _event_wall(step, reps, warm=False) if reps else start.elapsed_time(end)
            held = (_state_bytes(list(g.parameters()) + list(d.parameters())),
                    _state_bytes([t for o in (opt_g, opt_d) for s in o.state.values()
                                  for t in s.values() if torch.is_tensor(t)]))
            return (({k: v.item() for k, v in metrics.items()}, *grads), ms,
                    {k: counts[k] for k in ("K1", "K4")}, held)

        ref = None
        if first:  # one process alone, the other rank waiting
            with mesh.use_grid(mesh.LOCAL):
                g, d = make_g(), copy.deepcopy(d0)
                ref_frame = eval_frame(g)
                ref = trained(g, d, 2)
                del g, d
        dist.barrier()
        g = sharding.shard_params(make_g(), grid)
        d = sharding.shard_params(copy.deepcopy(d0), grid)
        frame = eval_frame(g)
        (m, gd, gg), ms, launches, held = trained(g, d, 0)
        gd = _gathered(gd, list(d.named_parameters()), d, grid)
        gg = _gathered(gg, list(g.named_parameters()), g, grid)
        res = {"step_ms": ms, "launches_a_step": launches, "param_bytes": held[0],
               "optimizer_bytes": held[1]}
        if first:
            diff = (frame.int() - ref_frame.int()).abs()
            res.update(errors(ref[0], m, gd, gg), one_process_step_ms=ref[1],
                       one_process_param_bytes=ref[3][0], one_process_optimizer_bytes=ref[3][1],
                       frame_share_within_1=float((diff <= 1).float().mean()),
                       frame_max_levels=int(diff.max()))
        del g, d, gd, gg
        torch.cuda.empty_cache()
        dist.barrier()
        out[mode] = res
        out["walls"][mode] = time.perf_counter() - t0 - sum(out["walls"].values())
    return out


def _data_qat_rank(dev, raw, cfg, g0, d0) -> dict:
    """17d on one of two data ranks: --qat_int8 on this rank's 4 rows of a
    batch whose halves differ twofold in range (f32, TF32 off).  Recorded:
    every fq8 conv's activation scale (nn_core.activation_scale) in the
    fused step and in an eval-mode forward, and this rank's local amax /
    127; the eval-mode frame's rows and the step's reduced gradients, each
    against one process on the global batch (rank 0); and the same with the
    scale left per rank (the fault repaired here: the amax's all-reduce
    skipped).  The eval forward's BatchNorms use the running statistics, so
    the rows depend on the other rows through the activation scale alone;
    the step's training BatchNorms carry f32 sums whose rounding the int8
    steps amplify from layer to layer."""
    import torch.distributed as dist

    from livespeechportraits_torch.models import feature2face as f2f
    from livespeechportraits_torch.models import nn_core
    from livespeechportraits_torch.parallel import mesh, multihost
    from livespeechportraits_torch.train import steps, trainer

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    grid = mesh.make_grid(1)
    full = trainer.device_rasterize_batch(raw)
    amp = torch.tensor([0.5] * 4 + [1.0] * 4, device=dev).view(-1, 1, 1, 1)
    full = {k: v.expand(8, *v.shape[1:]) * amp  # the shared candidates too
            if k in ("feature_map", "cand_image", "tgt_image") else v for k, v in full.items()}
    with mesh.use_grid(grid):
        rows = multihost.local_batch_slice(8)
    local = {k: v[rows] if v.shape[0] == 8 else v for k, v in full.items()}
    scales, orig = [], nn_core.activation_scale

    def record(layer, x, *more):
        s_x = orig(layer, x, *more)
        scales.append((float(s_x), float(x.detach().abs().amax()) / 127.0))
        return s_x

    def run(on, batch):
        """The eval-mode frame, its scales, D's and G's reduced gradients of
        the step and its scales, under grid ``on``."""
        g = f2f.qat_generator(copy.deepcopy(g0), int8_forward=True)
        scales.clear()
        with mesh.use_grid(on):
            with torch.no_grad():
                fake = f2f.apply_generator(g, steps.f2f_g_input(batch))
            eval_scales = list(scales)
            scales.clear()
            _, gd, gg = _reduced_grads(cfg, g, copy.deepcopy(d0), batch)
        return fake, eval_scales, gd, gg, list(scales)

    nn_core.activation_scale = record
    try:
        got = run(grid, local)
        reduce_max = mesh.all_reduce_max_
        mesh.all_reduce_max_ = lambda x: x  # the fault: one scale a rank
        try:
            fault = run(grid, local)
        finally:
            mesh.all_reduce_max_ = reduce_max
        ref = run(mesh.LOCAL, full) if grid.data_index == 0 else None
    finally:
        nn_core.activation_scale = orig
    dist.barrier()
    out = {"step_scales": [s for s, _ in got[4]], "eval_scales": [s for s, _ in got[1]],
           "local_amax_scales": [a for _, a in got[1]], "rows": int(local["tgt_image"].shape[0])}
    if ref is not None:
        fake_ref = ref[0][rows]
        for name, res in (("repaired", got), ("per_rank_scale", fault)):
            out[name] = {"fake_mean_abs": float((res[0] - fake_ref).abs().mean()),
                         "fake_max_abs": float((res[0] - fake_ref).abs().max()),
                         "grad_err_d": _grad_err(res[2], ref[2], DP_ZERO_FLOOR),
                         "grad_err_g": _grad_err(res[3], ref[3], DP_ZERO_FLOOR)}
        out["one_process_eval_scales"] = [s for s, _ in ref[1]]
    torch.cuda.empty_cache()
    return out


def _grid_rank(rank: int, port: int, work: str, device: str, size: int) -> None:
    """Phase 17's rank: joins a two-rank gloo group on cuda:0 (NCCL refuses
    two ranks on one card; gloo moves CUDA tensors through the host) and
    runs 17a, 17b and 17d, saving rank<r>.pt."""
    from livespeechportraits_torch import _build
    from livespeechportraits_torch.parallel import multihost
    from livespeechportraits_torch.train import __main__ as cli

    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK="0", MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    dev = multihost.initialize(device, backend="gloo")
    if dev.type == "cuda":
        _build.library()
    try:
        t0 = time.perf_counter()
        _dp_case(rank, os.path.join(work, "dp2"), dev, size)
        out = {"dp_wall": time.perf_counter() - t0, "spatial": _spatial_rank(dev, work)}
        walls = {"13d": out["dp_wall"], "17a": time.perf_counter() - t0 - out["dp_wall"]}
        raw = _raw_device_batch(cli.synthetic_face_data(8, size), dev)
        cfg, g0, d0 = _gan_models(dev, size)
        t1 = time.perf_counter()
        out["channel"] = _channel_rank(dev, raw, cfg, g0, d0)
        t2 = time.perf_counter()
        out["data_qat"] = _data_qat_rank(dev, raw, cfg, g0, d0)
        walls.update({"17b": t2 - t1, "17d": time.perf_counter() - t2})
        out["walls"] = walls
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    finally:
        multihost.shutdown()


def _grid_ranks(dev, pq, models, person, size: int) -> list:
    """Spawn phase 17's two ranks (13d, 17a, 17b, 17d) and return their
    results; 13d's files stay in a directory of this process (``dp_work``,
    removed at exit)."""
    import atexit
    import shutil

    import torch.multiprocessing as mp

    from livespeechportraits_torch.models import feature2face as f2f
    from livespeechportraits_torch.pipeline import animate, video

    lm, sh, _, _, _ = animate.compute_motion(pq._cfg, person, models, video.make_test_tone(1.0))
    work = tempfile.mkdtemp()
    atexit.register(shutil.rmtree, work, True)
    trees = {"float": f2f.cast_generator(models.feature2face, torch.bfloat16),
             "int8": f2f.cast_generator(pq._models.feature2face, torch.bfloat16)}
    trees["int8_split"] = f2f.split_skip_generator(trees["int8"])
    trees["int8_single"] = f2f.subpixel_generator(trees["int8"], mode="single")
    trees["float_single"] = f2f.subpixel_generator(trees["float"], mode="single")
    torch.save({"lm": lm[:16].cpu(), "sh": animate._shift_shoulders(person, sh[:16]).cpu(),
                "cand": animate._cand_stack(person, size, "cpu", torch.bfloat16), **trees},
               os.path.join(work, "spatial.pt"))
    torch.cuda.synchronize()
    mp.start_processes(_grid_rank, args=(free_port(), work, str(dev), size), nprocs=2,
                       start_method="spawn", join=True)
    return [dict(torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False),
                 dp_work=os.path.join(work, "dp2")) for r in range(2)]


def check_model_axis(dev, pq, models, person, size: int = 512) -> dict:
    """17.  The model axis on the card.  Two ranks (spawned, gloo on cuda:0)
    run 13d, 17a (spatial: the int8 Predictor's 'normal' renderer at 512^2,
    B = 16, SPATIAL_TREES, 256 rows a rank), 17b (channels: the fused GAN
    step at 512^2, float64 float and fq, qat and qat_int8) and 17d (the
    activation scale over two data ranks), while 17c, parallel.dryrun with
    4 ranks on the card and its 8 and 16 CPU ranks, runs beside them.
    Returns 13d's result and the K1 and K4 entries (``spatial``,
    ``channel``)."""
    t0 = time.perf_counter()
    # 17c in its own processes beside the two ranks (their start-up is most
    # of its wall; its tiny net takes little of the card), at the lowest
    # CPU priority: its 8 and 16 CPU ranks would otherwise take the host
    # cores that the two ranks' gloo collectives wait on (on an 8-core H100
    # host phase 17 took 148.7 s with them at the same priority)
    here = os.path.dirname(os.path.abspath(__file__))
    dry = subprocess.Popen([sys.executable, "-m", "livespeechportraits_torch.parallel.dryrun",
                            "--ranks", "4", "--device", dev.type], cwd=here,
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    os.setpriority(os.PRIO_PROCESS, dry.pid, 19)  # before it spawns its ranks
    try:
        ranks = _grid_ranks(dev, pq, models, person, size)
        t_ranks = time.perf_counter() - t0
        dry_out = dry.communicate(timeout=600)[0]
    finally:
        if dry.poll() is None:
            dry.kill()
            dry.communicate()
    t_dry = time.perf_counter() - t0
    dp = check_dp_two_ranks(dev, ranks[0]["dp_work"], max(r["dp_wall"] for r in ranks), size)
    bad = []
    sp = [r["spatial"] for r in ranks]
    for name in SPATIAL_TREES:
        a, b = sp[0][name], sp[1][name]
        log(f"grid_spatial_{name}", rows_a_rank=sp[0]["rows"],
            k1_a_rank=[r["k1_launches"] for r in sp],
            k4_launches_a_forward=[a["k4_launches_a_forward"], b["k4_launches_a_forward"]],
            k4_layers_bitwise=f"{a['k4_layers_bitwise']}+{b['k4_layers_bitwise']} of "
                              f"{a['k4_layers']}+{b['k4_layers']}",
            rewritten_k4_layers=a["rewritten_k4_layers"],
            frame_share_within_1=f"{a['frame_share_within_1']:.6f}",
            frame_max_levels=a["frame_max_levels"], share_bound=GRID_FRAME_SHARE,
            ms_a_forward=[f"{a['ms']:.3f}", f"{b['ms']:.3f}"],
            one_device_ms=f"{a['one_device_ms']:.3f}", collectives="gloo on one card",
            exchanged_bytes_a_forward=[a["exchanged_bytes_a_forward"],
                                       b["exchanged_bytes_a_forward"]])
        if not (a["frame_share_within_1"] >= GRID_FRAME_SHARE
                and b["frame_share_within_1"] >= GRID_FRAME_SHARE):
            bad.append(f"spatial {name}: frames {a['frame_share_within_1']}")
        want = 44 if name.startswith("int8") else 0
        if not ((a["rewritten_k4_layers"] > 0) == (name == "int8_split" or name == "int8_single")
                and a["k4_layers"] == b["k4_layers"] == want
                and a["k4_layers_bitwise"] == b["k4_layers_bitwise"] == want
                and a["k4_launches_a_forward"] == b["k4_launches_a_forward"]
                == a["k4_launches_want"] == want):
            bad.append(f"spatial {name}: K4 layers {a['k4_layers_bitwise']} / "
                       f"{b['k4_layers_bitwise']} bitwise of {want}, "
                       f"{a['k4_launches_a_forward']} launches")
    ch = [r["channel"] for r in ranks]
    f64 = ch[0]["float64"]
    for what, e in (("float64", f64), ("qat_float64", ch[1]["qat_float64"])):
        log(f"grid_channel_{what}", batch=2, grad_err=f"{e['grad_err']:.3e}",
            grad_tol=DP_TWO_RANK_TOL, loss_rel_err=f"{e['loss_rel_err']:.3e}",
            loss_tol=DP_LOSS_RTOL)
        if not (e["grad_err"] <= DP_TWO_RANK_TOL and e["loss_rel_err"] <= DP_LOSS_RTOL):
            bad.append(f"channel {what}: {e}")
    for mode in ("qat", "qat_int8"):
        a, b = ch[0][mode], ch[1][mode]
        share = a["param_bytes"] / a["one_process_param_bytes"]
        log(f"grid_channel_{mode}", batch=8,
            eval_frame_share_within_1=f"{a['frame_share_within_1']:.6f}",
            eval_frame_max_levels=a["frame_max_levels"], share_bound=GRID_FRAME_SHARE,
            step_ms=[f"{a['step_ms']:.3f}", f"{b['step_ms']:.3f}"],
            one_process_step_ms=f"{a['one_process_step_ms']:.3f}",
            launches_a_step=json.dumps(a["launches_a_step"]),
            param_bytes=[a["param_bytes"], b["param_bytes"]],
            one_process_param_bytes=a["one_process_param_bytes"],
            optimizer_bytes=[a["optimizer_bytes"], b["optimizer_bytes"]],
            one_process_optimizer_bytes=a["one_process_optimizer_bytes"],
            step_grad_err=f"{a['grad_err']:.3e}", step_loss_rel_err=f"{a['loss_rel_err']:.3e}")
        if not (a["frame_share_within_1"] >= GRID_FRAME_SHARE and 0.5 <= share <= 0.51
                and a["launches_a_step"]["K1"] == 1
                and a["launches_a_step"]["K4"] == (44 if mode == "qat_int8" else 0)):
            bad.append(f"channel {mode}: {a}")
    dq = [r["data_qat"] for r in ranks]
    one_scale = (dq[0]["step_scales"] == dq[1]["step_scales"]
                 and dq[0]["eval_scales"] == dq[1]["eval_scales"])
    vs_one = max(abs(a - b) / b for a, b in zip(dq[0]["eval_scales"],
                                                dq[0]["one_process_eval_scales"]))
    halves = max(b / a for a, b in zip(dq[0]["local_amax_scales"], dq[1]["local_amax_scales"]))
    rep, flt = dq[0]["repaired"], dq[0]["per_rank_scale"]
    log("grid_data_qat_int8", rows_a_rank=[r["rows"] for r in dq],
        fq8_scales_a_step=len(dq[0]["step_scales"]), one_scale_on_both_ranks=one_scale,
        eval_scale_rel_diff_vs_one_process_max=f"{vs_one:.3e}",
        local_amax_ratio_max=f"{halves:.3f}",
        eval_frame_vs_one_process=f"mean {rep['fake_mean_abs']:.3e} max {rep['fake_max_abs']:.3e}",
        per_rank_scale_eval_frame=f"mean {flt['fake_mean_abs']:.3e} max "
                                  f"{flt['fake_max_abs']:.3e}",
        step_grad_err=[f"{rep['grad_err_d']:.3e}", f"{rep['grad_err_g']:.3e}"],
        per_rank_scale_step_grad_err=[f"{flt['grad_err_d']:.3e}", f"{flt['grad_err_g']:.3e}"])
    if not (one_scale and dq[0]["step_scales"] and halves > 1.5
            and vs_one <= DATA_QAT_SCALE_RTOL
            and rep["fake_mean_abs"] * DATA_QAT_FAKE_MARGIN <= flt["fake_mean_abs"]):
        bad.append(f"data-parallel qat_int8: one scale {one_scale}, vs one process {vs_one}, "
                   f"local ratio {halves}, frame {rep} vs per-rank {flt}")
    lines = [x for x in dry_out.splitlines() if x.startswith("dryrun_multichip")]
    for line in lines:
        log("grid_dryrun", line=repr(line), exit=dry.returncode)
    found = [DRYRUN_LINE.match(x) for x in lines]
    meshes = [m and (m[1], m[2]) for m in found]
    same_rows = (max(abs(float(found[1][k]) - float(found[2][k])) / abs(float(found[2][k]))
                     for k in (3, 4)) if len(found) == 3 and all(found) else math.inf)
    log("grid_dryrun_same_rows", grids="(4x2),(4x4)", loss_rel_gap=same_rows,
        bound=DRYRUN_SAME_ROWS_RTOL)
    if (dry.returncode or meshes != [("2", "2"), ("4", "2"), ("4", "4")]
            or not same_rows <= DRYRUN_SAME_ROWS_RTOL):
        bad.append(f"dryrun: rc {dry.returncode}\n{dry_out[-3000:]}")
    log("phase17", seconds=f"{time.perf_counter() - t0:.1f}", ranks_s=f"{t_ranks:.1f}",
        dryrun_done_s=f"{t_dry:.1f}",
        rank_walls_s=json.dumps({k: round(v, 1) for k, v in ranks[0]["walls"].items()}),
        walls_17b_s=json.dumps({k: round(v, 1) for k, v in ch[0]["walls"].items()}))
    if bad:
        raise AssertionError("; ".join(bad))
    sp0, ch0 = sp[0], ch[0]
    return {"dp_two_ranks": dp,
        "K1": {"spatial": {"launches_a_rank_a_forward": sp0["k1_launches"]},
               "channel": {m: ch0[m]["launches_a_step"]["K1"] for m in ("qat", "qat_int8")}},
        "K4": {"spatial": {k: {"launches_a_rank_a_forward": sp0[k]["k4_launches_a_forward"],
                               "ms_a_forward": [r[k]["ms"] for r in sp],
                               "one_device_ms": sp0[k]["one_device_ms"],
                               "exchanged_bytes_a_forward": sp0[k]["exchanged_bytes_a_forward"],
                               "k4_layers_bitwise": sp0[k]["k4_layers_bitwise"]}
                           for k in SPATIAL_TREES},
               "channel": {**{m: {"launches_a_step": ch0[m]["launches_a_step"]["K4"],
                                  "step_ms": [r[m]["step_ms"] for r in ch],
                                  "one_process_step_ms": ch0[m]["one_process_step_ms"],
                                  "eval_frame_share_within_1": ch0[m]["frame_share_within_1"]}
                              for m in ("qat", "qat_int8")},
                           "float64_grad_err": f64["grad_err"],
                           "qat_float64_grad_err": ch[1]["qat_float64"]["grad_err"]}},
    }


class PhaseWalls:
    """Host seconds of each phase of main, for the script's time budget."""

    def __init__(self):
        self.seconds, self.name, self.t0 = {}, None, time.perf_counter()

    def mark(self, name) -> None:
        now = time.perf_counter()
        if self.name is not None:
            self.seconds[self.name] = now - self.t0
            log("phase_wall", of=self.name, seconds=f"{now - self.t0:.1f}",
                total=f"{sum(self.seconds.values()):.1f}")
        self.name, self.t0 = name, now


def main() -> int:
    phase_walls = PhaseWalls()
    phase_walls.mark("device")
    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device; nothing runs on the CPU")
    from livespeechportraits_torch.config import PersonConfig
    from livespeechportraits_torch import _build
    from livespeechportraits_torch.models import feature2face as f2f
    from livespeechportraits_torch.ops import rasterize, rasterize_cuda, recurrent_cuda
    from livespeechportraits_torch.pipeline import animate, assets, video

    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    log("device", name=repr(kind), count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, nvidia_smi=repr(smi))

    phase_walls.mark("build")
    # 2. build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    log("build", seconds=f"{time.perf_counter() - t0:.2f}",
        nvcc_seconds=_build.build_seconds, library=lib_path.name)
    # registers and spills of the recurrence kernels (ptxas -v; the
    # main-path instances are GRU H=512: cluster<3,4,2>, LSTM H=256:
    # cluster<4,2,1>), of K1's five instances (the f32 plane; the render
    # input in bf16 and f32, 13 channels and the edge-only 1) and of K5, the
    # head-pose decode: none may spill
    for what, src, want in (("recurrence", "recurrent.cu", 1), ("k1", "rasterize.cu", 5),
                            ("decode", "headpose.cu", 1)):
        regs = ptxas_report.summary(_build.build_logs.get(src, ""), kernel_label)
        log(f"ptxas_{what}", instances=json.dumps(dict(sorted(regs.items()))))
        spills = {k: v for k, v in regs.items() if v["spill_stores"] or v["spill_loads"]}
        if spills or len(regs) < want:
            raise AssertionError(f"{src}: kernels spill ({spills}) or ptxas -v listed "
                                 f"{len(regs)} instances")
    # 2b. what one int8 layer launches (first, while the profiler's records
    # are complete)
    check_conv2d_q8_launches(dev)

    cfg = PersonConfig()
    person, models_cpu = assets.make_synthetic_person(cfg, image_size=512, device="cpu")
    kernels = []

    phase_walls.mark("k1")
    # 3. K1: the table entry (the Pallas kernel's function) against its
    # plain twin on the edge-case table, then the render-input entry
    table = segment_table(person, 8, dev)
    out = rasterize_cuda.rasterize_segments(table, 512, 512)
    ref = rasterize.rasterize_segments(table, 512, 512)
    mismatched = int((out != ref).sum().item())
    k1_ms = cuda_ms(lambda: rasterize_cuda.rasterize_segments(table, 512, 512), reps=50)
    k1_plain = cuda_ms(lambda: rasterize.rasterize_segments(table, 512, 512), reps=3, warmup=1)
    k1_dev = graph_ms(lambda: rasterize_cuda.rasterize_segments(table, 512, 512))
    # bound: the segment table read and the f32 maps written once; after
    # culling a pixel tests a few segments, so bytes set it
    k1_bound, k1_by = bound(table.numel() * 4 + out.numel() * 4, 0, "f32")
    log("K1", entry="rasterize_segments", frames=8, size=512, segments=table.shape[1],
        lit=int(ref.sum().item()), mismatched=mismatched, ms=f"{k1_ms:.4f}",
        device_ms=f"{k1_dev:.5f}", plain_ms=f"{k1_plain:.4f}", bound_ms=f"{k1_bound:.5f}",
        bound_by=k1_by, share=f"{k1_bound / k1_dev:.3f}")
    if mismatched:
        raise AssertionError(f"K1: {mismatched} pixels differ from the plain twin")
    k1 = check_render_input(person, dev)
    kernels.append({"name": "K1 render_input (rasterizer + the U-Net's input)", "route": "cuda",
                    "source": "livespeechportraits_torch/csrc/rasterize.cu",
                    "replaces": "livespeechportraits_tpu/ops/rasterize_pallas.py:115",
                    **k1, "library_ms": None,
                    "table_entry": {"frames": 8, "device_ms": k1_dev, "ms": k1_ms,
                                    "plain_ms": k1_plain, "bound_ms": k1_bound}})

    phase_walls.mark("k2_k3")
    # 4. K2, 5. K3 (main-path lengths for 3 s: 360 mel steps, 198 frames)
    k2 = check_recurrence("K2", 3, 512, 80, (64, 360, 1200), 360, dev)
    # the stream's chunks: 64 mel rows a chunk of 32 frames, then a short one
    k2["carried_max_abs_err"] = check_carried("K2", 3, 512, (80, 512), (64, 64, 31), dev)
    kernels.append({"name": "K2 gru_layer", "route": "cuda",
                    "source": "livespeechportraits_torch/csrc/recurrent.cu",
                    "replaces": "livespeechportraits_tpu/ops/recurrent_pallas.py:67", **k2})
    k3 = check_recurrence("K3", 4, 256, 512, (64, 198, 600), 198, dev)
    k3["carried_max_abs_err"] = check_carried("K3", 4, 256, (512, 256), (32, 32, 17), dev)
    kernels.append({"name": "K3 lstm_layer", "route": "cuda",
                    "source": "livespeechportraits_torch/csrc/recurrent.cu",
                    "replaces": "livespeechportraits_tpu/ops/recurrent_pallas.py:176", **k3})

    phase_walls.mark("slice")
    # 6. slice: warm once, then zero the counters and drive the main path
    models = assets.init_models(cfg, assets.synthetic_seed(cfg)).to(dev)
    audio = video.make_test_tone(3.0)
    animate.animate(cfg, person, models, audio[:16000], seed=0)
    rasterize_cuda.LAUNCHES = recurrent_cuda.GRU_LAUNCHES = recurrent_cuda.LSTM_LAUNCHES = 0
    recurrent_cuda.PLAN_LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = animate.animate(cfg, person, models, audio, seed=0, profile=True)
    wall = time.perf_counter() - t0
    launches = {"K1": rasterize_cuda.LAUNCHES, "K2": recurrent_cuda.GRU_LAUNCHES,
                "K3": recurrent_cuda.LSTM_LAUNCHES}
    plans = dict(recurrent_cuda.PLAN_LAUNCHES)
    frames = result.frames
    log("slice", frames=frames.shape, dtype=frames.dtype, launches=launches,
        rnn_plans=json.dumps(plans),
        stage_ms=json.dumps({k: round(v, 3) for k, v in result.stage_ms.items()}),
        wall_s=f"{wall:.4f}", fps=f"{result.nframe / wall:.2f}",
        pixel_std=f"{frames.std():.4f}")
    n = 165
    if frames.shape != (n, 512, 512, 3) or frames.dtype != np.uint8:
        raise AssertionError(f"slice: frames {frames.shape} {frames.dtype}")
    if frames.min() == frames.max():
        raise AssertionError("slice: the frames are constant")
    if not np.isfinite(result.landmarks).all():
        raise AssertionError("slice: non-finite landmarks")
    need = {"K1": math.ceil(n / 8), "K2": 3, "K3": 3}
    for k, v in need.items():
        if launches[k] != v:
            raise AssertionError(f"slice: {k} launched {launches[k]} times, expected {v}")
    check_rnn_plans(launches, plans)
    for entry, k in zip(kernels, ("K1", "K2", "K3")):
        entry["launches"] = launches[k]

    # 6b. one more warm run of each half under torch.profiler: the device's
    # busy share, each kernel's device time per launch at the main path's
    # shapes, and the kernels that take the most device time
    lm, sh, _, _, nframe = animate.compute_motion(cfg, person, models, audio, seed=0)
    halves = {"motion": lambda: animate.compute_motion(cfg, person, models, audio, seed=0),
              "render": lambda: animate.render_frames(cfg, person, models, lm[:nframe],
                                                      sh[:nframe])}
    for half, fn in halves.items():
        # The profiler stretches the host side (several times over for the
        # motion half's ~56k launches) but not the kernels, so the busy share
        # divides the traced busy time by an unprofiled wall of the same call.
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        with labelled_k1():
            events, traced_wall, host = trace(fn)
        if half == "render":
            check_render_trace(events, host, math.ceil(nframe / 8), "slice")
        busy = busy_ms(events)
        per_kernel = {k: kernel_device_ms(events, s) for k, s in SYMBOLS.items()}
        log(f"profile_{half}", wall_ms=f"{wall:.3f}", traced_wall_ms=f"{traced_wall:.3f}",
            device_busy_ms=f"{busy:.3f}", busy_share=f"{busy / wall:.4f}",
            device_events=len(events),
            kernels=json.dumps({k: {"device_ms_per_launch": v[0], "launches": v[1]}
                                for k, v in per_kernel.items() if v[1]}),
            top=json.dumps(top_kernels(events, 6)))
    # the render half once more under torch's sync debug mode: a
    # synchronizing host call raises (the pinned copy's event and the
    # closing device synchronize are not such calls)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        halves["render"]()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log("render_sync_debug", batches=math.ceil(nframe / 8), synchronizing_calls=0)

    phase_walls.mark("k4")
    # 6c. K4 against its plain twin at the main-path shapes
    k4 = check_q8conv(dev)
    for B in (16, 8):  # the serving render batch and the stream's
        check_k4_forward(dev, B)
    kernels.append({"name": "K4 q8conv (int8 3x3 and 4x4 conv)", "route": "cuda",
                    "source": "livespeechportraits_torch/csrc/q8conv.cu",
                    "replaces": "livespeechportraits_tpu/models/nn_core.py:241", **k4})

    phase_walls.mark("serve_stream_coders")
    # 6d. the serving path; 6e. the live path; 6f. the frame coders
    with tempfile.TemporaryDirectory() as tmp:
        kernels[-1]["launches"], pq = check_serve(dev, tmp)
        stream_launches = check_stream(pq, dev)
        for entry, k in zip(kernels, ("K1", "K2", "K3", "K4")):
            entry["stream_launches"] = stream_launches[k]
        check_coders(pq, dev)

    phase_walls.mark("gpu_vs_cpu")
    # 7. GPU against CPU on the same port, TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lm_cpu, sh_cpu, *_ = animate.compute_motion(cfg, person, models_cpu, audio, seed=0)
    lm_gpu, sh_gpu, *_ = animate.compute_motion(cfg, person, models, audio, seed=0)
    lm_err = (lm_gpu.cpu() - lm_cpu).abs().max().item()
    i = n // 2
    # the f32 render input: K1 on the card, its twin on the CPU
    cand = animate._cand_stack(person, 512, "cpu", torch.float32)
    inp = rasterize_cuda.render_input(lm_cpu[i:i + 1], sh_cpu[i:i + 1], cand)
    inp_gpu = rasterize_cuda.render_input(lm_cpu[i:i + 1].to(dev), sh_cpu[i:i + 1].to(dev),
                                          cand.to(dev))
    with torch.no_grad():
        y_cpu = f2f.apply_generator(f2f.cast_generator(models_cpu.feature2face, torch.float32),
                                    inp)
        y_gpu = f2f.apply_generator(f2f.cast_generator(models.feature2face, torch.float32),
                                    inp.to(dev))
    frame_err = (y_gpu.cpu() - y_cpu).abs().max().item()
    inputs_equal = torch.equal(inp_gpu.cpu(), inp)
    log("gpu_vs_cpu", landmark_max_px=f"{lm_err:.3e}", landmark_tol_px=LANDMARK_TOL_PX,
        frame=i, frame_max_abs=f"{frame_err:.3e}", frame_tol=FRAME_TOL,
        render_input_bitwise=inputs_equal)
    if not lm_err <= LANDMARK_TOL_PX:
        raise AssertionError(f"landmarks differ by {lm_err} px > {LANDMARK_TOL_PX}")
    if not frame_err <= FRAME_TOL or not inputs_equal:
        raise AssertionError(f"frame differs by {frame_err} > {FRAME_TOL} or the render "
                             "inputs differ")

    phase_walls.mark("onboard")
    # 8. onboarding: clips -> pack -> a served subject and its variants
    with tempfile.TemporaryDirectory() as tmp:
        onboard, plane = check_onboard(dev, tmp)
    for entry, k in zip(kernels, ("K1", "K2", "K3", "K4")):
        entry["onboard_launches"] = onboard[k]
    kernels[0]["onboard_entry"] = plane

    phase_walls.mark("train")
    # 10. training: the four trainers at full width, then a Predictor
    # serving their checkpoints (kept for phase 13's demo)
    train_tmp = tempfile.TemporaryDirectory()
    train_counts, train_entry, face_sampler = check_training(dev, train_tmp.name)
    kernels[0]["train_launches"] = train_counts["K1"]
    kernels[0]["train_entry"] = train_entry

    phase_walls.mark("qat_real_data")
    # 11. quantization-aware training (K4's 4x4 taps), then training on a
    # subject's clips
    with tempfile.TemporaryDirectory() as tmp:
        qat = check_qat(dev, tmp, face_sampler)
    kernels[3].update(qat)
    with tempfile.TemporaryDirectory() as tmp:
        real = check_real_data(dev, tmp)
    kernels[0]["real_data_train_launches"] = real["train_K1"]
    kernels[1]["real_data_prepare_clip_launches"] = real["prepare_clip_K2"]

    phase_walls.mark("fused_e2e")
    # 12. the fused GAN step, remat and the chunked VGG loss at full width,
    # then the from-scratch subject run (tools/e2e_subject.py)
    with tempfile.TemporaryDirectory() as tmp:
        fused = check_fused(dev, tmp, face_sampler)
    for entry, k in zip(kernels, ("K1", "K2", "K3", "K4")):
        entry["e2e_launches"] = fused["e2e"]["launches"][k]
    kernels[0]["fused_step_launches"] = {m: v["k1_a_step"] for m, v in fused["modes"].items()}
    kernels[2]["a2h_lstm_variant"] = fused["a2h_lstm_k3"]
    kernels[3]["fused_step_launches"] = {m: v["k4_a_step"] for m, v in fused["modes"].items()}
    kernels[3]["fused_qat_remat_launches"] = fused["remat_k4"]

    phase_walls.mark("demo_parallel")
    # 13. the demo's flags (a subprocess on the card, phase 10's checkpoints
    # served) and data parallelism: the render split, one rank, two ranks
    with tempfile.TemporaryDirectory() as tmp:
        p13 = check_demo_and_parallel(dev, tmp, train_tmp.name, face_sampler)
    train_tmp.cleanup()
    for entry, k in zip(kernels, ("K1", "K2", "K3", "K4")):
        entry["demo_launches"] = p13["demo"]["demo_launches"][k]
    kernels[0]["render_split_launches"] = p13["serve"]["render_split_launches"]["K1"]
    kernels[3]["render_split_launches"] = p13["serve"]["render_split_launches"]["K4"]

    phase_walls.mark("measurement")
    # 14. the measurement slice: split_cand (K1's edge-only form), then the
    # tools at full width ('large' at 512^2 for the first time on the card)
    t14 = time.perf_counter()
    kernels[0].update(check_split_cand(dev, cfg, person, models))
    with tempfile.TemporaryDirectory() as tmp:
        tools = check_tools(dev, tmp, cfg, person, models)
    kernels[3]["large_launches"] = tools["large_launches"]
    kernels[3]["large_ms_per_batch"] = tools["large"]
    kernels[3]["int8_probe"] = tools["int8_probe"]
    log("phase14", seconds=f"{time.perf_counter() - t14:.1f}")

    phase_walls.mark("fused_motion")
    # 15. the fused motion half: two CUDA graphs and K5 on the int8
    # Predictor's subject, the request and the stream against the staged path
    with tempfile.TemporaryDirectory() as tmp:
        pq.results_dir = tmp
        p15 = check_fused_motion(dev, pq, smi)
    for entry, k in zip(kernels[1:3], ("K2", "K3")):
        entry["motion_graph_launches"] = p15["replayed"][k]
        entry["motion_graph_max_abs_err"] = p15["rnn_err"][k]

    phase_walls.mark("rewrites")
    # 16. the renderer's inference rewrites: K4's new forms, whole
    # generators, two requests served from rewritten artifacts, 'large'
    with tempfile.TemporaryDirectory() as tmp:
        kernels[3]["rewrite_forms"] = check_rewrites(dev, pq, tmp)

    phase_walls.mark("model_axis")
    # 17. the model axis: spatial and channel partitioning over two ranks on
    # the card, the activation scale over two data ranks, the dry run
    grid = check_model_axis(dev, pq, models, person)
    for k in ("K1", "K4"):
        kernels[0 if k == "K1" else 3].update(grid[k])
    kernels[0]["dp_rank_step_launches"] = grid["dp_two_ranks"]["k1_a_rank_a_step"]

    phase_walls.mark(None)
    log("phase_walls", **{k: f"{v:.1f}" for k, v in phase_walls.seconds.items()})
    # 9. results
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
