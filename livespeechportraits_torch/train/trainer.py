"""The four trainers: APC pretraining, Audio2Feature, Audio2Headpose and the
Feature2Face GAN.

Counterpart of ``livespeechportraits_tpu/train/trainer.py``: epochs over a host sampler
whose batches a background thread moves to the device, one optimizer step a
batch, the schedule's learning rate set each epoch, a scalar log, validation
on its own generator (seed + 7919, so it neither sees nor advances the
training stream), per-epoch checkpoints and ``<name>/ckpt_best``, the
lowest-validation epoch, which the serving loader prefers.

Beyond JAX: a checkpoint carries the best validation mean so far (JAX
restarts it on resume, ADVICE.md) and the sampler's and dropout's generator
states, so a resumed run repeats the uninterrupted one; ``ckpt_best`` keeps
one epoch (JAX never prunes it).

The trainers run on ``loop.device``, the card unless the caller asks for the
CPU; without a card they raise.  On the card the Feature2Face generator
computes in cfg.precision (bf16 under torch.autocast), and with
``device_rasterize`` each batch's edge maps come from one launch of the
rasteriser kernel K1 (``rasterize_cuda.rasterize_segments``) on the segment
table built on the device from the batch's landmarks and shoulders.

Data parallelism (``data_parallel``; JAX's one-device mesh on one card):
the run is one rank of a ``torch.distributed`` group (``parallel/multihost``:
torchrun's environment, else a group of one rank), ``batch_size`` is the
global batch and each rank feeds its device its own rows of it
(``multihost.global_batch_iter``; a batch that does not divide over the
ranks raises), so K1 draws only those rows.  The models start from rank
0's weights, every gradient is the ranks' mean (``state.gradients``), the
training BatchNorms normalise with the global batch's statistics
(``nn_core.batchnorm``) and the VGG style term with its Gram matrices.
Validation runs every batch on every rank, as JAX replicates its
evaluation batches (no batch needs to divide), and rank 0's means are the
ones every rank keeps (``best_val``).  Rank 0 alone writes checkpoints,
panels and logs.  ``zero1`` (with ``data_parallel`` only) partitions each
optimizer's Adam moments over the ranks (``mesh.Zero1``); a checkpoint
gathers them into the plain format, so a run resumes with or without it.
The caller ends the group (``multihost.shutdown``; the CLI does).

Quantization-aware training (``qat``, ``qat_int8``, ``qat_d``): the
generator is tagged (``f2f.qat_generator``) so that every forward, training
and validation, runs the deployed int8 arithmetic, on K4 with ``qat_int8``;
``qat_d`` runs the discriminator's interior convs on K4 too.  A checkpoint
records the generator's tag (``qat_mode``), and a resume follows JAX's
rules (trainer.py:416-460 there): a float checkpoint under QAT is tagged and
restarts the generator's Adam moments; a checkpoint of the other QAT mode is
retagged and keeps them; a tagged checkpoint with QAT off warns and trains
on in float.
"""

from __future__ import annotations

import time
import warnings
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from livespeechportraits_torch.config import (APCConfig, Audio2FeatureConfig,
                                              Audio2HeadposeConfig, Feature2FaceConfig)
from livespeechportraits_torch.models import apc as apc_model
from livespeechportraits_torch.models import audio2feature as a2f_model
from livespeechportraits_torch.models import audio2headpose as a2h_model
from livespeechportraits_torch.models import feature2face as f2f_model
from livespeechportraits_torch.models import losses, wavenet
from livespeechportraits_torch.ops import rasterize, rasterize_cuda
from livespeechportraits_torch.parallel import mesh, multihost
from livespeechportraits_torch.train import prefetch as prefetch_mod
from livespeechportraits_torch.train import schedulers, state, steps
from livespeechportraits_torch.utils import checkpoint as ckpt
from livespeechportraits_torch.utils.visualizer import Visualizer

Tensor = torch.Tensor
VAL_SEED_OFFSET = 7919


@dataclass
class TrainLoopConfig:
    n_epochs: int = 10
    n_epochs_decay: int = 10
    lr: float = 1e-4
    lr_policy: str = "linear"
    batch_size: int = 32
    print_freq: int = 10
    save_epoch_freq: int = 1
    validate_epoch: int = 1
    seed: int = 0
    checkpoints_dir: str = "./checkpoints"
    name: str = "experiment"
    continue_train: bool = False
    smooth_loss: float = 0.0
    ttur: bool = False
    prefetch: int = 2  # background batch queue depth (0 = synchronous)
    save_best: bool = True  # keep <name>/ckpt_best, the lowest-validation epoch
    device: str = "cuda"
    qat: bool = False  # quantization-aware G: train against the int8 arithmetic
    qat_int8: bool = False  # QAT forward on the int8 kernel K4 (implies qat)
    qat_d: bool = False  # D's interior convs on K4, straight-through gradients
    fused_step: bool = False  # one GAN step from shared forwards (steps.f2f_fused_step)
    remat: bool | int = False  # recompute G's forward (True) or its outer K stages in backward
    vgg_microbatch: int = 0  # chunk and recompute the VGG loss's tower (0 = unchunked)
    data_parallel: bool = False  # one rank of a process group; batch_size is the global batch
    zero1: bool = False  # partition the Adam moments over the ranks (needs data_parallel)

    @property
    def qat_mode(self) -> Optional[str]:
        """The generator's QAT tag this run trains with: "fq8", "fq" or None."""
        return "fq8" if self.qat_int8 else "fq" if self.qat else None


@dataclass
class TrainResult:
    """The trained modules and optimizers (``"params"``, or ``"G"`` and
    ``"D"``), the epochs done, the best validation mean and each step's
    milliseconds (CUDA events on the card, the host clock on the CPU)."""

    models: Dict[str, nn.Module]
    optimizers: Dict[str, torch.optim.Optimizer]
    epochs: int
    best_val: Optional[float]
    step_ms: List[float] = field(default_factory=list)


def _device(loop: TrainLoopConfig) -> torch.device:
    """The run's device; under data_parallel this rank's, in its process
    group (joined here once a process)."""
    if loop.zero1 and not loop.data_parallel:
        raise ValueError("zero1 partitions optimizer state over the data axis and needs "
                         "data_parallel=True (no process group was set up)")
    if loop.data_parallel:
        return multihost.initialize(loop.device)
    dev = torch.device(loop.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {loop.device!r} was asked for but torch sees no CUDA "
                           "device; pass device='cpu' to train on the CPU")
    return dev


class _StepTimer:
    """Each step's time: CUDA events around it on the card (read once, after
    the run), the host clock on the CPU."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        self.marks: list = []

    def start(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def stop(self, t0) -> None:
        self.marks.append((t0, self.start()))

    def ms(self) -> List[float]:
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in self.marks]
        return [(b - a) * 1e3 for a, b in self.marks]


class _Mover:
    """Host batches (numpy) -> tensors on the device.  A candidate stack
    with leading dim 1 is the subject's, shared by every batch: it is moved
    once and reused, keyed on the array it views."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self._cand: dict = {}

    def __call__(self, batch: dict) -> Dict[str, Tensor]:
        out = {}
        for k, v in batch.items():
            if k == "cand_image" and v.ndim == 4 and v.shape[0] == 1:
                base = v.base if isinstance(v.base, np.ndarray) else v
                ent = self._cand.get(id(base))
                if ent is None or ent[0] is not base:
                    ent = self._cand[id(base)] = (base, torch.from_numpy(
                        np.ascontiguousarray(v)).to(self.dev))
                out[k] = ent[1]
            else:
                out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(self.dev)
        return device_rasterize_batch(out)


def device_rasterize_batch(batch: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """A batch with raw ``landmarks`` [B, 73, 2] and ``shoulders`` [B, S, 2]
    (FaceFrameSampler(device_rasterize=True)) gets its ``feature_map`` [B,
    H, W, 1] f32: the segment table built on the batch's device, then one
    rasterize_segments call, which on the card is one launch of K1 (errors
    propagate) and on the CPU its plain twin.  Other batches pass as they
    are."""
    if "landmarks" not in batch:
        return batch
    batch = dict(batch)
    lm, sh = batch.pop("landmarks"), batch.pop("shoulders")
    H, W = batch["tgt_image"].shape[1:3]
    table = rasterize.segment_table(lm, sh)
    batch["feature_map"] = rasterize_cuda.rasterize_segments(table, H, W)[..., None]
    return batch


def _batch_iter(sampler, loop: TrainLoopConfig, rng: np.random.Generator, move: _Mover):
    it = (multihost.global_batch_iter(sampler, loop.batch_size, rng) if loop.data_parallel
          else sampler.batches(loop.batch_size, rng))
    if loop.prefetch > 0:
        return prefetch_mod.prefetch(it, loop.prefetch, move)
    return map(move, it)


def _val_batches(val_sampler, loop: TrainLoopConfig, move: _Mover):
    rng_val = np.random.default_rng(loop.seed + VAL_SEED_OFFSET)
    for b in val_sampler.batches(loop.batch_size, rng_val, shuffle=False, drop_last=False):
        yield move(b)


def _audio_bank(sampler, dev: torch.device):
    """The sampler's resident audio feature bank on the device, once, and
    its window length (AudioVisualSampler(device_audio=True))."""
    bank = getattr(sampler, "audio_bank", None) if sampler is not None else None
    if bank is None:
        return None, None
    return torch.from_numpy(bank).to(dev), sampler.audio_rows


def _rng_state(rng: np.random.Generator, gen: torch.Generator) -> dict:
    return {"numpy": rng.bit_generator.state, "torch": gen.get_state()}


def _set_rng_state(st: dict, rng: np.random.Generator, gen: torch.Generator) -> None:
    rng.bit_generator.state = st["numpy"]
    gen.set_state(st["torch"])


def _schedule_state(schedules: dict) -> dict:
    return {k: s.state_dict() for k, s in schedules.items() if hasattr(s, "state_dict")}


class _Run:
    """What the two kinds of trainer share: the device, the log, the
    checkpoint directories, resume and the epoch's generators.  qat_mode is
    the generator's QAT tag (the GAN trainer's; None elsewhere).  Under
    data_parallel the optimizers become ZeRO-1 partitions (loop.zero1)
    before a resume loads them, and the models take rank 0's weights after
    it; only rank 0 has a log (``vis`` is None elsewhere)."""

    def __init__(self, loop: TrainLoopConfig, models: Dict[str, nn.Module],
                 optimizers: Dict[str, torch.optim.Optimizer], schedules: dict,
                 qat_mode: Optional[str] = None):
        if loop.zero1:
            optimizers = {k: mesh.Zero1(o) for k, o in optimizers.items()}
        self.loop, self.models, self.optimizers, self.schedules = loop, models, optimizers, schedules
        self.qat_mode = qat_mode
        self.primary = multihost.is_primary()
        self.vis = Visualizer(loop.checkpoints_dir, loop.name) if self.primary else None
        self.ckpt_dir = f"{loop.checkpoints_dir}/{loop.name}/ckpt"
        self.rng = np.random.default_rng(loop.seed)
        self.gen = torch.Generator().manual_seed(loop.seed)
        self.start_epoch, self.best_val, self.it = 0, None, 0
        if loop.continue_train and ckpt.latest_step(self.ckpt_dir) is not None:
            raw = ckpt.load_checkpoint(self.ckpt_dir)
            st = ckpt.restore(raw, models, optimizers, fresh=self._resume_rule(raw))
            for k, s in st["schedules"].items():
                schedules[k].load_state_dict(s)
            _set_rng_state(st["rng"], self.rng, self.gen)
            self.start_epoch, self.best_val = st["epoch"], st["best_val"]
            print(f"resumed from epoch {self.start_epoch}")
        for m in models.values():
            mesh.replicate(m)

    def _resume_rule(self, raw: dict) -> tuple:
        """The optimizers a resume restarts: the generator's when QAT starts
        from a float checkpoint.  The tag itself is not in the state dicts,
        so a retag, or dropping the tags, loads them as they are."""
        ck, mode = ckpt.qat_mode(raw), self.qat_mode
        if mode is not None and ck is None:
            print(f"QAT warm-start from float checkpoint (epoch {raw['epoch']}); "
                  "optimizer moments reset")
            return ("G",)
        if ck is not None and mode is None:
            warnings.warn("checkpoint carries QAT tags but qat=False; tags dropped, "
                          "training continues in float")
        elif ck != mode:
            print(f"QAT checkpoint retagged {ck} -> {mode}")
        return ()

    def epochs(self):
        return range(self.start_epoch, self.loop.n_epochs + self.loop.n_epochs_decay)

    def log_step(self, epoch: int, metrics: dict, lr: Optional[float], t0: float, n: int):
        self.it += 1
        if self.primary and self.it % self.loop.print_freq == 0:
            m = {k: v.item() for k, v in metrics.items()}
            if lr is not None:
                m["lr"] = lr
            self.vis.plot_current_errors(m, self.it)
            self.vis.print_current_errors(epoch, self.it, m, (time.time() - t0) / max(n, 1))

    def validated(self, epoch: int, metrics: Dict[str, float], key: str) -> None:
        """Log the epoch's validation means, feed metrics[key] to plateau
        schedules, and keep the epoch of its lowest value in ckpt_best (one
        file).  Every rank takes rank 0's means."""
        metrics = {k: mesh.broadcast_scalar(v) for k, v in metrics.items()}
        if self.primary:
            self.vis.plot_current_errors(metrics, self.it)
        val_mean = metrics[key]
        for s in self.schedules.values():
            if hasattr(s, "update"):
                s.update(val_mean)
        if self.loop.save_best and (self.best_val is None or val_mean < self.best_val):
            self.best_val = val_mean
            self._save(f"{self.ckpt_dir}_best", epoch + 1, keep_only=True)

    def end_epoch(self, epoch: int) -> None:
        if (epoch + 1) % self.loop.save_epoch_freq == 0:
            self._save(self.ckpt_dir, epoch + 1)

    def _save(self, directory: str, epoch: int, keep_only: bool = False) -> None:
        for o in self.optimizers.values():  # every rank gathers the ZeRO-1 moments
            if isinstance(o, mesh.Zero1):
                o.consolidate_state_dict()
        if not self.primary:
            return
        ckpt.save_checkpoint(directory, epoch, self.models, self.optimizers,
                             _schedule_state(self.schedules), self.best_val,
                             rng=_rng_state(self.rng, self.gen), keep_only=keep_only,
                             qat_mode=self.qat_mode)

    def result(self, timer: _StepTimer) -> TrainResult:
        epochs = max(self.start_epoch, self.loop.n_epochs + self.loop.n_epochs_decay)
        return TrainResult(self.models, self.optimizers, epochs, self.best_val, timer.ms())


def _train_single_state(loop: TrainLoopConfig, sampler, val_sampler, model: nn.Module, *,
                        loss_fn: Callable, val_fn: Callable, val_key: str) -> TrainResult:
    """The loop of the APC, A2F and A2H trainers: Adam (0.9, 0.99) on the
    schedule, one step a batch.  loss_fn(model, batch, bank, rows, gen) ->
    (loss, metrics); val_fn(model, batch, bank, rows) -> loss."""
    dev = _device(loop)
    model.to(dev)
    schedule = schedulers.make_schedule(loop.lr_policy, loop.lr, loop.n_epochs,
                                        loop.n_epochs_decay)
    opt = state.adam(model.parameters(), loop.lr, 0.9, 0.99)
    run = _Run(loop, {"params": model}, {"params": opt}, {"params": schedule})
    opt = run.optimizers["params"]
    params = list(model.parameters())
    move = _Mover(dev)
    bank, rows = _audio_bank(sampler, dev)
    val_bank, val_rows = _audio_bank(val_sampler, dev)
    timer = _StepTimer(dev)
    for epoch in run.epochs():
        lr = schedule(epoch)
        state.set_lr(opt, lr)
        t0, n = time.time(), 0
        for batch in _batch_iter(sampler, loop, run.rng, move):
            ts = timer.start()
            loss, metrics = loss_fn(model, batch, bank, rows, run.gen)
            state.apply_gradients(opt, params, loss)
            timer.stop(ts)
            n += 1
            run.log_step(epoch, metrics, lr, t0, n)
        if val_sampler is not None and (epoch + 1) % loop.validate_epoch == 0:
            with torch.no_grad():
                vs = [float(val_fn(model, b, val_bank, val_rows))
                      for b in _val_batches(val_sampler, loop, move)]
            if vs:  # a validation set smaller than the batch logs nothing
                run.validated(epoch, {val_key: float(np.mean(vs))}, val_key)
        run.end_epoch(epoch)
    return run.result(timer)


def train_apc(cfg: APCConfig, loop: TrainLoopConfig, sampler, val_sampler=None,
              init: Optional[apc_model.APCPretrain] = None) -> TrainResult:
    """APC pretraining (L1 future-mel prediction) on MelWindowSampler
    batches.  The checkpoint holds the encoder and the head; serving and
    feature extraction keep the encoder (assets.load_trained_person_models)."""
    model = init if init is not None else _init(apc_model.APCPretrain(cfg), loop.seed)
    return _train_single_state(
        loop, sampler, val_sampler, model,
        loss_fn=lambda m, b, bank, rows, gen: _with_metrics(steps.apc_loss(cfg, m, b)),
        val_fn=lambda m, b, bank, rows: steps.apc_loss(cfg, m, b), val_key="val_l1")


def train_audio2feature(cfg: Audio2FeatureConfig, loop: TrainLoopConfig, sampler,
                        val_sampler=None, init: Optional[a2f_model.Audio2Feature] = None
                        ) -> TrainResult:
    model = init if init is not None else _init(a2f_model.Audio2Feature(cfg), loop.seed)
    return _train_single_state(
        loop, sampler, val_sampler, model,
        loss_fn=lambda m, b, bank, rows, gen: _with_metrics(
            steps.a2f_loss(cfg, m, b, audio_bank=bank, audio_rows=rows)),
        val_fn=lambda m, b, bank, rows: steps.a2f_loss(cfg, m, b, training=False,
                                                       audio_bank=bank, audio_rows=rows),
        val_key="val_loss")


def train_audio2headpose(cfg: Audio2HeadposeConfig, loop: TrainLoopConfig, sampler,
                         val_sampler=None, init: Optional[a2h_model.Audio2Headpose] = None
                         ) -> TrainResult:
    """GMM NLL (+ loop.smooth_loss x the smoothness term); each step draws
    the WaveNet's input-dropout mask from the trainer's torch.Generator."""
    model = init if init is not None else _init(a2h_model.Audio2Headpose(cfg), loop.seed)

    def loss_fn(m, b, bank, rows, gen):
        hist = b["history"]
        # the global batch's masks, this rank's rows (every row outside a group)
        keep = wavenet.dropout_keep(gen, loop.batch_size, hist.shape[2], hist.device)[
            multihost.local_batch_slice(loop.batch_size)]
        return steps.a2h_loss(cfg, m, b, dropout_keep=keep, smooth_loss_weight=loop.smooth_loss,
                              audio_bank=bank, audio_rows=rows)

    return _train_single_state(
        loop, sampler, val_sampler, model, loss_fn=loss_fn,
        val_fn=lambda m, b, bank, rows: steps.a2h_loss(cfg, m, b, training=False,
                                                       audio_bank=bank, audio_rows=rows)[0],
        val_key="val_gmm_nll")


def train_feature2face(cfg: Feature2FaceConfig, loop: TrainLoopConfig, sampler,
                       val_sampler=None, vgg: Optional[losses.VGG19] = None,
                       init_g: Optional[f2f_model.Feature2FaceG] = None,
                       init_d: Optional[f2f_model.Feature2FaceD] = None) -> TrainResult:
    """The GAN trainer: each batch a D step with the pre-update G, then a G
    step with the updated D (steps.f2f_d_step / f2f_g_step), or with
    loop.fused_step one steps.f2f_fused_step; Adam (0.5, 0.999), or TTUR's
    (0, 0.9) at lr / 2 for G and lr x 2 for D.  loop.remat and
    loop.vgg_microbatch reach the generator's forward and the VGG loss.
    Each epoch validates the eval-mode G (val_L1, val_PSNR), keeps the
    lowest val_L1 in ckpt_best, and writes JAX's image panel (input edge
    map | synthesized | target, from a fixed batch drawn once) to
    ``<name>/web``.  With loop.qat / qat_int8
    the generator trained (and returned) is a tagged copy of init_g,
    retagged when init_g carries the other tag.  loop.qat_d tags D once
    here (f2f.qat_discriminator, a view sharing D's parameters): the steps
    see the tagged view, the checkpoints, the optimizer and the result the
    float D."""
    dev = _device(loop)
    gen = torch.Generator().manual_seed(loop.seed)
    g = init_g if init_g is not None else _init(f2f_model.Feature2FaceG(cfg), gen=gen)
    d = init_d if init_d is not None else _init(f2f_model.Feature2FaceD(cfg), gen=gen)
    mode = loop.qat_mode
    if mode is not None and f2f_model.qat_tag_mode(g) not in (None, mode):
        g = f2f_model.strip_qat_generator(g)
    if mode is not None and not f2f_model.is_qat_generator(g):
        g = f2f_model.qat_generator(g, int8_forward=mode == "fq8")
    mode = f2f_model.qat_tag_mode(g)  # an init_g tagged with QAT off keeps its tags
    g.to(dev)
    d.to(dev)
    d_run = f2f_model.qat_discriminator(d) if loop.qat_d else d
    (lr_g, bg), (lr_d, bd) = steps.ttur_learning_rates(loop.lr, loop.ttur)
    schedules = {"G": schedulers.make_schedule(loop.lr_policy, lr_g, loop.n_epochs,
                                               loop.n_epochs_decay),
                 "D": schedulers.make_schedule(loop.lr_policy, lr_d, loop.n_epochs,
                                               loop.n_epochs_decay)}
    opts = {"G": state.adam(g.parameters(), lr_g, *bg), "D": state.adam(d.parameters(), lr_d, *bd)}
    compute_dtype = (torch.bfloat16 if cfg.precision == "bfloat16" and dev.type == "cuda"
                     else None)
    if vgg is not None:
        vgg.to(dev)
    vgg_mb = loop.vgg_microbatch or None
    run = _Run(loop, {"G": g, "D": d}, opts, schedules, qat_mode=mode)
    opts = run.optimizers
    move = _Mover(dev)
    # every rank runs the panel's forward (rank 0 writes it): a QAT forward
    # takes its activation scale over the ranks
    panel = _panel_batch(sampler, loop, move)
    timer = _StepTimer(dev)
    for epoch in run.epochs():
        for k, s in schedules.items():
            state.set_lr(opts[k], s(epoch))
        t0, n = time.time(), 0
        for batch in _batch_iter(sampler, loop, run.rng, move):
            ts = timer.start()
            if loop.fused_step:
                metrics = steps.f2f_fused_step(cfg, g, d_run, opts["G"], opts["D"], batch, vgg,
                                               compute_dtype, loop.remat,
                                               vgg_microbatch=vgg_mb)
            else:
                metrics = steps.f2f_d_step(cfg, g, d_run, opts["D"], batch, compute_dtype)
                metrics |= steps.f2f_g_step(cfg, g, d_run, opts["G"], batch, vgg,
                                            compute_dtype, loop.remat, vgg_mb)
            timer.stop(ts)
            n += 1
            run.log_step(epoch, metrics, None, t0, n)
        if val_sampler is not None and (epoch + 1) % loop.validate_epoch == 0:
            vals = [steps.f2f_validate(g, b, compute_dtype)[1]
                    for b in _val_batches(val_sampler, loop, move)]
            if vals:
                vm = {k: float(np.mean([float(v[k]) for v in vals])) for k in vals[0]}
                if run.primary:
                    run.vis.print_current_errors(epoch, run.it, vm)
                run.validated(epoch, vm, "val_L1")
        if panel is not None:
            _display_panel(run.vis, g, panel, compute_dtype, epoch + 1, run.it)
        run.end_epoch(epoch)
    return run.result(timer)


def _panel_batch(sampler, loop: TrainLoopConfig, move: _Mover) -> Optional[Dict[str, Tensor]]:
    """The epoch panel's fixed batch (JAX trainer.py:425-433): the sampler's
    first min(batch_size, 2) samples in order, drawn with seed + 1, so the
    training stream is not advanced."""
    rng = np.random.default_rng(loop.seed + 1)
    b = next(iter(sampler.batches(min(loop.batch_size, 2, len(sampler)), rng, shuffle=False)),
             None)
    return None if b is None else move(b)


def _display_panel(vis: Optional[Visualizer], g: nn.Module, batch: Dict[str, Tensor],
                   compute_dtype: Optional[torch.dtype], epoch: int, it: int) -> None:
    """JAX's epoch panel (trainer.py:506-517): the first sample's input edge
    map, the eval-mode synthesized frame and the target, each in [-1, 1].
    Every rank runs the forward; the rank with a log (``vis``) writes."""
    fake, _ = steps.f2f_validate(g, batch, compute_dtype)
    if vis is None:
        return
    fm = batch["feature_map"][0, ..., 0].float().cpu().numpy()
    vis.display_current_results({
        "input_feature_map": np.repeat((fm * 2.0 - 1.0)[..., None], 3, -1),
        "synthesized": fake[0].float().cpu().numpy(),
        "target": steps.f2f_target({"tgt_image": batch["tgt_image"][:1]})[0].float().cpu().numpy(),
    }, epoch, it)


def _with_metrics(loss: Tensor):
    return loss, {"loss": loss}


def _init(model: nn.Module, seed: int = 0, gen: Optional[torch.Generator] = None) -> nn.Module:
    """Random init at the JAX init's scales, drawn on the CPU."""
    model.reset_parameters(gen if gen is not None else torch.Generator().manual_seed(seed))
    return model
