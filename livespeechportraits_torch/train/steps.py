"""The training steps and validators of the four trainers.

Counterpart of ``livespeechportraits_tpu/train/steps.py``: each model's
loss on one batch of tensors, and one optimizer step on it
(``state.apply_gradients``).  JAX jits a pure step (state, batch) -> state;
here a step updates the modules, their BatchNorm running stats and the
optimizer in place.

Feature2Face has JAX's two forms.  The alternating pair (steps.py:274-393
there):
- ``f2f_d_loss`` runs G in eval mode under no_grad (the fake is detached)
  and D in training mode, the running stats taken from the real pair's
  forward only; loss (2 real + fake) / 2;
- ``f2f_g_loss`` runs G in training mode and D in eval mode; its gradient
  reaches G only; loss GAN + lambda_L1 L1 + VGG + style + feature matching;
- the trainer calls ``f2f_d_step`` with the pre-update G, then
  ``f2f_g_step`` with the updated D.
The fused step (``f2f_fused_step``, steps.py:396-528 there) shares one G
forward and two D forwards, all in training mode, between both losses and
takes both gradients at the pre-update parameters.
With ``compute_dtype`` the generator's forward runs under torch.autocast in
that dtype (JAX casts the generator alone to its compute dtype); the
discriminator, the losses, the parameters and Adam's moments stay f32.
``remat`` recomputes the generator's forward, or its outer stages, in the
backward (f2f.apply_generator), ``vgg_microbatch`` chunks the VGG loss
(losses.vgg_style_loss).  Under --qat_d the trainer hands these steps a
discriminator tagged once (f2f.qat_discriminator), whose interior convs run
on K4 with straight-through gradients.  A generator channel-sharded over a
(data, model) grid (parallel.sharding.shard_params) carries its grid, and
the Feature2Face steps and losses run under it (mesh.use_grid): the
gradients, the BatchNorm statistics and the VGG Gram matrices are reduced
over its data axis.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from livespeechportraits_torch.config import (APCConfig, Audio2FeatureConfig,
                                              Audio2HeadposeConfig, Feature2FaceConfig)
from livespeechportraits_torch.models import apc as apc_model
from livespeechportraits_torch.models import audio2feature as a2f
from livespeechportraits_torch.models import audio2headpose as a2h
from livespeechportraits_torch.models import feature2face as f2f
from livespeechportraits_torch.models import losses
from livespeechportraits_torch.ops import gmm
from livespeechportraits_torch.parallel import mesh
from livespeechportraits_torch.train import state

Tensor = torch.Tensor
Batch = Dict[str, Tensor]
Metrics = Dict[str, Tensor]
Remat = Union[bool, int]


def _grid(g: f2f.Feature2FaceG) -> Optional[mesh.Grid]:
    """The grid a channel-sharded generator carries (None otherwise)."""
    return getattr(g, "grid", None)


def f2f_g_input(batch: Batch) -> Tensor:
    """The generator's input [B, H, W, 13]: the feature map, then the
    candidates, whose shared [1, H, W, 12] tensor is broadcast to the
    batch."""
    fmap, cand = batch["feature_map"], batch["cand_image"]
    if cand.shape[0] != fmap.shape[0]:
        cand = cand.expand(fmap.shape[0], *cand.shape[1:])
    return torch.cat([fmap, cand.to(fmap.dtype)], dim=-1)


def f2f_target(batch: Batch) -> Tensor:
    """The target frame in [-1, 1] f32; a uint8 frame is normalised with the
    host's expression ((x / 255) - 0.5) / 0.5."""
    tgt = batch["tgt_image"]
    if tgt.dtype == torch.uint8:
        tgt = (tgt.float() / 255.0 - 0.5) / 0.5
    return tgt


def _batch_audio(batch: Batch, audio_bank: Optional[Tensor], audio_rows: Optional[int],
                 fold_pairs: bool) -> Tensor:
    """The batch's audio windows: shipped in the batch ("audio"), or
    gathered from the resident feature bank at the batch's "audio_start"
    rows, each start clamped so that its window lies in the bank, as JAX's
    dynamic_slice clamps.  fold_pairs: [B, rows / 2, 2F] (the head-pose
    window layout)."""
    if audio_bank is None or "audio_start" not in batch:
        return batch["audio"]
    start = batch["audio_start"].long().clamp(0, audio_bank.shape[0] - audio_rows)
    idx = start[:, None] + torch.arange(audio_rows, device=start.device)
    win = audio_bank[idx]
    if fold_pairs:
        win = win.reshape(win.shape[0], audio_rows // 2, -1)
    return win


# ---------------------------------------------------------------------------
# APC pretraining: L1 future-frame prediction
# ---------------------------------------------------------------------------


def apc_loss(cfg: APCConfig, model: apc_model.APCPretrain, batch: Batch) -> Tensor:
    """L1 between row t's prediction and mel row t + time_shift."""
    mels = batch["mels"]
    preds = apc_model.apply_apc_pretrain(model, mels, residual=cfg.residual)
    n = cfg.time_shift
    return torch.mean((preds[:, :-n] - mels[:, n:]).abs())


# ---------------------------------------------------------------------------
# Audio2Feature: MSE x 1000 (or the GMM NLL) with the frame_future shift
# ---------------------------------------------------------------------------


def _a2f_loss(cfg: Audio2FeatureConfig, preds: Tensor, target: Tensor) -> Tensor:
    ff = cfg.frame_future
    if ff > 0:
        preds, target = preds[:, ff:], target[:, :-ff]
    if cfg.loss == "GMM":
        return gmm.gmm_log_loss(preds, target, cfg.gmm_ncenter, cfg.output_dim,
                                cfg.gmm_sigma_min)
    return torch.mean((preds - target) ** 2) * 1000.0


def a2f_loss(cfg: Audio2FeatureConfig, model: a2f.Audio2Feature, batch: Batch,
             training: bool = True, audio_bank: Optional[Tensor] = None,
             audio_rows: Optional[int] = None) -> Tensor:
    """The frame-future-shifted loss; training=False is the validation loss
    (eval-mode BatchNorm)."""
    audio = _batch_audio(batch, audio_bank, audio_rows, fold_pairs=False)
    preds = a2f.apply_audio2feature(model, audio, training=training, batched=True)
    return _a2f_loss(cfg, preds, batch["target"])


# ---------------------------------------------------------------------------
# Audio2Headpose: GMM NLL (+ the optional smoothness term)
# ---------------------------------------------------------------------------


def a2h_loss(cfg: Audio2HeadposeConfig, model: a2h.Audio2Headpose, batch: Batch,
             training: bool = True, dropout_keep: Optional[Tensor] = None,
             smooth_loss_weight: float = 0.0, audio_bank: Optional[Tensor] = None,
             audio_rows: Optional[int] = None) -> Tuple[Tensor, Metrics]:
    """(loss, metrics): the GMM NLL of the target window, plus
    smooth_loss_weight x the second difference of the first component's
    means against the target's.  training=False is the validation loss
    (eval-mode BatchNorm, no dropout)."""
    target = batch["target"]
    audio = _batch_audio(batch, audio_bank, audio_rows, fold_pairs=True)
    preds = a2h.apply_audio2headpose(model, batch["history"], audio,
                                     output_length=target.shape[1], training=training,
                                     dropout_keep=dropout_keep)
    loss = gmm.gmm_log_loss(preds, target, cfg.ncenter, cfg.ndim, cfg.sigma_min)
    metrics = {"gmm_nll": loss}
    if smooth_loss_weight > 0:
        nc, nd = cfg.ncenter, cfg.ndim
        mu = preds[..., nc:nc + nc * nd].reshape(*preds.shape[:2], nc, nd)[:, :, 0]
        smooth = (mu[:, 2:] + target[:, :-2] - 2.0 * target[:, 1:-1]).mean(dim=2).abs().mean()
        metrics["smooth"] = smooth
        loss = loss + smooth_loss_weight * smooth
    metrics["loss"] = loss
    return loss, metrics


# ---------------------------------------------------------------------------
# Feature2Face: LSGAN + L1 + VGG / style + feature matching, D then G
# ---------------------------------------------------------------------------


def _g_forward(g: f2f.Feature2FaceG, inp: Tensor, training: bool,
               compute_dtype: Optional[torch.dtype], remat: Remat = False) -> Tensor:
    """The generator's f32 output; with compute_dtype, its convolutions run
    under torch.autocast in that dtype (the tanh in f32).  remat: see
    f2f.apply_generator."""
    with torch.autocast(inp.device.type, dtype=compute_dtype or torch.bfloat16,
                        enabled=compute_dtype is not None):
        return f2f.apply_generator(g, inp, training=training, remat=remat)


def f2f_d_loss(cfg: Feature2FaceConfig, g: f2f.Feature2FaceG, d: f2f.Feature2FaceD,
               batch: Batch, compute_dtype: Optional[torch.dtype] = None
               ) -> Tuple[Tensor, Metrics]:
    inp = f2f_g_input(batch)
    with torch.no_grad():
        fake = _g_forward(g, inp, False, compute_dtype)
    real_pair = torch.cat([inp, f2f_target(batch)], dim=-1)
    fake_pair = torch.cat([inp, fake], dim=-1)
    pred_real = f2f.apply_discriminator(d, real_pair, training=True)
    pred_fake = f2f.apply_discriminator(d, fake_pair, training=True, update_stats=False)
    return _d_loss_terms(cfg, pred_real, pred_fake)


def _d_loss_terms(cfg: Feature2FaceConfig, pred_real, pred_fake) -> Tuple[Tensor, Metrics]:
    # the real pair weighs twice (the reference's feature2face_model.py:166-171)
    loss_real = losses.gan_loss(pred_real, True, cfg.gan_mode) * 2.0
    loss_fake = losses.gan_loss(pred_fake, False, cfg.gan_mode)
    loss = (loss_real + loss_fake) * 0.5
    return loss, {"D_real": loss_real, "D_fake": loss_fake, "loss_D": loss}


def f2f_g_loss(cfg: Feature2FaceConfig, g: f2f.Feature2FaceG, d: f2f.Feature2FaceD,
               batch: Batch, vgg: Optional[losses.VGG19] = None,
               compute_dtype: Optional[torch.dtype] = None, remat: Remat = False,
               vgg_microbatch: Optional[int] = None) -> Tuple[Tensor, Metrics]:
    inp = f2f_g_input(batch)
    with mesh.use_grid(_grid(g)):
        fake = _g_forward(g, inp, True, compute_dtype, remat)
        tgt = f2f_target(batch)
        with torch.no_grad():  # feature matching detaches the real features
            pred_real = f2f.apply_discriminator(d, torch.cat([inp, tgt], dim=-1))
        pred_fake = f2f.apply_discriminator(d, torch.cat([inp, fake], dim=-1))
        return _g_loss_terms(cfg, fake, tgt, pred_fake, pred_real, vgg, vgg_microbatch)


def _g_loss_terms(cfg: Feature2FaceConfig, fake: Tensor, tgt: Tensor, pred_fake, pred_real,
                  vgg: Optional[losses.VGG19], vgg_microbatch: Optional[int]
                  ) -> Tuple[Tensor, Metrics]:
    """GAN + lambda_L1 L1 + VGG + style + feature matching against the
    (detached) real features."""
    loss_gan = losses.gan_loss(pred_fake, True, cfg.gan_mode, for_discriminator=False)
    loss_l1 = torch.mean((fake - tgt).abs()) * cfg.lambda_L1
    zero = fake.new_zeros(())
    loss_vgg = loss_style = zero
    if vgg is not None:
        p_loss, s_loss = losses.vgg_style_loss(vgg, fake, tgt, microbatch=vgg_microbatch)
        loss_vgg, loss_style = p_loss * cfg.lambda_feat, s_loss * cfg.lambda_feat
    loss_fm = losses.feature_matching_loss(pred_fake, pred_real, cfg.num_D, cfg.n_layers_D,
                                           cfg.lambda_feat)
    loss = loss_gan + loss_l1 + loss_vgg + loss_style + loss_fm
    return loss, {"loss_G_GAN": loss_gan, "L1": loss_l1, "VGG": loss_vgg, "Style": loss_style,
                  "loss_G_FM": loss_fm, "loss_G": loss}


def f2f_d_step(cfg: Feature2FaceConfig, g: f2f.Feature2FaceG, d: f2f.Feature2FaceD,
               opt_d: torch.optim.Optimizer, batch: Batch,
               compute_dtype: Optional[torch.dtype] = None) -> Metrics:
    with mesh.use_grid(_grid(g)):
        loss, metrics = f2f_d_loss(cfg, g, d, batch, compute_dtype)
        state.apply_gradients(opt_d, list(d.parameters()), loss)
    return metrics


def f2f_g_step(cfg: Feature2FaceConfig, g: f2f.Feature2FaceG, d: f2f.Feature2FaceD,
               opt_g: torch.optim.Optimizer, batch: Batch, vgg: Optional[losses.VGG19] = None,
               compute_dtype: Optional[torch.dtype] = None, remat: Remat = False,
               vgg_microbatch: Optional[int] = None) -> Metrics:
    with mesh.use_grid(_grid(g)):
        loss, metrics = f2f_g_loss(cfg, g, d, batch, vgg, compute_dtype, remat, vgg_microbatch)
        state.apply_gradients(opt_g, list(g.parameters()), loss)
    return metrics


def f2f_fused_losses(cfg: Feature2FaceConfig, g: f2f.Feature2FaceG, d: f2f.Feature2FaceD,
                     batch: Batch, vgg: Optional[losses.VGG19] = None,
                     compute_dtype: Optional[torch.dtype] = None, remat: Remat = False,
                     remat_d: bool = False, vgg_microbatch: Optional[int] = None
                     ) -> Tuple[Tensor, Tensor, Metrics]:
    """(loss_D, loss_G, metrics) of the fused step's shared forwards (JAX
    steps.py:396-528): one training-mode G forward, then D in training mode
    on the real pair (its running stats move) and on the fake pair (batch
    statistics, stats left as they are; the fake not detached).  loss_D is
    JAX's (2 real + fake) / 2; loss_G is GAN + L1 + VGG / style (chunked by
    vgg_microbatch) + feature matching against the real pair's (detached)
    features.  remat_d runs each D tower under f2f.checkpointed."""
    inp = f2f_g_input(batch)
    tgt = f2f_target(batch)

    def d_tower(pair: Tensor, update_stats: bool):
        if remat_d:
            return f2f.checkpointed(
                lambda t, upd: f2f.apply_discriminator(d, t, training=True, update_stats=upd),
                pair, update_stats)
        return f2f.apply_discriminator(d, pair, training=True, update_stats=update_stats)

    with mesh.use_grid(_grid(g)):
        fake = _g_forward(g, inp, True, compute_dtype, remat)
        pred_real = d_tower(torch.cat([inp, tgt], dim=-1), True)
        pred_fake = d_tower(torch.cat([inp, fake], dim=-1), False)
        loss_d, d_metrics = _d_loss_terms(cfg, pred_real, pred_fake)
        loss_g, g_metrics = _g_loss_terms(cfg, fake, tgt, pred_fake, pred_real, vgg,
                                          vgg_microbatch)
    return loss_d, loss_g, g_metrics | d_metrics


def f2f_fused_step(cfg: Feature2FaceConfig, g: f2f.Feature2FaceG, d: f2f.Feature2FaceD,
                   opt_g: torch.optim.Optimizer, opt_d: torch.optim.Optimizer, batch: Batch,
                   vgg: Optional[losses.VGG19] = None,
                   compute_dtype: Optional[torch.dtype] = None, remat: Remat = False,
                   remat_d: bool = False, vgg_microbatch: Optional[int] = None) -> Metrics:
    """One GAN step that updates D and G from shared forwards: 1 G forward
    and 2 D forwards, where the alternating pair runs 2 and 4.  D's
    gradient is d loss_D / d D's parameters; G's is d loss_G / d G's
    parameters, reaching G through the fake-pair D tower and the fake.
    Both are taken at the pre-update parameters (simultaneous descent, JAX
    steps.py:425-433), then both optimizers step.  Two torch.autograd.grad
    calls, each toward one network's parameters, keep loss_G's gradient out
    of D and loss_D's out of G; the first keeps the graph for the second.
    The metrics come back detached: loss_D's graph keeps the real pair's D
    tower, which the second gradient does not free."""
    loss_d, loss_g, metrics = f2f_fused_losses(cfg, g, d, batch, vgg, compute_dtype, remat,
                                               remat_d, vgg_microbatch)
    d_params, g_params = list(d.parameters()), list(g.parameters())
    with mesh.use_grid(_grid(g)):
        d_grads = state.gradients(loss_d, d_params, retain_graph=True)
        g_grads = state.gradients(loss_g, g_params)
    for params, grads, opt in ((d_params, d_grads, opt_d), (g_params, g_grads, opt_g)):
        for p, grad in zip(params, grads):
            p.grad = grad
        opt.step()
    return {k: v.detach() for k, v in metrics.items()}


@torch.no_grad()
def f2f_validate(g: f2f.Feature2FaceG, batch: Batch,
                 compute_dtype: Optional[torch.dtype] = None) -> Tuple[Tensor, Metrics]:
    """The eval-mode frame and its L1 and PSNR (over the [-1, 1] range)
    against the target."""
    fake = _g_forward(g, f2f_g_input(batch), False, compute_dtype)
    err = fake - f2f_target(batch)
    mse = torch.mean(err ** 2)
    psnr = 10.0 * torch.log10(4.0 / torch.clamp(mse, min=1e-12))
    return fake, {"val_L1": torch.mean(err.abs()), "val_PSNR": psnr}


def ttur_learning_rates(lr: float, ttur: bool, beta1: float = 0.5):
    """((lr_G, betas_G), (lr_D, betas_D)): TTUR halves G's rate and doubles
    D's, both with betas (0, 0.9) (the reference's feature2face_model.py:45-56)."""
    if ttur:
        return (lr / 2, (0.0, 0.9)), (lr * 2, (0.0, 0.9))
    return (lr, (beta1, 0.999)), (lr, (beta1, 0.999))
