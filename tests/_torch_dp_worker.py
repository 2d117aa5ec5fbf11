"""One rank of the PyTorch port's two-process data-parallel test.

Launched twice by tests/test_torch_parallel.py with torchrun's environment
(RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT) and the test's work directory
as its argument.  It joins a gloo group through
livespeechportraits_torch.parallel.multihost and, from the inputs the test
wrote (inputs.pt), runs on its own rows of each global batch:

- one APC and one Audio2Feature step: the local loss, the reduced
  gradients and the parameters and BatchNorm statistics after Adam;
- the VGG perceptual and style loss (its Gram matrices are batch means)
  and its gradient toward the input, in float64;
- the fused GAN step's losses and reduced gradients in float64, then its
  update under ZeRO-1 (mesh.Zero1) beside replicated Adam on the same
  gradients: the parameters, the optimizer-state bytes and the
  consolidated state dict of each;
- the fused GAN step's losses and reduced gradients under --qat and
  --qat_int8 (the "fq" and "fq8" generators, f32) on a global batch whose
  second half has twice the first half's amplitude: one activation scale
  for the global batch;
- the Audio2Feature trainer for two epochs with data_parallel (once with
  zero1, once without), writing checkpoints, and one epoch of the GAN
  trainer with data_parallel and qat (every rank runs the epoch panel's
  forward, whose activation scale is reduced over the ranks);
- local_batch_slice's refusal of a global batch that does not divide.

Each rank saves rank<r>.pt for the test to compare.
"""

import copy
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

A2F = dict(apc_hidden_size=8, lstm_hidden_size=16, output_dim=6, frame_future=2)
APC = dict(mel_dim=8, hidden_size=16, num_layers=2)
F2F = dict(size="normal", ngf=4, n_downsample=5, load_size=32, num_D=2, n_layers_D=2,
           precision="float32")
GLOBAL_BATCH = 4
LR = 1e-3


def tensors(batch):
    import torch

    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def step_case(model, loss_fn, batch):
    """(local loss, reduced gradients, state after one Adam step)."""
    from livespeechportraits_torch.train import state

    params = list(model.parameters())
    opt = state.adam(params, LR, 0.9, 0.99)
    loss = loss_fn(model, tensors(batch))
    grads = state.gradients(loss, params)
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()
    names = [n for n, _ in model.named_parameters()]
    return {"loss": loss.item(), "grads": dict(zip(names, [g.clone() for g in grads])),
            "state": copy.deepcopy(model.state_dict())}


def gan_case(inp):
    import torch

    from livespeechportraits_torch.config import Feature2FaceConfig
    from livespeechportraits_torch.models import feature2face as f2f
    from livespeechportraits_torch.parallel import mesh, multihost
    from livespeechportraits_torch.train import state, steps

    cfg = Feature2FaceConfig(**F2F)
    g, d = f2f.Feature2FaceG(cfg), f2f.Feature2FaceD(cfg)
    g.load_state_dict(inp["gan_g"])
    d.load_state_dict(inp["gan_d"])
    g, d = mesh.replicate(g.double()), mesh.replicate(d.double())
    batch = {k: v.double() for k, v in tensors(
        multihost.shard_batch(inp["gan_batch"], GLOBAL_BATCH)).items()}
    loss_d, loss_g, metrics = steps.f2f_fused_losses(cfg, g, d, batch)
    d_params, g_params = list(d.parameters()), list(g.parameters())
    d_grads = state.gradients(loss_d, d_params, retain_graph=True)
    g_grads = state.gradients(loss_g, g_params)
    out = {"metrics": {k: v.item() for k, v in metrics.items()},
           "d_grads": dict(zip([n for n, _ in d.named_parameters()], d_grads)),
           "g_grads": dict(zip([n for n, _ in g.named_parameters()], g_grads)),
           "stats": {**{f"G.{k}": v.clone() for k, v in g.state_dict().items() if "running" in k},
                     **{f"D.{k}": v.clone() for k, v in d.state_dict().items()
                        if "running" in k}}}
    # ZeRO-1 against replicated Adam on the same (reduced) gradients
    plain_g, plain_d = copy.deepcopy(g), copy.deepcopy(d)
    zero, plain = {}, {}
    for name, net, twin, grads in (("G", g, plain_g, g_grads), ("D", d, plain_d, d_grads)):
        zero[name] = mesh.Zero1(state.adam(net.parameters(), LR, 0.5, 0.999))
        plain[name] = state.adam(twin.parameters(), LR, 0.5, 0.999)
        for p, q, grad in zip(net.parameters(), twin.parameters(), grads):
            p.grad, q.grad = grad.clone(), grad.clone()
        for _ in range(2):  # two updates: the second reads the moments the first wrote
            zero[name].step()
            plain[name].step()
    out["zero1"] = {"G": copy.deepcopy(g.state_dict()), "D": copy.deepcopy(d.state_dict())}
    out["replicated"] = {"G": plain_g.state_dict(), "D": plain_d.state_dict()}
    out["state_bytes"] = {k: zero[k].state_bytes() for k in zero}
    out["replicated_state_bytes"] = {
        k: sum(t.numel() * t.element_size() for s in o.state.values() for t in s.values()
               if torch.is_tensor(t)) for k, o in plain.items()}
    for o in zero.values():
        o.consolidate_state_dict()
    out["zero1_opt"] = {k: o.state_dict() for k, o in zero.items()}
    out["replicated_opt"] = {k: o.state_dict() for k, o in plain.items()}
    return out


def qat_case(inp, int8: bool):
    """The fused step's metrics, reduced gradients and running statistics
    with the QAT-tagged generator ("fq", or "fq8" with int8), f32, on this
    rank's rows."""
    from livespeechportraits_torch.config import Feature2FaceConfig
    from livespeechportraits_torch.models import feature2face as f2f
    from livespeechportraits_torch.parallel import multihost

    g, d = gan_models(inp)
    g = f2f.qat_generator(g, int8_forward=int8)
    batch = tensors(multihost.shard_batch(inp["qat_batch"], GLOBAL_BATCH))
    return gan_grads(Feature2FaceConfig(**F2F), g, d, batch)


def gan_models(inp):
    from livespeechportraits_torch.config import Feature2FaceConfig
    from livespeechportraits_torch.models import feature2face as f2f
    from livespeechportraits_torch.parallel import mesh

    cfg = Feature2FaceConfig(**F2F)
    g, d = f2f.Feature2FaceG(cfg), f2f.Feature2FaceD(cfg)
    g.load_state_dict(inp["gan_g"])
    d.load_state_dict(inp["gan_d"])
    return mesh.replicate(g), mesh.replicate(d)


def gan_grads(cfg, g, d, batch):
    """The fused step's metrics, both networks' reduced gradients by name and
    the running statistics after its forwards."""
    from livespeechportraits_torch.train import state, steps

    loss_d, loss_g, metrics = steps.f2f_fused_losses(cfg, g, d, batch)
    d_grads = state.gradients(loss_d, list(d.parameters()), retain_graph=True)
    g_grads = state.gradients(loss_g, list(g.parameters()))
    return {"metrics": {k: v.item() for k, v in metrics.items()},
            "d_grads": dict(zip([n for n, _ in d.named_parameters()], d_grads)),
            "g_grads": dict(zip([n for n, _ in g.named_parameters()], g_grads)),
            "stats": {**{f"G.{k}": v.clone() for k, v in g.state_dict().items() if "running" in k},
                      **{f"D.{k}": v.clone() for k, v in d.state_dict().items()
                         if "running" in k}}}


def vgg_case(batch):
    """(perceptual, style, d (perceptual + style) / d x) of this rank's rows."""
    import torch

    from livespeechportraits_torch.models import losses

    vgg = losses.init_vgg19(0).double()
    x = torch.from_numpy(batch["x"]).double().requires_grad_(True)
    p, s = losses.vgg_style_loss(vgg, x, torch.from_numpy(batch["y"]).double())
    (gx,) = torch.autograd.grad(p + s, x)
    return {"p": p.item(), "s": s.item(), "gx": gx}


def trainer_runs(work):
    from livespeechportraits_torch.config import Audio2FeatureConfig
    from livespeechportraits_torch.train import __main__ as cli
    from livespeechportraits_torch.train import datasets, trainer

    cfg = Audio2FeatureConfig(apc_hidden_size=512, lstm_hidden_size=16, output_dim=75)
    for zero1 in (True, False):
        clips = cli.synthetic_clips(1, 200)
        sampler = datasets.AudioVisualSampler(clips, task="audio2feature", seq_len=32,
                                              frame_jump_stride=12, tail_margin=60,
                                              device_audio=True)
        # 5 windows: batches of 4 and 1, the second not divisible over the ranks
        val = datasets.AudioVisualSampler(clips, task="audio2feature", seq_len=32,
                                          frame_jump_stride=28, tail_margin=60,
                                          device_audio=True)
        loop = trainer.TrainLoopConfig(
            n_epochs=1, n_epochs_decay=1, batch_size=GLOBAL_BATCH, print_freq=1,
            checkpoints_dir=os.path.join(work, "zero1" if zero1 else "replicated"),
            name="a2f", device="cpu", prefetch=0, data_parallel=True, zero1=zero1)
        trainer.train_audio2feature(cfg, loop, sampler, val)
    from livespeechportraits_torch.config import Feature2FaceConfig

    loop = trainer.TrainLoopConfig(
        n_epochs=1, n_epochs_decay=0, batch_size=GLOBAL_BATCH, print_freq=1,
        checkpoints_dir=os.path.join(work, "qat"), name="f2f", device="cpu", prefetch=0,
        data_parallel=True, qat=True)
    trainer.train_feature2face(Feature2FaceConfig(**F2F), loop, cli.synthetic_face_data(8, 32))


def main(work: str) -> None:
    import torch

    torch.set_num_threads(1)
    from livespeechportraits_torch.config import APCConfig, Audio2FeatureConfig
    from livespeechportraits_torch.models import apc, audio2feature
    from livespeechportraits_torch.parallel import mesh, multihost
    from livespeechportraits_torch.train import steps

    dev = multihost.initialize("cpu")
    assert dev.type == "cpu" and multihost.world_size() == 2
    rank = multihost.rank()
    inp = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    out = {"primary": multihost.is_primary()}
    try:
        multihost.local_batch_slice(3)
    except ValueError as e:
        out["refusal"] = str(e)

    a2f_cfg = Audio2FeatureConfig(**A2F)
    model = audio2feature.Audio2Feature(a2f_cfg)
    model.load_state_dict(inp["a2f"])
    out["a2f"] = step_case(mesh.replicate(model),
                           lambda m, b: steps.a2f_loss(a2f_cfg, m, b),
                           multihost.shard_batch(inp["a2f_batch"], GLOBAL_BATCH))
    apc_cfg = APCConfig(**APC)
    model = apc.APCPretrain(apc_cfg)
    model.load_state_dict(inp["apc"])
    out["apc"] = step_case(mesh.replicate(model), lambda m, b: steps.apc_loss(apc_cfg, m, b),
                           multihost.shard_batch(inp["apc_batch"], GLOBAL_BATCH))
    out["vgg"] = vgg_case(multihost.shard_batch(inp["vgg_batch"], GLOBAL_BATCH))
    out["gan"] = gan_case(inp)
    out["qat"] = qat_case(inp, False)
    out["qat_int8"] = qat_case(inp, True)
    trainer_runs(work)
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    multihost.shutdown()


if __name__ == "__main__":
    main(sys.argv[1])
