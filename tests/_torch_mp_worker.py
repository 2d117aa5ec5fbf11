"""One rank of the PyTorch port's (data, model) grid test.

Launched four times by tests/test_torch_model_parallel.py with torchrun's
environment (RANK, WORLD_SIZE=4, MASTER_ADDR, MASTER_PORT) and the test's
work directory as its argument.  It joins a gloo group through
livespeechportraits_torch.parallel.multihost, lays the 2 x 2 grid
(parallel.mesh.make_grid(2): rank r at data index r // 2, model index
r % 2) and, from the inputs the test wrote (inputs.pt), runs:

- the channel-sharded generator's eval forward (ngf 8, 5 downsamplings,
  32^2) on its data rank's rows;
- the spatial forward (ngf 8, 5 downsamplings, 64^2) on its data rank's
  rows and its model rank's slab of them, float and int8 (dynamic scales:
  each int8 conv's rows against the one-device forward's);
- the QAT ("fq") fused GAN step with G and D channel-sharded, SGD (lr
  1e-2), on its data rank's rows of the global batch of 8: the mean of the
  data ranks' losses, the gathered post-step state dicts
  (sharding.full_state_dict), the slices' shapes and the replicated leaves;
- ZeRO-1 over the data group against replicated Adam on the same reduced
  gradients of a float fused step;
- parallel.dryrun.dryrun_multichip(4) in this group.

Each rank saves rank<r>.pt for the test to compare.
"""

import copy
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

TP = dict(size="normal", ngf=8, n_downsample=5, load_size=32)
SPATIAL = dict(size="normal", ngf=8, n_downsample=5, load_size=64)
QAT = dict(size="normal", ngf=4, n_downsample=5, load_size=32, num_D=2, n_layers_D=2,
           precision="float32")
MP = 2
QAT_BATCH = 8
LR = 1e-2


def tensors(batch):
    import torch

    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def generator(cfg_kw, sd):
    from livespeechportraits_torch.config import Feature2FaceConfig
    from livespeechportraits_torch.models import feature2face as f2f

    g = f2f.Feature2FaceG(Feature2FaceConfig(**cfg_kw))
    g.load_state_dict(sd, strict=True)
    return g


def tp_forward(inp, grid):
    import torch

    from livespeechportraits_torch.models import feature2face as f2f
    from livespeechportraits_torch.parallel import sharding

    g = sharding.shard_params(generator(TP, inp["tp_g"]), grid)
    rows = inp["tp_x"][grid.data_index:grid.data_index + 1]
    with torch.no_grad():
        y = f2f.apply_generator(g, torch.from_numpy(rows))
    return {"y": y, "shapes": {k: tuple(v.shape) for k, v in g.state_dict().items()},
            "sharded_keys": sorted(g.sharded_keys)}


def spatial_forward(inp, grid):
    import torch

    from livespeechportraits_torch.parallel import sharding

    g = generator(SPATIAL, inp["sp_g"])
    rows = torch.from_numpy(inp["sp_x"][grid.data_index:grid.data_index + 1])
    slab = sharding.shard_spatial(rows, grid, axis=1)
    sharding.EXCHANGED_BYTES = 0
    y = sharding.apply_generator_spatial(g, slab, grid)
    out = {"x_rows": tuple(slab.shape), "y": y, "exchanged": sharding.EXCHANGED_BYTES,
           "gathered": sharding.gather_spatial(y, grid, axis=1)}
    out["int8"] = spatial_int8(g, inp["sp_x"], slab, grid)
    return out


def spatial_int8(g, x_all, slab, grid):
    """The int8 generator (dynamic activation scales) on the slab: each int8
    conv's output rows against the one-device forward of the whole batch
    (this process alone), and how many there were."""
    import torch

    from livespeechportraits_torch.models import feature2face as f2f
    from livespeechportraits_torch.models import nn_core
    from livespeechportraits_torch.parallel import mesh, sharding

    q = f2f.quantize_generator(g)
    ref, orig = {}, nn_core.conv2d_q8

    def record(x, layer, stride, padding):
        ref[id(layer)] = y = orig(x, layer, stride, padding)
        return y

    nn_core.conv2d_q8 = record
    try:
        with torch.no_grad(), mesh.use_grid(mesh.LOCAL):
            f2f.apply_generator(q, torch.from_numpy(x_all))
    finally:
        nn_core.conv2d_q8 = orig
    taps = []
    sharding.apply_generator_spatial(q, slab, grid, taps=taps)
    b = grid.data_index
    q8 = [(layer, rows, r0) for layer, rows, r0 in taps if isinstance(layer, nn_core.QConv2d)]
    return {"layers": len(q8), "one_device_layers": len(ref),
            "bitwise": sum(torch.equal(ref[id(layer)][b:b + 1, :, r0:r0 + rows.shape[2]], rows)
                           for layer, rows, r0 in q8)}


def qat_step(inp, grid):
    import torch

    from livespeechportraits_torch.config import Feature2FaceConfig
    from livespeechportraits_torch.models import feature2face as f2f
    from livespeechportraits_torch.parallel import mesh, multihost, sharding
    from livespeechportraits_torch.train import steps

    cfg = Feature2FaceConfig(**QAT)
    g = sharding.shard_params(f2f.qat_generator(generator(QAT, inp["qat_g"])), grid)
    d = f2f.Feature2FaceD(cfg)
    d.load_state_dict(inp["qat_d"], strict=True)
    sharding.shard_params(d, grid)
    opt_g, opt_d = (torch.optim.SGD(m.parameters(), lr=LR) for m in (g, d))
    with mesh.use_grid(grid):
        local = tensors(multihost.shard_batch(inp["qat_batch"], QAT_BATCH))
    metrics = steps.f2f_fused_step(cfg, g, d, opt_g, opt_d, local)
    with mesh.use_grid(grid):  # the global batch's losses: the data ranks' mean
        loss = torch.stack([metrics["loss_G"], metrics["loss_D"]])
        loss = mesh.all_reduce_sum(loss) / grid.data_size
    out = {"loss_G": loss[0].item(), "loss_D": loss[1].item(), "rows": len(local["tgt_image"])}
    for name, net in (("G", g), ("D", d)):
        sd = net.state_dict()
        out[f"{name}_full"] = sharding.full_state_dict(net)
        out[f"{name}_slices"] = {k: tuple(sd[k].shape) for k in net.sharded_keys}
        out[f"{name}_replicated"] = {k: v.clone() for k, v in sd.items()
                                     if k not in net.sharded_keys}
    return out


def zero1_case(inp, grid):
    """A float fused step's reduced gradients, then ZeRO-1 Adam over the
    data group and replicated Adam on copies: the parameters after two
    updates and each one's optimizer bytes."""
    import torch

    from livespeechportraits_torch.config import Feature2FaceConfig
    from livespeechportraits_torch.models import feature2face as f2f
    from livespeechportraits_torch.parallel import mesh, multihost, sharding
    from livespeechportraits_torch.train import state, steps

    cfg = Feature2FaceConfig(**QAT)
    g = sharding.shard_params(generator(QAT, inp["qat_g"]), grid)
    d = f2f.Feature2FaceD(cfg)
    d.load_state_dict(inp["qat_d"], strict=True)
    sharding.shard_params(d, grid)
    with mesh.use_grid(grid):
        local = tensors(multihost.shard_batch(inp["qat_batch"], QAT_BATCH))
        loss_d, loss_g, _ = steps.f2f_fused_losses(cfg, g, d, local)
        grads = {"D": state.gradients(loss_d, list(d.parameters()), retain_graph=True),
                 "G": state.gradients(loss_g, list(g.parameters()))}
        out = {}
        for name, net in (("G", g), ("D", d)):
            twin = copy.deepcopy(net)
            zero = mesh.Zero1(state.adam(net.parameters(), 1e-3, 0.5, 0.999))
            plain = state.adam(twin.parameters(), 1e-3, 0.5, 0.999)
            for p, q, gr in zip(net.parameters(), twin.parameters(), grads[name]):
                p.grad, q.grad = gr.clone(), gr.clone()
            for _ in range(2):
                zero.step()
                plain.step()
            out[name] = {
                "equal": all(torch.equal(p, q) for p, q in zip(net.parameters(),
                                                                twin.parameters())),
                "state_bytes": zero.state_bytes(),
                "replicated_state_bytes": sum(
                    t.numel() * t.element_size() for s in plain.state.values()
                    for t in s.values() if torch.is_tensor(t)),
                "owners": list(zero.ranks)}
    return out


def main(work: str) -> None:
    import torch

    torch.set_num_threads(1)
    from livespeechportraits_torch.parallel import dryrun, mesh, multihost

    multihost.initialize("cpu")
    assert multihost.world_size() == 4
    grid = mesh.make_grid(MP)
    inp = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    out = {"grid": {"data": (grid.data_size, grid.data_index, grid.data_ranks),
                    "model": (grid.model_size, grid.model_index, grid.model_ranks)}}
    out["tp"] = tp_forward(inp, grid)
    out["spatial"] = spatial_forward(inp, grid)
    out["qat"] = qat_step(inp, grid)
    out["zero1"] = zero1_case(inp, grid)
    out["dryrun"] = dryrun.dryrun_multichip(4, "cpu")
    torch.save(out, os.path.join(work, f"rank{multihost.rank()}.pt"))
    multihost.shutdown()


if __name__ == "__main__":
    main(sys.argv[1])
