"""A dry run of the (data, model) grid: the channel-sharded GAN step under
ZeRO-1, the spatially partitioned inference render and the frame-sharded
int8 render, on tiny shapes.

Counterpart of ``__graft_entry__.dryrun_multichip`` (``__graft_entry__.py:
100-200``), with its mesh rule (4-way model axis from 16 ranks up, 2-way for
an even count above 1, else 1) and its one line:

    python -m livespeechportraits_torch.parallel.dryrun --ranks N [--device cpu]

starts N ranks itself (one a card when there are N cards, NCCL; else every
rank on the first card, or on the CPU, over gloo), or joins the process
group of ``torchrun --nproc_per_node=N -m livespeechportraits_torch.parallel.dryrun``.
Each rank runs:

- the tiny GAN (32^2, 5 downsamplings, num_D 2, n_layers_D 2; ngf 8 as
  JAX's, 16 on the card, where K4 needs Cin % 16 == 0 and the second
  stage's down conv would read 8 channels) with G and D channel-sharded
  (sharding.shard_params) and Adam under ZeRO-1 over the data axis, one
  alternating D and G step (steps.f2f_d_step / f2f_g_step) on its data
  rank's rows of a global batch of 2 x the data axis;
- the inference generator, its weights gathered (sharding.full_state_dict),
  on its model rank's rows of a [data, 32, 32, 13] batch
  (sharding.apply_generator_spatial);
- the int8 renderer (feature2face.quantize_generator, K4 on the card) on
  its 2 of 2 x N frames.

Losses and outputs must be finite.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from livespeechportraits_torch.config import Feature2FaceConfig
from livespeechportraits_torch.models import feature2face as f2f
from livespeechportraits_torch.parallel import mesh, multihost, sharding
from livespeechportraits_torch.train import state, steps, trainer


def model_axis(n: int) -> int:
    """JAX's rule: 4-way from 16 ranks up (the tiny net's channels all divide
    by 4), 2-way for an even count above 1, else 1."""
    if n >= 16 and n % 4 == 0:
        return 4
    return 2 if n % 2 == 0 and n > 1 else 1


def _finite(what: str, t: torch.Tensor) -> None:
    if not torch.isfinite(t).all():
        raise AssertionError(f"dryrun_multichip: non-finite {what}")


def run_rank(device: torch.device) -> str:
    """This rank's part of the dry run in the process group (every rank calls
    it); returns JAX's line."""
    n = multihost.world_size()
    grid = mesh.make_grid(model_axis(n))
    cfg = Feature2FaceConfig(size="normal", ngf=16 if device.type == "cuda" else 8,
                             n_downsample=5, load_size=32, num_D=2, n_layers_D=2,
                             precision="float32")
    gen = torch.Generator().manual_seed(0)
    g = trainer._init(f2f.Feature2FaceG(cfg), gen=gen).to(device)
    d = trainer._init(f2f.Feature2FaceD(cfg), gen=gen).to(device)
    sharding.shard_params(g, grid)
    sharding.shard_params(d, grid)
    rng = np.random.default_rng(0)
    B = 2 * grid.data_size
    batch = {"feature_map": rng.uniform(0, 1, (B, 32, 32, 1)).astype(np.float32),
             "cand_image": rng.uniform(-1, 1, (B, 32, 32, 12)).astype(np.float32),
             "tgt_image": rng.uniform(-1, 1, (B, 32, 32, 3)).astype(np.float32)}
    with mesh.use_grid(grid):
        opt_g = mesh.Zero1(state.adam(g.parameters(), 2e-4, 0.5, 0.999))
        opt_d = mesh.Zero1(state.adam(d.parameters(), 2e-4, 0.5, 0.999))
        local = {k: torch.from_numpy(v).to(device)
                 for k, v in multihost.shard_batch(batch, B).items()}
        metrics = steps.f2f_d_step(cfg, g, d, opt_d, local)
        metrics |= steps.f2f_g_step(cfg, g, d, opt_g, local)
        losses = torch.stack([metrics["loss_D"].detach(), metrics["loss_G"].detach()])
        losses = mesh.all_reduce_sum(losses) / grid.data_size  # the global batch's
    _finite("losses", losses)

    # spatial partitioning: the generator's rows over the model axis
    whole = f2f.Feature2FaceG(cfg).to(device)
    whole.load_state_dict(sharding.full_state_dict(g), strict=True)
    x_sp = torch.from_numpy(rng.uniform(0, 1, (grid.data_size, 32, 32, cfg.input_nc))
                            .astype(np.float32)).to(device)
    y_sp = sharding.apply_generator_spatial(whole, sharding.shard_spatial(x_sp, grid, axis=1),
                                            grid)
    _finite("spatial render", y_sp)

    # the int8 renderer, frames over every rank (the Predictor's data axis)
    frames = rng.uniform(0, 1, (2 * n, 32, 32, cfg.input_nc)).astype(np.float32)
    r = multihost.rank()
    int8 = f2f.cast_generator(f2f.quantize_generator(whole), torch.float32)  # channels_last
    with torch.no_grad():
        y_q = f2f.apply_generator(int8, torch.from_numpy(frames[2 * r:2 * r + 2]).to(device))
    _finite("int8 render", y_q)
    return (f"dryrun_multichip ok: mesh=({grid.data_size}x{grid.model_size}) "
            f"loss_D={losses[0].item():.4f} loss_G={losses[1].item():.4f} sp_render=ok "
            f"int8_dp_serve=ok")


def _rank_device(device: str, rank: int, n: int) -> tuple:
    """(this rank's device, the backend): a card each with NCCL when there
    are n cards; the first card shared over gloo (NCCL refuses two ranks on
    one card) or the CPU over gloo otherwise."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev, "gloo"
    if torch.cuda.device_count() >= n:
        return torch.device("cuda", rank), "nccl"
    return torch.device("cuda", 0), "gloo"


def _spawned(rank: int, n: int, port: int, device: str, out: str) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(n), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    dev, backend = _rank_device(device, rank, n)
    dev = multihost.initialize(dev, backend=backend)
    try:
        line = run_rank(dev)
        if rank == 0:
            with open(out, "w") as f:
                f.write(line)
    finally:
        multihost.shutdown()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_ranks: int, device: str = "cuda") -> str:
    """The dry run over n_ranks ranks; returns (and the command prints) its
    line.  In a process group (torchrun's, or one already joined) this
    process is one rank and the group must have n_ranks; otherwise it
    spawns n_ranks processes and waits for them."""
    if dist.is_initialized() or "WORLD_SIZE" in os.environ:
        dev, backend = _rank_device(device, int(os.environ.get("LOCAL_RANK", 0)), n_ranks)
        dev = multihost.initialize(dev, backend=backend)  # joins once
        if multihost.world_size() != n_ranks:
            raise ValueError(f"the process group has {multihost.world_size()} ranks, the dry "
                             f"run asks for {n_ranks}")
        return run_rank(dev)
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "line")
        mp.start_processes(_spawned, args=(n_ranks, _free_port(), device, out), nprocs=n_ranks,
                           start_method="spawn", join=True)
        with open(out) as f:
            return f.read()


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    line = dryrun_multichip(args.ranks, args.device)
    if multihost.is_primary():
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
