"""Data parallelism over the ranks of a process group, and over devices.

Counterpart of ``livespeechportraits_tpu/parallel/mesh.py``.  JAX lays a
(data, model) mesh over the devices and lets XLA insert the collectives;
here the data axis is explicit:

- ``make_mesh(device)``: the data axis of a frame-sharded render, every
  visible device of that type (``Predictor(data_parallel=True)``);
- ``replicate(module)``: rank 0's parameters and buffers on every rank;
- ``allreduce_gradients(grads)``: the ranks' mean gradient, one all-reduce
  of a flat bucket (``state.gradients`` calls it, so every trainer step,
  both gradients of the fused GAN step included, is reduced; the steps take
  their gradients with ``torch.autograd.grad``, which DDP's reducer would not
  see);
- ``all_reduce_sum(x)``: a differentiable all-reduce, for the training
  BatchNorms' global statistics (``nn_core.batchnorm``);
- ``Zero1``: ZeRO stage 1, each rank holding the Adam moments of its share
  of the parameters (JAX's ``zero1_place``).

Every loss of the trainers is a mean over equal local slices, so the mean
of the ranks' gradients is the gradient of the global batch's loss.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from livespeechportraits_torch.parallel import multihost

Tensor = torch.Tensor


def make_mesh(device: str | torch.device = "cuda") -> List[torch.device]:
    """Every visible device of ``device``'s type: the card's devices in
    index order, or the CPU.  With one card the split over it is the
    identity, as JAX's one-device mesh is."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


@torch.no_grad()
def replicate(module: torch.nn.Module) -> torch.nn.Module:
    """Rank 0's parameters and buffers broadcast to every rank (in place)."""
    if multihost.world_size() > 1:
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0)
    return module


def _flat(tensors: Sequence[Tensor]) -> Tensor:
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1:
        raise ValueError(f"one bucket holds one dtype, got {sorted(map(str, dtypes))}")
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat(flat: Tensor, like: Sequence[Tensor]) -> List[Tensor]:
    return [p.view_as(t) for p, t in zip(flat.split([t.numel() for t in like]), like)]


def allreduce_gradients(grads: Sequence[Tensor]) -> List[Tensor]:
    """The mean of each gradient over the ranks: all_reduce(SUM) of one flat
    bucket, then / world.  Outside a process group the gradients pass as
    they are; a group of one rank still runs the all-reduce."""
    if not dist.is_initialized() or not grads:
        return list(grads)
    flat = _flat(grads)
    dist.all_reduce(flat)
    flat /= dist.get_world_size()
    return _unflat(flat, grads)


class _AllReduceSum(torch.autograd.Function):
    """y = the sum of x over the ranks, on every rank.  Its adjoint is the
    same sum: the ranks' gradients are averaged afterwards, so the gradient
    reaching each rank's x must be the sum of the ranks' upstream ones."""

    @staticmethod
    def forward(ctx, x: Tensor) -> Tensor:
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g: Tensor) -> Tensor:
        g = g.clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: Tensor) -> Tensor:
    """The sum of x over the ranks, differentiable (see _AllReduceSum)."""
    return _AllReduceSum.apply(x)


def broadcast_scalar(value: float) -> float:
    """Rank 0's value on every rank (each rank's own outside a group)."""
    if multihost.world_size() == 1:
        return value
    out = [value]
    dist.broadcast_object_list(out, src=0)
    return out[0]


class Zero1:
    """ZeRO stage 1 (Rajbhandari et al. 2020) over an optimizer whose update
    is elementwise (Adam): each parameter is owned by one rank, chosen
    greedily by size so that the ranks hold about equal shares; a rank's
    optimizer keeps the moments of its own parameters only and steps them,
    then each owner broadcasts its updated parameters in one flat bucket.
    The gradients are the reduced ones every rank holds, so the update is
    replicated Adam's, bitwise.

    ``param_groups`` are the local optimizer's (a learning-rate change
    reaches it).  ``consolidate_state_dict()`` (collective) gathers the
    moments to every rank in the wrapped optimizer's own format, which
    ``state_dict()`` then returns; ``load_state_dict`` takes that format, so
    a checkpoint resumes with or without ZeRO-1."""

    def __init__(self, optimizer: torch.optim.Optimizer):
        if not dist.is_initialized():
            raise ValueError("zero1 partitions optimizer state over the data axis and "
                             "needs data_parallel=True (no process group was set up)")
        world, me = dist.get_world_size(), dist.get_rank()
        self.params = [p for g in optimizer.param_groups for p in g["params"]]
        load = [0] * world
        self.owner = [0] * len(self.params)
        for i in sorted(range(len(self.params)), key=lambda i: -self.params[i].numel()):
            r = min(range(world), key=lambda r: load[r])
            self.owner[i], load[r] = r, load[r] + self.params[i].numel()
        index = {id(p): i for i, p in enumerate(self.params)}
        # the global index of each local parameter, in the local optimizer's order
        self.global_index = [index[id(p)] for g in optimizer.param_groups
                             for p in g["params"] if self.owner[index[id(p)]] == me]
        groups = [dict(g, params=[p for p in g["params"] if self.owner[index[id(p)]] == me])
                  for g in optimizer.param_groups]
        self.local = type(optimizer)(groups, **optimizer.defaults)
        self._group_sizes = [len(g["params"]) for g in optimizer.param_groups]
        self._full: Optional[dict] = None
        self.load_state_dict(optimizer.state_dict())

    @property
    def param_groups(self):
        return self.local.param_groups

    def state_bytes(self) -> int:
        """The bytes of optimizer state this rank holds."""
        return sum(t.numel() * t.element_size() for s in self.local.state.values()
                   for t in s.values() if torch.is_tensor(t))

    @torch.no_grad()
    def step(self) -> None:
        self.local.step()
        me = dist.get_rank()
        for r in range(dist.get_world_size()):
            owned = [p for p, o in zip(self.params, self.owner) if o == r]
            if not owned:
                continue
            flat = _flat(owned) if r == me else torch.empty(
                sum(p.numel() for p in owned), dtype=owned[0].dtype, device=owned[0].device)
            dist.broadcast(flat, src=r)
            if r != me:
                for p, v in zip(owned, _unflat(flat, owned)):
                    p.copy_(v)

    def consolidate_state_dict(self) -> None:
        """Gather every rank's moments (a collective: every rank calls it)."""
        local = self.local.state_dict()
        mine = {self.global_index[j]: {k: v.cpu() if torch.is_tensor(v) else v
                                       for k, v in s.items()}
                for j, s in local["state"].items()}
        gathered: list = [None] * dist.get_world_size()
        dist.all_gather_object(gathered, mine)
        state = {i: s for part in gathered for i, s in part.items()}
        groups, lo = [], 0
        for g, n in zip(local["param_groups"], self._group_sizes):
            groups.append(dict(g, params=list(range(lo, lo + n))))
            lo += n
        self._full = {"state": {i: state[i] for i in sorted(state)}, "param_groups": groups}

    def state_dict(self) -> dict:
        if self._full is None:
            raise RuntimeError("call consolidate_state_dict() on every rank first")
        return self._full

    def load_state_dict(self, full: dict) -> None:
        """Keep this rank's share of a state dict in the wrapped optimizer's
        format."""
        local_of = {g: j for j, g in enumerate(self.global_index)}
        groups, lo = [], 0
        for g, n in zip(full["param_groups"], self._group_sizes):
            groups.append(dict(g, params=[local_of[i] for i in range(lo, lo + n)
                                          if i in local_of]))
            lo += n
        self.local.load_state_dict({
            "state": {local_of[i]: s for i, s in full["state"].items() if i in local_of},
            "param_groups": groups})
        self._full = None
