"""Data and model parallelism over the ranks of a process group, and the
data axis over devices.

Counterpart of ``livespeechportraits_tpu/parallel/mesh.py``.  JAX lays a
(data, model) mesh over the devices and lets XLA insert the collectives;
here both axes are explicit:

- ``make_mesh(device)``: the data axis of a frame-sharded render, every
  visible device of that type (``Predictor(data_parallel=True)``): a list
  of devices in one process;
- ``make_grid(model_parallel_size)`` / ``mesh_from_config(cfg)``: JAX's
  ``make_mesh(model_parallel_size)`` over the ranks of a process group, a
  ``Grid``: rank r sits at data index r // mp and model index r % mp, as
  JAX's ``reshape(n // mp, mp)`` lays the devices, and the grid holds the
  two process groups of this rank (every rank creates every group, in one
  order).  The grid has its own name because it is another kind of object:
  process groups, not devices;
- ``use_grid(grid)``: the grid that the collectives below reduce over
  within the block.  Outside one (no grid) the data group is the world
  group, so a data-parallel run is the grid (world, 1);
- ``replicate(module)``: the first data rank's parameters and buffers on
  every rank of the data group;
- ``allreduce_gradients(grads)``: the data group's mean gradient, one
  all-reduce of a flat bucket (``state.gradients`` calls it, so every
  trainer step, both gradients of the fused GAN step included, is reduced;
  the steps take their gradients with ``torch.autograd.grad``, which DDP's
  reducer would not see);
- ``all_reduce_sum(x)``: a differentiable all-reduce over the data group,
  for the training BatchNorms' global statistics (``nn_core.batchnorm``) and
  the VGG Gram matrices;
- ``all_reduce_max_(x)``: the max over the groups the activations are split
  over (``split_groups``), for the int8 activation scale;
- ``to_model_slices`` / ``from_model_slices``: Megatron's pair around a
  channel-sharded conv (``parallel.sharding``);
- ``Zero1``: ZeRO stage 1, each data rank holding the Adam moments of its
  share of the parameters (JAX's ``zero1_place``, which composes with the
  model sharding the same way: over the data axis only).

Every loss of the trainers is a mean over equal local slices, so the mean
of the data ranks' gradients is the gradient of the global batch's loss.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from livespeechportraits_torch.config import MeshConfig
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


@dataclasses.dataclass(frozen=True, eq=False)
class Grid:
    """This rank's place in a (data, model) grid of the process group's
    ranks, and its two groups: ``data_group`` (the ranks of its model index,
    which hold other rows of the batch) and ``model_group`` (the ranks of its
    data index, which hold other channels or other rows of an image).
    ``*_ranks`` are the groups' global ranks in index order.  A grid is
    shared, not copied, by ``copy.deepcopy`` (a module carries it)."""

    data_size: int
    model_size: int
    data_index: int
    model_index: int
    data_group: Optional[dist.ProcessGroup]
    model_group: Optional[dist.ProcessGroup]
    data_ranks: Tuple[int, ...]
    model_ranks: Tuple[int, ...]

    def __deepcopy__(self, memo) -> "Grid":
        return self


def make_grid(model_parallel_size: int = 1) -> Grid:
    """The (world / mp, mp) grid over the process group's ranks (a 1 x 1 grid
    outside one).  Collective: every rank calls it, and it creates every
    row's and column's group in the same order on every rank."""
    mp = int(model_parallel_size)
    n, me = multihost.world_size(), multihost.rank()
    if mp < 1 or n % mp:
        raise ValueError(f"{n} ranks not divisible by model_parallel_size={mp}")
    rows = n // mp
    data_ranks = tuple(i * mp + me % mp for i in range(rows))
    model_ranks = tuple(me // mp * mp + j for j in range(mp))
    groups = {}
    if dist.is_initialized():
        for j in range(mp):  # the data groups, one a model index
            ranks = [i * mp + j for i in range(rows)]
            groups[tuple(ranks)] = dist.new_group(ranks)
        for i in range(rows):  # the model groups, one a data index
            ranks = [i * mp + j for j in range(mp)]
            groups[tuple(ranks)] = dist.new_group(ranks)
    return Grid(rows, mp, me // mp, me % mp, groups.get(data_ranks), groups.get(model_ranks),
                data_ranks, model_ranks)


def mesh_from_config(cfg: MeshConfig) -> Grid:
    return make_grid(cfg.model_parallel_size)


# This process alone, inside a process group or not: under use_grid(LOCAL)
# no collective runs (make_grid(1) outside a group is the same grid)
LOCAL = Grid(1, 1, 0, 0, None, None, (0,), (0,))


# The grid the collectives reduce over (use_grid) and whether the forward
# splits images by rows over its model axis (sharding's spatial forward)
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("lsp_grid", default=(None, False))


@contextlib.contextmanager
def use_grid(grid: Optional[Grid], spatial: bool = False):
    """Within the block the collectives reduce over ``grid``'s groups; with
    ``spatial`` the activations are split over its model axis too (rows of
    an image), so the int8 activation scale crosses it.  ``grid`` None keeps
    the block's grid as it is."""
    if grid is None:
        yield
        return
    token = _ACTIVE.set((grid, spatial))
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active_grid() -> Optional[Grid]:
    return _ACTIVE.get()[0]


def data_group() -> Optional[dist.ProcessGroup]:
    """The data group of the active grid; None (the world group) without one."""
    grid = active_grid()
    return None if grid is None else grid.data_group


def data_size() -> int:
    """The ranks that hold other rows of the batch: the active grid's data
    axis, else the world."""
    grid = active_grid()
    return multihost.world_size() if grid is None else grid.data_size


def data_index() -> int:
    grid = active_grid()
    return multihost.rank() if grid is None else grid.data_index


def _group_ranks(group: Optional[dist.ProcessGroup]) -> List[int]:
    if group is None:
        return list(range(dist.get_world_size()))
    return dist.get_process_group_ranks(group)


def split_groups() -> List[Optional[dist.ProcessGroup]]:
    """The groups over which a forward's activations are split: the data
    group when it has more than one rank (the world group without a grid),
    and the model group under a spatial forward.  A channel-sharded conv's
    input is whole on every model rank, so its model group is not among
    them."""
    grid, spatial = _ACTIVE.get()
    if grid is None:
        return [None] if multihost.world_size() > 1 else []
    out = [grid.data_group] if grid.data_size > 1 else []
    if spatial and grid.model_size > 1:
        out.append(grid.model_group)
    return out


@torch.no_grad()
def all_reduce_max_(x: Tensor) -> Tensor:
    """x (a scalar), in place, the max over split_groups(); no gradient."""
    for group in split_groups():
        flat = x.reshape(1)
        dist.all_reduce(flat, op=dist.ReduceOp.MAX, group=group)
    return x


@torch.no_grad()
def replicate(module: torch.nn.Module) -> torch.nn.Module:
    """The first data rank's parameters and buffers broadcast to every rank
    of the data group (in place)."""
    if data_size() > 1:
        group = data_group()
        src = _group_ranks(group)[0]
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=src, group=group)
    return module


def _flat(tensors: Sequence[Tensor]) -> Tensor:
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1:
        raise ValueError(f"one bucket holds one dtype, got {sorted(map(str, dtypes))}")
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat(flat: Tensor, like: Sequence[Tensor]) -> List[Tensor]:
    return [p.view_as(t) for p, t in zip(flat.split([t.numel() for t in like]), like)]


def allreduce_gradients(grads: Sequence[Tensor]) -> List[Tensor]:
    """The mean of each gradient over the data group: all_reduce(SUM) of one
    flat bucket, then / its size.  Outside a process group, or under a grid
    without one (LOCAL), the gradients pass as they are; a group of one rank
    still runs the all-reduce.  A
    channel-sharded leaf's gradient is its slice's, and the data group holds
    the same slice on every rank."""
    grid = active_grid()
    if not dist.is_initialized() or not grads or (grid is not None and grid.data_group is None):
        return list(grads)
    flat = _flat(grads)
    dist.all_reduce(flat, group=data_group())
    flat /= data_size()
    return _unflat(flat, grads)


class _AllReduceSum(torch.autograd.Function):
    """y = the sum of x over the data group, on every rank.  Its adjoint is
    the same sum: the ranks' gradients are averaged afterwards, so the
    gradient reaching each rank's x must be the sum of the ranks' upstream
    ones."""

    @staticmethod
    def forward(ctx, x: Tensor, group) -> Tensor:
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g: Tensor):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: Tensor) -> Tensor:
    """The sum of x over the data group, differentiable (see _AllReduceSum)."""
    return _AllReduceSum.apply(x, data_group())


def _dense(t: Tensor) -> Tuple[Tensor, bool]:
    """(a contiguous tensor holding t's values, whether it is the NHWC view
    of a channels_last map): that view costs no copy; any other layout is
    t.contiguous()."""
    if t.dim() == 4 and not t.is_contiguous() and t.is_contiguous(
            memory_format=torch.channels_last):
        return t.permute(0, 2, 3, 1), True
    return t.contiguous(), False


class _ToModelSlices(torch.autograd.Function):
    """The input of a channel-sharded conv: the identity forward; backward,
    the sum over the model group of the ranks' partial gradients (each rank's
    conv sees its slice of the output channels, so it gives its share of
    d loss / d x)."""

    @staticmethod
    def forward(ctx, x: Tensor, group) -> Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: Tensor):
        d, nhwc = _dense(g)
        d = d.clone()
        dist.all_reduce(d, group=ctx.group)
        return (d.permute(0, 3, 1, 2) if nhwc else d), None


class _FromModelSlices(torch.autograd.Function):
    """The output of a channel-sharded conv (after its per-channel ops): the
    ranks' channel slices gathered in model-index order over dim 1; backward,
    this rank's slice of the whole gradient (every model rank holds the same
    whole gradient: what follows is replicated)."""

    @staticmethod
    def forward(ctx, y: Tensor, grid: Grid) -> Tensor:
        ctx.index, ctx.width = grid.model_index, y.shape[1]
        d, nhwc = _dense(y)
        parts = [torch.empty_like(d) for _ in range(grid.model_size)]
        dist.all_gather(parts, d, group=grid.model_group)
        if nhwc:  # the NHWC views of channels_last maps: join over C
            return torch.cat(parts, dim=3).permute(0, 3, 1, 2)
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, g: Tensor):
        return g.narrow(1, ctx.index * ctx.width, ctx.width), None


def to_model_slices(x: Tensor, grid: Grid) -> Tensor:
    """x as the input of a conv whose output channels are split over
    ``grid``'s model axis (see _ToModelSlices)."""
    return _ToModelSlices.apply(x, grid.model_group)


def from_model_slices(y: Tensor, grid: Grid) -> Tensor:
    """The whole channel dimension from each model rank's slice y (see
    _FromModelSlices)."""
    return _FromModelSlices.apply(y, grid)


def broadcast_scalar(value: float) -> float:
    """The first data rank's value on every rank of the data group (each
    rank's own outside a group)."""
    if data_size() == 1:
        return value
    out = [value]
    group = data_group()
    dist.broadcast_object_list(out, src=_group_ranks(group)[0], group=group)
    return out[0]


class Zero1:
    """ZeRO stage 1 (Rajbhandari et al. 2020) over an optimizer whose update
    is elementwise (Adam), over the data group (the active grid's, else the
    world): each parameter is owned by one data rank, chosen greedily by
    size so that the ranks hold about equal shares; a rank's optimizer
    keeps the moments of its own parameters only and steps them, then each
    owner broadcasts its updated parameters in one flat bucket.  The
    gradients are the reduced ones every rank holds, so the update is
    replicated Adam's, bitwise.  Under a grid each model rank partitions its
    own slices the same way (equal shapes, so equal owners).

    ``param_groups`` are the local optimizer's (a learning-rate change
    reaches it).  ``consolidate_state_dict()`` (collective) gathers the
    moments to every rank in the wrapped optimizer's own format, which
    ``state_dict()`` then returns; ``load_state_dict`` takes that format, so
    a checkpoint resumes with or without ZeRO-1."""

    def __init__(self, optimizer: torch.optim.Optimizer):
        if not dist.is_initialized():
            raise ValueError("zero1 partitions optimizer state over the data axis and "
                             "needs data_parallel=True (no process group was set up)")
        self.group = data_group()
        self.ranks = _group_ranks(self.group)
        world, me = len(self.ranks), self.ranks.index(dist.get_rank())
        self.me = me
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
        for r in range(len(self.ranks)):
            owned = [p for p, o in zip(self.params, self.owner) if o == r]
            if not owned:
                continue
            flat = _flat(owned) if r == self.me else torch.empty(
                sum(p.numel() for p in owned), dtype=owned[0].dtype, device=owned[0].device)
            dist.broadcast(flat, src=self.ranks[r], group=self.group)
            if r != self.me:
                for p, v in zip(owned, _unflat(flat, owned)):
                    p.copy_(v)

    def consolidate_state_dict(self) -> None:
        """Gather every rank's moments (a collective: every rank calls it)."""
        local = self.local.state_dict()
        mine = {self.global_index[j]: {k: v.cpu() if torch.is_tensor(v) else v
                                       for k, v in s.items()}
                for j, s in local["state"].items()}
        gathered: list = [None] * len(self.ranks)
        dist.all_gather_object(gathered, mine, group=self.group)
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
