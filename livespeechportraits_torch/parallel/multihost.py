"""The process group of a data-parallel run.

Counterpart of ``livespeechportraits_tpu/parallel/multihost.py``: JAX starts
``jax.distributed`` and runs one program over a mesh that spans every
process; here each process is one rank of a ``torch.distributed`` group that
drives one device, and the trainers reduce what crosses ranks themselves
(``parallel/mesh.py``, ``nn_core.batchnorm``).

    torchrun --nproc_per_node=N -m livespeechportraits_torch.train --data_parallel ...

``initialize()`` reads torchrun's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``); without it the group
has one rank, as JAX's data-parallel trainer on one chip is a one-device
mesh.  Every rank draws the same global batch from the same seed and keeps
its own rows (``global_batch_iter``).
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist


def initialize(device: str | torch.device = "cuda", backend: Optional[str] = None
               ) -> torch.device:
    """Join the process group (once a process) and return this rank's
    device.  ``device`` "cuda" without an index becomes ``cuda:LOCAL_RANK``;
    an explicit index is kept (two ranks on one card name the same one).
    The backend is NCCL for CUDA and gloo for the CPU, or ``backend`` (gloo
    also moves CUDA tensors).  Without torchrun's environment the group has
    one rank.  A failed init raises: nothing falls back to another backend
    or to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {str(device)!r} was asked for but torch sees no CUDA "
                               "device")
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://",
                                    rank=int(os.environ["RANK"]),
                                    world_size=int(os.environ["WORLD_SIZE"]))
        else:  # one rank: a store of its own, no port
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return dev


def shutdown() -> None:
    """Leave the process group (a no-op outside one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def world_size() -> int:
    """The ranks of the process group; 1 outside one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the rank that writes checkpoints, panels and logs."""
    return rank() == 0


def local_batch_slice(global_batch: int) -> slice:
    """The rows of a global batch this rank feeds its device: its data
    rank's share (parallel.mesh's active grid; the world without one), so
    the model ranks of one data index get the same rows."""
    from livespeechportraits_torch.parallel import mesh  # mesh imports this module

    n, i = mesh.data_size(), mesh.data_index()
    if global_batch % n or global_batch < n:
        raise ValueError(
            f"global_batch={global_batch} must be a positive multiple of "
            f"process_count={n}: truncating would silently drop rows and "
            "break the mesh's data-axis layout")
    per = global_batch // n
    return slice(i * per, (i + 1) * per)


def shard_batch(batch: Dict[str, np.ndarray], global_batch: int) -> Dict[str, np.ndarray]:
    """This rank's rows of a global batch (local_batch_slice).  A leaf whose
    leading dimension is not the batch's (the subject's shared candidate
    stack, [1, ...]) is every rank's, as JAX's shard_batch replicates it."""
    sl = local_batch_slice(global_batch)
    return {k: v[sl] if np.ndim(v) and np.shape(v)[0] == global_batch else v
            for k, v in batch.items()}


def global_batch_iter(sampler, global_batch: int, rng: np.random.Generator
                      ) -> Iterator[Dict[str, np.ndarray]]:
    """The training batch stream of a rank: every rank draws the same index
    order (the same seed), keeps its own rows and drops none of its own.
    The sampler draws the whole global batch on every rank (JAX's known
    cost: each rank decodes the other ranks' rows too)."""
    local_batch_slice(global_batch)  # refuse a batch that does not divide before drawing
    for batch in sampler.batches(global_batch, rng):
        yield shard_batch(batch, global_batch)
