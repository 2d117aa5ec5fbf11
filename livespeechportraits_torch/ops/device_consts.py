"""Constant tensors built on the host and uploaded once per device.

A tensor built from host data reaches a CUDA device through a pageable copy,
which synchronizes the stream and which a capturing stream refuses.  The
motion half's index lists, windows, filterbanks and scales therefore come
from this cache: the first call on a device uploads, every later call (and
every CUDA-graph capture after a warm-up) reads the cached tensor.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

Tensor = torch.Tensor

_CACHE: Dict[Tuple[str, str], Tensor] = {}


def const(name: str, device: torch.device | str, build: Callable[[], object]) -> Tensor:
    """The tensor ``build()`` (anything ``torch.as_tensor`` takes) on
    ``device``, built and uploaded on the first call for (name, device).
    ``name`` must identify the value: it includes every parameter ``build``
    reads."""
    key = (name, str(torch.device(device)))
    t = _CACHE.get(key)
    if t is None:
        t = _CACHE[key] = torch.as_tensor(build(), device=device)
    return t
