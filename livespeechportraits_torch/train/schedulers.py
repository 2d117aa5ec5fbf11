"""Learning-rate schedules, one value an epoch.

The port's own copy of ``livespeechportraits_tpu/train/schedulers.py`` (the
reference's networks.get_scheduler): each schedule maps an epoch index to a
learning rate, which the trainer sets on the optimizer's parameter groups at
the start of the epoch.

  linear  - flat for n_epochs, then linear decay to 0 over n_epochs_decay
  step    - lr * gamma^(epoch // step_size)
  cosine  - cosine anneal to 0 over n_epochs, then held there
  plateau - reduce-on-plateau (stateful; factor 0.2, patience 5,
            threshold 0.01, 'min' mode, torch's defaults as the reference
            used them)
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Callable

import numpy as np


def linear_schedule(base_lr: float, n_epochs: int, n_epochs_decay: int) -> Callable[[int], float]:
    def lr(epoch: int) -> float:
        factor = 1.0 - max(0, epoch - n_epochs) / float(n_epochs_decay + 1)
        return base_lr * max(0.0, factor)

    return lr


def step_schedule(base_lr: float, step_size: int, gamma: float) -> Callable[[int], float]:
    def lr(epoch: int) -> float:
        return base_lr * gamma ** (epoch // step_size)

    return lr


def cosine_schedule(base_lr: float, n_epochs: int, eta_min: float = 0.0) -> Callable[[int], float]:
    def lr(epoch: int) -> float:
        # clamped past n_epochs: the trainers run n_epochs + n_epochs_decay
        # epochs, and the cosine would climb back toward base_lr
        e = min(epoch, n_epochs)
        return eta_min + (base_lr - eta_min) * 0.5 * (1 + np.cos(np.pi * e / n_epochs))

    return lr


@dataclass
class ReduceOnPlateau:
    """Stateful reduce-on-plateau, 'min' mode.  Its state (``state_dict``)
    rides in the trainer's checkpoints."""

    base_lr: float
    factor: float = 0.2
    patience: int = 5
    threshold: float = 0.01
    best: float = field(default=float("inf"))
    num_bad: int = 0
    lr: float = field(default=0.0)

    def __post_init__(self):
        if not self.lr:
            self.lr = self.base_lr

    def update(self, metric: float) -> float:
        if metric < self.best * (1 - self.threshold):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr *= self.factor
                self.num_bad = 0
        return self.lr

    def __call__(self, epoch: int) -> float:
        """The current lr, whatever the epoch: update(metric) moves it."""
        return self.lr

    def state_dict(self) -> dict:
        return asdict(self)

    def load_state_dict(self, state: dict) -> None:
        for k, v in state.items():
            setattr(self, k, v)


def make_schedule(policy: str, base_lr: float, n_epochs: int = 10,
                  n_epochs_decay: int = 10, step_size: int = 900,
                  gamma: float = 0.25):
    if policy == "linear":
        return linear_schedule(base_lr, n_epochs, n_epochs_decay)
    if policy == "step":
        return step_schedule(base_lr, step_size, gamma)
    if policy == "cosine":
        return cosine_schedule(base_lr, n_epochs)
    if policy == "plateau":
        return ReduceOnPlateau(base_lr)
    raise ValueError(f"unknown lr policy {policy!r}")
