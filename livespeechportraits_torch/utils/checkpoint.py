"""The trainers' checkpoints: one ``torch.save`` file an epoch.

Counterpart of ``livespeechportraits_tpu/utils/checkpoint.py``, which
writes orbax step directories; the port writes its own format, since the
card's machine has no orbax: ``<ckpt_dir>/<epoch>.pt`` holds a dict of

    models      {name: state_dict}        ("params"; or "G" and "D")
    optimizers  {name: optimizer state_dict}
    schedules   {name: schedule state}     (ReduceOnPlateau's; {} otherwise)
    epoch       int, the epochs done
    best_val    float or None, the best validation mean so far
    rng         the trainer's generator states ({} when not given)
    qat_mode    None, "fq" or "fq8": the QAT tag of the generator's convs
                (a tag is not part of a state dict); a file without the
                entry reads as None

``restore`` loads it back into live modules and optimizers and refuses a
file whose entries, or whose state dicts' keys, are not the caller's:
missing and extra keys both raise, as JAX's ``_rebuild`` does.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional, Sequence

import torch
from torch import nn

_FILE = re.compile(r"^(\d+)\.pt$")


def _path(ckpt_dir: str, epoch: int) -> str:
    return os.path.join(ckpt_dir, f"{int(epoch)}.pt")


def save_checkpoint(ckpt_dir: str, epoch: int, models: Dict[str, nn.Module],
                    optimizers: Dict[str, torch.optim.Optimizer],
                    schedules: Optional[Dict[str, dict]] = None,
                    best_val: Optional[float] = None, rng: Optional[dict] = None,
                    keep_only: bool = False, qat_mode: Optional[str] = None) -> str:
    """Write ``<ckpt_dir>/<epoch>.pt`` (through a temporary file, so a cut
    write leaves no file behind); keep_only removes the directory's other
    epochs (the best-validation directory keeps one)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = _path(ckpt_dir, epoch)
    state = {"models": {k: m.state_dict() for k, m in models.items()},
             "optimizers": {k: o.state_dict() for k, o in optimizers.items()},
             "schedules": dict(schedules or {}), "epoch": int(epoch), "best_val": best_val,
             "rng": dict(rng or {}), "qat_mode": qat_mode}
    torch.save(state, path + ".tmp")
    os.replace(path + ".tmp", path)
    if keep_only:
        for name in os.listdir(ckpt_dir):
            m = _FILE.match(name)
            if m and int(m.group(1)) != int(epoch):
                os.remove(os.path.join(ckpt_dir, name))
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The highest epoch saved under ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for m in map(_FILE.match, os.listdir(ckpt_dir)) if m]
    return max(steps) if steps else None


def prefer_best(ckpt_dir: str) -> str:
    """``<ckpt_dir>_best`` when the trainer kept a best-validation save
    there, else ``ckpt_dir``."""
    if ckpt_dir:
        best = ckpt_dir.rstrip("/") + "_best"
        if latest_step(best) is not None:
            return best
    return ckpt_dir


def load_checkpoint(ckpt_dir: str, epoch: Optional[int] = None,
                    map_location: str | torch.device = "cpu") -> dict:
    """The raw dict saved at ``epoch`` (default: the latest)."""
    if epoch is None:
        epoch = latest_step(ckpt_dir)
        if epoch is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    return torch.load(_path(ckpt_dir, epoch), map_location=map_location, weights_only=True)


def _same_keys(what: str, want, got) -> None:
    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(f"checkpoint {what} do not match: missing {missing[:5]}, "
                         f"extra {extra[:5]} - architecture/config mismatch")


def qat_mode(state: dict) -> Optional[str]:
    """The generator's QAT tag a checkpoint dict records (None for a float
    run, and for a file written before the entry existed)."""
    return state.get("qat_mode")


def restore(state: dict, models: Dict[str, nn.Module],
            optimizers: Dict[str, torch.optim.Optimizer], fresh: Sequence[str] = ()) -> dict:
    """Load a checkpoint dict into ``models`` (strict: missing and extra
    parameters raise) and ``optimizers``; the file must name exactly these
    models and optimizers.  The optimizers named in ``fresh`` keep their
    fresh state (a QAT warm start restarts the generator's Adam moments).
    Returns the dict (for epoch, schedules, best_val, rng)."""
    entries = {"models", "optimizers", "schedules", "epoch", "best_val", "rng"}
    _same_keys("entries", entries | ({"qat_mode"} & set(state)), state)
    _same_keys("models", models, state["models"])
    _same_keys("optimizers", optimizers, state["optimizers"])
    for k, m in models.items():
        m.load_state_dict(state["models"][k], strict=True)
    for k, o in optimizers.items():
        if k not in fresh:
            o.load_state_dict(state["optimizers"][k])
    return state
