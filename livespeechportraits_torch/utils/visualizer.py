"""The trainers' scalar log.

The port's own copy of the scalar half of
``livespeechportraits_tpu/utils/visualizer.py`` (the reference's
util/visualizer.py): ``plot_current_errors`` appends to
``<checkpoints_dir>/<name>/scalars.csv``, with a header row before every
change of the key set, and ``print_current_errors`` prints a line and
appends it to ``loss_log.txt``.  No TensorBoard and no HTML image panels.
"""

from __future__ import annotations

import csv
import os
import time
from typing import List, Mapping, Optional


class Visualizer:
    def __init__(self, checkpoints_dir: str, name: str):
        self.save_dir = os.path.join(checkpoints_dir, name)
        os.makedirs(self.save_dir, exist_ok=True)
        self.log_path = os.path.join(self.save_dir, "loss_log.txt")
        self.csv_path = os.path.join(self.save_dir, "scalars.csv")
        with open(self.log_path, "a") as f:
            f.write(f"================ Training Loss ({time.strftime('%c')}) ================\n")
        self._csv_keys: Optional[List[str]] = None

    def plot_current_errors(self, errors: Mapping[str, float], step: int) -> None:
        keys = list(errors)
        with open(self.csv_path, "a", newline="") as f:
            w = csv.writer(f)
            if keys != self._csv_keys:  # train and validation keys interleave
                w.writerow(["step"] + keys)
                self._csv_keys = keys
            w.writerow([step] + [float(v) for v in errors.values()])

    def print_current_errors(self, epoch: int, iters: int, errors: Mapping[str, float],
                             t: float = 0.0) -> str:
        message = f"(epoch: {epoch}, iters: {iters}, time: {t:.3f}) "
        message += " ".join(f"{k}: {float(v):.3f}" for k, v in errors.items())
        print(message)
        with open(self.log_path, "a") as f:
            f.write(message + "\n")
        return message
