"""The trainers' scalar log and image panels.

The port's own copy of ``livespeechportraits_tpu/utils/visualizer.py`` (the
reference's util/visualizer.py and util/html.py): ``plot_current_errors``
appends to ``<checkpoints_dir>/<name>/scalars.csv``, with a header row
before every change of the key set; ``print_current_errors`` prints a line
and appends it to ``loss_log.txt``; ``display_current_results`` writes a
set of images an epoch under ``<name>/web/images`` and rewrites
``web/index.html``, newest epoch first (``HTMLReport``); ``save_images``
writes ``<label>_<name>.jpg`` files.  ``tensor2im`` maps a [-1, 1] image to
uint8.  No TensorBoard.
"""

from __future__ import annotations

import csv
import os
import time
from typing import Dict, Iterable, List, Mapping, Optional

import numpy as np


def tensor2im(img: np.ndarray) -> np.ndarray:
    """A [-1, 1] float image (HWC or CHW) -> uint8 HWC with three channels
    (the reference's util/util.py:19-42)."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[0] in (1, 3) and img.shape[-1] not in (1, 3):
        img = img.transpose(1, 2, 0)
    out = ((img + 1.0) * 127.5).clip(0, 255).astype(np.uint8)
    if out.ndim == 2:
        out = out[..., None]
    if out.shape[-1] == 1:
        out = np.repeat(out, 3, axis=-1)
    return out


class HTMLReport:
    """A page of image tables (the reference's util/html.py:6-67), written
    without the dominate package."""

    def __init__(self, web_dir: str, title: str):
        self.web_dir = web_dir
        self.title = title
        os.makedirs(os.path.join(web_dir, "images"), exist_ok=True)
        self._body: List[str] = []

    def add_header(self, text: str) -> None:
        self._body.append(f"<h3>{text}</h3>")

    def add_images(self, ims: Iterable[str], txts: Iterable[str], links: Iterable[str],
                   width: int = 400) -> None:
        cells = [f'<td style="word-wrap:break-word" halign="center" valign="top">'
                 f'<p><a href="images/{link}"><img src="images/{im}" '
                 f'style="width:{width}px"></a><br>{txt}</p></td>'
                 for im, txt, link in zip(ims, txts, links)]
        self._body.append('<table border="1" style="table-layout:fixed"><tr>'
                          + "".join(cells) + "</tr></table>")

    def save(self) -> str:
        html = (f"<!DOCTYPE html><html><head><title>{self.title}</title></head>"
                f"<body>{''.join(self._body)}</body></html>")
        path = os.path.join(self.web_dir, "index.html")
        with open(path, "w") as f:
            f.write(html)
        return path


class Visualizer:
    def __init__(self, checkpoints_dir: str, name: str):
        self.name = name
        self.save_dir = os.path.join(checkpoints_dir, name)
        self.web_dir = os.path.join(self.save_dir, "web")
        self.img_dir = os.path.join(self.web_dir, "images")
        os.makedirs(self.save_dir, exist_ok=True)
        self.log_path = os.path.join(self.save_dir, "loss_log.txt")
        self.csv_path = os.path.join(self.save_dir, "scalars.csv")
        with open(self.log_path, "a") as f:
            f.write(f"================ Training Loss ({time.strftime('%c')}) ================\n")
        self._csv_keys: Optional[List[str]] = None
        self._epoch_images: Dict[int, List[str]] = {}

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

    def display_current_results(self, visuals: Mapping[str, np.ndarray], epoch: int,
                                step: int = 0) -> None:
        """Write epoch{epoch:03d}_{label}.jpg for each visual and the gallery
        of every epoch shown so far."""
        os.makedirs(self.img_dir, exist_ok=True)
        names = []
        for label, img in visuals.items():
            fname = f"epoch{epoch:03d}_{label}.jpg"
            _write_image(os.path.join(self.img_dir, fname), img)
            names.append(fname)
        self._epoch_images[epoch] = names
        report = HTMLReport(self.web_dir, f"Experiment name = {self.name}")
        for e in sorted(self._epoch_images, reverse=True):
            report.add_header(f"epoch [{e}]")
            ims = self._epoch_images[e]
            report.add_images(ims, [n.split("_", 1)[1] for n in ims], ims)
        report.save()

    def save_images(self, save_root: str, visuals: Mapping[str, np.ndarray], name: str) -> None:
        """<label>_<name>.jpg for each visual (the reference's demo.py:268-272)."""
        os.makedirs(save_root, exist_ok=True)
        for label, img in visuals.items():
            _write_image(os.path.join(save_root, f"{label}_{name}.jpg"), img)


def _write_image(path: str, img: np.ndarray) -> None:
    """An RGB image (uint8, or [-1, 1] float through tensor2im) to a file;
    one channel is written grey."""
    from PIL import Image

    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = tensor2im(img)
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    Image.fromarray(img).save(path)
