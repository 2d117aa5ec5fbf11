"""Reference-format training-data ingestion: the part subject onboarding uses.

Counterpart of ``livespeechportraits_tpu/train/data_io.py``, so far only
``compute_apc_features`` (a clip's wav -> mel -> APC features), which
``pipeline/build_person.py`` runs over every clip to build the LLE feature
bank, and ``make_change_paras_normalise``, with which it crops the candidate
frames.  The rest of that module (``prepare_clip``, ``LazyH5Frames``,
``load_face_clip``) feeds the trainers and comes with them (ROADMAP item 15).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from livespeechportraits_torch.models import apc as apc_model
from livespeechportraits_torch.models.apc import APCEncoder
from livespeechportraits_torch.ops import mel as mel_ops


@torch.no_grad()
def compute_apc_features(audio: np.ndarray, apc: APCEncoder,
                         residual: bool = False) -> np.ndarray:
    """wav [-1, 1] at 16 kHz -> [2T, hidden] float32 APC features, on the
    encoder's device: each GRU layer in kernel K2 on the card
    (apc.encode_fast).  ``residual`` must match the encoder's training flag
    (cfg.apc.residual)."""
    dev = next(apc.parameters()).device
    mel80 = mel_ops.compute_mel_sequence(audio, device=dev)
    return apc_model.encode_fast(apc, mel80, residual=residual).cpu().numpy()


def make_change_paras_normalise(clip_root: str):
    """The clip's frame normalisation as a function of a uint8 frame: resize
    by change_paras.npz's scale, then the 512 x 512 crop around (xc, yc),
    zero-padded where it leaves the frame."""
    from PIL import Image

    paras = np.load(os.path.join(clip_root, "change_paras.npz"))
    scale, xc, yc = float(paras["scale"]), int(paras["xc"]), int(paras["yc"])

    def normalise(img: np.ndarray) -> np.ndarray:
        im = Image.fromarray(img)
        w, h = im.size
        arr = np.asarray(im.resize((int(w * scale), int(h * scale))))
        x0, x1, y0, y1 = xc - 256, xc + 256, yc - 256, yc + 256
        out = np.zeros((512, 512, 3), arr.dtype)
        sx0, sx1 = max(x0, 0), min(x1, arr.shape[1])
        sy0, sy1 = max(y0, 0), min(y1, arr.shape[0])
        out[sy0 - y0:sy1 - y0, sx0 - x0:sx1 - x0] = arr[sy0:sy1, sx0:sx1]
        return out

    return normalise
