#!/usr/bin/env python3
"""torchvision's VGG19 conv weights as the ``.npz`` that
``models/losses.load_vgg19_npz`` reads (the pretrained perceptual loss).

    python -m livespeechportraits_torch.tools.export_vgg19 vgg19.npz \\
        --state_dict vgg19-dcbb9e9d.pth
    # without --state_dict: torchvision's IMAGENET1K_V1 weights (downloads)

    python -m livespeechportraits_torch.train --task feature2face --vgg vgg19.npz ...

Counterpart of the repo-root ``tools/export_vgg19.py``.  ``--state_dict``
reads a local ``.pth`` (``torch.load(..., weights_only=True)``) in either of
torchvision's layouts: the features alone (``<i>.weight`` / ``<i>.bias``)
or the whole model (``features.<i>.*`` beside ``classifier.*``, which is
ignored; the reference tool raises on such a file, though it is what
torchvision ships).  The ``.npz`` holds ``conv{k}_w`` (OIHW, f32) and
``conv{k}_b`` for the 16 convs in layer-index order.  torchvision is
imported only without ``--state_dict``.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Mapping, Optional, Union

import numpy as np
import torch

N_CONVS = 16
_FEATURES = "features."


def conv_arrays(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """{conv{k}_w, conv{k}_b} of a VGG19 features-only or full-model state
    dict, k in layer-index order; anything but 16 convs raises."""
    if any(k.startswith(_FEATURES) for k in state_dict):
        state_dict = {k[len(_FEATURES):]: v for k, v in state_dict.items()
                      if k.startswith(_FEATURES)}
    layers = {}
    for key, v in state_dict.items():
        index, _, name = key.partition(".")
        if not index.isdigit() or name not in ("weight", "bias"):
            raise ValueError(f"{key!r} is not a key of VGG19's features ('<i>.weight', "
                             "'<i>.bias', or 'features.' before them)")
        layers.setdefault(int(index), {})[name] = v
    convs = [layers[i] for i in sorted(layers)]
    if len(convs) != N_CONVS or any(set(c) != {"weight", "bias"} or c["weight"].dim() != 4
                                    for c in convs):
        raise ValueError(f"expected VGG19's {N_CONVS} convs (a 4-d weight and a bias each), got "
                         f"{len(convs)} layers")
    out = {}
    for k, c in enumerate(convs):
        out[f"conv{k}_w"] = c["weight"].detach().cpu().float().numpy()  # OIHW
        out[f"conv{k}_b"] = c["bias"].detach().cpu().float().numpy()
    return out


def export(out_path: str, state_dict: Optional[Union[str, Mapping[str, torch.Tensor]]] = None
           ) -> int:
    """Write the .npz from a state dict or the path of a local .pth, or
    from torchvision's pretrained weights when state_dict is None (this
    path imports torchvision and downloads); returns the convs written."""
    if state_dict is None:
        from torchvision.models import vgg19

        state_dict = vgg19(weights="IMAGENET1K_V1").features.state_dict()
    elif isinstance(state_dict, str):
        state_dict = torch.load(state_dict, map_location="cpu", weights_only=True)
    arrays = conv_arrays(state_dict)
    np.savez(out_path, **arrays)
    return len(arrays) // 2


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out", help="the .npz to write")
    ap.add_argument("--state_dict", default=None,
                    help="a local VGG19 .pth (features-only or full-model) instead of "
                         "torchvision's download")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    n = export(args.out, args.state_dict)
    print(f"wrote {n} conv layers to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
