"""What a frame transfer does to the frames, as the reference applies it to
its own: the generator's float output [B, H, W, 3] in [-1, 1] -> the uint8
RGB frames a caller receives under that transfer.

- ``rgb``: the exact frames, ``nets.to_uint8``.
- ``yuv420``: planar 4:2:0 there and back, from the format's definition:
  BT.601 full range on RGB = (x + 1) * 127.5; Y = .299 R + .587 G + .114 B,
  U = -.168736 R - .331264 G + .5 B + 128, V = .5 R - .418688 G - .081312 B
  + 128; U and V the mean of each 2x2 block; each plane rounded to uint8 as
  clamp(c + 0.5); back with the chroma repeated over its block, R = Y +
  1.402 (V - 128), G = Y - .344136 (U - 128) - .714136 (V - 128), B = Y +
  1.772 (U - 128), rounded the same way.

A lossy transfer with no transform here (``jpeg``, ``jpeg4``, ``pack4e``)
cannot be checked: BENCHMARK.json's validation refuses a mix that names one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from lspbench.reference import nets

Tensor = torch.Tensor


def _u8(c: Tensor) -> Tensor:
    return torch.clamp(c + 0.5, 0, 255).to(torch.uint8)


def yuv420(y: Tensor) -> Tensor:
    """[B, H, W, 3] in [-1, 1] (H, W even) -> [B, H, W, 3] uint8 after the
    4:2:0 round trip, in float32."""
    rgb = (y.float() + 1.0) * 127.5
    r, g, b = rgb.unbind(-1)
    luma = _u8(0.299 * r + 0.587 * g + 0.114 * b)
    u = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    v = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
    u, v = (_u8(F.avg_pool2d(c[:, None], 2))[:, 0] for c in (u, v))
    yf = luma.float()
    uf, vf = ((c.float() - 128.0).repeat_interleave(2, 1).repeat_interleave(2, 2)
              for c in (u, v))
    return torch.stack([_u8(yf + 1.402 * vf), _u8(yf - 0.344136 * uf - 0.714136 * vf),
                        _u8(yf + 1.772 * uf)], dim=-1)


TRANSFORMS = {"rgb": nets.to_uint8, "yuv420": yuv420}
