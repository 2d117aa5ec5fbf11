"""Generated-image replay buffer for discriminator training.

The port's copy of ``livespeechportraits_tpu/utils/image_pool.py``: the
reference's util/image_pool.py:5-32 (the pix2pix history pool; unused by
the reference's shipped models but part of its training-framework
surface).  Operates on numpy batches; a 50% coin per image, drawn from the
pool's numpy Generator, decides whether to return the fresh image or swap
it with a stored one, so a seed gives JAX's choices.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


class ImagePool:
    def __init__(self, pool_size: int, rng: Optional[np.random.Generator] = None):
        self.pool_size = pool_size
        self.images: List[np.ndarray] = []
        self.num_imgs = 0
        self.rng = rng or np.random.default_rng(0)

    def query(self, images: np.ndarray) -> np.ndarray:
        """images: [B, ...]; returns a same-shaped batch mixing fresh and
        replayed images."""
        if self.pool_size == 0:
            return images
        out = []
        for image in images:
            if self.num_imgs < self.pool_size:
                self.images.append(image.copy())
                self.num_imgs += 1
                out.append(image)
            elif self.rng.uniform() > 0.5:
                idx = int(self.rng.integers(self.pool_size))
                out.append(self.images[idx].copy())
                self.images[idx] = image.copy()
            else:
                out.append(image)
        return np.stack(out)
