"""PyTorch port, ops/rasterize.py and ops/rasterize_cuda.py (kernel K1).

The plain twin is held bitwise against the JAX Pallas kernel in interpret
mode and against JAX's XLA rasteriser: every op rounds on its own in all
three, so the edge maps must be identical.  The CUDA kernel is held bitwise
against the twin on the card in test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import torch

from livespeechportraits_tpu.ops import rasterize as jrast
from livespeechportraits_tpu.ops import rasterize_pallas as jpallas
from livespeechportraits_torch.ops import rasterize, rasterize_cuda


def _edge_case_table(n_frames=2, size=128):
    """Random landmarks plus hand-made segments: crossing block and tile
    edges, zero length, off-canvas and negative endpoints, and -1e6
    padding rows."""
    rng = np.random.default_rng(0)
    lm = rng.uniform(-10, size + 10, (n_frames, 73, 2)).astype(np.float32)
    sh = rng.uniform(0, size, (n_frames, 18, 2)).astype(np.float32)
    table = rasterize.segment_table(torch.tensor(lm), torch.tensor(sh)).numpy()
    extra = np.array([
        [31, 5, 33, 120],     # vertical, crosses 8-row and 32-column block edges
        [0, 63, 127, 64],     # horizontal, whole width
        [50, 50, 50, 50],     # zero length
        [-20, -3, -1, -1],    # off canvas, negative endpoints
        [126, 126, 140, 200],  # leaves the canvas
        [-1e6, -1e6, -1e6, -1e6],  # padding
    ], np.float32)
    table = np.concatenate([table, np.broadcast_to(extra, (n_frames,) + extra.shape)], axis=1)
    return np.ascontiguousarray(table)


def test_plain_matches_pallas_interpret_bitwise():
    table = _edge_case_table()
    ref = np.asarray(jpallas.rasterize_segments_pallas(jnp.asarray(table), 128, 128,
                                                       interpret=True))
    ours = rasterize_cuda.rasterize_segments(torch.tensor(table), 128, 128).numpy()
    np.testing.assert_array_equal(ours, ref)
    assert ours.sum() > 100  # the frames were drawn on


def test_feature_maps_match_jax_xla_bitwise():
    rng = np.random.default_rng(1)
    lm = rng.uniform(20, 100, (2, 73, 2)).astype(np.float32)
    sh = rng.uniform(20, 100, (2, 18, 2)).astype(np.float32)
    ref = np.asarray(jrast.rasterize_feature_maps(jnp.asarray(lm), jnp.asarray(sh), (96, 128)))
    ours = rasterize_cuda.rasterize_feature_maps(torch.tensor(lm), torch.tensor(sh), (96, 128))
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_segment_endpoints_truncate_toward_zero():
    lm = np.full((1, 73, 2), 10.7, np.float32)
    lm[0, 0] = [-0.5, -1.5]
    p1, _ = rasterize._segment_endpoints(torch.tensor(lm), None)
    jp1, _ = jrast._segment_endpoints(jnp.asarray(lm), None)
    np.testing.assert_array_equal(p1.numpy(), np.asarray(jp1))
    assert p1[0, 0].tolist() == [0.0, -1.0]
    assert p1.shape[1] == len(jrast.face_segments())


def test_segment_lists_match_jax():
    np.testing.assert_array_equal(rasterize.face_segments(), jrast.face_segments())
    for n in (0, 3, 18):
        np.testing.assert_array_equal(rasterize.shoulder_segments(n), jrast.shoulder_segments(n))
