"""PyTorch port, ops/rasterize.py and ops/rasterize_cuda.py (kernel K1).

The plain twins are held bitwise against the JAX Pallas kernel in interpret
mode and against JAX's XLA rasteriser: every op rounds on its own in all
three, so the edge maps must be identical; the renderer's input (edge plus
candidate stack, cast) likewise against the Pallas kernel followed by
JAX's concat and cast.  The CUDA kernel is held bitwise against the twins
on the card in test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
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
    ours = rasterize.rasterize_feature_maps(torch.tensor(lm), torch.tensor(sh), (96, 128))
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


def _render_landmarks(n_frames, height, width, seed):
    """Seeded face landmarks inside the canvas plus, in the first frames,
    points off the canvas, negative ones (truncated toward zero) and
    fractional ones; 18 shoulder points."""
    rng = np.random.default_rng(seed)
    lm = rng.uniform(8, min(height, width) - 8, (n_frames, 73, 2)).astype(np.float32)
    lm[0, :6] = [[-0.7, 5.2], [-3.4, -0.2], [width + 4.5, 10.0], [20.0, height + 0.9],
                 [width - 0.5, height - 0.5], [-1e3, 40.0]]
    lm[1, 40:44] = [[0.4, -5.9], [width - 1.2, -2.0], [-2.6, height - 3.3], [60.5, 60.5]]
    sh = rng.uniform(0, max(height, width), (n_frames, 18, 2)).astype(np.float32)
    sh[-1, :3] = [[-4.2, height - 2.0], [width + 0.3, height + 7.0], [-0.99, -0.99]]
    return lm, sh


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("height,width", [(96, 128), (128, 128)])
def test_render_input_twin_matches_pallas_concat_cast(dtype, height, width):
    """The renderer's input (K1's second entry, its CPU twin): bitwise equal
    to the JAX package's Pallas rasteriser in interpret mode, concatenated
    with the candidate stack and cast to bf16 (f32: without the cast)."""
    lm, sh = _render_landmarks(3, height, width, seed=height)
    rng = np.random.default_rng(width)
    cand = rng.uniform(-1, 1, (height, width, 12)).astype(np.float32)
    edge = jpallas.rasterize_feature_maps_pallas(jnp.asarray(lm), jnp.asarray(sh),
                                                 (height, width), interpret=True)
    ref = jnp.concatenate([edge[..., None],
                           jnp.broadcast_to(jnp.asarray(cand), (3, height, width, 12))], axis=-1)
    ref = np.asarray(ref.astype(jnp.bfloat16) if dtype == "bfloat16" else ref, np.float32)
    tdtype = getattr(torch, dtype)
    ours = rasterize_cuda.render_input(torch.tensor(lm), torch.tensor(sh),
                                       torch.tensor(cand).to(tdtype), (height, width))
    assert ours.dtype == tdtype and ours.shape == (3, height, width, 13)
    assert ours.is_contiguous()
    np.testing.assert_array_equal(ours.float().numpy(), ref)
    assert ref[..., 0].sum() > 100 and set(np.unique(ref[..., 0])) == {0.0, 1.0}


def test_segment_pairs_come_from_the_lists_once_per_device_and_count():
    """The kernel's index pairs are face_segments() then shoulder_segments()
    offset by the 73 landmarks, built once per (device, shoulder count)."""
    face = rasterize.face_segments()
    for n in (0, 1, 18, 7):
        pairs = rasterize_cuda.segment_pairs("cpu", n)
        want = np.concatenate([face, rasterize.shoulder_segments(n) + 73])
        assert pairs.dtype == torch.int32
        np.testing.assert_array_equal(pairs.numpy(), want)
        assert rasterize_cuda.segment_pairs(torch.device("cpu"), n) is pairs
    assert rasterize_cuda.segment_pairs("cpu", 18).shape == (len(face) + 16, 2)
    assert rasterize_cuda.segment_pairs("cpu", 18) is not rasterize_cuda.segment_pairs("cpu", 0)


def test_render_input_twin_keeps_the_render_loop_arithmetic():
    """The twin is rasterize_feature_maps, then cat, then cast, for any
    shoulder count, and no shoulders at all."""
    lm, sh = _render_landmarks(2, 64, 64, seed=5)
    cand = torch.tensor(np.random.default_rng(6).normal(size=(64, 64, 12)).astype(np.float32))
    for shoulders in (torch.tensor(sh), torch.tensor(sh[:, :1]), None):
        edge = rasterize.rasterize_feature_maps(torch.tensor(lm), shoulders, (64, 64))
        ref = torch.cat([edge[..., None], cand.expand(2, 64, 64, 12)], dim=-1)
        got = rasterize_cuda.render_input(torch.tensor(lm), shoulders, cand.to(torch.bfloat16),
                                          (64, 64))
        assert torch.equal(got, ref.to(torch.bfloat16))
        assert torch.equal(rasterize_cuda.render_input(torch.tensor(lm), shoulders, cand,
                                                       (64, 64)), ref)
