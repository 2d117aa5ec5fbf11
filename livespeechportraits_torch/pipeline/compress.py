"""Frame coders of the renderer's transfers: encoders on the device, decoders
on the host.

Counterpart of ``livespeechportraits_tpu/pipeline/compress.py``.  Three
JPEG-class codes of BT.601 YUV 4:2:0 frames, each an 8x8 block DCT with the
JPEG Annex-K quantization tables (libjpeg quality scaling, DC step floored
at 8 so the centred DC fits int8) and a zonal choice of the first K zigzag
coefficients of each block:

- ``jpeg``: the K coefficients as int8 (``encode_rgb_frames``);
- ``jpeg4`` (pack4): DC as a byte, the K-1 ACs as 4-bit nibbles under one
  shift exponent a block (``encode_rgb_frames_p4``);
- ``pack4e``: a lossless, variable-length recoding of pack4 (trailing zero
  ACs cut, unchanged DCs skipped), packed back to back from byte 0 of a
  static worst-case buffer, so the host fetches only a prefix
  (``encode_rgb_frames_p4e``).

The encoders are torch ops on the frames' device: the block DCT is two f32
matmuls with block-diagonal operators (TF32 must be off, PyTorch's
default), the packing integer work (exclusive cumsums and one scatter).
The host decoders are the C++ codec of ``livespeechportraits_torch/native``
(``decode_to_rgb``, ``decode_to_rgb_p4``, ``decode_to_rgb_p4e``); the numpy
decoders below (``decode_to_yuv``, ``decode_to_yuv_p4``,
``decode_to_rgb_p4e_np``) are their reference in the tests.  The yuv420
transfer's host conversion (``i420_to_rgb``, torch on the CPU) and its
numpy reference (``yuv420_to_rgb``) live here too.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch

from livespeechportraits_torch import native

Tensor = torch.Tensor

# JPEG Annex-K base quantization tables (the spec's example tables, used by
# libjpeg and virtually every encoder).
_Q_LUMA = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99],
], np.float32)

_Q_CHROMA = np.array([
    [17, 18, 24, 47, 99, 99, 99, 99],
    [18, 21, 26, 66, 99, 99, 99, 99],
    [24, 26, 56, 99, 99, 99, 99, 99],
    [47, 66, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
], np.float32)


def zigzag_order() -> np.ndarray:
    """The 64 (row, col) flat indices in JPEG zigzag order."""
    out = []
    for s in range(15):
        diag = [(s - j, j) for j in range(max(0, s - 7), min(s, 7) + 1)]
        if s % 2 == 1:
            diag = diag[::-1]
        out.extend(diag)
    return np.array([i * 8 + j for i, j in out], np.int64)


_ZIGZAG = zigzag_order()

# Defaults, as in the JAX package: the jpeg code at (16, 6) and the pack4
# codes at (13, 5) clear the 30 dB serving gate on rendered frames.  pack4's
# K is odd (the K-1 AC nibbles pack in pairs).
DEFAULT_QUALITY = 75
DEFAULT_K_Y = 16
DEFAULT_K_C = 6
DEFAULT_P4_K_Y = 13
DEFAULT_P4_K_C = 5

_P4_MAX_SHIFT = 7  # 4-bit shift field; 7.5 * 2^7 = 960 covers every table


def dct_matrix() -> np.ndarray:
    """Orthonormal 8-point DCT-II matrix D: coefficients = D @ x @ D.T."""
    k = np.arange(8)
    d = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16.0)
    d[0] *= 1.0 / np.sqrt(2.0)
    return (d * 0.5).astype(np.float32)


def quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg quality scaling of a base table; DC step floored at 8 so the
    centred DC range [-1024, 1016] always fits int8 exactly."""
    q = int(quality)
    scale = 5000.0 / q if q < 50 else 200.0 - 2.0 * q
    t = np.floor((base * scale + 50.0) / 100.0).clip(1, 255)
    t.flat[0] = max(t.flat[0], 8.0)
    return t.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _bd_dct(n: int, transpose: bool) -> np.ndarray:
    """Block-diagonal 8-point DCT operator of size n (kron(I, D) or
    kron(I, D^T)): every block's 1-D DCT along an image axis as one [n, n]
    matmul."""
    d = dct_matrix()
    return np.kron(np.eye(n // 8, dtype=np.float32), d.T if transpose else d)


_CONSTS: Dict[Tuple, Tensor] = {}


def _const(key: Tuple, make, device: torch.device) -> Tensor:
    """The constant table ``make()`` on ``device``, uploaded once per key
    (an upload is a synchronizing copy, which the render loop never makes)."""
    key = (key, str(device))
    if key not in _CONSTS:
        _CONSTS[key] = torch.as_tensor(make(), device=device)
    return _CONSTS[key]


def _zigzag_quant(plane: Tensor, base: np.ndarray, quality: int, k: int) -> Tensor:
    """[B, H, W] f32 (0..255) -> [B, nblocks, k] f32 table-quantized zigzag
    coefficients: block-diagonal DCT matmuls, table quantization (round
    half to even, as jnp.round), zigzag gather.  The shared front half of
    every coder here."""
    B, H, W = plane.shape
    if H % 8 or W % 8:
        raise ValueError(f"a plane of {H}x{W} does not split into 8x8 blocks")
    dev = plane.device
    if dev.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the block DCT needs f32 matmuls: "
                           "torch.backends.cuda.matmul.allow_tf32 is on")
    m_col = _const(("dct", H, False), lambda: _bd_dct(H, False), dev)
    m_row = _const(("dct", W, True), lambda: _bd_dct(W, True), dev)
    qplane = _const(("q", base is _Q_LUMA, quality, H, W),
                    lambda: np.tile(quant_table(base, quality), (H // 8, W // 8)), dev)
    zz = _const(("zz", k), lambda: _ZIGZAG[:k], dev)
    x = plane.float() - 128.0
    coef = torch.matmul(m_col, x) @ m_row  # [B, H, W]
    q = torch.round(coef / qplane)
    blocks = q.reshape(B, H // 8, 8, W // 8, 8).permute(0, 1, 3, 2, 4).reshape(B, -1, 64)
    return blocks[..., zz]


def _encode_plane(plane: Tensor, base: np.ndarray, quality: int, k: int) -> Tensor:
    """[B, H, W] f32 (0..255) -> [B, nblocks*k] int8 zonal DCT code."""
    zz = _zigzag_quant(plane, base, quality, k)
    return zz.clamp(-128, 127).to(torch.int8).reshape(plane.shape[0], -1)


def _defaults(quality, k_y, k_c) -> Tuple[int, int, int]:
    return (DEFAULT_QUALITY if quality is None else quality,
            DEFAULT_K_Y if k_y is None else k_y, DEFAULT_K_C if k_c is None else k_c)


def _p4_defaults(quality, k_y, k_c) -> Tuple[int, int, int]:
    return (DEFAULT_QUALITY if quality is None else quality,
            DEFAULT_P4_K_Y if k_y is None else k_y, DEFAULT_P4_K_C if k_c is None else k_c)


def _plane_sizes(h: int, w: int, k_y: int, k_c: int) -> Tuple[int, int]:
    """(luma bytes, bytes of one chroma plane) of a frame's zonal code."""
    return (h // 8) * (w // 8) * k_y, (h // 16) * (w // 16) * k_c


def encoded_bytes_per_frame(h: int, w: int, k_y: int = None, k_c: int = None) -> int:
    _, k_y, k_c = _defaults(None, k_y, k_c)
    ny, nc = _plane_sizes(h, w, k_y, k_c)
    return ny + 2 * nc


def rgb_to_yuv_planes(img: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """[B, H, W, 3] in [-1, 1] -> f32 (Y [B, H, W], U/V [B, H/2, W/2]),
    BT.601 full range, 0..255 (the yuv420 transfer's colour space), on the
    tensor's device; chroma is the mean of each 2x2 block."""
    rgb = (img.float() + 1.0) * 127.5
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    v = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0

    def down2(c):
        B, H, W = c.shape
        return c.reshape(B, H // 2, 2, W // 2, 2).mean(dim=(2, 4))

    return y, down2(u), down2(v)


def encode_yuv420(y: Tensor, u: Tensor, v: Tensor, quality: int = None, k_y: int = None,
                  k_c: int = None) -> Tensor:
    """f32 YUV planes (Y [B, H, W], U/V [B, H/2, W/2], 0..255) -> one
    [B, bytes_per_frame] int8 zonal code."""
    quality, k_y, k_c = _defaults(quality, k_y, k_c)
    return torch.cat([_encode_plane(y, _Q_LUMA, quality, k_y),
                      _encode_plane(u, _Q_CHROMA, quality, k_c),
                      _encode_plane(v, _Q_CHROMA, quality, k_c)], dim=1)


def encode_rgb_frames(img: Tensor, quality: int = None, k_y: int = None,
                      k_c: int = None) -> Tensor:
    """[B, H, W, 3] in [-1, 1] -> the int8 zonal code ('jpeg'), on the
    tensor's device."""
    return encode_yuv420(*rgb_to_yuv_planes(img), quality=quality, k_y=k_y, k_c=k_c)


# ---------------------------------------------------------------------------
# pack4 ('jpeg4'): per block, DC as a byte (int8 + 128), one 4-bit shift s
# (the smallest with max|ac| <= 7.5 * 2^s) and the K-1 ACs as nibbles
# round(ac / 2^s) + 8.  Per-plane layout (nb blocks, K odd):
#   [B, nb]          DC bytes
#   [B, nb/2]        shift nibbles (two a byte, even block in the low nibble)
#   [B, nb*(K-1)/2]  AC nibbles (coefficients 2j, 2j+1 -> low, high)
# ---------------------------------------------------------------------------


def _plane_sizes_p4(h: int, w: int, k: int) -> int:
    nb = (h // 8) * (w // 8)
    return nb + nb // 2 + nb * (k - 1) // 2


def encoded_bytes_per_frame_p4(h: int, w: int, k_y: int = None, k_c: int = None) -> int:
    _, k_y, k_c = _p4_defaults(None, k_y, k_c)
    return _plane_sizes_p4(h, w, k_y) + 2 * _plane_sizes_p4(h // 2, w // 2, k_c)


def _shift_and_nibbles(zz: Tensor) -> Tuple[Tensor, Tensor]:
    """[B, nb, k] quantized zigzag floats -> (s [B, nb] f32 block shifts,
    n [B, nb, k-1] int32 biased nibbles, 8 == zero)."""
    ac = zz[..., 1:]
    m = ac.abs().amax(dim=-1)
    thresholds = _const(("p4thr",), lambda: 7.5 * 2.0 ** np.arange(_P4_MAX_SHIFT,
                                                                    dtype=np.float32),
                        zz.device)
    s = (m[..., None] > thresholds).sum(dim=-1).float()
    n = (torch.round(ac * torch.exp2(-s)[..., None]).clamp(-8, 7) + 8.0).to(torch.int32)
    return s, n


def _encode_plane_p4(plane: Tensor, base: np.ndarray, quality: int, k: int) -> Tensor:
    """[B, H, W] f32 (0..255) -> [B, _plane_sizes_p4] uint8 pack4 code."""
    if (k - 1) % 2:
        raise ValueError(f"pack4 K must be odd, got {k}")
    B = plane.shape[0]
    zz = _zigzag_quant(plane, base, quality, k)  # [B, nb, k]
    if zz.shape[1] % 2:
        raise ValueError(f"pack4 packs two block shifts a byte: {zz.shape[1]} blocks is odd")
    dc = (zz[..., 0].clamp(-128, 127) + 128.0).to(torch.uint8)
    s, n = _shift_and_nibbles(zz)
    nib = (n[..., 0::2] | (n[..., 1::2] << 4)).to(torch.uint8).reshape(B, -1)
    su = s.to(torch.int32)
    sbyte = (su[:, 0::2] | (su[:, 1::2] << 4)).to(torch.uint8)
    return torch.cat([dc, sbyte, nib], dim=1)


def encode_yuv420_p4(y: Tensor, u: Tensor, v: Tensor, quality: int = None, k_y: int = None,
                     k_c: int = None) -> Tensor:
    """f32 YUV planes -> one [B, bytes] uint8 pack4 code."""
    quality, k_y, k_c = _p4_defaults(quality, k_y, k_c)
    return torch.cat([_encode_plane_p4(y, _Q_LUMA, quality, k_y),
                      _encode_plane_p4(u, _Q_CHROMA, quality, k_c),
                      _encode_plane_p4(v, _Q_CHROMA, quality, k_c)], dim=1)


def encode_rgb_frames_p4(img: Tensor, quality: int = None, k_y: int = None,
                         k_c: int = None) -> Tensor:
    """[B, H, W, 3] in [-1, 1] -> the pack4 code ('jpeg4'), on the tensor's
    device."""
    return encode_yuv420_p4(*rgb_to_yuv_planes(img), quality=quality, k_y=k_y, k_c=k_c)


# ---------------------------------------------------------------------------
# pack4e: the pack4 coefficients, entropy-coded a block at a time:
#   control byte: bit 7 = dc_flag, bits 6..3 = m (AC nibbles kept: through
#                 the last nonzero, 0..K-1), bits 2..0 = s (pack4's shift)
#   [dc_flag]     1 byte: (dc - previous dc) mod 256 (the previous starts at 128)
#   ceil(m/2)     AC nibble bytes (low, high; an odd m pads with 8, a zero)
# A frame is its luma blocks, then U, then V, in raster order; frames follow
# each other back to back from byte 0 of a [B * cap] buffer whose tail is
# zero.  The stream delimits itself, so the host needs no length.
# ---------------------------------------------------------------------------


def _p4e_slots(k: int) -> int:
    return 2 + (k - 1) // 2


def p4e_bytes_per_frame_cap(h: int, w: int, k_y: int = None, k_c: int = None) -> int:
    """Worst-case bytes a frame (every block: a DC delta and all nibbles)."""
    _, k_y, k_c = _p4_defaults(None, k_y, k_c)
    nb_y = (h // 8) * (w // 8)
    nb_c = (h // 16) * (w // 16)
    return nb_y * _p4e_slots(k_y) + 2 * nb_c * _p4e_slots(k_c)


def _check_p4e_k(k: int) -> None:
    if (k - 1) % 2:
        raise ValueError(f"pack4e K must be odd, got {k}")
    if k > 15:
        # m (up to k-1) is a 4-bit field; a larger k would overflow into the dc flag
        raise ValueError(f"pack4e K must be <= 15 (4-bit m field), got {k}")


def _p4e_tokens(zz: Tensor, k: int):
    """[B, nb, k] quantized zigzag floats -> each block's slots: (vals
    [B, nb, S] uint8, valid [B, nb, S] bool, within [B, nb, S] int32 exclusive
    cumsum of valid, nbytes [B, nb] int32)."""
    _check_p4e_k(k)
    B, nb, _ = zz.shape
    dcu = (zz[..., 0].clamp(-128, 127) + 128.0).to(torch.int32)
    prev = torch.cat([torch.full((B, 1), 128, dtype=torch.int32, device=zz.device),
                      dcu[:, :-1]], dim=1)
    d = (dcu - prev) & 0xFF
    s, n = _shift_and_nibbles(zz)
    pos = torch.arange(1, k, dtype=torch.int32, device=zz.device)
    m = torch.where(n != 8, pos, torch.zeros_like(pos)).amax(dim=-1)  # kept nibbles
    dcf = (d != 0).to(torch.int32)
    nnib = (m + 1) // 2
    nbytes = 1 + dcf + nnib
    control = (dcf << 7) | (m << 3) | s.to(torch.int32)
    pair = n[..., 0::2] | (n[..., 1::2] << 4)  # [B, nb, (k-1)/2]
    vals = torch.cat([control[..., None], d[..., None], pair], dim=-1).to(torch.uint8)
    t = torch.arange(_p4e_slots(k) - 2, device=zz.device)
    valid = torch.cat([torch.ones(B, nb, 1, dtype=torch.bool, device=zz.device),
                       (dcf == 1)[..., None], t < nnib[..., None]], dim=-1)
    vi = valid.to(torch.int32)
    within = torch.cumsum(vi, dim=-1, dtype=torch.int32) - vi
    return vals, valid, within, nbytes


def _p4e_pack(toks, B: int, cap: int) -> Tuple[Tensor, Tensor]:
    """Per-plane slot tables -> (flat [B * cap] uint8, total int32): byte
    offsets by exclusive cumsums, then one scatter of every valid slot.  An
    invalid slot goes to one spare byte past the stream, which is cut off, so
    no stream byte is written twice and the device never synchronizes."""
    nbytes_cat = torch.cat([t[3] for t in toks], dim=1)
    csum = torch.cumsum(nbytes_cat, dim=1, dtype=torch.int32)
    frame_len = csum[:, -1]
    offs = csum - nbytes_cat  # exclusive, within the frame
    base = torch.cumsum(frame_len, dim=0, dtype=torch.int32) - frame_len
    flat = torch.zeros(B * cap + 1, dtype=torch.uint8, device=nbytes_cat.device)
    col = 0
    for vals, valid, within, nb_arr in toks:
        nb = nb_arr.shape[1]
        tgt = base[:, None, None] + offs[:, col:col + nb, None] + within
        col += nb
        tgt = torch.where(valid, tgt, B * cap)
        flat.scatter_(0, tgt.reshape(-1).long(), vals.reshape(-1))
    return flat[:B * cap], frame_len.sum(dtype=torch.int32)


def encode_yuv420_p4e(y: Tensor, u: Tensor, v: Tensor, quality: int = None, k_y: int = None,
                      k_c: int = None) -> Tuple[Tensor, Tensor]:
    """f32 YUV planes -> (flat [B * cap] uint8 pack4e stream, total int32).
    Bytes at and past ``total`` are zero; fetch a prefix of at least
    ``total`` bytes and hand it to decode_to_rgb_p4e."""
    quality, k_y, k_c = _p4_defaults(quality, k_y, k_c)
    _check_p4e_k(k_y)
    _check_p4e_k(k_c)
    B, h, w = y.shape
    toks = [_p4e_tokens(_zigzag_quant(y, _Q_LUMA, quality, k_y), k_y),
            _p4e_tokens(_zigzag_quant(u, _Q_CHROMA, quality, k_c), k_c),
            _p4e_tokens(_zigzag_quant(v, _Q_CHROMA, quality, k_c), k_c)]
    return _p4e_pack(toks, B, p4e_bytes_per_frame_cap(h, w, k_y, k_c))


def encode_rgb_frames_p4e(img: Tensor, quality: int = None, k_y: int = None,
                          k_c: int = None) -> Tuple[Tensor, Tensor]:
    """[B, H, W, 3] in [-1, 1] -> (flat pack4e stream, total bytes), on the
    tensor's device."""
    return encode_yuv420_p4e(*rgb_to_yuv_planes(img), quality=quality, k_y=k_y, k_c=k_c)


# ---------------------------------------------------------------------------
# Host decoders: the numpy references, then the native codec.
# ---------------------------------------------------------------------------


def _zig_qvec(base: np.ndarray, quality: int, k: int) -> np.ndarray:
    return quant_table(base, quality).reshape(-1)[_ZIGZAG[:k]]


@functools.lru_cache(maxsize=16)
def _dequant_idct_basis(is_luma: bool, quality: int, k: int) -> np.ndarray:
    """[k, 64] dequantize + inverse-DCT operator: x[i, j] = sum_k c_k q_k
    D[u_k, i] D[v_k, j] over the k kept zigzag coefficients (the native
    codec's basis).  Cached and shared: read only."""
    qvec = _zig_qvec(_Q_LUMA if is_luma else _Q_CHROMA, quality, k)
    d = dct_matrix()
    rows = []
    for kk in range(k):
        u, v = divmod(int(_ZIGZAG[kk]), 8)
        rows.append(np.outer(d[u], d[v]).reshape(64) * qvec[kk])
    out = np.ascontiguousarray(np.stack(rows), np.float32)
    out.flags.writeable = False
    return out


def _u8(p: np.ndarray) -> np.ndarray:
    return np.clip(p + 0.5, 0, 255).astype(np.uint8)


def _idct_blocks(zz: np.ndarray, qvec: np.ndarray, h: int, w: int, k: int) -> np.ndarray:
    """[B, nb, k] quantized zigzag coefficients -> [B, h, w] f32 plane
    (0..255, unclipped)."""
    B, nb = zz.shape[:2]
    c = np.zeros((B, nb, 64), np.float32)
    c[:, :, _ZIGZAG[:k]] = zz * qvec
    c = c.reshape(B, h // 8, w // 8, 8, 8)
    d = dct_matrix()
    x = np.einsum("ai,bhwac,cj->bhiwj", d, c, d, optimize=True) + 128.0
    return x.reshape(B, h, w)


def _decode_plane(code: np.ndarray, qvec: np.ndarray, h: int, w: int, k: int) -> np.ndarray:
    """[B, nblocks*k] int8 -> [B, h, w] f32 plane (0..255, unclipped)."""
    B = code.shape[0]
    nb = (h // 8) * (w // 8)
    return _idct_blocks(code.reshape(B, nb, k).astype(np.float32), qvec, h, w, k)


def decode_to_yuv(packed: np.ndarray, h: int, w: int, quality: int = None, k_y: int = None,
                  k_c: int = None):
    """Numpy inverse of encode_yuv420 -> uint8 (Y [B, h, w], U, V
    [B, h/2, w/2]) planes, ready for yuv420_to_rgb."""
    quality, k_y, k_c = _defaults(quality, k_y, k_c)
    packed = np.asarray(packed).view(np.int8)
    ny, nc = _plane_sizes(h, w, k_y, k_c)
    qy, qc = _zig_qvec(_Q_LUMA, quality, k_y), _zig_qvec(_Q_CHROMA, quality, k_c)
    yb = _decode_plane(packed[:, :ny], qy, h, w, k_y)
    ub = _decode_plane(packed[:, ny:ny + nc], qc, h // 2, w // 2, k_c)
    vb = _decode_plane(packed[:, ny + nc:], qc, h // 2, w // 2, k_c)
    return _u8(yb), _u8(ub), _u8(vb)


def _decode_plane_p4_np(code: np.ndarray, base: np.ndarray, quality: int, h: int, w: int,
                        k: int) -> np.ndarray:
    """Numpy inverse of _encode_plane_p4 -> [B, h, w] f32 plane."""
    B = code.shape[0]
    nb = (h // 8) * (w // 8)
    dc = code[:, :nb].astype(np.float32) - 128.0
    sb = code[:, nb:nb + nb // 2]
    s = np.empty((B, nb), np.float32)
    s[:, 0::2] = (sb & 0xF).astype(np.float32)
    s[:, 1::2] = (sb >> 4).astype(np.float32)
    pairs = code[:, nb + nb // 2:].reshape(B, nb, (k - 1) // 2)
    n = np.empty((B, nb, k - 1), np.float32)
    n[..., 0::2] = (pairs & 0xF).astype(np.float32) - 8.0
    n[..., 1::2] = (pairs >> 4).astype(np.float32) - 8.0
    zz = np.concatenate([dc[..., None], n * np.exp2(s)[..., None]], axis=-1)
    return _idct_blocks(zz, _zig_qvec(base, quality, k), h, w, k)


def decode_to_yuv_p4(packed: np.ndarray, h: int, w: int, quality: int = None, k_y: int = None,
                     k_c: int = None):
    """Numpy inverse of encode_yuv420_p4 -> uint8 (Y, U, V) planes."""
    quality, k_y, k_c = _p4_defaults(quality, k_y, k_c)
    packed = np.asarray(packed, np.uint8)
    ny = _plane_sizes_p4(h, w, k_y)
    nc = _plane_sizes_p4(h // 2, w // 2, k_c)
    yb = _decode_plane_p4_np(packed[:, :ny], _Q_LUMA, quality, h, w, k_y)
    ub = _decode_plane_p4_np(packed[:, ny:ny + nc], _Q_CHROMA, quality, h // 2, w // 2, k_c)
    vb = _decode_plane_p4_np(packed[:, ny + nc:], _Q_CHROMA, quality, h // 2, w // 2, k_c)
    return _u8(yb), _u8(ub), _u8(vb)


def _decode_p4e_plane_np(buf: np.ndarray, pos: int, basis: np.ndarray, h: int, w: int,
                         k: int):
    """Parse one plane of a pack4e stream -> (f32 plane [h, w], 0..255
    unclipped, the new position); IndexError on a truncated stream."""
    hb, wb = h // 8, w // 8
    out = np.empty((hb, wb, 64), np.float32)
    prev = 128
    end = buf.shape[0]
    coef = np.zeros(64, np.float32)
    for b in range(hb * wb):
        if pos >= end:
            raise IndexError("pack4e stream truncated")
        c = int(buf[pos])
        pos += 1
        dcf, m, s = c >> 7, (c >> 3) & 0xF, c & 0x7
        if dcf:
            if pos >= end:
                raise IndexError("pack4e stream truncated")
            prev = (prev + int(buf[pos])) & 0xFF
            pos += 1
        nbyt = (m + 1) // 2
        if pos + nbyt > end:
            raise IndexError("pack4e stream truncated")
        coef[:] = 0.0
        coef[0] = prev - 128
        scale = float(2.0 ** s)
        for t in range(m):
            byte = int(buf[pos + t // 2])
            nibble = (byte >> 4) if t % 2 else (byte & 0xF)
            coef[1 + t] = (nibble - 8) * scale
        pos += nbyt
        out[b // wb, b % wb] = coef[:k] @ basis
    x = out.reshape(hb, wb, 8, 8).transpose(0, 2, 1, 3).reshape(h, w)
    return x + 128.0, pos


def decode_to_rgb_p4e_np(flat: np.ndarray, B: int, h: int, w: int, quality: int = None,
                         k_y: int = None, k_c: int = None, return_consumed: bool = False):
    """Numpy reference of decode_to_rgb_p4e (a Python loop over blocks)."""
    quality, k_y, k_c = _p4_defaults(quality, k_y, k_c)
    flat = np.ascontiguousarray(flat, np.uint8).reshape(-1)
    by = _dequant_idct_basis(True, quality, k_y)
    bc = _dequant_idct_basis(False, quality, k_c)
    frames, pos = [], 0
    for _ in range(B):
        yp, pos = _decode_p4e_plane_np(flat, pos, by, h, w, k_y)
        up, pos = _decode_p4e_plane_np(flat, pos, bc, h // 2, w // 2, k_c)
        vp, pos = _decode_p4e_plane_np(flat, pos, bc, h // 2, w // 2, k_c)
        frames.append(yuv420_to_rgb(_u8(yp)[None], _u8(up)[None], _u8(vp)[None])[0])
    rgb = np.stack(frames)
    return (rgb, pos) if return_consumed else rgb


def decode_to_rgb(packed: np.ndarray, h: int, w: int, quality: int = None, k_y: int = None,
                  k_c: int = None) -> np.ndarray:
    """Host: int8 zonal code [B, bytes] -> [B, h, w, 3] uint8 RGB (native)."""
    quality, k_y, k_c = _defaults(quality, k_y, k_c)
    return native.decode_zonal(np.asarray(packed), h, w, k_y, k_c,
                               _dequant_idct_basis(True, quality, k_y),
                               _dequant_idct_basis(False, quality, k_c))


def decode_to_rgb_p4(packed: np.ndarray, h: int, w: int, quality: int = None, k_y: int = None,
                     k_c: int = None) -> np.ndarray:
    """Host: pack4 code [B, bytes] -> [B, h, w, 3] uint8 RGB (native)."""
    quality, k_y, k_c = _p4_defaults(quality, k_y, k_c)
    return native.decode_p4(np.asarray(packed), h, w, k_y, k_c,
                            _dequant_idct_basis(True, quality, k_y),
                            _dequant_idct_basis(False, quality, k_c))


def decode_to_rgb_p4e(flat: np.ndarray, B: int, h: int, w: int, quality: int = None,
                      k_y: int = None, k_c: int = None, return_consumed: bool = False):
    """Host: a prefix of a pack4e stream -> [B, h, w, 3] uint8 RGB (native),
    and with return_consumed the bytes it took (the true coded size).
    Raises IndexError when the prefix is too short; the caller fetches the
    whole stream."""
    quality, k_y, k_c = _p4_defaults(quality, k_y, k_c)
    rgb, consumed = native.decode_p4e(np.asarray(flat), B, h, w, k_y, k_c,
                                      _dequant_idct_basis(True, quality, k_y),
                                      _dequant_idct_basis(False, quality, k_c))
    return (rgb, consumed) if return_consumed else rgb


# ---------------------------------------------------------------------------
# The yuv420 transfer's host side.
# ---------------------------------------------------------------------------


def yuv420_unpack(packed, h: int, w: int):
    """[B, h*w*3/2] packed planes -> (Y [B, h, w], U, V [B, h/2, w/2])."""
    B = packed.shape[0]
    y = packed[:, : h * w].reshape(B, h, w)
    q = (h // 2) * (w // 2)
    u = packed[:, h * w : h * w + q].reshape(B, h // 2, w // 2)
    v = packed[:, h * w + q :].reshape(B, h // 2, w // 2)
    return y, u, v


def yuv420_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Numpy inverse of the yuv420 pack ([B, H, W] + 2x [B, H/2, W/2] uint8 ->
    [B, H, W, 3] uint8; nearest chroma upsampling)."""
    yf = y.astype(np.float32)
    uf = np.repeat(np.repeat(u.astype(np.float32) - 128.0, 2, axis=1), 2, axis=2)
    vf = np.repeat(np.repeat(v.astype(np.float32) - 128.0, 2, axis=1), 2, axis=2)
    r = yf + 1.402 * vf
    g = yf - 0.344136 * uf - 0.714136 * vf
    b = yf + 1.772 * uf
    return np.clip(np.stack([r, g, b], axis=-1) + 0.5, 0, 255).astype(np.uint8)


def i420_to_rgb(packed: Tensor, h: int, w: int) -> Tensor:
    """[B, h*w*3/2] packed uint8 -> [B, h, w, 3] uint8 RGB on the CPU, in
    torch with yuv420_to_rgb's operation order (JAX's compress.i420_to_rgb).
    The chroma terms are computed at chroma resolution and broadcast over
    each 2x2 block: nearest upsampling commutes with them exactly.  (A C++
    conversion, JAX's lsp_i420_to_rgb, was bitwise equal but did not make
    the serving render loop faster on the H100 machine's host: PERF.md.)"""
    y, u, v = yuv420_unpack(packed.cpu(), h, w)
    B = y.shape[0]
    uf, vf = u.float() - 128.0, v.float() - 128.0

    def up(c):  # [B, h/2, w/2] -> broadcastable over [B, h/2, 2, w/2, 2]
        return c.view(B, h // 2, 1, w // 2, 1)

    yf = y.float().view(B, h // 2, 2, w // 2, 2)
    r = yf + up(1.402 * vf)
    g = yf - up(0.344136 * uf) - up(0.714136 * vf)
    b = yf + up(1.772 * uf)
    rgb = torch.stack([r, g, b], dim=-1).add_(0.5).clamp_(0, 255)
    return rgb.to(torch.uint8).view(B, h, w, 3)
