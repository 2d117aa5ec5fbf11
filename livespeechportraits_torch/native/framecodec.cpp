// Host-side frame decoder of the PyTorch port's compressed transfers.
//
// The renderer ships frames to the host as compressed codes
// (livespeechportraits_torch/pipeline/compress.py: the int8 zonal-DCT
// "jpeg", the 4-bit-AC "jpeg4" (pack4) and its entropy-coded recoding
// pack4e).  This translation unit decodes them in one pass over the code:
// blocks reconstructed by a k-term basis accumulation with zero-coefficient
// skipping (most quantized ACs are zero on rendered face content), planes
// quantized to uint8 and color-converted in place.  It is called through
// ctypes (livespeechportraits_torch/native/__init__.py), which releases the
// GIL for the whole decode.
//
// Semantics are pinned to compress.py's numpy decoders
// (tests/test_torch_compress.py): the only tolerated divergence is the
// float32 summation order inside the k-term dot, i.e. at most 1 LSB on a
// vanishing fraction of pixels.  The same source as the JAX package's
// native/framecodec.cpp; the port keeps its own copy.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>

namespace {

inline uint8_t q8(float x) {
    // matches np.clip(x + 0.5, 0, 255).astype(uint8): round-half-up
    // via truncation of the clipped, offset value.  Branchless (minss/
    // maxss) - data-dependent branches mispredict on out-of-gamut
    // values and block vectorization.
    x = std::min(std::max(x + 0.5f, 0.0f), 255.0f);
    return static_cast<uint8_t>(x);
}

// Accumulate one block's pixels from its k-term coefficient vector and
// write the quantized 8x8 tile at block index b of a plane of width w.
// Shared by every decoder here so reconstructions are bitwise-identical
// across formats whenever the coefficients are (pack4 vs pack4e).
inline void accum_block(const float* coef, int k, const float* basis,
                        int b, int wb, int w, uint8_t* out) {
    float acc[64];
    for (int j = 0; j < 64; ++j) acc[j] = 128.0f;
    for (int kk = 0; kk < k; ++kk) {
        const float c = coef[kk];
        if (c == 0.0f) continue;  // flat-block fast path
        const float* brow = basis + 64 * kk;
        for (int j = 0; j < 64; ++j) acc[j] += c * brow[j];
    }
    uint8_t* dst = out + static_cast<size_t>(b / wb) * 8 * w
                       + static_cast<size_t>(b % wb) * 8;
    for (int r = 0; r < 8; ++r)
        for (int cidx = 0; cidx < 8; ++cidx)
            dst[static_cast<size_t>(r) * w + cidx] = q8(acc[r * 8 + cidx]);
}

// Parse one plane from a pack4e stream (variable-length, self-delimiting
// — see pipeline/compress.py pack4e layout).  Returns the new read
// position, or -1 if the stream would run past `end` (truncated prefix:
// the caller refetches a larger one).
long decode_plane_p4e(const uint8_t* buf, long pos, long end,
                      const float* basis, int hb, int wb, int k,
                      uint8_t* out) {
    const int nb = hb * wb;
    const int w = wb * 8;
    int prev = 128;
    float coef[64];
    for (int b = 0; b < nb; ++b) {
        if (pos >= end) return -1;
        const uint8_t c = buf[pos++];
        const int dcf = c >> 7;
        const int m = (c >> 3) & 0xF;
        const int s = c & 0x7;
        if (dcf) {
            if (pos >= end) return -1;
            prev = (prev + buf[pos++]) & 0xFF;
        }
        const int nbyt = (m + 1) / 2;
        if (pos + nbyt > end) return -1;
        for (int j = 0; j < k; ++j) coef[j] = 0.0f;
        coef[0] = static_cast<float>(prev) - 128.0f;
        const float scale = std::exp2f(static_cast<float>(s));
        for (int t = 0; t < m; ++t) {
            const uint8_t byte = buf[pos + t / 2];
            const int nibble = (t & 1) ? (byte >> 4) : (byte & 0xF);
            coef[1 + t] = static_cast<float>(nibble - 8) * scale;
        }
        pos += nbyt;
        accum_block(coef, k, basis, b, wb, w, out);
    }
    return pos;
}

// Reconstruct one plane from a pack4 code segment.
//   code layout (nb = hb*wb blocks, k odd):
//     [nb]          DC bytes  (int8 stored as uint8 + 128)
//     [nb/2]        shift nibbles (two 4-bit block shifts per byte)
//     [nb*(k-1)/2]  AC nibbles (coefficient pairs (2j, 2j+1) -> (lo, hi))
//   basis: [k, 64] dequantize+iDCT operator rows
//          (compress._dequant_idct_basis).
// Output: uint8 plane [hb*8, wb*8], row-major.
void decode_plane_p4(const uint8_t* code, const float* basis,
                     int hb, int wb, int k, uint8_t* out) {
    const int nb = hb * wb;
    const uint8_t* dc = code;
    const uint8_t* sb = code + nb;
    const uint8_t* nib = sb + nb / 2;
    const int pairs = (k - 1) / 2;
    const int w = wb * 8;

    float coef[64];  // k <= 64
    for (int b = 0; b < nb; ++b) {
        const float d0 = static_cast<float>(dc[b]) - 128.0f;
        const uint8_t sraw = sb[b >> 1];
        const float scale =
            std::exp2f(static_cast<float>((b & 1) ? (sraw >> 4)
                                                  : (sraw & 0xF)));
        const uint8_t* np_ = nib + static_cast<size_t>(b) * pairs;
        coef[0] = d0;
        for (int j = 0; j < pairs; ++j) {
            const uint8_t byte = np_[j];
            coef[1 + 2 * j] = (static_cast<float>(byte & 0xF) - 8.0f) * scale;
            coef[2 + 2 * j] = (static_cast<float>(byte >> 4) - 8.0f) * scale;
        }
        accum_block(coef, k, basis, b, wb, w, out);
    }
}

// Reconstruct one plane from an int8 zonal code segment ([nb, k] int8,
// blocks-major).  Same basis contract as decode_plane_p4.
void decode_plane_zonal(const int8_t* code, const float* basis,
                        int hb, int wb, int k, uint8_t* out) {
    const int nb = hb * wb;
    const int w = wb * 8;
    float coef[64];
    for (int b = 0; b < nb; ++b) {
        const int8_t* cb = code + static_cast<size_t>(b) * k;
        for (int kk = 0; kk < k; ++kk) coef[kk] = static_cast<float>(cb[kk]);
        accum_block(coef, k, basis, b, wb, w, out);
    }
}

// I420 uint8 planes -> interleaved uint8 RGB, BT.601 full range,
// nearest (2x2 repeat) chroma upsample.  Mirrors
// compress.yuv420_to_rgb bit-for-bit: the
// per-pixel float expressions are identical and evaluated in the same
// order, so no summation-order slack is needed here.
void i420_to_rgb_frame(const uint8_t* y, const uint8_t* u, const uint8_t* v,
                       int h, int w, uint8_t* rgb) {
    const int cw = w / 2;
    for (int r = 0; r < h; ++r) {
        const uint8_t* yrow = y + static_cast<size_t>(r) * w;
        const uint8_t* urow = u + static_cast<size_t>(r / 2) * cw;
        const uint8_t* vrow = v + static_cast<size_t>(r / 2) * cw;
        uint8_t* orow = rgb + static_cast<size_t>(r) * w * 3;
        for (int c = 0; c < w; ++c) {
            const float yf = static_cast<float>(yrow[c]);
            const float uf = static_cast<float>(urow[c >> 1]) - 128.0f;
            const float vf = static_cast<float>(vrow[c >> 1]) - 128.0f;
            orow[3 * c + 0] = q8(yf + 1.402f * vf);
            orow[3 * c + 1] = q8(yf - 0.344136f * uf - 0.714136f * vf);
            orow[3 * c + 2] = q8(yf + 1.772f * uf);
        }
    }
}

}  // namespace

extern "C" {

// pack4 code [B, bytes] -> RGB [B, h, w, 3].  scratch must hold
// h*w + 2*(h/2)*(w/2) bytes (one frame's I420 planes).
void lsp_decode_p4(const uint8_t* packed, int B, int h, int w,
                   int k_y, int k_c,
                   const float* basis_y, const float* basis_c,
                   uint8_t* scratch, uint8_t* rgb_out) {
    const int nb_y = (h / 8) * (w / 8);
    const int nb_c = (h / 16) * (w / 16);
    const size_t seg_y = nb_y + nb_y / 2
        + static_cast<size_t>(nb_y) * (k_y - 1) / 2;
    const size_t seg_c = nb_c + nb_c / 2
        + static_cast<size_t>(nb_c) * (k_c - 1) / 2;
    const size_t stride = seg_y + 2 * seg_c;
    uint8_t* yp = scratch;
    uint8_t* up = yp + static_cast<size_t>(h) * w;
    uint8_t* vp = up + static_cast<size_t>(h / 2) * (w / 2);
    for (int f = 0; f < B; ++f) {
        const uint8_t* code = packed + static_cast<size_t>(f) * stride;
        decode_plane_p4(code, basis_y, h / 8, w / 8, k_y, yp);
        decode_plane_p4(code + seg_y, basis_c, h / 16, w / 16, k_c, up);
        decode_plane_p4(code + seg_y + seg_c, basis_c,
                        h / 16, w / 16, k_c, vp);
        i420_to_rgb_frame(yp, up, vp, h, w,
                          rgb_out + static_cast<size_t>(f) * h * w * 3);
    }
}

// int8 zonal code [B, bytes] -> RGB [B, h, w, 3].
void lsp_decode_zonal(const int8_t* packed, int B, int h, int w,
                      int k_y, int k_c,
                      const float* basis_y, const float* basis_c,
                      uint8_t* scratch, uint8_t* rgb_out) {
    const int nb_y = (h / 8) * (w / 8);
    const int nb_c = (h / 16) * (w / 16);
    const size_t seg_y = static_cast<size_t>(nb_y) * k_y;
    const size_t seg_c = static_cast<size_t>(nb_c) * k_c;
    const size_t stride = seg_y + 2 * seg_c;
    uint8_t* yp = scratch;
    uint8_t* up = yp + static_cast<size_t>(h) * w;
    uint8_t* vp = up + static_cast<size_t>(h / 2) * (w / 2);
    for (int f = 0; f < B; ++f) {
        const int8_t* code = packed + static_cast<size_t>(f) * stride;
        decode_plane_zonal(code, basis_y, h / 8, w / 8, k_y, yp);
        decode_plane_zonal(code + seg_y, basis_c, h / 16, w / 16, k_c, up);
        decode_plane_zonal(code + seg_y + seg_c, basis_c,
                           h / 16, w / 16, k_c, vp);
        i420_to_rgb_frame(yp, up, vp, h, w,
                          rgb_out + static_cast<size_t>(f) * h * w * 3);
    }
}

// pack4e stream prefix (navail bytes) -> RGB [B, h, w, 3].  Returns the
// total bytes consumed, or -1 if the prefix is truncated (caller
// refetches a larger prefix — the stream is self-delimiting, so no
// length side-channel crosses the link).
long lsp_decode_p4e(const uint8_t* buf, long navail, int B, int h, int w,
                    int k_y, int k_c,
                    const float* basis_y, const float* basis_c,
                    uint8_t* scratch, uint8_t* rgb_out) {
    uint8_t* yp = scratch;
    uint8_t* up = yp + static_cast<size_t>(h) * w;
    uint8_t* vp = up + static_cast<size_t>(h / 2) * (w / 2);
    long pos = 0;
    for (int f = 0; f < B; ++f) {
        pos = decode_plane_p4e(buf, pos, navail, basis_y, h / 8, w / 8,
                               k_y, yp);
        if (pos < 0) return -1;
        pos = decode_plane_p4e(buf, pos, navail, basis_c, h / 16, w / 16,
                               k_c, up);
        if (pos < 0) return -1;
        pos = decode_plane_p4e(buf, pos, navail, basis_c, h / 16, w / 16,
                               k_c, vp);
        if (pos < 0) return -1;
        i420_to_rgb_frame(yp, up, vp, h, w,
                          rgb_out + static_cast<size_t>(f) * h * w * 3);
    }
    return pos;
}

}  // extern "C"
