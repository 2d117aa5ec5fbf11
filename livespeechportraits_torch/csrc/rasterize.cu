// K1: landmark -> edge-map rasteriser, and the renderer's input stage.
//
// Replaces the Pallas TPU kernel livespeechportraits_tpu/ops/rasterize_pallas.py
// (_kernel, called from rasterize_segments_pallas) and what the render loop
// did around it (livespeechportraits_tpu/pipeline/animate.py:534-553: the
// segment table, the concat with the candidate stack, the cast to the
// compute dtype).  A pixel is 1 where its squared distance to any segment of
// its frame is <= radius^2, else 0.
//
// One templated kernel, two entry points:
//   lsp_rasterize     segment table [T, S, 4] f32 -> edge plane [T, H, W] f32,
//                     the Pallas kernel's own function;
//   lsp_render_input  landmarks [T, L, 2] and shoulders [T, S2, 2] f32, the
//                     segments' point-index pairs [S, 2] and the candidate
//                     stack [H, W, 12] in bf16 or f32 -> [T, H, W, 13] in the
//                     candidate's type, NHWC: the edge as channel 0, then the
//                     candidates.  That is the U-Net's input, in one launch,
//                     with the segment table built on chip (endpoints
//                     truncated toward zero, cv2's int cast); with one
//                     channel (the edge-only form, the input of the
//                     split_cand renderer, whose candidate half of the first
//                     conv is computed once a call) it writes [T, H, W, 1]
//                     and reads no candidates.  The channel count is a
//                     template parameter of the output, not a second kernel.
//
// What bounds it on the H100: bytes.  The render input is 26 bytes a pixel in
// bf16 (109 MB for 16 frames at 512^2, 32.5 us at 3.35 TB/s) against a 6.3 MB
// candidate stack read; the edge-only form 2 bytes a pixel (8.4 MB, 2.5 us),
// where the distance math, not the bytes, is likely to set the time.  The
// distance math is kept off the byte path by culling: a block (256 x 8
// pixels of one frame) loads its frame's segments once and
// keeps those whose box, grown by the radius, meets its pixel box; each warp
// culls that list again by ballot against its own region; each thread (a
// pack of 8 consecutive pixels of one row) skips a segment whose grown box
// misses its 8 pixels.  A warp's region depends on what the kernel writes:
// for the render input, where bytes set the time, 256 pixels of one row, one
// contiguous run of the candidates and of the output; for the f32 plane,
// where the distance math does, a 32 x 8 box, which meets several times
// fewer segments than a row's 256 pixels.  The fold is a max over {0, 1}, so
// neither the order of a list nor an early exit changes the result.  The
// culling is exact for the integer endpoints the pipeline draws: a segment
// whose box misses a grown box lies >= 2 px from every pixel in it.
//
// The candidates and the output go through the warp's slice of shared
// memory, so every global access is a 16-byte one, lanes on neighbouring
// addresses.  The warp's candidates (6 KB in bf16) are copied in by cp.async
// as the block starts, so their latency overlaps the culling and the
// distance math; each lane then composes its pack's output (208 bytes in
// bf16: 13 16-byte words) in registers, stages it, and the warp stores its
// runs.  A lane's words lie an odd number of words apart in the stage (13 or
// 25 for the candidates, 13 or 27 for the output), so 8 lanes' 16-byte
// accesses meet no bank twice.
//
// The output must be bitwise equal to the PyTorch twin (ops/rasterize.py),
// whose elementwise ops round after every operation: the distance math uses
// the _rn intrinsics, which nvcc never contracts into FMAs, and IEEE division.
// The division is skipped where t clamps anyway: num <= 0 gives t <= 0 and
// num >= len2 gives t >= 1 (IEEE division is monotonic), so t is 0 or 1 there
// whichever way it is computed.  The candidate channels are copied bit for bit
// and 1.0 is exact in bf16, so the render input equals the twin's concat in
// f32 followed by a round-to-nearest-even cast.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSeg = 128;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPack = 8;                  // pixels a thread: consecutive, in one row
constexpr int kTileW = 32 * kPack;        // a block's pixels: 256 across
constexpr int kTileH = kWarps;            // and 8 rows
constexpr int kCand = 12;                 // candidate channels

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A pixel box grown by the radius; meets() is the culling test.
struct Box {
  float x_lo, x_hi, y_lo, y_hi;
  __device__ __forceinline__ bool meets(float4 s) const {
    return fmaxf(s.y, s.w) >= y_lo && fminf(s.y, s.w) <= y_hi && fmaxf(s.x, s.z) >= x_lo &&
           fminf(s.x, s.z) <= x_hi;
  }
};

// The box of pixels x0..x1, y0..y1, grown by r.
__device__ __forceinline__ Box pixel_box(int x0, int x1, int y0, int y1, float r) {
  return {(float)x0 - r, (float)x1 + r, (float)y0 - r, (float)y1 + r};
}

// Where a frame's segments (ax, ay, bx, by) come from.
struct TableSrc {
  const float4* segs;  // [T, S]
  int n_seg;
  __device__ __forceinline__ float4 load(int frame, int s) const {
    return segs[(size_t)frame * n_seg + s];
  }
};

struct LandmarkSrc {
  const float* lm;    // [T, n_lm, 2]
  const float* sh;    // [T, n_sh, 2]
  const int2* pairs;  // [n_seg]: point indices; below n_lm a landmark, else a shoulder point
  int n_lm, n_sh, n_seg;
  __device__ __forceinline__ float2 point(int frame, int i) const {
    const float* p = i < n_lm ? lm + ((size_t)frame * n_lm + i) * 2
                              : sh + ((size_t)frame * n_sh + (i - n_lm)) * 2;
    return make_float2(truncf(p[0]), truncf(p[1]));
  }
  __device__ __forceinline__ float4 load(int frame, int s) const {
    const int2 ab = pairs[s];
    const float2 a = point(frame, ab.x), b = point(frame, ab.y);
    return make_float4(a.x, a.y, b.x, b.y);
  }
};

// What a pack of kPack pixels writes: kWords 32-bit words, contiguous in the
// output at word offset (frame * H * W + p) * kWords / kPack.  A lane's output
// is staged kOutStride 16-byte words apart; a warp's stage holds kStage.
struct PlaneOut {
  static constexpr int kWarpW = 4;  // a warp's packs across (x 8 rows)
  static constexpr int kWords = kPack;  // f32 edges
  static constexpr int kOutStride = kWords / 4 + 1;
  static constexpr int kStage = 32 * kOutStride;
  float* out;
  __device__ __forceinline__ void prefetch(uint4*, int, int, int, int, int) const {}
  __device__ __forceinline__ void compose(uint32_t (&w)[kWords], unsigned mask,
                                          const uint4*, int) const {
#pragma unroll
    for (int j = 0; j < kPack; ++j) w[j] = (mask >> j) & 1u ? 0x3F800000u : 0u;
  }
  __device__ __forceinline__ uint4* at(size_t pixel) const {
    return reinterpret_cast<uint4*>(out + pixel);
  }
};

template <int E, int C>  // E bytes an element (2: bf16, 4: f32); C channels (13 or 1)
struct InputOut {
  static constexpr int kCandC = C - 1;  // candidate channels written: 12 or none
  static constexpr int kWarpW = 32;  // a warp's packs across: one row
  static constexpr int kWords = kPack * C * E / 4;
  static constexpr int kCandWords = kPack * kCandC * E / 4;
  static constexpr int kCandU4 = kCandWords / 4;  // a pack's candidates, 16-byte words
  static constexpr int kCandStride = kCandU4 + 1;
  static constexpr int kOutStride = kWords / 4 | 1;
  static constexpr int kStage = 32 * (kOutStride > kCandStride ? kOutStride : kCandStride);
  static constexpr uint32_t kOne = E == 2 ? 0x3F80u : 0x3F800000u;  // 1.0
  static_assert(C == 1 || C == kCand + 1, "the render input has 13 channels, the edge one");
  void* out;         // [T, H, W, C]
  const void* cand;  // [H, W, 12]; unread when C == 1

  // element h of the pack's 8 x C output, from the pack's candidates c
  __device__ __forceinline__ static uint32_t elem(const uint32_t (&c)[kCandWords ? kCandWords : 1],
                                                  unsigned mask, int h) {
    const int j = h / C, r = h % C;
    if (r == 0) return (mask >> j) & 1u ? kOne : 0u;
    if constexpr (kCandC == 0) {
      return 0u;  // not reached: the edge-only form's every element is an edge
    } else {
      const int i = kCandC * j + r - 1;
      if constexpr (E == 4) return c[i];
      else return (c[i >> 1] >> ((i & 1) * 16)) & 0xFFFFu;
    }
  }

  // The candidates of the warp's packs into its stage, a pack's words
  // kCandStride apart: pack l is row l / kWarpW, column l % kWarpW of the
  // warp's region (one row), whose first pixel is p0; rows and packs bound it.
  // The edge-only form reads no candidates.
  __device__ __forceinline__ void prefetch(uint4* stage, int p0, int width, int rows, int packs,
                                           int lane) const {
    if constexpr (kCandU4 > 0) {
      const uint4* src = reinterpret_cast<const uint4*>(cand);
      for (int c = lane; c < 32 * kCandU4; c += 32) {
        const int l = c / kCandU4, r = l / kWarpW, col = l % kWarpW;
        if (r < rows && col < packs)
          cp_async16(stage + c + l,
                     src + (size_t)((p0 + r * width) / kPack + col) * kCandU4 + (c - l * kCandU4));
      }
    }
  }

  __device__ __forceinline__ void compose(uint32_t (&w)[kWords], unsigned mask,
                                          const uint4* stage, int lane) const {
    uint32_t c[kCandWords ? kCandWords : 1] = {};
#pragma unroll
    for (int i = 0; i < kCandU4; ++i) {
      const uint4 v = stage[lane * kCandStride + i];
      c[4 * i] = v.x, c[4 * i + 1] = v.y, c[4 * i + 2] = v.z, c[4 * i + 3] = v.w;
    }
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      if constexpr (E == 4) w[k] = elem(c, mask, k);
      else w[k] = elem(c, mask, 2 * k) | (elem(c, mask, 2 * k + 1) << 16);
    }
  }
  __device__ __forceinline__ uint4* at(size_t pixel) const {
    return reinterpret_cast<uint4*>(static_cast<char*>(out) + pixel * C * E);
  }
};

// Bit j set where pixel (x + j, y) lies within the radius of a segment of the
// list live[idx[0..n)], in the twin's arithmetic.
__device__ __forceinline__ unsigned edge_mask(const float4* live, const uint8_t* idx, int n,
                                              int x, int y, float radius) {
  const float r2 = __fmul_rn(radius, radius);
  const float ys = (float)y;
  const Box box{(float)x - radius, (float)(x + kPack - 1) + radius, ys - radius, ys + radius};
  unsigned mask = 0;
  for (int i = 0; i < n && mask != (1u << kPack) - 1; ++i) {
    const float4 s = live[idx[i]];
    if (!box.meets(s)) continue;
    const float dx = __fsub_rn(s.z, s.x);
    const float dy = __fsub_rn(s.w, s.y);
    const float len2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
    const float den = fmaxf(len2, 1e-12f);
    const float py = __fsub_rn(ys, s.y);
    const float pdy = __fmul_rn(py, dy);
#pragma unroll
    for (int j = 0; j < kPack; ++j) {
      if ((mask >> j) & 1u) continue;
      const float px = __fsub_rn((float)(x + j), s.x);
      const float num = __fadd_rn(__fmul_rn(px, dx), pdy);
      float t = 0.0f;
      if (len2 > 0.0f) t = num <= 0.0f ? 0.0f : num >= den ? 1.0f : __fdiv_rn(num, den);
      t = fminf(fmaxf(t, 0.0f), 1.0f);
      const float ex = __fsub_rn(px, __fmul_rn(t, dx));
      const float ey = __fsub_rn(py, __fmul_rn(t, dy));
      if (__fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)) <= r2) mask |= 1u << j;
    }
  }
  return mask;
}

// One block: kTileW x kTileH pixels of frame blockIdx.z.  A warp takes
// Out::kWarpW packs across and 32 / Out::kWarpW rows of them, lane l the pack
// at column l % kWarpW, row l / kWarpW.  Needs width % kPack == 0, so a pack
// lies in one row and its output starts on a 16-byte boundary.
template <class Src, class Out>
__global__ void __launch_bounds__(kThreads)
rasterize_kernel(Src src, Out out, int height, int width, float radius) {
  constexpr int kWarpW = Out::kWarpW, kWarpH = 32 / kWarpW, kCols = 32 / kWarpW;
  extern __shared__ uint4 stage[];  // per warp: Out::kStage 16-byte words
  __shared__ float4 live[kMaxSeg];
  __shared__ uint8_t warp_live[kWarps][kMaxSeg];
  __shared__ int n_live;

  const int frame = blockIdx.z;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // The warp's region: from (xw, yw), `packs` packs across and `rows` rows
  // (no packs past the frame's edges); its candidates start on their way now.
  const int xw = x0 + warp % kCols * kWarpW * kPack, yw = y0 + warp / kCols * kWarpH;
  const int rows = min(kWarpH, height - yw);
  const int packs = xw < width && rows > 0 ? min(kWarpW, (width - xw) / kPack) : 0;
  uint4* my_stage = stage + warp * Out::kStage;
  if (packs) out.prefetch(my_stage, yw * width + xw, width, rows, packs, lane);
  if (threadIdx.x == 0) n_live = 0;
  __syncthreads();

  // The frame's segments, culled against the block's box (the TPU kernel's
  // per-tile lax.cond).
  const Box tile = pixel_box(x0, min(x0 + kTileW, width) - 1, y0,
                             min(y0 + kTileH, height) - 1, radius);
  for (int s = threadIdx.x; s < src.n_seg; s += kThreads) {
    const float4 seg = src.load(frame, s);
    if (tile.meets(seg)) live[atomicAdd(&n_live, 1)] = seg;
  }
  __syncthreads();
  const int n_block = n_live;

  // The block's list culled against the warp's region (a warp wholly past
  // the frame's edges leaves; no block barrier follows).
  if (!packs) return;
  const Box wbox = pixel_box(xw, xw + packs * kPack - 1, yw, yw + rows - 1, radius);
  int n_warp = 0;
  for (int base = 0; base < n_block; base += 32) {
    const int i = base + lane;
    const bool hit = i < n_block && wbox.meets(live[i]);
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, hit);
    if (hit) warp_live[warp][n_warp + __popc(ballot & ((1u << lane) - 1))] = (uint8_t)i;
    n_warp += __popc(ballot);
  }
  __syncwarp();

  constexpr int kU4 = Out::kWords / 4;  // 16-byte words a pack
  const int x = xw + lane % kWarpW * kPack, y = yw + lane / kWarpW;
  const bool valid = lane % kWarpW < packs && lane / kWarpW < rows;
  unsigned mask = 0;
  if (valid) mask = edge_mask(live, warp_live[warp], n_warp, x, y, radius);
  cp_async_wait_all();
  __syncwarp();
  uint32_t w[Out::kWords];
  if (valid) out.compose(w, mask, my_stage, lane);
  __syncwarp();  // every lane has read its candidates before the stage is reused
  if (valid) {
#pragma unroll
    for (int k = 0; k < kU4; ++k)
      my_stage[lane * Out::kOutStride + k] =
          make_uint4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);
  }
  __syncwarp();
  // Pack l's words go to its row's run: consecutive lanes, consecutive words.
  const size_t first = ((size_t)frame * height + yw) * width + xw;
  for (int i = lane; i < 32 * kU4; i += 32) {
    const int l = i / kU4, k = i - l * kU4, r = l / kWarpW, col = l % kWarpW;
    if (r < rows && col < packs)
      out.at(first + (size_t)r * width + col * kPack)[k] = my_stage[l * Out::kOutStride + k];
  }
}

template <class Src, class Out>
int launch(const Src& src, const Out& out, int n_frames, int height, int width, float radius,
           void* stream) {
  if (n_frames < 0 || n_frames > 65535 || height < 0 || height > 65535 * kTileH || width < 0 ||
      width % kPack != 0 || src.n_seg < 0 || src.n_seg > kMaxSeg ||
      (long long)height * width > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  if (n_frames == 0 || height == 0 || width == 0) return (int)cudaSuccess;
  const int smem = kWarps * Out::kStage * 16;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rasterize_kernel<Src, Out>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((width + kTileW - 1) / kTileW, (height + kTileH - 1) / kTileH, n_frames);
  rasterize_kernel<Src, Out><<<grid, kThreads, smem, (cudaStream_t)stream>>>(src, out, height,
                                                                           width, radius);
  return (int)cudaGetLastError();
}

}  // namespace

// segs: [T, S, 4] f32 (ax, ay, bx, by), S <= 128; out: [T, H, W] f32; W % 8 == 0.
extern "C" int lsp_rasterize(const float* segs, int n_frames, int n_seg, float* out,
                             int height, int width, float radius, void* stream) {
  return launch(TableSrc{reinterpret_cast<const float4*>(segs), n_seg}, PlaneOut{out},
                n_frames, height, width, radius, stream);
}

// lm: [T, n_lm, 2] f32; sh: [T, n_sh, 2] f32; pairs: [n_seg, 2] int32 point
// indices (< n_lm a landmark, else shoulder point index - n_lm), n_seg <= 128;
// channels 13: cand [H, W, 12] of elem_bytes (2: bf16, 4: f32), out
// [T, H, W, 13] of the same type; channels 1 (the edge-only form, split_cand's
// input): cand unread (may be null), out [T, H, W, 1] of elem_bytes; W % 8 == 0.
extern "C" int lsp_render_input(const float* lm, int n_lm, const float* sh, int n_sh,
                                const int* pairs, int n_seg, const void* cand, int elem_bytes,
                                int channels, void* out, int n_frames, int height, int width,
                                float radius, void* stream) {
  const LandmarkSrc src{lm, sh, reinterpret_cast<const int2*>(pairs), n_lm, n_sh, n_seg};
  if (channels == kCand + 1 && elem_bytes == 2)
    return launch(src, InputOut<2, kCand + 1>{out, cand}, n_frames, height, width, radius, stream);
  if (channels == kCand + 1 && elem_bytes == 4)
    return launch(src, InputOut<4, kCand + 1>{out, cand}, n_frames, height, width, radius, stream);
  if (channels == 1 && elem_bytes == 2)
    return launch(src, InputOut<2, 1>{out, cand}, n_frames, height, width, radius, stream);
  if (channels == 1 && elem_bytes == 4)
    return launch(src, InputOut<4, 1>{out, cand}, n_frames, height, width, radius, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* lsp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
