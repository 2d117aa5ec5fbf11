// K1: landmark -> edge-map rasteriser.
//
// Replaces the Pallas TPU kernel livespeechportraits_tpu/ops/rasterize_pallas.py
// (_kernel, called from rasterize_segments_pallas).  A pixel is 1 where its
// squared distance to any segment of its frame is <= radius^2, else 0.
//
// What bounds it on the H100: the writes of the [T, H, W] f32 output (8 MB for
// an 8-frame batch at 512^2, about 3 us at 3.35 TB/s) once the per-pixel
// distance math is kept to the few segments that can reach the pixel.  The
// TPU kernel culls per 128x512 tile with a scalar branch; a 32x8 pixel block
// culls far tighter, so most blocks test only a handful of segments.
//
// Design: one thread per pixel, a 32x8 block.  Each block loads its frame's
// segment table (<= 128 x 4 floats) into shared memory once, culls it against
// its own pixel box grown by the radius into a shared list, and folds the
// surviving segments with max.  The fold is a max over {0, 1}, so the order of
// the list does not change the result.  The culling is exact for the integer
// endpoints the pipeline draws: a segment whose box misses the grown block box
// lies >= 2 px from every pixel of the block.
//
// The output must be bitwise equal to the PyTorch twin (ops/rasterize.py),
// whose elementwise ops round after every operation: the distance math uses
// the _rn intrinsics, which nvcc never contracts into FMAs, and IEEE division.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxSeg = 128;
constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

__global__ void __launch_bounds__(kBlockX * kBlockY)
rasterize_kernel(const float* __restrict__ segs, int n_seg, float* __restrict__ out,
                 int height, int width, float radius) {
  __shared__ float4 table[kMaxSeg];
  __shared__ int n_live;

  const int frame = blockIdx.z;
  const int tid = threadIdx.y * kBlockX + threadIdx.x;
  const int x0 = blockIdx.x * kBlockX;
  const int y0 = blockIdx.y * kBlockY;
  if (tid == 0) n_live = 0;
  __syncthreads();

  // Cull: keep the segments whose bounding box, grown by the radius, meets
  // this block's pixel box (the TPU kernel's per-tile lax.cond).
  const float x_lo = (float)x0 - radius, x_hi = (float)(x0 + kBlockX - 1) + radius;
  const float y_lo = (float)y0 - radius, y_hi = (float)(y0 + kBlockY - 1) + radius;
  for (int s = tid; s < n_seg; s += kBlockX * kBlockY) {
    const float* p = segs + ((size_t)frame * n_seg + s) * 4;
    const float4 seg = make_float4(p[0], p[1], p[2], p[3]);
    const bool hit = fmaxf(seg.y, seg.w) >= y_lo && fminf(seg.y, seg.w) <= y_hi &&
                     fmaxf(seg.x, seg.z) >= x_lo && fminf(seg.x, seg.z) <= x_hi;
    if (hit) {
      const int slot = atomicAdd(&n_live, 1);
      table[slot] = seg;
    }
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  if (x >= width || y >= height) return;
  const float xs = (float)x, ys = (float)y;
  const float r2 = __fmul_rn(radius, radius);
  float acc = 0.0f;
  const int n = n_live;
  for (int i = 0; i < n; ++i) {
    const float4 seg = table[i];
    const float dx = __fsub_rn(seg.z, seg.x);
    const float dy = __fsub_rn(seg.w, seg.y);
    const float len2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
    const float px = __fsub_rn(xs, seg.x);
    const float py = __fsub_rn(ys, seg.y);
    float t = 0.0f;
    if (len2 > 0.0f) {
      t = __fdiv_rn(__fadd_rn(__fmul_rn(px, dx), __fmul_rn(py, dy)), fmaxf(len2, 1e-12f));
    }
    t = fminf(fmaxf(t, 0.0f), 1.0f);
    const float ex = __fsub_rn(px, __fmul_rn(t, dx));
    const float ey = __fsub_rn(py, __fmul_rn(t, dy));
    const float d2 = __fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey));
    if (d2 <= r2) {
      acc = 1.0f;
      break;
    }
  }
  out[((size_t)frame * height + y) * width + x] = acc;
}

}  // namespace

// segs: [T, S, 4] f32 (ax, ay, bx, by), S <= 128; out: [T, H, W] f32.
extern "C" int lsp_rasterize(const float* segs, int n_frames, int n_seg, float* out,
                             int height, int width, float radius, void* stream) {
  if (n_seg < 0 || n_seg > kMaxSeg) return (int)cudaErrorInvalidValue;
  if (n_frames == 0 || height == 0 || width == 0) return (int)cudaSuccess;
  dim3 block(kBlockX, kBlockY);
  dim3 grid((width + kBlockX - 1) / kBlockX, (height + kBlockY - 1) / kBlockY, n_frames);
  rasterize_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(segs, n_seg, out, height,
                                                              width, radius);
  return (int)cudaGetLastError();
}

extern "C" const char* lsp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
