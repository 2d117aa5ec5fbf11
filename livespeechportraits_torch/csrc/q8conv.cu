// K4: int8 3x3 convolution, s8 x s8 -> s32, as an implicit GEMM.
//
// Replaces the int8 lax.conv of livespeechportraits_tpu/models/nn_core.py
// _conv2d_q8 (conv_general_dilated with preferred_element_type=int32), which
// XLA runs on the TPU's int8 MXU path.  It is not a Pallas kernel, and PyTorch
// has no int8 convolution on CUDA.  Every interior conv of the int8 renderer
// runs here: 44 of them per 'normal' ResUNet forward, 256^2 down to 2^2,
// 64 to 1024 input and 64 to 512 output channels.
//
// GEMM view, with activations and weights both channels-last (NHWC / OHWI):
//     out[m, n] = sum_k A[m, k] * Wt[n, k],   m = (b, oy, ox), n = cout,
//     k = (kh*3 + kw) * Cin + ci,            A[m, k] = x[b, oy*s-1+kh, ox*s-1+kw, ci]
// with zeros outside the image (padding 1).  The int32 sums are exact
// (|acc| <= 127^2 * 9 * Cin < 2^31), so the result equals the plain twin's
// float64 conv bit for bit, whatever the summation order.
//
// What bounds it on the H100: at the outer stages (B=16, 256^2, 64 channels)
// a conv is ~77 G int8 ops against ~200 MB of traffic (the int8 input, read
// once plus halo re-reads from L2, and the bf16 output): 0.04 ms of the
// 1979 TOPS int8 peak and 0.06 ms of the 3.35 TB/s bandwidth, so both limits
// are close and a simple kernel is bound by how well it feeds the tensor
// cores.  The innermost stages (2^2, 512 channels) are a few blocks with a
// long K loop: latency, not throughput.
//
// Design (a first, simple kernel): a 128 (pixels) x 64 (channels) output
// tile per block of 4 warps, each warp 64 x 32 as 4 x 4 mma.sync m16n8k32 s8
// tiles with int32 accumulators in registers.  The K loop walks the 9 taps
// times 32-channel slices; each slice of A (im2col rows, gathered on the fly
// with the padding zero-filled by cp.async's src-size) and of the weights is
// copied to shared memory with 16-byte cp.async, double buffered.  Shared rows
// are 48 bytes apart so the 32-bit fragment loads hit 32 distinct banks.
// Needs Cin % 16 == 0 (every ResUNet width is a multiple of 64).
//
// Epilogue, optionally fused: int32 -> float (round to nearest) -> out type,
// then * scale[n] and + bias[n], each rounded to the out type as PyTorch's
// elementwise ops round them (bf16 ops compute in float and round once), so
// the fused output equals the twin's acc.to(dt) * scale + b bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kRow = 48;  // bytes between shared rows: 32 data + 16 pad
constexpr int kThreads = 128;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // src-size 0 fills the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// kind 0: int32 out; 1: float out; 2: bf16 out (scale, bias in the out type).
template <int kKind>
__device__ __forceinline__ void store(void* out, size_t idx, int acc, const void* scale,
                                      const void* bias, int n) {
  if constexpr (kKind == 0) {
    static_cast<int*>(out)[idx] = acc;
  } else if constexpr (kKind == 1) {
    float y = __fmul_rn((float)acc, static_cast<const float*>(scale)[n]);
    if (bias != nullptr) y = __fadd_rn(y, static_cast<const float*>(bias)[n]);
    static_cast<float*>(out)[idx] = y;
  } else {
    const float s = __bfloat162float(static_cast<const __nv_bfloat16*>(scale)[n]);
    const float t = __bfloat162float(__float2bfloat16_rn((float)acc));
    __nv_bfloat16 y = __float2bfloat16_rn(__fmul_rn(t, s));
    if (bias != nullptr) {
      const float b = __bfloat162float(static_cast<const __nv_bfloat16*>(bias)[n]);
      y = __float2bfloat16_rn(__fadd_rn(__bfloat162float(y), b));
    }
    static_cast<__nv_bfloat16*>(out)[idx] = y;
  }
}

template <int kKind>
__global__ void __launch_bounds__(kThreads)
q8conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w, int H, int W,
              int Cin, int Cout, int stride, int pad, int Ho, int Wo, int M, void* out,
              const void* scale, const void* bias) {
  __shared__ __align__(16) int8_t As[2][kBM * kRow];
  __shared__ __align__(16) int8_t Bs[2][kBN * kRow];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int warp_m = warp & 1, warp_n = warp >> 1;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;

  // The two A rows (pixels) and 16-byte halves this thread copies.
  int a_b[2], a_iy[2], a_ix[2];
  bool a_ok[2];
  for (int j = 0; j < 2; ++j) {
    const int c = tid + j * kThreads;
    const int p = m0 + (c >> 1);
    a_ok[j] = p < M;
    const int pp = a_ok[j] ? p : 0;
    const int ox = pp % Wo, t = pp / Wo;
    a_b[j] = t / Ho;
    a_iy[j] = (t % Ho) * stride - pad;
    a_ix[j] = ox * stride - pad;
  }
  const int a_half = tid & 1;  // both of this thread's chunks share the half
  const int b_n = n0 + (tid >> 1), b_half = tid & 1;

  const int n_ci = (Cin + kBK - 1) / kBK;
  const int n_iter = 9 * n_ci;

  auto load = [&](int it, int buf) {
    const int tap = it / n_ci;
    const int ci = (it - tap * n_ci) * kBK;
    const int kh = tap / 3, kw = tap - kh * 3;
    for (int j = 0; j < 2; ++j) {
      const int c = tid + j * kThreads;
      const int iy = a_iy[j] + kh, ix = a_ix[j] + kw;
      const int cc = ci + a_half * 16;
      const bool ok = a_ok[j] && iy >= 0 && iy < H && ix >= 0 && ix < W && cc < Cin;
      const int8_t* src = ok ? x + (((size_t)a_b[j] * H + iy) * W + ix) * Cin + cc : x;
      cp_async16(&As[buf][(c >> 1) * kRow + a_half * 16], src, ok);
    }
    const int cc = ci + b_half * 16;
    const bool ok = b_n < Cout && cc < Cin;
    const int8_t* src = ok ? w + ((size_t)b_n * 9 + tap) * Cin + cc : w;
    cp_async16(&Bs[buf][(tid >> 1) * kRow + b_half * 16], src, ok);
  };

  int acc[4][4][4];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j)
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0;

  load(0, 0);
  cp_async_commit();
  for (int it = 0; it < n_iter; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_iter) {
      load(it + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const int8_t* a_s = As[buf] + (warp_m * 64) * kRow;
    const int8_t* b_s = Bs[buf] + (warp_n * 32) * kRow;
    unsigned af[4][4], bf[4][2];
    for (int mi = 0; mi < 4; ++mi) {
      const int8_t* r0 = a_s + (mi * 16 + g) * kRow;
      const int8_t* r1 = r0 + 8 * kRow;
      af[mi][0] = *reinterpret_cast<const unsigned*>(r0 + tig * 4);
      af[mi][1] = *reinterpret_cast<const unsigned*>(r1 + tig * 4);
      af[mi][2] = *reinterpret_cast<const unsigned*>(r0 + 16 + tig * 4);
      af[mi][3] = *reinterpret_cast<const unsigned*>(r1 + 16 + tig * 4);
    }
    for (int ni = 0; ni < 4; ++ni) {
      const int8_t* r = b_s + (ni * 8 + g) * kRow;
      bf[ni][0] = *reinterpret_cast<const unsigned*>(r + tig * 4);
      bf[ni][1] = *reinterpret_cast<const unsigned*>(r + 16 + tig * 4);
    }
    for (int mi = 0; mi < 4; ++mi)
      for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    __syncthreads();
  }

  for (int mi = 0; mi < 4; ++mi) {
    const int r0 = m0 + warp_m * 64 + mi * 16 + g;
    for (int ni = 0; ni < 4; ++ni) {
      const int c0 = n0 + warp_n * 32 + ni * 8 + tig * 2;
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + (e >> 1) * 8, c = c0 + (e & 1);
        if (r < M && c < Cout)
          store<kKind>(out, (size_t)r * Cout + c, acc[mi][ni][e], scale, bias, c);
      }
    }
  }
}

}  // namespace

// x: [B, H, W, Cin] int8; w: [Cout, 3, 3, Cin] int8; out: [B, Ho, Wo, Cout] of
// out_kind (0 int32, 1 float, 2 bf16).  scale [Cout] (and bias [Cout] or null)
// in the out type, unused for int32.
extern "C" int lsp_q8conv(const int8_t* x, const int8_t* w, int B, int H, int W, int Cin,
                          int Cout, int stride, int pad, int Ho, int Wo, void* out,
                          int out_kind, const void* scale, const void* bias, void* stream) {
  if (Cin % 16 != 0 || Cin <= 0 || Cout <= 0 || stride < 1 || out_kind < 0 || out_kind > 2)
    return (int)cudaErrorInvalidValue;
  const long long M = (long long)B * Ho * Wo;
  if (M == 0) return (int)cudaSuccess;
  if (M > (1LL << 30)) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((M + kBM - 1) / kBM), (Cout + kBN - 1) / kBN);
  cudaStream_t s = (cudaStream_t)stream;
  if (out_kind == 0)
    q8conv_kernel<0><<<grid, kThreads, 0, s>>>(x, w, H, W, Cin, Cout, stride, pad, Ho, Wo,
                                               (int)M, out, scale, bias);
  else if (out_kind == 1)
    q8conv_kernel<1><<<grid, kThreads, 0, s>>>(x, w, H, W, Cin, Cout, stride, pad, Ho, Wo,
                                               (int)M, out, scale, bias);
  else
    q8conv_kernel<2><<<grid, kThreads, 0, s>>>(x, w, H, W, Cin, Cout, stride, pad, Ho, Wo,
                                               (int)M, out, scale, bias);
  return (int)cudaGetLastError();
}
