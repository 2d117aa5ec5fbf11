// K4: the int8 3x3 (and 4x4) convolution of the int8 renderer and of
// quantization-aware training, with the activation quantize folded in, on
// Hopper's wgmma.
//
// Replaces _conv2d_q8 of livespeechportraits_tpu/models/nn_core.py: the
// activation quantize (x_q = clip(round(x * r), -127, 127), r = 1/s_x in the
// activation dtype), the int8 lax.conv with int32 sums (XLA's int8 MXU path on
// the TPU; not a Pallas kernel) and the rescale acc.to(dt) * scale + b.  Every
// interior conv of the int8 renderer runs here: 44 per 'normal' ResUNet
// forward, 256^2 down to 2^2, 64 to 1024 input and 64 to 512 output channels.
// Quantization-aware training runs the same 3x3 convs in every training
// forward (_conv2d_fakequant_int8 of the JAX package), and the 4x4 interior
// convs of the multiscale discriminator (qat_discriminator: padding 2,
// stride 2 and 1, 64 to 256 input channels, odd output sizes such as 129^2
// and 66^2) in f32.  PyTorch has no int8 convolution on CUDA.
//
// GEMM view, activations and weights both channels-last (NHWC / OHWI):
//     out[m, n] = sum_k A[m, k] * Wt[n, k],   m = (b, oy, ox), n = cout,
//     k = (kh*KS + kw) * Cin + ci,           A[m, k] = q(x[b, oy*s-p+kh, ox*s-p+kw, ci])
// with q(0) = 0 outside the image and KS the kernel size (3 or 4).  The int32
// sums are exact (|acc| <= 127^2 * 16 * Cin < 2^31 for Cin <= 8,000), so they
// equal the plain twin's float64 conv in any summation order, split-K
// included.
//
// What bounds it on the H100: a 'normal' forward at B=16 is ~2.6 int8 TOP and
// each conv reads its bf16 input once and writes its bf16 output once; the
// bounds are 0.01-0.2 ms a conv, 1.59 ms a forward, set by bytes at the 256^2
// and 128^2 stages and by operations at the up convs (PERF.md).  The kernel
// it replaces ran mma.sync at 6-11 % of the int8 peak behind four elementwise
// quantize passes over the activation.  Quantizing inside the kernel moves
// that work to the SM's ALUs, so the design's aim is to quantize each input
// value as few times as it can, and to keep the 9x reuse of an input pixel
// by the 3x3 taps out of L2.
//
// Design, shared by both kernels:
// - One block computes 128 output pixels x BN output channels (BN = 64 when
//   Cout <= 64, else 128): two consumer warpgroups of 64 rows each issue
//   wgmma m64nBNk32 s8 with int32 accumulators in registers; one producer
//   warp feeds them through mbarrier rings.
// - Weights, [Cout, KS*KS*Cin] int8, arrive by TMA, one (tap, 64-channel
//   slice) per stage, with the 64-byte swizzle that the wgmma B descriptor
//   reads.
// - The A operand comes from registers: consumers build wgmma's A fragment
//   from int8 values in shared memory.  x * r is one float multiply rounded
//   once to the activation dtype (__fmul_rn / bf16x2 multiply, no
//   contraction), rounded half to even and clamped to +-127.
// - Each stage's wgmmas complete before the next fragments are written:
//   ptxas may give the next fragments the registers an in-flight wgmma
//   still reads (on the H100 a wait_group 1 pipeline corrupted outputs at
//   16x64x256^2).  The other warpgroup, and
//   a second block on the SM, fill the tensor cores meanwhile.
// - Epilogue: int32 -> float (round to nearest) -> dt, * scale[n], + bias[n],
//   each rounded to dt as PyTorch's elementwise ops round them, staged in
//   shared memory and stored 16 bytes at a time along Cout.
// - Small shapes (fewer 128 x BN tiles than SMs): split-K into an int32
//   workspace, then a second pass sums the splits (exactly) and applies the
//   epilogue.
//
// The halo kernel (stride 1, padding 1, W % 16 == 0, H % 8 == 0: 25 of a
// 'normal' forward's 44 convs, every residual and up conv from 256^2 to 16^2):
// a block's 128 pixels are an 8 x 16 patch of one image.  Per 64-channel
// slice one 4-D TMA box brings its 10 x 18 input halo (the padding is the
// box's out-of-bounds zero fill), the consumers quantize it once into an
// int8 copy, and all 9 taps read their A fragments from that copy at a
// shifted row.  Each input value is fetched from L2 and quantized ~1.4
// times instead of 9.  What bounds it now (PERF.md): at the deep convs it
// runs at ~40 % of the int8 peak, held by each warpgroup's wait for its own
// wgmmas between taps and by shared-memory traffic (the B reads, the
// fragment loads, the quantize, the TMA writes); deeper rings, 256-pixel
// tiles and A from shared memory with two taps in flight each left it
// about where it was on the H100.
//
// The gather kernel (stride 2, maps narrower than 16 or shorter than 8,
// every 2x2 and 4x4 conv, and every conv that reads its source through a
// row map; the kernel size is a launch parameter):
// per (tap, slice) stage the producer warp gathers the 128 rows of A with
// 16-byte cp.async (src-size 0 writes the zero padding) and
// cp.async.mbarrier.arrive signals the stage; the consumers quantize the
// stage in registers.
// Needs Cin % 16 == 0 (every ResUNet width is a multiple of 64).
//
// The renderer's inference rewrites (nn_core.py:471-800 of the JAX package:
// the subpixel, dilated and split up convs, each an int8 lax.conv there) run
// on the gather kernel through four launch parameters, all in the producer's
// row map, so the consumers and the int32 sums are those of every other conv:
// - a 2x2 kernel with its own top and left padding: phase (a, b) of the
//   four-phase subpixel conv, padding (1 - a, a) by (1 - b, b);
// - a source read through a nearest 2x upsample (row iy reads iy >> 1) or an
//   input dilation of 2 (row iy reads iy / 2 when iy is even, else zero):
//   the upsampled or dilated map is never written;
// - a second source: channels below n_a come from x, the rest from x2, both
//   quantized with the one r, one int32 sum over both (the split up conv over
//   the U-Net's (skip, submodule) pair without the concat); n_a % 64 == 0, so
//   no 64-channel slice straddles the two;
// - an output map: output pixel (b, oy, ox) of the launch lands at (b,
//   step * oy + dy, step * ox + dx) of an [OH, OW] map, so the four phase
//   launches write the interleaved map directly.

#include <cuda.h>  // CUtensorMap; the encoder is looked up in the driver at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBM = 128;             // output pixels per block
constexpr int kBK = 64;              // input channels per K slice
constexpr int kConsumers = 256;      // two warpgroups
constexpr int kThreads = kConsumers + 32;  // plus the producer warp

// The halo kernel's output patch and its input halo
constexpr int kHaloTW = 16, kHaloTR = 8;                 // columns x rows: kBM pixels
constexpr int kHaloPix = (kHaloTR + 2) * (kHaloTW + 2);  // 180 input pixels
constexpr int kQRow = kBK + 16;  // 80-byte int8 rows: the fragment loads hit 32 banks
constexpr int kHaloStages = 4;   // the weight ring

template <typename T>
struct InType;
template <>
struct InType<int8_t> {
  static constexpr int kPad = 16, kStages = 4;  // 80-byte rows: 4-byte reads hit 32 banks
};
template <>
struct InType<__nv_bfloat16> {
  static constexpr int kPad = 32, kStages = 4;  // 160-byte rows: 8-byte reads conflict-free
};
template <>
struct InType<float> {
  static constexpr int kPad = 64, kStages = 3;  // 320-byte rows: 16-byte reads conflict-free
};

// Row pitch of the staged fused-epilogue tile
template <typename TIn, int BN>
__host__ __device__ constexpr int out_row() {
  return BN * (int)sizeof(TIn) + (sizeof(TIn) == 2 ? 16 : 32);
}

// Gather kernel's dynamic shared memory: the B ring (1024-aligned for the
// swizzle), the A ring (reused to stage the fused epilogue), the mbarriers.
template <typename TIn, int BN>
struct Smem {
  static constexpr int kStages = InType<TIn>::kStages;
  static constexpr int kBBytes = BN * kBK;
  static constexpr int kARow = kBK * (int)sizeof(TIn) + InType<TIn>::kPad;
  static constexpr int kABytes = kBM * kARow;
  static constexpr int kAOff = kStages * kBBytes;
  static constexpr int kBarOff = kAOff + kStages * kABytes;
  static constexpr int kBytes = kBarOff + 16 * kStages + 1024;  // + alignment slack
  static_assert(kBM * out_row<TIn, BN>() <= kStages * kABytes, "the epilogue tile must fit");
};

// Halo kernel's: the B ring, two halo buffers as TMA writes them (dense
// [10][18][64] of TIn; reused to stage the fused epilogue), the int8 halo,
// the mbarriers.
template <typename TIn, int BN>
struct HaloSmem {
  static constexpr int kBBytes = BN * kBK;
  static constexpr int kRawBytes = kHaloPix * kBK * (int)sizeof(TIn);
  static constexpr int kRawOff = kHaloStages * kBBytes;
  static constexpr int kQOff = kRawOff + 2 * kRawBytes;
  static constexpr int kBarOff = kQOff + kHaloPix * kQRow;
  static constexpr int kBytes = kBarOff + 16 * kHaloStages + 32 + 1024;
  static_assert(kBM * out_row<TIn, BN>() <= 2 * kRawBytes, "the epilogue tile must fit");
};

// How a conv's input row (or column) v reads its source of n rows
enum SrcMode { kSrcPlain = 0, kSrcUp2 = 1, kSrcDil2 = 2 };

// Where output pixel m = (b, oy, ox) of an [Ho, Wo] launch is stored: at
// (b, step * oy + dy, step * ox + dx) of an [OH, OW] map (step 1: at m).
struct OutMap {
  int Ho, Wo, step, dy, dx, OH, OW;
  __host__ __device__ __forceinline__ size_t operator()(int m) const {
    if (step == 1) return (size_t)m;
    const int ox = m % Wo, t = m / Wo, oy = t % Ho, b = t / Ho;
    return ((size_t)b * OH + step * oy + dy) * OW + step * ox + dx;
  }
};

struct Params {
  const void* x;      // [B, H, W, Cin] of TIn (forms: [B, H, W, n_a])
  void* out;          // [M, Cout] of the out type (forms: through om), or int32 [splits, M, Cout]
  const void* r;      // [] reciprocal activation scale, TIn (fused only)
  const void* scale;  // [Cout] TIn (fused only)
  const void* bias;   // [Cout] TIn or null
  int H, W, Cin, Cout, ks, stride, pad, Ho, Wo, M;  // H, W: the source's; pad (forms): the top's
  int n_ci, n_iter, iters_per_split;  // K iterations: ks * ks taps x n_ci slices
};

// The rewrite forms' parameters, an argument of the gather kernel's kForms
// instance only, so that every other instance keeps Params as it was.
struct Forms {
  const void* x2;  // [B, H, W, Cin - n_a] of TIn (the input's channels n_a..), or null
  int pad_l, src, n_a;  // left padding, SrcMode, x's channels
  OutMap om;
};

// Source row s of conv input row v under the SrcMode; false where the input
// is zero (the padding, or an odd row of the dilated input).
__device__ __forceinline__ bool src_coord(int v, int n, int mode, int& s) {
  s = mode == kSrcPlain ? v : v >> 1;
  const bool in = v >= 0 && s < n;
  return mode == kSrcDil2 ? in && (v & 1) == 0 : in;
}

// The output pixel m of tile row rr: base + (rr / tw) * w + rr % tw (the
// gather kernel's tiles are 128 consecutive pixels: tw = kBM, w = 0).
struct RowMap {
  int base, tw, w;
  __device__ __forceinline__ int operator()(int rr) const { return base + (rr / tw) * w + rr % tw; }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// The barrier's pending count takes one arrival when this thread's earlier
// cp.async copies have landed (.noinc: counted in the barrier's init count).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;  // src-size 0 fills the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// A box whose start may be negative: elements outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// wgmma descriptor of a K-major B tile: 64-byte rows (32 bytes of K per
// instruction), 64-byte swizzle, 8-row groups 512 bytes apart.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(512 >> 4) << 32) |
         ((uint64_t)2 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// D[64 x 64] += A[64 x 32] (s8, registers) * B[64 x 32]^T (s8, shared memory)
__device__ __forceinline__ void wgmma_s8(int (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D[64 x 128] += A[64 x 32] (s8, registers) * B[128 x 32]^T (s8, shared memory)
__device__ __forceinline__ void wgmma_s8(int (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// The quantize, without the quarter-rate conversion instructions (F2F,
// FRND, F2I), which bound the first version of this kernel: x * r is a
// bf16x2 multiply (one rounding of the exact product, as float-then-bf16
// rounds it) or an f32 multiply; the clamp to +-127 comes first (the same
// result as after the rounding, the bounds being integers); then adding
// 1.5 * 2^23 rounds to an integer, half to even, and leaves its two's
// complement in the float's low byte, which byte permutes pack.
constexpr float kRoundMagic = 12582912.0f;

__device__ __forceinline__ uint32_t pack_q4(float a, float b, float c, float d) {
  const uint32_t ab = __byte_perm(__float_as_uint(__fadd_rn(a, kRoundMagic)),
                                  __float_as_uint(__fadd_rn(b, kRoundMagic)), 0x0040);
  const uint32_t cd = __byte_perm(__float_as_uint(__fadd_rn(c, kRoundMagic)),
                                  __float_as_uint(__fadd_rn(d, kRoundMagic)), 0x0040);
  return __byte_perm(ab, cd, 0x5410);
}

__device__ __forceinline__ float clamp127(float v) { return fminf(fmaxf(v, -127.0f), 127.0f); }

// The reciprocal scale in the form each input type multiplies by.
template <typename TIn>
struct Recip {
  float r;
};
template <>
struct Recip<__nv_bfloat16> {
  __nv_bfloat162 r;
};

template <typename TIn>
__device__ __forceinline__ Recip<TIn> load_recip(const void* r) {
  Recip<TIn> q{};  // unused for int8 input
  if constexpr (std::is_same<TIn, float>::value) q.r = *static_cast<const float*>(r);
  if constexpr (std::is_same<TIn, __nv_bfloat16>::value)
    q.r = __bfloat162bfloat162(*static_cast<const __nv_bfloat16*>(r));
  return q;
}

// Four consecutive K values (channels) of one A row as one s8x4 register.
__device__ __forceinline__ uint32_t a_word(const int8_t* p, Recip<int8_t>) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t a_word(const __nv_bfloat16* p, Recip<__nv_bfloat16> q) {
  const __nv_bfloat162 lo = __float2bfloat162_rn(-127.0f), hi = __float2bfloat162_rn(127.0f);
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const __nv_bfloat162 v0 = __hmin2(__hmax2(__hmul2(x[0], q.r), lo), hi);
  const __nv_bfloat162 v1 = __hmin2(__hmax2(__hmul2(x[1], q.r), lo), hi);
  const uint32_t w0 = *reinterpret_cast<const uint32_t*>(&v0);
  const uint32_t w1 = *reinterpret_cast<const uint32_t*>(&v1);
  // bf16 -> f32 is exact: the bf16 bits become the float's high half
  return pack_q4(__uint_as_float(w0 << 16), __uint_as_float(w0 & 0xFFFF0000u),
                 __uint_as_float(w1 << 16), __uint_as_float(w1 & 0xFFFF0000u));
}
__device__ __forceinline__ uint32_t a_word(const float* p, Recip<float> q) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  return pack_q4(clamp127(__fmul_rn(v.x, q.r)), clamp127(__fmul_rn(v.y, q.r)),
                 clamp127(__fmul_rn(v.z, q.r)), clamp127(__fmul_rn(v.w, q.r)));
}

// 16 bytes of TIn activations -> their int8 values (16 / sizeof(TIn) bytes).
__device__ __forceinline__ void quantize16(const uint8_t* src, uint8_t* dst, Recip<int8_t>) {
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
}
__device__ __forceinline__ void quantize16(const uint8_t* src, uint8_t* dst,
                                           Recip<__nv_bfloat16> q) {
  const __nv_bfloat16* s = reinterpret_cast<const __nv_bfloat16*>(src);
  *reinterpret_cast<uint2*>(dst) = make_uint2(a_word(s, q), a_word(s + 4, q));
}
__device__ __forceinline__ void quantize16(const uint8_t* src, uint8_t* dst, Recip<float> q) {
  *reinterpret_cast<uint32_t*>(dst) = a_word(reinterpret_cast<const float*>(src), q);
}

// wgmma's A fragment for k-step kk (32 channels) of this thread's rows g and
// g + 8 of its warp: channels 4t..4t+3 and 16+4t..16+4t+3 of each; row0
// and row1 point at the two rows' first channel.
template <typename TIn>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const uint8_t* row0, const uint8_t* row1,
                                       int kk, int t, Recip<TIn> q) {
  const TIn* r0 = reinterpret_cast<const TIn*>(row0) + kk * 32 + 4 * t;
  const TIn* r1 = reinterpret_cast<const TIn*>(row1) + kk * 32 + 4 * t;
  a[0] = a_word(r0, q);
  a[1] = a_word(r1, q);
  a[2] = a_word(r0 + 16, q);
  a[3] = a_word(r1 + 16, q);
}

// The rescale epilogue, rounding as PyTorch rounds acc.to(dt) * scale + bias.
__device__ __forceinline__ float rescale(int acc, float s, float b, bool has_bias) {
  float y = __fmul_rn((float)acc, s);
  return has_bias ? __fadd_rn(y, b) : y;
}
__device__ __forceinline__ __nv_bfloat16 rescale(int acc, __nv_bfloat16 s, __nv_bfloat16 b,
                                                 bool has_bias) {
  const float t = __bfloat162float(__float2bfloat16_rn((float)acc));
  __nv_bfloat16 y = __float2bfloat16_rn(__fmul_rn(t, __bfloat162float(s)));
  if (has_bias) y = __float2bfloat16_rn(__fadd_rn(__bfloat162float(y), __bfloat162float(b)));
  return y;
}

// Two neighbouring outputs of the fused epilogue, stored together; the
// bf16 roundings are paired conversions (cvt.rn.bf16x2.f32), and the
// multiply is one bf16x2 rounding of the exact product.
__device__ __forceinline__ void rescale2(float* d, int a0, int a1, float s0, float s1, float b0,
                                         float b1, bool has_bias) {
  *reinterpret_cast<float2*>(d) =
      make_float2(rescale(a0, s0, b0, has_bias), rescale(a1, s1, b1, has_bias));
}
__device__ __forceinline__ void rescale2(__nv_bfloat16* d, int a0, int a1, __nv_bfloat16 s0,
                                         __nv_bfloat16 s1, __nv_bfloat16 b0, __nv_bfloat16 b1,
                                         bool has_bias) {
  const __nv_bfloat162 t = __floats2bfloat162_rn((float)a0, (float)a1);
  __nv_bfloat162 y = __hmul2(t, __halves2bfloat162(s0, s1));
  if (has_bias) {
    const float2 yf = __bfloat1622float2(y);
    y = __floats2bfloat162_rn(__fadd_rn(yf.x, __bfloat162float(b0)),
                              __fadd_rn(yf.y, __bfloat162float(b1)));
  }
  *reinterpret_cast<__nv_bfloat162*>(d) = y;
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The consumers' epilogue.  acc[4j], acc[4j + 1] belong to tile row `row`,
// columns 8j + 2t and 8j + 2t + 1; acc[4j + 2], acc[4j + 3] to row + 8.
// kFused: the rescaled dt tile is staged in `tile` (idle shared memory),
// then stored 16 bytes at a time along Cout; otherwise the int32 sums go
// straight from the registers (8-byte pairs along Cout) to split z's slab.
// kOutMap: output pixel m is stored where om puts it (the gather kernel's
// forms); otherwise at m.
template <typename TIn, int BN, bool kFused, bool kOutMap>
__device__ __forceinline__ void store_tile(const int (&acc)[BN / 2], uint8_t* tile, const Params& p,
                                           RowMap map, int n0, int row, int t, int tid,
                                           const OutMap& om) {
  auto at = [&](int m) -> size_t { return kOutMap ? om(m) : (size_t)m; };
  if constexpr (kFused) {
    using OutT = TIn;
    constexpr int kOutRow = out_row<TIn, BN>();
    named_bar_sync(1, kConsumers);  // both warpgroups are done with the shared operands
    const OutT* scale = static_cast<const OutT*>(p.scale);
    const OutT* bias = static_cast<const OutT*>(p.bias);
    const bool has_bias = bias != nullptr;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + 2 * t, n = n0 + col;
      const bool v0 = n < p.Cout, v1 = n + 1 < p.Cout;
      const OutT s0 = v0 ? scale[n] : scale[0], s1 = v1 ? scale[n + 1] : scale[0];
      const OutT b0 = has_bias && v0 ? bias[n] : OutT(), b1 = has_bias && v1 ? bias[n + 1] : OutT();
      OutT* d0 = reinterpret_cast<OutT*>(tile + row * kOutRow) + col;
      OutT* d1 = reinterpret_cast<OutT*>(tile + (row + 8) * kOutRow) + col;
      rescale2(d0, acc[4 * j + 0], acc[4 * j + 1], s0, s1, b0, b1, has_bias);
      rescale2(d1, acc[4 * j + 2], acc[4 * j + 3], s0, s1, b0, b1, has_bias);
    }
    named_bar_sync(1, kConsumers);
    constexpr int kEpc = 16 / (int)sizeof(OutT);
    constexpr int kCpr = BN / kEpc;  // 16-byte chunks per tile row
    const bool vec = (p.Cout * (int)sizeof(OutT)) % 16 == 0;
    OutT* out = static_cast<OutT*>(p.out);
    for (int idx = tid; idx < kBM * kCpr; idx += kConsumers) {
      const int rr = idx / kCpr, c = idx - rr * kCpr;
      const int m = map(rr), n = n0 + c * kEpc;
      if (m >= p.M || n >= p.Cout) continue;
      const OutT* src = reinterpret_cast<const OutT*>(tile + rr * kOutRow) + c * kEpc;
      OutT* dst = out + at(m) * p.Cout + n;
      if (vec && n + kEpc <= p.Cout) {
        *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
      } else {
        for (int e = 0; e < kEpc && n + e < p.Cout; ++e) dst[e] = src[e];
      }
    }
  } else {
    int* out = static_cast<int*>(p.out) + (size_t)blockIdx.z * p.M * p.Cout;
    const bool pair = (p.Cout & 1) == 0;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = map(row + 8 * h);
        if (m >= p.M || n >= p.Cout) continue;
        int* dst = out + at(m) * p.Cout + n;
        if (pair) {
          *reinterpret_cast<int2*>(dst) = make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        } else {
          dst[0] = acc[4 * j + 2 * h];
          if (n + 1 < p.Cout) dst[1] = acc[4 * j + 2 * h + 1];
        }
      }
    }
  }
}

// One (tap, slice) stage's two k-steps on this warpgroup's 64 rows.
template <int BN>
__device__ __forceinline__ void mma_stage(int (&acc)[BN / 2], const uint32_t (&a0)[4],
                                          const uint32_t (&a1)[4], uint32_t b_smem) {
  wgmma_fence();
  wgmma_s8(acc, a0, b_desc(b_smem));
  wgmma_s8(acc, a1, b_desc(b_smem + 32));
  wgmma_commit();
  wgmma_wait0();
}

// kFused: quantize TIn activations and write the rescaled dt (= TIn) output;
// otherwise the int32 sums (int8 input, or one split of a split-K launch).
// kForms: the rewrite forms' row map (pad_l, the SrcMode, the second source)
// and output map; a plain launch takes the instance without them.
template <typename TIn, int BN, bool kFused, bool kForms>
__global__ void __launch_bounds__(kThreads, BN == 64 ? 2 : 1)
    q8conv_gather_kernel(const __grid_constant__ CUtensorMap wmap, const Params p, const Forms f) {
  using L = Smem<TIn, BN>;
  constexpr int S = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t full0 = base + L::kBarOff, empty0 = full0 + 8 * S;

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * BN;
  const int it0 = blockIdx.z * p.iters_per_split;
  const int it1 = min(it0 + p.iters_per_split, p.n_iter);

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 33);  // 32 producer lanes' cp.async + the TMA's expect_tx
      mbar_init(empty0 + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer warp: weights by TMA, the activation gather by cp.async ----
    const int lane = tid - kConsumers;
    constexpr int kChunks = kBK * (int)sizeof(TIn) / 16;  // 16-byte chunks per A row
    constexpr int kEpc = 16 / (int)sizeof(TIn);           // channels per chunk
    const TIn* x = static_cast<const TIn*>(p.x);
    int rb[4], riy[4], rix[4];
    bool rok[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + lane + 32 * j;
      rok[j] = m < p.M;
      const int mm = rok[j] ? m : 0;
      const int ox = mm % p.Wo, t = mm / p.Wo;
      rb[j] = t / p.Ho;
      riy[j] = (t % p.Ho) * p.stride - p.pad;
      rix[j] = ox * p.stride - (kForms ? f.pad_l : p.pad);
    }
    for (int it = it0; it < it1; ++it) {
      const int k = it - it0, s = k % S;
      mbar_wait(empty0 + 8 * s, ((k / S) & 1) ^ 1);
      const int tap = it / p.n_ci, ci0 = (it - tap * p.n_ci) * kBK;
      const int kh = tap / p.ks, kw = tap - p.ks * kh;
      if (lane == 0) {
        mbar_expect_tx(full0 + 8 * s, L::kBBytes);
        tma_load_2d(base + s * L::kBBytes, &wmap, tap * p.Cin + ci0, n0, full0 + 8 * s);
      }
      // the slice's source: x, or (forms) x2 past its first n_a channels
      const TIn* xs = x;
      int pitch = p.Cin, c0 = ci0;
      if constexpr (kForms) {
        if (ci0 >= f.n_a) {
          xs = static_cast<const TIn*>(f.x2);
          pitch = p.Cin - f.n_a, c0 = ci0 - f.n_a;
        } else {
          pitch = f.n_a;
        }
      }
      const uint32_t as = base + L::kAOff + s * L::kABytes;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int sy = riy[j] + kh, sx = rix[j] + kw;
        bool ok;
        if constexpr (kForms) {
          const bool oky = src_coord(sy, p.H, f.src, sy);
          ok = rok[j] && oky && src_coord(sx, p.W, f.src, sx);
        } else {
          ok = rok[j] && sy >= 0 && sy < p.H && sx >= 0 && sx < p.W;
        }
        const TIn* src = ok ? xs + (((size_t)rb[j] * p.H + sy) * p.W + sx) * pitch : x;
        const uint32_t dst = as + (lane + 32 * j) * L::kARow;
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          const int ch = c0 + c * kEpc;
          const bool okc = ok && ch < pitch;
          cp_async16(dst + 16 * c, okc ? src + ch : x, okc);
        }
      }
      cp_async_arrive(full0 + 8 * s);
    }
  } else {
    // ---- consumer warpgroups: quantize A into registers, wgmma, epilogue ----
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int row = wg * 64 + warp * 16 + g;  // this thread's rows: row, row + 8
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    const Recip<TIn> r = load_recip<TIn>(p.r);

    // Both k-steps' A fragments are built before either wgmma is issued.
    uint32_t a0[4], a1[4];
    for (int it = it0; it < it1; ++it) {
      const int k = it - it0, s = k % S;
      mbar_wait(full0 + 8 * s, (k / S) & 1);
      const uint8_t* a_row = smem + L::kAOff + s * L::kABytes + row * L::kARow;
      load_a<TIn>(a0, a_row, a_row + 8 * L::kARow, 0, t, r);
      load_a<TIn>(a1, a_row, a_row + 8 * L::kARow, 1, t, r);
      mma_stage<BN>(acc, a0, a1, base + s * L::kBBytes);
      mbar_arrive(empty0 + 8 * s);  // the stage's A and B have been read
    }
    store_tile<TIn, BN, kFused, kForms>(acc, smem + L::kAOff, p, RowMap{m0, kBM, 0}, n0, row, t,
                                        tid, f.om);
  }
}

// The halo kernel (see the note at the top): stride 1, padding 1, 8 x 16
// output patches; K walks 64-channel slices, each quantized once and read
// by the 9 taps.  A split-K launch splits the slices.
template <typename TIn, int BN, bool kFused>
__global__ void __launch_bounds__(kThreads, BN == 64 ? 2 : 1)
    q8conv_halo_kernel(const __grid_constant__ CUtensorMap wmap,
                       const __grid_constant__ CUtensorMap xmap, const Params p) {
  using L = HaloSmem<TIn, BN>;
  constexpr int S = kHaloStages;
  constexpr int kHaloW = kHaloTW + 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t full0 = base + L::kBarOff, empty0 = full0 + 8 * S;
  const uint32_t hfull0 = empty0 + 8 * S, hempty0 = hfull0 + 16;  // the two halo buffers'

  const int tid = threadIdx.x;
  const int tiles_x = p.W / kHaloTW, tiles_y = p.H / kHaloTR;
  const int tx = blockIdx.x % tiles_x, ty = (blockIdx.x / tiles_x) % tiles_y;
  const int b = blockIdx.x / (tiles_x * tiles_y);
  const int y0 = ty * kHaloTR, x0 = tx * kHaloTW, n0 = blockIdx.y * BN;
  const int per = p.iters_per_split / 9;  // slices per split
  const int sl0 = blockIdx.z * per, sl1 = min(sl0 + per, p.n_ci);

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);  // the TMA's expect_tx
      mbar_init(empty0 + 8 * s, kConsumers);
    }
    for (int h = 0; h < 2; ++h) {
      mbar_init(hfull0 + 8 * h, 1);
      mbar_init(hempty0 + 8 * h, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer thread: the halo of slice sl + 1 goes out before the
    // weights of slice sl, so it lands while the taps of sl run ----
    if (tid != kConsumers) return;
    auto load_halo = [&](int sl) {
      const int ks = sl - sl0, h = ks & 1;
      mbar_wait(hempty0 + 8 * h, ((ks >> 1) & 1) ^ 1);
      mbar_expect_tx(hfull0 + 8 * h, L::kRawBytes);
      tma_load_4d(base + L::kRawOff + h * L::kRawBytes, &xmap, sl * kBK, x0 - 1, y0 - 1, b,
                  hfull0 + 8 * h);
    };
    if (sl0 < sl1) load_halo(sl0);
    for (int sl = sl0; sl < sl1; ++sl) {
      if (sl + 1 < sl1) load_halo(sl + 1);
      for (int tap = 0; tap < 9; ++tap) {
        const int k = (sl - sl0) * 9 + tap, s = k % S;
        mbar_wait(empty0 + 8 * s, ((k / S) & 1) ^ 1);
        mbar_expect_tx(full0 + 8 * s, L::kBBytes);
        tma_load_2d(base + s * L::kBBytes, &wmap, tap * p.Cin + sl * kBK, n0, full0 + 8 * s);
      }
    }
  } else {
    // ---- consumer warpgroups: quantize the halo once, then 9 taps ----
    const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int row = wg * 64 + warp * 16 + g;  // rows row, row + 8: one patch row, 8 columns apart
    const int hpix = (row / kHaloTW) * kHaloW + row % kHaloTW;  // tap (0, 0)'s halo pixel
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    const Recip<TIn> r = load_recip<TIn>(p.r);
    uint8_t* q = smem + L::kQOff;  // [kHaloPix][kQRow] int8
    constexpr int kChunks = kBK * (int)sizeof(TIn) / 16;  // 16-byte chunks per halo pixel
    constexpr int kQpc = 16 / (int)sizeof(TIn);           // int8 bytes per chunk

    uint32_t a0[4], a1[4];
    for (int sl = sl0; sl < sl1; ++sl) {
      const int ks = sl - sl0, h = ks & 1;
      mbar_wait(hfull0 + 8 * h, (ks >> 1) & 1);
      if (ks) named_bar_sync(1, kConsumers);  // the previous slice's taps are done with q
      const uint8_t* halo = smem + L::kRawOff + h * L::kRawBytes;
      for (int u = tid; u < kHaloPix * kChunks; u += kConsumers) {
        const int px = u / kChunks;
        quantize16(halo + 16 * u, q + px * kQRow + (u - px * kChunks) * kQpc, r);
      }
      mbar_arrive(hempty0 + 8 * h);
      named_bar_sync(1, kConsumers);  // q holds the slice
      for (int tap = 0; tap < 9; ++tap) {
        const int k = ks * 9 + tap, s = k % S;
        const uint8_t* a_row = q + (hpix + (tap / 3) * kHaloW + tap % 3) * kQRow;
        load_a<int8_t>(a0, a_row, a_row + 8 * kQRow, 0, t, Recip<int8_t>{});
        load_a<int8_t>(a1, a_row, a_row + 8 * kQRow, 1, t, Recip<int8_t>{});
        mbar_wait(full0 + 8 * s, (k / S) & 1);
        mma_stage<BN>(acc, a0, a1, base + s * L::kBBytes);
        mbar_arrive(empty0 + 8 * s);
      }
    }
    const RowMap map{(b * p.H + y0) * p.W + x0, kHaloTW, p.W};
    store_tile<TIn, BN, kFused, false>(acc, smem + L::kRawOff, p, map, n0, row, t, tid, OutMap{});
  }
}

// Split-K's second pass: sum the int32 partials of each output (exact), then
// write int32 or apply the fused epilogue; kOutMap: at om's place (the
// rewrite forms' output map), else at the partial's.
template <typename OutT, bool kOutMap>
__global__ void q8conv_reduce_kernel(const int* __restrict__ ws, int splits, int M, int Cout,
                                     void* out, const void* scale, const void* bias,
                                     const OutMap om) {
  const size_t mn = (size_t)M * Cout;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < mn;
       i += (size_t)gridDim.x * blockDim.x) {
    int acc = 0;
    for (int s = 0; s < splits; ++s) acc += ws[s * mn + i];
    const int n = (int)(i % Cout);
    const size_t o = kOutMap ? om((int)(i / Cout)) * Cout + n : i;
    if constexpr (std::is_same<OutT, int>::value) {
      static_cast<int*>(out)[o] = acc;
    } else {
      const OutT* b = static_cast<const OutT*>(bias);
      static_cast<OutT*>(out)[o] =
          rescale(acc, static_cast<const OutT*>(scale)[n], b ? b[n] : OutT(), b != nullptr);
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver library the CUDA runtime has loaded,
// so the kernels link without -lcuda.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_LAZY | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_LAZY);
    if (lib != nullptr) fn = reinterpret_cast<EncodeTiledFn>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

template <typename TIn, int BN, bool kFused, bool kForms>
cudaError_t launch_gather(const CUtensorMap& wmap, const Params& p, const Forms& f, dim3 grid,
                          cudaStream_t s) {
  auto kernel = q8conv_gather_kernel<TIn, BN, kFused, kForms>;
  constexpr int bytes = Smem<TIn, BN>::kBytes;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, bytes, s>>>(wmap, p, f);
  return cudaGetLastError();
}

template <typename TIn, int BN, bool kFused>
cudaError_t launch(const CUtensorMap& wmap, const CUtensorMap* xmap, const Params& p,
                   const Forms* forms, dim3 grid, cudaStream_t s) {
  if (xmap != nullptr) {
    auto kernel = q8conv_halo_kernel<TIn, BN, kFused>;
    constexpr int bytes = HaloSmem<TIn, BN>::kBytes;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, bytes, s>>>(wmap, *xmap, p);
    return cudaGetLastError();
  }
  return forms ? launch_gather<TIn, BN, kFused, true>(wmap, p, *forms, grid, s)
               : launch_gather<TIn, BN, kFused, false>(wmap, p, Forms{}, grid, s);
}

template <typename TIn, bool kFused>
cudaError_t launch_bn(const CUtensorMap& wmap, const CUtensorMap* xmap, const Params& p,
                      const Forms* forms, dim3 grid, int bn, cudaStream_t s) {
  return bn == 64 ? launch<TIn, 64, kFused>(wmap, xmap, p, forms, grid, s)
                  : launch<TIn, 128, kFused>(wmap, xmap, p, forms, grid, s);
}

template <typename OutT>
void launch_reduce(const int* ws, int splits, int M, int Cout, void* out, const void* scale,
                   const void* bias, const OutMap& om, cudaStream_t s) {
  const int threads = 256;
  const long long want = ((long long)M * Cout + threads - 1) / threads;
  const unsigned blocks = (unsigned)(want < 4096 ? want : 4096);
  if (om.step == 1)
    q8conv_reduce_kernel<OutT, false><<<blocks, threads, 0, s>>>(ws, splits, M, Cout, out, scale,
                                                                 bias, om);
  else
    q8conv_reduce_kernel<OutT, true><<<blocks, threads, 0, s>>>(ws, splits, M, Cout, out, scale,
                                                                bias, om);
}

}  // namespace

// x: [B, H, W, Cin] of in_kind (0 int8, 1 float32, 2 bfloat16); w: [Cout, ks,
// ks, Cin] int8, ks 2, 3 or 4; out: [B, Ho, Wo, Cout], int32 for int8 input,
// else of the input dtype with the quantize (r: [] reciprocal scale) and the
// rescale (scale [Cout], bias [Cout] or null) fused.  iters_per_split > 0
// splits the ks * ks * ceil(Cin / 64) K iterations over `splits` =
// ceil(n_iter / iters_per_split) blocks per tile, through workspace (int32
// [splits, M, Cout]); the caller sizes it with the same formula.  A 3x3 conv
// of stride 1 with padding 1 on a plain source with W % 16 == 0 and H % 8 ==
// 0, and a plain output, takes the halo kernel, which splits whole slices:
// iters_per_split must then be a multiple of 9.
//
// The gather kernel's forms (see the note at the top): pad_t / pad_l the top
// and left padding (Ho and Wo fix the bottom and right); src a SrcMode, with
// H and W the source's size; x2 (or null) the second source, x holding the
// first n_a channels (n_a % 64 == 0 with x2; Cin without); out_step, out_dy,
// out_dx, OH, OW the output map (out is then [B, OH, OW, Cout]).
extern "C" int lsp_q8conv(const void* x, int in_kind, const int8_t* w, int B, int H, int W,
                          int Cin, int Cout, int ks, int stride, int pad_t, int pad_l, int Ho,
                          int Wo, void* out, const void* r, const void* scale, const void* bias,
                          int* workspace, int iters_per_split, int splits, int src,
                          const void* x2, int n_a, int out_step, int out_dy, int out_dx, int OH,
                          int OW, void* stream) {
  if (Cin % 16 != 0 || Cin <= 0 || Cout <= 0 || stride < 1 || in_kind < 0 || in_kind > 2 ||
      ks < 2 || ks > 4 || pad_t < 0 || pad_l < 0 || iters_per_split <= 0 ||
      ((uintptr_t)x | (uintptr_t)w | (uintptr_t)x2) % 16 != 0 || src < kSrcPlain ||
      src > kSrcDil2 || n_a <= 0 || n_a > Cin || n_a % 16 != 0 ||
      (x2 == nullptr) != (n_a == Cin) || (x2 != nullptr && n_a % kBK != 0) || out_step < 1 ||
      out_dy < 0 || out_dx < 0 || out_dy >= out_step || out_dx >= out_step ||
      (out_step == 1 && (OH != Ho || OW != Wo)) ||
      (out_step > 1 && (OH != out_step * Ho || OW != out_step * Wo)))
    return (int)cudaErrorInvalidValue;
  if (in_kind != 0 && (r == nullptr || scale == nullptr)) return (int)cudaErrorInvalidValue;
  const long long M = (long long)B * Ho * Wo;
  if (M == 0) return (int)cudaSuccess;
  if (M > (1LL << 30) || (long long)B * OH * OW > (1LL << 30)) return (int)cudaErrorInvalidValue;
  const int n_ci = (Cin + kBK - 1) / kBK, n_iter = ks * ks * n_ci;
  const bool halo = ks == 3 && stride == 1 && pad_t == 1 && pad_l == 1 && Ho == H && Wo == W &&
                    W % kHaloTW == 0 && H % kHaloTR == 0 && src == kSrcPlain &&
                    x2 == nullptr && out_step == 1;
  if (splits != (n_iter + iters_per_split - 1) / iters_per_split ||
      (splits > 1 && workspace == nullptr) || (halo && iters_per_split % 9 != 0))
    return (int)cudaErrorInvalidValue;
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;

  const int bn = Cout <= 64 ? 64 : 128;
  CUtensorMap wmap;
  const cuuint64_t dims[2] = {(cuuint64_t)ks * ks * Cin, (cuuint64_t)Cout};
  const cuuint64_t strides[1] = {(cuuint64_t)ks * ks * Cin};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)bn};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  if (encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(w), dims, strides, box,
             estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  // the halo kernel's activation map: [B, H, W, Cin], one box = one slice's
  // 10 x 18 halo; out-of-bounds elements (the padding) arrive as zeros
  CUtensorMap xmap;
  if (halo) {
    const cuuint64_t es = in_kind == 0 ? 1 : in_kind == 1 ? 4 : 2;
    const cuuint64_t xdims[4] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
    const cuuint64_t xstrides[3] = {Cin * es, (cuuint64_t)W * Cin * es,
                                    (cuuint64_t)H * W * Cin * es};
    const cuuint32_t xbox[4] = {(cuuint32_t)kBK, kHaloTW + 2, kHaloTR + 2, 1};
    const CUtensorMapDataType dt = in_kind == 0   ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                   : in_kind == 1 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                                  : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    if (encode(&xmap, dt, 4, const_cast<void*>(x), xdims, xstrides, xbox, estr,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
  }

  const OutMap om{Ho, Wo, out_step, out_dy, out_dx, OH, OW};
  Params p;
  p.x = x;
  p.out = splits > 1 ? (void*)workspace : out;
  p.r = r;
  p.scale = scale;
  p.bias = bias;
  p.H = H, p.W = W, p.Cin = Cin, p.Cout = Cout, p.ks = ks, p.stride = stride, p.pad = pad_t;
  p.Ho = Ho, p.Wo = Wo, p.M = (int)M;
  p.n_ci = n_ci, p.n_iter = n_iter, p.iters_per_split = iters_per_split;
  // split-K's partials are m-major in the workspace; the reduce pass maps them
  const Forms f{x2, pad_l, src, n_a, splits > 1 ? OutMap{Ho, Wo, 1, 0, 0, Ho, Wo} : om};
  const dim3 grid((unsigned)((M + kBM - 1) / kBM), (unsigned)((Cout + bn - 1) / bn),
                  (unsigned)splits);
  cudaStream_t s = (cudaStream_t)stream;
  const CUtensorMap* xm = halo ? &xmap : nullptr;
  const bool fused = in_kind != 0 && splits == 1;
  // a plain launch (one source read as it is, padding pad_t all round, the
  // output at m) takes the gather instance without the forms
  const bool forms = src != kSrcPlain || x2 != nullptr || out_step != 1 || pad_l != pad_t;
  const Forms* fp = forms ? &f : nullptr;
  cudaError_t err;
  if (in_kind == 0)
    err = launch_bn<int8_t, false>(wmap, xm, p, fp, grid, bn, s);
  else if (in_kind == 1)
    err = fused ? launch_bn<float, true>(wmap, xm, p, fp, grid, bn, s)
                : launch_bn<float, false>(wmap, xm, p, fp, grid, bn, s);
  else
    err = fused ? launch_bn<__nv_bfloat16, true>(wmap, xm, p, fp, grid, bn, s)
                : launch_bn<__nv_bfloat16, false>(wmap, xm, p, fp, grid, bn, s);
  if (err != cudaSuccess || splits == 1) return (int)err;

  if (in_kind == 0)
    launch_reduce<int>(workspace, splits, (int)M, Cout, out, scale, bias, om, s);
  else if (in_kind == 1)
    launch_reduce<float>(workspace, splits, (int)M, Cout, out, scale, bias, om, s);
  else
    launch_reduce<__nv_bfloat16>(workspace, splits, (int)M, Cout, out, scale, bias, om, s);
  return (int)cudaGetLastError();
}
