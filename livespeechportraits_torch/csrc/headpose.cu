// K5: the head-pose decode, n consecutive steps of the Audio2Headpose
// WaveNet and its GMM sample in one launch.
//
// Replaces no Pallas kernel: JAX runs the decode as a lax.scan of
// stream_step and sample_gmm (livespeechportraits_tpu/models/
// audio2headpose.py, _decode_scan), which XLA compiles into one loop on the
// TPU.  The port ran the same step (models/audio2headpose.py::decode_step,
// its plain twin) as a CUDA graph of ~360 nodes replayed once a frame, about
// 0.50 ms a step on the H100; the step's arithmetic needs a few microseconds.
//
// A step (the published A2H WaveNet: kernel size 2, dilations 1..64 twice,
// 128 residual and dilation channels, 256 skip channels, 12 inputs):
//   h   = act(start_conv2(act(start_conv1(x_prev))))
//   for each of the 14 layers l (ring slot s = step % d_l):
//     f   = Wf0 x_old + Wf1 h + b_f + fproj[l, row]    x_old = ring_l[s]
//     g   = Wg0 x_old + Wg1 h + b_g + gproj[l, row]
//     z   = tanh(f) * sigmoid(g);  skip += W_s z + b_s;  ring_l[s] = h
//     h   = W_r z + b_r + h
//   out = end_conv_2(act(end_conv_1(act(skip))))
//   x   = the GMM sample of out with row `row`'s Gumbel and normal draws
//         (ops/gmm.py::sample_gmm): samples[row] = x_prev = x; row, step += 1
//
// What bounds it: latency.  A step reads 6.8 MB of f32 weights (2 us at
// 3.35 TB/s, and they sit in the 50 MB L2) for 3.4 MFLOP, but its critical
// path is a chain of 29 dependent matrix-vector stages, each of which every
// output unit of the next one needs: start_conv2, then per layer the f/g
// taps on h and the residual on z, then the end.  So the design follows
// K2/K3 (csrc/recurrent.cu): ONE thread-block cluster of 16 blocks, one per
// SM, keeps the weights on the critical path in shared memory for the whole
// launch and hands each stage's vector to every block with st.async into
// distributed shared memory, counted on the receiving block's mbarrier; no
// barrier joins the blocks.
//
// Block b owns units 8b..8b+7 of every 128-wide vector and skip rows
// 16b..16b+15.  Warps 0-7 ("unit warps") carry the critical path, warp w
// unit 8b+w: per layer it forms f and g from h (2 rows of 128, one float4 a
// lane, resident), z, and sends z to every block; then, once all 128 z have
// landed, the residual row (resident) and h + it, which it sends on.  The
// weights off that path stream from L2 into warps 8-15 ("helpers"), one
// layer ahead of their use:
//   - the x_old taps: x_old of step t+1 is known during step t (ring rows
//     written d_l >= 1 steps before), so the helpers form step t+1's
//     Wf0 x_old + b_f + fproj (and g's) during step t.  For d_l = 1, x_old
//     is the layer input h of step t, which every block received; for
//     d_l >= 2, each block sends its 8 columns of the ring rows to every
//     block at the start of step t (one exchange of 12 x 128 floats, into
//     one of two buffers by step parity: a block's helpers may start step
//     t + 1 while a peer's still read step t's);
//   - the skip rows, summed as each z arrives; at the end each block forms
//     its 16 rows' share of end_conv_1 and sends it to every block (one
//     exchange), and warp 0 of every block finishes the step alike:
//     end_conv_1's sum, end_conv_2, the sample and start_conv1.
// The ring is the decode buffers' own ring_flat in device memory: a block
// writes and reads only its own 8 columns of it, so it holds the state
// between launches and nothing crosses blocks through device memory.
// Every step stage that the plain twin computes is computed here; the
// residual of the last layer is computed and, as in the twin, read by
// nothing (the step's h after the last layer feeds neither the ring nor the
// output).
//
// Race freedom (as K2's): every exchange has its own buffer and mbarrier,
// used once a step, so step t's data is phase t (parity t & 1).  A block
// sends step t + 1's data of an exchange only after the whole of step t,
// whose end needs every block's step-t end_conv_1 share, and each block
// sends that share only after its warps read all of step t's buffers; so
// no write overtakes a read and no phase completes twice before a waiter
// sees it.  The x_old exchange is the exception: a block's helpers send
// it at the start of their step, which waits only for the block's own
// unit warps, so it alternates between two buffers and barriers (a
// block's helpers reach step t + 1 only after every block's helpers have
// finished step t - 1, whose buffer step t + 1 reuses).  Inside a block, named barriers order the unit warps' ring
// writes before the helpers' reads of them (bar 3 / 4 by step parity), the
// helpers' step-(t+1) f/g parts before the unit warps' use (bar 2), and
// warp 0's start_conv1 before the unit warps' start_conv2 (bar 1).  One
// cluster barrier after the set-up makes sure every block's mbarriers are
// initialised before a peer stores into it; every block waits for all it
// receives before it exits.
//
// Numerics: f32 throughout, expf / tanhf and a correctly rounded
// reciprocal, no fast-math; the sample's sigma * scale * eps + mu in the
// twin's order, unfused.  Only the order of the f32 sums differs from the
// twin.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kC = 16;                     // blocks of the cluster
constexpr int kWarps = 16;                 // warps a block
constexpr int kThreads = kWarps * 32;
constexpr int kUnitWarps = 8;              // warps 0-7 carry the critical path
constexpr int kHelpThreads = kThreads - kUnitWarps * 32;
constexpr int kR = 128;                    // residual = dilation channels
constexpr int kS = 256;                    // skip channels
constexpr int kIn = 12;                    // input channels = the sample's width
constexpr int kL = 14;                     // layers: dilations 1..64, twice
constexpr int kWide = 12;                  // the layers of dilation >= 2
constexpr int kU = kR / kC;                // units a block
constexpr int kSkipRows = kS / kC;         // skip rows a block
constexpr int kMaxNC = 2;                  // GMM components
static_assert(kU == kUnitWarps, "one unit a unit warp");
static_assert(kSkipRows == 2 * (kWarps - kUnitWarps), "two skip rows a helper warp");
static_assert(kR == 4 * 32, "one float4 of a 128-vector a lane");

__host__ __device__ constexpr int dil(int l) { return 1 << (l % 7); }
// the first ring row of layer l in ring_flat (rows: the dilations, in order)
__host__ __device__ constexpr int ring_off(int l) { return dil(l) - 1 + (l >= 7 ? 127 : 0); }
// a layer of dilation >= 2: its row in the x_old exchange
__host__ __device__ constexpr int wide(int l) { return l - 1 - (l >= 8 ? 1 : 0); }

// The packed weights (ops/decode_cuda.py::pack_weights), float offsets.
constexpr size_t kHF = 0;                                // [L][R][2][R] f, g taps on h
constexpr size_t kRES = kHF + (size_t)kL * kR * 2 * kR;  // [L][R][R]
constexpr size_t kXF = kRES + (size_t)kL * kR * kR;      // [L][R][2][R] f, g taps on x_old
constexpr size_t kSK = kXF + (size_t)kL * kR * 2 * kR;   // [L][S][R]
constexpr size_t kBFG = kSK + (size_t)kL * kS * kR;      // [L][R][2]
constexpr size_t kBRES = kBFG + (size_t)kL * kR * 2;     // [L][R]
constexpr size_t kBSK = kBRES + (size_t)kL * kR;         // [L][S]
constexpr size_t kC1 = kBSK + (size_t)kL * kS;           // [R][In]
constexpr size_t kBC1 = kC1 + (size_t)kR * kIn;          // [R]
constexpr size_t kC2 = kBC1 + kR;                        // [R][R]
constexpr size_t kBC2 = kC2 + (size_t)kR * kR;           // [R]
constexpr size_t kE1 = kBC2 + kR;  // [E][S], then b [E], [E][E], b [E]; E = 25 * ncenter

// Shared memory of a block, float offsets (E = the GMM width).
struct Smem {
  int E;
  static constexpr int kBars = 2 * kL + 3;    // h[L], z[L], x_old exchange[2], end_conv_1
  static constexpr int hf = 64;               // after the mbarriers (256 bytes)
  static constexpr int res = hf + kL * kU * 2 * kR;  // [L][U][R]
  static constexpr int c2 = res + kL * kU * kR;      // [U][R]
  static constexpr int c1 = c2 + kU * kR;            // [R][In]
  static constexpr int bc1 = c1 + kR * kIn;          // [R]
  static constexpr int bc2 = bc1 + kR;               // [U]
  static constexpr int bres = bc2 + kU;              // [L][U]
  static constexpr int hbuf = bres + kL * kU;        // [L][R] each layer's input h
  static constexpr int zbuf = hbuf + kL * kR;        // [L][R]
  static constexpr int xo = zbuf + kL * kR;          // [2][kWide][R] x_old of step t by t & 1
  static constexpr int xpart = xo + 2 * kWide * kR;  // [2][L][U][2] f / g parts by step parity
  static constexpr int h1 = xpart + 2 * kL * kU * 2; // [R] start_conv1's output
  static constexpr int xprev = h1 + kR;              // [16]
  static constexpr int skact = xprev + 16;           // [16] act(skip) of the block's rows
  static constexpr int o1 = skact + 16;              // [C][E] end_conv_1 shares by sender
  static __host__ __device__ int pad(int n) { return (n + 3) & ~3; }
  __host__ __device__ int e1() const { return o1 + pad(kC * E); }  // [E][16] the block's columns
  __host__ __device__ int be1() const { return e1() + E * kSkipRows; }
  __host__ __device__ int be2() const { return be1() + pad(E); }
  __host__ __device__ int a1() const { return be2() + pad(E); }  // act(end_conv_1)
  __host__ __device__ int o2() const { return a1() + pad(E); }   // end_conv_2
  __host__ __device__ int e2() const { return o2() + pad(E); }   // [E][E]
  __host__ __device__ int floats() const { return e2() + E * E; }
};
static_assert(Smem::kBars * 8 <= Smem::hf * 4, "the mbarriers fit before the weights");

// named barriers (0 is __syncthreads)
constexpr int kTailBar = 1;   // the unit warps: warp 0's start_conv1 is in h1
constexpr int kXpartBar = 2;  // helpers arrive, unit warps wait: next step's f / g parts
constexpr int kRingBar = 3;   // 3 / 4 by step parity: unit warps arrive, helpers wait
constexpr int kHelpBar = 5;   // the helpers: act(skip) of the block's rows

__device__ __forceinline__ float act(float x) { return x >= 0.0f ? x : 0.2f * x; }
__device__ __forceinline__ float sigmoid(float x) { return __frcp_rn(1.0f + expf(-x)); }

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ unsigned map_rank(unsigned addr, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void st_async(unsigned addr, float v, unsigned mbar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(
                   addr),
               "r"(__float_as_uint(v)), "r"(mbar)
               : "memory");
}

__device__ __forceinline__ void st_async4(unsigned addr, float4 v, unsigned mbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(addr),
      "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)), "r"(__float_as_uint(v.z)),
      "r"(__float_as_uint(v.w)), "r"(mbar)
      : "memory");
}

// Send v to the same shared-memory word `p` (and its mbarrier `mbar`) of
// block `rank`.
__device__ __forceinline__ void send(const float* p, float v, unsigned mbar, int rank) {
  st_async(map_rank(smem_u32(p), rank), v, map_rank(mbar, rank));
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned mbar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(mbar) : "memory");
}

__device__ __forceinline__ void mbar_arm(unsigned mbar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(mbar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned mbar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(mbar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float4 lds4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// The sum over the warp of a (lanes 0-15 get it) and of b (lanes 16-31):
// one halving level, then butterflies in each half; every lane of a half
// holds the same bits.
__device__ __forceinline__ float pair_sum(float a, float b, int lane) {
  const bool up = lane & 16;
  float v = (up ? b : a) + __shfl_xor_sync(kFull, up ? a : b, 16);
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// warp 0: h1 = act(start_conv1(x_prev)), x_prev in shared memory
__device__ __forceinline__ void start_conv1(float* sm, int lane) {
#pragma unroll
  for (int u = lane; u < kR; u += 32) {
    float v = sm[Smem::bc1 + u];
#pragma unroll
    for (int d = 0; d < kIn; ++d) v = fmaf(sm[Smem::c1 + u * kIn + d], sm[Smem::xprev + d], v);
    sm[Smem::h1 + u] = act(v);
  }
}

// A helper lane's weights of one layer, fetched from L2 a layer ahead:
// its warp's two skip rows and its unit's two x_old rows (a float4 each),
// the skip bias of its half's row, the f (lanes 0-15) or g bias and
// conditioning projection of its half.
struct Fetch {
  float4 s0, s1, xf, xg;
  float bs, bfg, proj;
};

__global__ void __launch_bounds__(kThreads, 1)
headpose_decode_kernel(const float* __restrict__ w, const float* __restrict__ fproj,
                       const float* __restrict__ gproj, const float* __restrict__ gumbel,
                       const float* __restrict__ eps, float* ring, float* x_prev, float* samples,
                       long long* step, long long* row, int rows, int n, int nc,
                       float sigma_scale) {
  cg::cluster_group cluster = cg::this_cluster();
  const int b = (int)cluster.block_rank();
  const int E = 25 * nc;
  const Smem sl{E};
  extern __shared__ float4 dsm[];
  float* sm = reinterpret_cast<float*>(dsm);
  const unsigned bars = smem_u32(sm);
  // the x_old exchange of step t's data: barrier and buffer t & 1
  const unsigned bar_xo = bars + 8 * (2 * kL), bar_o1 = bars + 8 * (2 * kL + 2);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row0 = *row, step0 = *step;
  // steps past the buffers' rows are not taken (every block alike)
  const int nn = row0 < 0 || row0 >= rows ? 0 : (int)min((long long)n, (long long)rows - row0);
  if (nn <= 0) return;
  const int u0 = b * kU;
  const unsigned xo_bytes = 4u * kWide * kR, o1_bytes = 4u * kC * E;

  // ---- set-up: the block's resident weights, the mbarriers, x_prev
  for (int i = threadIdx.x; i < kL * kU * 2 * kR / 4; i += kThreads) {
    const int l = i / (kU * 2 * kR / 4), r = i % (kU * 2 * kR / 4);
    *reinterpret_cast<float4*>(sm + Smem::hf + l * kU * 2 * kR + 4 * r) =
        ldg4(w + kHF + ((size_t)l * kR + u0) * 2 * kR + 4 * r);
  }
  for (int i = threadIdx.x; i < kL * kU * kR / 4; i += kThreads) {
    const int l = i / (kU * kR / 4), r = i % (kU * kR / 4);
    *reinterpret_cast<float4*>(sm + Smem::res + l * kU * kR + 4 * r) =
        ldg4(w + kRES + ((size_t)l * kR + u0) * kR + 4 * r);
  }
  for (int i = threadIdx.x; i < kU * kR; i += kThreads) sm[Smem::c2 + i] = w[kC2 + u0 * kR + i];
  for (int i = threadIdx.x; i < kR * kIn; i += kThreads) sm[Smem::c1 + i] = w[kC1 + i];
  for (int i = threadIdx.x; i < kR; i += kThreads) sm[Smem::bc1 + i] = w[kBC1 + i];
  for (int i = threadIdx.x; i < kU; i += kThreads) sm[Smem::bc2 + i] = w[kBC2 + u0 + i];
  for (int i = threadIdx.x; i < kL * kU; i += kThreads)
    sm[Smem::bres + i] = w[kBRES + (i / kU) * kR + u0 + i % kU];
  const size_t e1 = kE1, be1 = e1 + (size_t)E * kS, e2 = be1 + E, be2 = e2 + (size_t)E * E;
  for (int i = threadIdx.x; i < E * kSkipRows; i += kThreads)
    sm[sl.e1() + i] = w[e1 + (size_t)(i / kSkipRows) * kS + b * kSkipRows + i % kSkipRows];
  for (int i = threadIdx.x; i < E; i += kThreads) {
    sm[sl.be1() + i] = w[be1 + i];
    sm[sl.be2() + i] = w[be2 + i];
  }
  for (int i = threadIdx.x; i < E * E; i += kThreads) sm[sl.e2() + i] = w[e2 + i];
  if (threadIdx.x < kIn) sm[Smem::xprev + threadIdx.x] = x_prev[threadIdx.x];
  if (threadIdx.x == 0) {
    for (int i = 0; i < Smem::kBars; ++i) mbar_init(bars + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < 2 * kL; ++i) mbar_arm(bars + 8 * i, 4u * kR);  // phase 0: step 0
    if (nn > 1) mbar_arm(bar_xo + 8, xo_bytes);  // step 0 sends step 1's x_old
    if (nn > 2) mbar_arm(bar_xo, xo_bytes);      // step 1 sends step 2's
    mbar_arm(bar_o1, o1_bytes);
  }
  __syncthreads();

  const bool unit = warp < kUnitWarps;
  const int hw = warp - kUnitWarps;  // a helper's warp
  const int j = u0 + (unit ? warp : hw);  // the unit of a unit warp, or of a helper's x_old rows
  const bool up = lane & 16;

  // A helper's fetch of layer l for step t (the x_old rows and projections
  // are step t + 1's; none past the last step)
  auto fetch = [&](int l, int t) {
    Fetch f;
    const int r0 = b * kSkipRows + 2 * hw;
    f.s0 = ldg4(w + kSK + ((size_t)l * kS + r0) * kR + 4 * lane);
    f.s1 = ldg4(w + kSK + ((size_t)l * kS + r0 + 1) * kR + 4 * lane);
    f.bs = __ldg(w + kBSK + (size_t)l * kS + r0 + (up ? 1 : 0));
    f.xf = ldg4(w + kXF + ((size_t)l * kR + j) * 2 * kR + 4 * lane);
    f.xg = ldg4(w + kXF + (((size_t)l * kR + j) * 2 + 1) * kR + 4 * lane);
    f.bfg = __ldg(w + kBFG + ((size_t)l * kR + j) * 2 + (up ? 1 : 0));
    f.proj = t < nn ? __ldg((up ? gproj : fproj) + ((size_t)l * rows + row0 + t) * kR + j) : 0.0f;
    return f;
  };
  // f / g parts of unit j: lanes 0-15 get Wf0 x + b_f + fproj, 16-31 g's
  auto xpart = [&](const Fetch& f, float4 x) {
    return pair_sum(dot4(f.xf, x, 0.0f), dot4(f.xg, x, 0.0f), lane) + f.bfg + f.proj;
  };

  // step 0's f / g parts, x_old straight from the ring as the launch found it
  if (!unit) {
    for (int l = 0; l < kL; ++l) {
      const Fetch f = fetch(l, 0);
      const unsigned long long slot = (unsigned long long)step0 & (dil(l) - 1);
      const float4 x = *reinterpret_cast<const float4*>(ring + (ring_off(l) + slot) * kR + 4 * lane);
      const float v = xpart(f, x);
      if ((lane & 15) == 0) sm[Smem::xpart + (l * kU + hw) * 2 + (up ? 1 : 0)] = v;
    }
  } else if (warp == 0) {
    start_conv1(sm, lane);
  }
  __syncthreads();
  cluster.sync();  // every block is running, its mbarriers set

  if (unit) {
    // start_conv2 of unit j from h1, sent to every block as layer 0's input
    auto start_conv2 = [&]() {
      const float a = warp_sum(dot4(lds4(sm + Smem::c2 + warp * kR + 4 * lane),
                                    lds4(sm + Smem::h1 + 4 * lane), 0.0f));
      const float h = act(a + sm[Smem::bc2 + warp]);
      if (lane < kC) send(sm + Smem::hbuf + j, h, bars, lane);
      return h;
    };
    float hj = start_conv2();
    for (int t = 0; t < nn; ++t) {
      const unsigned par = t & 1;
      const bool more = t + 1 < nn;
      const unsigned long long s = (unsigned long long)step0 + t;
      if (t > 0) bar_sync(kXpartBar, kThreads);
      const float* xp = sm + Smem::xpart + par * (kL * kU * 2) + warp * 2;
      for (int l = 0; l < kL; ++l) {
        const unsigned bh = bars + 8 * l, bz = bars + 8 * (kL + l);
        // f, g from h_l
        const float4 wf = lds4(sm + Smem::hf + ((l * kU + warp) * 2) * kR + 4 * lane);
        const float4 wg = lds4(sm + Smem::hf + ((l * kU + warp) * 2 + 1) * kR + 4 * lane);
        const float xf = xp[l * kU * 2], xg = xp[l * kU * 2 + 1];
        mbar_wait(bh, par);
        if (more && threadIdx.x == 0) mbar_arm(bh, 4u * kR);
        const float4 hv = lds4(sm + Smem::hbuf + l * kR + 4 * lane);
        const float v = pair_sum(dot4(wf, hv, 0.0f), dot4(wg, hv, 0.0f), lane);
        const float other = __shfl_xor_sync(kFull, v, 16);
        const float f = (up ? other : v) + xf, g = (up ? v : other) + xg;
        const float z = tanhf(f) * sigmoid(g);
        if (lane == 0) ring[(ring_off(l) + (s & (dil(l) - 1))) * kR + j] = hj;
        if (lane < kC) send(sm + Smem::zbuf + l * kR + j, z, bz, lane);
        // h_{l+1} = residual(z) + h_l
        const float4 wr = lds4(sm + Smem::res + (l * kU + warp) * kR + 4 * lane);
        mbar_wait(bz, par);
        if (more && threadIdx.x == 0) mbar_arm(bz, 4u * kR);
        const float r = warp_sum(dot4(wr, lds4(sm + Smem::zbuf + l * kR + 4 * lane), 0.0f));
        hj = (r + sm[Smem::bres + l * kU + warp]) + hj;
        if (l + 1 < kL && lane < kC) send(sm + Smem::hbuf + (l + 1) * kR + j, hj, bh + 8, lane);
      }
      if (more) bar_arrive(kRingBar + (t & 1), kThreads);  // this step's ring writes
      if (warp == 0) {
        // end_conv_1 from the blocks' shares, end_conv_2, the sample, start_conv1
        mbar_wait(bar_o1, par);
        if (more && lane == 0) mbar_arm(bar_o1, o1_bytes);
        for (int e = lane; e < E; e += 32) {
          float v = sm[sl.be1() + e];
          for (int src = 0; src < kC; ++src) v += sm[Smem::o1 + src * E + e];
          sm[sl.a1() + e] = act(v);
        }
        __syncwarp();
        for (int e = lane; e < E; e += 32) {
          float v = sm[sl.be2() + e];
          for (int k = 0; k < E; ++k) v = fmaf(sm[sl.e2() + e * E + k], sm[sl.a1() + k], v);
          sm[sl.o2() + e] = v;
        }
        __syncwarp();
        if (lane < kIn) {
          const long long rr = row0 + t;
          const float* o2 = sm + sl.o2();
          int comp = 0;
          float best = o2[0] + gumbel[rr * nc];
          for (int c = 1; c < nc; ++c) {
            const float v = o2[c] + gumbel[rr * nc + c];
            if (v > best) {
              best = v;
              comp = c;
            }
          }
          const float mu = o2[nc + comp * kIn + lane];
          const float sig = __fmul_rn(expf(-o2[nc + nc * kIn + comp * kIn + lane]), sigma_scale);
          const float x = __fadd_rn(mu, __fmul_rn(sig, eps[rr * kIn + lane]));
          sm[Smem::xprev + lane] = x;
          if (b == 0) samples[rr * kIn + lane] = x;
        }
        __syncwarp();
        if (more) start_conv1(sm, lane);
      }
      if (more) {
        bar_sync(kTailBar, kUnitWarps * 32);
        hj = start_conv2();
      }
    }
    if (b == 0 && warp == 0) {
      if (lane < kIn) x_prev[lane] = sm[Smem::xprev + lane];
      if (lane == 0) {
        *row = row0 + nn;
        *step = step0 + nn;
      }
    }
    return;
  }

  // ---- helpers: the skip rows of step t, the f / g parts of step t + 1
  const int ht = threadIdx.x - kUnitWarps * 32;
  Fetch cur = fetch(0, 1);
  for (int t = 0; t < nn; ++t) {
    const unsigned par = t & 1;
    const bool more = t + 1 < nn;
    if (t > 0) bar_sync(kRingBar + ((t - 1) & 1), kThreads);
    // x_old of step t + 1: buffer and barrier (t + 1) & 1, phase t >> 1
    const int xb = (t + 1) & 1;
    const float* xo = sm + Smem::xo + xb * kWide * kR;
    if (more) {
      // the block's 8 columns of each wide layer's x_old of step t + 1, to every block
      const unsigned long long s = (unsigned long long)step0 + t + 1;
      for (int k = ht; k < kWide * 2 * kC; k += kHelpThreads) {
        const int chunk = k % (kWide * 2), dest = k / (kWide * 2);
        const int wl = chunk / 2, l = wl + 1 + (wl >= 6 ? 1 : 0);
        const float* src = ring + (ring_off(l) + (s & (dil(l) - 1))) * kR + u0 + 4 * (chunk & 1);
        const float4 v = *reinterpret_cast<const float4*>(src);
        st_async4(map_rank(smem_u32(xo + wl * kR + u0 + 4 * (chunk & 1)), dest), v,
                  map_rank(bar_xo + 8 * xb, dest));
      }
    }
    float sk = 0.0f;  // the skip sum of row 2 hw (lanes 0-15) or 2 hw + 1
    for (int l = 0; l < kL; ++l) {
      const Fetch f = cur;
      cur = l + 1 < kL ? fetch(l + 1, t + 1) : fetch(0, t + 2);
      mbar_wait(bars + 8 * (kL + l), par);
      const float4 zv = lds4(sm + Smem::zbuf + l * kR + 4 * lane);
      sk = sk + (pair_sum(dot4(f.s0, zv, 0.0f), dot4(f.s1, zv, 0.0f), lane) + f.bs);
      if (!more) continue;
      const float* x;
      if (dil(l) == 1) {
        mbar_wait(bars + 8 * l, par);
        x = sm + Smem::hbuf + l * kR;
      } else {
        if (l == 1) {
          mbar_wait(bar_xo + 8 * xb, (t >> 1) & 1);
          if (t + 3 < nn && ht == 0) mbar_arm(bar_xo + 8 * xb, xo_bytes);  // step t + 3's
        }
        x = xo + wide(l) * kR;
      }
      const float v = xpart(f, lds4(x + 4 * lane));
      if ((lane & 15) == 0)
        sm[Smem::xpart + (((t + 1) & 1) * kL * kU + l * kU + hw) * 2 + (up ? 1 : 0)] = v;
    }
    if (more) bar_arrive(kXpartBar, kThreads);
    if ((lane & 15) == 0) sm[Smem::skact + 2 * hw + (up ? 1 : 0)] = act(sk);
    bar_sync(kHelpBar, kHelpThreads);
    // the block's share of end_conv_1, to every block
    for (int k = ht; k < E * kC; k += kHelpThreads) {
      const int e = k % E, dest = k / E;
      float v = 0.0f;
#pragma unroll
      for (int r = 0; r < kSkipRows; ++r)
        v = fmaf(sm[sl.e1() + e * kSkipRows + r], sm[Smem::skact + r], v);
      send(sm + Smem::o1 + b * E + e, v, bar_o1, dest);
    }
  }
}

}  // namespace

// The packed weights w (ops/decode_cuda.py::pack_weights); fproj, gproj
// [14, rows, 128]; gumbel [rows, ncenter], eps [rows, 12]; ring [254, 128],
// x_prev [12], samples [rows, 12]; step and row int64 [1], on the device.
// Decodes n steps from row `row`: rows row .. row + n - 1 of the inputs and
// samples (steps past `rows` are not taken), then row, step += n.
extern "C" int lsp_headpose_decode(const float* w, const float* fproj, const float* gproj,
                                   const float* gumbel, const float* eps, float* ring,
                                   float* x_prev, float* samples, long long* step,
                                   long long* row, int rows, int n, int ncenter,
                                   float sigma_scale, void* stream) {
  if (n <= 0 || rows <= 0 || ncenter < 1 || ncenter > kMaxNC) return (int)cudaErrorInvalidValue;
  const size_t bytes = sizeof(float) * (size_t)Smem{25 * ncenter}.floats();
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (bytes > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(headpose_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(headpose_decode_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;

  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kC);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, headpose_decode_kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return (int)cudaErrorLaunchOutOfResources;
  err = cudaLaunchKernelEx(&cfg, headpose_decode_kernel, w, fproj, gproj, gumbel, eps, ring, x_prev,
                           samples, step, row, rows, n, ncenter, sigma_scale);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

