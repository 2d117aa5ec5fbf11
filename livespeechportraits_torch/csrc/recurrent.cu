// K2 / K3: the whole GRU or LSTM time loop of one layer at batch 1.
//
// Replaces the Pallas TPU kernels livespeechportraits_tpu/ops/recurrent_pallas.py
// _gru_kernel (via _gru_chunk_call: the APC encoder, H=512, about 1200 steps
// for 10 s of audio) and _lstm_kernel (via _lstm_chunk_call: the Audio2Feature
// decoder, H=256).  The input projection x @ W_ih^T + b_ih is one large
// matmul outside the kernel, as in JAX; the kernel runs the recurrence
//     gates_t = xp_t (+) h_{t-1} @ W_hh^T + b_hh
// in torch's gate order (GRU: r, z, n; LSTM: i, f, g, o), all in f32 with
// expf / tanhf and a correctly rounded reciprocal (no fast-math: the error
// compounds over 1200 steps).
//
// What bounds it on the H100: the sequential dependence, not bytes or
// operations.  A step is a [1, H] x [H, G*H] product (3 MB of W_hh for the
// GRU at H=512, 1.5 MFLOP) whose result every unit of the next step needs, so
// the step time is a chain of latencies: the exchange of h between the SMs
// that hold W_hh, the signal that it has arrived, and the dot products.
//
// Two kernels; ops/recurrent_cuda.py::plan picks one from the shape alone
// and passes the plan here, where it is checked (never a fallback).
//
// rnn_cluster_kernel (H <= 512): ONE thread-block cluster of C <= 16 blocks,
// one block per SM, 16 warps a block.  Block b owns U = 16 * UW consecutive
// units (UW = 1 or 2 a warp; the plan takes 1 where it fits, which measured
// faster), and warp w of it owns UW units with all their G gates: G * UW
// rows of W_hh, each cut along k into KV = ceil(H / 128) float4 columns a
// lane.  The first kRegRows rows of each warp live in registers for the
// whole sequence (at most 64 floats a thread, fully unrolled so every index
// is a compile-time constant), the rest in shared memory; W_hh is read from
// device memory once.  GRU H=512: C=16, 32 units a block, 6 rows a warp, 4
// in registers and 2 in shared memory.  LSTM H=256: C=16, 16 units a block,
// 4 rows a warp, all in registers.  A step:
//   1. every warp waits on its block's mbarrier for h_{t-1}, reads it from
//      its block's own shared-memory buffer (KV float4 a lane, one live at a
//      time) and forms its rows' partial dot products;
//   2. the warp reduces its rows by recursive halving (9 shuffles for 8
//      rows instead of 40 for 8 butterflies), writes the gate sums to shared
//      memory and arrives at a named barrier without waiting;
//   3. warp 0 waits at that barrier, and lane u updates unit u of the block
//      (xp_t and b_hh already in shared memory, c_t in a register), writes
//      ys[t] (never read back), and the lanes send the block's units in
//      16-byte chunks with st.async (distributed shared memory) to the h
//      buffer of every block of the cluster, each store counting its bytes
//      on that block's mbarrier (mbarrier::complete_tx).
// No barrier joins the blocks during the sequence: a block's warps go on as
// soon as all 4 * H bytes of h_{t-1} have landed in their own block.  xp_t
// of the block's units does not depend on h: warp 0 brings it kRing - 1
// steps ahead with cp.async into a ring in shared memory.  Nothing off chip
// is on the critical path.
//
// Why two h buffers and no barrier are race-free: h_t goes to buffer
// (t + 1) & 1 of every block and is phase t >> 1 of that buffer's mbarrier,
// armed once a phase (arrive.expect_tx of 4 * H bytes) by thread 0 after it
// has seen the phase before complete.  A block writes h_{t+1} into a peer's
// buffer t & 1 only after it has received h_t from every block, and each
// block sends its h_t only after all its warps have read h_{t-1} from buffer
// t & 1 (the sums they post behind the named barrier are computed from what
// they read), so the write cannot overtake a read.  For the same reason no
// phase can complete twice before a slow warp waits on it, so a parity wait
// is exact, and no warp posts the sums of step t + 1 before warp 0 has read
// those of step t.  The mbarrier's complete_tx and the waiter's acquire make
// the stores visible.  One cluster barrier after the set-up makes sure every
// block is running and its mbarriers initialised before a peer writes into
// it, and every block waits for the last phase before it exits, so no store
// lands in a block that has left.
//
// What bounds it: the step is a chain of latencies (the st.async ->
// mbarrier signal, the dot products, the update's transcendentals), not
// bytes or issue slots.  In trial runs on the H100, a one-block cluster
// that did no dot products and no gate update still took a large part of
// the GRU's step; 8 warps with most of W_hh in registers (far fewer
// shared-memory reads) gained little; plain remote stores signalled by a
// release-add on a counter were slower (PERF.md).
//
// Registers (ptxas -v, sm_90a, CUDA 12.8; chip_smoke.py prints them and
// fails on a spill): the main-path instances use 128 (GRU, H=512) and 80
// (LSTM, H=256) registers a thread.  The 8-rows-of-512 instance (LSTM at
// H > 384) keeps 48 floats in registers instead of 64, or it would spill.
//
// rnn_grid_kernel (the shapes the cluster cannot hold, e.g. a GRU at
// H = 1024: 12 MB of W_hh): a cooperative persistent grid, at most one block
// per SM.  Block b owns U units and keeps their G*U rows of W_hh in shared
// memory; each step it re-reads h_{t-1} from row t-1 of ys through L2
// (__ldcg: L1 is not coherent across SMs), one warp a row, and the grid
// synchronises.  The launch is refused when the blocks cannot all be
// resident, since a cooperative grid that is not co-resident would deadlock.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;

// 1 / (1 + e^-x), the reciprocal rounded to nearest as a division by it would be
__device__ __forceinline__ float sigmoid(float x) { return __frcp_rn(1.0f + expf(-x)); }

// ---------------------------------------------------------------- grid kernel

constexpr int kGridThreads = 256;

// G = 3: GRU, G = 4: LSTM.  Shared memory: w [G*U, H], h [H], pre [G*U], c [U].
template <int G>
__global__ void __launch_bounds__(kGridThreads)
rnn_grid_kernel(const float* __restrict__ xp, const float* __restrict__ w_hh,
                const float* __restrict__ b_hh, const float* __restrict__ h0,
                const float* __restrict__ c0, float* ys, float* hT, float* cT, int T, int H,
                int U) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  const int R = G * U;
  float* w = smem;
  float* h = w + (size_t)R * H;
  float* pre = h + H;
  float* c = pre + R;

  const int u0 = blockIdx.x * U;
  const int nu = min(U, H - u0);
  for (int i = threadIdx.x; i < R * H; i += kGridThreads) {
    const int r = i / H, k = i - r * H;
    const int g = r / U, u = r - g * U;
    w[i] = u < nu ? w_hh[((size_t)g * H + u0 + u) * H + k] : 0.0f;
  }
  if constexpr (G == 4) {
    for (int u = threadIdx.x; u < nu; u += kGridThreads) c[u] = c0[u0 + u];
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int t = 0; t < T; ++t) {
    const float* h_prev = t == 0 ? h0 : ys + (size_t)(t - 1) * H;
    for (int k = threadIdx.x; k < H; k += kGridThreads) h[k] = __ldcg(h_prev + k);
    __syncthreads();

    for (int r = warp; r < R; r += kGridThreads / 32) {
      const float* wr = w + (size_t)r * H;
      float acc = 0.0f;
      for (int k = lane; k < H; k += 32) acc += wr[k] * h[k];
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(kFull, acc, off);
      if (lane == 0) pre[r] = acc;
    }
    __syncthreads();

    const float* x = xp + (size_t)t * G * H;
    for (int u = threadIdx.x; u < nu; u += kGridThreads) {
      const int j = u0 + u;
      float h_new;
      if constexpr (G == 3) {
        const float hr = pre[u] + b_hh[j];
        const float hz = pre[U + u] + b_hh[H + j];
        const float hn = pre[2 * U + u] + b_hh[2 * H + j];
        const float r = sigmoid(x[j] + hr);
        const float z = sigmoid(x[H + j] + hz);
        const float n = tanhf(x[2 * H + j] + r * hn);
        h_new = (1.0f - z) * n + z * h[j];
      } else {
        const float gi = sigmoid(x[j] + pre[u] + b_hh[j]);
        const float gf = sigmoid(x[H + j] + pre[U + u] + b_hh[H + j]);
        const float gg = tanhf(x[2 * H + j] + pre[2 * U + u] + b_hh[2 * H + j]);
        const float go = sigmoid(x[3 * H + j] + pre[3 * U + u] + b_hh[3 * H + j]);
        const float c_new = gf * c[u] + gi * gg;
        c[u] = c_new;
        h_new = go * tanhf(c_new);
        if (t == T - 1) cT[j] = c_new;
      }
      ys[(size_t)t * H + j] = h_new;
      if (t == T - 1) hT[j] = h_new;
    }
    grid.sync();
  }
}

template <int G>
int launch_grid(const float* xp, const float* w_hh, const float* b_hh, const float* h0,
                const float* c0, float* ys, float* hT, float* cT, int T, int H, int U,
                cudaStream_t stream) {
  int dev = 0, n_sm = 0, coop = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (!coop) return (int)cudaErrorNotSupported;

  const int n_blocks = (H + U - 1) / U;
  const size_t smem = ((size_t)G * U * H + H + (size_t)G * U + U) * sizeof(float);
  if (smem > (size_t)max_smem) return (int)cudaErrorCooperativeLaunchTooLarge;
  err = cudaFuncSetAttribute(rnn_grid_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rnn_grid_kernel<G>, kGridThreads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  if (n_blocks > per_sm * n_sm) return (int)cudaErrorCooperativeLaunchTooLarge;

  int T_ = T, H_ = H, U_ = U;
  void* args[] = {(void*)&xp, (void*)&w_hh, (void*)&b_hh, (void*)&h0, (void*)&c0,
                  (void*)&ys, (void*)&hT, (void*)&cT, (void*)&T_, (void*)&H_, (void*)&U_};
  err = cudaLaunchCooperativeKernel((const void*)rnn_grid_kernel<G>, dim3(n_blocks),
                                    dim3(kGridThreads), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------- cluster kernel

constexpr int kWarps = 16;                    // warps a block
constexpr int kClusterThreads = kWarps * 32;
// W_hh floats a thread keeps in registers: 64, but 48 for a warp of 8 rows
// of 512 (its 8 sums and the loads of 4 shared-memory rows need the rest of
// the 128 registers a thread of a 512-thread block may have)
constexpr int kRegFloats = 64;
constexpr int kRegFloats8x512 = 48;
constexpr int kRing = 8;                      // xp steps in flight, this one included
static_assert((kRing & (kRing - 1)) == 0, "the ring is indexed by t & (kRing - 1)");
constexpr int kMaxCluster = 16;
constexpr int kMaxKV = 4;                     // H <= 512

template <int G, int KV, int UW>
struct Tile {
  static constexpr int kRows = G * UW;  // rows of W_hh a warp
  static constexpr int kRegCap = (kRows == 8 && KV == 4 ? kRegFloats8x512 : kRegFloats) / (4 * KV);
  static constexpr int kRegRows = kRows < kRegCap ? kRows : kRegCap;
  static constexpr int kSmemRows = kRows - kRegRows;
  static constexpr int kLevels = kRows <= 2 ? 1 : kRows <= 4 ? 2 : 3;  // halving levels
  static constexpr int kPad = 1 << kLevels;
  static constexpr int kK = KV * 128;  // h padded to whole float4 columns of a warp
  static constexpr int kU = kWarps * UW;  // units a block
  // two mbarriers (16 bytes), h [2][kK], w [kSmemRows][kWarps][kK],
  // ring [kRing][G][kU], pre and bias [G][kU]
  // (ops/recurrent_cuda.py::cluster_smem_bytes)
  static constexpr size_t kSmemBytes =
      16 + sizeof(float) * (2 * kK + (size_t)kSmemRows * kWarps * kK + (kRing + 2) * G * kU);
  static_assert(kRows <= 8 && kU <= 32, "at most 8 rows a warp, one unit a lane of warp 0");
};

__device__ __forceinline__ void cp_async4(unsigned dst, const float* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// The address of the same shared-memory location in block `rank` of the cluster.
__device__ __forceinline__ unsigned map_rank(unsigned addr, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// Store v at a (maybe remote) cluster address and count its 4 bytes on the
// mbarrier of the block that holds it.
__device__ __forceinline__ void st_async(unsigned addr, float v, unsigned mbar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(
                   addr),
               "r"(__float_as_uint(v)), "r"(mbar)
               : "memory");
}

// The same for four floats at a 16-byte aligned address.
__device__ __forceinline__ void st_async4(unsigned addr, const float (&v)[4], unsigned mbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(addr),
      "r"(__float_as_uint(v[0])), "r"(__float_as_uint(v[1])), "r"(__float_as_uint(v[2])),
      "r"(__float_as_uint(v[3])), "r"(mbar)
      : "memory");
}

// Named barrier 1 over the whole block: the gate sums are in shared memory.
__device__ __forceinline__ void sums_posted() {
  asm volatile("bar.arrive 1, %0;\n" ::"n"(kClusterThreads) : "memory");
}
__device__ __forceinline__ void wait_sums() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kClusterThreads) : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned mbar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(mbar) : "memory");
}

// The one arrival of a phase, expecting `bytes` of st.async data.
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

template <int G, int KV, int UW>
__global__ void __launch_bounds__(kClusterThreads, 1)
rnn_cluster_kernel(const float* __restrict__ xp, const float* __restrict__ w_hh,
                   const float* __restrict__ b_hh, const float* __restrict__ h0,
                   const float* __restrict__ c0, float* __restrict__ ys, float* __restrict__ hT,
                   float* __restrict__ cT, int T, int H) {
  using S = Tile<G, KV, UW>;
  constexpr int K = S::kK;
  constexpr int U = S::kU;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();

  extern __shared__ float4 csm[];
  // mbar[b] counts the bytes of h_t landing in buffer b = (t + 1) & 1
  const unsigned mbar0 = smem_u32(csm);
  float* hbuf = reinterpret_cast<float*>(csm + 1);
  float* wsm = hbuf + 2 * K;
  float* ring = wsm + S::kSmemRows * kWarps * K;  // [kRing][G][U]
  float* pre = ring + kRing * G * U;               // [G][U]
  float* bias = pre + G * U;                       // [G][U]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int u0 = rank * U;
  const int wu0 = u0 + warp * UW;  // the warp's first unit; slot s = ui * G + g

  // W_hh rows: registers, then shared memory; zero past H (ragged units and k)
  auto load_row = [&](int s, int j) {
    const int unit = wu0 + s / G;
    const float* row = w_hh + ((size_t)(s % G) * H + unit) * H;
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = j * 128 + lane * 4 + e;
      v[e] = unit < H && k < H ? row[k] : 0.0f;
    }
    return make_float4(v[0], v[1], v[2], v[3]);
  };
  float4 wr[S::kRegRows][KV];
#pragma unroll
  for (int s = 0; s < S::kRegRows; ++s) {
#pragma unroll
    for (int j = 0; j < KV; ++j) wr[s][j] = load_row(s, j);
  }
#pragma unroll
  for (int s = S::kRegRows; s < S::kRows; ++s) {
#pragma unroll
    for (int j = 0; j < KV; ++j) {
      float* dst = wsm + ((s - S::kRegRows) * kWarps + warp) * K + j * 128 + lane * 4;
      *reinterpret_cast<float4*>(dst) = load_row(s, j);
    }
  }
  for (int i = threadIdx.x; i < G * U; i += kClusterThreads) {
    const int g = i / U, unit = u0 + i % U;
    bias[i] = unit < H ? b_hh[g * H + unit] : 0.0f;
  }
  for (int k = threadIdx.x; k < K; k += kClusterThreads) {
    hbuf[k] = k < H ? h0[k] : 0.0f;
    hbuf[K + k] = 0.0f;
  }
  if (threadIdx.x == 0) {
    mbar_init(mbar0);
    mbar_init(mbar0 + 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // Warp 0 updates the block's units, lane u unit u0 + u, and sends them:
  // lane l sends 4-unit chunk q = l % (U / 4) to blocks l / (U / 4), then
  // every 128 / U blocks further.
  constexpr int kChunks = U / 4;
  const int j = u0 + lane;
  const bool mine = warp == 0 && lane < U && j < H;
  const int q = lane % kChunks;
  const int nq = min(4, H - (u0 + 4 * q));  // units of chunk q (ragged end of H)
  float c = 0.0f;
  if constexpr (G == 4) {
    if (mine) c = c0[j];
  }
  // xp_t of the block's units (warp 0), kRing - 1 steps ahead, zero past T or H
  const int xoff = lane < U ? u0 + lane : u0;
  const unsigned xdst = smem_u32(ring + lane);
  auto issue = [&](int t) {
    if (lane < U) {
      const bool ok = t < T && u0 + lane < H;
#pragma unroll
      for (int g = 0; g < G; ++g)
        cp_async4(xdst + 4 * ((t & (kRing - 1)) * G + g) * U,
                  ok ? xp + (size_t)t * G * H + (size_t)g * H + xoff : xp, ok);
    }
    cp_async_commit();
  };
  if (warp == 0) {
#pragma unroll
    for (int t = 0; t < kRing - 1; ++t) issue(t);
  }

  cluster.sync();  // every block is running, its buffers zeroed, its mbarriers set

  const unsigned bytes = 4u * H;
  float h_new = 0.0f;
  for (int t = 0; t < T; ++t) {
    const int cur = t & 1;
    // h_t is phase t >> 1 of mbar[(t + 1) & 1]
    if (t > 0) mbar_wait(mbar0 + 8 * cur, ((t - 1) >> 1) & 1);  // h_{t-1} has landed
    if (threadIdx.x == 0) mbar_arm(mbar0 + 8 * (cur ^ 1), bytes);  // h_t will
    const float* hc = hbuf + cur * K;

    float acc[S::kPad];
#pragma unroll
    for (int s = 0; s < S::kPad; ++s) acc[s] = 0.0f;
#pragma unroll
    for (int jj = 0; jj < KV; ++jj) {  // one float4 of h live at a time
      const float4 hv = *reinterpret_cast<const float4*>(hc + jj * 128 + lane * 4);
#pragma unroll
      for (int s = 0; s < S::kRegRows; ++s) acc[s] = dot4(wr[s][jj], hv, acc[s]);
#pragma unroll
      for (int s = S::kRegRows; s < S::kRows; ++s) {
        const float* w = wsm + ((s - S::kRegRows) * kWarps + warp) * K + jj * 128 + lane * 4;
        acc[s] = dot4(*reinterpret_cast<const float4*>(w), hv, acc[s]);
      }
    }

    // Recursive halving: at the level of offset o the lanes with bit o set
    // keep the upper half of the rows, the others the lower half, each
    // adding its partner's copy.  Then lane l holds row l >> (5 - kLevels)
    // summed over its 2^kLevels partners; butterflies over the low bits
    // finish the sum.
#pragma unroll
    for (int lv = 0; lv < S::kLevels; ++lv) {
      const int off = 16 >> lv;
      const bool upper = lane & off;
      const int n = S::kPad >> (lv + 1);
#pragma unroll
      for (int i = 0; i < n; ++i) {
        const float send = upper ? acc[i] : acc[i + n];
        const float keep = upper ? acc[i + n] : acc[i];
        acc[i] = keep + __shfl_xor_sync(kFull, send, off);
      }
    }
    float v = acc[0];
#pragma unroll
    for (int off = 16 >> S::kLevels; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
    const int row = lane >> (5 - S::kLevels);
    if ((lane & ((32 >> S::kLevels) - 1)) == 0 && row < S::kRows)
      pre[(row % G) * U + warp * UW + row / G] = v;
    if (warp != 0) {  // on to the next step; warp 0 does the update
      sums_posted();
      continue;
    }

    issue(t + kRing - 1);
    wait_sums();
    cp_async_wait<kRing - 1>();  // this lane's copies of xp_t have landed
    if (mine) {
      const float* x = ring + (t & (kRing - 1)) * G * U + lane;
      const float* p = pre + lane;
      const float* b = bias + lane;
      if constexpr (G == 3) {
        const float r = sigmoid(x[0] + (p[0] + b[0]));
        const float z = sigmoid(x[U] + (p[U] + b[U]));
        const float n = tanhf(x[2 * U] + r * (p[2 * U] + b[2 * U]));
        h_new = (1.0f - z) * n + z * hc[j];
      } else {
        const float gi = sigmoid(x[0] + (p[0] + b[0]));
        const float gf = sigmoid(x[U] + (p[U] + b[U]));
        const float gg = tanhf(x[2 * U] + (p[2 * U] + b[2 * U]));
        const float go = sigmoid(x[3 * U] + (p[3 * U] + b[3 * U]));
        c = gf * c + gi * gg;
        h_new = go * tanhf(c);
      }
      ys[(size_t)t * H + j] = h_new;
    }
    float hq[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) hq[k] = __shfl_sync(kFull, h_new, 4 * q + k);
    if (nq > 0) {
      const unsigned a = smem_u32(hbuf + (cur ^ 1) * K + u0 + 4 * q);
      for (int d = lane / kChunks; d < C; d += 32 / kChunks) {
        const unsigned m = map_rank(mbar0 + 8 * (cur ^ 1), d), ad = map_rank(a, d);
        if (nq == 4) {
          st_async4(ad, hq, m);
        } else {
#pragma unroll
          for (int k = 0; k < 3; ++k)
            if (k < nq) st_async(ad + 4 * k, hq[k], m);
        }
      }
    }
    __syncwarp();  // warp 0's reads of pre and of the ring slot are done
  }
  // stay resident until the peers' last stores into this block have landed
  mbar_wait(mbar0 + 8 * (T & 1), ((T - 1) >> 1) & 1);
  if (warp == 0) cp_async_wait<0>();
  if (mine) {
    hT[j] = h_new;
    if constexpr (G == 4) cT[j] = c;
  }
}

template <int G, int KV, int UW>
int launch_cluster(const float* xp, const float* w_hh, const float* b_hh, const float* h0,
                   const float* c0, float* ys, float* hT, float* cT, int T, int H, int C,
                   int reg_rows, cudaStream_t stream) {
  using S = Tile<G, KV, UW>;
  if (reg_rows != S::kRegRows) return (int)cudaErrorInvalidValue;
  auto kernel = rnn_cluster_kernel<G, KV, UW>;
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (S::kSmemBytes > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)S::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;

  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = S::kSmemBytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return (int)cudaErrorLaunchOutOfResources;
  err = cudaLaunchKernelEx(&cfg, kernel, xp, w_hh, b_hh, h0, c0, ys, hT, cT, T, H);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int G, int UW>
int dispatch_kv(const float* xp, const float* w_hh, const float* b_hh, const float* h0,
                const float* c0, float* ys, float* hT, float* cT, int T, int H, int C,
                int reg_rows, cudaStream_t stream) {
  switch ((H + 127) / 128) {
    case 1: return launch_cluster<G, 1, UW>(xp, w_hh, b_hh, h0, c0, ys, hT, cT, T, H, C, reg_rows, stream);
    case 2: return launch_cluster<G, 2, UW>(xp, w_hh, b_hh, h0, c0, ys, hT, cT, T, H, C, reg_rows, stream);
    case 3: return launch_cluster<G, 3, UW>(xp, w_hh, b_hh, h0, c0, ys, hT, cT, T, H, C, reg_rows, stream);
    case 4: return launch_cluster<G, 4, UW>(xp, w_hh, b_hh, h0, c0, ys, hT, cT, T, H, C, reg_rows, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The plan (ops/recurrent_cuda.py::plan): cluster > 0 runs the cluster kernel
// with that many blocks of `units` units (16 or 32) and `reg_rows` register
// rows a warp; cluster == 0 runs the grid kernel with `units` units a block.
template <int G>
int launch_rnn(const float* xp, const float* w_hh, const float* b_hh, const float* h0,
               const float* c0, float* ys, float* hT, float* cT, int T, int H, int cluster,
               int units, int reg_rows, cudaStream_t stream) {
  if (T <= 0 || H <= 0 || units <= 0) return (int)cudaErrorInvalidValue;
  if (cluster == 0) return launch_grid<G>(xp, w_hh, b_hh, h0, c0, ys, hT, cT, T, H, units, stream);
  if (cluster > kMaxCluster || H > kMaxKV * 128 || cluster != (H + units - 1) / units)
    return (int)cudaErrorInvalidValue;
  if (units == kWarps)
    return dispatch_kv<G, 1>(xp, w_hh, b_hh, h0, c0, ys, hT, cT, T, H, cluster, reg_rows, stream);
  if (units == 2 * kWarps)
    return dispatch_kv<G, 2>(xp, w_hh, b_hh, h0, c0, ys, hT, cT, T, H, cluster, reg_rows, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// xp [T, 3H], w_hh [3H, H] (torch layout), b_hh [3H], h0 [H] -> ys [T, H], hT [H].
extern "C" int lsp_gru(const float* xp, const float* w_hh, const float* b_hh, const float* h0,
                       float* ys, float* hT, int T, int H, int cluster, int units, int reg_rows,
                       void* stream) {
  return launch_rnn<3>(xp, w_hh, b_hh, h0, nullptr, ys, hT, nullptr, T, H, cluster, units,
                       reg_rows, (cudaStream_t)stream);
}

// xp [T, 4H], w_hh [4H, H], b_hh [4H], h0/c0 [H] -> ys [T, H], hT [H], cT [H].
extern "C" int lsp_lstm(const float* xp, const float* w_hh, const float* b_hh, const float* h0,
                        const float* c0, float* ys, float* hT, float* cT, int T, int H,
                        int cluster, int units, int reg_rows, void* stream) {
  return launch_rnn<4>(xp, w_hh, b_hh, h0, c0, ys, hT, cT, T, H, cluster, units, reg_rows,
                       (cudaStream_t)stream);
}

// The opt-in shared memory a block may use on the current device, in bytes
// (the plan's budget), or -1 when the device cannot be queried.
extern "C" int lsp_smem_optin(void) {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return -1;
  return bytes;
}
