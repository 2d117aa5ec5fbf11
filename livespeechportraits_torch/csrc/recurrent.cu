// K2 / K3: the whole GRU or LSTM time loop of one layer at batch 1.
//
// Replaces the Pallas TPU kernels livespeechportraits_tpu/ops/recurrent_pallas.py
// _gru_kernel (via _gru_chunk_call: the APC encoder, H=512, about 1200 steps
// for 10 s of audio) and _lstm_kernel (via _lstm_chunk_call: the Audio2Feature
// decoder, H=256).  The input projection x @ W_ih^T + b_ih is one large
// matmul outside the kernel, as in JAX; the kernel runs the recurrence
//     gates_t = xp_t (+) h_{t-1} @ W_hh^T + b_hh
// in torch's gate order (GRU: r, z, n; LSTM: i, f, g, o), all in f32.
//
// What bounds it on the H100: the sequential dependence.  Each step is a
// [1, H] x [H, G*H] product (3 MB of W_hh for the GRU at H=512) that no single
// SM can hold, and a plain loop pays several kernel launches per step.
// Streaming W_hh from L2 through one SM would cost about 30 us a step.
//
// Design: a cooperative persistent grid, at most one block per SM.  Block b
// owns U consecutive hidden units and keeps the matching G*U rows of W_hh (all
// gates) in shared memory for the whole sequence: W_hh is read from device
// memory once.  Each step a block reads h_{t-1} (H floats) from global memory,
// computes its G*U gate pre-activations with one warp per row, updates its
// units (the LSTM cell state never leaves the block), writes h_t, and the grid
// synchronises.  h_{t-1} is read from row t-1 of the output sequence itself,
// so every step reads a row that no block writes during that step (an
// unbounded version of a double buffer); loads bypass L1 (__ldcg) because L1
// is not coherent across SMs.  The grid is sized from the occupancy query and
// the launch is refused with cudaErrorCooperativeLaunchTooLarge when the
// blocks cannot all be resident, since a cooperative grid that is not
// co-resident would deadlock.  The per-step cost is about one grid barrier.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// G = 3: GRU, G = 4: LSTM.  Shared memory: w [G*U, H], h [H], pre [G*U], c [U].
template <int G>
__global__ void __launch_bounds__(kThreads)
rnn_kernel(const float* __restrict__ xp, const float* __restrict__ w_hh,
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
  for (int i = threadIdx.x; i < R * H; i += kThreads) {
    const int r = i / H, k = i - r * H;
    const int g = r / U, u = r - g * U;
    w[i] = u < nu ? w_hh[((size_t)g * H + u0 + u) * H + k] : 0.0f;
  }
  if constexpr (G == 4) {
    for (int u = threadIdx.x; u < nu; u += kThreads) c[u] = c0[u0 + u];
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int t = 0; t < T; ++t) {
    const float* h_prev = t == 0 ? h0 : ys + (size_t)(t - 1) * H;
    for (int k = threadIdx.x; k < H; k += kThreads) h[k] = __ldcg(h_prev + k);
    __syncthreads();

    for (int r = warp; r < R; r += kThreads / 32) {
      const float* wr = w + (size_t)r * H;
      float acc = 0.0f;
      for (int k = lane; k < H; k += 32) acc += wr[k] * h[k];
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
      if (lane == 0) pre[r] = acc;
    }
    __syncthreads();

    const float* x = xp + (size_t)t * G * H;
    for (int u = threadIdx.x; u < nu; u += kThreads) {
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
int launch_rnn(const float* xp, const float* w_hh, const float* b_hh, const float* h0,
               const float* c0, float* ys, float* hT, float* cT, int T, int H,
               cudaStream_t stream) {
  if (T <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  int dev = 0, n_sm = 0, coop = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (!coop) return (int)cudaErrorNotSupported;

  // Units per block: at most one block per SM keeps the grid barrier cheap.
  const int U = (H + n_sm - 1) / n_sm;
  const int n_blocks = (H + U - 1) / U;
  const size_t smem = ((size_t)G * U * H + H + (size_t)G * U + U) * sizeof(float);
  if (smem > (size_t)max_smem) return (int)cudaErrorCooperativeLaunchTooLarge;
  err = cudaFuncSetAttribute(rnn_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rnn_kernel<G>, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (n_blocks > per_sm * n_sm) return (int)cudaErrorCooperativeLaunchTooLarge;

  int T_ = T, H_ = H, U_ = U;
  void* args[] = {(void*)&xp, (void*)&w_hh, (void*)&b_hh, (void*)&h0, (void*)&c0,
                  (void*)&ys, (void*)&hT, (void*)&cT, (void*)&T_, (void*)&H_, (void*)&U_};
  err = cudaLaunchCooperativeKernel((const void*)rnn_kernel<G>, dim3(n_blocks), dim3(kThreads),
                                    args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// xp [T, 3H], w_hh [3H, H] (torch layout), b_hh [3H], h0 [H] -> ys [T, H], hT [H].
extern "C" int lsp_gru(const float* xp, const float* w_hh, const float* b_hh, const float* h0,
                       float* ys, float* hT, int T, int H, void* stream) {
  return launch_rnn<3>(xp, w_hh, b_hh, h0, nullptr, ys, hT, nullptr, T, H,
                       (cudaStream_t)stream);
}

// xp [T, 4H], w_hh [4H, H], b_hh [4H], h0/c0 [H] -> ys [T, H], hT [H], cT [H].
extern "C" int lsp_lstm(const float* xp, const float* w_hh, const float* b_hh, const float* h0,
                        const float* c0, float* ys, float* hT, float* cT, int T, int H,
                        void* stream) {
  return launch_rnn<4>(xp, w_hh, b_hh, h0, c0, ys, hT, cT, T, H, (cudaStream_t)stream);
}
