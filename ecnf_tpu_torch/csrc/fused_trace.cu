// The flat EGNN field and its full exact divergence in one launch, f32.
//
// Replaces the Pallas kernel `_trace_kernel` dispatched by
// `egnn_value_and_div_fused` in ecnf_tpu/ops/pallas/attic/trace_kernel.py.
// For x [B, N*D] it returns v = f(x) and div[b] = sum_c (J e_c)_c over all
// N*D identity columns e_c.  Pallas derives the tangent program with an
// in-kernel `jax.linearize`; CUDA has none, so every tangent rule is
// written out (egnn_device.cuh, the rules of `ecnf_tpu_torch/ops/
// tangent.py`), with the tangent taken as 0 where the distance clamp is
// inactive (raw <= 0) and where l2 == 0.
//
// Design: one thread block per (chunk of C columns, sample b).  It holds
// all N nodes of its sample and, for its C columns, the node tangents
// (vec_t [N, D], h_t [N, H]) in shared memory, and loops over the EGNN
// blocks and, inside each, over the receivers.  For receiver i it
// recomputes the primal edge rows of i next to the C tangent rows of every
// sender (S = C + 1 slots through each layer together), so no residual is
// stored: a block's shared memory is a few [S * N, U] tiles.  Because a
// thread block holds the whole sample, nothing needs a grid-wide barrier
// between EGNN blocks.  Recomputing the primal costs 1/C of the tangent
// work; C is chosen from the card's SM count and the shared memory a slot
// needs (`ecnf_fused_trace_columns`).  div is summed without float
// atomics: each block writes its chunk's partial sum, and a second small
// kernel adds a sample's partials in chunk order, so two runs agree bit
// for bit.
//
// What bounds it on an H100: f32 FMAs on the CUDA cores.  At LJ13 width
// (N=13, D=3, H=64, U=128, three blocks of [128]*3, B=48) one launch is
// ~170 GFLOP (B N^2 edge rows x 39 columns x 3 blocks through a [64, 128]
// and five [128, 128] layers) against a few MB of memory traffic; each
// weight float4 read feeds up to 64 FMAs.

#include <cuda_runtime.h>

#include <climits>

#include "egnn_device.cuh"

namespace {

using namespace ecnf;

constexpr int kThreads = 512;
// Rows per thread of the edge passes: one kernel per choice.
constexpr int kRowChoices[] = {4, 8, 12, 16};

template <int R>
__global__ void __launch_bounds__(kThreads, 1)
    fused_trace_kernel(const Dims d, const Layout y, const Plan p, int n_blocks,
                       int cols, int group, const float* x, const float* h0,
                       const float* temb, const float* W, const float* fs,
                       float* v, float* partial) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int N = d.N, D = d.D, H = d.H, ND = N * D;
  const int q = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = q * cols;
  const int nc = min(cols, ND - k0);
  const int S = nc + 1;
  const int tid = threadIdx.x;
  float* vec = sm + p.vec;
  float* vec_new = sm + p.vec_new;
  float* init_vec = sm + p.init_vec;
  float* pos_mean = sm + p.pos_mean;
  float* hb = sm + p.hb;
  const float inv_n = 1.f / static_cast<float>(N);

  for (int idx = tid; idx < ND; idx += kThreads)
    vec[idx] = x[static_cast<size_t>(b) * ND + idx];
  for (int idx = tid; idx < d.T; idx += kThreads)
    sm[p.temb + idx] = temb[static_cast<size_t>(b) * d.T + idx];
  for (int idx = tid; idx < S * N * H; idx += kThreads) {
    const int row = idx / H;
    hb[row * p.lh + idx - row * H] =
        idx < N * H ? h0[static_cast<size_t>(b) * N * H + idx] : 0.f;
  }
  __syncthreads();
  if (tid < D) {
    float s = 0.f;
    for (int j = 0; j < N; ++j) s += vec[j * D + tid];
    pos_mean[tid] = s / static_cast<float>(N);
  }
  __syncthreads();
  // Primal: vec = pos - mean.  Column k = node n, dim c seeds the tangent
  // e_k - mean(e_k): the zero-CoM projection of the one-hot direction.
  for (int idx = tid; idx < S * ND; idx += kThreads) {
    const int s = idx / ND;
    const int e = idx - s * ND;
    const int c = e % D;
    if (s == 0) {
      vec[e] -= pos_mean[c];
      init_vec[e] = vec[e];
    } else {
      const int k = k0 + s - 1;
      vec[idx] = (e == k ? 1.f : 0.f) - (c == k % D ? inv_n : 0.f);
    }
  }
  __syncthreads();

  for (int blk = 0; blk < n_blocks; ++blk) {
    const float* Wb = W + static_cast<size_t>(blk) * y.size;
    block_prologue<kThreads, R>(d, y, Wb, sm, p, S);
    for (int i = 0; i < N; ++i) {
      const int i0 = i - i % group;
      receiver_pass<kThreads, R>(d, y, Wb, sm, p, S, i, vec, vec_new + i * D, ND,
                                 sm + p.mi + (i - i0) * p.lu, group * p.lu);
      if (i - i0 + 1 == group || i == N - 1)
        node_update<kThreads, R>(d, y, Wb, sm, p, S, i - i0 + 1, sm + p.mi, group,
                                 sm + p.hc + i0 * p.lh, N * p.lh, hb + i0 * p.lh,
                                 p.lh, N * p.lh);
    }
    float* tmp = vec;
    vec = vec_new;
    vec_new = tmp;
  }

  // Output: f(x) = (vec - vec_0 - pos_mean) * fs; the column's diagonal
  // entry of J e_k = (vec_t - (e - mean e) - mean e) * fs.
  const float f = *fs;
  if (q == 0)
    for (int idx = tid; idx < ND; idx += kThreads)
      v[static_cast<size_t>(b) * ND + idx] =
          ((vec[idx] - init_vec[idx]) - pos_mean[idx % D]) * f;
  if (tid == 0) {
    float acc = 0.f;
    for (int s = 1; s < S; ++s) {
      const int k = k0 + s - 1;
      acc += ((vec[s * ND + k] - (1.f - inv_n)) - inv_n) * f;
    }
    partial[static_cast<size_t>(b) * gridDim.x + q] = acc;
  }
}

__global__ void sum_partials(int B, int Q, const float* partial, float* div) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float acc = 0.f;
  for (int q = 0; q < Q; ++q) acc += partial[static_cast<size_t>(b) * Q + q];
  div[b] = acc;
}

// Rows per thread of the edge passes for S slots (0: too many slots).
// The node passes take one row per thread, so S may not exceed the row
// groups of a pass over U or H outputs.
int edge_rows(const Dims& d, int S) {
  const int G = row_groups(kThreads, d.U);
  if (S > G || S > row_groups(kThreads, d.H)) return 0;
  for (int R : kRowChoices)
    if (R * G >= S * d.N) return R;
  return 0;
}

size_t smem_bytes(const Dims& d, int S, int group) {
  return static_cast<size_t>(make_plan(d, S, group).total) * sizeof(float);
}

// Receivers per phi_h batch: all N when they fit in shared memory with S
// slots, else the most that do (0 if not even one).
int group_size(const Dims& d, int S, int smem_limit) {
  for (int g = d.N; g >= 1; --g)
    if (smem_bytes(d, S, g) <= static_cast<size_t>(smem_limit)) return g;
  return 0;
}

int smem_limit() {
  int dev = 0, smem = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return smem;
}

template <int R>
cudaError_t launch(const Dims& d, int n_blocks, int cols, int group, int B,
                   const float* x, const float* h0, const float* temb,
                   const float* w, const float* fs, float* v, float* partial,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(d, cols + 1, group);
  cudaError_t err = cudaFuncSetAttribute(
      fused_trace_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int Q = (d.N * d.D + cols - 1) / cols;
  fused_trace_kernel<R><<<dim3(Q, B), kThreads, smem, stream>>>(
      d, make_layout(d.H, d.T, d.U, d.L), make_plan(d, cols + 1, group), n_blocks,
      cols, group, x, h0, temb, w, fs, v, partial);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ecnf_weight_floats(int H, int T, int U, int L) {
  return make_layout(H, T, U, L).size;
}

// Columns per thread block: the C that minimises (thread blocks on the
// busiest SM) x (padded edge rows per receiver + 2 N, a rough price of a
// receiver's node-level work and barriers), within the shared memory.
// 0 if the shapes are not supported.
extern "C" int ecnf_fused_trace_columns(int B, int N, int D, int H, int T,
                                        int U) {
  if (B < 1 || !supported(N, D, H, T, U, 1)) return 0;
  int dev = 0, sms = 0;
  const int smem = smem_limit();
  if (smem == 0 || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  const Dims d{N, D, H, T, U, 1, 1.f};
  const int ND = N * D;
  const int G = row_groups(kThreads, U);
  int best = 0;
  long best_cost = LONG_MAX;
  for (int C = 1; C <= ND; ++C) {
    const int R = edge_rows(d, C + 1);
    if (R == 0 || group_size(d, C + 1, smem) == 0) break;
    const long blocks = static_cast<long>(B) * ((ND + C - 1) / C);
    const long cost = (blocks + sms - 1) / sms * (R * G + 2 * N);
    if (cost < best_cost) {
      best_cost = cost;
      best = C;
    }
  }
  return best;
}

// x [B, N*D], h0 [B, N, H], temb [B, T], w [n_blocks, weight floats],
// final_scaling fs [1]; outputs v [B, N*D], div [B], and partial
// [B, ceil(N*D / cols)] scratch; all f32, contiguous, 16-byte aligned.
// Returns a cudaError_t (0 on success) from the launches.
extern "C" int ecnf_fused_trace(int B, int N, int D, int H, int T, int U,
                                int L, int n_blocks, float C, int cols,
                                const float* x, const float* h0,
                                const float* temb, const float* w,
                                const float* fs, float* v, float* div,
                                float* partial, void* stream) {
  const int ND = N * D;
  if (B < 1 || n_blocks < 1 || cols < 1 || cols > ND ||
      !supported(N, D, H, T, U, L))
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims d{N, D, H, T, U, L, C};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int g = group_size(d, cols + 1, smem_limit());
  if (g == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (edge_rows(d, cols + 1)) {
    case 4: err = launch<4>(d, n_blocks, cols, g, B, x, h0, temb, w, fs, v, partial, s); break;
    case 8: err = launch<8>(d, n_blocks, cols, g, B, x, h0, temb, w, fs, v, partial, s); break;
    case 12: err = launch<12>(d, n_blocks, cols, g, B, x, h0, temb, w, fs, v, partial, s); break;
    case 16: err = launch<16>(d, n_blocks, cols, g, B, x, h0, temb, w, fs, v, partial, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int Q = (ND + cols - 1) / cols;
  sum_partials<<<(B + 127) / 128, 128, 0, s>>>(B, Q, partial, div);
  return static_cast<int>(cudaGetLastError());
}
