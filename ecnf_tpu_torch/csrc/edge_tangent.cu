// Edge-level tangent chain of one EGCL block, for K tangent columns at once.
//
// Replaces the Pallas kernel `_edge_tangent_kernel` dispatched by
// `_edge_tangent_pallas` in ecnf_tpu/ops/pallas/tangent_kernel.py (math in
// `_edge_tangent_math`).  For tangent column k, sample b, receiver i and
// sender j:
//
//   z_t   = a_t[k,b,j] + b_t[k,b,i] + l2_t[k,b,i,j] * e_l
//   m_t   = d_e[L-1] * cd(... d_e[1] * cd((d_e[0] * z_t) @ E_0) ...)
//   p     = d_x[L-1] * cd(... d_x[0] * cd(m_t @ X_0) ...)
//   phi_t[k,b,i,j] = p @ x_out                                  (f32)
//   g_t   = gd * cd(m_t @ g_out)
//   mi_t[k,b,i,:]  = sum_{j != i} f32(m_t * g + m * g_t) / sqrt(N-1)
//
// `cd` is the compute type (float or bf16).  Every product is accumulated
// in f32; the rounding points of the JAX math are kept: a cast to cd before
// each multiply by a stored silu' factor, phi_t left in f32, and the mi_t
// terms formed in cd and summed in f32.
//
// What bounds it on an H100: arithmetic.  At LJ13 (K=36, B=48, N=13,
// U=128, L=3) one launch is K*B*N*N = 292k edge rows through five
// [U, U] layers, ~48 GFLOP, against ~40 MB of device memory in bf16
// (residuals 15 MB, a_t/b_t 12 MB, outputs 13 MB) and ~0.2 MB of weights:
// over 1,000 operations per byte, well above the card's ~295, provided
// the [K, B, N, N, U] intermediates never leave the chip.  They do not:
// each lives only in shared memory for one block's pass.
//
// Design: one thread block per (receiver i, sample b), looping over the K
// columns.  The block's residual rows (d_e, d_x and m for its N senders:
// (2L+1) x N x U values) are loaded into shared memory once and reused by
// all K columns.  The sum over senders j for mi_t runs inside the block,
// one thread per unit, with no atomics.  Outputs are written once.
//
// - bf16 (the serving dtype): the [rows, U] @ [U, U] products run on the
//   tensor cores (wmma 16x16x16, f32 accumulation).  A pass stacks the N
//   sender rows of C = 64 / N columns into one 64-row bf16 activation
//   tile; each warp owns U/16/8 output tiles of 16 units for all 64 rows
//   and reads its weight fragments straight from L2.  The f32 products go
//   through a staging tile in shared memory, where the epilogue rounds
//   them to bf16 and applies the silu' factor.
// - f32: the tensor cores would round the inputs to TF32, so products run
//   on the CUDA cores.  A thread owns one output unit and R of the N rows,
//   reads the weight row by row (coalesced across the warp) and the f32
//   activations as float4 broadcasts from shared memory; the activations
//   live in a ping-pong pair of f32 tiles.
//
// This simple design stays far below the tensor cores' peak: every layer
// ends at a block-wide barrier, each warp reads its weight fragments from
// L2 again for every pass, and a QM9-sized block (N=19, U=256, L=4) needs
// enough shared memory that one block runs per SM.  Weights staged in
// shared memory and wgmma over 64-row tiles are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLayers = 8;
constexpr int kMaxNodes = 32;
constexpr int kTileRows = 64;  // rows per tensor-core pass (4 wmma tiles)

template <typename T>
struct Args {
  int K, B, N, U, L;
  const T* a_t;       // [K, B, N, U]
  const T* b_t;       // [K, B, N, U]
  const float* l2_t;  // [K, B, N, N]
  const T* d_e[kMaxLayers];  // L x [B, N, N, U]
  const T* d_x[kMaxLayers];  // L x [B, N, N, U]
  const T* m;         // [B, N, N, U]
  const T* g;         // [B, N, N]
  const T* gd;        // [B, N, N]
  const T* e_l;       // [U]
  const T* e_tail[kMaxLayers];  // (L-1) x [U, U], [in, out]
  const T* x_tail[kMaxLayers];  // L x [U, U], [in, out]
  const T* x_out;     // [U]
  const T* g_out;     // [U]
  float* phi_t;       // [K, B, N, N]
  float* mi_t;        // [K, B, N, U]
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// Round an f32 value to bf16 and back (round to nearest even).
__device__ __forceinline__ float rnd(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__host__ __device__ inline size_t align128(size_t n) {
  return (n + 127) & ~static_cast<size_t>(127);
}

// Per-row dot products act[r, :] . v over U (row stride ld), one warp per
// row; lane 0 of the row's warp calls emit(r, f32 sum).
template <typename T, typename Emit>
__device__ __forceinline__ void row_dots(const T* __restrict__ act, int ld,
                                         const float* __restrict__ v, int rows,
                                         int U, Emit emit) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += kWarps) {
    float s = 0.f;
    for (int c = lane; c < U; c += 32) s = fmaf(to_f(act[r * ld + c]), v[c], s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) emit(r, s);
  }
}

// Load the block's residual rows [b, i, :, :] of d_e, d_x and m, and the
// per-edge / per-unit vectors, into shared memory.
template <typename T>
__device__ void load_block_inputs(const Args<T>& a, int b, int i, T* res,
                                  float* g_s, float* gd_s, float* el_s,
                                  float* xo_s, float* go_s) {
  const int N = a.N, U = a.U, L = a.L, NU = N * U, tid = threadIdx.x;
  const size_t row0 = (static_cast<size_t>(b) * N + i) * NU;
  for (int r = 0; r < 2 * L + 1; ++r) {
    const T* src = r < L ? a.d_e[r] : (r < 2 * L ? a.d_x[r - L] : a.m);
    for (int idx = tid; idx < NU; idx += kThreads)
      res[r * NU + idx] = src[row0 + idx];
  }
  const size_t edge0 = (static_cast<size_t>(b) * N + i) * N;
  for (int j = tid; j < N; j += kThreads) {
    g_s[j] = to_f(a.g[edge0 + j]);
    gd_s[j] = to_f(a.gd[edge0 + j]);
  }
  for (int u = tid; u < U; u += kThreads) {
    el_s[u] = to_f(a.e_l[u]);
    xo_s[u] = to_f(a.x_out[u]);
    go_s[u] = to_f(a.g_out[u]);
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor-core products
// ---------------------------------------------------------------------------

__host__ __device__ inline int tc_lda(int U) { return U + 8; }  // bf16 tile row stride
__host__ __device__ inline int tc_ldc(int U) { return U + 4; }  // f32 staging row stride

__host__ __device__ inline size_t tc_smem_bytes(int N, int U, int L) {
  return align128(static_cast<size_t>(2 * L + 1) * N * U * sizeof(bf16)) +
         align128(static_cast<size_t>(kTileRows) * tc_lda(U) * sizeof(bf16)) +
         (static_cast<size_t>(kTileRows) * tc_ldc(U) + 2 * N + kTileRows +
          3 * U) * sizeof(float);
}

// acc[0:64, :] = act[0:64, :] @ W (f32 accumulation on the tensor cores).
__device__ __forceinline__ void tc_layer(const bf16* __restrict__ act,
                                         float* __restrict__ acc,
                                         const bf16* __restrict__ W, int U) {
  using namespace nvcuda;
  const int lda = tc_lda(U), ldc = tc_ldc(U);
  const int warp = threadIdx.x / 32;
  for (int nt = warp; nt < U / 16; nt += kWarps) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[kTileRows / 16];
#pragma unroll
    for (int mt = 0; mt < kTileRows / 16; ++mt) wmma::fill_fragment(c[mt], 0.f);
    for (int kk = 0; kk < U; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> w;
      wmma::load_matrix_sync(w, W + kk * U + nt * 16, U);
#pragma unroll
      for (int mt = 0; mt < kTileRows / 16; ++mt) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> x;
        wmma::load_matrix_sync(x, act + mt * 16 * lda + kk, lda);
        wmma::mma_sync(c[mt], x, w, c[mt]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < kTileRows / 16; ++mt)
      wmma::store_matrix_sync(acc + mt * 16 * ldc + nt * 16, c[mt], ldc,
                              wmma::mem_row_major);
  }
}

// act[r, o] = bf16(d[j, o] * bf16(acc[r, o])) for the pass's rows r = (c, j).
__device__ __forceinline__ void tc_epilogue(bf16* __restrict__ act,
                                            const float* __restrict__ acc,
                                            const bf16* __restrict__ d,
                                            int rows, int N, int U) {
  const int lda = tc_lda(U), ldc = tc_ldc(U);
  for (int idx = threadIdx.x; idx < rows * U; idx += kThreads) {
    const int r = idx / U;
    const int o = idx - r * U;
    const int j = r % N;
    act[r * lda + o] =
        __float2bfloat16(__bfloat162float(d[j * U + o]) * rnd(acc[r * ldc + o]));
  }
}

__global__ void __launch_bounds__(kThreads)
    edge_tangent_bf16_kernel(const Args<bf16> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int N = a.N, U = a.U, L = a.L, K = a.K, B = a.B;
  const int NU = N * U;
  const int lda = tc_lda(U);
  const int C = kTileRows / N;  // tangent columns per pass
  const int i = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;

  bf16* res = reinterpret_cast<bf16*>(smem);  // (2L+1) x [N, U]
  unsigned char* p = smem + align128(static_cast<size_t>(2 * L + 1) * NU * sizeof(bf16));
  bf16* act = reinterpret_cast<bf16*>(p);  // [64, lda]
  p += align128(static_cast<size_t>(kTileRows) * lda * sizeof(bf16));
  float* acc = reinterpret_cast<float*>(p);  // [64, ldc]
  float* g_s = acc + kTileRows * tc_ldc(U);  // [N]
  float* gd_s = g_s + N;                     // [N]
  float* gt_s = gd_s + N;                    // [64], per row
  float* el_s = gt_s + kTileRows;            // [U]
  float* xo_s = el_s + U;                    // [U]
  float* go_s = xo_s + U;                    // [U]

  load_block_inputs(a, b, i, res, g_s, gd_s, el_s, xo_s, go_s);
  const bf16* m_res = res + 2 * L * NU;
  const float sqrt_deg = sqrtf(static_cast<float>(N - 1));
  __syncthreads();

  for (int k0 = 0; k0 < K; k0 += C) {
    const int nc = min(C, K - k0);
    const int rows = nc * N;

    // First layer: t = d_e[0] * (a_t[j] + b_t[i] + bf16(l2_t) * e_l); the
    // rows past this pass's columns are zero.
    for (int idx = tid; idx < kTileRows * U; idx += kThreads) {
      const int r = idx / U;
      const int u = idx - r * U;
      float v = 0.f;
      if (r < rows) {
        const int c = r / N;
        const int j = r - c * N;
        const size_t kb = static_cast<size_t>(k0 + c) * B + b;
        const float ab = rnd(__bfloat162float(a.a_t[(kb * N + j) * U + u]) +
                             __bfloat162float(a.b_t[(kb * N + i) * U + u]));
        const float le = rnd(rnd(a.l2_t[(kb * N + i) * N + j]) * el_s[u]);
        v = __bfloat162float(res[j * U + u]) * rnd(ab + le);
      }
      act[r * lda + u] = __float2bfloat16(v);
    }
    __syncthreads();

    // phi_e tail: m_t.
    for (int l = 1; l < L; ++l) {
      tc_layer(act, acc, a.e_tail[l - 1], U);
      __syncthreads();
      tc_epilogue(act, acc, res + l * NU, rows, N, U);
      __syncthreads();
    }

    // Gate tangent g_t = gd * bf16(m_t @ g_out), per row.
    row_dots(act, lda, go_s, rows, U, [&](int r, float s) {
      gt_s[r] = rnd(gd_s[r % N] * rnd(s));
    });
    __syncthreads();

    // mi_t[c, i, u] = sum_{j != i} f32(m_t * g + m * g_t) / sqrt(N - 1).
    for (int idx = tid; idx < nc * U; idx += kThreads) {
      const int c = idx / U;
      const int u = idx - c * U;
      float s = 0.f;
      for (int j = 0; j < N; ++j) {
        if (j == i) continue;
        const int r = c * N + j;
        const float pg = rnd(__bfloat162float(act[r * lda + u]) * g_s[j]);
        const float mg = rnd(__bfloat162float(m_res[j * U + u]) * gt_s[r]);
        s += rnd(pg + mg);
      }
      const size_t kb = static_cast<size_t>(k0 + c) * B + b;
      a.mi_t[(kb * N + i) * U + u] = s / sqrt_deg;
    }
    __syncthreads();

    // phi_x chain.
    for (int l = 0; l < L; ++l) {
      tc_layer(act, acc, a.x_tail[l], U);
      __syncthreads();
      tc_epilogue(act, acc, res + (L + l) * NU, rows, N, U);
      __syncthreads();
    }

    // phi_t[c, i, j] = p[c, j] @ x_out, left in f32.
    row_dots(act, lda, xo_s, rows, U, [&](int r, float s) {
      const int c = r / N;
      const size_t kb = static_cast<size_t>(k0 + c) * B + b;
      a.phi_t[(kb * N + i) * N + (r - c * N)] = s;
    });
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA-core products
// ---------------------------------------------------------------------------

// out[j, o] = d[j, o] * sum_c in[j, c] * W[c, o] for j < N.  `in` has
// R * G rows (rows >= N are zero padding whose results are dropped).
template <int R>
__device__ __forceinline__ void f32_layer(const float* __restrict__ in,
                                          float* __restrict__ out,
                                          const float* __restrict__ W,
                                          const float* __restrict__ d, int N,
                                          int U) {
  const int G = kThreads / U;
  const int o = threadIdx.x % U;
  const int rg = threadIdx.x / U;
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
#pragma unroll 4
  for (int c = 0; c < U; c += 4) {
    const float w0 = W[(c + 0) * U + o];
    const float w1 = W[(c + 1) * U + o];
    const float w2 = W[(c + 2) * U + o];
    const float w3 = W[(c + 3) * U + o];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 x =
          *reinterpret_cast<const float4*>(in + (rg + r * G) * U + c);
      acc[r] = fmaf(x.x, w0, acc[r]);
      acc[r] = fmaf(x.y, w1, acc[r]);
      acc[r] = fmaf(x.z, w2, acc[r]);
      acc[r] = fmaf(x.w, w3, acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = rg + r * G;
    if (j < N) out[j * U + o] = d[j * U + o] * acc[r];
  }
}

__host__ __device__ inline size_t f32_smem_bytes(int N, int U, int L, int rows) {
  return align128(static_cast<size_t>(2 * L + 1) * N * U * sizeof(float)) +
         (2 * static_cast<size_t>(rows) * U + 4 * N + 4 * U) * sizeof(float);
}

template <int R>
__global__ void __launch_bounds__(kThreads)
    edge_tangent_f32_kernel(const Args<float> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int N = a.N, U = a.U, L = a.L, K = a.K, B = a.B;
  const int NU = N * U;
  const int rows = R * (kThreads / U);  // padded row count of act tiles
  const int i = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;

  float* res = reinterpret_cast<float*>(smem);  // (2L+1) x [N, U]
  float* act0 = reinterpret_cast<float*>(
      smem + align128(static_cast<size_t>(2 * L + 1) * NU * sizeof(float)));
  float* act1 = act0 + rows * U;
  float* g_s = act1 + rows * U;  // [N]
  float* gd_s = g_s + N;         // [N]
  float* gt_s = gd_s + N;        // [N]
  float* l2_s = gt_s + N;        // [N], current column
  float* bt_s = l2_s + N;        // [U], current column
  float* el_s = bt_s + U;        // [U]
  float* xo_s = el_s + U;        // [U]
  float* go_s = xo_s + U;        // [U]

  load_block_inputs(a, b, i, res, g_s, gd_s, el_s, xo_s, go_s);
  for (int idx = NU + tid; idx < rows * U; idx += kThreads) {
    act0[idx] = 0.f;
    act1[idx] = 0.f;
  }
  const float* m_res = res + 2 * L * NU;
  const float sqrt_deg = sqrtf(static_cast<float>(N - 1));
  __syncthreads();

  for (int k = 0; k < K; ++k) {
    const size_t kb = static_cast<size_t>(k) * B + b;
    const float* at = a.a_t + kb * NU;
    for (int u = tid; u < U; u += kThreads) bt_s[u] = a.b_t[(kb * N + i) * U + u];
    for (int j = tid; j < N; j += kThreads) l2_s[j] = a.l2_t[(kb * N + i) * N + j];
    __syncthreads();

    // First layer: t = d_e[0] * (a_t[j] + b_t[i] + l2_t * e_l).
    for (int idx = tid; idx < NU; idx += kThreads) {
      const int j = idx / U;
      const int u = idx - j * U;
      act0[idx] = res[idx] * ((at[idx] + bt_s[u]) + l2_s[j] * el_s[u]);
    }
    __syncthreads();

    // phi_e tail: m_t.
    float* cur = act0;
    float* nxt = act1;
    for (int l = 1; l < L; ++l) {
      f32_layer<R>(cur, nxt, a.e_tail[l - 1], res + l * NU, N, U);
      __syncthreads();
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }

    // Gate tangent g_t = gd * (m_t @ g_out).
    row_dots(cur, U, go_s, N, U, [&](int j, float s) { gt_s[j] = gd_s[j] * s; });
    __syncthreads();

    // mi_t[i, u] = sum_{j != i} (m_t * g + m * g_t) / sqrt(N - 1).
    float* mi = a.mi_t + (kb * N + i) * U;
    for (int u = tid; u < U; u += kThreads) {
      float s = 0.f;
      for (int j = 0; j < N; ++j) {
        if (j == i) continue;
        s += cur[j * U + u] * g_s[j] + m_res[j * U + u] * gt_s[j];
      }
      mi[u] = s / sqrt_deg;
    }

    // phi_x chain (reads m_t in `cur`, writes the other tile).
    for (int l = 0; l < L; ++l) {
      f32_layer<R>(cur, nxt, a.x_tail[l], res + (L + l) * NU, N, U);
      __syncthreads();
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }

    // phi_t[i, j] = p[j] @ x_out.
    float* phi = a.phi_t + (kb * N + i) * N;
    row_dots(cur, U, xo_s, N, U, [&](int j, float s) { phi[j] = s; });
    __syncthreads();
  }
}

template <int R>
cudaError_t launch_f32(const Args<float>& a, cudaStream_t stream) {
  const size_t smem = f32_smem_bytes(a.N, a.U, a.L, R * (kThreads / a.U));
  cudaError_t err = cudaFuncSetAttribute(
      edge_tangent_f32_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  edge_tangent_f32_kernel<R><<<dim3(a.N, a.B), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch(const Args<float>& a, cudaStream_t stream) {
  const int G = kThreads / a.U;
  const int rows = (a.N + G - 1) / G;
  if (rows <= 8) return launch_f32<8>(a, stream);
  if (rows <= 16) return launch_f32<16>(a, stream);
  if (rows <= 20) return launch_f32<20>(a, stream);
  return launch_f32<32>(a, stream);
}

cudaError_t launch(const Args<bf16>& a, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes(a.N, a.U, a.L);
  cudaError_t err = cudaFuncSetAttribute(
      edge_tangent_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  edge_tangent_bf16_kernel<<<dim3(a.N, a.B), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
int run(int K, int B, int N, int U, int L, const void* a_t, const void* b_t,
        const float* l2_t, const void* const* d_e, const void* const* d_x,
        const void* m, const void* g, const void* gd, const void* e_l,
        const void* const* e_tail, const void* const* x_tail,
        const void* x_out, const void* g_out, float* phi_t, float* mi_t,
        void* stream) {
  Args<T> a{};
  a.K = K;
  a.B = B;
  a.N = N;
  a.U = U;
  a.L = L;
  a.a_t = static_cast<const T*>(a_t);
  a.b_t = static_cast<const T*>(b_t);
  a.l2_t = l2_t;
  for (int l = 0; l < L; ++l) {
    a.d_e[l] = static_cast<const T*>(d_e[l]);
    a.d_x[l] = static_cast<const T*>(d_x[l]);
    a.x_tail[l] = static_cast<const T*>(x_tail[l]);
    if (l + 1 < L) a.e_tail[l] = static_cast<const T*>(e_tail[l]);
  }
  a.m = static_cast<const T*>(m);
  a.g = static_cast<const T*>(g);
  a.gd = static_cast<const T*>(gd);
  a.e_l = static_cast<const T*>(e_l);
  a.x_out = static_cast<const T*>(x_out);
  a.g_out = static_cast<const T*>(g_out);
  a.phi_t = phi_t;
  a.mi_t = mi_t;
  return static_cast<int>(launch(a, static_cast<cudaStream_t>(stream)));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Shapes and layouts as in Args.
// Requires 2 <= N <= 32, U in {32, 64, 128, 256}, 1 <= L <= 8, every
// pointer 32-byte aligned; the caller validates.  Returns a cudaError_t
// (0 on success) from the launch.
extern "C" int ecnf_edge_tangent(int dtype, int K, int B, int N, int U, int L,
                                 const void* a_t, const void* b_t,
                                 const float* l2_t, const void* const* d_e,
                                 const void* const* d_x, const void* m,
                                 const void* g, const void* gd,
                                 const void* e_l, const void* const* e_tail,
                                 const void* const* x_tail, const void* x_out,
                                 const void* g_out, float* phi_t, float* mi_t,
                                 void* stream) {
  if (N < 2 || N > kMaxNodes || L < 1 || L > kMaxLayers || U < 32 ||
      U > kThreads || kThreads % U != 0 || K < 1 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return run<float>(K, B, N, U, L, a_t, b_t, l2_t, d_e, d_x, m, g, gd, e_l,
                      e_tail, x_tail, x_out, g_out, phi_t, mi_t, stream);
  if (dtype == 1)
    return run<bf16>(K, B, N, U, L, a_t, b_t, l2_t, d_e, d_x, m, g, gd, e_l,
                     e_tail, x_tail, x_out, g_out, phi_t, mi_t, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
