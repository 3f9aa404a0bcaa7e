// Edge-level tangent chain of one EGCL block, for K tangent columns at once.
//
// Replaces the Pallas kernel `_edge_tangent_kernel`
// (ecnf_tpu/ops/pallas/tangent_kernel.py:344, dispatched by
// `_edge_tangent_pallas`, math in `_edge_tangent_math`).  For tangent
// column k, sample b, receiver i and sender j:
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
// What bounds it on an H100: operations.  At LJ13 (K=36, B=48, N=13,
// U=128, L=3) one launch is K*B*N*N = 292k edge rows through five
// [U, U] layers, 47.8 GFLOP, against ~40 MB of device memory in bf16: over
// 1,000 operations per byte, well above the card's ~295, as long as the
// [K, B, N, N, U] intermediates never leave the chip.  They do not: each
// lives in shared memory and registers for one thread block's pass.
//
// Design: every [rows, U] @ [U, U] product runs on the tensor cores, and
// the work around the products is kept per element as small as it can be,
// since at these widths (a row's product is 8 or 16 mma steps deep) that
// work, not the tensor cores, sets the pace.
//
// - Grid: a thread block owns (receiver i, sample b, a chunk of C tangent
//   columns), and stacks the N sender rows of its C columns as rows
//   r = c N + j of one tile, cut into 16-row tiles; a column's N senders
//   span ceil(N / 16) or more tiles, so N is bounded by the shared memory
//   and registers, not by a warp (kMaxEdgeNodes = 64; at LJ55 a column
//   is 55 rows).  The grid is (ceil(K / C), N, B), chunks fastest, so the
//   blocks that share one (i, b)'s residual rows run side by side and find
//   them in L2.  The sum over senders for mi_t runs inside the block, in
//   sender order, with no atomics: two runs agree bit for bit.  C comes
//   from a cost model (`ecnf_edge_tangent_columns`): the waves of work,
//   layers x row tiles of a block's busiest warp summed over the blocks
//   and divided by the blocks that run at once (the occupancy
//   calculator's blocks per SM, so the shared memory and registers count).
// - bf16 (the serving dtype): `dense_bf16` (dense_bf16.cuh), mma.sync
//   m16n8k16 bf16 -> f32 from ldmatrix fragments, with the weights of all
//   2L - 1 layers streamed through one cp.async ring.  The accumulators
//   stay in registers; the epilogue forms act = bf16(d * bf16(acc)) on
//   them with one bf16x2 multiply per pair and writes the pairs into the
//   other tile of a ping-pong pair, so a layer costs the ring's barriers
//   and no staging tile.  The gate's m_t . g_out and phi_x's p . x_out are
//   folded into the epilogues of the last pass of each chain.
//   Each layer's silu' factor rows of the block (N x U, shared by its C
//   columns) come into shared memory with the layer's first weight
//   chunk, so the epilogue neither waits on global memory nor holds
//   prefetched operands in registers through the products.  One block of
//   512 threads per SM.
// - f32: `dense_staged` (egnn_device.cuh) as the fused-trace kernel uses
//   it, mma.sync m16n8k8 TF32 in the 3xTF32 split (f32 accuracy), the
//   epilogue applying the silu' factor in place; the two row dots are
//   passes of their own.  The block's residual rows ((2L - 1) silu'
//   factors and m, N x U each) are staged in shared memory when they fit
//   beside the tile and the ring with two blocks of 256 per SM; otherwise
//   the epilogues read them from global memory, where the blocks of one
//   (i, b) keep them in L2.
// - The first layer and the mi_t sum run on the CUDA cores between
//   barriers, in bf16x2 operations in the bf16 kernel.
//
// Shared memory per block and blocks per SM at the default C (H100, 227 KB
// per block, 228 KB per SM; `ecnf_edge_tangent_plan`, printed by
// `chip_smoke.py`):
//   LJ13 bf16: C = 18, 211,072 B, 1 block of 512 threads, 4 row tiles a warp;
//   LJ13 f32:  C = 7, 99,328 B, 2 blocks of 256, 3 row tiles, residuals global;
//   QM9 bf16:  C = 5, 191,104 B, 1 block of 512, 3 row tiles;
//   QM9 f32:   C = 2, 89,856 B, 2 blocks of 256, 3 row tiles, residuals global;
//   LJ55 bf16 (K = 162, B = 16, N = 55): C = 3, 206,464 B, 1 block of 512,
//   3 row tiles (C = 4 would take 235,776 B);
//   LJ55 f32:  C = 1, 79,872 B, 2 blocks of 256, 2 row tiles, residuals global.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>

#include "dense_bf16.cuh"
#include "egnn_device.cuh"

namespace {

using namespace ecnf;

// Threads per block.  The bf16 kernel runs one block of 512 per SM: twice
// the rows of a block of 256 at the same registers per thread, so half the
// weights streamed per row.  The f32 kernel runs two blocks of 256 (its
// larger tiles leave room for no more rows).
constexpr int kThreadsF32 = 256;
constexpr int kThreadsBf16 = 512;

template <typename T>
__host__ __device__ constexpr int threads_for() {
  return sizeof(T) == 2 ? kThreadsBf16 : kThreadsF32;
}
constexpr int kMaxPasses = 2 * kMaxLayers - 1;
// Row tiles per warp of a dense pass, at most: one kernel per choice.  The
// 3xTF32 pass holds twice the operand registers of the bf16 one.
constexpr int kMaxTilesBf16 = 4;
constexpr int kMaxTilesF32 = 3;

template <typename T>
struct Args {
  int K, B, N, U, L, C;
  const T* a_t;       // [K, B, N, U]
  const T* b_t;       // [K, B, N, U]
  const float* l2_t;  // [K, B, N, N]
  const T* d_e0;      // [B, N, N, U], the first layer's silu' factor
  const T* w[kMaxPasses];  // the 2L - 1 [U, U] layers: e_tail..., x_tail...
  const T* d[kMaxPasses];  // their silu' factors, [B, N, N, U] each
  const T* m;         // [B, N, N, U]
  const T* g;         // [B, N, N]
  const T* gd;        // [B, N, N]
  const T* e_l;       // [U]
  const T* x_out;     // [U]
  const T* g_out;     // [U]
  float* phi_t;       // [K, B, N, N]
  float* mi_t;        // [K, B, N, U]
};

// Byte offsets into a block's dynamic shared memory.
struct Plan {
  int act0, act1;  // bf16: the ping-pong activation tiles; f32: act0 only
  int ring;        // bf16: `BfWeights` ring; f32: dense_staged's stage
  int epi;         // bf16: `BfWeights` epilogue rows
  int res;         // f32: (2L - 1) silu' factors then m, N x U each; -1: global
  int g, gd, gt;   // [N], [N], [C N]: f32, or bf16 pairs
  int dot;         // bf16: [wc][tile rows] f32 shares of the folded row dots
  int vec;         // bf16: g_out then x_out, [2][U] f32
  int total;
};

__host__ __device__ inline int align128(size_t n) {
  return static_cast<int>((n + 127) & ~static_cast<size_t>(127));
}

template <typename T>
__host__ __device__ inline Plan make_plan(int N, int U, int L, int C, bool staged) {
  const bool bf = sizeof(T) == 2;
  // bf16 tiles hold whole 16-row tiles (`dense_bf16` writes the padding
  // rows); `dense_staged` reads and writes only rows < C N.
  const int tile_rows = bf ? (C * N + 15) / 16 * 16 : C * N;
  const size_t tile = static_cast<size_t>(tile_rows) * (U + 8) * sizeof(T);
  Plan p{};
  int o = 0;
  p.act0 = o;
  o += align128(tile);
  p.act1 = bf ? o : -1;
  if (bf) o += align128(tile);
  p.ring = o;
  o += align128(bf ? bf_ring_bytes(U) : static_cast<size_t>(kStages) * kStageFloats * sizeof(float));
  p.epi = bf ? o : -1;
  if (bf) o += align128(bf_epi_bytes(N, U));
  p.res = staged && !bf ? o : -1;
  if (p.res >= 0) o += align128(static_cast<size_t>(2 * L) * N * U * sizeof(T));
  p.g = o;
  o += align128(N * sizeof(float));
  p.gd = o;
  o += align128(N * sizeof(float));
  p.gt = o;
  o += align128(static_cast<size_t>(C) * N * sizeof(float));
  // Column groups of a pass (`mma_layout`'s wc), at most.
  const int groups = U / 8 < threads_for<T>() / 32 ? U / 8 : threads_for<T>() / 32;
  p.dot = bf ? o : -1;
  if (bf) o += align128(static_cast<size_t>(groups) * tile_rows * sizeof(float));
  p.vec = bf ? o : -1;
  if (bf) o += align128(2 * static_cast<size_t>(U) * sizeof(float));
  p.total = o;
  return p;
}

// Row r = c N + j of a block's tile: its column c = r / N and sender
// j = r % N, for 0 <= r < 4096 and inv_n = 1 / N (the quotient from a
// float product is exact there, and far cheaper than an integer division).
__device__ __forceinline__ int column_of(int r, float inv_n) {
  return __float2int_rz((static_cast<float>(r) + 0.5f) * inv_n);
}

__device__ __forceinline__ int sender_of(int r, int N, float inv_n) {
  return r - N * column_of(r, inv_n);
}

// Stage the block's residual rows [b, i, :, :] of the 2L - 1 silu' factors
// and m with cp.async (one commit group; the first dense pass's wait
// covers it).
__device__ void stage_residuals(const Args<float>& a, float* res, size_t row0) {
  const int NU = a.N * a.U, P = 2 * a.L - 1;
  for (int s = 0; s <= P; ++s) {
    const float* src = (s < P ? a.d[s] : a.m) + row0;
    for (int idx = threadIdx.x; idx < NU / 4; idx += kThreadsF32)
      cp_async16(res + s * NU + 4 * idx, src + 4 * idx);
  }
  cp_async_commit();
}

// The block's per-edge gate and its derivative.
__device__ void load_gates(const Args<float>& a, size_t edge0, float* g_s, float* gd_s) {
  for (int j = threadIdx.x; j < a.N; j += kThreadsF32) {
    g_s[j] = a.g[edge0 + j];
    gd_s[j] = a.gd[edge0 + j];
  }
}

// ---------------------------------------------------------------------------
// bf16
// ---------------------------------------------------------------------------

using bf162 = __nv_bfloat162;

__device__ __forceinline__ bf162 as_bf162(unsigned v) { return *reinterpret_cast<const bf162*>(&v); }
__device__ __forceinline__ unsigned as_u32(bf162 v) { return *reinterpret_cast<const unsigned*>(&v); }

// dot(r) = act[r, :U] . v for r < rows, one warp per row, f32 sums; lane 0
// calls emit(r, dot).
template <int NT, typename Emit>
__device__ __forceinline__ void row_dots_bf16(const bf16* act, int ld,
                                              const bf16* __restrict__ v, int rows,
                                              int U, Emit emit) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += NT / 32) {
    float s = 0.f;
    for (int c = 2 * lane; c < U; c += 64) {
      const float2 x = __bfloat1622float2(*reinterpret_cast<const bf162*>(act + r * ld + c));
      const float2 y = __bfloat1622float2(as_bf162(__ldg(reinterpret_cast<const unsigned*>(v + c))));
      s = fmaf(x.x, y.x, s);
      s = fmaf(x.y, y.y, s);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) emit(r, s);
  }
}

// The bf16 products, sums and casts of the JAX math are single-rounded
// bf16x2 operations here (a bf16 x bf16 product is exact in f32, so
// bf16(f32(a) * f32(b)) is one rounding either way), in their .rn forms:
// without a rounding mode the compiler may fuse a product into the sum
// after it and skip the product's rounding.
template <int MT>
__global__ void __launch_bounds__(kThreadsBf16, 1)
    edge_tangent_bf16_kernel(const __grid_constant__ Args<bf16> a, const Plan pl) {
  constexpr int NT = kThreadsBf16;
  ECNF_PROBE_SCOPE(probe, kProbeTotal);
  extern __shared__ __align__(128) unsigned char smem[];
  const int N = a.N, U = a.U, L = a.L, K = a.K, B = a.B, C = a.C;
  const int NU = N * U, P = 2 * L - 1, ld = U + 8;
  const int lg = __ffs(U) - 1;  // log2 U
  const float inv_n = 1.f / static_cast<float>(N);
  const int k0 = blockIdx.x * C;
  const int i = blockIdx.y;
  const int b = blockIdx.z;
  const int nc = min(C, K - k0);
  const int rows = nc * N;
  const int tid = threadIdx.x;
  const size_t row0 = (static_cast<size_t>(b) * N + i) * NU;  // [b, i, :, :]

  bf16* act0 = reinterpret_cast<bf16*>(smem + pl.act0);
  bf16* act1 = reinterpret_cast<bf16*>(smem + pl.act1);
  bf162* g_s = reinterpret_cast<bf162*>(smem + pl.g);    // [N], (g, g)
  bf16* gd_s = reinterpret_cast<bf16*>(smem + pl.gd);    // [N]
  bf162* gt_s = reinterpret_cast<bf162*>(smem + pl.gt);  // [C N], (g_t, g_t)
  // The weights and, beside them, each pass's silu' factor rows [b, i, :, :].
  const BfWeights w{a.w, P, U, bf_chunk_rows(U), reinterpret_cast<bf16*>(smem + pl.ring),
                    a.d, row0, N, reinterpret_cast<bf16*>(smem + pl.epi)};
  const bf16* m_rows = a.m + row0;  // read once, by the mi_t sum

  bf_prologue<NT>(w);
  // The folded Dense(1) vectors, in shared memory: the epilogue's loads of
  // them then stay after the pass's barriers instead of being hoisted to
  // hold registers through the products.
  float* vec_s = reinterpret_cast<float*>(smem + pl.vec);  // g_out, x_out
  {
    const size_t edge0 = (static_cast<size_t>(b) * N + i) * N;
    for (int j = tid; j < N; j += NT) {
      g_s[j] = __bfloat162bfloat162(a.g[edge0 + j]);
      gd_s[j] = a.gd[edge0 + j];
    }
    for (int u = tid; u < U; u += NT) {
      vec_s[u] = __bfloat162float(a.g_out[u]);
      vec_s[U + u] = __bfloat162float(a.x_out[u]);
    }
  }

  // First layer: t = d_e[0] * (a_t[j] + b_t[i] + bf16(l2_t) * e_l), 8
  // units at a time.
  {
    ECNF_PROBE_SCOPE(probe_first, kProbeFirst);
    const int lg8 = lg - 3;  // log2 of the 8-unit groups per row
#pragma unroll 2
    for (int idx = tid; idx < rows << lg8; idx += NT) {
      const int r = idx >> lg8;
      const int u = (idx & ((1 << lg8) - 1)) << 3;
      const int c = column_of(r, inv_n);
      const int j = r - c * N;
      const size_t kb = static_cast<size_t>(k0 + c) * B + b;
      const uint4 av = *reinterpret_cast<const uint4*>(a.a_t + (kb * N + j) * U + u);
      const uint4 bv = __ldg(reinterpret_cast<const uint4*>(a.b_t + (kb * N + i) * U + u));
      const uint4 ev = __ldg(reinterpret_cast<const uint4*>(a.e_l + u));
      const uint4 dv = *reinterpret_cast<const uint4*>(a.d_e0 + row0 + j * U + u);
      const bf162 l2 = __float2bfloat162_rn(a.l2_t[(kb * N + i) * N + j]);
      const unsigned* ap = &av.x;
      const unsigned* bp = &bv.x;
      const unsigned* ep = &ev.x;
      const unsigned* dp = &dv.x;
      uint4 out;
      unsigned* op = &out.x;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bf162 z = __hadd2_rn(__hadd2_rn(as_bf162(ap[q]), as_bf162(bp[q])), __hmul2_rn(l2, as_bf162(ep[q])));
        op[q] = as_u32(__hmul2_rn(as_bf162(dp[q]), z));
      }
      *reinterpret_cast<uint4*>(act0 + r * ld + u) = out;
    }
  }

  // The chain: pass p reads `cur` and writes act = bf16(d * bf16(cur @ W_p))
  // into the other tile.  Given v (g_out or x_out in vec_s), it also folds
  // the Dense(1) row dots act . v into its epilogue (`row_dot` sums them).
  bf16* cur = act0;
  bf16* nxt = act1;
  const int tile_rows = (C * N + 15) / 16 * 16;
  const int wc = mma_layout(NT / 32, U, rows).wc;
  float* dot_s = reinterpret_cast<float*>(smem + pl.dot);  // [wc][tile_rows]
  auto pass = [&](int p, const float* v) {
    const bf16* d = epi_rows(w, p);
    bf16* out = nxt;
    auto store = [&](int r, int o, float2 acc) {
      const bf162 dv = *reinterpret_cast<const bf162*>(d + sender_of(r, N, inv_n) * ld + o);
      const bf162 y = __hmul2_rn(dv, __float22bfloat162_rn(acc));
      *reinterpret_cast<bf162*>(out + r * ld + o) = y;
      return y;
    };
    if (v) {
      dense_bf16<NT, MT, true>(
          cur, ld, rows, w, p,
          [&](int r, int o, float2 acc) {
            const float2 y = __bfloat1622float2(store(r, o, acc));
            const float2 x = *reinterpret_cast<const float2*>(v + o);
            return fmaf(y.x, x.x, y.y * x.y);
          },
          [&](int r, int q, float s) { dot_s[q * tile_rows + r] = s; });
    } else {
      dense_bf16<NT, MT, false>(
          cur, ld, rows, w, p,
          [&](int r, int o, float2 acc) {
            store(r, o, acc);
            return 0.f;
          },
          [](int, int, float) {});
    }
    nxt = cur;
    cur = out;
  };
  auto row_dot = [&](int r) {
    float s = 0.f;
    for (int q = 0; q < wc; ++q) s += dot_s[q * tile_rows + r];
    return s;
  };

  // phi_e tail: m_t, its last pass folding m_t . g_out.
  for (int p = 0; p < L - 1; ++p) pass(p, p == L - 2 ? vec_s : nullptr);
  __syncthreads();

  {
    ECNF_PROBE_SCOPE(probe_dots, kProbeRowDots);
    // Gate tangent g_t = gd * bf16(m_t @ g_out), per row.
    auto gate = [&](int r, float s) {
      gt_s[r] = __bfloat162bfloat162(__hmul_rn(gd_s[sender_of(r, N, inv_n)], __float2bfloat16(s)));
    };
    if (L == 1)
      row_dots_bf16<NT>(cur, ld, a.g_out, rows, U, gate);  // no pass to fold it into
    else
      for (int r = tid; r < rows; r += NT) gate(r, row_dot(r));
    __syncthreads();

    // mi_t[c, i, u] = sum_{j != i} f32(m_t * g + m * g_t) / sqrt(N - 1),
    // two units at a time.
    const float sqrt_deg = sqrtf(static_cast<float>(N - 1));
    const int lg2 = lg - 1;  // log2 of the unit pairs per row
    for (int idx = tid; idx < nc << lg2; idx += NT) {
      const int c = idx >> lg2;
      const int u = (idx & ((1 << lg2) - 1)) << 1;
      const bf16* mt = cur + c * N * ld + u;
      float s0 = 0.f, s1 = 0.f;
      // Branch-free, so that the unrolled iterations' loads overlap; the
      // receiver's own term is dropped by the select.
#pragma unroll 4
      for (int j = 0; j < N; ++j) {
        const bf162 mm = *reinterpret_cast<const bf162*>(m_rows + j * U + u);
        const bf162 term = __hadd2_rn(__hmul2_rn(*reinterpret_cast<const bf162*>(mt + j * ld), g_s[j]),
                                      __hmul2_rn(mm, gt_s[c * N + j]));
        const float2 f = __bfloat1622float2(term);
        s0 += j == i ? 0.f : f.x;
        s1 += j == i ? 0.f : f.y;
      }
      const size_t kb = static_cast<size_t>(k0 + c) * B + b;
      *reinterpret_cast<float2*>(a.mi_t + (kb * N + i) * U + u) =
          make_float2(s0 / sqrt_deg, s1 / sqrt_deg);
    }
  }

  // phi_x chain (its first pass reads m_t in `cur` beside the mi_t sum),
  // its last pass folding p . x_out.
  for (int p = L - 1; p < P; ++p) pass(p, p == P - 1 ? vec_s + U : nullptr);
  __syncthreads();

  // phi_t[c, i, j] = p[c, j] @ x_out, left in f32.
  for (int r = tid; r < rows; r += NT) {
    const int c = column_of(r, inv_n);
    const size_t kb = static_cast<size_t>(k0 + c) * B + b;
    a.phi_t[(kb * N + i) * N + (r - c * N)] = row_dot(r);
  }
}

// ---------------------------------------------------------------------------
// f32
// ---------------------------------------------------------------------------

template <int MT>
__global__ void __launch_bounds__(kThreadsF32, 2)
    edge_tangent_f32_kernel(const __grid_constant__ Args<float> a, const Plan pl) {
  constexpr int kThreads = kThreadsF32;
  ECNF_PROBE_SCOPE(probe, kProbeTotal);
  extern __shared__ __align__(128) unsigned char smem[];
  const int N = a.N, U = a.U, L = a.L, K = a.K, B = a.B, C = a.C;
  const int NU = N * U, P = 2 * L - 1, ld = U + 8;
  const int lg = __ffs(U) - 1;  // log2 U
  const float inv_n = 1.f / static_cast<float>(N);
  const int k0 = blockIdx.x * C;
  const int i = blockIdx.y;
  const int b = blockIdx.z;
  const int nc = min(C, K - k0);
  const int rows = nc * N;
  const int tid = threadIdx.x;
  const size_t row0 = (static_cast<size_t>(b) * N + i) * NU;

  float* tile = reinterpret_cast<float*>(smem + pl.act0);
  float* stage = reinterpret_cast<float*>(smem + pl.ring);
  float* res = pl.res >= 0 ? reinterpret_cast<float*>(smem + pl.res) : nullptr;
  float* g_s = reinterpret_cast<float*>(smem + pl.g);
  float* gd_s = reinterpret_cast<float*>(smem + pl.gd);
  float* gt_s = reinterpret_cast<float*>(smem + pl.gt);
  auto d_rows = [&](int p) -> const float* { return res ? res + p * NU : a.d[p] + row0; };
  const float* m_rows = res ? res + P * NU : a.m + row0;

  if (res) stage_residuals(a, res, row0);
  load_gates(a, (static_cast<size_t>(b) * N + i) * N, g_s, gd_s);

  // First layer: t = d_e[0] * ((a_t[j] + b_t[i]) + l2_t * e_l), 4 units at
  // a time.
  {
    ECNF_PROBE_SCOPE(probe_first, kProbeFirst);
    const int lg4 = lg - 2;  // log2 of the 4-unit groups per row
#pragma unroll 2
    for (int idx = tid; idx < rows << lg4; idx += kThreads) {
      const int r = idx >> lg4;
      const int u = (idx & ((1 << lg4) - 1)) << 2;
      const int c = column_of(r, inv_n);
      const int j = r - c * N;
      const size_t kb = static_cast<size_t>(k0 + c) * B + b;
      const float4 x = *reinterpret_cast<const float4*>(a.a_t + (kb * N + j) * U + u);
      const float4 y = __ldg(reinterpret_cast<const float4*>(a.b_t + (kb * N + i) * U + u));
      const float4 e = __ldg(reinterpret_cast<const float4*>(a.e_l + u));
      const float4 d = *reinterpret_cast<const float4*>(a.d_e0 + row0 + j * U + u);
      const float l2 = a.l2_t[(kb * N + i) * N + j];
      store4(tile + r * ld + u,
             make_float4(d.x * ((x.x + y.x) + l2 * e.x), d.y * ((x.y + y.y) + l2 * e.y),
                         d.z * ((x.z + y.z) + l2 * e.z), d.w * ((x.w + y.w) + l2 * e.w)));
    }
  }

  // Pass p: tile = d * (tile @ W_p), in place (dense_staged ends with a
  // barrier before its epilogue).
  auto pass = [&](int p) {
    const float* d = d_rows(p);
    dense_staged<kThreads, MT>(tile, ld, rows, 0, U, a.w[p], U, rows, stage,
                               [&](int r, int o, float2 acc) {
                                 const float2 dv = *reinterpret_cast<const float2*>(
                                     d + (sender_of(r, N, inv_n) << lg) + o);
                                 store2(tile + r * ld + o, make_float2(dv.x * acc.x, dv.y * acc.y));
                               });
  };

  for (int p = 0; p < L - 1; ++p) pass(p);
  if (L == 1) cp_async_wait<0>();
  __syncthreads();

  // Gate tangent g_t = gd * (m_t @ g_out) (row_dots has its own probe).
  row_dots<kThreads>(tile, ld, a.g_out, rows, U,
                     [&](int r, float s) { gt_s[r] = gd_s[sender_of(r, N, inv_n)] * s; });
  __syncthreads();
  {
    ECNF_PROBE_SCOPE(probe_mi, kProbeRowDots);
    const float sqrt_deg = sqrtf(static_cast<float>(N - 1));
    const int lg2 = lg - 1;  // log2 of the unit pairs per row
    for (int idx = tid; idx < nc << lg2; idx += kThreads) {
      const int c = idx >> lg2;
      const int u = (idx & ((1 << lg2) - 1)) << 1;
      float s0 = 0.f, s1 = 0.f;
      for (int j = 0; j < N; ++j) {
        if (j == i) continue;
        const int r = c * N + j;
        const float2 mt = *reinterpret_cast<const float2*>(tile + r * ld + u);
        const float2 mm = *reinterpret_cast<const float2*>(m_rows + j * U + u);
        const float gj = g_s[j], gt = gt_s[r];
        s0 += mt.x * gj + mm.x * gt;
        s1 += mt.y * gj + mm.y * gt;
      }
      const size_t kb = static_cast<size_t>(k0 + c) * B + b;
      *reinterpret_cast<float2*>(a.mi_t + (kb * N + i) * U + u) =
          make_float2(s0 / sqrt_deg, s1 / sqrt_deg);
    }
  }

  // phi_x chain: its first pass's barriers order the mi_t sum's reads of
  // the tile before its epilogue overwrites it.
  for (int p = L - 1; p < P; ++p) pass(p);
  __syncthreads();

  row_dots<kThreads>(tile, ld, a.x_out, rows, U, [&](int r, float s) {
    const int c = column_of(r, inv_n);
    const size_t kb = static_cast<size_t>(k0 + c) * B + b;
    a.phi_t[(kb * N + i) * N + (r - c * N)] = s;
  });
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

template <typename T>
constexpr int max_tiles() {
  return sizeof(T) == 2 ? kMaxTilesBf16 : kMaxTilesF32;
}

// The kernel for MT row tiles per warp, or nullptr.
template <typename T>
const void* kernel_for(int MT) {
  if (sizeof(T) == 2) {
    switch (MT) {
      case 1: return reinterpret_cast<const void*>(edge_tangent_bf16_kernel<1>);
      case 2: return reinterpret_cast<const void*>(edge_tangent_bf16_kernel<2>);
      case 3: return reinterpret_cast<const void*>(edge_tangent_bf16_kernel<3>);
      case 4: return reinterpret_cast<const void*>(edge_tangent_bf16_kernel<4>);
    }
  } else {
    switch (MT) {
      case 1: return reinterpret_cast<const void*>(edge_tangent_f32_kernel<1>);
      case 2: return reinterpret_cast<const void*>(edge_tangent_f32_kernel<2>);
      case 3: return reinterpret_cast<const void*>(edge_tangent_f32_kernel<3>);
    }
  }
  return nullptr;
}

// What one launch with C columns per block looks like on this card: row
// tiles per warp, the shared-memory plan and blocks per SM.  The f32
// kernel stages the residual rows when that still lets two blocks share
// an SM; the bf16 kernel's epilogue rows come with its weight stream.
// blocks_per_sm is 0 when it does not launch.
struct Config {
  int MT;
  Plan plan;
  int blocks_per_sm;
  const void* fn;
};

// Blocks of `threads` per SM with `smem` bytes of dynamic shared memory,
// 0 if it does not launch; cached per device, kernel and size, since every
// launch asks.
int occupancy(const void* fn, int threads, int smem) {
  static std::mutex mu;
  static std::map<std::tuple<int, const void*, int>, int> cache;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  const std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(dev, fn, smem);
  const auto it = cache.find(key);
  if (it != cache.end()) return it->second;
  int limit = 0, n = 0;
  if (cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess ||
      smem > limit ||
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, limit) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, threads, smem) != cudaSuccess)
    n = 0;
  cache[key] = n;
  return n;
}

template <typename T>
Config configure(int K, int N, int U, int L, int C) {
  Config cfg{};
  if (C < 1 || C > K) return cfg;
  constexpr int threads = threads_for<T>();
  const int need = warp_row_tiles(threads / 32, C * N, U);
  if (need > max_tiles<T>()) return cfg;
  cfg.MT = need;
  cfg.fn = kernel_for<T>(need);
  if (sizeof(T) == 4) {
    const Plan staged = make_plan<T>(N, U, L, C, true);
    const int occ = occupancy(cfg.fn, threads, staged.total);
    if (occ >= 2) {
      cfg.plan = staged;
      cfg.blocks_per_sm = occ;
      return cfg;
    }
  }
  cfg.plan = make_plan<T>(N, U, L, C, false);
  cfg.blocks_per_sm = occupancy(cfg.fn, threads, cfg.plan.total);
  return cfg;
}

bool supported(int K, int B, int N, int U, int L) {
  return K >= 1 && B >= 1 && B <= 65535 && N >= 2 && N <= kMaxEdgeNodes && L >= 1 &&
         L <= kMaxLayers && (U == 32 || U == 64 || U == 128 || U == 256);
}

// Columns per thread block: the C that minimises the waves of work, the
// sum over thread blocks of (2L - 1 layers x the row tiles of its busiest
// warp, + 2 for the first layer, the mi_t sum and the barriers between)
// over the blocks that run at once (SMs x blocks per SM), among the C that
// launch.  The last chunk of columns may be short, and its blocks lighter.
template <typename T>
int best_columns(int K, int B, int N, int U, int L) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  int best = 0;
  double best_cost = 0.0;
  for (int C = 1; C <= K; ++C) {
    const Config cfg = configure<T>(K, N, U, L, C);
    if (cfg.blocks_per_sm == 0) break;
    const int full = K / C, last = K - full * C;
    auto block_cost = [&](int nc) {
      return (2 * L - 1) * warp_row_tiles(threads_for<T>() / 32, nc * N, U) + 2;
    };
    const double work =
        static_cast<double>(B) * N * (full * block_cost(C) + (last ? block_cost(last) : 0));
    const double cost = work / (static_cast<double>(sms) * cfg.blocks_per_sm);
    if (best == 0 || cost < best_cost) {
      best_cost = cost;
      best = C;
    }
  }
  return best;
}

template <typename T>
int run(int K, int B, int N, int U, int L, int C, const void* a_t, const void* b_t,
        const float* l2_t, const void* const* d_e, const void* const* d_x,
        const void* m, const void* g, const void* gd, const void* e_l,
        const void* const* e_tail, const void* const* x_tail,
        const void* x_out, const void* g_out, float* phi_t, float* mi_t,
        cudaStream_t stream) {
  const Config cfg = configure<T>(K, N, U, L, C);
  if (cfg.blocks_per_sm == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  Args<T> a{};
  a.K = K;
  a.B = B;
  a.N = N;
  a.U = U;
  a.L = L;
  a.C = C;
  a.a_t = static_cast<const T*>(a_t);
  a.b_t = static_cast<const T*>(b_t);
  a.l2_t = l2_t;
  a.d_e0 = static_cast<const T*>(d_e[0]);
  for (int l = 1; l < L; ++l) {
    a.w[l - 1] = static_cast<const T*>(e_tail[l - 1]);
    a.d[l - 1] = static_cast<const T*>(d_e[l]);
  }
  for (int l = 0; l < L; ++l) {
    a.w[L - 1 + l] = static_cast<const T*>(x_tail[l]);
    a.d[L - 1 + l] = static_cast<const T*>(d_x[l]);
  }
  a.m = static_cast<const T*>(m);
  a.g = static_cast<const T*>(g);
  a.gd = static_cast<const T*>(gd);
  a.e_l = static_cast<const T*>(e_l);
  a.x_out = static_cast<const T*>(x_out);
  a.g_out = static_cast<const T*>(g_out);
  a.phi_t = phi_t;
  a.mi_t = mi_t;
  const dim3 grid((K + C - 1) / C, N, B);
  void* params[] = {&a, const_cast<Plan*>(&cfg.plan)};
  return static_cast<int>(cudaLaunchKernel(cfg.fn, grid, dim3(threads_for<T>()), params,
                                           static_cast<size_t>(cfg.plan.total), stream));
}

}  // namespace

// Columns per thread block that the cost model picks for these shapes on
// the current card.  dtype: 0 = float32, 1 = bfloat16.  0 if the shapes
// are not supported.
extern "C" int ecnf_edge_tangent_columns(int dtype, int K, int B, int N, int U, int L) {
  if (!supported(K, B, N, U, L)) return 0;
  if (dtype == 0) return best_columns<float>(K, B, N, U, L);
  if (dtype == 1) return best_columns<bf16>(K, B, N, U, L);
  return 0;
}

// The launch with C columns per block: its dynamic shared memory in
// bytes, thread blocks per SM, row tiles per warp and whether the residual
// rows are staged in shared memory.  Returns 0, or cudaErrorInvalidValue
// for shapes or a C that do not launch.
extern "C" int ecnf_edge_tangent_plan(int dtype, int K, int B, int N, int U, int L, int C,
                                      int* smem_bytes, int* blocks_per_sm, int* row_tiles,
                                      int* staged) {
  if (!supported(K, B, N, U, L) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Config cfg = dtype == 0 ? configure<float>(K, N, U, L, C) : configure<bf16>(K, N, U, L, C);
  if (cfg.blocks_per_sm == 0) return static_cast<int>(cudaErrorInvalidValue);
  *smem_bytes = cfg.plan.total;
  *blocks_per_sm = cfg.blocks_per_sm;
  *row_tiles = cfg.MT;
  *staged = cfg.plan.res >= 0 ? 1 : 0;
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16.  Shapes and layouts as in Args; C
// columns per thread block (`ecnf_edge_tangent_columns` or the caller's).
// Requires 2 <= N <= 64, U in {32, 64, 128, 256}, 1 <= L <= 8, every
// pointer 32-byte aligned; the caller validates.  Returns a cudaError_t
// (0 on success) from the launch; cudaErrorInvalidConfiguration for a C
// that does not launch.
extern "C" int ecnf_edge_tangent(int dtype, int K, int B, int N, int U, int L, int C,
                                 const void* a_t, const void* b_t,
                                 const float* l2_t, const void* const* d_e,
                                 const void* const* d_x, const void* m,
                                 const void* g, const void* gd,
                                 const void* e_l, const void* const* e_tail,
                                 const void* const* x_tail, const void* x_out,
                                 const void* g_out, float* phi_t, float* mi_t,
                                 void* stream) {
  if (!supported(K, B, N, U, L)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run<float>(K, B, N, U, L, C, a_t, b_t, l2_t, d_e, d_x, m, g, gd, e_l,
                      e_tail, x_tail, x_out, g_out, phi_t, mi_t, s);
  if (dtype == 1)
    return run<bf16>(K, B, N, U, L, C, a_t, b_t, l2_t, d_e, d_x, m, g, gd, e_l,
                     e_tail, x_tail, x_out, g_out, phi_t, mi_t, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
