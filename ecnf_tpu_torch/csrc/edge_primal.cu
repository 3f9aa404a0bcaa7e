// The primal edge chain of one EGCL block in bf16, with the residuals the
// edge-tangent kernel reads (ops/edge_primal.py: `edge_primal`).  For
// sample b, receiver i and sender j (edge row (b, i, j), q = b N + i):
//
//   z_0   = ((a[b,j] + r[q]) + bf16(l2[q,j]) * e_l) + e_b[0]
//   z_l   = bf16(act_{l-1} @ W_l) + bias_l        l = 1 .. 2L - 1
//   d_l   = silu'(z_l), act_l = silu(z_l)         (d_e: l < L, d_x: l >= L)
//   m     = act_{L-1}
//   g     = sigmoid(bf16(m . g_out) + g_out_b),  gd = g * (1 - g)
//   phi   = f32(bf16(act_{2L-1} . x_out) + x_out_b)
//   m_i[q, :] = sum_{j != i} f32(m * g) / sqrt(N - 1)
//
// where a = h @ e_s (the sender rows), r = h @ e_r (the receiver rows) and
// W_l runs over phi_e's tail then phi_x's layers.  Every torch op of the
// plain version (`edge_primal_reference`) rounds its result to bf16, and
// so does this kernel, at the same points, with the `_rn` intrinsics (no
// product is contracted into the sum after it); the products accumulate in
// f32 and round once to bf16, as the bf16 `mm` does; sigmoid and silu are
// taken in f32 from the bf16 pre-activation, as torch does, and
// silu' = s * (1 + z * (1 - s)) in bf16 steps from the rounded sigmoid s.
//
// It replaces no Pallas kernel: on the TPU XLA fused these epilogues into
// the products of `ecnf_tpu/ops/pallas/tangent_kernel.py: _block_forward`,
// where the port ran them as some 80 PyTorch launches a block, each a pass
// over a [B, N, N, U] tensor.
//
// What bounds it on an H100: bytes.  At the QM9 Hutchinson shape (B=256,
// N=19, U=256, L=4) a launch has to write the 2L silu' factors and m,
// (2L + 1) x 47.3 MB, against 84.9 GFLOP of products: 130.7 us at 3.35 TB/s
// (all its bytes) against 85.8 us at the bf16 peak.  The design writes each
// residual once, in whole rows, and reads nothing back:
//
// - Grid: a thread block owns R whole receivers (R N <= 128 edge rows,
//   R = floor(128 / N)), which are R N consecutive rows of every
//   [B, N, N, U] output, and m_i sums each receiver's N senders inside the
//   block, in sender order, in f32, with no atomics: two runs agree bit for
//   bit.  Up to N = 64 (kMaxEdgeNodes) a block holds R >= 2 whole
//   receivers (LJ55: two, 110 of the 128 rows), so no sum spans blocks.
//   The blocks that fill whole waves of the card take R receivers; the
//   receivers left over are spread over one more wave of smaller blocks
//   (`make_grid`), so that the last wave does not run a few full blocks on
//   a mostly idle card (QM9: 792 blocks of 6 and 112 of 1, not 811 of 6).
// - Products: Hopper's warpgroup MMA (wgmma.mma_async m64nNk16, bf16 in,
//   f32 out), both operands read from shared memory by descriptor.  The
//   block's four warpgroups each take 64 rows and U / 2 outputs of the
//   128-row tile.  The activations stay in one tile of K-major 8 x 8 core
//   matrices, 144 bytes apart along K (16 bytes of padding each, so that
//   the row dots and the sender sum, which read along a row, meet no bank
//   conflict) and 16 bytes more between groups of 8 rows; a layer's
//   epilogue waits at a barrier, then writes silu in place as the next
//   layer's operand.  The 2L - 1 [U, U] weights stream through a ring of
//   three chunks of KC rows (cp.async, two chunks ahead), as N-major core
//   matrices copied straight from their [in, out] rows, which wgmma reads
//   transposed.
// - Epilogue: bias, silu and silu' in registers on the accumulators; silu'
//   goes through a row-major staging tile and leaves in whole rows of
//   16-byte streaming stores.  The gate's and phi_x's Dense(1) columns are
//   f32 row dots over the tile, one warp a row, after the layers that
//   produce m and the last activation.
//
// Why these choices, measured at the QM9 shape on an H100 SXM at 700 W:
// mma.sync from ldmatrix fragments spends half a block's clocks loading
// fragments (705 us a launch); silu' stored straight from the
// accumulators' layout (4 bytes a lane, 8 rows an instruction) costs 236
// of 807 us.  This design runs 650 us, 20% of the bound: about 44% of a
// block's clocks go to the products (waits for weight chunks 5%), 38% to
// the epilogues and the copies out, 8% to m, the gate and m_i, 7% to the
// first layer, and the products and epilogues of one block do not
// overlap.
//
// Shared memory per block at U=256, L=4: the 128-row tile (73,984 B), the
// staging tile (67,584 B), the ring (3 x 18,496 B), the biases and the
// gate, 200,960 B: one block of 512 threads per SM, 64 accumulator
// registers a thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <map>
#include <mutex>
#include <tuple>

#include "egnn_device.cuh"

namespace {

using namespace ecnf;
using bf16 = __nv_bfloat16;
using bf162 = __nv_bfloat162;

constexpr int kThreads = 512;
constexpr int kMaxRows = 128;  // edge rows of a block's tile, two halves of 64
constexpr int kMaxPasses = 2 * kMaxLayers - 1;
constexpr int kRing = 3;  // weight chunks in the ring
constexpr int kCore = 72;  // bf16 elements between core matrices: 128 B + 16 B padding
constexpr int kChunkBytes = 19 * 1024;  // at most, per ring buffer

struct Args {
  int B, N, U, L;
  int R, full, r_last;  // blocks [0, full) take R receivers each, the rest r_last
  const bf16* a;      // [B, N, U], the sender rows h @ e_s
  const bf16* r;      // [B, N, U], the receiver rows h @ e_r
  const float* l2;    // [B, N, N]
  const bf16* e_l;    // [U]
  const bf16* e_b0;   // [U], the first layer's bias
  const bf16* w[kMaxPasses];     // the 2L - 1 [U, U] layers: e_tail..., x_tail...
  const bf16* bias[kMaxPasses];  // their biases, [U] each
  const bf16* x_out;  // [U]
  const bf16* g_out;  // [U]
  const bf16* x_out_b;  // []
  const bf16* g_out_b;  // []
  bf16* d[2 * kMaxLayers];  // d_e[0..L-1] then d_x[0..L-1], [B, N, N, U] each
  bf16* m;            // [B, N, N, U]
  float* phi;         // [B, N, N]
  bf16* g;            // [B, N, N]
  bf16* gd;           // [B, N, N]
  float* m_i;         // [B, N, U]
};

// Byte offsets into a block's dynamic shared memory.
struct PrimalPlan {
  int act, stage, ring, bias, gate, total;
};

__host__ __device__ inline int align128(size_t n) {
  return static_cast<int>((n + 127) & ~static_cast<size_t>(127));
}

__host__ __device__ inline int receivers_per_block(int N) { return kMaxRows / N; }

// bf16 elements between the core-matrix rows of a tile (U / 8 cores of 8
// rows each, and 16 bytes more, so that the cores that wgmma reads side by
// side along M, or along K for the weights, start in other banks).
__host__ __device__ inline int group_elems(int U) { return (U / 8) * kCore + 8; }

// Weight rows per chunk of the ring: the most (a power of two, U at most)
// whose core matrices fit in kChunkBytes.
__host__ __device__ inline int chunk_rows(int U) {
  int kc = U;
  while (kc > 16 && static_cast<size_t>(kc / 8) * group_elems(U) * sizeof(bf16) > kChunkBytes)
    kc /= 2;
  return kc;
}

__host__ __device__ inline size_t chunk_elems(int U) {
  return static_cast<size_t>(chunk_rows(U) / 8) * group_elems(U);
}

__host__ __device__ inline PrimalPlan make_plan(int L, int U) {
  PrimalPlan p{};
  int o = 0;
  p.act = o;
  o += align128(static_cast<size_t>(kMaxRows / 8) * group_elems(U) * sizeof(bf16));
  p.stage = o;
  o += align128(static_cast<size_t>(kMaxRows) * (U + 8) * sizeof(bf16));
  p.ring = o;
  o += align128(kRing * chunk_elems(U) * sizeof(bf16));
  p.bias = o;
  o += align128(static_cast<size_t>(2 * L - 1) * U * sizeof(bf16));
  p.gate = o;
  o += align128(kMaxRows * sizeof(bf16));
  p.total = o;
  return p;
}

// Element (row, k) of the activation tile: K-major core matrices, core
// (row / 8, k / 8) at (row / 8) group_elems + (k / 8) kCore, 8 contiguous k
// of one row a 16-byte row of the core.
__device__ __forceinline__ int act_at(int row, int k, int U) {
  return (row >> 3) * group_elems(U) + (k >> 3) * kCore + ((row & 7) << 3) + (k & 7);
}

__device__ __forceinline__ bf162 as_bf162(unsigned v) { return *reinterpret_cast<const bf162*>(&v); }
__device__ __forceinline__ unsigned as_u32(bf162 v) { return *reinterpret_cast<const unsigned*>(&v); }

// silu and silu' of a pair of bf16 pre-activations: torch's sigmoid and
// silu in f32 (1 / (1 + e^-z), z / (1 + e^-z)), each rounded to bf16, and
// silu' = s * (1 + z * (1 - s)) from the rounded s, one bf16 rounding a
// step.
__device__ __forceinline__ void activate(bf162 z, bf162& act, bf162& dsilu) {
  const float2 zf = __bfloat1622float2(z);
  const float sx = __fdividef(1.f, 1.f + __expf(-zf.x));
  const float sy = __fdividef(1.f, 1.f + __expf(-zf.y));
  const bf162 s = __floats2bfloat162_rn(sx, sy);
  act = __floats2bfloat162_rn(zf.x * sx, zf.y * sy);
  const bf162 one = __float2bfloat162_rn(1.f);
  dsilu = __hmul2_rn(s, __hadd2_rn(one, __hmul2_rn(z, __hadd2_rn(one, __hneg2(s)))));
}

// d += a b over a 64 x NW x 16 step of a warpgroup: A K-major, B N-major
// (read transposed), f32 accumulators in the m16n8 fragment order per warp
// of 16 rows: d[4 j + 2 h + c] is row 16 warp + lane / 4 + 8 h, column
// 8 j + 2 (lane % 4) + c.
template <int NW>
__device__ __forceinline__ void wgmma(float (&d)[NW / 2], unsigned long long da,
                                      unsigned long long db);

template <>
__device__ __forceinline__ void wgmma<128>(float (&d)[64], unsigned long long da,
                                         unsigned long long db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, 1, 1, 1, 0, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db));
}

template <>
__device__ __forceinline__ void wgmma<64>(float (&d)[32], unsigned long long da,
                                         unsigned long long db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, 1, 1, 1, 0, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db));
}

template <>
__device__ __forceinline__ void wgmma<32>(float (&d)[16], unsigned long long da,
                                         unsigned long long db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
      "}, %16, %17, 1, 1, 1, 0, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db));
}

template <>
__device__ __forceinline__ void wgmma<16>(float (&d)[8], unsigned long long da,
                                         unsigned long long db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7 "
      "}, %8, %9, 1, 1, 1, 0, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db));
}

// Chunk ch of the weight stream into its ring buffer, one cp.async group
// (empty past the last chunk): rows [q KC, (q + 1) KC) of layer p's
// [U, U] weights, as N-major core matrices, core (k / 8, n / 8) at
// (k / 8) group_elems + (n / 8) kCore, 8 contiguous n of one k a 16-byte row.
__device__ __forceinline__ void load_chunk(const Args& a, bf16* ring, int ch, int P, int U,
                                           int KC, int lg_cpl, int lg_u8) {
  if (ch < P << lg_cpl) {
    const int p = ch >> lg_cpl, q = ch & ((1 << lg_cpl) - 1);
    const bf16* src = a.w[p] + static_cast<size_t>(q) * KC * U;
    bf16* dst = ring + (ch % kRing) * chunk_elems(U);
    for (int idx = threadIdx.x; idx < KC << lg_u8; idx += kThreads) {
      const int k = idx >> lg_u8, n8 = idx & ((1 << lg_u8) - 1);
      cp_async16(dst + (k >> 3) * group_elems(U) + n8 * kCore + ((k & 7) << 3), src + k * U + 8 * n8);
    }
  }
  cp_async_commit();
}

// 16 bytes of a tile row (8 contiguous units from `u`) of `src` to the
// same place of row `row` of a [., U] output, streaming: the next kernel to
// read the residuals finds them in device memory, not in L2.
__device__ __forceinline__ void store16(bf16* dst, size_t row, int U, int u, const void* src) {
  __stcs(reinterpret_cast<int4*>(dst + row * U + u), *reinterpret_cast<const int4*>(src));
}

// dot(row) = tile[row, :U] . v for row < rows, one warp per row, f32 sums;
// lane 0 calls emit(row, dot).
template <typename Emit>
__device__ __forceinline__ void tile_row_dots(const bf16* tile, const bf16* __restrict__ v,
                                              int rows, int U, Emit emit) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int row = warp; row < rows; row += kThreads / 32) {
    float s = 0.f;
    for (int c = 2 * lane; c < U; c += 64) {
      const float2 x = __bfloat1622float2(*reinterpret_cast<const bf162*>(tile + act_at(row, c, U)));
      const float2 y = __bfloat1622float2(as_bf162(__ldg(reinterpret_cast<const unsigned*>(v + c))));
      s = fmaf(x.x, y.x, s);
      s = fmaf(x.y, y.y, s);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) emit(row, s);
  }
}

// NW = U / 2, the outputs of a warpgroup.
template <int NW>
__global__ void __launch_bounds__(kThreads, 1)
    edge_primal_bf16_kernel(const __grid_constant__ Args a, const PrimalPlan pl) {
  ECNF_PROBE_SCOPE(probe, kProbeTotal);
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int U = 2 * NW;
  constexpr int lg_u8 = (U >= 256) + (U >= 128) + (U >= 64) + 2;  // log2 (U / 8)
  const int N = a.N, L = a.L, P = 2 * a.L - 1;
  const int KC = chunk_rows(U);
  const int lg_cpl = __ffs(U / KC) - 1;  // log2 of the chunks per layer
  const float inv_n = 1.f / static_cast<float>(N);
  const int x = blockIdx.x;
  const int q0 = x < a.full ? x * a.R : a.full * a.R + (x - a.full) * a.r_last;  // b N + i
  const int nr = min(x < a.full ? a.R : a.r_last, a.B * N - q0);
  const int rows = nr * N;
  const size_t row0 = static_cast<size_t>(q0) * N;  // first edge row
  const size_t out0 = row0 * U;  // the block's first element of a [B, N, N, U] output
  const int tid = threadIdx.x;

  bf16* act = reinterpret_cast<bf16*>(smem + pl.act);
  bf16* stage = reinterpret_cast<bf16*>(smem + pl.stage);  // [128][U + 8], silu' of a layer
  bf16* ring = reinterpret_cast<bf16*>(smem + pl.ring);
  bf16* bias_s = reinterpret_cast<bf16*>(smem + pl.bias);  // [P][U]
  bf16* g_s = reinterpret_cast<bf16*>(smem + pl.gate);  // [rows], the gate
  for (int ch = 0; ch < kRing - 1; ++ch) load_chunk(a, ring, ch, P, U, KC, lg_cpl, lg_u8);
  for (int idx = tid; idx < P * U / 8; idx += kThreads) {
    const int p = idx / (U / 8), u = 8 * (idx % (U / 8));
    *reinterpret_cast<uint4*>(bias_s + p * U + u) = __ldg(reinterpret_cast<const uint4*>(a.bias[p] + u));
  }

  // Tile rows, 16 bytes a thread, eight rows (one core-matrix column) per
  // eight threads: idx -> row (idx & 7) + 8 (idx >> (3 + lg_u8)), units
  // 8 ((idx >> 3) % (U / 8)).
  const int tile_units = ((rows + 7) >> 3) << (3 + lg_u8);
  auto row_of = [&](int idx) { return (idx & 7) | ((idx >> (3 + lg_u8)) << 3); };
  auto unit_of = [&](int idx) { return ((idx >> 3) & ((1 << lg_u8) - 1)) << 3; };

  // First layer: z = ((a[b, j] + r[q]) + bf16(l2) * e_l) + e_b0,
  // row = (q - q0) N + j.
  {
    ECNF_PROBE_SCOPE(probe_first, kProbeFirst);
    for (int idx = tid; idx < tile_units; idx += kThreads) {
      const int row = row_of(idx), u = unit_of(idx);
      if (row >= rows) continue;
      const int rq = __float2int_rz((static_cast<float>(row) + 0.5f) * inv_n);
      const int j = row - rq * N;
      const int q = q0 + rq;
      const int b = q / N;
      const uint4 av = __ldg(reinterpret_cast<const uint4*>(a.a + (static_cast<size_t>(b) * N + j) * U + u));
      const uint4 rv = __ldg(reinterpret_cast<const uint4*>(a.r + static_cast<size_t>(q) * U + u));
      const uint4 ev = __ldg(reinterpret_cast<const uint4*>(a.e_l + u));
      const uint4 bv = __ldg(reinterpret_cast<const uint4*>(a.e_b0 + u));
      const bf162 l2 = __float2bfloat162_rn(a.l2[row0 + row]);
      const unsigned* ap = &av.x;
      const unsigned* rp = &rv.x;
      const unsigned* ep = &ev.x;
      const unsigned* bp = &bv.x;
      uint4 act_v, d_v;
      unsigned* op = &act_v.x;
      unsigned* dp = &d_v.x;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const bf162 z = __hadd2_rn(
            __hadd2_rn(__hadd2_rn(as_bf162(ap[k]), as_bf162(rp[k])), __hmul2_rn(l2, as_bf162(ep[k]))),
            as_bf162(bp[k]));
        bf162 y, d;
        activate(z, y, d);
        op[k] = as_u32(y);
        dp[k] = as_u32(d);
      }
      *reinterpret_cast<uint4*>(act + act_at(row, u, U)) = act_v;
      store16(a.d[0] + out0, row, U, u, &d_v);
    }
  }

  // After the layer that makes m, past a barrier: m out, the gate, then
  // m_i; the next layer's barriers order these reads of `act` before its
  // epilogue.
  auto messages = [&]() {
    ECNF_PROBE_SCOPE(probe_dots, kProbeRowDots);
    for (int idx = tid; idx < tile_units; idx += kThreads) {
      const int row = row_of(idx), u = unit_of(idx);
      if (row < rows) store16(a.m + out0, row, U, u, act + act_at(row, u, U));
    }
    const bf16 gb = *a.g_out_b;
    tile_row_dots(act, a.g_out, rows, U, [&](int row, float s) {
      const float z = __bfloat162float(__hadd_rn(__float2bfloat16_rn(s), gb));
      const bf16 g = __float2bfloat16_rn(1.f / (1.f + expf(-z)));
      const bf16 gd = __hmul_rn(g, __hadd_rn(__float2bfloat16_rn(1.f), __hneg(g)));
      g_s[row] = g;
      a.g[row0 + row] = g;
      a.gd[row0 + row] = gd;
    });
    __syncthreads();
    // m_i[q, u] = sum_{j != i} f32(m * g) / sqrt(N - 1), two units at a time.
    const float sqrt_deg = sqrtf(static_cast<float>(N - 1));
    const int lg2 = lg_u8 + 2;  // log2 of the unit pairs per row
    for (int idx = tid; idx < nr << lg2; idx += kThreads) {
      const int rq = idx >> lg2;
      const int u = (idx & ((1 << lg2) - 1)) << 1;
      const int i = (q0 + rq) % N;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll 4
      for (int j = 0; j < N; ++j) {
        const bf162 t = __hmul2_rn(*reinterpret_cast<const bf162*>(act + act_at(rq * N + j, u, U)),
                                   __bfloat162bfloat162(g_s[rq * N + j]));
        const float2 f = __bfloat1622float2(t);
        s0 += j == i ? 0.f : f.x;
        s1 += j == i ? 0.f : f.y;
      }
      *reinterpret_cast<float2*>(a.m_i + static_cast<size_t>(q0 + rq) * U + u) =
          make_float2(s0 / sqrt_deg, s1 / sqrt_deg);
    }
  };

  if (L == 1) {
    __syncthreads();
    messages();
  }

  // Warpgroup wg takes tile rows 64 (wg & 1) + [0, 64) and outputs
  // NW (wg >> 1) + [0, NW); its warp's lanes own rows 16 (warp % 4) + lane / 4
  // (+ 8) of those.
  const int wg = tid / 128, lane = tid % 32;
  const int rbase = 64 * (wg & 1) + 16 * ((tid / 32) % 4) + lane / 4;
  const int cbase = NW * (wg >> 1) + 2 * (lane % 4);
  constexpr unsigned kCoreBytes = kCore * sizeof(bf16);
  const unsigned group_bytes = group_elems(U) * sizeof(bf16);
  const bf16* a_tile = act + (64 * (wg & 1) / 8) * group_elems(U);
  const int b_col = (NW * (wg >> 1) / 8) * kCore;

  // Pass p: z = bf16(act @ W_p) + bias_p, silu in place, silu' to the
  // stage tile, which then leaves in whole rows of 16-byte stores (rows
  // past `rows` are padding).
  for (int p = 0; p < P; ++p) {
    float acc[NW / 2];
#pragma unroll
    for (int e = 0; e < NW / 2; ++e) acc[e] = 0.f;
    {
      ECNF_PROBE_SCOPE(probe_dense, kProbeDense);
      for (int q = 0; q < 1 << lg_cpl; ++q) {
        const int ch = (p << lg_cpl) + q;
        {
          ECNF_PROBE_SCOPE(probe_wait, kProbeDenseWait);
          cp_async_wait<kRing - 2>();
          fence_async_smem();  // the chunk and the last epilogue, to wgmma's view
          __syncthreads();  // chunk ch has landed; chunk ch - 1's buffer is free
        }
        load_chunk(a, ring, ch + kRing - 1, P, U, KC, lg_cpl, lg_u8);
        const bf16* chunk = ring + (ch % kRing) * chunk_elems(U) + b_col;
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        for (int kk = 0; kk < KC / 16; ++kk) {
          const int k0 = q * KC + 16 * kk;
          wgmma<NW>(acc,
                    smem_desc(a_tile + (k0 / 8) * kCore, kCoreBytes, group_bytes),
                    smem_desc(chunk + 2 * kk * group_elems(U), group_bytes, kCoreBytes));
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      }
      __syncthreads();  // every warpgroup's reads of `act` are done
    }
    ECNF_PROBE_SCOPE(probe_epi, kProbeSilu);
    const bf16* bias = bias_s + p * U;
#pragma unroll
    for (int j = 0; j < NW / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = rbase + 8 * h, o = cbase + 8 * j;
        const bf162 z = __hadd2_rn(__floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]),
                                   *reinterpret_cast<const bf162*>(bias + o));
        bf162 y, d;
        activate(z, y, d);
        *reinterpret_cast<bf162*>(act + act_at(row, o, U)) = y;
        *reinterpret_cast<bf162*>(stage + row * (U + 8) + o) = d;
      }
    __syncthreads();
    for (int idx = tid; idx < rows << lg_u8; idx += kThreads) {
      const int row = idx >> lg_u8, u = (idx & ((1 << lg_u8) - 1)) << 3;
      store16(a.d[p + 1] + out0, row, U, u, stage + row * (U + 8) + u);
    }
    if (p == L - 2) messages();
  }

  // phi = f32(bf16(act . x_out) + x_out_b), per row.
  const bf16 xb = *a.x_out_b;
  tile_row_dots(act, a.x_out, rows, U, [&](int row, float s) {
    a.phi[row0 + row] = __bfloat162float(__hadd_rn(__float2bfloat16_rn(s), xb));
  });
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

const void* kernel_for(int U) {
  switch (U) {
    case 32: return reinterpret_cast<const void*>(edge_primal_bf16_kernel<16>);
    case 64: return reinterpret_cast<const void*>(edge_primal_bf16_kernel<32>);
    case 128: return reinterpret_cast<const void*>(edge_primal_bf16_kernel<64>);
    case 256: return reinterpret_cast<const void*>(edge_primal_bf16_kernel<128>);
  }
  return nullptr;
}

bool supported(int B, int N, int U, int L) {
  return B >= 1 && N >= 2 && N <= kMaxEdgeNodes && L >= 1 && L <= kMaxLayers &&
         (U == 32 || U == 64 || U == 128 || U == 256) &&
         static_cast<long long>(B) * N <= (1 << 30);
}

// Blocks of kThreads per SM with `smem` bytes of dynamic shared memory, 0
// if it does not launch; cached per device, kernel and size, since every
// launch asks.
int occupancy(const void* fn, int smem) {
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
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, kThreads, smem) != cudaSuccess)
    n = 0;
  cache[key] = n;
  return n;
}

// Blocks [0, full) take R receivers; the Q - full R left over (if any) go
// to blocks of r_last <= R, spread over the `slots` blocks that run at once.
struct Grid {
  int full, r_last, blocks;
};

Grid make_grid(int Q, int R, int slots) {
  const int full = static_cast<int>(Q / (static_cast<long long>(R) * slots)) * slots;
  const int rest = Q - full * R;
  if (rest == 0) return Grid{full, R, full};
  const int r_last = (rest + slots - 1) / slots;
  return Grid{full, r_last, full + (rest + r_last - 1) / r_last};
}

// Blocks of the kernel that run at once on the current card, 0 if it does
// not launch.
int slots(const void* fn, int smem) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms * occupancy(fn, smem);
}

}  // namespace

// Shapes and layouts as in Args; U in {32, 64, 128, 256}, 2 <= N <= 64,
// 1 <= L <= 8, every [.., U] pointer 16-byte aligned; the caller
// validates.  e_b, x_b: L pointers each; e_tail: L - 1; x_tail: L; d_e,
// d_x: L each.  Returns a cudaError_t (0 on success) from the launch.
extern "C" int ecnf_edge_primal(int B, int N, int U, int L, const void* a, const void* r,
                                const float* l2, const void* e_l, const void* const* e_b,
                                const void* const* e_tail, const void* const* x_tail,
                                const void* const* x_b, const void* x_out, const void* x_out_b,
                                const void* g_out, const void* g_out_b, void* const* d_e,
                                void* const* d_x, void* m, float* phi, void* g, void* gd,
                                float* m_i, void* stream) {
  if (!supported(B, N, U, L)) return static_cast<int>(cudaErrorInvalidValue);
  const PrimalPlan pl = make_plan(L, U);
  const void* fn = kernel_for(U);
  const int n = slots(fn, pl.total);
  if (n == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const Grid grid = make_grid(B * N, receivers_per_block(N), n);
  Args args{};
  args.B = B;
  args.N = N;
  args.U = U;
  args.L = L;
  args.R = receivers_per_block(N);
  args.full = grid.full;
  args.r_last = grid.r_last;
  args.a = static_cast<const bf16*>(a);
  args.r = static_cast<const bf16*>(r);
  args.l2 = l2;
  args.e_l = static_cast<const bf16*>(e_l);
  args.e_b0 = static_cast<const bf16*>(e_b[0]);
  for (int l = 1; l < L; ++l) {
    args.w[l - 1] = static_cast<const bf16*>(e_tail[l - 1]);
    args.bias[l - 1] = static_cast<const bf16*>(e_b[l]);
  }
  for (int l = 0; l < L; ++l) {
    args.w[L - 1 + l] = static_cast<const bf16*>(x_tail[l]);
    args.bias[L - 1 + l] = static_cast<const bf16*>(x_b[l]);
    args.d[l] = static_cast<bf16*>(d_e[l]);
    args.d[L + l] = static_cast<bf16*>(d_x[l]);
  }
  args.x_out = static_cast<const bf16*>(x_out);
  args.g_out = static_cast<const bf16*>(g_out);
  args.x_out_b = static_cast<const bf16*>(x_out_b);
  args.g_out_b = static_cast<const bf16*>(g_out_b);
  args.m = static_cast<bf16*>(m);
  args.phi = phi;
  args.g = static_cast<bf16*>(g);
  args.gd = static_cast<bf16*>(gd);
  args.m_i = m_i;
  void* params[] = {&args, const_cast<PrimalPlan*>(&pl)};
  return static_cast<int>(cudaLaunchKernel(fn, dim3(grid.blocks), dim3(kThreads), params,
                                           static_cast<size_t>(pl.total),
                                           static_cast<cudaStream_t>(stream)));
}
