// The bf16 sibling of `dense_staged` (egnn_device.cuh): a chain of
// [rows, U] @ [U, U] products on the tensor cores in bf16 with f32
// accumulation, for the edge-tangent kernel (edge_tangent.cu).
//
// A pass takes one layer of the chain: out(r, :U) = in(r, :U) @ W_p for
// the rows r < rows of a bf16 tile in shared memory, with warp-level
// mma.sync m16n8k16 (bf16 in, f32 out), in 16-row tiles spread over the
// warps as `mma_layout` spreads them (a warp owns nt <= 4 adjacent 8-wide
// output tiles and every wr-th row tile).  The accumulators stay in
// registers: the caller's epilogue gets them, two adjacent outputs at a
// time, and writes its result to another tile, so a pass needs no staging
// tile in shared memory and no barrier of its own at its end.
//
// Fragments come from shared memory through ldmatrix: A (x4) from the
// activation tile, B (x4.trans, or x2.trans for a lone 8-wide tile) from
// the weights, which stay [in, out] row-major as the caller stores them.
// Rows of both are padded to U + 8 bf16 (a multiple of 16 bytes past a
// multiple of 128), so the eight 16-byte rows of each 8x8 matrix fall in
// distinct bank groups.  A warp's k-step loads the A fragments of all its
// row tiles first, then issues its mma's, with no branch between them: a
// row tile that lies wholly past `rows` (a warp's share can be uneven)
// runs on clamped copies of row rows - 1, and its results are dropped.
// The last, partly filled row tile is computed whole, and its rows past
// `rows` go to the epilogue too, so the tiles must hold 16 ceil(rows / 16)
// rows; what those padding rows hold does not reach the real ones.
//
// At a width of 128 or 256 a row's product is only 8 or 16 mma steps deep,
// so per output the tensor-core work is a few clocks and the epilogue's
// per-element instructions weigh as much: the caller keeps it to a load, a
// conversion, a bf16x2 multiply and a store.  (Loading the epilogue's
// operands before the products instead holds 2 MT nt registers through
// them, and at 128 registers a thread that spills.)
//
// The weights of all P layers of the chain stream through one ring of
// kBfStages chunks of KC rows (`BfWeights`), copied with cp.async
// kBfStages - 1 chunks ahead of their use.  Chunk q of layer p is chunk
// p * (U / KC) + q of the stream, so the first chunks of the next layer
// are in flight while a layer finishes and while the caller works between
// passes.  A chunk's wait ends at a block-wide barrier, after which the
// buffer of the chunk before it is free; that barrier also orders the
// previous pass's epilogue writes before this pass's reads.  Beside its
// weights, each layer brings the rows its epilogue reads (the silu'
// factors of the caller's N senders, [n, U]), in the same cp.async group
// as its first chunk, into one of kBfStages buffers (`epi_rows`; the
// stream runs at most kBfStages - 1 chunks, so layers, ahead): the epilogue
// then reads shared memory, and holds no registers through the products
// for operands in flight.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "egnn_device.cuh"

namespace ecnf {

using bf16 = __nv_bfloat16;

constexpr int kBfStages = 3;
constexpr int kBfChunkBytes = 18 * 1024;  // at most, per ring buffer

// Weight rows per chunk: the most (a power of two, U at most) whose
// padded rows fit in kBfChunkBytes.
__host__ __device__ inline int bf_chunk_rows(int U) {
  int kc = U;
  while (kc > 16 && static_cast<size_t>(kc) * (U + 8) * sizeof(bf16) > kBfChunkBytes) kc /= 2;
  return kc;
}

__host__ __device__ inline size_t bf_ring_bytes(int U) {
  return static_cast<size_t>(kBfStages) * bf_chunk_rows(U) * (U + 8) * sizeof(bf16);
}

// The weights of a chain of P [U, U] layers and their ring in shared
// memory (kBfStages x [KC, U + 8]), and the layers' epilogue rows and
// their buffers in shared memory (kBfStages x [n, U + 8]).
struct BfWeights {
  const bf16* const* W;  // P pointers, [U, U] each, [in, out]
  int P, U, KC;
  bf16* ring;
  const bf16* const* E;  // P pointers; layer p's rows are E[p] + e_off, [n, U]
  size_t e_off;
  int n;
  bf16* ebuf;
};

__host__ __device__ inline size_t bf_epi_bytes(int n, int U) {
  return static_cast<size_t>(kBfStages) * n * (U + 8) * sizeof(bf16);
}

// Layer p's epilogue rows in shared memory (row stride U + 8), once its
// first chunk has landed.
__device__ __forceinline__ const bf16* epi_rows(const BfWeights& w, int p) {
  return w.ebuf + (p % kBfStages) * w.n * (w.U + 8);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x2_trans(unsigned (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// c += a b over one 16 x 8 x 16 tile (mma.sync m16n8k16, bf16 in, f32
// out).  Lane l = 4 g + t holds a = A[g][2t:2t+2], A[g + 8][2t:2t+2],
// A[g][2t+8:2t+10], A[g + 8][2t+8:2t+10]; b = B[2t:2t+2][g],
// B[2t+8:2t+10][g]; c = C[g][2t], C[g][2t + 1], C[g + 8][2t],
// C[g + 8][2t + 1].
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy chunk ch of the stream into its ring buffer and commit one cp.async
// group (empty past the last chunk), so that waiting for all but the
// newest kBfStages - 2 groups always means "chunk ch - kBfStages + 2 has
// landed".
template <int NT>
__device__ __forceinline__ void bf_issue(const BfWeights& w, int ch) {
  const int cpl = w.U / w.KC;  // both powers of two
  if (ch < w.P * cpl) {
    const int q = ch & (cpl - 1);
    const bf16* src = w.W[ch / cpl] + static_cast<size_t>(q) * w.KC * w.U;
    bf16* dst = w.ring + (ch % kBfStages) * w.KC * (w.U + 8);
    const int lg = __ffs(w.U) - 4;  // log2 of the 16-byte units per weight row
    for (int idx = threadIdx.x; idx < w.KC << lg; idx += NT) {
      const int k = idx >> lg;
      const int o = 8 * (idx & ((1 << lg) - 1));
      cp_async16(dst + k * (w.U + 8) + o, src + k * w.U + o);
    }
    if (q == 0) {  // the layer's epilogue rows; the buffer's previous
                   // layer, kBfStages back, has passed its epilogue
      const int p = ch / cpl;
      const bf16* e = w.E[p] + w.e_off;
      bf16* edst = w.ebuf + (p % kBfStages) * w.n * (w.U + 8);
      for (int idx = threadIdx.x; idx < w.n << lg; idx += NT) {
        const int k = idx >> lg;
        const int o = 8 * (idx & ((1 << lg) - 1));
        cp_async16(edst + k * (w.U + 8) + o, e + k * w.U + o);
      }
    }
  }
  cp_async_commit();
}

// Start the stream: its first kBfStages - 1 chunks.
template <int NT>
__device__ __forceinline__ void bf_prologue(const BfWeights& w) {
#pragma unroll
  for (int ch = 0; ch < kBfStages - 1; ++ch) bf_issue<NT>(w, ch);
}

// Layer p of the chain over the rows r < rows of `in` (row stride ld, a
// multiple of 8, 16-byte aligned rows): for each output pair (r, o), o
// even, that this thread owns, epi(r, o, (out[r][o], out[r][o + 1])) runs
// after the products, also for the padding rows rows <= r < 16 ceil(rows /
// 16), whose values are meaningless.  With FOLD, epi returns its pair's
// share of a row's dot product with a vector (a Dense(1) layer folded into
// the epilogue): the shares are summed over a warp's outputs, and one lane
// calls fold(r, q, sum) for each of its rows, q = the warp's column group
// (0 <= q < wc of `mma_layout`); the row's dot is the sum over q, which
// the caller takes after a barrier.  Every thread of the block must call
// it, for p = 0, 1, ..., P - 1 in turn, after `bf_prologue`.  epi and fold
// must not write `in`: the pass ends without a barrier.
template <int NT, int MT, bool FOLD, typename Epi, typename Fold>
__device__ __forceinline__ void dense_bf16(const bf16* in, int ld, int rows,
                                           const BfWeights& w, int p, Epi epi,
                                           Fold fold) {
  ECNF_PROBE_SCOPE(probe, kProbeDense);
  const int U = w.U, KC = w.KC, ldw = U + 8, cpl = U / KC;
  const MmaLayout m = mma_layout(NT / 32, U, rows);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int col0 = (warp % m.wc) * m.nt * 8;
  const int wy = warp / m.wc;
  // ldmatrix row addresses.  A (x4): lane l gives row l % 16 of a row
  // tile at depth 8 (l / 16).  B (x4.trans over two 8-wide output tiles,
  // or x2.trans over one): lane l gives weight row l % 16 of a 16-deep
  // step at output col0 + 8 (l / 16).
  int a_off[MT];
  bool live[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int r0 = (wy + i * m.wr) * 16;
    live[i] = r0 < rows;  // the same for the whole warp
    a_off[i] = min(r0 + lane % 16, rows - 1) * ld + 8 * (lane / 16);
  }
  const int b_off = (lane % 16) * ldw + col0 + (m.nt > 1 ? 8 * (lane / 16) : 0);
  float acc[MT][kWarpCols][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < kWarpCols; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  for (int q = 0; q < cpl; ++q) {
    const int ch = p * cpl + q;
    {
      ECNF_PROBE_SCOPE(probe_wait, kProbeDenseWait);
      cp_async_wait<kBfStages - 2>();
      __syncthreads();  // chunk ch has landed; chunk ch - 1's buffer is free
    }
    bf_issue<NT>(w, ch + kBfStages - 1);
    const bf16* Ws = w.ring + (ch % kBfStages) * KC * ldw + b_off;
    const bf16* x = in + q * KC;
    // One 16-deep step: its fragments, then its mma's.
    auto load_step = [&](int c, unsigned (&a)[MT][4], unsigned (&b)[kWarpCols][2]) {
      if (m.nt == 1) {
        ldmatrix_x2_trans(b[0], Ws + c * ldw);
      } else {
#pragma unroll
        for (int j = 0; j < kWarpCols; j += 2)
          if (j < m.nt) {
            unsigned r4[4];
            ldmatrix_x4_trans(r4, Ws + c * ldw + 8 * j);
            b[j][0] = r4[0];
            b[j][1] = r4[1];
            b[j + 1][0] = r4[2];
            b[j + 1][1] = r4[3];
          }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) ldmatrix_x4(a[i], x + a_off[i] + c);
    };
    auto mma_step = [&](const unsigned (&a)[MT][4], const unsigned (&b)[kWarpCols][2]) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < kWarpCols; ++j)
          if (j < m.nt) mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
    };
#pragma unroll 2
    for (int c = 0; c < KC; c += 16) {
      unsigned a[MT][4], b[kWarpCols][2];
      load_step(c, a, b);
      mma_step(a, b);
    }
  }

  ECNF_PROBE_SCOPE(probe_epi, kProbeSilu);
#pragma unroll
  for (int i = 0; i < MT; ++i)
    if (live[i]) {
      const int r = (wy + i * m.wr) * 16 + g;
      float dot0 = 0.f, dot1 = 0.f;
#pragma unroll
      for (int j = 0; j < kWarpCols; ++j)
        if (j < m.nt) {
          const int o = col0 + 8 * j + 2 * t;
          dot0 += epi(r, o, make_float2(acc[i][j][0], acc[i][j][1]));
          dot1 += epi(r + 8, o, make_float2(acc[i][j][2], acc[i][j][3]));
        }
      if (FOLD) {
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          dot0 += __shfl_xor_sync(0xffffffffu, dot0, off);
          dot1 += __shfl_xor_sync(0xffffffffu, dot1, off);
        }
        if (t == 0) {
          fold(r, warp % m.wc, dot0);
          fold(r + 8, warp % m.wc, dot1);
        }
      }
    }
}

}  // namespace ecnf
