// Device code shared by the EGCL-forward kernel (egcl.cu) and the fused
// forward + exact-trace kernel (fused_trace.cu).
//
// Both run one EGNN block receiver by receiver.  A thread block holds the
// N nodes of one sample in shared memory and, for receiver i, pushes the N
// sender rows of i through phi_e, the gate, phi_x and the coordinate
// update (`receiver_pass`); phi_h then runs for a group of receivers at
// once (`node_update`).  The rows come in S "slots": slot 0
// is the primal, slots 1..S-1 are tangent columns (forward-mode JVP), and
// all slots go through each layer together, so one read of a weight row
// serves S * N rows.  The tangent of a silu layer needs the silu' of the
// primal row of the same sender, so every layer ends with an elementwise
// pass that, per (sender j, unit o), reads the primal pre-activation z,
// scales each slot's tangent by silu'(z) and then writes silu(z).  No
// residual outlives its layer: the tangent math is that of
// `ecnf_tpu_torch/ops/tangent.py` (`block_forward`, `_block_tangent`,
// `edge_tangent_reference`), evaluated in lockstep with the primal.
//
// Everything is f32-accurate: the dense passes over the edge and node rows
// (`dense_staged`) run on the tensor cores in 3xTF32, each f32 operand
// split into two TF32 halves and each product taken as three TF32 mma's
// (one TF32 product would miss the port's f32 limits of 1e-4); the rest
// runs in f32 on the CUDA cores.  The weights of one EGNN block are
// one packed f32 buffer whose order is `ops/egcl.py: weight_list` (the JAX
// `_flatten_egcl_weights` order), every segment padded to a multiple of 4
// floats; `make_layout` below walks the same order.

#pragma once

#include <cuda_runtime.h>

namespace ecnf {

constexpr int kMaxLayers = 8;
constexpr int kMaxNodes = 32;  // the EGCL and fused-trace kernels: a sample's N nodes a block
// The edge kernels (edge_tangent.cu, edge_primal.cu) hold only the sender
// rows of one or a few receivers in a block, cut into row tiles, so they
// take more nodes than the EGCL and fused-trace kernels.
constexpr int kMaxEdgeNodes = 64;
constexpr int kMaxDim = 4;
constexpr int kStageFloats = 4096;  // one weight chunk, 16 KB
constexpr int kStages = 3;  // chunks in flight or in use

// Clock probes, compiled only with -DECNF_PROBE (`kernel_probe.py`):
// thread 0 of every thread block adds the SM clocks it spends in each part
// to ecnf_probe_clocks, which `ecnf_probe_clocks_read` copies out and
// clears.  Thread 0 waits at the same barriers as the other threads, so its
// clocks are the block's.
enum ProbePart {
  kProbeTotal, kProbeDense, kProbeDenseWait, kProbeSilu, kProbeFirst, kProbeRowDots, kProbeParts
};
#ifdef ECNF_PROBE
__device__ unsigned long long ecnf_probe_clocks[kProbeParts];

#ifdef __CUDA_ARCH__
struct ProbeScope {
  int part;
  long long t0;
  __device__ explicit ProbeScope(int p) : part(p), t0(clock64()) {}
  __device__ ~ProbeScope() {
    if (threadIdx.x == 0)
      atomicAdd(&ecnf_probe_clocks[part], static_cast<unsigned long long>(clock64() - t0));
  }
};
#define ECNF_PROBE_SCOPE(name, part) const ProbeScope name(part)
#else
#define ECNF_PROBE_SCOPE(name, part)
#endif

extern "C" int ecnf_probe_clocks_read(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, ecnf_probe_clocks, sizeof(ecnf_probe_clocks));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[kProbeParts] = {};
  return static_cast<int>(cudaMemcpyToSymbol(ecnf_probe_clocks, zero, sizeof(zero)));
}
#else
#define ECNF_PROBE_SCOPE(name, part)
#endif

__host__ __device__ inline int pad4(int n) { return (n + 3) & ~3; }

__host__ __device__ inline int take(int& offset, int n) {
  const int at = offset;
  offset += pad4(n);
  return at;
}

// Float offsets of one block's weights in the packed buffer.  Kernels are
// [in, out] and row-major.
struct Layout {
  int cd_h, cd_t, cd_b;             // time ConcatDense: [H, H], [T, H], [H]
  int e_s, e_r, e_l;                // phi_e first layer: [H, U], [H, U], [U]
  int e_b[kMaxLayers];              // phi_e biases, L x [U]
  int e_tail[kMaxLayers];           // phi_e kernels 1.., (L-1) x [U, U]
  int x_tail[kMaxLayers];           // phi_x kernels, L x [U, U]
  int x_b[kMaxLayers];              // phi_x biases, L x [U]
  int x_out, x_out_b, g_out, g_out_b;  // Dense(1) of phi_x and of the gate
  int h_m, h_h;                     // phi_h first layer: [U, U], [H, U]
  int h_b[kMaxLayers + 1];          // phi_h biases, L x [U] and [H]
  int h_tail[kMaxLayers];           // phi_h kernels 1.., (L-1) x [U, U]
  int h_out;                        // phi_h last kernel, [U, H]
  int size;                         // floats per block
};

__host__ __device__ inline Layout make_layout(int H, int T, int U, int L) {
  Layout y{};
  int o = 0;
  y.cd_h = take(o, H * H);
  y.cd_t = take(o, T * H);
  y.cd_b = take(o, H);
  y.e_s = take(o, H * U);
  y.e_r = take(o, H * U);
  y.e_l = take(o, U);
  y.e_b[0] = take(o, U);
  for (int l = 1; l < L; ++l) {
    y.e_tail[l - 1] = take(o, U * U);
    y.e_b[l] = take(o, U);
  }
  for (int l = 0; l < L; ++l) {
    y.x_tail[l] = take(o, U * U);
    y.x_b[l] = take(o, U);
  }
  y.x_out = take(o, U);
  y.x_out_b = take(o, 1);
  y.g_out = take(o, U);
  y.g_out_b = take(o, 1);
  y.h_m = take(o, U * U);
  y.h_h = take(o, H * U);
  y.h_b[0] = take(o, U);
  for (int l = 1; l < L; ++l) {
    y.h_tail[l - 1] = take(o, U * U);
    y.h_b[l] = take(o, U);
  }
  y.h_out = take(o, U * H);
  y.h_b[L] = take(o, H);
  y.size = o;
  return y;
}

struct Dims {
  int N, D, H, T, U, L;
  float C;  // normalization_constant
};

// Float offsets into dynamic shared memory for S slots, with phi_h run
// for `group` receivers at a time.  [S][N][...] arrays hold slot s at
// s * N rows.  Rows that a dense pass reads are padded by 8 floats
// (lh = H + 8, lu = U + 8), so that the rows a warp reads at once fall in
// distinct banks.
struct Plan {
  int lh, lu;
  int vec, vec_new, init_vec, pos_mean, temb, tb;
  int hb;  // [S][N][H] block input h (before the ConcatDense), then h_out
  int hc;  // [S][N][H] h after the ConcatDense (tangent: without bias)
  int tile;  // [S*N][U] edge rows, updated in place layer by layer
  int stage;  // [kStages][kStageFloats] weight chunks of the staged passes
  int bi;  // [S][U] the receiver's first-layer term hc_i @ e_r
  int mi;  // [S][group][U] gated message sums, then phi_h rows, in place
  int l2, len, g, phi, w;  // [N] primal per-edge scalars
  int l2t, lent, gt, phit, wt, dot;  // [S][N] per-edge tangents, row dots
  int total;
};

__host__ __device__ inline Plan make_plan(const Dims& d, int S, int group) {
  Plan p{};
  int o = 0;
  const int SN = S * d.N;
  p.lh = d.H + 8;
  p.lu = d.U + 8;
  p.vec = take(o, SN * d.D);
  p.vec_new = take(o, SN * d.D);
  p.init_vec = take(o, d.N * d.D);
  p.pos_mean = take(o, d.D);
  p.temb = take(o, d.T);
  p.tb = take(o, d.H);
  p.hb = take(o, SN * p.lh);
  p.hc = take(o, SN * p.lh);
  p.tile = take(o, SN * p.lu);
  p.stage = take(o, kStages * kStageFloats);
  p.bi = take(o, S * p.lu);
  p.mi = take(o, S * group * p.lu);
  p.l2 = take(o, d.N);
  p.len = take(o, d.N);
  p.g = take(o, d.N);
  p.phi = take(o, d.N);
  p.w = take(o, d.N);
  p.l2t = take(o, SN);
  p.lent = take(o, SN);
  p.gt = take(o, SN);
  p.phit = take(o, SN);
  p.wt = take(o, SN);
  p.dot = take(o, SN);
  p.total = o;
  return p;
}

// Shapes the kernels take: U and H powers of two (a tensor-core pass
// takes 8-wide output tiles and 8-deep steps, and `dense` maps 4 outputs
// to a thread and needs NT % (width / 4) == 0), 8 <= H <= U.
inline bool supported(int N, int D, int H, int T, int U, int L) {
  auto pow2 = [](int x) { return x > 0 && (x & (x - 1)) == 0; };
  return N >= 2 && N <= kMaxNodes && D >= 1 && D <= kMaxDim && T >= 1 &&
         L >= 1 && L <= kMaxLayers && pow2(U) && U >= 32 && U <= 256 &&
         pow2(H) && H >= 8 && H <= U;
}

// Rows that one dense pass of NT threads over `Uo` outputs covers per
// unit of R (a thread owns 4 outputs).
__host__ __device__ inline int row_groups(int NT, int Uo) { return 4 * NT / Uo; }

__device__ __forceinline__ float sigmoid(float z) { return 1.f / (1.f + expf(-z)); }

__device__ __forceinline__ void fma4(float4& a, float x, const float4& w) {
  a.x = fmaf(x, w.x, a.x);
  a.y = fmaf(x, w.y, a.y);
  a.z = fmaf(x, w.z, a.z);
  a.w = fmaf(x, w.w, a.w);
}

// The thread tiling of a dense pass over Uo outputs: thread (og, rg) owns
// outputs 4 og .. 4 og + 3 of rows rg, rg + G, ...  A warp covers ow
// output groups x 32 / ow row groups: one 128-byte weight row segment and
// up to 8 (bank-disjoint) input rows per read.
struct Tile {
  int tpr, G, og, rg;
};

template <int NT>
__device__ __forceinline__ Tile tile_of(int Uo) {
  const int tpr = Uo >> 2;
  const int ow = tpr < 8 ? tpr : 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wx = tpr / ow;  // warps across the outputs
  return Tile{tpr, NT / tpr, (warp % wx) * ow + lane % ow, (warp / wx) * (32 / ow) + lane / ow};
}

// acc(r, o:o+4) = sum_c in[r * ld + c] * W[c * Uo + o] for every row
// r < rows, then epi(r, o, acc).  A thread owns 4 consecutive outputs and
// the rows rg, rg + G, ..., rg + (R - 1) G (G = 4 NT / Uo row groups;
// rows <= R * G), so a weight float4 feeds 16 R FMAs and the row reads
// are shared-memory broadcasts.  Every thread runs all R rows, the ones
// past `rows` on a clamped copy whose result is dropped: the loop has no
// branch, so its loads can be issued ahead.  The sum runs over c in
// order.  K, ld and Uo are multiples of 4; `in` and W are 16-byte
// aligned.  This form, on the CUDA cores, reads the weights from L1/L2 and
// serves the receiver's first-layer term (S rows); `dense_staged` below
// serves the edge and node passes on the tensor cores.
template <int NT, int R, typename Epi>
__device__ __forceinline__ void dense(const float* in, int ld, int K,
                                      const float* __restrict__ W, int Uo,
                                      int rows, Epi epi) {
  ECNF_PROBE_SCOPE(probe, kProbeFirst);
  const Tile t = tile_of<NT>(Uo);
  const int tpr = t.tpr, G = t.G, og = t.og, rg = t.rg;
  int xo[R];
  float4 acc[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    xo[k] = min(rg + k * G, rows - 1) * ld;
    acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  // The next 4 weight rows are fetched while the current 4 are used: the
  // warps of a block reach each row together, so an L2 miss would
  // otherwise stall all of them at once.
  const float4* W4 = reinterpret_cast<const float4*>(W) + og;
  float4 n0 = __ldg(W4), n1 = __ldg(W4 + tpr), n2 = __ldg(W4 + 2 * tpr), n3 = __ldg(W4 + 3 * tpr);
  for (int c = 0; c < K; c += 4) {
    const float4 w0 = n0, w1 = n1, w2 = n2, w3 = n3;
    if (c + 4 < K) {
      const float4* next = W4 + (c + 4) * tpr;
      n0 = __ldg(next);
      n1 = __ldg(next + tpr);
      n2 = __ldg(next + 2 * tpr);
      n3 = __ldg(next + 3 * tpr);
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const float4 x = *reinterpret_cast<const float4*>(in + xo[k] + c);
      fma4(acc[k], x.x, w0);
      fma4(acc[k], x.y, w1);
      fma4(acc[k], x.z, w2);
      fma4(acc[k], x.w, w3);
    }
  }
#pragma unroll
  for (int k = 0; k < R; ++k)
    if (rg + k * G < rows) epi(rg + k * G, og * 4, acc[k]);
}

// Offset of row r = s * n + j of an [S][n] row block: s * slot_ld + j * ld.
__device__ __forceinline__ int row_at(int r, int n, int ld, int slot_ld) {
  return (r / n) * slot_ld + (r % n) * ld;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Tensor-core products in f32 accuracy ("3xTF32").  An f32 x is split
// into two TF32 operands, hi = the TF32 value nearest x (ties away from
// zero) and lo = x - hi (exact in f32; the tensor cores read its top 19
// bits), and a product takes three TF32 mma's into an f32 accumulator:
// a_lo b_hi + a_hi b_lo + a_hi b_hi.  What is dropped, a_lo b_lo and lo's
// low bits, is ~2^-21 of a b, so the result keeps f32 accuracy; one TF32
// product keeps ~3 decimal digits, which misses the port's f32 limits of
// 1e-4.  (CUTLASS names the scheme OpMultiplyAddFastF32.)
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a b over one 16 x 8 x 8 tile (mma.sync m16n8k8, TF32 in, f32 out).
// Lane l = 4 g + t holds a = A[g][t], A[g + 8][t], A[g][t + 4],
// A[g + 8][t + 4]; b = B[t][g], B[t + 4][g]; c = C[g][2 t], C[g][2 t + 1],
// C[g + 8][2 t], C[g + 8][2 t + 1].
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The warp tiling of a dense pass over Uo outputs and `rows` rows, in
// 16-row x 8-output tiles: a warp owns nt (<= kWarpCols) adjacent output
// tiles and the row tiles wy, wy + wr, wy + 2 wr, ... of its row group wy;
// wc warps span the outputs and wr = warps / wc the rows.  When there are
// fewer row tiles than row groups, nt shrinks so that more warps span the
// outputs.  Uo is a power of two, 8 <= Uo <= 32 * warps.
constexpr int kWarpCols = 4;

struct MmaLayout {
  int nt, wc, wr;
};

__host__ __device__ inline MmaLayout mma_layout(int warps, int Uo, int rows) {
  const int n8 = Uo / 8, tiles = (rows + 15) / 16;
  int nt = n8 < kWarpCols ? n8 : kWarpCols;
  while (nt > 1 && warps * nt > tiles * n8 && 2 * n8 <= warps * nt) nt /= 2;
  return MmaLayout{nt, n8 / nt, warps * nt / n8};
}

// Row tiles per warp that a pass over `rows` rows and Uo outputs needs.
__host__ __device__ inline int warp_row_tiles(int warps, int rows, int Uo) {
  const int wr = mma_layout(warps, Uo, rows).wr;
  return ((rows + 15) / 16 + wr - 1) / wr;
}

// out(r, :Uo) = in(r, :K) @ W for every row r < rows, on the tensor cores
// in 3xTF32, then epi(r, o, (out[r][o], out[r][o + 1])) for even o.  Row r
// of `in` is at row_at(r, n, ld, slot_ld); a warp takes MT row tiles at
// most (`warp_row_tiles`), and the rows past `rows` in its last tile run
// on clamped copies whose results are dropped.  The weights W [K, Uo] are
// staged in shared memory: chunks of KC = min(kStageFloats / Uo, K) rows
// are copied with cp.async kStages - 1 chunks ahead of their use into a
// ring of kStages buffers.  An 8-deep step of the product takes logical
// k = t and t + 4 of lane (g, t) from columns 2 t and 2 t + 1 (the sum
// runs over the same k either way), so a lane reads its A fragment as two
// 8-byte loads and its B fragment from two adjacent weight rows.  Weight
// (k, o) is stored at k Uo + (o ^ 8 ((k / 2) & 3)) (mod Uo) of its chunk,
// and `in` rows lie 8 floats past a multiple of 32 apart (ld = width + 8),
// so both fragments' loads fall in distinct banks.  Every thread of the
// block must call it; it ends with a barrier, so epi may overwrite `in`.
// K and ld are multiples of 8, K a multiple of KC, `in` 8-byte and W
// 16-byte aligned.
template <int NT, int MT, typename Epi>
__device__ __forceinline__ void dense_staged(const float* in, int ld, int n,
                                             int slot_ld, int K,
                                             const float* __restrict__ W, int Uo,
                                             int rows, float* stage, Epi epi) {
  ECNF_PROBE_SCOPE(probe, kProbeDense);
  const MmaLayout m = mma_layout(NT / 32, Uo, rows);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int col0 = (warp % m.wc) * m.nt * 8;
  const int wy = warp / m.wc;
  const int sw = (t << 3) & (Uo - 1);  // the swizzle of weight rows 2 t, 2 t + 1 (mod 8)
  int bcol[kWarpCols];
#pragma unroll
  for (int j = 0; j < kWarpCols; ++j) bcol[j] = (col0 + 8 * j + g) ^ sw;
  int xo[MT][2];
  bool live[MT];
  float acc[MT][kWarpCols][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int r = (wy + i * m.wr) * 16 + g;
    live[i] = r - g < rows;  // the same for the whole warp
    xo[i][0] = row_at(min(r, rows - 1), n, ld, slot_ld) + 2 * t;
    xo[i][1] = row_at(min(r + 8, rows - 1), n, ld, slot_ld) + 2 * t;
#pragma unroll
    for (int j = 0; j < kWarpCols; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
  }
  const int KC = min(kStageFloats / Uo, K);
  const int n_chunks = K / KC;
  const int u4 = Uo / 4;  // 16-byte units per weight row
  // Every call commits one cp.async group, empty past the last chunk, so
  // that waiting for all but the newest kStages - 2 groups always means
  // "chunk ch has landed".
  auto issue = [&](int ch) {
    if (ch < n_chunks) {
      const float4* src = reinterpret_cast<const float4*>(W + ch * KC * Uo);
      float* dst = stage + (ch % kStages) * kStageFloats;
      // A thread copies one 16-byte unit o of rows k, k + NT / u4, ...
      // (u4 divides NT).
      const int o = 4 * (threadIdx.x % u4);
      for (int k = threadIdx.x / u4; k < KC; k += NT / u4) {
        cp_async16(dst + k * Uo + (o ^ ((((k >> 1) & 3) << 3) & (Uo - 1))), src + k * u4 + o / 4);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int ch = 0; ch < kStages - 1; ++ch) issue(ch);
  for (int ch = 0; ch < n_chunks; ++ch) {
    {
      ECNF_PROBE_SCOPE(probe_wait, kProbeDenseWait);
      cp_async_wait<kStages - 2>();
      __syncthreads();  // chunk ch has landed; chunk ch - 1's buffer is free
    }
    issue(ch + kStages - 1);
    const float* Ws = stage + (ch % kStages) * kStageFloats + 2 * t * Uo;
    const float* x = in + ch * KC;
    for (int c = 0; c < KC; c += 8) {
      unsigned bh[kWarpCols][2], bl[kWarpCols][2];
#pragma unroll
      for (int j = 0; j < kWarpCols; ++j)
        if (j < m.nt) {
          split_tf32(Ws[c * Uo + bcol[j]], bh[j][0], bl[j][0]);
          split_tf32(Ws[(c + 1) * Uo + bcol[j]], bh[j][1], bl[j][1]);
        }
      unsigned ah[MT][4], al[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        if (live[i]) {
          const float2 a0 = *reinterpret_cast<const float2*>(x + xo[i][0] + c);
          const float2 a1 = *reinterpret_cast<const float2*>(x + xo[i][1] + c);
          split_tf32(a0.x, ah[i][0], al[i][0]);
          split_tf32(a1.x, ah[i][1], al[i][1]);
          split_tf32(a0.y, ah[i][2], al[i][2]);
          split_tf32(a1.y, ah[i][3], al[i][3]);
        }
      // The three products in turn, so that back-to-back mma's write
      // different accumulators.
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < kWarpCols; ++j)
          if (live[i] && j < m.nt) mma_tf32(acc[i][j], al[i], bh[j]);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < kWarpCols; ++j)
          if (live[i] && j < m.nt) mma_tf32(acc[i][j], ah[i], bl[j]);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < kWarpCols; ++j)
          if (live[i] && j < m.nt) mma_tf32(acc[i][j], ah[i], bh[j]);
    }
  }
  {
    ECNF_PROBE_SCOPE(probe_wait, kProbeDenseWait);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int r = (wy + i * m.wr) * 16 + g;
#pragma unroll
    for (int j = 0; j < kWarpCols; ++j)
      if (j < m.nt) {
        const int o = col0 + 8 * j + 2 * t;
        if (r < rows) epi(r, o, make_float2(acc[i][j][0], acc[i][j][1]));
        if (r + 8 < rows) epi(r + 8, o, make_float2(acc[i][j][2], acc[i][j][3]));
      }
  }
}

// dot(r) = act[r * ld : r * ld + U] . v for r < rows, one warp per row;
// lane 0 calls emit(r, dot).
template <int NT, typename Emit>
__device__ __forceinline__ void row_dots(const float* act, int ld,
                                         const float* __restrict__ v, int rows,
                                         int U, Emit emit) {
  ECNF_PROBE_SCOPE(probe, kProbeRowDots);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += NT / 32) {
    float s = 0.f;
    for (int c = lane; c < U; c += 32) s = fmaf(act[r * ld + c], __ldg(v + c), s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) emit(r, s);
  }
}

__device__ __forceinline__ void store4(float* dst, const float4& a) {
  *reinterpret_cast<float4*>(dst) = a;
}

__device__ __forceinline__ void store2(float* dst, const float2& a) {
  *reinterpret_cast<float2*>(dst) = a;
}

// tile rows = raw pre-activations of S slots x n rows (row s * n + j at
// s * slot_ld + j * ld) -> primal rows silu(z + bias), tangent rows
// silu'(z + bias) * raw.  A thread keeps one unit o (U divides NT).
template <int NT>
__device__ __forceinline__ void silu_lockstep(float* tile, int S, int n, int U,
                                              int ld, int slot_ld,
                                              const float* __restrict__ bias) {
  ECNF_PROBE_SCOPE(probe, kProbeSilu);
  const int o = threadIdx.x % U;
  for (int j = threadIdx.x / U; j < n; j += NT / U) {
    float* t = tile + j * ld + o;
    const float z = *t + __ldg(bias + o);
    const float sg = sigmoid(z);
    const float ds = sg * (1.f + z * (1.f - sg));
    // Four slots at a time, so that their loads are in flight together.
    int s = 1;
    for (; s + 4 <= S; s += 4) {
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = t[(s + q) * slot_ld];
#pragma unroll
      for (int q = 0; q < 4; ++q) t[(s + q) * slot_ld] = v[q] * ds;
    }
    for (; s < S; ++s) t[s * slot_ld] *= ds;
    *t = z * sg;
  }
}

// The time ConcatDense of every node and slot: hc = hb @ cd_h, plus
// temb @ cd_t + cd_b on the primal.  Ends with a barrier.
template <int NT, int MT>
__device__ __forceinline__ void block_prologue(const Dims& d, const Layout& y,
                               const float* __restrict__ W, float* sm,
                               const Plan& p, int S) {
  const int H = d.H;
  float* tb = sm + p.tb;
  const float* temb = sm + p.temb;
  for (int o = threadIdx.x; o < H; o += NT) {
    float s = 0.f;
    for (int t = 0; t < d.T; ++t) s = fmaf(temb[t], __ldg(W + y.cd_t + t * H + o), s);
    tb[o] = s;
  }
  __syncthreads();
  float* hc = sm + p.hc;
  const float* cd_b = W + y.cd_b;
  dense_staged<NT, MT>(sm + p.hb, p.lh, S * d.N, 0, H, W + y.cd_h, H, S * d.N, sm + p.stage, [&](int r, int o, float2 a) {
    if (r < d.N) {
      a.x = (a.x + tb[o + 0]) + __ldg(cd_b + o + 0);
      a.y = (a.y + tb[o + 1]) + __ldg(cd_b + o + 1);
    }
    store2(hc + r * p.lh + o, a);
  });
  __syncthreads();
}

// The edges of one receiver i of one EGNN block, for S slots.  `vec` is
// the block's input coordinates [S][N][D]; hc must hold the block's
// ConcatDense output (block_prologue).  Writes slot s's new coordinates of
// node i to vec_dst[s * vec_stride + :D] and its gated message sum m_i to
// mi_dst[s * mi_stride + :U]; `node_update` then runs phi_h.  The edge
// passes take MT row tiles per warp (S * N rows, see `warp_row_tiles`);
// the receiver's first-layer term, S rows on the CUDA cores, takes one row
// per thread (S <= row_groups(NT, U)).  Ends with a barrier.
template <int NT, int MT>
__device__ __forceinline__ void receiver_pass(const Dims& d, const Layout& y,
                              const float* __restrict__ W, float* sm,
                              const Plan& p, int S, int i, const float* vec,
                              float* vec_dst, int vec_stride, float* mi_dst,
                              int mi_stride) {
  const int N = d.N, D = d.D, H = d.H, U = d.U, L = d.L;
  const int lh = p.lh, lu = p.lu;
  const int SN = S * N;
  const int tid = threadIdx.x;
  const float* hc = sm + p.hc;
  float* tile = sm + p.tile;
  float* stage = sm + p.stage;
  float* bi = sm + p.bi;
  float* l2 = sm + p.l2;
  float* len = sm + p.len;
  float* g = sm + p.g;
  float* phi = sm + p.phi;
  float* w = sm + p.w;
  float* l2t = sm + p.l2t;
  float* lent = sm + p.lent;
  float* gt = sm + p.gt;
  float* phit = sm + p.phit;
  float* wt = sm + p.wt;
  float* dot = sm + p.dot;
  const float* vi = vec + i * D;

  // Geometry of the edges (i, j): l2 = max(r2_i + r2_j - 2 gram, 0), and
  // its tangent, taken as 0 where the clamp is not active (raw <= 0).
  for (int idx = tid; idx < SN; idx += NT) {
    const int s = idx / N;
    const int j = idx - s * N;
    const float* vj = vec + j * D;
    float r2i = 0.f, r2j = 0.f, gram = 0.f;
    for (int c = 0; c < D; ++c) {
      r2i = fmaf(vi[c], vi[c], r2i);
      r2j = fmaf(vj[c], vj[c], r2j);
      gram = fmaf(vi[c], vj[c], gram);
    }
    const float raw = (r2i + r2j) - 2.f * gram;
    const float l2v = fmaxf(raw, 0.f);
    const float lenv = l2v == 0.f ? 1.f : sqrtf(l2v);
    if (s == 0) {
      l2[j] = l2v;
      len[j] = lenv;
    } else {
      const float* ti = vec + s * N * D + i * D;
      const float* tj = vec + s * N * D + j * D;
      float gij = 0.f, gji = 0.f, ri = 0.f, rj = 0.f;
      for (int c = 0; c < D; ++c) {
        gij = fmaf(ti[c], vj[c], gij);
        gji = fmaf(tj[c], vi[c], gji);
        ri = fmaf(vi[c], ti[c], ri);
        rj = fmaf(vj[c], tj[c], rj);
      }
      const float raw_t = (2.f * ri + 2.f * rj) - 2.f * (gij + gji);
      const float l2tv = raw > 0.f ? raw_t : 0.f;
      l2t[idx] = l2tv;
      lent[idx] = l2v == 0.f ? 0.f : 0.5f * l2tv / lenv;
    }
  }

  // phi_e first layer over [h_j, h_i, l2]: the receiver's row hc_i @ e_r,
  // then every sender row hc_j @ e_s.
  dense<NT, 1>(hc + i * lh, N * lh, H, W + y.e_r, U, S, [&](int r, int o, float4 a) {
    store4(bi + r * lu + o, a);
  });
  dense_staged<NT, MT>(hc, lh, SN, 0, H, W + y.e_s, U, SN, stage, [&](int r, int o, float2 a) {
    store2(tile + r * lu + o, a);
  });
  __syncthreads();
  {
    const float* e_l = W + y.e_l;
    const float* e_b = W + y.e_b[0];
    const int o = tid % U;
    const float el = __ldg(e_l + o);
    for (int j = tid / U; j < N; j += NT / U) {
      const float z = ((tile[j * lu + o] + bi[o]) + l2[j] * el) + __ldg(e_b + o);
      const float sg = sigmoid(z);
      const float ds = sg * (1.f + z * (1.f - sg));
      // Four slots at a time, as in silu_lockstep.
      int s = 1;
      for (; s + 4 <= S; s += 4) {
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = (s + q) * N + j;
          v[q] = (tile[r * lu + o] + bi[(s + q) * lu + o]) + l2t[r] * el;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) tile[((s + q) * N + j) * lu + o] = ds * v[q];
      }
      for (; s < S; ++s) {
        const int r = s * N + j;
        tile[r * lu + o] = ds * ((tile[r * lu + o] + bi[s * lu + o]) + l2t[r] * el);
      }
      tile[j * lu + o] = z * sg;
    }
  }
  __syncthreads();

  // phi_e tail: m and its tangents.
  for (int l = 1; l < L; ++l) {
    dense_staged<NT, MT>(tile, lu, SN, 0, U, W + y.e_tail[l - 1], U, SN, stage, [&](int r, int o, float2 a) {
      store2(tile + r * lu + o, a);
    });
    __syncthreads();
    silu_lockstep<NT>(tile, S, N, U, lu, N * lu, W + y.e_b[l]);
    __syncthreads();
  }

  // Gate g = sigmoid(m . g_out + b), its tangent g' * (m_t . g_out), and
  // the gated sums m_i = sum_{j != i} m_j g_j / sqrt(N - 1).
  row_dots<NT>(tile, lu, W + y.g_out, SN, U, [&](int r, float s) { dot[r] = s; });
  __syncthreads();
  {
    const float gb = __ldg(W + y.g_out_b);
    for (int r = tid; r < SN; r += NT) {
      const int j = r % N;
      const float gg = sigmoid(dot[j] + gb);
      if (r < N)
        g[j] = gg;
      else
        gt[r] = (gg * (1.f - gg)) * dot[r];
    }
  }
  __syncthreads();
  {
    const float sqrt_deg = sqrtf(static_cast<float>(N - 1));
    const int u = tid % U;
    for (int s = tid / U; s < S; s += NT / U) {
      float acc = 0.f;
      for (int j = 0; j < N; ++j) {
        if (j == i) continue;
        const float m = tile[j * lu + u];
        if (s == 0)
          acc += m * g[j];
        else
          acc += tile[(s * N + j) * lu + u] * g[j] + m * gt[s * N + j];
      }
      mi_dst[s * mi_stride + u] = acc / sqrt_deg;
    }
  }

  // phi_x chain and its Dense(1) output phi.
  for (int l = 0; l < L; ++l) {
    dense_staged<NT, MT>(tile, lu, SN, 0, U, W + y.x_tail[l], U, SN, stage, [&](int r, int o, float2 a) {
      store2(tile + r * lu + o, a);
    });
    __syncthreads();
    silu_lockstep<NT>(tile, S, N, U, lu, N * lu, W + y.x_b[l]);
    __syncthreads();
  }
  row_dots<NT>(tile, lu, W + y.x_out, SN, U, [&](int r, float s) { dot[r] = s; });
  __syncthreads();
  {
    const float xb = __ldg(W + y.x_out_b);
    for (int r = tid; r < SN; r += NT) {
      if (r < N)
        phi[r] = dot[r] + xb;
      else
        phit[r] = dot[r];
    }
  }
  __syncthreads();

  // Coordinate weights w = phi * mask / (C + len) and their tangents.
  for (int r = tid; r < SN; r += NT) {
    const int j = r % N;
    const float mask = j == i ? 0.f : 1.f;
    const float den = d.C + len[j];
    if (r < N)
      w[j] = phi[j] * mask / den;
    else
      wt[r] = mask * (phit[r] * den - phi[j] * lent[r]) / (den * den);
  }
  __syncthreads();
  // vec_out_i = vec_i + (sum_j w_j vec_i - sum_j w_j vec_j) / (N - 1).
  for (int idx = tid; idx < S * D; idx += NT) {
    const int s = idx / D;
    const int c = idx - s * D;
    float out;
    if (s == 0) {
      float sw = 0.f, swv = 0.f;
      for (int j = 0; j < N; ++j) {
        sw += w[j];
        swv += w[j] * vec[j * D + c];
      }
      out = vi[c] + (sw * vi[c] - swv) / static_cast<float>(N - 1);
    } else {
      const float* ts = vec + s * N * D;
      float sw = 0.f, swt = 0.f, a = 0.f, bb = 0.f;
      for (int j = 0; j < N; ++j) {
        const float wtj = wt[s * N + j];
        swt += wtj;
        sw += w[j];
        a += wtj * vec[j * D + c];
        bb += w[j] * ts[j * D + c];
      }
      const float shift = ((swt * vi[c] + sw * ts[i * D + c]) - a) - bb;
      out = ts[i * D + c] + shift / static_cast<float>(N - 1);
    }
    vec_dst[s * vec_stride + c] = out;
  }

  __syncthreads();
}

// phi_h over [m_i, hc_i] and the h residual for n nodes of S slots (row
// r = s * n + j; slot 0 is the primal): the m_i of node j of slot s at
// mi + (s * mi_slot + j) * lu (overwritten), its hc row at
// hc + s * hc_slot + j * lh, and its new h written to
// h_dst + s * h_slot + j * h_ld.  Ends with a barrier.
template <int NT, int MT>
__device__ __forceinline__ void node_update(const Dims& d, const Layout& y,
                                            const float* __restrict__ W,
                                            float* sm, const Plan& p, int S,
                                            int n, float* mi, int mi_slot,
                                            const float* hc, int hc_slot,
                                            float* h_dst, int h_ld, int h_slot) {
  const int H = d.H, U = d.U, L = d.L, lu = p.lu, lh = p.lh;
  const int rows = S * n;
  const int mi_ld = mi_slot * lu;
  float* stage = sm + p.stage;
  auto mi_row = [&](int r) { return mi + row_at(r, n, lu, mi_ld); };
  dense_staged<NT, MT>(mi, lu, n, mi_ld, U, W + y.h_m, U, rows, stage, [&](int r, int o, float2 a) {
    store2(mi_row(r) + o, a);
  });
  // The same thread owns the same (row, outputs) in both passes.
  dense_staged<NT, MT>(hc, lh, n, hc_slot, H, W + y.h_h, U, rows, stage, [&](int r, int o, float2 a) {
    float2* dst = reinterpret_cast<float2*>(mi_row(r) + o);
    float2 v = *dst;
    v.x += a.x;
    v.y += a.y;
    *dst = v;
  });
  __syncthreads();
  silu_lockstep<NT>(mi, S, n, U, lu, mi_ld, W + y.h_b[0]);
  __syncthreads();
  for (int l = 1; l < L; ++l) {
    dense_staged<NT, MT>(mi, lu, n, mi_ld, U, W + y.h_tail[l - 1], U, rows, stage,
                         [&](int r, int o, float2 a) { store2(mi_row(r) + o, a); });
    __syncthreads();
    silu_lockstep<NT>(mi, S, n, U, lu, mi_ld, W + y.h_b[l]);
    __syncthreads();
  }
  const float* h_b = W + y.h_b[L];
  dense_staged<NT, MT>(mi, lu, n, mi_ld, U, W + y.h_out, H, rows, stage, [&](int r, int o, float2 a) {
    const float* hcr = hc + row_at(r, n, lh, hc_slot) + o;
    float* dst = h_dst + row_at(r, n, h_ld, h_slot) + o;
    const float v[2] = {a.x, a.y};
#pragma unroll
    for (int q = 0; q < 2; ++q)
      dst[q] = r < n ? (v[q] + __ldg(h_b + o + q)) + hcr[q] : v[q] + hcr[q];
  });
  __syncthreads();
}

}  // namespace ecnf
