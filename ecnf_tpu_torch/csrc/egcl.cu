// One whole EGCL block of the EGNN, forward only, f32.
//
// Replaces the Pallas kernel `_egcl_kernel` dispatched by `egcl_fused` in
// ecnf_tpu/ops/pallas/attic/egcl_kernel.py: the time ConcatDense, the Gram
// squared distances, phi_e (fused first layer and tail), phi_x and its
// Dense(1), w = phi * mask / (C + len), the coordinate shifts, the sigmoid
// gate and the gated m_i / sqrt(N - 1), phi_h over [m_i, h], and both
// residuals (the h residual adds the post-ConcatDense h).
//
// Design: one thread block per (receiver i, sample b).  It computes the
// ConcatDense of all N nodes of its sample (it needs every sender's h; a
// [N, H] @ [H, H] product is cheap to recompute), runs its N sender rows
// through the edge MLPs as one [N, U] tile in shared memory, forms the
// shift and m_i as sums over its own rows (no atomics), runs phi_h for
// node i and writes vec_out[b, i] and h_out[b, i].  The edge rows never
// leave shared memory; the weights are staged through it in chunks.  The
// device code is `receiver_pass` and `node_update` of egnn_device.cuh with
// one slot.
//
// At LJ13 width (N=13, U=128, L=3) a block does ~1.2 M FMAs over its 13
// edge rows, which fill 13 of the 16 rows of one tensor-core row tile; the
// dense passes run in 3xTF32 (`dense_staged`), with the 8 warps spread
// over the outputs.  Each thread block streams every weight through
// shared memory for its 13 rows, so that stream and the per-pass
// barriers, not the tensor cores, set its pace.  Stacking several
// receivers' rows in one tile is the next step.

#include <cuda_runtime.h>

#include "egnn_device.cuh"

namespace {

using namespace ecnf;

constexpr int kThreads = 256;

// Thread blocks per SM that the register budget must allow: three with
// one row tile per warp (80 registers a thread, some spilled: faster at
// LJ13 width than two blocks of 128), two with two (at QM9 width the
// spills of 80 registers cost more than a third block gains).
template <int MT>
__global__ void __launch_bounds__(kThreads, MT == 1 ? 3 : 2)
    egcl_kernel(const Dims d, const Layout y, const Plan p, const float* vec,
                const float* h, const float* temb, const float* W,
                float* vec_out, float* h_out) {
  ECNF_PROBE_SCOPE(probe, kProbeTotal);
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int i = blockIdx.x;
  const int b = blockIdx.y;
  const int N = d.N, D = d.D, H = d.H;
  for (int idx = threadIdx.x; idx < N * D; idx += kThreads)
    sm[p.vec + idx] = vec[static_cast<size_t>(b) * N * D + idx];
  for (int idx = threadIdx.x; idx < N * H; idx += kThreads)
    sm[p.hb + idx / H * p.lh + idx % H] = h[static_cast<size_t>(b) * N * H + idx];
  for (int idx = threadIdx.x; idx < d.T; idx += kThreads)
    sm[p.temb + idx] = temb[static_cast<size_t>(b) * d.T + idx];
  __syncthreads();
  block_prologue<kThreads, MT>(d, y, W, sm, p, 1);
  const size_t node = static_cast<size_t>(b) * N + i;
  receiver_pass<kThreads, MT>(d, y, W, sm, p, 1, i, sm + p.vec, vec_out + node * D, 0,
                             sm + p.mi, 0);
  node_update<kThreads, MT>(d, y, W, sm, p, 1, 1, sm + p.mi, 1, sm + p.hc + i * p.lh, 0,
                           h_out + node * H, H, 0);
}

template <int MT>
cudaError_t launch(const Dims& d, int B, const float* vec, const float* h,
                   const float* temb, const float* w, float* vec_out,
                   float* h_out, cudaStream_t stream) {
  const Plan p = make_plan(d, 1, 1);
  const size_t smem = static_cast<size_t>(p.total) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      egcl_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  egcl_kernel<MT><<<dim3(d.N, B), kThreads, smem, stream>>>(
      d, make_layout(d.H, d.T, d.U, d.L), p, vec, h, temb, w, vec_out, h_out);
  return cudaGetLastError();
}

}  // namespace

// Floats per block in the packed weight buffer (see egnn_device.cuh).
extern "C" int ecnf_weight_floats(int H, int T, int U, int L) {
  return make_layout(H, T, U, L).size;
}

// vec [B, N, D], h [B, N, H], temb [B, T], w: one block's packed weights,
// outputs vec_out [B, N, D], h_out [B, N, H]; all f32, contiguous, 16-byte
// aligned.  Returns a cudaError_t (0 on success) from the launch.
extern "C" int ecnf_egcl_forward(int B, int N, int D, int H, int T, int U,
                                 int L, float C, const float* vec,
                                 const float* h, const float* temb,
                                 const float* w, float* vec_out, float* h_out,
                                 void* stream) {
  if (B < 1 || !supported(N, D, H, T, U, L))
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims d{N, D, H, T, U, L, C};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // N <= 32 rows: two row tiles at most, over at least one row group.
  if (warp_row_tiles(kThreads / 32, N, U) == 1)
    return static_cast<int>(launch<1>(d, B, vec, h, temb, w, vec_out, h_out, s));
  return static_cast<int>(launch<2>(d, B, vec, h, temb, w, vec_out, h_out, s));
}
