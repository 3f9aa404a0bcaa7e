// The card's rate for the warp-level tensor-core instruction that the f32
// kernels' dense passes use (mma.sync m16n8k8, TF32 in, f32 out), with no
// memory traffic: every warp of one 512-thread block per SM runs `chains`
// independent accumulators through `iters` mma's each.  It is the ceiling
// of the 3xTF32 route (three of these per product), which `kernel_probe.py`
// prints beside the published 495 TFLOP/s TF32 peak that only the
// asynchronous warpgroup instruction (wgmma) reaches.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;

template <int CHAINS>
__global__ void __launch_bounds__(kThreads, 1) mma_loop(float* out, int iters) {
  unsigned a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1e-3f * (threadIdx.x + i)) & 0xffffe000u;
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(1e-3f * (threadIdx.x - i)) & 0xffffe000u;
  float acc[CHAINS][4] = {};
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int c = 0; c < CHAINS; ++c)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(acc[c][0]), "+f"(acc[c][1]), "+f"(acc[c][2]), "+f"(acc[c][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  float s = 0.f;
  for (int c = 0; c < CHAINS; ++c) s += (acc[c][0] + acc[c][1]) + (acc[c][2] + acc[c][3]);
  out[blockIdx.x * kThreads + threadIdx.x] = s;
}

}  // namespace

// TF32 TFLOP/s of mma.sync m16n8k8 with 8 accumulators a warp, one
// 512-thread block per SM, timed with CUDA events on the default stream;
// out is scratch of [SMs * 512] floats.  Returns a cudaError_t (0 on
// success); the rate goes to *tflops.
extern "C" int ecnf_mma_tf32_tflops(float* out, int iters, double* tflops) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kChains = 8;
  mma_loop<kChains><<<sms, kThreads>>>(out, 16);  // warm-up
  cudaEvent_t start, stop;
  cudaEventCreate(&start);
  cudaEventCreate(&stop);
  cudaEventRecord(start);
  mma_loop<kChains><<<sms, kThreads>>>(out, iters);
  cudaEventRecord(stop);
  err = cudaEventSynchronize(stop);
  float ms = 0.f;
  if (err == cudaSuccess) err = cudaEventElapsedTime(&ms, start, stop);
  cudaEventDestroy(start);
  cudaEventDestroy(stop);
  if (err != cudaSuccess) return static_cast<int>(err);
  const double flop = 2.0 * 16 * 8 * 8 * kChains * static_cast<double>(iters) * sms * (kThreads / 32);
  *tflops = flop / (ms * 1e-3) / 1e12;
  return static_cast<int>(cudaGetLastError());
}
