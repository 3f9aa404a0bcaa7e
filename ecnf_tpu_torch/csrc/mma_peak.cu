// The card's rate for the warp-level tensor-core instructions that the
// kernels' dense passes use, with no memory traffic: mma.sync m16n8k8
// (TF32 in, f32 out; the f32 kernels, three per product in 3xTF32) and
// mma.sync m16n8k16 (bf16 in, f32 out; the edge-tangent kernel in bf16).
// Every warp of one 512-thread block per SM runs `chains` independent
// accumulators through `iters` mma's each.  These are the ceilings of the
// mma.sync routes, which `kernel_probe.py` prints beside the published
// 495 (TF32) and 989 (bf16) TFLOP/s peaks that only the asynchronous
// warpgroup instruction (wgmma) reaches.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kChains = 8;

template <bool BF16>
__global__ void __launch_bounds__(kThreads, 1) mma_loop(float* out, int iters) {
  unsigned a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1e-3f * (threadIdx.x + i)) & 0xffffe000u;
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(1e-3f * (threadIdx.x - i)) & 0xffffe000u;
  float acc[kChains][4] = {};
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      if (BF16)
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+f"(acc[c][0]), "+f"(acc[c][1]), "+f"(acc[c][2]), "+f"(acc[c][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      else
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+f"(acc[c][0]), "+f"(acc[c][1]), "+f"(acc[c][2]), "+f"(acc[c][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    }
  float s = 0.f;
  for (int c = 0; c < kChains; ++c) s += (acc[c][0] + acc[c][1]) + (acc[c][2] + acc[c][3]);
  out[blockIdx.x * kThreads + threadIdx.x] = s;
}

// TFLOP/s of mma_loop<BF16>, timed with CUDA events on the default stream.
template <bool BF16>
int rate(float* out, int iters, double* tflops) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  mma_loop<BF16><<<sms, kThreads>>>(out, 16);  // warm-up
  cudaEvent_t start, stop;
  cudaEventCreate(&start);
  cudaEventCreate(&stop);
  cudaEventRecord(start);
  mma_loop<BF16><<<sms, kThreads>>>(out, iters);
  cudaEventRecord(stop);
  err = cudaEventSynchronize(stop);
  float ms = 0.f;
  if (err == cudaSuccess) err = cudaEventElapsedTime(&ms, start, stop);
  cudaEventDestroy(start);
  cudaEventDestroy(stop);
  if (err != cudaSuccess) return static_cast<int>(err);
  const double depth = BF16 ? 16 : 8;
  const double flop = 2.0 * 16 * 8 * depth * kChains * static_cast<double>(iters) * sms * (kThreads / 32);
  *tflops = flop / (ms * 1e-3) / 1e12;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// TF32 TFLOP/s of mma.sync m16n8k8 with 8 accumulators a warp, one
// 512-thread block per SM; out is scratch of [SMs * 512] floats.  Returns
// a cudaError_t (0 on success); the rate goes to *tflops.
extern "C" int ecnf_mma_tf32_tflops(float* out, int iters, double* tflops) {
  return rate<false>(out, iters, tflops);
}

// The same for bf16: mma.sync m16n8k16, f32 accumulation.
extern "C" int ecnf_mma_bf16_tflops(float* out, int iters, double* tflops) {
  return rate<true>(out, iters, tflops);
}
