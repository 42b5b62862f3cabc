// Calibrated-retraining accumulate (paper eq. 3) for Hopper:
//   out[p] = w[p] + sum_m coeffs[m] * deltas[m, p]
//
// Replaces the Pallas TPU kernel calibrate_kernel in
// src/repro/kernels/calibrate/kernel.py.
//
// What bounds it on an H100: memory.  Each output element reads M + 1 floats
// and writes one for 2*M FLOPs, about 0.4 FLOP per byte.  So the design is
// one pass over P:
//   * the M coefficients sit in shared memory, in chunks of kChunkM = 1024
//     taken in ascending m (one chunk for M <= 1024), so any M is served;
//   * 256 threads, 4 columns each: 16-byte float4 loads of w and of every
//     delta row when P % 4 == 0 and the buffers are 16-byte aligned, else
//     coalesced scalar loads strided by the block;
//   * the sum over m runs in a fixed order (m = 0 .. M-1, fmaf into an fp32
//     accumulator that starts at 0), then w is added, as in w + coeffs @ d;
//   * 64-bit element offsets; ragged P is masked in the kernel.
// At the paper's shapes (M = 4 retained clients, P = 206,922) the whole call
// moves ~5 MB, about 1.5 us at 3.35 TB/s: launch overhead dominates, which
// is why the launch count per request is recorded beside its time.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 4;
constexpr int kTileP = kThreads * kCols;
constexpr int kChunkM = 1024;

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
calibrate_kernel(const float* __restrict__ w, const float* __restrict__ d,
                 const float* __restrict__ coeffs, float* __restrict__ out,
                 int M, int64_t P) {
  __shared__ float sc[kChunkM];
  const int64_t tile = static_cast<int64_t>(blockIdx.x) * kTileP;
  if (kVec) {
    const int64_t p = tile + static_cast<int64_t>(threadIdx.x) * kCols;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int m0 = 0; m0 < M; m0 += kChunkM) {
      const int nm = M - m0 < kChunkM ? M - m0 : kChunkM;
      __syncthreads();                 // the last chunk is read
      for (int i = threadIdx.x; i < nm; i += kThreads) sc[i] = coeffs[m0 + i];
      __syncthreads();
      if (p >= P) continue;
#pragma unroll 4
      for (int m = 0; m < nm; ++m) {
        const float k = sc[m];
        const float4 v =
            *reinterpret_cast<const float4*>(d + (m0 + m) * P + p);
        acc.x = fmaf(k, v.x, acc.x);
        acc.y = fmaf(k, v.y, acc.y);
        acc.z = fmaf(k, v.z, acc.z);
        acc.w = fmaf(k, v.w, acc.w);
      }
    }
    if (p >= P) return;
    const float4 b = *reinterpret_cast<const float4*>(w + p);
    *reinterpret_cast<float4*>(out + p) =
        make_float4(b.x + acc.x, b.y + acc.y, b.z + acc.z, b.w + acc.w);
  } else {
    float acc[kCols] = {0.f, 0.f, 0.f, 0.f};
    for (int m0 = 0; m0 < M; m0 += kChunkM) {
      const int nm = M - m0 < kChunkM ? M - m0 : kChunkM;
      __syncthreads();                 // the last chunk is read
      for (int i = threadIdx.x; i < nm; i += kThreads) sc[i] = coeffs[m0 + i];
      __syncthreads();
#pragma unroll 4
      for (int m = 0; m < nm; ++m) {
        const float k = sc[m];
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int64_t p = tile + threadIdx.x + j * kThreads;
          if (p < P) acc[j] = fmaf(k, d[(m0 + m) * P + p], acc[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int64_t p = tile + threadIdx.x + j * kThreads;
      if (p < P) out[p] = w[p] + acc[j];
    }
  }
}

}  // namespace

// w (P,), deltas (M,P), coeffs (M,), out (P,): f32, contiguous, on the
// device.  vec = 1 only when P % 4 == 0 and w, deltas and out are 16-byte
// aligned.  Returns cudaGetLastError() after the launch.
extern "C" int repro_calibrate(const float* w, const float* deltas,
                               const float* coeffs, float* out, int64_t M,
                               int64_t P, int vec, void* stream) {
  if (M < 1 || M > 0x7fffffffLL || P < 1 ||
      (P + kTileP - 1) / kTileP > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((P + kTileP - 1) / kTileP));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec)
    calibrate_kernel<true><<<grid, kThreads, 0, st>>>(w, deltas, coeffs, out,
                                                      static_cast<int>(M), P);
  else
    calibrate_kernel<false><<<grid, kThreads, 0, st>>>(w, deltas, coeffs, out,
                                                       static_cast<int>(M), P);
  return static_cast<int>(cudaGetLastError());
}
