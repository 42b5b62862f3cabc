// Coded matmul for Hopper: out[g] = coeff (C,S) @ w[g] (S,P), fp32 accumulate.
//
// Replaces the Pallas TPU kernels coded_matmul_kernel and
// coded_matmul_rounds_kernel in src/repro/kernels/coded_matmul/kernel.py
// (the Lagrange encode of eq. 6 and the erasure decode of eq. 7).  One CUDA
// kernel serves both: the 2-D call is the G = 1 case of the round grid.
//
// What bounds it on an H100: memory.  S is the code dimension (4 in the
// paper's setting, S << C by eq. 11), so each output element costs S fused
// multiply-adds against 4 or 2 bytes written and 4*S/C bytes read: about
// 1 FLOP per byte, far below the card's ~20 FLOP/byte fp32 ridge.  The
// reduction depth S is too shallow for tensor cores, and TF32 would break
// fp32 parity, so the product runs on the CUDA cores and the design is a
// streaming one:
//   * grid (P tiles, C tiles, G rounds); 256 threads, 4 columns each, so a
//     block covers 1024 columns of P;
//   * the (block_c x S) coefficient tile sits in shared memory;
//   * each thread reads its 4-column strip of all S rows of w once into
//     registers (16-byte float4 loads when P % 4 == 0 and the buffers are
//     16-byte aligned, else coalesced scalar loads strided by the block),
//     then writes block_c = 32 output rows, each a coalesced store, so w is
//     read from device memory once for C <= 32;
//   * bf16 output rounds with __float2bfloat16_rn / __floats2bfloat162_rn,
//     round-to-nearest-even like torch's and XLA's casts;
//   * 64-bit element offsets throughout (G*C*P passes 2^31 at real sizes);
//   * ragged P is masked in the kernel: no padding copies.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 4;                    // columns of P per thread
constexpr int kTileP = kThreads * kCols;    // columns of P per block
constexpr int kBlockC = 32;                 // output rows per block
constexpr int kMaxS = 16;                   // largest code dimension

__device__ __forceinline__ void store1(float* o, float v) { *o = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* o, float v) {
  *o = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store4(float* o, const float* a) {
  *reinterpret_cast<float4*>(o) = make_float4(a[0], a[1], a[2], a[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* o, const float* a) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a[0], a[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(a[2], a[3]);
  uint2 u;
  u.x = *reinterpret_cast<unsigned int*>(&lo);
  u.y = *reinterpret_cast<unsigned int*>(&hi);
  *reinterpret_cast<uint2*>(o) = u;
}

template <typename OutT, bool kVec>
__global__ void __launch_bounds__(kThreads)
coded_matmul_kernel(const float* __restrict__ coeff,
                    const float* __restrict__ w, OutT* __restrict__ out,
                    int64_t C, int S, int64_t P) {
  __shared__ float sc[kBlockC * kMaxS];
  const int64_t g = blockIdx.z;
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * kBlockC;
  const int nc = static_cast<int>(C - c0 < kBlockC ? C - c0 : kBlockC);
  // rows c0 .. c0+nc of the row-major (C, S) matrix are contiguous
  for (int i = threadIdx.x; i < nc * S; i += kThreads) sc[i] = coeff[c0 * S + i];
  __syncthreads();

  const float* wg = w + g * S * P;
  OutT* og = out + g * C * P;
  const int64_t tile = static_cast<int64_t>(blockIdx.x) * kTileP;
  float x[kMaxS][kCols];

  if (kVec) {
    // P % 4 == 0: a thread's 4 columns are all in range or all out
    const int64_t p = tile + static_cast<int64_t>(threadIdx.x) * kCols;
    if (p >= P) return;
#pragma unroll
    for (int s = 0; s < kMaxS; ++s) {
      if (s < S) {
        const float4 v = *reinterpret_cast<const float4*>(wg + s * P + p);
        x[s][0] = v.x; x[s][1] = v.y; x[s][2] = v.z; x[s][3] = v.w;
      }
    }
    for (int c = 0; c < nc; ++c) {
      float acc[kCols] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int s = 0; s < kMaxS; ++s) {
        if (s < S) {
          const float k = sc[c * S + s];
#pragma unroll
          for (int j = 0; j < kCols; ++j) acc[j] = fmaf(k, x[s][j], acc[j]);
        }
      }
      store4(og + (c0 + c) * P + p, acc);
    }
  } else {
    // columns tile + threadIdx.x + j*kThreads: each warp access is contiguous
#pragma unroll
    for (int s = 0; s < kMaxS; ++s) {
      if (s < S) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int64_t p = tile + threadIdx.x + j * kThreads;
          x[s][j] = p < P ? wg[s * P + p] : 0.f;
        }
      }
    }
    for (int c = 0; c < nc; ++c) {
      float acc[kCols] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int s = 0; s < kMaxS; ++s) {
        if (s < S) {
          const float k = sc[c * S + s];
#pragma unroll
          for (int j = 0; j < kCols; ++j) acc[j] = fmaf(k, x[s][j], acc[j]);
        }
      }
      OutT* orow = og + (c0 + c) * P;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int64_t p = tile + threadIdx.x + j * kThreads;
        if (p < P) store1(orow + p, acc[j]);
      }
    }
  }
}

template <typename OutT>
void launch(const float* coeff, const float* w, void* out, int64_t G,
            int64_t C, int S, int64_t P, bool vec, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>((P + kTileP - 1) / kTileP),
                  static_cast<unsigned>((C + kBlockC - 1) / kBlockC),
                  static_cast<unsigned>(G));
  OutT* o = static_cast<OutT*>(out);
  if (vec)
    coded_matmul_kernel<OutT, true><<<grid, kThreads, 0, st>>>(coeff, w, o, C, S, P);
  else
    coded_matmul_kernel<OutT, false><<<grid, kThreads, 0, st>>>(coeff, w, o, C, S, P);
}

}  // namespace

// coeff (C,S) f32, w (G,S,P) f32, out (G,C,P) f32 or bf16; all contiguous
// on the device.  vec = 1 only when P % 4 == 0 and w and out are 16-byte
// aligned (coeff is read a float at a time).  Returns cudaGetLastError()
// after the launch.
extern "C" int repro_coded_matmul(const float* coeff, const float* w,
                                  void* out, int64_t G, int64_t C, int64_t S,
                                  int64_t P, int out_bf16, int vec,
                                  void* stream) {
  if (G < 1 || C < 1 || S < 1 || S > kMaxS || P < 1 || G > 65535 ||
      (C + kBlockC - 1) / kBlockC > 65535 ||
      (P + kTileP - 1) / kTileP > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    launch<__nv_bfloat16>(coeff, w, out, G, C, static_cast<int>(S), P, vec, st);
  else
    launch<float>(coeff, w, out, G, C, static_cast<int>(S), P, vec, st);
  return static_cast<int>(cudaGetLastError());
}
