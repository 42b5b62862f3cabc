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
//
// encode_decode_kernel (below) replaces the Pallas TPU kernel
// encode_decode_kernel in the same kernel.py: the slice-verification round trip
// out (S,P) = dec (S,C) @ (enc (C,S) @ w (S,P)), with the (C, P) coded
// intermediate never written to device memory.  It reads w once and writes
// out once (8 S bytes per column) against 4 C S FLOPs per column: bytes
// bound it (at C = 20, S = 4 that is 10 FLOP per byte, under the fp32
// ridge of 20).  Each thread holds 4 columns of w's S rows in registers;
// for each client c it forms the coded value enc[c] . w (its 4 columns in
// registers) and adds dec[:, c] times it to the S output rows, so C only
// sets the work per column, not the registers; enc and dec sit in shared
// memory and every read of them is a broadcast.  The template bound on S
// (4, 8 or 16) keeps the two (S x 4) register tiles as small as S allows.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 4;                    // columns of P per thread
constexpr int kTileP = kThreads * kCols;    // columns of P per block
constexpr int kBlockC = 32;                 // output rows per block
constexpr int kMaxS = 16;                   // largest code dimension
constexpr int kMaxCS = 4096;                // largest C*S of encode_decode

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

template <int SMAX, bool kVec>
__global__ void __launch_bounds__(kThreads)
encode_decode_kernel(const float* __restrict__ enc, const float* __restrict__ dec,
                     const float* __restrict__ w, float* __restrict__ out,
                     int C, int S, int64_t P) {
  __shared__ float se[kMaxCS], sd[kMaxCS];
  for (int i = threadIdx.x; i < C * S; i += kThreads) {
    se[i] = enc[i];               // (C, S) row-major
    sd[i] = dec[i];               // (S, C) row-major
  }
  __syncthreads();
  const int64_t tile = static_cast<int64_t>(blockIdx.x) * kTileP;
  float x[SMAX][kCols], acc[SMAX][kCols];
  int64_t col[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j)
    col[j] = kVec ? tile + static_cast<int64_t>(threadIdx.x) * kCols + j
                  : tile + threadIdx.x + j * kThreads;
  if (kVec && col[0] >= P) return;
#pragma unroll
  for (int s = 0; s < SMAX; ++s) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[s][j] = 0.f;
    if (s < S) {
      if (kVec) {
        const float4 v = *reinterpret_cast<const float4*>(w + s * P + col[0]);
        x[s][0] = v.x; x[s][1] = v.y; x[s][2] = v.z; x[s][3] = v.w;
      } else {
#pragma unroll
        for (int j = 0; j < kCols; ++j) x[s][j] = col[j] < P ? w[s * P + col[j]] : 0.f;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kCols; ++j) x[s][j] = 0.f;
    }
  }
  for (int c = 0; c < C; ++c) {
    float coded[kCols] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int s = 0; s < SMAX; ++s) {
      if (s < S) {
        const float e = se[c * S + s];
#pragma unroll
        for (int j = 0; j < kCols; ++j) coded[j] = fmaf(e, x[s][j], coded[j]);
      }
    }
#pragma unroll
    for (int s = 0; s < SMAX; ++s) {
      if (s < S) {
        const float d = sd[s * C + c];
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[s][j] = fmaf(d, coded[j], acc[s][j]);
      }
    }
  }
#pragma unroll
  for (int s = 0; s < SMAX; ++s) {
    if (s < S) {
      if (kVec) {
        store4(out + s * P + col[0], acc[s]);
      } else {
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          if (col[j] < P) out[s * P + col[j]] = acc[s][j];
      }
    }
  }
}

template <int SMAX>
void launch_ed(const float* enc, const float* dec, const float* w, float* out,
               int C, int S, int64_t P, bool vec, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>((P + kTileP - 1) / kTileP));
  if (vec)
    encode_decode_kernel<SMAX, true><<<grid, kThreads, 0, st>>>(enc, dec, w, out, C, S, P);
  else
    encode_decode_kernel<SMAX, false><<<grid, kThreads, 0, st>>>(enc, dec, w, out, C, S, P);
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

// enc (C,S), dec (S,C), w (S,P) and out (S,P) fp32, contiguous on the
// device; S <= 16 and C*S <= 4096.  vec = 1 only when P % 4 == 0 and w and
// out are 16-byte aligned.  Returns cudaGetLastError() after the launch.
extern "C" int repro_encode_decode(const float* enc, const float* dec,
                                   const float* w, float* out, int64_t C,
                                   int64_t S, int64_t P, int vec, void* stream) {
  if (C < 1 || S < 1 || S > kMaxS || C * S > kMaxCS || P < 1 ||
      (P + kTileP - 1) / kTileP > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int c = static_cast<int>(C), s = static_cast<int>(S);
  if (S <= 4)
    launch_ed<4>(enc, dec, w, out, c, s, P, vec, st);
  else if (S <= 8)
    launch_ed<8>(enc, dec, w, out, c, s, P, vec, st);
  else
    launch_ed<16>(enc, dec, w, out, c, s, P, vec, st);
  return static_cast<int>(cudaGetLastError());
}
