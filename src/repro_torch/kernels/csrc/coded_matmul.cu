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
//
// Any code dimension.  The register tiles above hold S <= 16 (kMaxS) and
// encode_decode's shared tables C*S <= 4096 (kMaxCS); larger shapes take
// two more kernels, with the same sums in the same order:
//   * coded_matmul_deep_kernel (S > 16): a 2-column register tile walked
//     over S in chunks of 16 rows; each thread keeps all kBlockC = 32 output
//     rows as accumulators (two blocks of 8 warps per SM), loads a chunk's
//     16 rows before its FMAs, and reads the chunk's coefficients as float4
//     broadcasts from shared memory;
//   * encode_decode_deep_kernel (S > 16 or C*S > 4096): one column per
//     thread; clients pass in chunks of kChunkC whose coded values stay in
//     registers (the (C, P) intermediate never reaches device memory), and
//     the S output rows take each chunk's terms in ascending c, carried
//     between chunks in the output itself; the chunk's enc and dec columns
//     pass through a shared table kChunkS rows of s at a time, so no size
//     is bounded.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 4;                    // columns of P per thread
constexpr int kTileP = kThreads * kCols;    // columns of P per block
constexpr int kBlockC = 32;                 // output rows per block
constexpr int kMaxS = 16;                   // largest S of the register tile
constexpr int kMaxCS = 4096;                // largest C*S of the shared tables
constexpr int kDeepCols = 2;                // columns per thread, S > 16
constexpr int kDeepTileP = kThreads * kDeepCols;
constexpr int kChunkS = 64;                 // rows of s per table chunk
constexpr int kChunkC = 32;                 // clients per register chunk

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

__device__ __forceinline__ void store2(float* o, const float* a) {
  *reinterpret_cast<float2*>(o) = make_float2(a[0], a[1]);
}
__device__ __forceinline__ void store2(__nv_bfloat16* o, const float* a) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a[0], a[1]);
}

// S > 16: a register tile like coded_matmul_kernel's, walked over S in
// chunks of kMaxS rows.  A thread keeps all kBlockC output rows of its
// kDeepCols columns as accumulators and, for each chunk, loads the chunk's
// rows of its columns (float2 when kVec) before the FMAs, so 16 loads are
// in flight; the chunk's coefficients sit in shared memory as [c][s] and
// are read as float4 broadcasts.  The sum over s runs in ascending order.
template <typename OutT, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
coded_matmul_deep_kernel(const float* __restrict__ coeff,
                         const float* __restrict__ w, OutT* __restrict__ out,
                         int64_t C, int S, int64_t P) {
  __shared__ __align__(16) float sc[kBlockC][kMaxS];
  const int64_t g = blockIdx.z;
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * kBlockC;
  const int nc = static_cast<int>(C - c0 < kBlockC ? C - c0 : kBlockC);
  const float* wg = w + g * S * P;
  OutT* og = out + g * C * P;
  const int64_t tile = static_cast<int64_t>(blockIdx.x) * kDeepTileP;
  int64_t col[kDeepCols];
#pragma unroll
  for (int j = 0; j < kDeepCols; ++j)
    col[j] = kVec ? tile + static_cast<int64_t>(threadIdx.x) * kDeepCols + j
                  : tile + threadIdx.x + j * kThreads;
  float acc[kBlockC][kDeepCols];
#pragma unroll
  for (int c = 0; c < kBlockC; ++c)
#pragma unroll
    for (int j = 0; j < kDeepCols; ++j) acc[c][j] = 0.f;
  for (int s0 = 0; s0 < S; s0 += kMaxS) {
    const int ns = S - s0 < kMaxS ? S - s0 : kMaxS;
    __syncthreads();                  // the last chunk's coefficients are read
    for (int i = threadIdx.x; i < kBlockC * kMaxS; i += kThreads) {
      const int c = i / kMaxS, s = i % kMaxS;
      sc[c][s] = (c < nc && s < ns) ? coeff[(c0 + c) * S + s0 + s] : 0.f;
    }
    __syncthreads();
    float x[kMaxS][kDeepCols];
#pragma unroll
    for (int s = 0; s < kMaxS; ++s) {
      const float* row = wg + static_cast<int64_t>(s0 + s) * P;
      if (kVec) {
        const float2 v = s < ns && col[0] < P
                             ? *reinterpret_cast<const float2*>(row + col[0])
                             : make_float2(0.f, 0.f);
        x[s][0] = v.x; x[s][1] = v.y;
      } else {
#pragma unroll
        for (int j = 0; j < kDeepCols; ++j)
          x[s][j] = s < ns && col[j] < P ? row[col[j]] : 0.f;
      }
    }
#pragma unroll
    for (int c = 0; c < kBlockC; ++c) {
      if (c >= nc) break;
#pragma unroll
      for (int s4 = 0; s4 < kMaxS; s4 += 4) {
        if (s4 >= ns) break;
        const float4 k = *reinterpret_cast<const float4*>(&sc[c][s4]);
        const float kk[4] = {k.x, k.y, k.z, k.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (s4 + e < ns)
#pragma unroll
            for (int j = 0; j < kDeepCols; ++j)
              acc[c][j] = fmaf(kk[e], x[s4 + e][j], acc[c][j]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kBlockC; ++c) {
    if (c >= nc) break;
    OutT* orow = og + (c0 + c) * P;
    if (kVec) {
      if (col[0] < P) store2(orow + col[0], acc[c]);
    } else {
#pragma unroll
      for (int j = 0; j < kDeepCols; ++j)
        if (col[j] < P) store1(orow + col[j], acc[c][j]);
    }
  }
}

template <typename OutT>
void launch(const float* coeff, const float* w, void* out, int64_t G,
            int64_t C, int S, int64_t P, bool vec, cudaStream_t st) {
  OutT* o = static_cast<OutT*>(out);
  if (S > kMaxS) {
    const dim3 grid(static_cast<unsigned>((P + kDeepTileP - 1) / kDeepTileP),
                    static_cast<unsigned>((C + kBlockC - 1) / kBlockC),
                    static_cast<unsigned>(G));
    if (vec)
      coded_matmul_deep_kernel<OutT, true><<<grid, kThreads, 0, st>>>(
          coeff, w, o, C, S, P);
    else
      coded_matmul_deep_kernel<OutT, false><<<grid, kThreads, 0, st>>>(
          coeff, w, o, C, S, P);
    return;
  }
  const dim3 grid(static_cast<unsigned>((P + kTileP - 1) / kTileP),
                  static_cast<unsigned>((C + kBlockC - 1) / kBlockC),
                  static_cast<unsigned>(G));
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

// S > 16 or C*S > 4096: one column per thread, tile + threadIdx.x.  For
// each chunk of up to kChunkC clients, the coded values enc[c] . w of this
// column are formed in registers (sum over s ascending), then each output
// row adds dec[s, c] * coded[c] in ascending c onto its sum so far, which
// lives in ``out`` between chunks (fp32 stores and loads are exact).  The
// chunk's enc and dec columns pass through shared memory kChunkS rows of s
// at a time, as [s][c], read as float4 broadcasts.
__global__ void __launch_bounds__(kThreads)
encode_decode_deep_kernel(const float* __restrict__ enc,
                          const float* __restrict__ dec,
                          const float* __restrict__ w, float* __restrict__ out,
                          int C, int S, int64_t P) {
  __shared__ __align__(16) float tab[kChunkS][kChunkC];
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const bool live = p < P;
  for (int c0 = 0; c0 < C; c0 += kChunkC) {
    const int nc = C - c0 < kChunkC ? C - c0 : kChunkC;
    float coded[kChunkC];
#pragma unroll
    for (int i = 0; i < kChunkC; ++i) coded[i] = 0.f;
    for (int s0 = 0; s0 < S; s0 += kChunkS) {
      const int ns = S - s0 < kChunkS ? S - s0 : kChunkS;
      __syncthreads();                // the last table is read
      for (int t = threadIdx.x; t < kChunkS * kChunkC; t += kThreads) {
        const int s = t / kChunkC, i = t % kChunkC;
        tab[s][i] = s < ns && i < nc
                        ? enc[static_cast<int64_t>(c0 + i) * S + s0 + s] : 0.f;
      }
      __syncthreads();
      for (int s = 0; s < ns && live; ++s) {
        const float x = w[(s0 + s) * P + p];
#pragma unroll
        for (int i4 = 0; i4 < kChunkC; i4 += 4) {
          const float4 e = *reinterpret_cast<const float4*>(&tab[s][i4]);
          coded[i4 + 0] = fmaf(e.x, x, coded[i4 + 0]);
          coded[i4 + 1] = fmaf(e.y, x, coded[i4 + 1]);
          coded[i4 + 2] = fmaf(e.z, x, coded[i4 + 2]);
          coded[i4 + 3] = fmaf(e.w, x, coded[i4 + 3]);
        }
      }
    }
    for (int s0 = 0; s0 < S; s0 += kChunkS) {
      const int ns = S - s0 < kChunkS ? S - s0 : kChunkS;
      __syncthreads();
      for (int t = threadIdx.x; t < kChunkS * kChunkC; t += kThreads) {
        const int s = t / kChunkC, i = t % kChunkC;
        tab[s][i] = s < ns && i < nc
                        ? dec[static_cast<int64_t>(s0 + s) * C + c0 + i] : 0.f;
      }
      __syncthreads();
      for (int s = 0; s < ns && live; ++s) {
        float* o = out + (s0 + s) * P + p;
        float acc = c0 == 0 ? 0.f : *o;
#pragma unroll
        for (int i4 = 0; i4 < kChunkC; i4 += 4) {
          const float4 d = *reinterpret_cast<const float4*>(&tab[s][i4]);
          acc = fmaf(d.x, coded[i4 + 0], acc);
          acc = fmaf(d.y, coded[i4 + 1], acc);
          acc = fmaf(d.z, coded[i4 + 2], acc);
          acc = fmaf(d.w, coded[i4 + 3], acc);
        }
        *o = acc;
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
  if (G < 1 || C < 1 || S < 1 || S > 0x7fffffffLL || P < 1 || G > 65535 ||
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
// device.  vec = 1 only when P % 4 == 0 and w and out are 16-byte aligned.
// Returns cudaGetLastError() after the launch.
extern "C" int repro_encode_decode(const float* enc, const float* dec,
                                   const float* w, float* out, int64_t C,
                                   int64_t S, int64_t P, int vec, void* stream) {
  if (C < 1 || S < 1 || C > 0x7fffffffLL || S > 0x7fffffffLL || P < 1 ||
      (P + kThreads - 1) / kThreads > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int c = static_cast<int>(C), s = static_cast<int>(S);
  if (S > kMaxS || C * S > kMaxCS) {
    const dim3 grid(static_cast<unsigned>((P + kThreads - 1) / kThreads));
    encode_decode_deep_kernel<<<grid, kThreads, 0, st>>>(enc, dec, w, out, c,
                                                         s, P);
  } else if (S <= 4)
    launch_ed<4>(enc, dec, w, out, c, s, P, vec, st);
  else if (S <= 8)
    launch_ed<8>(enc, dec, w, out, c, s, P, vec, st);
  else
    launch_ed<16>(enc, dec, w, out, c, s, P, vec, st);
  return static_cast<int>(cudaGetLastError());
}
