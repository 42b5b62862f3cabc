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
//   * each thread reads its 4 columns of all S rows of w once into
//     registers, then writes block_c = 32 output rows, each a coalesced
//     store, so w is read from device memory once for C <= 32.  How wide a
//     thread's loads and stores are follows the rows' alignment (kW, the
//     wrapper's choice, ``coded_matmul/ops.py::load_width``): a row of w
//     starts at element (g S + s) P and a row of out at (g C + c) P, so
//     when P % 4 == 0 (and the buffers are 16-byte aligned) every row is,
//     and a thread's 4 columns are one float4 (fp32; 8 bytes of bf16); when
//     P is only even, the rows alternate between two alignments, and a
//     thread's columns are two pairs 512 columns apart, each one 8-byte
//     load or store (fp32; 4 bytes of bf16), a warp's pairs contiguous; at
//     odd P a thread reads and writes 4 single columns 256 apart.  At the
//     CNN stage's rounds (P = 5 x 206,922 = 2 mod 4) the pairs replace the
//     single columns: the fp32 output, most of the bytes, leaves in half
//     as many stores and 256 contiguous bytes a warp;
//   * bf16 output rounds with __float2bfloat16_rn / __floats2bfloat162_rn,
//     round-to-nearest-even like torch's and XLA's casts;
//   * 64-bit element offsets throughout (G*C*P passes 2^31 at real sizes);
//   * ragged P is masked in the kernel: no padding copies.
//
// encode_decode_kernel (below) replaces the Pallas TPU kernel
// encode_decode_kernel in the same kernel.py: the slice-verification round trip
// out (S,P) = dec (S,C) @ (enc (C,S) @ w (S,P)), with the (C, P) coded
// intermediate never written to device memory and never reassociated (no
// dec @ enc is formed: the coded values are what the check is about).  It
// reads w once and writes out once (8 S bytes per column) against 4 C S
// FLOPs per column: 10 FLOP per byte at C = 20, S = 4 (bytes bound it),
// 50 at the reference benchmark's C = 100 (operations do, past the fp32
// ridge of 20).  Its products are fp32 FMAs on the CUDA cores: a thread
// holds 8 columns of w's S rows and of out's S rows in registers and walks
// the clients, reading each client's enc row and dec column from shared
// memory as float4 broadcasts (notes at the kernel).  The tensor cores
// were weighed and lost: 3xTF32 needs three TF32 products per fp32
// product, and S = 4 pads the MMA's k and n of 8 to twice the work, so
// mma.sync reaches a sixth of its TF32 rate in useful FLOPs, under the
// CUDA cores' fp32 rate (that design's times: PERF.md section 6).
//
// Any code dimension.  The register tiles above hold S <= 16 (kMaxS) and
// encode_decode's shared tables C*S <= 4096 (kMaxCS); larger shapes take
// two more kernels:
//   * coded_matmul_deep_kernel (S > 16): a 2-column register tile walked
//     over S in chunks of 16 rows; each thread keeps all kBlockC = 32 output
//     rows as accumulators (two blocks of 8 warps per SM), loads a chunk's
//     16 rows before its FMAs, and reads the chunk's coefficients as float4
//     broadcasts from shared memory, summing over s in ascending order;
//   * encode_decode_tiled_kernel (S > 16 or C*S > 4096): w read once and
//     out written once, the arithmetic on register tiles.  A block of 4
//     warps owns 128 columns and all S rows: it stages its columns of w in
//     shared memory once (in chunks of 128 rows past S = 128), and for each
//     chunk of 64 clients forms the coded tile enc[chunk] @ w (8 clients x 8
//     columns a thread, in registers), passes it through shared memory 32
//     clients at a time, and adds dec[:, chunk] @ coded into out's
//     accumulators (RT rows x 8 columns a thread, RT = S / 8 up to 8),
//     which stay in registers across all chunks; past 64 rows of out
//     the clients are walked again for each pass of 64 rows.  The tables
//     are copied per chunk, coalesced, and out's rows leave through shared
//     memory, coalesced.  The sums run over s and over c in ascending
//     order, fp32 FMAs from 0, as in encode_decode_kernel: the two kernels
//     give the same bits.
//
// bf16 operands.  The TPU kernels take coeff and w in any float dtype and
// widen them to fp32 before the MXU's fp32 products (kernel.py's
// ``.astype(jnp.float32)``).  Here w's type is a template parameter (WT,
// float or __nv_bfloat16) of every kernel, read through one widening load
// (wload1 / wload2 / wload4: 2, 4 or 8 bytes of bf16 where fp32 reads 4,
// 8 or 16), and the coefficient tables (coeff, enc, dec), which are copied
// into shared memory once a block, are read through tab(), which widens
// where the caller says the table is bf16.  Nothing is copied to fp32 in
// device memory; a bf16 operand halves w's bytes, and widening is exact,
// so a bf16 call gives the bits of the fp32 call on the widened operands.
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 4;                    // columns of P per thread
constexpr int kTileP = kThreads * kCols;    // columns of P per block
constexpr int kBlockC = 32;                 // output rows per block
constexpr int kMaxS = 16;                   // largest S of the register tile
constexpr int kMaxCS = 4096;                // largest C*S of the shared tables
constexpr int kDeepCols = 2;                // columns per thread, S > 16
constexpr int kDeepTileP = kThreads * kDeepCols;

// entry i of a coefficient table, fp32 or (``bf16``) bfloat16, as fp32
__device__ __forceinline__ float tab(const void* p, int64_t i, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

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

__device__ __forceinline__ void store2(float* o, const float* a) {
  *reinterpret_cast<float2*>(o) = make_float2(a[0], a[1]);
}
__device__ __forceinline__ void store2(__nv_bfloat16* o, const float* a) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a[0], a[1]);
}

// kW: columns a load or store, 4 (P % 4 == 0, 16-byte aligned buffers),
// 2 (P even, buffers aligned to two elements) or 1.  Every route sums over
// s in ascending order from 0 by fmaf, so all three give the same bits.
template <typename OutT, typename WT, int kW>
__global__ void __launch_bounds__(kThreads)
coded_matmul_kernel(const void* __restrict__ coeff, bool coeff_bf16,
                    const WT* __restrict__ w, OutT* __restrict__ out,
                    int64_t C, int S, int64_t P) {
  __shared__ float sc[kBlockC * kMaxS];
  const int64_t g = blockIdx.z;
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * kBlockC;
  const int nc = static_cast<int>(C - c0 < kBlockC ? C - c0 : kBlockC);
  // rows c0 .. c0+nc of the row-major (C, S) matrix are contiguous
  for (int i = threadIdx.x; i < nc * S; i += kThreads)
    sc[i] = tab(coeff, c0 * S + i, coeff_bf16);
  __syncthreads();

  const WT* wg = w + g * S * P;
  OutT* og = out + g * C * P;
  const int64_t tile = static_cast<int64_t>(blockIdx.x) * kTileP;
  float x[kMaxS][kCols];

  if (kW == 4) {
    // P % 4 == 0: a thread's 4 columns are all in range or all out
    const int64_t p = tile + static_cast<int64_t>(threadIdx.x) * kCols;
    if (p >= P) return;
#pragma unroll
    for (int s = 0; s < kMaxS; ++s) {
      if (s < S) wload4(wg + s * P + p, x[s]);
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
  } else if (kW == 2) {
    // P even: pairs at tile + 2 threadIdx.x + j * 2 kThreads, each in range
    // or out as a whole; a warp's pairs are contiguous
    int64_t p[2];
#pragma unroll
    for (int j = 0; j < 2; ++j)
      p[j] = tile + 2 * static_cast<int64_t>(threadIdx.x) + j * 2 * kThreads;
#pragma unroll
    for (int s = 0; s < kMaxS; ++s) {
      if (s < S) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float2 v = p[j] < P ? wload2(wg + s * P + p[j])
                                    : make_float2(0.f, 0.f);
          x[s][2 * j] = v.x;
          x[s][2 * j + 1] = v.y;
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
      for (int j = 0; j < 2; ++j)
        if (p[j] < P) store2(orow + p[j], acc + 2 * j);
    }
  } else {
    // columns tile + threadIdx.x + j*kThreads: each warp access is contiguous
#pragma unroll
    for (int s = 0; s < kMaxS; ++s) {
      if (s < S) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int64_t p = tile + threadIdx.x + j * kThreads;
          x[s][j] = p < P ? wload1(wg + s * P + p) : 0.f;
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

// S > 16: a register tile like coded_matmul_kernel's, walked over S in
// chunks of kMaxS rows.  A thread keeps all kBlockC output rows of its
// kDeepCols columns as accumulators and, for each chunk, loads the chunk's
// rows of its columns (float2 when kVec) before the FMAs, so 16 loads are
// in flight; the chunk's coefficients sit in shared memory as [c][s] and
// are read as float4 broadcasts.  The sum over s runs in ascending order.
template <typename OutT, typename WT, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
coded_matmul_deep_kernel(const void* __restrict__ coeff, bool coeff_bf16,
                         const WT* __restrict__ w, OutT* __restrict__ out,
                         int64_t C, int S, int64_t P) {
  __shared__ __align__(16) float sc[kBlockC][kMaxS];
  const int64_t g = blockIdx.z;
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * kBlockC;
  const int nc = static_cast<int>(C - c0 < kBlockC ? C - c0 : kBlockC);
  const WT* wg = w + g * S * P;
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
      sc[c][s] = (c < nc && s < ns) ? tab(coeff, (c0 + c) * S + s0 + s, coeff_bf16)
                                    : 0.f;
    }
    __syncthreads();
    float x[kMaxS][kDeepCols];
#pragma unroll
    for (int s = 0; s < kMaxS; ++s) {
      const WT* row = wg + static_cast<int64_t>(s0 + s) * P;
      if (kVec) {
        const float2 v = s < ns && col[0] < P ? wload2(row + col[0])
                                              : make_float2(0.f, 0.f);
        x[s][0] = v.x; x[s][1] = v.y;
      } else {
#pragma unroll
        for (int j = 0; j < kDeepCols; ++j)
          x[s][j] = s < ns && col[j] < P ? wload1(row + col[j]) : 0.f;
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

// width: columns a load, 4, 2 or 1 (the C interface's ``vec``)
template <typename OutT, typename WT>
void launch(const void* coeff, bool cb, const WT* w, void* out, int64_t G,
            int64_t C, int S, int64_t P, int width, cudaStream_t st) {
  OutT* o = static_cast<OutT*>(out);
  // the deep kernel's vector route reads 2 columns a thread
  const bool vec = width >= 2;
  if (S > kMaxS) {
    const dim3 grid(static_cast<unsigned>((P + kDeepTileP - 1) / kDeepTileP),
                    static_cast<unsigned>((C + kBlockC - 1) / kBlockC),
                    static_cast<unsigned>(G));
    if (vec)
      coded_matmul_deep_kernel<OutT, WT, true><<<grid, kThreads, 0, st>>>(
          coeff, cb, w, o, C, S, P);
    else
      coded_matmul_deep_kernel<OutT, WT, false><<<grid, kThreads, 0, st>>>(
          coeff, cb, w, o, C, S, P);
    return;
  }
  const dim3 grid(static_cast<unsigned>((P + kTileP - 1) / kTileP),
                  static_cast<unsigned>((C + kBlockC - 1) / kBlockC),
                  static_cast<unsigned>(G));
  if (width == 4)
    coded_matmul_kernel<OutT, WT, 4><<<grid, kThreads, 0, st>>>(coeff, cb, w, o,
                                                                C, S, P);
  else if (width == 2)
    coded_matmul_kernel<OutT, WT, 2><<<grid, kThreads, 0, st>>>(coeff, cb, w, o,
                                                                C, S, P);
  else
    coded_matmul_kernel<OutT, WT, 1><<<grid, kThreads, 0, st>>>(coeff, cb, w, o,
                                                                C, S, P);
}

// The round trip as two register-tiled products per block of kEdTileP
// columns, kEdThreads threads.  Thread roles: q = lane % 4 picks 8 of the
// warp's 32 columns; g = lane / 4 is a client group in the encode (clients
// 8 t + g of a chunk, t < 8) and a row group in the decode (rows 8 r + g of
// a pass, r < RT).  A thread's tiles are 8 clients x 8 columns and RT rows
// x 8 columns: a shared-memory load costs 4 bytes a lane whether or not the
// lanes share the address, so each loaded value feeds as many FMAs as the
// registers allow, 8 here.  Every copy from device
// memory is coalesced: w's rows, the tables in their own row-major layouts
// (rows padded to an odd stride, so the 8 groups' reads fall in 8 banks),
// and out's rows, written through the warp's scratch.  Shared memory
// (floats): each warp's rows of w, [sb][32]; the enc chunk [kEdCB][sb | 1];
// the dec chunk [8 RT][kEdCB + 1]; each warp's scratch, 32 clients of the
// coded tile [32][32] (16-byte chunks XOR-swizzled by row) or 32 rows of
// out [32][33].
constexpr int kEdThreads = 128;
constexpr int kEdWarps = kEdThreads / 32;
constexpr int kEdWarpCols = 32;                    // columns of P per warp
constexpr int kEdTileP = kEdWarps * kEdWarpCols;   // columns of P per block
constexpr int kEdCB = 64;                          // clients per chunk
constexpr int kEdSO = 64;                          // output rows per pass
constexpr int kEdSB = 128;                         // rows of w staged at once
constexpr int kEdScratch = 32 * 33;                // floats of a warp's scratch

__host__ __device__ constexpr int ed_smem_floats(int sb, int rt) {
  return sb * kEdWarps * kEdWarpCols +
         (kEdCB * (sb | 1) + 8 * rt * (kEdCB + 1) + 3) / 4 * 4 +
         kEdWarps * kEdScratch;
}

// entry i of a table into shared memory: by cp.async for fp32, widened by
// a load for bf16; zero when ``valid`` is false
__device__ __forceinline__ void ed_table(float* dst, const void* src,
                                         int64_t i, bool valid, bool bf16) {
  if (bf16)
    *dst = valid ? tab(src, i, true) : 0.f;
  else
    cp_async4(dst, static_cast<const float*>(src) + (valid ? i : 0), valid);
}

__device__ __forceinline__ void ld8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// cod[t][j] += enc[8t+g][s] * w[s][8q+j] over the chunk's ns rows, s
// ascending (CT = client groups in use; enc chunk rows of stride es)
template <int CT>
__device__ __forceinline__ void ed_encode(const float* ws, const float* encp,
                                          int es, int ns, int q, int g,
                                          float (&cod)[8][8]) {
  const float* e = encp + g * es;
#pragma unroll 2
  for (int s = 0; s < ns; ++s) {
    float xv[8];
    ld8(ws + s * 32 + 8 * q, xv);
#pragma unroll
    for (int t = 0; t < CT; ++t) {
      const float et = e[8 * t * es + s];
#pragma unroll
      for (int j = 0; j < 8; ++j) cod[t][j] = fmaf(et, xv[j], cod[t][j]);
    }
  }
}

// The coded tile holds 32 clients x 32 columns: client i's 16-byte chunk k
// (columns 4k .. 4k+3) at chunk k ^ (i % 8) of row i, so the 8 client
// groups' stores fall in 8 different banks.
__device__ __forceinline__ float* coded_at(float* coded, int i, int k) {
  return coded + i * 32 + 4 * (k ^ (i % 8));
}

// acc[r][j] += dec[8r+g][cc] * coded[cc][8q+j] over clients c0 .. c1 of the
// chunk, cc ascending; the coded tile holds clients c0 .. c0+32
template <int RT>
__device__ __forceinline__ void ed_decode(float* coded, const float* decp,
                                          int c0, int c1, int q, int g,
                                          float (&acc)[RT][8]) {
  const float* d = decp + g * (kEdCB + 1);
#pragma unroll 2
  for (int cc = c0; cc < c1; ++cc) {
    const float4 a = *reinterpret_cast<const float4*>(
        coded_at(coded, cc - c0, 2 * q));
    const float4 b = *reinterpret_cast<const float4*>(
        coded_at(coded, cc - c0, 2 * q + 1));
    const float cv[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const float dr = d[8 * r * (kEdCB + 1) + cc];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[r][j] = fmaf(dr, cv[j], acc[r][j]);
    }
  }
}

// The work runs as steps (pass of output rows, chunk of clients, chunk of
// s), in that loop order; each step copies its tables (cp.async), and, past
// kEdSB rows of w, its chunk of w (else w is copied once, with step 0's
// tables).  RT = row groups per pass: the template keeps the accumulators
// as few as S allows.
template <int RT, typename WT>
__global__ void __launch_bounds__(kEdThreads)
encode_decode_tiled_kernel(const void* __restrict__ enc,
                           const void* __restrict__ dec, bool enc_bf16,
                           bool dec_bf16, const WT* __restrict__ w,
                           float* __restrict__ out, int C, int S, int64_t P,
                           bool vec) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q = lane % 4, g = lane / 4;
  const int sb = S < kEdSB ? S : kEdSB, es = sb | 1;
  const bool resident = S <= kEdSB;                  // all of w staged once
  float* ws = smem + warp * sb * kEdWarpCols;
  float* encp = smem + kEdWarps * sb * kEdWarpCols;
  float* decp = encp + kEdCB * es;
  float* scratch = smem + ed_smem_floats(sb, RT) - kEdWarps * kEdScratch +
                   warp * kEdScratch;
  const int64_t wcol = static_cast<int64_t>(blockIdx.x) * kEdTileP +
                       warp * kEdWarpCols;           // the warp's first column
  const int nsc = (S + kEdSB - 1) / kEdSB;           // chunks of s
  const int nch = (C + kEdCB - 1) / kEdCB;           // chunks of clients
  const int steps = (S + kEdSO - 1) / kEdSO * nch * nsc;

  // rows s0 .. s0+ns of the warp's 32 columns of w into ws (0 past P): by
  // cp.async for fp32, by widening loads for bf16
  auto copy_w = [&](int s0, int ns) {
    if constexpr (!std::is_same<WT, float>::value) {
      for (int i = lane; i < ns * 8; i += 32) {
        const int s = i / 8, j = 4 * (i % 8);
        float* dst = ws + s * 32 + j;
        const WT* src = w + static_cast<int64_t>(s0 + s) * P + wcol + j;
        if (vec) {
          if (wcol + j < P) wload4(src, dst);
          else *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dst[e] = wcol + j + e < P ? wload1(src + e) : 0.f;
        }
      }
    } else if (vec) {    // P % 4 == 0: a float4 is all in range or all out
      for (int i = lane; i < ns * 8; i += 32) {
        const int s = i / 8, j = 4 * (i % 8);
        float* dst = ws + s * 32 + j;
        if (wcol + j < P)
          cp_async16(dst, w + static_cast<int64_t>(s0 + s) * P + wcol + j);
        else
          *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    } else {
      for (int s = 0; s < ns; ++s)
        cp_async4(ws + s * 32 + lane,
                     w + static_cast<int64_t>(s0 + s) * P + wcol + lane,
                     wcol + lane < P);
    }
  };

  if (resident) copy_w(0, S);
  float acc[RT][8], cod[8][8];
  for (int step = 0; step < steps; ++step) {
    const int sc = step % nsc, ch = step / nsc % nch;
    const int so0 = step / nsc / nch * kEdSO, c0 = ch * kEdCB, s0 = sc * kEdSB;
    const int nc = C - c0 < kEdCB ? C - c0 : kEdCB;
    const int ns = S - s0 < kEdSB ? S - s0 : kEdSB;
    const int ct = (nc + 7) / 8;
    if (ch == 0 && sc == 0)
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;
    if (sc == 0)
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int j = 0; j < 8; ++j) cod[t][j] = 0.f;
    __syncthreads();               // the last step is done with the tables
    if (!resident) copy_w(s0, ns);
    // enc rows c0 + cc, columns s0 .. s0+ns, and, on the chunk's last
    // s-chunk (where the decode runs), dec rows so0 .. so0+8 RT, columns
    // c0 .. c0+kEdCB; zeros past C and S
    for (int cc = warp; cc < 8 * ct; cc += kEdWarps)
      for (int s = lane; s < ns; s += 32)
        ed_table(encp + cc * es + s, enc,
                 static_cast<int64_t>(c0 + cc) * S + s0 + s, cc < nc, enc_bf16);
    if (sc == nsc - 1)
      for (int rr = warp; rr < 8 * RT; rr += kEdWarps)
        for (int cc = lane; cc < kEdCB; cc += 32)
          ed_table(decp + rr * (kEdCB + 1) + cc, dec,
                   static_cast<int64_t>(so0 + rr) * C + c0 + cc,
                   so0 + rr < S && cc < nc, dec_bf16);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    switch (ct) {
      case 1: ed_encode<1>(ws, encp, es, ns, q, g, cod); break;
      case 2: ed_encode<2>(ws, encp, es, ns, q, g, cod); break;
      case 3: ed_encode<3>(ws, encp, es, ns, q, g, cod); break;
      case 4: ed_encode<4>(ws, encp, es, ns, q, g, cod); break;
      case 5: ed_encode<5>(ws, encp, es, ns, q, g, cod); break;
      case 6: ed_encode<6>(ws, encp, es, ns, q, g, cod); break;
      case 7: ed_encode<7>(ws, encp, es, ns, q, g, cod); break;
      default: ed_encode<8>(ws, encp, es, ns, q, g, cod); break;
    }
    if (sc < nsc - 1) continue;
    // the chunk's coded values pass through the scratch 32 clients at a
    // time: clients 8t + g of t = 4h .. 4h+3
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (32 * h >= nc) break;
#pragma unroll
      for (int t = 4 * h; t < 4 * h + 4; ++t)
        if (t < ct) {
          const int i = 8 * (t - 4 * h) + g;
          *reinterpret_cast<float4*>(coded_at(scratch, i, 2 * q)) =
              make_float4(cod[t][0], cod[t][1], cod[t][2], cod[t][3]);
          *reinterpret_cast<float4*>(coded_at(scratch, i, 2 * q + 1)) =
              make_float4(cod[t][4], cod[t][5], cod[t][6], cod[t][7]);
        }
      __syncwarp();
      ed_decode<RT>(scratch, decp, 32 * h, nc < 32 * h + 32 ? nc : 32 * h + 32,
                    q, g, acc);
      __syncwarp();                // the coded tile is read
    }
    if (ch < nch - 1) continue;
    // the pass's rows, 32 at a time through the scratch: row 8r + g at
    // [8 (r % 4) + g][8q + j] (stride 33: no bank conflicts), then each
    // row written by the warp along its 32 columns
#pragma unroll
    for (int half = 0; half < (RT + 3) / 4; ++half) {
#pragma unroll
      for (int r = 4 * half; r < RT && r < 4 * half + 4; ++r)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          scratch[(8 * (r % 4) + g) * 33 + 8 * q + j] = acc[r][j];
      __syncwarp();
      const int rows = S - so0 - 32 * half < 32 ? S - so0 - 32 * half : 32;
      if (wcol + lane < P)
        for (int i = 0; i < rows; ++i)
          out[static_cast<int64_t>(so0 + 32 * half + i) * P + wcol + lane] =
              scratch[i * 33 + lane];
      __syncwarp();
    }
  }
}

template <int RT, typename WT>
void launch_ed_tiled(const void* enc, const void* dec, bool eb, bool db,
                     const WT* w, float* out, int C, int S, int64_t P,
                     bool vec, cudaStream_t st) {
  const int sb = S < kEdSB ? S : kEdSB;
  const int smem = static_cast<int>(sizeof(float)) * ed_smem_floats(sb, RT);
  if (smem > 48 * 1024)            // past 48 KB only when asked for
    cudaFuncSetAttribute(encode_decode_tiled_kernel<RT, WT>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid(static_cast<unsigned>((P + kEdTileP - 1) / kEdTileP));
  encode_decode_tiled_kernel<RT, WT><<<grid, kEdThreads, smem, st>>>(
      enc, dec, eb, db, w, out, C, S, P, vec);
}

template <typename WT>
void launch_ed_tiled_rt(const void* enc, const void* dec, bool eb, bool db,
                        const WT* w, float* out, int C, int S, int64_t P,
                        bool vec, cudaStream_t st) {
  switch ((S < kEdSO ? S + 7 : kEdSO + 7) / 8) {
    case 1: launch_ed_tiled<1>(enc, dec, eb, db, w, out, C, S, P, vec, st); break;
    case 2: launch_ed_tiled<2>(enc, dec, eb, db, w, out, C, S, P, vec, st); break;
    case 3: launch_ed_tiled<3>(enc, dec, eb, db, w, out, C, S, P, vec, st); break;
    case 4: launch_ed_tiled<4>(enc, dec, eb, db, w, out, C, S, P, vec, st); break;
    case 5: launch_ed_tiled<5>(enc, dec, eb, db, w, out, C, S, P, vec, st); break;
    case 6: launch_ed_tiled<6>(enc, dec, eb, db, w, out, C, S, P, vec, st); break;
    case 7: launch_ed_tiled<7>(enc, dec, eb, db, w, out, C, S, P, vec, st); break;
    default: launch_ed_tiled<8>(enc, dec, eb, db, w, out, C, S, P, vec, st); break;
  }
}

// ---- encode_decode's register tile (S <= 16, C*S <= 4096) ------------------
//
// A thread owns NC columns of P and all S rows: it holds w's S x NC tile
// and out's S x NC accumulators in registers, and for each client c, in
// ascending order, forms the coded values coded[j] = enc[c] . w[:, j]
// (fp32 FMAs from 0, s ascending) and adds dec[:, c] coded[j] to its
// accumulators.
//  * The tables sit in shared memory as one row a client, enc[c][0 ..
//    SMAX) then dec[0 .. SMAX)[c], zero past S, so a client's coefficients
//    are SMAX / 2 float4 broadcasts for 2 SMAX NC FMAs (the FFMA design
//    before read one scalar for every 4 FMAs), and the loop has no branch
//    on S: the padded rows add exact zeros.
//  * SMAX NC <= 32 keeps the tiles in registers; NC is the largest of 8,
//    4, 2 that still gives every SM a block.  A lane's columns are groups
//    of 4 (2 at NC = 2) consecutive columns, one 16-byte access each, the
//    groups a block's width apart, so every warp access is contiguous.
//  * w's loads are issued before the tables' fill, which they overlap.
//    One launch runs in one wave: a thread's single tile is loaded, walked
//    and stored (streaming several tiles a warp, with the next tile's w
//    loaded during this one's FMAs, measured slower: PERF.md section 6).
// Each output value is summed in the order of encode_decode_tiled_kernel,
// so the two routes give the same bits.
constexpr int kEfThreads = 256;

template <int SMAX, int NC, typename WT, bool kVec>
__global__ void __launch_bounds__(kEfThreads)
encode_decode_kernel(const void* __restrict__ enc, const void* __restrict__ dec,
                     bool enc_bf16, bool dec_bf16, const WT* __restrict__ w,
                     float* __restrict__ out, int C, int S, int64_t P) {
  static_assert(SMAX % 4 == 0 && SMAX * NC <= 32, "tiles in registers");
  constexpr int GW = NC < 4 ? NC : 4;        // columns of one vector access
  constexpr int NG = NC / GW;                // vector groups a thread
  extern __shared__ __align__(16) float tabs[];      // [C][2 SMAX]
  // The thread's column j.  kVec (P % 4 == 0, 16-byte aligned rows): group
  // j / GW of GW consecutive columns, all in range or all out, the groups
  // kEfThreads GW columns apart, so each warp access is contiguous; else
  // columns kEfThreads apart.
  const int64_t tile = static_cast<int64_t>(blockIdx.x) * kEfThreads * NC;
  auto col = [&](int j) -> int64_t {
    return kVec ? tile + static_cast<int64_t>(j / GW) * kEfThreads * GW +
                      GW * threadIdx.x + j % GW
                : tile + threadIdx.x + static_cast<int64_t>(j) * kEfThreads;
  };
  // w's loads are issued first: their latency overlaps the tables' fill
  float x[SMAX][NC], acc[SMAX][NC];
#pragma unroll
  for (int s = 0; s < SMAX; ++s) {
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      x[s][j] = 0.f;
      acc[s][j] = 0.f;
    }
    if (s >= S) continue;
    const WT* row = w + s * P;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      if (kVec) {
        const int64_t c = col(g * GW);
        if (c >= P) continue;
        if constexpr (GW == 4) {
          wload4(row + c, &x[s][g * GW]);
        } else {
          const float2 v = wload2(row + c);
          x[s][g * GW] = v.x;
          x[s][g * GW + 1] = v.y;
        }
      } else {
#pragma unroll
        for (int j = g * GW; j < g * GW + GW; ++j)
          if (col(j) < P) x[s][j] = wload1(row + col(j));
      }
    }
  }
  for (int i = threadIdx.x; i < C * 2 * SMAX; i += kEfThreads) {
    const int c = i / (2 * SMAX), k = i % (2 * SMAX), s = k % SMAX;
    tabs[i] = s >= S ? 0.f
                     : (k < SMAX ? tab(enc, static_cast<int64_t>(c) * S + s,
                                       enc_bf16)
                                 : tab(dec, static_cast<int64_t>(s) * C + c,
                                       dec_bf16));
  }
  __syncthreads();
  if (col(0) >= P) return;                 // the thread's first column
  const float* tp = tabs;
#pragma unroll 2
  for (int c = 0; c < C; ++c, tp += 2 * SMAX) {
    float e[SMAX], d[SMAX];
#pragma unroll
    for (int q = 0; q < SMAX; q += 4) {
      const float4 a = *reinterpret_cast<const float4*>(tp + q);
      const float4 b = *reinterpret_cast<const float4*>(tp + SMAX + q);
      e[q] = a.x; e[q + 1] = a.y; e[q + 2] = a.z; e[q + 3] = a.w;
      d[q] = b.x; d[q + 1] = b.y; d[q + 2] = b.z; d[q + 3] = b.w;
    }
    float coded[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      coded[j] = 0.f;
#pragma unroll
      for (int s = 0; s < SMAX; ++s) coded[j] = fmaf(e[s], x[s][j], coded[j]);
    }
#pragma unroll
    for (int s = 0; s < SMAX; ++s)
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[s][j] = fmaf(d[s], coded[j], acc[s][j]);
  }
#pragma unroll
  for (int s = 0; s < SMAX; ++s) {
    if (s >= S) break;
    float* orow = out + s * P;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      if (kVec) {
        const int64_t c = col(g * GW);
        if (c >= P) continue;
        if constexpr (GW == 4)
          store4(orow + c, &acc[s][g * GW]);
        else
          *reinterpret_cast<float2*>(orow + c) =
              make_float2(acc[s][g * GW], acc[s][g * GW + 1]);
      } else {
#pragma unroll
        for (int j = g * GW; j < g * GW + GW; ++j)
          if (col(j) < P) orow[col(j)] = acc[s][j];
      }
    }
  }
}

template <int SMAX, int NC, typename WT>
void launch_ed_nc(const void* enc, const void* dec, bool eb, bool db,
                  const WT* w, float* out, int C, int S, int64_t P, bool vec,
                  cudaStream_t st) {
  const int smem = C * 2 * SMAX * static_cast<int>(sizeof(float));
  const dim3 grid(static_cast<unsigned>((P + kEfThreads * NC - 1) /
                                        (kEfThreads * NC)));
  if (vec) {
    auto kern = encode_decode_kernel<SMAX, NC, WT, true>;
    if (smem > 48 * 1024)          // past 48 KB only when asked for
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
    kern<<<grid, kEfThreads, smem, st>>>(enc, dec, eb, db, w, out, C, S, P);
  } else {
    auto kern = encode_decode_kernel<SMAX, NC, WT, false>;
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
    kern<<<grid, kEfThreads, smem, st>>>(enc, dec, eb, db, w, out, C, S, P);
  }
}

// NC: the largest of 32 / SMAX columns (at most 8) whose grid still has a
// block for every SM, and at least 2
template <int SMAX, typename WT>
void launch_ed(const void* enc, const void* dec, bool eb, bool db, const WT* w,
               float* out, int C, int S, int64_t P, bool vec, cudaStream_t st) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  auto fills = [&](int nc) {
    return (P + kEfThreads * nc - 1) / (kEfThreads * nc) >= sms;
  };
  if (SMAX <= 4 && fills(8))
    launch_ed_nc<SMAX, 32 / SMAX < 8 ? 32 / SMAX : 8>(enc, dec, eb, db, w,
                                                       out, C, S, P, vec, st);
  else if (SMAX <= 8 && fills(4))
    launch_ed_nc<SMAX, 32 / SMAX < 4 ? 32 / SMAX : 4>(enc, dec, eb, db, w,
                                                       out, C, S, P, vec, st);
  else
    launch_ed_nc<SMAX, 2>(enc, dec, eb, db, w, out, C, S, P, vec, st);
}

template <typename WT>
void encode_decode(const void* enc, const void* dec, bool eb, bool db,
                   const WT* w, float* out, int c, int s, int64_t P, bool vec,
                   cudaStream_t st) {
  if (s > kMaxS || c * s > kMaxCS)
    launch_ed_tiled_rt(enc, dec, eb, db, w, out, c, s, P, vec, st);
  else if (s <= 4)
    launch_ed<4>(enc, dec, eb, db, w, out, c, s, P, vec, st);
  else if (s <= 8)
    launch_ed<8>(enc, dec, eb, db, w, out, c, s, P, vec, st);
  else
    launch_ed<16>(enc, dec, eb, db, w, out, c, s, P, vec, st);
}

template <typename WT>
void coded(const void* coeff, bool cb, const void* w, void* out, int64_t G,
           int64_t C, int S, int64_t P, bool out_bf16, int width,
           cudaStream_t st) {
  const WT* wt = static_cast<const WT*>(w);
  if (out_bf16)
    launch<__nv_bfloat16>(coeff, cb, wt, out, G, C, S, P, width, st);
  else
    launch<float>(coeff, cb, wt, out, G, C, S, P, width, st);
}

}  // namespace

// coeff (C,S), w (G,S,P), each fp32 or (coeff_bf16, w_bf16) bf16; out
// (G,C,P) f32 or bf16; all contiguous on the device.  vec = 1 only when
// P % 4 == 0 and w and out are 16-byte aligned; vec = 2 only when P is even
// and w and out are aligned to two of their elements; else 0 (coeff is
// read an element at a time).  Returns cudaGetLastError() after the
// launch.
extern "C" int repro_coded_matmul(const void* coeff, const void* w,
                                  void* out, int64_t G, int64_t C, int64_t S,
                                  int64_t P, int out_bf16, int vec,
                                  int coeff_bf16, int w_bf16, void* stream) {
  if (G < 1 || C < 1 || S < 1 || S > 0x7fffffffLL || P < 1 || G > 65535 ||
      (C + kBlockC - 1) / kBlockC > 65535 ||
      (P + kTileP - 1) / kTileP > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec < 0 || vec > 2 || (vec == 1 && P % 4) || (vec == 2 && P % 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const int s = static_cast<int>(S);
  const int width = vec == 1 ? 4 : vec == 2 ? 2 : 1;
  if (w_bf16)
    coded<__nv_bfloat16>(coeff, coeff_bf16 != 0, w, out, G, C, s, P,
                         out_bf16 != 0, width, st);
  else
    coded<float>(coeff, coeff_bf16 != 0, w, out, G, C, s, P, out_bf16 != 0,
                 width, st);
  return static_cast<int>(cudaGetLastError());
}

// enc (C,S), dec (S,C) and w (S,P), each fp32 or (enc_bf16, dec_bf16,
// w_bf16) bf16, and out (S,P) fp32, contiguous on the device.  vec = 1 only
// when P % 4 == 0 and w and out are 16-byte aligned.  Returns
// cudaGetLastError() after the launch.
extern "C" int repro_encode_decode(const void* enc, const void* dec,
                                   const void* w, float* out, int64_t C,
                                   int64_t S, int64_t P, int vec, int enc_bf16,
                                   int dec_bf16, int w_bf16, void* stream) {
  if (C < 1 || S < 1 || C > 0x7fffffffLL || S > 0x7fffffffLL || P < 1 ||
      (P + kEdTileP - 1) / kEdTileP > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int c = static_cast<int>(C), s = static_cast<int>(S);
  if (w_bf16)
    encode_decode(enc, dec, enc_bf16 != 0, dec_bf16 != 0,
                  static_cast<const __nv_bfloat16*>(w), out, c, s, P, vec != 0,
                  st);
  else
    encode_decode(enc, dec, enc_bf16 != 0, dec_bf16 != 0,
                  static_cast<const float*>(w), out, c, s, P, vec != 0, st);
  return static_cast<int>(cudaGetLastError());
}
