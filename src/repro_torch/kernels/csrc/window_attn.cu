// Causal sliding-window attention for Hopper, forward and backward.  Query
// i attends keys j with i - window < j <= i at scale hd^-1/2:
//   O_i = sum_j P_ij V_j,   P_ij = exp(scale q_i.k_j - lse_i),
//   lse_i = log sum_j exp(scale q_i.k_j).
// q: (B, S, H, hd) and k, v: (B, S, KV, hd), read through their batch,
// sequence and head strides (the head dim is contiguous); query head h
// reads kv head h / (H / KV).  O: (B, S, H, hd) and lse: (B, H, S), fp32.
// hd <= 128; ragged S and hd are masked here, nothing is padded.
//
// Replaces the Pallas TPU kernel window_attention_kernel in
// src/repro/kernels/window_attn/kernel.py (forward; its wrapper expanded the
// GQA heads with repeat, transposed to (B*H, S, hd) and padded S to its
// block and hd to 128) and adds the backward it never had (the reference's
// model path differentiates its jnp local path instead).
//
// What bounds it on an H100.  Per (query, key) pair in the window the
// forward does 4 hd FLOPs (q.k and p v) and one exp; the backward 10 hd
// (dV, dP, dQ, dK and the recomputed q.k, counted once).  At gemma3-27b's
// local layer (B 2, S 4096, 32 heads of 128, window 1024) that is 120 GFLOP
// forward against 0.40 GB of inputs and outputs: operations bound it by a
// factor of 15 at 67 TFLOP/s fp32.  fp32 parity rules out TF32, so the
// products run on the CUDA cores.
//
// Design.  A block of 256 threads owns one (64-query or 64-key) tile of one
// head and walks only the 64-wide tiles of the other side that its window
// reaches, as the TPU grid's span did.  Tiles sit in shared memory with rows
// padded by 4 floats, so the 16-byte reads of 8 neighbouring rows fall in
// distinct banks.  Thread (ty, tx) of a 16 x 16 grid computes score rows
// 4 ty .. 4 ty + 3 at key columns tx + 16 c (c < 4), and output rows
// 4 ty .. 4 ty + 3 at head-dim columns 4 tx + 64 c' (float4 groups); the
// row reductions of the softmax are shuffles over the 16 lanes tx.
//  * forward: online softmax in base 2 (scores pre-scaled by log2 e), K and
//    then V staged through one buffer; writes O and lse.
//  * backward, FlashAttention-2 form, P recomputed from q, k and lse:
//    D_i = dO_i.O_i (wattn_bwd_delta_kernel), dS = P o (dO V^T - D),
//    dQ = scale dS K (wattn_bwd_dq_kernel, over query tiles) and dV = P^T dO,
//    dK = scale dS^T Q (wattn_bwd_dkv_kernel, over key tiles; it sums the
//    G query heads of its kv head and their query tiles in a fixed order).
//    No atomics: two runs give the same bits.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;          // queries or keys per tile
constexpr int kThreads = 256;
constexpr int kLdP = kTile + 4;    // row stride of the score tiles
constexpr int kMaxHd = 128;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Strides {
  int64_t b, s, h;
};

struct Geom {
  int S, H, KV, hd, window;
  float scale;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float comp(float4 a, int e) {
  return e == 0 ? a.x : e == 1 ? a.y : e == 2 ? a.z : a.w;
}

// Reductions over the 16 lanes tx that share a row (lanes 0-15, 16-31).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Rows t0 .. t0+63 of one head's (S, hd) slice, row stride ``ss``, into
// dst[64][HDP + 4]; zero outside S and hd.  Loads are issued 8 at a time.
template <int HDP>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          int64_t ss, int t0, int S, int hd) {
  constexpr int LD = HDP + 4, kIters = kTile * HDP / kThreads, kBatch = 8;
#pragma unroll 1
  for (int b0 = 0; b0 < kIters; b0 += kBatch) {
    float buf[kBatch];
#pragma unroll
    for (int it = 0; it < kBatch; ++it) {
      const int idx = threadIdx.x + (b0 + it) * kThreads;
      const int r = idx / HDP, d = idx % HDP, t = t0 + r;
      buf[it] = (t < S && d < hd) ? src[static_cast<int64_t>(t) * ss + d] : 0.f;
    }
#pragma unroll
    for (int it = 0; it < kBatch; ++it) {
      const int idx = threadIdx.x + (b0 + it) * kThreads;
      dst[(idx / HDP) * LD + idx % HDP] = buf[it];
    }
  }
}

// (64 x 64) products A B^T of two staged tiles: acc[r][c] += A[4 ty + r] .
// B[tx + 16 c] over HDP columns.
template <int HDP>
__device__ __forceinline__ void tile_abt(float (&acc)[4][4], const float* A,
                                         const float* B, int ty, int tx) {
  constexpr int LD = HDP + 4;
#pragma unroll 4
  for (int d = 0; d < HDP; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = ld4(A + (4 * ty + r) * LD + d);
#pragma unroll
    for (int c = 0; c < 4; ++c) b[c] = ld4(B + (tx + 16 * c) * LD + d);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = dot4(a[r], b[c], acc[r][c]);
  }
}

__device__ __forceinline__ bool in_window(int qi, int kj, const Geom& g) {
  return qi < g.S && kj < g.S && kj <= qi && kj > qi - g.window;
}

template <int HDP>
constexpr int fwd_smem() { return (2 * kTile * (HDP + 4) + kTile * kLdP) * 4; }

template <int HDP>
__global__ void __launch_bounds__(kThreads, 2)
wattn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, Geom g, Strides sq, Strides sk,
                 Strides sv) {
  constexpr int LD = HDP + 4, CG = HDP / 64;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                    // [64][LD]
  float* sKV = sQ + kTile * LD;        // [64][LD]: K, then V
  float* sP = sKV + kTile * LD;        // [64][kLdP]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * kTile, bh = blockIdx.y;
  const int b = bh / g.H, h = bh % g.H, kvh = h / (g.H / g.KV);
  const float* kb = k + b * sk.b + kvh * sk.h;
  const float* vb = v + b * sv.b + kvh * sv.h;
  load_tile<HDP>(sQ, q + b * sq.b + h * sq.h, sq.s, q0, g.S, g.hd);

  const float c2 = g.scale * kLog2e;
  float m[4], l[4], acc[4][4 * CG];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < 4 * CG; ++e) acc[r][e] = 0.f;
  }
  const int k_lo = max(0, q0 - g.window + 1) / kTile * kTile;
  const int k_hi = min(g.S, q0 + kTile);
  for (int k0 = k_lo; k0 < k_hi; k0 += kTile) {
    __syncthreads();                   // the last tile's P V is done
    load_tile<HDP>(sKV, kb, sk.s, k0, g.S, g.hd);
    __syncthreads();
    float sc[4][4] = {};
    tile_abt<HDP>(sc, sQ, sKV, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qi = q0 + 4 * ty + r;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sc[r][c] = in_window(qi, k0 + tx + 16 * c, g) ? sc[r][c] * c2 : -INFINITY;
        mx = fmaxf(mx, sc[r][c]);
      }
      const float mn = fmaxf(m[r], row_max(mx));
      const bool none = mn == -INFINITY;      // no key of this row yet
      const float corr = none ? 1.f : exp2f(m[r] - mn);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = none ? 0.f : exp2f(sc[r][c] - mn);
        sP[(4 * ty + r) * kLdP + tx + 16 * c] = p;
        rs += p;
      }
      l[r] = fmaf(l[r], corr, row_sum(rs));
      m[r] = mn;
#pragma unroll
      for (int e = 0; e < 4 * CG; ++e) acc[r][e] *= corr;
    }
    __syncthreads();                   // K read, P written
    load_tile<HDP>(sKV, vb, sv.s, k0, g.S, g.hd);
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < kTile; j += 4) {
      float4 p4[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) p4[r] = ld4(sP + (4 * ty + r) * kLdP + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int cg = 0; cg < CG; ++cg) {
          const float4 v4 = ld4(sKV + (j + jj) * LD + 4 * tx + 64 * cg);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float p = comp(p4[r], jj);
            acc[r][4 * cg + 0] = fmaf(p, v4.x, acc[r][4 * cg + 0]);
            acc[r][4 * cg + 1] = fmaf(p, v4.y, acc[r][4 * cg + 1]);
            acc[r][4 * cg + 2] = fmaf(p, v4.z, acc[r][4 * cg + 2]);
            acc[r][4 * cg + 3] = fmaf(p, v4.w, acc[r][4 * cg + 3]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + 4 * ty + r;
    if (qi >= g.S) continue;
    const float inv = 1.f / l[r];
    float* orow = o + ((static_cast<int64_t>(b) * g.S + qi) * g.H + h) * g.hd;
#pragma unroll
    for (int cg = 0; cg < CG; ++cg)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * tx + 64 * cg + e;
        if (d < g.hd) orow[d] = acc[r][4 * cg + e] * inv;
      }
    if (tx == 0)
      lse[static_cast<int64_t>(bh) * g.S + qi] = (m[r] + log2f(l[r])) * kLn2;
  }
}

// D[b, h, i] = dO_i . O_i: one warp per (b, i, h) row of the contiguous
// (B, S, H, hd) O and dO; written (B, H, S).
__global__ void __launch_bounds__(kThreads)
wattn_bwd_delta_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                       float* __restrict__ delta, int64_t rows, int S, int H,
                       int hd) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) +
                      threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const float* orow = o + row * hd;
  const float* drow = dout + row * hd;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32) acc = fmaf(orow[d], drow[d], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
  if (lane == 0) {
    const int64_t h = row % H, bs = row / H;
    delta[(bs / S * H + h) * S + bs % S] = acc;
  }
}

// The rows q0 .. q0+63 of lse (as log2) and D of head (b, h), zero outside S.
__device__ __forceinline__ void load_rows(float* sL, float* sD,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ delta,
                                          int64_t bh, int q0, int S) {
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const int qi = q0 + i;
    const bool ok = qi < S;
    sL[i] = ok ? lse[bh * S + qi] * kLog2e : 0.f;
    sD[i] = ok ? delta[bh * S + qi] : 0.f;
  }
}

template <int HDP>
constexpr int dq_smem() {
  return (4 * kTile * (HDP + 4) + kTile * kLdP + 2 * kTile) * 4;
}

// dQ of one 64-query tile of head (b, h): walks the key tiles of its window.
template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
wattn_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, Geom g, Strides sq, Strides sk,
                    Strides sv) {
  constexpr int LD = HDP + 4, CG = HDP / 64;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sdO = sQ + kTile * LD;
  float* sK = sdO + kTile * LD;
  float* sV = sK + kTile * LD;
  float* sdS = sV + kTile * LD;        // [64][kLdP]
  float* sL = sdS + kTile * kLdP;
  float* sD = sL + kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * kTile, bh = blockIdx.y;
  const int b = bh / g.H, h = bh % g.H, kvh = h / (g.H / g.KV);
  const Strides so = {static_cast<int64_t>(g.S) * g.H * g.hd,
                      static_cast<int64_t>(g.H) * g.hd, g.hd};
  const float* kb = k + b * sk.b + kvh * sk.h;
  const float* vb = v + b * sv.b + kvh * sv.h;
  load_tile<HDP>(sQ, q + b * sq.b + h * sq.h, sq.s, q0, g.S, g.hd);
  load_tile<HDP>(sdO, dout + b * so.b + h * so.h, so.s, q0, g.S, g.hd);
  load_rows(sL, sD, lse, delta, bh, q0, g.S);

  const float c2 = g.scale * kLog2e;
  float acc[4][4 * CG] = {};
  const int k_lo = max(0, q0 - g.window + 1) / kTile * kTile;
  const int k_hi = min(g.S, q0 + kTile);
  for (int k0 = k_lo; k0 < k_hi; k0 += kTile) {
    __syncthreads();                   // the last tile's dS K is done
    load_tile<HDP>(sK, kb, sk.s, k0, g.S, g.hd);
    load_tile<HDP>(sV, vb, sv.s, k0, g.S, g.hd);
    __syncthreads();
    float sc[4][4] = {}, dp[4][4] = {};
    tile_abt<HDP>(sc, sQ, sK, ty, tx);
    tile_abt<HDP>(dp, sdO, sV, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 4 * ty + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = in_window(q0 + i, k0 + tx + 16 * c, g)
                            ? exp2f(fmaf(sc[r][c], c2, -sL[i])) : 0.f;
        sdS[i * kLdP + tx + 16 * c] = p * (dp[r][c] - sD[i]);
      }
    }
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < kTile; j += 4) {
      float4 s4[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) s4[r] = ld4(sdS + (4 * ty + r) * kLdP + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int cg = 0; cg < CG; ++cg) {
          const float4 k4 = ld4(sK + (j + jj) * LD + 4 * tx + 64 * cg);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float s = comp(s4[r], jj);
            acc[r][4 * cg + 0] = fmaf(s, k4.x, acc[r][4 * cg + 0]);
            acc[r][4 * cg + 1] = fmaf(s, k4.y, acc[r][4 * cg + 1]);
            acc[r][4 * cg + 2] = fmaf(s, k4.z, acc[r][4 * cg + 2]);
            acc[r][4 * cg + 3] = fmaf(s, k4.w, acc[r][4 * cg + 3]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + 4 * ty + r;
    if (qi >= g.S) continue;
    float* row = dq + ((static_cast<int64_t>(b) * g.S + qi) * g.H + h) * g.hd;
#pragma unroll
    for (int cg = 0; cg < CG; ++cg)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * tx + 64 * cg + e;
        if (d < g.hd) row[d] = acc[r][4 * cg + e] * g.scale;
      }
  }
}

template <int HDP>
constexpr int dkv_smem() {
  return (4 * kTile * (HDP + 4) + 2 * kTile * kLdP + 2 * kTile) * 4;
}

// dK and dV of one 64-key tile of kv head (b, kvh): walks its G query
// heads in order and, for each, the query tiles that can see the keys.
template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
wattn_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, Geom g,
                     Strides sq, Strides sk, Strides sv) {
  constexpr int LD = HDP + 4, CG = HDP / 64;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = sK + kTile * LD;
  float* sQ = sV + kTile * LD;
  float* sdO = sQ + kTile * LD;
  float* sP = sdO + kTile * LD;        // [64][kLdP]
  float* sdS = sP + kTile * kLdP;      // [64][kLdP]
  float* sL = sdS + kTile * kLdP;
  float* sD = sL + kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * kTile, bkv = blockIdx.y;
  const int b = bkv / g.KV, kvh = bkv % g.KV, G = g.H / g.KV;
  const Strides so = {static_cast<int64_t>(g.S) * g.H * g.hd,
                      static_cast<int64_t>(g.H) * g.hd, g.hd};
  load_tile<HDP>(sK, k + b * sk.b + kvh * sk.h, sk.s, k0, g.S, g.hd);
  load_tile<HDP>(sV, v + b * sv.b + kvh * sv.h, sv.s, k0, g.S, g.hd);

  const float c2 = g.scale * kLog2e;
  float ak[4][4 * CG] = {}, av[4][4 * CG] = {};
  const int q_hi = min(g.S, k0 + kTile + g.window - 1);
  for (int gi = 0; gi < G; ++gi) {
    const int h = kvh * G + gi;
    const int64_t bh = static_cast<int64_t>(b) * g.H + h;
    const float* qb = q + b * sq.b + h * sq.h;
    const float* ob = dout + b * so.b + h * so.h;
    for (int q0 = k0; q0 < q_hi; q0 += kTile) {
      __syncthreads();                 // the last tile's products are done
      load_tile<HDP>(sQ, qb, sq.s, q0, g.S, g.hd);
      load_tile<HDP>(sdO, ob, so.s, q0, g.S, g.hd);
      load_rows(sL, sD, lse, delta, bh, q0, g.S);
      __syncthreads();
      // score rows: queries 4 ty + r; columns: keys tx + 16 c
      float sc[4][4] = {}, dp[4][4] = {};
      tile_abt<HDP>(sc, sQ, sK, ty, tx);
      tile_abt<HDP>(dp, sdO, sV, ty, tx);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * ty + r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float p = in_window(q0 + i, k0 + tx + 16 * c, g)
                              ? exp2f(fmaf(sc[r][c], c2, -sL[i])) : 0.f;
          sP[i * kLdP + tx + 16 * c] = p;
          sdS[i * kLdP + tx + 16 * c] = p * (dp[r][c] - sD[i]);
        }
      }
      __syncthreads();
      // accumulator rows: keys 4 ty + r; columns: head dims 4 tx + 64 cg
#pragma unroll 2
      for (int i = 0; i < kTile; ++i) {
        const float4 p4 = ld4(sP + i * kLdP + 4 * ty);
        const float4 s4 = ld4(sdS + i * kLdP + 4 * ty);
#pragma unroll
        for (int cg = 0; cg < CG; ++cg) {
          const float4 o4 = ld4(sdO + i * LD + 4 * tx + 64 * cg);
          const float4 q4 = ld4(sQ + i * LD + 4 * tx + 64 * cg);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float p = comp(p4, r), s = comp(s4, r);
            av[r][4 * cg + 0] = fmaf(p, o4.x, av[r][4 * cg + 0]);
            av[r][4 * cg + 1] = fmaf(p, o4.y, av[r][4 * cg + 1]);
            av[r][4 * cg + 2] = fmaf(p, o4.z, av[r][4 * cg + 2]);
            av[r][4 * cg + 3] = fmaf(p, o4.w, av[r][4 * cg + 3]);
            ak[r][4 * cg + 0] = fmaf(s, q4.x, ak[r][4 * cg + 0]);
            ak[r][4 * cg + 1] = fmaf(s, q4.y, ak[r][4 * cg + 1]);
            ak[r][4 * cg + 2] = fmaf(s, q4.z, ak[r][4 * cg + 2]);
            ak[r][4 * cg + 3] = fmaf(s, q4.w, ak[r][4 * cg + 3]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int kj = k0 + 4 * ty + r;
    if (kj >= g.S) continue;
    const int64_t off = ((static_cast<int64_t>(b) * g.S + kj) * g.KV + kvh) * g.hd;
#pragma unroll
    for (int cg = 0; cg < CG; ++cg)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * tx + 64 * cg + e;
        if (d < g.hd) {
          dk[off + d] = ak[r][4 * cg + e] * g.scale;
          dv[off + d] = av[r][4 * cg + e];
        }
      }
  }
}

template <typename Kern>
cudaError_t allow_smem(Kern kern, int bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

bool bad_geom(int64_t B, const Geom& g) {
  return B < 1 || g.S < 1 || g.H < 1 || g.KV < 1 || g.H % g.KV != 0 ||
         g.hd < 1 || g.hd > kMaxHd || g.window < 1 || B * g.H > 65535;
}

template <int HDP>
int fwd(const float* q, const float* k, const float* v, float* o, float* lse,
        int64_t B, Geom g, Strides sq, Strides sk, Strides sv, cudaStream_t st) {
  const int smem = fwd_smem<HDP>();
  cudaError_t err = allow_smem(wattn_fwd_kernel<HDP>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((g.S + kTile - 1) / kTile, static_cast<unsigned>(B * g.H));
  wattn_fwd_kernel<HDP><<<grid, kThreads, smem, st>>>(q, k, v, o, lse, g, sq,
                                                      sk, sv);
  return static_cast<int>(cudaGetLastError());
}

template <int HDP>
int bwd(const float* q, const float* k, const float* v, const float* dout,
        const float* lse, const float* delta, float* dq, float* dk, float* dv,
        int64_t B, Geom g, Strides sq, Strides sk, Strides sv, cudaStream_t st) {
  const int s_dq = dq_smem<HDP>(), s_dkv = dkv_smem<HDP>();
  cudaError_t err = allow_smem(wattn_bwd_dq_kernel<HDP>, s_dq);
  if (err == cudaSuccess) err = allow_smem(wattn_bwd_dkv_kernel<HDP>, s_dkv);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned tiles = (g.S + kTile - 1) / kTile;
  wattn_bwd_dq_kernel<HDP><<<dim3(tiles, static_cast<unsigned>(B * g.H)),
                             kThreads, s_dq, st>>>(q, k, v, dout, lse, delta,
                                                   dq, g, sq, sk, sv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  wattn_bwd_dkv_kernel<HDP><<<dim3(tiles, static_cast<unsigned>(B * g.KV)),
                              kThreads, s_dkv, st>>>(q, k, v, dout, lse, delta,
                                                     dk, dv, g, sq, sk, sv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Forward.  q (B,S,H,hd), k and v (B,S,KV,hd) with element strides
// (q_sb, q_ss, q_sh) etc. and a contiguous head dim; o (B,S,H,hd) and lse
// (B,H,S) contiguous.  Returns cudaGetLastError() after the launch.
extern "C" int repro_window_attn_fwd(
    const float* q, const float* k, const float* v, float* o, float* lse,
    int64_t B, int64_t S, int64_t H, int64_t KV, int64_t hd, int64_t window,
    float scale, int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
    int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
    void* stream) {
  if (S > 0x7fffffffLL || window > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geom g = {static_cast<int>(S), static_cast<int>(H), static_cast<int>(KV),
                  static_cast<int>(hd), static_cast<int>(window), scale};
  if (bad_geom(B, g)) return static_cast<int>(cudaErrorInvalidValue);
  const Strides sq = {q_sb, q_ss, q_sh}, sk = {k_sb, k_ss, k_sh},
                sv = {v_sb, v_ss, v_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return hd <= 64 ? fwd<64>(q, k, v, o, lse, B, g, sq, sk, sv, st)
                  : fwd<128>(q, k, v, o, lse, B, g, sq, sk, sv, st);
}

// Backward.  q, k, v as for the forward; o, dout and dq (B,S,H,hd), dk and
// dv (B,S,KV,hd), lse and delta (B,H,S, delta a workspace) contiguous.
extern "C" int repro_window_attn_bwd(
    const float* q, const float* k, const float* v, const float* o,
    const float* lse, const float* dout, float* dq, float* dk, float* dv,
    float* delta, int64_t B, int64_t S, int64_t H, int64_t KV, int64_t hd,
    int64_t window, float scale, int64_t q_sb, int64_t q_ss, int64_t q_sh,
    int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss,
    int64_t v_sh, void* stream) {
  if (S > 0x7fffffffLL || window > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geom g = {static_cast<int>(S), static_cast<int>(H), static_cast<int>(KV),
                  static_cast<int>(hd), static_cast<int>(window), scale};
  if (bad_geom(B, g)) return static_cast<int>(cudaErrorInvalidValue);
  const Strides sq = {q_sb, q_ss, q_sh}, sk = {k_sb, k_ss, k_sh},
                sv = {v_sb, v_ss, v_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t rows = B * S * H;
  const int64_t blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  wattn_bwd_delta_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      o, dout, delta, rows, g.S, g.H, g.hd);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return hd <= 64 ? bwd<64>(q, k, v, dout, lse, delta, dq, dk, dv, B, g, sq, sk,
                            sv, st)
                  : bwd<128>(q, k, v, dout, lse, delta, dq, dk, dv, B, g, sq,
                             sk, sv, st);
}
