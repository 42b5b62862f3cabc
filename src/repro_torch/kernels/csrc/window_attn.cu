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
// forward does 4 hd FLOPs (q.k and p v) and one exp; the backward's work is
// 10 hd (dV, dP, dQ, dK and the recomputed q.k, counted once).  At
// gemma3-27b's local layer (B 2, S 4096, 32 heads of 128, window 1024:
// 234,913,792 pairs) that is 120 GFLOP forward and 301 GFLOP backward
// against 0.40 and 0.81 GB of inputs and outputs: the products bound both.
// The card computes fp32-accurate products fastest on its tensor cores in
// 3xTF32 (below): 495 / 3 = 165 TFLOP/s against 67 TFLOP/s on the CUDA
// cores, so the bounds are 0.73 ms forward and 1.82 ms backward.
//
// Forward (tensor cores, 3xTF32), FlashAttention-2 form.  A block walks the
// 64-key tiles one 64-query tile's windows reach, as the TPU grid's span
// did.  It owns that tile of one query head (4 warps), or of two query heads
// 2p and 2p + 1 of one kv head (8 warps, gemma3: 32 heads over 16) that
// share each K and V tile; the second only where H / KV is even and that
// grid still gives every SM a block.  Warp w computes rows 16 (w % 4) .. +15
// of head slot w / 4 against all 64 keys of a key tile, so a row's max and
// sum are lane-local plus two shuffles over the 4 lanes tq of its group.
//  * S = Q K^T in 3xTF32 mma.sync (below) into 8 n-tiles of accumulators,
//    over ceil(hd / 8) k steps (2 at the local check's hd 16).  Online
//    softmax in base 2 on the accumulators, exps on the special-function
//    unit (ex2.approx.ftz), scores scaled by log2(e) / sqrt(hd) in the
//    exp's FMA.
//  * P stays in registers.  Under the k relabelling below, the C fragment
//    (d0, d1, d2, d3) of score n-tile j is exactly the A fragment (d0, d2,
//    d1, d3) of k step j of P V, so P is split and fed to the MMA where it
//    is: no shared P tile, no barrier between the softmax and P V.
//  * K and V have a cp.async buffer each, so loads overlap the MMAs: V_j
//    lands while S_j computes and K_{j+1} while P_j V_j does, one wait and
//    one barrier a half step.
//  * Two-head blocks split each landed K and V tile into its TF32 parts
//    once, by the whole block, into a hi and a lo tile, so a warp's
//    fragments are plain loads where 8 warps splitting their own would
//    split every element 8 times; sharing K and V halves the staging and
//    splitting a query row costs, and gives an SM 8 warps where 192 KB of
//    shared memory admit one block.  A one-head block splits in its
//    fragments and needs 96 KB, so two fit an SM: it walks few key tiles
//    (short sequences), where a split pass would sit on its critical path.
//    tools/wattn_fwd_alternatives.py times each choice against its removal
//    (PERF.md section 6).
//  * Masks only where a tile straddles the diagonal or the window's lower
//    edge (2 of the 17 key tiles a query tile walks at gemma3's shape), a
//    test uniform over the block; rows with no key yet keep the guard
//    against exp2(-inf + inf).  A warp whose rows see no key of a tile
//    skips its MMAs; on an edge tile P V also skips the 8-key steps none
//    of its rows sees.  The MMA loops have no other branch: a branch per
//    n-tile serialises each accumulator's three dependent MMAs, so the
//    n-tiles of O between hd and the route's width are computed on the
//    zero-filled columns rather than skipped.  So the forward has a width
//    of 32 besides the backward's 64 and 128: at hd 16 (the local check)
//    or 27 it halves the P V MMAs and the staged columns of 64.
//  * No atomics, so two runs give the same bits.
//
// Backward (tensor cores, 3xTF32), FlashAttention-2 form, P recomputed from
// q, k and lse: D_i = dO_i.O_i (wattn_bwd_delta_kernel), dS = P o (dO V^T -
// D), dQ = scale dS K (wattn_bwd_dq_kernel, over query tiles) and dV = P^T
// dO, dK = scale dS^T Q (wattn_bwd_dkv_kernel, over key tiles; it sums the
// G query heads of its kv head and their query tiles in a fixed order).  No
// atomics: two runs give the same bits.  Both kernels recompute q.k and
// dO.v, so they issue 14 hd FLOPs per pair against the work's 10 hd.
//  * Every product is a warp-level mma.sync.m16n8k8 with TF32 operands and
//    fp32 accumulation.  Each fp32 operand x is split as hi = cvt.rna.tf32
//    (x) and lo = cvt.rna.tf32(x - hi), and acc += a_lo b_hi + a_hi b_lo +
//    a_hi b_hi.  hi carries x's leading 11 significant bits and lo the next
//    11, so hi + lo is x within about 2^-22 |x|; the dropped a_lo b_lo and
//    that residue cost about 2^-21 of each product, the size of fp32's own
//    rounding (2^-24) amplified by a few ulps, where plain TF32 keeps only
//    2^-11.  (PyTorch's memory-efficient attention takes fp32 the same way,
//    cutlass::arch::OpMultiplyAddFastF32.)
//  * A block of 8 warps owns one 64-row tile; a warp computes a 16 x 32
//    score tile (S and dP, fused in one k loop) and a 16 x hd/2 output tile.
//    Scores stay in MMA accumulators through the softmax; P and dS pass to
//    the output products (where they are A operands) through a 64 x 64
//    shared tile.  The streamed tiles (K and V for dQ; Q, dO, lse and D for
//    dK/dV) are double-buffered by cp.async, so the next tile's loads
//    overlap this tile's MMAs; the block's own tiles load once.
//  * Shared memory at hd 128: 213,504 bytes (dQ) and 230,400 (dK/dV), one
//    block of 8 warps per SM; the MMAs' issue rate and the operand splits
//    on the CUDA cores bound it, not memory.
//
// Forward for bf16 operands, the TPU kernel's own arithmetic at bf16: Q
// K^T as one-pass bf16 products with fp32 accumulation, P = exp(s - m)
// rounded to bf16 before P V (again bf16 products, fp32 accumulation), the
// online softmax's max and sum and the log-sum-exp in fp32 (the sum over
// the unrounded P, as the TPU kernel's l), O written in bf16 (the TPU
// wrapper's cast to q.dtype).  It has two routes.  Where TMA can address
// the operands and hd is 64 or 128 (gemma3-27b's layer, every aligned
// model layout), wattn_fwd_bf16_tma_kernel in window_attn_tma.cu: wgmma
// fed by TMA in FlashAttention-3's form (a producer warpgroup and two
// consumer warpgroups; design and bound in that file's notes).  Every
// other bf16 call (hd 16, 27, 32; unaligned views) takes
// wattn_fwd_bf16_kernel here, on mma.sync, which reaches about a fifth of
// the card's bf16 tensor-core rate (0.17 of its bound at gemma3's layer,
// PERF.md): a block of 4 warps owns one 64-query tile of one head; its
// Q, K and V tiles stage in shared memory as bf16 ([64][HDP + 8]: rows
// padded by 16 bytes, so the 32-bit fragment loads of 8 rows x 4 columns
// fall in 32 banks), half the fp32 route's bytes; K and V are
// double-buffered by cp.async as there (V_j lands while S_j computes, K_j+1
// while P_j V_j does).  Every product is mma.sync.m16n8k16 bf16 -> fp32.  A
// warp keeps its Q fragments in registers for the whole walk; P's A
// fragments are the score accumulators of two n-tiles, packed to bf16 in
// registers; V's B fragments come from ldmatrix.trans.  The backward takes
// bf16 inputs through the fp32 kernels:
// the wrapper widens the saved operands (the TPU kernel had no backward).
#include <cstdint>
#include <initializer_list>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kTile = 64;          // queries or keys per tile
constexpr int kThreads = 256;
constexpr int kMaxHd = 128;
constexpr unsigned kFull = 0xffffffffu;

struct Strides {
  int64_t b, s, h;
};

struct Geom {
  int S, H, KV, hd, window;
  float scale;
};

__device__ __forceinline__ bool in_window(int qi, int kj, const Geom& g) {
  return qi < g.S && kj < g.S && kj <= qi && kj > qi - g.window;
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

// ---- forward and backward on the tensor cores, 3xTF32 --------------------
//
// Backward: each block has 8 warps; warp w = 4 wn + wm.  Score tiles (64 x
// 64): warp rows 16 wm .. +15, columns 32 wn .. +31 (4 MMA n-tiles of 8).
// Output tiles (64 x HDP): rows 16 wm .. +15, columns wn HDP/2 .. +HDP/2.
// Forward: warp w's rows 16 (w % 4) .. +15, all 64 columns.  Lane
// (gq, tq) = (lane / 4, lane % 4) holds the m16n8k8 fragments: A rows gq
// and gq + 8, B column gq, C rows gq and gq + 8 at columns 2 tq and
// 2 tq + 1.  The hardware's k index tq (tq + 4) is fed column 2 tq
// (2 tq + 1) of each 8-wide k step, in A and in B alike: a relabelling of k
// that leaves the sum unchanged and lets one 8-byte load fetch both.
//
// Staged tiles are [rows][HDP] (score tiles [64][64]; HDP 32, 64 or 128)
// with no padding; the 4-float granule c / 4 of row r sits at granule
// (c / 4) ^ swz(r) / 4.  That keeps the 8-byte fragment loads (rows gq,
// columns 2 tq), the column-wise B loads (rows 2 tq + e, column gq), the
// 8-byte score stores and the 16-byte cp.async writes free of bank
// conflicts.

__device__ __forceinline__ int swz(int r) {
  return ((((r & 3) << 1) ^ (((r >> 2) & 1) * 3))) << 2;
}

// A fragment at rows r0 + gq, r0 + gq + 8 (r0 % 8 == 0) of a [rows][LD]
// tile; ``row`` points at row r0 + gq, ``col`` = (8 kk + 2 tq) ^ swz(gq).
template <int LD>
__device__ __forceinline__ void frag_a(FragA& f, const float* row, int col) {
  const float2 u = *reinterpret_cast<const float2*>(row + col);
  const float2 w = *reinterpret_cast<const float2*>(row + 8 * LD + col);
  split(u.x, f.hi[0], f.lo[0]);
  split(w.x, f.hi[1], f.lo[1]);
  split(u.y, f.hi[2], f.lo[2]);
  split(w.y, f.hi[3], f.lo[3]);
}

// B fragment of a product A B^T: row n0 + gq of the [n][k] tile
__device__ __forceinline__ void frag_bt(FragB& f, const float* row, int col) {
  const float2 u = *reinterpret_cast<const float2*>(row + col);
  split(u.x, f.hi[0], f.lo[0]);
  split(u.y, f.hi[1], f.lo[1]);
}

// B fragment of a product A B: rows 8 kk + 2 tq and 8 kk + 2 tq + 1 of the
// [k][n] tile at column n = n0 + gq; ``r0``, ``r1`` point at those rows and
// x0, x1 are their swizzles.
__device__ __forceinline__ void frag_b(FragB& f, const float* r0,
                                       const float* r1, int n, int x0, int x1) {
  split(r0[n ^ x0], f.hi[0], f.lo[0]);
  split(r1[n ^ x1], f.hi[1], f.lo[1]);
}

// Rows t0 .. t0+63 of one head's (S, hd) slice (row stride ``ss``) into the
// swizzled dst[64][HDP] by cp.async from a block of NT threads, zero
// outside S and hd.  ``vec``: the slice's base and row stride are 16-byte
// aligned and hd % 4 == 0.
template <int HDP, int NT = kThreads>
__device__ __forceinline__ void stage_tile(float* dst,
                                           const float* __restrict__ src,
                                           int64_t ss, int t0, int S, int hd,
                                           bool vec) {
  if (vec) {
    constexpr int kG = HDP / 4;
#pragma unroll
    for (int i = 0; i < kTile * kG / NT; ++i) {
      const int idx = threadIdx.x + i * NT;
      const int r = idx / kG, c = (idx % kG) * 4, t = t0 + r;
      const bool ok = t < S && c < hd;
      cp_async16(dst + r * HDP + (c ^ swz(r)),
                 ok ? src + static_cast<int64_t>(t) * ss + c : src, ok);
    }
  } else {
#pragma unroll 4
    for (int idx = threadIdx.x; idx < kTile * HDP; idx += NT) {
      const int r = idx / HDP, c = idx % HDP, t = t0 + r;
      const bool ok = t < S && c < hd;
      cp_async4(dst + r * HDP + (c ^ swz(r)),
                ok ? src + static_cast<int64_t>(t) * ss + c : src, ok);
    }
  }
}

// lse (as read) and D of rows q0 .. q0+63 of head bh, zero outside S
__device__ __forceinline__ void stage_rows(float* sL, float* sD,
                                           const float* __restrict__ lse,
                                           const float* __restrict__ delta,
                                           int64_t bh, int q0, int S) {
  if (threadIdx.x < kTile) {
    const int qi = q0 + threadIdx.x;
    const bool ok = qi < S;
    cp_async4(sL + threadIdx.x, ok ? lse + bh * S + qi : lse, ok);
    cp_async4(sD + threadIdx.x, ok ? delta + bh * S + qi : delta, ok);
  }
}

// The staged tile ``hi`` split into its TF32 parts: hi in place, lo beside
// it at the same (swizzled) places, by a block of NT threads.
template <int HDP, int NT>
__device__ __forceinline__ void split_tile(float* hi, float* lo) {
#pragma unroll 4
  for (int i = 4 * threadIdx.x; i < kTile * HDP; i += 4 * NT) {
    const float4 x = *reinterpret_cast<const float4*>(hi + i);
    uint4 h, l;
    split(x.x, h.x, l.x);
    split(x.y, h.y, l.y);
    split(x.z, h.z, l.z);
    split(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + i) = h;
    *reinterpret_cast<uint4*>(lo + i) = l;
  }
}

// frag_bt and frag_b from split tiles: ``hi`` and ``lo`` point at the same
// row of the two parts.
__device__ __forceinline__ void frag_bt_split(FragB& f, const float* hi,
                                              const float* lo, int col) {
  const uint2 u = *reinterpret_cast<const uint2*>(hi + col);
  const uint2 w = *reinterpret_cast<const uint2*>(lo + col);
  f.hi[0] = u.x;
  f.hi[1] = u.y;
  f.lo[0] = w.x;
  f.lo[1] = w.y;
}

template <int LD>
__device__ __forceinline__ void frag_b_split(FragB& f, const float* hi,
                                             const float* lo, int n, int x0,
                                             int x1) {
  f.hi[0] = __float_as_uint(hi[n ^ x0]);
  f.hi[1] = __float_as_uint(hi[LD + (n ^ x1)]);
  f.lo[0] = __float_as_uint(lo[n ^ x0]);
  f.lo[1] = __float_as_uint(lo[LD + (n ^ x1)]);
}

// stage_tile for the forward's K and V tiles: with ``vec``, one 64-bit
// pointer a thread and 32-bit row steps, so the loop over key tiles keeps
// fewer addresses live (stage_tile's hoisted 64-bit ones spilled at HDP
// 128).
template <int HDP, int NT>
__device__ __forceinline__ void stage_kv(float* dst,
                                         const float* __restrict__ src,
                                         int64_t ss, int t0, int S, int hd,
                                         bool vec) {
  if (!vec) {
    stage_tile<HDP, NT>(dst, src, ss, t0, S, hd, false);
    return;
  }
  constexpr int kG = HDP / 4, kRows = NT / kG;
  const int r0 = threadIdx.x / kG, c = (threadIdx.x % kG) * 4;
  const float* p = src + static_cast<int64_t>(t0 + r0) * ss + c;
  const int step = static_cast<int>(kRows * ss);   // vec_ok bounds ss
#pragma unroll
  for (int i = 0; i < kTile / kRows; ++i) {
    const int r = r0 + i * kRows;
    const bool ok = t0 + r < S && c < hd;
    cp_async16(dst + r * HDP + (c ^ swz(r)), ok ? p + i * step : src, ok);
  }
}

// O += P V over one key tile: k step j (keys 8 j .. 8 j + 7) takes its A
// fragment from score n-tile j's C fragment (d0, d1, d2, d3) as (d0, d2,
// d1, d3).  EDGE (a tile that straddles the diagonal or the window's lower
// edge): only k steps j_lo .. j_hi - 1, the keys some row of the warp sees.
// SPLIT: V's TF32 parts are the tiles sV and sVl; else sV is V.
template <int HDP, bool SPLIT, bool EDGE>
__device__ __forceinline__ void pv_tile(float (&acc)[HDP / 8][4],
                                        const float (&s)[8][4],
                                        const float* sV, const float* sVl,
                                        int j_lo, int j_hi) {
  const int gq = (threadIdx.x & 31) >> 2, tq = threadIdx.x & 3;
  const int x0 = swz(2 * tq), x1 = swz(2 * tq + 1);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (EDGE && (j < j_lo || j >= j_hi)) continue;
    FragA fa;
    split(s[j][0], fa.hi[0], fa.lo[0]);
    split(s[j][2], fa.hi[1], fa.lo[1]);
    split(s[j][1], fa.hi[2], fa.lo[2]);
    split(s[j][3], fa.hi[3], fa.lo[3]);
    const int r = (8 * j + 2 * tq) * HDP;
#pragma unroll
    for (int nt = 0; nt < HDP / 8; ++nt) {
      FragB fb;
      if constexpr (SPLIT)
        frag_b_split<HDP>(fb, sV + r, sVl + r, 8 * nt + gq, x0, x1);
      else
        frag_b(fb, sV + r, sV + r + HDP, 8 * nt + gq, x0, x1);
      mma3(acc[nt], fa, fb);
    }
  }
}

template <int HDP, int SLOTS, bool SPLIT>
constexpr int fwd_smem() { return ((SPLIT ? 4 : 2) + SLOTS) * kTile * HDP * 4; }

// O and lse of one 64-query tile of SLOTS query heads of one kv head (heads
// SLOTS p .. SLOTS p + SLOTS - 1; SLOTS divides H / KV), which share its K
// and V tiles.  Walks the key tiles of the tile's windows; warp w computes
// rows 16 (w % 4) .. +15 of head h0 + w / 4 against all 64 keys of a key
// tile.  SPLIT: each landed K and V tile is split into its TF32 parts once.
template <int HDP, int SLOTS, bool SPLIT>
__global__ void __launch_bounds__(128 * SLOTS, 1)
wattn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, Geom g, Strides sq, Strides sk,
                 Strides sv, bool vec) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kParts = SPLIT ? 2 : 1;
  float* sK = smem;                          // [64][HDP]: K (SPLIT: K hi)
  float* sKl = sK + kTile * HDP;             // [64][HDP]: K lo (SPLIT)
  float* sV = sK + kParts * kTile * HDP;     // [64][HDP]: V (SPLIT: V hi)
  float* sVl = sV + kTile * HDP;             // [64][HDP]: V lo (SPLIT)
  float* sQ = sV + kParts * kTile * HDP;     // [SLOTS][64][HDP]
  constexpr int NT = 128 * SLOTS;
  const int warp = threadIdx.x >> 5, slot = warp >> 2;
  const int gq = (threadIdx.x & 31) >> 2, tq = threadIdx.x & 3;
  const int b = blockIdx.y / (g.H / SLOTS);
  const int h0 = SLOTS * (blockIdx.y % (g.H / SLOTS)), h = h0 + slot;
  const int q0 = blockIdx.x * kTile;
  const int kvh = h0 / (g.H / g.KV);
  const float* kb = k + b * sk.b + kvh * sk.h;
  const float* vb = v + b * sv.b + kvh * sv.h;
  const int k_lo = max(0, q0 - g.window + 1) / kTile * kTile;
  const int k_hi = min(g.S, q0 + kTile);
  for (int s = 0; s < SLOTS; ++s)
    stage_tile<HDP, NT>(sQ + s * kTile * HDP, q + b * sq.b + (h0 + s) * sq.h,
                        sq.s, q0, g.S, g.hd, vec);
  stage_kv<HDP, NT>(sK, kb, sk.s, k_lo, g.S, g.hd, vec);
  cp_async_commit();

  const float c2 = g.scale * kLog2e;
  const int ks = (g.hd + 7) / 8;
  const int qw = q0 + 16 * (warp & 3);       // the warp's first row
  const int qa = qw + gq;                    // this lane's rows: qa, qa + 8
  // the keys some row of the warp sees: kw_lo <= kj <= kw_hi
  const int kw_lo = qw - g.window + 1, kw_hi = min(qw + 15, g.S - 1);
  const float* qrow = sQ + (slot * kTile + 16 * (warp & 3) + gq) * HDP;
  const int xq = swz(gq);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[HDP / 8][4] = {};
  for (int k0 = k_lo; k0 < k_hi; k0 += kTile) {
    cp_async_wait_all();
    __syncthreads();           // K_j landed; every warp's P V of j - 1 done
    stage_kv<HDP, NT>(sV, vb, sv.s, k0, g.S, g.hd, vec);
    cp_async_commit();
    if constexpr (SPLIT) {
      split_tile<HDP, NT>(sK, sKl);
      __syncthreads();         // K_j split
    }
    const bool sees = qw < g.S && kw_lo <= k0 + kTile - 1 && kw_hi >= k0;
    // every (row, key) pair of the query tile in the window: no mask
    const bool full = k0 + kTile - 1 <= q0 && k0 + g.window > q0 + kTile - 1;
    float s[8][4] = {};
    if (sees) {
      const float* kr = sK + gq * HDP;
      const float* krl = sKl + gq * HDP;
#pragma unroll 2
      for (int kk = 0; kk < ks; ++kk) {
        const int col = (8 * kk + 2 * tq) ^ xq;
        FragA fa;
        frag_a<HDP>(fa, qrow, col);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          FragB fb;
          if constexpr (SPLIT)
            frag_bt_split(fb, kr + 8 * j * HDP, krl + 8 * j * HDP, col);
          else
            frag_bt(fb, kr + 8 * j * HDP, col);
          mma3(s[j], fa, fb);
        }
      }
      // online softmax in base 2: row qa + 8 hr holds s[j][2 hr + e] at key
      // k0 + 8 j + 2 tq + e; scores scaled by c2 inside the exp's FMA
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (!full &&
              !in_window(qa + 8 * (e >> 1), k0 + 8 * j + 2 * tq + (e & 1), g))
            s[j][e] = -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
      float corr[2];
      bool none[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(kFull, mx[hr], 1));
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(kFull, mx[hr], 2));
        const float mn = fmaxf(m[hr], mx[hr] * c2);
        none[hr] = mn == -INFINITY;          // no key of this row yet
        corr[hr] = none[hr] ? 1.f : ex2(m[hr] - mn);
        m[hr] = mn;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hr = e >> 1;
          s[j][e] = none[hr] ? 0.f : ex2(fmaf(s[j][e], c2, -m[hr]));
          rs[hr] += s[j][e];
        }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        rs[hr] += __shfl_xor_sync(kFull, rs[hr], 1);
        rs[hr] += __shfl_xor_sync(kFull, rs[hr], 2);
        l[hr] = fmaf(l[hr], corr[hr], rs[hr]);
      }
#pragma unroll
      for (int nt = 0; nt < HDP / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] *= corr[e >> 1];
    }
    cp_async_wait_all();
    __syncthreads();           // V_j landed; every warp's Q K_j^T is done
    if (k0 + kTile < k_hi) {
      stage_kv<HDP, NT>(sK, kb, sk.s, k0 + kTile, g.S, g.hd, vec);
      cp_async_commit();
    }
    if constexpr (SPLIT) {
      split_tile<HDP, NT>(sV, sVl);
      __syncthreads();         // V_j split
    }
    if (sees && full) {
      pv_tile<HDP, SPLIT, false>(acc, s, sV, sVl, 0, 8);
    } else if (sees) {
      pv_tile<HDP, SPLIT, true>(acc, s, sV, sVl, max(0, kw_lo - k0) / 8,
                                min(8, (kw_hi - k0) / 8 + 1));
    }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qi = qa + 8 * hr;
    if (qi >= g.S) continue;
    const float inv = 1.f / l[hr];
    float* orow = o + ((static_cast<int64_t>(b) * g.S + qi) * g.H + h) * g.hd;
#pragma unroll
    for (int nt = 0; nt < HDP / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * nt + 2 * tq + e;
        if (d < g.hd) orow[d] = acc[nt][2 * hr + e] * inv;
      }
    if (tq == 0)
      lse[(static_cast<int64_t>(b) * g.H + h) * g.S + qi] =
          (m[hr] + log2f(l[hr])) * kLn2;
  }
}

// The two score products of one warp, fused in one k loop for eight
// independent accumulator chains: s1 += A1 B1^T and s2 += A2 B2^T over the
// first ``ks`` k steps, A rows ``ra`` .. +15 and B rows ``rb`` .. +31 of
// [64][HDP] tiles with k along the row.
// ---- forward for bf16 operands, one-pass bf16 mma.sync ---------------------
//
// m16n8k16 bf16 fragments, lane (gq, tq): A a0 = (row gq, columns 2 tq,
// 2 tq + 1), a1 = (row gq + 8, the same), a2 and a3 the same at columns
// + 8; B b0 = (rows 2 tq, 2 tq + 1, column gq), b1 at rows + 8; C as for
// m16n8k8.  Two 16-bit values a register, the lower column in the low half.

constexpr int kBfPad = 8;          // bf16 elements padding a staged row

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Four 8 x 8 bf16 tiles, transposed: lane l gives the address of row l % 8
// of tile l / 8 and receives, of tile i, rows 2 tq and 2 tq + 1 of
// column gq in r[i] (a B fragment half of an [k][n] tile).
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// Rows t0 .. t0+63 of one head's bf16 (S, hd) slice (row stride ``ss``)
// into dst[64][HDP + kBfPad] by a block of 128 threads, zero outside S and
// hd: 16-byte cp.async where ``vec`` (hd % 8 == 0, 16-byte aligned rows),
// else a plain load and store an element.
template <int HDP>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst,
                                           const __nv_bfloat16* __restrict__ src,
                                           int64_t ss, int t0, int S, int hd,
                                           bool vec) {
  constexpr int LD = HDP + kBfPad;
  if (vec) {
    constexpr int kG = HDP / 8;
#pragma unroll 4
    for (int idx = threadIdx.x; idx < kTile * kG; idx += 128) {
      const int r = idx / kG, c = (idx % kG) * 8, t = t0 + r;
      const bool ok = t < S && c < hd;
      cp_async16(dst + r * LD + c,
                 ok ? src + static_cast<int64_t>(t) * ss + c : src, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < kTile * HDP; idx += 128) {
      const int r = idx / HDP, c = idx % HDP, t = t0 + r;
      dst[r * LD + c] = t < S && c < hd ? src[static_cast<int64_t>(t) * ss + c]
                                        : __float2bfloat16_rn(0.f);
    }
  }
}

template <int HDP>
constexpr int fwd_bf16_smem() { return 3 * kTile * (HDP + kBfPad) * 2; }

// O (bf16) and lse of one 64-query tile of query head blockIdx.y % H: warp
// w computes rows 16 w .. +15 against all 64 keys of each key tile its
// windows reach.  The walk, masks and skips are wattn_fwd_kernel's.
template <int HDP>
__global__ void __launch_bounds__(128)
wattn_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                      Geom g, Strides sq, Strides sk, Strides sv, bool vec) {
  constexpr int LD = HDP + kBfPad, KS = HDP / 16, NT = HDP / 8;
  extern __shared__ __align__(16) float smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);   // [64][LD]
  __nv_bfloat16* sK = sQ + kTile * LD;                          // [64][LD]
  __nv_bfloat16* sV = sK + kTile * LD;                          // [64][LD]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int b = blockIdx.y / g.H, h = blockIdx.y % g.H;
  const int q0 = blockIdx.x * kTile;
  const int kvh = h / (g.H / g.KV);
  const __nv_bfloat16* kb = k + b * sk.b + kvh * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + kvh * sv.h;
  const int k_lo = max(0, q0 - g.window + 1) / kTile * kTile;
  const int k_hi = min(g.S, q0 + kTile);
  stage_bf16<HDP>(sQ, q + b * sq.b + h * sq.h, sq.s, q0, g.S, g.hd, vec);
  stage_bf16<HDP>(sK, kb, sk.s, k_lo, g.S, g.hd, vec);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();             // Q and K_0 landed

  const float c2 = g.scale * kLog2e;
  const int qw = q0 + 16 * warp;             // the warp's first row
  const int qa = qw + gq;                    // this lane's rows: qa, qa + 8
  const int kw_lo = qw - g.window + 1, kw_hi = min(qw + 15, g.S - 1);
  // the warp's Q fragments, held for the whole walk
  uint32_t qf[KS][4];
  {
    const __nv_bfloat16* qr = sQ + (16 * warp + gq) * LD + 2 * tq;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      qf[kk][0] = ld_u32(qr + 16 * kk);
      qf[kk][1] = ld_u32(qr + 8 * LD + 16 * kk);
      qf[kk][2] = ld_u32(qr + 16 * kk + 8);
      qf[kk][3] = ld_u32(qr + 8 * LD + 16 * kk + 8);
    }
  }
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[NT][4] = {};
  for (int k0 = k_lo; k0 < k_hi; k0 += kTile) {
    cp_async_wait_all();
    __syncthreads();           // K_j landed; every warp's P V of j - 1 done
    stage_bf16<HDP>(sV, vb, sv.s, k0, g.S, g.hd, vec);
    cp_async_commit();
    const bool sees = qw < g.S && kw_lo <= k0 + kTile - 1 && kw_hi >= k0;
    const bool full = k0 + kTile - 1 <= q0 && k0 + g.window > q0 + kTile - 1;
    float s[8][4] = {};
    if (sees) {
      const __nv_bfloat16* kr = sK + gq * LD + 2 * tq;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          mma_bf16(s[j], qf[kk], ld_u32(kr + 8 * j * LD + 16 * kk),
                   ld_u32(kr + 8 * j * LD + 16 * kk + 8));
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (!full &&
              !in_window(qa + 8 * (e >> 1), k0 + 8 * j + 2 * tq + (e & 1), g))
            s[j][e] = -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
      float corr[2];
      bool none[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(kFull, mx[hr], 1));
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(kFull, mx[hr], 2));
        const float mn = fmaxf(m[hr], mx[hr] * c2);
        none[hr] = mn == -INFINITY;          // no key of this row yet
        corr[hr] = none[hr] ? 1.f : ex2(m[hr] - mn);
        m[hr] = mn;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hr = e >> 1;
          s[j][e] = none[hr] ? 0.f : ex2(fmaf(s[j][e], c2, -m[hr]));
          rs[hr] += s[j][e];
        }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        rs[hr] += __shfl_xor_sync(kFull, rs[hr], 1);
        rs[hr] += __shfl_xor_sync(kFull, rs[hr], 2);
        l[hr] = fmaf(l[hr], corr[hr], rs[hr]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] *= corr[e >> 1];
    }
    cp_async_wait_all();
    __syncthreads();           // V_j landed; every warp's Q K_j^T is done
    if (k0 + kTile < k_hi) {
      stage_bf16<HDP>(sK, kb, sk.s, k0 + kTile, g.S, g.hd, vec);
      cp_async_commit();
    }
    if (sees) {
      // k step kk (keys 16 kk .. +15): P's A fragment is score n-tiles 2 kk
      // and 2 kk + 1, rounded to bf16
      const __nv_bfloat16* vr =
          sV + (8 * ((lane >> 3) & 1) + (lane & 7)) * LD + 8 * (lane >> 4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int nt = 0; nt < NT; nt += 2) {
          uint32_t bv[4];
          ldsm_x4_trans(bv, vr + 16 * kk * LD + 8 * nt);
          mma_bf16(acc[nt], pa, bv[0], bv[1]);
          mma_bf16(acc[nt + 1], pa, bv[2], bv[3]);
        }
      }
    }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qi = qa + 8 * hr;
    if (qi >= g.S) continue;
    const float inv = 1.f / l[hr];
    __nv_bfloat16* orow =
        o + ((static_cast<int64_t>(b) * g.S + qi) * g.H + h) * g.hd;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * nt + 2 * tq + e;
        if (d < g.hd) orow[d] = __float2bfloat16_rn(acc[nt][2 * hr + e] * inv);
      }
    if (tq == 0)
      lse[(static_cast<int64_t>(b) * g.H + h) * g.S + qi] =
          (m[hr] + log2f(l[hr])) * kLn2;
  }
}

template <int HDP>
__device__ __forceinline__ void scores(float (&s1)[4][4], float (&s2)[4][4],
                                       const float* A1, const float* B1,
                                       const float* A2, const float* B2,
                                       int ra, int rb, int ks) {
  const int gq = (threadIdx.x & 31) >> 2, tq = threadIdx.x & 3;
  const int x = swz(gq);
  const float* a1 = A1 + (ra + gq) * HDP;
  const float* a2 = A2 + (ra + gq) * HDP;
  const float* b1 = B1 + (rb + gq) * HDP;
  const float* b2 = B2 + (rb + gq) * HDP;
#pragma unroll 2
  for (int kk = 0; kk < ks; ++kk) {
    const int col = (8 * kk + 2 * tq) ^ x;
    FragA f1, f2;
    frag_a<HDP>(f1, a1, col);
    frag_a<HDP>(f2, a2, col);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      FragB g1, g2;
      frag_bt(g1, b1 + 8 * j * HDP, col);
      frag_bt(g2, b2 + 8 * j * HDP, col);
      mma3(s1[j], f1, g1);
      mma3(s2[j], f2, g2);
    }
  }
}

// acc[2][NT] += A B over k = 0 .. 63: A rows ``ra`` .. +31 (two m-tiles)
// of a [64][64] score tile (k along the row), B a [64][LDB] tile (k down
// the column), columns ``cb`` .. (NT n-tiles of 8; those at or past ``hd``
// are skipped).
template <int NT, int LDB>
__device__ __forceinline__ void prod_ab(float (&acc)[2][NT][4], const float* A,
                                        int ra, const float* B, int cb,
                                        int hd) {
  const int gq = (threadIdx.x & 31) >> 2, tq = threadIdx.x & 3;
  const int x = swz(gq), x0 = swz(2 * tq), x1 = swz(2 * tq + 1);
  const float* a = A + (ra + gq) * kTile;
#pragma unroll 4
  for (int kk = 0; kk < kTile / 8; ++kk) {
    const int col = (8 * kk + 2 * tq) ^ x;
    const float* b0 = B + (8 * kk + 2 * tq) * LDB;
    FragA f[2];
    frag_a<kTile>(f[0], a, col);
    frag_a<kTile>(f[1], a + 16 * kTile, col);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = cb + 8 * j;
      if (c >= hd) continue;
      FragB fb;
      frag_b(fb, b0, b0 + LDB, c + gq, x0, x1);
      mma3(acc[0][j], f[0], fb);
      mma3(acc[1][j], f[1], fb);
    }
  }
}

template <int HDP>
constexpr int dq_smem() {
  return (6 * kTile * HDP + kTile * kTile + 2 * kTile) * 4;
}

// dQ of one 64-query tile of head (b, h): walks the key tiles of its
// window, K and V double-buffered by cp.async.  Warp w computes S = Q K^T
// and dP = dO V^T on rows 16 (w % 4) .. +15, columns 32 (w / 4) .. +31,
// then dS = P o (dP - D) into a shared tile; then dQ += dS K (rows 32 (w %
// 2) .. +31, columns HDP/4 (w / 2) ..), and dQ = scale dQ at the end.
template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
wattn_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, Geom g, Strides sq, Strides sk,
                    Strides sv, bool vec) {
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                          // [64][HDP]
  float* sdO = sQ + kTile * HDP;             // [64][HDP]
  float* sK = sdO + kTile * HDP;             // [2][64][HDP]
  float* sV = sK + 2 * kTile * HDP;          // [2][64][HDP]
  float* sdS = sV + 2 * kTile * HDP;         // [64][64]
  float* sL = sdS + kTile * kTile;           // [64]
  float* sD = sL + kTile;                    // [64]
  const int warp = threadIdx.x >> 5, wm = warp & 3, wn = warp >> 2;
  const int gq = (threadIdx.x & 31) >> 2, tq = threadIdx.x & 3;
  const int q0 = blockIdx.x * kTile, bh = blockIdx.y;
  const int b = bh / g.H, h = bh % g.H, kvh = h / (g.H / g.KV);
  const Strides so = {static_cast<int64_t>(g.S) * g.H * g.hd,
                      static_cast<int64_t>(g.H) * g.hd, g.hd};
  const float* kb = k + b * sk.b + kvh * sk.h;
  const float* vb = v + b * sv.b + kvh * sv.h;
  const int k_lo = max(0, q0 - g.window + 1) / kTile * kTile;
  const int k_hi = min(g.S, q0 + kTile);
  stage_tile<HDP>(sQ, q + b * sq.b + h * sq.h, sq.s, q0, g.S, g.hd, vec);
  stage_tile<HDP>(sdO, dout + b * so.b + h * so.h, so.s, q0, g.S, g.hd, vec);
  stage_rows(sL, sD, lse, delta, bh, q0, g.S);
  stage_tile<HDP>(sK, kb, sk.s, k_lo, g.S, g.hd, vec);
  stage_tile<HDP>(sV, vb, sv.s, k_lo, g.S, g.hd, vec);
  cp_async_commit();

  const float c2 = g.scale * kLog2e;
  const int ks = (g.hd + 7) / 8;
  float acc[2][HDP / 32][4] = {};
  for (int it = 0, k0 = k_lo; k0 < k_hi; ++it, k0 += kTile) {
    cp_async_wait_all();
    __syncthreads();           // tile it landed; tile it-1's dS K is done
    if (k0 + kTile < k_hi) {
      const int nx = ((it + 1) & 1) * kTile * HDP;
      stage_tile<HDP>(sK + nx, kb, sk.s, k0 + kTile, g.S, g.hd, vec);
      stage_tile<HDP>(sV + nx, vb, sv.s, k0 + kTile, g.S, g.hd, vec);
      cp_async_commit();
    }
    const float* cK = sK + (it & 1) * kTile * HDP;
    const float* cV = sV + (it & 1) * kTile * HDP;
    float sc[4][4] = {}, dp[4][4] = {};
    scores<HDP>(sc, dp, sQ, cK, sdO, cV, 16 * wm, 32 * wn, ks);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int i = 16 * wm + gq + 8 * hr;
      const float l2 = sL[i] * kLog2e, di = sD[i];
      float* row = sdS + i * kTile;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 32 * wn + 8 * j + 2 * tq;
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = in_window(q0 + i, k0 + c + e, g)
                              ? exp2f(fmaf(sc[j][2 * hr + e], c2, -l2)) : 0.f;
          ds[e] = p * (dp[j][2 * hr + e] - di);
        }
        *reinterpret_cast<float2*>(row + (c ^ swz(i))) =
            make_float2(ds[0], ds[1]);
      }
    }
    __syncthreads();           // dS written
    prod_ab<HDP / 32, HDP>(acc, sdS, 32 * (warp & 1), cK,
                              (warp >> 1) * (HDP / 4), g.hd);
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int qi = q0 + 32 * (warp & 1) + 16 * mt + gq + 8 * hr;
      if (qi >= g.S) continue;
      float* row = dq + ((static_cast<int64_t>(b) * g.S + qi) * g.H + h) * g.hd;
#pragma unroll
      for (int j = 0; j < HDP / 32; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = (warp >> 1) * (HDP / 4) + 8 * j + 2 * tq + e;
          if (d < g.hd) row[d] = acc[mt][j][2 * hr + e] * g.scale;
        }
    }
}

template <int HDP>
constexpr int dkv_smem() {
  return (6 * kTile * HDP + 2 * kTile * kTile + 4 * kTile) * 4;
}

// dK and dV of one 64-key tile of kv head (b, kvh): walks its G query
// heads in order and, for each, the query tiles that can see the keys; Q,
// dO and the rows' lse and D double-buffered by cp.async.  Warp w computes
// S^T = K Q^T and dP^T = V dO^T on keys 16 (w % 4) .. +15, queries 32 (w /
// 4) .. +31, then P^T and dS^T = P^T o (dP^T - D) into shared tiles; then
// warps 0-3 dV += P^T dO and warps 4-7 dK += dS^T Q, each on keys 32 (w %
// 2) .. +31 and head dims HDP/2 ((w / 2) % 2) ..; dK = scale dK at the end.
template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
wattn_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, Geom g,
                     Strides sq, Strides sk, Strides sv, bool vec) {
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;                          // [64][HDP]
  float* sV = sK + kTile * HDP;              // [64][HDP]
  float* sQ = sV + kTile * HDP;              // [2][64][HDP]
  float* sdO = sQ + 2 * kTile * HDP;         // [2][64][HDP]
  float* sP = sdO + 2 * kTile * HDP;         // [64 keys][64 queries]
  float* sdS = sP + kTile * kTile;           // [64 keys][64 queries]
  float* sL = sdS + kTile * kTile;           // [2][64]
  float* sD = sL + 2 * kTile;                // [2][64]
  const int warp = threadIdx.x >> 5, wm = warp & 3, wn = warp >> 2;
  const int u = warp & 3;                    // output quarter
  const bool dk_warp = warp >= 4;
  const int gq = (threadIdx.x & 31) >> 2, tq = threadIdx.x & 3;
  const int k0 = blockIdx.x * kTile, bkv = blockIdx.y;
  const int b = bkv / g.KV, kvh = bkv % g.KV, G = g.H / g.KV;
  const Strides so = {static_cast<int64_t>(g.S) * g.H * g.hd,
                      static_cast<int64_t>(g.H) * g.hd, g.hd};
  const int q_hi = min(g.S, k0 + kTile + g.window - 1);
  const int nq = (q_hi - k0 + kTile - 1) / kTile;   // query tiles per head
  const int n_it = G * nq;
  // step it: query head kvh G + it / nq, query tile k0 + 64 (it % nq)
  auto stage = [&](int it, int buf) {
    const int h = kvh * G + it / nq, q0 = k0 + (it % nq) * kTile;
    const int64_t bh = static_cast<int64_t>(b) * g.H + h;
    stage_tile<HDP>(sQ + buf * kTile * HDP, q + b * sq.b + h * sq.h, sq.s, q0,
                    g.S, g.hd, vec);
    stage_tile<HDP>(sdO + buf * kTile * HDP, dout + b * so.b + h * so.h, so.s,
                    q0, g.S, g.hd, vec);
    stage_rows(sL + buf * kTile, sD + buf * kTile, lse, delta, bh, q0, g.S);
  };
  stage_tile<HDP>(sK, k + b * sk.b + kvh * sk.h, sk.s, k0, g.S, g.hd, vec);
  stage_tile<HDP>(sV, v + b * sv.b + kvh * sv.h, sv.s, k0, g.S, g.hd, vec);
  stage(0, 0);
  cp_async_commit();

  const float c2 = g.scale * kLog2e;
  const int ks = (g.hd + 7) / 8;
  float acc[2][HDP / 16][4] = {};            // dV (warps 0-3), dK (4-7)
  for (int it = 0; it < n_it; ++it) {
    cp_async_wait_all();
    __syncthreads();           // step it landed; step it-1's products are done
    if (it + 1 < n_it) {
      stage(it + 1, (it + 1) & 1);
      cp_async_commit();
    }
    const int buf = it & 1, q0 = k0 + (it % nq) * kTile;
    const float* cQ = sQ + buf * kTile * HDP;
    const float* cdO = sdO + buf * kTile * HDP;
    const float* cL = sL + buf * kTile;
    const float* cD = sD + buf * kTile;
    // rows: keys 16 wm + gq (+8); columns: queries 32 wn + 8 j + 2 tq (+1)
    float sc[4][4] = {}, dp[4][4] = {};
    scores<HDP>(sc, dp, sK, cQ, sV, cdO, 16 * wm, 32 * wn, ks);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = 16 * wm + gq + 8 * hr;
      const int off = r * kTile;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 32 * wn + 8 * j + 2 * tq;
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          p[e] = in_window(q0 + c + e, k0 + r, g)
                     ? exp2f(fmaf(sc[j][2 * hr + e], c2, -cL[c + e] * kLog2e))
                     : 0.f;
          ds[e] = p[e] * (dp[j][2 * hr + e] - cD[c + e]);
        }
        const int at = off + (c ^ swz(r));
        *reinterpret_cast<float2*>(sP + at) = make_float2(p[0], p[1]);
        *reinterpret_cast<float2*>(sdS + at) = make_float2(ds[0], ds[1]);
      }
    }
    __syncthreads();           // P^T and dS^T written
    prod_ab<HDP / 16, HDP>(acc, dk_warp ? sdS : sP, 32 * (u & 1),
                              dk_warp ? cQ : cdO, (u >> 1) * (HDP / 2), g.hd);
  }
  float* out = dk_warp ? dk : dv;
  const float mul = dk_warp ? g.scale : 1.f;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int kj = k0 + 32 * (u & 1) + 16 * mt + gq + 8 * hr;
      if (kj >= g.S) continue;
      float* row = out + ((static_cast<int64_t>(b) * g.S + kj) * g.KV + kvh) * g.hd;
#pragma unroll
      for (int j = 0; j < HDP / 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = (u >> 1) * (HDP / 2) + 8 * j + 2 * tq + e;
          if (d < g.hd) row[d] = acc[mt][j][2 * hr + e] * mul;
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

// 16-byte cp.async when every staged row starts on a 16-byte boundary
bool vec_ok(const Geom& g, std::initializer_list<const float*> ptrs,
            std::initializer_list<Strides> strides) {
  bool vec = g.hd % 4 == 0;
  for (const float* p : ptrs)
    vec = vec && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  // (64 rows of a slice span under 2^31 elements: stage_kv's row steps)
  for (const Strides& s : strides)
    vec = vec && s.b % 4 == 0 && s.s % 4 == 0 && s.h % 4 == 0 &&
          s.s < (int64_t{1} << 25);
  return vec;
}

template <int HDP, int SLOTS, bool SPLIT>
int fwd_launch(const float* q, const float* k, const float* v, float* o,
               float* lse, int64_t B, Geom g, Strides sq, Strides sk,
               Strides sv, cudaStream_t st) {
  const int smem = fwd_smem<HDP, SLOTS, SPLIT>();
  cudaError_t err = allow_smem(wattn_fwd_kernel<HDP, SLOTS, SPLIT>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((g.S + kTile - 1) / kTile,
                  static_cast<unsigned>(B * g.H / SLOTS));
  wattn_fwd_kernel<HDP, SLOTS, SPLIT><<<grid, 128 * SLOTS, smem, st>>>(
      q, k, v, o, lse, g, sq, sk, sv, vec_ok(g, {q, k, v}, {sq, sk, sv}));
  return static_cast<int>(cudaGetLastError());
}

// Unset, the shape chooses the block and the head-dim route;
// tools/wattn_fwd_alternatives.py sets them to time each choice against its
// removal.  WATTN_FWD_SLOTS 1 or 2: blocks of that many query heads
// wherever H / KV allows.  WATTN_FWD_SPLIT 0 or 1: every block splits its
// fragments, or every block splits K and V tiles once.  WATTN_FWD_HDP32 0:
// hd <= 32 runs at 64.
#ifndef WATTN_FWD_SLOTS
#define WATTN_FWD_SLOTS 0
#endif
#ifndef WATTN_FWD_SPLIT
#define WATTN_FWD_SPLIT -1
#endif
#ifndef WATTN_FWD_HDP32
#define WATTN_FWD_HDP32 1
#endif

// Two query heads a block, splitting each K and V tile once, where H / KV
// is even and that grid still leaves a block for every SM; else one, for
// twice the blocks in flight (short sequences, odd H / KV).
template <int HDP>
int fwd(const float* q, const float* k, const float* v, float* o, float* lse,
        int64_t B, Geom g, Strides sq, Strides sk, Strides sv, cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles = (g.S + kTile - 1) / kTile;
  const bool two = (g.H / g.KV) % 2 == 0 &&
                   (WATTN_FWD_SLOTS ? WATTN_FWD_SLOTS == 2
                                    : tiles * B * g.H >= 2 * sms);
  if (two) {
    if constexpr (WATTN_FWD_SPLIT == 0)
      return fwd_launch<HDP, 2, false>(q, k, v, o, lse, B, g, sq, sk, sv, st);
    else
      return fwd_launch<HDP, 2, true>(q, k, v, o, lse, B, g, sq, sk, sv, st);
  }
  if constexpr (WATTN_FWD_SPLIT == 1)
    return fwd_launch<HDP, 1, true>(q, k, v, o, lse, B, g, sq, sk, sv, st);
  else
    return fwd_launch<HDP, 1, false>(q, k, v, o, lse, B, g, sq, sk, sv, st);
}

// 16-byte cp.async of bf16 rows: hd % 8 == 0, every row 16-byte aligned
bool vec_ok_bf16(const Geom& g, std::initializer_list<const void*> ptrs,
                 std::initializer_list<Strides> strides) {
  bool vec = g.hd % 8 == 0;
  for (const void* p : ptrs)
    vec = vec && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  for (const Strides& s : strides)
    vec = vec && s.b % 8 == 0 && s.s % 8 == 0 && s.h % 8 == 0;
  return vec;
}

template <int HDP>
int fwd_bf16(const void* q, const void* k, const void* v, void* o, float* lse,
             int64_t B, Geom g, Strides sq, Strides sk, Strides sv,
             cudaStream_t st) {
  const int smem = fwd_bf16_smem<HDP>();
  cudaError_t err = allow_smem(wattn_fwd_bf16_kernel<HDP>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((g.S + kTile - 1) / kTile, static_cast<unsigned>(B * g.H));
  wattn_fwd_bf16_kernel<HDP><<<grid, 128, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse,
      g, sq, sk, sv, vec_ok_bf16(g, {q, k, v}, {sq, sk, sv}));
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
  const bool vec = vec_ok(g, {q, k, v, dout}, {sq, sk, sv});
  const unsigned tiles = (g.S + kTile - 1) / kTile;
  wattn_bwd_dq_kernel<HDP><<<dim3(tiles, static_cast<unsigned>(B * g.H)),
                             kThreads, s_dq, st>>>(q, k, v, dout, lse, delta,
                                                   dq, g, sq, sk, sv, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  wattn_bwd_dkv_kernel<HDP><<<dim3(tiles, static_cast<unsigned>(B * g.KV)),
                              kThreads, s_dkv, st>>>(q, k, v, dout, lse, delta,
                                                     dk, dv, g, sq, sk, sv,
                                                     vec);
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
  return hd <= 32 && WATTN_FWD_HDP32 ? fwd<32>(q, k, v, o, lse, B, g, sq, sk,
                                                sv, st)
         : hd <= 64 ? fwd<64>(q, k, v, o, lse, B, g, sq, sk, sv, st)
                    : fwd<128>(q, k, v, o, lse, B, g, sq, sk, sv, st);
}

// Forward of bf16 q, k, v (strides and layout as for the fp32 forward); o
// (B,S,H,hd) bf16 and lse (B,H,S) fp32, contiguous.  Returns
// cudaGetLastError() after the launch.
extern "C" int repro_window_attn_fwd_bf16(
    const void* q, const void* k, const void* v, void* o, float* lse,
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
  return hd <= 32   ? fwd_bf16<32>(q, k, v, o, lse, B, g, sq, sk, sv, st)
         : hd <= 64 ? fwd_bf16<64>(q, k, v, o, lse, B, g, sq, sk, sv, st)
                    : fwd_bf16<128>(q, k, v, o, lse, B, g, sq, sk, sv, st);
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
