// Selective-SSM (mamba) scan for Hopper, forward and backward:
//   h_t = exp(dt_t * a) * h_{t-1} + dt_t * b_t * x_t       (per channel d,
//   y_t = sum_n c_t[n] * h_t[n]                             state n <= 16)
// dt, x, y: (B,S,D); b, c: (B,S,n); a: (G,D,n) with sequence i using
// a[i / (B/G)]; h0, h_last: (B,D,n).  All fp32, contiguous.
//
// Replaces the Pallas TPU kernel ssm_scan_kernel in
// src/repro/kernels/ssm_scan/kernel.py (forward) and the oracle VJP that
// src/repro/kernels/ssm_scan/ops.py:51-53 uses as its backward.
//
// What bounds it on an H100.  Per channel-step the forward reads dt and x
// and writes y (12 bytes) and evaluates n exps.  At the full-width shape
// (B=2, S=4096, D=16384, n=16) that is 1.61 GB (0.48 ms at 3.35 TB/s) and
// 2.15e9 exps (0.5 ms at 16 per clock per SM on 132 SMs): bytes and the
// special-function unit bound it about equally.  abar = exp(dt a) is taken
// as exp2(dt (a log2 e)): MUFU.EX2 with, without -use_fast_math, a range
// test and two multiplies around it, so a state-step issues about 8
// instructions beside its exp and the issue rate is as near a limit as
// the exp unit.  At the federated paths' (50, 64, 64, 8) the work is tiny
// and every latency of the recurrence's 64 dependent steps shows.
//
// Forward design.  Time is cut into sub-chunks of kCkpt = 8 steps, the
// backward's checkpoint interval.  Every sub-chunk is walked from its start
// h with abar() and advance(), which the backward's recompute shares, so
// the backward rebuilds from the checkpoints the very h that gave y.  The
// start is the checkpoint, written in training mode to a (B, ceil(S/8), D,
// n) buffer.  A lane holds 4 or 8 states of a channel; its 8 partial
// sums c.h of a sub-chunk are reduce-scattered over the channel's lanes
// and each lane stores 8/L of y straight from registers.  Tiles of dt, x,
// b, c are copied by cp.async (16 bytes where rows are aligned, 4 bytes
// with zero fill at ragged edges; steps past S are dt = 0, abar = 1) into
// one of two buffers while the other is walked.  Two routes (fwd_subs):
//   * The time split (SUBS = 2, 4, 8 sub-chunks of a tile at once).  A
//     thread owns (channel, lane, sub-chunk): it forms its sub-chunk's
//     abar (kept in registers) and composite, the product of the abar and
//     the h from zero; the composites go through shared memory, each
//     thread folds those before its own onto the tile's carry in order,
//     which gives its start, and walks.  The last sub-chunk's start,
//     folded once more, is the next tile's carry.  It costs 3 more FP32
//     operations a state-step and a barrier a tile, so it is taken only for
//     sequences of at most 256 steps whose (B, D) channels leave the card
//     short of warps.  The mamba path's (50, 64, 64, 8) takes 8: 16
//     channels a block, no thread idle, each warp taking one 8-step
//     sub-chunk of the 64 (its composite, then its walk).
//   * The walk alone (SUBS = 1): a thread walks a tile's sub-chunks in
//     turn, forming each step's abar as it goes.  Past n = 8 a lane holds 8
//     states (two lanes a channel), which halves the lanes' loads of b and
//     c and y's shuffles, where the 128-channel blocks that gives still
//     number at least the SMs (seq_lanes).  Jamba's (2, S, 16384, 16) takes
//     it: its channels fill the card without the split, whose extra
//     operations cost more there than the latency they hide.
// Backward design.  Time runs in reverse with the cotangent of h in
// registers: G_t = c_t gy_t + abar_{t+1} G_{t+1}, seeded with the h_last
// cotangent.  It needs h_{t-1} at every step, so each 8-step sub-chunk is
// recomputed forward from its checkpoint (one state update per step, the
// floor for this kernel), then walked back:
//   d dt_t = sum_n G (a abar h_{t-1} + b x),  d x_t = sum_n G dt b   (lanes)
//   d b_t[n] = sum_d G dt x,  d c_t[n] = sum_d gy h_t               (over D)
//   d a[d,n] = sum_t G dt abar h_{t-1},  d h0 = abar_0 G_0.
// Beyond that floor the cost is per state-step work and latency, so:
//   * One exp per state-step: the recompute keeps its 8 steps' abar in
//     shared memory ([step][thread][state], conflict-free float4s; in
//     registers they spilled at 256 threads) and the walk back reads it.
//     The forward uses the same abar() and advance(), so the recompute
//     rebuilds its h bit for bit.
//   * d b and d c: a lane's 8 partials (4 states each) are reduce-scattered
//     over the warp's channels, 4 + 2 + 1 shuffles plus a full sum over
//     any channel bits left (L < 4), so with the two lane sums a lane-step
//     costs 11 shuffles at L = 4 (an all-reduce would take 28); each lane
//     then stores one value.
//   * A block covers 64 channels (64 L threads), so no thread idles where
//     D = 64 and twice the blocks run; with one block in D the walk writes
//     d b and d c itself, and the second kernel only sums d a.
//   * Tiles of 16 steps (dt, x, gy, b, c and the tile's checkpoints) are
//     copied by cp.async into one of two buffers while the other is
//     walked; the warps' d b / d c partials are summed once a tile.
// The sums over D cross thread blocks: with more than one block in D each
// block writes its partial (warps summed in order) and the second kernel
// sums the partials over blocks in block order; d a is summed over t in
// registers and over the sequences of a group by the same second kernel.
// No atomics, so the result is the same on every run.
// Every offset into a (B,S,D)-sized array is 64-bit.  Ragged S, D and n are
// masked in the kernels; nothing is padded.
//
// bf16 operands.  The TPU kernel widens each load of dt, b, c and x to
// fp32 (kernel.py's ``.astype(jnp.float32)``) and writes y in fp32; the
// reference's mamba_impl="pallas" route hands it the compute-dtype
// operands straight.  The forward is templated on their type In.  For
// bf16, dt and x stay bf16 in the tile buffers, double-buffered by
// cp.async as the fp32 tiles are (16-byte copies of 8 elements where D %
// 8 == 0, else of 4 in 8 bytes), so two bf16 buffers take the bytes of one
// fp32 buffer; the walk widens each dt and x as it reads it into a
// register (a channel's dt and x are read by its L lanes alone).  b and c
// are (B, S, n): every channel of a block reads the same rows, so
// widening them at each read would repeat the conversion CPB = 128 times
// over (measured 1.12-1.16x slower: PERF.md section 6);
// a thread loads its 4 of the next tile's b and of its c into registers
// before the walk and widens them into the tile's fp32 b and c after it,
// so the loads' latency hides behind the walk, with no staging tile and
// no pass before the barrier.  Rows that are not 8-byte aligned (D or n
// not a multiple of 4) are loaded an element at a time, synchronously.
// The walk's arithmetic is the fp32 route's on the widened values, so a
// bf16 call gives the bits of the fp32 call on the widened operands.  a,
// h0, y, h_last and the checkpoints stay fp32, and the backward kernel is
// fp32 only: the wrapper widens saved bf16 operands once for it.
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;       // the reduce kernel's block
constexpr int kFwdThreads = 256;    // the forward's block
constexpr int kNpl = 4;          // states per lane
constexpr int kMaxN = 16;
constexpr int kCkpt = 8;         // steps between forward checkpoints
constexpr int kBwdCpb = 64;      // channels per backward block
constexpr int kBwdT = 16;        // steps per backward tile

int lanes_for(int64_t n) { return n <= 4 ? 1 : (n <= 8 ? 2 : 4); }

// abar = exp(dt a) as exp2(dt (a log2 e)), and one step of one state,
// h <- abar h + (dt x) b.  The forward and the backward's recompute share
// both, so the backward rebuilds the forward's h bit for bit.
__device__ __forceinline__ float abar(float dtv, float al) {
  return exp2f(dtv * al);
}

__device__ __forceinline__ float advance(float h, float ab, float dtx,
                                         float bj) {
  return fmaf(ab, h, dtx * bj);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <int L>
__device__ __forceinline__ float lane_sum(float v) {
#pragma unroll
  for (int o = 1; o < L; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One halving level of a reduce-scatter over lanes ``off`` apart: of the
// CNT values v[0..CNT), a lane keeps the upper half if ``upper`` and the
// lower half otherwise, summed with its partner's copy, in v[0..CNT/2).
template <int CNT>
__device__ __forceinline__ void rs_level(float (&v)[2 * kNpl], int off,
                                         bool upper) {
  constexpr int HALF = CNT / 2;
#pragma unroll
  for (int q = 0; q < HALF; ++q) {
    const float send = upper ? v[q + 0] : v[q + HALF];
    const float keep = upper ? v[q + HALF] : v[q + 0];
    v[q] = keep + __shfl_xor_sync(0xffffffffu, send, off);
  }
}

// The forward's geometry: a block of kFwdThreads covers CPB channels x L
// lanes x SUBS sub-chunks (a lane's 4 states, one sub-chunk of kCkpt
// steps).  A tile holds T steps: SUBS sub-chunks walked at once (SUBS > 1,
// the time split) or SEQ sub-chunks walked in turn (SUBS = 1, 2,048
// channel-steps a tile).  A tile buffer holds dt and x (T x CPB each, of
// the input type In) and b and c (T x kSt each, fp32: bf16 b and c are
// widened into the tile).
template <int L, int SUBS, int NPL>
struct FwdGeo {
  static constexpr int kCpb = kFwdThreads / (L * SUBS);   // channels
  static constexpr int kT =                                // steps a tile
      SUBS > 1 ? kCkpt * SUBS : (4096 / kCpb < 32 ? 4096 / kCpb : 32);
  static constexpr int kSeq = kT / (kCkpt * SUBS);
  static constexpr int kSt = NPL * L;                      // states held
  static constexpr int kDtx = 2 * kT * kCpb;               // dt, x
  static constexpr int kBc = 2 * kT * kSt;                  // b, c
  // every thread's composite (P, hl: 2 float4s) and the carry into the
  // next tile (two parities); only with the time split
  static constexpr int kComp =
      SUBS > 1 ? kFwdThreads * 2 * kNpl + 2 * kCpb * kSt : 0;
  template <typename In>
  __host__ __device__ static constexpr int buf_bytes() {
    return kDtx * static_cast<int>(sizeof(In)) + 4 * kBc;
  }
  // two tile buffers and the composites
  template <typename In>
  __host__ __device__ static constexpr int smem_bytes() {
    return 2 * buf_bytes<In>() + 4 * kComp;
  }
  static_assert(kCpb % 8 == 0 && kSeq >= 1, "16-byte rows, whole sub-chunks");
  static_assert(kCpb * L % 32 == 0, "a warp walks one sub-chunk");
  static_assert(SUBS == 1 || NPL == kNpl, "the split keeps 4 states a lane");
  static_assert(kT * kSt / 4 <= kFwdThreads, "a thread holds one b, c chunk");
};

// one bf16 element widened into an fp32 tile by a plain load (zero when
// ``ok`` is false)
__device__ __forceinline__ void widen1(float* dst, const __nv_bfloat16* src,
                                       bool ok) {
  *dst = ok ? __bfloat162float(*src) : 0.f;
}

// A sub-chunk's 8 steps from tile row r0: dtx = dt x and abar of each step
// and state (one exp each), and the sub-chunk's composite: the product of
// its abar (pr) and its h from zero (hl).
template <int L, typename DT>
__device__ __forceinline__ void sub_prep(
    const DT* s_dt, const DT* s_x, const float* s_b, int cpb, int ch,
    int lane, int r0, const float (&al)[kNpl], float (&ab)[kCkpt][kNpl],
    float (&dtx)[kCkpt], float (&pr)[kNpl], float (&hl)[kNpl]) {
#pragma unroll
  for (int u = 0; u < kCkpt; ++u) {
    const int row = r0 + u;
    const float dtv = wload1(s_dt + row * cpb + ch);
    dtx[u] = dtv * wload1(s_x + row * cpb + ch);
#pragma unroll
    for (int j = 0; j < kNpl; ++j) ab[u][j] = abar(dtv, al[j]);
    const float4 b4 = ld4(&s_b[row * kNpl * L + lane * kNpl]);
    const float bb[kNpl] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int j = 0; j < kNpl; ++j) {
      hl[j] = advance(u == 0 ? 0.f : hl[j], ab[u][j], dtx[u], bb[j]);
      pr[j] = u == 0 ? ab[u][j] : pr[j] * ab[u][j];
    }
  }
}

// Walk a sub-chunk's 8 steps from h with abar() and advance() as the
// backward's recompute does, then store y: the lane's 8 partial sums are
// reduce-scattered over the channel's L lanes, so lane l stores steps
// (8/L) l .. (8/L) l + 8/L - 1.
template <int L>
__device__ __forceinline__ void sub_walk(
    const float* s_b, const float* s_c, int lane, int r0,
    const float (&ab)[kCkpt][kNpl], const float (&dtx)[kCkpt],
    float (&h)[kNpl], float* __restrict__ yd, int64_t D, int tleft,
    bool live) {
  constexpr int ST = kNpl * L, KEEP = kCkpt / L;
  static_assert(kCkpt == 2 * kNpl, "rs_level works on 8 values");
  float yv[kCkpt];
#pragma unroll
  for (int u = 0; u < kCkpt; ++u) {
    const int row = r0 + u;
    const float4 b4 = ld4(&s_b[row * ST + lane * kNpl]);
    const float4 c4 = ld4(&s_c[row * ST + lane * kNpl]);
    const float bb[kNpl] = {b4.x, b4.y, b4.z, b4.w};
    const float cc[kNpl] = {c4.x, c4.y, c4.z, c4.w};
    float yp = 0.f;
#pragma unroll
    for (int j = 0; j < kNpl; ++j) {
      h[j] = advance(h[j], ab[u][j], dtx[u], bb[j]);
      yp = fmaf(cc[j], h[j], yp);
    }
    yv[u] = yp;
  }
  if constexpr (L >= 2) rs_level<8>(yv, L / 2, lane & (L / 2));
  if constexpr (L >= 4) rs_level<4>(yv, 1, lane & 1);
#pragma unroll
  for (int q = 0; q < KEEP; ++q) {
    const int u = KEEP * lane + q;
    if (live && u < tleft) yd[u * D] = yv[q];
  }
}

// The walk without the split: a sub-chunk's 8 steps from h, abar formed
// step by step (one exp per state-step) and applied with advance() as the
// backward's recompute does; y reduce-scattered and stored as in
// sub_walk.  A lane holds NPL states.
template <int L, int NPL, typename DT>
__device__ __forceinline__ void seq_walk(
    const DT* s_dt, const DT* s_x, const float* s_b, const float* s_c,
    int cpb, int ch, int lane, int r0, const float (&al)[NPL],
    float (&h)[NPL], float* __restrict__ yd, int64_t D, int tleft,
    bool live) {
  constexpr int ST = NPL * L, KEEP = kCkpt / L;
  float yv[kCkpt];
#pragma unroll
  for (int u = 0; u < kCkpt; ++u) {
    const int row = r0 + u;
    const float dtv = wload1(s_dt + row * cpb + ch);
    const float dtx = dtv * wload1(s_x + row * cpb + ch);
    float yp = 0.f;
#pragma unroll
    for (int q = 0; q < NPL; q += 4) {
      const float4 b4 = ld4(&s_b[row * ST + lane * NPL + q]);
      const float4 c4 = ld4(&s_c[row * ST + lane * NPL + q]);
      const float bb[4] = {b4.x, b4.y, b4.z, b4.w};
      const float cc[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        h[q + e] = advance(h[q + e], abar(dtv, al[q + e]), dtx, bb[e]);
        yp = fmaf(cc[e], h[q + e], yp);
      }
    }
    yv[u] = yp;
  }
  if constexpr (L >= 2) rs_level<8>(yv, L / 2, lane & (L / 2));
  if constexpr (L >= 4) rs_level<4>(yv, 1, lane & 1);
#pragma unroll
  for (int q = 0; q < KEEP; ++q) {
    const int u = KEEP * lane + q;
    if (live && u < tleft) yd[u * D] = yv[q];
  }
}

// The forward.  SUBS > 1 (the time split): the SUBS warps of a tile take
// one sub-chunk each; each forms its abar (kept in registers) and its
// composite, the composites are exchanged through shared memory, each warp
// folds those before its own onto the tile's carry (its start, written as
// the sub-chunk's checkpoint) and walks its 8 steps from there.  SUBS = 1:
// each thread walks the tile's sub-chunks in turn from h.  The next tile
// of dt, x, b, c is copied (cp.async, 16 or 8 bytes where rows allow; bf16
// b and c through registers, widened after the walk) into one of two
// buffers while the other is walked; y is stored from registers.
template <typename In, int L, int SUBS, int NPL>
__global__ void __launch_bounds__(kFwdThreads, 2)
ssm_fwd_kernel(const In* __restrict__ dt, const In* __restrict__ bm,
               const In* __restrict__ cm, const In* __restrict__ x,
               const float* __restrict__ a, const float* __restrict__ h0,
               float* __restrict__ y, float* __restrict__ h_last,
               float* __restrict__ ckpt, int S, int D, int n, int per_group,
               int dvec, bool vec_n) {
  using Geo = FwdGeo<L, SUBS, NPL>;
  constexpr int CPB = Geo::kCpb, T = Geo::kT, ST = Geo::kSt, CL = CPB * L;
  constexpr int kBufBytes = Geo::template buf_bytes<In>();
  constexpr bool kBf16 = !std::is_same<In, float>::value;
  extern __shared__ __align__(16) float smem[];
  unsigned char* base = reinterpret_cast<unsigned char*>(smem);
  float* s_comp = reinterpret_cast<float*>(base + 2 * kBufBytes);  // [SUBS][CL][8]
  float* s_carry = s_comp + kFwdThreads * 2 * kNpl;  // [2][CL][4]
  const int lane = threadIdx.x % L, cl = threadIdx.x % CL;
  const int ch = cl / L, sc = threadIdx.x / CL;
  const int bi = blockIdx.y, d0 = blockIdx.x * CPB, d = d0 + ch;
  const int64_t seq = static_cast<int64_t>(bi) * S * D;
  const int64_t seq_n = static_cast<int64_t>(bi) * S * n;
  const int64_t chan = (static_cast<int64_t>(bi) * D + d) * n;
  const float* ag = a + static_cast<int64_t>(bi / per_group) * D * n;
  const int nck = (S + kCkpt - 1) / kCkpt;
  const bool live = d < D;
  // tile buffer p: dt, x [T][CPB] of In, then b, c [T][ST] of fp32
  auto dt_of = [&](int p) {
    return reinterpret_cast<In*>(base + p * kBufBytes);
  };
  auto b_of = [&](int p) {
    return reinterpret_cast<float*>(base + p * kBufBytes +
                                    Geo::kDtx * static_cast<int>(sizeof(In)));
  };

  // bf16 b and c of the next tile (8-byte rows): this thread's 4
  // of each, loaded into registers by issue() before the walk and widened
  // into the tile's buffer by land() after it, so the loads' latency hides
  // behind the walk
  uint2 pend_b = make_uint2(0u, 0u), pend_c = make_uint2(0u, 0u);
  auto land = [&](int p) {
    if (!kBf16 || !vec_n || threadIdx.x >= T * ST / 4) return;
    float* s_b = b_of(p);
    *reinterpret_cast<float4*>(s_b + 4 * threadIdx.x) = widen_bf16x4(pend_b);
    *reinterpret_cast<float4*>(s_b + T * ST + 4 * threadIdx.x) =
        widen_bf16x4(pend_c);
  };

  // Issue the copies of tile ``tile`` into buffer ``p`` (zeros outside S,
  // D, n); bf16 b and c to be widened go to pend_b, pend_c (land()).  dt
  // and x rows are copied ``dvec`` elements at a time: 4 (16 bytes of fp32,
  // 8 of bf16) or 8 (16 bytes of bf16), or, in rows that allow neither, one
  // at a time (cp.async for fp32, plain loads for bf16).
  auto issue = [&](int tile, int p) {
    const int t0 = tile * T;
    In* s_dt = dt_of(p);
    In* s_x = s_dt + T * CPB;
    float* s_b = b_of(p);
    float* s_c = s_b + T * ST;
    if (kBf16 && dvec == 8) {
      for (int i = threadIdx.x; i < T * CPB / 8; i += kFwdThreads) {
        const int t = t0 + i / (CPB / 8), dd = d0 + 8 * (i % (CPB / 8));
        const bool ok = t < S && dd < D;
        const int64_t off = ok ? seq + static_cast<int64_t>(t) * D + dd : 0;
        cp_async16(s_dt + 8 * i, dt + off, ok);
        cp_async16(s_x + 8 * i, x + off, ok);
      }
    } else if (dvec == 4) {
      for (int i = threadIdx.x; i < T * CPB / 4; i += kFwdThreads) {
        const int t = t0 + i / (CPB / 4), dd = d0 + 4 * (i % (CPB / 4));
        const bool ok = t < S && dd < D;
        const int64_t off = ok ? seq + static_cast<int64_t>(t) * D + dd : 0;
        if constexpr (kBf16) {
          cp_async8(s_dt + 4 * i, dt + off, ok);
          cp_async8(s_x + 4 * i, x + off, ok);
        } else {
          cp_async16(s_dt + 4 * i, dt + off, ok);
          cp_async16(s_x + 4 * i, x + off, ok);
        }
      }
    } else {
      for (int i = threadIdx.x; i < T * CPB; i += kFwdThreads) {
        const int t = t0 + i / CPB, dd = d0 + i % CPB;
        const bool ok = t < S && dd < D;
        const int64_t off = ok ? seq + static_cast<int64_t>(t) * D + dd : 0;
        if constexpr (kBf16) {
          s_dt[i] = ok ? dt[off] : __float2bfloat16_rn(0.f);
          s_x[i] = ok ? x[off] : __float2bfloat16_rn(0.f);
        } else {
          cp_async4(s_dt + i, dt + off, ok);
          cp_async4(s_x + i, x + off, ok);
        }
      }
    }
    if (vec_n) {
      for (int i = threadIdx.x; i < T * ST / 4; i += kFwdThreads) {
        const int t = t0 + i / (ST / 4), j = 4 * (i % (ST / 4));
        const bool ok = t < S && j < n;
        const int64_t off = ok ? seq_n + static_cast<int64_t>(t) * n + j : 0;
        if constexpr (kBf16) {
          pend_b = ok ? *reinterpret_cast<const uint2*>(bm + off)
                      : make_uint2(0u, 0u);
          pend_c = ok ? *reinterpret_cast<const uint2*>(cm + off)
                      : make_uint2(0u, 0u);
        } else {
          cp_async16(s_b + 4 * i, bm + off, ok);
          cp_async16(s_c + 4 * i, cm + off, ok);
        }
      }
    } else {
      for (int i = threadIdx.x; i < T * ST; i += kFwdThreads) {
        const int t = t0 + i / ST, j = i % ST;
        const bool ok = t < S && j < n;
        const int64_t off = ok ? seq_n + static_cast<int64_t>(t) * n + j : 0;
        if constexpr (kBf16) {
          widen1(s_b + i, bm + off, ok);
          widen1(s_c + i, cm + off, ok);
        } else {
          cp_async4(s_b + i, bm + off, ok);
          cp_async4(s_c + i, cm + off, ok);
        }
      }
    }
    cp_async_commit();
  };
  // h of this channel's lane at the start of sub-chunk ``sub``
  auto store_ckpt = [&](int sub, const float (&hv)[NPL]) {
    float* dst = ckpt + ((static_cast<int64_t>(bi) * nck + sub) * D + d) * n +
                 lane * NPL;
    if (!live) return;
#pragma unroll
    for (int q = 0; q < NPL; q += 4) {
      if (vec_n && lane * NPL + q < n) {
        *reinterpret_cast<float4*>(dst + q) =
            make_float4(hv[q], hv[q + 1], hv[q + 2], hv[q + 3]);
      } else {
#pragma unroll
        for (int j = q; j < q + 4; ++j)
          if (lane * NPL + j < n) dst[j] = hv[j];
      }
    }
  };

  // h: the tile's carry (SUBS > 1) or the walk's state (SUBS = 1)
  float al[NPL], h[NPL];
#pragma unroll
  for (int j = 0; j < NPL; ++j) {
    const int st = lane * NPL + j;
    const bool ok = live && st < n;
    al[j] = ok ? ag[static_cast<int64_t>(d) * n + st] * kLog2e : 0.f;
    h[j] = ok ? h0[chan + st] : 0.f;
  }
  const int ntile = (S + T - 1) / T;
  issue(0, 0);
  land(0);
  for (int tile = 0, p = 0; tile < ntile; ++tile, p ^= 1) {
    const In* s_dt = dt_of(p);
    const In* s_x = s_dt + T * CPB;
    const float* s_b = b_of(p);
    const float* s_c = s_b + T * ST;
    cp_async_wait_all();
    __syncthreads();    // this tile landed; the last tile's reads are done
    if (tile + 1 < ntile) issue(tile + 1, p ^ 1);
    const int t0 = tile * T;
    if constexpr (SUBS == 1) {
#pragma unroll 1
      for (int q = 0; q < Geo::kSeq; ++q) {
        const int r0 = q * kCkpt, t = t0 + r0;
        if (t >= S) break;                       // uniform over the block
        if (ckpt != nullptr) store_ckpt(t / kCkpt, h);
        seq_walk<L, NPL>(s_dt, s_x, s_b, s_c, CPB, ch, lane, r0, al, h,
                         y + seq + static_cast<int64_t>(t) * D + d, D, S - t,
                         live);
      }
    } else {
      const int r0 = sc * kCkpt, t = t0 + r0, sub = t / kCkpt;
      float ab[kCkpt][kNpl], dtx[kCkpt], pr[kNpl], hl[kNpl];
      sub_prep<L>(s_dt, s_x, s_b, CPB, ch, lane, r0, al, ab, dtx, pr, hl);
      float* mine = s_comp + (sc * CL + cl) * 2 * kNpl;
      *reinterpret_cast<float4*>(mine) = make_float4(pr[0], pr[1], pr[2], pr[3]);
      *reinterpret_cast<float4*>(mine + kNpl) =
          make_float4(hl[0], hl[1], hl[2], hl[3]);
      __syncthreads();  // the tile's composites are in
      if (tile > 0) {
        const float4 c4 = ld4(s_carry + (p * CL + cl) * kNpl);
        h[0] = c4.x; h[1] = c4.y; h[2] = c4.z; h[3] = c4.w;
      }
      // the start of this sub-chunk: the earlier composites folded in order
#pragma unroll
      for (int s = 0; s < SUBS - 1; ++s) {
        if (s < sc) {                            // uniform over the warp
          const float4 p4 = ld4(s_comp + (s * CL + cl) * 2 * kNpl);
          const float4 l4 = ld4(s_comp + (s * CL + cl) * 2 * kNpl + kNpl);
          h[0] = fmaf(p4.x, h[0], l4.x); h[1] = fmaf(p4.y, h[1], l4.y);
          h[2] = fmaf(p4.z, h[2], l4.z); h[3] = fmaf(p4.w, h[3], l4.w);
        }
      }
      if (sc == SUBS - 1 && tile + 1 < ntile) {
        *reinterpret_cast<float4*>(s_carry + ((p ^ 1) * CL + cl) * kNpl) =
            make_float4(fmaf(pr[0], h[0], hl[0]), fmaf(pr[1], h[1], hl[1]),
                        fmaf(pr[2], h[2], hl[2]), fmaf(pr[3], h[3], hl[3]));
      }
      if (ckpt != nullptr && sub < nck) store_ckpt(sub, h);
      sub_walk<L>(s_b, s_c, lane, r0, ab, dtx, h,
                  y + seq + static_cast<int64_t>(t) * D + d, D, S - t, live);
      // the walk of the sub-chunk that holds step S-1 gives h_last
      if (sub == nck - 1 && live) {
#pragma unroll
        for (int j = 0; j < NPL; ++j)
          if (lane * NPL + j < n) h_last[chan + lane * NPL + j] = h[j];
      }
    }
    if (tile + 1 < ntile) land(p ^ 1);  // before the next tile's barrier
  }
  if (SUBS == 1 && live) {
#pragma unroll
    for (int j = 0; j < NPL; ++j)
      if (lane * NPL + j < n) h_last[chan + lane * NPL + j] = h[j];
  }
}

// The backward's geometry: a block covers kBwdCpb channels (64 L threads,
// so no lane idles where D = 64) and walks tiles of kBwdT steps.
template <int L>
struct BwdGeo {
  static constexpr int kThreads = kBwdCpb * L;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kSt = kNpl * L;            // states a channel holds
  static constexpr int kSubs = kBwdT / kCkpt;     // sub-chunks per tile
  // one tile buffer: dt, x, gy (T x CPB); b, c (T x kSt); the sub-chunks'
  // checkpoints (kSubs x CPB x kSt)
  static constexpr int kBuf = 3 * kBwdT * kBwdCpb + 2 * kBwdT * kSt +
                              kSubs * kBwdCpb * kSt;
  static constexpr int kRed = kWarps * kBwdT * 2 * kSt;  // warps' d b / d c
  static constexpr int kAbar = kCkpt * kThreads * kNpl;  // a sub-chunk's abar
  static constexpr int kSmemBytes = 4 * (2 * kBuf + kRed + kAbar);
  static_assert(kBwdT % kCkpt == 0, "a tile holds whole sub-chunks");
};

// Sum the 8 values v (a lane's d b and d c partials of its 4 states) over
// the warp's channels, lane bits log2(L) .. 4: a reduce-scatter over bits
// 4, 3, 2 (4 + 2 + 1 shuffles), then a full sum over the channel bits
// below 2.  Afterwards v[0] holds the sum of element
// 4 bit4 + 2 bit3 + bit2 of the lane, which is returned.
template <int L>
__device__ __forceinline__ int reduce_channels(float (&v)[2 * kNpl], int wl) {
  rs_level<8>(v, 16, wl & 16);
  rs_level<4>(v, 8, wl & 8);
  rs_level<2>(v, 4, wl & 4);
#pragma unroll
  for (int o = 2; o >= L; o >>= 1) v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
  return (wl >> 2) & 7;
}

template <int L>
__global__ void __launch_bounds__(BwdGeo<L>::kThreads, 2)
ssm_bwd_kernel(const float* __restrict__ dt, const float* __restrict__ bm,
               const float* __restrict__ cm, const float* __restrict__ x,
               const float* __restrict__ a, const float* __restrict__ ckpt,
               const float* __restrict__ gy, const float* __restrict__ ghl,
               float* __restrict__ ddt, float* __restrict__ dx,
               float* __restrict__ dh0, float* __restrict__ da_seq,
               float* __restrict__ out_b, float* __restrict__ out_c,
               int S, int D, int n, int per_group) {
  using Geo = BwdGeo<L>;
  constexpr int CPB = kBwdCpb, T = kBwdT, ST = Geo::kSt;
  constexpr int NT = Geo::kThreads, SUBS = Geo::kSubs;
  extern __shared__ __align__(16) float smem[];
  float* s_red = smem + 2 * Geo::kBuf;
  // abar of the sub-chunk's steps, [u][thread][state]: kept in shared
  // memory, where 32 registers would spill
  float* s_ab = s_red + Geo::kRed + threadIdx.x * kNpl;
  const int lane = threadIdx.x % L, ch = threadIdx.x / L;
  const int wl = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bi = blockIdx.y, d0 = blockIdx.x * CPB, d = d0 + ch;
  const int64_t seq = static_cast<int64_t>(bi) * S * D;
  const int64_t seq_n = static_cast<int64_t>(bi) * S * n;
  const int64_t chan = (static_cast<int64_t>(bi) * D + d) * n;
  // d b / d c of this block's channels: (B, nblk, S, n); with one block in
  // D that is the result itself
  const int64_t part =
      (static_cast<int64_t>(bi) * gridDim.x + blockIdx.x) * S * n;
  const float* ag = a + static_cast<int64_t>(bi / per_group) * D * n;
  const int nck = (S + kCkpt - 1) / kCkpt;

  // Issue the copies of tile ``tile`` into ``buf`` (zeros outside S, D, n).
  auto issue = [&](int tile, float* buf) {
    const int t0 = tile * T;
    float* s_dt = buf;
    float* s_x = s_dt + T * CPB;
    float* s_gy = s_x + T * CPB;
    float* s_b = s_gy + T * CPB;
    float* s_c = s_b + T * ST;
    float* s_h = s_c + T * ST;
    for (int i = threadIdx.x; i < T * CPB; i += NT) {
      const int t = t0 + i / CPB, dd = d0 + i % CPB;
      const bool ok = t < S && dd < D;
      const int64_t off = ok ? seq + static_cast<int64_t>(t) * D + dd : 0;
      cp_async4(s_dt + i, dt + off, ok);
      cp_async4(s_x + i, x + off, ok);
      cp_async4(s_gy + i, gy + off, ok);
    }
    for (int i = threadIdx.x; i < T * ST; i += NT) {
      const int t = t0 + i / ST, j = i % ST;
      const bool ok = t < S && j < n;
      const int64_t off = ok ? seq_n + static_cast<int64_t>(t) * n + j : 0;
      cp_async4(s_b + i, bm + off, ok);
      cp_async4(s_c + i, cm + off, ok);
    }
    for (int i = threadIdx.x; i < SUBS * CPB * ST; i += NT) {
      const int ck = t0 / kCkpt + i / (CPB * ST), r = i % (CPB * ST);
      const int dd = d0 + r / ST, j = r % ST;
      const bool ok = ck < nck && dd < D && j < n;
      const int64_t off =
          ok ? ((static_cast<int64_t>(bi) * nck + ck) * D + dd) * n + j : 0;
      cp_async4(s_h + i, ckpt + off, ok);
    }
    cp_async_commit();
  };

  float al[kNpl], carry[kNpl], dav[kNpl];
#pragma unroll
  for (int j = 0; j < kNpl; ++j) {
    const int st = lane * kNpl + j;
    const bool ok = d < D && st < n;
    al[j] = ok ? ag[static_cast<int64_t>(d) * n + st] * kLog2e : 0.f;
    carry[j] = ok ? ghl[chan + st] : 0.f;
    dav[j] = 0.f;
  }
  const int ntile = (S + T - 1) / T;
  issue(ntile - 1, smem);
  for (int tile = ntile - 1, p = 0; tile >= 0; --tile, p ^= 1) {
    float* s_dt = smem + p * Geo::kBuf;
    float* s_x = s_dt + T * CPB;
    float* s_gy = s_x + T * CPB;
    const float* s_b = s_gy + T * CPB;
    const float* s_c = s_b + T * ST;
    const float* s_h = s_c + T * ST;
    cp_async_wait_all();
    __syncthreads();         // this tile landed; the last tile's reads done
    if (tile > 0) issue(tile - 1, smem + (p ^ 1) * Geo::kBuf);
    const int t0 = tile * T;
    const int nsub = (min(T, S - t0) + kCkpt - 1) / kCkpt;
    for (int sc = nsub - 1; sc >= 0; --sc) {
      const int u0 = sc * kCkpt;
      // recompute the sub-chunk from its checkpoint: hist[u] = h before
      // step u, hist[kCkpt] after; abar of step u kept in s_ab for the walk
      // back (one exp per state-step)
      float hist[kCkpt + 1][kNpl];
      {
        const float4 h4 = ld4(&s_h[(sc * CPB + ch) * ST + lane * kNpl]);
        hist[0][0] = h4.x; hist[0][1] = h4.y;
        hist[0][2] = h4.z; hist[0][3] = h4.w;
      }
#pragma unroll
      for (int u = 0; u < kCkpt; ++u) {
        const int tt = u0 + u;
        const float dtv = s_dt[tt * CPB + ch];
        const float dtx = dtv * s_x[tt * CPB + ch];
        const float4 b4 = ld4(&s_b[tt * ST + lane * kNpl]);
        const float bb[kNpl] = {b4.x, b4.y, b4.z, b4.w};
        float ab[kNpl];
#pragma unroll
        for (int j = 0; j < kNpl; ++j) {
          ab[j] = abar(dtv, al[j]);
          hist[u + 1][j] = advance(hist[u][j], ab[j], dtx, bb[j]);
        }
        *reinterpret_cast<float4*>(s_ab + u * NT * kNpl) =
            make_float4(ab[0], ab[1], ab[2], ab[3]);
      }
      // walk back (steps past S are zero-padded and leave G unchanged)
#pragma unroll
      for (int u = kCkpt - 1; u >= 0; --u) {
        const int tt = u0 + u;
        const float dtv = s_dt[tt * CPB + ch], xv = s_x[tt * CPB + ch];
        const float gyv = s_gy[tt * CPB + ch];
        const float4 b4 = ld4(&s_b[tt * ST + lane * kNpl]);
        const float4 c4 = ld4(&s_c[tt * ST + lane * kNpl]);
        const float bb[kNpl] = {b4.x, b4.y, b4.z, b4.w};
        const float cc[kNpl] = {c4.x, c4.y, c4.z, c4.w};
        const float4 a4 = ld4(s_ab + u * NT * kNpl);
        const float ab[kNpl] = {a4.x, a4.y, a4.z, a4.w};
        const float dtx = dtv * xv;
        float sgb = 0.f, sea = 0.f, v[2 * kNpl];
#pragma unroll
        for (int j = 0; j < kNpl; ++j) {
          const float g = fmaf(cc[j], gyv, carry[j]);   // dL/dh_t
          carry[j] = ab[j] * g;                         // dL/dh_{t-1} part
          const float e = carry[j] * hist[u][j];        // G abar h_{t-1}
          sgb = fmaf(g, bb[j], sgb);
          sea = fmaf(e, al[j], sea);                    // sum e a / ln 2
          dav[j] = fmaf(e, dtv, dav[j]);
          v[j] = g * dtx;                               // d b partial
          v[kNpl + j] = gyv * hist[u + 1][j];           // d c partial
        }
        const float gdt = lane_sum<L>(fmaf(xv, sgb, sea * kLn2));
        const float gx = dtv * lane_sum<L>(sgb);
        if (lane == 0) {
          s_dt[tt * CPB + ch] = gdt;
          s_x[tt * CPB + ch] = gx;
        }
        const int which = reduce_channels<L>(v, wl);
        if ((wl & 3 & ~(L - 1)) == 0)
          s_red[((warp * T + tt) * 2 + (which >> 2)) * ST + lane * kNpl +
                (which & 3)] = v[0];
      }
    }
    __syncthreads();
    // this block's d b and d c for the tile: the warps summed in order
    for (int i = threadIdx.x; i < T * 2 * ST; i += NT) {
      const int tt = i / (2 * ST), wh = (i / ST) & 1, j = i % ST;
      const int t = t0 + tt;
      if (t < S && j < n) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < Geo::kWarps; ++w)
          s += s_red[((w * T + tt) * 2 + wh) * ST + j];
        (wh ? out_c : out_b)[part + static_cast<int64_t>(t) * n + j] = s;
      }
    }
    for (int i = threadIdx.x; i < T * CPB; i += NT) {
      const int t = t0 + i / CPB, dd = d0 + i % CPB;
      if (t < S && dd < D) {
        const int64_t off = seq + static_cast<int64_t>(t) * D + dd;
        ddt[off] = s_dt[i];
        dx[off] = s_x[i];
      }
    }
  }
  if (d < D) {
#pragma unroll
    for (int j = 0; j < kNpl; ++j) {
      const int st = lane * kNpl + j;
      if (st < n) {
        dh0[chan + st] = carry[j];
        da_seq[chan + st] = dav[j];
      }
    }
  }
}

// With more than one block in D, d b / d c: per-block partials (B, nblk,
// S, n) summed over blocks in block order.  d a: per-sequence (B, D, n)
// summed over each group's sequences in order.  One thread per output
// element.
__global__ void __launch_bounds__(kThreads)
ssm_bwd_reduce_kernel(const float* __restrict__ part_b,
                      const float* __restrict__ part_c,
                      const float* __restrict__ da_seq,
                      float* __restrict__ db, float* __restrict__ dc,
                      float* __restrict__ da, int64_t B, int64_t S,
                      int64_t D, int64_t n, int64_t G, int nblk) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t sn = S * n, m = nblk > 1 ? B * sn : 0;
  if (i < 2 * m) {
    const bool is_c = i >= m;
    const int64_t r = is_c ? i - m : i;
    const float* p = (is_c ? part_c : part_b) + (r / sn) * nblk * sn + r % sn;
    float s = 0.f;
    for (int k = 0; k < nblk; ++k) s += p[static_cast<int64_t>(k) * sn];
    (is_c ? dc : db)[r] = s;
  } else if (i < 2 * m + G * D * n) {
    const int64_t r = i - 2 * m, dn = D * n, per = B / G;
    const float* p = da_seq + (r / dn) * per * dn + r % dn;
    float s = 0.f;
    for (int64_t k = 0; k < per; ++k) s += p[k * dn];
    da[r] = s;
  }
}

bool bad_shape(int64_t B, int64_t S, int64_t D, int64_t n, int64_t G) {
  return B < 1 || S < 1 || D < 1 || n < 1 || n > kMaxN || G < 1 ||
         B % G != 0 || B > 65535 || S > 0x7fffffffLL - 2048 ||
         D > 0x7fffffffLL - kThreads;
}

int64_t bwd_blocks_d(int64_t D) { return (D + kBwdCpb - 1) / kBwdCpb; }

// The card's SMs, read once.
int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || sms < 1)
      sms = 132;
  }
  return sms;
}

// Sub-chunks a forward block walks at once: the smallest SUBS that leaves
// no thread idle (CPB <= D); for sequences of at most kSplitMaxS steps,
// whose walk is too short to hide its latencies, SUBS doubles further while
// the launch gives an SM fewer than 8 warps.  At most 8, and no more than
// the sequence has.  The mamba path's (50, 64, 64, 8) takes 8 (16 channels
// a block), the stage engine's (200, 64, 64, 8) 2, jamba's (2, S, 16384,
// 16) 1.
constexpr int kSplitMaxS = 256;

// Lanes a channel takes without the split.  Past n = 8 a lane holds 8
// states (two lanes a channel, 128 channels a block), which halves the
// lanes' loads of b and c and their sums of y, where those blocks still
// number at least the SMs (jamba's width); else 4 states, 64 channels a
// block.
int seq_lanes(int L, int64_t B, int64_t D) {
  return L == 4 && D >= 128 && B * ((D + 127) / 128) >= sm_count() ? 2 : L;
}

template <int L>
int fwd_subs(int64_t B, int64_t S, int64_t D) {
  const int64_t want = static_cast<int64_t>(sm_count()) * 8;
  int subs = 1;
  while (subs < 8 && subs * kCkpt < S) {
    const int64_t cpb =
        kFwdThreads / ((subs == 1 ? seq_lanes(L, B, D) : L) * subs);
    const int64_t warps = B * ((D + cpb - 1) / cpb) * (kFwdThreads / 32);
    if (cpb <= D && (S > kSplitMaxS || warps >= want)) break;
    subs *= 2;
  }
  return subs;
}

template <typename In, int L, int SUBS, int NPL>
int launch_fwd_subs(const In* dt, const In* b, const In* c,
                    const In* x, const float* a, const float* h0, float* y,
                    float* h_last, float* ckpt, int64_t B, int64_t S,
                    int64_t D, int64_t n, int64_t G, cudaStream_t st) {
  using Geo = FwdGeo<L, SUBS, NPL>;
  constexpr int smem = Geo::template smem_bytes<In>();
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssm_fwd_kernel<In, L, SUBS, NPL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  auto al16 = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  // dt and x rows in 16-byte copies of 4 fp32 or 8 bf16 elements, or in
  // 8-byte copies of 4 bf16
  const int dvec = D % 4 != 0 || !al16(dt) || !al16(x)
                       ? 0
                       : (!std::is_same<In, float>::value && D % 8 == 0 ? 8
                                                                       : 4);
  const bool vec_n = n % 4 == 0 && al16(b) && al16(c) &&
                     (ckpt == nullptr || al16(ckpt));
  const dim3 grid(static_cast<unsigned>((D + Geo::kCpb - 1) / Geo::kCpb),
                  static_cast<unsigned>(B));
  ssm_fwd_kernel<In, L, SUBS, NPL><<<grid, kFwdThreads, smem, st>>>(
      dt, b, c, x, a, h0, y, h_last, ckpt, static_cast<int>(S),
      static_cast<int>(D), static_cast<int>(n), static_cast<int>(B / G),
      dvec, vec_n);
  return static_cast<int>(cudaGetLastError());
}

template <typename In, int L>
int launch_fwd(const In* dt, const In* b, const In* c,
               const In* x, const float* a, const float* h0, float* y,
               float* h_last, float* ckpt, int64_t B, int64_t S, int64_t D,
               int64_t n, int64_t G, cudaStream_t st) {
  switch (fwd_subs<L>(B, S, D)) {
    case 1:
      if (L == 4 && seq_lanes(L, B, D) == 2)
        return launch_fwd_subs<In, 2, 1, 2 * kNpl>(dt, b, c, x, a, h0, y, h_last,
                                               ckpt, B, S, D, n, G, st);
      return launch_fwd_subs<In, L, 1, kNpl>(dt, b, c, x, a, h0, y, h_last, ckpt,
                                         B, S, D, n, G, st);
    case 2: return launch_fwd_subs<In, L, 2, kNpl>(dt, b, c, x, a, h0, y, h_last,
                                               ckpt, B, S, D, n, G, st);
    case 4: return launch_fwd_subs<In, L, 4, kNpl>(dt, b, c, x, a, h0, y, h_last,
                                               ckpt, B, S, D, n, G, st);
    default: return launch_fwd_subs<In, L, 8, kNpl>(dt, b, c, x, a, h0, y,
                                                h_last, ckpt, B, S, D, n, G,
                                                st);
  }
}

template <int L>
int launch_bwd(const float* dt, const float* b, const float* c,
               const float* x, const float* a, const float* ckpt,
               const float* gy, const float* ghl, float* ddt, float* dx,
               float* dh0, float* da_seq, float* out_b, float* out_c,
               int64_t B, int64_t S, int64_t D, int64_t n, int64_t G,
               cudaStream_t st) {
  using Geo = BwdGeo<L>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssm_bwd_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Geo::kSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  const dim3 grid(static_cast<unsigned>(bwd_blocks_d(D)),
                  static_cast<unsigned>(B));
  ssm_bwd_kernel<L><<<grid, Geo::kThreads, Geo::kSmemBytes, st>>>(
      dt, b, c, x, a, ckpt, gy, ghl, ddt, dx, dh0, da_seq, out_b, out_c,
      static_cast<int>(S), static_cast<int>(D), static_cast<int>(n),
      static_cast<int>(B / G));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Steps between the forward's checkpoints of h (the checkpoint buffer is
// (B, ceil(S / steps), D, n) floats).
extern "C" int repro_ssm_scan_ckpt_steps() { return kCkpt; }

// Floats of scratch the backward needs: with more than one block in D the
// per-block partials of d b and d c, 2 * B * nblk * S * n; and the
// per-sequence d a, B * D * n.
extern "C" int64_t repro_ssm_scan_bwd_workspace(int64_t B, int64_t S,
                                                int64_t D, int64_t n) {
  const int64_t nblk = bwd_blocks_d(D);
  return (nblk > 1 ? 2 * B * nblk * S * n : 0) + B * D * n;
}

template <typename In>
static int fwd(const void* dt, const void* b, const void* c, const void* x,
        const float* a, const float* h0, float* y, float* h_last, float* ckpt,
        int64_t B, int64_t S, int64_t D, int64_t n, int64_t G,
        cudaStream_t st) {
  const In* dt_ = static_cast<const In*>(dt);
  const In* b_ = static_cast<const In*>(b);
  const In* c_ = static_cast<const In*>(c);
  const In* x_ = static_cast<const In*>(x);
  switch (lanes_for(n)) {
    case 1: return launch_fwd<In, 1>(dt_, b_, c_, x_, a, h0, y, h_last, ckpt, B,
                                    S, D, n, G, st);
    case 2: return launch_fwd<In, 2>(dt_, b_, c_, x_, a, h0, y, h_last, ckpt, B,
                                    S, D, n, G, st);
    default: return launch_fwd<In, 4>(dt_, b_, c_, x_, a, h0, y, h_last, ckpt,
                                     B, S, D, n, G, st);
  }
}

// Forward.  dt, b, c, x fp32, or bf16 when ``in_bf16``; a, h0 and the
// outputs fp32.  ckpt may be null (no backward will follow).  Returns
// cudaGetLastError() after the launch.
extern "C" int repro_ssm_scan_fwd(const void* dt, const void* b,
                                  const void* c, const void* x,
                                  const float* a, const float* h0, float* y,
                                  float* h_last, float* ckpt, int64_t B,
                                  int64_t S, int64_t D, int64_t n, int64_t G,
                                  int in_bf16, void* stream) {
  if (bad_shape(B, S, D, n, G)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_bf16)
    return fwd<__nv_bfloat16>(dt, b, c, x, a, h0, y, h_last, ckpt, B, S, D, n,
                              G, st);
  return fwd<float>(dt, b, c, x, a, h0, y, h_last, ckpt, B, S, D, n, G, st);
}

// Backward: the walk kernel, then the reduce kernel, on one stream.  With
// one block in D the walk writes d b and d c itself and the reduce kernel
// only sums d a.  ``work`` holds repro_ssm_scan_bwd_workspace(B, S, D, n)
// floats.  Returns cudaGetLastError() after the launches.
extern "C" int repro_ssm_scan_bwd(const float* dt, const float* b,
                                  const float* c, const float* x,
                                  const float* a, const float* ckpt,
                                  const float* gy, const float* ghl,
                                  float* ddt, float* db, float* dc, float* dx,
                                  float* da, float* dh0, float* work,
                                  int64_t B, int64_t S, int64_t D, int64_t n,
                                  int64_t G, void* stream) {
  if (bad_shape(B, S, D, n, G)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t nblk = bwd_blocks_d(D);
  float* part_b = nblk > 1 ? work : db;
  float* part_c = nblk > 1 ? part_b + B * nblk * S * n : dc;
  float* da_seq = nblk > 1 ? part_c + B * nblk * S * n : work;
  int err;
  switch (lanes_for(n)) {
    case 1: err = launch_bwd<1>(dt, b, c, x, a, ckpt, gy, ghl, ddt, dx, dh0,
                                da_seq, part_b, part_c, B, S, D, n, G, st);
            break;
    case 2: err = launch_bwd<2>(dt, b, c, x, a, ckpt, gy, ghl, ddt, dx, dh0,
                                da_seq, part_b, part_c, B, S, D, n, G, st);
            break;
    default: err = launch_bwd<4>(dt, b, c, x, a, ckpt, gy, ghl, ddt, dx, dh0,
                                 da_seq, part_b, part_c, B, S, D, n, G, st);
  }
  if (err != 0) return err;
  const int64_t total = (nblk > 1 ? 2 * B * S * n : 0) + G * D * n;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  ssm_bwd_reduce_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      part_b, part_c, da_seq, db, dc, da, B, S, D, n, G,
      static_cast<int>(nblk));
  return static_cast<int>(cudaGetLastError());
}
