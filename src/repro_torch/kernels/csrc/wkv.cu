// RWKV-6 WKV recurrence for Hopper, forward and backward.  Per sequence b
// and head h, with N = head dim, w_t = exp(lw_t) and an (N x N) state S
// (key i x value j) starting at h0:
//   y_t[j] = sum_i r_t[i] (S_{t-1}[i,j] + u[i] k_t[i] v_t[j])
//   S_t    = diag(w_t) S_{t-1} + k_t^T v_t
// r, k, v, lw, y: (B, S, H, N), read and written in that layout; u: (G, H, N)
// with sequence b using u[b / (B/G)]; h0, h_last: (B, H, N, N).  All fp32,
// contiguous, N <= 64.
//
// Replaces the Pallas TPU kernel wkv_kernel in src/repro/kernels/wkv/
// kernel.py (forward) and the oracle VJP that src/repro/kernels/wkv/ops.py:
// 51-53 uses as its backward.
//
// What bounds it on an H100.  Per (sequence, step, head) the forward reads
// r, k, v, lw and writes y: 20 N bytes, and does 2 FMAs per state element
// (N^2 of them).  At rwkv6-3b's shape (B=8, S=4096, H=40, N=64) that is
// 1.68 GB (0.50 ms at 3.35 TB/s) against 2.1e10 FLOP (0.32 ms at 67 TFLOP/s
// fp32): bytes bound it, operations close behind.  The backward needs
// about 6 FMAs per state element per step and moves about twice the bytes.
// The recurrence is sequential in t, so the parallelism is over (B, H)
// heads and, inside a head, over the state.  In practice a step issues at
// least 3 FP32 instructions a state element (k v, the y FMA, the S FMA),
// and every element needs its row's r, k, w and its column's v from shared
// memory: 3 floats an element where a thread holds one column, 1 where it
// holds a 4 x 4 tile, which keeps those loads under the FP32 work.
//
// Forward design (wkv_fwd_kernel).
//   * A thread holds a 4 x 4 tile of S (rows 4 rg .. + 3, columns 4 c ..
//     + 3; 4 x 1 at NP = 16, N rounded up to NP = 16, 32, 64), so a step
//     reads one float4 each of r, k, w and v for 16 elements.  y's sum over
//     the NP/4 row groups, which lie in the low lane bits, is a reduce-
//     scatter inside the warp every NP/16 steps (every 4 at NP = 16), each
//     lane storing one y.
//   * The u term is folded into the row sum a 4-row group at a time: y_j =
//     sum_g (sum_{i in g} r_i S_ij + v_j sum_{i in g} r_i u_i k_i), the
//     Pallas kernel's r (S + u k v) in that order; a group's sum of r u k
//     is formed once a step in the staging pass by the thread that copied
//     that group's r, k and lw, so the walk issues 3 instructions an element
//     and there is no pass or barrier of its own.
//   * Tiles of T = 1024 / NP steps (the federated paths' S = 64 at NP = 16
//     is one tile) of r, k, lw and the block's columns of v are copied by
//     cp.async in chunks of 4 floats (16 bytes where rows are aligned),
//     double-buffered in dynamic shared memory; a thread turns the lw chunks
//     it copied into w = exp(lw) once they land; one barrier a tile.
//   * Steps run in unrolled groups of 8 with no branch inside; the
//     checkpoint (every kCkpt = 64 steps, a (B, H, ceil(S/64), N, N)
//     buffer) is written between groups.
//   * Route: heads of NP = 64 (256 threads) are split into 2 or 4 blocks by
//     columns (each restaging the row vectors) where that fills SMs or
//     evens their load: rwkv6-3b's 320 heads run as 640 blocks of 128
//     threads, at most 5 halves an SM instead of 3 whole heads (fwd_cg).
//   * Chunk parallelism was tried and is not kept: at rwkv6-3b's full width
//     the walk over every 64-step chunk as a sequence of its own, which a
//     chunk-parallel forward would run after its chunk-state pass and
//     combine, already takes longer than this whole forward (chip_smoke.py,
//     case chunk_walk_proxy).
// Backward.  With G_t the cotangent of S_t (G seeded from the h_last
// cotangent), walking t down:
//   dr_t[i]  = sum_j gy_t[j] S_{t-1}[i,j] + u[i] k_t[i] (gy_t . v_t)
//   dk_t[i]  = sum_j G_t[i,j] v_t[j]     + u[i] r_t[i] (gy_t . v_t)
//   dv_t[j]  = sum_i G_t[i,j] k_t[i]     + (sum_i r_t u k_t) gy_t[j]
//   dlw_t[i] = w_t[i] sum_j G_t[i,j] S_{t-1}[i,j]
//   du[i]   += r_t[i] k_t[i] (gy_t . v_t)
//   G_{t-1}  = diag(w_t) G_t + r_t^T gy_t,    dh0 = G_{-1}.
// S_{t-1} runs forward and G backward, and S_{t-1} cannot be rebuilt by
// dividing by w (w reaches 2e-9).  Recomputing it from the checkpoints
// inside the one sequential block per head costs about 7 state updates a
// step, none of it parallel.  So S_{t-1} enters the reverse walk only
// through two per-row sums that a chunk-parallel forward sweep writes out:
//   dr'_t = S_{t-1} gy_t          (dr_t without its u term)
//   a_t   = S_{t-1} gy_{t+1}.
// dlw needs the rest.  With P_t = rowsum(G_t * S_t), expanding S_t gives
// P_t = dlw_t + k_t (G_t v_t) and expanding G_{t-1} gives P_{t-1} = dlw_t +
// r_t dr'_t, an exact identity, but in fp32 dlw_t = P_t - k_t (G_t v_t)
// loses all its digits when w_t is small (at the clip, dlw ~ 1e-9 against
// P ~ 1).  Expanding both one step further, the term w_t w_{t+1} rowsum(
// G_{t+1} * S_{t-1}) is common to dlw_t and dlw_{t+1}, so
//   dlw_t = dlw_{t+1} + w_t r_{t+1} a_t - k_t (w_{t+1} G_{t+1} v_t),
// whose terms all carry a decay: the running sum keeps its relative
// precision at every w (tests/test_torch_rwkv6.py holds the algorithm to
// jax.vjp with decays near 1, the model's and the clip's; chip_smoke.py
// the kernel to autograd).  It starts from the direct dlw_{S-1} = w_{S-1}
// rowsum(ghl * S_{S-2}).
//   Sweep A (wkv_bwd_a_kernel): one block per (sequence, head, 64-step
// chunk), 20,480 blocks at rwkv6-3b; from the chunk's checkpoint it walks
// S forward and writes dr' into dr and a into dlw.  2 FMAs per state
// element per step plus 1 for a.
//   Sweep B (wkv_bwd_b_kernel): one block per head, t down, G in registers.
// A tile of 1024/NP steps is copied by cp.async (the next one in flight);
// a pass over the tile's elements forms w = exp(lw), e_t = w_t r_{t+1} a_t,
// dr_t = dr'_t + u k_t (gy_t . v_t) (written in place) and du's terms;
// then per step G_t v_t, G_t v_{t-1}, G_t^T k_t and the G update: 5 flops
// per state element, no checkpoint read, no state recomputed.
//   Layout (both sweeps): the sums over j dominate, so a warp holds 8 rows
// and lane = g CG + c splits them into row groups g and column groups c
// (columns 4c .. 4c+3, CG = NP/4); a thread's NP/16 rows share one float4
// of every column vector a step, so a step costs a lane 16 bytes of each
// staged vector (one shared-memory wavefront a quarter-warp).  Row sums
// are reduce-scattered over the CG lanes, leaving each row's dk and dlw in
// one fixed lane; dv's sum over rows is taken in-thread, reduce-scattered
// over the warp's row groups and summed over the warps in order twice a
// tile.  Steps are unrolled in groups of 8 with no branch inside, so
// their shared-memory and shuffle latencies overlap.
//   A sequence of at most one tile and one chunk (S = 64 with N <= 16, as
// on the federated paths) runs sweep A's walk inside sweep B's block, from
// h0, into the tile's shared rows: one launch instead of two.
// du is summed over t per thread in a fixed order and over a group's
// sequences, in order, by wkv_bwd_du_kernel.  No atomics: every run gives
// the same result.
// Every offset into a (B, S, H, N)-sized array is 64-bit.  Ragged S and N
// are masked in the kernels; nothing is padded.
//
// bf16 operands.  The TPU kernel widens each load of r, k, v and lw to
// fp32 (kernel.py's ``.astype(jnp.float32)``) and writes f32.  The forward
// is templated on their type In: for bf16 a thread copies its chunks of 4
// elements (8 bytes) by cp.async into a bf16 staging tile while the last
// tile is walked, and widens them into the same fp32 tile that cp.async
// fills for fp32 once they land, before its exp and r u k pass; rows that
// are not 8-byte aligned (N not a multiple of 4) are loaded an element at
// a time, synchronously.  The walk is the same code, so a bf16 call gives
// the bits of the fp32 call on the widened operands.  u, h0, y, h_last and
// the checkpoints stay fp32; the backward is fp32 only, and the wrapper
// widens saved bf16 operands once for it.
#include <cstdint>
#include <initializer_list>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kMaxN = 64;
constexpr int kCkpt = 64;        // steps between the forward's checkpoints
constexpr unsigned kFull = 0xffffffffu;

// A thread's p-th element (p < NP/4) of group g: 16 (p/4) + 4 g + p%4.
__device__ __forceinline__ int elem(int g, int p) {
  return 16 * (p >> 2) + 4 * g + (p & 3);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// The backward's layout of an (NP x NP) state or cotangent over the block's
// 4 NP threads: a warp holds 8 rows; lane = g CG + c, where c < CG = NP/4
// is the column group (columns 4c .. 4c+3, one float4 of a step's gy or v)
// and g < 32/CG the row group (rows 8 warp + RPT g + m, m < RPT = NP/16).
// A thread's 4 RPT elements share one float4 of every column vector, so a
// step reads 16 bytes a lane of each.
template <int NP>
struct RowGeo {
  static constexpr int CG = NP / 4, RPT = NP / 16, GROUPS = 32 / CG;
};

// One halving level of a reduce-scatter over lanes ``off`` apart: of the
// CNT values v[0..CNT), a lane keeps the upper half if ``upper`` and the
// lower half otherwise, summed with its partner's copy, in v[0..CNT/2).
template <int CNT, int K>
__device__ __forceinline__ void halve(float (&v)[K], int off, bool upper) {
  constexpr int HALF = CNT / 2;
#pragma unroll
  for (int q = 0; q < HALF; ++q) {
    const float send = upper ? v[q] : v[q + HALF];
    const float keep = upper ? v[q + HALF] : v[q];
    v[q] = keep + __shfl_xor_sync(kFull, send, off);
  }
}

// Sum v[0..CNT) over the lanes that differ in bits OFF, OFF/2, .. LOW:
// halving levels from the top while more than one value is left, then full
// sums.  Returns the index of the first value the lane keeps (in v[0..)).
template <int CNT, int OFF, int LOW, int K>
__device__ __forceinline__ int rs_sum(float (&v)[K], int lane) {
  if constexpr (OFF < LOW || OFF == 0) {
    return 0;
  } else if constexpr (CNT > 1) {
    const bool up = lane & OFF;
    halve<CNT, K>(v, OFF, up);
    return (up ? CNT / 2 : 0) + rs_sum<CNT / 2, OFF / 2, LOW, K>(v, lane);
  } else {
    v[0] += __shfl_xor_sync(kFull, v[0], OFF);
    return rs_sum<1, OFF / 2, LOW, K>(v, lane);
  }
}

// RPT consecutive floats of shared memory (RPT = 1, 2, 4), as one load.
template <int RPT>
__device__ __forceinline__ void ld_rows(const float* p, float (&x)[RPT]) {
  if constexpr (RPT == 4) {
    const float4 a = ld4(p);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  } else if constexpr (RPT == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    x[0] = a.x; x[1] = a.y;
  } else {
    x[0] = p[0];
  }
}

// x[m] for a lane-dependent m, without indexing registers.
template <int RPT>
__device__ __forceinline__ float pick(const float (&x)[RPT], int m) {
  float r = x[0];
#pragma unroll
  for (int q = 1; q < RPT; ++q) r = m == q ? x[q] : r;
  return r;
}

// 4 bytes into shared memory, or zeros when ``ok`` is false (nothing is
// read then).
// one bf16 element widened into an fp32 tile by a plain load (zero when
// ``ok`` is false)
__device__ __forceinline__ void widen1(float* dst, const __nv_bfloat16* src,
                                       bool ok) {
  *dst = ok ? __bfloat162float(*src) : 0.f;
}

// Issue the copies of steps t0 .. t0+R-1 of one head's (S, N) rows (stride
// ``stride`` between steps) into sh[R][NP], zeros outside [0, S) and N: 16
// bytes a copy where ``vec`` (N % 4 == 0 and 16-byte aligned arrays), else
// 4.
template <int R, int NP>
__device__ __forceinline__ void issue_rows(float* sh,
                                           const float* __restrict__ src,
                                           int64_t stride, int t0, int S,
                                           int N, bool vec) {
  if (vec) {
    for (int x = threadIdx.x; x < R * NP / 4; x += 4 * NP) {
      const int t = t0 + x / (NP / 4), i = 4 * (x % (NP / 4));
      const bool ok = t >= 0 && t < S && i < N;
      cp_async16(sh + 4 * x,
                 ok ? src + static_cast<int64_t>(t) * stride + i : src, ok);
    }
  } else {
    for (int x = threadIdx.x; x < R * NP; x += 4 * NP) {
      const int t = t0 + x / NP, i = x % NP;
      const bool ok = t >= 0 && t < S && i < N;
      cp_async4(sh + x, ok ? src + static_cast<int64_t>(t) * stride + i : src,
                ok);
    }
  }
}

// The forward's geometry.  A thread holds a 4-row x CPT-column tile of S
// (CPT = 4 from NP = 32 on, 1 at NP = 16); RG = NP / 4 row groups lie in
// the low lane bits, so y's sum over rows is a reduce-scatter inside the
// warp.  A block runs NPC = NP / CG of a head's columns (column j of S
// depends only on v[j] and the row vectors) and walks tiles of T = 1024 /
// NP steps (64 at NP = 16: the federated paths' S = 64 is one tile).
// The forward's geometry.  A thread holds a 4-row x CPT-column tile of S
// (CPT = 4 from NP = 32 on, 1 at NP = 16); the RG = NP / 4 row groups lie
// in the low lane bits, so y's sum over rows is a reduce-scatter inside the
// warp.  A block runs NPC = NP / CG of a head's columns (column j of S
// depends only on v[j] and the row vectors) and walks tiles of T = 1024 /
// NP steps (64 at NP = 16: the federated paths' S = 64 is one tile).
template <int NP, int CG>
struct FwdGeo {
  static constexpr int kRg = NP / 4, kCpt = NP >= 32 ? 4 : 1;
  static constexpr int kNpc = NP / CG, kThreads = kRg * (kNpc / kCpt);
  static constexpr int kRss = kRg / kCpt;   // steps a sum over rows covers
  static constexpr int kT = 1024 / NP;
  // 4-float chunks of a tile's r, k, lw rows and v columns a thread copies
  static constexpr int kRowChunks = kT * NP / 4 / kThreads;
  static constexpr int kColChunks = kT * kNpc / 4 / kThreads;
  // r, k, lw (then w), v; sum_i r_i u_i k_i of each row group and step
  static constexpr int kBuf = 3 * kT * NP + kT * kNpc + kT * kRg;
  static constexpr int kSmemBytes = 4 * (2 * kBuf + NP);    // and u
  // a tile's r, k, lw rows and v columns in bf16 (the bf16 route's staging)
  static constexpr int kStageBytes = 2 * (3 * kT * NP + kT * kNpc);
  static_assert(kThreads % 32 == 0 && 8 % kRss == 0 && kNpc % kCpt == 0 &&
                    kCkpt % kT == 0 && kT % 8 == 0,
                "whole warps, whole tiles a checkpoint, whole step groups");
  static_assert(kRowChunks * kThreads * 4 == kT * NP &&
                    kColChunks * kThreads * 4 == kT * kNpc,
                "every thread copies the same number of chunks");
};

// The forward.  Thread (rg, c) holds rows 4 rg .. 4 rg + 3 and columns
// c0 + CPT c .. + CPT - 1 of S in registers, so a step reads one float4 of
// r, k and w and CPT floats of v from shared memory for 4 CPT state
// elements.  Tiles of r, k, lw and the block's columns of v are copied by
// cp.async in chunks of 4 floats of a row (one 16-byte copy where rows
// allow, else four of 4 bytes) into one of two buffers while the other is
// walked.  Once its copies land, a thread turns the lw chunks it copied
// into w = exp(lw) and sums r_i u_i k_i over the same chunks' 4 rows (its
// r and k chunks are the same rows); one barrier a tile follows.  The u
// term thus enters the row sum per 4-row group,
//   y_j = sum_g (sum_{i in g} r_i S_ij + v_j sum_{i in g} r_i u_i k_i),
// the Pallas kernel's y = r (S + u k v) summed in that order.  Steps run in
// unrolled groups of 8 with no branch inside (steps past S: zero k, v and
// w = 1 leave S alone); every RSS steps the RSS x CPT = RG partial sums of
// y are reduce-scattered over the RG row groups, each lane storing one.
// The checkpoint is written between groups, every kCkpt steps.
template <typename In, int NP, int CG>
__global__ void __launch_bounds__(FwdGeo<NP, CG>::kThreads,
                                  640 / FwdGeo<NP, CG>::kThreads)
wkv_fwd_kernel(const In* __restrict__ r, const In* __restrict__ k,
               const In* __restrict__ v, const In* __restrict__ lw,
               const float* __restrict__ u, const float* __restrict__ h0,
               float* __restrict__ y, float* __restrict__ h_last,
               float* __restrict__ ckpt, int S, int H, int N, int per_group,
               bool vec) {
  using Geo = FwdGeo<NP, CG>;
  constexpr int NPC = Geo::kNpc, NT = Geo::kThreads, RG = Geo::kRg;
  constexpr int CPT = Geo::kCpt, RSS = Geo::kRss, T = Geo::kT;
  constexpr int RC = Geo::kRowChunks, CC = Geo::kColChunks;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, rg = threadIdx.x % RG;
  const int cc = threadIdx.x / RG;
  const int bh = blockIdx.x / CG, c0 = (blockIdx.x % CG) * NPC;
  const int j0 = c0 + CPT * cc, i0 = 4 * rg;  // the thread's first column, row
  const int b = bh / H, h = bh % H;
  const int64_t stride = static_cast<int64_t>(H) * N;
  const int64_t seq = static_cast<int64_t>(b) * S * stride + h * N;
  const int64_t st = static_cast<int64_t>(bh) * N * N;
  const float* ug = u + (static_cast<int64_t>(b / per_group) * H + h) * N;
  const int nck = (S + kCkpt - 1) / kCkpt;
  // bf16 rows that are 8-byte aligned stage here, laid out as a tile's
  // first 3 T NP + T NPC floats (r, k, lw, v)
  constexpr bool kBf16 = !std::is_same<In, float>::value;
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(
      smem + 2 * Geo::kBuf + NP);

  // Copy chunk x (step x / (W/4), floats 4 (x % (W/4)) .. + 3 of a row of
  // W) of steps t0 .. t0+T-1 of ``src`` to offset ``off`` of ``buf`` (or
  // of the staging tile); zeros past S and ``cols``.
  auto copy = [&](float* buf, int off, const In* __restrict__ src, int W,
                  int x, int t0, int cols) {
    const int t = t0 + x / (W / 4), i = 4 * (x % (W / 4));
    const In* p = src + static_cast<int64_t>(t) * stride + i;
    if (vec) {
      const bool ok = t < S && i < cols;
      if constexpr (kBf16)
        cp_async8(stage + off + 4 * x, ok ? p : src, ok);
      else
        cp_async16(buf + off + 4 * x, ok ? p : src, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = t < S && i + e < cols;
        if constexpr (kBf16)
          widen1(buf + off + 4 * x + e, ok ? p + e : src, ok);
        else
          cp_async4(buf + off + 4 * x + e, ok ? p + e : src, ok);
      }
    }
  };
  // Issue the copies of tile ``tile`` into ``buf``.
  auto issue = [&](int tile, float* buf) {
    const int t0 = tile * T;
#pragma unroll
    for (int q = 0; q < RC; ++q) {
      const int x = threadIdx.x + q * NT;
      copy(buf, 0, r + seq, NP, x, t0, N);
      copy(buf, T * NP, k + seq, NP, x, t0, N);
      copy(buf, 2 * T * NP, lw + seq, NP, x, t0, N);
    }
#pragma unroll
    for (int q = 0; q < CC; ++q)
      copy(buf, 3 * T * NP, v + seq + c0, NPC, threadIdx.x + q * NT, t0,
           N - c0);
    cp_async_commit();
  };

  float* s_u = smem + 2 * Geo::kBuf;
  for (int i = threadIdx.x; i < NP; i += NT) s_u[i] = i < N ? ug[i] : 0.f;
  __syncthreads();
  float s[4][CPT];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
#pragma unroll
    for (int e = 0; e < CPT; ++e)
      s[m][e] = (i0 + m < N && j0 + e < N) ? h0[st + (i0 + m) * N + j0 + e]
                                           : 0.f;
  }
  const int ntile = (S + T - 1) / T;
  issue(0, smem);
  for (int tile = 0, pb = 0; tile < ntile; ++tile, pb ^= 1) {
    float* buf = smem + pb * Geo::kBuf;
    const float* s_r = buf;
    const float* s_k = buf + T * NP;
    float* s_w = buf + 2 * T * NP;                 // lw, then w
    const float* s_v = buf + 3 * T * NP;
    float* s_ruk = buf + 3 * T * NP + T * NPC;     // [T][RG]
    cp_async_wait_all();
    if (kBf16 && vec) {   // the staged chunks this thread copied, widened
#pragma unroll
      for (int q = 0; q < RC; ++q) {
        const int x = threadIdx.x + q * NT;
#pragma unroll
        for (int a = 0; a < 3; ++a)
          widen4(buf + a * T * NP + 4 * x, stage + a * T * NP + 4 * x);
      }
#pragma unroll
      for (int q = 0; q < CC; ++q) {
        const int x = threadIdx.x + q * NT;
        widen4(buf + 3 * T * NP + 4 * x, stage + 3 * T * NP + 4 * x);
      }
    }
    // the chunks this thread copied: w = exp(lw) (zeros, past S and N,
    // give w = 1) and the chunk's sum of r u k
#pragma unroll
    for (int q = 0; q < RC; ++q) {
      const int x = threadIdx.x + q * NT;
      const float4 l4 = ld4(s_w + 4 * x);
      *reinterpret_cast<float4*>(s_w + 4 * x) =
          make_float4(expf(l4.x), expf(l4.y), expf(l4.z), expf(l4.w));
      const float4 r4 = ld4(s_r + 4 * x), k4 = ld4(s_k + 4 * x);
      const float4 u4 = ld4(s_u + 4 * (x % (NP / 4)));
      s_ruk[x] = fmaf(r4.w * u4.w, k4.w,
                      fmaf(r4.z * u4.z, k4.z,
                           fmaf(r4.y * u4.y, k4.y, r4.x * u4.x * k4.x)));
    }
    __syncthreads();        // the tile is in; the last tile's reads are done
    if (tile + 1 < ntile) issue(tile + 1, smem + (pb ^ 1) * Geo::kBuf);
    const int t0 = tile * T;
#pragma unroll 1
    for (int r0 = 0; r0 < T; r0 += 8) {
      const int t = t0 + r0;
      if (t >= S) break;                          // uniform over the block
      if (ckpt != nullptr && t % kCkpt == 0) {
        float* dst = ckpt + (static_cast<int64_t>(bh) * nck + t / kCkpt) * N * N;
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int e = 0; e < CPT; ++e)
            if (i0 + m < N && j0 + e < N) dst[(i0 + m) * N + j0 + e] = s[m][e];
      }
#pragma unroll
      for (int q0 = 0; q0 < 8; q0 += RSS) {
        float yv[RG];     // RSS steps x CPT columns of y, partial over rows
#pragma unroll
        for (int q = 0; q < RSS; ++q) {
          const int tt = r0 + q0 + q;
          const float4 r4 = ld4(&s_r[tt * NP + i0]);
          const float4 k4 = ld4(&s_k[tt * NP + i0]);
          const float4 w4 = ld4(&s_w[tt * NP + i0]);
          const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
          const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
          const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
          float vv[CPT];
          ld_rows<CPT>(&s_v[tt * NPC + CPT * cc], vv);
          const float ruk = s_ruk[tt * RG + rg];
#pragma unroll
          for (int e = 0; e < CPT; ++e) yv[q * CPT + e] = 0.f;
#pragma unroll
          for (int m = 0; m < 4; ++m)
#pragma unroll
            for (int e = 0; e < CPT; ++e) {
              const float x = s[m][e];
              yv[q * CPT + e] = fmaf(rr[m], x, yv[q * CPT + e]);
              s[m][e] = fmaf(ww[m], x, kk[m] * vv[e]);
            }
#pragma unroll
          for (int e = 0; e < CPT; ++e)
            yv[q * CPT + e] = fmaf(vv[e], ruk, yv[q * CPT + e]);
        }
        // the sum over the RG row groups: lane rg keeps (step, column)
        // pair rg of the RSS x CPT
        const int f = rs_sum<RG, RG / 2, 1, RG>(yv, lane);
        const int tq = t + q0 + f / CPT, jq = j0 + f % CPT;
        if (tq < S && jq < N)
          y[seq + static_cast<int64_t>(tq) * stride + jq] = yv[0];
      }
    }
  }
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int e = 0; e < CPT; ++e)
      if (i0 + m < N && j0 + e < N) h_last[st + (i0 + m) * N + j0 + e] = s[m][e];
}

// Sweep A's walk over one chunk for the thread's rows of S (sv, the state
// before step c0): from step tt's k, w (= exp(lw)), v, gy and gy of step
// tt + 1 (rows of NP floats from the chunk's first step),
//   dr'_t = S_{t-1} gy_t,  a_t = S_{t-1} gy_{t+1}  (at t = S-1 the direct
//   dlw_{S-1} = w_{S-1} rowsum(ghl * S_{S-2}) in place of a_t),
// then S_t.  store(is_a, i, t, value) keeps the lane's row sum of row i.
// The steps before S-1 run in unrolled groups of 8 whose steps past the
// chunk (zero k, w = 1) leave S alone and store nothing; no branch inside,
// so the steps overlap.
template <int NP, typename Store>
__device__ __forceinline__ void a_walk(
    float (&sv)[RowGeo<NP>::RPT][4], const float* s_k, const float* s_w,
    const float* s_v, const float* s_gy, int c0, int len, int S, int N,
    const float* __restrict__ ghl_h, Store store) {
  using Geo = RowGeo<NP>;
  constexpr int CG = Geo::CG, RPT = Geo::RPT, K2 = 2 * RPT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = lane % CG, row0 = 8 * warp + RPT * (lane / CG);
  auto step = [&](int tt, bool live, bool last) {
    const float4 g4 = ld4(&s_gy[tt * NP + 4 * c]);
    const float4 n4 = ld4(&s_gy[(tt + 1) * NP + 4 * c]);
    const float4 v4 = ld4(&s_v[tt * NP + 4 * c]);
    const float gg[4] = {g4.x, g4.y, g4.z, g4.w};
    const float nn[4] = {last ? 0.f : n4.x, last ? 0.f : n4.y,
                         last ? 0.f : n4.z, last ? 0.f : n4.w};
    const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
    float kr[RPT], wr[RPT], acc[K2];
    ld_rows<RPT>(&s_k[tt * NP + row0], kr);
    ld_rows<RPT>(&s_w[tt * NP + row0], wr);
#pragma unroll
    for (int m = 0; m < RPT; ++m) {
      kr[m] = live ? kr[m] : 0.f;
      wr[m] = live ? wr[m] : 1.f;
    }
#pragma unroll
    for (int q = 0; q < K2; ++q) acc[q] = 0.f;
    if (last) {
#pragma unroll
      for (int m = 0; m < RPT; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = row0 + m, j = 4 * c + e;
          if (i < N && j < N)
            acc[RPT + m] = fmaf(ghl_h[i * N + j], sv[m][e], acc[RPT + m]);
        }
    }
#pragma unroll
    for (int m = 0; m < RPT; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& x = sv[m][e];
        acc[m] = fmaf(gg[e], x, acc[m]);
        acc[RPT + m] = fmaf(nn[e], x, acc[RPT + m]);
        x = fmaf(wr[m], x, kr[m] * vv[e]);
      }
    const int idx = rs_sum<K2, CG / 2, 1, K2>(acc, lane);
    const int m = idx % RPT, i = row0 + m;
    const float val = last && idx >= RPT ? pick<RPT>(wr, m) * acc[0] : acc[0];
    if ((lane & 1) == 0 && live && i < N) store(idx >= RPT, i, c0 + tt, val);
  };
  const int nmain = c0 + len == S ? len - 1 : len;
  for (int t8 = 0; t8 < nmain; t8 += 8) {
#pragma unroll
    for (int uu = 0; uu < 8; ++uu) step(t8 + uu, t8 + uu < nmain, false);
  }
  if (nmain < len) step(len - 1, true, true);
}

// The thread's rows of an (N x N) state at ``src`` into registers, zero
// outside N.
template <int NP>
__device__ __forceinline__ void load_rows(float (&x)[RowGeo<NP>::RPT][4],
                                          const float* __restrict__ src,
                                          int N) {
  using Geo = RowGeo<NP>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = lane % Geo::CG, row0 = 8 * warp + Geo::RPT * (lane / Geo::CG);
#pragma unroll
  for (int m = 0; m < Geo::RPT; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = row0 + m, j = 4 * c + e;
      x[m][e] = (i < N && j < N) ? src[i * N + j] : 0.f;
    }
}

// Sweep A's shared memory, in floats: k, w, v for a chunk; gy for the
// chunk and one step past it.
template <int NP>
__host__ __device__ constexpr int bwd_a_smem_floats() {
  return (4 * kCkpt + 1) * NP;
}

// Sweep A: one block per (sequence, head, 64-step chunk), all chunks at
// once.  From the chunk's checkpoint S_{c0-1}, walk t up with S_{t-1} in
// the row layout and write
//   dr'_t = S_{t-1} gy_t  into dr,   a_t = S_{t-1} gy_{t+1}  into dlw,
// and at t = S-1, in place of a_t, the direct dlw_{S-1} = w_{S-1}
// rowsum(ghl * S_{S-2}).  Sweep B reads both back and overwrites them.
// Steps past S (zero k, v, gy and w = 1) leave S as it is, so the walk runs
// whole groups of 8 steps, unrolled, with the stores masked.
template <int NP>
__global__ void __launch_bounds__(4 * NP, 3)
wkv_bwd_a_kernel(const float* __restrict__ k, const float* __restrict__ v,
                 const float* __restrict__ lw, const float* __restrict__ ckpt,
                 const float* __restrict__ gy, const float* __restrict__ ghl,
                 float* __restrict__ drp, float* __restrict__ anext, int S,
                 int H, int N, bool vec) {
  constexpr int T = kCkpt;
  extern __shared__ __align__(16) float smem[];
  float* s_k = smem;
  float* s_w = s_k + T * NP;                         // lw, then exp(lw)
  float* s_v = s_w + T * NP;
  float* s_gy = s_v + T * NP;                        // T + 1 rows
  const int nck = (S + kCkpt - 1) / kCkpt;
  const int bh = blockIdx.x / nck, ck = blockIdx.x % nck;
  const int b = bh / H, h = bh % H;
  const int c0 = ck * T, len = min(T, S - c0);
  const int64_t stride = static_cast<int64_t>(H) * N;
  const int64_t seq = static_cast<int64_t>(b) * S * stride + h * N;
  const int64_t st = static_cast<int64_t>(bh) * N * N;
  issue_rows<T, NP>(s_k, k + seq, stride, c0, S, N, vec);
  issue_rows<T, NP>(s_w, lw + seq, stride, c0, S, N, vec);
  issue_rows<T, NP>(s_v, v + seq, stride, c0, S, N, vec);
  issue_rows<T + 1, NP>(s_gy, gy + seq, stride, c0, S, N, vec);
  cp_async_commit();
  float sv[RowGeo<NP>::RPT][4];
  load_rows<NP>(sv, ckpt + (static_cast<int64_t>(bh) * nck + ck) * N * N, N);
  cp_async_wait_all();
  __syncthreads();
  for (int x = threadIdx.x; x < T * NP; x += 4 * NP) s_w[x] = expf(s_w[x]);
  __syncthreads();
  a_walk<NP>(sv, s_k, s_w, s_v, s_gy, c0, len, S, N, ghl + st,
             [&](bool is_a, int i, int t, float val) {
               (is_a ? anext : drp)[seq + static_cast<int64_t>(t) * stride +
                                    i] = val;
             });
}

// Sweep B's steps per tile (1024 / NP: a tile buffer holds the same bytes
// at every NP) and between dv sums (two sums a tile).
template <int NP>
__host__ __device__ constexpr int bwd_b_tile() {
  return 1024 / NP;
}

template <int NP>
__host__ __device__ constexpr int bwd_b_sub() {
  return 512 / NP;
}

// Sweep B's tile buffer, in floats: r for the tile's steps and one past
// them; k, w, a (then e), dr', gy for the steps; v for the steps and the
// one before; gy . v and sum_i r u k per step.
template <int NP>
__host__ __device__ constexpr int bwd_b_buf_floats() {
  return (7 * bwd_b_tile<NP>() + 2) * NP + 2 * bwd_b_tile<NP>();
}

// Sweep B's shared memory: two tile buffers (one when the sequence is one
// tile), the per-warp partials of dv for two sub-chunks, u, and the du
// partials of the 4 NP threads.
template <int NP>
__host__ __device__ constexpr int bwd_b_smem_floats(int buffers) {
  return buffers * bwd_b_buf_floats<NP>() +
         2 * (NP / 8) * bwd_b_sub<NP>() * NP + 5 * NP;
}

// Sweep B: one block per (sequence, head), t down, G_t in registers in the
// row layout, from tiles of 1024 / NP steps copied by cp.async (the next tile
// in flight while this one is walked).  A tile first gets, for all its
// steps at once, gy . v, sum_i r u k, w = exp(lw), e_t = w_t r_{t+1} a_t,
//   dr_t = dr'_t + u k_t (gy_t . v_t)  (written out)  and du's terms.
// Then per step
//   dk_t = G_t v_t + u r_t (gy_t . v_t),  dv_t = G_t^T k_t + (sum r u k) gy_t
//   dlw_t = dlw_{t+1} + e_t - k_t (w_{t+1} G_{t+1} v_t)
//   G_{t-1} = diag(w_t) G_t + r_t^T gy_t.
// dk's and the dlw term's sums over columns are reduce-scattered over the
// row group's lanes, so each row's dk and dlw live in one fixed lane; dv's
// sum over rows is summed in-thread, reduce-scattered over the warp's row
// groups, and summed over the warps in order every half tile.  Steps past
// S leave G and dlw as they are; their stores are masked.
// FUSED (S no longer than one tile and one checkpoint chunk, as on the
// federated paths): the block runs sweep A's walk over its tile itself,
// from h0 (the first checkpoint), into the tile's dr' and a rows, and no
// sweep A kernel runs.
template <int NP, bool FUSED>
__global__ void __launch_bounds__(4 * NP, 2)
wkv_bwd_b_kernel(const float* __restrict__ r, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ lw,
                 const float* __restrict__ u, const float* __restrict__ ckpt,
                 const float* __restrict__ gy,
                 const float* __restrict__ ghl, float* __restrict__ dr,
                 float* __restrict__ dk, float* __restrict__ dv,
                 float* __restrict__ dlw, float* __restrict__ dh0,
                 float* __restrict__ du_seq, int S, int H, int N,
                 int per_group, bool vec) {
  using Geo = RowGeo<NP>;
  constexpr int CG = Geo::CG, RPT = Geo::RPT, K2 = 2 * RPT;
  constexpr int NW = NP / 8, T = bwd_b_tile<NP>(), KS = bwd_b_sub<NP>();
  constexpr int BUF = bwd_b_buf_floats<NP>();
  constexpr int PARTS = 4 * NP / T, COLS = NP / PARTS;  // gy . v pass
  // dv: after the sum over row groups a lane keeps KEEPC columns; with 8
  // row groups (NP = 16) the last level is a full sum over lane bit CG
  constexpr int KEEPC = Geo::GROUPS >= 4 ? 1 : 4 / Geo::GROUPS;
  constexpr int FULL = Geo::GROUPS > 4 ? CG : 0;
  static_assert(PARTS * T == 4 * NP && COLS % 4 == 0, "gy . v pass");
  extern __shared__ __align__(16) float smem[];
  float* s_dvp = smem + (FUSED ? 1 : 2) * BUF;       // [2][NW][KS][NP]
  float* s_u = s_dvp + 2 * NW * KS * NP;
  float* s_du = s_u + NP;                            // [4][NP]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = lane % CG, row0 = 8 * warp + RPT * (lane / CG);
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int64_t stride = static_cast<int64_t>(H) * N;
  const int64_t seq = static_cast<int64_t>(b) * S * stride + h * N;
  const int64_t st = static_cast<int64_t>(bh) * N * N;
  const float* ug = u + (static_cast<int64_t>(b / per_group) * H + h) * N;
  for (int x = threadIdx.x; x < NP; x += 4 * NP) s_u[x] = x < N ? ug[x] : 0.f;

  // Issue the copies of tile ``tile`` into ``buf``.
  auto issue = [&](int tile, float* buf) {
    const int t0 = tile * T;
    issue_rows<T + 1, NP>(buf, r + seq, stride, t0, S, N, vec);
    float* p = buf + (T + 1) * NP;
    issue_rows<T, NP>(p, k + seq, stride, t0, S, N, vec);
    issue_rows<T, NP>(p + T * NP, lw + seq, stride, t0, S, N, vec);
    if constexpr (!FUSED) {
      issue_rows<T, NP>(p + 2 * T * NP, dlw + seq, stride, t0, S, N, vec);
      issue_rows<T, NP>(p + 3 * T * NP, dr + seq, stride, t0, S, N, vec);
    }
    issue_rows<T, NP>(p + 4 * T * NP, gy + seq, stride, t0, S, N, vec);
    issue_rows<T + 1, NP>(p + 5 * T * NP, v + seq, stride, t0 - 1, S, N,
                          vec);
    cp_async_commit();
  };

  float gs[RPT][4];
#pragma unroll
  for (int m = 0; m < RPT; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = row0 + m, j = 4 * c + e;
      gs[m][e] = (i < N && j < N) ? ghl[st + i * N + j] : 0.f;
    }
  float du_part = 0.f, dl = 0.f, wgv = 0.f;
  const int ntile = (S + T - 1) / T;
  issue(ntile - 1, smem);
  int par = 0;
  for (int tile = ntile - 1, pb = 0; tile >= 0; --tile, pb ^= 1) {
    float* buf = smem + pb * BUF;
    float* __restrict__ s_r = buf;                 // T + 1 rows from t0
    float* __restrict__ s_k = buf + (T + 1) * NP;
    float* __restrict__ s_w = s_k + T * NP;        // lw, then w
    float* __restrict__ s_a = s_w + T * NP;        // a, then e
    float* __restrict__ s_drp = s_a + T * NP;
    float* __restrict__ s_gy = s_drp + T * NP;
    float* __restrict__ s_v = s_gy + T * NP;       // s_v[tt + 1] is step tt
    float* __restrict__ s_gyv = s_v + (T + 1) * NP;
    float* __restrict__ s_ruk = s_gyv + T;
    cp_async_wait_all();
    __syncthreads();        // this tile landed; the last tile's reads done
    if (tile > 0) issue(tile - 1, smem + (pb ^ 1) * BUF);
    const int t0 = tile * T, len = min(T, S - t0);
    for (int x = threadIdx.x; x < T * NP; x += 4 * NP) s_w[x] = expf(s_w[x]);
    {                       // gy . v and sum r u k: PARTS threads a step
      const int tt = threadIdx.x / PARTS, q = threadIdx.x % PARTS;
      float a = 0.f, bs = 0.f;
#pragma unroll
      for (int j = q * COLS; j < (q + 1) * COLS; j += 4) {
        const float4 g4 = ld4(&s_gy[tt * NP + j]);
        const float4 v4 = ld4(&s_v[(tt + 1) * NP + j]);
        const float4 r4 = ld4(&s_r[tt * NP + j]);
        const float4 k4 = ld4(&s_k[tt * NP + j]);
        const float4 u4 = ld4(&s_u[j]);
        a = fmaf(g4.x, v4.x, a);
        a = fmaf(g4.y, v4.y, a);
        a = fmaf(g4.z, v4.z, a);
        a = fmaf(g4.w, v4.w, a);
        bs = fmaf(r4.x * u4.x, k4.x, bs);
        bs = fmaf(r4.y * u4.y, k4.y, bs);
        bs = fmaf(r4.z * u4.z, k4.z, bs);
        bs = fmaf(r4.w * u4.w, k4.w, bs);
      }
#pragma unroll
      for (int o = 1; o < PARTS; o <<= 1) {
        a += __shfl_xor_sync(kFull, a, o);
        bs += __shfl_xor_sync(kFull, bs, o);
      }
      if (q == 0) {
        s_gyv[tt] = a;
        s_ruk[tt] = bs;
      }
    }
    __syncthreads();
    if constexpr (FUSED) {  // sweep A over the tile, into s_drp and s_a
      for (int x = len * NP + threadIdx.x; x < T * NP; x += 4 * NP)
        s_a[x] = s_drp[x] = 0.f;           // steps past S
      float sv[RPT][4];
      load_rows<NP>(sv, ckpt + static_cast<int64_t>(bh) * N * N, N);
      a_walk<NP>(sv, s_k, s_w, s_v + NP, s_gy, 0, len, S, N, ghl + st,
                 [&](bool is_a, int i, int t, float val) {
                   (is_a ? s_a : s_drp)[t * NP + i] = val;
                 });
      __syncthreads();
    }
    // per element of the tile: e, dr and du's terms; thread x keeps row
    // x % NP in every tile, so its du terms add up in a fixed order
    for (int x = threadIdx.x; x < T * NP; x += 4 * NP) {
      const int tt = x / NP, i = x % NP, t = t0 + tt;
      const float w = s_w[x];
      if (t != S - 1) s_a[x] = w * s_r[x + NP] * s_a[x];
      if (t < S && i < N) {
        const float ki = s_k[x], gyv = s_gyv[tt];
        dr[seq + static_cast<int64_t>(t) * stride + i] =
            fmaf(s_u[i] * ki, gyv, s_drp[x]);
        du_part = fmaf(s_r[x] * ki, gyv, du_part);
      }
    }
    __syncthreads();
    for (int sc = T / KS - 1; sc >= 0; --sc) {
      if (sc * KS >= len) continue;        // uniform over the block
      float* __restrict__ dvp = s_dvp + par * NW * KS * NP;
#pragma unroll 8
      for (int uu = KS - 1; uu >= 0; --uu) {
        const int tt = sc * KS + uu, t = t0 + tt;
        const float4 g4 = ld4(&s_gy[tt * NP + 4 * c]);
        const float4 v4 = ld4(&s_v[(tt + 1) * NP + 4 * c]);
        const float4 o4 = ld4(&s_v[tt * NP + 4 * c]);
        const float gg[4] = {g4.x, g4.y, g4.z, g4.w};
        const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
        const float oo[4] = {o4.x, o4.y, o4.z, o4.w};
        float rr[RPT], kr[RPT], wr[RPT], acc[K2], cs[4];
        ld_rows<RPT>(&s_r[tt * NP + row0], rr);
        ld_rows<RPT>(&s_k[tt * NP + row0], kr);
        ld_rows<RPT>(&s_w[tt * NP + row0], wr);
#pragma unroll
        for (int q = 0; q < K2; ++q) acc[q] = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) cs[e] = 0.f;
#pragma unroll
        for (int m = 0; m < RPT; ++m)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float& g = gs[m][e];
            acc[m] = fmaf(g, vv[e], acc[m]);             // G_t v_t
            acc[RPT + m] = fmaf(g, oo[e], acc[RPT + m]); // G_t v_{t-1}
            cs[e] = fmaf(g, kr[m], cs[e]);               // dv's term
            g = fmaf(wr[m], g, rr[m] * gg[e]);
          }
        // the lane's row sum: G_t v_t of row i (idx < RPT: its dk) or
        // G_t v_{t-1} (its dlw); dl and wgv mean something in the latter
        const int idx = rs_sum<K2, CG / 2, 1, K2>(acc, lane);
        const int m = idx % RPT, i = row0 + m;
        const bool q1 = idx >= RPT;
        const float ea = s_a[tt * NP + i];
        const float dln = t == S - 1 ? ea : ea + dl - pick<RPT>(kr, m) * wgv;
        dl = q1 ? dln : 0.f;
        wgv = pick<RPT>(wr, m) * acc[0];           // w_t G_t v_{t-1}
        const float dkv = fmaf(s_u[i] * pick<RPT>(rr, m), s_gyv[tt], acc[0]);
        if ((lane & 1) == 0 && t < S && i < N)
          (q1 ? dlw : dk)[seq + static_cast<int64_t>(t) * stride + i] =
              q1 ? dl : dkv;
        const int cidx = rs_sum<4, 16, CG, 4>(cs, lane);
        if ((lane & FULL) == 0) {
#pragma unroll
          for (int q = 0; q < KEEPC; ++q)
            dvp[(warp * KS + uu) * NP + 4 * c + cidx + q] = cs[q];
        }
      }
      __syncthreads();
      for (int idx = threadIdx.x; idx < KS * NP; idx += 4 * NP) {
        const int uu = idx / NP, jj = idx % NP, tt = sc * KS + uu;
        if (tt < len && jj < N) {
          float a = s_ruk[tt] * s_gy[tt * NP + jj];
          for (int w = 0; w < NW; ++w) a += dvp[(w * KS + uu) * NP + jj];
          dv[seq + static_cast<int64_t>(t0 + tt) * stride + jj] = a;
        }
      }
      par ^= 1;
    }
  }
#pragma unroll
  for (int m = 0; m < RPT; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = row0 + m, j = 4 * c + e;
      if (i < N && j < N) dh0[st + i * N + j] = gs[m][e];
    }
  s_du[threadIdx.x] = du_part;
  __syncthreads();
  if (threadIdx.x < N) {
    float a = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) a += s_du[q * NP + threadIdx.x];
    du_seq[static_cast<int64_t>(bh) * N + threadIdx.x] = a;
  }
}

// du (G, H, N): the per-sequence sums (B, H, N) summed over each group's
// sequences in order.  One thread per output element.
__global__ void __launch_bounds__(256)
wkv_bwd_du_kernel(const float* __restrict__ du_seq, float* __restrict__ du,
                  int64_t B, int64_t H, int64_t N, int64_t G) {
  const int64_t x = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  const int64_t hn = H * N, per = B / G;
  if (x < G * hn) {
    const float* p = du_seq + (x / hn) * per * hn + x % hn;
    float a = 0.f;
    for (int64_t s = 0; s < per; ++s) a += p[s * hn];
    du[x] = a;
  }
}

bool bad_shape(int64_t B, int64_t S, int64_t H, int64_t N, int64_t G) {
  return B < 1 || S < 1 || H < 1 || N < 1 || N > kMaxN || G < 1 ||
         B % G != 0 || S > 0x7fffffffLL - 2048 ||
         B * H * ((S + kCkpt - 1) / kCkpt) > 0x7fffffffLL;
}

int padded(int64_t N) { return N <= 16 ? 16 : (N <= 32 ? 32 : 64); }

// Allow ``kernel`` ``bytes`` of dynamic shared memory, once.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes, bool& done) {
  if (done) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  done = true;
  return 0;
}

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

// Column groups a head's forward is split into (NP = 64 only; smaller
// heads run one block of 64 threads).  Each group stages the row vectors
// and runs the exp and r u k pass again, so splitting pays only where it
// fills SMs that would idle or evens out their load: 4 groups while the
// quarters of every head fit one an SM, 2 when there are more heads than
// SMs (rwkv6-3b's 320 heads: 640 blocks, at most 5 halves an SM instead of
// 3 whole heads), else 1.
template <int NP>
int fwd_cg(int64_t BH) {
  const int64_t sms = sm_count();
  if (NP < 64) return 1;
  if (4 * BH <= sms) return 4;
  return BH > sms ? 2 : 1;
}

template <typename In, int NP, int CG>
int launch_fwd_cg(const In* r, const In* k, const In* v,
                  const In* lw, const float* u, const float* h0, float* y,
                  float* h_last, float* ckpt, int64_t B, int64_t S, int64_t H,
                  int64_t N, int64_t G, bool vec, cudaStream_t st) {
  using Geo = FwdGeo<NP, CG>;
  constexpr int smem = Geo::kSmemBytes +
                       (std::is_same<In, float>::value ? 0 : Geo::kStageBytes);
  static bool done = false;
  const int err = allow_smem(wkv_fwd_kernel<In, NP, CG>, smem, done);
  if (err != 0) return err;
  wkv_fwd_kernel<In, NP, CG><<<static_cast<unsigned>(B * H * CG), Geo::kThreads,
                           smem, st>>>(
      r, k, v, lw, u, h0, y, h_last, ckpt, static_cast<int>(S),
      static_cast<int>(H), static_cast<int>(N), static_cast<int>(B / G), vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename In, int NP>
int launch_fwd(const In* r, const In* k, const In* v,
               const In* lw, const float* u, const float* h0, float* y,
               float* h_last, float* ckpt, int64_t B, int64_t S, int64_t H,
               int64_t N, int64_t G, cudaStream_t st) {
  bool vec = N % 4 == 0;
  for (const In* p : {r, k, v, lw})
    vec = vec && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  if constexpr (NP < 64) {
    return launch_fwd_cg<In, NP, 1>(r, k, v, lw, u, h0, y, h_last, ckpt, B, S, H,
                                N, G, vec, st);
  } else {
    switch (fwd_cg<NP>(B * H)) {
      case 1: return launch_fwd_cg<In, NP, 1>(r, k, v, lw, u, h0, y, h_last,
                                          ckpt, B, S, H, N, G, vec, st);
      case 2: return launch_fwd_cg<In, NP, 2>(r, k, v, lw, u, h0, y, h_last,
                                          ckpt, B, S, H, N, G, vec, st);
      default: return launch_fwd_cg<In, NP, 4>(r, k, v, lw, u, h0, y, h_last,
                                           ckpt, B, S, H, N, G, vec, st);
    }
  }
}

template <int NP>
int launch_bwd(const float* r, const float* k, const float* v,
               const float* lw, const float* u, const float* ckpt,
               const float* gy, const float* ghl, float* dr, float* dk,
               float* dv, float* dlw, float* dh0, float* du_seq, int64_t B,
               int64_t S, int64_t H, int64_t N, int64_t G, cudaStream_t st) {
  const size_t a_bytes = sizeof(float) * bwd_a_smem_floats<NP>();
  const size_t b_bytes = sizeof(float) * bwd_b_smem_floats<NP>(2);
  const size_t f_bytes = sizeof(float) * bwd_b_smem_floats<NP>(1);
  static bool a_set = false, b_set = false, f_set = false;
  int err = allow_smem(wkv_bwd_a_kernel<NP>, a_bytes, a_set);
  if (err == 0)
    err = allow_smem(wkv_bwd_b_kernel<NP, false>, b_bytes, b_set);
  if (err == 0) err = allow_smem(wkv_bwd_b_kernel<NP, true>, f_bytes, f_set);
  if (err != 0) return err;
  const int64_t nck = (S + kCkpt - 1) / kCkpt;
  bool vec = N % 4 == 0;
  for (const float* p : {r, k, v, lw, gy, static_cast<const float*>(dr),
                         static_cast<const float*>(dlw)})
    vec = vec && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  const bool fused = S <= kCkpt && S <= bwd_b_tile<NP>();
  if (!fused) {
    wkv_bwd_a_kernel<NP><<<static_cast<unsigned>(B * H * nck), 4 * NP,
                           a_bytes, st>>>(
        k, v, lw, ckpt, gy, ghl, dr, dlw, static_cast<int>(S),
        static_cast<int>(H), static_cast<int>(N), vec);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  auto* kernel_b =
      fused ? wkv_bwd_b_kernel<NP, true> : wkv_bwd_b_kernel<NP, false>;
  kernel_b<<<static_cast<unsigned>(B * H), 4 * NP, fused ? f_bytes : b_bytes,
             st>>>(
      r, k, v, lw, u, ckpt, gy, ghl, dr, dk, dv, dlw, dh0, du_seq,
      static_cast<int>(S), static_cast<int>(H), static_cast<int>(N),
      static_cast<int>(B / G), vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Steps between the forward's checkpoints of S (the checkpoint buffer is
// (B, H, ceil(S / steps), N, N) floats).
extern "C" int repro_wkv_ckpt_steps() { return kCkpt; }

// Forward.  r, k, v, lw fp32, or bf16 when ``in_bf16``; u, h0 and the
// outputs fp32.  ckpt may be null (no backward will follow).  Returns
// cudaGetLastError() after the launch.
template <typename In>
static int fwd(const void* r, const void* k, const void* v, const void* lw,
               const float* u, const float* h0, float* y, float* h_last,
               float* ckpt, int64_t B, int64_t S, int64_t H, int64_t N,
               int64_t G, cudaStream_t st) {
  const In* r_ = static_cast<const In*>(r);
  const In* k_ = static_cast<const In*>(k);
  const In* v_ = static_cast<const In*>(v);
  const In* lw_ = static_cast<const In*>(lw);
  switch (padded(N)) {
    case 16: return launch_fwd<In, 16>(r_, k_, v_, lw_, u, h0, y, h_last, ckpt,
                                      B, S, H, N, G, st);
    case 32: return launch_fwd<In, 32>(r_, k_, v_, lw_, u, h0, y, h_last, ckpt,
                                      B, S, H, N, G, st);
    default: return launch_fwd<In, 64>(r_, k_, v_, lw_, u, h0, y, h_last, ckpt,
                                      B, S, H, N, G, st);
  }
}

extern "C" int repro_wkv_fwd(const void* r, const void* k, const void* v,
                             const void* lw, const float* u,
                             const float* h0, float* y, float* h_last,
                             float* ckpt, int64_t B, int64_t S, int64_t H,
                             int64_t N, int64_t G, int in_bf16, void* stream) {
  if (bad_shape(B, S, H, N, G)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_bf16)
    return fwd<__nv_bfloat16>(r, k, v, lw, u, h0, y, h_last, ckpt, B, S, H, N,
                              G, st);
  return fwd<float>(r, k, v, lw, u, h0, y, h_last, ckpt, B, S, H, N, G, st);
}

// Backward: the walk kernel, then the du reduce kernel, on one stream.
// ``work`` holds B * H * N floats (du per sequence).  Returns
// cudaGetLastError() after the launches.
extern "C" int repro_wkv_bwd(const float* r, const float* k, const float* v,
                             const float* lw, const float* u,
                             const float* ckpt, const float* gy,
                             const float* ghl, float* dr, float* dk,
                             float* dv, float* dlw, float* du, float* dh0,
                             float* work, int64_t B, int64_t S, int64_t H,
                             int64_t N, int64_t G, void* stream) {
  if (bad_shape(B, S, H, N, G)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  switch (padded(N)) {
    case 16: err = launch_bwd<16>(r, k, v, lw, u, ckpt, gy, ghl, dr, dk, dv,
                                  dlw, dh0, work, B, S, H, N, G, st); break;
    case 32: err = launch_bwd<32>(r, k, v, lw, u, ckpt, gy, ghl, dr, dk, dv,
                                  dlw, dh0, work, B, S, H, N, G, st); break;
    default: err = launch_bwd<64>(r, k, v, lw, u, ckpt, gy, ghl, dr, dk, dv,
                                  dlw, dh0, work, B, S, H, N, G, st);
  }
  if (err != 0) return err;
  const int64_t total = G * H * N;
  wkv_bwd_du_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                      st>>>(work, du, B, H, N, G);
  return static_cast<int>(cudaGetLastError());
}
