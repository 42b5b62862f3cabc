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
// heads and, inside a head, over the state.
//
// Forward design (wkv_fwd_kernel).  Column j of S depends only on v[j] and
// the row vectors r, k, w, u, so one block of 4 NP threads runs one head
// (NP = N rounded up to 16, 32 or 64): thread (j, g) holds rows
// i = 16q + 4g + e (q < NP/16, e < 4) of column j in registers, and y[j] is
// a shuffle sum over the 4 threads g of the column.  r, k, w = exp(lw) and
// v for a tile of 2048/NP steps are staged in shared memory with coalesced
// loads (a thread's rows come as float4 reads, conflict-free), together
// with sum_i r u k per step, and y is stored from a shared tile.  In
// training mode S is written every kCkpt = 64 steps to a (B, H, ceil(S/64),
// N, N) buffer: at N = 64 that is as large as one input tensor.
//
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
#include <cstdint>
#include <initializer_list>
#include <cuda_runtime.h>

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

// Stage steps t0 .. t0+T-1 of one head's (S, N) rows (stride ``stride``
// between steps) into sh[T][NP] with the block's 4 NP threads: zero outside
// S and N; with ``expo`` the values are exp(src).  A thread issues its
// T/4 loads 8 at a time before storing them, so their latencies overlap
// without holding every load in registers.
template <int T, int NP>
__device__ __forceinline__ void stage(float (*sh)[NP], const float* __restrict__ src,
                                      int64_t stride, int t0, int S, int N,
                                      bool expo) {
  constexpr int kIters = T / 4, kBatch = 8;
  static_assert(kIters % kBatch == 0, "whole batches of loads");
  const float pad = expo ? __int_as_float(0xff800000) : 0.f;   // exp(-inf) = 0
#pragma unroll 1
  for (int b0 = 0; b0 < kIters; b0 += kBatch) {
    float buf[kBatch];
#pragma unroll
    for (int it = 0; it < kBatch; ++it) {
      const int idx = threadIdx.x + (b0 + it) * 4 * NP;
      const int tt = idx / NP, i = idx % NP, t = t0 + tt;
      buf[it] = (t < S && i < N) ? src[static_cast<int64_t>(t) * stride + i]
                                 : pad;
    }
#pragma unroll
    for (int it = 0; it < kBatch; ++it) {
      const int idx = threadIdx.x + (b0 + it) * 4 * NP;
      sh[idx / NP][idx % NP] = expo ? expf(buf[it]) : buf[it];
    }
  }
}

// 3 blocks per SM: rwkv6-3b's 320 heads fit the 132 SMs in one wave.
template <int NP>
__global__ void __launch_bounds__(4 * NP, 3)
wkv_fwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ lw,
               const float* __restrict__ u, const float* __restrict__ h0,
               float* __restrict__ y, float* __restrict__ h_last,
               float* __restrict__ ckpt, int S, int H, int N,
               int per_group) {
  constexpr int T = 2048 / NP, PER = NP / 4;
  __shared__ __align__(16) float s_r[T][NP], s_k[T][NP], s_w[T][NP],
      s_v[T][NP], s_y[T][NP];
  __shared__ float s_ruk[T], s_u[NP];
  const int g = threadIdx.x & 3, j = threadIdx.x >> 2;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int64_t stride = static_cast<int64_t>(H) * N;
  const int64_t seq = static_cast<int64_t>(b) * S * stride + h * N;
  const int64_t st = static_cast<int64_t>(bh) * N * N;
  const float* ug = u + (static_cast<int64_t>(b / per_group) * H + h) * N;
  const int nck = (S + kCkpt - 1) / kCkpt;
  for (int i = threadIdx.x; i < NP; i += 4 * NP) s_u[i] = i < N ? ug[i] : 0.f;
  float s[PER];
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int i = elem(g, p);
    s[p] = (i < N && j < N) ? h0[st + i * N + j] : 0.f;
  }
  for (int t0 = 0; t0 < S; t0 += T) {
    stage<T, NP>(s_r, r + seq, stride, t0, S, N, false);
    stage<T, NP>(s_k, k + seq, stride, t0, S, N, false);
    stage<T, NP>(s_v, v + seq, stride, t0, S, N, false);
    stage<T, NP>(s_w, lw + seq, stride, t0, S, N, true);
    __syncthreads();
    for (int tt = threadIdx.x; tt < T; tt += 4 * NP) {
      float a = 0.f;
      for (int i = 0; i < N; ++i) a = fmaf(s_r[tt][i] * s_u[i], s_k[tt][i], a);
      s_ruk[tt] = a;
    }
    __syncthreads();
    const int steps = min(T, S - t0);
    for (int tt = 0; tt < steps; ++tt) {
      const int t = t0 + tt;
      if (ckpt != nullptr && t % kCkpt == 0 && j < N) {
        float* dst = ckpt + (static_cast<int64_t>(bh) * nck + t / kCkpt) * N * N;
#pragma unroll
        for (int p = 0; p < PER; ++p) {
          const int i = elem(g, p);
          if (i < N) dst[i * N + j] = s[p];
        }
      }
      const float vj = s_v[tt][j];
      float yp = 0.f;
#pragma unroll
      for (int q = 0; q < PER / 4; ++q) {
        const float4 r4 = ld4(&s_r[tt][16 * q + 4 * g]);
        const float4 k4 = ld4(&s_k[tt][16 * q + 4 * g]);
        const float4 w4 = ld4(&s_w[tt][16 * q + 4 * g]);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& sv = s[4 * q + e];
          yp = fmaf(rr[e], sv, yp);
          sv = fmaf(ww[e], sv, kk[e] * vj);
        }
      }
      yp += __shfl_xor_sync(kFull, yp, 1);
      yp += __shfl_xor_sync(kFull, yp, 2);
      if (g == 0) s_y[tt][j] = fmaf(vj, s_ruk[tt], yp);
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < T * NP; idx += 4 * NP) {
      const int tt = idx / NP, i = idx % NP, t = t0 + tt;
      if (t < S && i < N) y[seq + static_cast<int64_t>(t) * stride + i] = s_y[tt][i];
    }
  }
  if (j < N) {
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int i = elem(g, p);
      if (i < N) h_last[st + i * N + j] = s[p];
    }
  }
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
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
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

template <int NP>
int launch_fwd(const float* r, const float* k, const float* v,
               const float* lw, const float* u, const float* h0, float* y,
               float* h_last, float* ckpt, int64_t B, int64_t S, int64_t H,
               int64_t N, int64_t G, cudaStream_t st) {
  wkv_fwd_kernel<NP><<<static_cast<unsigned>(B * H), 4 * NP, 0, st>>>(
      r, k, v, lw, u, h0, y, h_last, ckpt, static_cast<int>(S),
      static_cast<int>(H), static_cast<int>(N), static_cast<int>(B / G));
  return static_cast<int>(cudaGetLastError());
}

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

// Forward.  ckpt may be null (no backward will follow).  Returns
// cudaGetLastError() after the launch.
extern "C" int repro_wkv_fwd(const float* r, const float* k, const float* v,
                             const float* lw, const float* u,
                             const float* h0, float* y, float* h_last,
                             float* ckpt, int64_t B, int64_t S, int64_t H,
                             int64_t N, int64_t G, void* stream) {
  if (bad_shape(B, S, H, N, G)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (padded(N)) {
    case 16: return launch_fwd<16>(r, k, v, lw, u, h0, y, h_last, ckpt, B, S,
                                   H, N, G, st);
    case 32: return launch_fwd<32>(r, k, v, lw, u, h0, y, h_last, ckpt, B, S,
                                   H, N, G, st);
    default: return launch_fwd<64>(r, k, v, lw, u, h0, y, h_last, ckpt, B, S,
                                   H, N, G, st);
  }
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
