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
// fp32): bytes bound it, operations close behind.  The backward does about
// 6 FMAs per state element per step and moves about twice the bytes.  The
// recurrence is sequential in t, so the parallelism is over (B, H) heads
// and, inside a head, over the state.
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
// Backward design (wkv_bwd_kernel).  With G_t the cotangent of S_t (G seeded
// from the h_last cotangent), walking t down:
//   dr_t[i]  = sum_j gy_t[j] S_{t-1}[i,j] + u[i] k_t[i] (gy_t . v_t)
//   dk_t[i]  = sum_j G_t[i,j] v_t[j]     + u[i] r_t[i] (gy_t . v_t)
//   dv_t[j]  = sum_i G_t[i,j] k_t[i]     + (sum_i r_t u k_t) gy_t[j]
//   dlw_t[i] = w_t[i] sum_j G_t[i,j] S_{t-1}[i,j]
//   du[i]   += r_t[i] k_t[i] (gy_t . v_t)
//   G_{t-1}  = diag(w_t) G_t + r_t^T gy_t,    dh0 = G_{-1}.
// Three of the four sums run over j, so the backward transposes the
// forward's layout: thread (i, c) holds columns j = 16q + 4c + e of row i,
// a warp holds 8 rows, and the sums over j are in-thread plus two shuffles
// over the 4 column groups c.  The one sum over i (dv) is reduce-scattered
// over the warp's 8 rows with shuffles, written per warp to shared memory
// and summed over the warps in order every kSub = 8 steps.  S_{t-1} is
// never rebuilt by dividing by w (w reaches 2e-9): each 64-step chunk's
// inputs are staged, its checkpoint loaded, and each 8-step sub-chunk walked
// back with S_{t-1} recomputed forward from the sub-chunk's start (itself
// recomputed from the checkpoint), about 7 state updates per step.
// du is summed over t in registers and over a group's sequences, in order,
// by wkv_bwd_du_kernel.  No atomics: every run gives the same result.
// Every offset into a (B, S, H, N)-sized array is 64-bit.  Ragged S and N
// are masked in the kernels; nothing is padded.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 64;
constexpr int kCkpt = 64;        // steps between the forward's checkpoints
constexpr int kSub = 8;          // steps per backward sub-chunk
constexpr unsigned kFull = 0xffffffffu;

static_assert(kCkpt % kSub == 0, "a chunk holds whole sub-chunks");

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

// One halving level of a reduce-scatter over lanes ``off`` apart: of the
// CNT values v[0..CNT), a lane keeps the upper half if ``upper`` and the
// lower half otherwise, summed with its partner's copy, in v[0..CNT/2).
template <int PER, int CNT>
__device__ __forceinline__ void rs_level(float (&v)[PER], int off, bool upper) {
  constexpr int HALF = CNT / 2;
#pragma unroll
  for (int q = 0; q < HALF; ++q) {
    const float send = upper ? v[q] : v[q + HALF];
    const float keep = upper ? v[q + HALF] : v[q];
    v[q] = keep + __shfl_xor_sync(kFull, send, off);
  }
}

// Sum v over the warp's 8 rows (lane bits 2..4).  Afterwards v[0..KEEP)
// (KEEP = max(PER/8, 1)) hold the sums of elements base .. base+KEEP-1;
// returns base.  With PER = 4 the last level is a full sum, so the two
// lanes 4 apart hold the same value.
template <int PER>
__device__ __forceinline__ int reduce_rows(float (&v)[PER], int lane) {
  int base = 0;
  bool up = lane & 16;
  rs_level<PER, PER>(v, 16, up);
  base += up ? PER / 2 : 0;
  up = lane & 8;
  rs_level<PER, PER / 2>(v, 8, up);
  base += up ? PER / 4 : 0;
  if constexpr (PER >= 8) {
    up = lane & 4;
    rs_level<PER, PER / 4>(v, 4, up);
    base += up ? PER / 8 : 0;
  } else {
    v[0] += __shfl_xor_sync(kFull, v[0], 4);
  }
  return base;
}

// The backward's shared memory, in floats: r, k, w, v, gy for a chunk;
// gy . v and sum_i r u k per step; per-warp partials of dv for a
// sub-chunk; u.
template <int NP>
constexpr int bwd_smem_floats() {
  return 5 * kCkpt * NP + 2 * kCkpt + (NP / 8) * kSub * NP + NP;
}

// 2 blocks per SM, as the shared memory allows at N = 64.
template <int NP>
__global__ void __launch_bounds__(4 * NP, 2)
wkv_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ lw,
               const float* __restrict__ u, const float* __restrict__ ckpt,
               const float* __restrict__ gy, const float* __restrict__ ghl,
               float* __restrict__ dr, float* __restrict__ dk,
               float* __restrict__ dv, float* __restrict__ dlw,
               float* __restrict__ dh0, float* __restrict__ du_seq, int S,
               int H, int N, int per_group) {
  constexpr int PER = NP / 4, NW = NP / 8;
  constexpr int KEEP = PER >= 8 ? PER / 8 : 1;
  extern __shared__ __align__(16) float smem[];
  float(*s_r)[NP] = reinterpret_cast<float(*)[NP]>(smem);
  float(*s_k)[NP] = s_r + kCkpt;
  float(*s_w)[NP] = s_k + kCkpt;
  float(*s_v)[NP] = s_w + kCkpt;
  float(*s_gy)[NP] = s_v + kCkpt;
  float* s_gyv = smem + 5 * kCkpt * NP;
  float* s_ruk = s_gyv + kCkpt;
  float(*s_dvp)[kSub][NP] =
      reinterpret_cast<float(*)[kSub][NP]>(s_ruk + kCkpt);
  float* s_u = smem + 5 * kCkpt * NP + 2 * kCkpt + NW * kSub * NP;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = lane & 3, i = warp * 8 + (lane >> 2);
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int64_t stride = static_cast<int64_t>(H) * N;
  const int64_t seq = static_cast<int64_t>(b) * S * stride + h * N;
  const int64_t st = static_cast<int64_t>(bh) * N * N;
  const float* ug = u + (static_cast<int64_t>(b / per_group) * H + h) * N;
  const int nck = (S + kCkpt - 1) / kCkpt;
  for (int x = threadIdx.x; x < NP; x += 4 * NP) s_u[x] = x < N ? ug[x] : 0.f;
  float gs[PER];
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int jj = elem(c, p);
    gs[p] = (i < N && jj < N) ? ghl[st + i * N + jj] : 0.f;
  }
  float du_acc = 0.f;
  __syncthreads();
  const float ui = s_u[i];

  // one recompute step of a thread's part of S with step tt's k, w, v
  auto advance = [&](float (&sv)[PER], int tt) {
    const float ki = s_k[tt][i], wi = s_w[tt][i];
#pragma unroll
    for (int q = 0; q < PER / 4; ++q) {
      const float4 v4 = ld4(&s_v[tt][16 * q + 4 * c]);
      const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sv[4 * q + e] = fmaf(wi, sv[4 * q + e], ki * vv[e]);
    }
  };

  for (int ck = nck - 1; ck >= 0; --ck) {
    const int c0 = ck * kCkpt, len = min(kCkpt, S - c0);
    __syncthreads();                       // the last chunk's reads are done
    stage<kCkpt, NP>(s_r, r + seq, stride, c0, S, N, false);
    stage<kCkpt, NP>(s_k, k + seq, stride, c0, S, N, false);
    stage<kCkpt, NP>(s_v, v + seq, stride, c0, S, N, false);
    stage<kCkpt, NP>(s_gy, gy + seq, stride, c0, S, N, false);
    stage<kCkpt, NP>(s_w, lw + seq, stride, c0, S, N, true);
    __syncthreads();
    for (int tt = threadIdx.x; tt < kCkpt; tt += 4 * NP) {
      float a = 0.f, bsum = 0.f;
      for (int x = 0; x < N; ++x) {
        a = fmaf(s_gy[tt][x], s_v[tt][x], a);
        bsum = fmaf(s_r[tt][x] * s_u[x], s_k[tt][x], bsum);
      }
      s_gyv[tt] = a;
      s_ruk[tt] = bsum;
    }
    float sck[PER];
    const float* src = ckpt + (static_cast<int64_t>(bh) * nck + ck) * N * N;
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int jj = elem(c, p);
      sck[p] = (i < N && jj < N) ? src[i * N + jj] : 0.f;
    }
    __syncthreads();
    const int nsub = (len + kSub - 1) / kSub;
    for (int sc = nsub - 1; sc >= 0; --sc) {
      float sst[PER];                      // S before step c0 + sc * kSub
#pragma unroll
      for (int p = 0; p < PER; ++p) sst[p] = sck[p];
      for (int tt = 0; tt < sc * kSub; ++tt) advance(sst, tt);
      for (int uu = kSub - 1; uu >= 0; --uu) {
        const int tt = sc * kSub + uu;
        if (tt >= len) continue;           // uniform over the block
        float sp[PER];                     // S_{t-1}
#pragma unroll
        for (int p = 0; p < PER; ++p) sp[p] = sst[p];
        for (int x = sc * kSub; x < tt; ++x) advance(sp, x);
        const float ri = s_r[tt][i], ki = s_k[tt][i], wi = s_w[tt][i];
        const float gyv = s_gyv[tt];
        float p1 = 0.f, p2 = 0.f, p3 = 0.f;
#pragma unroll
        for (int q = 0; q < PER / 4; ++q) {
          const float4 g4 = ld4(&s_gy[tt][16 * q + 4 * c]);
          const float4 v4 = ld4(&s_v[tt][16 * q + 4 * c]);
          const float gg[4] = {g4.x, g4.y, g4.z, g4.w};
          const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int p = 4 * q + e;
            p1 = fmaf(gg[e], sp[p], p1);
            p2 = fmaf(gs[p], vv[e], p2);
            p3 = fmaf(gs[p], sp[p], p3);
            sp[p] = gs[p] * ki;            // this column's dv term
            gs[p] = fmaf(wi, gs[p], ri * gg[e]);
          }
        }
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          p1 += __shfl_xor_sync(kFull, p1, o);
          p2 += __shfl_xor_sync(kFull, p2, o);
          p3 += __shfl_xor_sync(kFull, p3, o);
        }
        if (i < N) {
          const int64_t off = seq + static_cast<int64_t>(c0 + tt) * stride + i;
          if (c == 0) dr[off] = fmaf(ui * ki, gyv, p1);
          else if (c == 1) dk[off] = fmaf(ui * ri, gyv, p2);
          else if (c == 2) dlw[off] = wi * p3;
        }
        du_acc = fmaf(ri * ki, gyv, du_acc);
        const int base = reduce_rows<PER>(sp, lane);
        if (PER >= 8 || (lane & 4) == 0) {
#pragma unroll
          for (int q = 0; q < KEEP; ++q)
            s_dvp[warp][uu][elem(c, base + q)] = sp[q];
        }
      }
      __syncthreads();
      for (int idx = threadIdx.x; idx < kSub * NP; idx += 4 * NP) {
        const int uu = idx / NP, jj = idx % NP, tt = sc * kSub + uu;
        if (tt < len && jj < N) {
          float a = s_ruk[tt] * s_gy[tt][jj];
          for (int w = 0; w < NW; ++w) a += s_dvp[w][uu][jj];
          dv[seq + static_cast<int64_t>(c0 + tt) * stride + jj] = a;
        }
      }
      __syncthreads();
    }
  }
  if (i < N) {
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int jj = elem(c, p);
      if (jj < N) dh0[st + i * N + jj] = gs[p];
    }
    if (c == 0) du_seq[static_cast<int64_t>(bh) * N + i] = du_acc;
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
         B % G != 0 || B * H > 0x7fffffffLL || S > 0x7fffffffLL - 2048;
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

template <int NP>
int launch_bwd(const float* r, const float* k, const float* v,
               const float* lw, const float* u, const float* ckpt,
               const float* gy, const float* ghl, float* dr, float* dk,
               float* dv, float* dlw, float* dh0, float* du_seq, int64_t B,
               int64_t S, int64_t H, int64_t N, int64_t G, cudaStream_t st) {
  const size_t bytes = sizeof(float) * bwd_smem_floats<NP>();
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        wkv_bwd_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  wkv_bwd_kernel<NP><<<static_cast<unsigned>(B * H), 4 * NP, bytes, st>>>(
      r, k, v, lw, u, ckpt, gy, ghl, dr, dk, dv, dlw, dh0, du_seq,
      static_cast<int>(S), static_cast<int>(H), static_cast<int>(N),
      static_cast<int>(B / G));
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
