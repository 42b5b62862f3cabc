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
// special-function unit bound it about equally.  The recurrence itself is
// sequential in t, so the parallelism is over (B, D) channels only.
//
// Forward design.
//   * A channel's n states are split over L lanes (L = 1, 2, 4 for n <= 4,
//     8, 16), 4 states per lane in registers; y is a shuffle sum over the L
//     lanes.  At full width that is 32,768 channels * 4 lanes = 4,096 warps,
//     31 per SM, where one thread per channel would give 8.
//   * A block of 256 threads covers 256/L consecutive channels of one
//     sequence.  dt and x for a tile of steps (2,048 channel-steps) are
//     staged into shared memory with coalesced loads, b and c for the same
//     steps beside them; y is staged and stored coalesced.
//   * In training mode h is written every kCkpt = 8 steps to a
//     (B, ceil(S/8), D, n) checkpoint buffer for the backward.
// Backward design.  Time runs in reverse with the cotangent of h in
// registers: G_t = c_t gy_t + abar_{t+1} G_{t+1}, seeded with the h_last
// cotangent.  Each 8-step sub-chunk is first recomputed forward from its
// checkpoint into registers (h_{t-1} for every step), then walked back:
//   d dt_t = sum_n G (a abar h_{t-1} + b x),  d x_t = sum_n G dt b   (lanes)
//   d b_t[n] = sum_d G dt x,  d c_t[n] = sum_d gy h_t               (over D)
//   d a[d,n] = sum_t G dt abar h_{t-1},  d h0 = abar_0 G_0.
// The sums over D cross thread blocks: each block reduces its channels
// (shuffles within a warp, then the 8 warps in order) into a per-block
// partial, and a second kernel sums the partials over blocks in block
// order; d a is summed over t in registers and over the sequences of a
// group by the same second kernel.  No atomics, so the result is the same
// on every run.
// Every offset into a (B,S,D)-sized array is 64-bit.  Ragged S, D and n are
// masked in the kernels; nothing is padded.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNpl = 4;          // states per lane
constexpr int kMaxN = 16;
constexpr int kTile = 2048;      // channel-steps staged per tile
constexpr int kCkpt = 8;         // steps between forward checkpoints

template <int L>
struct Geo {
  static constexpr int kCpb = kThreads / L;    // channels per block
  static constexpr int kSteps = kTile / kCpb;  // steps per tile
  static_assert(L * kNpl <= kMaxN, "lanes times states per lane > 16");
  static_assert(kSteps % kCkpt == 0, "tile must hold whole sub-chunks");
};

int lanes_for(int64_t n) { return n <= 4 ? 1 : (n <= 8 ? 2 : 4); }

template <int L>
__device__ __forceinline__ float lane_sum(float v) {
#pragma unroll
  for (int o = 1; o < L; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Stage rows t0 .. t0+T-1 of a (S, D) slab (one sequence) into sh[T][CPB],
// zero outside S and D.
template <int T, int CPB>
__device__ __forceinline__ void stage_rows(float (*sh)[CPB],
                                           const float* __restrict__ src,
                                           int t0, int d0, int S, int D) {
  for (int i = threadIdx.x; i < T * CPB; i += kThreads) {
    const int tt = i / CPB, cc = i % CPB;
    const int t = t0 + tt, d = d0 + cc;
    sh[tt][cc] = (t < S && d < D) ? src[static_cast<int64_t>(t) * D + d]
                                  : 0.f;
  }
}

// Rows t0 .. t0+T-1 of a (S, n) slab into sh[T][kMaxN], zero-padded.
template <int T>
__device__ __forceinline__ void stage_states(float (*sh)[kMaxN],
                                             const float* __restrict__ src,
                                             int t0, int S, int n) {
  for (int i = threadIdx.x; i < T * kMaxN; i += kThreads) {
    const int tt = i / kMaxN, j = i % kMaxN;
    const int t = t0 + tt;
    sh[tt][j] = (t < S && j < n) ? src[static_cast<int64_t>(t) * n + j]
                                 : 0.f;
  }
}

template <int T, int CPB>
__device__ __forceinline__ void store_rows(float* __restrict__ dst,
                                           const float (*sh)[CPB], int t0,
                                           int d0, int S, int D) {
  for (int i = threadIdx.x; i < T * CPB; i += kThreads) {
    const int tt = i / CPB, cc = i % CPB;
    const int t = t0 + tt, d = d0 + cc;
    if (t < S && d < D) dst[static_cast<int64_t>(t) * D + d] = sh[tt][cc];
  }
}

template <int L>
__global__ void __launch_bounds__(kThreads)
ssm_fwd_kernel(const float* __restrict__ dt, const float* __restrict__ bm,
               const float* __restrict__ cm, const float* __restrict__ x,
               const float* __restrict__ a, const float* __restrict__ h0,
               float* __restrict__ y, float* __restrict__ h_last,
               float* __restrict__ ckpt, int S, int D, int n, int per_group) {
  constexpr int CPB = Geo<L>::kCpb, T = Geo<L>::kSteps;
  __shared__ float s_dt[T][CPB], s_x[T][CPB], s_y[T][CPB];
  __shared__ float s_b[T][kMaxN], s_c[T][kMaxN];
  const int lane = threadIdx.x % L, ch = threadIdx.x / L;
  const int bi = blockIdx.y, d0 = blockIdx.x * CPB, d = d0 + ch;
  const int64_t seq = static_cast<int64_t>(bi) * S * D;
  const int64_t seq_n = static_cast<int64_t>(bi) * S * n;
  const int64_t chan = (static_cast<int64_t>(bi) * D + d) * n;
  const float* ag = a + static_cast<int64_t>(bi / per_group) * D * n;
  const int nck = (S + kCkpt - 1) / kCkpt;
  float av[kNpl], h[kNpl];
#pragma unroll
  for (int j = 0; j < kNpl; ++j) {
    const int st = lane * kNpl + j;
    const bool ok = d < D && st < n;
    av[j] = ok ? ag[static_cast<int64_t>(d) * n + st] : 0.f;
    h[j] = ok ? h0[chan + st] : 0.f;
  }
  for (int t0 = 0; t0 < S; t0 += T) {
    stage_rows<T, CPB>(s_dt, dt + seq, t0, d0, S, D);
    stage_rows<T, CPB>(s_x, x + seq, t0, d0, S, D);
    stage_states<T>(s_b, bm + seq_n, t0, S, n);
    stage_states<T>(s_c, cm + seq_n, t0, S, n);
    __syncthreads();
    const int steps = min(T, S - t0);
    for (int tt = 0; tt < steps; ++tt) {
      const int t = t0 + tt;
      if (ckpt != nullptr && t % kCkpt == 0 && d < D) {
        float* dst = ckpt + ((static_cast<int64_t>(bi) * nck + t / kCkpt) * D
                             + d) * n;
#pragma unroll
        for (int j = 0; j < kNpl; ++j)
          if (lane * kNpl + j < n) dst[lane * kNpl + j] = h[j];
      }
      const float dtv = s_dt[tt][ch], xv = s_x[tt][ch];
      float yp = 0.f;
#pragma unroll
      for (int j = 0; j < kNpl; ++j) {
        const int st = lane * kNpl + j;
        const float ab = expf(dtv * av[j]);
        h[j] = ab * h[j] + dtv * s_b[tt][st] * xv;
        yp += s_c[tt][st] * h[j];
      }
      yp = lane_sum<L>(yp);
      if (lane == 0) s_y[tt][ch] = yp;
    }
    __syncthreads();
    store_rows<T, CPB>(y + seq, s_y, t0, d0, S, D);
  }
  if (d < D) {
#pragma unroll
    for (int j = 0; j < kNpl; ++j)
      if (lane * kNpl + j < n) h_last[chan + lane * kNpl + j] = h[j];
  }
}

template <int L>
__global__ void __launch_bounds__(kThreads, 2)
ssm_bwd_kernel(const float* __restrict__ dt, const float* __restrict__ bm,
               const float* __restrict__ cm, const float* __restrict__ x,
               const float* __restrict__ a, const float* __restrict__ ckpt,
               const float* __restrict__ gy, const float* __restrict__ ghl,
               float* __restrict__ ddt, float* __restrict__ dx,
               float* __restrict__ dh0, float* __restrict__ da_seq,
               float* __restrict__ part_b, float* __restrict__ part_c,
               int S, int D, int n, int per_group) {
  constexpr int CPB = Geo<L>::kCpb, T = Geo<L>::kSteps;
  // s_dt / s_x are overwritten in place with d dt / d x as the walk passes
  __shared__ float s_dt[T][CPB], s_x[T][CPB], s_gy[T][CPB];
  __shared__ float s_b[T][kMaxN], s_c[T][kMaxN];
  __shared__ float s_rb[kWarps][kCkpt][kMaxN], s_rc[kWarps][kCkpt][kMaxN];
  const int lane = threadIdx.x % L, ch = threadIdx.x / L;
  const int warp = threadIdx.x / 32;
  const bool warp_head = (threadIdx.x & 31) < L;   // first channel of a warp
  const int bi = blockIdx.y, d0 = blockIdx.x * CPB, d = d0 + ch;
  const int nblk = gridDim.x;
  const int64_t seq = static_cast<int64_t>(bi) * S * D;
  const int64_t seq_n = static_cast<int64_t>(bi) * S * n;
  const int64_t chan = (static_cast<int64_t>(bi) * D + d) * n;
  const int64_t part = (static_cast<int64_t>(bi) * nblk + blockIdx.x) * S * n;
  const float* ag = a + static_cast<int64_t>(bi / per_group) * D * n;
  const int nck = (S + kCkpt - 1) / kCkpt;
  float av[kNpl], carry[kNpl], dav[kNpl];
#pragma unroll
  for (int j = 0; j < kNpl; ++j) {
    const int st = lane * kNpl + j;
    const bool ok = d < D && st < n;
    av[j] = ok ? ag[static_cast<int64_t>(d) * n + st] : 0.f;
    carry[j] = ok ? ghl[chan + st] : 0.f;
    dav[j] = 0.f;
  }
  const int ntile = (S + T - 1) / T;
  for (int tile = ntile - 1; tile >= 0; --tile) {
    const int t0 = tile * T;
    stage_rows<T, CPB>(s_dt, dt + seq, t0, d0, S, D);
    stage_rows<T, CPB>(s_x, x + seq, t0, d0, S, D);
    stage_rows<T, CPB>(s_gy, gy + seq, t0, d0, S, D);
    stage_states<T>(s_b, bm + seq_n, t0, S, n);
    stage_states<T>(s_c, cm + seq_n, t0, S, n);
    __syncthreads();
    const int nsub = (min(T, S - t0) + kCkpt - 1) / kCkpt;
    for (int sc = nsub - 1; sc >= 0; --sc) {
      const int u0 = sc * kCkpt;
      const int tk = t0 + u0;                     // multiple of kCkpt, < S
      // recompute the sub-chunk: hist[u] = h before step u, hist[kCkpt] after
      float hist[kCkpt + 1][kNpl];
      const float* src = ckpt + ((static_cast<int64_t>(bi) * nck + tk / kCkpt)
                                 * D + d) * n;
#pragma unroll
      for (int j = 0; j < kNpl; ++j) {
        const int st = lane * kNpl + j;
        hist[0][j] = (d < D && st < n) ? src[st] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kCkpt; ++u) {
        const float dtv = s_dt[u0 + u][ch], xv = s_x[u0 + u][ch];
#pragma unroll
        for (int j = 0; j < kNpl; ++j) {
          const float ab = expf(dtv * av[j]);
          hist[u + 1][j] = ab * hist[u][j]
                           + dtv * s_b[u0 + u][lane * kNpl + j] * xv;
        }
      }
      // walk back (steps past S are zero-padded and leave G unchanged)
#pragma unroll
      for (int u = kCkpt - 1; u >= 0; --u) {
        const int tt = u0 + u;
        const float dtv = s_dt[tt][ch], xv = s_x[tt][ch], gyv = s_gy[tt][ch];
        float gdt = 0.f, gx = 0.f, pb[kNpl], pc[kNpl];
#pragma unroll
        for (int j = 0; j < kNpl; ++j) {
          const int st = lane * kNpl + j;
          const float bj = s_b[tt][st], cj = s_c[tt][st];
          const float ab = expf(dtv * av[j]);
          const float g = carry[j] + cj * gyv;          // dL/dh_t
          const float gab = g * hist[u][j];             // dL/dabar_t
          gdt += gab * ab * av[j] + g * bj * xv;
          gx += g * dtv * bj;
          dav[j] += gab * ab * dtv;
          pb[j] = g * dtv * xv;
          pc[j] = gyv * hist[u + 1][j];
          carry[j] = ab * g;
        }
        gdt = lane_sum<L>(gdt);
        gx = lane_sum<L>(gx);
        if (lane == 0) {
          s_dt[tt][ch] = gdt;
          s_x[tt][ch] = gx;
        }
#pragma unroll
        for (int j = 0; j < kNpl; ++j) {
          float vb = pb[j], vc = pc[j];
#pragma unroll
          for (int o = L; o < 32; o <<= 1) {
            vb += __shfl_xor_sync(0xffffffffu, vb, o);
            vc += __shfl_xor_sync(0xffffffffu, vc, o);
          }
          if (warp_head) {
            s_rb[warp][u][lane * kNpl + j] = vb;
            s_rc[warp][u][lane * kNpl + j] = vc;
          }
        }
      }
      __syncthreads();
      // this block's partial of d b and d c: the warps summed in order
      for (int i = threadIdx.x; i < 2 * kCkpt * kMaxN; i += kThreads) {
        const int which = i / (kCkpt * kMaxN), r = i % (kCkpt * kMaxN);
        const int u = r / kMaxN, st = r % kMaxN, t = tk + u;
        if (t < S && st < n) {
          float s = 0.f;
          for (int w = 0; w < kWarps; ++w)
            s += which ? s_rc[w][u][st] : s_rb[w][u][st];
          (which ? part_c : part_b)[part + static_cast<int64_t>(t) * n + st]
              = s;
        }
      }
      __syncthreads();
    }
    store_rows<T, CPB>(ddt + seq, s_dt, t0, d0, S, D);
    store_rows<T, CPB>(dx + seq, s_x, t0, d0, S, D);
    __syncthreads();
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

// d b / d c: per-block partials (B, nblk, S, n) summed over blocks in block
// order; d a: per-sequence (B, D, n) summed over each group's sequences in
// order.  One thread per output element.
__global__ void __launch_bounds__(kThreads)
ssm_bwd_reduce_kernel(const float* __restrict__ part_b,
                      const float* __restrict__ part_c,
                      const float* __restrict__ da_seq,
                      float* __restrict__ db, float* __restrict__ dc,
                      float* __restrict__ da, int64_t B, int64_t S,
                      int64_t D, int64_t n, int64_t G, int nblk) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t sn = S * n, m = B * sn;
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
         B % G != 0 || B > 65535 || S > 0x7fffffffLL - kTile ||
         D > 0x7fffffffLL - kThreads;
}

template <int L>
int64_t blocks_d(int64_t D) {
  return (D + Geo<L>::kCpb - 1) / Geo<L>::kCpb;
}

int64_t nblk_for(int64_t D, int64_t n) {
  switch (lanes_for(n)) {
    case 1: return blocks_d<1>(D);
    case 2: return blocks_d<2>(D);
    default: return blocks_d<4>(D);
  }
}

template <int L>
void launch_fwd(const float* dt, const float* b, const float* c,
                const float* x, const float* a, const float* h0, float* y,
                float* h_last, float* ckpt, int64_t B, int64_t S, int64_t D,
                int64_t n, int64_t G, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>(blocks_d<L>(D)),
                  static_cast<unsigned>(B));
  ssm_fwd_kernel<L><<<grid, kThreads, 0, st>>>(
      dt, b, c, x, a, h0, y, h_last, ckpt, static_cast<int>(S),
      static_cast<int>(D), static_cast<int>(n), static_cast<int>(B / G));
}

template <int L>
void launch_bwd(const float* dt, const float* b, const float* c,
                const float* x, const float* a, const float* ckpt,
                const float* gy, const float* ghl, float* ddt, float* dx,
                float* dh0, float* da_seq, float* part_b, float* part_c,
                int64_t B, int64_t S, int64_t D, int64_t n, int64_t G,
                cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>(blocks_d<L>(D)),
                  static_cast<unsigned>(B));
  ssm_bwd_kernel<L><<<grid, kThreads, 0, st>>>(
      dt, b, c, x, a, ckpt, gy, ghl, ddt, dx, dh0, da_seq, part_b, part_c,
      static_cast<int>(S), static_cast<int>(D), static_cast<int>(n),
      static_cast<int>(B / G));
}

}  // namespace

// Steps between the forward's checkpoints of h (the checkpoint buffer is
// (B, ceil(S / steps), D, n) floats).
extern "C" int repro_ssm_scan_ckpt_steps() { return kCkpt; }

// Floats of scratch the backward needs: the per-block partials of d b and
// d c, 2 * B * nblk * S * n, and the per-sequence d a, B * D * n.
extern "C" int64_t repro_ssm_scan_bwd_workspace(int64_t B, int64_t S,
                                                int64_t D, int64_t n) {
  return 2 * B * nblk_for(D, n) * S * n + B * D * n;
}

// Forward.  ckpt may be null (no backward will follow).  Returns
// cudaGetLastError() after the launch.
extern "C" int repro_ssm_scan_fwd(const float* dt, const float* b,
                                  const float* c, const float* x,
                                  const float* a, const float* h0, float* y,
                                  float* h_last, float* ckpt, int64_t B,
                                  int64_t S, int64_t D, int64_t n, int64_t G,
                                  void* stream) {
  if (bad_shape(B, S, D, n, G)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (lanes_for(n)) {
    case 1: launch_fwd<1>(dt, b, c, x, a, h0, y, h_last, ckpt, B, S, D, n, G,
                          st); break;
    case 2: launch_fwd<2>(dt, b, c, x, a, h0, y, h_last, ckpt, B, S, D, n, G,
                          st); break;
    default: launch_fwd<4>(dt, b, c, x, a, h0, y, h_last, ckpt, B, S, D, n,
                           G, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// Backward: the walk kernel, then the reduce kernel, on one stream.
// ``work`` holds repro_ssm_scan_bwd_workspace(B, S, D, n) floats.  Returns
// cudaGetLastError() after the launches.
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
  const int64_t nblk = nblk_for(D, n);
  float* part_b = work;
  float* part_c = part_b + B * nblk * S * n;
  float* da_seq = part_c + B * nblk * S * n;
  switch (lanes_for(n)) {
    case 1: launch_bwd<1>(dt, b, c, x, a, ckpt, gy, ghl, ddt, dx, dh0,
                          da_seq, part_b, part_c, B, S, D, n, G, st); break;
    case 2: launch_bwd<2>(dt, b, c, x, a, ckpt, gy, ghl, ddt, dx, dh0,
                          da_seq, part_b, part_c, B, S, D, n, G, st); break;
    default: launch_bwd<4>(dt, b, c, x, a, ckpt, gy, ghl, ddt, dx, dh0,
                           da_seq, part_b, part_c, B, S, D, n, G, st);
  }
  const int64_t total = 2 * B * S * n + G * D * n;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  ssm_bwd_reduce_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      part_b, part_c, da_seq, db, dc, da, B, S, D, n, G,
      static_cast<int>(nblk));
  return static_cast<int>(cudaGetLastError());
}
