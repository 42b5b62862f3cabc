// Calibrated-retraining accumulate (paper eq. 3) for Hopper:
//   out[p] = w[p] + sum_m coeffs[m] * deltas[m, p]
//
// Replaces the Pallas TPU kernel calibrate_kernel in
// src/repro/kernels/calibrate/kernel.py.
//
// What bounds it on an H100: memory.  Each output element reads M + 1 floats
// and writes one for 2*M FLOPs, about 0.4 FLOP per byte.  So the design is
// one pass over the (M, P) deltas with as many bytes in flight as the card
// needs, whatever P's alignment:
//   * a block owns 2048 columns of P (a warp 256, a lane 8: lane + 32 j)
//     and streams its rows through a ring of kStages row tiles in shared
//     memory, filled by 16-byte cp.async copies.  A row tile is the
//     16-byte-aligned superset of the row's 2048 columns (513 chunks), so a
//     ragged P (rows starting at any float offset) is copied as whole
//     chunks too, each once; the lanes then read their columns at the
//     row's offset, with no bank conflicts.  Only a chunk reaching outside
//     the deltas buffer (the first row of a misaligned buffer, the last
//     row's end) is read a float at a time.  No registers hold the loads
//     in flight;
//   * a range of at most kStages rows (the main path's M' = 4) skips the
//     ring: a separate instantiation loads its rows straight into
//     registers, every load in flight at once, since there latency and not
//     bandwidth sets the time;
//   * the coefficients reach the lanes through a shuffle from a register
//     holding 32 of them, the next 32 loaded one period ahead; w is loaded
//     into registers before the rows, so its latency hides behind theirs;
//   * the reduction over M is split into `splits` ranges (grid.y) when the
//     column tiles alone leave the card short of blocks.  The blocks of one
//     column tile form a thread-block cluster along M; rank 0 sums its
//     peers' partial rows from distributed shared memory in rank order and
//     writes out = w + sum.  One launch, no workspace, no atomics: two
//     launches give the same bits;
//   * the sums run in a fixed order: within a range m ascending, fmaf into
//     an fp32 accumulator that starts at 0, then the ranges' partials in
//     rank order, then w is added, as in w + coeffs @ d.  With splits = 1
//     (the wrapper's choice for M < 64, the main path's M' = 4 among them)
//     that is one accumulator over m = 0 .. M-1, the order of w + coeffs @ d
//     taken row by row;
//   * 64-bit element offsets; ragged P is masked in the kernel.
// At the paper's shapes (M = 4 retained clients, P = 206,922) the whole call
// moves ~5 MB, about 1.5 us at 3.35 TB/s: launch overhead dominates, which
// is why the launch count per request is recorded beside its time.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 8;                     // columns of P per lane
constexpr int kWarpCols = 32 * kCols;        // columns of P per warp
constexpr int kTileP = kWarps * kWarpCols;   // columns of P per block
constexpr int kRowFloats = kTileP + 4;       // a staged row: 513 16-byte chunks
constexpr int kStages = 4;                   // rows in flight per warp
constexpr int kMaxSplits = 8;                // the portable cluster size

// common.cuh's cp_async16 with a 256-byte L2 prefetch added: the rows
// stream
__device__ __forceinline__ void cp_async16_l2(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

template <bool kFew>
__global__ void __launch_bounds__(kThreads)
calibrate_kernel(const float* __restrict__ w, const float* __restrict__ d,
                 const float* __restrict__ coeffs, float* __restrict__ out,
                 int M, int64_t P, int splits) {
  __shared__ __align__(16) float ring[kStages][kRowFloats];
  __shared__ float part[kTileP];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * kTileP +
                       warp * kWarpCols;
  const int per = (M + splits - 1) / splits;
  const int m_lo = static_cast<int>(blockIdx.y) * per;
  const int rows = M - m_lo < per ? (M - m_lo > 0 ? M - m_lo : 0) : per;
  // d's float offset from a 16-byte boundary: row m's tile starts at
  // element m*P + col0, whose chunk starts (base + m*P + col0) % 4 earlier
  const int base = static_cast<int>(
      (reinterpret_cast<uintptr_t>(d) / sizeof(float)) & 3);
  const int64_t total = static_cast<int64_t>(M) * P;
  const int ncols = P - col0 < kWarpCols ? static_cast<int>(P - col0)
                                         : kWarpCols;  // <= 0: idle warp
  // the block that writes out (rank 0 of a cluster) loads w first
  const bool writer = blockIdx.y == 0;
  float acc[kCols], wv[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    acc[j] = 0.f;
    wv[j] = writer && lane + 32 * j < ncols ? w[col0 + lane + 32 * j] : 0.f;
  }

  if (kFew && ncols > 0) {
    // at most kStages rows (the main path's M' = 4): every load in flight
    // at once, straight into registers
    const float kc = lane < rows ? coeffs[m_lo + lane] : 0.f;
    float v[kStages][kCols];
#pragma unroll
    for (int i = 0; i < kStages; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        v[i][j] = i < rows && lane + 32 * j < ncols
                      ? d[static_cast<int64_t>(m_lo + i) * P + col0 + lane +
                          32 * j]
                      : 0.f;
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      const float k = __shfl_sync(0xffffffffu, kc, i);
      if (i < rows)
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[j] = fmaf(k, v[i][j], acc[j]);
    }
  } else if (!kFew) {
    // the block's row tile: columns tile0 .. tile0+bcols of row m start
    // (base + m*P + tile0) % 4 floats into their first 16-byte chunk
    const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * kTileP;
    const int bcols = P - tile0 < kTileP ? static_cast<int>(P - tile0)
                                         : kTileP;
    const int off0 = static_cast<int>((base + tile0) & 3);
    const int pm4 = static_cast<int>(P & 3);
    auto offset = [&](int m) { return (off0 + (m & 3) * pm4) & 3; };
    auto issue = [&](int m, float* buf) {
      const int off = offset(m);
      const int64_t a0 = static_cast<int64_t>(m) * P + tile0 - off;
      const int nchunks = (off + bcols + 3) / 4;
      for (int c = threadIdx.x; c < nchunks; c += kThreads) {
        const int64_t e = a0 + 4 * c;
        if (e >= 0 && e + 4 <= total) {
          cp_async16_l2(buf + 4 * c, d + e);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (e + j >= 0 && e + j < total) buf[4 * c + j] = d[e + j];
        }
      }
    };
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      if (i < rows) issue(m_lo + i, ring[i]);
      cp_async_commit();
    }
    float kc = lane < rows ? coeffs[m_lo + lane] : 0.f;
    float kn = lane + 32 < rows ? coeffs[m_lo + 32 + lane] : 0.f;
    for (int i = 0; i < rows; ++i) {
      if (i > 0 && (i & 31) == 0) {
        kc = kn;
        kn = i + 32 + lane < rows ? coeffs[m_lo + i + 32 + lane] : 0.f;
      }
      const float k = __shfl_sync(0xffffffffu, kc, i & 31);
      cp_async_wait<kStages - 1>();      // this thread's copies of row i
      __syncthreads();                   // everyone's
      const float* row = ring[i % kStages] + offset(m_lo + i) +
                         warp * kWarpCols;
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        if (lane + 32 * j < ncols)
          acc[j] = fmaf(k, row[lane + 32 * j], acc[j]);
      __syncthreads();                   // the stage is read: refill it
      if (i + kStages < rows) issue(m_lo + i + kStages, ring[i % kStages]);
      cp_async_commit();
    }
    cp_async_wait<0>();
  }

  if (splits == 1) {
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      if (lane + 32 * j < ncols) out[col0 + lane + 32 * j] = wv[j] + acc[j];
    return;
  }
  // rank r of the cluster (1, splits, 1) is blockIdx.y = r: rows [r*per, ..).
  // A thread's partials sit at the same slots in every rank's ``part``.
  cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
  for (int j = 0; j < kCols; ++j) part[threadIdx.x + kThreads * j] = acc[j];
  cluster.sync();
  if (writer) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      float s = acc[j];
      for (int r = 1; r < splits; ++r)
        s += cluster.map_shared_rank(part, r)[threadIdx.x + kThreads * j];
      if (lane + 32 * j < ncols) out[col0 + lane + 32 * j] = wv[j] + s;
    }
  }
  cluster.sync();                        // peers keep their shared memory
}

}  // namespace

// w (P,), deltas (M,P), coeffs (M,), out (P,): f32, contiguous, on the
// device, 4-byte aligned (any P and any offset).  splits (1 .. 8, at most
// M) is the number of ranges the sum over M is cut into, chosen by the
// wrapper.  Returns cudaGetLastError() after the launch.
extern "C" int repro_calibrate(const float* w, const float* deltas,
                               const float* coeffs, float* out, int64_t M,
                               int64_t P, int splits, void* stream) {
  if (M < 1 || M > 0x7fffffffLL || P < 1 || splits < 1 ||
      splits > kMaxSplits || splits > M ||
      (P + kTileP - 1) / kTileP > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((P + kTileP - 1) / kTileP),
                     static_cast<unsigned>(splits));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = static_cast<unsigned>(splits);
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  const bool few = (M + splits - 1) / splits <= kStages;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, few ? calibrate_kernel<true> : calibrate_kernel<false>, w, deltas,
      coeffs, out, static_cast<int>(M), P, splits);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

