// Causal sliding-window attention for Hopper, forward for bf16 operands on
// wgmma and TMA (FlashAttention-3's form).  It computes what
// wattn_fwd_bf16_kernel in window_attn.cu computes, the TPU kernel's
// arithmetic at bf16 (src/repro/kernels/window_attn/kernel.py,
// window_attention_kernel): S = Q K^T as bf16 products with fp32 sums, an
// online softmax in fp32, P = exp(s - m) rounded to bf16 before P V (fp32
// sums), O in bf16 and lse = log sum exp in fp32.  Query i attends keys j
// with i - window < j <= i at scale hd^-1/2; q: (B, S, H, hd), k, v:
// (B, S, KV, hd), query head h reading kv head h / (H / KV); O (B, S, H,
// hd) and lse (B, H, S) contiguous.  The wrapper (window_attn/ops.py,
// ``bf16_route``) sends a call here when hd is 64 or 128 and q, k and v
// start on 16 bytes with every stride but the head dim's a multiple of 8
// elements (TMA's 16-byte global strides); everything else stays on the
// mma.sync route.
//
// What bounds it on an H100: the products.  At gemma3-27b's local layer
// (B 2, S 4096, 32 heads of 128 over 16, window 1024) the forward does 4 hd
// FLOPs a (query, key) pair in the window, 120 GFLOP, 0.122 ms at the bf16
// tensor-core rate (989 TFLOP/s), against 0.15 GB of bf16 inputs and
// outputs (0.045 ms).  mma.sync reaches about a fifth of that rate on
// Hopper; only wgmma reaches all of it, so the design feeds wgmma:
//  * A block owns a 128-query tile of one head (grid: query tiles x B H)
//    and walks the 128-key tiles its windows reach (9 at gemma3's shape, of
//    which the first and the last straddle the window's edges).  It has
//    three warpgroups: two consumers, each owning 64 of the query rows, and
//    one producer.  A 128-query tile of one head (and not two query heads
//    of one kv head, as the fp32 route's two-head block) serves every GQA
//    ratio, odd ones included, and gives both consumers the same K and V
//    tiles at the cost of a window's span of 128 + 128 keys for 64-row
//    halves.
//  * The producer (setmaxnreg down to 40 registers) issues every load by
//    TMA from one thread: Q once (a box of 128 rows x 64 columns per 64
//    columns of hd), then each key tile's K and V into a ring of three
//    stages (the loads alone take a third of the kernel's time at gemma3's
//    shape, PERF.md), each with a full and an empty mbarrier for K and one
//    pair for V,
//    so a consumer starts Q K^T when K has landed while V is in flight.  The
//    tensor maps are encoded on the host over (hd, heads, S, B) from the
//    strides the wrapper passes; rows past S arrive as zeros.  The boxes use
//    the 128-byte swizzle, which the wgmma descriptors name: a 64-column box
//    is 128-byte rows, 8-row atoms of 1,024 bytes, so hd 128 is two boxes.
//  * Each consumer (setmaxnreg up to 232) computes its 64 rows' S = Q K^T
//    with wgmma m64n128k16 (A = Q, B = K, both K-major from shared memory,
//    hd / 16 k-steps), the base-2 online softmax on the accumulators in
//    registers (masks only on tiles that straddle an edge; the guard for
//    rows that have seen no key), packs P to bf16 in registers and computes
//    O += P V with wgmma m64n(hd)k16 RS: the accumulator fragment of two
//    score n-tiles is the register A fragment of one 16-key step, and V is
//    the B operand in shared memory, MN-major (hd contiguous), read
//    transposed.  O is scaled by the softmax's correction before each P V.
//  * The consumers take the tensor cores in turns (FlashAttention-3's
//    ping-pong, on two named barriers), a turn issuing one consumer's P V
//    of tile i and Q K^T of tile i + 1 back to back; each product is
//    waited for before the softmax reads it, so one consumer's softmax
//    runs under the other's products.  Without turns the two ran in
//    lockstep, their softmaxes together with the tensor cores idle; with
//    a turn for each product they gained 4.5 %, with both products in one
//    turn 12 % (PERF.md, section 6).  No branch is taken while a product
//    is in flight (ptxas serializes every wgmma of the kernel otherwise),
//    so both consumers run every key tile of the block.  Running the
//    softmax of tile i + 1 under the consumer's own P V of tile i as well
//    lost 2 % against this.
//  * O leaves through shared memory (the consumer's rows of the Q tile,
//    in the same swizzle), in coalesced 16-byte stores; lse in fp32.
//  * No atomics: two launches give the same bits.  P rounds at the running
//    max of each 128-key tile (the mma.sync route's tiles are 64 keys), so
//    the two routes' bits differ, each within 2^-8 (max|v| + |r|) of the
//    plain version (window_attn/ref.py).
#include <atomic>
#include <cstdint>
#include <initializer_list>
#include <utility>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kQT = 128;          // query rows a block (two consumers of 64)
constexpr int kKT = 128;          // keys a tile
// K and V tiles in flight: 3 fills shared memory at hd 128 (225 KB with
// Q); 2 timed the same (PERF.md, section 6)
constexpr int kStages = 3;
constexpr int kBoxCols = 64;      // hd columns a TMA box: 128 bytes of bf16
constexpr int kBoxBytes = 128 * kBoxCols * 2;   // a 128-row box
constexpr int kThreadsTma = 384;  // consumers 0, 1 and the producer

struct GeomT {
  int S, H, KV, window;
  float scale;
};

// ---- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// named barrier ``id`` of ``n`` threads: wait for it, or arrive and go on
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// until the phase of parity ``parity`` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// a 4-d box (c0: hd column, c1: head, c2: sequence row, c3: batch) into
// shared memory, completing on ``bar``
__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int c0, int c1, int c2,
                                          int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
        "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---- wgmma -------------------------------------------------------------------
//
// A shared-memory operand's descriptor for the 128-byte swizzle: start
// address >> 4 in bits 0-13, the leading and the stride byte offsets >> 4
// in bits 16-29 and 32-45, layout type 1 (128-byte swizzle) in bits 62-63;
// base offset 0 (every tile starts on 1,024 bytes).  K-major (Q and K: hd
// contiguous): rows of 128 bytes, 8-row groups 1,024 bytes apart (stride
// offset), the leading offset unused (1); a 16-element k-step moves the
// start 32 bytes along the row, and past 64 columns to the next box.
// MN-major (V: hd contiguous, k = keys down the rows): 64 hd columns a
// 128-byte row, 8 keys a 1,024-byte group (stride offset), the next 64
// columns one box further (leading offset); a 16-key step moves the start
// 2,048 bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (uint64_t{1} << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N committed groups of this warp's products are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of wgmma's registers
// across the asynchronous product (the asm claims to change them here).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (+)= A B, m64n128k16, A and B from shared memory (K-major)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                            uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// d += A B, m64n128k16, A from registers, B from shared memory
// (MN-major: transposed)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B, m64n64k16, A from registers, B from shared memory
// (MN-major: transposed)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// The online softmax of one key tile on the score accumulators, in base 2:
// masks where the tile is not ``full`` (some pair out of the window or past
// S), the rows' running max m (scaled by c2 = log2(e) / sqrt(hd)) and the
// correction corr = 2^(m_old - m) for O and l, then s becomes P = 2^(s c2 -
// m), summed unrounded into l.  A row that has seen no key yet keeps m =
// -inf, P = 0 and corr = 1.
__device__ __forceinline__ void softmax_tile(float (&s)[kKT / 2], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             bool full, int ra, int k0, int tq,
                                             const GeomT& g, float c2) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kKT / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hr = e >> 1;
      if (!full) {
        const int qi = ra + 8 * hr, kj = k0 + 8 * j + 2 * tq + (e & 1);
        if (!(qi < g.S && kj < g.S && kj <= qi && kj > qi - g.window))
          s[4 * j + e] = -INFINITY;
      }
      mx[hr] = fmaxf(mx[hr], s[4 * j + e]);
    }
  bool none[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
    mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
    const float mn = fmaxf(m[hr], mx[hr] * c2);
    none[hr] = mn == -INFINITY;                  // no key of this row yet
    corr[hr] = none[hr] ? 1.f : ex2(m[hr] - mn);
    m[hr] = mn;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kKT / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hr = e >> 1;
      s[4 * j + e] = none[hr] ? 0.f : ex2(fmaf(s[4 * j + e], c2, -m[hr]));
      rs[hr] += s[4 * j + e];
    }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    rs[hr] += __shfl_xor_sync(0xffffffffu, rs[hr], 1);
    rs[hr] += __shfl_xor_sync(0xffffffffu, rs[hr], 2);
    l[hr] = fmaf(l[hr], corr[hr], rs[hr]);
  }
}

// P as the register A operand of P V: k-step kk (keys 16 kk .. +15) is
// score n-tiles 2 kk and 2 kk + 1, rounded to bf16
__device__ __forceinline__ void pack_p(uint32_t (&pa)[kKT / 16][4],
                                       const float (&s)[kKT / 2]) {
#pragma unroll
  for (int kk = 0; kk < kKT / 16; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// ---- the kernel ----------------------------------------------------------------
//
// Shared memory (dynamic, from a 1,024-byte boundary): the Q tile, then the
// K tiles and the V tiles of the stages, each HD / 64 boxes of 128 rows x
// 128 bytes.  mbarriers (static): Q full; K full, V full, K empty, V empty
// per stage.  A full barrier counts the producer's one arrival and the
// box bytes; an empty one the 8 consumer warps, lane 0 of each arriving
// when the warp's wait for the product that read the tile has returned
// (one arrival a warp, not 32: they serialize on the barrier's word).
//
// Consumer lane (warp w of its warpgroup, gq = lane / 4, tq = lane % 4)
// holds rows 16 w + gq and + 8 of its 64; a score accumulator s[4 j + e]
// is row + 8 (e >> 1), key 8 j + 2 tq + (e & 1) of the tile (n-tile j),
// and O's acc[4 j + e] the same rows at hd column 8 j + 2 tq + (e & 1).

template <int HD>
__host__ __device__ constexpr int tma_tile_bytes() { return HD / kBoxCols * kBoxBytes; }

template <int HD>
__host__ __device__ constexpr int tma_smem_bytes() {
  return (1 + 2 * kStages) * tma_tile_bytes<HD>() + 1024;  // + alignment
}

template <int HD>
__global__ void __launch_bounds__(kThreadsTma, 1)
wattn_fwd_bf16_tma_kernel(const __grid_constant__ CUtensorMap mq,
                          const __grid_constant__ CUtensorMap mk,
                          const __grid_constant__ CUtensorMap mv,
                          __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, GeomT g) {
  constexpr int kSubs = HD / kBoxCols, kTileB = tma_tile_bytes<HD>();
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 4 * kStages];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t sq = base;
  const uint32_t bar0 = smem_u32(bars);
  // tiles and barriers by stage
  const auto sk = [&](int st) { return base + (1 + st) * kTileB; };
  const auto sv = [&](int st) { return base + (1 + kStages + st) * kTileB; };
  const auto k_full = [&](int st) { return bar0 + 8 * (1 + st); };
  const auto v_full = [&](int st) { return bar0 + 8 * (1 + kStages + st); };
  const auto k_empty = [&](int st) { return bar0 + 8 * (1 + 2 * kStages + st); };
  const auto v_empty = [&](int st) { return bar0 + 8 * (1 + 3 * kStages + st); };

  const int b = blockIdx.y / g.H, h = blockIdx.y % g.H;
  const int kvh = h / (g.H / g.KV);
  const int q0 = blockIdx.x * kQT;
  const int k_lo = max(0, q0 - g.window + 1) / kKT * kKT;
  const int k_hi = min(g.S, q0 + kQT);
  const int ntiles = (k_hi - k_lo + kKT - 1) / kKT;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bar0, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(k_empty(st), 8);
      mbar_init(v_empty(st), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread issues every TMA load -----------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      mbar_expect_tx(bar0, kTileB);
#pragma unroll
      for (int c = 0; c < kSubs; ++c)
        tma_load4(sq + c * kBoxBytes, &mq, bar0, c * kBoxCols, h, q0, b);
      for (int i = 0; i < ntiles; ++i) {
        const int st = i % kStages, k0 = k_lo + i * kKT;
        const uint32_t free_par = ((i / kStages) & 1) ^ 1;
        mbar_wait(k_empty(st), free_par);
        mbar_expect_tx(k_full(st), kTileB);
#pragma unroll
        for (int c = 0; c < kSubs; ++c)
          tma_load4(sk(st) + c * kBoxBytes, &mk, k_full(st), c * kBoxCols, kvh,
                    k0, b);
        mbar_wait(v_empty(st), free_par);
        mbar_expect_tx(v_full(st), kTileB);
#pragma unroll
        for (int c = 0; c < kSubs; ++c)
          tma_load4(sv(st) + c * kBoxBytes, &mv, v_full(st), c * kBoxCols, kvh,
                    k0, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows each -------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int gq = lane >> 2, tq = lane & 3;
    const int qc = q0 + 64 * wg;                 // the consumer's first row
    const int ra = qc + 16 * warp + gq;          // this lane's rows ra, ra + 8
    const float c2 = g.scale * kLog2e;
    const uint32_t qa = sq + wg * 64 * 128;      // its rows of each Q box
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2];
    float acc[HD / 2], s[kKT / 2];
    uint32_t pa[kKT / 16][4];
#pragma unroll
    for (int n = 0; n < HD / 2; ++n) acc[n] = 0.f;
#pragma unroll
    for (int n = 0; n < kKT / 2; ++n) s[n] = 0.f;
    // S = Q K^T of key tile i's stage, issued (not waited for)
    const auto issue_qk = [&](int st) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
        wgmma_ss_n128(s, sw128_desc(qa + off, 16, 1024),
                      sw128_desc(sk(st) + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
    };
    // O += P V of a stage's V tile, issued (not waited for)
    const auto issue_pv = [&](int st) {
#pragma unroll
      for (int kk = 0; kk < kKT / 16; ++kk) {
        const uint64_t dv = sw128_desc(sv(st) + kk * 2048, kBoxBytes, 1024);
        if constexpr (HD == 128)
          wgmma_rs_n128(acc, pa[kk], dv);
        else
          wgmma_rs_n64(acc, pa[kk], dv);
      }
      wgmma_commit();
    };
    const auto tile_full = [&](int k0) {
      return k0 + kKT - 1 <= qc && k0 + g.window > qc + 63;
    };
    mbar_wait(bar0, 0);
    // The consumers take the tensor cores in turns (named barriers 3 and
    // 4, one a consumer, of both warpgroups' 256 threads): a consumer
    // waits for its turn, issues its products, hands the turn over and
    // then waits for them, so one consumer's softmax runs while the
    // other's products do.  A turn issues tile i's P V and tile i + 1's
    // Q K^T back to back (the first turn tile 0's Q K^T alone).  No
    // branch is taken while a product is in flight (ptxas serializes
    // every wgmma otherwise, C7518): both consumers run every tile of the
    // block, and a tile none of a consumer's rows sees is masked whole (P
    // = 0, m, l and O kept).  Consumer 0 goes first; consumer 1's last
    // hand-over is taken after the loop.
    const int mine = 3 + wg, theirs = 4 - wg;
    // the softmax of key tile k0's scores, O's correction and P
    const auto take = [&](int k0) {
      softmax_tile(s, m, l, corr, tile_full(k0), ra, k0, tq, g, c2);
      // O keeps its value where the row's max did not move
      if (corr[0] != 1.f || corr[1] != 1.f) {
#pragma unroll
        for (int n = 0; n < HD / 2; ++n) acc[n] *= corr[(n >> 1) & 1];
      }
      pack_p(pa, s);
    };
    if (wg == 1) bar_arrive(3, 256);
    // first turn: tile 0's Q K^T
    mbar_wait(k_full(0), 0);
    bar_sync(mine, 256);
    fence_regs(s);
    wgmma_fence();
    issue_qk(0);
    bar_arrive(theirs, 256);
    wgmma_wait<0>();
    fence_regs(s);
    if (lane == 0) mbar_arrive(k_empty(0));
    take(k_lo);
    // then a turn a tile: tile i's P V and tile i + 1's Q K^T (on the last
    // tile, a Q K^T of the next stage's stale K, its result dropped: no
    // branch while a product is in flight)
    for (int i = 0; i < ntiles; ++i) {
      const int st = i % kStages, k0 = k_lo + i * kKT;
      const int sn = (i + 1) % kStages;
      const bool more = i + 1 < ntiles;
      mbar_wait(v_full(st), (i / kStages) & 1);
      if (more) mbar_wait(k_full(sn), ((i + 1) / kStages) & 1);
      bar_sync(mine, 256);
      fence_regs(acc);
      fence_regs(pa);
      fence_regs(s);
      wgmma_fence();
      issue_pv(st);
      issue_qk(sn);
      bar_arrive(theirs, 256);
      wgmma_wait<1>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(v_empty(st));
      wgmma_wait<0>();
      fence_regs(s);
      if (more) {
        if (lane == 0) mbar_arrive(k_empty(sn));
        take(k0 + kKT);
      }
    }
    if (wg == 0) bar_sync(3, 256);

    // O through this consumer's rows of the Q tile (every warp of the
    // warpgroup is past its last product on them), in Q's swizzle
    bar_sync(1 + wg, 128);
    uint8_t* oq = smem_raw + (qa - raw);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const float inv = 1.f / l[hr];
      const int r = 16 * warp + gq + 8 * hr;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<uint32_t*>(oq + (j / 8) * kBoxBytes + r * 128 +
                                     (((j % 8) ^ (r & 7)) << 4) + 4 * tq) =
            pack_bf16(acc[4 * j + 2 * hr] * inv, acc[4 * j + 2 * hr + 1] * inv);
    }
    bar_sync(1 + wg, 128);
    constexpr int kChunks = HD / 8;              // 16 bytes each
#pragma unroll
    for (int idx = t; idx < 64 * kChunks; idx += 128) {
      const int r = idx / kChunks, cc = idx % kChunks, qi = qc + r;
      if (qi < g.S)
        *reinterpret_cast<uint4*>(
            o + ((static_cast<int64_t>(b) * g.S + qi) * g.H + h) * HD + cc * 8) =
            *reinterpret_cast<const uint4*>(oq + (cc / 8) * kBoxBytes + r * 128 +
                                            (((cc % 8) ^ (r & 7)) << 4));
    }
    if (tq == 0) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int qi = ra + 8 * hr;
        if (qi < g.S)
          lse[(static_cast<int64_t>(b) * g.H + h) * g.S + qi] =
              (m[hr] + log2f(l[hr])) * kLn2;
      }
    }
  }
}

// ---- host side ---------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so the
// library links no libcuda
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    return err == cudaSuccess && res == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A (B, S, heads, hd) bf16 operand over (hd, heads, S, B), element strides
// (sh, ss, sb), the head dim contiguous; 64 x 1 x 128 x 1 boxes in the
// 128-byte swizzle; rows past S read as zeros.  A dim of extent 1 is never
// stepped, so it gets the packed stride of the dims below it.
bool encode(CUtensorMap* map, const void* ptr, int64_t B, int S, int heads,
            int hd, int64_t sh, int64_t ss, int64_t sb) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const int64_t ext[3] = {heads, S, B}, el[3] = {sh, ss, sb};
  cuuint64_t strides[3];
  int64_t below = 2 * hd;                      // bytes the lower dims span
  for (int i = 0; i < 3; ++i) {
    const int64_t bytes = ext[i] == 1 ? (below + 15) / 16 * 16 : 2 * el[i];
    strides[i] = static_cast<cuuint64_t>(bytes);
    below = bytes * ext[i] > below ? bytes * ext[i] : below;
  }
  const cuuint32_t box[4] = {kBoxCols, 1, kKT, 1}, step[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// TMA's conditions: 16-byte aligned base, every stepped stride a positive
// multiple of 8 elements (16 bytes) under 2^39 elements
bool tma_ok(const void* p, std::initializer_list<std::pair<int64_t, int64_t>>
                               extent_stride) {
  if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  for (const auto& es : extent_stride)
    if (es.first > 1 && (es.second <= 0 || es.second % 8 ||
                         es.second >= (int64_t{1} << 39)))
      return false;
  return true;
}

template <int HD>
int launch_tma(const void* q, const void* k, const void* v, void* o, float* lse,
               int64_t B, const GeomT& g, const int64_t (&st)[9],
               cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!encode(&mq, q, B, g.S, g.H, HD, st[2], st[1], st[0]) ||
      !encode(&mk, k, B, g.S, g.KV, HD, st[5], st[4], st[3]) ||
      !encode(&mv, v, B, g.S, g.KV, HD, st[8], st[7], st[6]))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = tma_smem_bytes<HD>();
  // the shared-memory limit is a device's attribute of the function: set
  // once a device (bit d of ``raised``), not at every launch
  static std::atomic<uint64_t> raised{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (!(raised.load(std::memory_order_relaxed) & bit)) {
    err = cudaFuncSetAttribute(wattn_fwd_bf16_tma_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    raised.fetch_or(bit, std::memory_order_relaxed);
  }
  const dim3 grid((g.S + kQT - 1) / kQT, static_cast<unsigned>(B * g.H));
  wattn_fwd_bf16_tma_kernel<HD><<<grid, kThreadsTma, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), lse, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Forward of bf16 q, k, v on wgmma and TMA, with the arguments of
// repro_window_attn_fwd_bf16 (window_attn.cu): q (B,S,H,hd), k and v
// (B,S,KV,hd) with element strides (q_sb, q_ss, q_sh) etc. and a contiguous
// head dim; o (B,S,H,hd) bf16 and lse (B,H,S) fp32 contiguous.  Takes hd 64
// or 128 with 16-byte aligned q, k, v and strides of multiples of 8
// elements (the wrapper's ``bf16_route``), and returns
// cudaErrorInvalidValue on anything else.  Returns cudaGetLastError()
// after the launch.
extern "C" int repro_window_attn_fwd_bf16_tma(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int64_t B, int64_t S, int64_t H, int64_t KV, int64_t hd, int64_t window,
    float scale, int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
    int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
    void* stream) {
  if (B < 1 || S < 1 || S > 0x7fffffffLL || H < 1 || KV < 1 || H % KV ||
      window < 1 || window > 0x7fffffffLL || B * H > 65535 ||
      (hd != 64 && hd != 128) || reinterpret_cast<uintptr_t>(o) % 16 ||
      !tma_ok(q, {{B, q_sb}, {S, q_ss}, {H, q_sh}}) ||
      !tma_ok(k, {{B, k_sb}, {S, k_ss}, {KV, k_sh}}) ||
      !tma_ok(v, {{B, v_sb}, {S, v_ss}, {KV, v_sh}}))
    return static_cast<int>(cudaErrorInvalidValue);
  const GeomT g = {static_cast<int>(S), static_cast<int>(H),
                   static_cast<int>(KV), static_cast<int>(window), scale};
  const int64_t st[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return hd == 64 ? launch_tma<64>(q, k, v, o, lse, B, g, st, s)
                  : launch_tma<128>(q, k, v, o, lse, B, g, st, s);
}
