// Device helpers shared by the kernels of this directory: cp.async groups,
// bf16 widening loads and packing, base-2 exponentials and the 3xTF32
// tensor-core product.  Each .cu file
// includes this header before its own anonymous namespace, so every
// translation unit gets its own copy of these inline functions.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// a shared-memory pointer as the 32-bit address PTX takes
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 2^x on the special-function unit (ex2.approx.ftz: relative error about
// 2^-22, results under 2^-126 flushed to 0), where exp2f adds range tests
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// (lo, hi) rounded to bf16 (to nearest even) in one register
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---- cp.async --------------------------------------------------------------
//
// n bytes into shared memory, or zeros when ``ok`` is false (nothing is
// read then).  16-byte copies bypass L1 (.cg), smaller ones go through it
// (.ca: .cg takes only 16).

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok = true) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 8 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { cp_async_wait<0>(); }

// ---- widening loads: 1, 2 or 4 consecutive fp32 or bf16 elements as fp32 --

__device__ __forceinline__ float wload1(const float* p) { return *p; }
__device__ __forceinline__ float wload1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float2 wload2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 wload2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
// 16 bytes of fp32 or 8 of bf16 (aligned so)
__device__ __forceinline__ void wload4(const float* p, float* x) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
// 4 bf16 held in 8 bytes, widened
__device__ __forceinline__ float4 widen_bf16x4(uint2 u) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void wload4(const __nv_bfloat16* p, float* x) {
  const float4 v = widen_bf16x4(*reinterpret_cast<const uint2*>(p));
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
// 4 staged bf16 widened into an fp32 tile
__device__ __forceinline__ void widen4(float* dst, const __nv_bfloat16* src) {
  float x[4];
  wload4(src, x);
  *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
}

// ---- 3xTF32 on the tensor cores --------------------------------------------
//
// x = hi + lo + r: hi = cvt.rna.tf32.f32(x), x rounded to TF32 (11
// significant bits, to nearest, ties away); lo = cvt.rna.tf32.f32(x - hi)
// (x - hi is exact in fp32); |r| <= 2^-23 |x|.  Both roundings are done on
// the integer pipe: adding half a TF32 ulp (0x1000) to the bit pattern and
// dropping the 13 low bits is cvt.rna for finite x.  The mask is needed on
// hi, whose value forms the residual; lo keeps its low bits, which the
// tensor core does not read (CUTLASS's round_half_ulp_truncate relies on
// the same).  Four instructions, where cvt.rna.tf32.f32 compiles to a
// finiteness test, a predicated add and a mask for each of the two.  A
// value with at most 11 significant bits (every bf16) splits into hi = x,
// lo = 0.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

// d += a b, one m16n8k8 TF32 product with fp32 accumulation.  Lane
// (gq, tq) = (lane / 4, lane % 4) holds A a0 = (row gq, k tq), a1 = (gq +
// 8, tq), a2 = (gq, tq + 4), a3 = (gq + 8, tq + 4); B b0 = (k tq, column
// gq), b1 = (tq + 4, gq); C d0, d1 = (row gq, columns 2 tq, 2 tq + 1), d2,
// d3 the same at row gq + 8.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An fp32 operand fragment as its TF32 parts.
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// d += a b in 3xTF32: a_lo b_hi + a_hi b_lo, then a_hi b_hi (a_lo b_lo,
// about 2^-22 of the product, is dropped).
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(d, a.lo, b.hi[0], b.hi[1]);
  mma_tf32(d, a.hi, b.lo[0], b.lo[1]);
  mma_tf32(d, a.hi, b.hi[0], b.hi[1]);
}

}  // namespace
