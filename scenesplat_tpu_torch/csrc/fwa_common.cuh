// What the flash-window attention sources share: the 16-bit storage types
// (Elem: how two values pack into a 32-bit register, and the .bf16 or .f16
// form of mma.sync), and the PTX helpers (ldmatrix, cp.async, ex2). Each
// source includes it and builds into a library of its own; the library's
// name hashes this header with the source (ops/_build.py).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

using bf16 = __nv_bfloat16;
using fp16 = __half;

constexpr float LOG2E = 1.4426950408889634f;

// The storage types: bf16 and fp16 run the same kernels; what differs is
// how two values pack into a 32-bit register and the product's type.
template <typename T>
struct Elem;

template <>
struct Elem<bf16> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
  static __device__ __forceinline__ float2 unpack(uint32_t x) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
  }
  // d += a . b for one m16n8k16 tile (fp32 accumulators)
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

template <>
struct Elem<fp16> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
  static __device__ __forceinline__ float2 unpack(uint32_t x) {
    return __half22float2(*reinterpret_cast<const __half2*>(&x));
  }
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

// the two values of x times s, rounded to the storage type
template <typename T>
__device__ __forceinline__ uint32_t scale2(uint32_t x, float s) {
  const float2 v = Elem<T>::unpack(x);
  return Elem<T>::pack(v.x * s, v.y * s);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 16-bit matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// 16 bytes from device to shared memory, or 16 zero bytes when !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// 4 bytes, or 4 zero bytes when !ok
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

__device__ __forceinline__ float ex2(float x) {  // 2^x; 2^-inf = +0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
