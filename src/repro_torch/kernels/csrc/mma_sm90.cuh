// Warp-level tensor-core and async-copy helpers shared by the port's
// kernels (sm_90a): cp.async 16-byte copies with zero fill, ldmatrix and
// mma.sync m16n8k16 with bf16 operands and an f32 sum.
//
// Fragment layout of mma.sync.m16n8k16 (lane = 4 * group + quad):
//   A (16 x 16, row-major): a0 = (row group, cols 2q, 2q+1), a1 = row
//     group + 8, a2 = cols + 8, a3 = row + 8 and cols + 8;
//   B (16 x 8, stored as 8 rows of 16 k): b0 = (k 2q, 2q+1; n group),
//     b1 = k + 8;
//   C (16 x 8, f32): c0, c1 = (row group, cols 2q, 2q+1), c2, c3 = row + 8.
// The C layout of one product is the A layout of the next (two adjacent
// n-tiles of C make one 16-wide k-step of A), which flash attention uses
// to keep P in registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma {

// Raise a kernel's dynamic shared-memory limit to `bytes` on the current
// device when it grows past what was granted there (`granted`: one static
// array per kernel), so that later launches make no runtime call besides
// the launch (a launch inside a CUDA graph capture then needs none).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kern, size_t bytes, int* granted) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (bytes <= 48 * 1024 || (int)bytes <= granted[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e == cudaSuccess) granted[dev] = (int)bytes;
  return e;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// copy `bytes` (0 or 16) of `src` to shared `dst` and zero the rest of the
// 16; both 16-byte aligned. With bytes == 0 nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

// the same for 4 bytes (0..4 read), both 4-byte aligned
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8 x 8 b16 matrices; lanes 8i .. 8i+7 give the row addresses of
// matrix i, whose fragment lands in r[i]
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// the same, each matrix transposed on the way
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a . b on bf16 tensor cores, f32 sum
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 values as one bf16x2 word, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// v == t0 + t1 + t2 exactly, each term a bf16 (8 significand bits a term
// cover f32's 24; only terms below f32's normal range could be lost)
__device__ __forceinline__ void split3(float v, float& t0, float& t1,
                                       float& t2) {
  t0 = __bfloat162float(__float2bfloat16_rn(v));
  const float r = v - t0;
  t1 = __bfloat162float(__float2bfloat16_rn(r));
  t2 = r - t1;  // exact in bf16
}

}  // namespace mma
