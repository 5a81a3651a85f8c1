// What every kernel of the port shares: fp32 <-> storage-type conversion,
// warp reductions, the warp-level tensor-core and asynchronous-copy
// instructions, and the C-interface plumbing (each source is built into a
// library of its own, and each library exports repro_error_string).
//
// The instruction wrappers (mma_bf16_16816, ldmatrix_x4[_trans],
// cp_async16/cp_async4, cp_async_commit, cp_async_wait) are inline PTX on
// the card.  Compiled with a host compiler against the CPU stand-in headers
// of tests/cuda_emu/ (REPRO_CUDA_EMU), they call the stand-in's
// warp-collective versions, which exchange the lanes' fragments and compute
// each lane's share with the PTX fragment layout, so a kernel's fragment
// indexing is checked on the CPU.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace repro {

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// ------------------------------------------ warp-level tensor cores, copies
//
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32: d += a . b for one
// warp, a 16x16 (row-major) and b 16x8 (column-major) of bf16 pairs packed
// in 32-bit registers, d 16x8 fp32.  With g = lane / 4, q = lane % 4:
//   a[0] = A[g][2q..2q+1]      a[1] = A[g+8][2q..2q+1]
//   a[2] = A[g][2q+8..2q+9]    a[3] = A[g+8][2q+8..2q+9]
//   b[0] = B[2q..2q+1][g]      b[1] = B[2q+8..2q+9][g]
//   d[0..1] = D[g][2q..2q+1]   d[2..3] = D[g+8][2q..2q+1]
// ldmatrix_x4 loads four 8x8 b16 matrices from shared memory, lanes 8i..8i+7
// giving the row addresses of matrix i; register i of lane l then holds row
// l / 4, columns 2 (l % 4) and 2 (l % 4) + 1 of matrix i (the _trans form:
// column l / 4, rows 2 (l % 4) and 2 (l % 4) + 1).

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(hi)))
          << 16);
}

#if defined(__CUDA_ARCH__)
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
#endif

__device__ __forceinline__ void mma_bf16_16816(float d[4], const uint32_t a[4],
                                               const uint32_t b[2]) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
#elif defined(REPRO_CUDA_EMU)
  emu_mma_bf16_16816(d, a, b);
#endif
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
#elif defined(REPRO_CUDA_EMU)
  emu_ldmatrix_x4(r, p, false);
#endif
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
#elif defined(REPRO_CUDA_EMU)
  emu_ldmatrix_x4(r, p, true);
#endif
}

// Asynchronous global -> shared copies of 16 (cp_async16, 16-byte aligned
// both sides) or 4 bytes; the first src_bytes are read and the rest of the
// destination is zero-filled (src_bytes 0: zeros, src is not read but must
// be a valid address).  Complete after cp_async_commit() and
// cp_async_wait<N>() (all but the N most recent committed groups).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
#elif defined(REPRO_CUDA_EMU)
  emu_cp_async(dst, src, 16, src_bytes);
#endif
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
#elif defined(REPRO_CUDA_EMU)
  emu_cp_async(dst, src, 4, src_bytes);
#endif
}

__device__ __forceinline__ void cp_async_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#elif defined(REPRO_CUDA_EMU)
  emu_cp_async_commit();
#endif
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#elif defined(REPRO_CUDA_EMU)
  emu_cp_async_wait(N);
#endif
}

// cp_async_wait<n> for a count known only at run time (0..15; a larger n
// waits for every group, which is never too early).
__device__ __forceinline__ void cp_async_wait_dyn(int n) {
  switch (n) {
#define REPRO_WAIT_CASE(k) \
  case k:                  \
    cp_async_wait<k>();    \
    break;
    REPRO_WAIT_CASE(1) REPRO_WAIT_CASE(2) REPRO_WAIT_CASE(3)
    REPRO_WAIT_CASE(4) REPRO_WAIT_CASE(5) REPRO_WAIT_CASE(6)
    REPRO_WAIT_CASE(7) REPRO_WAIT_CASE(8) REPRO_WAIT_CASE(9)
    REPRO_WAIT_CASE(10) REPRO_WAIT_CASE(11) REPRO_WAIT_CASE(12)
    REPRO_WAIT_CASE(13) REPRO_WAIT_CASE(14) REPRO_WAIT_CASE(15)
#undef REPRO_WAIT_CASE
    default:
      cp_async_wait<0>();
  }
}

// A barrier across the blocks of a cooperative launch (all resident) that
// share `count`: every such block arrives once per barrier, and `target`
// is (barriers so far) x (blocks sharing the counter); the counter is
// zeroed before the launch.  Arrival is a release add after the block's
// writes, the wait an acquire load (the pattern of CUTLASS's semaphore).
// Under the CPU emulation, which runs blocks one at a time, kernels that use
// it are launched once per step instead, so it only synchronises the block.
__device__ __forceinline__ void grid_barrier(unsigned* count,
                                             unsigned target) {
  __syncthreads();
#if defined(__CUDA_ARCH__)
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n" ::"l"(count),
                 "r"(1u)
                 : "memory");
    unsigned v;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(v)
                   : "l"(count)
                   : "memory");
    } while (v < target);
  }
#endif
  __syncthreads();
}

}  // namespace repro

// Every library exports its own copy (each source is its own library).
extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
