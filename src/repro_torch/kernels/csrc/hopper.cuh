// Hopper's asynchronous machinery for the hand-written kernels: mbarriers,
// TMA tile loads and stores (cp.async.bulk.tensor) described by a
// CUtensorMap, 1D bulk copies (cp.async.bulk), the async-proxy fence, wgmma (m64nNk16 bf16 -> fp32, A from
// shared memory or registers, B from shared memory) with its fence, commit
// and wait, named barriers and setmaxnreg.  Written by hand as inline PTX
// for sm_90a, no CuTe or CUTLASS device code.  An in-flight wgmma still
// reads its register A operand and writes its accumulators: fence_regs and
// keep_regs pin them across the wait that retires it.
//
// Shared-memory tiles are in the 128-byte swizzle that TMA writes with
// CU_TENSOR_MAP_SWIZZLE_128B and that a wgmma descriptor of layout type 1
// reads: rows of 128 bytes, and within each 1024-byte atom of 8 rows the
// 16-byte chunk c of row r stored at chunk c ^ r.  The swizzle is a function
// of the shared-memory address (bits 4-6 ^= bits 7-9), so every tile starts
// on a 1024-byte boundary.  An operand's layout in a descriptor:
//   K-major (the reduction axis contiguous): element (mn, k) at
//     start + (mn / 8) SBO + (mn % 8) 128 + 2 k, SBO = 1024 for rows of 128
//     bytes; a 16-deep step moves the start by 32 bytes within the row.
//   MN-major (the output axis contiguous; the transpose bit): element (mn,
//     k) at start + (mn / 64) LBO + (k / 8) SBO + (k % 8) 128 + 2 (mn % 64):
//     a row holds 64 values of mn at one k, LBO is the distance between
//     64-wide column blocks (one TMA box each), SBO = 1024; a 16-deep step
//     moves the start by 2048 bytes.
// The wgmma accumulator of a warpgroup's 64 x N tile: thread t (warp w =
// t / 32, g = lane / 4, q = lane % 4) holds d[4 j + e] = D[16 w + g + 8 (e /
// 2)][8 j + 2 q + e % 2], the mma.sync m16n8 layout repeated over n; an A
// fragment in registers for a 16-deep step is mma.sync's A (a[0] = A[g][2q,
// 2q+1], a[1] = A[g+8][..], a[2] = A[g][2q+8, 2q+9], a[3] = A[g+8][..]).
//
// Compiled against the CPU stand-in headers of tests/cuda_emu/
// (REPRO_CUDA_EMU), each wrapper calls the stand-in's version: wgmma is a
// warpgroup-collective product that decodes the descriptors and the swizzle
// as above, TMA copies the box in the swizzled layout (zeros outside the
// tensor) and completes its bytes on the mbarrier only when a thread waits
// there, a 1D bulk load likewise, a TMA or bulk store writes at once, mbarriers keep phases and parity, and
// the tensor map's encoder is a stand-in that records what the copy reads.  So the layouts the kernels
// assume are checked on the CPU, and the card's phase `kernels` holds the
// stand-in to the hardware.
#pragma once

#include <cuda.h>

#include "common.cuh"

namespace repro {

// the shared-memory address of a generic pointer into shared memory
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
#if defined(__CUDA_ARCH__)
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
#elif defined(REPRO_CUDA_EMU)
  return emu_smem_u32(p);
#else
  return 0;
#endif
}

// `p` advanced to the next 1024-byte boundary of shared memory
__device__ __forceinline__ char* align1024(void* p) {
  const uint32_t a = smem_addr(p);
  return static_cast<char*>(p) + ((1024u - (a & 1023u)) & 1023u);
}

// the byte offset of logical offset `off` within a 1024-aligned tile of
// 128-byte rows, in the 128-byte swizzle (for stores by threads)
__device__ __forceinline__ uint32_t swz128(uint32_t off) {
  return off ^ (((off >> 7) & 7u) << 4);
}

// ------------------------------------------------------------ mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
#if defined(__CUDA_ARCH__)
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
#elif defined(REPRO_CUDA_EMU)
  emu_mbar_init(bar, count);
#endif
}

// after the inits, before any other thread uses the barriers
__device__ __forceinline__ void mbar_init_fence() {
#if defined(__CUDA_ARCH__)
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
#endif
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
#if defined(__CUDA_ARCH__)
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
#elif defined(REPRO_CUDA_EMU)
  emu_mbar_arrive(bar, 0);
#endif
}

// one arrival that also expects `bytes` of TMA transactions this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      unsigned bytes) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
#elif defined(REPRO_CUDA_EMU)
  emu_mbar_arrive(bar, bytes);
#endif
}

// wait until the phase of parity `parity` has completed (a fresh barrier
// counts the phase before its first as completed with parity 1)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
#if defined(__CUDA_ARCH__)
  const uint32_t a = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
#elif defined(REPRO_CUDA_EMU)
  emu_mbar_wait(bar, parity);
#endif
}

// ------------------------------------------------------------------ TMA
//
// One box of the tensor `map` describes (coordinates innermost first, in
// elements) into shared memory at `dst` (1024-byte aligned for the
// swizzle), its bytes completed on `bar`.  Issued by one thread.

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(map), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
#elif defined(REPRO_CUDA_EMU)
  const int c[4] = {c0, c1, c2, 0};
  emu_tma_load(dst, map, bar, c);
#endif
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(map), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
#elif defined(REPRO_CUDA_EMU)
  const int c[4] = {c0, c1, c2, c3};
  emu_tma_load(dst, map, bar, c);
#endif
}

// A box of shared memory at `src` (1024-byte aligned, in the swizzle)
// written to the tensor `map` describes at coordinates c0, c1, c2; values
// outside the tensor are not written.  Issued by one thread after the
// threads' writes to `src` are fenced (fence_proxy_async) and joined;
// tma_store_commit() closes a group, tma_store_wait<N>() returns once all
// but the N most recent groups have read their shared memory.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4}], [%1];\n" ::"l"(map),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
#elif defined(REPRO_CUDA_EMU)
  const int c[4] = {c0, c1, c2, 0};
  emu_tma_store(map, src, c);
#endif
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4, %5}], [%1];\n" ::"l"(map),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
#elif defined(REPRO_CUDA_EMU)
  const int c[4] = {c0, c1, c2, c3};
  emu_tma_store(map, src, c);
#endif
}

__device__ __forceinline__ void tma_store_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
#endif
}

template <int N>
__device__ __forceinline__ void tma_store_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
#endif
}

// ------------------------------------------------------- 1D bulk copies
//
// `bytes` (a multiple of 16; both addresses 16-byte aligned) from global
// memory into shared memory at `dst`, completed on `bar` as transaction
// bytes (the issuing thread's mbar_arrive_expect_tx announces them), and
// from shared memory at `src` to global memory (device memory or the
// device view of page-locked host memory) in the thread's current bulk
// group (tma_store_commit closes it, tma_store_wait<N> waits for all but
// the N most recent groups to have read their shared memory,
// bulk_wait_all for every group's writes to be done).  Issued by one
// thread.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
#elif defined(REPRO_CUDA_EMU)
  emu_bulk_load(dst, src, bytes, bar);
#endif
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           unsigned bytes) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(smem_addr(src)), "r"(bytes)
      : "memory");
#elif defined(REPRO_CUDA_EMU)
  emu_bulk_store(dst, src, bytes);
#endif
}

__device__ __forceinline__ void bulk_wait_all() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
#endif
}

// shared-memory writes by threads made visible to the async proxy (wgmma
// operands read through descriptors)
__device__ __forceinline__ void fence_proxy_async() {
#if defined(__CUDA_ARCH__)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
#endif
}

// bar.sync on barrier `id` (1..15; 0 is __syncthreads) for `count` threads
__device__ __forceinline__ void named_barrier(int id, int count) {
#if defined(__CUDA_ARCH__)
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
#elif defined(REPRO_CUDA_EMU)
  emu_named_barrier(id, count);
#endif
}

// bar.arrive on barrier `id` for `count` threads: counts this thread's
// arrival and goes on (the others bar.sync there)
__device__ __forceinline__ void named_barrier_arrive(int id, int count) {
#if defined(__CUDA_ARCH__)
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
#elif defined(REPRO_CUDA_EMU)
  emu_named_barrier_arrive(id, count);
#endif
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
#if defined(__CUDA_ARCH__)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
#endif
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
#if defined(__CUDA_ARCH__)
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
#endif
}

// ---------------------------------------------------------------- wgmma

// a shared-memory matrix descriptor in the 128-byte swizzle
__device__ __forceinline__ uint64_t desc128(const void* p, uint32_t lbo,
                                            uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3ffffu) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3fffu) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3fffu) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// before the first wgmma of a batch (orders the registers and shared
// memory the threads wrote before it)
__device__ __forceinline__ void wgmma_fence() {
#if defined(__CUDA_ARCH__)
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#endif
}

__device__ __forceinline__ void wgmma_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
#endif
}

// all but the N most recent committed groups complete
template <int N>
__device__ __forceinline__ void wgmma_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
#endif
}

// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it (call after wgmma_wait)
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#if defined(__CUDA_ARCH__)
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
#endif
}

// keeps a register A operand's values in their registers up to this
// point (an in-flight wgmma still reads them: call after the wgmma_wait
// that retires it, so the compiler cannot reuse them before)
template <int R>
__device__ __forceinline__ void keep_regs(const uint32_t (&a)[R][4]) {
#if defined(__CUDA_ARCH__)
#pragma unroll
  for (int i = 0; i < R; ++i)
    asm volatile("" ::"r"(a[i][0]), "r"(a[i][1]), "r"(a[i][2]), "r"(a[i][3])
                 : "memory");
#endif
}

// D (64 x N fp32, N / 2 registers a thread) += A (64 x 16) . B (16 x N).
// wgmma_ss: A and B through descriptors, TA / TB 1 where the operand is
// MN-major.  wgmma_rs: A from registers (a 16-deep fragment), TB as above.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, "
      "%16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
#elif defined(REPRO_CUDA_EMU)
  emu_wgmma(d, 32, da, db, nullptr, TA, TB);
#endif
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(TB));
#elif defined(REPRO_CUDA_EMU)
  emu_wgmma(d, 32, 0, db, a, 0, TB);
#endif
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
#elif defined(REPRO_CUDA_EMU)
  emu_wgmma(d, 64, da, db, nullptr, TA, TB);
#endif
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(TB));
#elif defined(REPRO_CUDA_EMU)
  emu_wgmma(d, 64, 0, db, a, 0, TB);
#endif
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
#elif defined(REPRO_CUDA_EMU)
  emu_wgmma(d, 128, da, db, nullptr, TA, TB);
#endif
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(TB));
#elif defined(REPRO_CUDA_EMU)
  emu_wgmma(d, 128, 0, db, a, 0, TB);
#endif
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n256(float (&d)[128], uint64_t da,
                                             uint64_t db) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, "
      "%128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]),
        "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]),
        "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]),
        "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]),
        "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]),
        "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
#elif defined(REPRO_CUDA_EMU)
  emu_wgmma(d, 256, da, db, nullptr, TA, TB);
#endif
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]),
        "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]),
        "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]),
        "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]),
        "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]),
        "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(TB));
#elif defined(REPRO_CUDA_EMU)
  emu_wgmma(d, 256, 0, db, a, 0, TB);
#endif
}

template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db) {
  if constexpr (N == 32) wgmma_ss_n32<TA, TB>(d, da, db);
  if constexpr (N == 64) wgmma_ss_n64<TA, TB>(d, da, db);
  if constexpr (N == 128) wgmma_ss_n128<TA, TB>(d, da, db);
  if constexpr (N == 256) wgmma_ss_n256<TA, TB>(d, da, db);
}

template <int N, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 32) wgmma_rs_n32<TB>(d, a, db);
  if constexpr (N == 64) wgmma_rs_n64<TB>(d, a, db);
  if constexpr (N == 128) wgmma_rs_n128<TB>(d, a, db);
  if constexpr (N == 256) wgmma_rs_n256<TB>(d, a, db);
}

// -------------------------------------------------------- tensor maps
//
// A tensor of `rank` (2..4) dimensions, innermost first: dims[i]
// elements, strides[i] bytes between steps of dimension i + 1 (multiples
// of 16), boxes of box[i] elements (box[0] one 128-byte swizzled row: 64
// bf16, 32 fp32).
// cuTensorMapEncodeTiled is fetched from the driver through the runtime
// (cudaGetDriverEntryPoint), so the library links nothing beyond the
// runtime.  Returns a CUDA error code (cudaErrorInvalidValue where the
// driver refuses the map).

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline int tensor_map(CUtensorMap* map, CUtensorMapDataType type,
                      const void* base, int rank, const uint64_t* dims,
                      const uint64_t* strides, const uint32_t* box) {
  static EncodeTiledFn encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (fn == nullptr || found != cudaDriverEntryPointSuccess)
      return static_cast<int>(cudaErrorInvalidValue);
    encode = reinterpret_cast<EncodeTiledFn>(fn);
  }
  cuuint64_t d[5], s[4];
  cuuint32_t b[5], e[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    e[i] = 1;
    if (i + 1 < rank) s[i] = strides[i];
  }
  const CUresult r = encode(
      map, type, static_cast<cuuint32_t>(rank), const_cast<void*>(base), d, s,
      b, e, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// ------------------------------------------------- attention's tiles
//
// The attention kernels' shared pieces: a 4D bf16 map over the model's
// (B, S, heads, D) layout, boxes of 64 columns x `rows` rows of one head
// (a head's rows at stride heads x D, no transpose), and q * scale rounded
// to bf16 in place.

inline int map_heads(CUtensorMap* m, const void* base, int B, int S,
                     int heads, int D, int rows) {
  const uint64_t dims[4] = {static_cast<uint64_t>(D),
                            static_cast<uint64_t>(heads),
                            static_cast<uint64_t>(S),
                            static_cast<uint64_t>(B)};
  const uint64_t strides[3] = {static_cast<uint64_t>(D) * 2,
                               static_cast<uint64_t>(heads) * D * 2,
                               static_cast<uint64_t>(S) * heads * D * 2};
  const uint32_t box[4] = {64, 1, static_cast<uint32_t>(rows), 1};
  return tensor_map(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, 4, dims,
                    strides, box);
}

// q * scale rounded to bf16 in place over `bytes` bytes of a swizzled tile
// (the layout does not matter: every value is scaled), by 128 threads
__device__ __forceinline__ void scale_rows(char* p, int bytes, float scale,
                                           int lt) {
  for (int o = 4 * lt; o < bytes; o += 4 * 128) {
    uint32_t* w = reinterpret_cast<uint32_t*>(p + o);
    const float lo = __bfloat162float(
        __ushort_as_bfloat16(static_cast<unsigned short>(*w & 0xffffu)));
    const float hi = __bfloat162float(
        __ushort_as_bfloat16(static_cast<unsigned short>(*w >> 16)));
    *w = pack_bf16x2(lo * scale, hi * scale);
  }
}

}  // namespace repro
