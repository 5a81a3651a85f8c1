// The kernel work of the generic-body fused segments (runner="fused" for any
// chain body; driven from repro_torch/kernels/segment_generic.py).
//
// It carries the data movement of the generic-body half of the TPU kernels
// src/repro/kernels/segment_pallas.py::fused_advance_segment (the
// pallas_call at :248) and ::fused_reverse_segment (at :456), and no more.
// On the TPU the caller's body is traced into the kernel; around it the
// kernel snapshots each chunk-entry carry into one of two VMEM slots and
// copies it out to a host-reachable buffer while the chunk computes (the
// copy at :205), and its reverse walk folds each chunk's parameter
// cotangent into a running sum and writes the chunk's input cotangents
// (dxd) in place (:414-418).  On the card the body's steps, the reverse's
// recompute and the chunks' vjps -- the kernel's arithmetic -- are the
// caller's PyTorch code (on the decoders that code runs the port's
// flash_attention and ssd_scan kernels), so the TPU kernel is not ported by
// these two; they are its copies and its fold, each one launch over a table
// of leaves of mixed sizes and types in device memory:
//
// entry_store: one chunk-entry carry into page-locked host slots, every leaf
//   at once (table: src, dst, bytes per leaf; dst is the device view of the
//   slot).  It runs on a side stream after an event recorded on the compute
//   stream at the chunk entry, in a few blocks (STORE_BLOCKS of the 132 SMs),
//   so the chunk's steps run beside it.  Bound: the bytes over the host
//   link (PCIe 5.0 x16, 64 GB/s each way): 0.59 ms for gemma2-2b's 37.7 MB
//   carry.  Its design: 16-byte stores where both addresses are 16-byte
//   aligned, byte stores for the tail and for a misaligned leaf (the
//   decoders' carry holds a 0-d fp32 accumulator); writes to host memory are
//   posted, so a few thousand threads keep the link busy without waiting on
//   a round trip.  On the H100 it is slower than the copy engine's
//   copy_(non_blocking=True) of the same bytes and holds its blocks' SMs
//   while the body runs (PERF.md has the times): a redesign is queued.
//
// fold: one reverse chunk's cotangents in one launch (table: dst, src,
//   src2, count, op per entry): each parameter cotangent added into the
//   executor's accumulator in place in the accumulator's type (fp32 or
//   bf16, computed in fp32 and rounded once an add, as torch's add_ does),
//   or written where the accumulator leaf holds no memory yet; in a
//   segment's last launch a short tail chunk's cotangent follows as the
//   entry's second source (the TPU kernel adds it once at the end); each
//   input cotangent copied into its rows of the full-chain buffer.  Bound:
//   the bytes read and written over 3.35 TB/s (a gemma2-2b chunk of 4
//   steps moves 2.5 GB of weight cotangents in and out: ~1.5 ms).  Its
//   design: a grid-stride loop over each entry in turn, 16-byte loads and
//   stores where aligned.  No entry depends on another and every element
//   is a fixed sequence of IEEE adds or a copy, so the result is bit for
//   bit the plain version's.
#include "common.cuh"

namespace {

constexpr int NT = 256;            // threads per block
constexpr int STORE_BLOCKS = 16;   // entry_store's grid
constexpr int FOLD_BLOCKS_PER_SM = 4;

// fold's op word: bit 0 an accumulator entry (else a copy of `count`
// bytes), bit 1 fresh (the accumulator's value is not read: it starts from
// src), bits 2-4 bf16 for dst, src, src2 (fp32 where clear)
constexpr long long OP_ACC = 1, FRESH = 2, DST_BF16 = 4, SRC_BF16 = 8,
                    SRC2_BF16 = 16;

__device__ __forceinline__ bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) &
          15) == 0;
}

// nbytes from src to dst by the threads tid, tid + stride, ...
__device__ __forceinline__ void copy_bytes(char* dst, const char* src,
                                           long long nbytes, long long tid,
                                           long long stride) {
  long long done = 0;
  if (aligned16(dst, src)) {
    const long long nv = nbytes / 16;
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (long long i = tid; i < nv; i += stride) d[i] = s[i];
    done = nv * 16;
  }
  for (long long i = done + tid; i < nbytes; i += stride) dst[i] = src[i];
}

__global__ void __launch_bounds__(NT)
entry_store_kernel(const long long* __restrict__ table, int leaves) {
  const long long tid = static_cast<long long>(blockIdx.x) * NT + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * NT;
  for (int l = 0; l < leaves; ++l)
    copy_bytes(reinterpret_cast<char*>(table[3 * l + 1]),
               reinterpret_cast<const char*>(table[3 * l]), table[3 * l + 2],
               tid, stride);
}

__device__ __forceinline__ float load(const void* p, long long i,
                                      bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// v rounded to the stored type and back
__device__ __forceinline__ float stored(float v, bool bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16(v)) : v;
}

__device__ __forceinline__ void store(void* p, long long i, bool bf16,
                                      float v) {
  if (bf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  else
    static_cast<float*>(p)[i] = v;
}

__global__ void __launch_bounds__(NT)
fold_kernel(const long long* __restrict__ table, int entries) {
  const long long tid = static_cast<long long>(blockIdx.x) * NT + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * NT;
  for (int e = 0; e < entries; ++e) {
    const long long* w = table + 5 * e;
    void* dst = reinterpret_cast<void*>(w[0]);
    const void* src = reinterpret_cast<const void*>(w[1]);
    const void* src2 = reinterpret_cast<const void*>(w[2]);
    const long long n = w[3], op = w[4];
    if (!(op & OP_ACC)) {   // a copy of n bytes
      copy_bytes(static_cast<char*>(dst), static_cast<const char*>(src), n,
                 tid, stride);
      continue;
    }
    const bool fresh = op & FRESH, dbf = op & DST_BF16, sbf = op & SRC_BF16,
               s2bf = op & SRC2_BF16;
    long long done = 0;
    if (!fresh && !dbf && !sbf && src2 == nullptr && aligned16(dst, src)) {
      // the common case, fp32 into fp32: four elements a thread
      const long long nv = n / 4;
      float4* d4 = static_cast<float4*>(dst);
      const float4* s4 = static_cast<const float4*>(src);
      for (long long i = tid; i < nv; i += stride) {
        float4 a = d4[i];
        const float4 b = s4[i];
        a.x = a.x + b.x;
        a.y = a.y + b.y;
        a.z = a.z + b.z;
        a.w = a.w + b.w;
        d4[i] = a;
      }
      done = nv * 4;
    }
    for (long long i = done + tid; i < n; i += stride) {
      float v = load(src, i, sbf);
      if (!fresh) v = load(dst, i, dbf) + v;
      if (src2 != nullptr) v = stored(v, dbf) + load(src2, i, s2bf);
      store(dst, i, dbf, v);
    }
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || sms < 1)
    return 1;
  return sms;
}

}  // namespace

// One chunk-entry carry into its page-locked slots: `table` in device
// memory, three words a leaf (src, the device view of dst, bytes).
extern "C" int generic_entry_store(const long long* table, int leaves,
                                   void* stream) {
  entry_store_kernel<<<STORE_BLOCKS, NT, 0,
                       static_cast<cudaStream_t>(stream)>>>(table, leaves);
  return static_cast<int>(cudaGetLastError());
}

// One reverse chunk's fold: `table` in device memory, five words an entry
// (dst, src, src2 or 0, count, op): count is elements for an accumulator
// entry, bytes for a copy.
extern "C" int generic_fold(const long long* table, int entries,
                            void* stream) {
  fold_kernel<<<FOLD_BLOCKS_PER_SM * sm_count(), NT, 0,
                static_cast<cudaStream_t>(stream)>>>(table, entries);
  return static_cast<int>(cudaGetLastError());
}

// The address a kernel writes page-locked host memory `p` at.
extern "C" int repro_device_address(void* p, long long* out) {
  cudaPointerAttributes attr;
  const cudaError_t e = cudaPointerGetAttributes(&attr, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (attr.type != cudaMemoryTypeHost || attr.devicePointer == nullptr)
    return static_cast<int>(cudaErrorInvalidHostPointer);
  *out = reinterpret_cast<long long>(attr.devicePointer);
  return 0;
}
