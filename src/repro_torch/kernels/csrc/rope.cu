// Rotary position embedding, rotate-half convention, of q and k in one
// launch; the backward is the same launch rotating by -theta.
//
// Replaces the arithmetic the TPU kernels src/repro/kernels/segment_pallas.py
// ::fused_advance_segment / ::fused_reverse_segment run for a decoder body
// (the body is traced into the pallas_call: the chunk scans at :186, :323 and
// the chunk vjp at :395-409): src/repro/models/layers.py::apply_rope and
// its vjp.  The port's plain version is repro_torch/kernels/rope.py::
// rope_plain / rope_bwd_plain.
//
// x (..., S, H, D) with halves x1 = x[..., :D/2], x2 = x[..., D/2:] and the
// fp32 table cos, sin (S, D/2):
//   forward   y1 = x1 cos - x2 sin, y2 = x2 cos + x1 sin
//   backward  dx1 = g1 cos + g2 sin, dx2 = g2 cos - g1 sin
// in fp32, each product and sum rounded as the plain version's separate
// PyTorch operations round them (no fused multiply-add), and rounded once
// to x's type; so the result is the plain version's bit for bit.
//
// Bound: bytes.  gemma2-2b's q (2, 4096, 8, 256) and k (2, 4096, 4, 256)
// bf16, read once and written once, and the 4 MB table: 54 MB, 16 us at
// 3.35 TB/s.  Design: a grid-stride loop over the pairs (x1[j], x2[j]) of
// both tensors, consecutive threads on consecutive j; the table is read
// through L1/L2 (every head of a position reads the same row).
#include "common.cuh"

using repro::from_f32;
using repro::to_f32;

namespace {

constexpr int NT = 256;
constexpr int MAX_BLOCKS = 132 * 8;

__device__ __forceinline__ float mul_rn(float a, float b) {
#if defined(__CUDA_ARCH__)
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}

template <typename T>
__device__ __forceinline__ void rotate(const T* __restrict__ x,
                                       T* __restrict__ y,
                                       const float* __restrict__ cs,
                                       const float* __restrict__ sn, long p,
                                       int S, int H, int half, float sgn) {
  const long row = p / half;  // (..., s, h) flattened
  const int j = static_cast<int>(p % half);
  const int s = static_cast<int>((row / H) % S);
  const float c = cs[static_cast<long>(s) * half + j];
  const float sv = sgn * sn[static_cast<long>(s) * half + j];
  const long base = row * 2 * half + j;
  const float x1 = to_f32(x[base]), x2 = to_f32(x[base + half]);
  // y1 = x1 c - x2 s, y2 = x2 c + x1 s, each product rounded on its own
  y[base] = from_f32<T>(mul_rn(x1, c) - mul_rn(x2, sv));
  y[base + half] = from_f32<T>(mul_rn(x2, c) + mul_rn(x1, sv));
}

template <typename T>
__global__ void __launch_bounds__(NT)
rope_kernel(const T* __restrict__ xq, T* __restrict__ yq, long nq, int hq,
            const T* __restrict__ xk, T* __restrict__ yk, long nk, int hk,
            const float* __restrict__ cs, const float* __restrict__ sn,
            int S, int half, float sgn) {
  const long stride = static_cast<long>(gridDim.x) * NT;
  for (long p = static_cast<long>(blockIdx.x) * NT + threadIdx.x;
       p < nq + nk; p += stride) {
    if (p < nq)
      rotate(xq, yq, cs, sn, p, S, hq, half, sgn);
    else
      rotate(xk, yk, cs, sn, p - nq, S, hk, half, sgn);
  }
}

template <typename T>
int launch(const void* xq, void* yq, long nq, int hq, const void* xk,
           void* yk, long nk, int hk, const float* cs, const float* sn,
           int S, int half, float sgn, void* stream) {
  const long b = (nq + nk + NT - 1) / NT;
  const unsigned blocks =
      static_cast<unsigned>(b < MAX_BLOCKS ? b : MAX_BLOCKS);
  auto kern = rope_kernel<T>;
  kern<<<blocks, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(xq), static_cast<T*>(yq), nq, hq,
      static_cast<const T*>(xk), static_cast<T*>(yk), nk, hk, cs, sn, S,
      half, sgn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xq/yq: nq pairs (numel / 2) of a (..., S, hq, 2 half) tensor; xk/yk the
// same for k (nk = 0: none); cs, sn fp32 (S, half); inverse != 0 rotates by
// -theta (the backward).  Types bf16 ? bf16 : fp32.
extern "C" int rope(const void* xq, void* yq, long nq, int hq,
                    const void* xk, void* yk, long nk, int hk,
                    const float* cs, const float* sn, int S, int half,
                    int inverse, int bf16, void* stream) {
  if (nq + nk <= 0) return 0;
  if (S <= 0 || half <= 0 || hq <= 0 || (nk > 0 && hk <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const float sgn = inverse ? -1.0f : 1.0f;
  if (bf16)
    return launch<__nv_bfloat16>(xq, yq, nq, hq, xk, yk, nk, hk, cs, sn, S,
                                 half, sgn, stream);
  return launch<float>(xq, yq, nq, hq, xk, yk, nk, hk, cs, sn, S, half, sgn,
                       stream);
}
