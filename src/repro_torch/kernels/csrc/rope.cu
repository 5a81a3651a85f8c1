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
// to x's type; so the result is the plain version's bit for bit.  Without a
// table (cs null) the kernel computes it from the position s and theta as
// repro/models/layers.py::rope_table does, in fp32: cos and sin of
// s * theta^(-j / half) (the library's powf, cosf and sinf: within the
// plain table's rounding, not its bits), so no (S, D/2) table is made.
//
// Bound: bytes.  gemma2-2b's q (2, 4096, 8, 256) and k (2, 4096, 4, 256)
// bf16, read once and written once, and the 4 MB table: 54 MB, 16 us at
// 3.35 TB/s.  Design: a grid-stride loop over (position, j), consecutive
// threads on consecutive j; each thread takes its angle once (from the
// table, or computed from theta) and rotates the pair (x1[j], x2[j]) of
// every head of q and of k at that position.
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

// cos and sgn * sin of position s's angle at frequency j: the table's, or
// from theta
__device__ __forceinline__ void angle(const float* __restrict__ cs,
                                      const float* __restrict__ sn,
                                      float theta, int s, int j, int half,
                                      float sgn, float* c, float* sv) {
  if (cs) {
    *c = cs[static_cast<long>(s) * half + j];
    *sv = sgn * sn[static_cast<long>(s) * half + j];
  } else {
    const float freq = powf(theta, -static_cast<float>(j) / half);
    const float ang = mul_rn(static_cast<float>(s), freq);
    *c = cosf(ang);
    *sv = sgn * sinf(ang);
  }
}

// y1 = x1 c - x2 s, y2 = x2 c + x1 s at x[base], x[base + half], each
// product rounded on its own
template <typename T>
__device__ __forceinline__ void rotate(const T* __restrict__ x,
                                       T* __restrict__ y, long base,
                                       int half, float c, float sv) {
  const float x1 = to_f32(x[base]), x2 = to_f32(x[base + half]);
  y[base] = from_f32<T>(mul_rn(x1, c) - mul_rn(x2, sv));
  y[base + half] = from_f32<T>(mul_rn(x2, c) + mul_rn(x1, sv));
}

// a grid-stride loop over (position, j): one angle each, applied to every
// head of q and of k at that position (the angle is computed once for the
// hq + hk heads that share it)
template <typename T>
__global__ void __launch_bounds__(NT)
rope_kernel(const T* __restrict__ xq, T* __restrict__ yq, int hq,
            const T* __restrict__ xk, T* __restrict__ yk, int hk,
            long units, const float* __restrict__ cs,
            const float* __restrict__ sn, float theta, int S, int half,
            float sgn) {
  const long stride = static_cast<long>(gridDim.x) * NT;
  for (long u = static_cast<long>(blockIdx.x) * NT + threadIdx.x; u < units;
       u += stride) {
    const int j = static_cast<int>(u % half);
    const long pos = u / half;   // (..., s) flattened
    float c, sv;
    angle(cs, sn, theta, static_cast<int>(pos % S), j, half, sgn, &c, &sv);
    for (int h = 0; h < hq; ++h)
      rotate(xq, yq, (pos * hq + h) * 2 * half + j, half, c, sv);
    for (int h = 0; h < hk; ++h)
      rotate(xk, yk, (pos * hk + h) * 2 * half + j, half, c, sv);
  }
}

template <typename T>
int launch(const void* xq, void* yq, int hq, const void* xk, void* yk,
           int hk, long units, const float* cs, const float* sn, float theta,
           int S, int half, float sgn, void* stream) {
  const long b = (units + NT - 1) / NT;
  const unsigned blocks =
      static_cast<unsigned>(b < MAX_BLOCKS ? b : MAX_BLOCKS);
  auto kern = rope_kernel<T>;
  kern<<<blocks, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(xq), static_cast<T*>(yq), hq,
      static_cast<const T*>(xk), static_cast<T*>(yk), hk, units, cs, sn,
      theta, S, half, sgn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xq/yq: nq pairs (numel / 2) of a (..., S, hq, 2 half) tensor; xk/yk the
// same for k over the same positions (nk = 0: none); cs, sn fp32 (S, half),
// or both null: the angles from theta; inverse != 0 rotates by -theta (the
// backward).  Types bf16 ? bf16 : fp32.
extern "C" int rope(const void* xq, void* yq, long nq, int hq,
                    const void* xk, void* yk, long nk, int hk,
                    const float* cs, const float* sn, float theta, int S,
                    int half, int inverse, int bf16, void* stream) {
  if (nq + nk <= 0) return 0;
  if (S <= 0 || half <= 0 || hq <= 0 || (nk > 0 && hk <= 0) ||
      (cs == nullptr) != (sn == nullptr) || nq % hq != 0 ||
      (nk > 0 && (nk % hk != 0 || nk / hk != nq / hq)))
    return static_cast<int>(cudaErrorInvalidValue);
  const float sgn = inverse ? -1.0f : 1.0f;
  const long units = nq / hq;   // (position, j) pairs
  if (nk == 0) hk = 0;
  if (bf16)
    return launch<__nv_bfloat16>(xq, yq, hq, xk, yk, hk, units, cs, sn,
                                 theta, S, half, sgn, stream);
  return launch<float>(xq, yq, hq, xk, yk, hk, units, cs, sn, theta, S,
                       half, sgn, stream);
}
