// Mamba-2's step sizes: dt = softplus(dt_raw + dt_bias) in fp32, forward
// and backward.
//
// Replaces the arithmetic the TPU kernels src/repro/kernels/segment_pallas.py
// ::fused_advance_segment / ::fused_reverse_segment run for a mamba2 body
// (the body is traced into the pallas_call: the chunk scans at :186, :323
// and the chunk vjp at :395-409): src/repro/models/ssm.py:194-195 and its
// vjp.  The port's plain version is repro_torch/kernels/dt_softplus.py::
// dt_softplus_plain / dt_softplus_bwd_plain.
//
//   forward   v = float(dt_raw) + dt_bias, dt = v > 20 ? v : log1p(exp(v))
//             (PyTorch's softplus at beta 1, threshold 20)
//   backward  q = v > 20 ? g : g e / (e + 1), e = exp(v) (fp32);
//             d dt_raw = round(q) (dt_raw's type), d dt_bias[h] = sum over
//             rows of q: a block a head, each thread a fixed stride of rows,
//             then a fixed tree (no atomics: two calls give the same bits)
//
// Bound: bytes.  At mamba2-370m's layer (16384 rows x 32 heads, dt_raw
// bf16) the forward reads 1 MB and writes 2 MB; the backward reads 3 MB and
// writes 1 MB: ~1 us at 3.35 TB/s, so a launch's own cost is the floor.
// Design: a thread an element; dt_raw read in place through its row stride
// (it is a column slice of the input projection).
#include "common.cuh"

using repro::from_f32;
using repro::to_f32;

namespace {

constexpr int NT = 256;

__device__ __forceinline__ float softplus(float v) {
  return v > 20.0f ? v : log1pf(expf(v));
}

__device__ __forceinline__ float softplus_grad(float g, float v) {
  if (v > 20.0f) return g;
  const float e = expf(v);
  return g * e / (e + 1.0f);
}

template <typename T>
__global__ void __launch_bounds__(NT)
dt_fwd_kernel(const T* __restrict__ raw, const float* __restrict__ bias,
              float* __restrict__ out, long rows, int H, long sr) {
  const long e = static_cast<long>(blockIdx.x) * NT + threadIdx.x;
  if (e >= rows * H) return;
  const long r = e / H;
  const int h = static_cast<int>(e % H);
  out[e] = softplus(to_f32(raw[r * sr + h]) + bias[h]);
}

template <typename T>
__global__ void __launch_bounds__(NT)
dt_bwd_kernel(const T* __restrict__ raw, const float* __restrict__ bias,
              const float* __restrict__ g, T* __restrict__ draw, long rows,
              int H, long sr, long sd) {
  const long e = static_cast<long>(blockIdx.x) * NT + threadIdx.x;
  if (e >= rows * H) return;
  const long r = e / H;
  const int h = static_cast<int>(e % H);
  draw[r * sd + h] =
      from_f32<T>(softplus_grad(g[e], to_f32(raw[r * sr + h]) + bias[h]));
}

// a block a head: dbias[h] = sum over rows of the fp32 cotangent
template <typename T>
__global__ void __launch_bounds__(NT)
dt_bias_kernel(const T* __restrict__ raw, const float* __restrict__ bias,
               const float* __restrict__ g, float* __restrict__ dbias,
               long rows, int H, long sr) {
  __shared__ float red[NT / 32];
  const int h = blockIdx.x;
  float s = 0.0f;
  for (long r = threadIdx.x; r < rows; r += NT)
    s += softplus_grad(g[r * H + h], to_f32(raw[r * sr + h]) + bias[h]);
  s = repro::warp_sum(s);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float v = 0.0f;
    for (int w = 0; w < NT / 32; ++w) v += red[w];
    dbias[h] = v;
  }
}

unsigned blocks(long n) { return static_cast<unsigned>((n + NT - 1) / NT); }

}  // namespace

// raw (rows, H) at row stride sr, of type bf16 ? bf16 : fp32; bias (H),
// out (rows, H) fp32.
extern "C" int dt_softplus_fwd(const void* raw, const float* bias, float* out,
                               long rows, int H, long sr, int bf16,
                               void* stream) {
  if (rows <= 0 || H <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    dt_fwd_kernel<__nv_bfloat16><<<blocks(rows * H), NT, 0, st>>>(
        static_cast<const __nv_bfloat16*>(raw), bias, out, rows, H, sr);
  else
    dt_fwd_kernel<float><<<blocks(rows * H), NT, 0, st>>>(
        static_cast<const float*>(raw), bias, out, rows, H, sr);
  return static_cast<int>(cudaGetLastError());
}

// g (rows, H) fp32; draw (rows, H) of raw's type at row stride sd (its
// columns of the input projection's cotangent); dbias (H) fp32.
extern "C" int dt_softplus_bwd(const void* raw, const float* bias,
                               const float* g, void* draw, float* dbias,
                               long rows, int H, long sr, long sd, int bf16,
                               void* stream) {
  if (rows <= 0 || H <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    using T = __nv_bfloat16;
    dt_bwd_kernel<T><<<blocks(rows * H), NT, 0, st>>>(
        static_cast<const T*>(raw), bias, g, static_cast<T*>(draw), rows, H,
        sr, sd);
    dt_bias_kernel<T><<<H, NT, 0, st>>>(static_cast<const T*>(raw), bias, g,
                                        dbias, rows, H, sr);
  } else {
    dt_bwd_kernel<float><<<blocks(rows * H), NT, 0, st>>>(
        static_cast<const float*>(raw), bias, g, static_cast<float*>(draw),
        rows, H, sr, sd);
    dt_bias_kernel<float><<<H, NT, 0, st>>>(static_cast<const float*>(raw),
                                            bias, g, dbias, rows, H, sr);
  }
  return static_cast<int>(cudaGetLastError());
}
