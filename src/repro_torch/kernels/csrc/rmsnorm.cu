// RMSNorm with a weight stored as an offset from 1 (Gemma style), forward
// and backward, optionally with the post-norm's residual add fused in.
//
// Replaces the arithmetic the TPU kernels src/repro/kernels/segment_pallas.py
// ::fused_advance_segment / ::fused_reverse_segment run for a decoder body
// (the body is traced into the pallas_call: the chunk scans at :186, :323 and
// the chunk vjp at :395-409): src/repro/models/layers.py::rmsnorm and its
// vjp.  The port's plain version is repro_torch/kernels/rmsnorm.py::
// rmsnorm_fwd_plain / rmsnorm_bwd_plain.
//
//   forward   rstd = rsqrt(mean(x^2) + eps) (fp32, saved a row),
//             y = (x rstd) (1 + scale) rounded to the output type;
//             with a residual: h = residual + y, rounded again (the plain
//             version's x + rmsnorm(y), both roundings kept)
//   backward  dx = rstd (g w - xh mean(g w xh)), xh = x rstd, w = 1 + scale,
//             in fp32, rounded to x's type; dscale = sum over rows of g xh,
//             where g is the output's cotangent: with the output read by up
//             to three consumers, the sum of theirs, g = round(round(g1 +
//             g2) + g3) (autograd's sum of a fan-out's cotangents, each add
//             rounded to the output's type); with the input also passed on
//             as a skip (a residual), dx = round(round(dx) + dskip), the
//             skip's cotangent added as autograd would add it;
//             fp32: per-block partial sums over fixed row ranges, then a
//             second launch sums the partials in block order (no atomics:
//             two calls give the same bits)
//
// Bound: bytes.  At gemma2-2b's rows (8192 x 2304, bf16) the forward moves
// 38 MB (75 MB with the residual), the backward 113 MB: 11-34 us at
// 3.35 TB/s.  Design: one warp a row in the forward (a row
// is 2,304 values: 72 a lane), the row read twice (the second read from
// L1/L2); in the backward 256 blocks walk fixed ranges of rows, a block a
// row at a time, and keep their dscale partial in shared memory, one
// column a thread.  Row sums are a fixed tree (warp shuffles; in the
// backward then the warps' sums in order).
#include "common.cuh"

using repro::from_f32;
using repro::to_f32;

namespace {

constexpr int NT = 256;
constexpr int NWARP = NT / 32;
constexpr int BWD_BLOCKS = 256;  // the backward's grid at most ...
constexpr long BWD_MIN_ROWS = 16;  // ... of this many rows a block at least

// rows a block of the backward: fixed by `rows` alone (determinism)
long bwd_rows_per_block(long rows) {
  const long per = (rows + BWD_BLOCKS - 1) / BWD_BLOCKS;
  return per > BWD_MIN_ROWS ? per : BWD_MIN_ROWS;
}

// the block's sum of v, the same value in every thread, in a fixed order
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = repro::warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.0f;
#pragma unroll
  for (int w = 0; w < NWARP; ++w) s += red[w];
  __syncthreads();  // red is free again
  return s;
}

// one warp a row, NWARP rows a block
template <typename TX, typename TO>
__global__ void __launch_bounds__(NT)
rmsnorm_fwd_kernel(const TX* __restrict__ x, const float* __restrict__ scale,
                   const TO* __restrict__ res, TO* __restrict__ out,
                   float* __restrict__ rstd, long rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const long row = static_cast<long>(blockIdx.x) * NWARP + (threadIdx.x >> 5);
  if (row >= rows) return;
  const TX* xr = x + row * d;
  float ss = 0.0f;
  for (int i = lane; i < d; i += 32) {
    const float v = to_f32(xr[i]);
    ss = fmaf(v, v, ss);
  }
  const float r = rsqrtf(repro::warp_sum(ss) / d + eps);
  if (lane == 0) rstd[row] = r;
  TO* orow = out + row * d;
  const TO* rrow = res ? res + row * d : nullptr;
  for (int i = lane; i < d; i += 32) {
    const float y = to_f32(xr[i]) * r * (1.0f + scale[i]);
    if (rrow)
      orow[i] = from_f32<TO>(to_f32(rrow[i]) + to_f32(from_f32<TO>(y)));
    else
      orow[i] = from_f32<TO>(y);
  }
}

// the output's cotangent: the sum of its consumers' (g[1], g[2] may be
// null), each add rounded to TO as autograd's accumulation rounds it
template <typename TO>
struct Cot {
  const TO* g[3];
  __device__ __forceinline__ float at(long i) const {
    float v = to_f32(g[0][i]);
    if (g[1]) v = to_f32(from_f32<TO>(v + to_f32(g[1][i])));
    if (g[2]) v = to_f32(from_f32<TO>(v + to_f32(g[2][i])));
    return v;
  }
};

template <typename TX, typename TO>
__global__ void __launch_bounds__(NT)
rmsnorm_bwd_kernel(Cot<TO> g, const TX* __restrict__ x,
                   const float* __restrict__ scale,
                   const float* __restrict__ rstd,
                   const TX* __restrict__ dskip, TX* __restrict__ dx,
                   float* __restrict__ part, long rows, int d,
                   long rows_per_block) {
  extern __shared__ float smem[];  // this block's dscale partial, d floats
  __shared__ float red[NWARP];
  for (int i = threadIdx.x; i < d; i += NT) smem[i] = 0.0f;
  const long r0 = blockIdx.x * rows_per_block;
  const long r1 =
      r0 + rows_per_block < rows ? r0 + rows_per_block : rows;
  for (long row = r0; row < r1; ++row) {
    const float r = rstd[row];
    const TX* xr = x + row * d;
    float s = 0.0f;
    for (int i = threadIdx.x; i < d; i += NT) {
      const float xh = to_f32(xr[i]) * r;
      s = fmaf(g.at(row * d + i) * (1.0f + scale[i]), xh, s);
    }
    const float m = block_sum(s, red) / d;
    TX* dxr = dx + row * d;
    const TX* sk = dskip ? dskip + row * d : nullptr;
    for (int i = threadIdx.x; i < d; i += NT) {
      const float xh = to_f32(xr[i]) * r;
      const float gv = g.at(row * d + i);
      const TX v = from_f32<TX>(r * (gv * (1.0f + scale[i]) - xh * m));
      dxr[i] = sk ? from_f32<TX>(to_f32(v) + to_f32(sk[i])) : v;
      smem[i] = fmaf(gv, xh, smem[i]);  // column i is this thread's alone
    }
  }
  for (int i = threadIdx.x; i < d; i += NT)
    part[static_cast<long>(blockIdx.x) * d + i] = smem[i];
}

// dscale[i] = sum over the backward's blocks of part[b][i], b in order
__global__ void __launch_bounds__(NT)
rmsnorm_dscale_kernel(const float* __restrict__ part,
                      float* __restrict__ dscale, int nblocks, int d) {
  const int i = blockIdx.x * NT + threadIdx.x;
  if (i >= d) return;
  float s = 0.0f;
  for (int b = 0; b < nblocks; ++b) s += part[static_cast<long>(b) * d + i];
  dscale[i] = s;
}

template <typename TX, typename TO>
int fwd(const void* x, const float* scale, const void* res, void* out,
        float* rstd, long rows, int d, float eps, void* stream) {
  auto kern = rmsnorm_fwd_kernel<TX, TO>;
  kern<<<static_cast<unsigned>((rows + NWARP - 1) / NWARP), NT, 0,
         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TX*>(x), scale, static_cast<const TO*>(res),
      static_cast<TO*>(out), rstd, rows, d, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TO>
int bwd(const void* const* g, const void* x, const float* scale,
        const float* rstd, const void* dskip, void* dx, float* part,
        float* dscale, long rows, int d, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long per = bwd_rows_per_block(rows);
  const int nblocks = static_cast<int>((rows + per - 1) / per);
  const size_t smem = sizeof(float) * d;
  auto kern = rmsnorm_bwd_kernel<TX, TO>;
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kern),
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Cot<TO> cot{{static_cast<const TO*>(g[0]),
                     static_cast<const TO*>(g[1]),
                     static_cast<const TO*>(g[2])}};
  kern<<<nblocks, NT, smem, st>>>(
      cot, static_cast<const TX*>(x), scale, rstd,
      static_cast<const TX*>(dskip), static_cast<TX*>(dx), part, rows, d,
      per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rmsnorm_dscale_kernel<<<(d + NT - 1) / NT, NT, 0, st>>>(part, dscale,
                                                          nblocks, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The number of blocks of the backward's first launch for `rows` rows (the
// rows of its partial-sum scratch, (blocks, d) fp32).
extern "C" int rmsnorm_bwd_blocks(long rows) {
  if (rows <= 0) return 0;
  const long per = bwd_rows_per_block(rows);
  return static_cast<int>((rows + per - 1) / per);
}

// x (rows, d) of type x_bf16 ? bf16 : fp32; out (and res, which may be
// null) of type out_bf16 ? bf16 : fp32; scale fp32 (d); rstd fp32 (rows).
extern "C" int rmsnorm_fwd(const void* x, const float* scale, const void* res,
                           void* out, float* rstd, long rows, int d,
                           float eps, int x_bf16, int out_bf16,
                           void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  if (x_bf16 && out_bf16)
    return fwd<__nv_bfloat16, __nv_bfloat16>(x, scale, res, out, rstd, rows,
                                             d, eps, stream);
  if (x_bf16)
    return fwd<__nv_bfloat16, float>(x, scale, res, out, rstd, rows, d, eps,
                                     stream);
  if (out_bf16)
    return fwd<float, __nv_bfloat16>(x, scale, res, out, rstd, rows, d, eps,
                                     stream);
  return fwd<float, float>(x, scale, res, out, rstd, rows, d, eps, stream);
}

// g, g2, g3 (the output's consumers' cotangents, g2 and g3 nullable) of the
// output's type; x, dskip (the skip's cotangent, nullable) and dx of x's;
// part (rmsnorm_bwd_blocks(rows), d) fp32 scratch; dscale fp32 (d).
extern "C" int rmsnorm_bwd(const void* g1, const void* g2, const void* g3,
                           const void* x, const float* scale,
                           const float* rstd, const void* dskip, void* dx,
                           float* part, float* dscale, long rows, int d,
                           int x_bf16, int out_bf16, void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  if (g2 == nullptr && g3 != nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* g[3] = {g1, g2, g3};
  if (x_bf16 && out_bf16)
    return bwd<__nv_bfloat16, __nv_bfloat16>(g, x, scale, rstd, dskip, dx,
                                             part, dscale, rows, d, stream);
  if (x_bf16)
    return bwd<__nv_bfloat16, float>(g, x, scale, rstd, dskip, dx, part,
                                     dscale, rows, d, stream);
  if (out_bf16)
    return bwd<float, __nv_bfloat16>(g, x, scale, rstd, dskip, dx, part,
                                     dscale, rows, d, stream);
  return bwd<float, float>(g, x, scale, rstd, dskip, dx, part, dscale, rows,
                           d, stream);
}
