// Mamba-2's output gate: the D skip, the SiLU gate and the RMSNorm in one
// pass, forward and backward.
//
// Replaces the arithmetic the TPU kernels src/repro/kernels/segment_pallas.py
// ::fused_advance_segment / ::fused_reverse_segment run for a mamba2 body
// (the body is traced into the pallas_call: the chunk scans at :186, :323
// and the chunk vjp at :395-409): src/repro/models/ssm.py:202-204 (the
// skip, the gated norm of :154-158, the cast) and their vjp.  The port's
// plain version is repro_torch/kernels/gated_norm.py::gated_norm_plain /
// gated_norm_bwd_plain.
//
//   forward   u = round(y + round(D_h x))   (the plain version's two
//                                           roundings in y's type kept)
//             v = u silu(z), rstd = rsqrt(mean(v^2) + eps) (fp32, a row),
//             out = v rstd (1 + scale), rounded to the output type
//   backward  vh = v rstd, w = 1 + scale,
//             dv = rstd (g w - vh mean(g w vh)),
//             du = round(dv silu(z)) (y's type): dy = du, dx = round(du D_h),
//             dz = round(dv u silu'(z)) (z's type),
//             dscale = sum over rows of g vh, dD_h = sum over rows and the
//             head's columns of du x, both fp32: per-block partials over
//             fixed row ranges, then a second launch sums them in block
//             order (no atomics: two calls give the same bits)
//
// Column i belongs to head i / P.  x and z are read in place through a row
// stride (z the input projection's first d_inner columns, x the conv's x
// output), and dz is written through one (into those columns of the input
// projection's cotangent).
//
// Bound: bytes.  At mamba2-370m's rows (16384 x 2048, bf16) the forward
// reads y, x, z and writes out: 268 MB, 80 us at 3.35 TB/s; the backward
// reads g, y, x, z and writes dy, dx, dz: 470 MB, 140 us.  Design: one warp
// a row in the forward (64 values a lane at 2048), the row's values
// recomputed from the inputs on the second walk (L1/L2); in the backward
// up to 256 blocks walk fixed ranges of rows, a block a row at a time,
// keeping both partials in shared memory, one column a thread.  Row sums
// are a fixed tree (warp shuffles; in the backward then the warps' sums in
// order).
#include "common.cuh"

using repro::from_f32;
using repro::to_f32;

namespace {

constexpr int NT = 256;
constexpr int NWARP = NT / 32;
constexpr int BWD_BLOCKS = 256;    // the backward's grid at most ...
constexpr long BWD_MIN_ROWS = 16;  // ... of this many rows a block at least

long bwd_rows_per_block(long rows) {
  const long per = (rows + BWD_BLOCKS - 1) / BWD_BLOCKS;
  return per > BWD_MIN_ROWS ? per : BWD_MIN_ROWS;
}

__device__ __forceinline__ float sigmoid(float z) {
  return 1.0f / (1.0f + expf(-z));
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  v = repro::warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.0f;
#pragma unroll
  for (int w = 0; w < NWARP; ++w) s += red[w];
  __syncthreads();
  return s;
}

// u = round(y + round(D_h x)) in y's type, as fp32
template <typename TY>
__device__ __forceinline__ float skip(TY y, TY x, float d) {
  const float t = to_f32(from_f32<TY>(d * to_f32(x)));
  return to_f32(from_f32<TY>(to_f32(y) + t));
}

struct Rows {
  long rows;
  int d, P;
  long sx, sz;   // row strides of x and z (y, g and the outputs: d) ...
  long sdz;      // ... but dz's (its columns of the input projection's
                 // cotangent)
  float eps;
};

// one warp a row, NWARP rows a block
template <typename TY, typename TZ, typename TO>
__global__ void __launch_bounds__(NT)
gated_norm_fwd_kernel(const TY* __restrict__ y, const TY* __restrict__ x,
                      const TZ* __restrict__ z, const float* __restrict__ D,
                      const float* __restrict__ scale, TO* __restrict__ out,
                      float* __restrict__ rstd, Rows r) {
  const int lane = threadIdx.x & 31;
  const long row = static_cast<long>(blockIdx.x) * NWARP + (threadIdx.x >> 5);
  if (row >= r.rows) return;
  const TY* yr = y + row * r.d;
  const TY* xr = x + row * r.sx;
  const TZ* zr = z + row * r.sz;
  float ss = 0.0f;
  for (int i = lane; i < r.d; i += 32) {
    const float zv = to_f32(zr[i]);
    const float v = skip(yr[i], xr[i], D[i / r.P]) * (zv * sigmoid(zv));
    ss = fmaf(v, v, ss);
  }
  const float rs = rsqrtf(repro::warp_sum(ss) / r.d + r.eps);
  if (lane == 0) rstd[row] = rs;
  TO* orow = out + row * r.d;
  for (int i = lane; i < r.d; i += 32) {
    const float zv = to_f32(zr[i]);
    const float v = skip(yr[i], xr[i], D[i / r.P]) * (zv * sigmoid(zv));
    orow[i] = from_f32<TO>(v * rs * (1.0f + scale[i]));
  }
}

template <typename TY, typename TZ, typename TO>
__global__ void __launch_bounds__(NT)
gated_norm_bwd_kernel(const TO* __restrict__ g, const TY* __restrict__ y,
                      const TY* __restrict__ x, const TZ* __restrict__ z,
                      const float* __restrict__ D,
                      const float* __restrict__ scale,
                      const float* __restrict__ rstd, TY* __restrict__ dy,
                      TY* __restrict__ dx, TZ* __restrict__ dz,
                      float* __restrict__ part, Rows r, long rows_per_block) {
  extern __shared__ float smem[];  // this block's partials: 2 d floats
  __shared__ float red[NWARP];
  float* ps = smem;         // g vh, a column
  float* pd = smem + r.d;   // du x, a column
  for (int i = threadIdx.x; i < 2 * r.d; i += NT) smem[i] = 0.0f;
  __syncthreads();   // column i's two partials are thread i % NT's
  const long r0 = blockIdx.x * rows_per_block;
  const long r1 = r0 + rows_per_block < r.rows ? r0 + rows_per_block : r.rows;
  for (long row = r0; row < r1; ++row) {
    const float rs = rstd[row];
    const TY* yr = y + row * r.d;
    const TY* xr = x + row * r.sx;
    const TZ* zr = z + row * r.sz;
    const TO* gr = g + row * r.d;
    float s = 0.0f;
    for (int i = threadIdx.x; i < r.d; i += NT) {
      const float zv = to_f32(zr[i]);
      const float vh = skip(yr[i], xr[i], D[i / r.P]) * (zv * sigmoid(zv)) *
                       rs;
      s = fmaf(to_f32(gr[i]) * (1.0f + scale[i]), vh, s);
    }
    const float m = block_sum(s, red) / r.d;
    for (int i = threadIdx.x; i < r.d; i += NT) {
      const float zv = to_f32(zr[i]), sg = sigmoid(zv), sz = zv * sg;
      const float dh = D[i / r.P];
      const float u = skip(yr[i], xr[i], dh);
      const float vh = u * sz * rs;
      const float gv = to_f32(gr[i]);
      const float dv = rs * (gv * (1.0f + scale[i]) - vh * m);
      const TY du = from_f32<TY>(dv * sz);
      const long o = row * r.d + i;
      dy[o] = du;
      dx[o] = from_f32<TY>(to_f32(du) * dh);
      dz[row * r.sdz + i] =
          from_f32<TZ>(dv * u * (sg * (1.0f + zv * (1.0f - sg))));
      ps[i] = fmaf(gv, vh, ps[i]);   // column i is this thread's alone
      pd[i] = fmaf(to_f32(du), to_f32(xr[i]), pd[i]);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * r.d; i += NT)
    part[static_cast<long>(blockIdx.x) * 2 * r.d + i] = smem[i];
}

// dscale[i] = sum over blocks b of part[b][i]; dD[h] = sum over the head's
// columns p of (sum over blocks of part[b][d + h P + p]); in order
__global__ void __launch_bounds__(NT)
gated_norm_sums_kernel(const float* __restrict__ part,
                       float* __restrict__ dscale, float* __restrict__ dD,
                       int nblocks, int d, int P) {
  const int i = blockIdx.x * NT + threadIdx.x;
  if (i < d) {
    float s = 0.0f;
    for (int b = 0; b < nblocks; ++b) s += part[static_cast<long>(b) * 2 * d + i];
    dscale[i] = s;
  } else if (i < d + d / P) {
    const int h = i - d;
    float s = 0.0f;
    for (int p = 0; p < P; ++p) {
      float c = 0.0f;
      for (int b = 0; b < nblocks; ++b)
        c += part[static_cast<long>(b) * 2 * d + d + h * P + p];
      s += c;
    }
    dD[h] = s;
  }
}

template <typename TY, typename TZ, typename TO>
int fwd(const void* y, const void* x, const void* z, const float* D,
        const float* scale, void* out, float* rstd, const Rows& r,
        void* stream) {
  auto kern = gated_norm_fwd_kernel<TY, TZ, TO>;
  kern<<<static_cast<unsigned>((r.rows + NWARP - 1) / NWARP), NT, 0,
         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TY*>(y), static_cast<const TY*>(x),
      static_cast<const TZ*>(z), D, scale, static_cast<TO*>(out), rstd, r);
  return static_cast<int>(cudaGetLastError());
}

template <typename TY, typename TZ, typename TO>
int bwd(const void* g, const void* y, const void* x, const void* z,
        const float* D, const float* scale, const float* rstd, void* dy,
        void* dx, void* dz, float* part, float* dscale, float* dD,
        const Rows& r, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long per = bwd_rows_per_block(r.rows);
  const int nblocks = static_cast<int>((r.rows + per - 1) / per);
  const size_t smem = sizeof(float) * 2 * r.d;
  auto kern = gated_norm_bwd_kernel<TY, TZ, TO>;
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kern),
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<nblocks, NT, smem, st>>>(
      static_cast<const TO*>(g), static_cast<const TY*>(y),
      static_cast<const TY*>(x), static_cast<const TZ*>(z), D, scale, rstd,
      static_cast<TY*>(dy), static_cast<TY*>(dx), static_cast<TZ*>(dz), part,
      r, per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = r.d + r.d / r.P;
  gated_norm_sums_kernel<<<(n + NT - 1) / NT, NT, 0, st>>>(part, dscale, dD,
                                                           nblocks, r.d, r.P);
  return static_cast<int>(cudaGetLastError());
}

// the type combinations the wrappers take: y/x and z of one type (the
// compute dtype), the output of it or fp32
template <typename F>
int dispatch(int bf16, int out_bf16, F f) {
  if (bf16 && out_bf16) return f(__nv_bfloat16(), __nv_bfloat16());
  if (bf16) return f(__nv_bfloat16(), 0.0f);
  if (out_bf16) return f(0.0f, __nv_bfloat16());
  return f(0.0f, 0.0f);
}

}  // namespace

// The number of blocks of the backward's first launch for `rows` rows (the
// rows of its partial-sum scratch, (blocks, 2 d) fp32).
extern "C" int gated_norm_bwd_blocks(long rows) {
  if (rows <= 0) return 0;
  const long per = bwd_rows_per_block(rows);
  return static_cast<int>((rows + per - 1) / per);
}

// y (rows, d), x and z (rows, d) at row strides sx, sz, all of type bf16 ?
// bf16 : fp32; D fp32 (d / P), the values of the model's D in y's type;
// scale fp32 (d); out (rows, d) of type out_bf16 ? bf16 : fp32; rstd fp32
// (rows).
extern "C" int gated_norm_fwd(const void* y, const void* x, const void* z,
                              const float* D, const float* scale, void* out,
                              float* rstd, long rows, int d, int P, long sx,
                              long sz, float eps, int bf16, int out_bf16,
                              void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  if (P <= 0 || d % P != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Rows r{rows, d, P, sx, sz, d, eps};
  return dispatch(bf16, out_bf16, [&](auto ty, auto to) {
    using TY = decltype(ty);
    using TO = decltype(to);
    return fwd<TY, TY, TO>(y, x, z, D, scale, out, rstd, r, stream);
  });
}

// g (rows, d) of the output's type; dy, dx (rows, d) of y's and dz (rows,
// d) at row stride sdz of z's; part (gated_norm_bwd_blocks(rows), 2 d) fp32
// scratch; dscale fp32 (d), dD fp32 (d / P).
extern "C" int gated_norm_bwd(const void* g, const void* y, const void* x,
                              const void* z, const float* D,
                              const float* scale, const float* rstd, void* dy,
                              void* dx, void* dz, float* part, float* dscale,
                              float* dD, long rows, int d, int P, long sx,
                              long sz, long sdz, int bf16, int out_bf16,
                              void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  if (P <= 0 || d % P != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Rows r{rows, d, P, sx, sz, sdz, 0.0f};
  return dispatch(bf16, out_bf16, [&](auto ty, auto to) {
    using TY = decltype(ty);
    using TO = decltype(to);
    return bwd<TY, TY, TO>(g, y, x, z, D, scale, rstd, dy, dx, dz, part,
                           dscale, dD, r, stream);
  });
}
