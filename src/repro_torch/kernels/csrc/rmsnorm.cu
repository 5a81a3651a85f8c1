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
// 38 MB (75 MB with the residual), the backward 113 MB with one cotangent
// (226 MB with three and the skip's): 11-68 us at 3.35 TB/s.
//
// Design (the vector forms, for d a multiple of 8 up to 4,096 with every
// tensor 16-byte aligned: each width of the repo's decoders): one warp a
// row, 8 warps a block, each lane owning the fixed 8-value chunks lane,
// lane + 32, ... of the row, read and written with 16-byte accesses (8
// bf16, or two of 4 fp32).  The number of chunks a lane holds is a
// compile-time bound NV (1, 2, 4, 9, 10 or 16: 9 at d = 2,304, 4 at 1,024,
// 16 at 4,096; a row of a width between holds idle slots), so the row stays
// in registers between its sum of squares and its scaling: x is read once.
// The backward reads x and the cotangents from device memory once, for the
// row's sum, and again from L1 for dx; each lane keeps its columns' dscale
// partial in registers across the rows the warp takes (the block's fixed
// row range, rows r0 + w, r0 + w + 8, ...); at the block's end the warps'
// partials are summed in warp order, and rmsnorm_dscale_kernel sums the
// blocks in block order.  Past 10 chunks a lane (d > 2,560: phi3.5-moe's
// 4,096) two warps share a row, each holding half its chunks and its
// partial, the row sum the pair's two warp sums in order (a named barrier
// a pair).  The row ranges depend on `rows` alone
// (rmsnorm_bwd_blocks), never on the card, so the bits are the same on
// every card.  Row sums are a fixed tree (warp shuffles).
//
// Any other d (not a multiple of 8, wider, or a misaligned view) takes the
// general forms: one warp a row with scalar accesses, the row read twice,
// in the forward; in the backward a block a row, a row sum across the
// block, the dscale partial in shared memory, one column a thread, over the
// same row ranges.
#include <initializer_list>

#include "hopper.cuh"

using repro::from_f32;
using repro::to_f32;

namespace {

constexpr int NT = 256;
constexpr int NWARP = NT / 32;
constexpr int BWD_BLOCKS = 256;  // the backward's grid at most ...
constexpr long BWD_MIN_ROWS = 16;  // ... of this many rows a block at least
constexpr int MAX_NV = 16;       // the vector forms' widest row: 4,096

// rows a block of the backward: fixed by `rows` alone (determinism)
long bwd_rows_per_block(long rows) {
  const long per = (rows + BWD_BLOCKS - 1) / BWD_BLOCKS;
  return per > BWD_MIN_ROWS ? per : BWD_MIN_ROWS;
}

// ------------------------------------------------------- the vector forms

// 8 values of a row: one 16-byte access in bf16, two in fp32
template <typename T>
struct alignas(16) V8 {
  T v[8];
};

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
  // chunk c (8 values) of row `row`, summed as at()
  __device__ __forceinline__ V8<TO> chunk(long row, int d, int c) const {
    const long o = row * d / 8 + c;
    V8<TO> v = reinterpret_cast<const V8<TO>*>(g[0])[o];
    if (g[1]) {
      const V8<TO> a = reinterpret_cast<const V8<TO>*>(g[1])[o];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        v.v[i] = from_f32<TO>(to_f32(v.v[i]) + to_f32(a.v[i]));
    }
    if (g[2]) {
      const V8<TO> a = reinterpret_cast<const V8<TO>*>(g[2])[o];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        v.v[i] = from_f32<TO>(to_f32(v.v[i]) + to_f32(a.v[i]));
    }
    return v;
  }
};

// one warp a row, NWARP rows a block; lane owns chunks lane + 32 j, j < NV
template <typename TX, typename TO, int NV>
__global__ void __launch_bounds__(NT)
rmsnorm_fwd_vec_kernel(const TX* __restrict__ x,
                       const float* __restrict__ scale,
                       const TO* __restrict__ res, TO* __restrict__ out,
                       float* __restrict__ rstd, long rows, int d,
                       float eps) {
  const int lane = threadIdx.x & 31;
  const long row = static_cast<long>(blockIdx.x) * NWARP + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int nc = d / 8;
  const long r0 = row * nc;   // the row's first chunk
  V8<TX> xv[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j)
    if (lane + 32 * j < nc)
      xv[j] = reinterpret_cast<const V8<TX>*>(x)[r0 + lane + 32 * j];
  float ss = 0.0f;
#pragma unroll
  for (int j = 0; j < NV; ++j)
    if (lane + 32 * j < nc)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float v = to_f32(xv[j].v[i]);
        ss = fmaf(v, v, ss);
      }
  const float r = rsqrtf(repro::warp_sum(ss) / d + eps);
  if (lane == 0) rstd[row] = r;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = lane + 32 * j;
    if (c >= nc) continue;
    const V8<float> sc = reinterpret_cast<const V8<float>*>(scale)[c];
    V8<TO> o;
    if (res) {
      const V8<TO> rr = reinterpret_cast<const V8<TO>*>(res)[r0 + c];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float y = to_f32(xv[j].v[i]) * r * (1.0f + sc.v[i]);
        o.v[i] = from_f32<TO>(to_f32(rr.v[i]) + to_f32(from_f32<TO>(y)));
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        o.v[i] = from_f32<TO>(to_f32(xv[j].v[i]) * r * (1.0f + sc.v[i]));
    }
    reinterpret_cast<V8<TO>*>(out)[r0 + c] = o;
  }
}

// a team of WPR warps a row over the block's fixed row range (rows r0 +
// team, + NWARP / WPR, ...), warp h of a team owning the chunks (j WPR + h)
// 32 + lane, j < NV; each lane's dscale partial for its chunks in
// registers; at the end the warps' partials summed in warp order into
// `part`'s row of the block
template <typename TX, typename TO, int NV, int WPR>
__global__ void __launch_bounds__(NT)
rmsnorm_bwd_vec_kernel(Cot<TO> g, const TX* __restrict__ x,
                       const float* __restrict__ scale,
                       const float* __restrict__ rstd,
                       const TX* __restrict__ dskip, TX* __restrict__ dx,
                       float* __restrict__ part, long rows, int d,
                       long rows_per_block) {
  constexpr int TEAMS = NWARP / WPR;
  extern __shared__ float smem[];  // the warps' partials, summed in order
  __shared__ float red[2][NWARP];  // a team's warps' row sums, by parity
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int team = warp / WPR, h = warp % WPR;
  const int nc = d / 8;
  float acc[NV][8];
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[j][i] = 0.0f;
  const long b0 = blockIdx.x * rows_per_block;
  const long b1 = b0 + rows_per_block < rows ? b0 + rows_per_block : rows;
  int parity = 0;
  for (long row = b0 + team; row < b1; row += TEAMS) {
    const float r = rstd[row];
    const long r0 = row * nc;
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = (j * WPR + h) * 32 + lane;
      if (c >= nc) continue;
      const V8<TX> xc = reinterpret_cast<const V8<TX>*>(x)[r0 + c];
      const V8<TO> gc = g.chunk(row, d, c);
      const V8<float> sc = reinterpret_cast<const V8<float>*>(scale)[c];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        s = fmaf(to_f32(gc.v[i]) * (1.0f + sc.v[i]), to_f32(xc.v[i]) * r, s);
    }
    float sum = repro::warp_sum(s);
    if constexpr (WPR > 1) {   // the team's warps' sums, in warp order
      if (lane == 0) red[parity][warp] = sum;
      repro::named_barrier(1 + team, 32 * WPR);
      sum = 0.0f;
#pragma unroll
      for (int k = 0; k < WPR; ++k) sum += red[parity][team * WPR + k];
      parity ^= 1;   // the next row writes the other half: a team's warps
                     // both passed this row's barrier before it
    }
    const float m = sum / d;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int c = (j * WPR + h) * 32 + lane;
      if (c >= nc) continue;
      // the row again, from L1 (kept in registers, x and g with the partial
      // took 255 of them at d = 2,304 and ran 1.2x slower)
      const V8<TX> xc = reinterpret_cast<const V8<TX>*>(x)[r0 + c];
      const V8<TO> gc = g.chunk(row, d, c);
      const V8<float> sc = reinterpret_cast<const V8<float>*>(scale)[c];
      V8<TX> o;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float xh = to_f32(xc.v[i]) * r;
        const float gf = to_f32(gc.v[i]);
        o.v[i] = from_f32<TX>(r * (gf * (1.0f + sc.v[i]) - xh * m));
        acc[j][i] = fmaf(gf, xh, acc[j][i]);
      }
      if (dskip) {
        const V8<TX> sk = reinterpret_cast<const V8<TX>*>(dskip)[r0 + c];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          o.v[i] = from_f32<TX>(to_f32(o.v[i]) + to_f32(sk.v[i]));
      }
      reinterpret_cast<V8<TX>*>(dx)[r0 + c] = o;
    }
  }
  // the warps' partials in warp order: a column's first owner writes smem,
  // the next ones add theirs, its last owner writes the block's sum
  for (int w = 0; w < NWARP; ++w) {
    if (warp == w) {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int c = (j * WPR + h) * 32 + lane;
        if (c >= nc) continue;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float v = w < WPR ? acc[j][i] : smem[8 * c + i] + acc[j][i];
          if (w >= NWARP - WPR)
            part[static_cast<long>(blockIdx.x) * d + 8 * c + i] = v;
          else
            smem[8 * c + i] = v;
        }
      }
    }
    __syncthreads();
  }
}

// ------------------------------------------------------ the general forms

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

// ------------------------------------------------------------ launches

// the vector forms' chunks a lane of a warp a row for width d (0: the
// general form: d not a multiple of 8, wider than MAX_NV chunks a lane, or
// a pointer off 16 bytes)
int vec_chunks(int d, std::initializer_list<const void*> ptrs) {
  if (d % 8 != 0) return 0;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) & 15) return 0;
  const int per = (d / 8 + 31) / 32;
  return per <= MAX_NV ? per : 0;
}

// the compile-time bound NV of the vector forms for `per` chunks a lane
// (0: the general form)
int vec_nv(int per) {
  if (per <= 0) return 0;
  for (int nv : {1, 2, 4, 9, 10, MAX_NV})
    if (per <= nv) return nv;
  return 0;
}

template <typename TX, typename TO, int NV>
void fwd_vec(dim3 grid, cudaStream_t st, const void* x, const float* scale,
             const void* res, void* out, float* rstd, long rows, int d,
             float eps) {
  rmsnorm_fwd_vec_kernel<TX, TO, NV><<<grid, NT, 0, st>>>(
      static_cast<const TX*>(x), scale, static_cast<const TO*>(res),
      static_cast<TO*>(out), rstd, rows, d, eps);
}

template <typename TX, typename TO>
int fwd(const void* x, const float* scale, const void* res, void* out,
        float* rstd, long rows, int d, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>((rows + NWARP - 1) / NWARP));
  switch (vec_nv(vec_chunks(d, {x, scale, res, out}))) {
    case 1:
      fwd_vec<TX, TO, 1>(grid, st, x, scale, res, out, rstd, rows, d, eps);
      break;
    case 2:
      fwd_vec<TX, TO, 2>(grid, st, x, scale, res, out, rstd, rows, d, eps);
      break;
    case 4:
      fwd_vec<TX, TO, 4>(grid, st, x, scale, res, out, rstd, rows, d, eps);
      break;
    case 9:
      fwd_vec<TX, TO, 9>(grid, st, x, scale, res, out, rstd, rows, d, eps);
      break;
    case 10:
      fwd_vec<TX, TO, 10>(grid, st, x, scale, res, out, rstd, rows, d, eps);
      break;
    case MAX_NV:
      fwd_vec<TX, TO, MAX_NV>(grid, st, x, scale, res, out, rstd, rows, d,
                              eps);
      break;
    default:
      rmsnorm_fwd_kernel<TX, TO><<<grid, NT, 0, st>>>(
          static_cast<const TX*>(x), scale, static_cast<const TO*>(res),
          static_cast<TO*>(out), rstd, rows, d, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TO, int NV, int WPR = 1>
void bwd_vec(int nblocks, size_t smem, cudaStream_t st, const Cot<TO>& cot,
             const void* x, const float* scale, const float* rstd,
             const void* dskip, void* dx, float* part, long rows, int d,
             long per) {
  rmsnorm_bwd_vec_kernel<TX, TO, NV, WPR><<<nblocks, NT, smem, st>>>(
      cot, static_cast<const TX*>(x), scale, rstd,
      static_cast<const TX*>(dskip), static_cast<TX*>(dx), part, rows, d,
      per);
}

template <typename TX, typename TO>
int bwd(const void* const* g, const void* x, const float* scale,
        const float* rstd, const void* dskip, void* dx, float* part,
        float* dscale, long rows, int d, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long per = bwd_rows_per_block(rows);
  const int nblocks = static_cast<int>((rows + per - 1) / per);
  const size_t smem = sizeof(float) * d;
  const Cot<TO> cot{{static_cast<const TO*>(g[0]),
                     static_cast<const TO*>(g[1]),
                     static_cast<const TO*>(g[2])}};
  // past 10 chunks a lane (d > 2,560) two warps share a row, 9 chunks a
  // lane at most: the partial of 16 chunks a lane took 190 registers, one
  // block an SM, and ran no faster than the general form
  const int chunks = vec_chunks(d, {g[0], g[1], g[2], x, scale, dskip, dx});
  switch (chunks > 10 ? -1 : vec_nv(chunks)) {
    case 1:
      bwd_vec<TX, TO, 1>(nblocks, smem, st, cot, x, scale, rstd, dskip, dx,
                         part, rows, d, per);
      break;
    case 2:
      bwd_vec<TX, TO, 2>(nblocks, smem, st, cot, x, scale, rstd, dskip, dx,
                         part, rows, d, per);
      break;
    case 4:
      bwd_vec<TX, TO, 4>(nblocks, smem, st, cot, x, scale, rstd, dskip, dx,
                         part, rows, d, per);
      break;
    case 9:
      bwd_vec<TX, TO, 9>(nblocks, smem, st, cot, x, scale, rstd, dskip, dx,
                         part, rows, d, per);
      break;
    case 10:
      bwd_vec<TX, TO, 10>(nblocks, smem, st, cot, x, scale, rstd, dskip, dx,
                          part, rows, d, per);
      break;
    case -1:   // 11 to 16 chunks a lane: at most 9 a lane of a pair
      bwd_vec<TX, TO, 9, 2>(nblocks, smem, st, cot, x, scale, rstd, dskip,
                            dx, part, rows, d, per);
      break;
    default: {
      auto kern = rmsnorm_bwd_kernel<TX, TO>;
      cudaError_t err = cudaFuncSetAttribute(
          reinterpret_cast<const void*>(kern),
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      kern<<<nblocks, NT, smem, st>>>(
          cot, static_cast<const TX*>(x), scale, rstd,
          static_cast<const TX*>(dskip), static_cast<TX*>(dx), part, rows, d,
          per);
    }
  }
  cudaError_t err = cudaGetLastError();
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
