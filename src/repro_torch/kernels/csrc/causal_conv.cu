// Mamba-2's causal depthwise convolution over the (x, B, C) channels, with
// its bias and SiLU, forward and backward.
//
// Replaces the arithmetic the TPU kernels src/repro/kernels/segment_pallas.py
// ::fused_advance_segment / ::fused_reverse_segment run for a mamba2 body
// (the body is traced into the pallas_call: the chunk scans at :186, :323
// and the chunk vjp at :395-409): src/repro/models/ssm.py:179-188 and its
// vjp.  The port's plain version is repro_torch/kernels/causal_conv.py::
// causal_conv_plain / causal_conv_bwd_plain.
//
// With pad = [window; xbc] along time (window: the carried K - 1 rows, zero
// when none is given):
//
//   forward   a[t][c] = round(sum_i pad[t + i][c] w[i][c] + bias[c]) (the
//             sum in fp32, one rounding to the input's type where the plain
//             version rounds every product and every partial sum),
//             out = round(silu(a))
//   backward  da = round(g silu'(a)) (the input's type, as autograd's SiLU
//             backward rounds it);
//             dpad[j][c] = sum_i da[j - i][c] w[i][c] (fp32, one rounding):
//             dxbc = dpad[K - 1 ..], dwindow = dpad[.. K - 1];
//             dw[i][c] = sum_{b,t} da[b][t][c] pad[b][t + i][c],
//             dbias[c] = sum_{b,t} da[b][t][c]: per-block partials over
//             fixed row ranges, then a third launch sums them in block order
//             (no atomics: two calls give the same bits)
//
// Bound: bytes.  At mamba2-370m's layer (B = 4, T = 4096, 2304 channels,
// K = 4, bf16) the forward reads xbc and writes out: 151 MB, 45 us at
// 3.35 TB/s; the backward reads g and xbc and writes dxbc: 226 MB, 68 us.
// Design: a thread an output element, channels fastest (coalesced); the
// backward recomputes a and da where it needs them (K + 1 multiply-adds and
// an exp each) rather than writing them out.
#include "common.cuh"

using repro::from_f32;
using repro::to_f32;

namespace {

constexpr int NT = 256;
constexpr int KMAX = 8;
constexpr int PART_BLOCKS = 256;    // row blocks of the weight sums at most
constexpr long PART_MIN_ROWS = 64;  // ... of this many rows a block at least

long rows_per_part(long rows) {
  const long per = (rows + PART_BLOCKS - 1) / PART_BLOCKS;
  return per > PART_MIN_ROWS ? per : PART_MIN_ROWS;
}

struct Conv {
  int B, T, C, K;
  long sx;   // xbc's row stride (the outputs' and g's: C)
};

template <typename T>
struct Pad {
  const T* x;
  const T* win;   // (B, K - 1, C) or null
  Conv s;
  // pad[b][j][c]
  __device__ __forceinline__ float at(int b, int j, int c) const {
    if (j >= s.K - 1)
      return to_f32(x[(static_cast<long>(b) * s.T + j - (s.K - 1)) * s.sx + c]);
    return win ? to_f32(win[(static_cast<long>(b) * (s.K - 1) + j) * s.C + c])
               : 0.0f;
  }
};

template <typename T>
__device__ __forceinline__ float preact(const Pad<T>& p, const T* w,
                                        const T* bias, int b, int t, int c) {
  float acc = 0.0f;
  for (int i = 0; i < p.s.K; ++i)
    acc = fmaf(p.at(b, t + i, c), to_f32(w[i * p.s.C + c]), acc);
  return to_f32(from_f32<T>(acc + to_f32(bias[c])));
}

template <typename T>
__device__ __forceinline__ float dpre(const Pad<T>& p, const T* w,
                                      const T* bias, const T* g, int b, int t,
                                      int c) {
  const float a = preact(p, w, bias, b, t, c);
  const float sg = 1.0f / (1.0f + expf(-a));
  const float gv = to_f32(g[(static_cast<long>(b) * p.s.T + t) * p.s.C + c]);
  return to_f32(from_f32<T>(gv * (sg * (1.0f + a * (1.0f - sg)))));
}

template <typename T>
__global__ void __launch_bounds__(NT)
conv_fwd_kernel(Pad<T> p, const T* __restrict__ w, const T* __restrict__ bias,
                T* __restrict__ out) {
  const long e = static_cast<long>(blockIdx.x) * NT + threadIdx.x;
  const Conv& s = p.s;
  if (e >= static_cast<long>(s.B) * s.T * s.C) return;
  const int c = static_cast<int>(e % s.C);
  const long bt = e / s.C;
  const int t = static_cast<int>(bt % s.T), b = static_cast<int>(bt / s.T);
  const float a = preact(p, w, bias, b, t, c);
  out[e] = from_f32<T>(a / (1.0f + expf(-a)));
}

// dpad over j in [0, T + K - 1): a thread an element of dxbc (j >= K - 1)
// or of dwindow (j < K - 1, when it is asked for)
template <typename T>
__global__ void __launch_bounds__(NT)
conv_dx_kernel(Pad<T> p, const T* __restrict__ w, const T* __restrict__ bias,
               const T* __restrict__ g, T* __restrict__ dx,
               T* __restrict__ dwin) {
  const Conv& s = p.s;
  const int J = s.T + s.K - 1;
  const long e = static_cast<long>(blockIdx.x) * NT + threadIdx.x;
  if (e >= static_cast<long>(s.B) * J * s.C) return;
  const int c = static_cast<int>(e % s.C);
  const long bj = e / s.C;
  const int j = static_cast<int>(bj % J), b = static_cast<int>(bj / J);
  if (j < s.K - 1 && dwin == nullptr) return;
  float acc = 0.0f;
  for (int i = 0; i < s.K; ++i) {
    const int t = j - i;
    if (t >= 0 && t < s.T)
      acc = fmaf(dpre(p, w, bias, g, b, t, c), to_f32(w[i * s.C + c]), acc);
  }
  if (j >= s.K - 1)
    dx[(static_cast<long>(b) * s.T + j - (s.K - 1)) * s.C + c] =
        from_f32<T>(acc);
  else
    dwin[(static_cast<long>(b) * (s.K - 1) + j) * s.C + c] = from_f32<T>(acc);
}

// part[rb][i][c] (i < K: the weight's, i = K: the bias's) over the rows
// [rb per, (rb + 1) per) of the (B T) axis, in order
template <typename T>
__global__ void __launch_bounds__(NT)
conv_part_kernel(Pad<T> p, const T* __restrict__ w, const T* __restrict__ bias,
                 const T* __restrict__ g, float* __restrict__ part,
                 long per) {
  const Conv& s = p.s;
  const int c = blockIdx.x * NT + threadIdx.x;
  if (c >= s.C) return;
  const long rows = static_cast<long>(s.B) * s.T;
  const long r0 = blockIdx.y * per;
  const long r1 = r0 + per < rows ? r0 + per : rows;
  float acc[KMAX + 1] = {};
  for (long r = r0; r < r1; ++r) {
    const int t = static_cast<int>(r % s.T), b = static_cast<int>(r / s.T);
    const float da = dpre(p, w, bias, g, b, t, c);
    for (int i = 0; i < s.K; ++i) acc[i] = fmaf(da, p.at(b, t + i, c), acc[i]);
    acc[KMAX] += da;
  }
  float* out = part + static_cast<long>(blockIdx.y) * (s.K + 1) * s.C;
  for (int i = 0; i < s.K; ++i) out[static_cast<long>(i) * s.C + c] = acc[i];
  out[static_cast<long>(s.K) * s.C + c] = acc[KMAX];
}

// dw[i][c], dbias[c]: the partials summed over the row blocks in order
template <typename T>
__global__ void __launch_bounds__(NT)
conv_sums_kernel(const float* __restrict__ part, T* __restrict__ dw,
                 T* __restrict__ dbias, int nparts, int C, int K) {
  const long e = static_cast<long>(blockIdx.x) * NT + threadIdx.x;
  if (e >= static_cast<long>(K + 1) * C) return;
  float s = 0.0f;
  for (int rb = 0; rb < nparts; ++rb)
    s += part[static_cast<long>(rb) * (K + 1) * C + e];
  if (e < static_cast<long>(K) * C)
    dw[e] = from_f32<T>(s);
  else
    dbias[e - static_cast<long>(K) * C] = from_f32<T>(s);
}

unsigned blocks(long n) { return static_cast<unsigned>((n + NT - 1) / NT); }

template <typename T>
int fwd(const Conv& s, const void* x, const void* win, const void* w,
        const void* bias, void* out, cudaStream_t st) {
  const Pad<T> p{static_cast<const T*>(x), static_cast<const T*>(win), s};
  conv_fwd_kernel<T><<<blocks(static_cast<long>(s.B) * s.T * s.C), NT, 0,
                       st>>>(p, static_cast<const T*>(w),
                             static_cast<const T*>(bias), static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd(const Conv& s, const void* x, const void* win, const void* w,
        const void* bias, const void* g, void* dx, void* dwin, void* dw,
        void* dbias, float* part, cudaStream_t st) {
  const Pad<T> p{static_cast<const T*>(x), static_cast<const T*>(win), s};
  const T* wt = static_cast<const T*>(w);
  const T* bt = static_cast<const T*>(bias);
  const T* gt = static_cast<const T*>(g);
  const long J = s.T + s.K - 1;
  conv_dx_kernel<T><<<blocks(s.B * J * s.C), NT, 0, st>>>(
      p, wt, bt, gt, static_cast<T*>(dx), static_cast<T*>(dwin));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long rows = static_cast<long>(s.B) * s.T;
  const long per = rows_per_part(rows);
  const int nparts = static_cast<int>((rows + per - 1) / per);
  conv_part_kernel<T><<<dim3((s.C + NT - 1) / NT, nparts), NT, 0, st>>>(
      p, wt, bt, gt, part, per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  conv_sums_kernel<T><<<blocks(static_cast<long>(s.K + 1) * s.C), NT, 0,
                        st>>>(part, static_cast<T*>(dw),
                              static_cast<T*>(dbias), nparts, s.C, s.K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The largest kernel width K the kernels take.
extern "C" int causal_conv_max_k() { return KMAX; }

// The rows of the backward's partial-sum scratch ((rows, K + 1, C) fp32)
// for B T rows.
extern "C" int causal_conv_bwd_parts(long rows) {
  if (rows <= 0) return 0;
  const long per = rows_per_part(rows);
  return static_cast<int>((rows + per - 1) / per);
}

// xbc (B, T, C) at row stride sx, window (B, K - 1, C) or null, w (K, C),
// bias (C), out (B, T, C), all of type bf16 ? bf16 : fp32.
extern "C" int causal_conv_fwd(const void* x, const void* win, const void* w,
                               const void* bias, void* out, int B, int T,
                               int C, int K, long sx, int bf16,
                               void* stream) {
  if (B <= 0 || T <= 0 || C <= 0) return 0;
  if (K < 1 || K > KMAX) return static_cast<int>(cudaErrorInvalidValue);
  const Conv s{B, T, C, K, sx};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? fwd<__nv_bfloat16>(s, x, win, w, bias, out, st)
              : fwd<float>(s, x, win, w, bias, out, st);
}

// g, dx (B, T, C); dwin (B, K - 1, C) or null; dw (K, C), dbias (C), all of
// the input's type; part causal_conv_bwd_parts(B T) x (K + 1) x C fp32.
extern "C" int causal_conv_bwd(const void* x, const void* win, const void* w,
                               const void* bias, const void* g, void* dx,
                               void* dwin, void* dw, void* dbias, float* part,
                               int B, int T, int C, int K, long sx, int bf16,
                               void* stream) {
  if (B <= 0 || T <= 0 || C <= 0) return 0;
  if (K < 1 || K > KMAX) return static_cast<int>(cudaErrorInvalidValue);
  const Conv s{B, T, C, K, sx};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? bwd<__nv_bfloat16>(s, x, win, w, bias, g, dx, dwin, dw, dbias,
                                   part, st)
              : bwd<float>(s, x, win, w, bias, g, dx, dwin, dw, dbias, part,
                           st);
}
