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
// The outputs and the cotangent lie in up to three column pieces (a Cols:
// each piece its own base and row stride), so the forward writes x, B and
// C into the separate buffers the SSD reads, the backward reads their
// cotangents from those (the x piece's cotangent the sum of the SSD's and
// the gated norm's, g = round(g_ssd + g_skip) as autograd adds them) and
// writes dxbc into its columns of the input projection's cotangent
// buffer; xbc itself is read through a row stride (its columns of the
// input projection's output).
//
// Bound: bytes.  At mamba2-370m's layer (B = 4, T = 4096, 2304 channels,
// K = 4, bf16) the forward reads xbc and writes out: 151 MB, 45 us at
// 3.35 TB/s; the backward reads g and xbc and writes dxbc: 226 MB, 68 us.
// Design: a thread an output element, channels fastest (coalesced); the
// backward recomputes a and da where it needs them (K + 1 multiply-adds and
// an exp each) rather than writing them out.
#include <type_traits>

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
  long sx;   // xbc's row stride
};

// A (B T, C) operand in up to three column pieces: columns [0, c1) at p0,
// [c1, c2) at p1, [c2, C) at p2, each row-major with its own row stride;
// add (nullable) a second operand laid out as piece 0, summed into it on
// reading (round(p0 + add) in T).  The pieces are picked by selects, not
// by indexing an array (which would put the struct in local memory).
template <typename T>
struct Cols {
  T *p0, *p1, *p2;
  long ld0, ld1, ld2;
  int c1, c2;
  const T* add;
  // the element's offset in its piece, and which piece
  __device__ __forceinline__ long at(long row, int c, int* k) const {
    *k = c < c1 ? 0 : c < c2 ? 1 : 2;
    return *k == 0 ? row * ld0 + c
                   : *k == 1 ? row * ld1 + (c - c1) : row * ld2 + (c - c2);
  }
  __device__ __forceinline__ T* base(int k) const {
    return k == 0 ? p0 : k == 1 ? p1 : p2;
  }
  __device__ __forceinline__ float get(long row, int c) const {
    int k;
    const long i = at(row, c, &k);
    const float v = to_f32(base(k)[i]);
    if (k == 0 && add)
      return to_f32(from_f32<std::remove_const_t<T>>(v + to_f32(add[i])));
    return v;
  }
  __device__ __forceinline__ void put(long row, int c, float v) const {
    int k;
    const long i = at(row, c, &k);
    base(k)[i] = from_f32<T>(v);
  }
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
                                      const T* bias, Cols<const T> g,
                                      int b, int t, int c) {
  const float a = preact(p, w, bias, b, t, c);
  const float sg = 1.0f / (1.0f + expf(-a));
  const float gv = g.get(static_cast<long>(b) * p.s.T + t, c);
  return to_f32(from_f32<T>(gv * (sg * (1.0f + a * (1.0f - sg)))));
}

template <typename T>
__global__ void __launch_bounds__(NT)
conv_fwd_kernel(Pad<T> p, const T* __restrict__ w, const T* __restrict__ bias,
                Cols<T> out) {
  const long e = static_cast<long>(blockIdx.x) * NT + threadIdx.x;
  const Conv& s = p.s;
  if (e >= static_cast<long>(s.B) * s.T * s.C) return;
  const int c = static_cast<int>(e % s.C);
  const long bt = e / s.C;
  const int t = static_cast<int>(bt % s.T), b = static_cast<int>(bt / s.T);
  const float a = preact(p, w, bias, b, t, c);
  out.put(bt, c, a / (1.0f + expf(-a)));
}

// dpad over j in [0, T + K - 1): a thread an element of dxbc (j >= K - 1)
// or of dwindow (j < K - 1, when it is asked for)
template <typename T>
__global__ void __launch_bounds__(NT)
conv_dx_kernel(Pad<T> p, const T* __restrict__ w, const T* __restrict__ bias,
               Cols<const T> g, T* __restrict__ dx, long sdx,
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
    dx[(static_cast<long>(b) * s.T + j - (s.K - 1)) * sdx + c] =
        from_f32<T>(acc);
  else
    dwin[(static_cast<long>(b) * (s.K - 1) + j) * s.C + c] = from_f32<T>(acc);
}

// part[rb][i][c] (i < K: the weight's, i = K: the bias's) over the rows
// [rb per, (rb + 1) per) of the (B T) axis, in order
template <typename T>
__global__ void __launch_bounds__(NT)
conv_part_kernel(Pad<T> p, const T* __restrict__ w, const T* __restrict__ bias,
                 Cols<const T> g, float* __restrict__ part, long per) {
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

template <typename T, typename V>
Cols<T> cols(V* const* p, const long* ld, int c1, int c2, const void* add) {
  return Cols<T>{static_cast<T*>(p[0]), static_cast<T*>(p[1]),
                 static_cast<T*>(p[2]), ld[0], ld[1], ld[2], c1, c2,
                 static_cast<const T*>(add)};
}

template <typename T>
int fwd(const Conv& s, const void* x, const void* win, const void* w,
        const void* bias, void* const* out, const long* ld, int c1, int c2,
        cudaStream_t st) {
  const Pad<T> p{static_cast<const T*>(x), static_cast<const T*>(win), s};
  const Cols<T> o = cols<T>(out, ld, c1, c2, nullptr);
  conv_fwd_kernel<T><<<blocks(static_cast<long>(s.B) * s.T * s.C), NT, 0,
                       st>>>(p, static_cast<const T*>(w),
                             static_cast<const T*>(bias), o);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd(const Conv& s, const void* x, const void* win, const void* w,
        const void* bias, const void* const* g, const long* ld, int c1,
        int c2, const void* gadd, void* dx, long sdx, void* dwin, void* dw,
        void* dbias, float* part, cudaStream_t st) {
  const Pad<T> p{static_cast<const T*>(x), static_cast<const T*>(win), s};
  const T* wt = static_cast<const T*>(w);
  const T* bt = static_cast<const T*>(bias);
  const Cols<const T> gt = cols<const T>(g, ld, c1, c2, gadd);
  const long J = s.T + s.K - 1;
  conv_dx_kernel<T><<<blocks(s.B * J * s.C), NT, 0, st>>>(
      p, wt, bt, gt, static_cast<T*>(dx), sdx, static_cast<T*>(dwin));
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

namespace {
bool pieces_ok(int C, int c1, int c2, const void* const* p) {
  return 0 < c1 && c1 <= c2 && c2 <= C && p[0] != nullptr &&
         (c2 == c1 || p[1] != nullptr) && (c2 == C || p[2] != nullptr);
}
}  // namespace

// xbc (B, T, C) at row stride sx, window (B, K - 1, C) or null, w (K, C),
// bias (C); out in three column pieces (out0 [0, c1), out1 [c1, c2), out2
// [c2, C), each (B T) rows at row strides ld0, ld1, ld2; one piece: c1 = c2
// = C, out1 and out2 null), all of type bf16 ? bf16 : fp32.
extern "C" int causal_conv_fwd(const void* x, const void* win, const void* w,
                               const void* bias, void* out0, void* out1,
                               void* out2, long ld0, long ld1, long ld2,
                               int c1, int c2, int B, int T, int C, int K,
                               long sx, int bf16, void* stream) {
  if (B <= 0 || T <= 0 || C <= 0) return 0;
  void* const out[3] = {out0, out1, out2};
  const long ld[3] = {ld0, ld1, ld2};
  if (K < 1 || K > KMAX || !pieces_ok(C, c1, c2, out))
    return static_cast<int>(cudaErrorInvalidValue);
  const Conv s{B, T, C, K, sx};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? fwd<__nv_bfloat16>(s, x, win, w, bias, out, ld, c1, c2, st)
              : fwd<float>(s, x, win, w, bias, out, ld, c1, c2, st);
}

// g in three column pieces as causal_conv_fwd's out (g0 [0, c1) plus gadd,
// laid out as g0, where gadd is not null), dx (B, T, C) at row stride sdx;
// dwin (B, K - 1, C) or null; dw (K, C), dbias (C), all of the input's
// type; part causal_conv_bwd_parts(B T) x (K + 1) x C fp32.
extern "C" int causal_conv_bwd(const void* x, const void* win, const void* w,
                               const void* bias, const void* g0,
                               const void* g1, const void* g2, long ld0,
                               long ld1, long ld2, int c1, int c2,
                               const void* gadd, void* dx, long sdx,
                               void* dwin, void* dw, void* dbias, float* part,
                               int B, int T, int C, int K, long sx, int bf16,
                               void* stream) {
  if (B <= 0 || T <= 0 || C <= 0) return 0;
  const void* const g[3] = {g0, g1, g2};
  const long ld[3] = {ld0, ld1, ld2};
  if (K < 1 || K > KMAX || !pieces_ok(C, c1, c2, g))
    return static_cast<int>(cudaErrorInvalidValue);
  const Conv s{B, T, C, K, sx};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? bwd<__nv_bfloat16>(s, x, win, w, bias, g, ld, c1, c2, gadd,
                                   dx, sdx, dwin, dw, dbias, part, st)
              : bwd<float>(s, x, win, w, bias, g, ld, c1, c2, gadd, dx, sdx,
                           dwin, dw, dbias, part, st);
}
