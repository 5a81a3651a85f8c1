// Kernel 4: blocked causal GQA flash attention, forward (online softmax).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (Pallas: grid (B*H, q blocks, kv blocks), the running max,
// denominator and accumulator in VMEM scratch carried across the sequential
// kv axis, kv blocks outside the causal range or the window skipped with
// pl.when).  On Hopper blocks run in parallel and carry nothing between
// them, so the kv axis is a loop inside the block: one block per (batch *
// head, BQ-row query tile) walks the kv tiles of its causal/window range
// only, with the fp32 accumulator in registers.  A warp owns BQ/8 query rows
// through every phase (scores, online softmax, p.V), so the row max and
// denominator live in its registers and the p tile it writes to shared
// memory is read back by the same warp.  GQA reads K/V of head h / (H/G)
// directly: K/V are never repeated.
//
// Layouts are the model's: q, out (B, Sq, H, D) and k, v (B, Sk, G, D),
// contiguous.  Beyond the TPU kernel it writes lse = m + log(l), fp32,
// (B, H, Sq) == (B, G, H/G, Sq), which the backward
// (models/attention.py::_chunked_bwd) recomputes p from.
//
// Numerics follow the plain forward it replaces on the model path
// (models/attention.py::_chunked_fwd): q * scale rounded to the input type,
// scores, softcap (cap * tanh(s / cap)) and softmax in fp32, p rounded to
// the input type before p.V, fp32 accumulation; products are fp32 FMA on
// the CUDA cores (no TF32).  Keys a row may not see get p = 0; a row that
// sees no key (only when Sq > Sk) gives 0, never NaN: l is clamped at 1e-30
// and lse is then about NEG_INF.  Ragged Sq and Sk edges are masked (the TPU
// kernel asserts that its blocks divide them).
//
// Bound: at gemma2-2b's training shape (B*H = 16, S = 4096, D = 256,
// causal) one call does ~137 GFLOP of products against ~0.1 GB of bytes, so
// it is bound by operations.  This first version runs the products from
// shared memory on the CUDA cores; the tensor cores (wgmma, TMA tiles) are
// later work.  Shared memory: q tile BQ x (D+1), K tile BK x (D+1), V tile
// BK x D and p tile BQ x (BK+1) floats — 137 KB at D = 256, above the 48 KB
// static limit, so the launch raises the dynamic limit first.
#include "common.cuh"

using repro::from_f32;
using repro::to_f32;

namespace {

constexpr int BQ = 64;           // query rows per block
constexpr int BK = 32;           // keys per kv tile: one per lane
constexpr int NT = 256;          // 8 warps
constexpr int RPW = BQ / (NT / 32);  // query rows per warp
constexpr float NEG_INF = -1e30f;

size_t smem_bytes(int D) {
  return sizeof(float) * (static_cast<size_t>(BQ) * (D + 1) +
                          static_cast<size_t>(BK) * (D + 1) +
                          static_cast<size_t>(BK) * D +
                          static_cast<size_t>(BQ) * (BK + 1));
}

// DC = ceil(D / 32): output columns per lane (lane, lane + 32, ...).
template <typename T, int DC>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int Sq, int Sk, int H, int G, int D,
                 float scale, int causal, int window, float cap) {
  extern __shared__ float smem[];
  const int LD = D + 1;  // odd row stride: lanes reading down a column of
                         // the K tile hit distinct banks
  float* qs = smem;                // BQ x LD
  float* ks = qs + BQ * LD;        // BK x LD
  float* vs = ks + BK * LD;        // BK x D
  float* ps = vs + BK * D;         // BQ x (BK + 1)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.y;       // b * H + h
  const int b = bh / H, h = bh % H;
  const int g = h / (H / G);
  const int q0 = blockIdx.x * BQ;
  const int nq = min(BQ, Sq - q0);
  const int q_off = Sk - Sq;       // queries sit at the end of the keys
  const long qstride = static_cast<long>(H) * D;
  const long kstride = static_cast<long>(G) * D;
  const T* qb = q + (static_cast<long>(b) * Sq * H + h) * D;
  const T* kb = k + (static_cast<long>(b) * Sk * G + g) * D;
  const T* vb = v + (static_cast<long>(b) * Sk * G + g) * D;

  for (int e = tid; e < BQ * D; e += NT) {
    const int i = e / D, d = e % D;
    float val = 0.0f;
    if (i < nq)  // q * scale in the input type, as the plain forward
      val = to_f32(from_f32<T>(to_f32(qb[(q0 + i) * qstride + d]) * scale));
    qs[i * LD + d] = val;
  }

  // the kv tiles any row of this block can see (the TPU kernel's skip)
  const int q_first = q0 + q_off, q_last = q0 + nq - 1 + q_off;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  const int t_begin = k_begin / BK;
  const int t_end = k_end > 0 ? (k_end + BK - 1) / BK : 0;

  float acc[RPW][DC];
  float m[RPW], l[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.0f;
  }
  const int row0 = warp * RPW;  // this warp's rows of the tile

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // previous tile fully consumed (and q tile written)
    for (int e = tid; e < BK * D; e += NT) {
      const int j = e / D, d = e % D;
      float kv = 0.0f, vv = 0.0f;
      if (k0 + j < Sk) {
        kv = to_f32(kb[(k0 + j) * kstride + d]);
        vv = to_f32(vb[(k0 + j) * kstride + d]);
      }
      ks[j * LD + d] = kv;
      vs[j * D + d] = vv;
    }
    __syncthreads();

    // scores of this warp's rows against key k0 + lane
    float s[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) s[r] = 0.0f;
    const float* kr = ks + lane * LD;
    for (int d = 0; d < D; ++d) {
      const float kd = kr[d];
#pragma unroll
      for (int r = 0; r < RPW; ++r)
        s[r] = fmaf(qs[(row0 + r) * LD + d], kd, s[r]);
    }

    // online softmax, one row at a time across the warp
    const int kp = k0 + lane;
    float corr[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int qp = q0 + row0 + r + q_off;
      bool valid = (row0 + r < nq) && (kp < Sk);
      if (causal) valid = valid && kp <= qp;
      if (window > 0) valid = valid && (qp - kp < window);
      float sv = s[r];
      if (cap > 0.0f) sv = cap * tanhf(sv / cap);
      const float m_new = fmaxf(m[r], repro::warp_max(valid ? sv : NEG_INF));
      const float p = valid ? expf(sv - m_new) : 0.0f;
      corr[r] = expf(m[r] - m_new);
      l[r] = l[r] * corr[r] + repro::warp_sum(p);
      m[r] = m_new;
      ps[(row0 + r) * (BK + 1) + lane] = to_f32(from_f32<T>(p));
    }
    __syncwarp();

    // acc = acc * corr + p . V over this tile's keys
#pragma unroll
    for (int r = 0; r < RPW; ++r)
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[r][c] *= corr[r];
    const int jmax = min(BK, Sk - k0);
    for (int j = 0; j < jmax; ++j) {
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = lane + 32 * c;
        vv[c] = d < D ? vs[j * D + d] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float p = ps[(row0 + r) * (BK + 1) + j];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[r][c] = fmaf(p, vv[c], acc[r][c]);
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int i = row0 + r;
    if (i >= nq) continue;
    const float lc = fmaxf(l[r], 1e-30f);
    T* orow = out + ((static_cast<long>(b) * Sq + q0 + i) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) orow[d] = from_f32<T>(acc[r][c] / lc);
    }
    if (lane == 0) lse[static_cast<long>(bh) * Sq + q0 + i] = m[r] + logf(lc);
  }
}

template <typename T, int DC>
int launch_dc(const void* q, const void* k, const void* v, void* out,
              float* lse, int B, int Sq, int Sk, int H, int G, int D,
              float scale, int causal, int window, float cap, void* stream) {
  auto kern = flash_fwd_kernel<T, DC>;
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kern),
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kern<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, Sq, Sk, H, G, D,
      scale, causal, window, cap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int B, int Sq, int Sk, int H, int G, int D, float scale,
           int causal, int window, float cap, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return 0;
  if (D <= 0 || D > 256 || G <= 0 || H % G != 0 || Sk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int dc = (D + 31) / 32;
  if (dc == 1)
    return launch_dc<T, 1>(q, k, v, out, lse, B, Sq, Sk, H, G, D, scale,
                           causal, window, cap, stream);
  if (dc == 2)
    return launch_dc<T, 2>(q, k, v, out, lse, B, Sq, Sk, H, G, D, scale,
                           causal, window, cap, stream);
  if (dc <= 4)
    return launch_dc<T, 4>(q, k, v, out, lse, B, Sq, Sk, H, G, D, scale,
                           causal, window, cap, stream);
  return launch_dc<T, 8>(q, k, v, out, lse, B, Sq, Sk, H, G, D, scale,
                         causal, window, cap, stream);
}

}  // namespace

// window <= 0: no sliding window; cap <= 0: no softcap.
extern "C" int flash_attention_fwd_f32(const void* q, const void* k,
                                       const void* v, void* out, float* lse,
                                       int B, int Sq, int Sk, int H, int G,
                                       int D, float scale, int causal,
                                       int window, float cap, void* stream) {
  return launch<float>(q, k, v, out, lse, B, Sq, Sk, H, G, D, scale, causal,
                       window, cap, stream);
}

extern "C" int flash_attention_fwd_bf16(const void* q, const void* k,
                                        const void* v, void* out, float* lse,
                                        int B, int Sq, int Sk, int H, int G,
                                        int D, float scale, int causal,
                                        int window, float cap, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, lse, B, Sq, Sk, H, G, D, scale,
                               causal, window, cap, stream);
}
