// Kernel 4b: blocked causal GQA flash attention, backward (dq, dk, dv).
//
// Replaces the arithmetic the TPU kernels src/repro/kernels/segment_pallas.py
// ::fused_advance_segment / ::fused_reverse_segment run for a decoder body:
// there the caller's body is traced into the pallas_call (the chunk vjp at
// :395-409), and for attention that body is the custom VJP of
// src/repro/models/attention.py::chunked_attention (its backward
// _chunked_bwd, :118).  The port's plain version is
// src/repro_torch/models/attention.py::_chunked_bwd, and this kernel computes
// what it computes:
//
//   Dv = rowsum(dO . O)                         fp32
//   s  = (q * scale rounded to the input type) . k, fp32; with a softcap
//        t = tanh(s / cap), s = cap t and ds picks up 1 - t^2
//   p  = exp(s - lse)  (lse saved by the forward), 0 where masked
//   dV = sum_rows p(rounded) . dO, dP = dO . V^T, dS = p (dP - Dv) (1 - t^2)
//   dQ = scale * sum_keys dS(rounded) . K, dK = sum_rows dS(rounded) . q*scale
//
// with the causal mask (queries at the end of the keys), the sliding window
// and GQA (dK and dV summed over the H/G query heads of a group).  p and dS
// are rounded to the input type before their products, as the plain version
// does; sums are fp32 in another order.  Rows that see no key (only when
// Sq > Sk, causal) get p = 0: the plain version's p there is exp(0) for the
// masked keys (its lse is about NEG_INF), which adds their dO to dV; the
// kernel does not (ROADMAP queue 3's "Deliberate differences" records
// the difference).
//
// Two launches, no atomics, so two calls give the same bits: a dQ launch (one
// block per query tile: it walks the kv tiles its rows can see, recomputing
// p, and writes Dv for the second launch), then a dK/dV launch (one block per
// (batch, kv head, kv tile): it walks the query tiles of every head of its
// group that can see its keys and keeps dK and dV on chip).  FlashAttention-2
// and -3 instead accumulate dQ with float atomics from the dK/dV walk, which
// is not deterministic; the split recomputes s and dP once more (seven
// products of the tile where five are needed).  A single pass with a
// fixed-order dQ sum behind a per-query-tile turn counter would need every
// kv tile's block of a query tile resident in turn; the two launches need
// no such order.  Tiles the causal mask or the window rule out entirely are
// never visited.
//
// Bound: at gemma2-2b's layer (B=2, S=4096, 8 heads of 256, causal) the five
// products of the backward are ~343 GFLOP against ~0.2 GB of bytes: bound by
// the bf16 tensor cores (0.35 ms at 989 TFLOP/s).
//
// bf16 at D in {64, 128, 256} (the Hopper form): both launches are
// warp-specialised, warpgroup 0's first thread issuing TMA loads (4D tensor
// maps over (B, S, heads, D): a head's rows at stride heads x D, 64-column
// boxes in the 128-byte swizzle) into a ring of stages behind mbarriers,
// warpgroups 1 and 2 consuming with wgmma (fp32 accumulators; every operand
// that lies MN-major is read through the transpose bit).
//   dQ (bwd_dq_wgmma_kernel): 128 query rows a block, 64 a consumer; Q and
//   dO land once (each consumer rounds q * scale in place for its rows and
//   computes its rows' Dv and lse), K and V tiles of 64 keys (32 at D =
//   256) stream through the ring; S = Q K^T and dP = dO V^T from shared
//   memory, p and dS on the accumulators, dQ += dS K with dS as the
//   register A operand and K read MN-major.
//   dK/dV (bwd_dkdv_wgmma_kernel): query tiles of 64 rows stream through the
//   ring; warpgroup 0's warps 1-3 prepare each landed stage (q * scale
//   rounded in place, the rows' lse and Dv into shared memory) so the
//   consumers do neither.  D <= 128: 128 keys a block, a consumer owns 64
//   keys with all D columns of dK and dV, computes S^T = K Q^T and dP^T = V
//   dO^T for them and keeps p^T and dS^T in its registers as the A operand
//   of dV += p^T dO and dK += dS^T Q.  D = 256 (dK and dV of 64 x 256 fp32
//   would be 256 registers a thread): 64 keys a block, each consumer
//   computes S^T, dP^T for half the rows, both write p^T and dS^T (bf16,
//   swizzled, double-buffered) to shared memory, and each owns 128 columns
//   of dK and dV.
// bf16 at D in {16, 32} (the SMOKE configs' widths, under one 128-byte row)
// keeps the Ampere form: mma.sync m16n8k16 with fp32 accumulation, tiles
// bf16 in shared memory with rows padded by 16 bytes (ldmatrix rows in
// distinct banks), 16-byte cp.async loads double-buffered.
//   dQ launch: 4 warps, 64 query rows (16 a warp, as the forward); S = Q K^T
//   and dP = dO V^T per kv tile of 64 keys, p and dS on the accumulator
//   fragments in registers, dS (bf16) reused as the A fragment of dS . K (K
//   through ldmatrix.trans), dQ in registers (16 x D fp32 a warp).
//   dK/dV launch: kv tiles of 64 keys, query tiles of 64 rows.  Phase A: the
//   warps share the (keys x rows) tile in 16 x 16 pieces and compute S^T =
//   K Q^T and dP^T = V dO^T, then p^T and dS^T, written bf16 to shared
//   memory.  Phase B: each warp owns 16 keys and all D columns of dK and
//   dV, dV += p^T dO and dK += dS^T Q with dO and Q through ldmatrix.trans.
//   The next query tile loads while this one computes.
// fp32 (any D <= 256) keeps to the CUDA cores (no TF32): the same two
// launches with fp32 FMA from shared memory, lanes owning keys (dQ) or rows
// (dK/dV) for the scores and columns for the accumulators.
#include "hopper.cuh"

using repro::from_f32;
using repro::to_f32;

namespace {

constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (B, H, Sq)
  float* dvec;       // (B, H, Sq): Dv, written by the dQ launch
  void* dq;
  void* dk;
  void* dv;
  int B, Sq, Sk, H, G, D;
  float scale;
  int causal, window;
  float cap;
};

__device__ __forceinline__ bool visible(int qp, int kp, int Sk, int causal,
                                        int window) {
  bool ok = kp < Sk;
  if (causal) ok = ok && kp <= qp;
  if (window > 0) ok = ok && qp - kp < window;
  return ok;
}

// the kv tiles [t_begin, t_end) of width bk that query rows [q0, q0 + nq)
// can see
__device__ __forceinline__ void kv_range(const Args& a, int q0, int nq,
                                         int bk, int* t_begin, int* t_end) {
  const int q_off = a.Sk - a.Sq;
  const int q_first = q0 + q_off, q_last = q0 + nq - 1 + q_off;
  const int k_end = a.causal ? min(a.Sk, q_last + 1) : a.Sk;
  const int k_begin = a.window > 0 ? max(0, q_first - a.window + 1) : 0;
  *t_begin = k_begin / bk;
  *t_end = k_end > 0 ? (k_end + bk - 1) / bk : 0;
  if (*t_end < *t_begin) *t_end = *t_begin;
}

// the query tiles [t_lo, t_hi) of height bq whose rows can see a key of
// [k0, k0 + nk)
__device__ __forceinline__ void q_range(const Args& a, int k0, int nk, int bq,
                                        int* t_lo, int* t_hi) {
  const int q_off = a.Sk - a.Sq;
  const int i_lo = a.causal ? max(0, k0 - q_off) : 0;
  const int i_hi =
      a.window > 0 ? min(a.Sq, k0 + nk - 1 + a.window - q_off) : a.Sq;
  *t_lo = i_lo / bq;
  *t_hi = i_hi > i_lo ? (i_hi + bq - 1) / bq : *t_lo;
}

// ------------------------------------------------------------ fp32 path

constexpr int F_BQ = 64;   // query rows per tile
constexpr int F_BK = 32;   // keys per tile
constexpr int F_NT = 256;  // 8 warps
constexpr int F_RPW = F_BQ / (F_NT / 32);  // dQ: rows per warp
constexpr int F_KPW = F_BK / (F_NT / 32);  // dK/dV: keys per warp

size_t f_dq_smem(int D) {
  const size_t LD = D + 1;
  return sizeof(float) * (2 * F_BQ * LD + 2 * F_BK * LD +
                          F_BQ * (F_BK + 1) + 2 * F_BQ);
}

size_t f_kv_smem(int D) {
  const size_t LD = D + 1;
  return sizeof(float) * (2 * static_cast<size_t>(F_BK) * D + 2 * F_BQ * LD +
                          2 * F_BK * (F_BQ + 1) + 2 * F_BQ);
}

// DC = ceil(D / 32): accumulator columns per lane (lane, lane + 32, ...)
template <int DC>
__global__ void __launch_bounds__(F_NT) bwd_dq_f32_kernel(Args a) {
  extern __shared__ float smem[];
  const int D = a.D, LD = D + 1;
  float* qs = smem;              // F_BQ x LD, q * scale
  float* dos = qs + F_BQ * LD;   // F_BQ x LD
  float* ks = dos + F_BQ * LD;   // F_BK x LD
  float* vs = ks + F_BK * LD;    // F_BK x LD
  float* ps = vs + F_BK * LD;    // F_BQ x (F_BK + 1): dS
  float* rl = ps + F_BQ * (F_BK + 1);  // lse per row
  float* rd = rl + F_BQ;               // Dv per row

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int g = h / (a.H / a.G);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * F_BQ;  // heaviest first
  const int nq = min(F_BQ, a.Sq - q0);
  const int q_off = a.Sk - a.Sq;
  const long qstride = static_cast<long>(a.H) * D;
  const long kstride = static_cast<long>(a.G) * D;
  const long qbase = (static_cast<long>(b) * a.Sq * a.H + h) * D;
  const long kbase = (static_cast<long>(b) * a.Sk * a.G + g) * D;
  const float* qb = static_cast<const float*>(a.q) + qbase;
  const float* ob = static_cast<const float*>(a.o) + qbase;
  const float* dob = static_cast<const float*>(a.dout) + qbase;
  const float* kb = static_cast<const float*>(a.k) + kbase;
  const float* vb = static_cast<const float*>(a.v) + kbase;

  for (int e = tid; e < F_BQ * D; e += F_NT) {
    const int i = e / D, d = e % D;
    const bool ok = i < nq;
    qs[i * LD + d] = ok ? qb[(q0 + i) * qstride + d] * a.scale : 0.0f;
    dos[i * LD + d] = ok ? dob[(q0 + i) * qstride + d] : 0.0f;
  }
  __syncthreads();
  const int row0 = warp * F_RPW;
  for (int r = 0; r < F_RPW; ++r) {
    const int i = row0 + r;
    float s = 0.0f;
    if (i < nq)
      for (int d = lane; d < D; d += 32)
        s = fmaf(dos[i * LD + d], ob[(q0 + i) * qstride + d], s);
    s = repro::warp_sum(s);
    if (lane == 0) {
      rd[i] = s;
      rl[i] = i < nq ? a.lse[static_cast<long>(bh) * a.Sq + q0 + i] : 0.0f;
      if (i < nq) a.dvec[static_cast<long>(bh) * a.Sq + q0 + i] = s;
    }
  }
  __syncwarp();

  int t_begin, t_end;
  kv_range(a, q0, nq, F_BK, &t_begin, &t_end);
  float acc[F_RPW][DC];
#pragma unroll
  for (int r = 0; r < F_RPW; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.0f;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * F_BK;
    __syncthreads();  // the previous tile is consumed
    for (int e = tid; e < F_BK * D; e += F_NT) {
      const int j = e / D, d = e % D;
      const bool ok = k0 + j < a.Sk;
      ks[j * LD + d] = ok ? kb[(k0 + j) * kstride + d] : 0.0f;
      vs[j * LD + d] = ok ? vb[(k0 + j) * kstride + d] : 0.0f;
    }
    __syncthreads();
    float s[F_RPW], dp[F_RPW];
#pragma unroll
    for (int r = 0; r < F_RPW; ++r) s[r] = dp[r] = 0.0f;
    const float* kr = ks + lane * LD;
    const float* vr = vs + lane * LD;
    for (int d = 0; d < D; ++d) {
      const float kd = kr[d], vd = vr[d];
#pragma unroll
      for (int r = 0; r < F_RPW; ++r) {
        s[r] = fmaf(qs[(row0 + r) * LD + d], kd, s[r]);
        dp[r] = fmaf(dos[(row0 + r) * LD + d], vd, dp[r]);
      }
    }
    const int kp = k0 + lane;
#pragma unroll
    for (int r = 0; r < F_RPW; ++r) {
      const int i = row0 + r;
      const bool valid =
          i < nq && visible(q0 + i + q_off, kp, a.Sk, a.causal, a.window);
      float sv = s[r], dcap = 1.0f;
      if (a.cap > 0.0f) {
        const float th = tanhf(sv / a.cap);
        sv = a.cap * th;
        dcap = 1.0f - th * th;
      }
      float ds = 0.0f;
      if (valid) {
        const float p = expf(sv - rl[i]);
        ds = p * (dp[r] - rd[i]) * dcap;
      }
      ps[i * (F_BK + 1) + lane] = ds;
    }
    __syncwarp();
    const int jmax = min(F_BK, a.Sk - k0);
    for (int j = 0; j < jmax; ++j) {
      float kv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = lane + 32 * c;
        kv[c] = d < D ? ks[j * LD + d] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < F_RPW; ++r) {
        const float w = ps[(row0 + r) * (F_BK + 1) + j];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[r][c] = fmaf(w, kv[c], acc[r][c]);
      }
    }
    __syncwarp();
  }

  float* dqb = static_cast<float*>(a.dq) + qbase;
#pragma unroll
  for (int r = 0; r < F_RPW; ++r) {
    const int i = row0 + r;
    if (i >= nq) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) dqb[(q0 + i) * qstride + d] = acc[r][c] * a.scale;
    }
  }
}

template <int DC>
__global__ void __launch_bounds__(F_NT) bwd_dkdv_f32_kernel(Args a) {
  extern __shared__ float smem[];
  const int D = a.D, LD = D + 1;
  float* ks = smem;               // F_BK x D (read broadcast)
  float* vs = ks + F_BK * D;      // F_BK x D
  float* qs = vs + F_BK * D;      // F_BQ x LD, q * scale
  float* dos = qs + F_BQ * LD;    // F_BQ x LD
  float* pT = dos + F_BQ * LD;    // F_BK x (F_BQ + 1)
  float* dsT = pT + F_BK * (F_BQ + 1);
  float* rl = dsT + F_BK * (F_BQ + 1);  // lse per row
  float* rd = rl + F_BQ;                // Dv per row

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bg = blockIdx.y, b = bg / a.G, g = bg % a.G;
  const int Hg = a.H / a.G;
  const int k0 = blockIdx.x * F_BK;
  const int nk = min(F_BK, a.Sk - k0);
  const int q_off = a.Sk - a.Sq;
  const long qstride = static_cast<long>(a.H) * D;
  const long kstride = static_cast<long>(a.G) * D;
  const long kbase = (static_cast<long>(b) * a.Sk * a.G + g) * D;
  const float* kb = static_cast<const float*>(a.k) + kbase;
  const float* vb = static_cast<const float*>(a.v) + kbase;

  for (int e = tid; e < F_BK * D; e += F_NT) {
    const int j = e / D, d = e % D;
    const bool ok = j < nk;
    ks[e] = ok ? kb[(k0 + j) * kstride + d] : 0.0f;
    vs[e] = ok ? vb[(k0 + j) * kstride + d] : 0.0f;
  }
  int t_lo, t_hi;
  q_range(a, k0, nk, F_BQ, &t_lo, &t_hi);
  const int nt = t_hi - t_lo;

  float dk[F_KPW][DC], dv[F_KPW][DC];
#pragma unroll
  for (int j = 0; j < F_KPW; ++j)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[j][c] = dv[j][c] = 0.0f;
  const int key0 = warp * F_KPW;  // this warp's keys of the tile

  for (int it = 0; it < Hg * nt; ++it) {
    const int h = g * Hg + it / nt;
    const int q0 = (t_lo + it % nt) * F_BQ;
    const int nq = min(F_BQ, a.Sq - q0);
    const long bh = static_cast<long>(b) * a.H + h;
    const long qbase = (static_cast<long>(b) * a.Sq * a.H + h) * D;
    const float* qb = static_cast<const float*>(a.q) + qbase;
    const float* dob = static_cast<const float*>(a.dout) + qbase;
    __syncthreads();  // the previous query tile is consumed
    for (int e = tid; e < F_BQ * D; e += F_NT) {
      const int i = e / D, d = e % D;
      const bool ok = i < nq;
      qs[i * LD + d] = ok ? qb[(q0 + i) * qstride + d] * a.scale : 0.0f;
      dos[i * LD + d] = ok ? dob[(q0 + i) * qstride + d] : 0.0f;
    }
    for (int i = tid; i < F_BQ; i += F_NT) {
      rl[i] = i < nq ? a.lse[bh * a.Sq + q0 + i] : 0.0f;
      rd[i] = i < nq ? a.dvec[bh * a.Sq + q0 + i] : 0.0f;
    }
    __syncthreads();
    // scores and dP of this warp's keys against rows lane and lane + 32
#pragma unroll
    for (int j = 0; j < F_KPW; ++j) {
      const float* kr = ks + (key0 + j) * D;
      const float* vr = vs + (key0 + j) * D;
      float s[2] = {0.0f, 0.0f}, dp[2] = {0.0f, 0.0f};
      for (int d = 0; d < D; ++d) {
        const float kd = kr[d], vd = vr[d];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          s[x] = fmaf(kd, qs[(lane + 32 * x) * LD + d], s[x]);
          dp[x] = fmaf(vd, dos[(lane + 32 * x) * LD + d], dp[x]);
        }
      }
      const int kp = k0 + key0 + j;
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int i = lane + 32 * x;
        const bool valid = i < nq && key0 + j < nk &&
                           visible(q0 + i + q_off, kp, a.Sk, a.causal,
                                   a.window);
        float sv = s[x], dcap = 1.0f;
        if (a.cap > 0.0f) {
          const float th = tanhf(sv / a.cap);
          sv = a.cap * th;
          dcap = 1.0f - th * th;
        }
        float p = 0.0f, ds = 0.0f;
        if (valid) {
          p = expf(sv - rl[i]);
          ds = p * (dp[x] - rd[i]) * dcap;
        }
        pT[(key0 + j) * (F_BQ + 1) + i] = p;
        dsT[(key0 + j) * (F_BQ + 1) + i] = ds;
      }
    }
    __syncwarp();
    for (int i = 0; i < nq; ++i) {
      float dov[DC], qv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = lane + 32 * c;
        dov[c] = d < D ? dos[i * LD + d] : 0.0f;
        qv[c] = d < D ? qs[i * LD + d] : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < F_KPW; ++j) {
        const float p = pT[(key0 + j) * (F_BQ + 1) + i];
        const float ds = dsT[(key0 + j) * (F_BQ + 1) + i];
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          dv[j][c] = fmaf(p, dov[c], dv[j][c]);
          dk[j][c] = fmaf(ds, qv[c], dk[j][c]);
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < F_KPW; ++j) {
    const int kj = key0 + j;
    if (kj >= nk) continue;
    float* dkr = static_cast<float*>(a.dk) + kbase + (k0 + kj) * kstride;
    float* dvr = static_cast<float*>(a.dv) + kbase + (k0 + kj) * kstride;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) {
        dkr[d] = dk[j][c];
        dvr[d] = dv[j][c];
      }
    }
  }
}

template <int DC>
int launch_f32_dc(const Args& a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  {
    auto kern = bwd_dq_f32_kernel<DC>;
    const size_t smem = f_dq_smem(a.D);
    cudaError_t err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(kern),
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((a.Sq + F_BQ - 1) / F_BQ, a.B * a.H);
    kern<<<grid, F_NT, smem, st>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (a.Sk > 0) {
    auto kern = bwd_dkdv_f32_kernel<DC>;
    const size_t smem = f_kv_smem(a.D);
    cudaError_t err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(kern),
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((a.Sk + F_BK - 1) / F_BK, a.B * a.G);
    kern<<<grid, F_NT, smem, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const Args& a, void* stream) {
  const int dc = (a.D + 31) / 32;
  if (dc == 1) return launch_f32_dc<1>(a, stream);
  if (dc == 2) return launch_f32_dc<2>(a, stream);
  if (dc <= 4) return launch_f32_dc<4>(a, stream);
  return launch_f32_dc<8>(a, stream);
}

// ------------------------------------------------ bf16, tensor cores

using bf16 = __nv_bfloat16;

// rows [0, n) of a (rows x D) bf16 tile from global rows of stride `stride`
// elements by NT threads; rows [valid, n) are zero-filled.
template <int D, int LDS, int NT>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long stride, int valid, int n) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  for (int e = threadIdx.x; e < n * CPR; e += NT) {
    const int r = e / CPR, c = e % CPR;
    const bool ok = r < valid;
    repro::cp_async16(dst + r * LDS + c * 8,
                      ok ? src + r * stride + c * 8 : src, ok ? 16 : 0);
  }
}

// p and dS of one score from its raw fp32 value s and dP
__device__ __forceinline__ void p_ds(float s, float dp, float lse2, float dv,
                                     float cap, float inv_cap, bool valid,
                                     float* p, float* ds) {
  float dcap = 1.0f;
  if (cap > 0.0f) {
    const float th = tanhf(s * inv_cap);
    s = cap * th;
    dcap = 1.0f - th * th;
  }
  *p = valid ? exp2f(fmaf(s, LOG2E, -lse2)) : 0.0f;
  *ds = valid ? *p * (dp - dv) * dcap : 0.0f;
}

constexpr int DQ_BQ = 64;   // query rows per block (16 a warp)
constexpr int DQ_NT = 128;  // 4 warps

template <int D>
struct DqShape {
  static constexpr int BK = 64;                  // keys per kv tile
  static constexpr int LDS = D + 8;              // +16 bytes a row
  static constexpr size_t smem =
      sizeof(bf16) * static_cast<size_t>(2 * DQ_BQ + 4 * BK) * LDS +
      sizeof(float) * 2 * DQ_BQ;
};

template <int D>
__global__ void __launch_bounds__(DQ_NT) bwd_dq_bf16_kernel(Args a) {
  using S = DqShape<D>;
  constexpr int BK = S::BK, LDS = S::LDS;
  constexpr int NS = BK / 8;  // score n-tiles per kv tile
  constexpr int NO = D / 8;   // dQ n-tiles
  extern __shared__ float smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // DQ_BQ x LDS, q * scale
  bf16* dos = qs + DQ_BQ * LDS;              // DQ_BQ x LDS
  bf16* kbuf = dos + DQ_BQ * LDS;            // 2 x BK x LDS
  bf16* vbuf = kbuf + 2 * BK * LDS;          // 2 x BK x LDS
  float* rl = reinterpret_cast<float*>(vbuf + 2 * BK * LDS);  // lse * log2 e
  float* rd = rl + DQ_BQ;                                     // Dv

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int grp = h / (a.H / a.G);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * DQ_BQ;  // heaviest first
  const int nq = min(DQ_BQ, a.Sq - q0);
  const int q_off = a.Sk - a.Sq;
  const long qstride = static_cast<long>(a.H) * D;
  const long kstride = static_cast<long>(a.G) * D;
  const long qbase = (static_cast<long>(b) * a.Sq * a.H + h) * D;
  const long kbase = (static_cast<long>(b) * a.Sk * a.G + grp) * D;
  const bf16* qb = static_cast<const bf16*>(a.q) + qbase;
  const bf16* ob = static_cast<const bf16*>(a.o) + qbase;
  const bf16* dob = static_cast<const bf16*>(a.dout) + qbase;
  const bf16* kb = static_cast<const bf16*>(a.k) + kbase;
  const bf16* vb = static_cast<const bf16*>(a.v) + kbase;

  int t_begin, t_end;
  kv_range(a, q0, nq, BK, &t_begin, &t_end);
  load_rows<D, LDS, DQ_NT>(qs, qb + q0 * qstride, qstride, nq, DQ_BQ);
  load_rows<D, LDS, DQ_NT>(dos, dob + q0 * qstride, qstride, nq, DQ_BQ);
  if (t_begin < t_end) {
    const int k0 = t_begin * BK;
    load_rows<D, LDS, DQ_NT>(kbuf, kb + k0 * kstride, kstride, a.Sk - k0,
                             BK);
    load_rows<D, LDS, DQ_NT>(vbuf, vb + k0 * kstride, kstride, a.Sk - k0,
                             BK);
  }
  repro::cp_async_commit();
  repro::cp_async_wait<0>();
  __syncthreads();
  // q * scale in the input type, as the plain version's _layout
  for (int e = tid; e < DQ_BQ * D; e += DQ_NT) {
    bf16* p = qs + (e / D) * LDS + e % D;
    *p = __float2bfloat16(__bfloat162float(*p) * a.scale);
  }
  const int wrow = warp * 16;  // the warp's rows of the tile
  for (int r = 0; r < 16; ++r) {
    const int i = wrow + r;
    float s = 0.0f;
    if (i < nq)
      for (int d = lane; d < D; d += 32)
        s = fmaf(__bfloat162float(dos[i * LDS + d]),
                 __bfloat162float(ob[(q0 + i) * qstride + d]), s);
    s = repro::warp_sum(s);
    if (lane == 0) {
      rd[i] = s;
      rl[i] = i < nq
                  ? a.lse[static_cast<long>(bh) * a.Sq + q0 + i] * LOG2E
                  : 0.0f;
      if (i < nq) a.dvec[static_cast<long>(bh) * a.Sq + q0 + i] = s;
    }
  }
  __syncthreads();

  const int w_first = q0 + wrow + q_off;  // the warp's first query position
  const int row[2] = {wrow + g8, wrow + g8 + 8};
  const float lse2[2] = {rl[row[0]], rl[row[1]]};
  const float dvr[2] = {rd[row[0]], rd[row[1]]};
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  const float inv_cap = a.cap > 0.0f ? 1.0f / a.cap : 0.0f;

  for (int t = t_begin; t < t_end; ++t) {
    const int buf = (t - t_begin) & 1;
    if (t > t_begin) {
      repro::cp_async_wait<0>();  // tile t has landed ...
      __syncthreads();            // ... for all, and tile t-1 is consumed
    }
    if (t + 1 < t_end) {  // tile t+1 loads while tile t computes
      const int k1 = (t + 1) * BK;
      load_rows<D, LDS, DQ_NT>(kbuf + (buf ^ 1) * BK * LDS,
                               kb + k1 * kstride, kstride, a.Sk - k1, BK);
      load_rows<D, LDS, DQ_NT>(vbuf + (buf ^ 1) * BK * LDS,
                               vb + k1 * kstride, kstride, a.Sk - k1, BK);
    }
    repro::cp_async_commit();
    const bf16* ks = kbuf + buf * BK * LDS;
    const bf16* vs = vbuf + buf * BK * LDS;
    const int k0 = t * BK;

    // S = Q K^T and dP = dO V^T: 16 rows x BK keys a warp
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
#pragma unroll 4
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ad[4];
      const int aoff = (wrow + (lane & 15)) * LDS + kk * 16 + (lane >> 4) * 8;
      repro::ldmatrix_x4(aq, qs + aoff);
      repro::ldmatrix_x4(ad, dos + aoff);
#pragma unroll
      for (int j2 = 0; j2 < NS / 2; ++j2) {
        uint32_t bk[4], bv[4];
        const int boff = (j2 * 16 + (lane & 7) + (lane >> 4) * 8) * LDS +
                         kk * 16 + ((lane >> 3) & 1) * 8;
        repro::ldmatrix_x4(bk, ks + boff);
        repro::ldmatrix_x4(bv, vs + boff);
        repro::mma_bf16_16816(s[2 * j2], aq, bk);
        repro::mma_bf16_16816(s[2 * j2 + 1], aq, bk + 2);
        repro::mma_bf16_16816(dp[2 * j2], ad, bv);
        repro::mma_bf16_16816(dp[2 * j2 + 1], ad, bv + 2);
      }
    }
    // p and dS on the fragments (dS into s)
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int kp = k0 + 8 * j + 2 * tq + (e & 1);
        const bool valid = row[r] < nq && visible(w_first + g8 + 8 * r, kp,
                                                  a.Sk, a.causal, a.window);
        float p, ds;
        p_ds(s[j][e], dp[j][e], lse2[r], dvr[r], a.cap, inv_cap, valid, &p,
             &ds);
        s[j][e] = ds;
      }
    // dQ += dS K: dS (bf16) is the A fragment in the accumulator's layout
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[4];
      af[0] = repro::pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      af[1] = repro::pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      af[2] = repro::pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      af[3] = repro::pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int d2 = 0; d2 < NO / 2; ++d2) {
        uint32_t bb[4];
        repro::ldmatrix_x4_trans(
            bb, ks + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS +
                    d2 * 16 + (lane >> 4) * 8);
        repro::mma_bf16_16816(acc[2 * d2], af, bb);
        repro::mma_bf16_16816(acc[2 * d2 + 1], af, bb + 2);
      }
    }
  }
  repro::cp_async_wait<0>();

  bf16* dqb = static_cast<bf16*>(a.dq) + qbase;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row[r];
    if (i >= nq) continue;
    bf16* out = dqb + (q0 + i) * qstride;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<uint32_t*>(out + 8 * j + 2 * tq) = repro::pack_bf16x2(
          acc[j][2 * r] * a.scale, acc[j][2 * r + 1] * a.scale);
  }
}

template <int D>
struct KvShape {
  static constexpr int BKV = 64;                  // keys per block
  static constexpr int BQ = 64;                   // query rows per tile
  static constexpr int DW = D;                    // dK/dV columns a warp
  static constexpr int NCB = D / DW;
  static constexpr int NW = (BKV / 16) * NCB;  // one 16 x DW block a warp
  static constexpr int NT = 32 * NW;
  static constexpr int LDS = D + 8;
  static constexpr int LDP = BQ + 8;  // p^T and dS^T rows
  static constexpr size_t smem =
      sizeof(bf16) * (2 * static_cast<size_t>(BKV) * LDS +
                      4 * static_cast<size_t>(BQ) * LDS +
                      2 * static_cast<size_t>(BKV) * LDP) +
      sizeof(float) * 2 * BQ;
};

template <int D>
__global__ void __launch_bounds__(KvShape<D>::NT)
bwd_dkdv_bf16_kernel(Args a) {
  using S = KvShape<D>;
  constexpr int BKV = S::BKV, BQ = S::BQ, DW = S::DW, NCB = S::NCB,
                NW = S::NW, NT = S::NT, LDS = S::LDS, LDP = S::LDP;
  constexpr int NJ = (BKV / 16) * (BQ / 16);  // phase A's 16 x 16 pieces
  extern __shared__ float smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);  // BKV x LDS
  bf16* vs = ks + BKV * LDS;                 // BKV x LDS
  bf16* qbuf = vs + BKV * LDS;               // 2 x BQ x LDS, q * scale
  bf16* dobuf = qbuf + 2 * BQ * LDS;         // 2 x BQ x LDS
  bf16* pT = dobuf + 2 * BQ * LDS;           // BKV x LDP
  bf16* dsT = pT + BKV * LDP;                // BKV x LDP
  float* rl = reinterpret_cast<float*>(dsT + BKV * LDP);  // lse * log2 e
  float* rd = rl + BQ;                                    // Dv

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, tq = lane & 3;
  const int bg = blockIdx.y, b = bg / a.G, grp = bg % a.G;
  const int Hg = a.H / a.G;
  const int k0 = blockIdx.x * BKV;
  const int nk = min(BKV, a.Sk - k0);
  const int q_off = a.Sk - a.Sq;
  const long qstride = static_cast<long>(a.H) * D;
  const long kstride = static_cast<long>(a.G) * D;
  const long kbase = (static_cast<long>(b) * a.Sk * a.G + grp) * D;
  const bf16* kb = static_cast<const bf16*>(a.k) + kbase;
  const bf16* vb = static_cast<const bf16*>(a.v) + kbase;
  int t_lo, t_hi;
  q_range(a, k0, nk, BQ, &t_lo, &t_hi);
  const int nt = t_hi - t_lo, n_it = Hg * nt;

  // iteration `it`: head grp * Hg + it / nt, query tile t_lo + it % nt
  auto load_q_tile = [&](int it, int buf) {
    const int h = grp * Hg + it / nt;
    const int q0 = (t_lo + it % nt) * BQ;
    const long qbase = (static_cast<long>(b) * a.Sq * a.H + h) * D;
    load_rows<D, LDS, NT>(qbuf + buf * BQ * LDS,
                          static_cast<const bf16*>(a.q) + qbase +
                              q0 * qstride,
                          qstride, a.Sq - q0, BQ);
    load_rows<D, LDS, NT>(dobuf + buf * BQ * LDS,
                          static_cast<const bf16*>(a.dout) + qbase +
                              q0 * qstride,
                          qstride, a.Sq - q0, BQ);
  };
  load_rows<D, LDS, NT>(ks, kb + k0 * kstride, kstride, nk, BKV);
  load_rows<D, LDS, NT>(vs, vb + k0 * kstride, kstride, nk, BKV);
  if (n_it > 0) load_q_tile(0, 0);
  repro::cp_async_commit();

  const int rb = warp / NCB, cb = warp % NCB;  // phase B: keys, columns
  float dk[DW / 8][4], dv[DW / 8][4];
#pragma unroll
  for (int j = 0; j < DW / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.0f;
  const float inv_cap = a.cap > 0.0f ? 1.0f / a.cap : 0.0f;

  for (int it = 0; it < n_it; ++it) {
    const int buf = it & 1;
    repro::cp_async_wait<0>();  // this tile has landed ...
    __syncthreads();            // ... for all; the last one is consumed
    if (it + 1 < n_it) load_q_tile(it + 1, buf ^ 1);
    repro::cp_async_commit();
    const int h = grp * Hg + it / nt;
    const int q0 = (t_lo + it % nt) * BQ;
    const int nq = min(BQ, a.Sq - q0);
    const long bh = static_cast<long>(b) * a.H + h;
    bf16* qs = qbuf + buf * BQ * LDS;
    const bf16* dos = dobuf + buf * BQ * LDS;
    // q * scale in the input type, as the plain version's _layout
    for (int e = tid; e < BQ * D; e += NT) {
      bf16* p = qs + (e / D) * LDS + e % D;
      *p = __float2bfloat16(__bfloat162float(*p) * a.scale);
    }
    for (int i = tid; i < BQ; i += NT) {
      rl[i] = i < nq ? a.lse[bh * a.Sq + q0 + i] * LOG2E : 0.0f;
      rd[i] = i < nq ? a.dvec[bh * a.Sq + q0 + i] : 0.0f;
    }
    __syncthreads();

    // phase A: S^T = K Q^T and dP^T = V dO^T in 16 x 16 pieces -> p^T, dS^T
    for (int job = warp; job < NJ; job += NW) {
      const int kr = job / (BQ / 16), qc = job % (BQ / 16);
      float s[2][4], dp[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
#pragma unroll 4
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ak[4], av[4], bq[4], bd[4];
        const int aoff =
            (kr * 16 + (lane & 15)) * LDS + kk * 16 + (lane >> 4) * 8;
        const int boff = (qc * 16 + (lane & 7) + (lane >> 4) * 8) * LDS +
                         kk * 16 + ((lane >> 3) & 1) * 8;
        repro::ldmatrix_x4(ak, ks + aoff);
        repro::ldmatrix_x4(av, vs + aoff);
        repro::ldmatrix_x4(bq, qs + boff);
        repro::ldmatrix_x4(bd, dos + boff);
        repro::mma_bf16_16816(s[0], ak, bq);
        repro::mma_bf16_16816(s[1], ak, bq + 2);
        repro::mma_bf16_16816(dp[0], av, bd);
        repro::mma_bf16_16816(dp[1], av, bd + 2);
      }
#pragma unroll
      for (int jn = 0; jn < 2; ++jn)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int key = kr * 16 + g8 + 8 * r;
          float pv[2], dsv[2];
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int i = qc * 16 + 8 * jn + 2 * tq + x;
            const bool valid =
                i < nq && key < nk &&
                visible(q0 + i + q_off, k0 + key, a.Sk, a.causal, a.window);
            p_ds(s[jn][2 * r + x], dp[jn][2 * r + x], rl[i], rd[i], a.cap,
                 inv_cap, valid, &pv[x], &dsv[x]);
          }
          const int off = key * LDP + qc * 16 + 8 * jn + 2 * tq;
          *reinterpret_cast<uint32_t*>(pT + off) =
              repro::pack_bf16x2(pv[0], pv[1]);
          *reinterpret_cast<uint32_t*>(dsT + off) =
              repro::pack_bf16x2(dsv[0], dsv[1]);
        }
    }
    __syncthreads();

    // phase B: dV += p^T dO, dK += dS^T (q * scale) for this warp's block
#pragma unroll
    for (int kq = 0; kq < BQ / 16; ++kq) {
      uint32_t ap[4], as[4];
      const int aoff =
          (rb * 16 + (lane & 15)) * LDP + kq * 16 + (lane >> 4) * 8;
      repro::ldmatrix_x4(ap, pT + aoff);
      repro::ldmatrix_x4(as, dsT + aoff);
#pragma unroll
      for (int d2 = 0; d2 < DW / 16; ++d2) {
        uint32_t bdo[4], bq[4];
        const int boff =
            (kq * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS + cb * DW +
            d2 * 16 + (lane >> 4) * 8;
        repro::ldmatrix_x4_trans(bdo, dos + boff);
        repro::ldmatrix_x4_trans(bq, qs + boff);
        repro::mma_bf16_16816(dv[2 * d2], ap, bdo);
        repro::mma_bf16_16816(dv[2 * d2 + 1], ap, bdo + 2);
        repro::mma_bf16_16816(dk[2 * d2], as, bq);
        repro::mma_bf16_16816(dk[2 * d2 + 1], as, bq + 2);
      }
    }
  }
  repro::cp_async_wait<0>();

  bf16* dkb = static_cast<bf16*>(a.dk) + kbase;
  bf16* dvb = static_cast<bf16*>(a.dv) + kbase;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = rb * 16 + g8 + 8 * r;
    if (key >= nk) continue;
    const long off = (k0 + key) * kstride + cb * DW + 2 * tq;
#pragma unroll
    for (int j = 0; j < DW / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dkb + off + 8 * j) =
          repro::pack_bf16x2(dk[j][2 * r], dk[j][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dvb + off + 8 * j) =
          repro::pack_bf16x2(dv[j][2 * r], dv[j][2 * r + 1]);
    }
  }
}

template <int D>
int launch_tc(const Args& a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  {
    auto kern = bwd_dq_bf16_kernel<D>;
    const size_t smem = DqShape<D>::smem;
    cudaError_t err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(kern),
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((a.Sq + DQ_BQ - 1) / DQ_BQ, a.B * a.H);
    kern<<<grid, DQ_NT, smem, st>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (a.Sk > 0) {
    using S = KvShape<D>;
    auto kern = bwd_dkdv_bf16_kernel<D>;
    cudaError_t err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(kern),
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(S::smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((a.Sk + S::BKV - 1) / S::BKV, a.B * a.G);
    kern<<<grid, S::NT, S::smem, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------ bf16, the Hopper form (wgmma)
//
// D in {64, 128, 256}.  Both launches are warp-specialised: warpgroup 0's
// first thread is the producer (TMA loads into a ring, 4D tensor maps over
// (B, S, heads, D) so a head's rows are read at stride heads x D with no
// transpose; 64-column boxes in the 128-byte swizzle), warpgroups 1 and 2
// consume with wgmma.

constexpr int H_NT = 384;

using repro::map_heads;
using repro::scale_rows;

template <int D>
struct HDq {
  static constexpr int BQ = 128;                   // 64 rows a consumer
  static constexpr int BK = D == 256 ? 32 : 64;    // keys a kv tile
  static constexpr int NSTG = D == 256 ? 2 : D == 128 ? 3 : 4;
  static constexpr int CH = D / 64;                // 64-column boxes
  static constexpr int QB = BQ * D * 2;            // the Q or dO tile
  static constexpr int KB = BK * D * 2;            // a K or V tile
  static constexpr size_t smem = 1024 + 2 * QB + NSTG * 2 * KB +
                                 (1 + 2 * NSTG) * 8 + 2 * BQ * 4;
};

// dQ for 128 query rows of one (batch, head): S = Q K^T and dP = dO V^T
// (wgmma, both operands from shared memory, K-major), p and dS on the
// accumulators in registers, dQ += dS K with dS as the register A operand
// and K read MN-major; Dv written for the dK/dV launch.
template <int D>
__global__ void __launch_bounds__(H_NT, 1)
bwd_dq_wgmma_kernel(Args a, const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv) {
  using S = HDq<D>;
  constexpr int BQ = S::BQ, BK = S::BK, NSTG = S::NSTG, CH = S::CH;
  extern __shared__ float smem[];
  char* qs = repro::align1024(smem);
  char* dos = qs + S::QB;
  char* kv = dos + S::QB;   // NSTG x (K tile, V tile)
  uint64_t* qfull = reinterpret_cast<uint64_t*>(kv + NSTG * 2 * S::KB);
  uint64_t* full = qfull + 1;
  uint64_t* empty = full + NSTG;
  float* rl = reinterpret_cast<float*>(empty + NSTG);   // lse * log2 e
  float* rd = rl + BQ;                                  // Dv

  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int grp = h / (a.H / a.G);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // heaviest first
  const int nq = min(BQ, a.Sq - q0);
  int t_begin, t_end;
  kv_range(a, q0, nq, BK, &t_begin, &t_end);
  if (threadIdx.x == 0) {
    repro::mbar_init(qfull, 1);
    for (int s = 0; s < NSTG; ++s) {
      repro::mbar_init(&full[s], 1);
      repro::mbar_init(&empty[s], 256);
    }
    repro::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    repro::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      repro::mbar_arrive_expect_tx(qfull, 2 * S::QB);
      for (int c = 0; c < CH; ++c) {
        repro::tma_load_4d(qs + c * BQ * 128, &tq, qfull, 64 * c, h, q0, b);
        repro::tma_load_4d(dos + c * BQ * 128, &tdo, qfull, 64 * c, h, q0,
                           b);
      }
      int stage = 0, phase = 0;
      for (int t = t_begin; t < t_end; ++t) {
        repro::mbar_wait(&empty[stage], phase ^ 1);
        char* ks = kv + stage * 2 * S::KB;
        repro::mbar_arrive_expect_tx(&full[stage], 2 * S::KB);
        for (int c = 0; c < CH; ++c) {
          repro::tma_load_4d(ks + c * BK * 128, &tk, &full[stage], 64 * c,
                             grp, t * BK, b);
          repro::tma_load_4d(ks + S::KB + c * BK * 128, &tv, &full[stage],
                             64 * c, grp, t * BK, b);
        }
        if (++stage == NSTG) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    repro::setmaxnreg_inc<240>();
    const int cw = threadIdx.x / 128 - 1;   // rows 64 cw .. of the tile
    const int lt = threadIdx.x % 128, warp = lt / 32, lane = lt % 32;
    const int g8 = lane >> 2, tq4 = lane & 3;
    const int q_off = a.Sk - a.Sq;
    const long qstride = static_cast<long>(a.H) * D;
    const long qbase = (static_cast<long>(b) * a.Sq * a.H + h) * D;
    const bf16* ob = static_cast<const bf16*>(a.o) + qbase;
    const bf16* dob = static_cast<const bf16*>(a.dout) + qbase;
    // Dv = rowsum(dO . O) and lse of this warpgroup's rows
    for (int r = 0; r < 16; ++r) {
      const int i = 64 * cw + 16 * warp + r;
      float s = 0.0f;
      if (i < nq)
        for (int d = lane; d < D; d += 32)
          s = fmaf(__bfloat162float(dob[(q0 + i) * qstride + d]),
                   __bfloat162float(ob[(q0 + i) * qstride + d]), s);
      s = repro::warp_sum(s);
      if (lane == 0) {
        rd[i] = s;
        rl[i] = i < nq
                    ? a.lse[static_cast<long>(bh) * a.Sq + q0 + i] * LOG2E
                    : 0.0f;
        if (i < nq) a.dvec[static_cast<long>(bh) * a.Sq + q0 + i] = s;
      }
    }
    // q * scale in the input type, as the plain version's _layout: this
    // warpgroup's 64 rows of each 64-column box
    repro::mbar_wait(qfull, 0);
    for (int c = 0; c < CH; ++c)
      scale_rows(qs + c * BQ * 128 + cw * 64 * 128, 64 * 128, a.scale, lt);
    repro::fence_proxy_async();
    repro::named_barrier(1 + cw, 128);

    const int row[2] = {64 * cw + 16 * warp + g8, 64 * cw + 16 * warp + g8 + 8};
    const float lse2[2] = {rl[row[0]], rl[row[1]]};
    const float dvr[2] = {rd[row[0]], rd[row[1]]};
    const float inv_cap = a.cap > 0.0f ? 1.0f / a.cap : 0.0f;
    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.0f;
    const char* qw = qs + cw * 64 * 128;
    const char* dow = dos + cw * 64 * 128;
    int stage = 0, phase = 0;
    for (int t = t_begin; t < t_end; ++t) {
      repro::mbar_wait(&full[stage], phase);
      const char* ks = kv + stage * 2 * S::KB;
      const char* vs = ks + S::KB;
      float s[BK / 2], dp[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] = dp[i] = 0.0f;
      repro::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int o = (kk / 4) * BQ * 128 + (kk % 4) * 32;
        const int ob2 = (kk / 4) * BK * 128 + (kk % 4) * 32;
        repro::wgmma_ss<BK, 0, 0>(s, repro::desc128(qw + o, 16, 1024),
                                  repro::desc128(ks + ob2, 16, 1024));
        repro::wgmma_ss<BK, 0, 0>(dp, repro::desc128(dow + o, 16, 1024),
                                  repro::desc128(vs + ob2, 16, 1024));
      }
      repro::wgmma_commit();
      repro::wgmma_wait<0>();
      repro::fence_regs(s);
      repro::fence_regs(dp);
      const int k0 = t * BK;
      // p and dS on the accumulators (dS into s)
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int kp = k0 + 8 * j + 2 * tq4 + (e & 1);
          const bool valid = row[r] < nq &&
                             visible(q0 + row[r] + q_off, kp, a.Sk, a.causal,
                                     a.window);
          float p, ds;
          p_ds(s[4 * j + e], dp[4 * j + e], lse2[r], dvr[r], a.cap, inv_cap,
               valid, &p, &ds);
          s[4 * j + e] = ds;
        }
      // dQ += dS K: dS (bf16) the register A operand, K read MN-major
      repro::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t af[4] = {
            repro::pack_bf16x2(s[8 * kk], s[8 * kk + 1]),
            repro::pack_bf16x2(s[8 * kk + 2], s[8 * kk + 3]),
            repro::pack_bf16x2(s[8 * kk + 4], s[8 * kk + 5]),
            repro::pack_bf16x2(s[8 * kk + 6], s[8 * kk + 7])};
        repro::wgmma_rs<D, 1>(
            dq, af, repro::desc128(ks + kk * 16 * 128, BK * 128, 1024));
      }
      repro::wgmma_commit();
      repro::wgmma_wait<0>();
      repro::fence_regs(dq);
      repro::mbar_arrive(&empty[stage]);
      if (++stage == NSTG) {
        stage = 0;
        phase ^= 1;
      }
    }

    bf16* dqb = static_cast<bf16*>(a.dq) + qbase;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = row[r];
      if (i >= nq) continue;
      bf16* out = dqb + (q0 + i) * qstride;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(out + 8 * j + 2 * tq4) =
            repro::pack_bf16x2(dq[4 * j + 2 * r] * a.scale,
                               dq[4 * j + 2 * r + 1] * a.scale);
    }
  }
}

template <int D>
struct HKv {
  // D <= 128: each consumer warpgroup owns 64 keys and all D columns of dK
  // and dV, p^T and dS^T stay in its registers as the A operand; D = 256:
  // the two share 64 keys, each owning D / 2 columns (dK and dV of 64 x 256
  // fp32 would be 256 registers a thread), and exchange p^T and dS^T
  // through shared memory
  static constexpr bool KS = D <= 128;
  static constexpr int BKV = KS ? 128 : 64, BQ = 64;
  static constexpr int DH = KS ? D : D / 2;   // dK, dV columns a consumer
  static constexpr int NSTG = D == 256 ? 2 : 4;
  static constexpr int CH = D / 64;
  static constexpr int KB = BKV * D * 2;      // the K or V tile
  static constexpr int QB = BQ * D * 2;       // a Q or dO tile
  static constexpr int PB = KS ? 0 : 64 * BQ * 2;   // a p^T or dS^T tile
  static constexpr int SB = 2 * BQ * 4;       // a stage's lse and Dv rows
  static constexpr size_t smem = 1024 + 2 * KB + NSTG * (2 * QB + SB) +
                                 4 * PB + (1 + 3 * NSTG) * 8;
};

// dK and dV for the keys of one (batch, kv head) tile: for each query tile
// of every head of the group that sees them, S^T = K Q^T and dP^T = V dO^T,
// p^T and dS^T rounded to bf16, dV += p^T dO and dK += dS^T (q * scale)
// with dO and Q read MN-major.  Warpgroup 0: thread 0 issues the TMA loads;
// warps 1-3 prepare each landed stage (q * scale rounded to bf16 in place,
// the rows' lse * log2 e and Dv into shared memory) and release it to the
// consumers, so neither sits on the consumers' path.
template <int D>
__global__ void __launch_bounds__(H_NT, 1)
bwd_dkdv_wgmma_kernel(Args a, const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tdo,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv) {
  using S = HKv<D>;
  constexpr int BKV = S::BKV, BQ = S::BQ, DH = S::DH, NSTG = S::NSTG,
                CH = S::CH;
  extern __shared__ float smem[];
  char* ks = repro::align1024(smem);
  char* vs = ks + S::KB;
  char* ring = vs + S::KB;                   // NSTG x (Q tile, dO tile)
  char* pbuf = ring + NSTG * 2 * S::QB;      // D = 256: 2 x (p^T, dS^T)
  float* stats = reinterpret_cast<float*>(pbuf + 4 * S::PB);  // NSTG x 2 BQ
  uint64_t* kvfull = reinterpret_cast<uint64_t*>(stats + NSTG * 2 * BQ);
  uint64_t* full = kvfull + 1;               // TMA bytes landed
  uint64_t* ready = full + NSTG;             // the stage prepared
  uint64_t* empty = ready + NSTG;            // the stage consumed

  const int bg = blockIdx.y, b = bg / a.G, grp = bg % a.G;
  const int Hg = a.H / a.G;
  const int k0 = blockIdx.x * BKV;
  const int nk = min(BKV, a.Sk - k0);
  int t_lo, t_hi;
  q_range(a, k0, nk, BQ, &t_lo, &t_hi);
  const int nt = t_hi - t_lo, n_it = Hg * nt;
  if (threadIdx.x == 0) {
    repro::mbar_init(kvfull, 1);
    for (int s = 0; s < NSTG; ++s) {
      repro::mbar_init(&full[s], 1);
      repro::mbar_init(&ready[s], 96);
      repro::mbar_init(&empty[s], 256);
    }
    repro::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    repro::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {   // the copies
      repro::mbar_arrive_expect_tx(kvfull, 2 * S::KB);
      for (int c = 0; c < CH; ++c) {
        repro::tma_load_4d(ks + c * BKV * 128, &tk, kvfull, 64 * c, grp, k0,
                           b);
        repro::tma_load_4d(vs + c * BKV * 128, &tv, kvfull, 64 * c, grp, k0,
                           b);
      }
      int stage = 0, phase = 0;
      for (int it = 0; it < n_it; ++it) {
        const int h = grp * Hg + it / nt;
        const int q0 = (t_lo + it % nt) * BQ;
        repro::mbar_wait(&empty[stage], phase ^ 1);
        char* qs = ring + stage * 2 * S::QB;
        repro::mbar_arrive_expect_tx(&full[stage], 2 * S::QB);
        for (int c = 0; c < CH; ++c) {
          repro::tma_load_4d(qs + c * BQ * 128, &tq, &full[stage], 64 * c, h,
                             q0, b);
          repro::tma_load_4d(qs + S::QB + c * BQ * 128, &tdo, &full[stage],
                             64 * c, h, q0, b);
        }
        if (++stage == NSTG) {
          stage = 0;
          phase ^= 1;
        }
      }
    } else if (threadIdx.x >= 32) {   // the preparation, 96 threads
      const int pt = threadIdx.x - 32;
      int stage = 0, phase = 0;
      for (int it = 0; it < n_it; ++it) {
        const int h = grp * Hg + it / nt;
        const int q0 = (t_lo + it % nt) * BQ;
        const int nq = min(BQ, a.Sq - q0);
        const long bh = static_cast<long>(b) * a.H + h;
        // the stage's last consumers are done once its copy has landed
        repro::mbar_wait(&full[stage], phase);
        float* st = stats + stage * 2 * BQ;
        for (int i = pt; i < BQ; i += 96) {
          st[i] = i < nq ? a.lse[bh * a.Sq + q0 + i] * LOG2E : 0.0f;
          st[BQ + i] = i < nq ? a.dvec[bh * a.Sq + q0 + i] : 0.0f;
        }
        // q * scale in the input type, as the plain version's _layout
        char* qs = ring + stage * 2 * S::QB;
        for (int o = 4 * pt; o < S::QB; o += 4 * 96) {
          uint32_t* w = reinterpret_cast<uint32_t*>(qs + o);
          const float lo = __bfloat162float(
              __ushort_as_bfloat16(static_cast<unsigned short>(*w & 0xffffu)));
          const float hi = __bfloat162float(
              __ushort_as_bfloat16(static_cast<unsigned short>(*w >> 16)));
          *w = repro::pack_bf16x2(lo * a.scale, hi * a.scale);
        }
        repro::fence_proxy_async();
        repro::mbar_arrive(&ready[stage]);
        if (++stage == NSTG) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    repro::setmaxnreg_inc<232>();
    const int cw = threadIdx.x / 128 - 1;
    const int lt = threadIdx.x % 128, warp = lt / 32, lane = lt % 32;
    const int g8 = lane >> 2, tq4 = lane & 3;
    const int q_off = a.Sk - a.Sq;
    const float inv_cap = a.cap > 0.0f ? 1.0f / a.cap : 0.0f;
    // the keys of this warpgroup's rows of S^T (tile-relative), and its
    // first column of dK and dV
    const int key0 = (S::KS ? 64 * cw : 0) + 16 * warp + g8;
    const int col0 = S::KS ? 0 : cw * DH;
    float dk[DH / 2], dv[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) dk[i] = dv[i] = 0.0f;
    repro::mbar_wait(kvfull, 0);
    int stage = 0, phase = 0;
    for (int it = 0; it < n_it; ++it) {
      const int q0 = (t_lo + it % nt) * BQ;
      const int nq = min(BQ, a.Sq - q0);
      repro::mbar_wait(&ready[stage], phase);
      const char* qs = ring + stage * 2 * S::QB;
      const char* dos = qs + S::QB;
      const float* rl = stats + stage * 2 * BQ;
      const float* rd = rl + BQ;
      if constexpr (S::KS) {
        // S^T and dP^T: this warpgroup's 64 keys x the tile's 64 rows
        float s[32], dp[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.0f;
        repro::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int ok = (kk / 4) * BKV * 128 + cw * 64 * 128 + (kk % 4) * 32;
          const int oq = (kk / 4) * BQ * 128 + (kk % 4) * 32;
          repro::wgmma_ss<64, 0, 0>(s, repro::desc128(ks + ok, 16, 1024),
                                    repro::desc128(qs + oq, 16, 1024));
          repro::wgmma_ss<64, 0, 0>(dp, repro::desc128(vs + ok, 16, 1024),
                                    repro::desc128(dos + oq, 16, 1024));
        }
        repro::wgmma_commit();
        repro::wgmma_wait<0>();
        repro::fence_regs(s);
        repro::fence_regs(dp);
        // p^T into s, dS^T into dp
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = key0 + 8 * (e >> 1);
            const int i = 8 * j + 2 * tq4 + (e & 1);
            const bool valid = i < nq && key < nk &&
                               visible(q0 + i + q_off, k0 + key, a.Sk,
                                       a.causal, a.window);
            float p, ds;
            p_ds(s[4 * j + e], dp[4 * j + e], rl[i], rd[i], a.cap, inv_cap,
                 valid, &p, &ds);
            s[4 * j + e] = p;
            dp[4 * j + e] = ds;
          }
        // dV += p^T dO and dK += dS^T (q * scale): the A operands from
        // registers, dO and Q read MN-major
        repro::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          const uint32_t ap[4] = {
              repro::pack_bf16x2(s[8 * kk], s[8 * kk + 1]),
              repro::pack_bf16x2(s[8 * kk + 2], s[8 * kk + 3]),
              repro::pack_bf16x2(s[8 * kk + 4], s[8 * kk + 5]),
              repro::pack_bf16x2(s[8 * kk + 6], s[8 * kk + 7])};
          const uint32_t ad[4] = {
              repro::pack_bf16x2(dp[8 * kk], dp[8 * kk + 1]),
              repro::pack_bf16x2(dp[8 * kk + 2], dp[8 * kk + 3]),
              repro::pack_bf16x2(dp[8 * kk + 4], dp[8 * kk + 5]),
              repro::pack_bf16x2(dp[8 * kk + 6], dp[8 * kk + 7])};
          repro::wgmma_rs<D, 1>(
              dv, ap, repro::desc128(dos + kk * 16 * 128, BQ * 128, 1024));
          repro::wgmma_rs<D, 1>(
              dk, ad, repro::desc128(qs + kk * 16 * 128, BQ * 128, 1024));
        }
      } else {
        // S^T and dP^T: the tile's 64 keys x this warpgroup's 32 rows
        float s[16], dp[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) s[i] = dp[i] = 0.0f;
        repro::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int ok = (kk / 4) * BKV * 128 + (kk % 4) * 32;
          const int oq = (kk / 4) * BQ * 128 + cw * 32 * 128 + (kk % 4) * 32;
          repro::wgmma_ss<32, 0, 0>(s, repro::desc128(ks + ok, 16, 1024),
                                    repro::desc128(qs + oq, 16, 1024));
          repro::wgmma_ss<32, 0, 0>(dp, repro::desc128(vs + ok, 16, 1024),
                                    repro::desc128(dos + oq, 16, 1024));
        }
        repro::wgmma_commit();
        repro::wgmma_wait<0>();
        repro::fence_regs(s);
        repro::fence_regs(dp);
        // p^T and dS^T (bf16) into this iteration's buffers: key rows of
        // 64 query columns, the 128-byte swizzle (a K-major A operand)
        char* pT = pbuf + (it & 1) * 2 * S::PB;
        char* dsT = pT + S::PB;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int key = key0 + 8 * r;
            float pv[2], dsv[2];
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              const int i = 32 * cw + 8 * j + 2 * tq4 + x;
              const bool valid = i < nq && key < nk &&
                                 visible(q0 + i + q_off, k0 + key, a.Sk,
                                         a.causal, a.window);
              p_ds(s[4 * j + 2 * r + x], dp[4 * j + 2 * r + x], rl[i], rd[i],
                   a.cap, inv_cap, valid, &pv[x], &dsv[x]);
            }
            const uint32_t off = repro::swz128(
                key * 128 + (32 * cw + 8 * j + 2 * tq4) * 2);
            *reinterpret_cast<uint32_t*>(pT + off) =
                repro::pack_bf16x2(pv[0], pv[1]);
            *reinterpret_cast<uint32_t*>(dsT + off) =
                repro::pack_bf16x2(dsv[0], dsv[1]);
          }
        repro::fence_proxy_async();
        repro::named_barrier(1, 256);   // both halves of p^T and dS^T
        // dV += p^T dO and dK += dS^T (q * scale), this warpgroup's columns
        const int cb = (col0 / 64) * BQ * 128 + (col0 % 64) * 2;
        repro::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          repro::wgmma_ss<DH, 0, 1>(
              dv, repro::desc128(pT + 32 * kk, 16, 1024),
              repro::desc128(dos + cb + kk * 16 * 128, BQ * 128, 1024));
          repro::wgmma_ss<DH, 0, 1>(
              dk, repro::desc128(dsT + 32 * kk, 16, 1024),
              repro::desc128(qs + cb + kk * 16 * 128, BQ * 128, 1024));
        }
      }
      repro::wgmma_commit();
      repro::wgmma_wait<0>();
      repro::fence_regs(dk);
      repro::fence_regs(dv);
      repro::mbar_arrive(&empty[stage]);
      if (++stage == NSTG) {
        stage = 0;
        phase ^= 1;
      }
    }

    const long kstride = static_cast<long>(a.G) * D;
    const long kbase = (static_cast<long>(b) * a.Sk * a.G + grp) * D;
    bf16* dkb = static_cast<bf16*>(a.dk) + kbase;
    bf16* dvb = static_cast<bf16*>(a.dv) + kbase;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r;
      if (key >= nk) continue;
      const long off = (k0 + key) * kstride + col0 + 2 * tq4;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        *reinterpret_cast<uint32_t*>(dkb + off + 8 * j) =
            repro::pack_bf16x2(dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dvb + off + 8 * j) =
            repro::pack_bf16x2(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
      }
    }
  }
}

template <int D>
int launch_wgmma(const Args& a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap tq, tdo, tk, tv;
  int err;
  {
    using S = HDq<D>;
    if ((err = map_heads(&tq, a.q, a.B, a.Sq, a.H, D, S::BQ)) ||
        (err = map_heads(&tdo, a.dout, a.B, a.Sq, a.H, D, S::BQ)) ||
        (err = map_heads(&tk, a.k, a.B, max(a.Sk, 1), a.G, D, S::BK)) ||
        (err = map_heads(&tv, a.v, a.B, max(a.Sk, 1), a.G, D, S::BK)))
      return err;
    auto kern = bwd_dq_wgmma_kernel<D>;
    cudaError_t e = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(kern),
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(S::smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid((a.Sq + S::BQ - 1) / S::BQ, a.B * a.H);
    kern<<<grid, H_NT, S::smem, st>>>(a, tq, tdo, tk, tv);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (a.Sk > 0) {
    using S = HKv<D>;
    if ((err = map_heads(&tq, a.q, a.B, a.Sq, a.H, D, S::BQ)) ||
        (err = map_heads(&tdo, a.dout, a.B, a.Sq, a.H, D, S::BQ)) ||
        (err = map_heads(&tk, a.k, a.B, a.Sk, a.G, D, S::BKV)) ||
        (err = map_heads(&tv, a.v, a.B, a.Sk, a.G, D, S::BKV)))
      return err;
    auto kern = bwd_dkdv_wgmma_kernel<D>;
    cudaError_t e = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(kern),
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(S::smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid((a.Sk + S::BKV - 1) / S::BKV, a.B * a.G);
    kern<<<grid, H_NT, S::smem, st>>>(a, tq, tdo, tk, tv);
  }
  return static_cast<int>(cudaGetLastError());
}

// D 64, 128 and 256 take the Hopper form; D 16 and 32 (the SMOKE configs'
// widths, under one 128-byte row) the mma.sync form
int launch_bf16(const Args& a, void* stream) {
  switch (a.D) {
    case 16:
      return launch_tc<16>(a, stream);
    case 32:
      return launch_tc<32>(a, stream);
    case 64:
      return launch_wgmma<64>(a, stream);
    case 128:
      return launch_wgmma<128>(a, stream);
    case 256:
      return launch_wgmma<256>(a, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int launch(bool bf, const void* q, const void* k, const void* v,
           const void* o, const void* dout, const float* lse, float* dvec,
           void* dq, void* dk, void* dv, int B, int Sq, int Sk, int H, int G,
           int D, float scale, int causal, int window, float cap,
           void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return 0;
  if (D <= 0 || D > 256 || G <= 0 || H % G != 0 || Sk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,  k,  v, o,  dout, lse, dvec,  dq,     dk,     dv,
               B,  Sq, Sk, H, G,    D,   scale, causal, window, cap};
  return bf ? launch_bf16(a, stream) : launch_f32(a, stream);
}

}  // namespace

// dq, dk, dv have q's and k's layouts; dvec is (B, H, Sq) fp32 scratch.
// window <= 0: no sliding window; cap <= 0: no softcap.
extern "C" int flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* dvec, void* dq, void* dk,
    void* dv, int B, int Sq, int Sk, int H, int G, int D, float scale,
    int causal, int window, float cap, void* stream) {
  return launch(false, q, k, v, o, dout, lse, dvec, dq, dk, dv, B, Sq, Sk, H,
                G, D, scale, causal, window, cap, stream);
}

// D must be 16, 32, 64, 128 or 256 (cudaErrorInvalidValue otherwise).
extern "C" int flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* dvec, void* dq, void* dk,
    void* dv, int B, int Sq, int Sk, int H, int G, int D, float scale,
    int causal, int window, float cap, void* stream) {
  return launch(true, q, k, v, o, dout, lse, dvec, dq, dk, dv, B, Sq, Sk, H,
                G, D, scale, causal, window, cap, stream);
}
