// Kernel 4: blocked causal GQA flash attention, forward (online softmax).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (Pallas: grid (B*H, q blocks, kv blocks), the running max,
// denominator and accumulator in VMEM scratch carried across the sequential
// kv axis, kv blocks outside the causal range or the window skipped with
// pl.when).  On Hopper blocks run in parallel and carry nothing between
// them, so the kv axis is a loop inside the block: one block per (batch *
// head, query tile) walks the kv tiles of its causal/window range only.
// GQA reads K/V of head h / (H/G) directly: K/V are never repeated.
//
// Layouts are the model's: q, out (B, Sq, H, D) and k, v (B, Sk, G, D),
// contiguous.  Beyond the TPU kernel it writes lse = m + log(l), fp32,
// (B, H, Sq) == (B, G, H/G, Sq), which the backward
// (models/attention.py::_chunked_bwd) recomputes p from.
//
// Numerics follow the plain forward it replaces on the model path
// (models/attention.py::_chunked_fwd): q * scale rounded to the input type,
// scores, softcap (cap * tanh(s / cap)) and softmax in fp32, p rounded to
// the input type before p.V, fp32 accumulation; only the order of the fp32
// sums differs.  Keys a row may not see get p = 0; a row that sees no key
// (only when Sq > Sk) gives 0, never NaN: l is clamped at 1e-30 and lse is
// then about NEG_INF.  Ragged Sq and Sk edges are masked (the TPU kernel
// asserts that its blocks divide them).  Every sum runs in a fixed order and
// nothing is atomic, so two calls give the same bits.
//
// Bound: the bf16 tensor cores.  At gemma2-2b's layer (B = 2, S = 4096,
// H = 8, D = 256, causal) one call does ~137 GFLOP of products against
// ~0.1 GB of bytes (0.14 ms at 989 TFLOP/s); at phi3.5-moe's (H = 32,
// D = 128) ~275 GFLOP (0.28 ms).
//
// bf16 at D in {64, 128, 256} (flash_fwd_wgmma_kernel, the Hopper form; it
// replaces the mma.sync form below at these widths, which reached 149-189
// TFLOP/s against SDPA's 527-597): a block of 384 threads owns 128 query
// rows of one (batch, head).  Warpgroup 0 is the producer: its first thread
// TMA-loads the Q tile once (4D tensor maps over (B, S, heads, D), 64-column
// boxes in the 128-byte swizzle) and then K and V tiles into a ring of
// stages behind full and empty mbarriers; it gives up its registers
// (setmaxnreg) to warpgroups 1 and 2, the consumers, each owning 64 query
// rows.  A consumer rounds q * scale in place for its rows, then per kv
// tile: S = Q K^T on wgmma with both operands from shared memory (K-major);
// softcap, the causal, window and ragged masks (only on tiles that cross an
// edge, per warp) and the online softmax on the accumulator fragments in
// registers (a row's max and sum live in the 4 lanes that share it); P
// rounded to bf16 in registers is the register A operand of O += P V (wgmma
// RS, V read MN-major through the transpose bit), so P never goes through
// shared memory; the stage is released.  The consumers take turns to issue
// their products (two named barriers), so one's exponentials run under the
// other's products.  At D <= 128 a consumer also issues tile t's S product
// together with tile t-1's P V and runs t's softmax while P V is in flight;
// O is rescaled by t's correction only after that P V retires, so O sees the
// same operations in the same order as without the overlap.  Epilogue: O
// normalised into the consumer's rows of the Q tile (swizzled) and stored by
// TMA (rows past Sq are not written), lse from registers.  Tiles: 128 keys
// at D <= 128, 64 at D = 256, where the O accumulator is 64 x 256 fp32 a
// warpgroup, 128 registers a thread, beside 32 of S (240 a consumer thread
// after setmaxnreg); ring stages 4 (D = 64: 144 KB), 3 (D = 128: 225 KB), 2
// (D = 256: 192 KB).  One block per SM.  Query tiles run heaviest first
// across all heads (the grid's slow axis is the query tile), so the last
// wave is short.
//   Tried on the card (tools/time_attention_norm.py): the overlap at D =
// 256 ran 1.1x slower than without it; the turns alone gained 1-5%, the
// overlap with them and a third stage at D = 128 1.16x; 64-key tiles and 4
// stages at D = 128 gained nothing over the turns alone; the overlap
// written with the first P V under a branch in the loop made ptxas wait
// after every wgmma.
//
// bf16 at D in {16, 32} (the SMOKE configs' widths, under one 128-byte
// row; flash_fwd_bf16_kernel) keeps the Ampere form: a block of 4
// warps owns 64 query rows, a warp 16; Q, K and V bf16 in shared memory,
// rows padded by 16 bytes so the 8 row addresses of an ldmatrix fall in
// distinct banks; S = Q.K^T and O += P.V are mma.sync m16n8k16 (K tiles
// through ldmatrix, V through ldmatrix.trans), softmax on the fragments as
// above, P the A operand as it stands; K/V tiles of 64 keys double-buffered
// with 16-byte cp.async.  The softcap divides by cap as a multiply by 1/cap
// in both forms (within an ulp, and without an IEEE division per score).
//
// fp32 inputs (flash_fwd_kernel, D <= 256) keep the first design: products
// as fp32 FMA on the CUDA cores from shared memory (no TF32), one block per
// (batch * head, 64 query rows), a warp owning 8 rows through scores,
// online softmax and p.V; fp32 tiles need 137 KB of shared memory at
// D = 256, one block of 8 warps per SM.
#include "hopper.cuh"

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

// ------------------------------------------------ bf16, tensor cores

using bf16 = __nv_bfloat16;
constexpr int TC_BQ = 64;                  // query rows per block
constexpr int TC_NT = 128;                 // 4 warps, 16 rows each
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct TcShape {
  static constexpr int BK = 64;      // keys per kv tile
  static constexpr int LDS = D + 8;  // row stride (elements): +16 bytes
  static constexpr size_t smem =
      sizeof(bf16) * static_cast<size_t>(TC_BQ + 4 * BK) * LDS;
};

// rows [0, n) of a (rows x D) tile from global rows of stride `stride`
// elements; rows [valid, n) are zero-filled.
template <int D, int LDS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long stride, int valid, int n) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  for (int e = threadIdx.x; e < n * CPR; e += TC_NT) {
    const int r = e / CPR, c = e % CPR;
    const bool ok = r < valid;
    repro::cp_async16(dst + r * LDS + c * 8, ok ? src + r * stride + c * 8 : src,
                      ok ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(TC_NT)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ out,
                      float* __restrict__ lse, int Sq, int Sk, int H, int G,
                      float scale, int causal, int window, float cap) {
  using S = TcShape<D>;
  constexpr int BK = S::BK, LDS = S::LDS;
  constexpr int NS = BK / 8;   // score n-tiles (8 keys each) per kv tile
  constexpr int NO = D / 8;    // output n-tiles (8 columns each)
  extern __shared__ float smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // TC_BQ x LDS
  bf16* kbuf = qs + TC_BQ * LDS;             // 2 x BK x LDS
  bf16* vbuf = kbuf + 2 * BK * LDS;          // 2 x BK x LDS

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int grp = h / (H / G);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TC_BQ;  // heaviest first
  const int nq = min(TC_BQ, Sq - q0);
  const int q_off = Sk - Sq;
  const long qstride = static_cast<long>(H) * D;
  const long kstride = static_cast<long>(G) * D;
  const bf16* qb = q + (static_cast<long>(b) * Sq * H + h) * D;
  const bf16* kb = k + (static_cast<long>(b) * Sk * G + grp) * D;
  const bf16* vb = v + (static_cast<long>(b) * Sk * G + grp) * D;

  const int q_first = q0 + q_off, q_last = q0 + nq - 1 + q_off;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  const int t_begin = k_begin / BK;
  const int t_end = k_end > 0 ? (k_end + BK - 1) / BK : 0;

  load_tile<D, LDS>(qs, qb + q0 * qstride, qstride, nq, TC_BQ);
  if (t_begin < t_end) {
    const int k0 = t_begin * BK;
    load_tile<D, LDS>(kbuf, kb + k0 * kstride, kstride, Sk - k0, BK);
    load_tile<D, LDS>(vbuf, vb + k0 * kstride, kstride, Sk - k0, BK);
  }
  repro::cp_async_commit();
  repro::cp_async_wait<0>();
  __syncthreads();
  // q * scale in the input type, as the plain forward
  for (int e = tid; e < TC_BQ * D; e += TC_NT) {
    bf16* p = qs + (e / D) * LDS + e % D;
    *p = __float2bfloat16(__bfloat162float(*p) * scale);
  }
  __syncthreads();

  const int wrow = warp * 16;                 // the warp's rows of the tile
  const int w_first = q0 + wrow + q_off;      // its first query position
  const int qp[2] = {w_first + g, w_first + g + 8};
  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};
  // s / cap as s * (1 / cap): within an ulp, without a division per score
  const float inv_cap = cap > 0.0f ? 1.0f / cap : 0.0f;

  for (int t = t_begin; t < t_end; ++t) {
    const int buf = (t - t_begin) & 1;
    if (t > t_begin) {
      repro::cp_async_wait<0>();   // tile t has landed ...
      __syncthreads();             // ... for all, and tile t-1 is consumed
    }
    if (t + 1 < t_end) {           // tile t+1 loads while tile t computes
      const int k1 = (t + 1) * BK;
      load_tile<D, LDS>(kbuf + (buf ^ 1) * BK * LDS, kb + k1 * kstride,
                        kstride, Sk - k1, BK);
      load_tile<D, LDS>(vbuf + (buf ^ 1) * BK * LDS, vb + k1 * kstride,
                        kstride, Sk - k1, BK);
    }
    repro::cp_async_commit();
    const bf16* ks = kbuf + buf * BK * LDS;
    const bf16* vs = vbuf + buf * BK * LDS;
    const int k0 = t * BK;

    // S = Q K^T: 16 rows x BK keys per warp
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      repro::ldmatrix_x4(a, qs + (wrow + (lane & 15)) * LDS + kk * 16 +
                                (lane >> 4) * 8);
#pragma unroll
      for (int j2 = 0; j2 < NS / 2; ++j2) {
        uint32_t bb[4];
        repro::ldmatrix_x4(bb, ks + (j2 * 16 + (lane & 7) + (lane >> 4) * 8) *
                                       LDS +
                                   kk * 16 + ((lane >> 3) & 1) * 8);
        repro::mma_bf16_16816(s[2 * j2], a, bb);
        repro::mma_bf16_16816(s[2 * j2 + 1], a, bb + 2);
      }
    }

    // softcap, masks, online softmax on the fragments
    const bool need_mask =
        k0 + BK > Sk || (causal && k0 + BK - 1 > w_first) ||
        (window > 0 && w_first + 15 - k0 >= window);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float sv = s[j][e];
        if (cap > 0.0f) sv = cap * tanhf(sv * inv_cap);
        if (need_mask) {
          const int kp = k0 + 8 * j + 2 * tq + (e & 1);
          const int qpos = qp[e >> 1];
          bool valid = kp < Sk;
          if (causal) valid = valid && kp <= qpos;
          if (window > 0) valid = valid && qpos - kp < window;
          if (!valid) sv = -INFINITY;
        }
        s[j][e] = sv;
        mx[e >> 1] = fmaxf(mx[e >> 1], sv);
      }
    float corr[2], ml2[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = exp2f((m[r] - m_new) * LOG2E);
      m[r] = m_new;
      ml2[r] = m_new * LOG2E;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // masked scores are -inf: p = 0 (m stays finite)
        const float p = exp2f(fmaf(s[j][e], LOG2E, -ml2[e >> 1]));
        s[j][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      o[j][0] *= corr[0];
      o[j][1] *= corr[0];
      o[j][2] *= corr[1];
      o[j][3] *= corr[1];
    }

    // O += P V: P (bf16) is the A fragment in the S accumulator's layout
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      a[0] = repro::pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      a[1] = repro::pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      a[2] = repro::pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = repro::pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int d2 = 0; d2 < NO / 2; ++d2) {
        uint32_t bb[4];
        repro::ldmatrix_x4_trans(
            bb, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS +
                    d2 * 16 + (lane >> 4) * 8);
        repro::mma_bf16_16816(o[2 * d2], a, bb);
        repro::mma_bf16_16816(o[2 * d2 + 1], a, bb + 2);
      }
    }
  }
  repro::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int i = wrow + g + 8 * r;
    if (i >= nq) continue;
    const float lc = fmaxf(l[r], 1e-30f);
    bf16* orow = out + ((static_cast<long>(b) * Sq + q0 + i) * H + h) * D;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * tq) =
          repro::pack_bf16x2(o[j][2 * r] / lc, o[j][2 * r + 1] / lc);
    if (tq == 0) lse[static_cast<long>(bh) * Sq + q0 + i] = m[r] + logf(lc);
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* out,
              float* lse, int B, int Sq, int Sk, int H, int G, float scale,
              int causal, int window, float cap, void* stream) {
  auto kern = flash_fwd_bf16_kernel<D>;
  const size_t smem = TcShape<D>::smem;
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kern),
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + TC_BQ - 1) / TC_BQ, B * H);
  kern<<<grid, TC_NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, Sq, Sk, H,
      G, scale, causal, window, cap);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------ bf16, the Hopper form (wgmma)

constexpr int H_NT = 384;   // the producer warpgroup and two consumers
constexpr int PIPE_MAX_D = 128;   // up to this D, S a tile ahead of P V
constexpr int FWD_BK = 128;       // keys a kv tile at D <= 128
constexpr int FWD_BK_256 = 64;    // ... at D = 256
constexpr int FWD_STAGES_128 = 3; // ring stages at D = 128

template <int D>
struct HFwd {
  static constexpr int BQ = 128;                   // 64 rows a consumer
  static constexpr int BK = D == 256 ? FWD_BK_256 : FWD_BK;
  static constexpr int NSTG = D == 64 ? 4 : D == 128 ? FWD_STAGES_128 : 2;
  static constexpr bool PIPELINE = D <= PIPE_MAX_D;
  static constexpr int CH = D / 64;                // 64-column boxes
  static constexpr int QB = BQ * D * 2;            // the Q tile
  static constexpr int KB = BK * D * 2;            // a K or V tile
  static constexpr size_t smem =
      1024 + QB + NSTG * 2 * KB + (1 + 2 * NSTG) * 8;
};

// S = Q K^T of one kv tile (64 rows x BK keys a warpgroup; both operands
// K-major from shared memory: q the warpgroup's rows of the Q tile, ks the
// K tile), issued as one group
template <int D, int BQ, int BK>
__device__ __forceinline__ void issue_s(float (&s)[BK / 2], const char* q,
                                        const char* ks) {
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.0f;
  repro::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int oq = (kk / 4) * BQ * 128 + (kk % 4) * 32;
    const int ok = (kk / 4) * BK * 128 + (kk % 4) * 32;
    repro::wgmma_ss<BK, 0, 0>(s, repro::desc128(q + oq, 16, 1024),
                              repro::desc128(ks + ok, 16, 1024));
  }
  repro::wgmma_commit();
}

// O += P V of one kv tile: p (bf16) the register A operand, V (vs) read
// MN-major through the transpose bit; issued as one group
template <int D, int BK>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&pa)[BK / 16][4],
                                         const char* vs) {
  repro::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    repro::wgmma_rs<D, 1>(
        o, pa[kk], repro::desc128(vs + kk * 16 * 128, BK * 128, 1024));
  repro::wgmma_commit();
}

// Softcap, masks and the online softmax of the kv tile at key k0 on a
// warp's fragments (rows qp[0], qp[1] of the 16 from w_first): s becomes
// p, m and l move on, corr is O's correction.  The masks apply only where
// the tile crosses the ragged edge, the diagonal or the window's edge.
template <int BK>
__device__ __forceinline__ void tile_softmax(
    float (&s)[BK / 2], float (&m)[2], float (&l)[2], float (&corr)[2],
    int k0, int Sk, int causal, int window, float cap, float inv_cap,
    int w_first, const int (&qp)[2], int tq4) {
  const bool need_mask = k0 + BK > Sk || (causal && k0 + BK - 1 > w_first) ||
                         (window > 0 && w_first + 15 - k0 >= window);
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float sv = s[4 * j + e];
      if (cap > 0.0f) sv = cap * tanhf(sv * inv_cap);
      if (need_mask) {
        const int kp = k0 + 8 * j + 2 * tq4 + (e & 1);
        const int qpos = qp[e >> 1];
        bool valid = kp < Sk;
        if (causal) valid = valid && kp <= qpos;
        if (window > 0) valid = valid && qpos - kp < window;
        if (!valid) sv = -INFINITY;
      }
      s[4 * j + e] = sv;
      mx[e >> 1] = fmaxf(mx[e >> 1], sv);
    }
  float ml2[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    corr[r] = exp2f((m[r] - m_new) * LOG2E);
    m[r] = m_new;
    ml2[r] = m_new * LOG2E;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // masked scores are -inf: p = 0 (m stays finite)
      const float p = exp2f(fmaf(s[4 * j + e], LOG2E, -ml2[e >> 1]));
      s[4 * j + e] = p;
      l[e >> 1] += p;
    }
}

// O *= corr, and p rounded to bf16 into P V's A fragments
template <int D, int BK>
__device__ __forceinline__ void rescale_pack(float (&o)[D / 2],
                                             const float (&corr)[2],
                                             const float (&s)[BK / 2],
                                             uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o[4 * j] *= corr[0];
    o[4 * j + 1] *= corr[0];
    o[4 * j + 2] *= corr[1];
    o[4 * j + 3] *= corr[1];
  }
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    pa[kk][0] = repro::pack_bf16x2(s[8 * kk], s[8 * kk + 1]);
    pa[kk][1] = repro::pack_bf16x2(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = repro::pack_bf16x2(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = repro::pack_bf16x2(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

template <int D>
__global__ void __launch_bounds__(H_NT, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap to,
                       float* __restrict__ lse, int Sq, int Sk, int H, int G,
                       float scale, int causal, int window, float cap) {
  using S = HFwd<D>;
  constexpr int BQ = S::BQ, BK = S::BK, NSTG = S::NSTG, CH = S::CH;
  extern __shared__ float smem[];
  char* qs = repro::align1024(smem);
  char* kv = qs + S::QB;   // NSTG x (K tile, V tile)
  uint64_t* qfull = reinterpret_cast<uint64_t*>(kv + NSTG * 2 * S::KB);
  uint64_t* full = qfull + 1;
  uint64_t* empty = full + NSTG;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int grp = h / (H / G);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest first
  const int nq = min(BQ, Sq - q0);
  const int q_off = Sk - Sq;   // queries sit at the end of the keys
  const int k_end = causal ? min(Sk, q0 + nq + q_off) : Sk;
  const int k_begin = window > 0 ? max(0, q0 + q_off - window + 1) : 0;
  const int t_begin = k_begin / BK;
  const int t_end = k_end > k_begin ? (k_end + BK - 1) / BK : t_begin;
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
      repro::mbar_arrive_expect_tx(qfull, S::QB);
      for (int c = 0; c < CH; ++c)
        repro::tma_load_4d(qs + c * BQ * 128, &tq, qfull, 64 * c, h, q0, b);
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
    // q * scale in the input type, as the plain forward: this
    // warpgroup's 64 rows of each 64-column box
    repro::mbar_wait(qfull, 0);
    for (int c = 0; c < CH; ++c)
      repro::scale_rows(qs + c * BQ * 128 + cw * 64 * 128, 64 * 128, scale,
                        lt);
    repro::fence_proxy_async();
    repro::named_barrier(1 + cw, 128);

    const int wrow = 64 * cw + 16 * warp;     // the warp's rows of the tile
    const int w_first = q0 + wrow + q_off;    // its first query position
    const int qp[2] = {w_first + g8, w_first + g8 + 8};
    // s / cap as s * (1 / cap): within an ulp, without a division per score
    const float inv_cap = cap > 0.0f ? 1.0f / cap : 0.0f;
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};
    const char* qw = qs + cw * 64 * 128;
    float s[BK / 2];          // S of the tile, then its p
    uint32_t pa[BK / 16][4];  // p (bf16) as P V's A operand
    float corr[2];
    auto k_tile = [&](int stage) { return kv + stage * 2 * S::KB; };

    // Turns: a warpgroup issues a tile's products only after the other
    // has issued its own (named barriers 3 and 4), so that one's softmax
    // runs under the other's products; warpgroup 1 lets warpgroup 0 go
    // first, and skips its last hand-over, which no one waits for.
    auto my_turn = [&]() { repro::named_barrier(3 + cw, 256); };
    auto your_turn = [&](int t) {
      if (cw == 0 || t + 1 < t_end) repro::named_barrier_arrive(4 - cw, 256);
    };
    if (cw == 1 && t_begin < t_end) repro::named_barrier_arrive(3, 256);
    int stage = 0, phase = 0;
    if constexpr (!S::PIPELINE) {
      for (int t = t_begin; t < t_end; ++t) {
        repro::mbar_wait(&full[stage], phase);
        my_turn();
        issue_s<D, BQ, BK>(s, qw, k_tile(stage));
        your_turn(t);
        repro::wgmma_wait<0>();
        repro::fence_regs(s);
        tile_softmax<BK>(s, m, l, corr, t * BK, Sk, causal, window, cap,
                         inv_cap, w_first, qp, tq4);
        rescale_pack<D, BK>(o, corr, s, pa);
        issue_pv<D, BK>(o, pa, k_tile(stage) + S::KB);
        repro::wgmma_wait<0>();
        repro::fence_regs(o);
        repro::keep_regs(pa);
        repro::mbar_arrive(&empty[stage]);
        if (++stage == NSTG) {
          stage = 0;
          phase ^= 1;
        }
      }
    } else {
      // A tile deep (S::PIPELINE): tile t's S product is issued together with
      // tile t-1's P V, and t's softmax runs while P V is in flight.  O is
      // rescaled by t's correction only after t-1's P V has retired, so O
      // goes through the same operations, in the same order, as without
      // the overlap.
      int prev = 0;
      if (t_begin < t_end) {
        repro::mbar_wait(&full[stage], phase);
        my_turn();
        issue_s<D, BQ, BK>(s, qw, k_tile(stage));
        your_turn(t_begin);
        repro::wgmma_wait<0>();
        repro::fence_regs(s);
        tile_softmax<BK>(s, m, l, corr, t_begin * BK, Sk, causal, window,
                         cap, inv_cap, w_first, qp, tq4);
        rescale_pack<D, BK>(o, corr, s, pa);
        prev = stage;
        if (++stage == NSTG) {
          stage = 0;
          phase ^= 1;
        }
      }
      for (int t = t_begin + 1; t < t_end; ++t) {
        repro::mbar_wait(&full[stage], phase);
        my_turn();
        issue_s<D, BQ, BK>(s, qw, k_tile(stage));
        issue_pv<D, BK>(o, pa, k_tile(prev) + S::KB);
        your_turn(t);
        repro::wgmma_wait<1>();   // S of tile t
        repro::fence_regs(s);
        tile_softmax<BK>(s, m, l, corr, t * BK, Sk, causal, window, cap,
                         inv_cap, w_first, qp, tq4);
        repro::wgmma_wait<0>();   // P V of tile t-1
        repro::fence_regs(o);
        repro::keep_regs(pa);
        repro::mbar_arrive(&empty[prev]);
        rescale_pack<D, BK>(o, corr, s, pa);
        prev = stage;
        if (++stage == NSTG) {
          stage = 0;
          phase ^= 1;
        }
      }
      if (t_begin < t_end) {
        issue_pv<D, BK>(o, pa, k_tile(prev) + S::KB);
        repro::wgmma_wait<0>();
        repro::fence_regs(o);
        repro::keep_regs(pa);
        repro::mbar_arrive(&empty[prev]);
      }
    }

    // O / l into this warpgroup's rows of the Q tile (its last S product
    // has retired; the other warpgroup reads only its own rows), then one
    // TMA store a 64-column box
    char* ow = qs + cw * 64 * 128;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const float lc = fmaxf(l[r], 1e-30f);
      const int row = 16 * warp + g8 + 8 * r;   // of the warpgroup's 64
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int col = 8 * j + 2 * tq4;
        *reinterpret_cast<uint32_t*>(
            ow + (col / 64) * BQ * 128 +
            repro::swz128(row * 128 + (col % 64) * 2)) =
            repro::pack_bf16x2(o[4 * j + 2 * r] / lc,
                               o[4 * j + 2 * r + 1] / lc);
      }
      const int i = wrow + g8 + 8 * r;
      if (tq4 == 0 && i < nq)
        lse[static_cast<long>(bh) * Sq + q0 + i] = m[r] + logf(lc);
    }
    repro::fence_proxy_async();
    repro::named_barrier(1 + cw, 128);
    if (lt == 0 && 64 * cw < nq) {
      for (int c = 0; c < CH; ++c)
        repro::tma_store_4d(&to, ow + c * BQ * 128, 64 * c, h, q0 + 64 * cw,
                            b);
      repro::tma_store_commit();
      repro::tma_store_wait<0>();
    }
  }
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 float* lse, int B, int Sq, int Sk, int H, int G, float scale,
                 int causal, int window, float cap, void* stream) {
  using S = HFwd<D>;
  CUtensorMap tq, tk, tv, to;
  int err;
  if ((err = repro::map_heads(&tq, q, B, Sq, H, D, S::BQ)) ||
      (err = repro::map_heads(&tk, k, B, max(Sk, 1), G, D, S::BK)) ||
      (err = repro::map_heads(&tv, v, B, max(Sk, 1), G, D, S::BK)) ||
      (err = repro::map_heads(&to, out, B, Sq, H, D, 64)))
    return err;
  auto kern = flash_fwd_wgmma_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kern),
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(S::smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(B * H, (Sq + S::BQ - 1) / S::BQ);
  kern<<<grid, H_NT, S::smem, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, to, lse, Sq, Sk, H, G, scale, causal, window, cap);
  return static_cast<int>(cudaGetLastError());
}

// D 64, 128 and 256 take the Hopper form; D 16 and 32 (the SMOKE configs'
// widths, under one 128-byte row) the mma.sync form
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                float* lse, int B, int Sq, int Sk, int H, int G, int D,
                float scale, int causal, int window, float cap,
                void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return 0;
  if (G <= 0 || H % G != 0 || Sk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 16:
      return launch_tc<16>(q, k, v, out, lse, B, Sq, Sk, H, G, scale, causal,
                           window, cap, stream);
    case 32:
      return launch_tc<32>(q, k, v, out, lse, B, Sq, Sk, H, G, scale, causal,
                           window, cap, stream);
    case 64:
      return launch_wgmma<64>(q, k, v, out, lse, B, Sq, Sk, H, G, scale,
                              causal, window, cap, stream);
    case 128:
      return launch_wgmma<128>(q, k, v, out, lse, B, Sq, Sk, H, G, scale,
                               causal, window, cap, stream);
    case 256:
      return launch_wgmma<256>(q, k, v, out, lse, B, Sq, Sk, H, G, scale,
                               causal, window, cap, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
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

// D must be 16, 32, 64, 128 or 256 (cudaErrorInvalidValue otherwise).
extern "C" int flash_attention_fwd_bf16(const void* q, const void* k,
                                        const void* v, void* out, float* lse,
                                        int B, int Sq, int Sk, int H, int G,
                                        int D, float scale, int causal,
                                        int window, float cap, void* stream) {
  return launch_bf16(q, k, v, out, lse, B, Sq, Sk, H, G, D, scale, causal,
                     window, cap, stream);
}
