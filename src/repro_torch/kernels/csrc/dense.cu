// The models' projections: y = x @ w with w cast to bf16 as it is loaded,
// and the two products of its backward, dx = dy @ w^T and dw = x^T @ dy.
//
// Replaces the arithmetic the TPU kernels src/repro/kernels/segment_pallas.py
// ::fused_advance_segment / ::fused_reverse_segment run for a decoder body
// (the body is traced into the pallas_call: the chunk scans at :186, :323 and
// the chunk vjp at :395-409): src/repro/models/layers.py::dense
// (y = x @ dt.c(p["w"])) and its vjp, as the attention projections, the
// gated MLP and the mamba in/out projections call it; and, batched over
// the experts (blockIdx.z an expert, a batch stride for each operand),
// src/repro/models/moe.py::_expert_ffn's three einsums (:105-111) and their
// vjps, each expert's rows one matrix of the expert-major buckets
// (csrc/moe.cu), each expert's dw the sum over its own rows.  The port's
// plain versions are repro_torch/kernels/dense.py::dense_fwd_plain /
// dense_bwd_plain and expert_fwd_plain / expert_bwd_plain.
//
// Every call is one product C[P, Q] = sum_r A[p, r] B[r, q] over the
// operands as they lie in memory (nothing is transposed or copied first):
//   forward  P = M, Q = N, R = K: A = x (M, K), B = w (K, N)
//   dx       P = M, Q = K, R = N: A = dy (M, N), B = w^T (w read (K, N))
//   dw       P = K, Q = N, R = M: A = x^T (x read (M, K)), B = dy (M, N)
// x and dy are row-major with a row stride (a view's rows); w is (K, N)
// row-major; the outputs are contiguous.  M, K and N are any sizes: every
// tile edge is masked and the reduction's tail is zero-filled.
//
// bf16 x (dense_tc_kernel): the products run on the tensor cores,
// mma.sync m16n8k16 bf16 with fp32 accumulators.  A block of 8 warps owns a
// 256 x 128 output tile (a warp 64 x 64: 32 accumulator fragments, 128 fp32
// a thread, 8 ldmatrix.x4 a 16-deep step for 32 products) and walks the
// reduction in stages of 64, double-buffered: each operand's next stage
// comes by 16-byte cp.async into shared memory while this one computes.
// An fp32 w lands as fp32, and each thread rounds the chunks it copied to
// bf16 (round to nearest even, the value of .to(torch.bfloat16)) into one of
// two bf16 tiles after its products of the stage before, so no bf16 copy
// of w is written to device memory.  (Of the tile shapes timed with
// tools/dense_variants.py this one was fastest for the fp32-w products.)
// Tiles keep the operands' own layout in shared memory (bf16 rows padded
// by 16 bytes so the 8 row addresses of an ldmatrix fall in distinct
// banks), and the fragments are read with ldmatrix, .trans where an
// operand is read across its rows: w in the forward, dy in dw, and x in
// dw.  A row stride or a base that is not 16-byte aligned takes element
// loads instead of the 16-byte copies (the same values in shared memory,
// so the same bits out).  Blocks walk P fastest, so the blocks resident at
// once read the same columns of B from L2.  Each output is one
// fp32 sum over the reduction in a fixed order (stage by stage from 0, the
// tensor core's order within a stage), rounded once to bf16; dw is rounded
// to bf16 and then written in w's dtype: autograd's value for
// x @ w.to(bf16) followed by the cast's backward.  The forward may add a
// residual in its epilogue (y = round(res + round(x @ w)): a pre-norm
// layer's skip, the plain version's residual + y with both roundings);
// a batched call takes none.  No atomics: a dw tile
// walks all M rows itself (gemma2-2b's and mamba2-370m's dw have 64 to 648
// tiles of 256 x 128).
//
// fp32 x (dense_f32_kernel, an fp32-compute model): a tiled SIMT product
// with fp32 FMAs (no TF32) over the same operands, 64 x 64 tiles of 64
// threads, 8 x 8 outputs a thread, each a sequential sum over r; an fp32 w
// is used as it is, a bf16 one widened.
//
// Bound: operations.  At phi3.5-moe's expert gate/up product (16 experts
// of 1,280 rows, K = 4096, N = 6400) a call does 1.074 TFLOP: 1.086 ms at
// 989 TFLOP/s.  At gemma2-2b's gate/up projection (M = 8192 tokens,
// K = 2304, N = 9216) a call does 348 GFLOP against 0.23 GB: 0.35 ms at
// 989 TFLOP/s against 0.07 ms for the bytes at 3.35 TB/s; every call of the
// two decoders' bodies is above the card's ~295 FLOP a byte.  This is the
// simple form: the Hopper form (TMA loads by a producer warp into a ring of
// stages, wgmma consumer warpgroups, a persistent grid) is the next step.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int TP = 256;   // output tile rows
constexpr int TQ = 128;   // output tile columns
constexpr int TR = 64;    // reduction depth of a stage
constexpr int NS = 2;     // stages in flight
constexpr int WP = 64;    // warp tile rows
constexpr int WQ = 64;    // warp tile columns
constexpr int NT = 32 * (TP / WP) * (TQ / WQ);   // 8 warps, 4 x 2
constexpr int PAD = 8;    // bf16 per shared-memory row: 16 bytes

// operand layouts: A ROW holds A[p][r] at p * ld + r, A COL at r * ld + p;
// B RQ holds B[r][q] at r * ld + q, B QR at q * ld + r
constexpr int ROW = 0, COL = 1, RQ = 0, QR = 1;

// A tile of SR x SC values as it lies in memory (SC the contiguous axis),
// from `src` (the tile's first value) with row stride ld; rows >= nr and
// columns >= nc are zeros.  Stored bf16 in shared memory, rows SC + PAD; an
// fp32 source lands first in a raw fp32 tile (rows SC) and is rounded into
// the bf16 one by convert().
template <int SR, int SC>
struct Tile {
  static constexpr int LDS = SC + PAD;
  static constexpr int SIZE = SR * LDS;
  static constexpr int RAW = SR * SC;
  static constexpr int PER_THREAD = SR * SC / NT;   // values a thread moves

  // vec: src and ld allow 16-byte cp.async (the edge chunk's tail
  // zero-filled); else element loads, stored at once
  __device__ static void load(bf16* dst, const bf16* src, long ld, int nr,
                              int nc, bool vec) {
    const int tid = threadIdx.x;
    if (vec) {
#pragma unroll
      for (int i = 0; i < PER_THREAD / 8; ++i) {
        const int c = tid + i * NT;
        const int r = c / (SC / 8), col = (c % (SC / 8)) * 8;
        const int n = r < nr ? min(max(nc - col, 0), 8) : 0;
        repro::cp_async16(dst + r * LDS + col, n ? src + r * ld + col : src,
                          2 * n);
      }
      return;
    }
#pragma unroll 4
    for (int i = 0; i < PER_THREAD; ++i) {
      const int e = tid + i * NT;
      const int r = e / SC, col = e % SC;
      dst[r * LDS + col] = r < nr && col < nc ? src[r * ld + col]
                                              : __float2bfloat16(0.0f);
    }
  }

  __device__ static void load(float* raw, const float* src, long ld, int nr,
                              int nc, bool vec) {
    const int tid = threadIdx.x;
    if (vec) {
#pragma unroll
      for (int i = 0; i < PER_THREAD / 4; ++i) {
        const int c = tid + i * NT;
        const int r = c / (SC / 4), col = (c % (SC / 4)) * 4;
        const int n = r < nr ? min(max(nc - col, 0), 4) : 0;
        repro::cp_async16(raw + r * SC + col, n ? src + r * ld + col : src,
                          4 * n);
      }
      return;
    }
#pragma unroll
    for (int i = 0; i < PER_THREAD / 4; ++i) {
      const int c = tid + i * NT;
      const int r = c / (SC / 4), col = (c % (SC / 4)) * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        raw[r * SC + col + j] =
            r < nr && col + j < nc ? src[r * ld + col + j] : 0.0f;
    }
  }

  // each value rounded to bf16 (round to nearest even); a thread converts
  // the 4-value chunks it loaded itself, so it needs no barrier after its
  // own cp.async wait
  __device__ static void convert(bf16* dst, const float* raw) {
    const int tid = threadIdx.x;
#pragma unroll
    for (int i = 0; i < PER_THREAD / 4; ++i) {
      const int c = tid + i * NT;
      const int r = c / (SC / 4), col = (c % (SC / 4)) * 4;
      const float4 f = *reinterpret_cast<const float4*>(raw + r * SC + col);
      *reinterpret_cast<uint2*>(dst + r * LDS + col) = make_uint2(
          repro::pack_bf16x2(f.x, f.y), repro::pack_bf16x2(f.z, f.w));
    }
  }
};

template <typename T>
__device__ __forceinline__ T from_bf16(bf16 v);
template <>
__device__ __forceinline__ bf16 from_bf16<bf16>(bf16 v) {
  return v;
}
template <>
__device__ __forceinline__ float from_bf16<float>(bf16 v) {
  return __bfloat162float(v);
}

// round(res + v) in T, the sum in fp32
__device__ __forceinline__ bf16 add_rounded(bf16 res, bf16 v) {
  return __float2bfloat16(__bfloat162float(res) + __bfloat162float(v));
}
__device__ __forceinline__ float add_rounded(float res, float v) {
  return res + v;
}

__device__ __forceinline__ void load_pair(const bf16* src, bf16* v0,
                                          bf16* v1) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(src);
  *v0 = __ushort_as_bfloat16(static_cast<unsigned short>(u & 0xffffu));
  *v1 = __ushort_as_bfloat16(static_cast<unsigned short>(u >> 16));
}
__device__ __forceinline__ void load_pair(const float* src, float* v0,
                                          float* v1) {
  const float2 f = *reinterpret_cast<const float2*>(src);
  *v0 = f.x;
  *v1 = f.y;
}

__device__ __forceinline__ void store_pair(bf16* dst, bf16 v0, bf16 v1) {
  *reinterpret_cast<uint32_t*>(dst) =
      static_cast<uint32_t>(__bfloat16_as_ushort(v0)) |
      (static_cast<uint32_t>(__bfloat16_as_ushort(v1)) << 16);
}
__device__ __forceinline__ void store_pair(float* dst, float v0, float v1) {
  *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
}

// Shared memory: NS stages of A (bf16); NS stages of B (bf16), or, for an
// fp32 B, NS raw fp32 stages and two bf16 tiles they are rounded into (the
// next stage's is written while this one's is read).
template <int AL, int BL, typename TB>
struct TcLayout {
  using A = Tile<AL == ROW ? TP : TR, AL == ROW ? TR : TP>;
  using B = Tile<BL == RQ ? TR : TQ, BL == RQ ? TQ : TR>;
  static constexpr bool STAGED = sizeof(TB) == 4;
  static constexpr size_t a_bytes = sizeof(bf16) * NS * A::SIZE;
  static constexpr size_t smem =
      a_bytes + (STAGED ? sizeof(float) * NS * B::RAW +
                              sizeof(bf16) * 2 * B::SIZE
                        : sizeof(bf16) * NS * B::SIZE);
};

// C (P x Q, row stride ldc, type TC: the bf16 sum in TC) = A . B, A bf16 in
// layout AL, B of type TB (bf16, or fp32 rounded to bf16 in the load) in
// layout BL.  vec_a, vec_b: the operand's base and row stride allow 16-byte
// copies.  Blocks walk P fastest, so the blocks resident at once share
// B's columns.
template <int AL, int BL, typename TB, typename TC>
__global__ void __launch_bounds__(NT)
dense_tc_kernel(const bf16* __restrict__ a, long lda, long sa,
                const TB* __restrict__ b, long ldb, long sb,
                TC* __restrict__ c, const TC* __restrict__ res, long ldc,
                long sc, int P, int Q, int R, int vec_a, int vec_b) {
  using L = TcLayout<AL, BL, TB>;
  // the batch's product (the experts' products: one a blockIdx.z)
  a += blockIdx.z * sa;
  b += blockIdx.z * sb;
  c += blockIdx.z * sc;
  using TA = typename L::A;
  using TBt = typename L::B;
  extern __shared__ float smem[];
  bf16* as = reinterpret_cast<bf16*>(smem);   // NS x A stage
  char* b_region = reinterpret_cast<char*>(smem) + L::a_bytes;
  bf16* bs = reinterpret_cast<bf16*>(b_region);    // NS x B stage (bf16)
  float* braw = reinterpret_cast<float*>(b_region);   // NS x raw (fp32)
  bf16* bcvt = reinterpret_cast<bf16*>(braw + NS * TBt::RAW);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int p0 = blockIdx.x * TP, q0 = blockIdx.y * TQ;
  const int np = min(TP, P - p0), nq = min(TQ, Q - q0);
  const int wp = (warp / (TQ / WQ)) * WP, wq = (warp % (TQ / WQ)) * WQ;

  // stage t's operands into slot t % NS (tile origin, valid rows and
  // columns as they lie in memory)
  auto load_stage = [&](int t) {
    const int r0 = t * TR, slot = t % NS;
    if (AL == ROW)
      TA::load(as + slot * TA::SIZE, a + p0 * lda + r0, lda, np, R - r0,
               vec_a);
    else
      TA::load(as + slot * TA::SIZE, a + r0 * lda + p0, lda, R - r0, np,
               vec_a);
    const TB* src = BL == RQ ? b + r0 * ldb + q0 : b + q0 * ldb + r0;
    const int nr = BL == RQ ? R - r0 : nq, nc = BL == RQ ? nq : R - r0;
    if constexpr (L::STAGED)
      TBt::load(braw + slot * TBt::RAW, src, ldb, nr, nc, vec_b);
    else
      TBt::load(bs + slot * TBt::SIZE, src, ldb, nr, nc, vec_b);
  };

  float acc[WP / 16][WQ / 8][4];
#pragma unroll
  for (int i = 0; i < WP / 16; ++i)
#pragma unroll
    for (int j = 0; j < WQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  const int nt = (R + TR - 1) / TR;
#pragma unroll
  for (int t = 0; t < NS - 1; ++t) {
    if (t < nt) load_stage(t);
    repro::cp_async_commit();
  }
  if constexpr (L::STAGED) {   // stage 0's B rounded before the loop
    repro::cp_async_wait<NS - 2>();
    if (nt > 0) TBt::convert(bcvt, braw);
  }
  for (int t = 0; t < nt; ++t) {
    repro::cp_async_wait<NS - 2>();   // stage t has landed ...
    __syncthreads();   // ... for every thread, and stage t-1 is consumed
    if (t + NS - 1 < nt) load_stage(t + NS - 1);   // into t-1's slot
    repro::cp_async_commit();
    const int slot = t % NS;
    const bf16* at = as + slot * TA::SIZE;
    const bf16* bt = L::STAGED ? bcvt + (t & 1) * TBt::SIZE
                               : bs + slot * TBt::SIZE;
#pragma unroll
    for (int kk = 0; kk < TR / 16; ++kk) {
      uint32_t af[WP / 16][4], bf[WQ / 16][4];
#pragma unroll
      for (int i = 0; i < WP / 16; ++i) {
        const int pr = wp + i * 16;
        if (AL == ROW)
          repro::ldmatrix_x4(af[i], at + (pr + (lane & 15)) * TA::LDS +
                                        kk * 16 + (lane >> 4) * 8);
        else
          repro::ldmatrix_x4_trans(
              af[i], at + (kk * 16 + (lane & 7) + (lane >> 4) * 8) * TA::LDS +
                         pr + ((lane >> 3) & 1) * 8);
      }
#pragma unroll
      for (int j = 0; j < WQ / 16; ++j) {
        const int qc = wq + j * 16;
        if (BL == RQ)
          repro::ldmatrix_x4_trans(
              bf[j], bt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                              TBt::LDS +
                         qc + (lane >> 4) * 8);
        else
          repro::ldmatrix_x4(bf[j], bt + (qc + (lane & 7) + (lane >> 4) * 8) *
                                             TBt::LDS +
                                        kk * 16 + ((lane >> 3) & 1) * 8);
      }
#pragma unroll
      for (int i = 0; i < WP / 16; ++i)
#pragma unroll
        for (int j = 0; j < WQ / 8; ++j)
          repro::mma_bf16_16816(acc[i][j], af[i], bf[j >> 1] + 2 * (j & 1));
    }
    if constexpr (L::STAGED) {
      // the next stage's B, rounded while the other warps still compute
      // (its bf16 tile was last read in stage t-1, before this stage's
      // barrier; the next barrier publishes it)
      if (t + 1 < nt) {
        repro::cp_async_wait<NS - 2>();
        TBt::convert(bcvt + ((t + 1) & 1) * TBt::SIZE,
                     braw + ((t + 1) % NS) * TBt::RAW);
      }
    }
  }
  repro::cp_async_wait<0>();

  // each sum rounded once to bf16, then written in TC (plus the residual,
  // rounded again): a lane's two neighbouring columns in one store where
  // both are in range and aligned
  const bool pairs = ldc % 2 == 0 &&
                     (reinterpret_cast<uintptr_t>(c) % (2 * sizeof(TC))) == 0;
  const bool res_pairs =
      pairs && (reinterpret_cast<uintptr_t>(res) % (2 * sizeof(TC))) == 0;
#pragma unroll
  for (int i = 0; i < WP / 16; ++i)
#pragma unroll
    for (int j = 0; j < WQ / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = p0 + wp + i * 16 + g + 8 * h;
        const int q = q0 + wq + j * 8 + 2 * tq;
        if (p >= P) continue;
        TC v0 = from_bf16<TC>(__float2bfloat16(acc[i][j][2 * h]));
        TC v1 = from_bf16<TC>(__float2bfloat16(acc[i][j][2 * h + 1]));
        if (res) {
          const TC* rs = res + p * ldc + q;
          if (res_pairs && q + 1 < Q) {
            TC r0, r1;
            load_pair(rs, &r0, &r1);
            v0 = add_rounded(r0, v0);
            v1 = add_rounded(r1, v1);
          } else {
            if (q < Q) v0 = add_rounded(rs[0], v0);
            if (q + 1 < Q) v1 = add_rounded(rs[1], v1);
          }
        }
        TC* dst = c + p * ldc + q;
        if (pairs && q + 1 < Q) {
          store_pair(dst, v0, v1);
        } else {
          if (q < Q) dst[0] = v0;
          if (q + 1 < Q) dst[1] = v1;
        }
      }
}

// The fp32 product: C = A . B with A (p, r) at a[p * sap + r * sar], B (r,
// q) at b[r * sbr + q * sbq], each output one sequential fp32 FMA sum over
// r, written in TC (plus res where given).  64 threads, 8 x 8 outputs each.
constexpr int FT = 64;    // tile rows and columns
constexpr int FR = 32;    // reduction depth of a stage
constexpr int FNT = 64;   // threads

template <typename T>
__device__ __forceinline__ float widen(T v);
template <>
__device__ __forceinline__ float widen<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float widen<bf16>(bf16 v) {
  return __bfloat162float(v);
}

template <typename TB, typename TC>
__global__ void __launch_bounds__(FNT)
dense_f32_kernel(const float* __restrict__ a, long sap, long sar, long sa,
                 const TB* __restrict__ b, long sbr, long sbq, long sb,
                 TC* __restrict__ c, const TC* __restrict__ res, long ldc,
                 long sc, int P, int Q, int R) {
  a += blockIdx.z * sa;
  b += blockIdx.z * sb;
  c += blockIdx.z * sc;
  __shared__ float as[FR][FT + 1];
  __shared__ float bs[FR][FT + 1];
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int p0 = blockIdx.x * FT, q0 = blockIdx.y * FT;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  // the operand's contiguous axis along the threads (coalesced loads)
  const bool a_r_fast = sar == 1, b_q_fast = sbq == 1;
  for (int r0 = 0; r0 < R; r0 += FR) {
    for (int e = tid; e < FR * FT; e += FNT) {
      const int r = a_r_fast ? e % FR : e / FT;
      const int p = a_r_fast ? e / FR : e % FT;
      as[r][p] = p0 + p < P && r0 + r < R
                     ? a[(p0 + p) * sap + (r0 + r) * sar] : 0.0f;
      const int rb = b_q_fast ? e / FT : e % FR;
      const int q = b_q_fast ? e % FT : e / FR;
      bs[rb][q] = q0 + q < Q && r0 + rb < R
                      ? widen(b[(r0 + rb) * sbr + (q0 + q) * sbq]) : 0.0f;
    }
    __syncthreads();
    for (int r = 0; r < FR; ++r) {
      float av[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        av[i] = as[r][ty + 8 * i];
        bv[i] = bs[r][tx + 8 * i];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int p = p0 + ty + 8 * i, q = q0 + tx + 8 * j;
      if (p >= P || q >= Q) continue;
      const TC v = repro::from_f32<TC>(acc[i][j]);
      c[p * ldc + q] = res ? add_rounded(res[p * ldc + q], v) : v;
    }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Batch: `batch` products, the i-th at a + i sa, b + i sb, c + i sc
// (strides in elements).
struct Batch {
  int n;
  long sa, sb, sc;
};

template <int AL, int BL, typename TB, typename TC>
int launch_tc(const void* a, long lda, const void* b, long ldb, void* c,
              long ldc, int P, int Q, int R, Batch bt, void* stream,
              const void* res = nullptr) {
  using L = TcLayout<AL, BL, TB>;
  const int vec_a = aligned16(a) && lda % 8 == 0 && bt.sa % 8 == 0;
  const long vb = 16 / sizeof(TB);
  const int vec_b = aligned16(b) && ldb % vb == 0 && bt.sb % vb == 0;
  auto kern = dense_tc_kernel<AL, BL, TB, TC>;
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kern),
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L::smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((P + TP - 1) / TP, (Q + TQ - 1) / TQ, bt.n);
  kern<<<grid, NT, L::smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(a), lda, bt.sa, static_cast<const TB*>(b),
      ldb, bt.sb, static_cast<TC*>(c), static_cast<const TC*>(res), ldc,
      bt.sc, P, Q, R, vec_a, vec_b);
  return static_cast<int>(cudaGetLastError());
}

template <typename TB, typename TC>
int launch_f32(const void* a, long sap, long sar, const void* b, long sbr,
               long sbq, void* c, long ldc, int P, int Q, int R, Batch bt,
               void* stream, const void* res = nullptr) {
  auto kern = dense_f32_kernel<TB, TC>;
  const dim3 grid((P + FT - 1) / FT, (Q + FT - 1) / FT, bt.n);
  kern<<<grid, FNT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), sap, sar, bt.sa,
      static_cast<const TB*>(b), sbr, sbq, bt.sb, static_cast<TC*>(c),
      static_cast<const TC*>(res), ldc, bt.sc, P, Q, R);
  return static_cast<int>(cudaGetLastError());
}

// the most output columns a launch takes (gridDim.y of 64-column tiles)
constexpr long MAX_Q = 65535L * FT;

constexpr int MAX_BATCH = 65535;   // gridDim.z

bool empty_or_too_big(int P, int Q, int batch, int* err) {
  *err = 0;
  if (Q > MAX_Q || batch > MAX_BATCH)
    *err = static_cast<int>(cudaErrorInvalidValue);
  return P <= 0 || Q <= 0 || batch <= 0 || *err != 0;
}

}  // namespace

// x (M, K) with row stride ldx, bf16 (x_bf16) or fp32; w (K, N) contiguous,
// bf16 (w_bf16) or fp32; y (M, N) contiguous in x's dtype, and res (M, N)
// contiguous in x's dtype or null: y = res + x @ w.  K and N at most
// 65535 x 64 (cudaErrorInvalidValue otherwise).  `batch` products (at most
// 65535), the i-th at x + i sx, w + i sw, y + i sy (strides in elements):
// the experts' products, one an expert (no residual).
extern "C" int dense_fwd(const void* x, long ldx, const void* w, void* y,
                         const void* res, int M, int K, int N, int x_bf16,
                         int w_bf16, int batch, long sx, long sw, long sy,
                         void* stream) {
  int err;
  if (empty_or_too_big(M, N, batch, &err)) return err;
  if (res && batch != 1) return static_cast<int>(cudaErrorInvalidValue);
  const Batch bt{batch, sx, sw, sy};
  if (x_bf16)
    return w_bf16 ? launch_tc<ROW, RQ, bf16, bf16>(x, ldx, w, N, y, N, M, N,
                                                   K, bt, stream, res)
                  : launch_tc<ROW, RQ, float, bf16>(x, ldx, w, N, y, N, M, N,
                                                    K, bt, stream, res);
  return w_bf16 ? launch_f32<bf16, float>(x, ldx, 1, w, N, 1, y, N, M, N, K,
                                          bt, stream, res)
                : launch_f32<float, float>(x, ldx, 1, w, N, 1, y, N, M, N, K,
                                           bt, stream, res);
}

// dy (M, N) with row stride lddy, in x's dtype; dx (M, K) contiguous.
// Batched as dense_fwd: dy + i sdy, w + i sw, dx + i sdx.
extern "C" int dense_dx(const void* dy, long lddy, const void* w, void* dx,
                        int M, int K, int N, int x_bf16, int w_bf16,
                        int batch, long sdy, long sw, long sdx,
                        void* stream) {
  int err;
  if (empty_or_too_big(M, K, batch, &err)) return err;
  const Batch bt{batch, sdy, sw, sdx};
  if (x_bf16)
    return w_bf16 ? launch_tc<ROW, QR, bf16, bf16>(dy, lddy, w, N, dx, K, M,
                                                   K, N, bt, stream)
                  : launch_tc<ROW, QR, float, bf16>(dy, lddy, w, N, dx, K, M,
                                                    K, N, bt, stream);
  return w_bf16 ? launch_f32<bf16, float>(dy, lddy, 1, w, 1, N, dx, K, M, K,
                                          N, bt, stream)
                : launch_f32<float, float>(dy, lddy, 1, w, 1, N, dx, K, M, K,
                                           N, bt, stream);
}

// dw (K, N) contiguous in w's dtype: the sum over all M rows.  Batched as
// dense_fwd: x + i sx, dy + i sdy, dw + i sdw (each expert's dw the sum
// over its own rows).
extern "C" int dense_dw(const void* x, long ldx, const void* dy, long lddy,
                        void* dw, int M, int K, int N, int x_bf16, int w_bf16,
                        int batch, long sx, long sdy, long sdw,
                        void* stream) {
  int err;
  if (empty_or_too_big(K, N, batch, &err)) return err;
  const Batch bt{batch, sx, sdy, sdw};
  if (x_bf16)
    return w_bf16 ? launch_tc<COL, RQ, bf16, bf16>(x, ldx, dy, lddy, dw, N,
                                                   K, N, M, bt, stream)
                  : launch_tc<COL, RQ, bf16, float>(x, ldx, dy, lddy, dw, N,
                                                    K, N, M, bt, stream);
  return w_bf16 ? launch_f32<float, bf16>(x, 1, ldx, dy, lddy, 1, dw, N, K,
                                          N, M, bt, stream)
                : launch_f32<float, float>(x, 1, ldx, dy, lddy, 1, dw, N, K,
                                           N, M, bt, stream);
}
