// The models' projections: y = x @ w with w rounded to bf16, and the two
// products of its backward, dx = dy @ w^T and dw = x^T @ dy.
//
// Replaces the arithmetic the TPU kernels src/repro/kernels/segment_pallas.py
// ::fused_advance_segment / ::fused_reverse_segment run for a decoder body
// (the body is traced into the pallas_call: the chunk scans at :186, :323 and
// the chunk vjp at :395-409): src/repro/models/layers.py::dense
// (y = x @ dt.c(p["w"])) and its vjp, as the attention projections, the
// gated MLP and the mamba in/out projections call it; and, batched over
// the experts (a batch index for each operand, with its stride),
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
// bf16 x, operands TMA can describe (dense_wgmma_kernel, the Hopper form):
// a persistent grid of one block an SM walks the output tiles (128 x 256)
// in groups of 16 rows of tiles, P fastest within a group, so the blocks
// resident at once read the same rows of A and columns of B from L2.
// Warpgroup 0 is the producer: one thread keeps a ring of 4 stages of
// 64-deep slabs of A and B in flight by TMA (128-byte swizzle, zeros past
// every edge), each stage's bytes completed on its `full` mbarrier.
// Warpgroups 1 and 2 consume: each owns 64 rows of the tile and runs one
// wgmma m64n256k16 per 16-deep step with both operands read from shared
// memory through descriptors; an operand that lies MN-major in memory (w in
// the forward, x and dy in dw) is read so through the transpose bit, so
// nothing is transposed.  A stage is released (its `empty` mbarrier) once
// the next stage's wgmmas are issued and its own have retired, so one
// group of products is always in flight; the producer meanwhile fills the
// ring for the next tile while the consumers run this tile's epilogue,
// which goes out through shared memory by TMA (chunks of 64 rows x 128
// bytes, two buffers a consumer in turn) where the output's layout allows,
// else by each thread's own stores.  Registers: the producer gives its own
// back (setmaxnreg 40) and the consumers take 232 for their 128 fp32
// accumulators.
//   The fp32 weight: wgmma reads a bf16 B only from shared memory, so an
// fp32 w takes one of two forms, chosen by the product's rows (the
// wrapper's dense.W32_ROWS, 4096; phase timing times both).  Few rows
// (the experts' 1,280): dense_w32_kernel computes y^T = w^T x^T (dx^T = w
// dy^T) with w the A operand, which wgmma reads from registers: each
// stage's fp32 slab lands by TMA and each thread rounds its fragment to
// bf16 in registers (round to nearest even, the value of
// .to(torch.bfloat16)); an in-flight register-A wgmma still reads its
// registers, so each stage's group retires before the next stage's
// fragments are loaded; the output tile is stored transposed by TMA.  Many
// rows (the decoders' 8,192 and 16,384): w is first rounded into a bf16
// copy that the wrapper allocates for the call and frees after it
// (dense_cast_kernel: 6 bytes a weight, ~0.04 ms at gemma2-2b's gate/up
// weight), and the products run as above; the copy is cheap beside a
// product of many rows, the register form's retired stages are not.  Of
// the other options, a converter warpgroup rewriting each fp32 stage would
// need a 64 KB fp32 slab beside the bf16 ring (it holds three stages at
// most), and a cluster sharing one converted tile needs cluster launches.
// No bf16 copy of w outlives the call or is saved for the backward.
//   dw where the output tiles do not fill the card (gemma2-2b's wq, wk/wv,
// wo, mamba2-370m's in_proj and out_proj) splits the reduction over M into
// a fixed number of slices (dense_dw_slices: 1 to 4, from the tile count,
// the SM count and a cost of the partials' bytes); each slice writes its
// fp32 partial tile into a scratch the wrapper allocates, and
// dense_reduce_kernel sums the slices in index order and rounds once.  No
// atomics anywhere: two calls give the same bits.
//   Each output is one fp32 sum over the reduction in a fixed order (stage by
// stage, the tensor core's order within a stage), rounded once to bf16; dw
// is rounded to bf16 and then written in w's dtype: autograd's value for x @
// w.to(bf16) followed by the cast's backward.  The forward may add a
// residual in its epilogue (y = round(res + round(x @ w)): a pre-norm
// layer's skip, the plain version's residual + y with both roundings); a
// batched call takes none.
//
// bf16 x whose base, row stride or batch stride TMA cannot take (not 16-byte
// aligned; the wrapper decides by layout and counts these launches apart,
// dense.py's `mma_sync` counters) keeps the Ampere form (dense_tc_kernel):
// mma.sync m16n8k16 bf16 with fp32 accumulators, 8 warps on a 256 x 128
// tile (a warp 64 x 64), two cp.async stages of 64, tiles in the operands'
// own layout with rows padded by 16 bytes (ldmatrix, .trans across rows),
// an fp32 w rounded to bf16 by the threads that copied it, element loads
// where a 16-byte copy is not aligned.  Same sums, roundings and epilogue.
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
// two decoders' bodies is above the card's ~295 FLOP a byte.
#include <algorithm>

#include "hopper.cuh"

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

// ------------------------------------------- bf16, the Hopper form (wgmma)

constexpr int GP = 128;   // output tile rows: two consumer warpgroups of 64
constexpr int GQ = 256;   // output tile columns: one m64n256 wgmma
constexpr int GR = 64;    // reduction depth of a stage: one 128-byte row
constexpr int GS = 4;     // stages in the ring
constexpr int GNT = 384;  // warpgroup 0 the producer, 1 and 2 the consumers
constexpr int GA = GP * GR * 2;   // an A stage: 16 KB
constexpr int GB = GR * GQ * 2;   // a B stage: 32 KB
constexpr int GSTAGE = GA + GB;
constexpr int BOX = 64 * GR * 2;  // one 64 x 64 box of 128-byte rows: 8 KB
// the epilogue's buffers: two of 64 rows x 128 bytes a consumer
constexpr int OUT = 2 * 2 * 64 * 128;
constexpr size_t GSMEM =
    1024 + GS * GSTAGE + OUT + 2 * GS * sizeof(uint64_t);

constexpr int GROUP = 16;   // P tiles a group of the walk

// A work unit of the persistent walk: the output tile (pt, qt) of batch b,
// reduction slice sl.  The tiles go in groups of GROUP rows of tiles, P
// fastest within a group, so the units resident at once (one an SM) share
// both their A rows and their B columns in L2.
struct Unit {
  int pt, qt, sl, b;
};
__device__ __forceinline__ Unit unit_of(long u, int np, int nq, int slices) {
  Unit w;
  const long tiles = static_cast<long>(np) * nq;
  const int idx = static_cast<int>(u % tiles);
  u /= tiles;
  const int first = idx / (GROUP * nq) * GROUP;
  const int gp = min(GROUP, np - first);
  const int rem = idx - first * nq;
  w.pt = first + rem % gp;
  w.qt = rem / gp;
  w.sl = static_cast<int>(u % slices);
  w.b = static_cast<int>(u / slices);
  return w;
}

// This consumer's 64 x GQ tile of `acc` stored by TMA through shared
// memory: chunks of 64 rows x 128 bytes (E = 128 / sizeof(T) columns), the
// threads' values written in the swizzle into one of the consumer's two
// buffers in turn while the other's store may still be reading.  PART: the
// fp32 sums as they are (a split's partial); else each rounded to bf16 and
// written in T, plus the residual (rounded again).  The box at (q0, pr0,
// bz) of `map`; the tensor's edges clip the stores.
template <typename T, bool PART>
__device__ __forceinline__ void epilogue_tma(const float (&acc)[GQ / 2],
                                             const CUtensorMap* map,
                                             char* ob, int cw, int q0,
                                             int pr0, int bz, const T* res,
                                             long ldc, int P, int Q) {
  constexpr int E = 128 / static_cast<int>(sizeof(T));
  const int lt = threadIdx.x % 128, warp = lt / 32;
  const int g = (lt % 32) / 4, tq = lt % 4;
#pragma unroll
  for (int c = 0; c < GQ / E; ++c) {
    char* buf = ob + (c & 1) * 64 * 128;
    if (lt == 0) repro::tma_store_wait<1>();   // the buffer's last store read
    repro::named_barrier(1 + cw, 128);
#pragma unroll
    for (int jj = 0; jj < E / 8; ++jj) {
      const int j = c * (E / 8) + jj;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * warp + g + 8 * h;
        T v0, v1;
        if constexpr (PART) {
          v0 = acc[4 * j + 2 * h];
          v1 = acc[4 * j + 2 * h + 1];
        } else {
          v0 = from_bf16<T>(__float2bfloat16(acc[4 * j + 2 * h]));
          v1 = from_bf16<T>(__float2bfloat16(acc[4 * j + 2 * h + 1]));
          const int p = pr0 + r, q = q0 + 8 * j + 2 * tq;
          if (res && p < P) {
            if (q < Q) v0 = add_rounded(res[p * ldc + q], v0);
            if (q + 1 < Q) v1 = add_rounded(res[p * ldc + q + 1], v1);
          }
        }
        store_pair(reinterpret_cast<T*>(
                       buf + repro::swz128(static_cast<uint32_t>(
                                 r * 128 + (jj * 8 + 2 * tq) *
                                               static_cast<int>(sizeof(T))))),
                   v0, v1);
      }
    }
    repro::fence_proxy_async();
    repro::named_barrier(1 + cw, 128);
    if (lt == 0) {
      repro::tma_store_3d(map, buf, q0 + c * E, pr0, bz);
      repro::tma_store_commit();
    }
  }
}

// C (P x Q, row stride ldc, batch stride sc, type TC) = A . B over the
// tensor maps `ta` (A: AL == ROW rows p of r, COL rows r of p) and `tb` (B:
// BL == RQ rows r of q, QR rows q of r), each 3D (columns, rows, batch).
// slices > 1: slice sl of the reduction writes its fp32 partial tile to
// part + ((b slices + sl) P + p) Q + q instead (dense_reduce_kernel sums
// them).  tma_c: the tiles go out through shared memory by TMA, `tc` C's
// map (3D: columns, rows, batch) or the partials' (columns, rows, batch x
// slices); else each thread stores its own values.
template <int AL, int BL, typename TC>
__global__ void __launch_bounds__(GNT, 1)
dense_wgmma_kernel(const __grid_constant__ CUtensorMap ta,
                   const __grid_constant__ CUtensorMap tb,
                   const __grid_constant__ CUtensorMap tc, int tma_c,
                   TC* __restrict__ c, const TC* __restrict__ res, long ldc,
                   long sc, int P, int Q, int R, int batch, int slices,
                   float* __restrict__ part) {
  extern __shared__ float smem[];
  char* ring = repro::align1024(smem);
  char* outbuf = ring + GS * GSTAGE;   // the epilogue's buffers
  uint64_t* full = reinterpret_cast<uint64_t*>(outbuf + OUT);
  uint64_t* empty = full + GS;
  const int np = (P + GP - 1) / GP, nq = (Q + GQ - 1) / GQ;
  const int steps = (R + GR - 1) / GR;
  const int per = (steps + slices - 1) / slices;   // stages a slice
  const long units = static_cast<long>(batch) * slices * nq * np;
  if (threadIdx.x == 0) {
    for (int s = 0; s < GS; ++s) {
      repro::mbar_init(&full[s], 1);
      repro::mbar_init(&empty[s], 2 * 128);
    }
    repro::mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    // the producer: one thread issues every copy
    repro::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int stage = 0, phase = 0;
      for (long u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit w = unit_of(u, np, nq, slices);
        const int p0 = w.pt * GP, q0 = w.qt * GQ;
        const int t1 = min(steps, (w.sl + 1) * per);
        for (int t = w.sl * per; t < t1; ++t) {
          repro::mbar_wait(&empty[stage], phase ^ 1);
          char* st = ring + stage * GSTAGE;
          uint64_t* bar = &full[stage];
          repro::mbar_arrive_expect_tx(bar, GSTAGE);
          const int r0 = t * GR;
          if (AL == ROW) {   // 128 rows of 64 r
            repro::tma_load_3d(st, &ta, bar, r0, p0, w.b);
          } else {           // 64 rows of r, 64 p a box
#pragma unroll
            for (int j = 0; j < GP / 64; ++j)
              repro::tma_load_3d(st + j * BOX, &ta, bar, p0 + 64 * j, r0,
                                 w.b);
          }
          char* bs = st + GA;
          if (BL == RQ) {    // 64 rows of r, 64 q a box
#pragma unroll
            for (int j = 0; j < GQ / 64; ++j)
              repro::tma_load_3d(bs + j * BOX, &tb, bar, q0 + 64 * j, r0,
                                 w.b);
          } else {           // 256 rows of 64 r
            repro::tma_load_3d(bs, &tb, bar, r0, q0, w.b);
          }
          if (++stage == GS) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    repro::setmaxnreg_inc<232>();
    const int cw = threadIdx.x / 128 - 1;   // rows 64 cw .. of the tile
    const int lt = threadIdx.x % 128, warp = lt / 32, lane = lt % 32;
    const int g = lane / 4, tq = lane % 4;
    int stage = 0, phase = 0;
    float acc[GQ / 2];
    const bool pairs = ldc % 2 == 0 &&
                       (reinterpret_cast<uintptr_t>(c) % (2 * sizeof(TC))) ==
                           0;
    const bool res_pairs =
        pairs && (reinterpret_cast<uintptr_t>(res) % (2 * sizeof(TC))) == 0;
    for (long u = blockIdx.x; u < units; u += gridDim.x) {
      const Unit w = unit_of(u, np, nq, slices);
      const int p0 = w.pt * GP, q0 = w.qt * GQ;
      const int t1 = min(steps, (w.sl + 1) * per);
#pragma unroll
      for (int i = 0; i < GQ / 2; ++i) acc[i] = 0.0f;
      int prev = -1;
      for (int t = w.sl * per; t < t1; ++t) {
        repro::mbar_wait(&full[stage], phase);
        const char* st = ring + stage * GSTAGE;
        const char* as = st + cw * (AL == ROW ? 64 * 128 : BOX);
        const char* bs = st + GA;
        repro::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < GR / 16; ++kk) {
          const uint64_t da = AL == ROW
                                  ? repro::desc128(as + 32 * kk, 16, 1024)
                                  : repro::desc128(as + 2048 * kk, BOX, 1024);
          const uint64_t db = BL == QR
                                  ? repro::desc128(bs + 32 * kk, 16, 1024)
                                  : repro::desc128(bs + 2048 * kk, BOX, 1024);
          repro::wgmma_ss<GQ, AL == COL, BL == RQ>(acc, da, db);
        }
        repro::wgmma_commit();
        repro::wgmma_wait<1>();   // the stage before this one is read
        if (prev >= 0) repro::mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == GS) {
          stage = 0;
          phase ^= 1;
        }
      }
      repro::wgmma_wait<0>();
      repro::fence_regs(acc);
      if (prev >= 0) repro::mbar_arrive(&empty[prev]);

      if (tma_c) {
        char* ob = outbuf + cw * 2 * 64 * 128;
        if (slices > 1)
          epilogue_tma<float, true>(acc, &tc, ob, cw, q0, p0 + 64 * cw,
                                    w.b * slices + w.sl, nullptr, 0, P, Q);
        else
          epilogue_tma<TC, false>(acc, &tc, ob, cw, q0, p0 + 64 * cw, w.b,
                                  res, ldc, P, Q);
        continue;
      }
      // the epilogue: a thread's rows p0 + 64 cw + 16 warp + g (+ 8), its
      // columns 8 j + 2 tq (+ 1)
      const int pr = p0 + 64 * cw + 16 * warp + g;
      if (slices > 1) {
        float* pb = part + (static_cast<long>(w.b) * slices + w.sl) *
                               static_cast<long>(P) * Q;
        const bool fpairs = Q % 2 == 0;
#pragma unroll
        for (int j = 0; j < GQ / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int p = pr + 8 * h, q = q0 + 8 * j + 2 * tq;
            if (p >= P) continue;
            float* dst = pb + static_cast<long>(p) * Q + q;
            if (fpairs && q + 1 < Q) {
              store_pair(dst, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
            } else {
              if (q < Q) dst[0] = acc[4 * j + 2 * h];
              if (q + 1 < Q) dst[1] = acc[4 * j + 2 * h + 1];
            }
          }
        continue;
      }
      TC* cb = c + w.b * sc;
#pragma unroll
      for (int j = 0; j < GQ / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = pr + 8 * h, q = q0 + 8 * j + 2 * tq;
          if (p >= P) continue;
          TC v0 = from_bf16<TC>(__float2bfloat16(acc[4 * j + 2 * h]));
          TC v1 = from_bf16<TC>(__float2bfloat16(acc[4 * j + 2 * h + 1]));
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
          TC* dst = cb + p * ldc + q;
          if (pairs && q + 1 < Q) {
            store_pair(dst, v0, v1);
          } else {
            if (q < Q) dst[0] = v0;
            if (q + 1 < Q) dst[1] = v1;
          }
        }
    }
    // the block's shared memory must outlive the stores reading it
    if (tma_c && lt == 0) repro::tma_store_wait<0>();
  }
}

// ------------------------- bf16 x, fp32 w: the weight as the register A
//
// The products whose B would be the fp32 weight (the forward and dx) run
// transposed, so the weight is the A operand, which wgmma reads from
// registers: forward y^T = w^T x^T, dx^T = w dy^T.  Each stage lands the
// fp32 weight slab by TMA (boxes of 32 fp32, one 128-byte row); each
// consumer thread loads its A fragment of a 16-deep step from it and rounds
// it to bf16 (round to nearest even, .to(torch.bfloat16)) in registers; B
// is x or dy (K-major, as they lie).  No bf16 copy of the weight exists at
// any point.  The output tile (128 weight columns x 256 rows of x) is
// stored transposed through shared memory by TMA.

constexpr int WSTAGES = 3;
constexpr int WA = 64 * GP * 4;       // the fp32 weight slab: 32 KB
constexpr int WSTAGE = WA + GB;       // and 256 rows of x or dy: 32 KB
constexpr size_t WSMEM =
    1024 + WSTAGES * WSTAGE + OUT + 2 * WSTAGES * sizeof(uint64_t);

// C^T tile: P' = the weight's output axis (N forward, K dx), the rows of C
// (M) the wgmma N; R' the reduction (K forward, N dx).  DX 0: the weight
// slab is rows r of 128 p (w (K, N) read MN-major: 4 boxes of 32 p x 64 r);
// DX 1: rows p of 64 r (w read K-major: 2 boxes of 32 r x 128 p).  `tc`:
// C's map (columns P', rows M, batch), boxes of 64 x 64.
template <int DX>
__global__ void __launch_bounds__(GNT, 1)
dense_w32_kernel(const __grid_constant__ CUtensorMap ta,
                 const __grid_constant__ CUtensorMap tb,
                 const __grid_constant__ CUtensorMap tc,
                 const bf16* __restrict__ res, long ldc, int P, int M, int R,
                 int batch) {
  extern __shared__ float smem[];
  char* ring = repro::align1024(smem);
  char* outbuf = ring + WSTAGES * WSTAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(outbuf + OUT);
  uint64_t* empty = full + WSTAGES;
  const int np = (P + GP - 1) / GP, nm = (M + GQ - 1) / GQ;
  const int steps = (R + GR - 1) / GR;
  const long units = static_cast<long>(batch) * nm * np;
  if (threadIdx.x == 0) {
    for (int s = 0; s < WSTAGES; ++s) {
      repro::mbar_init(&full[s], 1);
      repro::mbar_init(&empty[s], 2 * 128);
    }
    repro::mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    repro::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int stage = 0, phase = 0;
      for (long u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit w = unit_of(u, np, nm, 1);
        const int p0 = w.pt * GP, m0 = w.qt * GQ;
        for (int t = 0; t < steps; ++t) {
          repro::mbar_wait(&empty[stage], phase ^ 1);
          char* st = ring + stage * WSTAGE;
          uint64_t* bar = &full[stage];
          repro::mbar_arrive_expect_tx(bar, WSTAGE);
          const int r0 = t * GR;
          if (DX == 0) {
#pragma unroll
            for (int j = 0; j < GP / 32; ++j)
              repro::tma_load_3d(st + j * 64 * 128, &ta, bar, p0 + 32 * j,
                                 r0, w.b);
          } else {
#pragma unroll
            for (int j = 0; j < GR / 32; ++j)
              repro::tma_load_3d(st + j * GP * 128, &ta, bar, r0 + 32 * j,
                                 p0, w.b);
          }
          repro::tma_load_3d(st + WA, &tb, bar, r0, m0, w.b);
          if (++stage == WSTAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    repro::setmaxnreg_inc<232>();
    const int cw = threadIdx.x / 128 - 1;   // weight columns 64 cw ..
    const int lt = threadIdx.x % 128, warp = lt / 32, lane = lt % 32;
    const int g = lane / 4, tq = lane % 4;
    const int pa = 64 * cw + 16 * warp + g;   // this thread's A rows (+ 8)
    int stage = 0, phase = 0;
    float acc[GQ / 2];
    for (long u = blockIdx.x; u < units; u += gridDim.x) {
      const Unit w = unit_of(u, np, nm, 1);
      const int p0 = w.pt * GP, m0 = w.qt * GQ;
#pragma unroll
      for (int i = 0; i < GQ / 2; ++i) acc[i] = 0.0f;
      for (int t = 0; t < steps; ++t) {
        repro::mbar_wait(&full[stage], phase);
        const char* st = ring + stage * WSTAGE;
        // the A fragments of the stage's four 16-deep steps, rounded
        uint32_t af[GR / 16][4];
#pragma unroll
        for (int kk = 0; kk < GR / 16; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int p = pa + 8 * (i & 1);
            const int r = 16 * kk + 2 * tq + 8 * (i >> 1);
            float2 v;
            if (DX == 0) {   // (r, p) in box p / 32 of 64 rows r
              const char* box = st + (p / 32) * 64 * 128;
              v.x = *reinterpret_cast<const float*>(
                  box + repro::swz128(r * 128 + (p % 32) * 4));
              v.y = *reinterpret_cast<const float*>(
                  box + repro::swz128((r + 1) * 128 + (p % 32) * 4));
            } else {         // (p, r), (p, r + 1) in box r / 32 of 128 rows
              const char* box = st + (r / 32) * GP * 128;
              v = *reinterpret_cast<const float2*>(
                  box + repro::swz128(p * 128 + (r % 32) * 4));
            }
            af[kk][i] = repro::pack_bf16x2(v.x, v.y);
          }
        repro::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < GR / 16; ++kk)
          repro::wgmma_rs<GQ, 0>(
              acc, af[kk], repro::desc128(st + WA + 32 * kk, 16, 1024));
        repro::wgmma_commit();
        // an in-flight wgmma still reads its A registers: the group retires
        // before the next stage's fragments are written (two sets of
        // fragments with one group in flight ran slower on the card)
        repro::wgmma_wait<0>();
        repro::keep_regs(af);
        repro::mbar_arrive(&empty[stage]);
        if (++stage == WSTAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      repro::fence_regs(acc);

      // the epilogue: acc holds C^T (rows p, columns m); C's 64 x 64 boxes
      // are rows m of 64 p, written through the swizzle one value at a time
      char* ob = outbuf + cw * 2 * 64 * 128;
#pragma unroll
      for (int c = 0; c < GQ / 64; ++c) {
        char* buf = ob + (c & 1) * 64 * 128;
        if (lt == 0) repro::tma_store_wait<1>();
        repro::named_barrier(1 + cw, 128);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = 8 * c + jj;
            const int pl = 16 * warp + g + 8 * (e >> 1);   // within 64
            const int ml = 8 * jj + 2 * tq + (e & 1);      // within 64
            bf16 v = __float2bfloat16(acc[4 * j + e]);
            const int p = p0 + 64 * cw + pl, m = m0 + 64 * c + ml;
            if (res && p < P && m < M)
              v = add_rounded(res[static_cast<long>(m) * ldc + p], v);
            *reinterpret_cast<bf16*>(
                buf + repro::swz128(static_cast<uint32_t>(ml * 128 +
                                                          pl * 2))) = v;
          }
        repro::fence_proxy_async();
        repro::named_barrier(1 + cw, 128);
        if (lt == 0) {
          repro::tma_store_3d(&tc, buf, p0 + 64 * cw, m0 + 64 * c, w.b);
          repro::tma_store_commit();
        }
      }
    }
    if (lt == 0) repro::tma_store_wait<0>();
  }
}

// c[b sc + e] = round(sum over s < slices, in order, of part[(b stride +
// s) pq + e]), written in TC: the split reduction's second pass (stride:
// the partials a batch holds)
template <typename TC>
__global__ void __launch_bounds__(256)
dense_reduce_kernel(const float* __restrict__ part, TC* __restrict__ c,
                    int slices, int stride, long pq, int batch, long sc) {
  const long n = static_cast<long>(batch) * pq;
  for (long i = blockIdx.x * 256L + threadIdx.x; i < n;
       i += static_cast<long>(gridDim.x) * 256) {
    const long b = i / pq, e = i % pq;
    const float* src = part + b * stride * pq + e;
    float s = 0.0f;
    for (int k = 0; k < slices; ++k) s += src[k * pq];
    c[b * sc + e] = from_bf16<TC>(__float2bfloat16(s));
  }
}

// out[b kn + e] = bf16(w[b sw + e]) (round to nearest even), kn % 4 == 0:
// the per-call bf16 copy of an fp32 weight the Hopper form reads
__global__ void __launch_bounds__(256)
dense_cast_kernel(const float* __restrict__ w, long sw, bf16* __restrict__ out,
                  long kn, int batch) {
  const long n4 = static_cast<long>(batch) * (kn / 4);
  const bool vec = (reinterpret_cast<uintptr_t>(w) % 16) == 0 && sw % 4 == 0;
  for (long i = blockIdx.x * 256L + threadIdx.x; i < n4;
       i += static_cast<long>(gridDim.x) * 256) {
    const long b = i / (kn / 4), e = (i % (kn / 4)) * 4;
    const float* src = w + b * sw + e;
    float4 f;
    if (vec) {
      f = *reinterpret_cast<const float4*>(src);
    } else {
      f = make_float4(src[0], src[1], src[2], src[3]);
    }
    *reinterpret_cast<uint2*>(out + b * kn + e) = make_uint2(
        repro::pack_bf16x2(f.x, f.y), repro::pack_bf16x2(f.z, f.w));
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

// A 3D bf16 tensor map over `batch` matrices of rows x cols (row stride
// ld, batch stride sb, in elements), boxes of box0 columns x box1 rows.
int map3(CUtensorMap* m, const void* base, long cols, long rows, long ld,
         int batch, long sb, uint32_t box0, uint32_t box1, int fp32 = 0) {
  const uint64_t es = fp32 ? 4 : 2;
  const uint64_t dims[3] = {static_cast<uint64_t>(cols),
                            static_cast<uint64_t>(rows),
                            static_cast<uint64_t>(batch)};
  const uint64_t strides[2] = {static_cast<uint64_t>(ld) * es,
                               static_cast<uint64_t>(batch > 1 ? sb
                                                               : rows * ld) *
                                   es};
  const uint32_t box[3] = {box0, box1, 1};
  return repro::tensor_map(m, fp32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                   : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                           base, 3, dims, strides, box);
}

// C's map for the TMA epilogue (0 where TMA cannot write C: a base not
// 16-byte aligned, or a row or batch stride not a multiple of 16 bytes)
int map_c(CUtensorMap* m, const void* c, long cols, long rows, long ld,
          int batch, long sb, int fp32) {
  const long per = fp32 ? 4 : 8;   // values a 16-byte step
  if (!aligned16(c) || ld % per || (batch > 1 && sb % per)) return 0;
  return map3(m, c, cols, rows, ld, batch, sb, fp32 ? 32 : 64, 64, fp32) == 0;
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

template <int AL, int BL, typename TC>
int launch_wgmma(const CUtensorMap& ta, const CUtensorMap& tb, void* c,
                 const void* res, long ldc, long sc, int P, int Q, int R,
                 int batch, int slices, float* part, void* stream) {
  // the epilogue by TMA where the output (C, or the partials) allows it
  CUtensorMap tc;
  const int tma_c =
      slices > 1 ? map_c(&tc, part, Q, P, Q, batch * slices,
                         static_cast<long>(P) * Q, 1)
                 : map_c(&tc, c, Q, P, ldc, batch, sc, sizeof(TC) == 4);
  auto kern = dense_wgmma_kernel<AL, BL, TC>;
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kern),
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(GSMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long units = static_cast<long>(batch) * slices *
                     ((P + GP - 1) / GP) * ((Q + GQ - 1) / GQ);
  const int grid = static_cast<int>(std::min<long>(units, sm_count()));
  kern<<<grid, GNT, GSMEM, static_cast<cudaStream_t>(stream)>>>(
      ta, tb, tma_c ? tc : ta, tma_c, static_cast<TC*>(c),
      static_cast<const TC*>(res), ldc, sc, P, Q, R, batch, slices, part);
  return static_cast<int>(cudaGetLastError());
}

// The register-A form for an fp32 weight: DX 0 the forward (C = y, P' =
// N, R' = K, B = x), DX 1 dx (C = dx, P' = K, R' = N, B = dy); C's map must
// be valid (a 16-byte aligned base, rows of whole 16 bytes).
template <int DX>
int launch_w32(const void* w, long sw, const void* b, long ldb, long sb,
               void* c, long ldc, long sc, const void* res, int M, int K,
               int N, int batch, void* stream) {
  CUtensorMap ta, tb, tc;
  const int P = DX ? K : N, R = DX ? N : K;
  int err = DX ? map3(&ta, w, N, K, N, batch, sw, 32, GP, 1)
               : map3(&ta, w, N, K, N, batch, sw, 32, GR, 1);
  if (err || (err = map3(&tb, b, R, M, ldb, batch, sb, 64, GQ)))
    return err;
  if (!map_c(&tc, c, P, M, ldc, batch, sc, 0))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = dense_w32_kernel<DX>;
  cudaError_t e = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kern),
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(WSMEM));
  if (e != cudaSuccess) return static_cast<int>(e);
  const long units = static_cast<long>(batch) * ((P + GP - 1) / GP) *
                     ((M + GQ - 1) / GQ);
  const int grid = static_cast<int>(std::min<long>(units, sm_count()));
  kern<<<grid, GNT, WSMEM, static_cast<cudaStream_t>(stream)>>>(
      ta, tb, tc, static_cast<const bf16*>(res), ldc, P, M, R, batch);
  return static_cast<int>(cudaGetLastError());
}

// w (batch x K x N fp32, batch stride sw) rounded into wbuf (contiguous):
// the bf16 B the Hopper form reads
int cast_w(const void* w, long sw, void* wbuf, int K, int N, int batch,
           void* stream) {
  const long kn = static_cast<long>(K) * N;
  const long n4 = batch * (kn / 4);
  const int grid = static_cast<int>(std::min<long>((n4 + 255) / 256, 4096));
  dense_cast_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), batch > 1 ? sw : kn,
      static_cast<bf16*>(wbuf), kn, batch);
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
// the experts' products, one an expert (no residual).  tma (bf16 x only):
// the Hopper form, whose operands the caller has checked TMA can take (x's
// base 16-byte aligned, ldx and sx multiples of 8, N a multiple of 8, a
// bf16 w's base aligned); an fp32 w is then rounded into wbuf (batch x K x
// N bf16) first, or, with wbuf null (its base aligned), read as the
// register operand (dense_w32_kernel).  tma 0: the mma.sync form.
extern "C" int dense_fwd(const void* x, long ldx, const void* w, void* y,
                         const void* res, int M, int K, int N, int x_bf16,
                         int w_bf16, int batch, long sx, long sw, long sy,
                         int tma, void* wbuf, void* stream) {
  int err;
  if (empty_or_too_big(M, N, batch, &err)) return err;
  if (res && batch != 1) return static_cast<int>(cudaErrorInvalidValue);
  const Batch bt{batch, sx, sw, sy};
  if (x_bf16 && tma) {
    if (K <= 0 || N % 8) return static_cast<int>(cudaErrorInvalidValue);
    if (!w_bf16 && !wbuf)
      return launch_w32<0>(w, sw, x, ldx, sx, y, N, sy, res, M, K, N, batch,
                           stream);
    const void* wb = w;
    long swb = sw;
    if (!w_bf16) {
      if ((err = cast_w(w, sw, wbuf, K, N, batch, stream))) return err;
      wb = wbuf;
      swb = static_cast<long>(K) * N;
    }
    CUtensorMap ta, tb;
    if ((err = map3(&ta, x, K, M, ldx, batch, sx, 64, GP)) ||
        (err = map3(&tb, wb, N, K, N, batch, swb, 64, GR)))
      return err;
    return launch_wgmma<ROW, RQ, bf16>(ta, tb, y, res, N, sy, M, N, K, batch,
                                       1, nullptr, stream);
  }
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
// Batched as dense_fwd: dy + i sdy, w + i sw, dx + i sdx; tma and wbuf as
// there (dy's base, lddy and sdy in place of x's; the register operand
// needs K a multiple of 8, dx's rows written by TMA).
extern "C" int dense_dx(const void* dy, long lddy, const void* w, void* dx,
                        int M, int K, int N, int x_bf16, int w_bf16,
                        int batch, long sdy, long sw, long sdx, int tma,
                        void* wbuf, void* stream) {
  int err;
  if (empty_or_too_big(M, K, batch, &err)) return err;
  const Batch bt{batch, sdy, sw, sdx};
  if (x_bf16 && tma) {
    if (N <= 0 || N % 8) return static_cast<int>(cudaErrorInvalidValue);
    if (!w_bf16 && !wbuf)
      return launch_w32<1>(w, sw, dy, lddy, sdy, dx, K, sdx, nullptr, M, K, N,
                           batch, stream);
    const void* wb = w;
    long swb = sw;
    if (!w_bf16) {
      if ((err = cast_w(w, sw, wbuf, K, N, batch, stream))) return err;
      wb = wbuf;
      swb = static_cast<long>(K) * N;
    }
    CUtensorMap ta, tb;
    if ((err = map3(&ta, dy, N, M, lddy, batch, sdy, 64, GP)) ||
        (err = map3(&tb, wb, N, K, N, batch, swb, 64, GQ)))
      return err;
    return launch_wgmma<ROW, QR, bf16>(ta, tb, dx, nullptr, K, sdx, M, K, N,
                                       batch, 1, nullptr, stream);
  }
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

// The slices dw's reduction over M is split into on the Hopper form (1 to
// 4): the count whose waves of (tile, slice) units over the SMs, plus the
// partials' bytes (written once, read once) at 3.35 TB/s, cost least, a
// full tile's walk over M taken at 5 TFLOP/s an SM; no split where the
// tiles fill the card twice, and no slice under 512 rows.
extern "C" int dense_dw_slices(int M, int K, int N, int batch) {
  if (M <= 0 || K <= 0 || N <= 0 || batch <= 0) return 1;
  const long tiles = static_cast<long>(batch) * ((K + GP - 1) / GP) *
                     ((N + GQ - 1) / GQ);
  const long sms = sm_count();
  if (tiles >= 2 * sms) return 1;
  const double t_tile = 2.0 * GP * GQ * M / 5e12;
  const double kn = static_cast<double>(batch) * K * N;
  int best = 1;
  double best_cost = 0.0;
  for (int s = 1; s <= 4; ++s) {
    if (s > 1 && M / s < 512) break;
    const double waves = static_cast<double>((tiles * s + sms - 1) / sms);
    const double cost =
        waves / s * t_tile + (s > 1 ? (8.0 * s + 2.0) * kn / 3.35e12 : 0.0);
    if (s == 1 || cost < best_cost) {
      best = s;
      best_cost = cost;
    }
  }
  return best;
}

// The split reduction's second pass: dw (batch x K x N in w's dtype,
// batch stride sdw) = the sum of the first `slices` of the `stride`
// partials a batch holds in part (batch x stride x K x N fp32), in index
// order, rounded once to bf16.
extern "C" int dense_dw_reduce(const void* part, void* dw, int slices,
                               int stride, int K, int N, int w_bf16,
                               int batch, long sdw, void* stream) {
  const long pq = static_cast<long>(K) * N;
  const long n = batch * pq;
  if (n <= 0) return 0;
  if (slices < 1 || slices > stride)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(std::min<long>((n + 255) / 256, 8192));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* pf = static_cast<const float*>(part);
  if (w_bf16) {
    bf16* out = static_cast<bf16*>(dw);
    dense_reduce_kernel<bf16><<<grid, 256, 0, st>>>(pf, out, slices, stride,
                                                    pq, batch, sdw);
  } else {
    float* out = static_cast<float*>(dw);
    dense_reduce_kernel<float><<<grid, 256, 0, st>>>(pf, out, slices, stride,
                                                     pq, batch, sdw);
  }
  return static_cast<int>(cudaGetLastError());
}

// dw (K, N) contiguous in w's dtype: the sum over all M rows.  Batched as
// dense_fwd: x + i sx, dy + i sdy, dw + i sdw (each expert's dw the sum
// over its own rows).  tma (bf16 x): the Hopper form (x's and dy's bases,
// row and batch strides as dense_fwd's x), its reduction split into
// `slices` (dense_dw_slices) whose fp32 partials go to part (batch x slices
// x K x N) and are summed by dense_dw_reduce; slices 1 writes dw directly.
extern "C" int dense_dw(const void* x, long ldx, const void* dy, long lddy,
                        void* dw, int M, int K, int N, int x_bf16, int w_bf16,
                        int batch, long sx, long sdy, long sdw, int tma,
                        int slices, void* part, void* stream) {
  int err;
  if (empty_or_too_big(K, N, batch, &err)) return err;
  const Batch bt{batch, sx, sdy, sdw};
  if (x_bf16 && tma) {
    if (M <= 0 || slices < 1 || (slices > 1 && part == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    CUtensorMap ta, tb;
    if ((err = map3(&ta, x, K, M, ldx, batch, sx, 64, GR)) ||
        (err = map3(&tb, dy, N, M, lddy, batch, sdy, 64, GR)))
      return err;
    float* pf = static_cast<float*>(part);
    err = w_bf16 ? launch_wgmma<COL, RQ, bf16>(ta, tb, dw, nullptr, N, sdw, K,
                                              N, M, batch, slices, pf, stream)
                 : launch_wgmma<COL, RQ, float>(ta, tb, dw, nullptr, N, sdw,
                                               K, N, M, batch, slices, pf,
                                               stream);
    if (err || slices == 1) return err;
    return dense_dw_reduce(pf, dw, slices, slices, K, N, w_bf16, batch, sdw,
                           stream);
  }
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
