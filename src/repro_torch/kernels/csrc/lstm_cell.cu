// Kernel 1: the fused LSTM cell, z = [x, h] @ W + b -> gates -> (h', c'),
// one step or a run of steps of the recurrence (lstm_cell_kernel).
//
// Replaces the TPU kernel src/repro/kernels/lstm_cell.py::lstm_cell (Pallas,
// one grid step per batch block with W whole in VMEM).  On the H100 W
// (320 x 1024 fp32 = 1.3 MB at the paper's width) does not fit a block's
// shared memory, so the grid is 2-D: a block owns a tile of BM = 16 batch
// rows by BJ = 32 hidden units and computes all four gate columns of those
// units (j, Dh+j, 2Dh+j, 3Dh+j), so the gate epilogue needs no exchange
// between blocks.  The block's 128 columns of W (160 KB at Dx + Dh = 320)
// are loaded into shared memory in BK = 32-row slices, each its own
// cp.async group: the first product multiplies slice s as soon as it has
// landed, while the later slices are still in flight.  The [x, h] rows of
// the tile sit beside them (row-major, padded).  Each of the 512 threads
// owns a 4 x 4 register tile of the 16 x 128 output and a quarter of every
// slice's rows (the block's four quarters split K, 16 warps for the
// latency of the shared-memory loads; their sums are added in a fixed
// order), so two 16-byte shared-memory loads feed 16 FMAs.  Products
// are fp32 FMA on the CUDA cores (no TF32).  The ragged batch and unit
// edges are masked (the TPU kernel asserted B % block_b == 0).  W's columns
// must fit a block's shared memory: Dx + Dh up to 352 on the H100
// (lstm_cell_max_k), as W had to fit the TPU kernel's VMEM.
//
// Bound on the H100 SXM (data sheet: 67 TFLOP/s fp32, 3.35 TB/s): one step
// at B = 256 does ~168 MFLOP against ~1.9 MB (W dominates), so it is bound
// by operations (2.5 us).
//
// A run of steps (the fused advance's forward chunks, the fused reverse's
// recompute; x = emb[tok]) is one launch: W is the same matrix at every
// step, so its columns stay in shared memory for the whole run and a step
// stages only the tile's [x, h] rows.
// h_{t+1} of a row tile is read only by the blocks that own that row tile,
// so after each step's writes those blocks (one grid row) meet at a barrier
// of their own, not the whole grid's.  The next step's x rows are fetched
// before that barrier, and the x part of the product runs while the new h
// rows land.  It is a cooperative launch, as the fused reverse's walk: the
// grid is sized from the occupancy query so every block is resident (a
// block whose row tiles outnumber the grid loops over them within a step),
// and a grid that could not all be resident is refused by the launch,
// never hung on a barrier.  Under the CPU emulation, which runs blocks one
// at a time, the same kernel runs one launch per step.  A step writes the
// [x, h] rows (spread over the row tile's blocks) and the gate activations
// the reverse's products read; no float atomics, so two calls give the same
// bits, and a step gives the same bits in a run as alone.  Step 0 may read
// its (h, c) from an entry state elsewhere (the advance's segment entry)
// instead of hs[0], cs[0]: the same values, the same bits.
#include <type_traits>

#include "lstm_step.cuh"

using repro::from_f32;
using repro::to_f32;

namespace {

constexpr int BM = 16;       // batch rows per tile
constexpr int BJ = 32;       // hidden units per tile
constexpr int NC = 4 * BJ;   // gate columns per tile: c = gate * BJ + unit
constexpr int BK = 32;       // rows of a W slice
constexpr int KQ = BK / 4;   // rows of a slice each quarter of the block sums
constexpr int NT = 512;      // threads: four quarters of 4 x 4 tiles

__host__ __device__ inline int kpad(int K) { return (K + BK - 1) / BK * BK; }
__host__ __device__ inline int row_ld(int K) { return kpad(K) + 4; }

// floats of shared memory: the [x, h] tile, the quarters' partial sums,
// the bias columns, and the block's W columns
size_t smem_floats(int K) {
  return static_cast<size_t>(BM) * row_ld(K) + 3 * BM * NC + NC +
         static_cast<size_t>(kpad(K)) * NC;
}

// One launch's operands.  Step t reads h + t step, c + t step (step 0:
// h_entry, c_entry when given) and writes h_out + t step, c_out + t step,
// xh[t], acts[t]; the x row of batch row b is x[tok[t B + b]] when tok is
// given, else x[b].
template <typename T>
struct Cell {
  const T* x;
  const int32_t* tok;
  const T* h;
  const T* c;
  T* h_out;
  T* c_out;
  const T* w;
  const T* bias;
  float* xh;     // (L, B, Dx + Dh) or NULL
  float* acts;   // (L, B, 4 Dh) or NULL
  int B, Dx, Dh;
  long step;     // elements between steps of h, c
  int vec;       // fp32 rows 16-byte aligned, Dx and Dh multiples of 4
  const T* h_entry = nullptr;   // step 0's h and c, when not h and c
  const T* c_entry = nullptr;
  // a captured segment's argument block (lstm_step.cuh): when given, the
  // ids of step t are row tok_lo + t of the segment's ARG_TOK rows
  const long long* args = nullptr;
  int tok_lo = 0;

  __device__ const T* h_at(int t) const {
    return t == 0 && h_entry != nullptr ? h_entry : h + t * step;
  }
  __device__ const T* c_at(int t) const {
    return t == 0 && c_entry != nullptr ? c_entry : c + t * step;
  }
};

template <typename T>
__device__ __forceinline__ void put(float* dst, const T* src, bool ok) {
  if constexpr (std::is_same<T, float>::value)
    repro::cp_async4(dst, src, ok ? 4 : 0);
  else
    *dst = ok ? to_f32(*src) : 0.0f;
}

// Columns [lo, hi) of the tile's [x, h] rows (row0 .. row0 + BM) into
// at[r][k], zero past K and B: x for k < Dx, h beyond.  With vec, lo and hi
// are multiples of 4 (16-byte copies); zero-filled copies name a valid
// global address that they do not read.
template <typename T>
__device__ __forceinline__ void stage_cols(float* at, const Cell<T>& p,
                                           const int32_t* tok, const T* h,
                                           int row0, int lo, int hi) {
  const int K = p.Dx + p.Dh, LD = row_ld(K), Dx = p.Dx;
  if (p.vec) {
    const int cpr = (hi - lo) / 4;
    for (int e = threadIdx.x; e < BM * cpr; e += NT) {
      const int r = e / cpr, k = lo + 4 * (e % cpr), row = row0 + r;
      const float* src = reinterpret_cast<const float*>(h);
      const bool ok = row < p.B && k < K;
      if (ok) {
        const long xr = tok != nullptr ? tok[row] : row;
        src = k < Dx ? reinterpret_cast<const float*>(p.x) + xr * Dx + k
                     : reinterpret_cast<const float*>(h) +
                           static_cast<long>(row) * p.Dh + (k - Dx);
      }
      repro::cp_async16(at + r * LD + k, src, ok ? 16 : 0);
    }
    return;
  }
  const int n = hi - lo;
  for (int e = threadIdx.x; e < BM * n; e += NT) {
    const int r = e / n, k = lo + e % n, row = row0 + r;
    const bool ok = row < p.B && k < K;
    const T* src = h;
    if (ok) {
      const long xr = tok != nullptr ? tok[row] : row;
      src = k < Dx ? p.x + xr * Dx + k
                   : h + static_cast<long>(row) * p.Dh + (k - Dx);
    }
    put(at + r * LD + k, src, ok);
  }
}

// Rows [k0, k0 + BK) of the block's W columns into ws[kk][c], zero past K
// and Dh (16-byte copies with vec).
template <typename T>
__device__ __forceinline__ void stage_w(float* ws, const Cell<T>& p, int k0,
                                        int j0) {
  const int K = p.Dx + p.Dh, Dh = p.Dh;
  const long N4 = 4L * Dh;
  if (p.vec) {
    const float* wf = reinterpret_cast<const float*>(p.w);
    for (int e = threadIdx.x; e < BK * (NC / 4); e += NT) {
      const int kk = e / (NC / 4), c = 4 * (e % (NC / 4));
      const int g = c / BJ, j = j0 + c % BJ, k = k0 + kk;
      const bool ok = k < K && j < Dh;
      repro::cp_async16(ws + kk * NC + c, ok ? wf + k * N4 + g * Dh + j : wf,
                        ok ? 16 : 0);
    }
    return;
  }
  for (int e = threadIdx.x; e < BK * NC; e += NT) {
    const int kk = e / NC, c = e % NC;
    const int g = c / BJ, j = j0 + c % BJ, k = k0 + kk;
    const bool ok = k < K && j < Dh;
    put(ws + kk * NC + c, ok ? p.w + k * N4 + g * Dh + j : p.w, ok);
  }
}

// acc += the thread's 4 x 4 tile over rows [KQ q, KQ q + KQ) of slice s
// of ws (Kp x NC), q its quarter, i.e. those columns of the [x, h] tile.
__device__ __forceinline__ void slice_product(float acc[4][4],
                                              const float* at, int LD,
                                              const float* ws, int s) {
  const int tid = threadIdx.x, q = tid / (NT / 4), u = tid % (NT / 4);
  const int r0 = 4 * (u / 32), c0 = 4 * (u % 32);
#pragma unroll
  for (int k4 = 0; k4 < KQ; k4 += 4) {
    const int k = BK * s + KQ * q + k4;
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(at + (r0 + i) * LD + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      b[kk] = *reinterpret_cast<const float4*>(ws + (k + kk) * NC + c0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float av[4] = {a[i].x, a[i].y, a[i].z, a[i].w};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        acc[i][0] = fmaf(av[kk], b[kk].x, acc[i][0]);
        acc[i][1] = fmaf(av[kk], b[kk].y, acc[i][1]);
        acc[i][2] = fmaf(av[kk], b[kk].z, acc[i][2]);
        acc[i][3] = fmaf(av[kk], b[kk].w, acc[i][3]);
      }
    }
  }
}

// z = (((quarter 0's sum + quarter 1's) + quarter 2's) + quarter 3's) +
// bias for the tile, then the cell per (row, unit) point: h', c' and (when
// given) the gate activations.  red: 3 x BM x NC partial sums.
template <typename T>
__device__ __forceinline__ void cell_epilogue(
    const float acc[4][4], float* red, const float* bs, const T* c, T* h_out,
    T* c_out, float* acts, int row0, int j0, int B, int Dh) {
  const int tid = threadIdx.x, q = tid / (NT / 4), u = tid % (NT / 4);
  const int r0 = 4 * (u / 32), c0 = 4 * (u % 32);
  float4* rv = reinterpret_cast<float4*>(red);
  if (q > 0)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      rv[((q - 1) * BM * NC + (r0 + i) * NC + c0) / 4] =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  __syncthreads();
  if (q == 0)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float4 z = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
#pragma unroll
      for (int o = 0; o < 3; ++o) {
        const float4 v = rv[(o * BM * NC + (r0 + i) * NC + c0) / 4];
        z = make_float4(z.x + v.x, z.y + v.y, z.z + v.z, z.w + v.w);
      }
      rv[((r0 + i) * NC + c0) / 4] = z;
    }
  __syncthreads();
  const long N4 = 4L * Dh;
  for (int p = tid; p < BM * BJ; p += NT) {
    const int r = p / BJ, uu = p % BJ, row = row0 + r, j = j0 + uu;
    if (row >= B || j >= Dh) continue;
    const float* z = red + r * NC + uu;
    const long o = static_cast<long>(row) * Dh + j;
    float cn, hn;
    const repro::GateActs a = repro::lstm_point(
        z[0] + bs[uu], z[BJ] + bs[BJ + uu], z[2 * BJ] + bs[2 * BJ + uu],
        z[3 * BJ] + bs[3 * BJ + uu], to_f32(c[o]), &cn, &hn);
    h_out[o] = from_f32<T>(hn);
    c_out[o] = from_f32<T>(cn);
    if (acts != nullptr) {
      float* ar = acts + static_cast<long>(row) * N4 + j;
      ar[0] = a.si;
      ar[Dh] = a.sf;
      ar[2 * Dh] = a.so;
      ar[3 * Dh] = a.tg;
    }
  }
}

// Steps t_lo .. t_hi over the block's row tiles blockIdx.y, + gridDim.y,
// ...; with t_hi > t_lo the blocks of a grid row meet at the barrier
// counter barrier[blockIdx.y] after each step (a cooperative launch).
template <typename T>
__global__ void __launch_bounds__(NT, 1)
lstm_cell_kernel(Cell<T> p, int t_lo, int t_hi, unsigned* barrier) {
  extern __shared__ float smem[];
  if (p.args != nullptr)
    p.tok = repro::seg_ids(p.args, repro::ARG_TOK, p.tok_lo, p.B);
  const int B = p.B, Dx = p.Dx, K = Dx + p.Dh, LD = row_ld(K);
  const int ns = kpad(K) / BK;   // W slices
  const int nxs = Dx / BK;       // slices of x columns alone
  const int xe = p.vec ? (Dx + 3) & ~3 : Dx;   // end of the x columns
  float* at = smem;              // BM x LD: the tile's [x, h] rows
  float* red = at + BM * LD;     // 3 x BM x NC
  float* bs = red + 3 * BM * NC;  // NC
  float* ws = bs + NC;           // kpad(K) x NC: the block's W columns
  const int j0 = blockIdx.x * BJ, row_tiles = (B + BM - 1) / BM;
  const int gy = gridDim.y, rt0 = blockIdx.y;
  const long xh_step = static_cast<long>(B) * K;

  auto tok_of = [&](int t) {
    return p.tok != nullptr ? p.tok + static_cast<long>(t) * B : nullptr;
  };
  auto stage_x = [&](int t, int rt) {
    stage_cols(at, p, tok_of(t), p.h, rt * BM, 0, xe);
    repro::cp_async_commit();
  };
  auto stage_h = [&](int t, int rt) {
    stage_cols(at, p, tok_of(t), p.h_at(t), rt * BM, xe, kpad(K));
    repro::cp_async_commit();
  };

  for (int c = threadIdx.x; c < NC; c += NT) {
    const int j = j0 + c % BJ;
    bs[c] = j < p.Dh ? to_f32(p.bias[(c / BJ) * p.Dh + j]) : 0.0f;
  }
  // groups: x, h of the first tile, then every W slice
  if (rt0 < row_tiles) {
    stage_x(t_lo, rt0);
    stage_h(t_lo, rt0);
  }
  for (int s = 0; s < ns; ++s) {
    stage_w(ws + s * BK * NC, p, s * BK, j0);
    repro::cp_async_commit();
  }
  bool first = true;
  unsigned arrived = 0;
  for (int t = t_lo; t <= t_hi; ++t) {
    for (int rt = rt0; rt < row_tiles; rt += gy) {
      const int row0 = rt * BM;
      float acc[4][4] = {};
      auto write_xh = [&]() {   // this block's share of the tile's columns
        if (p.xh == nullptr) return;
        const int per = (K + gridDim.x - 1) / gridDim.x;
        const int lo = blockIdx.x * per, n = max(0, min(K, lo + per) - lo);
        float* xh = p.xh + t * xh_step;
        for (int e = threadIdx.x; e < BM * n; e += NT) {
          const int r = e / n, k = lo + e % n;
          if (row0 + r < B)
            xh[static_cast<long>(row0 + r) * K + k] = at[r * LD + k];
        }
      };
      if (first) {   // slice s as soon as it (and the tile) has landed
        for (int s = 0; s < ns; ++s) {
          repro::cp_async_wait_dyn(ns - 1 - s);
          __syncthreads();
          if (s == 0) write_xh();
          slice_product(acc, at, LD, ws, s);
        }
      } else {   // the x columns while the h columns land
        repro::cp_async_wait<1>();
        __syncthreads();
        for (int s = 0; s < nxs; ++s) slice_product(acc, at, LD, ws, s);
        repro::cp_async_wait<0>();
        __syncthreads();
        write_xh();
        for (int s = nxs; s < ns; ++s) slice_product(acc, at, LD, ws, s);
      }
      first = false;
      __syncthreads();   // the tile is read: fetch the next one's rows
      if (rt + gy < row_tiles) {
        stage_x(t, rt + gy);
        stage_h(t, rt + gy);
      } else if (t < t_hi) {
        stage_x(t + 1, rt0);   // its h rows follow the barrier
      }
      cell_epilogue(acc, red, bs, p.c_at(t), p.h_out + t * p.step,
                    p.c_out + t * p.step,
                    p.acts == nullptr ? nullptr : p.acts + 4 * t * p.step,
                    row0, j0, B, p.Dh);
    }
    if (t < t_hi) {   // h_{t+1} of this grid row's tiles complete
      arrived += gridDim.x;
      repro::grid_barrier(barrier + blockIdx.y, arrived);
      if (rt0 < row_tiles) stage_h(t + 1, rt0);
    }
  }
  repro::cp_async_wait<0>();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
int vec_of(const Cell<T>& p) {
  return std::is_same<T, float>::value && p.Dx % 4 == 0 && p.Dh % 4 == 0 &&
         aligned16(p.x) && aligned16(p.h) && aligned16(p.w) &&
         aligned16(p.h_entry);
}

// The kernel's shared memory, set as its limit; cudaErrorInvalidValue when
// W's columns cannot fit.
template <typename T>
cudaError_t prepare(int K, size_t* smem) {
  *smem = sizeof(float) * smem_floats(K);
  int dev, optin;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&optin,
                                  cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                  dev)) != cudaSuccess)
    return e;
  if (*smem > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(
      reinterpret_cast<const void*>(lstm_cell_kernel<T>),
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(*smem));
}

template <typename T>
int launch_step(const void* x, const int32_t* tok, const void* h,
                const void* c, const void* w, const void* b, void* h_out,
                void* c_out, float* xh_out, float* acts_out, int B, int Dx,
                int Dh, void* stream) {
  if (B <= 0 || Dh <= 0) return 0;
  Cell<T> p{static_cast<const T*>(x), tok, static_cast<const T*>(h),
            static_cast<const T*>(c), static_cast<T*>(h_out),
            static_cast<T*>(c_out), static_cast<const T*>(w),
            static_cast<const T*>(b), xh_out, acts_out, B, Dx, Dh, 0, 0};
  p.vec = vec_of(p);
  size_t smem;
  if (cudaError_t e = prepare<T>(Dx + Dh, &smem)) return e;
  const dim3 grid((Dh + BJ - 1) / BJ, (B + BM - 1) / BM);
  lstm_cell_kernel<T><<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      p, 0, 0, nullptr);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One step.  x rows directly (tok == NULL) or x = x[tok[b]]; the optional
// xh_out / acts_out receive the [x, h] rows and the gate activations.
extern "C" int lstm_cell_f32(const void* x, const int32_t* tok, const void* h,
                             const void* c, const void* w, const void* b,
                             void* h_out, void* c_out, float* xh_out,
                             float* acts_out, int B, int Dx, int Dh,
                             void* stream) {
  return launch_step<float>(x, tok, h, c, w, b, h_out, c_out, xh_out,
                            acts_out, B, Dx, Dh, stream);
}

extern "C" int lstm_cell_bf16(const void* x, const int32_t* tok,
                              const void* h, const void* c, const void* w,
                              const void* b, void* h_out, void* c_out,
                              float* xh_out, float* acts_out, int B, int Dx,
                              int Dh, void* stream) {
  return launch_step<__nv_bfloat16>(x, tok, h, c, w, b, h_out, c_out, xh_out,
                                    acts_out, B, Dx, Dh, stream);
}

// The largest Dx + Dh whose W columns fit one block's shared memory (0 if
// the device cannot be queried).
extern "C" int lstm_cell_max_k() {
  int dev, optin;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  // floats: BM (Kp + 4) + 3 BM NC + NC + Kp NC <= optin / 4
  const long room = optin / 4 - 4L * BM - 3L * BM * NC - NC;
  const long kp = room / (NC + BM) / BK * BK;
  return kp > 0 ? static_cast<int>(kp) : 0;
}

// L steps over hs, cs (L + 1, B, Dh) with x = emb[tok[t]] (tok (L, B)),
// fp32, as one cooperative launch (on the card); xh (L, B, Dx + Dh) and
// acts (L, B, 4 Dh) may be NULL.  h_entry, c_entry (B, Dh): step 0's state
// in place of hs[0], cs[0] (NULL: hs[0], cs[0]).  blocks_y: the grid's rows
// of blocks (0: as many as can be resident beside the unit tiles, at most
// one per row tile of 16).  barrier: blocks_y unsigned counters of device
// scratch (the default needs ceil(B / 16)).  args: a captured segment's
// argument block (lstm_step.cuh), read on the card in place of tok (then
// NULL): the ids are rows tok_lo .. tok_lo + L of the segment's ARG_TOK.
extern "C" int lstm_cell_steps(const float* emb, const int32_t* tok,
                               float* hs, float* cs, const float* w,
                               const float* b, float* xh, float* acts,
                               const float* h_entry, const float* c_entry,
                               int L, int B, int Dx, int Dh, int blocks_y,
                               unsigned* barrier, const long long* args,
                               int tok_lo, void* stream) {
  if (L <= 0 || B <= 0 || Dh <= 0) return 0;
  if ((tok == nullptr) == (args == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long BDh = static_cast<long>(B) * Dh;
  Cell<float> p{emb, tok, hs, cs, hs + BDh, cs + BDh, w, b, xh, acts,
                B, Dx, Dh, BDh, 0, h_entry, c_entry, args, tok_lo};
  p.vec = vec_of(p);
  size_t smem;
  cudaError_t e;
  if ((e = prepare<float>(Dx + Dh, &smem)) != cudaSuccess) return e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* kern = reinterpret_cast<const void*>(lstm_cell_kernel<float>);
  const int col_tiles = (Dh + BJ - 1) / BJ, row_tiles = (B + BM - 1) / BM;
  if (blocks_y <= 0) {
    int dev, sms, per_sm;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kern, NT, smem)) != cudaSuccess)
      return e;
    const int resident = per_sm * sms;
    if (resident < col_tiles) return static_cast<int>(cudaErrorInvalidValue);
    blocks_y = min(row_tiles, resident / col_tiles);
  }
  const dim3 grid(col_tiles, blocks_y);
#if !defined(REPRO_CUDA_EMU)
  if ((e = cudaMemsetAsync(barrier, 0, sizeof(unsigned) * blocks_y, s)) !=
      cudaSuccess)
    return e;
  int t_lo = 0, t_hi = L - 1;
  void* kargs[] = {&p, &t_lo, &t_hi, &barrier};
  return static_cast<int>(
      cudaLaunchCooperativeKernel(kern, grid, dim3(NT), kargs, smem, s));
#else
  // blocks run one at a time here: one launch per step
  for (int t = 0; t < L; ++t) {
    lstm_cell_kernel<float><<<grid, NT, smem, s>>>(p, t, t, barrier);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  return 0;
#endif
}
