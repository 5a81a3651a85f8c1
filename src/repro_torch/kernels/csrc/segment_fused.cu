// Kernels 2 and 3: the fused segment kernels of runner="fused", written for
// the LSTM chain step (embedding gather -> cell -> h @ w_out + b_out ->
// log-sum-exp - gold -> acc += mean over the batch).
//
// Kernel 2, the fused advance (driven from repro_torch/kernels/
// segment_fused.py), replaces the TPU kernel src/repro/kernels/
// segment_pallas.py::fused_advance_segment (built in _fused_ops.advance).
// Only (h, c) carry the recurrence: the logits and the loss of step t read
// h_{t+1} and feed nothing back.  So each forward chunk of L steps runs the
// recurrence alone, on kernel 1's step loop (lstm_cell.cu: one cooperative
// launch, each block's 128 columns of W resident in shared memory, a
// barrier per row of blocks after each step), into device scratch hs, cs
// (L + 1, B, Dh); and the readout and loss are hoisted out of the step loop
// into work over all L * B rows of the chunk: logits = hs[1:] w_out + b_out
// (gemm_kernel, one pass over the card) and the rows' lse - gold with each
// step's batch mean (advance_loss_kernel, one block a step).  The same
// kernel writes the chunk-entry (h, c) straight into page-locked host memory
// through its device mapping (the analogue of the TPU's async copy into ANY
// space), so the Level-2 copy of boundary 0 needs no device-to-host transfer
// after the segment, and moves the chunk's exit state to the next chunk's
// entry (or to the segment's carry).  The loss accumulator couples every
// step: one launch a segment (acc_finalize_kernel) carries acc_{t+1} = acc_t
// + mean_t in step order and writes the acc boundaries.  No float atomics:
// two calls give the same bits, and the states are those of kernel 1 run
// from the same entry, as the fused reverse's recompute runs it.  Bound on
// the H100 SXM (67 TFLOP/s fp32): a step is ~181 MFLOP (the cell 168, the
// readout 12.6), so operations bound it (2.7 ms at T = 1000); what holds it
// is the step loop's latency per step (its barrier and the staging of the
// [x, h] rows), since the step loop does 93% of the work and the readout
// runs at the rate of a large product.  The kernel this replaces (one block
// per 4 batch rows, the readout inside the step loop) streamed all of W
// from L2 in every block at every step.
//
// Kernel 3, the fused reverse (driven from repro_torch/kernels/
// segment_fused.py), replaces segment_pallas.py::fused_reverse_segment
// (_fused_ops.reverse).  Its recompute steps run kernel 1's step loop
// (lstm_cell.cu), one launch per run of steps.  Bound: at the paper's
// width a chunk step is ~190 MFLOP of fp32 work, but only dh_t = dz_t
// W_h^T (134 MFLOP) and the pointwise vjp are sequential; the logits, their
// softmax, dlogits w_out^T, dx = dz W_x^T and the parameter gradients
// depend only on the recomputed states.  So those are hoisted out of the
// step loop into products over all L * B rows of a chunk, each spread over
// the whole card (tiled fp32 FMA from double-buffered shared memory; the
// reductions over rows split into slices added in a fixed order), and the
// step loop (the walk) carries the recurrence alone: 128 blocks, each
// holding its units' rows of W_h in shared memory for the whole chunk and
// reading only its batch rows of dz_t per step.  No float atomics: every
// sum has a fixed order, so two calls give the same bits.  Full chunks
// fold into the gradient in descending order from zero; a short tail chunk
// is kept apart and added once at the end (add_kernel) — the association
// of the JAX kernel.
#include "lstm_step.cuh"

namespace {

constexpr int NT = 256;  // threads per block
constexpr int NW = NT / 32;

// ---------------------------------------------------------------- kernel 2
//
// After a chunk's step loop, over its L steps (grid.x >= L; blocks past L
// only copy):
//   msum[t] = (sum over the batch rows b of lse(lg[t B + b]) -
//   lg[t B + b][tgt[t B + b]]) / B: warp w sums the rows w, w + LW, ... in
//   order, and the warps' sums are added in warp order.  A row is a chain of
//   dependent warp reductions, so a step's rows are spread over 32 warps;
// and over the whole grid, per element e of a (B, Dh) state: the chunk's
// entry into the boundary (bh, bc; skipped when bh is NULL), then the exit
// into next (the next chunk's entry, or the segment's carry).  entry_h may
// alias next_h: each element is read before it is written, by the same
// thread.  With a captured segment's argument block (args), the targets are
// rows t_lo .. of the segment's ARG_TGT, and with dst_from_args the
// boundary goes to the Level-2 slot the block names (ARG_BH, ARG_BC).
constexpr int LT = 1024;   // threads of advance_loss_kernel
constexpr int LW = LT / 32;

__global__ void __launch_bounds__(LT)
advance_loss_kernel(const float* __restrict__ lg,
                    const int32_t* __restrict__ tgt, int L, int B, int V,
                    float* __restrict__ msum, const float* entry_h,
                    const float* entry_c, float* bh, float* bc,
                    const float* __restrict__ exit_h,
                    const float* __restrict__ exit_c, float* next_h,
                    float* next_c, long n, const long long* args, int t_lo,
                    int dst_from_args) {
  __shared__ float wsum[LW];
  if (args != nullptr) {
    tgt = repro::seg_ids(args, repro::ARG_TGT, t_lo, B);
    if (dst_from_args) {
      bh = reinterpret_cast<float*>(args[repro::ARG_BH]);
      bc = reinterpret_cast<float*>(args[repro::ARG_BC]);
    }
  }
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int t = blockIdx.x;
  if (t < L) {
    float acc = 0.0f;
    for (int r = warp; r < B; r += LW) {
      const long row = static_cast<long>(t) * B + r;
      const float* l = lg + row * V;
      float m = -INFINITY;
      for (int v = lane; v < V; v += 32) m = fmaxf(m, l[v]);
      m = repro::warp_max(m);
      float s = 0.0f;
      for (int v = lane; v < V; v += 32) s += expf(l[v] - m);
      s = repro::warp_sum(s);
      if (lane == 0) acc += (m + logf(s)) - l[tgt[row]];
    }
    if (lane == 0) wsum[warp] = acc;
    __syncthreads();
    if (tid == 0) {
      float s = 0.0f;
      for (int w = 0; w < LW; ++w) s += wsum[w];
      msum[t] = s / static_cast<float>(B);
    }
  }
  for (long e = static_cast<long>(blockIdx.x) * LT + tid; e < n;
       e += static_cast<long>(gridDim.x) * LT) {
    if (bh != nullptr) {
      bh[e] = entry_h[e];
      bc[e] = entry_c[e];
    }
    next_h[e] = exit_h[e];
    next_c[e] = exit_c[e];
  }
}

// acc_{t+1} = acc_t + msum[t] over the segment's T steps in order, from
// *acc0; bnd_acc[k] = acc at the start of chunk k, and with a captured
// segment's argument block (args) the segment's entry acc also into its
// Level-2 slot (ARG_BACC).  One thread.
__global__ void acc_finalize_kernel(const float* __restrict__ msum, int T,
                                    const float* __restrict__ acc0,
                                    float* __restrict__ acc_out,
                                    float* __restrict__ bnd_acc, int chunk,
                                    int nc, const long long* args) {
  float a = *acc0;
  if (args != nullptr) *reinterpret_cast<float*>(args[repro::ARG_BACC]) = a;
  for (int t = 0; t < T; ++t) {
    if (t % chunk == 0 && t / chunk < nc) bnd_acc[t / chunk] = a;
    a = a + msum[t];
  }
  *acc_out = a;
}

// ---------------------------------------------------------------- kernel 3
//
// Per chunk of L steps (M = L * B rows), after the recompute (kernel 1)
// has written hs (L+1, B, Dh), cs (L+1, B, Dh), xh (L, B, Dx+Dh) and acts
// (L, B, 4Dh):
//   hoisted, before the walk: dl = g (softmax(hs[1:] w_out + b_out) -
//     onehot(target)) and dh_extra = dl w_out^T for all M rows at once
//     (gemm_kernel, dlogits_kernel);
//   the walk (walk_kernel, one cooperative launch per chunk): only the
//     recurrence dh_t = dz_t W_h^T, with the cell's vjp in its epilogue;
//   hoisted, after the walk: dx = dz W_x^T (gemm_kernel);
//   the parameter gradients [dW; db] = [xh, 1]^T dz and [dw_out; db_out] =
//     [hs[1:], 1]^T dl (gemm_kernel over M split into slices, the bias row
//     summed beside the product, reduce_kernel adding the slices) and demb
//     (embed_grad_kernel, also split over M).
// Every sum runs in a fixed order (no float atomics), so two calls give
// the same bits.  What bounds the step loop is latency, not work (one
// step's dh_t = dz_t W_h^T is 134 MFLOP, ~2 us of the card's fp32 FMA), and
// the 1 MB of W_h it reads.  So on the card the walk of a chunk is one
// cooperative launch with a grid-wide barrier per step, not a launch per
// step: each block loads its slice of W_h into shared memory once and keeps
// it for every step of the chunk, and no step pays a launch.  The grid is
// sized from the occupancy query so that every block is resident (a block
// whose rows outnumber the grid loops over its row tiles within a step), and
// a cooperative launch refuses a grid that could not all be resident rather
// than hanging on the barrier.  Under the CPU emulation, which runs blocks
// one at a time, the same kernel runs one launch per step (the launch
// boundary is the barrier).

// Tiled fp32 product on the CUDA cores (no TF32):
//   out[i][j] = sum over r in slice z of A(i, r) B(r, j), r ascending,
//   A(i, r) = TA ? A[r lda + i] : A[i lda + r],
//   B(r, j) = TB ? B[j ldb + r] : B[r ldb + j].
// A (64 RH) x 128 output tile per block of 256 threads, (4 RH) x 8 a thread
// (rows h 64 + ty*4.., columns tx*4.. and 64 + tx*4..), r in stages of 16
// double-buffered in shared memory by 4-byte cp.async (zero-filled past
// the edges, so every stage is a full one).  part == nullptr: C[i][j] =
// sum (+ bias[j]).  Otherwise the slice's sum goes to part[z][i][j] of a
// prow x No partial for reduce_kernel; with prow == Mo + 1 the blocks of
// the first row tile also sum B's columns over the slice (the bias row of
// a gradient, [A, 1]^T B) into part[z][Mo][j] from the same stages: thread
// row ty takes stage row ty, and the 16 partial sums are added in ty order.
constexpr int GN = 128, GR = 16, GPAD = 4;
constexpr int SMS = 132;  // H100 SMs: the slice count aims at ~2 blocks/SM

template <bool TA, bool TB, int RH>
__global__ void __launch_bounds__(NT)
gemm_kernel(const float* __restrict__ A, int lda, const float* __restrict__ Bm,
            int ldb, int Mo, int No, int R, int rslice, float* __restrict__ C,
            const float* __restrict__ bias, float* __restrict__ part,
            int prow) {
  constexpr int BM = 64 * RH;
  __align__(16) __shared__ float As[2][GR][BM + GPAD];
  __align__(16) __shared__ float Bs[2][GR][GN + GPAD];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int i0 = blockIdx.y * BM, j0 = blockIdx.x * GN, z = blockIdx.z;
  const int r_begin = z * rslice, r_end = min(R, r_begin + rslice);
  const bool colsum = part != nullptr && prow > Mo && i0 == 0;

  auto load = [&](int bf, int rb) {
    for (int e = tid; e < GR * BM; e += NT) {
      const int rr = TA ? e / BM : e % GR, ii = TA ? e % BM : e / GR;
      const int i = i0 + ii, r = rb + rr;
      const bool ok = i < Mo && r < r_end;
      const float* src = !ok ? A
                         : TA ? A + static_cast<long>(r) * lda + i
                              : A + static_cast<long>(i) * lda + r;
      repro::cp_async4(&As[bf][rr][ii], src, ok ? 4 : 0);
    }
    for (int e = tid; e < GR * GN; e += NT) {
      const int rr = TB ? e % GR : e / GN, jj = TB ? e / GR : e % GN;
      const int j = j0 + jj, r = rb + rr;
      const bool ok = j < No && r < r_end;
      const float* src = !ok ? Bm
                         : TB ? Bm + static_cast<long>(j) * ldb + r
                              : Bm + static_cast<long>(r) * ldb + j;
      repro::cp_async4(&Bs[bf][rr][jj], src, ok ? 4 : 0);
    }
  };

  float acc[4 * RH][8], csum[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    csum[c] = 0.0f;
#pragma unroll
    for (int i = 0; i < 4 * RH; ++i) acc[i][c] = 0.0f;
  }
  if (r_begin < r_end) load(0, r_begin);
  repro::cp_async_commit();
  for (int rb = r_begin, it = 0; rb < r_end; rb += GR, ++it) {
    const int bf = it & 1;
    repro::cp_async_wait<0>();   // stage `it` has landed ...
    __syncthreads();             // ... for all; stage it-1 is consumed
    if (rb + GR < r_end) load(bf ^ 1, rb + GR);
    repro::cp_async_commit();
#pragma unroll
    for (int rr = 0; rr < GR; ++rr) {
      float av[4 * RH];
#pragma unroll
      for (int h = 0; h < RH; ++h) {
        const float4 a =
            *reinterpret_cast<const float4*>(&As[bf][rr][h * 64 + ty * 4]);
        av[4 * h] = a.x;
        av[4 * h + 1] = a.y;
        av[4 * h + 2] = a.z;
        av[4 * h + 3] = a.w;
      }
      const float4 b0 =
          *reinterpret_cast<const float4*>(&Bs[bf][rr][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[bf][rr][GN / 2 + tx * 4]);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4 * RH; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(av[i], bv[c], acc[i][c]);
    }
    if (colsum) {
#pragma unroll
      for (int c = 0; c < 8; ++c)
        csum[c] += Bs[bf][ty][c < 4 ? tx * 4 + c : GN / 2 + tx * 4 + c - 4];
    }
  }
  repro::cp_async_wait<0>();

  if (colsum) {   // the 16 row partials of each column, in ty order
    __syncthreads();
    float* red = &Bs[0][0][0];   // 16 x GN floats of the stage buffers
#pragma unroll
    for (int c = 0; c < 8; ++c)
      red[ty * GN + (c < 4 ? tx * 4 + c : GN / 2 + tx * 4 + c - 4)] = csum[c];
    __syncthreads();
    if (tid < GN && j0 + tid < No) {
      float s = 0.0f;
      for (int k = 0; k < 16; ++k) s += red[k * GN + tid];
      part[(static_cast<long>(z) * prow + Mo) * No + j0 + tid] = s;
    }
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int col = j0 + (c < 4 ? tx * 4 + c : GN / 2 + tx * 4 + c - 4);
    if (col >= No) continue;
#pragma unroll
    for (int i = 0; i < 4 * RH; ++i) {
      const int row = i0 + (i / 4) * 64 + ty * 4 + i % 4;
      if (row >= Mo) continue;
      if (part != nullptr)
        part[(static_cast<long>(z) * prow + row) * No + col] = acc[i][c];
      else
        C[static_cast<long>(row) * No + col] =
            bias != nullptr ? acc[i][c] + bias[col] : acc[i][c];
    }
  }
}

// C[e] (+)= sum over slices z = 0, 1, ... of part[z][e] (+ bias[e % No]).
__global__ void reduce_kernel(const float* __restrict__ part, int S, long n,
                              float* __restrict__ C, int accumulate,
                              const float* __restrict__ bias, int No) {
  const long e = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.0f;
  for (int z = 0; z < S; ++z) s += part[z * n + e];
  if (bias != nullptr) s += bias[e % No];
  C[e] = accumulate ? C[e] + s : s;
}

// dl[m] = g (softmax(logits[m]) - onehot(tgt[m])), g = dacc / B, in place:
// one warp per row.  With args (a captured segment's argument block), tgt
// is rows t_lo .. of the segment's ARG_TGT.
__global__ void __launch_bounds__(NT)
dlogits_kernel(float* __restrict__ lg, const int32_t* __restrict__ tgt,
               const float* __restrict__ dacc, int M, int V, int B,
               const long long* args, int t_lo) {
  if (args != nullptr) tgt = repro::seg_ids(args, repro::ARG_TGT, t_lo, B);
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * NW + threadIdx.x / 32;
  if (row >= M) return;
  const float g = *dacc / static_cast<float>(B);
  float* l = lg + static_cast<long>(row) * V;
  float m = -INFINITY;
  for (int v = lane; v < V; v += 32) m = fmaxf(m, l[v]);
  m = repro::warp_max(m);
  float s = 0.0f;
  for (int v = lane; v < V; v += 32) s += expf(l[v] - m);
  s = repro::warp_sum(s);
  const float lse = m + logf(s);
  const int gold = tgt[row];
  for (int v = lane; v < V; v += 32)
    l[v] = g * expf(l[v] - lse) - (v == gold ? g : 0.0f);
}

// The walk of one chunk, steps t = t_hi down to t_lo (t = -1: the product
// alone), over WR x WC tiles of (batch row, hidden unit):
//   prod = dz[t+1] W_h^T (at t = L-1: prod = dh, the chunk's exit
//   cotangent); then for t >= 0 the cell's vjp of step t:
//   (dh_extra[t] + prod, dc) -> dz[t], dc; at t = -1, dh = prod.
// Block (x, y) owns the units of column tile x and the row tiles y,
// y + gridDim.y, ...: the same (row, unit) outputs in every step, so the
// thread that owns one reads and writes its dc alone.  The block's WC rows
// of W_h (131 KB at Dh = 256) are loaded into shared memory once and serve
// every step it runs; each row tile of a step reads only its WR rows of
// dz[t+1], by 16-byte cp.async in two halves of the 4 Dh axis (the second
// lands while the first is multiplied).  Warp w sums the slices w and
// WS + w of that axis (B-rows rg + 8 r by units cg + 4 c over the lanes:
// conflict-free float4 reads with the padded row stride); the slices'
// partial sums are then added in slice order.  With t_hi > t_lo a grid
// barrier follows each step's dz writes (a cooperative launch); with
// t_hi == t_lo the launch boundary orders the steps.
constexpr int WR = 16, WC = 32, WS = NW;

size_t walk_smem_bytes(int Dh) {
  return sizeof(float) * (WR + WC) * (4 * static_cast<size_t>(Dh) + 4);
}

__global__ void __launch_bounds__(NT)
walk_kernel(const float* __restrict__ w_h, float* __restrict__ dz,
            const float* __restrict__ acts, const float* __restrict__ cs,
            const float* __restrict__ dh_extra, float* __restrict__ dh,
            float* __restrict__ dc, int B, int Dh, int L, int t_hi, int t_lo,
            unsigned* __restrict__ barrier) {
  extern __shared__ float smem[];
  __shared__ float red[WS][WR * WC];
  const int N4 = 4 * Dh, LD = N4 + 4;
  const long BN4 = static_cast<long>(B) * N4, BDh = static_cast<long>(B) * Dh;
  float* zs = smem;              // WR x LD: rows of dz[t+1]
  float* ws = smem + WR * LD;    // WC x LD: rows of W_h
  const int tid = threadIdx.x, lane = tid % 32, sl = tid / 32;
  const int rg = lane / 4, cg = lane % 4;
  const int j0 = blockIdx.x * WC, row_tiles = (B + WR - 1) / WR;
  const int per = ((N4 + 2 * WS - 1) / (2 * WS) + 3) & ~3;
  const unsigned nblk = gridDim.x * gridDim.y;

  // rows [r0, r0 + n) of `src` (row stride N4, rows from `row0`, `nrow`
  // valid) into `dst` (row stride LD), columns [lo, hi): 16-byte copies
  auto load_rows = [&](float* dst, const float* src, int row0, int nrow,
                       int n, int lo, int hi) {
    const int cpr = (hi - lo + 3) / 4;
    for (int e = tid; e < n * cpr; e += NT) {
      const int r = e / cpr, col = lo + 4 * (e % cpr);
      const bool ok = row0 + r < nrow && col < N4;
      repro::cp_async16(dst + r * LD + col,
                        ok ? src + static_cast<long>(row0 + r) * N4 + col
                           : src,
                        ok ? 16 : 0);
    }
  };
  load_rows(ws, w_h, j0, Dh, WC, 0, N4);
  repro::cp_async_commit();

  constexpr int EPT = WR * WC / NT;   // (row, unit) outputs a thread
  unsigned arrived = 0;
  for (int t = t_hi; t >= t_lo; --t) {
    const bool has_prod = t < L - 1;
    for (int tile = blockIdx.y; tile < row_tiles; tile += gridDim.y) {
      const int b0 = tile * WR;
      // this thread's outputs in the tile, and their vjp operands (dc
      // included), loaded before the product so that their latency hides
      // behind it
      long o[EPT], oz[EPT];   // offsets in (B, Dh) and in (B, 4 Dh)
      bool own[EPT];
      repro::GateActs ga[EPT];
      float ci[EPT], cn[EPT], dhx[EPT], dcr[EPT];
#pragma unroll
      for (int k = 0; k < EPT; ++k) {
        const int e = tid + k * NT, b = b0 + e / WC, j = j0 + e % WC;
        own[k] = b < B && j < Dh;
        o[k] = static_cast<long>(b) * Dh + j;
        oz[k] = static_cast<long>(b) * N4 + j;
        if (!own[k] || t < 0) continue;
        const float* ar = acts + t * BN4 + oz[k];
        ga[k].si = ar[0];
        ga[k].sf = ar[Dh];
        ga[k].so = ar[2 * Dh];
        ga[k].tg = ar[3 * Dh];
        ci[k] = cs[t * BDh + o[k]];
        cn[k] = cs[(t + 1) * BDh + o[k]];
        dhx[k] = dh_extra[t * BDh + o[k]];
        dcr[k] = dc[o[k]];
      }
      if (has_prod) {
        const float* dzn = dz + (t + 1) * BN4;
        for (int h = 0; h < 2; ++h) {
          const int lo = h * WS * per;
          load_rows(zs, dzn, b0, B, WR, lo, min(N4, lo + WS * per));
          repro::cp_async_commit();
        }
        float acc[2][8];
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;
        for (int h = 0; h < 2; ++h) {
          if (h == 0)
            repro::cp_async_wait<1>();   // W_h and the first half
          else
            repro::cp_async_wait<0>();
          __syncthreads();   // ... for all; red of the last tile is read
          const int n0 = (h * WS + sl) * per, n1 = min(N4, n0 + per);
          for (int n = n0; n < n1; n += 4) {
            float4 a[2], w[8];
#pragma unroll
            for (int r = 0; r < 2; ++r)
              a[r] = *reinterpret_cast<const float4*>(zs + (rg + 8 * r) * LD +
                                                      n);
#pragma unroll
            for (int c = 0; c < 8; ++c)
              w[c] = *reinterpret_cast<const float4*>(ws + (cg + 4 * c) * LD +
                                                      n);
#pragma unroll
            for (int r = 0; r < 2; ++r)
#pragma unroll
              for (int c = 0; c < 8; ++c) {
                float s = acc[r][c];
                s = fmaf(a[r].x, w[c].x, s);
                s = fmaf(a[r].y, w[c].y, s);
                s = fmaf(a[r].z, w[c].z, s);
                acc[r][c] = fmaf(a[r].w, w[c].w, s);
              }
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c)
            red[sl][(rg + 8 * r) * WC + cg + 4 * c] = acc[r][c];
      }
      __syncthreads();   // red written; every warp is done with zs
#pragma unroll
      for (int k = 0; k < EPT; ++k) {
        if (!own[k]) continue;
        const int e = tid + k * NT;
        float prod;
        if (has_prod) {
          prod = 0.0f;
          for (int s = 0; s < WS; ++s) prod += red[s][e];
        } else {
          prod = dh[o[k]];
        }
        if (t < 0) {
          dh[o[k]] = prod;
          continue;
        }
        float dzv[4], dcp;
        repro::lstm_point_vjp(ga[k], ci[k], cn[k], prod + dhx[k], dcr[k],
                              dzv, &dcp);
        dc[o[k]] = dcp;
        float* dzr = dz + t * BN4 + oz[k];
#pragma unroll
        for (int q = 0; q < 4; ++q) dzr[q * Dh] = dzv[q];
      }
    }
    if (t > t_lo) {   // dz[t] complete in every block before step t-1
      arrived += nblk;
      repro::grid_barrier(barrier, arrived);
    }
  }
  repro::cp_async_wait<0>();
}

// part[z][v, d] = sum over rows m of slice z (ascending) with tok[m] == v
// of dx[m, d]; reduce_kernel adds the slices.  With args (a captured
// segment's argument block), tok is rows t_lo .. of the segment's ARG_TOK
// (B ids a row).
__global__ void embed_grad_kernel(const int32_t* __restrict__ tok,
                                  const float* __restrict__ dx, int M, int V,
                                  int Dx, int rslice,
                                  float* __restrict__ part,
                                  const long long* args, int t_lo, int B) {
  if (args != nullptr) tok = repro::seg_ids(args, repro::ARG_TOK, t_lo, B);
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long n = static_cast<long>(V) * Dx;
  if (i >= n) return;
  const int v = static_cast<int>(i / Dx), d = static_cast<int>(i % Dx);
  const int z = blockIdx.y, m_end = min(M, (z + 1) * rslice);
  float s = 0.0f;
  for (int m = z * rslice; m < m_end; ++m)
    if (tok[m] == v) s += dx[static_cast<long>(m) * Dx + d];
  part[z * n + i] = s;
}

int grid1(long n) { return static_cast<int>((n + NT - 1) / NT); }

// Slices of the r axis of a product: about two blocks per SM, at least 8
// stages of GR rows a slice.  A function of the shapes only, so the
// association of every sum is fixed.
int slices_for(int Mo, int No, int R, int rh) {
  const int tiles = ((No + GN - 1) / GN) * ((Mo + 64 * rh - 1) / (64 * rh));
  const int s = min((2 * SMS + tiles - 1) / tiles, R / (8 * GR));
  return max(1, s);
}

int rslice_for(int R, int S) {
  return ((R + S - 1) / S + GR - 1) / GR * GR;
}

// Slices of embed_grad: at least 256 rows each, at most 64.
int embed_slices(int M) { return max(1, min(64, M / 256)); }

// Row tiles of 64 rh: 128 (rh = 2, 8 x 8 a thread) where the output has
// rows enough to fill them, else 64.
int rows_half(int Mo) { return Mo >= 256 ? 2 : 1; }

template <bool TA, bool TB, int RH>
cudaError_t product_rh(const float* A, int lda, const float* Bm, int ldb,
                       int Mo, int No, int R, float* C, const float* bias,
                       int accumulate, bool bias_row, float* part,
                       cudaStream_t s) {
  const int S = slices_for(Mo, No, R, RH);
  const dim3 tiles((No + GN - 1) / GN, (Mo + 64 * RH - 1) / (64 * RH));
  if (S == 1 && !bias_row && !accumulate) {
    gemm_kernel<TA, TB, RH><<<tiles, NT, 0, s>>>(A, lda, Bm, ldb, Mo, No, R,
                                                 R, C, bias, nullptr, Mo);
    return cudaGetLastError();
  }
  const int prow = Mo + (bias_row ? 1 : 0);
  gemm_kernel<TA, TB, RH><<<dim3(tiles.x, tiles.y, S), NT, 0, s>>>(
      A, lda, Bm, ldb, Mo, No, R, rslice_for(R, S), nullptr, nullptr, part,
      prow);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long n = static_cast<long>(prow) * No;
  reduce_kernel<<<grid1(n), NT, 0, s>>>(part, S, n, C, accumulate, bias, No);
  return cudaGetLastError();
}

// C (Mo x No, or (Mo + 1) x No with the bias row when bias_row) (+)= the
// product of gemm_kernel, split over r when the output has few tiles (and
// always for a bias row); `part` holds product_scratch floats.
template <bool TA, bool TB>
cudaError_t product(const float* A, int lda, const float* Bm, int ldb,
                    int Mo, int No, int R, float* C, const float* bias,
                    int accumulate, bool bias_row, float* part,
                    cudaStream_t s) {
  if (rows_half(Mo) == 2)
    return product_rh<TA, TB, 2>(A, lda, Bm, ldb, Mo, No, R, C, bias,
                                 accumulate, bias_row, part, s);
  return product_rh<TA, TB, 1>(A, lda, Bm, ldb, Mo, No, R, C, bias,
                               accumulate, bias_row, part, s);
}

long product_scratch(int Mo, int No, int R, bool bias_row) {
  const int S = slices_for(Mo, No, R, rows_half(Mo));
  if (S == 1 && !bias_row) return 0;
  return static_cast<long>(S) * (Mo + (bias_row ? 1 : 0)) * No;
}

__global__ void add_kernel(float* __restrict__ dst,
                           const float* __restrict__ src, long n) {
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) dst[i] = dst[i] + src[i];
}

cudaError_t prepare_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The device address of page-locked host memory (its UVA mapping), or of
// device memory (itself).
cudaError_t device_view(void* p, float** dev) {
  cudaPointerAttributes attr;
  cudaError_t e = cudaPointerGetAttributes(&attr, p);
  if (e != cudaSuccess) return e;
  if ((attr.type != cudaMemoryTypeHost && attr.type != cudaMemoryTypeDevice)
      || attr.devicePointer == nullptr)
    return cudaErrorInvalidHostPointer;
  *dev = static_cast<float*>(attr.devicePointer);
  return cudaSuccess;
}

// Kernel 2's readout: lg (M x V) = hs1 (M x Dh) w_out + b_out in one pass
// of gemm_kernel (no split of Dh, so no partial sums to add): 128-row tiles
// where they fill the SMs, else 64-row ones.
cudaError_t readout(const float* hs1, const float* w_out, const float* b_out,
                    int M, int V, int Dh, float* lg, cudaStream_t s) {
  const int cols = (V + GN - 1) / GN;
  if ((M + 127) / 128 * cols >= SMS)
    gemm_kernel<false, false, 2><<<dim3(cols, (M + 127) / 128), NT, 0, s>>>(
        hs1, Dh, w_out, V, M, V, Dh, Dh, lg, b_out, nullptr, M);
  else
    gemm_kernel<false, false, 1><<<dim3(cols, (M + 63) / 64), NT, 0, s>>>(
        hs1, Dh, w_out, V, M, V, Dh, Dh, lg, b_out, nullptr, M);
  return cudaGetLastError();
}

}  // namespace

// Kernel 2, after the step loop of a forward chunk of L steps (hs, cs: (L +
// 1, B, Dh) of device scratch): the logits of its M = L B rows into lg (M x
// V), each step's mean loss into msum[0 .. L), the chunk's entry (entry_h,
// entry_c) into the boundary (bh, bc: page-locked host memory, written
// through its device mapping, or device memory; NULL: not written), and the
// exit (hs[L], cs[L]) into (next_h, next_c).  tgt: the chunk's (L, B)
// targets.  Two launches.  args: a captured segment's argument block
// (lstm_step.cuh), read on the card in place of tgt (then NULL): rows
// t_lo .. t_lo + L of the segment's ARG_TGT; with dst_from_args the
// boundary goes to its Level-2 slot in place of (bh, bc) (then NULL).
extern "C" int lstm_adv_chunk(const float* w_out, const float* b_out, int V,
                              int Dh, const int32_t* tgt, const float* hs,
                              const float* cs, int L, int B, float* lg,
                              float* msum, const float* entry_h,
                              const float* entry_c, float* bh, float* bc,
                              float* next_h, float* next_c,
                              const long long* args, int t_lo,
                              int dst_from_args, void* stream) {
  if (L <= 0 || B <= 0 || (tgt == nullptr) == (args == nullptr) ||
      (dst_from_args && (args == nullptr || bh != nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  float *bhd = nullptr, *bcd = nullptr;
  cudaError_t e;
  if (bh != nullptr && ((e = device_view(bh, &bhd)) != cudaSuccess ||
                        (e = device_view(bc, &bcd)) != cudaSuccess))
    return e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long n = static_cast<long>(B) * Dh;
  if ((e = readout(hs + n, w_out, b_out, L * B, V, Dh, lg, s)) !=
      cudaSuccess)
    return e;
  const int blocks = max(L, static_cast<int>((n + 4 * LT - 1) / (4 * LT)));
  advance_loss_kernel<<<blocks, LT, 0, s>>>(
      lg, tgt, L, B, V, msum, entry_h, entry_c, bhd, bcd, hs + L * n,
      cs + L * n, next_h, next_c, n, args, t_lo, dst_from_args);
  return static_cast<int>(cudaGetLastError());
}

// Kernel 2, once a segment of T steps: the acc chain over msum (T) from
// *acc0 into *acc_out, and its chunk boundaries into bnd_acc (page-locked
// host memory, or device memory); with args (a captured segment's argument
// block) the segment's entry acc also into its Level-2 slot.
extern "C" int lstm_adv_finalize(const float* msum, int T, const float* acc0,
                                 float* acc_out, float* bnd_acc, int chunk,
                                 int nc, const long long* args,
                                 void* stream) {
  if (T <= 0) return static_cast<int>(cudaErrorInvalidValue);
  float* bnd;
  cudaError_t e;
  if ((e = device_view(bnd_acc, &bnd)) != cudaSuccess) return e;
  acc_finalize_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      msum, T, acc0, acc_out, bnd, chunk, nc, args);
  return static_cast<int>(cudaGetLastError());
}

// Kernel 3: floats of the `part` scratch the functions below need for a
// chunk of M = L * B rows (0 if none).
extern "C" long lstm_rev_scratch(int V, int Dx, int Dh, int M) {
  const int K = Dx + Dh, N4 = 4 * Dh;
  const long need[] = {
      static_cast<long>(embed_slices(M)) * V * Dx,  // demb
      product_scratch(M, V, Dh, false),              // logits
      product_scratch(M, Dh, V, false),              // dh_extra
      product_scratch(M, Dx, N4, false),             // dx
      product_scratch(K, N4, M, true),               // [dW; db]
      product_scratch(Dh, V, M, true)};              // [dw_out; db_out]
  long n = 0;
  for (long x : need) n = x > n ? x : n;
  return n;
}

// Kernel 3, hoisted products before the walk, over M = L * B rows:
// dl = g (softmax(hs1 w_out + b_out) - onehot(tgt)), dh_extra = dl w_out^T.
extern "C" int lstm_rev_hoisted(const float* w_out, const float* b_out, int V,
                                int Dh, const int32_t* tgt, const float* hs1,
                                const float* dacc, float* dl, float* dh_extra,
                                int M, int B, float* part,
                                const long long* args, int t_lo,
                                void* stream) {
  if (M <= 0 || B <= 0 || (tgt == nullptr) == (args == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if ((e = product<false, false>(hs1, Dh, w_out, V, M, V, Dh, dl, b_out, 0,
                                 false, part, s)) != cudaSuccess)
    return e;
  dlogits_kernel<<<(M + NW - 1) / NW, NT, 0, s>>>(dl, tgt, dacc, M, V, B,
                                                  args, t_lo);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return product<false, true>(dl, V, w_out, V, M, Dh, V, dh_extra, nullptr, 0,
                              false, part, s);
}

// Kernel 3, the largest Dh whose walk tile fits the device's shared memory
// per block (0 if the device cannot be queried).
extern "C" int lstm_rev_walk_max_dh() {
  int dev, optin;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  const long room = optin - static_cast<long>(sizeof(float)) * WS * WR * WC;
  const long dh = (room / static_cast<long>(sizeof(float) * (WR + WC)) - 4) / 4;
  return dh > 0 ? static_cast<int>(dh) : 0;
}

// Kernel 3, the walk of one chunk (walk_kernel).  In: dh, dc the
// cotangents of the chunk's exit state; out: of its entry state, and dz
// (L, B, 4 Dh).  cs (L + 1, B, Dh), acts (L, B, 4 Dh), dh_extra (L, B, Dh);
// `barrier`: one unsigned of device scratch.  The grid holds as many row
// tiles as can be resident beside the column tiles, at most all of them.
extern "C" int lstm_rev_walk(const float* w, int Dx, int Dh, const float* cs,
                             const float* acts, const float* dh_extra,
                             float* dh, float* dc, float* dz, int L, int B,
                             unsigned* barrier, void* stream) {
  if (L <= 0 || B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = walk_smem_bytes(Dh);
  const void* kern = reinterpret_cast<const void*>(walk_kernel);
  cudaError_t e;
  if ((e = prepare_smem(kern, smem)) != cudaSuccess) return e;
  int dev, sms, per_sm;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, NT, smem)) != cudaSuccess)
    return e;
  const int col_tiles = (Dh + WC - 1) / WC, row_tiles = (B + WR - 1) / WR;
  const int resident = per_sm * sms;
  if (resident < col_tiles) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(col_tiles, min(row_tiles, resident / col_tiles));
  const float* w_h = w + 4L * Dh * Dx;
#if !defined(REPRO_CUDA_EMU)
  if ((e = cudaMemsetAsync(barrier, 0, sizeof(unsigned), s)) != cudaSuccess)
    return e;
  int t_hi = L - 1, t_lo = -1;
  void* args[] = {const_cast<float**>(&w_h), &dz,
                  const_cast<float**>(&acts), const_cast<float**>(&cs),
                  const_cast<float**>(&dh_extra), &dh, &dc, &B, &Dh, &L,
                  &t_hi, &t_lo, &barrier};
  return static_cast<int>(
      cudaLaunchCooperativeKernel(kern, grid, dim3(NT), args, smem, s));
#else
  // blocks run one at a time here: one launch per step
  for (int t = L - 1; t >= -1; --t) {
    walk_kernel<<<grid, NT, smem, s>>>(w_h, dz, acts, cs, dh_extra, dh, dc, B,
                                       Dh, L, t, t, barrier);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  return 0;
#endif
}

// Kernel 3, hoisted product after the walk: dx = dz W_x^T over M rows.
extern "C" int lstm_rev_dx(const float* w, int Dx, int Dh, const float* dz,
                           float* dx, int M, float* part, void* stream) {
  return product<false, true>(dz, 4 * Dh, w, 4 * Dh, M, Dx, 4 * Dh, dx,
                              nullptr, 0, false, part,
                              static_cast<cudaStream_t>(stream));
}

// Slices grad_reduce splits M into; its scratch `part` holds
// slices * (Ka + 1) * N floats.
extern "C" int grad_reduce_slices(int Ka, int N, int M) {
  return slices_for(Ka, N, M, rows_half(Ka));
}

// C[(Ka+1) x N] (+)= [A, 1]^T B over M rows (A: M x Ka, B: M x N, row
// strides lda, ldb): row Ka of C is the column sum of B (the bias
// gradient).  M is split into grad_reduce_slices slices; each slice sums
// its rows in ascending order into part, and the slices are added in order.
extern "C" int grad_reduce(const float* A, int lda, const float* Bm, int ldb,
                           int M, int Ka, int N, float* C, int accumulate,
                           float* part, void* stream) {
  return product<true, false>(A, lda, Bm, ldb, Ka, N, M, C, nullptr,
                              accumulate, true, part,
                              static_cast<cudaStream_t>(stream));
}

// demb[v, d] (+)= sum over rows m with tok[m] == v of dx[m, d]: slices of
// M in ascending row order, added in slice order.  args: a captured
// segment's argument block, read on the card in place of tok (then NULL):
// rows t_lo .. of the segment's ARG_TOK, B ids a row.
extern "C" int embed_grad(const int32_t* tok, const float* dx, int M, int V,
                          int Dx, float* demb, int accumulate, float* part,
                          const long long* args, int t_lo, int B,
                          void* stream) {
  if ((tok == nullptr) == (args == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int S = embed_slices(M);
  const long n = static_cast<long>(V) * Dx;
  embed_grad_kernel<<<dim3(grid1(n), S), NT, 0, s>>>(
      tok, dx, M, V, Dx, (M + S - 1) / S, part, args, t_lo, B);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  reduce_kernel<<<grid1(n), NT, 0, s>>>(part, S, n, demb, accumulate, nullptr,
                                        1);
  return static_cast<int>(cudaGetLastError());
}

// The device address of page-locked host memory (its UVA mapping) or of
// device memory, for a captured segment's argument block.
extern "C" int repro_device_address(void* p, long long* out) {
  float* dev;
  const cudaError_t e = device_view(p, &dev);
  if (e == cudaSuccess) *out = reinterpret_cast<long long>(dev);
  return static_cast<int>(e);
}

extern "C" int add_inplace(float* dst, const float* src, long n,
                           void* stream) {
  add_kernel<<<static_cast<unsigned>((n + NT - 1) / NT), NT, 0,
               static_cast<cudaStream_t>(stream)>>>(dst, src, n);
  return static_cast<int>(cudaGetLastError());
}
