// The Mamba-2 chunked SSD scan, backward: the vjp of ssd_scan.cu's function
// (x, dt, A, b, c, h0) -> (y, final state).
//
// Replaces the arithmetic the TPU kernel src/repro/kernels/segment_pallas.py
// ::fused_reverse_segment runs for a mamba2 body (the body's chunk vjp is
// traced into the pallas_call at :395-409): jax.vjp of
// src/repro/models/ssm.py::ssd_chunked (:64-118).  The port's plain version
// is repro_torch/kernels/ssd_scan.py::ssd_scan_bwd_plain (autograd over
// repro_torch/models/ssm.py::ssd_chunked_plain).
//
// Per (batch, head) and chunk k of Lc rows (la = dt a, ca = cumsum(la)
// within the chunk, xbar = x dt, w_l = exp(ca_last - ca_l), cd_k =
// exp(ca_last), h_k the state entering chunk k, G_k = dh_{k+1} the
// cotangent of the state leaving it):
//
//   forward   S_k = sum_l w_l xbar_l (x) b_l,  h_{k+1} = cd_k h_k + S_k
//             M[l][s] = (c_l . b_s) exp(ca_l - ca_s) for s <= l, else 0
//             y_l = sum_s M[l][s] xbar_s + exp(ca_l) h_k c_l
//   backward  U_k = sum_l exp(ca_l) dy_l (x) c_l
//             G_{nc-1} = dh_final, G_{k-1} = cd_k G_k + U_k, dh0 = G_{-1}
//             dM[l][s] = dy_l . xbar_s,  dcb = dM exp(ca_l - ca_s) (s <= l)
//             dxbar_s = w_s G_k b_s + sum_{l >= s} M[l][s] dy_l
//             dc_l   += exp(ca_l) h_k^T dy_l + sum_{s <= l} dcb[l][s] b_s
//             db_s   += w_s G_k^T xbar_s + sum_{l >= s} dcb[l][s] c_l
//             dca_l   = exp(ca_l) dy_l . h_k c_l  - w_l xbar_l . G_k b_l
//                       + sum_s dcb[l][s] cb[l][s] - sum_l' dcb[l'][l] cb[l'][l]
//                       (+ cd_k (G_k . h_k) + sum_l w_l xbar_l . G_k b_l at
//                       the chunk's last row)
//             dla = the reverse cumsum of dca within the chunk
//             dx = dxbar dt, ddt = dxbar . x + dla a, dA = sum_{b,t} dla dt
//
// db and dc sum over the heads of a group, dA over (batch, time).
//
// bf16 inputs (the mamba2 path; L <= 128, P <= 64, N <= 128) run the Hopper
// form, seven launches with every product on wgmma (csrc/hopper.cuh):
//
//   1. hop_decay: ca of every (batch, head, chunk), a warp scan in double
//      (la in fp32), and cd.
//   2. hop_states: S_k and U_k.  A block owns one chunk of one (batch,
//      group) and a slice of the group's heads; b and c are loaded once,
//      each head's x, dy, dt and ca are prefetched (cp.async) into the
//      second of two buffers while the head before computes.  Warpgroup 0
//      runs S_k = (x w dt)^T b, warpgroup 1 U_k = (dy exp(ca))^T c: the
//      derived operand is the register A operand, scaled and split in
//      registers; b and c are read MN-major.
//   3. hop_pass: per (batch, head), each thread 8 elements of the (P, N)
//      state over the chunks, four chunks' loads issued before their
//      arithmetic: h_k forward, G_k backward, each written as two bf16
//      planes (high part, remainder) in the 128-byte-swizzled layout the
//      products read, so the next passes copy them as they are; G_k . h_k
//      (a block sum in a fixed order) and dh0.
//   4. hop_dx: blocks as pass 2.  C B^T once a block, kept in registers as
//      (B C^T)[s][l]; per head dM^T = x dy^T, the decays' term of dca from
//      dcb^T (.) (B C^T) by rows and columns, then dxbar = w (b G_k^T) + M^T
//      dy with M^T decayed in registers from B C^T as the split register A
//      operand; dx, and the rows' terms of dca and ddt.
//   5. hop_dbc: a block a (batch, group, chunk) and output (dc: z = 0, db:
//      z = 1), over the group's heads in order, the sum in registers: dc +=
//      exp(ca) (dy h_k) + dcb b with dcb = (dy x^T) dt exp(ca_l - ca_s)
//      recomputed as the split register A operand; db += w dt (x G_k) +
//      dcb^T c likewise; dc's pass also gives dca's exp(ca_l) dy_l . h_k c_l.
//   6. hop_ddt: a warp per (batch, head, chunk): the reverse cumsum of dca
//      (a warp scan in double), ddt and the chunk's partial of dA.
//   7. hop_da: dA, the partials summed over (batch, chunk) in order.
//
// Operand precision as the forward's (csrc/ssd_scan.cu): x, dy, b and c are
// exact bf16 operands; what is derived in fp32 (x w dt, dy exp(ca), the
// states h_k and cotangents G_k, the decayed M^T, dcb) is split where it
// feeds a product into a bf16 high part and the bf16 remainder, one product
// for each part (v = hi + lo to ~2^-16 of |v|); a product of a derived
// operand with a scale of its output's rows (exp(ca) (dy h_k), w dt (x G_k),
// w (b G_k^T)) folds the scale into the fp32 result, so dy and x stay exact.
// LOW_PARTS = 0 drops the remainders' products (a test's mutation: the
// fp32 outputs then miss the fp32 gradient by ~2^-9).  Operand tiles are
// in the 128-byte swizzle, 64 columns a block (at()); the exact operands
// are copied in by cp.async, 16 bytes a thread where the rows are aligned,
// zeros past the chunk, P or N, so any P, N and a shorter last chunk read
// as they are.  No float atomics; every sum runs in a fixed order, so two
// calls give the same bits.
//
// fp32 inputs take nine passes of 64 x 64 fp32 tiles on the CUDA cores (no
// TF32), 256 threads a block, 4 x 4 outputs a thread, 16-deep operand
// slices in shared memory (bf16 outside the Hopper form's limits is
// refused, cudaErrorInvalidValue):
//
//   1. bwd_decay: ca (la in fp32, summed in double, as the forward) and cd.
//   2. bwd_states: every chunk's S_k and U_k (products of K = Lc).
//   3. bwd_pass: per (batch, head, state element), the states passed
//      forward over the chunks (S_k becomes h_k) and the cotangents passed
//      backward (U_k becomes G_k); dh0.
//   4. bwd_cb: c_l . b_s a chunk and group (shared by the group's heads).
//   5. bwd_dcb: dcb a chunk and head (the mask applied before the exp: a
//      masked entry is exactly 0).
//   6. bwd_dx: dx, and the row terms of dca and ddt, a 64-row tile a block.
//   7. bwd_dbc: db and dc a chunk and group: one product whose reduction
//      runs over the group's heads in order (each head's P + Lc terms), so
//      the sum over heads is fixed and needs no per-head partials.
//   8. bwd_ddt: per (batch, head), over the chunks in order: G_k . h_k, the
//      reverse cumsum of dca, ddt and a partial of dA.
//   9. bwd_da: dA, the partials summed over the batch in order.
//
// Bound on the H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 on the tensor cores):
// at mamba2-370m's layer (B = 4, T = 4096, H = 32, G = 1, P = 64, N = 128,
// chunk 128) the function reads x, b, c, dy (bf16), dt, h0, dh_final and
// writes dx, db, dc, ddt, dh0: ~0.1 GB; its products are ~39 G
// multiply-adds (chip_smoke.ssd_bwd_flops): 0.078 ms by operations.  The
// Hopper form runs ~100 G multiply-adds (the split products, dM in both
// blocks of pass 5, whole 64-row tiles of the causal products) and its
// scratch moves ~1.3 GB (S_k and U_k written and read once, h_k and G_k
// written once and read twice, 134 MB each at that shape).
//
// Layouts as the forward's: x, dx, dy (B, T, H, P), dt, ddt (B, T, H), b, c,
// db, dc (B, T, G, N), h0, dh_final, dh0 (B, H, P, N) fp32; head h reads
// group h / (H / G).  A chunk length that does not divide T leaves a shorter
// last chunk, as in the forward.
#include <algorithm>
#include <utility>

#include "common.cuh"
#include "hopper.cuh"

using repro::from_f32;
using repro::to_f32;

namespace {

constexpr int NT = 256;                 // 16 x 16 threads
constexpr int TM = 64, TN = 64, TK = 16;

struct Shape {
  int B, T, H, G, P, N, L, nc, rep;
};

struct Scratch {
  double* ca;   // (B, H, T): cumulative log-decay within each chunk
  float* cd;    // (B, H, nc): exp(ca) at each chunk's last row
  float* st;    // (B, H, nc, P, N): S_k, then the state entering chunk k
  float* ut;    // (B, H, nc, P, N): U_k, then G_k
  float* cb;    // (B, G, nc, L, L): c_l . b_s
  float* dcb;   // (B, H, nc, L, L): dM[l][s] exp(ca_l - ca_s), s <= l
  float* qa;    // (B, H, T): dca's row terms (the output's, the decays')
  float* qr;    // (B, H, T): w_l xbar_l . G_k b_l
  float* qx;    // (B, H, T): dxbar_l . x_l
  float* dap;   // (B, H): partial sums of dA
};

int chunks_of(int T, int* L) {
  if (T < *L) *L = T > 0 ? T : 1;  // a chunk no longer than the sequence
  return T > 0 ? (T + *L - 1) / *L : 0;
}

// the scratch's floats, and its parts carved from `base` (ca first: 8-byte
// aligned as the buffer is)
long carve(float* base, const Shape& s, Scratch* w) {
  const long BH = static_cast<long>(s.B) * s.H;
  const long BT = BH * s.T, LL = static_cast<long>(s.L) * s.L;
  const long parts[] = {2 * BT, BH * s.nc, BH * s.nc * s.P * s.N,
                        BH * s.nc * s.P * s.N,
                        static_cast<long>(s.B) * s.G * s.nc * LL,
                        BH * s.nc * LL, BT, BT, BT, BH};
  long off[10], n = 0;
  for (int i = 0; i < 10; ++i) {
    off[i] = n;
    n += (parts[i] + 3) & ~3L;   // 16-byte aligned parts
  }
  if (w != nullptr) {
    w->ca = reinterpret_cast<double*>(base + off[0]);
    w->cd = base + off[1];
    w->st = base + off[2];
    w->ut = base + off[3];
    w->cb = base + off[4];
    w->dcb = base + off[5];
    w->qa = base + off[6];
    w->qr = base + off[7];
    w->qx = base + off[8];
    w->dap = base + off[9];
  }
  return n;
}

// The chunk a block or thread works on: flat index i = (b H + h) nc + k
// (or (b G + g) nc + k with `group`).
struct Chunk {
  long bh;      // b H + h (or b G + g)
  int b, h, k, c0, Lc;
  long row;     // b T + c0: the chunk's first row of the (B, T) axes
};

__device__ __forceinline__ Chunk chunk_of(long i, const Shape& s, int heads) {
  Chunk c;
  c.k = static_cast<int>(i % s.nc);
  c.bh = i / s.nc;
  c.h = static_cast<int>(c.bh % heads);
  c.b = static_cast<int>(c.bh / heads);
  c.c0 = c.k * s.L;
  c.Lc = min(s.L, s.T - c.c0);
  c.row = static_cast<long>(c.b) * s.T + c.c0;
  return c;
}

// acc[i][j] += sum_{k0 <= k < k1} a(m0 + 4 ty + i, k) b(k, n0 + 4 tx + j),
// (ty, tx) = (thread / 16, thread % 16), k in order: a block's 64 x 64 tile
// of a product whose operands the functors give (zero outside it), staged
// 16 deep in shared memory.
template <class FA, class FB>
__device__ __forceinline__ void tile_product(float (&acc)[4][4], int m0,
                                             int n0, int k0, int k1, FA a,
                                             FB b) {
  __shared__ float sa[TK][TM + 4];
  __shared__ float sb[TK][TN + 4];
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
  for (int kb = k0; kb < k1; kb += TK) {
    for (int e = t; e < TM * TK; e += NT) {
      const int m = e / TK, k = e % TK;
      sa[k][m] = kb + k < k1 ? a(m0 + m, kb + k) : 0.0f;
    }
    for (int e = t; e < TK * TN; e += NT) {
      const int k = e / TN, n = e % TN;
      sb[k][n] = kb + k < k1 ? b(kb + k, n0 + n) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < TK; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = sa[k][4 * ty + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = sb[k][4 * tx + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// the sum over the 16 threads of a tile row (lanes 16 apart hold other rows)
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float ex(double v) {
  return expf(static_cast<float>(v));
}

// ------------------------------------------------------------- 1. decay
__global__ void __launch_bounds__(NT)
bwd_decay(const float* __restrict__ dt, const float* __restrict__ A,
          Scratch w, Shape s) {
  const long i = static_cast<long>(blockIdx.x) * NT + threadIdx.x;
  if (i >= static_cast<long>(s.B) * s.H * s.nc) return;
  const Chunk c = chunk_of(i, s, s.H);
  const float a = A[c.h];
  double ca = 0.0;
  for (int l = 0; l < c.Lc; ++l) {
    ca += static_cast<double>(dt[(c.row + l) * s.H + c.h] * a);
    w.ca[c.bh * s.T + c.c0 + l] = ca;
  }
  w.cd[i] = ex(ca);
}

// ------------------------------------------------------------ 2. states
// blockIdx.x: the chunk (b H + h) nc + k; blockIdx.y: the (P, N) tile;
// blockIdx.z: 0 for S_k, 1 for U_k.
template <typename T>
__global__ void __launch_bounds__(NT)
bwd_states(const T* __restrict__ x, const float* __restrict__ dt,
           const T* __restrict__ dy, const T* __restrict__ bm,
           const T* __restrict__ cm, Scratch w, Shape s) {
  const long i = blockIdx.x;
  const Chunk c = chunk_of(i, s, s.H);
  const int g = c.h / s.rep, ntn = (s.N + TN - 1) / TN;
  const int m0 = (blockIdx.y / ntn) * TM, n0 = (blockIdx.y % ntn) * TN;
  const double* ca = w.ca + c.bh * s.T + c.c0;
  const double last = ca[c.Lc - 1];
  const T* bc = blockIdx.z == 0 ? bm : cm;
  float acc[4][4] = {};
  auto bn = [&](int l, int n) -> float {
    return n < s.N ? to_f32(bc[((c.row + l) * s.G + g) * s.N + n]) : 0.0f;
  };
  if (blockIdx.z == 0) {
    tile_product(acc, m0, n0, 0, c.Lc, [&](int p, int l) -> float {
      if (p >= s.P) return 0.0f;
      const long r = (c.row + l) * s.H + c.h;
      return to_f32(x[r * s.P + p]) * dt[r] * ex(last - ca[l]);
    }, bn);
  } else {
    tile_product(acc, m0, n0, 0, c.Lc, [&](int p, int l) -> float {
      if (p >= s.P) return 0.0f;
      const long r = (c.row + l) * s.H + c.h;
      return to_f32(dy[r * s.P + p]) * ex(ca[l]);
    }, bn);
  }
  float* out = (blockIdx.z == 0 ? w.st : w.ut) + i * s.P * s.N;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int p = m0 + 4 * ty + a, n = n0 + 4 * tx + b;
      if (p < s.P && n < s.N) out[static_cast<long>(p) * s.N + n] = acc[a][b];
    }
}

// -------------------------------------------------------------- 3. pass
__global__ void __launch_bounds__(NT)
bwd_pass(const float* __restrict__ h0, const float* __restrict__ dhf,
         float* __restrict__ dh0, Scratch w, Shape s) {
  const long PN = static_cast<long>(s.P) * s.N;
  const long i = static_cast<long>(blockIdx.x) * NT + threadIdx.x;
  if (i >= static_cast<long>(s.B) * s.H * PN) return;
  const long bh = i / PN, e = i % PN;
  float hv = h0 != nullptr ? h0[i] : 0.0f;
  for (int k = 0; k < s.nc; ++k) {
    float* p = w.st + (bh * s.nc + k) * PN + e;
    const float sk = *p;
    *p = hv;
    hv = hv * w.cd[bh * s.nc + k] + sk;
  }
  float g = dhf != nullptr ? dhf[i] : 0.0f;
  for (int k = s.nc - 1; k >= 0; --k) {
    float* p = w.ut + (bh * s.nc + k) * PN + e;
    const float u = *p;
    *p = g;
    g = g * w.cd[bh * s.nc + k] + u;
  }
  dh0[i] = g;
}

// ---------------------------------------------------------------- 4. cb
// blockIdx.x: (b G + g) nc + k; blockIdx.y: the (L, L) tile
template <typename T>
__global__ void __launch_bounds__(NT)
bwd_cb(const T* __restrict__ bm, const T* __restrict__ cm, Scratch w,
       Shape s) {
  const long i = blockIdx.x;
  const Chunk c = chunk_of(i, s, s.G);
  const int nt = (s.L + TN - 1) / TN;
  const int m0 = (blockIdx.y / nt) * TM, n0 = (blockIdx.y % nt) * TN;
  if (m0 >= c.Lc || n0 >= c.Lc || n0 > m0 + TM - 1) return;  // s <= l only
  const int g = c.h;
  float acc[4][4] = {};
  tile_product(acc, m0, n0, 0, s.N, [&](int l, int n) -> float {
    return l < c.Lc ? to_f32(cm[((c.row + l) * s.G + g) * s.N + n]) : 0.0f;
  }, [&](int n, int j) -> float {
    return j < c.Lc ? to_f32(bm[((c.row + j) * s.G + g) * s.N + n]) : 0.0f;
  });
  float* out = w.cb + i * s.L * s.L;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int l = m0 + 4 * ty + a, j = n0 + 4 * tx + b;
      if (l < c.Lc && j < c.Lc) out[l * s.L + j] = acc[a][b];
    }
}

// --------------------------------------------------------------- 5. dcb
// blockIdx.x: (b H + h) nc + k; blockIdx.y: the (L, L) tile
template <typename T>
__global__ void __launch_bounds__(NT)
bwd_dcb(const T* __restrict__ x, const float* __restrict__ dt,
        const T* __restrict__ dy, Scratch w, Shape s) {
  const long i = blockIdx.x;
  const Chunk c = chunk_of(i, s, s.H);
  const int nt = (s.L + TN - 1) / TN;
  const int m0 = (blockIdx.y / nt) * TM, n0 = (blockIdx.y % nt) * TN;
  if (m0 >= c.Lc || n0 >= c.Lc || n0 > m0 + TM - 1) return;  // s <= l only
  const double* ca = w.ca + c.bh * s.T + c.c0;
  float acc[4][4] = {};
  tile_product(acc, m0, n0, 0, s.P, [&](int l, int p) -> float {
    return l < c.Lc ? to_f32(dy[((c.row + l) * s.H + c.h) * s.P + p]) : 0.0f;
  }, [&](int p, int j) -> float {
    if (j >= c.Lc) return 0.0f;
    const long r = (c.row + j) * s.H + c.h;
    return to_f32(x[r * s.P + p]) * dt[r];
  });
  float* out = w.dcb + i * s.L * s.L;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int l = m0 + 4 * ty + a, j = n0 + 4 * tx + b;
      if (l < c.Lc && j < c.Lc)
        out[l * s.L + j] = j <= l ? acc[a][b] * ex(ca[l] - ca[j]) : 0.0f;
    }
}

// ---------------------------------------------------------------- 6. dx
// blockIdx.x: (b H + h) nc + k; blockIdx.y: the tile of 64 rows
template <typename T>
__global__ void __launch_bounds__(NT)
bwd_dx(const T* __restrict__ x, const float* __restrict__ dt,
       const T* __restrict__ dy, const T* __restrict__ bm,
       const T* __restrict__ cm, T* __restrict__ dx, Scratch w, Shape s) {
  __shared__ float srow[TM][3];
  const long i = blockIdx.x;
  const Chunk c = chunk_of(i, s, s.H);
  const int m0 = blockIdx.y * TM;
  if (m0 >= c.Lc) return;
  const int g = c.h / s.rep;
  const double* ca = w.ca + c.bh * s.T + c.c0;
  const double last = ca[c.Lc - 1];
  const long PN = static_cast<long>(s.P) * s.N;
  const float* hk = w.st + i * PN;
  const float* gk = w.ut + i * PN;
  const float* cbk =
      w.cb + ((static_cast<long>(c.b) * s.G + g) * s.nc + c.k) * s.L * s.L;
  const float* dcbk = w.dcb + i * s.L * s.L;
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
  auto bc_row = [&](const T* m, int l, int n) -> float {
    return l < c.Lc ? to_f32(m[((c.row + l) * s.G + g) * s.N + n]) : 0.0f;
  };
  auto at = [&](int l) { return (c.row + l) * s.H + c.h; };
  float rs[4][3] = {};   // a row's exp(ca) dy . h_k c, xbar . G_k b, dxbar . x
  for (int p0 = 0; p0 < s.P; p0 += TN) {
    float a1[4][4] = {}, a2[4][4] = {}, a3[4][4] = {};
    tile_product(a1, m0, p0, 0, s.N,
                 [&](int l, int n) { return bc_row(cm, l, n); },
                 [&](int n, int p) -> float {
                   return p < s.P ? hk[static_cast<long>(p) * s.N + n] : 0.0f;
                 });
    tile_product(a2, m0, p0, 0, s.N,
                 [&](int l, int n) { return bc_row(bm, l, n); },
                 [&](int n, int p) -> float {
                   return p < s.P ? gk[static_cast<long>(p) * s.N + n] : 0.0f;
                 });
    // sum_{j >= l} M[j][l] dy_j
    tile_product(a3, m0, p0, m0, c.Lc, [&](int l, int j) -> float {
      return l < c.Lc && j >= l ? cbk[j * s.L + l] * ex(ca[j] - ca[l])
                                : 0.0f;
    }, [&](int j, int p) -> float {
      return p < s.P ? to_f32(dy[at(j) * s.P + p]) : 0.0f;
    });
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int l = m0 + 4 * ty + a;
      const bool ok = l < c.Lc;
      const float wl = ok ? ex(last - ca[l]) : 0.0f;
      const float el = ok ? ex(ca[l]) : 0.0f;
      const float dtl = ok ? dt[at(l)] : 0.0f;
      float r0 = 0.0f, r1 = 0.0f, r2 = 0.0f;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int p = p0 + 4 * tx + b;
        if (!ok || p >= s.P) continue;
        const long e = at(l) * s.P + p;
        const float xv = to_f32(x[e]), dyv = to_f32(dy[e]);
        const float dxbar = wl * a2[a][b] + a3[a][b];
        dx[e] = from_f32<T>(dxbar * dtl);
        r0 = fmaf(el * dyv, a1[a][b], r0);
        r1 = fmaf(xv * dtl, a2[a][b], r1);
        r2 = fmaf(dxbar, xv, r2);
      }
      rs[a][0] += row_sum16(r0);
      rs[a][1] += row_sum16(r1);
      rs[a][2] += row_sum16(r2);
    }
  }
  if (tx == 0)
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < 3; ++q) srow[4 * ty + a][q] = rs[a][q];
  __syncthreads();
  // the decays' term: sum_s dcb[l][s] cb[l][s] - sum_j dcb[j][l] cb[j][l],
  // four threads a row
  const int l = m0 + t / 4, q = t % 4;
  float d = 0.0f;
  if (l < c.Lc) {
    for (int j = q; j <= l; j += 4) d += dcbk[l * s.L + j] * cbk[l * s.L + j];
    for (int j = l + q; j < c.Lc; j += 4)
      d -= dcbk[j * s.L + l] * cbk[j * s.L + l];
  }
  d += __shfl_xor_sync(0xffffffffu, d, 1);
  d += __shfl_xor_sync(0xffffffffu, d, 2);
  if (q == 0 && l < c.Lc) {
    const long tt = c.bh * s.T + c.c0 + l;
    w.qa[tt] = srow[l - m0][0] + d;
    w.qr[tt] = ex(last - ca[l]) * srow[l - m0][1];
    w.qx[tt] = srow[l - m0][2];
  }
}

// --------------------------------------------------------------- 7. dbc
// blockIdx.x: (b G + g) nc + k; blockIdx.y: the (L, N) tile; blockIdx.z: 0
// for dc, 1 for db.  The reduction runs over the group's heads in order,
// P + Lc terms a head.
template <typename T>
__global__ void __launch_bounds__(NT)
bwd_dbc(const T* __restrict__ x, const float* __restrict__ dt,
        const T* __restrict__ dy, const T* __restrict__ bm,
        const T* __restrict__ cm, T* __restrict__ db, T* __restrict__ dc,
        Scratch w, Shape s) {
  const long i = blockIdx.x;
  const Chunk c = chunk_of(i, s, s.G);
  const int g = c.h, ntn = (s.N + TN - 1) / TN;
  const int m0 = (blockIdx.y / ntn) * TM, n0 = (blockIdx.y % ntn) * TN;
  if (m0 >= c.Lc) return;
  const int KH = s.P + c.Lc;
  const long LL = static_cast<long>(s.L) * s.L;
  const long PN = static_cast<long>(s.P) * s.N;
  const long bh0 = static_cast<long>(c.b) * s.H + g * s.rep;
  auto bc_at = [&](const T* m, int l, int n) -> float {
    return to_f32(m[((c.row + l) * s.G + g) * s.N + n]);
  };
  float acc[4][4] = {};
  if (blockIdx.z == 0) {
    // dc[l][n] = sum_h exp(ca_l) (h_k^T dy_l)[n] + sum_{s <= l} dcb[l][s] b_s
    tile_product(acc, m0, n0, 0, s.rep * KH, [&](int l, int kk) -> float {
      if (l >= c.Lc) return 0.0f;
      const int jh = kk / KH, r = kk % KH;
      const long bh = bh0 + jh;
      if (r < s.P)
        return ex(w.ca[bh * s.T + c.c0 + l]) *
               to_f32(dy[((c.row + l) * s.H + g * s.rep + jh) * s.P + r]);
      const int j = r - s.P;
      return j <= l ? w.dcb[(bh * s.nc + c.k) * LL + l * s.L + j] : 0.0f;
    }, [&](int kk, int n) -> float {
      if (n >= s.N) return 0.0f;
      const int jh = kk / KH, r = kk % KH;
      if (r < s.P)
        return w.st[((bh0 + jh) * s.nc + c.k) * PN +
                    static_cast<long>(r) * s.N + n];
      return bc_at(bm, r - s.P, n);
    });
  } else {
    // db[j][n] = sum_h w_j xbar_j^T G_k + sum_{l >= j} dcb[l][j] c_l
    tile_product(acc, m0, n0, 0, s.rep * KH, [&](int j, int kk) -> float {
      if (j >= c.Lc) return 0.0f;
      const int jh = kk / KH, r = kk % KH;
      const long bh = bh0 + jh;
      if (r < s.P) {
        const double* ca = w.ca + bh * s.T + c.c0;
        const long e = (c.row + j) * s.H + g * s.rep + jh;
        return ex(ca[c.Lc - 1] - ca[j]) * to_f32(x[e * s.P + r]) * dt[e];
      }
      const int l = r - s.P;
      return l >= j ? w.dcb[(bh * s.nc + c.k) * LL + l * s.L + j] : 0.0f;
    }, [&](int kk, int n) -> float {
      if (n >= s.N) return 0.0f;
      const int jh = kk / KH, r = kk % KH;
      if (r < s.P)
        return w.ut[((bh0 + jh) * s.nc + c.k) * PN +
                    static_cast<long>(r) * s.N + n];
      return bc_at(cm, r - s.P, n);
    });
  }
  T* out = blockIdx.z == 0 ? dc : db;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int l = m0 + 4 * ty + a, n = n0 + 4 * tx + b;
      if (l < c.Lc && n < s.N)
        out[((c.row + l) * s.G + g) * s.N + n] = from_f32<T>(acc[a][b]);
    }
}

// --------------------------------------------------------------- 8. ddt
// a block per (batch, head), over its chunks in order
__global__ void __launch_bounds__(NT)
bwd_ddt(const float* __restrict__ dt, const float* __restrict__ A,
        float* __restrict__ ddt, Scratch w, Shape s) {
  __shared__ float red[NT / 32];
  const long bh = blockIdx.x;
  const int h = static_cast<int>(bh % s.H), b = static_cast<int>(bh / s.H);
  const long PN = static_cast<long>(s.P) * s.N;
  const float a = A[h];
  float dap = 0.0f;
  for (int k = 0; k < s.nc; ++k) {
    const long base = (bh * s.nc + k) * PN;
    float v = 0.0f;
    for (long e = threadIdx.x; e < PN; e += NT)
      v = fmaf(w.ut[base + e], w.st[base + e], v);
    v = repro::warp_sum(v);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    if (threadIdx.x == 0) {
      float dcd = 0.0f;
      for (int q = 0; q < NT / 32; ++q) dcd += red[q];
      const int c0 = k * s.L, Lc = min(s.L, s.T - c0);
      const long t0 = bh * s.T + c0;
      float sr = 0.0f;
      for (int l = 0; l < Lc; ++l) sr += w.qr[t0 + l];
      float acc = 0.0f;   // the reverse cumsum of dca
      for (int l = Lc - 1; l >= 0; --l) {
        float dca = w.qa[t0 + l] - w.qr[t0 + l];
        if (l == Lc - 1) dca += w.cd[bh * s.nc + k] * dcd + sr;
        acc += dca;
        const long r = (static_cast<long>(b) * s.T + c0 + l) * s.H + h;
        ddt[r] = w.qx[t0 + l] + acc * a;
        dap = fmaf(acc, dt[r], dap);
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) w.dap[bh] = dap;
}

// ---------------------------------------------------------------- 9. dA
__global__ void __launch_bounds__(NT)
bwd_da(float* __restrict__ dA, Scratch w, Shape s) {
  for (int h = threadIdx.x; h < s.H; h += NT) {
    float v = 0.0f;
    for (int b = 0; b < s.B; ++b) v += w.dap[static_cast<long>(b) * s.H + h];
    dA[h] = v;
  }
}

unsigned blocks(long n) { return static_cast<unsigned>((n + NT - 1) / NT); }

template <typename T>
int run(const void* x_, const float* dt, const float* A, const void* b_,
        const void* c_, const float* h0, const void* dy_, const float* dhf,
        void* dx_, float* ddt, float* dA, void* db_, void* dc_, float* dh0,
        float* scratch, const Shape& s, cudaStream_t st) {
  const T* x = static_cast<const T*>(x_);
  const T* bm = static_cast<const T*>(b_);
  const T* cm = static_cast<const T*>(c_);
  const T* dy = static_cast<const T*>(dy_);
  Scratch w;
  carve(scratch, s, &w);
  const long BH = static_cast<long>(s.B) * s.H;
  const long BG = static_cast<long>(s.B) * s.G;
  const unsigned tp = (s.P + TM - 1) / TM, tn = (s.N + TN - 1) / TN,
                 tl = (s.L + TM - 1) / TM;
  bwd_decay<<<blocks(BH * s.nc), NT, 0, st>>>(dt, A, w, s);
  bwd_states<T><<<dim3(BH * s.nc, tp * tn, 2), NT, 0, st>>>(x, dt, dy, bm,
                                                            cm, w, s);
  bwd_pass<<<blocks(BH * s.P * s.N), NT, 0, st>>>(h0, dhf, dh0, w, s);
  bwd_cb<T><<<dim3(BG * s.nc, tl * tl), NT, 0, st>>>(bm, cm, w, s);
  bwd_dcb<T><<<dim3(BH * s.nc, tl * tl), NT, 0, st>>>(x, dt, dy, w, s);
  bwd_dx<T><<<dim3(BH * s.nc, tl), NT, 0, st>>>(
      x, dt, dy, bm, cm, static_cast<T*>(dx_), w, s);
  bwd_dbc<T><<<dim3(BG * s.nc, tl * tn, 2), NT, 0, st>>>(
      x, dt, dy, bm, cm, static_cast<T*>(db_), static_cast<T*>(dc_), w, s);
  bwd_ddt<<<static_cast<unsigned>(BH), NT, 0, st>>>(dt, A, ddt, w, s);
  bwd_da<<<1, NT, 0, st>>>(dA, w, s);
  return static_cast<int>(cudaGetLastError());
}

bool shape_of(int B, int T, int H, int G, int P, int N, int L, Shape* s) {
  if (B <= 0 || T <= 0 || G <= 0 || H % G != 0 || P <= 0 || N <= 0 || L <= 0)
    return false;
  const int nc = chunks_of(T, &L);
  *s = Shape{B, T, H, G, P, N, L, nc, H / G};
  return true;
}


// ===================================================== bf16: the Hopper form

namespace hop {

using bf16 = __nv_bfloat16;
constexpr int LOW_PARTS = 1;   // the remainders' products of split operands
constexpr int PP = 64;         // P padded to one 64-wide column block
constexpr int LMAX = 128, PMAX = 64, NMAX = 128;

// bytes of a split state's image: two planes (high part, remainder) of
// 64 x NP bf16
__host__ __device__ constexpr int img_bytes(int np) { return 4 * PP * np; }

// byte offset of element (r, c) of a tile of `rows` rows, 64 columns a
// block, in the 128-byte swizzle (the tile 1024-byte aligned)
__device__ __forceinline__ uint32_t at(int rows, int r, int c) {
  return repro::swz128(
      static_cast<uint32_t>(((c >> 6) * rows + r) * 128 + (c & 63) * 2));
}

__device__ __forceinline__ float ld(const char* tile, int rows, int r, int c) {
  return __bfloat162float(
      *reinterpret_cast<const bf16*>(tile + at(rows, r, c)));
}

// hi = bf16(v), lo = bf16(v - hi), two values packed per register
__device__ __forceinline__ void split2(float v0, float v1, uint32_t* hi,
                                       uint32_t* lo) {
  const bf16 h0 = __float2bfloat16(v0), h1 = __float2bfloat16(v1);
  *hi = static_cast<uint32_t>(__bfloat16_as_ushort(h0)) |
        (static_cast<uint32_t>(__bfloat16_as_ushort(h1)) << 16);
  *lo = repro::pack_bf16x2(v0 - __bfloat162float(h0),
                           v1 - __bfloat162float(h1));
}

__device__ __forceinline__ float unpack(uint32_t v, int half) {
  return __bfloat162float(__ushort_as_bfloat16(
      static_cast<unsigned short>(half ? v >> 16 : v & 0xffffu)));
}

// the sum over the four threads of an accumulator row (lanes 4 g .. 4 g + 3)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// v0, v1 into columns n, n + 1 (n even) of a row of `cols` values at p
// (p pointing at column n): one 8- or 4-byte store where both columns
// exist and the row length keeps the pair aligned
__device__ __forceinline__ void store2(float* p, int n, int cols, float v0,
                                       float v1) {
  if (n + 1 < cols && cols % 2 == 0) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else if (n < cols) {
    p[0] = v0;
    if (n + 1 < cols) p[1] = v1;
  }
}

__device__ __forceinline__ void store2(bf16* p, int n, int cols, float v0,
                                       float v1) {
  if (n + 1 < cols && cols % 2 == 0) {
    *reinterpret_cast<uint32_t*>(p) = repro::pack_bf16x2(v0, v1);
  } else if (n < cols) {
    p[0] = __float2bfloat16(v0);
    if (n + 1 < cols) p[1] = __float2bfloat16(v1);
  }
}

// Rows [0, R) x columns [0, C) (C a multiple of 64) of a tile at `dst` from
// global rows of `stride` elements; rows >= valid and columns >= cols are
// zero.  vec (every row 16-byte aligned, cols % 8 == 0): 16-byte cp.async,
// complete at the caller's cp_async_wait; otherwise stores by the threads.
__device__ __forceinline__ void load_tile(char* dst, int R, int C,
                                          const bf16* src, long stride,
                                          int valid, int cols, bool vec,
                                          int tid, int nth) {
  const int cpr = C / 8;
  for (int e = tid; e < R * cpr; e += nth) {
    const int r = e / cpr, c = 8 * (e % cpr);
    char* d = dst + at(R, r, c);
    if (vec) {
      const bool ok = r < valid && c < cols;
      repro::cp_async16(d, ok ? src + r * stride + c : src, ok ? 16 : 0);
    } else {
      for (int i = 0; i < 8; ++i)
        reinterpret_cast<bf16*>(d)[i] = r < valid && c + i < cols
                                            ? src[r * stride + c + i]
                                            : __float2bfloat16(0.0f);
    }
  }
}

// `bytes` (a multiple of 16) from global memory to shared, by cp.async
__device__ __forceinline__ void load_bytes(char* dst, const char* src,
                                           int bytes, int tid, int nth) {
  for (int o = 16 * tid; o < bytes; o += 16 * nth)
    repro::cp_async16(dst + o, src + o, 16);
}

// One head's chunk rows for a block: its ca (LP doubles) and dt (zero past
// the chunk), by cp.async.
__device__ __forceinline__ void load_decay(double* cas, float* dts,
                                           const double* cag,
                                           const float* dt, const Shape& s,
                                           long bh, int k, long row0, int h,
                                           int Lc, int LP, int tid, int nth) {
  load_bytes(reinterpret_cast<char*>(cas),
             reinterpret_cast<const char*>(cag + (bh * s.nc + k) * LP),
             8 * LP, tid, nth);
  const float* src = dt + row0 * s.H + h;
  for (int l = tid; l < LP; l += nth)
    repro::cp_async4(dts + l, l < Lc ? src + static_cast<long>(l) * s.H : dt,
                     l < Lc ? 4 : 0);
}

// The (batch, group, heads) of a block of passes 2 and 4: block x =
// (b G + g) nhs + head slice, heads [h0, h0 + nh) of group g.
struct Slice {
  int b, g, h0, nh;
};

__device__ __forceinline__ Slice slice_of(const Shape& s, int hpb) {
  const int nhs = (s.rep + hpb - 1) / hpb;
  const int x = blockIdx.x, hs = x % nhs, bg = x / nhs;
  const int first = hs * hpb;
  return {bg / s.G, bg % s.G, (bg % s.G) * s.rep + first,
          min(hpb, s.rep - first)};
}

// The scratch of the Hopper form (floats, parts 1024-byte aligned).
struct Scratch {
  double* ca;   // (B, H, nc, LP): ca, constant past the chunk's end
  float* cd;    // (B, H, nc)
  float* st;    // (B, H, nc, P, N): S_k
  float* ut;    // (B, H, nc, P, N): U_k
  char* himg;   // (B, H, nc): h_k split, img_bytes(NP) each
  char* gimg;   // (B, H, nc): G_k split
  float* hdot;  // (B, H, nc, NP / 32): G_k . h_k, a partial a block
  float* qa;    // (B, H, T): the decays' term of dca
  float* qa1;   // (B, H, T): exp(ca_l) dy_l . h_k c_l
  float* qr;    // (B, H, T): w_l xbar_l . G_k b_l
  float* qx;    // (B, H, T): dxbar_l . x_l
  float* dap;   // (B, H, nc): partial sums of dA
};

inline long carve(float* base, const Shape& s, int LP, int NP, Scratch* w) {
  const long BHc = static_cast<long>(s.B) * s.H * s.nc;
  const long BT = static_cast<long>(s.B) * s.H * s.T;
  const long PN = static_cast<long>(s.P) * s.N;
  const long img = img_bytes(NP) / 4;
  const long parts[] = {2 * BHc * LP, BHc, BHc * PN, BHc * PN, BHc * img,
                        BHc * img,    BHc * 4, BT,   BT,       BT,
                        BT,           BHc};
  long off[12], n = 0;
  for (int i = 0; i < 12; ++i) {
    off[i] = n;
    n += (parts[i] + 255) & ~255L;
  }
  if (w != nullptr) {
    w->ca = reinterpret_cast<double*>(base + off[0]);
    w->cd = base + off[1];
    w->st = base + off[2];
    w->ut = base + off[3];
    w->himg = reinterpret_cast<char*>(base + off[4]);
    w->gimg = reinterpret_cast<char*>(base + off[5]);
    w->hdot = base + off[6];
    w->qa = base + off[7];
    w->qa1 = base + off[8];
    w->qr = base + off[9];
    w->qx = base + off[10];
    w->dap = base + off[11];
  }
  return n;
}

// --------------------------------------------------------------- 1. decay
// a warp per head, 8 heads a block; blockIdx.y the chunk, .z the batch
__global__ void __launch_bounds__(256)
hop_decay(const float* __restrict__ dt, const float* __restrict__ A,
          double* __restrict__ cag, float* __restrict__ cd, Shape s, int LP) {
  const int lane = threadIdx.x & 31;
  const int h = blockIdx.x * 8 + threadIdx.x / 32;
  if (h >= s.H) return;
  const int bb = blockIdx.z, k = blockIdx.y, c0 = k * s.L;
  const int Lc = min(s.L, s.T - c0);
  const long bh = static_cast<long>(bb) * s.H + h;
  const float* dtb = dt + (static_cast<long>(bb) * s.T + c0) * s.H + h;
  const float a = A[h];
  double* ca = cag + (bh * s.nc + k) * LP;
  double carry = 0.0;
  for (int l0 = 0; l0 < LP; l0 += 32) {
    const int l = l0 + lane;
    double v =
        l < Lc ? static_cast<double>(dtb[static_cast<long>(l) * s.H] * a)
               : 0.0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    ca[l] = carry + v;
    if (l == Lc - 1) cd[bh * s.nc + k] = ex(carry + v);
    carry += __shfl_sync(0xffffffffu, v, 31);
  }
}

// -------------------------------------------------------------- 2. states
// 256 threads: warpgroup 0 S_k = x'^T b (x' = x dt w), warpgroup 1 U_k =
// dy'^T c (dy' = dy exp(ca)); the primed operand is the register A operand
// (rows p, depth l), split; b and c MN-major.
template <int LP, int NP>
size_t states_smem() {
  return 2 * LP * NP * 2 + 2 * (2 * LP * PP * 2) + 2 * LP * 12 + 2 * LP * 4 +
         1024;
}

template <int LP, int NP>
__global__ void __launch_bounds__(256)
hop_states(const bf16* __restrict__ x, const float* __restrict__ dt,
           const bf16* __restrict__ dy, const bf16* __restrict__ bm,
           const bf16* __restrict__ cm, const double* __restrict__ cag,
           float* __restrict__ st, float* __restrict__ ut, Shape s, int hpb,
           int vec_x, int vec_b) {
  extern __shared__ float smem[];
  constexpr int TBN = LP * NP * 2, TX = LP * PP * 2;
  char* bt = repro::align1024(smem);
  char* ct = bt + TBN;
  char* xs[2] = {ct + TBN, ct + TBN + 2 * TX};
  char* ds[2] = {xs[0] + TX, xs[1] + TX};
  double* cas = reinterpret_cast<double*>(xs[1] + 2 * TX);   // 2 x LP
  float* dts = reinterpret_cast<float*>(cas + 2 * LP);        // 2 x LP
  float* scs = dts + 2 * LP;   // the rows' scales: dt w (S_k), exp(ca) (U_k)
  const int tid = threadIdx.x, wg = tid >> 7, lt = tid & 127;
  const int warp = lt >> 5, g = (tid & 31) >> 2, q = tid & 3;
  const Slice sl = slice_of(s, hpb);
  const int k = blockIdx.y, c0 = k * s.L, Lc = min(s.L, s.T - c0);
  const long row0 = static_cast<long>(sl.b) * s.T + c0;
  const long xrow = static_cast<long>(s.H) * s.P;
  auto stage = [&](int buf, int h) {
    load_tile(xs[buf], LP, PP, x + (row0 * s.H + h) * s.P, xrow, Lc, s.P,
              vec_x, tid, 256);
    load_tile(ds[buf], LP, PP, dy + (row0 * s.H + h) * s.P, xrow, Lc, s.P,
              vec_x, tid, 256);
    load_decay(cas + buf * LP, dts + buf * LP, cag, dt, s,
               static_cast<long>(sl.b) * s.H + h, k, row0, h, Lc, LP, tid,
               256);
    repro::cp_async_commit();
  };
  const long bc = (row0 * s.G + sl.g) * s.N;
  load_tile(bt, LP, NP, bm + bc, static_cast<long>(s.G) * s.N, Lc, s.N, vec_b,
            tid, 256);
  load_tile(ct, LP, NP, cm + bc, static_cast<long>(s.G) * s.N, Lc, s.N, vec_b,
            tid, 256);
  stage(0, sl.h0);
  for (int i = 0; i < sl.nh; ++i) {
    const int cur = i & 1, h = sl.h0 + i;
    if (i + 1 < sl.nh) {
      stage(cur ^ 1, h + 1);
      repro::cp_async_wait<1>();
    } else {
      repro::cp_async_wait<0>();
    }
    __syncthreads();
    {
      const double* ca = cas + cur * LP;
      const float* dtv = dts + cur * LP;
      const int l = lt;   // 128 threads a table, LP <= 128 rows
      if (l < LP)
        scs[wg * LP + l] = l >= Lc ? 0.0f
                           : wg == 0 ? dtv[l] * ex(ca[Lc - 1] - ca[l])
                                     : ex(ca[l]);
    }
    __syncthreads();
    const char* src = wg == 0 ? xs[cur] : ds[cur];
    const char* bop = wg == 0 ? bt : ct;
    const float* sc = scs + wg * LP;
    float acc[NP / 2];
#pragma unroll
    for (int j = 0; j < NP / 2; ++j) acc[j] = 0.0f;
    repro::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < LP / 16; ++kk) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int p = 16 * warp + g + 8 * (r & 1);
        const int l = 16 * kk + 2 * q + 8 * (r >> 1);
        split2(ld(src, LP, l, p) * sc[l], ld(src, LP, l + 1, p) * sc[l + 1],
               &ah[r], &al[r]);
      }
      const uint64_t db = repro::desc128(bop + kk * 2048, LP * 128, 1024);
      repro::wgmma_rs<NP, 1>(acc, ah, db);
      if (LOW_PARTS) repro::wgmma_rs<NP, 1>(acc, al, db);
    }
    repro::wgmma_commit();
    repro::wgmma_wait<0>();
    repro::fence_regs(acc);
    float* out = (wg == 0 ? st : ut) +
                 ((static_cast<long>(sl.b) * s.H + h) * s.nc + k) * s.P * s.N;
#pragma unroll
    for (int j = 0; j < NP / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = 16 * warp + g + 8 * r, n = 8 * j + 2 * q;
        if (p < s.P)
          store2(out + static_cast<long>(p) * s.N + n, n, s.N,
                 acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      }
    __syncthreads();
  }
}

// ---------------------------------------------------------------- 3. pass
// NP / 32 blocks of 256 threads per (batch, head) (blockIdx.x, .y): thread
// t = 256 y + x the image's row p = t / (NP / 8) and columns n0 .. n0 + 7,
// n0 = 8 (t % (NP / 8)); G_k . h_k a partial a block.
__device__ __forceinline__ void put_split(char* img, int plane, uint32_t off,
                                          const float (&v)[8]) {
  uint32_t hi[4], lo[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) split2(v[2 * i], v[2 * i + 1], &hi[i], &lo[i]);
  uint4 a, b;
  a.x = hi[0], a.y = hi[1], a.z = hi[2], a.w = hi[3];
  b.x = lo[0], b.y = lo[1], b.z = lo[2], b.w = lo[3];
  *reinterpret_cast<uint4*>(img + off) = a;
  *reinterpret_cast<uint4*>(img + plane + off) = b;
}

template <int NP>
__global__ void __launch_bounds__(256)
hop_pass(const float* __restrict__ st, const float* __restrict__ ut,
         const float* __restrict__ cd, const float* __restrict__ h0,
         const float* __restrict__ dhf, char* __restrict__ himg,
         char* __restrict__ gimg, float* __restrict__ hdot,
         float* __restrict__ dh0, Shape s) {
  constexpr int IMG = img_bytes(NP), PLANE = IMG / 2, NPB = NP / 32;
  constexpr int U = 4;   // chunks whose loads are issued together
  __shared__ float red[U][8];
  const int t = 256 * blockIdx.y + threadIdx.x;
  const int p = t / (NP / 8), n0 = 8 * (t % (NP / 8));
  const long bh = blockIdx.x, PN = static_cast<long>(s.P) * s.N;
  const long e0 = static_cast<long>(p) * s.N + n0;
  const uint32_t off = at(PP, p, n0);
  bool ok[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) ok[i] = p < s.P && n0 + i < s.N;
  float v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    v[i] = h0 != nullptr && ok[i] ? h0[bh * PN + e0 + i] : 0.0f;
  for (int k0 = 0; k0 < s.nc; k0 += U) {   // h_k: the state entering k
    float sv[U][8], cdv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = k0 + u;
      cdv[u] = k < s.nc ? cd[bh * s.nc + k] : 0.0f;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        sv[u][i] = k < s.nc && ok[i] ? st[(bh * s.nc + k) * PN + e0 + i]
                                     : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = k0 + u;
      if (k >= s.nc) break;
      put_split(himg + (bh * s.nc + k) * IMG, PLANE, off, v);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = v[i] * cdv[u] + sv[u][i];
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
    v[i] = dhf != nullptr && ok[i] ? dhf[bh * PN + e0 + i] : 0.0f;
  for (int k1 = s.nc - 1; k1 >= 0; k1 -= U) {   // G_k, from the last chunk
    float uv[U][8], hk[U][8], cdv[U], pd[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = k1 - u;
      cdv[u] = k >= 0 ? cd[bh * s.nc + k] : 0.0f;
      uint4 a, b;
      a.x = a.y = a.z = a.w = b.x = b.y = b.z = b.w = 0u;
      if (k >= 0) {
        const char* hi = himg + (bh * s.nc + k) * IMG;
        a = *reinterpret_cast<const uint4*>(hi + off);
        b = *reinterpret_cast<const uint4*>(hi + PLANE + off);
      }
      const uint32_t aw[4] = {a.x, a.y, a.z, a.w};
      const uint32_t bw[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        hk[u][i] = unpack(aw[i / 2], i & 1) + unpack(bw[i / 2], i & 1);
        uv[u][i] = k >= 0 && ok[i] ? ut[(bh * s.nc + k) * PN + e0 + i] : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = k1 - u;
      pd[u] = 0.0f;
      if (k < 0) continue;
      float gk[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) gk[i] = v[i];   // G_k
      put_split(gimg + (bh * s.nc + k) * IMG, PLANE, off, gk);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        pd[u] = fmaf(gk[i], hk[u][i], pd[u]);
        v[i] = v[i] * cdv[u] + uv[u][i];
      }
    }
    // G_k . h_k over the block, in a fixed order
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float r = repro::warp_sum(pd[u]);
      if ((threadIdx.x & 31) == 0) red[u][threadIdx.x >> 5] = r;
    }
    __syncthreads();
    const int u = threadIdx.x;
    if (u < U && k1 - u >= 0) {
      float sum = 0.0f;
      for (int w = 0; w < 8; ++w) sum += red[u][w];
      hdot[(bh * s.nc + k1 - u) * NPB + blockIdx.y] = sum;
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (ok[i]) dh0[bh * PN + e0 + i] = v[i];
}

// ------------------------------------------------------------------ 4. dx
// 128 threads a 64-row tile of the chunk (2 LP threads); warpgroup w owns
// rows s in [64 w, 64 w + 64).
template <int LP, int NP>
size_t dx_smem() {
  return 2 * LP * NP * 2 + 2 * (2 * LP * PP * 2 + img_bytes(NP)) +
         2 * LP * 12 + (LP / 16) * LP * 4 + 3 * LP * 4 + 1024;
}

template <int LP, int NP>
__global__ void __launch_bounds__(2 * LP)
hop_dx(const bf16* __restrict__ x, const float* __restrict__ dt,
       const bf16* __restrict__ dy, const bf16* __restrict__ bm,
       const bf16* __restrict__ cm, const double* __restrict__ cag,
       const char* __restrict__ gimg, bf16* __restrict__ dx,
       float* __restrict__ qa, float* __restrict__ qr, float* __restrict__ qx,
       Shape s, int hpb, int vec_x, int vec_b) {
  extern __shared__ float smem[];
  constexpr int NTH = 2 * LP, NW = NTH / 32;
  constexpr int TBN = LP * NP * 2, TX = LP * PP * 2, IMG = img_bytes(NP);
  char* bt = repro::align1024(smem);
  char* ct = bt + TBN;
  char* xs[2] = {ct + TBN, ct + TBN + 2 * TX + IMG};
  char* ds[2] = {xs[0] + TX, xs[1] + TX};
  char* gs[2] = {ds[0] + TX, ds[1] + TX};
  double* cas = reinterpret_cast<double*>(gs[1] + IMG);   // 2 x LP
  float* dts = reinterpret_cast<float*>(cas + 2 * LP);     // 2 x LP
  float* colp = dts + 2 * LP;                               // NW x LP
  float* rowv = colp + NW * LP;                             // 3 x LP
  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid & 127) >> 5, g = (tid & 31) >> 2, q = tid & 3;
  const int s0 = 64 * wg;
  const Slice sl = slice_of(s, hpb);
  const int k = blockIdx.y, c0 = k * s.L, Lc = min(s.L, s.T - c0);
  const long row0 = static_cast<long>(sl.b) * s.T + c0;
  const long xrow = static_cast<long>(s.H) * s.P;
  auto stage = [&](int buf, int h) {
    const long bh = static_cast<long>(sl.b) * s.H + h;
    load_tile(xs[buf], LP, PP, x + (row0 * s.H + h) * s.P, xrow, Lc, s.P,
              vec_x, tid, NTH);
    load_tile(ds[buf], LP, PP, dy + (row0 * s.H + h) * s.P, xrow, Lc, s.P,
              vec_x, tid, NTH);
    load_bytes(gs[buf], gimg + (bh * s.nc + k) * IMG, IMG, tid, NTH);
    load_decay(cas + buf * LP, dts + buf * LP, cag, dt, s, bh, k, row0, h, Lc,
               LP, tid, NTH);
    repro::cp_async_commit();
  };
  const long bc = (row0 * s.G + sl.g) * s.N;
  load_tile(bt, LP, NP, bm + bc, static_cast<long>(s.G) * s.N, Lc, s.N, vec_b,
            tid, NTH);
  load_tile(ct, LP, NP, cm + bc, static_cast<long>(s.G) * s.N, Lc, s.N, vec_b,
            tid, NTH);
  repro::cp_async_commit();
  stage(0, sl.h0);
  repro::cp_async_wait<1>();
  __syncthreads();
  // (B C^T)[s][l] = b_s . c_l, this warpgroup's rows
  float cbt[LP / 2];
#pragma unroll
  for (int j = 0; j < LP / 2; ++j) cbt[j] = 0.0f;
  repro::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NP / 16; ++kk)
    repro::wgmma_ss<LP, 0, 0>(
        cbt,
        repro::desc128(bt + (kk >> 2) * LP * 128 + s0 * 128 + (kk & 3) * 32,
                       16, 1024),
        repro::desc128(ct + (kk >> 2) * LP * 128 + (kk & 3) * 32, 16, 1024));
  repro::wgmma_commit();
  repro::wgmma_wait<0>();
  repro::fence_regs(cbt);
  for (int i = 0; i < sl.nh; ++i) {
    const int cur = i & 1, h = sl.h0 + i;
    if (i + 1 < sl.nh) {
      stage(cur ^ 1, h + 1);
      repro::cp_async_wait<1>();
    } else {
      repro::cp_async_wait<0>();
    }
    __syncthreads();
    const double* ca = cas + cur * LP;
    const float* dtv = dts + cur * LP;
    const double last = ca[Lc - 1];
    const char* xt = xs[cur];
    const char* dyt = ds[cur];
    const char* gi = gs[cur];
    int sr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) sr[r] = s0 + 16 * warp + g + 8 * r;
    // dM^T = x dy^T: (dy_l . x_s) at [s][l]; then M^T in its place
    float t1[LP / 2];
    {
#pragma unroll
      for (int j = 0; j < LP / 2; ++j) t1[j] = 0.0f;
      repro::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < PP / 16; ++kk)
        repro::wgmma_ss<LP, 0, 0>(
            t1, repro::desc128(xt + s0 * 128 + kk * 32, 16, 1024),
            repro::desc128(dyt + kk * 32, 16, 1024));
      repro::wgmma_commit();
      repro::wgmma_wait<0>();
      repro::fence_regs(t1);
      // the decays' term: dcb^T (.) (B C^T) summed along its rows (the
      // term of index s, subtracted) and its columns (index l, added)
      float rs[2] = {0.0f, 0.0f}, cs[LP / 4];
#pragma unroll
      for (int j = 0; j < LP / 4; ++j) cs[j] = 0.0f;
#pragma unroll
      for (int j = 0; j < LP / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, l = 8 * j + 2 * q + (e & 1);
          float v = 0.0f, m = 0.0f;
          if (l >= sr[r] && l < Lc) {
            const float dec = ex(ca[l] - ca[sr[r]]);
            m = cbt[4 * j + e] * dec;
            v = t1[4 * j + e] * dtv[sr[r]] * m;
          }
          t1[4 * j + e] = m;
          rs[r] += v;
          cs[2 * j + (e & 1)] += v;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rs[r] = quad_sum(rs[r]);
        if (q == 0) rowv[sr[r]] = rs[r];
      }
#pragma unroll
      for (int j = 0; j < LP / 4; ++j) {
        float v = cs[j];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (g == 0) colp[(tid >> 5) * LP + 8 * (j >> 1) + 2 * q + (j & 1)] = v;
      }
    }
    // t2 = b G_k^T (rows s, columns p)
    float t2[PP / 2];
#pragma unroll
    for (int j = 0; j < PP / 2; ++j) t2[j] = 0.0f;
    repro::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NP / 16; ++kk) {
      const uint64_t da = repro::desc128(
          bt + (kk >> 2) * LP * 128 + s0 * 128 + (kk & 3) * 32, 16, 1024);
      const int o = (kk >> 2) * PP * 128 + (kk & 3) * 32;
      repro::wgmma_ss<PP, 0, 0>(t2, da, repro::desc128(gi + o, 16, 1024));
      if (LOW_PARTS)
        repro::wgmma_ss<PP, 0, 0>(t2, da,
                                  repro::desc128(gi + IMG / 2 + o, 16, 1024));
    }
    repro::wgmma_commit();
    repro::wgmma_wait<0>();
    repro::fence_regs(t2);
    // qr_s = w_s xbar_s . (G_k b_s); then t2 *= w_s
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool ok = sr[r] < Lc;
      const float wl = ok ? ex(last - ca[sr[r]]) : 0.0f;
      float dot = 0.0f;
#pragma unroll
      for (int j = 0; j < PP / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& v = t2[4 * j + 2 * r + e];
          dot = fmaf(ld(xt, LP, sr[r], 8 * j + 2 * q + e), v, dot);
          v *= wl;
        }
      dot = quad_sum(dot);
      if (q == 0) rowv[LP + sr[r]] = ok ? wl * dtv[sr[r]] * dot : 0.0f;
    }
    // t2 += M^T dy, M^T[s][l] = (B C^T)[s][l] exp(ca_l - ca_s) for l >= s
    // (in t1), split, the register A operand; dy read MN-major
    repro::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < LP / 16; ++kk) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const int idx = 4 * (2 * kk + (rr >> 1)) + 2 * (rr & 1);
        split2(t1[idx], t1[idx + 1], &ah[rr], &al[rr]);
      }
      const uint64_t db = repro::desc128(dyt + kk * 2048, LP * 128, 1024);
      repro::wgmma_rs<PP, 1>(t2, ah, db);
      if (LOW_PARTS) repro::wgmma_rs<PP, 1>(t2, al, db);
    }
    repro::wgmma_commit();
    repro::wgmma_wait<0>();
    repro::fence_regs(t2);
    // dxbar = t2: dx = dxbar dt, qx_s = dxbar_s . x_s
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool ok = sr[r] < Lc;
      const float d = ok ? dtv[sr[r]] : 0.0f;
      bf16* out = dx + ((row0 + sr[r]) * s.H + h) * s.P;
      float dot = 0.0f;
#pragma unroll
      for (int j = 0; j < PP / 8; ++j) {
        const int p = 8 * j + 2 * q, i = 4 * j + 2 * r;
        dot = fmaf(t2[i], ld(xt, LP, sr[r], p), dot);
        dot = fmaf(t2[i + 1], ld(xt, LP, sr[r], p + 1), dot);
        if (ok) store2(out + p, p, s.P, t2[i] * d, t2[i + 1] * d);
      }
      dot = quad_sum(dot);
      if (q == 0) rowv[2 * LP + sr[r]] = dot;
    }
    __syncthreads();
    const long t0 = (static_cast<long>(sl.b) * s.H + h) * s.T + c0;
    for (int l = tid; l < Lc; l += NTH) {
      float v = 0.0f;
      for (int w = 0; w < NW; ++w) v += colp[w * LP + l];
      qa[t0 + l] = v - rowv[l];
      qr[t0 + l] = rowv[LP + l];
      qx[t0 + l] = rowv[2 * LP + l];
    }
    __syncthreads();
  }
}

// ----------------------------------------------------------------- 5. dbc
// blockIdx.x: b G + g; .y the chunk; .z 0 for dc (rows l), 1 for db (rows
// s).  128 threads a 64-row tile; the group's heads in order.
template <int LP, int NP>
size_t dbc_smem() {
  return 2 * LP * NP * 2 + 2 * (2 * LP * PP * 2 + img_bytes(NP)) +
         2 * LP * 12 + LP * 4 + 1024;
}

template <int LP, int NP>
__global__ void __launch_bounds__(2 * LP)
hop_dbc(const bf16* __restrict__ x, const float* __restrict__ dt,
        const bf16* __restrict__ dy, const bf16* __restrict__ bm,
        const bf16* __restrict__ cm, const double* __restrict__ cag,
        const char* __restrict__ himg, const char* __restrict__ gimg,
        bf16* __restrict__ db, bf16* __restrict__ dc, float* __restrict__ qa1,
        Shape s, int vec_x, int vec_b) {
  extern __shared__ float smem[];
  constexpr int NTH = 2 * LP;
  constexpr int TBN = LP * NP * 2, TX = LP * PP * 2, IMG = img_bytes(NP);
  char* bt = repro::align1024(smem);
  char* ct = bt + TBN;
  char* xs[2] = {ct + TBN, ct + TBN + 2 * TX + IMG};
  char* ds[2] = {xs[0] + TX, xs[1] + TX};
  char* ss[2] = {ds[0] + TX, ds[1] + TX};
  double* cas = reinterpret_cast<double*>(ss[1] + IMG);   // 2 x LP
  float* dts = reinterpret_cast<float*>(cas + 2 * LP);     // 2 x LP
  float* rowv = dts + 2 * LP;                               // LP
  const bool is_dc = blockIdx.z == 0;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid & 127) >> 5, g = (tid & 31) >> 2, q = tid & 3;
  const int r0 = 64 * wg;
  const int bb = blockIdx.x / s.G, gg = blockIdx.x % s.G;
  const int k = blockIdx.y, c0 = k * s.L, Lc = min(s.L, s.T - c0);
  const long row0 = static_cast<long>(bb) * s.T + c0;
  const long xrow = static_cast<long>(s.H) * s.P;
  const char* img = is_dc ? himg : gimg;
  auto stage = [&](int buf, int h) {
    const long bh = static_cast<long>(bb) * s.H + h;
    load_tile(xs[buf], LP, PP, x + (row0 * s.H + h) * s.P, xrow, Lc, s.P,
              vec_x, tid, NTH);
    load_tile(ds[buf], LP, PP, dy + (row0 * s.H + h) * s.P, xrow, Lc, s.P,
              vec_x, tid, NTH);
    load_bytes(ss[buf], img + (bh * s.nc + k) * IMG, IMG, tid, NTH);
    load_decay(cas + buf * LP, dts + buf * LP, cag, dt, s, bh, k, row0, h, Lc,
               LP, tid, NTH);
    repro::cp_async_commit();
  };
  const long bc = (row0 * s.G + gg) * s.N;
  if (is_dc)
    load_tile(bt, LP, NP, bm + bc, static_cast<long>(s.G) * s.N, Lc, s.N,
              vec_b, tid, NTH);
  load_tile(ct, LP, NP, cm + bc, static_cast<long>(s.G) * s.N, Lc, s.N, vec_b,
            tid, NTH);
  const int hfirst = gg * s.rep;
  stage(0, hfirst);
  int rw[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) rw[r] = r0 + 16 * warp + g + 8 * r;
  float acc[NP / 2];
#pragma unroll
  for (int j = 0; j < NP / 2; ++j) acc[j] = 0.0f;
  for (int i = 0; i < s.rep; ++i) {
    const int cur = i & 1, h = hfirst + i;
    if (i + 1 < s.rep) {
      stage(cur ^ 1, h + 1);
      repro::cp_async_wait<1>();
    } else {
      repro::cp_async_wait<0>();
    }
    __syncthreads();
    const double* ca = cas + cur * LP;
    const float* dtv = dts + cur * LP;
    const double last = ca[Lc - 1];
    // the output's rows' operand (dy for dc, x for db) and the other's
    const char* ft = is_dc ? ds[cur] : xs[cur];
    const char* ot = is_dc ? xs[cur] : ds[cur];
    const char* si = ss[cur];
    {
      // dy h_k (dc) or x G_k (db), the state split, read MN-major
      float t[NP / 2];
#pragma unroll
      for (int j = 0; j < NP / 2; ++j) t[j] = 0.0f;
      repro::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < PP / 16; ++kk) {
        const uint64_t da =
            repro::desc128(ft + r0 * 128 + kk * 32, 16, 1024);
        repro::wgmma_ss<NP, 0, 1>(
            t, da, repro::desc128(si + kk * 2048, PP * 128, 1024));
        if (LOW_PARTS)
          repro::wgmma_ss<NP, 0, 1>(
              t, da, repro::desc128(si + IMG / 2 + kk * 2048, PP * 128, 1024));
      }
      repro::wgmma_commit();
      repro::wgmma_wait<0>();
      repro::fence_regs(t);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const bool ok = rw[r] < Lc;
        const float sc = !ok ? 0.0f
                         : is_dc ? ex(ca[rw[r]])
                                 : ex(last - ca[rw[r]]) * dtv[rw[r]];
        float dot = 0.0f;
#pragma unroll
        for (int j = 0; j < NP / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int idx = 4 * j + 2 * r + e;
            if (is_dc)
              dot = fmaf(t[idx], ld(ct, LP, rw[r], 8 * j + 2 * q + e), dot);
            acc[idx] = fmaf(sc, t[idx], acc[idx]);
          }
        if (is_dc) {
          dot = quad_sum(dot);
          if (q == 0) rowv[rw[r]] = sc * dot;
        }
      }
    }
    // D = F O^T: dM (dc, [l][s]) or dM^T (db, [s][l])
    float d[LP / 2];
#pragma unroll
    for (int j = 0; j < LP / 2; ++j) d[j] = 0.0f;
    repro::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < PP / 16; ++kk)
      repro::wgmma_ss<LP, 0, 0>(
          d, repro::desc128(ft + r0 * 128 + kk * 32, 16, 1024),
          repro::desc128(ot + kk * 32, 16, 1024));
    repro::wgmma_commit();
    repro::wgmma_wait<0>();
    repro::fence_regs(d);
    // acc += dcb b (dc) or dcb^T c (db): dcb = dM dt_s exp(ca_l - ca_s),
    // s <= l, split, the register A operand; b or c read MN-major
    auto dcb = [&](int row, int col, float v) -> float {
      if (is_dc)
        return col <= row && row < Lc ? v * dtv[col] * ex(ca[row] - ca[col])
                                      : 0.0f;
      return col >= row && col < Lc ? v * dtv[row] * ex(ca[col] - ca[row])
                                    : 0.0f;
    };
    const char* yt = is_dc ? bt : ct;
    repro::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < LP / 16; ++kk) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const int r = rr & 1, cb = rr >> 1;
        const int idx = 4 * (2 * kk + cb) + 2 * r;
        const int col = 16 * kk + 8 * cb + 2 * q;
        split2(dcb(rw[r], col, d[idx]), dcb(rw[r], col + 1, d[idx + 1]),
               &ah[rr], &al[rr]);
      }
      const uint64_t dbd = repro::desc128(yt + kk * 2048, LP * 128, 1024);
      repro::wgmma_rs<NP, 1>(acc, ah, dbd);
      if (LOW_PARTS) repro::wgmma_rs<NP, 1>(acc, al, dbd);
    }
    repro::wgmma_commit();
    repro::wgmma_wait<0>();
    repro::fence_regs(acc);
    __syncthreads();
    if (is_dc) {
      const long t0 = (static_cast<long>(bb) * s.H + h) * s.T + c0;
      for (int l = tid; l < Lc; l += NTH) qa1[t0 + l] = rowv[l];
    }
  }
  bf16* out = is_dc ? dc : db;
#pragma unroll
  for (int j = 0; j < NP / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = 8 * j + 2 * q;
      if (rw[r] < Lc)
        store2(out + ((row0 + rw[r]) * s.G + gg) * s.N + n, n, s.N,
               acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
}

// ----------------------------------------------------------------- 6. ddt
// a warp per (batch, head, chunk), 8 heads a block: the reverse cumsum of
// dca over the chunk's rows (a warp scan in double, 32 rows a step from the
// chunk's end), ddt, and the chunk's partial of dA
__global__ void __launch_bounds__(256)
hop_ddt(const float* __restrict__ dt, const float* __restrict__ A,
        float* __restrict__ ddt, Scratch w, Shape s, int npb) {
  const int lane = threadIdx.x & 31;
  const int h = blockIdx.x * 8 + threadIdx.x / 32;
  if (h >= s.H) return;
  const int b = blockIdx.z, k = blockIdx.y, c0 = k * s.L;
  const int Lc = min(s.L, s.T - c0);
  const long bh = static_cast<long>(b) * s.H + h;
  const long t0 = bh * s.T + c0;
  float sr = 0.0f;
  for (int l = lane; l < Lc; l += 32) sr += w.qr[t0 + l];
  sr = repro::warp_sum(sr);
  float dot = 0.0f;
  for (int i = 0; i < npb; ++i) dot += w.hdot[(bh * s.nc + k) * npb + i];
  const float tail = w.cd[bh * s.nc + k] * dot + sr;
  const float a = A[h];
  double carry = 0.0;
  float dap = 0.0f;
  for (int i0 = 0; i0 < Lc; i0 += 32) {
    const int l = Lc - 1 - i0 - lane;
    double v = 0.0;
    if (l >= 0) {
      float dca = w.qa[t0 + l] + w.qa1[t0 + l] - w.qr[t0 + l];
      if (l == Lc - 1) dca += tail;
      v = dca;
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    if (l >= 0) {
      const float acc = static_cast<float>(carry + v);
      const long r = (static_cast<long>(b) * s.T + c0 + l) * s.H + h;
      ddt[r] = w.qx[t0 + l] + acc * a;
      dap = fmaf(acc, dt[r], dap);
    }
    carry += __shfl_sync(0xffffffffu, v, 31);
  }
  dap = repro::warp_sum(dap);
  if (lane == 0) w.dap[bh * s.nc + k] = dap;
}

// ------------------------------------------------------------------ 7. dA
__global__ void __launch_bounds__(256)
hop_da(float* __restrict__ dA, const float* __restrict__ dap, Shape s) {
  for (int h = threadIdx.x; h < s.H; h += 256) {
    float v = 0.0f;
    for (int b = 0; b < s.B; ++b)
      for (int k = 0; k < s.nc; ++k)
        v += dap[(static_cast<long>(b) * s.H + h) * s.nc + k];
    dA[h] = v;
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || sms < 1)
    return 1;
  return sms;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int LP, int NP>
int run(const bf16* x, const float* dt, const float* A, const bf16* bm,
        const bf16* cm, const float* h0, const bf16* dy, const float* dhf,
        bf16* dx, float* ddt, float* dA, bf16* db, bf16* dc, float* dh0,
        float* scratch, const Shape& s, cudaStream_t st) {
  Scratch w;
  carve(scratch, s, LP, NP, &w);
  const int vec_x = aligned16(x) && aligned16(dy) && s.P % 8 == 0;
  const int vec_b = aligned16(bm) && aligned16(cm) && s.N % 8 == 0;
  // heads split over enough blocks of passes 2 and 4 to fill the card twice
  const long base = static_cast<long>(s.B) * s.G * s.nc;
  const long fill = (2L * sm_count() + base - 1) / base;
  const int slices =
      static_cast<int>(std::max(1L, std::min(static_cast<long>(s.rep), fill)));
  const int hpb = (s.rep + slices - 1) / slices;
  const int nhs = (s.rep + hpb - 1) / hpb;
  const size_t sm_s = states_smem<LP, NP>(), sm_x = dx_smem<LP, NP>(),
               sm_c = dbc_smem<LP, NP>();
  const std::pair<const void*, size_t> big[] = {
      {reinterpret_cast<const void*>(hop_states<LP, NP>), sm_s},
      {reinterpret_cast<const void*>(hop_dx<LP, NP>), sm_x},
      {reinterpret_cast<const void*>(hop_dbc<LP, NP>), sm_c}};
  for (const auto& k : big) {
    const cudaError_t e = cudaFuncSetAttribute(
        k.first, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(k.second));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 heads8((s.H + 7) / 8, s.nc, s.B);
  const unsigned slabs = static_cast<unsigned>(base / s.nc * nhs);
  hop_decay<<<heads8, 256, 0, st>>>(dt, A, w.ca, w.cd, s, LP);
  hop_states<LP, NP><<<dim3(slabs, s.nc), 256, sm_s, st>>>(
      x, dt, dy, bm, cm, w.ca, w.st, w.ut, s, hpb, vec_x, vec_b);
  hop_pass<NP><<<dim3(static_cast<unsigned>(static_cast<long>(s.B) * s.H),
                      NP / 32), 256, 0, st>>>(w.st, w.ut, w.cd, h0, dhf,
                                              w.himg, w.gimg, w.hdot, dh0, s);
  hop_dx<LP, NP><<<dim3(slabs, s.nc), 2 * LP, sm_x, st>>>(
      x, dt, dy, bm, cm, w.ca, w.gimg, dx, w.qa, w.qr, w.qx, s, hpb, vec_x,
      vec_b);
  hop_dbc<LP, NP><<<dim3(s.B * s.G, s.nc, 2), 2 * LP, sm_c, st>>>(
      x, dt, dy, bm, cm, w.ca, w.himg, w.gimg, db, dc, w.qa1, s, vec_x,
      vec_b);
  hop_ddt<<<heads8, 256, 0, st>>>(dt, A, ddt, w, s, NP / 32);
  hop_da<<<1, 256, 0, st>>>(dA, w.dap, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace hop

// Whether a call takes the Hopper form: bf16 within its limits.
bool hopper_form(const Shape& s, int bf16) {
  return bf16 && s.L <= hop::LMAX && s.P <= hop::PMAX && s.N <= hop::NMAX;
}

int tile64(int v) { return v <= 64 ? 64 : 128; }

}  // namespace

// The scratch's floats for a call of ssd_scan_bwd at this shape.
extern "C" long ssd_scan_bwd_scratch(int B, int T, int H, int G, int P, int N,
                                     int L, int bf16) {
  Shape s;
  if (!shape_of(B, T, H, G, P, N, L, &s)) return 0;
  if (hopper_form(s, bf16))
    return hop::carve(nullptr, s, tile64(s.L), tile64(s.N), nullptr);
  return carve(nullptr, s, nullptr);
}

// 1 where a call at this shape runs the Hopper form (bf16 on wgmma), 0 where
// it runs the passes on the CUDA cores.
extern "C" int ssd_scan_bwd_form(int B, int T, int H, int G, int P, int N,
                                 int L, int bf16) {
  Shape s;
  return shape_of(B, T, H, G, P, N, L, &s) && hopper_form(s, bf16) ? 1 : 0;
}

// x, b, c, dy and dx, db, dc of type bf16 ? bf16 : fp32; dt, A, h0
// (nullable), dh_final (nullable) and ddt, dA, dh0 fp32; scratch:
// ssd_scan_bwd_scratch(..., bf16) floats, 16-byte aligned.
extern "C" int ssd_scan_bwd(const void* x, const float* dt, const float* A,
                            const void* b, const void* c, const float* h0,
                            const void* dy, const float* dhf, void* dx,
                            float* ddt, float* dA, void* db, void* dc,
                            float* dh0, float* scratch, int B, int T, int H,
                            int G, int P, int N, int L, int bf16,
                            void* stream) {
  Shape s;
  if (H <= 0) return 0;
  if (!shape_of(B, T, H, G, P, N, L, &s))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hopper_form(s, bf16)) {
    using hop::bf16;
    auto go = [&](auto fn) {
      return fn(static_cast<const bf16*>(x), dt, A,
                static_cast<const bf16*>(b), static_cast<const bf16*>(c), h0,
                static_cast<const bf16*>(dy), dhf, static_cast<bf16*>(dx),
                ddt, dA, static_cast<bf16*>(db), static_cast<bf16*>(dc), dh0,
                scratch, s, st);
    };
    const int lp = tile64(s.L), np = tile64(s.N);
    if (lp == 64 && np == 64) return go(hop::run<64, 64>);
    if (lp == 64) return go(hop::run<64, 128>);
    if (np == 64) return go(hop::run<128, 64>);
    return go(hop::run<128, 128>);
  }
  if (bf16) return static_cast<int>(cudaErrorInvalidValue);
  return run<float>(x, dt, A, b, c, h0, dy, dhf, dx, ddt, dA, db, dc, dh0,
                    scratch, s, st);
}
