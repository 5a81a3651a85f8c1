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
// db and dc sum over the heads of a group, dA over (batch, time).  Nine
// launches, each a parallel pass, with the per-chunk states, their
// cotangents and the chunk matrices in a scratch buffer:
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
// Every product is a 64 x 64 output tile a block of 256 threads (4 x 4 a
// thread) with 16-deep slices of its operands staged in shared memory,
// fp32 on the CUDA cores (bf16 operands converted as they are staged, no
// TF32).  Every sum runs in a fixed order and nothing uses atomics: two
// calls give the same bits.
//
// Bound on the H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 off the tensor cores;
// the products could run on the tensor cores at 989 TFLOP/s in bf16): at
// mamba2-370m's layer (B = 4, T = 4096, H = 32, G = 1, P = 64, N = 128,
// chunk 128) the function reads x, b, c, dy (bf16), dt, h0, dh_final and
// writes dx, db, dc, ddt, dh0: ~0.1 GB; its products are ~50 G
// multiply-adds (db and dc's sums over 32 heads half of them).  The scratch
// (the states and their cotangents, 2 x 134 MB; dcb, 268 MB) is written and
// read once more.  This first kernel runs the products in fp32 on the CUDA
// cores.
//
// Layouts as the forward's: x, dx, dy (B, T, H, P), dt, ddt (B, T, H), b, c,
// db, dc (B, T, G, N), h0, dh_final, dh0 (B, H, P, N) fp32; head h reads
// group h / (H / G).  A chunk length that does not divide T leaves a shorter
// last chunk, as in the forward.
#include "common.cuh"

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

}  // namespace

// The scratch's floats for a call of ssd_scan_bwd at this shape.
extern "C" long ssd_scan_bwd_scratch(int B, int T, int H, int G, int P, int N,
                                     int L) {
  Shape s;
  if (!shape_of(B, T, H, G, P, N, L, &s)) return 0;
  return carve(nullptr, s, nullptr);
}

// x, b, c, dy and dx, db, dc of type bf16 ? bf16 : fp32; dt, A, h0
// (nullable), dh_final (nullable) and ddt, dA, dh0 fp32; scratch:
// ssd_scan_bwd_scratch(...) floats, 16-byte aligned.
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
  if (bf16)
    return run<__nv_bfloat16>(x, dt, A, b, c, h0, dy, dhf, dx, ddt, dA, db,
                              dc, dh0, scratch, s, st);
  return run<float>(x, dt, A, b, c, h0, dy, dhf, dx, ddt, dA, db, dc, dh0,
                    scratch, s, st);
}
