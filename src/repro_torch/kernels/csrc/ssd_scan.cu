// Kernel 5: the Mamba-2 chunked SSD scan, forward.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan (Pallas:
// grid (B*H, chunks), one (batch*head, chunk) cell per step, the (P, N)
// fp32 state in VMEM scratch carried across the sequential chunk axis).
// Per chunk k of L steps (la = dt * A, ca = cumsum(la) within the chunk,
// xbar = x * dt, w_l = exp(ca_L - ca_l)):
//
//   dS_k    = sum_l (w_l xbar_l) (x) b_l                         (P x N)
//   S_{k+1} = exp(ca_L) S_k + dS_k        (S_0 = h0, or zero)
//   M[l][s] = (s <= l) ? (c_l . b_s) exp(ca_l - ca_s) : 0   (mask before exp)
//   y_l     = sum_s M[l][s] xbar_s + exp(ca_l) (c_l . S_k^T)
//
// On Hopper a sequential walk over the chunks leaves the card idle (one
// block per batch*head: 128 blocks at mamba2-370m's shape).  Only the
// state passing is sequential, and it is an elementwise pass, so the scan
// runs as the chunk decomposition of Mamba-2's own GPU implementation
// (arXiv:2405.21060 §6): every chunk's own work in parallel, the state
// passed between them in one elementwise pass.  Four launches:
//
//   0. ssd_decay_kernel: ca of every (batch*head, chunk), a warp scan in
//      double, into the scratch cag[bh][k], and exp(ca_L) into dec[bh][k].
//   1. ssd_state_*: every chunk at once: its own state contribution dS_k
//      into the scratch st[bh][k].
//   2. ssd_pass_kernel: per (batch*head, state element), S_k over the
//      chunks in order (st[bh][k] becomes the state entering chunk k; bf16
//      inputs write it instead as the bf16 planes pass 3 multiplies by);
//      the final state to hout.
//   3. ssd_out_*: every chunk at once: y from the chunk's C, B, x and its
//      entering state.
//
// bf16 inputs run the products on the tensor cores (mma.sync m16n8k16, bf16
// in, fp32 accumulate; ldmatrix and 16-byte cp.async as the flash kernel).
// A block of passes 1 and 3 owns one chunk of one (batch, group) and loops
// over heads of that group: the heads share the chunk's B and C rows, so B
// and C are loaded once, C B^T (pass 3) is computed once into registers,
// and each head's x, dt, ca and state rows are prefetched with cp.async
// into a second buffer while the head before computes.  The heads of a
// group are split over as many blocks as fill the card once (two blocks a
// SM in pass 1, one in pass 3).  C, B and x are exact bf16 operands.  What
// is derived in fp32 (w xbar, the decayed M, the fp32 state S_k) is split
// where it feeds a product into a bf16 high part and the bf16 remainder,
// one product per part: v = hi + lo to ~2^-16 of |v|, so the split products
// keep the fp32 gates.  dt is folded into the derived operand (dS_k = x'^T
// b with x' = x dt w, scaled and split in registers after ldmatrix; M' = M
// dt_s so that y = M' x), so x and b stay exact.  Pass 2 writes S_k split,
// as two bf16 planes, for pass 3 to copy as it is.  In pass 3 each of the 8
// warps owns 16 rows of y: C S_k^T, scaled by exp(ca_l); then, 16 columns
// at a time, the causal part of C B^T decayed for the head in registers
// (below the diagonal block from two per-head tables, exp(ca_l - ca_e) by
// row and exp(ca_e - ca_s) dt_s by column) and fed, split, as the A operand
// of M' x (the accumulator's layout is the A fragment's).  Row tiles go to
// warps so that each scheduler's pair of warps (w, w + 4) does the same
// work (tile t and 7 - t).  Results leave through shared memory as whole
// rows (a warp's fragments alone would write 16 bytes into each of 8 rows
// per store).  These take L, P and N up to 128, 64 and 128 (padded to
// multiples of 16 with zeros); larger shapes are refused
// (cudaErrorInvalidValue).
//
// fp32 inputs take the same passes on the CUDA cores (no TF32), a block per
// (batch*head, chunk): 4x4 register tiles from shared memory (tile_mm2).
//
// Bound on the H100 SXM (data sheet: 3.35 TB/s, 989 TFLOP/s bf16): at
// mamba2-370m's training shape (B*H = 128, T = 4096, P = 64, N = 128,
// L = 128) the function needs ~30 GFLOP (the causal half of each chunk's
// products) and ~0.15 GB of bytes (bf16 x, b, c, y; fp32 dt and the final
// state): bound by bytes (0.044 ms).  The passes add the per-chunk states,
// written, passed and read again (4 x 134 MB at that shape) and read x
// twice: ~0.6 GB in all (~0.18 ms); the split products double the
// tensor-core work to ~60 GFLOP.
//
// The model's layouts are read in place — x, y (B, T, H, P), dt (B, T, H),
// b, c (B, T, G, N), state (B, H, P, N) — with head h reading group
// h / (H/G), so nothing is transposed or repeated.  An optional entry state
// h0 starts the scan (the JAX kernel starts at zero).  A chunk length that
// does not divide T leaves a shorter last chunk (the TPU kernel asserts
// divisibility).  The chunk's cumulative log-decay is summed in double: in
// fp32 the rounding of two sums (~1e-5 of |ca| at the end of a chunk)
// would become the relative error of every decay factor exp(ca_l - ca_s).
#include <algorithm>

#include "common.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr int NT = 256;                           // 8 warps
constexpr int LMAX = 128, PMAX = 64, NMAX = 128;  // tensor-core kernels
constexpr int LB = 32;   // rows of M built at a time (fp32 pass 3)

struct Shape {
  int T, H, G, P, N, L, nc;
  int hpb;   // heads per block (bf16 passes 1 and 3)
};

__host__ __device__ inline int pad16(int v) { return (v + 15) & ~15; }

// Rows [0, n) by `cols` bf16 of a tile from global rows of stride `stride`
// elements into shared rows of stride `ld`, columns up to `cpad` (a
// multiple of 8); rows >= valid and columns >= cols are zero.  vec: every
// global row is 16-byte aligned and cols % 8 == 0 (16-byte cp.async);
// otherwise element loads.
__device__ __forceinline__ void load_tile_bf16(bf16* dst, int ld,
                                               const bf16* src, long stride,
                                               int valid, int n, int cols,
                                               int cpad, bool vec) {
  if (vec) {
    const int cpr = cpad / 8;
    const bool pow2 = (cpr & (cpr - 1)) == 0;   // shifts, not divisions
    const int sh = __ffs(cpr) - 1;
    for (int e = threadIdx.x; e < n * cpr; e += blockDim.x) {
      const int r = pow2 ? e >> sh : e / cpr;
      const int c = 8 * (pow2 ? e & (cpr - 1) : e % cpr);
      const bool ok = r < valid && c < cols;
      repro::cp_async16(dst + r * ld + c, ok ? src + r * stride + c : src,
                        ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < n * cpad; e += blockDim.x) {
      const int r = e / cpad, c = e % cpad;
      dst[r * ld + c] = r < valid && c < cols ? src[r * stride + c]
                                              : __float2bfloat16(0.0f);
    }
  }
}

// dt of head h over the chunk's rows into dts (zero past Lc)
__device__ __forceinline__ void load_dt(float* dts, const float* dt,
                                        const Shape& s, int bb, int h, int c0,
                                        int Lc, int Lp) {
  const float* src = dt + (static_cast<long>(bb) * s.T + c0) * s.H + h;
  for (int l = threadIdx.x; l < Lp; l += blockDim.x)
    repro::cp_async4(dts + l, l < Lc ? src + static_cast<long>(l) * s.H : dt,
                     l < Lc ? 4 : 0);
}

// ca of head h over the chunk's rows (Lp doubles) into cas
__device__ __forceinline__ void load_ca(double* cas, const double* cag,
                                        const Shape& s, long bh, int k,
                                        int Lp) {
  const double* src = cag + (bh * s.nc + k) * Lp;
  for (int e = threadIdx.x; e < Lp / 2; e += blockDim.x)
    repro::cp_async16(cas + 2 * e, src + 2 * e, 16);
}

// hi = bf16(v), lo = bf16(v - hi), two values packed per register
__device__ __forceinline__ void split_bf16x2(float v0, float v1, uint32_t* hi,
                                             uint32_t* lo) {
  const bf16 h0 = __float2bfloat16(v0), h1 = __float2bfloat16(v1);
  *hi = static_cast<uint32_t>(__bfloat16_as_ushort(h0)) |
        (static_cast<uint32_t>(__bfloat16_as_ushort(h1)) << 16);
  *lo = repro::pack_bf16x2(v0 - __bfloat162float(h0),
                           v1 - __bfloat162float(h1));
}

// The (batch, group, heads) of a block of the bf16 passes 1 and 3: block x
// = ((b G + g) nhs + head slice), heads [first, first + nh) of group g.
struct Heads {
  int bb, h0, nh;
};

__device__ __forceinline__ Heads block_heads(const Shape& s) {
  const int per = s.H / s.G, nhs = (per + s.hpb - 1) / s.hpb;
  const int x = blockIdx.x, hs = x % nhs, bg = x / nhs;
  const int first = hs * s.hpb;
  return {bg / s.G, (bg % s.G) * per + first, min(s.hpb, per - first)};
}

// ------------------------------------------------------------- pass 0
//
// ca[l] = sum_{i <= l} dt_i a_h over each (batch*head, chunk) (la in fp32,
// summed in double), into cag[bh][k][l] for l < ld (constant past the
// chunk's end), and exp(ca_L) into dec[bh][k]: a warp per head, 8 heads a
// block, 32 steps at a time (the loads of 128 steps issued first).
__global__ void __launch_bounds__(NT)
ssd_decay_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                 double* __restrict__ cag, float* __restrict__ dec, Shape s,
                 int ld) {
  const int lane = threadIdx.x & 31;
  const int h = blockIdx.x * (NT / 32) + threadIdx.x / 32;
  if (h >= s.H) return;
  const int bb = blockIdx.z, k = blockIdx.y, c0 = k * s.L;
  const int Lc = min(s.L, s.T - c0);
  const long bh = static_cast<long>(bb) * s.H + h;
  const float* dtb = dt + (static_cast<long>(bb) * s.T + c0) * s.H + h;
  const float a_h = A[h];
  double* ca = cag + (bh * s.nc + k) * ld;
  double carry = 0.0;
  for (int l0 = 0; l0 < ld; l0 += 128) {
    float d[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int l = l0 + 32 * i + lane;
      d[i] = l < Lc ? dtb[static_cast<long>(l) * s.H] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int l = l0 + 32 * i + lane;
      double v = static_cast<double>(d[i] * a_h);
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double u = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += u;
      }
      if (l < ld) ca[l] = carry + v;
      if (l == Lc - 1)
        dec[bh * s.nc + k] = expf(static_cast<float>(carry + v));
      carry += __shfl_sync(0xffffffffu, v, 31);
    }
  }
}

// ------------------------------------------------- pass 1, tensor cores
//
// dS_k[p][n] = sum_l x'[l][p] b[l][n], x' = x dt w split (hi, lo): A is
// x^T (read from the [l][p] tile by ldmatrix.trans), scaled by dt_l w_l
// and split in registers; B is b (the [l][n] tile, ldmatrix.trans).  Warp w
// owns p rows 16 (w % 4) .. and n columns 64 (w / 4) ..: 8 n-tiles of 8.
size_t state_bf16_smem(int Lp, int Pp, int Np) {
  return sizeof(double) * 2 * Lp + sizeof(float) * 3 * Lp +
         sizeof(float) * static_cast<size_t>(Pp) * (Np + 4) +   // dS_k
         sizeof(bf16) * (static_cast<size_t>(Lp) * (Np + 8) +
                         2 * static_cast<size_t>(Lp) * (Pp + 8));
}

// a packed pair of bf16 times (s0, s1), split into (hi, lo) pairs
__device__ __forceinline__ void scale_split(uint32_t v, float s0, float s1,
                                            uint32_t* hi, uint32_t* lo) {
  const bf16 e0 = __ushort_as_bfloat16(static_cast<unsigned short>(v));
  const bf16 e1 = __ushort_as_bfloat16(static_cast<unsigned short>(v >> 16));
  split_bf16x2(__bfloat162float(e0) * s0, __bfloat162float(e1) * s1, hi, lo);
}

__global__ void __launch_bounds__(NT)
ssd_state_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                      const double* __restrict__ cag,
                      const bf16* __restrict__ b, float* __restrict__ st,
                      Shape s, int vec_x, int vec_b) {
  extern __shared__ float smem[];
  const int Lp = pad16(s.L), Pp = pad16(s.P), Np = pad16(s.N);
  const int LDP = Pp + 8, LDN = Np + 8;
  double* cas = reinterpret_cast<double*>(smem);   // 2 x Lp: ca, per buffer
  float* dts = reinterpret_cast<float*>(cas + 2 * Lp);  // 2 x Lp: dt
  float* sc = dts + 2 * Lp;                      // Lp: dt w
  float* ds = sc + Lp;                           // Pp x (Np + 4): dS_k
  bf16* bs = reinterpret_cast<bf16*>(ds + Pp * (Np + 4));   // Lp x LDN
  bf16* xst = bs + Lp * LDN;                     // 2 x Lp x LDP: x

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Heads hd = block_heads(s);
  const int k = blockIdx.y, c0 = k * s.L, Lc = min(s.L, s.T - c0);
  const int g = hd.h0 / (s.H / s.G);
  const long xrow = static_cast<long>(s.H) * s.P;
  auto stage = [&](int buf, int h) {
    load_tile_bf16(xst + buf * Lp * LDP, LDP,
                   x + ((static_cast<long>(hd.bb) * s.T + c0) * s.H + h) * s.P,
                   xrow, Lc, Lp, s.P, Pp, vec_x);
    load_dt(dts + buf * Lp, dt, s, hd.bb, h, c0, Lc, Lp);
    load_ca(cas + buf * Lp, cag, s, static_cast<long>(hd.bb) * s.H + h, k,
            Lp);
  };
  load_tile_bf16(bs, LDN,
                 b + ((static_cast<long>(hd.bb) * s.T + c0) * s.G + g) * s.N,
                 static_cast<long>(s.G) * s.N, Lc, Lp, s.N, Np, vec_b);
  stage(0, hd.h0);
  repro::cp_async_commit();

  const int p0 = 16 * (warp % 4), n0 = 64 * (warp / 4);
  const bool active = p0 < Pp && n0 < Np;
  const int gq = lane >> 2, q = lane & 3;
  for (int i = 0; i < hd.nh; ++i) {
    const int buf = i & 1, h = hd.h0 + i;
    const long bh = static_cast<long>(hd.bb) * s.H + h;
    repro::cp_async_wait<0>();   // head i has landed ...
    __syncthreads();             // ... for all; head i - 1 is done
    if (i + 1 < hd.nh) stage(buf ^ 1, h + 1);
    repro::cp_async_commit();
    const float* dtb = dts + buf * Lp;
    const double* ca = cas + buf * Lp;
    const double ca_last = ca[Lc - 1];
    for (int l = tid; l < Lp; l += NT)
      sc[l] = dtb[l] * expf(static_cast<float>(ca_last - ca[l]));
    __syncthreads();
    if (!active) continue;
    const bf16* xb = xst + buf * Lp * LDP;
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
    for (int kk = 0; kk < Lp; kk += 16) {
      const int arow = kk + (lane & 7) + (lane >> 4) * 8;
      const int acol = p0 + ((lane >> 3) & 1) * 8;
      // register r holds x^T[p][l], x^T[p][l + 1], l = kk + 2q + 8 (r / 2)
      uint32_t a[4], ah[4], al[4];
      repro::ldmatrix_x4_trans(a, xb + arow * LDP + acol);
      const float2 s0 = *reinterpret_cast<const float2*>(sc + kk + 2 * q);
      const float2 s1 = *reinterpret_cast<const float2*>(sc + kk + 2 * q + 8);
      scale_split(a[0], s0.x, s0.y, &ah[0], &al[0]);
      scale_split(a[1], s0.x, s0.y, &ah[1], &al[1]);
      scale_split(a[2], s1.x, s1.y, &ah[2], &al[2]);
      scale_split(a[3], s1.x, s1.y, &ah[3], &al[3]);
#pragma unroll
      for (int j2 = 0; j2 < 4; ++j2) {
        if (n0 + 16 * j2 >= Np) break;
        uint32_t bv[4];
        repro::ldmatrix_x4_trans(
            bv, bs + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LDN + n0 +
                    16 * j2 + (lane >> 4) * 8);
        repro::mma_bf16_16816(acc[2 * j2], ah, bv);
        repro::mma_bf16_16816(acc[2 * j2], al, bv);
        repro::mma_bf16_16816(acc[2 * j2 + 1], ah, bv + 2);
        repro::mma_bf16_16816(acc[2 * j2 + 1], al, bv + 2);
      }
    }
    // dS_k through shared memory: the warp's 16 x 64 block, then whole
    // row segments out (16-byte stores when N % 4 == 0)
    const int LDS = Np + 4;
    float* dw = ds + p0 * LDS + n0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (n0 + 8 * j < Np)
          *reinterpret_cast<float2*>(dw + (gq + 8 * r) * LDS + 8 * j +
                                     2 * q) =
              make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
    __syncwarp();
    float* sk = st + (bh * s.nc + k) * s.P * s.N;
    for (int e = lane; e < 16 * 16; e += 32) {
      const int r = e / 16, n = n0 + 4 * (e % 16), p = p0 + r;
      if (p >= s.P || n >= s.N) continue;
      float* o = sk + static_cast<long>(p) * s.N + n;
      const float* v = dw + r * LDS + 4 * (e % 16);
      if (s.N % 4 == 0)
        *reinterpret_cast<float4*>(o) = *reinterpret_cast<const float4*>(v);
      else
        for (int u = 0; u < 4 && n + u < s.N; ++u) o[u] = v[u];
    }
  }
}

// ------------------------------------------------------------- pass 2
//
// S_k over the chunks in order, per state element (V consecutive elements
// a thread); loads run 8 chunks ahead of the updates.  fp32: S_k over
// dS_k in place.  bf16: S_k split into the planes sp[bh][k] = (hi, lo),
// each P x N bf16.
template <int V, bool PLANES>
__global__ void __launch_bounds__(NT)
ssd_pass_kernel(float* __restrict__ st, const float* __restrict__ dec,
                const float* __restrict__ h0, float* __restrict__ hout,
                bf16* __restrict__ sp, int nc, long PN) {
  const long bh = blockIdx.x;
  const long e = (static_cast<long>(blockIdx.y) * NT + threadIdx.x) * V;
  if (e >= PN) return;
  float* base = st + bh * nc * PN + e;
  const float* dk = dec + bh * nc;
  float s[V], d[8][V];
#pragma unroll
  for (int v = 0; v < V; ++v)
    s[v] = h0 != nullptr ? h0[bh * PN + e + v] : 0.0f;
  for (int k0 = 0; k0 < nc; k0 += 8) {
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (k0 + u < nc) {
        if constexpr (V == 4) {
          const float4 t =
              *reinterpret_cast<const float4*>(base + (k0 + u) * PN);
          d[u][0] = t.x;
          d[u][1] = t.y;
          d[u][2] = t.z;
          d[u][3] = t.w;
        } else {
          d[u][0] = base[(k0 + u) * PN];
        }
      }
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (k0 + u < nc) {
        const long k = k0 + u;
        if constexpr (PLANES) {
          bf16* hi = sp + (bh * nc + k) * 2 * PN + e;
          uint32_t ph[(V + 1) / 2], pl[(V + 1) / 2];
#pragma unroll
          for (int v = 0; v < V; v += 2)
            split_bf16x2(s[v], v + 1 < V ? s[v + 1] : 0.0f, &ph[v / 2],
                         &pl[v / 2]);
          if constexpr (V == 4) {
            *reinterpret_cast<uint2*>(hi) = make_uint2(ph[0], ph[1]);
            *reinterpret_cast<uint2*>(hi + PN) = make_uint2(pl[0], pl[1]);
          } else {
            hi[0] = __ushort_as_bfloat16(static_cast<unsigned short>(ph[0]));
            hi[PN] = __ushort_as_bfloat16(static_cast<unsigned short>(pl[0]));
          }
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) base[k * PN + v] = s[v];
        }
        const float a = dk[k];
#pragma unroll
        for (int v = 0; v < V; ++v) s[v] = fmaf(a, s[v], d[u][v]);
      }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) hout[bh * PN + e + v] = s[v];
}

// ------------------------------------------------- pass 3, tensor cores
//
// A warp's row tile rt (rows r0 .. r0 + 15 of the chunk): its causal
// column blocks of C B^T (kb <= rt), kept in registers for every head, and
// its y accumulator over the columns of P.
struct Tile {
  static constexpr int KBN = LMAX / 16, NJ = PMAX / 8;
  int rt, r0;
  float cb[KBN][2][4];
  float acc[NJ][4];

  __device__ explicit Tile(int t) : rt(t), r0(16 * t) {}

  __device__ __forceinline__ void cb_product(const bf16* cs, const bf16* bs,
                                             int LDN, int Lp, int Np,
                                             int lane) {
#pragma unroll
    for (int kb = 0; kb < KBN; ++kb)
#pragma unroll
      for (int e = 0; e < 8; ++e) cb[kb][e / 4][e % 4] = 0.0f;
    if (r0 >= Lp) return;
    for (int kk = 0; kk < Np; kk += 16) {
      uint32_t a[4];
      repro::ldmatrix_x4(a, cs + (r0 + (lane & 15)) * LDN + kk +
                                (lane >> 4) * 8);
#pragma unroll
      for (int kb = 0; kb < KBN; ++kb) {
        if (kb > rt) break;
        uint32_t bv[4];
        repro::ldmatrix_x4(bv, bs + (16 * kb + (lane & 7) + (lane >> 4) * 8) *
                                        LDN +
                                    kk + ((lane >> 3) & 1) * 8);
        repro::mma_bf16_16816(cb[kb][0], a, bv);
        repro::mma_bf16_16816(cb[kb][1], a, bv + 2);
      }
    }
  }

  // acc = C S_k^T, S_k split (sh, sl)
  __device__ __forceinline__ void cs_product(const bf16* cs, const bf16* sh,
                                             const bf16* sl, int LDN, int Lp,
                                             int Np, int Pp, int lane) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
    if (r0 >= Lp) return;
    for (int kk = 0; kk < Np; kk += 16) {
      uint32_t a[4];
      repro::ldmatrix_x4(a, cs + (r0 + (lane & 15)) * LDN + kk +
                                (lane >> 4) * 8);
#pragma unroll
      for (int j2 = 0; j2 < NJ / 2; ++j2) {
        const int pb = 16 * j2;
        if (pb >= Pp) break;
        const int off = (pb + (lane & 7) + (lane >> 4) * 8) * LDN + kk +
                        ((lane >> 3) & 1) * 8;
        uint32_t bh4[4], bl4[4];
        repro::ldmatrix_x4(bh4, sh + off);
        repro::ldmatrix_x4(bl4, sl + off);
        repro::mma_bf16_16816(acc[2 * j2], a, bh4);
        repro::mma_bf16_16816(acc[2 * j2 + 1], a, bh4 + 2);
        repro::mma_bf16_16816(acc[2 * j2], a, bl4);
        repro::mma_bf16_16816(acc[2 * j2 + 1], a, bl4 + 2);
      }
    }
  }

  // acc = exp(ca_l) acc + M' x, 16 columns s at a time: M'[l][s] = (s <= l)
  // ? (c_l . b_s) exp(ca_l - ca_s) dt_s : 0 (rows and columns past the
  // chunk's end have c, b = 0), split (hi, lo) as the A operand (the
  // accumulator's layout is the A fragment's); x by ldmatrix.trans.  Below
  // the diagonal block the decay is rw[l][kb] cw[s].
  __device__ __forceinline__ void mx_product(const double* ca,
                                             const float* dtb,
                                             const float* cw,
                                             const float* rw, const bf16* xs,
                                             int LDP, int Lp, int Pp,
                                             int lane) {
    if (r0 >= Lp) return;
    const int gq = lane >> 2, q = lane & 3;
    const int lr[2] = {r0 + gq, r0 + gq + 8};
    const double cal[2] = {ca[lr[0]], ca[lr[1]]};
    const float e0 = expf(static_cast<float>(cal[0]));
    const float e1 = expf(static_cast<float>(cal[1]));
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      acc[j][0] *= e0;
      acc[j][1] *= e0;
      acc[j][2] *= e1;
      acc[j][3] *= e1;
    }
#pragma unroll
    for (int kb = 0; kb < KBN; ++kb) {
      if (kb > rt) break;
      float m[2][4];
      if (kb < rt) {
        const float r[2] = {rw[lr[0] * (LMAX / 16) + kb],
                            rw[lr[1] * (LMAX / 16) + kb]};
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const float2 w = *reinterpret_cast<const float2*>(
              cw + 16 * kb + 8 * jj + 2 * q);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            m[jj][e] = cb[kb][jj][e] * r[e >> 1] * (e & 1 ? w.y : w.x);
        }
      } else {
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int l = lr[e >> 1];
            const int sp_ = 16 * kb + 8 * jj + 2 * q + (e & 1);
            m[jj][e] = sp_ <= l ? cb[kb][jj][e] *
                                      expf(static_cast<float>(cal[e >> 1] -
                                                              ca[sp_])) *
                                      dtb[sp_]
                                : 0.0f;
          }
      }
      uint32_t ah[4], al[4];
      split_bf16x2(m[0][0], m[0][1], &ah[0], &al[0]);
      split_bf16x2(m[0][2], m[0][3], &ah[1], &al[1]);
      split_bf16x2(m[1][0], m[1][1], &ah[2], &al[2]);
      split_bf16x2(m[1][2], m[1][3], &ah[3], &al[3]);
#pragma unroll
      for (int d2 = 0; d2 < NJ / 2; ++d2) {
        const int pb = 16 * d2;
        if (pb >= Pp) break;
        uint32_t bv[4];
        repro::ldmatrix_x4_trans(
            bv, xs + (16 * kb + (lane & 7) + ((lane >> 3) & 1) * 8) * LDP +
                    pb + (lane >> 4) * 8);
        repro::mma_bf16_16816(acc[2 * d2], ah, bv);
        repro::mma_bf16_16816(acc[2 * d2 + 1], ah, bv + 2);
        repro::mma_bf16_16816(acc[2 * d2], al, bv);
        repro::mma_bf16_16816(acc[2 * d2 + 1], al, bv + 2);
      }
    }
  }

  // y of the tile's rows into ys (bf16, stride LDP)
  __device__ __forceinline__ void to_smem(bf16* ys, int LDP, int Lp, int Pp,
                                          int lane) const {
    if (r0 >= Lp) return;
    const int gq = lane >> 2, q = lane & 3;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int col = 8 * j;
        if (col < Pp)
          *reinterpret_cast<uint32_t*>(ys + (r0 + gq + 8 * r) * LDP + col +
                                       2 * q) =
              repro::pack_bf16x2(acc[j][2 * r], acc[j][2 * r + 1]);
      }
  }
};

size_t out_bf16_smem(int Lp, int Pp, int Np) {
  return sizeof(double) * 2 * Lp + sizeof(float) * (3 + LMAX / 16) * Lp +
         sizeof(bf16) * (static_cast<size_t>(Lp) * (Pp + 8) +   // y
                         2 * static_cast<size_t>(Lp) * (Np + 8) +
                         2 * static_cast<size_t>(Lp) * (Pp + 8) +
                         4 * static_cast<size_t>(Pp) * (Np + 8));
}

__global__ void __launch_bounds__(NT)
ssd_out_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                    const double* __restrict__ cag,
                    const bf16* __restrict__ b, const bf16* __restrict__ c,
                    const bf16* __restrict__ sp, bf16* __restrict__ y,
                    Shape s, int vec_x, int vec_b, int vec_s, int vec_y) {
  extern __shared__ float smem[];
  const int Lp = pad16(s.L), Pp = pad16(s.P), Np = pad16(s.N);
  const int LDP = Pp + 8, LDN = Np + 8;
  double* cas = reinterpret_cast<double*>(smem);   // 2 x Lp
  float* dts = reinterpret_cast<float*>(cas + 2 * Lp);  // 2 x Lp
  float* cw = dts + 2 * Lp;        // Lp: exp(ca_e - ca_s) dt_s, e = s | 15
  float* rw = cw + Lp;             // Lp x LMAX / 16: exp(ca_l - ca_e)
  bf16* ys = reinterpret_cast<bf16*>(rw + Lp * (LMAX / 16));  // Lp x LDP
  bf16* cs = ys + Lp * LDP;                        // Lp x LDN
  bf16* bs = cs + Lp * LDN;                        // Lp x LDN
  bf16* xst = bs + Lp * LDN;                       // 2 x Lp x LDP
  bf16* sst = xst + 2 * Lp * LDP;                  // 2 x (hi, lo) x Pp x LDN

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Heads hd = block_heads(s);
  const int k = blockIdx.y, c0 = k * s.L, Lc = min(s.L, s.T - c0);
  const int g = hd.h0 / (s.H / s.G);
  const long xrow = static_cast<long>(s.H) * s.P;
  const long PN = static_cast<long>(s.P) * s.N;
  auto stage = [&](int buf, int h) {
    const long bh = static_cast<long>(hd.bb) * s.H + h;
    load_tile_bf16(xst + buf * Lp * LDP, LDP,
                   x + ((static_cast<long>(hd.bb) * s.T + c0) * s.H + h) * s.P,
                   xrow, Lc, Lp, s.P, Pp, vec_x);
    load_dt(dts + buf * Lp, dt, s, hd.bb, h, c0, Lc, Lp);
    load_ca(cas + buf * Lp, cag, s, bh, k, Lp);
    const bf16* sk = sp + (bh * s.nc + k) * 2 * PN;
    for (int part = 0; part < 2; ++part)
      load_tile_bf16(sst + (2 * buf + part) * Pp * LDN, LDN, sk + part * PN,
                     s.N, s.P, Pp, s.N, Np, vec_s);
  };
  const long goff = (static_cast<long>(hd.bb) * s.T + c0) * s.G + g;
  load_tile_bf16(cs, LDN, c + goff * s.N, static_cast<long>(s.G) * s.N, Lc,
                 Lp, s.N, Np, vec_b);
  load_tile_bf16(bs, LDN, b + goff * s.N, static_cast<long>(s.G) * s.N, Lc,
                 Lp, s.N, Np, vec_b);
  stage(0, hd.h0);
  repro::cp_async_commit();
  repro::cp_async_wait<0>();
  __syncthreads();

  // warps w and w + 4 share a scheduler: row tiles t and 7 - t
  Tile t(warp < 4 ? warp : 11 - warp);
  t.cb_product(cs, bs, LDN, Lp, Np, lane);   // once for every head

  for (int i = 0; i < hd.nh; ++i) {
    const int buf = i & 1, h = hd.h0 + i;
    if (i > 0) {
      repro::cp_async_wait<0>();   // head i has landed ...
      __syncthreads();             // ... for all; head i - 1 is done
    }
    if (i + 1 < hd.nh) stage(buf ^ 1, h + 1);
    repro::cp_async_commit();
    const float* dtb = dts + buf * Lp;
    const double* ca = cas + buf * Lp;
    const bf16* xs = xst + buf * Lp * LDP;
    const bf16* sh = sst + 2 * buf * Pp * LDN;
    const bf16* sl = sh + Pp * LDN;
    // the decays factored at each column block's last step e: exp(ca_l -
    // ca_s) = exp(ca_l - ca_e) exp(ca_e - ca_s) below the diagonal block
    // (s <= e < l), where both factors lie on the same side of 1 as the
    // product (at most 1 for A < 0, as in Mamba-2)
    for (int sp_ = tid; sp_ < Lp; sp_ += NT)
      cw[sp_] = expf(static_cast<float>(ca[sp_ | 15] - ca[sp_])) * dtb[sp_];
    for (int e = tid; e < Lp * (LMAX / 16); e += NT) {
      const int l = e / (LMAX / 16), cb_end = 16 * (e % (LMAX / 16)) + 15;
      rw[e] = cb_end < l ? expf(static_cast<float>(ca[l] - ca[cb_end]))
                         : 0.0f;
    }
    t.cs_product(cs, sh, sl, LDN, Lp, Np, Pp, lane);
    __syncthreads();   // the decay tables of head i
    t.mx_product(ca, dtb, cw, rw, xs, LDP, Lp, Pp, lane);
    // y through shared memory, then whole rows out (16-byte stores with
    // vec_y)
    t.to_smem(ys, LDP, Lp, Pp, lane);
    __syncwarp();
    const int r0 = t.r0;
    if (r0 >= Lp) continue;
    bf16* yb = y + ((static_cast<long>(hd.bb) * s.T + c0) * s.H + h) * s.P;
    const int cpr = Pp / 8;
    for (int e = lane; e < 16 * cpr; e += 32) {
      const int r = e / cpr, p = 8 * (e % cpr), l = r0 + r;
      if (l >= Lc || p >= s.P) continue;
      const bf16* src = ys + l * LDP + p;
      if (vec_y)
        *reinterpret_cast<uint4*>(yb + l * xrow + p) =
            *reinterpret_cast<const uint4*>(src);
      else
        for (int u = 0; u < 8 && p + u < s.P; ++u)
          yb[l * xrow + p + u] = src[u];
    }
  }
}

// --------------------------------------------------- fp32, CUDA cores
//
// out(i, j) = sum_k a1(i, k) b1(k, j) (+ a second sum into acc2) over an
// M x N output: lane tx owns columns tx + 32c, warp ty rows ty + 8r of each
// 32 x 128 pass, so a warp reads one a-row (a broadcast) and 32 consecutive
// b-columns.
template <class A1, class B1, class A2, class B2, class S>
__device__ __forceinline__ void tile_mm2(int M, int N, int K1, A1 a1, B1 b1,
                                         int K2, A2 a2, B2 b2, S store) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int i0 = 0; i0 < M; i0 += 32)
    for (int j0 = 0; j0 < N; j0 += 128) {
      int ii[4], jj[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) ii[r] = min(i0 + ty + 8 * r, M - 1);
#pragma unroll
      for (int c = 0; c < 4; ++c) jj[c] = min(j0 + tx + 32 * c, N - 1);
      float acc1[4][4], acc2[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc1[r][c] = acc2[r][c] = 0.0f;
      for (int k = 0; k < K1; ++k) {
        float av[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) av[r] = a1(ii[r], k);
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = b1(k, jj[c]);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc1[r][c] = fmaf(av[r], bv[c], acc1[r][c]);
      }
      for (int k = 0; k < K2; ++k) {
        float av[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) av[r] = a2(ii[r], k);
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = b2(k, jj[c]);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc2[r][c] = fmaf(av[r], bv[c], acc2[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (i0 + ty + 8 * r < M && j0 + tx + 32 * c < N)
            store(ii[r], jj[c], acc1[r][c], acc2[r][c]);
    }
}

__device__ __forceinline__ void load_f32_rows(float* dst, int ld,
                                              const float* src, long stride,
                                              int rows, int cols) {
  for (int e = threadIdx.x; e < rows * cols; e += NT) {
    const int r = e / cols, n = e % cols;
    dst[r * ld + n] = src[r * stride + n];
  }
}

// The chunk's xbar = x dt (L x P, stride ld) and ca (from pass 0), for the
// fp32 passes; dts receives dt (zero past Lc).  Ends with the block
// synchronised.
__device__ __forceinline__ void chunk_f32(float* xs, int ld, double* ca,
                                          float* dts, const float* x,
                                          const float* dt,
                                          const double* cag, const Shape& s,
                                          int bb, int h, int k, int c0,
                                          int Lc) {
  const float* dtb = dt + (static_cast<long>(bb) * s.T + c0) * s.H + h;
  const double* cab =
      cag + ((static_cast<long>(bb) * s.H + h) * s.nc + k) * pad16(s.L);
  for (int l = threadIdx.x; l < s.L; l += NT) {
    dts[l] = l < Lc ? dtb[static_cast<long>(l) * s.H] : 0.0f;
    ca[l] = cab[l];
  }
  __syncthreads();
  const long xrow = static_cast<long>(s.H) * s.P;
  const float* xb = x + ((static_cast<long>(bb) * s.T + c0) * s.H + h) * s.P;
  for (int e = threadIdx.x; e < Lc * s.P; e += NT) {
    const int l = e / s.P, p = e % s.P;
    xs[l * ld + p] = xb[l * xrow + p] * dts[l];
  }
  __syncthreads();
}

// pass 1: dS_k = sum_l (w_l xbar_l) (x) b_l
size_t state_f32_smem(int L, int P, int N) {
  return (sizeof(double) + 2 * sizeof(float)) * L +
         sizeof(float) * (static_cast<size_t>(L) * (P + 1) +
                          static_cast<size_t>(L) * (N + 1));
}

__global__ void __launch_bounds__(NT)
ssd_state_f32_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                     const double* __restrict__ cag,
                     const float* __restrict__ b, float* __restrict__ st,
                     Shape s) {
  extern __shared__ float smem[];
  const int LDP = s.P + 1, LDN = s.N + 1;
  double* ca = reinterpret_cast<double*>(smem);     // L
  float* dts = reinterpret_cast<float*>(ca + s.L);  // L
  float* w = dts + s.L;                             // L
  float* xs = w + s.L;                              // L x LDP: xbar
  float* bs = xs + s.L * LDP;                       // L x LDN
  const int tid = threadIdx.x;
  const int bh = blockIdx.x, k = blockIdx.y;
  const int bb = bh / s.H, h = bh % s.H, g = h / (s.H / s.G);
  const int c0 = k * s.L, Lc = min(s.L, s.T - c0);
  load_f32_rows(bs, LDN,
                b + ((static_cast<long>(bb) * s.T + c0) * s.G + g) * s.N,
                static_cast<long>(s.G) * s.N, Lc, s.N);
  chunk_f32(xs, LDP, ca, dts, x, dt, cag, s, bb, h, k, c0, Lc);
  const double ca_last = ca[Lc - 1];
  for (int l = tid; l < Lc; l += NT)
    w[l] = expf(static_cast<float>(ca_last - ca[l]));
  __syncthreads();
  float* sk = st + (static_cast<long>(bh) * s.nc + k) * s.P * s.N;
  tile_mm2(
      s.P, s.N, Lc, [&](int p, int l) { return xs[l * LDP + p] * w[l]; },
      [&](int l, int n) { return bs[l * LDN + n]; }, 0,
      [&](int, int) { return 0.0f; }, [&](int, int) { return 0.0f; },
      [&](int p, int n, float v, float) {
        sk[static_cast<long>(p) * s.N + n] = v;
      });
}

// pass 3: y from the chunk's C, B, xbar and S_k, LB rows of M at a time
size_t out_f32_smem(int L, int P, int N) {
  return (sizeof(double) + 2 * sizeof(float)) * L +
         sizeof(float) * (static_cast<size_t>(P) * (N + 1) +     // S_k
                          static_cast<size_t>(L) * (P + 1) +     // xbar
                          2 * static_cast<size_t>(L) * (N + 1) + // b, c
                          static_cast<size_t>(LB) * (L + 1));    // M rows
}

__global__ void __launch_bounds__(NT)
ssd_out_f32_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                   const double* __restrict__ cag, const float* __restrict__ b,
                   const float* __restrict__ c, const float* __restrict__ st,
                   float* __restrict__ y, Shape s) {
  extern __shared__ float smem[];
  const int LDN = s.N + 1, LDP = s.P + 1, LDL = s.L + 1;
  double* ca = reinterpret_cast<double*>(smem);     // L
  float* dts = reinterpret_cast<float*>(ca + s.L);  // L
  float* eca = dts + s.L;                           // L
  float* hs = eca + s.L;                            // P x LDN
  float* xs = hs + s.P * LDN;                       // L x LDP
  float* bs = xs + s.L * LDP;                       // L x LDN
  float* cs = bs + s.L * LDN;                       // L x LDN
  float* ms = cs + s.L * LDN;                       // LB x LDL

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, k = blockIdx.y;
  const int bb = bh / s.H, h = bh % s.H, g = h / (s.H / s.G);
  const int c0 = k * s.L, Lc = min(s.L, s.T - c0);
  const long brow = static_cast<long>(s.G) * s.N;
  const long goff = ((static_cast<long>(bb) * s.T + c0) * s.G + g) * s.N;
  load_f32_rows(bs, LDN, b + goff, brow, Lc, s.N);
  load_f32_rows(cs, LDN, c + goff, brow, Lc, s.N);
  load_f32_rows(hs, LDN, st + (static_cast<long>(bh) * s.nc + k) * s.P * s.N,
                s.N, s.P, s.N);
  chunk_f32(xs, LDP, ca, dts, x, dt, cag, s, bb, h, k, c0, Lc);
  for (int l = tid; l < Lc; l += NT) eca[l] = expf(static_cast<float>(ca[l]));
  __syncthreads();

  const long xrow = static_cast<long>(s.H) * s.P;
  float* yb = y + ((static_cast<long>(bb) * s.T + c0) * s.H + h) * s.P;
  for (int lb = 0; lb < Lc; lb += LB) {
    const int rows = min(LB, Lc - lb);
    const int smax = lb + rows;  // M[l][s] = 0 for s > l
    tile_mm2(
        rows, smax, s.N, [&](int i, int n) { return cs[(lb + i) * LDN + n]; },
        [&](int n, int sp) { return bs[sp * LDN + n]; }, 0,
        [&](int, int) { return 0.0f; }, [&](int, int) { return 0.0f; },
        [&](int i, int sp, float cb, float) {
          const int l = lb + i;
          ms[i * LDL + sp] =
              sp <= l ? cb * expf(static_cast<float>(ca[l] - ca[sp])) : 0.0f;
        });
    __syncthreads();
    tile_mm2(
        rows, s.P, smax, [&](int i, int sp) { return ms[i * LDL + sp]; },
        [&](int sp, int p) { return xs[sp * LDP + p]; }, s.N,
        [&](int i, int n) { return cs[(lb + i) * LDN + n]; },
        [&](int n, int p) { return hs[p * LDN + n]; },
        [&](int i, int p, float intra, float ch) {
          const int l = lb + i;
          yb[l * xrow + p] = intra + eca[l] * ch;
        });
    __syncthreads();  // M rows consumed
  }
}

// ------------------------------------------------------------ launches

int chunks_of(int T, int* L) {
  if (T < *L) *L = T > 0 ? T : 1;  // a chunk no longer than the sequence
  return T > 0 ? (T + *L - 1) / *L : 0;
}

cudaError_t prepare(const void* kern, size_t smem) {
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <bool PLANES>
int pass2(float* st, const float* dec, const float* h0, float* hout,
          bf16* planes, int BH, const Shape& s, cudaStream_t stream) {
  const long PN = static_cast<long>(s.P) * s.N;
  if (PN % 4 == 0) {
    const dim3 grid(BH, static_cast<unsigned>((PN / 4 + NT - 1) / NT));
    ssd_pass_kernel<4, PLANES><<<grid, NT, 0, stream>>>(st, dec, h0, hout,
                                                        planes, s.nc, PN);
  } else {
    const dim3 grid(BH, static_cast<unsigned>((PN + NT - 1) / NT));
    ssd_pass_kernel<1, PLANES><<<grid, NT, 0, stream>>>(st, dec, h0, hout,
                                                        planes, s.nc, PN);
  }
  return static_cast<int>(cudaGetLastError());
}

int check_shape(int H, int G, int P, int N, int L, int T) {
  if (G <= 0 || H % G != 0 || P <= 0 || N <= 0 || L <= 0 || T < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// Heads per block so that B G nc (chunk, group) blocks, the heads of each
// group split `nhs` ways, fill the card's `per_sm` blocks a SM once.
int heads_per_block(int B, const Shape& s, int per_sm) {
  int dev, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long groups = static_cast<long>(B) * s.G * s.nc;
  const int per = s.H / s.G;
  const long nhs = std::max(1L, std::min<long>(per, per_sm * sms / groups));
  return static_cast<int>((per + nhs - 1) / nhs);
}

int blocks_of(int B, const Shape& s) {
  const int per = s.H / s.G;
  return B * s.G * ((per + s.hpb - 1) / s.hpb);
}

// The scratch of one call, in floats: ca (B*H, nc, pad16(L)) doubles, the
// states (B*H, nc, P, N), for bf16 inputs their planes (as many floats),
// and the chunk decays (B*H, nc).
struct Scratch {
  double* ca;
  float* st;
  bf16* planes;
  float* dec;
};

long scratch_floats(long BH, long nc, int L, int P, int N, bool planes) {
  const long states = BH * nc * P * N;
  return BH * nc * 2 * pad16(L) + (planes ? 2 : 1) * states + BH * nc;
}

Scratch carve(float* scratch, long BH, long nc, int L, int P, int N,
              bool planes) {
  const long states = BH * nc * P * N;
  float* st = scratch + BH * nc * 2 * pad16(L);
  float* after = st + states;
  return {reinterpret_cast<double*>(scratch), st,
          planes ? reinterpret_cast<bf16*>(after) : nullptr,
          after + (planes ? states : 0)};
}

int pass0(const float* dt, const float* A, const Scratch& w, int B,
          const Shape& s, cudaStream_t stream) {
  const dim3 grid((s.H + NT / 32 - 1) / (NT / 32), s.nc, B);
  ssd_decay_kernel<<<grid, NT, 0, stream>>>(dt, A, w.ca, w.dec, s,
                                            pad16(s.L));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" long ssd_scan_scratch(int B, int T, int H, int P, int N, int L,
                                 int bf16_planes) {
  const long nc = chunks_of(T, &L);
  return scratch_floats(static_cast<long>(B) * H, nc, L, P, N, bf16_planes);
}

// The largest chunk, head dim and state size the bf16 kernels take.
extern "C" void ssd_scan_bf16_limits(int* L, int* P, int* N) {
  *L = LMAX;
  *P = PMAX;
  *N = NMAX;
}

// x, b, c and y in the input type; dt, A, h0 (nullable) and the final state
// fp32; scratch: ssd_scan_scratch(...) floats.  The shared memory a chunk
// needs must fit one SM (the launch returns the CUDA error otherwise).
extern "C" int ssd_scan_f32(const void* x, const float* dt, const float* A,
                            const void* b, const void* c, const float* h0,
                            void* y, float* hout, float* scratch, int B,
                            int T, int H, int G, int P, int N, int L,
                            void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (int e = check_shape(H, G, P, N, L, T)) return e;
  const int nc = chunks_of(T, &L);
  const Shape s{T, H, G, P, N, L, nc, 1};
  const int BH = B * H;
  const Scratch w = carve(scratch, BH, nc, L, P, N, false);
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (nc > 0) {
    const size_t s1 = state_f32_smem(L, P, N), s3 = out_f32_smem(L, P, N);
    if ((e = prepare(reinterpret_cast<const void*>(ssd_state_f32_kernel),
                     s1)) != cudaSuccess ||
        (e = prepare(reinterpret_cast<const void*>(ssd_out_f32_kernel), s3)) !=
            cudaSuccess)
      return e;
    if (int r = pass0(dt, A, w, B, s, cs)) return r;
    ssd_state_f32_kernel<<<dim3(BH, nc), NT, s1, cs>>>(
        static_cast<const float*>(x), dt, w.ca, static_cast<const float*>(b),
        w.st, s);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  if (int r = pass2<false>(w.st, w.dec, h0, hout, nullptr, BH, s, cs))
    return r;
  if (nc > 0) {
    ssd_out_f32_kernel<<<dim3(BH, nc), NT, out_f32_smem(L, P, N), cs>>>(
        static_cast<const float*>(x), dt, w.ca, static_cast<const float*>(b),
        static_cast<const float*>(c), w.st, static_cast<float*>(y), s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ssd_scan_bf16(const void* x, const float* dt, const float* A,
                             const void* b, const void* c, const float* h0,
                             void* y, float* hout, float* scratch, int B,
                             int T, int H, int G, int P, int N, int L,
                             void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (int e = check_shape(H, G, P, N, L, T)) return e;
  const int nc = chunks_of(T, &L);
  if (L > LMAX || P > PMAX || N > NMAX)
    return static_cast<int>(cudaErrorInvalidValue);
  Shape s{T, H, G, P, N, L, nc, 1};
  const int BH = B * H;
  const Scratch w = carve(scratch, BH, nc, L, P, N, true);
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const int Lp = pad16(L), Pp = pad16(P), Np = pad16(N);
  const int vec_x = P % 8 == 0 && aligned16(x);
  const int vec_b = N % 8 == 0 && aligned16(b) && aligned16(c);
  const int vec_s = N % 8 == 0 && aligned16(w.planes);
  cudaError_t e;
  const size_t s1 = state_bf16_smem(Lp, Pp, Np);
  const size_t s3 = out_bf16_smem(Lp, Pp, Np);
  if (nc > 0) {
    if ((e = prepare(reinterpret_cast<const void*>(ssd_state_bf16_kernel),
                     s1)) != cudaSuccess ||
        (e = prepare(reinterpret_cast<const void*>(ssd_out_bf16_kernel),
                     s3)) != cudaSuccess)
      return e;
    if (int r = pass0(dt, A, w, B, s, cs)) return r;
    s.hpb = heads_per_block(B, s, 2);
    ssd_state_bf16_kernel<<<dim3(blocks_of(B, s), nc), NT, s1, cs>>>(
        static_cast<const bf16*>(x), dt, w.ca, static_cast<const bf16*>(b),
        w.st, s, vec_x, vec_b);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  if (int r = pass2<true>(w.st, w.dec, h0, hout, w.planes, BH, s, cs))
    return r;
  if (nc > 0) {
    s.hpb = heads_per_block(B, s, 1);
    ssd_out_bf16_kernel<<<dim3(blocks_of(B, s), nc), NT, s3, cs>>>(
        static_cast<const bf16*>(x), dt, w.ca, static_cast<const bf16*>(b),
        static_cast<const bf16*>(c), w.planes, static_cast<bf16*>(y), s,
        vec_x, vec_b, vec_s, P % 8 == 0 && aligned16(y));
  }
  return static_cast<int>(cudaGetLastError());
}
