// Kernel 5: the Mamba-2 chunked SSD scan, forward.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan (Pallas:
// grid (B*H, chunks), one (batch*head, chunk) cell per step, the (P, N)
// fp32 state in VMEM scratch carried across the sequential chunk axis).
// On Hopper the chunk axis is a loop inside the block: one block per
// batch*head walks the chunks in order with the state in shared memory.
// Per chunk of L steps (la = dt * A, ca = cumsum(la), xbar = x * dt):
//
//   M[l][s] = (s <= l) ? (c_l . b_s) * exp(ca_l - ca_s) : 0   (mask before
//             exp, as the plain version)
//   y_l     = sum_s M[l][s] xbar_s + exp(ca_l) * (c_l @ h^T)
//   h'      = exp(ca_L) * h + sum_l exp(ca_L - ca_l) * xbar_l (x) b_l
//
// The model's layouts are read in place — x, y (B, T, H, P), dt (B, T, H),
// b, c (B, T, G, N), state (B, H, P, N) — with head h reading group
// h / (H/G): the head flattening of repro/kernels/ops.py::ssd_scan done by
// index arithmetic, so nothing is transposed or repeated.  An optional
// entry state h0 starts the scan (the JAX kernel starts at zero).  A chunk
// length that does not divide T leaves a shorter last chunk (the TPU kernel
// asserts divisibility; the chunked form is exact for any chunking).
//
// Bound: at mamba2-370m's training shape (B*H = 128, T = 4096, P = 64,
// N = 128, L = 128) one call needs ~30 GFLOP (the causal half of each
// chunk's products) and moves ~0.15 GB (bf16 x, b, c, y; fp32 dt and the
// final state): bound by bytes at the bf16 tensor-core rate (0.044 ms),
// by operations on the CUDA cores' fp32 rate (0.45 ms).  The products run
// on the CUDA cores from shared memory in 4x4 register tiles (fp32, no
// TF32); the M tile is built 32 rows at a time so state, xbar, b, c and the
// M rows fit the SM's shared memory together (217 KB at those widths).  The
// tensor cores are later work.  One block per batch*head gives 128 blocks
// at that shape, about one per SM.
#include "common.cuh"

using repro::from_f32;
using repro::to_f32;

namespace {

constexpr int NT = 256;  // 8 warps; tile_mm covers 32 x 128 outputs a pass
constexpr int LB = 32;   // rows of the M tile built at a time

size_t smem_bytes(int L, int P, int N) {
  return sizeof(double) * static_cast<size_t>(L) +  // ca
         sizeof(float) *
             (static_cast<size_t>(P) * (N + 1) +     // state h
              static_cast<size_t>(L) * (P + 1) +     // xbar
              2 * static_cast<size_t>(L) * (N + 1) + // b, c
              static_cast<size_t>(LB) * (L + 1) +    // M rows
              2 * static_cast<size_t>(L));           // exp(ca), weights
}

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

template <typename T>
__global__ void __launch_bounds__(NT)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ b,
                const T* __restrict__ c, const float* __restrict__ h0,
                T* __restrict__ y, float* __restrict__ hout, int T_, int H,
                int G, int P, int N, int L) {
  extern __shared__ float smem[];
  const int LDN = N + 1, LDP = P + 1, LDL = L + 1;
  // ca in double: exp(ca_l - ca_s) takes the difference of two sums of up
  // to L terms of la; in fp32 their rounding (~1e-5 of |ca| at the end of
  // a chunk) would become the relative error of every decay factor
  double* ca = reinterpret_cast<double*>(smem);  // L   cumsum of la
  float* hs = smem + 2 * L;         // P x LDN
  float* xs = hs + P * LDN;         // L x LDP   xbar
  float* bs = xs + L * LDP;         // L x LDN
  float* cs = bs + L * LDN;         // L x LDN
  float* ms = cs + L * LDN;         // LB x LDL  rows of M
  float* eca = ms + LB * LDL;       // L         exp(ca)
  float* w = eca + L;               // L         exp(ca_last - ca)

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;        // b * H + h
  const int bb = bh / H, h = bh % H;
  const int g = h / (H / G);
  const float a_h = A[h];
  const long xrow = static_cast<long>(H) * P;   // x/y stride over t
  const long brow = static_cast<long>(G) * N;   // b/c stride over t
  const T* xb = x + (static_cast<long>(bb) * T_ * H + h) * P;
  T* yb = y + (static_cast<long>(bb) * T_ * H + h) * P;
  const T* bgb = b + (static_cast<long>(bb) * T_ * G + g) * N;
  const T* cgb = c + (static_cast<long>(bb) * T_ * G + g) * N;
  const float* dtb = dt + static_cast<long>(bb) * T_ * H + h;

  for (int e = tid; e < P * N; e += NT) {
    const int p = e / N, n = e % N;
    hs[p * LDN + n] =
        h0 != nullptr ? h0[static_cast<long>(bh) * P * N + e] : 0.0f;
  }

  for (int c0 = 0; c0 < T_; c0 += L) {
    const int Lc = min(L, T_ - c0);
    __syncthreads();  // previous chunk done with xs, bs, cs, hs
    for (int e = tid; e < Lc * P; e += NT) {
      const int l = e / P, p = e % P;
      const long t = c0 + l;
      xs[l * LDP + p] = to_f32(xb[t * xrow + p]) * dtb[t * H];
    }
    for (int e = tid; e < Lc * N; e += NT) {
      const int l = e / N, n = e % N;
      const long t = c0 + l;
      bs[l * LDN + n] = to_f32(bgb[t * brow + n]);
      cs[l * LDN + n] = to_f32(cgb[t * brow + n]);
    }
    if (tid == 0) {
      double run = 0.0;
      for (int l = 0; l < Lc; ++l) {
        run += dtb[static_cast<long>(c0 + l) * H] * a_h;  // la in fp32
        ca[l] = run;
      }
    }
    __syncthreads();
    for (int l = tid; l < Lc; l += NT) {
      eca[l] = expf(static_cast<float>(ca[l]));
      w[l] = expf(static_cast<float>(ca[Lc - 1] - ca[l]));
    }
    __syncthreads();

    // y, LB rows at a time: build those rows of M, then y from them
    for (int lb = 0; lb < Lc; lb += LB) {
      const int rows = min(LB, Lc - lb);
      const int smax = lb + rows;  // M[l][s] = 0 for s > l
      tile_mm2(
          rows, smax, N,
          [&](int i, int n) { return cs[(lb + i) * LDN + n]; },
          [&](int n, int s) { return bs[s * LDN + n]; }, 0,
          [&](int, int) { return 0.0f; }, [&](int, int) { return 0.0f; },
          [&](int i, int s, float cb, float) {
            const int l = lb + i;
            ms[i * LDL + s] =
                s <= l ? cb * expf(static_cast<float>(ca[l] - ca[s])) : 0.0f;
          });
      __syncthreads();
      tile_mm2(
          rows, P, smax,
          [&](int i, int s) { return ms[i * LDL + s]; },
          [&](int s, int p) { return xs[s * LDP + p]; }, N,
          [&](int i, int n) { return cs[(lb + i) * LDN + n]; },
          [&](int n, int p) { return hs[p * LDN + n]; },
          [&](int i, int p, float intra, float ch) {
            const int l = lb + i;
            yb[static_cast<long>(c0 + l) * xrow + p] =
                from_f32<T>(intra + eca[l] * ch);
          });
      __syncthreads();  // M rows consumed; every read of the old h done
    }

    // h' = exp(ca_last) h + sum_l w_l xbar_l (x) b_l  (each thread updates
    // only the entries it owns)
    const float decay = eca[Lc - 1];
    tile_mm2(
        P, N, Lc, [&](int p, int l) { return xs[l * LDP + p] * w[l]; },
        [&](int l, int n) { return bs[l * LDN + n]; }, 0,
        [&](int, int) { return 0.0f; }, [&](int, int) { return 0.0f; },
        [&](int p, int n, float upd, float) {
          hs[p * LDN + n] = hs[p * LDN + n] * decay + upd;
        });
  }
  __syncthreads();
  for (int e = tid; e < P * N; e += NT) {
    const int p = e / N, n = e % N;
    hout[static_cast<long>(bh) * P * N + e] = hs[p * LDN + n];
  }
}

template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* b,
           const void* c, const float* h0, void* y, float* hout, int B,
           int T_, int H, int G, int P, int N, int L, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (G <= 0 || H % G != 0 || P <= 0 || N <= 0 || L <= 0 || T_ < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (T_ < L) L = T_ > 0 ? T_ : 1;  // a chunk no longer than the sequence
  auto kern = ssd_scan_kernel<T>;
  const size_t smem = smem_bytes(L, P, N);
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kern),
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<B * H, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(b),
      static_cast<const T*>(c), h0, static_cast<T*>(y), hout, T_, H, G, P, N,
      L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, b, c and y in the input type; dt, A, h0 (nullable) and the final state
// fp32.  The shared memory the chunk needs must fit one SM (the launch
// returns the CUDA error otherwise).
extern "C" int ssd_scan_f32(const void* x, const float* dt, const float* A,
                            const void* b, const void* c, const float* h0,
                            void* y, float* hout, int B, int T, int H, int G,
                            int P, int N, int L, void* stream) {
  return launch<float>(x, dt, A, b, c, h0, y, hout, B, T, H, G, P, N, L,
                       stream);
}

extern "C" int ssd_scan_bf16(const void* x, const float* dt, const float* A,
                             const void* b, const void* c, const float* h0,
                             void* y, float* hout, int B, int T, int H, int G,
                             int P, int N, int L, void* stream) {
  return launch<__nv_bfloat16>(x, dt, A, b, c, h0, y, hout, B, T, H, G, P,
                               N, L, stream);
}
