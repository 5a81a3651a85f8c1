// Kernels 2 and 3: the fused segment kernels of runner="fused", written for
// the LSTM chain step (embedding gather -> cell -> h @ w_out + b_out ->
// log-sum-exp - gold -> acc += mean over the batch).
//
// Kernel 2, fused_advance_lstm, replaces the TPU kernel
// src/repro/kernels/segment_pallas.py::fused_advance_segment (built in
// _fused_ops.advance).  Batch rows are independent through (h, c), so one
// block owns BT rows and loops over every step of the segment in a single
// launch, its rows' [x, h] and c resident in shared memory; W, emb and
// w_out (1.3 MB + 25 KB + 98 KB at the paper's width) are read through L2
// every step.  Each chunk-entry (h, c) is written straight into page-locked
// host memory through its device mapping (the analogue of the TPU's async
// copy into ANY space), so the Level-2 copy of boundary 0 overlaps the
// segment's compute and needs no device-to-host transfer afterwards.  The
// loss accumulator couples every row: each block writes its rows' summed
// NLL per step, and a second tiny launch (acc_finalize_kernel) adds the
// partials and carries acc_{t+1} = acc_t + mean_t in a fixed order — no
// float atomics, so the result is the same on every run.  Bound: every
// block streams all of W once per step, so a step costs
// ceil(B/BT) x 1.3 MB of L2 reads (L2 bandwidth), against ~180 MFLOP of
// fp32 work; the design trades that traffic for a launch-free recurrence.
//
// Kernel 3, fused_reverse_lstm (driven from repro_torch/kernels/
// segment_fused.py), replaces segment_pallas.py::fused_reverse_segment
// (_fused_ops.reverse).  Its recompute steps run kernel 1 (lstm_cell.cu)
// over the whole batch; the kernels here walk each chunk back step by step
// (chunk_backward_kernel) and reduce the parameter gradients over batch rows
// and steps in a fixed order (grad_gemm_kernel, embed_grad_kernel) instead
// of with float atomics.  Full chunks fold into the gradient in descending
// order from zero; a short tail chunk is kept apart and added once at the
// end (add_kernel) — the association of the JAX kernel.
#include "lstm_step.cuh"

namespace {

constexpr int BT = 4;    // batch rows per block (the recurrence is row-local)
constexpr int NT = 256;  // threads per block
constexpr int NW = NT / 32;

struct Lstm {
  const float* emb;    // (V, Dx)
  const float* w;      // (Dx + Dh, 4 Dh)
  const float* b;      // (4 Dh)
  const float* w_out;  // (Dh, V)
  const float* b_out;  // (V)
  int V, Dx, Dh;
};

// ---------------------------------------------------------------- kernel 2

__global__ void __launch_bounds__(NT)
fused_advance_kernel(Lstm p, const int32_t* __restrict__ tok,
                     const int32_t* __restrict__ tgt,
                     const float* __restrict__ h0,
                     const float* __restrict__ c0, float* __restrict__ h_out,
                     float* __restrict__ c_out, float* __restrict__ bnd_h,
                     float* __restrict__ bnd_c, float* __restrict__ nll_part,
                     int T, int B, int chunk, int nc) {
  extern __shared__ float smem[];
  const int Dx = p.Dx, Dh = p.Dh, V = p.V, K = Dx + Dh;
  const long N4 = 4L * Dh;
  float* xh = smem;             // BT x K: [x_t, h_t]
  float* cs = xh + BT * K;      // BT x Dh: c_t
  float* hn = cs + BT * Dh;     // BT x Dh: h_{t+1}
  float* lg = hn + BT * Dh;     // BT x V: logits
  float* nll = lg + BT * V;     // BT
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int row0 = blockIdx.x * BT;
  const int nrows = min(BT, B - row0);

  for (int e = tid; e < BT * Dh; e += NT) {
    const int r = e / Dh, j = e % Dh;
    const long o = static_cast<long>(row0 + r) * Dh + j;
    xh[r * K + Dx + j] = r < nrows ? h0[o] : 0.0f;
    cs[r * Dh + j] = r < nrows ? c0[o] : 0.0f;
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    // chunk-entry snapshot, streamed to the host buffer while we compute
    if (t % chunk == 0 && t / chunk < nc) {
      const long base = static_cast<long>(t / chunk) * B;
      for (int e = tid; e < nrows * Dh; e += NT) {
        const int r = e / Dh, j = e % Dh;
        const long o = (base + row0 + r) * Dh + j;
        bnd_h[o] = xh[r * K + Dx + j];
        bnd_c[o] = cs[r * Dh + j];
      }
    }
    const int32_t* tok_t = tok + static_cast<long>(t) * B + row0;
    for (int e = tid; e < BT * Dx; e += NT) {
      const int r = e / Dx, d = e % Dx;
      xh[r * K + d] =
          r < nrows ? p.emb[static_cast<long>(tok_t[r]) * Dx + d] : 0.0f;
    }
    __syncthreads();

    // gates: one thread per hidden unit, all rows of the tile
    for (int j = tid; j < Dh; j += NT) {
      float a[4][BT];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float bg = p.b[g * Dh + j];
#pragma unroll
        for (int r = 0; r < BT; ++r) a[g][r] = bg;
      }
      const float* wc = p.w + j;
#pragma unroll 4
      for (int k = 0; k < K; ++k) {
        const float* wr = wc + k * N4;
        const float w0 = __ldg(wr), w1 = __ldg(wr + Dh);
        const float w2 = __ldg(wr + 2 * Dh), w3 = __ldg(wr + 3 * Dh);
#pragma unroll
        for (int r = 0; r < BT; ++r) {
          const float v = xh[r * K + k];
          a[0][r] = fmaf(v, w0, a[0][r]);
          a[1][r] = fmaf(v, w1, a[1][r]);
          a[2][r] = fmaf(v, w2, a[2][r]);
          a[3][r] = fmaf(v, w3, a[3][r]);
        }
      }
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        float cn, hh;
        repro::lstm_point(a[0][r], a[1][r], a[2][r], a[3][r], cs[r * Dh + j],
                          &cn, &hh);
        cs[r * Dh + j] = cn;
        hn[r * Dh + j] = hh;
      }
    }
    __syncthreads();

    for (int e = tid; e < BT * Dh; e += NT) {
      const int r = e / Dh, j = e % Dh;
      xh[r * K + Dx + j] = hn[e];
    }
    // logits = h' @ w_out + b_out
    for (int v = tid; v < V; v += NT) {
      float a[BT];
      const float bo = p.b_out[v];
#pragma unroll
      for (int r = 0; r < BT; ++r) a[r] = bo;
      for (int j = 0; j < Dh; ++j) {
        const float wv = __ldg(p.w_out + static_cast<long>(j) * V + v);
#pragma unroll
        for (int r = 0; r < BT; ++r) a[r] = fmaf(hn[r * Dh + j], wv, a[r]);
      }
#pragma unroll
      for (int r = 0; r < BT; ++r) lg[r * V + v] = a[r];
    }
    __syncthreads();

    // per-row NLL = logsumexp(logits) - logits[target]: one warp per row
    for (int r = warp; r < nrows; r += NW) {
      const float* l = lg + r * V;
      float m = -INFINITY;
      for (int v = lane; v < V; v += 32) m = fmaxf(m, l[v]);
      m = repro::warp_max(m);
      float s = 0.0f;
      for (int v = lane; v < V; v += 32) s += expf(l[v] - m);
      s = repro::warp_sum(s);
      if (lane == 0) {
        const int gold = tgt[static_cast<long>(t) * B + row0 + r];
        nll[r] = (m + logf(s)) - l[gold];
      }
    }
    __syncthreads();
    if (tid == 0) {
      float s = 0.0f;
      for (int r = 0; r < nrows; ++r) s += nll[r];
      nll_part[static_cast<long>(t) * gridDim.x + blockIdx.x] = s;
    }
  }

  for (int e = tid; e < nrows * Dh; e += NT) {
    const int r = e / Dh, j = e % Dh;
    const long o = static_cast<long>(row0 + r) * Dh + j;
    h_out[o] = xh[r * K + Dx + j];
    c_out[o] = cs[r * Dh + j];
  }
}

// acc_{t+1} = acc_t + (sum of the blocks' row NLLs at step t) / B, in order.
__global__ void acc_finalize_kernel(const float* __restrict__ nll_part,
                                    float* __restrict__ msum, int T, int nblk,
                                    int B, const float* __restrict__ acc0,
                                    float* __restrict__ acc_out,
                                    float* __restrict__ bnd_acc, int chunk,
                                    int nc) {
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    float s = 0.0f;
    for (int k = 0; k < nblk; ++k) s += nll_part[static_cast<long>(t) * nblk + k];
    msum[t] = s / static_cast<float>(B);
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  float a = *acc0;
  for (int t = 0; t < T; ++t) {
    if (t % chunk == 0 && t / chunk < nc) bnd_acc[t / chunk] = a;
    a = a + msum[t];
  }
  *acc_out = a;
}

// ---------------------------------------------------------------- kernel 3

// Walk one chunk back over its L steps for the block's BT rows.
// hs/cs: (L+1, B, Dh) recomputed states (index t = input of step t);
// acts: (L, B, 4Dh) gate activations; dh/dc: (B, Dh) cotangents of the
// chunk's exit state in, of its entry state out (each block owns its rows).
// Outputs per step: dz (L, B, 4Dh), dl (L, B, V) logit cotangents and
// dx (L, B, Dx) embedding-row cotangents, for the fixed-order reductions.
__global__ void __launch_bounds__(NT)
chunk_backward_kernel(Lstm p, const int32_t* __restrict__ tgt,
                      const float* __restrict__ hs,
                      const float* __restrict__ cs,
                      const float* __restrict__ acts,
                      const float* __restrict__ dacc, float* __restrict__ dh,
                      float* __restrict__ dc, float* __restrict__ dz_out,
                      float* __restrict__ dl_out, float* __restrict__ dx_out,
                      int L, int B) {
  extern __shared__ float smem[];
  const int Dx = p.Dx, Dh = p.Dh, V = p.V, K = Dx + Dh;
  const long N4 = 4L * Dh;
  float* sdh = smem;               // BT x Dh
  float* sdc = sdh + BT * Dh;      // BT x Dh
  float* sdz = sdc + BT * Dh;      // BT x 4Dh
  float* shn = sdz + BT * N4;      // BT x Dh: h_{t+1}
  float* slg = shn + BT * Dh;      // BT x V
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int row0 = blockIdx.x * BT;
  const int nrows = min(BT, B - row0);
  const float g = *dacc / static_cast<float>(B);  // d nll_row

  for (int e = tid; e < BT * Dh; e += NT) {
    const int r = e / Dh, j = e % Dh;
    const long o = static_cast<long>(row0 + r) * Dh + j;
    sdh[e] = r < nrows ? dh[o] : 0.0f;
    sdc[e] = r < nrows ? dc[o] : 0.0f;
  }

  for (int t = L - 1; t >= 0; --t) {
    const long st = static_cast<long>(t) * B + row0;  // row index of step t
    for (int e = tid; e < BT * Dh; e += NT) {
      const int r = e / Dh, j = e % Dh;
      shn[e] = r < nrows ? hs[(st + B + r) * Dh + j] : 0.0f;
    }
    __syncthreads();
    // logits of step t from h_{t+1}
    for (int v = tid; v < V; v += NT) {
      float a[BT];
      const float bo = p.b_out[v];
#pragma unroll
      for (int r = 0; r < BT; ++r) a[r] = bo;
      for (int j = 0; j < Dh; ++j) {
        const float wv = __ldg(p.w_out + static_cast<long>(j) * V + v);
#pragma unroll
        for (int r = 0; r < BT; ++r) a[r] = fmaf(shn[r * Dh + j], wv, a[r]);
      }
#pragma unroll
      for (int r = 0; r < BT; ++r) slg[r * V + v] = a[r];
    }
    __syncthreads();
    // dlogits = (softmax - onehot(target)) * dacc / B, one warp per row
    for (int r = warp; r < nrows; r += NW) {
      float* l = slg + r * V;
      float m = -INFINITY;
      for (int v = lane; v < V; v += 32) m = fmaxf(m, l[v]);
      m = repro::warp_max(m);
      float s = 0.0f;
      for (int v = lane; v < V; v += 32) s += expf(l[v] - m);
      s = repro::warp_sum(s);
      const float lse = m + logf(s);
      const int gold = tgt[st + r];
      for (int v = lane; v < V; v += 32) {
        const float d = g * expf(l[v] - lse) - (v == gold ? g : 0.0f);
        l[v] = d;
        dl_out[(st + r) * V + v] = d;
      }
    }
    __syncthreads();
    // dh += dlogits @ w_out^T: one warp per hidden unit
    for (int j = warp; j < Dh; j += NW) {
      float a[BT];
#pragma unroll
      for (int r = 0; r < BT; ++r) a[r] = 0.0f;
      for (int v = lane; v < V; v += 32) {
        const float wv = __ldg(p.w_out + static_cast<long>(j) * V + v);
#pragma unroll
        for (int r = 0; r < BT; ++r) a[r] = fmaf(slg[r * V + v], wv, a[r]);
      }
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        const float s = repro::warp_sum(a[r]);
        if (lane == 0) sdh[r * Dh + j] += s;
      }
    }
    __syncthreads();
    // the cell's vjp: one thread per hidden unit
    for (int j = tid; j < Dh; j += NT) {
      for (int r = 0; r < nrows; ++r) {
        const float* ar = acts + (st + r) * N4 + j;
        repro::GateActs a;
        a.si = ar[0];
        a.sf = ar[Dh];
        a.so = ar[2 * Dh];
        a.tg = ar[3 * Dh];
        const float c_in = cs[(st + r) * Dh + j];
        const float c_new = cs[(st + B + r) * Dh + j];
        float dz[4], dcp;
        repro::lstm_point_vjp(a, c_in, c_new, sdh[r * Dh + j],
                              sdc[r * Dh + j], dz, &dcp);
        sdc[r * Dh + j] = dcp;
        float* dzr = dz_out + (st + r) * N4 + j;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          sdz[r * N4 + q * Dh + j] = dz[q];
          dzr[q * Dh] = dz[q];
        }
      }
    }
    __syncthreads();
    // [dx, dh_t] = dz @ W^T: one warp per row of W
    for (int k = warp; k < K; k += NW) {
      float a[BT];
#pragma unroll
      for (int r = 0; r < BT; ++r) a[r] = 0.0f;
      const float* wr = p.w + static_cast<long>(k) * N4;
      for (int col = lane; col < N4; col += 32) {
        const float wv = __ldg(wr + col);
#pragma unroll
        for (int r = 0; r < BT; ++r) a[r] = fmaf(sdz[r * N4 + col], wv, a[r]);
      }
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        const float s = repro::warp_sum(a[r]);
        if (lane == 0 && r < nrows) {
          if (k < Dx)
            dx_out[(st + r) * Dx + k] = s;
          else
            sdh[r * Dh + (k - Dx)] = s;
        }
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < nrows * Dh; e += NT) {
    const int r = e / Dh, j = e % Dh;
    const long o = static_cast<long>(row0 + r) * Dh + j;
    dh[o] = sdh[e];
    dc[o] = sdc[e];
  }
}

// C[(Ka+1) x N] (+)= A_ext^T B over M rows, A_ext = [A, 1]: row Ka of C is
// the column sum of B (the bias gradient).  Each element sums its M terms
// in ascending row order, so the result does not depend on the launch.
constexpr int GT = 64;  // output tile (rows of C) x (columns of C)
constexpr int GM = 16;  // rows of A/B per shared-memory stage

__global__ void __launch_bounds__(NT)
grad_gemm_kernel(const float* __restrict__ A, int lda,
                 const float* __restrict__ Bm, int ldb, int M, int Ka, int N,
                 float* __restrict__ C, int accumulate) {
  __shared__ float As[GM][GT];
  __shared__ float Bs[GM][GT];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int ka0 = blockIdx.y * GT, n0 = blockIdx.x * GT;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.0f;

  for (int m0 = 0; m0 < M; m0 += GM) {
    for (int e = tid; e < GM * GT; e += NT) {
      const int mm = e / GT, q = e % GT, m = m0 + mm;
      const int ka = ka0 + q, n = n0 + q;
      float av = 0.0f, bv = 0.0f;
      if (m < M) {
        if (ka < Ka)
          av = A[static_cast<long>(m) * lda + ka];
        else if (ka == Ka)
          av = 1.0f;
        if (n < N) bv = Bm[static_cast<long>(m) * ldb + n];
      }
      As[mm][q] = av;
      Bs[mm][q] = bv;
    }
    __syncthreads();
    const int mmax = min(GM, M - m0);
    for (int mm = 0; mm < mmax; ++mm) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[mm][ty * 4 + i];
#pragma unroll
      for (int q = 0; q < 4; ++q) b[q] = Bs[mm][tx * 4 + q];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(a[i], b[q], acc[i][q]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ka = ka0 + ty * 4 + i;
    if (ka > Ka) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = n0 + tx * 4 + q;
      if (n >= N) continue;
      float* o = C + static_cast<long>(ka) * N + n;
      *o = accumulate ? *o + acc[i][q] : acc[i][q];
    }
  }
}

// demb[v, d] (+)= sum over rows m (ascending) with tok[m] == v of dx[m, d].
__global__ void embed_grad_kernel(const int32_t* __restrict__ tok,
                                  const float* __restrict__ dx, int M, int V,
                                  int Dx, float* __restrict__ demb,
                                  int accumulate) {
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long>(V) * Dx) return;
  const int v = static_cast<int>(i / Dx), d = static_cast<int>(i % Dx);
  float s = 0.0f;
  for (int m = 0; m < M; ++m)
    if (tok[m] == v) s += dx[static_cast<long>(m) * Dx + d];
  demb[i] = accumulate ? demb[i] + s : s;
}

__global__ void add_kernel(float* __restrict__ dst,
                           const float* __restrict__ src, long n) {
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) dst[i] = dst[i] + src[i];
}

int num_row_blocks(int B) { return (B + BT - 1) / BT; }

cudaError_t prepare_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The device address of page-locked host memory (UVA mapping).
cudaError_t device_view(void* host, float** dev) {
  cudaPointerAttributes attr;
  cudaError_t e = cudaPointerGetAttributes(&attr, host);
  if (e != cudaSuccess) return e;
  if (attr.type != cudaMemoryTypeHost || attr.devicePointer == nullptr)
    return cudaErrorInvalidHostPointer;
  *dev = static_cast<float*>(attr.devicePointer);
  return cudaSuccess;
}

}  // namespace

extern "C" int segment_fused_rows_per_block() { return BT; }

extern "C" int fused_advance_lstm(
    const float* emb, const float* w, const float* b, const float* w_out,
    const float* b_out, int V, int Dx, int Dh, const int32_t* tok,
    const int32_t* tgt, const float* h0, const float* c0, const float* acc0,
    float* h_out, float* c_out, float* acc_out, float* bnd_h_host,
    float* bnd_c_host, float* bnd_acc_host, float* nll_part, float* msum,
    int T, int B, int chunk, int nc, void* stream) {
  if (T <= 0 || B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  float *bnd_h, *bnd_c, *bnd_acc;
  cudaError_t e;
  if ((e = device_view(bnd_h_host, &bnd_h)) != cudaSuccess) return e;
  if ((e = device_view(bnd_c_host, &bnd_c)) != cudaSuccess) return e;
  if ((e = device_view(bnd_acc_host, &bnd_acc)) != cudaSuccess) return e;
  const Lstm p{emb, w, b, w_out, b_out, V, Dx, Dh};
  const size_t smem =
      sizeof(float) * (BT * (Dx + Dh) + 2 * BT * Dh + BT * V + BT);
  if ((e = prepare_smem(reinterpret_cast<const void*>(fused_advance_kernel),
                        smem)) != cudaSuccess)
    return e;
  const int nblk = num_row_blocks(B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  fused_advance_kernel<<<nblk, NT, smem, s>>>(p, tok, tgt, h0, c0, h_out,
                                              c_out, bnd_h, bnd_c, nll_part,
                                              T, B, chunk, nc);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  acc_finalize_kernel<<<1, NT, 0, s>>>(nll_part, msum, T, nblk, B, acc0,
                                       acc_out, bnd_acc, chunk, nc);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int chunk_backward_lstm(
    const float* emb, const float* w, const float* b, const float* w_out,
    const float* b_out, int V, int Dx, int Dh, const int32_t* tgt,
    const float* hs, const float* cs, const float* acts, const float* dacc,
    float* dh, float* dc, float* dz, float* dl, float* dx, int L, int B,
    void* stream) {
  if (L <= 0 || B <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Lstm p{emb, w, b, w_out, b_out, V, Dx, Dh};
  const size_t smem = sizeof(float) * (3 * BT * Dh + 4 * BT * Dh + BT * V);
  cudaError_t e;
  if ((e = prepare_smem(reinterpret_cast<const void*>(chunk_backward_kernel),
                        smem)) != cudaSuccess)
    return e;
  chunk_backward_kernel<<<num_row_blocks(B), NT, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      p, tgt, hs, cs, acts, dacc, dh, dc, dz, dl, dx, L, B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int grad_gemm(const float* A, int lda, const float* Bm, int ldb,
                         int M, int Ka, int N, float* C, int accumulate,
                         void* stream) {
  const dim3 grid((N + GT - 1) / GT, (Ka + 1 + GT - 1) / GT);
  grad_gemm_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      A, lda, Bm, ldb, M, Ka, N, C, accumulate);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int embed_grad(const int32_t* tok, const float* dx, int M, int V,
                          int Dx, float* demb, int accumulate, void* stream) {
  const long n = static_cast<long>(V) * Dx;
  embed_grad_kernel<<<static_cast<unsigned>((n + NT - 1) / NT), NT, 0,
                      static_cast<cudaStream_t>(stream)>>>(tok, dx, M, V, Dx,
                                                           demb, accumulate);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int add_inplace(float* dst, const float* src, long n,
                           void* stream) {
  add_kernel<<<static_cast<unsigned>((n + NT - 1) / NT), NT, 0,
               static_cast<cudaStream_t>(stream)>>>(dst, src, n);
  return static_cast<int>(cudaGetLastError());
}
