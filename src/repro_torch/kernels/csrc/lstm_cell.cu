// Kernel 1: the fused LSTM cell, z = [x, h] @ W + b -> gates -> (h', c').
//
// Replaces the TPU kernel src/repro/kernels/lstm_cell.py::lstm_cell (Pallas,
// one grid step per batch block with W whole in VMEM).  On the H100 W
// (320x1024 fp32 = 1.3 MB at the paper's width) does not fit a block's
// shared memory, so the grid is 2-D: a block owns BM batch rows and BJ
// hidden units and computes all four gate columns of those units
// (j, Dh+j, 2Dh+j, 3Dh+j), so the gate epilogue needs no exchange between
// blocks.  The [x, h] row tile and the W column tile go through shared
// memory in BK-deep slices; the products are fp32 FMA on the CUDA cores.
// Bound: at B=256 one call moves ~1.9 MB (W dominates) and does ~168 MFLOP,
// so it is bound by operations (fp32, 67 TFLOP/s) over bytes (3.35 TB/s) by
// ~4.5x; each W column tile is read once per row tile (B/BM times in all),
// from L2 after the first.  The ragged batch and unit edges are masked
// (the TPU kernel asserted B % block_b == 0).
//
// Two C entry points: lstm_cell_f32/_bf16 take x rows directly (the
// standalone kernel); with tok != NULL the x row of batch row b is
// emb[tok[b]] (the recompute steps of the fused reverse), and the optional
// xh_out / acts_out receive the [x, h] rows and the gate activations the
// reverse's backward consumes.
#include "lstm_step.cuh"

using repro::from_f32;
using repro::to_f32;

namespace {

constexpr int BM = 16;   // batch rows per block
constexpr int BJ = 32;   // hidden units per block (4 * BJ gate columns)
constexpr int BK = 32;   // reduction slice
constexpr int NT = 256;  // threads: BJ units x (BM / 2) row pairs

template <typename T>
__global__ void __launch_bounds__(NT)
lstm_cell_kernel(const T* __restrict__ x, const int32_t* __restrict__ tok,
                 const T* __restrict__ h, const T* __restrict__ c,
                 const T* __restrict__ w, const T* __restrict__ bias,
                 T* __restrict__ h_out, T* __restrict__ c_out,
                 float* __restrict__ xh_out, float* __restrict__ acts_out,
                 int B, int Dx, int Dh) {
  __shared__ float xs[BK][BM];
  __shared__ float ws[BK][4 * BJ];
  const int tid = threadIdx.x;
  const int tx = tid % BJ;  // unit within the tile
  const int ty = tid / BJ;  // rows 2*ty, 2*ty + 1 of the tile
  const int row0 = blockIdx.x * BM;
  const int j0 = blockIdx.y * BJ;
  const int K = Dx + Dh;
  const long N4 = 4L * Dh;
  const int j = j0 + tx;

  float acc[2][4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const float bg = (j < Dh) ? to_f32(bias[g * Dh + j]) : 0.0f;
    acc[0][g] = bg;
    acc[1][g] = bg;
  }

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += NT) {
      const int r = e / BK, kk = e % BK;
      const int row = row0 + r, k = k0 + kk;
      float v = 0.0f;
      if (row < B && k < K) {
        if (k < Dx) {
          const long xr = tok ? static_cast<long>(tok[row]) : row;
          v = to_f32(x[xr * Dx + k]);
        } else {
          v = to_f32(h[static_cast<long>(row) * Dh + (k - Dx)]);
        }
        if (xh_out != nullptr && blockIdx.y == 0)
          xh_out[static_cast<long>(row) * K + k] = v;
      }
      xs[kk][r] = v;
    }
    for (int e = tid; e < BK * 4 * BJ; e += NT) {
      const int kk = e / (4 * BJ), col = e % (4 * BJ);
      const int g = col / BJ, u = j0 + col % BJ, k = k0 + kk;
      ws[kk][col] = (k < K && u < Dh)
                        ? to_f32(w[static_cast<long>(k) * N4 + g * Dh + u])
                        : 0.0f;
    }
    __syncthreads();
    const int kmax = min(BK, K - k0);
    for (int kk = 0; kk < kmax; ++kk) {
      const float a0 = xs[kk][2 * ty], a1 = xs[kk][2 * ty + 1];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float wv = ws[kk][g * BJ + tx];
        acc[0][g] = fmaf(a0, wv, acc[0][g]);
        acc[1][g] = fmaf(a1, wv, acc[1][g]);
      }
    }
    __syncthreads();
  }

  if (j >= Dh) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 2 * ty + r;
    if (row >= B) continue;
    const long o = static_cast<long>(row) * Dh + j;
    float cn, hn;
    const repro::GateActs a = repro::lstm_point(
        acc[r][0], acc[r][1], acc[r][2], acc[r][3], to_f32(c[o]), &cn, &hn);
    h_out[o] = from_f32<T>(hn);
    c_out[o] = from_f32<T>(cn);
    if (acts_out != nullptr) {
      float* ar = acts_out + static_cast<long>(row) * N4 + j;
      ar[0] = a.si;
      ar[Dh] = a.sf;
      ar[2 * Dh] = a.so;
      ar[3 * Dh] = a.tg;
    }
  }
}

template <typename T>
int launch(const void* x, const int32_t* tok, const void* h, const void* c,
           const void* w, const void* b, void* h_out, void* c_out,
           float* xh_out, float* acts_out, int B, int Dx, int Dh,
           void* stream) {
  if (B <= 0 || Dh <= 0) return 0;
  const dim3 grid((B + BM - 1) / BM, (Dh + BJ - 1) / BJ);
  lstm_cell_kernel<T><<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), tok, static_cast<const T*>(h),
      static_cast<const T*>(c), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<T*>(h_out),
      static_cast<T*>(c_out), xh_out, acts_out, B, Dx, Dh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lstm_cell_f32(const void* x, const int32_t* tok, const void* h,
                             const void* c, const void* w, const void* b,
                             void* h_out, void* c_out, float* xh_out,
                             float* acts_out, int B, int Dx, int Dh,
                             void* stream) {
  return launch<float>(x, tok, h, c, w, b, h_out, c_out, xh_out, acts_out, B,
                       Dx, Dh, stream);
}

extern "C" int lstm_cell_bf16(const void* x, const int32_t* tok,
                              const void* h, const void* c, const void* w,
                              const void* b, void* h_out, void* c_out,
                              float* xh_out, float* acts_out, int B, int Dx,
                              int Dh, void* stream) {
  return launch<__nv_bfloat16>(x, tok, h, c, w, b, h_out, c_out, xh_out,
                               acts_out, B, Dx, Dh, stream);
}
