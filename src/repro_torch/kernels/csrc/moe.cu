// The MoE layer's routing and data movement: top-k softmax routing, the
// capacity slots of the one-hot dispatch, the gather of the kept rows into
// expert-major buckets, the weighted combine, and each one's vjp.
//
// Replaces the arithmetic the TPU kernels src/repro/kernels/segment_pallas.py
// ::fused_advance_segment / ::fused_reverse_segment run for a MoE decoder
// body (the body is traced into the pallas_call: the chunk scans at :186,
// :323 and the chunk vjp at :395-409): src/repro/models/moe.py::_route
// (:81-97), the one_hot / cumsum slot assignment and the dispatch einsum of
// ::moe_einsum (:129-149) and its combine einsum (:151), with their vjps.
// The port's plain versions are repro_torch/kernels/moe.py::*_plain.
//
// Each kernel computes the einsums' function, not their blocks: a one-hot
// dispatch product copies each kept row into its slot, and a one-hot
// combine product is a weighted sum of a token's k slots.  Slots keep the
// einsum's positions: choice i of token s of group g takes position
// (choices of expert e before it in choice-major order: every token's
// choices < i, then tokens < s at choice i), dropped at C.  The buckets
// lie expert-major, (E, G C, d) with expert e's group g at rows g C ..
// g C + C - 1, so that each expert's rows are one matrix for the batched
// expert GEMM (csrc/dense.cu); an empty slot is a zero row.
//
//   route      logits = x W_r (fp32 sums over d in order, x read as it is
//              stored), probs = softmax, top-k by a descending scan that
//              keeps the lower expert among equals (lax.top_k's order),
//              weights = top / max(sum top, 1e-9); one thread block a tile
//              of RT tokens, W_r staged through shared memory; then the
//              Switch aux loss in one block (route_aux): me_e = sum_n
//              probs[n][e] / N, ce_e = (choices of e) / N, aux = E sum_e
//              me_e ce_e, written added to the chain's running aux (aux_in
//              + aux: the carry's sum), ce kept for the backward; each
//              routing block sums its tokens' share, then one block adds
//              the blocks' sums in order
//   route_bwd  dprobs (the aux loss's, (daux E) ce_e / N) plus, through the
//              renormalisation, dw / den - sum(dw w) / den on the chosen
//              experts; dlogits = p (dp - <p, dp>); dx = dlogits W_r^T
//              (rounded to x's type; W_r staged through shared memory as
//              in the forward); dW_r = x^T dlogits as partial sums over
//              fixed row ranges, then a second launch adds them in range
//              order (no atomics)
//   slots      one block a group: each thread counts its contiguous run of
//              choices by expert, a running sum over the threads' counts
//              gives each run's offsets, and a second walk over the run
//              writes each choice's slot (choice_slot, -1 if dropped), the
//              bucket table (slot_src: the choice that fills a slot, -1 if
//              empty) and the routed count by group and expert
//   dispatch   bucket row = x[token of slot_src] or zeros (16-byte copies;
//              like the other row kernels below, a warp a row, the rows
//              walked with a grid stride)
//   dispatch_bwd  dx[token] = sum over its kept choices, in choice order,
//              of their slots' rows: a gather-sum in fp32, rounded once;
//              with two cotangents of the buckets (the experts' gate and
//              up products read them), each row their sum rounded first,
//              as autograd adds them
//   combine    y[token] = sum over its kept choices, in choice order, of
//              weight * row (each product and sum rounded to fp32 apart, as
//              the plain version's multiply and add), rounded to y's type;
//              with a residual, y = round(res + y) (the layer's skip)
//   combine_bwd   d row[slot] = weight * dy[token] (0 for an empty slot);
//              d weight = <row, dy[token]> (0 for a dropped choice), a
//              warp a token, each lane's columns in order, then a fixed
//              shuffle tree
//
// Bound: bytes.  At phi3.5-moe's layer (G = 2 groups of S = 4096 tokens,
// d = 4096 bf16, E = 16, top-2, C = 640): the route reads x's 67 MB
// (0.020 ms at 3.35 TB/s), its backward reads x and writes dx (0.040 ms);
// the dispatch reads 134 MB of kept rows and writes the 168 MB buckets
// (0.090 ms), its backward the reverse; the combine reads the buckets and
// writes y (0.060 ms).  Every output is written by one thread; no atomics,
// so two calls give the same bits.
#include "common.cuh"

using repro::from_f32;
using repro::to_f32;

namespace {

using bf16 = __nv_bfloat16;

constexpr int MAX_E = 64;   // experts a launch takes
constexpr int MAX_K = 8;    // choices a token
constexpr int RT = 16;      // tokens a routing block
constexpr int RNT = 256;    // routing threads
constexpr int RD = 64;      // rows of x and W_r a routing stage
constexpr int RP = RT * MAX_E / RNT;   // (token, expert) pairs a thread
constexpr int DWR = 64;     // rows of dW_r a block of its partial sums
constexpr int DWN = 32;     // tokens a stage of them
constexpr int DWP = DWR * MAX_E / RNT;
constexpr int SNT = 128;    // slot threads (a group a block)
constexpr int RPB = 4;      // rows (warps) a block of the row kernels
constexpr int ROWT = 32 * RPB;
constexpr int ROW_BLOCKS_PER_SM = 16;   // 64 resident warps an SM
constexpr int TPB = 8;      // tokens (warps) a block of the weight grads

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// eight values at p (16-byte aligned for bf16, 32 for fp32) as fp32, and
// eight fp32 values rounded into p
__device__ __forceinline__ void load8(const bf16* p, float f[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __bfloat162float(
        __ushort_as_bfloat16(static_cast<unsigned short>(w[i] & 0xffffu)));
    f[2 * i + 1] = __bfloat162float(
        __ushort_as_bfloat16(static_cast<unsigned short>(w[i] >> 16)));
  }
}
__device__ __forceinline__ void load8(const float* p, float f[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
__device__ __forceinline__ void store8(bf16* p, const float f[8]) {
  uint4 u;
  u.x = repro::pack_bf16x2(f[0], f[1]);
  u.y = repro::pack_bf16x2(f[2], f[3]);
  u.z = repro::pack_bf16x2(f[4], f[5]);
  u.w = repro::pack_bf16x2(f[6], f[7]);
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void store8(float* p, const float f[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

// a * b + c with the product and the sum each rounded to fp32 (no fused
// multiply-add): the plain version's multiply, then its add
__device__ __forceinline__ float mul_add_rn(float a, float b, float c) {
#if defined(__CUDA_ARCH__)
  return __fadd_rn(__fmul_rn(a, b), c);
#else
  return a * b + c;
#endif
}

// ------------------------------------------------------------- routing

// one token's softmax (in place in l: its probabilities), top-k and
// renormalised weights
__device__ __forceinline__ void route_token(float* l, int* sel,
                                            float* __restrict__ probs,
                                            float* __restrict__ weights,
                                            long long* __restrict__ idx,
                                            long n, int E, int k) {
  float m = l[0];
  for (int c = 1; c < E; ++c) m = fmaxf(m, l[c]);
  float s = 0.0f;
  for (int c = 0; c < E; ++c) {
    l[c] = expf(l[c] - m);
    s += l[c];
  }
  for (int c = 0; c < E; ++c) {
    l[c] = l[c] / s;
    probs[n * E + c] = l[c];
  }
  // top-k: the largest not yet taken, the lower expert among equals
  unsigned long long taken = 0ull;
  float top[MAX_K], tot = 0.0f;
  for (int i = 0; i < k; ++i) {
    int best = -1;
    float bv = 0.0f;
    for (int c = 0; c < E; ++c)
      if (!((taken >> c) & 1ull) && (best < 0 || l[c] > bv)) {
        best = c;
        bv = l[c];
      }
    taken |= 1ull << best;
    sel[i] = best;
    top[i] = bv;
    tot += bv;
  }
  const float den = fmaxf(tot, 1e-9f);
  for (int i = 0; i < k; ++i) {
    weights[n * k + i] = top[i] / den;
    idx[n * k + i] = sel[i];
  }
}

template <typename T>
__global__ void __launch_bounds__(RNT)
route_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                 float* __restrict__ probs, float* __restrict__ weights,
                 long long* __restrict__ idx, float* __restrict__ part_p,
                 int* __restrict__ part_c, int N, int d, int E, int k) {
  __shared__ float xs[RT][RD + 1];
  __shared__ float ws[RD][MAX_E];
  __shared__ float lg[RT][MAX_E + 1];
  __shared__ int chosen[RT][MAX_K];
  const int tid = threadIdx.x;
  const long t0 = static_cast<long>(blockIdx.x) * RT;
  float acc[RP];
#pragma unroll
  for (int j = 0; j < RP; ++j) acc[j] = 0.0f;
  for (int r0 = 0; r0 < d; r0 += RD) {
    for (int e = tid; e < RT * RD; e += RNT) {
      const int t = e / RD, r = e % RD;
      xs[t][r] = t0 + t < N && r0 + r < d
                     ? to_f32(x[(t0 + t) * d + r0 + r]) : 0.0f;
    }
    for (int e = tid; e < RD * E; e += RNT) {
      const int r = e / E, c = e % E;
      ws[r][c] = r0 + r < d ? w[static_cast<long>(r0 + r) * E + c] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < RP; ++j) {
      const int p = tid + j * RNT;
      if (p < RT * E) {
        const int t = p / E, c = p % E;
        float a = acc[j];
        for (int r = 0; r < RD; ++r) a = fmaf(xs[t][r], ws[r][c], a);
        acc[j] = a;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < RP; ++j) {
    const int p = tid + j * RNT;
    if (p < RT * E) lg[p / E][p % E] = acc[j];
  }
  __syncthreads();
  const int nt = static_cast<int>(min(static_cast<long>(RT), N - t0));
  if (tid < nt) route_token(lg[tid], chosen[tid], probs, weights, idx,
                            t0 + tid, E, k);
  if (part_p == nullptr) return;
  __syncthreads();
  // the block's part of the aux loss: each expert's probabilities and
  // choices summed over the block's tokens, in order
  if (tid < E) {
    float sp = 0.0f;
    int sc = 0;
    for (int t = 0; t < nt; ++t) {
      sp += lg[t][tid];
      for (int i = 0; i < k; ++i) sc += chosen[t][i] == tid;
    }
    part_p[static_cast<long>(blockIdx.x) * E + tid] = sp;
    part_c[static_cast<long>(blockIdx.x) * E + tid] = sc;
  }
}

// The aux loss of one routing: ce (E) and aux_out = aux_in + E sum_e me_e
// ce_e (aux_in null: 0 added), in one block from the routing blocks'
// partial sums (nb of them): thread t sums expert t % E's partials over
// the blocks b = t / E (mod RNT / E), in order, then the parts are added
// in order.
__global__ void __launch_bounds__(RNT)
route_aux_kernel(const float* __restrict__ part_p,
                 const int* __restrict__ part_c, int nb,
                 const float* __restrict__ aux_in, float* __restrict__ aux_out,
                 float* __restrict__ ce, int N, int E) {
  __shared__ float pm[RNT];
  __shared__ int pc[RNT];
  const int tid = threadIdx.x, lanes = RNT / E;
  float s = 0.0f;
  int cnt = 0;
  if (tid < lanes * E) {
    const int e = tid % E;
    for (int b = tid / E; b < nb; b += lanes) {
      s += part_p[static_cast<long>(b) * E + e];
      cnt += part_c[static_cast<long>(b) * E + e];
    }
  }
  pm[tid] = s;
  pc[tid] = cnt;
  __syncthreads();
  if (tid != 0) return;
  float tot = 0.0f;
  for (int e = 0; e < E; ++e) {
    float me = 0.0f;
    int c = 0;
    for (int j = 0; j < lanes; ++j) {
      me += pm[j * E + e];
      c += pc[j * E + e];
    }
    const float cv = static_cast<float>(c) / N;
    ce[e] = cv;
    tot += (me / N) * cv;
  }
  const float aux = static_cast<float>(E) * tot;
  aux_out[0] = aux_in ? aux_in[0] + aux : aux;
}

// dlogits (into dlog) and dx = dlogits W_r^T for a tile of RT tokens
template <typename T>
__global__ void __launch_bounds__(RNT)
route_dlogits_kernel(const float* __restrict__ w,
                     const float* __restrict__ probs,
                     const long long* __restrict__ idx,
                     const float* __restrict__ dweights,
                     const float* __restrict__ daux,
                     const float* __restrict__ ce,
                     float* __restrict__ dlog, T* __restrict__ dx, int N,
                     int d, int E, int k) {
  __shared__ float dl[RT][MAX_E + 1];
  __shared__ float ws[RD][MAX_E + 1];
  const int tid = threadIdx.x;
  const long t0 = static_cast<long>(blockIdx.x) * RT;
  const int nt = static_cast<int>(min(static_cast<long>(RT), N - t0));
  if (tid < nt) {
    const long n = t0 + tid;
    const float* p = probs + n * E;
    float* g = dl[tid];
    // the aux loss's dprobs: (daux E) ce_e, spread over the N rows
    const float da = daux ? daux[0] * static_cast<float>(E) : 0.0f;
    for (int c = 0; c < E; ++c) g[c] = daux ? da * ce[c] / N : 0.0f;
    if (dweights) {
      float s = 0.0f;
      for (int i = 0; i < k; ++i) s += p[idx[n * k + i]];
      const float den = fmaxf(s, 1e-9f);
      float sw = 0.0f;   // sum dw_i w_i
      for (int i = 0; i < k; ++i)
        sw += dweights[n * k + i] * (p[idx[n * k + i]] / den);
      for (int i = 0; i < k; ++i) {
        const long long e = idx[n * k + i];
        g[e] += dweights[n * k + i] / den;
        if (s >= 1e-9f) g[e] -= sw / den;
      }
    }
    float dot = 0.0f;
    for (int c = 0; c < E; ++c) dot += p[c] * g[c];
    for (int c = 0; c < E; ++c) {
      g[c] = p[c] * (g[c] - dot);
      dlog[n * E + c] = g[c];
    }
  }
  __syncthreads();
  // dx, RD rows of W_r at a time through shared memory (rows padded: the
  // lanes of a warp read neighbouring rows)
  for (int r0 = 0; r0 < d; r0 += RD) {
    for (int e = tid; e < RD * E; e += RNT) {
      const int r = e / E, c = e % E;
      ws[r][c] = r0 + r < d ? w[static_cast<long>(r0 + r) * E + c] : 0.0f;
    }
    __syncthreads();
    for (int p = tid; p < RT * RD; p += RNT) {
      const int t = p / RD, r = p % RD;
      if (t < nt && r0 + r < d) {
        float s = 0.0f;
        for (int c = 0; c < E; ++c) s = fmaf(dl[t][c], ws[r][c], s);
        dx[(t0 + t) * d + r0 + r] = from_f32<T>(s);
      }
    }
    __syncthreads();
  }
}

// part[split][r][c] = sum over the split's rows n (in order) of
// x[n][r] dlog[n][c]
template <typename T>
__global__ void __launch_bounds__(RNT)
route_dw_kernel(const T* __restrict__ x, const float* __restrict__ dlog,
                float* __restrict__ part, int N, int d, int E,
                int rows_per_split) {
  __shared__ float xs[DWN][DWR + 1];
  __shared__ float gs[DWN][MAX_E];
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * DWR, split = blockIdx.y;
  const long n0 = static_cast<long>(split) * rows_per_split;
  const long n1 = min(static_cast<long>(N), n0 + rows_per_split);
  float acc[DWP];
#pragma unroll
  for (int j = 0; j < DWP; ++j) acc[j] = 0.0f;
  for (long b = n0; b < n1; b += DWN) {
    for (int e = tid; e < DWN * DWR; e += RNT) {
      const int t = e / DWR, r = e % DWR;
      xs[t][r] = b + t < n1 && r0 + r < d ? to_f32(x[(b + t) * d + r0 + r])
                                          : 0.0f;
    }
    for (int e = tid; e < DWN * E; e += RNT) {
      const int t = e / E, c = e % E;
      gs[t][c] = b + t < n1 ? dlog[(b + t) * E + c] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < DWP; ++j) {
      const int p = tid + j * RNT;
      if (p < DWR * E) {
        const int r = p / E, c = p % E;
        float a = acc[j];
        for (int t = 0; t < DWN; ++t) a = fmaf(xs[t][r], gs[t][c], a);
        acc[j] = a;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < DWP; ++j) {
    const int p = tid + j * RNT;
    if (p < DWR * E && r0 + p / E < d)
      part[(static_cast<long>(split) * d + r0 + p / E) * E + p % E] = acc[j];
  }
}

__global__ void __launch_bounds__(RNT)
route_dw_sum_kernel(const float* __restrict__ part, float* __restrict__ dw,
                    int nsplit, long n) {
  const long i = static_cast<long>(blockIdx.x) * RNT + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int sp = 0; sp < nsplit; ++sp) s += part[sp * n + i];
  dw[i] = s;
}

// --------------------------------------------------------------- slots

__global__ void __launch_bounds__(SNT)
slots_kernel(const long long* __restrict__ idx, int* __restrict__ choice_slot,
             int* __restrict__ slot_src, int* __restrict__ routed, int G,
             int S, int k, int E, int C) {
  __shared__ int cnt[SNT * MAX_E];
  const int g = blockIdx.x, t = threadIdx.x;
  const long base = static_cast<long>(g) * S * k;   // the group's choices
  const int total = S * k, run = (total + SNT - 1) / SNT;
  const int j0 = min(t * run, total), j1 = min(j0 + run, total);
  const long GC = static_cast<long>(G) * C;
  for (long i = t; i < static_cast<long>(E) * C; i += SNT)
    slot_src[(i / C) * GC + static_cast<long>(g) * C + i % C] = -1;
  for (int e = 0; e < E; ++e) cnt[t * E + e] = 0;
  // choice j of the group in choice-major order: choice j / S of token j % S
  for (int j = j0; j < j1; ++j) {
    const long long e = idx[base + static_cast<long>(j % S) * k + j / S];
    if (e >= 0 && e < E) ++cnt[t * E + e];
  }
  __syncthreads();
  if (t < E) {   // each run's offset by expert; the group's routed count
    int sum = 0;
    for (int u = 0; u < SNT; ++u) {
      const int v = cnt[u * E + t];
      cnt[u * E + t] = sum;
      sum += v;
    }
    routed[g * E + t] = sum;
  }
  __syncthreads();
  for (int j = j0; j < j1; ++j) {
    const long flat = base + static_cast<long>(j % S) * k + j / S;
    const long long e = idx[flat];
    int slot = -1;
    if (e >= 0 && e < E) {
      const int pos = cnt[t * E + e]++;
      if (pos < C) {
        const long sl = e * GC + static_cast<long>(g) * C + pos;
        slot = static_cast<int>(sl);
        slot_src[sl] = static_cast<int>(flat);
      }
    }
    choice_slot[flat] = slot;
  }
}

// ------------------------------------------------------------ dispatch
//
// The row kernels give each warp a row of d values (16 bytes a lane where
// vec) and walk the rows with a grid stride: a grid of at most
// ROW_BLOCKS_PER_SM blocks an SM (all of them resident).

// the warp's rows: row, row + the grid's warps, ...
#define REPRO_FOR_ROWS(row, n)                                              \
  for (long row = static_cast<long>(blockIdx.x) * RPB + (threadIdx.x >> 5); \
       row < (n); row += static_cast<long>(gridDim.x) * RPB)

// bucket row = x[slot_src[row] / k] or zeros; vec: 16-byte copies
template <typename T>
__global__ void __launch_bounds__(ROWT)
dispatch_kernel(const T* __restrict__ x, const int* __restrict__ slot_src,
                T* __restrict__ out, long nrows, int d, int k, int vec) {
  const int lane = threadIdx.x & 31;
  uint4 zero;
  zero.x = zero.y = zero.z = zero.w = 0u;
  REPRO_FOR_ROWS(row, nrows) {
    const int src = slot_src[row];
    T* dst = out + row * d;
    const T* s = src >= 0 ? x + static_cast<long>(src / k) * d : nullptr;
    if (vec) {
      const int n16 = static_cast<int>(d * sizeof(T) / 16);
      for (int c = lane; c < n16; c += 32)
        reinterpret_cast<uint4*>(dst)[c] =
            s ? reinterpret_cast<const uint4*>(s)[c] : zero;
    } else {
      for (int c = lane; c < d; c += 32)
        dst[c] = s ? s[c] : from_f32<T>(0.0f);
    }
  }
}

// dx[n] = sum over kept i, in order, of dexp[choice_slot[n k + i]] (with
// dexp2, each row round(dexp + dexp2) first)
template <typename T>
__global__ void __launch_bounds__(ROWT)
dispatch_bwd_kernel(const T* __restrict__ dexp, const T* __restrict__ dexp2,
                    const int* __restrict__ choice_slot, T* __restrict__ dx,
                    long ntok, int d, int k, int vec) {
  const int lane = threadIdx.x & 31;
  REPRO_FOR_ROWS(n, ntok) {
    const int* cs = choice_slot + n * k;
    T* dst = dx + n * d;
    if (vec) {
      for (int c = lane * 8; c < d; c += 32 * 8) {
        float acc[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        for (int i = 0; i < k; ++i) {
          if (cs[i] < 0) continue;
          float v[8];
          load8(dexp + static_cast<long>(cs[i]) * d + c, v);
          if (dexp2) {
            float v2[8];
            load8(dexp2 + static_cast<long>(cs[i]) * d + c, v2);
#pragma unroll
            for (int q = 0; q < 8; ++q)
              v[q] = to_f32(from_f32<T>(v[q] + v2[q]));
          }
#pragma unroll
          for (int q = 0; q < 8; ++q) acc[q] += v[q];
        }
        store8(dst + c, acc);
      }
    } else {
      for (int c = lane; c < d; c += 32) {
        float acc = 0.0f;
        for (int i = 0; i < k; ++i) {
          if (cs[i] < 0) continue;
          const long at = static_cast<long>(cs[i]) * d + c;
          acc += dexp2 ? to_f32(from_f32<T>(to_f32(dexp[at]) +
                                            to_f32(dexp2[at])))
                       : to_f32(dexp[at]);
        }
        dst[c] = from_f32<T>(acc);
      }
    }
  }
}

// ------------------------------------------------------------- combine

// y[n] = sum over kept i, in order, of weights[n k + i] rows[slot] (with
// res, round(res[n] + round(that)))
template <typename TO, typename TY>
__global__ void __launch_bounds__(ROWT)
combine_kernel(const TO* __restrict__ rows, const float* __restrict__ weights,
               const int* __restrict__ choice_slot,
               const TY* __restrict__ res, TY* __restrict__ y, long ntok,
               int d, int k, int vec) {
  const int lane = threadIdx.x & 31;
  REPRO_FOR_ROWS(n, ntok) {
    const int* cs = choice_slot + n * k;
    const float* wt = weights + n * k;
    TY* dst = y + n * d;
    if (vec) {
      for (int c = lane * 8; c < d; c += 32 * 8) {
        float acc[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        for (int i = 0; i < k; ++i) {
          if (cs[i] < 0) continue;
          float v[8];
          load8(rows + static_cast<long>(cs[i]) * d + c, v);
#pragma unroll
          for (int q = 0; q < 8; ++q)
            acc[q] = mul_add_rn(wt[i], v[q], acc[q]);
        }
        if (res) {
          float r[8];
          load8(res + n * d + c, r);
#pragma unroll
          for (int q = 0; q < 8; ++q)
            acc[q] = r[q] + to_f32(from_f32<TY>(acc[q]));
        }
        store8(dst + c, acc);
      }
    } else {
      for (int c = lane; c < d; c += 32) {
        float acc = 0.0f;
        for (int i = 0; i < k; ++i)
          if (cs[i] >= 0)
            acc = mul_add_rn(
                wt[i], to_f32(rows[static_cast<long>(cs[i]) * d + c]), acc);
        if (res) acc = to_f32(res[n * d + c]) + to_f32(from_f32<TY>(acc));
        dst[c] = from_f32<TY>(acc);
      }
    }
  }
}

// d rows[row] = weights[src] dy[src / k], src = slot_src[row]; 0 if empty
template <typename TO, typename TY>
__global__ void __launch_bounds__(ROWT)
combine_drows_kernel(const TY* __restrict__ dy,
                     const float* __restrict__ weights,
                     const int* __restrict__ slot_src, TO* __restrict__ drows,
                     long nrows, int d, int k, int vec) {
  const int lane = threadIdx.x & 31;
  REPRO_FOR_ROWS(row, nrows) {
    const int src = slot_src[row];
    const float wt = src >= 0 ? weights[src] : 0.0f;
    const TY* g = src >= 0 ? dy + static_cast<long>(src / k) * d : nullptr;
    TO* dst = drows + row * d;
    if (vec) {
      for (int c = lane * 8; c < d; c += 32 * 8) {
        float v[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        if (g) {
          load8(g + c, v);
#pragma unroll
          for (int q = 0; q < 8; ++q) v[q] = wt * v[q];
        }
        store8(dst + c, v);
      }
    } else {
      for (int c = lane; c < d; c += 32)
        dst[c] = from_f32<TO>(g ? wt * to_f32(g[c]) : 0.0f);
    }
  }
}

// dweights[n k + i] = <rows[slot], dy[n]> (0 if dropped): a warp a token
template <typename TO, typename TY>
__global__ void __launch_bounds__(32 * TPB)
combine_dweights_kernel(const TO* __restrict__ rows,
                        const TY* __restrict__ dy,
                        const int* __restrict__ choice_slot,
                        float* __restrict__ dweights, long ntok, int d,
                        int k, int vec) {
  const int lane = threadIdx.x & 31;
  const long n = static_cast<long>(blockIdx.x) * TPB + (threadIdx.x >> 5);
  if (n >= ntok) return;   // the whole warp
  const int* cs = choice_slot + n * k;
  const TY* g = dy + n * d;
  float acc[MAX_K];
#pragma unroll
  for (int i = 0; i < MAX_K; ++i) acc[i] = 0.0f;
  if (vec) {
    for (int c = lane * 8; c < d; c += 32 * 8) {
      float gv[8];
      load8(g + c, gv);
#pragma unroll
      for (int i = 0; i < MAX_K; ++i) {
        if (i >= k || cs[i] < 0) continue;
        float v[8];
        load8(rows + static_cast<long>(cs[i]) * d + c, v);
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[i] = fmaf(v[q], gv[q], acc[i]);
      }
    }
  } else {
    for (int c = lane; c < d; c += 32) {
      const float gv = to_f32(g[c]);
#pragma unroll
      for (int i = 0; i < MAX_K; ++i)
        if (i < k && cs[i] >= 0)
          acc[i] = fmaf(to_f32(rows[static_cast<long>(cs[i]) * d + c]), gv,
                        acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < MAX_K; ++i) {
    if (i >= k) break;   // k is the same for the whole warp
    const float s = repro::warp_sum(acc[i]);
    if (lane == 0) dweights[n * k + i] = cs[i] >= 0 ? s : 0.0f;
  }
}

// ------------------------------------------------------------- launches

int check_ek(int E, int k) {
  return E < 1 || E > MAX_E || k < 1 || k > MAX_K || k > E
             ? static_cast<int>(cudaErrorInvalidValue) : 0;
}

int last_error() { return static_cast<int>(cudaGetLastError()); }

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || sms < 1)
    return 1;
  return sms;
}

// blocks of the row kernels for n rows: a warp a row, at most
// ROW_BLOCKS_PER_SM an SM (the warps then take several rows each)
unsigned blocks_for(long n) {
  const long want = (n + RPB - 1) / RPB;
  const long most = static_cast<long>(ROW_BLOCKS_PER_SM) * sm_count();
  return static_cast<unsigned>(want < most ? want : most);
}

template <typename T>
int route_fwd(const void* x, const void* w, void* probs, void* weights,
              void* idx, const void* aux_in, void* aux_out, void* ce,
              void* part_p, void* part_c, int N, int d, int E, int k,
              cudaStream_t stream) {
  const int nb = (N + RT - 1) / RT;
  float* pp = aux_out ? static_cast<float*>(part_p) : nullptr;
  route_fwd_kernel<T><<<nb, RNT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<float*>(probs), static_cast<float*>(weights),
      static_cast<long long*>(idx), pp, static_cast<int*>(part_c), N, d, E,
      k);
  const int err = last_error();
  if (err || aux_out == nullptr) return err;
  route_aux_kernel<<<1, RNT, 0, stream>>>(
      static_cast<const float*>(part_p), static_cast<const int*>(part_c), nb,
      static_cast<const float*>(aux_in), static_cast<float*>(aux_out),
      static_cast<float*>(ce), N, E);
  return last_error();
}

template <typename T>
int route_bwd(const void* x, const void* w, const void* probs,
              const void* idx, const void* dweights, const void* daux,
              const void* ce, void* dlog, void* part, void* dx, void* dw,
              int N, int d, int E, int k, int nsplit, cudaStream_t stream) {
  route_dlogits_kernel<T><<<(N + RT - 1) / RT, RNT, 0, stream>>>(
      static_cast<const float*>(w), static_cast<const float*>(probs),
      static_cast<const long long*>(idx),
      static_cast<const float*>(dweights), static_cast<const float*>(daux),
      static_cast<const float*>(ce), static_cast<float*>(dlog),
      static_cast<T*>(dx), N, d, E, k);
  int err = last_error();
  if (err) return err;
  const int rows_per_split = (N + nsplit - 1) / nsplit;
  route_dw_kernel<T><<<dim3((d + DWR - 1) / DWR, nsplit), RNT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dlog),
      static_cast<float*>(part), N, d, E, rows_per_split);
  err = last_error();
  if (err) return err;
  const long n = static_cast<long>(d) * E;
  route_dw_sum_kernel<<<static_cast<int>((n + RNT - 1) / RNT), RNT, 0,
                        stream>>>(static_cast<const float*>(part),
                                  static_cast<float*>(dw), nsplit, n);
  return last_error();
}

template <typename T>
int dispatch(const void* x, const void* slot_src, void* out, long rows, int d,
             int k, cudaStream_t stream) {
  const int vec = aligned16(x) && aligned16(out) && d * sizeof(T) % 16 == 0;
  dispatch_kernel<T><<<blocks_for(rows), ROWT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int*>(slot_src),
      static_cast<T*>(out), rows, d, k, vec);
  return last_error();
}

template <typename T>
int dispatch_bwd(const void* dexp, const void* dexp2, const void* choice_slot,
                 void* dx, long ntok, int d, int k, cudaStream_t stream) {
  const int vec = aligned16(dexp) && (!dexp2 || aligned16(dexp2)) &&
                  aligned16(dx) && d % 8 == 0;
  dispatch_bwd_kernel<T><<<blocks_for(ntok), ROWT, 0, stream>>>(
      static_cast<const T*>(dexp), static_cast<const T*>(dexp2),
      static_cast<const int*>(choice_slot), static_cast<T*>(dx), ntok, d, k,
      vec);
  return last_error();
}

template <typename TO, typename TY>
int combine(const void* rows, const void* weights, const void* choice_slot,
            const void* res, void* y, long ntok, int d, int k,
            cudaStream_t stream) {
  const int vec = aligned16(rows) && aligned16(y) &&
                  (!res || aligned16(res)) && d % 8 == 0;
  combine_kernel<TO, TY><<<blocks_for(ntok), ROWT, 0, stream>>>(
      static_cast<const TO*>(rows), static_cast<const float*>(weights),
      static_cast<const int*>(choice_slot), static_cast<const TY*>(res),
      static_cast<TY*>(y), ntok, d, k, vec);
  return last_error();
}

template <typename TO, typename TY>
int combine_bwd(const void* dy, const void* rows, const void* weights,
                const void* choice_slot, const void* slot_src, void* drows,
                void* dweights, long nrows, long ntok, int d, int k,
                cudaStream_t stream) {
  const int vec = aligned16(dy) && aligned16(rows) && aligned16(drows) &&
                  d % 8 == 0;
  if (nrows > 0) {
    combine_drows_kernel<TO, TY><<<blocks_for(nrows), ROWT, 0, stream>>>(
        static_cast<const TY*>(dy), static_cast<const float*>(weights),
        static_cast<const int*>(slot_src), static_cast<TO*>(drows), nrows,
        d, k, vec);
    const int err = last_error();
    if (err) return err;
  }
  const int blocks = static_cast<int>((ntok + TPB - 1) / TPB);
  // (the launch on one line: the emulated tests' rewrite reads it so)
  combine_dweights_kernel<TO, TY><<<blocks, 32 * TPB, 0, stream>>>(
      static_cast<const TO*>(rows), static_cast<const TY*>(dy),
      static_cast<const int*>(choice_slot), static_cast<float*>(dweights),
      ntok, d, k, vec);
  return last_error();
}

cudaStream_t as_stream(void* s) { return static_cast<cudaStream_t>(s); }

}  // namespace

// The routing blocks of N tokens (the rows of the aux loss's partial sums,
// (blocks, E) fp32 and int32).
extern "C" int moe_route_blocks(int N) {
  return N <= 0 ? 0 : (N + RT - 1) / RT;
}

// x (N, d) bf16 (x_bf16) or fp32, w (d, E) fp32; probs (N, E), weights
// (N, k) fp32, idx (N, k) int64; aux_out (1) and ce (E) fp32, or both NULL
// (no aux loss), aux_in (1) fp32 or NULL; part_p, part_c the aux loss's
// partial sums (moe_route_blocks(N), E) fp32 and int32 scratch.  E <= 64,
// k <= min(E, 8).
extern "C" int moe_route_fwd(const void* x, const void* w, void* probs,
                             void* weights, void* idx, const void* aux_in,
                             void* aux_out, void* ce, void* part_p,
                             void* part_c, int N, int d, int E, int k,
                             int x_bf16, void* stream) {
  if (int err = check_ek(E, k)) return err;
  if (N <= 0) return 0;
  if ((aux_out == nullptr) != (ce == nullptr) ||
      (aux_out != nullptr && (part_p == nullptr || part_c == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  return x_bf16 ? route_fwd<bf16>(x, w, probs, weights, idx, aux_in, aux_out,
                                  ce, part_p, part_c, N, d, E, k,
                                  as_stream(stream))
                : route_fwd<float>(x, w, probs, weights, idx, aux_in,
                                   aux_out, ce, part_p, part_c, N, d, E, k,
                                   as_stream(stream));
}

// dweights (N, k) fp32 or NULL for zeros; daux (1) fp32, the aux loss's
// cotangent, with the forward's ce (E), or NULL for zero; scratch dlog (N,
// E) and part (nsplit, d, E) fp32; dx (N, d) in x's type, dw (d, E) fp32.
extern "C" int moe_route_bwd(const void* x, const void* w, const void* probs,
                             const void* idx, const void* dweights,
                             const void* daux, const void* ce, void* dlog,
                             void* part, void* dx, void* dw, int N, int d,
                             int E, int k, int nsplit, int x_bf16,
                             void* stream) {
  if (int err = check_ek(E, k)) return err;
  if (N <= 0 || nsplit < 1 || (daux != nullptr && ce == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return x_bf16 ? route_bwd<bf16>(x, w, probs, idx, dweights, daux, ce, dlog,
                                  part, dx, dw, N, d, E, k, nsplit,
                                  as_stream(stream))
                : route_bwd<float>(x, w, probs, idx, dweights, daux, ce,
                                   dlog, part, dx, dw, N, d, E, k, nsplit,
                                   as_stream(stream));
}

// idx (G, S, k) int64; choice_slot (G, S, k), slot_src (E, G C), routed
// (G, E) int32.
extern "C" int moe_slots(const void* idx, void* choice_slot, void* slot_src,
                         void* routed, int G, int S, int k, int E, int C,
                         void* stream) {
  if (int err = check_ek(E, k)) return err;
  if (G <= 0 || S <= 0) return 0;
  slots_kernel<<<G, SNT, 0, as_stream(stream)>>>(
      static_cast<const long long*>(idx), static_cast<int*>(choice_slot),
      static_cast<int*>(slot_src), static_cast<int*>(routed), G, S, k, E, C);
  return last_error();
}

// x (G S, d), out (rows = E G C, d), both of the compute type.
extern "C" int moe_dispatch(const void* x, const void* slot_src, void* out,
                            long rows, int d, int k, int bf16_, void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  return bf16_ ? dispatch<bf16>(x, slot_src, out, rows, d, k,
                                as_stream(stream))
               : dispatch<float>(x, slot_src, out, rows, d, k,
                                 as_stream(stream));
}

// dexp, dexp2 (E G C, d; dexp2 NULL or a second cotangent of the buckets),
// dx (ntok = G S, d).
extern "C" int moe_dispatch_bwd(const void* dexp, const void* dexp2,
                                const void* choice_slot, void* dx, long ntok,
                                int d, int k, int bf16_, void* stream) {
  if (ntok <= 0 || d <= 0) return 0;
  return bf16_ ? dispatch_bwd<bf16>(dexp, dexp2, choice_slot, dx, ntok, d, k,
                                    as_stream(stream))
               : dispatch_bwd<float>(dexp, dexp2, choice_slot, dx, ntok, d,
                                     k, as_stream(stream));
}

#define REPRO_MOE_TYPES(CALL)                                            \
  if (rows_bf16 && y_bf16) return CALL(bf16, bf16);                      \
  if (rows_bf16) return CALL(bf16, float);                               \
  if (y_bf16) return CALL(float, bf16);                                  \
  return CALL(float, float);

// rows (E G C, d) in the compute type (rows_bf16), y and res (ntok, d; res
// NULL or the residual) in x's type (y_bf16), weights (ntok, k) fp32.
extern "C" int moe_combine(const void* rows, const void* weights,
                           const void* choice_slot, const void* res, void* y,
                           long ntok, int d, int k, int rows_bf16, int y_bf16,
                           void* stream) {
  if (ntok <= 0 || d <= 0) return 0;
#define REPRO_CALL(TO, TY)                                             \
  combine<TO, TY>(rows, weights, choice_slot, res, y, ntok, d, k,      \
                  as_stream(stream))
  REPRO_MOE_TYPES(REPRO_CALL)
#undef REPRO_CALL
}

// drows (nrows = E G C, d) in the rows' type; dweights (ntok, k) fp32.
extern "C" int moe_combine_bwd(const void* dy, const void* rows,
                               const void* weights, const void* choice_slot,
                               const void* slot_src, void* drows,
                               void* dweights, long nrows, long ntok, int d,
                               int k, int rows_bf16, int y_bf16,
                               void* stream) {
  if (ntok <= 0 || d <= 0) return 0;
#define REPRO_CALL(TO, TY)                                              \
  combine_bwd<TO, TY>(dy, rows, weights, choice_slot, slot_src, drows,  \
                      dweights, nrows, ntok, d, k, as_stream(stream))
  REPRO_MOE_TYPES(REPRO_CALL)
#undef REPRO_CALL
}
