// Gated activation act(gate) * up, forward and backward, with act the
// tanh-approximate GELU (GeGLU) or SiLU (SwiGLU).
//
// Replaces the arithmetic the TPU kernels src/repro/kernels/segment_pallas.py
// ::fused_advance_segment / ::fused_reverse_segment run for a decoder body
// (the body is traced into the pallas_call: the chunk scans at :186, :323 and
// the chunk vjp at :395-409): src/repro/models/layers.py::geglu (as
// jax.nn.gelu(approximate=True)) and ::swiglu, and their vjps.  The port's
// plain version is repro_torch/kernels/glu.py::glu_plain / glu_bwd_plain.
//
//   forward   h = act(gate) up
//   backward  dgate = g up act'(gate), dup = g act(gate)
//   GELU      act(x) = x (1 + tanh(k (x + c x^3))) / 2, k = sqrt(2 / pi),
//             c = 0.044715; act' = (1 + t) / 2 + x (1 - t^2) k (1 + 3 c x^2) / 2
//   SiLU      act(x) = x s, s = sigmoid(x); act' = s (1 + x (1 - s))
//
// Computed in fp32 and rounded once to the input type (the plain forward,
// PyTorch's gelu then a multiply, rounds twice in bf16: ROADMAP queue 3's
// "Deliberate differences" records the difference).  Bound: bytes, 3
// (forward) or 5 (backward) tensors of gemma2-2b's (2, 4096, 9216) bf16:
// 453 and 755 MB, 0.14 and 0.23 ms at 3.35 TB/s.  Design: a grid-stride loop, 16 bytes a load and a
// store where the tensors are 16-byte aligned (8 bf16 or 4 fp32 values),
// one value at a time for the tail and a misaligned tensor.
#include "common.cuh"

using repro::from_f32;
using repro::to_f32;

namespace {

constexpr int NT = 256;
constexpr int MAX_BLOCKS = 132 * 8;
constexpr float K_GELU = 0.7978845608028654f;  // sqrt(2 / pi)
constexpr float C_GELU = 0.044715f;

template <int ACT>
__device__ __forceinline__ float act(float x) {
  if (ACT == 0) {
    const float t = tanhf(K_GELU * (x + C_GELU * x * x * x));
    return 0.5f * x * (1.0f + t);
  }
  return x / (1.0f + expf(-x));
}

// act(x) and act'(x)
template <int ACT>
__device__ __forceinline__ void act_grad(float x, float* a, float* da) {
  if (ACT == 0) {
    const float t = tanhf(K_GELU * (x + C_GELU * x * x * x));
    *a = 0.5f * x * (1.0f + t);
    *da = 0.5f * (1.0f + t) +
          0.5f * x * (1.0f - t * t) * K_GELU * (1.0f + 3.0f * C_GELU * x * x);
    return;
  }
  const float s = 1.0f / (1.0f + expf(-x));
  *a = x * s;
  *da = s * (1.0f + x * (1.0f - s));
}

template <typename T>
struct alignas(16) Vec {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, int ACT>
__global__ void __launch_bounds__(NT)
glu_fwd_kernel(const T* __restrict__ gate, const T* __restrict__ up,
               T* __restrict__ out, long n, int vec) {
  constexpr int N = Vec<T>::N;
  const long tid = static_cast<long>(blockIdx.x) * NT + threadIdx.x;
  const long stride = static_cast<long>(gridDim.x) * NT;
  long done = 0;
  if (vec) {
    const long nv = n / N;
    for (long i = tid; i < nv; i += stride) {
      const Vec<T> g = reinterpret_cast<const Vec<T>*>(gate)[i];
      const Vec<T> u = reinterpret_cast<const Vec<T>*>(up)[i];
      Vec<T> o;
#pragma unroll
      for (int j = 0; j < N; ++j)
        o.v[j] = from_f32<T>(act<ACT>(to_f32(g.v[j])) * to_f32(u.v[j]));
      reinterpret_cast<Vec<T>*>(out)[i] = o;
    }
    done = nv * N;
  }
  for (long i = done + tid; i < n; i += stride)
    out[i] = from_f32<T>(act<ACT>(to_f32(gate[i])) * to_f32(up[i]));
}

template <typename T, int ACT>
__global__ void __launch_bounds__(NT)
glu_bwd_kernel(const T* __restrict__ grad, const T* __restrict__ gate,
               const T* __restrict__ up, T* __restrict__ dgate,
               T* __restrict__ dup, long n, int vec) {
  constexpr int N = Vec<T>::N;
  const long tid = static_cast<long>(blockIdx.x) * NT + threadIdx.x;
  const long stride = static_cast<long>(gridDim.x) * NT;
  long done = 0;
  if (vec) {
    const long nv = n / N;
    for (long i = tid; i < nv; i += stride) {
      const Vec<T> g = reinterpret_cast<const Vec<T>*>(grad)[i];
      const Vec<T> x = reinterpret_cast<const Vec<T>*>(gate)[i];
      const Vec<T> u = reinterpret_cast<const Vec<T>*>(up)[i];
      Vec<T> dg, du;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float a, da;
        act_grad<ACT>(to_f32(x.v[j]), &a, &da);
        const float gv = to_f32(g.v[j]);
        dg.v[j] = from_f32<T>(gv * to_f32(u.v[j]) * da);
        du.v[j] = from_f32<T>(gv * a);
      }
      reinterpret_cast<Vec<T>*>(dgate)[i] = dg;
      reinterpret_cast<Vec<T>*>(dup)[i] = du;
    }
    done = nv * N;
  }
  for (long i = done + tid; i < n; i += stride) {
    float a, da;
    act_grad<ACT>(to_f32(gate[i]), &a, &da);
    const float gv = to_f32(grad[i]);
    dgate[i] = from_f32<T>(gv * to_f32(up[i]) * da);
    dup[i] = from_f32<T>(gv * a);
  }
}

unsigned blocks_for(long n) {
  const long b = (n + NT - 1) / NT;
  return static_cast<unsigned>(b < MAX_BLOCKS ? (b > 0 ? b : 1) : MAX_BLOCKS);
}

template <typename T, int ACT>
int fwd(const void* gate, const void* up, void* out, long n, void* stream) {
  const int vec = aligned16(gate) && aligned16(up) && aligned16(out);
  auto kern = glu_fwd_kernel<T, ACT>;
  kern<<<blocks_for(n), NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(gate), static_cast<const T*>(up),
      static_cast<T*>(out), n, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int ACT>
int bwd(const void* g, const void* gate, const void* up, void* dgate,
        void* dup, long n, void* stream) {
  const int vec = aligned16(g) && aligned16(gate) && aligned16(up) &&
                  aligned16(dgate) && aligned16(dup);
  auto kern = glu_bwd_kernel<T, ACT>;
  kern<<<blocks_for(n), NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(g), static_cast<const T*>(gate),
      static_cast<const T*>(up), static_cast<T*>(dgate),
      static_cast<T*>(dup), n, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// act: 0 the tanh-approximate GELU, 1 SiLU; every tensor of n values of
// type bf16 ? bf16 : fp32.
extern "C" int glu_fwd(const void* gate, const void* up, void* out, long n,
                       int act, int bf16, void* stream) {
  if (n <= 0) return 0;
  if (bf16)
    return act ? fwd<__nv_bfloat16, 1>(gate, up, out, n, stream)
               : fwd<__nv_bfloat16, 0>(gate, up, out, n, stream);
  return act ? fwd<float, 1>(gate, up, out, n, stream)
             : fwd<float, 0>(gate, up, out, n, stream);
}

extern "C" int glu_bwd(const void* g, const void* gate, const void* up,
                       void* dgate, void* dup, long n, int act, int bf16,
                       void* stream) {
  if (n <= 0) return 0;
  if (bf16)
    return act ? bwd<__nv_bfloat16, 1>(g, gate, up, dgate, dup, n, stream)
               : bwd<__nv_bfloat16, 0>(g, gate, up, dgate, dup, n, stream);
  return act ? bwd<float, 1>(g, gate, up, dgate, dup, n, stream)
             : bwd<float, 0>(g, gate, up, dgate, dup, n, stream);
}
