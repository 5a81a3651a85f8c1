// The LSTM chain step shared by every kernel of the port: the gate
// nonlinearities and state update of one (batch row, hidden unit) point, its
// vector-Jacobian product, and the C-interface plumbing.
//
// Gate order is the JAX package's: z = [x, h] @ W + b splits into i, f, o, g
// (W is (Dx+Dh, 4Dh), gate-major), with the +1.0 forget bias:
//   c' = sigmoid(f + 1) * c + sigmoid(i) * tanh(g),   h' = sigmoid(o) * tanh(c')
// All arithmetic is fp32 (no fast-math intrinsics, no TF32).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace repro {

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Gate activations of one point: sigmoid(i), sigmoid(f + 1), sigmoid(o),
// tanh(g).
struct GateActs {
  float si, sf, so, tg;
};

// The step: gate pre-activations + cell input -> (c', h'), activations out.
__device__ __forceinline__ GateActs lstm_point(float zi, float zf, float zo,
                                               float zg, float c,
                                               float* c_new, float* h_new) {
  GateActs a;
  a.si = sigmoid(zi);
  a.sf = sigmoid(zf + 1.0f);
  a.so = sigmoid(zo);
  a.tg = tanhf(zg);
  const float cn = a.sf * c + a.si * a.tg;
  *c_new = cn;
  *h_new = a.so * tanhf(cn);
  return a;
}

// vjp of lstm_point: cotangents (dh', dc') of the outputs -> dz[4] (gate
// pre-activations, order i, f, o, g) and dc (the input cell).
__device__ __forceinline__ void lstm_point_vjp(const GateActs& a, float c,
                                               float c_new, float dh,
                                               float dc_new, float dz[4],
                                               float* dc) {
  const float tc = tanhf(c_new);
  const float dso = dh * tc;
  const float dcn = dc_new + dh * a.so * (1.0f - tc * tc);
  const float dsf = dcn * c;
  const float dsi = dcn * a.tg;
  const float dtg = dcn * a.si;
  *dc = dcn * a.sf;
  dz[0] = dsi * a.si * (1.0f - a.si);
  dz[1] = dsf * a.sf * (1.0f - a.sf);
  dz[2] = dso * a.so * (1.0f - a.so);
  dz[3] = dtg * (1.0f - a.tg * a.tg);
}

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

}  // namespace repro

// Every library exports its own copy (each source is its own library).
extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
