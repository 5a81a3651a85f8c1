// The LSTM chain step shared by the LSTM kernels of the port: the gate
// nonlinearities and state update of one (batch row, hidden unit) point and
// its vector-Jacobian product.
//
// Gate order is the JAX package's: z = [x, h] @ W + b splits into i, f, o, g
// (W is (Dx+Dh, 4Dh), gate-major), with the +1.0 forget bias:
//   c' = sigmoid(f + 1) * c + sigmoid(i) * tanh(g),   h' = sigmoid(o) * tanh(c')
// All arithmetic is fp32 (no fast-math intrinsics, no TF32).
#pragma once

#include "common.cuh"

namespace repro {

// A captured segment's argument block: int64 words in device memory that
// the kernels of a captured CUDA graph read at launch, since a graph bakes
// in every pointer it was captured with.  The wrapper writes the block
// before each replay (one small host-to-device copy, ordered on the stream
// before the replay).  ARG_TOK, ARG_TGT: the addresses of the chain's
// (n, B) int32 token ids and targets; ARG_STEP: the segment's first step
// in the chain; ARG_BH, ARG_BC, ARG_BACC: the device addresses of the
// Level-2 slot the advance writes its segment-entry (h, c, acc) into.
enum SegArg {
  ARG_TOK = 0,
  ARG_TGT = 1,
  ARG_STEP = 2,
  ARG_BH = 3,
  ARG_BC = 4,
  ARG_BACC = 5,
  ARG_WORDS = 6
};

// Row t of the segment's ids (ARG_TOK or ARG_TGT), t counted from the
// segment's first step.
__device__ __forceinline__ const int32_t* seg_ids(const long long* args,
                                                  int which, long t, int B) {
  return reinterpret_cast<const int32_t*>(args[which]) +
         (args[ARG_STEP] + t) * B;
}

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

}  // namespace repro
