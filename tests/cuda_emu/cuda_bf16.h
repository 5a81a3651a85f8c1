// CPU stand-in for cuda_bf16.h (see cuda_runtime.h here): bfloat16 with
// round-to-nearest-even conversion.
#pragma once
#include <cstdint>
#include <cstring>

struct __nv_bfloat16 {
  uint16_t x;
};
inline float __bfloat162float(__nv_bfloat16 v) {
  const uint32_t u = static_cast<uint32_t>(v.x) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  const uint32_t round = ((u >> 16) & 1u) + 0x7fffu;
  __nv_bfloat16 b;
  b.x = static_cast<uint16_t>((u + round) >> 16);
  return b;
}
inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 v) { return v.x; }
inline __nv_bfloat16 __ushort_as_bfloat16(unsigned short u) {
  __nv_bfloat16 b;
  b.x = u;
  return b;
}
