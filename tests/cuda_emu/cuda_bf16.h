// CPU stand-in for cuda_bf16.h: bf16 as its 16 bits, round-to-nearest-even.
#pragma once
#include "cuda_runtime.h"

struct __nv_bfloat16 {
  uint16_t v;
};
struct __nv_bfloat162 {
  __nv_bfloat16 x, y;  // x in the low half, as on the device
};

inline float __bfloat162float(__nv_bfloat16 h) {
  const uint32_t u = uint32_t(h.v) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {uint16_t((u >> 16) | 0x40u)};  // quiet NaN
  return {uint16_t((u + 0x7fffu + ((u >> 16) & 1u)) >> 16)};
}

inline __nv_bfloat162 __floats2bfloat162_rn(float lo, float hi) {
  return {__float2bfloat16(lo), __float2bfloat16(hi)};
}

inline __nv_bfloat16 __ushort_as_bfloat16(unsigned short v) { return {v}; }

// bf16x2 arithmetic: each lane's op in fp32, rounded once to bf16 (what the
// correctly rounded device instructions give for bf16 operands)
inline __nv_bfloat162 emu_bf16x2(__nv_bfloat162 a, __nv_bfloat162 b, float (*op)(float, float)) {
  return {__float2bfloat16(op(__bfloat162float(a.x), __bfloat162float(b.x))),
          __float2bfloat16(op(__bfloat162float(a.y), __bfloat162float(b.y)))};
}
inline __nv_bfloat162 __hadd2(__nv_bfloat162 a, __nv_bfloat162 b) {
  return emu_bf16x2(a, b, [](float u, float v) { return u + v; });
}
inline __nv_bfloat162 __hsub2(__nv_bfloat162 a, __nv_bfloat162 b) {
  return emu_bf16x2(a, b, [](float u, float v) { return u - v; });
}
inline __nv_bfloat162 __hmul2(__nv_bfloat162 a, __nv_bfloat162 b) {
  return emu_bf16x2(a, b, [](float u, float v) { return u * v; });
}
inline float __low2float(__nv_bfloat162 a) { return __bfloat162float(a.x); }
inline float __high2float(__nv_bfloat162 a) { return __bfloat162float(a.y); }
// the SFU's exp2-based exponential and fast division, to fp32 rounding
inline float __expf(float v) { return std::exp2(v * 1.4426950408889634f); }
inline float __fdividef(float a, float b) { return a / b; }
