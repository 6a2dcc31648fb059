// CPU stand-in for cuda_fp16.h: fp16 as its 16 bits, converted through the
// host compiler's _Float16 (round-to-nearest-even, as the device converts).
#pragma once
#include "cuda_runtime.h"

struct __half {
  uint16_t v;
};

inline float __half2float(__half h) {
  _Float16 f;
  std::memcpy(&f, &h.v, 2);
  return static_cast<float>(f);
}

inline __half __float2half_rn(float v) {
  const _Float16 f = static_cast<_Float16>(v);
  __half h;
  std::memcpy(&h.v, &f, 2);
  return h;
}

inline __half __ushort_as_half(unsigned short v) { return {v}; }
