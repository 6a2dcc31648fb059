// CPU stand-in for the driver API types the port's kernels use (tensor maps
// for TMA copies), for tests/test_torch_cuda_emulation.py.
#pragma once
#include <cstdint>

typedef uint32_t cuuint32_t;
typedef uint64_t cuuint64_t;
typedef int CUresult;
constexpr CUresult CUDA_SUCCESS = 0;
enum CUtensorMapDataType { CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, CU_TENSOR_MAP_DATA_TYPE_FLOAT32 };
enum CUtensorMapInterleave { CU_TENSOR_MAP_INTERLEAVE_NONE };
enum CUtensorMapSwizzle { CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_SWIZZLE_128B };
enum CUtensorMapL2promotion { CU_TENSOR_MAP_L2_PROMOTION_L2_128B };
enum CUtensorMapFloatOOBfill { CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE };
struct alignas(64) CUtensorMap {
  unsigned long long opaque[16];
};

// what the emulated encode keeps in a map's 128 bytes: a bf16 or fp32 tensor
// of up to 4 dims (strides in bytes, dim 0 contiguous; missing dims 1) and
// the box a copy takes
struct EmuTensorMap {
  const unsigned char* base;
  uint64_t dims[4], strides[4];
  uint32_t box[4];
  uint32_t esize;
  bool sw128;  // boxes of 128-byte rows land in the 128-byte swizzle layout
};
static_assert(sizeof(EmuTensorMap) <= sizeof(CUtensorMap));

inline CUresult emu_encode_tiled(CUtensorMap* map, CUtensorMapDataType type, cuuint32_t rank, void* base,
                                 const cuuint64_t* dims, const cuuint64_t* strides,
                                 const cuuint32_t* box, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle swizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill) {
  const uint32_t esize = type == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4 : 2;
  if (rank < 1 || rank > 4 || reinterpret_cast<uintptr_t>(base) % 16 || box[0] * esize % 16)
    return 1;
  EmuTensorMap m{static_cast<const unsigned char*>(base), {1, 1, 1, 1}, {esize}, {1, 1, 1, 1}, esize,
                 swizzle == CU_TENSOR_MAP_SWIZZLE_128B};
  if (m.sw128 && box[0] * esize != 128) return 1;
  for (uint32_t i = 0; i < rank; ++i) {
    if (box[i] < 1 || box[i] > 256) return 1;
    m.dims[i] = dims[i];
    m.box[i] = box[i];
    if (i > 0) {
      if (strides[i - 1] % 16) return 1;
      m.strides[i] = strides[i - 1];
    }
  }
  *reinterpret_cast<EmuTensorMap*>(map) = m;
  return CUDA_SUCCESS;
}
