// CPU stand-in for the driver API types the port's kernels use (tensor maps
// for TMA copies), for tests/test_torch_cuda_emulation.py.
#pragma once
#include <cstdint>

typedef uint32_t cuuint32_t;
typedef uint64_t cuuint64_t;
typedef int CUresult;
constexpr CUresult CUDA_SUCCESS = 0;
enum CUtensorMapDataType { CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 };
enum CUtensorMapInterleave { CU_TENSOR_MAP_INTERLEAVE_NONE };
enum CUtensorMapSwizzle { CU_TENSOR_MAP_SWIZZLE_NONE };
enum CUtensorMapL2promotion { CU_TENSOR_MAP_L2_PROMOTION_L2_128B };
enum CUtensorMapFloatOOBfill { CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE };
struct alignas(64) CUtensorMap {
  unsigned long long opaque[16];
};

// what the emulated encode keeps in a map's 128 bytes: a bf16 tensor of up
// to 4 dims (strides in bytes, dim 0 contiguous) and the box a copy takes
struct EmuTensorMap {
  const unsigned char* base;
  uint64_t dims[4], strides[4];
  uint32_t box[4];
};
static_assert(sizeof(EmuTensorMap) <= sizeof(CUtensorMap));

inline CUresult emu_encode_tiled(CUtensorMap* map, CUtensorMapDataType, cuuint32_t rank, void* base,
                                 const cuuint64_t* dims, const cuuint64_t* strides,
                                 const cuuint32_t* box, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill) {
  if (rank != 4 || reinterpret_cast<uintptr_t>(base) % 16 || box[0] * 2 % 16) return 1;
  EmuTensorMap m{static_cast<const unsigned char*>(base), {}, {2}, {}};
  for (int i = 0; i < 4; ++i) {
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
