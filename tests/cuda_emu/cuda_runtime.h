// CPU stand-in for the CUDA runtime surface the port's kernels use, for
// tests/test_torch_cuda_emulation.py. Every CUDA thread of a block runs as
// an OS thread; __syncthreads is a block barrier and the warp collectives
// are warp barriers around an exchange buffer. Blocks run one at a time.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__
#define __align__(n)
#define __restrict__

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct emu_uint3 {
  unsigned x, y, z;
};
inline thread_local emu_uint3 threadIdx, blockIdx, blockDim;

typedef int cudaError_t;
constexpr cudaError_t cudaSuccess = 0;
constexpr cudaError_t cudaErrorInvalidValue = 1;
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
constexpr int kEmuMaxSmem = 232448;  // per block on sm_90

template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int bytes) {
  return bytes <= kEmuMaxSmem ? cudaSuccess : cudaErrorInvalidValue;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
using std::max;
using std::min;

struct EmuWarp {
  std::barrier<> bar{32};
  uint32_t u[32][8];
  float f[32][4];
  const void* p[32];
};
struct EmuBlock {
  std::barrier<>* bar;
  EmuWarp* warps;
};
inline EmuBlock* g_emu_block;
inline EmuWarp& emu_warp() { return g_emu_block->warps[threadIdx.x / 32]; }
inline int emu_lane() { return threadIdx.x % 32; }

inline void __syncthreads() { g_emu_block->bar->arrive_and_wait(); }
inline void __syncwarp() { emu_warp().bar.arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float v, int mask) {
  EmuWarp& w = emu_warp();
  const int l = emu_lane();
  w.f[l][0] = v;
  w.bar.arrive_and_wait();
  const float r = w.f[l ^ mask][0];
  w.bar.arrive_and_wait();
  return r;
}

namespace skp {
alignas(16) inline unsigned char smem[kEmuMaxSmem];
}

// kernel<<<grid, threads, smem_bytes, stream>>>(...) becomes
// emu_launch(grid, threads, smem_bytes, stream, [&] { kernel(...); })
template <class F>
void emu_launch(dim3 grid, int threads, size_t smem_bytes, cudaStream_t, F body) {
  if (smem_bytes > sizeof(skp::smem) || threads % 32) std::abort();
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        std::barrier<> bar(threads);
        std::unique_ptr<EmuWarp[]> warps(new EmuWarp[threads / 32]);
        EmuBlock block{&bar, warps.get()};
        g_emu_block = &block;
        // all-ones bytes are bf16 NaNs: a read of unwritten shared memory shows
        std::memset(skp::smem, 0xFF, sizeof(skp::smem));
        std::vector<std::thread> pool;
        for (int i = 0; i < threads; ++i)
          pool.emplace_back([&, i] {
            threadIdx = {unsigned(i), 0, 0};
            blockIdx = {x, y, z};
            blockDim = {unsigned(threads), 1, 1};
            body();
          });
        for (auto& th : pool) th.join();
      }
}
