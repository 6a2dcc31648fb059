// CPU stand-in for the CUDA runtime surface the port's kernels use, for
// tests/test_torch_cuda_emulation.py. Every CUDA thread of a block runs as
// an OS thread; __syncthreads is a block barrier and the warp collectives
// are warp barriers around an exchange buffer. Blocks run one at a time,
// the blocks of a cluster (cudaLaunchKernelEx with a cluster dimension)
// at once, each with its own shared memory; in z, y, x order unless
// emu_set_block_order asks for another (a harness switch: a kernel whose
// result depends on the order its blocks run in shows it).
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <numeric>
#include <random>
#include <thread>
#include <vector>

#include "cuda.h"

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
inline thread_local emu_uint3 threadIdx, blockIdx, blockDim, gridDim;

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
// two "SMs": a persistent kernel's blocks each take several tiles
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* value, cudaDeviceAttr, int) {
  *value = 2;
  return cudaSuccess;
}
using std::max;
using std::min;
#define __grid_constant__

// the driver's entry points by name: the tensor-map encoder only
enum cudaDriverEntryPointQueryResult { cudaDriverEntryPointSuccess, cudaDriverEntryPointSymbolNotFound };
constexpr unsigned long long cudaEnableDefault = 0;
inline cudaError_t cudaGetDriverEntryPoint(const char* name, void** fn, unsigned long long,
                                           cudaDriverEntryPointQueryResult* found) {
  const bool ok = std::strcmp(name, "cuTensorMapEncodeTiled") == 0;
  *fn = ok ? reinterpret_cast<void*>(&emu_encode_tiled) : nullptr;
  *found = ok ? cudaDriverEntryPointSuccess : cudaDriverEntryPointSymbolNotFound;
  return cudaSuccess;
}

struct float2 {
  float x, y;
};
struct float4 {
  float x, y, z, w;
};
struct uint4 {
  unsigned x, y, z, w;
};
// global-memory atomics, fences and L2 loads: blocks run one at a time, and
// a block's threads see each other's writes after a barrier
inline int atomicAdd(int* p, int v) { return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST); }
inline void __threadfence() { __atomic_thread_fence(__ATOMIC_SEQ_CST); }
inline float4 __ldcg(const float4* p) { return *p; }
inline float2 make_float2(float x, float y) { return {x, y}; }
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

struct EmuWarp {
  std::barrier<> bar{32};
  uint32_t u[32][8];
  float f[32][4];
  const void* p[32];
};
struct EmuBlock {
  std::barrier<>* bar;
  EmuWarp* warps;
  std::mutex named_mutex;  // named barriers (bar.sync id, count), made on first use
  std::unique_ptr<std::barrier<>> named[16];
  std::unique_ptr<std::barrier<>> warpgroup[8];  // the wgmma waits' (128 threads), made on first use
};
constexpr int kEmuMaxCluster = 8;
struct EmuCluster {
  int size;
  unsigned char* smem[kEmuMaxCluster];  // each block's shared memory, by rank
  std::barrier<>* bar;                  // every thread of the cluster
};
// this thread's block, its shared memory, its cluster and rank there
inline thread_local EmuBlock* g_emu_block;
inline thread_local unsigned char* g_emu_smem;
inline thread_local EmuCluster* g_emu_cluster;
inline thread_local int g_emu_rank;
// a kernel's `extern __shared__ ... smem[]` reads `unsigned char* smem =
// emu_smem();` in the emulated sources
inline unsigned char* emu_smem() { return g_emu_smem; }
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

// the shared memory of the blocks running at once (a cluster's)
alignas(1024) inline unsigned char g_emu_smem_pool[kEmuMaxCluster][kEmuMaxSmem];
// a shared-memory address is its offset in the block's shared memory
inline size_t __cvta_generic_to_shared(const void* p) {
  return static_cast<const unsigned char*>(p) - g_emu_smem;
}

// the order the grid's clusters run in: 0 z, y, x; 1 the reverse; 2 a
// permutation drawn from the seed (one draw a launch)
inline int g_emu_block_order = 0;
inline unsigned g_emu_block_seed = 0;
extern "C" void emu_set_block_order(int order, unsigned seed) {
  g_emu_block_order = order;
  g_emu_block_seed = seed;
}

// the grid in clusters of `cluster` blocks along x, one cluster at a time
template <class F>
void emu_run(dim3 grid, int threads, size_t smem_bytes, int cluster, F body) {
  if (smem_bytes > kEmuMaxSmem || threads % 32 || cluster < 1 || cluster > kEmuMaxCluster ||
      grid.x % cluster)
    std::abort();
  const unsigned nx = grid.x / cluster;
  std::vector<unsigned> order(static_cast<size_t>(nx) * grid.y * grid.z);
  std::iota(order.begin(), order.end(), 0u);
  if (g_emu_block_order == 1) std::reverse(order.begin(), order.end());
  if (g_emu_block_order == 2) std::shuffle(order.begin(), order.end(), std::mt19937(g_emu_block_seed++));
  for (const unsigned c : order) {
    const unsigned x0 = c % nx * cluster, y = c / nx % grid.y, z = c / nx / grid.y;
    std::barrier<> cbar(threads * cluster);
    EmuCluster cl{cluster, {}, &cbar};
    std::vector<std::unique_ptr<std::barrier<>>> bars;
    std::vector<std::unique_ptr<EmuWarp[]>> warps;
    std::vector<std::unique_ptr<EmuBlock>> blocks;
    for (int r = 0; r < cluster; ++r) {
      bars.emplace_back(new std::barrier<>(threads));
      warps.emplace_back(new EmuWarp[threads / 32]);
      blocks.emplace_back(new EmuBlock{bars.back().get(), warps.back().get()});
      cl.smem[r] = g_emu_smem_pool[r];
      // all-ones bytes are bf16 NaNs: a read of unwritten shared memory shows
      std::memset(cl.smem[r], 0xFF, kEmuMaxSmem);
    }
    std::vector<std::thread> pool;
    for (int r = 0; r < cluster; ++r)
      for (int i = 0; i < threads; ++i)
        pool.emplace_back([&, r, i] {
          g_emu_block = blocks[r].get();
          g_emu_smem = cl.smem[r];
          g_emu_cluster = &cl;
          g_emu_rank = r;
          threadIdx = {unsigned(i), 0, 0};
          blockIdx = {x0 + unsigned(r), y, z};
          blockDim = {unsigned(threads), 1, 1};
          gridDim = {grid.x, grid.y, grid.z};
          body();
        });
    for (auto& th : pool) th.join();
  }
}

// kernel<<<grid, threads, smem_bytes, stream>>>(...) becomes
// emu_launch(grid, threads, smem_bytes, stream, [&] { kernel(...); })
template <class F>
void emu_launch(dim3 grid, int threads, size_t smem_bytes, cudaStream_t, F body) {
  emu_run(grid, threads, smem_bytes, 1, body);
}

// cudaLaunchKernelEx with the one attribute the kernels give, the cluster
// dimension (along x)
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttributeValue {
  struct {
    unsigned x, y, z;
  } clusterDim;
};
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  cudaLaunchAttributeValue val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
template <class... P, class... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, void (*kernel)(P...), A&&... args) {
  int cluster = 1;
  for (unsigned i = 0; i < cfg->numAttrs; ++i)
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension) {
      if (cfg->attrs[i].val.clusterDim.y != 1 || cfg->attrs[i].val.clusterDim.z != 1) std::abort();
      cluster = int(cfg->attrs[i].val.clusterDim.x);
    }
  emu_run(cfg->gridDim, int(cfg->blockDim.x), cfg->dynamicSmemBytes, cluster, [&] { kernel(args...); });
  return cudaSuccess;
}
