// K6: GroupNorm statistics folded into per-(batch, channel) affine
// coefficients, one launch per GroupNorm (sm_90a).
//
// Replaces the statistics of stablekeypoints_tpu/kernels/groupnorm.py
// gn_affine_coeffs -> _coeffs_impl (pallas_call at :110) and the jnp glue
// after it:
//
//   mean_g = E[x] over (HW, the group's C / G channels), var_g likewise (fp32)
//   a[b,c]      = scale[c] / sqrt(var_g + eps)
//   m_q[b,c]    = mean_g rounded to x's type (the value the consumer subtracts)
//   b_comp[b,c] = bias[c] + (m_q - mean_g) * a
//
// for channels-last x [B, HW, C] in bf16, fp16 or fp32. The TPU kernel
// carried its sums across a sequential grid axis; blocks on Hopper run in
// no order, so the grid is (row chunks, B), sized to put a few blocks on
// every SM, and the last block of each batch element to finish merges.
//
// Each thread owns 16 bytes of a row's channels (8 bf16 / fp16, 4 fp32) and
// walks every (256 / threads a row)-th row of its chunk, four 16-byte loads
// in flight, summing x - ref and (x - ref)^2 per channel in fp32 registers.
// ref is the per-channel mean of the batch element's first 8 rows, the same
// in every block: the sums stay centred, so the variance of a tensor with
// mean 30 and std 0.5 does not cancel, and partial sums that share the
// shift combine by a plain sum. A block reduces its threads' sums in shared
// memory in a fixed order and writes one partial row (s0, s1 per channel)
// to an fp32 scratch; then it takes a ticket (after a fence) from its group
// of 8 chunks' counter. The holder of a group's last ticket sums the
// group's rows in chunk order into the group's first row and takes a ticket
// from the batch element's counter; the holder of that last ticket sums the
// group rows in order, forms each group's mean and variance
// (sum_c [s1 - 2 (mean - ref) s0 + HW (mean - ref)^2]) and writes the three
// coefficient rows. Each last holder resets its counter to 0 for the next
// launch. Two levels keep each merge to a few rows (one round of loads in
// flight) instead of one block reading every chunk's row. The sums never
// depend on which block finishes last, so the result is bitwise
// reproducible. Launches that share the counter buffer must not run
// concurrently (one stream).
//
// Bound: bytes (x read once; a few FLOP an element). The Triton version
// this replaces took two launches (a statistics pass whose ~1000 programs
// each re-read a whole first tile for the shift, then a coefficient pass
// of B x 32 programs), with one tile load in flight a program.
#include <cuda_fp16.h>

#include "common.cuh"

namespace skp {

constexpr int kGnThreads = 256;
constexpr int kGnUnroll = 4;   // 16-byte loads in flight a thread
constexpr int kGnRefRows = 8;  // rows whose per-channel mean is the shift
constexpr int kGnGroup = 8;    // chunks merged by the last block of their group
constexpr int kGnCounters = 128;  // counters a batch element: groups, then each group's chunks

// the 16 bytes of x at p as floats; the mean rounded to x's type
__device__ __forceinline__ void gn_unpack(const uint4& v, float (&f)[8], const bf16*) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = bf16_lo(w[i]);
    f[2 * i + 1] = bf16_hi(w[i]);
  }
}
__device__ __forceinline__ void gn_unpack(const uint4& v, float (&f)[8], const __half*) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __half2float(__ushort_as_half(static_cast<unsigned short>(w[i] & 0xffffu)));
    f[2 * i + 1] = __half2float(__ushort_as_half(static_cast<unsigned short>(w[i] >> 16)));
  }
}
__device__ __forceinline__ void gn_unpack(const uint4& v, float (&f)[4], const float*) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ float gn_round(float v, const bf16*) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ float gn_round(float v, const __half*) {
  return __half2float(__float2half_rn(v));
}
__device__ __forceinline__ float gn_round(float v, const float*) { return v; }

// scale or bias element c: kind 0 fp32, 1 bf16, 2 fp16
__device__ __forceinline__ float gn_param(const void* p, int kind, int c) {
  if (kind == 1) return __bfloat162float(static_cast<const bf16*>(p)[c]);
  if (kind == 2) return __half2float(static_cast<const __half*>(p)[c]);
  return static_cast<const float*>(p)[c];
}

// After this block's writes: a fence, then a ticket from *cnt; true (for the
// whole block) for the holder of the last of `n` tickets, which resets *cnt
// and fences before reading what the others wrote
__device__ __forceinline__ bool gn_ticket(int* cnt, int n, int* is_last) {
  __threadfence();  // this block's rows reach L2 before its ticket
  __syncthreads();
  if (threadIdx.x == 0) {
    *is_last = atomicAdd(cnt, 1) == n - 1;
    if (*is_last) *cnt = 0;
  }
  __syncthreads();
  if (!*is_last) return false;
  __threadfence();
  return true;
}

// dst[i] = sum over rows r in order of src[r * stride + i], i < 2C, as
// float4 columns, each thread eight rows' loads in flight (src from L2: other
// SMs wrote it; dst may be src's first row)
__device__ __forceinline__ void gn_merge_rows(const float* src, int rows, long stride, float* dst,
                                              int C) {
  for (int col = threadIdx.x; col < C / 2; col += kGnThreads) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r0 = 0; r0 < rows; r0 += 8) {
      float4 v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        v[i] = r0 + i < rows ? __ldcg(reinterpret_cast<const float4*>(src + (r0 + i) * stride) + col)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc.x += v[i].x;
        acc.y += v[i].y;
        acc.z += v[i].z;
        acc.w += v[i].w;
      }
    }
    reinterpret_cast<float4*>(dst)[col] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kGnThreads, 4)
    gn_coeffs_kernel(const T* __restrict__ x, const void* scale, const void* bias, int pkind,
                     float* __restrict__ part, int* __restrict__ counter, float* __restrict__ m_out,
                     float* __restrict__ a_out, float* __restrict__ b_out, int HW, int C, int G,
                     int rows_per_chunk, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);  // [2][threads][VEC]: each thread's s0, s1
  float* ref_s = red + 2 * kGnThreads * VEC;    // [C] the shift
  float* tot = ref_s + C;                       // [2][C] the batch element's sums (last block)
  float* grp = tot + 2 * C;                     // [2][G] group mean, 1 / sqrt(var + eps)
  int* is_last = reinterpret_cast<int*>(grp + 2 * G);

  const int tid = threadIdx.x, b = blockIdx.y, chunk = blockIdx.x, chunks = gridDim.x;
  const int tpr = C / VEC, rpi = kGnThreads / tpr;  // threads a row, rows an iteration
  const int lc = tid % tpr, rr = tid / tpr, c0 = lc * VEC;
  const T* xb = x + static_cast<long>(b) * HW * C;

  const int r1 = min(HW, (chunk + 1) * rows_per_chunk);
  int r = chunk * rows_per_chunk + rr;  // this thread's rows: r, r + rpi, ... < r1
  uint4 v[kGnUnroll];
  auto load = [&](int row) {  // rows past the chunk are loaded (valid memory), not summed
#pragma unroll
    for (int u = 0; u < kGnUnroll; ++u)
      v[u] = *reinterpret_cast<const uint4*>(
          xb + static_cast<long>(min(row + u * rpi, r1 - 1)) * C + c0);
  };
  if (rr < rpi) load(r);  // the first loads fly while the shift is formed

  // the shift: each thread sums its channels over its rows among the first
  // nref (one round of loads), then each channel's partial sums in row order
  const int nref = min(kGnRefRows, HW);
  if (rr < rpi) {
    float acc[VEC] = {};
#pragma unroll
    for (int i = 0; i < kGnRefRows; ++i) {
      const int row = rr + i * rpi;
      if (row < nref) {
        float f[VEC];
        gn_unpack(*reinterpret_cast<const uint4*>(xb + static_cast<long>(row) * C + c0), f, xb);
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] += f[e];
      }
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) red[tid * VEC + e] = acc[e];
  }
  __syncthreads();
  for (int c = tid; c < C; c += kGnThreads) {
    float acc = 0.f;
    for (int i = 0; i < min(rpi, nref); ++i) acc += red[(i * tpr + c / VEC) * VEC + c % VEC];
    ref_s[c] = acc / nref;
  }
  __syncthreads();

  float ref[VEC], s0[VEC], s1[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    ref[e] = ref_s[c0 + e];
    s0[e] = s1[e] = 0.f;
  }
  if (rr < rpi) {
    for (; r < r1; r += kGnUnroll * rpi) {
#pragma unroll
      for (int u = 0; u < kGnUnroll; ++u) {
        if (r + u * rpi >= r1) break;
        float f[VEC];
        gn_unpack(v[u], f, xb);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float d = f[e] - ref[e];
          s0[e] += d;
          s1[e] = fmaf(d, d, s1[e]);
        }
      }
      if (r + kGnUnroll * rpi < r1) load(r + kGnUnroll * rpi);
    }
  }
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    red[tid * VEC + e] = s0[e];
    red[(kGnThreads + tid) * VEC + e] = s1[e];
  }
  __syncthreads();
  // the block's partial row: channel c summed over the rows an iteration, in order
  float* prow = part + (static_cast<long>(b) * chunks + chunk) * 2 * C;
  for (int c = tid; c < C; c += kGnThreads) {
    float a0 = 0.f, a1 = 0.f;
    for (int i = 0; i < rpi; ++i) {
      const int at = (i * tpr + c / VEC) * VEC + c % VEC;
      a0 += red[at];
      a1 += red[kGnThreads * VEC + at];
    }
    prow[c] = a0;
    prow[C + c] = a1;
  }
  // the two ticket levels (see the top of the file)
  const int cgrp = chunk / kGnGroup, groups = (chunks + kGnGroup - 1) / kGnGroup;
  const int in_grp = min(kGnGroup, chunks - cgrp * kGnGroup);
  int* cnt = counter + static_cast<long>(b) * kGnCounters;  // [0] groups, [1 + cgrp] chunks
  float* pb = part + static_cast<long>(b) * chunks * 2 * C;
  if (!gn_ticket(&cnt[1 + cgrp], in_grp, is_last)) return;
  float* grow = pb + static_cast<long>(cgrp) * kGnGroup * 2 * C;
  gn_merge_rows(grow, in_grp, 2 * C, grow, C);
  if (!gn_ticket(&cnt[0], groups, is_last)) return;
  gn_merge_rows(pb, groups, kGnGroup * 2 * C, tot, C);  // the last block: into shared memory
  __syncthreads();
  const int cg = C / G;
  const float hw = static_cast<float>(HW), n = hw * cg;
  for (int g = tid; g < G; g += kGnThreads) {
    float t0 = 0.f, tr = 0.f;
    for (int j = 0; j < cg; ++j) {
      t0 += tot[g * cg + j];
      tr += ref_s[g * cg + j];
    }
    const float mean = (t0 + hw * tr) / n;
    float ss = 0.f;
    for (int j = 0; j < cg; ++j) {
      const int c = g * cg + j;
      const float dmu = mean - ref_s[c];
      ss += tot[C + c] - 2.f * dmu * tot[c] + hw * dmu * dmu;
    }
    grp[g] = mean;
    grp[G + g] = 1.f / sqrtf(fmaxf(ss / n, 0.f) + eps);
  }
  __syncthreads();
  for (int c = tid; c < C; c += kGnThreads) {
    const float mean = grp[c / cg], a = grp[G + c / cg] * gn_param(scale, pkind, c);
    const float mq = gn_round(mean, xb);
    const long o = static_cast<long>(b) * C + c;
    m_out[o] = mq;
    a_out[o] = a;
    b_out[o] = gn_param(bias, pkind, c) + (mq - mean) * a;
  }
}

template <typename T>
static int launch_gn_coeffs(const void* x, const void* scale, const void* bias, int pkind,
                            void* part, void* counter, void* m, void* a, void* bc, int B, int HW,
                            int C, int G, int chunks, float eps, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  if (C % VEC != 0 || C / VEC > kGnThreads || C % G != 0 || chunks < 1 || HW < 1) return -1;
  chunks = min(chunks, kGnGroup * (kGnCounters - 1));
  const int rows_per_chunk = (HW + chunks - 1) / chunks;
  chunks = (HW + rows_per_chunk - 1) / rows_per_chunk;  // no empty chunk
  const size_t bytes = sizeof(float) * (2 * kGnThreads * VEC + 3 * C + 2 * G) + sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(gn_coeffs_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(chunks, B);
  gn_coeffs_kernel<T><<<grid, kGnThreads, bytes, stream>>>(
      static_cast<const T*>(x), scale, bias, pkind, static_cast<float*>(part),
      static_cast<int*>(counter), static_cast<float*>(m), static_cast<float*>(a),
      static_cast<float*>(bc), HW, C, G, rows_per_chunk, eps);
  return (int)cudaGetLastError();
}

}  // namespace skp

// x [B, HW, C] (dtype: 0 fp32, 1 bf16, 2 fp16), scale / bias [C] (pkind, the
// same codes) -> m_q, a, b_comp [B, C] fp32. part is an fp32 scratch of
// B * chunks * 2 * C values (chunks >= 1: the row chunks a batch element
// is cut into, fewer if HW is short, at most 1016), counter B * 128 ints
// that are 0 and left 0.
// Returns a cudaError_t, or -1 for a shape the kernel does not take (C not
// whole 16-byte vectors or wider than 256 of them, C % G != 0).
extern "C" int skp_gn_coeffs(const void* x, const void* scale, const void* bias, void* part,
                             void* counter, void* m, void* a, void* bc, int dtype, int pkind, int B,
                             int HW, int C, int G, int chunks, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return skp::launch_gn_coeffs<float>(x, scale, bias, pkind, part, counter, m, a, bc, B, HW,
                                          C, G, chunks, eps, s);
    case 1:
      return skp::launch_gn_coeffs<skp::bf16>(x, scale, bias, pkind, part, counter, m, a, bc, B,
                                              HW, C, G, chunks, eps, s);
    case 2:
      return skp::launch_gn_coeffs<__half>(x, scale, bias, pkind, part, counter, m, a, bc, B, HW,
                                           C, G, chunks, eps, s);
    default: return -1;
  }
}
