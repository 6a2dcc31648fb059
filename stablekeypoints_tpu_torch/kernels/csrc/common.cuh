// Shared device helpers for the port's attention kernels (sm_90a).
//
// The kernels run their products on the tensor cores with the warp-level
// `mma.sync.m16n8k16` (bf16 in, fp32 accumulate): a warp owns 16 query
// rows. Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16"),
// with g = lane / 4 and t = lane % 4:
//   A 16x16 (row-major): a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 8+2t..)  a3 (g+8, 8+2t..)
//   B 16x8  (k x n):     b0 (k 2t..2t+1, n g)  b1 (k 8+2t.., n g)
//   C 16x8  (fp32):      c0,c1 (g, 2t..2t+1)   c2,c3 (g+8, 2t..2t+1)
// so row g of a score tile lives in the 4 lanes of one quad, and two
// neighbouring C tiles of scores, packed to bf16, are exactly the A
// fragment of the following p.v product.
//
// Shared-memory tiles are bf16 with a row stride of (a multiple of 16) + 8
// elements: rows stay 16-byte aligned for cp.async and ldmatrix, and the 8
// rows a fragment load touches fall in 8 different 4-bank groups.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace skp {

typedef __nv_bfloat16 bf16;

constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int round_up16(int d) { return (d + 15) / 16 * 16; }

// row stride (elements) of a shared tile holding `cols` bf16 columns
__host__ __device__ constexpr int tile_ld(int cols) { return round_up16(cols) + 8; }

// max / sum over the 4 lanes of a quad (the lanes holding one fragment row)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// two floats rounded to bf16, lo in the low half (the smaller column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a * b, one m16n8k16 bf16 product with fp32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment of the 16x16 block at (row 0, column k0) of a row-major tile
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* s, int ld, int k0,
                                       int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bf16* p = s + g * ld + k0 + 2 * t;
  a[0] = lds32(p);
  a[1] = lds32(p + 8 * ld);
  a[2] = lds32(p + 8);
  a[3] = lds32(p + 8 * ld + 8);
}

// B fragment of rows^T: B[k][n] = s[n][k0 + k] for the 8 rows n of a
// row-major tile starting at s (keys as rows, depth along the row)
__device__ __forceinline__ void load_bt(uint32_t (&b)[2], const bf16* s, int ld, int k0,
                                        int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bf16* p = s + g * ld + k0 + 2 * t;
  b[0] = lds32(p);
  b[1] = lds32(p + 8);
}

// B fragment B[k][n] = s[k][n0 + n] for k in 0..15 of a row-major tile
// (depth as rows), through ldmatrix's transposing load
__device__ __forceinline__ void load_b(uint32_t (&b)[2], const bf16* s, int ld, int n0,
                                       int lane) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(s + (lane & 15) * ld + n0));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b[0]), "=r"(b[1])
               : "r"(addr));
}

// 16-byte asynchronous copy global -> shared; zero-fills when !valid
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Start copying a rows x (8*CHUNKS) bf16 tile: row r from src + r*stride
// into dst + r*ld. Rows >= valid_rows and columns >= cols are zero.
// Needs cols % 8 == 0 and 16-byte aligned source rows.
template <int CHUNKS>
__device__ __forceinline__ void load_tile_async(bf16* dst, int ld, const bf16* src,
                                                long stride, int rows, int valid_rows,
                                                int cols) {
  for (int idx = threadIdx.x; idx < rows * CHUNKS; idx += blockDim.x) {
    const int r = idx / CHUNKS, c = (idx % CHUNKS) * 8;
    const bool ok = r < valid_rows && c < cols;
    cp_async16(dst + r * ld + c, ok ? src + r * stride + c : src, ok);
  }
}

// S[16 x 8*NT] = A[16 x 16*KS] . B^T for a warp: A fragments in registers,
// B rows (keys) in a shared tile. Scores in C-fragment layout.
template <int KS, int NT>
__device__ __forceinline__ void warp_scores(float (&s)[NT][4], const uint32_t (&a)[KS][4],
                                            const bf16* keys, int ld, int lane) {
#pragma unroll
  for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t b[2];
      load_bt(b, keys + 8 * n * ld, ld, 16 * ks, lane);
      mma_bf16(s[n], a[ks], b);
    }
  }
}

// Scores scaled to the log2 domain; columns k0 + c >= valid are -inf.
template <int NT>
__device__ __forceinline__ void scale_mask(float (&s)[NT][4], float scale_log2, int k0,
                                           int valid, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = k0 + 8 * n + 2 * t + (e & 1);
      s[n][e] = col < valid ? s[n][e] * scale_log2 : -CUDART_INF_F;
    }
}

// o[16 x 8*VT] += p[16 x 16*KK] . V, p in C-fragment layout (2*KK tiles),
// V rows (keys) in a shared tile starting at the p block's first key.
template <int KK, int VT>
__device__ __forceinline__ void warp_pv(float (&o)[VT][4], const float (&p)[2 * KK][4],
                                        const bf16* vals, int ld, int lane) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                           pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                           pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int j = 0; j < VT; ++j) {
      uint32_t b[2];
      load_b(b, vals + 16 * kk * ld, ld, 8 * j, lane);
      mma_bf16(o[j], a, b);
    }
  }
}

}  // namespace skp
