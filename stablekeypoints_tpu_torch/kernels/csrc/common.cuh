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

// Four 8x8 b16 matrices from shared memory (ldmatrix.x4, no transpose):
// lanes 8i..8i+7 give the row addresses of matrix i, and lane l receives
// row l / 4, columns 2 (l % 4) .. + 1 of matrix i in r[i]
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
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

// wait until at most the latest committed group is still in flight
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
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


// ---------------------------------------------------------------------------
// Hopper warpgroup MMA (wgmma), A from registers, B from shared memory.

// Shared-memory matrix descriptor of a K-major tile without swizzle, laid
// out in 8x8 core matrices (8 rows of 16 bytes, 128 contiguous bytes each):
// lbo = bytes between core matrices adjacent along K, sbo = bytes between
// core matrices adjacent along the rows (M or N).
__device__ __forceinline__ uint64_t smem_desc(const bf16* tile, uint32_t lbo, uint32_t sbo) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(tile));
  return (static_cast<uint64_t>((addr >> 4) & 0x3fff)) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3fff) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3fff) << 32);
}

// d[64 x 128] (+)= a[64 x 16] . b[16 x 128] for a warpgroup: warp w gives
// rows 16w .. 16w + 15 of a as an mma.m16n8k16 A fragment, and holds those
// rows of d as 16 m16n8 C fragments (d[4j .. 4j + 3] for columns 8j ..).
// b is K-major (its 128 rows are the output columns). accumulate = 0
// overwrites d. Asynchronous: wgmma_fence() before, wgmma_commit() and
// wgmma_wait0() after, before d, a or the b tile is touched again.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t b_desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(accumulate));
}

// the same product with a [64 x 16] read from shared memory through its own
// K-major descriptor (the warpgroup's 64 rows of a; no transpose of a or b)
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t a_desc,
                                                    uint64_t b_desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a_desc), "l"(b_desc), "r"(accumulate));
}

// an empty asm that reads and writes every accumulator register: the compiler
// keeps other instructions' writes of d out of the products in flight (which
// would serialize them)
__device__ __forceinline__ void wgmma_fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// make this thread's generic-proxy shared-memory writes (cp.async included,
// after their wait) visible to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

}  // namespace skp
