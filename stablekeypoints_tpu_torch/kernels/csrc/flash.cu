// K4/K5: flash (online-softmax) attention, forward and backward (sm_90a).
//
// Replaces stablekeypoints_tpu/kernels/flash.py flash_self_attention (K4)
// and flash_cross_attention (K5), which call JAX's stock Pallas TPU
// flash_attention. K5 there pads kv to 128 and masks through segment ids;
// here it is the same kernel with a kv-length mask on the last key tile.
//
//   out = softmax(q . k^T * scale) . v   fp32 running max/sum/accumulator
//
// d 40 and 80: attn_fwd_kernel<D> (attn_fwd.cuh): two (d 40) or four
// (d 80) warpgroups of 64 query rows per block, wgmma products, a ring of
// 64-key tiles copied by TMA, one FFMA + one ex2 per score, tile j+1's
// scores in flight during tile j's softmax. What bounds it on the H100: the
// exponentials at d 40 (N*M*B*H ex2 at 16 per clock per SM, above the
// products' 4*N*M*D FLOP at the bf16 peak), the products at d 80. d 64:
// attn_fwd_ws_kernel (attn_fwd.cuh), persistent and warp-specialized, in
// FlashAttention-3's form (a producer warp, 128-key tiles, two consumer
// warpgroups taking turns at the tensor cores).
//
// d = 512 (the VAE mid-block, one head) has its own kernel,
// flash_wide_kernel: a 64 x 512 fp32 accumulator is half an SM's register
// file, so no block holds more than 64 query rows, and the block is
// warp-specialized around them. A producer warpgroup (setmaxnreg down to
// 40) has one thread issue every TMA copy: q once, then k and v of each
// 64-key tile into one k stage and one v stage (64 KB each, 128-byte
// swizzle, full / empty mbarriers), so k of tile j + 1 lands during tile
// j's softmax and p.v, and v of tile j + 1 during tile j + 1's q.k^T. Two
// consumer warpgroups (setmaxnreg up to 232; ptxas compiles every role
// within the 168 registers that 12 warps leave a thread, which the 128
// accumulators and 16 scores fit) share the 64 rows: warpgroup w scores
// keys 32w .. 32w + 31 of a tile (m64n32k16, 32 k-steps, q and k from
// shared memory), the two exchange row maxima through shared memory, each
// writes its p to a shared [64][64] bf16 tile (128-byte swizzle), and after
// a named barrier of the 256 consumer threads each runs o[:, 256w ..] +=
// p . v[:, 256w ..] (m64n256k16, p K-major, v MN-major through the
// transpose bit; 128 fp32 accumulators a thread). Both warpgroups see the
// same maxima, so they rescale alike; each keeps the sum of its own keys'
// p, added at the end. Two named barriers a tile, no block barrier.
//
// Bound: operations (4 N M D FLOP: 0.347 ms at the bf16 peak for the VAE's
// [10, 4096, 1, 512]); every 64-row block reads its image's k and v (8 MB)
// from L2, 5.1 GB a launch. Measured on an H100 (PERF.md,
// tools/wide_attn_variants.py): 0.69 ms (the mma.sync kernel it replaced:
// 2.38), about as fast without the k / v copies or without the
// exponentials; with 1 of q.k^T's 32 k-steps 24% faster: the tile's chain
// (q.k^T, exchange, softmax, p.v, each waited for) runs in lockstep in
// both warpgroups, and the tensor cores idle during the softmax. So a
// cluster sharing k and v by TMA multicast (half the L2 reads) cannot help
// until that chain is shorter. Tried and dropped: 32-key tiles with q.k^T
// split by depth between the warpgroups (partial scores exchanged, p from
// registers, tile j + 1's q.k^T and tile j's p.v back to back under the
// softmax) took 1.18 ms with the copies issued by a consumer thread; with a
// producer warpgroup it needed more than 168 registers, spilled, and ptxas
// serialized the products (1.52 ms). Retiring tile j's p.v under tile
// j + 1's q.k^T (a product group in flight across the loop's back edge)
// made ptxas serialize them too (0.95 ms); skipping the o rescale when no
// row max moved cost more than it saved (0.705 against 0.685).
//
// With a non-null `lse`, the d 40 / 64 / 80 kernels also write each row's
// log-sum-exp of the log2-domain logits (fp32 [B, H, N]), the residual of
// the backward (attn_bwd.cuh); skp_flash_bwd first forms di = rowsum(dO*O)
// from the bf16 output, as JAX's stock backward does, then runs the rows
// and keys passes as one grid (attn_rk_kernel): no reduce-adds, dq, dk and
// dv bitwise reproducible.
//
// Backward bound: operations (the passes' 14*N*M*D FLOP; two ex2 a score).
#include "attn_bwd.cuh"
#include "attn_fwd.cuh"

namespace skp {

// di[b, h, n] = sum_d o[b,n,h,d] * dout[b,n,h,d] in fp32, one thread per
// row with 16-byte loads
__global__ void flash_di_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                                float* __restrict__ di, int N, int H, int D, long rows) {
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;  // (b, n, h)
  if (i >= rows) return;
  const uint4* a = reinterpret_cast<const uint4*>(o + i * D);
  const uint4* c = reinterpret_cast<const uint4*>(dout + i * D);
  float s = 0.f;
  for (int j = 0; j < D / 8; ++j) {
    const uint4 x = a[j], y = c[j];
    const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      s = fmaf(bf16_lo(xs[u]), bf16_lo(ys[u]), s);
      s = fmaf(bf16_hi(xs[u]), bf16_hi(ys[u]), s);
    }
  }
  const long b = i / (static_cast<long>(N) * H);
  const long n = (i / H) % N, h = i % H;
  di[(b * H + h) * N + n] = s;
}

// di, then the rows and keys passes with the forward's lse given
template <int D>
static int launch_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                            const void* dout, const void* lse, void* di, void* dkv_part, void* dq,
                            void* dk, void* dv, int B, int N, int M, int H, int Z, float scale,
                            cudaStream_t stream) {
  const long rows = static_cast<long>(B) * N * H;
  flash_di_kernel<<<(unsigned)((rows + 255) / 256), 256, 0, stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), static_cast<float*>(di), N, H, D, rows);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_attn_rk<D, true>(q, k, v, dout, const_cast<void*>(lse), di, dkv_part, dq, dk, dv, B, N, M,
                                 H, Z, scale, stream);
}

constexpr int kWideD = 512;
constexpr int kWideBQ = 64;                    // query rows per block
constexpr int kWideBK = 64;                    // keys per tile, 32 per consumer warpgroup
constexpr int kWideTile = kWideBQ * kWideD;    // q, the k stage, the v stage: [8][64][64] each
constexpr int kWideThreads = 384;              // a producer and two consumer warpgroups
// q, k, v, p (bf16, 1024-byte aligned), row maxima and sums [2][64], 5 mbarriers
constexpr size_t kWideBytes = sizeof(bf16) * (3 * kWideTile + kWideBQ * kWideBK) +
                              sizeof(float) * 4 * kWideBQ + sizeof(uint64_t) * 5;

// q [B,N,H,512], k/v [B,M,H,512] (tensor maps: boxes of 64 rows x 64
// columns in the 128-byte swizzle) -> out [B,N,H,512]; one block a (64
// query rows, h, b)
__global__ void __launch_bounds__(kWideThreads, 1)
    flash_wide_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out, int N, int M,
                      int H, float c) {
  constexpr int D = kWideD, BQ = kWideBQ, BK = kWideBK, CB = D / 64;
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [column block][64 rows][64], 128-byte swizzle
  bf16* Ks = Qs + kWideTile;                 // the k stage, the same layout
  bf16* Vs = Ks + kWideTile;                 // the v stage
  bf16* Ps = Vs + kWideTile;                 // p [64 rows][64 keys], 128-byte swizzle
  float* Red = reinterpret_cast<float*>(Ps + BQ * BK);  // [warpgroup][row] a tile's row max
  float* Lsum = Red + 2 * BQ;                           // [warpgroup][row] the row sums
  uint64_t* bars = reinterpret_cast<uint64_t*>(Lsum + 2 * BQ);
  uint64_t *q_full = bars, *k_full = bars + 1, *k_empty = bars + 2, *v_full = bars + 3,
           *v_empty = bars + 4;

  const int tid = threadIdx.x, lane = tid % 32;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int tiles = (M + BK - 1) / BK;
  if (tid == 0) {
    mbar_init(q_full, 1);
    mbar_init(k_full, 1);
    mbar_init(v_full, 1);
    mbar_init(k_empty, 8);  // one arrival per consumer warp
    mbar_init(v_empty, 8);
    mbar_fence_init();
  }
  __syncthreads();

  if (tid < 128) {  // the producer warpgroup: its first thread issues every copy
    setmaxnreg_dec<40>();
    if (tid == 0) {
      // a [64 rows][512] tile as 8 boxes of 64 columns (rows past N or M zero)
      auto load = [&](bf16* dst, const CUtensorMap* map, int r0, uint64_t* bar) {
        mbar_expect_tx(bar, kWideTile * 2);
        for (int cb = 0; cb < CB; ++cb) tma_load_4d(dst + cb * 64 * 64, map, 64 * cb, h, r0, b, bar);
      };
      load(Qs, &tq, q0, q_full);
      for (int j = 0; j < tiles; ++j) {
        if (j > 0) mbar_wait(k_empty, (j - 1) & 1);  // tile j - 1's q.k^T done: k of tile j
        load(Ks, &tk, j * BK, k_full);
        if (j > 0) mbar_wait(v_empty, (j - 1) & 1);  // tile j - 1's p.v done: v of tile j
        load(Vs, &tv, j * BK, v_full);
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int wg = tid / 128 - 1, warp = (tid / 32) % 4, g = lane >> 2, t = lane & 3;
  const int rows[2] = {16 * warp + g, 16 * warp + g + 8};  // this thread's rows of the tile
  const int kw = 32 * wg;                                  // its warpgroup's keys of a tile
  float o[128];  // o[:, 256 wg ..] as m64n256 fragments
#pragma unroll
  for (int i = 0; i < 128; ++i) o[i] = 0.f;
  float m_r[2] = {-CUDART_INF_F, -CUDART_INF_F}, l_r[2] = {0.f, 0.f};
  mbar_wait(q_full, 0);

  for (int j = 0; j < tiles; ++j) {
    // s = q . k^T over this warpgroup's 32 keys (q and k from shared memory)
    float s[16];
    mbar_wait(k_full, j & 1);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_m64n32k16_ss(s, desc_sw128_kmajor<BQ>(Qs, ks), desc_sw128_kmajor<BK>(Ks + kw * 64, ks),
                         ks > 0);
    wgmma_commit();
    wgmma_wait0();
    reg_fence(s);
    __syncwarp();
    if (lane == 0) mbar_arrive(k_empty);

    const int k0 = j * BK + kw;  // keys past M are -inf (only the last tile has any)
    if (k0 + 32 > M)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + 8 * jj + 2 * t + (e & 1) >= M) s[4 * jj + e] = -CUDART_INF_F;
    // the row max over both warpgroups' keys, exchanged through shared memory
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) mx = fmaxf(mx, fmaxf(s[4 * jj + 2 * r], s[4 * jj + 2 * r + 1]));
      mx = quad_max(mx);  // -inf if this warpgroup's keys are all masked
      if (t == 0) Red[wg * BQ + rows[r]] = mx;
    }
    named_bar_sync(1, 256);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // finite: each tile's first key is valid, and it is warpgroup 0's
      const float m_new = fmaxf(m_r[r], fmaxf(Red[rows[r]], Red[BQ + rows[r]]));
      alpha[r] = fast_exp2((m_r[r] - m_new) * c);  // 0 on the first tile
      m_r[r] = m_new;
      const float mc = m_new * c;
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p0 = fast_exp2(fmaf(s[4 * jj + 2 * r], c, -mc));
        const float p1 = fast_exp2(fmaf(s[4 * jj + 2 * r + 1], c, -mc));
        sum += p0 + p1;
        // p[row][kw + 8 jj + 2 t ..]: 16-byte chunk kw / 8 + jj of the row, swizzled
        const int row = rows[r];
        *reinterpret_cast<uint32_t*>(Ps + row * BK + (((kw / 8 + jj) ^ (row & 7)) << 3) + 2 * t) =
            pack_bf16(p0, p1);
      }
      l_r[r] = fmaf(l_r[r], alpha[r], sum);  // this warpgroup's keys
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      o[4 * i] *= alpha[0];
      o[4 * i + 1] *= alpha[0];
      o[4 * i + 2] *= alpha[1];
      o[4 * i + 3] *= alpha[1];
    }
    fence_proxy_async();
    named_bar_sync(1, 256);  // p of both warpgroups in shared memory
    // o[:, 256 wg ..] += p . v[:, 256 wg ..] (v MN-major: column blocks 4 wg ..)
    mbar_wait(v_full, j & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_m64n256k16_ss_tb(o, desc_sw128_kmajor<BQ>(Ps, kk),
                             desc_sw128_mnmajor<BK>(Vs + 4 * wg * 64 * 64, 16 * kk), 1);
    wgmma_commit();
    wgmma_wait0();
    reg_fence(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(v_empty);
  }

  // the row sums of both warpgroups' keys, then out = o / l
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = quad_sum(l_r[r]);
    if (t == 0) Lsum[wg * BQ + rows[r]] = l;
  }
  named_bar_sync(1, 256);
  const long row = static_cast<long>(H) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qr = q0 + rows[r];
    if (qr >= N) continue;
    const float inv = 1.0f / (Lsum[rows[r]] + Lsum[BQ + rows[r]]);
    bf16* dst = out + (static_cast<long>(b) * N + qr) * row + h * D + 256 * wg + 2 * t;
#pragma unroll
    for (int jj = 0; jj < 32; ++jj)
      *reinterpret_cast<uint32_t*>(dst + 8 * jj) =
          pack_bf16(o[4 * jj + 2 * r] * inv, o[4 * jj + 2 * r + 1] * inv);
  }
}

static int launch_wide(const void* q, const void* k, const void* v, void* out, int B, int N,
                       int M, int H, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int e = encode_rows_map(&tq, q, B, N, H, kWideD, kWideBQ, true);
  if (e == 0) e = encode_rows_map(&tk, k, B, M, H, kWideD, kWideBK, true);
  if (e == 0) e = encode_rows_map(&tv, v, B, M, H, kWideD, kWideBK, true);
  if (e != 0) return e;
  cudaError_t err = cudaFuncSetAttribute(
      flash_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kWideBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + kWideBQ - 1) / kWideBQ, H, B);
  flash_wide_kernel<<<grid, kWideThreads, kWideBytes, stream>>>(
      tq, tk, tv, static_cast<bf16*>(out), N, M, H, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace skp

// q [B,N,H,D], k/v [B,M,H,D], all bf16 -> out [B,N,H,D] bf16 and, when lse is
// not null, lse [B,H,N] fp32 (log2 domain); keys past M are masked. Returns a
// cudaError_t; -1 for an unsupported head dimension (d 512 writes no lse).
extern "C" int skp_flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                             int B, int N, int M, int H, int D, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 40:
      return skp::launch_attn_fwd<40>(q, k, v, out, lse, B, N, M, H, scale, s);
    case 64:
      return skp::launch_attn_fwd<64>(q, k, v, out, lse, B, N, M, H, scale, s);
    case 80:
      return skp::launch_attn_fwd<80>(q, k, v, out, lse, B, N, M, H, scale, s);
    case 512: return lse ? -1 : skp::launch_wide(q, k, v, out, B, N, M, H, scale, s);
    default: return -1;
  }
}

// Z for the backward's scratch (the keys pass's query split): dkv_part
// must hold 2 * Z * B * M * H * D fp32 values when Z > 1
extern "C" int skp_attn_bwd_splits(int B, int N, int M, int H, int D) {
  return skp::attn_rk_splits(B, N, M, H, D);
}

// (q, k, v, o, dout, lse from skp_flash_fwd) -> dq, dk, dv in the inputs'
// layouts, all bf16; di [B,H,N] fp32 is scratch, as is, with Z =
// skp_attn_bwd_splits(...) > 1, dkv_part (2 Z B M H D fp32). -1 for a head
// dimension other than 40, 64 or 80, or a Z it does not take.
extern "C" int skp_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                             const void* dout, const void* lse, void* di, void* dkv_part, void* dq,
                             void* dk, void* dv, int B, int N, int M, int H, int D, int Z, float scale,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 40:
      return skp::launch_flash_bwd<40>(q, k, v, o, dout, lse, di, dkv_part, dq, dk, dv, B, N, M, H, Z,
                                       scale, s);
    case 64:
      return skp::launch_flash_bwd<64>(q, k, v, o, dout, lse, di, dkv_part, dq, dk, dv, B, N, M, H, Z,
                                       scale, s);
    case 80:
      return skp::launch_flash_bwd<80>(q, k, v, o, dout, lse, di, dkv_part, dq, dk, dv, B, N, M, H, Z,
                                       scale, s);
    default: return -1;
  }
}
