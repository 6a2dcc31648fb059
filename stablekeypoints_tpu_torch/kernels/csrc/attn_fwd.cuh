// Attention forward kernel of K4/K5 (flash.cu) and K3's backward statistics
// (cross_attn.cu), sm_90a. Replaces the forward of JAX's stock Pallas TPU
// flash attention that stablekeypoints_tpu/kernels/flash.py calls
// (flash_self_attention :126, flash_cross_attention :187), and the row
// statistics that stablekeypoints_tpu/kernels/cross_attn.py's backward
// (_cross_bwd, pallas_call at :174) recomputes.
//
// One template, two modes over the same tile walk:
//   kFlash      K4/K5: online softmax (running max, rescaled sum and output),
//               out = bf16(sum_t bf16(p_t) v_t / l); optional lse output.
//   kStats      K3 backward statistics: one pass gives lse and
//               di = sum_t p * dp (fp32, dp = dO . v^T) with the same online
//               rescaling, and zeroes the fp32 dq accumulator rows that the
//               backward kernel (attn_bwd.cuh) adds into.
//
// A block holds two or four warpgroups of 64 query rows of one (b, h).
// Keys and values stream in 64-key chunk-major tiles (common.cuh) through a
// ring of four stages, two tiles ahead: one thread starts the TMA copies of
// a tile (one box per 8-column chunk; rows past M arrive as zeros) on the
// stage's mbarrier, so the other threads spend no instruction on copies and
// no proxy fence. Every warpgroup reads each tile, so k and v cross L2 once
// per block. Products are wgmma: s = q . k^T is m64n64k16 with q and k read
// from shared memory (d 40 zero-padded to 48), o += p . v is m64nDk16 with
// p converted in registers from the score accumulators to bf16 A fragments
// (FlashAttention-3's layout identity) and v read MN-major (transpose bit),
// so neither operand is transposed in memory. kFlash issues tile j+1's
// q . k^T with tile j's p . v and runs tile j+1's softmax while p . v is on
// the tensor cores (FlashAttention-3's intra-warpgroup overlap). Each score
// costs one FFMA (s * c - m * c, the scale folded into the exponent), one
// ex2.approx, one max and one add; only the tail tile (500 keys: K5, K3) is
// masked (K5: 500 keys).
//
// What bounds it on the H100: by count, the exponentials at d 40 (one MUFU
// ex2 per score, 16 per clock per SM: N*M*B*H / 16 / 132 / 1.98 GHz =
// 0.32 ms for K4's [10,4096,8,40], over the 0.22 ms of its products at the
// bf16 peak), the products at d 80. Measured on an H100 (700 W,
// tools/attention_variants.py) at d 40, no single part dominates: without the softmax, or without the
// exponentials, it runs as fast; without the k/v copies 11% faster; the
// rest is the chain of dependent steps per tile (barrier, q.k, softmax,
// p.v) under 8 warps an SM. A version whose threads copied k and v with
// cp.async lost about a quarter of its time to the copies, hence TMA; a
// deeper ring or a 128-key tile did not help.
#pragma once

#include "common.cuh"

namespace skp {

enum AttnFwdMode { kFlash = 0, kStats = 1 };

constexpr int kFwdBK = 64;  // keys per tile

template <int D, int MODE>
struct FwdCfg {
  static constexpr int DP = round_up16(D);  // q.k depth, padded
  static constexpr int KS = DP / 16;
  // warpgroups of 64 query rows per block (tools/attention_variants.py):
  // four at d 64 and 80, so that k and v cross L2 once per 256 rows (at d 64
  // with two, the copies and not the exponentials bound K4: 3.81 ms, 2.31
  // without the k/v copies, 2.81 with four, for [10, 9216, 5, 64] on an
  // H100); two at d 40, with two blocks per SM, as the softmax there costs
  // more than the copies
  static constexpr int WGS = D <= 40 ? 2 : 4;
  static constexpr int BQ = 64 * WGS;  // query rows per block
  // tiles st - 1 (p.v), st (scores) and STAGES - 2 loading
  static constexpr int STAGES = 4;
  static constexpr int QTILE = DP / 8 * plane_ld(BQ);  // chunk-major q (and dO)
  static constexpr int KPL = kFwdBK * 8;               // k and v planes, as TMA writes them
  static constexpr int TILE = DP / 8 * KPL;            // one chunk-major k or v tile
  static constexpr int NQ = MODE == kStats ? 2 : 1;
  // k, v [stage]; q (and dO); one mbarrier per stage
  static constexpr size_t bytes =
      sizeof(bf16) * (STAGES * 2 * TILE + NQ * QTILE) + sizeof(uint64_t) * STAGES;
  static constexpr int min_blocks = WGS == 4 || MODE == kStats ? 1 : 2;
};

// q, dout [B,N,H,D]; k, v [B,M,H,D] -> (kFlash) out [B,N,H,D] and,
// when lse is not null, lse [B,H,N] (log2 domain); (kStats) lse, di [B,H,N]
// and dq_acc [B,H,N,D] set to 0
template <int D, int MODE>
__global__ void __launch_bounds__(FwdCfg<D, MODE>::WGS * 128, FwdCfg<D, MODE>::min_blocks)
    attn_fwd_kernel(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                    const bf16* __restrict__ q, const bf16* __restrict__ dout,
                    bf16* __restrict__ out, float* __restrict__ lse, float* __restrict__ di,
                    float* __restrict__ dq_acc, int N, int M, int H, float c) {
  using C = FwdCfg<D, MODE>;
  constexpr int DP = C::DP, KS = C::KS, BQ = C::BQ, BK = kFwdBK, NT = C::WGS * 128;
  constexpr int VCH = (MODE == kStats ? DP : D) / 8;  // v as K-major (dp) or MN-major (p.v)
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* KV = reinterpret_cast<bf16*>(smem);   // [stage][k, v] chunk-major
  bf16* Qs = KV + C::STAGES * 2 * C::TILE;    // chunk-major [BQ][DP]
  bf16* Os = Qs + C::QTILE;                   // the same, dO (kStats)
  uint64_t* full = reinterpret_cast<uint64_t*>(Qs + C::NQ * C::QTILE);  // [stage]

  const int tid = threadIdx.x, warp = (tid / 32) % 4, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int wg0 = (tid / 128) * 64;  // this warpgroup's first row in the block
  const int r0 = wg0 + warp * 16;    // and this warp's
  const long row = static_cast<long>(H) * D;
  const int tiles = (M + BK - 1) / BK;

  auto kt = [&](int st) { return KV + (st % C::STAGES) * 2 * C::TILE; };
  auto vt = [&](int st) { return kt(st) + C::TILE; };
  for (int st = 0; st < C::STAGES; ++st) {  // d 40: the q.k padding columns 40..47
    zero_chunks<BK, C::KPL>(kt(st), D / 8, DP / 8, tid, NT);
    if constexpr (MODE == kStats) zero_chunks<BK, C::KPL>(vt(st), D / 8, VCH, tid, NT);
  }
  // one thread starts the TMA copies of tile st's D / 8 column chunks of k
  // and v (rows past M arrive as zeros)
  auto issue = [&](int st) {
    if (tid != 0) return;
    const int stage = st % C::STAGES;
    mbar_expect_tx(&full[stage], 2 * (D / 8) * BK * 16);
    for (int ch = 0; ch < D / 8; ++ch) {
      tma_load_4d(kt(st) + ch * C::KPL, &tk, 8 * ch, h, st * BK, b, &full[stage]);
      tma_load_4d(vt(st) + ch * C::KPL, &tv, 8 * ch, h, st * BK, b, &full[stage]);
    }
  };
  // start copying tile st + kAhead into the stage that tile st - 2 held
  // (every warp is past it: the barrier; its p.v is done), then wait for
  // tile st
  constexpr int kAhead = C::STAGES - 2;
  auto advance = [&](int st) {
    __syncthreads();
    if (st + kAhead < tiles) issue(st + kAhead);
    mbar_wait(&full[st % C::STAGES], (st / C::STAGES) & 1);
  };

  const long q_off = (static_cast<long>(b) * N + q0) * row + h * D;
  const int valid_q = min(BQ, N - q0);
  load_chunked_async<DP / 8, BQ>(Qs, q + q_off, row, valid_q, D, tid, NT);
  if constexpr (MODE == kStats)
    load_chunked_async<DP / 8, BQ>(Os, dout + q_off, row, valid_q, D, tid, NT);
  cp_async_commit();
  if (tid == 0) {
    for (int st = 0; st < C::STAGES; ++st) mbar_init(&full[st], 1);
    mbar_fence_init();
  }
  __syncthreads();
  for (int st = 0; st < kAhead && st < tiles; ++st) issue(st);
  cp_async_wait_all();  // q (and dO), read by wgmma
  fence_proxy_async();
  advance(0);

  // s = a . k^T for the tile of step st, a this warpgroup's rows of q (or dO)
  // (asynchronous; the caller commits)
  auto scores = [&](float (&s)[BK / 2], const bf16* a, const bf16* tile) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      wgmma_m64n64k16_ss(s, desc_kmajor<plane_ld(BQ)>(a, wg0, 2 * ks), desc_kmajor<C::KPL>(tile, 0, 2 * ks),
                         ks > 0);
  };
  // columns past M are -inf (only the last tile can have any)
  auto mask_tail = [&](float (&s)[BK / 2], int st) {
    const int k0 = st * BK;
    if (k0 + BK <= M) return;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k0 + 8 * j + 2 * t + (e & 1) >= M) s[4 * j + e] = -CUDART_INF_F;
  };
  // row max of a tile folded into m (raw logits: the scale c > 0 comes later);
  // returns the rescale factor of what was summed before
  auto new_max = [&](const float (&s)[BK / 2], float (&m)[2], float (&alpha)[2]) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
      const float m_new = fmaxf(m[r], quad_max(mx));  // finite: every tile has a valid key
      alpha[r] = fast_exp2((m[r] - m_new) * c);       // 0 on the first tile
      m[r] = m_new;
    }
  };

  float m_r[2] = {-CUDART_INF_F, -CUDART_INF_F}, l_r[2] = {0.f, 0.f};
  float s[BK / 2];

  if constexpr (MODE == kStats) {
    float acc[2] = {0.f, 0.f};
    for (int st = 0; st < tiles; ++st) {
      if (st > 0) advance(st);
      float dp[BK / 2];
      wgmma_fence();
      scores(s, Qs, kt(st));
      scores(dp, Os, vt(st));  // dp = dO . v^T
      wgmma_commit();
      wgmma_wait0();
      reg_fence(s);
      reg_fence(dp);
      mask_tail(s, st);
      float alpha[2];
      new_max(s, m_r, alpha);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mc = m_r[r] * c;
        float sum = 0.f, pdp = 0.f;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            const float p = fast_exp2(fmaf(s[4 * j + e], c, -mc));
            sum += p;
            pdp = fmaf(p, dp[4 * j + e], pdp);
          }
        l_r[r] = fmaf(l_r[r], alpha[r], sum);
        acc[r] = fmaf(acc[r], alpha[r], pdp);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float l = quad_sum(l_r[r]), a = quad_sum(acc[r]);
      const int qr = q0 + r0 + g + 8 * r;
      if (qr < N && t == 0) {
        const long idx = (static_cast<long>(b) * H + h) * N + qr;
        lse[idx] = m_r[r] * c + log2f(l);
        di[idx] = a / l;
      }
    }
    float4* z = reinterpret_cast<float4*>(dq_acc + ((static_cast<long>(b) * H + h) * N + q0) * D);
    for (int i = tid; i < valid_q * D / 4; i += NT) z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }

  // kFlash. p of a tile into s with the running max updated; alpha rescales
  // the earlier sum and output
  auto softmax = [&](float (&sc)[BK / 2], int st, float (&alpha)[2]) {
    mask_tail(sc, st);
    new_max(sc, m_r, alpha);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mc = m_r[r] * c;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          sc[4 * j + e] = fast_exp2(fmaf(sc[4 * j + e], c, -mc));
          sum += sc[4 * j + e];
        }
      l_r[r] = fmaf(l_r[r], alpha[r], sum);
    }
  };
  uint32_t pf[BK / 16][4];
  auto pack = [&](const float (&sc)[BK / 2]) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) pf[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
  };
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  auto pv = [&](const bf16* tile) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_pv<D>(o, pf[kk], desc_mnmajor<C::KPL>(tile, 16 * kk, 0), 1);
  };

  float alpha[2];
  wgmma_fence();
  scores(s, Qs, kt(0));
  wgmma_commit();
  wgmma_wait0();
  reg_fence(s);
  softmax(s, 0, alpha);  // o is 0: nothing to rescale
  pack(s);
  for (int st = 1; st < tiles; ++st) {
    advance(st);
    wgmma_fence();
    scores(s, Qs, kt(st));  // tile st's scores ...
    wgmma_commit();
    pv(vt(st - 1));  // ... and tile st - 1's p.v, both in flight
    wgmma_commit();
    wgmma_wait1();
    reg_fence(s);
    softmax(s, st, alpha);  // the exponentials overlap p.v
    wgmma_wait0();
    reg_fence(o);
    frag_fence(pf);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }
    pack(s);
  }
  wgmma_fence();
  pv(vt(tiles - 1));
  wgmma_commit();
  wgmma_wait0();
  reg_fence(o);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qr = q0 + r0 + g + 8 * r;
    const float l = quad_sum(l_r[r]);  // every lane of the warp takes part
    if (qr >= N) continue;
    if (lse != nullptr && t == 0) lse[(static_cast<long>(b) * H + h) * N + qr] = m_r[r] * c + log2f(l);
    const float inv = 1.0f / l;
    bf16* dst = out + (static_cast<long>(b) * N + qr) * row + h * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
  }
}

template <int D, int MODE>
static int launch_attn_fwd(const void* q, const void* k, const void* v, const void* dout,
                           void* out, void* lse, void* di, void* dq_acc, int B, int N, int M,
                           int H, float scale, cudaStream_t stream) {
  using C = FwdCfg<D, MODE>;
  CUtensorMap tk, tv;
  int e = encode_rows_map(&tk, k, B, M, H, D, kFwdBK);
  if (e == 0) e = encode_rows_map(&tv, v, B, M, H, D, kFwdBK);
  if (e != 0) return e;
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_kernel<D, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + C::BQ - 1) / C::BQ, H, B);
  attn_fwd_kernel<D, MODE><<<grid, C::WGS * 128, C::bytes, stream>>>(
      tk, tv, static_cast<const bf16*>(q), static_cast<const bf16*>(dout), static_cast<bf16*>(out), static_cast<float*>(lse),
      static_cast<float*>(di), static_cast<float*>(dq_acc), N, M, H, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace skp
