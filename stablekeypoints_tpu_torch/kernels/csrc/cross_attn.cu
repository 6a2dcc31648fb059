// K3: cross-attention over the learned tokens, forward and backward (sm_90a).
//
// Replaces stablekeypoints_tpu/kernels/cross_attn.py cross_attention_resident
// -> _cross_fwd (pallas_call at :152).
//
//   p   = softmax_t(q . k^T * scale)   fp32, columns t >= T masked to -inf
//   out = bf16( bf16(p) . v )          fp32 accumulation
//
// Forward: p must be normalised before it is rounded to bf16 (the TPU
// kernel and the einsum path cast the softmax to v's dtype), so each row
// needs its max and sum over all keys before any p.v. As in the TPU kernel,
// which holds the whole [rows, 512] softmax at once, cross_ws_kernel<D, TP>
// keeps all keys and values of one (b, h) in shared memory (TMA, keys past T
// zero), the key extent TP a compile-time parameter taken from T (80 for the
// guidance's 77 tokens, 256, or 512 for the 500 learned tokens). It is
// persistent and warp-specialized: a grid of one block an SM (two at TP 80
// and d <= 64) splits the (b, h, 64-row tile) sequence into equal contiguous
// ranges; a block loads k and v once per (b, h) it meets (a named barrier
// of the whole block before a reload), and a producer warp streams its
// query tiles through a 4-stage TMA ring (full / empty mbarriers). At TP <=
// 256 each consumer warpgroup owns its own tiles (two a round) over all TP
// keys, with no exchange; at TP 512 the two split a tile's keys and exchange
// row maxima, sums and the partial output through shared memory (three
// named barriers of the 256 consumer threads a tile). The scores are one
// m64nKWk16 wgmma per 16 columns of depth, bf16(p / l) . v one m64nDk16 per
// 16 keys with p from registers; one exponential per score. On the H100 (700
// W, tools/attention_variants.py): [10, 4096, 10, 64] with 500 keys 0.221 ms
// where the one-block-per-256-rows kernel it replaced took 0.290 (SDPA
// 0.160), with 77 keys 0.070 (0.307); SD-1.5's [10, 4096, 8, 40] 0.144
// (0.183; SDPA 0.130); at d 80 [10, 2304, 8, 80] 0.118 (0.155; SDPA 0.099),
// 77 keys [2, 2304, 8, 80] 0.015 (0.055; 0.015). At 500 keys the
// exponentials are 8% of it, and the 168 registers that nine warps leave a
// thread spill 44-76 bytes.
//
// d 160 (SD-1.5's 1280-channel levels at 1536^2 and above: (S / 32)^2
// queries): at the guidance's 77 tokens cross_ws_kernel<160, 80> as it is
// (k and v 51 KB; one block an SM, as q tiles of 20 KB fill the rest). For
// the 500 learned tokens the keys of one (b, h) do not fit beside a query
// tile (2 x 160 KB at 512 padded keys), so attn_fwd_kernel<160, kCross>
// streams them twice through its TMA ring: the row max and sum first, then
// bf16(p / l) . v (the design K3 had before its resident one).
//
// Backward (replaces _cross_bwd, pallas_call at :174): the TPU kernel keeps
// no residual and recomputes the softmax, so attn_fwd_kernel<D, kStats>
// first recomputes each row's log-sum-exp and di = sum_t p * dp (fp32, p
// from the fp32 logits, dp = dO . v^T) in one online pass, and zeroes the
// fp32 dq accumulator; then the single-pass backward of attn_bwd.cuh runs
// (at d 160 each key block's 160 output columns in two halves).
//
// Bound on the H100: the exponentials (N*T*B*H ex2 at 16 per clock per SM;
// twice in the backward: statistics and backward kernel), then the products
// (q.k and p.v; backward 2 in the statistics pass and 5 in the backward
// kernel).
#include "attn_bwd.cuh"
#include "attn_fwd.cuh"

namespace skp {

constexpr int kCrossBQ = 64;  // query rows per tile
constexpr int kCrossWsThreads = 288;  // two consumer warpgroups and a producer warp
constexpr int kCrossWsStages = 4;     // query tiles in the ring

template <int D, int TP>
struct CrossWsCfg {
  static_assert(TP == 80 || TP == 256 || TP == 512, "cross_ws_kernel: key extents 80, 256, 512");
  static constexpr int KSPLIT = TP > 256 ? 2 : 1;   // warpgroups that share a query tile's keys
  static constexpr int KW = TP / KSPLIT;            // keys a warpgroup scores
  static constexpr int KBOX = TP > 256 ? 256 : TP;  // rows of a k or v box
  static constexpr int DP = round_up16(D);          // q.k depth (d 40: zero-padded to 48)
  static constexpr int KPL = TP * 8;                // k and v planes (TMA boxes)
  static constexpr int QPL = kCrossBQ * 8;          // q planes
  static constexpr int QT = DP / 8 * QPL;           // one chunk-major q tile
  static constexpr int MINB = TP <= 80 && D <= 64 ? 2 : 1;  // blocks an SM
  // KSPLIT 2: warpgroup 1's partial output fp32 [BQ][D], row max and sum [2][BQ]
  static constexpr size_t xbytes = KSPLIT == 2 ? sizeof(float) * (kCrossBQ * D + 4 * kCrossBQ) : 0;
  // k, v; q [stage]; the exchange; mbarriers: k and v, q full / empty [stage]
  static constexpr size_t bytes = sizeof(bf16) * ((DP / 8 + D / 8) * KPL + kCrossWsStages * QT) +
                                  xbytes + sizeof(uint64_t) * (1 + 2 * kCrossWsStages);
};

// s = a . k^T over N keys (q and k K-major from shared memory)
template <int N>
__device__ __forceinline__ void wgmma_scores(float (&d)[N / 2], uint64_t a_desc, uint64_t b_desc,
                                             int accumulate) {
  static_assert(N == 80 || N == 256, "wgmma_scores: no product shape for N");
  if constexpr (N == 80) wgmma_m64n80k16_ss(d, a_desc, b_desc, accumulate);
  else wgmma_m64n256k16_ss(d, a_desc, b_desc, accumulate);
}

// q [B,N,H,D], k/v [B,T,H,D] (T <= TP) -> out [B,N,H,D]; BH = B * H
template <int D, int TP>
__global__ void __launch_bounds__(kCrossWsThreads, CrossWsCfg<D, TP>::MINB)
    cross_ws_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out, int N, int T,
                    int H, int BH, float c) {
  using C = CrossWsCfg<D, TP>;
  constexpr int BQ = kCrossBQ, S = kCrossWsStages, DP = C::DP, KS = DP / 16, KW = C::KW;
  constexpr int KPL = C::KPL, QPL = C::QPL, TPR = 2 / C::KSPLIT;  // query tiles a round
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // chunk-major [TP][DP]
  bf16* Vs = Ks + DP / 8 * KPL;              // chunk-major [TP][D]
  bf16* Qs = Vs + D / 8 * KPL;               // [stage] chunk-major [BQ][DP]
  float* Ox = reinterpret_cast<float*>(Qs + S * C::QT);  // KSPLIT 2: [BQ][D]
  float* Red = Ox + BQ * D;                              // [2][BQ] row max
  float* Sum = Red + 2 * BQ;                             // [2][BQ] row sum
  uint64_t* kv_full =
      reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(Qs + S * C::QT) + C::xbytes);
  uint64_t* q_full = kv_full + 1;  // [stage]
  uint64_t* q_empty = q_full + S;  // [stage]

  const int tid = threadIdx.x, lane = tid % 32;
  const int tpb = (N + BQ - 1) / BQ;  // query tiles a (b, h)
  const long total = static_cast<long>(BH) * tpb;
  const long lo = blockIdx.x * total / gridDim.x, hi = (blockIdx.x + 1) * total / gridDim.x;
  // d 40: the q.k padding columns 40..47, which no copy writes
  zero_chunks<TP, KPL>(Ks, D / 8, DP / 8, tid, kCrossWsThreads);
  for (int st = 0; st < S; ++st) zero_chunks<BQ, QPL>(Qs + st * C::QT, D / 8, DP / 8, tid, kCrossWsThreads);
  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < S; ++st) {
      mbar_init(&q_full[st], 1);
      mbar_init(&q_empty[st], 4 * C::KSPLIT);  // each consumer warp of the tile
    }
    mbar_fence_init();
  }
  fence_proxy_async();  // the padding zeros, read by wgmma
  __syncthreads();

  const bool producer = tid >= 256;
  const int wg = tid / 128, warp = (tid / 32) % 4, g = lane >> 2, t = lane & 3;
  const int kw = C::KSPLIT == 2 ? KW * wg : 0;   // this warpgroup's keys of a tile
  const int rr[2] = {16 * warp + g, 16 * warp + g + 8};  // this thread's rows of a tile
  int i = 0;  // query tiles of this block before the current round
  for (long tile = lo, e = 0; tile < hi; ++e) {
    const int bh = static_cast<int>(tile / tpb), b = bh / H, h = bh % H;
    const long s1 = hi < static_cast<long>(bh + 1) * tpb ? hi : static_cast<long>(bh + 1) * tpb;
    if (e > 0) {  // every consumer is done with the last (b, h)'s k and v
      __syncwarp();
      named_bar_sync(3, kCrossWsThreads);
    }
    if (producer) {
      if (lane == 0) {  // k and v of (b, h) (keys past T arrive as zeros), then its query tiles
        mbar_expect_tx(kv_full, 2 * (D / 8) * TP * 16);
        for (int ch = 0; ch < D / 8; ++ch)
          for (int r0 = 0; r0 < TP; r0 += C::KBOX) {
            tma_load_4d(Ks + ch * KPL + r0 * 8, &tk, 8 * ch, h, r0, b, kv_full);
            tma_load_4d(Vs + ch * KPL + r0 * 8, &tv, 8 * ch, h, r0, b, kv_full);
          }
        for (long u = tile; u < s1; ++u) {
          const int slot = i + static_cast<int>(u - tile), st = slot % S;
          if (slot >= S) mbar_wait(&q_empty[st], (slot / S - 1) & 1);  // tile slot - S read
          mbar_expect_tx(&q_full[st], (D / 8) * BQ * 16);
          const int q0 = static_cast<int>(u - static_cast<long>(bh) * tpb) * BQ;
          for (int ch = 0; ch < D / 8; ++ch)
            tma_load_4d(Qs + st * C::QT + ch * QPL, &tq, 8 * ch, h, q0, b, &q_full[st]);
        }
      }
      i += static_cast<int>(s1 - tile);
      tile = s1;
      continue;
    }
    mbar_wait(kv_full, e & 1);
    for (long t0 = tile; t0 < s1; i += static_cast<int>(s1 - t0 < TPR ? s1 - t0 : TPR), t0 += TPR) {
      const int u = C::KSPLIT == 1 ? wg : 0;  // this warpgroup's tile of the round
      if (t0 + u >= s1) continue;
      const int slot = i + u, st = slot % S;
      const int q0 = static_cast<int>(t0 + u - static_cast<long>(bh) * tpb) * BQ;
      mbar_wait(&q_full[st], (slot / S) & 1);
      const bf16* qt = Qs + st * C::QT;

      float s[KW / 2];  // this warpgroup's KW keys
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        wgmma_scores<KW>(s, desc_kmajor<QPL>(qt, 0, 2 * ks), desc_kmajor<KPL>(Ks, kw, 2 * ks),
                         ks > 0);
      wgmma_commit();
      wgmma_wait0();
      reg_fence(s);
      __syncwarp();
      if (lane == 0) mbar_arrive(&q_empty[st]);  // this warp is done with the query tile
      if (kw + KW > T) {
#pragma unroll
        for (int j = 0; j < KW / 8; ++j)
#pragma unroll
          for (int e2 = 0; e2 < 4; ++e2)
            if (kw + 8 * j + 2 * t + (e2 & 1) >= T) s[4 * j + e2] = -CUDART_INF_F;
      }
      // row maxima and sums as four interleaved partials (short dependent chains)
      float mc[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx[4] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
        for (int j = 0; j < KW / 8; ++j)
          mx[j % 4] = fmaxf(mx[j % 4], fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
        // finite: every warpgroup's keys start below T
        mc[r] = quad_max(fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3])));
        if (C::KSPLIT == 2 && t == 0) Red[wg * BQ + rr[r]] = mc[r];
      }
      if constexpr (C::KSPLIT == 2) {
        named_bar_sync(1, 256);  // both warpgroups' row maxima
#pragma unroll
        for (int r = 0; r < 2; ++r) mc[r] = fmaxf(Red[rr[r]], Red[BQ + rr[r]]);
      }
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m = mc[r] * c;
        float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < KW / 8; ++j)
#pragma unroll
          for (int e2 = 2 * r; e2 < 2 * r + 2; ++e2) {
            s[4 * j + e2] = fast_exp2(fmaf(s[4 * j + e2], c, -m));
            sum[j % 4] += s[4 * j + e2];
          }
        inv[r] = quad_sum((sum[0] + sum[1]) + (sum[2] + sum[3]));
        if (C::KSPLIT == 2 && t == 0) Sum[wg * BQ + rr[r]] = inv[r];
      }
      if constexpr (C::KSPLIT == 2) {
        named_bar_sync(1, 256);  // both warpgroups' row sums
#pragma unroll
        for (int r = 0; r < 2; ++r) inv[r] = Sum[rr[r]] + Sum[BQ + rr[r]];
      }
      inv[0] = 1.0f / inv[0];
      inv[1] = 1.0f / inv[1];
      // bf16(p / l), as the TPU kernel rounds, times this warpgroup's values
      uint32_t pf[KW / 16][4];
#pragma unroll
      for (int kk = 0; kk < KW / 16; ++kk)
#pragma unroll
        for (int q4 = 0; q4 < 4; ++q4) {
          const int e0 = 8 * kk + 2 * q4, r = q4 & 1;
          pf[kk][q4] = pack_bf16(s[e0] * inv[r], s[e0 + 1] * inv[r]);
        }
      float o[D / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KW / 16; ++kk)
        wgmma_pv<D>(o, pf[kk], desc_mnmajor<KPL>(Vs, kw + 16 * kk, 0), kk > 0);
      wgmma_commit();
      wgmma_wait0();
      reg_fence(o);
      frag_fence(pf);
      if constexpr (C::KSPLIT == 2) {  // warpgroup 1's partial output into warpgroup 0's
        if (wg == 1) {
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int j = 0; j < D / 8; ++j)
              *reinterpret_cast<float2*>(Ox + rr[r] * D + 8 * j + 2 * t) =
                  make_float2(o[4 * j + 2 * r], o[4 * j + 2 * r + 1]);
        }
        named_bar_sync(1, 256);
        if (wg == 1) continue;
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            const float2 x = *reinterpret_cast<const float2*>(Ox + rr[r] * D + 8 * j + 2 * t);
            o[4 * j + 2 * r] += x.x;
            o[4 * j + 2 * r + 1] += x.y;
          }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qr = q0 + rr[r];
        if (qr >= N) continue;
        bf16* dst = out + (static_cast<long>(b) * N + qr) * H * D + h * D + 2 * t;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<uint32_t*>(dst + 8 * j) = pack_bf16(o[4 * j + 2 * r], o[4 * j + 2 * r + 1]);
      }
    }
    tile = s1;
  }
}

template <int D, int TP>
static int launch_cross_ws(const void* q, const void* k, const void* v, void* out, int B, int N,
                           int T, int H, float scale, cudaStream_t stream) {
  using C = CrossWsCfg<D, TP>;
  CUtensorMap tq, tk, tv;
  int e = encode_rows_map(&tq, q, B, N, H, D, kCrossBQ);
  if (e == 0) e = encode_rows_map(&tk, k, B, T, H, D, C::KBOX);
  if (e == 0) e = encode_rows_map(&tv, v, B, T, H, D, C::KBOX);
  if (e != 0) return e;
  int dev = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(cross_ws_kernel<D, TP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)C::bytes)) != cudaSuccess)
    return (int)err;
  const long total = static_cast<long>(B) * H * ((N + kCrossBQ - 1) / kCrossBQ);
  const int grid = static_cast<int>(total < static_cast<long>(sms) * C::MINB ? total : sms * C::MINB);
  cross_ws_kernel<D, TP><<<grid, kCrossWsThreads, C::bytes, stream>>>(
      tq, tk, tv, static_cast<bf16*>(out), N, T, H, B * H, scale * kLog2e);
  return (int)cudaGetLastError();
}

template <int D>
static int launch_cross_bwd(const void* q, const void* k, const void* v, const void* dout,
                            void* lse2, void* di, void* dq_acc, void* dkv_part, void* dq, void* dk,
                            void* dv, int B, int N, int T, int H, int Z, float scale,
                            cudaStream_t stream) {
  if (!bwd_splits_ok(D, Z, dkv_part)) return -1;
  const int err = launch_attn_fwd<D, kStats>(q, k, v, dout, nullptr, lse2, di, dq_acc, B, N, T,
                                             H, scale, stream);
  if (err != 0) return err;
  return launch_attn_bwd<D>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                            static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
                            static_cast<const float*>(lse2), static_cast<const float*>(di),
                            static_cast<float*>(dq_acc), static_cast<float*>(dkv_part),
                            static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                            B, N, T, H, Z, scale, stream);
}

}  // namespace skp

// q [B,N,H,D], k/v [B,T,H,D] (T <= 512), all bf16 -> out [B,N,H,D] bf16.
// Returns a cudaError_t; -1 for an unsupported head dimension.
extern "C" int skp_cross_fwd(const void* q, const void* k, const void* v, void* out, int B,
                             int N, int T, int H, int D, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 40:  // the persistent kernel, its key extent from T
      if (T <= 80) return skp::launch_cross_ws<40, 80>(q, k, v, out, B, N, T, H, scale, s);
      if (T <= 256) return skp::launch_cross_ws<40, 256>(q, k, v, out, B, N, T, H, scale, s);
      return skp::launch_cross_ws<40, 512>(q, k, v, out, B, N, T, H, scale, s);
    case 64:
      if (T <= 80) return skp::launch_cross_ws<64, 80>(q, k, v, out, B, N, T, H, scale, s);
      if (T <= 256) return skp::launch_cross_ws<64, 256>(q, k, v, out, B, N, T, H, scale, s);
      return skp::launch_cross_ws<64, 512>(q, k, v, out, B, N, T, H, scale, s);
    case 80:
      if (T <= 80) return skp::launch_cross_ws<80, 80>(q, k, v, out, B, N, T, H, scale, s);
      if (T <= 256) return skp::launch_cross_ws<80, 256>(q, k, v, out, B, N, T, H, scale, s);
      return skp::launch_cross_ws<80, 512>(q, k, v, out, B, N, T, H, scale, s);
    case 160:  // resident k and v at the guidance's tokens, else two passes over the keys
      if (T <= 80) return skp::launch_cross_ws<160, 80>(q, k, v, out, B, N, T, H, scale, s);
      return skp::launch_attn_fwd<160, skp::kCross>(q, k, v, nullptr, out, nullptr, nullptr,
                                                    nullptr, B, N, T, H, scale, s);
    default: return -1;
  }
}

// (q, k, v, dout) -> dq, dk, dv in the inputs' layouts, all bf16; lse2 and
// di [B,H,N] and dq_acc [B,H,N,D] fp32 are scratch, and with
// Z = skp_attn_bwd_splits(...) > 1 dkv_part (2 Z B T H D fp32). -1 for an
// unsupported head dimension or a Z it does not take.
extern "C" int skp_cross_bwd(const void* q, const void* k, const void* v, const void* dout,
                             void* lse2, void* di, void* dq_acc, void* dkv_part, void* dq, void* dk,
                             void* dv, int B, int N, int T, int H, int D, int Z, float scale,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 40:
      return skp::launch_cross_bwd<40>(q, k, v, dout, lse2, di, dq_acc, dkv_part, dq, dk, dv, B, N,
                                       T, H, Z, scale, s);
    case 64:
      return skp::launch_cross_bwd<64>(q, k, v, dout, lse2, di, dq_acc, dkv_part, dq, dk, dv, B, N,
                                       T, H, Z, scale, s);
    case 80:
      return skp::launch_cross_bwd<80>(q, k, v, dout, lse2, di, dq_acc, dkv_part, dq, dk, dv, B, N,
                                       T, H, Z, scale, s);
    case 160:
      return skp::launch_cross_bwd<160>(q, k, v, dout, lse2, di, dq_acc, dkv_part, dq, dk, dv, B,
                                        N, T, H, Z, scale, s);
    default: return -1;
  }
}
