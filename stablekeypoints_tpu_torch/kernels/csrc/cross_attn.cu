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
// the 500 learned tokens the keys and values of one (b, h) (2 x 160 KB at
// 512 padded keys) do not fit beside a query tile, so cross_pair_kernel
// splits them over a cluster of two blocks, each holding k and v of 256
// keys, and scores each key once: a query tile's two blocks exchange each
// row's (max, sum) and then halves of their fp32 partial outputs through
// each other's shared memory (distributed shared memory, one remote
// mbarrier arrival per warp and exchange), and each writes half the output
// columns. k, v and q tiles are split in layout: columns 0-127 in the
// 128-byte swizzle, 128-159 chunk-major (a third of the copy requests of an
// all chunk-major tile, in the same bytes). On the H100 (700 W,
// tools/attention_variants.py --d160) at [2, 2304, 8, 160]: 0.058 ms, where
// the two passes over streamed keys it replaced took 0.104 (SDPA 0.042);
// one block with k resident and v streamed in 32-key tiles (the other
// design tried) took 0.107, its 16-byte copy boxes and the chain of v tile
// waits setting the pace; the cluster with all chunk-major tiles and two
// exchanges (max, then sum) 0.077.
//
// Backward (replaces _cross_bwd, pallas_call at :174): the TPU kernel keeps
// no residual and recomputes the softmax. It is query-major as the TPU
// kernel, in attn_bwd.cuh's two passes with no reduce-adds
// (attn_rows_kernel, attn_keys_kernel): the rows pass recomputes each
// row's log-sum-exp and di = sum_t p * dp and writes dq whole, the keys
// pass writes dk and dv with the keys as the rows of its products (query
// tiles split Z ways where SMs would idle, the fp32 partials summed in
// order), so dq, dk and dv are bitwise reproducible. On the H100 (700 W):
// [2, 2304, 8, 160] 0.184 ms (rows 0.111, keys 0.086), where the
// statistics pass and a single pass with dq reduce-adds in two column
// halves took 0.363 (SDPA 0.183); d 40 [8, 4096, 8, 40] 0.370 against that
// design's 0.469 (SDPA 0.280). At d 64 (attn_bwd.cuh's source note) the
// rows pass's statistics sweep alone, then the keys-major pass
// (attn_kq_kernel): 7 products a score where the two passes run 9; [4,
// 4096, 10, 64] 0.350 ms against 0.357.
//
// d 64 forward at 500 keys: two forms were tried against the key split
// above and dropped (tools/attention_variants.py, PERF.md): a producer
// warpgroup that gives its registers to the consumers (setmaxnreg 40 /
// 232) left ptxas's allocation at 168 registers and 68 bytes of spill, and
// no faster (0.2200 against 0.2183 ms at [10, 4096, 10, 64]); each
// warpgroup on its own tiles over all 512 keys in two sweeps of 128-key
// chunks (row max and sum, then p . v; no exchange, 141 registers, no
// spill) took 0.2397 against 0.2219, 0.2574 with the chunks' products
// overlapped.
//
// Bound on the H100: the exponentials (N*T*B*H ex2 at 16 per clock per SM;
// three times in the backward: the rows pass's two sweeps and the keys
// pass), then the products (q.k and p.v; backward 9: s and dp in each
// sweep and in the keys pass, dq, dk, dv).
#include "attn_bwd.cuh"

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

// ---------------------------------------------------------------------------
// d 160 above 80 keys: a cluster of two blocks, each holding k and v of 256
// keys (source note). Every [rows][160] tile is two parts of one shared
// layout: columns 0-127 as two 64-column blocks in the 128-byte swizzle
// (TMA boxes of 128-byte rows), columns 128-159 chunk-major (boxes of
// 16-byte rows), so the copies take a third of the requests of an all
// chunk-major tile in the same bytes.

constexpr int kPairKH = 256;  // keys a block holds

template <int R>
struct SplitTile {  // a [R][160] bf16 tile: [2][R][64] swizzled, then [4][R][8]
  static constexpr int A = 2 * R * 64;   // elements of the swizzled part
  static constexpr int PL = R * 8;       // planes of the chunk-major part
  static constexpr int SIZE = A + 4 * PL;
};

template <int D>
struct PairCfg {
  static_assert(D == 160, "cross_pair_kernel: the split layout is 128 + 32 columns");
  using KT = SplitTile<kPairKH>;
  using QT = SplitTile<kCrossBQ>;
  static_assert(sizeof(float) * kCrossBQ * D / 2 == sizeof(bf16) * QT::SIZE,
                "a query slot holds half a partial output");
  // k, v; q [warpgroup]; the other block's row maxima and sums [warpgroup]
  // [parity][BQ] (float2); mbarriers: k and v, q full / empty [warpgroup],
  // the other block's statistics and partial output [warpgroup]
  static constexpr size_t bytes = sizeof(bf16) * (2 * KT::SIZE + 2 * QT::SIZE) +
                                  sizeof(float) * 2 * 2 * 2 * kCrossBQ + sizeof(uint64_t) * 9;
};

// the copies of a [R][160] split tile's rows r0 .. of head h, image b, into
// `dst` (rows past the tensor zero); `ma` maps 64-column boxes (128-byte
// swizzle), `mb` 8-column ones
template <int R>
__device__ __forceinline__ void load_split(bf16* dst, const CUtensorMap* ma, const CUtensorMap* mb,
                                           int h, int r0, int b, uint64_t* bar) {
  using S = SplitTile<R>;
  mbar_expect_tx(bar, S::SIZE * 2);
  for (int cb = 0; cb < 2; ++cb) tma_load_4d(dst + cb * R * 64, ma, 64 * cb, h, r0, b, bar);
  for (int ch = 0; ch < 4; ++ch) tma_load_4d(dst + S::A + ch * S::PL, mb, 128 + 8 * ch, h, r0, b, bar);
}

// q [B,N,H,D], k/v [B,T,H,D] (80 < T <= 512) -> out [B,N,H,D]; BH = B * H.
// A cluster of two blocks; block r holds keys 256 r .. 256 r + 255 of a (b,
// h). Persistent: cluster i walks the (b, h, 64-row tile) range [lo, hi) in
// rounds of two tiles of one (b, h), warpgroup w of both blocks taking the
// round's tile w. Each warpgroup scores its block's keys; the two blocks'
// warpgroups w exchange each row's local max and sum, then halves of their
// partial outputs, by storing into each other's shared memory and arriving
// on each other's mbarriers. k and v are reloaded at a (b, h) boundary once
// both warpgroups are past it (a named barrier).
template <int D>
__global__ void __launch_bounds__(256, 1)
    cross_pair_kernel(const __grid_constant__ CUtensorMap tqa, const __grid_constant__ CUtensorMap tqb,
                      const __grid_constant__ CUtensorMap tka, const __grid_constant__ CUtensorMap tkb,
                      const __grid_constant__ CUtensorMap tva, const __grid_constant__ CUtensorMap tvb,
                      bf16* __restrict__ out, int N, int T, int H, int BH, float c) {
  using C = PairCfg<D>;
  using KT = typename C::KT;
  using QT = typename C::QT;
  constexpr int BQ = kCrossBQ, KS = D / 16, KH = kPairKH;
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // split [256][160]
  bf16* Vs = Ks + KT::SIZE;
  bf16* Qs = Vs + KT::SIZE;                  // [warpgroup] split [BQ][160]
  float2* StatIn = reinterpret_cast<float2*>(Qs + 2 * QT::SIZE);  // [warpgroup][parity][BQ]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(StatIn + 2 * 2 * BQ);
  uint64_t* q_full = kv_full + 1;   // [warpgroup]
  uint64_t* q_empty = q_full + 2;   // [warpgroup]
  uint64_t* x_stat = q_empty + 2;   // [warpgroup]
  uint64_t* x_out = x_stat + 2;     // [warpgroup]

  const int tid = threadIdx.x, wg = tid / 128, wt = tid % 128, lane = tid % 32;
  const int warp = wt / 32, g = lane >> 2, t = lane & 3;
  const int rank = cluster_rank(), peer = 1 - rank;
  const int tpb = (N + BQ - 1) / BQ;  // query tiles a (b, h)
  const long total = static_cast<long>(BH) * tpb;
  const long nc = gridDim.x / 2, ci = blockIdx.x / 2;
  const long lo = ci * total / nc, hi = (ci + 1) * total / nc;
  auto seg_end = [&](long tile) {
    const long e = (tile / tpb + 1) * tpb;
    return e < hi ? e : hi;
  };
  // this warpgroup's first tile from the (b, h) range starting at s0 on
  // (tile s0 + wg of the first range that has one), hi when none
  auto first_tile = [&](long s0) {
    for (; s0 < hi; s0 = seg_end(s0))
      if (s0 + wg < seg_end(s0)) return s0 + wg;
    return hi;
  };
  // and its tile after `tile`
  auto next_tile = [&](long tile) { return tile + 2 < seg_end(tile) ? tile + 2 : first_tile(seg_end(tile)); };
  if (tid == 0) {
    mbar_init(kv_full, 2);  // the expect_tx of k's copies and of v's
    for (int w = 0; w < 2; ++w) {
      mbar_init(&q_full[w], 1);
      mbar_init(&q_empty[w], 4);  // the warpgroup's warps
      mbar_init(&x_stat[w], 4);   // the other block's warpgroup w's warps
      mbar_init(&x_out[w], 4);
    }
    mbar_fence_init();
  }
  __syncthreads();
  cluster_sync();  // both blocks' mbarriers initialised before any arrival
  auto load_kv = [&](long tile) {  // this block's keys of tile's (b, h) (keys past T zero)
    const int bh = static_cast<int>(tile / tpb);
    load_split<KH>(Ks, &tka, &tkb, bh % H, KH * rank, bh / H, kv_full);
    load_split<KH>(Vs, &tva, &tvb, bh % H, KH * rank, bh / H, kv_full);
  };
  bf16* qs = Qs + wg * QT::SIZE;  // this warpgroup's query slot
  auto load_q = [&](long tile) {  // rows past N zero
    const int bh = static_cast<int>(tile / tpb);
    load_split<BQ>(qs, &tqa, &tqb, bh % H, static_cast<int>(tile - static_cast<long>(bh) * tpb) * BQ, bh / H,
                   &q_full[wg]);
  };
  if (tid == 0 && lo < hi) load_kv(lo);
  long tile = first_tile(lo);
  if (wt == 0 && tile < hi) load_q(tile);
  // a remote arrival of this warp on the other block's barrier `bar`
  auto arrive_peer = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive_cluster(cluster_map(bar, peer));
  };
  const int key0 = KH * rank;                               // this block's keys
  const int rr[2] = {16 * warp + g, 16 * warp + g + 8};  // this thread's rows of a tile
  int n = 0;                                              // this warpgroup's tiles so far
  for (long s0 = lo, e = 0; s0 < hi; s0 = seg_end(s0), ++e) {
    if (e > 0) {  // both warpgroups are done with the last (b, h)'s k and v
      named_bar_sync(3, 256);
      if (tid == 0) load_kv(s0);
    }
    mbar_wait(kv_full, static_cast<int>(e & 1));
    for (; tile < seg_end(s0); tile = next_tile(tile), ++n) {
      const int bh = static_cast<int>(tile / tpb), b = bh / H, h = bh % H;
      const int q0 = static_cast<int>(tile - static_cast<long>(bh) * tpb) * BQ, par = n & 1;
      mbar_wait(&q_full[wg], par);
      // s = q . k^T: k-steps 0-7 over the swizzled columns, 8-9 the chunk-major
      float s[KH / 2];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        wgmma_m64n256k16_ss(s,
                            ks < 8 ? desc_sw128_kmajor<BQ>(qs, ks) : desc_kmajor<QT::PL>(qs + QT::A, 0, 2 * ks - 16),
                            ks < 8 ? desc_sw128_kmajor<KH>(Ks, ks) : desc_kmajor<KT::PL>(Ks + KT::A, 0, 2 * ks - 16),
                            ks > 0);
      wgmma_commit();
      wgmma_wait0();
      reg_fence(s);
      if (key0 + KH > T) {
#pragma unroll
        for (int j = 0; j < KH / 8; ++j)
#pragma unroll
          for (int x = 0; x < 4; ++x)
            if (key0 + 8 * j + 2 * t + (x & 1) >= T) s[4 * j + x] = -CUDART_INF_F;
      }
      // each row's max and sum over this block's keys (exp2 relative to its
      // own max: 0 when none of its keys is below T), sent to the other block
      float2* stat = StatIn + (2 * wg + par) * BQ;
      float m[2], l[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx[4] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
        for (int j = 0; j < KH / 8; ++j)
          mx[j % 4] = fmaxf(mx[j % 4], fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
        m[r] = quad_max(fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3])));
        const float mc = m[r] == -CUDART_INF_F ? 0.f : m[r] * c;
        float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < KH / 8; ++j)
#pragma unroll
          for (int x = 2 * r; x < 2 * r + 2; ++x) {
            s[4 * j + x] = fast_exp2(fmaf(s[4 * j + x], c, -mc));
            sum[j % 4] += s[4 * j + x];
          }
        l[r] = quad_sum((sum[0] + sum[1]) + (sum[2] + sum[3]));
        if (t == 0) st_cluster_f32x2(cluster_map(stat + rr[r], peer), m[r], l[r]);
      }
      arrive_peer(&x_stat[wg]);
      mbar_wait_cluster(&x_stat[wg], par);
      // the row's max over both blocks, its sum block 0's + block 1's (the
      // same in both), and this block's factor 2^((m_r - m) c) / l
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 o2 = stat[rr[r]];
        const float mm = fmaxf(m[r], o2.x);  // finite: block 0's first key is below T
        const float a_own = fast_exp2((m[r] - mm) * c), a_oth = fast_exp2((o2.x - mm) * c);
        const float lt = rank == 0 ? l[r] * a_own + o2.y * a_oth : o2.y * a_oth + l[r] * a_own;
        inv[r] = a_own / lt;
      }
      uint32_t pf[KH / 16][4];  // bf16(p / l), as the TPU kernel rounds
#pragma unroll
      for (int kk = 0; kk < KH / 16; ++kk)
#pragma unroll
        for (int q4 = 0; q4 < 4; ++q4) {
          const int e0 = 8 * kk + 2 * q4, r = q4 & 1;
          pf[kk][q4] = pack_bf16(s[e0] * inv[r], s[e0 + 1] * inv[r]);
        }
      // o = bf16(p / l) . v: columns 0-127 (o[0..63]) from v's swizzled
      // part, 128-159 (o[64..79]) from its chunk-major part
      float o[D / 2];
      float(&o_a)[64] = *reinterpret_cast<float(*)[64]>(o);
      float(&o_b)[16] = *reinterpret_cast<float(*)[16]>(o + 64);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KH / 16; ++kk) {
        wgmma_m64n128k16_tb(o_a, pf[kk], desc_sw128_mnmajor<KH>(Vs, 16 * kk), kk > 0);
        wgmma_m64n32k16_tb(o_b, pf[kk], desc_mnmajor<KT::PL>(Vs + KT::A, 16 * kk, 0), kk > 0);
      }
      wgmma_commit();
      wgmma_wait0();
      reg_fence(o);
      frag_fence(pf);
      // the partial outputs summed: block r writes output columns r D/2 ..
      // r D/2 + D/2 - 1 of the tile; each stores the other half of its
      // partial (fp32 [BQ][D/2]) into the other block's query slot, whose
      // scores are done (its statistics came first)
      float* xs = reinterpret_cast<float*>(qs);
#pragma unroll
      for (int J = 0; J < D / 8; ++J) {
        const int half = J / (D / 16), cc = 8 * (J % (D / 16)) + 2 * t;
        if (half == rank) continue;
#pragma unroll
        for (int r = 0; r < 2; ++r)
          st_cluster_f32x2(cluster_map(xs + rr[r] * (D / 2) + cc, peer), o[4 * J + 2 * r], o[4 * J + 2 * r + 1]);
      }
      arrive_peer(&x_out[wg]);
      mbar_wait_cluster(&x_out[wg], par);
#pragma unroll
      for (int J = 0; J < D / 8; ++J) {
        const int half = J / (D / 16), cc = 8 * (J % (D / 16)) + 2 * t;
        if (half != rank) continue;
#pragma unroll
        for (int r = 0; r < 2; ++r) {  // block 0's partial + block 1's
          const float2 y = *reinterpret_cast<const float2*>(xs + rr[r] * (D / 2) + cc);
          o[4 * J + 2 * r] = rank == 0 ? o[4 * J + 2 * r] + y.x : y.x + o[4 * J + 2 * r];
          o[4 * J + 2 * r + 1] = rank == 0 ? o[4 * J + 2 * r + 1] + y.y : y.y + o[4 * J + 2 * r + 1];
        }
      }
      // the query slot is free: the warpgroup's first thread copies its next tile
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(&q_empty[wg]);
      if (wt == 0) {
        const long nt = next_tile(tile);
        mbar_wait(&q_empty[wg], par);
        if (nt < hi) load_q(nt);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qr = q0 + rr[r];
        if (qr >= N) continue;
        bf16* dst = out + (static_cast<long>(b) * N + qr) * H * D + h * D + 2 * t;
#pragma unroll
        for (int J = 0; J < D / 8; ++J)
          if (J / (D / 16) == rank)
            *reinterpret_cast<uint32_t*>(dst + 8 * J) = pack_bf16(o[4 * J + 2 * r], o[4 * J + 2 * r + 1]);
      }
    }
  }
  cluster_sync();  // no block leaves while the other may still store into its shared memory
}

template <int D>
static int launch_cross_pair(const void* q, const void* k, const void* v, void* out, int B, int N,
                             int T, int H, float scale, cudaStream_t stream) {
  using C = PairCfg<D>;
  CUtensorMap m[6];  // q, k, v: 64-column boxes (128-byte swizzle), 8-column boxes
  int e = 0;
  const void* src[3] = {q, k, v};
  const int rows[3] = {N, T, T}, box[3] = {kCrossBQ, kPairKH, kPairKH};
  for (int i = 0; i < 3 && e == 0; ++i) {
    e = encode_rows_map(&m[2 * i], src[i], B, rows[i], H, D, box[i], true);
    if (e == 0) e = encode_rows_map(&m[2 * i + 1], src[i], B, rows[i], H, D, box[i]);
  }
  if (e != 0) return e;
  const int sms = device_sms();
  cudaError_t err = cudaFuncSetAttribute(cross_pair_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::bytes);
  if (err != cudaSuccess) return (int)err;
  if (sms < 2) return (int)cudaErrorInvalidValue;
  const long total = static_cast<long>(B) * H * ((N + kCrossBQ - 1) / kCrossBQ);
  const long pairs = (total + 1) / 2;  // a cluster takes two tiles a round
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2 * static_cast<unsigned>(pairs < sms / 2 ? pairs : sms / 2));
  cfg.blockDim = dim3(256);
  cfg.dynamicSmemBytes = C::bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, cross_pair_kernel<D>, m[0], m[1], m[2], m[3], m[4], m[5],
                           static_cast<bf16*>(out), N, T, H, B * H, scale * kLog2e);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
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
    case 160:  // resident k and v at the guidance's tokens, else over a cluster of two blocks
      if (T <= 80) return skp::launch_cross_ws<160, 80>(q, k, v, out, B, N, T, H, scale, s);
      return skp::launch_cross_pair<160>(q, k, v, out, B, N, T, H, scale, s);
    default: return -1;
  }
}

// Z for the backward's scratch (the keys pass's query split): dkv_part
// must hold 2 * Z * B * T * H * D fp32 values when Z > 1
extern "C" int skp_attn_bwd_splits(int B, int N, int T, int H, int D) {
  return skp::attn_rk_splits(B, N, T, H, D);
}

// (q, k, v, dout) -> dq, dk, dv in the inputs' layouts, all bf16; lse2 and
// di [B,H,N] fp32 are scratch, as is, with Z = skp_attn_bwd_splits(...) > 1,
// dkv_part (2 Z B T H D fp32). -1 for an unsupported head dimension, a Z
// it does not take, or more than 512 keys at d 64.
extern "C" int skp_cross_bwd(const void* q, const void* k, const void* v, const void* dout,
                             void* lse2, void* di, void* dkv_part, void* dq, void* dk, void* dv, int B,
                             int N, int T, int H, int D, int Z, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 40:
      return skp::launch_attn_rk<40, false>(q, k, v, dout, lse2, di, dkv_part, dq, dk, dv, B, N, T, H, Z,
                                            scale, s);
    case 64:
      return skp::launch_attn_rk<64, false>(q, k, v, dout, lse2, di, dkv_part, dq, dk, dv, B, N, T, H, Z,
                                            scale, s);
    case 80:
      return skp::launch_attn_rk<80, false>(q, k, v, dout, lse2, di, dkv_part, dq, dk, dv, B, N, T, H, Z,
                                            scale, s);
    case 160:
      return skp::launch_attn_rk<160, false>(q, k, v, dout, lse2, di, dkv_part, dq, dk, dv, B, N, T, H, Z,
                                             scale, s);
    default: return -1;
  }
}
