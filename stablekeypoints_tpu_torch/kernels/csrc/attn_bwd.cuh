// Attention backward of K3 (cross_attn.cu) and K4/K5 (flash.cu), every head
// dim, sm_90a. No reduce-add and no atomic: dq, dk and dv are bitwise the
// same from launch to launch, whatever order the blocks run in.
//
// Replaces the backward kernels of stablekeypoints_tpu/kernels/cross_attn.py
// (_cross_bwd, pallas_call at :174) and of JAX's stock Pallas TPU flash
// attention that kernels/flash.py calls (its dkv and dq kernels). With the
// per-row statistics of the forward softmax
//
//   lse2[r] = log2 sum_t exp2(s[r,t])      s = q.k^T * scale * log2(e)
//   di[r]   = sum_t p[r,t] * dp[r,t]       dp = dO . v^T
//
// (K4/K5: lse2 from the forward, di = rowsum(dO o) by flash.cu's
// flash_di_kernel; K3 keeps no residual, so its rows pass recomputes both)
//
//   p    = exp2(s - lse2)
//   dsim = p * (dp - di) * scale, rounded to bf16
//   dq   = dsim . k        dk = dsim^T . q        dv = bf16(p)^T . dO
//
// with fp32 accumulation, as the TPU kernels round. The TPU kernels carried
// dk and dv across a sequential grid axis; on Hopper blocks run in no order,
// so the work splits in two passes, each owning what it writes:
//   rows pass  one block per 128 query rows of a (b, h) (two warpgroups of
//              64): q and dO land once by TMA, k and v of every 64-key tile
//              stream through a ring; s, dp, then dq += dsim . k, dq whole
//              in registers and written once (K3: a first sweep for lse2
//              and di, which it writes for the keys pass);
//   keys pass  one block per 128 keys (two warpgroups of 64) walking the
//              query tiles, split Z ways where the grid would leave SMs
//              idle: k and v land once, q and dO tiles stream; the keys are
//              the rows of every product (s^T, dp^T, then dv += p^T . dO and
//              dk += dsim^T . q), dk and dv in registers; with Z > 1 fp32
//              partials that partial_sum_kernel (common.cuh) sums in the
//              order z = 0, 1, ...
// 7 products and 2 exponentials a score (K3: 9 and 3), where the single
// pass that this replaced ran 5 and 1 but added each query tile's dq from
// every key block into an fp32 scratch by bulk reduce-adds, in no fixed
// order. K4/K5 run both passes as one grid (attn_rk_kernel: the keys
// blocks first, then the rows blocks), which fills each pass's last wave
// with the other's blocks; K3's keys pass needs the rows pass's lse2 and
// di, so it runs after it.
//
// d 64 and 80 (PIPE): each pass takes two tiles at once (the rows pass key
// tiles in pairs, the keys pass a query tile's two halves of 32), both
// tiles' score products issued together, the first's exponentials under
// the second's products and the second's under the first's dq (or dv / dk)
// products; nothing but the accumulation is in flight across the loop's
// back edge (a version that carried the next tile's scores across it made
// ptxas serialize every product: C7514). One block an SM (no 128-register
// cap), a 5-stage ring. At d 64 (AREG) the score products' A operand (the
// block's q and dO rows in the rows pass, its k and v rows in the keys
// pass) sits in registers, loaded once, so that a product reads only its B
// tile from shared memory. d 40 and 160 take one tile at a time (d 40: two
// blocks an SM; two tiles at a time ran its exponentials slower). Ring
// tiles are in the 128-byte swizzle (columns past D zero); the blocks'
// own tiles chunk-major (d 40: depth zero-padded to 48).
//
// On the H100 (700 W, tools/attention_variants.py and chip_smoke.py):
// K4 [4, 9216, 5, 64] 3.64 ms (the reduce-add single pass 3.68; SDPA 2.27;
// rows pass alone 1.39, keys pass alone 2.22), SDXL's [2, 1024, 20, 64]
// 0.126 (0.163), K5 at 500 keys 0.071 (0.117); K3 [4, 4096, 10, 64] 0.356
// (0.358); at d 80 K4 [8, 1024, 8, 80] 0.226 (0.311), K5 0.129 (0.187);
// d 40 K4 [8, 4096, 8, 40] 1.80 (1.82); d 160 K3 [2, 2304, 8, 160] 0.184.
// Bound: operations (7 products of 2 N M D FLOP; at d 40 the exponentials
// come next). Without the two-tile overlap 3.75 at [4, 9216, 5, 64], without
// the register A operand 3.80; a version with both, the passes launched
// apart, 3.92.
//
// K3 at d 64: attn_kq_kernel, one keys-major pass of 5 products a score
// (7 with the statistics sweep before it, where the two passes ran 9),
// each query tile's s^T and dp^T scored once and dq = dsim . k formed from
// dsim^T staged in shared memory; each tile's dq is summed over the
// cluster of key blocks (at most 4: 512 keys) in rank order through
// distributed shared memory, so it is bitwise reproducible too. On the
// H100 (700 W, tools/attention_variants.py --d64, the two passes in the
// same call): K3 [4, 4096, 10, 64] at 500 keys 0.350 ms against 0.357, at
// 77 0.092 against 0.129. K4/K5 keep the two passes: the same pass, given
// their statistics (5 products), lost at 1 to 8 clusters of 8 key blocks
// (0.253 / 0.150 against 0.243 / 0.139 at [4, 1024, 20, 64] and K5 500
// keys; 8-43% at [4, 4096-7744, 5, 64]) and won 3% at 9 ([4, 9216, 5,
// 64] 3.48 against 3.59), not worth a second route. What set its pace: a
// remote mbarrier arrival with release semantics waits a round trip, so
// one thread's arrivals to C blocks waited C round trips (spread over C
// lanes here); float4 sums held in the summing warps' 64 registers spilled
// and slowed the whole pass (they go through shared memory); the consumers
// sit at the 168 registers that 12 warps leave a thread (ptxas allocates
// per launch bound, whatever setmaxnreg gives), and a tile's chain of
// waits runs in lockstep in both warpgroups (the dsim^T barrier).
#pragma once

#include "common.cuh"

namespace skp {

// ---------------------------------------------------------------------------
// The backward as a rows pass and a keys pass, no reduce-adds (source note)

constexpr int kRkBQ = 64;      // query rows a tile (one warpgroup's)
constexpr int kRkKT = 64;      // rows pass: keys a k / v tile
constexpr int kRkStages = 3;   // k / v tiles (rows pass), q / dO tiles (keys pass) in the ring
constexpr int kRkPipeStages = 5;  // ... at d 64 and 80 (the rows pass takes key tiles in pairs)
constexpr int kRkKB = 128;     // keys pass: keys a block (64 a warpgroup)
constexpr int kRkQH = 32;      // keys pass: queries a product step (half a tile)
constexpr int kRkMaxSplits = 8;

template <int D>
struct RkCfg {
  static constexpr int DP = round_up16(D);   // q.k and dO.v depth (d 40: zero-padded to 48)
  static constexpr int KS = DP / 16;
  static constexpr int BPL = 2 * kRkBQ * 8;  // planes of a block's 128 rows (q, dO; k, v)
  static constexpr int BT = DP / 8 * BPL;    // a chunk-major [128][DP] tile
  static constexpr int CB = (D + 63) / 64;   // 64-column blocks of a ring tile
  static constexpr int TT = CB * 64 * 64;    // a ring tile: [CB][64 rows][64], 128-byte swizzle
  // d 64 and 80: each pass takes two tiles (key tiles, or query halves) at
  // once, the second's scores in flight under the first's exponentials and
  // the first's products under the second's (two score buffers: one block
  // an SM, no 128-register cap); d 40 and 160 one (d 40: two blocks an SM)
  static constexpr bool PIPE = D == 64 || D == 80;
  static constexpr int MINB = D <= 64 && !PIPE ? 2 : 1;
  static constexpr int ST = PIPE ? kRkPipeStages : kRkStages;
  // d 64: the score products' A operand (the block's q and dO rows in the
  // rows pass, its k and v rows in the keys pass) as register fragments,
  // loaded once, so that a product reads only its B tile from shared memory
  static constexpr bool AREG = D == 64;
  // q, dO (rows) or k, v (keys); [stage] two ring tiles; mbarriers: the
  // block's tiles, full [stage], empty [stage]
  static constexpr size_t bytes = sizeof(bf16) * 2 * (BT + ST * TT) + sizeof(uint64_t) * (1 + 2 * ST);
};

// A fragments (k-steps of 16 columns) of the 16 rows of this thread's warp
// starting at `row` - g (row = this thread's first row) in a chunk-major
// tile of planes of PL elements ([chunk][row][8])
template <int KS, int PL>
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[KS][4], const bf16* tile, int row) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f[ks][i] = *reinterpret_cast<const uint32_t*>(tile + (2 * ks + (i >> 1)) * PL + (row + 8 * (i & 1)) * 8 +
                                                    2 * t);
}

// The rows pass, one block of two warpgroups per 128 query rows of one (b,
// h) (warpgroup w: rows 64 w ..). q and dO land once by TMA; k and v of
// every key tile (any key count) stream through a ring that thread 0
// refills once all eight warps have released a stage:
//   1. (K3, whose forward keeps no residual; not with kGiven) s = q . k^T,
//      dp = dO . v^T (m64n64k16; q and dO from registers at d 64, else from
//      shared memory): the online row max and sum and a = sum_t exp2(s c -
//      m) dp; lse2 = m c + log2 l and di = a / l, written for the keys pass;
//   2. s and dp (again), dsim = bf16(exp2(s c - lse2) (dp - di) scale) and
//      dq += dsim . k (m64nDk16, dsim from registers, k MN-major), a tile's
//      scores formed while the last tile's dq product runs.
// kGiven (K4/K5): lse2 from the forward and di = rowsum(dO o) are given, so
// one sweep. dq is whole in registers at the end and written once as bf16.
// kStats: sweep 1 alone (K3's statistics at d 64, where attn_kq_kernel
// forms dq). Block (bx, h, b) of the pass: query rows 128 bx .. of head h,
// image b.
template <int D, bool kGiven, bool kStats = false>
__device__ __forceinline__ void rows_pass(const CUtensorMap* tq, const CUtensorMap* tdo, const CUtensorMap* tk,
                                          const CUtensorMap* tv, float* __restrict__ lse2,
                                          float* __restrict__ di, bf16* __restrict__ dq, int N, int T, int H,
                                          float scale, int bx, int h, int b) {
  using C = RkCfg<D>;
  constexpr int BQ = kRkBQ, KT = kRkKT, ST = C::ST, KS = C::KS, BPL = C::BPL;
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // chunk-major [128][DP]
  bf16* Os = Qs + C::BT;                     // dO, the same
  bf16* Ring = Os + C::BT;                   // [stage] k tile, v tile: [CB][64][64], 128-byte swizzle
  uint64_t* qfull = reinterpret_cast<uint64_t*>(Ring + ST * 2 * C::TT);
  uint64_t* full = qfull + 1;    // [stage]
  uint64_t* empty = full + ST;   // [stage]

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = bx * 2 * BQ;
  const long bh = static_cast<long>(b) * H + h;
  const float c = scale * kLog2e;
  static_assert(!(kGiven && kStats), "rows_pass: the statistics are given or computed");
  const int nkt = (T + KT - 1) / KT, steps = kGiven || kStats ? nkt : 2 * nkt;  // ring steps: the sweeps
  auto kt_of = [&](int i) { return Ring + (i % ST) * 2 * C::TT; };
  // d 40: the padding columns 40..47, which no copy writes
  zero_chunks<2 * BQ, BPL>(Qs, D / 8, C::DP / 8, tid, 256);
  zero_chunks<2 * BQ, BPL>(Os, D / 8, C::DP / 8, tid, 256);
  if (tid == 0) {
    mbar_init(qfull, 1);
    for (int st = 0; st < ST; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 8);  // each warp of the block
    }
    mbar_fence_init();
  }
  fence_proxy_async();  // the padding zeros, read by wgmma
  __syncthreads();
  // ring step i: k and v of key tile i % nkt, a box a 64-column block (keys
  // past T and columns past D arrive as zeros)
  auto issue = [&](int i) {
    if (i >= steps) return;
    bf16* kt = kt_of(i);
    mbar_expect_tx(&full[i % ST], 2 * C::TT * 2);
    for (int cb = 0; cb < C::CB; ++cb) {
      tma_load_4d(kt + cb * KT * 64, tk, 64 * cb, h, (i % nkt) * KT, b, &full[i % ST]);
      tma_load_4d(kt + C::TT + cb * KT * 64, tv, 64 * cb, h, (i % nkt) * KT, b, &full[i % ST]);
    }
  };
  if (tid == 0) {  // the block's q and dO rows (rows past N zero), the ring's first stages
    mbar_expect_tx(qfull, 2 * (D / 8) * 2 * BQ * 16);
    for (int ch = 0; ch < D / 8; ++ch) {
      tma_load_4d(Qs + ch * BPL, tq, 8 * ch, h, n0, b, qfull);
      tma_load_4d(Os + ch * BPL, tdo, 8 * ch, h, n0, b, qfull);
    }
    for (int i = 0; i < ST; ++i) issue(i);
  }
  // every warp is done with step i's stage: thread 0 refills it with step i + ST
  auto release = [&](int i) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[i % ST]);
    if (tid == 0 && i + ST < steps) {
      mbar_wait(&empty[i % ST], (i / ST) & 1);
      issue(i + ST);
    }
  };
  float s[KT / 2], dp[KT / 2];
  uint32_t qf[C::AREG ? KS : 1][4], of[C::AREG ? KS : 1][4];  // AREG: this warp's q and dO rows
  // s and dp of ring step i into (sb, db) (asynchronous; one commit group)
  auto scores_into = [&](int i, float (&sb)[KT / 2], float (&db)[KT / 2]) {
    mbar_wait(&full[i % ST], (i / ST) & 1);
    const bf16* kt = kt_of(i);
    wgmma_fence();
    if constexpr (C::AREG) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) wgmma_m64n64k16(sb, qf[ks], desc_sw128_kmajor<KT>(kt, ks), ks > 0);
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) wgmma_m64n64k16(db, of[ks], desc_sw128_kmajor<KT>(kt + C::TT, ks), ks > 0);
    } else {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        wgmma_m64n64k16_ss(sb, desc_kmajor<BPL>(Qs, BQ * wg, 2 * ks), desc_sw128_kmajor<KT>(kt, ks), ks > 0);
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        wgmma_m64n64k16_ss(db, desc_kmajor<BPL>(Os, BQ * wg, 2 * ks), desc_sw128_kmajor<KT>(kt + C::TT, ks),
                           ks > 0);
    }
    wgmma_commit();
  };
  auto scores = [&](int i) { scores_into(i, s, dp); };
  mbar_wait(qfull, 0);
  if constexpr (C::AREG) {
    load_a_frags<KS, BPL>(qf, Qs, BQ * wg + 16 * warp + g);
    load_a_frags<KS, BPL>(of, Os, BQ * wg + 16 * warp + g);
  }

  const int row0 = n0 + BQ * wg + 16 * warp + g;  // this thread's rows: row0, row0 + 8
  float lse_r[2], di_r[2];
  if constexpr (kGiven) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // rows past N: 0 (their q and dO are zero, so is their dsim)
      const bool ok = row0 + 8 * r < N;
      lse_r[r] = ok ? lse2[bh * N + row0 + 8 * r] : 0.f;
      di_r[r] = ok ? di[bh * N + row0 + 8 * r] : 0.f;
    }
  } else {
    // sweep 1: the statistics, four interleaved partials a row
    float m_r[2] = {-CUDART_INF_F, -CUDART_INF_F}, l_r[2] = {0.f, 0.f}, a_r[2] = {0.f, 0.f};
    for (int i = 0; i < nkt; ++i) {
      scores(i);
      wgmma_wait0();
      reg_fence(s);
      reg_fence(dp);
      release(i);
      const int k0 = i * KT;
      if (k0 + KT > T)
#pragma unroll
        for (int j = 0; j < KT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k0 + 8 * j + 2 * t + (e & 1) >= T) s[4 * j + e] = -CUDART_INF_F;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx[4] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
        for (int j = 0; j < KT / 8; ++j)
          mx[j % 4] = fmaxf(mx[j % 4], fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
        const float m_new =  // finite: every tile has a key below T
            fmaxf(m_r[r], quad_max(fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3]))));
        const float alpha = fast_exp2((m_r[r] - m_new) * c), mc = m_new * c;
        m_r[r] = m_new;
        float sum[4] = {0.f, 0.f, 0.f, 0.f}, pdp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < KT / 8; ++j)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            const float p = fast_exp2(fmaf(s[4 * j + e], c, -mc));
            sum[j % 4] += p;
            pdp[j % 4] = fmaf(p, dp[4 * j + e], pdp[j % 4]);
          }
        l_r[r] = fmaf(l_r[r], alpha, (sum[0] + sum[1]) + (sum[2] + sum[3]));
        a_r[r] = fmaf(a_r[r], alpha, (pdp[0] + pdp[1]) + (pdp[2] + pdp[3]));
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float l = quad_sum(l_r[r]), a = quad_sum(a_r[r]);
      lse_r[r] = m_r[r] * c + log2f(l);
      di_r[r] = a / l;
      if (row0 + 8 * r < N && t == 0) {
        lse2[bh * N + row0 + 8 * r] = lse_r[r];
        di[bh * N + row0 + 8 * r] = di_r[r];
      }
    }
    if constexpr (kStats) return;
  }

  // sweep 2: dq = sum over the key tiles of bf16(dsim) . k
  float dq_acc[D / 2];
  uint32_t da[KT / 16][4];  // bf16(dsim), 16 keys a k-step
  const int base = kGiven ? 0 : nkt;  // sweep 2's first ring step
  // dsim of key tile kt from the scores in (sb, db), rounded to bf16 into
  // fr (keys past T masked), then dq += fr . k, asynchronous
  auto dq_step = [&](int kt, float (&sb)[KT / 2], float (&db)[KT / 2], uint32_t (&fr)[KT / 16][4],
                     const bf16* k_tile) {
    const int k0 = kt * KT;
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = fast_exp2(fmaf(sb[4 * j + e], c, -lse_r[r]));
        const float ds = p * (db[4 * j + e] - di_r[r]) * scale;
        sb[4 * j + e] = k0 + 8 * j + 2 * t + (e & 1) < T ? ds : 0.f;
      }
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk)
#pragma unroll
      for (int q4 = 0; q4 < 4; ++q4) fr[kk][q4] = pack_bf16(sb[8 * kk + 2 * q4], sb[8 * kk + 2 * q4 + 1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk)
      wgmma_pv<D>(dq_acc, fr[kk], desc_sw128_mnmajor<KT>(k_tile, 16 * kk), kt > 0 || kk > 0);
    wgmma_commit();
  };
  if constexpr (C::PIPE) {
    // key tiles in pairs (a, b = a + 1; past the last tile b is tile a's
    // keys again, all masked): both pairs' scores issued, then a's dsim
    // under b's scores and b's dsim under a's dq product. Nothing is in
    // flight across the loop's back edge but dq's accumulation.
    float s1[KT / 2], dp1[KT / 2];
    uint32_t da1[KT / 16][4];
    const int last = base + nkt - 1;
    for (int kt = 0; kt < nkt; kt += 2) {
      const int ia = base + kt, ib = min(ia + 1, last);
      scores_into(ia, s, dp);
      scores_into(ib, s1, dp1);
      wgmma_wait1();  // a's scores, the last pair's dq products
      reg_fence(s);
      reg_fence(dp);
      frag_fence(da);
      frag_fence(da1);
      if (kt > 0) {  // the last pair's k and v are free
        release(ia - 2);
        release(ia - 1);
      }
      dq_step(kt, s, dp, da, kt_of(ia));
      wgmma_wait1();  // b's scores
      reg_fence(s1);
      reg_fence(dp1);
      dq_step(kt + 1, s1, dp1, da1, kt_of(ib));
    }
    wgmma_wait0();
    frag_fence(da1);
  } else {
    for (int kt = 0; kt < nkt; ++kt) {
      const int i = base + kt;
      scores(i);
      wgmma_wait0();  // the scores, and the last tile's dq product
      reg_fence(s);
      reg_fence(dp);
      if (kt > 0) {
        reg_fence(dq_acc);
        frag_fence(da);
        release(i - 1);
      }
      dq_step(kt, s, dp, da, kt_of(i));
    }
    wgmma_wait0();
  }
  reg_fence(dq_acc);
  frag_fence(da);
  release(steps - 1);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row0 + 8 * r >= N) continue;
    bf16* dst = dq + ((static_cast<long>(b) * N + row0 + 8 * r) * H + h) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) = pack_bf16(dq_acc[4 * j + 2 * r], dq_acc[4 * j + 2 * r + 1]);
  }
}

// The keys pass, one block of two warpgroups per (128 keys, h, b, z)
// (warpgroup w: keys 64 w ..) walking query tiles z, z + Z, ... of the (b,
// h). k and v land once by TMA; each tile's q and dO stream through a ring
// that thread 0 refills once all eight warps have released a stage. The
// keys are the rows of every product, and a tile is taken in two halves of
// 32 queries:
//   s^T = k . q^T, dp^T = v . dO^T       m64n32k16 (k and v from registers
//                                        at d 64, else from shared memory)
//   p^T = exp2(s^T c - lse2), dsim^T = p^T (dp^T - di) scale (lse2 and di
//   from the rows pass)
//   dv += bf16(p^T) . dO, dk += bf16(dsim^T) . q
//                                        m64nDk16, A from the scores'
//                                        registers, dO and q MN-major
// dk and dv stay in registers: bf16 when the query tiles are not split (Z
// = 1), else fp32 partials that partial_sum_kernel adds in the order z = 0, 1, ...
// Block (bx, h, b Z + z) of the pass: keys 128 bx .. of head h, image b (of B).
template <int D>
__device__ __forceinline__ void keys_pass(const CUtensorMap* tq, const CUtensorMap* tdo, const CUtensorMap* tk,
                                          const CUtensorMap* tv, const float* __restrict__ lse2,
                                          const float* __restrict__ di, float* __restrict__ dkv_part,
                                          bf16* __restrict__ dk, bf16* __restrict__ dv, int N, int T, int H,
                                          int Z, int B, float scale, int bx, int h, int bz) {
  using C = RkCfg<D>;
  constexpr int BQ = kRkBQ, QH = kRkQH, ST = C::ST, KS = C::KS, BPL = C::BPL;
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // chunk-major [128][DP]
  bf16* Vs = Ks + C::BT;
  bf16* Ring = Vs + C::BT;                   // [stage] q tile, dO tile: [CB][64][64], 128-byte swizzle
  uint64_t* kvfull = reinterpret_cast<uint64_t*>(Ring + ST * 2 * C::TT);
  uint64_t* full = kvfull + 1;   // [stage]
  uint64_t* empty = full + ST;   // [stage]

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int b = bz / Z, z = bz % Z, k0 = bx * kRkKB;
  const long bh = static_cast<long>(b) * H + h;
  const float c = scale * kLog2e;
  const int tiles = (N + BQ - 1) / BQ;
  const int n = tiles > z ? (tiles - z + Z - 1) / Z : 0;  // this block's tiles: z, z + Z, ...
  auto qt_of = [&](int j) { return Ring + (j % ST) * 2 * C::TT; };
  zero_chunks<kRkKB, BPL>(Ks, D / 8, C::DP / 8, tid, 256);
  zero_chunks<kRkKB, BPL>(Vs, D / 8, C::DP / 8, tid, 256);
  if (tid == 0) {
    mbar_init(kvfull, 1);
    for (int st = 0; st < ST; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 8);
    }
    mbar_fence_init();
  }
  fence_proxy_async();
  __syncthreads();
  // the block's j-th tile: q and dO rows (z + Z j) BQ .., a box a 64-column
  // block (rows past N and columns past D zero)
  auto issue = [&](int j) {
    if (j >= n) return;
    bf16* qt = qt_of(j);
    const int q0 = (z + Z * j) * BQ;
    mbar_expect_tx(&full[j % ST], 2 * C::TT * 2);
    for (int cb = 0; cb < C::CB; ++cb) {
      tma_load_4d(qt + cb * BQ * 64, tq, 64 * cb, h, q0, b, &full[j % ST]);
      tma_load_4d(qt + C::TT + cb * BQ * 64, tdo, 64 * cb, h, q0, b, &full[j % ST]);
    }
  };
  if (tid == 0) {  // the block's keys (keys past T zero), the ring's first stages
    mbar_expect_tx(kvfull, 2 * (D / 8) * kRkKB * 16);
    for (int ch = 0; ch < D / 8; ++ch) {
      tma_load_4d(Ks + ch * BPL, tk, 8 * ch, h, k0, b, kvfull);
      tma_load_4d(Vs + ch * BPL, tv, 8 * ch, h, k0, b, kvfull);
    }
    for (int j = 0; j < ST; ++j) issue(j);
  }
  auto release = [&](int j) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[j % ST]);
    if (tid == 0 && j + ST < n) {
      mbar_wait(&empty[j % ST], (j / ST) & 1);
      issue(j + ST);
    }
  };

  const int key0 = k0 + 64 * wg + 16 * warp + g;  // this thread's keys: key0, key0 + 8
  float dk_acc[D / 2], dv_acc[D / 2];
  uint32_t pa[QH / 16][4], da[QH / 16][4];  // bf16(p^T), bf16(dsim^T), 16 queries a k-step
  // lse2 and di of this thread's queries q0 + 8 jj + 2 t + e (loaded before
  // the scores are waited for)
  float lq[QH / 8][2], dq_[QH / 8][2];
  auto stats = [&](int q0) {
#pragma unroll
    for (int jj = 0; jj < QH / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = q0 + 8 * jj + 2 * t + e;
        lq[jj][e] = row < N ? lse2[bh * N + row] : 0.f;
        dq_[jj][e] = row < N ? di[bh * N + row] : 0.f;
      }
  };
  // p^T and dsim^T of the scores in (s, dp) for those queries, rounded to
  // bf16 into (fp, fd)
  auto dsim = [&](float (&s)[QH / 2], float (&dp)[QH / 2], int q0, uint32_t (&fp)[QH / 16][4],
                  uint32_t (&fd)[QH / 16][4]) {
#pragma unroll
    for (int jj = 0; jj < QH / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + 8 * (e >> 1), row = q0 + 8 * jj + 2 * t + (e & 1);
        const float p = fast_exp2(fmaf(s[4 * jj + e], c, -lq[jj][e & 1]));
        const bool ok = key < T && row < N;
        s[4 * jj + e] = ok ? p : 0.f;
        dp[4 * jj + e] = ok ? p * (dp[4 * jj + e] - dq_[jj][e & 1]) * scale : 0.f;
      }
#pragma unroll
    for (int kk = 0; kk < QH / 16; ++kk)
#pragma unroll
      for (int q4 = 0; q4 < 4; ++q4) {
        fp[kk][q4] = pack_bf16(s[8 * kk + 2 * q4], s[8 * kk + 2 * q4 + 1]);
        fd[kk][q4] = pack_bf16(dp[8 * kk + 2 * q4], dp[8 * kk + 2 * q4 + 1]);
      }
  };
  mbar_wait(kvfull, 0);
  if constexpr (C::PIPE) {
    // a tile's two halves at once: both halves' scores issued, then the
    // first's dsim under the second's scores and the second's dsim under
    // the first's dv and dk products. Nothing is in flight across the loop's
    // back edge but dk's and dv's accumulation.
    static_assert(BQ == 2 * QH, "keys_pass: a tile is two halves");
    float s0[QH / 2], dp0[QH / 2], s1[QH / 2], dp1[QH / 2];
    uint32_t pa1[QH / 16][4], da1[QH / 16][4];
    uint32_t kf[C::AREG ? KS : 1][4], vf[C::AREG ? KS : 1][4];  // AREG: this warp's k and v rows
    if constexpr (C::AREG) {
      load_a_frags<KS, BPL>(kf, Ks, 64 * wg + 16 * warp + g);
      load_a_frags<KS, BPL>(vf, Vs, 64 * wg + 16 * warp + g);
    }
    auto scores = [&](const bf16* qt, float (&sb)[QH / 2], float (&db)[QH / 2]) {
      wgmma_fence();
      if constexpr (C::AREG) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) wgmma_m64n32k16(sb, kf[ks], desc_sw128_kmajor<BQ>(qt, ks), ks > 0);
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) wgmma_m64n32k16(db, vf[ks], desc_sw128_kmajor<BQ>(qt + C::TT, ks), ks > 0);
      } else {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          wgmma_m64n32k16_ss(sb, desc_kmajor<BPL>(Ks, 64 * wg, 2 * ks), desc_sw128_kmajor<BQ>(qt, ks), ks > 0);
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          wgmma_m64n32k16_ss(db, desc_kmajor<BPL>(Vs, 64 * wg, 2 * ks), desc_sw128_kmajor<BQ>(qt + C::TT, ks),
                             ks > 0);
      }
      wgmma_commit();
    };
    auto products = [&](const bf16* qt, int half, uint32_t (&fp)[QH / 16][4], uint32_t (&fd)[QH / 16][4],
                        bool acc) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < QH / 16; ++kk)
        wgmma_pv<D>(dv_acc, fp[kk], desc_sw128_mnmajor<BQ>(qt + C::TT, QH * half + 16 * kk), acc || kk > 0);
#pragma unroll
      for (int kk = 0; kk < QH / 16; ++kk)
        wgmma_pv<D>(dk_acc, fd[kk], desc_sw128_mnmajor<BQ>(qt, QH * half + 16 * kk), acc || kk > 0);
      wgmma_commit();
    };
    for (int j = 0; j < n; ++j) {
      const int q0 = (z + Z * j) * BQ;
      mbar_wait(&full[j % ST], (j / ST) & 1);
      const bf16* qt = qt_of(j);
      scores(qt, s0, dp0);
      scores(qt + QH * 64, s1, dp1);
      stats(q0);
      wgmma_wait1();  // the first half's scores, the last tile's dv and dk
      reg_fence(s0);
      reg_fence(dp0);
      frag_fence(pa);
      frag_fence(da);
      frag_fence(pa1);
      frag_fence(da1);
      if (j > 0) release(j - 1);  // q and dO of the last tile are free
      dsim(s0, dp0, q0, pa, da);
      products(qt, 0, pa, da, j > 0);
      stats(q0 + QH);
      wgmma_wait1();  // the second half's scores
      reg_fence(s1);
      reg_fence(dp1);
      dsim(s1, dp1, q0 + QH, pa1, da1);
      products(qt, 1, pa1, da1, true);
    }
    wgmma_wait0();
    frag_fence(pa1);
    frag_fence(da1);
  } else {
    for (int j = 0; j < n; ++j) {
      const int q0 = (z + Z * j) * BQ;
      mbar_wait(&full[j % ST], (j / ST) & 1);
      const bf16* qt = qt_of(j);
#pragma unroll
      for (int half = 0; half < BQ / QH; ++half) {
        float s[QH / 2], dp[QH / 2];  // this warpgroup's keys x the half's queries
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          wgmma_m64n32k16_ss(s, desc_kmajor<BPL>(Ks, 64 * wg, 2 * ks), desc_sw128_kmajor<BQ>(qt + QH * half * 64, ks),
                             ks > 0);
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
          wgmma_m64n32k16_ss(dp, desc_kmajor<BPL>(Vs, 64 * wg, 2 * ks),
                             desc_sw128_kmajor<BQ>(qt + C::TT + QH * half * 64, ks), ks > 0);
        wgmma_commit();
        stats(q0 + QH * half);
        wgmma_wait0();  // the scores, and the last half's dk and dv products
        reg_fence(s);
        reg_fence(dp);
        if (half > 0 || j > 0) {
          reg_fence(dk_acc);
          reg_fence(dv_acc);
          frag_fence(pa);
          frag_fence(da);
          if (half == 0) release(j - 1);  // q and dO of the last tile are free
        }
        dsim(s, dp, q0 + QH * half, pa, da);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < QH / 16; ++kk)
          wgmma_pv<D>(dv_acc, pa[kk], desc_sw128_mnmajor<BQ>(qt + C::TT, QH * half + 16 * kk),
                      j > 0 || half > 0 || kk > 0);
#pragma unroll
        for (int kk = 0; kk < QH / 16; ++kk)
          wgmma_pv<D>(dk_acc, da[kk], desc_sw128_mnmajor<BQ>(qt, QH * half + 16 * kk), j > 0 || half > 0 || kk > 0);
        wgmma_commit();
      }
    }
  }
  wgmma_wait0();
  reg_fence(dk_acc);
  reg_fence(dv_acc);
  frag_fence(pa);
  frag_fence(da);
  const long E = static_cast<long>(B) * T * H * D;  // elements of dk (and dv)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= T) continue;
    const long off = ((static_cast<long>(b) * T + key) * H + h) * D + 2 * t;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      // a block with no tiles (Z above the tile count) adds zeros
      const float2 k2 = n > 0 ? make_float2(dk_acc[4 * jj + 2 * r], dk_acc[4 * jj + 2 * r + 1])
                              : make_float2(0.f, 0.f);
      const float2 v2 = n > 0 ? make_float2(dv_acc[4 * jj + 2 * r], dv_acc[4 * jj + 2 * r + 1])
                              : make_float2(0.f, 0.f);
      if (Z == 1) {
        *reinterpret_cast<uint32_t*>(dk + off + 8 * jj) = pack_bf16(k2.x, k2.y);
        *reinterpret_cast<uint32_t*>(dv + off + 8 * jj) = pack_bf16(v2.x, v2.y);
      } else {
        *reinterpret_cast<float2*>(dkv_part + z * E + off + 8 * jj) = k2;
        *reinterpret_cast<float2*>(dkv_part + (Z + z) * E + off + 8 * jj) = v2;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K3 at d 64: the backward as one keys-major pass of five products, dq
// summed over a cluster of key blocks in a fixed order (source note)

constexpr int kKqKB = 128;        // keys a block (64 a consumer warpgroup)
constexpr int kKqBQ = 64;         // queries a tile
constexpr int kKqStages = 3;      // q / dO tiles in the ring
constexpr int kKqMaxCluster = 4;  // key blocks a cluster: K3's keys are at most 512
constexpr int kKqThreads = 384;   // a producer warpgroup, two consumer warpgroups
constexpr int kKqRows = 72;       // rows of a dq exchange buffer: C slots of ceil(64 / C) rows, <= 66 for C <= 4
constexpr int kKqBufs = 2;        // exchange buffers a side: tile j's use the buffers of tile j - 2

struct KqCfg {
  static constexpr int D = 64, KS = D / 16;
  static constexpr int BPL = kKqKB * 8;       // planes of the block's k and v ([8][128][8] chunk-major)
  static constexpr int KT = D / 8 * BPL;      // a k or v tile (elements)
  static constexpr int QT = kKqBQ * 64;       // a q or dO ring tile ([64][64], 128-byte swizzle)
  static constexpr int SPL = kKqKB * 8;       // planes of dsim^T ([8 query chunks][128 keys][8])
  static constexpr int DS = kKqBQ / 8 * SPL;  // a dsim^T tile
  static constexpr int XB = kKqRows * D;      // a dq exchange buffer (fp32 [slot][row][64])
  static constexpr int SUM = 32 * D;          // a slice's sums (fp32; at most 32 rows at C >= 2)
  // ring [stage] q, dO; k, v; dsim^T [parity] (bf16); lse2, di [stage][2][64],
  // the staging and the receive buffers [kKqBufs] and the sums (fp32);
  // mbarriers: k and v, full / empty [stage]; staged / sent / xfull / xempty
  // [kKqBufs]
  static constexpr size_t bytes = sizeof(bf16) * (kKqStages * 2 * QT + 2 * KT + 2 * DS) +
                                  sizeof(float) * (kKqStages * 2 * kKqBQ + 2 * kKqBufs * XB + SUM) +
                                  sizeof(uint64_t) * (1 + 2 * kKqStages + 4 * kKqBufs);
};

// the offset of fp32 column `col` of row `row` in a [rows][64] dq block
// (256-byte lines, the 16-byte chunks of each half swizzled by the row's
// index in the tile, so that the 8 rows a warp stores fall in different
// banks)
__device__ __forceinline__ int kq_sw(int row, int col) {
  return ((((col >> 2) ^ (row & 7)) << 2) | (col & 3));
}

// lse2, di [B,H,N] from K3's statistics sweep. Grid (C, H, B Z), one
// cluster of C = ceil(M / 128) blocks a (b, h, z): block x holds keys 128 x
// .. of head h, image b, and walks the query tiles z, z + Z, ... of the
// (b, h) in lockstep with its cluster. A tile's 64 rows are C slices, slice
// s rows ceil(64 s / C) .., and block s sums the slice's dq over the
// cluster.
//   producer warpgroup (setmaxnreg down): warp 0 copies k and v once and
//     each tile's q and dO (TMA, 128-byte swizzle) and the tile's lse2 and
//     di rows into a ring. Warp 1 sends each block of the cluster its slice
//     of this block's staged dq partial, one bulk copy (the copy engine,
//     into distributed shared memory) a block and tile whose bytes complete
//     that block's mbarrier, once that block has summed what it was sent two
//     tiles before. Warps 2-3 sum the C partials of this block's slice in
//     rank order into shared memory, tell each block that the buffer is
//     free (one remote arrival a lane, C lanes at once), then write the
//     sums as bf16 dq.
//   two consumer warpgroups (setmaxnreg up) of 64 keys: per tile
//     s^T = k . q^T, dp^T = v . dO^T (m64n64k16, k and v from registers)
//     p^T = exp2(s^T c - lse2), dsim^T = bf16(p^T (dp^T - di) scale)
//     dv += bf16(p^T) . dO, dk += dsim^T . q (A from the scores' registers)
//     dsim^T into shared memory; once both warpgroups' are there (a named
//     barrier), warpgroup w's columns 32 w .. of the block's dq partial
//     dsim . k over the block's 128 keys (m64n32k16, both operands
//     MN-major) into the staging buffer, slice by slice (C = 1: dq itself,
//     written at once).
// dk and dv stay in registers: bf16 at Z = 1, else fp32 partials
// (dkv_part [2][Z][B,M,H,D]) summed in order after.
__global__ void __launch_bounds__(kKqThreads, 1)
    attn_kq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                   const float* __restrict__ lse2, const float* __restrict__ di, float* __restrict__ dkv_part,
                   bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv, int N, int M, int H,
                   int Z, int CL, float scale) {
  using C = KqCfg;
  constexpr int BQ = kKqBQ, S = kKqStages, KS = C::KS, BPL = C::BPL, NB = kKqBufs;
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* Ring = reinterpret_cast<bf16*>(smem);  // [stage] q tile, dO tile
  bf16* Ks = Ring + S * 2 * C::QT;             // chunk-major [128][64]
  bf16* Vs = Ks + C::KT;
  bf16* Ds = Vs + C::KT;                                   // [parity] dsim^T, chunk-major [128 keys][64]
  float* Stat = reinterpret_cast<float*>(Ds + 2 * C::DS);  // [stage] lse2 [64], di [64] of the tile's rows
  float* Stg = Stat + S * 2 * BQ;  // [buffer][slice][ceil(64 / C) rows][64]: this block's dq partial
  float* Rcv = Stg + NB * C::XB;   // [buffer][source rank][ceil(64 / C) rows][64]: this block's slice
  float* Sum = Rcv + NB * C::XB;   // [row][64]: its sums, each in the slot of the thread that made it
  uint64_t* kvfull = reinterpret_cast<uint64_t*>(Sum + C::SUM);
  uint64_t* full = kvfull + 1;     // [stage]
  uint64_t* empty = full + S;      // [stage]
  uint64_t* staged = empty + S;    // [buffer]: the consumers have staged a tile's partial
  uint64_t* sent = staged + NB;    // [buffer]: its copies have read it
  uint64_t* xfull = sent + NB;     // [buffer]: the cluster's partials of this block's slice landed
  uint64_t* xempty = xfull + NB;   // [buffer]: every block has read what it was sent

  const int tid = threadIdx.x, lane = tid % 32;
  const int rank = blockIdx.x, h = blockIdx.y;
  const int b = blockIdx.z / Z, z = blockIdx.z % Z, k0 = blockIdx.x * kKqKB;
  const long bh = static_cast<long>(b) * H + h;
  const int tiles = (N + BQ - 1) / BQ;
  const int n = tiles > z ? (tiles - z + Z - 1) / Z : 0;  // this block's tiles: z, z + Z, ...
  const int RM = (BQ + CL - 1) / CL;  // rows of a slice's slot
  auto slice_start = [&](int sl) { return (BQ * sl + CL - 1) / CL; };
  // the bytes of a tile's partials this block receives: its slice's 64 columns from each block
  const int xbytes = CL * (slice_start(rank + 1) - slice_start(rank)) * C::D * 4;
  if (tid == 0) {
    mbar_init(kvfull, 1);
    for (int st = 0; st < S; ++st) {
      mbar_init(&full[st], 32);  // the copying warp's lanes (lane 0's with the copies' bytes)
      mbar_init(&empty[st], 8);  // each consumer warp
    }
    for (int x = 0; x < NB; ++x) {
      mbar_init(&staged[x], 8);  // each consumer warp
      mbar_init(&sent[x], 1);
      mbar_init(&xfull[x], 1);  // the bytes of tile x (then x + NB, ...), expected before any is sent
      if (x < n && CL > 1) mbar_expect_tx(&xfull[x], xbytes);
      mbar_init(&xempty[x], CL);  // each block, once it has read what it was sent
    }
    mbar_fence_init();
  }
  __syncthreads();
  cluster_sync();  // every block's mbarriers initialised before any remote arrival

  if (tid < 128) {
    setmaxnreg_dec<64>();
    const int warp = tid / 32;
    if (warp == 0) {  // the copies
      if (lane == 0) {  // the block's keys (keys past M zero)
        mbar_expect_tx(kvfull, 2 * C::KT * 2);
        for (int ch = 0; ch < C::D / 8; ++ch) {
          tma_load_4d(Ks + ch * BPL, &tk, 8 * ch, h, k0, b, kvfull);
          tma_load_4d(Vs + ch * BPL, &tv, 8 * ch, h, k0, b, kvfull);
        }
      }
      for (int j = 0; j < n; ++j) {
        const int st = j % S, q0 = (z + Z * j) * BQ;
        if (j >= S) mbar_wait(&empty[st], (j / S - 1) & 1);  // tile j - S's stage is free
        float* sv = Stat + st * 2 * BQ;
        for (int r = lane; r < BQ; r += 32) {  // rows past N: 0
          const bool ok = q0 + r < N;
          sv[r] = ok ? lse2[bh * N + q0 + r] : 0.f;
          sv[BQ + r] = ok ? di[bh * N + q0 + r] : 0.f;
        }
        if (lane == 0) {  // q and dO rows q0 .. (rows past N zero)
          bf16* qt = Ring + st * 2 * C::QT;
          mbar_expect_tx(&full[st], 2 * C::QT * 2);
          tma_load_4d(qt, &tq, 0, h, q0, b, &full[st]);
          tma_load_4d(qt + C::QT, &tdo, 0, h, q0, b, &full[st]);
        } else {
          mbar_arrive(&full[st]);
        }
      }
    } else if (CL > 1 && warp == 1) {  // the sends
      if (lane == 0)
        for (int j = 0; j < n; ++j) {
          const int x = j % NB, ph = (j / NB) & 1;
          mbar_wait(&staged[x], ph);
          if (j >= NB) mbar_wait_cluster(&xempty[x], ph ^ 1);  // tile j - NB read by every block
          const float* sg = Stg + x * C::XB;
          for (int sl = 0; sl < CL; ++sl)
            bulk_copy_to_cluster(cluster_map(Rcv + x * C::XB + rank * RM * C::D, sl), sg + sl * RM * C::D,
                                 (slice_start(sl + 1) - slice_start(sl)) * C::D * 4, cluster_map(&xfull[x], sl));
          bulk_commit();
          bulk_wait_read<0>();
          mbar_arrive(&sent[x]);  // the consumers may stage tile j + NB
        }
    } else if (CL > 1) {  // warps 2-3: the sums of this block's slice of each tile's rows
      // thread rt sums float4 units rt, rt + 64, ..., each into its own slot
      // of Sum, all read before the buffer is released and stored after (in
      // registers they spilled, and the spills slowed the whole pass)
      const int rt = tid - 64, r0 = slice_start(rank), units = (slice_start(rank + 1) - r0) * (C::D / 4);
      auto sum_of = [&](const float* rx, int i) {  // unit i's sum over the cluster, rank order
        const int lr = i / (C::D / 4), col = 4 * (i % (C::D / 4));
        const float* at = rx + lr * C::D + kq_sw(r0 + lr, col);
        float4 a = *reinterpret_cast<const float4*>(at);
        for (int src = 1; src < CL; ++src) {
          const float4 y = *reinterpret_cast<const float4*>(at + src * RM * C::D);
          a = make_float4(a.x + y.x, a.y + y.y, a.z + y.z, a.w + y.w);
        }
        return a;
      };
      auto store = [&](int q0, int i, const float4& a) {
        const int lr = i / (C::D / 4), col = 4 * (i % (C::D / 4)), row = q0 + r0 + lr;
        if (row >= N) return;
        const long off = ((static_cast<long>(b) * N + row) * H + h) * C::D + col;
        *reinterpret_cast<uint32_t*>(dq + off) = pack_bf16(a.x, a.y);
        *reinterpret_cast<uint32_t*>(dq + off + 2) = pack_bf16(a.z, a.w);
      };
      for (int j = 0; j < n; ++j) {
        const int x = j % NB, q0 = (z + Z * j) * BQ;
        mbar_wait(&xfull[x], (j / NB) & 1);
        const float* rx = Rcv + x * C::XB;
        for (int i = rt; i < units; i += 64) reinterpret_cast<float4*>(Sum)[i] = sum_of(rx, i);
        named_bar_sync(4, 64);  // both warps have read the buffer
        if (tid < 96 && j + NB < n) {  // tile j + NB's bytes expected, then each block may send them
          if (lane == 0) mbar_expect_tx(&xfull[x], xbytes);
          __syncwarp();
          if (lane < CL) mbar_arrive_cluster(cluster_map(&xempty[x], lane));
        }
        for (int i = rt; i < units; i += 64) store(q0, i, reinterpret_cast<const float4*>(Sum)[i]);
      }
    }
  } else {
    setmaxnreg_inc<216>();
    const int wg = tid / 128 - 1, warp = (tid / 32) % 4, g = lane >> 2, t = lane & 3;
    const int kl = 64 * wg + 16 * warp + g;  // this thread's keys of the block: kl, kl + 8
    const int key0 = k0 + kl;
    const float c = scale * kLog2e;
    uint32_t kf[KS][4], vf[KS][4];  // this warp's k and v rows as A fragments
    float dk_acc[C::D / 2], dv_acc[C::D / 2];
    mbar_wait(kvfull, 0);
    load_a_frags<KS, BPL>(kf, Ks, kl);
    load_a_frags<KS, BPL>(vf, Vs, kl);
    for (int j = 0; j < n; ++j) {
      const int st = j % S, par = j & 1, q0 = (z + Z * j) * BQ;
      mbar_wait(&full[st], (j / S) & 1);
      const bf16* qt = Ring + st * 2 * C::QT;
      float s[BQ / 2], dp[BQ / 2];  // this warpgroup's keys x the tile's queries
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) wgmma_m64n64k16(s, kf[ks], desc_sw128_kmajor<BQ>(qt, ks), ks > 0);
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) wgmma_m64n64k16(dp, vf[ks], desc_sw128_kmajor<BQ>(qt + C::QT, ks), ks > 0);
      wgmma_commit();
      wgmma_wait0();
      reg_fence(s);
      reg_fence(dp);
      const float* sv = Stat + st * 2 * BQ;
#pragma unroll
      for (int jj = 0; jj < BQ / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 8 * jj + 2 * t + (e & 1);
          const float p = fast_exp2(fmaf(s[4 * jj + e], c, -sv[r]));
          const bool ok = key0 + 8 * (e >> 1) < M && q0 + r < N;
          s[4 * jj + e] = ok ? p : 0.f;
          dp[4 * jj + e] = ok ? p * (dp[4 * jj + e] - sv[BQ + r]) * scale : 0.f;
        }
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];  // bf16(p^T), bf16(dsim^T), 16 queries a k-step
      bf16* ds = Ds + par * C::DS;
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int q4 = 0; q4 < 4; ++q4) {
          pa[kk][q4] = pack_bf16(s[8 * kk + 2 * q4], s[8 * kk + 2 * q4 + 1]);
          da[kk][q4] = pack_bf16(dp[8 * kk + 2 * q4], dp[8 * kk + 2 * q4 + 1]);
          // key kl + 8 (q4 & 1), queries 16 kk + 8 (q4 >> 1) + 2 t ..
          *reinterpret_cast<uint32_t*>(ds + (2 * kk + (q4 >> 1)) * C::SPL + (kl + 8 * (q4 & 1)) * 8 + 2 * t) =
              da[kk][q4];
        }
      fence_proxy_async();  // dsim^T, read by the dq product
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_pv<C::D>(dv_acc, pa[kk], desc_sw128_mnmajor<BQ>(qt + C::QT, 16 * kk), j > 0 || kk > 0);
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_pv<C::D>(dk_acc, da[kk], desc_sw128_mnmajor<BQ>(qt, 16 * kk), j > 0 || kk > 0);
      wgmma_commit();
      named_bar_sync(1, 256);  // both warpgroups' dsim^T in ds
      float dqa[16];           // the tile's dq partial, columns 32 wg ..
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKqKB / 16; ++kk)
        wgmma_m64n32k16_ss_tt(dqa, desc_mnmajor<C::SPL>(ds, 16 * kk, 0), desc_mnmajor<BPL>(Ks, 16 * kk, 4 * wg),
                              kk > 0);
      wgmma_commit();
      wgmma_wait0();
      reg_fence(dk_acc);
      reg_fence(dv_acc);
      reg_fence(dqa);
      frag_fence(pa);
      frag_fence(da);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);  // q, dO and the statistics of the stage are free
      if (CL == 1) {  // one block covers the keys: the partial is dq (rows 16 warp + g (+ 8))
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = q0 + 16 * warp + g + 8 * r;
          if (row >= N) continue;
          bf16* dst = dq + ((static_cast<long>(b) * N + row) * H + h) * C::D + 32 * wg + 2 * t;
#pragma unroll
          for (int jc = 0; jc < 4; ++jc)
            *reinterpret_cast<uint32_t*>(dst + 8 * jc) = pack_bf16(dqa[4 * jc + 2 * r], dqa[4 * jc + 2 * r + 1]);
        }
        continue;
      }
      // rows 16 warp + g (+ 8), columns 32 wg .. of the partial into their
      // slices' slots of the staging buffer, once its copies of tile j - NB
      // have read it
      const int x = j % NB;
      if (j >= NB) mbar_wait(&sent[x], ((j / NB) & 1) ^ 1);
      float* sg = Stg + x * C::XB;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 16 * warp + g + 8 * r, sl = row * CL / BQ;
        float* at = sg + (sl * RM + row - slice_start(sl)) * C::D;
#pragma unroll
        for (int jc = 0; jc < 4; ++jc)
          *reinterpret_cast<float2*>(at + kq_sw(row, 32 * wg + 8 * jc + 2 * t)) =
              make_float2(dqa[4 * jc + 2 * r], dqa[4 * jc + 2 * r + 1]);
      }
      fence_proxy_async();  // the staged partial, read by the copy engine
      __syncwarp();
      if (lane == 0) mbar_arrive(&staged[x]);
    }
    const long E = static_cast<long>(gridDim.z / Z) * M * H * C::D;  // elements of dk (and dv)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r;
      if (key >= M) continue;
      const long off = ((static_cast<long>(b) * M + key) * H + h) * C::D + 2 * t;
#pragma unroll
      for (int jj = 0; jj < C::D / 8; ++jj) {
        // a block with no tiles (Z above the tile count) adds zeros
        const float2 k2 = n > 0 ? make_float2(dk_acc[4 * jj + 2 * r], dk_acc[4 * jj + 2 * r + 1])
                                : make_float2(0.f, 0.f);
        const float2 v2 = n > 0 ? make_float2(dv_acc[4 * jj + 2 * r], dv_acc[4 * jj + 2 * r + 1])
                                : make_float2(0.f, 0.f);
        if (Z == 1) {
          *reinterpret_cast<uint32_t*>(dk + off + 8 * jj) = pack_bf16(k2.x, k2.y);
          *reinterpret_cast<uint32_t*>(dv + off + 8 * jj) = pack_bf16(v2.x, v2.y);
        } else {
          *reinterpret_cast<float2*>(dkv_part + z * E + off + 8 * jj) = k2;
          *reinterpret_cast<float2*>(dkv_part + (Z + z) * E + off + 8 * jj) = v2;
        }
      }
    }
  }
  cluster_sync();  // no block leaves while another may still copy into its shared memory
}

// K3 (the rows pass writes lse2 and di, which the keys pass reads): the
// passes in turn, grids (N / 128, H, B) and (M / 128, H, B Z); kStats: the
// rows pass's statistics sweep alone (d 64, before attn_kq_kernel)
template <int D, bool kStats = false>
__global__ void __launch_bounds__(256, RkCfg<D>::MINB)
    attn_rows_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                     float* __restrict__ lse2, float* __restrict__ di, bf16* __restrict__ dq, int N,
                     int T, int H, float scale) {
  rows_pass<D, false, kStats>(&tq, &tdo, &tk, &tv, lse2, di, dq, N, T, H, scale, blockIdx.x, blockIdx.y,
                              blockIdx.z);
}

template <int D>
__global__ void __launch_bounds__(256, RkCfg<D>::MINB)
    attn_keys_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                     const float* __restrict__ lse2, const float* __restrict__ di,
                     float* __restrict__ dkv_part, bf16* __restrict__ dk, bf16* __restrict__ dv, int N,
                     int T, int H, int Z, float scale) {
  keys_pass<D>(&tq, &tdo, &tk, &tv, lse2, di, dkv_part, dk, dv, N, T, H, Z, gridDim.z / Z, scale, blockIdx.x,
               blockIdx.y, blockIdx.z);
}

// K4/K5 (lse2 and di given): both passes in one grid, its first
// ceil(M / 128) H B Z blocks the keys pass's (the longer blocks first),
// then ceil(N / 128) H B of the rows pass, so the two fill each other's
// last wave; tensor maps of the rows pass (q, dO rows of 128; k, v of 64 in
// the 128-byte swizzle) and of the keys pass (q, dO rows of 64 in the
// swizzle; k, v of 128)
template <int D>
__global__ void __launch_bounds__(256, RkCfg<D>::MINB)
    attn_rk_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tq64, const __grid_constant__ CUtensorMap tdo64,
                   const __grid_constant__ CUtensorMap tk128, const __grid_constant__ CUtensorMap tv128,
                   float* __restrict__ lse2, float* __restrict__ di, float* __restrict__ dkv_part,
                   bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv, int N, int M, int H,
                   int B, int Z, float scale) {
  const int kx = (M + kRkKB - 1) / kRkKB, keys = kx * H * B * Z;
  const int i = blockIdx.x;
  if (i < keys) {
    keys_pass<D>(&tq64, &tdo64, &tk128, &tv128, lse2, di, dkv_part, dk, dv, N, M, H, Z, B, scale, i % kx,
                 i / kx % H, i / kx / H);
  } else {
    const int rx = (N + 2 * kRkBQ - 1) / (2 * kRkBQ), r = i - keys;
    rows_pass<D, true>(&tq, &tdo, &tk, &tv, lse2, di, dq, N, M, H, scale, r % rx, r / rx % H, r / rx / H);
  }
}

// how many blocks split each key block's query tiles in the keys pass (Z,
// block_splits): [2, 2304, 8, 160] with 500 keys is 64 blocks of 128 keys
// for the H100's 132 SMs
static int attn_rk_splits(int B, int N, int M, int H, int D) {
  const long blocks = static_cast<long>((M + kRkKB - 1) / kRkKB) * H * B;
  return block_splits(blocks, (N + kRkBQ - 1) / kRkBQ, static_cast<double>(B) * M * H * D, kRkMaxSplits);
}

// K3 at d 64: the statistics sweep, the keys-major pass, then with Z > 1
// the ordered sums of dk's and dv's partials (dkv_part [2][Z][B, M, H, D]
// fp32)
static int launch_attn_kq(const void* q, const void* k, const void* v, const void* dout, void* lse2, void* di,
                          void* dkv_part, void* dq, void* dk, void* dv, int B, int N, int M, int H, int Z,
                          float scale, cudaStream_t stream) {
  constexpr int D = 64;
  const int cl = (M + kKqKB - 1) / kKqKB;
  const long E = static_cast<long>(B) * M * H * D;
  if (cl > kKqMaxCluster || Z < 1 || Z > kRkMaxSplits || (Z > 1 && dkv_part == nullptr)) return -1;
  float *lp = static_cast<float*>(lse2), *dp = static_cast<float*>(di), *part = static_cast<float*>(dkv_part);
  bf16 *gq = static_cast<bf16*>(dq), *gk = static_cast<bf16*>(dk), *gv = static_cast<bf16*>(dv);
  // the statistics sweep's maps: q, dO rows of 128; k, v of 64 (swizzle);
  // the pass's: q, dO rows of 64 (128-byte swizzle); k, v of 128
  CUtensorMap tq, tdo, tk, tv, tq64, tdo64, tk128, tv128;
  int e = encode_rows_map(&tq, q, B, N, H, D, 2 * kRkBQ);
  if (e == 0) e = encode_rows_map(&tdo, dout, B, N, H, D, 2 * kRkBQ);
  if (e == 0) e = encode_rows_map(&tk, k, B, M, H, D, kRkKT, true);
  if (e == 0) e = encode_rows_map(&tv, v, B, M, H, D, kRkKT, true);
  if (e == 0) e = encode_rows_map(&tq64, q, B, N, H, D, kKqBQ, true);
  if (e == 0) e = encode_rows_map(&tdo64, dout, B, N, H, D, kKqBQ, true);
  if (e == 0) e = encode_rows_map(&tk128, k, B, M, H, D, kKqKB);
  if (e == 0) e = encode_rows_map(&tv128, v, B, M, H, D, kKqKB);
  if (e != 0) return e;
  cudaError_t err = cudaFuncSetAttribute(attn_rows_kernel<D, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)RkCfg<D>::bytes);
  if (err != cudaSuccess) return (int)err;
  attn_rows_kernel<D, true><<<dim3((N + 2 * kRkBQ - 1) / (2 * kRkBQ), H, B), 256, RkCfg<D>::bytes, stream>>>(
      tq, tdo, tk, tv, lp, dp, gq, N, M, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attn_kq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)KqCfg::bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl, H, B * Z);
  cfg.blockDim = dim3(kKqThreads);
  cfg.dynamicSmemBytes = KqCfg::bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, attn_kq_kernel, tq64, tdo64, tk128, tv128, static_cast<const float*>(lp),
                           static_cast<const float*>(dp), part, gq, gk, gv, N, M, H, Z, cl, scale);
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaGetLastError()) != cudaSuccess || Z == 1) return (int)err;
  if ((e = launch_partial_sum(part, gk, E, Z, E, E, 0, stream)) != 0) return e;
  return launch_partial_sum(part + Z * E, gv, E, Z, E, E, 0, stream);
}

// the rows and keys passes (and, with Z > 1, the sums of dk's and dv's
// partials in dkv_part, [2][Z][B, M, H, D] fp32). kGiven: lse2 and di
// [B,H,N] are the caller's, and both passes run as one grid; else the rows
// pass writes them, then the keys pass runs. K3 at d 64 takes the
// keys-major pass instead (launch_attn_kq).
template <int D, bool kGiven>
static int launch_attn_rk(const void* q, const void* k, const void* v, const void* dout, void* lse2,
                          void* di, void* dkv_part, void* dq, void* dk, void* dv, int B, int N, int M,
                          int H, int Z, float scale, cudaStream_t stream) {
  if constexpr (D == 64 && !kGiven) {
    return launch_attn_kq(q, k, v, dout, lse2, di, dkv_part, dq, dk, dv, B, N, M, H, Z, scale, stream);
  } else {
    using C = RkCfg<D>;
    if (Z < 1 || Z > kRkMaxSplits || (Z > 1 && dkv_part == nullptr)) return -1;
    // the rows pass: q and dO in boxes of 128 rows, k and v of 64 (128-byte
    // swizzle); the keys pass: q and dO of 64 (swizzle), k and v of 128
    CUtensorMap tq, tdo, tk, tv, tq64, tdo64, tk128, tv128;
    int e = encode_rows_map(&tq, q, B, N, H, D, 2 * kRkBQ);
    if (e == 0) e = encode_rows_map(&tdo, dout, B, N, H, D, 2 * kRkBQ);
    if (e == 0) e = encode_rows_map(&tk, k, B, M, H, D, kRkKT, true);
    if (e == 0) e = encode_rows_map(&tv, v, B, M, H, D, kRkKT, true);
    if (e == 0) e = encode_rows_map(&tk128, k, B, M, H, D, kRkKB);
    if (e == 0) e = encode_rows_map(&tv128, v, B, M, H, D, kRkKB);
    if (e == 0) e = encode_rows_map(&tq64, q, B, N, H, D, kRkBQ, true);
    if (e == 0) e = encode_rows_map(&tdo64, dout, B, N, H, D, kRkBQ, true);
    if (e != 0) return e;
    float *lp = static_cast<float*>(lse2), *dp = static_cast<float*>(di), *part = static_cast<float*>(dkv_part);
    bf16 *gq = static_cast<bf16*>(dq), *gk = static_cast<bf16*>(dk), *gv = static_cast<bf16*>(dv);
    const int rows = (N + 2 * kRkBQ - 1) / (2 * kRkBQ), kx = (M + kRkKB - 1) / kRkKB;
    cudaError_t err;
    if constexpr (kGiven) {
      err = cudaFuncSetAttribute(attn_rk_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::bytes);
      if (err != cudaSuccess) return (int)err;
      attn_rk_kernel<D><<<(kx * Z + rows) * H * B, 256, C::bytes, stream>>>(
          tq, tdo, tk, tv, tq64, tdo64, tk128, tv128, lp, dp, part, gq, gk, gv, N, M, H, B, Z, scale);
    } else {
      err = cudaFuncSetAttribute(attn_rows_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::bytes);
      if (err != cudaSuccess) return (int)err;
      attn_rows_kernel<D><<<dim3(rows, H, B), 256, C::bytes, stream>>>(tq, tdo, tk, tv, lp, dp, gq, N, M, H, scale);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      err = cudaFuncSetAttribute(attn_keys_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::bytes);
      if (err != cudaSuccess) return (int)err;
      attn_keys_kernel<D><<<dim3(kx, H, B * Z), 256, C::bytes, stream>>>(tq64, tdo64, tk128, tv128, lp, dp, part,
                                                                          gk, gv, N, M, H, Z, scale);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess || Z == 1) return (int)err;
    const long E = static_cast<long>(B) * M * H * D;
    if ((e = launch_partial_sum(part, gk, E, Z, E, E, 0, stream)) != 0) return e;
    return launch_partial_sum(part + Z * E, gv, E, Z, E, E, 0, stream);
  }
}

}  // namespace skp
