// Attention backward shared by K4/K5 (flash.cu) and K3 at d 64 and 80
// (cross_attn.cu; at d 40 and 160 K3 runs its own rows and keys passes),
// sm_90a.
//
// Replaces the backward kernels of stablekeypoints_tpu/kernels/cross_attn.py
// (_cross_bwd, pallas_call at :174) and of JAX's stock Pallas TPU flash
// attention that kernels/flash.py calls (its dkv and dq kernels). With the
// per-row statistics of the forward softmax given,
//
//   lse2[r] = log2 sum_t exp2(s[r,t])      s = q.k^T * scale * log2(e)
//   di[r]   = sum_t p[r,t] * dp[r,t]       dp = dO . v^T
//
// the kernel recomputes p = exp2(s - lse2) per tile and
//
//   dsim = p * (dp - di) * scale, rounded to bf16
//   dq   = dsim . k        dk = dsim^T . q        dv = bf16(p)^T . dO
//
// with fp32 accumulation, as the TPU kernels round. The TPU kernels carried
// dk and dv across a sequential grid axis; on Hopper blocks run in no
// order, so the work splits as in FlashAttention-2/3's single pass: one
// block (one warpgroup) per (b, h, 64 keys) walks every 64-row query tile
// with the keys as the rows of the products. Per tile, five wgmma products
// and one exponential per score:
//   s^T  = k . q^T, dp^T = v . dO^T    m64n64k16, k, v, q, dO from shared
//   dv  += bf16(p)^T . dO              m64nDk16, p^T from registers, dO MN-major
//   dk  += bf16(dsim)^T . q            m64nDk16, dsim^T from registers, q MN-major
//   dq_t = bf16(dsim) . k              m64nDk16, dsim^T through shared memory,
//                                       both operands MN-major
// dk and dv stay in registers and are written once. Each tile's dq (fp32)
// is added into an fp32 [B,H,N,D] accumulator by one bulk reduce-add of its
// 64 contiguous rows (the TMA unit adds in L2), and dq_convert_kernel then
// rounds it to bf16 in the [B,N,H,D] layout. The blocks' additions land in
// no fixed order, so dq's fp32 sum is not bitwise reproducible from run to
// run (dk and dv are); the bf16 dq agrees with the plain version within the
// same 2^-6 of its largest magnitude. Query and dO tiles stream through a
// 3-stage ring, two tiles ahead, copied by TMA (one thread, one box per
// 8-column chunk, on the stage's mbarrier; lse2 and di by cp.async): on an
// H100 the copies were a third of the time of a version whose threads
// copied with cp.async. Keys >= M and query rows >= N are masked to p = 0. Head dims
// that are not multiples of 16 (40) are zero-padded in shared memory for
// the q.k and dO.v products.
//
// Bound on the H100: operations (5 products of 2*N*M*D FLOP; the fp32
// exponential and the dsim arithmetic per score come next at d 40). The
// split into a dkdv and a dq kernel that this replaces computed s and dp
// in both (7 products, two exponentials per score).
//
// d 64 (SD-2.x, SDXL) has a warp-specialized form of the same pass,
// attn_bwd_ws_kernel: a block holds 128 keys as two consumer warpgroups of
// 64 (each keeps its keys' dk and dv in registers) and one producer warp.
// The producer's first lane starts the TMA copies of k and v once and of
// each query tile's q and dO (one box of 128-byte rows each, 128-byte
// swizzle) into a 4-stage ring (full / empty mbarriers); its 32 lanes copy
// the tile's lse2 and di and arrive on the stage's full barrier. Both
// warpgroups read each q / dO tile, so a tile crosses L2 once per 128 keys,
// and each writes its dsim^T into one shared [128 keys][64] tile; after a
// named barrier of the 256 consumer threads warpgroup w forms dq's columns
// 32w .. 32w + 31 over all 128 keys (m64n32k16, both operands MN-major), and
// one bulk reduce-add a tile adds the block's dq: half the q / dO reads and
// half the reduce-adds of the one-warpgroup block, and two named barriers a
// tile in place of three block barriers. Where a (b, h) has few key blocks
// (500 keys: 4) the grid would leave SMs idle, and each key block's query
// tiles split over Z blocks whose fp32 partial dk and dv a second pass sums
// in a fixed order (attn_bwd_splits). On the H100 (700 W,
// tools/attention_variants.py --d64): 3.72 ms at [4, 9216, 5, 64] where the
// one-warpgroup block took 4.43 (SDPA 2.29), without the reduce-add 3.47,
// without the exponentials 3.57, without the q / dO copies 3.68: the tile's
// chain (products, softmax, products, barrier, dq, barrier) runs in step in
// both warpgroups. Tried and slower: each warpgroup adding its own keys' dq
// (5.01), the two taking turns at whole tiles' dq (4.30), dv's product
// issued before dsim is formed (4.53, spills), the next tile's scores in
// flight under this tile's dq (5.03 with p^T through shared memory, 4.63
// with p and dsim in registers: ptxas serialized every wgmma, C7518 "WG.DP
// in divergent path", and spilled).
#pragma once

#include "common.cuh"

namespace skp {

constexpr int kBwdBQ = 64;     // query rows per tile
constexpr int kBwdStages = 3;  // query tiles in the ring: the current one, 2 loading
constexpr int kBwdBK = 64;     // keys per block: the 64 rows of one warpgroup

template <int D>
struct BwdCfg {
  static constexpr int DP = round_up16(D);
  static constexpr int KS = DP / 16;
  static constexpr int QPL = kBwdBQ * 8;  // q and dO planes, as TMA writes them
  static constexpr int QT = DP / 8 * QPL;  // a chunk-major [BQ][DP] q or dO tile
  static constexpr int KT = DP / 8 * plane_ld(kBwdBK);      // k, v
  static constexpr int ST = kBwdBQ / 8 * plane_ld(kBwdBK);  // dsim^T [BK keys][BQ]
  // q, dO [stage]; dq fp32 [BQ][D]; lse2, di [stage][BQ]; k, v; dsim^T;
  // an mbarrier per stage
  static constexpr size_t bytes = sizeof(bf16) * (2 * kBwdStages * QT + 2 * KT + ST) +
                                  sizeof(float) * (kBwdBQ * D + 2 * kBwdStages * kBwdBQ) +
                                  sizeof(uint64_t) * kBwdStages;
};

// q, dout [B,N,H,D]; k, v [B,M,H,D]; lse2, di [B,H,N] -> dk, dv [B,M,H,D];
// dq_acc [B,H,N,D] fp32 (zeroed by the caller) += dq
template <int D>
__global__ void __launch_bounds__(128)
    attn_bwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                    const bf16* __restrict__ k, const bf16* __restrict__ v,
                    const float* __restrict__ lse2, const float* __restrict__ di,
                    float* __restrict__ dq_acc, bf16* __restrict__ dk, bf16* __restrict__ dv,
                    int N, int M, int H, float scale) {
  using C = BwdCfg<D>;
  constexpr int DP = C::DP, KS = C::KS, BK = kBwdBK, NT = 128, QT = C::QT, QPL = C::QPL;
  constexpr int KPL = plane_ld(BK);
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);                  // [stage] tiles
  bf16* Os = Qs + kBwdStages * QT;                           // [stage] tiles, dO
  float* Dq = reinterpret_cast<float*>(Os + kBwdStages * QT);  // [BQ][D]
  float* Ls = Dq + kBwdBQ * D;                               // [stage][BQ]
  float* Ds = Ls + kBwdStages * kBwdBQ;                      // [stage][BQ]
  bf16* Ks = reinterpret_cast<bf16*>(Ds + kBwdStages * kBwdBQ);
  bf16* Vs = Ks + C::KT;
  bf16* St = Vs + C::KT;  // dsim^T, chunk-major: [BQ / 8][BK][8]
  uint64_t* full = reinterpret_cast<uint64_t*>(St + C::ST);  // [stage]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * BK;
  const float c = scale * kLog2e;
  const long row = static_cast<long>(H) * D;
  const long kv_off = (static_cast<long>(b) * M + k0) * row + h * D;
  const long bh = static_cast<long>(b) * H + h;
  const float* lse_bh = lse2 + bh * N;
  const float* di_bh = di + bh * N;

  load_chunked_async<DP / 8, BK>(Ks, k + kv_off, row, min(BK, M - k0), D, tid, NT);
  load_chunked_async<DP / 8, BK>(Vs, v + kv_off, row, min(BK, M - k0), D, tid, NT);
  for (int st = 0; st < kBwdStages; ++st) {  // d 40: the padding columns 40..47
    zero_chunks<kBwdBQ, QPL>(Qs + st * QT, D / 8, DP / 8, tid, NT);
    zero_chunks<kBwdBQ, QPL>(Os + st * QT, D / 8, DP / 8, tid, NT);
  }
  if (tid == 0) {
    for (int st = 0; st < kBwdStages; ++st) mbar_init(&full[st], 1);
    mbar_fence_init();
  }
  __syncthreads();
  // q and dO of a query tile by TMA (one thread; rows past N arrive as
  // zeros), lse2 and di by cp.async
  auto issue = [&](int tile) {
    const int q0 = tile * kBwdBQ, st = tile % kBwdStages, valid = min(kBwdBQ, N - q0);
    if (tid == 0) {
      mbar_expect_tx(&full[st], 2 * (D / 8) * kBwdBQ * 16);
      for (int ch = 0; ch < D / 8; ++ch) {
        tma_load_4d(Qs + st * QT + ch * QPL, &tq, 8 * ch, h, q0, b, &full[st]);
        tma_load_4d(Os + st * QT + ch * QPL, &tdo, 8 * ch, h, q0, b, &full[st]);
      }
    }
    if (tid < kBwdBQ) {
      cp_async4(Ls + st * kBwdBQ + tid, lse_bh + q0 + min(tid, valid - 1), tid < valid);
      cp_async4(Ds + st * kBwdBQ + tid, di_bh + q0 + min(tid, valid - 1), tid < valid);
    }
  };
  const int tiles = (N + kBwdBQ - 1) / kBwdBQ;
  for (int i = 0; i < kBwdStages - 1; ++i) {  // one commit group per tile, k and v with the first
    if (i < tiles) issue(i);
    cp_async_commit();
  }
  cp_async_wait_all();  // k and v, read by wgmma
  fence_proxy_async();

  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int it = 0; it < tiles; ++it) {
    if (tid == 0) bulk_wait_read0();  // the last tile's dq has left shared memory
    cp_async_wait<kBwdStages - 2>();  // lse2 and di of tile `it`
    __syncthreads();  // ... visible; every warp is done with tile it - 1's stage
    if (it + kBwdStages - 1 < tiles) issue(it + kBwdStages - 1);
    cp_async_commit();
    const int st = it % kBwdStages, q0 = it * kBwdBQ;
    mbar_wait(&full[st], (it / kBwdStages) & 1);  // q and dO of tile `it`
    const bf16* qt = Qs + st * QT;
    const bf16* ot = Os + st * QT;
    const float* lt = Ls + st * kBwdBQ;
    const float* dt = Ds + st * kBwdBQ;

    float s[32], dp[32];  // keys x queries
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      wgmma_m64n64k16_ss(s, desc_kmajor<KPL>(Ks, 0, 2 * ks), desc_kmajor<QPL>(qt, 0, 2 * ks),
                         ks > 0);
    wgmma_commit();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      wgmma_m64n64k16_ss(dp, desc_kmajor<KPL>(Vs, 0, 2 * ks), desc_kmajor<QPL>(ot, 0, 2 * ks),
                         ks > 0);
    wgmma_commit();
    wgmma_wait1();
    reg_fence(s);
    const bool edge = q0 + kBwdBQ > N || k0 + BK > M;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1);
        const float p = fast_exp2(fmaf(s[4 * j + e], c, -lt[col]));
        s[4 * j + e] = edge && (key[e >> 1] >= M || q0 + col >= N) ? 0.f : p;
      }
    wgmma_wait0();
    reg_fence(dp);
    uint32_t pa[4][4], da[4][4];  // bf16(p)^T, bf16(dsim)^T as A fragments
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e0 = 8 * kk + 2 * i, col = 16 * kk + 8 * (i >> 1) + 2 * t;
        pa[kk][i] = pack_bf16(s[e0], s[e0 + 1]);
        da[kk][i] = pack_bf16(s[e0] * (dp[e0] - dt[col]) * scale,
                              s[e0 + 1] * (dp[e0 + 1] - dt[col + 1]) * scale);
        // dsim^T row (key) 16 warp + g + 8 (i & 1), queries col, col + 1
        *reinterpret_cast<uint32_t*>(St + (col / 8) * KPL + (16 * warp + g + 8 * (i & 1)) * 8 +
                                     2 * t) = da[kk][i];
      }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_pv<D>(dv_acc, pa[kk], desc_mnmajor<QPL>(ot, 16 * kk, 0), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_pv<D>(dk_acc, da[kk], desc_mnmajor<QPL>(qt, 16 * kk, 0), 1);
    wgmma_commit();
    fence_proxy_async();
    __syncthreads();  // dsim^T of all four warps in shared memory
    float dq[D / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_pv_ss<D>(dq, desc_mnmajor<KPL>(St, 16 * kk, 0), desc_mnmajor<KPL>(Ks, 16 * kk, 0), kk > 0);
    wgmma_commit();
    wgmma_wait0();
    reg_fence(dq);
    reg_fence(dk_acc);
    reg_fence(dv_acc);
    frag_fence(pa);
    frag_fence(da);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(Dq + (16 * warp + g + 8 * r) * D + 8 * j + 2 * t) =
            make_float2(dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]);
    fence_proxy_async();
    __syncthreads();  // the tile's dq rows in shared memory
    if (tid == 0) {
      bulk_reduce_add_f32(dq_acc + (bh * N + q0) * D, Dq, min(kBwdBQ, N - q0) * D * 4);
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait0();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= M) continue;
    const long off = (static_cast<long>(b) * M + key[r]) * row + h * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dk + off + 8 * j) =
          pack_bf16(dk_acc[4 * j + 2 * r], dk_acc[4 * j + 2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + 8 * j) =
          pack_bf16(dv_acc[4 * j + 2 * r], dv_acc[4 * j + 2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// d 64: the warp-specialized block (header note)

constexpr int kBwdWsBK = 128;        // keys per block: 64 per consumer warpgroup
constexpr int kBwdWsStages = 4;      // q / dO tiles in the ring
constexpr int kBwdWsThreads = 288;   // two consumer warpgroups and the producer warp

template <int D>
struct BwdWsCfg {
  static_assert(D == 64, "attn_bwd_ws_kernel: one 128-byte swizzle block a q / dO row");
  static constexpr int QT = kBwdBQ * D;             // a q or dO tile, 128-byte swizzle
  static constexpr int KPL = kBwdWsBK * 8;          // k and v planes (TMA boxes of 128 rows)
  static constexpr int KT = D / 8 * KPL;            // chunk-major k or v
  static constexpr int SPL = plane_ld(kBwdWsBK);    // dsim^T [128 keys][64 queries]
  static constexpr int ST = kBwdBQ / 8 * SPL;
  // q, dO [stage]; k, v; dsim^T; dq fp32 [BQ][D]; lse2, di [stage][BQ];
  // mbarriers full, empty [stage] and k / v
  static constexpr size_t bytes = sizeof(bf16) * (2 * kBwdWsStages * QT + 2 * KT + ST) +
                                  sizeof(float) * (kBwdBQ * D + 2 * kBwdWsStages * kBwdBQ) +
                                  sizeof(uint64_t) * (2 * kBwdWsStages + 1);
};

// as attn_bwd_kernel, with k and v through tensor maps too. Z > 1 splits
// each key block's query tiles over Z blocks (blockIdx.z = b * Z + z walks
// tiles z, z + Z, ...), which write fp32 partial dk and dv into
// dkv_part [2][Z][B, M, H, D] for dkv_sum_kernel
template <int D>
__global__ void __launch_bounds__(kBwdWsThreads, 1)
    attn_bwd_ws_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                       const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                       const float* __restrict__ lse2, const float* __restrict__ di,
                       float* __restrict__ dq_acc, float* __restrict__ dkv_part,
                       bf16* __restrict__ dk, bf16* __restrict__ dv, int N, int M, int H, int Z,
                       float scale) {
  using C = BwdWsCfg<D>;
  constexpr int BQ = kBwdBQ, BK = kBwdWsBK, S = kBwdWsStages, KS = D / 16, SPL = C::SPL;
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);          // [stage] [BQ][D], 128-byte swizzle
  bf16* Os = Qs + S * C::QT;                          // [stage] dO, the same
  bf16* Ks = Os + S * C::QT;                          // chunk-major [BK][D]
  bf16* Vs = Ks + C::KT;
  bf16* St = Vs + C::KT;                              // dsim^T, chunk-major [BQ / 8][BK][8]
  float* Dq = reinterpret_cast<float*>(St + C::ST);   // [BQ][D]
  float* Ls = Dq + BQ * D;                            // [stage][BQ]
  float* Ds = Ls + S * BQ;                            // [stage][BQ]
  uint64_t* full = reinterpret_cast<uint64_t*>(Ds + S * BQ);  // [stage]
  uint64_t* empty = full + S;                                 // [stage]
  uint64_t* kv_full = empty + S;

  const int tid = threadIdx.x, lane = tid % 32;
  const int b = blockIdx.z / Z, z = blockIdx.z % Z, h = blockIdx.y, k0 = blockIdx.x * BK;
  const long bh = static_cast<long>(b) * H + h;
  const int tiles = (N + BQ - 1) / BQ;
  if (tid == 0) {
    for (int st = 0; st < S; ++st) {
      mbar_init(&full[st], 32);  // the producer warp's lanes (the first with the copies' bytes)
      mbar_init(&empty[st], 8);  // one arrival per consumer warp
    }
    mbar_init(kv_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 256) {  // the producer warp
    if (lane == 0) {  // k and v of the block's keys (keys past M arrive as zeros)
      mbar_expect_tx(kv_full, 2 * (D / 8) * BK * 16);
      for (int ch = 0; ch < D / 8; ++ch) {
        tma_load_4d(Ks + ch * C::KPL, &tk, 8 * ch, h, k0, b, kv_full);
        tma_load_4d(Vs + ch * C::KPL, &tv, 8 * ch, h, k0, b, kv_full);
      }
    }
    for (int it = z, n = 0; it < tiles; it += Z, ++n) {  // n: this block's tiles so far
      const int st = n % S, q0 = it * BQ;
      if (n >= S) mbar_wait(&empty[st], (n / S - 1) & 1);  // the stage's last tile fully read
      for (int r = lane; r < BQ; r += 32) {  // rows past N: 0 (masked to p = 0)
        const bool ok = q0 + r < N;
        Ls[st * BQ + r] = ok ? lse2[bh * N + q0 + r] : 0.f;
        Ds[st * BQ + r] = ok ? di[bh * N + q0 + r] : 0.f;
      }
      if (lane == 0) {  // q and dO, a box each (rows past N arrive as zeros)
        mbar_expect_tx(&full[st], 2 * BQ * D * 2);
        tma_load_4d(Qs + st * C::QT, &tq, 0, h, q0, b, &full[st]);
        tma_load_4d(Os + st * C::QT, &tdo, 0, h, q0, b, &full[st]);
      } else {
        mbar_arrive(&full[st]);
      }
    }
    return;
  }

  const int wg = tid / 128, warp = (tid / 32) % 4, g = lane >> 2, t = lane & 3;
  const int kw = 64 * wg;  // this warpgroup's keys in the block
  const float c = scale * kLog2e;
  const int key[2] = {k0 + kw + warp * 16 + g, k0 + kw + warp * 16 + g + 8};
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  mbar_wait(kv_full, 0);

  for (int it = z, n = 0; it < tiles; it += Z, ++n) {
    const int st = n % S, q0 = it * BQ;
    mbar_wait(&full[st], (n / S) & 1);  // q, dO, lse2 and di of tile `it`
    const bf16* qt = Qs + st * C::QT;
    const bf16* ot = Os + st * C::QT;
    const float* lt = Ls + st * BQ;
    const float* dt = Ds + st * BQ;

    float s[32], dp[32];  // this warpgroup's keys x the tile's queries
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      wgmma_m64n64k16_ss(s, desc_kmajor<C::KPL>(Ks, kw, 2 * ks), desc_sw128_kmajor<BQ>(qt, ks),
                         ks > 0);
    wgmma_commit();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      wgmma_m64n64k16_ss(dp, desc_kmajor<C::KPL>(Vs, kw, 2 * ks), desc_sw128_kmajor<BQ>(ot, ks),
                         ks > 0);
    wgmma_commit();
    wgmma_wait1();
    reg_fence(s);
    const bool edge = q0 + BQ > N || k0 + kw + 64 > M;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1);
        const float p = fast_exp2(fmaf(s[4 * j + e], c, -lt[col]));
        s[4 * j + e] = edge && (key[e >> 1] >= M || q0 + col >= N) ? 0.f : p;
      }
    wgmma_wait0();
    reg_fence(dp);
    uint32_t pa[4][4], da[4][4];  // bf16(p)^T, bf16(dsim)^T as A fragments
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e0 = 8 * kk + 2 * i, col = 16 * kk + 8 * (i >> 1) + 2 * t;
        pa[kk][i] = pack_bf16(s[e0], s[e0 + 1]);
        da[kk][i] = pack_bf16(s[e0] * (dp[e0] - dt[col]) * scale,
                              s[e0 + 1] * (dp[e0 + 1] - dt[col + 1]) * scale);
        // dsim^T row (key) kw + 16 warp + g + 8 (i & 1), queries col, col + 1
        *reinterpret_cast<uint32_t*>(St + (col / 8) * SPL +
                                     (kw + 16 * warp + g + 8 * (i & 1)) * 8 + 2 * t) = da[kk][i];
      }
    // dv += bf16(p)^T . dO, dk += bf16(dsim)^T . q (q, dO MN-major)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_pv<D>(dv_acc, pa[kk], desc_sw128_mnmajor<BQ>(ot, 16 * kk), 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_pv<D>(dk_acc, da[kk], desc_sw128_mnmajor<BQ>(qt, 16 * kk), 1);
    wgmma_commit();
    if (tid == 0) bulk_wait_read0();  // the last tile's dq has left Dq
    fence_proxy_async();
    named_bar_sync(1, 256);  // dsim^T of both warpgroups in St, Dq free
    // dq[:, 32 wg ..] = bf16(dsim) . k over the block's 128 keys
    float dq[D / 4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_m64n32k16_ss_tt(dq, desc_mnmajor<SPL>(St, 16 * kk, 0),
                            desc_mnmajor<C::KPL>(Ks, 16 * kk, wg * D / 16), kk > 0);
    wgmma_commit();
    wgmma_wait0();
    reg_fence(dq);
    reg_fence(dk_acc);
    reg_fence(dv_acc);
    frag_fence(pa);
    frag_fence(da);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);  // this warp is done with the stage
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < D / 16; ++j)
        *reinterpret_cast<float2*>(Dq + (16 * warp + g + 8 * r) * D + D / 2 * wg + 8 * j + 2 * t) =
            make_float2(dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]);
    fence_proxy_async();
    named_bar_sync(2, 256);  // the tile's dq in Dq
    if (tid == 0) {
      bulk_reduce_add_f32(dq_acc + (bh * N + q0) * D, Dq, min(BQ, N - q0) * D * 4);
      bulk_commit();
    }
  }
  if (tid == 0) bulk_wait0();

  const long E = static_cast<long>(gridDim.z / Z) * M * H * D;  // elements of dk (and dv)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= M) continue;
    const long off = (static_cast<long>(b) * M + key[r]) * H * D + h * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (Z == 1) {
        *reinterpret_cast<uint32_t*>(dk + off + 8 * j) =
            pack_bf16(dk_acc[4 * j + 2 * r], dk_acc[4 * j + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dv + off + 8 * j) =
            pack_bf16(dv_acc[4 * j + 2 * r], dv_acc[4 * j + 2 * r + 1]);
      } else {
        *reinterpret_cast<float2*>(dkv_part + z * E + off + 8 * j) =
            make_float2(dk_acc[4 * j + 2 * r], dk_acc[4 * j + 2 * r + 1]);
        *reinterpret_cast<float2*>(dkv_part + (Z + z) * E + off + 8 * j) =
            make_float2(dv_acc[4 * j + 2 * r], dv_acc[4 * j + 2 * r + 1]);
      }
    }
  }
}

// dk, dv bf16 <- the sums of their Z fp32 partials (attn_bwd_ws_kernel),
// in the order z = 0, 1, ..., so bitwise the same from run to run; 4 values
// a thread
__global__ void dkv_sum_kernel(const float* __restrict__ part, bf16* __restrict__ dk,
                               bf16* __restrict__ dv, long E, int Z) {
  const long i = (static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (i >= E) return;
  for (int w = 0; w < 2; ++w) {
    float4 a = *reinterpret_cast<const float4*>(part + w * Z * E + i);
    for (int z = 1; z < Z; ++z) {
      const float4 x = *reinterpret_cast<const float4*>(part + (w * Z + z) * E + i);
      a = make_float4(a.x + x.x, a.y + x.y, a.z + x.z, a.w + x.w);
    }
    bf16* dst = (w == 0 ? dk : dv) + i;
    *reinterpret_cast<uint32_t*>(dst) = pack_bf16(a.x, a.y);
    *reinterpret_cast<uint32_t*>(dst + 2) = pack_bf16(a.z, a.w);
  }
}

// how many blocks split each key block's query tiles (attn_bwd_ws_kernel's
// Z, block_splits): at the learned tokens' 500 keys a (b, h) has only 4 key
// blocks, and [2, 4096, 10, 64] fills 80 of the 132 SMs. On the H100 a split
// took K3's backward at [4, 4096, 10, 64] from 0.449 to 0.363 ms, and an
// uncosted split of K5's [4, 1024, 20, 64] lost 8% (tools/attention_variants.py
// --d64, no_split). 1 at d != 64.
static int attn_bwd_splits(int B, int N, int M, int H, int D) {
  if (D != 64) return 1;
  const long blocks = static_cast<long>((M + kBwdWsBK - 1) / kBwdWsBK) * H * B;
  return block_splits(blocks, (N + kBwdBQ - 1) / kBwdBQ, static_cast<double>(B) * M * H * D, 8);
}

// dq [B,N,H,D] bf16 <- dq_acc [B,H,N,D] fp32, 8 values per thread
__global__ void dq_convert_kernel(const float* __restrict__ acc, bf16* __restrict__ dq, int N,
                                  int H, int D, long chunks) {
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= chunks) return;
  const int per_row = D / 8;
  const long c = i % per_row, bnh = i / per_row;  // (b, n, h) row of dq
  const long h = bnh % H, n = (bnh / H) % N, b = bnh / (static_cast<long>(H) * N);
  const float4* src = reinterpret_cast<const float4*>(acc + ((b * H + h) * N + n) * D + 8 * c);
  const float4 x = src[0], y = src[1];
  uint4 o;
  o.x = pack_bf16(x.x, x.y);
  o.y = pack_bf16(x.z, x.w);
  o.z = pack_bf16(y.x, y.y);
  o.w = pack_bf16(y.z, y.w);
  *reinterpret_cast<uint4*>(dq + bnh * D + 8 * c) = o;
}

// a split count the launch takes: 1, or more at d 64 with the partials' scratch
static bool bwd_splits_ok(int D, int Z, const void* dkv_part) {
  return Z == 1 || (Z > 1 && D == 64 && dkv_part != nullptr);
}

// the backward kernel and dq's conversion, after the caller has written
// lse2 and di and zeroed dq_acc; d 64 with Z > 1 (attn_bwd_splits): the
// partial dk and dv in dkv_part ([2][Z][B, M, H, D] fp32) and their sum
template <int D>
static int launch_attn_bwd(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                           const float* lse2, const float* di, float* dq_acc, float* dkv_part,
                           bf16* dq, bf16* dk, bf16* dv, int B, int N, int M, int H, int Z,
                           float scale, cudaStream_t stream) {
  CUtensorMap tq, tdo;  // d 64: one box of 128-byte rows a tile
  int e = encode_rows_map(&tq, q, B, N, H, D, kBwdBQ, D == 64);
  if (e == 0) e = encode_rows_map(&tdo, dout, B, N, H, D, kBwdBQ, D == 64);
  if (e != 0) return e;
  cudaError_t err;
  if constexpr (D == 64) {  // the warp-specialized block of 128 keys
    using C = BwdWsCfg<D>;
    CUtensorMap tk, tv;
    e = encode_rows_map(&tk, k, B, M, H, D, kBwdWsBK);
    if (e == 0) e = encode_rows_map(&tv, v, B, M, H, D, kBwdWsBK);
    if (e != 0) return e;
    err = cudaFuncSetAttribute(attn_bwd_ws_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)C::bytes);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((M + kBwdWsBK - 1) / kBwdWsBK, H, B * Z);
    attn_bwd_ws_kernel<D><<<grid, kBwdWsThreads, C::bytes, stream>>>(
        tq, tdo, tk, tv, lse2, di, dq_acc, dkv_part, dk, dv, N, M, H, Z, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (Z > 1) {
      const long E = static_cast<long>(B) * M * H * D;
      dkv_sum_kernel<<<(unsigned)((E / 4 + 255) / 256), 256, 0, stream>>>(dkv_part, dk, dv, E, Z);
    }
  } else {
    using C = BwdCfg<D>;
    err = cudaFuncSetAttribute(attn_bwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)C::bytes);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((M + kBwdBK - 1) / kBwdBK, H, B);
    attn_bwd_kernel<D><<<grid, 128, C::bytes, stream>>>(tq, tdo, k, v, lse2, di, dq_acc, dk, dv,
                                                        N, M, H, scale);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long chunks = static_cast<long>(B) * N * H * (D / 8);
  dq_convert_kernel<<<(unsigned)((chunks + 255) / 256), 256, 0, stream>>>(
      dq_acc, dq, N, H, D, chunks);
  return (int)cudaGetLastError();
}

}  // namespace skp
