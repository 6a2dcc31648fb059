// K1: fused capture attention, forward and backward (sm_90a).
//
// Replaces stablekeypoints_tpu/kernels/attn_capture.py
// capture_attention_fused -> _capture_fused_fwd (pallas_call at :341).
//
//   out[b, o*P + p, t] = mean_h softmax_t( q[b,h,o*P+p,:] . k[b,t,h,:] * scale )
//   q[b,h,o*P+p,:]     = bf16( sum_x ww[p,x] * tt[b,h,o,x,:] )   (column resize)
//
// tt is the row-resized query tensor [B, H, O, X, D]; the upsampled
// queries [B, H, O*P, D] never exist in device memory, nor in shared
// memory: each warp makes its 16 query rows of head h as an mma product
// ww[16 rows, X] . tt[b,h,o] [X, D] and packs the fp32 result to bf16
// straight into the A fragments of the q.k product.
//
// Forward, one pass: one block per (b, output row o, 64 columns p) walks
// the H heads in order. The head-mean needs each head's softmax normalised
// before the heads are summed, and a block holds at most 512 tokens, so
// a head's whole row of scores fits in the registers of two consumer
// warpgroups (256 keys each, m64n128k16 products with q from registers).
// Past 512 tokens (up to 4096, the wrappers' limit) a cluster of
// ceil(T / 512) blocks shares the 64 rows, each block an even, balanced
// range of keys (T 1000: 500 + 500), and the row's max and sum are merged
// over the cluster's blocks through distributed shared memory.
// Each takes its own row max and sum, the two exchange them through shared
// memory once a head (buffers by head parity, one barrier), and each adds
// exp2(s * c - m) / (l * H) into an fp32 [64][512] accumulator in
// shared memory, heads in a fixed order (deterministic, no atomics; the TPU
// kernel carried the sum across a sequential grid axis, and blocks on
// Hopper run in no order); the last head adds and writes each output row
// once. Each warpgroup streams its keys of each head by TMA from its first
// thread, [128 keys][64 columns] a stage in the 128-byte swizzle, through
// two stages of its own (full / empty mbarriers); 8 warps, so up to 255
// registers a thread (a ninth, producer warp capped them at 168, three
// warps on one SM sub-partition, and the scores spilled: 1.91 against 1.14
// ms at d 160 on an H100). One product and one exponential a score; the
// two-pass mma.sync kernel this replaces did two of each.
//
// Bound: operations (q.k, 0.22 ms for the d-160 detect launch [10, 8,
// 16384, 500]); the exponentials (B*H*N*T ex2 at 16 per clock per SM, 0.16
// ms) and the accumulator's shared-memory traffic come close. Every 64-row
// block reads each head's k from L2 (512 x D bf16, 3.4 GB per d-160
// launch); a 128-row tile would halve that but needs 512 registers of
// scores and sums a thread. Measured (PERF.md, tools/capture_fwd_variants.py)
// no part dominates: without the accumulator, the k copies, the query build
// or the ex2 the d-160 launch is 5-13% faster each; the rest is each head's
// chain (products, exchange, ex2, accumulate) run by 8 warps in lockstep,
// one block an SM, which at d 80 weighs more against half the products.
//
// Backward (replaces _capture_fused_bwd, pallas_call at :367; kernel body
// _bwd_kernel_fused). With g the cotangent of the maps [B, O*P, T] (fp32),
// per head h:
//
//   p    = softmax_t(q . k^T * scale)   c[r] = sum_t g[r,t]/H * p[r,t]
//   dsim = (g/H - c) * p * scale, rounded to bf16 (capture_fp32_bwd: kept
//          fp32 as bf16 hi + lo halves through both products, kPrecise)
//   dq   = dsim . k (fp32)              dt[b,h,o] = ww^T . bf16(dq[o*P ..])
//   dk   = sum over all rows r of dsim^T . q   (fp32, then bf16)
//
// The TPU kernel summed each row's dq over its resident keys in one order
// and dk across a sequential grid axis; on Hopper blocks run in no order, so
// each of two kernels owns what it writes, with no additions into device
// memory, at every head dim (64: SD-2.x and SDXL, 20 heads; 80 and 160:
// SD-1.5's captured layers, 8 heads), for up to 4096 tokens and, in K1, up
// to 512 output columns a row (8 tiles, the 512^2 capture):
//   1. capture_rows_kernel, per (64-row query tile, b, head split): the
//      tile's g rows [64][T] fp32 land once by TMA (128 KB at 512 tokens)
//      and stay while two warpgroups take the heads in turn; per head a
//      warpgroup sweeps the keys twice in KT-key tiles from its own
//      two-stage TMA ring, first the statistics (lse2, c), then dsim and
//      dq = dsim . k, whole in registers at the end: K2 writes it as bf16;
//      K1 writes dt = ww^T . bf16(dq) of its columns (mma.sync), bf16 when
//      an output row is one tile, else fp32 partials, one a tile of the
//      row, that partial_sum_kernel adds in order. Blocks split a tile's
//      heads in two where that saves a wave (K2 at 96^2). Past 512 tokens
//      a cluster of ceil(T / 512) blocks shares a tile, each holding the g
//      rows of its keys only: the row statistics are merged over the
//      cluster (rank order) before lse2 and c, and each block's partial dq
//      (fp32, left in its ring) is summed over the cluster in rank order,
//      block r taking dq's 8-column chunks r, r + ncl, ... into its
//      columns of dq (K2) or dt (K1); see capture_rows_kernel.
//   2. capture_keys_kernel, per (KB keys, h, b, z): warpgroups of 64 keys
//      walk z's share of the query tiles (Z > 1 where the grid would leave
//      SMs idle: 4 at SD-2.1's step, 3 at SDXL's and at its tensor-parallel
//      rank), q and g tiles through a two-stage ring, with the keys as the
//      rows of both products, so that dsim^T goes from the scores'
//      registers straight into dk += dsim^T . q as A fragments; bf16 dk, or
//      fp32 partials that partial_sum_kernel adds in order.
// dq, dt and dk are bitwise reproducible. Three exponentials a score (two
// sweeps and the keys pass) and five products of 2*N*T*D. Tiles of q and k
// arrive by TMA as CapTile lays them: the first 64 or 128 columns in the
// 128-byte swizzle (boxes of 128-byte rows), the last 16 (d 80) or 32 (d
// 160) chunk-major, so that nothing past D takes shared memory; on an
// NVIDIA H100 80GB HBM3 (700.00 W, tools/capture_bwd_variants.py) tiles of
// 16-byte boxes only made an earlier statistics pass 2.4x slower. Shapes by
// head dim, as shared memory allows beside the resident g [64][512] fp32
// (227 KB a block at most):
//   d 64   rows: KT 128; keys: four warpgroups (256 keys a block)
//   d 80   rows: KT 64;  keys: four warpgroups
//   d 160  rows: KT 64 (the g rows, two rings of 64 x 160 and K1's tt
//          leave 10 KB); keys: two warpgroups (128 keys: four would need
//          252 KB). K1's two tt buffers of 32 rows (X > 16, SD-1.5's up_1
//          from 576^2 up) do not fit past 448 tokens: there each warp reads
//          its tt B fragments from device memory (L1), once a head.
// K1 stages bf16(dq) for its dt product in the ring stage of the tile its dq
// product read last, and refills that stage after dt: no buffer of its own
// (at d 160, 16 columns at a time in the 8 KB left made dt 12% of the
// launch; at d 64 a buffer of its own was no faster).
// Past 512 tokens each block does what one block does at 500 and more:
// the cluster's exchanges, and the next head's first key tiles are copied
// only once the partial dq has left the ring (PERF.md: about 2.3x the
// 500-token time at 1000 tokens on an NVIDIA H100 80GB HBM3, 700.00 W).
// Resources (ptxas, sm_90a): the rows kernel 236-255 registers at d 160
// (K1 254; precise 255 with 16 bytes of spill; the kTtG builds 255 with 28
// / 40), 181-219 at d 80, 240-255 at d 64 (K1 precise: 32 bytes of spill),
// one block of 8 warps an SM (K1 at 512 tokens: 223,816 bytes of shared
// memory at d 160 X 16, 183,368 at d 80 X 32); the keys kernel 156 /
// 170 (precise) registers at d 160, 116 / 128 at d 80 (precise: 28 bytes
// of spill and its products serialized, C7512: four warpgroups cap a thread
// at 128), 108 / 128 at d 64. Bound: operations (3 products of 2*N*T*D:
// 0.26 ms at SD-2.1's step [4, 20, 16384, 500], 0.52 at SD-1.5's d-160 step
// [8, 8, 16384, 500]; the exponentials, 3*B*H*N*T at 16 a clock per SM,
// 0.47 / 0.38 ms). Measured on an NVIDIA H100 80GB HBM3 (700.00 W, PERF.md):
// 2.24 ms at SD-2.1's step, 1.19 at SDXL's, 3.03 at SD-1.5's d 160 and 2.27
// at its d 80 (rows pass 2/3 of it), 3.70 at d 160 X 24 (768^2, kTtG); each warpgroup's tile steps run as a
// chain of dependent waits (products, exponentials, stores) at two or four
// warpgroups an SM, the resident g and the registers leaving no room for
// more (three rows warpgroups over 64-key tiles were no faster at d 64).
//
// K2, the unfused capture (replaces capture_attention -> _capture_core,
// pallas_calls at :252 forward and :284 backward), is the same kernels with
// the queries given: q [B, H, N, D] head-major, already upsampled. The
// forward and the rows pass are templates on where a query tile
// comes from (kQ): K1 builds it from tt and ww, K2 reads it. K2 runs with
// one "output row" of N columns: the forward takes 128-query blocks that
// need not cover whole rows (a 96^2 grid is 72 blocks of 128), each warp
// reading its 16 query rows of a head straight into A fragments; the
// backward passes take 64-row tiles of q, the last one masked.
#include "common.cuh"

namespace skp {

// the bf16 pair of what rounding (a, b) to bf16 leaves over: bf16(x - bf16(x))
__device__ __forceinline__ uint32_t pack_bf16_rem(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return pack_bf16(a - __low2float(h), b - __high2float(h));
}

constexpr int kCapMaxP = 512;            // K1's backward: output columns a row (eight tiles)
constexpr int kCapMaxX = 32;
constexpr int kCapBlockKeys = 512;        // keys a block holds: above, a cluster of blocks
constexpr int kCapMaxCluster = 8;         // the portable cluster size
constexpr int kCapMaxT = kCapBlockKeys * kCapMaxCluster;

// blocks of a cluster that splits T keys, kCapBlockKeys at most each
__host__ __device__ inline int cap_cluster(int T) { return (T + kCapBlockKeys - 1) / kCapBlockKeys; }

// the first key of block r of a cluster of n over T keys: even and balanced
// (T 1000: 0, 500; T 513: 0, 258), at most kCapBlockKeys a block as long as
// T <= kCapBlockKeys n; r = n gives T. Block 0 holds the most keys,
// cap_key_start(T, n, 1).
__host__ __device__ inline int cap_key_start(int T, int n, int r) {
  return r >= n ? T : 2 * ((T * r + 2 * n - 1) / (2 * n));
}

// the forward
constexpr int kCfBQ = 64;                 // query rows per block: one warpgroup's
constexpr int kCfWG = 2;                  // consumer warpgroups, 256 keys each
constexpr int kCfKeys = 256 * kCfWG;      // resident keys (T <= 512)
constexpr int kCfSub = 128;               // keys per ring stage
constexpr int kCfStages = 2;              // ring stages per warpgroup
constexpr int kCfStage = kCfSub * 64;     // a stage: [128 keys][64 columns] bf16, 128-byte swizzle
constexpr int kCfLDA = kCfKeys + 8;       // fp32 accumulator rows: conflict-free float2 access

template <int D>
struct CapFwdCfg {
  static constexpr int KS = D / 16;
  static constexpr int CB = (D + 63) / 64;  // 64-column blocks of a head of k
  static constexpr int LD = tile_ld(D);     // K1's tt rows, row-major (ldmatrix)
  // k ring [WG][stage]; acc [BQ][LDA]; tt [2][XP][LD] (K1); row max, sum
  // [2 heads][WG][BQ]; full, empty mbarriers [WG][stage]
  static size_t bytes(int XP) {
    return sizeof(bf16) * (kCfWG * kCfStages * kCfStage + 2 * XP * LD) +
           sizeof(float) * (kCfBQ * kCfLDA + 4 * kCfWG * kCfBQ) +
           sizeof(uint64_t) * 2 * kCfWG * kCfStages;
  }
};

// A fragments of ww for 16 rows p0 + r (r < 16) of the [P, X] column-resize
// matrix; rows >= P and columns >= X are zero
__device__ __forceinline__ void ww_frags(uint32_t (&wf)[kCapMaxX / 16][4],
                                         const bf16* __restrict__ ww, int p0, int P, int X,
                                         int lane) {
  const int g = lane >> 2, t = lane & 3;
  auto w = [&](int r, int x) {
    const int p = p0 + r;
    return (p < P && x < X) ? __bfloat162float(ww[p * X + x]) : 0.f;
  };
#pragma unroll
  for (int xs = 0; xs < kCapMaxX / 16; ++xs) {
    const int x = 16 * xs + 2 * t;
    wf[xs][0] = pack_bf16(w(g, x), w(g, x + 1));
    wf[xs][1] = pack_bf16(w(g + 8, x), w(g + 8, x + 1));
    wf[xs][2] = pack_bf16(w(g, x + 8), w(g, x + 9));
    wf[xs][3] = pack_bf16(w(g + 8, x + 8), w(g + 8, x + 9));
  }
}

// K1's query fragments of 16 rows: bf16(ww . tt) with fp32 accumulation,
// from the ww fragments of the rows and tt's B fragments, load_tt(bb, x0,
// n0) giving those of rows x0 .. x0 + 15, columns n0 .. n0 + 7
template <int D, typename LoadTT>
__device__ __forceinline__ void resize_frags_by(uint32_t (&qf)[D / 16][4],
                                                const uint32_t (&wf)[kCapMaxX / 16][4], int xsteps,
                                                LoadTT load_tt) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int xs = 0; xs < kCapMaxX / 16; ++xs) {
        if (xs >= xsteps) break;
        uint32_t bb[2];
        load_tt(bb, 16 * xs, 16 * ks + 8 * half);
        mma_bf16(c[half], wf[xs], bb);
      }
    }
    qf[ks][0] = pack_bf16(c[0][0], c[0][1]);
    qf[ks][1] = pack_bf16(c[0][2], c[0][3]);
    qf[ks][2] = pack_bf16(c[1][0], c[1][1]);
    qf[ks][3] = pack_bf16(c[1][2], c[1][3]);
  }
}

// ... with tt [XP][ld] in shared memory (ldmatrix)
template <int D>
__device__ __forceinline__ void resize_frags(uint32_t (&qf)[D / 16][4],
                                             const uint32_t (&wf)[kCapMaxX / 16][4],
                                             const bf16* th, int ld, int xsteps, int lane) {
  resize_frags_by<D>(qf, wf, xsteps,
                     [&](uint32_t (&bb)[2], int x0, int n0) { load_b(bb, th + x0 * ld, ld, n0, lane); });
}

// ... with tt [X][D] of one head in device memory (rows >= X zero), every
// B fragment loaded before the first product (one round trip a head, not
// one a product): lane (g, t) takes rows x0 + 2t, + 1 (bb[0]) and + 8, + 9
// (bb[1]) of column n0 + g
template <int D>
__device__ __forceinline__ void resize_frags_g(uint32_t (&qf)[D / 16][4],
                                               const uint32_t (&wf)[kCapMaxX / 16][4],
                                               const bf16* __restrict__ th, int X, int xsteps, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const uint16_t* th16 = reinterpret_cast<const uint16_t*>(th);
  auto v = [&](int x, int col) -> uint32_t { return x < X ? th16[x * D + col] : 0u; };
  uint32_t bv[kCapMaxX / 16][D / 8][2];  // [x step][8-column step][bb]
#pragma unroll
  for (int xs = 0; xs < kCapMaxX / 16; ++xs)
#pragma unroll
    for (int n8 = 0; n8 < D / 8; ++n8) {
      const int x = 16 * xs + 2 * t, col = 8 * n8 + g;
      bv[xs][n8][0] = v(x, col) | v(x + 1, col) << 16;
      bv[xs][n8][1] = v(x + 8, col) | v(x + 9, col) << 16;
    }
  resize_frags_by<D>(qf, wf, xsteps, [&](uint32_t (&bb)[2], int x0, int n0) {
    bb[0] = bv[x0 / 16][n0 / 8][0];
    bb[1] = bv[x0 / 16][n0 / 8][1];
  });
}

// K2's query fragments: rows row0 .. row0 + 15 of q [P, D] in device memory
// (rows >= P zero)
template <int D>
__device__ __forceinline__ void q_frags(uint32_t (&qf)[D / 16][4], const bf16* __restrict__ q,
                                        int row0, int P, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bool ok0 = row0 + g < P, ok1 = row0 + g + 8 < P;
  const bf16* r0 = q + static_cast<long>(row0 + g) * D + 2 * t;
  const bf16* r1 = r0 + 8 * D;
  auto ld = [](const bf16* p) { return *reinterpret_cast<const uint32_t*>(p); };
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    qf[ks][0] = ok0 ? ld(r0 + 16 * ks) : 0u;
    qf[ks][1] = ok1 ? ld(r1 + 16 * ks) : 0u;
    qf[ks][2] = ok0 ? ld(r0 + 16 * ks + 8) : 0u;
    qf[ks][3] = ok1 ? ld(r1 + 16 * ks + 8) : 0u;
  }
}

// One pass per head: a block of 64 query rows walks the H heads in order.
// Two consumer warpgroups each own 256 of the block's (<= 512) keys: per
// head each forms its 64 x 256 scores in registers (q from registers, k from the ring,
// m64n128k16 per 128-key stage), the two exchange row maxima and then row
// sums through shared memory, and each adds exp2(s * c - m) / (l * H) into
// the block's fp32 accumulator [64][512] in shared memory, in head order;
// the last head's sum goes straight to the output. Each warpgroup streams
// its keys by TMA from its first thread, [128 keys][64 columns] a stage in
// the 128-byte swizzle, through its own two stages (full / empty mbarriers). kQ: K2 (tt is q [B, H, P,
// D] with O = 1, ww unused).
// kCl: above 512 keys, a cluster of ncl blocks along x shares each 64-row
// block, block r holding keys cap_key_start(T, ncl, r) .. (r + 1) - 1 as
// the one block does all of them: per head the row maxima and sums of every
// block's warpgroups are read from each other's shared memory (a cluster
// barrier a head, buffers by head parity), the sum in rank order, and each
// block writes its own keys' columns of the head-mean.
template <int D, bool kQ, bool kCl>
__global__ void __launch_bounds__(kCfWG * 128, 1)
    capture_fwd_kernel(const __grid_constant__ CUtensorMap tk, const bf16* __restrict__ tt,
                       const bf16* __restrict__ ww, float* __restrict__ out, int H, int O, int X,
                       int P, int T, float c, float total_h, int ncl) {
  using C = CapFwdCfg<D>;
  constexpr int ST = kCfStages, KS = C::KS, CB = C::CB, LD = C::LD;
  extern __shared__ __align__(1024) unsigned char smem[];
  const int xsteps = kQ ? 0 : (X + 15) / 16, XP = 16 * xsteps;
  bf16* Ks = reinterpret_cast<bf16*>(smem);                      // [WG][stage] k (TMA)
  float* Acc = reinterpret_cast<float*>(Ks + kCfWG * ST * kCfStage);  // [BQ][LDA]
  bf16* Ts = reinterpret_cast<bf16*>(Acc + kCfBQ * kCfLDA);      // K1: [2][XP][LD] tt[b, h, o]
  float* Red = reinterpret_cast<float*>(Ts + 2 * XP * LD);  // [h & 1][WG][BQ] row max
  float* Sum = Red + 2 * kCfWG * kCfBQ;                     // [h & 1][WG][BQ] row sum
  uint64_t* full = reinterpret_cast<uint64_t*>(Sum + 2 * kCfWG * kCfBQ);  // [WG][stage]
  uint64_t* empty = full + kCfWG * ST;                                // [WG][stage]

  const int tid = threadIdx.x, wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int rank = kCl ? cluster_rank() : 0;
  const int b = blockIdx.z, o = blockIdx.y, p0 = (kCl ? blockIdx.x / ncl : blockIdx.x) * kCfBQ;
  // this block's keys t0 .. tend - 1
  const int t0 = kCl ? cap_key_start(T, ncl, rank) : 0, tend = kCl ? cap_key_start(T, ncl, rank + 1) : T;
  if (tid == 0) {
    for (int i = 0; i < kCfWG * ST; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4);  // one arrival per warp of the warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  auto load_tt = [&](int h) {  // K1: tt[b, h, o] into buffer h & 1, rows >= X zero
    const bf16* src = tt + ((static_cast<long>(b) * H + h) * O + o) * X * D;
    bf16* dst = Ts + (h & 1) * XP * LD;
    for (int idx = tid; idx < XP * (D / 8); idx += kCfWG * 128) {
      const int r = idx / (D / 8), c8 = idx % (D / 8);
      cp_async16(dst + r * LD + 8 * c8, r < X ? src + r * D + 8 * c8 : src, r < X);
    }
    cp_async_commit();
  };
  uint32_t wf[kCapMaxX / 16][4];  // K1: ww fragments of this warp's 16 rows
  if constexpr (!kQ) {
    ww_frags(wf, ww, p0 + warp * 16, P, X, lane);
    load_tt(0);
    cp_async_wait_all();
    __syncthreads();  // tt of head 0 in shared memory
  }

  const int kl = 256 * wg, kw = t0 + kl;  // this warpgroup's first key: in the block, in k
  const int rr[2] = {16 * warp + g, 16 * warp + g + 8};
  float* arow[2] = {Acc + rr[0] * kCfLDA + kl + 2 * t, Acc + rr[1] * kCfLDA + kl + 2 * t};
  uint64_t* my_full = full + wg * ST;
  uint64_t* my_empty = empty + wg * ST;
  bf16* my_ks = Ks + wg * ST * kCfStage;
  // this warpgroup's ring stage i, (head, 64-column block, 128-key half) in
  // order, by TMA from its first thread; rows past T and columns past D zero
  auto issue_k = [&](int i) {
    const int h = i / (2 * CB);
    if (h >= H) return;
    mbar_expect_tx(&my_full[i % ST], kCfStage * 2);
    tma_load_4d(my_ks + (i % ST) * kCfStage, &tk, 64 * ((i / 2) % CB), h,
                kw + kCfSub * (i % 2), b, &my_full[i % ST]);
  };
  // stage i's products are done in each warp of the warpgroup: its arrival,
  // then the first thread refills the stage with stage i + ST
  auto release = [&](int i) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&my_empty[i % ST]);
    if (tid % 128 == 0) {
      mbar_wait(&my_empty[i % ST], (i / ST) & 1);
      issue_k(i + ST);
    }
  };
  if (tid % 128 == 0)
    for (int i = 0; i < ST; ++i) issue_k(i);
  int i = 0;  // ring stages consumed by this warpgroup
  for (int h = 0; h < H; ++h) {
    // K1: tt of head h + 1 into the buffer head h - 1 read before the last barrier
    if (!kQ && h + 1 < H) load_tt(h + 1);
    // the queries of head h as A fragments: K1 bf16(ww . tt[b, h, o]) with
    // fp32 accumulation, K2 the rows of q[b, h]
    uint32_t qf[KS][4];
    if constexpr (kQ)
      q_frags<D>(qf, tt + (static_cast<long>(b) * H + h) * P * D, p0 + warp * 16, P, lane);
    else
      resize_frags<D>(qf, wf, Ts + (h & 1) * XP * LD, LD, xsteps, lane);

    // s = q . k^T over this warpgroup's 256 keys: stage (cb, half) adds the
    // column block cb of keys kw + 128 half ..; a stage is released once the
    // next one's products are issued
    float s[128];
#pragma unroll
    for (int cb = 0; cb < CB; ++cb)
#pragma unroll
      for (int half = 0; half < 2; ++half, ++i) {
        mbar_wait(&my_full[i % ST], (i / ST) & 1);
        float(&sh)[64] = *reinterpret_cast<float(*)[64]>(s + 64 * half);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          if (4 * cb + kk < KS)
            wgmma_m64n128k16(sh, qf[min(4 * cb + kk, KS - 1)],
                             desc_sw128_kmajor<kCfSub>(my_ks + (i % ST) * kCfStage, kk),
                             cb > 0 || kk > 0);
        wgmma_commit();
        if (cb > 0 || half > 0) {
          wgmma_wait1();
          release(i - 1);
        }
      }
    wgmma_wait0();
    reg_fence(s);
    frag_fence(qf);
    release(i - 1);

    if (kw + 256 > tend)
#pragma unroll
      for (int j = 0; j < 32; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kw + 8 * j + 2 * t + (e & 1) >= tend) s[4 * j + e] = -CUDART_INF_F;
    // each warpgroup's row max and its sum of exp2(s * c - max) over its own
    // keys; one exchange (buffers by head parity, so one barrier a head);
    // then the row's max m and sum l, and this warpgroup's factor
    // exp2((max - m) * c) / (l * total_h), total_h the heads of the mean (H
    // unless a tensor-parallel rank holds H of them)
    float* red = Red + (h & 1) * kCfWG * kCfBQ;
    float* sum = Sum + (h & 1) * kCfWG * kCfBQ;
    float mw[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 32; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
      mw[r] = quad_max(mx);  // -inf if all this warpgroup's keys are masked
      const float mc = mw[r] == -CUDART_INF_F ? 0.f : mw[r] * c;
      float l = 0.f;
#pragma unroll
      for (int j = 0; j < 32; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[4 * j + e] = fast_exp2(fmaf(s[4 * j + e], c, -mc));
          l += s[4 * j + e];
        }
      l = quad_sum(l);
      if (t == 0) {
        red[wg * kCfBQ + rr[r]] = mw[r];
        sum[wg * kCfBQ + rr[r]] = l;
      }
    }
    if constexpr (!kQ) cp_async_wait_all();  // tt of head h + 1
    float inv[2];
    if constexpr (kCl) {
      // every block's two maxima and sums of the row, merged in rank order,
      // one block's four values of both rows loaded at once (a warpgroup
      // with no key below T has max -inf and sum 0; block 0's first
      // warpgroup has a key, so the running max is finite from it on)
      cluster_sync();
      float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
      for (int q = 0; q < ncl; ++q) {
        float v[2][4];  // [row][max 0, max 1, sum 0, sum 1] of block q's warpgroups
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint32_t a = cluster_map(red + rr[r], q), u = cluster_map(sum + rr[r], q);
          v[r][0] = ld_cluster_f32(a);
          v[r][1] = ld_cluster_f32(a + 4 * kCfBQ);
          v[r][2] = ld_cluster_f32(u);
          v[r][3] = ld_cluster_f32(u + 4 * kCfBQ);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float mn = fmaxf(m[r], fmaxf(v[r][0], v[r][1]));
          l[r] = l[r] * fast_exp2((m[r] - mn) * c) + v[r][2] * fast_exp2((v[r][0] - mn) * c) +
                 v[r][3] * fast_exp2((v[r][1] - mn) * c);
          m[r] = mn;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) inv[r] = fast_exp2((mw[r] - m[r]) * c) / (l[r] * total_h);
    } else {
      __syncthreads();
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m0 = red[rr[r]], m1 = red[kCfBQ + rr[r]];
        const float m = fmaxf(m0, m1);  // finite: T >= 1
        const float l = sum[rr[r]] * fast_exp2((m0 - m) * c) + sum[kCfBQ + rr[r]] * fast_exp2((m1 - m) * c);
        inv[r] = fast_exp2((mw[r] - m) * c) / (l * total_h);
      }
    }
    // the head-mean, summed in head order: the first head writes the
    // accumulator, the others add, the last adds and stores
    if (h < H - 1) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          float2* at = reinterpret_cast<float2*>(arow[r] + 8 * j);
          const float2 v = h == 0 ? make_float2(0.f, 0.f) : *at;
          *at = make_float2(v.x + s[4 * j + 2 * r] * inv[r], v.y + s[4 * j + 2 * r + 1] * inv[r]);
        }
    } else {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = p0 + rr[r];
        if (p >= P) continue;
        float* dst = out + ((static_cast<long>(b) * O + o) * P + p) * T + kw + 2 * t;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int col = kw + 8 * j + 2 * t;
          if (col >= tend) continue;
          const float2 v = h == 0 ? make_float2(0.f, 0.f)
                                  : *reinterpret_cast<const float2*>(arow[r] + 8 * j);
          const float x0 = v.x + s[4 * j + 2 * r] * inv[r];
          const float x1 = v.y + s[4 * j + 2 * r + 1] * inv[r];
          if ((T & 1) == 0) {
            *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(x0, x1);
          } else {
            dst[8 * j] = x0;
            if (col + 1 < tend) dst[8 * j + 1] = x1;
          }
        }
      }
    }
  }
  if constexpr (kCl) cluster_sync();  // no block leaves while another may read its maxima and sums
}

template <int D, bool kQ>
static int launch_capture(const void* tt, const void* ww, const void* k, void* out, int B,
                          int H, int O, int X, int P, int T, float scale,
                          cudaStream_t stream, int total_heads) {
  if (X > kCapMaxX || T < 1 || T > kCapMaxT || total_heads < H) return -1;
  CUtensorMap tk;
  const int e = encode_rows_map(&tk, k, B, T, H, D, kCfSub, true);
  if (e != 0) return e;
  const size_t smem = CapFwdCfg<D>::bytes(kQ ? 0 : (X + 15) / 16 * 16);
  const int ncl = cap_cluster(T);
  auto kernel = ncl == 1 ? capture_fwd_kernel<D, kQ, false> : capture_fwd_kernel<D, kQ, true>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (P + kCfBQ - 1) / kCfBQ;
  const float c = scale * kLog2e, th = static_cast<float>(total_heads);
  if (ncl > 1)
    return launch_clustered(kernel, dim3(tiles * ncl, O, B), kCfWG * 128, smem, ncl, stream, tk,
                            static_cast<const bf16*>(tt), static_cast<const bf16*>(ww), static_cast<float*>(out), H,
                            O, X, P, T, c, th, ncl);
  kernel<<<dim3(tiles, O, B), kCfWG * 128, smem, stream>>>(
      tk, static_cast<const bf16*>(tt), static_cast<const bf16*>(ww), static_cast<float*>(out),
      H, O, X, P, T, c, th, 1);
  return (int)cudaGetLastError();
}
// ---------------------------------------------------------------------------
// The backward, every head dim: a rows pass and a keys pass, no reduce-adds
// (see the source note)

constexpr int kC6BQ = 64;          // query rows a tile
constexpr int kC6RowWG = 2;        // rows pass: warpgroups a block
constexpr int kC6RowStages = 2;    // rows pass: k tiles in each warpgroup's ring
constexpr int kC6KeyStages = 2;    // keys pass: q and g tiles in the ring
constexpr int kC6MaxSplits = 8;
constexpr size_t kC6MaxSmem = 232448;  // dynamic shared memory a block (sm_90)

// Query tiles: O groups of P rows (K1: output rows; K2: O = 1, P = N), each
// cut into ceil(P / 64) tiles; the last tile of a group is masked past P.
struct CapTiles {
  int P, per_group;
  __device__ explicit CapTiles(int p) : P(p), per_group((p + kC6BQ - 1) / kC6BQ) {}
  // the valid rows of tile i, and its first row n0 in [0, O * P)
  __device__ int rows(int i, long& n0) const {
    const int o = i / per_group, p0 = (i % per_group) * kC6BQ;
    n0 = static_cast<long>(o) * P + p0;
    return min(kC6BQ, P - p0);
  }
};

// A [R][D] bf16 tile as TMA lands it (R a multiple of 64): the first SW =
// 64 floor(D / 64) columns as SW / 64 blocks [R][64] in the 128-byte swizzle
// (boxes of 128-byte rows), the other TL = D - SW columns (d 80: 16, d 160:
// 32) as TL / 8 chunk-major planes [R][8] (boxes of 16-byte rows), so that
// no column past D takes shared memory (d 160 in three swizzle blocks would
// be 192 columns wide).
template <int D, int R>
struct CapTile {
  static constexpr int SW = D / 64 * 64, TL = D - SW;
  static constexpr int A = SW * R;   // elements of the swizzled part
  static constexpr int PL = R * 8;   // a plane of the chunk-major part
  static constexpr int SIZE = R * D;
  static_assert(R % 64 == 0 && (TL == 0 || TL == 16 || TL == 32), "CapTile: R a multiple of 64, D 64, 80 or 160");
  // the K-major descriptor of k-step ks (columns 16 ks .. 16 ks + 15)
  static __device__ __forceinline__ uint64_t kmajor(const bf16* tile, int ks) {
    return ks < SW / 16 ? desc_sw128_kmajor<R>(tile, ks) : desc_kmajor<PL>(tile + A, 0, 2 * ks - SW / 8);
  }
  // rows r0 .. r0 + R - 1 of head c1, image c3 of a [c3][rows][c1][D]
  // tensor by TMA on `bar` (rows past the tensor zero): `ma` maps boxes of
  // 64 rows x 64 columns (128-byte swizzle), `mb` 64 rows x 8 columns. The
  // caller expects SIZE * 2 bytes.
  static __device__ __forceinline__ void load(bf16* dst, const CUtensorMap* ma, const CUtensorMap* mb, int c1,
                                              int r0, int c3, uint64_t* bar) {
    for (int hb = 0; hb < R / 64; ++hb) {
      for (int cb = 0; cb < SW / 64; ++cb)
        tma_load_4d(dst + cb * R * 64 + hb * 64 * 64, ma, 64 * cb, c1, r0 + 64 * hb, c3, bar);
      for (int ch = 0; ch < TL / 8; ++ch)
        tma_load_4d(dst + A + ch * PL + hb * 64 * 8, mb, SW + 8 * ch, c1, r0 + 64 * hb, c3, bar);
    }
  }
};

// d (+)= a . rows r0 .. r0 + 15 of a CapTile<D, R> (MN-major: the tile's
// rows are the product's depth, its D columns the product's), a from
// registers: one product over the swizzled columns, one over the rest
template <int D, int R>
__device__ __forceinline__ void wgmma_pv_tile(float (&d)[D / 2], const uint32_t (&a)[4], const bf16* tile,
                                              int r0, int accumulate) {
  using S = CapTile<D, R>;
  float(&dw)[S::SW / 2] = *reinterpret_cast<float(*)[S::SW / 2]>(d);
  if constexpr (S::SW == 64)
    wgmma_m64n64k16_tb(dw, a, desc_sw128_mnmajor<R>(tile, r0), accumulate);
  else
    wgmma_m64n128k16_tb(dw, a, desc_sw128_mnmajor<R>(tile, r0), accumulate);
  if constexpr (S::TL == 16) {
    float(&dn)[8] = *reinterpret_cast<float(*)[8]>(d + S::SW / 2);
    wgmma_m64n16k16_tb(dn, a, desc_mnmajor<S::PL>(tile + S::A, r0, 0), accumulate);
  } else if constexpr (S::TL == 32) {
    float(&dn)[16] = *reinterpret_cast<float(*)[16]>(d + S::SW / 2);
    wgmma_m64n32k16_tb(dn, a, desc_mnmajor<S::PL>(tile + S::A, r0, 0), accumulate);
  }
}

// s [64 x KT] (+)= q . k^T for a 64- or 128-key tile, q from registers
template <int KT>
__device__ __forceinline__ void wgmma_qk(float (&s)[KT / 2], const uint32_t (&a)[4], uint64_t b_desc,
                                         int accumulate) {
  if constexpr (KT == 128)
    wgmma_m64n128k16(s, a, b_desc, accumulate);
  else
    wgmma_m64n64k16(s, a, b_desc, accumulate);
}

template <int D>
struct RowsCfg {
  // keys a ring tile: d 64 128 (two boxes of 64 rows); d 80 and 160 64, so
  // that two warpgroups' rings fit beside the resident g
  static constexpr int KT = D == 64 ? 128 : 64;
  static constexpr int KS = D / 16;
  static constexpr int LD = tile_ld(D);  // K1's tt rows (ldmatrix)
  using Tile = CapTile<D, KT>;
  // g [Tp / 32][64][32] fp32; k ring [WG][stage]; K1 tt [WG][XP][LD];
  // mbarriers (g, full [WG][stage], empty [WG][stage]); with a cluster
  // (kCl) the mbarriers stat [WG][2], part_full [WG], part_empty [WG] and
  // the row statistics [WG][2][3][64] fp32
  static size_t bytes(int Tp, int XP, bool kq, bool cl = false) {
    return sizeof(float) * Tp * 64 + sizeof(bf16) * kC6RowWG * kC6RowStages * Tile::SIZE +
           (kq ? 0 : sizeof(bf16) * kC6RowWG * XP * LD) + sizeof(uint64_t) * (1 + 2 * kC6RowWG * kC6RowStages) +
           (cl ? sizeof(uint64_t) * 4 * kC6RowWG + sizeof(float) * kC6RowWG * 2 * 3 * kC6BQ : 0);
  }
  // kCl: a warpgroup's fp32 partial dq [D][64] in its ring, column-major,
  // rows of column col swapped in 8-row groups by col & 3 (so that the
  // fragment loads of 8 columns x 8 rows take two wavefronts)
  static __device__ __forceinline__ int part_at(int col, int row) { return col * kC6BQ + (row ^ (8 * (col & 3))); }
  static_assert(kC6RowStages * Tile::SIZE * 2 >= kC6BQ * D * 4, "a partial dq fits in a ring");
  // K1 stages bf16(dq) [64][D] for its dt product in a ring stage, the
  // 16-byte chunk c of row r at chunk c ^ f(r), so that the 8 rows that an
  // ldmatrix or a warp's stores reach fall in 8 different 16-byte bank
  // groups (rows are D / 8 chunks apart: d 64 8, d 80 10, d 160 20)
  static __device__ __forceinline__ int staged(int r, int c) {
    const int f = D == 64 ? r & 7 : D == 80 ? (r >> 2) & 1 : (r >> 1) & 3;
    return r * D + 8 * (c ^ f);
  }
};

template <int D>
struct KeysCfg {
  static constexpr int NWG = D == 160 ? 2 : 4;  // warpgroups of 64 keys (d 160: four do not fit)
  static constexpr int KB = 64 * NWG;           // keys a block
  static constexpr int GT = kC6BQ * KB;         // a g tile [64 rows][KB keys] fp32
  using Tile = CapTile<D, 64>;                  // a warpgroup's keys, a query tile
  // k [WG]; q [stage]; g [stage]; lse2 and c [2][WG][2][64]; mbarriers
  // (full [stage], empty [stage], k)
  static constexpr size_t bytes = sizeof(bf16) * (NWG + kC6KeyStages) * Tile::SIZE +
                                  sizeof(float) * (kC6KeyStages * GT + 2 * NWG * 2 * kC6BQ) +
                                  sizeof(uint64_t) * (2 * kC6KeyStages + 1);
};

// The rows pass, one block of kC6RowWG warpgroups per (64-row query tile,
// b, head split hs of HS): the tile's g rows [64][T] fp32 land in shared
// memory once by TMA and stay while the warpgroups take the block's heads
// hs, hs + HS, ... in turn. Per head a warpgroup holds its queries as A
// fragments (K1 builds bf16(ww . tt) with mma.sync and writes them to q [B,
// H, N, D] for the keys pass; K2 reads q) and sweeps the keys twice, KT a
// tile from its own two-stage TMA ring:
//   1. s = q . k^T (m64nKTk16), the online row max and sum of exp2(s * c)
//      and a = sum_t g p: lse2 and c = a / l / H of each row, written for
//      the keys pass;
//   2. s again, p = exp2(s * c - lse2), dsim = (g/H - c) * p * scale
//      (bf16; kPrecise: bf16 hi + lo) and dq += dsim . k (m64nDk16, split
//      at d 80 / 160 as the tile is; dsim from registers, k MN-major from the
//      same ring stage).
// dq is whole in registers after the sweep: K2 writes it as bf16 in q's
// layout; K1 stages bf16(dq) in the ring stage of the last key tile (whose
// refill waits for it) and writes dt = ww^T . bf16(dq) of its columns
// (mma.sync): bf16 dt where a row
// is one tile (P <= 64), else an fp32 partial per tile of the row, summed in
// order by partial_sum_kernel. No atomics: dq and dt are bitwise reproducible. A
// product's accumulator registers are touched only after its wait (else
// ptxas serializes every product: C7514 / C7515). kTtG: K1 builds its
// queries from tt in device memory, where no tt buffers fit (d 160, X > 16,
// past 448 tokens a block).
// kCl: above 512 keys, a cluster of ncl blocks along x shares each query
// tile, block r holding the g rows of keys cap_key_start(T, ncl, r) ..
// (r + 1) - 1 and sweeping only those. After sweep 1 each warpgroup reads
// the row statistics (max, l, a) of its counterparts in the other blocks
// from their shared memory and combines them in rank order (so every block
// has the same lse2 and c); after sweep 2 each leaves its partial dq (fp32)
// in its ring, and block r sums the 8-column chunks r, r + ncl, ... of dq
// over the cluster in rank order, writing those columns of dq (K2) or of dt
// (K1, bf16(dq) straight into mma.sync B fragments); the ring is refilled
// with the next head's keys once every block has read it (mbarriers with
// remote arrivals). No atomics: dq and dt stay bitwise reproducible. K1's
// rows of more than two tiles (P > 128, its dt partials of up to 8 tiles a
// row) run this build too, at any cluster size (ncl 1: no exchange), so
// that the build of the other shapes is as it was.
template <int D, bool kQ, bool kPrecise, bool kTtG, bool kCl>
__global__ void __launch_bounds__(kC6RowWG * 128, 1)
    capture_rows_kernel(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tk8,
                        const __grid_constant__ CUtensorMap tg, const bf16* __restrict__ tt,
                        const bf16* __restrict__ ww, bf16* __restrict__ q, float* __restrict__ lse2,
                        float* __restrict__ cvec, bf16* __restrict__ out, float* __restrict__ dt_part,
                        int H, int O, int X, int P, int T, float scale, float inv_h, int ncl) {
  using C = RowsCfg<D>;
  using S = typename C::Tile;
  constexpr int NWG = kC6RowWG, ST = kC6RowStages, LD = C::LD, KT = C::KT, KS = C::KS, KTILE = S::SIZE;
  extern __shared__ __align__(1024) unsigned char smem[];
  const int rank = kCl ? cluster_rank() : 0;
  // this block's keys t0 .. t0 + tb - 1
  const int t0 = kCl ? cap_key_start(T, ncl, rank) : 0, tb = (kCl ? cap_key_start(T, ncl, rank + 1) : T) - t0;
  const int Tp = (tb + KT - 1) / KT * KT, nkt = Tp / KT;
  // the g rows' room: the cluster's blocks lay out their shared memory alike
  // (each reaches the others' mbarriers and buffers), room for block 0's keys
  const int Tg = kCl ? (cap_key_start(T, ncl, 1) + KT - 1) / KT * KT : Tp;
  const int xsteps = kQ ? 0 : (X + 15) / 16, XP = 16 * xsteps;
  constexpr bool tts = !kQ && !kTtG;  // K1: tt through shared memory (kTtG: from device memory)
  float* Gs = reinterpret_cast<float*>(smem);                // [Tp / 32][64][32] g (TMA)
  bf16* Ks = reinterpret_cast<bf16*>(Gs + Tg * 64);          // [WG][stage] k tiles (TMA)
  bf16* Ts = Ks + NWG * ST * KTILE;                          // K1 (tts): [WG][XP][LD] tt[b, h, o]
  uint64_t* gfull = reinterpret_cast<uint64_t*>(Ts + (tts ? NWG * XP * LD : 0));
  uint64_t* full = gfull + 1;       // [WG][stage]
  uint64_t* empty = full + NWG * ST;  // [WG][stage]
  uint64_t* stat_full = empty + NWG * ST;     // kCl: [WG][2] the cluster's row statistics written
  uint64_t* part_full = stat_full + 2 * NWG;  // kCl: [WG] the cluster's partial dq written
  uint64_t* part_empty = part_full + NWG;     // kCl: [WG] this block's partial dq read by the cluster
  float* Stat = reinterpret_cast<float*>(part_empty + NWG);  // kCl: [WG][2][max, l, a][64]

  const int tid = threadIdx.x, wg = tid / 128, wt = tid % 128, warp = wt / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y, hs = blockIdx.z, HS = gridDim.z;  // the heads hs, hs + HS, ...
  const CapTiles tl(P);
  long n0;
  const int tile = kCl ? blockIdx.x / ncl : blockIdx.x;
  const int rows = tl.rows(tile, n0);
  const int o = tile / tl.per_group, half = tile % tl.per_group, p0 = half * kC6BQ;
  const long N = static_cast<long>(O) * P;
  const float c = scale * kLog2e, gs = inv_h * scale;
  const int row0 = 16 * warp + g;  // this thread's rows of the tile: row0, row0 + 8

  if (tid == 0) {
    mbar_init(gfull, 1);
    for (int i = 0; i < NWG * ST; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4);  // one arrival per warp of the warpgroup
    }
    if constexpr (kCl)
      for (int i = 0; i < 4 * NWG; ++i) mbar_init(&stat_full[i], 4 * ncl);  // each block's warps
    mbar_fence_init();
  }
  if constexpr (kCl)
    cluster_sync();  // every block's mbarriers initialised before any remote arrival
  else
    __syncthreads();
  if (tid == 0) {  // the tile's g rows over the block's keys (columns past T and rows past B N zero)
    mbar_expect_tx(gfull, Tp * 64 * 4);
    for (int cb = 0; cb < Tp / 32; ++cb)
      tma_load_2d(Gs + cb * 64 * 32, &tg, t0 + 32 * cb, static_cast<int>(b * N + n0), gfull);
  }

  // this warpgroup's ring: stage i is (head j, sweep, key tile) in order
  // warpgroup wg takes the block's heads head(j) = hs + HS (wg + 2 j)
  const int my_heads = ((H - hs + HS - 1) / HS - wg + NWG - 1) / NWG;
  auto head = [&](int j) { return hs + HS * (wg + NWG * j); };
  const int steps = my_heads * 2 * nkt;
  uint64_t* my_full = full + wg * ST;
  uint64_t* my_empty = empty + wg * ST;
  bf16* my_ks = Ks + wg * ST * KTILE;
  auto issue_k = [&](int i) {
    if (i >= steps) return;
    mbar_expect_tx(&my_full[i % ST], KTILE * 2);
    S::load(my_ks + (i % ST) * KTILE, &tk, &tk8, head(i / (2 * nkt)), t0 + (i % nkt) * KT, b, &my_full[i % ST]);
  };
  // stage i's products are done in each warp: its arrival, then the
  // warpgroup's first thread refills the stage with stage i + ST (kCl: only
  // within the head; the next head's first stages wait for the partial dq's
  // exchange)
  auto release = [&](int i) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&my_empty[i % ST]);
    if (wt == 0) {
      mbar_wait(&my_empty[i % ST], (i / ST) & 1);
      if (!kCl || ncl == 1 || (i + ST) / (2 * nkt) == i / (2 * nkt)) issue_k(i + ST);
    }
  };
  if (wt == 0)
    for (int i = 0; i < ST; ++i) issue_k(i);

  auto load_tt = [&](int h) {  // K1: tt[b, h, o] into this warpgroup's buffer, rows >= X zero
    const bf16* src = tt + ((static_cast<long>(b) * H + h) * O + o) * X * D;
    bf16* dst = Ts + wg * XP * LD;
    for (int idx = wt; idx < XP * (D / 8); idx += 128) {
      const int r = idx / (D / 8), c8 = idx % (D / 8);
      cp_async16(dst + r * LD + 8 * c8, r < X ? src + r * D + 8 * c8 : src, r < X);
    }
    cp_async_commit();
  };
  uint32_t wf[kCapMaxX / 16][4];  // K1: ww fragments of this warp's 16 rows
  if constexpr (!kQ) {
    ww_frags(wf, ww, p0 + 16 * warp, P, X, lane);
    if constexpr (tts)
      if (my_heads > 0) load_tt(head(0));
  }
  mbar_wait(gfull, 0);

  int i = 0;  // ring stages consumed by this warpgroup
  for (int j = 0; j < my_heads; ++j) {
    const int h = head(j);
    const long bh = static_cast<long>(b) * H + h;
    uint32_t qf[KS][4];
    if constexpr (kQ) {
      q_frags<D>(qf, q + (bh * N + n0) * D, 16 * warp, rows, lane);
    } else {
      if constexpr (tts) {
        cp_async_wait_all();
        named_bar_sync(1 + wg, 128);  // tt of head h in the buffer
        resize_frags<D>(qf, wf, Ts + wg * XP * LD, LD, xsteps, lane);
        named_bar_sync(1 + wg, 128);  // every warp has read it
        if (j + 1 < my_heads) load_tt(head(j + 1));
      } else {
        resize_frags_g<D>(qf, wf, tt + (bh * O + o) * X * D, X, xsteps, lane);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (row0 + 8 * r < rows) {
          uint32_t* dst = reinterpret_cast<uint32_t*>(q + (bh * N + n0 + row0 + 8 * r) * D + 2 * t);
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) {
            if (kCl && ks % ncl != rank) continue;  // the cluster's blocks share the writes
            dst[8 * ks] = qf[ks][r];
            dst[8 * ks + 4] = qf[ks][2 + r];
          }
        }
    }
    // s = q . k^T over ring stage i (m64nKTk16, q from registers)
    float s[KT / 2];
    auto scores = [&]() {
      mbar_wait(&my_full[i % ST], (i / ST) & 1);
      const bf16* kst = my_ks + (i % ST) * KTILE;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) wgmma_qk<KT>(s, qf[ks], S::kmajor(kst, ks), ks > 0);
      wgmma_commit();
    };

    // sweep 1: lse2 and c, online over the key tiles
    float m_r[2] = {-CUDART_INF_F, -CUDART_INF_F}, l_r[2] = {0.f, 0.f}, a_r[2] = {0.f, 0.f};
    for (int kt = 0; kt < nkt; ++kt, ++i) {
      scores();
      wgmma_wait0();
      reg_fence(s);
      release(i);
      const int k0 = kt * KT;
      if (k0 + KT > tb)
#pragma unroll
        for (int jj = 0; jj < KT / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k0 + 8 * jj + 2 * t + (e & 1) >= tb) s[4 * jj + e] = -CUDART_INF_F;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // four partial maxima and sums a row: short dependency chains
        float mx[4] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
        for (int jj = 0; jj < KT / 8; ++jj)
          mx[jj % 4] = fmaxf(mx[jj % 4], fmaxf(s[4 * jj + 2 * r], s[4 * jj + 2 * r + 1]));
        const float m_new =  // finite: every tile has a valid key
            fmaxf(m_r[r], quad_max(fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3]))));
        const float alpha = fast_exp2((m_r[r] - m_new) * c), mc = m_new * c;
        m_r[r] = m_new;
        const int row = row0 + 8 * r;
        float sum[4] = {0.f, 0.f, 0.f, 0.f}, ga[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int jj = 0; jj < KT / 8; ++jj) {
          const float2 gv = *reinterpret_cast<const float2*>(Gs + sw128_f32<64>(row, k0 + 8 * jj + 2 * t));
          const float e0 = fast_exp2(fmaf(s[4 * jj + 2 * r], c, -mc));
          const float e1 = fast_exp2(fmaf(s[4 * jj + 2 * r + 1], c, -mc));
          sum[jj % 4] += e0 + e1;
          ga[jj % 4] = fmaf(e0, gv.x, fmaf(e1, gv.y, ga[jj % 4]));
        }
        l_r[r] = fmaf(l_r[r], alpha, (sum[0] + sum[1]) + (sum[2] + sum[3]));
        a_r[r] = fmaf(a_r[r], alpha, (ga[0] + ga[1]) + (ga[2] + ga[3]));
      }
    }
    float lse_r[2], cs_r[2];  // lse2 and c * scale of each row
    bool merged = false;      // the statistics merged over a cluster
    if constexpr (kCl) {
      if (ncl > 1) {
        // the cluster's statistics of the row: max over the blocks, l and a
        // rescaled to it and summed in rank order (every block's max is
        // finite: each holds a key)
        float* st = Stat + (2 * wg + (j & 1)) * 3 * kC6BQ;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float l = quad_sum(l_r[r]), a = quad_sum(a_r[r]);
          const int row = row0 + 8 * r;
          if (t == 0) {
            st[row] = m_r[r];
            st[kC6BQ + row] = l;
            st[2 * kC6BQ + row] = a;
          }
        }
        __syncwarp();
        if (lane == 0)
          for (int qq = 0; qq < ncl; ++qq) mbar_arrive_cluster(cluster_map(&stat_full[2 * wg + (j & 1)], qq));
        mbar_wait_cluster(&stat_full[2 * wg + (j & 1)], (j >> 1) & 1);
        // merged in rank order, one block's three values of both rows loaded
        // at once (the running max is finite from block 0 on)
        float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f}, a[2] = {0.f, 0.f};
        for (int qq = 0; qq < ncl; ++qq) {
          float v[2][3];  // [row][max, l, a] of block qq
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const uint32_t at = cluster_map(st + row0 + 8 * r, qq);
            v[r][0] = ld_cluster_f32(at);
            v[r][1] = ld_cluster_f32(at + 4 * kC6BQ);
            v[r][2] = ld_cluster_f32(at + 8 * kC6BQ);
          }
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float mn = fmaxf(m[r], v[r][0]), f0 = fast_exp2((m[r] - mn) * c);
            const float f1 = fast_exp2((v[r][0] - mn) * c);
            l[r] = fmaf(l[r], f0, v[r][1] * f1);
            a[r] = fmaf(a[r], f0, v[r][2] * f1);
            m[r] = mn;
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row0 + 8 * r;
          const float cr = a[r] / l[r] * inv_h;
          lse_r[r] = m[r] * c + log2f(l[r]);
          cs_r[r] = cr * scale;
          if (row < rows && t == 0 && rank == 0) {
            lse2[bh * N + n0 + row] = lse_r[r];
            cvec[bh * N + n0 + row] = cr;
          }
        }
        merged = true;
      }
    }
    if (!merged) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float l = quad_sum(l_r[r]), a = quad_sum(a_r[r]);
        const float cr = a / l * inv_h;
        lse_r[r] = m_r[r] * c + log2f(l);
        cs_r[r] = cr * scale;
        const int row = row0 + 8 * r;
        if (row < rows && t == 0) {
          lse2[bh * N + n0 + row] = lse_r[r];
          cvec[bh * N + n0 + row] = cr;
        }
      }
    }

    // sweep 2: dq = sum over the key tiles of dsim . k (dsim from registers,
    // k MN-major from the same stage); a tile's scores are formed while the
    // last tile's dq product runs, and its stage released once that product
    // is done
    float dq[D / 2];
    uint32_t da[KT / 16][4], dl[KT / 16][4];  // bf16(dsim) (kPrecise: and lo), 16 keys a step
    for (int kt = 0; kt < nkt; ++kt, ++i) {
      const bf16* kst = my_ks + (i % ST) * KTILE;
      scores();
      wgmma_wait0();  // the scores, and the last tile's dq product
      reg_fence(s);
      if (kt > 0) {
        reg_fence(dq);
        frag_fence(da);
        if constexpr (kPrecise) frag_fence(dl);
        release(i - 1);
      }
      const int k0 = kt * KT;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
#pragma unroll
        for (int jj = 0; jj < KT / 8; ++jj) {
          const int key = k0 + 8 * jj + 2 * t;
          const float2 gv = *reinterpret_cast<const float2*>(Gs + sw128_f32<64>(row, key));
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int idx = 4 * jj + 2 * r + e;
            const float p = fast_exp2(fmaf(s[idx], c, -lse_r[r]));
            const float ds = fmaf(e ? gv.y : gv.x, gs, -cs_r[r]) * p;  // (g/H - c) p scale
            s[idx] = row < rows && key + e < tb ? ds : 0.f;
          }
        }
      }
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          da[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
          if constexpr (kPrecise) dl[kk][e] = pack_bf16_rem(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
        }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) wgmma_pv_tile<D, KT>(dq, da[kk], kst, 16 * kk, kt > 0 || kk > 0);
      if constexpr (kPrecise)
#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk) wgmma_pv_tile<D, KT>(dq, dl[kk], kst, 16 * kk, 1);
      wgmma_commit();
    }
    wgmma_wait0();
    reg_fence(dq);
    frag_fence(da);
    if constexpr (kPrecise) frag_fence(dl);
    frag_fence(qf);

    if constexpr (kCl) {
      if (ncl > 1) {
        // the partial dq into this warpgroup's ring, whose stages hold no
        // copy in flight (release issues no stage of the next head)
        release(i - 1);
        named_bar_sync(1 + wg, 128);  // every warp's dq products are done with the ring
        float* part = reinterpret_cast<float*>(my_ks);
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int jj = 0; jj < D / 8; ++jj)
#pragma unroll
            for (int e = 0; e < 2; ++e) part[C::part_at(8 * jj + 2 * t + e, row0 + 8 * r)] = dq[4 * jj + 2 * r + e];
        __syncwarp();
        if (lane == 0)
          for (int qq = 0; qq < ncl; ++qq) mbar_arrive_cluster(cluster_map(&part_full[wg], qq));
        mbar_wait_cluster(&part_full[wg], j & 1);
        if constexpr (kQ) {
          // K2: dq of the chunks rank, rank + ncl, ...: row wt % 64, four
          // columns a thread
          const int row = wt % kC6BQ;
          for (int jc = rank; jc < D / 8; jc += ncl) {
            const int c0 = 8 * jc + 4 * (wt / kC6BQ);
            float v[4] = {0.f, 0.f, 0.f, 0.f};
            for (int qq = 0; qq < ncl; qq += 2) {  // two blocks' loads in flight at once
              const int nq = min(2, ncl - qq);
              float x[2][4];
#pragma unroll
              for (int u = 0; u < 2; ++u)
                if (u < nq)
#pragma unroll
                  for (int e = 0; e < 4; ++e)
                    x[u][e] = ld_cluster_f32(cluster_map(part + C::part_at(c0 + e, row), qq + u));
#pragma unroll
              for (int u = 0; u < 2; ++u)
                if (u < nq)
#pragma unroll
                  for (int e = 0; e < 4; ++e) v[e] += x[u][e];
            }
            if (row < rows) {
              uint32_t* dst = reinterpret_cast<uint32_t*>(out + (bh * N + n0 + row) * D + c0);
              dst[0] = pack_bf16(v[0], v[1]);
              dst[1] = pack_bf16(v[2], v[3]);
            }
          }
        } else {
          // K1: dt = ww^T . bf16(dq) of the chunks rank, rank + ncl, ...: warp
          // w takes every fourth of them; the B fragments of bf16(dq) summed
          // over the cluster in rank order
          auto w = [&](int p, int x) { return (p < P && x < X) ? __bfloat162float(ww[p * X + x]) : 0.f; };
          uint32_t wa[kCapMaxX / 16][4][4];  // ww^T [16 x][16 p] A fragments, [x step][16-row step kk]
#pragma unroll
          for (int xm = 0; xm < kCapMaxX / 16; ++xm)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const int p = p0 + 16 * kk + 2 * t, x = 16 * xm + g;
              wa[xm][kk][0] = pack_bf16(w(p, x), w(p + 1, x));
              wa[xm][kk][1] = pack_bf16(w(p, x + 8), w(p + 1, x + 8));
              wa[xm][kk][2] = pack_bf16(w(p + 8, x), w(p + 9, x));
              wa[xm][kk][3] = pack_bf16(w(p + 8, x + 8), w(p + 9, x + 8));
            }
#pragma unroll 1
          for (int jc = rank + ncl * warp; jc < D / 8; jc += 4 * ncl) {
            const int col = 8 * jc + g;
            float bs[4][4] = {};  // [16-row step kk][rows 2t, 2t + 1, 2t + 8, 2t + 9]
            for (int qq = 0; qq < ncl; qq += 2) {  // two blocks' loads in flight at once
              const int nq = min(2, ncl - qq);
              float2 x[2][4][2];
#pragma unroll
              for (int u = 0; u < 2; ++u)
                if (u < nq)
#pragma unroll
                  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
                    for (int hh = 0; hh < 2; ++hh)
                      x[u][kk][hh] =
                          ld_cluster_f32x2(cluster_map(part + C::part_at(col, 16 * kk + 8 * hh + 2 * t), qq + u));
#pragma unroll
              for (int u = 0; u < 2; ++u)
                if (u < nq)
#pragma unroll
                  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
                    for (int hh = 0; hh < 2; ++hh) {
                      bs[kk][2 * hh] += x[u][kk][hh].x;
                      bs[kk][2 * hh + 1] += x[u][kk][hh].y;
                    }
            }
            uint32_t bb[4][2];
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              bb[kk][0] = pack_bf16(bs[kk][0], bs[kk][1]);
              bb[kk][1] = pack_bf16(bs[kk][2], bs[kk][3]);
            }
#pragma unroll
            for (int xm = 0; xm < kCapMaxX / 16; ++xm) {
              if (xm >= xsteps) break;
              const int x = 16 * xm + g;
              float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
              for (int kk = 0; kk < 4; ++kk) mma_bf16(acc, wa[xm][kk], bb[kk]);
              const int cc = 8 * jc + 2 * t;
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                const int xr = x + 8 * r;
                if (xr >= X) continue;
                const long at = ((bh * O + o) * X + xr) * D + cc;
                if (tl.per_group == 1)
                  *reinterpret_cast<uint32_t*>(out + at) = pack_bf16(acc[2 * r], acc[2 * r + 1]);
                else
                  *reinterpret_cast<float2*>(dt_part + ((bh * O + o) * tl.per_group + half) * X * D +
                                             static_cast<long>(xr) * D + cc) = make_float2(acc[2 * r], acc[2 * r + 1]);
              }
            }
          }
        }
        // this block has read the cluster's partials; once every block has
        // read this one's, its ring takes the next head's first stages
        fence_proxy_async();
        __syncwarp();
        if (lane == 0)
          for (int qq = 0; qq < ncl; ++qq) mbar_arrive_cluster(cluster_map(&part_empty[wg], qq));
        if (wt == 0) {
          mbar_wait_cluster(&part_empty[wg], j & 1);
          fence_proxy_async();
          for (int st = 0; st < ST; ++st) issue_k(i + st);
        }
        continue;
      }
    }
    if constexpr (kQ) {  // K2: dq as bf16, in q's layout
      release(i - 1);
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (row0 + 8 * r < rows) {
          bf16* dst = out + (bh * N + n0 + row0 + 8 * r) * D + 2 * t;
#pragma unroll
          for (int jj = 0; jj < D / 8; ++jj)
            *reinterpret_cast<uint32_t*>(dst + 8 * jj) = pack_bf16(dq[4 * jj + 2 * r], dq[4 * jj + 2 * r + 1]);
        }
    } else {  // K1: dt of these columns, ww^T . bf16(dq), by mma.sync
      // bf16(dq) staged in the ring stage of the last key tile, once the dq
      // product that read it is done in every warp (the barrier); the stage
      // is refilled after dt
      bf16* dqs = my_ks + ((i - 1) % ST) * KTILE;
      named_bar_sync(1 + wg, 128);
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int jj = 0; jj < D / 8; ++jj)
          *reinterpret_cast<uint32_t*>(dqs + C::staged(row0 + 8 * r, jj) + 2 * t) =
              row0 + 8 * r < rows ? pack_bf16(dq[4 * jj + 2 * r], dq[4 * jj + 2 * r + 1]) : 0u;
      named_bar_sync(1 + wg, 128);
      auto w = [&](int p, int x) { return (p < P && x < X) ? __bfloat162float(ww[p * X + x]) : 0.f; };
      // not unrolled: with the items' code twice the K1 launches took 5-14%
      // longer on an H100 (the kernel's size, it seems)
#pragma unroll 1
      for (int xm = 0; xm < xsteps; ++xm) {
        const int x = 16 * xm + g;
        uint32_t wa[4][4];  // ww^T [16 x][16 p] of the tile's four 16-row steps, A fragments
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int p = p0 + 16 * kk + 2 * t;
          wa[kk][0] = pack_bf16(w(p, x), w(p + 1, x));
          wa[kk][1] = pack_bf16(w(p, x + 8), w(p + 1, x + 8));
          wa[kk][2] = pack_bf16(w(p + 8, x), w(p + 9, x));
          wa[kk][3] = pack_bf16(w(p + 8, x + 8), w(p + 9, x + 8));
        }
        for (int jc = warp; jc < D / 8; jc += 4) {  // (16 x rows, 8 columns) items
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            uint32_t bb[2];  // rows 16 kk .. of chunk jc, each lane's row address (ld 0)
            load_b(bb, dqs + C::staged(16 * kk + (lane & 15), jc), 0, 0, lane);
            mma_bf16(acc, wa[kk], bb);
          }
          const int col = 8 * jc + 2 * t;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int xr = x + 8 * r;
            if (xr >= X) continue;
            const long at = ((bh * O + o) * X + xr) * D + col;
            if (tl.per_group == 1)
              *reinterpret_cast<uint32_t*>(out + at) = pack_bf16(acc[2 * r], acc[2 * r + 1]);
            else  // two tiles a row at most, but in the kCl build
              *reinterpret_cast<float2*>(dt_part + ((bh * O + o) * (kCl ? tl.per_group : 2) + half) * X * D +
                                         static_cast<long>(xr) * D + col) = make_float2(acc[2 * r], acc[2 * r + 1]);
          }
        }
      }
      fence_proxy_async();  // the staging's writes before the stage's next TMA refill
      release(i - 1);
    }
  }
  if constexpr (kCl) cluster_sync();  // no block leaves while another may read its shared memory
}

// The keys pass, one block per (KB keys, h, b, z): NWG warpgroups of 64
// keys (d 64 and 80: four; d 160: two) walking query tiles [first, last) of
// the (b, h), z's share of them. The block's first thread streams each
// tile's q [64][D] (from q [B, H, N, D]) and g [64 rows][KB keys] fp32 by
// TMA through a two-stage ring; lse2 and c of the tile's rows, from the rows
// pass, go through a small per-warpgroup staging one tile ahead. Each
// warpgroup works with its keys as the rows of every product:
//   s^T  = k . q^T                  m64n64k16, both from shared memory
//   dsim^T = (g/H - c) * p * scale  per element, as in the rows pass
//   dk  += bf16(dsim^T) . q         m64nDk16, dsim^T from registers (the
//                                   scores' accumulator layout is the A
//                                   fragment layout), q MN-major
// so dsim never goes through shared memory and a warpgroup waits for no
// other. dk stays in registers: bf16 dk when the (b, h)'s tiles are not
// split (Z = 1), else an fp32 partial per z, summed in order by
// partial_sum_kernel, so dk is bitwise reproducible.
template <int D, bool kPrecise>
__global__ void __launch_bounds__(KeysCfg<D>::NWG * 128, 1)
    capture_keys_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tq8,
                        const __grid_constant__ CUtensorMap tg, const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tk8, const float* __restrict__ lse2,
                        const float* __restrict__ cvec, bf16* __restrict__ dk, float* __restrict__ dk_part,
                        int H, int O, int P, int T, int Z, long E, float scale, float inv_h) {
  using C = KeysCfg<D>;
  using S = typename C::Tile;
  constexpr int ST = kC6KeyStages, NWG = C::NWG, KB = C::KB, GT = C::GT, TILE = S::SIZE;
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);                 // [WG] k tiles (TMA)
  bf16* Qs = Ks + NWG * TILE;                               // [stage] q tiles (TMA)
  float* Gs = reinterpret_cast<float*>(Qs + ST * TILE);     // [stage] g [KB / 32][64][32] (TMA)
  float* Ls = Gs + ST * GT;                                 // [2][WG][2][64] lse2 and c * scale
  uint64_t* full = reinterpret_cast<uint64_t*>(Ls + 2 * 2 * NWG * kC6BQ);  // [stage]
  uint64_t* empty = full + ST;                                            // [stage]
  uint64_t* kfull = empty + ST;

  const int tid = threadIdx.x, wg = tid / 128, wt = tid % 128, warp = wt / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z / Z, z = blockIdx.z % Z;
  const int k0 = blockIdx.x * KB;
  const long N = static_cast<long>(O) * P, bh = static_cast<long>(b) * H + h;
  const CapTiles tl(P);
  const int tiles = O * tl.per_group;
  const int first = static_cast<int>(static_cast<long>(tiles) * z / Z);
  const int n = static_cast<int>(static_cast<long>(tiles) * (z + 1) / Z) - first;
  const float c = scale * kLog2e, gs = inv_h * scale;

  if (tid == 0) {
    for (int st = 0; st < ST; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 4 * NWG);  // one arrival per warp
    }
    mbar_init(kfull, 1);
    mbar_fence_init();
  }
  __syncthreads();
  // tile it's q and g into its stage, by TMA from the first thread once
  // every warp has released the stage's last tile
  auto issue = [&](int it) {
    const int st = it % ST;
    if (it >= ST) mbar_wait(&empty[st], (it / ST - 1) & 1);
    long m0;
    tl.rows(first + it, m0);
    mbar_expect_tx(&full[st], TILE * 2 + GT * 4);
    S::load(Qs + st * TILE, &tq, &tq8, 0, static_cast<int>(m0), static_cast<int>(bh), &full[st]);
    for (int cb = 0; cb < KB / 32; ++cb)
      tma_load_2d(Gs + st * GT + cb * kC6BQ * 32, &tg, k0 + 32 * cb, static_cast<int>(b * N + m0), &full[st]);
  };
  if (tid == 0) {
    mbar_expect_tx(kfull, NWG * TILE * 2);
    for (int w = 0; w < NWG; ++w) S::load(Ks + w * TILE, &tk, &tk8, h, k0 + 64 * w, b, kfull);
    for (int it = 0; it < ST && it < n; ++it) issue(it);
  }
  // lse2 and c * scale of tile it's rows into the warpgroup's staging it & 1
  // (rows past the tile's repeat its last)
  auto stage_rows = [&](int it) {
    if (wt < kC6BQ) {
      long m0;
      const int rows = tl.rows(first + it, m0);
      const long at = bh * N + m0 + min(wt, rows - 1);
      float* ls = Ls + ((it & 1) * NWG + wg) * 2 * kC6BQ;
      ls[wt] = lse2[at];
      ls[kC6BQ + wt] = cvec[at] * scale;
    }
  };

  const bf16* Kw = Ks + wg * TILE;
  const int key0 = k0 + 64 * wg + 16 * warp + g;  // this thread's keys: key0, key0 + 8
  float dk_acc[D / 2];
  if (n > 0) stage_rows(0);
  mbar_wait(kfull, 0);
  for (int it = 0; it < n; ++it) {
    const int st = it % ST;
    long m0;
    const int rows = tl.rows(first + it, m0);
    const bf16* qt = Qs + st * TILE;
    mbar_wait(&full[st], (it / ST) & 1);
    float s[32];  // s^T: this warpgroup's keys x the tile's 64 rows
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) wgmma_m64n64k16_ss(s, S::kmajor(Kw, ks), S::kmajor(qt, ks), ks > 0);
    wgmma_commit();
    named_bar_sync(1 + wg, 128);  // tile it's row statistics staged
    if (it + 1 < n) stage_rows(it + 1);
    wgmma_wait0();  // the scores, and the last tile's dk product
    reg_fence(s);
    if (it > 0) {
      reg_fence(dk_acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(it - 1) % ST]);  // q and g of the last tile are free
      if (tid == 0 && it - 1 + ST < n) issue(it - 1 + ST);
    }
    const float* gt = Gs + st * GT;
    const float* ls = Ls + ((it & 1) * NWG + wg) * 2 * kC6BQ;
    uint32_t da[4][4], dl[4][4];  // bf16(dsim^T) (kPrecise: and lo) as A fragments, 16 rows a step
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {  // rows 8 jj + 2 t + e of keys key0 + 8 r
      float d[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = 8 * jj + 2 * t + e;
        const float lr = ls[row], cr = ls[kC6BQ + row];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int key = key0 + 8 * r;
          const float gv = gt[sw128_f32<kC6BQ>(row, key - k0)];
          const float p = fast_exp2(fmaf(s[4 * jj + 2 * r + e], c, -lr));
          const float v = fmaf(gv, gs, -cr) * p;
          d[2 * r + e] = row < rows && key < T ? v : 0.f;
        }
      }
      da[jj / 2][2 * (jj & 1)] = pack_bf16(d[0], d[1]);
      da[jj / 2][2 * (jj & 1) + 1] = pack_bf16(d[2], d[3]);
      if constexpr (kPrecise) {
        dl[jj / 2][2 * (jj & 1)] = pack_bf16_rem(d[0], d[1]);
        dl[jj / 2][2 * (jj & 1) + 1] = pack_bf16_rem(d[2], d[3]);
      }
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_pv_tile<D, 64>(dk_acc, da[kk], qt, 16 * kk, it > 0 || kk > 0);
    if constexpr (kPrecise)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_pv_tile<D, 64>(dk_acc, dl[kk], qt, 16 * kk, 1);
    wgmma_commit();
  }
  wgmma_wait0();
  reg_fence(dk_acc);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= T || n == 0) continue;
    const long at = ((static_cast<long>(b) * T + key) * H + h) * D + 2 * t;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      if (Z == 1)
        *reinterpret_cast<uint32_t*>(dk + at + 8 * jj) = pack_bf16(dk_acc[4 * jj + 2 * r], dk_acc[4 * jj + 2 * r + 1]);
      else
        *reinterpret_cast<float2*>(dk_part + z * E + at + 8 * jj) =
            make_float2(dk_acc[4 * jj + 2 * r], dk_acc[4 * jj + 2 * r + 1]);
    }
  }
}

// how many blocks split a query tile's heads in the rows pass (HS, 1 or 2):
// two where that saves waves, e.g. K2 at SD-2.1's 96^2 step (576 tiles of
// 20 heads: 5 waves of 10 heads a warpgroup on 132 SMs, against 9 of 5)
static int rows_head_splits(int blocks, int H) {
  const int sms = device_sms();
  if (sms < 1) return 1;
  auto cost = [&](int hs) {
    return static_cast<long>((blocks * hs + sms - 1) / sms) *
           (((H + hs - 1) / hs + kC6RowWG - 1) / kC6RowWG);
  };
  return cost(2) < cost(1) ? 2 : 1;
}

// fp32 values of the scratch (dq_acc, B*H*N*D) that K1's dt partials take:
// one a 64-column tile of an output row, where a row is more than one
static long dt_part_size(bool kq, int B, int H, int O, int X, int P, int D) {
  const int tiles = (P + kC6BQ - 1) / kC6BQ;
  return !kq && tiles > 1 ? static_cast<long>(tiles) * B * H * O * X * D : 0;
}

// how many blocks split each (b, h)'s query tiles in the keys pass (Z,
// block_splits): the grid of ceil(T / KB) x H x B blocks fills 40 of the
// H100's 132 SMs at SDXL's tensor-parallel rank and 80 at SDXL's step; only
// as far as the scratch holds the partials (dk in fp32, E values a split)
template <int D>
static int capture_bwd_splits(int B, int H, int T, int tiles, long room) {
  const long blocks = static_cast<long>((T + KeysCfg<D>::KB - 1) / KeysCfg<D>::KB) * H * B;
  const long E = static_cast<long>(B) * T * H * D;
  return block_splits(blocks, tiles, static_cast<double>(E),
                      static_cast<int>(min(static_cast<long>(kC6MaxSplits), room / E)));
}

// The backward: the rows pass, the keys pass, and the sums of the
// partials. K1: tt, ww given, q [B, H, N, D] scratch, out = dt; K2 (kQ): q
// given (O = 1, P = N), out = dq. g rows are ldg floats apart (ldg % 4 ==
// 0); lse2, c [B, H, N] and dq_acc [B, H, N, D] fp32 are scratch, dq_acc for
// K1's dt partials and the keys pass's dk partials.
template <int D, bool kQ, bool kPrecise>
static int launch_capture_bwd(const void* tt, const void* ww, const void* k, const void* g,
                              void* q, void* lse, void* c, void* dq_acc, void* out, void* dk,
                              int B, int H, int O, int X, int P, int T, int ldg, float scale,
                              cudaStream_t stream, int total_heads) {
  using RC = RowsCfg<D>;
  using KC = KeysCfg<D>;
  if (X > kCapMaxX || (!kQ && P > kCapMaxP) || ldg % 4 != 0 || ldg < T || total_heads < H ||
      T < 1 || T > kCapMaxT)
    return -1;
  const long N = static_cast<long>(O) * P;
  // the rows pass over a cluster of ncl blocks above 512 keys, each holding
  // the g rows of at most Tb keys; K1's rows of more than two 64-column tiles
  // (P > 128) take the same build (kCl) at any ncl, so that the build for the
  // other shapes stays as it was
  const int ncl = cap_cluster(T), Tb = cap_key_start(T, ncl, 1);
  const int tiles = O * ((P + kC6BQ - 1) / kC6BQ), Tp = (Tb + RC::KT - 1) / RC::KT * RC::KT;
  // K1's tt buffers where they fit beside the g rows and the rings (d 160:
  // X <= 16 or T <= 448 a block), else the rows pass reads tt from device
  // memory (kTtG, a build of its own, so that the other paths' code is as
  // it was)
  const int XP = kQ ? 0 : (X + 15) / 16 * 16;
  const bool cl = ncl > 1 || (!kQ && P > 2 * kC6BQ), tt_smem = RC::bytes(Tp, XP, kQ, cl) <= kC6MaxSmem;
  const size_t rows_smem = RC::bytes(Tp, tt_smem ? XP : 0, kQ, cl);
  auto rows_kernel = cl ? capture_rows_kernel<D, kQ, kPrecise, false, true>
                        : capture_rows_kernel<D, kQ, kPrecise, false, false>;
  if constexpr (D == 160 && !kQ)
    if (!tt_smem)
      rows_kernel = cl ? capture_rows_kernel<D, kQ, kPrecise, true, true>
                       : capture_rows_kernel<D, kQ, kPrecise, true, false>;
  CUtensorMap tk, tk8, tg, tq, tq8;
  int e = encode_rows_map(&tk, k, B, T, H, D, 64, true);
  if (e == 0) e = encode_rows_map(&tk8, k, B, T, H, D, 64);
  if (e == 0) e = encode_f32_map(&tg, g, B * N, T, 4L * ldg, kC6BQ);
  if (e == 0) e = encode_rows_map(&tq, q, B * H, N, 1, D, kC6BQ, true);
  if (e == 0) e = encode_rows_map(&tq8, q, B * H, N, 1, D, kC6BQ);
  if (e != 0) return e;
  cudaError_t err = cudaFuncSetAttribute(rows_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)rows_smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(capture_keys_kernel<D, kPrecise>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)KC::bytes);
  if (err != cudaSuccess) return (int)err;
  const float inv_h = 1.0f / static_cast<float>(total_heads);
  float* scratch = static_cast<float*>(dq_acc);
  const long dtp = dt_part_size(kQ, B, H, O, X, P, D), E = static_cast<long>(B) * T * H * D;
  const int Z = capture_bwd_splits<D>(B, H, T, tiles, static_cast<long>(B) * H * N * D - dtp);
  float* dk_part = scratch + dtp;
  float *lp = static_cast<float*>(lse), *cp = static_cast<float*>(c);
  // a cluster's blocks take all of a tile's heads: a split would have each
  // block load its g rows once more, which the count of waves leaves out
  const dim3 rows_grid(tiles * ncl, B, ncl > 1 ? 1 : rows_head_splits(tiles * B, H));
  if (cl) {
    const int e = launch_clustered(rows_kernel, rows_grid, kC6RowWG * 128, rows_smem, ncl, stream, tk, tk8, tg,
                                   static_cast<const bf16*>(tt), static_cast<const bf16*>(ww), static_cast<bf16*>(q),
                                   lp, cp, static_cast<bf16*>(out), scratch, H, O, X, P, T, scale, inv_h, ncl);
    if (e != 0) return e;
  } else {
    rows_kernel<<<rows_grid, kC6RowWG * 128, rows_smem, stream>>>(
        tk, tk8, tg, static_cast<const bf16*>(tt), static_cast<const bf16*>(ww), static_cast<bf16*>(q), lp, cp,
        static_cast<bf16*>(out), scratch, H, O, X, P, T, scale, inv_h, 1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  capture_keys_kernel<D, kPrecise><<<dim3((T + KC::KB - 1) / KC::KB, H, B * Z), KC::NWG * 128, KC::bytes,
                                     stream>>>(
      tq, tq8, tg, tk, tk8, lp, cp, static_cast<bf16*>(dk), dk_part, H, O, P, T, Z, E, scale, inv_h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (Z > 1) {
    const int e = launch_partial_sum(dk_part, static_cast<bf16*>(dk), E, Z, E, E, 0, stream);
    if (e != 0) return e;
  }
  if (dtp > 0) {  // part [B H O][tiles][X D]: the tiles of an output row
    const int rt = (P + kC6BQ - 1) / kC6BQ;
    const long dtE = static_cast<long>(B) * H * O * X * D, XD = static_cast<long>(X) * D;
    return launch_partial_sum(scratch, static_cast<bf16*>(out), dtE, rt, XD, XD, rt * XD, stream);
  }
  return (int)cudaGetLastError();
}

template <bool kQ, bool kPrecise>
static int capture_bwd_for_d(const void* tt, const void* ww, const void* k, const void* g, void* q,
                             void* lse, void* c, void* dq_acc, void* out, void* dk, int B, int H,
                             int O, int X, int P, int T, int ldg, int D, float scale,
                             cudaStream_t s, int total_heads) {
  switch (D) {
    case 64:
      return launch_capture_bwd<64, kQ, kPrecise>(tt, ww, k, g, q, lse, c, dq_acc, out, dk, B, H, O, X, P, T,
                                                  ldg, scale, s, total_heads);
    case 80:
      return launch_capture_bwd<80, kQ, kPrecise>(tt, ww, k, g, q, lse, c, dq_acc, out, dk, B, H, O, X, P, T,
                                                  ldg, scale, s, total_heads);
    case 160:
      return launch_capture_bwd<160, kQ, kPrecise>(tt, ww, k, g, q, lse, c, dq_acc, out, dk, B, H, O, X, P, T,
                                                   ldg, scale, s, total_heads);
    default: return -1;
  }
}


}  // namespace skp

// Every entry takes total_heads last: the head-mean divides by it (the
// forward's normalised softmaxes are summed as p / total_heads, the
// backward's cotangent reads g / total_heads). total_heads = H is the
// head-mean of the H heads given; a tensor-parallel rank that holds H of
// total_heads heads gets its partial sum, which an all-reduce over the
// model ranks completes. Returns -1 for total_heads < H.

// tt [B,H,O,X,D] bf16, ww [P,X] bf16, k [B,T,H,D] bf16 -> out [B, O*P, T] fp32.
// Returns a cudaError_t; -1 for an unsupported head dimension or X > 32.
extern "C" int skp_capture_fwd(const void* tt, const void* ww, const void* k, void* out,
                               int B, int H, int O, int X, int P, int T, int D,
                               float scale, void* stream, int total_heads) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return skp::launch_capture<64, false>(tt, ww, k, out, B, H, O, X, P, T, scale, s, total_heads);
    case 80: return skp::launch_capture<80, false>(tt, ww, k, out, B, H, O, X, P, T, scale, s, total_heads);
    case 160: return skp::launch_capture<160, false>(tt, ww, k, out, B, H, O, X, P, T, scale, s, total_heads);
    default: return -1;
  }
}

// (tt, ww, k as for skp_capture_fwd; g [B, O*P, T] fp32, the maps'
// cotangent, rows ldg floats apart) -> dt [B,H,O,X,D] and dk [B,T,H,D] bf16;
// q [B,H,O*P,D] bf16, lse and c [B,H,O*P] and dq_acc [B,H,O*P,D] fp32 are
// scratch. -1 for an unsupported head dimension, X > 32, P > 512, T > 4096
// or ldg not a multiple of 4.
// The _precise entry keeps dsim fp32 through the products.
extern "C" int skp_capture_bwd(const void* tt, const void* ww, const void* k, const void* g,
                               void* q, void* lse, void* c, void* dq_acc, void* dt, void* dk,
                               int B, int H, int O, int X, int P, int T, int ldg, int D,
                               float scale, void* stream, int total_heads) {
  return skp::capture_bwd_for_d<false, false>(tt, ww, k, g, q, lse, c, dq_acc, dt, dk, B, H, O, X,
                                              P, T, ldg, D, scale, static_cast<cudaStream_t>(stream),
                                              total_heads);
}
extern "C" int skp_capture_bwd_precise(const void* tt, const void* ww, const void* k,
                                       const void* g, void* q, void* lse, void* c, void* dq_acc,
                                       void* dt, void* dk, int B, int H, int O, int X, int P,
                                       int T, int ldg, int D, float scale, void* stream,
                                       int total_heads) {
  return skp::capture_bwd_for_d<false, true>(tt, ww, k, g, q, lse, c, dq_acc, dt, dk, B, H, O, X,
                                             P, T, ldg, D, scale, static_cast<cudaStream_t>(stream),
                                             total_heads);
}

// Z, the number of blocks the backward's keys pass splits each (b, h)'s
// query tiles over; kq: K2's shapes (O = 1, P = N). -1 for an unsupported
// head dimension.
extern "C" int skp_capture_bwd_splits(int B, int H, int O, int X, int P, int T, int D, int kq) {
  const long room = static_cast<long>(B) * H * O * P * D - skp::dt_part_size(kq != 0, B, H, O, X, P, D);
  const int tiles = O * ((P + skp::kC6BQ - 1) / skp::kC6BQ);
  switch (D) {
    case 64: return skp::capture_bwd_splits<64>(B, H, T, tiles, room);
    case 80: return skp::capture_bwd_splits<80>(B, H, T, tiles, room);
    case 160: return skp::capture_bwd_splits<160>(B, H, T, tiles, room);
    default: return -1;
  }
}

// K2: q [B,H,N,D] bf16 (head-major), k [B,T,H,D] bf16 -> out [B, N, T] fp32.
// -1 for an unsupported head dimension.
extern "C" int skp_capture_q_fwd(const void* q, const void* k, void* out, int B, int H, int N,
                                 int T, int D, float scale, void* stream, int total_heads) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return skp::launch_capture<64, true>(q, nullptr, k, out, B, H, 1, 0, N, T, scale, s, total_heads);
    case 80: return skp::launch_capture<80, true>(q, nullptr, k, out, B, H, 1, 0, N, T, scale, s, total_heads);
    case 160: return skp::launch_capture<160, true>(q, nullptr, k, out, B, H, 1, 0, N, T, scale, s, total_heads);
    default: return -1;
  }
}

// K2 backward: (q, k as for skp_capture_q_fwd; g [B, N, T] fp32, rows ldg
// floats apart) -> dq [B,H,N,D] and dk [B,T,H,D] bf16; lse and c [B,H,N] and
// dq_acc [B,H,N,D] fp32 are scratch. The _precise entry keeps dsim fp32.
extern "C" int skp_capture_q_bwd(const void* q, const void* k, const void* g, void* lse,
                                 void* c, void* dq_acc, void* dq, void* dk, int B, int H, int N,
                                 int T, int ldg, int D, float scale, void* stream,
                                 int total_heads) {
  return skp::capture_bwd_for_d<true, false>(nullptr, nullptr, k, g, const_cast<void*>(q), lse, c,
                                             dq_acc, dq, dk, B, H, 1, 0, N, T, ldg, D, scale,
                                             static_cast<cudaStream_t>(stream), total_heads);
}
extern "C" int skp_capture_q_bwd_precise(const void* q, const void* k, const void* g, void* lse,
                                         void* c, void* dq_acc, void* dq, void* dk, int B, int H,
                                         int N, int T, int ldg, int D, float scale, void* stream,
                                         int total_heads) {
  return skp::capture_bwd_for_d<true, true>(nullptr, nullptr, k, g, const_cast<void*>(q), lse, c,
                                            dq_acc, dq, dk, B, H, 1, 0, N, T, ldg, D, scale,
                                            static_cast<cudaStream_t>(stream), total_heads);
}
