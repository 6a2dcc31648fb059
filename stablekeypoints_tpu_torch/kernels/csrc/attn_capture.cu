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
// before the heads are summed, and the wrappers take at most 512 tokens, so
// a head's whole row of scores fits in the registers of two consumer
// warpgroups (256 keys each, m64n128k16 products with q from registers).
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
// The TPU kernel summed dk across a sequential grid axis; on Hopper blocks
// run in no order, so one launch runs three passes, as the K3/K4/K5
// backward of attn_bwd.cuh does:
//   1. capture_stats_kernel, per (h, 64 query rows, b): lse2 and c of each
//      row in one online pass over the keys (q.k^T by wgmma, one ex2 a
//      score); K1 builds the tile's queries bf16(ww . tt) (mma.sync) and
//      writes them to a bf16 [B, H, N, D] scratch; zeroes the tile's rows
//      of an fp32 dq accumulator.
//   2. capture_bwd_kernel, per (h, 128 keys, b), two warpgroups of 64 keys
//      walking every query tile: s, dq = dsim . k and dk += dsim^T . q by
//      wgmma, one ex2 a score; dk in registers, dq by bulk reduce-add.
//   3. K1: capture_dt_kernel, dt = ww^T . bf16(dq) per (o, h, b); K2:
//      capture_dq_kernel, dq to bf16.
// Three products of 2*N*T*D and two exponentials a score in all. q, k
// and g tiles arrive by TMA in 128-byte rows (128-byte swizzle, read by wgmma
// through swizzled descriptors): on an NVIDIA H100 80GB HBM3 (700.00 W,
// tools/capture_bwd_variants.py) boxes of 16-byte rows, one per 8-column
// chunk, made the statistics pass 2.4x and the whole launch 1.5x slower.
// The dq of a tile is staged row-major in shared memory (rows padded by 4
// floats: no bank conflicts) and added one row per bulk reduce-add: the
// same tensor reduce in 16-byte rows took 3.5 of 9.0 ms at d 160. The dq
// sums land in no fixed order, so dq and dt are not bitwise reproducible
// from run to run (dk is); they agree with the plain version within 2^-6
// of their largest magnitude.
//
// Resources at d 160 (d 80): the backward kernel holds dk and a tile's dq,
// 80 (40) fp32 registers each a thread: 230 (156) registers, no spills;
// 215.6 KB (158.1 KB) of shared memory (a 2-stage ring of q [64][192] bf16
// and g [64][128] fp32, k [128][160], the dq tile, dsim), one block of 8
// warps an SM. The statistics kernel: 108 KB at d 160, two blocks an SM.
// At d 64 (SD-2.x, SDXL; 20 heads at the captured layers) a head of q or
// k is exactly one 64-column swizzle block (CB = 1). The forward runs the
// kernel above; the backward has kernels of its own (below).
//
// Bound on the H100: operations (3 products of 2*N*T*D: 0.52 ms for the
// d-160 training-step launch [8, 8, 16384, 500]); the exponentials come
// next (2*B*H*N*T ex2 at 16 per clock per SM: 0.25 ms). Measured on the
// same card: 3.59 ms, of which the statistics pass is 0.87, the finish 0.39
// and the dq reduce-adds 0.56; the backward pass runs its products at
// about half the tensor cores' peak (from its time and its product count),
// the rest being each tile's chain of dependent steps (wait, s, dsim,
// barrier, dq and dk, the dq sum) in the two warpgroups at once.
//
// The d-64 backward. On an NVIDIA H100 80GB HBM3 (700.00 W) the passes
// above, instanced at d 64, spent 3.47 ms on SD-2.1's [4, 20, 16384, 500]
// (tools/capture_bwd_variants.py --d64): the statistics 0.61, the dt finish
// 0.39, the dq reduce-adds 0.83, and the pass over the keys, whose grid of
// (H, T / 128, B) blocks each walking all 256 query tiles (~3.3 us a tile)
// ran in three waves (SDXL's step: two, the second of 28 blocks). Two
// kernels replace the three passes, with no additions into device memory:
//   1. capture_rows64_kernel, per (64-row query tile, b, head split): the
//      tile's g rows [64][T] fp32 land once by TMA (128 KB at 512 tokens)
//      and stay while two warpgroups take the heads in turn; per head a
//      warpgroup sweeps the keys twice in 128-key tiles from its own
//      two-stage TMA ring, first the statistics (lse2, c), then dsim and
//      dq = dsim . k, whole in registers at the end: K2 writes it as bf16;
//      K1 writes dt = ww^T . bf16(dq) of its columns (mma.sync), bf16 when
//      an output row is one tile, else fp32 partials that dt_sum_kernel
//      adds in order. Blocks split a tile's heads in two where that saves
//      a wave (K2 at 96^2).
//   2. capture_keys64_kernel, per (256 keys, h, b, z): four warpgroups of
//      64 keys walk z's share of the query tiles (Z > 1 where the grid
//      would leave SMs idle: 4 at SD-2.1's step, 3 at SDXL's and at its
//      tensor-parallel rank), q and g tiles through a two-stage ring, with
//      the keys as the rows of both products, so that dsim^T goes from the
//      scores' registers straight into dk += dsim^T . q as A fragments;
//      bf16 dk, or fp32 partials that dk_sum_kernel adds in order.
// dq, dt and dk are bitwise reproducible. Three exponentials a score (two
// sweeps and the keys pass) and five products of 2*N*T*D, against the
// passes above's two and four. Resources (ptxas, sm_90a): the rows kernel
// 240 registers (K2), 244 (K1), 249 / 255 (precise), no spills, 224,328
// bytes of shared memory at 512 tokens (K2: 196,680), one block of 8 warps
// an SM; the keys kernel 108 registers (precise: 128, 56 bytes of spill),
// 184,360 bytes, one block of 16 warps. Bound: operations (3 products of
// 2*N*T*D: 0.26 ms at SD-2.1's step; the exponentials 2*B*H*N*T at 16 a
// clock per SM, 0.31 ms). Measured 2.35 ms there (rows 1.44, keys 0.91),
// 1.28 at SDXL's step; each warpgroup's tile steps run as a chain of
// dependent waits (products, exponentials, stores) at two or four
// warpgroups an SM, the resident g and the registers leaving no room for
// more (PERF.md: three rows warpgroups over 64-key tiles were no faster). A d-64 forward that kept each
// warpgroup's two 128-key halves apart (one half's exponentials under the
// other's products, the next head's products under this one's
// accumulation, the exchange by named barriers) measured 1.89-1.96 ms
// against the kernel above's 1.74 and was dropped.
//
// K2, the unfused capture (replaces capture_attention -> _capture_core,
// pallas_calls at :252 forward and :284 backward), is the same kernels with
// the queries given: q [B, H, N, D] head-major, already upsampled. The
// forward and the statistics pass are templates on where a query tile
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

constexpr int kCapWarps = 8;             // the finishing pass: 8 warps
constexpr int kCapBQ = 16 * kCapWarps;    // ... over up to 128 output columns p
constexpr int kCapMaxX = 32;

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
// from the ww fragments of the rows and tt [XP][ld] in shared memory
template <int D>
__device__ __forceinline__ void resize_frags(uint32_t (&qf)[D / 16][4],
                                             const uint32_t (&wf)[kCapMaxX / 16][4],
                                             const bf16* th, int ld, int xsteps, int lane) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int xs = 0; xs < kCapMaxX / 16; ++xs) {
        if (xs >= xsteps) break;
        uint32_t bb[2];
        load_b(bb, th + 16 * xs * ld, ld, 16 * ks + 8 * half, lane);
        mma_bf16(c[half], wf[xs], bb);
      }
    }
    qf[ks][0] = pack_bf16(c[0][0], c[0][1]);
    qf[ks][1] = pack_bf16(c[0][2], c[0][3]);
    qf[ks][2] = pack_bf16(c[1][0], c[1][1]);
    qf[ks][3] = pack_bf16(c[1][2], c[1][3]);
  }
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
// Two consumer warpgroups each own 256 of the (<= 512) keys: per head each
// forms its 64 x 256 scores in registers (q from registers, k from the ring,
// m64n128k16 per 128-key stage), the two exchange row maxima and then row
// sums through shared memory, and each adds exp2(s * c - m) / (l * H) into
// the block's fp32 accumulator [64][512] in shared memory, in head order;
// the last head's sum goes straight to the output. Each warpgroup streams
// its keys by TMA from its first thread, [128 keys][64 columns] a stage in
// the 128-byte swizzle, through its own two stages (full / empty mbarriers). kQ: K2 (tt is q [B, H, P,
// D] with O = 1, ww unused).
template <int D, bool kQ>
__global__ void __launch_bounds__(kCfWG * 128, 1)
    capture_fwd_kernel(const __grid_constant__ CUtensorMap tk, const bf16* __restrict__ tt,
                       const bf16* __restrict__ ww, float* __restrict__ out, int H, int O, int X,
                       int P, int T, float c, float total_h) {
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
  const int b = blockIdx.z, o = blockIdx.y, p0 = blockIdx.x * kCfBQ;
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

  const int kw = 256 * wg;  // this warpgroup's first key
  const int rr[2] = {16 * warp + g, 16 * warp + g + 8};
  float* arow[2] = {Acc + rr[0] * kCfLDA + kw + 2 * t, Acc + rr[1] * kCfLDA + kw + 2 * t};
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

    if (kw + 256 > T)
#pragma unroll
      for (int j = 0; j < 32; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kw + 8 * j + 2 * t + (e & 1) >= T) s[4 * j + e] = -CUDART_INF_F;
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
    __syncthreads();
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m0 = red[rr[r]], m1 = red[kCfBQ + rr[r]];
      const float m = fmaxf(m0, m1);  // finite: T >= 1
      const float l = sum[rr[r]] * fast_exp2((m0 - m) * c) + sum[kCfBQ + rr[r]] * fast_exp2((m1 - m) * c);
      inv[r] = fast_exp2((mw[r] - m) * c) / (l * total_h);
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
          if (col >= T) continue;
          const float2 v = h == 0 ? make_float2(0.f, 0.f)
                                  : *reinterpret_cast<const float2*>(arow[r] + 8 * j);
          const float x0 = v.x + s[4 * j + 2 * r] * inv[r];
          const float x1 = v.y + s[4 * j + 2 * r + 1] * inv[r];
          if ((T & 1) == 0) {
            *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(x0, x1);
          } else {
            dst[8 * j] = x0;
            if (col + 1 < T) dst[8 * j + 1] = x1;
          }
        }
      }
    }
  }
}

template <int D, bool kQ>
static int launch_capture(const void* tt, const void* ww, const void* k, void* out, int B,
                          int H, int O, int X, int P, int T, float scale,
                          cudaStream_t stream, int total_heads) {
  if (X > kCapMaxX || T < 1 || T > kCfKeys || total_heads < H) return -1;
  CUtensorMap tk;
  const int e = encode_rows_map(&tk, k, B, T, H, D, kCfSub, true);
  if (e != 0) return e;
  const size_t smem = CapFwdCfg<D>::bytes(kQ ? 0 : (X + 15) / 16 * 16);
  cudaError_t err = cudaFuncSetAttribute(
      capture_fwd_kernel<D, kQ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((P + kCfBQ - 1) / kCfBQ, O, B);
  capture_fwd_kernel<D, kQ><<<grid, kCfWG * 128, smem, stream>>>(
      tk, static_cast<const bf16*>(tt), static_cast<const bf16*>(ww), static_cast<float*>(out),
      H, O, X, P, T, scale * kLog2e, static_cast<float>(total_heads));
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// backward: a statistics pass, one backward pass, a finishing pass

constexpr int kCbBQ = 64;          // query rows per tile: one warpgroup
constexpr int kCbBK = 64;          // keys per tile (statistics) and per warpgroup (backward)
constexpr int kCbWG = 2;           // backward: warpgroups per block
constexpr int kCbKB = kCbWG * kCbBK;  // backward: keys per block
constexpr int kCbStatStages = 2;   // statistics: k and g tiles in the ring, one loading
constexpr int kCbStages = 2;       // backward: q and g tiles in the ring, one loading
constexpr int kCbGT = kCbBQ * kCbBK;  // a g tile [64 rows][64 keys] fp32, 128-byte swizzle

template <int D>
struct CapBwdCfg {
  static constexpr int KS = D / 16;
  static constexpr int CB = (D + 63) / 64;  // 64-column blocks of a q or k tile
  static constexpr int TILE = CB * 64 * 64;   // a q or k tile [64][64 CB], 128-byte swizzle
  static constexpr int STX = CB * 64 * 128 + kCbGT * 4;  // bytes TMA brings a stage: statistics
  static constexpr int GBT = kCbBQ * kCbKB;  // the backward's g tile [64 rows][128 keys] fp32
  static constexpr int TX = CB * 64 * 128 + GBT * 4;      // bytes TMA brings a stage: backward
  static constexpr int KPL = plane_ld(kCbKB);             // the backward's k planes
  static constexpr int PPL = plane_ld(64);  // bf16 planes of 64 rows that threads write:
  static constexpr int PTILE = D / 8 * PPL;  // the statistics' q, the backward's dsim [8][64][8]
  static constexpr int DQLD = D + 4;          // fp32 dq tile rows, padded: no bank conflicts
  static constexpr int DQT = kCbBQ * DQLD;
  static constexpr int LD = tile_ld(D);       // K1's tt rows, row-major (ldmatrix)
  // statistics: k, g [stage]; q; tt [XP][LD] (K1); an mbarrier per stage
  static size_t stats_bytes(int XP) {
    return sizeof(bf16) * (kCbStatStages * TILE + PTILE + XP * LD) +
           sizeof(float) * kCbStatStages * kCbGT + sizeof(uint64_t) * kCbStatStages;
  }
  // backward: q, g [stage]; dq; k; dsim [WG]; lse2, c [stage]; an mbarrier per stage
  static constexpr size_t bwd_bytes =
      sizeof(bf16) * (kCbStages * TILE + D / 8 * KPL + kCbWG * 8 * PPL) +
      sizeof(float) * (kCbStages * GBT + DQT + 2 * kCbStages * kCbBQ) +
      sizeof(uint64_t) * kCbStages;
};

// Query tiles: O groups of P rows (K1: output rows; K2: O = 1, P = N), each
// cut into ceil(P / 64) tiles; the last tile of a group is masked past P.
struct CapTiles {
  int P, per_group;
  __device__ explicit CapTiles(int p) : P(p), per_group((p + kCbBQ - 1) / kCbBQ) {}
  // the valid rows of tile i, and its first row n0 in [0, O * P)
  __device__ int rows(int i, long& n0) const {
    const int o = i / per_group, p0 = (i % per_group) * kCbBQ;
    n0 = static_cast<long>(o) * P + p0;
    return min(kCbBQ, P - p0);
  }
};

// Statistics, one warpgroup per (h, query tile, b), the heads of a tile
// side by side so that their g rows come from L2: lse2 = log2 sum_t
// exp2(s * c) and c = sum_t g/H * p over all T keys, online (a running max,
// the sums rescaled when it moves). K1 builds the tile's queries
// bf16(ww . tt[b, h, o]) and writes them to q [B, H, N, D] for the backward;
// K2 (kQ) reads them from q. Zeroes the tile's rows of dq_acc.
template <int D, bool kQ>
__global__ void __launch_bounds__(128)
    capture_stats_kernel(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tg,
                         const bf16* __restrict__ tt, const bf16* __restrict__ ww,
                         bf16* __restrict__ q, float* __restrict__ lse2, float* __restrict__ cvec,
                         float* __restrict__ dq_acc, int H, int O, int X, int P, int T, float c,
                         float inv_h) {
  using C = CapBwdCfg<D>;
  constexpr int ST = kCbStatStages, BK = kCbBK, KS = C::KS;
  extern __shared__ __align__(1024) unsigned char smem[];
  const int xsteps = kQ ? 0 : (X + 15) / 16, XP = 16 * xsteps;
  bf16* Ks = reinterpret_cast<bf16*>(smem);                  // [stage] k tiles (TMA)
  float* Gs = reinterpret_cast<float*>(Ks + ST * C::TILE);   // [stage] g tiles (TMA)
  bf16* Qs = reinterpret_cast<bf16*>(Gs + ST * kCbGT);       // the tile's queries
  bf16* Ts = Qs + C::PTILE;                                  // K1: tt[b, h, o] [XP][LD]
  uint64_t* full = reinterpret_cast<uint64_t*>(Ts + XP * C::LD);  // [stage]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x, b = blockIdx.z;
  const CapTiles tl(P);
  long n0;
  const int rows = tl.rows(blockIdx.y, n0);
  const int o = blockIdx.y / tl.per_group, p0 = n0 - static_cast<long>(o) * P;
  const long N = static_cast<long>(O) * P, bh = static_cast<long>(b) * H + h;
  const int tiles = (T + BK - 1) / BK;

  if (tid == 0) {
    for (int st = 0; st < ST; ++st) mbar_init(&full[st], 1);
    mbar_fence_init();
  }
  __syncthreads();
  // k tile j (rows past T zero) and the g tile of the same keys (columns past
  // T and rows past B * N zero) by TMA on the stage's mbarrier, 128-byte rows
  auto issue = [&](int j) {
    const int st = j % ST;
    mbar_expect_tx(&full[st], C::STX);
    for (int cb = 0; cb < C::CB; ++cb)
      tma_load_4d(Ks + st * C::TILE + cb * 64 * 64, &tk, 64 * cb, h, j * BK, b, &full[st]);
    for (int cb = 0; cb < BK / 32; ++cb)
      tma_load_2d(Gs + st * kCbGT + cb * kCbBQ * 32, &tg, j * BK + 32 * cb,
                  static_cast<int>(b * N + n0), &full[st]);
  };
  if (tid == 0)
    for (int j = 0; j < ST - 1 && j < tiles; ++j) issue(j);

  if constexpr (kQ) {
    load_chunked_async<D / 8, kCbBQ>(Qs, q + (bh * N + n0) * D, D, rows, D, tid, 128);
    cp_async_commit();
    cp_async_wait_all();
  } else {
    load_tile_async<D / 8>(Ts, C::LD, tt + ((bh * O + o) * X) * D, D, XP, X, D);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();  // tt in shared memory
    uint32_t wf[kCapMaxX / 16][4], qf[KS][4];
    ww_frags(wf, ww, p0 + 16 * warp, P, X, lane);
    resize_frags<D>(qf, wf, Ts, C::LD, xsteps, lane);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<uint32_t*>(Qs + (2 * ks + (i >> 1)) * C::PPL +
                                     (16 * warp + g + 8 * (i & 1)) * 8 + 2 * t) = qf[ks][i];
  }
  fence_proxy_async();
  __syncthreads();  // the tile's queries in shared memory
  if constexpr (!kQ)
    for (int i = tid; i < rows * (D / 8); i += 128) {
      const int r = i / (D / 8), ch = i % (D / 8);
      *reinterpret_cast<uint4*>(q + (bh * N + n0 + r) * D + 8 * ch) =
          *reinterpret_cast<const uint4*>(Qs + ch * C::PPL + r * 8);
    }
  float4* z = reinterpret_cast<float4*>(dq_acc + (bh * N + n0) * D);
  for (int i = tid; i < rows * D / 4; i += 128) z[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  float m_r[2] = {-CUDART_INF_F, -CUDART_INF_F}, l_r[2] = {0.f, 0.f}, a_r[2] = {0.f, 0.f};
  for (int j = 0; j < tiles; ++j) {
    if (j > 0) __syncthreads();  // every warp is done with tile j - 1's stage
    if (tid == 0 && j + ST - 1 < tiles) issue(j + ST - 1);
    const int st = j % ST;
    mbar_wait(&full[st], (j / ST) & 1);
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      wgmma_m64n64k16_ss(s, desc_kmajor<C::PPL>(Qs, 0, 2 * ks),
                         desc_sw128_kmajor<BK>(Ks + st * C::TILE, ks), ks > 0);
    wgmma_commit();
    wgmma_wait0();
    reg_fence(s);
    const int k0 = j * BK;
    if (k0 + BK > T)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + 8 * jj + 2 * t + (e & 1) >= T) s[4 * jj + e] = -CUDART_INF_F;
    const float* gt = Gs + st * kCbGT;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) mx = fmaxf(mx, fmaxf(s[4 * jj + 2 * r], s[4 * jj + 2 * r + 1]));
      const float m_new = fmaxf(m_r[r], quad_max(mx));  // finite: every tile has a valid key
      const float alpha = fast_exp2((m_r[r] - m_new) * c), mc = m_new * c;
      m_r[r] = m_new;
      const int row = 16 * warp + g + 8 * r;
      float sum = 0.f, ga = 0.f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float2 gv = *reinterpret_cast<const float2*>(gt + sw128_f32<kCbBQ>(row, 8 * jj + 2 * t));
        const float e0 = fast_exp2(fmaf(s[4 * jj + 2 * r], c, -mc));
        const float e1 = fast_exp2(fmaf(s[4 * jj + 2 * r + 1], c, -mc));
        sum += e0 + e1;
        ga = fmaf(e0, gv.x, fmaf(e1, gv.y, ga));
      }
      l_r[r] = fmaf(l_r[r], alpha, sum);
      a_r[r] = fmaf(a_r[r], alpha, ga);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = quad_sum(l_r[r]), a = quad_sum(a_r[r]);
    const int row = 16 * warp + g + 8 * r;
    if (row < rows && t == 0) {
      const long idx = bh * N + n0 + row;
      lse2[idx] = m_r[r] * c + log2f(l);
      cvec[idx] = a / l * inv_h;
    }
  }
}

// The backward, one block of two warpgroups per (h, 128 keys, b), heads
// side by side so that their g tiles come from L2, walking every query
// tile. Each warpgroup owns 64 of the keys; with the queries as the rows,
//   s    = q . k^T                       m64n64k16, q and k from shared memory
//   dsim = (g/H - c) * p * scale, p = exp2(s * c - lse2), rounded to bf16
//   dq_t = bf16(dsim) . k                m64nDk16, dsim from registers, k MN-major
//   dk  += bf16(dsim)^T . q              m64nDk16, dsim^T and q MN-major, through
//                                         shared memory
// Three products and one exponential per score. q and g tiles stream by TMA
// (128-byte rows, 128-byte swizzle) into a 2-stage ring shared by both
// warpgroups, one tile ahead; lse2 and c by cp.async. dk stays in registers
// and is written once. The two warpgroups' dq of a tile are summed in shared
// memory (fp32, in a fixed order) and each valid row is added into dq_acc
// by one bulk reduce-add (fp32, in L2). Rows past a group's P and keys past
// T give dsim = 0.
//
// kPrecise (capture_fp32_bwd; the TPU kernel's precise=True keeps dsim fp32
// through both contractions): wgmma takes no fp32 operands, so dsim is split
// into hi = bf16(dsim) and lo = bf16(dsim - hi), 16 of its 24 significand
// bits, and both products take both halves: dq = hi . k + lo . k and
// dk += hi^T . q + lo^T . q, all summed in fp32. No second set of fragments
// or dsim tile is held: lo goes to shared memory in the dq tile's space
// (free until the tile's dq is summed there), laid out as the dsim tile, so
// that the dk product reads it as it reads hi; the dq product then takes lo
// in a second sweep of the same four 16-key steps, each thread reading back
// the fragments it wrote. Twice the products of the default kernel.
template <int D, bool kPrecise>
__global__ void __launch_bounds__(kCbWG * 128, 1)
    capture_bwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tg,
                       const bf16* __restrict__ k, const float* __restrict__ lse2,
                       const float* __restrict__ cvec, float* __restrict__ dq_acc,
                       bf16* __restrict__ dk, int H, int O, int P, int T, float scale,
                       float inv_h) {
  using C = CapBwdCfg<D>;
  constexpr int ST = kCbStages, BQ = kCbBQ, KB = kCbKB, KS = C::KS, KPL = C::KPL;
  constexpr int NT = kCbWG * 128;
  static_assert(kCbWG * 8 * C::PPL * sizeof(bf16) <= C::DQT * sizeof(float),
                "the lo tiles must fit in the dq tile's space");
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);                 // [stage] q tiles (TMA)
  float* Gs = reinterpret_cast<float*>(Qs + ST * C::TILE);  // [stage] g tiles [BQ][KB] (TMA)
  float* Dq = Gs + ST * C::GBT;                             // the tile's dq [BQ][DQLD]
  bf16* Ks = reinterpret_cast<bf16*>(Dq + C::DQT);          // this block's keys [D / 8][KPL]
  bf16* Sts = Ks + D / 8 * KPL;                             // [WG] dsim [8][BQ][8]
  float* Ls = reinterpret_cast<float*>(Sts + kCbWG * 8 * C::PPL);  // [stage][BQ] lse2
  float* Cs = Ls + ST * BQ;                                 // [stage][BQ] c
  uint64_t* full = reinterpret_cast<uint64_t*>(Cs + ST * BQ);  // [stage]

  const int tid = threadIdx.x, wg = tid / 128, wt = tid % 128, warp = wt / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x, k0 = blockIdx.y * KB, b = blockIdx.z;
  const int kw = 64 * wg;  // this warpgroup's first key within the block
  const float c = scale * kLog2e;
  const long N = static_cast<long>(O) * P, bh = static_cast<long>(b) * H + h;
  const long krow = static_cast<long>(H) * D;
  const CapTiles tl(P);
  const int tiles = O * tl.per_group;
  bf16* St = Sts + wg * 8 * C::PPL;
  bf16* Lo = reinterpret_cast<bf16*>(Dq) + wg * 8 * C::PPL;  // kPrecise: [WG] lo [8][BQ][8]

  load_chunked_async<D / 8, KB>(Ks, k + (static_cast<long>(b) * T + k0) * krow + h * D, krow,
                                min(KB, T - k0), D, tid, NT);
  if (tid == 0) {
    for (int st = 0; st < ST; ++st) mbar_init(&full[st], 1);
    mbar_fence_init();
  }
  __syncthreads();
  auto issue = [&](int i) {
    long n0;
    const int rows = tl.rows(i, n0), st = i % ST;
    if (tid == 0) {
      mbar_expect_tx(&full[st], C::TX);
      for (int cb = 0; cb < C::CB; ++cb)
        tma_load_4d(Qs + st * C::TILE + cb * 64 * 64, &tq, 64 * cb, 0, static_cast<int>(n0),
                    static_cast<int>(bh), &full[st]);
      for (int cb = 0; cb < KB / 32; ++cb)
        tma_load_2d(Gs + st * C::GBT + cb * BQ * 32, &tg, k0 + 32 * cb, static_cast<int>(b * N + n0),
                    &full[st]);
    }
    if (tid < BQ) {
      const long at = bh * N + n0 + min(tid, rows - 1);
      cp_async4(Ls + st * BQ + tid, lse2 + at, tid < rows);
      cp_async4(Cs + st * BQ + tid, cvec + at, tid < rows);
    }
  };
  for (int i = 0; i < ST - 1; ++i) {  // one commit group per tile, k with the first
    if (i < tiles) issue(i);
    cp_async_commit();
  }
  cp_async_wait_all();  // k, read by wgmma
  fence_proxy_async();

  float dk_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = 0.f;
  const bool reducer = wg == kCbWG - 1 && wt < BQ;  // issues the bulk reduce-add of row wt

  for (int it = 0; it < tiles; ++it) {
    if (reducer) bulk_wait_read0();  // the last tile's dq rows have left shared memory
    cp_async_wait<ST - 2>();         // lse2 and c of tile `it`
    __syncthreads();  // ... visible; every warp is done with tile it - 1's stage and dq
    if (it + ST - 1 < tiles) issue(it + ST - 1);
    cp_async_commit();
    const int st = it % ST;
    long n0;
    const int rows = tl.rows(it, n0);
    mbar_wait(&full[st], (it / ST) & 1);  // q and g of tile `it`
    const bf16* qt = Qs + st * C::TILE;
    const float* gt = Gs + st * C::GBT;

    float s[32];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      wgmma_m64n64k16_ss(s, desc_sw128_kmajor<BQ>(qt, ks), desc_kmajor<KPL>(Ks, kw, 2 * ks), ks > 0);
    wgmma_commit();
    wgmma_wait0();
    reg_fence(s);
    const bool edge = rows < BQ || k0 + kw + 64 > T;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * warp + g + 8 * r;
      const float lr = Ls[st * BQ + row], cr = Cs[st * BQ + row];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float2 gv = *reinterpret_cast<const float2*>(gt + sw128_f32<BQ>(row, kw + 8 * jj + 2 * t));
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * jj + 2 * r + e;
          const float p = fast_exp2(fmaf(s[i], c, -lr));
          const float ds = ((e ? gv.y : gv.x) * inv_h - cr) * p * scale;
          s[i] = edge && (row >= rows || k0 + kw + 8 * jj + 2 * t + e >= T) ? 0.f : ds;
        }
      }
    }
    // this thread's word of fragment i of 16-key step kk in a [8][BQ][8] tile
    auto frag_at = [&](int kk, int i) {
      return (2 * kk + (i >> 1)) * C::PPL + (16 * warp + g + 8 * (i & 1)) * 8 + 2 * t;
    };
    uint32_t da[4][4];  // bf16(dsim) as A fragments of the four 16-key steps
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float s0 = s[8 * kk + 2 * i], s1 = s[8 * kk + 2 * i + 1];
        da[kk][i] = pack_bf16(s0, s1);
        *reinterpret_cast<uint32_t*>(St + frag_at(kk, i)) = da[kk][i];
        if constexpr (kPrecise) *reinterpret_cast<uint32_t*>(Lo + frag_at(kk, i)) = pack_bf16_rem(s0, s1);
      }
    float dq[D / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_pv<D>(dq, da[kk], desc_mnmajor<KPL>(Ks, kw + 16 * kk, 0), kk > 0);
    wgmma_commit();
    fence_proxy_async();
    __syncthreads();  // dsim (and lo) of all four warps of each warpgroup in shared memory
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_pv_ss<D>(dk_acc, desc_mnmajor<C::PPL>(St, 16 * kk, 0), desc_sw128_mnmajor<BQ>(qt, 16 * kk),
                     1);
    if constexpr (kPrecise)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_pv_ss<D>(dk_acc, desc_mnmajor<C::PPL>(Lo, 16 * kk, 0),
                       desc_sw128_mnmajor<BQ>(qt, 16 * kk), 1);
    wgmma_commit();
    wgmma_wait0();
    reg_fence(dq);
    reg_fence(dk_acc);
    frag_fence(da);
    if constexpr (kPrecise) {  // the second sweep: dq += lo . k
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) da[kk][i] = *reinterpret_cast<const uint32_t*>(Lo + frag_at(kk, i));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_pv<D>(dq, da[kk], desc_mnmajor<KPL>(Ks, kw + 16 * kk, 0), 1);
      wgmma_commit();
      wgmma_wait0();
      reg_fence(dq);
      frag_fence(da);
      __syncthreads();  // every warpgroup's products are done with lo before dq overwrites it
    }
    // dq of the tile: warpgroup 0 writes, warpgroup 1 adds, in this order
#pragma unroll
    for (int w = 0; w < kCbWG; ++w) {
      if (wg == w)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            float2* at = reinterpret_cast<float2*>(Dq + (16 * warp + g + 8 * r) * C::DQLD + 8 * j + 2 * t);
            const float2 v = w == 0 ? make_float2(0.f, 0.f) : *at;
            *at = make_float2(v.x + dq[4 * j + 2 * r], v.y + dq[4 * j + 2 * r + 1]);
          }
      if (w == kCbWG - 1) fence_proxy_async();
      __syncthreads();  // warpgroup w's dq in shared memory
    }
    if (reducer && wt < rows) {  // one bulk reduce-add of each valid row
      bulk_reduce_add_f32(dq_acc + (bh * N + n0 + wt) * D, Dq + wt * C::DQLD, D * 4);
      bulk_commit();
    }
  }
  if (reducer) bulk_wait0();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + kw + 16 * warp + g + 8 * r;
    if (key >= T) continue;
    bf16* dst = dk + (static_cast<long>(b) * T + key) * krow + h * D + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) = pack_bf16(dk_acc[4 * j + 2 * r], dk_acc[4 * j + 2 * r + 1]);
  }
}

// K1's finish, one block per (o, h, b): dt[b,h,o] [X, D] = ww^T [X, P] .
// bf16(dq[b, h, o*P .. o*P + P - 1]) with fp32 sums (mma.sync), rounded to bf16
template <int D>
__global__ void __launch_bounds__(kCapWarps * 32)
    capture_dt_kernel(const float* __restrict__ dq_acc, const bf16* __restrict__ ww,
                      bf16* __restrict__ dt, int H, int O, int X, int P) {
  constexpr int LD = tile_ld(D), VT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Dq = reinterpret_cast<bf16*>(smem);  // [BQ][LD] bf16(dq), rows >= P zero
  const int o = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const long bh = static_cast<long>(b) * H + h;
  const float* src = dq_acc + (bh * O + o) * P * D;
  for (int i = threadIdx.x; i < kCapBQ * (D / 4); i += blockDim.x) {
    const int r = i / (D / 4), c4 = i % (D / 4);
    const float4 v = r < P ? *reinterpret_cast<const float4*>(src + static_cast<long>(r) * D + 4 * c4)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    uint32_t* d = reinterpret_cast<uint32_t*>(Dq + r * LD + 4 * c4);
    d[0] = pack_bf16(v.x, v.y);
    d[1] = pack_bf16(v.z, v.w);
  }
  __syncthreads();
  // (x block, 8 columns) items
  const int xsteps = (X + 15) / 16, items = xsteps * VT;
  auto w = [&](int p, int x) { return (p < P && x < X) ? __bfloat162float(ww[p * X + x]) : 0.f; };
  for (int it = warp; it < items; it += kCapWarps) {
    const int xm = it / VT, j = it % VT;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < kCapBQ / 16; ++kk) {
      const int x = 16 * xm + g, p = 16 * kk + 2 * t;
      const uint32_t a[4] = {pack_bf16(w(p, x), w(p + 1, x)), pack_bf16(w(p, x + 8), w(p + 1, x + 8)),
                             pack_bf16(w(p + 8, x), w(p + 9, x)),
                             pack_bf16(w(p + 8, x + 8), w(p + 9, x + 8))};
      uint32_t bb[2];
      load_b(bb, Dq + 16 * kk * LD, LD, 8 * j, lane);
      mma_bf16(acc, a, bb);
    }
    bf16* dst = dt + (bh * O + o) * X * D + 8 * j + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int x = 16 * xm + g + 8 * r;
      if (x < X)
        *reinterpret_cast<uint32_t*>(dst + static_cast<long>(x) * D) = pack_bf16(acc[2 * r], acc[2 * r + 1]);
    }
  }
}

// K2's finish: dq [B, H, N, D] bf16 <- dq_acc (same layout), 8 values a thread
__global__ void capture_dq_kernel(const float* __restrict__ acc, bf16* __restrict__ dq, long chunks) {
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= chunks) return;
  const float4 x = reinterpret_cast<const float4*>(acc)[2 * i];
  const float4 y = reinterpret_cast<const float4*>(acc)[2 * i + 1];
  uint4 v;
  v.x = pack_bf16(x.x, x.y);
  v.y = pack_bf16(x.z, x.w);
  v.z = pack_bf16(y.x, y.y);
  v.w = pack_bf16(y.z, y.w);
  reinterpret_cast<uint4*>(dq)[i] = v;
}

// ---------------------------------------------------------------------------
// The d-64 backward (SD-2.x, SDXL: 20 heads of 64 at the captured layers):
// a rows pass and a keys pass, no reduce-adds (see the source note).

constexpr int kC6BQ = 64;             // query rows a tile
constexpr int kC6KeyWG = 4;           // keys pass: warpgroups a block, 64 keys each
constexpr int kC6KB = 64 * kC6KeyWG;  // keys a keys-pass block
constexpr int kC6RowWG = 2;           // rows pass: warpgroups a block
constexpr int kC6RowStages = 2;       // rows pass: k tiles in each warpgroup's ring
constexpr int kC6RowKeys = 128;       // rows pass: keys a k tile (TMA boxes of 64)
constexpr int kC6KeyStages = 2;       // keys pass: q and g tiles in the ring
constexpr int kC6Tile = 64 * 64;      // a [64][64] bf16 tile, one 128-byte swizzle TMA box
constexpr int kC6GT = kC6BQ * kC6KB;  // a keys-pass g tile [64 rows][256 keys] fp32
constexpr int kC6LD = tile_ld(64);    // tt and bf16(dq) rows (ldmatrix), 72
constexpr int kC6MaxSplits = 8;

// rows pass: g [Tp / 32][64][32] fp32; k ring [WG][stage]; K1 tt [WG][XP][LD]
// and bf16(dq) [WG][64][LD]; mbarriers (g, full [WG][stage], empty [WG][stage])
static size_t rows64_bytes(int Tp, int XP, bool kq) {
  return sizeof(float) * Tp * 64 + sizeof(bf16) * kC6RowWG * kC6RowStages * kC6RowKeys * 64 +
         (kq ? 0 : sizeof(bf16) * kC6RowWG * (XP + 64) * kC6LD) +
         sizeof(uint64_t) * (1 + 2 * kC6RowWG * kC6RowStages);
}
// keys pass: k [256][64]; q [stage]; g [stage]; lse2 and c [2][WG][2][64];
// mbarriers (full [stage], empty [stage], k)
constexpr size_t kC6KeysBytes =
    sizeof(bf16) * (kC6KB * 64 + kC6KeyStages * kC6Tile) +
    sizeof(float) * (kC6KeyStages * kC6GT + 2 * kC6KeyWG * 2 * kC6BQ) +
    sizeof(uint64_t) * (2 * kC6KeyStages + 1);

// s [64 x KT] (+)= q . k^T for a 64- or 128-key tile, q from registers
template <int KT>
__device__ __forceinline__ void wgmma_qk(float (&s)[KT / 2], const uint32_t (&a)[4], uint64_t b_desc,
                                         int accumulate) {
  if constexpr (KT == 128)
    wgmma_m64n128k16(s, a, b_desc, accumulate);
  else
    wgmma_m64n64k16(s, a, b_desc, accumulate);
}

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
//      (bf16; kPrecise: bf16 hi + lo) and dq += dsim . k (m64n64k16, dsim
//      from registers, k MN-major from the same ring stage).
// dq is whole in registers after the sweep: K2 writes it as bf16 in q's
// layout; K1 stages bf16(dq) in shared memory and writes dt = ww^T . bf16(dq)
// of its columns (mma.sync): bf16 dt where a row is one tile (P <= 64), else
// an fp32 partial per tile of the row, summed in order by dt_sum_kernel.
// No atomics: dq and dt are bitwise reproducible. A product's accumulator
// registers are touched only after its wait (else ptxas serializes every
// product: C7514 / C7515).
template <bool kQ, bool kPrecise>
__global__ void __launch_bounds__(kC6RowWG * 128, 1)
    capture_rows64_kernel(const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tg, const bf16* __restrict__ tt,
                          const bf16* __restrict__ ww, bf16* __restrict__ q,
                          float* __restrict__ lse2, float* __restrict__ cvec,
                          bf16* __restrict__ out, float* __restrict__ dt_part, int H, int O, int X,
                          int P, int T, float scale, float inv_h) {
  constexpr int NWG = kC6RowWG, ST = kC6RowStages, LD = kC6LD, KT = kC6RowKeys, KTILE = KT * 64;
  extern __shared__ __align__(1024) unsigned char smem[];
  const int Tp = (T + KT - 1) / KT * KT, nkt = Tp / KT;
  const int xsteps = kQ ? 0 : (X + 15) / 16, XP = 16 * xsteps;
  float* Gs = reinterpret_cast<float*>(smem);                // [Tp / 32][64][32] g (TMA)
  bf16* Ks = reinterpret_cast<bf16*>(Gs + Tp * 64);          // [WG][stage] k tiles [KT][64] (TMA)
  bf16* Ts = Ks + NWG * ST * KTILE;                          // K1: [WG][XP][LD] tt[b, h, o]
  bf16* Dqs = Ts + NWG * XP * LD;                            // K1: [WG][64][LD] bf16(dq)
  uint64_t* gfull = reinterpret_cast<uint64_t*>(Dqs + (kQ ? 0 : NWG * 64 * LD));
  uint64_t* full = gfull + 1;       // [WG][stage]
  uint64_t* empty = full + NWG * ST;  // [WG][stage]

  const int tid = threadIdx.x, wg = tid / 128, wt = tid % 128, warp = wt / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y, hs = blockIdx.z, HS = gridDim.z;  // the heads hs, hs + HS, ...
  const CapTiles tl(P);
  long n0;
  const int rows = tl.rows(blockIdx.x, n0);
  const int o = blockIdx.x / tl.per_group, half = blockIdx.x % tl.per_group, p0 = half * kC6BQ;
  const long N = static_cast<long>(O) * P;
  const float c = scale * kLog2e, gs = inv_h * scale;
  const int row0 = 16 * warp + g;  // this thread's rows of the tile: row0, row0 + 8

  if (tid == 0) {
    mbar_init(gfull, 1);
    for (int i = 0; i < NWG * ST; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4);  // one arrival per warp of the warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {  // the tile's g rows over every key (columns past T and rows past B N zero)
    mbar_expect_tx(gfull, Tp * 64 * 4);
    for (int cb = 0; cb < Tp / 32; ++cb)
      tma_load_2d(Gs + cb * 64 * 32, &tg, 32 * cb, static_cast<int>(b * N + n0), gfull);
  }

  // this warpgroup's ring: stage i is (head j, sweep, key tile) in order,
  // a tile two 64-key TMA boxes
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
    for (int hb = 0; hb < KT / 64; ++hb)
      tma_load_4d(my_ks + (i % ST) * KTILE + hb * kC6Tile, &tk, 0, head(i / (2 * nkt)),
                  (i % nkt) * KT + 64 * hb, b, &my_full[i % ST]);
  };
  // stage i's products are done in each warp: its arrival, then the
  // warpgroup's first thread refills the stage with stage i + ST
  auto release = [&](int i) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&my_empty[i % ST]);
    if (wt == 0) {
      mbar_wait(&my_empty[i % ST], (i / ST) & 1);
      issue_k(i + ST);
    }
  };
  if (wt == 0)
    for (int i = 0; i < ST; ++i) issue_k(i);

  auto load_tt = [&](int h) {  // K1: tt[b, h, o] into this warpgroup's buffer, rows >= X zero
    const bf16* src = tt + ((static_cast<long>(b) * H + h) * O + o) * X * 64;
    bf16* dst = Ts + wg * XP * LD;
    for (int idx = wt; idx < XP * 8; idx += 128) {
      const int r = idx / 8, c8 = idx % 8;
      cp_async16(dst + r * LD + 8 * c8, r < X ? src + r * 64 + 8 * c8 : src, r < X);
    }
    cp_async_commit();
  };
  uint32_t wf[kCapMaxX / 16][4];  // K1: ww fragments of this warp's 16 rows
  if constexpr (!kQ) {
    ww_frags(wf, ww, p0 + 16 * warp, P, X, lane);
    if (my_heads > 0) load_tt(head(0));
  }
  mbar_wait(gfull, 0);

  int i = 0;  // ring stages consumed by this warpgroup
  for (int j = 0; j < my_heads; ++j) {
    const int h = head(j);
    const long bh = static_cast<long>(b) * H + h;
    uint32_t qf[4][4];
    if constexpr (kQ) {
      q_frags<64>(qf, q + (bh * N + n0) * 64, 16 * warp, rows, lane);
    } else {
      cp_async_wait_all();
      named_bar_sync(1 + wg, 128);  // tt of head h in the buffer
      resize_frags<64>(qf, wf, Ts + wg * XP * LD, LD, xsteps, lane);
      named_bar_sync(1 + wg, 128);  // every warp has read it
      if (j + 1 < my_heads) load_tt(head(j + 1));
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (row0 + 8 * r < rows) {
          uint32_t* dst = reinterpret_cast<uint32_t*>(q + (bh * N + n0 + row0 + 8 * r) * 64 + 2 * t);
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
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
      for (int ks = 0; ks < 4; ++ks) wgmma_qk<KT>(s, qf[ks], desc_sw128_kmajor<KT>(kst, ks), ks > 0);
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
      if (k0 + KT > T)
#pragma unroll
        for (int jj = 0; jj < KT / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k0 + 8 * jj + 2 * t + (e & 1) >= T) s[4 * jj + e] = -CUDART_INF_F;
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

    // sweep 2: dq = sum over the key tiles of dsim . k (m64n64k16, dsim from
    // registers, k MN-major from the same stage); a tile's scores are formed
    // while the last tile's dq product runs, and its stage released once
    // that product is done
    float dq[32];
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
            s[idx] = row < rows && key + e < T ? ds : 0.f;
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
      for (int kk = 0; kk < KT / 16; ++kk)
        wgmma_pv<64>(dq, da[kk], desc_sw128_mnmajor<KT>(kst, 16 * kk), kt > 0 || kk > 0);
      if constexpr (kPrecise)
#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk) wgmma_pv<64>(dq, dl[kk], desc_sw128_mnmajor<KT>(kst, 16 * kk), 1);
      wgmma_commit();
    }
    wgmma_wait0();
    reg_fence(dq);
    frag_fence(da);
    if constexpr (kPrecise) frag_fence(dl);
    frag_fence(qf);
    release(i - 1);

    if constexpr (kQ) {  // K2: dq as bf16, in q's layout
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (row0 + 8 * r < rows) {
          bf16* dst = out + (bh * N + n0 + row0 + 8 * r) * 64 + 2 * t;
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
            *reinterpret_cast<uint32_t*>(dst + 8 * jj) = pack_bf16(dq[4 * jj + 2 * r], dq[4 * jj + 2 * r + 1]);
        }
    } else {  // K1: dt of these columns, ww^T . bf16(dq), by mma.sync
      bf16* dqs = Dqs + wg * 64 * LD;
      named_bar_sync(1 + wg, 128);  // the last head's dt products are done with the staging
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
          *reinterpret_cast<uint32_t*>(dqs + (row0 + 8 * r) * LD + 8 * jj + 2 * t) =
              row0 + 8 * r < rows ? pack_bf16(dq[4 * jj + 2 * r], dq[4 * jj + 2 * r + 1]) : 0u;
      named_bar_sync(1 + wg, 128);
      auto w = [&](int p, int x) { return (p < P && x < X) ? __bfloat162float(ww[p * X + x]) : 0.f; };
      for (int it = warp; it < xsteps * 8; it += 4) {  // (16 x rows, 8 columns) items
        const int xm = it / 8, jc = it % 8, x = 16 * xm + g;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int p = p0 + 16 * kk + 2 * t;
          const uint32_t a[4] = {pack_bf16(w(p, x), w(p + 1, x)), pack_bf16(w(p, x + 8), w(p + 1, x + 8)),
                                 pack_bf16(w(p + 8, x), w(p + 9, x)),
                                 pack_bf16(w(p + 8, x + 8), w(p + 9, x + 8))};
          uint32_t bb[2];
          load_b(bb, dqs + 16 * kk * LD, LD, 8 * jc, lane);
          mma_bf16(acc, a, bb);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int xr = x + 8 * r;
          if (xr >= X) continue;
          const long at = ((bh * O + o) * X + xr) * 64 + 8 * jc + 2 * t;
          if (tl.per_group == 1)
            *reinterpret_cast<uint32_t*>(out + at) = pack_bf16(acc[2 * r], acc[2 * r + 1]);
          else
            *reinterpret_cast<float2*>(dt_part + ((bh * O + o) * 2 + half) * X * 64 +
                                       static_cast<long>(xr) * 64 + 8 * jc + 2 * t) =
                make_float2(acc[2 * r], acc[2 * r + 1]);
        }
      }
    }
  }
}

// The keys pass, one block per (256 keys, h, b, z): four warpgroups of 64
// keys walking query tiles [first, last) of the (b, h), z's share of them.
// The block's first thread streams each tile's q [64][64] (from q [B, H, N,
// D]) and g [64 rows][256 keys] fp32 by TMA through a two-stage ring; lse2
// and c of the tile's rows, from the rows pass, go through a small
// per-warpgroup staging one tile ahead. Each warpgroup works with its keys
// as the rows of every product:
//   s^T  = k . q^T                  m64n64k16, both from shared memory
//   dsim^T = (g/H - c) * p * scale  per element, as in the rows pass
//   dk  += bf16(dsim^T) . q         m64n64k16, dsim^T from registers (the
//                                   scores' accumulator layout is the A
//                                   fragment layout), q MN-major
// so dsim never goes through shared memory and a warpgroup waits for no
// other. dk stays in registers: bf16 dk when the (b, h)'s tiles are not
// split (Z = 1), else an fp32 partial per z, summed in order by
// dk_sum_kernel, so dk is bitwise reproducible.
template <bool kPrecise>
__global__ void __launch_bounds__(kC6KeyWG * 128, 1)
    capture_keys64_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tg,
                          const __grid_constant__ CUtensorMap tk, const float* __restrict__ lse2,
                          const float* __restrict__ cvec, bf16* __restrict__ dk,
                          float* __restrict__ dk_part, int H, int O, int P, int T, int Z, long E,
                          float scale, float inv_h) {
  constexpr int ST = kC6KeyStages, NT = kC6KeyWG * 128;
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);                 // [256 keys][64] (TMA boxes of 64)
  bf16* Qs = Ks + kC6KB * 64;                               // [stage] q tiles (TMA)
  float* Gs = reinterpret_cast<float*>(Qs + ST * kC6Tile);  // [stage] g [8][64][32] (TMA)
  float* Ls = Gs + ST * kC6GT;                               // [2][WG][64] lse2 and c * scale
  uint64_t* full = reinterpret_cast<uint64_t*>(Ls + 2 * 2 * kC6KeyWG * kC6BQ);  // [stage]
  uint64_t* empty = full + ST;                                                // [stage]
  uint64_t* kfull = empty + ST;

  const int tid = threadIdx.x, wg = tid / 128, wt = tid % 128, warp = wt / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z / Z, z = blockIdx.z % Z;
  const int k0 = blockIdx.x * kC6KB;
  const long N = static_cast<long>(O) * P, bh = static_cast<long>(b) * H + h;
  const CapTiles tl(P);
  const int tiles = O * tl.per_group;
  const int first = static_cast<int>(static_cast<long>(tiles) * z / Z);
  const int n = static_cast<int>(static_cast<long>(tiles) * (z + 1) / Z) - first;
  const float c = scale * kLog2e, gs = inv_h * scale;

  if (tid == 0) {
    for (int st = 0; st < ST; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 4 * kC6KeyWG);  // one arrival per warp
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
    mbar_expect_tx(&full[st], kC6Tile * 2 + kC6GT * 4);
    tma_load_4d(Qs + st * kC6Tile, &tq, 0, 0, static_cast<int>(m0), static_cast<int>(bh), &full[st]);
    for (int cb = 0; cb < kC6KB / 32; ++cb)
      tma_load_2d(Gs + st * kC6GT + cb * kC6BQ * 32, &tg, k0 + 32 * cb, static_cast<int>(b * N + m0),
                  &full[st]);
  };
  if (tid == 0) {
    mbar_expect_tx(kfull, kC6KB * 64 * 2);
    for (int hb = 0; hb < kC6KB / 64; ++hb)
      tma_load_4d(Ks + hb * kC6Tile, &tk, 0, h, k0 + 64 * hb, b, kfull);
    for (int it = 0; it < ST && it < n; ++it) issue(it);
  }
  // lse2 and c * scale of tile it's rows into the warpgroup's staging it & 1
  // (rows past the tile's repeat its last)
  auto stage_rows = [&](int it) {
    if (wt < kC6BQ) {
      long m0;
      const int rows = tl.rows(first + it, m0);
      const long at = bh * N + m0 + min(wt, rows - 1);
      float* ls = Ls + ((it & 1) * kC6KeyWG + wg) * 2 * kC6BQ;
      ls[wt] = lse2[at];
      ls[kC6BQ + wt] = cvec[at] * scale;
    }
  };

  const int kw = k0 + 64 * wg;  // this warpgroup's first key
  const bf16* Kw = Ks + wg * kC6Tile;
  const int key0 = kw + 16 * warp + g;  // this thread's keys: key0, key0 + 8
  float dk_acc[32];
  if (n > 0) stage_rows(0);
  mbar_wait(kfull, 0);
  for (int it = 0; it < n; ++it) {
    const int st = it % ST;
    long m0;
    const int rows = tl.rows(first + it, m0);
    const bf16* qt = Qs + st * kC6Tile;
    mbar_wait(&full[st], (it / ST) & 1);
    float s[32];  // s^T: this warpgroup's keys x the tile's 64 rows
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_m64n64k16_ss(s, desc_sw128_kmajor<64>(Kw, ks), desc_sw128_kmajor<64>(qt, ks), ks > 0);
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
    const float* gt = Gs + st * kC6GT;
    const float* ls = Ls + ((it & 1) * kC6KeyWG + wg) * 2 * kC6BQ;
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
    for (int kk = 0; kk < 4; ++kk)
      wgmma_pv<64>(dk_acc, da[kk], desc_sw128_mnmajor<64>(qt, 16 * kk), it > 0 || kk > 0);
    if constexpr (kPrecise)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_pv<64>(dk_acc, dl[kk], desc_sw128_mnmajor<64>(qt, 16 * kk), 1);
    wgmma_commit();
  }
  wgmma_wait0();
  reg_fence(dk_acc);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= T || n == 0) continue;
    const long at = ((static_cast<long>(b) * T + key) * H + h) * 64 + 2 * t;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      if (Z == 1)
        *reinterpret_cast<uint32_t*>(dk + at + 8 * jj) = pack_bf16(dk_acc[4 * jj + 2 * r], dk_acc[4 * jj + 2 * r + 1]);
      else
        *reinterpret_cast<float2*>(dk_part + z * E + at + 8 * jj) =
            make_float2(dk_acc[4 * jj + 2 * r], dk_acc[4 * jj + 2 * r + 1]);
    }
  }
}

// dk bf16 <- the sum of its Z fp32 partials in the order z = 0, 1, ..., 4
// values a thread
__global__ void dk_sum_kernel(const float* __restrict__ part, bf16* __restrict__ dk, long E, int Z) {
  const long i = (static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (i >= E) return;
  float4 a = *reinterpret_cast<const float4*>(part + i);
  for (int z = 1; z < Z; ++z) {
    const float4 x = *reinterpret_cast<const float4*>(part + z * E + i);
    a = make_float4(a.x + x.x, a.y + x.y, a.z + x.z, a.w + x.w);
  }
  *reinterpret_cast<uint32_t*>(dk + i) = pack_bf16(a.x, a.y);
  *reinterpret_cast<uint32_t*>(dk + i + 2) = pack_bf16(a.z, a.w);
}

// K1's dt bf16 <- the sum of its two fp32 partials (the tiles of an output
// row of 64 < P <= 128 columns), 4 values a thread; part [B*H*O][2][X*D]
__global__ void dt_sum_kernel(const float* __restrict__ part, bf16* __restrict__ dt, long E, int XD) {
  const long i = (static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (i >= E) return;
  const long row = i / XD, col = i % XD;
  const float4 a = *reinterpret_cast<const float4*>(part + 2 * row * XD + col);
  const float4 x = *reinterpret_cast<const float4*>(part + (2 * row + 1) * XD + col);
  *reinterpret_cast<uint32_t*>(dt + i) = pack_bf16(a.x + x.x, a.y + x.y);
  *reinterpret_cast<uint32_t*>(dt + i + 2) = pack_bf16(a.z + x.z, a.w + x.w);
}

// how many blocks split a query tile's heads in the rows pass (HS, 1 or 2):
// two where that saves waves, e.g. K2 at SD-2.1's 96^2 step (576 tiles of
// 20 heads: 5 waves of 10 heads a warpgroup on 132 SMs, against 9 of 5)
static int rows64_head_splits(int blocks, int H) {
  const int sms = device_sms();
  if (sms < 1) return 1;
  auto cost = [&](int hs) {
    return static_cast<long>((blocks * hs + sms - 1) / sms) *
           (((H + hs - 1) / hs + kC6RowWG - 1) / kC6RowWG);
  };
  return cost(2) < cost(1) ? 2 : 1;
}

// fp32 values of the scratch (dq_acc, B*H*N*D) that K1's dt partials take
static long dt64_part_size(bool kq, int B, int H, int O, int X, int P) {
  return !kq && P > kC6BQ ? 2L * B * H * O * X * 64 : 0;
}

// how many blocks split each (b, h)'s query tiles in the keys pass (Z,
// block_splits): the grid of ceil(T / 256) x H x B blocks fills 40 of the
// H100's 132 SMs at SDXL's tensor-parallel rank and 80 at SDXL's step; only
// as far as the scratch holds the partials (dk in fp32, E values a split)
static int capture_bwd64_splits(int B, int H, int T, int tiles, long room) {
  const long blocks = static_cast<long>((T + kC6KB - 1) / kC6KB) * H * B;
  const long E = static_cast<long>(B) * T * H * 64;
  return block_splits(blocks, tiles, static_cast<double>(E),
                      static_cast<int>(min(static_cast<long>(kC6MaxSplits), room / E)));
}

// The d-64 backward: the rows pass, the keys pass, and the sums of the
// partials. K1: tt, ww given, q [B, H, N, D] scratch, out = dt; K2 (kQ): q
// given, out = dq. dq_acc [B, H, N, D] fp32 is scratch for K1's dt partials
// and the keys pass's dk partials.
template <bool kQ, bool kPrecise>
static int launch_capture_bwd64(const void* tt, const void* ww, const void* k, const void* g,
                                void* q, void* lse, void* c, void* dq_acc, void* out, void* dk,
                                int B, int H, int O, int X, int P, int T, int ldg, float scale,
                                cudaStream_t stream, int total_heads) {
  if (X > kCapMaxX || (!kQ && P > kCapBQ) || ldg % 4 != 0 || ldg < T || total_heads < H ||
      T < 1 || T > kCfKeys)
    return -1;
  const long N = static_cast<long>(O) * P;
  const int tiles = O * ((P + kC6BQ - 1) / kC6BQ), Tp = (T + kC6RowKeys - 1) / kC6RowKeys * kC6RowKeys;
  CUtensorMap tk, tg, tq;
  int e = encode_rows_map(&tk, k, B, T, H, 64, 64, true);
  if (e == 0) e = encode_f32_map(&tg, g, B * N, T, 4L * ldg, kC6BQ);
  if (e == 0) e = encode_rows_map(&tq, q, B * H, N, 1, 64, kC6BQ, true);
  if (e != 0) return e;
  const size_t rows_smem = rows64_bytes(Tp, kQ ? 0 : (X + 15) / 16 * 16, kQ);
  const size_t keys_smem = kC6KeysBytes;
  cudaError_t err = cudaFuncSetAttribute(capture_rows64_kernel<kQ, kPrecise>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)rows_smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(capture_keys64_kernel<kPrecise>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)keys_smem);
  if (err != cudaSuccess) return (int)err;
  const float inv_h = 1.0f / static_cast<float>(total_heads);
  float* scratch = static_cast<float*>(dq_acc);
  const long dtp = dt64_part_size(kQ, B, H, O, X, P), E = static_cast<long>(B) * T * H * 64;
  const int Z = capture_bwd64_splits(B, H, T, tiles, static_cast<long>(B) * H * N * 64 - dtp);
  float* dk_part = scratch + dtp;
  float *lp = static_cast<float*>(lse), *cp = static_cast<float*>(c);
  capture_rows64_kernel<kQ, kPrecise><<<dim3(tiles, B, rows64_head_splits(tiles * B, H)),
                                         kC6RowWG * 128,
                                         rows_smem, stream>>>(
      tk, tg, static_cast<const bf16*>(tt), static_cast<const bf16*>(ww), static_cast<bf16*>(q), lp,
      cp, static_cast<bf16*>(out), scratch, H, O, X, P, T, scale, inv_h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  capture_keys64_kernel<kPrecise><<<dim3((T + kC6KB - 1) / kC6KB, H, B * Z), kC6KeyWG * 128, keys_smem,
                                                 stream>>>(
      tq, tg, tk, lp, cp, static_cast<bf16*>(dk), dk_part, H, O, P, T, Z, E, scale, inv_h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (Z > 1)
    dk_sum_kernel<<<(unsigned)((E / 4 + 255) / 256), 256, 0, stream>>>(dk_part, static_cast<bf16*>(dk), E, Z);
  if (dtp > 0) {
    const long dtE = static_cast<long>(B) * H * O * X * 64;
    dt_sum_kernel<<<(unsigned)((dtE / 4 + 255) / 256), 256, 0, stream>>>(scratch, static_cast<bf16*>(out), dtE,
                                                                        X * 64);
  }
  return (int)cudaGetLastError();
}

// The three passes. K1: tt, ww given, q [B, H, O*P, D] scratch, out = dt;
// K2 (kQ): q given (O = 1, P = N), out = dq. g rows are ldg floats apart
// (ldg % 4 == 0); lse2, c [B, H, N] and dq_acc [B, H, N, D] fp32 are scratch.
template <int D, bool kQ, bool kPrecise>
static int launch_capture_bwd(const void* tt, const void* ww, const void* k, const void* g,
                              void* q, void* lse, void* c, void* dq_acc, void* out, void* dk,
                              int B, int H, int O, int X, int P, int T, int ldg, float scale,
                              cudaStream_t stream, int total_heads) {
  if (X > kCapMaxX || (!kQ && P > kCapBQ) || ldg % 4 != 0 || ldg < T || total_heads < H)
    return -1;
  using C = CapBwdCfg<D>;
  const long N = static_cast<long>(O) * P;
  CUtensorMap tk, tg, tq;
  int e = encode_rows_map(&tk, k, B, T, H, D, kCbBK, true);
  if (e == 0) e = encode_f32_map(&tg, g, B * N, T, 4L * ldg, kCbBQ);
  if (e == 0) e = encode_rows_map(&tq, q, B * H, N, 1, D, kCbBQ, true);
  if (e != 0) return e;
  const size_t stats_smem = C::stats_bytes(kQ ? 0 : (X + 15) / 16 * 16);
  cudaError_t err = cudaFuncSetAttribute(capture_stats_kernel<D, kQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)stats_smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(capture_bwd_kernel<D, kPrecise>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::bwd_bytes);
  if (err != cudaSuccess) return (int)err;
  const float inv_h = 1.0f / static_cast<float>(total_heads);
  const int tiles = O * ((P + kCbBQ - 1) / kCbBQ);
  const bf16 *kp = static_cast<const bf16*>(k), *wwp = static_cast<const bf16*>(ww);
  float *lp = static_cast<float*>(lse), *cp = static_cast<float*>(c), *ap = static_cast<float*>(dq_acc);
  capture_stats_kernel<D, kQ><<<dim3(H, tiles, B), 128, stats_smem, stream>>>(
      tk, tg, static_cast<const bf16*>(tt), wwp, static_cast<bf16*>(q), lp, cp, ap, H, O, X, P, T,
      scale * kLog2e, inv_h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  capture_bwd_kernel<D, kPrecise><<<dim3(H, (T + kCbKB - 1) / kCbKB, B), kCbWG * 128, C::bwd_bytes, stream>>>(
      tq, tg, kp, lp, cp, ap, static_cast<bf16*>(dk), H, O, P, T, scale, inv_h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if constexpr (kQ) {
    const long chunks = B * H * N * D / 8;
    capture_dq_kernel<<<(unsigned)((chunks + 255) / 256), 256, 0, stream>>>(
        ap, static_cast<bf16*>(out), chunks);
  } else {
    capture_dt_kernel<D><<<dim3(O, H, B), kCapWarps * 32, kCapBQ * tile_ld(D) * sizeof(bf16),
                           stream>>>(ap, wwp, static_cast<bf16*>(out), H, O, X, P);
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
      return launch_capture_bwd64<kQ, kPrecise>(tt, ww, k, g, q, lse, c, dq_acc, out, dk, B, H, O,
                                                X, P, T, ldg, scale, s, total_heads);
    case 80:
      return launch_capture_bwd<80, kQ, kPrecise>(tt, ww, k, g, q, lse, c, dq_acc, out, dk, B, H,
                                                  O, X, P, T, ldg, scale, s,
                                                  total_heads);
    case 160:
      return launch_capture_bwd<160, kQ, kPrecise>(tt, ww, k, g, q, lse, c, dq_acc, out, dk, B, H,
                                                   O, X, P, T, ldg, scale, s,
                                                  total_heads);
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
// scratch. -1 for an unsupported head dimension, X > 32, P > 128 or ldg not
// a multiple of 4. The _precise entry keeps dsim fp32 through the products.
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

// Z, the number of blocks the d-64 backward's keys pass splits each (b,
// h)'s query tiles over (1 at the other head dimensions); kq: K2's shapes
// (O = 1, P = N)
extern "C" int skp_capture_bwd_splits(int B, int H, int O, int X, int P, int T, int D, int kq) {
  if (D != 64) return 1;
  const long room = static_cast<long>(B) * H * O * P * 64 - skp::dt64_part_size(kq != 0, B, H, O, X, P);
  return skp::capture_bwd64_splits(B, H, T, O * ((P + 63) / 64), room);
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
