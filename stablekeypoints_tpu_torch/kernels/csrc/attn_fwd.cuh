// Attention forward kernel of K4/K5 (flash.cu), sm_90a. Replaces the
// forward of JAX's stock Pallas TPU flash attention that
// stablekeypoints_tpu/kernels/flash.py calls (flash_self_attention :126,
// flash_cross_attention :187): online softmax (running max, rescaled sum and
// output), out = bf16(sum_t bf16(p_t) v_t / l); optional lse output.
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
// so neither operand is transposed in memory. It issues tile j+1's
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
//
// d 64 (SD-2.x, SDXL) runs attn_fwd_ws_kernel, FlashAttention-3's
// form: there the kernel above (four warpgroups) lost a third of its time
// to the softmax, which ran in lockstep in every warpgroup between
// block-wide barriers (tools/attention_variants.py --d64 on an H100: 2.86 ms
// for [10, 9216, 5, 64], 1.89 without the softmax, no faster without the
// k / v copies). A block holds 128 query rows as two consumer warpgroups and
// one producer warp, whose first lane starts the TMA copies of q and of each
// 128-key tile of k and of v into two-stage rings with full and empty
// mbarriers, so no barrier spans the block after the start. Each tile is
// one box of 128-byte rows in the 128-byte swizzle layout (eight boxes of
// 16-byte rows a tile lost a quarter of the time to the copies: 3.09 ms).
// Scores are m64n128k16 (q and k from shared memory), p . v m64n64k16 with
// p from registers. Each warpgroup keeps the intra-warpgroup overlap above
// (tile j + 1's scores issued with tile j's p . v, its softmax under the
// p . v), and the two take turns at the tensor cores through two named
// barriers ("ping-pong"), so one's softmax runs under the other's products.
// The block is persistent (one an SM, taking the (128 rows, h, b) items in
// turn): the rings run on across items, and the next item's q lands while
// the last item's final p . v and output run. On the H100 (700 W): 2.38 ms
// at [10, 9216, 5, 64] (SDPA 2.19), 0.139 at [10, 1024, 20, 64] (0.139),
// K5's 500 keys 0.082 (0.086); without the ping-pong 2.90 / 0.163 / 0.094,
// one block an item 2.47 / 0.163 / 0.105, three-stage rings slower; what
// bounds it is the softmax (1.61 ms at [10, 9216, 5, 64] without it; the
// exponentials alone 0.28 of its 0.78).
#pragma once

#include "common.cuh"

namespace skp {

constexpr int kFwdBK = 64;  // keys per tile

template <int D>
struct FwdCfg {
  static constexpr int DP = round_up16(D);  // q.k depth, padded
  static constexpr int KS = DP / 16;
  // warpgroups of 64 query rows per block (tools/attention_variants.py):
  // four at d 80, so that k and v cross L2 once per 256 rows (with two the
  // copies bound it at d 64 on an H100: 3.81 ms against 2.81 with four, for
  // [10, 9216, 5, 64]); two at d 40, with two blocks per SM, as the softmax
  // there costs more than the copies
  static constexpr int WGS = D <= 40 ? 2 : 4;
  static constexpr int BQ = 64 * WGS;  // query rows per block
  // tiles st - 1 (p.v), st (scores) and STAGES - 2 loading
  static constexpr int STAGES = 4;
  static constexpr int QTILE = DP / 8 * plane_ld(BQ);  // chunk-major q
  static constexpr int KPL = kFwdBK * 8;               // k and v planes, as TMA writes them
  static constexpr int TILE = DP / 8 * KPL;            // one chunk-major k or v tile
  // k, v [stage]; q; one mbarrier per stage
  static constexpr size_t bytes = sizeof(bf16) * (STAGES * 2 * TILE + QTILE) + sizeof(uint64_t) * STAGES;
  static constexpr int min_blocks = WGS == 4 ? 1 : 2;
};

// q [B,N,H,D]; k, v [B,M,H,D] -> out [B,N,H,D] and, when lse is not null,
// lse [B,H,N] (log2 domain)
template <int D>
__global__ void __launch_bounds__(FwdCfg<D>::WGS * 128, FwdCfg<D>::min_blocks)
    attn_fwd_kernel(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                    const bf16* __restrict__ q, bf16* __restrict__ out, float* __restrict__ lse, int N,
                    int M, int H, float c) {
  using C = FwdCfg<D>;
  constexpr int DP = C::DP, KS = C::KS, BQ = C::BQ, BK = kFwdBK, NT = C::WGS * 128;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* KV = reinterpret_cast<bf16*>(smem);   // [stage][k, v] chunk-major
  bf16* Qs = KV + C::STAGES * 2 * C::TILE;    // chunk-major [BQ][DP]
  uint64_t* full = reinterpret_cast<uint64_t*>(Qs + C::QTILE);  // [stage]

  const int tid = threadIdx.x, warp = (tid / 32) % 4, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int wg0 = (tid / 128) * 64;  // this warpgroup's first row in the block
  const int r0 = wg0 + warp * 16;    // and this warp's
  const long row = static_cast<long>(H) * D;
  const int tiles = (M + BK - 1) / BK;

  auto kt = [&](int st) { return KV + (st % C::STAGES) * 2 * C::TILE; };
  auto vt = [&](int st) { return kt(st) + C::TILE; };
  for (int st = 0; st < C::STAGES; ++st)  // d 40: the q.k padding columns 40..47
    zero_chunks<BK, C::KPL>(kt(st), D / 8, DP / 8, tid, NT);
  // one thread starts the TMA copies of key tile st's D / 8 column chunks
  // of k and v (rows past M arrive as zeros)
  auto issue = [&](int st) {
    if (tid != 0) return;
    const int stage = st % C::STAGES, k0 = st * BK;
    mbar_expect_tx(&full[stage], 2 * (D / 8) * BK * 16);
    for (int ch = 0; ch < D / 8; ++ch) {
      tma_load_4d(kt(st) + ch * C::KPL, &tk, 8 * ch, h, k0, b, &full[stage]);
      tma_load_4d(vt(st) + ch * C::KPL, &tv, 8 * ch, h, k0, b, &full[stage]);
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
  cp_async_commit();
  if (tid == 0) {
    for (int st = 0; st < C::STAGES; ++st) mbar_init(&full[st], 1);
    mbar_fence_init();
  }
  __syncthreads();
  for (int st = 0; st < kAhead && st < tiles; ++st) issue(st);
  cp_async_wait_all();  // q, read by wgmma
  fence_proxy_async();
  advance(0);

  // s = a . k^T for the tile of step st, a this warpgroup's rows of q
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

  // p of a tile into s with the running max updated; alpha rescales the
  // earlier sum and output
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

// ---------------------------------------------------------------------------
// d 64: the warp-specialized kernel (header note)

constexpr int kFwdWsBK = 128;       // keys per tile
constexpr int kFwdWsStages = 2;     // k (and v) tiles in each ring
constexpr int kFwdWsThreads = 288;  // two consumer warpgroups of 64 query rows, a producer warp
constexpr bool kFwdWsPingPong = true;  // the two warpgroups take turns at the tensor cores

template <int D>
struct FwdWsCfg {
  static_assert(D == 64, "attn_fwd_ws_kernel: one 128-byte swizzle block a row");
  static constexpr int TILE = kFwdWsBK * D;  // one q (the block's 128 rows), k or v tile
  // q; k, v [stage]; mbarriers: q full / empty, k full / empty, v full / empty [stage]
  static constexpr size_t bytes =
      sizeof(bf16) * (1 + 2 * kFwdWsStages) * TILE + sizeof(uint64_t) * (2 + 4 * kFwdWsStages);
};

// q, k, v as attn_fwd_kernel's (through tensor maps) -> out [B,N,H,D] and,
// when lse is not null, lse [B,H,N] (log2 domain). Persistent: block i takes
// the items (128 query rows of one (b, h)) i, i + gridDim.x, ...; the k and
// v rings run on across items, and the next item's q is copied while the
// last one's final p . v and output run.
template <int D>
__global__ void __launch_bounds__(kFwdWsThreads, 1)
    attn_fwd_ws_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out,
                       float* __restrict__ lse, int N, int M, int H, int B, float c) {
  using C = FwdWsCfg<D>;
  constexpr int BK = kFwdWsBK, S = kFwdWsStages, KS = D / 16;
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [128][D], 128-byte swizzle
  bf16* Kst = Qs + C::TILE;                  // [stage] [BK][D], 128-byte swizzle
  bf16* Vst = Kst + S * C::TILE;             // [stage]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vst + S * C::TILE);
  uint64_t* q_empty = q_full + 1;
  uint64_t* k_full = q_empty + 1;  // [stage]
  uint64_t* k_empty = k_full + S;  // [stage]
  uint64_t* v_full = k_empty + S;  // [stage]
  uint64_t* v_empty = v_full + S;  // [stage]

  const int tid = threadIdx.x, lane = tid % 32;
  const int qblocks = (N + 127) / 128, items = qblocks * H * B;
  const int tiles = (M + BK - 1) / BK;
  // item -> (first query row, h, b)
  auto decode = [&](int item, int& q0, int& h, int& b) {
    q0 = (item % qblocks) * 128;
    h = (item / qblocks) % H;
    b = item / (qblocks * H);
  };
  if (tid == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 8);  // one arrival per consumer warp
    for (int st = 0; st < S; ++st) {
      mbar_init(&k_full[st], 1);
      mbar_init(&v_full[st], 1);
      mbar_init(&k_empty[st], 8);
      mbar_init(&v_empty[st], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 256) {  // the producer warp: its first lane starts every copy
    if (lane == 0) {
      for (int item = blockIdx.x, n = 0, j = 0; item < items; item += gridDim.x, ++n) {
        int q0, h, b;
        decode(item, q0, h, b);
        // a tile of rows r0 .. r0 + 127, one box of 128-byte rows (rows past N
        // or M arrive as zeros)
        auto load = [&](bf16* dst, const CUtensorMap* map, int r0, uint64_t* bar) {
          mbar_expect_tx(bar, 128 * D * 2);
          tma_load_4d(dst, map, 0, h, r0, b, bar);
        };
        if (n > 0) mbar_wait(q_empty, (n - 1) & 1);  // the last item's scores done
        load(Qs, &tq, q0, q_full);
        for (int jt = 0; jt < tiles; ++jt, ++j) {  // j: tiles through the rings so far
          const int st = j % S;
          if (j >= S) mbar_wait(&k_empty[st], (j / S - 1) & 1);  // that stage's scores done
          load(Kst + st * C::TILE, &tk, jt * BK, &k_full[st]);
          if (j >= S) mbar_wait(&v_empty[st], (j / S - 1) & 1);  // its p . v done
          load(Vst + st * C::TILE, &tv, jt * BK, &v_full[st]);
        }
      }
    }
    return;
  }

  const int wg = tid / 128, warp = (tid / 32) % 4, g = lane >> 2, t = lane & 3;
  const int r0 = 64 * wg + 16 * warp;  // this warp's first row in the block
  // ping-pong: warpgroup wg waits on barrier 1 + wg before it issues its
  // products and then arrives on the other's; warpgroup 0 goes first
  auto turn_wait = [&] {
    if (kFwdWsPingPong) named_bar_sync(1 + wg, 256);
  };
  auto turn_pass = [&] {
    if (kFwdWsPingPong) named_bar_arrive(2 - wg, 256);
  };
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  // ring stage and phase of the tile that is the j-th through the rings
  auto wait_full = [&](uint64_t* full, int j) { mbar_wait(&full[j % S], (j / S) & 1); };

  float s[BK / 2];  // this warpgroup's 64 rows x the tile's 128 keys
  auto scores = [&](int j) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      wgmma_m64n128k16_ss(s, desc_sw128_kmajor<64>(Qs + 64 * wg * D, ks),
                          desc_sw128_kmajor<BK>(Kst + (j % S) * C::TILE, ks), ks > 0);
  };
  float m_r[2], l_r[2];
  // p of the item's tile jt into s with the running max updated; alpha
  // rescales the earlier sum and output. Columns past M are -inf (only the
  // last tile).
  auto softmax = [&](int jt, float (&alpha)[2]) {
    const int k0 = jt * BK;
    if (k0 + BK > M) {
#pragma unroll
      for (int jj = 0; jj < BK / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + 8 * jj + 2 * t + (e & 1) >= M) s[4 * jj + e] = -CUDART_INF_F;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int jj = 0; jj < BK / 8; ++jj) mx = fmaxf(mx, fmaxf(s[4 * jj + 2 * r], s[4 * jj + 2 * r + 1]));
      const float m_new = fmaxf(m_r[r], quad_max(mx));  // finite: every tile has a valid key
      alpha[r] = fast_exp2((m_r[r] - m_new) * c);       // 0 on the first tile
      m_r[r] = m_new;
      const float mc = m_new * c;
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < BK / 8; ++jj)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[4 * jj + e] = fast_exp2(fmaf(s[4 * jj + e], c, -mc));
          sum += s[4 * jj + e];
        }
      l_r[r] = fmaf(l_r[r], alpha[r], sum);
    }
  };
  uint32_t pf[BK / 16][4];
  auto pack = [&] {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) pf[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
  };
  float o[D / 2];
  auto pv = [&](int j) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_pv<D>(o, pf[kk], desc_sw128_mnmajor<BK>(Vst + (j % S) * C::TILE, 16 * kk), 1);
  };

  if (kFwdWsPingPong && wg == 1) named_bar_arrive(1, 256);
  for (int item = blockIdx.x, n = 0, j0 = 0; item < items; item += gridDim.x, ++n, j0 += tiles) {
    int q0, h, b;
    decode(item, q0, h, b);
    m_r[0] = m_r[1] = -CUDART_INF_F;
    l_r[0] = l_r[1] = 0.f;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    mbar_wait(q_full, n & 1);
    wait_full(k_full, j0);
    float alpha[2];
    turn_wait();
    wgmma_fence();
    scores(j0);
    wgmma_commit();
    turn_pass();
    wgmma_wait0();
    reg_fence(s);
    release(&k_empty[j0 % S]);
    if (tiles == 1) release(q_empty);  // the item's scores are done
    softmax(0, alpha);  // o is 0: nothing to rescale
    pack();
    for (int jt = 1; jt < tiles; ++jt) {
      const int j = j0 + jt;
      wait_full(k_full, j);
      wait_full(v_full, j - 1);
      turn_wait();
      wgmma_fence();
      scores(j);  // tile jt's scores ...
      wgmma_commit();
      pv(j - 1);  // ... and tile jt - 1's p . v, both in flight
      wgmma_commit();
      turn_pass();
      wgmma_wait1();
      reg_fence(s);
      release(&k_empty[j % S]);
      if (jt == tiles - 1) release(q_empty);
      softmax(jt, alpha);  // the exponentials overlap p . v
      wgmma_wait0();
      reg_fence(o);
      frag_fence(pf);
      release(&v_empty[(j - 1) % S]);
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        o[4 * i] *= alpha[0];
        o[4 * i + 1] *= alpha[0];
        o[4 * i + 2] *= alpha[1];
        o[4 * i + 3] *= alpha[1];
      }
      pack();
    }
    const int jl = j0 + tiles - 1;
    wait_full(v_full, jl);
    turn_wait();
    wgmma_fence();
    pv(jl);
    wgmma_commit();
    // warpgroup 1's last turn of the block has no one waiting for it; the
    // others open warpgroup 0's first turn of the next item
    if (wg == 0 || item + gridDim.x < items) turn_pass();
    wgmma_wait0();
    reg_fence(o);
    frag_fence(pf);
    release(&v_empty[jl % S]);

    const long row = static_cast<long>(H) * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qr = q0 + r0 + g + 8 * r;
      const float l = quad_sum(l_r[r]);  // every lane of the warp takes part
      if (qr >= N) continue;
      if (lse != nullptr && t == 0) lse[(static_cast<long>(b) * H + h) * N + qr] = m_r[r] * c + log2f(l);
      const float inv = 1.0f / l;
      bf16* dst = out + (static_cast<long>(b) * N + qr) * row + h * D + 2 * t;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj)
        *reinterpret_cast<uint32_t*>(dst + 8 * jj) =
            pack_bf16(o[4 * jj + 2 * r] * inv, o[4 * jj + 2 * r + 1] * inv);
    }
  }
}

template <int D>
static int launch_attn_fwd_block(const void* q, const void* k, const void* v, void* out, void* lse, int B,
                                 int N, int M, int H, float scale, cudaStream_t stream) {
  using C = FwdCfg<D>;
  CUtensorMap tk, tv;
  int e = encode_rows_map(&tk, k, B, M, H, D, kFwdBK);
  if (e == 0) e = encode_rows_map(&tv, v, B, M, H, D, kFwdBK);
  if (e != 0) return e;
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + C::BQ - 1) / C::BQ, H, B);
  attn_fwd_kernel<D><<<grid, C::WGS * 128, C::bytes, stream>>>(
      tk, tv, static_cast<const bf16*>(q), static_cast<bf16*>(out), static_cast<float*>(lse), N, M, H,
      scale * kLog2e);
  return (int)cudaGetLastError();
}

template <int D>
static int launch_attn_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int B, int N,
                           int M, int H, float scale, cudaStream_t stream) {
  if constexpr (D == 64) {  // the warp-specialized kernel
    using C = FwdWsCfg<D>;
    CUtensorMap tq, tk, tv;
    int e = encode_rows_map(&tq, q, B, N, H, D, 128, true);
    if (e == 0) e = encode_rows_map(&tk, k, B, M, H, D, kFwdWsBK, true);
    if (e == 0) e = encode_rows_map(&tv, v, B, M, H, D, kFwdWsBK, true);
    if (e != 0) return e;
    int dev = 0, sms = 0;
    cudaError_t err;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (err = cudaFuncSetAttribute(attn_fwd_ws_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)C::bytes)) != cudaSuccess)
      return (int)err;
    const int items = (N + 127) / 128 * H * B;  // one block an SM, each taking items in turn
    attn_fwd_ws_kernel<D><<<items < sms ? items : sms, kFwdWsThreads, C::bytes, stream>>>(
        tq, tk, tv, static_cast<bf16*>(out), static_cast<float*>(lse), N, M, H, B, scale * kLog2e);
    return (int)cudaGetLastError();
  } else {
    return launch_attn_fwd_block<D>(q, k, v, out, lse, B, N, M, H, scale, stream);
  }
}

}  // namespace skp
