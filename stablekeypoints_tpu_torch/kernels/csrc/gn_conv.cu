// K7: fused GroupNorm-affine + SiLU + 3x3 conv (+ bias, + residual) (sm_90a).
//
// Replaces stablekeypoints_tpu/kernels/gn_conv.py fused_gn_silu_conv3x3 ->
// _impl (pallas_call at :251, kernel body _kernel at :127).
//
//   n[b,y,x,c]   = silu((x - m_q) * a + b_comp), every step rounded to bf16,
//                  the sigmoid computed in fp32 and rounded (as the TPU kernel)
//   out[b,y,x,o] = bf16(bf16(sum_{dy,dx,c} n[b,y+dy-1,x+dx-1,c] * w[o,dy,dx,c])
//                       + bias[o]) (+ residual, rounded once more)
//
// with n = 0 outside the image: the conv's padding=1 ring is zero *after*
// normalizing, as diffusers' ResnetBlock2D pads the activated tensor.
//
// The conv is an implicit GEMM on the tensor cores (wgmma, bf16 in, fp32
// accumulate): M = output pixels, N = output channels, K = 9 taps x Cin. Two
// kernels, both persistent (one block an SM walks its tiles, Cin in chunks of
// 64 channels and each chunk's 9 taps) and warp-specialized (their roles meet
// at mbarriers; one block barrier, at the start):
//
// gn_conv_kernel, where Cout allows tiles of 256 output channels (every
// SD-2.x / SDXL / SD-1.5 encoder level but the first): 128 pixels, one row of
// 64 to each product warpgroup where W % 64 == 0, else 8 rows of 16, each
// warpgroup an 8 x 8 block (W 96 in tiles of 16 columns, none padded).
//  - Products: two warpgroups, one m64 row set each (m64n256k16 a k16 slice,
//    128 fp32 accumulators a thread), A read by wgmma straight from the
//    patch: its 8-row core matrices are 8 consecutive pixels of one row, 8
//    pixels apart along a 64-pixel row or one patch row apart in an 8 x 8
//    block. A tap waits for its weight stage, issues its products and waits
//    for the previous tap's, across chunk ends too (the pipeline drains at a
//    tile's end only). One thread of each warpgroup then releases the
//    previous tap's stage, and the second of the two to do so refills it.
//  - Epilogue, off the tensor cores' path: after its last tap a warpgroup
//    adds the bias, and the residual from shared memory, and puts its bf16
//    half tile into a staging tile by stmatrix (the 128-byte swizzle, one
//    box of 64 channels x the half tile a 64 outputs); one thread sends it
//    out by TMA tensor stores and the warpgroup goes on to the next tile's
//    first tap while the stores drain. The same thread, once the stores have
//    read the staging (bulk_wait_read), brings the next tile's residual into
//    it by TMA in that tile's last chunk (an mbarrier a warpgroup says the
//    staging is free and filled).
//  - Weights: w [o][dy][dx][c], read by TMA as a [Cout][9 Cin] matrix, one
//    [256 outputs x 64 channels] box a tap in the 128-byte swizzle, through
//    a ring of 3 stages across chunk and tile ends; each stage keeps the next
//    tap it loads, so a refill divides nothing.
//  - Patches: the third warpgroup loads a chunk's raw (TH + 2) x (TW + 2)
//    patch (the tile and its one-pixel halo) and its coefficients into
//    registers a chunk ahead, applies the GN affine and SiLU there (zero
//    outside the image: the padding) and, once the products are done with a
//    buffer, writes it there, two buffers deep: each element passes through
//    shared memory once, and the third buffer's memory is the staging tile.
//    A patch thread keeps one channel group of pixels q, q + 16, ...; eight
//    consecutive threads take eight consecutive pixels, so a warp's loads
//    are 64-byte runs of 8 pixels and its 16-byte stores hit 8 different
//    bank groups.
//
// gn_conv128_kernel, where Cout takes only tiles of 128 (the encoder's first
// level, the decoder's last): the previous design, 128 channels x 256 pixels as
// wide as W needs no padding for (TW 64, 32 or 16; A by ldmatrix below 64),
// the products' own epilogue (4-byte bias, residual and output accesses), and
// a patch warpgroup that copies by cp.async and normalizes in place three
// buffers deep. At 128 channels a chunk's patch is twice the normalize work
// for the same products, and the register patch of the kernel above (25
// pixels a thread) spilled and made that level 1.5x slower (PERF.md §6).
//
// Patches are channel-group-major ([8 groups][pixel][8 channels], 16 bytes
// per pixel and group), so any 8 consecutive pixels of a patch row, shifted
// by a tap, are one 8 x 8 core matrix of a k16 slice's A.
//
// Bound: operations. At SD-2.1 768^2 (10 views) the 20 encoder convs are
// ~22.6 TFLOP (22.9 ms at the bf16 peak) against ~28 GB of activations read
// and written (8.3 ms of HBM). The patch is normalized once per tile (1 or 2
// times per input element, x1.4-2.1 for the halo); the design keeps the
// normalized tensor out of device memory, which is what the TPU kernel was
// for. What the stamps of the previous kernel showed (clock64 around every wait,
// tools/gn_conv_variants.py --stamps, PERF.md): a tap's products ran ~1500
// clocks with the release path and the weight wait hidden behind them; its
// epilogue (global residual loads and 4-byte stores by both product
// warpgroups, ~590 clocks a tap at 512^2, 1550 at 768^2's residual row) and
// the patch path (~1540 clocks of work a tap) were not hidden. Tried and
// dropped: the two product warpgroups taking turns at a tap (ping-pong), the
// epilogue staged per warp or quad-transposed into 16-byte accesses, an L2
// prefetch of the residual, mbarrier waits spinning on test_wait (57.9
// against 49.3 ms at 768^2), two patch buffers fed by cp.async (much slower),
// the patch by TMA boxes of 16-byte rows, a patch thread polling the weight
// ring, setmaxnreg between the roles; since, four weight stages at 128
// channels (no faster) and 8 x 8 blocks where W % 64 == 0 (3% slower at
// 512^2 than rows of 64).
#include "common.cuh"

namespace skp {

constexpr int kGcMmaWarps = 8;         // two warpgroups of products
constexpr int kGcPatchThreads = 128;   // warpgroup 2: patch loads and the normalize
constexpr int kGcThreads = 384;
constexpr int kGcKC = 64;              // input channels per chunk
constexpr int kGcPatches = 2;          // patch buffers: one read by the products, one written

// A tile is BN output channels (128, or 256 where Cout allows: each patch
// normalized once for twice the outputs) by TM = 32768 / BN pixels, so a
// product thread keeps 128 fp32 accumulators either way. A row set (the 64
// rows of one m64 product) is RW pixels wide: RW 8, an 8 x 8 block (the tile
// 8 rows of TM / 8, each warpgroup the left or right half), or RW 64, one
// tile row (the tile TM / 64 rows of 64, each warpgroup the upper or lower
// half).
template <int BN, int RW>
struct GcCfg {
  static constexpr int TM = 32768 / BN;
  static constexpr int RS = TM / 128;      // m64 row sets a product warpgroup
  static constexpr int TW = RW == 64 ? 64 : TM / 8, TH = TM / TW, PC = TW + 2;
  static constexpr int HW = RW == 64 ? TW : TW / 2;  // a warpgroup's half tile: HH x HW
  static constexpr int HH = RW == 64 ? TH / 2 : TH;
  static constexpr int NP = (TH + 2) * PC;  // patch pixels: the tile and its halo
  static constexpr int WT = BN * kGcKC;     // elements of a weight stage (128-byte swizzle)
  static constexpr int R = 3;               // weight stages
  static constexpr int OB = BN / 64;        // output boxes a warpgroup: 64 channels each
  static constexpr int OT = TM / 2 * 64;    // elements of an output box (TM / 2 pixels)
  // the weight ring and the output staging (bf16, 1024-byte aligned), the
  // patch buffers (bf16), a full and an empty mbarrier per stage and per
  // patch buffer, one per warpgroup's staging; per stage its release count
  // and the next tap it loads
  static constexpr size_t smem =
      sizeof(bf16) * (R * WT + 2 * OB * OT + kGcPatches * NP * kGcKC) +
      sizeof(uint64_t) * (2 * R + 2 * kGcPatches + 2) + sizeof(int) * 4 * R;
};

// d (+)= a . b over one k16 slice of a tap, b [BN outputs] K-major, a (the
// patch) through a descriptor
template <int BN>
__device__ __forceinline__ void gc_mma_ss(float (&d)[BN / 2], uint64_t a, uint64_t b, int acc) {
  if constexpr (BN == 128) wgmma_m64n128k16_ss(d, a, b, acc);
  else wgmma_m64n256k16_ss(d, a, b, acc);
}

// a weight stage's next tap: the block's tile k, tap r of its walk (chunk
// r / 9, dy dx r % 9), that tile's first output channel
struct GcTap {
  int k, r, n0;
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// silu((v - m) * a + b) of two channels with the TPU kernel's roundings:
// the sub, mul and add are bf16x2 instructions, each correctly rounded, which
// for bf16 operands is the fp32 op rounded once to bf16; the sigmoid runs in
// fp32 and is rounded before the product. It takes the SFU's exp2 and
// reciprocal, a few fp32 ulps from the plain version's correctly rounded
// ones, so after the bf16 rounding an element can differ by one bf16 ulp.
__device__ __forceinline__ uint32_t gn_silu2(uint32_t v, __nv_bfloat162 m, __nv_bfloat162 a,
                                             __nv_bfloat162 b) {
  __nv_bfloat162 t = *reinterpret_cast<__nv_bfloat162*>(&v);
  t = __hadd2(__hmul2(__hsub2(t, m), a), b);
  const float lo = __low2float(t), hi = __high2float(t);
  __nv_bfloat162 sig = __floats2bfloat162_rn(__fdividef(1.0f, 1.0f + __expf(-lo)),
                                             __fdividef(1.0f, 1.0f + __expf(-hi)));
  t = __hmul2(t, sig);
  return *reinterpret_cast<uint32_t*>(&t);
}

// bf16(bf16(acc) + bias) (+ residual, rounded) of two neighbouring outputs,
// packed; the bias and residual pairs packed bf16
__device__ __forceinline__ uint32_t gc_out2(float a0, float a1, uint32_t bias2, bool with_res,
                                            uint32_t res2) {
  float v0 = round_bf16(round_bf16(a0) + bf16_lo(bias2));
  float v1 = round_bf16(round_bf16(a1) + bf16_hi(bias2));
  if (with_res) {
    v0 = bf16_lo(res2) + v0;
    v1 = bf16_hi(res2) + v1;
  }
  return pack_bf16(v0, v1);
}

// The tile geometry is compile-time, so the patch index math divides by
// constants. Every role walks tiles p, p + gridDim.x, ... (tile = output-
// channel tile fastest, then pixel tile, then image), so the producers run
// ahead across tile ends. `to` and `tr` map out and the residual as [B, H,
// W, Cout] in boxes of 64 channels x HW x HH, a warpgroup's half tile (tr is
// unused without a residual).
template <int RW, int BN>
__global__ void __launch_bounds__(kGcThreads, 1)
    gn_conv_kernel(const __grid_constant__ CUtensorMap tw, const __grid_constant__ CUtensorMap to,
                   const __grid_constant__ CUtensorMap tr, const bf16* __restrict__ x,
                   const float* __restrict__ mq, const float* __restrict__ ga,
                   const float* __restrict__ gb, const bf16* __restrict__ bias, bool with_res,
                   int H, int W, int Cin, int Cout, int tiles) {
  using Cfg = GcCfg<BN, RW>;
  constexpr int RS = Cfg::RS, R = Cfg::R, WT = Cfg::WT, NB = kGcPatches;
  constexpr int TW = Cfg::TW, TH = Cfg::TH, PC = Cfg::PC, NP = Cfg::NP, OB = Cfg::OB, OT = Cfg::OT;
  constexpr int HW = Cfg::HW, HH = Cfg::HH;
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* Ws = reinterpret_cast<bf16*>(smem);  // [stage][BN outputs][64 channels], 128-byte swizzle
  bf16* Os = Ws + R * WT;        // [warpgroup][OB][TM / 2 pixels][64 channels], 128-byte swizzle
  bf16* Pb = Os + 2 * OB * OT;   // [2][8][NP][8] patches, chunk C in buffer C % 2
  uint64_t* full = reinterpret_cast<uint64_t*>(Pb + NB * NP * kGcKC);  // [stage]
  uint64_t* empty = full + R;                                           // [stage]
  uint64_t* pfull = empty + R;     // [buffer] a patch normalized
  uint64_t* pempty = pfull + NB;   // [buffer] a patch's products done
  uint64_t* sfull = pempty + NB;   // [warpgroup] its staging read out (and the residual in)
  int* released = reinterpret_cast<int*>(sfull + 2);    // [stage] warpgroups done with its tap
  GcTap* next = reinterpret_cast<GcTap*>(released + R);  // [stage] the next tap it loads

  const int tiles_w = (W + TW - 1) / TW, tiles_p = ((H + TH - 1) / TH) * tiles_w;
  const int tiles_n = Cout / BN;
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int t = lane & 3;
  const int chunks = Cin / kGcKC;
  auto patch = [&](int c) { return Pb + (c % NB) * NP * kGcKC; };

  struct Tile {
    int n0, b, ty0, tx0;
  };
  auto tile_at = [&](int i) {
    const int p = (i / tiles_n) % tiles_p;
    return Tile{(i % tiles_n) * BN, i / (tiles_n * tiles_p), (p / tiles_w) * TH,
                (p % tiles_w) * TW};
  };

  const int taps = 9 * chunks;  // a tile's walk
  if (tid == 0) {
    for (int s = 0; s < R; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
      released[s] = 0;
      next[s] = GcTap{0, s, (static_cast<int>(blockIdx.x) % tiles_n) * BN};
    }
    for (int s = 0; s < NB; ++s) {
      mbar_init(&pfull[s], kGcPatchThreads);
      mbar_init(&pempty[s], 2);
    }
    mbar_init(&sfull[0], 1);
    mbar_init(&sfull[1], 1);
    mbar_fence_init();
  }
  // the weights of stage st's next tap: one TMA box of w viewed as [Cout
  // rows][9 Cin columns], BN rows of 64 channels; then the tap R further
  // on the walk, counted without a division (a refill runs on the products'
  // path: its two 64-bit divisions added 7.6 ms to a 768^2 encode's chain)
  auto issue_w = [&](int st) {
    GcTap& nt = next[st];
    const int i = static_cast<int>(blockIdx.x + nt.k * gridDim.x);
    if (i >= tiles) return;
    mbar_expect_tx(&full[st], WT * 2);
    tma_load_4d(Ws + st * WT, &tw, (nt.r % 9) * Cin + (nt.r / 9) * kGcKC, 0, nt.n0, 0, &full[st]);
    nt.r += R;
    if (nt.r >= taps) {  // R < taps: the next tile
      nt.r -= taps;
      ++nt.k;
      nt.n0 = ((i + static_cast<int>(gridDim.x)) % tiles_n) * BN;
    }
  };
  if (tid == 0)
    for (int s = 0; s < R; ++s) issue_w(s);
  __syncthreads();  // the only block-wide barrier

  if (wg == 2) {
    // patches: the raw pixels of the next chunk and its coefficients into
    // registers; once they land, GN affine + SiLU in place (zero outside the
    // image), and once the products are done with the buffer, into it. Thread
    // pt keeps channel group cg of pixels q0, q0 + 16, ...
    const int pt = tid - 256, cg = (pt >> 3) & 7, q0 = (pt & 7) + 8 * (pt >> 6);
    constexpr int QN = (NP + 15) / 16;  // pixels a thread
    uint4 raw[QN];
    uint32_t inside = 0;  // bit k: pixel q0 + 16 k lies in the image
    float4 fm[2], fa[2], fb[2];  // the chunk's m_q, a and b_comp of the group's 8 channels
    auto fetch = [&](const Tile& T, int c) {
      const long at = static_cast<long>(T.b) * Cin + c * kGcKC + 8 * cg;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        fm[e] = *reinterpret_cast<const float4*>(mq + at + 4 * e);
        fa[e] = *reinterpret_cast<const float4*>(ga + at + 4 * e);
        fb[e] = *reinterpret_cast<const float4*>(gb + at + 4 * e);
      }
      inside = 0;
#pragma unroll
      for (int k = 0; k < QN; ++k) {
        const int q = q0 + 16 * k;
        const int y = T.ty0 - 1 + q / PC, xx = T.tx0 - 1 + q % PC;
        if (q < NP && y >= 0 && y < H && xx >= 0 && xx < W) {
          raw[k] = *reinterpret_cast<const uint4*>(
              x + ((static_cast<long>(T.b) * H + y) * W + xx) * Cin + c * kGcKC + 8 * cg);
          inside |= 1u << k;
        }
      }
    };
    int i = blockIdx.x, c = 0;
    if (i < tiles) fetch(tile_at(i), 0);
    for (int C = 0; i < tiles; ++C) {
      const int i_n = c + 1 < chunks ? i : i + gridDim.x, c_n = c + 1 < chunks ? c + 1 : 0;
      const __nv_bfloat162 cm[4] = {__floats2bfloat162_rn(fm[0].x, fm[0].y), __floats2bfloat162_rn(fm[0].z, fm[0].w),
                                    __floats2bfloat162_rn(fm[1].x, fm[1].y), __floats2bfloat162_rn(fm[1].z, fm[1].w)};
      const __nv_bfloat162 ca[4] = {__floats2bfloat162_rn(fa[0].x, fa[0].y), __floats2bfloat162_rn(fa[0].z, fa[0].w),
                                    __floats2bfloat162_rn(fa[1].x, fa[1].y), __floats2bfloat162_rn(fa[1].z, fa[1].w)};
      const __nv_bfloat162 cb[4] = {__floats2bfloat162_rn(fb[0].x, fb[0].y), __floats2bfloat162_rn(fb[0].z, fb[0].w),
                                    __floats2bfloat162_rn(fb[1].x, fb[1].y), __floats2bfloat162_rn(fb[1].z, fb[1].w)};
#pragma unroll
      for (int k = 0; k < QN; ++k) {  // the pad ring stays zero
        if ((inside >> k) & 1) {
          raw[k].x = gn_silu2(raw[k].x, cm[0], ca[0], cb[0]);
          raw[k].y = gn_silu2(raw[k].y, cm[1], ca[1], cb[1]);
          raw[k].z = gn_silu2(raw[k].z, cm[2], ca[2], cb[2]);
          raw[k].w = gn_silu2(raw[k].w, cm[3], ca[3], cb[3]);
        } else {
          raw[k] = uint4{0, 0, 0, 0};
        }
      }
      // the products are done with chunk C - 2, which had this buffer
      if (C >= NB) mbar_wait(&pempty[C % NB], (C / NB + 1) & 1);
      bf16* buf = patch(C);
#pragma unroll
      for (int k = 0; k < QN; ++k)
        if (q0 + 16 * k < NP) *reinterpret_cast<uint4*>(buf + (cg * NP + q0 + 16 * k) * 8) = raw[k];
      fence_proxy_async();  // the patch is read by wgmma (async proxy)
      mbar_arrive(&pfull[C % NB]);
      if (i_n < tiles) fetch(tile_at(i_n), c_n);
      i = i_n;
      c = c_n;
    }
    return;
  }

  // the products: warpgroup wg owns half the tile (HH x HW pixels from
  // column x0h, row y0h) as RS m64 row sets s = RS wg + j: at RW 64 tile row
  // s, product row r its pixel r; at RW 8 the 8 x 8 block of columns 8 s ..,
  // product row r its pixel (r / 8, r % 8). Its thread 0 (`lead`) releases
  // stages and patches, and moves the staging tile in and out.
  const bool lead = tid % 128 == 0;
  bf16* Ow = Os + wg * OB * OT;  // this warpgroup's staging
  const int x0h = RW == 64 ? 0 : HW * wg, y0h = RW == 64 ? HH * wg : 0;
  auto release = [&](int P) {  // tap P's products are done in this warpgroup
    if (lead) {
      const int st = P % R;
      mbar_arrive(&empty[st]);
      // the second warpgroup to finish with the stage refills it with tap
      // P + R: neither waits for the other's products
      if (atomicAdd(&released[st], 1) == 1) {
        atomicAdd(&released[st], -2);
        mbar_wait(&empty[st], (P / R) & 1);
        issue_w(st);
      }
    }
  };
  // the staging is free once the previous tile's stores have read it; then
  // the residual of tile T's half into it (or a plain arrival)
  auto stage_in = [&](const Tile& T) {
    bulk_wait_read<0>();
    if (with_res) {
      mbar_expect_tx(&sfull[wg], OB * OT * 2);
#pragma unroll
      for (int ob = 0; ob < OB; ++ob)
        tma_load_4d(Ow + ob * OT, &tr, T.n0 + 64 * ob, T.tx0 + x0h, T.ty0 + y0h, T.b, &sfull[wg]);
    } else {
      mbar_arrive(&sfull[wg]);
    }
  };
  // the walk position that moves the staging: the last chunk's first tap,
  // or 3 taps into a one-chunk walk (the stores issued at the previous
  // tile's end have had a few taps to read it)
  const int stage_at = taps > 9 ? taps - 9 : 3;
  float acc[RS][BN / 2];  // row set j, m64nBN layout
  int G = 0;
  for (int i = blockIdx.x, C = 0, k = 0; i < tiles; i += gridDim.x, ++k) {
    const Tile T = tile_at(i);
    for (int c = 0; c < chunks; ++c, ++C) {
      mbar_wait(&pfull[C % NB], (C / NB) & 1);
      const bf16* Ps = patch(C);
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap, ++G) {
        const int dy = tap / 3, dx = tap % 3;
        const bf16* wt = Ws + (G % R) * WT;
        mbar_wait(&full[G % R], (G / R) & 1);
        // A of tap (dy, dx), k16 slice ks: the row set's 64 pixels shifted
        // by the tap, channel groups 2 ks and 2 ks + 1; its 8-row core
        // matrices are 8 consecutive patch pixels of one row, 8 pixels apart
        // along a tile row (RW 64) or one patch row apart (RW 8)
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < RS; ++j)
#pragma unroll
          for (int ks = 0; ks < kGcKC / 16; ++ks) {
            const int s = RS * wg + j;
            const int at = RW == 64 ? (s + dy) * PC + dx : dy * PC + 8 * s + dx;
            const uint64_t da =
                smem_desc(Ps + (2 * ks * NP + at) * 8, NP * 16, RW == 64 ? 128 : PC * 16);
            gc_mma_ss<BN>(acc[j], da, desc_sw128_kmajor<BN>(wt, ks), c > 0 || tap > 0 || ks > 0);
          }
        wgmma_commit();
#pragma unroll
        for (int j = 0; j < RS; ++j) reg_fence(acc[j]);
        // the previous tap's products are done (across a chunk's end too:
        // the pipeline drains only at a tile's end)
        wgmma_wait1();
        if (c > 0 || tap > 0) release(G - 1);  // the tile's previous tap
        // the last chunk's patch, once its last tap's products are done
        if (tap == 0 && c > 0 && lead) mbar_arrive(&pempty[(C - 1) % NB]);
        if (c * 9 + tap == stage_at && lead) stage_in(T);
      }
    }
    wgmma_wait0();
#pragma unroll
    for (int j = 0; j < RS; ++j) reg_fence(acc[j]);
    release(G - 1);
    if (lead) mbar_arrive(&pempty[(C - 1) % NB]);

    // epilogue: round, + bias (bf16), + residual (bf16) into the staging;
    // stmatrix rows: lane l gives product row 16 warp + l % 16 in output
    // chunk jj + l / 16, the chunk's 16 bytes at its 128-byte swizzle in the
    // half tile's pixel pp (row-major, as TMA lays out a box), so the 8 rows
    // of one stmatrix matrix are 8 consecutive pixels of a row
    mbar_wait(&sfull[wg], k & 1);
#pragma unroll
    for (int j = 0; j < RS; ++j) {
      const int pp = RW == 64 ? 64 * j + 16 * warp + (lane & 15)
                              : (2 * warp + ((lane >> 3) & 1)) * HW + 8 * j + (lane & 7);
#pragma unroll
      for (int jj = 0; jj < BN / 8; jj += 2) {
        const int ch = jj + (lane >> 4);
        bf16* row = Ow + (ch / 8) * OT + pp * 64 + (((ch % 8) ^ (pp & 7)) * 8);
        uint32_t r[4] = {0, 0, 0, 0};
        if (with_res) ldsm_x4(r, row);
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(bias + T.n0 + 8 * jj + 2 * t);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(bias + T.n0 + 8 * jj + 8 + 2 * t);
        const float* a = acc[j];
        uint32_t v[4];
        v[0] = gc_out2(a[4 * jj], a[4 * jj + 1], b0, with_res, r[0]);
        v[1] = gc_out2(a[4 * jj + 2], a[4 * jj + 3], b0, with_res, r[1]);
        v[2] = gc_out2(a[4 * jj + 4], a[4 * jj + 5], b1, with_res, r[2]);
        v[3] = gc_out2(a[4 * jj + 6], a[4 * jj + 7], b1, with_res, r[3]);
        stsm_x4(row, v);
      }
    }
    fence_proxy_async();  // the staging is read by the TMA store (async proxy)
    named_bar_sync(1 + wg, 128);
    if (lead) {
#pragma unroll
      for (int ob = 0; ob < OB; ++ob)
        tma_store_4d(&to, Ow + ob * OT, T.n0 + 64 * ob, T.tx0 + x0h, T.ty0 + y0h, T.b);
      bulk_commit();
    }
#pragma unroll
    for (int j = 0; j < RS; ++j) reg_fence(acc[j]);
  }
  if (lead) bulk_wait_read<0>();  // the staging stays until the last stores have read it
}

template <int RW, int BN>
static int launch_gn_conv(const void* x, const void* m, const void* a, const void* b,
                          const void* w, const void* bias, const void* res, void* out, int B,
                          int H, int W, int Cin, int Cout, cudaStream_t stream) {
  using C = GcCfg<BN, RW>;
  CUtensorMap tw, to, tr;  // w as [Cout rows][9 Cin columns]: boxes of BN rows x 64 channels
  int e = encode_rows_map(&tw, w, 1, Cout, 1, 9 * Cin, BN, true);
  if (e == 0) e = encode_nhwc_map(&to, out, B, H, W, Cout, C::HW, C::HH);
  if (e == 0) e = encode_nhwc_map(&tr, res != nullptr ? res : out, B, H, W, Cout, C::HW, C::HH);
  if (e != 0) return e;
  cudaError_t err = cudaFuncSetAttribute(gn_conv_kernel<RW, BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::smem);
  if (err != cudaSuccess) return (int)err;
  const long tiles =
      static_cast<long>((H + C::TH - 1) / C::TH) * ((W + C::TW - 1) / C::TW) * (Cout / BN) * B;
  if (tiles > 0x7fffffff) return -1;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  dim3 grid(static_cast<unsigned>(std::min<long>(tiles, sms)));  // one block per SM
  gn_conv_kernel<RW, BN><<<grid, kGcThreads, C::smem, stream>>>(
      tw, to, tr, static_cast<const bf16*>(x), static_cast<const float*>(m),
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<const bf16*>(bias),
      res != nullptr, H, W, Cin, Cout, static_cast<int>(tiles));
  return (int)cudaGetLastError();
}

// rows of 64 pixels where W allows, else 8 x 8 blocks (W 96: 16-column tiles, none padded)
template <int BN>
static int launch_gn_conv_bn(const void* x, const void* m, const void* a, const void* b,
                             const void* w, const void* bias, const void* res, void* out, int B,
                             int H, int W, int Cin, int Cout, cudaStream_t s) {
  if (W % 64 == 0) return launch_gn_conv<64, BN>(x, m, a, b, w, bias, res, out, B, H, W, Cin, Cout, s);
  return launch_gn_conv<8, BN>(x, m, a, b, w, bias, res, out, B, H, W, Cin, Cout, s);
}

constexpr int kGc128Patches = 3;
template <int BN>
__device__ __forceinline__ void gc_mma_rs(float (&d)[BN / 2], const uint32_t (&a)[4], uint64_t b,
                                          int acc) {
  if constexpr (BN == 128) wgmma_m64n128k16(d, a, b, acc);
  else wgmma_m64n256k16(d, a, b, acc);
}
// A tile is BN output channels (128, or 256 where Cout allows: each patch
// normalized once for twice the outputs) by TM = 32768 / BN pixels, so a
// product thread keeps 128 fp32 accumulators either way.
template <int BN>
struct Gc128Cfg {
  static constexpr int TM = 32768 / BN;
  static constexpr int RS = TM / 128;  // m64 row sets a product warpgroup
  static constexpr int WT = BN * kGcKC;  // elements of a weight stage (128-byte swizzle)
  // weight stages, [BN outputs][64 channels] each: four at BN 128; three of
  // 32 KB at BN 256, beside its smaller patches
  static constexpr int R = BN == 128 ? 4 : 3;
  // (TH + 2) x (TW + 2) pixels, largest at TW 64, + 1: the pixel count NP
  // between channel groups is odd, so the 8 groups of a pixel lie in 8
  // different 16-byte bank groups
  static constexpr int MaxP = (TM / 64 + 2) * 66 + 1;
  // the weight ring (bf16, 1024-byte aligned), the patch buffers (bf16), a
  // full and an empty mbarrier per stage and per patch buffer; per stage its
  // release count and the next tap it loads
  static constexpr size_t smem = sizeof(bf16) * (R * WT + kGc128Patches * MaxP * kGcKC) +
                                 sizeof(uint64_t) * 2 * (R + kGc128Patches) + sizeof(int) * 4 * R;
};

// TW columns per tile (a compile-time constant, so the patch index math
// divides by constants). Every role walks tiles p, p + gridDim.x, ... (tile
// = output-channel tile fastest, then pixel tile, then image), so the
// producers run ahead across tile ends.
template <int TW, int BN>
__global__ void __launch_bounds__(kGcThreads, 1)
    gn_conv128_kernel(const __grid_constant__ CUtensorMap tw, const bf16* __restrict__ x,
                   const float* __restrict__ mq, const float* __restrict__ ga,
                   const float* __restrict__ gb, const bf16* __restrict__ bias,
                   const bf16* __restrict__ res, bf16* __restrict__ out, int H, int W, int Cin,
                   int Cout, int tiles) {
  using Cfg = Gc128Cfg<BN>;
  constexpr int TM = Cfg::TM, RS = Cfg::RS, R = Cfg::R, WT = Cfg::WT, NB = kGc128Patches;
  constexpr int MaxP = Cfg::MaxP;
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* Ws = reinterpret_cast<bf16*>(smem);  // [stage][BN outputs][64 channels], 128-byte swizzle
  bf16* Pb = Ws + R * WT;                    // [3][8][NP][8] patches, chunk C in buffer C % 3
  uint64_t* full = reinterpret_cast<uint64_t*>(Pb + NB * MaxP * kGcKC);  // [stage]
  uint64_t* empty = full + R;                                              // [stage]
  uint64_t* pfull = empty + R;     // [buffer] a patch normalized
  uint64_t* pempty = pfull + NB;   // [buffer] a patch's products done
  int* released = reinterpret_cast<int*>(pempty + NB);  // [stage] warps done with its tap
  GcTap* next = reinterpret_cast<GcTap*>(released + R);  // [stage] the next tap it loads

  constexpr int TH = TM / TW, PC = TW + 2, NPIX = (TH + 2) * PC, NP = NPIX | 1;
  const int tiles_w = (W + TW - 1) / TW, tiles_p = ((H + TH - 1) / TH) * tiles_w;
  const int tiles_n = Cout / BN;
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int chunks = Cin / kGcKC;
  auto patch = [&](int c) { return Pb + (c % NB) * MaxP * kGcKC; };

  struct Tile {
    int n0, b, ty0, tx0;
  };
  auto tile_at = [&](int i) {
    const int p = (i / tiles_n) % tiles_p;
    return Tile{(i % tiles_n) * BN, i / (tiles_n * tiles_p), (p / tiles_w) * TH,
                (p % tiles_w) * TW};
  };

  const int taps = 9 * chunks;  // a tile's walk
  if (tid == 0) {
    for (int s = 0; s < R; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kGcMmaWarps);
      released[s] = 0;
      next[s] = GcTap{0, s, (static_cast<int>(blockIdx.x) % tiles_n) * BN};
    }
    for (int s = 0; s < NB; ++s) {
      mbar_init(&pfull[s], kGcPatchThreads);
      mbar_init(&pempty[s], kGcMmaWarps);
    }
    mbar_fence_init();
  }
  // the weights of stage st's next tap: one TMA box of w viewed as [Cout
  // rows][9 Cin columns], BN rows of 64 channels; then the tap R further
  // on the walk, counted without a division (a refill runs on the products'
  // path: its two 64-bit divisions added 7.6 ms to a 768^2 encode's chain)
  auto issue_w = [&](int st) {
    GcTap& nt = next[st];
    const int i = static_cast<int>(blockIdx.x + nt.k * gridDim.x);
    if (i >= tiles) return;
    mbar_expect_tx(&full[st], WT * 2);
    tma_load_4d(Ws + st * WT, &tw, (nt.r % 9) * Cin + (nt.r / 9) * kGcKC, 0, nt.n0, 0, &full[st]);
    nt.r += R;
    if (nt.r >= taps) {  // R < taps: the next tile
      nt.r -= taps;
      ++nt.k;
      nt.n0 = ((i + static_cast<int>(gridDim.x)) % tiles_n) * BN;
    }
  };
  if (tid == 0)
    for (int s = 0; s < R; ++s) issue_w(s);
  __syncthreads();  // the only block-wide barrier

  if (wg == 2) {
    // patches: the raw (TH + 2) x (TW + 2) patch of the next chunk (zero
    // outside the image) by cp.async, once its buffer's products are done,
    // then GN affine + SiLU of this chunk in place, three pixels at a time.
    // Thread pt copies and normalizes channel group pt % 8 of pixels pt / 8,
    // pt / 8 + 12, ...: only its own elements, so it waits for its own
    // copies only.
    const int pt = tid - 256, cg = pt % 8;
    constexpr int QS = kGcPatchThreads / 8;  // pixel stride
    auto in_image = [&](const Tile& T, int q) {
      const int y = T.ty0 - 1 + q / PC, xx = T.tx0 - 1 + q % PC;
      return y >= 0 && y < H && xx >= 0 && xx < W;
    };
    auto load = [&](const Tile& T, int c, int C) {
      if (C >= NB) mbar_wait(&pempty[C % NB], (C / NB + 1) & 1);
      bf16* buf = patch(C);
      for (int q = pt / 8; q < NPIX; q += QS) {
        const int y = T.ty0 - 1 + q / PC, xx = T.tx0 - 1 + q % PC;
        const bool ok = in_image(T, q);
        cp_async16(buf + (cg * NP + q) * 8,
                   ok ? x + ((static_cast<long>(T.b) * H + y) * W + xx) * Cin + c * kGcKC + 8 * cg
                      : x,
                   ok);
      }
      cp_async_commit();
    };
    int i = blockIdx.x, c = 0;
    if (i < tiles) load(tile_at(i), 0, 0);
    for (int C = 0; i < tiles; ++C) {
      const Tile T = tile_at(i);
      const int i_n = c + 1 < chunks ? i : i + gridDim.x, c_n = c + 1 < chunks ? c + 1 : 0;
      // this chunk's coefficients, loaded while its copies land
      const long at = static_cast<long>(T.b) * Cin + c * kGcKC + 8 * cg;
      __nv_bfloat162 cm[4], ca[4], cb[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        cm[e] = __floats2bfloat162_rn(mq[at + 2 * e], mq[at + 2 * e + 1]);
        ca[e] = __floats2bfloat162_rn(ga[at + 2 * e], ga[at + 2 * e + 1]);
        cb[e] = __floats2bfloat162_rn(gb[at + 2 * e], gb[at + 2 * e + 1]);
      }
      if (i_n < tiles) {
        load(tile_at(i_n), c_n, C + 1);
        cp_async_wait_1();  // this chunk's raw pixels landed; the next one's may be in flight
      } else {
        cp_async_wait_all();
      }
      bf16* buf = patch(C);
      for (int q0 = pt / 8; q0 < NPIX; q0 += 3 * QS) {
        uint4 v[3];
        bool in[3];
#pragma unroll
        for (int u = 0; u < 3; ++u) {  // the pad ring stays zero
          const int q = q0 + u * QS;
          in[u] = q < NPIX && in_image(T, q);
          if (in[u]) v[u] = *reinterpret_cast<const uint4*>(buf + (cg * NP + q) * 8);
        }
#pragma unroll
        for (int u = 0; u < 3; ++u)
          if (in[u]) {
            v[u].x = gn_silu2(v[u].x, cm[0], ca[0], cb[0]);
            v[u].y = gn_silu2(v[u].y, cm[1], ca[1], cb[1]);
            v[u].z = gn_silu2(v[u].z, cm[2], ca[2], cb[2]);
            v[u].w = gn_silu2(v[u].w, cm[3], ca[3], cb[3]);
            *reinterpret_cast<uint4*>(buf + (cg * NP + q0 + u * QS) * 8) = v[u];
          }
      }
      fence_proxy_async();  // the patch is read by wgmma (async proxy)
      mbar_arrive(&pfull[C % NB]);
      i = i_n;
      c = c_n;
    }
    return;
  }

  // the products: warpgroup wg owns pixels TM / 2 wg .. of a tile as RS m64
  // row sets (tile rows RS wg + j at TW 64)
  auto release = [&](int P) {  // tap P's products are done in this warp
    __syncwarp();
    if (lane == 0) {
      const int st = P % R;
      mbar_arrive(&empty[st]);
      // the last of the 8 warps to finish with the stage refills it with tap
      // P + R: no warp waits for another's products
      if (atomicAdd(&released[st], 1) == kGcMmaWarps - 1) {
        atomicAdd(&released[st], -kGcMmaWarps);
        mbar_wait(&empty[st], (P / R) & 1);
        issue_w(st);
      }
    }
  };
  float acc[RS][BN / 2];  // row set j, m64nBN layout
  int G = 0;
  for (int i = blockIdx.x, C = 0; i < tiles; i += gridDim.x) {
    const Tile T = tile_at(i);
    for (int c = 0; c < chunks; ++c, ++C) {
      mbar_wait(&pfull[C % NB], (C / NB) & 1);
      const bf16* Ps = patch(C);
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap, ++G) {
        const int dy = tap / 3, dx = tap % 3;
        const bf16* wt = Ws + (G % R) * WT;
        mbar_wait(&full[G % R], (G / R) & 1);
        if constexpr (TW == 64) {
          // A of tap (dy, dx), k16 slice ks: the 64 patch pixels of the row
          // set's tile row shifted by the tap, channel groups 2 ks and 2 ks + 1
          wgmma_fence();
#pragma unroll
          for (int j = 0; j < RS; ++j)
#pragma unroll
            for (int ks = 0; ks < kGcKC / 16; ++ks) {
              const uint64_t da =
                  smem_desc(Ps + (2 * ks * NP + (RS * wg + j + dy) * PC + dx) * 8, NP * 16, 128);
              gc_mma_ss<BN>(acc[j], da, desc_sw128_kmajor<BN>(wt, ks), c > 0 || tap > 0 || ks > 0);
            }
          wgmma_commit();
#pragma unroll
          for (int j = 0; j < RS; ++j) reg_fence(acc[j]);
          // the previous tap's products are done (across a chunk's end too:
          // the pipeline drains only at a tile's end)
          wgmma_wait1();
        } else {
#pragma unroll
          for (int j = 0; j < RS; ++j) {
            // ldmatrix.x4 rows: pixel lane % 16 of the warp's 16, channel group lane / 16
            const int p = 64 * (RS * wg + j) + 16 * warp;
            const int pbase = (p / TW) * PC + p % TW;
            uint32_t af[kGcKC / 16][4];
#pragma unroll
            for (int ks = 0; ks < kGcKC / 16; ++ks)
              ldsm_x4(af[ks],
                      Ps + ((2 * ks + lane / 16) * NP + pbase + dy * PC + dx + lane % 16) * 8);
            wgmma_fence();
#pragma unroll
            for (int ks = 0; ks < kGcKC / 16; ++ks)
              gc_mma_rs<BN>(acc[j], af[ks], desc_sw128_kmajor<BN>(wt, ks), c > 0 || tap > 0 || ks > 0);
            wgmma_commit();
            wgmma_wait0();
            reg_fence(acc[j]);
          }
        }
        if (c > 0 || tap > 0) release(G - 1);  // the tile's previous tap
        // the last chunk's patch, once its last tap's products are done
        if (tap == 0 && c > 0 && lane == 0) mbar_arrive(&pempty[(C - 1) % NB]);
      }
    }
    wgmma_wait0();
#pragma unroll
    for (int j = 0; j < RS; ++j) reg_fence(acc[j]);
    release(G - 1);
    if (lane == 0) mbar_arrive(&pempty[(C - 1) % NB]);

    // epilogue: round, + bias (bf16), + residual (bf16), store
#pragma unroll
    for (int j = 0; j < RS; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = 64 * (RS * wg + j) + 16 * warp + g + 8 * r;
        const int y = T.ty0 + p / TW, xx = T.tx0 + p % TW;
        if (y >= H || xx >= W) continue;
        const long pix = ((static_cast<long>(T.b) * H + y) * W + xx) * Cout;
#pragma unroll
        for (int jj = 0; jj < BN / 8; ++jj) {
          const int n = T.n0 + 8 * jj + 2 * t;
          const int e = 4 * jj + 2 * r;
          float v0 = round_bf16(round_bf16(acc[j][e]) + __bfloat162float(bias[n]));
          float v1 = round_bf16(round_bf16(acc[j][e + 1]) + __bfloat162float(bias[n + 1]));
          if (res != nullptr) {
            const uint32_t u = *reinterpret_cast<const uint32_t*>(res + pix + n);
            v0 = __bfloat162float(__ushort_as_bfloat16(u & 0xffffu)) + v0;
            v1 = __bfloat162float(__ushort_as_bfloat16(u >> 16)) + v1;
          }
          *reinterpret_cast<uint32_t*>(out + pix + n) = pack_bf16(v0, v1);
        }
      }
#pragma unroll
    for (int j = 0; j < RS; ++j) reg_fence(acc[j]);
  }
}

template <int TW, int BN>
static int launch_gn_conv128(const void* x, const void* m, const void* a, const void* b,
                          const void* w, const void* bias, const void* res, void* out, int B,
                          int H, int W, int Cin, int Cout, cudaStream_t stream) {
  using C = Gc128Cfg<BN>;
  constexpr int TH = C::TM / TW;
  CUtensorMap tw;  // w as [Cout rows][9 Cin columns]: boxes of BN rows x 64 channels
  const int e = encode_rows_map(&tw, w, 1, Cout, 1, 9 * Cin, BN, true);
  if (e != 0) return e;
  cudaError_t err = cudaFuncSetAttribute(gn_conv128_kernel<TW, BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::smem);
  if (err != cudaSuccess) return (int)err;
  const long tiles = static_cast<long>((H + TH - 1) / TH) * ((W + TW - 1) / TW) * (Cout / BN) * B;
  if (tiles > 0x7fffffff) return -1;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  dim3 grid(static_cast<unsigned>(std::min<long>(tiles, sms)));  // one block per SM
  gn_conv128_kernel<TW, BN><<<grid, kGcThreads, C::smem, stream>>>(
      tw, static_cast<const bf16*>(x), static_cast<const float*>(m), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const bf16*>(bias), static_cast<const bf16*>(res),
      static_cast<bf16*>(out), H, W, Cin, Cout, static_cast<int>(tiles));
  return (int)cudaGetLastError();
}

// tiles as wide as W allows without padded columns (W 96: three of 32), of
// 256 output channels where Cout allows
template <int BN>
static int launch_gn_conv128_bn(const void* x, const void* m, const void* a, const void* b,
                             const void* w, const void* bias, const void* res, void* out, int B,
                             int H, int W, int Cin, int Cout, cudaStream_t s) {
  if (W % 64 == 0) return launch_gn_conv128<64, BN>(x, m, a, b, w, bias, res, out, B, H, W, Cin, Cout, s);
  if (W >= 32) return launch_gn_conv128<32, BN>(x, m, a, b, w, bias, res, out, B, H, W, Cin, Cout, s);
  return launch_gn_conv128<16, BN>(x, m, a, b, w, bias, res, out, B, H, W, Cin, Cout, s);
}


}  // namespace skp

// x [B,H,W,Cin] bf16, m/a/b [B,Cin] fp32, w [Cout,3,3,Cin] bf16 (channels-last
// conv weight), bias [Cout] bf16, res [B,H,W,Cout] bf16 or null ->
// out [B,H,W,Cout] bf16. Returns a cudaError_t, 1000 + a CUresult from the
// tensor-map encoder, or -1 for a shape the kernel does not take (Cin % 64,
// Cout % 128, W or H < 8).
extern "C" int skp_gn_conv(const void* x, const void* m, const void* a, const void* b,
                           const void* w, const void* bias, const void* res, void* out, int B,
                           int H, int W, int Cin, int Cout, void* stream) {
  using namespace skp;
  if (Cin % kGcKC != 0 || Cout % 128 != 0 || H < 8 || W < 8) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Cout % 256 == 0)
    return launch_gn_conv_bn<256>(x, m, a, b, w, bias, res, out, B, H, W, Cin, Cout, s);
  return launch_gn_conv128_bn<128>(x, m, a, b, w, bias, res, out, B, H, W, Cin, Cout, s);
}
