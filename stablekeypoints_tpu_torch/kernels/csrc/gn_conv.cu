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
// accumulate): M = output pixels, N = output channels, K = 9 taps x Cin. A
// tile is 256 output channels x 128 pixels where Cout allows (every SD-2.x /
// SDXL / SD-1.5 encoder level but the first), else 128 x 256 pixels: TH rows
// x TW columns, TW the widest of {64, 32, 16} that W needs no padding for
// (W 96: three tiles of 32). One block an SM walks its tiles persistently,
// Cin in chunks of 64 channels and each chunk's 9 taps. The block is
// warp-specialized; its roles meet at mbarriers only (one block barrier, at
// the start):
//
//  - Products: two warpgroups, each half the tile's pixels as one or two
//    m64 row sets (m64n256k16 or two m64n128k16 products a k16 slice; 128
//    fp32 accumulators a thread). A tap waits for its weight stage, issues
//    its products and waits for the previous tap's, across chunk ends too
//    (the pipeline drains at a tile's end only). Each warp then releases the
//    previous tap's stage, and the last of the 8 to do so refills it: no
//    warp waits for another's products. They also run the epilogue (bias,
//    residual).
//  - Weights: w [o][dy][dx][c], read by TMA as a [Cout][9 Cin] matrix, one
//    [BN outputs x 64 channels] box a tap in the 128-byte swizzle, through a
//    ring of 4 stages (3 of 32 KB at BN 256), across chunk and tile ends;
//    each stage keeps the next tap it loads, so a refill divides nothing.
//  - Patches: the third warpgroup copies a chunk's raw (TH + 2) x (TW + 2)
//    patch (the tile plus its one-pixel halo, zero outside the image) by
//    cp.async and applies the GN affine and SiLU in place, three patch
//    buffers deep: the next chunk's copy is in flight while this one is
//    normalized, and the products read a third. Each thread copies and
//    normalizes the same elements, so it waits for its own copies only. The
//    normalize skips pixels outside the image, whose zeros are the padding.
//
// Patches are channel-group-major ([8 groups][pixel][8 channels], 16 bytes
// per pixel and group; the odd pixel count between groups keeps a pixel's 8
// groups in 8 bank groups), so the 64 output pixels of one tile row,
// shifted by a tap, are 64 consecutive 16-byte rows at any pixel offset: at
// TW 64 a warpgroup reads a tap's A straight from the patch through a wgmma
// descriptor. At TW < 64 a row set spans several tile rows, so each warp
// loads its 16 rows with ldmatrix and the products take A from registers.
//
// Bound: operations. At SD-2.1 768^2 (10 views) the 20 encoder convs are
// ~22.6 TFLOP (22.9 ms at the bf16 peak) against ~28 GB of activations read
// and written (8.3 ms of HBM). The patch is normalized once per tile (1 or 2
// times per input element, x1.5-2.1 for the halo); the design keeps the
// normalized tensor out of device memory, which is what the TPU kernel was
// for. What the redesign found (tools/gn_conv_variants.py, PERF.md): the
// previous kernel's bare chain of waits and barriers (no products, copies,
// normalize or stores) took as long as the products, ~950 clocks a tap (a
// refill's two 64-bit divisions, once on the releasing warps, added 7.6 of
// 28 ms at 768^2); its epilogue ~10 of 60 ms (this one's ~7 of 49.6), the
// tensor cores idle meanwhile; 256-channel tiles halve the normalizes and
// the chain's taps per output channel. Tried and dropped: the two product
// warpgroups taking turns at a tap (ping-pong: slower), the epilogue staged
// per warp or quad-transposed into 16-byte accesses (slower, level), an L2
// prefetch of the residual (no faster), mbarrier waits spinning on
// test_wait in place of try_wait (57.9 against 49.3 ms at 768^2), two patch
// buffers (much slower), and earlier the patch by TMA boxes of 16-byte rows,
// a patch thread polling the weight ring, setmaxnreg between the roles.
#include "common.cuh"

namespace skp {

constexpr int kGcMmaWarps = 8;         // two warpgroups of products
constexpr int kGcPatchThreads = 128;   // warpgroup 2: patch copies and the normalize
constexpr int kGcThreads = 384;
constexpr int kGcKC = 64;              // input channels per chunk
constexpr int kGcPatches = 3;          // patch buffers: one in use, one normalized, one loading

// A tile is BN output channels (128, or 256 where Cout allows: each patch
// normalized once for twice the outputs) by TM = 32768 / BN pixels, so a
// product thread keeps 128 fp32 accumulators either way.
template <int BN>
struct GcCfg {
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
  static constexpr size_t smem = sizeof(bf16) * (R * WT + kGcPatches * MaxP * kGcKC) +
                                 sizeof(uint64_t) * 2 * (R + kGcPatches) + sizeof(int) * 4 * R;
};

// d (+)= a . b over one k16 slice of a tap, b [BN outputs] K-major: a
// through a descriptor (the patch) or from registers (ldmatrix)
template <int BN>
__device__ __forceinline__ void gc_mma_ss(float (&d)[BN / 2], uint64_t a, uint64_t b, int acc) {
  if constexpr (BN == 128) wgmma_m64n128k16_ss(d, a, b, acc);
  else wgmma_m64n256k16_ss(d, a, b, acc);
}
template <int BN>
__device__ __forceinline__ void gc_mma_rs(float (&d)[BN / 2], const uint32_t (&a)[4], uint64_t b,
                                          int acc) {
  if constexpr (BN == 128) wgmma_m64n128k16(d, a, b, acc);
  else wgmma_m64n256k16(d, a, b, acc);
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

// TW columns per tile (a compile-time constant, so the patch index math
// divides by constants). Every role walks tiles p, p + gridDim.x, ... (tile
// = output-channel tile fastest, then pixel tile, then image), so the
// producers run ahead across tile ends.
template <int TW, int BN>
__global__ void __launch_bounds__(kGcThreads, 1)
    gn_conv_kernel(const __grid_constant__ CUtensorMap tw, const bf16* __restrict__ x,
                   const float* __restrict__ mq, const float* __restrict__ ga,
                   const float* __restrict__ gb, const bf16* __restrict__ bias,
                   const bf16* __restrict__ res, bf16* __restrict__ out, int H, int W, int Cin,
                   int Cout, int tiles) {
  using Cfg = GcCfg<BN>;
  constexpr int TM = Cfg::TM, RS = Cfg::RS, R = Cfg::R, WT = Cfg::WT, NB = kGcPatches;
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
static int launch_gn_conv(const void* x, const void* m, const void* a, const void* b,
                          const void* w, const void* bias, const void* res, void* out, int B,
                          int H, int W, int Cin, int Cout, cudaStream_t stream) {
  using C = GcCfg<BN>;
  constexpr int TH = C::TM / TW;
  CUtensorMap tw;  // w as [Cout rows][9 Cin columns]: boxes of BN rows x 64 channels
  const int e = encode_rows_map(&tw, w, 1, Cout, 1, 9 * Cin, BN, true);
  if (e != 0) return e;
  cudaError_t err = cudaFuncSetAttribute(gn_conv_kernel<TW, BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::smem);
  if (err != cudaSuccess) return (int)err;
  const long tiles = static_cast<long>((H + TH - 1) / TH) * ((W + TW - 1) / TW) * (Cout / BN) * B;
  if (tiles > 0x7fffffff) return -1;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  dim3 grid(static_cast<unsigned>(std::min<long>(tiles, sms)));  // one block per SM
  gn_conv_kernel<TW, BN><<<grid, kGcThreads, C::smem, stream>>>(
      tw, static_cast<const bf16*>(x), static_cast<const float*>(m), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const bf16*>(bias), static_cast<const bf16*>(res),
      static_cast<bf16*>(out), H, W, Cin, Cout, static_cast<int>(tiles));
  return (int)cudaGetLastError();
}

// tiles as wide as W allows without padded columns (W 96: three of 32), of
// 256 output channels where Cout allows
template <int BN>
static int launch_gn_conv_bn(const void* x, const void* m, const void* a, const void* b,
                             const void* w, const void* bias, const void* res, void* out, int B,
                             int H, int W, int Cin, int Cout, cudaStream_t s) {
  if (W % 64 == 0) return launch_gn_conv<64, BN>(x, m, a, b, w, bias, res, out, B, H, W, Cin, Cout, s);
  if (W >= 32) return launch_gn_conv<32, BN>(x, m, a, b, w, bias, res, out, B, H, W, Cin, Cout, s);
  return launch_gn_conv<16, BN>(x, m, a, b, w, bias, res, out, B, H, W, Cin, Cout, s);
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
  return launch_gn_conv_bn<128>(x, m, a, b, w, bias, res, out, B, H, W, Cin, Cout, s);
}
