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
// tile is 256 output pixels (TH rows x TW columns, TW in {64, 32, 16}) x 128
// output channels. One block an SM walks its tiles persistently, Cin in
// chunks of 64 channels and each chunk's 9 taps. The block is
// warp-specialized; its roles meet at mbarriers only (one block barrier, at
// the start):
//
//  - Products: two warpgroups, each 128 of the tile's pixels as two m64 row
//    sets (two m64n128k16 products a k16 slice; 128 fp32 accumulators a
//    thread). A tap waits for its weight stage, issues its products and
//    waits for the previous tap's, so one tap stays in flight; each warp
//    then releases the previous stage, and thread 0 refills it once all 8
//    warps have. They also run the epilogue (bias, residual).
//  - Weights: w [o][dy][dx][c], read by TMA as a [Cout][9 Cin] matrix, one
//    [128 outputs x 64 channels] box a tap in the 128-byte swizzle, through a
//    ring of 4 stages, across chunk and tile ends.
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
// TW 64 (every SD-1.5 512^2 level) a warpgroup reads a tap's A straight from
// the patch through a wgmma descriptor. At TW < 64 a row set spans several
// tile rows, so each warp loads its 16 rows with ldmatrix and the products
// take A from registers.
//
// Bound: operations. At SD-1.5 512^2 (10 views) the 20 encoder convs are
// ~10 TFLOP against ~6 GB of activations read and written: ~10 ms of
// tensor-core time against ~2 ms of HBM traffic. The patch is normalized
// once per tile (1 to 4 times per input element, x1.5 for the halo); the
// design keeps the normalized tensor out of device memory, which is what
// the TPU kernel was for. Measured on an H100 (PERF.md,
// tools/gn_conv_variants.py): no part dominates; without the products the
// kernel still takes ~75% of its time (patch copies and their normalize,
// weight waits, the epilogue's residual loads while the tensor cores idle).
// Tried and dropped: 256-channel tiles where Cout allows (half the
// normalizes, no faster), the patch by TMA boxes of 16-byte rows, an L2
// prefetch of the residual, a patch thread that also polls the weight ring,
// setmaxnreg between the roles (no change), and, before the roles were
// split, one barrier a chunk with all warps copying, normalizing and
// multiplying (slower than the kernel it replaced).
#include "common.cuh"

namespace skp {

constexpr int kGcTM = 256;             // output pixels per tile
constexpr int kGcBN = 128;             // output channels per tile
constexpr int kGcMmaWarps = 8;         // two warpgroups of products
constexpr int kGcPatchThreads = 128;   // warpgroup 2: patch copies and the normalize
constexpr int kGcThreads = 384;
constexpr int kGcKC = 64;              // input channels per chunk
constexpr int kGcStages = 4;           // weight ring: [128 outputs][64 channels] a stage
constexpr int kGcWT = kGcBN * kGcKC;   // elements of a weight stage (128-byte swizzle)
constexpr int kGcPatches = 3;          // patch buffers: one in use, one normalized, one loading
// (TH + 2) x (TW + 2) pixels, largest at TW 64, + 1: the pixel count NP
// between channel groups is odd, so the 8 groups of a pixel lie in 8
// different 16-byte bank groups
constexpr int kGcMaxP = (kGcTM / 64 + 2) * 66 + 1;
// the weight ring (bf16, 1024-byte aligned), the patch buffers (bf16), a
// full and an empty mbarrier per stage and per patch buffer
constexpr size_t kGcSmem = sizeof(bf16) * (kGcStages * kGcWT + kGcPatches * kGcMaxP * kGcKC) +
                           sizeof(uint64_t) * 2 * (kGcStages + kGcPatches);

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
template <int TW>
__global__ void __launch_bounds__(kGcThreads, 1)
    gn_conv_kernel(const __grid_constant__ CUtensorMap tw, const bf16* __restrict__ x,
                   const float* __restrict__ mq, const float* __restrict__ ga,
                   const float* __restrict__ gb, const bf16* __restrict__ bias,
                   const bf16* __restrict__ res, bf16* __restrict__ out, int H, int W, int Cin,
                   int Cout, int tiles) {
  constexpr int BN = kGcBN, R = kGcStages, WT = kGcWT, NB = kGcPatches;
  extern __shared__ __align__(1024) unsigned char smem[];
  bf16* Ws = reinterpret_cast<bf16*>(smem);  // [stage][128 outputs][64 channels], 128-byte swizzle
  bf16* Pb = Ws + R * WT;                    // [3][8][NP][8] patches, chunk C in buffer C % 3
  uint64_t* full = reinterpret_cast<uint64_t*>(Pb + NB * kGcMaxP * kGcKC);  // [stage]
  uint64_t* empty = full + R;                                              // [stage]
  uint64_t* pfull = empty + R;     // [buffer] a patch normalized
  uint64_t* pempty = pfull + NB;   // [buffer] a patch's products done

  constexpr int TH = kGcTM / TW, PC = TW + 2, NPIX = (TH + 2) * PC, NP = NPIX | 1;
  const int tiles_w = (W + TW - 1) / TW, tiles_p = ((H + TH - 1) / TH) * tiles_w;
  const int tiles_n = Cout / BN;
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int chunks = Cin / kGcKC;
  auto patch = [&](int c) { return Pb + (c % NB) * kGcMaxP * kGcKC; };

  struct Tile {
    int n0, b, ty0, tx0;
  };
  auto tile_at = [&](int i) {
    const int p = (i / tiles_n) % tiles_p;
    return Tile{(i % tiles_n) * BN, i / (tiles_n * tiles_p), (p / tiles_w) * TH,
                (p % tiles_w) * TW};
  };

  if (tid == 0) {
    for (int s = 0; s < R; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kGcMmaWarps);
    }
    for (int s = 0; s < NB; ++s) {
      mbar_init(&pfull[s], kGcPatchThreads);
      mbar_init(&pempty[s], kGcMmaWarps);
    }
    mbar_fence_init();
  }
  // the weights of tap G of the walk (tile, chunk, dy, dx) into stage G % R:
  // one TMA box of w viewed as [Cout rows][9 Cin columns], 128 rows of 64
  // channels; issued by thread 0
  const long taps = 9L * chunks;
  auto issue_w = [&](long G) {
    const long i = blockIdx.x + (G / taps) * static_cast<long>(gridDim.x);
    if (i >= tiles) return;
    const int r = static_cast<int>(G % taps), st = static_cast<int>(G % R);
    mbar_expect_tx(&full[st], WT * 2);
    tma_load_4d(Ws + st * WT, &tw, (r % 9) * Cin + (r / 9) * kGcKC, 0,
                (static_cast<int>(i) % tiles_n) * BN, 0, &full[st]);
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
      if (i_n < tiles) {
        load(tile_at(i_n), c_n, C + 1);
        cp_async_wait_1();  // this chunk's raw pixels landed; the next one's may be in flight
      } else {
        cp_async_wait_all();
      }
      const long at = static_cast<long>(T.b) * Cin + c * kGcKC + 8 * cg;
      __nv_bfloat162 cm[4], ca[4], cb[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        cm[e] = __floats2bfloat162_rn(mq[at + 2 * e], mq[at + 2 * e + 1]);
        ca[e] = __floats2bfloat162_rn(ga[at + 2 * e], ga[at + 2 * e + 1]);
        cb[e] = __floats2bfloat162_rn(gb[at + 2 * e], gb[at + 2 * e + 1]);
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

  // the products: warpgroup wg owns pixels 128 wg .. 128 wg + 127 of a tile
  // as two m64 row sets (tile rows 2 wg + j at TW 64)
  auto release = [&](long P) {  // tap P's products are done in this warp
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[P % R]);
    if (tid == 0) {  // once every warp is done with the stage, refill it with tap P + R
      mbar_wait(&empty[P % R], static_cast<int>((P / R) & 1));
      issue_w(P + R);
    }
  };
  float acc[2][64];  // row set j, m64n128 layout
  long G = 0;
  for (int i = blockIdx.x, C = 0; i < tiles; i += gridDim.x) {
    const Tile T = tile_at(i);
    for (int c = 0; c < chunks; ++c, ++C) {
      mbar_wait(&pfull[C % NB], (C / NB) & 1);
      const bf16* Ps = patch(C);
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap, ++G) {
        const int dy = tap / 3, dx = tap % 3;
        const bf16* wt = Ws + static_cast<int>(G % R) * WT;
        mbar_wait(&full[G % R], static_cast<int>((G / R) & 1));
        if constexpr (TW == 64) {
          // A of tap (dy, dx), k16 slice ks: the 64 patch pixels of the row
          // set's tile row shifted by the tap, channel groups 2 ks and 2 ks + 1
          wgmma_fence();
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int ks = 0; ks < kGcKC / 16; ++ks) {
              const uint64_t da =
                  smem_desc(Ps + (2 * ks * NP + (2 * wg + j + dy) * PC + dx) * 8, NP * 16, 128);
              wgmma_m64n128k16_ss(acc[j], da, desc_sw128_kmajor<BN>(wt, ks),
                                  c > 0 || tap > 0 || ks > 0);
            }
          wgmma_commit();
          reg_fence(acc[0]);
          reg_fence(acc[1]);
          wgmma_wait1();  // the previous tap's products are done
        } else {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            // ldmatrix.x4 rows: pixel lane % 16 of the warp's 16, channel group lane / 16
            const int p = 64 * (2 * wg + j) + 16 * warp;
            const int pbase = (p / TW) * PC + p % TW;
            uint32_t af[kGcKC / 16][4];
#pragma unroll
            for (int ks = 0; ks < kGcKC / 16; ++ks)
              ldsm_x4(af[ks],
                      Ps + ((2 * ks + lane / 16) * NP + pbase + dy * PC + dx + lane % 16) * 8);
            wgmma_fence();
#pragma unroll
            for (int ks = 0; ks < kGcKC / 16; ++ks)
              wgmma_m64n128k16(acc[j], af[ks], desc_sw128_kmajor<BN>(wt, ks),
                               c > 0 || tap > 0 || ks > 0);
            wgmma_commit();
            wgmma_wait0();
            reg_fence(acc[j]);
          }
        }
        if (tap > 0) release(G - 1);
      }
      wgmma_wait0();
      reg_fence(acc[0]);
      reg_fence(acc[1]);
      release(G - 1);
      if (lane == 0) mbar_arrive(&pempty[C % NB]);  // this warp is done with the patch
    }

    // epilogue: round, + bias (bf16), + residual (bf16), store
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = 64 * (2 * wg + j) + 16 * warp + g + 8 * r;
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
    reg_fence(acc[0]);
    reg_fence(acc[1]);
  }
}

template <int TW>
static int launch_gn_conv(const void* x, const void* m, const void* a, const void* b,
                          const void* w, const void* bias, const void* res, void* out, int B,
                          int H, int W, int Cin, int Cout, cudaStream_t stream) {
  constexpr int TH = kGcTM / TW;
  CUtensorMap tw;  // w as [Cout rows][9 Cin columns]: boxes of 128 rows x 64 channels
  const int e = encode_rows_map(&tw, w, 1, Cout, 1, 9 * Cin, kGcBN, true);
  if (e != 0) return e;
  cudaError_t err = cudaFuncSetAttribute(gn_conv_kernel<TW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kGcSmem);
  if (err != cudaSuccess) return (int)err;
  const long tiles =
      static_cast<long>((H + TH - 1) / TH) * ((W + TW - 1) / TW) * (Cout / kGcBN) * B;
  if (tiles > 0x7fffffff) return -1;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  dim3 grid(static_cast<unsigned>(std::min<long>(tiles, sms)));  // one block per SM
  gn_conv_kernel<TW><<<grid, kGcThreads, kGcSmem, stream>>>(
      tw, static_cast<const bf16*>(x), static_cast<const float*>(m), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const bf16*>(bias), static_cast<const bf16*>(res),
      static_cast<bf16*>(out), H, W, Cin, Cout, static_cast<int>(tiles));
  return (int)cudaGetLastError();
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
  if (W >= 64) return launch_gn_conv<64>(x, m, a, b, w, bias, res, out, B, H, W, Cin, Cout, s);
  if (W >= 32) return launch_gn_conv<32>(x, m, a, b, w, bias, res, out, B, H, W, Cin, Cout, s);
  return launch_gn_conv<16>(x, m, a, b, w, bias, res, out, B, H, W, Cin, Cout, s);
}
