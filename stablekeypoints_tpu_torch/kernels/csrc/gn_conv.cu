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
// output channels; a block (four warpgroups, each 64 pixels x 128 channels,
// m64n128k16) is persistent, one per SM, and walks its tiles, and within a
// tile Cin in chunks of 64. A chunk's raw (TH + 2) x (TW + 2) input patch
// (the tile plus its one-pixel halo, zero outside the image) and its GN
// coefficients arrive by cp.async into one of two patch buffers while the
// other chunk's taps run; at the chunk's last tap row the block applies
// the GN affine and SiLU to the next chunk in place, while that tap row's
// products run. Patches are channel-group-major ([8 groups][pixel][8
// channels], 16 bytes per pixel and group), so the 64 output pixels of one
// tile row, shifted by a tap, are 64 consecutive 16-byte rows at any pixel
// offset: at TW 64 (every SD-1.5 512^2 level) a warpgroup reads a tap's A
// straight from the patch through a wgmma descriptor, and the 12 products
// of a step (3 taps x 4 k16 slices) run asynchronously while the next
// step's weights load. At TW < 64 a warpgroup's rows span two tile rows, so
// each warp loads its 16 rows with ldmatrix and the products take A from
// registers. The weights stay in the port's channels-last conv layout
// w[o][dy][dx][c]: per (chunk, tap row dy) three [128 outputs x 64
// channels] tiles stream through a cp.async double buffer into the 8x8
// core-matrix layout wgmma reads; a block passes one barrier per step.
//
// Bound: operations. At SD-1.5 512^2 (10 views) the 20 encoder convs are
// ~10 TFLOP against ~6 GB of activations read and written: ~10 ms of
// tensor-core time against ~2 ms of HBM traffic. The patch is normalized
// once per 128 output channels (1 to 4 times per input element, x1.5 for
// the halo); the design keeps the normalized tensor out of device memory,
// which is what the TPU kernel was for. Measured on an H100 the products
// take a small share of the kernel's time: each tile streams the whole
// [128 x 9 Cin] weight slab from L2 for its 256 pixels, and the loads, the
// normalize and the per-step barrier of one block per SM dominate
// (PERF.md, tools/gn_conv_variants.py). TMA-staged halos, weights
// multicast to a cluster of blocks and warp-specialized producers are the
// next step.
#include "common.cuh"

namespace skp {

constexpr int kGcBM = 256;             // output pixels per block
constexpr int kGcWarps = kGcBM / 16;   // 16 pixels x 128 channels per warp, 4 per warpgroup
constexpr int kGcBN = 128;  // output channels per block
constexpr int kGcKC = 64;   // input channels per chunk
constexpr int kGcWT = kGcBN * kGcKC;   // elements of a weight tile (8x8 core matrices)
// (TH + 2) x (TW + 2) pixels, largest at TW 64, + 1: the pixel count NP
// between channel groups is odd, so the 8 groups of a pixel lie in 8
// different 16-byte bank groups
constexpr int kGcMaxPatch = (kGcBM / 64 + 2) * 66 + 1;

// two patch buffers, two buffers of 3 weight tiles (bf16); a chunk's m, a,
// b (fp32)
__host__ __device__ constexpr size_t gn_conv_smem_bytes() {
  return sizeof(bf16) * (2 * kGcMaxPatch * kGcKC + 6 * kGcWT) + sizeof(float) * 3 * kGcKC;
}

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
// divides by constants). At TW 64 a warpgroup's 64 pixels are one tile row
// and its products read A from the patch, else from registers. Persistent:
// block p takes tiles p, p + gridDim.x, ... (tile = output-channel tile
// fastest, then pixel tile, then image), and the steps of consecutive tiles
// form one pipeline, so the next tile's first weights, raw patch and
// normalize overlap this tile's last taps and its epilogue.
template <int TW>
__global__ void __launch_bounds__(kGcWarps * 32, 1)
    gn_conv_kernel(const bf16* __restrict__ x, const float* __restrict__ mq,
                   const float* __restrict__ ga, const float* __restrict__ gb,
                   const bf16* __restrict__ w, const bf16* __restrict__ bias,
                   const bf16* __restrict__ res, bf16* __restrict__ out, int H, int W,
                   int Cin, int Cout, int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Pb = reinterpret_cast<bf16*>(smem);  // [2][8][NP][8] patches, chunk C in buffer C & 1
  bf16* Ws = Pb + 2 * kGcMaxPatch * kGcKC;   // [2][3 dx][WT] weight tiles (o, c), step S in S & 1
  float* Cf = reinterpret_cast<float*>(Ws + 6 * kGcWT);  // [3][KC] m, a, b of the next chunk

  constexpr int TH = kGcBM / TW, PC = TW + 2, NPIX = (TH + 2) * PC, NP = NPIX | 1;
  const int tiles_w = (W + TW - 1) / TW, tiles_p = ((H + TH - 1) / TH) * tiles_w;
  const int tiles_n = Cout / kGcBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int chunks = Cin / kGcKC, steps = 3 * chunks;
  const long wrow = 9L * Cin;  // elements per output channel of w
  auto patch = [&](int c) { return Pb + (c & 1) * kGcMaxPatch * kGcKC; };

  struct Tile {
    int n0, b, ty0, tx0;
  };
  auto tile_at = [&](int i) {
    const int p = (i / tiles_n) % tiles_p;
    return Tile{(i % tiles_n) * kGcBN, i / (tiles_n * tiles_p), (p / tiles_w) * TH,
                (p % tiles_w) * TW};
  };

  // the weights of step s of tile T into buffer S & 1: the three taps dx of
  // tap row s % 3 for chunk s / 3, each [128 outputs x 64 channels] stored
  // as 8x8 core matrices (output group n / 8 at 1024 bytes, channel group
  // k / 8 at 128 bytes, then row n % 8 at 16 bytes: the K-major layout wgmma
  // reads without swizzle); consecutive threads fill consecutive 16 bytes
  auto issue = [&](const Tile& T, int s, int S) {
    const int c0 = (s / 3) * kGcKC, dy = s % 3;
    for (int idx = threadIdx.x; idx < 3 * kGcBN * (kGcKC / 8); idx += blockDim.x) {
      const int r = idx % 8, kc = (idx / 8) % (kGcKC / 8), rest = idx / kGcKC;
      const int n8 = rest % (kGcBN / 8), dx = rest / (kGcBN / 8), n = 8 * n8 + r;
      cp_async16(Ws + ((S & 1) * 3 + dx) * kGcWT + (n8 * (kGcKC / 8) + kc) * 64 + r * 8,
                 w + static_cast<long>(T.n0 + n) * wrow + (3 * dy + dx) * Cin + c0 + 8 * kc, true);
    }
  };
  auto inside = [&](const Tile& T, int q) {
    const int y = T.ty0 - 1 + q / PC, xx = T.tx0 - 1 + q % PC;
    return y >= 0 && y < H && xx >= 0 && xx < W;
  };
  // the raw patch of chunk c of tile T into buffer C & 1 (pixels outside the
  // image are zero-filled) and the chunk's coefficients
  auto issue_raw = [&](const Tile& T, int c, int C) {
    const int c0 = c * kGcKC;
    bf16* dst = patch(C);
    for (int idx = threadIdx.x; idx < NPIX * (kGcKC / 8); idx += blockDim.x) {
      const int q = idx / (kGcKC / 8), j = idx % (kGcKC / 8);
      const int y = T.ty0 - 1 + q / PC, xx = T.tx0 - 1 + q % PC;
      const bool ok = inside(T, q);
      cp_async16(dst + (j * NP + q) * 8,
                 ok ? x + ((static_cast<long>(T.b) * H + y) * W + xx) * Cin + c0 + 8 * j : x, ok);
    }
    if (threadIdx.x < 3 * kGcKC / 4) {  // 16 floats of m, a or b per 4 threads
      const int k = threadIdx.x / (kGcKC / 4), e = threadIdx.x % (kGcKC / 4);
      const float* src =
          (k == 0 ? mq : k == 1 ? ga : gb) + static_cast<long>(T.b) * Cin + c0 + 4 * e;
      cp_async16(reinterpret_cast<bf16*>(Cf + k * kGcKC + 4 * e),
                 reinterpret_cast<const bf16*>(src), true);
    }
  };
  // GN affine + SiLU of a landed raw patch in buffer C & 1, in place; the
  // pad ring stays zero. Each thread keeps 8 channels (blockDim % (KC / 8) == 0).
  const int cg = threadIdx.x % (kGcKC / 8);
  auto normalize = [&](const Tile& T, int C) {
    __nv_bfloat162 cm[4], ca[4], cb[4];  // m, a, b of this thread's 8 channels, in bf16
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ch = 8 * cg + 2 * e;
      cm[e] = __floats2bfloat162_rn(Cf[ch], Cf[ch + 1]);
      ca[e] = __floats2bfloat162_rn(Cf[kGcKC + ch], Cf[kGcKC + ch + 1]);
      cb[e] = __floats2bfloat162_rn(Cf[2 * kGcKC + ch], Cf[2 * kGcKC + ch + 1]);
    }
    bf16* buf = patch(C);
    for (int idx = threadIdx.x; idx < NPIX * (kGcKC / 8); idx += blockDim.x) {
      const int q = idx / (kGcKC / 8);
      if (!inside(T, q)) continue;
      uint32_t* v = reinterpret_cast<uint32_t*>(buf + (cg * NP + q) * 8);
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = gn_silu2(v[e], cm[e], ca[e], cb[e]);
    }
    fence_proxy_async();  // the patch is read by wgmma (async proxy)
  };

  // first patch pixel of this warp's 16-pixel row group (of its warpgroup's
  // 64-pixel row at TW 64)
  const int pbase = (warp * 16 / TW) * PC + warp * 16 % TW;
  const int pgroup = (warp / 4) * PC;

  int i = blockIdx.x;  // the grid has at most `tiles` blocks
  Tile T = tile_at(i);
  issue_raw(T, 0, 0);
  issue(T, 0, 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  normalize(T, 0);

  // Per step: wait for its weights, then start the next step's weights (and
  // at a chunk's first step the next chunk's raw patch, into the other
  // buffer), run the 3 taps, and at a chunk's last step normalize the next
  // chunk while the taps run. The next step or chunk may be the next tile's.
  float acc[64];
  for (int S = 0, C = 0;; C += chunks) {  // S, C: this block's step and chunk count
    const int i_next = i + gridDim.x;
    const bool last_tile = i_next >= tiles;
    const Tile Tn = tile_at(last_tile ? i : i_next);
    for (int s = 0; s < steps; ++s, ++S) {
      const int dy = s % 3, c = s / 3;
      const bool more = c + 1 < chunks || !last_tile;  // a next chunk to load and normalize
      // at dy 1 the next chunk's raw patch, committed last, may still be in flight
      if (dy == 1 && more)
        cp_async_wait_1();
      else
        cp_async_wait_all();
      wgmma_wait0();        // step S-1's products are done with their patch and weight buffers
      fence_proxy_async();  // this thread's landed weights are visible to wgmma (async proxy)
      __syncthreads();      // step S's weights, and every thread's normalized patch
      if (s + 1 < steps)
        issue(T, s + 1, S + 1);
      else if (!last_tile)
        issue(Tn, 0, S + 1);
      cp_async_commit();
      if (dy == 0 && more) {
        if (c + 1 < chunks)
          issue_raw(T, c + 1, C + c + 1);
        else
          issue_raw(Tn, 0, C + c + 1);
        cp_async_commit();
      }
      const bf16* Ps = patch(C + c);
      const bf16* wt = Ws + (S & 1) * 3 * kGcWT;
      if constexpr (TW == 64) {
        // A of tap (dy, dx), k16 slice ks: 64 patch pixels from the warpgroup's
        // row shifted by the tap, channel groups 2 ks and 2 ks + 1
        wgmma_fence();
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
#pragma unroll
          for (int ks = 0; ks < kGcKC / 16; ++ks)
            wgmma_m64n128k16_ss(acc, smem_desc(Ps + (2 * ks * NP + pgroup + dy * PC + dx) * 8,
                                               NP * 16, 128),
                                smem_desc(wt + dx * kGcWT + 2 * ks * 64, 128, 16 * kGcKC),
                                s > 0 || dx > 0 || ks > 0);
        wgmma_commit();  // waited for at the next step's barrier
        wgmma_fence_acc(acc);
      } else {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          // ldmatrix.x4 rows: pixel lane % 16 of the window, channel group lane / 16
          uint32_t af[kGcKC / 16][4];
#pragma unroll
          for (int ks = 0; ks < kGcKC / 16; ++ks)
            ldsm_x4(af[ks],
                    Ps + ((2 * ks + lane / 16) * NP + pbase + dy * PC + dx + lane % 16) * 8);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < kGcKC / 16; ++ks)
            wgmma_m64n128k16(acc, af[ks],
                             smem_desc(wt + dx * kGcWT + 2 * ks * 64, 128, 16 * kGcKC),
                             s > 0 || dx > 0 || ks > 0);
          wgmma_commit();
          wgmma_wait0();
          wgmma_fence_acc(acc);
        }
      }
      // the next chunk's raw patch landed (waited for above)
      if (dy == 2 && more) normalize(c + 1 < chunks ? T : Tn, C + c + 1);
    }
    wgmma_wait0();
    wgmma_fence_acc(acc);

    // epilogue: round, + bias (bf16), + residual (bf16), store
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = warp * 16 + g + 8 * r;
      const int y = T.ty0 + p / TW, xx = T.tx0 + p % TW;
      if (y >= H || xx >= W) continue;
      const long pix = ((static_cast<long>(T.b) * H + y) * W + xx) * Cout;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int n = T.n0 + 8 * j + 2 * t;
        float v0 = round_bf16(round_bf16(acc[4 * j + 2 * r]) + __bfloat162float(bias[n]));
        float v1 = round_bf16(round_bf16(acc[4 * j + 2 * r + 1]) + __bfloat162float(bias[n + 1]));
        if (res != nullptr) {
          const uint32_t u = *reinterpret_cast<const uint32_t*>(res + pix + n);
          v0 = __bfloat162float(__ushort_as_bfloat16(u & 0xffffu)) + v0;
          v1 = __bfloat162float(__ushort_as_bfloat16(u >> 16)) + v1;
        }
        *reinterpret_cast<uint32_t*>(out + pix + n) = pack_bf16(v0, v1);
      }
    }
    wgmma_fence_acc(acc);
    if (last_tile) break;
    i = i_next;
    T = Tn;
  }
}

}  // namespace skp

// x [B,H,W,Cin] bf16, m/a/b [B,Cin] fp32, w [Cout,3,3,Cin] bf16 (channels-last
// conv weight), bias [Cout] bf16, res [B,H,W,Cout] bf16 or null ->
// out [B,H,W,Cout] bf16. Returns a cudaError_t; -1 for a shape the kernel
// does not take (Cin % 64, Cout % 128, W or H < 8).
extern "C" int skp_gn_conv(const void* x, const void* m, const void* a, const void* b,
                           const void* w, const void* bias, const void* res, void* out, int B,
                           int H, int W, int Cin, int Cout, void* stream) {
  using namespace skp;
  if (Cin % kGcKC != 0 || Cout % kGcBN != 0 || H < 8 || W < 8) return -1;
  const int TW = W >= 64 ? 64 : (W >= 32 ? 32 : 16);
  const int TH = kGcBM / TW;
  const size_t smem = gn_conv_smem_bytes();
  auto kernel = TW == 64 ? gn_conv_kernel<64> : TW == 32 ? gn_conv_kernel<32> : gn_conv_kernel<16>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long tiles =
      static_cast<long>((H + TH - 1) / TH) * ((W + TW - 1) / TW) * (Cout / kGcBN) * B;
  if (tiles > 0x7fffffff) return -1;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  dim3 grid(static_cast<unsigned>(std::min<long>(tiles, sms)));  // one block per SM
  kernel<<<grid, kGcWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(m), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const bf16*>(w), static_cast<const bf16*>(bias),
      static_cast<const bf16*>(res), static_cast<bf16*>(out), H, W, Cin, Cout,
      static_cast<int>(tiles));
  return (int)cudaGetLastError();
}
