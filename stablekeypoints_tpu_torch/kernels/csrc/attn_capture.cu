// K1: fused capture attention, forward (sm_90a).
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
// Layout: one block of 8 warps per (b, output row o, 128 columns p), 16
// query rows per warp. The rows of tt[b, :, o] for every head stay in
// shared memory; 64-key tiles of k stream through a double buffer
// (cp.async). The head-mean needs each head's softmax normalised first,
// so the block makes two passes over the (head, key tile) pairs:
//   1. for each head, the row max and sum over all T tokens;
//   2. for each key tile, the sum over heads of exp(s - max_h) / sum_h / H,
//      accumulated in registers in head order (deterministic, no atomics;
//      the TPU kernel carried it across a sequential grid axis, and blocks
//      on Hopper run in no order), then written once.
// Pass 2 rebuilds each head's query fragments (an X-deep product, a
// quarter to a half of the q.k products it feeds).
//
// Bound: operations. At the SD-1.5 shapes (16384 queries x 512 padded
// tokens x d 160 or 80, 8 heads, 10 views) q.k is ~2e11 FLOP per d-160
// launch, done twice, against a 0.33 GB fp32 output.
#include "common.cuh"

namespace skp {

constexpr int kCapWarps = 8;
constexpr int kCapBQ = 16 * kCapWarps;  // output columns p per block
constexpr int kCapBK = 64;              // keys per tile
constexpr int kCapMaxX = 32;

template <int D>
struct CaptureCfg {
  static_assert(D % 16 == 0, "query fragments are built 16 columns at a time");
  static constexpr int LD = tile_ld(D);
  static size_t bytes(int H, int XP) {
    return sizeof(bf16) * (H * XP * LD + 2 * kCapBK * LD) + sizeof(float) * 2 * H * kCapBQ;
  }
};

// Two blocks per SM: at d 160 the register cap of 128 spills a few bytes,
// and the kernel still ran faster on an H100 than at one block per SM
// with 167 registers.
template <int D>
__global__ void __launch_bounds__(kCapWarps * 32, 2)
    capture_fwd_kernel(const bf16* __restrict__ tt, const bf16* __restrict__ ww,
                       const bf16* __restrict__ k, float* __restrict__ out, int H, int O,
                       int X, int P, int T, float scale_log2) {
  using C = CaptureCfg<D>;
  constexpr int LD = C::LD, KS = D / 16, NT = kCapBK / 8;
  constexpr int XS = kCapMaxX / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int xsteps = (X + 15) / 16, XP = 16 * xsteps;
  bf16* Ts = reinterpret_cast<bf16*>(smem);  // [H][XP][LD]: tt[b, h, o], rows >= X zero
  bf16* Ks = Ts + H * XP * LD;               // [2][BK][LD]
  float* Mx = reinterpret_cast<float*>(Ks + 2 * kCapBK * LD);  // [H][BQ] row max (log2)
  float* Inv = Mx + H * kCapBQ;                                // [H][BQ] 1 / (sum * H)

  const int b = blockIdx.z, o = blockIdx.y, p0 = blockIdx.x * kCapBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const long krow = static_cast<long>(H) * D;
  const int key_tiles = (T + kCapBK - 1) / kCapBK;
  const int steps = H * key_tiles;  // (head, key tile) pairs per pass

  // step i of the two passes: pass 1 runs head-major, pass 2 tile-major
  auto head_of = [&](int i) { return i < steps ? i / key_tiles : (i - steps) % H; };
  auto tile_of = [&](int i) { return i < steps ? i % key_tiles : (i - steps) / H; };
  auto issue = [&](int i) {
    const int h = head_of(i), k0 = tile_of(i) * kCapBK;
    load_tile_async<D / 8>(Ks + (i & 1) * kCapBK * LD, LD,
                            k + (static_cast<long>(b) * T + k0) * krow + h * D, krow, kCapBK,
                            min(kCapBK, T - k0), D);
  };
  for (int h = 0; h < H; ++h)
    load_tile_async<D / 8>(Ts + h * XP * LD, LD,
                           tt + ((static_cast<long>(b) * H + h) * O + o) * X * D, D, XP, X, D);
  issue(0);
  cp_async_commit();

  // A fragments of ww for this warp's 16 rows (p >= P and x >= X are zero)
  uint32_t wf[XS][4];
  {
    auto w = [&](int r, int x) {
      const int p = p0 + warp * 16 + r;
      return (p < P && x < X) ? __bfloat162float(ww[p * X + x]) : 0.f;
    };
#pragma unroll
    for (int xs = 0; xs < XS; ++xs) {
      const int x = 16 * xs + 2 * t;
      wf[xs][0] = pack_bf16(w(g, x), w(g, x + 1));
      wf[xs][1] = pack_bf16(w(g + 8, x), w(g + 8, x + 1));
      wf[xs][2] = pack_bf16(w(g, x + 8), w(g, x + 9));
      wf[xs][3] = pack_bf16(w(g + 8, x + 8), w(g + 8, x + 9));
    }
  }

  // query fragments of head h: bf16(ww . tt[b,h,o]) with fp32 accumulation
  uint32_t qf[KS][4];
  auto build_q = [&](int h) {
    const bf16* th = Ts + h * XP * LD;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int xs = 0; xs < XS; ++xs) {
          if (xs >= xsteps) break;
          uint32_t bb[2];
          load_b(bb, th + 16 * xs * LD, LD, 16 * ks + 8 * half, lane);
          mma_bf16(c[half], wf[xs], bb);
        }
      }
      qf[ks][0] = pack_bf16(c[0][0], c[0][1]);
      qf[ks][1] = pack_bf16(c[0][2], c[0][3]);
      qf[ks][2] = pack_bf16(c[1][0], c[1][1]);
      qf[ks][3] = pack_bf16(c[1][2], c[1][3]);
    }
  };

  const int rl = warp * 16 + g;  // this lane's first row within the block
  float m_r[2] = {0.f, 0.f}, l_r[2] = {0.f, 0.f}, acc[NT][4] = {};
  for (int i = 0; i < 2 * steps; ++i) {
    cp_async_wait_all();
    __syncthreads();  // step i's keys landed; every warp is done with the other buffer
    if (i + 1 < 2 * steps) {
      issue(i + 1);
      cp_async_commit();
    }
    const int h = head_of(i), kt = tile_of(i);
    const bf16* keys = Ks + (i & 1) * kCapBK * LD;

    if (i < steps) {  // pass 1: online max and sum of head h
      if (kt == 0) {
        build_q(h);
        m_r[0] = m_r[1] = -CUDART_INF_F;
        l_r[0] = l_r[1] = 0.f;
      }
      float s[NT][4];
      warp_scores<KS, NT>(s, qf, keys, LD, lane);
      scale_mask<NT>(s, scale_log2, kt * kCapBK, T, lane);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -CUDART_INF_F;
#pragma unroll
        for (int n = 0; n < NT; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
        const float m_new = fmaxf(m_r[r], quad_max(mx));
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < NT; ++n)
          sum += exp2f(s[n][2 * r] - m_new) + exp2f(s[n][2 * r + 1] - m_new);
        l_r[r] = l_r[r] * exp2f(m_r[r] - m_new) + sum;
        m_r[r] = m_new;
      }
      if (kt == key_tiles - 1) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float l = quad_sum(l_r[r]);
          if (t == 0) {
            Mx[h * kCapBQ + rl + 8 * r] = m_r[r];
            Inv[h * kCapBQ + rl + 8 * r] = 1.0f / (l * static_cast<float>(H));
          }
        }
        __syncwarp();  // each warp reads back only its own rows
      }
    } else {  // pass 2: accumulate the head-mean of one key tile
      if (h == 0) {
#pragma unroll
        for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
      }
      build_q(h);
      float s[NT][4];
      warp_scores<KS, NT>(s, qf, keys, LD, lane);
      scale_mask<NT>(s, scale_log2, kt * kCapBK, T, lane);
      const float mx[2] = {Mx[h * kCapBQ + rl], Mx[h * kCapBQ + rl + 8]};
      const float iv[2] = {Inv[h * kCapBQ + rl], Inv[h * kCapBQ + rl + 8]};
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] += exp2f(s[n][e] - mx[e >> 1]) * iv[e >> 1];
      if (h == H - 1) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int p = p0 + rl + 8 * r;
          if (p >= P) continue;
          float* dst = out + ((static_cast<long>(b) * O + o) * P + p) * T;
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const int col = kt * kCapBK + 8 * n + 2 * t;
            if (col < T) dst[col] = acc[n][2 * r];
            if (col + 1 < T) dst[col + 1] = acc[n][2 * r + 1];
          }
        }
      }
    }
  }
}

template <int D>
static int launch_capture(const void* tt, const void* ww, const void* k, void* out, int B,
                          int H, int O, int X, int P, int T, float scale,
                          cudaStream_t stream) {
  if (X > kCapMaxX) return -1;
  const size_t smem = CaptureCfg<D>::bytes(H, (X + 15) / 16 * 16);
  cudaError_t err = cudaFuncSetAttribute(
      capture_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((P + kCapBQ - 1) / kCapBQ, O, B);
  capture_fwd_kernel<D><<<grid, kCapWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(tt), static_cast<const bf16*>(ww),
      static_cast<const bf16*>(k), static_cast<float*>(out), H, O, X, P, T, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace skp

// tt [B,H,O,X,D] bf16, ww [P,X] bf16, k [B,T,H,D] bf16 -> out [B, O*P, T] fp32.
// Returns a cudaError_t; -1 for an unsupported head dimension or X > 32.
extern "C" int skp_capture_fwd(const void* tt, const void* ww, const void* k, void* out,
                               int B, int H, int O, int X, int P, int T, int D,
                               float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 80: return skp::launch_capture<80>(tt, ww, k, out, B, H, O, X, P, T, scale, s);
    case 160: return skp::launch_capture<160>(tt, ww, k, out, B, H, O, X, P, T, scale, s);
    default: return -1;
  }
}
