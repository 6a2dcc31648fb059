// K4/K5: flash (online-softmax) attention, forward and backward (sm_90a).
//
// Replaces stablekeypoints_tpu/kernels/flash.py flash_self_attention (K4)
// and flash_cross_attention (K5), which call JAX's stock Pallas TPU
// flash_attention. K5 there pads kv to 128 and masks through segment ids;
// here it is the same kernel with a kv-length mask.
//
//   out = softmax(q . k^T * scale) . v   fp32 running max/sum/accumulator
//
// A block of 4 warps owns 64 query rows of one (b, h), 16 per warp, and
// walks the keys in tiles of 64; the next key/value tile is copied
// (cp.async) while the tensor cores work on the current one. q.k and p.v
// run as mma.sync m16n8k16 (bf16 in, fp32 out); p is rounded to bf16 for
// p.v as in FlashAttention. Head dims that are not multiples of 16 (40)
// are zero-padded in shared memory.
//
// d = 512 (the VAE mid-block, one head) has its own kernel: a 16 x 512
// fp32 accumulator does not fit one warp's registers, so 8 warps share a
// 64-row query tile. For a 32-key tile, warp w scores rows 16*(w%4) on
// keys 16*(w/4): the two key halves exchange row maxima through shared
// memory and write p there (bf16); then warp w multiplies its rows' p by
// the value columns 256*(w/4) .. +255. No score is computed twice.
//
// With a non-null `lse`, the d <= 160 kernel also writes each row's
// log-sum-exp of the log2-domain logits (fp32 [B, H, N]), the residual of
// the backward (attn_bwd.cuh); skp_flash_bwd first forms di = rowsum(dO*O)
// from the bf16 output, as JAX's stock backward does, then runs the dkdv
// and dq kernels.
//
// Bound: operations (4*N*M*D FLOP against inputs read once; the backward
// 10*N*M*D).
#include "attn_bwd.cuh"

namespace skp {

constexpr int kFlashWarps = 4;
constexpr int kFlashBQ = 16 * kFlashWarps;

constexpr int kFlashBK = 64;

template <int D>
struct FlashCfg {
  static constexpr int DP = round_up16(D);  // q.k depth, padded
  static constexpr int LD = tile_ld(D);
  static constexpr size_t bytes = sizeof(bf16) * LD * (kFlashBQ + 4 * kFlashBK);
};

template <int D>
__global__ void __launch_bounds__(kFlashWarps * 32)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     float* __restrict__ lse, int N, int M, int H, float scale_log2) {
  using C = FlashCfg<D>;
  constexpr int DP = C::DP, BK = kFlashBK, LD = C::LD;
  constexpr int KS = DP / 16, NT = BK / 8, VT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [BQ][LD]
  bf16* Ks = Qs + kFlashBQ * LD;             // [2][BK][LD]
  bf16* Vs = Ks + 2 * BK * LD;               // [2][BK][LD]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kFlashBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long row = static_cast<long>(H) * D;
  const bf16* kb = k + static_cast<long>(b) * M * row + h * D;
  const bf16* vb = v + static_cast<long>(b) * M * row + h * D;

  auto issue = [&](int tile) {
    const int k0 = tile * BK, valid = min(BK, M - k0);
    const int buf = tile & 1;
    load_tile_async<DP / 8>(Ks + buf * BK * LD, LD, kb + k0 * row, row, BK, valid, D);
    load_tile_async<D / 8>(Vs + buf * BK * LD, LD, vb + k0 * row, row, BK, valid, D);
  };
  load_tile_async<DP / 8>(Qs, LD, q + (static_cast<long>(b) * N + q0) * row + h * D, row,
                          kFlashBQ, min(kFlashBQ, N - q0), D);
  issue(0);
  cp_async_commit();

  cp_async_wait_all();
  __syncthreads();
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) load_a(qf[ks], Qs + warp * 16 * LD, LD, 16 * ks, lane);
  float o[VT][4];
#pragma unroll
  for (int j = 0; j < VT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_r[2] = {-CUDART_INF_F, -CUDART_INF_F}, l_r[2] = {0.f, 0.f};

  const int tiles = (M + BK - 1) / BK;
  for (int it = 0; it < tiles; ++it) {
    cp_async_wait_all();
    __syncthreads();  // tile `it` landed; every warp is done with the other buffer
    if (it + 1 < tiles) {
      issue(it + 1);
      cp_async_commit();
    }
    float s[NT][4];
    warp_scores<KS, NT>(s, qf, Ks + (it & 1) * BK * LD, LD, lane);
    scale_mask<NT>(s, scale_log2, it * BK, M, lane);

    // online softmax: rows g (e = 0, 1) and g + 8 (e = 2, 3) of the warp
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int n = 0; n < NT; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      const float m_new = fmaxf(m_r[r], quad_max(mx));  // finite: the tile has a valid key
      alpha[r] = exp2f(m_r[r] - m_new);                 // 0 on the first tile
      m_r[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        s[n][2 * r] = exp2f(s[n][2 * r] - m_new);
        s[n][2 * r + 1] = exp2f(s[n][2 * r + 1] - m_new);
        sum += s[n][2 * r] + s[n][2 * r + 1];
      }
      l_r[r] = l_r[r] * alpha[r] + sum;  // this lane's columns; the quad sums at the end
    }
#pragma unroll
    for (int j = 0; j < VT; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
    warp_pv<BK / 16, VT>(o, s, Vs + (it & 1) * BK * LD, LD, lane);
  }

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qr = q0 + warp * 16 + g + 8 * r;
    const float l = quad_sum(l_r[r]);  // every lane of the warp takes part
    if (qr >= N) continue;
    if (lse != nullptr && t == 0) lse[(static_cast<long>(b) * H + h) * N + qr] = m_r[r] + log2f(l);
    const float inv = 1.0f / l;
    bf16* dst = out + (static_cast<long>(b) * N + qr) * row + h * D + 2 * t;
#pragma unroll
    for (int j = 0; j < VT; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          pack_bf16(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
  }
}

template <int D>
static int launch_flash(const void* q, const void* k, const void* v, void* out, void* lse,
                        int B, int N, int M, int H, float scale, cudaStream_t stream) {
  using C = FlashCfg<D>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + kFlashBQ - 1) / kFlashBQ, H, B);
  flash_fwd_kernel<D><<<grid, kFlashWarps * 32, C::bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), static_cast<float*>(lse), N, M, H,
      scale * kLog2e);
  return (int)cudaGetLastError();
}

// di[b, h, n] = sum_d o[b,n,h,d] * dout[b,n,h,d] in fp32, one thread per row
__global__ void flash_di_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                                float* __restrict__ di, int N, int H, int D, long rows) {
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;  // (b, n, h)
  if (i >= rows) return;
  const bf16* a = o + i * D;
  const bf16* c = dout + i * D;
  float s = 0.f;
  for (int d = 0; d < D; ++d) s += __bfloat162float(a[d]) * __bfloat162float(c[d]);
  const long b = i / (static_cast<long>(N) * H);
  const long n = (i / H) % N, h = i % H;
  di[(b * H + h) * N + n] = s;
}

template <int D>
static int launch_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                            const void* dout, const void* lse, void* di, void* dq, void* dk,
                            void* dv, int B, int N, int M, int H, float scale,
                            cudaStream_t stream) {
  const long rows = static_cast<long>(B) * N * H;
  flash_di_kernel<<<(unsigned)((rows + 255) / 256), 256, 0, stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), static_cast<float*>(di), N,
      H, D, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_attn_bwd<D>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                            static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
                            static_cast<const float*>(lse), static_cast<const float*>(di),
                            static_cast<bf16*>(dq), static_cast<bf16*>(dk),
                            static_cast<bf16*>(dv), B, N, M, H, scale, stream);
}

constexpr int kWideD = 512;
constexpr int kWideWarps = 8;
constexpr int kWideBQ = 64;  // 4 row groups of 16
constexpr int kWideBK = 32;  // 2 key halves of 16
constexpr int kWideLD = tile_ld(kWideD);
constexpr int kWideLDP = tile_ld(kWideBK);
constexpr size_t kWideBytes =
    sizeof(bf16) * (kWideLD * (kWideBQ + 4 * kWideBK) + kWideLDP * kWideBQ) +
    sizeof(float) * 4 * kWideBQ;

__global__ void __launch_bounds__(kWideWarps * 32)
    flash_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ out, int N, int M,
                      int H, float scale_log2) {
  constexpr int D = kWideD, LD = kWideLD, LDP = kWideLDP, BK = kWideBK;
  constexpr int KS = D / 16, VT = D / 2 / 8;  // q.k depth steps; value tiles per warp
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);                // [BQ][LD]
  bf16* Ks = Qs + kWideBQ * LD;                            // [2][BK][LD]
  bf16* Vs = Ks + 2 * BK * LD;                             // [2][BK][LD]
  bf16* Ps = Vs + 2 * BK * LD;                             // [BQ][LDP]
  float* Red = reinterpret_cast<float*>(Ps + kWideBQ * LDP);  // [2 halves][BQ]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kWideBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp & 3, half = warp >> 2;  // row group; key half and value-column half
  const int r0 = rg * 16 + g;                 // this lane's rows r0, r0 + 8 of the tile
  const long row = static_cast<long>(H) * D;
  const bf16* kb = k + static_cast<long>(b) * M * row + h * D;
  const bf16* vb = v + static_cast<long>(b) * M * row + h * D;

  auto issue = [&](int tile) {
    const int k0 = tile * BK, valid = min(BK, M - k0);
    const int buf = tile & 1;
    load_tile_async<D / 8>(Ks + buf * BK * LD, LD, kb + k0 * row, row, BK, valid, D);
    load_tile_async<D / 8>(Vs + buf * BK * LD, LD, vb + k0 * row, row, BK, valid, D);
  };
  load_tile_async<D / 8>(Qs, LD, q + (static_cast<long>(b) * N + q0) * row + h * D, row,
                         kWideBQ, min(kWideBQ, N - q0), D);
  issue(0);
  cp_async_commit();

  float o[VT][4];
#pragma unroll
  for (int j = 0; j < VT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_r[2] = {-CUDART_INF_F, -CUDART_INF_F}, l_r[2] = {0.f, 0.f};

  const int tiles = (M + BK - 1) / BK;
  for (int it = 0; it < tiles; ++it) {
    cp_async_wait_all();
    __syncthreads();  // tile landed; every warp is done with the other buffer, P and Red
    if (it + 1 < tiles) {
      issue(it + 1);
      cp_async_commit();
    }
    const bf16* kt = Ks + (it & 1) * BK * LD + half * 16 * LD;
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 4
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t a[4];
      load_a(a, Qs + rg * 16 * LD, LD, 16 * ks, lane);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        uint32_t bb[2];
        load_bt(bb, kt + 8 * n * LD, LD, 16 * ks, lane);
        mma_bf16(s[n], a, bb);
      }
    }
    scale_mask<2>(s, scale_log2, it * BK + half * 16, M, lane);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mx = quad_max(fmaxf(fmaxf(s[0][2 * r], s[0][2 * r + 1]),
                                      fmaxf(s[1][2 * r], s[1][2 * r + 1])));
      if (t == 0) Red[half * kWideBQ + r0 + 8 * r] = mx;  // -inf if all masked
    }
    __syncthreads();
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rr = r0 + 8 * r;
      const float m_new = fmaxf(m_r[r], fmaxf(Red[rr], Red[kWideBQ + rr]));  // finite
      alpha[r] = exp2f(m_r[r] - m_new);
      m_r[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const float p0 = exp2f(s[n][2 * r] - m_new), p1 = exp2f(s[n][2 * r + 1] - m_new);
        sum += p0 + p1;
        *reinterpret_cast<uint32_t*>(Ps + rr * LDP + half * 16 + 8 * n + 2 * t) =
            pack_bf16(p0, p1);
      }
      l_r[r] = l_r[r] * alpha[r] + sum;  // this lane's keys of this half
    }
#pragma unroll
    for (int j = 0; j < VT; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
    __syncthreads();  // p of both key halves written
    const bf16* vt = Vs + (it & 1) * BK * LD + half * (D / 2);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      load_a(a, Ps + rg * 16 * LDP, LDP, 16 * kk, lane);
#pragma unroll
      for (int j = 0; j < VT; ++j) {
        uint32_t bb[2];
        load_b(bb, vt + 16 * kk * LD, LD, 8 * j, lane);
        mma_bf16(o[j], a, bb);
      }
    }
  }

  // the row sum over both key halves
  float* Lsum = Red + 2 * kWideBQ;  // [2 halves][BQ]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = quad_sum(l_r[r]);
    if (t == 0) Lsum[half * kWideBQ + r0 + 8 * r] = l;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = r0 + 8 * r, qr = q0 + rr;
    if (qr >= N) continue;
    const float inv = 1.0f / (Lsum[rr] + Lsum[kWideBQ + rr]);
    bf16* dst = out + (static_cast<long>(b) * N + qr) * row + h * D + half * (D / 2) + 2 * t;
#pragma unroll
    for (int j = 0; j < VT; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          pack_bf16(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
  }
}

static int launch_wide(const void* q, const void* k, const void* v, void* out, int B, int N,
                       int M, int H, float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kWideBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + kWideBQ - 1) / kWideBQ, H, B);
  flash_wide_kernel<<<grid, kWideWarps * 32, kWideBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), N, M, H, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace skp

// q [B,N,H,D], k/v [B,M,H,D], all bf16 -> out [B,N,H,D] bf16 and, when lse is
// not null, lse [B,H,N] fp32 (log2 domain); keys past M are masked. Returns a
// cudaError_t; -1 for an unsupported head dimension (d 512 writes no lse).
extern "C" int skp_flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                             int B, int N, int M, int H, int D, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 40: return skp::launch_flash<40>(q, k, v, out, lse, B, N, M, H, scale, s);
    case 80: return skp::launch_flash<80>(q, k, v, out, lse, B, N, M, H, scale, s);
    case 512: return lse ? -1 : skp::launch_wide(q, k, v, out, B, N, M, H, scale, s);
    default: return -1;
  }
}

// (q, k, v, o, dout, lse from skp_flash_fwd) -> dq, dk, dv in the inputs'
// layouts, all bf16; di [B,H,N] fp32 is scratch. -1 for a head dimension
// other than 40 or 80.
extern "C" int skp_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                             const void* dout, const void* lse, void* di, void* dq, void* dk,
                             void* dv, int B, int N, int M, int H, int D, float scale,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 40:
      return skp::launch_flash_bwd<40>(q, k, v, o, dout, lse, di, dq, dk, dv, B, N, M, H, scale, s);
    case 80:
      return skp::launch_flash_bwd<80>(q, k, v, o, dout, lse, di, dq, dk, dv, B, N, M, H, scale, s);
    default: return -1;
  }
}
