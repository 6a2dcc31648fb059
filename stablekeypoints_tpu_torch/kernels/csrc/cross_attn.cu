// K3: KV-resident cross-attention over the learned tokens, forward and
// backward (sm_90a).
//
// Replaces stablekeypoints_tpu/kernels/cross_attn.py cross_attention_resident
// -> _cross_fwd (pallas_call at :152).
//
//   p   = softmax_t(q . k^T * scale)   fp32, columns t >= T masked to -inf
//   out = bf16( bf16(p) . v )          fp32 accumulation
//
// All T <= 512 keys and values of one (b, h) fit shared memory as bf16,
// so a block of 8 warps loads them once and walks several 128-row query
// tiles, 16 rows per warp. p must be normalised before it is rounded to
// bf16 (the TPU kernel and the einsum path cast the softmax to v's dtype),
// so each warp makes two passes over the resident keys: the row max and
// sum, then p = exp(s - max) / sum and p.v. q.k and p.v run as mma.sync
// m16n8k16 (bf16 in, fp32 out).
//
// Backward (replaces _cross_bwd, pallas_call at :174): the TPU kernel keeps
// no residual and recomputes the softmax, so cross_stats_kernel first
// recomputes each row's log-sum-exp and di = sum_t p * dp (fp32, p from the
// fp32 logits, dp = dO . v^T) with the keys and values resident as in the
// forward; then the dkdv and dq kernels of attn_bwd.cuh run.
//
// Bound: operations (q.k twice and p.v at 512 padded tokens; q, k, v and
// out are read or written once). Backward: 5 products of 2*N*T*D FLOP.
#include "attn_bwd.cuh"

namespace skp {

constexpr int kCrossWarps = 8;
constexpr int kCrossBQ = 16 * kCrossWarps;
constexpr int kCrossTiles = 4;  // query tiles per block
constexpr int kCrossTP = 512;   // resident (padded) tokens
constexpr int kCrossBK = 64;    // keys per score tile

template <int D>
struct CrossCfg {
  static constexpr int DP = round_up16(D);
  static constexpr int LD = tile_ld(D);
  static constexpr size_t bytes = sizeof(bf16) * LD * (kCrossBQ + 2 * kCrossTP);
};

template <int D>
__global__ void __launch_bounds__(kCrossWarps * 32)
    cross_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out, int N, int T,
                     int H, float scale_log2) {
  using C = CrossCfg<D>;
  constexpr int DP = C::DP, LD = C::LD, KS = DP / 16, NT = kCrossBK / 8, VT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [BQ][LD]
  bf16* Ks = Qs + kCrossBQ * LD;             // [512][LD]
  bf16* Vs = Ks + kCrossTP * LD;             // [512][LD]

  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long row = static_cast<long>(H) * D;
  const long kv_off = (static_cast<long>(b) * T * H + h) * D;
  load_tile_async<DP / 8>(Ks, LD, k + kv_off, row, kCrossTP, T, D);
  load_tile_async<D / 8>(Vs, LD, v + kv_off, row, kCrossTP, T, D);
  const int key_tiles = (T + kCrossBK - 1) / kCrossBK;
  const bf16* qw = Qs + warp * 16 * LD;
  const int g = lane >> 2, t = lane & 3;

  for (int tile = 0; tile < kCrossTiles; ++tile) {
    const int q0 = (blockIdx.x * kCrossTiles + tile) * kCrossBQ;
    if (q0 >= N) break;
    __syncthreads();  // every warp is done with the previous query tile
    load_tile_async<DP / 8>(Qs, LD, q + (static_cast<long>(b) * N + q0) * row + h * D, row,
                            kCrossBQ, min(kCrossBQ, N - q0), D);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    uint32_t qf[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) load_a(qf[ks], qw, LD, 16 * ks, lane);

    // pass 1: row max and sum (this lane's columns; the quad sums after)
    float m_r[2] = {-CUDART_INF_F, -CUDART_INF_F}, l_r[2] = {0.f, 0.f};
    for (int kt = 0; kt < key_tiles; ++kt) {
      float s[NT][4];
      warp_scores<KS, NT>(s, qf, Ks + kt * kCrossBK * LD, LD, lane);
      scale_mask<NT>(s, scale_log2, kt * kCrossBK, T, lane);
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
    }
    const float inv[2] = {1.0f / quad_sum(l_r[0]), 1.0f / quad_sum(l_r[1])};

    // pass 2: normalised p, rounded to bf16, times v
    float o[VT][4];
#pragma unroll
    for (int j = 0; j < VT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    for (int kt = 0; kt < key_tiles; ++kt) {
      float s[NT][4];
      warp_scores<KS, NT>(s, qf, Ks + kt * kCrossBK * LD, LD, lane);
      scale_mask<NT>(s, scale_log2, kt * kCrossBK, T, lane);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = exp2f(s[n][e] - m_r[e >> 1]) * inv[e >> 1];
      warp_pv<kCrossBK / 16, VT>(o, s, Vs + kt * kCrossBK * LD, LD, lane);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qr = q0 + warp * 16 + g + 8 * r;
      if (qr >= N) continue;
      bf16* dst = out + (static_cast<long>(b) * N + qr) * row + h * D + 2 * t;
#pragma unroll
      for (int j = 0; j < VT; ++j)
        *reinterpret_cast<uint32_t*>(dst + 8 * j) = pack_bf16(o[j][2 * r], o[j][2 * r + 1]);
    }
  }
}

template <int D>
static int launch_cross(const void* q, const void* k, const void* v, void* out, int B,
                        int N, int T, int H, float scale, cudaStream_t stream) {
  const size_t smem = CrossCfg<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      cross_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int per_block = kCrossBQ * kCrossTiles;
  dim3 grid((N + per_block - 1) / per_block, H, B);
  cross_fwd_kernel<D><<<grid, kCrossWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), N, T, H, scale * kLog2e);
  return (int)cudaGetLastError();
}

// lse2[b,h,n] (log2 domain) and di[b,h,n] = sum_t p * (dO . v^T), fp32
template <int D>
__global__ void __launch_bounds__(kCrossWarps * 32)
    cross_stats_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       float* __restrict__ lse2, float* __restrict__ di, int N, int T, int H,
                       float scale_log2) {
  using C = CrossCfg<D>;
  constexpr int DP = C::DP, LD = C::LD, KS = DP / 16, NT = kCrossBK / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [BQ][LD]
  bf16* Os = Qs + kCrossBQ * LD;             // [BQ][LD] dO
  bf16* Ks = Os + kCrossBQ * LD;             // [512][LD]
  bf16* Vs = Ks + kCrossTP * LD;             // [512][LD], zero-padded to DP columns

  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const long row = static_cast<long>(H) * D;
  const long kv_off = (static_cast<long>(b) * T * H + h) * D;
  load_tile_async<DP / 8>(Ks, LD, k + kv_off, row, kCrossTP, T, D);
  load_tile_async<DP / 8>(Vs, LD, v + kv_off, row, kCrossTP, T, D);
  const int key_tiles = (T + kCrossBK - 1) / kCrossBK;

  for (int tile = 0; tile < kCrossTiles; ++tile) {
    const int q0 = (blockIdx.x * kCrossTiles + tile) * kCrossBQ;
    if (q0 >= N) break;
    __syncthreads();  // every warp is done with the previous query tile
    const long q_off = (static_cast<long>(b) * N + q0) * row + h * D;
    load_tile_async<DP / 8>(Qs, LD, q + q_off, row, kCrossBQ, min(kCrossBQ, N - q0), D);
    load_tile_async<DP / 8>(Os, LD, dout + q_off, row, kCrossBQ, min(kCrossBQ, N - q0), D);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    uint32_t qf[KS][4], of[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      load_a(qf[ks], Qs + warp * 16 * LD, LD, 16 * ks, lane);
      load_a(of[ks], Os + warp * 16 * LD, LD, 16 * ks, lane);
    }

    // pass 1: row max and sum -> log-sum-exp
    float m_r[2] = {-CUDART_INF_F, -CUDART_INF_F}, l_r[2] = {0.f, 0.f};
    for (int kt = 0; kt < key_tiles; ++kt) {
      float s[NT][4];
      warp_scores<KS, NT>(s, qf, Ks + kt * kCrossBK * LD, LD, lane);
      scale_mask<NT>(s, scale_log2, kt * kCrossBK, T, lane);
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
    }
    const float lse[2] = {m_r[0] + log2f(quad_sum(l_r[0])), m_r[1] + log2f(quad_sum(l_r[1]))};

    // pass 2: di = sum_t p * dp
    float acc[2] = {0.f, 0.f};
    for (int kt = 0; kt < key_tiles; ++kt) {
      float s[NT][4], dp[NT][4];
      warp_scores<KS, NT>(s, qf, Ks + kt * kCrossBK * LD, LD, lane);
      scale_mask<NT>(s, scale_log2, kt * kCrossBK, T, lane);
      warp_scores<KS, NT>(dp, of, Vs + kt * kCrossBK * LD, LD, lane);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e >> 1] += exp2f(s[n][e] - lse[e >> 1]) * dp[n][e];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float d = quad_sum(acc[r]);
      const int qr = q0 + warp * 16 + g + 8 * r;
      if (qr < N && t == 0) {
        const long idx = (static_cast<long>(b) * H + h) * N + qr;
        lse2[idx] = lse[r];
        di[idx] = d;
      }
    }
  }
}

template <int D>
static int launch_cross_bwd(const void* q, const void* k, const void* v, const void* dout,
                            void* lse2, void* di, void* dq, void* dk, void* dv, int B, int N,
                            int T, int H, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * CrossCfg<D>::LD * (2 * kCrossBQ + 2 * kCrossTP);
  cudaError_t err = cudaFuncSetAttribute(
      cross_stats_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int per_block = kCrossBQ * kCrossTiles;
  dim3 grid((N + per_block - 1) / per_block, H, B);
  cross_stats_kernel<D><<<grid, kCrossWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<float*>(lse2), static_cast<float*>(di), N, T,
      H, scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_attn_bwd<D>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                            static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
                            static_cast<const float*>(lse2), static_cast<const float*>(di),
                            static_cast<bf16*>(dq), static_cast<bf16*>(dk),
                            static_cast<bf16*>(dv), B, N, T, H, scale, stream);
}

}  // namespace skp

// q [B,N,H,D], k/v [B,T,H,D] (T <= 512), all bf16 -> out [B,N,H,D] bf16.
// Returns a cudaError_t; -1 for an unsupported head dimension.
extern "C" int skp_cross_fwd(const void* q, const void* k, const void* v, void* out, int B,
                             int N, int T, int H, int D, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 40: return skp::launch_cross<40>(q, k, v, out, B, N, T, H, scale, s);
    case 80: return skp::launch_cross<80>(q, k, v, out, B, N, T, H, scale, s);
    default: return -1;
  }
}

// (q, k, v, dout) -> dq, dk, dv in the inputs' layouts, all bf16; lse2 and
// di [B,H,N] fp32 are scratch. -1 for an unsupported head dimension.
extern "C" int skp_cross_bwd(const void* q, const void* k, const void* v, const void* dout,
                             void* lse2, void* di, void* dq, void* dk, void* dv, int B, int N,
                             int T, int H, int D, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 40:
      return skp::launch_cross_bwd<40>(q, k, v, dout, lse2, di, dq, dk, dv, B, N, T, H, scale, s);
    case 80:
      return skp::launch_cross_bwd<80>(q, k, v, dout, lse2, di, dq, dk, dv, B, N, T, H, scale, s);
    default: return -1;
  }
}
