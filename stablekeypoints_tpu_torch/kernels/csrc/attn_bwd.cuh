// Attention backward shared by K3 (cross_attn.cu) and K4/K5 (flash.cu),
// sm_90a.
//
// Replaces the backward kernels of stablekeypoints_tpu/kernels/cross_attn.py
// (_cross_bwd, pallas_call at :174) and of JAX's stock Pallas TPU flash
// attention that kernels/flash.py calls (its dkv and dq kernels). With the
// per-row statistics of the forward softmax given,
//
//   lse2[r] = log2 sum_t exp2(s[r,t])      s = q.k^T * scale * log2(e)
//   di[r]   = sum_t p[r,t] * dp[r,t]       dp = dO . v^T
//
// both kernels recompute p = exp2(s - lse2) per tile and
//
//   dsim = p * (dp - di) * scale, rounded to bf16
//   dq   = dsim . k        dk = dsim^T . q        dv = bf16(p)^T . dO
//
// with fp32 accumulation, as the TPU kernels round. The TPU kernels carried
// dk and dv across a sequential grid axis; on Hopper blocks run in no
// order, so the work splits as in FlashAttention-2:
//   dkdv: one block of 4 warps per (b, h, 64 keys), 16 keys per warp. The
//         block walks every query tile with the keys as the rows of the
//         products (s^T = k.q^T, dp^T = v.dO^T), so dk and dv accumulate in
//         registers in query order (deterministic, no atomics) and are
//         written once.
//   dq:   one block of 4 warps per (b, h, 64 query rows), walking the key
//         tiles; dq accumulates in registers.
// Query and key tiles stream through cp.async double buffers. Keys >= M and
// query rows >= N are masked to p = 0. Head dims that are not multiples of
// 16 (40) are zero-padded in shared memory for the q.k and dO.v products.
//
// Bound: operations (5 products of 2*N*M*D FLOP; s and dp are computed in
// both kernels, 7 in all).
#pragma once

#include "common.cuh"

namespace skp {

constexpr int kBwdWarps = 4;
constexpr int kBwdBK = 16 * kBwdWarps;  // keys per dkdv block, 16 per warp
constexpr int kBwdBQ = 16 * kBwdWarps;  // query rows per dq block and per tile

template <int D>
struct BwdCfg {
  static constexpr int DP = round_up16(D);
  static constexpr int LD = tile_ld(D);
  // dkdv: K, V [BK][LD]; Q, dO [2][BQ][LD]; lse2, di [2][BQ]
  static constexpr size_t dkdv_bytes =
      sizeof(bf16) * LD * (2 * kBwdBK + 4 * kBwdBQ) + sizeof(float) * 4 * kBwdBQ;
  // dq: Q, dO [BQ][LD]; K, V [2][BK][LD]
  static constexpr size_t dq_bytes = sizeof(bf16) * LD * (2 * kBwdBQ + 4 * kBwdBK);
};

// q, dout [B,N,H,D]; k, v [B,M,H,D]; lse2, di [B,H,N] -> dk, dv [B,M,H,D]
template <int D>
__global__ void __launch_bounds__(kBwdWarps * 32)
    attn_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse2, const float* __restrict__ di,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int N, int M, int H,
                         float scale) {
  using C = BwdCfg<D>;
  constexpr int DP = C::DP, LD = C::LD, KS = DP / 16, NT = kBwdBQ / 8, VT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // [BK][LD]
  bf16* Vs = Ks + kBwdBK * LD;               // [BK][LD]
  bf16* Qs = Vs + kBwdBK * LD;               // [2][BQ][LD]
  bf16* Os = Qs + 2 * kBwdBQ * LD;           // [2][BQ][LD] dO
  float* Ls = reinterpret_cast<float*>(Os + 2 * kBwdBQ * LD);  // [2][BQ]
  float* Ds = Ls + 2 * kBwdBQ;                                  // [2][BQ]

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kBwdBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const float scale_log2 = scale * kLog2e;
  const long row = static_cast<long>(H) * D;
  const long kv_off = (static_cast<long>(b) * M + k0) * row + h * D;
  const long qo_off = static_cast<long>(b) * N * row + h * D;
  const float* lse_bh = lse2 + (static_cast<long>(b) * H + h) * N;
  const float* di_bh = di + (static_cast<long>(b) * H + h) * N;

  load_tile_async<DP / 8>(Ks, LD, k + kv_off, row, kBwdBK, min(kBwdBK, M - k0), D);
  load_tile_async<DP / 8>(Vs, LD, v + kv_off, row, kBwdBK, min(kBwdBK, M - k0), D);
  auto issue = [&](int tile) {
    const int q0 = tile * kBwdBQ, buf = tile & 1, valid = min(kBwdBQ, N - q0);
    load_tile_async<DP / 8>(Qs + buf * kBwdBQ * LD, LD, q + qo_off + q0 * row, row, kBwdBQ,
                            valid, D);
    load_tile_async<DP / 8>(Os + buf * kBwdBQ * LD, LD, dout + qo_off + q0 * row, row,
                            kBwdBQ, valid, D);
    for (int i = threadIdx.x; i < kBwdBQ; i += blockDim.x) {
      Ls[buf * kBwdBQ + i] = i < valid ? lse_bh[q0 + i] : 0.f;
      Ds[buf * kBwdBQ + i] = i < valid ? di_bh[q0 + i] : 0.f;
    }
  };
  issue(0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // this warp's 16 keys as the rows (A operands) of s^T and dp^T
  uint32_t kf[KS][4], vf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    load_a(kf[ks], Ks + warp * 16 * LD, LD, 16 * ks, lane);
    load_a(vf[ks], Vs + warp * 16 * LD, LD, 16 * ks, lane);
  }
  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  float dk_acc[VT][4], dv_acc[VT][4];
#pragma unroll
  for (int j = 0; j < VT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  const int tiles = (N + kBwdBQ - 1) / kBwdBQ;
  for (int it = 0; it < tiles; ++it) {
    cp_async_wait_all();
    __syncthreads();  // tile `it` landed; every warp is done with the other buffer
    if (it + 1 < tiles) {
      issue(it + 1);
      cp_async_commit();
    }
    const int buf = it & 1, q0 = it * kBwdBQ;
    const bf16* qt = Qs + buf * kBwdBQ * LD;
    const bf16* ot = Os + buf * kBwdBQ * LD;
    const float* lt = Ls + buf * kBwdBQ;
    const float* dt = Ds + buf * kBwdBQ;
    float s[NT][4], dp[NT][4];
    warp_scores<KS, NT>(s, kf, qt, LD, lane);   // s^T:  keys x queries
    warp_scores<KS, NT>(dp, vf, ot, LD, lane);  // dp^T: keys x queries
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * n + 2 * t + (e & 1);
        const bool ok = key[e >> 1] < M && q0 + col < N;
        const float p = ok ? exp2f(s[n][e] * scale_log2 - lt[col]) : 0.f;
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - dt[col]) * scale;
      }
    warp_pv<kBwdBQ / 16, VT>(dv_acc, s, ot, LD, lane);   // dv += bf16(p)^T . dO
    warp_pv<kBwdBQ / 16, VT>(dk_acc, dp, qt, LD, lane);  // dk += bf16(dsim)^T . q
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= M) continue;
    const long off = (static_cast<long>(b) * M + key[r]) * row + h * D + 2 * t;
#pragma unroll
    for (int j = 0; j < VT; ++j) {
      *reinterpret_cast<uint32_t*>(dk + off + 8 * j) =
          pack_bf16(dk_acc[j][2 * r], dk_acc[j][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + 8 * j) =
          pack_bf16(dv_acc[j][2 * r], dv_acc[j][2 * r + 1]);
    }
  }
}

// q, dout [B,N,H,D]; k, v [B,M,H,D]; lse2, di [B,H,N] -> dq [B,N,H,D]
template <int D>
__global__ void __launch_bounds__(kBwdWarps * 32)
    attn_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const float* __restrict__ lse2, const float* __restrict__ di,
                       bf16* __restrict__ dq, int N, int M, int H, float scale) {
  using C = BwdCfg<D>;
  constexpr int DP = C::DP, LD = C::LD, KS = DP / 16, NT = kBwdBK / 8, VT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [BQ][LD]
  bf16* Os = Qs + kBwdBQ * LD;               // [BQ][LD] dO
  bf16* Ks = Os + kBwdBQ * LD;               // [2][BK][LD]
  bf16* Vs = Ks + 2 * kBwdBK * LD;           // [2][BK][LD]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBwdBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const float scale_log2 = scale * kLog2e;
  const long row = static_cast<long>(H) * D;
  const long qo_off = (static_cast<long>(b) * N + q0) * row + h * D;
  const bf16* kb = k + static_cast<long>(b) * M * row + h * D;
  const bf16* vb = v + static_cast<long>(b) * M * row + h * D;

  auto issue = [&](int tile) {
    const int k0 = tile * kBwdBK, buf = tile & 1, valid = min(kBwdBK, M - k0);
    load_tile_async<DP / 8>(Ks + buf * kBwdBK * LD, LD, kb + k0 * row, row, kBwdBK, valid, D);
    load_tile_async<DP / 8>(Vs + buf * kBwdBK * LD, LD, vb + k0 * row, row, kBwdBK, valid, D);
  };
  const int valid_q = min(kBwdBQ, N - q0);
  load_tile_async<DP / 8>(Qs, LD, q + qo_off, row, kBwdBQ, valid_q, D);
  load_tile_async<DP / 8>(Os, LD, dout + qo_off, row, kBwdBQ, valid_q, D);
  issue(0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  uint32_t qf[KS][4], of[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    load_a(qf[ks], Qs + warp * 16 * LD, LD, 16 * ks, lane);
    load_a(of[ks], Os + warp * 16 * LD, LD, 16 * ks, lane);
  }
  float lse_r[2], di_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qr = q0 + warp * 16 + g + 8 * r;
    const long idx = (static_cast<long>(b) * H + h) * N + qr;
    lse_r[r] = qr < N ? lse2[idx] : 0.f;
    di_r[r] = qr < N ? di[idx] : 0.f;
  }
  float dq_acc[VT][4];
#pragma unroll
  for (int j = 0; j < VT; ++j) dq_acc[j][0] = dq_acc[j][1] = dq_acc[j][2] = dq_acc[j][3] = 0.f;

  const int tiles = (M + kBwdBK - 1) / kBwdBK;
  for (int it = 0; it < tiles; ++it) {
    cp_async_wait_all();
    __syncthreads();  // tile `it` landed; every warp is done with the other buffer
    if (it + 1 < tiles) {
      issue(it + 1);
      cp_async_commit();
    }
    const bf16* kt = Ks + (it & 1) * kBwdBK * LD;
    const bf16* vt = Vs + (it & 1) * kBwdBK * LD;
    float s[NT][4], dp[NT][4];
    warp_scores<KS, NT>(s, qf, kt, LD, lane);
    scale_mask<NT>(s, scale_log2, it * kBwdBK, M, lane);  // keys >= M: p = 0
    warp_scores<KS, NT>(dp, of, vt, LD, lane);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - lse_r[e >> 1]);
        s[n][e] = p * (dp[n][e] - di_r[e >> 1]) * scale;
      }
    warp_pv<kBwdBK / 16, VT>(dq_acc, s, kt, LD, lane);  // dq += bf16(dsim) . k
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qr = q0 + warp * 16 + g + 8 * r;
    if (qr >= N) continue;
    bf16* dst = dq + (static_cast<long>(b) * N + qr) * row + h * D + 2 * t;
#pragma unroll
    for (int j = 0; j < VT; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          pack_bf16(dq_acc[j][2 * r], dq_acc[j][2 * r + 1]);
  }
}

// the dkdv and dq kernels after the caller has written lse2 and di
template <int D>
static int launch_attn_bwd(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
                           const float* lse2, const float* di, bf16* dq, bf16* dk, bf16* dv,
                           int B, int N, int M, int H, float scale, cudaStream_t stream) {
  using C = BwdCfg<D>;
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::dkdv_bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attn_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)C::dq_bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid_kv((M + kBwdBK - 1) / kBwdBK, H, B);
  attn_bwd_dkdv_kernel<D><<<grid_kv, kBwdWarps * 32, C::dkdv_bytes, stream>>>(
      q, k, v, dout, lse2, di, dk, dv, N, M, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid_q((N + kBwdBQ - 1) / kBwdBQ, H, B);
  attn_bwd_dq_kernel<D><<<grid_q, kBwdWarps * 32, C::dq_bytes, stream>>>(
      q, k, v, dout, lse2, di, dq, N, M, H, scale);
  return (int)cudaGetLastError();
}

}  // namespace skp
