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
//
// Backward (replaces _capture_fused_bwd, pallas_call at :367; kernel body
// _bwd_kernel_fused). With g the cotangent of the maps [B, O*P, T] (fp32),
// per head h:
//
//   p    = softmax_t(q . k^T * scale)   c[r] = sum_t g[r,t]/H * p[r,t]
//   dsim = (g/H * p - p * c) * scale, rounded to bf16
//   dq   = dsim . k (fp32)              dt[b,h,o] = ww^T . bf16(dq[o*P ..])
//   dk   = sum over all rows r of dsim^T . q   (fp32, then bf16)
//
// The TPU kernel summed dk across a sequential grid axis; here two kernels
// split the work so that nothing crosses blocks:
//   rows: one block of 8 warps per (b, output row o), all 8 heads, as the
//         forward. Pass 1 takes each head's row max and sum; pass 2 runs
//         tile-major and reads each g tile once for all heads, summing c per
//         head in shared memory in a fixed order; pass 3 runs head-major:
//         dsim, dq in registers, then dq (bf16) goes to shared memory and
//         the block forms dt = ww^T . dq for its row, so dq never reaches
//         device memory. Pass 3 reads g again per head (8 x 0.26 GB at
//         batch 8, from L2 while the block's row stays resident). The
//         row statistics (lse, c) go to device memory for the second kernel.
//   keys: one block of 4 warps per (h, 64 keys, b), 16 keys per warp,
//         walking every output row o: q (bf16(ww . tt)) is rebuilt in
//         shared memory, s^T = k . q^T with the keys as rows, dsim^T from
//         the stored lse and c and a g tile staged in shared memory, and
//         dk += dsim^T . q accumulates in registers in row order
//         (deterministic, no atomics).
// The backward takes P <= 128 (one block per output row) and is bound by
// operations too (~5 products of 2*N*T*D per head against g read once).
//
// K2, the unfused capture (replaces capture_attention -> _capture_core,
// pallas_calls at :252 forward and :284 backward), is the same three
// kernels with the queries given: q [B, H, N, D] head-major, already
// upsampled. Each kernel is a template on where a query tile comes from
// (kQ): K1 builds it from tt and ww, K2 reads it. K2 runs with one "output
// row" of N columns: the forward and the rows kernel take 128-query blocks
// that need not cover whole rows (a 96^2 grid is 72 blocks of 128), each
// warp reads its 16 query rows of a head straight into A fragments; the
// rows kernel writes dq [B, H, N, D] from registers; the keys kernel walks
// the 128-row blocks with the q block staged in shared memory (cp.async).
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

// Two blocks per SM: at d 160 the register cap of 128 spills a few bytes,
// and the kernel still ran faster on an H100 than at one block per SM
// with 167 registers. kQ: K2 (tt is q [B, H, P, D] with O = 1, ww unused).
template <int D, bool kQ>
__global__ void __launch_bounds__(kCapWarps * 32, 2)
    capture_fwd_kernel(const bf16* __restrict__ tt, const bf16* __restrict__ ww,
                       const bf16* __restrict__ k, float* __restrict__ out, int H, int O,
                       int X, int P, int T, float scale_log2) {
  using C = CaptureCfg<D>;
  constexpr int LD = C::LD, KS = D / 16, NT = kCapBK / 8;
  constexpr int XS = kCapMaxX / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int xsteps = kQ ? 0 : (X + 15) / 16, XP = 16 * xsteps;
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
  if constexpr (!kQ)
    for (int h = 0; h < H; ++h)
      load_tile_async<D / 8>(Ts + h * XP * LD, LD,
                             tt + ((static_cast<long>(b) * H + h) * O + o) * X * D, D, XP, X, D);
  issue(0);
  cp_async_commit();

  // A fragments of ww for this warp's 16 rows (p >= P and x >= X are zero)
  uint32_t wf[XS][4];
  if constexpr (!kQ) ww_frags(wf, ww, p0 + warp * 16, P, X, lane);

  // query fragments of head h: K1 bf16(ww . tt[b,h,o]) with fp32
  // accumulation, K2 the rows of q[b,h]
  uint32_t qf[KS][4];
  auto build_q = [&](int h) {
    if constexpr (kQ)
      q_frags<D>(qf, tt + (static_cast<long>(b) * H + h) * P * D, p0 + warp * 16, P, lane);
    else
      resize_frags<D>(qf, wf, Ts + h * XP * LD, LD, xsteps, lane);
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

template <int D, bool kQ>
static int launch_capture(const void* tt, const void* ww, const void* k, void* out, int B,
                          int H, int O, int X, int P, int T, float scale,
                          cudaStream_t stream) {
  if (X > kCapMaxX) return -1;
  const size_t smem = CaptureCfg<D>::bytes(H, kQ ? 0 : (X + 15) / 16 * 16);
  cudaError_t err = cudaFuncSetAttribute(
      capture_fwd_kernel<D, kQ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((P + kCapBQ - 1) / kCapBQ, O, B);
  capture_fwd_kernel<D, kQ><<<grid, kCapWarps * 32, smem, stream>>>(
      static_cast<const bf16*>(tt), static_cast<const bf16*>(ww),
      static_cast<const bf16*>(k), static_cast<float*>(out), H, O, X, P, T, scale * kLog2e);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// backward

template <int D>
struct CaptureBwdCfg {
  static constexpr int LD = tile_ld(D);
  static constexpr int GLD = kCapBK + 4;  // fp32 row stride of the keys kernel's g tile
  // rows: Ts [H][XP][LD], Ks [2][BK][LD], Dq [BQ][LD] bf16 (K1 only: Ts, Dq);
  // Lse, Cs [H][BQ] fp32
  static size_t rows_bytes(int H, int XP, bool kq) {
    return sizeof(bf16) * (H * XP * LD + 2 * kCapBK * LD + (kq ? 0 : kCapBQ * LD)) +
           sizeof(float) * 2 * H * kCapBQ;
  }
  // keys: Ks [BK][LD], Ts [2][XP][LD], Qs [BQ][LD] bf16; Gs [BQ][GLD], Ls, Cq [BQ] fp32
  static size_t keys_bytes(int XP) {
    return sizeof(bf16) * (kCapBK * LD + 2 * XP * LD + kCapBQ * LD) +
           sizeof(float) * (kCapBQ * GLD + 2 * kCapBQ);
  }
};

// kQ: K2 (tt is q [B, H, P, D] with O = 1, ww unused, dt receives dq [B, H, P, D])
template <int D, bool kQ>
__global__ void __launch_bounds__(kCapWarps * 32, 1)
    capture_bwd_rows_kernel(const bf16* __restrict__ tt, const bf16* __restrict__ ww,
                            const bf16* __restrict__ k, const float* __restrict__ gmap,
                            float* __restrict__ lse_out, float* __restrict__ c_out,
                            bf16* __restrict__ dt, int H, int O, int X, int P, int T,
                            float scale) {
  using C = CaptureBwdCfg<D>;
  constexpr int LD = C::LD, KS = D / 16, NT = kCapBK / 8, VT = D / 8;
  constexpr int XS = kCapMaxX / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int xsteps = kQ ? 0 : (X + 15) / 16, XP = 16 * xsteps;
  bf16* Ts = reinterpret_cast<bf16*>(smem);  // [H][XP][LD]
  bf16* Ks = Ts + H * XP * LD;               // [2][BK][LD]
  bf16* Dq = Ks + 2 * kCapBK * LD;           // [BQ][LD] bf16(dq) of one head (K1)
  float* Lse = reinterpret_cast<float*>(Dq + (kQ ? 0 : kCapBQ * LD));  // [H][BQ] log2 domain
  float* Cs = Lse + H * kCapBQ;                              // [H][BQ]

  const int b = blockIdx.z, o = blockIdx.y, p0 = blockIdx.x * kCapBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const float scale_log2 = scale * kLog2e, inv_h = 1.0f / static_cast<float>(H);
  const long krow = static_cast<long>(H) * D;
  const int key_tiles = (T + kCapBK - 1) / kCapBK;
  const int steps = H * key_tiles;  // (head, key tile) pairs per pass

  // passes 1 and 3 run head-major, pass 2 tile-major
  auto head_of = [&](int i) {
    const int j = i % steps;
    return i / steps == 1 ? j % H : j / key_tiles;
  };
  auto tile_of = [&](int i) {
    const int j = i % steps;
    return i / steps == 1 ? j / H : j % key_tiles;
  };
  auto issue = [&](int i) {
    const int h = head_of(i), k0 = tile_of(i) * kCapBK;
    load_tile_async<D / 8>(Ks + (i & 1) * kCapBK * LD, LD,
                           k + (static_cast<long>(b) * T + k0) * krow + h * D, krow, kCapBK,
                           min(kCapBK, T - k0), D);
  };
  if constexpr (!kQ)
    for (int h = 0; h < H; ++h)
      load_tile_async<D / 8>(Ts + h * XP * LD, LD,
                             tt + ((static_cast<long>(b) * H + h) * O + o) * X * D, D, XP, X, D);
  issue(0);
  cp_async_commit();
  for (int i = threadIdx.x; i < H * kCapBQ; i += blockDim.x) Cs[i] = 0.f;

  uint32_t wf[XS][4];
  if constexpr (!kQ) ww_frags(wf, ww, p0 + warp * 16, P, X, lane);
  uint32_t qf[KS][4];
  auto build_q = [&](int h) {
    if constexpr (kQ)
      q_frags<D>(qf, tt + (static_cast<long>(b) * H + h) * P * D, p0 + warp * 16, P, lane);
    else
      resize_frags<D>(qf, wf, Ts + h * XP * LD, LD, xsteps, lane);
  };

  const int rl = warp * 16 + g;  // this lane's rows rl, rl + 8 within the block
  const bool row_ok[2] = {p0 + rl < P, p0 + rl + 8 < P};
  const float* grow[2] = {gmap + ((static_cast<long>(b) * O + o) * P + p0 + rl) * T,
                          gmap + ((static_cast<long>(b) * O + o) * P + p0 + rl + 8) * T};
  auto g_at = [&](int r, int col) { return row_ok[r] && col < T ? grow[r][col] : 0.f; };

  float m_r[2] = {0.f, 0.f}, l_r[2] = {0.f, 0.f}, dq[VT][4];
  for (int i = 0; i < 3 * steps; ++i) {
    cp_async_wait_all();
    __syncthreads();  // step i's keys landed; every warp is done with the other buffer
    if (i + 1 < 3 * steps) {
      issue(i + 1);
      cp_async_commit();
    }
    const int pass = i / steps, h = head_of(i), kt = tile_of(i);
    const bf16* keys = Ks + (i & 1) * kCapBK * LD;
    float s[NT][4];

    if (pass == 0) {  // row max and sum of head h
      if (kt == 0) {
        build_q(h);
        m_r[0] = m_r[1] = -CUDART_INF_F;
        l_r[0] = l_r[1] = 0.f;
      }
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
          if (t == 0) Lse[h * kCapBQ + rl + 8 * r] = m_r[r] + log2f(l);
        }
        __syncwarp();  // each warp reads back only its own rows
      }
    } else if (pass == 1) {  // c = sum_t g/H * p, one g tile for every head
      build_q(h);
      warp_scores<KS, NT>(s, qf, keys, LD, lane);
      scale_mask<NT>(s, scale_log2, kt * kCapBK, T, lane);
      const float ls[2] = {Lse[h * kCapBQ + rl], Lse[h * kCapBQ + rl + 8]};
      float part[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = kt * kCapBK + 8 * n + 2 * t + (e & 1);
          part[e >> 1] += g_at(e >> 1, col) * inv_h * exp2f(s[n][e] - ls[e >> 1]);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float c = quad_sum(part[r]);
        if (t == 0) Cs[h * kCapBQ + rl + 8 * r] += c;
      }
      __syncwarp();
    } else {  // dsim, dq = dsim . k; after the last tile dq (K2) or dt = ww^T . dq (K1)
      if (kt == 0) {
        build_q(h);
#pragma unroll
        for (int j = 0; j < VT; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;
      }
      warp_scores<KS, NT>(s, qf, keys, LD, lane);
      scale_mask<NT>(s, scale_log2, kt * kCapBK, T, lane);
      const float ls[2] = {Lse[h * kCapBQ + rl], Lse[h * kCapBQ + rl + 8]};
      const float cs[2] = {Cs[h * kCapBQ + rl], Cs[h * kCapBQ + rl + 8]};
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, col = kt * kCapBK + 8 * n + 2 * t + (e & 1);
          const float p = exp2f(s[n][e] - ls[r]);
          s[n][e] = row_ok[r] ? (g_at(r, col) * inv_h * p - p * cs[r]) * scale : 0.f;
        }
      warp_pv<kCapBK / 16, VT>(dq, s, keys, LD, lane);
      if (kQ && kt == key_tiles - 1) {  // dq [b, h, rows] straight from registers
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (!row_ok[r]) continue;
          bf16* dst = dt + ((static_cast<long>(b) * H + h) * P + p0 + rl + 8 * r) * D + 2 * t;
#pragma unroll
          for (int j = 0; j < VT; ++j)
            *reinterpret_cast<uint32_t*>(dst + 8 * j) = pack_bf16(dq[j][2 * r], dq[j][2 * r + 1]);
        }
      } else if (kt == key_tiles - 1) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int j = 0; j < VT; ++j)
            *reinterpret_cast<uint32_t*>(Dq + (rl + 8 * r) * LD + 8 * j + 2 * t) =
                pack_bf16(dq[j][2 * r], dq[j][2 * r + 1]);
        __syncthreads();  // the block's 128 rows of bf16(dq) are in Dq
        // dt[b,h,o] [X, D] = ww^T [X, BQ] . Dq [BQ, D]: (x block, 8 columns) items
        const int items = xsteps * VT;
        for (int it = warp; it < items; it += kCapWarps) {
          const int xm = it / VT, j = it % VT;
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
          auto w = [&](int p, int x) {
            return (p0 + p < P && x < X) ? __bfloat162float(ww[(p0 + p) * X + x]) : 0.f;
          };
#pragma unroll
          for (int kk = 0; kk < kCapBQ / 16; ++kk) {
            const int x = 16 * xm + g, p = 16 * kk + 2 * t;
            const uint32_t a[4] = {pack_bf16(w(p, x), w(p + 1, x)),
                                   pack_bf16(w(p, x + 8), w(p + 1, x + 8)),
                                   pack_bf16(w(p + 8, x), w(p + 9, x)),
                                   pack_bf16(w(p + 8, x + 8), w(p + 9, x + 8))};
            uint32_t bb[2];
            load_b(bb, Dq + 16 * kk * LD, LD, 8 * j, lane);
            mma_bf16(acc, a, bb);
          }
          bf16* dst = dt + ((static_cast<long>(b) * H + h) * O + o) * X * D + 8 * j + 2 * t;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int x = 16 * xm + g + 8 * r;
            if (x < X)
              *reinterpret_cast<uint32_t*>(dst + static_cast<long>(x) * D) =
                  pack_bf16(acc[2 * r], acc[2 * r + 1]);
          }
        }
      }
    }
  }

  __syncthreads();
  for (int i = threadIdx.x; i < H * kCapBQ; i += blockDim.x) {
    const int h = i / kCapBQ, p = p0 + i % kCapBQ;
    if (p >= P) continue;
    const long idx = ((static_cast<long>(b) * H + h) * O + o) * P + p;
    lse_out[idx] = Lse[i];
    c_out[idx] = Cs[i];
  }
}

// Walks O blocks of P query rows, N rows in all per (b, h): K1 O output
// rows of P columns (N = O * P), K2 the 128-row blocks of q (P = 128).
template <int D, bool kQ>
__global__ void __launch_bounds__(4 * 32)
    capture_bwd_keys_kernel(const bf16* __restrict__ tt, const bf16* __restrict__ ww,
                            const bf16* __restrict__ k, const float* __restrict__ gmap,
                            const float* __restrict__ lse, const float* __restrict__ cvec,
                            bf16* __restrict__ dk, int H, int O, int X, int P, int N, int T,
                            float scale) {
  using C = CaptureBwdCfg<D>;
  constexpr int LD = C::LD, GLD = C::GLD, KS = D / 16, NT = 64 / 8, VT = D / 8;
  constexpr int XS = kCapMaxX / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int xsteps = kQ ? 0 : (X + 15) / 16, XP = 16 * xsteps;
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // [BK][LD] this block's keys
  bf16* Ts = Ks + kCapBK * LD;               // [2][XP][LD] tt[b, h, o]
  bf16* Qs = Ts + 2 * XP * LD;               // [BQ][LD] q of block o, bf16
  float* Gs = reinterpret_cast<float*>(Qs + kCapBQ * LD);  // [BQ][GLD] g[b, o*P + p, keys]
  float* Ls = Gs + kCapBQ * GLD;                            // [BQ] lse
  float* Cq = Ls + kCapBQ;                                  // [BQ] c

  const int h = blockIdx.x, k0 = blockIdx.y * kCapBK, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const float scale_log2 = scale * kLog2e, inv_h = 1.0f / static_cast<float>(H);
  const long krow = static_cast<long>(H) * D;
  const long bh = static_cast<long>(b) * H + h;

  auto issue = [&](int o) {
    if constexpr (kQ)  // block o of q[b, h], rows >= N zero
      load_tile_async<D / 8>(Qs, LD, tt + (bh * N + o * P) * D, D, kCapBQ, min(P, N - o * P), D);
    else
      load_tile_async<D / 8>(Ts + (o & 1) * XP * LD, LD, tt + (bh * O + o) * X * D, D, XP, X, D);
  };
  load_tile_async<D / 8>(Ks, LD, k + (static_cast<long>(b) * T + k0) * krow + h * D, krow,
                         kCapBK, min(kCapBK, T - k0), D);
  if constexpr (!kQ) issue(0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  uint32_t kf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) load_a(kf[ks], Ks + warp * 16 * LD, LD, 16 * ks, lane);
  // ww fragments of the two 16-row groups of q this warp builds
  uint32_t wf[2][XS][4];
  if constexpr (!kQ) {
    ww_frags(wf[0], ww, 32 * warp, P, X, lane);
    ww_frags(wf[1], ww, 32 * warp + 16, P, X, lane);
  }
  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  float dk_acc[VT][4];
#pragma unroll
  for (int j = 0; j < VT; ++j) dk_acc[j][0] = dk_acc[j][1] = dk_acc[j][2] = dk_acc[j][3] = 0.f;

  for (int o = 0; o < O; ++o) {
    const int rows = min(P, N - o * P);  // query rows of block o
    if constexpr (kQ) {
      __syncthreads();  // every warp is done with Qs and Gs of block o - 1
      issue(o);
      cp_async_commit();
    } else {
      cp_async_wait_all();
      __syncthreads();  // tt of row o landed; every warp is done with Qs and Gs of row o - 1
      if (o + 1 < O) {
        issue(o + 1);
        cp_async_commit();
      }
    }
    const long row0 = static_cast<long>(b) * N + o * P;  // first map row of block o
    for (int i = threadIdx.x; i < kCapBQ * kCapBK; i += blockDim.x) {
      const int r = i / kCapBK, c = i % kCapBK;
      Gs[r * GLD + c] = (r < rows && k0 + c < T) ? gmap[(row0 + r) * T + k0 + c] : 0.f;
    }
    for (int i = threadIdx.x; i < kCapBQ; i += blockDim.x) {
      Ls[i] = i < rows ? lse[bh * N + o * P + i] : 0.f;
      Cq[i] = i < rows ? cvec[bh * N + o * P + i] : 0.f;
    }
    if constexpr (kQ) {
      cp_async_wait_all();
    } else {
      // q rows 32 * warp .. + 31 of row o: bf16(ww . tt[b, h, o]), as the forward
      const bf16* th = Ts + (o & 1) * XP * LD;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < VT; ++j) {
          float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int xs = 0; xs < XS; ++xs) {
            if (xs >= xsteps) break;
            uint32_t bb[2];
            load_b(bb, th + 16 * xs * LD, LD, 8 * j, lane);
            mma_bf16(c, wf[mi][xs], bb);
          }
          bf16* qr = Qs + (32 * warp + 16 * mi + g) * LD + 8 * j + 2 * t;
          *reinterpret_cast<uint32_t*>(qr) = pack_bf16(c[0], c[1]);
          *reinterpret_cast<uint32_t*>(qr + 8 * LD) = pack_bf16(c[2], c[3]);
        }
    }
    __syncthreads();  // q, g, lse and c of block o are in shared memory
    const int halves = (rows + 63) / 64;

    for (int half = 0; half < halves; ++half) {
      const bf16* qt = Qs + half * 64 * LD;
      float s[NT][4];
      warp_scores<KS, NT>(s, kf, qt, LD, lane);  // s^T: keys x queries
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = half * 64 + 8 * n + 2 * t + (e & 1), kr = 16 * warp + g + 8 * (e >> 1);
          const bool ok = key[e >> 1] < T && col < rows;
          const float p = ok ? exp2f(s[n][e] * scale_log2 - Ls[col]) : 0.f;
          s[n][e] = (Gs[col * GLD + kr] * inv_h * p - p * Cq[col]) * scale;
        }
      warp_pv<4, VT>(dk_acc, s, qt, LD, lane);  // dk += bf16(dsim)^T . q
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= T) continue;
    bf16* dst = dk + (static_cast<long>(b) * T + key[r]) * krow + h * D + 2 * t;
#pragma unroll
    for (int j = 0; j < VT; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) = pack_bf16(dk_acc[j][2 * r], dk_acc[j][2 * r + 1]);
  }
}

// K1: O output rows of P <= 128 columns; K2 (kQ): O = 1, P = N query rows
template <int D, bool kQ>
static int launch_capture_bwd(const void* tt, const void* ww, const void* k, const void* g,
                              void* lse, void* c, void* dt, void* dk, int B, int H, int O,
                              int X, int P, int T, float scale, cudaStream_t stream) {
  if (X > kCapMaxX || (!kQ && P > kCapBQ)) return -1;
  using C = CaptureBwdCfg<D>;
  const int XP = kQ ? 0 : (X + 15) / 16 * 16;
  const size_t rows_smem = C::rows_bytes(H, XP, kQ), keys_smem = C::keys_bytes(XP);
  cudaError_t err = cudaFuncSetAttribute(capture_bwd_rows_kernel<D, kQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)rows_smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(capture_bwd_keys_kernel<D, kQ>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)keys_smem);
  if (err != cudaSuccess) return (int)err;
  const bf16 *ttp = static_cast<const bf16*>(tt), *wwp = static_cast<const bf16*>(ww),
             *kp = static_cast<const bf16*>(k);
  const float* gp = static_cast<const float*>(g);
  dim3 grid_rows((P + kCapBQ - 1) / kCapBQ, O, B);
  capture_bwd_rows_kernel<D, kQ><<<grid_rows, kCapWarps * 32, rows_smem, stream>>>(
      ttp, wwp, kp, gp, static_cast<float*>(lse), static_cast<float*>(c),
      static_cast<bf16*>(dt), H, O, X, P, T, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // the keys kernel walks blocks of <= 128 query rows
  const int n = O * P, ko = kQ ? (n + kCapBQ - 1) / kCapBQ : O, kp_rows = kQ ? kCapBQ : P;
  dim3 grid_keys(H, (T + kCapBK - 1) / kCapBK, B);
  capture_bwd_keys_kernel<D, kQ><<<grid_keys, 4 * 32, keys_smem, stream>>>(
      ttp, wwp, kp, gp, static_cast<const float*>(lse), static_cast<const float*>(c),
      static_cast<bf16*>(dk), H, ko, X, kp_rows, n, T, scale);
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
    case 80: return skp::launch_capture<80, false>(tt, ww, k, out, B, H, O, X, P, T, scale, s);
    case 160: return skp::launch_capture<160, false>(tt, ww, k, out, B, H, O, X, P, T, scale, s);
    default: return -1;
  }
}

// (tt, ww, k as for skp_capture_fwd; g [B, O*P, T] fp32, the maps' cotangent)
// -> dt [B,H,O,X,D] and dk [B,T,H,D] bf16; lse and c [B,H,O*P] fp32 are
// scratch. -1 for an unsupported head dimension, X > 32 or P > 128.
extern "C" int skp_capture_bwd(const void* tt, const void* ww, const void* k, const void* g,
                               void* lse, void* c, void* dt, void* dk, int B, int H, int O,
                               int X, int P, int T, int D, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 80:
      return skp::launch_capture_bwd<80, false>(tt, ww, k, g, lse, c, dt, dk, B, H, O, X, P, T,
                                                scale, s);
    case 160:
      return skp::launch_capture_bwd<160, false>(tt, ww, k, g, lse, c, dt, dk, B, H, O, X, P,
                                                 T, scale, s);
    default: return -1;
  }
}

// K2: q [B,H,N,D] bf16 (head-major), k [B,T,H,D] bf16 -> out [B, N, T] fp32.
// -1 for an unsupported head dimension.
extern "C" int skp_capture_q_fwd(const void* q, const void* k, void* out, int B, int H, int N,
                                 int T, int D, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 80: return skp::launch_capture<80, true>(q, nullptr, k, out, B, H, 1, 0, N, T, scale, s);
    case 160: return skp::launch_capture<160, true>(q, nullptr, k, out, B, H, 1, 0, N, T, scale, s);
    default: return -1;
  }
}

// K2 backward: (q, k as for skp_capture_q_fwd; g [B, N, T] fp32) -> dq
// [B,H,N,D] and dk [B,T,H,D] bf16; lse and c [B,H,N] fp32 are scratch.
extern "C" int skp_capture_q_bwd(const void* q, const void* k, const void* g, void* lse,
                                 void* c, void* dq, void* dk, int B, int H, int N, int T, int D,
                                 float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 80:
      return skp::launch_capture_bwd<80, true>(q, nullptr, k, g, lse, c, dq, dk, B, H, 1, 0, N,
                                               T, scale, s);
    case 160:
      return skp::launch_capture_bwd<160, true>(q, nullptr, k, g, lse, c, dq, dk, B, H, 1, 0, N,
                                                T, scale, s);
    default: return -1;
  }
}
