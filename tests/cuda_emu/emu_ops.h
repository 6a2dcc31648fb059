// CPU emulations of the warp-level PTX helpers of kernels/csrc/common.cuh
// (mma.sync m16n8k16 bf16, ldmatrix.x2.trans, cp.async), following the PTX
// ISA's fragment layouts; with g = lane / 4 and t = lane % 4:
//   A 16x16: a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 8+2t..)  a3 (g+8, 8+2t..)
//   B 16x8:  b0 (k 2t..2t+1, n g)  b1 (k 8+2t.., n g)
//   C 16x8:  c0,c1 (g, 2t..2t+1)   c2,c3 (g+8, 2t..2t+1)
// Included inside namespace skp in place of the inline-asm versions.
#pragma once

inline float emu_lo(uint32_t w) { return __bfloat162float({uint16_t(w & 0xffffu)}); }
inline float emu_hi(uint32_t w) { return __bfloat162float({uint16_t(w >> 16)}); }

inline void mma_bf16(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  EmuWarp& w = emu_warp();
  const int l = emu_lane();
  for (int i = 0; i < 4; ++i) {
    w.u[l][i] = a[i];
    w.f[l][i] = d[i];
  }
  w.u[l][4] = b[0];
  w.u[l][5] = b[1];
  w.bar.arrive_and_wait();
  float A[16][16], B[16][8];
  for (int L = 0; L < 32; ++L) {
    const int g = L >> 2, t = L & 3;
    A[g][2 * t] = emu_lo(w.u[L][0]);
    A[g][2 * t + 1] = emu_hi(w.u[L][0]);
    A[g + 8][2 * t] = emu_lo(w.u[L][1]);
    A[g + 8][2 * t + 1] = emu_hi(w.u[L][1]);
    A[g][2 * t + 8] = emu_lo(w.u[L][2]);
    A[g][2 * t + 9] = emu_hi(w.u[L][2]);
    A[g + 8][2 * t + 8] = emu_lo(w.u[L][3]);
    A[g + 8][2 * t + 9] = emu_hi(w.u[L][3]);
    B[2 * t][g] = emu_lo(w.u[L][4]);
    B[2 * t + 1][g] = emu_hi(w.u[L][4]);
    B[2 * t + 8][g] = emu_lo(w.u[L][5]);
    B[2 * t + 9][g] = emu_hi(w.u[L][5]);
  }
  const int g = l >> 2, t = l & 3;
  float r[4];
  for (int e = 0; e < 4; ++e) {
    const int row = g + 8 * (e >> 1), col = 2 * t + (e & 1);
    float acc = w.f[l][e];
    for (int k = 0; k < 16; ++k) acc += A[row][k] * B[k][col];
    r[e] = acc;
  }
  w.bar.arrive_and_wait();
  for (int e = 0; e < 4; ++e) d[e] = r[e];
}

// ldmatrix.x2.trans: lanes 0-15 give the row addresses of two 8x8 bf16
// matrices; lane l receives elements (2t, g) and (2t+1, g) of each
inline void load_b(uint32_t (&b)[2], const bf16* s, int ld, int n0, int) {
  EmuWarp& w = emu_warp();
  const int l = emu_lane();
  w.p[l] = s + (l & 15) * ld + n0;
  w.bar.arrive_and_wait();
  const int g = l >> 2, t = l & 3;
  for (int i = 0; i < 2; ++i) {
    const bf16* r0 = static_cast<const bf16*>(w.p[8 * i + 2 * t]);
    const bf16* r1 = static_cast<const bf16*>(w.p[8 * i + 2 * t + 1]);
    if (reinterpret_cast<uintptr_t>(r0) % 16 || reinterpret_cast<uintptr_t>(r1) % 16) std::abort();
    b[i] = uint32_t(r0[g].v) | (uint32_t(r1[g].v) << 16);
  }
  w.bar.arrive_and_wait();
}

// ldmatrix.x4 (no transpose): lanes 8i..8i+7 give the row addresses of
// matrix i; lane l receives row l / 4, columns 2t, 2t+1 of each matrix
inline void ldsm_x4(uint32_t (&r)[4], const bf16* row) {
  EmuWarp& w = emu_warp();
  const int l = emu_lane();
  w.p[l] = row;
  w.bar.arrive_and_wait();
  for (int i = 0; i < 4; ++i) {
    const bf16* src = static_cast<const bf16*>(w.p[8 * i + l / 4]);
    if (reinterpret_cast<uintptr_t>(src) % 16) std::abort();
    r[i] = uint32_t(src[2 * (l % 4)].v) | (uint32_t(src[2 * (l % 4) + 1].v) << 16);
  }
  w.bar.arrive_and_wait();
}

// the copy lands at once (the kernels wait for it before any read)
inline void cp_async16(bf16* dst, const bf16* src, bool valid) {
  if (reinterpret_cast<uintptr_t>(dst) % 16 || (valid && reinterpret_cast<uintptr_t>(src) % 16))
    std::abort();
  if (valid)
    std::memcpy(dst, src, 16);
  else
    std::memset(dst, 0, 16);
}
inline void cp_async_commit() {}
inline void cp_async_wait_all() {}
inline void cp_async_wait_1() {}

// wgmma.mma_async m64n128k16, A from registers: each warp's 16 rows of the
// warpgroup's product depend only on its own A fragment, so a warp computes
// them alone. b is read through the descriptor of a K-major tile without
// swizzle: element (k, n) at start + (n / 8) * sbo + (k / 8) * lbo +
// (n % 8) * 16 + (k % 8) * 2 bytes. The product completes at once.
inline void wgmma_m64n128k16(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                             int accumulate) {
  EmuWarp& w = emu_warp();
  const int l = emu_lane();
  for (int i = 0; i < 4; ++i) w.u[l][i] = a[i];
  w.bar.arrive_and_wait();
  float A[16][16];
  for (int L = 0; L < 32; ++L) {
    const int g = L >> 2, t = L & 3;
    A[g][2 * t] = emu_lo(w.u[L][0]);
    A[g][2 * t + 1] = emu_hi(w.u[L][0]);
    A[g + 8][2 * t] = emu_lo(w.u[L][1]);
    A[g + 8][2 * t + 1] = emu_hi(w.u[L][1]);
    A[g][2 * t + 8] = emu_lo(w.u[L][2]);
    A[g][2 * t + 9] = emu_hi(w.u[L][2]);
    A[g + 8][2 * t + 8] = emu_lo(w.u[L][3]);
    A[g + 8][2 * t + 9] = emu_hi(w.u[L][3]);
  }
  w.bar.arrive_and_wait();
  const unsigned char* start = smem + ((desc & 0x3fffu) << 4);
  const size_t lbo = ((desc >> 16) & 0x3fffu) << 4, sbo = ((desc >> 32) & 0x3fffu) << 4;
  if (reinterpret_cast<uintptr_t>(start) % 16) std::abort();
  const int g = l >> 2, t = l & 3;
  for (int j = 0; j < 16; ++j)
    for (int e = 0; e < 4; ++e) {
      const int row = g + 8 * (e >> 1), n = 8 * j + 2 * t + (e & 1);
      float acc = accumulate ? d[4 * j + e] : 0.f;
      for (int k = 0; k < 16; ++k) {
        const bf16* b = reinterpret_cast<const bf16*>(start + (n / 8) * sbo + (k / 8) * lbo +
                                                      (n % 8) * 16 + (k % 8) * 2);
        acc += A[row][k] * __bfloat162float(*b);
      }
      d[4 * j + e] = acc;
    }
}
// the same with a read through its descriptor: element (m, k) of the
// warpgroup's 64 rows at the same offsets as b's (n, k); warp w % 4 of the
// warpgroup computes rows 16 (w % 4) .. + 15
inline void wgmma_m64n128k16_ss(float (&d)[64], uint64_t a_desc, uint64_t b_desc,
                                int accumulate) {
  const unsigned char* start = smem + ((a_desc & 0x3fffu) << 4);
  const size_t lbo = ((a_desc >> 16) & 0x3fffu) << 4, sbo = ((a_desc >> 32) & 0x3fffu) << 4;
  if (reinterpret_cast<uintptr_t>(start) % 16) std::abort();
  const int l = emu_lane(), m0 = 16 * ((threadIdx.x / 32) % 4), g = l >> 2, t = l & 3;
  uint32_t a[4];
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + g + 8 * (i & 1), k = 2 * t + 8 * (i >> 1);
    const uint16_t* p = reinterpret_cast<const uint16_t*>(start + (m / 8) * sbo + (k / 8) * lbo +
                                                          (m % 8) * 16 + (k % 8) * 2);
    a[i] = uint32_t(p[0]) | (uint32_t(p[1]) << 16);
  }
  wgmma_m64n128k16(d, a, b_desc, accumulate);
}
inline void wgmma_fence_acc(float (&)[64]) {}
inline void wgmma_fence() {}
inline void wgmma_commit() {}
inline void wgmma_wait0() {}
inline void fence_proxy_async() {}
