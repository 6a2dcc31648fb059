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
