// CPU emulations of the PTX helpers of kernels/csrc/common.cuh (mma.sync
// m16n8k16 bf16, ldmatrix, stmatrix, cp.async, wgmma in every form the
// kernels issue, ex2.approx, TMA tensor loads and stores), following the PTX
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

// stmatrix.x4 (no transpose), ldsm_x4's inverse: lane l writes row l % 8
// of matrix l / 8, whose 8 elements lanes 4 (l % 8) .. + 3 hold in r[l / 8]
inline void stsm_x4(bf16* row, const uint32_t (&r)[4]) {
  EmuWarp& w = emu_warp();
  const int l = emu_lane();
  w.p[l] = row;
  for (int i = 0; i < 4; ++i) w.u[l][i] = r[i];
  w.bar.arrive_and_wait();
  bf16* dst = const_cast<bf16*>(static_cast<const bf16*>(w.p[l]));
  if (reinterpret_cast<uintptr_t>(dst) % 16) std::abort();
  for (int q = 0; q < 4; ++q) {
    const uint32_t v = w.u[4 * (l % 8) + q][l / 8];
    dst[2 * q].v = uint16_t(v & 0xffffu);
    dst[2 * q + 1].v = uint16_t(v >> 16);
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
template <int N>
inline void cp_async_wait() {}
inline void cp_async4(float* dst, const float* src, bool valid) {
  if (reinterpret_cast<uintptr_t>(dst) % 4 || (valid && reinterpret_cast<uintptr_t>(src) % 4))
    std::abort();
  *dst = valid ? *src : 0.f;
}

// wgmma.mma_async: each warp's 16 rows of the warpgroup's product depend
// only on its own rows of a, so a warp computes them alone. An operand read
// through a descriptor (no swizzle) has element (row, k) -- row along M or
// N -- at start + (row / 8) * sbo + (k / 8) * lbo plus, K-major,
// (row % 8) * 16 + (k % 8) * 2 or, MN-major (transpose bit),
// (k % 8) * 16 + (row % 8) * 2 bytes. The product completes at once.
// With layout type 1 (128-byte swizzle) the layout is K-major: (row / 8) *
// sbo + (row % 8) * 128 + k * 2; MN-major: (row / 64) * lbo + (row % 64) * 2 +
// (k / 8) * sbo + (k % 8) * 128; and the 16-byte chunk bits [4, 7) of the
// resulting shared-memory address are XORed with its bits [7, 10).
inline float emu_desc_elem(uint64_t desc, int row, int k, bool mn_major) {
  const size_t start = (desc & 0x3fffu) << 4;
  const size_t lbo = ((desc >> 16) & 0x3fffu) << 4, sbo = ((desc >> 32) & 0x3fffu) << 4;
  const unsigned layout = unsigned(desc >> 62);
  if (start % 16 || (layout != 0 && layout != 1)) std::abort();
  size_t addr;
  if (layout == 0) {
    addr = start + (row / 8) * sbo + (k / 8) * lbo +
           (mn_major ? (k % 8) * 16 + (row % 8) * 2 : (row % 8) * 16 + (k % 8) * 2);
  } else {
    addr = start + (mn_major ? (row / 64) * lbo + (row % 64) * 2 + (k / 8) * sbo + (k % 8) * 128
                             : (row / 8) * sbo + (row % 8) * 128 + k * 2);
    addr ^= ((addr >> 7) & 7) << 4;
  }
  if (addr + 2 > size_t(kEmuMaxSmem)) std::abort();
  return __bfloat162float(*reinterpret_cast<const bf16*>(emu_smem() + addr));
}
// the warp's 16 x 16 block of a from its lanes' m16n8k16 A fragments
inline void emu_gather_a(float (&A)[16][16], const uint32_t (&a)[4]) {
  EmuWarp& w = emu_warp();
  const int l = emu_lane();
  for (int i = 0; i < 4; ++i) w.u[l][i] = a[i];
  w.bar.arrive_and_wait();
  for (int L = 0; L < 32; ++L) {
    const int g = L >> 2, t = L & 3;
    for (int i = 0; i < 4; ++i) {
      const int row = g + 8 * (i & 1), col = 2 * t + 8 * (i >> 1);
      A[row][col] = emu_lo(w.u[L][i]);
      A[row][col + 1] = emu_hi(w.u[L][i]);
    }
  }
  w.bar.arrive_and_wait();
}
// ... or from the warpgroup's 64 rows of a behind a descriptor
inline void emu_desc_a(float (&A)[16][16], uint64_t desc, bool mn_major) {
  const int m0 = 16 * ((threadIdx.x / 32) % 4);
  for (int r = 0; r < 16; ++r)
    for (int k = 0; k < 16; ++k) A[r][k] = emu_desc_elem(desc, m0 + r, k, mn_major);
}
template <int N>
inline void emu_wgmma(float* d, const float (&A)[16][16], uint64_t b_desc, bool tb,
                      int accumulate) {
  const int l = emu_lane(), g = l >> 2, t = l & 3;
  for (int j = 0; j < N / 8; ++j)
    for (int e = 0; e < 4; ++e) {
      const int row = g + 8 * (e >> 1), n = 8 * j + 2 * t + (e & 1);
      float acc = accumulate ? d[4 * j + e] : 0.f;
      for (int k = 0; k < 16; ++k) acc += A[row][k] * emu_desc_elem(b_desc, n, k, tb);
      d[4 * j + e] = acc;
    }
}
template <int N, bool TB>
inline void emu_wgmma_rs(float* d, const uint32_t (&a)[4], uint64_t b_desc, int accumulate) {
  float A[16][16];
  emu_gather_a(A, a);
  emu_wgmma<N>(d, A, b_desc, TB, accumulate);
}
template <int N, bool TA, bool TB>
inline void emu_wgmma_ss(float* d, uint64_t a_desc, uint64_t b_desc, int accumulate) {
  float A[16][16];
  emu_desc_a(A, a_desc, TA);
  emu_wgmma<N>(d, A, b_desc, TB, accumulate);
}
inline void wgmma_m64n128k16(float (&d)[64], const uint32_t (&a)[4], uint64_t b, int acc) {
  emu_wgmma_rs<128, false>(d, a, b, acc);
}
inline void wgmma_m64n128k16_tb(float (&d)[64], const uint32_t (&a)[4], uint64_t b, int acc) {
  emu_wgmma_rs<128, true>(d, a, b, acc);
}
inline void wgmma_m64n32k16(float (&d)[16], const uint32_t (&a)[4], uint64_t b, int acc) {
  emu_wgmma_rs<32, false>(d, a, b, acc);
}
inline void wgmma_m64n32k16_tb(float (&d)[16], const uint32_t (&a)[4], uint64_t b, int acc) {
  emu_wgmma_rs<32, true>(d, a, b, acc);
}
inline void wgmma_m64n16k16_tb(float (&d)[8], const uint32_t (&a)[4], uint64_t b, int acc) {
  emu_wgmma_rs<16, true>(d, a, b, acc);
}
inline void wgmma_m64n256k16(float (&d)[128], const uint32_t (&a)[4], uint64_t b, int acc) {
  emu_wgmma_rs<256, false>(d, a, b, acc);
}
inline void wgmma_m64n128k16_ss(float (&d)[64], uint64_t a, uint64_t b, int acc) {
  emu_wgmma_ss<128, false, false>(d, a, b, acc);
}
inline void wgmma_m64n40k16_tb(float (&d)[20], const uint32_t (&a)[4], uint64_t b, int acc) {
  emu_wgmma_rs<40, true>(d, a, b, acc);
}
inline void wgmma_m64n80k16_tb(float (&d)[40], const uint32_t (&a)[4], uint64_t b, int acc) {
  emu_wgmma_rs<80, true>(d, a, b, acc);
}
inline void wgmma_m64n256k16_ss(float (&d)[128], uint64_t a, uint64_t b, int acc) {
  emu_wgmma_ss<256, false, false>(d, a, b, acc);
}
inline void wgmma_m64n64k16_ss(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  emu_wgmma_ss<64, false, false>(d, a, b, acc);
}
inline void wgmma_m64n64k16(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int acc) {
  emu_wgmma_rs<64, false>(d, a, b, acc);
}
inline void wgmma_m64n64k16_tb(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int acc) {
  emu_wgmma_rs<64, true>(d, a, b, acc);
}
inline void wgmma_m64n64k16_ss_tt(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  emu_wgmma_ss<64, true, true>(d, a, b, acc);
}
inline void wgmma_m64n160k16_tb(float (&d)[80], const uint32_t (&a)[4], uint64_t b, int acc) {
  emu_wgmma_rs<160, true>(d, a, b, acc);
}
inline void wgmma_m64n160k16_ss_tt(float (&d)[80], uint64_t a, uint64_t b, int acc) {
  emu_wgmma_ss<160, true, true>(d, a, b, acc);
}
inline void wgmma_m64n40k16_ss_tt(float (&d)[20], uint64_t a, uint64_t b, int acc) {
  emu_wgmma_ss<40, true, true>(d, a, b, acc);
}
inline void wgmma_m64n80k16_ss_tt(float (&d)[40], uint64_t a, uint64_t b, int acc) {
  emu_wgmma_ss<80, true, true>(d, a, b, acc);
}
inline void wgmma_m64n32k16_ss(float (&d)[16], uint64_t a, uint64_t b, int acc) {
  emu_wgmma_ss<32, false, false>(d, a, b, acc);
}
inline void wgmma_m64n256k16_ss_tb(float (&d)[128], uint64_t a, uint64_t b, int acc) {
  emu_wgmma_ss<256, false, true>(d, a, b, acc);
}
inline void wgmma_m64n80k16_ss(float (&d)[40], uint64_t a, uint64_t b, int acc) {
  emu_wgmma_ss<80, false, false>(d, a, b, acc);
}
inline void wgmma_m64n32k16_ss_tt(float (&d)[16], uint64_t a, uint64_t b, int acc) {
  emu_wgmma_ss<32, true, true>(d, a, b, acc);
}
template <int N>
inline void reg_fence(float (&)[N]) {}
template <int N>
inline void frag_fence(uint32_t (&)[N][4]) {}
inline void wgmma_fence() {}
inline void wgmma_commit() {}
// A warpgroup's product is one operation: a warp's wait returns once every
// warp of its warpgroup has issued (here: computed) the products it waits
// for, so one thread may release their operands for the warpgroup. The
// emulated wait is a barrier of the warpgroup's 128 threads (every warp
// executes the same waits: wgmma.wait_group is .aligned).
inline void emu_warpgroup_sync() {
  EmuBlock& blk = *g_emu_block;
  std::barrier<>* bar;
  {
    std::lock_guard<std::mutex> lock(blk.named_mutex);
    const unsigned wg = threadIdx.x / 128;
    if (wg >= 8) std::abort();
    if (!blk.warpgroup[wg]) blk.warpgroup[wg].reset(new std::barrier<>(128));
    bar = blk.warpgroup[wg].get();
  }
  bar->arrive_and_wait();
}
inline void wgmma_wait0() { emu_warpgroup_sync(); }
inline void wgmma_wait1() { emu_warpgroup_sync(); }
inline void fence_proxy_async() {}
inline float fast_exp2(float x) { return std::exp2(x); }

// a named barrier: the block's barrier of that id over `count` threads,
// made by the first thread to reach it (bar.sync or bar.arrive); the
// register budget is the host's
inline void named_bar_sync(int id, int count) {
  EmuBlock& blk = *g_emu_block;
  std::barrier<>* bar;
  {
    std::lock_guard<std::mutex> lock(blk.named_mutex);
    if (id < 1 || id >= 16 || count % 32) std::abort();
    if (!blk.named[id]) blk.named[id].reset(new std::barrier<>(count));
    bar = blk.named[id].get();
  }
  bar->arrive_and_wait();
}
// bar.arrive: counts towards the barrier's phase without waiting for it
inline void named_bar_arrive(int id, int count) {
  EmuBlock& blk = *g_emu_block;
  std::barrier<>* bar;
  {
    std::lock_guard<std::mutex> lock(blk.named_mutex);
    if (id < 1 || id >= 16 || count % 32) std::abort();
    if (!blk.named[id]) blk.named[id].reset(new std::barrier<>(count));
    bar = blk.named[id].get();
  }
  (void)bar->arrive();
}
template <int N>
inline void setmaxnreg_inc() {}
template <int N>
inline void setmaxnreg_dec() {}

// mbarriers: the 8 bytes hold the phase parity (bit 63), the arrival count
// (bits 48-62), the arrivals still due (bits 32-47) and the transaction
// bytes still due (bits 0-31). A phase completes when both reach 0. A TMA
// copy counts its bytes when it is issued but lands only when a thread's
// wait on its mbarrier sees the copy's phase complete (the first such wait
// applies every copy of the phase before it returns), so a thread that
// reads a tile without that wait reads what was there before: NaN at
// first, then an earlier tile.
struct EmuPendingCopy {
  uint64_t phase;  // the barrier's phase the copy completes towards
  void* dst;
  EmuTensorMap map;  // a TMA box, or
  int c[4];
  std::vector<unsigned char> bytes;  // a bulk copy's source, read when it was issued
};
struct EmuBarState {
  uint64_t completed = 0;  // phases completed since the barrier's init
  std::vector<EmuPendingCopy> pending;
};
inline std::mutex& emu_mbar_mutex() {
  static std::mutex m;
  return m;
}
// by barrier address; guarded by emu_mbar_mutex
inline std::map<const void*, EmuBarState>& emu_bar_states() {
  static std::map<const void*, EmuBarState> states;
  return states;
}
inline void emu_mbar_update(uint64_t* bar, int arrivals, int64_t bytes) {
  std::lock_guard<std::mutex> lock(emu_mbar_mutex());
  uint64_t v = __atomic_load_n(bar, __ATOMIC_SEQ_CST);
  const uint64_t phase = v >> 63, count = (v >> 48) & 0x7fff;
  int64_t due = int64_t((v >> 32) & 0xffff) - arrivals;
  int64_t tx = int64_t(uint32_t(v)) + bytes;
  if (due < 0 || tx < 0) std::abort();
  if (due == 0 && tx == 0) {
    v = ((phase ^ 1) << 63) | (count << 48) | (count << 32);
    ++emu_bar_states()[bar].completed;
  } else {
    v = (phase << 63) | (count << 48) | (uint64_t(due) << 32) | uint64_t(tx);
  }
  __atomic_store_n(bar, v, __ATOMIC_SEQ_CST);
  std::atomic_ref<uint64_t>(*bar).notify_all();
}
inline uint32_t smem_u32(const void* p) { return uint32_t(__cvta_generic_to_shared(p)); }
inline void mbar_init(uint64_t* bar, int count) {
  std::lock_guard<std::mutex> lock(emu_mbar_mutex());
  emu_bar_states()[bar] = EmuBarState{};
  __atomic_store_n(bar, (uint64_t(count) << 48) | (uint64_t(count) << 32), __ATOMIC_SEQ_CST);
}
inline void mbar_fence_init() {}
inline void mbar_arrive(uint64_t* bar) { emu_mbar_update(bar, 1, 0); }
inline void mbar_expect_tx(uint64_t* bar, int bytes) { emu_mbar_update(bar, 1, bytes); }
// TMA loads: the box at c, dim 0 fastest (the order TMA lays it out in
// shared memory); elements outside the tensor are zero. 128-byte swizzle:
// the 16-byte chunk of each 128-byte row XORed with the row's index within
// its 1024-byte atom.
inline size_t emu_tma_bytes(const EmuTensorMap& m) {
  return size_t(m.box[0]) * m.box[1] * m.box[2] * m.box[3] * m.esize;
}
inline void emu_tma_apply(void* dst, const EmuTensorMap& m, const int (&c)[4]) {
  unsigned char* out = static_cast<unsigned char*>(dst);
  size_t o = 0;
  for (uint32_t i3 = 0; i3 < m.box[3]; ++i3)
    for (uint32_t i2 = 0; i2 < m.box[2]; ++i2)
      for (uint32_t i1 = 0; i1 < m.box[1]; ++i1)
        for (uint32_t i0 = 0; i0 < m.box[0]; ++i0, o += m.esize) {
          const int64_t at[4] = {c[0] + i0, c[1] + i1, c[2] + i2, c[3] + i3};
          bool in = true;
          size_t off = 0;
          for (int d = 0; d < 4; ++d) {
            in = in && at[d] >= 0 && uint64_t(at[d]) < m.dims[d];
            off += at[d] * m.strides[d];
          }
          unsigned char* to = out + (m.sw128 ? o ^ (((o >> 7) & 7) << 4) : o);
          if (in) std::memcpy(to, m.base + off, m.esize);
          else std::memset(to, 0, m.esize);
        }
}
// the copy is recorded against the barrier's current phase, then its bytes
// count (which may complete the phase)
inline void emu_tma_issue(void* dst, const CUtensorMap* map, const int (&c)[4], uint64_t* bar) {
  const EmuTensorMap& m = *reinterpret_cast<const EmuTensorMap*>(map);
  if (reinterpret_cast<uintptr_t>(dst) % (m.sw128 ? 1024 : 128)) std::abort();
  {
    std::lock_guard<std::mutex> lock(emu_mbar_mutex());
    EmuBarState& st = emu_bar_states()[bar];
    st.pending.push_back(EmuPendingCopy{st.completed, dst, m, {c[0], c[1], c[2], c[3]}});
  }
  emu_mbar_update(bar, 0, -int64_t(emu_tma_bytes(m)));
}
// wait until the phase of parity `parity` has completed, then land the
// copies of every completed phase
inline void mbar_wait(uint64_t* bar, int parity) {
  // a waiter yields, then blocks until the word changes (every update
  // notifies): a cluster is thousands of threads
  for (uint64_t v, spin = 0; ((v = __atomic_load_n(bar, __ATOMIC_SEQ_CST)) >> 63) == uint64_t(parity); ++spin)
    if (spin < 64) std::this_thread::yield();
    else std::atomic_ref<uint64_t>(*bar).wait(v);
  std::lock_guard<std::mutex> lock(emu_mbar_mutex());
  EmuBarState& st = emu_bar_states()[bar];
  auto done = [&](const EmuPendingCopy& p) { return p.phase < st.completed; };
  for (const EmuPendingCopy& p : st.pending)
    if (done(p) && p.bytes.empty()) emu_tma_apply(p.dst, p.map, p.c);
    else if (done(p)) std::memcpy(p.dst, p.bytes.data(), p.bytes.size());
  st.pending.erase(std::remove_if(st.pending.begin(), st.pending.end(), done), st.pending.end());
}
inline void tma_load_4d(bf16* dst, const CUtensorMap* map, int c0, int c1, int c2, int c3,
                        uint64_t* bar) {
  emu_tma_issue(dst, map, {c0, c1, c2, c3}, bar);
}
inline void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1, uint64_t* bar) {
  emu_tma_issue(dst, map, {c0, c1, 0, 0}, bar);
}

// thread block clusters: a shared::cluster address is the block's rank in
// bits 24.. and the offset in its shared memory below; stores and mbarrier
// arrivals land at once, and the mbarriers order them for the waiting side
inline int cluster_rank() { return g_emu_rank; }
inline uint32_t cluster_map(const void* p, int rank) {
  if (rank < 0 || rank >= g_emu_cluster->size) std::abort();
  return (uint32_t(rank) << 24) | uint32_t(__cvta_generic_to_shared(p));
}
inline unsigned char* emu_cluster_ptr(uint32_t a) {
  if ((a & 0xffffffu) >= uint32_t(kEmuMaxSmem)) std::abort();
  return g_emu_cluster->smem[a >> 24] + (a & 0xffffffu);
}
inline void st_cluster_f32x2(uint32_t a, float x, float y) {
  if (a % 8) std::abort();
  float* f = reinterpret_cast<float*>(emu_cluster_ptr(a));
  f[0] = x;
  f[1] = y;
}
inline float ld_cluster_f32(uint32_t a) {
  if (a % 4) std::abort();
  return *reinterpret_cast<const float*>(emu_cluster_ptr(a));
}
inline float2 ld_cluster_f32x2(uint32_t a) {
  if (a % 8) std::abort();
  const float* f = reinterpret_cast<const float*>(emu_cluster_ptr(a));
  return make_float2(f[0], f[1]);
}
inline void mbar_arrive_cluster(uint32_t a) {
  emu_mbar_update(reinterpret_cast<uint64_t*>(emu_cluster_ptr(a)), 1, 0);
}
inline void mbar_wait_cluster(uint64_t* bar, int parity) { mbar_wait(bar, parity); }
// bulk copies between the cluster's shared memories: the source is read
// when the copy is issued, the bytes land when the destination's mbarrier
// is waited on (as TMA loads); the group waits have nothing left to wait for
inline void bulk_copy_to_cluster(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  if (dst % 16 || reinterpret_cast<uintptr_t>(src) % 16 || bytes % 16 || bytes <= 0) std::abort();
  uint64_t* b = reinterpret_cast<uint64_t*>(emu_cluster_ptr(bar));
  emu_cluster_ptr(dst + uint32_t(bytes) - 1);  // in bounds
  {
    std::lock_guard<std::mutex> lock(emu_mbar_mutex());
    EmuBarState& st = emu_bar_states()[b];
    const unsigned char* s = static_cast<const unsigned char*>(src);
    st.pending.push_back(EmuPendingCopy{st.completed, emu_cluster_ptr(dst), {}, {}, {s, s + bytes}});
  }
  emu_mbar_update(b, 0, -int64_t(bytes));
}
// TMA tensor stores: a store is recorded in the issuing thread's open bulk
// group with its shared-memory source; bulk_commit closes the group, and
// bulk_wait_read<N> applies every group but the N newest. Only then is the
// source read and each element inside the tensor written, so a kernel that
// writes the staging again before that wait stores the later data, and one
// that never waits stores nothing. (The cluster bulk copies above land at
// their mbarriers; the group waits have nothing else to wait for.)
struct EmuPendingStore {
  EmuTensorMap map;
  int c[4];
  const unsigned char* src;
};
inline thread_local std::vector<EmuPendingStore> g_emu_open_stores;
inline thread_local std::vector<std::vector<EmuPendingStore>> g_emu_store_groups;
inline void tma_store_4d(const CUtensorMap* map, const bf16* src, int c0, int c1, int c2, int c3) {
  const EmuTensorMap& m = *reinterpret_cast<const EmuTensorMap*>(map);
  if (reinterpret_cast<uintptr_t>(src) % (m.sw128 ? 1024 : 128)) std::abort();
  g_emu_open_stores.push_back(
      EmuPendingStore{m, {c0, c1, c2, c3}, reinterpret_cast<const unsigned char*>(src)});
}
inline void emu_tma_store_apply(const EmuPendingStore& p) {
  const EmuTensorMap& m = p.map;
  size_t o = 0;
  for (uint32_t i3 = 0; i3 < m.box[3]; ++i3)
    for (uint32_t i2 = 0; i2 < m.box[2]; ++i2)
      for (uint32_t i1 = 0; i1 < m.box[1]; ++i1)
        for (uint32_t i0 = 0; i0 < m.box[0]; ++i0, o += m.esize) {
          const int64_t at[4] = {p.c[0] + i0, p.c[1] + i1, p.c[2] + i2, p.c[3] + i3};
          bool in = true;
          size_t off = 0;
          for (int d = 0; d < 4; ++d) {
            in = in && at[d] >= 0 && uint64_t(at[d]) < m.dims[d];
            off += at[d] * m.strides[d];
          }
          const unsigned char* from = p.src + (m.sw128 ? o ^ (((o >> 7) & 7) << 4) : o);
          if (in) std::memcpy(const_cast<unsigned char*>(m.base) + off, from, m.esize);
        }
}
inline void bulk_commit() {
  g_emu_store_groups.push_back(std::move(g_emu_open_stores));
  g_emu_open_stores.clear();
}
template <int N>
inline void bulk_wait_read() {
  while (g_emu_store_groups.size() > size_t(N)) {
    for (const EmuPendingStore& p : g_emu_store_groups.front()) emu_tma_store_apply(p);
    g_emu_store_groups.erase(g_emu_store_groups.begin());
  }
}
inline void cluster_sync() { g_emu_cluster->bar->arrive_and_wait(); }
