// K2 (the bucket scan, G2) and K6 (the fixed-base MSM, G1 and G2) at
// twelve words (BLS12-381) where chains or points fill the card:
// rcb_wide_madd_scan3 and rcb_wide_fixed_base1/3, launched by
// rcb_team_scan.cu (mode 0 of zkp_rcb_scan) and rcb_fixed_base.cu from the
// widths of wide_design on; narrower launches, K2 on G1, and every launch
// at eight words keep the team designs of rcb_team.cuh and K6's one thread
// a point.
//
// At twelve words an Fq product is 600 IMADs, and where chains fill the
// card the IMAD issue rate bounds these kernels. The 8-lane team of
// rcb_team.cuh issues a warp instruction for four chains where two to four
// of its lanes work (idle lanes, the adds of L2, the combination), and its
// G2 slots (70-83 KB a block of 256 threads) let two or three blocks share
// an SM. So each lane here multiplies at every product level, and every
// value lives in registers:
//   G1 (Fq, K6): one thread a point, rcb.cuh's Alg. 8 (rcb_madd; 3b an
//     add chain, field.cuh fe_mul_b3).
//   G2 (Fq2): a team of three lanes a chain, lane s holding part s of every
//     Fq2 value x = x0 + x1 u: x0 (s = 0), x1 (s = 1) or x0 + x1 (s = 2).
//     Parts are linear in x, and the product of parts s of a and b is part
//     v_s of Karatsuba's product a b (v0 = a0 b0, v1 = a1 b1, v2 = (a0 +
//     a1)(b0 + b1)), so each lane computes one Fq product of each Fq2
//     product: five at Alg. 8's first level (t0 = X1 X2, t1 = Y1 Y2, (X1 +
//     Y1)(X2 + Y2), X2 Z1, Y2 Z1), six at its last. v-form returns to part
//     form through two rounds of __shfl_sync within the team (part 0 is v0
//     - v1, part 1 v2 - (v0 + v1), part 2 v2 - 2 v1), once for each product
//     of the first level and once for each of X3, Y3, Z3 (differences and
//     sums of v-forms are v-forms). 3b x for 3b = k + k u takes one round
//     (parts k (x0 - x1), k (x0 + x1), 2k x0) and an add chain; any other
//     3b one Fq product by part s of 3b and a return to part form. Ten teams
//     share a warp (its lanes 30 and 31 idle).
// Each reads its next element a step ahead: the next leaf (K2, through
// the sort order) or the next live window's table row (K6, through the
// scalar's digits) is copied by cp.async into shared memory (G1: its own
// buffer a thread, chunk-major so that a warp's 16-byte reads hit distinct
// banks; G2: the team's, each lane copying a third of it) while a step
// multiplies. A team's lanes read the row after a __syncwarp, and meet at
// another after the step, so that no lane copies over a buffer that
// another still reads (a flagged leaf's step has no shuffle to order them).
//
// Every value is formed by canonical field operations from the same values
// as the formulas of rcb.cuh, so the outputs are the same bits as the team
// designs' and the plain versions'. Blocks of kWideBlock threads; a thread
// or team past the last chain or point returns at once (a team as a whole:
// its shuffles name its own lanes only). The launches are on the caller's
// stream; they allocate nothing and do not synchronise.
#pragma once

#include <cuda_pipeline.h>

#include "rcb_team.cuh"

namespace zkp {
namespace {

constexpr int kWideBlock = 128;  // threads a block
// Blocks an SM must hold (ptxas bounds the registers to 168 a thread): on
// the H100, 3 blocks (12 warps an SM) against 2 at 184-255 registers take
// K6 G1 at 2^20 points from 42.4 to 29.1 ms, K6 G2 from 176.6 to 120.1 and
// K2 G2 at 65536 chains from 13.4 to 11.5, for 44-88 B of spills a thread;
// 4 blocks (128 registers) spill 0.7 KB (PERF.md).
constexpr int kWideMinBlocks = 3;
constexpr int kTeams3 = 10;      // three-lane teams a warp
constexpr int kTeams3Block = kTeams3 * kWideBlock / 32;

// The widths (chains for K2, points for K6) from which the twelve-word
// launches run these designs, [G1, G2]; 0: none. On the H100 the
// three-lane team loses to the warp team up to 2048 and to the 8-lane
// team at 4096 (K2 1.73 against 1.01 ms, K6 1.77 against 0.99 at 4096)
// and wins from 8192 on (K2 1.76 against 2.06, K6 1.77 against 1.87; at
// 2^20 points 174 against 224 ms). One thread a chain for K2 G1 lost to
// the 8-lane team at every width from 2048 chains (5.42 against 3.17 ms
// at 65536: one thread's products in a row are latency-bound), so K2 G1
// has no wide design (PERF.md).
constexpr long long kWideK2Min[2] = {0, 8192};
constexpr long long kWideK6Min[2] = {1, 8192};

// Whether a K2 (kernel 0) or K6 (kernel 3) launch of n chains or points at
// nw words runs the wide design.
bool wide_design(int nw, int ext, int kernel, long long n) {
  if (nw != kNW12 || (kernel != 0 && kernel != 3)) return false;
  const long long t = (kernel == 0 ? kWideK2Min : kWideK6Min)[ext - 1];
  return t > 0 && n >= t;
}

// ------------------------------------------------------------------ G1
// The next element's X and Y packed words, two stages, chunk-major:
// [stage][chunk][thread] of 16 bytes.
template <int NW>
struct Stage1 {
  static constexpr int CH = 2 * NW / 4;  // 16-byte chunks of X and Y
  uint4 (*buf)[CH][kWideBlock];

  // cp.async of row r of xw and of yw into stage st
  __device__ __forceinline__ void copy(int st, const uint32_t* xw, const uint32_t* yw,
                                       long long r) const {
    const uint4* x4 = reinterpret_cast<const uint4*>(xw + r * NW);
    const uint4* y4 = reinterpret_cast<const uint4*>(yw + r * NW);
#pragma unroll
    for (int q = 0; q < CH / 2; ++q) {
      __pipeline_memcpy_async(&buf[st][q][threadIdx.x], x4 + q, 16);
      __pipeline_memcpy_async(&buf[st][CH / 2 + q][threadIdx.x], y4 + q, 16);
    }
    __pipeline_commit();
  }

  __device__ __forceinline__ void read(int st, Fe<NW, 1>& X, Fe<NW, 1>& Y) const {
#pragma unroll
    for (int q = 0; q < CH / 2; ++q) {
      const uint4 a = buf[st][q][threadIdx.x], b = buf[st][CH / 2 + q][threadIdx.x];
      uint32_t* x = X.v[0] + 4 * q;
      uint32_t* y = Y.v[0] + 4 * q;
      x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
      y[0] = b.x, y[1] = b.y, y[2] = b.z, y[3] = b.w;
    }
  }
};

// K6, G1: thread i folds the table rows (w, digit w of scalar i) from the
// identity with Alg. 8, skipping zero digits (row 0, the identity, is never
// read), and writes the projective total. The scalar's limbs sit in shared
// memory as packed words (byte w is digit w), [word][thread].
template <int NW>
__global__ void __launch_bounds__(kWideBlock, kWideMinBlocks)
    rcb_wide_fixed_base1(CurveConsts c, uint32_t* ox, uint32_t* oy, uint32_t* oz,
                         const uint32_t* xw, const uint32_t* yw, const uint32_t* sc,
                         long long n) {
  __shared__ __align__(16) uint4 buf[2][Stage1<NW>::CH][kWideBlock];
  __shared__ uint32_t dw[kFbLimbs / 2][kWideBlock];
  const Stage1<NW> sg{buf};
  const long long i = (long long)blockIdx.x * kWideBlock + threadIdx.x;
  if (i >= n) return;
  const uint2* s2 = reinterpret_cast<const uint2*>(sc + i * kFbLimbs);
#pragma unroll
  for (int q = 0; q < kFbLimbs / 2; ++q) {
    const uint2 v = __ldg(s2 + q);
    dw[q][threadIdx.x] = (v.x & 0xFFFFu) | (v.y << 16);
  }
  auto digit = [&](int w) { return (dw[w >> 2][threadIdx.x] >> (8 * (w & 3))) & 0xFFu; };
  auto live = [&](int w) {  // the first window from w on with a digit, or kFbWin
    while (w < kFbWin && !digit(w)) ++w;
    return w;
  };
  auto row = [&](int w) { return (long long)w * kFbRows + digit(w); };
  Pt<NW, 1> acc = identity<NW, 1>(c);
  int w = live(0), st = 0;
  if (w < kFbWin) sg.copy(0, xw, yw, row(w));
  while (w < kFbWin) {
    const int next = live(w + 1);
    if (next < kFbWin) {
      sg.copy(st ^ 1, xw, yw, row(next));
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    Fe<NW, 1> X2, Y2;
    sg.read(st, X2, Y2);
    acc = rcb_madd<NW, 1>(acc, X2, Y2, c);
    st ^= 1;
    w = next;
  }
  store_pt<NW, 1>(ox, oy, oz, i, acc);
}

// ------------------------------------------------------------------ G2
// Lane s of a three-lane team, and its team's stage buffer: two stages of
// an element's X and Y rows (c0 then c1, 4 NW words each), then pad words
// (a team's slot is 4 words mod 32 so that the teams of a warp read
// distinct banks), then for K6 the scalar's digits as packed words.
template <int NW>
struct Lane3 {
  static constexpr int CH = 4 * NW / 4;  // 16-byte chunks of X and Y (both components)
  static constexpr int STAGE = 4 * NW;   // words a stage
  static constexpr int SLOT = 2 * STAGE + kFbLimbs / 2 + 4;  // words a team's slot
  // 16-byte aligned, and 4 mod 8 words: any four teams in a row read
  // 16-byte words of distinct banks at equal offsets
  static_assert(SLOT % 8 == 4 && CH % 3 == 0, "the slot layout");

  int s;          // this lane's part: 0 c0, 1 c1, 2 c0 + c1
  int base;       // the warp lane of the team's part 0
  unsigned mask;  // the team's lanes
  uint32_t* slot;

  __device__ __forceinline__ explicit Lane3(uint32_t* smem) {
    const int l = threadIdx.x % 32;
    base = l / 3 * 3;
    s = l - base;
    mask = 7u << base;
    slot = smem + (threadIdx.x / 32 * kTeams3 + l / 3) * SLOT;
  }

  // this lane's team in the grid (lanes 30 and 31 of a warp: none, -1)
  static __device__ __forceinline__ long long index() {
    const int l = threadIdx.x % 32;
    if (l >= 3 * kTeams3) return -1;
    return (long long)blockIdx.x * kTeams3Block + threadIdx.x / 32 * kTeams3 + l / 3;
  }

  __device__ __forceinline__ void sync() const { __syncwarp(mask); }

  // r = x of the team's lane src
  __device__ __forceinline__ void from(uint32_t* r, const uint32_t* x, int src) const {
#pragma unroll
    for (int i = 0; i < NW; ++i) r[i] = __shfl_sync(mask, x[i], base + src);
  }

  // r = part s of the Fq2 product whose Karatsuba part s is v (r may be v)
  __device__ __forceinline__ void part(uint32_t* r, const uint32_t* v,
                                       const CurveConsts& c) const {
    uint32_t y[NW], z[NW];
    from(y, v, s == 1 ? 0 : 1);  // v1 (s = 0, 2) or v0 (s = 1)
    from(z, v, 2);               // v2
    // s 0: v0 - (v1 + 0); s 1: v2 - (v1 + v0); s 2: v2 - (v1 + v1)
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const uint32_t a = s == 1 ? z[i] : v[i];
      const uint32_t b = s == 1 ? v[i] : y[i];
      z[i] = a;
      y[i] = s == 0 ? 0u : y[i];
      r[i] = b;
    }
    fp_add<NW>(y, r, y, c);
    fp_sub<NW>(r, z, y, c);
  }

  // r = part s of 3b x, from part s of x (r may be x)
  __device__ __forceinline__ void mul_b3(uint32_t* r, const uint32_t* x,
                                         const CurveConsts& c) const {
    uint32_t y[NW], d[NW];
    if (c.b3_twist) {  // k (x0 - x1), k (x0 + x1) = k part 2, 2k x0 = 2k part 0
      from(y, x, s == 2 ? 0 : s + 1);
      fp_sub<NW>(d, x, y, c);
#pragma unroll
      for (int i = 0; i < NW; ++i) d[i] = s == 0 ? d[i] : y[i];
      fp_mul_small<NW>(r, d, c.b3_small, c);
      fp_add<NW>(d, r, r, c);
#pragma unroll
      for (int i = 0; i < NW; ++i) r[i] = s == 2 ? d[i] : r[i];
    } else {  // Karatsuba part s of x 3b, back to part form
      fp_add<NW>(d, c.b3[0], c.b3[1], c);
#pragma unroll
      for (int i = 0; i < NW; ++i) y[i] = s == 2 ? d[i] : c.b3[s & 1][i];
      fp_mul<NW>(d, x, y, c);
      part(r, d, c);
    }
  }

  // cp.async of row r of xw and of yw (4 NW words: c0, c1) into stage st,
  // this lane's third of the chunks
  __device__ __forceinline__ void copy(int st, const uint32_t* xw, const uint32_t* yw,
                                       long long r) const {
#pragma unroll
    for (int k = 0; k < CH / 3; ++k) {
      const int q = s + 3 * k, half = CH / 2;
      const uint32_t* src = (q < half ? xw : yw) + r * 2 * NW + 4 * (q % half);
      __pipeline_memcpy_async(slot + st * STAGE + 4 * q, src, 16);
    }
    __pipeline_commit();
  }

  // part s of the staged element's X2 and Y2; with flag, the infinity flag
  // (bit 31 of the top X word) is read and cleared
  __device__ __forceinline__ uint32_t read(int st, uint32_t* X2, uint32_t* Y2, bool flag,
                                           const CurveConsts& c) const {
    const uint4* src = reinterpret_cast<const uint4*>(slot + st * STAGE);
    uint32_t c1[NW];
    uint32_t f = 0;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      uint32_t* d = k ? Y2 : X2;
#pragma unroll
      for (int q = 0; q < NW / 4; ++q) {
        const uint4 u = src[k * NW / 2 + q], v = src[k * NW / 2 + NW / 4 + q];
        d[4 * q] = u.x, d[4 * q + 1] = u.y, d[4 * q + 2] = u.z, d[4 * q + 3] = u.w;
        c1[4 * q] = v.x, c1[4 * q + 1] = v.y, c1[4 * q + 2] = v.z, c1[4 * q + 3] = v.w;
      }
      if (flag && k == 0) {
        f = c1[NW - 1] >> 31;
        c1[NW - 1] &= 0x7FFFFFFFu;
      }
      uint32_t sum[NW];
      fp_add<NW>(sum, d, c1, c);
#pragma unroll
      for (int i = 0; i < NW; ++i) d[i] = s == 0 ? d[i] : s == 1 ? c1[i] : sum[i];
    }
    return f;
  }

  // Alg. 8: (X1, Y1, Z1) += (X2, Y2, 1), parts s throughout
  __device__ __forceinline__ void madd(uint32_t* X1, uint32_t* Y1, uint32_t* Z1,
                                       const uint32_t* X2, const uint32_t* Y2,
                                       const CurveConsts& c) const {
    uint32_t t0[NW], t1[NW], t3[NW], a[NW], b[NW], u[NW];
    // L1: Karatsuba parts of t0 = X1 X2, t1 = Y1 Y2, m = (X1+Y1)(X2+Y2),
    // X2 Z1, Y2 Z1; t3 = m - (t0 + t1) in that form
    fp_mul<NW>(t0, X1, X2, c);
    fp_mul<NW>(t1, Y1, Y2, c);
    fp_add<NW>(a, X1, Y1, c);
    fp_add<NW>(b, X2, Y2, c);
    fp_mul<NW>(t3, a, b, c);
    fp_mul<NW>(a, X2, Z1, c);
    fp_mul<NW>(b, Y2, Z1, c);
    fp_add<NW>(u, t0, t1, c);
    fp_sub<NW>(t3, t3, u, c);
    part(t0, t0, c);
    part(t1, t1, c);
    part(t3, t3, c);
    part(a, a, c);
    part(b, b, c);
    // L2: t4 = X2 Z1 + X1, Y3' = 3b t4, t5 = Y2 Z1 + Y1, Z3 = t1 + 3b Z1,
    // t1' = t1 - 3b Z1, t0' = 3 t0
    fp_add<NW>(a, a, X1, c);
    mul_b3(a, a, c);
    fp_add<NW>(b, b, Y1, c);
    mul_b3(Z1, Z1, c);
    fp_add<NW>(u, t1, Z1, c);
    fp_sub<NW>(t1, t1, Z1, c);
    fp_add<NW>(Z1, t0, t0, c);
    fp_add<NW>(t0, Z1, t0, c);
    // L3: X3 = t3 t1' - t5 Y3', Y3 = t1' Z3 + Y3' t0', Z3 = Z3 t5 + t0' t3
    fp_mul<NW>(X1, t3, t1, c);
    fp_mul<NW>(Y1, b, a, c);
    fp_sub<NW>(X1, X1, Y1, c);
    fp_mul<NW>(Y1, t1, u, c);
    fp_mul<NW>(Z1, a, t0, c);
    fp_add<NW>(Y1, Y1, Z1, c);
    fp_mul<NW>(Z1, u, b, c);
    fp_mul<NW>(a, t0, t3, c);
    fp_add<NW>(Z1, Z1, a, c);
    part(X1, X1, c);
    part(Y1, Y1, c);
    part(Z1, Z1, c);
  }

  // the identity (0 : 1 : 0): parts of 0, 1, 0
  __device__ __forceinline__ void identity(uint32_t* X, uint32_t* Y, uint32_t* Z,
                                           const CurveConsts& c) const {
#pragma unroll
    for (int i = 0; i < NW; ++i) X[i] = Z[i] = 0, Y[i] = s == 1 ? 0u : c.one[i];
  }

  // lanes 0 and 1: component s of (X, Y, Z) -> point e of (dx, dy, dz) as
  // limb rows
  __device__ __forceinline__ void store(uint32_t* dx, uint32_t* dy, uint32_t* dz, long long e,
                                        const uint32_t* X, const uint32_t* Y,
                                        const uint32_t* Z) const {
    if (s == 2) return;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const uint32_t* a = k == 0 ? X : k == 1 ? Y : Z;
      uint4* d = reinterpret_cast<uint4*>((k == 0 ? dx : k == 1 ? dy : dz) +
                                          (e * 2 + s) * 2 * NW);
#pragma unroll
      for (int q = 0; q < NW / 2; ++q)
        d[q] = make_uint4(a[2 * q] & 0xFFFFu, a[2 * q] >> 16, a[2 * q + 1] & 0xFFFFu,
                          a[2 * q + 1] >> 16);
    }
  }
};

// K2, G2: team g folds the leaves order[g*B] .. order[g*B+B-1] (order
// null: g*B ..) from the identity with Alg. 8, writing every prefix W and
// the total T[g]; a flagged leaf (bit 31 of its top X word, the same in
// every lane of the team) leaves the accumulator as it is.
template <int NW>
__global__ void __launch_bounds__(kWideBlock, kWideMinBlocks)
    rcb_wide_madd_scan3(CurveConsts c, uint32_t* wx, uint32_t* wy, uint32_t* wz,
                        uint32_t* tx, uint32_t* ty, uint32_t* tz, const uint32_t* xw,
                        const uint32_t* yw, const long long* order, long long ncols,
                        int B) {
  __shared__ __align__(16) uint32_t smem[kTeams3Block * Lane3<NW>::SLOT];
  const long long g = Lane3<NW>::index();
  if (g < 0 || g >= ncols) return;  // the whole team
  const Lane3<NW> t(smem);
  const long long e0 = g * B;
  auto leaf = [&](long long e) { return order ? order[e] : e; };
  long long s = leaf(e0);  // the row of the next leaf to stage
  t.copy(0, xw, yw, s);
  if (B > 1) s = leaf(e0 + 1);
  uint32_t X[NW], Y[NW], Z[NW], X2[NW], Y2[NW];
  t.identity(X, Y, Z, c);
  for (int b = 0; b < B; ++b) {
    if (b + 1 < B) {
      t.copy((b + 1) & 1, xw, yw, s);
      if (b + 2 < B) s = leaf(e0 + b + 2);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    t.sync();
    if (!t.read(b & 1, X2, Y2, true, c)) t.madd(X, Y, Z, X2, Y2, c);
    t.sync();
    t.store(wx, wy, wz, e0 + b, X, Y, Z);
  }
  t.store(tx, ty, tz, g, X, Y, Z);
}

// K6, G2: team i folds point i's live windows as rcb_wide_fixed_base1
// does; the digits go into the team's slot once.
template <int NW>
__global__ void __launch_bounds__(kWideBlock, kWideMinBlocks)
    rcb_wide_fixed_base3(CurveConsts c, uint32_t* ox, uint32_t* oy, uint32_t* oz,
                         const uint32_t* xw, const uint32_t* yw, const uint32_t* sc,
                         long long n) {
  __shared__ __align__(16) uint32_t smem[kTeams3Block * Lane3<NW>::SLOT];
  const long long i = Lane3<NW>::index();
  if (i < 0 || i >= n) return;  // the whole team
  const Lane3<NW> t(smem);
  uint32_t* const dw = t.slot + 2 * Lane3<NW>::STAGE;
  for (int q = t.s; q < kFbLimbs / 2; q += 3) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(sc + i * kFbLimbs) + q);
    dw[q] = (v.x & 0xFFFFu) | (v.y << 16);
  }
  t.sync();
  const uint8_t* const digit = reinterpret_cast<const uint8_t*>(dw);
  auto live = [&](int w) {  // the first window from w on with a digit, or kFbWin
    while (w < kFbWin && !digit[w]) ++w;
    return w;
  };
  auto row = [&](int w) { return (long long)w * kFbRows + digit[w]; };
  uint32_t X[NW], Y[NW], Z[NW], X2[NW], Y2[NW];
  t.identity(X, Y, Z, c);
  int w = live(0), st = 0;
  if (w < kFbWin) t.copy(0, xw, yw, row(w));
  while (w < kFbWin) {
    const int next = live(w + 1);
    if (next < kFbWin) {
      t.copy(st ^ 1, xw, yw, row(next));
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    t.sync();
    t.read(st, X2, Y2, false, c);
    t.madd(X, Y, Z, X2, Y2, c);
    t.sync();
    st ^= 1;
    w = next;
  }
  t.store(ox, oy, oz, i, X, Y, Z);
}

// Blocks of a wide launch of n chains or points (ext 1: a thread each;
// ext 2: a team of three).
inline unsigned wide_blocks(int ext, long long n) {
  const int per = ext == 1 ? kWideBlock : kTeams3Block;
  return (unsigned)((n + per - 1) / per);
}

// Static shared memory a block of a wide kernel (K2 G2, K6 G1 and G2).
inline int wide_smem(int ext) {
  if (ext == 2) return kTeams3Block * Lane3<kNW12>::SLOT * 4;
  return (2 * Stage1<kNW12>::CH * 16 + kFbLimbs / 2 * 4) * kWideBlock;
}

template <int NW>
cudaError_t launch_wide_madd_scan(const CurveConsts& c, uint32_t* wx, uint32_t* wy,
                                  uint32_t* wz, uint32_t* tx, uint32_t* ty, uint32_t* tz,
                                  const uint32_t* xw, const uint32_t* yw,
                                  const long long* order, long long ncols, int B,
                                  cudaStream_t s) {
  rcb_wide_madd_scan3<NW><<<wide_blocks(2, ncols), kWideBlock, 0, s>>>(
      c, wx, wy, wz, tx, ty, tz, xw, yw, order, ncols, B);
  return cudaSuccess;
}

template <int NW, int EXT>
cudaError_t launch_wide_fixed_base(const CurveConsts& c, uint32_t* ox, uint32_t* oy,
                                   uint32_t* oz, const uint32_t* xw, const uint32_t* yw,
                                   const uint32_t* sc, long long n, cudaStream_t s) {
  auto kern = EXT == 1 ? &rcb_wide_fixed_base1<NW> : &rcb_wide_fixed_base3<NW>;
  kern<<<wide_blocks(EXT, n), kWideBlock, 0, s>>>(c, ox, oy, oz, xw, yw, sc, n);
  return cudaSuccess;
}

}  // namespace
}  // namespace zkp
