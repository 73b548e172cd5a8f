// The team of lanes that runs one RCB point operation on Hopper, and the
// kernels built on it: K3 / K4 (rcb_team_scan: chains of Alg. 7 adds over
// projective points), K2 (rcb_team_madd_scan: chains of Alg. 8 mixed adds
// over packed affine leaves, read through an order), K5 (rcb_team_add:
// one Alg. 7 add a team, no chain) and K6's fixed-base MSM on G2
// (rcb_team_fixed_base: a chain of Alg. 8 mixed adds a point over the
// window-table rows its scalar's digits pick). Their launchers and C
// entries are rcb_team_scan.cu (K2, K3, K4), rcb_add.cu (K5) and
// rcb_fixed_base.cu (K6).
//
// What bounds most of these launches on the H100 is the latency of a chain
// of dependent field products, not the IMAD rate: one thread running Alg.
// 7's twelve products (36 over Fq2) or Alg. 8's eleven in a row leaves the
// MSM's narrow launches (2-4096 chains, 1-64 points) waiting on one lane,
// and G2 spills under it (192-255 registers). So a team of lanes runs one
// chain or one add, never across warps. Where chains or points fill the
// card (K2 at 65536 chains, K5 at 2^17 points) the issue rate bounds them
// instead, and the team issues about twice one thread's instructions there
// (idle lanes, the adds of L2 and the combination; PERF.md). Both formulas
// have three levels of independent work, and each lane computes one
// product of a level:
//   Alg. 7 (K3, K4, K5), P + Q:
//     L1: t0 = X1 X2, t1 = Y1 Y2, t2 = Z1 Z2, (X1+Y1)(X2+Y2), (Y1+Z1)(Y2+Z2),
//         (X1+Z1)(X2+Z2);
//     L2: t3, t4, 3 t0, 3b Y3, Z3 = t1 + 3b t2, t1' = t1 - 3b t2;
//   Alg. 8 (K2), P + (X2, Y2, 1):
//     L1: t0 = X1 X2, t1 = Y1 Y2, (X1+Y1)(X2+Y2), X2 Z1, Y2 Z1, 3b Z1;
//     L2: t3, t5 = Y2 Z1 + Y1, 3 t0, 3b t4 (t4 = X2 Z1 + X1), Z3 = t1 + 3b Z1,
//         t1' = t1 - 3b Z1;
//   L3 (both): t3 t1', t4 Y3', t1' Z3, Y3' t0', Z3 t4, t0' t3, with t5 in
//     t4's place for Alg. 8 (Y3' = 3b Y3 or 3b t4, t0' = 3 t0);
//   then X3 = q0 - q1, Y3 = q2 + q3, Z3 = q4 + q5.
// Two team shapes:
//   8 lanes (G1; G2 above kSplitMax): six lanes each run one Fe product of
//     L1 and L3 (an Fq2 product is field.cuh fe_mul's three Fq products in
//     one lane) and one operand of L3 at L2 (3b is fe_mul_b3's add chain
//     on both BLS12-381 groups and BN254's G1, an Fq2 product on BN254's
//     G2), three lanes X3, Y3, Z3; four warp syncs a step.
//   A warp (G2 up to kSplitMax chains or points): each Fq2 product split
//     into Karatsuba's three Fq products v0, v1, v2 on three lanes, 18 lanes
//     at L1 and L3; L2 in two levels, L2a (the Karatsuba parts of the 3b
//     products beside the adds) and L2b (their combination); five warp
//     syncs a step. Where 3b = k + k u (b3_twist: BLS12-381, at twelve
//     words only) L2a forms the 3b products by field.cuh fp2_twist_b3's
//     adds and there is no L2b.
// At twelve words, K2 on G2 and K6 run the designs of rcb_wide.cuh from
// their width thresholds on. The shorter chain of products wins where chains are
//     few; where they are many, the 8-lane team's fuller lanes win (on the
//     H100 the two tie at 2048 chains; PERF.md).
// Every value is formed by canonical field operations (each returns the
// representative < p) from the same field values as rcb.cuh's rcb_add and
// rcb_madd, so the outputs are the same bits as the one-thread formulas'
// and the plain versions'. Alg. 8's 3b Z1 is the product of Z1 and 3b in
// Montgomery form, the same value as G1's add chain. Operands and results
// pass through the team's own slot of shared memory, with __syncwarp(team
// mask) between levels; lanes read absent summands from zero rows, so a
// level is one code path. A chain's accumulator stays in the slot for all B
// steps. The next element is copied into the slot by cp.async (16 B a lane,
// as it lies in device memory) while a step multiplies, and converted to
// word rows once, by the lanes that copied it, while the last level runs.
// Points leave in 16-B stores by the whole team. Word rows are padded to
// NW + 1 words and 8-lane team slots to 8 words mod 32, so the lanes of a
// warp reading distinct rows hit distinct banks.
//
// Blocks: 256 threads (the scan probe's best), halved down to one warp while
// the grid would have fewer blocks than the card has SMs, so that narrow
// launches spread over the SMs. A team past the last chain or point returns
// at once: no other team's __syncwarp waits on its lanes. A slot above 48 KB
// a block (G2's 8-lane teams at 256 threads) makes the launcher raise the
// kernel's dynamic shared-memory limit first and return that call's error.
// The launches are on the caller's stream; they allocate nothing and do not
// synchronise.
#pragma once

#include <cuda_pipeline.h>

#include "rcb.cuh"

namespace zkp {
namespace {

// G2 chains (K2-K4) or points (K5) up to this count run split (a warp a
// team); more run 8 lanes a team. On the H100 the warp team wins K3/K4 at
// 2-128 chains (0.25-0.28 ms against 0.62-0.71 for the 8-lane team at
// B = 32), the two tie at 2048 (0.68 ms), and the 8-lane team wins at 4096
// (0.72 against 1.26 ms; PERF.md).
constexpr long long kSplitMax = 2048;

bool team_split(int ext, long long n) { return ext == 2 && n <= kSplitMax; }

// lanes of one team: 32 (G2, split) or 8
int team_lanes(int ext, long long n) { return team_split(ext, n) ? 32 : 8; }

int sm_count() {  // the card's SM count, read at the first launch
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

// Threads per block for n teams: 256, halved (down to one warp) while the
// grid would have fewer blocks than SMs.
int team_block(int ext, long long n) {
  const long long lanes = n * team_lanes(ext, n);
  int threads = 256;
  while (threads > 32 && (lanes + threads - 1) / threads < sm_count())
    threads /= 2;
  return threads;
}

// L1's products as sums of coordinates (-1: none) of the accumulator (A)
// and of the element (B). Alg. 7: t0 = X1 X2, t1 = Y1 Y2, t2 = Z1 Z2,
// (X1+Y1)(X2+Y2), (Y1+Z1)(Y2+Z2), (X1+Z1)(X2+Z2), the same sums on both
// sides. Alg. 8: t0 = X1 X2, t1 = Y1 Y2, (X1+Y1)(X2+Y2), Z1 X2, Z1 Y2,
// Z1 3b (the element's third coordinate rows hold 3b). L3's products as
// pairs of OPS entries: t3 t1', t4 Y3', t1' Z3, Y3' t0', Z3 t4, t0' t3 (OPS:
// 0 t3, 1 t4 or t5, 2 t0' = 3 t0, 3 Y3', 4 Z3, 5 t1').
__constant__ int kL1A[6] = {0, 1, 2, 0, 1, 0};
__constant__ int kL1B[6] = {-1, -1, -1, 1, 2, 2};
__constant__ int kM1A1[6] = {0, 1, 0, 2, 2, 2};
__constant__ int kM1A2[6] = {-1, -1, 1, -1, -1, -1};
__constant__ int kM1B1[6] = {0, 1, 0, 0, 1, 2};
__constant__ int kL3A[6] = {0, 1, 5, 3, 4, 2};
__constant__ int kL3B[6] = {5, 3, 4, 2, 1, 0};
// L2 of the 8-lane team, [Alg. 7, Alg. 8][lane o]: OPS[o] from x = A - (B +
// C) (sub) or A + (B + C), rows coded 0-5: V[k], 6-7: X1, Y1, -1: zero;
// mode 0: x, 1: 3b x, 2: t1 + 3b x, 3: t1 - 3b x. Alg. 7: t3 = m3 - (t0 +
// t1), t4 = m4 - (t1 + t2), 3 t0, 3b Y3 (Y3 = m5 - (t0 + t2)), t1 + 3b t2,
// t1 - 3b t2; Alg. 8: t3 = m - (t0 + t1), t5 = Y2 Z1 + Y1, 3 t0, 3b t4
// (t4 = X2 Z1 + X1), t1 + 3b Z1, t1 - 3b Z1 (3b Z1 = V[5]).
__constant__ int kL2[2][6][5] = {
    {{3, 0, 1, 1, 0}, {4, 1, 2, 1, 0}, {0, 0, 0, 0, 0},
     {5, 0, 2, 1, 1}, {2, -1, -1, 0, 2}, {2, -1, -1, 0, 3}},
    {{2, 0, 1, 1, 0}, {4, 7, -1, 0, 0}, {0, 0, 0, 0, 0},
     {3, 6, -1, 0, 1}, {1, 5, -1, 0, 0}, {1, 5, -1, 1, 0}}};

template <int NW>
__device__ __forceinline__ void ld_row(uint32_t* r, const uint32_t* row) {
#pragma unroll
  for (int i = 0; i < NW; ++i) r[i] = row[i];
}

template <int NW>
__device__ __forceinline__ void st_row(uint32_t* row, const uint32_t* r) {
#pragma unroll
  for (int i = 0; i < NW; ++i) row[i] = r[i];
}

// SPLIT: part s of an Fq2 operand, the sum of entries i1 and i2 (i2 < 0:
// none) of the [.][2] rows at base: component 0 (s = 0), component 1
// (s = 1) or their sum (s = 2, Karatsuba's third product). Absent summands
// are the zero row 0, so every lane adds the same number of rows.
template <int NW, int ROW>
__device__ __forceinline__ void part_sum(uint32_t* r, const uint32_t* rows,
                                         int base, int i1, int i2, int s,
                                         const CurveConsts& c) {
  const int c0 = s == 1 ? 1 : 0;
  const bool both = s == 2;
  uint32_t t[NW];
  ld_row<NW>(r, rows + (base + i1 * 2 + c0) * ROW);
  ld_row<NW>(t, rows + (i2 >= 0 ? base + i2 * 2 + c0 : 0) * ROW);
  fp_add<NW>(r, r, t, c);
  ld_row<NW>(t, rows + (both ? base + i1 * 2 + 1 : 0) * ROW);
  fp_add<NW>(r, r, t, c);
  ld_row<NW>(t, rows + (both && i2 >= 0 ? base + i2 * 2 + 1 : 0) * ROW);
  fp_add<NW>(r, r, t, c);
}

// SPLIT: component comp of the Fq2 product whose three part rows start at
// row first: Karatsuba's v0 - v1 and v2 - (v0 + v1) (field.cuh fe_mul).
template <int NW, int ROW>
__device__ __forceinline__ void prod_comp(uint32_t* r, const uint32_t* rows,
                                          int first, int comp,
                                          const CurveConsts& c) {
  uint32_t v0[NW], v1[NW];
  ld_row<NW>(v0, rows + first * ROW);
  ld_row<NW>(v1, rows + (first + 1) * ROW);
  if (comp == 0) {
    fp_sub<NW>(r, v0, v1, c);
  } else {
    ld_row<NW>(r, rows + (first + 2) * ROW);
    fp_add<NW>(v0, v0, v1, c);
    fp_sub<NW>(r, r, v0, c);
  }
}

// SPLIT: part s (as part_sum) of the Fq2 value (u0, u1) times part s of 3b.
template <int NW>
__device__ __forceinline__ void b3_part(uint32_t* r, const uint32_t* u0,
                                        const uint32_t* u1, int s,
                                        const CurveConsts& c) {
  uint32_t kc[NW];
  if (s == 2) {
    fp_add<NW>(r, u0, u1, c);
    fp_add<NW>(kc, c.b3[0], c.b3[1], c);
  } else {
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      r[i] = s ? u1[i] : u0[i];
      kc[i] = s ? c.b3[1][i] : c.b3[0][i];
    }
  }
  fp_mul<NW>(r, r, kc, c);
}

// One team's lanes and slot. SPLIT (G2 only): a warp, each Fq2 product
// split into Karatsuba's three Fq products on three lanes; else 8 lanes,
// one Fe product (Fq, or a whole Fq2 product) a lane. RAW: words staged by
// cp.async ahead of the word rows (a point's limb rows for K3/K4, a leaf's
// packed words for K2, none for K5).
template <int NW, int EXT, bool SPLIT, int RAW>
struct Team {
  static_assert(EXT == 2 || !SPLIT, "only an Fq2 product splits");
  using F = Fe<NW, EXT>;
  static constexpr int T = SPLIT ? 32 : 8;     // lanes of a team
  static constexpr int P = SPLIT ? 3 : EXT;    // V rows of one Fe product
  static constexpr int ROW = NW + 1;           // words of a padded row
  static constexpr int S = 2 * NW * EXT;       // int32 limbs of a coordinate
  static constexpr int CH = 3 * S / 4;         // 16-byte chunks of a point
  static constexpr int NWE = NW * EXT;         // packed words of a coordinate
  // word rows of the slot
  static constexpr int ZERO = 0;               // [EXT] zero rows
  static constexpr int ACC = EXT;              // [3][EXT] accumulator, P
  static constexpr int LEAF = ACC + 3 * EXT;   // [3][EXT] element: Q, or X2, Y2, 3b
  static constexpr int V = LEAF + 3 * EXT;     // [6][P] L1 and L3 products
  static constexpr int OPS = V + 6 * P;        // [6][EXT] L3's operands
  static constexpr int W2 = OPS + 6 * EXT;     // SPLIT: [2][3] parts of the 3b products
  static constexpr int T1 = W2 + (SPLIT ? 6 : 0);  // SPLIT: [EXT] t1 (Alg. 7)
  static constexpr int NROWS = T1 + (SPLIT ? EXT : 0);
  // a slot: the staged words (16-byte aligned), then the word rows; a
  // multiple of 4 words, and 8 mod 32 where teams share a warp
  static constexpr int USED = RAW + NROWS * ROW;
  static constexpr int WORDS =
      T < 32 ? (USED + 23) / 32 * 32 + 8 : (USED + 3) / 4 * 4;

  const int lane;
  const unsigned mask;
  uint32_t* const raw;
  uint32_t* const rows;

  __device__ __forceinline__ explicit Team(uint32_t* smem)
      : lane(threadIdx.x % T),
        mask((0xFFFFFFFFu >> (32 - T)) << (threadIdx.x % 32 / T * T)),
        raw(smem + threadIdx.x / T * WORDS),
        rows(raw + RAW) {}

  // this thread's team in the grid
  static __device__ __forceinline__ long long index() {
    return (long long)blockIdx.x * (blockDim.x / T) + threadIdx.x / T;
  }

  __device__ __forceinline__ void sync() const { __syncwarp(mask); }
  __device__ __forceinline__ uint32_t* row(int r) const { return rows + r * ROW; }

  // the Fe whose EXT component rows start at row `first`
  __device__ __forceinline__ F ld(int first) const {
    F r;
#pragma unroll
    for (int k = 0; k < EXT; ++k) ld_row<NW>(r.v[k], row(first + k));
    return r;
  }
  __device__ __forceinline__ void st(int first, const F& a) const {
#pragma unroll
    for (int k = 0; k < EXT; ++k) st_row<NW>(row(first + k), a.v[k]);
  }

  // The zero rows; with `identity` the accumulator (0 : 1 : 0); with `b3`
  // the element's third coordinate rows 3b (Alg. 8).
  __device__ __forceinline__ void init(const CurveConsts& c, bool identity,
                                       bool b3) const {
    for (int r = lane; r < V; r += T) {
      const bool one = identity && r == ACC + EXT;
      const int k = r - LEAF - 2 * EXT;  // component k of 3b
      const bool kb = b3 && k >= 0;
      if (!(r < ACC || (identity && r < LEAF) || kb)) continue;
      for (int i = 0; i < NW; ++i)
        row(r)[i] = one ? c.one[i] : kb ? (k ? c.b3[1][i] : c.b3[0][i]) : 0u;
    }
  }

  // K3/K4: cp.async of point e's limb rows (coordinates x, y, z) into raw.
  // Chunk q of a point: coordinate q / (S/4), limbs 4 (q % (S/4)) ..+3,
  // which are words 2 (q % (S/4)) and the next of that coordinate.
  __device__ __forceinline__ void stage_point(const uint32_t* x,
                                              const uint32_t* y,
                                              const uint32_t* z,
                                              long long e) const {
    static_assert(RAW >= 3 * S, "the slot stages a point");
    for (int q = lane; q < CH; q += T) {
      const int i = q / (S / 4), o = 4 * (q % (S / 4));
      const uint32_t* src = i == 0 ? x : i == 1 ? y : z;
      __pipeline_memcpy_async(raw + i * S + o, src + e * S + o, 16);
    }
    __pipeline_commit();
  }

  // K3/K4: this lane's staged chunks -> the element's word rows
  __device__ __forceinline__ void convert_point() const {
    __pipeline_wait_prior(0);
    for (int q = lane; q < CH; q += T) {
      const int i = q / (S / 4), w = 2 * (q % (S / 4));
      const uint4 u = *reinterpret_cast<const uint4*>(raw + i * S + 2 * w);
      uint32_t* d = row(LEAF + i * EXT + w / NW) + w % NW;
      d[0] = (u.x & 0xFFFFu) | (u.y << 16);
      d[1] = (u.z & 0xFFFFu) | (u.w << 16);
    }
  }

  // K5: point e's limb rows straight into the word rows from `first` on
  __device__ __forceinline__ void load_point(int first, const uint32_t* x,
                                             const uint32_t* y,
                                             const uint32_t* z,
                                             long long e) const {
    for (int q = lane; q < CH; q += T) {
      const int i = q / (S / 4), w = 2 * (q % (S / 4));
      const uint32_t* src = i == 0 ? x : i == 1 ? y : z;
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(src + e * S + 2 * w));
      uint32_t* d = row(first + i * EXT + w / NW) + w % NW;
      d[0] = (u.x & 0xFFFFu) | (u.y << 16);
      d[1] = (u.z & 0xFFFFu) | (u.w << 16);
    }
  }

  // K2: cp.async of leaf s's packed words (row s of xw and of yw) into raw;
  // chunk q: coordinate q / (NWE/4), words 4 (q % (NWE/4)) ..+3.
  __device__ __forceinline__ void stage_leaf(const uint32_t* xw,
                                             const uint32_t* yw,
                                             long long s) const {
    static_assert(RAW >= 2 * NWE, "the slot stages a leaf");
    for (int q = lane; q < NWE / 2; q += T) {
      const int i = q / (NWE / 4), o = 4 * (q % (NWE / 4));
      __pipeline_memcpy_async(raw + i * NWE + o, (i ? yw : xw) + s * NWE + o, 16);
    }
    __pipeline_commit();
  }

  // K2: this lane's staged chunks -> the leaf's X2, Y2 rows, the infinity
  // flag (bit 31 of the top X word) cleared
  __device__ __forceinline__ void convert_leaf() const {
    __pipeline_wait_prior(0);
    for (int q = lane; q < NWE / 2; q += T) {
      const int i = q / (NWE / 4), w = 4 * (q % (NWE / 4));
      uint4 u = *reinterpret_cast<const uint4*>(raw + i * NWE + w);
      if (i == 0 && w + 4 == NWE) u.w &= 0x7FFFFFFFu;
      uint32_t* d = row(LEAF + i * EXT + w / NW) + w % NW;
      d[0] = u.x;
      d[1] = u.y;
      d[2] = u.z;
      d[3] = u.w;
    }
  }

  // the accumulator -> element e of (dx, dy, dz) as limb rows, 16 B a lane
  __device__ __forceinline__ void store(uint32_t* dx, uint32_t* dy,
                                        uint32_t* dz, long long e) const {
    for (int q = lane; q < CH; q += T) {
      const int i = q / (S / 4), w = 2 * (q % (S / 4));
      const uint32_t* s = row(ACC + i * EXT + w / NW) + w % NW;
      const uint32_t a0 = s[0], a1 = s[1];
      uint32_t* d = (i == 0 ? dx : i == 1 ? dy : dz) + e * S + 2 * w;
      *reinterpret_cast<uint4*>(d) =
          make_uint4(a0 & 0xFFFFu, a0 >> 16, a1 & 0xFFFFu, a1 >> 16);
    }
  }

  // L1 of Alg. 7 (MADD false) or Alg. 8 (MADD true): ACC and LEAF -> V
  template <bool MADD>
  __device__ __forceinline__ void l1(const CurveConsts& c) const {
    if constexpr (SPLIT) {  // part s = lane % 3 of product k = lane / 3
      if (lane < 18) {
        const int k = lane / 3, s = lane % 3;
        uint32_t a[NW], q[NW];
        part_sum<NW, ROW>(a, rows, ACC, MADD ? kM1A1[k] : kL1A[k],
                          MADD ? kM1A2[k] : kL1B[k], s, c);
        part_sum<NW, ROW>(q, rows, LEAF, MADD ? kM1B1[k] : kL1A[k],
                          MADD ? kM1A2[k] : kL1B[k], s, c);
        fp_mul<NW>(a, a, q, c);
        st_row<NW>(row(V + lane), a);
      }
    } else if (lane < 6) {  // product k = lane
      const int a1 = MADD ? kM1A1[lane] : kL1A[lane];
      const int b1 = MADD ? kM1B1[lane] : kL1A[lane];
      const int i2 = MADD ? kM1A2[lane] : kL1B[lane];
      const F a = fe_add<NW, EXT>(ld(ACC + a1 * EXT),
                                  ld(i2 >= 0 ? ACC + i2 * EXT : ZERO), c);
      const F q = fe_add<NW, EXT>(ld(LEAF + b1 * EXT),
                                  ld(i2 >= 0 ? LEAF + i2 * EXT : ZERO), c);
      st(V + lane * EXT, fe_mul<NW, EXT>(a, q, c));
    }
  }

  // L2 of the 8-lane team (kL2), one code path for the six lanes: the
  // lanes that multiply by 3b do so together, the others wait
  template <bool MADD>
  __device__ __forceinline__ void l2_lanes(const CurveConsts& c) const {
    if (lane < 6) {
      const int* k = kL2[MADD][lane];
      auto at = [&](int code) {
        return ld(code < 0 ? ZERO : code < 6 ? V + code * EXT : ACC + (code - 6) * EXT);
      };
      const F a = at(k[0]);
      const F s = fe_add<NW, EXT>(at(k[1]), at(k[2]), c);
      F x = k[3] ? fe_sub<NW, EXT>(a, s, c) : fe_add<NW, EXT>(a, s, c);
      if (const int mode = k[4]) {
        x = fe_mul_b3<NW, EXT>(x, c);
        if (mode > 1) {
          const F t1 = ld(V + EXT);
          x = mode == 2 ? fe_add<NW, EXT>(t1, x, c) : fe_sub<NW, EXT>(t1, x, c);
        }
      }
      st(OPS + lane * EXT, x);
    }
    sync();
  }

  // L2 of Alg. 7: V (t0, t1, t2, m3, m4, m5) -> OPS, with its syncs
  __device__ __forceinline__ void l2_add(const CurveConsts& c) const {
    if constexpr (!SPLIT) {
      l2_lanes<false>(c);
    } else {
      // L2a: lanes 0-5 the Karatsuba parts of 3b t2 (0-2) and 3b Y3 (3-5),
      // or with 3b = k + k u (b3_twist) 3b Y3, Z3 and t1' themselves, one
      // component a lane, with no L2b; lanes 6-13 t3, t4, 3 t0 and t1, one
      // component each
      if (kTwistB3<NW> && lane < 6 && c.b3_twist) {
        const int o = lane / 2, comp = lane % 2;
        uint32_t u[2][NW], m[NW], t[NW], r[NW];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          prod_comp<NW, ROW>(u[k], rows, V + 2 * P, k, c);  // t2
          if (o == 0) {  // Y3 = m5 - (t0 + t2)
            prod_comp<NW, ROW>(m, rows, V + 5 * P, k, c);
            prod_comp<NW, ROW>(t, rows, V, k, c);
            fp_add<NW>(t, t, u[k], c);
            fp_sub<NW>(u[k], m, t, c);
          }
        }
        fp2_twist_b3<NW>(r, u[0], u[1], comp, c);
        if (o > 0) {  // Z3 = t1 + 3b t2, t1' = t1 - 3b t2
          prod_comp<NW, ROW>(t, rows, V + P, comp, c);
          if (o == 1)
            fp_add<NW>(r, t, r, c);
          else
            fp_sub<NW>(r, t, r, c);
        }
        st_row<NW>(row(OPS + (3 + o) * EXT + comp), r);
      } else if (lane < 6) {
        uint32_t u[2][NW], m[NW], t[NW], a[NW];
#pragma unroll
        for (int comp = 0; comp < 2; ++comp) {
          prod_comp<NW, ROW>(u[comp], rows, V + 2 * P, comp, c);  // t2
          if (lane >= 3) {  // Y3 = m5 - (t0 + t2)
            prod_comp<NW, ROW>(m, rows, V + 5 * P, comp, c);
            prod_comp<NW, ROW>(t, rows, V, comp, c);
            fp_add<NW>(t, t, u[comp], c);
            fp_sub<NW>(u[comp], m, t, c);
          }
        }
        b3_part<NW>(a, u[0], u[1], lane % 3, c);
        st_row<NW>(row(W2 + lane), a);
      } else if (lane < 14) {
        const int o = (lane - 6) / 2, comp = lane % 2;
        uint32_t r[NW], u[NW], v[NW];
        if (o < 2) {  // t3 = m3 - (t0 + t1), t4 = m4 - (t1 + t2)
          prod_comp<NW, ROW>(u, rows, V + o * P, comp, c);
          prod_comp<NW, ROW>(v, rows, V + (o + 1) * P, comp, c);
          prod_comp<NW, ROW>(r, rows, V + (o + 3) * P, comp, c);
          fp_add<NW>(u, u, v, c);
          fp_sub<NW>(r, r, u, c);
          st_row<NW>(row(OPS + o * EXT + comp), r);
        } else if (o == 2) {  // 3 t0
          prod_comp<NW, ROW>(u, rows, V, comp, c);
          fp_add<NW>(r, u, u, c);
          fp_add<NW>(r, r, u, c);
          st_row<NW>(row(OPS + 2 * EXT + comp), r);
        } else {  // t1
          prod_comp<NW, ROW>(r, rows, V + P, comp, c);
          st_row<NW>(row(T1 + comp), r);
        }
      }
      sync();
      if (kTwistB3<NW> && c.b3_twist) return;
      // L2b: 3b Y3 (lanes 0-1), Z3 = t1 + 3b t2 (2-3), t1 - 3b t2 (4-5)
      if (lane < 6) {
        const int o = lane / 2, comp = lane % 2;
        uint32_t r[NW], t1[NW];
        prod_comp<NW, ROW>(r, rows, W2 + (o == 0 ? 3 : 0), comp, c);
        if (o > 0) {
          ld_row<NW>(t1, row(T1 + comp));
          if (o == 1)
            fp_add<NW>(r, t1, r, c);
          else
            fp_sub<NW>(r, t1, r, c);
        }
        st_row<NW>(row(OPS + (3 + o) * EXT + comp), r);
      }
      sync();
    }
  }

  // L2 of Alg. 8: V (t0, t1, m, X2 Z1, Y2 Z1, 3b Z1) and the accumulator's
  // X1, Y1 -> OPS, with its syncs
  __device__ __forceinline__ void l2_madd(const CurveConsts& c) const {
    if constexpr (!SPLIT) {
      l2_lanes<true>(c);
    } else {
      // L2a: lanes 0-2 the Karatsuba parts of 3b t4, or with 3b = k + k u
      // (b3_twist) lanes 0-1 3b t4 itself, one component a lane, with no
      // L2b; lanes 3-12 t3, t5, 3 t0, Z3 and t1', one component each
      if (lane < 3) {
        uint32_t u[2][NW], x[NW], a[NW];
#pragma unroll
        for (int comp = 0; comp < 2; ++comp) {  // t4 = X2 Z1 + X1
          prod_comp<NW, ROW>(u[comp], rows, V + 3 * P, comp, c);
          ld_row<NW>(x, row(ACC + comp));
          fp_add<NW>(u[comp], u[comp], x, c);
        }
        if (!(kTwistB3<NW> && c.b3_twist)) {
          b3_part<NW>(a, u[0], u[1], lane, c);
          st_row<NW>(row(W2 + lane), a);
        } else if (lane < 2) {
          fp2_twist_b3<NW>(a, u[0], u[1], lane, c);
          st_row<NW>(row(OPS + 3 * EXT + lane), a);
        }
      } else if (lane < 13) {
        const int o = (lane - 3) / 2, comp = (lane - 3) % 2;
        uint32_t r[NW], u[NW], v[NW];
        int dst;
        if (o == 0) {  // t3 = m - (t0 + t1)
          prod_comp<NW, ROW>(u, rows, V, comp, c);
          prod_comp<NW, ROW>(v, rows, V + P, comp, c);
          prod_comp<NW, ROW>(r, rows, V + 2 * P, comp, c);
          fp_add<NW>(u, u, v, c);
          fp_sub<NW>(r, r, u, c);
          dst = 0;
        } else if (o == 1) {  // t5 = Y2 Z1 + Y1
          prod_comp<NW, ROW>(r, rows, V + 4 * P, comp, c);
          ld_row<NW>(u, row(ACC + EXT + comp));
          fp_add<NW>(r, r, u, c);
          dst = 1;
        } else if (o == 2) {  // 3 t0
          prod_comp<NW, ROW>(u, rows, V, comp, c);
          fp_add<NW>(r, u, u, c);
          fp_add<NW>(r, r, u, c);
          dst = 2;
        } else {  // Z3 = t1 + 3b Z1 (o = 3), t1' = t1 - 3b Z1 (o = 4)
          prod_comp<NW, ROW>(u, rows, V + P, comp, c);
          prod_comp<NW, ROW>(v, rows, V + 5 * P, comp, c);
          if (o == 3)
            fp_add<NW>(r, u, v, c);
          else
            fp_sub<NW>(r, u, v, c);
          dst = o + 1;
        }
        st_row<NW>(row(OPS + dst * EXT + comp), r);
      }
      sync();
      if (kTwistB3<NW> && c.b3_twist) return;
      // L2b: 3b t4 (lanes 0-1)
      if (lane < 2) {
        uint32_t r[NW];
        prod_comp<NW, ROW>(r, rows, W2, lane, c);
        st_row<NW>(row(OPS + 3 * EXT + lane), r);
      }
      sync();
    }
  }

  // L3: product k of OPS entries kL3A[k] and kL3B[k] -> V
  __device__ __forceinline__ void l3(const CurveConsts& c) const {
    if constexpr (SPLIT) {
      if (lane < 18) {
        const int k = lane / 3, s = lane % 3;
        uint32_t a[NW], q[NW];
        part_sum<NW, ROW>(a, rows, OPS, kL3A[k], -1, s, c);
        part_sum<NW, ROW>(q, rows, OPS, kL3B[k], -1, s, c);
        fp_mul<NW>(a, a, q, c);
        st_row<NW>(row(V + lane), a);
      }
    } else if (lane < 6) {
      st(V + lane * EXT, fe_mul<NW, EXT>(ld(OPS + kL3A[lane] * EXT),
                                         ld(OPS + kL3B[lane] * EXT), c));
    }
  }

  // L1 to L3 of one step, each level followed by its sync: the operands
  // (ACC, LEAF) must be in place and synced
  template <bool MADD>
  __device__ __forceinline__ void products(const CurveConsts& c) const {
    l1<MADD>(c);
    sync();
    if constexpr (MADD)
      l2_madd(c);
    else
      l2_add(c);
    l3(c);
    sync();
  }

  // X3 = q0 - q1, Y3 = q2 + q3, Z3 = q4 + q5 into the accumulator (SPLIT:
  // one component a lane); the caller syncs after
  __device__ __forceinline__ void combine(const CurveConsts& c) const {
    if constexpr (SPLIT) {
      if (lane < 6) {
        const int i = lane / 2, comp = lane % 2;
        uint32_t u[NW], v[NW];
        prod_comp<NW, ROW>(u, rows, V + 2 * i * P, comp, c);
        prod_comp<NW, ROW>(v, rows, V + (2 * i + 1) * P, comp, c);
        if (i == 0)
          fp_sub<NW>(u, u, v, c);
        else
          fp_add<NW>(u, u, v, c);
        st_row<NW>(row(ACC + lane), u);
      }
    } else if (lane < 3) {
      const F u = ld(V + 2 * lane * EXT), v = ld(V + (2 * lane + 1) * EXT);
      st(ACC + lane * EXT, lane == 0 ? fe_sub<NW, EXT>(u, v, c)
                                     : fe_add<NW, EXT>(u, v, c));
    }
  }
};

// K3 (PREFIX) / K4: team g folds the points g*B .. g*B+B-1 from the
// identity with Alg. 7, writing every inclusive prefix W (PREFIX) and the
// total T[g].
template <int NW, int EXT, bool SPLIT, bool PREFIX>
__global__ void __launch_bounds__(256)
    rcb_team_scan(CurveConsts c, uint32_t* wx, uint32_t* wy, uint32_t* wz,
                  uint32_t* tx, uint32_t* ty, uint32_t* tz, const uint32_t* x,
                  const uint32_t* y, const uint32_t* z, long long ncols,
                  int B) {
  using L = Team<NW, EXT, SPLIT, 6 * NW * EXT>;
  extern __shared__ __align__(16) uint32_t smem[];
  const long long g = L::index();
  if (g >= ncols) return;  // the whole team
  const L t(smem);
  const long long e0 = g * B;
  t.stage_point(x, y, z, e0);
  t.init(c, true, false);
  t.convert_point();
  t.sync();
  for (int b = 0; b < B; ++b) {
    const long long e = e0 + b;
    if (b + 1 < B) t.stage_point(x, y, z, e + 1);
    t.template products<false>(c);
    t.combine(c);  // meanwhile every lane converts its chunks of point e + 1
    if (b + 1 < B) t.convert_point();
    t.sync();
    if constexpr (PREFIX) t.store(wx, wy, wz, e);
  }
  t.store(tx, ty, tz, g);
}

// K2: team g folds the affine leaves order[g*B] .. order[g*B+B-1] of the
// packed words xw, yw (order null: the leaves g*B .. g*B+B-1) from the
// identity with Alg. 8, writing every inclusive prefix W and the total
// T[g]. A leaf whose top X word has bit 31 set (the infinity flag) leaves
// the accumulator as it is; every lane of the team reads the same flag, so
// the branch is uniform in the team, and W is stored all the same.
template <int NW, int EXT, bool SPLIT>
__global__ void __launch_bounds__(256)
    rcb_team_madd_scan(CurveConsts c, uint32_t* wx, uint32_t* wy,
                       uint32_t* wz, uint32_t* tx, uint32_t* ty, uint32_t* tz,
                       const uint32_t* xw, const uint32_t* yw,
                       const long long* order, long long ncols, int B) {
  using L = Team<NW, EXT, SPLIT, 2 * NW * EXT>;
  constexpr int NWE = L::NWE;
  extern __shared__ __align__(16) uint32_t smem[];
  const long long g = L::index();
  if (g >= ncols) return;  // the whole team
  const L t(smem);
  const long long e0 = g * B;
  auto leaf = [&](long long e) { return order ? order[e] : e; };
  // the flag of each leaf is read when the leaf is staged, a step ahead;
  // s is the row of the next leaf to stage
  long long s = leaf(e0);
  t.stage_leaf(xw, yw, s);
  uint32_t flag = xw[s * NWE + NWE - 1] >> 31;
  if (B > 1) s = leaf(e0 + 1);
  t.init(c, true, true);
  t.convert_leaf();
  t.sync();
  for (int b = 0; b < B; ++b) {
    const long long e = e0 + b;
    uint32_t next = 0;
    if (b + 1 < B) {
      t.stage_leaf(xw, yw, s);
      next = xw[s * NWE + NWE - 1] >> 31;
      if (b + 2 < B) s = leaf(e + 2);
    }
    if (!flag) {
      t.template products<true>(c);
      t.combine(c);  // meanwhile every lane converts its chunks of leaf e + 1
    }
    if (b + 1 < B) t.convert_leaf();
    t.sync();
    t.store(wx, wy, wz, e);
    flag = next;
  }
  t.store(tx, ty, tz, g);
}

// The fixed-base MSM's windows: kFbWin digits of 8 bits a scalar of kFbLimbs
// canonical 16-bit limbs (digit w is byte w % 2 of limb w / 2), each picking
// one of kFbRows rows of its window's table.
constexpr int kFbWin = 32;
constexpr int kFbLimbs = 16;
constexpr int kFbRows = 256;

// K6, the fixed-base MSM: team g folds the table rows (w, digit w of scalar
// g), w = 0 .. kFbWin-1, of the packed words xw, yw (row w * kFbRows + d)
// from the identity with Alg. 8, and writes the total only. A zero digit
// picks row 0, the identity: the step is skipped and the row never read.
// The scalar's digits go into the slot once (its limbs as packed words, so
// byte w of them is digit w); the next live window's row is staged a step
// ahead, as K2 stages its next leaf.
template <int NW, int EXT, bool SPLIT>
__global__ void __launch_bounds__(256)
    rcb_team_fixed_base(CurveConsts c, uint32_t* ox, uint32_t* oy,
                        uint32_t* oz, const uint32_t* xw, const uint32_t* yw,
                        const uint32_t* sc, long long n) {
  using L = Team<NW, EXT, SPLIT, 2 * NW * EXT + kFbLimbs / 2>;
  constexpr int NWE = L::NWE;
  extern __shared__ __align__(16) uint32_t smem[];
  const long long g = L::index();
  if (g >= n) return;  // the whole team
  const L t(smem);
  uint32_t* const dw = t.raw + 2 * NWE;  // the digits, 4 a word
  if (t.lane < kFbLimbs / 2) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(sc + g * kFbLimbs) + t.lane);
    dw[t.lane] = (v.x & 0xFFFFu) | (v.y << 16);
  }
  t.init(c, true, true);
  t.sync();
  const uint8_t* const digit = reinterpret_cast<const uint8_t*>(dw);
  auto live = [&](int w) {  // the first window from w on with a digit, or kFbWin
    while (w < kFbWin && !digit[w]) ++w;
    return w;
  };
  auto row = [&](int w) { return (long long)w * kFbRows + digit[w]; };
  int w = live(0);
  if (w < kFbWin) {
    t.stage_leaf(xw, yw, row(w));
    t.convert_leaf();
  }
  t.sync();
  while (w < kFbWin) {
    const int next = live(w + 1);
    if (next < kFbWin) t.stage_leaf(xw, yw, row(next));
    t.template products<true>(c);
    t.combine(c);  // meanwhile every lane converts its chunks of the next row
    if (next < kFbWin) t.convert_leaf();
    t.sync();
    w = next;
  }
  t.store(ox, oy, oz, g);
}

// K5: team g adds point g of (x1, y1, z1) and of (x2, y2, z2) with Alg. 7.
template <int NW, int EXT, bool SPLIT>
__global__ void __launch_bounds__(256)
    rcb_team_add(CurveConsts c, uint32_t* ox, uint32_t* oy, uint32_t* oz,
                 const uint32_t* x1, const uint32_t* y1, const uint32_t* z1,
                 const uint32_t* x2, const uint32_t* y2, const uint32_t* z2,
                 long long n) {
  using L = Team<NW, EXT, SPLIT, 0>;
  extern __shared__ __align__(16) uint32_t smem[];
  const long long g = L::index();
  if (g >= n) return;  // the whole team
  const L t(smem);
  t.init(c, false, false);
  t.load_point(L::ACC, x1, y1, z1, g);
  t.load_point(L::LEAF, x2, y2, z2, g);
  t.sync();
  t.template products<false>(c);
  t.combine(c);
  t.sync();
  t.store(ox, oy, oz, g);
}

// Launches kern for n teams of the slot layout L on stream s, in blocks of
// team_block(ext, n) threads. Returns the error of a refused shared-memory
// attribute, else cudaSuccess (the caller reads cudaGetLastError()).
template <class L, class Kernel, class... Args>
cudaError_t launch_team(Kernel kern, int ext, long long n, cudaStream_t s,
                        Args... args) {
  const int threads = team_block(ext, n);
  const size_t smem = (size_t)(threads / L::T) * L::WORDS * sizeof(uint32_t);
  if (smem > 48 * 1024) {  // G2's 8-lane slots at 256 threads
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<blocks_for(n * L::T, threads), threads, smem, s>>>(args...);
  return cudaSuccess;
}

}  // namespace
}  // namespace zkp
