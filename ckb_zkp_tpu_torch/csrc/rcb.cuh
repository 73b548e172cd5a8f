// Projective points and the Renes-Costello-Batina mixed add (a = 0) shared
// by the port's one-thread point kernels (rcb_madd.cu, rcb_scan.cu, the
// probes), and the host-side helpers of the C entries. The team kernels
// (rcb_team.cuh) run Alg. 7 and Alg. 8 split into levels over lanes.
//
// Points are homogeneous projective (X : Y : Z) with the identity
// (0 : 1 : 0); in device memory each coordinate is the reference's row of
// 16-bit limbs in int32 lanes ((N, L) for Fq, (N, 2, L) for Fq2). The
// formulas are the reference's ops/rcb.py step for step, so the outputs
// are bit-equal to its XLA and Pallas versions.
#pragma once

#include <cuda_runtime.h>

#include "field.cuh"

namespace zkp {

// Word counts of the instances. K1-K6 (mont_mul.cu, rcb_team_scan.cu via
// rcb_scan.cu modes 0-2, rcb_add.cu, rcb_fixed_base.cu) are built for both
// kNW (BN254) and kNW12 (BLS12-381) and pick one from consts[0]; every
// other entry (the Jacobian engine's, the elementwise K6, K2a, K2b and the
// probes) is built for kNW only and refuses any other width.
constexpr int kNW = 8;
constexpr int kNW12 = 12;
constexpr int kThreads = 128;

// consts[0] names one of the two instances of K1-K6
inline bool rcb_width(uint32_t nw) { return nw == kNW || nw == kNW12; }

// constants arrive as a flat uint32 buffer from the host
// (cuda_field.kernel_consts):
// [nw, ninv, b3_small, p[12], one[12], b3_c0[12], b3_c1[12]]
inline CurveConsts parse_consts(const uint32_t* h) {
  CurveConsts c;
  c.ninv = h[1];
  c.b3_small = h[2];
  for (int i = 0; i < MAXW; ++i) {
    c.p[i] = h[3 + i];
    c.one[i] = h[3 + MAXW + i];
    c.b3[0][i] = h[3 + 2 * MAXW + i];
    c.b3[1][i] = h[3 + 3 * MAXW + i];
  }
  return c;
}

inline unsigned blocks_for(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

template <int NW, int EXT>
struct Pt {
  Fe<NW, EXT> X, Y, Z;
};

template <int NW, int EXT>
__device__ __forceinline__ Pt<NW, EXT> identity(const CurveConsts& c) {
  return {fe_zero<NW, EXT>(), fe_one<NW, EXT>(c), fe_zero<NW, EXT>()};
}

// Alg. 8 (Q = (x2, y2, 1), Q not the identity), as ops/rcb.py madd_noinf.
// Its eleven multiplies (the two by 3b aside) go through the policy mul
// (CIOS by default; mont_tc.cuh TcMul in the tensor-core scan probes).
template <int NW, int EXT, class Mul = CiosMul>
__device__ __forceinline__ Pt<NW, EXT> rcb_madd(const Pt<NW, EXT>& p,
                                                const Fe<NW, EXT>& X2,
                                                const Fe<NW, EXT>& Y2,
                                                const CurveConsts& c,
                                                const Mul& mul = Mul()) {
  using F = Fe<NW, EXT>;
  F t0 = mul(p.X, X2, c);
  F t1 = mul(p.Y, Y2, c);
  F t3 = mul(fe_add<NW, EXT>(X2, Y2, c), fe_add<NW, EXT>(p.X, p.Y, c), c);
  t3 = fe_sub<NW, EXT>(t3, fe_add<NW, EXT>(t0, t1, c), c);
  F t4 = fe_add<NW, EXT>(mul(X2, p.Z, c), p.X, c);
  F t5 = fe_add<NW, EXT>(mul(Y2, p.Z, c), p.Y, c);
  F X3 = fe_add<NW, EXT>(t0, t0, c);
  t0 = fe_add<NW, EXT>(X3, t0, c);
  F t2 = fe_mul_b3<NW, EXT>(p.Z, c);
  F Z3 = fe_add<NW, EXT>(t1, t2, c);
  t1 = fe_sub<NW, EXT>(t1, t2, c);
  F Y3 = fe_mul_b3<NW, EXT>(t4, c);
  Pt<NW, EXT> r;
  r.X = fe_sub<NW, EXT>(mul(t3, t1, c), mul(t5, Y3, c), c);
  r.Y = fe_add<NW, EXT>(mul(t1, Z3, c), mul(Y3, t0, c), c);
  r.Z = fe_add<NW, EXT>(mul(Z3, t5, c), mul(t0, t3, c), c);
  return r;
}

template <int NW, int EXT>
__device__ __forceinline__ Pt<NW, EXT> load_pt(const uint32_t* x,
                                               const uint32_t* y,
                                               const uint32_t* z,
                                               long long e) {
  constexpr int S = 2 * NW * EXT;
  return {load_limbs<NW, EXT>(x + e * S), load_limbs<NW, EXT>(y + e * S),
          load_limbs<NW, EXT>(z + e * S)};
}

template <int NW, int EXT>
__device__ __forceinline__ void store_pt(uint32_t* x, uint32_t* y,
                                         uint32_t* z, long long e,
                                         const Pt<NW, EXT>& p) {
  constexpr int S = 2 * NW * EXT;
  store_limbs<NW, EXT>(x + e * S, p.X);
  store_limbs<NW, EXT>(y + e * S, p.Y);
  store_limbs<NW, EXT>(z + e * S, p.Z);
}

}  // namespace zkp
