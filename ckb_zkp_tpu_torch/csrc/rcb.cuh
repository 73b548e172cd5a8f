// Projective points and the Renes-Costello-Batina formulas (a = 0) shared
// by the port's point kernels (rcb_add.cu, rcb_madd.cu, rcb_scan.cu), and
// the host-side helpers of their C entries.
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

// Only NW = 8 (BN254) is instantiated; BLS12-381 (NW = 12) comes later.
constexpr int kNW = 8;
constexpr int kThreads = 128;

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

// Renes-Costello-Batina Alg. 7 (a = 0), step for step as ops/rcb.py add.
template <int NW, int EXT>
__device__ __forceinline__ Pt<NW, EXT> rcb_add(const Pt<NW, EXT>& p,
                                               const Pt<NW, EXT>& q,
                                               const CurveConsts& c) {
  using F = Fe<NW, EXT>;
  F t0 = fe_mul<NW, EXT>(p.X, q.X, c);
  F t1 = fe_mul<NW, EXT>(p.Y, q.Y, c);
  F t2 = fe_mul<NW, EXT>(p.Z, q.Z, c);
  F t3 = fe_mul<NW, EXT>(fe_add<NW, EXT>(p.X, p.Y, c),
                         fe_add<NW, EXT>(q.X, q.Y, c), c);
  t3 = fe_sub<NW, EXT>(t3, fe_add<NW, EXT>(t0, t1, c), c);
  F t4 = fe_mul<NW, EXT>(fe_add<NW, EXT>(p.Y, p.Z, c),
                         fe_add<NW, EXT>(q.Y, q.Z, c), c);
  t4 = fe_sub<NW, EXT>(t4, fe_add<NW, EXT>(t1, t2, c), c);
  F X3 = fe_mul<NW, EXT>(fe_add<NW, EXT>(p.X, p.Z, c),
                         fe_add<NW, EXT>(q.X, q.Z, c), c);
  F Y3 = fe_sub<NW, EXT>(X3, fe_add<NW, EXT>(t0, t2, c), c);
  X3 = fe_add<NW, EXT>(t0, t0, c);
  t0 = fe_add<NW, EXT>(X3, t0, c);
  t2 = fe_mul_b3<NW, EXT>(t2, c);
  F Z3 = fe_add<NW, EXT>(t1, t2, c);
  t1 = fe_sub<NW, EXT>(t1, t2, c);
  Y3 = fe_mul_b3<NW, EXT>(Y3, c);
  Pt<NW, EXT> r;
  r.X = fe_sub<NW, EXT>(fe_mul<NW, EXT>(t3, t1, c),
                        fe_mul<NW, EXT>(t4, Y3, c), c);
  r.Y = fe_add<NW, EXT>(fe_mul<NW, EXT>(t1, Z3, c),
                        fe_mul<NW, EXT>(Y3, t0, c), c);
  r.Z = fe_add<NW, EXT>(fe_mul<NW, EXT>(Z3, t4, c),
                        fe_mul<NW, EXT>(t0, t3, c), c);
  return r;
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
