// Jacobian points and the complete a = 0 formulas of the Jacobian MSM
// engine's kernels (ec_add.cu K8, ec_madd.cu K9a, ec_scan.cu K9b/K9c).
//
// A point is (X, Y, Z) with affine (X / Z^2, Y / Z^3) and Z = 0 at
// infinity; in device memory each coordinate is the reference's row of
// 16-bit limbs in int32 lanes, as in rcb.cuh (whose Pt, load_pt and
// store_pt these kernels share). The formulas are the reference's
// ckb_zkp_tpu/ops/pallas_ec.py _double_core, _add_core and _madd_core.
// Jacobian representatives are not unique, so the kernels keep the
// reference's result exactly where it selects: p infinite gives q (in
// _madd_core (x2, y2, one), or (x2, y2, 0) for a flagged q); q infinite
// gives p; p == q gives the doubling of p; p == -q runs the general sum,
// whose Z is then 0. The TPU kernels compute every branch and select; here
// a thread computes only the branch it takes, so the doubling runs only on
// the elements that need it. Every field value is canonical, so equal
// formulas give bit-equal outputs.
#pragma once

#include "rcb.cuh"

namespace zkp {

template <int NW, int EXT>
__device__ __forceinline__ bool fe_is_zero(const Fe<NW, EXT>& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int k = 0; k < EXT; ++k)
#pragma unroll
    for (int i = 0; i < NW; ++i) acc |= a.v[k][i];
  return acc == 0;
}

// (one, one, 0): the accumulator's start in K9b/K9c, as the TPU kernels'.
template <int NW, int EXT>
__device__ __forceinline__ Pt<NW, EXT> jac_infinity(const CurveConsts& c) {
  return {fe_one<NW, EXT>(c), fe_one<NW, EXT>(c), fe_zero<NW, EXT>()};
}

// _double_core (a = 0): 2 p, 7 multiplies. Out of line: only the elements
// with p == q take it.
template <int NW, int EXT>
__device__ __noinline__ Pt<NW, EXT> jac_double(const Pt<NW, EXT>& p,
                                               const CurveConsts& c) {
  using F = Fe<NW, EXT>;
  const F A = fe_mul(p.X, p.X, c);
  const F B = fe_mul(p.Y, p.Y, c);
  const F C = fe_mul(B, B, c);
  const F XB = fe_add(p.X, B, c);
  const F t = fe_sub(fe_mul(XB, XB, c), fe_add(A, C, c), c);
  const F D = fe_add(t, t, c);
  const F E = fe_add(fe_add(A, A, c), A, c);
  Pt<NW, EXT> r;
  r.X = fe_sub(fe_mul(E, E, c), fe_add(D, D, c), c);
  F C8 = fe_add(C, C, c);
  C8 = fe_add(C8, C8, c);
  C8 = fe_add(C8, C8, c);
  r.Y = fe_sub(fe_mul(E, fe_sub(D, r.X, c), c), C8, c);
  const F YZ = fe_mul(p.Y, p.Z, c);
  r.Z = fe_add(YZ, YZ, c);
  return r;
}

// _add_core: complete p + q, 16 multiplies on the general branch.
template <int NW, int EXT>
__device__ __forceinline__ Pt<NW, EXT> jac_add(const Pt<NW, EXT>& p,
                                               const Pt<NW, EXT>& q,
                                               const CurveConsts& c) {
  using F = Fe<NW, EXT>;
  if (fe_is_zero(p.Z)) return q;
  if (fe_is_zero(q.Z)) return p;
  const F Z1Z1 = fe_mul(p.Z, p.Z, c);
  const F Z2Z2 = fe_mul(q.Z, q.Z, c);
  const F U1 = fe_mul(p.X, Z2Z2, c);
  const F U2 = fe_mul(q.X, Z1Z1, c);
  const F S1 = fe_mul(p.Y, fe_mul(q.Z, Z2Z2, c), c);
  const F S2 = fe_mul(q.Y, fe_mul(p.Z, Z1Z1, c), c);
  const F H = fe_sub(U2, U1, c);
  const F r = fe_sub(S2, S1, c);
  if (fe_is_zero(H) && fe_is_zero(r)) return jac_double(p, c);
  const F HH = fe_mul(H, H, c);
  const F HHH = fe_mul(H, HH, c);
  const F V = fe_mul(U1, HH, c);
  Pt<NW, EXT> o;
  o.X = fe_sub(fe_sub(fe_mul(r, r, c), HHH, c), fe_add(V, V, c), c);
  o.Y = fe_sub(fe_mul(r, fe_sub(V, o.X, c), c), fe_mul(S1, HHH, c), c);
  o.Z = fe_mul(fe_mul(p.Z, q.Z, c), H, c);
  return o;
}

// _madd_core: p + (x2, y2) with q's infinity flag, Z2 in {0, one} implied;
// 11 multiplies on the general branch.
template <int NW, int EXT>
__device__ __forceinline__ Pt<NW, EXT> jac_madd(const Pt<NW, EXT>& p,
                                                const Fe<NW, EXT>& X2,
                                                const Fe<NW, EXT>& Y2,
                                                bool qinf,
                                                const CurveConsts& c) {
  using F = Fe<NW, EXT>;
  if (fe_is_zero(p.Z))
    return {X2, Y2, qinf ? fe_zero<NW, EXT>() : fe_one<NW, EXT>(c)};
  if (qinf) return p;
  const F Z1Z1 = fe_mul(p.Z, p.Z, c);
  const F U2 = fe_mul(X2, Z1Z1, c);
  const F S2 = fe_mul(Y2, fe_mul(p.Z, Z1Z1, c), c);
  const F H = fe_sub(U2, p.X, c);
  const F r = fe_sub(S2, p.Y, c);
  if (fe_is_zero(H) && fe_is_zero(r)) return jac_double(p, c);
  const F HH = fe_mul(H, H, c);
  const F HHH = fe_mul(H, HH, c);
  const F V = fe_mul(p.X, HH, c);
  Pt<NW, EXT> o;
  o.X = fe_sub(fe_sub(fe_mul(r, r, c), HHH, c), fe_add(V, V, c), c);
  o.Y = fe_sub(fe_mul(r, fe_sub(V, o.X, c), c), fe_mul(p.Y, HHH, c), c);
  o.Z = fe_mul(p.Z, H, c);
  return o;
}

}  // namespace zkp
