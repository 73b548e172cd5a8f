// Montgomery prime-field and Fq2 arithmetic for the port's CUDA kernels.
//
// Elements are NW little-endian 32-bit words (NW = 8 for BN254, 12 for
// BLS12-381), in Montgomery form with R = 2^(32 NW). In device memory they
// are stored as the reference's 16-bit limbs in int32 lanes ((N, L) for Fq,
// (N, 2, L) for Fq2, L = 2 NW); two limbs form one word, so R and the
// Montgomery form are the reference's. Every operation returns the
// canonical representative (< p), so results are bit-equal to the
// reference's XLA and Pallas field code.
//
// Bound: the multiply is CIOS with 64-bit accumulators, 2 NW^2 32x32->64
// products per call; the card's integer multiply rate bounds every kernel
// here. Requires p < 2^(32 NW - 1), so sums of two canonical values never
// overflow NW words (true of BN254 and BLS12-381).
#pragma once

#include <cstdint>

namespace zkp {

constexpr int MAXW = 12;

struct CurveConsts {
  uint32_t p[MAXW];
  uint32_t one[MAXW];      // R mod p: 1 in Montgomery form
  uint32_t b3[2][MAXW];    // 3b in Montgomery form (c0, c1)
  uint32_t ninv;           // -p^-1 mod 2^32
  uint32_t b3_small;       // 3b when it is a small integer (G1), else 0
};

// ---------------------------------------------------------------- Fq
template <int NW>
__device__ __forceinline__ void fp_cond_sub(uint32_t* r, const uint32_t* s,
                                            uint32_t top,
                                            const CurveConsts& c) {
  // r = s - p if (top:s) >= p else s
  uint32_t d[NW];
  int64_t br = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    int64_t t = (int64_t)s[i] - (int64_t)c.p[i] + br;
    d[i] = (uint32_t)t;
    br = t >> 32;  // 0 or -1
  }
  const bool ge = (top != 0) || (br == 0);
#pragma unroll
  for (int i = 0; i < NW; ++i) r[i] = ge ? d[i] : s[i];
}

template <int NW>
__device__ __forceinline__ void fp_add(uint32_t* r, const uint32_t* a,
                                       const uint32_t* b,
                                       const CurveConsts& c) {
  uint32_t s[NW];
  uint64_t acc = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    acc += (uint64_t)a[i] + b[i];
    s[i] = (uint32_t)acc;
    acc >>= 32;
  }
  fp_cond_sub<NW>(r, s, (uint32_t)acc, c);
}

template <int NW>
__device__ __forceinline__ void fp_sub(uint32_t* r, const uint32_t* a,
                                       const uint32_t* b,
                                       const CurveConsts& c) {
  uint32_t d[NW];
  int64_t br = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    int64_t t = (int64_t)a[i] - (int64_t)b[i] + br;
    d[i] = (uint32_t)t;
    br = t >> 32;
  }
  const uint32_t mask = br ? 0xFFFFFFFFu : 0u;  // borrow: add p back
  uint64_t acc = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    acc += (uint64_t)d[i] + (c.p[i] & mask);
    r[i] = (uint32_t)acc;
    acc >>= 32;
  }
}

// CIOS Montgomery product a * b * R^-1 mod p, canonical output.
template <int NW>
__device__ __forceinline__ void fp_mul(uint32_t* r, const uint32_t* a,
                                       const uint32_t* b,
                                       const CurveConsts& c) {
  uint32_t t[NW + 2];
#pragma unroll
  for (int i = 0; i < NW + 2; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t acc = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      acc += (uint64_t)a[j] * b[i] + t[j];
      t[j] = (uint32_t)acc;
      acc >>= 32;
    }
    acc += t[NW];
    t[NW] = (uint32_t)acc;
    t[NW + 1] = (uint32_t)(acc >> 32);
    const uint32_t m = t[0] * c.ninv;
    acc = ((uint64_t)m * c.p[0] + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < NW; ++j) {
      acc += (uint64_t)m * c.p[j] + t[j];
      t[j - 1] = (uint32_t)acc;
      acc >>= 32;
    }
    acc += t[NW];
    t[NW - 1] = (uint32_t)acc;
    t[NW] = t[NW + 1] + (uint32_t)(acc >> 32);
  }
  fp_cond_sub<NW>(r, t, t[NW], c);  // t < 2p
}

// ------------------------------------------------- Fq (EXT 1) / Fq2 (EXT 2)
template <int NW, int EXT>
struct Fe {
  uint32_t v[EXT][NW];
};

template <int NW, int EXT>
__device__ __forceinline__ Fe<NW, EXT> fe_add(const Fe<NW, EXT>& a,
                                              const Fe<NW, EXT>& b,
                                              const CurveConsts& c) {
  Fe<NW, EXT> r;
#pragma unroll
  for (int k = 0; k < EXT; ++k) fp_add<NW>(r.v[k], a.v[k], b.v[k], c);
  return r;
}

template <int NW, int EXT>
__device__ __forceinline__ Fe<NW, EXT> fe_sub(const Fe<NW, EXT>& a,
                                              const Fe<NW, EXT>& b,
                                              const CurveConsts& c) {
  Fe<NW, EXT> r;
#pragma unroll
  for (int k = 0; k < EXT; ++k) fp_sub<NW>(r.v[k], a.v[k], b.v[k], c);
  return r;
}

// Fq2 = Fq[u]/(u^2 + 1): Karatsuba with beta = -1, as ops/ec.py DeviceFq2.
template <int NW, int EXT>
__device__ __forceinline__ Fe<NW, EXT> fe_mul(const Fe<NW, EXT>& a,
                                              const Fe<NW, EXT>& b,
                                              const CurveConsts& c) {
  Fe<NW, EXT> r;
  if constexpr (EXT == 1) {
    fp_mul<NW>(r.v[0], a.v[0], b.v[0], c);
  } else {
    uint32_t v0[NW], v1[NW], sa[NW], sb[NW], v2[NW];
    fp_mul<NW>(v0, a.v[0], b.v[0], c);
    fp_mul<NW>(v1, a.v[1], b.v[1], c);
    fp_add<NW>(sa, a.v[0], a.v[1], c);
    fp_add<NW>(sb, b.v[0], b.v[1], c);
    fp_mul<NW>(v2, sa, sb, c);
    fp_sub<NW>(r.v[0], v0, v1, c);
    fp_add<NW>(sa, v0, v1, c);
    fp_sub<NW>(r.v[1], v2, sa, c);
  }
  return r;
}

// The CIOS multiply as a multiply policy, for code generic in its field
// multiply (rcb.cuh rcb_madd); mont_tc.cuh TcMul is the other. Both are
// built from (fragment table, shared slice), which CIOS does not use.
struct CiosMul {
  __device__ __forceinline__ CiosMul() {}
  __device__ __forceinline__ CiosMul(const uint4*, uint32_t*) {}
  template <int NW, int EXT>
  __device__ __forceinline__ Fe<NW, EXT> operator()(const Fe<NW, EXT>& a,
                                                    const Fe<NW, EXT>& b,
                                                    const CurveConsts& c) const {
    return fe_mul<NW, EXT>(a, b, c);
  }
};

template <int NW, int EXT>
__device__ __forceinline__ Fe<NW, EXT> fe_zero() {
  Fe<NW, EXT> r;
#pragma unroll
  for (int k = 0; k < EXT; ++k)
#pragma unroll
    for (int i = 0; i < NW; ++i) r.v[k][i] = 0;
  return r;
}

template <int NW, int EXT>
__device__ __forceinline__ Fe<NW, EXT> fe_one(const CurveConsts& c) {
  Fe<NW, EXT> r = fe_zero<NW, EXT>();
#pragma unroll
  for (int i = 0; i < NW; ++i) r.v[0][i] = c.one[i];
  return r;
}

// 3b * t: a short add chain when 3b is a small integer (BN254 G1: 9),
// else one multiply by the Montgomery-form constant (the G2 twist).
template <int NW, int EXT>
__device__ __forceinline__ Fe<NW, EXT> fe_mul_b3(const Fe<NW, EXT>& t,
                                                 const CurveConsts& c) {
  if (c.b3_small) {
    Fe<NW, EXT> res = t, base = t;
    bool have = false;
    uint32_t n = c.b3_small;
    while (n) {
      if (n & 1) {
        res = have ? fe_add<NW, EXT>(res, base, c) : base;
        have = true;
      }
      n >>= 1;
      if (n) base = fe_add<NW, EXT>(base, base, c);
    }
    return res;
  }
  Fe<NW, EXT> k;
#pragma unroll
  for (int e = 0; e < EXT; ++e)
#pragma unroll
    for (int i = 0; i < NW; ++i) k.v[e][i] = c.b3[e][i];
  return fe_mul<NW, EXT>(t, k, c);
}

// ------------------------------------------------ 16-bit limb rows <-> words
// One element = EXT * 2 NW int32 lanes holding 16-bit limbs.
template <int NW, int EXT>
__device__ __forceinline__ Fe<NW, EXT> load_limbs(const uint32_t* src) {
  Fe<NW, EXT> r;
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int q = 0; q < EXT * NW / 2; ++q) {
    const uint4 u = s4[q];
    const int w = 2 * q;
    r.v[w / NW][w % NW] = (u.x & 0xFFFFu) | (u.y << 16);
    r.v[(w + 1) / NW][(w + 1) % NW] = (u.z & 0xFFFFu) | (u.w << 16);
  }
  return r;
}

template <int NW, int EXT>
__device__ __forceinline__ void store_limbs(uint32_t* dst,
                                            const Fe<NW, EXT>& a) {
  uint4* d4 = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int q = 0; q < EXT * NW / 2; ++q) {
    const int w = 2 * q;
    const uint32_t a0 = a.v[w / NW][w % NW];
    const uint32_t a1 = a.v[(w + 1) / NW][(w + 1) % NW];
    d4[q] = make_uint4(a0 & 0xFFFFu, a0 >> 16, a1 & 0xFFFFu, a1 >> 16);
  }
}

// packed words (two limbs per word, pack_limbs): EXT * NW words
template <int NW, int EXT>
__device__ __forceinline__ Fe<NW, EXT> load_words(const uint32_t* src) {
  Fe<NW, EXT> r;
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int q = 0; q < EXT * NW / 4; ++q) {
    const uint4 u = s4[q];
    const int w = 4 * q;
    r.v[w / NW][w % NW] = u.x;
    r.v[(w + 1) / NW][(w + 1) % NW] = u.y;
    r.v[(w + 2) / NW][(w + 2) % NW] = u.z;
    r.v[(w + 3) / NW][(w + 3) % NW] = u.w;
  }
  return r;
}

}  // namespace zkp
