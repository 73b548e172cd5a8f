// The tensor-core Montgomery multiply fp_mul_tc<NW>: the card's
// counterpart of K7, the reference's int8 MXU reduction
// (ckb_zkp_tpu/ops/pallas_field.py:249 _mont_reduce_cols_mxu, with
// mxu_band_consts :194 and _band_matmul :232, reached through
// pallas_rcb.py:95 _FRcbMxu).
//
// Warp-collective, one element per lane: every lane of the warp must call
// it together (no lane may have left), with the same frag and its warp's
// slice sh of kTcWords shared words.
//   1. t = a * b, a schoolbook product over 32-bit words on the integer
//      multipliers (2 NW^2 IMADs for the low and high halves).
//   2. The low NW words of t are 32 bytes per element. With the constant
//      band of n''s bytes as A (32 output byte columns x 32 input bytes,
//      two m16 tiles) and the warp's 32 elements as B (32 bytes x 8
//      elements, four n8 tiles), 8 mma.m16n8k32.u8 give the 32 byte
//      columns q of (t mod R) * n'.
//   3. Each lane carries its 32 columns into the bytes of m = t n' mod R.
//   4. The band of p's bytes (64 x 32, four m16 tiles) gives the 64 byte
//      columns u of m * p: 16 mma.
//   5. Each lane gathers its u columns into words, adds t, ripples, takes
//      the high NW words and subtracts p if needed.
// Exact: u8 x u8 < 2^16 and a 32-term column sum < 2^21 in the s32
// accumulator, so no shift or row-sum correction is needed (the TPU has
// only s8); the column sums are the same integers as the reference's, and
// the output is bit-equal to fp_mul (field.cuh) and to the reference.
//
// Fragment layouts (PTX ISA, mma.m16n8k32 with .u8/.s8 operands; lane =
// 4 * group + tq):
//   A (16 x 32, row): a0..a3 = row group, cols 4 tq .. 4 tq + 3;
//     a4..a7 row group + 8, same cols; a8..a15 the same rows at 16 + 4 tq.
//     Four bytes per register, lowest index in the lowest byte. The host
//     lays them out per tile and lane (ops/mont_tc.fragment_table), so a
//     lane loads its A operand as one uint4.
//   B (32 x 8, col): b0..b3 = rows 4 tq .. 4 tq + 3 of column group,
//     b4..b7 rows 16 + 4 tq ..; with t's bytes little-endian in words that
//     is word tq and word tq + 4 of element group.
//   C/D (16 x 8, s32): c0, c1 = row group, cols 2 tq, 2 tq + 1; c2, c3 =
//     row group + 8, same cols.
// Moving bytes between "one element per lane" and those layouts goes
// through the warp's shared slice: the words in rows of 12 (a B read by
// group and tq, and a lane's uint4 stores, are free of bank conflicts) and
// the columns in rows of 36 (a D scatter and a lane's uint4 reads are
// too), with __syncwarp() between writes and reads.
//
// Cost: about 1 KB of shared traffic per multiply (t and m: 2 x 32 B
// written and read; q and u: 96 x 4 B written and read) against the 136
// IMADs of CIOS's reduction it replaces; the prediction is no faster than
// CIOS. wgmma is later work.
#pragma once

#include <cstdint>

#include "field.cuh"

namespace zkp {

constexpr int kTcWordRow = 12;  // words per element: 8 used
constexpr int kTcColRow = 36;   // columns per element: 32 used
constexpr int kTcWords = 32 * kTcWordRow + 32 * kTcColRow;  // per warp

// dynamic shared memory of the kernels in the files that include this one
extern __shared__ __align__(16) unsigned char zkp_dyn_smem[];

__device__ __forceinline__ void mma_u8(int (&d)[4], const uint4& a, uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// D (32 columns of tiles tile0, tile0 + 1) = band * bytes of the words in
// wrow, scattered to crow[element * kTcColRow + column].
__device__ __forceinline__ void tc_band32(const uint4* frag, int tile0,
                                          const uint32_t* wrow, int* crow,
                                          int lane) {
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const uint4 a = __ldg(frag + (tile0 + mt) * 32 + lane);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t* src = wrow + (8 * j + g) * kTcWordRow;
      int d[4] = {0, 0, 0, 0};
      mma_u8(d, a, src[tq], src[tq + 4]);
      int* dst = crow + (8 * j + 2 * tq) * kTcColRow + 16 * mt + g;
      dst[0] = d[0];
      dst[kTcColRow] = d[1];
      dst[8] = d[2];
      dst[kTcColRow + 8] = d[3];
    }
  }
}

template <int NW>
__device__ __forceinline__ void fp_mul_tc(uint32_t* r, const uint32_t* a,
                                          const uint32_t* b,
                                          const CurveConsts& c,
                                          const uint4* frag, uint32_t* sh) {
  static_assert(NW == 8, "the byte bands are 32 bytes wide: NW = 8 (BN254)");
  const int lane = threadIdx.x & 31;
  uint32_t* wrow = sh;
  int* crow = reinterpret_cast<int*>(sh + 32 * kTcWordRow);
  uint32_t* mine = wrow + lane * kTcWordRow;
  const int* cols = crow + lane * kTcColRow;

  // 1. t = a * b
  uint32_t t[2 * NW];
#pragma unroll
  for (int i = 0; i < 2 * NW; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t acc = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      acc += (uint64_t)a[j] * b[i] + t[i + j];
      t[i + j] = (uint32_t)acc;
      acc >>= 32;
    }
    t[i + NW] = (uint32_t)acc;
  }

  // 2. q = bytes of (t mod R) x band(n')
  reinterpret_cast<uint4*>(mine)[0] = make_uint4(t[0], t[1], t[2], t[3]);
  reinterpret_cast<uint4*>(mine)[1] = make_uint4(t[4], t[5], t[6], t[7]);
  __syncwarp();
  tc_band32(frag, 0, wrow, crow, lane);
  __syncwarp();

  // 3. carry the columns into the bytes of m
  uint32_t m[NW];
  uint32_t carry = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const int4 q = reinterpret_cast<const int4*>(cols)[w];
    const int qs[4] = {q.x, q.y, q.z, q.w};
    uint32_t word = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t cur = (uint32_t)qs[k] + carry;
      word |= (cur & 0xFFu) << (8 * k);
      carry = cur >> 8;
    }
    m[w] = word;
  }
  __syncwarp();
  reinterpret_cast<uint4*>(mine)[0] = make_uint4(m[0], m[1], m[2], m[3]);
  reinterpret_cast<uint4*>(mine)[1] = make_uint4(m[4], m[5], m[6], m[7]);
  __syncwarp();

  // 4-5. u = bytes of m x band(p), 32 columns at a time, added to t
  uint32_t s[2 * NW];
  uint64_t acc = 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    tc_band32(frag, 2 + 2 * h, wrow, crow, lane);
    __syncwarp();
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const int4 u = reinterpret_cast<const int4*>(cols)[w];
      acc += (uint64_t)t[NW * h + w] + (uint64_t)(uint32_t)u.x +
             ((uint64_t)(uint32_t)u.y << 8) + ((uint64_t)(uint32_t)u.z << 16) +
             ((uint64_t)(uint32_t)u.w << 24);
      s[NW * h + w] = (uint32_t)acc;
      acc >>= 32;
    }
    __syncwarp();
  }
  fp_cond_sub<NW>(r, s + NW, (uint32_t)acc, c);  // t + m p < 2 R p
}

// The tensor-core multiply as a multiply policy (CiosMul, field.cuh, is
// the other) for code generic in its field multiply (rcb.cuh rcb_madd).
struct TcMul {
  const uint4* frag;
  uint32_t* sh;  // this warp's kTcWords
  __device__ __forceinline__ TcMul(const uint4* f, uint32_t* s) : frag(f), sh(s) {}
  template <int NW, int EXT>
  __device__ __forceinline__ Fe<NW, EXT> operator()(const Fe<NW, EXT>& a,
                                                    const Fe<NW, EXT>& b,
                                                    const CurveConsts& c) const {
    static_assert(EXT == 1, "the tensor-core multiply is instantiated for Fq");
    Fe<NW, EXT> r;
    fp_mul_tc<NW>(r.v[0], a.v[0], b.v[0], c, frag, sh);
    return r;
  }
};

// the warp's slice of the block's dynamic shared memory
__device__ __forceinline__ uint32_t* tc_warp_smem() {
  return reinterpret_cast<uint32_t*>(zkp_dyn_smem) + (threadIdx.x >> 5) * kTcWords;
}

}  // namespace zkp
