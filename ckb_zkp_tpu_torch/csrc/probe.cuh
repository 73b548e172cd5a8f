// Device helpers shared by the probe kernels (probe_scan.cu, probe_grid.cu):
// packed-word stores and a branch-free select of field elements.
#pragma once

#include "field.cuh"

namespace zkp {

// a as packed words (two limbs per word, pack_limbs): EXT * NW words
template <int NW, int EXT>
__device__ __forceinline__ void store_words(uint32_t* dst,
                                            const Fe<NW, EXT>& a) {
  uint4* d4 = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int q = 0; q < EXT * NW / 4; ++q) {
    const int w = 4 * q;
    d4[q] = make_uint4(a.v[w / NW][w % NW], a.v[(w + 1) / NW][(w + 1) % NW],
                       a.v[(w + 2) / NW][(w + 2) % NW],
                       a.v[(w + 3) / NW][(w + 3) % NW]);
  }
}

template <int NW, int EXT>
__device__ __forceinline__ Fe<NW, EXT> fe_select(bool keep,
                                                 const Fe<NW, EXT>& a,
                                                 const Fe<NW, EXT>& b) {
  Fe<NW, EXT> r;
#pragma unroll
  for (int k = 0; k < EXT; ++k)
#pragma unroll
    for (int i = 0; i < NW; ++i) r.v[k][i] = keep ? a.v[k][i] : b.v[k][i];
  return r;
}

}  // namespace zkp
