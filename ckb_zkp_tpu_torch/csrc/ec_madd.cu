// K9a ec_madd: replaces ckb_zkp_tpu/ops/pallas_ec.py:259 _ec_madd_kernel
// (via _ec_madd_fn, entry ec_madd_pallas): the elementwise Jacobian p plus
// an affine (x2, y2) with an infinity flag, over Fq (G1) or Fq2 (G2). The
// Jacobian engine's fixed-base MSM (ops/msm.py _fixed_base_impl) calls it
// once per 8-bit window on the gathered window-table rows.
//
// One thread per element, as K6. The flag is a byte array (a bool tensor),
// so the table rows are read as they are. (x2, y2) are read for every
// element: where p is infinity the result is (x2, y2, one), or (x2, y2, 0)
// for a flagged q, as in the reference. Bound on the H100 by the integer
// multiply rate: 11 field multiplies on the general branch (3x that over
// Fq2), against 8 coordinates of 64 B (128 B over Fq2) and one flag byte
// moved; the doubling (7 more) runs only where p == q. The entry launches
// on the caller's stream, allocates nothing, does not synchronise and
// returns cudaGetLastError().
#include "ec_jac.cuh"

using namespace zkp;

namespace {

template <int NW, int EXT>
__global__ void ec_madd_kernel(CurveConsts c, uint32_t* ox, uint32_t* oy,
                               uint32_t* oz, const uint32_t* x1,
                               const uint32_t* y1, const uint32_t* z1,
                               const uint32_t* x2, const uint32_t* y2,
                               const uint8_t* inf2, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  constexpr int S = 2 * NW * EXT;
  const Pt<NW, EXT> p = load_pt<NW, EXT>(x1, y1, z1, i);
  const Fe<NW, EXT> X2 = load_limbs<NW, EXT>(x2 + i * S);
  const Fe<NW, EXT> Y2 = load_limbs<NW, EXT>(y2 + i * S);
  store_pt<NW, EXT>(ox, oy, oz, i,
                    jac_madd<NW, EXT>(p, X2, Y2, inf2[i] != 0, c));
}

}  // namespace

extern "C" int zkp_ec_madd(const uint32_t* consts, int ext, void* ox,
                           void* oy, void* oz, const void* x1,
                           const void* y1, const void* z1, const void* x2,
                           const void* y2, const void* inf2, long long n,
                           void* stream) {
  if (consts[0] != kNW || n <= 0 || (ext != 1 && ext != 2))
    return (int)cudaErrorInvalidValue;
  const CurveConsts c = parse_consts(consts);
  const unsigned grid = blocks_for(n, kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  auto u = [](const void* p) { return (const uint32_t*)p; };
  const uint8_t* f = (const uint8_t*)inf2;
  if (ext == 1)
    ec_madd_kernel<kNW, 1><<<grid, kThreads, 0, s>>>(
        c, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, u(x1), u(y1), u(z1),
        u(x2), u(y2), f, n);
  else
    ec_madd_kernel<kNW, 2><<<grid, kThreads, 0, s>>>(
        c, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, u(x1), u(y1), u(z1),
        u(x2), u(y2), f, n);
  return (int)cudaGetLastError();
}
