// K6 rcb_madd: replaces ckb_zkp_tpu/ops/pallas_rcb.py:204 _madd_kernel (via
// _madd_fn, entry rcb_madd_pallas): the elementwise mixed add
// p + (x2, y2, inf) of a projective point and an affine point with an
// infinity flag, over Fq (G1) or Fq2 (G2). Alg. 8 (a = 0, Z2 = 1), then p
// where the flag is set, as the reference's _rcb_madd_core.
//
// The setup's fixed-base MSM calls it once per 8-bit window on the gathered
// window-table rows (ops/msm.py fixed_base_msm). One thread per element, as
// K5; the flag is its own byte array (a bool tensor), not bit 31 of X as in
// K2's packed leaves, so the table rows are read as they are. A flagged
// element skips the formula and the (x2, y2) loads. Bound on the H100 by
// the integer multiply rate: 11 field multiplies per element (3x that over
// Fq2), against 8 coordinates of 64 B (128 B over Fq2) and one flag byte
// moved. The entry launches on the caller's stream, allocates nothing,
// does not synchronise and returns cudaGetLastError().
#include "rcb.cuh"

using namespace zkp;

namespace {

template <int NW, int EXT>
__global__ void rcb_madd_kernel(CurveConsts c, uint32_t* ox, uint32_t* oy,
                                uint32_t* oz, const uint32_t* x1,
                                const uint32_t* y1, const uint32_t* z1,
                                const uint32_t* x2, const uint32_t* y2,
                                const uint8_t* inf2, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Pt<NW, EXT> p = load_pt<NW, EXT>(x1, y1, z1, i);
  if (inf2[i]) {
    store_pt<NW, EXT>(ox, oy, oz, i, p);
    return;
  }
  constexpr int S = 2 * NW * EXT;
  const Fe<NW, EXT> X2 = load_limbs<NW, EXT>(x2 + i * S);
  const Fe<NW, EXT> Y2 = load_limbs<NW, EXT>(y2 + i * S);
  store_pt<NW, EXT>(ox, oy, oz, i, rcb_madd<NW, EXT>(p, X2, Y2, c));
}

}  // namespace

extern "C" int zkp_rcb_madd(const uint32_t* consts, int ext, void* ox,
                            void* oy, void* oz, const void* x1,
                            const void* y1, const void* z1, const void* x2,
                            const void* y2, const void* inf2, long long n,
                            void* stream) {
  if (consts[0] != kNW || n <= 0 || (ext != 1 && ext != 2))
    return (int)cudaErrorInvalidValue;
  const CurveConsts c = parse_consts(consts);
  if (!b3_fits(c, ext, kNW)) return (int)cudaErrorInvalidValue;
  const unsigned grid = blocks_for(n, kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  auto u = [](const void* p) { return (const uint32_t*)p; };
  const uint8_t* f = (const uint8_t*)inf2;
  if (ext == 1)
    rcb_madd_kernel<kNW, 1><<<grid, kThreads, 0, s>>>(
        c, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, u(x1), u(y1), u(z1),
        u(x2), u(y2), f, n);
  else
    rcb_madd_kernel<kNW, 2><<<grid, kThreads, 0, s>>>(
        c, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, u(x1), u(y1), u(z1),
        u(x2), u(y2), f, n);
  return (int)cudaGetLastError();
}
