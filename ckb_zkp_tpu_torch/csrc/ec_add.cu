// K8 ec_add: replaces ckb_zkp_tpu/ops/pallas_ec.py:247 _ec_add_kernel (via
// _ec_add_fn, entry ec_add_pallas): the elementwise complete Jacobian add
// over Fq (G1) or Fq2 (G2), the point add of the Jacobian MSM engine
// (ops/ec.py ec_add: the bucket-prefix combines, the Hillis-Steele scans
// and the window fold of ops/msm.py).
//
// One thread per element, as the TPU kernel's lanes, with 32-bit words
// instead of limb-major 16-bit rows (ec_jac.cuh). Bound on the H100 by the
// integer multiply rate: 16 field multiplies on the general branch (3x
// that over Fq2), against 9 coordinates of 64 B (128 B over Fq2) moved; the
// doubling (7 more) runs only where p == q. The entry launches on the
// caller's stream, allocates nothing, does not synchronise and returns
// cudaGetLastError().
#include "ec_jac.cuh"

using namespace zkp;

namespace {

template <int NW, int EXT>
__global__ void ec_add_kernel(CurveConsts c, uint32_t* ox, uint32_t* oy,
                              uint32_t* oz, const uint32_t* x1,
                              const uint32_t* y1, const uint32_t* z1,
                              const uint32_t* x2, const uint32_t* y2,
                              const uint32_t* z2, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Pt<NW, EXT> p = load_pt<NW, EXT>(x1, y1, z1, i);
  const Pt<NW, EXT> q = load_pt<NW, EXT>(x2, y2, z2, i);
  store_pt<NW, EXT>(ox, oy, oz, i, jac_add<NW, EXT>(p, q, c));
}

}  // namespace

extern "C" int zkp_ec_add(const uint32_t* consts, int ext, void* ox,
                          void* oy, void* oz, const void* x1, const void* y1,
                          const void* z1, const void* x2, const void* y2,
                          const void* z2, long long n, void* stream) {
  if (consts[0] != kNW || n <= 0 || (ext != 1 && ext != 2))
    return (int)cudaErrorInvalidValue;
  const CurveConsts c = parse_consts(consts);
  const unsigned grid = blocks_for(n, kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  auto u = [](const void* p) { return (const uint32_t*)p; };
  if (ext == 1)
    ec_add_kernel<kNW, 1><<<grid, kThreads, 0, s>>>(
        c, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, u(x1), u(y1), u(z1),
        u(x2), u(y2), u(z2), n);
  else
    ec_add_kernel<kNW, 2><<<grid, kThreads, 0, s>>>(
        c, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, u(x1), u(y1), u(z1),
        u(x2), u(y2), u(z2), n);
  return (int)cudaGetLastError();
}
