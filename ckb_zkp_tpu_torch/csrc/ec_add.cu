// K8 ec_add: replaces ckb_zkp_tpu/ops/pallas_ec.py:247 _ec_add_kernel (via
// _ec_add_fn, entry ec_add_pallas): the elementwise complete Jacobian add
// over Fq (G1) or Fq2 (G2), the point add of the Jacobian MSM engine
// (ops/ec.py ec_add: the bucket-prefix combines, the Hillis-Steele scans,
// the halving tree and the window folds of ops/msm.py).
//
// The 2^20 prove launches it at 1 to 16384 points, where one thread a point
// running the add's 16 dependent products (3x that over Fq2; 7 more where
// p == q) waits on one lane's latency and leaves most SMs idle. So the add
// runs on the team of lanes of ec_team.cuh (one product of a level a lane:
// six levels of products for the add, three for the doubling): 4 lanes a
// point for G1, and for G2 16 lanes (each Fq2 product on three) up to
// kEcSplitMax points, 4 above. The one-thread kernel (ec_jac.cuh jac_add;
// `thread` set in the entry) stays as the yardstick the per-shape checks
// hold the team against.
//
// The chain entry (zkp_ec_add_chain) runs the MSM's two window folds in one
// launch each, a team a point: the Horner fold sum_w 2^(cw) S_w of
// _msm_impl (W rounds of c doublings t + t and one add) and _window_sums'
// (2^c - 1) E_last - sum E_b (c doublings, two adds), where the loop of K8
// launches took W (c + 1) and c + 2 launches. The accumulator stays in the
// team's slot from the first step to the last; each step takes the branch
// jac_add takes (t + t of an infinite t is t), so the bits are the loop's.
//
// Bound on the H100 by the integer multiply rate: 16 field multiplies an
// add on the general branch (3x that over Fq2), against 9 coordinates of
// 64 B (128 B over Fq2) moved; the doubling (7 more) runs only where
// p == q. The entries launch on the caller's stream, allocate nothing, do
// not synchronise and return cudaGetLastError().
#include "ec_team.cuh"

namespace zkp {
namespace {

// One thread a point (nvcc's host stub names the kernels of one anonymous
// namespace a file only: this one lives in zkp's, beside the team kernels).
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
}  // namespace zkp

using namespace zkp;

namespace {

template <int EXT, bool SPLIT>
cudaError_t launch_add(const CurveConsts& c, uint32_t* ox, uint32_t* oy,
                       uint32_t* oz, const uint32_t* x1, const uint32_t* y1,
                       const uint32_t* z1, const uint32_t* x2,
                       const uint32_t* y2, const uint32_t* z2, long long n,
                       cudaStream_t s) {
  using L = EcTeam<kNW, EXT, SPLIT>;
  return launch_ec_team<L>(&ec_team_add<kNW, EXT, SPLIT>, n, s, c, ox, oy, oz,
                           x1, y1, z1, x2, y2, z2, n);
}

template <int EXT, bool SPLIT>
cudaError_t launch_chain(const CurveConsts& c, uint32_t* ox, uint32_t* oy,
                         uint32_t* oz, const uint32_t* ix, const uint32_t* iy,
                         const uint32_t* iz, const uint32_t* ax,
                         const uint32_t* ay, const uint32_t* az,
                         const Rounds& rounds, long long k, cudaStream_t s) {
  using L = EcTeam<kNW, EXT, SPLIT>;
  return launch_ec_team<L>(&ec_team_chain<kNW, EXT, SPLIT>, k, s, c, ox, oy,
                           oz, ix, iy, iz, ax, ay, az, rounds, k);
}

}  // namespace

// thread 0: the team (the path's kernel); 1: one thread a point (for the
// per-shape checks).
extern "C" int zkp_ec_add(const uint32_t* consts, int ext, int thread, void* ox,
                          void* oy, void* oz, const void* x1, const void* y1,
                          const void* z1, const void* x2, const void* y2,
                          const void* z2, long long n, void* stream) {
  if (consts[0] != kNW || n <= 0 || (ext != 1 && ext != 2) || (thread != 0 && thread != 1))
    return (int)cudaErrorInvalidValue;
  const CurveConsts c = parse_consts(consts);
  cudaStream_t s = (cudaStream_t)stream;
  auto u = [](const void* p) { return (const uint32_t*)p; };
  auto w = [](void* p) { return (uint32_t*)p; };
  int rc = 0;
  if (thread) {
    const unsigned grid = blocks_for(n, kThreads);
    if (ext == 1)
      ec_add_kernel<kNW, 1><<<grid, kThreads, 0, s>>>(
          c, w(ox), w(oy), w(oz), u(x1), u(y1), u(z1), u(x2), u(y2), u(z2), n);
    else
      ec_add_kernel<kNW, 2><<<grid, kThreads, 0, s>>>(
          c, w(ox), w(oy), w(oz), u(x1), u(y1), u(z1), u(x2), u(y2), u(z2), n);
  } else {
    decltype(&launch_add<1, false>) f = ext == 1 ? &launch_add<1, false>
                                        : ec_split(ext, n) ? &launch_add<2, true>
                                                           : &launch_add<2, false>;
    rc = (int)f(c, w(ox), w(oy), w(oz), u(x1), u(y1), u(z1), u(x2), u(y2),
                u(z2), n, s);
  }
  return rc ? rc : (int)cudaGetLastError();
}

// The chain: k points of (ix, iy, iz) as the start, `rounds` rounds, round r
// doubling dbl[r] times and adding point r * k + i of (ax, ay, az) to the
// accumulator of point i; the k totals into (ox, oy, oz).
extern "C" int zkp_ec_add_chain(const uint32_t* consts, int ext, void* ox,
                                void* oy, void* oz, const void* ix,
                                const void* iy, const void* iz, const void* ax,
                                const void* ay, const void* az,
                                const unsigned char* dbl, int rounds,
                                long long k, void* stream) {
  if (consts[0] != kNW || k <= 0 || (ext != 1 && ext != 2) || rounds < 0 ||
      rounds > kChainMax)
    return (int)cudaErrorInvalidValue;
  const CurveConsts c = parse_consts(consts);
  Rounds r{};
  r.n = rounds;
  for (int i = 0; i < rounds; ++i) r.dbl[i] = dbl[i];
  auto u = [](const void* p) { return (const uint32_t*)p; };
  auto w = [](void* p) { return (uint32_t*)p; };
  decltype(&launch_chain<1, false>) f = ext == 1 ? &launch_chain<1, false>
                                        : ec_split(ext, k) ? &launch_chain<2, true>
                                                           : &launch_chain<2, false>;
  const int rc = (int)f(c, w(ox), w(oy), w(oz), u(ix), u(iy), u(iz), u(ax),
                        u(ay), u(az), r, k, (cudaStream_t)stream);
  return rc ? rc : (int)cudaGetLastError();
}
