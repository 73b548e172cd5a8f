// K5 rcb_add: replaces ckb_zkp_tpu/ops/pallas_rcb.py _add_kernel (via
// _add_fn, entry rcb_add_pallas): the elementwise complete projective add
// (Alg. 7, a = 0) over Fq (G1) or Fq2 (G2).
//
// The prover's MSM launches it 480 times a G2 MSM and as often a G1 one, at
// 2^17, 64, 2 and 1 points (ops/msm.py: bucket boundaries, Hillis-Steele
// top, weighting, window fold). At a few points one thread running Alg. 7's
// twelve products in a row (36 over Fq2, with spills) is a single lane's
// latency; so a team of lanes adds one pair of points with the three-level
// step of rcb_team.cuh (8 lanes; for G2 up to kSplitMax points a warp, each
// Fq2 product on three lanes), with no chain: p and q go from their limb
// rows straight into the team's word rows, and the sum leaves in 16-B
// stores by the team. At 2^17 points the bound is the integer multiply
// rate (12 field multiplies an add, 3x that over Fq2, against 9
// coordinates of 4 NW B, twice that over Fq2), and the team's extra
// instructions make G1 slower there than one thread a point (PERF.md).
// Instances at NW = 8 (BN254) and 12 (BLS12-381), picked by consts[0].
// The entry launches on the caller's stream, allocates nothing, does not
// synchronise and returns cudaGetLastError().
#include "rcb_team.cuh"

using namespace zkp;

namespace {

template <int NW, int EXT, bool SPLIT>
cudaError_t launch(const CurveConsts& c, uint32_t* ox, uint32_t* oy,
                   uint32_t* oz, const uint32_t* x1, const uint32_t* y1,
                   const uint32_t* z1, const uint32_t* x2, const uint32_t* y2,
                   const uint32_t* z2, long long n, cudaStream_t s) {
  using L = Team<NW, EXT, SPLIT, 0>;
  return launch_team<L>(&rcb_team_add<NW, EXT, SPLIT>, EXT, n, s, c, ox, oy,
                        oz, x1, y1, z1, x2, y2, z2, n);
}

// the launcher of width NW for (ext, n)
template <int NW>
decltype(&launch<NW, 1, false>) pick(int ext, long long n) {
  return ext == 1 ? &launch<NW, 1, false>
         : team_split(ext, n) ? &launch<NW, 2, true>
                              : &launch<NW, 2, false>;
}

}  // namespace

extern "C" int zkp_rcb_add(const uint32_t* consts, int ext, void* ox,
                           void* oy, void* oz, const void* x1, const void* y1,
                           const void* z1, const void* x2, const void* y2,
                           const void* z2, long long n, void* stream) {
  if (!rcb_width(consts[0]) || n <= 0 || (ext != 1 && ext != 2))
    return (int)cudaErrorInvalidValue;
  const CurveConsts c = parse_consts(consts);
  // the split G2 team multiplies by 3b as an Fq2 product, not an add chain
  if (ext == 2 && c.b3_small) return (int)cudaErrorInvalidValue;
  auto u = [](const void* p) { return (const uint32_t*)p; };
  auto w = [](void* p) { return (uint32_t*)p; };
  const auto f = consts[0] == kNW ? pick<kNW>(ext, n) : pick<kNW12>(ext, n);
  const int rc = (int)f(c, w(ox), w(oy), w(oz), u(x1), u(y1), u(z1), u(x2),
                        u(y2), u(z2), n, (cudaStream_t)stream);
  return rc ? rc : (int)cudaGetLastError();
}
