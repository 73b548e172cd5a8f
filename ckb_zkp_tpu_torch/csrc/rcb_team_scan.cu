// K2, K3 and K4 on a team of lanes a chain (rcb_team.cuh), modes 0, 1 and 2
// of the C entry zkp_rcb_scan (rcb_scan.cu). They replace three _scan_fn
// kernels of ckb_zkp_tpu/ops/pallas_rcb.py: _scan_prefix_madd_packedf_kernel
// (K2: every inclusive prefix W and the block total T of sorted affine
// leaves, packed two limbs a word with the infinity flag in bit 31 of the
// top X word, mixed adds), _scan_prefix_add_kernel (K3: W and T of
// projective points) and _scan_total_add_kernel (K4: T only). Each block of
// B elements is folded from the identity (0 : 1 : 0) in order, with Alg. 8
// (K2) or Alg. 7 (K3, K4).
//
// K2 reads its leaves through the sort order: leaf e of the scan is row
// order[e] of the unsorted packed arrays, so the MSM's window no longer
// writes sorted copies of the leaves (two torch gathers) for the kernel to
// read back. A team stages the next leaf's 64 B (G1) or 128 B (G2) by
// cp.async, 16 B a lane, while a step multiplies.
//
// Team shapes (rcb_team.cuh): 8 lanes a chain for G1 and for G2 above
// kSplitMax chains (the prove's widest launches: 65536 chains for K2, 2048
// and 4096 for K3 and K4), a warp a chain for G2 up to kSplitMax. Each
// kernel has an instance at NW = 8 (BN254) and at NW = 12 (BLS12-381);
// the team shape and block size depend on (ext, n) only, so
// zkp_rcb_team_lanes and zkp_rcb_team_block describe both.
#include "rcb_team.cuh"

using namespace zkp;

namespace {

template <int NW, int EXT, bool SPLIT, bool PREFIX>
cudaError_t launch_add(const CurveConsts& c, uint32_t* wx, uint32_t* wy,
                       uint32_t* wz, uint32_t* tx, uint32_t* ty, uint32_t* tz,
                       const uint32_t* x, const uint32_t* y, const uint32_t* z,
                       long long ncols, int B, cudaStream_t s) {
  using L = Team<NW, EXT, SPLIT, 6 * NW * EXT>;
  return launch_team<L>(&rcb_team_scan<NW, EXT, SPLIT, PREFIX>, EXT, ncols, s,
                        c, wx, wy, wz, tx, ty, tz, x, y, z, ncols, B);
}

template <int NW, int EXT, bool SPLIT>
cudaError_t launch_madd(const CurveConsts& c, uint32_t* wx, uint32_t* wy,
                        uint32_t* wz, uint32_t* tx, uint32_t* ty, uint32_t* tz,
                        const uint32_t* xw, const uint32_t* yw,
                        const long long* order, long long ncols, int B,
                        cudaStream_t s) {
  using L = Team<NW, EXT, SPLIT, 2 * NW * EXT>;
  return launch_team<L>(&rcb_team_madd_scan<NW, EXT, SPLIT>, EXT, ncols, s, c,
                        wx, wy, wz, tx, ty, tz, xw, yw, order, ncols, B);
}

}  // namespace

// Lanes of one team for n chains or points: 32 (G2, split) or 8.
extern "C" int zkp_rcb_team_lanes(int ext, long long n) {
  return team_lanes(ext, n);
}

// Threads per block of a team kernel for n chains or points.
extern "C" int zkp_rcb_team_block(int ext, long long n) {
  return team_block(ext, n);
}

namespace {

template <int NW>
decltype(&launch_add<NW, 1, false, false>) pick_add(int ext, bool prefix,
                                                    long long ncols) {
  if (ext == 1)
    return prefix ? &launch_add<NW, 1, false, true> : &launch_add<NW, 1, false, false>;
  if (team_split(ext, ncols))
    return prefix ? &launch_add<NW, 2, true, true> : &launch_add<NW, 2, true, false>;
  return prefix ? &launch_add<NW, 2, false, true> : &launch_add<NW, 2, false, false>;
}

template <int NW>
decltype(&launch_madd<NW, 1, false>) pick_madd(int ext, long long ncols) {
  if (ext == 1) return &launch_madd<NW, 1, false>;
  return team_split(ext, ncols) ? &launch_madd<NW, 2, true> : &launch_madd<NW, 2, false>;
}

}  // namespace

namespace zkp {

// K3 (prefix) or K4 (totals only) at nw words (kNW or kNW12); the inputs
// are checked by zkp_rcb_scan. Returns the error of a refused shared-memory
// attribute, else cudaSuccess.
int launch_rcb_team_scan(const CurveConsts& c, int nw, int ext, bool prefix,
                         uint32_t* wx, uint32_t* wy, uint32_t* wz,
                         uint32_t* tx, uint32_t* ty, uint32_t* tz,
                         const uint32_t* x, const uint32_t* y,
                         const uint32_t* z, long long ncols, int B,
                         cudaStream_t s) {
  const auto f = nw == kNW ? pick_add<kNW>(ext, prefix, ncols)
                           : pick_add<kNW12>(ext, prefix, ncols);
  return (int)f(c, wx, wy, wz, tx, ty, tz, x, y, z, ncols, B, s);
}

// K2 at nw words over the packed leaves xw, yw read through order (null:
// in order); the inputs are checked by zkp_rcb_scan. Returns as
// launch_rcb_team_scan.
int launch_rcb_team_madd_scan(const CurveConsts& c, int nw, int ext,
                              uint32_t* wx, uint32_t* wy, uint32_t* wz,
                              uint32_t* tx, uint32_t* ty, uint32_t* tz,
                              const uint32_t* xw, const uint32_t* yw,
                              const long long* order, long long ncols, int B,
                              cudaStream_t s) {
  const auto f = nw == kNW ? pick_madd<kNW>(ext, ncols) : pick_madd<kNW12>(ext, ncols);
  return (int)f(c, wx, wy, wz, tx, ty, tz, xw, yw, order, ncols, B, s);
}

}  // namespace zkp
