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
// and 4096 for K3 and K4), a warp a chain for G2 up to kSplitMax.
#include "rcb_team.cuh"

using namespace zkp;

namespace {

template <int EXT, bool SPLIT, bool PREFIX>
cudaError_t launch_add(const CurveConsts& c, uint32_t* wx, uint32_t* wy,
                       uint32_t* wz, uint32_t* tx, uint32_t* ty, uint32_t* tz,
                       const uint32_t* x, const uint32_t* y, const uint32_t* z,
                       long long ncols, int B, cudaStream_t s) {
  using L = Team<kNW, EXT, SPLIT, 6 * kNW * EXT>;
  return launch_team<L>(&rcb_team_scan<kNW, EXT, SPLIT, PREFIX>, EXT, ncols, s,
                        c, wx, wy, wz, tx, ty, tz, x, y, z, ncols, B);
}

template <int EXT, bool SPLIT>
cudaError_t launch_madd(const CurveConsts& c, uint32_t* wx, uint32_t* wy,
                        uint32_t* wz, uint32_t* tx, uint32_t* ty, uint32_t* tz,
                        const uint32_t* xw, const uint32_t* yw,
                        const long long* order, long long ncols, int B,
                        cudaStream_t s) {
  using L = Team<kNW, EXT, SPLIT, 2 * kNW * EXT>;
  return launch_team<L>(&rcb_team_madd_scan<kNW, EXT, SPLIT>, EXT, ncols, s, c,
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

namespace zkp {

// K3 (prefix) or K4 (totals only); the inputs are checked by zkp_rcb_scan.
// Returns the error of a refused shared-memory attribute, else cudaSuccess.
int launch_rcb_team_scan(const CurveConsts& c, int ext, bool prefix,
                         uint32_t* wx, uint32_t* wy, uint32_t* wz,
                         uint32_t* tx, uint32_t* ty, uint32_t* tz,
                         const uint32_t* x, const uint32_t* y,
                         const uint32_t* z, long long ncols, int B,
                         cudaStream_t s) {
  decltype(&launch_add<1, false, false>) f;
  if (ext == 1)
    f = prefix ? &launch_add<1, false, true> : &launch_add<1, false, false>;
  else if (team_split(ext, ncols))
    f = prefix ? &launch_add<2, true, true> : &launch_add<2, true, false>;
  else
    f = prefix ? &launch_add<2, false, true> : &launch_add<2, false, false>;
  return (int)f(c, wx, wy, wz, tx, ty, tz, x, y, z, ncols, B, s);
}

// K2 over the packed leaves xw, yw read through order (null: in order); the
// inputs are checked by zkp_rcb_scan. Returns as launch_rcb_team_scan.
int launch_rcb_team_madd_scan(const CurveConsts& c, int ext, uint32_t* wx,
                              uint32_t* wy, uint32_t* wz, uint32_t* tx,
                              uint32_t* ty, uint32_t* tz, const uint32_t* xw,
                              const uint32_t* yw, const long long* order,
                              long long ncols, int B, cudaStream_t s) {
  decltype(&launch_madd<1, false>) f;
  if (ext == 1)
    f = &launch_madd<1, false>;
  else if (team_split(ext, ncols))
    f = &launch_madd<2, true>;
  else
    f = &launch_madd<2, false>;
  return (int)f(c, wx, wy, wz, tx, ty, tz, xw, yw, order, ncols, B, s);
}

}  // namespace zkp
