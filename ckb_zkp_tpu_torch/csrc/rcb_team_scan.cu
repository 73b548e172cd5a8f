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
// kernel has an instance at NW = 8 (BN254) and at NW = 12 (BLS12-381),
// with the team shape and block size of (ext, n). At NW = 12, K2 runs
// rcb_wide.cuh's three-lane team for G2 from its width threshold on;
// zkp_rcb_shape describes every launch of K2-K6.
#include "rcb_wide.cuh"

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
  if constexpr (NW == kNW12) {
    if (ext == 2 && wide_design(NW, ext, 0, ncols)) return &launch_wide_madd_scan<NW>;
  }
  if (ext == 1) return &launch_madd<NW, 1, false>;
  return team_split(ext, ncols) ? &launch_madd<NW, 2, true> : &launch_madd<NW, 2, false>;
}

// the slot layout of a team kernel (kernel 0: K2, 1: K3/K4, 2: K5, 3: K6)
template <int NW, int EXT, bool SPLIT>
int team_words(int kernel) {
  constexpr int NWE = NW * EXT;
  switch (kernel) {
    case 0: return Team<NW, EXT, SPLIT, 2 * NWE>::WORDS;
    case 1: return Team<NW, EXT, SPLIT, 6 * NWE>::WORDS;
    case 2: return Team<NW, EXT, SPLIT, 0>::WORDS;
    default: return Team<NW, EXT, SPLIT, 2 * NWE + kFbLimbs / 2>::WORDS;
  }
}

template <int NW>
int team_slot_words(int ext, bool split, int kernel) {
  return ext == 1 ? team_words<NW, 1, false>(kernel)
         : split  ? team_words<NW, 2, true>(kernel)
                  : team_words<NW, 2, false>(kernel);
}

}  // namespace

// The launch of kernel `kernel` (0: K2, 1: K3 or K4, 2: K5, 3: K6's
// fixed-base MSM) for n chains or points at nw words over Fq (ext 1) or
// Fq2 (ext 2), as the entries pick it: out[0] lanes a chain or point,
// out[1] threads a block, out[2] shared memory bytes a block (a team
// kernel's dynamic slots, a wide kernel's static buffers), out[3] the
// design: 0 the 8-lane team, 1 the warp team, 2 one thread a point (K6 G1
// at eight words), 3 one thread a chain or point (rcb_wide.cuh, G1), 4
// three lanes a chain or point (rcb_wide.cuh, G2). Returns
// cudaErrorInvalidValue for a width, ext or kernel no entry takes.
extern "C" int zkp_rcb_shape(int nw, int ext, int kernel, long long n, int* out) {
  if (!rcb_width((uint32_t)nw) || (ext != 1 && ext != 2) || kernel < 0 || kernel > 3 ||
      n <= 0)
    return (int)cudaErrorInvalidValue;
  if (wide_design(nw, ext, kernel, n)) {
    out[0] = ext == 1 ? 1 : 3;
    out[1] = kWideBlock;
    out[2] = wide_smem(ext);
    out[3] = ext == 1 ? 3 : 4;
  } else if (kernel == 3 && ext == 1) {
    out[0] = 1;
    out[1] = 256;
    out[2] = 0;
    out[3] = 2;
  } else {
    const bool split = team_split(ext, n);
    out[0] = team_lanes(ext, n);
    out[1] = team_block(ext, n);
    out[2] = out[1] / out[0] *
             (nw == kNW ? team_slot_words<kNW>(ext, split, kernel)
                        : team_slot_words<kNW12>(ext, split, kernel)) * 4;
    out[3] = split ? 1 : 0;
  }
  return 0;
}

// The least width (chains for K2, kernel 0; points for K6, kernel 3) at
// which a twelve-word launch over Fq (ext 1) or Fq2 (ext 2) runs the wide
// design of rcb_wide.cuh; 0 where none runs (K2 on G1, another kernel).
extern "C" long long zkp_rcb_wide_min(int ext, int kernel) {
  if (ext != 1 && ext != 2) return 0;
  return kernel == 0 ? kWideK2Min[ext - 1] : kernel == 3 ? kWideK6Min[ext - 1] : 0;
}

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
