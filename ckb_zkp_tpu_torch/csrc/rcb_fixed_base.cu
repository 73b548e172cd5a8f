// K6, the setup's fixed-base MSM: replaces ckb_zkp_tpu/ops/pallas_rcb.py:204
// _madd_kernel (via _madd_fn, entry rcb_madd_pallas) as the reference's
// _fixed_base_rcb (ckb_zkp_tpu/ops/msm.py:901) calls it, once a window on the
// table rows a one-hot int8 matmul selected. Point i's result is a chain of
// kFbWin = 32 Alg. 8 mixed adds from the identity (0 : 1 : 0): step w adds
// row (w, d) of the window table, d = digit w of scalar i (8 bits), and
// skips the step where d = 0 (row 0 is the identity). The projective total
// (X, Y, Z) is written; the caller normalizes it.
//
// Not carried over window by window: on the TPU each window is a launch
// (the grid runs in order, the accumulator goes through HBM between
// windows) and the row selection a matmul, because XLA's row gather cost
// most of its setup. Here the window loop is a loop in the kernel, as the
// reference's lax.fori_loop over windows: each step reads its row straight
// from the table (32 x 256 rows of X and Y, packed two limbs a word, 1 MB
// for G1 and 2 MB for G2: it stays in L2) through the digit, taken from the
// scalar's limbs; the accumulator stays in registers or in the team's slot
// for all 32 steps. So one launch a MSM replaces, a window, the digits, the
// two 2^20-row gathers, the flag and the elementwise K6 (rcb_madd.cu).
//
// Bound on the H100 by the integer multiply rate: 11 field products a live
// step (3 x 14 Fq products over Fq2), against 64 B of scalar and 192 B
// (G1) or 384 B (G2) of output a point. G1 runs one thread a point (K2a's
// chain, rcb.cuh rcb_madd) in blocks of 256 threads: 2^20 points fill the
// card many times over, where the 8-lane team issues about twice one
// thread's instructions a step (PERF.md, K2 and K5). G2 runs on the team of
// lanes of rcb_team.cuh (rcb_team_fixed_base; 8 lanes, a warp up to
// kSplitMax points): one thread running 42 Fq products a step spills. At
// twelve words (BLS12-381) the launches from rcb_wide.cuh's thresholds on
// run its designs: G1 one thread a point with the next live row staged by
// cp.async, G2 a team of three lanes, one Karatsuba part a lane
// (rcb_wide_fixed_base). All give the bits of the elementwise loop they
// replace. The entry launches on
// the caller's stream, allocates nothing, does not synchronise and returns
// cudaGetLastError().
#include "rcb_wide.cuh"

namespace zkp {
namespace {

constexpr int kFbThreads = 256;

// Thread i folds point i's windows from the identity.
template <int NW, int EXT>
__global__ void __launch_bounds__(kFbThreads)
    rcb_fixed_base_kernel(CurveConsts c, uint32_t* ox, uint32_t* oy,
                          uint32_t* oz, const uint32_t* xw,
                          const uint32_t* yw, const uint32_t* sc,
                          long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  constexpr int NWE = NW * EXT;
  const uint32_t* const s = sc + i * kFbLimbs;
  Pt<NW, EXT> acc = identity<NW, EXT>(c);
#pragma unroll 1
  for (int w = 0; w < kFbWin; ++w) {
    const uint32_t d = (__ldg(s + w / 2) >> (8 * (w % 2))) & 0xFFu;
    if (d) {
      const long long r = ((long long)w * kFbRows + d) * NWE;
      acc = rcb_madd<NW, EXT>(acc, load_words<NW, EXT>(xw + r),
                              load_words<NW, EXT>(yw + r), c);
    }
  }
  store_pt<NW, EXT>(ox, oy, oz, i, acc);
}

}  // namespace
}  // namespace zkp

using namespace zkp;

namespace {

template <int NW, int EXT, bool SPLIT>
cudaError_t launch_team_fb(const CurveConsts& c, uint32_t* ox, uint32_t* oy,
                           uint32_t* oz, const uint32_t* xw,
                           const uint32_t* yw, const uint32_t* sc,
                           long long n, cudaStream_t s) {
  using L = Team<NW, EXT, SPLIT, 2 * NW * EXT + kFbLimbs / 2>;
  return launch_team<L>(&rcb_team_fixed_base<NW, EXT, SPLIT>, EXT, n, s, c,
                        ox, oy, oz, xw, yw, sc, n);
}

// G1: one thread a point, at NW words
template <int NW>
cudaError_t launch_thread_fb(const CurveConsts& c, uint32_t* ox, uint32_t* oy,
                             uint32_t* oz, const uint32_t* xw,
                             const uint32_t* yw, const uint32_t* sc,
                             long long n, cudaStream_t s) {
  rcb_fixed_base_kernel<NW, 1><<<blocks_for(n, kFbThreads), kFbThreads, 0, s>>>(
      c, ox, oy, oz, xw, yw, sc, n);
  return cudaSuccess;
}

// the launcher of width NW for (ext, n)
template <int NW>
decltype(&launch_thread_fb<NW>) pick(int ext, long long n) {
  if constexpr (NW == kNW12) {
    if (wide_design(NW, ext, 3, n))
      return ext == 1 ? &launch_wide_fixed_base<NW, 1> : &launch_wide_fixed_base<NW, 2>;
  }
  return ext == 1 ? &launch_thread_fb<NW>
         : team_split(ext, n) ? &launch_team_fb<NW, 2, true>
                              : &launch_team_fb<NW, 2, false>;
}

}  // namespace

// xw, yw: the window tables (kFbWin * kFbRows rows of EXT * NW packed
// words, pack_limbs); sc: n scalars of kFbLimbs canonical 16-bit limbs;
// ox, oy, oz: n projective points as limb rows.
extern "C" int zkp_rcb_fixed_base(const uint32_t* consts, int ext, void* ox,
                                  void* oy, void* oz, const void* xw,
                                  const void* yw, const void* sc, long long n,
                                  void* stream) {
  if (!rcb_width(consts[0]) || n <= 0 || (ext != 1 && ext != 2))
    return (int)cudaErrorInvalidValue;
  const CurveConsts c = parse_consts(consts);
  if (!b3_fits(c, ext, (int)consts[0])) return (int)cudaErrorInvalidValue;
  auto u = [](const void* p) { return (const uint32_t*)p; };
  auto w = [](void* p) { return (uint32_t*)p; };
  const auto f = consts[0] == kNW ? pick<kNW>(ext, n) : pick<kNW12>(ext, n);
  const int rc = (int)f(c, w(ox), w(oy), w(oz), u(xw), u(yw), u(sc), n,
                        (cudaStream_t)stream);
  return rc ? rc : (int)cudaGetLastError();
}
