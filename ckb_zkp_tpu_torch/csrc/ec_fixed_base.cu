// K9a, the Jacobian setup's fixed-base MSM: replaces
// ckb_zkp_tpu/ops/pallas_ec.py:259 _ec_madd_kernel (via _ec_madd_fn, entry
// ec_madd_pallas) as the reference's _fixed_base_impl
// (ckb_zkp_tpu/ops/msm.py:883-899) calls it, once a window on the gathered
// table rows. Point i's result is a chain of kFbWin = 32 Jacobian mixed adds
// (ec_jac.cuh jac_madd) from infinity (one, one, 0): step w adds row (w, d)
// of the window table, d = digit w of scalar i (8 bits), and skips the step
// where d = 0 (row 0 is never read). Once the accumulator is finite, the
// loop's step with a flagged row returns it unchanged, so the skip gives
// the same bits; while it is infinite, the loop's step returns row 0's (X,
// Y, 0), another representative of infinity, so the two differ only for an
// all-zero scalar, and only before the caller's normalization, which maps
// both to (0, 0, 0). The first live step gives (X2, Y2, one), as jac_madd
// does from infinity. The Jacobian total (X, Y, Z) is written; the caller
// normalizes it.
//
// As K6's fixed-base kernel (rcb_fixed_base.cu) does for the RCB engine,
// the window loop is a loop in the kernel: each step reads its row straight
// from the table (32 x 256 rows of X and Y, packed two limbs a word: 1 MB
// for G1 and 2 MB for G2, held in L2) through the digit, taken from the
// scalar's limbs, and the accumulator stays in registers for all 32 steps.
// One launch a MSM thus replaces, a window, the digits, the two table-row
// gathers of up to 2^18 rows, the flag and the elementwise K9a
// (ec_madd.cu). The next live row is staged by cp.async into the thread's
// slot of shared memory while a step multiplies.
//
// Bound on the H100 by the integer multiply rate: 11 field products a live
// step (3 x 11 Fq products over Fq2), against 64 B of scalar and 192 B (G1)
// or 384 B (G2) of output a point. One thread a point, G1 and G2, in blocks
// of 256 threads: 2^20 points fill the card many times over, and one thread
// issues about half the instructions a team of lanes issues a step: such a
// team (ec_team.cuh's lanes over the mixed add's levels) took 133.0 ms
// against one thread's 64.3 at 2^20 G2 points, 25.0 against 12.8 for G1
// (PERF.md). The entry launches on the caller's stream, allocates nothing,
// does not synchronise and returns cudaGetLastError().
#include "ec_jac.cuh"
#include "rcb_team.cuh"

namespace zkp {
namespace {

constexpr int kFbThreads = 256;

// Thread i folds point i's windows from infinity; its next live row waits
// in stage[threadIdx.x] (X words, then Y words).
template <int NW, int EXT>
__global__ void __launch_bounds__(kFbThreads)
    ec_fixed_base_kernel(CurveConsts c, uint32_t* ox, uint32_t* oy,
                         uint32_t* oz, const uint32_t* xw, const uint32_t* yw,
                         const uint32_t* sc, long long n) {
  constexpr int NWE = NW * EXT;
  __shared__ __align__(16) uint32_t stage[kFbThreads][2 * NWE];
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t* const st = stage[threadIdx.x];
  const uint32_t* const s = sc + i * kFbLimbs;
  auto digit = [&](int w) { return (__ldg(s + w / 2) >> (8 * (w % 2))) & 0xFFu; };
  auto live = [&](int w) {  // the first window from w on with a digit, or kFbWin
    while (w < kFbWin && !digit(w)) ++w;
    return w;
  };
  auto fetch = [&](int w) {  // cp.async of row (w, digit w) into st
    const long long r = ((long long)w * kFbRows + digit(w)) * NWE;
#pragma unroll
    for (int q = 0; q < NWE / 4; ++q) {
      __pipeline_memcpy_async(st + 4 * q, xw + r + 4 * q, 16);
      __pipeline_memcpy_async(st + NWE + 4 * q, yw + r + 4 * q, 16);
    }
    __pipeline_commit();
  };
  Pt<NW, EXT> acc = jac_infinity<NW, EXT>(c);
  int w = live(0);
  if (w < kFbWin) fetch(w);
  while (w < kFbWin) {
    __pipeline_wait_prior(0);
    const Fe<NW, EXT> X2 = load_words<NW, EXT>(st);
    const Fe<NW, EXT> Y2 = load_words<NW, EXT>(st + NWE);
    const int next = live(w + 1);
    if (next < kFbWin) fetch(next);
    acc = jac_madd<NW, EXT>(acc, X2, Y2, false, c);
    w = next;
  }
  store_pt<NW, EXT>(ox, oy, oz, i, acc);
}

}  // namespace
}  // namespace zkp

using namespace zkp;

// xw, yw: the window tables (kFbWin * kFbRows rows of EXT * NW packed
// words, pack_limbs); sc: n scalars of kFbLimbs canonical 16-bit limbs;
// ox, oy, oz: n Jacobian points as limb rows.
extern "C" int zkp_ec_fixed_base(const uint32_t* consts, int ext, void* ox,
                                 void* oy, void* oz, const void* xw,
                                 const void* yw, const void* sc, long long n,
                                 void* stream) {
  if (consts[0] != kNW || n <= 0 || (ext != 1 && ext != 2))
    return (int)cudaErrorInvalidValue;
  const CurveConsts c = parse_consts(consts);
  auto u = [](const void* p) { return (const uint32_t*)p; };
  auto w = [](void* p) { return (uint32_t*)p; };
  const cudaStream_t s = (cudaStream_t)stream;
  const unsigned grid = blocks_for(n, kFbThreads);
  if (ext == 1)
    ec_fixed_base_kernel<kNW, 1><<<grid, kFbThreads, 0, s>>>(
        c, w(ox), w(oy), w(oz), u(xw), u(yw), u(sc), n);
  else
    ec_fixed_base_kernel<kNW, 2><<<grid, kFbThreads, 0, s>>>(
        c, w(ox), w(oy), w(oz), u(xw), u(yw), u(sc), n);
  return (int)cudaGetLastError();
}
