// K2a / K2b rcb_scan, and the C entry of K2 / K3 / K4: replaces the
// _scan_fn kernels of ckb_zkp_tpu/ops/pallas_rcb.py:
// _scan_prefix_madd_kernel (K2a, mode 3) and _scan_prefix_madd_packed_kernel
// (K2b, mode 4) here; _scan_prefix_madd_packedf_kernel (K2, mode 0),
// _scan_prefix_add_kernel (K3, mode 1) and _scan_total_add_kernel (K4,
// mode 2) in rcb_team_scan.cu, a team of lanes per chain.
//
// Not carried over block by block: the TPU kernels work on limb-major
// (B, R, SB, 128) tiles sized for VMEM and the MXU, with the sequential
// dimension in the grid. Here one thread owns one block-column of B
// sequential mixed adds (rcb.cuh formulas, 32-bit words). What bounds them
// on the H100 is the latency of one thread's 11 field multiplies a step (3x
// that over Fq2) and too few threads: N = 2^20 with B = 32 is 32768 columns
// per window. They are the window and scan probes' kernels, off the
// prover's path, and keep this design so that their measurements stay
// comparable (the prover's K2 runs on the team kernel). K2a reads its
// leaves as 16-bit limb rows, twice K2b's packed words, so it moves more
// bytes for the same multiplies. The entry launches on the caller's
// stream, allocates nothing, does not synchronise and returns
// cudaGetLastError().
#include "rcb.cuh"

using namespace zkp;

namespace {

// the affine leaf e: 16-bit limb rows (MODE 3) or packed words (MODE 4)
template <int NW, int EXT, int MODE>
__device__ __forceinline__ Fe<NW, EXT> load_leaf(const uint32_t* p,
                                                 long long e) {
  if constexpr (MODE == 3)
    return load_limbs<NW, EXT>(p + e * 2 * NW * EXT);
  else
    return load_words<NW, EXT>(p + e * NW * EXT);
}

// Thread g runs the B elements g*B .. g*B+B-1 from the identity with the
// mixed add (Alg. 8), writing each inclusive prefix W[g*B + b] and the
// total T[g]; the flags are a bool array.
// MODE 3: affine leaves as limb rows.
// MODE 4: affine leaves as packed words (all 32 bits).
template <int NW, int EXT, int MODE>
__global__ void rcb_scan_kernel(CurveConsts c, uint32_t* wx, uint32_t* wy,
                                uint32_t* wz, uint32_t* tx, uint32_t* ty,
                                uint32_t* tz, const uint32_t* x,
                                const uint32_t* y, const bool* flags,
                                long long ncols, int B) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= ncols) return;
  Pt<NW, EXT> acc = identity<NW, EXT>(c);
  for (int b = 0; b < B; ++b) {
    const long long e = g * B + b;
    if (!flags[e])
      acc = rcb_madd<NW, EXT>(acc, load_leaf<NW, EXT, MODE>(x, e),
                              load_leaf<NW, EXT, MODE>(y, e), c);
    store_pt<NW, EXT>(wx, wy, wz, e, acc);
  }
  store_pt<NW, EXT>(tx, ty, tz, g, acc);
}

constexpr int kScanThreads = 64;

// Launches rcb_scan_kernel<kNW, ext, MODE> on the caller's stream.
template <int MODE>
void launch_scan(const CurveConsts& c, int ext, uint32_t* wx, uint32_t* wy,
                 uint32_t* wz, uint32_t* tx, uint32_t* ty, uint32_t* tz,
                 const uint32_t* x, const uint32_t* y, const bool* flags,
                 long long ncols, int B, cudaStream_t s) {
  const unsigned grid = blocks_for(ncols, kScanThreads);
  if (ext == 1)
    rcb_scan_kernel<kNW, 1, MODE><<<grid, kScanThreads, 0, s>>>(
        c, wx, wy, wz, tx, ty, tz, x, y, flags, ncols, B);
  else
    rcb_scan_kernel<kNW, 2, MODE><<<grid, kScanThreads, 0, s>>>(
        c, wx, wy, wz, tx, ty, tz, x, y, flags, ncols, B);
}

}  // namespace

namespace zkp {
int launch_rcb_team_scan(const CurveConsts& c, int nw, int ext, bool prefix,
                         uint32_t* wx, uint32_t* wy, uint32_t* wz,
                         uint32_t* tx, uint32_t* ty, uint32_t* tz,
                         const uint32_t* x, const uint32_t* y,
                         const uint32_t* z, long long ncols, int B,
                         cudaStream_t s);
int launch_rcb_team_madd_scan(const CurveConsts& c, int nw, int ext,
                              uint32_t* wx, uint32_t* wy, uint32_t* wz,
                              uint32_t* tx, uint32_t* ty, uint32_t* tz,
                              const uint32_t* xw, const uint32_t* yw,
                              const long long* order, long long ncols, int B,
                              cudaStream_t s);
}  // namespace zkp

// aux: the flags of modes 3 and 4 (a bool a leaf), or the order of mode 0
// (an int64 leaf row a scan position, or null for the leaves in order).
// Modes 0-2 (K2-K4) run at 8 or 12 words (consts[0]); modes 3 and 4 (K2a,
// K2b, the window probes' BN254 kernels) at 8 only.
extern "C" int zkp_rcb_scan(const uint32_t* consts, int ext, int mode,
                            void* wx, void* wy, void* wz, void* tx, void* ty,
                            void* tz, const void* x, const void* y,
                            const void* z, const void* aux, long long ncols,
                            int B, void* stream) {
  const int nw = (int)consts[0];
  if (!rcb_width(consts[0]) || (mode >= 3 && nw != kNW) || ncols <= 0 || B <= 0 ||
      mode < 0 || mode > 4 ||
      (ext != 1 && ext != 2) || ((mode == 3 || mode == 4) && !aux) ||
      ((mode == 1 || mode == 2) && !z))
    return (int)cudaErrorInvalidValue;
  const CurveConsts c = parse_consts(consts);
  if (!b3_fits(c, ext, nw)) return (int)cudaErrorInvalidValue;
  auto w = [](void* p) { return (uint32_t*)p; };
  auto r = [](const void* p) { return (const uint32_t*)p; };
  const cudaStream_t s = (cudaStream_t)stream;
  int rc = 0;
  if (mode == 0)
    rc = launch_rcb_team_madd_scan(c, nw, ext, w(wx), w(wy), w(wz), w(tx), w(ty),
                                   w(tz), r(x), r(y), (const long long*)aux,
                                   ncols, B, s);
  else if (mode <= 2)
    rc = launch_rcb_team_scan(c, nw, ext, mode == 1, w(wx), w(wy), w(wz), w(tx),
                              w(ty), w(tz), r(x), r(y), r(z), ncols, B, s);
  else
    (mode == 3 ? &launch_scan<3> : &launch_scan<4>)(
        c, ext, w(wx), w(wy), w(wz), w(tx), w(ty), w(tz), r(x), r(y),
        (const bool*)aux, ncols, B, s);
  return rc ? rc : (int)cudaGetLastError();
}
