// K9b / K9c ec_scan: replaces ckb_zkp_tpu/ops/pallas_ec.py:271
// _scan_madd_kernel (K9b, mode 0; entry ec_block_totals_madd) and :290
// _scan_add_kernel (K9c, mode 1; entry ec_block_totals_add): the block
// totals of the Jacobian MSM engine's bucket-boundary prefixes
// (ops/msm.py _prefix_boundary_leaf, _prefix_boundary_jac).
//
// Not carried over block by block: the TPU kernels take (B, R, SB, 128)
// limb-major tiles with a fori_loop over B in VMEM. Here one thread owns
// one block of B sequential adds from infinity (one, one, 0), in 32-bit
// words (ec_jac.cuh), and writes only the block total T[g], as rcb_scan.cu
// does for K4. Bound on the H100 by the integer multiply rate (11 field
// multiplies per mixed add, 16 per add, 3x that over Fq2) and by too few
// threads: a 2^20-leaf window gives 2^15 columns to K9b and 2^10 to K9c,
// so small blocks of 32 threads spread them over the SMs. The entry
// launches on the caller's stream, allocates nothing, does not synchronise
// and returns cudaGetLastError().
#include "ec_jac.cuh"

using namespace zkp;

namespace {

// MODE 0: affine leaves (x, y) with a byte flag array f; mixed add.
// MODE 1: Jacobian points (x, y, z); complete add.
template <int NW, int EXT, int MODE>
__global__ void ec_scan_kernel(CurveConsts c, uint32_t* tx, uint32_t* ty,
                               uint32_t* tz, const uint32_t* x,
                               const uint32_t* y, const void* zf,
                               long long ncols, int B) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= ncols) return;
  constexpr int S = 2 * NW * EXT;
  Pt<NW, EXT> acc = jac_infinity<NW, EXT>(c);
  for (int b = 0; b < B; ++b) {
    const long long e = g * B + b;
    if constexpr (MODE == 0) {
      const bool qinf = ((const uint8_t*)zf)[e] != 0;
      acc = jac_madd<NW, EXT>(acc, load_limbs<NW, EXT>(x + e * S),
                              load_limbs<NW, EXT>(y + e * S), qinf, c);
    } else {
      acc = jac_add<NW, EXT>(
          acc, load_pt<NW, EXT>(x, y, (const uint32_t*)zf, e), c);
    }
  }
  store_pt<NW, EXT>(tx, ty, tz, g, acc);
}

constexpr int kEcScanThreads = 32;

template <int MODE>
void launch_ec_scan(const CurveConsts& c, int ext, uint32_t* tx,
                    uint32_t* ty, uint32_t* tz, const uint32_t* x,
                    const uint32_t* y, const void* zf, long long ncols,
                    int B, cudaStream_t s) {
  const unsigned grid = blocks_for(ncols, kEcScanThreads);
  if (ext == 1)
    ec_scan_kernel<kNW, 1, MODE><<<grid, kEcScanThreads, 0, s>>>(
        c, tx, ty, tz, x, y, zf, ncols, B);
  else
    ec_scan_kernel<kNW, 2, MODE><<<grid, kEcScanThreads, 0, s>>>(
        c, tx, ty, tz, x, y, zf, ncols, B);
}

}  // namespace

extern "C" int zkp_ec_scan(const uint32_t* consts, int ext, int mode,
                           void* tx, void* ty, void* tz, const void* x,
                           const void* y, const void* zf, long long ncols,
                           int B, void* stream) {
  if (consts[0] != kNW || ncols <= 0 || B <= 0 || (mode != 0 && mode != 1) ||
      (ext != 1 && ext != 2))
    return (int)cudaErrorInvalidValue;
  const CurveConsts c = parse_consts(consts);
  decltype(&launch_ec_scan<0>) launch =
      mode == 0 ? &launch_ec_scan<0> : &launch_ec_scan<1>;
  launch(c, ext, (uint32_t*)tx, (uint32_t*)ty, (uint32_t*)tz,
         (const uint32_t*)x, (const uint32_t*)y, zf, ncols, B,
         (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
