// K1 mont_mul: replaces ckb_zkp_tpu/ops/pallas_field.py _mul_kernel (via
// _mul_fn, entries mont_mul / mont_mul_tiles): a * b * R^-1 mod p,
// canonical, over N rows of 16-bit limbs.
//
// Not carried over block by block: the TPU kernel works on limb-major
// (L, SB, 128) tiles for VMEM and the MXU. Here one thread owns one element,
// reads its 16-bit limb rows with 16-byte vector loads, forms eight 32-bit
// words (the same integer, so the same Montgomery form) and runs CIOS with
// 64-bit accumulators. What bounds it on the H100 is the bytes it moves
// (3 x 64 B per element) against the integer multiply rate (2 * 8^2
// 32x32->64 products). A broadcast operand (a constant such as R^2) is
// read with a zero element step. The entry launches on the caller's
// stream, allocates nothing, does not synchronise and returns
// cudaGetLastError().
#include "rcb.cuh"

using namespace zkp;

namespace {

template <int NW>
__global__ void mont_mul_kernel(CurveConsts c, uint32_t* out,
                                const uint32_t* a, const uint32_t* b,
                                long long n, int a_step, int b_step) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  constexpr int S = 2 * NW;
  const Fe<NW, 1> x = load_limbs<NW, 1>(a + i * a_step * S);
  const Fe<NW, 1> y = load_limbs<NW, 1>(b + i * b_step * S);
  store_limbs<NW, 1>(out + i * S, fe_mul<NW, 1>(x, y, c));
}

}  // namespace

extern "C" int zkp_mont_mul(const uint32_t* consts, void* out, const void* a,
                            const void* b, long long n, int a_step,
                            int b_step, void* stream) {
  if (consts[0] != kNW || n <= 0) return (int)cudaErrorInvalidValue;
  const CurveConsts c = parse_consts(consts);
  mont_mul_kernel<kNW><<<blocks_for(n, kThreads), kThreads, 0,
                         (cudaStream_t)stream>>>(
      c, (uint32_t*)out, (const uint32_t*)a, (const uint32_t*)b, n, a_step,
      b_step);
  return (int)cudaGetLastError();
}
