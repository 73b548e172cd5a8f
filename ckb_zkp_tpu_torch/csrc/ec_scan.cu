// K9b ec_scan: replaces ckb_zkp_tpu/ops/pallas_ec.py:271 _scan_madd_kernel
// (entry ec_block_totals_madd): the block totals of the Jacobian MSM
// engine's leaf level of bucket-boundary prefixes (ops/msm.py
// _prefix_boundary_leaf). K9c, the level above it, runs on K8's team
// (ec_team.cuh ec_team_chain, entry zkp_ec_add_totals in ec_add.cu).
//
// Not carried over block by block: the TPU kernel takes sorted (B, R, SB,
// 128) limb-major tiles with a fori_loop over B in VMEM. Here one thread
// folds one block of B leaves from infinity (one, one, 0) with the mixed
// add, in 32-bit words (ec_jac.cuh), and writes only the block total T[g].
// It reads its leaves through the MSM's sort order: leaf e of the sums is
// row order[e] of the unsorted (X, Y) limb rows and of the flags, so the
// MSM writes no sorted copy of its leaves (the gather of every leaf row a
// window batch). The next leaf is copied into the thread's two
// shared-memory buffers by cp.async a step ahead (its flag read a step
// ahead, its order entry two), so the random row reads wait behind a mixed
// add's eleven products instead of in front of them. A team of lanes a
// chain lost to this on the H100 at the prove's 2^16 chains, which one
// thread a chain fills the card with (PERF.md, the K9b rows).
//
// Bound on the H100 by the integer multiply rate: 11 field multiplies a
// mixed add (3x that over Fq2). Blocks of 256 threads, halved (down to one
// warp) while the grid would have fewer blocks than SMs. The entry
// launches on the caller's stream, allocates nothing, does not synchronise
// and returns the launch's error.
#include "ec_team.cuh"

namespace zkp {
namespace {

// Words of one thread's staging buffers: two leaves (X, Y limb rows),
// padded so that the threads of a warp reading 16 B each hit distinct
// banks.
template <int NW, int EXT>
constexpr int kStageWords = 4 * (2 * NW * EXT) + 4;

// Thread g folds the affine leaves order[g*B] .. order[g*B+B-1] of (x, y)
// with the byte flags f (order null: the leaves g*B .. g*B+B-1).
template <int NW, int EXT>
__global__ void ec_scan_kernel(CurveConsts c, uint32_t* tx, uint32_t* ty,
                               uint32_t* tz, const uint32_t* x,
                               const uint32_t* y, const uint8_t* f,
                               const long long* order, long long ncols,
                               int B) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= ncols) return;
  constexpr int S = 2 * NW * EXT;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* const buf = smem + threadIdx.x * kStageWords<NW, EXT>;
  auto leaf = [&](long long e) { return order ? order[e] : e; };
  auto stage = [&](long long s, uint32_t* d) {
#pragma unroll
    for (int q = 0; q < 2 * S / 4; ++q) {
      const int i = q / (S / 4), o = 4 * (q % (S / 4));
      __pipeline_memcpy_async(d + i * S + o, (i ? y : x) + s * S + o, 16);
    }
  };
  Pt<NW, EXT> acc = jac_infinity<NW, EXT>(c);
  const long long e0 = g * B;
  long long s = leaf(e0);
  stage(s, buf);
  __pipeline_commit();
  bool qinf = f[s] != 0;
  if (B > 1) s = leaf(e0 + 1);
  for (int b = 0; b < B; ++b) {
    uint32_t* const cur = buf + (b & 1) * 2 * S;
    bool next = false;
    if (b + 1 < B) {  // into the other buffer, read by the step before
      stage(s, buf + ((b + 1) & 1) * 2 * S);
      next = f[s] != 0;
      if (b + 2 < B) s = leaf(e0 + b + 2);
    }
    __pipeline_commit();
    __pipeline_wait_prior(1);  // leaf b's copy
    acc = jac_madd<NW, EXT>(acc, load_limbs<NW, EXT>(cur),
                            load_limbs<NW, EXT>(cur + S), qinf, c);
    qinf = next;
  }
  store_pt<NW, EXT>(tx, ty, tz, g, acc);
}

}  // namespace
}  // namespace zkp

using namespace zkp;

namespace {

// Launches ncols chains of one thread, each with its staging buffers;
// returns the error of a refused shared-memory attribute, else cudaSuccess.
template <int EXT>
cudaError_t launch_scan(const CurveConsts& c, uint32_t* tx, uint32_t* ty,
                        uint32_t* tz, const uint32_t* x, const uint32_t* y,
                        const uint8_t* f, const long long* order,
                        long long ncols, int B, cudaStream_t s) {
  auto kern = &ec_scan_kernel<kNW, EXT>;
  const int threads = ec_block(ncols, 1);
  const size_t smem = (size_t)threads * kStageWords<kNW, EXT> * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<blocks_for(ncols, threads), threads, smem, s>>>(c, tx, ty, tz, x, y,
                                                         f, order, ncols, B);
  return cudaSuccess;
}

}  // namespace

// K9b: leaf e of (x, y) and of the byte flags f is row order[e] (order
// null: row e); block g's total into (tx, ty, tz).
extern "C" int zkp_ec_scan(const uint32_t* consts, int ext, void* tx,
                           void* ty, void* tz, const void* x, const void* y,
                           const void* f, const void* order, long long ncols,
                           int B, void* stream) {
  if (consts[0] != kNW || ncols <= 0 || B <= 0 || (ext != 1 && ext != 2))
    return (int)cudaErrorInvalidValue;
  const CurveConsts c = parse_consts(consts);
  decltype(&launch_scan<1>) launch = ext == 1 ? &launch_scan<1> : &launch_scan<2>;
  const int rc = (int)launch(c, (uint32_t*)tx, (uint32_t*)ty, (uint32_t*)tz,
                             (const uint32_t*)x, (const uint32_t*)y,
                             (const uint8_t*)f, (const long long*)order, ncols,
                             B, (cudaStream_t)stream);
  return rc ? rc : (int)cudaGetLastError();
}
