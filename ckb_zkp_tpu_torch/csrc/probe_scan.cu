// Scan probes: the on-card counterparts of the Pallas probe kernels of
// scripts/probe_scan.py, probe_scan2.py, probe_scan5.py, probe_scan6.py and
// probe_scan7.py (BN254 G1).
//
// probe_madd_scan<NW, EXT, K, WOUT, LAYOUT, RED> runs K2b's function (the
// blocked mixed-add scan over packed affine leaves with a bool flag array,
// Alg. 8) with K independent block-columns per thread:
//   WOUT 0 (P-tot): block totals T only. Replaces probe_scan.py
//     _totals_kernel (fori and unrolled, sb 8 and 32), probe_scan2.py
//     _totals_k_kernel (k = 2, 4 sublane chains) and probe_scan7.py
//     _totals_kernel.
//   WOUT 1 (P-prepk): every inclusive prefix W too, written as packed words
//     (R/2 per coordinate). Replaces probe_scan2.py _prefix_k_packed_kernel.
//   LAYOUT 0: leaf (column g, step b) at e = g*B + b, the column-major
//     order of the port's scans, the counterpart of the reference's b-major
//     tiles. LAYOUT 1 (g-major, K =
//     1): a block's leaves are one contiguous run, e = first*B + b*w +
//     (g - first) with first = the block's first column and w its columns
//     (the threads per block, fewer in a ragged last block), so a warp's
//     32 leaves of one step are contiguous. With WOUT 1 the prefixes are
//     one array, X|Y|Z packed words adjacent per leaf (3 R/2 words).
//     Replaces probe_scan5.py _tot_kernel (P12) and _pref_kernel (P13).
//   RED 0: every multiply CIOS (field.cuh fp_mul). RED 1 (K = 1, WOUT 0):
//     the mixed add's multiplies through the tensor-core reduction
//     (mont_tc.cuh fp_mul_tc). Replaces probe_scan6.py _tot_kernel (P18,
//     LAYOUT 1) and probe_scan7.py kern (P19, LAYOUT 0).
// probe_chain_mul<NW, K> (P-chain): per column g, acc = x[g, 0], then
// acc = mont_mul(acc, x[g, b]) for b = 0 .. B-1 (leaf 0 enters twice, as in
// the reference). Replaces probe_scan2.py _chainmul_kernel.
// probe_scan.py's _prefix_unroll_kernel (P-pre) is K2b itself (rcb_scan.cu
// mode 4).
//
// Not carried over block by block: the TPU probes vary the sublane rows per
// grid step (sb), the loop's unrolling and k interleaved sublane chains. On
// the card one thread owns K block-columns and interleaves their chains: K
// times the independent multiplies in flight per thread, K-fold fewer
// threads. The mixed add runs on every leaf and a flagged leaf's result is
// dropped by a select, so the K chains have no branch between them. The
// threads per block (32 .. 256) are a launch argument, the card's
// counterpart of sb. What bounds these kernels is the integer multiply
// rate (11 field multiplies per mixed add; B per column for P-chain); the
// probes ask how far more chains per thread, another block size, another
// leaf order or the tensor cores close the gap to it. RED 1 is
// warp-collective: no thread leaves early, and a thread past the last
// column runs on the last column and stores nothing. Only EXT = 1 (G1) is
// instantiated, as the probes are G1.
// The entries launch on the caller's stream, allocate nothing, do not
// synchronise and return cudaGetLastError().
#include <type_traits>

#include "mont_tc.cuh"
#include "probe.cuh"
#include "rcb.cuh"

using namespace zkp;

namespace {

// leaf (column col, step b) in the given layout; bcols = columns per block
template <int LAYOUT>
__device__ __forceinline__ long long leaf_index(long long col, int b, int B,
                                                long long ncols,
                                                long long bcols) {
  if constexpr (LAYOUT == 0) {
    return col * B + b;
  } else {
    const long long first = col / bcols * bcols;
    const long long w = min(bcols, ncols - first);
    return first * B + b * w + (col - first);
  }
}

// Thread t owns block-columns t*K .. t*K+K-1; a column past the end runs on
// the last column's leaves and stores nothing. W row e of coordinate k is
// at w[k] + e * wstride.
template <int NW, int EXT, int K, int WOUT, int LAYOUT, int RED>
__global__ void probe_madd_scan(CurveConsts c, const uint4* frag, uint32_t* wx,
                                uint32_t* wy, uint32_t* wz, int wstride,
                                uint32_t* tx, uint32_t* ty, uint32_t* tz,
                                const uint32_t* x, const uint32_t* y,
                                const bool* flags, long long ncols, int B) {
  static_assert(LAYOUT == 0 || K == 1, "g-major runs one column per thread");
  static_assert(RED == 0 || (K == 1 && WOUT == 0), "tensor-core: P-tot, K = 1");
  const long long g0 = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * K;
  if (RED == 0 && g0 >= ncols) return;
  using Mul = std::conditional_t<RED == 1, TcMul, CiosMul>;
  const Mul mul(frag, RED == 1 ? tc_warp_smem() : nullptr);
  constexpr int S = NW * EXT;  // packed words per coordinate
  const long long bcols = (long long)blockDim.x * K;
  long long col[K];
  Pt<NW, EXT> acc[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    col[j] = g0 + j < ncols ? g0 + j : ncols - 1;
    acc[j] = identity<NW, EXT>(c);
  }
  for (int b = 0; b < B; ++b) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const long long e = leaf_index<LAYOUT>(col[j], b, B, ncols, bcols);
      const Pt<NW, EXT> nxt =
          rcb_madd<NW, EXT>(acc[j], load_words<NW, EXT>(x + e * S),
                            load_words<NW, EXT>(y + e * S), c, mul);
      const bool f = flags[e];
      acc[j].X = fe_select<NW, EXT>(f, acc[j].X, nxt.X);
      acc[j].Y = fe_select<NW, EXT>(f, acc[j].Y, nxt.Y);
      acc[j].Z = fe_select<NW, EXT>(f, acc[j].Z, nxt.Z);
      if constexpr (WOUT == 1) {
        if (g0 + j < ncols) {
          store_words<NW, EXT>(wx + e * wstride, acc[j].X);
          store_words<NW, EXT>(wy + e * wstride, acc[j].Y);
          store_words<NW, EXT>(wz + e * wstride, acc[j].Z);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < K; ++j)
    if (g0 + j < ncols) store_pt<NW, EXT>(tx, ty, tz, g0 + j, acc[j]);
}

template <int NW, int K>
__global__ void probe_chain_mul(CurveConsts c, uint32_t* t, const uint32_t* x,
                                long long ncols, int B) {
  const long long g0 = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * K;
  if (g0 >= ncols) return;
  constexpr int S = 2 * NW;  // 16-bit limb rows
  long long col[K];
  Fe<NW, 1> acc[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    col[j] = g0 + j < ncols ? g0 + j : ncols - 1;
    acc[j] = load_limbs<NW, 1>(x + col[j] * B * S);
  }
  for (int b = 0; b < B; ++b) {
#pragma unroll
    for (int j = 0; j < K; ++j)
      acc[j] = fe_mul<NW, 1>(acc[j],
                             load_limbs<NW, 1>(x + (col[j] * B + b) * S), c);
  }
#pragma unroll
  for (int j = 0; j < K; ++j)
    if (g0 + j < ncols) store_limbs<NW, 1>(t + (g0 + j) * S, acc[j]);
}

bool valid_launch(const uint32_t* consts, int k, int threads,
                  long long ncols, int B) {
  return consts[0] == kNW && (k == 1 || k == 2 || k == 4) &&
         (threads == 32 || threads == 64 || threads == 128 ||
          threads == 256) &&
         ncols > 0 && B > 0;
}

template <int K, int WOUT, int LAYOUT, int RED>
cudaError_t launch_madd(const CurveConsts& c, const uint4* frag, int threads,
                        uint32_t* const* w, int wstride, uint32_t* const* t,
                        const uint32_t* x, const uint32_t* y, const bool* flags,
                        long long ncols, int B, cudaStream_t s) {
  auto kern = probe_madd_scan<kNW, 1, K, WOUT, LAYOUT, RED>;
  const unsigned grid = blocks_for((ncols + K - 1) / K, threads);
  const int smem = RED == 1 ? threads / 32 * kTcWords * 4 : 0;
  if (smem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, threads, smem, s>>>(c, frag, w[0], w[1], w[2], wstride, t[0],
                                    t[1], t[2], x, y, flags, ncols, B);
  return cudaSuccess;
}

template <int K>
void launch_chain(const CurveConsts& c, int threads, uint32_t* t,
                  const uint32_t* x, long long ncols, int B, cudaStream_t s) {
  const unsigned grid = blocks_for((ncols + K - 1) / K, threads);
  probe_chain_mul<kNW, K><<<grid, threads, 0, s>>>(c, t, x, ncols, B);
}

}  // namespace

// layout 0: k 1, 2, 4, wout 0, 1, red 0; layout 1: k 1, wout 0, 1, red 0;
// red 1: k 1, wout 0, layout 0, 1 (frag: ops/mont_tc.fragment_table).
extern "C" int zkp_probe_madd_scan(const uint32_t* consts, const void* frag,
                                   int ext, int k, int wout, int layout,
                                   int red, int threads, void* wx, void* wy,
                                   void* wz, void* tx, void* ty, void* tz,
                                   const void* x, const void* y,
                                   const void* flags, long long ncols, int B,
                                   void* stream) {
  const bool ok = valid_launch(consts, k, threads, ncols, B) && ext == 1 &&
                  (wout == 0 || wout == 1) && (layout == 0 || layout == 1) &&
                  (red == 0 || red == 1) && (layout == 0 || k == 1) &&
                  (red == 0 || (k == 1 && wout == 0 && frag)) &&
                  (wout == 0 || (wx && (layout == 1 || (wy && wz))));
  if (!ok) return (int)cudaErrorInvalidValue;
  const CurveConsts c = parse_consts(consts);
  constexpr int S = kNW;  // packed words per G1 coordinate
  uint32_t* const w[3] = {
      (uint32_t*)wx, layout == 1 && wx ? (uint32_t*)wx + S : (uint32_t*)wy,
      layout == 1 && wx ? (uint32_t*)wx + 2 * S : (uint32_t*)wz};
  const int wstride = layout == 1 ? 3 * S : S;
  uint32_t* const t[3] = {(uint32_t*)tx, (uint32_t*)ty, (uint32_t*)tz};
  using Launch = decltype(&launch_madd<1, 0, 0, 0>);
  static const Launch cios0[2][3] = {
      {&launch_madd<1, 0, 0, 0>, &launch_madd<2, 0, 0, 0>, &launch_madd<4, 0, 0, 0>},
      {&launch_madd<1, 1, 0, 0>, &launch_madd<2, 1, 0, 0>, &launch_madd<4, 1, 0, 0>}};
  static const Launch cios1[2] = {&launch_madd<1, 0, 1, 0>, &launch_madd<1, 1, 1, 0>};
  static const Launch tc[2] = {&launch_madd<1, 0, 0, 1>, &launch_madd<1, 0, 1, 1>};
  const Launch launch = red == 1      ? tc[layout]
                        : layout == 1 ? cios1[wout]
                                      : cios0[wout][k == 1 ? 0 : k == 2 ? 1 : 2];
  const cudaError_t e = launch(c, (const uint4*)frag, threads, w, wstride, t,
                               (const uint32_t*)x, (const uint32_t*)y,
                               (const bool*)flags, ncols, B,
                               (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" int zkp_probe_chain_mul(const uint32_t* consts, int k, int threads,
                                   void* t, const void* x, long long ncols,
                                   int B, void* stream) {
  if (!valid_launch(consts, k, threads, ncols, B))
    return (int)cudaErrorInvalidValue;
  const CurveConsts c = parse_consts(consts);
  using Launch = decltype(&launch_chain<1>);
  static const Launch launch[3] = {&launch_chain<1>, &launch_chain<2>,
                                   &launch_chain<4>};
  launch[k == 1 ? 0 : k == 2 ? 1 : 2](c, threads, (uint32_t*)t,
                                      (const uint32_t*)x, ncols, B,
                                      (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
