// Scan probes: the on-card counterparts of the Pallas probe kernels of
// scripts/probe_scan.py, probe_scan2.py and probe_scan7.py (BN254 G1).
//
// probe_madd_scan<NW, EXT, K, WOUT> runs K2b's function (the blocked
// mixed-add scan over packed affine leaves with a bool flag array, Alg. 8)
// with K independent block-columns per thread:
//   WOUT 0 (P-tot): block totals T only. Replaces probe_scan.py
//     _totals_kernel (fori and unrolled, sb 8 and 32), probe_scan2.py
//     _totals_k_kernel (k = 2, 4 sublane chains) and probe_scan7.py
//     _totals_kernel.
//   WOUT 1 (P-prepk): every inclusive prefix W too, written as packed words
//     (R/2 per coordinate). Replaces probe_scan2.py _prefix_k_packed_kernel.
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
// probes ask how far more chains per thread, or another block size, close
// the gap to it. Only EXT = 1 (G1) is instantiated, as the probes are G1.
// The entries launch on the caller's stream, allocate nothing, do not
// synchronise and return cudaGetLastError().
#include "rcb.cuh"

using namespace zkp;

namespace {

template <int NW, int EXT>
__device__ __forceinline__ void store_words(uint32_t* dst,
                                            const Fe<NW, EXT>& a) {
  uint4* d4 = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int q = 0; q < EXT * NW / 4; ++q) {
    const int w = 4 * q;
    d4[q] = make_uint4(a.v[w / NW][w % NW], a.v[(w + 1) / NW][(w + 1) % NW],
                       a.v[(w + 2) / NW][(w + 2) % NW],
                       a.v[(w + 3) / NW][(w + 3) % NW]);
  }
}

template <int NW, int EXT>
__device__ __forceinline__ Fe<NW, EXT> fe_select(bool keep,
                                                 const Fe<NW, EXT>& a,
                                                 const Fe<NW, EXT>& b) {
  Fe<NW, EXT> r;
#pragma unroll
  for (int k = 0; k < EXT; ++k)
#pragma unroll
    for (int i = 0; i < NW; ++i) r.v[k][i] = keep ? a.v[k][i] : b.v[k][i];
  return r;
}

// Thread t owns block-columns t*K .. t*K+K-1; a column past the end runs on
// the last column's leaves and stores nothing.
template <int NW, int EXT, int K, int WOUT>
__global__ void probe_madd_scan(CurveConsts c, uint32_t* wx, uint32_t* wy,
                                uint32_t* wz, uint32_t* tx, uint32_t* ty,
                                uint32_t* tz, const uint32_t* x,
                                const uint32_t* y, const bool* flags,
                                long long ncols, int B) {
  const long long g0 = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * K;
  if (g0 >= ncols) return;
  constexpr int S = NW * EXT;  // packed words per coordinate
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
      const long long e = col[j] * B + b;
      const Pt<NW, EXT> nxt =
          rcb_madd<NW, EXT>(acc[j], load_words<NW, EXT>(x + e * S),
                            load_words<NW, EXT>(y + e * S), c);
      const bool f = flags[e];
      acc[j].X = fe_select<NW, EXT>(f, acc[j].X, nxt.X);
      acc[j].Y = fe_select<NW, EXT>(f, acc[j].Y, nxt.Y);
      acc[j].Z = fe_select<NW, EXT>(f, acc[j].Z, nxt.Z);
      if constexpr (WOUT == 1) {
        if (g0 + j < ncols) {
          store_words<NW, EXT>(wx + e * S, acc[j].X);
          store_words<NW, EXT>(wy + e * S, acc[j].Y);
          store_words<NW, EXT>(wz + e * S, acc[j].Z);
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

template <int K, int WOUT>
void launch_madd(const CurveConsts& c, int threads, uint32_t* const* w,
                 uint32_t* const* t, const uint32_t* x, const uint32_t* y,
                 const bool* flags, long long ncols, int B, cudaStream_t s) {
  const unsigned grid = blocks_for((ncols + K - 1) / K, threads);
  probe_madd_scan<kNW, 1, K, WOUT><<<grid, threads, 0, s>>>(
      c, w[0], w[1], w[2], t[0], t[1], t[2], x, y, flags, ncols, B);
}

template <int K>
void launch_chain(const CurveConsts& c, int threads, uint32_t* t,
                  const uint32_t* x, long long ncols, int B, cudaStream_t s) {
  const unsigned grid = blocks_for((ncols + K - 1) / K, threads);
  probe_chain_mul<kNW, K><<<grid, threads, 0, s>>>(c, t, x, ncols, B);
}

}  // namespace

extern "C" int zkp_probe_madd_scan(const uint32_t* consts, int ext, int k,
                                   int wout, int threads, void* wx, void* wy,
                                   void* wz, void* tx, void* ty, void* tz,
                                   const void* x, const void* y,
                                   const void* flags, long long ncols, int B,
                                   void* stream) {
  if (!valid_launch(consts, k, threads, ncols, B) || ext != 1 ||
      (wout != 0 && wout != 1) || (wout == 1 && !(wx && wy && wz)))
    return (int)cudaErrorInvalidValue;
  const CurveConsts c = parse_consts(consts);
  uint32_t* const w[3] = {(uint32_t*)wx, (uint32_t*)wy, (uint32_t*)wz};
  uint32_t* const t[3] = {(uint32_t*)tx, (uint32_t*)ty, (uint32_t*)tz};
  using Launch = decltype(&launch_madd<1, 0>);
  static const Launch launch[2][3] = {
      {&launch_madd<1, 0>, &launch_madd<2, 0>, &launch_madd<4, 0>},
      {&launch_madd<1, 1>, &launch_madd<2, 1>, &launch_madd<4, 1>}};
  launch[wout][k == 1 ? 0 : k == 2 ? 1 : 2](
      c, threads, w, t, (const uint32_t*)x, (const uint32_t*)y,
      (const bool*)flags, ncols, B, (cudaStream_t)stream);
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
