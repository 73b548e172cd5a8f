// Hand-written Hopper kernels of the Groth16 prover's path, with a plain C
// interface loaded through ctypes (ckb_zkp_tpu_torch/ops/cuda_build.py).
//
// K1 mont_mul     replaces ops/pallas_field.py _mul_kernel (via _mul_fn).
// K5 rcb_add      replaces ops/pallas_rcb.py _add_kernel (via _add_fn).
// K2/K3/K4 rcb_scan replaces ops/pallas_rcb.py _scan_fn's
//                 _scan_prefix_madd_packedf_kernel (mode 0),
//                 _scan_prefix_add_kernel (mode 1) and
//                 _scan_total_add_kernel (mode 2).
//
// None is carried over block by block: the TPU kernels work on limb-major
// (R, SB, 128) tiles sized for VMEM and the MXU. Here one thread owns one
// element (K1, K5) or one block-column of B sequential adds (scans), reads
// the reference's row layout (16-bit limbs in int32 lanes, 16-byte vector
// loads) and computes in 32-bit words. What bounds them on the H100 is the
// integer multiply rate (about 2 * 8^2 32x32->64 products per Fq multiply,
// 12 multiplies per RCB add, 3x that over Fq2) and, for the scans, too few
// threads: N = 2^18 with B = 32 is 8192 columns per window. The MSM batches
// its windows into one launch to widen the grid; a wider, work-split scan is
// later work. Each entry launches on the caller's stream, allocates
// nothing, does not synchronise and returns cudaGetLastError().
#include <cuda_runtime.h>

#include "field.cuh"

using namespace zkp;

namespace {

// constants arrive as a flat uint32 buffer from the host
// (cuda_field.kernel_consts):
// [nw, ninv, b3_small, p[12], one[12], b3_c0[12], b3_c1[12]]
CurveConsts parse_consts(const uint32_t* h) {
  CurveConsts c;
  c.ninv = h[1];
  c.b3_small = h[2];
  for (int i = 0; i < MAXW; ++i) {
    c.p[i] = h[3 + i];
    c.one[i] = h[3 + MAXW + i];
    c.b3[0][i] = h[3 + 2 * MAXW + i];
    c.b3[1][i] = h[3 + 3 * MAXW + i];
  }
  return c;
}

template <int NW, int EXT>
struct Pt {
  Fe<NW, EXT> X, Y, Z;
};

template <int NW, int EXT>
__device__ __forceinline__ Pt<NW, EXT> identity(const CurveConsts& c) {
  return {fe_zero<NW, EXT>(), fe_one<NW, EXT>(c), fe_zero<NW, EXT>()};
}

// Renes-Costello-Batina Alg. 7 (a = 0), step for step as ops/rcb.py add.
template <int NW, int EXT>
__device__ __forceinline__ Pt<NW, EXT> rcb_add(const Pt<NW, EXT>& p,
                                               const Pt<NW, EXT>& q,
                                               const CurveConsts& c) {
  using F = Fe<NW, EXT>;
  F t0 = fe_mul<NW, EXT>(p.X, q.X, c);
  F t1 = fe_mul<NW, EXT>(p.Y, q.Y, c);
  F t2 = fe_mul<NW, EXT>(p.Z, q.Z, c);
  F t3 = fe_mul<NW, EXT>(fe_add<NW, EXT>(p.X, p.Y, c),
                         fe_add<NW, EXT>(q.X, q.Y, c), c);
  t3 = fe_sub<NW, EXT>(t3, fe_add<NW, EXT>(t0, t1, c), c);
  F t4 = fe_mul<NW, EXT>(fe_add<NW, EXT>(p.Y, p.Z, c),
                         fe_add<NW, EXT>(q.Y, q.Z, c), c);
  t4 = fe_sub<NW, EXT>(t4, fe_add<NW, EXT>(t1, t2, c), c);
  F X3 = fe_mul<NW, EXT>(fe_add<NW, EXT>(p.X, p.Z, c),
                         fe_add<NW, EXT>(q.X, q.Z, c), c);
  F Y3 = fe_sub<NW, EXT>(X3, fe_add<NW, EXT>(t0, t2, c), c);
  X3 = fe_add<NW, EXT>(t0, t0, c);
  t0 = fe_add<NW, EXT>(X3, t0, c);
  t2 = fe_mul_b3<NW, EXT>(t2, c);
  F Z3 = fe_add<NW, EXT>(t1, t2, c);
  t1 = fe_sub<NW, EXT>(t1, t2, c);
  Y3 = fe_mul_b3<NW, EXT>(Y3, c);
  Pt<NW, EXT> r;
  r.X = fe_sub<NW, EXT>(fe_mul<NW, EXT>(t3, t1, c),
                        fe_mul<NW, EXT>(t4, Y3, c), c);
  r.Y = fe_add<NW, EXT>(fe_mul<NW, EXT>(t1, Z3, c),
                        fe_mul<NW, EXT>(Y3, t0, c), c);
  r.Z = fe_add<NW, EXT>(fe_mul<NW, EXT>(Z3, t4, c),
                        fe_mul<NW, EXT>(t0, t3, c), c);
  return r;
}

// Alg. 8 (Q = (x2, y2, 1), Q not the identity), as ops/rcb.py madd_noinf.
template <int NW, int EXT>
__device__ __forceinline__ Pt<NW, EXT> rcb_madd(const Pt<NW, EXT>& p,
                                                const Fe<NW, EXT>& X2,
                                                const Fe<NW, EXT>& Y2,
                                                const CurveConsts& c) {
  using F = Fe<NW, EXT>;
  F t0 = fe_mul<NW, EXT>(p.X, X2, c);
  F t1 = fe_mul<NW, EXT>(p.Y, Y2, c);
  F t3 = fe_mul<NW, EXT>(fe_add<NW, EXT>(X2, Y2, c),
                         fe_add<NW, EXT>(p.X, p.Y, c), c);
  t3 = fe_sub<NW, EXT>(t3, fe_add<NW, EXT>(t0, t1, c), c);
  F t4 = fe_add<NW, EXT>(fe_mul<NW, EXT>(X2, p.Z, c), p.X, c);
  F t5 = fe_add<NW, EXT>(fe_mul<NW, EXT>(Y2, p.Z, c), p.Y, c);
  F X3 = fe_add<NW, EXT>(t0, t0, c);
  t0 = fe_add<NW, EXT>(X3, t0, c);
  F t2 = fe_mul_b3<NW, EXT>(p.Z, c);
  F Z3 = fe_add<NW, EXT>(t1, t2, c);
  t1 = fe_sub<NW, EXT>(t1, t2, c);
  F Y3 = fe_mul_b3<NW, EXT>(t4, c);
  Pt<NW, EXT> r;
  r.X = fe_sub<NW, EXT>(fe_mul<NW, EXT>(t3, t1, c),
                        fe_mul<NW, EXT>(t5, Y3, c), c);
  r.Y = fe_add<NW, EXT>(fe_mul<NW, EXT>(t1, Z3, c),
                        fe_mul<NW, EXT>(Y3, t0, c), c);
  r.Z = fe_add<NW, EXT>(fe_mul<NW, EXT>(Z3, t5, c),
                        fe_mul<NW, EXT>(t0, t3, c), c);
  return r;
}

template <int NW, int EXT>
__device__ __forceinline__ Pt<NW, EXT> load_pt(const uint32_t* x,
                                               const uint32_t* y,
                                               const uint32_t* z,
                                               long long e) {
  constexpr int S = 2 * NW * EXT;
  return {load_limbs<NW, EXT>(x + e * S), load_limbs<NW, EXT>(y + e * S),
          load_limbs<NW, EXT>(z + e * S)};
}

template <int NW, int EXT>
__device__ __forceinline__ void store_pt(uint32_t* x, uint32_t* y,
                                         uint32_t* z, long long e,
                                         const Pt<NW, EXT>& p) {
  constexpr int S = 2 * NW * EXT;
  store_limbs<NW, EXT>(x + e * S, p.X);
  store_limbs<NW, EXT>(y + e * S, p.Y);
  store_limbs<NW, EXT>(z + e * S, p.Z);
}

// ------------------------------------------------------------------ K1
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

// ------------------------------------------------------------------ K5
template <int NW, int EXT>
__global__ void rcb_add_kernel(CurveConsts c, uint32_t* ox, uint32_t* oy,
                               uint32_t* oz, const uint32_t* x1,
                               const uint32_t* y1, const uint32_t* z1,
                               const uint32_t* x2, const uint32_t* y2,
                               const uint32_t* z2, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Pt<NW, EXT> p = load_pt<NW, EXT>(x1, y1, z1, i);
  const Pt<NW, EXT> q = load_pt<NW, EXT>(x2, y2, z2, i);
  store_pt<NW, EXT>(ox, oy, oz, i, rcb_add<NW, EXT>(p, q, c));
}

// ------------------------------------------------------------ K2 / K3 / K4
// Thread g runs the B elements g*B .. g*B+B-1 from the identity, writing
// each inclusive prefix W[g*B + b] (MODE 0, 1) and the total T[g].
// MODE 0: affine leaves as packed words, the infinity flag in bit 31 of
//         the top X word (pack_limbs_flag); mixed add (Alg. 8).
// MODE 1: projective leaves (X, Y, Z limb rows); complete add (Alg. 7).
// MODE 2: as MODE 1, totals only.
template <int NW, int EXT, int MODE>
__global__ void rcb_scan_kernel(CurveConsts c, uint32_t* wx, uint32_t* wy,
                                uint32_t* wz, uint32_t* tx, uint32_t* ty,
                                uint32_t* tz, const uint32_t* x,
                                const uint32_t* y, const uint32_t* z,
                                long long ncols, int B) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= ncols) return;
  Pt<NW, EXT> acc = identity<NW, EXT>(c);
  for (int b = 0; b < B; ++b) {
    const long long e = g * B + b;
    if constexpr (MODE == 0) {
      constexpr int S = NW * EXT;  // packed words per coordinate
      Fe<NW, EXT> X2 = load_words<NW, EXT>(x + e * S);
      const Fe<NW, EXT> Y2 = load_words<NW, EXT>(y + e * S);
      const uint32_t top = X2.v[EXT - 1][NW - 1];
      X2.v[EXT - 1][NW - 1] = top & 0x7FFFFFFFu;
      if (!(top >> 31)) acc = rcb_madd<NW, EXT>(acc, X2, Y2, c);
    } else {
      acc = rcb_add<NW, EXT>(acc, load_pt<NW, EXT>(x, y, z, e), c);
    }
    if constexpr (MODE != 2) store_pt<NW, EXT>(wx, wy, wz, e, acc);
  }
  store_pt<NW, EXT>(tx, ty, tz, g, acc);
}

constexpr int kThreads = 128;
constexpr int kScanThreads = 64;

inline unsigned blocks_for(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

template <int EXT>
void launch_scan(const CurveConsts& c, int mode, uint32_t* wx, uint32_t* wy,
                 uint32_t* wz, uint32_t* tx, uint32_t* ty, uint32_t* tz,
                 const uint32_t* x, const uint32_t* y, const uint32_t* z,
                 long long ncols, int B, cudaStream_t s) {
  const unsigned grid = blocks_for(ncols, kScanThreads);
  if (mode == 0)
    rcb_scan_kernel<8, EXT, 0><<<grid, kScanThreads, 0, s>>>(
        c, wx, wy, wz, tx, ty, tz, x, y, z, ncols, B);
  else if (mode == 1)
    rcb_scan_kernel<8, EXT, 1><<<grid, kScanThreads, 0, s>>>(
        c, wx, wy, wz, tx, ty, tz, x, y, z, ncols, B);
  else
    rcb_scan_kernel<8, EXT, 2><<<grid, kScanThreads, 0, s>>>(
        c, wx, wy, wz, tx, ty, tz, x, y, z, ncols, B);
}

}  // namespace

// Only NW = 8 (BN254) is instantiated; BLS12-381 (NW = 12) comes later.

extern "C" int zkp_mont_mul(const uint32_t* consts, void* out, const void* a,
                            const void* b, long long n, int a_step,
                            int b_step, void* stream) {
  if (consts[0] != 8 || n <= 0) return (int)cudaErrorInvalidValue;
  const CurveConsts c = parse_consts(consts);
  mont_mul_kernel<8><<<blocks_for(n, kThreads), kThreads, 0,
                       (cudaStream_t)stream>>>(
      c, (uint32_t*)out, (const uint32_t*)a, (const uint32_t*)b, n, a_step,
      b_step);
  return (int)cudaGetLastError();
}

extern "C" int zkp_rcb_add(const uint32_t* consts, int ext, void* ox,
                           void* oy, void* oz, const void* x1, const void* y1,
                           const void* z1, const void* x2, const void* y2,
                           const void* z2, long long n, void* stream) {
  if (consts[0] != 8 || n <= 0 || (ext != 1 && ext != 2))
    return (int)cudaErrorInvalidValue;
  const CurveConsts c = parse_consts(consts);
  const unsigned grid = blocks_for(n, kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  auto u = [](const void* p) { return (const uint32_t*)p; };
  if (ext == 1)
    rcb_add_kernel<8, 1><<<grid, kThreads, 0, s>>>(
        c, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, u(x1), u(y1), u(z1),
        u(x2), u(y2), u(z2), n);
  else
    rcb_add_kernel<8, 2><<<grid, kThreads, 0, s>>>(
        c, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, u(x1), u(y1), u(z1),
        u(x2), u(y2), u(z2), n);
  return (int)cudaGetLastError();
}

extern "C" int zkp_rcb_scan(const uint32_t* consts, int ext, int mode,
                            void* wx, void* wy, void* wz, void* tx, void* ty,
                            void* tz, const void* x, const void* y,
                            const void* z, long long ncols, int B,
                            void* stream) {
  if (consts[0] != 8 || ncols <= 0 || B <= 0 || mode < 0 || mode > 2 ||
      (ext != 1 && ext != 2))
    return (int)cudaErrorInvalidValue;
  const CurveConsts c = parse_consts(consts);
  auto w = [](void* p) { return (uint32_t*)p; };
  auto r = [](const void* p) { return (const uint32_t*)p; };
  if (ext == 1)
    launch_scan<1>(c, mode, w(wx), w(wy), w(wz), w(tx), w(ty), w(tz), r(x),
                   r(y), r(z), ncols, B, (cudaStream_t)stream);
  else
    launch_scan<2>(c, mode, w(wx), w(wy), w(wz), w(tx), w(ty), w(tz), r(x),
                   r(y), r(z), ncols, B, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
