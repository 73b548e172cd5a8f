// Grid-carried scan and write-only probes: the on-card counterparts of the
// Pallas probe kernels of scripts/probe_scan3.py and probe_scan4.py (BN254
// G1, packed affine leaves of 8 words a coordinate, leaf e = g*B + b).
//
// The TPU sites put the B steps of a block-column scan in the grid, (g, b):
// the b steps run in order on one core, and the accumulator stays in VMEM
// scratch from one step to the next and is written as T at the last one.
// The blocks of a CUDA grid run in no order, so here the b loop runs inside
// the block: one launch per call, never one per step. The sites' question,
// whether small step bodies with their state kept on chip beat one loop
// over the steps, becomes on the card: does staging each step's leaves
// through shared memory, with the accumulator in shared memory, beat
// P-tot's direct loads into registers (probe_scan.cu)?
//
// probe_grid_scan<WMODE>: one thread per column, `cols` (the threads per
// block) columns per block. Step b's leaf comes into shared memory by two
// 16-byte cp.async per coordinate, issued a step ahead into the other of
// two buffers, so step b+1's copy overlaps step b's mixed add; each thread
// copies and reads only its own slots, so no block barrier is needed. The
// accumulator (X, Y, Z: 24 words) lives in shared memory, word-major
// ([word][thread], a warp on 32 banks); each step reads it into registers,
// runs rcb_madd (Alg. 8, 11 multiplies), keeps it for a flagged leaf and
// stores it back (volatile, so the round trip the site measures is not
// optimised into registers). The staged leaves sit 32 B apart a thread
// (2-way conflicted 16-byte reads).
//   WMODE 0 (P7): T only. Replaces probe_scan3.py _gtot_kernel (sb 8, 32 ->
//     64, 256 threads).
//   WMODE 1 (P8): each step's prefix also written as packed W straight to
//     device memory. Replaces probe_scan3.py _gpref_kernel.
//   WMODE 2 (P11): the tile's whole W (cols * B leaves x 3 coordinates x
//     32 B: 96 KB at 32 columns, 192 KB at 64) kept in shared memory in the
//     order of device memory and written once, after the last step, as one
//     coalesced sweep of the tile's contiguous run of leaves (the columns
//     first .. first+cols-1 are leaves first*B .. (first+cols)*B - 1).
//     Replaces probe_scan4.py _gpref_big_kernel (its revisited (B, Rp, sb,
//     128) W block). A warp's stores of one step into the tile lie B * 32 B
//     apart, on the same banks: conflicted, recorded, not fixed here.
// Bound: the integer multiply rate (11 Fq multiplies per mixed add), as
// P-tot; P8 and P11 also write 96 B of W per leaf.
//
// probe_wo<STAGED> (P9, P10): no arithmetic. Thread per column; each step
// it reads x[e], y[e] and writes x[e], y[e], x[e] ^ y[e] to W.
//   STAGED 0 (P9): straight to device memory each step. Replaces
//     probe_scan4.py _wo_kernel (per-(g, b) output blocks); 64 threads.
//   STAGED 1 (P10): the tile's three outputs staged in shared memory in
//     device order and flushed once per tile. Replaces _wo_big_kernel;
//     cols 32 and 64.
// Bound: bytes (2 reads and 3 writes of 32 B per leaf).
//
// Shared memory above 48 KB is dynamic, after cudaFuncSetAttribute
// (checked); a block holds at most 232,448 B. The entries launch on the
// caller's stream, allocate nothing, do not synchronise and return
// cudaGetLastError() (or the attribute call's error).
#include <cuda_pipeline.h>

#include "probe.cuh"
#include "rcb.cuh"

using namespace zkp;

namespace {

constexpr int kW = kNW;  // packed words per G1 coordinate
constexpr long long kSmemMax = 232448;

__device__ __forceinline__ void stage_leaf(uint32_t* dst, const uint32_t* src) {
  __pipeline_memcpy_async(dst, src, 16);
  __pipeline_memcpy_async(dst + 4, src + 4, 16);
}

// accumulator in shared memory, word-major: coordinate k, word i of thread t
// at acc[(k * kW + i) * cols + t]
__device__ __forceinline__ Pt<kW, 1> load_acc(const volatile uint32_t* acc,
                                              int cols, int t) {
  Pt<kW, 1> p;
#pragma unroll
  for (int i = 0; i < kW; ++i) {
    p.X.v[0][i] = acc[(0 * kW + i) * cols + t];
    p.Y.v[0][i] = acc[(1 * kW + i) * cols + t];
    p.Z.v[0][i] = acc[(2 * kW + i) * cols + t];
  }
  return p;
}

__device__ __forceinline__ void store_acc(volatile uint32_t* acc, int cols,
                                          int t, const Pt<kW, 1>& p) {
#pragma unroll
  for (int i = 0; i < kW; ++i) {
    acc[(0 * kW + i) * cols + t] = p.X.v[0][i];
    acc[(1 * kW + i) * cols + t] = p.Y.v[0][i];
    acc[(2 * kW + i) * cols + t] = p.Z.v[0][i];
  }
}

// n words (a multiple of 4) from shared src to device dst, 16 B a thread,
// consecutive threads on consecutive addresses
__device__ __forceinline__ void flush_tile(uint32_t* dst, const uint32_t* src,
                                           long long n) {
  uint4* d4 = reinterpret_cast<uint4*>(dst);
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
  for (long long q = threadIdx.x; q < n / 4; q += blockDim.x) d4[q] = s4[q];
}

long long grid_smem(int wmode, int cols, int B) {
  const long long acc_stage = (3 + 4) * kW * 4LL * cols;
  return acc_stage + (wmode == 2 ? 3LL * cols * B * kW * 4 : 0);
}

template <int WMODE>
__global__ void probe_grid_scan(CurveConsts c, uint32_t* wx, uint32_t* wy,
                                uint32_t* wz, uint32_t* tx, uint32_t* ty,
                                uint32_t* tz, const uint32_t* x,
                                const uint32_t* y, const bool* flags,
                                long long ncols, int B) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int cols = blockDim.x, t = threadIdx.x;
  const long long first = (long long)blockIdx.x * cols;
  const long long g = first + t;
  volatile uint32_t* acc = smem;           // [3][kW][cols]
  uint32_t* stage = smem + 3 * kW * cols;  // [2 buffers][x, y][cols][kW]
  uint32_t* tile = stage + 4 * kW * cols;  // [3][cols * B][kW] (WMODE 2)
  const long long run = (long long)cols * B * kW;
  if (g < ncols) {
    store_acc(acc, cols, t, identity<kW, 1>(c));
    stage_leaf(stage + t * kW, x + g * B * kW);
    stage_leaf(stage + (cols + t) * kW, y + g * B * kW);
    __pipeline_commit();
    for (int b = 0; b < B; ++b) {
      const long long e = g * B + b;
      if (b + 1 < B) {
        uint32_t* nxt = stage + ((b + 1) & 1) * 2 * kW * cols;
        stage_leaf(nxt + t * kW, x + (e + 1) * kW);
        stage_leaf(nxt + (cols + t) * kW, y + (e + 1) * kW);
      }
      __pipeline_commit();
      __pipeline_wait_prior(1);  // step b's copies have landed
      const uint32_t* cur = stage + (b & 1) * 2 * kW * cols;
      const Pt<kW, 1> a = load_acc(acc, cols, t);
      const Pt<kW, 1> s =
          rcb_madd<kW, 1>(a, load_words<kW, 1>(cur + t * kW),
                          load_words<kW, 1>(cur + (cols + t) * kW), c);
      const bool f = flags[e];
      Pt<kW, 1> r;
      r.X = fe_select<kW, 1>(f, a.X, s.X);
      r.Y = fe_select<kW, 1>(f, a.Y, s.Y);
      r.Z = fe_select<kW, 1>(f, a.Z, s.Z);
      store_acc(acc, cols, t, r);
      if constexpr (WMODE == 1) {
        store_words<kW, 1>(wx + e * kW, r.X);
        store_words<kW, 1>(wy + e * kW, r.Y);
        store_words<kW, 1>(wz + e * kW, r.Z);
      } else if constexpr (WMODE == 2) {
        const long long l = ((long long)t * B + b) * kW;
        store_words<kW, 1>(tile + l, r.X);
        store_words<kW, 1>(tile + run + l, r.Y);
        store_words<kW, 1>(tile + 2 * run + l, r.Z);
      }
    }
    store_pt<kW, 1>(tx, ty, tz, g, load_acc(acc, cols, t));
  }
  if constexpr (WMODE == 2) {
    __syncthreads();
    const long long n = min((long long)cols, ncols - first) * B * kW;
    const long long off = first * B * kW;
    flush_tile(wx + off, tile, n);
    flush_tile(wy + off, tile + run, n);
    flush_tile(wz + off, tile + 2 * run, n);
  }
}

template <int STAGED>
__global__ void probe_wo(uint32_t* wx, uint32_t* wy, uint32_t* wz,
                         const uint32_t* x, const uint32_t* y, long long ncols,
                         int B) {
  extern __shared__ __align__(16) uint32_t smem[];  // [3][cols * B][kW]
  const int cols = blockDim.x, t = threadIdx.x;
  const long long first = (long long)blockIdx.x * cols;
  const long long g = first + t;
  const long long run = (long long)cols * B * kW;
  if (g < ncols) {
    for (int b = 0; b < B; ++b) {
      const long long e = g * B + b;
      const uint4* x4 = reinterpret_cast<const uint4*>(x + e * kW);
      const uint4* y4 = reinterpret_cast<const uint4*>(y + e * kW);
      const long long l = STAGED ? ((long long)t * B + b) * kW : e * kW;
      uint4* o0 = reinterpret_cast<uint4*>((STAGED ? smem : wx) + l);
      uint4* o1 = reinterpret_cast<uint4*>((STAGED ? smem + run : wy) + l);
      uint4* o2 = reinterpret_cast<uint4*>((STAGED ? smem + 2 * run : wz) + l);
#pragma unroll
      for (int q = 0; q < kW / 4; ++q) {
        const uint4 u = x4[q], v = y4[q];
        o0[q] = u;
        o1[q] = v;
        o2[q] = make_uint4(u.x ^ v.x, u.y ^ v.y, u.z ^ v.z, u.w ^ v.w);
      }
    }
  }
  if constexpr (STAGED == 1) {
    __syncthreads();
    const long long n = min((long long)cols, ncols - first) * B * kW;
    const long long off = first * B * kW;
    flush_tile(wx + off, smem, n);
    flush_tile(wy + off, smem + run, n);
    flush_tile(wz + off, smem + 2 * run, n);
  }
}

template <class Kern>
cudaError_t allow_smem(Kern kern, long long smem) {
  return smem > 48 * 1024
             ? cudaFuncSetAttribute(
                   kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)
             : cudaSuccess;
}

}  // namespace

// wmode 0 (P7), 1 (P8): cols 64 or 256; wmode 2 (P11): cols 32 or 64.
// W (wmode 1, 2) and T as probe_madd_scan's (packed (M, 8) per coordinate;
// T (G, 16) limb rows).
extern "C" int zkp_probe_grid_scan(const uint32_t* consts, int ext, int wmode,
                                   int cols, void* wx, void* wy, void* wz,
                                   void* tx, void* ty, void* tz,
                                   const void* x, const void* y,
                                   const void* flags, long long ncols, int B,
                                   void* stream) {
  const bool cols_ok =
      wmode == 2 ? (cols == 32 || cols == 64) : (cols == 64 || cols == 256);
  const long long smem = grid_smem(wmode, cols, B);
  if (consts[0] != kNW || ext != 1 || wmode < 0 || wmode > 2 || !cols_ok ||
      ncols <= 0 || B <= 0 || smem > kSmemMax ||
      (wmode != 0 && !(wx && wy && wz)))
    return (int)cudaErrorInvalidValue;
  const CurveConsts c = parse_consts(consts);
  using Kern = decltype(&probe_grid_scan<0>);
  static const Kern kerns[3] = {&probe_grid_scan<0>, &probe_grid_scan<1>,
                                &probe_grid_scan<2>};
  const Kern kern = kerns[wmode];
  const cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<blocks_for(ncols, cols), cols, (size_t)smem, (cudaStream_t)stream>>>(
      c, (uint32_t*)wx, (uint32_t*)wy, (uint32_t*)wz, (uint32_t*)tx,
      (uint32_t*)ty, (uint32_t*)tz, (const uint32_t*)x, (const uint32_t*)y,
      (const bool*)flags, ncols, B);
  return (int)cudaGetLastError();
}

// staged 0 (P9): cols 64; staged 1 (P10): cols 32 or 64.
extern "C" int zkp_probe_wo(int staged, int cols, void* wx, void* wy, void* wz,
                            const void* x, const void* y, long long ncols,
                            int B, void* stream) {
  const bool cols_ok = staged == 1 ? (cols == 32 || cols == 64)
                                   : (staged == 0 && cols == 64);
  const long long smem = staged == 1 ? 3LL * cols * B * kW * 4 : 0;
  if (!cols_ok || ncols <= 0 || B <= 0 || smem > kSmemMax)
    return (int)cudaErrorInvalidValue;
  using Kern = decltype(&probe_wo<0>);
  const Kern kern = staged == 1 ? &probe_wo<1> : &probe_wo<0>;
  const cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<blocks_for(ncols, cols), cols, (size_t)smem, (cudaStream_t)stream>>>(
      (uint32_t*)wx, (uint32_t*)wy, (uint32_t*)wz, (const uint32_t*)x,
      (const uint32_t*)y, ncols, B);
  return (int)cudaGetLastError();
}
