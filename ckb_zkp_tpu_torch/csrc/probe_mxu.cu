// Tensor-core probes: the on-card counterparts of the Pallas probe kernels
// of scripts/probe_mxu.py and scripts/probe_mxu2.py.
//
// probe_u32_ops<OP> (P14, probe_mxu.py vpu_kernel): per element, 512
//   chained wrapping u32 steps on (a, b), step i:
//     OP 0 add      a = a + b + i
//     OP 1 mul      a = a * b + i
//     OP 2 mulmask  p = a * b; a = (p & 0xFFFF) + (p >> 16) + i
//     OP 3 shift    a = (a >> 16) + b + i
//   then writes a and b. One thread per element. Each step is written in
//   PTX so that the compiler cannot fold the chain (a + 512 b + ...): the
//   probe asks what one op costs. Bound: the int32 op rate (64 per SM per
//   clock for add, multiply-add, shift and logical ops on compute
//   capability 9.0).
// probe_band_mma<N_MM> (P15, probe_mxu.py mxu_kernel): one block per tile of
//   256 rows x 128 columns (the reference's 32 byte planes x 8 sublanes x
//   128 lanes); N_MM chained steps of
//     t8 = int8((t & 0xFF) - 128); o = M2d @ t8 (s32); o += per-column
//     byte total of t + i; acc += o; t = |acc| & 0xFFFF
//   with the signed (256, 256) M2d and t8 in dynamic shared memory (rows
//   padded to 272 bytes: the fragment loads of a group are free of bank
//   conflicts), 16 warps each holding 16 output rows x 128 columns as
//   mma.m16n8k32.s8 accumulators (the o + acc update rides the mma's C),
//   the column byte total a shared-memory reduction at each step. M2d
//   mixes all 256 rows of a tile, so the tile is the unit of the function.
//   Bound: the int8 tensor-core rate (2 * 256 * 256 * 128 ops per tile and
//   step) or the 64 MB of x and out.
// probe_mul_chain<NW, NMUL, RED> (P16 RED 0, probe_mxu2.py kern_vpu; P17
//   RED 1, kern_mxu): per element, NMUL chained a = mont(a * b) over (N, L)
//   limb rows as K1 stores them; RED 0 CIOS (field.cuh fp_mul), RED 1 the
//   tensor-core reduction (mont_tc.cuh fp_mul_tc), bit-equal. RED 1 is
//   warp-collective: an element past the end runs on the last one and
//   stores nothing.
// The entries launch on the caller's stream, allocate nothing, do not
// synchronise and return cudaGetLastError().
#include <type_traits>

#include "mont_tc.cuh"
#include "rcb.cuh"

using namespace zkp;

namespace {

constexpr int kOps = 512;

template <int OP>
__global__ void probe_u32_ops(uint32_t* out, const uint32_t* x, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t a = x[i];
  const uint32_t b = x[n + i];
#pragma unroll 16
  for (uint32_t k = 0; k < kOps; ++k) {
    if constexpr (OP == 0) {
      asm("add.u32 %0, %0, %1;" : "+r"(a) : "r"(b));
      asm("add.u32 %0, %0, %1;" : "+r"(a) : "r"(k));
    } else if constexpr (OP == 1) {
      asm("mad.lo.u32 %0, %0, %1, %2;" : "+r"(a) : "r"(b), "r"(k));
    } else if constexpr (OP == 2) {
      uint32_t p, lo;
      asm("mul.lo.u32 %0, %1, %2;" : "=r"(p) : "r"(a), "r"(b));
      asm("and.b32 %0, %1, 0xFFFF;" : "=r"(lo) : "r"(p));
      asm("shr.u32 %0, %1, 16;" : "=r"(a) : "r"(p));
      asm("add.u32 %0, %0, %1;" : "+r"(a) : "r"(lo));
      asm("add.u32 %0, %0, %1;" : "+r"(a) : "r"(k));
    } else {
      asm("shr.u32 %0, %0, 16;" : "+r"(a));
      asm("add.u32 %0, %0, %1;" : "+r"(a) : "r"(b));
      asm("add.u32 %0, %0, %1;" : "+r"(a) : "r"(k));
    }
  }
  out[i] = a;
  out[n + i] = b;
}

// ------------------------------------------------------------------ P15
constexpr int kMmRows = 256;     // rows of a tile and of M2d
constexpr int kMmCols = 128;     // columns (lanes) of a tile
constexpr int kMmPitch = 272;    // bytes per shared row: 256 + 16
constexpr int kMmWarps = 16;     // 16 output rows each
constexpr int kMmSmem = kMmRows * kMmPitch + kMmCols * kMmPitch +
                        kMmWarps * kMmCols * 4 + kMmCols * 4;

__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// x, out: (32, 8 * ntiles, 128) u32; tile i, row r = plane * 8 + sublane.
// A lane of warp w holds acc[nt][e] = row w*16 + group + 8 (e >> 1),
// column nt*8 + 2 tq + (e & 1): the mma's C/D layout.
template <int N_MM>
__global__ void __launch_bounds__(kMmWarps * 32, 1)
    probe_band_mma(int32_t* out, const int8_t* m2d, const uint32_t* x,
                   int ntiles) {
  unsigned char* sm = zkp_dyn_smem;
  unsigned char* sM = sm;                              // M2d rows
  unsigned char* sT = sM + kMmRows * kMmPitch;         // t8 transposed: [col][row]
  int* part = reinterpret_cast<int*>(sT + kMmCols * kMmPitch);  // [warp][col]
  int* csum = part + kMmWarps * kMmCols;                         // [col]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const long long plane_stride = 8LL * ntiles * kMmCols;
  const long long tile_off = (long long)blockIdx.x * 8 * kMmCols;

  for (int q = tid; q < kMmRows * 16; q += blockDim.x)
    *reinterpret_cast<uint4*>(sM + (q >> 4) * kMmPitch + (q & 15) * 16) =
        reinterpret_cast<const uint4*>(m2d)[q];

  auto gidx = [&](int nt, int e) {
    const int r = warp * 16 + g + 8 * (e >> 1);
    const int col = nt * 8 + 2 * tq + (e & 1);
    return (r >> 3) * plane_stride + tile_off + (r & 7) * kMmCols + col;
  };
  int acc[16][4];
#pragma unroll
  for (int nt = 0; nt < 16; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = (int)x[gidx(nt, e)];

  for (int i = 0; i < N_MM; ++i) {
    // t = x (step 0) or |acc| & 0xFFFF: its bytes - 128 to sT, and the
    // column byte totals of this warp's 16 rows to part
#pragma unroll
    for (int nt = 0; nt < 16; ++nt) {
      int colsum[2] = {0, 0};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = i == 0 ? acc[nt][e] : (abs(acc[nt][e]) & 0xFFFF);
        const int byte = t & 0xFF;
        colsum[e & 1] += byte;
        const int r = warp * 16 + g + 8 * (e >> 1);
        const int col = nt * 8 + 2 * tq + (e & 1);
        sT[col * kMmPitch + r] = (unsigned char)(byte - 128);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        colsum[h] += __shfl_xor_sync(0xFFFFFFFFu, colsum[h], 4);
        colsum[h] += __shfl_xor_sync(0xFFFFFFFFu, colsum[h], 8);
        colsum[h] += __shfl_xor_sync(0xFFFFFFFFu, colsum[h], 16);
      }
      if (g == 0) {
        part[warp * kMmCols + nt * 8 + 2 * tq] = colsum[0];
        part[warp * kMmCols + nt * 8 + 2 * tq + 1] = colsum[1];
      }
    }
    __syncthreads();
    if (tid < kMmCols) {
      int s = 0;
#pragma unroll
      for (int w = 0; w < kMmWarps; ++w) s += part[w * kMmCols + tid];
      csum[tid] = s;
    }
    __syncthreads();
    // acc = acc + (byte total + i) + M2d @ t8, the first two as the mma's C
#pragma unroll
    for (int nt = 0; nt < 16; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[nt][e] = (i == 0 ? 0 : acc[nt][e]) + csum[nt * 8 + 2 * tq + (e & 1)] + i;
#pragma unroll
    for (int ks = 0; ks < kMmRows / 32; ++ks) {
      const unsigned char* ar = sM + (warp * 16 + g) * kMmPitch + ks * 32 + tq * 4;
      const uint32_t a0 = *reinterpret_cast<const uint32_t*>(ar);
      const uint32_t a1 = *reinterpret_cast<const uint32_t*>(ar + 8 * kMmPitch);
      const uint32_t a2 = *reinterpret_cast<const uint32_t*>(ar + 16);
      const uint32_t a3 = *reinterpret_cast<const uint32_t*>(ar + 8 * kMmPitch + 16);
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        const unsigned char* br = sT + (nt * 8 + g) * kMmPitch + ks * 32 + tq * 4;
        mma_s8(acc[nt], a0, a1, a2, a3, *reinterpret_cast<const uint32_t*>(br),
               *reinterpret_cast<const uint32_t*>(br + 16));
      }
    }
    __syncthreads();  // every warp has read sT and part
  }
#pragma unroll
  for (int nt = 0; nt < 16; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) out[gidx(nt, e)] = abs(acc[nt][e]) & 0xFFFF;
}

// ------------------------------------------------------------- P16 / P17
template <int NW, int NMUL, int RED>
__global__ void probe_mul_chain(CurveConsts c, const uint4* frag, uint32_t* out,
                                const uint32_t* a, const uint32_t* b,
                                long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (RED == 0 && i >= n) return;
  const long long e = i < n ? i : n - 1;
  using Mul = std::conditional_t<RED == 1, TcMul, CiosMul>;
  const Mul mul(frag, RED == 1 ? tc_warp_smem() : nullptr);
  constexpr int S = 2 * NW;  // 16-bit limb rows
  Fe<NW, 1> x = load_limbs<NW, 1>(a + e * S);
  const Fe<NW, 1> y = load_limbs<NW, 1>(b + e * S);
#pragma unroll 1
  for (int k = 0; k < NMUL; ++k) x = mul(x, y, c);
  if (i < n) store_limbs<NW, 1>(out + i * S, x);
}

constexpr int kChainThreads = 128;

template <int NMUL, int RED>
cudaError_t launch_chain(const CurveConsts& c, const uint4* frag, uint32_t* out,
                         const uint32_t* a, const uint32_t* b, long long n,
                         cudaStream_t s) {
  auto kern = probe_mul_chain<kNW, NMUL, RED>;
  const int smem = RED == 1 ? kChainThreads / 32 * kTcWords * 4 : 0;
  if (smem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<blocks_for(n, kChainThreads), kChainThreads, smem, s>>>(c, frag, out, a,
                                                                  b, n);
  return cudaSuccess;
}

}  // namespace

extern "C" int zkp_probe_u32_ops(int op, void* out, const void* x,
                                 long long n, void* stream) {
  if (op < 0 || op > 3 || n <= 0) return (int)cudaErrorInvalidValue;
  using Kern = decltype(&probe_u32_ops<0>);
  static const Kern kerns[4] = {&probe_u32_ops<0>, &probe_u32_ops<1>,
                                &probe_u32_ops<2>, &probe_u32_ops<3>};
  kerns[op]<<<blocks_for(n, 256), 256, 0, (cudaStream_t)stream>>>(
      (uint32_t*)out, (const uint32_t*)x, n);
  return (int)cudaGetLastError();
}

// n_mm 1, 8 or 32; m2d (256, 256) int8; x, out (32, 8 * ntiles, 128)
extern "C" int zkp_probe_band_mma(int n_mm, void* out, const void* m2d,
                                  const void* x, int ntiles, void* stream) {
  if ((n_mm != 1 && n_mm != 8 && n_mm != 32) || ntiles <= 0)
    return (int)cudaErrorInvalidValue;
  using Kern = decltype(&probe_band_mma<1>);
  const Kern kern = n_mm == 1   ? &probe_band_mma<1>
                    : n_mm == 8 ? &probe_band_mma<8>
                                : &probe_band_mma<32>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMmSmem);
  if (e != cudaSuccess) return (int)e;
  kern<<<ntiles, kMmWarps * 32, kMmSmem, (cudaStream_t)stream>>>(
      (int32_t*)out, (const int8_t*)m2d, (const uint32_t*)x, ntiles);
  return (int)cudaGetLastError();
}

// nmul 1 or 4; red 0 (CIOS) or 1 (tensor cores, frag from
// ops/mont_tc.fragment_table); a, b, out (n, 2 NW) limb rows
extern "C" int zkp_probe_mul_chain(const uint32_t* consts, const void* frag,
                                   int nmul, int red, void* out, const void* a,
                                   const void* b, long long n, void* stream) {
  if (consts[0] != kNW || (nmul != 1 && nmul != 4) || (red != 0 && red != 1) ||
      (red == 1 && !frag) || n <= 0)
    return (int)cudaErrorInvalidValue;
  const CurveConsts c = parse_consts(consts);
  using Launch = decltype(&launch_chain<1, 0>);
  static const Launch launch[2][2] = {{&launch_chain<1, 0>, &launch_chain<4, 0>},
                                      {&launch_chain<1, 1>, &launch_chain<4, 1>}};
  const cudaError_t e = launch[red][nmul == 4](
      c, (const uint4*)frag, (uint32_t*)out, (const uint32_t*)a,
      (const uint32_t*)b, n, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
