// K3 / K4 rcb_team_scan: the projective RCB block scans of the prover's
// MSM, modes 1 and 2 of the C entry zkp_rcb_scan (rcb_scan.cu). Replaces
// ckb_zkp_tpu/ops/pallas_rcb.py _scan_prefix_add_kernel (K3: every
// inclusive prefix W and the block total T) and _scan_total_add_kernel
// (K4: T only). Each block of B elements is left-folded from the identity
// (0 : 1 : 0) with Alg. 7 (rcb.cuh rcb_add), in order.
//
// What bounds it on the H100: the latency of one chain of B dependent
// adds, not the IMAD rate. The MSM's levels give 2-4096 chains a launch
// (ops/msm.py _boundary_before, _reduce_pts), too few for one thread per
// chain to fill 132 SMs, and one thread runs Alg. 7's twelve products in
// a row (36 over Fq2). So a team of lanes runs one chain, never across
// warps. Measured on an H100 (PERF.md): a G1 step takes about 4.5 us, most of
// it one lane's Montgomery product latency, at every chain count; only
// the widest G2 levels are bound by the warps' issue rate instead. Alg. 7 has three levels of independent work, and each lane
// computes one product of a level:
//   L1: t0 = X1 X2, t1 = Y1 Y2, t2 = Z1 Z2, (X1+Y1)(X2+Y2), (Y1+Z1)(Y2+Z2),
//       (X1+Z1)(X2+Z2);
//   L2: the adds and subtracts, 3b t2 and 3b Y3;
//   L3: t3 t1', t4 Y3', t1' Z3, Y3' t0', Z3 t4, t0' t3;
//   then X3, Y3, Z3.
// Two team shapes:
//   8 lanes a chain (G1; G2 above the split limit): six lanes each run one
//     Fe product of L1 and L3 (an Fq2 product is field.cuh fe_mul's three
//     Fq products in one lane) and one operand of L3 at L2 (G1's 3b is
//     fe_mul_b3's add chain, G2's an Fq2 product), three lanes X3, Y3, Z3;
//     four warp syncs a step.
//   A warp a chain (G2 up to the split limit): each Fq2 product split into
//     Karatsuba's three Fq products v0, v1, v2 on three lanes, 18 lanes at
//     L1 and L3; the six parts of the two 3b products on six lanes while
//     eight others form t3, t4, 3 t0 and t1 (L2a), then six lanes combine
//     them into 3b Y3, Z3 and t1 - 3b t2 (L2b); five warp syncs a step. The
//     shorter chain of products wins where chains are few; where they are
//     many, the 8-lane team's fuller lanes win (PERF.md).
// Every value is formed by the same field operations as rcb_add, and every
// field operation returns the canonical representative, so the outputs
// are the same bits as the one-thread formula's and the plain version's.
// Operands and results pass through the team's own slot of shared memory,
// with __syncwarp(team mask) between levels; lanes read absent summands
// from zero rows, so a level is one code path. The accumulator stays in
// the slot for all B steps. Element b+1 is copied into the slot by
// cp.async (16 B a lane, its limb rows as they lie in device memory) while
// step b multiplies, and converted to words once, by the lanes that copied
// it, while the last level runs. W and T are stored by the whole team,
// 16 B a lane. Word rows are padded to NW + 1 words and 8-lane team slots
// to 8 words mod 32, so the lanes of a warp reading distinct rows hit
// distinct banks.
//
// Blocks: 256 threads (the scan probe's best), halved down to one warp while the
// grid would have fewer blocks than the card has SMs, so that narrow
// levels spread over the SMs. A team past the last chain returns at once:
// no other team's __syncwarp waits on its lanes. Slots at 256 threads:
// 29,696 B (G1), 18,048 B (G2, a warp a chain) and 58,368 B (G2, 8 lanes a
// chain: above 48 KB, so the launch raises the kernel's dynamic
// shared-memory limit first and returns that call's error). The launch is
// on the caller's stream; it allocates nothing and does not synchronise.
#include <cuda_pipeline.h>

#include "rcb.cuh"

using namespace zkp;

extern "C" int zkp_rcb_team_block(int ext, long long ncols);

// G2 chains up to this count run split (a warp a chain); more run 8 lanes
// a chain. On the H100 the warp team wins at 2-128 chains (0.25-0.28 ms
// against 0.62-0.71 for the 8-lane team at B = 32), the two tie at 2048
// (0.68 ms), and the 8-lane team wins at 4096 (0.72 against 1.26 ms;
// PERF.md).
constexpr long long kSplitMax = 2048;

namespace {

// SPLIT (G2 only): a warp a chain, each Fq2 product split into Karatsuba's
// three Fq products on three lanes. Else 8 lanes a chain, one Fe product
// (Fq, or a whole Fq2 product) a lane.
template <int NW, int EXT, bool SPLIT>
struct Team {
  static_assert(EXT == 2 || !SPLIT, "only an Fq2 product splits");
  static constexpr int T = SPLIT ? 32 : 8;     // lanes of a team
  static constexpr int P = SPLIT ? 3 : EXT;    // V rows of one Fe product
  static constexpr int ROW = NW + 1;           // words of a padded row
  static constexpr int S = 2 * NW * EXT;       // int32 limbs of a coordinate
  static constexpr int CH = 3 * S / 4;         // 16-byte chunks of a point
  // word rows of the slot
  static constexpr int ZERO = 0;               // [EXT] zero rows
  static constexpr int ACC = EXT;              // [3][EXT] accumulator
  static constexpr int LEAF = ACC + 3 * EXT;   // [3][EXT] this step's element
  static constexpr int V = LEAF + 3 * EXT;     // [6][P] L1 and L3 products
  static constexpr int OPS = V + 6 * P;        // [6][EXT] L3's operands
  static constexpr int W2 = OPS + 6 * EXT;     // SPLIT: [2][3] parts of 3b t2, 3b Y3
  static constexpr int T1 = W2 + (SPLIT ? 6 : 0);  // SPLIT: [EXT] t1
  static constexpr int NROWS = T1 + (SPLIT ? EXT : 0);
  // a slot: the staged limb rows (16-byte aligned), then the word rows;
  // a multiple of 4 words, and 8 mod 32 where teams share a warp
  static constexpr int RAW = 3 * S;
  static constexpr int USED = RAW + NROWS * ROW;
  static constexpr int WORDS =
      T < 32 ? (USED + 23) / 32 * 32 + 8 : (USED + 3) / 4 * 4;
};

// L1's products: coordinates i1 and i2 (-1: none) of each side summed, for
// t0 = X1 X2, t1 = Y1 Y2, t2 = Z1 Z2, (X1+Y1)(X2+Y2), (Y1+Z1)(Y2+Z2),
// (X1+Z1)(X2+Z2); L3's products as pairs of OPS entries: t3 t1', t4 Y3',
// t1' Z3, Y3' t0', Z3 t4, t0' t3 (OPS: 0 t3, 1 t4, 2 t0' = 3 t0,
// 3 Y3' = 3b Y3, 4 Z3, 5 t1' = t1 - 3b t2)
__constant__ int kL1A[6] = {0, 1, 2, 0, 1, 0};
__constant__ int kL1B[6] = {-1, -1, -1, 1, 2, 2};
__constant__ int kL3A[6] = {0, 1, 5, 3, 4, 2};
__constant__ int kL3B[6] = {5, 3, 4, 2, 1, 0};

template <int NW>
__device__ __forceinline__ void ld_row(uint32_t* r, const uint32_t* row) {
#pragma unroll
  for (int i = 0; i < NW; ++i) r[i] = row[i];
}

template <int NW>
__device__ __forceinline__ void st_row(uint32_t* row, const uint32_t* r) {
#pragma unroll
  for (int i = 0; i < NW; ++i) row[i] = r[i];
}

// the Fe whose EXT component rows start at row `first`
template <int NW, int EXT, int ROW>
__device__ __forceinline__ Fe<NW, EXT> ld_fe(const uint32_t* rows, int first) {
  Fe<NW, EXT> r;
#pragma unroll
  for (int k = 0; k < EXT; ++k) ld_row<NW>(r.v[k], rows + (first + k) * ROW);
  return r;
}

template <int NW, int EXT, int ROW>
__device__ __forceinline__ void st_fe(uint32_t* rows, int first,
                                      const Fe<NW, EXT>& a) {
#pragma unroll
  for (int k = 0; k < EXT; ++k) st_row<NW>(rows + (first + k) * ROW, a.v[k]);
}

// SPLIT: part s of an Fq2 operand, the sum of entries i1 and i2 (i2 < 0:
// none) of the [.][2] rows at base: component 0 (s = 0), component 1
// (s = 1) or their sum (s = 2, Karatsuba's third product). Absent
// summands are the zero row, so every lane adds the same number of rows.
template <int NW, int ROW>
__device__ __forceinline__ void part_sum(uint32_t* r, const uint32_t* rows,
                                         int base, int i1, int i2, int s,
                                         const CurveConsts& c) {
  const int c0 = s == 1 ? 1 : 0;
  const bool both = s == 2;
  uint32_t t[NW];
  ld_row<NW>(r, rows + (base + i1 * 2 + c0) * ROW);
  constexpr int Z = Team<NW, 2, true>::ZERO;
  ld_row<NW>(t, rows + (i2 >= 0 ? base + i2 * 2 + c0 : Z) * ROW);
  fp_add<NW>(r, r, t, c);
  ld_row<NW>(t, rows + (both ? base + i1 * 2 + 1 : Z) * ROW);
  fp_add<NW>(r, r, t, c);
  ld_row<NW>(t, rows + (both && i2 >= 0 ? base + i2 * 2 + 1 : Z) * ROW);
  fp_add<NW>(r, r, t, c);
}

// SPLIT: component comp of the Fq2 product whose three part rows start at
// row first: Karatsuba's v0 - v1 and v2 - (v0 + v1) (field.cuh fe_mul).
template <int NW, int ROW>
__device__ __forceinline__ void prod_comp(uint32_t* r, const uint32_t* rows,
                                          int first, int comp,
                                          const CurveConsts& c) {
  uint32_t v0[NW], v1[NW];
  ld_row<NW>(v0, rows + first * ROW);
  ld_row<NW>(v1, rows + (first + 1) * ROW);
  if (comp == 0) {
    fp_sub<NW>(r, v0, v1, c);
  } else {
    ld_row<NW>(r, rows + (first + 2) * ROW);
    fp_add<NW>(v0, v0, v1, c);
    fp_sub<NW>(r, r, v0, c);
  }
}

template <int NW, int EXT, bool SPLIT, bool PREFIX>
__global__ void __launch_bounds__(256)
    rcb_team_scan(CurveConsts c, uint32_t* wx, uint32_t* wy, uint32_t* wz,
                  uint32_t* tx, uint32_t* ty, uint32_t* tz, const uint32_t* x,
                  const uint32_t* y, const uint32_t* z, long long ncols,
                  int B) {
  using L = Team<NW, EXT, SPLIT>;
  using F = Fe<NW, EXT>;
  constexpr int T = L::T, P = L::P, ROW = L::ROW, S = L::S;
  extern __shared__ __align__(16) uint32_t smem[];
  const int lane = threadIdx.x % T;
  const long long g = (long long)blockIdx.x * (blockDim.x / T) + threadIdx.x / T;
  if (g >= ncols) return;  // the whole team
  const unsigned mask = (0xFFFFFFFFu >> (32 - T)) << (threadIdx.x % 32 / T * T);
  uint32_t* raw = smem + (threadIdx.x / T) * L::WORDS;
  uint32_t* rows = raw + L::RAW;
  auto row = [&](int r) { return rows + r * ROW; };
  auto ld = [&](int first) { return ld_fe<NW, EXT, ROW>(rows, first); };
  auto st = [&](int first, const F& a) { st_fe<NW, EXT, ROW>(rows, first, a); };

  // chunk q of a point: coordinate q / (S/4), limbs 4 (q % (S/4)) ..+3,
  // which are words 2 (q % (S/4)) and the next of that coordinate
  auto stage = [&](long long e) {
    for (int q = lane; q < L::CH; q += T) {
      const int i = q / (S / 4), o = 4 * (q % (S / 4));
      const uint32_t* src = i == 0 ? x : i == 1 ? y : z;
      __pipeline_memcpy_async(raw + i * S + o, src + e * S + o, 16);
    }
    __pipeline_commit();
  };
  auto convert = [&]() {  // this lane's staged chunks -> LEAF words
    __pipeline_wait_prior(0);
    for (int q = lane; q < L::CH; q += T) {
      const int i = q / (S / 4), w = 2 * (q % (S / 4));
      const uint4 u = *reinterpret_cast<const uint4*>(raw + i * S + 2 * w);
      uint32_t* d = row(L::LEAF + i * EXT + w / NW) + w % NW;
      d[0] = (u.x & 0xFFFFu) | (u.y << 16);
      d[1] = (u.z & 0xFFFFu) | (u.w << 16);
    }
  };
  auto store = [&](uint32_t* dx, uint32_t* dy, uint32_t* dz, long long e) {
    for (int q = lane; q < L::CH; q += T) {
      const int i = q / (S / 4), w = 2 * (q % (S / 4));
      const uint32_t* s = row(L::ACC + i * EXT + w / NW) + w % NW;
      const uint32_t a0 = s[0], a1 = s[1];
      uint32_t* d = (i == 0 ? dx : i == 1 ? dy : dz) + e * S + 2 * w;
      *reinterpret_cast<uint4*>(d) =
          make_uint4(a0 & 0xFFFFu, a0 >> 16, a1 & 0xFFFFu, a1 >> 16);
    }
  };

  const long long e0 = g * B;
  stage(e0);
  for (int r = lane; r < L::LEAF; r += T) {  // the zero rows; ACC = (0 : 1 : 0)
    const bool one = r == L::ACC + EXT;
    for (int i = 0; i < NW; ++i) row(r)[i] = one ? c.one[i] : 0u;
  }
  convert();
  __syncwarp(mask);

  for (int b = 0; b < B; ++b) {
    const long long e = e0 + b;
    if (b + 1 < B) stage(e + 1);
    // L1
    if constexpr (SPLIT) {  // part s = lane % 3 of product k = lane / 3
      if (lane < 18) {
        const int k = lane / 3, s = lane % 3;
        uint32_t a[NW], q[NW];
        part_sum<NW, ROW>(a, rows, L::ACC, kL1A[k], kL1B[k], s, c);
        part_sum<NW, ROW>(q, rows, L::LEAF, kL1A[k], kL1B[k], s, c);
        fp_mul<NW>(a, a, q, c);
        st_row<NW>(row(L::V + lane), a);
      }
    } else if (lane < 6) {  // product k = lane
      const int i2 = kL1B[lane];
      const F a = fe_add<NW, EXT>(ld(L::ACC + kL1A[lane] * EXT),
                                  ld(i2 >= 0 ? L::ACC + i2 * EXT : L::ZERO), c);
      const F q = fe_add<NW, EXT>(ld(L::LEAF + kL1A[lane] * EXT),
                                  ld(i2 >= 0 ? L::LEAF + i2 * EXT : L::ZERO), c);
      st(L::V + lane * EXT, fe_mul<NW, EXT>(a, q, c));
    }
    __syncwarp(mask);
    if constexpr (!SPLIT) {
      // L2: lane o forms OPS[o] from t0..t2, m3..m5 = V[0..5]
      if (lane < 6) {
        F r;
        switch (lane) {
          case 0:  // t3 = m3 - (t0 + t1)
          case 1:  // t4 = m4 - (t1 + t2)
            r = fe_sub<NW, EXT>(ld(L::V + (3 + lane) * EXT),
                                fe_add<NW, EXT>(ld(L::V + lane * EXT),
                                                ld(L::V + (lane + 1) * EXT), c),
                                c);
            break;
          case 2: {  // 3 t0 = (t0 + t0) + t0
            const F u = ld(L::V);
            r = fe_add<NW, EXT>(fe_add<NW, EXT>(u, u, c), u, c);
            break;
          }
          case 3:  // 3b Y3, Y3 = m5 - (t0 + t2)
            r = fe_mul_b3<NW, EXT>(
                fe_sub<NW, EXT>(ld(L::V + 5 * EXT),
                                fe_add<NW, EXT>(ld(L::V), ld(L::V + 2 * EXT), c), c),
                c);
            break;
          default: {  // Z3 = t1 + 3b t2, t1' = t1 - 3b t2
            const F u = fe_mul_b3<NW, EXT>(ld(L::V + 2 * EXT), c);
            const F v = ld(L::V + EXT);
            r = lane == 4 ? fe_add<NW, EXT>(v, u, c) : fe_sub<NW, EXT>(v, u, c);
          }
        }
        st(L::OPS + lane * EXT, r);
      }
      __syncwarp(mask);
    } else {
      // L2a: lanes 0-5 the Karatsuba parts of 3b t2 (0-2) and 3b Y3 (3-5);
      // lanes 6-13 t3, t4, 3 t0 and t1, one component each
      if (lane < 6) {
        const int s = lane % 3;
        uint32_t u[2][NW], m[NW], t[NW];
#pragma unroll
        for (int comp = 0; comp < 2; ++comp) {
          prod_comp<NW, ROW>(u[comp], rows, L::V + 2 * P, comp, c);  // t2
          if (lane >= 3) {  // Y3 = m5 - (t0 + t2)
            prod_comp<NW, ROW>(m, rows, L::V + 5 * P, comp, c);
            prod_comp<NW, ROW>(t, rows, L::V, comp, c);
            fp_add<NW>(t, t, u[comp], c);
            fp_sub<NW>(u[comp], m, t, c);
          }
        }
        uint32_t a[NW], kc[NW];
        if (s == 2) {
          fp_add<NW>(a, u[0], u[1], c);
          fp_add<NW>(kc, c.b3[0], c.b3[1], c);
        } else {
#pragma unroll
          for (int i = 0; i < NW; ++i) {
            a[i] = s ? u[1][i] : u[0][i];
            kc[i] = s ? c.b3[1][i] : c.b3[0][i];
          }
        }
        fp_mul<NW>(a, a, kc, c);
        st_row<NW>(row(L::W2 + lane), a);
      } else if (lane < 14) {
        const int o = (lane - 6) / 2, comp = lane % 2;
        uint32_t r[NW], u[NW], v[NW];
        if (o < 2) {  // t3 = m3 - (t0 + t1), t4 = m4 - (t1 + t2)
          prod_comp<NW, ROW>(u, rows, L::V + o * P, comp, c);
          prod_comp<NW, ROW>(v, rows, L::V + (o + 1) * P, comp, c);
          prod_comp<NW, ROW>(r, rows, L::V + (o + 3) * P, comp, c);
          fp_add<NW>(u, u, v, c);
          fp_sub<NW>(r, r, u, c);
          st_row<NW>(row(L::OPS + o * EXT + comp), r);
        } else if (o == 2) {  // 3 t0
          prod_comp<NW, ROW>(u, rows, L::V, comp, c);
          fp_add<NW>(r, u, u, c);
          fp_add<NW>(r, r, u, c);
          st_row<NW>(row(L::OPS + 2 * EXT + comp), r);
        } else {  // t1
          prod_comp<NW, ROW>(r, rows, L::V + P, comp, c);
          st_row<NW>(row(L::T1 + comp), r);
        }
      }
      __syncwarp(mask);
      // L2b: 3b Y3 (lanes 0-1), Z3 = t1 + 3b t2 (2-3), t1 - 3b t2 (4-5)
      if (lane < 6) {
        const int o = lane / 2, comp = lane % 2;
        uint32_t r[NW], t1[NW];
        prod_comp<NW, ROW>(r, rows, L::W2 + (o == 0 ? 3 : 0), comp, c);
        if (o > 0) {
          ld_row<NW>(t1, row(L::T1 + comp));
          if (o == 1)
            fp_add<NW>(r, t1, r, c);
          else
            fp_sub<NW>(r, t1, r, c);
        }
        st_row<NW>(row(L::OPS + (3 + o) * EXT + comp), r);
      }
      __syncwarp(mask);
    }
    // L3: product k of OPS entries kL3A[k] and kL3B[k]
    if constexpr (SPLIT) {
      if (lane < 18) {
        const int k = lane / 3, s = lane % 3;
        uint32_t a[NW], q[NW];
        part_sum<NW, ROW>(a, rows, L::OPS, kL3A[k], -1, s, c);
        part_sum<NW, ROW>(q, rows, L::OPS, kL3B[k], -1, s, c);
        fp_mul<NW>(a, a, q, c);
        st_row<NW>(row(L::V + lane), a);
      }
    } else if (lane < 6) {
      st(L::V + lane * EXT, fe_mul<NW, EXT>(ld(L::OPS + kL3A[lane] * EXT),
                                            ld(L::OPS + kL3B[lane] * EXT), c));
    }
    __syncwarp(mask);
    // X3 = q0 - q1, Y3 = q2 + q3, Z3 = q4 + q5 (SPLIT: one component a
    // lane); meanwhile every lane converts its chunks of element b + 1
    if constexpr (SPLIT) {
      if (lane < 6) {
        const int i = lane / 2, comp = lane % 2;
        uint32_t u[NW], v[NW];
        prod_comp<NW, ROW>(u, rows, L::V + 2 * i * P, comp, c);
        prod_comp<NW, ROW>(v, rows, L::V + (2 * i + 1) * P, comp, c);
        if (i == 0)
          fp_sub<NW>(u, u, v, c);
        else
          fp_add<NW>(u, u, v, c);
        st_row<NW>(row(L::ACC + lane), u);
      }
    } else if (lane < 3) {
      const F u = ld(L::V + 2 * lane * EXT), v = ld(L::V + (2 * lane + 1) * EXT);
      st(L::ACC + lane * EXT, lane == 0 ? fe_sub<NW, EXT>(u, v, c)
                                        : fe_add<NW, EXT>(u, v, c));
    }
    if (b + 1 < B) convert();
    __syncwarp(mask);
    if constexpr (PREFIX) store(wx, wy, wz, e);
  }
  store(tx, ty, tz, g);
}

int g_sms = 0;  // the card's SM count, read at the first launch

int sm_count() {
  if (!g_sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, dev);
    if (g_sms <= 0) g_sms = 132;
  }
  return g_sms;
}

bool split(int ext, long long ncols) { return ext == 2 && ncols <= kSplitMax; }

template <int EXT, bool SPLIT, bool PREFIX>
cudaError_t launch(const CurveConsts& c, uint32_t* wx, uint32_t* wy,
                   uint32_t* wz, uint32_t* tx, uint32_t* ty, uint32_t* tz,
                   const uint32_t* x, const uint32_t* y, const uint32_t* z,
                   long long ncols, int B, cudaStream_t s) {
  using L = Team<kNW, EXT, SPLIT>;
  const int threads = zkp_rcb_team_block(EXT, ncols);
  const size_t smem = (size_t)(threads / L::T) * L::WORDS * sizeof(uint32_t);
  auto kern = &rcb_team_scan<kNW, EXT, SPLIT, PREFIX>;
  if (smem > 48 * 1024) {  // the 8-lane G2 team at 256 threads: 58,368 B
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<blocks_for(ncols * L::T, threads), threads, smem, s>>>(
      c, wx, wy, wz, tx, ty, tz, x, y, z, ncols, B);
  return cudaSuccess;
}

}  // namespace

// Lanes of one chain's team: 32 (G2, split) or 8.
extern "C" int zkp_rcb_team_lanes(int ext, long long ncols) {
  return split(ext, ncols) ? 32 : 8;
}

// Threads per block of the team scan for ncols chains: 256, halved (down
// to one warp) while the grid would have fewer blocks than SMs.
extern "C" int zkp_rcb_team_block(int ext, long long ncols) {
  const long long lanes = ncols * zkp_rcb_team_lanes(ext, ncols);
  int threads = 256;
  while (threads > 32 && (lanes + threads - 1) / threads < sm_count())
    threads /= 2;
  return threads;
}

namespace zkp {

// K3 (prefix) or K4 (totals only); the inputs are checked by zkp_rcb_scan.
// Returns the error of a refused shared-memory attribute, else cudaSuccess.
int launch_rcb_team_scan(const CurveConsts& c, int ext, bool prefix,
                         uint32_t* wx, uint32_t* wy, uint32_t* wz,
                         uint32_t* tx, uint32_t* ty, uint32_t* tz,
                         const uint32_t* x, const uint32_t* y,
                         const uint32_t* z, long long ncols, int B,
                         cudaStream_t s) {
  decltype(&launch<1, false, false>) f;
  if (ext == 1)
    f = prefix ? &launch<1, false, true> : &launch<1, false, false>;
  else if (split(ext, ncols))
    f = prefix ? &launch<2, true, true> : &launch<2, true, false>;
  else
    f = prefix ? &launch<2, false, true> : &launch<2, false, false>;
  return (int)f(c, wx, wy, wz, tx, ty, tz, x, y, z, ncols, B, s);
}

}  // namespace zkp
