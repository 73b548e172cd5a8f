// The team of lanes that runs one Jacobian point operation on Hopper, and
// the kernels built on it: K8 (ec_team_add: one complete add a team;
// ec_team_chain: a chain of doublings and adds a team, the MSM's window
// folds, and K9c's block totals: a chain of B adds from a block's first
// point). Their entry is ec_add.cu.
//
// The Jacobian formulas of ec_jac.cuh are long chains of dependent field
// products: the complete add (_add_core) is 16 of them, the doubling
// (_double_core) 7. One thread runs them in a row, so a launch of a few
// points, or a few chains, lasts one lane's latency of 16 (or 23) products
// a step, and the MSM launches K8 at 1 to 16384 points and K9c at 2048
// chains. Here each product of a level of
// independent products is one lane's (the levels of the add: Z1Z1, Z2Z2,
// Z1Z2 | U1, U2, Z2 Z2Z2, Z1 Z1Z1 | S1, S2 | HH, r^2, Z1Z2 H | HHH, V |
// r (V - X3), S1 HHH; of the doubling: X^2, Y^2, YZ | C = B^2, (X + B)^2,
// E^2 | E (D - X3)), and the adds and subtractions between them are
// "linear" levels, a sequence of them a lane. The add's branch (p or q
// infinite, p == q, which doubles) is decided once a team from the shared
// operands, so every lane takes it; the team takes the branch jac_add
// takes, and every value is a canonical field value of the same formula,
// so the outputs are the same bits as the one-thread kernels' and the
// plain versions'.
//
// Two team shapes:
//   4 lanes (G1; G2 above kEcSplitMax points or chains): each lane one Fe
//     product of a level (an Fq2 product is field.cuh fe_mul's three Fq
//     products in one lane) or one linear sequence over all components.
//   16 lanes (G2 up to kEcSplitMax): each Fq2 product split into Karatsuba's
//     three Fq products v0, v1, v2 on three lanes (12 lanes at the add's
//     widest level), then combined into its two components by two lanes; a
//     linear sequence runs on two lanes, one component each.
// Operands and results live in the team's slot of shared memory, in word
// rows of NW + 1 words (so lanes reading distinct rows hit distinct banks),
// with __syncwarp(team mask) after every level. The sum's X3, Y3 and Z3
// overwrite the accumulator rows once no level reads them. The chains
// stage their next element into the slot's first words by cp.async (16 B a
// lane, as it lies in device memory) while a step runs, and convert it to
// word rows once, by the lanes that copied it, as rcb_team.cuh's teams do.
//
// Blocks: 256 threads, halved (down to one warp) while the grid would have
// fewer blocks than the card has SMs, as rcb_team.cuh's teams. A team past
// the last point returns at once. A slot above 48 KB a block makes the
// launcher raise the kernel's dynamic shared-memory limit first. Launches
// are on the caller's stream; they allocate nothing and do not synchronise.
#pragma once

#include "ec_jac.cuh"
#include "rcb_team.cuh"  // (cuda_pipeline.h, ld_row, st_row, sm_count)

namespace zkp {
namespace {

// G2 points (or chains) up to this count run split (16 lanes a team); more
// run 4 lanes a team. On the H100 the split team wins K8 at 2-2048 points (device
// 0.0086-0.0130 ms against 0.0131-0.0192 for 4 lanes) and loses at 16384
// (0.0322 against 0.0214 ms; PERF.md, K8 at every shape).
constexpr long long kEcSplitMax = 2048;

bool ec_split(int ext, long long n) { return ext == 2 && n <= kEcSplitMax; }

// Threads per block for n teams of `lanes` lanes: 256, halved (down to one
// warp) while the grid would have fewer blocks than SMs.
int ec_block(long long n, int lanes) {
  int threads = 256;
  while (threads > 32 && (n * lanes + threads - 1) / threads < sm_count())
    threads /= 2;
  return threads;
}

// Fe slots of the team (each EXT word rows): the accumulator P, the element
// Q, then temporaries named after the add's values; the doubling reuses
// them.
enum : int {
  X1, Y1, Z1, X2, Y2, Z2,
  Z1Z1, Z2Z2, Z1Z2, U1, U2, Z2C, Z1C, S1, S2, HD, RD, HH, RR, HHH, VV, TD, RVX, SHH,
  NFE
};

struct Prod {
  int d, a, b;  // Fe slots: d = a * b
};

// One team's lanes and slot. SPLIT (G2 only): 16 lanes, each Fq2 product
// split over three; else 4 lanes. STAGE: the slot also holds the raw limbs
// of the next point, copied by cp.async (the chain's; K8 stages none).
template <int NW, int EXT, bool SPLIT, bool STAGE = false>
struct EcTeam {
  static_assert(EXT == 2 || !SPLIT, "only an Fq2 product splits");
  using F = Fe<NW, EXT>;
  static constexpr int T = SPLIT ? 16 : 4;      // lanes of a team
  static constexpr int ROW = NW + 1;            // words of a padded row
  static constexpr int S = 2 * NW * EXT;        // int32 limbs of a coordinate
  static constexpr int CH = 3 * S / 4;          // 16-byte chunks of a point
  static constexpr int PARTS = NFE * EXT;       // SPLIT: 12 Karatsuba part rows
  static constexpr int NROWS = PARTS + (SPLIT ? 12 : 0);
  static constexpr int RAW = STAGE ? 3 * S : 0;  // words of the staged point
  static_assert(RAW % 4 == 0, "the staged words stay 16-byte aligned");
  // a slot: the staged words, then the word rows, 16-byte aligned
  static constexpr int WORDS = (RAW + NROWS * ROW + 3) / 4 * 4;

  const int lane;
  const unsigned mask;
  uint32_t* const raw;
  uint32_t* const rows;

  __device__ __forceinline__ explicit EcTeam(uint32_t* smem)
      : lane(threadIdx.x % T),
        mask((0xFFFFFFFFu >> (32 - T)) << (threadIdx.x % 32 / T * T)),
        raw(smem + threadIdx.x / T * WORDS),
        rows(raw + RAW) {}

  // this thread's team in the grid
  static __device__ __forceinline__ long long index() {
    return (long long)blockIdx.x * (blockDim.x / T) + threadIdx.x / T;
  }

  __device__ __forceinline__ void sync() const { __syncwarp(mask); }
  // component k of Fe slot f
  __device__ __forceinline__ uint32_t* row(int f, int k = 0) const {
    return rows + (f * EXT + k) * ROW;
  }
  __device__ __forceinline__ F ld(int f) const {
    F r;
#pragma unroll
    for (int k = 0; k < EXT; ++k) ld_row<NW>(r.v[k], row(f, k));
    return r;
  }
  __device__ __forceinline__ void st(int f, const F& a) const {
#pragma unroll
    for (int k = 0; k < EXT; ++k) st_row<NW>(row(f, k), a.v[k]);
  }

  // every lane: is Fe slot f zero (read after a sync, so the team agrees)
  __device__ __forceinline__ bool zero(int f) const {
    uint32_t acc = 0;
#pragma unroll
    for (int k = 0; k < EXT; ++k)
#pragma unroll
      for (int i = 0; i < NW; ++i) acc |= row(f, k)[i];
    return acc == 0;
  }

  // point e's limb rows into Fe slots first .. first + 2 as word rows
  __device__ __forceinline__ void load_point(int first, const uint32_t* x,
                                             const uint32_t* y,
                                             const uint32_t* z,
                                             long long e) const {
    for (int q = lane; q < CH; q += T) {
      const int i = q / (S / 4), w = 2 * (q % (S / 4));
      const uint32_t* src = i == 0 ? x : i == 1 ? y : z;
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(src + e * S + 2 * w));
      uint32_t* d = row(first + i, w / NW) + w % NW;
      d[0] = (u.x & 0xFFFFu) | (u.y << 16);
      d[1] = (u.z & 0xFFFFu) | (u.w << 16);
    }
  }

  // cp.async of point e of (x, y, z) into raw; chunk q: coordinate
  // q / (S/4), limbs 4 (q % (S/4)) ..+3
  __device__ __forceinline__ void stage(const uint32_t* x, const uint32_t* y,
                                        const uint32_t* z, long long e) const {
    for (int q = lane; q < CH; q += T) {
      const int i = q / (S / 4), o = 4 * (q % (S / 4));
      const uint32_t* src = i == 0 ? x : i == 1 ? y : z;
      __pipeline_memcpy_async(raw + i * S + o, src + e * S + o, 16);
    }
    __pipeline_commit();
  }

  // this lane's staged chunks -> Fe slots first .. first + 2 as word rows
  // (the team syncs before reading them)
  __device__ __forceinline__ void unstage(int first) const {
    __pipeline_wait_prior(0);
    for (int q = lane; q < CH; q += T) {
      const int i = q / (S / 4), w = 2 * (q % (S / 4));
      const uint4 u = *reinterpret_cast<const uint4*>(raw + i * S + 2 * w);
      uint32_t* d = row(first + i, w / NW) + w % NW;
      d[0] = (u.x & 0xFFFFu) | (u.y << 16);
      d[1] = (u.z & 0xFFFFu) | (u.w << 16);
    }
  }

  // the accumulator -> element e of (dx, dy, dz) as limb rows, 16 B a lane
  __device__ __forceinline__ void store(uint32_t* dx, uint32_t* dy,
                                        uint32_t* dz, long long e) const {
    for (int q = lane; q < CH; q += T) {
      const int i = q / (S / 4), w = 2 * (q % (S / 4));
      const uint32_t* s = row(X1 + i, w / NW) + w % NW;
      const uint32_t a0 = s[0], a1 = s[1];
      uint32_t* d = (i == 0 ? dx : i == 1 ? dy : dz) + e * S + 2 * w;
      *reinterpret_cast<uint4*>(d) =
          make_uint4(a0 & 0xFFFFu, a0 >> 16, a1 & 0xFFFFu, a1 >> 16);
    }
  }

  // Fe slot dst = slot src (all components), the rows spread over the lanes;
  // n slots from dst and src on
  __device__ __forceinline__ void copy(int dst, int src, int n) const {
    for (int r = lane; r < n * EXT * NW; r += T)
      row(dst)[r / NW * ROW + r % NW] = row(src)[r / NW * ROW + r % NW];
  }

  // One level of N independent products (N <= 4), then its sync(s).
  template <int N>
  __device__ __forceinline__ void mul(const Prod (&p)[N],
                                      const CurveConsts& c) const {
    if constexpr (SPLIT) {
      // part s = lane % 3 of product j = lane / 3, then the two components
      if (lane < 3 * N) {
        const int j = lane / 3, s = lane % 3;
        int a = 0, b = 0;
#pragma unroll
        for (int i = 0; i < N; ++i)
          if (i == j) a = p[i].a, b = p[i].b;
        uint32_t x[NW], y[NW];
        if (s < 2) {
          ld_row<NW>(x, row(a, s));
          ld_row<NW>(y, row(b, s));
        } else {
          uint32_t t[NW];
          ld_row<NW>(x, row(a, 0));
          ld_row<NW>(t, row(a, 1));
          fp_add<NW>(x, x, t, c);
          ld_row<NW>(y, row(b, 0));
          ld_row<NW>(t, row(b, 1));
          fp_add<NW>(y, y, t, c);
        }
        fp_mul<NW>(x, x, y, c);
        st_row<NW>(rows + (PARTS + lane) * ROW, x);
      }
      sync();
      if (lane < 2 * N) {  // Karatsuba: v0 - v1 and v2 - (v0 + v1)
        const int j = lane / 2, k = lane % 2;
        int d = 0;
#pragma unroll
        for (int i = 0; i < N; ++i)
          if (i == j) d = p[i].d;
        const uint32_t* v = rows + (PARTS + 3 * j) * ROW;
        uint32_t v0[NW], v1[NW], r[NW];
        ld_row<NW>(v0, v);
        ld_row<NW>(v1, v + ROW);
        if (k == 0) {
          fp_sub<NW>(r, v0, v1, c);
        } else {
          ld_row<NW>(r, v + 2 * ROW);
          fp_add<NW>(v0, v0, v1, c);
          fp_sub<NW>(r, r, v0, c);
        }
        st_row<NW>(row(d, k), r);
      }
    } else if (lane < N) {
      int d = 0, a = 0, b = 0;
#pragma unroll
      for (int i = 0; i < N; ++i)
        if (i == lane) d = p[i].d, a = p[i].a, b = p[i].b;
      st(d, fe_mul<NW, EXT>(ld(a), ld(b), c));
    }
    sync();
  }

  // One level of n linear sequences (n <= 3): f(seq, k0, k1) runs sequence
  // seq on components [k0, k1) (SPLIT: two lanes a sequence, one component
  // each; else one lane a sequence, every component). Then the sync.
  template <class Fn>
  __device__ __forceinline__ void lin(int n, Fn f) const {
    if constexpr (SPLIT) {
      if (lane < 2 * n) f(lane / 2, lane % 2, lane % 2 + 1);
    } else if (lane < n) {
      f(lane, 0, EXT);
    }
    sync();
  }

  // slot d = a + b or a - b on components [k0, k1)
  __device__ __forceinline__ void add(int d, int a, int b, int k0, int k1,
                                      const CurveConsts& c) const {
    for (int k = k0; k < k1; ++k) {
      uint32_t x[NW], y[NW];
      ld_row<NW>(x, row(a, k));
      ld_row<NW>(y, row(b, k));
      fp_add<NW>(x, x, y, c);
      st_row<NW>(row(d, k), x);
    }
  }
  __device__ __forceinline__ void sub(int d, int a, int b, int k0, int k1,
                                      const CurveConsts& c) const {
    for (int k = k0; k < k1; ++k) {
      uint32_t x[NW], y[NW];
      ld_row<NW>(x, row(a, k));
      ld_row<NW>(y, row(b, k));
      fp_sub<NW>(x, x, y, c);
      st_row<NW>(row(d, k), x);
    }
  }

  // _double_core on the accumulator, in place (its Z must not be zero;
  // the caller keeps an infinite one as it is, as jac_add(p, p) does).
  // A = X^2, B = Y^2, YZ | C = B^2, (X + B)^2, E^2 (E = 3A) | E (D - X3),
  // with D = 2((X + B)^2 - A - C), X3 = E^2 - 2D, Y3 = E (D - X3) - 8C,
  // Z3 = 2 YZ; slots: A Z1Z1, B Z2Z2, YZ Z1Z2, X + B U1, E U2, C Z2C,
  // (X + B)^2 Z1C, E^2 S1, D S2, 8C HD, E (D - X3) RVX.
  __device__ __forceinline__ void dbl(const CurveConsts& c) const {
    mul<3>({{Z1Z1, X1, X1}, {Z2Z2, Y1, Y1}, {Z1Z2, Y1, Z1}}, c);
    lin(2, [&](int q, int k0, int k1) {
      if (q == 0) {
        add(U1, X1, Z2Z2, k0, k1, c);
      } else {
        add(U2, Z1Z1, Z1Z1, k0, k1, c);
        add(U2, U2, Z1Z1, k0, k1, c);
      }
    });
    mul<3>({{Z2C, Z2Z2, Z2Z2}, {Z1C, U1, U1}, {S1, U2, U2}}, c);
    lin(3, [&](int q, int k0, int k1) {
      if (q == 0) {  // D, X3 (into X1), D - X3
        add(TD, Z1Z1, Z2C, k0, k1, c);
        sub(TD, Z1C, TD, k0, k1, c);
        add(S2, TD, TD, k0, k1, c);
        add(TD, S2, S2, k0, k1, c);
        sub(X1, S1, TD, k0, k1, c);
        sub(TD, S2, X1, k0, k1, c);
      } else if (q == 1) {  // 8C
        add(HD, Z2C, Z2C, k0, k1, c);
        add(HD, HD, HD, k0, k1, c);
        add(HD, HD, HD, k0, k1, c);
      } else {  // Z3 = 2 YZ (into Z1)
        add(Z1, Z1Z2, Z1Z2, k0, k1, c);
      }
    });
    mul<1>({{RVX, U2, TD}}, c);
    lin(1, [&](int, int k0, int k1) { sub(Y1, RVX, HD, k0, k1, c); });
  }

  // The accumulator P (X1, Y1, Z1) += Q (X2, Y2, Z2): the complete add,
  // with jac_add's branches. Operands in place and synced; the result is
  // in the accumulator and synced.
  __device__ __forceinline__ void add_to_acc(const CurveConsts& c) const {
    // each branch syncs before the team writes what a lane may still read
    if (zero(Z1)) {  // P infinite: Q
      sync();
      copy(X1, X2, 3);
      sync();
      return;
    }
    if (zero(Z2)) {  // Q infinite: P
      sync();
      return;
    }
    mul<3>({{Z1Z1, Z1, Z1}, {Z2Z2, Z2, Z2}, {Z1Z2, Z1, Z2}}, c);
    mul<4>({{U1, X1, Z2Z2}, {U2, X2, Z1Z1}, {Z2C, Z2, Z2Z2}, {Z1C, Z1, Z1Z1}}, c);
    mul<2>({{S1, Y1, Z2C}, {S2, Y2, Z1C}}, c);
    lin(2, [&](int q, int k0, int k1) {
      if (q == 0)
        sub(HD, U2, U1, k0, k1, c);
      else
        sub(RD, S2, S1, k0, k1, c);
    });
    if (zero(HD) && zero(RD)) {  // P == Q: the doubling of P
      dbl(c);
      return;
    }
    // Z3 = Z1Z2 HD straight into Z1 (no later level reads Z1)
    mul<3>({{HH, HD, HD}, {RR, RD, RD}, {Z1, Z1Z2, HD}}, c);
    mul<2>({{HHH, HD, HH}, {VV, U1, HH}}, c);
    lin(1, [&](int, int k0, int k1) {  // X3 (into X1), VV - X3
      sub(TD, RR, HHH, k0, k1, c);
      add(X1, VV, VV, k0, k1, c);
      sub(X1, TD, X1, k0, k1, c);
      sub(TD, VV, X1, k0, k1, c);
    });
    mul<2>({{RVX, RD, TD}, {SHH, S1, HHH}}, c);
    lin(1, [&](int, int k0, int k1) { sub(Y1, RVX, SHH, k0, k1, c); });
  }
};

// K8: team g adds point g of (x1, y1, z1) and of (x2, y2, z2) (jac_add).
template <int NW, int EXT, bool SPLIT>
__global__ void __launch_bounds__(256)
    ec_team_add(CurveConsts c, uint32_t* ox, uint32_t* oy, uint32_t* oz,
                const uint32_t* x1, const uint32_t* y1, const uint32_t* z1,
                const uint32_t* x2, const uint32_t* y2, const uint32_t* z2,
                long long n) {
  using L = EcTeam<NW, EXT, SPLIT>;
  extern __shared__ __align__(16) uint32_t smem[];
  const long long g = L::index();
  if (g >= n) return;  // the whole team
  const L t(smem);
  t.load_point(X1, x1, y1, z1, g);
  t.load_point(X2, x2, y2, z2, g);
  t.sync();
  t.add_to_acc(c);
  t.store(ox, oy, oz, g);
}

// Doublings of the chain's rounds: round r doubles the accumulator dbl[r]
// times (t + t with jac_add, an infinite accumulator staying as it is)
// before its add; rounds from n on double none. kChainMax rounds at most.
constexpr int kChainMax = 64;
struct Rounds {
  int n;
  unsigned char dbl[kChainMax];
};

// K8's chain and K9c: team g starts from point g * is of (ix, iy, iz) and
// runs `steps` rounds, round r adding point r * rs + g * gs of (ax, ay, az)
// after its doublings. The window folds: is = 1, addend r of team g at
// r * k + g. K9c: the block's first point, then its other B - 1 points
// (ax one point past the block's first, rs = 1, gs = B, no doublings).
// The accumulator stays in the slot from the first step to the last; the
// next addend is staged while a round runs.
template <int NW, int EXT, bool SPLIT>
__global__ void __launch_bounds__(256)
    ec_team_chain(CurveConsts c, uint32_t* ox, uint32_t* oy, uint32_t* oz,
                  const uint32_t* ix, const uint32_t* iy, const uint32_t* iz,
                  long long is, const uint32_t* ax, const uint32_t* ay,
                  const uint32_t* az, long long rs, long long gs, int steps,
                  Rounds rounds, long long k) {
  using L = EcTeam<NW, EXT, SPLIT, true>;
  extern __shared__ __align__(16) uint32_t smem[];
  const long long g = L::index();
  if (g >= k) return;  // the whole team
  const L t(smem);
  if (steps > 0) t.stage(ax, ay, az, g * gs);
  t.load_point(X1, ix, iy, iz, g * is);
  t.sync();
  for (int r = 0; r < steps; ++r) {
    for (int d = r < rounds.n ? rounds.dbl[r] : 0; d > 0; --d) {
      if (t.zero(Z1)) break;  // infinity doubles to itself
      t.dbl(c);
    }
    t.unstage(X2);
    t.sync();
    if (r + 1 < steps) t.stage(ax, ay, az, (r + 1) * rs + g * gs);
    t.add_to_acc(c);
  }
  t.store(ox, oy, oz, g);
}

// Launches kern for n teams of the slot layout L on stream s, in blocks of
// ec_block(n, L::T) threads. Returns the error of a refused shared-memory
// attribute, else cudaSuccess (the caller reads cudaGetLastError()).
template <class L, class Kernel, class... Args>
cudaError_t launch_ec_team(Kernel kern, long long n, cudaStream_t s,
                           Args... args) {
  const int threads = ec_block(n, L::T);
  const size_t smem = (size_t)(threads / L::T) * L::WORDS * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<blocks_for(n * L::T, threads), threads, smem, s>>>(args...);
  return cudaSuccess;
}

}  // namespace
}  // namespace zkp
