// DMA-pattern probes: the on-card counterparts of the three pallas_calls of
// scripts/probe_dma.py's kern2 (o = a ^ b over int32 words; the same bytes,
// only the blocking and the grid differ).
//
// probe_xor_tiles: one block per tile of `planes` runs of sb rows of 128
// words; 256 threads walk the tile 16 B a thread, consecutive threads on
// consecutive addresses, and each word is read once and written once.
//   mode 0 (P20, flat_fn): arrays (Rp, M, 128), 1-D grid of M / sb tiles;
//     tile i is rows i*sb .. of every plane. sb 8 or 32.
//   mode 1 (P21, lead1_fn): arrays (B, Rp, M/B, 128), tiles (1, Rp, sb,
//     128) as the scans read; the TPU grid (g, j) has j fastest, so
//     blockIdx.x = j and blockIdx.y = g. sb 8.
//   mode 2 (P22, grid2d_fn): the flat arrays of P20, tiles walked by a 2-D
//     grid, tile row (g*B + j)*sb with j = blockIdx.x fastest. sb 8.
// Bound: bytes (two reads and one write per word). The TPU sites asked
// whether the block shape moves a DMA-bound kernel; on the card each tile
// is Rp runs of sb * 512 B (4 KB at sb 8), whole sectors and lines in any
// of the three walks, so what they can show is the cost of the block count
// and of the runs' stride across the planes.
// The entry launches on the caller's stream, allocates nothing, does not
// synchronise and returns cudaGetLastError().
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes4 = 128 / 4;  // uint4 per 128-word row

__global__ void probe_xor_tiles(uint4* o, const uint4* a, const uint4* b,
                                int mode, int planes, long long rows, int sb) {
  long long plane0, row0;
  if (mode == 1) {
    plane0 = (long long)blockIdx.x * planes;
    row0 = (long long)blockIdx.y * sb;
  } else {
    plane0 = 0;
    row0 = ((long long)blockIdx.y * gridDim.x + blockIdx.x) * sb;
  }
  const int per_plane = sb * kLanes4;
  for (int i = threadIdx.x; i < planes * per_plane; i += blockDim.x) {
    const int r = i / per_plane, q = i % per_plane;
    const long long off = ((plane0 + r) * rows + row0) * kLanes4 + q;
    const uint4 u = a[off], v = b[off];
    o[off] = make_uint4(u.x ^ v.x, u.y ^ v.y, u.z ^ v.z, u.w ^ v.w);
  }
}

}  // namespace

// mode 0, 2: arrays (planes, rows, 128); mode 1: (B, planes, rows, 128).
// Mode 0 takes sb 8 or 32 and rows % sb == 0; mode 1 sb 8, rows % sb == 0;
// mode 2 sb 8, rows % (sb * B) == 0.
extern "C" int zkp_probe_xor(int mode, int sb, int B, void* o, const void* a,
                             const void* b, int planes, long long rows,
                             void* stream) {
  const bool ok = planes > 0 && rows > 0 && B > 0 &&
                  (mode == 0 ? (sb == 8 || sb == 32) && rows % sb == 0
                   : mode == 1 ? sb == 8 && rows % sb == 0
                   : mode == 2 ? sb == 8 && rows % ((long long)sb * B) == 0
                               : false);
  if (!ok) return (int)cudaErrorInvalidValue;
  const dim3 grid = mode == 0   ? dim3((unsigned)(rows / sb))
                    : mode == 1 ? dim3((unsigned)B, (unsigned)(rows / sb))
                                : dim3((unsigned)B, (unsigned)(rows / sb / B));
  probe_xor_tiles<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (uint4*)o, (const uint4*)a, (const uint4*)b, mode, planes, rows, sb);
  return (int)cudaGetLastError();
}
