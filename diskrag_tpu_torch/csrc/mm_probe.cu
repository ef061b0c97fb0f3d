// M1: the matmul-only probe of the packed scans.
//
// Replaces the TPU kernel benchmarks/fused_scan_micro.py::_mm_only (reached
// through that script's mm_only(tile, nb_out, qb)). The database rows are cut
// into tiles of `tile` rows (rows at or past n_phys are zero); for every tile
// the full [queries, tile] int8 x int8 -> int32 product is taken, and
//   out[b, c]  = sum over tiles t of  q[b] . db[t * tile + c]      (c < nb_out)
//   rowsum[b]  = sum over ALL rows r of q[b] . db[r]
// both in wrapping int32. `out` is the TPU kernel's output: the scan's product
// with the fold taken out. `rowsum` is what keeps the products of the columns
// at or past nb_out alive: the TPU runs the whole [QB, tile] product on its
// matrix unit and throws those columns away, but a CUDA compiler removes a
// product whose result is never read, and a probe that multiplied only the
// kept columns would do a quarter or an eighth of the scan's work. Every
// accumulator of every tile is added into rowsum, so every product is read,
// and the plain version (q . colsum(db) mod 2^32) checks it bit for bit.
//
// What bounds it on the H100: the products, 2 * B * n * D int8 operations,
// the same count as B2 / B3 at the same shapes (0.13 ms at 1M x 128, B = 1000
// at the int8 tensor-core peak against 0.04 ms for the bytes).
//
// Design: the product of B2 / B3's partial kernel (packed_wgmma.cuh) with
// its fold taken out, so that the probe's time, taken from theirs, is what
// their fold costs. The block, the producer thread, the 4-stage TMA ring,
// the queries as wgmma m64n64k32 s8's A operand in registers and `issue`
// are that kernel's own; three blocks an SM as there. Column block c0 of
// tile t is rows [t * tile + c0, +64) where the scan reads [s * NB + l0,
// +64). Where the scan waits for each segment's product and folds it, the
// probe lets the accumulators run through all tiles of its part: it issues
// tile t's product, waits until at most one product is in flight (tile t -
// 1's has retired) and hands that stage back, read by wgmma alone, so
// the tensor cores always hold the next product. wgmma without .satfinite
// wraps, like the int32 adds. It multiplies every (query, row) pair: no
// column sums are taken ahead of the product.
//
// A tile that is no multiple of 64 rows: its last column block reaches into
// the next tile's first rows (the same rows its first column block owns),
// so columns at or past `tile` are left out of both outputs. The TPU kernel
// walks the tiles in order on one core. Here a block owns 64 columns of the
// tile (grid y), 64 queries (grid x) and a range of tiles (grid z), and adds
// its sums into the zero-initialised outputs with integer atomics: wrapping
// adds commute, so the result does not depend on the order in which blocks
// finish. The wrapper plans the parts (ops/mm_probe.py::plan_mm_probe).

#include "packed_wgmma.cuh"

namespace {

using namespace packed_wg;

// Grid (ceil(b / 64), ceil(tile / 64), parts), kThreads threads.
template <int kKSteps>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) mm_probe_kernel(
    const __grid_constant__ CUtensorMap db_map, const int8_t* __restrict__ q, int b,
    int row_bytes, int tile, int n_tiles, int tiles_per_part, int nb_out,
    int* __restrict__ out, int* __restrict__ rowsum) {
  constexpr int kBoxes = (kKSteps + 3) / 4;
  extern __shared__ unsigned char smem_raw[];
  const Smem m = setup_smem<kBoxes>(smem_raw);

  const int q0 = blockIdx.x * kQueries;
  const int c0 = blockIdx.y * kLanes;
  const int t_begin = blockIdx.z * tiles_per_part;
  const int t_end = min(n_tiles, t_begin + tiles_per_part);

  if (threadIdx.x >= 128) {
    // producer (one thread): the row boxes of column block c0 of every tile
    if (threadIdx.x == 128)
      produce<kBoxes, false>(&db_map, nullptr, t_begin * tile + c0, tile, t_end - t_begin,
                             m.stages, nullptr, m.full, m.empty);
    return;
  }

  const int t4 = threadIdx.x & 3;
  const int row_lo = q0 + 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2);
  uint32_t a[kKSteps][4];
  load_query_fragments<kKSteps>(a, q, b, row_bytes, row_lo, t4);
  int acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0;
  Ring r;
  for (int t = t_begin; t < t_end; ++t) {
    issue<kKSteps>(acc, a, r, m.full, m.stages, true);
    wg::wgmma_wait<1>();  // tile t - 1's product has retired: hand its stage back
    if (t > t_begin) {
      wg::mbar_arrive(&m.empty[r.release]);
      r.release = (r.release + 1) % kStages;
    }
  }
  wg::wgmma_wait<0>();

  // accumulator i = 4c + 2h + j holds query row_lo + 8h, column
  // c0 + 8c + 2 * t4 + j (wgmma_common.cuh)
  int sum[2] = {0, 0};
#pragma unroll
  for (int c = 0; c < 8; ++c) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int i = 4 * c + 2 * h + j;
        const int col = c0 + 8 * c + 2 * t4 + j;
        const int query = row_lo + 8 * h;
        if (col < tile) {
          sum[h] += acc[i];
          if (col < nb_out && query < b && acc[i] != 0)
            atomicAdd(out + (size_t)query * nb_out + col, acc[i]);
        }
      }
    }
  }
  // the sum over this block's columns, for all columns of the tile: the four
  // threads t4 of a row hold its 64 columns
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    const int query = row_lo + 8 * h;
    if (t4 == 0 && query < b && sum[h] != 0) atomicAdd(rowsum + query, sum[h]);
  }
}

}  // namespace

extern "C" {

// Queries and tile columns per block, and blocks an SM: the wrapper plans
// the grid's parts from them.
int mm_probe_queries() { return kQueries; }
int mm_probe_lanes() { return kLanes; }
int mm_probe_blocks_per_sm() { return kBlocksPerSm; }

// q [b, row_bytes] int8, db [n_phys, row_bytes] int8 (row_bytes % 16 == 0,
// <= 192, both 16-byte aligned). nb_out <= tile, n_tiles = ceil(n_phys /
// tile) cut into n_parts ranges of tiles_per_part. out [>= b, nb_out] int32
// and rowsum [>= b] int32 must be zero on entry. Returns -1 if the CUDA
// driver refuses the TMA descriptor, else cudaGetLastError().
int mm_probe_launch(const void* q, const void* db, int b, int row_bytes, int n_phys, int tile,
                    int n_tiles, int tiles_per_part, int n_parts, int nb_out, void* out,
                    void* rowsum, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (b <= 0 || n_tiles <= 0) return cudaSuccess;
  if (row_bytes % 16 || row_bytes > 192 || tile <= 0 || nb_out > tile || nb_out <= 0 ||
      tiles_per_part <= 0 || (long long)tiles_per_part * n_parts < n_tiles)
    return cudaErrorInvalidValue;
  CUtensorMap db_map;
  if (!wg::make_row_map(&db_map, db, n_phys, row_bytes)) return -1;
  const int ks = ksteps_for(row_bytes);
  auto k = ks == 2 ? mm_probe_kernel<2> : ks == 4 ? mm_probe_kernel<4> : mm_probe_kernel<6>;
  const int smem = smem_bytes((ks + 3) / 4);
  if (smem > 48 * 1024) {  // two K boxes a tile: past the default limit
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((b + kQueries - 1) / kQueries, (tile + kLanes - 1) / kLanes, n_parts);
  k<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      db_map, static_cast<const int8_t*>(q), b, row_bytes, tile, n_tiles, tiles_per_part,
      nb_out, static_cast<int*>(out), static_cast<int*>(rowsum));
  return cudaGetLastError();
}

}  // extern "C"
