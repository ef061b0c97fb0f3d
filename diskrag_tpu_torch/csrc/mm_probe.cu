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
// matrix unit and throws those columns away, but a CUDA compiler removes an
// mma whose result is never read, and a probe that multiplied only the kept
// columns would do a quarter or an eighth of the scan's work. Every
// accumulator of every tile is added into rowsum, so every product is read,
// and the plain version (q . colsum(db) mod 2^32) checks it bit for bit.
//
// What bounds it on the H100: the products, 2 * B * n * D int8 operations,
// the same count as B2 / B3 at the same shapes (0.13 ms at 1M x 128, B = 1000
// at the int8 tensor-core peak against 0.04 ms for the bytes). Its purpose is
// to be subtracted from their times, so it runs the product exactly as they
// do (packed_common.cuh): mma.sync m16n8k32 s8, a warp owning 16 rows of
// every tile and 8 * NQ queries whose fragments stay in registers, rows read
// 16 bytes a thread straight from global memory with the next tile's rows
// fetched while this one is multiplied, the same launch bounds. Where the
// scans clear the accumulators and fold after every segment, the probe lets
// the mma accumulate through all tiles of its part: no norm row, no packed
// score, no max. mma.sync without .satfinite wraps, like the int32 adds.
//
// The TPU kernel walks the tiles in order on one core. Here a block owns 16
// columns of the tile (grid y), a block of queries (grid x) and a range of
// tiles (grid z), and adds its sums into the zero-initialised outputs with
// integer atomics: wrapping adds commute, so the result does not depend on
// the order in which blocks finish.

#include "packed_common.cuh"

namespace {

using namespace packed;

template <int KH>
__global__ void __launch_bounds__(kThreads, kMinBlocks) mm_probe_kernel(
    const int8_t* __restrict__ q, const int8_t* __restrict__ db, int b,
    int row_bytes, int n_phys, int tile, int n_tiles, int tiles_per_part,
    int nb_out, int* __restrict__ out, int* __restrict__ rowsum) {
  using T = Tile<KH>;
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const int q_base = blockIdx.x * T::kBlockQ + warp * T::kWarpQ;
  if (q_base >= b) return;  // the whole warp leaves: no shuffle below misses it
  const int c0 = blockIdx.y * kLanes;
  const int t_begin = blockIdx.z * tiles_per_part;
  const int t_end = min(n_tiles, t_begin + tiles_per_part);

  uint4 bq[T::NQ][KH];
  load_queries<KH>(bq, q, b, row_bytes, q_base, g, t);
  int acc[T::NQ][4];
  clear<KH>(acc, 0);

  uint4 a[2][KH], an[2][KH];
  if (t_begin < t_end)
    load_rows<KH>(a, db, row_bytes, (long long)t_begin * tile + c0 + g, n_phys,
                  t);
  for (int s = t_begin; s < t_end; ++s) {
    if (s + 1 < t_end)
      load_rows<KH>(an, db, row_bytes, (long long)(s + 1) * tile + c0 + g,
                    n_phys, t);
    product<KH>(acc, a, bq);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int h = 0; h < KH; ++h) a[r][h] = an[r][h];
  }

  // accumulators 0, 1 belong to column c0 + g, 2, 3 to column c0 + g + 8;
  // 0, 2 to query 2t, 1, 3 to query 2t + 1 of the n-tile
#pragma unroll
  for (int nt = 0; nt < T::NQ; ++nt) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int query = q_base + nt * 8 + t * 2 + (c & 1);
      const int col = c0 + g + (c >> 1) * 8;
      if (query < b && col < nb_out && acc[nt][c] != 0)
        atomicAdd(out + (size_t)query * nb_out + col, acc[nt][c]);
    }
    // the sum over this warp's 16 columns, for all columns of the tile
    int s0 = acc[nt][0] + acc[nt][2];
    int s1 = acc[nt][1] + acc[nt][3];
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {  // over g: lane bits 2..4
      s0 += __shfl_xor_sync(0xffffffffu, s0, off);
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    }
    if (g == 0) {
      const int query = q_base + nt * 8 + t * 2;
      if (query < b && s0 != 0) atomicAdd(rowsum + query, s0);
      if (query + 1 < b && s1 != 0) atomicAdd(rowsum + query + 1, s1);
    }
  }
}

using ProbeKernel = void (*)(const int8_t*, const int8_t*, int, int, int, int,
                             int, int, int, int*, int*);

}  // namespace

extern "C" {

// Queries and tile columns per block: the wrapper sizes the grid's parts from
// them.
int mm_probe_block_queries(int row_bytes) { return block_queries(row_bytes); }
int mm_probe_block_lanes() { return kLanes; }

// q [b, row_bytes] int8, db [n_phys, row_bytes] int8 (row_bytes % 16 == 0,
// <= 192, both 16-byte aligned). tile % 16 == 0, nb_out <= tile,
// n_tiles = ceil(n_phys / tile) cut into n_parts ranges of tiles_per_part.
// out [>= b, nb_out] int32 and rowsum [>= b] int32 must be zero on entry.
// Returns cudaGetLastError().
int mm_probe_launch(const void* q, const void* db, int b, int row_bytes,
                    int n_phys, int tile, int n_tiles, int tiles_per_part,
                    int n_parts, int nb_out, void* out, void* rowsum,
                    int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (b <= 0 || n_tiles <= 0) return cudaSuccess;
  if (row_bytes % 16 || row_bytes > 192 || tile % kLanes || nb_out > tile ||
      nb_out <= 0 || tiles_per_part <= 0 ||
      (long long)tiles_per_part * n_parts < n_tiles)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bq = block_queries(row_bytes);
  dim3 grid((b + bq - 1) / bq, tile / kLanes, n_parts);
  const ProbeKernel kernel =
      row_bytes <= 64    ? static_cast<ProbeKernel>(mm_probe_kernel<1>)
      : row_bytes <= 128 ? static_cast<ProbeKernel>(mm_probe_kernel<2>)
                         : static_cast<ProbeKernel>(mm_probe_kernel<3>);
  kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(db), b,
      row_bytes, n_phys, tile, n_tiles, tiles_per_part, nb_out,
      static_cast<int*>(out), static_cast<int*>(rowsum));
  return cudaGetLastError();
}

}  // extern "C"
