// The partial kernel of the packed folds B2 (packed_scan.cu) and B3
// (hier_scan.cu): int8 products on the tensor cores through wgmma m64n64k32
// s8 with the queries in registers and the database tiles fed by TMA
// (wgmma_common.cuh), and the packed fold in registers.
//
// For a block's 64 queries and 64 bucket lanes it keeps, over the segments
// of one part, the max of
//   packed = 512 * (q_i8 . db_i8) + nc_j,  nc_j = (s & 255) - 256 * nint_j
// (packed_common.cuh). The part is a contiguous range of segments that
// never crosses a 256-segment super-tile (the wrapper cuts parts of a power
// of two that divides 256), so `s & 255` is the local segment B3 needs and,
// for B2 (at most 256 segments), the segment itself. After the one f32
// product inside nint everything is integer arithmetic: any tiling and any
// split of the segments gives the same bits.
//
//  - nc is computed once a call for every scanned row by a small pass
//    (packed_nc_rows), rows at or past n_phys (the scan's pad rows, up to
//    n_scan) getting nint = 2^21 as the reference's +inf nf gives, so the
//    fold needs no norm arithmetic, no shared buffer and no barrier of its
//    own: it reads 16 nc values staged beside the tile.
//  - A block is one consumer warpgroup and one producer warp; several
//    blocks share an SM. The queries are the A operand in registers, loaded
//    once (8 to 24 registers a thread for rows of up to 192 bytes); only
//    the database tile, rows [s*NB + l0, +64) of segment s, is read from
//    shared memory by the tensor cores. One TMA box per 128 bytes of K
//    brings it into a ring of kStages stages, with its 64 nc values beside
//    it; K past a row's end and rows past the table are TMA's zero fill, so
//    a pad row's product is 0.
//  - The consumer starts the segment's product (wgmma, async), waits for
//    it, folds it with the tile's nc values (one shift-add and one max a
//    score, state = max(state, acc * 512 + nc[col])) and hands the stage
//    back behind a proxy fence.
//  - The grid runs the query tiles fastest, so the blocks that share a
//    database tile run together and read it from L2.
// Each block stores its [64, 64] state into parts[part]; the merge kernels
// of B2 / B3 take it from there.
//
// M1 (mm_probe.cu) is this kernel with the fold taken out: the same block,
// producer (produce), ring, A fragments (load_query_fragments) and product
// (issue), its accumulators running through all tiles of its part.
//
// Why this shape (measured on an H100 80GB HBM3 at 700 W; see PERF.md): a
// warpgroup's step (wait for the tile, product, fold) is a chain of
// latencies whose parts add up, about 0.4 us a segment with three blocks an
// SM. Blocks of three warpgroups (192 queries, B1's shape) took the same
// time a warpgroup-step but pad 1000 queries to 1152 where blocks of one pad
// to 1024. Both operands in shared memory, nc computed inside the kernel
// behind a barrier, wgmma m64n128 tiles, two segments a step, and a second
// accumulator set overlapping one segment's fold with the next one's
// product all measured slower or no faster.

#pragma once

#include "packed_common.cuh"
#include "wgmma_common.cuh"

namespace packed_wg {

constexpr int kStages = 4;
constexpr int kLanes = wg::kTileRows;    // bucket lanes per block
constexpr int kQueries = wg::kTileRows;  // queries per block: one warpgroup
constexpr int kThreads = 128 + 32;       // the consumer warpgroup, the producer warp

// k-steps of 32 bytes a row of `row_bytes` bytes is multiplied in: one of
// the kernel's instantiations (2, 4 or 6), the rest of K being zero.
__host__ __device__ constexpr int ksteps_for(int row_bytes) {
  return row_bytes <= 64 ? 2 : row_bytes <= 128 ? 4 : 6;
}

// Blocks an SM holds, the kernel's launch bound: it caps a thread at 136
// registers (65536 / (3 * kThreads)), which the widest rows' 24 query
// registers still fit. Four blocks (96 registers) measured slower, two the
// same (the compiler then takes 109 and three blocks fit anyway).
constexpr int kBlocksPerSm = 3;

// Bytes of dynamic shared memory, with 1024 of slack for the alignment the
// swizzled tiles need: the ring's row boxes and nc values, the mbarriers.
inline int smem_bytes(int n_boxes) {
  return 1024 + kStages * n_boxes * wg::kTileBytes + kStages * kLanes * 4 + 2 * kStages * 8;
}

// nc[j] = (segment & 255) - 256 * nint_j for every scanned row j < n_scan:
// the packed score's row term, from nf and the batch's 1 / q_scale once per
// call; rows at or past n_phys are the scan's pad rows (nint = 2^21).
__global__ void packed_nc_rows(const float* __restrict__ nf, const float* __restrict__ inv_qs_ptr,
                               int n_phys, int n_scan, int nb, int* __restrict__ nc) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n_scan) return;
  const int nint = j < n_phys ? packed::norm_int(nf[j], *inv_qs_ptr) : (1 << 21);
  nc[j] = ((j / nb) & (packed::kPack - 1)) - nint * packed::kPack;
}

using Ring = wg::Ring<kStages>;

// Waits for the next stage and starts acc = (or, with `accumulate`, +=) the
// block's queries (A, in registers) x the stage's 64 rows (asynchronous: one
// committed wgmma group). The scans start each segment afresh; M1 runs one
// sum through all tiles of its part.
template <int kKSteps>
__device__ __forceinline__ void issue(int (&acc)[32], const uint32_t (&a)[kKSteps][4], Ring& r,
                                      uint64_t* full, const unsigned char* stages,
                                      bool accumulate) {
  constexpr int kBoxes = (kKSteps + 3) / 4;
  wg::mbar_wait(&full[r.stage], r.phase);
  const unsigned char* st = stages + r.stage * kBoxes * wg::kTileBytes;
  wg::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks) {
    const uint64_t db = wg::sw128_desc(st + (ks / 4) * wg::kTileBytes);
    wg::wgmma_m64n64k32_s8_rs(acc, a[ks], wg::desc_k(db, ks % 4), accumulate || ks > 0);
  }
  wg::wgmma_commit();
  r.next();
}

// Folds the oldest held stage's product: state = max(state, acc * 512 +
// nc[col]), accumulator i = 4c + 2h + j holding column 8c + 2 * t4 + j
// (wgmma_common.cuh); then hands the stage back. The nc values are read with
// plain loads and the refill is a TMA write, so a proxy fence orders the two:
// without it a refill could land before the loads, and a segment's product
// was folded with the nc (and segment bits) of the tile kStages later.
__device__ __forceinline__ void fold(int (&state)[32], const int (&acc)[32], Ring& r,
                                     uint64_t* empty, const int* snc, int t4) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int2 v = *reinterpret_cast<const int2*>(snc + r.release * kLanes + 8 * c + 2 * t4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 4 * c + 2 * h;
      state[i] = max(state[i], acc[i] * (2 * packed::kPack) + v.x);
      state[i + 1] = max(state[i + 1], acc[i + 1] * (2 * packed::kPack) + v.y);
    }
  }
  wg::fence_proxy_async();
  wg::mbar_arrive(&empty[r.release]);
  r.release = (r.release + 1) % kStages;
}

// The 4-byte word of query `row` at byte `col`, or 0 past the batch or the
// row (row_bytes is a multiple of 16, so a word lies wholly inside or out).
__device__ __forceinline__ uint32_t query_word(const int8_t* __restrict__ q, int b,
                                               int row_bytes, int row, int col) {
  return row < b && col < row_bytes
             ? __ldg(reinterpret_cast<const uint32_t*>(q + (size_t)row * row_bytes + col))
             : 0u;
}

// The consumer warpgroup's A fragments: thread (g, t4) of warp w4 holds
// query rows row_lo = q0 + 16 * w4 + g and row_lo + 8 of the block's 64.
template <int kKSteps>
__device__ __forceinline__ void load_query_fragments(uint32_t (&a)[kKSteps][4],
                                                     const int8_t* __restrict__ q, int b,
                                                     int row_bytes, int row_lo, int t4) {
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks) {
    const int col = 32 * ks + 4 * t4;
    a[ks][0] = query_word(q, b, row_bytes, row_lo, col);
    a[ks][1] = query_word(q, b, row_bytes, row_lo + 8, col);
    a[ks][2] = query_word(q, b, row_bytes, row_lo, col + 16);
    a[ks][3] = query_word(q, b, row_bytes, row_lo + 8, col + 16);
  }
}

// The producer thread: for step i < n_steps in order, the row boxes of the
// 64-row database tile at row0 + i * row_step (and with kNc its 64 nc
// values) into the ring, each stage once the consumers have handed it back.
template <int kBoxes, bool kNc>
__device__ __forceinline__ void produce(const CUtensorMap* db_map, const CUtensorMap* nc_map,
                                        int row0, int row_step, int n_steps,
                                        unsigned char* stages, int* snc, uint64_t* full,
                                        uint64_t* empty) {
  int stage = 0;
  uint32_t phase = 0;
  for (int i = 0; i < n_steps; ++i) {
    const int row = row0 + i * row_step;
    wg::mbar_wait(&empty[stage], phase ^ 1);
    unsigned char* st = stages + stage * kBoxes * wg::kTileBytes;
    wg::mbar_arrive_expect_tx(&full[stage], kBoxes * wg::kTileBytes + (kNc ? kLanes * 4 : 0));
    for (int kb = 0; kb < kBoxes; ++kb)
      wg::tma_load_2d(st + kb * wg::kTileBytes, db_map, &full[stage], kb * wg::kBoxK, row);
    if constexpr (kNc) wg::tma_load_2d(snc + stage * kLanes, nc_map, &full[stage], row, 0);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// The shared memory of a block (smem_bytes): the ring's row boxes, its nc
// values, the full and empty mbarriers, set up by thread 0.
struct Smem {
  unsigned char* stages;
  int* snc;
  uint64_t* full;
  uint64_t* empty;
};

template <int kBoxes>
__device__ __forceinline__ Smem setup_smem(unsigned char* smem_raw) {
  Smem m;
  m.stages = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  m.snc = reinterpret_cast<int*>(m.stages + kStages * kBoxes * wg::kTileBytes);
  m.full = reinterpret_cast<uint64_t*>(m.snc + kStages * kLanes);
  m.empty = m.full + kStages;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      wg::mbar_init(&m.full[i], 1);  // the producer's expect_tx
      wg::mbar_init(&m.empty[i], 128);
    }
    wg::mbar_init_fence();
  }
  __syncthreads();
  return m;
}

// Grid (query tiles, nb / 64, parts), kThreads threads. kKSteps k-steps of
// 32 bytes a row (kKSteps / 4 rounded up 128-byte K boxes a tile).
template <int kKSteps>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) packed_wgmma_partial(
    const __grid_constant__ CUtensorMap db_map, const __grid_constant__ CUtensorMap nc_map,
    const int8_t* __restrict__ q, int b, int row_bytes, int n_seg, int nb, int segs_per_part,
    int* __restrict__ parts) {
  constexpr int kBoxes = (kKSteps + 3) / 4;
  extern __shared__ unsigned char smem_raw[];
  const Smem m = setup_smem<kBoxes>(smem_raw);

  const int q0 = blockIdx.x * kQueries;
  const int l0 = blockIdx.y * kLanes;
  const int part = blockIdx.z;
  const int s_begin = part * segs_per_part;
  const int s_end = min(n_seg, s_begin + segs_per_part);

  if (threadIdx.x >= 128) {
    // producer (one thread): for every segment in order its row boxes and
    // nc values
    if (threadIdx.x == 128)
      produce<kBoxes, true>(&db_map, &nc_map, s_begin * nb + l0, nb, s_end - s_begin, m.stages,
                            m.snc, m.full, m.empty);
    return;
  }

  // the consumer warpgroup
  const int t4 = threadIdx.x & 3;
  const int row_lo = q0 + 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2);
  uint32_t a[kKSteps][4];
  load_query_fragments<kKSteps>(a, q, b, row_bytes, row_lo, t4);
  int state[32];
  int acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) state[i] = INT_MIN;
  Ring r;
  for (int s = s_begin; s < s_end; ++s) {
    issue<kKSteps>(acc, a, r, m.full, m.stages, false);
    wg::wgmma_wait<0>();
    fold(state, acc, r, m.empty, m.snc, t4);
  }

#pragma unroll
  for (int c = 0; c < 8; ++c) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int query = row_lo + 8 * h;
      if (query < b) {
        const int i = 4 * c + 2 * h;
        *reinterpret_cast<int2*>(parts + ((size_t)part * b + query) * nb + l0 + 8 * c +
                                 2 * t4) = make_int2(state[i], state[i + 1]);
      }
    }
  }
}

// One call's kernels before the merge: the nc pass into nc [n_scan] int32
// scratch (16-byte aligned), then the partial kernel into parts [n_parts,
// b, nb]. q [b, row_bytes] int8 (row_bytes % 16 == 0, <= 192), db [n_phys,
// row_bytes] int8 (both 16-byte aligned), nf [n_phys] f32, inv_qs [1] f32;
// nb % 64 == 0; n_scan / nb segments in parts of segs_per_part. Returns -1
// if the CUDA driver refuses a TMA descriptor, else cudaGetLastError().
inline int launch_partial(const void* q, const void* inv_qs, const void* db, const void* nf,
                          int b, int row_bytes, int n_phys, int n_scan, int nb,
                          int segs_per_part, int n_parts, int* parts, int* nc, cudaStream_t st) {
  CUtensorMap db_map, nc_map;
  if (!wg::make_row_map(&db_map, db, n_phys, row_bytes) ||
      !wg::make_vec_map(&nc_map, nc, n_scan))
    return -1;
  const int threads = 256;
  packed_nc_rows<<<(n_scan + threads - 1) / threads, threads, 0, st>>>(
      static_cast<const float*>(nf), static_cast<const float*>(inv_qs), n_phys, n_scan, nb, nc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int ks = ksteps_for(row_bytes);
  auto k = ks == 2 ? packed_wgmma_partial<2> : ks == 4 ? packed_wgmma_partial<4>
                                                       : packed_wgmma_partial<6>;
  const int smem = smem_bytes((ks + 3) / 4);
  if (smem > 48 * 1024) {  // two K boxes a tile: past the default limit
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((b + kQueries - 1) / kQueries, nb / kLanes, n_parts);
  k<<<grid, kThreads, smem, st>>>(db_map, nc_map, static_cast<const int8_t*>(q), b, row_bytes,
                                  n_scan / nb, nb, segs_per_part, parts);
  return cudaGetLastError();
}

}  // namespace packed_wg
