// The partial kernel of B6 (hier_scan.cu, pipelined): B3's packed fold on
// the tensor cores, with the product of one segment overlapping the fold of
// another through a warp-specialized ping-pong schedule.
//
// B6 replaces diskrag_tpu/ops/flat_scan_pallas.py::_scan_kernel_hier_pipe.
// On the TPU that kernel overlaps the MXU product of tile j with the VPU
// fold of tile j-1 inside one grid step. Here a block is three warpgroups,
// and an SM holds kBlocksPerSm blocks:
//  - a producer warpgroup, of which one thread keeps a TMA ring of kStages
//    stages full (each stage: a segment's 64 database rows, one 128-byte box
//    per 128 bytes of K, and their 64 nc values). It gives registers back
//    with setmaxnreg.dec, down to kProducerRegs.
//  - two consumer warpgroups of 64 queries each, which raise theirs with
//    setmaxnreg.inc to kConsumerRegs. Each holds its queries as the A
//    operand in registers (wgmma m64n64k32 s8, the rows from shared memory).
//  - The consumers take turns on the tensor cores through named barriers
//    (bar.sync / bar.arrive, one id a consumer): a consumer issues its
//    product for segment j once the other has issued its own and passes the
//    turn on as soon as its product is issued, then waits for it and folds.
//    So the two products of a segment run back to back and whole, and each
//    consumer folds segment j while the other's product of j (or j + 1)
//    runs: the reference's overlap of product and fold, across warpgroups.
// The fold is B3's integer fold, state = max(state, acc * 512 + nc[col]),
// with nc = (s & 255) - 256 * nint from the same per-call pass
// (packed_wgmma.cuh::packed_nc_rows) and parts that never cross a
// 256-segment super-tile; the parts go to B3's merge kernel, so B6's output
// equals B3's bit for bit at any tiling. It is an independent design all the
// same: the schedule, the ring, the block shape and the grid plan
// (ops/flat_scan.py::plan_pipelined_scan) are its own, and chip_smoke.py
// holds the two against each other.
//
// What bounds it on the H100: the products, as B3 (2 * B * n * D int8
// operations, 0.129 ms at 1000 x 1M x 128). There, at NB 512, the partial
// kernel takes 0.30 ms on the device against B3's 0.34 (H100 80GB HBM3,
// 700 W; chip_smoke.py, PERF.md). What bought it is the warpgroups in
// flight, two blocks an SM: in development runs one block an SM, three
// consumers a block, and two accumulator sets a consumer (segment j's
// product started before segment j-1's fold, which fits only at one block
// an SM) were all slower; the turns were worth little at two blocks.
// Ptxas serializes the wgmma of a warpgroup whose role it cannot prove
// warp-uniform (C7518), hence the shuffle that reads the role.

#pragma once

#include "packed_wgmma.cuh"

namespace pingpong_wg {

constexpr int kStages = 6;
constexpr int kLanes = wg::kTileRows;  // bucket lanes per block
constexpr int kConsumers = 2;
constexpr int kQueries = kConsumers * wg::kTileRows;  // 64 queries a consumer
constexpr int kThreads = 128 * (1 + kConsumers);      // producer + consumers
constexpr int kBlocksPerSm = 2;
// setmaxnreg's split of a block's share of the SM's 65536 registers: what a
// thread gets at launch (a multiple of 8), the producer's after it lowers
// them and the consumers' after they raise theirs (232 a thread at most):
// with two consumers and one block an SM, 168 at launch, 40 and 232. The
// split holds only if ptxas gave the kernel exactly kLaunchRegs a thread:
// with fewer, setmaxnreg.inc waits for registers that never come free and
// the block hangs, so launch_partial refuses a build that differs
// (PINGPONG_LAUNCH_REGS overrides the figure, to reach that refusal).
#ifdef PINGPONG_LAUNCH_REGS
constexpr int kLaunchRegs = PINGPONG_LAUNCH_REGS;
#else
constexpr int kLaunchRegs = (65536 / kBlocksPerSm / kThreads) & ~7;
#endif
// launch_partial's return for a build whose registers differ from
// kLaunchRegs (cudaError_t values are >= 0; -1 is a refused TMA map)
constexpr int kErrRegisters = -2;
constexpr int kProducerRegs = kBlocksPerSm == 1 ? 40 : 24;
constexpr int kConsumerRegs =
    ((kLaunchRegs * kThreads - kProducerRegs * 128) / (128 * kConsumers) & ~7) < 232
        ? ((kLaunchRegs * kThreads - kProducerRegs * 128) / (128 * kConsumers) & ~7)
        : 232;
// named barriers of the consumers' turns, one a consumer (0 is
// __syncthreads)
constexpr int kTurnBarrier = 1;

inline int smem_bytes(int n_boxes) {
  return 1024 + kStages * n_boxes * wg::kTileBytes + kStages * kLanes * 4 + 2 * kStages * 8;
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous product's issue and wait.
__device__ __forceinline__ void fence_regs(int (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

using Ring = wg::Ring<kStages>;

// Waits for the next stage and starts acc = queries x its rows.
template <int kKSteps>
__device__ __forceinline__ void issue(int (&acc)[32], const uint32_t (&a)[kKSteps][4], Ring& r,
                                      uint64_t* full, const unsigned char* stages) {
  constexpr int kBoxes = (kKSteps + 3) / 4;
  wg::mbar_wait(&full[r.stage], r.phase);
  const unsigned char* st = stages + r.stage * kBoxes * wg::kTileBytes;
  fence_regs(acc);
  wg::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks) {
    const uint64_t db = wg::sw128_desc(st + (ks / 4) * wg::kTileBytes);
    wg::wgmma_m64n64k32_s8_rs(acc, a[ks], wg::desc_k(db, ks % 4), ks > 0);
  }
  wg::wgmma_commit();
  fence_regs(acc);
  r.next();
}

// Folds the oldest held stage's product into the state, then hands the stage
// back behind a proxy fence (its nc values were read with plain loads and
// the refill is a TMA write).
__device__ __forceinline__ void fold(int (&state)[32], int (&acc)[32], Ring& r, uint64_t* empty,
                                     const int* snc, int t4) {
  fence_regs(acc);
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

// Grid (query tiles of kQueries, nb / 64, parts), kThreads threads, one
// block an SM. Same arguments as packed_wg::packed_wgmma_partial.
template <int kKSteps>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) pingpong_wgmma_partial(
    const __grid_constant__ CUtensorMap db_map, const __grid_constant__ CUtensorMap nc_map,
    const int8_t* __restrict__ q, int b, int row_bytes, int n_seg, int nb, int segs_per_part,
    int* __restrict__ parts) {
  constexpr int kBoxes = (kKSteps + 3) / 4;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* stages = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  int* snc = reinterpret_cast<int*>(stages + kStages * kBoxes * wg::kTileBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(snc + kStages * kLanes);
  uint64_t* empty = full + kStages;

  const int l0 = blockIdx.y * kLanes;
  const int part = blockIdx.z;
  const int s_begin = part * segs_per_part;
  const int n = max(0, min(n_seg, s_begin + segs_per_part) - s_begin);
  // the warpgroup's role, read through a shuffle so that the compiler knows
  // it is uniform across the warp: wgmma on a path it must treat as
  // divergent is serialized (ptxas C7518)
  const int wg_id = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      wg::mbar_init(&full[i], 1);                  // the producer's expect_tx
      wg::mbar_init(&empty[i], 128 * kConsumers);  // every consumer thread
    }
    wg::mbar_init_fence();
  }
  __syncthreads();

  if (wg_id == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int j = 0; j < n; ++j) {
      const int s = s_begin + j;
      wg::mbar_wait(&empty[stage], phase ^ 1);
      unsigned char* st = stages + stage * kBoxes * wg::kTileBytes;
      wg::mbar_arrive_expect_tx(&full[stage], kBoxes * wg::kTileBytes + kLanes * 4);
      for (int kb = 0; kb < kBoxes; ++kb)
        wg::tma_load_2d(st + kb * wg::kTileBytes, &db_map, &full[stage], kb * wg::kBoxK,
                        s * nb + l0);
      wg::tma_load_2d(snc + stage * kLanes, &nc_map, &full[stage], s * nb + l0, 0);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));

  // consumer c: thread (g, t4) of warp w4 holds query rows 16 * w4 + g and
  // + 8 of its 64
  const int c = wg_id - 1;
  const int tid = threadIdx.x - 128 * wg_id;
  const int t4 = tid & 3;
  const int row_lo = blockIdx.x * kQueries + 64 * c + 16 * (tid >> 5) + ((tid & 31) >> 2);
  uint32_t a[kKSteps][4];
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks) {
    const int col = 32 * ks + 4 * t4;
    a[ks][0] = packed_wg::query_word(q, b, row_bytes, row_lo, col);
    a[ks][1] = packed_wg::query_word(q, b, row_bytes, row_lo + 8, col);
    a[ks][2] = packed_wg::query_word(q, b, row_bytes, row_lo, col + 16);
    a[ks][3] = packed_wg::query_word(q, b, row_bytes, row_lo + 8, col + 16);
  }
  int state[32], acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    state[i] = INT_MIN;
    acc[i] = 0;
  }
  Ring r;
  // The turns go round the consumers in order: consumer c issues a segment's
  // product once consumer c - 1 has issued its own, then passes the turn to
  // c + 1 and folds while the products queued behind its own run. Consumer
  // 0 takes the first turn, and the last consumer does not pass its last,
  // so every barrier sees whole phases (128 threads syncing, 128 arriving).
  const int my_turn = kTurnBarrier + c;
  const int next_turn = kTurnBarrier + (c + 1) % kConsumers;
  const bool last = c == kConsumers - 1;
  if (last && n > 0) bar_arrive(next_turn, 256);
  for (int j = 0; j < n; ++j) {
    bar_sync(my_turn, 256);
    issue<kKSteps>(acc, a, r, full, stages);
    if (!(last && j == n - 1)) bar_arrive(next_turn, 256);
    wg::wgmma_wait<0>();
    fold(state, acc, r, empty, snc, t4);
  }

#pragma unroll
  for (int cc = 0; cc < 8; ++cc) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int query = row_lo + 8 * h;
      if (query < b) {
        const int i = 4 * cc + 2 * h;
        *reinterpret_cast<int2*>(parts + ((size_t)part * b + query) * nb + l0 + 8 * cc +
                                 2 * t4) = make_int2(state[i], state[i + 1]);
      }
    }
  }
}

// The partial kernel for kKSteps = ks (2, 4 or 6).
inline auto kernel_for(int ks) {
  return ks == 2 ? pingpong_wgmma_partial<2> : ks == 4 ? pingpong_wgmma_partial<4>
                                                       : pingpong_wgmma_partial<6>;
}

// The registers a thread that ptxas gave kernel_for(ks), or -1 if CUDA
// cannot say.
inline int kernel_regs(int ks) {
  cudaFuncAttributes attr;
  return cudaFuncGetAttributes(&attr, kernel_for(ks)) == cudaSuccess ? attr.numRegs : -1;
}

// One call's kernels before the merge, as packed_wg::launch_partial: the nc
// pass into nc [n_scan], then the ping-pong partial kernel into parts
// [n_parts, b, nb] on a grid of (ceil(b / kQueries), nb / 64, n_parts).
// Returns kErrRegisters, before any launch, if the partial kernel's
// registers differ from kLaunchRegs.
inline int launch_partial(const void* q, const void* inv_qs, const void* db, const void* nf,
                          int b, int row_bytes, int n_phys, int n_scan, int nb,
                          int segs_per_part, int n_parts, int* parts, int* nc, cudaStream_t st) {
  const int ks = packed_wg::ksteps_for(row_bytes);
  if (kernel_regs(ks) != kLaunchRegs) return kErrRegisters;
  CUtensorMap db_map, nc_map;
  if (!wg::make_row_map(&db_map, db, n_phys, row_bytes) ||
      !wg::make_vec_map(&nc_map, nc, n_scan))
    return -1;
  const int threads = 256;
  packed_wg::packed_nc_rows<<<(n_scan + threads - 1) / threads, threads, 0, st>>>(
      static_cast<const float*>(nf), static_cast<const float*>(inv_qs), n_phys, n_scan, nb, nc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  auto k = kernel_for(ks);
  const int smem = smem_bytes((ks + 3) / 4);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((b + kQueries - 1) / kQueries, nb / kLanes, n_parts);
  k<<<grid, kThreads, smem, st>>>(db_map, nc_map, static_cast<const int8_t*>(q), b, row_bytes,
                                  n_scan / nb, nb, segs_per_part, parts);
  return cudaGetLastError();
}

}  // namespace pingpong_wg
