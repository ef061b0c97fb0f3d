// B3 and B6: int8 L2 scan with the hierarchical packed fold, optionally with
// the candidate cut fused in (B3 only).
//
// B3 replaces the TPU kernel
// diskrag_tpu/ops/flat_scan_pallas.py::_scan_kernel_hier, B6 replaces
// ::_scan_kernel_hier_pipe (both reached through scan_bucketed_topk_hier,
// B6 with pipelined=True). The packed fold of packed_scan.cu has 8 bits for
// the segment, so its NB must grow with N. Here the rows are cut into
// super-tiles of 256 segments (256 * NB rows); inside a super-tile the fold
// is B2's (max of packed = 512 * cross + local_seg - 256 * nint, the larger
// segment wins ties), and super-tiles are merged in order into a pair state
//   val = packed >> 8 (arithmetic),  gseg = 256 * super_tile + (packed & 255)
// with a strict '>' (the earlier super-tile wins ties), so NB stays at the
// requested width at any N. Rows in [n_phys, n_scan) are pad rows that the
// reference scans too (see packed_scan.cu). Outputs: scores = (float)val
// (-inf where empty) and ids = gseg * NB + lane (-1 where empty or >=
// n_valid); or, with cut_kk > 0, only the top-cut_kk element ids per query.
//
// What bounds it on the H100: the products. At 1M x 128 and B = 1000 the scan
// is 2.56e11 int8 operations on 128 MB of rows: 0.129 ms at the int8
// tensor-core peak against 0.04 ms for the bytes. B3's partial kernel is
// B2's (packed_wgmma.cuh): wgmma m64n64k32 s8, the queries in registers and
// the rows fed by a TMA ring, the fold in registers. At that shape with the
// fused cut (NB 512, kk 40) a call takes 0.446 ms launch to launch, 0.427 ms
// on the device (the partial kernel 0.349, the merge with the cut 0.071),
// 3.3x the bound, against 0.651-0.660 ms for the earlier mma.sync design
// (H100 80GB HBM3, 700 W; PERF.md). What holds the partial kernel is the
// chain inside each warpgroup (wait for the tile, product, fold), about
// 0.4 us a segment with three blocks an SM. The parts that run in
// parallel (grid z) never cross a super-tile, so the merge kernel, one block
// per query, first takes the max over the parts of each super-tile and then
// applies the strict '>' across super-tiles in order: exactly the sequential
// result. The fused cut runs in that merge kernel from shared memory.
//
// B6 keeps the earlier mma.sync design (packed_common.cuh) and computes
// the same parts from a software pipeline inside the block: the 16 rows of
// segment j+1 are on their way into a shared-memory stage (cp.async, three
// stages) and the product of segment j is started into one accumulator set
// while segment j-1 is folded out of the other; one epilogue step folds the
// last segment, as in the TPU kernel. Its four warps share one staged copy of
// the rows instead of each reading them from L1/L2. Its parts feed the same
// merge kernel, so its output equals B3's bit for bit: two independent
// designs held against each other. It is not a default; PERF.md holds both
// times.

#include "packed_wgmma.cuh"

namespace {

using namespace packed;

__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

constexpr int kStages = 3;

// B6: B3's part on mma.sync, pipelined through shared memory.
template <int KH>
__global__ void __launch_bounds__(kThreads) hier_scan_partial_pipelined(
    const int8_t* __restrict__ q, const float* __restrict__ inv_qs_ptr,
    const int8_t* __restrict__ db, const float* __restrict__ nf, int b,
    int row_bytes, int n_phys, int n_scan, int nb, int segs_per_part,
    int* __restrict__ parts) {
  using T = Tile<KH>;
  constexpr int kRowStride = 64 * KH;  // staged rows are zero-filled to this
  constexpr int kChunks = kLanes * 4 * KH;  // 16-byte chunks per stage
  __shared__ __align__(16) unsigned char rows[kStages][kLanes * kRowStride];
  __shared__ float snf[kStages][kLanes];

  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  // every warp takes part in the copies and barriers; a warp whose queries
  // all lie past b multiplies zeros and stores nothing
  const int q_base = blockIdx.x * T::kBlockQ + warp * T::kWarpQ;
  const int lane0 = blockIdx.y * kLanes;
  const int part = blockIdx.z;
  const int n_seg = n_scan / nb;
  const int s_begin = part * segs_per_part;
  const int n = max(0, min(n_seg, s_begin + segs_per_part) - s_begin);
  const float inv_qs = *inv_qs_ptr;

  uint4 bq[T::NQ][KH];
  load_queries<KH>(bq, q, b, row_bytes, q_base, g, t);
  int state[T::NQ][4];
  clear<KH>(state, INT_MIN);

  auto stage_segment = [&](int j) {  // segment s_begin + j -> stage j % kStages
    const int st = j % kStages;
    const long long row0 = (long long)(s_begin + j) * nb + lane0;
    for (int c = threadIdx.x; c < kChunks; c += kThreads) {
      const int r = c / (4 * KH);
      const int off = (c % (4 * KH)) * 16;
      const bool live = row0 + r < n_phys && off < row_bytes;
      const int8_t* src = live ? db + (size_t)(row0 + r) * row_bytes + off : db;
      cp_async_16(&rows[st][r * kRowStride + off], src, live ? 16 : 0);
    }
    if (threadIdx.x < kLanes) {
      const long long row = row0 + threadIdx.x;
      snf[st][threadIdx.x] = row < n_phys ? __ldg(nf + row) : INFINITY;
    }
  };

  float nf_prev0 = INFINITY, nf_prev1 = INFINITY;
  // step j: stage segment j+1, start the product of segment j into `cur`,
  // fold segment j-1 out of `prev`
  auto step = [&](int j, int (&cur)[T::NQ][4], int (&prev)[T::NQ][4]) {
    if (j + 1 < n) stage_segment(j + 1);
    asm volatile("cp.async.commit_group;\n" ::);
    float nf_cur0 = INFINITY, nf_cur1 = INFINITY;
    if (j < n) {
      asm volatile("cp.async.wait_group 1;\n" ::);
      __syncthreads();
      const int st = j % kStages;
      uint4 a[2][KH];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int h = 0; h < KH; ++h)
          a[r][h] = *reinterpret_cast<const uint4*>(
              &rows[st][(g + 8 * r) * kRowStride + 64 * h + 16 * t]);
      nf_cur0 = snf[st][g];
      nf_cur1 = snf[st][g + 8];
      clear<KH>(cur, 0);
      product<KH>(cur, a, bq);
    }
    if (j > 0) {
      const int seg = (s_begin + j - 1) & (kPack - 1);
      fold<KH>(state, prev, seg - norm_int(nf_prev0, inv_qs) * kPack,
               seg - norm_int(nf_prev1, inv_qs) * kPack);
    }
    nf_prev0 = nf_cur0;
    nf_prev1 = nf_cur1;
  };

  int acc0[T::NQ][4], acc1[T::NQ][4];
  if (n > 0) stage_segment(0);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int j = 0; j <= n; j += 2) {
    step(j, acc0, acc1);
    if (j + 1 <= n) step(j + 1, acc1, acc0);
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  store_part<KH>(state, parts, part, b, nb, q_base, lane0, g, t);
}

// One block per query. Parts never cross a super-tile: parts_per_super
// consecutive parts make one. Max over a super-tile's parts, then the
// strict '>' across super-tiles in order; then the [NB] outputs or the cut.
template <bool kCut>
__global__ void __launch_bounds__(kMergeThreads) hier_scan_merge(
    const int* __restrict__ parts, int n_parts, int parts_per_super, int b,
    int nb, int n_valid, int kk, float* __restrict__ scores,
    int* __restrict__ ids) {
  extern __shared__ int sm[];
  int* sval = sm;
  int* sgseg = sm + nb;
  const int row = blockIdx.x;
  const size_t total = (size_t)b * nb;
  for (int lane = threadIdx.x; lane < nb; lane += kMergeThreads) {
    int bv = kEmptyHier;
    int bs = -1;
    for (int p0 = 0; p0 < n_parts; p0 += parts_per_super) {
      int p = INT_MIN;
      const int p1 = min(n_parts, p0 + parts_per_super);
      for (int i = p0; i < p1; ++i)
        p = max(p, parts[i * total + (size_t)row * nb + lane]);
      const int val = p >> kPackBits;  // arithmetic shift
      if (val > bv && p != INT_MIN) {
        bv = val;
        bs = (p0 / parts_per_super) * kPack + (p & (kPack - 1));
      }
    }
    if (kCut) {
      sval[lane] = bv;
      sgseg[lane] = bs;
    } else {
      const long long id = (long long)bs * nb + lane;
      scores[(size_t)row * nb + lane] = bs < 0 ? -INFINITY : __int2float_rn(bv);
      ids[(size_t)row * nb + lane] = (bs < 0 || id >= n_valid) ? -1 : (int)id;
    }
  }
  if (kCut) {
    __syncthreads();
    epilogue_cut_ids<true>(sval, sgseg, nb, kk, kEmptyHier, n_valid,
                           ids + (size_t)row * kk);
  }
}

}  // namespace

extern "C" {

// The partial kernel's tiles: queries and lanes per block and the blocks
// an SM holds (the wrapper's plan).
int hier_scan_queries() { return packed_wg::kQueries; }
int hier_scan_lanes() { return packed_wg::kLanes; }
int hier_scan_blocks_per_sm() { return packed_wg::kBlocksPerSm; }
int hier_scan_pipelined_block_queries(int row_bytes) { return block_queries(row_bytes); }
int hier_scan_pipelined_block_lanes() { return kLanes; }

// Arguments as packed_scan_launch, except: any n_scan / nb; segs_per_part
// must divide 256 so that no part crosses a super-tile; `pipelined` selects
// B6 (nc is then unused and cut_kk must be 0). Returns -1 if the CUDA
// driver refuses a TMA descriptor, else cudaGetLastError().
int hier_scan_launch(const void* q, const void* inv_qs, const void* db,
                     const void* nf, int b, int row_bytes, int n_phys,
                     int n_scan, int nb, int n_valid, int segs_per_part,
                     int n_parts, void* parts, void* nc, int cut_kk, int pipelined,
                     void* scores, void* ids, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (b <= 0) return cudaSuccess;
  const int n_seg = n_scan / nb;
  if (row_bytes % 16 || row_bytes > 192 || n_scan % nb ||
      nb % (pipelined ? kLanes : packed_wg::kLanes) || segs_per_part <= 0 ||
      kPack % segs_per_part || n_parts <= 0 || (long long)segs_per_part * n_parts < n_seg ||
      (pipelined && cut_kk > 0))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* pp = static_cast<int*>(parts);
  if (pipelined) {
    const int bq = block_queries(row_bytes);
    dim3 grid((b + bq - 1) / bq, nb / kLanes, n_parts);
    const PartKernel part = PACKED_PART_KERNEL_FOR(hier_scan_partial_pipelined, row_bytes);
    part<<<grid, kThreads, 0, st>>>(static_cast<const int8_t*>(q),
                                    static_cast<const float*>(inv_qs),
                                    static_cast<const int8_t*>(db),
                                    static_cast<const float*>(nf), b, row_bytes, n_phys,
                                    n_scan, nb, segs_per_part, pp);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  } else {
    const int err = packed_wg::launch_partial(q, inv_qs, db, nf, b, row_bytes, n_phys, n_scan,
                                              nb, segs_per_part, n_parts, pp,
                                              static_cast<int*>(nc), st);
    if (err != 0) return err;
  }
  auto* sc = static_cast<float*>(scores);
  auto* ii = static_cast<int*>(ids);
  const int pps = kPack / segs_per_part;
  if (cut_kk > 0) {
    const size_t smem = 2 * (size_t)nb * sizeof(int);
    if (smem > 48 * 1024) {
      e = cudaFuncSetAttribute(hier_scan_merge<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
      if (e != cudaSuccess) return e;
    }
    hier_scan_merge<true><<<b, kMergeThreads, smem, st>>>(
        pp, n_parts, pps, b, nb, n_valid, cut_kk, sc, ii);
  } else {
    hier_scan_merge<false><<<b, kMergeThreads, 0, st>>>(
        pp, n_parts, pps, b, nb, n_valid, 0, sc, ii);
  }
  return cudaGetLastError();
}

}  // extern "C"
