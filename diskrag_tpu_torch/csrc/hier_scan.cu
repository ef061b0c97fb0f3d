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
// B6 has its own partial kernel (pingpong_wgmma.cuh): a producer warpgroup
// feeding a TMA ring and two consumer warpgroups that take turns on the
// tensor cores through named barriers, each folding one segment while the
// other's product runs, with registers moved from the producer to the
// consumers by setmaxnreg. It computes the same parts from B3's nc pass,
// and its parts feed the same merge kernel, so its output equals B3's bit
// for bit: two independent designs held against each other. It is not a
// default; PERF.md holds both times.

#include "pingpong_wgmma.cuh"

namespace {

using namespace packed;

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
// B6's tiles: queries and lanes per block and the blocks an SM holds.
int hier_scan_pipelined_queries() { return pingpong_wg::kQueries; }
int hier_scan_pipelined_lanes() { return pingpong_wg::kLanes; }
int hier_scan_pipelined_blocks_per_sm() { return pingpong_wg::kBlocksPerSm; }
// The registers a thread that B6's setmaxnreg split assumes at launch, and
// those ptxas gave its partial kernel for rows of row_bytes (-1 if CUDA
// cannot say); hier_scan_launch refuses B6 (returns -2) where they differ.
int hier_scan_pipelined_launch_regs() { return pingpong_wg::kLaunchRegs; }
int hier_scan_pipelined_kernel_regs(int row_bytes) {
  return pingpong_wg::kernel_regs(packed_wg::ksteps_for(row_bytes));
}

// Arguments as packed_scan_launch, except: any n_scan / nb; segs_per_part
// must divide 256 so that no part crosses a super-tile; `pipelined` selects
// B6's partial kernel (cut_kk must then be 0). Returns -1 if the CUDA
// driver refuses a TMA descriptor, -2 if B6's partial kernel was built
// with other registers than its setmaxnreg split assumes (nothing is
// launched then), else cudaGetLastError().
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
      nb % (pipelined ? pingpong_wg::kLanes : packed_wg::kLanes) || segs_per_part <= 0 ||
      kPack % segs_per_part || n_parts <= 0 || (long long)segs_per_part * n_parts < n_seg ||
      (pipelined && cut_kk > 0))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* pp = static_cast<int*>(parts);
  const int err =
      pipelined ? pingpong_wg::launch_partial(q, inv_qs, db, nf, b, row_bytes, n_phys, n_scan,
                                              nb, segs_per_part, n_parts, pp,
                                              static_cast<int*>(nc), st)
                : packed_wg::launch_partial(q, inv_qs, db, nf, b, row_bytes, n_phys, n_scan, nb,
                                            segs_per_part, n_parts, pp, static_cast<int*>(nc),
                                            st);
  if (err != 0) return err;
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
