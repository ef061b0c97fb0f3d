// B2: int8 L2 scan with the packed-int32 bucket fold, optionally with the
// candidate cut fused in.
//
// Replaces the TPU kernel
// diskrag_tpu/ops/flat_scan_pallas.py::_scan_kernel_packed (with
// _norm_seg_row and _epilogue_cut_ids; reached through
// scan_bucketed_topk_packed). For every query and bucket lane l in [0, NB)
// it keeps max over the scanned rows {s*NB + l : s = 0 .. n_scan/NB - 1} of
//   packed = 512 * (q_i8 . db_i8) + s - 256 * nint_j
// (see packed_common.cuh), one int32 that carries the score and, in its low
// 8 bits, the winning segment s < 256; on equal scores the larger segment
// wins. Rows in [n_phys, n_scan) are pad rows (zero codes, +inf norm): the
// reference scans them too, and a pad can win an empty bucket, so the count
// of scanned rows is an argument and not a by-product of a tile size.
// Outputs: scores = (float)packed (-inf where empty) and ids = s*NB + l (-1
// where empty or >= n_valid); or, with cut_kk > 0, only the top-cut_kk
// element ids per query.
//
// What bounds it on the H100: the products. At 200k x 128 and B = 1000 the
// scan is 5.1e10 int8 operations on 26 MB of rows: 0.026 ms at the int8
// tensor-core peak against 0.010 ms for the bytes. The partial kernel
// (packed_wgmma.cuh, shared with B3) therefore runs the products on wgmma
// m64n64k32 s8, the queries in registers and the rows fed by a TMA ring, and
// keeps the fold at one shift-add and one max a score in registers. At that
// shape with the fused cut (NB 1024, kk 40) a call takes 0.154-0.171 ms
// launch to launch and 0.131-0.139 ms on the device (the partial kernel
// 0.074-0.078, the merge with the cut 0.053-0.057), 5.1-5.4x the bound,
// against 0.171-0.180 ms for the earlier mma.sync design (H100 80GB HBM3,
// 700 W; PERF.md). A host enqueued a call in 0.05-0.08 ms, so most of the
// rest of the launch-to-launch time lies between the call's four kernels.
//
// The TPU walks the database tiles in order on one core and carries the
// [B, NB] state in VMEM. Here the max is associative, so the segments are cut
// into parts that run in parallel (grid z; planned by the wrapper,
// ops/flat_scan.py::plan_packed_scan) and a second kernel, one block per
// query, takes the max over the parts. That second kernel is where the merged
// row is last held, so the fused cut runs there from shared memory and no
// [B, NB] state reaches the caller.

#include "packed_wgmma.cuh"

namespace {

using namespace packed;

// One block per query: max over the parts, then either the [NB] outputs or
// the fused cut from shared memory.
template <bool kCut>
__global__ void __launch_bounds__(kMergeThreads) packed_scan_merge(
    const int* __restrict__ parts, int n_parts, int b, int nb, int n_valid,
    int kk, float* __restrict__ scores, int* __restrict__ ids) {
  extern __shared__ int sval[];
  const int row = blockIdx.x;
  const size_t total = (size_t)b * nb;
  for (int lane = threadIdx.x; lane < nb; lane += kMergeThreads) {
    int p = INT_MIN;
    for (int i = 0; i < n_parts; ++i)
      p = max(p, parts[i * total + (size_t)row * nb + lane]);
    if (kCut) {
      sval[lane] = p;
    } else {
      const bool empty = p == INT_MIN;
      const long long id = (long long)(p & (kPack - 1)) * nb + lane;
      scores[(size_t)row * nb + lane] = empty ? -INFINITY : __int2float_rn(p);
      ids[(size_t)row * nb + lane] = (empty || id >= n_valid) ? -1 : (int)id;
    }
  }
  if (kCut) {
    __syncthreads();
    epilogue_cut_ids<false>(sval, nullptr, nb, kk, INT_MIN, n_valid,
                            ids + (size_t)row * kk);
  }
}

}  // namespace

extern "C" {

// The partial kernel's tiles: queries and lanes per block and the blocks
// an SM holds (the wrapper's plan).
int packed_scan_queries() { return packed_wg::kQueries; }
int packed_scan_lanes() { return packed_wg::kLanes; }
int packed_scan_blocks_per_sm() { return packed_wg::kBlocksPerSm; }

// q [b, row_bytes] int8, db [n_phys, row_bytes] int8 (row_bytes % 16 == 0,
// <= 192, both 16-byte aligned), inv_qs [1] f32, nf [n_phys] f32,
// parts [n_parts, b, nb] int32 scratch. n_scan % nb == 0,
// n_scan / nb <= 256 segments in parts of segs_per_part, nc [n_scan] int32
// scratch (16-byte aligned). cut_kk == 0: scores [b, nb] f32 and ids
// [b, nb] int32; cut_kk > 0: ids [b, cut_kk] int32 (scores unused). Returns
// -1 if the CUDA driver refuses a TMA descriptor, else cudaGetLastError().
int packed_scan_launch(const void* q, const void* inv_qs, const void* db,
                       const void* nf, int b, int row_bytes, int n_phys,
                       int n_scan, int nb, int n_valid, int segs_per_part,
                       int n_parts, void* parts, void* nc, int cut_kk, void* scores,
                       void* ids, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (b <= 0) return cudaSuccess;
  const int n_seg = n_scan / nb;
  if (row_bytes % 16 || row_bytes > 192 || n_scan % nb || nb % packed_wg::kLanes ||
      n_seg > kPack ||
      segs_per_part <= 0 || n_parts <= 0 || (long long)segs_per_part * n_parts < n_seg)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* pp = static_cast<int*>(parts);
  const int err = packed_wg::launch_partial(q, inv_qs, db, nf, b, row_bytes, n_phys, n_scan,
                                            nb, segs_per_part, n_parts, pp,
                                            static_cast<int*>(nc), st);
  if (err != 0) return err;
  auto* sc = static_cast<float*>(scores);
  auto* ii = static_cast<int*>(ids);
  if (cut_kk > 0) {
    const size_t smem = (size_t)nb * sizeof(int);
    if (smem > 48 * 1024) {
      e = cudaFuncSetAttribute(packed_scan_merge<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
      if (e != cudaSuccess) return e;
    }
    packed_scan_merge<true><<<b, kMergeThreads, smem, st>>>(
        pp, n_parts, b, nb, n_valid, cut_kk, sc, ii);
  } else {
    packed_scan_merge<false><<<b, kMergeThreads, 0, st>>>(
        pp, n_parts, b, nb, n_valid, 0, sc, ii);
  }
  return cudaGetLastError();
}

}  // extern "C"
