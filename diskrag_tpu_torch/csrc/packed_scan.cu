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
// tensor-core peak against 0.010 ms for the bytes. The design therefore puts
// the product on the tensor cores (mma.sync m16n8k32 s8) with the queries'
// fragments resident in registers, reads each row 16 bytes a thread straight
// into fragments (no shared-memory staging), and keeps the fold at one
// multiply-add and one max per score in registers. It does not use wgmma or
// TMA; that is later work, and PERF.md holds the measured distance from the
// bound.
//
// The TPU walks the database tiles in order on one core and carries the
// [B, NB] state in VMEM. Here the max is associative, so the segments are cut
// into parts that run in parallel (grid z) and a second kernel, one block per
// query, takes the max over the parts. That second kernel is where the merged
// row is last held, so the fused cut runs there from shared memory and no
// [B, NB] state reaches the caller.

#include "packed_common.cuh"

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

// Queries per block for rows of `row_bytes` bytes, and lanes per block: the
// wrapper sizes the grid's parts from them.
int packed_scan_block_queries(int row_bytes) {
  return block_queries(row_bytes);
}
int packed_scan_block_lanes() { return kLanes; }

// q [b, row_bytes] int8, db [n_phys, row_bytes] int8 (row_bytes % 16 == 0,
// <= 192, both 16-byte aligned), inv_qs [1] f32, nf [n_phys] f32,
// parts [n_parts, b, nb] int32 scratch. n_scan % nb == 0, n_scan / nb <= 256.
// cut_kk == 0: scores [b, nb] f32 and ids [b, nb] int32; cut_kk > 0:
// ids [b, cut_kk] int32 (scores unused). Returns cudaGetLastError().
int packed_scan_launch(const void* q, const void* inv_qs, const void* db,
                       const void* nf, int b, int row_bytes, int n_phys,
                       int n_scan, int nb, int n_valid, int segs_per_part,
                       int n_parts, void* parts, int cut_kk, void* scores,
                       void* ids, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (b <= 0) return cudaSuccess;
  if (row_bytes % 16 || row_bytes > 192 || n_scan % nb || nb % kLanes ||
      n_scan / nb > kPack)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* qq = static_cast<const int8_t*>(q);
  auto* iq = static_cast<const float*>(inv_qs);
  auto* dd = static_cast<const int8_t*>(db);
  auto* nn = static_cast<const float*>(nf);
  auto* pp = static_cast<int*>(parts);
  const int bq = block_queries(row_bytes);
  dim3 grid((b + bq - 1) / bq, nb / kLanes, n_parts);
  const PartKernel part = PACKED_PART_KERNEL_FOR(scan_partial, row_bytes);
  part<<<grid, kThreads, 0, st>>>(qq, iq, dd, nn, b, row_bytes, n_phys, n_scan,
                                  nb, segs_per_part, pp);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
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
