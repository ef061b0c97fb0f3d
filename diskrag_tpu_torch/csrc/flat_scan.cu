// B1: fused exhaustive scan with a bucketed top-k fold, per-row int8 or bf16.
//
// Replaces the TPU kernel diskrag_tpu/ops/flat_scan_pallas.py::_scan_kernel
// (reached through scan_bucketed_topk). For every query b and bucket lane
// l in [0, NB) it keeps the best score over the database rows
// {s*NB + l : s = 0, 1, ...} and the segment s that produced it, with a
// strict '>' so the earliest segment wins ties:
//   int8: score = ((float)(q_i8 . db_i8) * q_scale) * row1[j] - row0[j]
//   bf16: score = (2q)_bf16 . db_bf16 (f32 sum) - row0[j]
// (row0 = squared norms, +inf at pads; row1 = per-row dequant scales,
// pre-doubled for L2). Without norms (cosine, dot) the score is the
// scaled cross product, set to -inf where row0 is +inf.
//
// What bounds it on the H100: the products. At 1M x 128 and B = 1000 the
// scan is 1.28e11 multiply-adds on 128 MB of int8 rows; the int8 tensor
// cores would finish in ~0.13 ms, far above the 0.04 ms that the bytes
// need. This first version does not use the tensor cores: it runs the
// products on __dp4a (4 int8 multiply-adds per instruction) and the bf16
// path on fmaf, so it is bound by the integer/FP32 pipes: 3.6 ms at that
// shape, 28x the 0.13 ms bound, on an H100 80GB HBM3 at 700 W (PR 1,
// chip_smoke.py). wgmma is later work.
//
// Design. The TPU walks the database tiles in order on one core and
// carries the [B, NB] state in VMEM between grid steps. Here blocks run in
// parallel and in no order, so the sequential axis becomes a loop inside
// the block: a block owns kBQ queries (held in shared memory) and kLanes
// bucket lanes, one per thread, and each thread walks its lane's segments
// s = s0, s0+1, ... in increasing order, keeping kBQ (best, segment) pairs
// in registers. Nothing is shared between threads after the query tile is
// loaded, so no atomics and no ordering questions arise. Each thread
// reuses one 16-byte load of its database row for all kBQ queries (the
// wrapper zero-pads rows to a multiple of 16 bytes).
// To fill 132 SMs when B/kBQ x NB/kLanes is small, the segment range is
// cut into n_split contiguous parts that run in parallel; a second kernel
// merges the parts in order with the same strict '>', which gives exactly
// the sequential result (earliest segment on ties).
//
// Bit-exactness. nvcc contracts a*b*c - d into FMAs by default, which
// would change the last bit of int8 scores and flip ids on near-ties.
// The score is therefore computed with __int2float_rn / __fmul_rn /
// __fsub_rn in the reference order ((cross * q_scale) * row1) - row0, so
// int8 scores and ids are bit-identical to the plain PyTorch version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 32;      // queries per block
constexpr int kLanes = 128;  // bucket lanes per block, one per thread

__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

template <bool kInt8>
struct Dot;

template <>
struct Dot<true> {
  using Acc = int;
  static __device__ __forceinline__ void step(unsigned a, unsigned b, int& acc) {
    acc = __dp4a(static_cast<int>(a), static_cast<int>(b), acc);
  }
  static __device__ __forceinline__ float cross(int acc, float qs, float sc) {
    return __fmul_rn(__fmul_rn(__int2float_rn(acc), qs), sc);
  }
};

template <>
struct Dot<false> {
  using Acc = float;
  static __device__ __forceinline__ void step(unsigned a, unsigned b, float& acc) {
    acc = fmaf(bf16_lo(a), bf16_lo(b), acc);
    acc = fmaf(bf16_hi(a), bf16_hi(b), acc);
  }
  static __device__ __forceinline__ float cross(float acc, float, float) {
    return acc;
  }
};

__device__ __forceinline__ unsigned word_of(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// One block: queries [qb*kBQ, +kBQ), lanes [lb*kLanes, +kLanes), segments
// [split*seg_per_split, +seg_per_split). Row length is `row_words` 32-bit
// words, a multiple of 4: rows are read 16 bytes at a time.
template <bool kInt8, bool kL2>
__global__ void __launch_bounds__(kLanes) scan_partial(
    const unsigned* __restrict__ q, const float* __restrict__ q_scales,
    const unsigned* __restrict__ db, const float* __restrict__ norms,
    int b, int row_words, int n_rows, int nb, int seg_per_split,
    float* __restrict__ part_v, int* __restrict__ part_s) {
  using D = Dot<kInt8>;
  extern __shared__ uint4 smem[];
  const int qstride = row_words / 4;  // row length in uint4
  uint4* sq = smem;
  float* sqs = reinterpret_cast<float*>(smem + kBQ * qstride);

  const int q0 = blockIdx.x * kBQ;
  unsigned* sqw = reinterpret_cast<unsigned*>(sq);
  // `w < row_words` always holds (qstride * 4 == row_words). Written this
  // way, ptxas schedules the main loop so that the int8 L2 scan at 1M x 128,
  // B = 1000 takes 3.55 ms; without the test it takes 4.15 ms (H100 80GB
  // HBM3 at 700 W, PR 1, chip_smoke.py). Keep it until the wgmma rewrite.
  for (int i = threadIdx.x; i < kBQ * qstride * 4; i += kLanes) {
    const int qi = i / (qstride * 4);
    const int w = i % (qstride * 4);
    const int row = q0 + qi;
    sqw[i] = (row < b && w < row_words) ? q[(size_t)row * row_words + w] : 0u;
  }
  if (threadIdx.x < kBQ) {
    const int row = q0 + threadIdx.x;
    sqs[threadIdx.x] = (kInt8 && row < b) ? q_scales[row] : 0.f;
  }
  __syncthreads();

  const int lane = blockIdx.y * kLanes + threadIdx.x;
  if (lane >= nb) return;
  const int split = blockIdx.z;
  const int n_seg = (n_rows + nb - 1) / nb;
  const int s_begin = split * seg_per_split;
  const int s_end = min(n_seg, s_begin + seg_per_split);

  float best_v[kBQ];
  int best_s[kBQ];
#pragma unroll
  for (int qi = 0; qi < kBQ; ++qi) {
    best_v[qi] = -INFINITY;
    best_s[qi] = -1;
  }

  for (int s = s_begin; s < s_end; ++s) {
    const long long row = (long long)s * nb + lane;
    if (row >= n_rows) break;  // later segments lie past the table too
    typename D::Acc acc[kBQ];
#pragma unroll
    for (int qi = 0; qi < kBQ; ++qi) acc[qi] = 0;
    const uint4* rv = reinterpret_cast<const uint4*>(db + row * row_words);
    for (int c = 0; c < qstride; ++c) {
      const uint4 v = __ldg(rv + c);
#pragma unroll
      for (int qi = 0; qi < kBQ; ++qi) {
        const uint4 qv = sq[qi * qstride + c];
#pragma unroll
        for (int w = 0; w < 4; ++w) D::step(word_of(v, w), word_of(qv, w), acc[qi]);
      }
    }
    const float nrm = norms[row];
    const float sc = kInt8 ? norms[(long long)n_rows + row] : 0.f;
    const bool pad = isinf(nrm);
#pragma unroll
    for (int qi = 0; qi < kBQ; ++qi) {
      const float cr = D::cross(acc[qi], sqs[qi], sc);
      const float score = kL2 ? __fsub_rn(cr, nrm) : (pad ? -INFINITY : cr);
      if (score > best_v[qi]) {
        best_v[qi] = score;
        best_s[qi] = s;
      }
    }
  }

#pragma unroll
  for (int qi = 0; qi < kBQ; ++qi) {
    const int row = q0 + qi;
    if (row < b) {
      const size_t o = ((size_t)split * b + row) * nb + lane;
      part_v[o] = best_v[qi];
      part_s[o] = best_s[qi];
    }
  }
}

// Merge the n_split partial states in segment order and emit element ids:
// id = seg*NB + lane, or -1 for an empty bucket or an id >= n_valid.
__global__ void scan_merge(const float* __restrict__ part_v,
                           const int* __restrict__ part_s, int n_split, int b,
                           int nb, int n_valid, float* __restrict__ vals,
                           int* __restrict__ ids) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)b * nb;
  if (i >= total) return;
  float bv = -INFINITY;
  int bs = -1;
  for (int p = 0; p < n_split; ++p) {
    const float v = part_v[p * total + i];
    if (v > bv) {
      bv = v;
      bs = part_s[p * total + i];
    }
  }
  const long long id = (long long)bs * nb + (long long)(i % nb);
  vals[i] = bv;
  ids[i] = (bs < 0 || id >= n_valid) ? -1 : (int)id;
}

template <bool kInt8, bool kL2>
cudaError_t launch_partial(dim3 grid, size_t smem, cudaStream_t st,
                           const unsigned* q, const float* qs,
                           const unsigned* db, const float* norms, int b,
                           int row_words, int n_rows, int nb,
                           int seg_per_split, float* pv, int* ps) {
  auto k = scan_partial<kInt8, kL2>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  k<<<grid, kLanes, smem, st>>>(q, qs, db, norms, b, row_words, n_rows, nb,
                                 seg_per_split, pv, ps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int flat_scan_block_queries() { return kBQ; }
int flat_scan_block_lanes() { return kLanes; }

// q [b, row_words] words of int8 (4 per word) or bf16 (2 per word), with
// row_words % 4 == 0 and q, db 16-byte aligned;
// q_scales [b] f32 (int8 only); db [n_rows, row_words]; norms [R, n_rows]
// f32 (row 1 = scales, int8 only); part_v/part_s [n_split, b, nb];
// vals/ids [b, nb]. Returns cudaGetLastError() after both launches.
int flat_scan_launch(const void* q, const void* q_scales, const void* db,
                     const void* norms, int b, int row_words, int n_rows,
                     int nb, int n_valid, int int8, int l2,
                     int seg_per_split, int n_split, void* part_v,
                     void* part_s, void* vals, void* ids, int device,
                     void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)kBQ * row_words * 4 + kBQ * sizeof(float);
  dim3 grid((b + kBQ - 1) / kBQ, (nb + kLanes - 1) / kLanes, n_split);
  auto* qq = static_cast<const unsigned*>(q);
  auto* qs = static_cast<const float*>(q_scales);
  auto* dd = static_cast<const unsigned*>(db);
  auto* nn = static_cast<const float*>(norms);
  auto* pv = static_cast<float*>(part_v);
  auto* ps = static_cast<int*>(part_s);
#define DISPATCH(I8, L2)                                                      \
  if (!!int8 == I8 && !!l2 == L2)                                              \
    e = launch_partial<I8, L2>(grid, smem, st, qq, qs, dd, nn, b, row_words,   \
                               n_rows, nb, seg_per_split, pv, ps);
  DISPATCH(true, true)
  DISPATCH(true, false)
  DISPATCH(false, true)
  DISPATCH(false, false)
#undef DISPATCH
  if (e != cudaSuccess) return e;
  const size_t total = (size_t)b * nb;
  const int threads = 256;
  scan_merge<<<(unsigned)((total + threads - 1) / threads), threads, 0, st>>>(
      pv, ps, n_split, b, nb, n_valid, static_cast<float*>(vals),
      static_cast<int*>(ids));
  return cudaGetLastError();
}

}  // extern "C"
