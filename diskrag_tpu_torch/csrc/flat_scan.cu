// B1: fused exhaustive scan with a bucketed top-k fold, per-row int8 or bf16.
//
// Replaces the TPU kernel diskrag_tpu/ops/flat_scan_pallas.py::_scan_kernel
// (reached through scan_bucketed_topk; its int8=False branch is the bf16
// form). For every query b and bucket lane l in [0, NB) it keeps the best
// score over the database rows {s*NB + l : s = 0, 1, ...} and the segment s
// that produced it, with a strict '>' so the earliest segment wins ties:
//   int8: score = ((float)(q_i8 . db_i8) * q_scale) * row1[j] - row0[j]
//   bf16: score = (2q)_bf16 . db_bf16 (f32 sum) - row0[j]
// (row0 = squared norms, +inf at pads; row1 = per-row dequant scales,
// pre-doubled for L2). Without norms (cosine, dot) the score is the
// scaled cross product, set to -inf where row0 is +inf.
//
// What bounds it on the H100: the products. At 1M x 128 and B = 1000 the
// int8 scan is 1.28e11 multiply-adds on 128 MB of int8 rows: 0.13 ms at the
// int8 tensor-core peak, against 0.04 ms for the bytes; the bf16 scan the
// same multiply-adds at half the rate on 256 MB (0.26 ms against 0.08). Next
// come the fold's f32 operations, about six per int8 score and one per bf16
// score (1e9 scores there), and the L2 traffic of the row tiles, which every
// query tile of the batch reads again (0.9 GB at that shape, 1.8 GB in
// bf16). A first int8 version on __dp4a ran the products on the integer
// pipe, 28x the bound (3.6 ms); the first bf16 one on fmaf, 46x (2.40 ms at
// 200k). The int8 kernel below takes 0.74 ms at 1M and 0.63 ms at 4096
// queries x 200k rows, NB 4096 (H100 80GB HBM3, 700 W): a 64 x 64 tile of
// 128-byte rows costs an SM about 0.34 us against the ~0.07 us its products
// need. What holds it now is the chain inside a warpgroup, wait for the
// tile, multiply, wait for the product, fold, with three warpgroups to
// overlap one another's chains. Overlapping one segment's fold with the
// next one's product inside a warpgroup (a second set of accumulators), or
// half a tile's fold with the other half's product (two m64n32 groups),
// measured slower; a ring of 8 stages instead of 4 measured the same: the
// copies keep up.
//
// Design (scan_wgmma, instantiated as scan_i8_wgmma and scan_bf16_wgmma):
// the products on the tensor cores through wgmma, m64n64k32 s8 into s32 or
// m64n64k16 bf16 into f32, both operands read from shared memory, fed by
// TMA (wgmma_common.cuh). A k-step is 32 bytes of K in either type, so the
// tiles, the swizzle and the descriptors are the same bytes; a 128-dim bf16
// row is two 128-byte K boxes where an int8 row is one.
//  - A block owns 64, 128 or 192 queries (one to three consumer warpgroups
//    of 64, chosen by the wrapper), a lane tile of 64 bucket lanes and a
//    contiguous range of segments. For segment s its database tile is rows
//    [s*NB + l0, +64): contiguous rows, one 2-D TMA box per 128 bytes of K.
//    Walking the segments in increasing order keeps each (query, lane) pair
//    on the same thread's accumulator register every time, so the best
//    score and its segment stay in registers with a strict '>'.
//  - The queries are loaded once into shared memory (A); the database tiles
//    (B) and their norm rows (row0 and row1 for int8, row0 for bf16) pass
//    through a ring of 4 stages that one producer thread fills with TMA
//    (mbarrier completion). Rows wider than 128 bytes loop over K boxes; K
//    past a row's end and rows past the table's end are TMA's zero fill, and
//    their norms its NaN fill, which no score can beat: NaN - anything is
//    NaN, never '>' the best, and the norm-free metrics take -inf unless
//    row0 < +inf, which NaN is not. Where all K boxes of the queries would
//    not fit the block's shared memory (rows above ~2.9 KB), the query
//    boxes pass through the ring beside the database tile instead
//    ("streamed").
//  - int8's fold converts each s32 accumulator exactly: for D <= 256 bytes,
//    |acc| <= 2^22 and int -> float is an integer add and an fsub
//    (__int_as_float(acc + 0x4B400000) - 12582912), not the quarter-rate
//    I2F; wider rows keep __int2float_rn. bf16's fold is one __fsub_rn (L2)
//    or one select.
//  - The grid runs the query tiles fastest, so the blocks that share a
//    database tile run together and read it from L2.
// To fill 132 SMs when the query x lane tiles are few, the segment range is
// cut into n_split contiguous parts that run in parallel; scan_merge then
// merges the parts in segment order with the same strict '>', which gives
// exactly the sequential result (earliest segment on ties). With one part
// the kernel writes the scores and ids itself. The wrapper plans the tiles
// and the parts (ops/flat_scan.py::plan_rowscan, at the row's bytes).
//
// Exactness. nvcc contracts a*b*c - d into FMAs by default, which would
// change the last bit of int8 scores and flip ids on near-ties. The int8
// score is therefore computed with __fmul_rn / __fsub_rn in the reference
// order ((cross * q_scale) * row1) - row0, so int8 scores and ids are
// bit-identical to the plain PyTorch version. The bf16 products are exact
// in f32 but the tensor cores add them in their own order, so bf16 scores
// agree with the plain version to f32 rounding, not bit for bit.

#include <math.h>

#include <type_traits>

#include "wgmma_common.cuh"

namespace {

// --- the scan: wgmma + TMA --------------------------------------------------

constexpr int kStages = 4;
constexpr int kLanes = wg::kTileRows;      // bucket lanes per block
constexpr int kWgQueries = wg::kTileRows;  // queries per consumer warpgroup
constexpr int kMaxConsumers = 3;
constexpr int kNormFloats = 2 * kLanes;    // a tile's row0, then its row1 (int8)

// Bytes of dynamic shared memory, with 1024 of slack for the alignment the
// swizzled tiles need (both forms: bf16 leaves a stage's row1 unused).
__host__ __device__ inline int stage_tiles(int n_cons, bool streamed) {
  return 1 + (streamed ? n_cons : 0);
}
__host__ __device__ inline int a_bytes(int n_cons, int n_kb, bool streamed) {
  return streamed ? 0 : n_cons * n_kb * wg::kTileBytes;
}
inline int scan_smem_bytes(int n_cons, int n_kb, bool streamed) {
  return 1024 + a_bytes(n_cons, n_kb, streamed) +
         kStages * stage_tiles(n_cons, streamed) * wg::kTileBytes +
         kStages * kNormFloats * 4 + (2 * kStages + 1) * 8;
}

using Ring = wg::Ring<kStages>;

// Multiplies the next stage's K box: acc (+)= the warpgroup's query box
// (resident at a_res, or streamed beside the database tile) x the tile;
// s8 products into int accumulators, bf16 ones into float.
template <typename Acc>
__device__ __forceinline__ void issue_box(Acc (&acc)[32], Ring& r, uint64_t* full,
                                          const unsigned char* stages, int stage_bytes,
                                          const unsigned char* a_res, int w, bool streamed,
                                          bool accumulate) {
  wg::mbar_wait(&full[r.stage], r.phase);
  const unsigned char* st = stages + r.stage * stage_bytes;
  wg::wgmma_fence();
  wg::wgmma_tile(acc, streamed ? st + (1 + w) * wg::kTileBytes : a_res, st, accumulate);
  wg::wgmma_commit();
  r.next();
}

// Hands the oldest stage still held back to the producer.
__device__ __forceinline__ void release(Ring& r, uint64_t* empty) {
  wg::mbar_arrive(&empty[r.release]);
  r.release = (r.release + 1) % kStages;
}

// Folds segment s's finished product into (best_v, best_s) with the norms
// staged beside its last K box, then hands that stage back.
template <bool kL2, bool kSmallD>
__device__ __forceinline__ void fold_segment(const int (&acc)[32], Ring& r, uint64_t* empty,
                                             const float* snorm, int s,
                                             const float (&qs)[2], int t4,
                                             float (&best_v)[32], int (&best_s)[32]) {
  const float* sn = snorm + r.release * kNormFloats;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float2 r0 = *reinterpret_cast<const float2*>(sn + 8 * c + 2 * t4);
    const float2 r1 = *reinterpret_cast<const float2*>(sn + kLanes + 8 * c + 2 * t4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int i = 4 * c + 2 * h + j;
        const float nrm = j ? r0.y : r0.x;
        const float sc = j ? r1.y : r1.x;
        const float f = kSmallD ? __fsub_rn(__int_as_float(acc[i] + 0x4B400000), 12582912.f)
                                : __int2float_rn(acc[i]);
        const float cr = __fmul_rn(__fmul_rn(f, qs[h]), sc);
        const float score = kL2 ? __fsub_rn(cr, nrm) : (nrm < INFINITY ? cr : -INFINITY);
        if (score > best_v[i]) {
          best_v[i] = score;
          best_s[i] = s;
        }
      }
    }
  }
  // The norms above were read with plain loads and the refill of this stage
  // is a TMA write (the async proxy): without the fence nothing orders the
  // two, and a refill could land before the loads (the race B3 showed on the
  // card with the same pattern). The K-box stages handed back in the loop
  // were read by wgmma alone and need none.
  wg::fence_proxy_async();
  release(r, empty);
}

// The bf16 form: the f32 accumulator is the cross product (the query copy
// already doubled for L2), so the score is one subtraction or one select.
template <bool kL2, bool kSmallD>
__device__ __forceinline__ void fold_segment(const float (&acc)[32], Ring& r, uint64_t* empty,
                                             const float* snorm, int s,
                                             const float (&)[2], int t4,
                                             float (&best_v)[32], int (&best_s)[32]) {
  const float* sn = snorm + r.release * kNormFloats;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float2 r0 = *reinterpret_cast<const float2*>(sn + 8 * c + 2 * t4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int i = 4 * c + 2 * h + j;
        const float nrm = j ? r0.y : r0.x;
        const float score = kL2 ? __fsub_rn(acc[i], nrm) : (nrm < INFINITY ? acc[i] : -INFINITY);
        if (score > best_v[i]) {
          best_v[i] = score;
          best_s[i] = s;
        }
      }
    }
  }
  wg::fence_proxy_async();  // as above
  release(r, empty);
}

// The scan of one block (see the top of the file); Acc is int for the int8
// form, float for bf16. Called by the two __global__ instantiations below.
template <typename Acc, bool kL2, bool kSmallD>
__device__ __forceinline__ void scan_wgmma(
    const CUtensorMap* q_map, const CUtensorMap* db_map, const CUtensorMap* norm_map,
    const float* __restrict__ q_scales, int b, int n_kb, int nb, int n_rows, int n_valid,
    int seg_per_split, int streamed, float* __restrict__ part_v, int* __restrict__ part_s,
    float* __restrict__ vals, int* __restrict__ ids) {
  constexpr bool kBf16 = std::is_same<Acc, float>::value;
  // a stage's norms: row0 and row1 for int8, row0 alone for bf16
  constexpr int kNormBytes = (kBf16 ? 1 : 2) * kLanes * 4;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int n_cons = (blockDim.x - 32) / 128;
  unsigned char* stages = base + a_bytes(n_cons, n_kb, streamed);
  const int stage_bytes = stage_tiles(n_cons, streamed) * wg::kTileBytes;
  float* snorm = reinterpret_cast<float*>(stages + kStages * stage_bytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(snorm + kStages * kNormFloats);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  const int q0 = blockIdx.x * n_cons * kWgQueries;
  const int l0 = blockIdx.y * kLanes;
  const int split = blockIdx.z;
  const int n_seg = (n_rows + nb - 1) / nb;
  const int s_begin = split * seg_per_split;
  const int s_end = min(n_seg, s_begin + seg_per_split);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      wg::mbar_init(&full[i], 1);  // the producer's expect_tx
      wg::mbar_init(&empty[i], n_cons * 128);
    }
    wg::mbar_init(qbar, 1);
    wg::mbar_init_fence();
  }
  __syncthreads();

  if (warp == n_cons * 4) {
    // producer (one thread): the query boxes once, then for every (segment,
    // K box) in order the database tile and the tile's norms
    if (lane != 0) return;
    if (!streamed) {
      wg::mbar_arrive_expect_tx(qbar, n_cons * n_kb * wg::kTileBytes);
      for (int w = 0; w < n_cons; ++w)
        for (int kb = 0; kb < n_kb; ++kb)
          wg::tma_load_2d(base + (w * n_kb + kb) * wg::kTileBytes, q_map, qbar,
                          kb * wg::kBoxK, q0 + w * kWgQueries);
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int s = s_begin; s < s_end; ++s) {
      for (int kb = 0; kb < n_kb; ++kb) {
        wg::mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* st = stages + stage * stage_bytes;
        wg::mbar_arrive_expect_tx(&full[stage], stage_bytes + kNormBytes);
        wg::tma_load_2d(st, db_map, &full[stage], kb * wg::kBoxK, s * nb + l0);
        if (streamed)
          for (int w = 0; w < n_cons; ++w)
            wg::tma_load_2d(st + (1 + w) * wg::kTileBytes, q_map, &full[stage],
                            kb * wg::kBoxK, q0 + w * kWgQueries);
        wg::tma_load_2d(snorm + stage * kNormFloats, norm_map, &full[stage], s * nb + l0, 0);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warpgroup w multiplies queries [q0 + 64w, +64) by each tile
  const int w = warp >> 2;
  const int wt = threadIdx.x & 127;
  const int g = (wt & 31) >> 2;
  const int t4 = wt & 3;
  const int row_lo = q0 + w * kWgQueries + 16 * (wt >> 5) + g;  // and row_lo + 8
  float qs[2] = {0.f, 0.f};
  if constexpr (!kBf16) {
#pragma unroll
    for (int h = 0; h < 2; ++h) qs[h] = row_lo + 8 * h < b ? q_scales[row_lo + 8 * h] : 0.f;
  }
  float best_v[32];
  int best_s[32];
  Acc acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    best_v[i] = -INFINITY;
    best_s[i] = -1;
    acc[i] = 0;
  }
  if (!streamed) wg::mbar_wait(qbar, 0);
  const unsigned char* a_res = base + w * n_kb * wg::kTileBytes;
  Ring r;
  // one K box at a time; each stage is handed back as soon as its product
  // is done, the segment's last after the fold, which reads its norms
  for (int s = s_begin; s < s_end; ++s) {
    for (int kb = 0; kb < n_kb; ++kb) {
      issue_box(acc, r, full, stages, stage_bytes, a_res + kb * wg::kTileBytes, w, streamed,
                kb > 0);
      wg::wgmma_wait<0>();
      if (kb + 1 < n_kb) release(r, empty);
    }
    fold_segment<kL2, kSmallD>(acc, r, empty, snorm, s, qs, t4, best_v, best_s);
  }

#pragma unroll
  for (int c = 0; c < 8; ++c) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int i = 4 * c + 2 * h + j;
        const int query = row_lo + 8 * h;
        const int ln = l0 + 8 * c + 2 * t4 + j;
        if (query < b && ln < nb) {
          if (gridDim.z == 1) {  // one part: the final output, no merge
            const size_t o = (size_t)query * nb + ln;
            const long long id = (long long)best_s[i] * nb + ln;
            vals[o] = best_v[i];
            ids[o] = (best_s[i] < 0 || id >= n_valid) ? -1 : (int)id;
          } else {
            const size_t o = ((size_t)split * b + query) * nb + ln;
            part_v[o] = best_v[i];
            part_s[o] = best_s[i];
          }
        }
      }
    }
  }
}

template <bool kL2, bool kSmallD>
__global__ void __launch_bounds__(kMaxConsumers * 128 + 32, 1) scan_i8_wgmma(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap db_map,
    const __grid_constant__ CUtensorMap norm_map, const float* __restrict__ q_scales, int b,
    int n_kb, int nb, int n_rows, int n_valid, int seg_per_split, int streamed,
    float* __restrict__ part_v, int* __restrict__ part_s, float* __restrict__ vals,
    int* __restrict__ ids) {
  scan_wgmma<int, kL2, kSmallD>(&q_map, &db_map, &norm_map, q_scales, b, n_kb, nb, n_rows,
                                n_valid, seg_per_split, streamed, part_v, part_s, vals, ids);
}

template <bool kL2>
__global__ void __launch_bounds__(kMaxConsumers * 128 + 32, 1) scan_bf16_wgmma(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap db_map,
    const __grid_constant__ CUtensorMap norm_map, const float* __restrict__ q_scales, int b,
    int n_kb, int nb, int n_rows, int n_valid, int seg_per_split, int streamed,
    float* __restrict__ part_v, int* __restrict__ part_s, float* __restrict__ vals,
    int* __restrict__ ids) {
  scan_wgmma<float, kL2, false>(&q_map, &db_map, &norm_map, q_scales, b, n_kb, nb, n_rows,
                                n_valid, seg_per_split, streamed, part_v, part_s, vals, ids);
}

// --- the merge of the parts ------------------------------------------------

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

cudaError_t launch_merge(cudaStream_t st, const void* pv, const void* ps, int n_split,
                         int b, int nb, int n_valid, void* vals, void* ids) {
  const size_t total = (size_t)b * nb;
  const int threads = 256;
  scan_merge<<<(unsigned)((total + threads - 1) / threads), threads, 0, st>>>(
      static_cast<const float*>(pv), static_cast<const int*>(ps), n_split, b, nb,
      n_valid, static_cast<float*>(vals), static_cast<int*>(ids));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Tile sizes of the scan kernels: queries per consumer warpgroup, consumer
// warpgroups per block at most, lanes per block.
int flat_scan_wg_queries() { return kWgQueries; }
int flat_scan_lanes() { return kLanes; }
int flat_scan_max_consumers() { return kMaxConsumers; }

// q [b, row_bytes] and db [n_rows, row_bytes], int8 (bf16 = 0) or bf16 (bf16
// = 1; the queries already doubled for L2), row_bytes % 16 == 0, both
// 16-byte aligned. int8: q_scales [b] f32 and norms [2, n_rows] f32 rows
// `norm_stride` floats apart (a multiple of 4, base 16-byte aligned; row 1 =
// scales). bf16: q_scales unused, norms' row 0 alone is read (a [n_rows]
// f32 vector will do; norm_stride unused). part_v/part_s [n_split, b, nb]
// (unused when n_split == 1); vals/ids [b, nb]. n_cons consumer warpgroups
// (1 to 3) per block; `streamed` passes the query boxes through the ring.
// Returns -1 if the CUDA driver refuses a TMA descriptor, else
// cudaGetLastError() after the launches.
int flat_scan_launch(int bf16, const void* q, const void* q_scales, const void* db,
                     const void* norms, int b, int row_bytes, int n_rows, int norm_stride,
                     int nb, int n_valid, int l2, int n_cons, int streamed, int seg_per_split,
                     int n_split, void* part_v, void* part_s, void* vals, void* ids,
                     int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  CUtensorMap q_map, db_map, norm_map;
  if (!wg::make_row_map(&q_map, q, b, row_bytes) ||
      !wg::make_row_map(&db_map, db, n_rows, row_bytes) ||
      !wg::make_norm_map(&norm_map, norms, n_rows,
                         bf16 ? (n_rows + 3LL) / 4 * 4 : norm_stride, bf16 ? 1 : 2))
    return -1;
  const int n_kb = (row_bytes + wg::kBoxK - 1) / wg::kBoxK;
  const int smem = scan_smem_bytes(n_cons, n_kb, streamed != 0);
  const bool small_d = row_bytes <= 256;  // int8: |acc| <= 128 * 128 * 256 = 2^22
  auto k = bf16 ? (l2 ? scan_bf16_wgmma<true> : scan_bf16_wgmma<false>)
           : l2 ? (small_d ? scan_i8_wgmma<true, true> : scan_i8_wgmma<true, false>)
                : (small_d ? scan_i8_wgmma<false, true> : scan_i8_wgmma<false, false>);
  e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int q_tile = n_cons * kWgQueries;
  dim3 grid((b + q_tile - 1) / q_tile, (nb + kLanes - 1) / kLanes, n_split);
  k<<<grid, n_cons * 128 + 32, smem, st>>>(
      q_map, db_map, norm_map, static_cast<const float*>(q_scales), b, n_kb, nb, n_rows,
      n_valid, seg_per_split, streamed, static_cast<float*>(part_v),
      static_cast<int*>(part_s), static_cast<float*>(vals), static_cast<int*>(ids));
  e = cudaGetLastError();
  if (e != cudaSuccess || n_split == 1) return e;
  return launch_merge(st, part_v, part_s, n_split, b, nb, n_valid, vals, ids);
}

}  // extern "C"
