// Device code shared by the packed-int32 scans: B2 (packed_scan.cu), B3 /
// B6 (hier_scan.cu) and the matmul-only probe M1 (mm_probe.cu).
//
// The packed score. With one dequant scale for the whole database and one
// for the query batch, L2 order survives in integers:
//   nint   = int(clip(rint(nf_j * inv_qs), 0, 2^21))      (f32, one rounding)
//   packed = cross * 512 + (seg - nint * 256)              (int32)
// where cross = q_i8 . db_i8, nf_j = ||v_j||^2 / db_scale (+inf at pad
// rows), inv_qs = 1 / q_scale and seg < 256 is the row's segment (row / NB,
// local to its super-tile for the hierarchical fold). A plain integer max
// over a bucket lane's rows then keeps the best score and, on equal scores,
// the larger segment. Everything after the one f32 product is integer
// arithmetic, so any split of the rows over blocks and any order of the
// max gives the same bits; nf * inv_qs uses __fmul_rn so the compiler cannot
// contract it. The fused candidate cut (epilogue_cut_ids) and norm_int serve
// all three scans.
//
// What bounds the scans on the H100 is the product: 2 * B * n * D int8
// operations, 0.129 ms at 1000 x 1M x 128 at the tensor-core peak. B2 and B3
// run it on wgmma with the queries in registers and the rows fed by TMA
// (packed_wgmma.cuh; B3 0.43 ms on the device at that shape), B6 on wgmma
// too under its own schedule (pingpong_wgmma.cuh). The helpers below run it
// on mma.sync m16n8k32 (s8 x s8 -> s32), the design B2, B3 and B6 used
// before (B3 0.65 ms, B6 1.05 ms there): M1 (0.53 ms) still does (H100 80GB
// HBM3, 700 W; PERF.md). Database rows are the M side, queries
// the N side: a warp owns 16 bucket lanes (rows lane0 .. lane0+15 of every
// segment) and 8*NQ queries, keeps the queries' B fragments in registers for
// its whole life, and walks the segments, so each thread's four accumulators
// of an n-tile always belong to the same (lane, query) pairs and the running
// max lives in registers. A dot product does not care in which order k is
// summed, so fragments are filled with one 16-byte load per thread and
// 64-byte half row instead of the canonical 4-byte pieces: thread (g, t) of a
// warp reads bytes [64h + 16t, 64h + 16t + 16) of row g (and g + 8), and of
// query g of each n-tile, and words x, y feed k-step 2h, words z, w k-step
// 2h + 1. Both operands use the same permutation of k, so the sums are
// unchanged.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace packed {

constexpr int kPack = 256;        // segment ids per packed int32
constexpr int kPackBits = 8;
constexpr int kLanes = 16;        // bucket lanes per block: one mma M tile
constexpr int kWarps = 4;         // warps per block; they split the queries
constexpr int kThreads = kWarps * 32;
constexpr int kMergeThreads = 256;
constexpr int kMergeWarps = kMergeThreads / 32;
constexpr int kEmptyHier = INT_MIN >> kPackBits;  // below any reachable score

// Rows of up to 64*KH bytes. NQ n-tiles of 8 queries per warp: the B
// fragments take 4*KH*NQ registers, so the widest rows get fewer queries.
template <int KH>
struct Tile {
  static constexpr int NQ = KH <= 2 ? 8 : 4;
  static constexpr int kWarpQ = NQ * 8;
  static constexpr int kBlockQ = kWarps * kWarpQ;
};

__device__ __forceinline__ void mma_s8(int (&c)[4], unsigned a0, unsigned a1,
                                       unsigned a2, unsigned a3, unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// clip(rint(nf * inv_qs), 0, 2^21) as int: the clip in float, before the
// cast (+inf pads land on 2^21).
__device__ __forceinline__ int norm_int(float nf, float inv_qs) {
  const float r = rintf(__fmul_rn(nf, inv_qs));
  return __float2int_rn(fminf(fmaxf(r, 0.f), 2097152.f));
}

__device__ __forceinline__ uint4 zero4() { return make_uint4(0u, 0u, 0u, 0u); }

// B fragments of this warp's queries [q_base, q_base + 8*NQ): zero for
// queries past b and for 16-byte chunks past the row.
template <int KH>
__device__ __forceinline__ void load_queries(uint4 (&bq)[Tile<KH>::NQ][KH],
                                             const int8_t* __restrict__ q,
                                             int b, int row_bytes, int q_base,
                                             int g, int t) {
#pragma unroll
  for (int nt = 0; nt < Tile<KH>::NQ; ++nt) {
    const int query = q_base + nt * 8 + g;
#pragma unroll
    for (int h = 0; h < KH; ++h) {
      const int off = 64 * h + 16 * t;
      bq[nt][h] = (query < b && off < row_bytes)
                      ? __ldg(reinterpret_cast<const uint4*>(
                            q + (size_t)query * row_bytes + off))
                      : zero4();
    }
  }
}

// A fragments of rows `row` and `row + 8` straight from global memory; rows
// at or past n_phys are the scan's virtual pad rows (zero codes).
template <int KH>
__device__ __forceinline__ void load_rows(uint4 (&a)[2][KH],
                                          const int8_t* __restrict__ db,
                                          int row_bytes, long long row,
                                          int n_phys, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long rr = row + 8 * r;
#pragma unroll
    for (int h = 0; h < KH; ++h) {
      const int off = 64 * h + 16 * t;
      a[r][h] = (rr < n_phys && off < row_bytes)
                    ? __ldg(reinterpret_cast<const uint4*>(
                          db + (size_t)rr * row_bytes + off))
                    : zero4();
    }
  }
}

// acc += rows x queries for one segment (16 rows x 8*NQ queries x 64*KH k).
template <int KH>
__device__ __forceinline__ void product(int (&acc)[Tile<KH>::NQ][4],
                                        const uint4 (&a)[2][KH],
                                        const uint4 (&bq)[Tile<KH>::NQ][KH]) {
#pragma unroll
  for (int h = 0; h < KH; ++h) {
#pragma unroll
    for (int nt = 0; nt < Tile<KH>::NQ; ++nt) {
      mma_s8(acc[nt], a[0][h].x, a[1][h].x, a[0][h].y, a[1][h].y, bq[nt][h].x,
             bq[nt][h].y);
      mma_s8(acc[nt], a[0][h].z, a[1][h].z, a[0][h].w, a[1][h].w, bq[nt][h].z,
             bq[nt][h].w);
    }
  }
}

template <int KH>
__device__ __forceinline__ void clear(int (&x)[Tile<KH>::NQ][4], int v) {
#pragma unroll
  for (int nt = 0; nt < Tile<KH>::NQ; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) x[nt][c] = v;
}

// Queries per block of the mma.sync kernel (M1) for rows of
// `row_bytes` bytes: with kLanes, what its wrapper sizes the grid from.
inline int block_queries(int row_bytes) {
  return row_bytes <= 128 ? Tile<2>::kBlockQ : Tile<3>::kBlockQ;
}

// --- the fused candidate cut -------------------------------------------------

__device__ __forceinline__ bool better(int v, int l, int bv, int bl) {
  return v > bv || (v == bv && l < bl);
}

__device__ __forceinline__ void rescan(const int* s, int nb, int empty, int& bv,
                                       int& bl) {
  bv = empty;
  bl = nb;
  for (int i = threadIdx.x; i < nb; i += kMergeThreads) {
    if (s[i] > bv) {  // increasing lane order: strict '>' keeps the lowest
      bv = s[i];
      bl = i;
    }
  }
}

// Top-kk element ids of one query row from its merged state in shared
// memory (`sval` [nb], and for the hierarchical fold `sgseg` [nb]): kk
// rounds of the row maximum over the exact int32 values, lowest lane on
// ties; id = segment * nb + lane, the segment being the low 8 bits of the
// packed value or the lane's global segment; -1 once the row holds only
// `empty`, and -1 for an id at or past n_valid; the taken lane is set to
// `empty`. Each thread keeps the best of its own lanes in registers and
// only the owner of the taken lane rescans, so a round costs one
// block-wide reduction. Called by all kMergeThreads threads of the block,
// after a __syncthreads() that made the state visible.
template <bool kHier>
__device__ __forceinline__ void epilogue_cut_ids(int* sval, const int* sgseg,
                                                 int nb, int kk, int empty,
                                                 int n_valid,
                                                 int* __restrict__ dst) {
  __shared__ int wv[kMergeWarps];
  __shared__ int wl[kMergeWarps];
  __shared__ int chosen;
  int bv, bl;
  rescan(sval, nb, empty, bv, bl);
  const int warp = threadIdx.x / 32;
  const int wlane = threadIdx.x % 32;
  for (int r = 0; r < kk; ++r) {
    int v = bv;
    int l = bl;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int ov = __shfl_down_sync(0xffffffffu, v, off);
      const int ol = __shfl_down_sync(0xffffffffu, l, off);
      if (better(ov, ol, v, l)) {
        v = ov;
        l = ol;
      }
    }
    if (wlane == 0) {
      wv[warp] = v;
      wl[warp] = l;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      v = wv[0];
      l = wl[0];
      for (int w = 1; w < kMergeWarps; ++w) {
        if (better(wv[w], wl[w], v, l)) {
          v = wv[w];
          l = wl[w];
        }
      }
      const int pick = (v == empty || l >= nb) ? nb : l;
      int id = -1;
      if (pick < nb) {
        const int seg = kHier ? sgseg[pick] : (v & (kPack - 1));
        const long long e = (long long)seg * nb + pick;
        id = e < n_valid ? (int)e : -1;
        sval[pick] = empty;
      }
      dst[r] = id;
      chosen = pick;
    }
    __syncthreads();
    const int c = chosen;
    if (c >= nb) {  // exhausted: every later round is -1 too
      for (int i = r + 1 + threadIdx.x; i < kk; i += kMergeThreads) dst[i] = -1;
      break;
    }
    if (c % kMergeThreads == (int)threadIdx.x) rescan(sval, nb, empty, bv, bl);
  }
}

}  // namespace packed
