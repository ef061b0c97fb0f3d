// Device code shared by the packed-int32 scans: B2 (packed_scan.cu) and B3 /
// B6 (hier_scan.cu).
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
// (packed_wgmma.cuh), B6 on wgmma too under its own schedule
// (pingpong_wgmma.cuh); M1 (mm_probe.cu) runs B2 / B3's product alone.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace packed {

constexpr int kPack = 256;        // segment ids per packed int32
constexpr int kPackBits = 8;
constexpr int kMergeThreads = 256;
constexpr int kMergeWarps = kMergeThreads / 32;
constexpr int kEmptyHier = INT_MIN >> kPackBits;  // below any reachable score

// clip(rint(nf * inv_qs), 0, 2^21) as int: the clip in float, before the
// cast (+inf pads land on 2^21).
__device__ __forceinline__ int norm_int(float nf, float inv_qs) {
  const float r = rintf(__fmul_rn(nf, inv_qs));
  return __float2int_rn(fminf(fmaxf(r, 0.f), 2097152.f));
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
