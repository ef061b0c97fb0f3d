// B4: exact top-kk lanes of a [B, NB] f32 score block (the candidate cut).
//
// Replaces the TPU kernel diskrag_tpu/ops/flat_scan_pallas.py::_cut_kernel
// (reached through topk_lanes_pallas). Round i takes the row maximum,
// records the lowest lane holding it, and knocks that lane out with -inf.
// Once a row has no finite lane left it records the sentinel NB.
//
// What bounds it on the H100: neither bytes nor arithmetic. Reading the
// [1000, 512] f32 block is 2 MB, ~0.6 us at 3.35 TB/s; the work is kk
// rounds of a block-wide reduction, so it is bound by the latency of the
// kk dependent reductions (two __syncthreads each).
//
// Design. One block per row; the row is copied once into shared memory.
// Each of the kThreads threads owns lanes t, t+kThreads, ... and keeps its
// own best (value, lowest lane) in registers. A round is a warp-shuffle
// reduction of those bests plus one step across warps; only the thread that
// owned the knocked-out lane rescans its lanes, so a round costs
// NB/kThreads reads instead of NB. The reduction orders (value desc, lane
// asc), which is the TPU kernel's max-then-lowest-lane rule, so the result
// is bit-identical to the plain version, sentinel included.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ bool better(float v, int l, float bv, int bl) {
  return v > bv || (v == bv && l < bl);
}

__device__ __forceinline__ void rescan(const float* s, int nb, float& bv,
                                       int& bl) {
  bv = -INFINITY;
  bl = nb;
  for (int i = threadIdx.x; i < nb; i += kThreads) {
    if (s[i] > bv) {  // increasing lane order: strict '>' keeps the lowest
      bv = s[i];
      bl = i;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    topk_lanes_kernel(const float* __restrict__ scores, int nb, int kk,
                      int* __restrict__ out) {
  extern __shared__ float s[];
  __shared__ float wv[kWarps];
  __shared__ int wl[kWarps];
  __shared__ int chosen;
  const int row = blockIdx.x;
  const float* src = scores + (size_t)row * nb;
  int* dst = out + (size_t)row * kk;
  for (int i = threadIdx.x; i < nb; i += kThreads) s[i] = src[i];
  __syncthreads();

  float bv;
  int bl;
  rescan(s, nb, bv, bl);
  const int warp = threadIdx.x / 32;
  const int wlane = threadIdx.x % 32;
  for (int r = 0; r < kk; ++r) {
    float v = bv;
    int l = bl;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, v, off);
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
      for (int w = 1; w < kWarps; ++w) {
        if (better(wv[w], wl[w], v, l)) {
          v = wv[w];
          l = wl[w];
        }
      }
      const int pick = (v == -INFINITY) ? nb : l;
      dst[r] = pick;
      chosen = pick;
      if (pick < nb) s[pick] = -INFINITY;
    }
    __syncthreads();
    const int c = chosen;
    if (c >= nb) {  // exhausted: every later round is the sentinel too
      for (int i = r + 1 + threadIdx.x; i < kk; i += kThreads) dst[i] = nb;
      break;
    }
    if (c % kThreads == (int)threadIdx.x) rescan(s, nb, bv, bl);
  }
}

}  // namespace

extern "C" {

// scores [b, nb] f32 -> out [b, kk] int32 lanes. Returns cudaGetLastError().
int topk_lanes_launch(const void* scores, int b, int nb, int kk, void* out,
                      int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const size_t smem = (size_t)nb * sizeof(float);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(topk_lanes_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
  }
  if (b > 0)
    topk_lanes_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(scores), nb, kk, static_cast<int*>(out));
  return cudaGetLastError();
}

}  // extern "C"
