// B4: exact top-kk lanes of a [B, NB] f32 score block (the candidate cut).
//
// Replaces the TPU kernel diskrag_tpu/ops/flat_scan_pallas.py::_cut_kernel
// (reached through topk_lanes_pallas). The TPU kernel runs kk rounds: take
// the row maximum, record the lowest lane holding it, knock that lane out
// with -inf; once a row has no finite lane left, record the sentinel NB.
// The result is the lanes ordered by (score desc, lane asc), cut at kk, with
// NB for every place past the row's finite lanes.
//
// What bounds it on the H100: the bytes, [B, NB] f32 read once and [B, kk]
// int32 written once (0.02 ms at 4096 x 4096, kk = 260). A first version
// ran the TPU's kk rounds, each a block-wide reduction with two
// __syncthreads, so its time grew with kk: 0.85 ms at that shape, twice
// torch.topk. This one takes 0.17 ms there (torch.topk 0.41-0.43) and 0.011
// ms at 1000 x 512, kk = 40 (H100 80GB HBM3, 700 W). What holds it now is
// latency inside a block: four histogram passes over the row in shared
// memory, whose atomics pile onto the few bins that similar scores share,
// and the sort's log2(p)(log2(p)+1)/2 barrier-separated steps.
//
// Design: a selection whose depth does not grow with kk. One block per row;
// the row is read once into shared memory as order-preserving uint32 keys
// (-0.0 canonicalised to +0.0, since the float compare ties them; -inf maps
// to the smallest key a score can have; the scores hold no NaN).
//   1. Count the finite lanes F; t = min(kk, NB, F) lanes are taken.
//   2. Radix-select the t-th largest key T: four passes of 8 bits, each a
//      256-bin histogram in shared memory (the first pass built while the
//      row is read) and a scan by one warp. A pass whose chosen bin holds
//      exactly the keys still needed ends the selection early. With
//      t = F the selection is skipped: every finite lane is taken.
//   3. Compact: every lane whose key is above T, plus the lowest-lane keys
//      equal to T until t are taken (a warp-ordered prefix count of the
//      equal keys: warp w owns a contiguous range of lanes).
//   4. Order the t picks by (key desc, lane asc) with a bitonic sort over
//      the next power of two p in shared memory (by one warp up to p = 64),
//      and write them; places [t, kk) get NB.
// A pick is sorted as one uint64, key << 32 | ~lane. Where the row and
// those words do not fit the block's shared memory (kk > 8192 at NB > 16384)
// the sort holds 16-bit lanes and reads the keys through them
// (kIndirect). The wrapper picks threads per block and the variant
// (ops/flat_scan.py::plan_cut) and sizes the shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kNegInfKey = 0x007FFFFFu;  // key of -inf
constexpr int kBins = 256;
constexpr int kMaxWarps = 32;

__device__ __forceinline__ unsigned key_of(float f) {
  unsigned u = __float_as_uint(f);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ unsigned long long pick_word(unsigned key, int lane) {
  return ((unsigned long long)key << 32) | (unsigned)(~lane);
}

struct Ctl {
  unsigned prefix, mask, k_rem;
  int done, finite, n_gt;
};

// The sort's items: uint64 words, or 16-bit lanes read through the keys
// (0xFFFF pads, below every pick).
template <bool kIndirect>
struct Picks;

template <>
struct Picks<false> {
  unsigned long long* p;
  const unsigned* keys;
  __device__ void put(int i, unsigned key, int lane) { p[i] = pick_word(key, lane); }
  __device__ void pad(int i) { p[i] = 0ull; }
  __device__ unsigned long long word(int i) const { return p[i]; }
  __device__ void swap(int a, int b) {
    const unsigned long long t = p[a];
    p[a] = p[b];
    p[b] = t;
  }
  __device__ int lane(int i) const { return (int)~(unsigned)p[i]; }
};

template <>
struct Picks<true> {
  unsigned short* p;
  const unsigned* keys;
  __device__ void put(int i, unsigned, int lane) { p[i] = (unsigned short)lane; }
  __device__ void pad(int i) { p[i] = 0xFFFFu; }
  __device__ unsigned long long word(int i) const {
    const unsigned l = p[i];
    return l == 0xFFFFu ? 0ull : pick_word(keys[l], (int)l);
  }
  __device__ void swap(int a, int b) {
    const unsigned short t = p[a];
    p[a] = p[b];
    p[b] = t;
  }
  __device__ int lane(int i) const { return p[i]; }
};

// Warp 0 finds the bin of `h` that holds the k_rem-th largest key among those
// matching (prefix, mask), digit at `shift`; narrows (prefix, mask, k_rem).
__device__ __forceinline__ void choose_bin(const unsigned* h, int shift, bool last,
                                           Ctl& ctl) {
  const int lane = threadIdx.x;
  const unsigned k_rem = ctl.k_rem;
  unsigned c[8];
  unsigned tot = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c[j] = h[kBins - 1 - 8 * lane - j];  // lane 0 holds the top digits
    tot += c[j];
  }
  unsigned incl = tot;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  unsigned run = incl - tot;  // keys in the digits above this lane's
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (run < k_rem && k_rem <= run + c[j]) {
      const unsigned d = (unsigned)(kBins - 1 - 8 * lane - j);
      ctl.prefix |= d << shift;
      ctl.mask |= 0xFFu << shift;
      ctl.k_rem = k_rem - run;
      ctl.done = last || c[j] == k_rem - run;
    }
    run += c[j];
  }
}

// Sorts places [0, p2) descending; `sync` joins the `nthreads` callers.
template <class P, class Sync>
__device__ __forceinline__ void bitonic(P& picks, int p2, int tid, int nthreads, Sync sync) {
  for (int size = 2; size <= p2; size <<= 1) {
    for (int j = size >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < (p2 >> 1); i += nthreads) {
        const int a = 2 * i - (i & (j - 1));  // bit j of a is clear
        const int b = a + j;
        const unsigned long long wa = picks.word(a), wb = picks.word(b);
        if ((a & size) == 0 ? wa < wb : wa > wb) picks.swap(a, b);
      }
      sync();
    }
  }
}

template <bool kIndirect>
__global__ void topk_lanes_kernel(const float* __restrict__ scores, int nb, int kk,
                                  int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Ctl ctl;
  __shared__ int warp_eq[kMaxWarps];
  unsigned* hist = reinterpret_cast<unsigned*>(smem);  // [2][kBins]
  unsigned* keys = hist + 2 * kBins;
  Picks<kIndirect> picks{
      reinterpret_cast<decltype(Picks<kIndirect>::p)>(keys + ((nb + 1) & ~1)), keys};
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* src = scores + (size_t)blockIdx.x * nb;
  int* dst = out + (size_t)blockIdx.x * kk;

  for (int i = tid; i < 2 * kBins; i += nthreads) hist[i] = 0u;
  if (tid == 0) {
    ctl.prefix = 0u;
    ctl.mask = 0u;
    ctl.done = 0;
    ctl.finite = 0;
    ctl.n_gt = 0;
  }
  __syncthreads();
  int fin = 0;
  for (int i = tid; i < nb; i += nthreads) {
    const unsigned k = key_of(__ldg(src + i));
    keys[i] = k;
    fin += k != kNegInfKey;
    atomicAdd(&hist[k >> 24], 1u);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) fin += __shfl_xor_sync(0xffffffffu, fin, off);
  if (lane == 0) atomicAdd(&ctl.finite, fin);
  __syncthreads();
  const int t = min(min(kk, nb), ctl.finite);
  if (t == 0) {
    for (int i = tid; i < kk; i += nthreads) dst[i] = nb;
    return;
  }

  // 2. the t-th largest key
  if (t == ctl.finite) {  // every finite lane is taken
    if (tid == 0) {
      ctl.prefix = kNegInfKey;
      ctl.mask = 0xFFFFFFFFu;
      ctl.k_rem = 0u;
    }
  } else {
    if (tid == 0) ctl.k_rem = (unsigned)t;
    for (int pass = 0; pass < 4; ++pass) {
      const int shift = 24 - 8 * pass;
      unsigned* h = hist + (pass & 1) * kBins;
      if (pass > 0) {
        const unsigned prefix = ctl.prefix, mask = ctl.mask;
        unsigned* other = hist + ((pass + 1) & 1) * kBins;  // the next pass's
        for (int i = tid; i < kBins; i += nthreads) other[i] = 0u;
        for (int i = tid; i < nb; i += nthreads) {
          const unsigned k = keys[i];
          if ((k & mask) == prefix) atomicAdd(&h[(k >> shift) & 0xFFu], 1u);
        }
      }
      __syncthreads();
      if (warp == 0) choose_bin(h, shift, pass == 3, ctl);
      __syncthreads();
      if (ctl.done) break;
    }
  }
  __syncthreads();
  const unsigned prefix = ctl.prefix, mask = ctl.mask;
  const int k_rem = (int)ctl.k_rem;
  const int n_gt = t - k_rem;  // picks above T fill [0, n_gt)

  // 3. compaction; warp w owns lanes [w * range, (w + 1) * range)
  const int nwarps = nthreads >> 5;
  const int range = ((nb + nwarps - 1) / nwarps + 31) & ~31;
  const int lo = warp * range;
  const int hi = min(nb, lo + range);
  const unsigned below = (1u << lane) - 1u;
  int eq_count = 0;
  for (int base = lo; base < hi; base += 32) {
    const int i = base + lane;
    const unsigned k = i < hi ? keys[i] : 0u;
    const bool gt = i < hi && (k & mask) > prefix;
    const bool eq = i < hi && (k & mask) == prefix;
    const unsigned bgt = __ballot_sync(0xffffffffu, gt);
    eq_count += __popc(__ballot_sync(0xffffffffu, eq));
    if (bgt) {
      int pos = 0;
      if (lane == 0) pos = atomicAdd(&ctl.n_gt, __popc(bgt));
      pos = __shfl_sync(0xffffffffu, pos, 0);
      if (gt) picks.put(pos + __popc(bgt & below), k, i);
    }
  }
  if (lane == 0) warp_eq[warp] = eq_count;
  int p2 = 1;
  while (p2 < t) p2 <<= 1;
  for (int i = t + tid; i < p2; i += nthreads) picks.pad(i);
  __syncthreads();
  if (k_rem > 0) {
    int rank = 0;
    for (int w = 0; w < warp; ++w) rank += warp_eq[w];
    for (int base = lo; base < hi && rank < k_rem; base += 32) {
      const int i = base + lane;
      const bool eq = i < hi && (keys[i] & mask) == prefix;
      const unsigned beq = __ballot_sync(0xffffffffu, eq);
      const int r = rank + __popc(beq & below);
      if (eq && r < k_rem) picks.put(n_gt + r, keys[i], i);
      rank += __popc(beq);
    }
  }
  __syncthreads();

  // 4. bitonic sort, descending, over p2 places: by warp 0 alone up to 64
  if (p2 <= 64) {
    if (warp == 0) bitonic(picks, p2, lane, 32, [] { __syncwarp(); });
    __syncthreads();
  } else {
    bitonic(picks, p2, tid, nthreads, [] { __syncthreads(); });
  }
  for (int i = tid; i < kk; i += nthreads) dst[i] = i < t ? picks.lane(i) : nb;
}

}  // namespace

extern "C" {

// scores [b, nb] f32 -> out [b, kk] int32 lanes, one block of `threads`
// threads (a multiple of 32, at most 1024) per row with `smem` bytes of
// dynamic shared memory: 2 * 256 * 4 for the histograms, 4 * nb rounded up
// to 8 bytes for the keys, then 8 (or with `indirect` 2) bytes for each of
// the next power of two >= min(kk, nb) sort places. Returns
// cudaGetLastError().
int topk_lanes_launch(const void* scores, int b, int nb, int kk, int threads,
                      int indirect, int smem, void* out, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  auto k = indirect ? topk_lanes_kernel<true> : topk_lanes_kernel<false>;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  if (b > 0 && kk > 0)
    k<<<b, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(scores), nb, kk, static_cast<int*>(out));
  return cudaGetLastError();
}

}  // extern "C"
