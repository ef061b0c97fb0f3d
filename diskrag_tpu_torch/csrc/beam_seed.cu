// G2: the exact search's seeded candidate list in one launch.
//
// The counterpart, for the exact L2 f32 search that G1 (beam_traverse.cu)
// serves, of diskrag_tpu_torch/graph/search.py::_seed_candidates: the medoid
// and the entry points scored against every query, the L closest kept. G1
// then starts from this state; the two go to one stream back to back, with
// no PyTorch op and no host read between them.
//
// Seeds: position 0 is the medoid (read from the device, or passed by value),
// position i > 0 is entry_points[i - 1]; a copy of the medoid at a position
// > 0 scores +inf. Distance: _gathered_distance's formula in f32,
// max(qn + vn - 2 q.v, 0), the three steps rounded apart (no contraction, no
// TF32), its sums taken in another order than PyTorch's. Order: ascending by
// the key (distance with -0 folded into +0, position), which is the stable
// sort's, so ties go to the lower position. With S >= L seeds the L smallest,
// +inf entries as id -1; with S < L the seeds in position order padded with
// -1 / +inf, unsorted, as the plain seeding leaves them (G1 sorts its input
// stably once). `expanded` is id == -1.
//
// Grid: query tiles x seed slices, both taken from B and S alone (the host's
// plan, ops/traverse.py::seed_plan). Each block keeps its tile's queries in
// shared memory, walks its slice in chunks of kChunk seeds (a warp loads
// RW seed rows by id, float4 loads, all RW in flight, and scores each
// against every query of the tile: one read of a row serves the tile),
// moves each query's chunk keys below its current L-th smallest to the
// front (no other can enter), sorts those and merges them by ranks into the
// query's running L smallest. With one slice the block writes the seeded
// list. With several each block writes its (query, slice) lists to global
// memory, and the last block of a tile to finish (a counter and a fence: no
// second pass) merges its queries' slice lists pairwise, by ranks, into the
// top L.
//
// What bounds it on an H100 (80 GB HBM3, 700 W) at the exact cells' shape
// (15,626 seeds of 128 floats, L 32): latency at B = 1, 22 us against a
// 2.3-us byte bound: ~9 us in each of the 123 blocks (the load and scoring
// of its 128 rows 2.7, the sort of its chunk 3.8) and ~11 us in the last
// block's seven merge levels of 123 lists; at B = 512 the products (2 x 512
// x 15,626 x 128 operations, each row read 32 times, not 512), 0.25 ms
// against a 0.03-ms bound, ~12 us a chunk of 128 seeds in each block.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 128;          // seeds scored between two selections
constexpr int kMergeKeys = 4096;     // a query's slices x L, the last block's merge
constexpr int kTileBytes = 48 * 1024;  // the tile's scoring state (queries, chunk, lists)
constexpr unsigned long long kPadKey = ~0ull;
constexpr unsigned kFull = 0xffffffffu;

// the kernel's limits, also checked by the wrapper (ops/traverse.py)
constexpr int kMaxDim = 2048;
constexpr int kMaxWidth = 256;

struct Params {
  const float* vectors;       // [n, d]
  const float* queries;       // [b, d]
  const int* medoid_ptr;      // the medoid on the device, or null: `medoid`
  const int* entry_points;    // [s - 1]; null when s == 1
  long long n;
  int medoid, b, d, s, l, ns, sl, group;  // ns slices of sl seeds; group: queries a merge pass
  unsigned long long* lists;  // [tiles * qt, ns, l] when ns > 1
  unsigned* tile_done;        // [tiles] slices finished, zero on entry and on exit
  int* out_ids;               // [b, l]
  float* out_dists;           // [b, l]
  uint8_t* out_expanded;      // [b, l]
  int* zero;                  // set to 0 (G1's round counter), or null
};

// Byte offsets of the block's shared arrays; the host sizes the launch with
// the same struct. The merge's two buffers reuse the space from 0.
template <int QT>
struct Layout {
  int q, qn, chunk, run0, run1, tile_bytes, bytes;
  __host__ __device__ Layout(int d, int l, int ns, int group) {
    int o = 0;
    q = o;      o += 4 * QT * d;
    qn = o;     o += 8 * ((QT + 1) / 2);
    chunk = o;  o += 8 * QT * kChunk;
    run0 = o;   o += 8 * QT * l;
    run1 = o;   o += 8 * QT * l;
    tile_bytes = o;
    const int merge = ns > 1 ? 16 * group * ns * l : 0;
    bytes = o > merge ? o : merge;
  }
};

// A distance as an unsigned key of the same order (-0 folded into +0),
// the position in the low half.
__device__ __forceinline__ unsigned long long order_key(float x, int pos) {
  uint32_t u = x == 0.f ? 0u : __float_as_uint(x);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (uint32_t)pos;
}

__device__ __forceinline__ float key_dist(unsigned long long k) {
  const uint32_t u = (uint32_t)(k >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ int seed_id(const Params& p, int medoid, int pos) {
  return pos == 0 ? medoid : __ldg(p.entry_points + pos - 1);
}

// Keys of a[0, len) below x (a sorted ascending, len <= kMaxWidth): a
// search of fixed steps and no branch, so that the searches a thread makes
// together overlap their loads.
__device__ __forceinline__ int count_below(const unsigned long long* a, int len,
                                           unsigned long long x) {
  int pos = 0;
#pragma unroll
  for (int step = kMaxWidth; step > 0; step >>= 1)
    pos += (pos + step <= len && a[pos + step - 1] < x) ? step : 0;
  return pos;
}

// The warp's V partial sums (a power of two) reduced over its 32 lanes and
// scattered: each halving step trades half of the values with the lane O
// apart. Afterwards, for V >= 32, lane t holds the totals of values
// t * (V / 32) + i, i < V / 32; for V < 32 it holds value t / (32 / V) in v[0].
template <int V, int O>
struct ReduceScatter {
  static __device__ __forceinline__ void run(float* v, int lane) {
    if constexpr (O > 0) {
      if constexpr (V > 1) {
        constexpr int H = V / 2;
        const bool up = lane & O;
#pragma unroll
        for (int i = 0; i < H; ++i) {
          const float send = up ? v[i] : v[i + H];
          const float keep = up ? v[i + H] : v[i];
          v[i] = keep + __shfl_xor_sync(kFull, send, O);
        }
        ReduceScatter<H, O / 2>::run(v, lane);
      } else {
        v[0] += __shfl_xor_sync(kFull, v[0], O);
        ReduceScatter<1, O / 2>::run(v, lane);
      }
    }
  }
};

// Ascending bitonic sort of the first 2^log_n keys of `segs` rows of
// kChunk keys, all rows at once by the whole block. A warp's 32 threads
// take 32 consecutive pairs, so a step of stride 32 or less stays within
// the 64 keys the warp owns: only a step of stride 64 waits on the block,
// before it and after it.
__device__ void sort_rows(unsigned long long* k, int segs, int log_n) {
  const int n = 1 << log_n, half = n >> 1;
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride > 32) __syncthreads();
      for (int t = threadIdx.x; t < segs * half; t += kThreads) {
        const int u = t & (half - 1);
        const int i = 2 * u - (u & (stride - 1));
        const int j = i + stride;
        unsigned long long* a = k + (t >> (log_n - 1)) * kChunk;
        const unsigned long long x = a[i], y = a[j];
        if ((x > y) == ((i & size) == 0)) {
          a[i] = y;
          a[j] = x;
        }
      }
      if (stride > 32) __syncthreads(); else __syncwarp();
    }
  }
  __syncthreads();
}

// Merge by ranks of the sorted a[0, la) and b[0, lb) (keys unique but for
// padding) into out[0, l): the l smallest, by the calling warp.
__device__ __forceinline__ void merge_lists(const unsigned long long* a, int la,
                                            const unsigned long long* b, int lb,
                                            unsigned long long* out, int l, int lane) {
  const int n = la > lb ? la : lb;
  for (int at = lane; at < n; at += 32) {
    const bool in_a = at < la, in_b = at < lb;
    const unsigned long long x = in_a ? a[at] : 0ull, y = in_b ? b[at] : 0ull;
    const int rx = at + count_below(b, lb, x), ry = at + count_below(a, la, y);
    if (in_a && rx < l) out[rx] = x;
    if (in_b && ry < l) out[ry] = y;
  }
}

// Seed list slot i of query q from its key.
__device__ __forceinline__ void write_slot(const Params& p, int medoid, int q, int i,
                                           unsigned long long key) {
  float x = CUDART_INF_F;
  int id = -1;
  if (key != kPadKey) {
    x = key_dist(key);
    if (!isinf(x)) id = seed_id(p, medoid, (int)(key & 0xffffffffu));
  }
  const size_t at = (size_t)q * p.l + i;
  p.out_ids[at] = id;
  p.out_dists[at] = x;
  p.out_expanded[at] = id == -1;
}

template <int QT>
__global__ void __launch_bounds__(kThreads) beam_seed_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int RW = QT <= 2 ? 16 : QT <= 8 ? 8 : 4;  // rows a warp scores at once
  constexpr int V = RW * QT;
  constexpr int HELD = V >= 32 ? V / 32 : 1;   // sums a lane holds after the reduction
  constexpr int SHARE = V >= 32 ? 1 : 32 / V;  // lanes holding each
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d = p.d, d4 = d >> 2, l = p.l, s = p.s;
  const Layout<QT> lay(d, l, p.ns, p.group);
  float* qs = reinterpret_cast<float*>(smem + lay.q);
  float* qn_s = reinterpret_cast<float*>(smem + lay.qn);
  unsigned long long* ck = reinterpret_cast<unsigned long long*>(smem + lay.chunk);
  unsigned long long* run = reinterpret_cast<unsigned long long*>(smem + lay.run0);
  unsigned long long* run_next = reinterpret_cast<unsigned long long*>(smem + lay.run1);
  __shared__ int last, most;  // the tile's last block; the most keys a query keeps of a chunk

  const int tile = blockIdx.x, slice = blockIdx.y;
  const int q0 = tile * QT;
  const int p0 = slice * p.sl, p1 = min(s, p0 + p.sl);
  const int medoid = p.medoid_ptr ? __ldg(p.medoid_ptr) : p.medoid;
  const bool sorted = s >= l;
  if (p.zero && tile == 0 && slice == 0 && tid == 0) *p.zero = 0;

  // --- the tile's queries, their squared norms, the empty lists -----------
  for (int i = tid; i < QT * d; i += kThreads) {
    const int q = q0 + i / d;
    qs[i] = q < p.b ? p.queries[(size_t)q * d + i % d] : 0.f;
  }
  __syncthreads();
  for (int qi = warp; qi < QT; qi += kWarps) {
    float x = 0.f;
    for (int i = lane; i < d; i += 32) x = fmaf(qs[qi * d + i], qs[qi * d + i], x);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
    if (lane == 0) qn_s[qi] = x;
  }
  if (sorted) {
    for (int i = tid; i < QT * l; i += kThreads) run[i] = kPadKey;
  } else {  // fewer seeds than L: the slots past them are padding
    for (int i = tid; i < QT * l; i += kThreads)
      if (q0 + i / l < p.b && i % l >= s) write_slot(p, medoid, q0 + i / l, i % l, kPadKey);
  }
  __syncthreads();
  const float4* qs4 = reinterpret_cast<const float4*>(qs);

  for (int c0 = p0; c0 < p1; c0 += kChunk) {
    const int cn = min(kChunk, p1 - c0);
    if (tid == 0) most = 0;
    // --- score the chunk: a warp RW rows at a time, every query of the tile
    for (int base = warp * RW; base < kChunk; base += kWarps * RW) {
      int mine = -1;  // lane r < RW: the id of row base + r
      if (lane < RW && base + lane < cn) mine = seed_id(p, medoid, c0 + base + lane);
      const float* row[RW];
      bool live[RW];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const int id = __shfl_sync(kFull, mine, r);
        live[r] = base + r < cn;
        // a row not scored reads row 0: every lane's address stays valid
        const long long at = live[r] ? min(max((long long)id, 0LL), p.n - 1) : 0;
        row[r] = p.vectors + at * d;
      }
      float acc[V], vn[RW];
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = 0.f;
#pragma unroll
      for (int r = 0; r < RW; ++r) vn[r] = 0.f;
      for (int c = lane; c < d4; c += 32) {
        float4 v[RW];
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          const float4 w = __ldg(reinterpret_cast<const float4*>(row[r]) + c);
          v[r] = live[r] ? w : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int r = 0; r < RW; ++r)
          vn[r] = fmaf(v[r].x, v[r].x, fmaf(v[r].y, v[r].y, fmaf(v[r].z, v[r].z, fmaf(v[r].w, v[r].w, vn[r]))));
#pragma unroll
        for (int qi = 0; qi < QT; ++qi) {
          const float4 qv = qs4[qi * d4 + c];
#pragma unroll
          for (int r = 0; r < RW; ++r)
            acc[r * QT + qi] = fmaf(qv.x, v[r].x, fmaf(qv.y, v[r].y, fmaf(qv.z, v[r].z, fmaf(qv.w, v[r].w, acc[r * QT + qi]))));
        }
      }
      ReduceScatter<V, 16>::run(acc, lane);
      ReduceScatter<RW, 16>::run(vn, lane);  // lane t holds row t / (32 / RW)'s
#pragma unroll
      for (int i = 0; i < HELD; ++i) {
        const int f = V >= 32 ? lane * HELD + i : lane / SHARE;
        const int r = f / QT, qi = f % QT;
        const float nv = __shfl_sync(kFull, vn[0], r * (32 / RW));
        const int id = __shfl_sync(kFull, mine, r);
        const int j = base + r, pos = c0 + j;
        if (lane % SHARE == 0) {
          unsigned long long key = kPadKey;
          if (j < cn && q0 + qi < p.b) {
            float x = fmaxf(__fsub_rn(__fadd_rn(qn_s[qi], nv), __fmul_rn(2.f, acc[i])), 0.f);
            if (pos > 0 && id == medoid) x = CUDART_INF_F;  // the medoid's repeat
            key = order_key(x, pos);
          }
          ck[qi * kChunk + j] = key;
        }
      }
    }
    __syncthreads();

    if (!sorted) {  // fewer seeds than L: the seeds in position order
      for (int i = tid; i < QT * kChunk; i += kThreads) {
        const int q = q0 + i / kChunk, j = i % kChunk;
        if (q < p.b && j < cn) {
          const float x = key_dist(ck[i]);
          const size_t at = (size_t)q * l + c0 + j;
          const int id = isinf(x) ? -1 : seed_id(p, medoid, c0 + j);
          p.out_ids[at] = id;
          p.out_dists[at] = x;
          p.out_expanded[at] = id == -1;
        }
      }
      __syncthreads();
      continue;
    }

    // --- each query's keys below its current L-th smallest moved to the front
    // of its row (no other can enter its list), sorted, merged in ----------
    for (int qi = warp; qi < QT; qi += kWarps) {
      const unsigned long long thr = run[qi * l + l - 1];
      unsigned long long* row = ck + qi * kChunk;
      unsigned long long k[kChunk / 32];
      bool keep[kChunk / 32];
#pragma unroll
      for (int t = 0; t < kChunk / 32; ++t) {
        k[t] = row[lane + 32 * t];
        keep[t] = k[t] < thr;
      }
      __syncwarp();
      int kept = 0;
#pragma unroll
      for (int t = 0; t < kChunk / 32; ++t) {
        const unsigned m = __ballot_sync(kFull, keep[t]);
        if (keep[t]) row[kept + __popc(m & ((1u << lane) - 1u))] = k[t];
        kept += __popc(m);
      }
      __syncwarp();
      for (int j = kept + lane; j < kChunk; j += 32) row[j] = kPadKey;
      if (lane == 0) atomicMax(&most, kept);
    }
    __syncthreads();
    const int kept = most;
    if (kept == 0) continue;  // nothing of the chunk enters any list
    int log_n = 1;
    while ((1 << log_n) < kept) ++log_n;
    sort_rows(ck, QT, log_n);
    const int m = min(l, kept);
    for (int qi = warp; qi < QT; qi += kWarps)
      merge_lists(run + qi * l, l, ck + qi * kChunk, m, run_next + qi * l, l, lane);
    __syncthreads();
    unsigned long long* t = run; run = run_next; run_next = t;
  }
  if (!sorted) return;

  if (p.ns == 1) {  // one slice: its lists are the seeded lists
    for (int i = tid; i < QT * l; i += kThreads)
      if (q0 + i / l < p.b) write_slot(p, medoid, q0 + i / l, i % l, run[i]);
    return;
  }

  // --- hand this slice's lists over; the tile's last block merges them ------
  for (int i = tid; i < QT * l; i += kThreads)
    p.lists[((size_t)(q0 + i / l) * p.ns + slice) * l + i % l] = run[i];
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(p.tile_done + tile, 1u) == (unsigned)(p.ns - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (tid == 0) p.tile_done[tile] = 0;  // ready for the next launch

  unsigned long long* src0 = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* dst0 = src0 + (size_t)p.group * p.ns * l;
  const int per = p.ns * l;
  for (int g0 = 0; g0 < QT && q0 + g0 < p.b; g0 += p.group) {
    const int gq = min(p.group, min(QT - g0, p.b - q0 - g0));
    unsigned long long* src = src0;
    unsigned long long* dst = dst0;
    const unsigned long long* from = p.lists + (size_t)(q0 + g0) * per;
    for (int i = tid; i < gq * per; i += kThreads) src[i] = __ldcg(from + i);
    __syncthreads();
    // lists 2k and 2k + 1 into list k, a warp a pair, until one is left
    for (int cnt = p.ns; cnt > 1; cnt = (cnt + 1) >> 1) {
      const int half = (cnt + 1) >> 1;
      for (int pair = warp; pair < gq * half; pair += kWarps) {
        const int gi = pair / half, k = 2 * (pair - gi * half);
        const unsigned long long* a = src + ((size_t)gi * cnt + k) * l;
        unsigned long long* out = dst + (size_t)pair * l;
        merge_lists(a, l, a + l, k + 1 < cnt ? l : 0, out, l, lane);
      }
      __syncthreads();
      unsigned long long* t = src; src = dst; dst = t;
    }
    for (int i = tid; i < gq * l; i += kThreads)
      write_slot(p, medoid, q0 + g0 + i / l, i % l, src[i]);
    __syncthreads();
  }
}

template <int QT>
cudaError_t launch_tile(const Params& p, int tiles, cudaStream_t stream) {
  const Layout<QT> lay(p.d, p.l, p.ns, p.group);
  if (lay.bytes > kTileBytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        beam_seed_kernel<QT>, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.bytes);
    if (err != cudaSuccess) return err;
  }
  beam_seed_kernel<QT><<<dim3(tiles, p.ns), kThreads, lay.bytes, stream>>>(p);
  return cudaGetLastError();
}

// The scoring state of a tile of qt queries (qt 1, 2, 4, 8 or 16) at D, L,
// or -1 for another qt: the host's plan keeps it within kTileBytes.
int tile_bytes(int qt, int d, int l) {
  switch (qt) {
    case 1: return Layout<1>(d, l, 1, 1).tile_bytes;
    case 2: return Layout<2>(d, l, 1, 1).tile_bytes;
    case 4: return Layout<4>(d, l, 1, 1).tile_bytes;
    case 8: return Layout<8>(d, l, 1, 1).tile_bytes;
    case 16: return Layout<16>(d, l, 1, 1).tile_bytes;
    default: return -1;
  }
}

}  // namespace

extern "C" {

// vectors [n, d] f32 (16-byte aligned), queries [b, d] f32, the medoid at
// medoid_ptr (int32 on the device) or, where that is null, `medoid`;
// entry_points [s - 1] int32 (null when s == 1); qt queries a tile, ns seed
// slices (ops/traverse.py::seed_plan); lists [ceil(b / qt) * qt, ns, l]
// uint64 and tile_done [ceil(b / qt)] uint32, zero, when ns > 1; out_ids
// [b, l] int32, out_dists [b, l] f32, out_expanded [b, l] uint8; zero: an
// int32 set to 0, or null. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for shapes outside the kernel's limits.
int beam_seed_launch(const void* vectors, const void* queries, const void* medoid_ptr,
                     int medoid, const void* entry_points, long long n, int b, int d, int s,
                     int l, int qt, int ns, void* lists, void* tile_done, void* out_ids,
                     void* out_dists, void* out_expanded, void* zero, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n <= 0 || d <= 0 || d % 4 || d > kMaxDim || l <= 0 || l > kMaxWidth || s <= 0 ||
      (s > 1 && !entry_points) || ns <= 0 || (s < l && ns != 1) || b < 0 ||
      (ns > 1 && (ns * l > kMergeKeys || !lists || !tile_done)) ||
      reinterpret_cast<uintptr_t>(vectors) % 16)
    return cudaErrorInvalidValue;
  const int tb = tile_bytes(qt, d, l);
  if (tb < 0 || tb > kTileBytes) return cudaErrorInvalidValue;
  if (b == 0) return cudaSuccess;
  const int sl = (s + ns - 1) / ns;
  // queries a merge pass: as many as the scoring state's room holds, at least one
  int group = tb / (16 * ns * l);
  group = group < 1 ? 1 : group > qt ? qt : group;
  const Params p{static_cast<const float*>(vectors), static_cast<const float*>(queries),
                 static_cast<const int*>(medoid_ptr), static_cast<const int*>(entry_points),
                 n, medoid, b, d, s, l, ns, sl, group,
                 static_cast<unsigned long long*>(lists), static_cast<unsigned*>(tile_done),
                 static_cast<int*>(out_ids), static_cast<float*>(out_dists),
                 static_cast<uint8_t*>(out_expanded), static_cast<int*>(zero)};
  const int tiles = (b + qt - 1) / qt;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (qt) {
    case 1: return launch_tile<1>(p, tiles, st);
    case 2: return launch_tile<2>(p, tiles, st);
    case 4: return launch_tile<4>(p, tiles, st);
    case 8: return launch_tile<8>(p, tiles, st);
    default: return launch_tile<16>(p, tiles, st);
  }
}

}  // extern "C"
