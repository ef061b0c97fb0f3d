// G1: the exact graph traversal's rounds, after seeding, in one launch.
//
// One block a query. The block keeps the query, its candidate list (L ids,
// distances, expanded flags), its visited log (max_steps * E ids and
// distances) and the round's E x R neighbour scratch in shared memory and
// runs every round itself; a query stops at the first round with nothing
// left to expand (or at max_steps), and the number of rounds of the batch
// is the largest of its queries' (atomicMax), which is what the batch loop
// of diskrag_tpu_torch/graph/search.py::_plain_rounds counts: a query with
// no active selection never changes state there.
//
// Replaces no TPU kernel: it is the port's counterpart of the JAX package's
// lax.while_loop in diskrag_tpu/graph/search.py::_frontier_search, which
// XLA compiles into one device loop. Run one small PyTorch op at a time,
// a round was some 73 launches and a host wait on "is any query active?";
// on the H100 the host's dispatch was 95% of a one-query search.
//
// Each round, in the plain loop's order and with its tie rules (a stable
// sort everywhere: the lower position first among equal distances):
//   1. select the E closest unexpanded candidates; none left: stop;
//   2. mark them expanded and log them at visited slots step*E .. step*E+E-1;
//   3. load their E adjacency rows;
//   4. score each valid neighbour not on the beam, a warp a row (float4
//      loads, several rows' loads in flight, shuffle reduce), with
//      _gathered_distance's formula in f32: max(qn + vn - 2 q.v, 0);
//      the rest score +inf;
//   5. cut the E x R fresh candidates to the L' = min(L, E x R) smallest;
//   6. drop the cut's entries that are +inf, in the visited log or an
//      earlier entry of the cut;
//   7. merge [L + L'] into the top L.
// The candidate list stays sorted by (distance, position), so step 1 takes
// the first E unexpanded slots and step 7 is a merge by ranks (binary
// search). The seeded list, unsorted when there are fewer seeds than L, is
// sorted stably once before the first round: the same entries then come
// out of every selection and merge in the same order.
//
// What bounds it on the H100: latency, not bytes. A round reads E adjacency
// rows and at most E x R vectors (48 rows of 512 bytes at the exact cell's
// shape), two dependent trips to HBM, then sorts and merges a few hundred
// keys in shared memory between barriers. So every intermediate stays in
// shared memory, the rows of a round are scored by all warps at once with
// their loads issued together, and neighbours already on the beam are not
// loaded at all.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsInFlight = 4;  // rows a warp loads before it reduces any
constexpr unsigned long long kPadKey = ~0ull;

// the kernel's limits, also checked by the wrapper (ops/traverse.py)
constexpr int kMaxDim = 2048;
constexpr int kMaxWidth = 256;  // L; must not exceed kThreads (one thread a cut slot)
constexpr int kMaxFresh = 1024;  // E x R
constexpr int kMaxVisited = 1024;  // max_steps x E

struct Params {
  const float* vectors;        // [n, d]
  const int* adjacency;        // [n, r]
  const float* queries;        // [b, d]
  const int* seed_ids;         // [b, l]
  const float* seed_dists;     // [b, l]
  const uint8_t* seed_expanded;  // [b, l]
  long long n;
  int d, r, l, e, max_steps, n2;  // n2: keys sorted a round, a power of two >= max(E x R, L)
  int* out_ids;                // [b, l]
  float* out_dists;            // [b, l]
  int* visited_ids;            // [b, max_steps * e]
  float* visited_dists;        // [b, max_steps * e]
  int* n_expanded;             // [b]
  int* n_steps;                // [], zero on entry
};

// Byte offsets of the block's shared arrays (the host sizes the launch with
// the same function): the 8-byte keys first, the flags last.
struct Layout {
  int keys, q, cd0, cd1, ci0, ci1, vis_i, vis_d, nbr, cut_i, fresh_i, fresh_d, sel, scal, ce0,
      ce1, bytes;
  __host__ __device__ Layout(int d, int r, int l, int e, int max_steps, int n2) {
    const int er = e * r, lp = l < er ? l : er, vcap = max_steps * e;
    int o = 0;
    keys = o;    o += 8 * n2;
    q = o;       o += 4 * d;
    cd0 = o;     o += 4 * l;
    cd1 = o;     o += 4 * l;
    ci0 = o;     o += 4 * l;
    ci1 = o;     o += 4 * l;
    vis_i = o;   o += 4 * vcap;
    vis_d = o;   o += 4 * vcap;
    nbr = o;     o += 4 * er;
    cut_i = o;   o += 4 * lp;
    fresh_i = o; o += 4 * lp;
    fresh_d = o; o += 4 * lp;
    sel = o;     o += 4 * e;
    scal = o;    o += 4 * (1 + kWarps);
    ce0 = o;     o += l;
    ce1 = o;     o += l;
    bytes = o;  // at most 37,412 within the limits: under the 48 KB a block gets unasked
  }
};

// A distance as an unsigned key of the same order (-0 folded into +0).
__device__ __forceinline__ unsigned long long order_key(float x, int pos) {
  uint32_t u = x == 0.f ? 0u : __float_as_uint(x);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (uint32_t)pos;
}

__device__ __forceinline__ float key_dist(unsigned long long k) {
  const uint32_t u = (uint32_t)(k >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// Ascending bitonic sort of n (a power of two) keys, by the whole block.
__device__ void bitonic_sort(unsigned long long* k, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < (n >> 1); t += kThreads) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const unsigned long long a = k[i], b = k[j];
        if ((a > b) == ((i & size) == 0)) {
          k[i] = b;
          k[j] = a;
        }
      }
      __syncthreads();
    }
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__global__ void __launch_bounds__(kThreads) beam_traverse_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d = p.d, r = p.r, l = p.l, e = p.e, n2 = p.n2;
  const int er = e * r, lp = l < er ? l : er, vcap = p.max_steps * e;
  const Layout lay(d, r, l, e, p.max_steps, n2);
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem + lay.keys);
  float* q = reinterpret_cast<float*>(smem + lay.q);
  float* cd = reinterpret_cast<float*>(smem + lay.cd0);
  float* cd_next = reinterpret_cast<float*>(smem + lay.cd1);
  int* ci = reinterpret_cast<int*>(smem + lay.ci0);
  int* ci_next = reinterpret_cast<int*>(smem + lay.ci1);
  uint8_t* ce = smem + lay.ce0;
  uint8_t* ce_next = smem + lay.ce1;
  int* vis_i = reinterpret_cast<int*>(smem + lay.vis_i);
  float* vis_d = reinterpret_cast<float*>(smem + lay.vis_d);
  int* nbr = reinterpret_cast<int*>(smem + lay.nbr);
  int* cut_i = reinterpret_cast<int*>(smem + lay.cut_i);
  int* fresh_i = reinterpret_cast<int*>(smem + lay.fresh_i);
  float* fresh_d = reinterpret_cast<float*>(smem + lay.fresh_d);
  int* sel = reinterpret_cast<int*>(smem + lay.sel);
  int* scal = reinterpret_cast<int*>(smem + lay.scal);  // [0] selected, [1 + w] kept by warp w

  const size_t qb = blockIdx.x;
  const float inf = CUDART_INF_F;

  // --- the query, the visited log, and the seeded list sorted stably -------
  for (int i = tid; i < d; i += kThreads) q[i] = p.queries[qb * d + i];
  for (int i = tid; i < vcap; i += kThreads) {
    vis_i[i] = -1;
    vis_d[i] = inf;
  }
  for (int i = tid; i < n2; i += kThreads) {
    if (i < l) {
      const float x = p.seed_dists[qb * l + i];
      const int id = p.seed_ids[qb * l + i];
      keys[i] = order_key(x, i);
      cd_next[i] = x;
      ci_next[i] = id;
      ce_next[i] = p.seed_expanded[qb * l + i] || id < 0;
    } else {
      keys[i] = kPadKey;
    }
  }
  __syncthreads();
  bitonic_sort(keys, n2);
  for (int i = tid; i < l; i += kThreads) {
    const int s = (int)(keys[i] & 0xffffffffu);
    cd[i] = cd_next[s];
    ci[i] = ci_next[s];
    ce[i] = ce_next[s];
  }
  float qn = 0.f;  // every warp holds the query's squared norm
  for (int i = lane; i < d; i += 32) qn = fmaf(q[i], q[i], qn);
  qn = warp_sum(qn);
  __syncthreads();

  int step = 0, n_exp = 0;
  for (; step < p.max_steps; ++step) {
    // 1. the first E unexpanded slots (the list is sorted)
    if (warp == 0) {
      int found = 0;
      for (int base = 0; base < l && found < e; base += 32) {
        const int s = base + lane;
        const bool ok = s < l && !ce[s] && ci[s] >= 0 && cd[s] < inf;
        const unsigned m = __ballot_sync(0xffffffffu, ok);
        const int at = found + __popc(m & ((1u << lane) - 1u));
        if (ok && at < e) sel[at] = s;
        found += __popc(m);
      }
      if (lane == 0) scal[0] = found < e ? found : e;
    }
    __syncthreads();
    const int na = scal[0];
    if (na == 0) break;
    n_exp += na;

    // 2-3. mark and log the selected, then load their adjacency rows
    for (int j = tid; j < na; j += kThreads) {
      const int s = sel[j];
      ce[s] = 1;
      vis_i[step * e + j] = ci[s];
      vis_d[step * e + j] = cd[s];
    }
    for (int i = tid; i < er; i += kThreads) {
      const int j = i / r;
      int id = -1;
      if (j < na) {
        const long long src = min(max((long long)ci[sel[j]], 0LL), p.n - 1);
        id = __ldg(p.adjacency + src * r + (i - j * r));
      }
      nbr[i] = id;
    }
    __syncthreads();

    // 4. score the neighbours: a warp a row, kRowsInFlight rows at once
    for (int base = warp; base < er; base += kWarps * kRowsInFlight) {
      int id[kRowsInFlight];
      bool live[kRowsInFlight];
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u) {
        const int i = base + u * kWarps;
        id[u] = i < er ? nbr[i] : -1;
        bool on_beam = false;
        if (id[u] >= 0)
          for (int s = lane; s < l; s += 32) on_beam |= ci[s] == id[u];
        live[u] = id[u] >= 0 && !__any_sync(0xffffffffu, on_beam);
      }
      float dot[kRowsInFlight], vn[kRowsInFlight];
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u) dot[u] = vn[u] = 0.f;
      for (int c = lane * 4; c < d; c += 128) {
        const float4 qv = *reinterpret_cast<const float4*>(q + c);
        float4 v[kRowsInFlight];
#pragma unroll
        for (int u = 0; u < kRowsInFlight; ++u) {
          // a row not scored reads row 0: every lane's address stays valid
          const long long row = live[u] ? min((long long)id[u], p.n - 1) : 0;
          const float4 w = __ldg(reinterpret_cast<const float4*>(p.vectors + row * d + c));
          v[u] = live[u] ? w : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < kRowsInFlight; ++u) {
          dot[u] = fmaf(qv.x, v[u].x, fmaf(qv.y, v[u].y, fmaf(qv.z, v[u].z, fmaf(qv.w, v[u].w, dot[u]))));
          vn[u] = fmaf(v[u].x, v[u].x, fmaf(v[u].y, v[u].y, fmaf(v[u].z, v[u].z, fmaf(v[u].w, v[u].w, vn[u]))));
        }
      }
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u) {
        const float qv = warp_sum(dot[u]), nv = warp_sum(vn[u]);
        const int i = base + u * kWarps;
        if (lane == 0 && i < er) {
          const float x = live[u] ? fmaxf(__fsub_rn(__fadd_rn(qn, nv), __fmul_rn(2.f, qv)), 0.f) : inf;
          keys[i] = order_key(x, i);
        }
      }
    }
    for (int i = er + tid; i < n2; i += kThreads) keys[i] = kPadKey;
    __syncthreads();

    // 5. the cut: the L' smallest (distance, position)
    bitonic_sort(keys, n2);
    for (int i = tid; i < lp; i += kThreads) {
      const unsigned long long k = keys[i];
      cut_i[i] = key_dist(k) < inf ? nbr[(int)(k & 0xffffffffu)] : -1;
    }
    __syncthreads();

    // 6. drop what is in the visited log or repeats an earlier entry; compact
    bool keep = false;
    int id = -1;
    float x = inf;
    if (tid < lp) {
      id = cut_i[tid];
      x = key_dist(keys[tid]);
      keep = id >= 0;
      const int logged = step * e + na;
      for (int v = 0; keep && v < logged; ++v) keep = vis_i[v] != id;
      for (int j = 0; keep && j < tid; ++j) keep = cut_i[j] != id;
    }
    const unsigned m = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) scal[1 + warp] = __popc(m);
    __syncthreads();
    int nf = 0, off = 0;
    for (int w = 0; w < kWarps; ++w) {
      nf += scal[1 + w];
      off += w < warp ? scal[1 + w] : 0;
    }
    if (keep) {
      const int at = off + __popc(m & ((1u << lane) - 1u));
      fresh_i[at] = id;
      fresh_d[at] = x;
    }
    __syncthreads();

    // 7. merge [L + nf] into the top L by ranks: the beam first among equals
    for (int i = tid; i < l; i += kThreads) {
      const float a = cd[i];
      int lo = 0, hi = nf;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (fresh_d[mid] < a) lo = mid + 1; else hi = mid;
      }
      const int rank = i + lo;
      if (rank < l) {
        cd_next[rank] = a;
        ci_next[rank] = ci[i];
        ce_next[rank] = ce[i] || ci[i] < 0;
      }
    }
    for (int j = tid; j < nf; j += kThreads) {
      const float b = fresh_d[j];
      int lo = 0, hi = l;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (cd[mid] <= b) lo = mid + 1; else hi = mid;
      }
      const int rank = j + lo;
      if (rank < l) {
        cd_next[rank] = b;
        ci_next[rank] = fresh_i[j];
        ce_next[rank] = 0;
      }
    }
    __syncthreads();
    float* tf = cd; cd = cd_next; cd_next = tf;
    int* ti = ci; ci = ci_next; ci_next = ti;
    uint8_t* te = ce; ce = ce_next; ce_next = te;
  }

  // --- the results ---------------------------------------------------------
  for (int i = tid; i < l; i += kThreads) {
    p.out_ids[qb * l + i] = ci[i];
    p.out_dists[qb * l + i] = cd[i];
  }
  for (int i = tid; i < vcap; i += kThreads) {
    p.visited_ids[qb * vcap + i] = vis_i[i];
    p.visited_dists[qb * vcap + i] = vis_d[i];
  }
  if (tid == 0) {
    p.n_expanded[qb] = n_exp;
    atomicMax(p.n_steps, step);
  }
}

}  // namespace

extern "C" {

// vectors [n, d] f32, adjacency [n, r] int32, queries [b, d] f32, the seeded
// list seed_ids [b, l] int32, seed_dists [b, l] f32, seed_expanded [b, l]
// uint8; out_ids [b, l] int32, out_dists [b, l] f32, visited_ids /
// visited_dists [b, max_steps * e], n_expanded [b] int32, n_steps [] int32
// (zero on entry). Returns cudaGetLastError(), or cudaErrorInvalidValue for
// shapes outside the kernel's limits.
int beam_traverse_launch(const void* vectors, const void* adjacency, const void* queries,
                         const void* seed_ids, const void* seed_dists, const void* seed_expanded,
                         long long n, int b, int d, int r, int l, int e, int max_steps,
                         void* out_ids, void* out_dists, void* visited_ids, void* visited_dists,
                         void* n_expanded, void* n_steps, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n <= 0 || d <= 0 || d % 4 || d > kMaxDim || r <= 0 || l <= 0 || l > kMaxWidth ||
      e <= 0 || e > l || e * r > kMaxFresh || max_steps <= 0 || max_steps * e > kMaxVisited ||
      reinterpret_cast<uintptr_t>(vectors) % 16)
    return cudaErrorInvalidValue;
  if (b <= 0) return cudaSuccess;
  int n2 = 2;
  while (n2 < e * r || n2 < l) n2 <<= 1;
  const Layout lay(d, r, l, e, max_steps, n2);
  const Params p{static_cast<const float*>(vectors), static_cast<const int*>(adjacency),
                 static_cast<const float*>(queries), static_cast<const int*>(seed_ids),
                 static_cast<const float*>(seed_dists), static_cast<const uint8_t*>(seed_expanded),
                 n, d, r, l, e, max_steps, n2,
                 static_cast<int*>(out_ids), static_cast<float*>(out_dists),
                 static_cast<int*>(visited_ids), static_cast<float*>(visited_dists),
                 static_cast<int*>(n_expanded), static_cast<int*>(n_steps)};
  beam_traverse_kernel<<<b, kThreads, lay.bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

}  // extern "C"
