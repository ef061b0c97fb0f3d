// G1: the exact graph traversal's rounds, after seeding, in one launch.
//
// One block a query. The block keeps the query, its candidate list (L ids,
// distances, expanded flags), a hash set of its visited ids and the round's
// E x R neighbours in shared memory and runs every round itself; a query
// stops at the first round with nothing left to expand (or at max_steps),
// and the number of rounds of the batch is the largest of its queries'
// (atomicMax), which is what the batch loop of
// diskrag_tpu_torch/graph/search.py::_plain_rounds counts: a query with no
// active selection never changes state there. The visited log goes straight
// to global memory as it grows; nothing reads it back.
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
//   4. score each valid neighbour not on the beam with _gathered_distance's
//      formula in f32: max(qn + vn - 2 q.v, 0); the rest score +inf;
//   5. cut the E x R fresh candidates to the L' = min(L, E x R) smallest;
//   6. drop the cut's entries that are +inf, in the visited log or an
//      earlier entry of the cut;
//   7. merge [L + L'] into the top L (the beam first among equals).
// The candidate list stays sorted by (distance, position), so step 1 takes
// the first E unexpanded slots and step 7 is a merge by ranks. The seeded
// list, unsorted when there are fewer seeds than L, is sorted stably once
// before the first round: the same entries then come out of every
// selection and merge in the same order.
//
// What bounds it on the H100: latency, not bytes. A round reads E adjacency
// rows and at most E x R vectors (48 rows of 512 bytes at the exact cells'
// shape), two dependent trips to HBM, and then orders a few dozen keys. So a
// round is laid out around those two trips:
//   - warp 0 selects by ballot and loads the adjacency rows, its lanes in
//     parallel, straight after the selection (one trip); block barrier 1;
//   - every row's vector loads are issued before any reduction: 8 lanes a
//     row (4 float4 each at D 128), each group of 8 lanes holding its rows'
//     loads in flight together, then a 3-step shuffle reduction; a
//     neighbour already on the beam is neither loaded nor scored (one
//     trip); block barrier 2;
//   - the cut, the dedupe and the merge: where E x R and L are at most 64
//     (the warp path: the exact cells, L 32, E 1, R 48), warp 0 alone,
//     two keys a lane in registers: ranks by counting, the visited check a
//     probe of the shared-memory hash set (constant in the step), repeats
//     by __match_any_sync, the merge by ranks; no block barrier, so a round
//     has two. Wider shapes (the wave build's E 8 x R 64, L up to 256) take
//     the block path: a bitonic sort of the keys by the whole block, the
//     same hash probe, a merge by ranks, with block barriers between.
// The launcher picks the path and the threads from E, R and L alone; the
// wrapper's counter of warp-path launches (ops/traverse.py::traverse_plan)
// reads the same two limits.
//
// Built with -DG1_STAGE_CLOCK (never by default), the kernel also records
// %globaltimer at four points of every round (start, after barrier 1, after
// barrier 2, after the merge) for each query, into the buffer given to
// beam_traverse_stage_buffer: [b, max_steps, 4] nanoseconds.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kRowLanes = 8;   // lanes that score one neighbour row
constexpr int kRowChunk = 4;   // float4 a lane reads of a row a trip: 8 x 4 x 4 = 128 floats
constexpr int kRowsInFlight = 2;  // rows a group of kRowLanes lanes loads at once
constexpr int kRowsAWarp = 32 / kRowLanes * kRowsInFlight;
constexpr int kWarpKeys = 64;  // the warp path's limit on E x R and on L: two keys a lane
constexpr int kAdjBatch = 16;  // adjacency entries a lane of warp 0 has in flight (block path)
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kPadKey = ~0ull;

// the kernel's limits, also checked by the wrapper (ops/traverse.py)
constexpr int kMaxDim = 2048;
constexpr int kMaxWidth = 256;     // L
constexpr int kMaxFresh = 1024;    // E x R
constexpr int kMaxVisited = 1024;  // max_steps x E
constexpr int kMaxSmem = 48 * 1024;  // what a block gets without opting in

struct Params {
  const float* vectors;        // [n, d]
  const int* adjacency;        // [n, r]
  const float* queries;        // [b, d]
  const int* seed_ids;         // [b, l]
  const float* seed_dists;     // [b, l]
  const uint8_t* seed_expanded;  // [b, l]
  long long n;
  int d, r, l, e, max_steps;
  int n2;         // keys a round: a power of two >= max(E x R, L); 64 on the warp path
  int hash_bits;  // the visited set has 2^hash_bits slots, at least twice max_steps x E
  int* out_ids;                // [b, l]
  float* out_dists;            // [b, l]
  int* visited_ids;            // [b, max_steps * e]
  float* visited_dists;        // [b, max_steps * e]
  int* n_expanded;             // [b]
  int* n_steps;                // [], zero on entry
#ifdef G1_STAGE_CLOCK
  unsigned long long* stage_ns;  // [b, max_steps, 4]
#endif
};

// Byte offsets of the block's shared arrays (the launcher sizes the launch
// with the same function): the 8-byte keys first, the flags last.
struct Layout {
  int keys, q, cd0, cd1, ci0, ci1, hash, nbr, cut_d, cut_i, fresh_i, fresh_d, sel, scal, ce0,
      ce1, bytes;
  __host__ __device__ Layout(int d, int r, int l, int e, int n2, int hash_bits) {
    const int er = e * r, lp = l < er ? l : er;
    int o = 0;
    keys = o;    o += 8 * n2;
    q = o;       o += 4 * d;
    cd0 = o;     o += 4 * l;
    cd1 = o;     o += 4 * l;
    ci0 = o;     o += 4 * l;
    ci1 = o;     o += 4 * l;
    hash = o;    o += 4 << hash_bits;
    nbr = o;     o += 4 * er;
    cut_d = o;   o += 4 * lp;
    cut_i = o;   o += 4 * lp;
    fresh_i = o; o += 4 * lp;
    fresh_d = o; o += 4 * lp;
    sel = o;     o += 4 * e;
    scal = o;    o += 4 * (1 + kMaxWarps);
    ce0 = o;     o += l;
    ce1 = o;     o += l;
    bytes = o;  // at most 38,436 within the limits: under the 48 KB a block gets unasked
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
      for (int t = threadIdx.x; t < (n >> 1); t += blockDim.x) {
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

// Ranks of a and b among the warp path's kWarpKeys keys (real keys
// distinct, pads above them): the number of keys below each. Every lane
// reads the same two keys at once, so each read is a broadcast; unrolled,
// the reads are all in flight together.
__device__ __forceinline__ void warp_rank(const unsigned long long* keys, unsigned long long a,
                                          unsigned long long b, int& ra, int& rb) {
  ra = rb = 0;
#pragma unroll
  for (int j = 0; j < kWarpKeys; j += 2) {
    const ulonglong2 k = *reinterpret_cast<const ulonglong2*>(keys + j);
    ra += (k.x < a) + (k.y < a);
    rb += (k.x < b) + (k.y < b);
  }
}

// Entries of a[0, len) below x, or at most x (a sorted ascending, len <= 64).
template <bool kOrEqual>
__device__ __forceinline__ int count_below(const float* a, int len, float x) {
  int pos = 0;
#pragma unroll
  for (int step = 64; step > 0; step >>= 1) {
    if (pos + step <= len) {
      const float v = a[pos + step - 1];
      pos += (kOrEqual ? v <= x : v < x) ? step : 0;
    }
  }
  return pos;
}

// The visited set: open addressing, linear probing, -1 empty. At most half
// full, so a probe ends within a few slots whatever the step.
__device__ __forceinline__ unsigned hash_slot(int id, int bits) {
  return ((unsigned)id * 0x9E3779B1u) >> (32 - bits);
}

__device__ __forceinline__ void visited_insert(int* tab, int bits, int id) {
  const unsigned mask = (1u << bits) - 1u;
  for (unsigned h = hash_slot(id, bits);; h = (h + 1) & mask) {
    const int old = atomicCAS(tab + h, -1, id);
    if (old == -1 || old == id) return;
  }
}

__device__ __forceinline__ bool visited_has(const int* tab, int bits, int id) {
  const unsigned mask = (1u << bits) - 1u;
  for (unsigned h = hash_slot(id, bits);; h = (h + 1) & mask) {
    const int v = tab[h];
    if (v == id) return true;
    if (v == -1) return false;
  }
}

#ifdef G1_STAGE_CLOCK
__device__ __forceinline__ void stamp(const Params& p, int step, int at) {
  if (threadIdx.x == 0 && step < p.max_steps) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    p.stage_ns[((size_t)blockIdx.x * p.max_steps + step) * 4 + at] = t;
  }
}
#define G1_STAMP(step, at) stamp(p, step, at)
#else
#define G1_STAMP(step, at)
#endif

// Step 4: score the round's er neighbour rows into keys[0, er). A group of
// kRowLanes lanes takes a row and kRowsInFlight rows at once, all their loads in
// flight before any sum is reduced; a row not scored reads nothing.
__device__ __forceinline__ void score_rows(const Params& p, const float* q, const int* ci,
                                           const int* nbr, unsigned long long* keys, float qn,
                                           int er) {
  const int tid = threadIdx.x, sub = tid % kRowLanes;
  const int g = tid / kRowLanes, groups = blockDim.x / kRowLanes;
  const unsigned gmask = 0xffu << (tid & 24);  // the group's lanes in its warp
  const int d = p.d, l = p.l;
  const float inf = CUDART_INF_F;
  constexpr int kRows = kRowsInFlight;
  for (int base = 0; base < er; base += groups * kRows) {
    int id[kRows];
    bool live[kRows];
    long long row[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int i = base + g + groups * u;
      id[u] = i < er ? nbr[i] : -1;
      bool on_beam = false;
      for (int s = sub; s < l; s += kRowLanes) on_beam |= ci[s] == id[u];
      const unsigned seen = __ballot_sync(kFull, on_beam) & gmask;  // every lane votes
      live[u] = id[u] >= 0 && !seen;
      row[u] = live[u] ? min((long long)id[u], p.n - 1) : 0;
    }
    float dot[kRows], vn[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) dot[u] = vn[u] = 0.f;
    for (int c0 = 0; c0 < d; c0 += 4 * kRowLanes * kRowChunk) {
      float4 v[kRows][kRowChunk];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
#pragma unroll
        for (int k = 0; k < kRowChunk; ++k) {
          const int c = c0 + 4 * (sub + kRowLanes * k);
          v[u][k] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (live[u] && c < d) v[u][k] = __ldg(reinterpret_cast<const float4*>(p.vectors + row[u] * d + c));
        }
      }
#pragma unroll
      for (int k = 0; k < kRowChunk; ++k) {
        const int c = c0 + 4 * (sub + kRowLanes * k);
        if (c < d) {
          const float4 qv = *reinterpret_cast<const float4*>(q + c);
#pragma unroll
          for (int u = 0; u < kRows; ++u) {
            const float4 w = v[u][k];
            dot[u] = fmaf(qv.x, w.x, fmaf(qv.y, w.y, fmaf(qv.z, w.z, fmaf(qv.w, w.w, dot[u]))));
            vn[u] = fmaf(w.x, w.x, fmaf(w.y, w.y, fmaf(w.z, w.z, fmaf(w.w, w.w, vn[u]))));
          }
        }
      }
    }
#pragma unroll
    for (int o = kRowLanes / 2; o > 0; o >>= 1) {
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        dot[u] += __shfl_xor_sync(kFull, dot[u], o);
        vn[u] += __shfl_xor_sync(kFull, vn[u], o);
      }
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int i = base + g + groups * u;
      if (sub == 0 && i < er) {
        const float x = live[u] ? fmaxf(__fsub_rn(__fadd_rn(qn, vn[u]), __fmul_rn(2.f, dot[u])), 0.f)
                                : inf;
        keys[i] = order_key(x, i);
      }
    }
  }
}

template <bool kWarpPath>
__global__ void __launch_bounds__(kMaxThreads) beam_traverse_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nthreads = blockDim.x;
  const int d = p.d, r = p.r, l = p.l, e = p.e, n2 = p.n2, bits = p.hash_bits;
  const int er = e * r, lp = l < er ? l : er, vcap = p.max_steps * e;
  constexpr int kAdj = kWarpPath ? 2 : kAdjBatch;  // adjacency entries a lane loads at once
  const Layout lay(d, r, l, e, n2, bits);
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem + lay.keys);
  float* q = reinterpret_cast<float*>(smem + lay.q);
  float* cd = reinterpret_cast<float*>(smem + lay.cd0);
  float* cd_next = reinterpret_cast<float*>(smem + lay.cd1);
  int* ci = reinterpret_cast<int*>(smem + lay.ci0);
  int* ci_next = reinterpret_cast<int*>(smem + lay.ci1);
  uint8_t* ce = smem + lay.ce0;
  uint8_t* ce_next = smem + lay.ce1;
  int* hash = reinterpret_cast<int*>(smem + lay.hash);
  int* nbr = reinterpret_cast<int*>(smem + lay.nbr);
  float* cut_d = reinterpret_cast<float*>(smem + lay.cut_d);
  int* cut_i = reinterpret_cast<int*>(smem + lay.cut_i);
  int* fresh_i = reinterpret_cast<int*>(smem + lay.fresh_i);
  float* fresh_d = reinterpret_cast<float*>(smem + lay.fresh_d);
  int* sel = reinterpret_cast<int*>(smem + lay.sel);    // the round's selected ids
  int* scal = reinterpret_cast<int*>(smem + lay.scal);  // [0] selected, [1 + w] kept by warp w

  const size_t qb = blockIdx.x;
  const float inf = CUDART_INF_F;
  const unsigned lt = (1u << lane) - 1u;
  int* log_i = p.visited_ids + qb * vcap;
  float* log_d = p.visited_dists + qb * vcap;

  // --- the query, the visited log and set, and the seeded list sorted stably
  for (int i = tid; i < d; i += nthreads) q[i] = p.queries[qb * d + i];
  for (int i = tid; i < vcap; i += nthreads) {
    log_i[i] = -1;
    log_d[i] = inf;
  }
  for (int i = tid; i < (1 << bits); i += nthreads) hash[i] = -1;
  for (int i = tid; i < n2; i += nthreads) {
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
  if constexpr (kWarpPath) {
    if (warp == 0) {
      int r0, r1;
      warp_rank(keys, keys[lane], keys[lane + 32], r0, r1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int s = lane + 32 * h, to = h ? r1 : r0;
        if (s < l) {
          cd[to] = cd_next[s];
          ci[to] = ci_next[s];
          ce[to] = ce_next[s];
        }
      }
    }
  } else {
    bitonic_sort(keys, n2);
    for (int i = tid; i < l; i += nthreads) {
      const int s = (int)(keys[i] & 0xffffffffu);
      cd[i] = cd_next[s];
      ci[i] = ci_next[s];
      ce[i] = ce_next[s];
    }
  }
  __syncthreads();
  // the keys past the round's E x R read as pads from now on
  for (int i = er + tid; i < n2; i += nthreads) keys[i] = kPadKey;
  float qn = 0.f;  // every lane holds the query's squared norm
  for (int i = lane; i < d; i += 32) qn = fmaf(q[i], q[i], qn);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) qn += __shfl_xor_sync(kFull, qn, o);

  int step = 0, n_exp = 0;
  for (; step < p.max_steps; ++step) {
    G1_STAMP(step, 0);
    // 1-3. warp 0: the first E unexpanded slots (the list is sorted),
    // marked, logged and put in the visited set; their adjacency rows
    if (warp == 0) {
      int found = 0;
      for (int base = 0; base < l && found < e; base += 32) {
        const int s = base + lane;
        const bool ok = s < l && !ce[s] && ci[s] >= 0 && cd[s] < inf;
        const unsigned m = __ballot_sync(kFull, ok);
        const int at = found + __popc(m & lt);
        if (ok && at < e) {
          sel[at] = ci[s];
          ce[s] = 1;
          log_i[step * e + at] = ci[s];
          log_d[step * e + at] = cd[s];
        }
        found += __popc(m);
      }
      const int na = found < e ? found : e;
      __syncwarp();
      for (int i0 = 0; i0 < er; i0 += 32 * kAdj) {
        int a[kAdj];
#pragma unroll
        for (int u = 0; u < kAdj; ++u) {
          const int i = i0 + lane + 32 * u;
          a[u] = -1;
          if (i < er) {
            const int j = i / r;
            if (j < na) {
              const long long src = min(max((long long)sel[j], 0LL), p.n - 1);
              a[u] = __ldg(p.adjacency + src * r + (i - j * r));
            }
          }
        }
        if (i0 == 0)  // while the rows are in flight
          for (int j = lane; j < na; j += 32) visited_insert(hash, bits, sel[j]);
#pragma unroll
        for (int u = 0; u < kAdj; ++u) {
          const int i = i0 + lane + 32 * u;
          if (i < er) nbr[i] = a[u];
        }
      }
      if (lane == 0) scal[0] = na;
    }
    __syncthreads();
    G1_STAMP(step, 1);
    const int na = scal[0];
    if (na == 0) break;
    n_exp += na;

    // 4. score the neighbours
    score_rows(p, q, ci, nbr, keys, qn, er);
    __syncthreads();
    G1_STAMP(step, 2);

    if constexpr (kWarpPath) {
      // 5-7. warp 0 alone: lane t holds positions t and t + 32
      if (warp == 0) {
        const unsigned long long k0 = keys[lane], k1 = keys[lane + 32];
        int r0, r1;
        warp_rank(keys, k0, k1, r0, r1);
        // 5. the cut, in rank order
        if (lane < er && r0 < lp) {
          cut_d[r0] = key_dist(k0);
          cut_i[r0] = nbr[lane];
        }
        if (lane + 32 < er && r1 < lp) {
          cut_d[r1] = key_dist(k1);
          cut_i[r1] = nbr[lane + 32];
        }
        __syncwarp();
        // 6. lane t holds ranks t and t + 32: drop +inf, visited, repeats
        float x0 = inf, x1 = inf;
        int c0 = -1, c1 = -1;
        if (lane < lp) {
          x0 = cut_d[lane];
          c0 = cut_i[lane];
        }
        if (lane + 32 < lp) {
          x1 = cut_d[lane + 32];
          c1 = cut_i[lane + 32];
        }
        const unsigned same0 = __match_any_sync(kFull, c0) & lt;  // every lane takes part
        bool keep0 = x0 < inf && !same0;
        bool keep1 = false;
        if (lp > 32) {
          bool dup1 = __match_any_sync(kFull, c1) & lt;
#pragma unroll 8
          for (int k = 0; k < 32; ++k) dup1 |= __shfl_sync(kFull, c0, k) == c1;
          keep1 = x1 < inf && !dup1;
        }
        if (keep0) keep0 = !visited_has(hash, bits, c0);
        if (keep1) keep1 = !visited_has(hash, bits, c1);
        const unsigned m0 = __ballot_sync(kFull, keep0), m1 = __ballot_sync(kFull, keep1);
        const int nf = __popc(m0) + __popc(m1);
        if (keep0) {
          const int at = __popc(m0 & lt);
          fresh_d[at] = x0;
          fresh_i[at] = c0;
        }
        if (keep1) {
          const int at = __popc(m0) + __popc(m1 & lt);
          fresh_d[at] = x1;
          fresh_i[at] = c1;
        }
        __syncwarp();
        // 7. merge by ranks, in place: the beam first among equals
        float a[2], f[2];
        int ai[2], fi[2], ra[2], rf[2];
        bool ae[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int s = lane + 32 * h;
          a[h] = s < l ? cd[s] : inf;
          ai[h] = s < l ? ci[s] : -1;
          ae[h] = s < l ? ce[s] || ai[h] < 0 : true;
          f[h] = s < nf ? fresh_d[s] : inf;
          fi[h] = s < nf ? fresh_i[s] : -1;
          ra[h] = s + count_below<false>(fresh_d, nf, a[h]);
          rf[h] = s + count_below<true>(cd, l, f[h]);
        }
        __syncwarp();
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int s = lane + 32 * h;
          if (s < l && ra[h] < l) {
            cd[ra[h]] = a[h];
            ci[ra[h]] = ai[h];
            ce[ra[h]] = ae[h];
          }
          if (s < nf && rf[h] < l) {
            cd[rf[h]] = f[h];
            ci[rf[h]] = fi[h];
            ce[rf[h]] = 0;
          }
        }
        __syncwarp();
      }
      G1_STAMP(step, 3);
    } else {
      // 5. the cut: the L' smallest (distance, position)
      bitonic_sort(keys, n2);
      for (int i = tid; i < lp; i += nthreads) {
        const unsigned long long k = keys[i];
        cut_i[i] = key_dist(k) < inf ? nbr[(int)(k & 0xffffffffu)] : -1;
      }
      __syncthreads();

      // 6. drop what is in the visited set or repeats an earlier entry; compact
      bool keep = false;
      int id = -1;
      float x = inf;
      if (tid < lp) {
        id = cut_i[tid];
        x = key_dist(keys[tid]);
        keep = id >= 0 && !visited_has(hash, bits, id);
        for (int j = 0; keep && j < tid; ++j) keep = cut_i[j] != id;
      }
      const unsigned m = __ballot_sync(kFull, keep);
      if (lane == 0) scal[1 + warp] = __popc(m);
      __syncthreads();
      int nf = 0, off = 0;
      for (int w = 0; w < nthreads / 32; ++w) {
        nf += scal[1 + w];
        off += w < warp ? scal[1 + w] : 0;
      }
      if (keep) {
        const int at = off + __popc(m & lt);
        fresh_i[at] = id;
        fresh_d[at] = x;
      }
      __syncthreads();

      // 7. merge [L + nf] into the top L by ranks: the beam first among equals
      for (int i = tid; i < l; i += nthreads) {
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
      for (int j = tid; j < nf; j += nthreads) {
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
      G1_STAMP(step, 3);
      float* tf = cd; cd = cd_next; cd_next = tf;
      int* ti = ci; ci = ci_next; ci_next = ti;
      uint8_t* te = ce; ce = ce_next; ce_next = te;
    }
  }

  // --- the results: on the warp path a query stopped by max_steps leaves
  // warp 0 merging in place past barrier 2, so the block waits for it once
  __syncthreads();
  for (int i = tid; i < l; i += nthreads) {
    p.out_ids[qb * l + i] = ci[i];
    p.out_dists[qb * l + i] = cd[i];
  }
  if (tid == 0) {
    p.n_expanded[qb] = n_exp;
    atomicMax(p.n_steps, step);
  }
}

template <bool kWarpPath>
cudaError_t launch(const Params& p, int b, int threads, int bytes, cudaStream_t stream) {
  beam_traverse_kernel<kWarpPath><<<b, threads, bytes, stream>>>(p);
  return cudaGetLastError();
}

#ifdef G1_STAGE_CLOCK
unsigned long long* g_stage_ns = nullptr;
#endif

}  // namespace

extern "C" {

#ifdef G1_STAGE_CLOCK
// The stage clock's buffer for the launches that follow: [b, max_steps, 4]
// u64 nanoseconds on the device (only in a -DG1_STAGE_CLOCK build).
int beam_traverse_stage_buffer(void* buf) {
  g_stage_ns = static_cast<unsigned long long*>(buf);
  return 0;
}
#endif

// vectors [n, d] f32, adjacency [n, r] int32, queries [b, d] f32, the seeded
// list seed_ids [b, l] int32, seed_dists [b, l] f32, seed_expanded [b, l]
// uint8; out_ids [b, l] int32, out_dists [b, l] f32, visited_ids /
// visited_dists [b, max_steps * e], n_expanded [b] int32, n_steps [] int32
// (zero on entry). Where E x R and L are at most 64 the launch takes the
// warp path (the cut, dedupe and merge by warp 0) with the fewest warps that
// score every row in one pass (kRowsAWarp rows a warp); elsewhere the block
// path, kMaxThreads threads. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for shapes outside the kernel's limits.
int beam_traverse_launch(const void* vectors, const void* adjacency, const void* queries,
                         const void* seed_ids, const void* seed_dists, const void* seed_expanded,
                         long long n, int b, int d, int r, int l, int e, int max_steps,
                         void* out_ids, void* out_dists, void* visited_ids, void* visited_dists,
                         void* n_expanded, void* n_steps, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int er = e * r;
  if (n <= 0 || d <= 0 || d % 4 || d > kMaxDim || r <= 0 || l <= 0 || l > kMaxWidth ||
      e <= 0 || e > l || er > kMaxFresh || max_steps <= 0 || max_steps * e > kMaxVisited ||
      reinterpret_cast<uintptr_t>(vectors) % 16)
    return cudaErrorInvalidValue;
  const bool warp_path = er <= kWarpKeys && l <= kWarpKeys;
  const int threads = warp_path ? 32 * ((er + kRowsAWarp - 1) / kRowsAWarp) : kMaxThreads;
  int n2 = 2;
  while (n2 < er || n2 < l) n2 <<= 1;
  if (warp_path) n2 = kWarpKeys;
  int bits = 1;
  while ((1 << bits) < 2 * max_steps * e) ++bits;
  const Layout lay(d, r, l, e, n2, bits);
  if (lay.bytes > kMaxSmem) return cudaErrorInvalidValue;
  if (b <= 0) return cudaSuccess;
  Params p{static_cast<const float*>(vectors), static_cast<const int*>(adjacency),
           static_cast<const float*>(queries), static_cast<const int*>(seed_ids),
           static_cast<const float*>(seed_dists), static_cast<const uint8_t*>(seed_expanded),
           n, d, r, l, e, max_steps, n2, bits,
           static_cast<int*>(out_ids), static_cast<float*>(out_dists),
           static_cast<int*>(visited_ids), static_cast<float*>(visited_dists),
           static_cast<int*>(n_expanded), static_cast<int*>(n_steps)};
#ifdef G1_STAGE_CLOCK
  p.stage_ns = g_stage_ns;
  if (!p.stage_ns) return cudaErrorInvalidValue;
#endif
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return warp_path ? launch<true>(p, b, threads, lay.bytes, s)
                   : launch<false>(p, b, threads, lay.bytes, s);
}

}  // extern "C"
