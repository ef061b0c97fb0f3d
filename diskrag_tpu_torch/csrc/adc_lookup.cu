// B5: the ADC lookup of the PQ-guided traversal, in two addressing modes.
//
//   gathered  out[b, c] = sum_{j<m} T[b, j, code[b, c, j]]
//             (codes [B, C, m] uint8, gathered by the caller)
//   by id     out[b, c] = (sum_{j<m} T[b, j, ct[id, j]] + cell[b, pc[id]]) + bias[id]
//             id = clamp(ids[b, c], 0, n - 1): the code table ct [n, m] and,
//             for a residual PQ, the point cells pc [n] int32, the point
//             biases bias [n] f32 and the query-cell terms cell [B, n_cells]
//             f32 are read by id, so one launch is a traversal round's whole
//             distance step (without the residual terms, the cell and bias
//             adds are left out).
//
// Replaces the TPU kernel diskrag_tpu/ops/pq_scan.py::_adc_kernel (reached
// through adc_lookup_gathered_pallas), whose contract is the gathered mode.
// The TPU kernel turns the lookup into a one-hot compare, multiply and lane
// sum because gathers lower badly there, and leaves the code gather and the
// residual terms to XLA (diskrag_tpu/graph/search.py::beam_search_pq); on
// this card they are loads, and the by-id mode does them in the kernel.
//
// Both modes add the m entries in subspace order j = 0 .. m-1, in f32, one
// rounding per add (__fadd_rn), then the cell term and then the bias: the
// order of the TPU kernel's loop and of the reference's adds, so the result
// is bit-identical to the plain version.
//
// What bounds it on the H100: bytes, mostly latency. At the engine's shape
// (1000 queries x 24 candidates x m = 16) a call reads 384,000 table
// entries out of 16 MB of tables that sit in the 50 MB L2 (they are built
// once a batch and read every round), so what matters is how many loads are
// in flight. So the tables are read directly, never staged: one thread per
// (query, candidate) pair, several queries to a block; a thread loads its m
// codes (one 16-byte load per 16 subspaces where the rows are aligned),
// issues the addressed table reads 16 at a time (ld.global.nc), then adds
// them in order. A block that first copied its query's whole table into
// shared memory was measured slower at every shape up to 2048 candidates a
// query and level at 4096 (H100 80GB HBM3, 700 W; PERF.md), so it was
// dropped. Ragged B and C are bound-checked, not padded.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCentroids = 256;
constexpr int kChunk = 16;  // subspaces whose table reads are in flight together

enum Mode { kGathered = 0, kById = 1, kByIdResidual = 2 };

// The 16 code bytes j0 .. j0+15 of a row as four words (bytes past m are
// not read): one 16-byte load (kVec 16: m % 16 == 0, rows 16-byte aligned),
// four 4-byte loads (kVec 4: m % 4 == 0, rows 4-byte aligned) or bytes.
template <int kVec>
__device__ __forceinline__ void load_codes(const uint8_t* __restrict__ row, int j0, int m,
                                           uint32_t (&w)[4]) {
  if (kVec == 16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + j0));
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else if (kVec == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = j0 + 4 * i < m ? __ldg(reinterpret_cast<const uint32_t*>(row + j0) + i) : 0u;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t x = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = j0 + 4 * i + k;
        if (j < m) x |= uint32_t(__ldg(row + j)) << (8 * k);
      }
      w[i] = x;
    }
  }
}

// A call's operands (see adc_lookup_launch); ids == nullptr in the
// gathered mode, point_cell == nullptr without the residual terms.
struct Operands {
  const float* tables;
  const uint8_t* codes;
  long long n;
  const long long* ids;
  const int* point_cell;
  const float* point_bias;
  const float* cell_tables;
  int n_cells, b, c, m;
  float* out;
};

// Grid: ceil(B * C / kThreads) blocks over the (query, candidate) pairs in
// row-major order.
template <int kMode, int kVec>
__global__ void __launch_bounds__(kThreads) adc_lookup_kernel(const Operands o) {
  const int c = o.c, m = o.m;
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= (long long)o.b * c) return;
  const int q = (int)(p / c);
  const int cand = (int)(p - (long long)q * c);
  const size_t pair = (size_t)q * c + cand;
  const uint8_t* row;
  long long id = 0;
  if (kMode == kGathered) {
    row = o.codes + pair * m;
  } else {
    id = min(max(__ldg(o.ids + pair), 0LL), o.n - 1);
    row = o.codes + id * m;
  }
  // the residual terms depend on the id only: their loads go out beside the
  // table reads
  float cell = 0.f, bias = 0.f;
  if (kMode == kByIdResidual) {
    cell = __ldg(o.cell_tables + (size_t)q * o.n_cells + __ldg(o.point_cell + id));
    bias = __ldg(o.point_bias + id);
  }
  const float* tab = o.tables + (size_t)q * m * kCentroids;
  float acc = 0.0f;
  for (int j0 = 0; j0 < m; j0 += kChunk) {
    uint32_t w[4];
    load_codes<kVec>(row, j0, m, w);
    float v[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int j = j0 + u;
      const uint32_t code = (w[u >> 2] >> (8 * (u & 3))) & 0xffu;
      const float* e = tab + (size_t)j * kCentroids + code;
      v[u] = j < m ? __ldg(e) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u)
      if (j0 + u < m) acc = __fadd_rn(acc, v[u]);
  }
  if (kMode == kByIdResidual) {
    acc = __fadd_rn(acc, cell);
    acc = __fadd_rn(acc, bias);
  }
  o.out[pair] = acc;
}

template <int kMode>
int launch(int vec, dim3 grid, cudaStream_t st, const Operands& o) {
  auto k = vec == 16 ? adc_lookup_kernel<kMode, 16>
           : vec == 4 ? adc_lookup_kernel<kMode, 4>
                      : adc_lookup_kernel<kMode, 1>;
  k<<<grid, kThreads, 0, st>>>(o);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// tables [b, m, 256] f32, out [b, c] f32.
// ids == NULL: the gathered mode, codes [b, c, m] uint8. Otherwise the
// by-id mode: codes is the code table [n, m] uint8 and ids [b, c] int64;
// with point_cell != NULL also point_cell [n] int32, point_bias [n] f32
// and cell_tables [b, n_cells] f32. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for m <= 0 or an empty code table.
int adc_lookup_launch(const void* tables, const void* codes, long long n, const void* ids,
                      const void* point_cell, const void* point_bias,
                      const void* cell_tables, int n_cells, int b, int c, int m, void* out,
                      int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (m <= 0 || (ids && n <= 0)) return cudaErrorInvalidValue;
  if (b <= 0 || c <= 0) return cudaSuccess;
  // every code row starts at a multiple of m bytes from the base
  const uintptr_t base = reinterpret_cast<uintptr_t>(codes);
  const int vec = (m % 16 == 0 && base % 16 == 0) ? 16 : (m % 4 == 0 && base % 4 == 0) ? 4 : 1;
  const dim3 grid((unsigned)(((long long)b * c + kThreads - 1) / kThreads));
  const Operands o{static_cast<const float*>(tables), static_cast<const uint8_t*>(codes), n,
                   static_cast<const long long*>(ids), static_cast<const int*>(point_cell),
                   static_cast<const float*>(point_bias), static_cast<const float*>(cell_tables),
                   n_cells, b, c, m, static_cast<float*>(out)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!ids) return launch<kGathered>(vec, grid, st, o);
  if (!point_cell) return launch<kById>(vec, grid, st, o);
  return launch<kByIdResidual>(vec, grid, st, o);
}

}  // extern "C"
