// B5: gathered ADC lookup, out[b, c] = sum_{j<m} T[b, j, code[b, c, j]].
//
// Replaces the TPU kernel diskrag_tpu/ops/pq_scan.py::_adc_kernel (reached
// through adc_lookup_gathered_pallas). The TPU kernel turns the lookup into
// a one-hot compare, multiply and lane sum because gathers lower badly
// there; here the same sum is an indexed read of shared memory.
//
// What bounds it on the H100: bytes. Per query the table is m KB (f32
// [m, 256]) and per candidate there are m code bytes in and 4 bytes out;
// there are m adds per candidate and no products. At the graph search's
// shapes (hundreds of queries, tens to hundreds of candidates each) the
// tables dominate the traffic.
//
// Design. One block per (query, tile of kThreads candidates). The block
// copies the query's table into shared memory once (16-byte loads), then
// each thread owns one candidate and adds smem[j * 256 + code[j]] for
// j = 0 .. m-1 in that order, in f32, one rounding per add: the order of
// the TPU kernel's loop over subspaces, so the result is bit-identical to
// the plain version (and to the TPU kernel on finite tables). Codes are
// read as 32-bit words when m is a multiple of 4 and the array is 4-byte
// aligned, else byte by byte. Ragged B and C are bound-checked, not padded.
// Tables above 48 KB (m > 48) need the opt-in dynamic shared-memory limit;
// above 227 KB (m > 227) the launcher refuses.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCentroids = 256;
constexpr size_t kMaxSmem = 227 * 1024;

__global__ void __launch_bounds__(kThreads)
    adc_lookup_kernel(const float* __restrict__ tables,
                      const uint8_t* __restrict__ codes, int c, int m,
                      int words, float* __restrict__ out) {
  extern __shared__ __align__(16) float t[];
  const int b = blockIdx.x;
  const int n_tab = m * kCentroids;  // a multiple of 4 floats
  const float4* src = reinterpret_cast<const float4*>(tables + (size_t)b * n_tab);
  float4* dst = reinterpret_cast<float4*>(t);
  for (int i = threadIdx.x; i < n_tab / 4; i += kThreads) dst[i] = src[i];
  __syncthreads();

  const int cand = blockIdx.y * kThreads + threadIdx.x;
  if (cand >= c) return;
  const uint8_t* row = codes + ((size_t)b * c + cand) * m;
  float acc = 0.0f;
  if (words) {
    const uint32_t* row4 = reinterpret_cast<const uint32_t*>(row);
    for (int w = 0; w < words; ++w) {
      const uint32_t v = row4[w];
      const float* tj = t + (size_t)w * 4 * kCentroids;
      acc = __fadd_rn(acc, tj[v & 0xffu]);
      acc = __fadd_rn(acc, tj[kCentroids + ((v >> 8) & 0xffu)]);
      acc = __fadd_rn(acc, tj[2 * kCentroids + ((v >> 16) & 0xffu)]);
      acc = __fadd_rn(acc, tj[3 * kCentroids + (v >> 24)]);
    }
  } else {
    for (int j = 0; j < m; ++j)
      acc = __fadd_rn(acc, t[j * kCentroids + row[j]]);
  }
  out[(size_t)b * c + cand] = acc;
}

}  // namespace

extern "C" {

int adc_lookup_block_candidates() { return kThreads; }

// tables [b, m, 256] f32 (16-byte aligned), codes [b, c, m] uint8,
// out [b, c] f32. Returns cudaGetLastError(), or cudaErrorInvalidValue for
// a table that does not fit a block's shared memory.
int adc_lookup_launch(const void* tables, const void* codes, int b, int c,
                      int m, void* out, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const size_t smem = (size_t)m * kCentroids * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(adc_lookup_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
  }
  if (b > 0 && c > 0) {
    const int words =
        (m % 4 == 0 && reinterpret_cast<uintptr_t>(codes) % 4 == 0) ? m / 4 : 0;
    const dim3 grid(b, (c + kThreads - 1) / kThreads);
    adc_lookup_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(tables), static_cast<const uint8_t*>(codes), c,
        m, words, static_cast<float*>(out));
  }
  return cudaGetLastError();
}

}  // extern "C"
