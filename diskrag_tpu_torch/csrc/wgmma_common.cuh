// Hopper building blocks for scans on the tensor cores through wgmma:
// mbarriers, TMA tile loads, the shared-memory matrix descriptor of a
// 128-byte-swizzled K-major tile, the m64n64k32 s8 and m64n64k16 bf16
// products and their accumulator layout, a consumer's view of a ring of
// stages, and the host-side TMA descriptors. Used by B1 (flat_scan.cu, int8
// and bf16), by the partial kernel of B2 / B3 and M1 (packed_wgmma.cuh,
// mm_probe.cu) and by B6's (pingpong_wgmma.cuh).
//
// Tiles. An operand tile is R rows (64 queries or 64 database rows) of 128
// bytes of K, loaded by one 2-D TMA box {128 bytes, R rows} with
// CU_TENSOR_MAP_SWIZZLE_128B into a 1024-byte-aligned buffer: row r at r *
// 128, its 16-byte chunks permuted by r % 8. The wgmma descriptor of such a
// tile says "128-byte swizzle, 8-row groups 1024 bytes apart"; the k-step
// kk (32 bytes of K: 32 s8 or 16 bf16 values) starts 32 * kk bytes into it,
// whatever the element type. K past a row's end is zero-filled by TMA's
// out-of-bounds fill, as are rows past the tensor's end.
//
// Accumulators of wgmma m64nNk32 s8 (s32) and m64nNk16 bf16 (f32): thread t
// of the warpgroup holds
// d[4c + 2h + j] = D[16 * (t / 32) + (t % 32) / 4 + 8h][8c + 2 * (t % 4) + j]
// for c < N / 8 and h, j in {0, 1}.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wg {

constexpr int kBoxK = 128;                 // bytes of K per tile
constexpr int kTileRows = 64;              // rows per tile (wgmma M, and our N)
constexpr int kTileBytes = kBoxK * kTileRows;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Orders this thread's earlier generic-proxy accesses to shared memory
// before later async-proxy ones (TMA): needed before handing back a stage
// whose contents were read with plain loads, or a refill can land first.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t ok = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!ok);
}

// A consumer's view of a ring of kStages stages: the stage and parity of
// the next tile to multiply, and the stage of the next tile to hand back.
template <int kStages>
struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  int release = 0;
  __device__ void next() {
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// --- TMA ------------------------------------------------------------------

// One 2-D box of `map` at (c0 bytes of K, c1 rows) into `dst`; completion
// (its bytes) is reported to `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// --- wgmma ----------------------------------------------------------------

// Descriptor of a 128-byte-swizzled K-major tile at `tile` (1024-aligned).
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFFu) >> 4)          // start address
         | (uint64_t(1) << 16)             // leading byte offset (unused here)
         | (uint64_t(1024 >> 4) << 32)     // stride byte offset: 8 rows
         | (uint64_t(1) << 62);            // 128-byte swizzle
}

// The descriptor of k-step kk (32 bytes of K) inside the tile.
__device__ __forceinline__ uint64_t desc_k(uint64_t desc, int kk) {
  return desc + uint64_t((32 * kk) >> 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (+)= A[64 x 32] . B[64 x 32]^T, both K-major in shared memory, s8 x s8
// -> s32 (wrapping). scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n64k32_s8(int (&d)[32], uint64_t da,
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]),
        "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),
        "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]),
        "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (+)= A[64 x 32] . B[64 x 32]^T with A in registers: each warp of the
// warpgroup holds rows [16w, 16w + 16), thread (g, t4) = (lane / 4, lane % 4)
// a[0] = A[g][4t4, +4), a[1] = A[g + 8][4t4, +4), a[2] = A[g][16 + 4t4, +4),
// a[3] = A[g + 8][16 + 4t4, +4) (four s8 a register, low byte first); B
// K-major in shared memory. s8 x s8 -> s32 (wrapping); scale_d = 0
// overwrites d.
__device__ __forceinline__ void wgmma_m64n64k32_s8_rs(int (&d)[32], const uint32_t (&a)[4],
                                                      uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]),
        "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),
        "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]),
        "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d (+)= A[64 x 16] . B[64 x 16]^T, both bf16 K-major in shared memory,
// f32 accumulators (the tensor cores' own order of adds). scale_d = 0
// overwrites d.
__device__ __forceinline__ void wgmma_m64n64k16_bf16(float (&d)[32], uint64_t da,
                                                     uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// One 64 x 64 output tile over one 128-byte K box: four k-steps, s8 into
// s32 accumulators or bf16 into f32 ones.
__device__ __forceinline__ void wgmma_tile(int (&d)[32], const void* a, const void* b,
                                           bool accumulate) {
  const uint64_t da = sw128_desc(a), db = sw128_desc(b);
#pragma unroll
  for (int kk = 0; kk < kBoxK / 32; ++kk)
    wgmma_m64n64k32_s8(d, desc_k(da, kk), desc_k(db, kk), (accumulate || kk) ? 1 : 0);
}
__device__ __forceinline__ void wgmma_tile(float (&d)[32], const void* a, const void* b,
                                           bool accumulate) {
  const uint64_t da = sw128_desc(a), db = sw128_desc(b);
#pragma unroll
  for (int kk = 0; kk < kBoxK / 32; ++kk)
    wgmma_m64n64k16_bf16(d, desc_k(da, kk), desc_k(db, kk), (accumulate || kk) ? 1 : 0);
}

// --- host: TMA descriptors -------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)p;
  }
  return fn;
}

// The map of a [rows, row_bytes] uint8 matrix (row_bytes % 16 == 0, base
// 16-byte aligned) in boxes of {kBoxK bytes, kTileRows rows}, 128-byte
// swizzle, zero fill outside. Returns false if the CUDA driver refuses it.
inline bool make_row_map(CUtensorMap* map, const void* base, long long rows,
                         int row_bytes) {
  EncodeTiledFn fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)row_bytes, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)kBoxK, (cuuint32_t)kTileRows};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
            strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The map of the first `n_norm_rows` (1 or 2) rows of an [R, n_rows] f32
// block whose rows lie `stride` floats apart (a multiple of 4, base 16-byte
// aligned), in boxes of {kTileRows, n_norm_rows}: a tile's row 0, then its
// row 1. Columns at or past n_rows read as NaN. With one row the stride is
// never followed, so a [n_rows] vector is its own one-row block.
inline bool make_norm_map(CUtensorMap* map, const void* base, long long n_rows,
                          long long stride, int n_norm_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)n_rows, (cuuint64_t)n_norm_rows};
  const cuuint64_t strides[1] = {(cuuint64_t)stride * 4};
  const cuuint32_t box[2] = {(cuuint32_t)kTileRows, (cuuint32_t)n_norm_rows};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dims,
            strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_NONE,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NAN_REQUEST_ZERO_FMA) == CUDA_SUCCESS;
}

// The map of a vector of n int32 values (base 16-byte aligned) as a [1, n]
// matrix in boxes of {kTileRows, 1}. Columns at or past n read as zero.
inline bool make_vec_map(CUtensorMap* map, const void* base, long long n) {
  EncodeTiledFn fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)n, 1};
  const cuuint64_t strides[1] = {(cuuint64_t)((n * 4 + 15) / 16 * 16)};
  const cuuint32_t box[2] = {(cuuint32_t)kTileRows, 1};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_INT32, 2, const_cast<void*>(base), dims, strides,
            box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace wg
