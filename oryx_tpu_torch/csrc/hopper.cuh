// Hopper building blocks shared by the phase-A kernels (phase_a.cu,
// phase_a_i8.cu, phase_a_i8_fold.cu, phase_a_fold.cu): cp.async,
// mbarriers, TMA tensor maps and loads, bulk copies, wgmma descriptors and
// fences, the halving-butterfly max, and the host helpers that size a
// persistent grid.  Each source includes it once; nothing here launches
// or allocates.  cuda_build.library_path hashes every header of this
// directory with the source, so an edit here rebuilds every library.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; nothing of libcuda is linked
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__host__ __device__ constexpr int halve(int c) { return c >= 2 ? c / 2 : 1; }

__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ int32_t vmax(int32_t a, int32_t b) {
  return max(a, b);
}

// One step of a halving butterfly over the lanes that differ in bit MASK:
// each lane sends one half of its CNT values, keeps the other half and
// takes the max with what its partner sent, so it ends with CNT / 2
// values reduced over both lanes; `base` counts the values the lane gave
// up below its half.  With one value left it is a plain xor-max.
template <int CNT, int MASK, typename T>
__device__ __forceinline__ void bfly(T* v, int lane, int& base) {
  if constexpr (CNT >= 2) {
    constexpr int H = CNT / 2;
    const bool hi = (lane & MASK) != 0;
#pragma unroll
    for (int k = 0; k < H; ++k) {
      const T send = hi ? v[k] : v[k + H];
      const T keep = hi ? v[k + H] : v[k];
      v[k] = vmax(keep, __shfl_xor_sync(0xffffffffu, send, MASK));
    }
    if (hi) base += H;
  } else {
    v[0] = vmax(v[0], __shfl_xor_sync(0xffffffffu, v[0], MASK));
  }
}

// lane bits of a butterfly over masks 16..1 (LAST = the smallest mask)
// at which no halving took place: those lanes hold copies
__host__ __device__ constexpr int dup_bits(int cnt, int mask, int last) {
  return mask < last ? 0
      : (cnt >= 2 ? 0 : mask) | dup_bits(halve(cnt), mask / 2, last);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

namespace tc {

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}
// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(col), "r"(row)
      : "memory");
}

// a plain copy of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) from device to shared memory, counted on `bar` like a TMA load
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Shared-memory matrix descriptor of a K-major operand as TMA stored it
// with an RB-byte swizzle (RB = 128, 64 or 32): rows of RB bytes, 8-row
// groups 8 * RB bytes apart (the stride byte offset); the leading byte
// offset is unused for a swizzled K-major operand.  Layout type 1 is the
// 128-byte swizzle, 2 the 64-byte one, 3 the 32-byte one.  One wgmma
// K step (32 bytes: 16 bf16 or 32 int8) advances the start by 2.
template <int RB>
__device__ __forceinline__ uint64_t desc(const void* p) {
  static_assert(RB == 128 || RB == 64 || RB == 32, "swizzle width");
  constexpr uint64_t layout = RB == 128 ? 1 : RB == 64 ? 2 : 3;
  constexpr uint64_t sbo = (8 * RB) >> 4;
  const uint64_t start = (smem_u32(p) & 0x3FFFF) >> 4;
  return start | (1ull << 16) | (sbo << 32) | (layout << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

}  // namespace tc

// ---------------------------------------------------------------------------
// host side

inline int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

// at most the dynamic shared memory a thread block may have on sm_90
constexpr int SMEM_LIMIT = 232448;

// thread blocks of `kernel` that fit the card at once, at most `work`
template <typename K>
int grid_for(K kernel, int threads, size_t smem, int work) {
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                smem);
  const long want = (long)(per_sm > 0 ? per_sm : 1) * sm_count();
  return (int)(want < work ? want : work);
}

// lets `kernel` take up to SMEM_LIMIT bytes of dynamic shared memory;
// `done` is a static of the caller's, one per kernel instantiation
template <typename K>
int set_smem(K kernel, bool& done) {
  if (!done) {
    if (cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_LIMIT) != cudaSuccess)
      return (int)cudaGetLastError();
    done = true;
  }
  return 0;
}

typedef CUresult (*EncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library links no libcuda
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (rc == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 2-D tensor of `rows` rows of `cols` elements of `type` (elem_bytes
// each), `pitch` bytes apart, read in boxes of box_rows x box_cols whose
// rows (box_cols * elem_bytes = 128, 64 or 32 bytes) are swizzled across
// their own width; boxes past the last row are zero-filled
inline bool encode_tiled(CUtensorMap* map, CUtensorMapDataType type,
                         int elem_bytes, const void* base, int cols,
                         int rows, size_t pitch, int box_cols,
                         int box_rows) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const int box_bytes = box_cols * elem_bytes;
  const CUtensorMapSwizzle swizzle = box_bytes == 128
      ? CU_TENSOR_MAP_SWIZZLE_128B
      : box_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                        : CU_TENSOR_MAP_SWIZZLE_32B;
  if (box_bytes != 128 && box_bytes != 64 && box_bytes != 32) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)pitch};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// rows of the wgmma query tile for a window of nb queries: 8 ... 256
inline int tc_tile(int nb) {
  int n = 8;
  while (n < nb && n < 256) n *= 2;
  return n;
}

}  // namespace
