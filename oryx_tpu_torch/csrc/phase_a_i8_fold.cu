// Phase A of the two-phase streaming top-k on the folded int8 mirror:
// per-block maxima of the integer products Y8 . q8^T.
//
// Replaces _batch_top_n_twophase_pallas_i8_fold of
// oryx_tpu/app/als/serving_model.py (the "i8_fold" kind), both of its
// bodies, over the folded int8 mirror (see "Folded mirror" below).  The
// unfolded int8 mirror (the "i8" kind) has its own kernel on the tensor
// cores, csrc/phase_a_i8.cu; this __dp4a template served both kinds until
// that kernel replaced it there, and is kept unchanged here, so its
// maxima can be held against the tensor-core kernel's bit for bit.
// For every 128-row item block `blk` and query `q`:
//
//   M[q, blk] = max over rows r of block blk of (Y8[r] . q8[q] + penalty[r])
//
// in int32, where penalty[r] is 0 for a live row and _I8_PENALTY = -2^29
// for a retired one.  The LSH body REPLACES the score of every row whose
// bucket differs from the query's target bucket in more than `max_bits`
// bits with _I8_PENALTY (it does not add it: a row both retired and
// outside the ball would otherwise reach another maximum).  Integer sums
// are exact, |Y8 . q8| <= 127^2 x width < 2^23 at width <= 256, so the
// maxima equal the plain version's bit for bit.  The float32 upper bounds
// phase B selects on are made from them by torch code (the bound epilogue),
// as the reference makes them outside its kernel.
//
// Folded mirror.  The reference folds `fold` logical rows into one
// physical row of a W-byte mirror: logical row i*fold + j occupies bytes
// [j*w, j*w + w), w = W / fold.  In row-major memory that is the int8
// mirror narrowed to its first w bytes and packed, so logical row r sits
// at byte offset r*w: the folded body reads N rows of w bytes against the
// first w bytes of each query row (`q_stride` = W), and reads only the
// penalty and the buckets in the mirror's slot-major order,
// penalty_f[j, blk, r'] for block row r'*fold + j.  Quantized lanes at or
// past the feature count are exact zeros, so the folded maxima equal the
// unfolded ones bit for bit.
//
// What bounds it on an H100 SXM (3.35 TB/s HBM; 1,979 TOPS int8 on the
// tensor cores; __dp4a runs on the CUDA cores, at a small fraction of
// that):
//   - i8, 5,111,808 rows x 256 bytes (250 features): 1.31 GB, 0.39 ms of
//     reading; 2 x 5,111,808 x 256 x B operations, 6.7e11 at B = 256,
//     0.34 ms at the tensor cores' rate.  x 64 bytes (50 features):
//     0.33 GB, 0.10 ms.
//   - i8_fold, 20,054,016 logical rows x 16 bytes (10 features, fold 2):
//     0.32 GB, 0.10 ms.
//   Every case is bound by bytes against the tensor cores' rate; this
//   kernel multiplies with __dp4a (4 int8 products per instruction), so
//   its large windows are bound by the CUDA cores' integer throughput.
//
// Design: one thread block per (128-row item block, tile of QT queries),
// QT in {8, 32, 64}, as in phase_a.cu.  The block walks the row in stages
// of KB bytes (32, or the whole row of a folded mirror: 8 or 16); each
// stage's rows and queries are loaded into registers one stage ahead
// (16-byte loads; 8-byte ones for 8-byte rows), then stored into shared
// memory as int32 words, transposed (word-major), so a thread reads four
// rows' or four queries' words as one int4.  Each of the 256 threads holds
// a TM x TN register tile of int32 sums and issues TM x TN __dp4a per word.
// The epilogue adds the penalty, applies the LSH replacement with __popc,
// takes the max over the thread's rows and finishes the max over the
// block's 128 rows with warp shuffles.  A zero query row gives 0 (or the
// penalty) on every block; the bound epilogue turns it into -inf.
//
// The kernel needs N % 128 == 0 and a row width that is a multiple of 32
// bytes, or 8 or 16 for a folded mirror; it launches on the caller's
// stream, allocates nothing and does not synchronise.  The folded body on
// the tensor cores (int8 wgmma against slot-shifted queries) is later
// work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BS = 128;            // rows per item block (_BLOCK_ROWS)
constexpr int THREADS = 256;
constexpr int YS_STRIDE = BS + 4;  // keeps int4 alignment of each word row
constexpr int32_t I8_PENALTY = -(1 << 29);

template <int VB>
struct Vec;
template <>
struct Vec<16> {
  using T = uint4;
  static __device__ void words(const uint4& v, int32_t* w) {
    w[0] = (int32_t)v.x;
    w[1] = (int32_t)v.y;
    w[2] = (int32_t)v.z;
    w[3] = (int32_t)v.w;
  }
  static __device__ uint4 zero() { return make_uint4(0u, 0u, 0u, 0u); }
};
template <>
struct Vec<8> {
  using T = uint2;
  static __device__ void words(const uint2& v, int32_t* w) {
    w[0] = (int32_t)v.x;
    w[1] = (int32_t)v.y;
  }
  static __device__ uint2 zero() { return make_uint2(0u, 0u); }
};

// KB: bytes per shared-memory stage
template <int QT, int KB>
struct Tile {
  static constexpr int VB = KB < 16 ? KB : 16;     // bytes per vector load
  using V = Vec<VB>;
  using VT = typename V::T;
  static constexpr int VW = VB / 4;                // words per vector
  static constexpr int VPR = KB / VB;              // vectors per row per stage
  static constexpr int KW = KB / 4;                // words per row per stage
  static constexpr int YVEC = BS * VPR;            // Y vectors per stage
  static constexpr int YV = (YVEC + THREADS - 1) / THREADS;
  static constexpr int QVEC = QT * VPR;            // Q vectors per stage
  static constexpr int QV = (QVEC + THREADS - 1) / THREADS;
  static constexpr int TN = QT >= 32 ? 4 : 1;      // queries per thread
  static constexpr int QG = QT / TN;               // query groups
  static constexpr int RG = THREADS / QG;          // row groups
  static constexpr int TM = BS / RG;               // rows per thread
  static_assert(RG * QG == THREADS, "thread layout");
  static_assert(TM % 4 == 0, "rows per thread come in int4s");
  static_assert(VPR >= 1 && VPR * VB == KB, "a stage is whole vectors");
};

template <int QT, int KB>
__device__ __forceinline__ void load_stage(
    const uint8_t* __restrict__ Y, const uint8_t* __restrict__ Q,
    size_t row0, int q0, int B, size_t y_row_bytes, size_t q_row_bytes,
    int k0, int tid, typename Tile<QT, KB>::VT* yreg,
    typename Tile<QT, KB>::VT* qreg) {
  using T = Tile<QT, KB>;
#pragma unroll
  for (int i = 0; i < T::YV; ++i) {
    const int v = tid + i * THREADS;
    if (T::YVEC % THREADS == 0 || v < T::YVEC) {
      const int r = v / T::VPR, c = v % T::VPR;
      yreg[i] = *reinterpret_cast<const typename T::VT*>(
          Y + (row0 + r) * y_row_bytes + k0 + c * T::VB);
    }
  }
#pragma unroll
  for (int i = 0; i < T::QV; ++i) {
    const int v = tid + i * THREADS;
    if (v < T::QVEC) {
      const int qq = v / T::VPR, c = v % T::VPR;
      qreg[i] = (q0 + qq < B)
          ? *reinterpret_cast<const typename T::VT*>(
                Q + (size_t)(q0 + qq) * q_row_bytes + k0 + c * T::VB)
          : T::V::zero();
    }
  }
}

template <int QT, int KB>
__device__ __forceinline__ void store_stage(
    const typename Tile<QT, KB>::VT* yreg,
    const typename Tile<QT, KB>::VT* qreg, int tid, int32_t* ys,
    int32_t* qs) {
  using T = Tile<QT, KB>;
  int32_t w[T::VW];
#pragma unroll
  for (int i = 0; i < T::YV; ++i) {
    const int v = tid + i * THREADS;
    if (T::YVEC % THREADS != 0 && v >= T::YVEC) continue;
    const int r = v / T::VPR, c = v % T::VPR;
    T::V::words(yreg[i], w);
#pragma unroll
    for (int e = 0; e < T::VW; ++e) ys[(c * T::VW + e) * YS_STRIDE + r] = w[e];
  }
#pragma unroll
  for (int i = 0; i < T::QV; ++i) {
    const int v = tid + i * THREADS;
    if (v < T::QVEC) {
      const int qq = v / T::VPR, c = v % T::VPR;
      T::V::words(qreg[i], w);
#pragma unroll
      for (int e = 0; e < T::VW; ++e) qs[(c * T::VW + e) * QT + qq] = w[e];
    }
  }
}

// F: bytes per Y row (the whole row is reduced); q_stride: bytes per Q
// row, of which the first F are read; fold: logical rows per physical row
// of the penalty's and buckets' slot-major layout (1: row order)
template <bool LSH, int QT, int KB>
__global__ void __launch_bounds__(THREADS, 2)
phase_a_i8_kernel(const uint8_t* __restrict__ Y,
                  const uint8_t* __restrict__ Q,
                  const int32_t* __restrict__ penalty,
                  const int32_t* __restrict__ buckets,
                  const int32_t* __restrict__ target,
                  int32_t* __restrict__ out, int n_blocks, int F,
                  int q_stride, int B, int max_bits, int fold) {
  using T = Tile<QT, KB>;
  __shared__ __align__(16) int32_t ys[T::KW * YS_STRIDE];
  __shared__ __align__(16) int32_t qs[T::KW * QT];

  const int n_qt = (B + QT - 1) / QT;
  const int blk = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * QT;
  const int tid = threadIdx.x;
  const int rg = tid % T::RG;
  const int qg = tid / T::RG;
  const size_t row0 = (size_t)blk * BS;

  typename T::VT yreg[T::YV];
  typename T::VT qreg[T::QV];
  int32_t acc[T::TM][T::TN];
#pragma unroll
  for (int i = 0; i < T::TM; ++i)
#pragma unroll
    for (int j = 0; j < T::TN; ++j) acc[i][j] = 0;

  load_stage<QT, KB>(Y, Q, row0, q0, B, F, q_stride, 0, tid, yreg, qreg);
  for (int k0 = 0; k0 < F; k0 += KB) {
    store_stage<QT, KB>(yreg, qreg, tid, ys, qs);
    __syncthreads();
    if (k0 + KB < F)  // next stage's loads are in flight during the dp4a
      load_stage<QT, KB>(Y, Q, row0, q0, B, F, q_stride, k0 + KB, tid, yreg,
                         qreg);
#pragma unroll
    for (int kk = 0; kk < T::KW; ++kk) {
      int32_t a[T::TM];
      int32_t b[T::TN];
#pragma unroll
      for (int j = 0; j < T::TM / 4; ++j) {
        const int4 v = *reinterpret_cast<const int4*>(
            &ys[kk * YS_STRIDE + j * T::RG * 4 + rg * 4]);
        a[4 * j] = v.x;
        a[4 * j + 1] = v.y;
        a[4 * j + 2] = v.z;
        a[4 * j + 3] = v.w;
      }
      if constexpr (T::TN == 4) {
        const int4 w = *reinterpret_cast<const int4*>(&qs[kk * QT + qg * 4]);
        b[0] = w.x;
        b[1] = w.y;
        b[2] = w.z;
        b[3] = w.w;
      } else {
        b[0] = qs[kk * QT + qg];
      }
#pragma unroll
      for (int i = 0; i < T::TM; ++i)
#pragma unroll
        for (int j = 0; j < T::TN; ++j)
          acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: thread-local row i is block row t = (i/4)*RG*4 + rg*4 + i%4,
  // whose penalty and bucket sit at [t % fold, blk, t / fold] of the
  // (fold, n_blocks, BS / fold) side inputs (at row0 + t for fold 1)
  const int bsf = BS / fold;
  int32_t pen[T::TM];
  int32_t bkt[T::TM];
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    const int t = (i / 4) * T::RG * 4 + rg * 4 + (i % 4);
    const size_t r = (size_t)(t % fold) * n_blocks * bsf
        + (size_t)blk * bsf + t / fold;
    pen[i] = penalty[r];
    bkt[i] = LSH ? buckets[r] : 0;
  }
#pragma unroll
  for (int j = 0; j < T::TN; ++j) {
    const int q = q0 + qg * T::TN + j;
    const int32_t tgt = (LSH && q < B) ? target[q] : 0;
    int32_t m = INT32_MIN;
#pragma unroll
    for (int i = 0; i < T::TM; ++i) {
      int32_t s = acc[i][j] + pen[i];
      if (LSH && __popc(bkt[i] ^ tgt) > max_bits) s = I8_PENALTY;
      m = max(m, s);
    }
    // the RG row groups of one query group are adjacent lanes of a warp
#pragma unroll
    for (int off = T::RG / 2; off > 0; off >>= 1)
      m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (rg == 0 && q < B) out[(size_t)q * n_blocks + blk] = m;
  }
}

template <bool LSH, int QT, int KB>
void launch(const void* y, const void* q, const int32_t* penalty,
            const int32_t* buckets, const int32_t* target, int32_t* out,
            int n_blocks, int F, int q_stride, int B, int max_bits, int fold,
            cudaStream_t stream) {
  const unsigned n_qt = (unsigned)((B + QT - 1) / QT);
  const dim3 grid((unsigned)n_blocks * n_qt);
  phase_a_i8_kernel<LSH, QT, KB><<<grid, THREADS, 0, stream>>>(
      static_cast<const uint8_t*>(y), static_cast<const uint8_t*>(q),
      penalty, buckets, target, out, n_blocks, F, q_stride, B, max_bits,
      fold);
}

template <bool LSH, int KB>
void launch_tile(const void* y, const void* q, const int32_t* penalty,
                 const int32_t* buckets, const int32_t* target, int32_t* out,
                 int n_blocks, int F, int q_stride, int B, int max_bits,
                 int fold, cudaStream_t stream) {
  if (B >= 64)
    launch<LSH, 64, KB>(y, q, penalty, buckets, target, out, n_blocks, F,
                        q_stride, B, max_bits, fold, stream);
  else if (B > 8)
    launch<LSH, 32, KB>(y, q, penalty, buckets, target, out, n_blocks, F,
                        q_stride, B, max_bits, fold, stream);
  else
    launch<LSH, 8, KB>(y, q, penalty, buckets, target, out, n_blocks, F,
                       q_stride, B, max_bits, fold, stream);
}

template <bool LSH>
void launch_width(const void* y, const void* q, const int32_t* penalty,
                  const int32_t* buckets, const int32_t* target,
                  int32_t* out, int n_blocks, int F, int q_stride, int B,
                  int max_bits, int fold, cudaStream_t stream) {
  if (F % 32 == 0)
    launch_tile<LSH, 32>(y, q, penalty, buckets, target, out, n_blocks, F,
                         q_stride, B, max_bits, fold, stream);
  else if (F == 16)
    launch_tile<LSH, 16>(y, q, penalty, buckets, target, out, n_blocks, F,
                         q_stride, B, max_bits, fold, stream);
  else
    launch_tile<LSH, 8>(y, q, penalty, buckets, target, out, n_blocks, F,
                        q_stride, B, max_bits, fold, stream);
}

}  // namespace

// Y8 (n_rows, width) and q8 (n_queries, q_stride) int8, row-major and
// 16-byte aligned; width a multiple of 32, or 8 or 16, at most 256 and at
// most q_stride; only the first `width` bytes of a q8 row are read.
// penalty (fold, n_rows / 128, 128 / fold) int32; buckets of the same
// layout and target (n_queries,), int32, both null for the exact body;
// fold 1 (the mirror of the store: penalty and buckets in row order), 2 or
// 4 (a folded mirror read as n_rows rows of `width` bytes).  out
// (n_queries, n_rows / 128) int32.  Returns the CUDA error of the launch,
// 0 on success.
extern "C" int oryx_phase_a_i8_fold(const void* y8, const void* q8,
                                    const int32_t* penalty,
                                    const int32_t* buckets,
                                    const int32_t* target, int32_t* out,
                                    int n_rows, int width, int q_stride,
                                    int n_queries, int max_bits, int fold,
                                    void* stream) {
  const bool width_ok = width > 0 && width <= 256
      && (width % 32 == 0 || width == 16 || width == 8);
  if (n_rows <= 0 || n_rows % BS || !width_ok || q_stride < width
      || q_stride % 16 || n_queries <= 0
      || (fold != 1 && fold != 2 && fold != 4)
      || (buckets == nullptr) != (target == nullptr))
    return (int)cudaErrorInvalidValue;
  (void)cudaGetLastError();  // clear a stale error of an earlier call
  const int n_blocks = n_rows / BS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (buckets != nullptr)
    launch_width<true>(y8, q8, penalty, buckets, target, out, n_blocks,
                       width, q_stride, n_queries, max_bits, fold, s);
  else
    launch_width<false>(y8, q8, penalty, buckets, target, out, n_blocks,
                        width, q_stride, n_queries, max_bits, fold, s);
  return (int)cudaGetLastError();
}
