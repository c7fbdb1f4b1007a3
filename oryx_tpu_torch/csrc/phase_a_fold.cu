// Phase A of the two-phase streaming top-k over the folded mirror of a
// narrow store: per-block maxima of Q . Y^T.
//
// Replaces _batch_top_n_twophase_pallas_fold of
// oryx_tpu/app/als/serving_model.py (the "fold" kind), both of its bodies.
// For every 128-row logical item block `blk` and query `q`:
//
//   M[q, blk] = max over rows r of block blk of (Y[r] . Q[q] + penalty[r])
//
// accumulated in float32, where penalty[r] is 0 for a live row and -inf for
// a retired one.  The LSH body first sets to -inf every row whose bucket
// differs from the query's target bucket in more than `max_bits` bits.
// The scores never reach device memory: only the (B, N/128) maxima do.
//
// Stores: float32, or bfloat16 with a bfloat16 query.  A bf16 x bf16
// product is exact in float32, so the bf16 body widens both operands on
// the way into shared memory and runs the same float32 FMA loop, in full
// float32 on the CUDA cores (FFMA, no TF32).
//
// Folded mirror.  The reference folds `fold` logical rows into one
// physical row of a W-column mirror: logical row i*fold + j occupies
// columns [j*w, j*w + w), w = W / fold, and it scores each slot against a
// slot-shifted copy of the query.  In row-major memory that mirror is the
// store narrowed to its first w columns and packed, so logical row r sits
// at element offset r*w: this kernel reads it as N rows of w columns
// (`features` = w) against the first w columns of each query (`q_stride`
// = W), and only the penalty and the buckets are read in the mirror's
// slot-major order, penalty_f[j, blk, r'] for block row r'*fold + j.
// Columns w.. of the store are zero (w >= features), so the maxima are
// those of the unfolded store, summed over w columns instead of W.
//
// What bounds it on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s FP32 on CUDA
// cores): the folded mirror of 20,054,016 logical rows x 16 columns (10
// features, fold 2), float32, is 1.28 GB, 0.38 ms; 2 x 20M x 10 x 256 =
// 103 GFLOP, 1.5 ms at B = 256.  The mirror reads 1/fold of the store's
// bytes.
//
// Design: one thread block per (128-row item block, tile of QT queries),
// QT in {8, 32, 64}.  Blocks of one item block are adjacent in the launch
// order, so the tiles of a wide window read their rows from L2, not HBM.
// The block walks the columns in stages of KC columns (the whole row of a
// folded mirror: 8 or 16; 32 for a wider slot): each stage's rows and
// queries are loaded from device memory into registers one stage ahead
// (16-byte loads), then stored transposed into shared memory as float32,
// so a thread reads its rows and queries as float4.  Each of the 256
// threads holds a TM x TN register tile of dot products (8 x 4 at
// QT = 64).  The epilogue adds the penalty, applies the LSH mask with
// __popc, takes the max over the thread's rows, and finishes the max over
// the block's 128 rows with warp shuffles.  A fully masked block gives
// exactly -inf (never NaN), and a zero query row scores exactly 0 before
// the penalty.
//
// The kernel needs N % 128 == 0 and a row width of 8 or 16 columns or a
// multiple of 32; it launches on the caller's stream, allocates nothing
// and does not synchronise.  Its redesign for the tensor cores is queued.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BS = 128;            // rows per item block (_BLOCK_ROWS)
constexpr int THREADS = 256;
constexpr int YS_STRIDE = BS + 4;  // keeps float4 alignment of each column

template <bool BF16>
__device__ __forceinline__ void widen(const uint4& v, float* out) {
  if constexpr (BF16) {
    // little-endian: element 2i is the low half of word i; a bf16 is the
    // high 16 bits of the float32 with the same value
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
    out[0] = __uint_as_float(v.x);
    out[1] = __uint_as_float(v.y);
    out[2] = __uint_as_float(v.z);
    out[3] = __uint_as_float(v.w);
  }
}

// KC: columns per shared-memory stage
template <bool BF16, int QT, int KC>
struct Tile {
  static constexpr int ES = BF16 ? 2 : 4;          // bytes per element
  static constexpr int PV = 16 / ES;               // elements per uint4
  static constexpr int VPR = KC / PV;              // uint4 per row per stage
  static constexpr int YVEC = BS * VPR;            // Y uint4 per stage
  static constexpr int YV = (YVEC + THREADS - 1) / THREADS;
  static constexpr int QVEC = QT * VPR;            // Q uint4 per stage
  static constexpr int QV = (QVEC + THREADS - 1) / THREADS;
  static constexpr int TN = QT >= 32 ? 4 : 1;      // queries per thread
  static constexpr int QG = QT / TN;               // query groups
  static constexpr int RG = THREADS / QG;          // row groups
  static constexpr int TM = BS / RG;               // rows per thread
  static_assert(RG * QG == THREADS, "thread layout");
  static_assert(TM % 4 == 0, "rows per thread come in float4s");
  static_assert(VPR >= 1 && VPR * PV == KC, "a stage is whole uint4s");
};

template <bool BF16, int QT, int KC>
__device__ __forceinline__ void load_stage(
    const uint8_t* __restrict__ Y, const uint8_t* __restrict__ Q,
    size_t row0, int q0, int B, size_t y_row_bytes, size_t q_row_bytes,
    int k0, int tid, uint4* yreg, uint4* qreg) {
  using T = Tile<BF16, QT, KC>;
#pragma unroll
  for (int i = 0; i < T::YV; ++i) {
    const int v = tid + i * THREADS;
    if (T::YVEC % THREADS == 0 || v < T::YVEC) {
      const int r = v / T::VPR, c = v % T::VPR;
      yreg[i] = *reinterpret_cast<const uint4*>(
          Y + (row0 + r) * y_row_bytes + (size_t)(k0 + c * T::PV) * T::ES);
    }
  }
#pragma unroll
  for (int i = 0; i < T::QV; ++i) {
    const int v = tid + i * THREADS;
    if (v < T::QVEC) {
      const int qq = v / T::VPR, c = v % T::VPR;
      qreg[i] = (q0 + qq < B)
          ? *reinterpret_cast<const uint4*>(
                Q + (size_t)(q0 + qq) * q_row_bytes
                  + (size_t)(k0 + c * T::PV) * T::ES)
          : make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

template <bool BF16, int QT, int KC>
__device__ __forceinline__ void store_stage(
    const uint4* yreg, const uint4* qreg, int tid, float* ys, float* qs) {
  using T = Tile<BF16, QT, KC>;
  float f[T::PV];
#pragma unroll
  for (int i = 0; i < T::YV; ++i) {
    const int v = tid + i * THREADS;
    if (T::YVEC % THREADS != 0 && v >= T::YVEC) continue;
    const int r = v / T::VPR, c = v % T::VPR;
    widen<BF16>(yreg[i], f);
#pragma unroll
    for (int e = 0; e < T::PV; ++e) ys[(c * T::PV + e) * YS_STRIDE + r] = f[e];
  }
#pragma unroll
  for (int i = 0; i < T::QV; ++i) {
    const int v = tid + i * THREADS;
    if (v < T::QVEC) {
      const int qq = v / T::VPR, c = v % T::VPR;
      widen<BF16>(qreg[i], f);
#pragma unroll
      for (int e = 0; e < T::PV; ++e) qs[(c * T::PV + e) * QT + qq] = f[e];
    }
  }
}

// F: columns per Y row (the whole row is reduced); q_stride: columns per
// Q row, of which the first F are read; fold: logical rows per physical
// row of the penalty's and buckets' slot-major layout (1: row order)
template <bool BF16, bool LSH, int QT, int KC>
__global__ void __launch_bounds__(THREADS, 2)
phase_a_kernel(const uint8_t* __restrict__ Y, const uint8_t* __restrict__ Q,
               const float* __restrict__ penalty,
               const int32_t* __restrict__ buckets,
               const int32_t* __restrict__ target, float* __restrict__ out,
               int n_blocks, int F, int q_stride, int B, int max_bits,
               int fold) {
  using T = Tile<BF16, QT, KC>;
  __shared__ __align__(16) float ys[KC * YS_STRIDE];
  __shared__ __align__(16) float qs[KC * QT];

  const int n_qt = (B + QT - 1) / QT;
  const int blk = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * QT;
  const int tid = threadIdx.x;
  const int rg = tid % T::RG;
  const int qg = tid / T::RG;
  const size_t row0 = (size_t)blk * BS;
  const size_t y_row_bytes = (size_t)F * T::ES;
  const size_t q_row_bytes = (size_t)q_stride * T::ES;

  uint4 yreg[T::YV];
  uint4 qreg[T::QV];
  float acc[T::TM][T::TN];
#pragma unroll
  for (int i = 0; i < T::TM; ++i)
#pragma unroll
    for (int j = 0; j < T::TN; ++j) acc[i][j] = 0.0f;

  load_stage<BF16, QT, KC>(Y, Q, row0, q0, B, y_row_bytes, q_row_bytes, 0,
                           tid, yreg, qreg);
  for (int k0 = 0; k0 < F; k0 += KC) {
    store_stage<BF16, QT, KC>(yreg, qreg, tid, ys, qs);
    __syncthreads();
    if (k0 + KC < F)  // next stage's loads are in flight during the FMAs
      load_stage<BF16, QT, KC>(Y, Q, row0, q0, B, y_row_bytes, q_row_bytes,
                               k0 + KC, tid, yreg, qreg);
#pragma unroll 4
    for (int kk = 0; kk < KC; ++kk) {
      float a[T::TM];
      float b[T::TN];
#pragma unroll
      for (int j = 0; j < T::TM / 4; ++j) {
        const float4 v = *reinterpret_cast<const float4*>(
            &ys[kk * YS_STRIDE + j * T::RG * 4 + rg * 4]);
        a[4 * j] = v.x;
        a[4 * j + 1] = v.y;
        a[4 * j + 2] = v.z;
        a[4 * j + 3] = v.w;
      }
      if constexpr (T::TN == 4) {
        const float4 w = *reinterpret_cast<const float4*>(
            &qs[kk * QT + qg * 4]);
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
        for (int j = 0; j < T::TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: thread-local row i is block row t = (i/4)*RG*4 + rg*4 + i%4,
  // whose penalty and bucket sit at [t % fold, blk, t / fold] of the
  // (fold, n_blocks, BS / fold) side inputs (at row0 + t for fold 1)
  const int bsf = BS / fold;
  float pen[T::TM];
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
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < T::TM; ++i) {
      float s = acc[i][j] + pen[i];
      if (LSH && __popc(bkt[i] ^ tgt) > max_bits) s = -INFINITY;
      m = fmaxf(m, s);
    }
    // the RG row groups of one query group are adjacent lanes of a warp
#pragma unroll
    for (int off = T::RG / 2; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (rg == 0 && q < B) out[(size_t)q * n_blocks + blk] = m;
  }
}

template <bool BF16, bool LSH, int QT, int KC>
void launch(const void* y, const void* q, const float* penalty,
            const int32_t* buckets, const int32_t* target, float* out,
            int n_blocks, int F, int q_stride, int B, int max_bits, int fold,
            cudaStream_t stream) {
  const unsigned n_qt = (unsigned)((B + QT - 1) / QT);
  const dim3 grid((unsigned)n_blocks * n_qt);
  phase_a_kernel<BF16, LSH, QT, KC><<<grid, THREADS, 0, stream>>>(
      static_cast<const uint8_t*>(y), static_cast<const uint8_t*>(q),
      penalty, buckets, target, out, n_blocks, F, q_stride, B, max_bits,
      fold);
}

template <bool BF16, bool LSH, int KC>
void launch_tile(const void* y, const void* q, const float* penalty,
                 const int32_t* buckets, const int32_t* target, float* out,
                 int n_blocks, int F, int q_stride, int B, int max_bits,
                 int fold, cudaStream_t stream) {
  if (B >= 64)
    launch<BF16, LSH, 64, KC>(y, q, penalty, buckets, target, out, n_blocks,
                              F, q_stride, B, max_bits, fold, stream);
  else if (B > 8)
    launch<BF16, LSH, 32, KC>(y, q, penalty, buckets, target, out, n_blocks,
                              F, q_stride, B, max_bits, fold, stream);
  else
    launch<BF16, LSH, 8, KC>(y, q, penalty, buckets, target, out, n_blocks,
                             F, q_stride, B, max_bits, fold, stream);
}

template <bool BF16, bool LSH>
void launch_width(const void* y, const void* q, const float* penalty,
                  const int32_t* buckets, const int32_t* target, float* out,
                  int n_blocks, int F, int q_stride, int B, int max_bits,
                  int fold, cudaStream_t stream) {
  if (F % 32 == 0)
    launch_tile<BF16, LSH, 32>(y, q, penalty, buckets, target, out, n_blocks,
                               F, q_stride, B, max_bits, fold, stream);
  else if (F == 16)
    launch_tile<BF16, LSH, 16>(y, q, penalty, buckets, target, out, n_blocks,
                               F, q_stride, B, max_bits, fold, stream);
  else
    launch_tile<BF16, LSH, 8>(y, q, penalty, buckets, target, out, n_blocks,
                              F, q_stride, B, max_bits, fold, stream);
}

}  // namespace

// Yf read as (n_rows, features) logical rows and Q (n_queries, q_stride),
// both float32 or both bfloat16 (bf16 != 0), row-major and 16-byte
// aligned; features (w = W / fold) is 8, 16 or a multiple of 32, and at
// most q_stride; only the first `features` columns of Q are read.
// penalty_f (fold, n_rows / 128, 128 / fold) float32; buckets of the same
// layout and target (n_queries,), int32, both null for the exact body;
// fold 2 or 4.  out (n_queries, n_rows / 128) float32.  Returns the CUDA
// error of the launch, 0 on success.
extern "C" int oryx_phase_a_fold(const void* y, const void* q,
                                 const float* penalty,
                                 const int32_t* buckets,
                                 const int32_t* target, float* out,
                                 int n_rows, int features, int q_stride,
                                 int n_queries, int max_bits, int bf16,
                                 int fold, void* stream) {
  const bool width_ok = features > 0
      && (features % 32 == 0 || features == 16 || features == 8);
  if (n_rows <= 0 || n_rows % BS || !width_ok || q_stride < features
      || q_stride % (bf16 ? 8 : 4) || n_queries <= 0
      || (fold != 2 && fold != 4)
      || (buckets == nullptr) != (target == nullptr))
    return (int)cudaErrorInvalidValue;
  (void)cudaGetLastError();  // clear a stale error of an earlier call
  const int n_blocks = n_rows / BS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool lsh = buckets != nullptr;
  if (bf16) {
    if (lsh)
      launch_width<true, true>(y, q, penalty, buckets, target, out, n_blocks,
                               features, q_stride, n_queries, max_bits, fold,
                               s);
    else
      launch_width<true, false>(y, q, penalty, buckets, target, out,
                                n_blocks, features, q_stride, n_queries,
                                max_bits, fold, s);
  } else {
    if (lsh)
      launch_width<false, true>(y, q, penalty, buckets, target, out,
                                n_blocks, features, q_stride, n_queries,
                                max_bits, fold, s);
    else
      launch_width<false, false>(y, q, penalty, buckets, target, out,
                                 n_blocks, features, q_stride, n_queries,
                                 max_bits, fold, s);
  }
  return (int)cudaGetLastError();
}
