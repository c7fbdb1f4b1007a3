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
// A fully masked block gives exactly -inf (never NaN), and a zero query
// row scores exactly 0 before the penalty.
//
// Folded mirror.  The reference folds `fold` logical rows into one
// physical row of a W-column mirror: logical row i*fold + j occupies
// columns [j*w, j*w + w), w = W / fold, and it scores each slot against a
// slot-shifted copy of the query.  In row-major memory that mirror is the
// store narrowed to its first w columns and packed, so logical row r sits
// at element offset r*w and a 128-row logical block is 128*w contiguous
// elements: this kernel reads it as N rows of w columns against the first
// w columns of each query (`q_stride` = W), and only the penalty and the
// buckets are read in the mirror's slot-major order, penalty_f[j, blk, r']
// for block row r'*fold + j.
//
// Zero lanes.  Columns `features`.. of the store and of the cast query
// are exact zeros (the store pads its rows, the query is cast from a
// `features`-wide vector), so the kernel stops its products at `features`
// rounded up to 4 columns.  Each dot product starts at +0 and takes the
// columns in order with fmaf; a sum that starts at +0 is never -0, and
// adding a +0 or -0 product leaves any other value unchanged, so the
// maxima equal those of all w columns (the plain version's) bit for bit.
// At 10 features in a 16-column slot that skips 4 of 16 columns.
//
// Stores: float32, or bfloat16 with a bfloat16 query.  A bf16 x bf16
// product is exact in float32, so the bf16 body widens both operands (the
// rows as it reads them from shared memory, the queries once) and runs
// the same float32 FMA loop, in full float32 on the CUDA cores (FFMA, no
// TF32).
//
// What bounds it on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s FP32 on CUDA
// cores): the folded mirror of 20,054,016 logical rows x 16 columns (10
// features, fold 2), float32, is 1.28 GB, 0.38 ms; 2 x 20M x 10 x 256 =
// 103 GFLOP, 1.5 ms at B = 256, so operations bound the large windows and
// bytes the small ones.
//
// Design: the FFMA engine of phase_a.cu's float32 body, with a whole
// 128-row block per ring stage (a block of a folded mirror is 4-8 KB).
//   - B <= 8 ("narrow", bound by bytes): one warp per 128-row block, each
//     lane 4 rows x 8 queries; every warp streams its blocks through a
//     private cp.async ring of 4 stages, each a whole block with its
//     penalty and buckets; the query tile stays in shared memory as
//     float32, read by broadcast.
//   - B > 8 ("wide"): persistent thread blocks of 256 threads walk the
//     128-row blocks through a CTA-wide cp.async ring of 4 stages, each a
//     whole block with its penalty and buckets.  Every query of the
//     window (up to 256 per grid) stays resident in shared memory as
//     float32, so each block is read from device memory once per 256
//     queries; per query tile of WQ = 128 queries (32 at B <= 32, two
//     thread blocks per SM) a thread holds an 8 x 8 (4 x 4) register tile
//     and multiplies column by column across it, over a number of column
//     groups fixed at compile time.  The
//     epilogue adds the penalty, applies the LSH mask with __popc, takes
//     the max over the thread's rows, then over the row groups with a
//     halving butterfly of shuffles.
//
// The kernels need N % 128 == 0 and a row width of 8 or 16 columns: a
// store pads its rows to a multiple of 32 columns and folds only where
// the features fit half or a quarter of them, so its folded mirrors have
// 8- or 16-column rows.  They launch on the caller's stream, allocate
// nothing and do not synchronise.  A bf16 body on the tensor cores is queued (ROADMAP.md).

#include "hopper.cuh"

namespace {

constexpr int BS = 128;  // rows per item block (_BLOCK_ROWS)

// acc[i][j] += a[i] . b[j] over the four columns of a float4, one column
// at a time across the whole tile, so TM * TN independent FMAs separate
// two that depend on each other; each sum still takes the columns in order
template <int TM, int TN>
__device__ __forceinline__ void fma_tile(float (&acc)[TM][TN],
                                         const float4 (&a)[TM],
                                         const float4 (&b)[TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
}

// little-endian: element 2i is the low half of word i; a bf16 is the high
// 16 bits of the float32 with the same value
__device__ __forceinline__ float4 widen_lo(const uint4& v) {
  return make_float4(__uint_as_float(v.x << 16),
                     __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16),
                     __uint_as_float(v.y & 0xffff0000u));
}
__device__ __forceinline__ float4 widen_hi(const uint4& v) {
  return make_float4(__uint_as_float(v.z << 16),
                     __uint_as_float(v.z & 0xffff0000u),
                     __uint_as_float(v.w << 16),
                     __uint_as_float(v.w & 0xffff0000u));
}

// The layout of one ring stage: a whole 128-row block of W columns, each
// row padded by 16 bytes (so the rows a warp reads at once fall in
// different bank groups), then the block's penalty and buckets in the
// mirror's slot-major order (2 x 128 words).
template <bool BF16, int W>
struct Stage {
  static constexpr int ES = BF16 ? 2 : 4;          // bytes per element
  static constexpr int RB = W * ES;                // bytes per row
  static constexpr int PB = RB + 16;               // bytes per staged row
  static constexpr int CHUNKS = BS * RB / 16;      // 16-byte copies
  static constexpr int BYTES = BS * PB + 2 * BS * 4;
  static constexpr int QP = W + 4;                 // floats per query row
  static constexpr int G = W / 4;                  // column groups of 4
};

// issue the copies of block `blk` into stage `st`, thread `lane0` of the
// `nthreads` threads that share them: the rows, then the side inputs
template <bool BF16, int W>
__device__ __forceinline__ void copy_block(
    uint8_t* st, const uint8_t* __restrict__ Y,
    const float* __restrict__ penalty, const int32_t* __restrict__ buckets,
    int blk, int n_blocks, int fold, int lane0, int nthreads) {
  using S = Stage<BF16, W>;
  const uint8_t* src = Y + (size_t)blk * BS * S::RB;
  for (int i = lane0; i < S::CHUNKS; i += nthreads) {
    const int r = i / (S::RB / 16), c = i % (S::RB / 16);
    cp_async16(st + r * S::PB + 16 * c, src + (size_t)r * S::RB + 16 * c);
  }
  // slot j of the block: bsf = 128 / fold words at [j, blk, 0..bsf);
  // copy k < 32 is a penalty chunk, 32 <= k < 64 a buckets chunk
  const int bsf = BS / fold, per_slot = bsf / 4;
  uint8_t* side = st + BS * S::PB;
  for (int k = lane0; k < (buckets ? 64 : 32); k += nthreads) {
    const int c = k % 32;
    const size_t off = (size_t)(c / per_slot) * n_blocks * bsf
        + (size_t)blk * bsf + 4 * (c % per_slot);
    if (k < 32)
      cp_async16(side + 16 * c, penalty + off);
    else
      cp_async16(side + BS * 4 + 16 * c, buckets + off);
  }
}

// the rows' columns 4g .. 4g + 3 as float32
template <bool BF16, int W>
__device__ __forceinline__ float4 row_group(const uint8_t* row, int g) {
  if constexpr (BF16) {
    const uint4 v = *reinterpret_cast<const uint4*>(row + 16 * (g / 2));
    return g % 2 ? widen_hi(v) : widen_lo(v);
  } else {
    return *reinterpret_cast<const float4*>(row + 16 * g);
  }
}

// the resident query tile: rows q0 .. q0 + nq of Q as float32, W columns,
// zero past B
template <bool BF16, int W>
__device__ __forceinline__ void load_queries(float* qs, const uint8_t* Q,
                                             int q_stride, int q0, int nq,
                                             int B, int tid, int nthreads) {
  constexpr int QP = Stage<BF16, W>::QP;
  for (int i = tid; i < nq * W; i += nthreads) {
    const int q = i / W, c = i % W;
    float x = 0.0f;
    if (q0 + q < B) {
      const size_t e = (size_t)(q0 + q) * q_stride + c;
      x = BF16 ? __uint_as_float(
                     (uint32_t)reinterpret_cast<const uint16_t*>(Q)[e] << 16)
               : reinterpret_cast<const float*>(Q)[e];
    }
    qs[q * QP + c] = x;
  }
}

// B <= 8: one warp per 128-row block, lane l holds rows l + 32 i (i < 4)
// and every query of the tile
constexpr int NQ = 8;        // queries per tile
constexpr int NSTAGES = 4;   // ring stages per warp
constexpr int NW = 4;        // warps per thread block

template <bool BF16, int W>
size_t narrow_smem() {
  using S = Stage<BF16, W>;
  return (size_t)NW * NSTAGES * S::BYTES + (NQ * S::QP + NQ) * 4;
}

template <bool BF16, int W>
__global__ void __launch_bounds__(NW * 32, 1)
fold_narrow(const uint8_t* __restrict__ Y, const uint8_t* __restrict__ Q,
            const float* __restrict__ penalty,
            const int32_t* __restrict__ buckets,
            const int32_t* __restrict__ target, float* __restrict__ out,
            int n_blocks, int q_stride, int B, int max_bits, int fold,
            int kg) {
  using S = Stage<BF16, W>;
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  uint8_t* ring = reinterpret_cast<uint8_t*>(smem4)
      + (size_t)warp * NSTAGES * S::BYTES;
  float* qs = reinterpret_cast<float*>(reinterpret_cast<uint8_t*>(smem4)
                                       + (size_t)NW * NSTAGES * S::BYTES);
  int32_t* tgt = reinterpret_cast<int32_t*>(qs + NQ * S::QP);

  load_queries<BF16, W>(qs, Q, q_stride, 0, NQ, B, tid, NW * 32);
  if (tid < NQ) tgt[tid] = (buckets && tid < B) ? target[tid] : 0;
  __syncthreads();

  const int gw = blockIdx.x * NW + warp, nw = gridDim.x * NW;
  const int mine = gw < n_blocks ? (n_blocks - 1 - gw) / nw + 1 : 0;
  auto issue = [&](int t) {
    if (t < mine)
      copy_block<BF16, W>(ring + (t % NSTAGES) * S::BYTES, Y, penalty,
                          buckets, gw + t * nw, n_blocks, fold, lane, 32);
    cp_async_commit();  // an empty group past the end keeps the count
  };
#pragma unroll
  for (int t = 0; t < NSTAGES - 1; ++t) issue(t);

  const int bsf = BS / fold;
  for (int t = 0; t < mine; ++t) {
    const int blk = gw + t * nw;
    cp_async_wait<NSTAGES - 2>();
    __syncwarp();
    issue(t + NSTAGES - 1);  // into the slot the warp read at t - 1
    const uint8_t* ys = ring + (t % NSTAGES) * S::BYTES;
    // the side inputs came with the block's rows
    const float* sp = reinterpret_cast<const float*>(ys + BS * S::PB);
    const int32_t* sb = reinterpret_cast<const int32_t*>(sp + BS);
    float pen[4];
    int32_t bkt[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = lane + 32 * i;
      const int k = (r % fold) * bsf + r / fold;
      pen[i] = sp[k];
      bkt[i] = buckets ? sb[k] : 0;
    }
    float acc[4][NQ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NQ; ++j) acc[i][j] = 0.0f;
#pragma unroll
    for (int g = 0; g < S::G; ++g) {
      if (g < kg) {
        float4 a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = row_group<BF16, W>(ys + (lane + 32 * i) * S::PB, g);
        float4 b[NQ];
#pragma unroll
        for (int j = 0; j < NQ; ++j)
          b[j] = *reinterpret_cast<const float4*>(qs + j * S::QP + 4 * g);
        fma_tile(acc, a, b);
      }
    }
    float v[NQ];
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      float m = -INFINITY;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float s = acc[i][j] + pen[i];
        if (buckets && __popc(bkt[i] ^ tgt[j]) > max_bits) s = -INFINITY;
        m = fmaxf(m, s);
      }
      v[j] = m;
    }
    int base = 0;
    bfly<NQ, 16>(v, lane, base);
    bfly<halve(NQ), 8>(v, lane, base);
    bfly<halve(halve(NQ)), 4>(v, lane, base);
    bfly<halve(halve(halve(NQ))), 2>(v, lane, base);
    bfly<halve(halve(halve(halve(NQ)))), 1>(v, lane, base);
    constexpr int V5 = halve(halve(halve(halve(halve(NQ)))));
    constexpr int DUP = dup_bits(NQ, 16, 1);
    if ((lane & DUP) == 0) {
#pragma unroll
      for (int k = 0; k < V5; ++k)
        if (base + k < B) out[(size_t)(base + k) * n_blocks + blk] = v[k];
    }
  }
  cp_async_wait<0>();
}

// 8 < B: 256 threads; per query tile of WQ queries (32 up to 32 queries,
// else 128) thread (rg, qg) = (tid % RG, tid / RG) holds rows rg + RG i
// (i < TM) and queries qg + QG j (j < TN): 8 x 8 at WQ = 128, 4 x 4 at
// WQ = 32, where two thread blocks share an SM
constexpr int WT = 256;
constexpr int WSTAGES = 4;   // ring stages per thread block
constexpr int QMAX = 256;    // queries resident per grid

template <int WQ>
struct Wide {
  static constexpr int RG = WQ == 32 ? 32 : 16;  // row groups
  static constexpr int TM = BS / RG;
  static constexpr int QG = WT / RG;             // query groups
  static constexpr int TN = WQ / QG;
  static constexpr int PER_SM = WQ == 128 ? 1 : 2;
  static_assert(TN * QG == WQ && TM * RG == BS, "thread tile");
};

template <bool BF16, int W>
size_t wide_smem(int nq) {
  using S = Stage<BF16, W>;
  return (size_t)WSTAGES * S::BYTES + (size_t)nq * (S::QP + 1) * 4;
}

template <bool BF16, int W, int WQ, int KG>
__global__ void __launch_bounds__(WT, Wide<WQ>::PER_SM)
fold_wide(const uint8_t* __restrict__ Y, const uint8_t* __restrict__ Q,
          const float* __restrict__ penalty,
          const int32_t* __restrict__ buckets,
          const int32_t* __restrict__ target, float* __restrict__ out,
          int n_blocks, int q_stride, int q0, int B, int max_bits, int fold,
          int n_qt) {
  using S = Stage<BF16, W>;
  using T = Wide<WQ>;
  constexpr int RG = T::RG, TM = T::TM, QG = T::QG, TN = T::TN;
  extern __shared__ float4 smem4[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(smem4);
  float* qs = reinterpret_cast<float*>(ring + (size_t)WSTAGES * S::BYTES);
  int32_t* tgt = reinterpret_cast<int32_t*>(qs + n_qt * WQ * S::QP);
  const int tid = threadIdx.x, lane = tid % 32;
  const int rg = tid % RG, qg = tid / RG;

  load_queries<BF16, W>(qs, Q, q_stride, q0, n_qt * WQ, B, tid, WT);
  for (int i = tid; i < n_qt * WQ; i += WT)
    tgt[i] = (buckets && q0 + i < B) ? target[q0 + i] : 0;
  __syncthreads();

  const int first = blockIdx.x, stride = gridDim.x;
  const int mine = first < n_blocks ? (n_blocks - 1 - first) / stride + 1 : 0;
  auto issue = [&](int t) {
    if (t < mine)
      copy_block<BF16, W>(ring + (t % WSTAGES) * S::BYTES, Y, penalty,
                          buckets, first + t * stride, n_blocks, fold, tid,
                          WT);
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < WSTAGES - 1; ++t) issue(t);

  const int bsf = BS / fold;
  for (int t = 0; t < mine; ++t) {
    const int blk = first + t * stride;
    cp_async_wait<WSTAGES - 2>();
    __syncthreads();
    issue(t + WSTAGES - 1);  // into the slot every thread read at t - 1
    const uint8_t* ys = ring + (t % WSTAGES) * S::BYTES;
    const float* sp = reinterpret_cast<const float*>(ys + BS * S::PB);
    const int32_t* sb = reinterpret_cast<const int32_t*>(sp + BS);
    float pen[TM];
    int32_t bkt[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = rg + RG * i;
      const int k = (r % fold) * bsf + r / fold;
      pen[i] = sp[k];
      bkt[i] = buckets ? sb[k] : 0;
    }
    for (int qt = 0; qt < n_qt; ++qt) {
      const float* qt_s = qs + qt * WQ * S::QP;
      float acc[TM][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
#pragma unroll
      for (int g = 0; g < KG; ++g) {
        {
          float4 a[TM];
#pragma unroll
          for (int i = 0; i < TM; ++i)
            a[i] = row_group<BF16, W>(ys + (rg + RG * i) * S::PB, g);
          float4 b[TN];
#pragma unroll
          for (int j = 0; j < TN; ++j)
            b[j] = *reinterpret_cast<const float4*>(
                qt_s + (qg + QG * j) * S::QP + 4 * g);
          fma_tile(acc, a, b);
        }
      }
      float v[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int32_t tq = tgt[qt * WQ + qg + QG * j];
        float m = -INFINITY;
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          float s = acc[i][j] + pen[i];
          if (buckets && __popc(bkt[i] ^ tq) > max_bits) s = -INFINITY;
          m = fmaxf(m, s);
        }
        v[j] = m;
      }
      // over the RG row groups: the lanes that differ in the low bits
      int base = 0;
      constexpr int C1 = RG == 32 ? halve(TN) : TN;
      if constexpr (RG == 32) bfly<TN, 16>(v, lane, base);
      bfly<C1, 8>(v, lane, base);
      bfly<halve(C1), 4>(v, lane, base);
      bfly<halve(halve(C1)), 2>(v, lane, base);
      bfly<halve(halve(halve(C1))), 1>(v, lane, base);
      static_assert(halve(halve(halve(halve(C1)))) == 1, "one query left");
      constexpr int DUP = dup_bits(TN, RG / 2, 1);
      const int q = q0 + qt * WQ + qg + QG * base;
      if ((lane & DUP) == 0 && q < B) out[(size_t)q * n_blocks + blk] = v[0];
    }
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// host side

template <bool BF16, int W>
int launch_narrow(const void* y, const void* q, const float* penalty,
                  const int32_t* buckets, const int32_t* target, float* out,
                  int n_blocks, int q_stride, int B, int max_bits, int fold,
                  int kg, cudaStream_t stream) {
  auto kernel = fold_narrow<BF16, W>;
  static bool smem_set = false;
  if (const int rc = set_smem(kernel, smem_set)) return rc;
  const size_t smem = narrow_smem<BF16, W>();
  if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  constexpr int nw = NW;
  const int grid = grid_for(kernel, nw * 32, smem, (n_blocks + nw - 1) / nw);
  kernel<<<grid, nw * 32, smem, stream>>>(
      static_cast<const uint8_t*>(y), static_cast<const uint8_t*>(q),
      penalty, buckets, target, out, n_blocks, q_stride, B, max_bits, fold,
      kg);
  return (int)cudaGetLastError();
}

template <bool BF16, int W, int WQ, int KG>
int launch_wide(const void* y, const void* q, const float* penalty,
                const int32_t* buckets, const int32_t* target, float* out,
                int n_blocks, int q_stride, int B, int max_bits, int fold,
                cudaStream_t stream) {
  auto kernel = fold_wide<BF16, W, WQ, KG>;
  static bool smem_set = false;
  if (const int rc = set_smem(kernel, smem_set)) return rc;
  // one grid per QMAX queries, each holding them all in shared memory
  for (int q0 = 0; q0 < B; q0 += QMAX) {
    const int nb = B - q0 < QMAX ? B - q0 : QMAX;
    const int n_qt = (nb + WQ - 1) / WQ;
    const size_t smem = wide_smem<BF16, W>(n_qt * WQ);
    if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    const int grid = grid_for(kernel, WT, smem, n_blocks);
    kernel<<<grid, WT, smem, stream>>>(
        static_cast<const uint8_t*>(y), static_cast<const uint8_t*>(q),
        penalty, buckets, target, out, n_blocks, q_stride, q0, B, max_bits,
        fold, n_qt);
    if (const cudaError_t rc = cudaGetLastError()) return (int)rc;
  }
  return 0;
}

template <bool BF16, int W>
int launch_width(const void* y, const void* q, const float* penalty,
                 const int32_t* buckets, const int32_t* target, float* out,
                 int n_blocks, int q_stride, int B, int max_bits, int fold,
                 int kg, cudaStream_t s) {
  if (B <= NQ)
    return launch_narrow<BF16, W>(y, q, penalty, buckets, target, out,
                                  n_blocks, q_stride, B, max_bits, fold, kg,
                                  s);
  // the column groups multiplied are a template argument, so the FMA
  // loop unrolls whole: 3 or 4 in a 16-column slot (9-16 features: fewer
  // fold 4 ways), all 2 in an 8-column one; more than `features` columns
  // only adds zero products
  if constexpr (W == 16) {
    if (kg <= 3)
      return B <= 32 ? launch_wide<BF16, W, 32, 3>(y, q, penalty, buckets,
                                                   target, out, n_blocks,
                                                   q_stride, B, max_bits,
                                                   fold, s)
                     : launch_wide<BF16, W, 128, 3>(y, q, penalty, buckets,
                                                    target, out, n_blocks,
                                                    q_stride, B, max_bits,
                                                    fold, s);
  }
  return B <= 32 ? launch_wide<BF16, W, 32, W / 4>(y, q, penalty, buckets,
                                                   target, out, n_blocks,
                                                   q_stride, B, max_bits,
                                                   fold, s)
                 : launch_wide<BF16, W, 128, W / 4>(y, q, penalty, buckets,
                                                    target, out, n_blocks,
                                                    q_stride, B, max_bits,
                                                    fold, s);
}

template <bool BF16>
int launch_dtype(const void* y, const void* q, const float* penalty,
                 const int32_t* buckets, const int32_t* target, float* out,
                 int n_blocks, int w, int q_stride, int B, int max_bits,
                 int fold, int kg, cudaStream_t s) {
#define ORYX_FOLD(width)                                                   \
  case width:                                                              \
    return launch_width<BF16, width>(y, q, penalty, buckets, target, out, \
                                     n_blocks, q_stride, B, max_bits,     \
                                     fold, kg, s);
  switch (w) {
    ORYX_FOLD(8)
    ORYX_FOLD(16)
  }
#undef ORYX_FOLD
  return (int)cudaErrorInvalidValue;
}

bool width_ok(int w) { return w == 8 || w == 16; }

}  // namespace

// Yf read as (n_rows, width) logical rows and Q (n_queries, q_stride),
// both float32 or both bfloat16 (bf16 != 0), row-major and 16-byte
// aligned; width (w = W / fold) is 8 or 16, and at most q_stride;
// only the first `width` columns of Q are read, and of those only the
// first `features` (1 <= features <= width) are multiplied: the columns
// past them must be zero in the rows or in the queries.  penalty_f (fold,
// n_rows / 128, 128 / fold) float32; buckets of the same layout and
// target (n_queries,), int32, both null for the exact body; fold 2 or 4.
// out (n_queries, n_rows / 128) float32.  Returns the CUDA error of the
// launch, 0 on success.
extern "C" int oryx_phase_a_fold(const void* y, const void* q,
                                 const float* penalty,
                                 const int32_t* buckets,
                                 const int32_t* target, float* out,
                                 int n_rows, int width, int q_stride,
                                 int n_queries, int max_bits, int bf16,
                                 int fold, int features, void* stream) {
  if (n_rows <= 0 || n_rows % BS || !width_ok(width) || q_stride < width
      || q_stride % (bf16 ? 8 : 4) || n_queries <= 0
      || (fold != 2 && fold != 4) || features <= 0 || features > width
      || (buckets == nullptr) != (target == nullptr))
    return (int)cudaErrorInvalidValue;
  (void)cudaGetLastError();  // clear a stale error of an earlier call
  const int n_blocks = n_rows / BS;
  const int kg = (features + 3) / 4;  // column groups multiplied
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_dtype<true>(y, q, penalty, buckets, target, out,
                                   n_blocks, width, q_stride, n_queries,
                                   max_bits, fold, kg, s)
              : launch_dtype<false>(y, q, penalty, buckets, target, out,
                                    n_blocks, width, q_stride, n_queries,
                                    max_bits, fold, kg, s);
}

// What a launch of oryx_phase_a_fold with these sizes runs, for reports:
// the body (1 narrow FFMA, 2 wide FFMA), the queries per register tile,
// the ring stages and the dynamic shared memory of one thread block (of
// the first grid).  Returns -1 for sizes the kernel does not take.
extern "C" int oryx_phase_a_fold_plan(int width, int n_queries, int bf16,
                                      int* tile, int* stages, int* smem) {
  if (!width_ok(width) || n_queries <= 0) return -1;
  const int nb = n_queries < QMAX ? n_queries : QMAX;
  size_t bytes = 0;
#define ORYX_PLAN(w)                                                         \
  if (width == w) {                                                          \
    if (n_queries <= NQ)                                                     \
      bytes = bf16 ? narrow_smem<true, w>() : narrow_smem<false, w>();       \
    else {                                                                   \
      const int wq = n_queries <= 32 ? 32 : 128;                             \
      const int nq = (nb + wq - 1) / wq * wq;                                \
      bytes = bf16 ? wide_smem<true, w>(nq) : wide_smem<false, w>(nq);       \
    }                                                                        \
  }
  ORYX_PLAN(8)
  ORYX_PLAN(16)
#undef ORYX_PLAN
  *smem = (int)bytes;
  if (n_queries <= NQ) {
    *tile = NQ;
    *stages = NSTAGES;
    return 1;
  }
  *tile = n_queries <= 32 ? 32 : 128;
  *stages = WSTAGES;
  return 2;
}
