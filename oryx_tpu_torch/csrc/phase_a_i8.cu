// Phase A of the two-phase streaming top-k on the int8 mirror: per-block
// maxima of the integer products Y8 . q8^T, on the tensor cores.
//
// Replaces _batch_top_n_twophase_pallas_i8 of
// oryx_tpu/app/als/serving_model.py (the "i8" kind), both of its bodies,
// over the int8 mirror of the store (one scale per 128-row block, made by
// _quantize_items_kernel).  For every 128-row item block `blk` and query
// `q`:
//
//   M[q, blk] = max over rows r of block blk of (Y8[r] . q8[q] + penalty[r])
//
// in int32, where penalty[r] is 0 for a live row and _I8_PENALTY = -2^29
// for a retired one.  The LSH body REPLACES the score of every row whose
// bucket differs from the query's target bucket in more than `max_bits`
// bits with _I8_PENALTY (it does not add it: a row both retired and
// outside the ball would otherwise reach another maximum).  The tensor
// cores sum int8 products exactly in int32, |Y8 . q8| <= 127^2 x width <
// 2^23 at width <= 256, so the maxima equal the plain version's bit for
// bit.  The float32 upper bounds phase B selects on are made from them by
// torch code (the bound epilogue), as the reference makes them outside its
// kernel.  The folded int8 mirror (the "i8_fold" kind) has its own kernel,
// csrc/phase_a_i8_fold.cu, on the same int8 wgmma engine and in the same
// two orientations.
//
// What bounds it on an H100 SXM (3.35 TB/s HBM; 1,979 TOPS int8 dense on
// the tensor cores): at 5,111,808 rows x 256 bytes (250 features) 1.31 GB
// to read, 0.39 ms; 2 x 5,111,808 x 256 x B operations, 6.7e11 at B = 256,
// 0.34 ms.  At x 64 bytes (50 features) 0.33 GB, 0.10 ms.  Every window is
// bound by bytes.
//
// Design: wgmma.mma_async m64nNk32, s8 x s8 -> s32, on the engine of
// phase_a.cu's bf16 body (the shared pieces are in hopper.cuh, the int8
// products in wgmma_s8.cuh): both operands K-major in shared memory, as
// integer wgmma requires; the store rows through a ring of up to 8
// stages of 128 rows x CB bytes that one producer lane keeps filled by
// TMA, each stage with a "full" and an "empty" mbarrier; the query tile
// loaded once per thread block by TMA, its rows past B zero-filled;
// persistent thread blocks (about one per SM) walking the 128-row blocks,
// so each block is read from device memory once per query tile of up to
// 256 queries (one grid per tile).
// CB = 128 bytes with the 128-byte swizzle where the width is a multiple
// of 128 (256: the 250-feature mirror), 64 with the 64-byte swizzle where
// it is a multiple of 64 (the 50-feature mirror), else 32 with the 32-byte
// swizzle (widths 32, 96); one K step is 32 bytes in every case.  The s32
// accumulator fragment has the f32 layout.  Two orientations:
//   - up to 64 queries (phase_a_i8_tc): the item rows are the M side (two
//     consumer warpgroups of 64 rows) and the queries the N side (N = 8,
//     16, 32 or 64), two thread blocks per SM; the epilogue adds the
//     penalty, reduces over the thread's two rows, over the eight lanes
//     that share a column with a halving butterfly of shuffles, then over
//     the eight warps through shared memory.
//   - above 64 queries (phase_a_i8_tq): the queries are the M side, an
//     m-tile of 64 queries for each of four consumer warpgroups, so the
//     rows of a block pass through the ring once for the whole tile of
//     256 queries; the 128 rows of a block are the N side, so a block's
//     max is over the thread's own 64 accumulator columns and then four
//     lanes: one DPX add-max per value and two shuffles per query, where
//     the other orientation at N = 256 takes about four instructions per
//     value (its butterfly).  The warpgroups wait on the ring
//     independently, so one's epilogue overlaps another's products.  A
//     producer warpgroup, whose registers setmaxnreg moves to the
//     consumers.  The block's penalty and buckets come a block ahead by
//     cp.async into each warp's own shared memory.
// The LSH replacement is applied per (row, query) in both.  A zero query
// row gives 0 (or the penalty) on every block; the bound epilogue turns
// it into -inf.
//
// The kernel needs N % 128 == 0 and a width that is a multiple of 32
// bytes, at most 256; it launches on the caller's stream, allocates
// nothing and does not synchronise.

#include "hopper.cuh"
#include "wgmma_s8.cuh"

namespace {

constexpr int BS = 128;  // rows per item block (_BLOCK_ROWS)
constexpr int32_t I8_PENALTY = -(1 << 29);

namespace tc {

constexpr int CONSUMERS = 256;  // two warpgroups of 64 rows each
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int MAX_STAGES = 8;

// Shared memory of one thread block, from a 1024-byte aligned base: the
// ring (stages of 128 rows x CB bytes), the query tile (W / CB chunks of
// N rows x CB bytes), the cross-warp maxima of two blocks in turn, the
// query buckets, barriers.
inline size_t smem_bytes(int n, int cb, int stages, int W) {
  return 1024 + (size_t)stages * BS * cb + (size_t)W * n + 2 * 8 * n * 4
      + n * 4 + (2 * stages + 1) * 8;
}

template <int N, int CB>
__global__ void __launch_bounds__(THREADS, 2)
phase_a_i8_tc(const __grid_constant__ CUtensorMap ymap,
              const __grid_constant__ CUtensorMap qmap,
              const int32_t* __restrict__ penalty,
              const int32_t* __restrict__ buckets,
              const int32_t* __restrict__ target, int32_t* __restrict__ out,
              int n_blocks, int W, int q0, int B, int max_bits, int stages) {
  constexpr int STAGE = BS * CB, QCHUNK = N * CB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int nk = W / CB;
  uint8_t* qs = ring + (size_t)stages * STAGE;
  int32_t* red = reinterpret_cast<int32_t*>(qs + (size_t)nk * QCHUNK);
  int32_t* tgt = red + 2 * 8 * N;
  uint64_t* full = reinterpret_cast<uint64_t*>(tgt + N);
  uint64_t* empty = full + stages;
  uint64_t* qbar = empty + stages;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < N) tgt[tid] = (buckets && q0 + tid < B) ? target[q0 + tid] : 0;
  __syncthreads();

  if (tid >= CONSUMERS) {
    // producer: one lane issues every copy
    if (tid == CONSUMERS) {
      mbar_expect_tx(qbar, (uint32_t)(nk * QCHUNK));
      for (int c = 0; c < nk; ++c)
        tma_load(qs + (size_t)c * QCHUNK, &qmap, qbar, c * CB, q0);
      int s = 0;
      uint32_t phase = 0;
      for (int blk = blockIdx.x; blk < n_blocks; blk += gridDim.x) {
        for (int c = 0; c < nk; ++c) {
          mbar_wait(&empty[s], phase ^ 1);
          mbar_expect_tx(&full[s], STAGE);
          tma_load(ring + (size_t)s * STAGE, &ymap, &full[s], c * CB,
                   blk * BS);
          if (++s == stages) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg takes rows [64 wg, 64 wg + 64) of each block
  const int wg = tid / 128, warp = tid / 32, lane = tid % 32;
  const int row_in = wg * 64 + (warp % 4) * 16 + lane / 4;  // and +8
  constexpr int V = N / 4;  // columns of this thread after the row max
  int32_t acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0;
  mbar_wait(qbar, 0);
  int s = 0, p = 0;
  uint32_t phase = 0;
  for (int blk = blockIdx.x; blk < n_blocks; blk += gridDim.x) {
    const size_t r0 = (size_t)blk * BS + row_in;
    const int32_t pen0 = penalty[r0], pen1 = penalty[r0 + 8];
    const int32_t bk0 = buckets ? buckets[r0] : 0;
    const int32_t bk1 = buckets ? buckets[r0 + 8] : 0;
    int prev = -1;
    for (int c = 0; c < nk; ++c) {
      mbar_wait(&full[s], phase);
      wg_fence();
      const uint64_t da = desc<CB>(ring + (size_t)s * STAGE + wg * 64 * CB);
      const uint64_t db = desc<CB>(qs + (size_t)c * QCHUNK);
#pragma unroll
      for (int kk = 0; kk < CB / 32; ++kk)  // 32 bytes = 2 units per step
        WgmmaS8<N>::mma(acc, da + 2 * kk, db + 2 * kk, (c | kk) != 0);
      wg_commit();
      if (prev >= 0) {
        // the previous stage's products are done: hand its slot back
        wg_wait<1>();
        if (tid % 128 == 0) mbar_arrive(&empty[prev]);
      }
      prev = s;
      if (++s == stages) {
        s = 0;
        phase ^= 1;
      }
    }
    wg_wait<0>();
    if (tid % 128 == 0) mbar_arrive(&empty[prev]);

    // epilogue: fragment value 4n + 2i + j is row row_in + 8i, column
    // 8n + 2 (lane % 4) + j
    int32_t v[V];
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        int32_t s0 = acc[4 * n + j] + pen0;
        int32_t s1 = acc[4 * n + 2 + j] + pen1;
        if (buckets) {
          const int32_t t = tgt[8 * n + 2 * (lane % 4) + j];
          if (__popc(bk0 ^ t) > max_bits) s0 = I8_PENALTY;
          if (__popc(bk1 ^ t) > max_bits) s1 = I8_PENALTY;
        }
        v[2 * n + j] = max(s0, s1);
      }
    }
    // over the eight lanes of one lane % 4 (the warp's 16 rows)
    int base = 0;
    bfly<V, 16>(v, lane, base);
    bfly<halve(V), 8>(v, lane, base);
    bfly<halve(halve(V)), 4>(v, lane, base);
    constexpr int V3 = halve(halve(halve(V)));
    int32_t* rd = red + (p * 8 + warp) * N;
#pragma unroll
    for (int k = 0; k < V3; ++k) {
      const int cc = base + k;
      rd[(cc / 2) * 8 + 2 * (lane % 4) + cc % 2] = v[k];
    }
    // over the eight warps; the maxima of two blocks alternate, so one
    // barrier per block keeps a buffer from being rewritten while read
    asm volatile("bar.sync 1, %0;\n" :: "n"(CONSUMERS) : "memory");
    for (int t = tid; t < N; t += CONSUMERS) {
      if (q0 + t < B) {
        const int32_t* rp = red + p * 8 * N + t;
        int32_t m = rp[0];
#pragma unroll
        for (int w = 1; w < 8; ++w) m = max(m, rp[w * N]);
        out[(size_t)(q0 + t) * n_blocks + blk] = m;
      }
    }
    p ^= 1;
  }
}

}  // namespace tc

// ---------------------------------------------------------------------------
// windows above 64 queries: the queries are the M side

namespace tq {

// four consumer warpgroups, each an m-tile of 64 queries against the 128
// rows of a stage (N = 128), so a block's max is over one thread's own
// accumulator columns and four lanes; the warpgroups wait on the ring
// independently, so one's epilogue overlaps another's products.  A
// producer warpgroup, whose registers go to the consumers (setmaxnreg; a
// lone producer warp cannot give enough, phase_a.cu)
constexpr int NWG = 4;
constexpr int CONSUMERS = 128 * NWG;
constexpr int THREADS = CONSUMERS + 128;
constexpr int QT = 64 * NWG;  // queries of the tile

// the ring, the query tile (W / CB chunks of QT rows x CB bytes), each
// consumer warp's two copies of a block's penalty and buckets, barriers
inline size_t smem_bytes(int cb, int stages, int W) {
  return 1024 + (size_t)stages * BS * cb + (size_t)W * QT
      + (size_t)4 * NWG * 2 * 2 * BS * 4 + (2 * stages + 1) * 8;
}

// every query of the grid's tile meets a block's rows in one trip
// through the ring
template <int CB>
__global__ void __launch_bounds__(THREADS, 1)
phase_a_i8_tq(const __grid_constant__ CUtensorMap ymap,
              const __grid_constant__ CUtensorMap qmap,
              const int32_t* __restrict__ penalty,
              const int32_t* __restrict__ buckets,
              const int32_t* __restrict__ target, int32_t* __restrict__ out,
              int n_blocks, int W, int q0, int B, int max_bits,
              int stages) {
  constexpr int STAGE = BS * CB, QCHUNK = QT * CB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int nk = W / CB;
  uint8_t* qs = ring + (size_t)stages * STAGE;
  int32_t* side = reinterpret_cast<int32_t*>(qs + (size_t)nk * QCHUNK);
  uint64_t* full = reinterpret_cast<uint64_t*>(side + 4 * NWG * 2 * 2 * BS);
  uint64_t* empty = full + stages;
  uint64_t* qbar = empty + stages;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      tc::mbar_init(&full[s], 1);
      tc::mbar_init(&empty[s], NWG);  // one arrival per consumer warpgroup
    }
    tc::mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // producer: one lane issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == CONSUMERS) {
      tc::mbar_expect_tx(qbar, (uint32_t)(nk * QCHUNK));
      for (int c = 0; c < nk; ++c)
        tc::tma_load(qs + (size_t)c * QCHUNK, &qmap, qbar, c * CB, q0);
      int s = 0;
      uint32_t phase = 0;
      for (int blk = blockIdx.x; blk < n_blocks; blk += gridDim.x) {
        for (int c = 0; c < nk; ++c) {
          tc::mbar_wait(&empty[s], phase ^ 1);
          tc::mbar_expect_tx(&full[s], STAGE);
          tc::tma_load(ring + (size_t)s * STAGE, &ymap, &full[s], c * CB,
                       blk * BS);
          if (++s == stages) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg takes queries [64 wg, 64 wg + 64) of the
  // tile; fragment value 4n + 2i + j is query 64 wg + 16 (warp % 4) +
  // lane / 4 + 8i, block row 8n + 2 (lane % 4) + j
  asm volatile("setmaxnreg.inc.sync.aligned.u32 112;\n" ::: "memory");
  const int wg = tid / 128, warp = tid / 32, lane = tid % 32;
  const int qrow = q0 + 64 * wg + 16 * (warp % 4) + lane / 4;  // and +8
  int32_t tgt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    tgt[i] = (buckets && qrow + 8 * i < B) ? target[qrow + 8 * i] : 0;
  // this warp's two copies of a block's penalty and buckets, filled by
  // cp.async a block ahead
  int32_t* ws = side + warp * 2 * 2 * BS;
  auto side_of = [&](int blk, int buf) {
    if (blk < n_blocks) {
      int32_t* dst = ws + buf * 2 * BS;
      cp_async16(dst + 4 * lane, penalty + (size_t)blk * BS + 4 * lane);
      if (buckets)
        cp_async16(dst + BS + 4 * lane, buckets + (size_t)blk * BS + 4 * lane);
    }
    cp_async_commit();
  };
  side_of(blockIdx.x, 0);
  int32_t acc[64];
  tc::mbar_wait(qbar, 0);
  int s = 0;
  uint32_t phase = 0;
  int buf = 0;
  for (int blk = blockIdx.x; blk < n_blocks; blk += gridDim.x, buf ^= 1) {
    __syncwarp();  // the warp's reads of the other copy are done
    side_of(blk + gridDim.x, buf ^ 1);
    int prev = -1;
    for (int c = 0; c < nk; ++c) {
      tc::mbar_wait(&full[s], phase);
      tc::wg_fence();
      const uint64_t da = tc::desc<CB>(qs + (size_t)c * QCHUNK
                                       + 64 * wg * CB);
      const uint64_t db = tc::desc<CB>(ring + (size_t)s * STAGE);
#pragma unroll
      for (int kk = 0; kk < CB / 32; ++kk)
        tc::WgmmaS8<128>::mma(acc, da + 2 * kk, db + 2 * kk, (c | kk) != 0);
      tc::wg_commit();
      if (prev >= 0) {
        tc::wg_wait<1>();
        if (tid % 128 == 0) tc::mbar_arrive(&empty[prev]);
      }
      prev = s;
      if (++s == stages) {
        s = 0;
        phase ^= 1;
      }
    }
    tc::wg_wait<0>();
    if (tid % 128 == 0) tc::mbar_arrive(&empty[prev]);

    cp_async_wait<1>();  // this block's copy has landed
    __syncwarp();
    const int32_t* wp = ws + buf * 2 * BS;
    int32_t m[2] = {INT32_MIN, INT32_MIN};
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const int col = 8 * n + 2 * (lane % 4);
      const int2 p2 = *reinterpret_cast<const int2*>(wp + col);
      const int2 b2 = buckets ? *reinterpret_cast<const int2*>(wp + BS + col)
                              : make_int2(0, 0);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int32_t a = acc[4 * n + 2 * i + j], p = j ? p2.y : p2.x;
          if (buckets) {
            const int32_t v = __popc((j ? b2.y : b2.x) ^ tgt[i]) > max_bits
                ? I8_PENALTY : a + p;
            m[i] = max(m[i], v);
          } else {
            m[i] = __viaddmax_s32(a, p, m[i]);  // max(a + p, m), one DPX op
          }
        }
    }
    // over the four lanes of one query (the block's 128 rows)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int32_t v = m[i];
      v = max(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = max(v, __shfl_xor_sync(0xffffffffu, v, 2));
      const int q = qrow + 8 * i;
      if (lane % 4 == 0 && q < B) out[(size_t)q * n_blocks + blk] = v;
    }
  }
  cp_async_wait<0>();
}

}  // namespace tq

// ---------------------------------------------------------------------------
// host side

// bytes per row of a ring stage and of a query chunk: the widest of
// 128, 64, 32 that divides the width (each with its own swizzle)
int chunk_bytes(int W) { return W % 128 == 0 ? 128 : W % 64 == 0 ? 64 : 32; }

// as many ring stages as fit in half the SM's shared memory: two thread
// blocks share an SM
int tc_stages(int n, int cb, int W) {
  const size_t budget = SMEM_LIMIT / 2 - 1024;
  int stages = tc::MAX_STAGES;
  while (stages > 2 && tc::smem_bytes(n, cb, stages, W) > budget) --stages;
  return stages;
}

int tq_stages(int cb, int W) {
  int stages = tc::MAX_STAGES;
  while (stages > 2 && tq::smem_bytes(cb, stages, W) > SMEM_LIMIT)
    --stages;
  return stages;
}

bool encode_i8(CUtensorMap* map, const void* base, int cols, int rows,
               size_t pitch, int box_cols, int box_rows) {
  return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, base, cols,
                      rows, pitch, box_cols, box_rows);
}

// one grid over every block for queries [q0, q0 + min(B - q0, N))
template <int N, int CB>
int launch_tc(const void* y, const void* q, const int32_t* penalty,
              const int32_t* buckets, const int32_t* target, int32_t* out,
              int n_blocks, int W, int q_stride, int q0, int B, int max_bits,
              cudaStream_t stream) {
  auto kernel = tc::phase_a_i8_tc<N, CB>;
  static bool smem_set = false;
  if (const int rc = set_smem(kernel, smem_set)) return rc;
  const int stages = tc_stages(N, CB, W);
  const size_t smem = tc::smem_bytes(N, CB, stages, W);
  if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  CUtensorMap ymap, qmap;
  if (!encode_i8(&ymap, y, W, n_blocks * BS, (size_t)W, CB, BS)
      || !encode_i8(&qmap, q, W, B, (size_t)q_stride, CB, N))
    return (int)cudaErrorInvalidValue;
  const int grid = grid_for(kernel, tc::THREADS, smem, n_blocks);
  kernel<<<grid, tc::THREADS, smem, stream>>>(
      ymap, qmap, penalty, buckets, target, out, n_blocks, W, q0, B,
      max_bits, stages);
  return (int)cudaGetLastError();
}

// one grid over every block for queries [q0, q0 + min(B - q0, 256))
template <int CB>
int launch_tq(const void* y, const void* q, const int32_t* penalty,
              const int32_t* buckets, const int32_t* target, int32_t* out,
              int n_blocks, int W, int q_stride, int q0, int B, int max_bits,
              cudaStream_t stream) {
  auto kernel = tq::phase_a_i8_tq<CB>;
  static bool smem_set = false;
  if (const int rc = set_smem(kernel, smem_set)) return rc;
  const int stages = tq_stages(CB, W);
  const size_t smem = tq::smem_bytes(CB, stages, W);
  if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  CUtensorMap ymap, qmap;
  if (!encode_i8(&ymap, y, W, n_blocks * BS, (size_t)W, CB, BS)
      || !encode_i8(&qmap, q, W, B, (size_t)q_stride, CB, tq::QT))
    return (int)cudaErrorInvalidValue;
  const int grid = grid_for(kernel, tq::THREADS, smem, n_blocks);
  kernel<<<grid, tq::THREADS, smem, stream>>>(
      ymap, qmap, penalty, buckets, target, out, n_blocks, W, q0, B,
      max_bits, stages);
  return (int)cudaGetLastError();
}

// the queries of one tile of up to 256: the M side (m-tiles of 64) above
// 64 queries, else the N side (N = 8 ... 64)
template <int CB>
int launch_tc_tile(const void* y, const void* q, const int32_t* penalty,
                   const int32_t* buckets, const int32_t* target,
                   int32_t* out, int n_blocks, int W, int q_stride, int q0,
                   int B, int max_bits, cudaStream_t s) {
#define ORYX_TC(n)                                                        \
  case n:                                                                 \
    return launch_tc<n, CB>(y, q, penalty, buckets, target, out, n_blocks, \
                            W, q_stride, q0, B, max_bits, s);
  if (B - q0 > 64)
    return launch_tq<CB>(y, q, penalty, buckets, target, out, n_blocks, W,
                         q_stride, q0, B, max_bits, s);
  switch (tc_tile(B - q0)) {
    ORYX_TC(8)
    ORYX_TC(16)
    ORYX_TC(32)
    ORYX_TC(64)
  }
#undef ORYX_TC
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Y8 (n_rows, width) and q8 (n_queries, q_stride) int8, row-major and
// 16-byte aligned; width a multiple of 32, at most 256 and at most
// q_stride; only the first `width` bytes of a q8 row are read.  penalty
// (n_rows / 128, 128) int32; buckets (n_rows,) and target (n_queries,)
// int32, both null for the exact body; fold must be 1 (the folded int8
// mirror has its own entry, csrc/phase_a_i8_fold.cu).  out (n_queries,
// n_rows / 128) int32.  Returns the CUDA error of the launch, 0 on
// success.
extern "C" int oryx_phase_a_i8(const void* y8, const void* q8,
                               const int32_t* penalty,
                               const int32_t* buckets,
                               const int32_t* target, int32_t* out,
                               int n_rows, int width, int q_stride,
                               int n_queries, int max_bits, int fold,
                               void* stream) {
  if (n_rows <= 0 || n_rows % BS || width <= 0 || width > 256 || width % 32
      || q_stride < width || q_stride % 16 || n_queries <= 0 || fold != 1
      || (buckets == nullptr) != (target == nullptr))
    return (int)cudaErrorInvalidValue;
  (void)cudaGetLastError();  // clear a stale error of an earlier call
  const int n_blocks = n_rows / BS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cb = chunk_bytes(width);
  // one grid per tile of up to 256 queries
  for (int q0 = 0; q0 < n_queries; q0 += 256) {
    const int rc = cb == 128
        ? launch_tc_tile<128>(y8, q8, penalty, buckets, target, out,
                              n_blocks, width, q_stride, q0, n_queries,
                              max_bits, s)
        : cb == 64
        ? launch_tc_tile<64>(y8, q8, penalty, buckets, target, out, n_blocks,
                             width, q_stride, q0, n_queries, max_bits, s)
        : launch_tc_tile<32>(y8, q8, penalty, buckets, target, out, n_blocks,
                             width, q_stride, q0, n_queries, max_bits, s);
    if (rc) return rc;
  }
  return 0;
}

// What a launch of oryx_phase_a_i8 with these sizes runs on its first
// query tile, for reports: the orientation (0: queries the N side, 1:
// queries the M side), the queries of the tile (the wgmma N, or 256),
// the bytes per stage row (CB), its ring stages and the dynamic shared
// memory of one thread block.  Returns -1 for sizes the kernel does not
// take.
extern "C" int oryx_phase_a_i8_plan(int width, int n_queries, int* tile,
                                    int* chunk, int* stages, int* smem) {
  if (width <= 0 || width > 256 || width % 32 || n_queries <= 0) return -1;
  *chunk = chunk_bytes(width);
  if (n_queries > 64) {
    *tile = tq::QT;
    *stages = tq_stages(*chunk, width);
    *smem = (int)tq::smem_bytes(*chunk, *stages, width);
    return 1;
  }
  *tile = tc_tile(n_queries);
  *stages = tc_stages(*tile, *chunk, width);
  *smem = (int)tc::smem_bytes(*tile, *chunk, *stages, width);
  return 0;
}
