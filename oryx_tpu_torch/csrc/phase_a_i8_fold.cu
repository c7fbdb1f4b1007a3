// Phase A of the two-phase streaming top-k on the folded int8 mirror:
// per-block maxima of the integer products Y8 . q8^T, on the tensor cores.
//
// Replaces _batch_top_n_twophase_pallas_i8_fold of
// oryx_tpu/app/als/serving_model.py (the "i8_fold" kind), both of its
// bodies.  For every 128-row item block `blk` and query `q`:
//
//   M[q, blk] = max over rows r of block blk of (Y8[r] . q8[q] + penalty[r])
//
// in int32, where penalty[r] is 0 for a live row and _I8_PENALTY = -2^29
// for a retired one.  The LSH body REPLACES the score of every row whose
// bucket differs from the query's target bucket in more than `max_bits`
// bits with _I8_PENALTY (it does not add it: a row both retired and
// outside the ball would otherwise reach another maximum).  The tensor
// cores sum int8 products exactly in int32, so the maxima equal the plain
// version's, and phase_a_i8's on the unfolded mirror, bit for bit.  The
// float32 upper bounds phase B selects on are made from them by torch code
// (the bound epilogue), as the reference makes them outside its kernel.
//
// Folded mirror.  `fold` logical rows share one physical row of W = 32
// bytes: logical row i*fold + j occupies bytes [j*w, j*w + w), w = W /
// fold (fold 2: w = 16, up to 16 features; fold 4: w = 8, up to 8).  The
// penalty and the buckets are slot-major, penalty_f[j, blk, r'] for
// block row r'*fold + j: for a fixed slot j they run along the physical
// rows.  Every store of the port pads features to 32 columns, so every
// mirror it folds has 32-byte physical rows; the kernel takes no other.
//
// What bounds it on an H100 SXM (3.35 TB/s HBM; 1,979 TOPS int8 dense on
// the tensor cores), at the served shape, 20,054,016 logical rows of 10
// features (fold 2), B = 256:
//   - bytes: mirror 320.9 MB + penalty 80.2 MB + output 160.4 MB, 0.168
//     ms (B = 8: 0.121 ms);
//   - tensor cores: the reference's formulation multiplies each 32-byte
//     physical row by `fold` slot copies of the query, 2 x 10,027,008 x
//     32 x 512 = 3.3e11 operations, 0.166 ms (the slot zeros and padded
//     lanes double the logical work);
//   - epilogue: 20,054,016 x 256 = 5.1e9 (row, query) values, one DPX
//     add-max each in the exact body, about 0.3 ms at the int32 rate; the
//     LSH body adds an xor, a popcount (a quarter-rate instruction), a
//     compare and a select per value.
//
// Design: the reference's own formulation on phase_a_i8.cu's engine.  A
// physical row is one int8 wgmma K step (32 bytes, the 32-byte swizzle).
// The product of a physical row with slot j's copy of a query (the query's
// first w bytes at bytes [j*w, j*w + w), zeros elsewhere) is logical row
// row*fold + j's score.  A ring of stages of 128 physical rows (`fold`
// logical blocks) with their slot-major penalty (and buckets): one TMA
// load of the rows and one bulk copy per slot of each side input, issued
// by one producer lane; persistent thread blocks, so the mirror and its
// penalty pass through the ring once per query tile (one grid per tile).
// The consumers write the slot copies of the query tile into shared
// memory once per thread block, laid out as TMA lays out a tile with the
// 32-byte swizzle (a TMA box of the (B, w) query at column -j*w makes slot
// j at w = 16, but stopped the card with an illegal instruction at w = 8).
// Two orientations, as in phase_a_i8.cu:
//   - small windows (phase_a_i8_fold_tc: fold * QN <= 64 for the wgmma
//     query tile QN of 8, 16 or 32) put the stage's rows on the M side,
//     two consumer warpgroups of 64 rows, and the fold * QN slot-query
//     columns on the N side, slot-major: every thread then holds each of
//     its query columns in every slot, so the max over slots and over its
//     two rows is in registers, then over the eight lanes of a column by a
//     halving butterfly and over the warps of a block through shared
//     memory; two thread blocks per SM.
//   - larger windows (phase_a_i8_fold_tq) put up to 256 queries on the M
//     side, four consumer warpgroups of 64, so a stage passes the ring
//     once per 256 queries: per stage and slot j, one m64n128k32 product
//     of slot j's query copy with the stage's rows, column r' of it
//     logical row r'*fold + j; one DPX add-max per value into running
//     maxima per (query, block, column parity); a halving butterfly over
//     the four lanes of a query row leaves each lane one block's maximum.
//     A warpgroup waits for each product before its epilogue: a second
//     accumulator does not fit its registers (96 for a 640-thread block,
//     112 after the producer warpgroup hands its registers over by
//     setmaxnreg; two m64n64 products in turn spilled and ran slower at
//     B = 256), so the four warpgroups overlap one another's products and
//     epilogues.  A tile of up to 64 (128) queries uses one (two)
//     m-tiles and the warpgroups take the stages in turn (every 4th, 2nd);
//     warps whose queries all lie past B skip the epilogue.
// The LSH replacement is applied per (row, query) in both.  A zero query
// row gives 0 (or the penalty) on every block; the bound epilogue turns it
// into -inf.
//
// The kernel needs N % 128 == 0, fold 2 or 4 with fold * w = 32, and
// 16-byte aligned operands; it launches on the caller's stream, allocates
// nothing and does not synchronise.

#include "hopper.cuh"
#include "wgmma_s8.cuh"

namespace {

constexpr int BS = 128;  // logical rows per item block (_BLOCK_ROWS)
constexpr int32_t I8_PENALTY = -(1 << 29);
constexpr int W = 32;            // bytes of a physical row: one K step
constexpr int ROWS = 128;        // physical rows per ring stage
constexpr int QT = 256;          // queries of a tile
constexpr int MAX_STAGES = 24;

// a stage: the physical rows, then per slot their penalty (and buckets)
__host__ __device__ constexpr int stage_bytes(int fold, bool lsh) {
  return ROWS * W + fold * ROWS * 4 * (lsh ? 2 : 1);
}

// Keeps stage k of the thread block filled: the rows of unit blockIdx.x +
// k * gridDim.x (128 physical rows; the last may be short, its rows past
// the mirror zero-filled), then per slot their penalty (and buckets).
template <int FOLD, bool LSH>
__device__ void produce(const CUtensorMap* ymap,
                        const int32_t* __restrict__ penalty,
                        const int32_t* __restrict__ buckets, uint8_t* ring,
                        uint64_t* full, uint64_t* empty, int stages,
                        int n_phys) {
  constexpr int STAGE = stage_bytes(FOLD, LSH);
  const int n_units = (n_phys + ROWS - 1) / ROWS;
  int k = 0;
  for (int unit = blockIdx.x; unit < n_units; unit += gridDim.x, ++k) {
    const int s = k % stages;
    tc::mbar_wait(&empty[s], ((k / stages) & 1) ^ 1);
    const int rows = min(ROWS, n_phys - unit * ROWS);
    const uint32_t side = (uint32_t)rows * 4;
    tc::mbar_expect_tx(&full[s], ROWS * W + FOLD * side * (LSH ? 2 : 1));
    uint8_t* st = ring + (size_t)s * STAGE;
    tc::tma_load(st, ymap, &full[s], 0, unit * ROWS);
    int32_t* sd = reinterpret_cast<int32_t*>(st + ROWS * W);
#pragma unroll
    for (int j = 0; j < FOLD; ++j) {
      const size_t off = (size_t)j * n_phys + (size_t)unit * ROWS;
      tc::bulk_load(sd + j * ROWS, penalty + off, side, &full[s]);
      if (LSH)
        tc::bulk_load(sd + (FOLD + j) * ROWS, buckets + off, side, &full[s]);
    }
  }
}

// Writes the slot copies of queries [q0, q0 + rows) into qs, slot j's
// `rows` rows at qs + j * rows * W, as TMA stores a tile with the 32-byte
// swizzle (16-byte chunk c of row r at chunk c ^ (r / 4 % 2); rows is a
// multiple of 8): slot j holds bytes [0, w) of the query at [j w, j w + w)
// and zeros elsewhere, and rows past B are zeros.  Then makes them visible
// to the tensor cores.
template <int FOLD>
__device__ void write_slots(uint8_t* qs, int rows,
                            const uint8_t* __restrict__ q8, int q_stride,
                            int q0, int B, int tid, int threads) {
  for (int e = tid; e < FOLD * rows; e += threads) {
    const int j = e / rows, r = e % rows;
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    uint4 v = zero;  // the chunk that holds the slot
    if (q0 + r < B) {
      const uint8_t* src = q8 + (size_t)(q0 + r) * q_stride;
      if (FOLD == 2) {
        v = *reinterpret_cast<const uint4*>(src);
      } else {
        const uint2 h = *reinterpret_cast<const uint2*>(src);
        v = j % 2 ? make_uint4(0u, 0u, h.x, h.y)
                  : make_uint4(h.x, h.y, 0u, 0u);
      }
    }
    const int c = FOLD == 2 ? j : j / 2;  // the chunk's index in the row
    uint8_t* row = qs + (size_t)(j * rows + r) * W;
    const int x = (r >> 2) & 1;
    *reinterpret_cast<uint4*>(row + 16 * (c ^ x)) = v;
    *reinterpret_cast<uint4*>(row + 16 * (c ^ x ^ 1)) = zero;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 1024-byte aligned, indexed from the shared array so that the compiler
// keeps shared-memory loads (a pointer rebuilt from an integer is
// generic)
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// ---------------------------------------------------------------------------
// small windows: the rows are the M side

namespace tc_rows {

constexpr int CONSUMERS = 256;  // two warpgroups of 64 rows each
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp

// the ring, the slot-query tile (fold * qn rows), the cross-warp maxima of
// two stages in turn, barriers
inline size_t smem_bytes(int fold, int qn, bool lsh, int stages) {
  return 1024 + (size_t)stages * stage_bytes(fold, lsh)
      + (size_t)fold * qn * W + 2 * 8 * qn * 4 + 2 * stages * 8;
}

// as many ring stages as fit in half the SM's shared memory: two thread
// blocks share an SM
inline int ring_stages(int fold, int qn, bool lsh) {
  const size_t budget = SMEM_LIMIT / 2 - 1024;
  int stages = MAX_STAGES;
  while (stages > 2 && smem_bytes(fold, qn, lsh, stages) > budget) --stages;
  return stages;
}

template <int FOLD, int QN, bool LSH>
__global__ void __launch_bounds__(THREADS, 2)
phase_a_i8_fold_tc(const __grid_constant__ CUtensorMap ymap,
                   const uint8_t* __restrict__ q8, int q_stride,
                   const int32_t* __restrict__ penalty,
                   const int32_t* __restrict__ buckets,
                   const int32_t* __restrict__ target,
                   int32_t* __restrict__ out, int n_phys, int n_blocks,
                   int q0, int B, int max_bits, int stages) {
  constexpr int N = FOLD * QN;   // slot-query columns, slot-major
  constexpr int STAGE = stage_bytes(FOLD, LSH);
  constexpr int V = QN / 4;      // query columns of a thread
  constexpr int WPB = 8 / FOLD;  // warps of a block (16 rows each)
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = aligned_smem(smem_raw);
  uint8_t* qs = ring + (size_t)stages * STAGE;
  int32_t* red = reinterpret_cast<int32_t*>(qs + N * W);
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 2 * 8 * QN);
  uint64_t* empty = full + stages;
  const int n_units = (n_phys + ROWS - 1) / ROWS;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      tc::mbar_init(&full[s], 1);
      tc::mbar_init(&empty[s], 8);  // each consumer warp arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < CONSUMERS)
    write_slots<FOLD>(qs, QN, q8, q_stride, q0, B, tid, CONSUMERS);
  __syncthreads();

  if (tid >= CONSUMERS) {
    if (tid == CONSUMERS)
      produce<FOLD, LSH>(&ymap, penalty, buckets, ring, full, empty, stages,
                         n_phys);
    return;
  }

  // consumers.  Value 4n + 2i + c of the accumulator is row 16 (warp % 4)
  // + lane / 4 + 8i of the warpgroup's 64 and column 8n + 2t + c: slot
  // (8n + 2t + c) / QN of query column q' = 8 (n % (QN / 8)) + 2t + c.
  const int wg = tid / 128, warp = tid / 32, lane = tid % 32, t = lane % 4;
  const int row0 = 64 * wg + 16 * (warp % 4) + lane / 4;  // and row0 + 8
  int32_t tgt[V];  // targets of this thread's query columns
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int q = q0 + 8 * (k / 2) + 2 * t + k % 2;
    tgt[k] = LSH && q < B ? target[q] : 0;
  }
  int32_t acc[N / 2];
  int p = 0;
  for (int k = 0; blockIdx.x + k * gridDim.x < n_units; ++k, p ^= 1) {
    const int unit = blockIdx.x + k * gridDim.x;
    const int s = k % stages;
    tc::mbar_wait(&full[s], (k / stages) & 1);
    const uint8_t* st = ring + (size_t)s * STAGE;
    const int32_t* sd = reinterpret_cast<const int32_t*>(st + ROWS * W);
    int32_t pen[FOLD][2], bkt[FOLD][2];
#pragma unroll
    for (int j = 0; j < FOLD; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        pen[j][i] = sd[j * ROWS + row0 + 8 * i];
        bkt[j][i] = LSH ? sd[(FOLD + j) * ROWS + row0 + 8 * i] : 0;
      }
    tc::wg_fence();
    tc::WgmmaS8<N>::mma(acc, tc::desc<32>(st + 64 * wg * W),
                        tc::desc<32>(qs), 0);
    tc::wg_commit();
    tc::wg_wait<0>();
    // this warp is done with the stage
    __syncwarp();
    if (lane == 0) tc::mbar_arrive(&empty[s]);

    // the max over slots and the thread's two rows, per query column
    int32_t v[V];
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = INT32_MIN;
#pragma unroll
    for (int j = 0; j < FOLD; ++j)
#pragma unroll
      for (int m = 0; m < QN / 8; ++m)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int32_t a = acc[4 * (j * (QN / 8) + m) + 2 * i + c];
            int32_t& vv = v[2 * m + c];
            if (LSH) {
              const bool far = __popc(bkt[j][i] ^ tgt[2 * m + c]) > max_bits;
              vv = max(vv, far ? I8_PENALTY : a + pen[j][i]);
            } else {
              vv = __viaddmax_s32(a, pen[j][i], vv);
            }
          }
    // over the eight lanes of one lane % 4 (the warp's 16 rows)
    int base = 0;
    bfly<V, 16>(v, lane, base);
    bfly<halve(V), 8>(v, lane, base);
    bfly<halve(halve(V)), 4>(v, lane, base);
    constexpr int V3 = halve(halve(halve(V)));
    int32_t* rd = red + (p * 8 + warp) * QN;
#pragma unroll
    for (int k = 0; k < V3; ++k) {
      const int cc = base + k;
      rd[8 * (cc / 2) + 2 * t + cc % 2] = v[k];
    }
    // over the warps of each block; the maxima of two stages alternate,
    // so one barrier per stage keeps a buffer from being rewritten while
    // read
    asm volatile("bar.sync 1, %0;\n" :: "n"(CONSUMERS) : "memory");
    if (tid < FOLD * QN) {
      const int b = tid / QN, qq = tid % QN;
      const int blk = unit * FOLD + b;
      if (q0 + qq < B && blk < n_blocks) {
        const int32_t* rp = red + (p * 8 + b * WPB) * QN + qq;
        int32_t mx = rp[0];
#pragma unroll
        for (int w = 1; w < WPB; ++w) mx = max(mx, rp[w * QN]);
        out[(size_t)(q0 + qq) * n_blocks + blk] = mx;
      }
    }
  }
}

}  // namespace tc_rows

// ---------------------------------------------------------------------------
// larger windows: the queries are the M side

namespace tq {

constexpr int NWG = 4;           // consumer warpgroups, one m-tile each
constexpr int CONSUMERS = 128 * NWG;
constexpr int THREADS = CONSUMERS + 128;  // and a producer warpgroup
constexpr int QCHUNK = QT * W;   // bytes of one slot's copy of the tile

// the ring, the slot copies of the query tile, barriers
inline size_t smem_bytes(int fold, bool lsh, int stages) {
  return 1024 + (size_t)stages * stage_bytes(fold, lsh)
      + (size_t)fold * QCHUNK + 2 * stages * 8;
}

inline int ring_stages(int fold, bool lsh) {
  int stages = MAX_STAGES;
  while (stages > 2 && smem_bytes(fold, lsh, stages) > SMEM_LIMIT) --stages;
  return stages;
}

// m-tiles of 64 queries a tile of nq queries multiplies
inline int query_groups(int nq) { return nq > 128 ? 4 : nq > 64 ? 2 : 1; }

// `groups` m-tiles of 64 queries in use (1, 2 or 4): warpgroup wg
// multiplies m-tile wg % groups and takes every (4 / groups)-th stage of
// the thread block, from the (wg / groups)-th.
template <int FOLD, bool LSH>
__global__ void __launch_bounds__(THREADS, 1)
phase_a_i8_fold_tq(const __grid_constant__ CUtensorMap ymap,
                   const uint8_t* __restrict__ q8, int q_stride,
                   const int32_t* __restrict__ penalty,
                   const int32_t* __restrict__ buckets,
                   const int32_t* __restrict__ target,
                   int32_t* __restrict__ out, int n_phys, int n_blocks,
                   int q0, int B, int max_bits, int groups, int stages) {
  constexpr int STAGE = stage_bytes(FOLD, LSH);
  // chains of running maxima per (query row, block): two, split by column
  // parity, for the DPX latency of the exact body
  constexpr int CH = LSH ? 1 : 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = aligned_smem(smem_raw);
  uint8_t* qs = ring + (size_t)stages * STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(qs + FOLD * QCHUNK);
  uint64_t* empty = full + stages;
  const int n_units = (n_phys + ROWS - 1) / ROWS;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      tc::mbar_init(&full[s], 1);
      tc::mbar_init(&empty[s], 4 * groups);  // each consumer warp arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < CONSUMERS)
    write_slots<FOLD>(qs, QT, q8, q_stride, q0, B, tid, CONSUMERS);
  __syncthreads();

  if (tid >= CONSUMERS) {
    // the warpgroup's registers go to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 32;\n" ::: "memory");
    if (tid == CONSUMERS)
      produce<FOLD, LSH>(&ymap, penalty, buckets, ring, full, empty, stages,
                         n_phys);
    return;
  }

  // consumers.  Value 4n + 2i + c of the accumulator is query qrow + 8i
  // of the m-tile and physical row 8n + 2t + c of the stage.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 112;\n" ::: "memory");
  const int wg = tid / 128, warp = tid / 32, lane = tid % 32, t = lane % 4;
  const int qg = wg % groups, step = NWG / groups;
  const int qwarp = q0 + 64 * qg + 16 * (warp % 4);
  const int qrow = qwarp + lane / 4;  // and qrow + 8
  const bool live = qwarp < B;  // the warp holds a query of the window
  int32_t tgt[2] = {0, 0};
  if (LSH) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      tgt[i] = qrow + 8 * i < B ? target[qrow + 8 * i] : 0;
  }
  const uint8_t* qa = qs + 64 * qg * W;
  int32_t acc[64];
  for (int k = wg / groups; blockIdx.x + k * gridDim.x < n_units;
       k += step) {
    const int unit = blockIdx.x + k * gridDim.x;
    const int s = k % stages;
    tc::mbar_wait(&full[s], (k / stages) & 1);
    const uint8_t* st = ring + (size_t)s * STAGE;
    const int32_t* sd = reinterpret_cast<const int32_t*>(st + ROWS * W);
    // running maxima per query row i, logical block b of the stage and
    // chain
    int32_t m[2][FOLD][CH];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int b = 0; b < FOLD; ++b)
#pragma unroll
        for (int h = 0; h < CH; ++h) m[i][b][h] = INT32_MIN;

    // one product per slot: slot j's query copy against the stage's 128
    // physical rows, column r' of it logical row r' * FOLD + j of the
    // stage; the epilogue reads it while the other warpgroups multiply
    // (a loop, not unrolled: unrolled, its loads hoisted and spilled)
#pragma unroll 1
    for (int j = 0; j < FOLD; ++j) {
      tc::wg_fence();
      tc::WgmmaS8<128>::mma(acc, tc::desc<32>(qa + j * QCHUNK),
                            tc::desc<32>(st), 0);
      tc::wg_commit();
      tc::wg_wait<0>();
      if (!live) continue;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        const int col = 8 * n + 2 * t;  // physical row of the stage
        const int b = n / (16 / FOLD);  // its block: 128 / FOLD rows each
        const int2 p2 = *reinterpret_cast<const int2*>(sd + j * ROWS + col);
        int2 b2 = make_int2(0, 0);
        if (LSH)
          b2 = *reinterpret_cast<const int2*>(sd + (FOLD + j) * ROWS + col);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int32_t v = acc[4 * n + 2 * i + c];
            const int32_t pen = c ? p2.y : p2.x;
            int32_t& mm = m[i][b][c % CH];
            if (LSH) {
              // outside the ball: more than max_bits bits differ
              const bool far = __popc((c ? b2.y : b2.x) ^ tgt[i]) > max_bits;
              mm = max(mm, far ? I8_PENALTY : v + pen);
            } else {
              mm = __viaddmax_s32(v, pen, mm);
            }
          }
        }
      }
    }
    // this warp is done with the stage's rows and side inputs
    __syncwarp();
    if (lane == 0) tc::mbar_arrive(&empty[s]);
    if (!live) continue;

    // over the four lanes of a query row: lane t ends with the maximum of
    // block `base` of the stage (fold 2: lanes 2t' and 2t' + 1 alike)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      int32_t v[FOLD];
#pragma unroll
      for (int b = 0; b < FOLD; ++b) v[b] = max(m[i][b][0], m[i][b][CH - 1]);
      int base = 0;
      bfly<FOLD, 2>(v, lane, base);
      bfly<FOLD / 2, 1>(v, lane, base);
      const int q = qrow + 8 * i;
      const int blk = unit * FOLD + base;
      if (q < B && blk < n_blocks && (FOLD == 4 || t % 2 == 0))
        out[(size_t)q * n_blocks + blk] = v[0];
    }
  }
}

}  // namespace tq

// ---------------------------------------------------------------------------
// host side

// the wgmma query tile of the rows-as-M kernel for a tile of nq queries
// (8, 16 or 32), or 0 where the queries take the M side: fold * QN must
// stay within 64 columns, whose accumulator fits the registers of two
// thread blocks per SM
inline int rows_tile(int fold, int nq) {
  const int qn = tc_tile(nq);
  return fold * qn <= 64 ? qn : 0;
}

struct Args {
  const CUtensorMap* ymap;
  const uint8_t* q8;
  int q_stride;
  const int32_t *penalty, *buckets, *target;
  int32_t* out;
  int n_phys, n_blocks, q0, B, max_bits;
  cudaStream_t stream;
};

template <int FOLD, int QN, bool LSH>
int launch_tc(const Args& a) {
  auto kernel = tc_rows::phase_a_i8_fold_tc<FOLD, QN, LSH>;
  static bool smem_set = false;
  if (const int rc = set_smem(kernel, smem_set)) return rc;
  const int stages = tc_rows::ring_stages(FOLD, QN, LSH);
  const size_t smem = tc_rows::smem_bytes(FOLD, QN, LSH, stages);
  const int grid = grid_for(kernel, tc_rows::THREADS, smem,
                            (a.n_phys + ROWS - 1) / ROWS);
  kernel<<<grid, tc_rows::THREADS, smem, a.stream>>>(
      *a.ymap, a.q8, a.q_stride, a.penalty, a.buckets, a.target, a.out,
      a.n_phys, a.n_blocks, a.q0, a.B, a.max_bits, stages);
  return (int)cudaGetLastError();
}

template <int FOLD, bool LSH>
int launch_tq(const Args& a) {
  auto kernel = tq::phase_a_i8_fold_tq<FOLD, LSH>;
  static bool smem_set = false;
  if (const int rc = set_smem(kernel, smem_set)) return rc;
  const int stages = tq::ring_stages(FOLD, LSH);
  const size_t smem = tq::smem_bytes(FOLD, LSH, stages);
  const int grid = grid_for(kernel, tq::THREADS, smem,
                            (a.n_phys + ROWS - 1) / ROWS);
  const int nq = a.B - a.q0 < QT ? a.B - a.q0 : QT;
  kernel<<<grid, tq::THREADS, smem, a.stream>>>(
      *a.ymap, a.q8, a.q_stride, a.penalty, a.buckets, a.target, a.out,
      a.n_phys, a.n_blocks, a.q0, a.B, a.max_bits, tq::query_groups(nq),
      stages);
  return (int)cudaGetLastError();
}

// one grid for the queries [q0, q0 + min(B - q0, 256))
template <int FOLD, bool LSH>
int launch_tile(const Args& a) {
  switch (rows_tile(FOLD, a.B - a.q0)) {
    case 8:
      return launch_tc<FOLD, 8, LSH>(a);
    case 16:
      return launch_tc<FOLD, 16, LSH>(a);
    case 32:
      if constexpr (FOLD == 2) return launch_tc<FOLD, 32, LSH>(a);
  }
  return launch_tq<FOLD, LSH>(a);
}

}  // namespace

// Y8f (n_rows / fold, 32) int8, the folded mirror; q8 (n_queries,
// q_stride) int8, of which the first `width` bytes of a row are read;
// fold 2 or 4 and width = 32 / fold (the logical row); penalty (fold,
// n_rows / 128, 128 / fold) int32; buckets of the same layout and target
// (n_queries,), int32, both null for the exact body.  Every operand
// 16-byte aligned, q_stride a multiple of 16.  out (n_queries, n_rows /
// 128) int32.  Returns the CUDA error of the launch, 0 on success.
extern "C" int oryx_phase_a_i8_fold(const void* y8, const void* q8,
                                    const int32_t* penalty,
                                    const int32_t* buckets,
                                    const int32_t* target, int32_t* out,
                                    int n_rows, int width, int q_stride,
                                    int n_queries, int max_bits, int fold,
                                    void* stream) {
  if (n_rows <= 0 || n_rows % BS || (fold != 2 && fold != 4)
      || width * fold != W || q_stride < width || q_stride % 16
      || n_queries <= 0 || (buckets == nullptr) != (target == nullptr))
    return (int)cudaErrorInvalidValue;
  (void)cudaGetLastError();  // clear a stale error of an earlier call
  const int n_phys = n_rows / fold;
  CUtensorMap ymap;
  if (!encode_tiled(&ymap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, y8, W, n_phys,
                    W, W, ROWS))
    return (int)cudaErrorInvalidValue;
  Args a{&ymap, static_cast<const uint8_t*>(q8), q_stride, penalty,
         buckets, target, out, n_phys, n_rows / BS, 0, n_queries, max_bits,
         static_cast<cudaStream_t>(stream)};
  decltype(&launch_tile<2, false>) const runs[2][2] = {
      {launch_tile<2, false>, launch_tile<2, true>},
      {launch_tile<4, false>, launch_tile<4, true>}};
  // one grid per tile of up to 256 queries
  for (a.q0 = 0; a.q0 < n_queries; a.q0 += QT)
    if (const int rc = runs[fold / 4][buckets != nullptr](a)) return rc;
  return 0;
}

// What a launch of oryx_phase_a_i8_fold with these sizes runs on its first
// query tile, for reports: the orientation (0: rows the M side, 1:
// queries the M side), its size (the wgmma query tile QN, or the m-tiles
// of 64 queries in use), its ring stages and the dynamic shared memory of
// one thread block; and the grids (query tiles of up to 256).  Returns -1
// for sizes the kernel does not take.
extern "C" int oryx_phase_a_i8_fold_plan(int fold, int n_queries, int lsh,
                                         int* tiles, int* size, int* stages,
                                         int* smem) {
  if ((fold != 2 && fold != 4) || n_queries <= 0) return -1;
  const int nq = n_queries < QT ? n_queries : QT;
  *tiles = (n_queries + QT - 1) / QT;
  if (const int qn = rows_tile(fold, nq)) {
    *size = qn;
    *stages = tc_rows::ring_stages(fold, qn, lsh != 0);
    *smem = (int)tc_rows::smem_bytes(fold, qn, lsh != 0, *stages);
    return 0;
  }
  *size = tq::query_groups(nq);
  *stages = tq::ring_stages(fold, lsh != 0);
  *smem = (int)tq::smem_bytes(fold, lsh != 0, *stages);
  return 1;
}
