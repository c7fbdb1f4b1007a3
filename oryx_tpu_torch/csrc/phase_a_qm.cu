// Phase A of the two-phase streaming top-k over a bf16 store, with the
// queries as the wgmma M side: per-block maxima of Q . Y^T.
//
// Replaces variant_b of docs/bench_diag/lsh_mask_probe.py (:67, its
// pallas_call :86), the probe that computes kernel 1's LSH body
// (_batch_top_n_twophase_pallas of oryx_tpu/app/als/serving_model.py) with
// the scores transposed to (queries, rows), so that the per-row bucket
// vector broadcasts once per tile and the block maximum reduces along the
// other axis.  It computes what csrc/phase_a.cu's bf16 body computes, with
// the same arguments: for every 128-row item block `blk` and query `q`
//
//   M[q, blk] = max over rows r of block blk of (Y[r] . Q[q] + penalty[r])
//
// accumulated in float32, penalty[r] 0 for a live row and -inf for a
// retired one; the LSH body first sets to -inf every row whose bucket
// differs from the query's target bucket in more than `max_bits` bits.  A
// fully masked block gives exactly -inf, never NaN.  It serves no route:
// the port's lsh_mask_probe (bench/diag/lsh_mask_probe.py) and
// chip_smoke.py launch it, to compare its orientation with phase_a.cu's.
//
// What bounds it on an H100 SXM (3.35 TB/s HBM, 989 TFLOP/s bf16 dense):
// at the probe's 19,996,672 rows x 128 bf16 and B = 256, 5.12 GB of rows,
// 80 MB of penalty, 80 MB of buckets and 160 MB of maxima, 5.44 GB: 1.624
// ms (1.600 exact); the products are 1.31 TFLOP, 1.33 ms at the data
// sheet's rate but about 1.8 ms at the 701-746 TFLOP/s the card sustains
// under its 700 W limit, where its clock sits at 1.2-1.56 GHz.  So the
// products and the bytes bound it about equally, and the epilogue has to
// hide under them.
//
// Design: wgmma.mma_async m64n128k16, bf16 x bf16 -> f32, both operands
// K-major in shared memory (wgmma_bf16.cuh).  The queries are the M side,
// an m-tile of 64 queries for each of NWG consumer warpgroups (NWG = 1, 2
// or 4 for a tile of up to 64, 128 or 256 queries; rows past B
// zero-filled by TMA), and the 128 rows of a block are the N side of one
// instruction.  A producer (one warp; at NWG = 4 a warpgroup whose
// registers setmaxnreg hands to the consumers, 112 a thread) keeps a ring
// of stages (128 rows x KC columns, KC = 64 with the 128-byte swizzle, or
// 32 with the 64-byte swizzle for widths that are not a multiple of 64)
// full by TMA, and with the block's last stage it copies the block's 128
// penalties (and, in the LSH body, buckets) into that stage's side slot,
// on the same "full" mbarrier.  Persistent thread blocks (one per SM; two
// at NWG <= 2) walk the 128-row blocks, so every block is read from
// device memory once per query tile.
//
// Each warpgroup issues a stage's products as soon as the stage is full,
// one commit group a stage, and hands a stage back once the next stage's
// products are issued and its own are done (wait<1>); it waits for all of
// a block's products only before the epilogue.  Its epilogue overlaps the
// other warpgroups' products (and at NWG <= 2 the other thread block's):
// the tensor cores take the warpgroups' groups one after another, so the
// warpgroups drift apart by a group and no order needs enforcing.  The
// epilogue: each thread keeps its two queries' target buckets in
// registers, reads the penalty (and bucket) of each of its 32 columns
// from the side slot (a broadcast to the eight lanes of a column), adds
// the penalty and, in the LSH body, takes the max only where the ball
// test holds (a predicated max, no select); the exact body is its own
// instantiation and reads and tests no bucket.  Then the max over the
// four lanes of a quad with two shuffles.  The maxima leave block-major,
// (N/128, B): one block's maxima of a warp's 16 queries are 64 contiguous
// bytes, one store; the wrapper returns the (B, N/128) view.
//
// Instructions of the epilogue per accumulator value (cuobjdump -sass of
// nvcc 12.8's build, bench/diag/sass_counts.py --per 64): LSH 5.5-5.6
// (FADD 1, LOP3 1.1, POPC 1, ISETP 1.3-1.4, FMNMX 1.1), exact 2.5-2.6
// (FADD 1, FMNMX 1.1, the rest loop control); the first version, one
// function for both bodies, 8.8 in both (a select and a max more per
// value, the bucket test's branch).
//
// What chose it (one H100 80GB HBM3 at 700 W, LSH at B = 256 on the
// probe's head shape, 19,996,672 x 128; bench/diag/qm_time.py with each
// version first on PYTHONPATH, two alternating runs): the first version
// 3.238-3.245 ms, this kernel 2.586-2.707 (the spread of identical
// builds).  Dropped: a warpgroup handing a block's stages back only after
// all its products, 2.616-2.690 here but up to 7 % slower at width 256
// with 256-300 queries (LSH at B = 300 on 1,048,576 x 256: 0.438-0.444 ms
// against 0.406-0.422); and, timed against each other in an earlier build
// of this kernel that handed stages back that way (same card, medians of
// four rounds): the warpgroups issuing a block in turn, ordered by an
// mbarrier each (ping-pong), 2.702 ms against 2.676 without the order;
// the query-major store of the first version 2.817; a ball test for one
// differing bit without the population count 2.761; two 64-row halves a
// block, the next issued before the current one is reduced, 3.371, since
// ptxas cannot follow the commit groups through the stage loop's runtime
// trip count and injects wgmma waits (C7517, C7519), so no product stays
// in flight through an epilogue.  The LSH body stays about 0.4 ms above
// the exact one: its integer work does not hide under the products.

// The kernel needs N % 128 == 0 and a width that is a multiple of 32
// columns, at most 256; it launches on the caller's stream, allocates
// nothing and does not synchronise.

#include "hopper.cuh"
#include "wgmma_bf16.cuh"

namespace {

constexpr int BS = 128;  // rows per item block (_BLOCK_ROWS)

namespace qm {

constexpr int MAX_STAGES = 8;
// consumer warpgroups of 64 queries each, and one producer warp; at NWG = 4
// a producer warpgroup, whose registers setmaxnreg hands to the consumers
// (a lone warp cannot give enough: 96 registers a thread at 544 threads)
template <int NWG>
constexpr int THREADS = 128 * NWG + (NWG == 4 ? 128 : 32);
// registers of a consumer (producer) thread after setmaxnreg at NWG = 4:
// 512 x 112 + 128 x 24 of the 640 x 96 the launch gives the thread block
constexpr int CONSUMER_REGS = 112, PRODUCER_REGS = 24;
// bytes of one stage's side slot: 128 float penalties, 128 int32 buckets
constexpr int SIDE = 2 * BS * 4;

// Shared memory of one thread block, from a 1024-byte aligned base: the
// ring (stages of 128 rows x KC bf16), the query tile (F / KC chunks of
// 64 NWG rows x KC), the stages' side slots, barriers (full and empty per
// stage, the query tile's).
inline size_t smem_bytes(int nwg, int kc, int stages, int F) {
  return 1024 + (size_t)stages * BS * kc * 2 + (size_t)F * 64 * nwg * 2
      + (size_t)stages * SIDE + (2 * stages + 1) * 8;
}

// the max over this thread's 32 columns of the block, for its two
// queries: value 4n + 2i + j of `acc` is query row i, column 8n + 2 (lane
// % 4) + j; `sp` and `sb` the block's penalties and buckets
template <bool LSH>
__device__ __forceinline__ void block_max(const float* acc, const float* sp,
                                          const int32_t* sb,
                                          const int32_t* tgt, int max_bits,
                                          int lane, float* m) {
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    const int col = 8 * n + 2 * (lane % 4);
    const float2 p2 = *reinterpret_cast<const float2*>(sp + col);
    int2 b2;
    if constexpr (LSH) b2 = *reinterpret_cast<const int2*>(sb + col);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float v = acc[4 * n + 2 * i + j] + (j ? p2.y : p2.x);
        if constexpr (LSH) {
          if (__popc((j ? b2.y : b2.x) ^ tgt[i]) <= max_bits)
            m[i] = fmaxf(m[i], v);
        } else {
          m[i] = fmaxf(m[i], v);
        }
      }
  }
}

template <int NWG, int KC, bool LSH>
__global__ void __launch_bounds__(THREADS<NWG>, NWG <= 2 ? 2 : 1)
phase_a_qm(const __grid_constant__ CUtensorMap ymap,
           const __grid_constant__ CUtensorMap qmap,
           const float* __restrict__ penalty,
           const int32_t* __restrict__ buckets,
           const int32_t* __restrict__ target, float* __restrict__ out,
           int n_blocks, int F, int q0, int B, int max_bits, int stages) {
  constexpr int QT = 64 * NWG;            // queries of the tile
  constexpr int STAGE = BS * KC * 2;      // bytes of one ring stage
  constexpr int QCHUNK = QT * KC * 2;     // bytes of one query chunk
  constexpr int CONSUMERS = 128 * NWG;
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte aligned by indexing the shared array, so that the side
  // slots' reads compile to shared-memory loads (a pointer rebuilt from an
  // integer compiles to generic ones)
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int nk = F / KC;
  uint8_t* qs = ring + (size_t)stages * STAGE;
  uint8_t* side = qs + (size_t)nk * QCHUNK;
  uint64_t* full = reinterpret_cast<uint64_t*>(side + (size_t)stages * SIDE);
  uint64_t* empty = full + stages;
  uint64_t* qbar = empty + stages;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      tc::mbar_init(&full[s], 1);
      tc::mbar_init(&empty[s], 4 * NWG);  // one arrival per consumer warp
    }
    tc::mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {
    // producer: one lane issues every copy
    if constexpr (NWG == 4)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                   :: "n"(PRODUCER_REGS) : "memory");
    if (tid == CONSUMERS) {
      const uint32_t side_bytes = LSH ? SIDE : SIDE / 2;
      tc::mbar_expect_tx(qbar, (uint32_t)(nk * QCHUNK));
      for (int c = 0; c < nk; ++c)
        tc::tma_load(qs + (size_t)c * QCHUNK, &qmap, qbar, c * KC, q0);
      int s = 0;
      uint32_t phase = 0;
      for (int blk = blockIdx.x; blk < n_blocks; blk += gridDim.x) {
        for (int c = 0; c < nk; ++c) {
          tc::mbar_wait(&empty[s], phase ^ 1);
          const bool last = c == nk - 1;
          tc::mbar_expect_tx(&full[s], STAGE + (last ? side_bytes : 0));
          tc::tma_load(ring + (size_t)s * STAGE, &ymap, &full[s], c * KC,
                       blk * BS);
          if (last) {
            uint8_t* sd = side + (size_t)s * SIDE;
            tc::bulk_load(sd, penalty + (size_t)blk * BS, BS * 4, &full[s]);
            if (LSH)
              tc::bulk_load(sd + BS * 4, buckets + (size_t)blk * BS, BS * 4,
                            &full[s]);
          }
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
  if constexpr (NWG == 4)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(CONSUMER_REGS) : "memory");
  // the warpgroup, warp-uniform as the compiler sees it
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int warp = tid / 32, lane = tid % 32;
  const int qrow = q0 + 64 * wg + 16 * (warp % 4) + lane / 4;  // and +8
  int32_t tgt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    tgt[i] = (LSH && qrow + 8 * i < B) ? target[qrow + 8 * i] : 0;
  // this warpgroup's queries in each chunk of the tile
  const uint8_t* qa = qs + (size_t)64 * wg * KC * 2;
  // lanes 0 and 1 of a quad store its two queries' maxima
  const int qst = qrow + 8 * (lane % 4);
  tc::mbar_wait(qbar, 0);
  int s = 0;
  uint32_t phase = 0;

  float acc[64];
  for (int blk = blockIdx.x; blk < n_blocks; blk += gridDim.x) {
    int t = s;
    for (int c = 0; c < nk; ++c) {
      tc::mbar_wait(&full[s], phase);
      tc::wg_fence();
      const uint64_t da = tc::desc<2 * KC>(qa + (size_t)c * QCHUNK);
      const uint64_t db = tc::desc<2 * KC>(ring + (size_t)s * STAGE);
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk)  // 32 bytes = 2 units per step
        tc::Wgmma<128>::mma(acc, da + 2 * kk, db + 2 * kk, (c | kk) != 0);
      tc::wg_commit();
      if (c > 0) {
        // the previous stage's products are done: hand its slot back
        tc::wg_wait<1>();
        __syncwarp();
        if (lane == 0) tc::mbar_arrive(&empty[t]);
      }
      t = s;
      if (++s == stages) {
        s = 0;
        phase ^= 1;
      }
    }
    // the block's last stage goes back once the epilogue has read its
    // side slot
    tc::wg_wait<0>();
    const float* sp = reinterpret_cast<const float*>(side + (size_t)t * SIDE);
    float m[2] = {-INFINITY, -INFINITY};
    block_max<LSH>(acc, sp, reinterpret_cast<const int32_t*>(sp + BS), tgt,
                   max_bits, lane, m);
    __syncwarp();
    if (lane == 0) tc::mbar_arrive(&empty[t]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 1));
      m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 2));
    }
    if (lane % 4 < 2 && qst < B)
      out[(size_t)blk * B + qst] = lane % 4 ? m[1] : m[0];
  }
}

}  // namespace qm

// ---------------------------------------------------------------------------
// host side

// a 2-D bf16 tensor of `rows` rows of `cols` columns, `pitch` bytes apart,
// read in boxes of box_rows x box_cols with a (2 * box_cols)-byte swizzle
bool encode(CUtensorMap* map, const void* base, int cols, int rows,
            size_t pitch, int box_cols, int box_rows) {
  return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, cols,
                      rows, pitch, box_cols, box_rows);
}

// consumer warpgroups for a tile of nq queries
int qm_groups(int nq) { return nq <= 64 ? 1 : nq <= 128 ? 2 : 4; }

// as many ring stages as fit: in half the SM's shared memory at NWG <= 2,
// where two thread blocks share an SM
int qm_stages(int nwg, int kc, int F) {
  const size_t budget = nwg <= 2 ? SMEM_LIMIT / 2 - 1024 : SMEM_LIMIT;
  int stages = qm::MAX_STAGES;
  while (stages > 2 && qm::smem_bytes(nwg, kc, stages, F) > budget) --stages;
  return stages;
}

template <int NWG, int KC, bool LSH>
int launch_qm(const void* y, const void* q, const float* penalty,
              const int32_t* buckets, const int32_t* target, float* out,
              int n_blocks, int F, int q_stride, int q0, int B, int max_bits,
              cudaStream_t stream) {
  auto kernel = qm::phase_a_qm<NWG, KC, LSH>;
  static bool smem_set = false;
  if (const int rc = set_smem(kernel, smem_set)) return rc;
  const int stages = qm_stages(NWG, KC, F);
  const size_t smem = qm::smem_bytes(NWG, KC, stages, F);
  if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  CUtensorMap ymap, qmap;
  if (!encode(&ymap, y, F, n_blocks * BS, (size_t)F * 2, KC, BS)
      || !encode(&qmap, q, F, B, (size_t)q_stride * 2, KC, 64 * NWG))
    return (int)cudaErrorInvalidValue;
  const int grid = grid_for(kernel, qm::THREADS<NWG>, smem, n_blocks);
  kernel<<<grid, qm::THREADS<NWG>, smem, stream>>>(
      ymap, qmap, penalty, buckets, target, out, n_blocks, F, q0, B,
      max_bits, stages);
  return (int)cudaGetLastError();
}

template <int KC, bool LSH>
int launch_tile(const void* y, const void* q, const float* penalty,
                const int32_t* buckets, const int32_t* target, float* out,
                int n_blocks, int F, int q_stride, int q0, int B,
                int max_bits, cudaStream_t s) {
  switch (qm_groups(B - q0)) {
    case 1:
      return launch_qm<1, KC, LSH>(y, q, penalty, buckets, target, out,
                                   n_blocks, F, q_stride, q0, B, max_bits,
                                   s);
    case 2:
      return launch_qm<2, KC, LSH>(y, q, penalty, buckets, target, out,
                                   n_blocks, F, q_stride, q0, B, max_bits,
                                   s);
    default:
      return launch_qm<4, KC, LSH>(y, q, penalty, buckets, target, out,
                                   n_blocks, F, q_stride, q0, B, max_bits,
                                   s);
  }
}

template <bool LSH>
int launch_body(const void* y, const void* q, const float* penalty,
                const int32_t* buckets, const int32_t* target, float* out,
                int n_blocks, int F, int q_stride, int q0, int B,
                int max_bits, cudaStream_t s) {
  return F % 64 == 0
      ? launch_tile<64, LSH>(y, q, penalty, buckets, target, out, n_blocks,
                             F, q_stride, q0, B, max_bits, s)
      : launch_tile<32, LSH>(y, q, penalty, buckets, target, out, n_blocks,
                             F, q_stride, q0, B, max_bits, s);
}

// the kernel instantiation a tile of nq queries at width F runs
template <bool LSH>
const void* kernel_of(int F, int nq) {
  const int nwg = qm_groups(nq);
  if (F % 64 == 0)
    return nwg == 1 ? (const void*)qm::phase_a_qm<1, 64, LSH>
        : nwg == 2 ? (const void*)qm::phase_a_qm<2, 64, LSH>
                   : (const void*)qm::phase_a_qm<4, 64, LSH>;
  return nwg == 1 ? (const void*)qm::phase_a_qm<1, 32, LSH>
      : nwg == 2 ? (const void*)qm::phase_a_qm<2, 32, LSH>
                 : (const void*)qm::phase_a_qm<4, 32, LSH>;
}

}  // namespace

// Y (n_rows, features) and Q (n_queries, q_stride) bfloat16, row-major and
// 16-byte aligned; features a multiple of 32, at most 256 and at most
// q_stride; only the first `features` columns of Q are read.  penalty
// (n_rows / 128, 128) float32; buckets (n_rows,) and target (n_queries,)
// int32, both null for the exact body.  out (n_rows / 128, n_queries)
// float32: block-major, the transpose of the (n_queries, n_rows / 128)
// maxima.  Returns the CUDA error of the launch, 0 on success.
extern "C" int oryx_phase_a_qm(const void* y, const void* q,
                               const float* penalty, const int32_t* buckets,
                               const int32_t* target, float* out, int n_rows,
                               int features, int q_stride, int n_queries,
                               int max_bits, void* stream) {
  if (n_rows <= 0 || n_rows % BS || features <= 0 || features % 32
      || features > 256 || q_stride < features || q_stride % 8
      || n_queries <= 0 || (buckets == nullptr) != (target == nullptr))
    return (int)cudaErrorInvalidValue;
  (void)cudaGetLastError();  // clear a stale error of an earlier call
  const int n_blocks = n_rows / BS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // one grid per tile of up to 256 queries
  for (int q0 = 0; q0 < n_queries; q0 += 256) {
    const int rc = buckets
        ? launch_body<true>(y, q, penalty, buckets, target, out, n_blocks,
                            features, q_stride, q0, n_queries, max_bits, s)
        : launch_body<false>(y, q, penalty, buckets, target, out, n_blocks,
                             features, q_stride, q0, n_queries, max_bits, s);
    if (rc) return rc;
  }
  return 0;
}

// What a launch of oryx_phase_a_qm with these sizes runs on its first
// query tile, for reports: the queries of the tile (64 x the consumer
// warpgroups), the columns per stage row (KC), its ring stages, the
// dynamic shared memory of one thread block, and of that instantiation
// (exact or LSH) the registers of a thread at launch and its local memory
// (bytes a thread spills).  Returns -1 for sizes the kernel does not
// take, or the CUDA error of the attribute query.
extern "C" int oryx_phase_a_qm_plan(int features, int n_queries, int lsh,
                                    int* tile, int* kc, int* stages,
                                    int* smem, int* regs, int* local) {
  if (features <= 0 || features % 32 || features > 256 || n_queries <= 0)
    return -1;
  const int nq = n_queries < 256 ? n_queries : 256;
  const int nwg = qm_groups(nq);
  *tile = 64 * nwg;
  *kc = features % 64 == 0 ? 64 : 32;
  *stages = qm_stages(nwg, *kc, features);
  *smem = (int)qm::smem_bytes(nwg, *kc, *stages, features);
  cudaFuncAttributes attr;
  const void* k = lsh ? kernel_of<true>(features, nq)
                      : kernel_of<false>(features, nq);
  if (const cudaError_t rc = cudaFuncGetAttributes(&attr, k)) return (int)rc;
  *regs = attr.numRegs;
  *local = (int)attr.localSizeBytes;
  return 0;
}
