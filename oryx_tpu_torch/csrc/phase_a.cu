// Phase A of the two-phase streaming top-k over the store: per-block
// maxima of Q . Y^T.
//
// Replaces _batch_top_n_twophase_pallas of oryx_tpu/app/als/serving_model.py
// (the "pallas" kind), both of its bodies.  For every 128-row item block
// `blk` and query `q`:
//
//   M[q, blk] = max over rows r of block blk of (Y[r] . Q[q] + penalty[r])
//
// accumulated in float32, where penalty[r] is 0 for a live row and -inf for
// a retired one.  The LSH body first sets to -inf every row whose bucket
// differs from the query's target bucket in more than `max_bits` bits.
// The scores never reach device memory: only the (B, N/128) maxima do.
// A fully masked block gives exactly -inf (never NaN), and a zero query
// row scores exactly 0 before the penalty.  The folded variant (the "fold"
// kind) is csrc/phase_a_fold.cu.
//
// What bounds it on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s FP32 on the
// CUDA cores, 989 TFLOP/s bf16 dense on the tensor cores), at the served
// store of 5,111,808 rows x 256 columns (250 features padded to 32):
//   - bfloat16: 2.62 GB to read, 0.78 ms; 2 x 5,111,808 x 250 x B flops,
//     0.66 ms at B = 256 on the tensor cores, so bytes bound every window.
//   - float32: 5.23 GB, 1.56 ms, the bound at B <= 32; at B = 256 the
//     654 GFLOP take 9.8 ms on the CUDA cores, so operations bound it.
//
// Two bodies, one per store dtype:
//
// bf16, on the tensor cores (wgmma.mma_async m64nNk16, bf16 x bf16 -> f32).
// The item rows are the 64-row M side, K-major; the query window is the N
// side, N = 8, 16, 32, 64, 128 or 256, its rows past B zero-filled by the
// TMA unit.  Persistent thread blocks (about one per SM, two at N <= 64)
// walk the 128-row blocks: one producer warp keeps a ring of 4-8 stages of
// 128 rows x KC columns (KC = 64 with 128-byte swizzle, or 32 with 64-byte
// swizzle for widths that are not a multiple of 64) filled by TMA, each
// stage with a "full" and an "empty" mbarrier; two consumer warpgroups
// each run wgmma on 64 rows of the stage against the query tile, which
// TMA loads once per thread block.  The epilogue reads the accumulator
// fragment, adds the penalty, applies the LSH test per (row, query),
// reduces over the thread's two rows, then over the eight lanes that
// share a column with a halving butterfly of shuffles, then over the
// eight warps through shared memory.  bf16 x bf16 products are exact in
// float32; the tensor cores sum them in another order than the plain
// version, the divergence that phase B's 1e-4 relative certificate margin
// covers.  Above 256 queries the entry point launches one grid per
// 256-query tile.
//
// float32, on the CUDA cores in full float32 (FFMA, no TF32): phase B's
// exactness certificate holds only if phase A's maxima and phase B's exact
// rescore agree within its 1e-4 relative margin, and TF32 keeps ~3 digits.
// Each dot product is summed with fmaf over columns 0..F-1 in order, the
// order of the plain version's SGEMM, so the two agree bit for bit.  Rows
// and queries sit in shared memory in their row-major layout, row pitch
// padded by 16 bytes so eight consecutive rows fall in eight different
// 16-byte bank groups, and each thread reads float4s along K (4
// consecutive columns, so the column order holds).
//   - B <= 8 ("narrow", bound by bytes): one warp per 128-row block,
//     each lane 4 rows x 8 queries; every warp streams its own blocks
//     through a private cp.async ring of 3 stages of 128 rows x 32
//     columns; the query tile stays in shared memory, read by broadcast.
//   - B > 8 ("wide"): 256 threads per 128-row x WQ-query tile, WQ = 32
//     (B <= 32, 4 x 4 per thread, two thread blocks per SM) or 128 (8 x 8
//     per thread); a cp.async ring of 2 stages of 128 rows x 64 columns
//     (3 x 32 where the width is not a multiple of 64) shared by the
//     thread block, the query tile resident; persistent thread blocks,
//     each on one query tile, so an item block is read by ceil(B / WQ)
//     thread blocks, at about the same time (through L2).
//
// The kernels need N % 128 == 0 and a row width that is a multiple of 32
// columns, at most 256 (the query tile stays in shared memory); they
// launch on the caller's stream, allocate nothing and do not synchronise.
// The TMA descriptors are encoded on the host through
// cudaGetDriverEntryPointByVersion, so the library links no libcuda.
// chip_smoke.py builds this source, phase_a_fold.cu and phase_a_i8.cu in
// parallel in about 9 s (nvcc of CUDA 12.8, on an H100 host).

#include "hopper.cuh"
#include "wgmma_bf16.cuh"

namespace {

constexpr int BS = 128;  // rows per item block (_BLOCK_ROWS)

// ---------------------------------------------------------------------------
// bf16 body: wgmma fed by TMA

namespace tc {

constexpr int CONSUMERS = 256;  // two warpgroups of 64 rows each
// and one producer warp; at N = 256 a whole producer warpgroup, whose
// registers setmaxnreg hands to the consumers
template <int N>
constexpr int THREADS = CONSUMERS + (N == 256 ? 128 : 32);
constexpr int MAX_STAGES = 8;

// Shared memory of one thread block, from a 1024-byte aligned base: the
// ring, the query tile (F / KC chunks of N rows x KC columns), the
// cross-warp maxima of two blocks in turn, the query buckets, barriers.
template <int N, int KC>
struct Smem {
  static constexpr int STAGE = BS * KC * 2;
  static constexpr int QCHUNK = N * KC * 2;
};

__host__ __device__ inline size_t smem_bytes(int n, int kc, int stages,
                                             int F) {
  return 1024 + (size_t)stages * BS * kc * 2 + (size_t)F * n * 2
      + 2 * 8 * n * 4 + n * 4 + (2 * stages + 1) * 8;
}

template <int N, int KC>
__global__ void __launch_bounds__(THREADS<N>, N <= 64 ? 2 : 1)
phase_a_tc(const __grid_constant__ CUtensorMap ymap,
           const __grid_constant__ CUtensorMap qmap,
           const float* __restrict__ penalty,
           const int32_t* __restrict__ buckets,
           const int32_t* __restrict__ target, float* __restrict__ out,
           int n_blocks, int F, int q0, int B, int max_bits, int stages) {
  using S = Smem<N, KC>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int nk = F / KC;
  uint8_t* qs = ring + (size_t)stages * S::STAGE;
  float* red = reinterpret_cast<float*>(qs + (size_t)nk * S::QCHUNK);
  int32_t* tgt = reinterpret_cast<int32_t*>(red + 2 * 8 * N);
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
    // producer: one lane issues every copy.  At N = 256 the accumulators
    // need more registers than an even share: the producer warpgroup
    // gives its up to the consumer warpgroups
    if constexpr (N == 256)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == CONSUMERS) {
      mbar_expect_tx(qbar, (uint32_t)(nk * S::QCHUNK));
      for (int c = 0; c < nk; ++c)
        tma_load(qs + (size_t)c * S::QCHUNK, &qmap, qbar, c * KC, q0);
      int s = 0;
      uint32_t phase = 0;
      for (int blk = blockIdx.x; blk < n_blocks; blk += gridDim.x) {
        for (int c = 0; c < nk; ++c) {
          mbar_wait(&empty[s], phase ^ 1);
          mbar_expect_tx(&full[s], S::STAGE);
          tma_load(ring + (size_t)s * S::STAGE, &ymap, &full[s], c * KC,
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
  if constexpr (N == 256)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = tid / 128, warp = tid / 32, lane = tid % 32;
  const int row_in = wg * 64 + (warp % 4) * 16 + lane / 4;  // and +8
  constexpr int V = N / 4;  // columns of this thread after the row max
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
  mbar_wait(qbar, 0);
  int s = 0, p = 0;
  uint32_t phase = 0;
  for (int blk = blockIdx.x; blk < n_blocks; blk += gridDim.x) {
    const size_t r0 = (size_t)blk * BS + row_in;
    const float pen0 = penalty[r0], pen1 = penalty[r0 + 8];
    const int32_t bk0 = buckets ? buckets[r0] : 0;
    const int32_t bk1 = buckets ? buckets[r0 + 8] : 0;
    int prev = -1;
    for (int c = 0; c < nk; ++c) {
      mbar_wait(&full[s], phase);
      wg_fence();
      const uint64_t da = desc<2 * KC>(ring + (size_t)s * S::STAGE
                                   + wg * 64 * KC * 2);
      const uint64_t db = desc<2 * KC>(qs + (size_t)c * S::QCHUNK);
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk)  // 32 bytes = 2 units per step
        Wgmma<N>::mma(acc, da + 2 * kk, db + 2 * kk, (c | kk) != 0);
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
    float v[V];
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float s0 = acc[4 * n + j] + pen0;
        float s1 = acc[4 * n + 2 + j] + pen1;
        if (buckets) {
          const int32_t t = tgt[8 * n + 2 * (lane % 4) + j];
          if (__popc(bk0 ^ t) > max_bits) s0 = -INFINITY;
          if (__popc(bk1 ^ t) > max_bits) s1 = -INFINITY;
        }
        v[2 * n + j] = fmaxf(s0, s1);
      }
    }
    // over the eight lanes of one lane % 4 (the warp's 16 rows)
    int base = 0;
    bfly<V, 16>(v, lane, base);
    bfly<halve(V), 8>(v, lane, base);
    bfly<halve(halve(V)), 4>(v, lane, base);
    constexpr int V3 = halve(halve(halve(V)));
    float* rd = red + (p * 8 + warp) * N;
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
        const float* rp = red + p * 8 * N + t;
        float m = rp[0];
#pragma unroll
        for (int w = 1; w < 8; ++w) m = fmaxf(m, rp[w * N]);
        out[(size_t)(q0 + t) * n_blocks + blk] = m;
      }
    }
    p ^= 1;
  }
}

}  // namespace tc

// ---------------------------------------------------------------------------
// float32 body: FFMA from a cp.async ring, column order kept

namespace ffma {

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

// B <= 8: one warp per 128-row block, lane l holds rows l + 32 i (i < 4)
// and every query of the tile; warps stream their blocks independently,
// each through a private ring of stages of 128 rows x 32 columns: whole
// 128-byte row segments, which measured faster than 16-column stages.
constexpr int NQ = 8;                // queries per tile
constexpr int NW = 4;                // warps per thread block
constexpr int NSTAGES = 3;           // ring stages per warp
constexpr int NKC = 32;              // columns per stage
constexpr int NPITCH = NKC + 4;      // floats per row in a stage
constexpr int NSTAGE = BS * NPITCH;  // floats per stage

inline size_t narrow_smem(int F) {
  return ((size_t)NQ * F + NQ + (size_t)NW * NSTAGES * NSTAGE) * 4;
}

__global__ void __launch_bounds__(NW * 32, 1)
phase_a_narrow(const float* __restrict__ Y, const float* __restrict__ Q,
               const float* __restrict__ penalty,
               const int32_t* __restrict__ buckets,
               const int32_t* __restrict__ target, float* __restrict__ out,
               int n_blocks, int F, int q_stride, int B, int max_bits) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // NQ x F
  int32_t* tgt = reinterpret_cast<int32_t*>(qs + NQ * F);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* ring = reinterpret_cast<float*>(tgt + NQ)
      + (size_t)warp * NSTAGES * NSTAGE;

  for (int i = tid; i < NQ * F / 4; i += NW * 32) {
    const int q = i / (F / 4), c4 = i % (F / 4);
    reinterpret_cast<float4*>(qs)[i] = q < B
        ? *reinterpret_cast<const float4*>(Q + (size_t)q * q_stride + 4 * c4)
        : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (tid < NQ) tgt[tid] = (buckets && tid < B) ? target[tid] : 0;
  __syncthreads();

  const int nk = F / NKC;
  const int gw = blockIdx.x * NW + warp, nw = gridDim.x * NW;
  const int mine = gw < n_blocks ? (n_blocks - 1 - gw) / nw + 1 : 0;
  const int total = mine * nk;
  // stage t: chunk t % nk of this warp's block t / nk, in slot t % NSTAGES
  auto issue = [&](int t) {
    if (t < total) {
      const int blk = gw + (t / nk) * nw, c = t % nk;
      const float* src = Y + (size_t)blk * BS * F + c * NKC;
      float* dst = ring + (t % NSTAGES) * NSTAGE;
#pragma unroll
      for (int i = 0; i < BS * NKC / 4 / 32; ++i) {
        const int idx = lane + 32 * i;
        const int r = idx / (NKC / 4), c4 = idx % (NKC / 4);
        cp_async16(dst + r * NPITCH + 4 * c4, src + (size_t)r * F + 4 * c4);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
#pragma unroll
  for (int t = 0; t < NSTAGES - 1; ++t) issue(t);

  float acc[4][NQ];
  float pen[4];
  int32_t bkt[4];
  for (int t = 0; t < total; ++t) {
    const int c = t % nk;
    const int blk = gw + (t / nk) * nw;
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const size_t r = (size_t)blk * BS + lane + 32 * i;
        pen[i] = penalty[r];
        bkt[i] = buckets ? buckets[r] : 0;
#pragma unroll
        for (int j = 0; j < NQ; ++j) acc[i][j] = 0.0f;
      }
    }
    cp_async_wait<NSTAGES - 2>();
    __syncwarp();
    issue(t + NSTAGES - 1);  // into the slot the warp read at t - 1
    const float* ys = ring + (t % NSTAGES) * NSTAGE;
    const float* qc = qs + c * NKC;
#pragma unroll
    for (int k4 = 0; k4 < NKC / 4; ++k4) {
      float4 a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(
            ys + (lane + 32 * i) * NPITCH + 4 * k4);
      float4 b[NQ];
#pragma unroll
      for (int j = 0; j < NQ; ++j)
        b[j] = *reinterpret_cast<const float4*>(qc + j * F + 4 * k4);
      fma_tile(acc, a, b);
    }
    if (c == nk - 1) {
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
  }
  cp_async_wait<0>();
}

// 8 < B: a 128-row x WQ-query tile per step (WQ = 32 up to 32 queries,
// else 128), 256 threads; thread (rg, qg) = (tid % RG, tid / RG) holds
// rows rg + RG i (i < TM) and queries qg + QG j (j < TN): 8 x 8 at
// WQ = 128, 4 x 4 at WQ = 32, where two thread blocks share an SM.  A
// stage holds KC = 64 columns (2 stages) where the width allows, else 32
// (3 stages): fewer, longer stages between barriers measured faster.
constexpr int WT = 256;
// the penalty and buckets of a block come with its first stage, into one
// of SIDE_SLOTS buffers of 2 x 128 words, and are read at its epilogue
constexpr int SIDE_SLOTS = 4;

template <int WQ, int KC>
struct Wide {
  static constexpr int RG = WQ == 32 ? 32 : 16;  // row groups
  static constexpr int TM = BS / RG;
  static constexpr int QG = WT / RG;             // query groups
  static constexpr int TN = WQ / QG;
  static constexpr int PER_SM = WQ == 128 ? 1 : 2;
  static constexpr int PITCH = KC + 4;           // floats per staged row
  static constexpr int STAGE = BS * PITCH;       // floats per stage
  static constexpr int STAGES = KC == 64 ? 2 : 3;
  static_assert(TN * QG == WQ && TM * RG == BS, "thread tile");
};

template <int WQ, int KC>
size_t wide_smem(int F) {
  using T = Wide<WQ, KC>;
  return ((size_t)WQ * (F + 4) + WQ + (size_t)T::STAGES * T::STAGE
          + SIDE_SLOTS * 2 * BS) * 4;
}

template <int WQ, int KC>
__global__ void __launch_bounds__(WT, Wide<WQ, KC>::PER_SM)
phase_a_wide(const float* __restrict__ Y, const float* __restrict__ Q,
             const float* __restrict__ penalty,
             const int32_t* __restrict__ buckets,
             const int32_t* __restrict__ target, float* __restrict__ out,
             int n_blocks, int F, int q_stride, int B, int max_bits,
             int n_qt) {
  using T = Wide<WQ, KC>;
  constexpr int RG = T::RG, TM = T::TM, QG = T::QG, TN = T::TN;
  constexpr int PITCH = T::PITCH, STAGE = T::STAGE, STAGES = T::STAGES;
  extern __shared__ float4 smem4[];
  const int qpitch = F + 4;
  float* qs = reinterpret_cast<float*>(smem4);  // WQ x (F + 4)
  int32_t* tgt = reinterpret_cast<int32_t*>(qs + WQ * qpitch);
  float* ring = reinterpret_cast<float*>(tgt + WQ);
  float* side = ring + STAGES * STAGE;
  const int tid = threadIdx.x, lane = tid % 32;
  const int rg = tid % RG, qg = tid / RG;
  // thread block b works on query tile b % n_qt, item blocks
  // b / n_qt + k * (gridDim.x / n_qt)
  const int q0 = (blockIdx.x % n_qt) * WQ;
  const int first = blockIdx.x / n_qt, stride = gridDim.x / n_qt;

  for (int i = tid; i < WQ * F / 4; i += WT) {
    const int q = i / (F / 4), c4 = i % (F / 4);
    *reinterpret_cast<float4*>(qs + q * qpitch + 4 * c4) = q0 + q < B
        ? *reinterpret_cast<const float4*>(
              Q + (size_t)(q0 + q) * q_stride + 4 * c4)
        : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (tid < WQ) tgt[tid] = (buckets && q0 + tid < B) ? target[q0 + tid] : 0;
  __syncthreads();

  const int nk = F / KC;
  const int mine = first < n_blocks ? (n_blocks - 1 - first) / stride + 1 : 0;
  const int total = mine * nk;
  auto issue = [&](int t) {
    if (t < total) {
      const int blk = first + (t / nk) * stride, c = t % nk;
      const float* src = Y + (size_t)blk * BS * F + c * KC;
      float* dst = ring + (t % STAGES) * STAGE;
#pragma unroll
      for (int i = 0; i < BS * KC / 4 / WT; ++i) {
        const int idx = tid + WT * i, r = idx / (KC / 4), c4 = idx % (KC / 4);
        cp_async16(dst + r * PITCH + 4 * c4, src + (size_t)r * F + 4 * c4);
      }
      if (c == 0 && tid < (buckets ? 64 : 32)) {
        float* sd = side + ((t / nk) % SIDE_SLOTS) * 2 * BS;
        if (tid < 32)
          cp_async16(sd + 4 * tid, penalty + (size_t)blk * BS + 4 * tid);
        else
          cp_async16(sd + BS + 4 * (tid - 32),
                     buckets + (size_t)blk * BS + 4 * (tid - 32));
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) issue(t);

  float acc[TM][TN];
  for (int t = 0; t < total; ++t) {
    const int c = t % nk;
    const int blk = first + (t / nk) * stride;
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
    }
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    issue(t + STAGES - 1);  // into the slot every thread read at t - 1
    const float* ys = ring + (t % STAGES) * STAGE;
    const float* qc = qs + c * KC;
#pragma unroll
    for (int k4 = 0; k4 < KC / 4; ++k4) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(
            ys + (rg + RG * i) * PITCH + 4 * k4);
      float4 b[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j)
        b[j] = *reinterpret_cast<const float4*>(
            qc + (qg + QG * j) * qpitch + 4 * k4);
      fma_tile(acc, a, b);
    }
    if (c == nk - 1) {
      // the side inputs came with the block's first stage
      const float* sd = side + ((t / nk) % SIDE_SLOTS) * 2 * BS;
      float pen[TM];
      int32_t bkt[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        pen[i] = sd[rg + RG * i];
        bkt[i] = reinterpret_cast<const int32_t*>(sd + BS)[rg + RG * i];
      }
      float v[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int32_t tq = tgt[qg + QG * j];
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
      const int q = q0 + qg + QG * base;
      if ((lane & DUP) == 0 && q < B) out[(size_t)q * n_blocks + blk] = v[0];
    }
  }
  cp_async_wait<0>();
}

}  // namespace ffma

// ---------------------------------------------------------------------------
// host side

// a 2-D bf16 tensor of `rows` rows of `cols` columns, `pitch` bytes apart,
// read in boxes of box_rows x box_cols with a (2 * box_cols)-byte swizzle
bool encode(CUtensorMap* map, const void* base, int cols, int rows,
            size_t pitch, int box_cols, int box_rows) {
  return encode_tiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, cols,
                      rows, pitch, box_cols, box_rows);
}

// as many ring stages as fit: in the whole SM's shared memory at n > 64,
// in half of it at n <= 64, where two thread blocks share an SM
int tc_stages(int n, int kc, int F) {
  const size_t budget = n <= 64 ? SMEM_LIMIT / 2 - 1024 : SMEM_LIMIT;
  int stages = tc::MAX_STAGES;
  while (stages > 2 && tc::smem_bytes(n, kc, stages, F) > budget) --stages;
  return stages;
}

// one grid over every block for queries [q0, q0 + min(B - q0, N))
template <int N, int KC>
int launch_tc(const void* y, const void* q, const float* penalty,
              const int32_t* buckets, const int32_t* target, float* out,
              int n_blocks, int F, int q_stride, int q0, int B, int max_bits,
              cudaStream_t stream) {
  auto kernel = tc::phase_a_tc<N, KC>;
  static bool smem_set = false;
  if (const int rc = set_smem(kernel, smem_set)) return rc;
  const int stages = tc_stages(N, KC, F);
  const size_t smem = tc::smem_bytes(N, KC, stages, F);
  if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  CUtensorMap ymap, qmap;
  if (!encode(&ymap, y, F, n_blocks * BS, (size_t)F * 2, KC, BS)
      || !encode(&qmap, q, F, B, (size_t)q_stride * 2, KC, N))
    return (int)cudaErrorInvalidValue;
  const int grid = grid_for(kernel, tc::THREADS<N>, smem, n_blocks);
  kernel<<<grid, tc::THREADS<N>, smem, stream>>>(
      ymap, qmap, penalty, buckets, target, out, n_blocks, F, q0, B,
      max_bits, stages);
  return (int)cudaGetLastError();
}

template <int KC>
int launch_tc_tile(const void* y, const void* q, const float* penalty,
                   const int32_t* buckets, const int32_t* target, float* out,
                   int n_blocks, int F, int q_stride, int q0, int B,
                   int max_bits, cudaStream_t s) {
#define ORYX_TC(n)                                                       \
  case n:                                                                \
    return launch_tc<n, KC>(y, q, penalty, buckets, target, out, n_blocks, \
                            F, q_stride, q0, B, max_bits, s);
  switch (tc_tile(B - q0)) {
    ORYX_TC(8)
    ORYX_TC(16)
    ORYX_TC(32)
    ORYX_TC(64)
    ORYX_TC(128)
    ORYX_TC(256)
  }
#undef ORYX_TC
  return (int)cudaErrorInvalidValue;
}

int launch_narrow(const float* y, const float* q, const float* penalty,
                  const int32_t* buckets, const int32_t* target, float* out,
                  int n_blocks, int F, int q_stride, int B, int max_bits,
                  cudaStream_t stream) {
  auto kernel = ffma::phase_a_narrow;
  constexpr int NW = ffma::NW;
  static bool smem_set = false;
  if (const int rc = set_smem(kernel, smem_set)) return rc;
  const size_t smem = ffma::narrow_smem(F);
  if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const int grid = grid_for(kernel, NW * 32, smem, (n_blocks + NW - 1) / NW);
  kernel<<<grid, NW * 32, smem, stream>>>(
      y, q, penalty, buckets, target, out, n_blocks, F, q_stride, B,
      max_bits);
  return (int)cudaGetLastError();
}

template <int WQ, int KC>
int launch_wide(const float* y, const float* q, const float* penalty,
                const int32_t* buckets, const int32_t* target, float* out,
                int n_blocks, int F, int q_stride, int B, int max_bits,
                cudaStream_t stream) {
  auto kernel = ffma::phase_a_wide<WQ, KC>;
  static bool smem_set = false;
  if (const int rc = set_smem(kernel, smem_set)) return rc;
  const size_t smem = ffma::wide_smem<WQ, KC>(F);
  if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const int n_qt = (B + WQ - 1) / WQ;
  // a whole number of thread blocks per query tile, each tile's blocks
  // over every item block
  int per_tile = grid_for(kernel, ffma::WT, smem, n_blocks * n_qt) / n_qt;
  if (per_tile < 1) per_tile = 1;
  if (per_tile > n_blocks) per_tile = n_blocks;
  kernel<<<per_tile * n_qt, ffma::WT, smem, stream>>>(
      y, q, penalty, buckets, target, out, n_blocks, F, q_stride, B,
      max_bits, n_qt);
  return (int)cudaGetLastError();
}

}  // namespace

// Y (n_rows, features) and Q (n_queries, q_stride), both float32 or both
// bfloat16 (bf16 != 0), row-major and 16-byte aligned; features is a
// multiple of 32 and at most q_stride; only the first `features` columns
// of Q are read.  penalty (n_rows / 128, 128) float32; buckets (n_rows,)
// and target (n_queries,) int32, both null for the exact body; fold must
// be 1 (the folded mirror has its own entry, csrc/phase_a_fold.cu).  out
// (n_queries, n_rows / 128) float32.  Returns the CUDA error of the
// launch, 0 on success.
extern "C" int oryx_phase_a(const void* y, const void* q,
                            const float* penalty, const int32_t* buckets,
                            const int32_t* target, float* out, int n_rows,
                            int features, int q_stride, int n_queries,
                            int max_bits, int bf16, int fold, void* stream) {
  if (n_rows <= 0 || n_rows % BS || features <= 0 || features % 32
      || q_stride < features || q_stride % (bf16 ? 8 : 4) || n_queries <= 0
      || fold != 1 || (buckets == nullptr) != (target == nullptr))
    return (int)cudaErrorInvalidValue;
  (void)cudaGetLastError();  // clear a stale error of an earlier call
  const int n_blocks = n_rows / BS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    // one grid per tile of up to 256 queries
    for (int q0 = 0; q0 < n_queries; q0 += 256) {
      const int rc = features % 64 == 0
          ? launch_tc_tile<64>(y, q, penalty, buckets, target, out, n_blocks,
                               features, q_stride, q0, n_queries, max_bits,
                               s)
          : launch_tc_tile<32>(y, q, penalty, buckets, target, out, n_blocks,
                               features, q_stride, q0, n_queries, max_bits,
                               s);
      if (rc) return rc;
    }
    return 0;
  }
  const float* yf = static_cast<const float*>(y);
  const float* qf = static_cast<const float*>(q);
  if (n_queries <= ffma::NQ)
    return launch_narrow(yf, qf, penalty, buckets, target, out, n_blocks,
                         features, q_stride, n_queries, max_bits, s);
  const bool k64 = features % 64 == 0;
  if (n_queries <= 32)
    return k64 ? launch_wide<32, 64>(yf, qf, penalty, buckets, target, out,
                                     n_blocks, features, q_stride, n_queries,
                                     max_bits, s)
               : launch_wide<32, 32>(yf, qf, penalty, buckets, target, out,
                                     n_blocks, features, q_stride, n_queries,
                                     max_bits, s);
  return k64 ? launch_wide<128, 64>(yf, qf, penalty, buckets, target, out,
                                    n_blocks, features, q_stride, n_queries,
                                    max_bits, s)
             : launch_wide<128, 32>(yf, qf, penalty, buckets, target, out,
                                    n_blocks, features, q_stride, n_queries,
                                    max_bits, s);
}

// What a launch of oryx_phase_a with these sizes runs, for reports: the
// body (0 wgmma, 1 narrow FFMA, 2 wide FFMA), its tile (the wgmma N of
// the first query tile, or the queries per FFMA tile), its ring stages
// and the dynamic shared memory of one thread block.
extern "C" int oryx_phase_a_plan(int features, int n_queries, int bf16,
                                 int* tile, int* stages, int* smem) {
  if (features <= 0 || features % 32 || n_queries <= 0)
    return -1;
  if (bf16) {
    const int kc = features % 64 == 0 ? 64 : 32;
    *tile = tc_tile(n_queries);
    *stages = tc_stages(*tile, kc, features);
    *smem = (int)tc::smem_bytes(*tile, kc, *stages, features);
    return 0;
  }
  if (n_queries <= ffma::NQ) {
    *tile = ffma::NQ;
    *stages = ffma::NSTAGES;
    *smem = (int)ffma::narrow_smem(features);
    return 1;
  }
  const bool k64 = features % 64 == 0;
  *tile = n_queries <= 32 ? 32 : 128;
  *stages = k64 ? ffma::Wide<128, 64>::STAGES : ffma::Wide<128, 32>::STAGES;
  *smem = (int)(*tile == 32
                    ? (k64 ? ffma::wide_smem<32, 64>(features)
                           : ffma::wide_smem<32, 32>(features))
                    : (k64 ? ffma::wide_smem<128, 64>(features)
                           : ffma::wide_smem<128, 32>(features)));
  return 2;
}
