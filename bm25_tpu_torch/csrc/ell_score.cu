// Membership-count ELL scoring kernels for Hopper (sm_90a).
//
// Replaces the two Pallas kernels of bm25_tpu/ops/ell_score.py:
//   * ell_score_pallas (:161)  -> bm25_ell_score        (B2: the plain scan)
//   * ell_score_fused  (:314)  -> bm25_ell_score_fused  (B1: scan + hot
//     split-bf16 products + pad-row mask + maxima of each group of 8 rows)
//
//   base[q, d] = sum_l valT[l, d] * #{t : ids[q, t] == tokT[l, d]}
//
// With per-token weights each match adds w[q, t] instead of 1.
//
// Design.  The layout is slot-major (tokT/valT are (L, rows)), so one
// thread owns one doc row and neighbouring threads read neighbouring
// addresses of every slot: each slot row is one coalesced load.  A block
// is ROWS_PER_BLOCK rows x QT queries; the query tile's ids (and weights)
// sit in shared memory and every compare reads them as a broadcast.  The
// TPU grid walks query tiles and slot tiles in order with the accumulator
// in VMEM; here the slot loop runs inside the thread and the accumulators
// are registers.
//
// Exactness.  The f32 order is the Pallas kernel's: per slot, reduce the
// matches over T (an integer count, or the sum of the matching weights in
// t order), then add count * value to the accumulator with one rounding
// (a fused multiply-add, which is what the JAX kernel compiles to), slots
// ascending from +0; a bucket wider than SLOT_TILE adds the partial sums
// of _slot_tiling's balanced tiles in order.  __fmaf_rn/__fadd_rn pin each
// rounding, so the ELL-only base is bit-equal to the plain PyTorch twin
// and to the JAX kernel.  A slot with no match adds +/-0 to a sum that is
// never -0 (it starts at +0 and round-to-nearest never makes -0 from a
// nonzero sum), so skipping such slots changes no bit.
//
// The hot epilogue adds sum_h hc[q,h]*hi[h,d], then sum_h hc[q,h]*lo[h,d],
// then (split counts) sum_h hc_lo[q,h]*hi[h,d], in the order the Pallas
// kernel adds its dots.  With a hot tier B1 is two launches:
// the scan writes the ELL-only base into out, then ell_hot_kernel reads
// it, adds the three products in that order, applies the pad-row mask and
// writes out and gmax; without one, the scan applies the mask and the
// maxima itself (a hot-only bucket, l_pad == 0, skips the scan: base +0).
//
// ell_hot_kernel runs the products on the tensor cores: wgmma on bf16
// with f32 accumulators.  A product of two bf16 values is exact in f32,
// so only the order of the sums differs from the twin's (held to 2e-5 x
// the row's largest |score|).  The doc rows are wgmma's M and the queries
// its N, so the (H, rows) hot pair is the A operand and the counts the B
// operand, K-major as they lie ((Q, H) rows):
//   - K runs over the hot tokens the chunk uses, not all H: the wrapper's
//     hot plan (ops/ell_score.py::hot_plan, on the device, no host sync)
//     lists the used tokens first and the counts' columns in that order,
//     zero past them, and n_used says how many K steps of HOT_BK run.  A
//     query uses at most T tokens, so an 8-query chunk reads at most 64
//     hot rows where a dense product would read all H.  A block keeps
//     the list in shared memory beside its ring (H up to about 32,000;
//     two blocks fit an SM up to H of about 3,000): a global load per
//     stage put an L2 round trip before each stage's copies.
//   - TMA has no row gather, so a producer warp stages each used hot
//     row's run of the block's HOT_BM doc rows by 16-byte cp.async (one
//     warp instruction copies two rows' 256 bytes), completing on the
//     stage's mbarrier (cp.async.mbarrier.arrive); rows are padded by 16
//     bytes in shared memory.  One 1-D cp.async.bulk a row (64 copies of
//     256 bytes a stage) paced the ring and was markedly slower on an
//     H100; deeper rings were no faster.  The
//     consumers read the rows with ldmatrix.trans straight into wgmma's A
//     fragments (the rows are M-contiguous: the transpose happens on the
//     way into registers).  Rows past n_used and units past the bucket's
//     rows are zero-filled by the copy (a zero count times stale shared
//     memory could be NaN).  The counts come by TMA in the 128-byte
//     swizzle, one box of HOT_BK tokens by BQ queries a stage, E4's
//     descriptor.
//   - A block covers BQ = 128 queries (16 for chunks of at most 16) and
//     HOT_BM = 128 doc rows in two consumer warpgroups, two blocks an SM
//     (three stages each), so one block's base reads, stores and stage
//     hand-offs overlap the other's products; the query blocks of one doc
//     tile are neighbours in the grid, so the hot rows they share come
//     from L2.  One accumulator: each thread's BQ / 2 running sums start
//     at the base and are wgmma's D through every pass (hi, lo, then hi
//     against hc_lo), in that order, streamed through one ring of stages.
//     The sums round where the tensor cores round them, not after each
//     product sum as the twin does; tests/test_torch_cuda.py holds the
//     result within the bound, 64 weighted hot tokens a query included.  Keeping the three sums apart
//     took a second accumulator and so one block an SM, and ran slower
//     on an H100, as did blocks of 256 queries (they spilled).
//
// What bounds it on an H100: the scan is integer compare/add work, ~Q*T*
// slots operations (~1.2e11 at the 524,288-doc headline shape), read from
// shared memory as broadcasts.  The hot epilogue moves the base in and
// out (2 Q rows 4 bytes) and the used hot rows (2 bytes each, twice);
// its dense products (~2 Q n_used rows 2 FLOP) sit well under the bf16
// peak.  The scan is not yet redesigned.
//
// Offsets are int64: q*rows and h*rows pass 2^31 at larger corpora.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include "matmul_ring.cuh"  // mbarriers, TMA, cp.async.bulk, allow_smem
#include "wgmma.cuh"        // wgmma descriptors and fences, swizzled maps

namespace {

constexpr int ROWS_PER_BLOCK = 128;  // one thread per doc row
constexpr int QT = 16;               // queries per block
constexpr int GROUP = 8;             // rows per group maximum

struct EllArgs {
  const int* ids;        // (Q, T)
  const float* weights;  // (Q, T) or null
  int q_count, t_count;
  const int* tokT;       // (L, rows)
  const float* valT;     // (L, rows)
  int l_pad, rows, l_tile;
  const int* doc_ids;  // (rows,); FUSED only
  float* out;          // (Q, rows)
  float* gmax;         // (Q, rows / GROUP); FUSED only
};

// The scan.  FUSED: then the pad-row mask and the group maxima (B1 with no
// hot tier); else the ELL-only base as it is (B2, and B1's first launch
// where a hot tier follows).
template <bool FUSED, bool WEIGHTED>
__global__ void __launch_bounds__(ROWS_PER_BLOCK) ell_kernel(const EllArgs a) {
  // [QT][t_count] ids, then [QT][t_count] weights when WEIGHTED
  extern __shared__ int s_dyn[];
  int* s_ids = s_dyn;
  float* s_w = reinterpret_cast<float*>(s_dyn + QT * a.t_count);

  const int rows = a.rows, t_count = a.t_count;
  const int row = blockIdx.x * ROWS_PER_BLOCK + threadIdx.x;
  const int q0 = blockIdx.y * QT;
  const bool live = row < rows;

  // query pads/OOV (< 0) become -2 so they never match a pad slot (-1);
  // rows of the tile past q_count are all pads
  for (int i = threadIdx.x; i < QT * t_count; i += blockDim.x) {
    const int q = q0 + i / t_count;
    int v = -2;
    float w = 0.0f;
    if (q < a.q_count) {
      const int64_t off = (int64_t)q * t_count + (i % t_count);
      v = a.ids[off];
      if (v < 0) v = -2;
      if constexpr (WEIGHTED) w = a.weights[off];
    }
    s_ids[i] = v;
    if constexpr (WEIGHTED) s_w[i] = w;
  }
  __syncthreads();

  float base[QT];
#pragma unroll
  for (int q = 0; q < QT; ++q) base[q] = 0.0f;

  if (live) {
    for (int l0 = 0; l0 < a.l_pad; l0 += a.l_tile) {
      const int l1 = min(l0 + a.l_tile, a.l_pad);
      float part[QT];
#pragma unroll
      for (int q = 0; q < QT; ++q) part[q] = 0.0f;
      for (int l = l0; l < l1; ++l) {
        const int64_t off = (int64_t)l * rows + row;
        const int tok = a.tokT[off];
        if (tok < 0) continue;  // pad slot: nothing matches
        const float val = a.valT[off];
#pragma unroll
        for (int q = 0; q < QT; ++q) {
          const int* qi = s_ids + q * t_count;
          if constexpr (WEIGHTED) {
            const float* qw = s_w + q * t_count;
            float wsum = 0.0f;
            bool hit = false;
            for (int t = 0; t < t_count; ++t) {
              if (qi[t] == tok) {
                wsum = hit ? __fadd_rn(wsum, qw[t]) : qw[t];
                hit = true;
              }
            }
            if (hit) part[q] = __fmaf_rn(wsum, val, part[q]);
          } else {
            int cnt = 0;
            for (int t = 0; t < t_count; ++t) cnt += (qi[t] == tok);
            if (cnt) part[q] = __fmaf_rn((float)cnt, val, part[q]);
          }
        }
      }
      if (l0 == 0) {
#pragma unroll
        for (int q = 0; q < QT; ++q) base[q] = part[q];
      } else {
#pragma unroll
        for (int q = 0; q < QT; ++q) base[q] = __fadd_rn(base[q], part[q]);
      }
    }
  }

  if constexpr (FUSED) {
    const bool pad_row = !live || a.doc_ids[row] < 0;
    const int64_t groups = rows / GROUP;
#pragma unroll
    for (int q = 0; q < QT; ++q) {
      float v = pad_row ? -CUDART_INF_F : base[q];
      base[q] = v;
      // maxima of 8 neighbouring rows = 8 neighbouring lanes; every lane
      // takes part in the shuffles (rows % 8 == 0, so a group is either
      // all live or all past the end)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
      if (live && (threadIdx.x % GROUP) == 0 && q0 + q < a.q_count)
        a.gmax[(int64_t)(q0 + q) * groups + row / GROUP] = v;
    }
  }

  if (live) {
#pragma unroll
    for (int q = 0; q < QT; ++q)
      if (q0 + q < a.q_count) a.out[(int64_t)(q0 + q) * rows + row] = base[q];
  }
}

template <bool FUSED, bool WEIGHTED>
int launch_scan(const EllArgs& a, cudaStream_t stream) {
  const size_t smem =
      (size_t)QT * a.t_count * (sizeof(int) + (WEIGHTED ? sizeof(float) : 0));
  auto kernel = ell_kernel<FUSED, WEIGHTED>;
  if (int err = allow_smem(kernel, smem)) return err;
  const dim3 grid((a.rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK,
                  (a.q_count + QT - 1) / QT);
  kernel<<<grid, ROWS_PER_BLOCK, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------ B1's hot epilogue --

constexpr int HOT_BK = 64;             // hot tokens a stage: 128 bytes of counts
constexpr int HOT_WG = 2;              // consumer warpgroups, 64 doc rows each
constexpr int HOT_BM = 64 * HOT_WG;    // doc rows a block
constexpr int HOT_CONSUMER_WARPS = 4 * HOT_WG;
constexpr int HOT_THREADS = 32 * (HOT_CONSUMER_WARPS + 1);  // + a producer
constexpr int HOT_LD = 2 * HOT_BM + 16;  // bytes a staged hot row, padded

// BQ queries a block (wgmma's N): 128, or 16 for chunks of at most 16.
template <int BQ>
struct HotShape {
  static constexpr int STAGES = 3;
  static constexpr int MIN_BLOCKS = BQ == 128 ? 2 : 3;
  static constexpr int COUNT_BYTES = BQ * SWIZZLE_ROW_BYTES;  // BQ x HOT_BK
  static constexpr int STAGE_BYTES =
      (COUNT_BYTES + HOT_BK * HOT_LD + 1023) / 1024 * 1024;
  // the ring, its barriers, then the used tokens (at most kp)
  static size_t smem(int kp) {
    return 1024 + (size_t)STAGES * STAGE_BYTES +
           2 * STAGES * sizeof(uint64_t) + (size_t)kp * sizeof(int);
  }
  static_assert(COUNT_BYTES % 1024 == 0, "the hot tile follows aligned");
};

struct HotArgs {
  const float* base;              // (Q, rows) ELL-only base; null: +0
  const __nv_bfloat16* hotT;      // (H, rows) high parts
  const __nv_bfloat16* hotLo;     // (H, rows) residuals
  const int* tokens;              // (H,) the used hot tokens first
  const int* n_used;              // (1,) how many
  const int* doc_ids;             // (rows,)
  int q_count, rows;
  float* out;   // (Q, rows); may be base
  float* gmax;  // (Q, rows / GROUP)
};

// 16 bytes from global to shared memory, or 16 zeros where !valid (the
// source is then not read)
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// One arrival on `bar` once this thread's cp.async copies so far have
// landed (counted in the barrier's initial count: noinc).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d (a warpgroup's 64 doc rows x BQ queries) += A (64 x 16, this warp's
// 16 rows in registers) @ B (16 x BQ, K-major in shared memory); scale_d
// == 0 starts the sum at the product.
template <int BQ>
__device__ __forceinline__ void wgmma_hot(float (&d)[BQ / 2],
                                          const uint32_t (&a)[4],
                                          uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_hot<128>(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WGMMA_REGS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : WGMMA_D64(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_hot<16>(float (&d)[8],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, "
      "0;\n}\n"
      : WGMMA_D8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// Block b: query block b % q_blocks (BQ queries), doc tile b / q_blocks
// (HOT_BM rows).  Warps 0-7 are two consumer warpgroups of 64 doc rows;
// warp 8 is the producer.  Pass 0 sums counts x hi, pass 1 counts x lo,
// pass 2 (SPLIT) counts_lo x hi, each over ceil(n_used / HOT_BK) stages.
template <int BQ, bool SPLIT>
__global__ void __launch_bounds__(HOT_THREADS, HotShape<BQ>::MIN_BLOCKS)
ell_hot_kernel(const __grid_constant__ CUtensorMap map_c,
               const __grid_constant__ CUtensorMap map_clo, const HotArgs a) {
  using S = HotShape<BQ>;
  constexpr int PASSES = SPLIT ? 3 : 2;
  extern __shared__ __align__(16) uint8_t hot_smem[];
  uint8_t* ring = hot_smem + ((1024 - (smem_u32(hot_smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S::STAGES *
                                               S::STAGE_BYTES);
  uint64_t* empty = full + S::STAGES;
  int* s_tok = reinterpret_cast<int*>(empty + S::STAGES);  // [n_used]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q_blocks = (a.q_count + BQ - 1) / BQ;
  const int q0 = (blockIdx.x % q_blocks) * BQ;
  const int64_t d0 = (int64_t)(blockIdx.x / q_blocks) * HOT_BM;
  const int rows = a.rows;
  const int n_used = *a.n_used;
  const int steps = (n_used + HOT_BK - 1) / HOT_BK;  // a pass's stages
  const int total = PASSES * steps;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(&full[s], 33);  // the counts' expect_tx + 32 lanes' copies
      mbar_init(&empty[s], HOT_CONSUMER_WARPS);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the used tokens, read once
  for (int i = threadIdx.x; i < n_used; i += blockDim.x)
    s_tok[i] = __ldg(a.tokens + i);
  __syncthreads();

  if (warp == HOT_CONSUMER_WARPS) {  // the producer warp
    // a lane copies 16-byte unit lane % 16 of rows 2 c + lane / 16, c <
    // 32: a warp's copy is 2 rows x 256 bytes; units past the bucket's
    // rows, and rows past the used tokens, are zeros
    const bool unit_live = d0 + 8 * (lane % 16) < rows;
    for (int t = 0; t < total; ++t) {
      const int slot = t % S::STAGES, pass = t / steps;
      const int k0 = (t % steps) * HOT_BK;
      uint8_t* st = ring + slot * S::STAGE_BYTES;
      uint8_t* hot = st + S::COUNT_BYTES + 16 * (lane % 16);
      const __nv_bfloat16* src = (pass == 1 ? a.hotLo : a.hotT) + d0 +
                                 8 * (lane % 16);
      const int tok_a = k0 + lane < n_used ? s_tok[k0 + lane] : -1;
      const int tok_b = k0 + 32 + lane < n_used ? s_tok[k0 + 32 + lane] : -1;
      if (lane == 0) mbar_wait(&empty[slot], ((t / S::STAGES) & 1) ^ 1);
      __syncwarp();
      if (lane == 0) {
        mbar_expect_tx(&full[slot], S::COUNT_BYTES);
        tma_load(st, pass == 2 ? &map_clo : &map_c, k0, q0, &full[slot]);
      }
#pragma unroll 4
      for (int c = 0; c < HOT_BK / 2; ++c) {
        const int k = 2 * c + lane / 16;
        const int tok = __shfl_sync(0xffffffffu, c < 16 ? tok_a : tok_b,
                                    k % 32);
        const bool valid = tok >= 0 && unit_live;
        cp_async16_zfill(hot + k * HOT_LD,
                         valid ? src + (int64_t)tok * rows : a.hotT, valid);
      }
      cp_async_arrive(&full[slot]);
    }
    return;
  }

  // consumers: warp w holds doc rows d0 + 16 w .. + 15 (warpgroup w / 4);
  // the running sum res, wgmma's accumulator from the base on, holds at
  // res[4 j + 2 h + e] (doc row lane / 4 + 8 h, query 8 j + 2 (lane % 4)
  // + e)
  const int64_t m_lo = d0 + 16 * warp + lane / 4;
  const int qc = q0 + 2 * (lane % 4);
  float res[BQ / 2];
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int64_t m = m_lo + 8 * h;
        const int q = qc + 8 * j + e;
        res[4 * j + 2 * h + e] =
            a.base != nullptr && m < rows && q < a.q_count
                ? a.base[(int64_t)q * rows + m] : 0.0f;
      }
    }
  }
  // lane l gives ldmatrix the row address of matrix l / 8: k = l % 8 (+8
  // for matrices 2, 3), doc rows +8 for matrices 1, 3
  const int a_off = (lane % 8 + 8 * (lane / 16)) * HOT_LD +
                    2 * (16 * warp + 8 * ((lane / 8) % 2));
  const uint64_t db = wgmma_desc(ring);
  for (int t = 0; t < total; ++t) {
    const int slot = t % S::STAGES;
    mbar_wait(&full[slot], (t / S::STAGES) & 1);
    const uint8_t* hot = ring + slot * S::STAGE_BYTES + S::COUNT_BYTES;
    const uint64_t off = (uint64_t)(slot * S::STAGE_BYTES) >> 4;
    // two k16 slices at a time: their A fragments stay live until the
    // wgmma reading them is done, and two blocks an SM leave 96 registers
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t frag[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        ldmatrix_x4_trans(frag[kk],
                          hot + a_off + 16 * (2 * half + kk) * HOT_LD);
      fence_acc(res);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        wgmma_hot<BQ>(res, frag[kk], db + off + 2 * (2 * half + kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(res);
    }
    release_slot(&empty[slot], lane);
  }

  // the pad-row mask, out, then the maxima of each 8 doc rows (the 8
  // lanes of one lane % 4)
  const int64_t groups = rows / GROUP;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t m = m_lo + 8 * h;
    const bool live = m < rows;
    const bool pad = !live || a.doc_ids[m] < 0;
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = qc + 8 * j + e;
        float v = pad ? -CUDART_INF_F : res[4 * j + 2 * h + e];
        if (live && q < a.q_count) a.out[(int64_t)q * rows + m] = v;
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 8));
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 16));
        if (live && lane < 4 && q < a.q_count)
          a.gmax[(int64_t)q * groups + m / GROUP] = v;
      }
    }
  }
}

template <int BQ, bool SPLIT>
int launch_hot(const HotArgs& a, const void* counts, const void* counts_lo,
               int kp, cudaStream_t stream) {
  CUtensorMap map_c, map_clo;
  if (int err = encode_packed(&map_c, counts, a.q_count, kp, true, BQ))
    return err;
  if (int err = encode_packed(&map_clo, SPLIT ? counts_lo : counts,
                              a.q_count, kp, true, BQ))
    return err;
  auto kernel = ell_hot_kernel<BQ, SPLIT>;
  const size_t smem = HotShape<BQ>::smem(kp);
  if (int err = allow_smem(kernel, smem)) return err;
  const int64_t blocks = (int64_t)((a.q_count + BQ - 1) / BQ) *
                         ((a.rows + HOT_BM - 1) / HOT_BM);
  kernel<<<(unsigned)blocks, HOT_THREADS, smem, stream>>>(map_c, map_clo,
                                                          a);
  return (int)cudaGetLastError();
}

int check_scan(const EllArgs& a) {
  if (a.t_count <= 0 || a.l_pad < 0 || (a.l_pad > 0 && a.l_tile <= 0))
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

extern "C" {

const char* bm25_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// B2: (Q, T) ids x (L, rows) slots -> out (Q, rows) f32.
int bm25_ell_score(const int* ids, int q_count, int t_count, const int* tokT,
                   const float* valT, int l_pad, int rows, int l_tile,
                   float* out, void* stream) {
  if (q_count <= 0 || rows <= 0) return 0;
  EllArgs a = {ids, nullptr, q_count, t_count, tokT, valT, l_pad, rows,
               l_tile, nullptr, out, nullptr};
  if (int err = check_scan(a)) return err;
  return launch_scan<false, false>(a, static_cast<cudaStream_t>(stream));
}

// B1: B2 plus optional (Q, T) f32 weights, the pad-row mask from doc_ids
// (rows,) and gmax (Q, rows / 8), and, where h_count > 0, the hot tier:
// the hot plan's (Q, kp) bf16 counts (and their residual), tokens (H,)
// and n_used (1,) x (H, rows) bf16 hi/lo.  l_pad may be 0 (a bucket with
// no cold postings).
int bm25_ell_score_fused(const int* ids, const float* weights, int q_count,
                         int t_count, const int* tokT, const float* valT,
                         int l_pad, int rows, int l_tile, const int* doc_ids,
                         const void* counts, const void* counts_lo, int kp,
                         const int* tokens, const int* n_used,
                         const void* hotT, const void* hotLo, int h_count,
                         float* out, float* gmax, void* stream) {
  if (q_count <= 0 || rows <= 0) return 0;
  if (rows % GROUP) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  EllArgs a = {ids, weights, q_count, t_count, tokT, valT, l_pad, rows,
               l_tile, doc_ids, out, gmax};
  if (int err = check_scan(a)) return err;
  if (h_count <= 0)
    return weights ? launch_scan<true, true>(a, s)
                   : launch_scan<true, false>(a, s);
  if (!counts || !tokens || !n_used || !hotT || !hotLo || kp % HOT_BK ||
      kp < h_count)
    return (int)cudaErrorInvalidValue;
  if (l_pad > 0) {
    const int err = weights ? launch_scan<false, true>(a, s)
                            : launch_scan<false, false>(a, s);
    if (err) return err;
  }
  const HotArgs h = {l_pad > 0 ? out : nullptr,
                     static_cast<const __nv_bfloat16*>(hotT),
                     static_cast<const __nv_bfloat16*>(hotLo),
                     tokens, n_used, doc_ids, q_count, rows, out, gmax};
  const bool split = counts_lo != nullptr;
  if (q_count <= 16)
    return split ? launch_hot<16, true>(h, counts, counts_lo, kp, s)
                 : launch_hot<16, false>(h, counts, counts_lo, kp, s);
  return split ? launch_hot<128, true>(h, counts, counts_lo, kp, s)
               : launch_hot<128, false>(h, counts, counts_lo, kp, s);
}

}  // extern "C"
