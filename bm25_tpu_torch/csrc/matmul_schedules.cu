// Schedules of the matrix product C = A @ B for Hopper (sm_90a): the four
// TPU experiments on kernel B6's product.
//
// Replaces:
//   E1 scripts/exp_r4_matmul_tiles3.py: mm_noacc (:50, pallas_call :57) and
//      mm_resident (:79, :89), body _noacc_kernel (:40)  -> bm25_matmul_sweep
//   E2 scripts/exp_r4_matmul_tiles4.py: mm_b_resident (:43, :48) and
//      mm_single_dot (:69, :73), body _strip_kernel (:37)
//                                                     -> bm25_matmul_row_strip
//   E3 scripts/exp_r4_matmul_dma.py: mm_dma (:70, :76), body _dma_kernel
//      (:34)                                          -> bm25_matmul_pipelined
//   E4 scripts/exp_r4_matmul_precision.py: pallas_matmul (:65, :85), body
//      _tiled_kernel (:43), modes "default" and "bf16in"
//                                                     -> bm25_matmul_mma
//
// A (M, K), B (K, N) and C (M, N) are row-major float32; offsets are int64.
//
// Exactness.  E1-E3 sum every output over k in ascending order from +0,
// one __fmaf_rn per product, as B6 (csrc/matmul.cu) does, so they give the
// bits of the plain twin ops/matmul.py::matmul_plain.  The K tail of the
// last step is cut by the loop bound, never summed as zero products
// (fmaf(0, x, -0) is +0: even the sign of a zero matches the twin).  E4
// runs on the tensor cores, whose sums of one mma's products follow their
// own order and alignment; it is held to its twin (the same rounded inputs
// through matmul_plain) within K 2^-22 (|A^| @ |B^|), not bit for bit.
//
// What bounds them on an H100: at 1028^3 and above the product does ~170
// or more FLOP per byte of operands, far above the card's ridge, so the
// f32 FMA issue rate of the CUDA cores (67 TFLOP/s) bounds E1-E3 and the
// tensor cores' TF32 (495) and bf16 (989 TFLOP/s) rates bound E4.  Each
// design's answer:
//
// E1 matmul_sweep: the TPU kernel keeps C's f32 output block resident over
//   the K axis (no scratch).  Here a block's C tile lives in registers over
//   the whole K loop and is written once.  Twelve tiles: BM x BN in {64x64,
//   128x64, 128x128, 256x128} times BK in {8, 16, 32}; the script's
//   mm_resident (one grid cell over C, K in tk strips) is the same kernel
//   on the one-wave tile the wrapper picks.  The body is the ring of
//   matmul_ring.cuh (shared with E3 and B6's "optimized"), one block per C
//   tile in row-major order, 16 rows a warp (32 at BM = 256): a producer
//   warp streams A's and B's boxes by TMA into a ring of stages on
//   mbarriers, and consumer warps hold warp-broadcast register tiles (at
//   128 x 128, 8 warps of 16 rows, 64 accumulators a lane: 20 shared-memory
//   reads for 256 FMAs).  TMA takes row strides of whole 16-byte units from
//   a 16-byte aligned base: the wrapper stages an operand that is not so
//   into a padded copy.
//   What bounds it: the FMA issue rate (the reads take under a tenth of
//   the issue slots, and the shared-memory pipe serves half as many
//   wavefronts as the FMA pipes take warp-FMAs at 128 x 128) and filling
//   the SMs: at 1028^3 a 128 x 128 tile gives 81 blocks on 132 SMs, so the
//   busiest SM does 16.8 M FMAs (~75 us at 1.75 GHz) whatever the
//   mainloop; 64 x 64 gives 289 blocks, all resident at once.  Split-K is
//   ruled out: every output sums k in one chain.  E1 takes the deepest
//   ring up to RING_MAX_STAGES that fits the card's shared memory (the
//   wrapper's sweep_stages: 4 at every tile on an H100; a 256 x 128 x 32
//   stage is 48 KB).
// E2 matmul_row_strip: the TPU keeps one operand whole in VMEM and streams
//   the other once.  B (4.2 MB at 1028^2) cannot sit in 227 KB of shared
//   memory, but an A strip can: a block holds strip_m (8, 16 or 32) rows of
//   A, all of K, resident in dynamic shared memory (opted into with
//   cudaFuncAttributeMaxDynamicSharedMemorySize, the counterpart of the
//   script's vmem_limit_bytes) and streams B.  What bounds it:
//   - the FMA pipe, if the shared-memory pipe keeps up: each of 8 consumer
//     warps holds 8 rows x 128 columns of C, a thread 8 x 4 in registers;
//     per four k values it reads the 8 rows' A values as 16-byte warp-wide
//     broadcasts and 4 rows of B as 16-byte loads, 12 reads for 128 FMAs;
//   - B's traffic through the L2: a block feeds each B value it streams to
//     strip_m FMAs, so at strip 8 the SMs would need ~64 bytes of B per
//     clock each, more than the L2 delivers.  Taller strips need less, but
//     strip_m K 4 bytes must fit the block's 227 KB (the wrapper's default
//     is the tallest strip that fits);
//   - filling the card: the grid is (strip, column group), and the groups
//     are the fewest whose blocks reach the SM count (the wrapper's plan);
//   - the number of copies (below).
//   Copies are Hopper's bulk asynchronous copies (cp.async.bulk), issued by
//   a ninth, producer warp and completing on mbarriers with their byte
//   counts.  Each copy is as large as the data allows (one copy per 1-2 KB
//   tile row was markedly slower at strips 16 and 32 on an H100): the A
//   strip is one copy (its rows are contiguous), and the wrapper lays B out
//   by panels (each BN-wide panel's K rows contiguous), so a BK x BN tile
//   (4096 floats, BN = 8192 / strip_m columns) is one copy.  The tiles pass
//   through a ring of as many 16 KB slots as the strip leaves (3 to 8) with
//   a full and an empty barrier per slot; the phase bits carry across
//   panels and strips.  A consumer warp frees a slot as soon as its B
//   values are in registers.  A narrow panel (the ragged last columns)
//   takes tiles of up to 4096 / width rows, and a warp with at most 64 of
//   its columns gives each lane one row and a few column quads, not 8 rows
//   x 4 columns on a handful of lanes (at 1028^3 every block's 4-column
//   tail panel would take a lane 1028 x 32 serial FMAs).
//   A block walks its column group in BN-wide panels, and with `blocks`
//   set, a grid of that many blocks walks the strips, reloading A once a
//   strip's consumers release it (blocks = 1: mm_single_dot's grid of one,
//   on one SM).  Bulk copies need 16-byte aligned runs of whole 16-byte
//   units; the wrapper stages an A that is not so into a padded copy (B's
//   packing pads its panels), and the loops stop at the real K and N.  A
//   wait that never ends traps (a launch failure) instead of hanging the
//   card.  A cluster of blocks over consecutive strips, each B tile
//   multicast to all of them, was tried and lost to one block at each
//   size's fastest strip (PERF.md): the slot hand-off across the
//   cluster cost more than the L2 reads it saved.
// E3 matmul_pipelined: the script copies A strips by hand into a 2-slot
//   VMEM buffer so strip i+1's copy overlaps strip i's product.  Here it is
//   E1's ring body on its tiles 64 x 64 x 16 and 128 x 128 x 16 with the
//   caller's `stages` (2, 3 or 4; the script's two DMA slots are 2).  It
//   replaced a cp.async.cg ring whose copies were hidden but whose scalar
//   shared-memory reads (16 LDS.32 per 64 FMAs a thread) were the wall.
//   Its contract stays: K % 4 == 0, N % 4 == 0 and 16-byte aligned
//   operands, or the wrapper raises.
// E4 matmul_mma: wgmma on the tensor cores, fed by TMA, in two launches.
//   mma_pack_kernel rounds every input once, as the twin does ("default":
//   TF32, round_tf32's bits, the 13 low bits cleared, since wgmma's TF32
//   path would truncate them; "bf16in": bf16 to nearest even) and writes
//   both operands K-major: A as (M, kp), B transposed through a shared
//   tile to (N, kp), rows zero-padded to kp, a multiple of 16 bytes (TMA's
//   row strides must be: a bf16 row of K = 1028 is 2,056 bytes).  wgmma
//   transposes only 16-bit operands, so a TF32 B must be K-major; bf16
//   takes the same layout, so both modes share one descriptor scheme.
//   mma_wgmma_kernel: a block computes a 128 x BN C tile, BN = 128, or
//   256 where 128 x 128 tiles would take more than one wave (the
//   wrapper's plan): a wider tile reads fewer operand bytes through the
//   L2 for the same work.  A producer warp streams boxes of 128 bytes of
//   K (64 bf16 or 32 TF32 values) by 128 rows of A and BN rows of B by TMA
//   (cp.async.bulk.tensor, 128-byte swizzle, zeros past every edge) into
//   a 4-stage ring with a full and an empty mbarrier per stage; two
//   consumer warpgroups of 64 rows each run wgmma.mma_async (m64nBNk16
//   bf16, m64nBNk8 TF32, both operands from shared memory through
//   descriptors matching the swizzle), keep one stage's wgmma in flight
//   (wait_group 1) and free a stage once the wgmma reading it has
//   completed.  The f32 accumulators (BN / 2 a thread) are written to C,
//   masked at the edges.  What bounds it: the tensor cores' rate (989
//   TFLOP/s bf16, 495 TF32) and the operands' reads through the L2 at
//   2048^3 and above; at 1028^3 the 81 blocks of one wave on 132 SMs, the
//   pack's pass over the operands (~13-17 MB) and the host's work per
//   call.  Simple first: no persistent blocks, stream-K, clusters or TMA
//   store.  A wait that never ends traps.
//
// E1 and E3 are simple first: one block per tile, no clusters or setmaxnreg.

#include "matmul_ring.cuh"  // the ring body and the mbarrier/TMA helpers
#include "wgmma.cuh"        // wgmma descriptors and fences, swizzled maps

namespace {

constexpr int STRIP_WARPS = 8;  // E2's consumer warps; one more produces
constexpr int STRIP_THREADS = 32 * (STRIP_WARPS + 1);
constexpr int STRIP_MIN_STAGES = 3;        // E2's ring of B tiles: as
constexpr int STRIP_MAX_STAGES = 8;        // many slots as shared memory
constexpr int STRIP_TILE_FLOATS = 4096;    // holds; one slot is 16 KB
// E4: a 128 x BN (128 or 256) C tile per block, two consumer warpgroups
// and a producer warp; each ring stage is a box of 128 bytes of K (64
// bf16 or 32 TF32 values) by 128 rows of A and BN rows of B
constexpr int MMA_TILE = 128, MMA_ROW_BYTES = 128, MMA_STAGES = 4;
constexpr int MMA_CONSUMER_WARPS = 8;
constexpr int MMA_THREADS = 32 * (MMA_CONSUMER_WARPS + 1);
constexpr int PACK_TILE = 32, PACK_THREADS = 256;  // E4's pack

// ---------------------------------------------------------------- E2 ----

template <int SM>
struct StripShape {
  static constexpr int ROW_GROUPS = SM / 8;  // warps over the strip's rows
  static constexpr int BN = 128 * STRIP_WARPS / ROW_GROUPS;  // panel width
  static constexpr int BK = STRIP_TILE_FLOATS / BN;          // tile depth
};

// shared memory: the ring's slots, the A strip (lda = K rounded up to 4),
// then the barriers: full[MAX], empty[MAX], a_full, a_empty
__host__ __device__ constexpr size_t strip_smem_bytes(int sm, int64_t lda,
                                                      int stages) {
  return (stages * STRIP_TILE_FLOATS + sm * lda) * sizeof(float) +
         (2 * STRIP_MAX_STAGES + 2) * sizeof(uint64_t);
}

// Rows of B per tile of a panel whose slot rows are wr floats (its width
// rounded up to 4): BK for a full panel, deeper for a narrow one, so a
// narrow tail panel takes few trips around the ring.
__host__ __device__ constexpr int panel_rows(int wr) {
  return STRIP_TILE_FLOATS / wr / 4 * 4;
}

__device__ __forceinline__ float part(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// acc[i][j] += a(row i, k + q) * b(k + q, j) for q < 4, in ascending k:
// av[i] holds row i's four A values (k .. k + 3), bv[q] B's row k + q at
// this thread's four columns
__device__ __forceinline__ void strip_fma4(float (&acc)[8][4],
                                           const float4 (&av)[8],
                                           const float4* bv, int nq) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (q < nq) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float x = part(av[i], q);
        acc[i][0] = __fmaf_rn(x, bv[q].x, acc[i][0]);
        acc[i][1] = __fmaf_rn(x, bv[q].y, acc[i][1]);
        acc[i][2] = __fmaf_rn(x, bv[q].z, acc[i][2]);
        acc[i][3] = __fmaf_rn(x, bv[q].w, acc[i][3]);
      }
    }
  }
}

// the 8 rows' A values at k .. k + 3: the same 16 bytes for the whole warp
__device__ __forceinline__ void load_a4(float4 (&av)[8], const float* ak,
                                        int64_t lda) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
    av[i] = *reinterpret_cast<const float4*>(ak + i * lda);
}

// Work item i of `strips` x `groups` is strip i % strips of column group
// i / strips.  bp is B packed by panels: the panel of width w starting at column c0 is a
// contiguous (K, wr) block at bp + K c0, wr = w rounded up to 4, so a
// tile of it is one contiguous run of bytes.
template <int SM>
__global__ void __launch_bounds__(STRIP_THREADS, 1)
row_strip_kernel(const float* __restrict__ a, const float* __restrict__ bp,
                 float* __restrict__ c, int64_t m, int64_t n, int64_t k,
                 int64_t lda, int64_t strips, int64_t groups, int64_t group_w,
                 int stages) {
  using S = StripShape<SM>;
  constexpr int BN = S::BN, BK = S::BK;
  extern __shared__ __align__(128) float smem[];
  float* ring = smem;                              // [stages][4096 floats]
  float* as = smem + stages * STRIP_TILE_FLOATS;   // [SM][lda]
  uint64_t* full = reinterpret_cast<uint64_t*>(as + SM * lda);
  uint64_t* empty = full + STRIP_MAX_STAGES;
  uint64_t* a_full = empty + STRIP_MAX_STAGES;
  uint64_t* a_empty = a_full + 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);             // the producer's expect_tx
      mbar_init(&empty[s], STRIP_WARPS);  // every consumer warp is done
    }
    mbar_init(a_full, 1);
    mbar_init(a_empty, STRIP_WARPS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the barriers are initialised before any use

  const int64_t items = strips * groups;
  int stage = 0;
  uint32_t phase = 0, a_loads = 0;
  int64_t cur = -1;  // the strip resident in `as`

  if (warp == STRIP_WARPS) {  // the producer: lane 0 copies
    for (int64_t it = blockIdx.x; it < items; it += gridDim.x) {
      const int64_t g = it / strips, s = it % strips;
      if (s != cur) {  // (re)load the A strip once its readers are done
        if (a_loads > 0) mbar_wait(a_empty, (a_loads - 1) & 1);
        const int64_t m0 = s * SM;
        const uint32_t bytes = (uint32_t)(imin(SM, m - m0) * lda * 4);
        if (lane == 0) {
          mbar_expect_tx(a_full, bytes);
          if (bytes) bulk_copy(as, a + m0 * lda, bytes, a_full);
        }
        ++a_loads;
        cur = s;
      }
      const int64_t c_hi = imin((g + 1) * group_w, n);
      for (int64_t c0 = g * group_w; c0 < c_hi; c0 += BN) {
        const int wr = (int)(imin(BN, c_hi - c0) + 3) / 4 * 4;
        const int pk = panel_rows(wr);
        const float* panel = bp + k * c0;
        for (int64_t k0 = 0; k0 < k; k0 += pk) {
          mbar_wait(&empty[stage], phase ^ 1);
          const uint32_t bytes = (uint32_t)(imin(pk, k - k0) * wr * 4);
          if (lane == 0) {  // the tile is one copy
            mbar_expect_tx(&full[stage], bytes);
            bulk_copy(ring + stage * STRIP_TILE_FLOATS, panel + k0 * wr,
                      bytes, &full[stage]);
          }
          __syncwarp();
          if (++stage == stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {  // consumers: warp = (column chunk, row group of 8 rows)
    const int rg = warp % S::ROW_GROUPS, cc = warp / S::ROW_GROUPS;
    for (int64_t it = blockIdx.x; it < items; it += gridDim.x) {
      const int64_t g = it / strips, s = it % strips;
      if (s != cur) {
        if (a_loads > 0) {  // done with the previous strip
          __syncwarp();
          if (lane == 0) mbar_arrive(a_empty);
        }
        mbar_wait(a_full, a_loads & 1);
        ++a_loads;
        cur = s;
      }
      const int64_t row0 = s * SM + rg * 8;
      const float* arow = as + rg * 8 * lda;
      const int64_t c_hi = imin((g + 1) * group_w, n);
      for (int64_t c0 = g * group_w; c0 < c_hi; c0 += BN) {
        const int w = (int)imin(BN, c_hi - c0);
        const int wr = (w + 3) / 4 * 4, pk = panel_rows(wr);
        // rows past M and columns past the panel compute nothing, but
        // take part in every barrier
        const bool active = row0 < m && cc * 128 < w;
        const bool lane_on = cc * 128 + lane * 4 < w;
        // where the warp has at most 16 column quads of a narrow panel (the
        // ragged last columns), it spreads its (row, quad) items over its
        // lanes: item lane + 32 t is row lane % 8, quad lane / 8 + 4 t
        const int quads = (int)imin(128, w - cc * 128 + 3) / 4;
        const bool narrow = wr < BN && quads <= 16;
        float acc[8][4];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
        for (int64_t k0 = 0; k0 < k; k0 += pk) {
          mbar_wait(&full[stage], phase);
          const float* ak = arow + k0;
          const float* bk =
              ring + stage * STRIP_TILE_FLOATS + cc * 128 + lane * 4;
          bool held = true;
          if (active && wr == BN && k - k0 >= BK) {
            // a full tile: take this thread's B values, free the slot,
            // then run the tile's FMAs from registers
            float4 bt[BK], av[8];
#pragma unroll
            for (int q = 0; q < BK; ++q)
              bt[q] = *reinterpret_cast<const float4*>(bk + q * BN);
            release_slot(&empty[stage], lane);
            held = false;
#pragma unroll
            for (int kk = 0; kk < BK; kk += 4) {
              load_a4(av, ak + kk, lda);
              strip_fma4(acc, av, bt + kk, 4);
            }
          } else if (active && narrow) {
            // one row's four A values and, per item, four B rows: a few
            // FMAs a lane where 8 x 4 on one lane would serialise the panel
            const int kmax = (int)imin(pk, k - k0);
            const float* ar = ak + (lane % 8) * lda;
            const float* br = bk - lane * 4 + (lane / 8) * 4;
            for (int kk = 0; kk < kmax; kk += 4) {
              const float4 a4 = *reinterpret_cast<const float4*>(ar + kk);
              const int nq = (int)imin(4, kmax - kk);
#pragma unroll
              for (int t = 0; t < 4; ++t) {
                if (lane / 8 + 4 * t < quads) {
#pragma unroll
                  for (int q = 0; q < 4; ++q) {
                    if (q < nq) {
                      const float x = part(a4, q);
                      const float4 bv = *reinterpret_cast<const float4*>(
                          br + (kk + q) * wr + 16 * t);
                      acc[t][0] = __fmaf_rn(x, bv.x, acc[t][0]);
                      acc[t][1] = __fmaf_rn(x, bv.y, acc[t][1]);
                      acc[t][2] = __fmaf_rn(x, bv.z, acc[t][2]);
                      acc[t][3] = __fmaf_rn(x, bv.w, acc[t][3]);
                    }
                  }
                }
              }
            }
          } else if (active && lane_on) {
            // the K tail of a full panel: cut by the loop bound
            const int kmax = (int)imin(pk, k - k0);
            float4 av[8], bv[4];
            for (int kk = 0; kk < kmax; kk += 4) {
              load_a4(av, ak + kk, lda);
#pragma unroll
              for (int q = 0; q < 4; ++q)
                bv[q] = *reinterpret_cast<const float4*>(bk + (kk + q) * wr);
              strip_fma4(acc, av, bv, kmax - kk);
            }
          }
          if (held) release_slot(&empty[stage], lane);
          if (++stage == stages) {
            stage = 0;
            phase ^= 1;
          }
        }
        if (active && narrow) {
          const int64_t row = row0 + lane % 8;
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int64_t col = c0 + cc * 128 + (lane / 8 + 4 * t) * 4;
            if (row < m && lane / 8 + 4 * t < quads) {
#pragma unroll
              for (int j = 0; j < 4; ++j)
                if (col + j < c0 + w) c[row * n + col + j] = acc[t][j];
            }
          }
        } else if (active) {
          const int64_t col = c0 + cc * 128 + lane * 4;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            if (row0 + i >= m) break;
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (col + j < c0 + w) c[(row0 + i) * n + col + j] = acc[i][j];
          }
        }
      }
    }
  }
}

template <int SM>
int launch_row_strip(const float* a, const float* b, float* c, int64_t m,
                     int64_t n, int64_t k, int64_t lda, int64_t groups,
                     int64_t group_w, int64_t grid, int stages,
                     cudaStream_t s) {
  const int64_t strips = (m + SM - 1) / SM;
  const size_t bytes = strip_smem_bytes(SM, lda, stages);
  int optin = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (bytes > (size_t)optin) return (int)cudaErrorInvalidValue;
  if (grid < 1 || grid > 0x7fffffff || groups < 1 || group_w < 1)
    return (int)cudaErrorInvalidConfiguration;
  if (int err = allow_smem(row_strip_kernel<SM>, bytes)) return err;
  row_strip_kernel<SM><<<(unsigned)grid, STRIP_THREADS, bytes, s>>>(
      a, b, c, m, n, k, lda, strips, groups, group_w, stages);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- E4 ----

// Rounding, once per input value, as the twin rounds: bf16 to nearest
// even; TF32 as round_tf32, half an ulp added to the magnitude bits and
// the 13 low bits cleared (cvt.rna.tf32.f32's rounding, ties away from
// zero, with the low bits zero: wgmma's TF32 path would otherwise drop
// them, a truncation).
template <bool BF16> struct Packed;
template <> struct Packed<true> {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ T round(float v) {
    return __float2bfloat16_rn(v);
  }
};
template <> struct Packed<false> {
  using T = float;
  static __device__ __forceinline__ T round(float v) {
    return __uint_as_float((__float_as_uint(v) + 0x1000u) & 0xFFFFE000u);
  }
};

// One launch packs both operands K-major, rounded, rows zero-padded to kp
// (a whole number of 16-byte units, as TMA's strides must be): blocks
// [0, tiles_a) copy A's 32 x 32 tiles to ap (M, kp), the rest transpose
// B's through shared memory to bt (N, kp), so reads and writes coalesce
// on both sides.  Any 4-byte aligned a and b.
template <bool BF16>
__global__ void __launch_bounds__(PACK_THREADS)
mma_pack_kernel(const float* __restrict__ a, const float* __restrict__ b,
                typename Packed<BF16>::T* __restrict__ ap,
                typename Packed<BF16>::T* __restrict__ bt, int64_t m,
                int64_t n, int64_t k, int64_t kp, int64_t tiles_k,
                int64_t tiles_a, int64_t tiles_bn) {
  __shared__ float tile[PACK_TILE][PACK_TILE + 1];
  const int tx = threadIdx.x % PACK_TILE, ty = threadIdx.x / PACK_TILE;
  constexpr int ROWS = PACK_THREADS / PACK_TILE;  // 8: four rows a thread
  const int64_t t = blockIdx.x;
  if (t < tiles_a) {
    const int64_t r0 = t / tiles_k * PACK_TILE;
    const int64_t col = t % tiles_k * PACK_TILE + tx;
#pragma unroll
    for (int i = 0; i < PACK_TILE; i += ROWS) {
      const int64_t r = r0 + ty + i;
      if (r < m && col < kp)
        ap[r * kp + col] =
            Packed<BF16>::round(col < k ? a[r * k + col] : 0.f);
    }
  } else {  // B's tile (k0.., n0..) lands as bt's (n0.., k0..)
    const int64_t u = t - tiles_a;
    const int64_t k0 = u / tiles_bn * PACK_TILE;
    const int64_t n0 = u % tiles_bn * PACK_TILE;
#pragma unroll
    for (int i = 0; i < PACK_TILE; i += ROWS) {
      const int64_t kk = k0 + ty + i, col = n0 + tx;
      tile[ty + i][tx] = kk < k && col < n ? b[kk * n + col] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < PACK_TILE; i += ROWS) {
      const int64_t row = n0 + ty + i, col = k0 + tx;
      if (row < n && col < kp)
        bt[row * kp + col] = Packed<BF16>::round(tile[tx][ty + i]);
    }
  }
}

template <bool BF16>
int launch_pack(const float* a, const float* b, void* ap, void* bt,
                int64_t m, int64_t n, int64_t k, int64_t kp,
                cudaStream_t s) {
  using T = typename Packed<BF16>::T;
  const int64_t tiles_k = (kp + PACK_TILE - 1) / PACK_TILE;
  const int64_t tiles_a = (m + PACK_TILE - 1) / PACK_TILE * tiles_k;
  const int64_t tiles_bn = (n + PACK_TILE - 1) / PACK_TILE;
  const int64_t blocks = tiles_a + tiles_k * tiles_bn;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  mma_pack_kernel<BF16><<<(unsigned)blocks, PACK_THREADS, 0, s>>>(
      a, b, static_cast<T*>(ap), static_cast<T*>(bt), m, n, k, kp, tiles_k,
      tiles_a, tiles_bn);
  return (int)cudaGetLastError();
}

// d (this warpgroup's 64 x BN f32 accumulator) += A slice (64 rows) @ B
// slice (BN columns), both K-major in shared memory: one k16 step of
// bf16, or one k8 step of TF32.
template <bool BF16, int BN>
__device__ __forceinline__ void wgmma_step(float (&d)[BN / 2], uint64_t da,
                                           uint64_t db);

template <>
__device__ __forceinline__ void wgmma_step<true, 128>(float (&d)[64],
                                                      uint64_t da,
                                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WGMMA_REGS64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WGMMA_D64(0)
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_step<false, 128>(float (&d)[64],
                                                       uint64_t da,
                                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " WGMMA_REGS64
      ", %64, %65, p, 1, 1;\n}\n"
      : WGMMA_D64(0)
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_step<true, 256>(float (&d)[128],
                                                      uint64_t da,
                                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " WGMMA_REGS128
      ", %128, %129, p, 1, 1, 0, 0;\n}\n"
      : WGMMA_D64(0), WGMMA_D64(64)
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_step<false, 256>(float (&d)[128],
                                                       uint64_t da,
                                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 " WGMMA_REGS128
      ", %128, %129, p, 1, 1;\n}\n"
      : WGMMA_D64(0), WGMMA_D64(64)
      : "l"(da), "l"(db), "r"(1));
}

// Shared memory of a 128 x BN block: the ring (A's 128-row box, then B's
// BN-row box, per stage), its barriers, and room to align it to 1024.
template <int BN>
constexpr size_t mma_smem_bytes() {
  return 1024 + MMA_STAGES * ((MMA_TILE + BN) * MMA_ROW_BYTES +
                              2 * sizeof(uint64_t));
}

// The product of the packed operands: block (tm, tn) computes C's 128 x
// BN tile at (128 tm, BN tn).  Warps 0-7 are two consumer warpgroups of
// 64 rows each; warp 8's lane 0 is the producer.
template <bool BF16, int BN>
__global__ void __launch_bounds__(MMA_THREADS, 1)
mma_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b,
                 float* __restrict__ c, int64_t m, int64_t n, int k_steps,
                 int tiles_n) {
  constexpr int BK = MMA_ROW_BYTES / (BF16 ? 2 : 4);  // K values a stage
  constexpr int A_BYTES = MMA_TILE * MMA_ROW_BYTES;     // 16 KB
  constexpr int STAGE_BYTES = A_BYTES + BN * MMA_ROW_BYTES;
  constexpr int R = BN / 2;  // accumulators a thread
  extern __shared__ __align__(16) uint8_t mma_smem[];
  uint8_t* ring = mma_smem + ((1024 - (smem_u32(mma_smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + MMA_STAGES *
                                               STAGE_BYTES);
  uint64_t* empty = full + MMA_STAGES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tm = blockIdx.x / tiles_n, tn = blockIdx.x % tiles_n;

  if (threadIdx.x == 0) {
    for (int s = 0; s < MMA_STAGES; ++s) {
      mbar_init(&full[s], 1);                    // the producer's expect_tx
      mbar_init(&empty[s], MMA_CONSUMER_WARPS);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the barriers are initialised before any use

  if (warp == MMA_CONSUMER_WARPS) {  // the producer
    if (lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = 0; t < k_steps; ++t) {
        mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* sa = ring + stage * STAGE_BYTES;
        mbar_expect_tx(&full[stage], STAGE_BYTES);  // zero-fill included
        tma_load(sa, &map_a, t * BK, tm * MMA_TILE, &full[stage]);
        tma_load(sa + A_BYTES, &map_b, t * BK, tn * BN, &full[stage]);
        if (++stage == MMA_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {  // consumers: warpgroup wg holds rows 64 wg .. 64 wg + 63
    const int wg = warp / 4;
    float acc[R];
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = 0.f;
    const uint64_t da = wgmma_desc(ring + wg * 64 * MMA_ROW_BYTES);
    const uint64_t db = wgmma_desc(ring + A_BYTES);
    int stage = 0, held = -1;
    uint32_t phase = 0;
    for (int t = 0; t < k_steps; ++t) {
      mbar_wait(&full[stage], phase);
      const uint64_t off = (uint64_t)(stage * STAGE_BYTES) >> 4;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // four 32-byte slices of the row
        wgmma_step<BF16, BN>(acc, da + off + 2 * kk, db + off + 2 * kk);
      wgmma_commit();
      // the previous stage's wgmma has completed: free its slot
      wgmma_wait<1>();
      fence_acc(acc);
      if (held >= 0) release_slot(&empty[held], lane);
      held = stage;
      if (++stage == MMA_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    // accumulator fragment: warp w of the warpgroup holds rows 16 w ..;
    // acc[4 j + 2 h + e] is (row lane / 4 + 8 h, column 8 j + 2 (lane % 4)
    // + e)
    const int64_t row0 = (int64_t)tm * MMA_TILE + wg * 64 + (warp % 4) * 16 +
                         lane / 4;
    const int64_t col0 = (int64_t)tn * BN + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t row = row0 + 8 * h, col = col0 + 8 * j;
        if (row < m) {
          if (col < n) c[row * n + col] = acc[4 * j + 2 * h];
          if (col + 1 < n) c[row * n + col + 1] = acc[4 * j + 2 * h + 1];
        }
      }
    }
  }
}

template <bool BF16, int BN>
int launch_wgmma(const void* ap, const void* bt, float* c, int64_t m,
                 int64_t n, int64_t kp, int64_t grid_m, int64_t grid_n,
                 int dev, cudaStream_t s) {
  CUtensorMap map_a, map_b;
  if (int err = encode_packed(&map_a, ap, m, kp, BF16, MMA_TILE)) return err;
  if (int err = encode_packed(&map_b, bt, n, kp, BF16, BN)) return err;
  constexpr int64_t BK = MMA_ROW_BYTES / (BF16 ? 2 : 4);
  constexpr size_t SMEM = mma_smem_bytes<BN>();
  static bool allowed[64] = {};  // the opt-in to SMEM bytes, per device
  if (dev >= 64 || !allowed[dev]) {
    if (int err = allow_smem(mma_wgmma_kernel<BF16, BN>, SMEM)) return err;
    if (dev < 64) allowed[dev] = true;
  }
  mma_wgmma_kernel<BF16, BN><<<(unsigned)(grid_m * grid_n), MMA_THREADS,
                               SMEM, s>>>(map_a, map_b, c, m, n,
                                          (int)((kp + BK - 1) / BK),
                                          (int)grid_n);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------- E1 and E3 ----

// The ring body (matmul_ring.cuh) at a sweep tile, one block per C tile in
// row-major order; a warp holds 16 rows, 32 at BM = 256.
template <int BM, int BN, int BK>
int launch_sweep(const float* a, const float* b, float* c, int64_t m,
                 int64_t n, int64_t k, int64_t lda, int64_t ldb, int stages,
                 int dev, cudaStream_t s) {
  const int64_t tiles = (m + BM - 1) / BM * ((n + BN - 1) / BN);
  return launch_ring<float, BM, BN, BK, (BM >= 256 ? 32 : 16), false>(
      a, b, c, m, n, k, lda, ldb, stages, tiles, dev, s);
}

}  // namespace

extern "C" {

const char* bm25_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#define STRIP(SM, CALL)                                                    \
  if (strip_m == SM) return CALL;

// E2: strips of strip_m (8, 16 or 32) rows of A resident in shared memory,
// B streamed through a ring of `stages` (3-8) slots of bulk copies.  A has
// row stride lda, a multiple of 4 >= K, from a 16-byte aligned start; bp is
// B packed by panels (row_strip_kernel), 16-byte aligned.  The grid walks
// strips x groups work items (each group group_w columns wide, a multiple
// of 4).  A strip plus the ring above the card's opt-in limit of shared
// memory per block is refused (cudaErrorInvalidValue).
int bm25_matmul_row_strip(const void* a, const void* bp, void* c,
                          long long m, long long n, long long k,
                          long long lda, int strip_m, long long groups,
                          long long group_w, long long grid, int stages,
                          void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (k < 0 || lda < k || lda % 4 || group_w % 4 ||
      reinterpret_cast<uintptr_t>(a) % 16 ||
      reinterpret_cast<uintptr_t>(bp) % 16 || stages < STRIP_MIN_STAGES ||
      stages > STRIP_MAX_STAGES)
    return (int)cudaErrorInvalidValue;
  const float* A = static_cast<const float*>(a);
  const float* B = static_cast<const float*>(bp);
  float* C = static_cast<float*>(c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  STRIP(8, launch_row_strip<8>(A, B, C, m, n, k, lda, groups, group_w, grid,
                               stages, s))
  STRIP(16, launch_row_strip<16>(A, B, C, m, n, k, lda, groups, group_w,
                                 grid, stages, s))
  STRIP(32, launch_row_strip<32>(A, B, C, m, n, k, lda, groups, group_w,
                                 grid, stages, s))
  return (int)cudaErrorInvalidValue;
}
#undef STRIP

#define RING_TILE(BM, BN, BK)                                              \
  if (bm == BM && bn == BN && bk == BK)                                    \
    return launch_sweep<BM, BN, BK>(A, B, C, m, n, k, lda, ldb, stages,    \
                                    dev, s);

// E1 and E3: C = A @ B on the (bm, bn, bk) tile of the sweep through a ring
// of `stages` (2 to RING_MAX_STAGES) TMA stages.  A (M, K) and B (K, N)
// have row strides lda >= K and ldb >= N floats, multiples of 4, from
// 16-byte aligned bases (TMA's rule); the loops stop at the real M, N, K.
int bm25_matmul_ring(const void* a, const void* b, void* c, long long m,
                     long long n, long long k, long long lda, long long ldb,
                     int bm, int bn, int bk, int stages, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (k < 0 || lda < k || ldb < n || lda % 4 || ldb % 4 ||
      reinterpret_cast<uintptr_t>(a) % 16 ||
      reinterpret_cast<uintptr_t>(b) % 16 || stages < 2 ||
      stages > RING_MAX_STAGES)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  if (int err = cudaGetDevice(&dev)) return err;
  const float* A = static_cast<const float*>(a);
  const float* B = static_cast<const float*>(b);
  float* C = static_cast<float*>(c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RING_TILE(64, 64, 8) RING_TILE(64, 64, 16) RING_TILE(64, 64, 32)
  RING_TILE(128, 64, 8) RING_TILE(128, 64, 16) RING_TILE(128, 64, 32)
  RING_TILE(128, 128, 8) RING_TILE(128, 128, 16) RING_TILE(128, 128, 32)
  RING_TILE(256, 128, 8) RING_TILE(256, 128, 16) RING_TILE(256, 128, 32)
  return (int)cudaErrorInvalidValue;
}
#undef RING_TILE

// E4's pack alone: a and b (any 4-byte aligned f32) rounded, bf16
// (bf16 != 0) or TF32 (kept as f32), into the 16-byte aligned scratch
// packed: A as (M, kp), then B as (N, kp), both K-major and zero-padded;
// kp >= max(K, 1), and kp values are whole 16-byte units.
int bm25_mma_pack(const void* a, const void* b, void* packed, long long m,
                  long long n, long long k, long long kp, int bf16,
                  void* stream) {
  const int64_t esize = bf16 ? 2 : 4;
  if (m < 0 || n < 0 || k < 0 || kp < k || kp < 1 || (kp * esize) % 16 ||
      reinterpret_cast<uintptr_t>(packed) % 16)
    return (int)cudaErrorInvalidValue;
  if (m == 0 && n == 0) return 0;
  const float* A = static_cast<const float*>(a);
  const float* B = static_cast<const float*>(b);
  char* ap = static_cast<char*>(packed);
  char* bt = ap + m * kp * esize;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_pack<true>(A, B, ap, bt, m, n, k, kp, s)
              : launch_pack<false>(A, B, ap, bt, m, n, k, kp, s);
}

// E4: tensor-core product of the rounded inputs, bf16 (bf16 != 0) or TF32:
// the pack into the scratch packed (as bm25_mma_pack), then the wgmma
// kernel on a grid_m x grid_n grid of 128 x bn (128 or 256) C tiles, which
// must cover C.  Two launches on the caller's stream.
int bm25_matmul_mma(const void* a, const void* b, void* c, long long m,
                    long long n, long long k, void* packed, long long kp,
                    int bn, long long grid_m, long long grid_n, int bf16,
                    void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if ((bn != 128 && bn != 256) || grid_m * MMA_TILE < m || grid_n * bn < n ||
      (grid_m - 1) * MMA_TILE >= m || (grid_n - 1) * bn >= n ||
      grid_m * grid_n > 0x7fffffff)
    return (int)cudaErrorInvalidConfiguration;
  if (int err = bm25_mma_pack(a, b, packed, m, n, k, kp, bf16, stream))
    return err;
  int dev = 0;
  if (int err = cudaGetDevice(&dev)) return err;
  const char* ap = static_cast<const char*>(packed);
  const char* bt = ap + m * kp * (bf16 ? 2 : 4);
  float* C = static_cast<float*>(c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 256)
    return bf16 ? launch_wgmma<true, 256>(ap, bt, C, m, n, kp, grid_m,
                                          grid_n, dev, s)
                : launch_wgmma<false, 256>(ap, bt, C, m, n, kp, grid_m,
                                           grid_n, dev, s);
  return bf16 ? launch_wgmma<true, 128>(ap, bt, C, m, n, kp, grid_m, grid_n,
                                        dev, s)
              : launch_wgmma<false, 128>(ap, bt, C, m, n, kp, grid_m,
                                         grid_n, dev, s);
}

}  // extern "C"
