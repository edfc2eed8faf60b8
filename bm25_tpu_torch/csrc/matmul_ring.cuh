// The TMA ring body of the CUDA-core matrix product C = A @ B for Hopper
// (sm_90a), shared by B6's "optimized" kernel (matmul.cu) and E1/E3's
// matmul_sweep and matmul_pipelined (matmul_schedules.cu), with the
// mbarrier and TMA helpers that E2 and E4 use too.
//
// matmul_ring_kernel<T, BM, BN, BK, R, BALANCED>: T is float or
// __nv_bfloat16 (A, B and C all of it; the sums are f32).
//   - A producer warp copies A's box (BK values of K by BM rows,
//     k-contiguous as A lies) and B's (BN columns by BK rows) with
//     cp.async.bulk.tensor into a ring of stages, a full and an empty
//     mbarrier per stage; no pack, no transpose, no swizzle; zeros past
//     every edge.  TMA takes row strides of whole 16-byte units from a
//     16-byte aligned base: the wrappers stage an operand that is not so
//     into a padded copy.
//   - Register tiles, read 16 bytes at a time; bf16 widens to f32 on read,
//     exactly (a bf16 is the top half of its f32).  E1 and E3
//     (BALANCED = false): BM / R consumer warps, every lane of a warp on
//     the same R rows of C and TN = BN / 32 columns of its own, so a
//     warp reads each row's A values as one 16-byte broadcast and the B
//     rows as TN values a lane.  B6 (BALANCED = true): 8 consumer warps
//     as a grid of 2 x 4, each over 4R rows and 32 columns, a lane on R
//     rows 4 apart and 4 columns; a warp's B read is then 128 bytes and
//     its A read 4 rows, which lie on four bank groups because A's box
//     rows are padded by 16 bytes in shared memory (TMA reads them from
//     the next K step, or zeros).  Per 4 values of K a lane does 16 R
//     FMAs for R + 4 reads, and the warp's reads take R + 4 shared-memory
//     wavefronts where the broadcast layout at 64 x 128 takes 2R + 16.
//   - A warp frees a stage once its reads of it are done.
//   - Exactness: every output sums k in ascending order from +0, one
//     __fmaf_rn per product, and the K tail is cut by the loop bound
//     (TMA's zero fill is never summed: fmaf(0, x, -0) would turn a -0
//     sum into +0), so C has the bits of ops/matmul.py::matmul_plain; a
//     bf16 C is rounded once, to nearest even.
//   - The walk: block b takes tiles b, b + gridDim.x, ... of an order, and
//     the ring's phase bits carry across its tiles, so the producer runs
//     into the next tile's stages while the consumers store the last one.
//     BALANCED = false: one block per tile, row-major.  BALANCED = true:
//     as many blocks as the SMs hold at once (or one a tile, if fewer),
//     over the full tiles first, row-major, then the right edge's thin
//     tiles, the bottom edge's, the corner.
//     The strided walk hands the edges to the blocks that got the fewest
//     full tiles first (ops/matmul.py::tile_order mirrors it).  A thin
//     tile (its valid rows times its 4-column quads at most the consumer
//     threads) gives one (row, quad) item to each thread, where the
//     register tiles would leave most lanes idle for a whole K loop;
//     warps whose rows lie past M skip their products.
//
// A wait that never ends traps.  All offsets are int64.

#pragma once

#include <cuda.h>          // CUtensorMap (types only: no libcuda link)
#include <cudaTypedefs.h>  // PFN_cuTensorMapEncodeTiled_v12000
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DEFAULT_SMEM = 48 * 1024;
// the ring holds at most this many stages (its barriers are laid out for
// this many), from a base aligned to TMA's 128 bytes
constexpr int RING_MAX_STAGES = 4, RING_ALIGN = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// one arrival that also adds `bytes` to the phase's expected transactions
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`.  No
// wait of these kernels lasts more than a few milliseconds; one that spins
// 2^26 times is a protocol fault and traps rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (spins == (1u << 26)) __trap();
  }
}

// `bytes` from global memory to this CTA's shared memory, completing on
// `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// One TMA load of a box of `map` at (c0 along the inner dimension, c1
// along rows) into shared memory, completing on `bar`; boxes past the
// tensor's edges are zero-filled.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// The warp is done reading a ring slot: one arrival on its empty barrier.
__device__ __forceinline__ void release_slot(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

__host__ __device__ constexpr int64_t imin(int64_t x, int64_t y) {
  return x < y ? x : y;
}

template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= DEFAULT_SMEM) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// cuTensorMapEncodeTiled from the driver through the runtime, so the
// libraries link no libcuda.
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// The map of a row-major (rows, cols) matrix of T with row stride ld
// values (whole 16-byte units, from a 16-byte aligned base): boxes of
// box_cols x box_rows, no swizzle, zeros past the edges.
template <typename T>
int encode_rows(CUtensorMap* map, const T* base, int64_t rows, int64_t cols,
                int64_t ld, int box_cols, int box_rows) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (!encode) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)(ld * sizeof(T))};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      2, const_cast<T*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The ring body's shape at a (BM, BN, BK) tile of T.  R is the rows of C a
// consumer thread holds, TN = BN / 32 its columns, KV the values of K in
// one 16-byte A read.  With GRID = false (E1, E3) every lane of a warp
// holds the same R rows (BM / R warps); with GRID = true (B6) the warps
// form a grid of (BM / 4R) x (BN / 32), each over 4R rows and 32 columns,
// its lanes 4 x 8, and a lane holds rows 4 i + its row (i < R) and 4
// columns; A's rows are then padded by one 16-byte unit (ALD values) so
// that the four rows a warp reads at once lie on different banks.  A
// stage is A's BM x ALD box, then B's BK x BN box (ops/matmul.py::
// ring_smem_bytes mirrors it).
template <typename T, int BM, int BN, int BK, int R, bool GRID>
struct RingShape {
  static constexpr int TN = BN / 32;  // 4 at BN = 128, 2 at 64
  static constexpr int KV = 16 / (int)sizeof(T);  // 4 f32, 8 bf16
  static constexpr int WARPS = GRID ? BM / (4 * R) * (BN / 32) : BM / R;
  static constexpr int THREADS = 32 * (WARPS + 1);
  static constexpr int ALD = GRID ? BK + KV : BK;
  static constexpr int A_ELEMS = BM * ALD, B_ELEMS = BK * BN;
  static constexpr int STAGE_ELEMS = A_ELEMS + B_ELEMS;
  static constexpr int STAGE_BYTES = STAGE_ELEMS * (int)sizeof(T);
  // two blocks an SM where the accumulators leave the registers for them
  static constexpr int MIN_BLOCKS = R * TN < 64 ? 2 : 1;
  static_assert(BK % KV == 0 && BN % 32 == 0 && WARPS <= 8, "tile");
  static_assert(GRID ? BM % (4 * R) == 0 && TN == 4 : BM % R == 0, "tile");
  static_assert(STAGE_BYTES % RING_ALIGN == 0, "stages stay aligned");
};

// shared memory of a ring of `stages`: room to align, the stages, then
// full[RING_MAX_STAGES] and empty[RING_MAX_STAGES]
template <typename S>
constexpr size_t ring_smem_bytes(int stages) {
  return RING_ALIGN + (size_t)stages * S::STAGE_BYTES +
         2 * RING_MAX_STAGES * sizeof(uint64_t);
}

// N consecutive values of T from shared memory (4, 8 or 16 bytes, aligned
// to their size), widened to f32.
template <typename T, int N>
__device__ __forceinline__ void load_widened(float (&v)[N], const T* p) {
  constexpr int W = N * (int)sizeof(T) / 4;  // 32-bit words
  static_assert(W == 1 || W == 2 || W == 4, "4, 8 or 16 bytes");
  uint32_t w[W];
  if constexpr (W == 4) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    w[0] = x.x, w[1] = x.y, w[2] = x.z, w[3] = x.w;
  } else if constexpr (W == 2) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    w[0] = x.x, w[1] = x.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
#pragma unroll
  for (int i = 0; i < W; ++i) {
    if constexpr (sizeof(T) == 4) {
      v[i] = __uint_as_float(w[i]);
    } else {  // a bf16 is the top half of its f32: widen by shifting
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// N accumulators to consecutive C values: one 8- or 16-byte store where
// `wide`, else masked scalars up to column n
template <typename T, int N>
__device__ __forceinline__ void store_row(T* p, const float (&v)[N],
                                          int64_t col, int64_t n, bool wide) {
  if constexpr (sizeof(T) == 4 && (N == 2 || N == 4)) {
    if (wide) {
      if constexpr (N == 4)
        *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
      else
        *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
      return;
    }
  } else if constexpr (sizeof(T) == 2 && N == 4) {
    if (wide) {
      __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
      __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
      uint2 x;
      x.x = *reinterpret_cast<uint32_t*>(&lo);
      x.y = *reinterpret_cast<uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(p) = x;
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (col + j < n) store(p + j, v[j]);
}

// One stage's products, k ascending: acc[i][j] += a(row i, kk) b(kk, j)
// for kk < BK (FULL) or kk < kmax (the K tail: the zeros TMA filled past K
// are never summed).  `as` is the warp's first row of the A box (rows BK
// values apart), `bs` the lane's first column of the B box (rows BN
// values apart).
template <typename T, int BN, int BK, int R, int TN, int KV, bool FULL>
__device__ __forceinline__ void ring_products(float (&acc)[R][TN],
                                              const T* as, const T* bs,
                                              int kmax) {
#pragma unroll
  for (int kk = 0; kk < BK; kk += KV) {
    if (FULL || kk < kmax) {
      float bv[KV][TN];
#pragma unroll
      for (int q = 0; q < KV; ++q)
        load_widened<T, TN>(bv[q], bs + (kk + q) * BN);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        // the same 16 bytes for the whole warp: one broadcast
        float av[KV];
        load_widened<T, KV>(av, as + i * BK + kk);
#pragma unroll
        for (int q = 0; q < KV; ++q) {
          if (FULL || kk + q < kmax) {
#pragma unroll
            for (int j = 0; j < TN; ++j)
              acc[i][j] = __fmaf_rn(av[q], bv[q][j], acc[i][j]);
          }
        }
      }
    }
  }
}

// The same for a thread of the warp grid (GRID): acc[i][j] += a(row 4 i,
// kk) b(kk, j).  `as` is the thread's first row of the A box (rows ALD
// values apart, so its rows are 4 ALD apart), `bs` its first column of
// the B box.
template <typename T, int BN, int BK, int ALD, int R, int KV, bool FULL>
__device__ __forceinline__ void grid_products(float (&acc)[R][4],
                                              const T* as, const T* bs,
                                              int kmax) {
#pragma unroll
  for (int kk = 0; kk < BK; kk += KV) {
    if (FULL || kk < kmax) {
      float bv[KV][4];
#pragma unroll
      for (int q = 0; q < KV; ++q)
        load_widened<T, 4>(bv[q], bs + (kk + q) * BN);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        // four rows, four banks: one wavefront for the warp
        float av[KV];
        load_widened<T, KV>(av, as + i * 4 * ALD + kk);
#pragma unroll
        for (int q = 0; q < KV; ++q) {
          if (FULL || kk + q < kmax) {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = __fmaf_rn(av[q], bv[q][j], acc[i][j]);
          }
        }
      }
    }
  }
}

// A thin tile's products for one thread's item, k ascending: acc[j] +=
// a(row, kk) b(kk, 4 quad + j).  `ar` is the item's row of the A box, `bq`
// its quad of the B box.
template <typename T, int BN, int BK, int KV, bool FULL>
__device__ __forceinline__ void item_products(float (&acc)[4], const T* ar,
                                              const T* bq, int kmax) {
#pragma unroll
  for (int kk = 0; kk < BK; kk += KV) {
    if (FULL || kk < kmax) {
      float av[KV];
      load_widened<T, KV>(av, ar + kk);
#pragma unroll
      for (int q = 0; q < KV; ++q) {
        if (FULL || kk + q < kmax) {
          float bv[4];
          load_widened<T, 4>(bv, bq + (kk + q) * BN);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[j] = __fmaf_rn(av[q], bv[j], acc[j]);
        }
      }
    }
  }
}

// Tile i of B6's walk as (tm, tn): the full tiles (row-major) first, then
// the right edge's thin tiles (top to bottom), the bottom edge's (left to
// right), the corner.
template <int BM, int BN>
__device__ __forceinline__ void tile_at(int i, int m, int n, int& tm,
                                        int& tn) {
  const int fm = m / BM, fn = n / BN;
  const int em = m % BM != 0, en = n % BN != 0;
  if (i < fm * fn) {
    tm = i / fn, tn = i % fn;
    return;
  }
  i -= fm * fn;
  if (i < fm * en) {
    tm = i, tn = fn;
    return;
  }
  i -= fm * en;
  tm = fm, tn = i < fn * em ? i : fn;
}

// C = A @ B over BM x BN tiles, walked as the header says.  map_a covers A
// as (K, M) boxes of BK x BM, map_b B as (N, K) boxes of BN x BK (inner
// dimension first); both are unused where K = 0 (C is +0).  Warps 0 ..
// WARPS-1 consume, warp WARPS's lane 0 produces.  M, N, K and the tile
// count fit an int (launch_ring checks); C's offsets are int64.
template <typename T, int BM, int BN, int BK, int R, bool BALANCED>
__global__ void __launch_bounds__(
    RingShape<T, BM, BN, BK, R, BALANCED>::THREADS,
    RingShape<T, BM, BN, BK, R, BALANCED>::MIN_BLOCKS)
matmul_ring_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b,
                   T* __restrict__ c, int64_t m, int64_t n, int64_t k,
                   int stages) {
  using S = RingShape<T, BM, BN, BK, R, BALANCED>;
  constexpr int TN = S::TN, KV = S::KV, ALD = S::ALD;
  static_assert(!BALANCED || TN == 4, "a thin tile's item is 4 columns");
  extern __shared__ __align__(16) uint8_t ring_smem[];
  T* ring = reinterpret_cast<T*>(
      ring_smem + ((RING_ALIGN - (smem_u32(ring_smem) & (RING_ALIGN - 1))) &
                   (RING_ALIGN - 1)));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * S::STAGE_ELEMS);
  uint64_t* empty = full + RING_MAX_STAGES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int steps = (int)((k + BK - 1) / BK);
  const int tiles_n = (int)((n + BN - 1) / BN);

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);         // the producer's expect_tx
      mbar_init(&empty[s], S::WARPS);  // every consumer warp is done
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the barriers are initialised before any use

  int stage = 0;
  uint32_t phase = 0;
  if constexpr (!BALANCED) {
    // E1 and E3: block (tm, tn) = (blockIdx.x / tiles_n, blockIdx.x %
    // tiles_n), one tile
    const int tm = blockIdx.x / tiles_n, tn = blockIdx.x % tiles_n;
    if (warp == S::WARPS) {  // the producer
      if (lane == 0) {
        for (int64_t t = 0; t < steps; ++t) {
          mbar_wait(&empty[stage], phase ^ 1);
          T* sa = ring + stage * S::STAGE_ELEMS;
          mbar_expect_tx(&full[stage], S::STAGE_BYTES);  // zero fill too
          tma_load(sa, &map_a, (int)(t * BK), tm * BM, &full[stage]);
          tma_load(sa + S::A_ELEMS, &map_b, tn * BN, (int)(t * BK),
                   &full[stage]);
          if (++stage == stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
      return;
    }
    float acc[R][TN];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[r][j] = 0.0f;
    for (int64_t t = 0; t < steps; ++t) {
      mbar_wait(&full[stage], phase);
      const T* as = ring + stage * S::STAGE_ELEMS + warp * R * BK;
      const T* bs = ring + stage * S::STAGE_ELEMS + S::A_ELEMS + lane * TN;
      const int64_t left = k - t * BK;
      if (left >= BK)
        ring_products<T, BN, BK, R, TN, KV, true>(acc, as, bs, BK);
      else
        ring_products<T, BN, BK, R, TN, KV, false>(acc, as, bs, (int)left);
      release_slot(&empty[stage], lane);
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    const int64_t col = (int64_t)tn * BN + lane * TN;
    const bool wide = n % TN == 0 && col + TN <= n;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int64_t row = (int64_t)tm * BM + warp * R + r;
      if (row >= m) break;
      store_row<T, TN>(c + row * n + col, acc[r], col, n, wide);
    }
  } else {  // B6: the walk
    const int tiles = (int)((m + BM - 1) / BM) * tiles_n;
    if (warp == S::WARPS) {  // the producer
      if (lane != 0) return;
      for (int i = blockIdx.x; i < tiles; i += gridDim.x) {
        int tm, tn;
        tile_at<BM, BN>(i, (int)m, (int)n, tm, tn);
        for (int t = 0; t < steps; ++t) {
          mbar_wait(&empty[stage], phase ^ 1);
          T* sa = ring + stage * S::STAGE_ELEMS;
          mbar_expect_tx(&full[stage], S::STAGE_BYTES);  // zero fill too
          tma_load(sa, &map_a, t * BK, tm * BM, &full[stage]);
          tma_load(sa + S::A_ELEMS, &map_b, tn * BN, t * BK, &full[stage]);
          if (++stage == stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
      return;
    }

    // the K loop over one tile: wait for each stage, run `products` on it
    // (the stage's base and the values of K left), free it
    auto k_loop = [&](auto&& products) {
      for (int t = 0; t < steps; ++t) {
        mbar_wait(&full[stage], phase);
        products(ring + stage * S::STAGE_ELEMS, (int)k - t * BK);
        release_slot(&empty[stage], lane);
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    };
    for (int i = blockIdx.x; i < tiles; i += gridDim.x) {
      int tm, tn;
      tile_at<BM, BN>(i, (int)m, (int)n, tm, tn);
      const int m0 = tm * BM, n0 = tn * BN;
      const int hm = (int)imin(BM, m - m0);
      float acc[R][TN];
  #pragma unroll
      for (int r = 0; r < R; ++r)
  #pragma unroll
        for (int j = 0; j < TN; ++j) acc[r][j] = 0.0f;

      // a thin tile: one (row, quad) item a consumer thread, item u is row
      // u % hm, quad u / hm; acc[0] is its quad
      const int quads = (int)(imin(BN, n - n0) + 3) / 4;
      if (hm * quads <= 32 * S::WARPS) {
        const int u = warp * 32 + lane, row = u % hm, quad = u / hm;
        const bool live = quad < quads;
        k_loop([&](const T* sa, int left) {
          if (!live) return;
          const T* ar = sa + row * ALD;
          const T* bq = sa + S::A_ELEMS + quad * 4;
          if (left >= BK)
            item_products<T, BN, BK, KV, true>(acc[0], ar, bq, BK);
          else
            item_products<T, BN, BK, KV, false>(acc[0], ar, bq, left);
        });
        const int64_t col = n0 + quad * 4;
        if (live)
          store_row<T, 4>(c + (int64_t)(m0 + row) * n + col, acc[0], col, n,
                          n % 4 == 0 && col + 4 <= n);
        continue;
      }
      // the warp grid: warp (wr, wc) over rows 4 R wr .., columns 32 wc ..;
      // lane (lr, lc) on rows 4 i + lr of them and columns 4 lc .. 4 lc + 3
      const int wr = warp / (BN / 32), wc = warp % (BN / 32);
      const int lr = lane / 8, lc = lane % 8;
      const int r0 = wr * 4 * R + lr, c0 = wc * 32 + lc * 4;
      const bool live = wr * 4 * R < hm;
      k_loop([&](const T* sa, int left) {
        if (!live) return;
        const T* as = sa + r0 * ALD;
        const T* bs = sa + S::A_ELEMS + c0;
        if (left >= BK)
          grid_products<T, BN, BK, ALD, R, KV, true>(acc, as, bs, BK);
        else
          grid_products<T, BN, BK, ALD, R, KV, false>(acc, as, bs, left);
      });
      const int64_t col = n0 + c0;
      const bool wide = n % 4 == 0 && col + 4 <= n;
  #pragma unroll
      for (int r = 0; r < R; ++r) {
        const int64_t rr = (int64_t)m0 + r0 + 4 * r;
        if (rr < m) store_row<T, 4>(c + rr * n + col, acc[r], col, n, wide);
      }
    }
  }
}

// Launch the ring body of tile (BM, BN, BK), R rows a warp, on `grid`
// blocks (at most the tile count) with a ring of `stages`.  A (M, K) and
// B (K, N) have row strides lda >= K and ldb >= N values of T, whole
// 16-byte units, from 16-byte aligned bases (TMA's rule; the callers
// check it); the loops stop at the real M, N, K.
template <typename T, int BM, int BN, int BK, int R, bool BALANCED>
int launch_ring(const T* a, const T* b, T* c, int64_t m, int64_t n,
                int64_t k, int64_t lda, int64_t ldb, int stages, int64_t grid,
                int dev, cudaStream_t s) {
  using S = RingShape<T, BM, BN, BK, R, BALANCED>;
  const int64_t tiles_n = (n + BN - 1) / BN;
  const int64_t tiles = (m + BM - 1) / BM * tiles_n;
  if (grid < 1 || grid > tiles || tiles > 0x7fffffff ||
      (m + BM - 1) / BM * BM > 0x7fffffff || tiles_n * BN > 0x7fffffff ||
      k > 0x7fffffff - BK)
    return (int)cudaErrorInvalidConfiguration;  // the kernel's ints
  CUtensorMap map_a = {}, map_b = {};
  if (k > 0) {
    if (int err = encode_rows<T>(&map_a, a, m, k, lda, S::ALD, BM))
      return err;
    if (int err = encode_rows<T>(&map_b, b, k, n, ldb, BN, BK)) return err;
  }
  auto kernel = matmul_ring_kernel<T, BM, BN, BK, R, BALANCED>;
  // the opt-in to this ring's shared memory, raised once per device and
  // depth
  const size_t smem = ring_smem_bytes<S>(stages);
  static size_t allowed[64] = {};
  if (dev >= 64 || allowed[dev] < smem) {
    if (int err = allow_smem(kernel, smem)) return err;
    if (dev < 64) allowed[dev] = smem;
  }
  kernel<<<(unsigned)grid, S::THREADS, smem, s>>>(map_a, map_b, c, m, n, k,
                                                  stages);
  return (int)cudaGetLastError();
}

}  // namespace
