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
//   the K axis (no scratch).  Here the block's C tile lives in registers
//   over the whole K loop and is written once: B6's matmul_tiled_kernel
//   (matmul_tiled.cuh) at the sweep's tiles, 256 threads in a 16 x 16
//   grid, each owning a (BM/16) x (BN/16) register tile; per BK step the
//   block stages A's BM x BK slice (transposed) and B's BK x BN slice in
//   shared memory, with 16-byte loads where K, N and the pointers allow.
//   Twelve tiles: BM x BN in {64x64, 128x64, 128x128, 256x128} times BK in
//   {8, 16, 32}.  The script's mm_resident (one grid cell over C, K in tk
//   strips) is the same kernel on the one-wave tile the wrapper picks.
//   Single-buffered: a barrier per BK step.
// E2 matmul_row_strip: the TPU keeps one operand whole in VMEM and streams
//   the other once.  B (4.2 MB at 1028^2) cannot sit in 227 KB of shared
//   memory, but an A strip can: a block holds strip_m rows of A (all of K)
//   in dynamic shared memory, streams B through a 32 x 128 staging tile,
//   and writes each 128-column piece of its C strip once.  The L2 serves
//   B's repeats across strips.  One block per strip (mm_b_resident), or a
//   grid of `blocks` blocks walking the strips (blocks = 1: mm_single_dot's
//   grid of one, on one SM).  Shared memory above 48 KB is opted into with
//   cudaFuncAttributeMaxDynamicSharedMemorySize, the counterpart of the
//   script's vmem_limit_bytes.
// E3 matmul_pipelined: the script copies A strips by hand into a 2-slot
//   VMEM buffer so strip i+1's copy overlaps strip i's product.  Here both
//   operands' tiles of step i+1.. are copied by cp.async.cg (16 bytes per
//   copy, zero-filled past the edges through its src-size operand) into a
//   `stages`-slot shared-memory ring while step i's FMAs run
//   (commit_group / wait_group<stages-2>).  Needs K % 4 == 0, N % 4 == 0
//   and 16-byte aligned operands.  Thread (ty, tx) owns rows ty + 16 i and
//   columns tx + 16 j, so a warp's shared-memory reads hit distinct banks.
// E4 matmul_mma: mma.sync on the tensor cores, 4 warps over a 64 x 64 C
//   tile (32 x 32 each), a 32-deep K step staged in shared memory.
//   "default": m16n8k8 TF32 (cvt.rna.tf32.f32 at staging, rounding to
//   nearest with ties away from zero), the card's one-pass counterpart of
//   XLA's DEFAULT precision; "bf16in": m16n8k16 bf16 (round to nearest
//   even at staging, as the script's astype(bfloat16)).  Fragments are read
//   from shared memory per the PTX fragment layouts; B is staged n-major for
//   bf16 so that each register's two k values are adjacent.  Rows of the
//   staged tiles are padded so a warp's fragment reads hit distinct banks.
//
// Simple first: no wgmma, TMA or persistent blocks yet.

#include "matmul_tiled.cuh"  // matmul_tiled_kernel (E1 is B6's body)

namespace {

constexpr int THREADS = 256;  // E2, E3
constexpr int DEFAULT_SMEM = 48 * 1024;
constexpr int STRIP_BN = 128;  // E2: columns of C per pass
constexpr int STRIP_BK = 32;   // E2: rows of B per staged tile
constexpr int MMA_BM = 64, MMA_BN = 64, MMA_BK = 32, MMA_THREADS = 128;

// ---------------------------------------------------------------- E1 ----

// B6's block-tiled kernel on the (BM, BN, BK) sweep tile: a 16 x 16 thread
// grid, each thread a (BM/16) x (BN/16) register tile.
template <int BM, int BN, int BK>
int launch_sweep(const float* a, const float* b, float* c, int64_t m,
                 int64_t n, int64_t k, int vec, cudaStream_t s) {
  const int64_t tiles_n = (n + BN - 1) / BN;
  const int64_t blocks = (m + BM - 1) / BM * tiles_n;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  if (vec)
    matmul_tiled_kernel<float, BM, BN, BK, BM / 16, BN / 16, true>
        <<<(unsigned)blocks, TILED_THREADS, 0, s>>>(a, b, c, m, n, k,
                                                    tiles_n);
  else
    matmul_tiled_kernel<float, BM, BN, BK, BM / 16, BN / 16, false>
        <<<(unsigned)blocks, TILED_THREADS, 0, s>>>(a, b, c, m, n, k,
                                                    tiles_n);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- E2 ----

template <int SM>
__global__ void __launch_bounds__(THREADS)
row_strip_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 float* __restrict__ c, int64_t m, int64_t n, int64_t k,
                 int64_t kp, int64_t strips) {
  constexpr int TM = SM / 8;  // 8 row groups of TM rows, 32 x 4 columns
  extern __shared__ __align__(16) float smem[];
  float* as = smem;              // [SM][kp]: the A strip, all of K
  float* bs = smem + SM * kp;    // [STRIP_BK][STRIP_BN]
  const int tid = threadIdx.x;
  const int tx = tid % 32, ty = tid / 32;

  for (int64_t s = blockIdx.x; s < strips; s += gridDim.x) {
    const int64_t m0 = s * SM;
    __syncthreads();  // the previous strip's readers are done with as
    for (int r = 0; r < SM; ++r)
      for (int64_t kk = tid; kk < k; kk += THREADS)
        as[r * kp + kk] = m0 + r < m ? __ldg(a + (m0 + r) * k + kk) : 0.f;

    for (int64_t n0 = 0; n0 < n; n0 += STRIP_BN) {
      float acc[TM][4];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
      for (int64_t k0 = 0; k0 < k; k0 += STRIP_BK) {
        __syncthreads();  // the A strip is staged, bs is free
        for (int i = tid; i < STRIP_BK * STRIP_BN; i += THREADS) {
          const int kk = i / STRIP_BN, col = i % STRIP_BN;
          bs[i] = k0 + kk < k && n0 + col < n
                      ? __ldg(b + (k0 + kk) * n + n0 + col) : 0.f;
        }
        __syncthreads();
        const int kmax = k - k0 < STRIP_BK ? (int)(k - k0) : STRIP_BK;
#pragma unroll 8
        for (int kk = 0; kk < STRIP_BK; ++kk) {
          if (kk < kmax) {
            const float4 rb =
                *reinterpret_cast<const float4*>(bs + kk * STRIP_BN + tx * 4);
#pragma unroll
            for (int i = 0; i < TM; ++i) {
              const float ra = as[(ty * TM + i) * kp + k0 + kk];  // broadcast
              acc[i][0] = __fmaf_rn(ra, rb.x, acc[i][0]);
              acc[i][1] = __fmaf_rn(ra, rb.y, acc[i][1]);
              acc[i][2] = __fmaf_rn(ra, rb.z, acc[i][2]);
              acc[i][3] = __fmaf_rn(ra, rb.w, acc[i][3]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int64_t row = m0 + ty * TM + i;
        if (row >= m) break;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int64_t col = n0 + tx * 4 + j;
          if (col < n) c[row * n + col] = acc[i][j];
        }
      }
    }
  }
}

template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= DEFAULT_SMEM) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int SM>
int launch_row_strip(const float* a, const float* b, float* c, int64_t m,
                     int64_t n, int64_t k, int blocks, cudaStream_t s) {
  const int64_t kp = (k + 3) / 4 * 4;  // keeps bs 16-byte aligned
  const int64_t strips = (m + SM - 1) / SM;
  const size_t bytes = (SM * kp + STRIP_BK * STRIP_BN) * sizeof(float);
  int optin = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (bytes > (size_t)optin) return (int)cudaErrorInvalidValue;
  const int64_t grid = blocks > 0 ? blocks : strips;
  if (grid > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  if (int err = allow_smem(row_strip_kernel<SM>, bytes)) return err;
  row_strip_kernel<SM><<<(unsigned)grid, THREADS, bytes, s>>>(
      a, b, c, m, n, k, kp, strips);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- E3 ----

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;  // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Copy step t's A tile (as [BM][BK]) and B tile (bs [BK][BN]) into ring
// slot `slot`; K % 4 == 0 and N % 4 == 0, so a 16-byte chunk lies wholly
// inside or outside the operand.
template <int BM, int BN, int BK>
__device__ __forceinline__ void issue_tile(float* as, float* bs,
                                           const float* a, const float* b,
                                           int64_t m, int64_t n, int64_t k,
                                           int64_t m0, int64_t n0,
                                           int64_t k0, int tid) {
  constexpr int A_CHUNKS = BM * BK / 4, B_CHUNKS = BK * BN / 4;
  for (int i = tid; i < A_CHUNKS; i += THREADS) {
    const int r = i / (BK / 4), c4 = (i % (BK / 4)) * 4;
    const bool ok = m0 + r < m && k0 + c4 < k;
    cp_async16(as + r * BK + c4, ok ? a + (m0 + r) * k + k0 + c4 : a, ok);
  }
  for (int i = tid; i < B_CHUNKS; i += THREADS) {
    const int r = i / (BN / 4), c4 = (i % (BN / 4)) * 4;
    const bool ok = k0 + r < k && n0 + c4 < n;
    cp_async16(bs + r * BN + c4, ok ? b + (k0 + r) * n + n0 + c4 : b, ok);
  }
}

template <int BM, int BN, int BK, int STAGES>
__global__ void __launch_bounds__(THREADS)
pipelined_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 float* __restrict__ c, int64_t m, int64_t n, int64_t k,
                 int64_t tiles_n) {
  constexpr int TM = BM / 16, TN = BN / 16;
  constexpr int A_TILE = BM * BK, B_TILE = BK * BN;
  extern __shared__ __align__(16) float smem[];
  float* ring_a = smem;                     // [STAGES][BM][BK]
  float* ring_b = smem + STAGES * A_TILE;   // [STAGES][BK][BN]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t m0 = (int64_t)(blockIdx.x / tiles_n) * BM;
  const int64_t n0 = (int64_t)(blockIdx.x % tiles_n) * BN;
  const int64_t steps = (k + BK - 1) / BK;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  // prologue: steps 0 .. STAGES-2 in flight, one commit group each
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < steps)
      issue_tile<BM, BN, BK>(ring_a + t * A_TILE, ring_b + t * B_TILE, a, b,
                             m, n, k, m0, n0, (int64_t)t * BK, tid);
    cp_async_commit();
  }
  for (int64_t t = 0; t < steps; ++t) {
    // groups committed so far: STAGES - 1 + t; step t's is complete once
    // at most STAGES - 2 remain pending
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // every thread's copies of step t have landed, and
                      // step t-1's slot is no longer being read
    const int64_t next = t + STAGES - 1;
    if (next < steps) {
      const int slot = (int)(next % STAGES);
      issue_tile<BM, BN, BK>(ring_a + slot * A_TILE, ring_b + slot * B_TILE,
                             a, b, m, n, k, m0, n0, next * BK, tid);
    }
    cp_async_commit();  // an empty group past the end keeps the count

    const float* as = ring_a + (t % STAGES) * A_TILE;
    const float* bs = ring_b + (t % STAGES) * B_TILE;
    const int64_t k0 = t * BK;
    const int kmax = k - k0 < BK ? (int)(k - k0) : BK;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      if (kk < kmax) {
        float ra[TM], rb[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) ra[i] = as[(ty + 16 * i) * BK + kk];
#pragma unroll
        for (int j = 0; j < TN; ++j) rb[j] = bs[kk * BN + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = __fmaf_rn(ra[i], rb[j], acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t row = m0 + ty + 16 * i;
    if (row >= m) break;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t col = n0 + tx + 16 * j;
      if (col < n) c[row * n + col] = acc[i][j];
    }
  }
}

template <int BM, int BN, int BK, int STAGES>
int launch_pipelined(const float* a, const float* b, float* c, int64_t m,
                     int64_t n, int64_t k, cudaStream_t s) {
  const int64_t tiles_n = (n + BN - 1) / BN;
  const int64_t blocks = (m + BM - 1) / BM * tiles_n;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  const size_t bytes = STAGES * (BM * BK + BK * BN) * sizeof(float);
  if (int err = allow_smem(pipelined_kernel<BM, BN, BK, STAGES>, bytes))
    return err;
  pipelined_kernel<BM, BN, BK, STAGES><<<(unsigned)blocks, THREADS, bytes,
                                         s>>>(a, b, c, m, n, k, tiles_n);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- E4 ----

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// Staged tiles.  TF32: A [64][32 + 4] and B [32][64 + 8] as tf32 bit
// patterns.  bf16: A [64][32 + 8] and B n-major [64][32 + 8], so one 32-bit
// read gives a fragment register's two adjacent k values.
template <bool BF16> struct MmaTiles;
template <> struct MmaTiles<false> {
  uint32_t a[MMA_BM][MMA_BK + 4];
  uint32_t b[MMA_BK][MMA_BN + 8];
};
template <> struct MmaTiles<true> {
  __nv_bfloat16 a[MMA_BM][MMA_BK + 8];
  __nv_bfloat16 b[MMA_BN][MMA_BK + 8];
};

__device__ __forceinline__ uint32_t pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);  // p[0] low, p[1] high
}

template <bool BF16>
__global__ void __launch_bounds__(MMA_THREADS)
mma_kernel(const float* __restrict__ a, const float* __restrict__ b,
           float* __restrict__ c, int64_t m, int64_t n, int64_t k,
           int64_t tiles_n) {
  __shared__ __align__(16) MmaTiles<BF16> sm;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane >> 2, t = lane & 3;  // PTX groupID, threadID_in_group
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const int64_t m0 = (int64_t)(blockIdx.x / tiles_n) * MMA_BM;
  const int64_t n0 = (int64_t)(blockIdx.x % tiles_n) * MMA_BN;

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.0f;

  for (int64_t k0 = 0; k0 < k; k0 += MMA_BK) {
    // stage, rounding each value once (zeros past the edges add nothing)
    for (int i = tid; i < MMA_BM * MMA_BK; i += MMA_THREADS) {
      const int r = i / MMA_BK, kk = i % MMA_BK;
      const float v = m0 + r < m && k0 + kk < k
                          ? __ldg(a + (m0 + r) * k + k0 + kk) : 0.f;
      if constexpr (BF16) sm.a[r][kk] = __float2bfloat16_rn(v);
      else sm.a[r][kk] = to_tf32(v);
    }
    for (int i = tid; i < MMA_BK * MMA_BN; i += MMA_THREADS) {
      const int kk = i / MMA_BN, col = i % MMA_BN;
      const float v = k0 + kk < k && n0 + col < n
                          ? __ldg(b + (k0 + kk) * n + n0 + col) : 0.f;
      if constexpr (BF16) sm.b[col][kk] = __float2bfloat16_rn(v);
      else sm.b[kk][col] = to_tf32(v);
    }
    __syncthreads();

    if constexpr (BF16) {
#pragma unroll
      for (int ks = 0; ks < MMA_BK; ks += 16) {
        uint32_t af[2][4], bf[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int r = wm + mi * 16 + g;
          af[mi][0] = pair(&sm.a[r][ks + 2 * t]);
          af[mi][1] = pair(&sm.a[r + 8][ks + 2 * t]);
          af[mi][2] = pair(&sm.a[r][ks + 2 * t + 8]);
          af[mi][3] = pair(&sm.a[r + 8][ks + 2 * t + 8]);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int col = wn + ni * 8 + g;
          bf[ni][0] = pair(&sm.b[col][ks + 2 * t]);
          bf[ni][1] = pair(&sm.b[col][ks + 2 * t + 8]);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            float* d = acc[mi][ni];
            asm volatile(
                "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
                : "r"(af[mi][0]), "r"(af[mi][1]), "r"(af[mi][2]),
                  "r"(af[mi][3]), "r"(bf[ni][0]), "r"(bf[ni][1]));
          }
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < MMA_BK; ks += 8) {
        uint32_t af[2][4], bf[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int r = wm + mi * 16 + g;
          af[mi][0] = sm.a[r][ks + t];
          af[mi][1] = sm.a[r + 8][ks + t];
          af[mi][2] = sm.a[r][ks + t + 4];
          af[mi][3] = sm.a[r + 8][ks + t + 4];
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int col = wn + ni * 8 + g;
          bf[ni][0] = sm.b[ks + t][col];
          bf[ni][1] = sm.b[ks + t + 4][col];
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            float* d = acc[mi][ni];
            asm volatile(
                "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
                : "r"(af[mi][0]), "r"(af[mi][1]), "r"(af[mi][2]),
                  "r"(af[mi][3]), "r"(bf[ni][0]), "r"(bf[ni][1]));
          }
      }
    }
    __syncthreads();
  }

  // accumulator fragment: d0, d1 at (g, 2t), (g, 2t+1); d2, d3 at row g+8
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int64_t row = m0 + wm + mi * 16 + g + (r >= 2 ? 8 : 0);
        const int64_t col = n0 + wn + ni * 8 + 2 * t + (r & 1);
        if (row < m && col < n) c[row * n + col] = acc[mi][ni][r];
      }
}

template <bool BF16>
int launch_mma(const float* a, const float* b, float* c, int64_t m,
               int64_t n, int64_t k, cudaStream_t s) {
  const int64_t tiles_n = (n + MMA_BN - 1) / MMA_BN;
  const int64_t blocks = (m + MMA_BM - 1) / MMA_BM * tiles_n;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  mma_kernel<BF16><<<(unsigned)blocks, MMA_THREADS, 0, s>>>(a, b, c, m, n, k,
                                                            tiles_n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* bm25_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int bm25_smem_optin_bytes(int device) {
  int v = 0;
  cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         device);
  return v;
}

#define SWEEP_TILE(BM, BN, BK)                                             \
  if (bm == BM && bn == BN && bk == BK)                                    \
    return launch_sweep<BM, BN, BK>(A, B, C, m, n, k, vec, s);

// E1: the (bm, bn, bk) block tile; vec selects 16-byte loads (K and N
// multiples of 4, A and B 16-byte aligned).
int bm25_matmul_sweep(const void* a, const void* b, void* c, long long m,
                      long long n, long long k, int bm, int bn, int bk,
                      int vec, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (k < 0 || (vec && (k % 4 || n % 4))) return (int)cudaErrorInvalidValue;
  const float* A = static_cast<const float*>(a);
  const float* B = static_cast<const float*>(b);
  float* C = static_cast<float*>(c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  SWEEP_TILE(64, 64, 8) SWEEP_TILE(64, 64, 16) SWEEP_TILE(64, 64, 32)
  SWEEP_TILE(128, 64, 8) SWEEP_TILE(128, 64, 16) SWEEP_TILE(128, 64, 32)
  SWEEP_TILE(128, 128, 8) SWEEP_TILE(128, 128, 16) SWEEP_TILE(128, 128, 32)
  SWEEP_TILE(256, 128, 8) SWEEP_TILE(256, 128, 16) SWEEP_TILE(256, 128, 32)
  return (int)cudaErrorInvalidValue;
}
#undef SWEEP_TILE

// E2: strips of strip_m (8, 16 or 32) rows of A held in shared memory;
// blocks <= 0 launches one block per strip, else that many blocks walk the
// strips.  An A strip plus staging above the card's opt-in limit of shared
// memory per block is refused (cudaErrorInvalidValue).
int bm25_matmul_row_strip(const void* a, const void* b, void* c, long long m,
                          long long n, long long k, int strip_m, int blocks,
                          void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (k < 0) return (int)cudaErrorInvalidValue;
  const float* A = static_cast<const float*>(a);
  const float* B = static_cast<const float*>(b);
  float* C = static_cast<float*>(c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (strip_m == 8) return launch_row_strip<8>(A, B, C, m, n, k, blocks, s);
  if (strip_m == 16) return launch_row_strip<16>(A, B, C, m, n, k, blocks, s);
  if (strip_m == 32) return launch_row_strip<32>(A, B, C, m, n, k, blocks, s);
  return (int)cudaErrorInvalidValue;
}

#define PIPE(T, BK, S)                                                     \
  if (tile == T && stages == S)                                            \
    return launch_pipelined<T, T, BK, S>(A, B, C, m, n, k, s);

// E3: a tile x tile block tile (64 or 128, K step 16) fed by a `stages`-slot
// (2, 3 or 4) cp.async ring; K and N multiples of 4, A and B 16-byte aligned.
int bm25_matmul_pipelined(const void* a, const void* b, void* c, long long m,
                          long long n, long long k, int tile, int stages,
                          void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (k < 0 || k % 4 || n % 4 || reinterpret_cast<uintptr_t>(a) % 16 ||
      reinterpret_cast<uintptr_t>(b) % 16)
    return (int)cudaErrorInvalidValue;
  const float* A = static_cast<const float*>(a);
  const float* B = static_cast<const float*>(b);
  float* C = static_cast<float*>(c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  PIPE(64, 16, 2) PIPE(64, 16, 3) PIPE(64, 16, 4)
  PIPE(128, 16, 2) PIPE(128, 16, 3) PIPE(128, 16, 4)
  return (int)cudaErrorInvalidValue;
}
#undef PIPE

// E4: tensor-core product of the rounded inputs, bf16 (bf16 != 0) or TF32.
int bm25_matmul_mma(const void* a, const void* b, void* c, long long m,
                    long long n, long long k, int bf16, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (k < 0) return (int)cudaErrorInvalidValue;
  const float* A = static_cast<const float*>(a);
  const float* B = static_cast<const float*>(b);
  float* C = static_cast<float*>(c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_mma<true>(A, B, C, m, n, k, s)
              : launch_mma<false>(A, B, C, m, n, k, s);
}

}  // extern "C"
