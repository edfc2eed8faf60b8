// Matrix-product kernels for Hopper (sm_90a).
//
// Replaces the Pallas kernels of bm25_tpu/ops/matmul.py::matmul (:127):
//   * the naive schedule (pallas_call :164)             -> bm25_matmul_naive
//   * the optimized schedules: resident C (:209) and the
//     K-tiled accumulation (:256)                        -> bm25_matmul_tiled
//
//   C[m, n] = sum_k A[m, k] * B[k, n]
//
// A (M, K) and B (K, N) are row-major f32 or bf16; the sum is taken in
// f32 and C has A's dtype (rounded once, to nearest even, for bf16).
//
// Exactness.  Every output sums k in ascending order from +0, one
// __fmaf_rn per product (a bf16 input widens to f32 exactly, and a product
// of two bf16 values is exact in f32).  Both kernels therefore give the
// same bits, and so does their plain twin (ops/matmul.py::matmul_plain, a
// loop of f32 fused multiply-adds over k).  No TF32 and no tensor cores:
// a later mma/wgmma version changes only the order of summation.  The
// K tail of the last tile is cut by the loop bound, not padded with
// zeros, so not even the sign of a zero differs from the twin.
//
// matmul_naive: one thread per output element, the counterpart of the
// reference's naive GPU kernel.  A block of 32 x 32 threads covers a
// 32 x 32 tile of C; each thread walks its row of A
// (a broadcast across the warp) and its column of B (coalesced across
// the warp).  Every operand is re-read from L2 once per output tile row
// or column: it is bound by load issue, and is the baseline.
//
// matmul_tiled ("optimized"): the TMA ring body of matmul_ring.cuh (shared
// with E1's matmul_sweep and E3's matmul_pipelined), typed for f32 and
// bf16, on a balanced walk of its C tiles.  A producer warp streams A's
// and B's boxes by TMA into a ring of stages on mbarriers; 8 consumer
// warps, a 2 x 4 grid, hold register tiles of R rows x 4 columns a lane,
// reading 16 bytes at a time from A rows padded onto separate banks;
// bf16 widens to f32 on read.  Tiles (BM x BN x BK, R): 128 x 128 x 64
// (16) for f32 and x 32 for bf16, whose threads keep 64 accumulators, one
// block an SM; 64 x 128 x 32 (8), two blocks an SM.  ops/matmul.py::
// b6_plan picks the tile, the ring depth that fits and min(tiles, SMs x
// blocks an SM) blocks; block b walks tiles b, b + grid, ... of the order
// full tiles first, then the thin edge tiles, so the edges land beside
// the least work, and the producer runs into a block's next tile while
// its consumers store the last one.  A thin tile gives one (row, 4
// columns) item to each consumer thread; its ring still streams a stage
// per BK of K, which is slow next to its few FMAs, so it gains most from
// running beside a full tile, as the second block of an SM.  No split-K
// and no atomics: every C element is written once, by one chain over k.
//
// What bounds it on an H100: f32 FMA issue.  At the reference's 1028^3
// shape B6 does 2.17 GFLOP over 12.7 MB of operands, ~170 FLOP per byte,
// far above the card's ridge, so the CUDA cores' 67 TFLOP/s f32 peak is
// the ceiling (0.0324 ms).  Filling the SMs is the other half: 1028 =
// 8 x 128 + 4, so 128 x 128 tiles (81 blocks) leave a busiest SM with
// 16.8 M FMAs, twice an even share; 64 x 128 tiles give 128 full tiles,
// one an SM, and 25 thin ones beside them, 1.09 x an even share.  TMA
// takes row strides of whole 16-byte units from 16-byte aligned bases:
// the wrapper stages any other operand (a bf16 row of 1028 values is
// 2,056 bytes) into a padded copy.
//
// All offsets are int64.

#include "matmul_ring.cuh"  // the ring body, shared with E1 and E3

namespace {

constexpr int NAIVE_BLOCK = 32;  // rows and columns of C per naive block

template <typename T>
__global__ void matmul_naive_kernel(const T* __restrict__ a,
                                    const T* __restrict__ b,
                                    T* __restrict__ c, int64_t m, int64_t n,
                                    int64_t k, int64_t tiles_n) {
  const int64_t tile_m = blockIdx.x / tiles_n;
  const int64_t tile_n = blockIdx.x % tiles_n;
  const int64_t row = tile_m * NAIVE_BLOCK + threadIdx.y;
  const int64_t col = tile_n * NAIVE_BLOCK + threadIdx.x;
  if (row >= m || col >= n) return;
  const T* ar = a + row * k;
  const T* bc = b + col;
  float acc = 0.0f;
  for (int64_t kk = 0; kk < k; ++kk)
    acc = __fmaf_rn(to_f32(__ldg(ar + kk)), to_f32(__ldg(bc + kk * n)), acc);
  store(c + row * n + col, acc);
}

template <typename T>
int launch_naive(const void* a, const void* b, void* c, int64_t m, int64_t n,
                 int64_t k, cudaStream_t s) {
  const int64_t tiles_n = (n + NAIVE_BLOCK - 1) / NAIVE_BLOCK;
  const int64_t blocks = (m + NAIVE_BLOCK - 1) / NAIVE_BLOCK * tiles_n;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  matmul_naive_kernel<T>
      <<<(unsigned)blocks, dim3(NAIVE_BLOCK, NAIVE_BLOCK), 0, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      m, n, k, tiles_n);
  return (int)cudaGetLastError();
}

// B6's tiles: (BM, BN, BK) and the rows R a consumer thread holds
template <typename T>
int launch_b6(const void* a, const void* b, void* c, int64_t m, int64_t n,
              int64_t k, int64_t lda, int64_t ldb, int bm, int bn, int bk,
              int stages, int64_t grid, int dev, cudaStream_t s) {
  constexpr bool F32 = sizeof(T) == 4;
  const T* A = static_cast<const T*>(a);
  const T* B = static_cast<const T*>(b);
  T* C = static_cast<T*>(c);
  if (bm == 128 && bn == 128 && bk == (F32 ? 64 : 32))
    return launch_ring<T, 128, 128, F32 ? 64 : 32, 16, true>(
        A, B, C, m, n, k, lda, ldb, stages, grid, dev, s);
  if (bm == 64 && bn == 128 && bk == 32)
    return launch_ring<T, 64, 128, 32, 8, true>(A, B, C, m, n, k, lda, ldb,
                                               stages, grid, dev, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* bm25_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// B6, naive: row-major (M, K) @ (K, N) -> C (M, N), all f32, or all bf16
// when bf16 != 0.
int bm25_matmul_naive(const void* a, const void* b, void* c, long long m,
                      long long n, long long k, int bf16, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (k < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_naive<__nv_bfloat16>(a, b, c, m, n, k, s)
              : launch_naive<float>(a, b, c, m, n, k, s);
}

int bm25_smem_optin_bytes(int device) {
  int v = 0;
  cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         device);
  return v;
}

// B6, optimized: the same product on the ring, all f32 or all bf16, with
// a bm x bn x bk tile (128 x 128 x 64 or 64 x 128 x 32 for f32, 128 x 128
// x 32 or 64 x 128 x 32 for bf16), a ring of `stages` (2 to
// RING_MAX_STAGES) and `grid` blocks (1 to the tile count).  A (M, K) and
// B (K, N) have row strides lda >= K and ldb >= N elements, whole 16-byte
// units, from 16-byte aligned bases (TMA's rule); the loops stop at the
// real M, N, K.
int bm25_matmul_tiled(const void* a, const void* b, void* c, long long m,
                      long long n, long long k, long long lda, long long ldb,
                      int bf16, int bm, int bn, int bk, int stages,
                      long long grid, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  const int64_t esize = bf16 ? 2 : 4;
  if (k < 0 || lda < k || ldb < n || (lda * esize) % 16 ||
      (ldb * esize) % 16 || reinterpret_cast<uintptr_t>(a) % 16 ||
      reinterpret_cast<uintptr_t>(b) % 16 || stages < 2 ||
      stages > RING_MAX_STAGES)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  if (int err = cudaGetDevice(&dev)) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_b6<__nv_bfloat16>(a, b, c, m, n, k, lda, ldb, bm, bn,
                                         bk, stages, grid, dev, s)
              : launch_b6<float>(a, b, c, m, n, k, lda, ldb, bm, bn, bk,
                                 stages, grid, dev, s);
}

}  // extern "C"
