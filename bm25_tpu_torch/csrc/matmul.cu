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
// matmul_tiled: shared-memory block tiling with register blocking, the
// counterpart of the reference's block_tiled_vectorized kernel (its body,
// matmul_tiled_kernel, is in matmul_tiled.cuh, shared with E1's
// matmul_sweep in matmul_schedules.cu).  A block
// of 256 threads owns a BM x BN tile of C; per step of BK along K it
// stages the BM x BK slice of A (transposed, so a thread's TM rows are
// contiguous) and the BK x BN slice of B in shared memory, then each
// thread does TM x TN FMAs per k on f32 accumulators held in registers.
// Instantiated tiles (BM = BN, TM = TN): 128 x 128 (TM 8, the reference's
// shape) and 64 x 64 (TM 4), with BK 16 for f32 and BK 8 for bf16 (the
// faster K step of each dtype at 1028^3 on an H100).  Ragged M, N and K
// are masked in the kernel (no padded copies).  Loads are 16 bytes wide
// (4 f32 or 8 bf16) where K and N are multiples of that width and A and
// B are 16-byte aligned; otherwise the scalar instantiation runs.
//
// What bounds it on an H100: f32 FMA issue.  At the reference's 1028^3
// shape B6 does 2.17 GFLOP over 12.7 MB of operands, ~170 FLOP per byte,
// far above the card's ridge, so the CUDA cores' 67 TFLOP/s f32 peak is
// the ceiling.  A 128 x 128 tile gives 9 x 9 = 81 blocks for 132 SMs,
// under one wave; the wrapper picks the tile by block count (64 x 64:
// 289 blocks there).  The 8 x 8 register tile makes 64 FMAs for 16
// shared-memory reads per k, and a warp's reads of A are broadcasts.
// Single-buffered staging (a barrier per BK step) is the simple first
// version: cp.async/TMA pipelining and tensor cores are later work.
//
// All offsets are int64.

#include "matmul_tiled.cuh"  // matmul_tiled_kernel, shared with E1

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

template <typename T, int BM, int BK, int TM, bool VEC>
int launch_tiled(const void* a, const void* b, void* c, int64_t m, int64_t n,
                 int64_t k, cudaStream_t s) {
  const int64_t tiles_n = (n + BM - 1) / BM;
  const int64_t blocks = (m + BM - 1) / BM * tiles_n;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  matmul_tiled_kernel<T, BM, BM, BK, TM, TM, VEC>
      <<<(unsigned)blocks, TILED_THREADS, 0, s>>>(
          static_cast<const T*>(a), static_cast<const T*>(b),
          static_cast<T*>(c), m, n, k, tiles_n);
  return (int)cudaGetLastError();
}

template <typename T, bool VEC>
int dispatch_tiled(const void* a, const void* b, void* c, int64_t m,
                   int64_t n, int64_t k, int tile, cudaStream_t s) {
  constexpr int BK = sizeof(T) == 4 ? 16 : 8;  // f32 : bf16
  if (tile == 128) return launch_tiled<T, 128, BK, 8, VEC>(a, b, c, m, n, k, s);
  if (tile == 64) return launch_tiled<T, 64, BK, 4, VEC>(a, b, c, m, n, k, s);
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

// B6, block-tiled: the same product with a tile x tile block tile (128 or
// 64) and a K step of 16 (f32) or 8 (bf16).  vec selects the 16-byte
// loads: K and N multiples of 4 (f32) or 8 (bf16), A and B 16-byte aligned.
int bm25_matmul_tiled(const void* a, const void* b, void* c, long long m,
                      long long n, long long k, int bf16, int tile, int vec,
                      void* stream) {
  if (m <= 0 || n <= 0) return 0;
  const int vw = bf16 ? 8 : 4;
  if (k < 0 || (vec && (k % vw || n % vw))) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return vec ? dispatch_tiled<__nv_bfloat16, true>(a, b, c, m, n, k, tile, s)
               : dispatch_tiled<__nv_bfloat16, false>(a, b, c, m, n, k, tile,
                                                      s);
  return vec ? dispatch_tiled<float, true>(a, b, c, m, n, k, tile, s)
             : dispatch_tiled<float, false>(a, b, c, m, n, k, tile, s);
}

}  // extern "C"
