// The block-tiled f32-accumulating product C = A @ B for Hopper (sm_90a),
// shared by B6's matmul_tiled (matmul.cu) and E1's matmul_sweep
// (matmul_schedules.cu), which instantiate it at their own tiles.
//
// A block of 256 threads owns a BM x BN tile of C; per step of BK along K
// it stages the BM x BK slice of A (transposed, so a thread's TM rows are
// contiguous) and the BK x BN slice of B in shared memory, then each
// thread does TM x TN FMAs per k on f32 accumulators held in registers
// over the whole K loop; C is written once.  Every output sums k in
// ascending order from +0, one __fmaf_rn per product, and the K tail of
// the last step is cut by the loop bound (no product of padding is added),
// so the result has the bits of the plain twin ops/matmul.py::matmul_plain.
// Ragged M, N and K are masked in the kernel.  With VEC, loads are 16
// bytes wide (4 f32 or 8 bf16): K and N must be multiples of that width
// and A and B 16-byte aligned.  Single-buffered: a barrier per BK step.
//
// All offsets are int64.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TILED_THREADS = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// VW consecutive values from global memory, widened to f32; VW > 1 only
// from a 16-byte aligned address (4 f32 or 8 bf16).
template <typename T, int VW>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[VW]) {
  if constexpr (VW == 1) {
    v[0] = to_f32(__ldg(p));
  } else {
    static_assert(VW * sizeof(T) == 16, "16-byte vectors only");
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
    if constexpr (sizeof(T) == 4) {
      v[0] = __uint_as_float(x.x); v[1] = __uint_as_float(x.y);
      v[2] = __uint_as_float(x.z); v[3] = __uint_as_float(x.w);
    } else {  // a bf16 is the top half of its f32: widen by shifting
      const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[2 * i] = __uint_as_float(w[i] << 16);
        v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    }
  }
}

template <typename T, int BM, int BN, int BK, int TM, int TN, bool VEC>
__global__ void __launch_bounds__(TILED_THREADS)
matmul_tiled_kernel(const T* __restrict__ a, const T* __restrict__ b,
                    T* __restrict__ c, int64_t m, int64_t n, int64_t k,
                    int64_t tiles_n) {
  static_assert((BM / TM) * (BN / TN) == TILED_THREADS, "256 threads");
  constexpr int VW = VEC ? 16 / (int)sizeof(T) : 1;
  static_assert(BK % VW == 0 && BN % VW == 0, "tile not a vector multiple");
  __shared__ float as[BK][BM];  // A's slice, transposed
  __shared__ float bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int64_t m0 = (int64_t)(blockIdx.x / tiles_n) * BM;
  const int64_t n0 = (int64_t)(blockIdx.x % tiles_n) * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int64_t k0 = 0; k0 < k; k0 += BK) {
    // stage A[m0 : m0+BM, k0 : k0+BK] (vectors along k; with VEC, K is a
    // multiple of VW, so a vector is wholly inside or outside K)
    constexpr int A_VECS = BM * BK / VW;
#pragma unroll
    for (int it = 0; it < (A_VECS + TILED_THREADS - 1) / TILED_THREADS; ++it) {
      const int i = tid + it * TILED_THREADS;
      if (A_VECS % TILED_THREADS && i >= A_VECS) break;
      const int r = i / (BK / VW);
      const int kk = (i % (BK / VW)) * VW;
      float v[VW];
      if (m0 + r < m && k0 + kk < k) {
        load_vec<T, VW>(a + (m0 + r) * k + k0 + kk, v);
      } else {
#pragma unroll
        for (int j = 0; j < VW; ++j) v[j] = 0.0f;
      }
#pragma unroll
      for (int j = 0; j < VW; ++j) as[kk + j][r] = v[j];
    }
    // stage B[k0 : k0+BK, n0 : n0+BN] (vectors along n)
    constexpr int B_VECS = BK * BN / VW;
#pragma unroll
    for (int it = 0; it < (B_VECS + TILED_THREADS - 1) / TILED_THREADS; ++it) {
      const int i = tid + it * TILED_THREADS;
      if (B_VECS % TILED_THREADS && i >= B_VECS) break;
      const int kk = i / (BN / VW);
      const int col = (i % (BN / VW)) * VW;
      float v[VW];
      if (k0 + kk < k && n0 + col < n) {
        load_vec<T, VW>(b + (k0 + kk) * n + n0 + col, v);
      } else {
#pragma unroll
        for (int j = 0; j < VW; ++j) v[j] = 0.0f;
      }
#pragma unroll
      for (int j = 0; j < VW; ++j) bs[kk][col + j] = v[j];
    }
    __syncthreads();

    // the K tail stops at K exactly: no product of padding is added
    const int kmax = k - k0 < BK ? (int)(k - k0) : BK;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      if (kk < kmax) {
        float ra[TM], rb[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) ra[i] = as[kk][ty * TM + i];
#pragma unroll
        for (int j = 0; j < TN; ++j) rb[j] = bs[kk][tx * TN + j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = __fmaf_rn(ra[i], rb[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t row = m0 + ty * TM + i;
    if (row >= m) break;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t col = n0 + tx * TN + j;
      if (col < n) store(c + row * n + col, acc[i][j]);
    }
  }
}

}  // namespace
