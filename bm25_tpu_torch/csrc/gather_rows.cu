// Gather-accumulate kernel for Hopper (sm_90a).
//
// Replaces the Pallas kernel of bm25_tpu/ops/gather_rows.py:
//   * _gather_add_rows_pallas (:56)  -> bm25_gather_add_rows  (B3)
//
//   out[q, :] = sum_t w[q, t] * table[ids[q, t], :]     (w = 1 unweighted)
//
// the dense engine's scoring step: a query's token rows of the token-major
// (V, D) score table, summed.
//
// Design.  One thread owns VEC neighbouring columns of one query's output;
// a block is 256 threads (1024 columns with VEC = 4) and the grid is
// (column tiles, queries).  The thread walks t in order, loads its VEC
// columns of row ids[q, t] with one vector load (float4 for f32, 8 bytes
// for bf16), accumulates in registers and stores once.  Neighbouring
// threads read neighbouring addresses of the same row, so every row read
// is coalesced; a query's ids are the same for the whole block and come
// through the cache as broadcasts.  The TPU kernel walks the token axis
// as the innermost grid dimension with the output block resident in VMEM;
// here that loop runs inside the thread.  A D that is not a multiple of 4
// (or a table that is not 16-byte aligned) takes the scalar instantiation.
//
// Exactness.  The f32 order is the JAX package's: from +0, t ascending.
// Unweighted, each row is added with one rounding (__fadd_rn).  Weighted,
// acc + w * row rounds once, as a fused multiply-add (__fmaf_rn): that is
// what XLA compiles the JAX scan to, checked on the CPU.  A bf16 table
// accumulates in bf16 as JAX does (its accumulator has the table's dtype):
// the weight is rounded to bf16, the product w * row (exact in f32) is
// rounded to bf16, and the running sum is rounded to bf16 after every
// token; a sum of two bf16 values rounded once in f32 and then to bf16 is
// the exactly rounded bf16 sum, so this equals bf16 arithmetic.
//
// What bounds it on an H100: bytes.  Per call it reads Q * T rows of D
// table values and writes Q * D values; at the dense main path (512
// queries x 8 tokens over 131,072 doc columns) that is 2.15 GB read and
// 0.27 GB written, about 0.72 ms at 3.35 TB/s.  The arithmetic is one
// add or FMA per loaded value.  Duplicate ids in a query re-read the row
// (the L2 cache serves the repeat).  TMA staging is later work.
//
// Offsets are int64: ids * D passes 2^31 at the main shape (32,776 rows
// x 131,072 columns).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_GRID_Y = 65535;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = __ldg(p + i);
  }
}

template <int VEC>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&x.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&x.y);
    v[0] = __low2float(a); v[1] = __high2float(a);
    v[2] = __low2float(b); v[3] = __high2float(b);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = __bfloat162float(p[i]);
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = v[i];
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&v)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) p[i] = __float2bfloat16_rn(v[i]);
}

template <typename T, int VEC, bool WEIGHTED>
__global__ void __launch_bounds__(THREADS)
gather_add_rows_kernel(const T* __restrict__ table, int64_t d,
                       const int* __restrict__ ids,
                       const float* __restrict__ weights, int q_count,
                       int t_count, T* __restrict__ out) {
  constexpr bool BF16 = sizeof(T) == 2;
  const int64_t col = ((int64_t)blockIdx.x * THREADS + threadIdx.x) * VEC;
  if (col >= d) return;
  for (int q = blockIdx.y; q < q_count; q += gridDim.y) {
    const int* qi = ids + (int64_t)q * t_count;
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
#pragma unroll 4
    for (int t = 0; t < t_count; ++t) {
      float row[VEC];
      load_vec<VEC>(table + (int64_t)__ldg(qi + t) * d + col, row);
      if constexpr (WEIGHTED) {
        float w = __ldg(weights + (int64_t)q * t_count + t);
        if constexpr (BF16) w = round_bf16(w);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          if constexpr (BF16)
            acc[i] = round_bf16(__fadd_rn(acc[i], round_bf16(__fmul_rn(w, row[i]))));
          else
            acc[i] = __fmaf_rn(w, row[i], acc[i]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          acc[i] = __fadd_rn(acc[i], row[i]);
          if constexpr (BF16) acc[i] = round_bf16(acc[i]);
        }
      }
    }
    store_vec<VEC>(out + (int64_t)q * d + col, acc);
  }
}

template <typename T, int VEC>
int launch(const void* table, int64_t d, const int* ids, const float* weights,
           int q_count, int t_count, void* out, cudaStream_t stream) {
  const int64_t tiles = (d / VEC + THREADS - 1) / THREADS;
  const dim3 grid((unsigned)tiles, (unsigned)(q_count < MAX_GRID_Y ? q_count
                                                                  : MAX_GRID_Y));
  const T* tb = static_cast<const T*>(table);
  T* o = static_cast<T*>(out);
  if (weights)
    gather_add_rows_kernel<T, VEC, true><<<grid, THREADS, 0, stream>>>(
        tb, d, ids, weights, q_count, t_count, o);
  else
    gather_add_rows_kernel<T, VEC, false><<<grid, THREADS, 0, stream>>>(
        tb, d, ids, weights, q_count, t_count, o);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* bm25_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// B3: (V, D) table (f32, or bf16 when bf16 != 0), (Q, T) int32 ids in
// [0, V), optional (Q, T) f32 weights -> out (Q, D) in the table's dtype.
// vec is 4 (D % 4 == 0, table and out 16-byte aligned) or 1.
int bm25_gather_add_rows(const void* table, long long d, int bf16,
                         const int* ids, const float* weights, int q_count,
                         int t_count, int vec, void* out, void* stream) {
  if (q_count <= 0 || d <= 0) return 0;
  if (t_count < 0 || (vec != 1 && vec != 4) || d % vec ||
      d / vec > (int64_t)THREADS * 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return vec == 4
        ? launch<__nv_bfloat16, 4>(table, d, ids, weights, q_count, t_count, out, s)
        : launch<__nv_bfloat16, 1>(table, d, ids, weights, q_count, t_count, out, s);
  return vec == 4
      ? launch<float, 4>(table, d, ids, weights, q_count, t_count, out, s)
      : launch<float, 1>(table, d, ids, weights, q_count, t_count, out, s);
}

}  // extern "C"
