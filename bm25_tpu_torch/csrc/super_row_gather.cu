// Selection-gather kernels for Hopper (sm_90a).
//
// Replace the Pallas kernels of three TPU experiments on one function, the
// top-k tree's winning-group gather:
//   * scripts/exp_r4_pallas_gather.py:64 (kernel :51)
//       -> bm25_super_row_gather           (E5, direct)
//   * scripts/exp_r4_window_gather.py:87 (kernel :60)
//       -> bm25_super_row_gather_window    (E6, sorted window)
//   * scripts/exp_r4_dyngather.py:100 (kernel :75)
//       -> bm25_super_row_gather_resident  (E7, table in shared memory)
//
//   out[q, j, :] = x3[q, rowof[q, j], :]
//
// x3 (Q, R, 128) f32 is a query's score row cut into 128-wide super-rows,
// rowof (Q, KP) int32 the winners' row ids, out (Q, KP, 128) f32.  It is a
// pure copy, so every kernel equals the plain gather bit for bit.  A row id
// outside [0, R) is a caller error; the kernels clamp it into range so that
// no access leaves the query's rows.
//
// Design.  A super-row is 512 bytes: one warp moves it with one 16-byte
// load and one 16-byte store per lane, both coalesced.
//   * Direct (E5): one warp per output super-row, ROWS_PER_WARP rows per
//     warp in turn; lane i < ROWS_PER_WARP reads the i-th row id and the
//     warp shares it by shuffle, so each id is read once per warp.  The TPU
//     kernel keeps the whole 1 MB query row in VMEM and serves rows from
//     there; a block has at most 227 KB of shared memory, so here the 50 MB
//     L2 serves repeated rows instead.  The TPU's unroll sweep (1/4/8/16)
//     becomes the rows-per-warp sweep.
//   * Window (E6): winners sorted ascending within a query.  One block of 8
//     warps per tile of 8 winners stages the 8-aligned window
//     [w0a, w0a + W), w0a = min(8 * floor(w0 / 8), R - W), into shared
//     memory by cp.async and serves the 8 rows from it, one warp each.
//     When w7 - w0a >= W (the tile's span does not fit the window) it takes
//     the script's own fallback: 8 direct row loads, counted in *fallbacks.
//     A row outside the window (unsorted input) is also loaded directly, so
//     the result is the gather for any input.  Requires R >= W, W % 8 == 0
//     and KP % 8 == 0 (the wrapper checks).  The TPU layout of the ids,
//     [q, s, t] = rowof[q, 8t + s] for its scalar memory, is not carried:
//     tile t reads rowof[q, 8t : 8t + 8] directly.
//   * Resident (E7): one block per query stages the whole (H, 128) table in
//     shared memory by cp.async and serves the KP rows from it: E5's "row
//     in fast memory", where it fits this card (H * 512 bytes up to the
//     opt-in limit, 227 KB: H <= 454).  Above 48 KB the launcher opts in
//     with cudaFuncSetAttribute.
//
// What bounds it on an H100: bytes.  Each kernel writes Q * KP * 512 bytes
// and needs each distinct (query, row) read once; at the scripts' shape
// (Q = 512, R = 2048, KP = 1024) that is up to 268 MB read and 268 MB
// written, about 0.16 ms at 3.35 TB/s.  The window kernel reads W rows per
// tile of 8 (4-6 times the direct kernel's reads, mostly from L2); the
// resident kernel reads the whole table once per query.
//
// Offsets are int64: Q * R * 128 passes 2^31 at the scripts' shape.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int VEC_PER_ROW = 32;  // float4s per 128-wide super-row
constexpr int DIRECT_WARPS = 8;
constexpr int WINDOW_ROWS = 8;  // winners per window tile, one warp each
constexpr int RESIDENT_THREADS = 512;
constexpr int DEFAULT_SMEM = 48 * 1024;

__device__ __forceinline__ int clamp_row(int r, int rows) {
  return r < 0 ? 0 : (r >= rows ? rows - 1 : r);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

template <int RPW>
__global__ void __launch_bounds__(DIRECT_WARPS * 32)
super_row_gather_kernel(const float4* __restrict__ x,
                        const int* __restrict__ rowof, int64_t rows_total,
                        int kp, int r_count, float4* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t first =
      ((int64_t)blockIdx.x * DIRECT_WARPS + (threadIdx.x >> 5)) * RPW;
  int mine = 0;
  if (lane < RPW && first + lane < rows_total)
    mine = __ldg(rowof + first + lane);
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = clamp_row(__shfl_sync(0xffffffffu, mine, i), r_count);
    const int64_t row = first + i;  // warp-uniform
    if (row >= rows_total) break;
    const int64_t q = row / kp;
    out[row * VEC_PER_ROW + lane] =
        __ldg(x + (q * r_count + r) * VEC_PER_ROW + lane);
  }
}

__global__ void __launch_bounds__(WINDOW_ROWS * 32)
super_row_gather_window_kernel(const float4* __restrict__ x,
                               const int* __restrict__ rowof, int kp,
                               int r_count, int w, float4* __restrict__ out,
                               int* __restrict__ fallbacks) {
  extern __shared__ float4 win[];  // (w, 32)
  const int64_t tile = blockIdx.x;  // over Q * KP / 8
  const int64_t j0 = tile * WINDOW_ROWS;  // flat (q, j) of the tile's first
  const int64_t q = j0 / kp;
  const float4* xq = x + q * r_count * VEC_PER_ROW;
  const int w0 = clamp_row(__ldg(rowof + j0), r_count);
  const int w7 = clamp_row(__ldg(rowof + j0 + WINDOW_ROWS - 1), r_count);
  const int w0a = min((w0 / 8) * 8, r_count - w);
  const bool direct = w7 - w0a >= w;  // block-uniform
  if (!direct) {
    const float4* src = xq + (int64_t)w0a * VEC_PER_ROW;
    for (int i = threadIdx.x; i < w * VEC_PER_ROW; i += blockDim.x)
      cp_async16(win + i, src + i);
    cp_async_wait_all();
  } else if (threadIdx.x == 0 && fallbacks != nullptr) {
    atomicAdd(fallbacks, 1);
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = clamp_row(__ldg(rowof + j0 + warp), r_count);
  const int rel = r - w0a;
  const float4 v = (!direct && rel >= 0 && rel < w)
                       ? win[rel * VEC_PER_ROW + lane]
                       : __ldg(xq + (int64_t)r * VEC_PER_ROW + lane);
  out[(j0 + warp) * VEC_PER_ROW + lane] = v;
}

__global__ void __launch_bounds__(RESIDENT_THREADS)
super_row_gather_resident_kernel(const float4* __restrict__ x,
                                 const int* __restrict__ rowof, int kp,
                                 int h, float4* __restrict__ out) {
  extern __shared__ float4 table[];  // (h, 32)
  const int64_t q = blockIdx.x;
  const float4* xq = x + q * h * VEC_PER_ROW;
  for (int i = threadIdx.x; i < h * VEC_PER_ROW; i += blockDim.x)
    cp_async16(table + i, xq + i);
  cp_async_wait_all();
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int* rq = rowof + q * kp;
  float4* oq = out + q * kp * VEC_PER_ROW;
  for (int j = warp; j < kp; j += RESIDENT_THREADS / 32) {
    const int r = clamp_row(__ldg(rq + j), h);
    oq[(int64_t)j * VEC_PER_ROW + lane] = table[r * VEC_PER_ROW + lane];
  }
}

template <typename K>
int opt_in_smem(K kernel, size_t bytes) {
  if (bytes <= DEFAULT_SMEM) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int RPW>
int launch_direct(const float4* x, const int* rowof, int64_t rows_total,
                  int kp, int r_count, float4* out, cudaStream_t s) {
  const int64_t per_block = (int64_t)DIRECT_WARPS * RPW;
  const int64_t blocks = (rows_total + per_block - 1) / per_block;
  super_row_gather_kernel<RPW><<<(unsigned)blocks, DIRECT_WARPS * 32, 0, s>>>(
      x, rowof, rows_total, kp, r_count, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* bm25_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The card's opt-in limit of dynamic shared memory per block, in bytes
// (0 on error).
int bm25_smem_optin_bytes(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  return v;
}

// E5: x3 (Q, R, 128) f32, rowof (Q, KP) int32 -> out (Q, KP, 128) f32;
// rows_per_warp is 1, 4, 8 or 16.
int bm25_super_row_gather(const void* x3, const int* rowof, int q_count,
                          int r_count, int kp, int rows_per_warp, void* out,
                          void* stream) {
  const int64_t rows_total = (int64_t)q_count * kp;
  if (rows_total <= 0) return 0;
  if (r_count <= 0) return (int)cudaErrorInvalidValue;
  const float4* x = static_cast<const float4*>(x3);
  float4* o = static_cast<float4*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rows_per_warp) {
    case 1: return launch_direct<1>(x, rowof, rows_total, kp, r_count, o, s);
    case 4: return launch_direct<4>(x, rowof, rows_total, kp, r_count, o, s);
    case 8: return launch_direct<8>(x, rowof, rows_total, kp, r_count, o, s);
    case 16: return launch_direct<16>(x, rowof, rows_total, kp, r_count, o, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// E6: as E5 with winners sorted within each query; window w rows (w % 8 ==
// 0, w <= R), KP % 8 == 0.  fallbacks (one int32, may be null) gains the
// number of tiles served by direct loads.
int bm25_super_row_gather_window(const void* x3, const int* rowof,
                                 int q_count, int r_count, int kp, int w,
                                 void* out, int* fallbacks, void* stream) {
  const int64_t tiles = (int64_t)q_count * (kp / WINDOW_ROWS);
  if (tiles <= 0) return 0;
  if (w <= 0 || w % 8 || w > r_count || kp % WINDOW_ROWS)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)w * VEC_PER_ROW * sizeof(float4);
  int err = opt_in_smem(super_row_gather_window_kernel, smem);
  if (err) return err;
  super_row_gather_window_kernel<<<(unsigned)tiles, WINDOW_ROWS * 32, smem,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x3), rowof, kp, r_count, w,
      static_cast<float4*>(out), fallbacks);
  return (int)cudaGetLastError();
}

// E7: x3 (Q, H, 128) f32 staged whole per query (H * 512 bytes of shared
// memory), rowof (Q, KP) int32 -> out (Q, KP, 128) f32.
int bm25_super_row_gather_resident(const void* x3, const int* rowof,
                                   int q_count, int h, int kp, void* out,
                                   void* stream) {
  if ((int64_t)q_count * kp <= 0) return 0;
  if (h <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)h * VEC_PER_ROW * sizeof(float4);
  int err = opt_in_smem(super_row_gather_resident_kernel, smem);
  if (err) return err;
  super_row_gather_resident_kernel<<<(unsigned)q_count, RESIDENT_THREADS,
                                     smem,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x3), rowof, kp, h,
      static_cast<float4*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
