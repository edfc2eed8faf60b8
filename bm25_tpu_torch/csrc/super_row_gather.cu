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
//   * Window (E6): winners sorted ascending within a query.  The TPU
//     kernel stages an 8-aligned window of W rows for each tile of 8
//     winners; here the window becomes the depth of a ring of W row slots
//     in shared memory that slides along the query's ids.  One block walks
//     a run of WINDOW_RUN = 64 slots of one query (runs of 64 beat 128
//     and 256 at the scripts' shape on an H100: more blocks even out the
//     SMs' share).  Its threads first mark the run's distinct rows (a slot
//     whose id differs from the slot before it: sorted ids put duplicates
//     side by side), so each distinct row is read from global memory once
//     per run, and only rows some winner names.  A producer lane copies
//     them in order into the ring, one
//     512-byte cp.async.bulk each on the slot's full mbarrier, up to W
//     ahead of the stores; consumer warps take the distinct rows in turn
//     (u = warp, warp + WINDOW_WARPS, ...; W % WINDOW_WARPS == 0, so the
//     warp that frees a slot is the one that next waits on it), read the
//     row into registers, free the slot on its empty mbarrier and write
//     it to every slot of the run that names it with streaming stores
//     (st.global.cs), so the output does not evict the input from L2.
//     An unsorted id only starts another distinct row, so the result is
//     the gather for any input, with no direct path.  The script's
//     fallback (8 direct row loads where a tile's span w7 - w0a >= W) is
//     no longer a path here; *fallbacks still gains the number of such
//     tiles, w0a = min(8 * floor(w0 / 8), R - W), a statement about the
//     input.  Requires R >= W, W % 8 == 0 and KP % 8 == 0 (the wrapper
//     checks).  The TPU layout of the ids, [q, s, t] = rowof[q, 8t + s]
//     for its scalar memory, is not carried.
//   * Resident (E7): one block per query stages the whole (H, 128) table in
//     shared memory by cp.async and serves the KP rows from it: E5's "row
//     in fast memory", where it fits this card (H * 512 bytes up to the
//     opt-in limit, 227 KB: H <= 454).  Above 48 KB the launcher opts in
//     with cudaFuncSetAttribute.
//
// What bounds it on an H100: bytes.  Each kernel writes Q * KP * 512 bytes
// and needs each distinct (query, row) read once; at the scripts' shape
// (Q = 512, R = 2048, KP = 1024) that is up to 268 MB read and 268 MB
// written, about 0.16 ms at 3.35 TB/s.  The direct kernel reads every
// winner's row (repeats from L1/L2); the window kernel each distinct row
// once per run; the resident kernel the whole table once per query.
//
// Offsets are int64: Q * R * 128 passes 2^31 at the scripts' shape.

#include <cuda_runtime.h>
#include <stdint.h>

#include "matmul_ring.cuh"  // mbarriers, cp.async.bulk, allow_smem

namespace {

constexpr int VEC_PER_ROW = 32;  // float4s per 128-wide super-row
constexpr int DIRECT_WARPS = 8;
constexpr int WINDOW_TILE = 8;    // winners per tile of the fallback count
constexpr int WINDOW_RUN = 64;    // slots of one query a block walks
constexpr int WINDOW_WARPS = 4;   // consumer warps; one more produces
constexpr int WINDOW_THREADS = 32 * (WINDOW_WARPS + 1);
constexpr int ROW_BYTES = VEC_PER_ROW * 16;
constexpr int RESIDENT_THREADS = 512;

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

// Shared memory of a window block: the ring (w row slots), full[w] and
// empty[w], then each distinct row's first slot (WINDOW_RUN + 1) and row
// id (WINDOW_RUN).
size_t window_smem_bytes(int w) {
  return (size_t)w * (ROW_BYTES + 2 * sizeof(uint64_t)) +
         (2 * WINDOW_RUN + 1) * sizeof(int);
}

__global__ void __launch_bounds__(WINDOW_THREADS)
super_row_gather_window_kernel(const float4* __restrict__ x,
                               const int* __restrict__ rowof, int kp,
                               int r_count, int w, float4* __restrict__ out,
                               int* __restrict__ fallbacks) {
  extern __shared__ __align__(128) uint8_t win_smem[];
  float4* ring = reinterpret_cast<float4*>(win_smem);  // (w, 32)
  uint64_t* full = reinterpret_cast<uint64_t*>(win_smem + w * ROW_BYTES);
  uint64_t* empty = full + w;
  int* first = reinterpret_cast<int*>(empty + w);  // [WINDOW_RUN + 1]
  int* row = first + WINDOW_RUN + 1;               // [WINDOW_RUN]
  __shared__ int chunk_rows[WINDOW_RUN / 32];

  const int runs = (kp + WINDOW_RUN - 1) / WINDOW_RUN;
  const int64_t q = blockIdx.x / runs;
  const int j0 = (blockIdx.x % runs) * WINDOW_RUN;
  const int len = min(WINDOW_RUN, kp - j0);
  const int* rq = rowof + q * kp + j0;
  const float4* xq = x + q * r_count * VEC_PER_ROW;
  float4* oq = out + (q * kp + j0) * VEC_PER_ROW;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int s = threadIdx.x; s < w; s += blockDim.x) {
    mbar_init(&full[s], 1);   // the producer's expect_tx
    mbar_init(&empty[s], 1);  // the consumer warp that read the slot
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // The tiles of 8 whose span does not fit the script's window (KP % 8 ==
  // 0 and WINDOW_RUN % 8 == 0: a run holds whole tiles).
  bool wide = false;
  if (threadIdx.x < len / WINDOW_TILE) {
    const int w0 = clamp_row(__ldg(rq + WINDOW_TILE * threadIdx.x), r_count);
    const int w7 = clamp_row(
        __ldg(rq + WINDOW_TILE * threadIdx.x + WINDOW_TILE - 1), r_count);
    wide = w7 - min((w0 / 8) * 8, r_count - w) >= w;
  }
  // The run's distinct rows: slot j starts one where its id differs from
  // slot j - 1's.  Count them per 32 slots, then place each.
  int id[WINDOW_RUN / 32 / (WINDOW_WARPS + 1) + 1];
  unsigned heads[WINDOW_RUN / 32 / (WINDOW_WARPS + 1) + 1];
#pragma unroll
  for (int i = 0; i * (WINDOW_WARPS + 1) < WINDOW_RUN / 32; ++i) {
    const int c = warp + i * (WINDOW_WARPS + 1), j = 32 * c + lane;
    id[i] = -1;
    bool head = false;
    if (c < WINDOW_RUN / 32 && j < len) {
      id[i] = clamp_row(__ldg(rq + j), r_count);
      head = j == 0 || id[i] != clamp_row(__ldg(rq + j - 1), r_count);
    }
    heads[i] = __ballot_sync(0xffffffffu, head);
    if (c < WINDOW_RUN / 32 && lane == 0) chunk_rows[c] = __popc(heads[i]);
  }
  const int n_wide = __syncthreads_count(wide);
  if (threadIdx.x == 0 && n_wide && fallbacks != nullptr)
    atomicAdd(fallbacks, n_wide);
#pragma unroll
  for (int i = 0; i * (WINDOW_WARPS + 1) < WINDOW_RUN / 32; ++i) {
    const int c = warp + i * (WINDOW_WARPS + 1);
    if (c >= WINDOW_RUN / 32 || !((heads[i] >> lane) & 1)) continue;
    int u = __popc(heads[i] & ((1u << lane) - 1));
    for (int k = 0; k < c; ++k) u += chunk_rows[k];
    first[u] = 32 * c + lane;
    row[u] = id[i];
  }
  int n_rows = 0;
  for (int k = 0; k < WINDOW_RUN / 32; ++k) n_rows += chunk_rows[k];
  if (threadIdx.x == 0) first[n_rows] = len;
  __syncthreads();  // barriers initialised, first[] and row[] written

  if (warp == WINDOW_WARPS) {  // the producer: distinct rows in order
    if (lane == 0) {
      for (int u = 0; u < n_rows; ++u) {
        const int s = u % w;
        if (u >= w) mbar_wait(&empty[s], (u / w - 1) & 1);
        mbar_expect_tx(&full[s], ROW_BYTES);
        bulk_copy(ring + s * VEC_PER_ROW, xq + (int64_t)row[u] * VEC_PER_ROW,
                  ROW_BYTES, &full[s]);
      }
    }
  } else {  // consumers: distinct rows warp, warp + WINDOW_WARPS, ...
    for (int u = warp; u < n_rows; u += WINDOW_WARPS) {
      const int s = u % w;
      mbar_wait(&full[s], (u / w) & 1);
      const float4 v = ring[s * VEC_PER_ROW + lane];
      release_slot(&empty[s], lane);
      for (int j = first[u]; j < first[u + 1]; ++j)
        __stcs(oq + (int64_t)j * VEC_PER_ROW + lane, v);
    }
  }
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

// E6: as E5 with winners sorted within each query; a ring of w row slots
// (w % 8 == 0, w <= R), KP % 8 == 0.  fallbacks (one int32, may be null)
// gains the number of tiles of 8 whose span does not fit a window of w.
int bm25_super_row_gather_window(const void* x3, const int* rowof,
                                 int q_count, int r_count, int kp, int w,
                                 void* out, int* fallbacks, void* stream) {
  const int64_t blocks =
      (int64_t)q_count * ((kp + WINDOW_RUN - 1) / WINDOW_RUN);
  if (blocks <= 0) return 0;
  if (w <= 0 || w % 8 || w > r_count || kp % WINDOW_TILE)
    return (int)cudaErrorInvalidValue;
  const size_t smem = window_smem_bytes(w);
  int err = allow_smem(super_row_gather_window_kernel, smem);
  if (err) return err;
  super_row_gather_window_kernel<<<(unsigned)blocks, WINDOW_THREADS, smem,
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
  int err = allow_smem(super_row_gather_resident_kernel, smem);
  if (err) return err;
  super_row_gather_resident_kernel<<<(unsigned)q_count, RESIDENT_THREADS,
                                     smem,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x3), rowof, kp, h,
      static_cast<float4*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
