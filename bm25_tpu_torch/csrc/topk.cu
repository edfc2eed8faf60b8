// Top-k and Gumbel-max sampling kernels for Hopper (sm_90a).
//
// Replaces the two Pallas kernels of bm25_tpu/ops/topk.py:
//   * _pallas_topk_lastaxis (:241)  -> bm25_topk_select  (B4: two-stage
//     top-k, launched once per stage)
//   * _pallas_gumbel_choice (:620)  -> bm25_gumbel_choice (B5)
//
// B4.  The JAX kernel cuts the last axis into chunks; stage 1 runs k rounds
// of (row max, first argmax, mask) over each chunk, stage 2 the same rounds
// over the nblocks * k candidates in chunk order.  Here one block runs the
// rounds of one (row, chunk): the chunk's values become order keys in
// shared memory (a uint32 whose unsigned order is the float order: NaN
// above +inf, -0 equal to +0, and 0 reserved for "taken"), every thread
// keeps the best (key, -position) pair of the positions it owns in a
// register, and each round is one block-wide max of those 64-bit pairs:
// the largest key wins and, among equal keys, the smaller position.  The
// winner's owner marks it taken and rescans its own positions only.  A
// taken key (0) sits below -inf, so a row without finite values left picks
// its first untaken position, as the JAX kernel's fallback does; once every
// position of a chunk is taken the round emits (-inf, chunk start), as the
// JAX kernel's does.  Stage 2 is the same kernel over the candidates, one
// block per row, with ties going to the earlier candidate.  The result
// equals a stable descending sort: values, indices (ties to the smaller
// index) and distinct indices on exhausted rows.
//
// What bounds it on an H100: the k sequential rounds.  Each round costs a
// block reduction (two barriers) and one owner's rescan of chunk / 512
// shared-memory keys, so a launch is O(k * (log threads + chunk / 512))
// per block and the work is O(k * N) in all, against one streaming read of
// the input.  The wrapper cuts stage 1 into chunks of at most 16,384 values
// (64 KB of keys), which keeps several blocks on each SM.  A block holds up
// to MAX_LEN = 57,344 keys (224 KB, opted into above the 48 KB default), so
// stage 2 merges up to that many candidates at once; more candidates are
// merged in passes of this same kernel over chunks of the candidate row,
// each of which keeps candidate order, until one block holds them all.
//
// B5.  Gumbel-max choice of one column per row of (B, k) logits: a
// counter-based hash of (seed, row, column) gives 32 random bits (the TPU
// PRNG cannot be reproduced), then the JAX kernel's steps: the top 24 bits
// u = bits * 2^-24 + 1e-12, g = -log(-log u), z = logit + g, first argmax.
// One warp per row; each lane walks its columns, then a warp reduction
// keeps the larger z and, among equal z, the smaller column.  Bounded by
// two logf per element; negligible at the sampling shapes.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int SEL_THREADS = 512;
constexpr int SEL_WARPS = SEL_THREADS / 32;
constexpr int MAX_LEN = 57344;  // keys per block: 224 KB of shared memory
constexpr int MAX_GRID_Y = 65535;
constexpr int CHOICE_THREADS = 256;

// order key: unsigned order == float order; NaN largest; -0 == +0;
// every key of a value is > 0, the taken mark
__device__ __forceinline__ uint32_t order_key(float x) {
  if (isnan(x)) return 0xFFFFFFFFu;
  const uint32_t b = __float_as_uint(x);
  if ((b << 1) == 0) return 0x80000000u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ uint64_t pack(uint32_t key, int pos) {
  return ((uint64_t)key << 32) | (uint32_t)~(uint32_t)pos;
}

__device__ __forceinline__ uint64_t warp_max(uint64_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const uint64_t u = __shfl_xor_sync(0xffffffffu, v, o);
    v = u > v ? u : v;
  }
  return v;
}

// k rounds of (max, first position, take) over vals[row, base : base+len],
// len = min(chunk, n - base).  cand_idx == null: stage 1 (the output index
// is base + position); otherwise stage 2 (the output index is the
// candidate's).  Output row r of block b: out[row * out_stride + b * k + r].
__global__ void __launch_bounds__(SEL_THREADS)
select_rounds(const float* __restrict__ vals,
              const long long* __restrict__ cand_idx, int b_count, int n,
              int chunk, int k, float* __restrict__ out_v,
              long long* __restrict__ out_i, int64_t out_stride) {
  extern __shared__ uint32_t s_key[];
  __shared__ uint64_t s_warp[SEL_WARPS];
  __shared__ uint64_t s_win;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int base = blockIdx.x * chunk;
  const int len = min(chunk, n - base);

  for (int row = blockIdx.y; row < b_count; row += gridDim.y) {
    const int64_t in_off = (int64_t)row * n + base;
    const float* v = vals + in_off;
    __syncthreads();  // the previous row is done with s_key
    for (int i = threadIdx.x; i < len; i += SEL_THREADS)
      s_key[i] = order_key(v[i]);
    __syncthreads();
    auto rescan = [&]() {
      uint64_t b = 0;  // below every position's pair
      for (int i = threadIdx.x; i < len; i += SEL_THREADS) {
        const uint64_t p = pack(s_key[i], i);
        b = p > b ? p : b;
      }
      return b;
    };
    uint64_t best = rescan();
    float* ov = out_v + (int64_t)row * out_stride + (int64_t)blockIdx.x * k;
    long long* oi = out_i + (int64_t)row * out_stride + (int64_t)blockIdx.x * k;
    for (int r = 0; r < k; ++r) {
      uint64_t m = warp_max(best);
      if (lane == 0) s_warp[warp] = m;
      __syncthreads();
      if (warp == 0) {
        m = warp_max(lane < SEL_WARPS ? s_warp[lane] : 0);
        if (lane == 0) s_win = m;
      }
      __syncthreads();
      m = s_win;
      const int pos = (int)~(uint32_t)m;
      if (threadIdx.x == 0) {
        const bool open = (m >> 32) != 0;
        ov[r] = open ? v[pos] : -CUDART_INF_F;
        oi[r] = cand_idx ? cand_idx[in_off + pos] : (long long)(base + pos);
      }
      if (pos % SEL_THREADS == (int)threadIdx.x) {
        s_key[pos] = 0;
        best = rescan();
      }
    }
  }
}

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

__global__ void __launch_bounds__(CHOICE_THREADS)
gumbel_choice(const float* __restrict__ logits, int b_count, int k,
              uint32_t seed, long long* __restrict__ out) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * (CHOICE_THREADS / 32) + threadIdx.x / 32;
  if (row >= b_count) return;  // whole warps leave together
  const uint32_t h_row = mix32(mix32(seed) ^ (uint32_t)row);
  const float* x = logits + (int64_t)row * k;
  float best = -CUDART_INF_F;
  int best_c = 0x7fffffff;
  for (int c = lane; c < k; c += 32) {
    const uint32_t bits = mix32(h_row ^ (uint32_t)c);
    // 2^-24 and 1e-12 as f32; the product is exact
    const float u = __fadd_rn(__fmul_rn((float)(bits >> 8), 0x1p-24f),
                              0x1.197998p-40f);
    const float z = __fadd_rn(x[c], -logf(-logf(u)));
    if (z > best || (z == best && c < best_c)) {
      best = z;
      best_c = c;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float z = __shfl_xor_sync(0xffffffffu, best, o);
    const int c = __shfl_xor_sync(0xffffffffu, best_c, o);
    if (z > best || (z == best && c < best_c)) {
      best = z;
      best_c = c;
    }
  }
  if (lane == 0) out[row] = best_c;
}

}  // namespace

extern "C" {

const char* bm25_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// B4, one stage: (B, n) f32 values (stage 2: (B, n) candidates with their
// int64 indices in cand_idx) cut into ceil(n / chunk) chunks of at most
// MAX_LEN -> per chunk k (value, int64 index) pairs, written at
// out[row * out_stride + chunk_no * k + r].
int bm25_topk_select(const float* vals, const long long* cand_idx,
                     int b_count, int n, int chunk, int k, float* out_v,
                     long long* out_i, long long out_stride, void* stream) {
  if (b_count <= 0) return 0;
  const int nblocks = chunk > 0 ? (n + chunk - 1) / chunk : 0;
  if (n <= 0 || chunk <= 0 || chunk > MAX_LEN || k <= 0 ||
      k > chunk || out_stride < (long long)nblocks * k)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)chunk * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        select_rounds, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MAX_LEN * (int)sizeof(uint32_t));
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(nblocks, b_count < MAX_GRID_Y ? b_count : MAX_GRID_Y);
  select_rounds<<<grid, SEL_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      vals, cand_idx, b_count, n, chunk, k, out_v, out_i, out_stride);
  return (int)cudaGetLastError();
}

// B5: (B, k) f32 logits, 32-bit seed -> out (B,) int64 chosen columns.
int bm25_gumbel_choice(const float* logits, int b_count, int k,
                       unsigned int seed, long long* out, void* stream) {
  if (b_count <= 0) return 0;
  if (k <= 0) return (int)cudaErrorInvalidValue;
  const int rows_per_block = CHOICE_THREADS / 32;
  const int grid = (b_count + rows_per_block - 1) / rows_per_block;
  gumbel_choice<<<grid, CHOICE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      logits, b_count, k, seed, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
