// Top-k and Gumbel-max sampling kernels for Hopper (sm_90a).
//
// Replaces the two Pallas kernels of bm25_tpu/ops/topk.py:
//   * _pallas_topk_lastaxis (:241)  -> bm25_topk_select  (B4: exact top-k
//     per row by radix select)
//   * _pallas_gumbel_choice (:620)  -> bm25_gumbel_choice (B5)
//
// B4.  The JAX kernel runs k rounds of (row max, first argmax, mask) over
// each chunk of a row, then over the chunks' candidates: O(k * N) work, a
// design for a TPU's wide vector unit.  Here the result is the same (a
// stable descending sort of each row cut to k: NaN largest, -0 equal to
// +0, ties to the smaller index, distinct indices) and the work is a fixed
// number of streaming passes whatever k is.  Every value becomes a 32-bit
// order key (unsigned order == float order) and:
//   1. three histogram passes (digits of 13, 11 and 8 bits, high first)
//      find the key T of the k-th largest and, per slice of the row, the
//      number of keys above T and equal to T.  Each pass counts, in shared
//      memory, the digit of the keys that share the prefix chosen so far;
//      each thread adds runs of equal digits as one atomic, so the masked
//      scores' few hot keys (0.0, -inf) do not serialise the block.  One
//      block per row then sums the slices' histograms and picks the digit
//      that holds the k-th key (radix_scan).  After pass 0 or 1, a row
//      whose keys at or above the chosen prefix fit the side buffer (at
//      most min(n / 8, 65,536) per row) has them compacted there with their
//      positions, in position order (radix_compact), and the later passes
//      read those instead of the row: two or three reads of the row, not
//      four.  The buffer is global memory: a per-row buffer in shared
//      memory would leave one block per SM, too few loads in flight;
//   2. one selection pass writes every position whose key is > T, then the
//      first (k - #keys > T) positions whose key equals T, both in position
//      order: block prefix sums (warp shuffles) of each thread's counts,
//      offset by an exclusive scan of the slices' counts;
//   3. the k candidates are sorted by (key desc, position asc): a bitonic
//      sort of packed (key, ~position) in shared memory for k <= 16,384,
//      above that a stable LSD radix sort (up to 4 x 8 bits) in global
//      memory,
//      which keeps ties in their position order.  Values come back from
//      their keys, and from the input where a key stands for several
//      values (+-0, NaN), so a chosen -0 stays -0.
// Many rows: one block per (row, slice) with one slice per row; few rows:
// each row is cut into up to MAX_SLICES slices so that the grid fills the
// SMs.
//
// What bounds it on an H100: the two to four reads of the input (the
// passes up to the compaction, or all four without it) against one in the
// bound; for small rows the histogram (up to 32 KB) each block writes per
// pass; at few rows the eleven launches; at k > 16,384 the sort, one block
// a row.
//
// B5.  Gumbel-max choice of one column per row of (B, k) logits: a
// counter-based hash of (seed, row, column) gives 32 random bits (the TPU
// PRNG cannot be reproduced), then the JAX kernel's steps: the top 24 bits
// u = bits * 2^-24 + 1e-12, g = -log(-log u), z = logit + g, first argmax.
// The pick is order-free: a NaN z ranks above every number and, among
// equal z or NaNs, the smaller column wins (torch.argmax's and
// jnp.argmax's order), so a row of NaNs picks column 0 and no column >= k
// is ever written.  Each lane takes runs of 4 consecutive columns (one
// 16-byte load where k % 4 == 0 and the logits are aligned), and the
// wrapper picks one of three layouts from B, k and the SM count, so that
// few rows still fill the card:
//   * a warp per row (8 rows a block) where B alone gives every SM
//     several warps;
//   * a block per row where a row needs more lanes; its warps combine
//     their (z, column) pairs in shared memory;
//   * a thread-block cluster per row (2-8 blocks, the portable sizes)
//     where one block a row would leave SMs idle: the row's columns are
//     cut into one slice per block, and after cluster.sync() the first
//     block reads the others' pairs through distributed shared memory.
//     One launch, no global scratch, no atomics.
// The seed is a kernel argument or, to spare the caller a host sync, the
// low 32 bits of an int64 on the device.  With an id tensor the kernel
// writes idx[row, choice], the sampled id, in the same launch.  What it
// must move is the logits' bytes; what holds it at few wide rows is the
// two accurate logf a column (a polynomial: no special-function
// instruction), and at the sampling shapes the launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int RADIX_THREADS = 512;
constexpr int RADIX_WARPS = RADIX_THREADS / 32;
constexpr int ITEMS = 8;  // consecutive values a thread takes per tile
constexpr int BINS = 8192;  // the widest digit: 13 bits
constexpr int SCAN_THREADS = 1024;
constexpr int BINS_PER_SCAN_THREAD = BINS / SCAN_THREADS;  // 8
constexpr int MAX_SLICES = 128;
constexpr int SORT_THREADS = 1024;
constexpr int SORT_SMEM_KEYS = 16384;  // 128 KB of packed pairs
constexpr int LSD_THREADS = 512;
constexpr int LSD_WARPS = LSD_THREADS / 32;
constexpr int MAX_GRID_Y = 65535;
constexpr int CHOICE_MAX_THREADS = 1024;
constexpr int CHOICE_MAX_CLUSTER = 8;  // the portable limit

// order key: unsigned order == float order; NaN largest; -0 == +0
__device__ __forceinline__ uint32_t order_key(float x) {
  if (isnan(x)) return 0xFFFFFFFFu;
  const uint32_t b = __float_as_uint(x);
  if ((b << 1) == 0) return 0x80000000u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// the digits, high first: 13, 11 and 8 bits
// the value of a key, read from the input only where the key does not
// tell it: +-0 (one key) and NaN (one key for every payload)
__device__ __forceinline__ float key_value(uint32_t key, const float* row,
                                           int pos) {
  if (key == 0x80000000u || key == 0xFFFFFFFFu) return row[pos];
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7FFFFFFFu) : ~key);
}

__device__ __forceinline__ int digit_shift(int pass) {
  return pass == 0 ? 19 : (pass == 1 ? 8 : 0);
}

__device__ __forceinline__ int digit_bits(int pass) {
  return pass == 0 ? 13 : (pass == 1 ? 11 : 8);
}

__device__ __forceinline__ int warp_inclusive_sum(int v) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide exclusive prefix sum of one int per thread (RADIX_THREADS
// threads); *total gets the block's sum.  s_warp: RADIX_WARPS ints.
__device__ __forceinline__ int block_exclusive_sum(int v, int* s_warp,
                                                   int* total) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int incl = warp_inclusive_sum(v);
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = warp_inclusive_sum(lane < RADIX_WARPS ? s_warp[lane] : 0);
    if (lane < RADIX_WARPS) s_warp[lane] = w;
  }
  __syncthreads();
  const int excl = incl - v + (warp ? s_warp[warp - 1] : 0);
  *total = s_warp[RADIX_WARPS - 1];
  __syncthreads();  // s_warp is free again
  return excl;
}

// Per row, int32 state[4]: the key prefix chosen so far, the keys still
// needed from those that share it, and where the row's keys are read
// from: 0 the row itself, p (1 or 2) the side buffer from pass p on,
// filled after pass p - 1 with the keys >= the prefix.  Per (row, slice),
// int32 cnt[4]: the keys above the prefix (after the last pass: > T), the
// keys equal to T, and the slice's offset and length in the side buffer.
struct Source {
  const float* v;  // the row's values [lo, hi)
  int lo, hi;
  bool vec;
  const uint32_t* sk;  // or its (key, position) pairs [off, off + len)
  const int* sp;
  int off, len;
  bool side;

  __device__ __forceinline__ int size() const { return side ? len : hi - lo; }

  // this thread's ITEMS consecutive (key, position) pairs of the tile at
  // t0; key 0 (below every key of a value) past the end
  __device__ __forceinline__ void load(int t0, uint32_t key[ITEMS],
                                       int pos[ITEMS]) const {
    const int i = t0 + ITEMS * (int)threadIdx.x;
    if (side) {
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        const bool ok = i + j < len;
        key[j] = ok ? sk[off + i + j] : 0u;
        pos[j] = ok ? sp[off + i + j] : 0;
      }
      return;
    }
    const int p = lo + i;
    if (vec && p + ITEMS <= hi) {
#pragma unroll
      for (int j = 0; j < ITEMS; j += 4) {
        const float4 q = *reinterpret_cast<const float4*>(v + p + j);
        key[j] = order_key(q.x);
        key[j + 1] = order_key(q.y);
        key[j + 2] = order_key(q.z);
        key[j + 3] = order_key(q.w);
      }
    } else {
#pragma unroll
      for (int j = 0; j < ITEMS; ++j)
        key[j] = p + j < hi ? order_key(v[p + j]) : 0u;
    }
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) pos[j] = p + j;
  }
};

__device__ __forceinline__ Source make_source(
    const float* x, int row, int n, int slice_len, bool vec, bool side,
    const int* cnt, const uint32_t* side_key, const int* side_pos, int cap) {
  const int slices = gridDim.x, s = blockIdx.x;
  const int* c = cnt + ((int64_t)row * slices + s) * 4;
  Source src;
  src.v = x + (int64_t)row * n;
  src.lo = s * slice_len;
  src.hi = min(n, src.lo + slice_len);
  src.vec = vec;  // lo is a multiple of 4
  src.sk = side_key + (int64_t)row * cap;
  src.sp = side_pos + (int64_t)row * cap;
  src.off = side ? c[2] : 0;
  src.len = side ? c[3] : 0;
  src.side = side;
  return src;
}

// Pass p's histogram of each (row, slice): the digit of the keys that
// share the prefix, in shared memory; each thread adds a run of equal
// digits as one atomic.  hist: (rows, slices, BINS) int32.
__global__ void __launch_bounds__(RADIX_THREADS)
radix_hist(const float* __restrict__ x, int rows, int n, int slice_len,
           bool vec, int pass, const uint32_t* __restrict__ state,
           const int* __restrict__ cnt, const uint32_t* __restrict__ side_key,
           const int* __restrict__ side_pos, int cap,
           int* __restrict__ hist) {
  __shared__ int s_hist[BINS];
  const int shift = digit_shift(pass), bits = digit_bits(pass);
  const int hi_shift = shift + bits;  // 32 on pass 0: no prefix yet
  const uint32_t mask = (1u << bits) - 1;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    for (int i = threadIdx.x; i < (1 << bits); i += blockDim.x) s_hist[i] = 0;
    __syncthreads();
    const uint32_t from = pass ? state[4 * row + 2] : 0u;
    const Source src = make_source(x, row, n, slice_len, vec,
                                   from && pass >= (int)from, cnt, side_key,
                                   side_pos, cap);
    const uint32_t want = pass ? state[4 * row] >> hi_shift : 0u;
    int run_bin = -1, run_n = 0;
    for (int t0 = 0; t0 < src.size(); t0 += ITEMS * RADIX_THREADS) {
      uint32_t key[ITEMS];
      int pos[ITEMS];
      src.load(t0, key, pos);
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        if (key[j] == 0u || (pass && (key[j] >> hi_shift) != want)) continue;
        const int b = (int)((key[j] >> shift) & mask);
        if (b == run_bin) {
          ++run_n;
          continue;
        }
        if (run_n) atomicAdd(&s_hist[run_bin], run_n);
        run_bin = b;
        run_n = 1;
      }
    }
    if (run_n) atomicAdd(&s_hist[run_bin], run_n);
    __syncthreads();
    int* out = hist + ((int64_t)row * gridDim.x + blockIdx.x) * BINS;
    for (int i = threadIdx.x; i < (1 << bits); i += blockDim.x)
      out[i] = s_hist[i];
    __syncthreads();
  }
}

// One block per row: sum the slices' histograms, pick the digit d holding
// the kr-th largest key of those sharing the prefix (kr = k on pass 0),
// extend the prefix by d and keep kr minus the keys above d; add each
// slice's keys above d to its cnt[0] (on the last pass, cnt[1] = its keys
// equal to T).  After pass 0 or 1, a row whose keys >= the new prefix fit
// `cap` is marked for compaction into the side buffer, and each slice gets
// its offset and length there.
__global__ void __launch_bounds__(SCAN_THREADS)
radix_scan(const int* __restrict__ hist, int rows, int slices, int k,
           int pass, int cap, uint32_t* __restrict__ state,
           int* __restrict__ cnt) {
  __shared__ int s_warp[SCAN_THREADS / 32];
  __shared__ int s_pick[3];
  __shared__ int s_above[MAX_SLICES];
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int shift = digit_shift(pass), nb = 1 << digit_bits(pass);
  // this thread's bins: all of them exist this pass or none (nb >= 256)
  const bool live = t * BINS_PER_SCAN_THREAD < nb;
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const int* h = hist + (int64_t)row * slices * BINS;
    const int kr = pass ? (int)state[4 * row + 1] : k;
    const int from = pass ? (int)state[4 * row + 2] : 0;
    // the thread's 8 bins of one slice: two 16-byte loads
    auto bins8 = [&](int s, int v[8]) {
      const int4* q = reinterpret_cast<const int4*>(
          h + (int64_t)s * BINS + t * BINS_PER_SCAN_THREAD);
      const int4 a = q[0], b = q[1];
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    };
    int local[BINS_PER_SCAN_THREAD] = {};
    if (live) {
#pragma unroll 4
      for (int s = 0; s < slices; ++s) {
        int v[8];
        bins8(s, v);
#pragma unroll
        for (int j = 0; j < 8; ++j) local[j] += v[j];
      }
    }
    int sum = 0;
#pragma unroll
    for (int j = 0; j < BINS_PER_SCAN_THREAD; ++j) sum += local[j];
    for (int s = t; s < slices; s += blockDim.x) s_above[s] = 0;
    // inclusive suffix sums over the threads' bins: in the warp, then
    // over the warps' totals
    int suffix = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_down_sync(0xffffffffu, suffix, o);
      if (lane + o < 32) suffix += u;
    }
    if (lane == 0) s_warp[warp] = suffix;
    __syncthreads();
    if (warp == 0) {
      int w = lane < SCAN_THREADS / 32 ? s_warp[lane] : 0;
      const int own = w;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_down_sync(0xffffffffu, w, o);
        if (lane + o < 32) w += u;
      }
      if (lane < SCAN_THREADS / 32) s_warp[lane] = w - own;  // exclusive
    }
    __syncthreads();
    int above = suffix - sum + s_warp[warp];  // keys in higher threads' bins
#pragma unroll
    for (int j = BINS_PER_SCAN_THREAD - 1; j >= 0; --j) {
      if (above < kr && kr <= above + local[j]) {
        s_pick[0] = t * BINS_PER_SCAN_THREAD + j;
        s_pick[1] = above;
        s_pick[2] = local[j];
      }
      above += local[j];
    }
    __syncthreads();
    const int d = s_pick[0];
    // the keys >= the new prefix: those above it, and those in bin d
    const bool compact = cap > 0 && pass < 2 && from == 0 &&
                         (long long)(k - kr + s_pick[1]) + s_pick[2] <= cap;
#pragma unroll 4
    for (int s = 0; s < slices; ++s) {
      int g = 0;
      if (live && (t + 1) * BINS_PER_SCAN_THREAD - 1 > d) {
        int v[8];
        bins8(s, v);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (t * BINS_PER_SCAN_THREAD + j > d) g += v[j];
      }
      g = warp_sum(g);
      if (lane == 0 && g) atomicAdd(&s_above[s], g);
    }
    __syncthreads();
    for (int s = t; s < slices; s += blockDim.x) {
      int* c = cnt + ((int64_t)row * slices + s) * 4;
      c[0] = (pass ? c[0] : 0) + s_above[s];
      if (pass == 2) c[1] = h[(int64_t)s * BINS + d];
      if (compact) c[3] = c[0] + h[(int64_t)s * BINS + d];
    }
    __syncthreads();
    if (t == 0) {
      if (compact) {
        int off = 0;
        for (int s = 0; s < slices; ++s) {
          int* c = cnt + ((int64_t)row * slices + s) * 4;
          c[2] = off;
          off += c[3];
        }
      }
      state[4 * row] = (pass ? state[4 * row] : 0u) | ((uint32_t)d << shift);
      state[4 * row + 1] = (uint32_t)(kr - s_pick[1]);
      state[4 * row + 2] = (uint32_t)(compact ? pass + 1 : from);
    }
    __syncthreads();
  }
}

// The rows marked for it after pass `after` - 1: each slice's keys >= the
// prefix, with their positions, in position order, into the side buffer.
__global__ void __launch_bounds__(RADIX_THREADS)
radix_compact(const float* __restrict__ x, int rows, int n, int slice_len,
              bool vec, int after, const uint32_t* __restrict__ state,
              const int* __restrict__ cnt, uint32_t* __restrict__ side_key,
              int* __restrict__ side_pos, int cap) {
  __shared__ int s_warp[RADIX_WARPS];
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    if ((int)state[4 * row + 2] != after) continue;  // the whole block
    const uint32_t lowest = state[4 * row];  // low bits zero: a key >= it
    const Source src = make_source(x, row, n, slice_len, vec, false, cnt,
                                   side_key, side_pos, cap);
    uint32_t* sk = side_key + (int64_t)row * cap;
    int* sp = side_pos + (int64_t)row * cap;
    int base = cnt[((int64_t)row * gridDim.x + blockIdx.x) * 4 + 2];
    for (int t0 = 0; t0 < src.size(); t0 += ITEMS * RADIX_THREADS) {
      uint32_t key[ITEMS];
      int pos[ITEMS];
      src.load(t0, key, pos);
      int mine = 0;
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) mine += key[j] >= lowest;
      if (!__syncthreads_or(mine)) continue;  // nothing in this tile
      int total;
      int o = base + block_exclusive_sum(mine, s_warp, &total);
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        if (key[j] >= lowest) {
          sk[o] = key[j];
          sp[o] = pos[j];
          ++o;
        }
      }
      base += total;
    }
  }
}

// The k candidates of each row, in the order [keys > T by position, then
// the first (k - #keys > T) keys == T by position]: (key, position) pairs.
__global__ void __launch_bounds__(RADIX_THREADS)
radix_select(const float* __restrict__ x, int rows, int n, int k,
             int slice_len, bool vec, const uint32_t* __restrict__ state,
             const int* __restrict__ cnt,
             const uint32_t* __restrict__ side_key,
             const int* __restrict__ side_pos, int cap,
             uint32_t* __restrict__ cand_key, int* __restrict__ cand_pos) {
  __shared__ int s_warp[RADIX_WARPS];
  const int slices = gridDim.x, s = blockIdx.x;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const uint32_t T = state[4 * row];
    const int ties = (int)state[4 * row + 1];
    const int n_gt = k - ties;
    const Source src = make_source(x, row, n, slice_len, vec,
                                   state[4 * row + 2] != 0u, cnt, side_key,
                                   side_pos, cap);
    int gt_base = 0, eq_base = 0;  // this slice's offsets
    for (int p = 0; p < s; ++p) {
      gt_base += cnt[((int64_t)row * slices + p) * 4];
      eq_base += cnt[((int64_t)row * slices + p) * 4 + 1];
    }
    uint32_t* ck = cand_key + (int64_t)row * k;
    int* cp = cand_pos + (int64_t)row * k;
    for (int t0 = 0; t0 < src.size(); t0 += ITEMS * RADIX_THREADS) {
      uint32_t key[ITEMS];
      int pos[ITEMS];
      src.load(t0, key, pos);
      int n_g = 0, n_e = 0;
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        n_g += key[j] > T;
        n_e += key[j] == T;
      }
      if (!__syncthreads_or(n_g | n_e)) continue;  // nothing in this tile
      // both counts in one int: each is at most ITEMS * RADIX_THREADS < 2^16
      int total;
      const int excl =
          block_exclusive_sum(n_g | (n_e << 16), s_warp, &total);
      int g = gt_base + (excl & 0xFFFF), e = eq_base + (excl >> 16);
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        if (key[j] > T) {
          ck[g] = key[j];
          cp[g] = pos[j];
          ++g;
        } else if (key[j] == T) {
          if (e < ties) {
            ck[n_gt + e] = key[j];
            cp[n_gt + e] = pos[j];
          }
          ++e;
        }
      }
      gt_base += total & 0xFFFF;
      eq_base += total >> 16;
    }
  }
}

// k <= SORT_SMEM_KEYS: bitonic sort of packed (key, ~position) descending
// in shared memory, one block per row; out = (values, int64 positions).
__global__ void __launch_bounds__(SORT_THREADS)
sort_smem(const float* __restrict__ x, int rows, int n, int k,
          const uint32_t* __restrict__ cand_key,
          const int* __restrict__ cand_pos, float* __restrict__ out_v,
          long long* __restrict__ out_i) {
  extern __shared__ unsigned long long s_pair[];
  int m = 1;
  while (m < k) m <<= 1;
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const uint32_t* ck = cand_key + (int64_t)row * k;
    const int* cp = cand_pos + (int64_t)row * k;
    for (int i = threadIdx.x; i < m; i += blockDim.x)
      s_pair[i] = i < k ? ((unsigned long long)ck[i] << 32) |
                              (uint32_t)~(uint32_t)cp[i]
                        : 0ull;  // below every real pair (keys are > 0)
    __syncthreads();
    for (int size = 2; size <= m; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int i = threadIdx.x; i < (m >> 1); i += blockDim.x) {
          const int a = 2 * i - (i & (stride - 1));
          const int b = a + stride;
          const bool desc = (a & size) == 0;
          const unsigned long long pa = s_pair[a], pb = s_pair[b];
          if ((pa < pb) == desc) {
            s_pair[a] = pb;
            s_pair[b] = pa;
          }
        }
        __syncthreads();
      }
    }
    for (int i = threadIdx.x; i < k; i += blockDim.x) {
      const int pos = (int)~(uint32_t)s_pair[i];
      out_v[(int64_t)row * k + i] =
          key_value((uint32_t)(s_pair[i] >> 32), x + (int64_t)row * n, pos);
      out_i[(int64_t)row * k + i] = pos;
    }
    __syncthreads();
  }
}

// Exclusive prefix sums of s[0..256) in place, by warp 0 (8 per lane).
__device__ __forceinline__ void exclusive_scan_256(int* s) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int v[8], sum = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[j] = s[lane * 8 + j];
      sum += v[j];
    }
    int run = warp_inclusive_sum(sum) - sum;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[lane * 8 + j] = run;
      run += v[j];
    }
  }
}

// k > SORT_SMEM_KEYS: stable LSD radix sort of the candidates by key,
// descending, 8 bits a pass (a byte that every key shares is skipped),
// between (key_a, pos_a) and (key_b, pos_b); one block per row.
// Stability keeps equal keys in position order.
__global__ void __launch_bounds__(LSD_THREADS)
sort_lsd(const float* __restrict__ x, int rows, int n, int k,
         uint32_t* __restrict__ key_a, int* __restrict__ pos_a,
         uint32_t* __restrict__ key_b, int* __restrict__ pos_b,
         float* __restrict__ out_v, long long* __restrict__ out_i) {
  __shared__ int s_base[256];
  __shared__ int s_tile[256];
  __shared__ int s_wcnt[LSD_WARPS][256];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const unsigned lt = (1u << lane) - 1;
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    uint32_t* ka = key_a + (int64_t)row * k;
    int* pa = pos_a + (int64_t)row * k;
    uint32_t* kb = key_b + (int64_t)row * k;
    int* pb = pos_b + (int64_t)row * k;
    bool in_b = false;  // which buffer holds the pairs
    for (int pass = 0; pass < 4; ++pass) {
      const int shift = 8 * pass;
      const uint32_t* sk = in_b ? kb : ka;
      const int* sp = in_b ? pb : pa;
      uint32_t* dk = in_b ? ka : kb;
      int* dp = in_b ? pa : pb;
      for (int i = tid; i < 256; i += blockDim.x) s_base[i] = 0;
      __syncthreads();
      for (int i = tid; i < k; i += blockDim.x)
        atomicAdd(&s_base[255 - ((sk[i] >> shift) & 255)], 1);
      __syncthreads();
      // a digit that every key shares leaves the order as it is
      if (__syncthreads_or(tid < 256 && s_base[tid] == k)) continue;
      in_b = !in_b;
      exclusive_scan_256(s_base);
      __syncthreads();
      for (int t0 = 0; t0 < k; t0 += LSD_THREADS) {
        const int i = t0 + tid;
        const bool valid = i < k;
        const uint32_t key = valid ? sk[i] : 0u;
        const int pos = valid ? sp[i] : 0;
        const int d = valid ? 255 - (int)((key >> shift) & 255) : 256;
        const unsigned peers = __match_any_sync(0xffffffffu, d);
        const int rank = __popc(peers & lt);
        for (int j = tid; j < LSD_WARPS * 256; j += blockDim.x)
          (&s_wcnt[0][0])[j] = 0;
        __syncthreads();
        if (valid && rank == 0) s_wcnt[warp][d] = __popc(peers);
        __syncthreads();
        if (tid < 256) {
          int run = 0;
          for (int w = 0; w < LSD_WARPS; ++w) {
            const int c = s_wcnt[w][tid];
            s_wcnt[w][tid] = run;
            run += c;
          }
          s_tile[tid] = run;
        }
        __syncthreads();
        if (valid) {
          const int dest = s_base[d] + s_wcnt[warp][d] + rank;
          dk[dest] = key;
          dp[dest] = pos;
        }
        __syncthreads();
        if (tid < 256) s_base[tid] += s_tile[tid];
        __syncthreads();
      }
    }
    for (int i = tid; i < k; i += blockDim.x) {
      const int pos = in_b ? pb[i] : pa[i];
      out_v[(int64_t)row * k + i] =
          key_value(in_b ? kb[i] : ka[i], x + (int64_t)row * n, pos);
      out_i[(int64_t)row * k + i] = pos;
    }
    __syncthreads();
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

// B5's order on (z, column) pairs: NaN above every number, then the
// larger z, then the smaller column.  A strict order on distinct columns,
// so any reduction tree gives the first argmax.
__device__ __forceinline__ bool beats(float z, int c, float bz, int bc) {
  const bool zn = isnan(z), bn = isnan(bz);
  if (zn || bn) return zn && (!bn || c < bc);
  return z > bz || (z == bz && c < bc);
}

__device__ __forceinline__ void keep(float z, int c, float& bz, int& bc) {
  if (beats(z, c, bz, bc)) {
    bz = z;
    bc = c;
  }
}

__device__ __forceinline__ void warp_keep(float& bz, int& bc) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float z = __shfl_xor_sync(0xffffffffu, bz, o);
    const int c = __shfl_xor_sync(0xffffffffu, bc, o);
    keep(z, c, bz, bc);
  }
}

// z of column c: the logit plus the Gumbel noise of (row hash, c)
__device__ __forceinline__ float gumbel_z(float logit, uint32_t h_row, int c) {
  const uint32_t bits = mix32(h_row ^ (uint32_t)c);
  // 2^-24 and 1e-12 as f32; the product is exact
  const float u = __fadd_rn(__fmul_rn((float)(bits >> 8), 0x1p-24f),
                            0x1.197998p-40f);
  return __fadd_rn(logit, -logf(-logf(u)));
}

// B5's layouts: a warp a row (blockDim.x / 32 rows a block), a block a
// row, a cluster a row (each block on its slice of the row)
enum ChoiceLayout { WARP_ROWS = 0, BLOCK_ROW = 1, CLUSTER_ROW = 2 };

// out[row] = the chosen column of row's logits, or idx[row, column] when
// idx is given.
template <int LAYOUT>
__global__ void __launch_bounds__(CHOICE_MAX_THREADS)
gumbel_choice(const float* __restrict__ x, int b_count, int k,
              const long long* __restrict__ seed_ptr, uint32_t seed,
              const long long* __restrict__ idx, bool vec,
              long long* __restrict__ out) {
  __shared__ float s_z[32];
  __shared__ int s_c[32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int group = LAYOUT == WARP_ROWS ? 32 : (int)blockDim.x;
  const int g = LAYOUT == WARP_ROWS ? lane : (int)threadIdx.x;
  int row = LAYOUT == WARP_ROWS ? (int)(blockIdx.x * (blockDim.x / 32)) + warp
                                : (int)blockIdx.x;
  int lo = 0, hi = k, parts = 1, part = 0;
  if constexpr (LAYOUT == CLUSTER_ROW) {
    asm("mov.u32 %0, %%clusterid.x;" : "=r"(row));
    asm("mov.u32 %0, %%cluster_nctarank;" : "=r"(parts));
    asm("mov.u32 %0, %%cluster_ctarank;" : "=r"(part));
    // this block's slice of the row: a multiple of 4 columns
    const int slice = (k + 4 * parts - 1) / (4 * parts) * 4;
    lo = part * slice;
    hi = min(k, lo + slice);
  }
  float bz = -CUDART_INF_F;
  int bc = 0x7fffffff;  // loses to every column
  if (row < b_count) {
    const float* xr = x + (int64_t)row * k;
    const uint32_t s = seed_ptr ? (uint32_t)*seed_ptr : seed;
    const uint32_t h_row = mix32(mix32(s) ^ (uint32_t)row);
    for (int c = lo + 4 * g; c < hi; c += 4 * group) {
      float v[4];
      if (vec) {  // k % 4 == 0: the run lies inside the slice
        const float4 q = *reinterpret_cast<const float4*>(xr + c);
        v[0] = q.x;
        v[1] = q.y;
        v[2] = q.z;
        v[3] = q.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = c + j < hi ? xr[c + j] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (c + j >= hi) break;
        keep(gumbel_z(v[j], h_row, c + j), c + j, bz, bc);
      }
    }
  }
  warp_keep(bz, bc);
  if (LAYOUT != WARP_ROWS && blockDim.x > 32) {  // the block's warps
    if (lane == 0) {
      s_z[warp] = bz;
      s_c[warp] = bc;
    }
    __syncthreads();
    if (warp == 0) {
      const bool have = lane < (int)blockDim.x / 32;
      bz = have ? s_z[lane] : -CUDART_INF_F;
      bc = have ? s_c[lane] : 0x7fffffff;
      warp_keep(bz, bc);
    }
  }
  if constexpr (LAYOUT == CLUSTER_ROW) {  // block 0 reads every block's pair
    __shared__ float s_part_z;
    __shared__ int s_part_c;
    cooperative_groups::cluster_group cluster =
        cooperative_groups::this_cluster();
    if (threadIdx.x == 0) {
      s_part_z = bz;
      s_part_c = bc;
    }
    cluster.sync();
    if (part == 0 && warp == 0) {
      const bool have = lane < parts;
      bz = have ? *cluster.map_shared_rank(&s_part_z, lane) : -CUDART_INF_F;
      bc = have ? *cluster.map_shared_rank(&s_part_c, lane) : 0x7fffffff;
      warp_keep(bz, bc);
    }
    cluster.sync();  // no block leaves while its pair may still be read
  }
  if (g == 0 && part == 0 && row < b_count)
    out[row] = idx ? idx[(int64_t)row * k + bc] : (long long)bc;
}

}  // namespace

extern "C" {

const char* bm25_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// B4: the k largest of each row of (rows, n) f32 x, as a stable descending
// sort cut to k -> out_v (rows, k) f32, out_i (rows, k) int64.  Each row is
// cut into `slices` slices of slice_len values (a multiple of 4).  The
// caller's int32 scratch: hist (rows, slices, BINS = 8192), state (rows, 4),
// cnt (rows, slices, 4), side_key/side_pos (rows, cap) each (cap 0: the row's
// keys are never compacted), cand_key/cand_pos (rows, k) each, and, for k
// above the shared-memory sort, tmp_key/tmp_pos (rows, k) each.
int bm25_topk_select(const float* x, int rows, int n, int k, int slices,
                     int slice_len, int cap, int* hist, unsigned int* state,
                     int* cnt, unsigned int* side_key, int* side_pos,
                     unsigned int* cand_key, int* cand_pos,
                     unsigned int* tmp_key, int* tmp_pos, float* out_v,
                     long long* out_i, void* stream_ptr) {
  if (rows <= 0) return 0;
  if (n <= 0 || k <= 0 || k > n || slices <= 0 || slices > MAX_SLICES ||
      slice_len <= 0 || slice_len % 4 ||
      (long long)slices * slice_len < n ||
      (long long)(slices - 1) * slice_len >= n || cap < 0 ||
      (cap > 0 && (side_key == nullptr || side_pos == nullptr)) ||
      (k > SORT_SMEM_KEYS && (tmp_key == nullptr || tmp_pos == nullptr)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int grid_rows = rows < MAX_GRID_Y ? rows : MAX_GRID_Y;
  const dim3 grid(slices, grid_rows);
  for (int pass = 0; pass < 3; ++pass) {
    radix_hist<<<grid, RADIX_THREADS, 0, stream>>>(
        x, rows, n, slice_len, vec, pass, state, cnt, side_key, side_pos, cap,
        hist);
    radix_scan<<<grid_rows, SCAN_THREADS, 0, stream>>>(hist, rows, slices, k,
                                                       pass, cap, state, cnt);
    if (pass < 2 && cap > 0)
      radix_compact<<<grid, RADIX_THREADS, 0, stream>>>(
          x, rows, n, slice_len, vec, pass + 1, state, cnt, side_key,
          side_pos, cap);
  }
  radix_select<<<grid, RADIX_THREADS, 0, stream>>>(
      x, rows, n, k, slice_len, vec, state, cnt, side_key, side_pos, cap,
      cand_key, cand_pos);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (k <= SORT_SMEM_KEYS) {
    int m = 1;
    while (m < k) m <<= 1;
    const size_t smem = (size_t)m * sizeof(unsigned long long);
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(sort_smem,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SORT_SMEM_KEYS * 8);
      if (err != cudaSuccess) return (int)err;
    }
    sort_smem<<<grid_rows, SORT_THREADS, smem, stream>>>(
        x, rows, n, k, cand_key, cand_pos, out_v, out_i);
  } else {
    sort_lsd<<<grid_rows, LSD_THREADS, 0, stream>>>(
        x, rows, n, k, cand_key, cand_pos, tmp_key, tmp_pos, out_v, out_i);
  }
  return (int)cudaGetLastError();
}

// B5: (B, k) f32 logits x -> out (B,) int64: the Gumbel-max column of
// each row, or idx[row, column] where idx (B, k) int64 is given.  The
// seed is the low 32 bits of *seed_ptr (an int64 on the device) or, where
// seed_ptr is null, `seed`.  Layout (ChoiceLayout): a warp a row, threads
// / 32 rows a block; a block of `threads` a row; or a cluster of
// `cluster` such blocks a row (a refused launch returns its error).
// Launches on `device` (the current device is restored).
int bm25_gumbel_choice(const float* x, int b_count, int k,
                       const long long* seed_ptr, unsigned int seed,
                       const long long* idx, int layout, int threads,
                       int cluster, long long* out, int device,
                       void* stream_ptr) {
  if (b_count <= 0) return 0;
  if (k <= 0 || k > (1 << 30) || layout < WARP_ROWS || layout > CLUSTER_ROW ||
      threads < 32 || threads % 32 || threads > CHOICE_MAX_THREADS ||
      (layout == CLUSTER_ROW) != (cluster > 1) ||
      cluster > CHOICE_MAX_CLUSTER)
    return (int)cudaErrorInvalidValue;
  int current = device;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool vec = k % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const uint32_t sd = seed;
  if (layout == WARP_ROWS) {
    const int rows = threads / 32;
    gumbel_choice<WARP_ROWS><<<(b_count + rows - 1) / rows, threads, 0,
                                stream>>>(x, b_count, k, seed_ptr, sd, idx,
                                          vec, out);
    err = cudaGetLastError();
  } else if (layout == BLOCK_ROW) {
    gumbel_choice<BLOCK_ROW><<<b_count, threads, 0, stream>>>(
        x, b_count, k, seed_ptr, sd, idx, vec, out);
    err = cudaGetLastError();
  } else {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3((unsigned)b_count * cluster);
    cfg.blockDim = dim3(threads);
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, gumbel_choice<CLUSTER_ROW>, x, b_count, k,
                             seed_ptr, sd, idx, vec, out);
  }
  if (current != device) cudaSetDevice(current);
  return (int)err;
}

}  // extern "C"
