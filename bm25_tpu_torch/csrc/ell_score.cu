// Membership-count ELL scoring kernels for Hopper (sm_90a).
//
// Replaces the two Pallas kernels of bm25_tpu/ops/ell_score.py:
//   * ell_score_pallas (:161)  -> bm25_ell_score        (B2: the plain scan)
//   * ell_score_fused  (:314)  -> bm25_ell_score_fused  (B1: scan + hot
//     split-bf16 products + pad-row mask + maxima of each group of 8 rows)
//
//   base[q, d] = sum_l valT[l, d] * #{t : ids[q, t] == tokT[l, d]}
//
// With per-token weights each match adds w[q, t] instead of 1.
//
// Design of the scan.  The TPU kernel compares every slot's token with
// all Q x T query ids (a VPU sweep, ~Q T L rows compares); here a slot
// costs one lookup, and only a match does arithmetic:
//   - The tables (ell_table_kernel, once per (Q, T) batch of ids, on the
//     device, no host sync; the sparse step makes them once a chunk for
//     every bucket): a tile of qp queries gets a table of its distinct
//     ids, each leading to its (query, c) pairs in query order (c: the
//     id's count in the query, or with weights the t-ordered sum of its
//     weights), hashed into buckets of 4 keys at a load of at most a
//     quarter, with a filter of 8 bits a key slot.  ops/ell_score.py::
//     table_pairs defines what they hold; qp = 128 queries (fewer as T
//     grows: tables and accumulators fit two blocks an SM).
//   - The layout is slot-major (tokT/valT are (L, rows)), so one thread
//     owns one doc row and a warp reads each slot row as one coalesced
//     load.  A block of 128 threads is 128 / ROWS groups of ROWS rows, a
//     group against one table; the tables are copied into shared memory
//     once, and the block walks doc tiles y, y + gridDim.y, ... (as many
//     blocks as the SMs hold; the query blocks of a doc tile are grid
//     neighbours, so its tokens come from L2 after the first).
//   - A thread loads B slots' tokens at once, checks each token's filter
//     bit (one 4-byte shared load; most misses end there), probes the
//     buckets of those that pass (one 16-byte load reads 4 keys; a probe
//     ends at the key or at a bucket with a free slot), loads valT only
//     for hits, then adds c x value with one __fmaf_rn a pair into the
//     (query, row) accumulator in shared memory, laid out [query][row] so
//     that a warp's lanes fall in different banks.  The next B slots'
//     tokens are loaded before this batch's hits are added, and a doc
//     tile's first batch before the write-out of the one before.
//   - The write-out: where a doc tile is one slot tile and rows % 4 == 0,
//     the unmasked scan (B2, and B1's first launch where a hot tier
//     follows) stores the block's (queries x ROWS) box with one TMA store,
//     which lets the block go on to its next doc tile while the box
//     drains (3-8% faster than the threads' stores on an H100, PERF.md);
//     otherwise the threads store 16-byte units (512 contiguous bytes a
//     query and warp), adding a later slot tile's sums to the earlier
//     ones' (base + part), and FUSED masks pad rows and writes the maxima
//     of each 8 rows on the way.
//
// Exactness.  The f32 order is the Pallas kernel's: per slot, reduce the
// matches over T (an integer count, or the sum of the matching weights in
// t order: the table's c, computed once), then add c * value to the
// accumulator of each matching query with one rounding
// (a fused multiply-add, which is what the JAX kernel compiles to), slots
// ascending from +0; a bucket wider than SLOT_TILE adds the partial sums
// of _slot_tiling's balanced tiles in order.  __fmaf_rn/__fadd_rn pin each
// rounding, so the ELL-only base is bit-equal to the plain PyTorch twin
// and to the JAX kernel.  A slot with no match adds +/-0 to a sum that is
// never -0 (it starts at +0 and round-to-nearest never makes -0 from a
// nonzero sum), so skipping such slots changes no bit.
//
// The hot epilogue adds sum_h hc[q,h]*hi[h,d], then sum_h hc[q,h]*lo[h,d],
// then (split counts) sum_h hc_lo[q,h]*hi[h,d], in the order the Pallas
// kernel adds its dots.  With a hot tier B1 is two launches:
// the scan writes the ELL-only base into out, then ell_hot_kernel reads
// it, adds the three products in that order, applies the pad-row mask and
// writes out and gmax; without one, the scan applies the mask and the
// maxima itself (a hot-only bucket, l_pad == 0, skips the scan: base +0).
//
// ell_hot_kernel runs the products on the tensor cores: wgmma on bf16
// with f32 accumulators.  A product of two bf16 values is exact in f32,
// so only the order of the sums differs from the twin's (held to 2e-5 x
// the row's largest |score|).  The doc rows are wgmma's M and the queries
// its N, so the (H, rows) hot pair is the A operand and the counts the B
// operand, K-major as they lie ((Q, H) rows):
//   - K runs over the hot tokens the chunk uses, not all H: the wrapper's
//     hot plan (ops/ell_score.py::hot_plan, on the device, no host sync)
//     lists, ascending, each aligned group of 16 hot ranks (one k16 step)
//     in which some query counts a token, every rank at its own offset
//     in its group (-1 where no query counts it: a row not read), and the
//     counts' columns in that order, zero past them; n_used (16 x the
//     groups) says how many K steps of HOT_BK run.  So a query's nonzero
//     counts meet the same lanes of the same sequence of k16 steps
//     whatever its chunk-mates are: the steps and lanes only mates use
//     add exact zero products, and its sums keep their bits.  A query
//     uses at most T tokens, so an 8-query chunk reads at most 64 hot
//     rows, in at most 64 groups, where a dense product would read all
//     H.  A block keeps the list in shared memory beside its ring (H up
//     to about 32,000; two blocks fit an SM up to H of about 3,000): a
//     global load per stage put an L2 round trip before each stage's
//     copies.
//   - TMA has no row gather, so a producer warp stages each used hot
//     row's run of the block's HOT_BM doc rows by 16-byte cp.async (one
//     warp instruction copies two rows' 256 bytes), completing on the
//     stage's mbarrier (cp.async.mbarrier.arrive); rows are padded by 16
//     bytes in shared memory.  One 1-D cp.async.bulk a row (64 copies of
//     256 bytes a stage) paced the ring and was markedly slower on an
//     H100; deeper rings were no faster.  The
//     consumers read the rows with ldmatrix.trans straight into wgmma's A
//     fragments (the rows are M-contiguous: the transpose happens on the
//     way into registers).  Rows past n_used or listed as -1, and units
//     past the bucket's rows, are zero-filled by the copy (a zero count
//     times stale shared memory could be NaN).  The counts come by TMA
//     in the 128-byte swizzle, one box of HOT_BK tokens by BQ queries a
//     stage, E4's descriptor.
//   - A block covers BQ = 128 queries (16 for chunks of at most 16) and
//     HOT_BM = 128 doc rows in two consumer warpgroups, two blocks an SM
//     (three stages each), so one block's base reads, stores and stage
//     hand-offs overlap the other's products; the query blocks of one doc
//     tile are neighbours in the grid, so the hot rows they share come
//     from L2.  One accumulator: each thread's BQ / 2 running sums start
//     at the base and are wgmma's D through every pass (hi, lo, then hi
//     against hc_lo), in that order, streamed through one ring of stages.
//     The sums round where the tensor cores round them, not after each
//     product sum as the twin does; tests/test_torch_cuda.py holds the
//     result within the bound, 64 weighted hot tokens a query included,
//     and a query's results bit-equal alone and in any chunk (BQ = 16 or
//     128 alike).  Keeping the three sums apart took a second
//     accumulator and so one block an SM, and ran slower on an H100, as
//     did blocks of 256 queries (they spilled).
//
// What bounds it on an H100.  The scan must read the slots' tokens once
// and the values of the slots that match, and write the (Q, rows) base
// once, Q rows x 4 bytes; its arithmetic (one FMA a matching (query,
// posting) pair) is negligible.  It stays above that bound by the
// lookups: with every slot looked up once per table, a bucket of L slots
// costs L x rows x Q / qp lookups, and those, not the writes, take most
// of its time (PERF.md).  What B1 must move beyond the scan is the used
// hot rows (2 bytes each, hi and lo), the counts, doc_ids and the
// maxima; its dense products (~2 Q n_used rows 2 FLOP) sit well under
// the bf16 peak.  The hot kernel also reads and rewrites the base (2 Q
// rows 4 bytes), the price of two launches, and re-reads the used hot
// rows once per query block: those, not B1's own work, set its time.
//
// Offsets are int64: q*rows and h*rows pass 2^31 at larger corpora.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>

#include "matmul_ring.cuh"  // mbarriers, TMA, cp.async.bulk, allow_smem
#include "wgmma.cuh"        // wgmma descriptors and fences, swizzled maps

namespace {

constexpr int GROUP = 8;  // rows per group maximum

// ------------------------------------------------------- the lookup tables --

// A table holds the tokens of `qp` consecutive queries (a tile) and, for
// each, its (query, c) pairs; as int32 words:
//   [0]          the number of pairs, then 3 words of padding
//   [4, 4+cap)   keys: the tile's distinct token ids by open addressing
//                in buckets of 4 (a key lies in the first bucket from its
//                table_hash bucket on that had a free slot), EMPTY where
//                unused
//   [.., +cap)   meta: start | count << 16 of the token's run of pairs
//   [.., +cap/4) filter: 8 cap bits, bit filter_hash(key) set for each key
//   [.., +2n)    pairs (query in the tile, c as f32 bits), n = qp * T slots
// c is the token's count in the query (an exact integer), or with weights
// the sum of its weights in t order (the first as it is, then __fadd_rn).
// Tiles are table_words apart, a multiple of 4 words (16 bytes).
constexpr int TABLE_HEAD = 4;
constexpr int EMPTY = -1;
constexpr int TABLE_THREADS = 256;
constexpr int TABLE_SCRATCH = 16;  // words before the kernel's keys
constexpr int MAX_TABLE_ENTRIES = 4096;  // qp * T; keys and pairs fit 16 bits

__host__ __device__ inline int64_t table_words(int cap_log2, int n) {
  const int64_t cap = (int64_t)1 << cap_log2;
  return TABLE_HEAD + 2 * cap + cap / 4 + 2 * (int64_t)(n + (n & 1));
}

constexpr int BUCKET = 4;  // keys a bucket: one 16-byte shared load

// the first bucket a token's key may lie in (cap_log2 >= 4)
__device__ __forceinline__ uint32_t table_hash(int tok, int cap_log2) {
  return ((uint32_t)tok * 0x9E3779B1u) >> (32 - (cap_log2 - 2));
}

// the token's bit of the filter (8 cap bits)
__device__ __forceinline__ uint32_t filter_hash(int tok, int cap_log2) {
  return ((uint32_t)tok * 0x85EBCA6Bu) >> (32 - (cap_log2 + 3));
}

struct TableArgs {
  const int* ids;        // (Q, T); < 0: pad or OOV, never a key
  const float* weights;  // (Q, T) or null
  int q_count, t_count, qp, cap_log2;
  int* table;  // (ceil(Q / qp), table_words)
};

// One block builds one tile's table in shared memory: insert the ids
// (atomicCAS), sort the entries by (slot, entry) so that each slot's
// entries lie in query then t order, count the pair starts (one a distinct
// (slot, query)) with a block scan, then write the pairs, the runs and the
// keys.  Which slot a colliding key takes depends on the race; the
// contents (key -> pairs) do not.
__global__ void __launch_bounds__(TABLE_THREADS) ell_table_kernel(
    const TableArgs a) {
  extern __shared__ __align__(16) int t_smem[];
  const int cap = 1 << a.cap_log2, t = a.t_count, n = a.qp * t;
  int npow = 1;
  while (npow < n) npow <<= 1;
  int* s_warp = t_smem;  // [TABLE_THREADS / 32], then the valid entries
  int& s_valid = t_smem[TABLE_THREADS / 32];
  int* s_keys = t_smem + TABLE_SCRATCH;                   // [cap]
  int* s_meta = s_keys + cap;                             // [cap]
  uint32_t* s_filter = reinterpret_cast<uint32_t*>(s_meta + cap);  // [cap/4]
  uint32_t* s_sort = s_filter + cap / 4;                  // [npow]
  int* s_idx = reinterpret_cast<int*>(s_sort + npow);    // [npow]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int64_t e0 = (int64_t)blockIdx.x * n;  // the tile's first entry
  const int q_in = min(a.qp, a.q_count - (int)blockIdx.x * a.qp);
  int* out = a.table + (int64_t)blockIdx.x * table_words(a.cap_log2, n);
  int2* out_pairs =
      reinterpret_cast<int2*>(out + TABLE_HEAD + 2 * cap + cap / 4);

  for (int i = tid; i < cap; i += TABLE_THREADS) s_keys[i] = EMPTY;
  for (int i = tid; i < cap / 4; i += TABLE_THREADS) s_filter[i] = 0;
  if (tid == 0) s_valid = 0;
  __syncthreads();
  int valid = 0;
  for (int i = tid; i < npow; i += TABLE_THREADS) {
    uint32_t key = 0xFFFFFFFFu;  // sorts last
    const int id = i < q_in * t ? __ldg(a.ids + e0 + i) : -1;
    if (id >= 0) {
      uint32_t h = table_hash(id, a.cap_log2) * BUCKET;
      for (;;) {  // the bucket's slots in order, then the next bucket's
        const int prev = atomicCAS(&s_keys[h], EMPTY, id);
        if (prev == EMPTY || prev == id) break;
        h = (h + 1) & (cap - 1);
      }
      key = h << 16 | (uint32_t)i;
      ++valid;
      const uint32_t f = filter_hash(id, a.cap_log2);
      atomicOr(&s_filter[f >> 5], 1u << (f & 31));
    }
    s_sort[i] = key;
  }
  if (valid) atomicAdd(&s_valid, valid);
  __syncthreads();
  for (int k = 2; k <= npow; k <<= 1) {  // bitonic sort, ascending
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < npow; i += TABLE_THREADS) {
        const int l = i ^ j;
        if (l > i) {
          const uint32_t x = s_sort[i], y = s_sort[l];
          if ((x > y) == ((i & k) == 0)) {
            s_sort[i] = y;
            s_sort[l] = x;
          }
        }
      }
      __syncthreads();
    }
  }
  const int nv = s_valid;
  // entry p starts a pair where its slot or its query differs from p - 1's
  auto pair_start = [&](int p) -> int {
    if (p >= nv) return 0;
    if (p == 0) return 1;
    const uint32_t x = s_sort[p], y = s_sort[p - 1];
    return (x >> 16) != (y >> 16) ||
           (int)(x & 0xFFFF) / t != (int)(y & 0xFFFF) / t;
  };
  // exclusive scan of the pair starts: each thread a run of chunk entries
  const int chunk = (npow + TABLE_THREADS - 1) / TABLE_THREADS;
  const int p0 = tid * chunk;
  int local = 0;
  for (int c = 0; c < chunk; ++c) local += pair_start(p0 + c);
  int incl = local;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int v = lane < TABLE_THREADS / 32 ? s_warp[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (lane < TABLE_THREADS / 32) s_warp[lane] = v;
  }
  __syncthreads();
  int run = (warp ? s_warp[warp - 1] : 0) + incl - local;
  for (int c = 0; c < chunk && p0 + c < npow; ++c) {
    s_idx[p0 + c] = run;
    run += pair_start(p0 + c);
  }
  const int n_pairs = s_warp[TABLE_THREADS / 32 - 1];
  __syncthreads();
  // the pairs, and each token's first pair
  for (int p = tid; p < nv; p += TABLE_THREADS) {
    const uint32_t x = s_sort[p];
    const int slot = x >> 16, i = x & 0xFFFF, q = i / t;
    if (p == 0 || (s_sort[p - 1] >> 16) != (uint32_t)slot) s_meta[slot] = s_idx[p];
    if (!pair_start(p)) continue;
    float c = a.weights ? __ldg(a.weights + e0 + i) : 1.0f;
    int cnt = 1;
    for (int r = p + 1; r < nv; ++r) {
      const uint32_t y = s_sort[r];
      if ((y >> 16) != (uint32_t)slot || (int)(y & 0xFFFF) / t != q) break;
      if (a.weights) c = __fadd_rn(c, __ldg(a.weights + e0 + (y & 0xFFFF)));
      ++cnt;
    }
    if (!a.weights) c = (float)cnt;
    out_pairs[s_idx[p]] = make_int2(q, __float_as_int(c));
  }
  __syncthreads();
  // each token's run ends at its last entry's pair
  for (int p = tid; p < nv; p += TABLE_THREADS) {
    const int slot = s_sort[p] >> 16;
    if (p + 1 < nv && (int)(s_sort[p + 1] >> 16) == slot) continue;
    const int start = s_meta[slot];
    s_meta[slot] = start | (s_idx[p] + pair_start(p) - start) << 16;
  }
  __syncthreads();
  if (tid == 0) out[0] = n_pairs;
  if (tid > 0 && tid < TABLE_HEAD) out[tid] = 0;
  for (int i = tid; i < cap; i += TABLE_THREADS) {
    const int key = s_keys[i];
    out[TABLE_HEAD + i] = key;
    out[TABLE_HEAD + cap + i] = key == EMPTY ? 0 : s_meta[i];
  }
  for (int i = tid; i < cap / 4; i += TABLE_THREADS)
    out[TABLE_HEAD + 2 * cap + i] = s_filter[i];
}

int launch_table(const TableArgs& a, cudaStream_t stream) {
  const int n = a.qp * a.t_count;
  if (a.qp <= 0 || a.t_count <= 0 || n > MAX_TABLE_ENTRIES ||
      a.cap_log2 < 4 || a.cap_log2 > 16 || (1 << a.cap_log2) < 2 * n)
    return (int)cudaErrorInvalidValue;
  int npow = 1;
  while (npow < n) npow <<= 1;
  const size_t cap = (size_t)1 << a.cap_log2;
  const size_t smem =
      (TABLE_SCRATCH + 2 * cap + cap / 4 + 2 * (size_t)npow) * sizeof(int);
  if (int err = allow_smem(ell_table_kernel, smem)) return err;
  const int tiles = (a.q_count + a.qp - 1) / a.qp;
  ell_table_kernel<<<tiles, TABLE_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- the scan --

constexpr int SCAN_THREADS = 128;

struct ScanArgs {
  const int* table;  // (tiles, words) from ell_table_kernel
  int tiles, qp, cap_log2, q_count, t_count;
  const int* tokT;    // (L, rows)
  const float* valT;  // (L, rows)
  int l_pad, rows, l_tile;
  const int* doc_ids;  // (rows,); FUSED only
  float* out;          // (Q, rows)
  float* gmax;         // (Q, rows / GROUP); FUSED only
  int tma_out;         // set by the launch: out goes by TMA stores
};

// B slots of a thread's row: their tokens (-1 past the range or the
// rows), what the lookups found (0: a miss, else the token's run of
// pairs: start | count << 16; a key's run is never empty) and the hits'
// values.
template <int B>
struct Batch {
  int tok[B], hit[B];
  float val[B];
};

template <int B>
__device__ __forceinline__ void load_tokens(Batch<B>& b, const ScanArgs& a,
                                            int row, int l, int l1) {
#pragma unroll
  for (int j = 0; j < B; ++j)
    b.tok[j] = row < a.rows && l + j < l1
                   ? __ldg(a.tokT + (int64_t)(l + j) * a.rows + row) : -1;
}

// each token looked up, then the hits' values loaded.  The filter's bit
// (one 4-byte shared load, all B at once) rules out most misses; past it
// a probe reads a bucket's 4 keys at once, and a lookup ends at its key
// or at a bucket with a free slot.  The probes go round by round over the
// B slots: a round's loads are independent, and a warp waits once a round.
template <int B>
__device__ __forceinline__ void look_up(Batch<B>& b, const ScanArgs& a,
                                        const int* keys, const int* meta,
                                        const uint32_t* filter, int row,
                                        int l) {
  const uint32_t mask = (1u << (a.cap_log2 - 2)) - 1;
  const int4* buckets = reinterpret_cast<const int4*>(keys);
  uint32_t h[B], bits[B];
  int at[B];  // the slot of a found key, else -1
  uint32_t probing = 0;  // bit j: slot j probes on
#pragma unroll
  for (int j = 0; j < B; ++j) {
    h[j] = filter_hash(b.tok[j], a.cap_log2);
    bits[j] = b.tok[j] >= 0 ? filter[h[j] >> 5] : 0;
  }
#pragma unroll
  for (int j = 0; j < B; ++j) {
    probing |= (bits[j] >> (h[j] & 31) & 1) << j;
    h[j] = table_hash(b.tok[j], a.cap_log2);
    at[j] = -1;
  }
  while (probing) {
    int4 k[B];
#pragma unroll
    for (int j = 0; j < B; ++j)
      k[j] = probing >> j & 1 ? buckets[h[j]]
                              : make_int4(EMPTY, EMPTY, EMPTY, EMPTY);
#pragma unroll
    for (int j = 0; j < B; ++j) {
      if (!(probing >> j & 1)) continue;
      const int t = b.tok[j];
      const int i = k[j].x == t ? 0 : k[j].y == t ? 1 : k[j].z == t ? 2
                                                   : k[j].w == t ? 3 : -1;
      if (i >= 0) at[j] = BUCKET * h[j] + i;
      if (i >= 0 || k[j].w == EMPTY)  // a bucket fills in order
        probing &= ~(1u << j);
      else
        h[j] = (h[j] + 1) & mask;
    }
  }
#pragma unroll
  for (int j = 0; j < B; ++j) b.hit[j] = at[j] >= 0 ? meta[at[j]] : 0;
#pragma unroll
  for (int j = 0; j < B; ++j)
    b.val[j] = b.hit[j] ? __ldg(a.valT + (int64_t)(l + j) * a.rows + row)
                        : 0.0f;
}

// for each hit, in slot order, one __fmaf_rn per pair into the
// accumulator of (query, row)
template <int ROWS, int B>
__device__ __forceinline__ void add_hits(const Batch<B>& b,
                                         const int2* pairs, float* acc) {
#pragma unroll
  for (int j = 0; j < B; ++j) {
    if (!b.hit[j]) continue;
    const int p1 = (b.hit[j] & 0xFFFF) + (b.hit[j] >> 16);
    for (int p = b.hit[j] & 0xFFFF; p < p1; ++p) {
      const int2 pr = pairs[p];
      float* x = acc + pr.x * ROWS;
      *x = __fmaf_rn(__int_as_float(pr.y), b.val[j], *x);
    }
  }
}

// A thread's row over slots [l0, l1), whose first batch's tokens `cur`
// already holds: batch k + 1's tokens are loaded before batch k's hits
// are added, so that its loads are in flight while batch k's values
// arrive.
template <int ROWS, int B>
__device__ __forceinline__ void scan_slots(Batch<B>& cur, const ScanArgs& a,
                                           const int* keys, const int* meta,
                                           const uint32_t* filter,
                                           const int2* pairs, float* acc,
                                           int row, int l0, int l1) {
  look_up(cur, a, keys, meta, filter, row, l0);
  for (int l = l0 + B; l < l1; l += B) {
    Batch<B> nxt;
    load_tokens(nxt, a, row, l, l1);
    add_hits<ROWS>(cur, pairs, acc);
    look_up(nxt, a, keys, meta, filter, row, l);
    cur = nxt;
  }
  add_hits<ROWS>(cur, pairs, acc);
}

// Make this thread's shared-memory writes visible to TMA
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The accumulators' box to out by TMA (one thread), the smem read awaited
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];\n"
      "cp.async.bulk.commit_group;\n"
      "cp.async.bulk.wait_group.read 0;\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0),
         "r"(c1)
      : "memory");
}

// The block's accumulators (G * qp queries x ROWS rows) to out, zeroing
// them: a slot tile's sums as they are (first) or added to the sums of the
// tiles before (base + part); after the last tile, FUSED masks pad rows
// and writes the maxima of each 8 rows.  Rows % 4 == 0 (always so when
// FUSED): a thread moves 4 rows as one 16-byte unit, the same 4 rows
// (unit tid % V) for every query, so a warp stores 512 contiguous bytes a
// query; else one row at a time.
template <int ROWS, int G, bool FUSED>
__device__ __forceinline__ void write_out(const ScanArgs& a, float* acc,
                                          int dt, int q_base, bool first,
                                          bool last) {
  const int rows = a.rows, row_base = dt * ROWS;
  if (FUSED || rows % 4 == 0) {
    constexpr int V = ROWS / 4;
    const int total = G * a.qp * V;
    const int row = row_base + 4 * (threadIdx.x % V);
    const bool live = row < rows;
    int pad = 0;  // bit i: row + i is a pad row
    if (FUSED && last)
      for (int i = 0; i < 4; ++i)
        pad |= (!live || __ldg(a.doc_ids + row + i) < 0) << i;
    float4* acc4 = reinterpret_cast<float4*>(acc);
    // the same trip count for every lane (qp may be 1 or 2: the shuffle
    // below needs the whole warp)
    for (int f0 = 0; f0 < total; f0 += ROWS * G) {
      const int f = f0 + threadIdx.x;
      const int q = q_base + f / V;
      const bool ok = live && f < total && q < a.q_count;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (f < total) {
        v = acc4[f];
        acc4[f] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
      float4* dst = reinterpret_cast<float4*>(a.out + (int64_t)q * rows + row);
      if (ok && !first) {
        const float4 b = *dst;
        v = make_float4(__fadd_rn(b.x, v.x), __fadd_rn(b.y, v.y),
                        __fadd_rn(b.z, v.z), __fadd_rn(b.w, v.w));
      }
      if (FUSED && last) {
        if (pad & 1) v.x = -CUDART_INF_F;
        if (pad & 2) v.y = -CUDART_INF_F;
        if (pad & 4) v.z = -CUDART_INF_F;
        if (pad & 8) v.w = -CUDART_INF_F;
        // a group of 8 rows is two neighbouring lanes' units
        float m = fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        if (ok && f % 2 == 0)
          a.gmax[(int64_t)q * (rows / GROUP) + row / GROUP] = m;
      }
      if (ok) *dst = v;
    }
  } else {
    const int total = G * a.qp * ROWS;
    for (int f = threadIdx.x; f < total; f += ROWS * G) {
      const int q = q_base + f / ROWS, row = row_base + f % ROWS;
      float v = acc[f];
      acc[f] = 0.0f;
      if (q >= a.q_count || row >= rows) continue;
      float* dst = a.out + (int64_t)q * rows + row;
      *dst = first ? v : __fadd_rn(*dst, v);
    }
  }
}

// Block (x, y): the G tables x G, .., x G + G - 1 (G * qp queries) over
// doc tiles y, y + gridDim.y, ... of ROWS rows; thread (g, r) = row r of
// each doc tile against table g.  The tables are copied into shared memory
// once; the accumulators live there as [query][row], so a warp's lanes
// (its rows) fall in different banks whichever queries they add to.
template <int ROWS, int B, bool FUSED>
__global__ void __launch_bounds__(SCAN_THREADS) ell_scan_kernel(
    const __grid_constant__ CUtensorMap out_map, const ScanArgs a) {
  constexpr int G = SCAN_THREADS / ROWS;
  extern __shared__ __align__(16) int s_dyn[];
  const int cap = 1 << a.cap_log2, qp = a.qp;
  const int64_t words = table_words(a.cap_log2, qp * a.t_count);
  float* acc = reinterpret_cast<float*>(s_dyn);  // [G * qp][ROWS]
  int* tabs = s_dyn + G * qp * ROWS;            // G tables, words apart
  const int tid = threadIdx.x, g = tid / ROWS, r = tid % ROWS;

  for (int gg = 0; gg < G; ++gg) {
    int* dst = tabs + gg * words;
    const int tile = blockIdx.x * G + gg;
    if (tile < a.tiles) {
      const int* src = a.table + (int64_t)tile * words;
      const int units =
          (TABLE_HEAD + 2 * cap + cap / 4 + 2 * __ldg(src) + 3) / 4;
      for (int i = tid; i < units; i += SCAN_THREADS)
        reinterpret_cast<int4*>(dst)[i] =
            __ldg(reinterpret_cast<const int4*>(src) + i);
    }
  }
  for (int i = tid; i < G * qp * ROWS / 4; i += SCAN_THREADS)
    reinterpret_cast<float4*>(acc)[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __syncthreads();

  const int* keys = tabs + g * words + TABLE_HEAD;
  const int* meta = keys + cap;
  const uint32_t* filter = reinterpret_cast<const uint32_t*>(meta + cap);
  const int2* pairs = reinterpret_cast<const int2*>(filter + cap / 4);
  float* my_acc = acc + g * qp * ROWS + r;
  const int q_base = blockIdx.x * G * qp;
  // a group with no table (past the last query) only writes nothing
  const int tile = blockIdx.x * G + g;
  const bool scans = tile < a.tiles;
  const int doc_tiles = (a.rows + ROWS - 1) / ROWS;
  // the ranges (doc tile, slot tile) in order, once a doc tile where
  // l_pad == 0; each range's first tokens are loaded before the write-out
  // of the range before
  int dt = blockIdx.y, l0 = 0;
  Batch<B> cur;
  if (scans)
    load_tokens(cur, a, dt * ROWS + r, 0, min(a.l_tile, a.l_pad));
  while (dt < doc_tiles) {
    const int l1 = min(l0 + a.l_tile, a.l_pad);
    if (scans)
      scan_slots<ROWS, B>(cur, a, keys, meta, filter, pairs, my_acc,
                          dt * ROWS + r, l0, l1);
    int next_dt = dt, next_l0 = l1;
    if (next_l0 >= a.l_pad) {
      next_dt += gridDim.y;
      next_l0 = 0;
    }
    if (scans && next_dt < doc_tiles)
      load_tokens(cur, a, next_dt * ROWS + r, next_l0,
                  min(next_l0 + a.l_tile, a.l_pad));
    if (!FUSED && a.tma_out) {  // one slot tile: the box goes out by TMA
      fence_async_shared();
      __syncthreads();
      if (tid == 0) tma_store(&out_map, acc, dt * ROWS, q_base);
      __syncthreads();
      for (int qq = 0; qq < qp; ++qq) my_acc[qq * ROWS] = 0.0f;
    } else {
      __syncthreads();
      write_out<ROWS, G, FUSED>(a, acc, dt, q_base, l0 == 0, l1 == a.l_pad);
      __syncthreads();
    }
    dt = next_dt;
    l0 = next_l0;
  }
  if (!FUSED && a.tma_out && tid == 0)
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <int ROWS, int B, bool FUSED>
int launch_scan_kernel(ScanArgs a, cudaStream_t stream) {
  constexpr int G = SCAN_THREADS / ROWS;
  // TMA stores the block's box where a doc tile is one slot tile and out's
  // rows are whole 16-byte units; else the threads store it
  CUtensorMap out_map = {};
  a.tma_out = !FUSED && a.l_pad <= a.l_tile && a.rows % 4 == 0 &&
              G * a.qp <= 256 &&
              reinterpret_cast<uintptr_t>(a.out) % 16 == 0;
  if (a.tma_out)
    if (int err = encode_rows<float>(&out_map, a.out, a.q_count, a.rows,
                                     a.rows, ROWS, G * a.qp))
      return err;
  const size_t smem =
      ((size_t)G * a.qp * ROWS +
       G * (size_t)table_words(a.cap_log2, a.qp * a.t_count)) * sizeof(int);
  auto kernel = ell_scan_kernel<ROWS, B, FUSED>;
  if (int err = allow_smem(kernel, smem)) return err;
  if (int err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared))
    return err;
  // as many blocks as the SMs hold at once: the query blocks of a doc tile
  // are neighbours in the grid, so its tokens come from L2 after the first
  int dev = 0, sms = 0, per_sm = 0;
  if (int err = cudaGetDevice(&dev)) return err;
  if (int err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                       dev))
    return err;
  if (int err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, SCAN_THREADS, smem))
    return err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int qblocks = (a.tiles + G - 1) / G;
  const int doc_tiles = (a.rows + ROWS - 1) / ROWS;
  const int64_t want = ((int64_t)sms * per_sm + qblocks - 1) / qblocks;
  const int y = (int)std::min<int64_t>(std::min<int64_t>(want, doc_tiles),
                                       65535);
  kernel<<<dim3(qblocks, std::max(y, 1)), SCAN_THREADS, smem, stream>>>(
      out_map, a);
  return (int)cudaGetLastError();
}

// The two builds ops/ell_score.py::scan_build picks by T: rows_tile doc
// rows a block (the block's 128 threads are 128 / rows_tile groups of one
// table each), batch slots a thread loads at once
template <bool FUSED>
int launch_scan(const ScanArgs& a, int rows_tile, int batch,
                cudaStream_t s) {
  if (rows_tile == 128 && batch == 8)  // T > 1
    return launch_scan_kernel<128, 8, FUSED>(a, s);
  if (rows_tile == 64 && batch == 16)  // one-token queries (B2's build)
    return launch_scan_kernel<64, 16, FUSED>(a, s);
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------------------ B1's hot epilogue --

constexpr int HOT_BK = 64;             // hot tokens a stage: 128 bytes of counts
constexpr int HOT_WG = 2;              // consumer warpgroups, 64 doc rows each
constexpr int HOT_BM = 64 * HOT_WG;    // doc rows a block
constexpr int HOT_CONSUMER_WARPS = 4 * HOT_WG;
constexpr int HOT_THREADS = 32 * (HOT_CONSUMER_WARPS + 1);  // + a producer
constexpr int HOT_LD = 2 * HOT_BM + 16;  // bytes a staged hot row, padded

// BQ queries a block (wgmma's N): 128, or 16 for chunks of at most 16.
template <int BQ>
struct HotShape {
  static constexpr int STAGES = 3;
  static constexpr int MIN_BLOCKS = BQ == 128 ? 2 : 3;
  static constexpr int COUNT_BYTES = BQ * SWIZZLE_ROW_BYTES;  // BQ x HOT_BK
  static constexpr int STAGE_BYTES =
      (COUNT_BYTES + HOT_BK * HOT_LD + 1023) / 1024 * 1024;
  // the ring, its barriers, then the used tokens (at most kp)
  static size_t smem(int kp) {
    return 1024 + (size_t)STAGES * STAGE_BYTES +
           2 * STAGES * sizeof(uint64_t) + (size_t)kp * sizeof(int);
  }
  static_assert(COUNT_BYTES % 1024 == 0, "the hot tile follows aligned");
};

struct HotArgs {
  const float* base;              // (Q, rows) ELL-only base; null: +0
  const __nv_bfloat16* hotT;      // (H, rows) high parts
  const __nv_bfloat16* hotLo;     // (H, rows) residuals
  const int* tokens;              // (kp,) the listed ranks, -1: zeros
  const int* n_used;              // (1,) how many are listed
  const int* doc_ids;             // (rows,)
  int q_count, rows;
  float* out;   // (Q, rows); may be base
  float* gmax;  // (Q, rows / GROUP)
};

// 16 bytes from global to shared memory, or 16 zeros where !valid (the
// source is then not read)
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// One arrival on `bar` once this thread's cp.async copies so far have
// landed (counted in the barrier's initial count: noinc).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d (a warpgroup's 64 doc rows x BQ queries) += A (64 x 16, this warp's
// 16 rows in registers) @ B (16 x BQ, K-major in shared memory); scale_d
// == 0 starts the sum at the product.
template <int BQ>
__device__ __forceinline__ void wgmma_hot(float (&d)[BQ / 2],
                                          const uint32_t (&a)[4],
                                          uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_hot<128>(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WGMMA_REGS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : WGMMA_D64(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_hot<16>(float (&d)[8],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, "
      "0;\n}\n"
      : WGMMA_D8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// Block b: query block b % q_blocks (BQ queries), doc tile b / q_blocks
// (HOT_BM rows).  Warps 0-7 are two consumer warpgroups of 64 doc rows;
// warp 8 is the producer.  Pass 0 sums counts x hi, pass 1 counts x lo,
// pass 2 (SPLIT) counts_lo x hi, each over ceil(n_used / HOT_BK) stages.
template <int BQ, bool SPLIT>
__global__ void __launch_bounds__(HOT_THREADS, HotShape<BQ>::MIN_BLOCKS)
ell_hot_kernel(const __grid_constant__ CUtensorMap map_c,
               const __grid_constant__ CUtensorMap map_clo, const HotArgs a) {
  using S = HotShape<BQ>;
  constexpr int PASSES = SPLIT ? 3 : 2;
  extern __shared__ __align__(16) uint8_t hot_smem[];
  uint8_t* ring = hot_smem + ((1024 - (smem_u32(hot_smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S::STAGES *
                                               S::STAGE_BYTES);
  uint64_t* empty = full + S::STAGES;
  int* s_tok = reinterpret_cast<int*>(empty + S::STAGES);  // [n_used]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q_blocks = (a.q_count + BQ - 1) / BQ;
  const int q0 = (blockIdx.x % q_blocks) * BQ;
  const int64_t d0 = (int64_t)(blockIdx.x / q_blocks) * HOT_BM;
  const int rows = a.rows;
  const int n_used = *a.n_used;
  const int steps = (n_used + HOT_BK - 1) / HOT_BK;  // a pass's stages
  const int total = PASSES * steps;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(&full[s], 33);  // the counts' expect_tx + 32 lanes' copies
      mbar_init(&empty[s], HOT_CONSUMER_WARPS);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the listed hot ranks, read once
  for (int i = threadIdx.x; i < n_used; i += blockDim.x)
    s_tok[i] = __ldg(a.tokens + i);
  __syncthreads();

  if (warp == HOT_CONSUMER_WARPS) {  // the producer warp
    // a lane copies 16-byte unit lane % 16 of rows 2 c + lane / 16, c <
    // 32: a warp's copy is 2 rows x 256 bytes; units past the bucket's
    // rows, and rows past the used tokens, are zeros
    const bool unit_live = d0 + 8 * (lane % 16) < rows;
    for (int t = 0; t < total; ++t) {
      const int slot = t % S::STAGES, pass = t / steps;
      const int k0 = (t % steps) * HOT_BK;
      uint8_t* st = ring + slot * S::STAGE_BYTES;
      uint8_t* hot = st + S::COUNT_BYTES + 16 * (lane % 16);
      const __nv_bfloat16* src = (pass == 1 ? a.hotLo : a.hotT) + d0 +
                                 8 * (lane % 16);
      const int tok_a = k0 + lane < n_used ? s_tok[k0 + lane] : -1;
      const int tok_b = k0 + 32 + lane < n_used ? s_tok[k0 + 32 + lane] : -1;
      if (lane == 0) mbar_wait(&empty[slot], ((t / S::STAGES) & 1) ^ 1);
      __syncwarp();
      if (lane == 0) {
        mbar_expect_tx(&full[slot], S::COUNT_BYTES);
        tma_load(st, pass == 2 ? &map_clo : &map_c, k0, q0, &full[slot]);
      }
#pragma unroll 4
      for (int c = 0; c < HOT_BK / 2; ++c) {
        const int k = 2 * c + lane / 16;
        const int tok = __shfl_sync(0xffffffffu, c < 16 ? tok_a : tok_b,
                                    k % 32);
        const bool valid = tok >= 0 && unit_live;
        cp_async16_zfill(hot + k * HOT_LD,
                         valid ? src + (int64_t)tok * rows : a.hotT, valid);
      }
      cp_async_arrive(&full[slot]);
    }
    return;
  }

  // consumers: warp w holds doc rows d0 + 16 w .. + 15 (warpgroup w / 4);
  // the running sum res, wgmma's accumulator from the base on, holds at
  // res[4 j + 2 h + e] (doc row lane / 4 + 8 h, query 8 j + 2 (lane % 4)
  // + e)
  const int64_t m_lo = d0 + 16 * warp + lane / 4;
  const int qc = q0 + 2 * (lane % 4);
  float res[BQ / 2];
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int64_t m = m_lo + 8 * h;
        const int q = qc + 8 * j + e;
        res[4 * j + 2 * h + e] =
            a.base != nullptr && m < rows && q < a.q_count
                ? a.base[(int64_t)q * rows + m] : 0.0f;
      }
    }
  }
  // lane l gives ldmatrix the row address of matrix l / 8: k = l % 8 (+8
  // for matrices 2, 3), doc rows +8 for matrices 1, 3
  const int a_off = (lane % 8 + 8 * (lane / 16)) * HOT_LD +
                    2 * (16 * warp + 8 * ((lane / 8) % 2));
  const uint64_t db = wgmma_desc(ring);
  for (int t = 0; t < total; ++t) {
    const int slot = t % S::STAGES;
    mbar_wait(&full[slot], (t / S::STAGES) & 1);
    const uint8_t* hot = ring + slot * S::STAGE_BYTES + S::COUNT_BYTES;
    const uint64_t off = (uint64_t)(slot * S::STAGE_BYTES) >> 4;
    // two k16 slices at a time: their A fragments stay live until the
    // wgmma reading them is done, and two blocks an SM leave 96 registers
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t frag[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        ldmatrix_x4_trans(frag[kk],
                          hot + a_off + 16 * (2 * half + kk) * HOT_LD);
      fence_acc(res);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        wgmma_hot<BQ>(res, frag[kk], db + off + 2 * (2 * half + kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(res);
    }
    release_slot(&empty[slot], lane);
  }

  // the pad-row mask, out, then the maxima of each 8 doc rows (the 8
  // lanes of one lane % 4)
  const int64_t groups = rows / GROUP;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t m = m_lo + 8 * h;
    const bool live = m < rows;
    const bool pad = !live || a.doc_ids[m] < 0;
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = qc + 8 * j + e;
        float v = pad ? -CUDART_INF_F : res[4 * j + 2 * h + e];
        if (live && q < a.q_count) a.out[(int64_t)q * rows + m] = v;
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 8));
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 16));
        if (live && lane < 4 && q < a.q_count)
          a.gmax[(int64_t)q * groups + m / GROUP] = v;
      }
    }
  }
}

template <int BQ, bool SPLIT>
int launch_hot(const HotArgs& a, const void* counts, const void* counts_lo,
               int kp, cudaStream_t stream) {
  CUtensorMap map_c, map_clo;
  if (int err = encode_packed(&map_c, counts, a.q_count, kp, true, BQ))
    return err;
  if (int err = encode_packed(&map_clo, SPLIT ? counts_lo : counts,
                              a.q_count, kp, true, BQ))
    return err;
  auto kernel = ell_hot_kernel<BQ, SPLIT>;
  const size_t smem = HotShape<BQ>::smem(kp);
  if (int err = allow_smem(kernel, smem)) return err;
  const int64_t blocks = (int64_t)((a.q_count + BQ - 1) / BQ) *
                         ((a.rows + HOT_BM - 1) / HOT_BM);
  kernel<<<(unsigned)blocks, HOT_THREADS, smem, stream>>>(map_c, map_clo,
                                                          a);
  return (int)cudaGetLastError();
}

int check_scan(const ScanArgs& a) {
  const int n = a.qp * a.t_count;
  if (!a.table || a.qp <= 0 || a.t_count <= 0 || n > MAX_TABLE_ENTRIES ||
      a.cap_log2 < 4 || a.cap_log2 > 16 || (1 << a.cap_log2) < 2 * n ||
      a.tiles != (a.q_count + a.qp - 1) / a.qp || a.l_pad < 0 ||
      (a.l_pad > 0 && a.l_tile <= 0))
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

extern "C" {

const char* bm25_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The scan's lookup tables: (Q, T) ids (and optional f32 weights) ->
// ceil(Q / qp) tables of table_words(cap_log2, qp * T) int32 words.
int bm25_ell_table(const int* ids, const float* weights, int q_count,
                   int t_count, int qp, int cap_log2, int* table,
                   void* stream) {
  if (q_count <= 0) return 0;
  const TableArgs a = {ids, weights, q_count, t_count, qp, cap_log2, table};
  return launch_table(a, static_cast<cudaStream_t>(stream));
}

// B2: the tables of (Q, T) ids x (L, rows) slots -> out (Q, rows) f32.
int bm25_ell_score(const int* table, int qp, int cap_log2, int q_count,
                   int t_count, const int* tokT, const float* valT, int l_pad,
                   int rows, int l_tile, int rows_tile, int batch, float* out,
                   void* stream) {
  if (q_count <= 0 || rows <= 0) return 0;
  const ScanArgs a = {table, (q_count + qp - 1) / qp, qp, cap_log2, q_count,
                      t_count, tokT, valT, l_pad, rows, l_tile, nullptr, out,
                      nullptr, 0};
  if (int err = check_scan(a)) return err;
  return launch_scan<false>(a, rows_tile, batch,
                            static_cast<cudaStream_t>(stream));
}

// B1: B2 (the tables may carry weights) plus the pad-row mask from
// doc_ids (rows,) and gmax (Q, rows / 8), and, where h_count > 0, the hot
// tier: the hot plan's (Q, kp) bf16 counts (and their residual), tokens
// (kp,) and n_used (1,) x (H, rows) bf16 hi/lo.  l_pad may be 0 (a bucket
// with no cold postings).
int bm25_ell_score_fused(const int* table, int qp, int cap_log2,
                         int q_count, int t_count, const int* tokT,
                         const float* valT, int l_pad, int rows, int l_tile,
                         int rows_tile, int batch, const int* doc_ids,
                         const void* counts, const void* counts_lo, int kp,
                         const int* tokens, const int* n_used,
                         const void* hotT, const void* hotLo, int h_count,
                         float* out, float* gmax, void* stream) {
  if (q_count <= 0 || rows <= 0) return 0;
  if (rows % GROUP) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ScanArgs a = {table, (q_count + qp - 1) / qp, qp, cap_log2, q_count,
                      t_count, tokT, valT, l_pad, rows, l_tile, doc_ids, out,
                      gmax, 0};
  if (h_count <= 0) {
    if (int err = check_scan(a)) return err;
    return launch_scan<true>(a, rows_tile, batch, s);
  }
  if (!counts || !tokens || !n_used || !hotT || !hotLo || kp % HOT_BK ||
      kp < h_count)
    return (int)cudaErrorInvalidValue;
  if (l_pad > 0) {
    if (int err = check_scan(a)) return err;
    if (int err = launch_scan<false>(a, rows_tile, batch, s)) return err;
  }
  const HotArgs h = {l_pad > 0 ? out : nullptr,
                     static_cast<const __nv_bfloat16*>(hotT),
                     static_cast<const __nv_bfloat16*>(hotLo),
                     tokens, n_used, doc_ids, q_count, rows, out, gmax};
  const bool split = counts_lo != nullptr;
  if (q_count <= 16)
    return split ? launch_hot<16, true>(h, counts, counts_lo, kp, s)
                 : launch_hot<16, false>(h, counts, counts_lo, kp, s);
  return split ? launch_hot<128, true>(h, counts, counts_lo, kp, s)
               : launch_hot<128, false>(h, counts, counts_lo, kp, s);
}

}  // extern "C"
