// Native CSC index construction: flat doc-major token stream -> CSC (by
// token column) with per-(doc, token) term frequencies.
//
// Replaces the numpy radix argsort + fancy-gather + run-length pipeline of
// bm25_tpu_torch/scoring.py::build_scored_index_flat with a stable counting sort
// (one histogram pass + one scatter pass + one RLE pass), parallelized over
// input/column ranges when more than one hardware thread is available.
// Output contract is identical: postings within each token column are
// ordered by ascending doc id (the input stream is doc-major and the sort
// is stable), and tf counts are exact.  The BM25 scoring transform stays in
// Python so the scorer semantics remain single-sourced.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <new>
#include <thread>
#include <vector>

namespace {

struct CscHandle {
  std::vector<int64_t> indptr;   // V+1 (over RLE'd postings)
  std::vector<int32_t> docs;     // nnz doc ids, ascending per column
  std::vector<float> tf;         // nnz term frequencies
};

inline int pick_threads(int64_t n, int64_t v) {
  unsigned hw = std::thread::hardware_concurrency();
  if (hw <= 1 || n < (1 << 20)) return 1;
  int t = static_cast<int>(std::min<unsigned>(hw, 16));
  t = static_cast<int>(std::min<int64_t>(t, n / (1 << 19)));
  // per-thread histograms cost v * 8 bytes each: cap total at ~512 MB so
  // multi-million-term vocabularies don't blow host memory
  int64_t hist_cap = std::max<int64_t>((512ll << 20) / (v * 8 + 1), 1);
  return static_cast<int>(std::max<int64_t>(
      1, std::min<int64_t>(t, hist_cap)));
}

template <typename F>
void run_parallel(int threads, F&& body) {
  if (threads <= 1) {
    body(0);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(threads);
  for (int t = 0; t < threads; ++t) pool.emplace_back(body, t);
  for (auto& th : pool) th.join();
}

// diagnostic for the Python wrapper: why the last bm25_build_csc returned
// null (0 = ok, 1 = token id out of [0, v), 2 = allocation failure).
// Builds are heavyweight host calls; concurrent builders could race this,
// in which case the wrapper's fallback classification still applies.
std::atomic<int> g_csc_last_error{0};

}  // namespace

extern "C" {

int bm25_csc_last_error() { return g_csc_last_error.load(); }

// flat: n token ids (doc-major); lengths: d per-doc token counts summing to
// n; v: vocab size (all ids in [0, v)).  Returns a CscHandle* or null
// (bm25_csc_last_error() tells why).  Exceptions (std::bad_alloc from the
// large vectors, std::system_error from thread creation) must never cross
// the extern "C"/ctypes boundary — that is UB and in practice aborts the
// whole Python process — so the body is wrapped.
void* bm25_build_csc(const int32_t* flat, int64_t n, const int32_t* lengths,
                     int64_t d, int64_t v) {
  g_csc_last_error.store(0);
  if (n < 0 || d < 0 || v < 0) return nullptr;
  CscHandle* h = nullptr;
  try {
    h = new CscHandle();

  // doc boundaries (prefix sums of lengths)
  std::vector<int64_t> doc_end(static_cast<size_t>(d) + 1, 0);
  for (int64_t i = 0; i < d; ++i) doc_end[i + 1] = doc_end[i] + lengths[i];

  const int threads = pick_threads(n, v);
  const int64_t chunk = threads ? (n + threads - 1) / threads : 0;

  // phase 1: per-thread token histograms, bounds-checking every id (the
  // scatter phase trusts its inputs; an out-of-range id would corrupt
  // memory).  The branch rides the same pass that already reads each id.
  std::atomic<bool> bad_id{false};
  std::vector<std::vector<int64_t>> hist(
      threads, std::vector<int64_t>(static_cast<size_t>(v), 0));
  run_parallel(threads, [&](int t) {
    const int64_t lo = t * chunk, hi = std::min<int64_t>(n, lo + chunk);
    auto& hh = hist[t];
    for (int64_t i = lo; i < hi; ++i) {
      const uint32_t id = static_cast<uint32_t>(flat[i]);
      if (id >= static_cast<uint64_t>(v)) {
        bad_id.store(true, std::memory_order_relaxed);
        return;
      }
      hh[id]++;
    }
  });
  if (bad_id.load()) {
    delete h;
    g_csc_last_error.store(1);
    return nullptr;
  }

  // phase 2: column starts (occurrence-level) + per-thread write offsets
  std::vector<int64_t> occ_start(static_cast<size_t>(v) + 1, 0);
  {
    int64_t acc = 0;
    for (int64_t tok = 0; tok < v; ++tok) {
      occ_start[tok] = acc;
      for (int t = 0; t < threads; ++t) {
        int64_t c = hist[t][tok];
        hist[t][tok] = acc;  // becomes this thread's write cursor
        acc += c;
      }
    }
    occ_start[v] = acc;
  }

  // phase 3: stable scatter of doc ids into occurrence-sorted order
  std::vector<int32_t> occ_docs(static_cast<size_t>(n));
  run_parallel(threads, [&](int t) {
    const int64_t lo = t * chunk, hi = std::min<int64_t>(n, lo + chunk);
    if (lo >= hi) return;
    // current doc for position lo
    int64_t doc = std::upper_bound(doc_end.begin(), doc_end.end(), lo) -
                  doc_end.begin() - 1;
    auto& cursor = hist[t];
    for (int64_t i = lo; i < hi; ++i) {
      while (i >= doc_end[doc + 1]) ++doc;
      occ_docs[cursor[flat[i]]++] = static_cast<int32_t>(doc);
    }
  });

  // phase 4: RLE per column (docs ascend within a column) -> counts
  const int col_threads = threads;
  const int64_t col_chunk =
      col_threads ? (v + col_threads - 1) / col_threads : 0;
  std::vector<int64_t> runs_per_thread(col_threads, 0);
  run_parallel(col_threads, [&](int t) {
    const int64_t clo = t * col_chunk, chi = std::min<int64_t>(v, clo + col_chunk);
    int64_t runs = 0;
    for (int64_t tok = clo; tok < chi; ++tok) {
      int32_t prev = -1;
      for (int64_t i = occ_start[tok]; i < occ_start[tok + 1]; ++i) {
        runs += (occ_docs[i] != prev);
        prev = occ_docs[i];
      }
    }
    runs_per_thread[t] = runs;
  });
  int64_t nnz = 0;
  std::vector<int64_t> run_base(col_threads, 0);
  for (int t = 0; t < col_threads; ++t) {
    run_base[t] = nnz;
    nnz += runs_per_thread[t];
  }

  h->indptr.assign(static_cast<size_t>(v) + 1, 0);
  h->docs.resize(static_cast<size_t>(nnz));
  h->tf.resize(static_cast<size_t>(nnz));
  run_parallel(col_threads, [&](int t) {
    const int64_t clo = t * col_chunk, chi = std::min<int64_t>(v, clo + col_chunk);
    int64_t w = run_base[t];
    for (int64_t tok = clo; tok < chi; ++tok) {
      h->indptr[tok] = w;
      int64_t i = occ_start[tok];
      const int64_t end = occ_start[tok + 1];
      while (i < end) {
        const int32_t doc = occ_docs[i];
        int64_t j = i + 1;
        while (j < end && occ_docs[j] == doc) ++j;
        h->docs[w] = doc;
        h->tf[w] = static_cast<float>(j - i);  // < 2^24: exact in f32
        ++w;
        i = j;
      }
    }
  });
  // every thread wrote indptr for its own columns (first column = its
  // run_base); only the terminal entry remains
  h->indptr[v] = nnz;
  return h;
  } catch (...) {
    delete h;
    g_csc_last_error.store(2);
    return nullptr;
  }
}

int64_t csc_nnz(void* hp) { return static_cast<CscHandle*>(hp)->docs.size(); }

void csc_copy_indptr(void* hp, int64_t* out) {
  auto* h = static_cast<CscHandle*>(hp);
  std::memcpy(out, h->indptr.data(), h->indptr.size() * sizeof(int64_t));
}

void csc_copy_indices(void* hp, int32_t* out) {
  auto* h = static_cast<CscHandle*>(hp);
  std::memcpy(out, h->docs.data(), h->docs.size() * sizeof(int32_t));
}

void csc_copy_tf(void* hp, float* out) {
  auto* h = static_cast<CscHandle*>(hp);
  std::memcpy(out, h->tf.data(), h->tf.size() * sizeof(float));
}

void csc_free(void* hp) { delete static_cast<CscHandle*>(hp); }

}  // extern "C"
