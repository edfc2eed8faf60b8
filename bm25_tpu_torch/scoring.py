"""BM25 scoring math (host side, NumPy) — the semantics oracle.

Implements the score-matrix precomputation that the whole engine rests on:
every (doc, token) pair with tf > 0 gets a precomputed BM25 contribution, so
query scoring degenerates to "sum the score-matrix entries for the query's
token ids" (the reference's design: ``reference/bm25.py:111-121`` dense,
``reference/bm25_native.py:129-158`` sparse-CSC).

Supported methods mirror bm25s v0.2.12 (the library the reference's on-disk
format comes from, ``reference/animal_index_bm25/params.index.json``):

=============  ==========================================  ==============================
method         idf                                         tf saturation
=============  ==========================================  ==============================
``lucene``     ln(1 + (N-df+0.5)/(df+0.5))                 tf / (tf + k1*norm)
``robertson``  ln((N-df+0.5)/(df+0.5))                     tf(k1+1) / (tf + k1*norm)
``atire``      ln(N/df)                                    tf(k1+1) / (tf + k1*norm)
``bm25l``      ln((N+1)/(df+0.5))                          (k1+1)(c+d)/(k1+c+d), c=tf/norm
``bm25+``      ln((N+1)/df)                                tf(k1+1)/(k1*norm + tf) + d
``classic``    ln(1 + (N-df+0.5)/(df+0.5))                 tf(k1+1) / (tf + k1*norm)
=============  ==========================================  ==============================

with ``norm = 1 - b + b*dl/avgdl`` and ``d = delta``.  ``lucene`` is verified
bit-exactly against the bundled reference index (tests/test_scoring.py);
``classic`` reproduces the reference's own dense scorer
(``reference/bm25.py:96-121``).  For ``bm25l``/``bm25+`` the tf=0
score is nonzero but doc-independent; it is returned as a per-token offset
vector (bm25s's "nonoccurrence array") so sparse storage stays exact.

The port's copy of ``bm25_tpu/scoring.py`` (numpy CSC build only).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp

METHODS = ("lucene", "robertson", "atire", "bm25l", "bm25+", "classic")


@dataclass(frozen=True)
class BM25Params:
    """Scoring hyper-parameters, serialized to params.index.json.

    Defaults match the bundled reference index
    (``reference/animal_index_bm25/params.index.json``).
    """

    k1: float = 1.5
    b: float = 0.75
    delta: float = 0.5
    method: str = "lucene"
    idf_method: str | None = None  # None -> same as method

    def __post_init__(self):
        if self.method not in METHODS:
            raise ValueError(f"unknown method {self.method!r}; one of {METHODS}")
        if self.idf_method is not None and self.idf_method not in METHODS:
            raise ValueError(
                f"unknown idf_method {self.idf_method!r}; one of {METHODS}"
            )
        # out-of-range hyper-parameters don't error downstream — they
        # produce zero/negative dl_norm and silently NaN or sign-flip
        # every score, so reject them here
        if not self.k1 >= 0:
            raise ValueError(f"k1 must be >= 0, got {self.k1}")
        if not 0.0 <= self.b <= 1.0:
            raise ValueError(f"b must be in [0, 1], got {self.b}")
        if not self.delta >= 0:
            raise ValueError(f"delta must be >= 0, got {self.delta}")

    @property
    def effective_idf_method(self) -> str:
        return self.idf_method or self.method


def idf(method: str, num_docs: int, df: np.ndarray) -> np.ndarray:
    """Inverse document frequency for each term. df: int array (V,)."""
    N = float(num_docs)
    df = df.astype(np.float64)
    if method in ("lucene", "classic"):
        return np.log(1.0 + (N - df + 0.5) / (df + 0.5))
    if method == "robertson":
        return np.log(np.maximum((N - df + 0.5) / (df + 0.5), np.finfo(np.float64).tiny))
    if method == "atire":
        return np.log(N / np.maximum(df, 1.0))
    if method == "bm25l":
        return np.log((N + 1.0) / (df + 0.5))
    if method == "bm25+":
        return np.log((N + 1.0) / np.maximum(df, 1.0))
    raise ValueError(f"unknown idf method {method!r}")


def tf_saturation(
    method: str, tf: np.ndarray, dl_norm: np.ndarray, k1: float, delta: float,
    scratch_ok: bool = False,
) -> np.ndarray:
    """Length-normalized tf saturation. dl_norm = 1 - b + b*dl/avgdl per entry.

    ``scratch_ok=True`` lets the lucene branch (the bm25s default and the
    bench path) reuse ``dl_norm`` as its output buffer — at MS MARCO
    scale the three fresh 8B/entry temporaries are a measurable slice of
    build time.  Each in-place op computes the SAME primitive in the
    same order, so results stay bitwise identical (pinned by
    tests/test_scoring.py against the reference artifacts).
    """
    if method == "lucene":
        if scratch_ok and isinstance(dl_norm, np.ndarray) \
                and dl_norm.shape == tf.shape:
            np.multiply(dl_norm, k1, out=dl_norm)   # k1 * dl_norm
            np.add(dl_norm, tf, out=dl_norm)        # tf + k1 * dl_norm
            np.divide(tf, dl_norm, out=dl_norm)
            return dl_norm
        return tf / (tf + k1 * dl_norm)
    if method in ("robertson", "atire", "classic"):
        return tf * (k1 + 1.0) / (tf + k1 * dl_norm)
    if method == "bm25l":
        c = tf / dl_norm
        return (k1 + 1.0) * (c + delta) / (k1 + c + delta)
    if method == "bm25+":
        return tf * (k1 + 1.0) / (k1 * dl_norm + tf) + delta
    raise ValueError(f"unknown scoring method {method!r}")


def zero_tf_offset(method: str, k1: float, delta: float) -> float:
    """Score contribution at tf=0 (doc-independent; nonzero for bm25l/bm25+)."""
    if method == "bm25l":
        return (k1 + 1.0) * delta / (k1 + delta)
    if method == "bm25+":
        return delta
    return 0.0


@dataclass
class ScoredIndex:
    """Host-side scored inverted index (CSC over token columns).

    Layout identical to the reference's on-disk triplet
    (``reference/animal_index_bm25``): column t's postings live at
    ``indptr[t]:indptr[t+1]`` in ``indices`` (doc ids, ascending) and ``data``
    (precomputed BM25 contributions, float32).
    """

    indptr: np.ndarray  # int32/int64 (V+1,)
    indices: np.ndarray  # int32 (nnz,) doc ids
    data: np.ndarray  # float32 (nnz,)
    num_docs: int
    doc_lengths: np.ndarray  # int32 (D,)
    params: BM25Params
    vocab: dict[str, int] | None = None
    # per-token doc-independent offset added once per occurring query token
    # (bm25s "nonoccurrence" correction; all-zero except bm25l/bm25+)
    token_offsets: np.ndarray | None = None

    @property
    def vocab_size(self) -> int:
        return len(self.indptr) - 1

    @property
    def nnz(self) -> int:
        return len(self.data)

    @property
    def avgdl(self) -> float:
        return float(np.mean(self.doc_lengths)) if self.num_docs else 0.0

    def to_csc(self) -> sp.csc_matrix:
        return sp.csc_matrix(
            (self.data, self.indices, self.indptr),
            shape=(self.num_docs, self.vocab_size),
        )

    def df(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int32)


def build_scored_index(
    doc_token_ids: list[np.ndarray],
    vocab_size: int | None = None,
    params: BM25Params | None = None,
    vocab: dict[str, int] | None = None,
    dtype=np.float32,
) -> ScoredIndex:
    """Build the scored CSC index from per-doc token-id arrays.

    Vectorized equivalent of the reference's fit loop
    (``reference/bm25.py:76-121``) without the dense (docs x vocab)
    materialization.  See build_scored_index_flat for the core.
    """
    doc_lengths = np.array([len(t) for t in doc_token_ids], dtype=np.int32)
    flat_tokens = (
        np.concatenate(doc_token_ids).astype(np.int32, copy=False)
        if doc_token_ids else np.zeros(0, np.int32)
    )
    return build_scored_index_flat(
        flat_tokens, doc_lengths, vocab_size=vocab_size, params=params,
        vocab=vocab, dtype=dtype,
    )


def tf_csc_numpy(flat_tokens: np.ndarray, doc_lengths: np.ndarray,
                 vocab_size: int, dtype=np.float32):
    """The numpy CSC build: (indptr int64, doc ids int32, tf ``dtype``),
    postings ascending by doc id in each token column.  The oracle of the
    native counting sort (``NativeTextPipeline.build_tf_csc``)."""
    total = len(flat_tokens)
    num_docs = len(doc_lengths)
    flat_docs = np.repeat(np.arange(num_docs, dtype=np.int32), doc_lengths)
    order = np.argsort(flat_tokens, kind="stable")
    st = flat_tokens[order]
    sd = flat_docs[order]
    if total:
        new_run = np.empty(total, dtype=bool)
        new_run[0] = True
        np.logical_or(st[1:] != st[:-1], sd[1:] != sd[:-1], out=new_run[1:])
        run_starts = np.flatnonzero(new_run)
        run_ends = np.empty(len(run_starts), dtype=np.int64)
        run_ends[:-1] = run_starts[1:]
        run_ends[-1] = total
        # tf counts are small integers: exact in float32 (< 2^24)
        tf_vals = (run_ends - run_starts).astype(dtype)
        col_tok = st[run_starts]
        row_doc = sd[run_starts]
    else:
        tf_vals = np.zeros(0, dtype=dtype)
        col_tok = np.zeros(0, dtype=np.int32)
        row_doc = np.zeros(0, dtype=np.int32)
    indptr = np.zeros(vocab_size + 1, dtype=np.int64)
    np.cumsum(np.bincount(col_tok, minlength=vocab_size), out=indptr[1:])
    return indptr, row_doc, tf_vals


def build_scored_index_flat(
    flat_tokens: np.ndarray,
    doc_lengths: np.ndarray,
    vocab_size: int | None = None,
    params: BM25Params | None = None,
    vocab: dict[str, int] | None = None,
    dtype=np.float32,
) -> ScoredIndex:
    """Core index build from a flat token stream + per-doc lengths.

    Postings within each token column are sorted by doc id (ascending),
    which fixes a deterministic accumulation order for all downstream
    kernels.
    """
    params = params or BM25Params()
    doc_lengths = np.asarray(doc_lengths, dtype=np.int32)
    num_docs = len(doc_lengths)
    total = int(doc_lengths.sum())
    flat_tokens = np.asarray(flat_tokens)
    if len(flat_tokens) != total:
        raise ValueError(
            f"flat token stream has {len(flat_tokens)} entries, "
            f"doc lengths sum to {total}"
        )
    if vocab_size is None:
        if vocab is not None:
            vocab_size = len(vocab)
        else:
            vocab_size = int(flat_tokens.max(initial=-1)) + 1
    # Direct CSC construction (postings ascend by doc id inside each token
    # column; tf by run-length): the native C++ counting-sort builder (one
    # histogram + scatter + RLE pass, threaded on multi-core hosts —
    # native/src/csc_build.cpp).  ``tf_csc_numpy`` is its oracle, pinned
    # byte-equal in tests/test_torch_native.py, and builds the empty case;
    # the scoring transform below is shared, so scorer semantics stay
    # single-sourced.
    if flat_tokens.dtype != np.int32:
        flat_tokens = flat_tokens.astype(np.int32)
    if total:
        from bm25_tpu_torch.native import loader

        indptr, row_doc, tf_vals = loader.get().build_tf_csc(
            flat_tokens, doc_lengths, vocab_size)
        tf_vals = tf_vals.astype(dtype, copy=False)
    else:
        indptr, row_doc, tf_vals = tf_csc_numpy(
            flat_tokens, doc_lengths, vocab_size, dtype)

    df = np.diff(indptr)
    avgdl = float(doc_lengths.mean()) if num_docs else 0.0

    idf_vec = idf(params.effective_idf_method, num_docs, df)
    if avgdl > 0:
        dl_norm_per_doc = 1.0 - params.b + params.b * (
            doc_lengths.astype(np.float64) / avgdl
        )
    else:
        dl_norm_per_doc = np.full(num_docs, 1.0 - params.b)

    # Per-nnz transform: data[i] = idf[col(i)] * sat(tf[i], dl_norm[row(i)]).
    # This is the build's second-largest phase after the native counting
    # sort (measured round 4: 4.1 s of a 6 s 25M-token build before the
    # rework), so it runs in as few 8B/entry passes as possible: the
    # per-entry idf comes from ONE repeat of the f32 idf table (not an
    # int32 column-id materialization plus a fancy gather), and the
    # products reuse buffers in place.  Operation ORDER and rounding are
    # unchanged — bm25s bit-exactness is pinned by tests/test_scoring.py
    # against the reference artifacts.
    nnz = len(tf_vals)
    row_of = row_doc
    # bm25s computes the score arrays in the target dtype (float32): idf and
    # the length norm are rounded to `dtype` BEFORE the saturation/product, so
    # we do the same to stay bit-exact with the reference artifacts
    # (verified in tests/test_scoring.py against animal_index_bm25).
    sat = tf_saturation(
        params.method,
        tf_vals,
        dl_norm_per_doc.astype(dtype)[row_of],
        dtype(params.k1),
        dtype(params.delta),
        scratch_ok=True,
    )
    base = dtype(zero_tf_offset(params.method, params.k1, params.delta))
    idf_low = idf_vec.astype(dtype)
    # Sparse entries store score(tf) - score(0); score(0) goes to
    # token_offsets.  `sat` is scratch (scratch_ok above): subtract and
    # multiply land in place; values are bitwise what
    # `(idf_low[col_of] * (sat - base)).astype(dtype)` produced.
    if base != 0.0:
        np.subtract(sat, base, out=sat)
    per_entry_idf = np.repeat(idf_low, df)
    np.multiply(per_entry_idf, sat, out=sat)
    scores = sat if sat.dtype == dtype else sat.astype(dtype)
    # None (not an all-zero array) for zero-offset methods: the save/load
    # path normalizes all-zero offsets to None, and consumers gate dead
    # per-query offset work on `is not None` — a fresh build must match a
    # reloaded one
    token_offsets = (
        (idf_low * base).astype(dtype) if base != 0.0 else None
    )

    assert len(scores) == nnz
    return ScoredIndex(
        indptr=indptr.astype(np.int32) if nnz < 2**31 else indptr,
        indices=row_doc.astype(np.int32, copy=False),
        data=scores,
        num_docs=num_docs,
        doc_lengths=doc_lengths,
        params=params,
        vocab=vocab,
        token_offsets=token_offsets,
    )


def explain_score(index: ScoredIndex, tokenizer, query, doc_id: int) -> dict:
    """Per-term score breakdown for one (query, document) pair.

    Lucene-``explain``-style relevance debugging, absent from the
    reference: decomposes exactly the quantity the engines score
    (reference semantics ``reference/bm25_native.py:129-158`` —
    sum of gathered pre-scored CSC columns, plus the per-token
    nonoccurrence offset for bm25l/bm25+) into one entry per query
    term, so "why did/didn't this document rank" is answerable.

    ``query`` is a plain string or a ``{term: weight}`` mapping — the
    same surface the retrieval paths accept.  Plain-query duplicates
    aggregate into one entry with their occurrence count as the weight
    (the engines score per occurrence; the sum is identical).
    OOV/stopword-only terms appear with ``token_id=-1`` and zero
    contribution rather than being silently dropped.

    Returns ``{"doc_id", "score", "terms": [{"term", "token",
    "token_id", "weight", "df", "idf", "tf_score", "offset",
    "contribution", "matched"}, ...]}`` where ``score`` is the sum of
    contributions — equal (up to float32 accumulation order) to the
    score a search would report for this document.
    """
    if index.vocab is None:
        raise ValueError("explain needs a vocab on the index")
    doc_id = int(doc_id)
    if not 0 <= doc_id < index.num_docs:
        raise ValueError(f"doc_id {doc_id} out of range [0, {index.num_docs})")

    # (display term, token string, token id, weight) — mirrors the two
    # tokenization paths the retrieval surfaces use
    entries: list[tuple[str, str | None, int, float]] = []
    vocab = index.vocab
    if isinstance(query, dict):
        for term, wt in query.items():
            toks = tokenizer.words(str(term))
            if not toks:
                entries.append((str(term), None, -1, float(wt)))
            for w in toks:
                entries.append((str(term), w, vocab.get(w, -1), float(wt)))
    else:
        agg: dict[str, int] = {}
        for w in tokenizer.words(str(query)):
            agg[w] = agg.get(w, 0) + 1
        entries = [(w, w, vocab.get(w, -1), float(c)) for w, c in agg.items()]

    df_all = index.df()
    method = index.params.effective_idf_method
    terms = []
    total = np.float32(0.0)
    for term, token, tok_id, weight in entries:
        if tok_id >= 0:
            lo, hi = int(index.indptr[tok_id]), int(index.indptr[tok_id + 1])
            # postings are doc-id ascending (invariant pinned by tests)
            j = lo + int(np.searchsorted(index.indices[lo:hi], doc_id))
            matched = j < hi and int(index.indices[j]) == doc_id
            tf_score = float(index.data[j]) if matched else 0.0
            offset = (float(index.token_offsets[tok_id])
                      if index.token_offsets is not None else 0.0)
            df = int(df_all[tok_id])
            idf_val = float(idf(method, index.num_docs, np.asarray([df]))[0])
        else:
            matched, tf_score, offset, df, idf_val = False, 0.0, 0.0, 0, 0.0
        contribution = np.float32(weight) * np.float32(tf_score + offset)
        total = total + contribution
        terms.append({
            "term": term,
            "token": token,
            "token_id": int(tok_id),
            "weight": float(weight),
            "df": df,
            "idf": idf_val,
            "tf_score": tf_score,
            "offset": offset,
            "contribution": float(contribution),
            "matched": bool(matched),
        })
    return {"doc_id": doc_id, "score": float(total), "terms": terms}
