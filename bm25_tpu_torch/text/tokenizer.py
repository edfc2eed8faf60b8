"""Corpus/query tokenization: lowercase -> regex split -> stopwords -> stem.

Reproduces the observable pipeline of the reference index builder
(``reference/bm25_test.py:16``: ``bm25s.tokenize(corpus,
stopwords="en", stemmer=Stemmer.Stemmer("english"))``):

* lowercase,
* split with the word pattern ``(?u)\\b\\w\\w+\\b`` (tokens of >= 2 word
  characters, so "a" and the "s" left over from "human's" are dropped),
* remove stopwords,
* Snowball-English stemming ("feline"->"felin", "fly"->"fli", ...).

Parity with the bundled ``animal_index_bm25`` artifacts is asserted in
``tests/test_text.py``.

Padding/OOV contract (unifying the reference's two conventions): padded query
matrices use ``-1`` for both padding and out-of-vocabulary terms, and scoring
treats negative ids as zero-contribution (``reference/bm25_native.py:151``
drops negative ids; we deliberately do NOT replicate the OOV->id-0 bug of
``reference/main.py:247``).

The port's copy of ``bm25_tpu/text/tokenizer.py``.  With ``use_native``
(the default) the ``"snowball-en"`` stemmer is the port's own C++ Snowball
stemmer (``bm25_tpu_torch/native``), for queries and every document, and
a corpus of ASCII documents tokenizes in C++; non-ASCII documents take the
Python path below, with one shared vocab.  With ``use_native=False`` the
stemmer is NLTK's ``SnowballStemmer("english")``, the Python oracle, and
every document takes the Python path.  Both give the same tokens wherever
both run (``tests/test_torch_native.py`` holds the native stemmer equal to
NLTK on ASCII and non-ASCII words), so a machine without ``nltk`` builds
and queries the indexes of one with it.  The native library builds at
first use and raises where it cannot.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Callable, Iterable, Sequence

import numpy as np

from .stopwords import get_stopwords

TOKEN_PATTERN = r"(?u)\b\w\w+\b"

# bm25s appends an empty-string token to the saved vocabulary as the padding
# symbol (see ``reference/animal_index_bm25/vocab.index.json`` entry
# ``"": 20``).  We keep that on-disk convention for interop but map it to
# PAD_ID in memory.
PAD_TOKEN = ""
PAD_ID = -1

# Lucene-style boost suffix: any float() literal after '^' (including
# '.5' / '2.' — float accepts both, so the parser must too)
_BOOST_RE = re.compile(
    r"^(.+)\^([+-]?(?:\d+(?:\.\d*)?|\.\d+)(?:[eE][+-]?\d+)?)$"
)


SNOWBALL_NAMES = ("snowball", "snowball-en", "english", "porter2")


def _make_stemmer(spec, use_native: bool = True
                  ) -> Callable[[str], str] | None:
    if spec is None:
        return None
    if callable(spec):
        return spec
    if isinstance(spec, str):
        name = spec.lower()
        if name in SNOWBALL_NAMES and use_native:
            from bm25_tpu_torch.native import loader

            loader.get()  # build and load now: a failure raises here
            return loader.snowball_stem
        if name in SNOWBALL_NAMES:
            try:
                from nltk.stem import SnowballStemmer
            except ImportError as e:
                raise RuntimeError(
                    "nltk is required for the Python Snowball stemmer "
                    "(use_native=False)"
                ) from e
            return SnowballStemmer("english").stem
        raise ValueError(f"Unknown stemmer spec {spec!r}")
    raise TypeError(f"stemmer must be None, str or callable, got {type(spec)}")


@dataclass
class TokenizedCorpus:
    """Token-id representation of a corpus.

    Attributes:
        ids: one int32 array of token ids per document (duplicates preserved —
            term frequency is derived downstream).
        vocab: term -> id mapping (contiguous ids ``0..len(vocab)-1``).
    """

    ids: list[np.ndarray]
    vocab: dict[str, int]

    @property
    def num_docs(self) -> int:
        return len(self.ids)

    @property
    def doc_lengths(self) -> np.ndarray:
        return np.array([len(x) for x in self.ids], dtype=np.int32)


@dataclass
class Tokenizer:
    """Configurable text -> token-id pipeline (host side)."""

    stopwords: object = "en"
    stemmer: object = "snowball-en"
    token_pattern: str = TOKEN_PATTERN
    lower: bool = True
    use_native: bool = True

    _stop: frozenset = field(init=False, repr=False)
    _stem: Callable[[str], str] | None = field(init=False, repr=False)
    _regex: re.Pattern = field(init=False, repr=False)
    _stem_cache: dict = field(init=False, repr=False, default_factory=dict)

    def __post_init__(self):
        self._stop = get_stopwords(self.stopwords)
        self._stem = _make_stemmer(self.stemmer, self.use_native)
        self._regex = re.compile(self.token_pattern)
        self._stem_cache = {}

    # -- persistence ---------------------------------------------------------

    def config(self) -> dict | None:
        """JSON-serializable construction config, or None when a component
        is a custom callable (not persistable).  Saved next to an index so
        ``Retriever.load`` reconstructs the SAME pipeline — a mismatched
        query tokenizer silently misses the stemmed/filtered vocab.
        """
        sw = self.stopwords
        if isinstance(sw, (set, frozenset, tuple)):
            sw = sorted(sw)
        elif not (sw is None or isinstance(sw, (str, list))):
            return None
        if not (self.stemmer is None or isinstance(self.stemmer, str)):
            return None
        return {
            "stopwords": sw,
            "stemmer": self.stemmer,
            "token_pattern": self.token_pattern,
            "lower": self.lower,
        }

    @classmethod
    def from_config(cls, cfg: dict) -> "Tokenizer":
        sw = cfg.get("stopwords", "en")
        if isinstance(sw, list):
            sw = frozenset(sw)
        return cls(
            stopwords=sw,
            stemmer=cfg.get("stemmer", "snowball-en"),
            token_pattern=cfg.get("token_pattern", TOKEN_PATTERN),
            lower=bool(cfg.get("lower", True)),
        )

    # -- low level ---------------------------------------------------------

    def words(self, text: str) -> list[str]:
        """Split one text into stemmed, stopword-filtered surface words."""
        if self.lower:
            text = text.lower()
        out = []
        stop = self._stop
        stem = self._stem
        cache = self._stem_cache
        for w in self._regex.findall(text):
            if w in stop:
                continue
            if stem is not None:
                s = cache.get(w)
                if s is None:
                    s = stem(w)
                    cache[w] = s
                w = s
            out.append(w)
        return out

    # -- corpus ------------------------------------------------------------

    def tokenize_corpus(
        self, texts: Sequence[str], vocab: dict[str, int] | None = None
    ) -> TokenizedCorpus:
        """Tokenize a corpus, building (or extending from scratch) a vocab.

        New terms get ids in first-occurrence order, matching the id-assignment
        style visible in ``reference/animal_index_bm25/vocab.index.json``.
        """
        if self.use_native and vocab is None and self._is_native_compatible():
            from bm25_tpu_torch.native import loader

            native = loader.get()
            # The native pipeline matches the Python path byte-for-byte on
            # ASCII only: its word classes and case folding do not handle
            # non-ASCII (unicode punctuation would glue tokens, and 'Über'
            # would never fold to the query path's 'über').  Route
            # non-ASCII documents through the Python path, sharing one
            # vocab, so corpus and query tokenization always agree.
            # one isascii() pass (it walks every byte of every doc)
            non_ascii, ascii_idx = [], []
            for i, t in enumerate(texts):
                (ascii_idx if t.isascii() else non_ascii).append(i)
            if not non_ascii:
                return native.tokenize_corpus(texts, stopwords=self._stop)
            tc = native.tokenize_corpus(
                [texts[i] for i in ascii_idx], stopwords=self._stop
            )
            vocab = tc.vocab
            ids: list[np.ndarray] = [None] * len(texts)  # type: ignore[list-item]
            for pos, i in enumerate(ascii_idx):
                ids[i] = tc.ids[pos]
            for i in non_ascii:
                ids[i] = self._encode_doc(texts[i], vocab)
            return _remap_first_occurrence(ids, vocab)

        if vocab is None:
            vocab = {}
        return TokenizedCorpus(
            ids=[self._encode_doc(text, vocab) for text in texts], vocab=vocab
        )

    def _encode_doc(self, text: str, vocab: dict[str, int]) -> np.ndarray:
        """Encode one document's words to ids, extending ``vocab`` in place."""
        ws = self.words(text)
        doc = np.empty(len(ws), dtype=np.int32)
        for j, w in enumerate(ws):
            tid = vocab.get(w)
            if tid is None:
                tid = len(vocab)
                vocab[w] = tid
            doc[j] = tid
        return doc

    def _is_native_compatible(self) -> bool:
        return (
            self.lower
            and self.token_pattern == TOKEN_PATTERN
            and isinstance(self.stemmer, str)
            and self.stemmer.lower() in SNOWBALL_NAMES
        )

    # -- queries -----------------------------------------------------------

    def tokenize_queries(
        self,
        texts: Sequence[str],
        vocab: dict[str, int],
        pad_to: int | None = None,
    ) -> np.ndarray:
        """Tokenize queries against a fixed vocab into a padded int32 matrix.

        Returns shape ``(Q, T)`` with PAD_ID (-1) padding; OOV terms are also
        PAD_ID (they contribute zero to scores).
        """
        rows = []
        for text in texts:
            ws = self.words(text)
            row = [vocab[w] for w in ws if w in vocab]
            rows.append(row)
        width = max((len(r) for r in rows), default=0)
        if pad_to is not None:
            if width > pad_to:
                raise ValueError(
                    f"query has {width} tokens, more than pad_to={pad_to}"
                )
            width = pad_to
        width = max(width, 1)
        out = np.full((len(rows), width), PAD_ID, dtype=np.int32)
        for i, row in enumerate(rows):
            out[i, : len(row)] = row
        return out

    @staticmethod
    def parse_boosted(text: str):
        """Parse ``term^weight`` boost syntax: ``"fish^2.5 cat"`` ->
        ``{"fish": 2.5, "cat": 1.0}``; returns None when the query has no
        boosts (callers keep the plain fast path).  Repeated terms
        accumulate their weights (per-occurrence semantics).  Signed and
        scientific weights parse (``fish^-2``, ``fish^1e2`` — negative
        weights reach the engine, which rejects them only where unsound);
        a ``^`` whose suffix is not numeric stays part of the literal
        term."""
        parts = text.split()
        if not any("^" in p for p in parts):
            return None
        boost = _BOOST_RE
        out: dict[str, float] = {}
        for p in parts:
            m = boost.match(p)
            term, wt = (m.group(1), float(m.group(2))) if m else (p, 1.0)
            out[term] = out.get(term, 0.0) + wt
        return out

    def tokenize_weighted_queries(
        self,
        queries: Sequence,
        vocab: dict[str, int],
        pad_to: int | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Tokenize mixed plain/weighted queries -> (ids, weights) matrices.

        Each query is either a plain string (every token weight 1.0, one
        entry per occurrence — identical to ``tokenize_queries`` semantics)
        or a ``{term: weight}`` mapping; terms run through the same
        normalize/stem pipeline, multi-word terms contribute each of their
        tokens at the term's weight.  Pad slots carry weight 0.
        """
        rows: list[list[tuple[int, float]]] = []
        for q in queries:
            if isinstance(q, dict):
                row = []
                for term, wt in q.items():
                    wt = float(wt)
                    row.extend(
                        (vocab[w], wt)
                        for w in self.words(str(term))
                        if w in vocab
                    )
            else:
                row = [(vocab[w], 1.0) for w in self.words(q) if w in vocab]
            rows.append(row)
        width = max((len(r) for r in rows), default=0)
        if pad_to is not None:
            if width > pad_to:
                raise ValueError(
                    f"query has {width} tokens, more than pad_to={pad_to}"
                )
            width = pad_to
        width = max(width, 1)
        ids = np.full((len(rows), width), PAD_ID, dtype=np.int32)
        wts = np.zeros((len(rows), width), dtype=np.float32)
        for i, row in enumerate(rows):
            for j, (tid, wt) in enumerate(row):
                ids[i, j] = tid
                wts[i, j] = wt
        return ids, wts


def _remap_first_occurrence(
    ids: list[np.ndarray], vocab: dict[str, int]
) -> TokenizedCorpus:
    """Renumber vocab ids to first-occurrence order over the corpus.

    The hybrid native/Python path assigns all ASCII docs' terms before any
    non-ASCII doc's; this restores the documented contract (ids in
    first-occurrence order) so saved vocab artifacts stay reproducible
    regardless of which docs took the native path.  The vocab dict is
    rebuilt in the new id order too: ``index/merge.py::remap_vocab``
    (streaming chunks, worker shards) assigns global ids in the dict's
    iteration order.
    """
    flat = np.concatenate(ids) if ids else np.zeros(0, np.int32)
    if not len(flat):
        return TokenizedCorpus(ids=ids, vocab=vocab)
    uniq, first = np.unique(flat, return_index=True)
    order = uniq[np.argsort(first, kind="stable")]
    old_to_new = np.empty(len(vocab), dtype=np.int32)
    old_to_new[order] = np.arange(len(order), dtype=np.int32)
    new_ids = [old_to_new[doc] if len(doc) else doc for doc in ids]
    terms = np.empty(len(vocab), dtype=object)
    for term, tid in vocab.items():
        terms[old_to_new[tid]] = term
    new_vocab = {term: i for i, term in enumerate(terms.tolist())}
    return TokenizedCorpus(ids=new_ids, vocab=new_vocab)


def pad_token_lists(rows: Iterable[Sequence[int]], pad_to: int | None = None) -> np.ndarray:
    """Pad variable-length token-id lists to a (Q, T) int32 matrix with -1.

    ``pad_to`` is a hard width like in ``tokenize_queries``: a longer row
    raises (a silent wider-than-requested matrix would shape-mismatch a
    kernel compiled for T=pad_to).
    """
    rows = [list(r) for r in rows]
    width = max((len(r) for r in rows), default=0)
    if pad_to is not None:
        if width > pad_to:
            raise ValueError(
                f"row has {width} tokens, more than pad_to={pad_to}"
            )
        width = pad_to
    width = max(width, 1)
    out = np.full((len(rows), width), PAD_ID, dtype=np.int32)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out
