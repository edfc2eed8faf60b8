"""The port's native text library (``bm25_tpu_torch/native``) against NLTK,
the JAX package's native library and the port's own Python and numpy paths
(CPU).

The port builds its library from its own sources at first use; the JAX
package's tracked ``libbm25text.so`` is only loaded here, read-only, as a
second reference.  The stemmer must equal NLTK's
``SnowballStemmer("english")`` on every word the tokenizer can hand it,
ASCII or not, since the port stems queries and non-ASCII documents with it
too (the card's machine has no NLTK).
"""

import os
import random
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
from nltk.stem import SnowballStemmer

import bm25_tpu.text.tokenizer as jtok
from bm25_tpu.native.text_native import NativeTextPipeline as JaxPipeline
from bm25_tpu.text.stopwords import STOPWORDS_EN
from bm25_tpu_torch import scoring as pscoring
from bm25_tpu_torch.native import _build as native_build
from bm25_tpu_torch.native import loader
from bm25_tpu_torch.ops import _build
from bm25_tpu_torch.runtime.cache import cache_info
from bm25_tpu_torch.text import tokenizer as ptok

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SO = os.path.join(REPO, "bm25_tpu", "native", "libbm25text.so")
FIXTURE = os.path.join(REPO, "tests", "data", "english_fixture.txt")

ASCII_LETTERS = "aeiouybcdfglmnprstwxzAEIOUYBCDFGLMNRSTWXZ'"
# Latin-1 letters, Greek (final sigma too), sharp s, dotless and dotted i,
# and the three quote characters NLTK maps to an apostrophe
NON_ASCII = "àáâäçèéêëìíîïñòóôöùúûüýÿßÀÉÎÖÜΑΒΓΔΕΣαβγδεσςıİ’‘‛"
SUFFIXES = [
    "ing", "ed", "ies", "ization", "ational", "fulness", "ogi", "ively",
    "ement", "ance", "e", "l", "eedly", "sses", "'s", "ly", "li", "ion", "y",
    "at", "bl", "iz", "s", "ss", "us", "ied", "ness", "ful", "ical", "ative",
    "alize", "icate", "tional", "er", "ic", "al", "ate", "ism", "ous", "ive",
    "ize", "ment", "ent", "ant", "able", "ible", "ence", "eed", "ingly",
    "edly", "'s'", "'", "",
]
MIXED_CORPUS = [
    "The quick brown fox jumps over the lazy dog",
    "Über das schöne Café — naïve Träume! ÜBER and über again",
    "cafÉ people… enjoy coffee’s aroma; l’homme’s résumé",
    "Straße, STRASSE and straßen: Greek ΣΟΦΙΑ σοφίας, Turkish ılık İstanbul",
    "数据 检索 and retrieval of 数据 in 2024",
    "dogs, DOGS and dog's bones: the human's best friend",
    "",
    "running runner runs ran quickly quick quicker generously",
]
QUERIES = ["quick fox", "über café", "naïve résumé", "数据", "σοφίας",
           "running dogs", "zebra", ""]


@pytest.fixture(scope="module")
def native():
    return loader.get()


@pytest.fixture(scope="module")
def jax_native():
    return JaxPipeline(JAX_SO)


def fixture_lines():
    with open(FIXTURE, encoding="utf-8") as f:
        return f.read().splitlines()


def random_words(seed, n):
    """Half ASCII words, half with non-ASCII letters and apostrophes, each
    with a prefix that moves R1 and a suffix that some step strips."""
    rng = random.Random(seed)
    words = []
    for i in range(n):
        pool = ASCII_LETTERS if i % 2 == 0 else ASCII_LETTERS + NON_ASCII * 2
        base = "".join(rng.choice(pool) for _ in range(rng.randint(1, 10)))
        words.append(rng.choice(["", "gener", "commun", "arsen", "'", "’",
                                 "y", "Y"])
                     + base + rng.choice(SUFFIXES)
                     + rng.choice(["", "", "’s", "'s", "‘"]))
    return words


def test_stemmer_matches_nltk_fuzz(native):
    s = SnowballStemmer("english")
    words = random_words(0, 24000)
    assert sum(not w.isascii() for w in words) >= 10000
    diffs = [w for w in words if native.stem(w) != s.stem(w)]
    assert diffs == [], f"{len(diffs)} stem divergences, e.g. {diffs[:10]}"


def test_fixture_stems_match_nltk_exhaustive(native):
    """Every unique non-stopword surface form of the English fixture (1,602)
    stems as NLTK stems it."""
    s = SnowballStemmer("english")
    rx = re.compile(r"(?u)\b\w\w+\b")
    uniq = sorted({w for line in fixture_lines()
                   for w in rx.findall(line.lower())
                   if w not in STOPWORDS_EN})
    assert len(uniq) >= 1500
    diffs = [w for w in uniq if native.stem(w) != s.stem(w)]
    assert diffs == [], f"{len(diffs)} stem divergences, e.g. {diffs[:10]}"


@pytest.mark.parametrize("word, stem", [
    ("TYPE", "type"), ("Feline", "felin"), ("Running", "run"),
    ("Über", "über"), ("l’homme", "l'homm"), ("ΣΑΣ", "σας"),
    ("generously", "generous"), ("feline", "felin"), ("fly", "fli"),
])
def test_stem_lowercases_like_nltk(native, word, stem):
    assert native.stem(word) == SnowballStemmer("english").stem(word) == stem


CORPORA = {
    "animal": lambda a, f: a,
    "fox": lambda a, f: f,
    "fixture": lambda a, f: fixture_lines(),
    "mixed": lambda a, f: MIXED_CORPUS + a,
    "non_ascii_only": lambda a, f: [t for t in MIXED_CORPUS
                                    if not t.isascii()],
}


@pytest.mark.parametrize("name", list(CORPORA))
def test_tokenizer_matches_jax(name, animal_corpus, fox_corpus, native):
    """``Tokenizer()`` (native stemmer; C++ for ASCII documents) and
    ``Tokenizer(use_native=False)`` (NLTK) give JAX's ``Tokenizer()``'s
    vocab, ids and query tokens."""
    corpus = CORPORA[name](animal_corpus, fox_corpus)
    want = jtok.Tokenizer().tokenize_corpus(corpus)
    jq = jtok.Tokenizer().tokenize_queries(QUERIES, want.vocab)
    for tok in (ptok.Tokenizer(), ptok.Tokenizer(use_native=False)):
        got = tok.tokenize_corpus(corpus)
        assert got.vocab == want.vocab
        assert len(got.ids) == len(want.ids)
        for x, y in zip(got.ids, want.ids):
            assert x.dtype == y.dtype and np.array_equal(x, y)
        assert np.array_equal(tok.tokenize_queries(QUERIES, got.vocab), jq)
        for text in corpus[:20] + QUERIES:
            assert tok.words(text) == jtok.Tokenizer().words(text)
    if all(t.isascii() for t in corpus):
        nat = native.tokenize_corpus(corpus, stopwords=STOPWORDS_EN)
        assert nat.vocab == want.vocab
        for x, y in zip(nat.ids, want.ids):
            assert np.array_equal(x, y)


def test_tokenizer_routes_ascii_docs_through_native(monkeypatch, native):
    """ASCII documents go to the C++ tokenizer in one call; non-ASCII ones
    take the Python path with the native stemmer; ``use_native=False``
    never calls the library's tokenizer."""
    calls = []
    real = type(native).tokenize_corpus

    def spy(self, texts, **kw):
        calls.append(list(texts))
        return real(self, texts, **kw)

    monkeypatch.setattr(type(native), "tokenize_corpus", spy)
    ptok.Tokenizer().tokenize_corpus(MIXED_CORPUS)
    assert calls == [[t for t in MIXED_CORPUS if t.isascii()]]
    assert ptok.Tokenizer().words("Über") == ["über"]
    assert ptok.Tokenizer()._stem is loader.snowball_stem
    calls.clear()
    ptok.Tokenizer(use_native=False).tokenize_corpus(MIXED_CORPUS)
    assert calls == []


def test_streaming_over_mixed_chunks_equals_build_index():
    """The hybrid path's vocab iterates in id order, so streaming chunks
    that mix ASCII and non-ASCII documents remap onto the same global ids
    as one ``build_index`` over the corpus, the port's and JAX's alike."""
    from bm25_tpu.index.builder import build_index as jax_build_index
    from bm25_tpu_torch import StreamingIndexBuilder, build_index

    docs = [MIXED_CORPUS[(7 * i) % len(MIXED_CORPUS)] + f" doc{i % 13}"
            for i in range(40)]
    tc = ptok.Tokenizer().tokenize_corpus(docs)
    assert list(tc.vocab.values()) == list(range(len(tc.vocab)))
    sb = StreamingIndexBuilder()
    for i in range(0, len(docs), 9):
        sb.add(docs[i: i + 9])
    streamed = sb.finalize()[0]
    built, _ = build_index(docs)
    want, _ = jax_build_index(docs)
    for other in (built, want):
        assert streamed.vocab == other.vocab
        assert list(streamed.vocab.items()) == sorted(
            other.vocab.items(), key=lambda kv: kv[1])
        for name in ("indptr", "indices", "data", "doc_lengths"):
            x, y = getattr(streamed, name), getattr(other, name)
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), name


def csc_inputs(seed):
    rng = random.Random(seed)
    nprng = np.random.default_rng(seed)
    num_docs = rng.randint(1, 300)
    vocab = rng.randint(1, 80)
    lengths = np.maximum(0, nprng.poisson(rng.randint(1, 30), num_docs)
                         ).astype(np.int32)
    flat = nprng.integers(0, vocab, int(lengths.sum()), dtype=np.int32)
    return flat, lengths, vocab


@pytest.mark.parametrize("seed", range(4))
def test_csc_matches_jax_native_and_numpy(seed, native, jax_native,
                                          monkeypatch):
    flat, lengths, vocab = csc_inputs(seed)
    got = native.build_tf_csc(flat, lengths, vocab)
    want = jax_native.build_tf_csc(flat, lengths, vocab)
    oracle = pscoring.tf_csc_numpy(flat, lengths, vocab)
    for g, w, o in zip(got, want, oracle):
        assert g.dtype == w.dtype == o.dtype
        assert g.tobytes() == w.tobytes() == o.tobytes()
    method = pscoring.METHODS[seed % len(pscoring.METHODS)]
    kw = dict(vocab_size=vocab, params=pscoring.BM25Params(method=method))
    a = pscoring.build_scored_index_flat(flat, lengths, **kw)

    class NumpyCsc:  # the whole call again, over the numpy oracle
        def build_tf_csc(self, flat, lengths, vocab_size):
            return pscoring.tf_csc_numpy(flat, lengths, vocab_size)

    monkeypatch.setattr(loader, "get", NumpyCsc)
    b = pscoring.build_scored_index_flat(flat, lengths, **kw)
    assert (a.token_offsets is None) == (b.token_offsets is None)
    for name in ("indptr", "indices", "data", "doc_lengths",
                 "token_offsets"):
        x, y = getattr(a, name), getattr(b, name)
        if x is not None:
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), name


def test_csc_threaded_matches_numpy(native):
    """Past 2^20 tokens the counting sort runs on several threads."""
    rng = np.random.default_rng(5)
    lengths = rng.poisson(40, 40000).astype(np.int32)
    flat = rng.integers(0, 3000, int(lengths.sum()), dtype=np.int32)
    assert len(flat) > 1 << 20
    for g, o in zip(native.build_tf_csc(flat, lengths, 3000),
                    pscoring.tf_csc_numpy(flat, lengths, 3000)):
        assert g.tobytes() == o.tobytes()


def test_csc_empty_and_unit_cases(native):
    indptr, docs, tf = native.build_tf_csc(
        np.array([2, 2, 0], np.int32), np.array([3], np.int32), vocab_size=4)
    np.testing.assert_array_equal(indptr, [0, 1, 1, 2, 2])
    np.testing.assert_array_equal(docs, [0, 0])
    np.testing.assert_array_equal(tf, [1.0, 2.0])


# tests/test_native.py's error cases: (flat, lengths, vocab_size, match)
ERROR_CASES = {
    "out_of_range": (np.array([0, 5], np.int32), np.array([2], np.int32), 3,
                     "token ids"),
    "lengths_sum": (np.array([0, 1], np.int32), np.array([3], np.int32), 3,
                    "sum"),
    "wide_dtype_wraparound": (np.array([2**32 + 5], np.int64),
                              np.array([1], np.int32), 10,
                              "token ids must be in"),
    "int32_above_vocab": (np.array([3, 99], np.int32),
                          np.array([2], np.int32), 10,
                          "token ids must be in"),
    "int32_negative": (np.array([-4], np.int32), np.array([1], np.int32), 10,
                       "token ids must be in"),
    "negative_vocab": (np.zeros(0, np.int32), np.zeros(0, np.int32), -5,
                       "vocab_size"),
    "negative_length": (np.zeros(0, np.int32), np.array([2, -2], np.int32),
                        3, "non-negative"),
}


@pytest.mark.parametrize("case", list(ERROR_CASES))
def test_csc_errors_match_jax(case, native, jax_native):
    flat, lengths, vocab, match = ERROR_CASES[case]
    errors = []
    for pipe in (native, jax_native):
        with pytest.raises(ValueError, match=match) as e:
            pipe.build_tf_csc(flat, lengths, vocab_size=vocab)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_missing_or_failing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setenv(_build.BUILD_DIR_ENV, str(tmp_path / "empty"))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native_build.build()
    monkeypatch.setenv("CXX", "false")  # a compiler that always fails
    with pytest.raises(RuntimeError, match="failed"):
        native_build.build()
    assert not [n for n in os.listdir(tmp_path / "empty")
                if n.endswith(".so")]  # no half-written library left


CONCURRENT_BUILD = textwrap.dedent("""
    from bm25_tpu_torch.native import loader
    from bm25_tpu_torch.ops import _build
    with _build.collect_phases() as phases:
        p = loader.get()
    assert p.stem("Running") == "run"
    print(p.path, phases["native_build_s"] > 0)
""")


def test_concurrent_first_builds_share_one_library(tmp_path):
    """Two processes building into one empty build directory at once: one
    compiles (under the library's lock), both load the same library."""
    build = tmp_path / "build"
    env = {**os.environ, _build.BUILD_DIR_ENV: str(build),
           "PYTHONPATH": REPO}
    procs = [subprocess.Popen([sys.executable, "-c", CONCURRENT_BUILD],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    paths = {o.split()[0] for o, _ in outs}
    compiled = [o.split()[1] == "True" for o, _ in outs]
    assert len(paths) == 1 and sum(compiled) == 1
    path = paths.pop()
    assert os.path.dirname(path) == str(build)
    name = os.path.basename(path)
    assert sorted(os.listdir(build)) == [name, name + ".lock"]
    assert cache_info(str(build))["entries"] == 1  # the lock is no entry
