"""The port's host layer against its originals in the JAX package (CPU).

``bm25_tpu_torch`` keeps its own copy of each JAX-free module of
``bm25_tpu`` it uses (tokenizer, scoring maths, index build and bm25s I/O,
the oracle, ``Retriever``, the eval helpers, the benchmark's corpus).  The
same inputs, made from a seed with numpy, go through both packages, and
the results must be equal: arrays bit for bit, tokens and vocabularies
identical, errors with the same message.  Objects stay duck-typed across
the two packages, both ways.
"""

import os

import numpy as np
import pytest

import bm25_tpu.bench.query_bench as jbench
import bm25_tpu.eval as jeval
import bm25_tpu.index.builder as jbuilder
import bm25_tpu.index.io as jio
import bm25_tpu.index.merge as jmerge
import bm25_tpu.reference as jref
import bm25_tpu.retriever as jretriever
import bm25_tpu.scoring as jscoring
import bm25_tpu.text.stopwords as jstop
import bm25_tpu.text.tokenizer as jtok
import bm25_tpu.utils.padding as jpad
import bm25_tpu.utils.validate as jval
import bm25_tpu_torch.bench.query_bench as pbench
import bm25_tpu_torch.eval as peval
import bm25_tpu_torch.index.builder as pbuilder
import bm25_tpu_torch.index.io as pio
import bm25_tpu_torch.index.merge as pmerge
import bm25_tpu_torch.reference as pref
import bm25_tpu_torch.retriever as pretriever
import bm25_tpu_torch.scoring as pscoring
import bm25_tpu_torch.text.stopwords as pstop
import bm25_tpu_torch.text.tokenizer as ptok
import bm25_tpu_torch.utils.padding as ppad
import bm25_tpu_torch.utils.validate as pval
from bm25_tpu_torch import DenseEngine, Session, SparseEngine, create_engine
from bm25_tpu_torch.utils.parity import assert_matches_oracle

CPU = Session("cpu")

# ASCII and non-ASCII documents, punctuation, case, stopwords, repeats
CORPUS = [
    "The quick brown fox jumps over the lazy dog",
    "A cat is a feline and likes to purr; cats purr loudly.",
    "Über café naïve résumé — Straße, ÜBER and über again",
    "dogs, DOGS and dog's bones: the human's best friend",
    "数据 检索 and retrieval of 数据 in 2024",
    "fish swim in water; a fish is a creature that lives in water",
    "",
    "running runner runs ran quickly quick quicker",
]
QUERIES = ["quick fox", "über café", "purring cats", "数据", "zebra", "",
           "dog dog friend"]
TOKENIZERS = {
    "snowball": {},
    "no_stem": {"stemmer": None},
    "lucene_stop": {"stopwords": "lucene", "stemmer": None},
    "no_stop_upper": {"stopwords": None, "stemmer": None, "lower": False},
}


def fields_equal(a, b):
    """Two ScoredIndexes equal field for field, arrays bit for bit."""
    for name in ("indptr", "indices", "data", "doc_lengths"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    assert (a.token_offsets is None) == (b.token_offsets is None)
    if a.token_offsets is not None:
        assert a.token_offsets.dtype == b.token_offsets.dtype
        assert np.array_equal(a.token_offsets, b.token_offsets)
    assert a.num_docs == b.num_docs and a.vocab == b.vocab
    assert a.params.__dict__ == b.params.__dict__


def zipf_docs(seed, n=120, vocab=300):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, vocab + 1)
    p /= p.sum()
    return [rng.choice(vocab, size=rng.integers(0, 40), p=p).astype(np.int32)
            for _ in range(n)]


@pytest.mark.parametrize("ascii_only", [False, True])
@pytest.mark.parametrize("name", list(TOKENIZERS))
def test_tokenizer_tokens_and_vocab(name, ascii_only):
    kw = TOKENIZERS[name]
    jt, pt = jtok.Tokenizer(**kw), ptok.Tokenizer(**kw)
    # the JAX package routes an ASCII corpus through its native tokenizer
    # where that library is built, and a mixed one partly
    corpus = [t for t in CORPUS if t.isascii()] if ascii_only else CORPUS
    jc, pc = jt.tokenize_corpus(corpus), pt.tokenize_corpus(corpus)
    assert jc.vocab == pc.vocab
    assert len(jc.ids) == len(pc.ids)
    for x, y in zip(jc.ids, pc.ids):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert np.array_equal(jc.doc_lengths, pc.doc_lengths)
    for text in CORPUS + QUERIES:
        assert jt.words(text) == pt.words(text)
    assert np.array_equal(jt.tokenize_queries(QUERIES, jc.vocab),
                          pt.tokenize_queries(QUERIES, pc.vocab))
    weighted = QUERIES + [{"quick fox": 2.5, "über": -1.0}, {"zebra": 3}]
    for x, y in zip(
            jt.tokenize_weighted_queries(weighted, jc.vocab, pad_to=9),
            pt.tokenize_weighted_queries(weighted, pc.vocab, pad_to=9)):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert jt.config() == pt.config()
    if jt.config() is not None:
        assert ptok.Tokenizer.from_config(jt.config()).config() == jt.config()


@pytest.mark.parametrize("text", ["fish^2.5 cat", "fish^-2 fish^1e2 a^b",
                                  "no boost", "x^.5 y^2."])
def test_parse_boosted_and_padding(text):
    assert jtok.Tokenizer.parse_boosted(text) == \
        ptok.Tokenizer.parse_boosted(text)
    rows = [[1, 2, 3], [], [4]]
    assert np.array_equal(jtok.pad_token_lists(rows, 5),
                          ptok.pad_token_lists(rows, 5))
    with pytest.raises(ValueError) as je:
        jtok.pad_token_lists(rows, 2)
    with pytest.raises(ValueError) as pe:
        ptok.pad_token_lists(rows, 2)
    assert str(je.value) == str(pe.value)


def test_stopwords_and_padding_helpers():
    for spec in ("en", "english", "lucene", None, ["The", "A"]):
        assert jstop.get_stopwords(spec) == pstop.get_stopwords(spec)
    with pytest.raises(ValueError) as je:
        jstop.get_stopwords("klingon")
    with pytest.raises(ValueError) as pe:
        pstop.get_stopwords("klingon")
    assert str(je.value) == str(pe.value)
    for x in range(-3, 70):
        for m in (1, 8, 128):
            assert jpad.next_multiple(x, m) == ppad.next_multiple(x, m)
            assert jpad.cdiv(x, m) == ppad.cdiv(x, m)
        assert jpad.next_pow2_at_least(x) == ppad.next_pow2_at_least(x)


@pytest.mark.parametrize("method", jscoring.METHODS)
def test_build_scored_index_bit_equal(method):
    docs = zipf_docs(jscoring.METHODS.index(method))
    for params in (jscoring.BM25Params(method=method),
                   jscoring.BM25Params(k1=0.9, b=0.4, delta=1.0, method=method,
                                       idf_method="atire")):
        pp = pscoring.BM25Params(**params.__dict__)
        fields_equal(jscoring.build_scored_index(docs, 300, params),
                     pscoring.build_scored_index(docs, 300, pp))
        lengths = np.array([len(d) for d in docs], np.int32)
        flat = np.concatenate(docs)
        fields_equal(
            jscoring.build_scored_index_flat(flat, lengths, params=params),
            pscoring.build_scored_index_flat(flat, lengths, params=pp))


@pytest.mark.parametrize("method", ["lucene", "bm25+"])
def test_build_index_from_texts_bit_equal(method):
    tok = {"stemmer": None}
    ji, js = jbuilder.build_index(CORPUS, jscoring.BM25Params(method=method),
                                  jtok.Tokenizer(**tok))
    pi, ps = pbuilder.build_index(CORPUS, pscoring.BM25Params(method=method),
                                  ptok.Tokenizer(**tok))
    fields_equal(ji, pi)
    assert (js.num_docs, js.vocab_size, js.nnz) == \
        (ps.num_docs, ps.vocab_size, ps.nnz)


def test_scoring_edge_cases_and_explain():
    empty_j = jscoring.build_scored_index([], vocab_size=4)
    empty_p = pscoring.build_scored_index([], vocab_size=4)
    fields_equal(empty_j, empty_p)
    for bad in ({"k1": -1.0}, {"b": 1.5}, {"method": "nope"}):
        with pytest.raises(ValueError) as je:
            jscoring.BM25Params(**bad)
        with pytest.raises(ValueError) as pe:
            pscoring.BM25Params(**bad)
        assert str(je.value) == str(pe.value)
    tk = {"stemmer": None}
    ji, _ = jbuilder.build_index(CORPUS, jscoring.BM25Params(method="bm25l"),
                                 jtok.Tokenizer(**tk))
    pi, _ = pbuilder.build_index(CORPUS, pscoring.BM25Params(method="bm25l"),
                                 ptok.Tokenizer(**tk))
    for q in ("quick fox fox", {"über": 2.0, "zebra": 1.0}):
        for doc in (0, 2, 7):
            assert jscoring.explain_score(ji, jtok.Tokenizer(**tk), q, doc) \
                == pscoring.explain_score(pi, ptok.Tokenizer(**tk), q, doc)


def test_merge_shard_indexes_bit_equal():
    tok = {"stemmer": None}
    shards_j = [jtok.Tokenizer(**tok).tokenize_corpus(CORPUS[i::3])
                for i in range(3)]
    shards_p = [ptok.Tokenizer(**tok).tokenize_corpus(CORPUS[i::3])
                for i in range(3)]
    fields_equal(jmerge.merge_shard_indexes(shards_j),
                 pmerge.merge_shard_indexes(shards_p))


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("mmap", [False, True])
def test_save_load_round_trip_across_packages(tmp_path, writer, mmap):
    tok = {"stemmer": None}
    idx, _ = pbuilder.build_index(CORPUS, pscoring.BM25Params(method="bm25+"),
                                  ptok.Tokenizer(**tok))
    save = jio.save_index if writer == "jax" else pio.save_index
    save(tmp_path, idx, corpus=CORPUS)
    (jio if writer == "jax" else pio).save_tokenizer_config(
        tmp_path, ptok.Tokenizer(**tok))
    loaded_j = jio.load_index(tmp_path, mmap=mmap)
    loaded_p = pio.load_index(tmp_path, mmap=mmap)
    fields_equal(loaded_j, loaded_p)
    assert np.array_equal(loaded_p.data, idx.data) and \
        loaded_p.vocab == idx.vocab
    # the other package writes the same files, byte for byte
    other = tmp_path / "other"
    (pio.save_index if writer == "jax" else jio.save_index)(
        other, loaded_p, corpus=CORPUS)
    for name in sorted(os.listdir(other)):
        assert (other / name).read_bytes() == (tmp_path / name).read_bytes(), \
            name
    assert pio.load_tokenizer_config(tmp_path).config() == \
        jio.load_tokenizer_config(tmp_path).config()
    jc, pc = jio.MMapCorpus.open(tmp_path), pio.MMapCorpus.open(tmp_path)
    assert len(jc) == len(pc) and jc.batch([0, 2, 7]) == pc.batch([0, 2, 7])
    jc.close()
    pc.close()


def test_load_bundled_reference_index(reference_index_dir):
    fields_equal(jio.load_index(reference_index_dir),
                 pio.load_index(reference_index_dir))


@pytest.mark.parametrize("method", ["lucene", "robertson", "bm25+"])
def test_reference_engine_bit_equal(method):
    rng = np.random.default_rng(3)
    docs = zipf_docs(7)
    pidx = pscoring.build_scored_index(docs, 300,
                                       pscoring.BM25Params(method=method))
    jidx = jscoring.build_scored_index(docs, 300,
                                       jscoring.BM25Params(method=method))
    q = rng.integers(-1, 300, (9, 6)).astype(np.int32)
    q[0] = -1
    w = rng.uniform(0.1, 3.0, q.shape).astype(np.float32)
    mask = rng.random(len(docs)) < 0.3
    engines = [jref.ReferenceEngine.from_scored_index(jidx),
               pref.ReferenceEngine.from_scored_index(pidx),
               # duck-typed both ways
               jref.ReferenceEngine.from_scored_index(pidx),
               pref.ReferenceEngine.from_scored_index(jidx)]
    for kw in ({}, {"weights": w}, {"doc_mask": mask}):
        want = engines[0].search(q, top_k=17, **kw)
        for eng in engines[1:]:
            got = eng.search(q, top_k=17, **kw)
            for x, y in zip(want, got):
                assert x.dtype == y.dtype and np.array_equal(x, y)
    assert np.array_equal(engines[0].get_scores(q[1]),
                          engines[1].get_scores(q[1]))
    scores = rng.integers(0, 5, 50).astype(np.float32)
    for k in (0, 3, 50, 80):
        for x, y in zip(jref.topk_descending(scores, k),
                        pref.topk_descending(scores, k)):
            assert np.array_equal(x, y)


@pytest.mark.parametrize("queries,weights,oov", [
    (np.zeros(5, np.int32), None, "raise"),  # 1-D
    (np.zeros((2, 3), np.float32), None, "raise"),  # not integer
    (np.array([[1, 400]]), None, "raise"),  # out of vocab
    (np.array([[1, 2]]), np.ones((2, 2)), "raise"),  # weights shape
    (np.array([[1, 400, -1]]), None, "clamp"),  # clamped, no error
    (np.zeros((0, 4), np.int32), None, "raise"),  # empty batch
])
def test_validate_query_batch_same_errors(queries, weights, oov):
    def run(mod):
        try:
            return mod.validate_query_batch(queries, 300, weights, oov=oov)
        except ValueError as e:
            return str(e)

    want, got = run(jval), run(pval)
    if isinstance(want, str):
        assert want == got
    else:
        assert all(np.array_equal(x, y) for x, y in zip(want, got)
                   if x is not None)
    for ids_only in (False, True):
        a = jval.empty_results(3, 4, ids_only)
        b = pval.empty_results(3, 4, ids_only)
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("mode", ["dense", "sparse"])
def test_engine_device_bytes_equal_to_jax_count(mode):
    idx = pscoring.build_scored_index(zipf_docs(5), 300)
    kw = {"hot_tokens": 16, "hot_budget_bytes": 1 << 20} \
        if mode == "sparse" else {}
    engine = create_engine(idx, mode=mode, session=CPU, **kw)
    assert isinstance(engine, DenseEngine if mode == "dense"
                      else SparseEngine)
    count = peval.engine_device_bytes(engine)
    assert count == jeval.engine_device_bytes(engine) > 0
    mem_p = peval.index_memory_stats(idx, engine).as_dict()
    assert mem_p == jeval.index_memory_stats(idx, engine).as_dict()
    if mode == "dense":
        assert count == engine.st.numel() * 4 + engine.offsets.numel() * 4


def test_eval_metrics_equal():
    rng = np.random.default_rng(11)
    got = rng.integers(-1, 30, (6, 10))
    ref = rng.integers(-1, 30, (6, 10))
    rel = [set(rng.integers(0, 30, 3).tolist()) for _ in range(6)]
    grades = [{int(d): int(g) for d, g in zip(rng.integers(0, 30, 4),
                                               rng.integers(1, 3, 4))}
              for _ in range(5)] + [{}]
    assert jeval.recall_at_k(got, ref) == peval.recall_at_k(got, ref)
    assert jeval.mrr_at_k(got, rel) == peval.mrr_at_k(got, rel)
    assert jeval.ndcg_at_k(got, grades) == peval.ndcg_at_k(got, grades)


def test_bench_corpus_and_queries_equal():
    jc = jbench.BenchConfig(num_docs=3000, vocab=500, num_queries=40)
    pc = pbench.BenchConfig(num_docs=3000, vocab=500, num_queries=40)
    assert jc.__dict__ == pc.__dict__
    assert jc.engine_kwargs() == pc.engine_kwargs()
    fields_equal(jbench.make_synthetic_index(jc),
                 pbench.make_synthetic_index(pc))
    assert np.array_equal(jbench.make_queries(jc), pbench.make_queries(pc))


@pytest.mark.parametrize("mode", ["auto", "sparse"])
def test_retriever_fit_builds_a_port_engine(tmp_path, mode):
    tok = ptok.Tokenizer(stemmer=None)
    r = pretriever.Retriever.fit(CORPUS, tokenizer=tok, engine_mode=mode,
                                 save_to=str(tmp_path), session=CPU)
    assert isinstance(r.engine, DenseEngine if mode == "auto"
                      else SparseEngine)
    assert r.engine.session is CPU
    oracle = pref.ReferenceEngine.from_scored_index(r.index)
    ids = tok.tokenize_queries(QUERIES, r.index.vocab)
    docs, scores, texts = r.retrieve(QUERIES, k=3, return_text=True)
    assert_matches_oracle(docs, scores, *oracle.search(ids, top_k=3))
    assert texts[0][0] == CORPUS[docs[0, 0]]
    # the JAX package's Retriever over the same texts: the same index
    j = jretriever.Retriever.fit(CORPUS, tokenizer=jtok.Tokenizer(
        stemmer=None))
    fields_equal(j.index, r.index)
    assert r.explain("quick fox", 0) == j.explain("quick fox", 0)
    # load streams the saved index (mmap) through the port's engine build
    loaded = pretriever.Retriever.load(str(tmp_path), engine_mode=mode,
                                       mmap=True, session=CPU)
    assert isinstance(loaded.engine, type(r.engine))
    assert isinstance(loaded.index.data, np.memmap)
    assert loaded.tokenizer.config() == tok.config()
    got = loaded.retrieve(QUERIES, k=3)
    assert_matches_oracle(*got, *oracle.search(ids, top_k=3))
    if mode == "auto":  # weighted queries, on the engine "auto" picks
        weighted = [{"quick": 2.0, "fox": 0.5}, "dog"]
        wid, wts = tok.tokenize_weighted_queries(weighted, r.index.vocab)
        assert_matches_oracle(*loaded.retrieve(weighted, k=3),
                              *oracle.search(wid, top_k=3, weights=wts))
