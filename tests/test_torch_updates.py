"""Live updates in the port (bm25_tpu_torch/index/updates.py) on the CPU.

Every test of ``tests/test_updates.py`` that needs no sharded engine or
streaming builder, run on the port (engines on ``Session("cpu")``), and
the port held against the JAX package on the same inputs: the delta
segment's scores bit-equal, ``UpdatableEngine.search`` over a port base
against JAX's over a JAX base and against the oracle base through mixed
adds, deletes, masks and weights for every method, compaction against a
fresh fit, and the update log's on-disk format read by either package.
"""

import threading
import warnings

import numpy as np
import pytest

from bm25_tpu.index import updates as jax_updates
from bm25_tpu.models.dense import DenseEngine as JaxDenseEngine
from bm25_tpu.scoring import build_scored_index as jax_build_scored_index
from bm25_tpu_torch import (DenseEngine, ReferenceEngine, Retriever, Session,
                            SparseEngine, Tokenizer)
from bm25_tpu_torch.index.updates import (DeltaSegment, StatsSnapshot,
                                          UpdatableEngine,
                                          UpdatableRetriever, UpdateLog,
                                          _round_up_k)
from bm25_tpu_torch.scoring import METHODS, BM25Params, build_scored_index
from bm25_tpu_torch.utils.parity import assert_matches_oracle

CPU = Session("cpu")
ENGINE_KW = {"engine_kwargs": {"session": CPU}}


def _corpus(n=40, seed=0, vocab=30):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(vocab)]
    return [
        " ".join(rng.choice(words, size=rng.integers(3, 12)))
        for _ in range(n)
    ]


def _fresh(texts, **kw):
    return UpdatableRetriever.fit(list(texts), **{**ENGINE_KW, **kw})


@pytest.fixture(scope="module")
def base_retriever():
    return _fresh(_corpus(), engine_mode="sparse")


# -- engine-level (tests/test_updates.py's, on the port) --------------------


def test_noop_wrapper_matches_base():
    docs_tok = [np.array([0, 1, 2], np.int32), np.array([1, 1, 3], np.int32),
                np.array([2, 4], np.int32)]
    idx = build_scored_index(docs_tok, vocab_size=5)
    base = ReferenceEngine.from_scored_index(idx)
    upd = UpdatableEngine(base, idx)
    q = np.array([[1, 2, -1]], np.int32)
    d0, s0 = base.search(q, top_k=3)
    d1, s1 = upd.search(q, top_k=3)
    np.testing.assert_array_equal(d0, d1)
    np.testing.assert_array_equal(s0, s1)


def test_added_identical_doc_scores_identically():
    docs_tok = [np.array([0, 1, 2, 3], np.int32),
                np.array([1, 1, 4], np.int32),
                np.array([2, 0, 0, 4], np.int32)]
    idx = build_scored_index(docs_tok, vocab_size=5)
    upd = UpdatableEngine(ReferenceEngine.from_scored_index(idx), idx)
    new_ids = upd.add([docs_tok[0].copy()])
    assert list(new_ids) == [3]
    docs, scores = upd.search(np.array([[0, 1, 2, 3]], np.int32), top_k=4)
    row = {int(d): float(s) for d, s in zip(docs[0], scores[0])}
    assert row[0] == row[3]
    assert list(docs[0][:2]) == [0, 3]


@pytest.mark.parametrize("method", ["lucene", "bm25+", "bm25l"])
def test_added_doc_clone_exact_all_methods(method):
    docs_tok = [np.array([0, 1, 2], np.int32), np.array([3, 3, 1], np.int32)]
    idx = build_scored_index(docs_tok, vocab_size=4,
                             params=BM25Params(method=method))
    upd = UpdatableEngine(ReferenceEngine.from_scored_index(idx), idx)
    upd.add([docs_tok[1].copy()])
    docs, scores = upd.search(np.array([[1, 3, -1]], np.int32), top_k=3)
    row = {int(d): float(s) for d, s in zip(docs[0], scores[0])}
    assert row[1] == row[2]


def test_new_term_only_matches_delta_docs():
    docs_tok = [np.array([0, 1], np.int32), np.array([1, 2], np.int32)]
    idx = build_scored_index(docs_tok, vocab_size=3)
    upd = UpdatableEngine(ReferenceEngine.from_scored_index(idx), idx)
    upd.add([np.array([3, 3, 0], np.int32)])
    assert upd.vocab_size == 4
    docs, scores = upd.search(np.array([[3]], np.int32), top_k=3)
    assert docs[0][0] == 2 and scores[0][0] > 0
    assert list(docs[0][1:]) == [0, 1]
    assert scores[0][1] == 0.0


def test_delete_never_surfaces_and_overfetch_stays_exact():
    docs_tok = [np.array([0], np.int32) for _ in range(10)]
    idx = build_scored_index(docs_tok, vocab_size=1)
    upd = UpdatableEngine(ReferenceEngine.from_scored_index(idx), idx)
    assert upd.delete([0, 1, 2]) == 3
    docs, _ = upd.search(np.array([[0]], np.int32), top_k=5)
    assert list(docs[0]) == [3, 4, 5, 6, 7]
    assert upd.live_docs == 7
    assert upd.delete([2]) == 0


def test_delete_delta_doc():
    docs_tok = [np.array([0, 1], np.int32)]
    idx = build_scored_index(docs_tok, vocab_size=2)
    upd = UpdatableEngine(ReferenceEngine.from_scored_index(idx), idx)
    ids = upd.add([np.array([0], np.int32), np.array([0], np.int32)])
    upd.delete([int(ids[0])])
    docs, _ = upd.search(np.array([[0]], np.int32), top_k=3)
    assert int(ids[0]) not in docs[0]
    assert upd.deleted_docs == 1 and upd.delta_docs == 2


def test_k_clamped_to_live_corpus():
    docs_tok = [np.array([0], np.int32) for _ in range(4)]
    idx = build_scored_index(docs_tok, vocab_size=1)
    upd = UpdatableEngine(ReferenceEngine.from_scored_index(idx), idx)
    upd.delete([1])
    docs, scores = upd.search(np.array([[0]], np.int32), top_k=100)
    assert docs.shape == (1, 3) and scores.shape == (1, 3)


def test_out_of_range_ids_score_as_oov():
    idx = build_scored_index([np.array([0], np.int32)], vocab_size=2)
    upd = UpdatableEngine(ReferenceEngine.from_scored_index(idx), idx)
    _, scores = upd.search(np.array([[5]], np.int32), top_k=1)
    assert scores[0, 0] == 0.0
    _, s2 = upd.search(np.array([[0, 5]], np.int32), top_k=1)
    _, s1 = upd.search(np.array([[0, -1]], np.int32), top_k=1)
    np.testing.assert_array_equal(s2, s1)
    with pytest.raises(ValueError, match="out of range"):
        upd.delete([7])


@pytest.mark.parametrize("weights", [
    np.array([[10.0, 0.1]], np.float32),
    [[10.0, 0.1]],  # non-ndarray weights normalize through the validator
])
def test_weighted_search_spans_segments(weights):
    docs_tok = [np.array([0, 1], np.int32), np.array([1, 1], np.int32)]
    idx = build_scored_index(docs_tok, vocab_size=2)
    upd = UpdatableEngine(ReferenceEngine.from_scored_index(idx), idx)
    upd.add([np.array([0, 0], np.int32)])
    docs, scores = upd.search(np.array([[0, 1]], np.int32), top_k=3,
                              weights=weights)
    assert docs[0][0] == 2 and scores.shape == (1, 3)


def test_doc_mask_composes_with_tombstones_and_delta():
    docs_tok = [np.array([0, 1, 2], np.int32), np.array([1, 2], np.int32),
                np.array([0, 2], np.int32)]
    idx = build_scored_index(docs_tok, vocab_size=3)
    upd = UpdatableEngine(ReferenceEngine.from_scored_index(idx), idx)
    upd.add([np.array([0, 1], np.int32), np.array([2, 2], np.int32)])
    upd.delete([1])
    q = np.array([[0, 1, 2]], np.int32)
    mask = np.array([True, True, False, False, True])
    docs, scores = upd.search(q, top_k=5, doc_mask=mask)
    assert docs.shape[1] == 4
    assert set(docs[0][docs[0] >= 0].tolist()) == {0, 4}
    n_real = int((docs[0] >= 0).sum())
    assert list(docs[0][n_real:]) == [-1] * (docs.shape[1] - n_real)
    assert (scores[0][n_real:] == 0.0).all()
    docs, _ = upd.search(q, top_k=3, doc_mask=np.ones(3, bool))
    assert set(docs[0][docs[0] >= 0].tolist()) <= {0, 2}
    with pytest.raises(ValueError, match="doc_mask shape"):
        upd.search(q, top_k=3, doc_mask=np.ones(9, bool))
    only_delta = np.zeros(5, bool)
    only_delta[3] = True
    docs, scores = upd.search(q, top_k=2, doc_mask=only_delta)
    assert docs[0][0] == 3 and scores[0][0] > 0 and docs[0][1] == -1
    upd2 = UpdatableEngine(ReferenceEngine.from_scored_index(idx), idx)
    upd2.add([np.array([0, 1], np.int32), np.array([2, 2], np.int32)])
    upd2.delete([1, 2, 3])
    d2, s2 = upd2.search(q, top_k=2)
    d1, s1 = upd.search(q, top_k=2,
                        doc_mask=np.array([True, False, False, False, True]))
    np.testing.assert_array_equal(d1, d2)
    np.testing.assert_allclose(s1, s2, rtol=1e-6)


def test_doc_mask_tolerates_racing_add():
    docs_tok = [np.array([0, 1], np.int32), np.array([1, 2], np.int32)]
    idx = build_scored_index(docs_tok, vocab_size=3)
    upd = UpdatableEngine(ReferenceEngine.from_scored_index(idx), idx)
    snapshot_mask = np.ones(upd.num_docs, bool)
    upd.add([np.array([0, 1, 2], np.int32)])
    docs, _ = upd.search(np.array([[0, 1, 2]], np.int32), top_k=3,
                         doc_mask=snapshot_mask)
    assert set(docs[0][docs[0] >= 0].tolist()) == {0, 1}


# -- retriever-level ----------------------------------------------------------


def test_add_then_retrieve_text(base_retriever):
    r = _fresh(_corpus(12, seed=3), engine_mode="sparse")
    ids = r.add_documents(["a brand zyqqx document about zyqqx"])
    docs, scores = r.retrieve(["zyqqx"], k=3)
    assert len(ids) == 1 and docs[0][0] == ids[0] and scores[0][0] > 0


@pytest.mark.parametrize("mode", ["sparse", "dense"])
def test_compact_matches_fresh_fit(mode):
    """After compact(), index arrays are bit-identical to a fresh fit of
    the live corpus, and retrieval equals the fresh retriever's and a
    ReferenceEngine rebuilt over the live texts."""
    texts = _corpus(15, seed=5)
    r = _fresh(texts, engine_mode=mode)
    added = ["new shiny doc about plasma", "another plasma physics doc"]
    r.add_documents(added)
    r.delete_documents([2, 7])
    remap = r.compact()
    live_texts = [t for i, t in enumerate(texts) if i not in (2, 7)] + added
    fresh = _fresh(live_texts, engine_mode=mode)
    np.testing.assert_array_equal(r.index.indptr, fresh.index.indptr)
    np.testing.assert_array_equal(r.index.indices, fresh.index.indices)
    np.testing.assert_array_equal(r.index.data, fresh.index.data)
    assert r.vocab == fresh.vocab
    assert remap[2] == -1 and remap[7] == -1
    assert remap[0] == 0 and remap[3] == 2
    q = ["plasma physics", "w1 w2 w3"]
    d0, s0 = r.retrieve(q, k=5)
    d1, s1 = fresh.retrieve(q, k=5)
    np.testing.assert_array_equal(d0, d1)
    np.testing.assert_array_equal(s0, s1)
    ref = ReferenceEngine.from_scored_index(fresh.index)
    assert_matches_oracle(d0, s0, *ref.search(
        r.tokenizer.tokenize_queries(q, r.vocab), top_k=5))
    jax_r = jax_updates.UpdatableRetriever.fit(texts, engine_mode="dense")
    jax_r.add_documents(added)
    jax_r.delete_documents([2, 7])
    np.testing.assert_array_equal(jax_r.compact(), remap)
    np.testing.assert_array_equal(jax_r.index.data, r.index.data)
    assert jax_r.vocab == r.vocab


def test_auto_compaction_on_add():
    r = _fresh(_corpus(10, seed=8), engine_mode="sparse", max_delta_docs=2)
    ids = r.add_documents(["alpha doc one", "alpha doc two", "alpha three"])
    assert r.engine.delta_docs == 0
    assert list(ids) == [10, 11, 12]
    docs, _ = r.retrieve(["alpha"], k=3)
    assert set(map(int, docs[0])) == {10, 11, 12}


def test_auto_compaction_on_delete():
    r = _fresh(_corpus(10, seed=9), engine_mode="sparse",
               max_deleted_frac=0.15)
    r.delete_documents([0, 1])
    assert r.engine.deleted_docs == 0 and r.engine.num_docs == 8


def test_save_compacts_and_roundtrips(tmp_path):
    r = _fresh(_corpus(8, seed=11), engine_mode="sparse")
    r.add_documents(["roundtrip target doc qwyx"])
    r.delete_documents([1])
    out = tmp_path / "upd_idx"
    r.save(str(out))
    r2 = Retriever.load(str(out), engine_mode="sparse", session=CPU)
    d, s = r2.retrieve(["qwyx"], k=1)
    assert s[0][0] > 0
    assert r2.text(int(d[0][0])).endswith("qwyx")


def test_compact_refuses_empty_corpus():
    r = _fresh(["only doc"], engine_mode="sparse")
    r.max_deleted_frac = 10.0
    r.delete_documents([0])
    with pytest.raises(ValueError, match="empty"):
        r.compact()


def test_device_engine_base(base_retriever):
    """The wrapper over the port's sparse engine on the CPU session."""
    r = base_retriever
    assert isinstance(r.engine.base, SparseEngine)
    assert r.engine.base.session.device.type == "cpu"
    ids = r.add_documents(["tpu kernels and sharded meshes zzremarkable"])
    docs, _ = r.retrieve(["zzremarkable kernels"], k=5)
    assert docs[0][0] == ids[0]
    q_ids = r.tokenizer.tokenize_queries(["kernels"], r.vocab)
    base_oracle = ReferenceEngine.from_scored_index(r.index)
    q_base = np.where(q_ids >= r.index.vocab_size, -1, q_ids)
    d0, _ = base_oracle.search(q_base, top_k=3)
    d1, _ = r.engine.search(q_ids, top_k=3)
    live = [i for i, d in enumerate(d1[0]) if d < r.index.num_docs]
    np.testing.assert_array_equal(d1[0][live][:2], d0[0][:2])


def test_retriever_concurrent_add_and_retrieve_text_alignment():
    base = [f"seed document number {i} alpha beta" for i in range(4)]
    r = _fresh(base, engine_mode="dense")
    errors: list = []
    stop = threading.Event()

    def adder(tid):
        try:
            for j in range(10):
                r.add_documents([f"marker{tid}x{j} fresh content {tid} {j}"])
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    def reader():
        try:
            while not stop.is_set():
                _, _, texts = r.retrieve(["alpha beta"], k=3,
                                         return_text=True)
                assert len(texts[0]) == 3
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=adder, args=(t,)) for t in range(3)]
    readers = [threading.Thread(target=reader) for _ in range(2)]
    for t in readers + threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    stop.set()
    for t in readers + threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not errors, errors
    for tid in range(3):
        for j in range(10):
            tok = f"marker{tid}x{j}"
            docs, scores = r.retrieve([tok], k=1)
            assert scores[0][0] > 0 and tok in r.text(int(docs[0][0]))


def test_fit_engine_kwargs_shape_initial_and_compacted_engine():
    """engine_kwargs (the session, score_dtype) shape the initial engine
    and every compaction's rebuild, which stays on the caller's device."""
    r = _fresh(_corpus(8), engine_mode="sparse",
               engine_kwargs={"session": CPU, "score_dtype": "bfloat16"})
    assert r.engine.base.score_dtype == "bfloat16"
    r.add_documents(["zebra quagga yak"])
    r.compact()
    assert r.engine.base.score_dtype == "bfloat16"
    assert r.engine.base.session is CPU


def test_fit_without_a_session_builds_on_the_card():
    """No session: the engine goes to the default CUDA session, which
    raises where there is no card (never a silent CPU build)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        UpdatableRetriever.fit(_corpus(4), engine_mode="dense")


def test_delete_everything_commits_without_raising():
    r = _fresh(_corpus(4), engine_mode="sparse", max_deleted_frac=0.25)
    assert r.delete_documents(list(range(r.engine.num_docs))) == 4
    assert not r.engine.live_mask().any()
    r.add_documents(["phoenix rises again"])
    _, _, texts = r.retrieve(["phoenix"], k=1, return_text=True)
    assert texts[0][0] == "phoenix rises again"


def test_short_doc_mask_rejected_below_base_length():
    r = _fresh(_corpus(8), engine_mode="sparse")
    with pytest.raises(ValueError, match="doc_mask shape"):
        r.engine.search(np.array([[0]], np.int32), top_k=2,
                        doc_mask=np.ones(3, bool))
    r.add_documents(["newest doc text here"])
    docs, _ = r.engine.search(np.array([[0]], np.int32), top_k=2,
                              doc_mask=np.ones(8, bool))
    assert (docs < 8).all() or (docs == -1).any()


# -- the delta segment and UpdatableEngine against the JAX package ----------


def _delta_inputs(method, seed=7, vocab=64):
    rng = np.random.default_rng(seed)
    base_tok = [rng.integers(0, vocab, size=rng.integers(3, 12)).astype(np.int32)
                for _ in range(30)]
    params = BM25Params(method=method)
    docs = [np.concatenate([
        rng.integers(0, vocab, size=rng.integers(2, 10)),
        rng.integers(vocab, vocab + 16, size=rng.integers(0, 4)),
    ]).astype(np.int32) for _ in range(200)]
    q = np.concatenate([
        rng.integers(-1, vocab, size=(16, 6)),
        rng.integers(vocab, vocab + 16, size=(16, 2)),
    ], axis=1).astype(np.int32)
    w = rng.uniform(0.1, 3.0, size=q.shape).astype(np.float32)
    batches, i = [], 0
    while i < len(docs):
        b = int(rng.integers(1, 17))
        batches.append(docs[i:i + b])
        i += b
    return base_tok, params, docs, batches, q, w


@pytest.mark.parametrize("method", METHODS)
def test_delta_score_all_bit_equal_to_jax(method):
    """DeltaSegment.score_all is JAX's bit for bit (one batch and the
    incremental LSM layout, weighted and not), and any partition into add
    batches gives the same bits."""
    base_tok, params, docs, batches, q, w = _delta_inputs(method)
    vocab = 64
    idx = build_scored_index(base_tok, vocab_size=vocab, params=params)
    jidx = jax_build_scored_index(base_tok, vocab_size=vocab, params=params)
    one = DeltaSegment(StatsSnapshot.from_index(idx), vocab)
    one.add([d.copy() for d in docs])
    inc = DeltaSegment(StatsSnapshot.from_index(idx), vocab)
    jinc = jax_updates.DeltaSegment(
        jax_updates.StatsSnapshot.from_index(jidx), vocab)
    for b in batches:
        inc.add([d.copy() for d in b])
        jinc.add([d.copy() for d in b])
    assert len(inc._blocks) < 8
    for weights in (None, w):
        got = inc.score_all(q, weights)
        np.testing.assert_array_equal(got, jinc.score_all(q, weights))
        np.testing.assert_array_equal(got, one.score_all(q, weights))
    np.testing.assert_array_equal(inc._token_offsets, jinc._token_offsets)


def _port_base(kind, idx):
    if kind == "reference":
        return ReferenceEngine.from_scored_index(idx)
    cls = SparseEngine if kind == "sparse" else DenseEngine
    kw = {"hot_tokens": 8, "max_buckets": 2} if kind == "sparse" else {}
    return cls.from_scored_index(idx, session=CPU, **kw)


@pytest.mark.parametrize("method", METHODS)
def test_updatable_engine_matches_jax_and_the_oracle_base(method):
    """Mixed adds (new terms too), deletes of base and delta docs, masks
    and weights: UpdatableEngine over the port's sparse and dense engines
    against JAX's UpdatableEngine over its dense engine and against an
    UpdatableEngine over ReferenceEngine, under the parity comparator."""
    rng = np.random.default_rng(11)
    vocab = 48
    base_tok = [rng.integers(0, vocab, size=rng.integers(3, 14)).astype(np.int32)
                for _ in range(150)]
    params = BM25Params(method=method)
    idx = build_scored_index(base_tok, vocab_size=vocab, params=params)
    jidx = jax_build_scored_index(base_tok, vocab_size=vocab, params=params)
    engines = {kind: UpdatableEngine(_port_base(kind, idx), idx)
               for kind in ("reference", "sparse", "dense")}
    jax_eng = jax_updates.UpdatableEngine(
        JaxDenseEngine.from_scored_index(jidx), jidx)
    q = np.concatenate([rng.integers(-1, vocab, size=(12, 5)),
                        rng.integers(vocab, vocab + 6, size=(12, 1))],
                       axis=1).astype(np.int32)
    w = rng.uniform(0.2, 2.5, size=q.shape).astype(np.float32)

    def check(k=12, **kw):
        want = engines["reference"].search(q, top_k=k, **kw)
        jd, js = jax_eng.search(q, top_k=k, **kw)
        assert_matches_oracle(jd, js, *want)
        for kind in ("sparse", "dense"):
            assert_matches_oracle(*engines[kind].search(q, top_k=k, **kw),
                                  *want)

    check()
    for step in range(3):
        added = [rng.integers(0, vocab + 6, size=rng.integers(2, 9))
                 .astype(np.int32) for _ in range(6)]
        ids = [e.add(added) for e in (*engines.values(), jax_eng)]
        for got in ids[1:]:
            np.testing.assert_array_equal(got, ids[0])
        victims = [int(v) for v in rng.choice(engines["reference"].num_docs,
                                              5, replace=False)]
        for e in (*engines.values(), jax_eng):
            e.delete(victims)
        check()
        check(weights=w)
    mask = rng.random(engines["reference"].num_docs) < 0.6
    check(doc_mask=mask)
    check(k=40, doc_mask=mask, weights=w)


def test_overfetch_past_the_chunk_plan_stays_exact():
    """k_base = k + the rounded-up tombstone count can exceed a sparse
    bucket's rows and the chunk plan's query rows: results stay the
    oracle's."""
    rng = np.random.default_rng(3)
    vocab = 40
    base_tok = [rng.integers(0, vocab, size=rng.integers(2, 10)).astype(np.int32)
                for _ in range(300)]
    idx = build_scored_index(base_tok, vocab_size=vocab)
    sparse = SparseEngine.from_scored_index(idx, session=CPU, hot_tokens=4,
                                            max_buckets=3)
    sparse.score_buffer_budget = 1 << 12  # chunks of 8 queries
    upd = UpdatableEngine(sparse, idx)
    ref = UpdatableEngine(ReferenceEngine.from_scored_index(idx), idx)
    victims = rng.choice(300, 150, replace=False)
    upd.delete(victims)
    ref.delete(victims)
    assert _round_up_k(150) == 192
    q = rng.integers(-1, vocab, size=(37, 4)).astype(np.int32)
    assert len(sparse.plan_chunks(q)[1]) > 1
    for k in (10, 100, 150):
        docs, scores = upd.search(q, top_k=k)
        assert_matches_oracle(docs, scores, *ref.search(q, top_k=k))
        assert not np.isin(docs, victims).any()


# -- UpdateLog: the on-disk format, shared with the JAX package -------------


def test_update_log_roundtrip_and_reset(tmp_path):
    log = UpdateLog(str(tmp_path))
    assert log.read() == [] and log.read_pending() == []
    log.append({"op": "add", "docs": ["héllo wörld"]})
    log.append({"op": "delete", "doc_ids": [1, 2]})
    log.append({"op": "compact"})
    want = [{"op": "add", "docs": ["héllo wörld"]},
            {"op": "delete", "doc_ids": [1, 2]}, {"op": "compact"}]
    assert UpdateLog(str(tmp_path)).read_pending() == want
    log.reset()
    assert UpdateLog(str(tmp_path)).read_pending() == []
    log.append({"op": "compact"})
    assert UpdateLog(str(tmp_path)).read_pending() == [{"op": "compact"}]
    log.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_update_log_bytes_and_replay_across_packages(tmp_path, writer):
    """Either package writes the same bytes (the sig header included) and
    reads the other's log, and both fence a changed base alike."""
    records = [{"op": "add", "docs": ["héllo wörld", "x"]},
               {"op": "delete", "doc_ids": [3]}, {"op": "compact"}]
    np.save(tmp_path / "data.csc.index.npy", np.arange(4, dtype=np.float32))
    logs = {}
    for name, cls in (("jax", jax_updates.UpdateLog), ("port", UpdateLog)):
        d = tmp_path / name
        d.mkdir()
        np.save(d / "data.csc.index.npy", np.arange(4, dtype=np.float32))
        log = cls(str(d))
        for rec in records:
            log.append(rec)
        log.close()
        logs[name] = d
    port_bytes = (logs["port"] / "updates.wal").read_bytes()
    jax_bytes = (logs["jax"] / "updates.wal").read_bytes()
    assert port_bytes.split(b"\n", 1)[1] == jax_bytes.split(b"\n", 1)[1]
    reader = UpdateLog if writer == "jax" else jax_updates.UpdateLog
    assert reader(str(logs[writer])).read_pending() == records
    np.save(logs[writer] / "data.csc.index.npy",
            np.arange(8, dtype=np.float32))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert reader(str(logs[writer])).read_pending() == []
    assert any("base artifacts changed" in str(x.message) for x in w)


def test_update_log_base_generation_fencing(tmp_path):
    np.save(tmp_path / "data.csc.index.npy", np.arange(4, dtype=np.float32))
    log = UpdateLog(str(tmp_path))
    log.append({"op": "add", "docs": ["pending doc"]})
    log.close()
    assert UpdateLog(str(tmp_path)).read_pending() == [
        {"op": "add", "docs": ["pending doc"]}]
    np.save(tmp_path / "data.csc.index.npy", np.arange(8, dtype=np.float32))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert UpdateLog(str(tmp_path)).read_pending() == []
    assert any("base artifacts changed" in str(x.message) for x in w)
    assert UpdateLog(str(tmp_path)).read_pending() == []


@pytest.mark.parametrize("lines,match", [
    (['{"op": "compact"}\n', "not json at all\n",
      '{"op": "delete", "doc_ids": [0]}\n'], "line 2"),
    (["garbage line\n", '{"op": "delete", "doc_ids": [0]}\n'], "line 1"),
])
def test_update_log_corrupt_middle_raises(tmp_path, lines, match):
    log = UpdateLog(str(tmp_path))
    with open(log.path, "w", encoding="utf-8") as f:
        f.writelines(lines)
    with pytest.raises(ValueError, match=match):
        log.read()
    with pytest.raises(ValueError, match=match):
        jax_updates.UpdateLog(str(tmp_path)).read()


def test_update_log_non_op_record_rejected(tmp_path):
    log = UpdateLog(str(tmp_path))
    with open(log.path, "w", encoding="utf-8") as f:
        f.write('{"op": "compact"}\n')
        f.write("[1, 2, 3]\n")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert log.read() == [{"op": "compact"}]
    assert any("torn" in str(x.message) for x in w)


@pytest.mark.parametrize("tail,want", [
    ('{"op": "add", "docs": ["never ack', []),  # torn: cut
    ('{"op": "add", "docs": ["acked doc"]}',  # newline lost: kept
     [{"op": "add", "docs": ["acked doc"]}]),
])
def test_update_log_append_after_dirty_tail(tmp_path, tail, want):
    log = UpdateLog(str(tmp_path))
    log.append({"op": "compact"})
    log.close()
    with open(log.path, "a", encoding="utf-8") as f:
        f.write(tail)
    fresh = UpdateLog(str(tmp_path))
    fresh.append({"op": "delete", "doc_ids": [1]})
    fresh.close()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert UpdateLog(str(tmp_path)).read_pending() == [
            {"op": "compact"}, *want, {"op": "delete", "doc_ids": [1]}]


def test_update_log_read_pending_truncates_torn_bytes(tmp_path):
    log = UpdateLog(str(tmp_path))
    log.append({"op": "compact"})
    log.close()
    with open(log.path, "a", encoding="utf-8") as f:
        f.write('{"op": "add", "docs": ["never ack')
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert UpdateLog(str(tmp_path)).read_pending() == [{"op": "compact"}]
    assert any("torn" in str(x.message) for x in w)
    data = open(log.path, "rb").read()
    assert b"never ack" not in data and data.endswith(b"\n")


def test_retriever_tokenizer_saved_beside_the_index(tmp_path):
    r = _fresh(_corpus(6), engine_mode="sparse",
               tokenizer=Tokenizer(stemmer=None))
    r.add_documents(["running runners run"])
    r.save(str(tmp_path / "idx"))
    r2 = Retriever.load(str(tmp_path / "idx"), engine_mode="sparse",
                        session=CPU)
    assert r2.tokenizer.stemmer is None
    assert "running" in r2.index.vocab
