"""The port's layout cost model (models/sparse.py: ``_ell_slot_estimate``,
``_hot_cost_sweep``, ``choose_hot_tokens``, ``choose_layout``,
``hot_tokens="auto"``, ``overhead_target``) against the JAX package's, on
the CPU.

The model's search is JAX's and only its cost terms are the card's
(``H100Costs``): with JAX's v5e terms swapped in (``LAYOUT_COSTS``) the
port returns JAX's exact sweep and choice.  With the card's terms, the
counterparts of JAX's model tests hold.  The device memory is pinned at
the H100's 80 GB (on the CPU ``device_hbm_bytes`` reads the machine's
RAM), so no choice depends on the machine running the tests.
"""

import importlib
import json
import logging

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from conftest import make_zipf_corpus

import bm25_tpu.models.sparse as jax_sparse
from bm25_tpu.ops.ell_score import max_hot_for_vmem
from bm25_tpu.reference import ReferenceEngine
from bm25_tpu.scoring import build_scored_index, build_scored_index_flat
from bm25_tpu.text.tokenizer import Tokenizer
from bm25_tpu_torch import Session
from bm25_tpu_torch.bench import layout_sweep
from bm25_tpu_torch.models import sparse as port_sparse
from bm25_tpu_torch.models.sparse import SparseEngine
from bm25_tpu_torch.utils.parity import assert_matches_oracle
from bm25_tpu_torch.utils.padding import cdiv

# bm25_tpu_torch.ops re-exports a function of the module's name
port_ell = importlib.import_module("bm25_tpu_torch.ops.ell_score")
CPU = Session("cpu")
DEV = torch.device("cpu")
H100_BYTES = 80 * 2**30


@pytest.fixture(autouse=True)
def card_memory(monkeypatch):
    monkeypatch.setattr(port_sparse, "device_hbm_bytes",
                        lambda device: H100_BYTES)


def skewed_index(num_docs=6000, vocab=512, seed=3, avg_len=40):
    """tests/test_sparse_engine.py's _skewed_index (Zipf token draws)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    cum = np.cumsum((1.0 / ranks) / (1.0 / ranks).sum())
    lengths = np.maximum(4, rng.poisson(avg_len, num_docs)).astype(np.int32)
    flat = np.searchsorted(cum, rng.random(int(lengths.sum()))).astype(
        np.int32)
    np.clip(flat, 0, vocab - 1, out=flat)
    return build_scored_index_flat(flat, lengths, vocab_size=vocab)


@pytest.fixture(scope="module")
def small_index():
    return skewed_index()


@pytest.fixture(scope="module")
def long_index():
    """Long documents (3,000 Zipf draws over 256 tokens, so a doc holds
    most of the vocabulary): here the card's terms do buy a hot tier,
    since the whole vocabulary hot frees every ELL slot."""
    return skewed_index(num_docs=3000, vocab=256, avg_len=3000)


@pytest.fixture(scope="module")
def long_engines(long_index):
    """The default build of ``long_index`` at overhead targets 1.6, 3.0
    and none, device memory pinned at the card's (built once: the hot
    tier's build runs B2's plain twin here)."""
    threads = torch.get_num_threads()
    # one thread: the twin's many small ops slow down by tens of times
    # when several test processes each run a thread per core
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(port_sparse, "device_hbm_bytes",
                       lambda device: H100_BYTES)
            return {target: SparseEngine.from_scored_index(
                long_index, session=CPU, overhead_target=target)
                for target in (1.6, 3.0, None)}
    finally:
        torch.set_num_threads(threads)


# -- the slot estimate -----------------------------------------------------------


@pytest.mark.parametrize("d,v,mb,ra", [
    (300, 200, 4, 8), (1000, 500, 2, 8), (97, 50, 4, 8),
    (512, 300, 8, 8), (64, 40, 4, 512), (8, 10, 4, 8), (1500, 300, 6, 512),
])
def test_ell_slot_estimate_matches_jax_and_built_layout(d, v, mb, ra):
    """JAX's test_ell_slot_estimate_matches_built_layout: the estimate is
    JAX's and the slot count the port's bucketing builds."""
    rng = np.random.default_rng(d + v)
    nnz = np.maximum(1, rng.poisson(rng.integers(2, 30), size=d))
    rows, cols = [], []
    for r, n in enumerate(nnz):
        c = rng.choice(v, size=min(n, v), replace=False)
        rows.extend([r] * len(c))
        cols.extend(c.tolist())
    csr = sp.csr_matrix((np.ones(len(rows), np.float32), (rows, cols)),
                        shape=(d, v))
    row_nnz = np.diff(csr.indptr)
    est = port_sparse._ell_slot_estimate(row_nnz, mb, ra)
    assert est == jax_sparse._ell_slot_estimate(row_nnz, mb, ra)
    built = port_sparse.build_ell_buckets_from_csr(csr.copy(), d,
                                                   max_buckets=mb,
                                                   row_align=ra)
    assert est == sum(b.tok.shape[0] * b.tok.shape[1] for b in built)


# -- JAX's model, on JAX's terms ---------------------------------------------------


class V5ECosts:
    """JAX's v5e cost terms, in JAX's order of operations."""

    def scan_hot_seconds(self, slots, h, rows_pad, q, t):
        q_tiles = max(1, cdiv(q, 128))
        return (slots * q * (2 * t + 2) / jax_sparse._SCAN_OPS_PER_SEC
                + h * rows_pad * q_tiles * jax_sparse._HOT_SEC_PER_ROW_TILE)

    def selection_us_per_query(self, k, n_rows):
        return jax_sparse._selection_us_per_query(k, n_rows)

    def h_cap(self, max_doc_nnz):
        return max_hot_for_vmem(max_doc_nnz)

    def resident_cap(self, device, num_docs):
        return jax_sparse._auto_resident_cap()


@pytest.mark.parametrize("tail", [False, True])
@pytest.mark.parametrize("target", [None, 3.0])
@pytest.mark.parametrize("budget_rows", [None, 64])
def test_sweep_and_choice_equal_jax_on_jax_terms(monkeypatch, small_index,
                                                 tail, target, budget_rows):
    idx = small_index
    monkeypatch.setattr(port_sparse, "LAYOUT_COSTS", V5ECosts())
    df = idx.df()
    cap = int(np.median(df[df > 0])) if tail else 0
    budget = None if budget_rows is None else budget_rows * idx.num_docs * 4
    kw = dict(budget_bytes=budget, tail_cap=cap, overhead_target=target)
    buckets = (2, 3, 4, 6, 8)
    got = port_sparse._hot_cost_sweep(idx, buckets, device=DEV, **kw)
    assert got == jax_sparse._hot_cost_sweep(idx, buckets, **kw)
    assert port_sparse.choose_hot_tokens(idx, device=DEV, **kw) == \
        jax_sparse.choose_hot_tokens(idx, **kw)
    for k in (100, 1000):
        assert port_sparse.choose_layout(idx, k, device=DEV, **kw) == \
            jax_sparse.choose_layout(idx, k, **kw)


# -- the card's terms ---------------------------------------------------------------


def test_card_terms_cap_and_resident_memory():
    """The hot tier's cap is the hot kernel's shared-memory list, not a
    doc width; the resident cap leaves 4x a full chunk's score tiles
    under the usable share of the card."""
    costs = port_sparse.H100Costs()
    assert costs.h_cap(1) == costs.h_cap(10**6) == port_ell.max_hot_tokens()
    assert port_ell.max_hot_tokens() % port_ell.HOT_BK == 0
    assert (port_ell.HOT_SMEM_FIXED + 4 * port_ell.max_hot_tokens()
            <= port_ell.SMEM_ONE_BLOCK
            < port_ell.HOT_SMEM_FIXED + 4 * (port_ell.max_hot_tokens()
                                             + port_ell.HOT_BK))
    usable = int(H100_BYTES * 14 / 16)
    assert costs.resident_cap(DEV, 524288) == usable - 4 * 512 * 4 * 524288
    assert costs.resident_cap(DEV, 10**8) == usable - 4 * (4 << 30)
    # more tables, more scan; a hot tier costs its rows even at h = 1
    t8, t64 = (costs.scan_hot_seconds(10**6, 0, 4096, 512, t)
               for t in (8, 64))
    assert t64 > t8 > 0
    assert costs.scan_hot_seconds(0, 1, 4096, 512, 8) > \
        costs.scan_hot_seconds(0, 0, 4096, 512, 8)


def test_layout_candidates_and_choice(small_index):
    """choose_layout is the cheapest of layout_candidates; the model is
    free to pick no hot tier (short Zipf docs: the card's hot kernel
    costs more than the slots it frees)."""
    cands = port_sparse.layout_candidates(small_index, 1000, device=DEV)
    assert [c["max_buckets"] for c in cands] == [2, 3, 4, 6, 8]
    for c in cands:
        assert c["total_ms"] == pytest.approx(c["scan_hot_ms"]
                                              + c["selection_ms"])
    best = min(cands, key=lambda c: c["total_ms"])
    choice = port_sparse.choose_layout(small_index, 1000, device=DEV)
    assert choice == {"max_buckets": best["max_buckets"],
                      "hot_tokens": best["hot_tokens"]}
    assert choice["hot_tokens"] == 0
    lines = []
    port_sparse.choose_layout(small_index, 100, device=DEV, log=lines.append)
    assert len(lines) == 5 and all(x.startswith("[layout] B=") for x in lines)


def test_choose_hot_tokens_cost_model(long_index):
    """JAX's test_choose_hot_tokens_cost_model on the card's terms."""
    idx = long_index
    assert port_sparse.choose_hot_tokens(idx, budget_bytes=0,
                                         device=DEV) == 0
    h1 = port_sparse.choose_hot_tokens(idx, device=DEV)
    assert h1 == port_sparse.choose_hot_tokens(idx, device=DEV)
    assert 0 < h1 <= idx.vocab_size
    assert port_sparse.choose_hot_tokens(
        idx, budget_bytes=64 * idx.num_docs * 4, device=DEV) <= 64


def test_auto_hot_tokens_engine_matches_oracle(small_index, long_index,
                                               long_engines):
    """JAX's test_auto_hot_tokens_engine_matches_oracle: "auto" is the
    default, with no hot tier (against the oracle and the JAX engine,
    which sizes its own tier by its v5e terms) and with one (against the
    oracle)."""
    rng = np.random.default_rng(41)
    for idx, eng in ((small_index, SparseEngine.from_scored_index(
            small_index, session=CPU)), (long_index, long_engines[None])):
        assert eng.hot_h == port_sparse.choose_hot_tokens(idx, device=DEV)
        queries = rng.integers(-1, idx.vocab_size, size=(8, 5),
                               dtype=np.int32)
        dd, ds = eng.search(queries, top_k=9)
        assert_matches_oracle(dd, ds, *ReferenceEngine.from_scored_index(
            idx).search(queries, top_k=9))
        if idx is small_index:
            assert eng.hot_h == 0
            assert_matches_oracle(dd, ds, *jax_sparse.SparseEngine.
                                  from_scored_index(idx).search(queries,
                                                                top_k=9))
    assert long_engines[None].hot_h > 0


def test_auto_hot_respects_tail_cap_disjointness(long_index):
    """JAX's test_auto_hot_respects_tail_cap_disjointness: with a tail
    tier the auto hot set stays within the tokens above the cap."""
    idx = long_index
    df = idx.df()
    cap = int(np.sort(df)[-5])
    n_above = int((df > cap).sum())
    assert n_above < 8
    assert port_sparse.choose_hot_tokens(idx, tail_cap=cap,
                                         device=DEV) <= n_above
    eng = SparseEngine.from_scored_index(idx, session=CPU, tail_cap=cap)
    assert eng.hot_h <= n_above
    hot_ids = np.flatnonzero(eng.hot_table.numpy()[:-1] >= 0)
    assert (df[hot_ids] > cap).all()
    rng = np.random.default_rng(11)
    queries = rng.integers(-1, idx.vocab_size, size=(8, 6), dtype=np.int32)
    assert_matches_oracle(
        *eng.search(queries, top_k=10),
        *ReferenceEngine.from_scored_index(idx).search(queries, top_k=10))


def test_overhead_target_memory_budget_knob(long_index, long_engines):
    """JAX's test_overhead_target_memory_budget_knob on the card's terms:
    a target caps the device bytes at ~R x CSC whenever a hot tier fits,
    the hot tier grows with the target, results stay exact."""
    idx = long_index
    csc = idx.data.nbytes + idx.indices.nbytes + idx.indptr.nbytes
    oracle = ReferenceEngine.from_scored_index(idx)
    rng = np.random.default_rng(5)
    queries = rng.integers(-1, idx.vocab_size, size=(16, 6), dtype=np.int32)
    engines = {}
    for target, eng in long_engines.items():
        ratio = eng.device_bytes() / csc
        if target is not None and eng.hot_h > 0:
            assert ratio <= target * 1.1
        assert_matches_oracle(*eng.search(queries, top_k=9),
                              *oracle.search(queries, top_k=9))
        engines[target] = eng.hot_h
    assert engines[1.6] <= engines[3.0] <= engines[None]
    assert engines[None] > 0


def test_overhead_target_rejects_explicit_hot_tokens():
    """JAX's test: the same ValueErrors, word for word."""
    idx = skewed_index(num_docs=200, vocab=64)
    for kw in ({"hot_tokens": 8, "overhead_target": 2.0},
               {"overhead_target": -1.0}):
        with pytest.raises(ValueError) as pe:
            SparseEngine.from_scored_index(idx, session=CPU, **kw)
        with pytest.raises(ValueError) as je:
            jax_sparse.SparseEngine.from_scored_index(idx, **kw)
        assert str(pe.value) == str(je.value)


def test_overhead_target_below_floor_degrades_to_ell_only(caplog):
    """JAX's test: a target below the ELL-only floor builds no hot tier
    and warns."""
    idx = skewed_index(num_docs=3000, vocab=256)
    with caplog.at_level(logging.WARNING, logger=port_sparse.__name__):
        eng = SparseEngine.from_scored_index(idx, session=CPU,
                                             overhead_target=0.1)
    assert eng.hot_h == 0
    assert any("not reachable" in r.message for r in caplog.records)
    q = np.array([[0, 3, 5, -1]], dtype=np.int32)
    assert_matches_oracle(*eng.search(q, top_k=5),
                          *ReferenceEngine.from_scored_index(idx).search(
                              q, top_k=5))


def test_auto_logs_the_memory_trade(caplog, small_index):
    with caplog.at_level(logging.INFO, logger=port_sparse.__name__):
        SparseEngine.from_scored_index(small_index, session=CPU)
    assert any(r.message.startswith("hot-auto: h=") for r in caplog.records)


def test_explicit_hot_tokens_capped_by_the_hot_kernel(monkeypatch):
    """An explicit width beyond what B1's hot kernel takes is clamped."""
    out = Tokenizer(stopwords=None, stemmer=None).tokenize_corpus(
        make_zipf_corpus(200, vocab=100, avg_len=20, seed=2))
    idx = build_scored_index(out.ids, vocab_size=len(out.vocab))
    monkeypatch.setattr(port_sparse, "max_hot_tokens", lambda: 8)
    eng = SparseEngine.from_scored_index(idx, session=CPU, hot_tokens=20,
                                         hot_budget_bytes=1 << 24)
    assert eng.hot_h == 8


# -- the sweep script's fit ---------------------------------------------------------


def test_layout_sweep_fit_recovers_the_terms(tmp_path, capsys):
    """``--fit`` on lines made from known terms returns them, with the
    grid, and reports each corpus and k's choice."""
    costs = port_sparse.H100Costs()
    want = {"SCAN_S_PER_SLOT_TABLE": 2e-11, "SCAN_S_PER_ROW_BLOCK": 3e-10,
            "HOT_S_PER_ROW_BLOCK": 1e-9, "HOT_S_PER_TOKEN_ROW_BLOCK": 7e-13}
    for name, value in want.items():
        setattr(costs, name, value)
    lines = []
    for h in (0, 64, 256, 1024):
        for mb, slots in ((2, 4_000_000), (4, 3_500_000)):
            slots -= 1000 * h
            r = {"corpus": "headline", "num_docs": 65536, "h": h,
                 "max_buckets": mb, "slots_model": slots,
                 "rows_pad_model": 65536 + mb * 512, "q": 512, "t": 8,
                 "card": "test"}
            for k in (1000, 100):
                t = 512 * 8
                scan = (slots * 4 * want["SCAN_S_PER_SLOT_TABLE"]
                        + r["rows_pad_model"] * 4
                        * want["SCAN_S_PER_ROW_BLOCK"])
                hot = costs.scan_hot_seconds(slots, h, r["rows_pad_model"],
                                             512, 8) - scan
                r[f"k{k}"] = {"scan_ms": scan * 1e3, "hot_ms": hot * 1e3,
                              "table_ms": 0.01, "other_ms": 1.0,
                              "busy_ms": 0, "step_ms": (scan + hot) * 1e3
                              + t / 4096}
            lines.append(r)
    for rows in (8192, 65536, 262144):
        for k in (100, 1000):
            lines.append({"sel_grid": True, "rows": rows, "k": k,
                          "us_per_query": rows / 65536 + k / 1000,
                          "card": "test"})
    path = tmp_path / "sweep.jsonl"
    path.write_text("\n".join(json.dumps(x) for x in lines) + "\n")
    fitted = layout_sweep.fit([str(path)])
    for name, value in want.items():
        assert fitted["constants"][name] == pytest.approx(value, rel=1e-6)
    assert fitted["constants"]["SEL_GRID"][1000] == [
        (8192, 1.125), (65536, 2.0), (262144, 5.0)]
    layout_sweep.report(fitted)
    out = capsys.readouterr().out
    assert "headline k=1000: model picks h=0 B=2" in out
    assert out.count("| headline |") == 16


def test_route_sweep_fit_recovers_the_chunk_costs(tmp_path, capsys):
    """``--fit-route`` on two passes' lines made from known chunk costs
    returns them, fits each pass alone, and prints a grid a k with each
    pass's reading over the model's."""
    unit, c0, fixed = 1e-4, {100: 90.0, 1000: 130.0}, 16000.0
    paths = []
    for n, jitter in ((1, 1.0), (2, 1.0 + 1e-9)):
        lines = [{"route": True, "height": q, "cold_width": t, "k": k,
                  "ms": unit * jitter * (q * (c0[k] + 2 * t + 2) + fixed),
                  "card": "test"}
                 for q in layout_sweep.ROUTE_HEIGHTS
                 for t in layout_sweep.ROUTE_COLD for k in (1000, 100)]
        path = tmp_path / f"route_p{n}.jsonl"
        path.write_text("\n".join(json.dumps(x) for x in lines) + "\n")
        paths.append(str(path))
    fitted = layout_sweep.fit_route(paths)
    assert fitted["unit_ms"] == pytest.approx(unit, rel=1e-6)
    assert fitted["CHUNK_FIXED_UNITS"] == pytest.approx(fixed, rel=1e-6)
    for k, want in c0.items():
        assert fitted["CHUNK_C0_UNITS"][k] == pytest.approx(want, rel=1e-6)
    layout_sweep.report_route(paths)
    out = capsys.readouterr().out
    assert out.count(" alone: ") == 2
    assert "k=1000: measured ms" in out and "k=100: measured ms" in out
    assert out.count("\n| 512 |") == 2
    assert "error over 120 readings: median 0.000" in out
