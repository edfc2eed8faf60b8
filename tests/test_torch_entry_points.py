"""The port's user entry points (cli/main.py, compat.py, datasets.py)
against the JAX package's, on the CPU.

The port's CLI runs with ``--device cpu`` (its default is the card) and is
held to the JAX CLI on the same inputs: the files ``index`` writes are
byte-equal, ``info``'s JSON is equal, ``query``'s text is equal once its
``(... ms batch)`` timing is cut out (doc ids and 4-decimal scores, with
and without term boosts, under ``--engine dense`` and ``sparse``), and so
are ``demo``'s text and ``eval``'s metrics.  ``compat`` and ``datasets``
mirror ``tests/test_compat.py`` and ``tests/test_datasets.py`` on
``Session("cpu")`` and agree with the JAX classes and functions.  Without
a session the port's entry points raise where CUDA is absent.
"""

import argparse
import json
import os
import re

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import bm25_tpu.compat as jax_compat
import bm25_tpu.datasets as jax_datasets
from bm25_tpu.cli.main import main as jax_main
from bm25_tpu_torch import Session, SparseEngine
from bm25_tpu_torch import compat, datasets
from bm25_tpu_torch.bench import matmul_bench
from bm25_tpu_torch.cli.main import _read_corpus, main

CPU = Session("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MINI_BEIR = os.path.join(REPO, "tests", "data", "mini_beir")
TIMING = re.compile(r"\(\d+(\.\d+)? ms batch\)")


def run(fn, args, capsys) -> str:
    assert fn(args) == 0
    return TIMING.sub("", capsys.readouterr().out)


@pytest.fixture
def index_dirs(tmp_path, animal_corpus, capsys):
    corpus = tmp_path / "docs.txt"
    corpus.write_text("\n".join(animal_corpus))
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    run(main, ["index", str(corpus), "-o", str(port_dir)], capsys)
    run(jax_main, ["index", str(corpus), "-o", str(jax_dir)], capsys)
    return port_dir, jax_dir


def test_index_files_and_info_equal_jax(index_dirs, capsys):
    port_dir, jax_dir = index_dirs
    names = sorted(os.listdir(jax_dir))
    assert sorted(os.listdir(port_dir)) == names and names
    for name in names:
        with open(port_dir / name, "rb") as f, open(jax_dir / name, "rb") as g:
            assert f.read() == g.read(), name
    info = json.loads(run(main, ["info", str(port_dir)], capsys))
    assert info == json.loads(run(jax_main, ["info", str(jax_dir)], capsys))
    assert info["num_docs"] == 4 and info["vocab_size"] == 20


@pytest.mark.parametrize("engine", ["dense", "sparse"])
@pytest.mark.parametrize("queries", [
    ["does the fish purr like a cat?", "bird that can fly"],
    ["fish^50 purr cat", "water^0.5 dog^2 play"],  # Lucene term boosts
])
def test_query_text_equals_jax(index_dirs, capsys, engine, queries):
    port_dir, jax_dir = index_dirs
    args = [*queries, "-k", "3", "--engine", engine, "--explain", "2"]
    got = run(main, ["--device", "cpu", "query", str(port_dir), *args],
              capsys)
    want = run(jax_main, ["query", str(jax_dir), *args], capsys)
    assert got == want
    assert got.count("query: ") == 2 and "doc=" in got


def test_query_top_hit_and_errors(index_dirs, capsys):
    port_dir, _ = index_dirs
    out = run(main, ["--device", "cpu", "query", str(port_dir),
                     "fish^50 purr cat", "-k", "1"], capsys)
    assert "fish" in out.splitlines()[-1]
    assert main(["--device", "cpu", "query", str(port_dir)]) == 2
    with pytest.raises(NotImplementedError,
                       match="ROADMAP.md: the sharded engines"):
        main(["--device", "cpu", "query", str(port_dir), "cat",
              "--engine", "sharded"])


def test_demo_equals_jax(capsys):
    for args in ([], ["-q", "sleeping rabbit", "-k", "2"]):
        got = run(main, ["--device", "cpu", "demo", *args], capsys)
        assert got == run(jax_main, ["demo", *args], capsys)
        assert "score=" in got


@pytest.mark.parametrize("extra", [[], ["--engine", "sparse", "-k", "10"]])
def test_eval_metrics_equal_jax(capsys, extra):
    got = json.loads(run(main, ["--device", "cpu", "eval", MINI_BEIR,
                                *extra], capsys))
    want = json.loads(run(jax_main, ["eval", MINI_BEIR, *extra], capsys))
    assert got == want
    assert got["num_queries"] == 16


def test_eval_without_stemmer_and_run_file(tmp_path, capsys):
    run_file = tmp_path / "run.trec"
    out = json.loads(run(main, ["--device", "cpu", "eval", MINI_BEIR,
                                "--stemmer", "none", "--run-file",
                                str(run_file)], capsys))
    assert out["run_file"] == str(run_file) and run_file.stat().st_size
    assert 0 < out["mrr@10"] <= 1


def test_index_takes_the_jax_cli_options_only(tmp_path, animal_corpus,
                                              capsys):
    """``index`` has no ``--stemmer`` (nor has JAX's); an unstemmed index
    is built through the library, and ``query`` reads its saved
    tokenizer, as JAX's CLI does on the same directory."""
    from bm25_tpu_torch import Tokenizer, build_index

    corpus = tmp_path / "docs.txt"
    corpus.write_text("\n".join(animal_corpus))
    for cli in (main, jax_main):
        with pytest.raises(SystemExit):
            cli(["index", str(corpus), "-o", str(tmp_path / "x"),
                 "--stemmer", "none"])
    capsys.readouterr()
    idx = tmp_path / "plain"
    build_index(animal_corpus, tokenizer=Tokenizer(stemmer=None),
                save_to=str(idx))
    args = ["query", str(idx), "cats purring", "fish", "-k", "3"]
    got = run(main, ["--device", "cpu", *args], capsys)
    assert got == run(jax_main, args, capsys)
    assert "doc=" in got


# tests/test_bench_run.py's tiny config, without the rows that are not
# ported
TINY_BENCH = dict(
    num_docs=256, vocab=512, avg_len=16, num_queries=64, batch=32,
    top_k=20, top_k2=5, baseline_queries=8, engine="sparse",
    max_buckets=2, eval_docs=200, eval_queries=8,
    longdoc_docs=96, longdoc_long_len=320, longdoc_short_len=16,
    sharded_docs=0, cold_start=0, shard_scaling=0,
)


def test_bench_suites(capsys, monkeypatch):
    small = matmul_bench.bench_matmul
    monkeypatch.setattr(matmul_bench, "bench_matmul",
                        lambda **kw: small(8, 8, 8, iters=1, **kw))
    out = run(main, ["--device", "cpu", "bench", "--suite", "matmul"],
              capsys).strip()
    assert len(out.splitlines()) == 1
    assert [r["algorithm"] for r in json.loads(out)] == ["xla", "naive",
                                                         "optimized"]
    # the query suite (the default) runs the harness: the full record,
    # then the compact headline last
    for field, value in TINY_BENCH.items():
        monkeypatch.setenv(f"BM25_BENCH_{field.upper()}", str(value))
    out = run(main, ["--device", "cpu", "bench"], capsys).strip()
    full, last = [json.loads(x) for x in out.splitlines()]
    assert full["metric"] == last["metric"] == "bm25_query_throughput"
    assert last["recall"] == full["extra"]["headline"][
        "recall_vs_reference"] == 1.0
    assert full["extra"]["device"] == {"type": "cpu"}


def _options(parser, cmd: str) -> dict:
    """{dest: (flags, default, choices, nargs, required)} of a command."""
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return {a.dest: (tuple(a.option_strings), a.default, a.choices,
                     a.nargs, a.required)
            for a in sub.choices[cmd]._actions if a.dest != "help"}


@pytest.mark.parametrize("cmd", ["checkpoint", "warm", "cache"])
def test_warm_restart_commands_take_jax_options(cmd, index_dirs, tmp_path,
                                                capsys):
    from bm25_tpu.cli.main import build_parser as jax_parser
    from bm25_tpu_torch.cli.main import build_parser

    assert _options(build_parser(), cmd) == _options(jax_parser(), cmd)
    port_dir, _ = index_dirs
    args = {"checkpoint": ["checkpoint", str(port_dir), "-o",
                           str(tmp_path / "ck")],
            "warm": ["warm", str(port_dir), "--batch-sizes", "1",
                     "--routed-batch", "8"],
            "cache": ["cache", "info", "--dir", str(tmp_path)]}[cmd]
    if cmd != "cache" and not torch.cuda.is_available():
        # warm and checkpoint build on the global --device: cuda by default
        with pytest.raises(RuntimeError, match="CUDA"):
            main(args)
    assert main(["--device", "cpu", *args]) == 0
    out = capsys.readouterr().out
    if cmd == "checkpoint":
        assert os.path.isfile(tmp_path / "ck")
        assert os.path.isfile(tmp_path / "ck.meta.json")
    else:
        assert json.loads(out.splitlines()[-1])
    # serve: registered, and with no index dir it exits 2
    assert main(["--device", "cpu", "serve"]) == 2
    assert "index dir" in capsys.readouterr().err


def test_read_corpus_equals_jax(tmp_path):
    from bm25_tpu.cli.main import _read_corpus as jax_read

    p = tmp_path / "docs.txt"
    p.write_text("{disputed} territory claims\n"
                 '{"text": "a real jsonl record"}\n\n'
                 "plain line\n")
    assert _read_corpus(str(p)) == jax_read(str(p)) == [
        "{disputed} territory claims", "a real jsonl record", "plain line"]


def test_entry_points_raise_without_cuda(index_dirs, animal_corpus):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where CUDA is absent")
    port_dir, _ = index_dirs
    for args in (["query", str(port_dir), "cat"], ["demo"],
                 ["eval", MINI_BEIR], ["bench", "--suite", "matmul"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(args)
    with pytest.raises(RuntimeError, match="CUDA"):
        compat.BM25().fit([d.split() for d in animal_corpus])
    with pytest.raises(RuntimeError, match="CUDA"):
        compat.BM25v().index(sp.csc_matrix(np.eye(3, dtype=np.float32)),
                             np.ones(3, np.int32))
    with pytest.raises(RuntimeError, match="CUDA"):
        datasets.evaluate_dataset(datasets.load_beir(MINI_BEIR),
                                  log=lambda *a: None)


# ---- compat (mirrors tests/test_compat.py) --------------------------------


def test_bm25_matches_jax_and_reference_math(fox_corpus):
    corpus = [d.lower().split() for d in fox_corpus]
    m = compat.BM25(session=CPU)
    m.fit(corpus)
    j = jax_compat.BM25()
    j.fit(corpus)
    assert m.vocabulary == j.vocabulary and m.term_to_id == j.term_to_id
    np.testing.assert_array_equal(m.bm25_matrix, j.bm25_matrix)
    n, v = len(corpus), len(m.vocabulary)
    tf = np.zeros((n, v), np.float32)
    for i, d in enumerate(corpus):
        for w in d:
            tf[i, m.term_to_id[w]] += 1
    dl = np.array([len(d) for d in corpus], np.float32)
    df = (tf > 0).sum(0)
    idf = np.log((n - df + 0.5) / (df + 0.5) + 1)
    norm = 1.5 * (1 - 0.75 + 0.75 * dl / dl.mean())
    expected = tf * 2.5 / (tf + norm[:, None]) * idf[None, :]
    np.testing.assert_allclose(m.bm25_matrix, expected, rtol=1e-5, atol=1e-6)
    for query in (["sleeping", "rabbit"], ["fox", "fox", "zzz"], ["zzz"]):
        scores = m.get_scores(query)
        np.testing.assert_allclose(scores, j.get_scores(query), rtol=1e-6,
                                   atol=1e-6)
        assert [c for _, c in m.get_top_n(query, fox_corpus, n=3)] == [
            c for _, c in j.get_top_n(query, fox_corpus, n=3)]
    top = m.get_top_n(["sleeping", "rabbit"], fox_corpus, n=3)
    assert top[0][1] == "The brown fox watches the sleeping rabbit"
    assert m._engine.st.device.type == "cpu"


def test_bm25_empty_oov_and_refit():
    m = compat.BM25(session=CPU)
    m.fit([])
    assert m.get_top_n(["x"], [], 5) == []
    m.fit([["alpha", "beta"]])
    assert (m.get_scores(["zzz"]) == 0).all()
    assert m.get_top_n(["alpha"], [["alpha", "beta"]], 0) == []
    m.fit([["brown", "fox"], ["lazy", "dog"]])
    assert m.get_scores(["fox"]).shape == (2,)
    m.fit([])
    assert m.corpus_size == 0 and m.term_to_id == {}
    np.testing.assert_array_equal(m.get_scores(["fox"]), np.zeros(0))


@pytest.mark.parametrize("dense_rows", [30, 3000])
def test_bm25v_matches_jax(dense_rows, monkeypatch):
    """Small CSCs route to DenseEngine; past the dense budget (here shrunk
    to 1 MiB, as a card's half memory is at the bench shape) to
    SparseEngine, whose get_scores serves too."""
    if dense_rows > 100:
        real = compat.create_engine
        monkeypatch.setattr(compat, "create_engine", lambda idx, **kw: real(
            idx, dense_budget_bytes=1 << 20, **kw))
    rng = np.random.default_rng(0)
    dense = (rng.random((dense_rows, 400))
             * (rng.random((dense_rows, 400)) > 0.9)).astype(np.float32)
    lengths = np.full(dense_rows, 5, dtype=np.int32)
    m = compat.BM25v(session=CPU)
    m.index(sp.csc_matrix(dense), lengths)
    j = jax_compat.BM25v()
    j.index(sp.csc_matrix(dense), lengths)
    assert isinstance(m._engine, SparseEngine) == (dense_rows > 100)
    queries = np.array([[0, 3, -1], [5, 5, 11], [-1, -1, -1]], np.int32)
    for k in (4, 25):
        docs, scores = m.search(queries, top_k=k)
        jd, js = j.search(queries, top_k=k)
        np.testing.assert_allclose(scores, js, rtol=1e-5, atol=1e-6)
        strict = np.ones_like(js, bool)
        strict[:, 1:] &= js[:, 1:] != js[:, :-1]
        strict[:, :-1] &= js[:, :-1] != js[:, 1:]
        np.testing.assert_array_equal(docs[strict], jd[strict])
        np.testing.assert_array_equal(m.get_scores(queries, k)[0], docs)
    np.testing.assert_allclose(scores[1, 0], (dense[:, 5] * 2
                                              + dense[:, 11]).max(), rtol=1e-5)
    if dense_rows > 100:
        np.testing.assert_allclose(m._engine.get_scores([5, 5, 11]),
                                   dense[:, 5] * 2 + dense[:, 11], rtol=1e-5,
                                   atol=1e-6)
    docs, scores = m.search(np.zeros((0, 2), np.int32), top_k=2)
    assert docs.shape == (0, 2) and scores.shape == (0, 2)
    with pytest.raises(ValueError, match="index"):
        compat.BM25v(session=CPU).search(queries)


# ---- datasets (mirrors tests/test_datasets.py) ----------------------------


def make_beir_dir(tmp_path):
    docs = [
        {"_id": "d1", "title": "Cats", "text": "a cat is a feline and likes to purr"},
        {"_id": "d2", "title": "Dogs", "text": "a dog is the humans best friend"},
        {"_id": "d3", "title": "Birds", "text": "a bird is a beautiful animal that can fly"},
        {"_id": "d4", "title": "Fish", "text": "a fish lives in water and swims"},
    ]
    queries = [{"_id": "q1", "text": "does the fish purr like a cat?"},
               {"_id": "q2", "text": "bird that can fly"}]
    (tmp_path / "qrels").mkdir()
    with open(tmp_path / "corpus.jsonl", "w") as f:
        f.writelines(json.dumps(d) + "\n" for d in docs)
    with open(tmp_path / "queries.jsonl", "w") as f:
        f.writelines(json.dumps(q) + "\n" for q in queries)
    with open(tmp_path / "qrels" / "test.tsv", "w") as f:
        f.write("query-id\tcorpus-id\tscore\n")
        f.write("q1\td1\t1\nq2\td3\t1\n")
    with open(tmp_path / "qrels" / "dev.tsv", "w") as f:
        f.write("q1\t0\td1\t1\nq2\t0\td3\t1\n")  # TREC 4-column layout
    return tmp_path


def quiet(*_):
    pass


def test_load_beir_and_evaluate_match_jax(tmp_path):
    root = make_beir_dir(tmp_path)
    for split in ("test", "dev"):
        ds = datasets.load_beir(root, split=split)
        assert vars(ds) == vars(jax_datasets.load_beir(root, split=split))
        assert ds.qrels == {"q1": {"d1": 1}, "q2": {"d3": 1}}
    ds = datasets.load_beir(root)
    for kw in ({"top_k": 2}, {"top_k": 1, "max_queries": 1}):
        got = datasets.evaluate_dataset(ds, log=quiet, session=CPU, **kw)
        assert got == jax_datasets.evaluate_dataset(ds, log=quiet, **kw)
    assert got["mrr@10"] == 1.0 and got["num_queries"] == 1


def test_synthetic_generators_match_jax():
    assert datasets.synthetic_corpus(50, vocab=100, avg_len=10, seed=1) == \
        jax_datasets.synthetic_corpus(50, vocab=100, avg_len=10, seed=1)
    kw = dict(num_docs=400, num_queries=12, vocab=1024, avg_len=20, seed=3)
    assert vars(datasets.synthetic_beir_dataset(**kw)) == \
        vars(jax_datasets.synthetic_beir_dataset(**kw))
    kw = dict(num_docs=60, num_queries=4, vocab=300, query_terms=2,
              decoys_per_query=3, seed=3)
    assert vars(datasets.synthetic_beir_hard(**kw)) == \
        vars(jax_datasets.synthetic_beir_hard(**kw))


def test_synthetic_beir_hard_discriminates_like_jax():
    ds = datasets.synthetic_beir_hard(num_docs=800, num_queries=20,
                                      decoys_per_query=12, seed=3)
    assert all(len(v) == 3 for v in ds.qrels.values())
    r = datasets.evaluate_dataset(ds, top_k=10, engine_mode="dense",
                                  log=quiet, session=CPU)
    assert 0.3 < r["recall@10"] < 1.0 and 0.3 < r["mrr@10"] < 1.0
    r2 = datasets.evaluate_dataset(ds, top_k=10, engine_mode="sparse",
                                   log=quiet, session=CPU)
    assert (r2["recall@10"], r2["mrr@10"]) == (r["recall@10"], r["mrr@10"])
    assert r2["engine"] == "SparseEngine"
    want = jax_datasets.evaluate_dataset(ds, top_k=10, engine_mode="dense",
                                         log=quiet)
    assert r == want
