"""The port's warmers (runtime/warmup.py) against the JAX package's, on the
CPU.

The port's plan must be the one JAX makes for the same engine, routed
(the default) and built with ``route_cold=False``, over the cases of
``tests/test_warmup.py``; ``warm_engine`` reports every task with its
first-use work, and the CLI's ``warm`` prints the JAX CLI's report.
"""

import json

import numpy as np
import pytest
import torch

import bm25_tpu.models.sparse as jax_sparse
from bm25_tpu.cli.main import main as jax_main
from bm25_tpu.runtime import warmup as jax_warmup
from bm25_tpu.scoring import build_scored_index
from bm25_tpu.text.tokenizer import Tokenizer
from bm25_tpu_torch import Session, SparseEngine, save_device_checkpoint
from bm25_tpu_torch.cli.main import main
from bm25_tpu_torch.runtime.warmup import (_query_matrix, default_plan,
                                           warm_engine)

CPU = Session("cpu")
PHASES = ("nvcc_build_s", "native_build_s", "library_load_s")


@pytest.fixture(scope="module")
def engines(request):
    corpus = request.getfixturevalue("zipf_corpus_small")
    out = Tokenizer(stopwords=None, stemmer=None).tokenize_corpus(corpus)
    idx = build_scored_index(out.ids, vocab_size=len(out.vocab))
    jax_engine = jax_sparse.SparseEngine.from_scored_index(
        idx, hot_tokens=16)
    return jax_engine, SparseEngine.from_scored_index(
        idx, session=CPU, hot_tokens=16, hot_budget_bytes=1 << 22)


# the plan arguments of tests/test_warmup.py's cases
PLAN_CASES = [
    dict(top_ks=(5, 10), batch_sizes=(1, 8), routed_batch=64,
         cold_classes=(2, 4)),
    dict(top_ks=(5,), batch_sizes=(1, 8, 32), routed_batch=512,
         cold_classes=(2, 4)),
    dict(top_ks=(5,), batch_sizes=(8,), routed_batch=64, cold_classes=(2,),
         weighted=True, ids_only=True),
    dict(top_ks=(5,), batch_sizes=(8,), routed_batch=64, widths=(1,),
         cold_classes=(2, 4, 8)),
    dict(top_ks=(3,), filtered=True),
    dict(),
]


@pytest.mark.parametrize("routed", [True, False])
@pytest.mark.parametrize("case", range(len(PLAN_CASES)))
def test_default_plan_equals_jax_unrouted(engines, case, routed,
                                          monkeypatch):
    """JAX's default engine plans its routed family, one built with
    ``route_cold=False`` the unrouted one; the port's plans are JAX's."""
    jax_engine, port = engines
    if not routed:
        monkeypatch.setattr(jax_engine, "route_cold", False)
        monkeypatch.setattr(port, "route_cold", False)
    kw = PLAN_CASES[case]
    want = jax_warmup.default_plan(jax_engine, **kw)
    got = default_plan(port, **kw)
    assert got == want and got
    assert any(t["cold"] is not None for t in got) == (
        routed and any(q >= 32 for q in (*kw.get("batch_sizes", (1, 8, 32)),
                                         kw.get("routed_batch", 512))))


def test_default_plan_without_routing_equals_jax():
    class Bare:
        vocab_size = 100
        hot_table_host = None
        hot_h = 0

    kw = dict(top_ks=(10,), batch_sizes=(8,), routed_batch=64)
    assert default_plan(Bare(), **kw) == jax_warmup.default_plan(Bare(), **kw)
    assert [t["q"] for t in default_plan(Bare(), **kw)] == [8, 64]


def test_query_matrix_equals_jax_unrouted(engines):
    """The warm queries at a cold-width class (each row's cold count
    pinned by the hot table) and without one: JAX's."""
    jax_engine, port = engines
    for cold in (None, 3):
        got = _query_matrix(port, 16, 8, cold, np.random.default_rng(0))
        want = jax_warmup._query_matrix(jax_engine, 16, 8, cold,
                                        np.random.default_rng(0))
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.int32 and got.max() < port.vocab_size


def test_warm_engine_reports_every_task(engines):
    _, port = engines
    tasks = default_plan(port, top_ks=(5,), batch_sizes=(1, 8),
                         routed_batch=32, weighted=True, ids_only=True,
                         filtered=True)
    lines = []
    report = warm_engine(port, tasks=tasks, log=lines.append)
    assert len(report) == len(tasks) == len(lines)
    for task, entry in zip(tasks, report):
        assert {k: entry[k] for k in task} == task
        assert entry["seconds"] >= 0
        # on the CPU nothing is built or loaded
        assert all(entry[p] == 0 for p in PHASES)
    assert {(r["weighted"], r["ids_only"], r["filtered"]) for r in report} \
        == {(False, False, False), (True, False, False),
            (False, True, False), (False, False, True)}
    assert "nvcc 0.000s" in lines[0]
    # a hand-built task with the core keys only runs too
    assert warm_engine(port, tasks=[{"q": 4, "t": 8, "top_k": 3}])[0][
        "seconds"] >= 0
    docs, _ = port.search(np.array([[1, 2, 3, -1]], np.int32), top_k=3)
    assert docs.shape == (1, 3)


def test_warm_cli_equals_jax(tmp_path, animal_corpus, capsys):
    corpus_file = tmp_path / "docs.txt"
    corpus_file.write_text("\n".join(animal_corpus))
    idx = tmp_path / "idx"
    assert main(["index", str(corpus_file), "-o", str(idx)]) == 0
    capsys.readouterr()
    args = ["warm", str(idx), "--top-k", "3", "--batch-sizes", "1",
            "--routed-batch", "8", "--weighted"]
    assert main(["--device", "cpu", *args]) == 0
    got = json.loads(capsys.readouterr().out)
    assert jax_main(args) == 0
    want = json.loads(capsys.readouterr().out)
    strip = lambda r: [{k: v for k, v in t.items()  # noqa: E731
                        if k not in ("seconds", *PHASES)} for t in r]
    assert got["shapes"] == want["shapes"] == len(got["report"]) > 0
    assert strip(got["report"]) == strip(want["report"])
    assert all(all(t[p] == 0 for p in PHASES) for t in got["report"])

    # from a device checkpoint
    from bm25_tpu_torch import create_engine, load_index

    ck = str(tmp_path / "ck")
    save_device_checkpoint(ck, create_engine(load_index(str(idx)),
                                             session=CPU))
    assert main(["--device", "cpu", "warm", "--device-checkpoint", ck,
                 "--top-k", "2", "--batch-sizes", "1"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["shapes"] == 2  # q=1 and the routed batch, unrouted
    assert main(["--device", "cpu", "warm"]) == 2
    capsys.readouterr()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            main(args)
