"""bm25-tpu-torch command line: index build, query, bench, demo, eval.

The port's copy of ``bm25_tpu/cli/main.py``, command for command, with the
port's imports: ``demo`` is ``python main.py`` without the interactive-only
flow (``reference/main.py:210-264``), ``index``/``query`` replace
``bm25_test.py``'s build/save/load, ``bench`` replaces ``magic run
benchmarks``.  What differs:

* a global ``--device`` (default ``cuda``): the ``Session`` that the
  commands which run on a device (``query``, ``demo``, ``eval``, ``bench``)
  build their engine or benchmark on; it raises where CUDA is absent
  unless ``--device cpu`` is given;
* ``eval`` takes ``--stemmer snowball-en|none`` (default ``snowball-en``,
  the JAX CLI's tokenizer): the Snowball stemmer needs ``nltk``, which a
  GPU machine may not have.  ``index`` builds with the JAX CLI's default
  tokenizer, as JAX's does; an index without stemming is built through the
  library (``build_index(..., tokenizer=Tokenizer(stemmer=None),
  save_to=...)``), and ``query`` reads the saved tokenizer config;
* ``bench --suite matmul`` runs the port's ``bench_matmul`` on the device;
  ``bench --suite query`` runs the port's query benchmark harness
  (``bench/query_bench.py::run``, ``BM25_BENCH_*`` overrides) on the
  device and prints the full record, then the compact headline as the
  last line, as ``bench.py`` does;
* ``checkpoint``, ``warm``, ``cache`` and ``serve`` are not registered until
  device checkpoints and serving are ported (ROADMAP.md: device
  checkpoints, serving).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

STEMMERS = ("snowball-en", "none")


def _session(args):
    from bm25_tpu_torch.runtime.session import Session

    return Session(args.device)


def _tokenizer(args):
    """The tokenizer of ``--stemmer``: None (the default ``Tokenizer()``)
    for snowball-en, else one without a stemmer."""
    from bm25_tpu_torch.text.tokenizer import Tokenizer

    return None if args.stemmer == "snowball-en" else Tokenizer(stemmer=None)


def _read_corpus(path: str) -> list[str]:
    docs = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith("{"):
                # JSONL record — but a plain-text line may legitimately
                # start with '{' ("{disputed} territory"), so fall back to
                # text instead of crashing the whole build
                try:
                    obj = json.loads(line)
                except json.JSONDecodeError:
                    docs.append(line)
                else:
                    docs.append(obj.get("text", "")
                                if isinstance(obj, dict) else line)
            else:
                docs.append(line)
    return docs


def cmd_index(args) -> int:
    from bm25_tpu_torch.index.builder import build_index
    from bm25_tpu_torch.scoring import BM25Params

    corpus = _read_corpus(args.corpus)
    params = BM25Params(k1=args.k1, b=args.b, delta=args.delta, method=args.method)
    index, stats = build_index(corpus, params=params, save_to=args.out,
                               workers=args.workers)
    print(
        f"indexed {stats.num_docs} docs, vocab {stats.vocab_size}, "
        f"nnz {stats.nnz}, {stats.docs_per_second:.0f} docs/s -> {args.out}"
    )
    return 0


def cmd_query(args) -> int:
    from bm25_tpu_torch.index.io import (
        MMapCorpus, load_index, load_tokenizer_config)
    from bm25_tpu_torch.models.auto import create_engine
    from bm25_tpu_torch.text.tokenizer import Tokenizer

    index = load_index(args.index, mmap=args.mmap)
    if index.vocab is None:
        print("index has no vocab.index.json; cannot map text queries", file=sys.stderr)
        return 2
    engine = create_engine(index, mode=args.engine, session=_session(args))
    tok = load_tokenizer_config(args.index) or Tokenizer()
    try:
        corpus = MMapCorpus.open(args.index)
    except FileNotFoundError:
        corpus = None

    queries = list(args.query)
    if args.interactive:
        # positional queries run first (argparse accepted them; silently
        # dropping them surprised users), then the interactive loop
        if queries:
            _run_queries(engine, tok, index, corpus, queries, args.top_k,
                         explain_n=args.explain)
        print("enter queries (empty line to quit):")
        for line in sys.stdin:
            line = line.strip()
            if not line:
                break
            _run_queries(engine, tok, index, corpus, [line], args.top_k,
                         explain_n=args.explain)
        return 0
    if not queries:
        print("no queries given (use positional args or --interactive)", file=sys.stderr)
        return 2
    _run_queries(engine, tok, index, corpus, queries, args.top_k,
                 explain_n=args.explain)
    return 0


def _run_queries(engine, tok, index, corpus, queries, top_k, explain_n=0):
    # Lucene-style term boosts: "fish^2.5 cat" scores fish at 2.5x
    parsed = [tok.parse_boosted(q) or q for q in queries]
    t0 = time.perf_counter()
    if any(isinstance(p, dict) for p in parsed):
        ids, wts = tok.tokenize_weighted_queries(parsed, index.vocab)
        docs, scores = engine.search(ids, top_k=top_k, weights=wts)
    else:
        ids = tok.tokenize_queries(queries, index.vocab)
        docs, scores = engine.search(ids, top_k=top_k)
    dt = time.perf_counter() - t0
    for qi, q in enumerate(queries):
        print(f"query: {q!r}  ({dt * 1e3:.1f} ms batch)")
        for rank in range(docs.shape[1]):
            d, s = int(docs[qi, rank]), float(scores[qi, rank])
            text = ""
            if corpus is not None:
                text = " " + repr(corpus[d].get("text", ""))[:80]
            print(f"  {rank + 1}. doc={d} score={s:.4f}{text}")
            if rank < explain_n and d >= 0:
                from bm25_tpu_torch.scoring import explain_score

                exp = explain_score(index, tok, parsed[qi], d)
                for t in exp["terms"]:
                    mark = "+" if t["matched"] else "-"
                    print(f"     {mark} {t['term']!r} (token={t['token']!r} "
                          f"id={t['token_id']} df={t['df']} "
                          f"idf={t['idf']:.4f} weight={t['weight']:g}): "
                          f"contribution={t['contribution']:.4f}")


def cmd_bench(args) -> int:
    log = lambda *a: print(*a, file=sys.stderr)  # noqa: E731
    if args.suite == "matmul":
        from bm25_tpu_torch.bench.matmul_bench import bench_matmul

        print(json.dumps(bench_matmul(log=log,
                                      device=_session(args).device)))
        return 0
    from bm25_tpu_torch.bench.query_bench import (BenchConfig,
                                                  compact_headline, run)

    result = run(BenchConfig.from_env(), log=log, session=_session(args))
    print(json.dumps(result))
    print(json.dumps(compact_headline(result)))
    return 0


def cmd_demo(args) -> int:
    """The reference's 13-doc retrieval demo (main.py:210-264), batch-safe."""
    from bm25_tpu_torch.index.builder import build_index
    from bm25_tpu_torch.models.auto import create_engine
    from bm25_tpu_torch.text.tokenizer import Tokenizer

    docs = [
        "The quick brown fox jumps over the lazy dog",
        "Some other text",
        "The quick rabbit runs past the brown fox",
        "The quick rabbit jumps over the brown dog",
        "The quick dog chases past the lazy fox",
        "The quick dog runs through the tall trees",
        "The quick brown fox jumps over the lazy dog",
        "The brown dog sleeps under the shady tree",
        "The brown rabbit hops under the tall tree",
        "The brown fox runs through the forest trees",
        "The brown fox watches the sleeping rabbit",
        "The lazy fox watches over the sleeping dog",
        "The lazy dog watches the quick rabbit",
    ]
    tok = Tokenizer(stopwords=None, stemmer=None)
    index, _ = build_index(docs, tokenizer=tok)
    engine = create_engine(index, session=_session(args))
    query = args.query or "quick brown fox"
    ids = tok.tokenize_queries([query], index.vocab)
    d, s = engine.search(ids, top_k=args.top_k)
    print(f"query: {query!r}")
    for rank in range(d.shape[1]):
        print(f"  {rank + 1}. score={float(s[0, rank]):.4f}  {docs[int(d[0, rank])]!r}")
    return 0


def cmd_info(args) -> int:
    from bm25_tpu_torch.index.io import load_index

    # stats only touch shapes + avgdl: mmap keeps info O(1) RAM and
    # near-instant on multi-GB indexes
    idx = load_index(args.index, mmap=True)
    print(json.dumps({
        "num_docs": idx.num_docs,
        "vocab_size": idx.vocab_size,
        "nnz": idx.nnz,
        "avgdl": idx.avgdl,
        "params": {
            "k1": idx.params.k1, "b": idx.params.b,
            "delta": idx.params.delta, "method": idx.params.method,
        },
    }, indent=2))
    return 0


def cmd_eval(args) -> int:
    from bm25_tpu_torch.datasets import evaluate_dataset, load_beir

    ds = load_beir(args.dataset, split=args.split)
    result = evaluate_dataset(
        ds, top_k=args.top_k, engine_mode=args.engine,
        max_queries=args.max_queries,
        log=lambda *a: print(*a, file=sys.stderr),
        run_file=args.run_file,
        session=_session(args), tokenizer=_tokenizer(args),
    )
    print(json.dumps(result))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="bm25-tpu-torch")
    p.add_argument("--device", default="cuda",
                   help="torch device that query/demo/eval/bench run on "
                        "(default cuda; raises where CUDA is absent)")
    sub = p.add_subparsers(dest="cmd", required=True)

    pi = sub.add_parser("index", help="build and save an index from a corpus file")
    pi.add_argument("corpus", help="text file (one doc per line) or jsonl with 'text'")
    pi.add_argument("-o", "--out", required=True)
    pi.add_argument("--k1", type=float, default=1.5)
    pi.add_argument("--b", type=float, default=0.75)
    pi.add_argument("--delta", type=float, default=0.5)
    pi.add_argument("--method", default="lucene")
    pi.add_argument("--workers", type=int, default=1,
                    help="tokenize in N worker processes (multi-core hosts)")
    pi.set_defaults(fn=cmd_index)

    pq = sub.add_parser(
        "query",
        help="query a saved index (supports Lucene-style term^weight boosts)",
    )
    pq.add_argument("index")
    pq.add_argument("query", nargs="*")
    pq.add_argument("-k", "--top-k", type=int, default=5)
    pq.add_argument("--engine", default="auto",
                    choices=["auto", "dense", "sparse", "sharded", "sharded_sparse"])
    pq.add_argument("-i", "--interactive", action="store_true")
    pq.add_argument("--mmap", action="store_true",
                    help="memory-map the index npy triplet instead of "
                         "reading it into RAM (bm25s load(mmap=True) analog)")
    pq.add_argument(
        "--explain", type=int, default=0, metavar="N",
        help="print a per-term score breakdown for the top N results "
             "of each query",
    )
    pq.set_defaults(fn=cmd_query)

    pb = sub.add_parser("bench", help="run a benchmark suite (JSON to stdout)")
    pb.add_argument("--suite", default="query", choices=["query", "matmul"])
    pb.set_defaults(fn=cmd_bench)

    pd = sub.add_parser("demo", help="13-doc retrieval demo (reference main.py)")
    pd.add_argument("-q", "--query", default=None)
    pd.add_argument("-k", "--top-k", type=int, default=3)
    pd.set_defaults(fn=cmd_demo)

    pn = sub.add_parser("info", help="print index stats")
    pn.add_argument("index")
    pn.set_defaults(fn=cmd_info)

    pe = sub.add_parser("eval", help="evaluate on a BEIR-format dataset dir")
    pe.add_argument("dataset", help="dir with corpus.jsonl/queries.jsonl/qrels/")
    pe.add_argument("--split", default="test")
    pe.add_argument("-k", "--top-k", type=int, default=100)
    pe.add_argument("--engine", default="auto")
    pe.add_argument("--max-queries", type=int, default=None)
    pe.add_argument("--run-file", default=None,
                    help="write results as a TREC run file (trec_eval/"
                         "pytrec_eval interop)")
    pe.add_argument("--stemmer", default="snowball-en", choices=STEMMERS,
                    help="none: no stemming (the Snowball stemmer needs nltk)")
    pe.set_defaults(fn=cmd_eval)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
