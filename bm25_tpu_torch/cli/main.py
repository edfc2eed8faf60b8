"""bm25-tpu-torch command line: index build, query, bench, demo, eval,
checkpoint, warm, cache, serve.

The port's copy of ``bm25_tpu/cli/main.py``, command for command, with the
port's imports: ``demo`` is ``python main.py`` without the interactive-only
flow (``reference/main.py:210-264``), ``index``/``query`` replace
``bm25_test.py``'s build/save/load, ``bench`` replaces ``magic run
benchmarks``.  What differs:

* a global ``--device`` (default ``cuda``): the ``Session`` that the
  commands which run on a device (``query``, ``demo``, ``eval``, ``bench``,
  ``checkpoint``, ``warm``, ``serve``) build or restore their engine or
  benchmark on; it raises where CUDA is absent unless ``--device cpu`` is
  given (``cache`` touches no device but to probe its fingerprint);
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
* ``checkpoint`` writes the port's device checkpoint (one ``torch.save``
  file and its ``.meta.json`` sidecar, ``index/device_checkpoint.py``),
  which ``serve --device-checkpoint`` and ``warm --device-checkpoint``
  restore; ``warm`` runs the engine's dispatch family once, which builds
  and loads the kernel libraries the path needs, and ``cache`` inspects,
  exports and imports the directory of those libraries
  (``runtime/cache.py``), the port's counterpart of JAX's compile cache.
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


def cmd_warm(args) -> int:
    """Run the serving dispatch family once: a deploy step.

    The first run builds (nvcc) and loads every kernel library the served
    path needs; ``cache export`` then ships the built libraries, so a
    later ``serve`` on a fresh host of the same environment starts warm.
    """
    from bm25_tpu_torch.runtime.warmup import warm_engine

    if args.index is None and not args.device_checkpoint:
        print("error: provide an index dir and/or --device-checkpoint",
              file=sys.stderr)
        return 2
    session = _session(args)
    if args.device_checkpoint:
        from bm25_tpu_torch.index.device_checkpoint import (
            load_device_checkpoint)

        engine = load_device_checkpoint(args.device_checkpoint,
                                        session=session)
    else:
        from bm25_tpu_torch.index.io import load_index
        from bm25_tpu_torch.models.auto import create_engine

        engine_kwargs = {}
        if args.score_dtype != "float32":
            engine_kwargs["score_dtype"] = args.score_dtype
        if args.overhead_target is not None:
            engine_kwargs["overhead_target"] = args.overhead_target
        engine = create_engine(load_index(args.index), mode=args.engine,
                               session=session, **engine_kwargs)
    ints = lambda s: tuple(int(x) for x in s.split(","))  # noqa: E731
    t0 = time.perf_counter()
    report = warm_engine(
        engine,
        top_ks=ints(args.top_k),
        batch_sizes=ints(args.batch_sizes),
        routed_batch=args.routed_batch,
        widths=ints(args.widths),
        cold_classes=ints(args.cold_classes),
        weighted=args.weighted,
        ids_only=args.ids_only,
        filtered=args.filtered,
        log=lambda *a: print(*a, file=sys.stderr),
    )
    print(json.dumps({
        "shapes": len(report),
        "total_seconds": round(time.perf_counter() - t0, 1),
        "report": report,
    }))
    return 0


def cmd_checkpoint(args) -> int:
    """Build the engine once and save a device checkpoint for fast serves."""
    from bm25_tpu_torch.index.device_checkpoint import save_device_checkpoint
    from bm25_tpu_torch.index.io import load_index
    from bm25_tpu_torch.models.auto import create_engine

    session = _session(args)
    t0 = time.perf_counter()
    index = load_index(args.index)
    engine_kwargs = {}
    if getattr(args, "overhead_target", None) is not None:
        engine_kwargs["overhead_target"] = args.overhead_target
    engine = create_engine(index, mode=args.engine, session=session,
                           **engine_kwargs)
    print(f"engine built in {time.perf_counter() - t0:.1f}s "
          f"({type(engine).__name__})")
    t0 = time.perf_counter()
    save_device_checkpoint(args.out, engine)
    print(f"device checkpoint saved to {args.out} "
          f"in {time.perf_counter() - t0:.1f}s")
    return 0


def cmd_cache(args) -> int:
    """Kernel build-cache lifecycle: info / export / import.

    Deploy flow: ``bm25-tpu-torch warm`` on a build host fills the build
    directory, ``cache export`` tars it with an environment manifest,
    ``cache import`` on each serving host validates and unpacks it — the
    first ``serve`` there loads the libraries instead of running nvcc.
    """
    from bm25_tpu_torch.runtime import cache as cc

    if args.action == "info":
        print(json.dumps(cc.cache_info(args.dir)))
        return 0
    if args.archive is None:
        print(f"error: cache {args.action} requires an archive path",
              file=sys.stderr)
        return 2
    import tarfile

    if args.action == "export":
        try:
            out = cc.export_cache(args.archive, path=args.dir)
        except (FileNotFoundError, ValueError, OSError, tarfile.TarError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        print(json.dumps(out))
        return 0
    # import — tarfile.ReadError (corrupt/truncated/non-gzip archive) is a
    # TarError, not an OSError; catch it so a bad file gets the clean path
    try:
        out = cc.import_cache(args.archive, path=args.dir, force=args.force)
    except (FileNotFoundError, ValueError, OSError, tarfile.TarError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    for m in out["mismatches"]:
        print(f"warning: fingerprint mismatch ({m})", file=sys.stderr)
    print(json.dumps(out))
    return 0


def cmd_serve(args) -> int:
    from bm25_tpu_torch.serve import Server

    if args.index is None and not args.device_checkpoint:
        print("error: provide an index dir and/or --device-checkpoint",
              file=sys.stderr)
        return 2
    engine_kwargs = {"session": _session(args)}
    if args.score_dtype != "float32":
        engine_kwargs["score_dtype"] = args.score_dtype
    if args.overhead_target is not None:
        engine_kwargs["overhead_target"] = args.overhead_target
    Server(args.index, host=args.host, port=args.port,
           engine_mode=args.engine,
           batch_window_ms=args.batch_window_ms,
           warmup_top_k=args.warmup_top_k,
           engine_kwargs=engine_kwargs,
           device_checkpoint=args.device_checkpoint,
           updatable=args.updatable,
           auto_compact=args.auto_compact,
           auto_compact_delta_docs=args.auto_compact_delta_docs,
           auto_compact_deleted_frac=args.auto_compact_deleted_frac,
           mmap=args.mmap,
           result_cache=args.result_cache,
           ).serve_forever()
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="bm25-tpu-torch")
    p.add_argument("--device", default="cuda",
                   help="torch device that query/demo/eval/bench/checkpoint/"
                        "warm/serve run on (default cuda; raises where CUDA "
                        "is absent)")
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

    pc = sub.add_parser(
        "checkpoint",
        help="build an engine once and save a device checkpoint "
             "(warm-restart serving without the index rebuild)",
    )
    pc.add_argument("index")
    pc.add_argument("-o", "--out", required=True)
    pc.add_argument("--overhead-target", type=float, default=None,
                    help="cap device memory at this ratio of the raw CSC "
                         "footprint (auto hot-tier policy dial)")
    pc.add_argument("--engine", default="auto",
                    choices=["auto", "dense", "sparse", "sharded",
                             "sharded_sparse"])
    pc.set_defaults(fn=cmd_checkpoint)

    pw = sub.add_parser(
        "warm",
        help="run the serving dispatch family once, building and loading "
             "the kernel libraries it needs (run once at deploy; later "
             "serves start warm)",
    )
    pw.add_argument("index", nargs="?", default=None)
    pw.add_argument("--device-checkpoint", default=None,
                    help="warm an engine restored from a device checkpoint "
                         "instead of building from the index dir")
    pw.add_argument("--engine", default="auto",
                    choices=["auto", "dense", "sparse", "sharded",
                             "sharded_sparse"])
    pw.add_argument("--top-k", default="10",
                    help="comma-separated top_k values to warm (match what "
                         "clients will send)")
    pw.add_argument("--batch-sizes", default="1,8,32",
                    help="comma-separated unrouted request sizes")
    pw.add_argument("--routed-batch", type=int, default=512,
                    help="row count for the routed (micro-batched) shapes")
    pw.add_argument("--widths", default="8",
                    help="comma-separated padded query widths (8 covers "
                         "all queries with <= 8 terms)")
    pw.add_argument("--cold-classes", default="2,4,8",
                    help="comma-separated routed cold-width classes")
    pw.add_argument("--weighted", action="store_true",
                    help="also warm the weighted-query path")
    pw.add_argument("--ids-only", action="store_true",
                    help="also warm the rankings-only (search_ids) path")
    pw.add_argument("--filtered", action="store_true",
                    help="also warm the filtered-search (doc_mask / "
                         "filter_ids) path — it bypasses the batcher, so "
                         "its first production request pays any first-use "
                         "work directly")
    pw.add_argument("--overhead-target", type=float, default=None,
                    help="cap device memory at this ratio of the raw CSC "
                         "footprint (auto hot-tier policy dial; ~1.4 = "
                         "parity floor, unset = speed-optimal)")
    pw.add_argument("--score-dtype", default="float32",
                    choices=["float32", "bfloat16"])
    pw.set_defaults(fn=cmd_warm)

    pcc = sub.add_parser(
        "cache",
        help="kernel build-cache lifecycle: ship built kernel libraries to "
             "new serving hosts (info / export <tar.gz> / import <tar.gz>)")
    pcc.add_argument("action", choices=["info", "export", "import"])
    pcc.add_argument("archive", nargs="?", default=None,
                     help="archive path (required for export/import)")
    pcc.add_argument("--dir", default=None,
                     help="build directory (default: BM25_TPU_TORCH_BUILD_"
                          "DIR, else bm25_tpu_torch/_build)")
    pcc.add_argument("--force", action="store_true",
                     help="import even if the archive's nvcc/torch/driver/"
                          "device fingerprint does not match this host")
    pcc.set_defaults(fn=cmd_cache)

    ps = sub.add_parser("serve", help="HTTP search daemon over a saved index")
    ps.add_argument("index", nargs="?", default=None)
    ps.add_argument("--device-checkpoint", default=None,
                    help="warm-restart the engine from a device checkpoint "
                         "(bm25-tpu-torch checkpoint ...) instead of "
                         "building from the index; the index dir remains "
                         "optional for corpus text in responses and "
                         "/reload")
    ps.add_argument("--host", default="127.0.0.1")
    ps.add_argument("--port", type=int, default=8225)
    ps.add_argument("--engine", default="auto",
                    choices=["auto", "dense", "sparse", "sharded", "sharded_sparse"])
    ps.add_argument("--batch-window-ms", type=float, default=0.0,
                    help="coalesce concurrent requests arriving within this "
                         "window into one device batch (0 = off)")
    ps.add_argument("--warmup-top-k", type=int, default=0,
                    help="run the query path once at this top_k before "
                         "accepting traffic (0 = no warmup)")
    ps.add_argument("--overhead-target", type=float, default=None,
                    help="cap device memory at this ratio of the raw CSC "
                         "footprint (auto hot-tier policy dial)")
    ps.add_argument("--score-dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="bfloat16 halves result-transfer bytes (sparse "
                         "engines; doc ids stay exact, returned score "
                         "values round to bf16)")
    ps.add_argument("--updatable", action="store_true",
                    help="enable live index mutation: POST /add, /delete, "
                         "/compact (delta segment + tombstones over the "
                         "frozen base engine); acked mutations are fsynced "
                         "to <index>/updates.wal and replayed on restart")
    ps.add_argument("--auto-compact", action="store_true",
                    help="background compaction when the delta/tombstone "
                         "load crosses the thresholds below; persists to "
                         "the served index dir and folds the update log "
                         "(requires --updatable)")
    ps.add_argument("--auto-compact-delta-docs", type=int, default=50_000,
                    help="auto-compact when the delta holds more docs "
                         "than this")
    ps.add_argument("--auto-compact-deleted-frac", type=float, default=0.2,
                    help="auto-compact when more than this fraction of "
                         "docs is tombstoned")
    ps.add_argument("--mmap", action="store_true",
                    help="memory-map the index npy triplet at host load "
                         "(bm25s load(mmap=True) analog); host RAM stays "
                         "O(1) in index size")
    ps.add_argument("--result-cache", type=int, default=0, metavar="N",
                    help="LRU-cache up to N per-query results; repeat "
                         "queries skip the device entirely (0 = off; "
                         "invalidated on reload/add/delete/compact)")
    ps.set_defaults(fn=cmd_serve)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
