"""The port never imports JAX or the JAX package ``bm25_tpu``, and never
picks the CPU by itself."""

import os
import re
import subprocess
import sys
import textwrap

import pytest
import torch

from bm25_tpu_torch import Session, get_session

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "bm25_tpu_torch")

BLOCKED_RUN = textwrap.dedent("""
    import sys

    BLOCKED = ("jax", "jaxlib", "bm25_tpu", "nltk")

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{name} is blocked")

    sys.meta_path.insert(0, Block())
    import numpy as np
    import torch
    import bm25_tpu_torch
    from bm25_tpu_torch import (DenseEngine, ReferenceEngine, Retriever,
                                Session, Tokenizer, create_engine, custom,
                                top_k)
    from bm25_tpu_torch.bench import BenchConfig, make_synthetic_index
    from bm25_tpu_torch.bench.gather_bench import bench_gather
    from bm25_tpu_torch.bench.matmul_bench import bench_matmul
    from bm25_tpu_torch.eval import engine_device_bytes
    from bm25_tpu_torch.entry import entry
    from bm25_tpu_torch.models import dense
    from bm25_tpu_torch.ops import (gather_rows, gather_scatter, registry,
                                    shape_ops, super_row_gather, topk)
    from bm25_tpu_torch.ops.matmul import launches, plain_calls
    from bm25_tpu_torch.utils.parity import assert_matches_oracle
    from bm25_tpu_torch.bench.matmul_schedules import bench_schedules
    from bm25_tpu_torch.cli.main import main as cli_main
    from bm25_tpu_torch.compat import BM25, BM25v
    from bm25_tpu_torch.datasets import evaluate_dataset, synthetic_beir_dataset
    from bm25_tpu_torch.ops import matmul_schedules

    cpu = Session("cpu")
    cfg = BenchConfig(num_docs=2000, vocab=300)
    index = make_synthetic_index(cfg)
    ref = ReferenceEngine.from_scored_index(index)
    q = np.random.default_rng(0).integers(-1, 300, (6, 8))
    engine = create_engine(index, mode="sparse", session=cpu, hot_tokens=16,
                           hot_budget_bytes=1 << 20, max_buckets=2)
    assert_matches_oracle(*engine.search(q, top_k=25), *ref.search(q, top_k=25))
    w = np.random.default_rng(1).uniform(0.1, 3.0, q.shape).astype(np.float32)
    assert_matches_oracle(*engine.search(q, top_k=25, weights=w),
                          *ref.search(q, top_k=25, weights=w))
    assert np.allclose(engine.get_scores(q[1]), ref.get_scores(q[1]),
                       rtol=2e-5, atol=1e-5)
    engine = create_engine(index, session=cpu, dense_budget_bytes=1 << 30)
    assert isinstance(engine, dense.DenseEngine)
    assert_matches_oracle(*engine.search(q, top_k=25), *ref.search(q, top_k=25))
    x = torch.rand((3, 500), generator=torch.Generator().manual_seed(0))
    v, i = top_k(x, 5, implementation="pallas")
    assert torch.equal(i, custom("top_k", x, 5)[1])
    assert torch.equal(i, topk.top_k_blockwise(x, 5)[1])
    _, s = topk.top_k_fused_sampling(x, 5, implementation="pallas",
                                     generator=torch.Generator())
    assert bool((s == i).any(dim=1).all())
    assert "gather_add_rows" in registry.list_ops()
    a = torch.rand((5, 7), generator=torch.Generator().manual_seed(1))
    c = custom("matrix_multiplication", a, a.T.contiguous(), algorithm="naive")
    assert c.shape == (5, 5) and plain_calls["matmul"] == 1
    assert not any(launches.values())
    assert len(bench_matmul(4, 4, 4, iters=1, device="cpu", log=len)) == 3
    assert custom("arange", 4, device="cpu").tolist() == [0, 1, 2, 3]
    assert custom("gather", a, torch.tensor([4, -1])).shape == (2, 7)
    assert custom("scatter_nd", a, torch.tensor([[0]]),
                  torch.ones(1, 7))[0].eq(1).all()
    assert gather_scatter.gather_shape((5, 7), (2,)) == (2, 7)
    assert shape_ops.reshape(a, (-1,)).shape == (35,)
    gpos, ok = custom("union_group_select", [x], 2)
    assert gpos.shape == (3, 2) and ok.dim() == 0
    fn, args = entry(cpu)
    assert fn(*args)[1].shape == (4, 8)
    assert gather_rows.plain_calls["gather_add_rows"] > 0
    texts = ["a cat likes to purr", "the dog barks", "fish swim in water"]
    r = Retriever.fit(texts, session=cpu)
    assert isinstance(r.engine, DenseEngine) and engine_device_bytes(r.engine)
    docs, _ = r.retrieve(["cat purr", "dog"], k=2)
    assert docs[:, 0].tolist() == [0, 1]
    for experiment in ("pallas_gather", "window_gather", "dyngather"):
        assert bench_gather(experiment, "cpu", q=2, n=8192, k=20, kp=32,
                            iters=1, log=len)
    assert super_row_gather.plain_calls["super_row_gather"] > 0
    assert not any(super_row_gather.launches.values())
    assert len(bench_schedules([8], iters=1, device="cpu", log=len)) == 28
    assert not any(matmul_schedules.launches.values())
    assert cli_main(["--device", "cpu", "demo", "-k", "1"]) == 0
    bm25 = BM25(session=cpu)
    bm25.fit([t.split() for t in texts])
    assert bm25.get_top_n(["dog"], texts, n=1)[0][1] == "the dog barks"
    ds = synthetic_beir_dataset(num_docs=200, num_queries=4, vocab=500,
                                avg_len=10)
    assert evaluate_dataset(ds, top_k=5, log=len, session=cpu)["num_queries"]
    import json, os, tempfile, urllib.request
    from bm25_tpu_torch import Server, build_index
    from bm25_tpu_torch.index.updates import UpdatableRetriever
    from bm25_tpu_torch.runtime.health import device_probe, engine_probe
    from bm25_tpu_torch.runtime.profiling import compile_phase_collector
    with tempfile.TemporaryDirectory() as d:
        build_index(texts, save_to=d)
        srv = Server(d, port=0, engine_kwargs={"session": cpu},
                     updatable=True, warmup_top_k=2)
        srv.start_background()
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.port}/search",
                data=json.dumps({"queries": ["dog barks"],
                                 "top_k": 1}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                out = json.loads(r.read())
            assert out["results"][0][0]["text"] == "the dog barks"
        finally:
            srv.shutdown()
    assert device_probe("cpu").ok
    assert engine_probe(engine).ok
    with compile_phase_collector() as phases:
        pass
    assert set(phases) == {"nvcc_build_s", "native_build_s", "library_load_s"}
    u = UpdatableRetriever.fit(texts, engine_kwargs={"session": cpu})
    u.add_documents(["a cat chases the dog"])
    assert u.retrieve(["chases"], k=1)[0][0, 0] == 3
    from bm25_tpu_torch import (StreamingIndexBuilder, load_device_checkpoint,
                                load_snapshot, save_device_checkpoint,
                                save_snapshot)
    from bm25_tpu_torch.runtime.cache import cache_info, environment_fingerprint
    from bm25_tpu_torch.runtime.warmup import warm_engine
    sparse = create_engine(index, mode="sparse", session=cpu, hot_tokens=16,
                           hot_budget_bytes=1 << 20, max_buckets=2)
    with tempfile.TemporaryDirectory() as d:
        save_device_checkpoint(os.path.join(d, "ck"), sparse)
        back = load_device_checkpoint(os.path.join(d, "ck"), session=cpu)
        assert np.array_equal(back.search(q, top_k=5)[0],
                              sparse.search(q, top_k=5)[0])
        save_snapshot(os.path.join(d, "snap"), index)
        assert load_snapshot(os.path.join(d, "snap")).nnz == index.nnz
        assert cache_info(d)["entries"] == 3
    assert environment_fingerprint()["torch"] == torch.__version__
    assert len(warm_engine(back, top_ks=(3,), batch_sizes=(1,),
                           routed_batch=8)) == 2
    sb = StreamingIndexBuilder()
    sb.add(texts)
    streamed = sb.finalize()[0]
    assert streamed.num_docs == 3
    built, _ = build_index(texts)
    assert streamed.vocab == built.vocab
    assert np.array_equal(streamed.data, built.data)
    # the default text path without nltk: the port's native stemmer and
    # library, built under the port's build directory
    from bm25_tpu_torch.native import loader
    from bm25_tpu_torch.ops import _build
    tok = Tokenizer()
    assert tok.words("Running felines purr") == ["run", "felin", "purr"]
    assert tok.tokenize_corpus(["Über cafés", "cats"]).vocab == {
        "über": 0, "café": 1, "cat": 2}
    lib = loader.get().path
    assert os.path.dirname(lib) == _build.build_dir()
    assert os.path.basename(lib).startswith("libbm25text-")
    assert not lib.startswith(os.path.join(os.getcwd(), "bm25_tpu") + os.sep)
    import bm25_tpu_torch.parallel
    from bm25_tpu_torch import ShardedEngine, ShardedSparseEngine
    from bm25_tpu_torch.entry import dryrun_multichip
    from bm25_tpu_torch.parallel import (_dryrun_main, _multihost_main,
                                         distributed, make_mesh, mesh,
                                         sharded_engine)
    mesh4 = make_mesh(4, data=2, devices=[cpu.device] * 4)
    for mode in ("sharded", "sharded_sparse"):
        sh = create_engine(index, mode=mode, mesh=mesh4)
        assert_matches_oracle(*sh.search(q, top_k=25),
                              *ref.search(q, top_k=25))
    assert isinstance(sh, ShardedSparseEngine) and engine_device_bytes(sh)
    dryrun_multichip(2, device="cpu")
    assert distributed.process_info() == (0, 1)
    assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
    print("NO_JAX_OK")
""")


def test_port_runs_with_jax_blocked():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", BLOCKED_RUN], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "NO_JAX_OK" in res.stdout


# an import of jax, or of bm25_tpu but not bm25_tpu_torch
FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|bm25_tpu(?!_torch))\b", re.MULTILINE)


def test_no_jax_import_in_sources():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        paths += [os.path.join(root, n) for n in files if n.endswith(".py")]
    for path in paths:
        with open(path) as f:
            src = f.read()
        assert not FORBIDDEN.search(src), (path, FORBIDDEN.findall(src))
    assert FORBIDDEN.search("    from bm25_tpu.eval import x")
    assert FORBIDDEN.search("import bm25_tpu")
    assert not FORBIDDEN.search("from bm25_tpu_torch import eval")


def test_session_never_falls_back_to_cpu():
    if torch.cuda.is_available():
        assert Session().device.type == "cuda"
        assert get_session().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            Session()
        with pytest.raises(RuntimeError, match="CUDA"):
            get_session()
    assert Session("cpu").device == torch.device("cpu")
    with pytest.raises(ValueError):
        Session("meta")
    # nor does a mesh: with no devices given it takes the cards or raises
    from bm25_tpu_torch.parallel.mesh import make_mesh

    if torch.cuda.is_available():
        assert make_mesh().devices.flat[0].type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
