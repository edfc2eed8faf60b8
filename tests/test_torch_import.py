"""The port never imports JAX, and never picks the CPU by itself."""

import os
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

    class BlockJax:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib"):
                raise ImportError(f"{name} is blocked")

    sys.meta_path.insert(0, BlockJax())
    import numpy as np
    import torch
    import bm25_tpu_torch
    from bm25_tpu_torch import (DenseEngine, ReferenceEngine, Session,
                                create_engine, custom, top_k)
    from bm25_tpu_torch.bench import BenchConfig, make_synthetic_index
    from bm25_tpu_torch.entry import entry
    from bm25_tpu_torch.models import dense
    from bm25_tpu_torch.ops import gather_rows, registry, topk
    from bm25_tpu_torch.utils.parity import assert_matches_oracle

    cpu = Session("cpu")
    cfg = BenchConfig(num_docs=2000, vocab=300)
    index = make_synthetic_index(cfg)
    ref = ReferenceEngine.from_scored_index(index)
    q = np.random.default_rng(0).integers(-1, 300, (6, 8))
    engine = create_engine(index, mode="sparse", session=cpu, hot_tokens=16,
                           hot_budget_bytes=1 << 20, max_buckets=2)
    assert_matches_oracle(*engine.search(q, top_k=25), *ref.search(q, top_k=25))
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
    fn, args = entry(cpu)
    assert fn(*args)[1].shape == (4, 8)
    assert gather_rows.plain_calls["gather_add_rows"] > 0
    assert not any(m.split(".")[0] in ("jax", "jaxlib") for m in sys.modules)
    print("NO_JAX_OK")
""")


def test_port_runs_with_jax_blocked():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", BLOCKED_RUN], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "NO_JAX_OK" in res.stdout


def test_no_jax_import_in_sources():
    for root, _, files in os.walk(PKG):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(root, name)) as f:
                    src = f.read()
                assert "import jax" not in src and "from jax" not in src, name


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
