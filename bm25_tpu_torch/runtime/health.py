"""Device/engine health checks — serving-side failure detection.

The port's copy of ``bm25_tpu/runtime/health.py``.  ``device_probe`` runs
a small known computation on an explicit device and verifies the numeric
result (catching a wedged card or a lost context), ``engine_probe`` runs a
fixed query through the full engine path and checks the invariants that
hold for any index (sorted scores, in-range doc ids).  serve.py exposes
both through /healthz?deep=1.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class ProbeResult:
    ok: bool
    latency_ms: float
    detail: str = ""

    def as_dict(self) -> dict:
        return {"ok": self.ok, "latency_ms": round(self.latency_ms, 2),
                "detail": self.detail}


def device_probe(device=None) -> ProbeResult:
    """Run a tiny matmul on ``device`` and verify the result numerically.

    ``device`` None probes the default session's device (``cuda``; where
    there is none the probe fails, it never probes the CPU instead).  The
    probe waits for the device before reading the result and reports a
    failure in its result rather than raising.
    """
    t0 = time.perf_counter()
    try:
        if device is None:
            from bm25_tpu_torch.runtime.session import get_session

            device = get_session().device
        device = torch.device(device)
        a = torch.full((8, 128), 2.0, device=device)
        b = torch.full((128, 128), 3.0, device=device)
        c = torch.matmul(a, b)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        out = float(c[0, 0])
        ok = abs(out - 2.0 * 3.0 * 128) < 1e-3
        return ProbeResult(ok=ok, latency_ms=(time.perf_counter() - t0) * 1e3,
                           detail="" if ok else f"bad result {out}")
    except Exception as e:  # noqa: BLE001 - a probe must not raise
        return ProbeResult(ok=False, latency_ms=(time.perf_counter() - t0) * 1e3,
                           detail=f"{type(e).__name__}: {e}")


def engine_probe(engine, num_tokens: int = 2) -> ProbeResult:
    """Run one fixed query through the engine; check structural invariants."""
    t0 = time.perf_counter()
    try:
        ids = np.zeros((1, num_tokens), dtype=np.int32)
        docs, scores = engine.search(ids, top_k=min(3, engine.num_docs))
        ok = (
            docs.shape == scores.shape
            and (np.diff(scores[0]) <= 1e-6).all()  # sorted descending
            and int(docs.max(initial=0)) < engine.num_docs
            and int(docs.min(initial=0)) >= 0
            and np.isfinite(scores).all()
        )
        return ProbeResult(ok=bool(ok), latency_ms=(time.perf_counter() - t0) * 1e3,
                           detail="" if ok else "invariant violation")
    except Exception as e:  # noqa: BLE001
        return ProbeResult(ok=False, latency_ms=(time.perf_counter() - t0) * 1e3,
                           detail=f"{type(e).__name__}: {e}")
