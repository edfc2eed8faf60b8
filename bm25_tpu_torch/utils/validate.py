"""Shared engine input contract for batched queries.

Every engine family (dense, sparse, sharded, reference oracle) accepts the
same query surface: a 2-D integer array of token ids where negative ids are
padding (the contract of ``reference/bm25_native.py:108-121,151``),
optional per-token weights of the same shape, and ids bounded by the vocab.
One validator keeps the contract from drifting between engines.  The
port's copy of ``bm25_tpu/utils/validate.py``.
"""

from __future__ import annotations

import numpy as np


def validate_query_batch(
    queries,
    vocab_size: int,
    weights=None,
    weights_dtype=np.float32,
    oov: str = "raise",
) -> tuple[np.ndarray, np.ndarray | None]:
    """Validate a (Q, T) query batch against the shared engine contract.

    Checks: 2-D integer dtype, ``max(id) < vocab_size`` (negative ids are
    padding and always legal), and ``weights.shape == queries.shape`` when
    weights are given.  Returns ``(queries, weights)`` as ndarrays with
    weights cast to ``weights_dtype``.

    ``oov="raise"`` (default) treats an out-of-vocab id as a caller bug;
    ``oov="clamp"`` rewrites such ids to -1 (pad/OOV, contributes zero) —
    the tolerant contract engines under concurrent vocab growth need
    (an UpdatableEngine's vocab can lag a racing add's tokenization).
    """
    queries = np.asarray(queries)
    if queries.ndim != 2 or not np.issubdtype(queries.dtype, np.integer):
        raise ValueError("queries must be a 2-D integer array of token ids")
    if queries.size and int(queries.max()) >= vocab_size:
        if oov == "clamp":
            queries = np.where(queries < vocab_size, queries, -1)
        else:
            raise ValueError(
                f"max token id {int(queries.max())} out of range for vocab "
                f"of {vocab_size} tokens"
            )
    if weights is not None:
        weights = np.asarray(weights, dtype=weights_dtype)
        if weights.shape != queries.shape:
            raise ValueError(
                f"weights shape {weights.shape} != queries shape "
                f"{queries.shape}"
            )
    return queries, weights


def empty_results(q_n: int, k: int, ids_only: bool = False):
    """Degenerate search results: empty batch and/or k <= 0 (0-doc engine).

    Shaped (q_n, k_eff) so callers that concatenate per-batch results along
    axis 0 never hit a column mismatch on an empty batch, and a search
    against an empty engine returns zero columns instead of crashing in
    top-k selection.
    """
    docs = np.zeros((q_n, max(k, 0)), np.int32)
    if ids_only:
        return docs
    return docs, np.zeros((q_n, max(k, 0)), np.float32)
