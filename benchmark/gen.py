"""The benchmark's one generator: a seeded Zipf corpus and query set.

Every configuration and traffic mix is data (``configs/*.json``,
``traffic/*.json``); this module turns a configuration and a seed into the
inputs that both the program and the reference receive:

* per-document lengths and the flat token stream of the corpus;
* the query set, a (Q, T) int32 matrix padded with -1, each query of its
  own length.

The draws run on the given device with a ``torch.Generator`` in a few large
calls and come back to the host as numpy.  The corpus and the queries are
drawn once for the configuration (from ``SHAPE_SEED``), and token ids are
numbered once, by first occurrence in that corpus, as the port's tokenizer
and bm25s number them while they read it.  A run's seed only puts the
documents and the queries in its own order.  So every seed serves the same
work (the same documents, token ids, document frequencies and queries)
under other doc ids and in another order, and the answers differ from seed
to seed.  Tokens follow a Zipf law over the vocabulary's ranks; frequent
tokens, met early, get small ids.
"""

from __future__ import annotations

import numpy as np
import torch

# the configuration's own draws (lengths, tokens): the same for every seed
SHAPE_SEED = 20_240_414
# the run seed's stream that orders the queries, apart from the documents'
QUERY_ORDER = 1 << 40
# Zipf draws a call (f64 uniforms: 256 MiB a call)
DRAW_CHUNK = 1 << 25


def _generator(device: torch.device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def zipf_cdf(vocab: int, exponent: float, device) -> torch.Tensor:
    """(vocab,) float64 cumulative Zipf probabilities, rank 1 first."""
    ranks = torch.arange(1, vocab + 1, dtype=torch.float64, device=device)
    p = ranks.pow(-float(exponent))
    cdf = torch.cumsum(p, 0)
    return cdf / cdf[-1]


def zipf_tokens(cdf: torch.Tensor, n: int, g: torch.Generator) -> np.ndarray:
    """``n`` Zipf token ranks (int32, on the host) by inverse-CDF draws on
    ``cdf``'s device, in calls of ``DRAW_CHUNK``."""
    out = np.empty(n, np.int32)
    host = torch.from_numpy(out)
    vocab = cdf.shape[0]
    for lo in range(0, n, DRAW_CHUNK):
        hi = min(n, lo + DRAW_CHUNK)
        u = torch.rand(hi - lo, dtype=torch.float64, device=cdf.device,
                       generator=g)
        tok = torch.searchsorted(cdf, u).clamp_(max=vocab - 1)
        host[lo:hi].copy_(tok.to(torch.int32))
    return out


def _poisson_lengths(n: int, mean: float, lo: int, hi: int | None,
                     device, extra: int = 0) -> torch.Tensor:
    """``n`` lengths ``extra + Poisson(mean)`` clipped to [lo, hi], drawn
    from the configuration's fixed stream (``SHAPE_SEED``)."""
    g = _generator(device, SHAPE_SEED)
    rate = torch.full((n,), float(mean), dtype=torch.float32, device=device)
    lengths = torch.poisson(rate, generator=g).to(torch.int64) + extra
    return lengths.clamp_(min=lo, max=hi)


def _permutation(n: int, seed: int, device) -> torch.Tensor:
    """The seed's permutation of ``n`` (int64, on ``device``)."""
    return torch.randperm(n, generator=_generator(device, seed),
                          device=device)


def first_occurrence_ids(flat: torch.Tensor, vocab: int) -> torch.Tensor:
    """(vocab,) int32: each token's id in order of its first occurrence in
    ``flat``, as a tokenizer that builds its vocabulary while reading the
    corpus numbers them (``bm25_tpu_torch/text/tokenizer.py``, bm25s);
    tokens that never occur come last."""
    total = flat.shape[0]
    first = torch.full((vocab,), total, dtype=torch.int64, device=flat.device)
    first.scatter_reduce_(0, flat, torch.arange(total, device=flat.device),
                          "amin")
    ids = torch.empty(vocab, dtype=torch.int32, device=flat.device)
    ids[torch.argsort(first, stable=True)] = torch.arange(
        vocab, dtype=torch.int32, device=flat.device)
    return ids


def make_inputs(cfg: dict, seed: int, device):
    """``(doc_lengths (D,) int32, flat_tokens (sum of lengths,) int32,
    queries (Q, T) int32)`` for ``cfg`` at ``seed``.

    The configuration's corpus (Poisson lengths, Zipf tokens) and queries
    (lengths ``1 + Poisson(query_len_extra_mean)`` clipped to
    ``query_len_max``, Zipf tokens) are drawn from ``SHAPE_SEED``, token ids
    follow each token's first occurrence in that corpus, and the seed
    orders the documents and the queries.  Queries are padded with -1 to
    the longest."""
    device = torch.device(device)
    n, v, q = (int(cfg[k]) for k in ("num_docs", "vocab_size",
                                     "num_queries"))
    cdf = zipf_cdf(v, cfg["zipf_exponent"], device)
    lengths = _poisson_lengths(n, cfg["doc_len_mean"], int(cfg["doc_len_min"]),
                               None, device)
    total = int(lengths.sum())
    ranks = torch.from_numpy(zipf_tokens(
        cdf, total, _generator(device, SHAPE_SEED + 1))).to(device).long()
    ids = first_occurrence_ids(ranks, v)
    tokens = ids[ranks]
    del ranks
    order = _permutation(n, seed, device)
    new_len = lengths[order]
    src_start = torch.cumsum(lengths, 0) - lengths
    dst_start = torch.cumsum(new_len, 0) - new_len
    src = torch.repeat_interleave(src_start[order] - dst_start, new_len)
    src += torch.arange(total, device=device)
    flat = tokens[src].cpu().numpy()
    del tokens, src

    qlen = _poisson_lengths(q, cfg["query_len_extra_mean"], 1,
                            int(cfg["query_len_max"]), device,
                            extra=1).cpu().numpy()
    qtok = zipf_tokens(cdf, int(qlen.sum()), _generator(device,
                                                        SHAPE_SEED + 2))
    width = int(qlen.max())
    queries = np.full((q, width), -1, np.int32)
    queries[np.arange(width)[None, :] < qlen[:, None]] = \
        ids.cpu().numpy()[qtok]
    queries = queries[_permutation(q, seed + QUERY_ORDER, device).cpu()
                      .numpy()]
    return new_len.to(torch.int32).cpu().numpy(), flat, queries


def query_lengths(queries: np.ndarray) -> np.ndarray:
    """Each query's token count (its non-pad entries)."""
    return (queries >= 0).sum(axis=1)


def trim(queries: np.ndarray) -> np.ndarray:
    """The rows with the columns that are pad in every row cut off, as a
    caller tokenizing just these queries would pad them."""
    width = max(int(query_lengths(queries).max(initial=0)), 1)
    return np.ascontiguousarray(queries[:, :width])
