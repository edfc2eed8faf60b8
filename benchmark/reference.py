"""The benchmark's plain BM25 reference, in plain torch (and numpy).

It recomputes BM25 from the generated tokens, independently of the program:
its own postings (one sort of the (token, doc) pairs), its own document
frequencies, idf and length norms, and a dense score vector a query.  The
scoring is bm25s's ``lucene`` method, the default of bm25s and of the
reference index's ``params.index.json``:

    idf(t)   = ln(1 + (N - df + 0.5) / (df + 0.5))
    score    = sum over the query's tokens t of idf(t) * tf / (tf + k1 * norm)
    norm(d)  = 1 - b + b * dl(d) / avgdl

with bm25s's roundings: idf and norm in float64, rounded to the score type
before the per-posting product; tf / (tf + k1 * norm) and the product in the
score type; a query's contributions summed in its token order (a repeated
token counts each time).  ``dtype=torch.bfloat16`` computes every step in
bfloat16: that is the control, the precision below the float32 that the
configuration states.

It imports nothing of the program, of JAX or of the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch


class Bm25Reference:
    """Postings and per-posting scores of a corpus, built on ``device``.

    ``doc_lengths`` (D,) and ``flat_tokens`` (sum of lengths,) are the
    generator's arrays, token ids in [0, vocab_size)."""

    def __init__(self, doc_lengths: np.ndarray, flat_tokens: np.ndarray,
                 vocab_size: int, k1: float = 1.5, b: float = 0.75,
                 device="cpu", dtype=torch.float32):
        device = torch.device(device)
        self.device, self.dtype = device, dtype
        self.num_docs = n = len(doc_lengths)
        self.vocab_size = v = int(vocab_size)
        dl = torch.from_numpy(np.asarray(doc_lengths, np.int64)).to(device)
        avgdl = float(dl.sum().item()) / n if n else 0.0
        # (token, doc) keys of every token occurrence; one sort groups
        # them by token, then by doc, and runs give tf
        doc_of = torch.repeat_interleave(torch.arange(n, device=device), dl)
        tok = torch.from_numpy(np.asarray(flat_tokens, np.int32)).to(device)
        keys = tok.to(torch.int64) * n + doc_of
        del doc_of, tok
        keys, tf = torch.unique(keys, sorted=True, return_counts=True)
        post_tok = keys // n
        self.post_doc = (keys - post_tok * n).to(torch.int32)
        del keys
        df = torch.bincount(post_tok, minlength=v)
        self.indptr = torch.zeros(v + 1, dtype=torch.int64, device=device)
        self.indptr[1:] = torch.cumsum(df, 0)
        self.indptr_host = self.indptr.cpu().numpy()
        self.df = df
        idf64 = torch.log(1.0 + (n - df.double() + 0.5) / (df.double() + 0.5))
        if avgdl > 0:
            norm64 = 1.0 - b + b * (dl.double() / avgdl)
        else:
            norm64 = torch.full((n,), 1.0 - b, dtype=torch.float64,
                                device=device)
        norm = norm64.to(dtype)[self.post_doc.long()]
        tf = tf.to(dtype)
        sat = tf / (tf + norm * torch.tensor(k1, dtype=dtype))
        del norm
        self.post_score = idf64.to(dtype)[post_tok] * sat
        del post_tok, sat, tf

    def scores(self, query: np.ndarray) -> torch.Tensor:
        """(D,) scores of one query (its token ids; -1 pads ignored)."""
        out = torch.zeros(self.num_docs, dtype=self.dtype, device=self.device)
        ptr = self.indptr_host
        for t in (int(t) for t in np.asarray(query) if t >= 0):
            lo, hi = int(ptr[t]), int(ptr[t + 1])
            if hi > lo:
                out.index_add_(0, self.post_doc[lo:hi].long(),
                               self.post_score[lo:hi])
        return out

    def top_k(self, query: np.ndarray, k: int
              ) -> tuple[np.ndarray, np.ndarray]:
        """``(docs (k,) int64, scores (k,) float32)``: the query's k best,
        scores descending (ties in any order)."""
        s = self.scores(query)
        top = torch.topk(s.float(), min(k, self.num_docs))
        return top.indices.cpu().numpy(), top.values.cpu().numpy()

    def judge(self, query: np.ndarray, docs: np.ndarray, k: int
              ) -> tuple[np.ndarray, np.ndarray]:
        """What the comparison needs of one query: ``(best, of_docs)``, the
        reference's k best scores, descending, and its scores of the given
        doc ids (ids outside [0, D) read NaN)."""
        s = self.scores(query).float()
        best = torch.topk(s, min(k, self.num_docs)).values.cpu().numpy()
        docs = np.asarray(docs, np.int64)
        ok = (docs >= 0) & (docs < self.num_docs)
        of = np.full(docs.shape, np.nan, np.float32)
        if ok.any():
            idx = torch.from_numpy(docs[ok]).to(self.device)
            of[ok] = s[idx].cpu().numpy()
        return best, of
