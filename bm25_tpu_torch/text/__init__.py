"""Host-side text processing: tokenization, stopwords, stemming (the
port's copy of ``bm25_tpu/text``, pure Python)."""

from bm25_tpu_torch.text.stopwords import STOPWORDS_EN, get_stopwords
from bm25_tpu_torch.text.tokenizer import TokenizedCorpus, Tokenizer, pad_token_lists

__all__ = [
    "STOPWORDS_EN", "get_stopwords",
    "TokenizedCorpus", "Tokenizer", "pad_token_lists",
]
