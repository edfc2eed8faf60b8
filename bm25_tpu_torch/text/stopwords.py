"""English stopword lists used by the tokenizer.

The reference pipeline (``reference/bm25_test.py:16``) tokenizes with
``bm25s.tokenize(corpus, stopwords="en", ...)``.  The observable behaviour on
the bundled ``animal_index_bm25`` corpus is: {is, and, to, the, that, in} are
dropped while {can} is kept (``reference/animal_index_bm25/
vocab.index.json`` keeps "can" at id 11).  ``STOPWORDS_EN`` below is a
standard ~127-word English list consistent with that behaviour; parity on the
bundled corpus is locked in by ``tests/test_text.py``.  The port's copy of
``bm25_tpu/text/stopwords.py``.
"""

from __future__ import annotations

STOPWORDS_EN: frozenset[str] = frozenset(
    (
        "a", "about", "above", "after", "again", "against", "all", "am",
        "an", "and", "any", "are", "as", "at", "be", "because", "been",
        "before", "being", "below", "between", "both", "but", "by", "could",
        "did", "do", "does", "doing", "down", "during", "each", "few",
        "for", "from", "further", "had", "has", "have", "having", "he",
        "her", "here", "hers", "herself", "him", "himself", "his", "how",
        "i", "if", "in", "into", "is", "it", "its", "itself", "just", "me",
        "more", "most", "my", "myself", "no", "nor", "not", "now", "of",
        "off", "on", "once", "only", "or", "other", "our", "ours",
        "ourselves", "out", "over", "own", "same", "she", "should", "so",
        "some", "such", "than", "that", "the", "their", "theirs", "them",
        "themselves", "then", "there", "these", "they", "this", "those",
        "through", "to", "too", "under", "until", "up", "very", "was", "we",
        "were", "what", "when", "where", "which", "while", "who", "whom",
        "why", "will", "with", "you", "your", "yours", "yourself",
        "yourselves",
    )
)

# Minimal Lucene/Snowball list, offered as an alternative preset.
STOPWORDS_LUCENE: frozenset[str] = frozenset(
    (
        "a", "an", "and", "are", "as", "at", "be", "but", "by", "for",
        "if", "in", "into", "is", "it", "no", "not", "of", "on", "or",
        "such", "that", "the", "their", "then", "there", "these", "they",
        "this", "to", "was", "will", "with",
    )
)

_PRESETS: dict[str, frozenset[str]] = {
    "en": STOPWORDS_EN,
    "english": STOPWORDS_EN,
    "lucene": STOPWORDS_LUCENE,
}


def get_stopwords(spec: str | list[str] | tuple[str, ...] | set[str] | frozenset[str] | None) -> frozenset[str]:
    """Resolve a stopword spec (preset name, explicit collection, or None)."""
    if spec is None:
        return frozenset()
    if isinstance(spec, str):
        try:
            return _PRESETS[spec.lower()]
        except KeyError:
            raise ValueError(
                f"Unknown stopword preset {spec!r}; available: {sorted(_PRESETS)}"
            ) from None
    return frozenset(w.lower() for w in spec)
