"""Index build, persistence (bm25s format) and merging: the port's copy of
``bm25_tpu/index`` (snapshots, streaming and live updates are not ported
yet)."""

from bm25_tpu_torch.index.builder import BuildStats, build_index
from bm25_tpu_torch.index.io import MMapCorpus, load_index, save_corpus, save_index

__all__ = [
    "BuildStats", "build_index",
    "MMapCorpus", "load_index", "save_corpus", "save_index",
]
