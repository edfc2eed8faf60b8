"""Device engines of the PyTorch port."""

from bm25_tpu_torch.models.auto import create_engine
from bm25_tpu_torch.models.dense import DenseEngine
from bm25_tpu_torch.models.sparse import SparseEngine

__all__ = ["DenseEngine", "SparseEngine", "create_engine"]
