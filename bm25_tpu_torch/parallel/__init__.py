"""Multi-device serving: mesh construction, doc-sharded engines,
multi-process groups — PyTorch counterpart of ``bm25_tpu/parallel``."""

from bm25_tpu_torch.parallel.mesh import DATA_AXIS, DOC_AXIS, make_mesh
from bm25_tpu_torch.parallel.sharded_engine import (ShardedEngine,
                                                    ShardedSparseEngine)

__all__ = [
    "DATA_AXIS", "DOC_AXIS", "make_mesh",
    "ShardedEngine", "ShardedSparseEngine",
]
