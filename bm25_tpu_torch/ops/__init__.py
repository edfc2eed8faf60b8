"""Kernels of the PyTorch port: hand-written CUDA for Hopper (``csrc/``),
each beside its plain PyTorch twin, and the top-k op library around them.

Importing this package registers the built-in ops with the registry.
"""

from bm25_tpu_torch.ops.registry import custom, get_op, list_ops, register_op
from bm25_tpu_torch.ops import gather_rows as _gather_rows  # noqa: F401
from bm25_tpu_torch.ops import topk as _topk  # noqa: F401

__all__ = ["custom", "get_op", "list_ops", "register_op"]
