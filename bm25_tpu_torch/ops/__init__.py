"""Kernels of the PyTorch port: hand-written CUDA for Hopper (``csrc/``),
each beside its plain PyTorch twin, and the op library around them.

Importing this package registers every built-in op with the registry, as
importing ``bm25_tpu.ops`` does, and exports the same public names.
Signatures differ from JAX's only where the port says so in the op's
docstring: ``arange`` takes a ``device``, ``gather_reduce``'s callable
takes ``dim=``, ``matmul``'s tile arguments choose among the CUDA tiles,
and indices are int64.  As in ``bm25_tpu.ops``, the functions
``ell_score`` and ``matmul`` take their modules' names here: reach the
modules with ``importlib.import_module("bm25_tpu_torch.ops.matmul")``.
"""

from bm25_tpu_torch.ops.registry import custom, get_op, list_ops, register_op

# importing each op module registers its ops
from bm25_tpu_torch.ops.ell_score import ell_score
from bm25_tpu_torch.ops.gather_rows import gather_add_rows
from bm25_tpu_torch.ops.topk import (
    select_top_k,
    top_k,
    top_k_blockwise,
    top_k_fused_sampling,
    top_k_tree,
)
from bm25_tpu_torch.ops.gather_scatter import (
    gather,
    gather_elements,
    gather_nd,
    gather_nd_shape,
    gather_reduce,
    gather_shape,
    scatter_elements,
    scatter_nd,
    scatter_nd_shape,
)
from bm25_tpu_torch.ops.matmul import matmul
from bm25_tpu_torch.ops.shape_ops import (arange, arange_shape, reshape,
                                          reshape_shape)

__all__ = [
    "custom", "get_op", "list_ops", "register_op",
    "top_k", "top_k_fused_sampling", "top_k_blockwise", "top_k_tree",
    "select_top_k", "ell_score", "gather_add_rows",
    "gather", "gather_elements", "gather_nd", "gather_nd_shape",
    "gather_reduce", "gather_shape",
    "scatter_elements", "scatter_nd", "scatter_nd_shape",
    "matmul", "arange", "arange_shape", "reshape", "reshape_shape",
]
