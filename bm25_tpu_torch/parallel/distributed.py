"""Multi-process initialization and doc-shard planning — PyTorch
counterpart of ``bm25_tpu/parallel/distributed.py``.

``initialize`` joins a ``torch.distributed`` process group; in a group the
doc axis of a mesh spans the ranks (``parallel/mesh.py``), each rank builds
and holds only its own shards, and the sharded engines gather every rank's
candidates with ``all_gather_shards`` before the same replicated merge.
``DocShardPlan`` is the host-level plan of a streaming build in which each
process scores its own document range.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch

# Environment markers of a managed multi-process launch, beside torchrun's
# WORLD_SIZE.  JAX's TPU markers (TPU_WORKER_HOSTNAMES,
# MEGASCALE_COORDINATOR_ADDRESS) name TPU pod slices and have no
# counterpart here.
_CLUSTER_ENVS = (
    "SLURM_NTASKS",
    "OMPI_COMM_WORLD_SIZE",
)
_RANK_ENVS = ("RANK", "SLURM_PROCID", "OMPI_COMM_WORLD_RANK")


def _cluster_detected() -> bool:
    procs = os.environ.get("WORLD_SIZE")
    if procs is not None:
        return int(procs) > 1
    return any(int(os.environ.get(key) or 0) > 1 for key in _CLUSTER_ENVS)


def _env_int(keys, default=None):
    for key in keys:
        val = os.environ.get(key)
        if val:
            return int(val)
    return default


def default_backend(num_processes: int) -> str:
    """NCCL where every rank of this host has a card of its own (NCCL
    refuses two ranks on one device), else gloo."""
    local = _env_int(("LOCAL_WORLD_SIZE",), num_processes)
    if torch.cuda.is_available() and torch.cuda.device_count() >= local:
        return "nccl"
    return "gloo"


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
) -> None:
    """Join a ``torch.distributed`` process group (no-op for one process).

    With no arguments a managed launch is detected from torchrun's
    ``WORLD_SIZE``, Slurm's ``SLURM_NTASKS`` or OpenMPI's
    ``OMPI_COMM_WORLD_SIZE`` (rank from ``RANK``, ``SLURM_PROCID`` or
    ``OMPI_COMM_WORLD_RANK``, the address from ``MASTER_ADDR`` /
    ``MASTER_PORT``); on a plain single process this is a no-op.  Pass
    ``coordinator_address`` ("host:port"), ``num_processes`` and
    ``process_id`` for a group the detection does not cover.  ``backend``
    defaults to ``default_backend``'s choice.
    """
    import torch.distributed as dist

    if (num_processes is None and coordinator_address is None
            and not _cluster_detected()):
        return  # single process: nothing to do
    world = num_processes or _env_int(("WORLD_SIZE",) + _CLUSTER_ENVS)
    rank = process_id if process_id is not None else _env_int(_RANK_ENVS, 0)
    if world is None:
        raise ValueError("initialize: num_processes is not given and no "
                         "launcher set WORLD_SIZE")
    init = ("env://" if coordinator_address is None
            else f"tcp://{coordinator_address}")
    dist.init_process_group(
        backend or default_backend(world), init_method=init,
        world_size=world, rank=rank)


def process_info() -> tuple[int, int]:
    """(rank, world size) of this process; (0, 1) outside a group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_devices() -> list[torch.device]:
    """The CUDA devices a default mesh takes: every visible card in one
    process; in a group, the rank's own card (``LOCAL_RANK``, else the
    rank, modulo the cards: ranks share a card where there are fewer)."""
    count = torch.cuda.device_count()
    rank, world = process_info()
    if world == 1:
        return [torch.device("cuda", i) for i in range(count)]
    local = _env_int(("LOCAL_RANK",), rank)
    return [torch.device("cuda", local % count)]


def all_gather_shards(x: torch.Tensor) -> torch.Tensor:
    """(local shards, ...) stacked per rank -> (every shard, ...) in rank
    order, which is global shard order; ``x`` itself outside a group.
    The tensor goes to the collective on its own device: gloo takes CUDA
    tensors (staging them through host memory itself) and NCCL needs
    them."""
    import torch.distributed as dist

    rank, world = process_info()
    if world == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts, dim=0)


@dataclass(frozen=True)
class DocShardPlan:
    """Contiguous doc-range assignment of a corpus across hosts/devices.

    Build-time: host h tokenizes+scores docs [host_start, host_end).
    Serve-time: global device d owns docs [doc_start(d), doc_end(d)).
    """

    num_docs: int
    num_hosts: int
    num_devices_global: int

    def host_range(self, host: int) -> tuple[int, int]:
        per = -(-self.num_docs // self.num_hosts)
        return min(host * per, self.num_docs), min((host + 1) * per, self.num_docs)

    def device_range(self, device: int) -> tuple[int, int]:
        per = -(-self.num_docs // self.num_devices_global)
        return (
            min(device * per, self.num_docs),
            min((device + 1) * per, self.num_docs),
        )


def make_plan(num_docs: int) -> DocShardPlan:
    """The plan over this group's processes and the devices a default
    mesh takes on each (one where there is no CUDA device)."""
    _rank, world = process_info()
    per = len(local_devices()) if torch.cuda.is_available() else 1
    return DocShardPlan(
        num_docs=num_docs,
        num_hosts=world,
        num_devices_global=world * max(per, 1),
    )
