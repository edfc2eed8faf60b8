"""Device mesh for doc-sharded BM25 serving — PyTorch counterpart of
``bm25_tpu/parallel/mesh.py``.

A 2-D logical mesh with

* ``data`` — query-batch data parallelism (each row serves its own slice
  of a query chunk);
* ``docs`` — index (doc-axis) sharding: every shard holds a slice of the
  score table or postings and scores its documents only; each shard's
  top-k candidates are gathered on the row's first device and merged
  there.

``Mesh`` is a (data, docs) grid of ``torch.device`` s plus the axis sizes
under ``shape``, so that ``mesh.shape[DOC_AXIS]`` reads as in JAX.  A grid
may name one device several times: ``[torch.device("cuda:0")] * 4`` puts
four doc shards on one card (they share its stream), and
``[torch.device("cpu")] * 8`` is the 8-shard mesh the CPU tests run: the
port's counterpart of JAX's ``jax_num_cpu_devices``.

In a process group (``parallel/distributed.py``) the doc axis spans the
ranks: each process's grid holds its own shards, and ``shape`` counts the
shards of every rank, as a JAX mesh over ``jax.devices()`` holds every
process's devices.  A data axis across processes is not supported.

JAX's ``index_sharding``, ``replicated`` and ``query_sharding`` name
``NamedSharding`` s for ``device_put``; the port places each shard's
tensors on its device itself (``parallel/sharded_engine.py::MeshTensor``),
so they have no counterpart.
"""

from __future__ import annotations

import numpy as np
import torch

DATA_AXIS = "data"
DOC_AXIS = "docs"


class Mesh:
    """A (data, docs) grid of this process's devices.

    ``devices[r, j]`` is the device of data row r and local doc shard j;
    the global index of local shard j is ``process_index * local_docs +
    j``.  ``shape`` maps each axis name to its global size."""

    def __init__(self, devices: np.ndarray, process_index: int = 0,
                 process_count: int = 1):
        if devices.ndim != 2 or devices.size == 0:
            raise ValueError(f"a mesh needs a non-empty (data, docs) grid, "
                             f"got shape {devices.shape}")
        if process_count > 1 and devices.shape[0] > 1:
            raise NotImplementedError(
                "a data axis across processes is not supported (ROADMAP.md: "
                "a data axis across processes)")
        self.devices = devices
        self.process_index = process_index
        self.process_count = process_count

    @property
    def shape(self) -> dict[str, int]:
        rows, cols = self.devices.shape
        return {DATA_AXIS: rows, DOC_AXIS: cols * self.process_count}

    @property
    def local_docs(self) -> int:
        """Doc shards this process holds."""
        return self.devices.shape[1]

    def shard_index(self, j: int) -> int:
        """Global doc-shard index of local shard ``j``."""
        return self.process_index * self.local_docs + j

    def distinct_devices(self) -> list[torch.device]:
        """Each device of the grid once, in grid order."""
        out: list[torch.device] = []
        for dev in self.devices.flat:
            if dev not in out:
                out.append(dev)
        return out

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, devices="
                f"{[[str(d) for d in row] for row in self.devices]}, "
                f"process {self.process_index}/{self.process_count})")


def make_mesh(
    n_devices: int | None = None,
    data: int | None = None,
    devices=None,
) -> Mesh:
    """Build a (data, docs) mesh over the first ``n_devices`` devices.

    By default all devices go to the ``docs`` axis (index sharding), the
    usual regime for corpora that exceed one card's memory.  Pass ``data``
    to split off query-parallel rows, e.g. ``make_mesh(8, data=2)`` -> 2x4.
    ``devices`` (any sequence of ``torch.device`` s or names, repeats
    allowed) replaces the default list: every visible CUDA device, or in a
    process group the rank's own card.  With no CUDA device and no
    ``devices`` it raises: it never falls back to the CPU.  In a process
    group ``n_devices`` counts the shards of every rank.
    """
    from bm25_tpu_torch.parallel.distributed import (local_devices,
                                                     process_info)

    pid, nproc = process_info()
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device is available; pass devices= "
                "(e.g. [torch.device('cpu')] * 8) to build a mesh elsewhere")
        devices = local_devices()
    devices = [_indexed(torch.device(d)) for d in devices]
    if n_devices is not None:
        if n_devices % nproc:
            raise ValueError(f"a {n_devices}-device mesh does not split over "
                             f"{nproc} processes")
        if len(devices) * nproc < n_devices:
            raise ValueError(
                f"requested a {n_devices}-device mesh but only "
                f"{len(devices) * nproc} devices are available")
        devices = devices[: n_devices // nproc]
    n = len(devices)
    data = data or 1
    if n % data != 0:
        raise ValueError(f"{n} devices not divisible by data={data}")
    grid = np.empty((data, n // data), dtype=object)
    for i, dev in enumerate(devices):
        grid[i // (n // data), i % (n // data)] = dev
    return Mesh(grid, process_index=pid, process_count=nproc)


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` as the card it names (``cuda:<current>``), so that one card
    is one device of the grid however it was named."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def default_mesh(session=None) -> Mesh:
    """The mesh an engine or the harness takes when none is given: every
    visible card, or the session's device alone where it is not a card
    (the CPU)."""
    if session is not None and session.device.type != "cuda":
        return make_mesh(devices=[session.device])
    return make_mesh()
