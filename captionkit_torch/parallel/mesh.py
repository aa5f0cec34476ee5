"""Data parallelism over ``torch.distributed`` (``captionkit.parallel.mesh``).

The reference is pure data parallelism on a ``jax.sharding`` mesh: the
parameters, optimizer state and scalars are replicated, every array whose
first axis is the global batch is split over every mesh axis (a 2-level
``('dcn', 'ici')`` mesh is still one flat split), and XLA inserts the
gradient sum. Here a mesh is one process per rank, each with its own
device, and the steps call the collectives below themselves:

* rank r takes the r-th contiguous 1/W of every global batch's rows
  (``shard_batch_arrays``; on axis 1 of a ``[k, B, ...]`` pack), as
  ``PartitionSpec('data')`` places them;
* ``all_reduce_`` sums a list of tensors through one flat buffer (the
  gradients, with the step's metric sums appended);
* ``broadcast_`` copies rank 0's tensors to every rank (the initial
  parameters and optimizer state);
* ``host_sum``, ``host_max`` and ``gather_rows`` work on host values
  (reward metrics, the preemption flag and bucket widths, decoded token
  rows), always over gloo;
* ``barrier`` orders the file writes of rank 0 before the other ranks'
  reads.

The device collectives run on NCCL when the ranks' devices are ``cuda``
and on gloo when they are the CPU; gloo with CUDA tensors only when the
caller names it (``backend="gloo"``: two ranks sharing one card, which
NCCL refuses). A world of one (``make_mesh`` without ``ranks``) has no
process group and every collective is the identity.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from captionkit_torch.device import resolve_device

log = logging.getLogger(__name__)


@dataclass(frozen=True)
class Ranks:
    """The processes of a run, seen from one of them: their number, this
    one's rank and device, and the process groups (None for a world of
    one). ``group`` carries the device tensors' collectives, ``host_group``
    (gloo) the host tensors'."""

    size: int
    rank: int
    device: torch.device
    backend: Optional[str] = None
    group: Any = None
    host_group: Any = None


def init_ranks(init_method: str, world_size: int, rank: int,
               device: "str | torch.device" = "cuda", *,
               backend: Optional[str] = None) -> Ranks:
    """Start the process group of rank ``rank`` of ``world_size`` at
    ``init_method`` (``env://``, ``tcp://host:port``, ``file:///path``).

    ``device="cuda"`` binds ``cuda:{rank % device_count}`` and logs it;
    its collectives run on NCCL unless ``backend="gloo"`` is named. The
    CPU takes gloo; NCCL on the CPU raises."""
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside a world of {world_size}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        log.info("rank %d of %d binds %s", rank, world_size, dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("NCCL needs CUDA devices; the CPU takes gloo")
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank)
    group = dist.group.WORLD
    host = group if backend == "gloo" else dist.new_group(backend="gloo")
    return Ranks(size=world_size, rank=rank, device=dev, backend=backend,
                 group=group, host_group=host)


def close_ranks(ranks: Ranks) -> None:
    """End the process group that ``init_ranks`` started."""
    if ranks.group is not None:
        dist.destroy_process_group()


@dataclass(frozen=True)
class Mesh:
    """The ranks arranged as ``shape`` under ``axis_names``: pure data
    parallelism, the batch split over every axis in row-major rank order."""

    shape: tuple[int, ...]
    axis_names: tuple[str, ...]
    ranks: Ranks

    @property
    def size(self) -> int:
        return self.ranks.size

    @property
    def rank(self) -> int:
        return self.ranks.rank

    @property
    def device(self) -> torch.device:
        return self.ranks.device

    @property
    def share(self) -> tuple[int, int]:
        """(this rank, the number of ranks): the share of every global
        batch this process takes (``data.pipeline.make_batches``)."""
        return self.ranks.rank, self.ranks.size

    @property
    def is_main(self) -> bool:
        """Rank 0: the one that writes checkpoints, logs and exports."""
        return self.ranks.rank == 0


def make_mesh(shape: Sequence[int] = (-1,),
              axis_names: Sequence[str] = ("data",), *,
              ranks: Optional[Ranks] = None,
              device: "str | torch.device | None" = None) -> Mesh:
    """A mesh over ``ranks`` (``init_ranks``), or over a world of one on
    ``device`` (default the card) with no process group. -1 in ``shape``
    absorbs the remaining ranks. The shape must cover the world: a rank
    outside the mesh would have no rows to take."""
    if ranks is None:
        ranks = Ranks(size=1, rank=0, device=resolve_device(device or "cuda"))
    elif device is not None and torch.device(device) != ranks.device:
        raise ValueError(
            f"device {device} differs from the rank's device {ranks.device}")
    shape = list(shape)
    if len(shape) != len(tuple(axis_names)):
        raise ValueError(f"mesh shape {tuple(shape)} and axis names "
                         f"{tuple(axis_names)} differ in length")
    known = int(np.prod([s for s in shape if s != -1])) if shape else 1
    if -1 in shape:
        if ranks.size % known:
            raise ValueError(f"{ranks.size} devices not divisible by fixed "
                             f"mesh dims {shape}")
        shape[shape.index(-1)] = ranks.size // known
    total = int(np.prod(shape))
    if total > ranks.size:
        raise ValueError(f"mesh shape {tuple(shape)} needs {total} devices, "
                         f"have {ranks.size}")
    if total < ranks.size:
        raise ValueError(f"mesh shape {tuple(shape)} covers {total} of "
                         f"{ranks.size} ranks")
    return Mesh(tuple(shape), tuple(axis_names), ranks)


@dataclass(frozen=True)
class Sharding:
    """Where a batch array lives on the mesh: ``axis`` is the global batch
    axis, split over the ranks. (Parameters, optimizer state and scalars
    are whole on every rank: ``broadcast_`` makes them rank 0's.)"""

    mesh: Mesh
    axis: int

    def place(self, x) -> Optional[torch.Tensor]:
        """This rank's part of ``x`` (numpy or tensor) on its device."""
        if x is None:
            return None
        t = x if isinstance(x, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(x))
        t = t.narrow(self.axis, *rank_rows(self.mesh, t.shape[self.axis]))
        return t.to(self.mesh.device, non_blocking=True)


def batch_sharding(mesh: Mesh) -> Sharding:
    """Arrays whose leading axis is the global batch."""
    return Sharding(mesh, 0)


def stacked_batch_sharding(mesh: Mesh) -> Sharding:
    """k-step packs ``[k, B, ...]``: the batch is axis 1."""
    return Sharding(mesh, 1)


def rank_rows(mesh: Mesh, n: int) -> tuple[int, int]:
    """(start, length) of this rank's rows of a global batch of ``n``."""
    if n % mesh.size:
        raise ValueError(f"a batch of {n} rows does not split evenly over "
                         f"W = {mesh.size} ranks")
    per = n // mesh.size
    return mesh.rank * per, per


def shard_batch_arrays(mesh: Mesh, tree: Any, *, stacked: bool = False
                       ) -> Any:
    """Every array leaf of ``tree`` (dicts, tuples and lists of arrays;
    None passes through) as this rank's rows on its device: the leading
    axis, or with ``stacked`` the second (the first is the pack's)."""
    sh = stacked_batch_sharding(mesh) if stacked else batch_sharding(mesh)

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(walk(v) for v in x)
        return sh.place(x)

    return walk(tree)


def all_reduce_(mesh: Mesh, tensors: Sequence[torch.Tensor]
                ) -> Sequence[torch.Tensor]:
    """Sum ``tensors`` (one dtype, on the rank's device) over the ranks, in
    place, through one flat buffer: one collective for the whole list."""
    if mesh.ranks.group is None or not tensors:
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.ranks.group)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n
    return tensors


def broadcast_(mesh: Mesh, tensors: Sequence[torch.Tensor]
               ) -> Sequence[torch.Tensor]:
    """Copy rank 0's ``tensors`` (one dtype) to every rank, in place,
    through one flat buffer."""
    if mesh.ranks.group is None or not tensors:
        return tensors
    with torch.no_grad():
        flat = torch.cat([t.detach().reshape(-1) for t in tensors])
        dist.broadcast(flat, src=0, group=mesh.ranks.group)
        offset = 0
        for t in tensors:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n
    return tensors


def host_sum(mesh: Mesh, values: Sequence[float]) -> list[float]:
    """Host numbers summed over the ranks (float64, over gloo)."""
    if mesh.ranks.group is None:
        return [float(v) for v in values]
    t = torch.tensor([float(v) for v in values], dtype=torch.float64)
    dist.all_reduce(t, group=mesh.ranks.host_group)
    return t.tolist()


def host_max(mesh: Mesh, values: Sequence[int]) -> list[int]:
    """Host integers, their maximum over the ranks (over gloo)."""
    if mesh.ranks.group is None:
        return [int(v) for v in values]
    t = torch.tensor([int(v) for v in values], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.ranks.host_group)
    return t.tolist()


def gather_rows(mesh: Mesh, rows: np.ndarray) -> np.ndarray:
    """Every rank's ``rows`` (one shape and dtype on all ranks) stacked on
    axis 0 in rank order, on every rank, through the host."""
    rows = np.ascontiguousarray(rows)
    if mesh.ranks.group is None:
        return rows
    t = torch.from_numpy(rows)
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t, group=mesh.ranks.host_group)
    return torch.cat(parts).numpy()


def barrier(mesh: Mesh) -> None:
    """Wait until every rank reaches this point."""
    if mesh.ranks.group is not None:
        dist.barrier(group=mesh.ranks.host_group)
