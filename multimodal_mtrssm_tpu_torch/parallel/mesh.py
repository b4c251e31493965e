"""Process groups and batch data parallelism (port of ``parallel/mesh.py``).

The JAX package trains one program over a device mesh: parameters and
optimizer state replicated (or the moments sharded, ZeRO-1), the batch
sharded on axis 0, and XLA inserting the cross-device sums. The port runs
one process per device on ``torch.distributed`` with the same layouts:

- a flat ``data`` mesh of every rank (:func:`make_mesh`), or a hybrid
  ``(dcn, data)`` one (:func:`make_hybrid_mesh`) whose ``data`` groups are
  the ranks of one node: ZeRO-1's moment shards and the all-gather of the
  parameter step stay inside a node, and only the gradient's all-reduce
  crosses nodes;
- every rank builds the whole batch from the same seed and keeps its own
  rows (:func:`shard_rows`), JAX's "replicated dataset, sharded batch"
  recipe (its ``put_sharded``);
- the weights are broadcast from rank 0 (:func:`replicate`).

:func:`init_from_env` starts the process group from the variables
``torchrun`` sets. The backend is NCCL on CUDA devices and gloo on the CPU;
gloo on CUDA tensors only where the caller names it (ranks that share one
card: NCCL refuses two ranks on one device). Only ``all_reduce``,
``all_gather`` (list form) and ``broadcast`` are used: both backends take
them on CUDA and CPU tensors.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
from typing import Any, Sequence

import torch
import torch.distributed as dist
from torch import nn

DATA_AXIS = "data"
DCN_AXIS = "dcn"
# Seconds a collective (and the rendezvous) may wait before it fails.
TIMEOUT_S = 600


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a ``data`` or ``(dcn, data)`` mesh: the axes and
    their sizes, the global ranks of this rank's ``data`` group and its
    process group (the default group on a flat mesh), and a gloo group of
    every rank for host-side flags (the default group where that is gloo)."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    rank: int
    data_ranks: tuple[int, ...]
    data_group: Any
    host_group: Any

    @property
    def shape(self) -> dict[str, int]:
        """Each axis's size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def world(self) -> int:
        """The number of ranks: the product of the axes."""
        n = 1
        for s in self.sizes:
            n *= s
        return n

    @property
    def data_rank(self) -> int:
        """This rank's index in its ``data`` group (its ZeRO-1 shard)."""
        return self.data_ranks.index(self.rank)


def init_from_env(device: torch.device | str = "cuda", backend: str | None = None,
                  init_method: str = "env://",
                  timeout_s: float = TIMEOUT_S) -> torch.device:
    """Join the process group that ``RANK``/``WORLD_SIZE`` (and
    ``LOCAL_RANK``, as ``torchrun`` sets them) describe, and return the
    device this rank trains on: ``cuda`` without an index means
    ``cuda:LOCAL_RANK``, made the current device (the kernels launch on
    it). The backend is ``nccl`` on CUDA and ``gloo`` on the CPU unless
    ``backend`` names one. Without ``WORLD_SIZE`` in the environment this
    joins nothing and returns ``device``. A failed init raises."""
    device = torch.device(device)
    if "WORLD_SIZE" not in os.environ:
        return device
    local = int(os.environ.get("LOCAL_RANK", 0))
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend or ("nccl" if device.type == "cuda" else "gloo"),
                                init_method=init_method, rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]),
                                timeout=datetime.timedelta(seconds=timeout_s))
    return device


def _host_group() -> Any:
    """A gloo group of every rank: the default group where it is gloo, else
    a new one (made on every rank in the same order)."""
    if dist.get_backend() == "gloo":
        return dist.group.WORLD
    return dist.new_group(backend="gloo")


def make_mesh(host_group: Any = None) -> Mesh:
    """The 1-D ``data`` mesh of every rank of the default process group
    (``host_group``: a gloo group of every rank already made, else one is)."""
    world, rank = dist.get_world_size(), dist.get_rank()
    return Mesh((DATA_AXIS,), (world,), rank, tuple(range(world)), dist.group.WORLD,
                host_group if host_group is not None else _host_group())


def node_groups(hosts: Sequence[str]) -> list[list[int]]:
    """Global ranks grouped by the node each runs on (``hosts[r]`` names
    rank ``r``'s), groups in the order of their first rank: the
    counterpart of JAX's ``slice_groups``."""
    groups: dict[str, list[int]] = {}
    for r, h in enumerate(hosts):
        groups.setdefault(h, []).append(r)
    return list(groups.values())


def hybrid_layout(world: int, dcn_size: int | None,
                  hosts: Sequence[str] | None = None) -> list[list[int]]:
    """The ``data`` groups of a ``(dcn, data)`` mesh of ``world`` ranks, as
    JAX's ``make_hybrid_mesh`` lays them out: ``dcn_size`` rows of
    consecutive ranks; with ``dcn_size=None`` one group per node of
    ``hosts`` (one group, a flat mesh, when there is one node). Raises on
    nodes of unequal size and on a world that ``dcn_size`` does not
    divide. The batch splits over the ranks in rank order whatever the
    groups: they decide only where ZeRO-1's shards and all-gather live."""
    if dcn_size is None:
        groups = node_groups(hosts if hosts is not None else [""] * world)
        if len(groups) <= 1:
            return [list(range(world))]
        sizes = {len(g) for g in groups}
        if len(sizes) != 1:
            raise ValueError(f"unequal node sizes {sorted(sizes)}; pass dcn_size explicitly")
        return groups
    if dcn_size < 1 or world % dcn_size:
        raise ValueError(f"{world} ranks not divisible by dcn_size={dcn_size}")
    ici = world // dcn_size
    return [list(range(i * ici, (i + 1) * ici)) for i in range(dcn_size)]


def _hosts(host_group: Any) -> list[str]:
    """Each rank's node: consecutive blocks of ``LOCAL_WORLD_SIZE`` ranks
    where ``torchrun`` set it, else each rank's host name, gathered."""
    world = dist.get_world_size()
    local = os.environ.get("LOCAL_WORLD_SIZE")
    if local is not None:
        return [str(r // int(local)) for r in range(world)]
    names: list[Any] = [None] * world
    dist.all_gather_object(names, socket.gethostname(), group=host_group)
    return names


def make_hybrid_mesh(dcn_size: int | None = None) -> Mesh:
    """The ``(dcn, data)`` mesh (:func:`hybrid_layout`); a flat ``data``
    mesh when ``dcn_size`` is None and every rank runs on one node. Every
    rank must call it, in the same order as its other group calls."""
    world, rank = dist.get_world_size(), dist.get_rank()
    host = _host_group()
    groups = hybrid_layout(world, dcn_size, _hosts(host) if dcn_size is None else None)
    if len(groups) == 1:
        return make_mesh(host)
    mine = None
    for ranks in groups:  # new_group is collective: every rank makes every group
        g = dist.new_group(ranks)
        if rank in ranks:
            mine = (tuple(ranks), g)
    return Mesh((DCN_AXIS, DATA_AXIS), (len(groups), len(groups[0])), rank, mine[0], mine[1],
                host)


def ici_size(mesh: Mesh) -> int:
    """The size of the ``data`` (within-node) axis: ZeRO-1's shard count."""
    return mesh.shape[DATA_AXIS]


def row_range(n: int, world: int, rank: int) -> tuple[int, int]:
    """Rank ``rank``'s rows ``[lo, hi)`` of ``n`` over ``world`` ranks: the
    first ``n % world`` ranks take one row more (``numpy.array_split``), so
    a ragged tail leaves the last ranks fewer rows, or none."""
    base, extra = divmod(n, world)
    lo = rank * base + min(rank, extra)
    return lo, lo + base + (rank < extra)


def mesh_rows(n: int, mesh: Mesh | None) -> tuple[int, int]:
    """This rank's :func:`row_range` of ``n`` rows on ``mesh`` (all of them
    without one). The batch splits over every axis in rank order, as JAX's
    ``batch_sharding`` splits it over ``(dcn, data)``."""
    if mesh is None:
        return 0, n
    return row_range(n, mesh.world, mesh.rank)


def shard_rows(batch: Any, mesh: Mesh | None) -> Any:
    """This rank's rows (:func:`mesh_rows`, axis 0) of a tensor or array, or
    of each one of a tuple: the port's ``shard_batch``."""
    if isinstance(batch, tuple):
        return tuple(shard_rows(x, mesh) for x in batch)
    lo, hi = mesh_rows(batch.shape[0], mesh)
    return batch[lo:hi]


@torch.no_grad()
def replicate(module: nn.Module, mesh: Mesh | None) -> nn.Module:
    """Broadcast ``module``'s parameters and buffers from rank 0 (in
    place); returns it."""
    if mesh is not None:
        for t in [*module.parameters(), *module.buffers()]:
            dist.broadcast(t.data, src=0)
    return module


def agree(flag: bool, mesh: Mesh | None) -> bool:
    """Whether ``flag`` is set on any rank (a MAX all-reduce over the host
    group: no device work on an NCCL mesh)."""
    if mesh is None:
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.host_group)
    return bool(t.item())


def barrier(mesh: Mesh | None) -> None:
    """Wait for every rank (over the host group)."""
    if mesh is not None:
        dist.barrier(group=mesh.host_group)
