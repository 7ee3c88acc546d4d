"""The rank topology of a multi-rank run (port of
``dgen_tpu/parallel/mesh.py``).

The JAX package lays the agent axis over a device mesh that one process
(or one process per host) drives. The port runs one process per rank,
the PyTorch idiom: each rank holds one shard of the agent table and
launches its kernels on its own card. A :class:`RankTopology` replaces
the mesh: the (hosts, devices) grid, the world size, the rank and the
rank's ``torch.device``. A rank's card is its local index modulo
``torch.cuda.device_count()``.

The process group's backend is NCCL when every rank has a card of its
own, and gloo otherwise (the CPU, or ranks that share a card; NCCL
refuses two ranks on one device). Gloo does not gather CUDA tensors, so
under gloo a collective on a card's tensor goes through the host (and
under NCCL one on a host tensor through the card). The collectives are
``all_reduce``, ``all_gather`` and ``broadcast``; a world of one rank runs
none.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import List, Optional, Tuple

import torch

logger = logging.getLogger(__name__)

#: seconds a collective waits for its peers before the group raises (a
#: rank that died leaves the others at their next collective)
DEFAULT_TIMEOUT_S = 600.0


def parse_mesh_shape(label: str) -> Tuple[int, int]:
    """'HxD' -> (H, D), e.g. '1x8' or '2x4'."""
    parts = label.lower().split("x")
    if len(parts) != 2:
        raise ValueError(
            f"bad mesh shape '{label}' (expected HxD, e.g. 2x4)"
        )
    try:
        h, d = int(parts[0]), int(parts[1])
    except ValueError:
        raise ValueError(
            f"bad mesh shape '{label}' (expected HxD, e.g. 2x4)"
        ) from None
    if h < 1 or d < 1:
        raise ValueError(f"bad mesh shape '{label}' (axes must be >= 1)")
    return h, d


def default_mesh_shape(world_size: Optional[int] = None,
                       local_size: Optional[int] = None) -> Tuple[int, int]:
    """The (hosts, devices) grid of this run.

    ``DGEN_TPU_MESH=HxD`` forces a shape; otherwise ``world_size`` ranks
    (default: the initialized group's, else 1) make a ``processes x
    local ranks`` grid, the local ranks of a host being ``local_size``
    (default ``LOCAL_WORLD_SIZE`` as ``torchrun`` sets it, else every rank
    on one host)."""
    raw = os.environ.get("DGEN_TPU_MESH", "").strip()
    if raw:
        return parse_mesh_shape(raw)
    if world_size is None:
        world_size = _group_size()
    world_size = int(world_size)
    if local_size is None:
        local_size = int(os.environ.get("LOCAL_WORLD_SIZE", "0") or 0) or world_size
    local_size = int(local_size)
    if world_size > 1 and 0 < local_size < world_size and world_size % local_size == 0:
        return (world_size // local_size, local_size)
    return (1, world_size)


def _group_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank_device(local_rank: int, device="cuda") -> torch.device:
    """The device of a rank: on a card, the card at the rank's local
    index modulo the host's card count; the CPU as it is."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    n = torch.cuda.device_count()
    if n < 1:
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the ranks "
            "on the CPU")
    return torch.device("cuda", int(local_rank) % n)


def choose_backend(device: torch.device, local_ranks: int) -> str:
    """NCCL when every local rank has a card of its own, gloo otherwise."""
    if device.type == "cuda" and torch.cuda.device_count() >= local_ranks:
        return "nccl"
    return "gloo"


@dataclasses.dataclass(frozen=True)
class RankTopology:
    """One rank's view of the run: the (hosts, devices) grid, the world
    size, this rank, its local index on its host, its ``torch.device`` and
    the process group's backend (None for a world of one rank, which has
    no group)."""

    hosts: int
    devices: int
    rank: int
    local_rank: int
    device: torch.device
    backend: Optional[str] = None
    #: ranks on this rank's host where its launcher says so
    #: (``LOCAL_WORLD_SIZE``: a supervisor's local children, ``torchrun``);
    #: 0 means the grid's devices axis
    local_world: int = 0

    @property
    def world_size(self) -> int:
        return self.hosts * self.devices

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.hosts, self.devices)

    @property
    def distributed(self) -> bool:
        return self.world_size > 1

    @property
    def ranks_per_card(self) -> int:
        """How many ranks share this rank's card: the host's local ranks
        over its cards, rounded up (1 off a card, and for a rank with a
        card of its own)."""
        if self.device.type != "cuda":
            return 1
        local = int(self.local_world or self.devices)
        return max(1, -(-local // max(torch.cuda.device_count(), 1)))

    @staticmethod
    def single(device="cuda") -> "RankTopology":
        """A world of one rank on ``device`` (no process group)."""
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return RankTopology(hosts=1, devices=1, rank=0, local_rank=0, device=dev)

    # --- collectives -------------------------------------------------------

    def _buffer(self, t: torch.Tensor) -> torch.Tensor:
        """A copy of ``t`` where the backend communicates: the host under
        gloo (which does not gather a card's tensors), the rank's card
        under NCCL."""
        where = torch.device("cpu") if self.backend == "gloo" else self.device
        return t.detach().to(where, copy=True).contiguous()

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` reduced over every rank (``op``: "sum" or "max"), as a new
        tensor on ``t``'s device; ``t`` itself in a world of one rank."""
        if not self.distributed:
            return t
        import torch.distributed as dist

        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        buf = self._buffer(t)
        dist.all_reduce(buf, op=red)
        return buf.to(t.device)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (equal shapes) concatenated along dim 0 in
        rank order, on ``t``'s device."""
        if not self.distributed:
            return t
        import torch.distributed as dist

        src = self._buffer(t)
        parts: List[torch.Tensor] = [torch.empty_like(src) for _ in range(self.world_size)]
        dist.all_gather(parts, src)
        return torch.cat(parts).to(t.device)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank, on ``t``'s device."""
        if not self.distributed:
            return t
        import torch.distributed as dist

        buf = self._buffer(t)
        dist.broadcast(buf, src=src)
        return buf.to(t.device)

    def max_int(self, value: int) -> int:
        """The largest of every rank's ``value``."""
        if not self.distributed:
            return int(value)
        return int(self.all_reduce(torch.tensor([int(value)], dtype=torch.int64),
                                   op="max")[0])


@dataclasses.dataclass(frozen=True)
class CrossRank:
    """How a rank's agent reductions reach the other ranks' rows: the
    ``reduce`` of ``models.market.segment_sum`` and its callers.

    ``whole_groups``: every state (so every state x sector group) lives
    whole on one rank (``RunConfig.partition_by_state``), and a group's
    sum is combined from local sums; otherwise the ``[N]`` operands are
    gathered in rank order. Every rank holds an equal number of rows."""

    topo: RankTopology
    whole_groups: bool

    def combine(self, partial: torch.Tensor) -> torch.Tensor:
        """Per-rank partial sums summed over the ranks."""
        return self.topo.all_reduce(partial)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of ``x``, in rank order."""
        return self.topo.all_gather(x)

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a gathered ``full``."""
        n = full.shape[0] // self.topo.world_size
        return full[self.topo.rank * n:(self.topo.rank + 1) * n]


def mesh_shape_of(topo: RankTopology) -> Tuple[int, int]:
    """(hosts, devices) of a run's topology."""
    return topo.shape


def init_ranks(coordinator: str, world_size: int, rank: int, device="cuda",
               mesh_shape: Optional[Tuple[int, int]] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> RankTopology:
    """Start this rank's process group over ``tcp://<coordinator>`` and
    return its topology. The rank's device is chosen first (its local
    index modulo the host's cards), then the backend (NCCL when every
    local rank has a card of its own, gloo otherwise), which is logged.
    The local index and the ranks on the host are the grid's (``rank %
    D`` and ``D``) unless the launcher sets ``LOCAL_RANK`` and
    ``LOCAL_WORLD_SIZE`` (as ``torchrun`` and the gang supervisor do):
    ranks of a one-host gang share the host's cards whatever the grid."""
    import datetime
    import inspect

    import torch.distributed as dist

    h, d = mesh_shape or default_mesh_shape(world_size)
    if h * d != world_size:
        raise ValueError(f"mesh shape {h}x{d} does not cover {world_size} ranks")
    local = int(os.environ.get("LOCAL_RANK", "").strip() or rank % d)
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", "").strip() or d)
    dev = rank_device(local, device)
    backend = choose_backend(dev, local_world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {}
    if backend == "nccl" and "device_id" in inspect.signature(
            dist.init_process_group).parameters:
        kw["device_id"] = dev
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{coordinator}",
        world_size=int(world_size), rank=int(rank),
        timeout=datetime.timedelta(seconds=timeout_s), **kw)
    logger.info("rank %d of %d (mesh %dx%d) on %s over %s%s", rank, world_size, h, d,
                dev, backend,
                "" if backend == "nccl" or dev.type != "cuda"
                else " (ranks share a card: collectives go through the host)")
    return RankTopology(hosts=h, devices=d, rank=int(rank), local_rank=local,
                        device=dev, backend=backend, local_world=local_world)


def shutdown() -> None:
    """Tear the process group down (no-op when none is up)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
