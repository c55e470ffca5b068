"""Island meshes: the port of ``namazu_tpu/parallel/mesh.py``.

The reference's mesh is a grid of devices with one island on each. The
port keeps the same grid of island coordinates (axis names and sizes,
row-major) and maps it onto *shards*: a shard is a block of consecutive
islands that lives on one torch device as a leading axis ``[I_s, Pi, H]``.

* :func:`make_mesh` on ``cuda`` puts one island on each of the first N
  cards (N shards of one island), the reference's real layout; on ``cpu``
  it puts N islands in one shard, the counterpart of the reference's
  virtual CPU devices.
* Several islands on one card (one shard, or several with
  :meth:`IslandMesh.reshard`) is how one card runs a multi-island search.
* In a multi-process run (``parallel/distributed.py``) each process holds
  whole rows of the first axis; its islands are the global indices
  ``[rank * n_local, (rank + 1) * n_local)``.

The search's result does not depend on the layout: an island's draws
depend only on its coordinates (``parallel/islands.py``).
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from namazu_tpu_torch.device import DeviceLike, resolve_device


class Shard(NamedTuple):
    device: torch.device
    start: int  # global index of the shard's first island
    islands: int  # consecutive islands it holds


class IslandMesh:
    """A row-major grid of islands (``axis_names`` x ``sizes``) and the
    shards of this process's islands. ``devices`` has one entry per local
    island; consecutive islands on one device form one shard of at most
    ``shard_size`` islands (default: as many as run on). ``distributed``
    marks a mesh whose first axis crosses ``torch.distributed`` processes:
    rings over that axis and the global best go through collectives."""

    def __init__(self, axis_names: Sequence[str], sizes: Sequence[int],
                 devices: Sequence[DeviceLike],
                 shard_size: Optional[int] = None, rank: int = 0,
                 world: int = 1, distributed: bool = False):
        self.axis_names = tuple(str(a) for a in axis_names)
        self.sizes = tuple(int(s) for s in sizes)
        if len(self.axis_names) != len(self.sizes) or min(self.sizes) < 1:
            raise ValueError(f"bad mesh shape {self.sizes} for axes "
                             f"{self.axis_names}")
        if self.n_islands % world:
            raise ValueError(f"{self.n_islands} islands do not divide over "
                             f"{world} processes")
        self.devices = tuple(resolve_device(d) for d in devices)
        n_local = self.n_islands // world
        if len(self.devices) != n_local:
            raise ValueError(f"{len(self.devices)} devices for {n_local} "
                             f"local islands")
        self.rank, self.world, self.distributed = rank, world, distributed
        self.shard_size = shard_size
        first = rank * n_local
        shards: List[Shard] = []
        for j, dev in enumerate(self.devices):
            last = shards[-1] if shards else None
            if (last is not None and last.device == dev
                    and (shard_size is None or last.islands < shard_size)):
                shards[-1] = last._replace(islands=last.islands + 1)
            else:
                shards.append(Shard(dev, first + j, 1))
        self.shards = tuple(shards)
        # per-ring slice plans, filled by parallel/islands.py
        self.route_cache: Dict[tuple, list] = {}

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def n_islands(self) -> int:
        return math.prod(self.sizes)

    @property
    def local_islands(self) -> int:
        return len(self.devices)

    @property
    def first_island(self) -> int:
        return self.shards[0].start

    @property
    def device(self) -> torch.device:
        """The primary device: the first shard's; the best-so-far and the
        search's archives live here."""
        return self.shards[0].device

    def coords(self, island: int) -> Tuple[int, ...]:
        out = []
        for n in reversed(self.sizes):
            out.append(island % n)
            island //= n
        return tuple(reversed(out))

    def index(self, coords: Sequence[int]) -> int:
        g = 0
        for c, n in zip(coords, self.sizes):
            g = g * n + c
        return g

    def predecessor(self, island: int, axis: int) -> int:
        """The island whose migrants land on ``island`` in the ring over
        axis number ``axis``: one step back along it, cyclically."""
        c = list(self.coords(island))
        c[axis] = (c[axis] - 1) % self.sizes[axis]
        return self.index(c)

    def shard_of(self, island: int) -> Tuple[int, int]:
        """``(shard index, island index inside the shard)`` of a local
        island."""
        for s, sh in enumerate(self.shards):
            if sh.start <= island < sh.start + sh.islands:
                return s, island - sh.start
        raise ValueError(f"island {island} is not local to rank {self.rank}")

    def reshard(self, shard_size: int) -> "IslandMesh":
        """The same grid and devices in shards of at most ``shard_size``
        islands (a test of layout independence on one device)."""
        return IslandMesh(self.axis_names, self.sizes, self.devices,
                          shard_size, self.rank, self.world,
                          self.distributed)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """``[world, *t.shape]``: ``t`` of every process, in rank order."""
        import torch.distributed as dist

        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t.contiguous())
        return torch.stack(parts)

    def __repr__(self) -> str:
        return (f"IslandMesh({self.shape}, shards="
                f"{[(str(s.device), s.start, s.islands) for s in self.shards]}"
                f", rank={self.rank}/{self.world})")


def default_device_count(device: DeviceLike = "cuda") -> int:
    """Cards visible to this process; 1 for the CPU."""
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return 1


def _cuda_devices(n_devices: Optional[int], device: DeviceLike
                  ) -> List[torch.device]:
    """The first ``n_devices`` cards from ``device``'s index on (all of
    them by default); asking for more cards than exist raises
    ``ValueError``, as the reference's ``make_mesh`` does."""
    base = resolve_device(device).index
    have = torch.cuda.device_count() - base
    n = have if n_devices is None else int(n_devices)
    if n > have:
        raise ValueError(f"requested {n} devices, have {have}")
    return [torch.device("cuda", base + j) for j in range(n)]


def make_mesh(n_devices: Optional[int] = None, axis: str = "i",
              device: DeviceLike = "cuda") -> IslandMesh:
    """1-D mesh of ``n_devices`` islands (default: every card). On
    ``cuda`` one island per card; on ``cpu`` the islands share one shard
    on the CPU."""
    if torch.device(device).type == "cuda":
        devices = _cuda_devices(n_devices, device)
    else:
        devices = [resolve_device(device)] * (
            1 if n_devices is None else int(n_devices))
    if not devices:
        raise ValueError("a mesh needs at least one island")
    return IslandMesh((axis,), (len(devices),), devices)


def make_island_mesh(n_islands: int, axis: str = "i",
                     device: DeviceLike = "cuda") -> IslandMesh:
    """1-D mesh of ``n_islands`` islands in one shard on one device: a
    multi-island search on one card."""
    return IslandMesh((axis,), (n_islands,), [device] * n_islands)


def make_topology_mesh(n_devices: Optional[int] = None, host_size: int = 4,
                       axes: tuple = ("h", "i"),
                       device: DeviceLike = "cuda",
                       devices: Optional[Sequence[DeviceLike]] = None
                       ) -> IslandMesh:
    """``h x i`` mesh grouped by host (``host_size`` islands a host) for a
    count past one host's; one host's worth or less falls back to the
    flat mesh, as in the reference. ``devices`` has one entry per island
    (repeats put several islands on one device); by default one island
    on each of ``n_devices`` cards."""
    if devices is None:
        n = (n_devices if n_devices is not None
             else default_device_count(device))
        if n <= host_size:
            return make_mesh(n_devices, axis=axes[1], device=device)
        devices = make_mesh(n, device=device).devices
    n = len(devices)
    if n <= host_size:
        return IslandMesh((axes[1],), (n,), devices)
    if n % host_size != 0:
        raise ValueError(f"{n} devices do not divide into hosts of "
                         f"{host_size}")
    from namazu_tpu_torch.parallel.distributed import make_hybrid_mesh

    return make_hybrid_mesh(n_hosts=n // host_size, devices=devices,
                            axes=axes)
