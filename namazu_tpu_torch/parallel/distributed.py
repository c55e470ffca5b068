"""Several processes: the port of ``namazu_tpu/parallel/distributed.py``.

The reference runs one JAX process per host and gives the mesh two axes,
``h`` (hosts) and ``i`` (chips within a host): the ring over ``i`` runs
every generation, a thin ring over ``h`` (``dcn_migrate_k`` genomes) on
its own cadence, and the global best is gathered over both. Here each
process is started with ``torch.distributed`` (:func:`initialize_from_env`)
and holds whole rows of ``h``: the ``i`` ring stays in the process, the
``h`` ring and the global best go through ``all_gather``
(``parallel/islands.py``). In one process the same ``h x i`` mesh runs
with virtual hosts, and gives the same populations bit for bit.

Launch (one command per process)::

    NMZ_TPU_COORDINATOR=host0:8476 NMZ_TPU_NUM_PROCESSES=4 \\
    NMZ_TPU_PROCESS_ID=$RANK  python -m my_experiment ...
"""

from __future__ import annotations

import functools
import os
from typing import Optional, Sequence

import torch

from namazu_tpu_torch.device import DeviceLike
from namazu_tpu_torch.models.ga import GAConfig
from namazu_tpu_torch.ops.schedule import ScoreWeights
from namazu_tpu_torch.parallel.islands import island_step
from namazu_tpu_torch.parallel.mesh import IslandMesh, _cuda_devices


def initialize_from_env(coordinator: Optional[str] = None,
                        num_processes: Optional[int] = None,
                        process_id: Optional[int] = None,
                        device: DeviceLike = "cuda") -> bool:
    """Start ``torch.distributed`` for a multi-process run (NCCL for
    ``cuda``, gloo for ``cpu``). Idempotent. Explicit arguments win;
    otherwise ``NMZ_TPU_COORDINATOR`` (``host:port``) /
    ``NMZ_TPU_NUM_PROCESSES`` / ``NMZ_TPU_PROCESS_ID`` are read; with none
    set this is a single-process run and returns False."""
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    coordinator = coordinator or os.environ.get("NMZ_TPU_COORDINATOR")
    np_env = os.environ.get("NMZ_TPU_NUM_PROCESSES")
    pid_env = os.environ.get("NMZ_TPU_PROCESS_ID")
    if num_processes is None and np_env:
        num_processes = int(np_env)
    if process_id is None and pid_env:
        process_id = int(pid_env)
    if coordinator is None and num_processes is None:
        return False  # single-process
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("a multi-process run needs the coordinator, the "
                         "process count and this process's id")
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(
        backend,
        init_method=(coordinator if "://" in coordinator
                     else f"tcp://{coordinator}"),
        world_size=num_processes, rank=process_id)
    return True


def make_hybrid_mesh(n_hosts: Optional[int] = None,
                     devices: Optional[Sequence[DeviceLike]] = None,
                     axes: tuple = ("h", "i")) -> IslandMesh:
    """``h x i`` mesh of hosts by islands a host. ``devices`` has one
    entry per island of this process (repeats put several islands on one
    device; default: one island on each card). With ``torch.distributed``
    up, ``n_hosts`` defaults to the process count and each process holds
    ``n_hosts / world`` whole rows; in one process any ``n_hosts`` that
    divides the islands makes virtual hosts. Refusals as the
    reference's."""
    import torch.distributed as dist

    on = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if on else 1
    rank = dist.get_rank() if on else 0
    devs = list(devices) if devices is not None else _cuda_devices(None,
                                                                   "cuda")
    if n_hosts is None:
        n_hosts = max(1, world)
    total = len(devs) * world
    if total % n_hosts != 0:
        raise ValueError(f"{total} devices do not divide into {n_hosts} "
                         f"hosts")
    if world > 1 and n_hosts % world != 0:
        raise ValueError(
            f"n_hosts={n_hosts} must be a multiple of the process count "
            f"({world}) so the chip axis stays intra-host")
    return IslandMesh(axes, (n_hosts, total // n_hosts), devs, rank=rank,
                      world=world, distributed=on)


def hier_rings(migrate_k: int = 8, dcn_migrate_k: int = 2,
               migrate_every: int = 1, dcn_every: int = 1,
               host_axis: str = "h", chip_axis: str = "i"):
    """The ring plan of an ``h x i`` mesh: the ring over the chip axis
    first, then the thin ring over hosts, each with its own cadence."""
    return (
        (chip_axis, migrate_k, migrate_every),
        (host_axis, dcn_migrate_k, dcn_every),
    )


def make_hier_island_step(mesh: IslandMesh, cfg: GAConfig,
                          weights: ScoreWeights = ScoreWeights(),
                          migrate_k: int = 8, dcn_migrate_k: int = 2,
                          host_axis: str = "h", chip_axis: str = "i",
                          migrate_every: int = 1, dcn_every: int = 1):
    """:func:`~namazu_tpu_torch.parallel.islands.island_step` on an ``h x
    i`` mesh with :func:`hier_rings`: called as ``step(state, seed,
    traces, pairs, archive, failures, coin=..., ...)``."""
    return functools.partial(
        island_step, cfg=cfg, weights=weights, mesh=mesh,
        rings=hier_rings(migrate_k, dcn_migrate_k, migrate_every,
                         dcn_every, host_axis, chip_axis))
