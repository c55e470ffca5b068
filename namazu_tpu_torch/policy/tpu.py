"""The search half of the ``tpu_search`` policy on the port: the
counterpart of what ``namazu_tpu/policy/tpu.py`` runs through JAX.

The policy's event-time half (queueing, bucket lookup, release, the
reorder window) is host code that never touches a device and stays the
reference's. What it hands to JAX is here, as plain functions on the
policy's flat knob dicts (``TPUSearchPolicy._search_params()`` and
``._ingest_params()._asdict()``), for the ``torch_search`` policy shim
(``namazu_tpu_torch_policy.py`` at the repository root) and for the
port's sidecar:

* :func:`policy_device`: the ``platform`` knob as a device, checked when
  the config loads;
* :func:`build_search`: the search of the knobs (``_build_search``),
  over a hybrid ``h x i`` mesh across ``torch.distributed`` processes
  with ``dcn_hosts > 1``;
* :func:`install_from_checkpoint`: a checkpoint's best tables read with
  numpy alone, as the reference's ``_install_from_checkpoint`` reads
  them;
* :func:`wire_remote_surrogate`: the knowledge service's shared
  surrogate as the search's ``remote_surrogate``;
* :func:`ingest_params`: the policy's ingest knobs as the port's
  ``ingest_history`` takes them (``_ingest_history``).

A multi-process search (``dcn_hosts > 1``) starts one process per host
with ``NMZ_TPU_COORDINATOR=host:port``, ``NMZ_TPU_NUM_PROCESSES`` and
``NMZ_TPU_PROCESS_ID`` set (``parallel/distributed.py``).
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import numpy as np
import torch

from namazu_tpu_torch.device import DeviceLike, resolve_device
from namazu_tpu_torch.knowledge.client import pairs_fingerprint
from namazu_tpu_torch.models.ga import GAConfig
from namazu_tpu_torch.models.ingest import IngestParams
from namazu_tpu_torch.models.mcts import MCTSConfig
from namazu_tpu_torch.models.search import (
    MCTSSearch,
    ScheduleSearch,
    SearchBase,
    SearchConfig,
    make_score_weights,
)
from namazu_tpu_torch.ops.trace_encoding import (
    HINT_SPACE,
    checkpoint_hint_space,
)
from namazu_tpu_torch.parallel.distributed import (
    initialize_from_env,
    make_hybrid_mesh,
)
from namazu_tpu_torch.parallel.mesh import IslandMesh, make_mesh

log = logging.getLogger("namazu_tpu_torch.policy")

#: the reference's ``platform`` values and the device each one names
PLATFORMS = {"": "cuda", "gpu": "cuda", "cuda": "cuda", "cpu": "cpu"}


def policy_device(platform: str = "", n_devices: Optional[int] = None,
                  dcn_hosts: int = 0) -> torch.device:
    """The device of a policy's search: ``""``, ``"gpu"`` or ``"cuda"``
    is the card, ``"cpu"`` the CPU; any other platform (``"tpu"``
    included) raises ``ValueError``, and the card without CUDA raises
    ``RuntimeError``. In one process ``devices = N`` names the first N
    cards, and more than there are raises ``ValueError``."""
    if platform not in PLATFORMS:
        raise ValueError(
            f"platform {platform!r} is not served by namazu_tpu_torch "
            f"(expected one of {sorted(PLATFORMS)})")
    device = resolve_device(PLATFORMS[platform])
    if dcn_hosts <= 1:
        make_mesh(n_devices, device=device)  # raises for too many cards
    return device


def _cards(device: torch.device, wanted: int) -> int:
    """Cards this process can give a hybrid mesh from ``device`` on; on
    the CPU islands are virtual, so as many as wanted."""
    if device.type == "cuda":
        return torch.cuda.device_count() - device.index
    return wanted


def _process_devices(n_devices: Optional[int], device: torch.device
                     ) -> list:
    """This process's islands of a hybrid mesh, as the reference slices
    its devices per process: ``devices = N`` across P processes takes
    ``N / P`` of each process's cards (refused unless P divides N and
    every process has that many), and without ``devices`` every card
    (one island on the CPU)."""
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is None or world == 1:
        return list(make_mesh(n_devices, device=device).devices)
    if n_devices % world != 0:
        raise ValueError(f"devices={n_devices} must divide evenly "
                         f"across {world} processes")
    per = n_devices // world
    counts: list = [None] * world
    dist.all_gather_object(counts, _cards(device, per))
    short = {p: c for p, c in enumerate(counts) if c < per}
    if short:
        raise ValueError(f"devices={n_devices} needs {per} chips per "
                         f"process but some have fewer: {short}")
    return list(make_mesh(per, device=device).devices)


def build_search(p: dict, device: DeviceLike = "cuda", dcn_hosts: int = 0,
                 mesh: Optional[IslandMesh] = None) -> SearchBase:
    """A search from the policy's flat params dict, with the reference's
    defaults: the GA, or with ``search_backend = "mcts"`` the MCTS
    backend, over ``mesh``; else with ``dcn_hosts > 1`` over a hybrid
    mesh of ``dcn_hosts`` hosts (``torch.distributed`` started from the
    environment first); else over ``devices`` islands (one on each of the
    first N cards; one island by default). Causality guidance is wired
    when asked, before any checkpoint load, so archive rows and fragments
    stay slot-aligned. Raises ``ValueError`` where the reference refuses
    a mesh, and for more cards than there are."""
    device = resolve_device(device)
    weights = make_score_weights(
        release_mode=p.get("release_mode", "delay"),
        w_novelty=p.get("w_novelty", 1.0),
        w_bug=p.get("w_bug", 1.0),
        w_delay_cost=p.get("w_delay_cost", 0.01),
        w_fault_cost=p.get("w_fault_cost", 0.05),
        tau=p.get("tau", 0.005),
        reorder_gap=p.get("reorder_gap", 0.002),
        reorder_window=p.get("reorder_window", 0.05),
    )
    cfg = SearchConfig(
        H=p.get("H", 256), L=p.get("L", 0), K=p.get("K", 256),
        population=p.get("population", 4096),
        migrate_k=p.get("migrate_k", 8),
        seed=p.get("seed", 0),
        ga=GAConfig(max_delay=p.get("max_interval", 0.1),
                    max_fault=p.get("max_fault", 0.0)),
        weights=weights,
        surrogate_topk=p.get("surrogate_topk", 16),
        min_failure_signatures=p.get("min_failure_signatures", 0),
        novelty_floor=p.get("novelty_floor", 0.25),
        guidance_bonus=p.get("guidance_bonus", 0.5),
        fused=bool(p.get("fused", True)),
        fused_chunk=int(p.get("fused_chunk", 16)),
        migrate_every=int(p.get("migrate_every", 1)),
        dcn_migrate_every=int(p.get("dcn_migrate_every", 1)),
        device_trace_dir=str(p.get("device_trace_dir", "") or ""),
    )
    n_devices = p.get("devices")
    if mesh is None and dcn_hosts > 1:
        initialize_from_env(device=device)
        mesh = make_hybrid_mesh(n_hosts=dcn_hosts,
                                devices=_process_devices(n_devices, device))
    if p.get("search_backend", "ga") == "mcts":
        mcts_cfg = MCTSConfig(
            tree_depth=p.get("mcts_tree_depth", 24),
            n_levels=p.get("mcts_levels", 8),
            simulations=p.get("mcts_simulations", 256),
            rollouts=p.get("mcts_rollouts", 64),
            max_delay=p.get("max_interval", 0.1),
            max_fault=p.get("max_fault", 0.0),
        )
        search: SearchBase = MCTSSearch(cfg, mcts_cfg=mcts_cfg, mesh=mesh,
                                        n_devices=n_devices, device=device)
    else:
        search = ScheduleSearch(cfg, mesh=mesh, n_devices=n_devices,
                                device=device)
    if p.get("guidance"):
        search.enable_guidance(p.get("guidance_width") or None,
                               p.get("guidance_window") or None)
    return search


def install_from_checkpoint(path: str, H: int
                            ) -> Optional[Tuple[np.ndarray,
                                                Optional[np.ndarray],
                                                float]]:
    """``(delays, faults or None, fitness)`` of a checkpoint's best, read
    with numpy alone (no search is built, so a run installs it before its
    decisive window); None, with the reference's log line, for a
    checkpoint that has not evolved, another hint space, another ``H``,
    a non-finite fitness or an unreadable file."""
    try:
        with np.load(path) as z:
            if "best_delays" not in z or "generations_run" not in z:
                return None
            if int(z["generations_run"]) <= 0:
                return None
            space = checkpoint_hint_space(z)
            if space != HINT_SPACE:
                log.warning(
                    "checkpoint %s is from hint space %r (this build: "
                    "%r); not installing its schedule", path, space,
                    HINT_SPACE)
                return None
            fit = (float(z["best_fitness"])
                   if "best_fitness" in z else float("nan"))
            if not np.isfinite(fit):
                return None
            delays = np.array(z["best_delays"])
            if delays.shape != (H,):
                log.warning(
                    "checkpoint %s has best_delays of shape %s but "
                    "hint_buckets=%d; not installing", path, delays.shape,
                    H)
                return None
            faults = (np.array(z["best_faults"])
                      if "best_faults" in z else None)
    except Exception:
        log.exception("unreadable checkpoint %s", path)
        return None
    return delays, faults, fit


def wire_remote_surrogate(search: SearchBase, client) -> None:
    """Give ``search`` the knowledge service's shared surrogate, scoped
    by the search's own pair fingerprint (features never cross feature
    spaces); consulted only while the local surrogate is too thin. A
    None client (the knowledge plane off) leaves the search as it is."""
    if client is None:
        return

    def hook(feats, _client=client, _search=search):
        return _client.predict(feats,
                               pairs_fp=pairs_fingerprint(_search.pairs))

    search.remote_surrogate = hook


def ingest_params(p: dict) -> IngestParams:
    """:class:`IngestParams` of the policy's ``_ingest_params()`` dict;
    keys the port does not read are dropped."""
    return IngestParams(**{k: v for k, v in p.items()
                           if k in IngestParams._fields})

