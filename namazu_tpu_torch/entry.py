"""Driver entry points of the port: the counterparts of the reference's
``__graft_entry__.py``.

* :func:`entry` returns ``(fn, example_args)``: the population scorer
  (``ops/schedule.py::score_population``: counterfactual first
  occurrences, precedence features and the pair-distance kernel B1
  against both archives) at the reference's sizes, ready to call.
* :func:`dryrun_multichip` takes one island step (score, GA, ring
  migration, global best) over an ``n``-island mesh, then, for an even
  ``n``, one step of the hierarchical ``2 x n/2`` host-chip mesh.
* :func:`dryrun_multichip_fused` runs the fused generation loop on an
  ``h x i`` topology mesh against one island of the same total
  population, and reports the overhead factor.

Placement. The reference runs its dry runs on ``n`` virtual CPU devices.
Here ``device="cuda"`` (the default) spreads the ``n`` islands over the
visible cards from the given one on, in equal groups of consecutive
islands that share a card: on as many cards as divide ``n``, at most
all of them (8 islands on one card: one shard of 8; on 4 cards: 2 a
card). ``device="cpu"`` puts every island in one CPU shard. A missing
card raises ``RuntimeError``; nothing falls back to the CPU.

Run from the repository root, on the card::

    python -m namazu_tpu_torch.entry [N]          # dryrun_multichip(N)
    python -m namazu_tpu_torch.entry [N] fused    # dryrun_multichip_fused(N)
"""

from __future__ import annotations

import time
from typing import Callable, List, Tuple

import numpy as np
import torch

from namazu_tpu_torch.device import DeviceLike, resolve_device
from namazu_tpu_torch.models.ga import GAConfig, init_population
from namazu_tpu_torch.ops import trace_encoding as te
from namazu_tpu_torch.ops.schedule import (
    ScoreWeights,
    TraceArrays,
    score_population,
)
from namazu_tpu_torch.parallel.distributed import (
    hier_rings,
    make_hier_island_step,
    make_hybrid_mesh,
)
from namazu_tpu_torch.parallel.islands import (
    fused_step,
    init_island_state,
    island_step,
    one_island,
)
from namazu_tpu_torch.parallel.mesh import IslandMesh, make_topology_mesh


def _trace(hints: int, buckets: int, L: int, H: int, dev: torch.device
           ) -> TraceArrays:
    """The reference's synthetic trace: ``hints`` events of ``hint:{i %
    buckets}``, one a millisecond."""
    enc = te.encode_event_stream(
        [f"hint:{i % buckets}" for i in range(hints)],
        arrivals=[i * 1e-3 for i in range(hints)], L=L, H=H)
    return TraceArrays(torch.from_numpy(enc.hint_ids.astype(np.int64)).to(dev),
                       torch.from_numpy(enc.arrival).to(dev),
                       torch.from_numpy(enc.mask).to(dev))


def entry(device: DeviceLike = "cuda") -> Tuple[Callable, tuple]:
    """``(fn, example_args)``: ``fn(delays, hint_ids, arrival, mask, pairs,
    archive, failures)`` is the fitness ``f32[P]`` of a population against
    one trace, at H = L = K = 256, archive 512, 32 failures, P = 1024 and
    200 events. The population is drawn on the CPU from a generator
    seeded 0, so every device gets the same one; on the card each call
    launches B1 once."""
    dev = resolve_device(device)
    H, L, K, A, P = 256, 256, 256, 512, 1024
    trace = _trace(200, 96, L, H, dev)
    pairs = torch.from_numpy(te.sample_pairs(K, H, 0)).to(dev)
    pop = init_population(torch.Generator().manual_seed(0), P, H,
                          GAConfig(max_delay=0.1))
    archive = torch.full((A, K), 0.5, dtype=torch.float32, device=dev)
    failures = torch.full((32, K), 0.5, dtype=torch.float32, device=dev)
    weights = ScoreWeights()

    def fn(delays, hint_ids, arrival, mask, pairs, archive, failures):
        tr = TraceArrays(hint_ids.long(), arrival, mask)
        fitness, _ = score_population(delays, tr, pairs, archive, failures,
                                      weights)
        return fitness

    return fn, (pop.delays.to(dev), trace.hint_ids, trace.arrival,
                trace.mask, pairs, archive, failures)


def island_devices(n: int, device: DeviceLike = "cuda"
                   ) -> List[torch.device]:
    """One device per island: on ``cuda``, ``n`` islands in equal groups
    of consecutive islands over as many cards (from ``device``'s on) as
    divide ``n``; on ``cpu``, the CPU for all."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * n
    have = min(n, torch.cuda.device_count() - dev.index)
    cards = max(c for c in range(1, have + 1) if n % c == 0)
    per = n // cards
    return [torch.device("cuda", dev.index + i // per) for i in range(n)]


def _tiny_inputs(dev: torch.device):
    """The dry runs' shapes: H 32, L 64, K 32, archive 16, 4 failures."""
    H, L, K, A = 32, 64, 32, 16
    trace = _trace(40, 12, L, H, dev)
    pairs = torch.from_numpy(te.sample_pairs(K, H, 0)).to(dev)
    archive = torch.full((A, K), 0.5, dtype=torch.float32, device=dev)
    failures = torch.full((4, K), 0.5, dtype=torch.float32, device=dev)
    return H, (trace, pairs, archive, failures)


def _describe(mesh: IslandMesh) -> str:
    cards = sorted({str(s.device) for s in mesh.shards})
    return f"{mesh.n_islands} islands on {', '.join(cards)}"


def dryrun_multichip(n_devices: int, device: DeviceLike = "cuda") -> None:
    """One island step over an ``n_devices``-island mesh at tiny shapes
    (population ``8 * n_devices``); for an even count, one step of the
    ``2 x n/2`` hybrid mesh with hierarchical migration. Raises
    ``RuntimeError`` if a step does not advance the generation."""
    dev = resolve_device(device)
    H, inputs = _tiny_inputs(dev)
    P_total = 8 * n_devices
    devices = island_devices(n_devices, dev)
    cfg = GAConfig(max_delay=0.05)
    mesh = IslandMesh(("i",), (n_devices,), devices)
    state = init_island_state(0, P_total, H, cfg, mesh=mesh)
    state, _ = island_step(state, 1, *inputs, cfg, ScoreWeights(),
                           mesh=mesh, rings=(("i", 2),))
    best = float(state.best_fitness)  # waits for the step
    if state.gen != 1:
        raise RuntimeError(f"island step left gen {state.gen}, not 1")
    print(f"dryrun_multichip OK: {n_devices}-device mesh, population "
          f"{P_total}, best fitness {best:.4f} ({_describe(mesh)})")

    if n_devices >= 2 and n_devices % 2 == 0:
        hmesh = make_hybrid_mesh(n_hosts=2, devices=devices)
        hstep = make_hier_island_step(hmesh, cfg, ScoreWeights(),
                                      migrate_k=2, dcn_migrate_k=1)
        hstate = init_island_state(2, P_total, H, cfg, mesh=hmesh)
        hstate, _ = hstep(hstate, 3, *inputs)
        best = float(hstate.best_fitness)
        if hstate.gen != 1:
            raise RuntimeError(f"hybrid step left gen {hstate.gen}, not 1")
        print(f"dryrun_multichip OK (hybrid): 2x{n_devices // 2} host-chip "
              f"mesh, best fitness {best:.4f} ({_describe(hmesh)})")


def dryrun_multichip_fused(n_devices: int = 16, host_size: int = 4,
                           generations: int = 8, per_island: int = 64,
                           device: DeviceLike = "cuda") -> dict:
    """The fused loop (``generations`` island steps a call) on a
    ``n_devices / host_size x host_size`` topology mesh with the
    hierarchical rings (chip ring every generation, host ring every 4th),
    called once to warm up and three times timed; then the same on one
    island of the same total population. ``overhead_factor`` is the best
    mesh time over the best one-island time. Returns the reference's
    dict; raises ``RuntimeError`` if the generations do not add up."""
    dev = resolve_device(device)
    H, inputs = _tiny_inputs(dev)
    P_total = per_island * n_devices
    cfg = GAConfig(max_delay=0.05)

    def time_mesh(mesh, rings):
        state = init_island_state(0, P_total, H, cfg, mesh=mesh)
        state, hist = fused_step(state, generations, 1, *inputs, cfg,
                                 mesh=mesh, rings=rings)
        hist.cpu()  # warm, and wait for it
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            state, hist = fused_step(state, generations, 1, *inputs, cfg,
                                     mesh=mesh, rings=rings)
            hist.cpu()
            best = min(best, time.perf_counter() - t0)
        if state.gen != 4 * generations:
            raise RuntimeError(f"fused loop left gen {state.gen}, not "
                               f"{4 * generations}")
        return best, state

    devices = island_devices(n_devices, dev)
    mesh = make_topology_mesh(host_size=host_size, devices=devices)
    rings = hier_rings(migrate_k=2, dcn_migrate_k=1, dcn_every=4)
    t_mesh, state = time_mesh(mesh, rings)
    t_single, _ = time_mesh(one_island(devices[0]), (("i", 2),))

    overhead = t_mesh / t_single if t_single > 0 else float("inf")
    n_hosts = n_devices // host_size
    best = float(state.best_fitness)
    result = {
        "n_devices": n_devices,
        "mesh": f"{n_hosts}x{host_size}",
        "population": P_total,
        "generations_per_dispatch": generations,
        "dcn_every": 4,
        "t_mesh_s": round(t_mesh, 4),
        "t_single_device_s": round(t_single, 4),
        "overhead_factor": round(overhead, 3),
        "best_fitness": best,
        "ok": True,
    }
    print(f"dryrun_multichip_fused OK: {n_hosts}x{host_size} host-chip "
          f"mesh ({_describe(mesh)}), population {P_total}, fused "
          f"{generations}-generation dispatch {t_mesh * 1e3:.1f} ms vs "
          f"{t_single * 1e3:.1f} ms on one island (overhead factor "
          f"{overhead:.2f}), best fitness {best:.4f}")
    return result


if __name__ == "__main__":
    import sys

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    if len(sys.argv) > 2 and sys.argv[2] == "fused":
        dryrun_multichip_fused(n)
    else:
        dryrun_multichip(n)
