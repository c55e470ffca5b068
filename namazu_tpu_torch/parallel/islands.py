"""The island model on the card: the port of
``namazu_tpu/parallel/islands.py``.

One generation, on every shard of the mesh (``parallel/mesh.py``): score
every row of the shard in one call (scoring is per row, so this equals
scoring each island alone), take each island's best, evolve one GA
generation per island (``models/ga.py`` over a leading island axis),
then migrate ring by ring and agree on the global best.

* **Migration**, as the reference's ``_make_local_step``: the migrants of
  a ring are an island's leading ``kk`` rows of the new population
  (elites first), ``kk = min(k, max(0, Pi - n_elite - offset))``; they
  land at rows ``[Pi - offset - kk, Pi - offset)`` of the next island
  along the ring's axis, each later ring taking the next tail slice, so
  an island's own elites are never overwritten. A ring runs only when its
  axis is longer than 1, ``kk > 0`` and ``gen % every == 0`` (``gen``
  counted before the step). Inside a shard a ring is a few row-slice
  copies; between shards it copies ``kk x H`` rows to the neighbour
  shard's device (a cross-device ``copy`` orders itself after both
  devices' current streams); across processes (the first axis of a
  distributed mesh) it is one ``all_gather`` of every island's migrants.
* **Global best**: the argmax over every island in row-major order, the
  first island on ties, as the reference's axis-by-axis ``all_gather``
  and ``argmax``; it stays on the device.
* **Draws**: island ``c`` of generation ``gen`` draws from a generator
  seeded from ``(seed, gen, c)`` (the counterpart of
  ``fold_in(fold_in(base_key, gen), axis_index)`` over every axis), so
  the same islands give the same populations however they are spread
  over shards, cards and processes; all-zero coordinates keep the
  one-island stream of ``generation_seed(seed, gen)``.
* **Ranges**: each step's parts run inside ``nmz_score``, ``nmz_mutate``,
  ``nmz_migrate`` and ``nmz_select`` (``obs.trace_range``, the
  reference's ``jax.named_scope``), so a
  ``torch.profiler`` capture attributes each kernel to its part.

Bit-exactness contract, as in the reference: G generations of
:func:`fused_step` equal G calls of :func:`island_step` bit for bit.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from namazu_tpu_torch.device import DeviceLike, resolve_device
from namazu_tpu_torch.models.ga import (
    GAConfig,
    GADraws,
    Population,
    ga_generation,
    init_population,
)
from namazu_tpu_torch.obs import trace_range
from namazu_tpu_torch.ops.schedule import (
    ScoreWeights,
    TraceArrays,
    normalize_fault_trace,
    score_population_multi,
)
from namazu_tpu_torch.parallel.mesh import IslandMesh

_MASK64 = (1 << 64) - 1


class IslandState(NamedTuple):
    # delays/faults f32[P, H], row-major by island; on a mesh of several
    # shards, a tuple of each local shard's [rows, H] block
    pop: Population
    gen: int  # generations evolved so far (host counter)
    best_fitness: torch.Tensor  # f32 scalar, on the mesh's primary device
    best_delays: torch.Tensor  # f32[H]
    best_faults: torch.Tensor  # f32[H]


def generation_seed(seed: int, gen: int) -> int:
    """63-bit seed of generation ``gen`` under base ``seed`` (splitmix64
    of the pair), so neighbouring seeds and generations never share a
    stream."""
    z = ((seed & _MASK64) * 0x9E3779B97F4A7C15 + gen + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def fold_coords(seed: int, coords: Sequence[int] = ()) -> int:
    """The seed of the island (or MCTS tree) at mesh coordinates
    ``coords`` under ``seed``: each coordinate folded in turn, the
    counterpart of ``fold_in(key, axis_index)`` over every axis. All-zero
    coordinates keep ``seed`` itself."""
    if not any(coords):
        return seed
    for c in coords:
        seed = generation_seed(seed, c)
    return seed


def generator_for(seed: int, gen: int, device: DeviceLike = "cuda",
                  coords: Sequence[int] = ()) -> torch.Generator:
    g = torch.Generator(device=resolve_device(device))
    g.manual_seed(fold_coords(generation_seed(seed, gen), coords))
    return g


def chunk_seeds(seed: int, gen: int, generations: int,
                mesh: IslandMesh) -> List[List[int]]:
    """The seeds :func:`generator_for` gives generations ``gen ..
    gen + generations - 1`` of this process's islands, ``[generation]
    [island]`` in island order: what a captured chunk's own generators
    are set to before each replay."""
    coords = [mesh.coords(i) for sh in mesh.shards
              for i in range(sh.start, sh.start + sh.islands)]
    return [[fold_coords(generation_seed(seed, gen + j), c) for c in coords]
            for j in range(generations)]


def one_island(device: DeviceLike) -> IslandMesh:
    return IslandMesh(("i",), (1,), [device])


def _parts(pop: Population) -> List[Population]:
    """The flat ``[rows, H]`` block of each local shard."""
    if torch.is_tensor(pop.delays):
        return [pop]
    return [Population(d, f) for d, f in zip(pop.delays, pop.faults)]


def _join(parts: List[Population]) -> Population:
    if len(parts) == 1:
        return parts[0]
    return Population(tuple(p.delays for p in parts),
                      tuple(p.faults for p in parts))


def shard_population(pop: Population, mesh: IslandMesh) -> Population:
    """A flat population of every island (``[P, H]``, row-major) as this
    process's shards: one tensor for one shard, else a tuple of blocks,
    each on its shard's device."""
    Pi = pop.delays.shape[0] // mesh.n_islands
    parts = [Population(*(x[s.start * Pi:(s.start + s.islands) * Pi]
                          .to(s.device) for x in pop))
             for s in mesh.shards]
    return _join(parts)


def local_population(pop: Population, mesh: IslandMesh) -> Population:
    """This process's islands as one flat ``[rows, H]`` population on the
    mesh's primary device."""
    parts = _parts(pop)
    if len(parts) == 1:
        return parts[0]
    return Population(*(torch.cat([x.to(mesh.device) for x in xs])
                        for xs in zip(*parts)))


def init_island_state(seed: int, P: int, H: int, cfg: GAConfig,
                      device: DeviceLike = "cuda",
                      mesh: Optional[IslandMesh] = None) -> IslandState:
    """A uniform population of ``P`` genomes drawn on the primary device
    (so the same for every layout of the islands) and split over the
    mesh's shards (one island on ``device`` without a mesh)."""
    mesh = mesh if mesh is not None else one_island(device)
    dev = mesh.device
    pop = init_population(generator_for(seed, -1, dev), P, H, cfg)
    return IslandState(
        pop=shard_population(pop, mesh),
        gen=0,
        best_fitness=torch.full((), float("-inf"), device=dev),
        best_delays=torch.zeros((H,), device=dev),
        best_faults=torch.zeros((H,), device=dev),
    )


def _norm_rings(rings: Sequence[Tuple]) -> Tuple[Tuple[str, int, int], ...]:
    """Rings as ``(axis, k, every)``; 2-tuples get ``every=1``."""
    out = []
    for r in rings:
        ax, k, every = r if len(r) == 3 else (*r, 1)
        out.append((str(ax), int(k), max(1, int(every))))
    return tuple(out)


def ring_plan(mesh: IslandMesh, rings: Sequence[Tuple], rows: int,
              cfg: GAConfig) -> List[Tuple[int, int, int, int]]:
    """``(axis number, kk, landing offset from the tail, every)`` of each
    ring that moves rows, in order; counts clamp so the landing region
    stays clear of the elite rows."""
    n_elite = max(1, int(rows * cfg.elite_frac))
    offset, plan = 0, []
    for ax, k, every in _norm_rings(rings):
        kk = min(k, max(0, rows - n_elite - offset))
        if mesh.shape[ax] > 1 and kk > 0:
            plan.append((mesh.axis_names.index(ax), kk, offset, every))
            offset += kk
    return plan


def _runs(mesh: IslandMesh, axis: int, shard: int, gathered: bool):
    """Where the migrants that land on a shard's islands come from, as
    ``(source, start, stop)`` slices in the shard's island order: the
    source is a local shard's index, or ``"all"`` for every island's
    migrants gathered across processes (indexed by global island)."""
    key = (axis, shard, gathered)
    runs = mesh.route_cache.get(key)
    if runs is None:
        sh = mesh.shards[shard]
        runs = []
        for g in range(sh.start, sh.start + sh.islands):
            src = mesh.predecessor(g, axis)
            where, j = ("all", src) if gathered else mesh.shard_of(src)
            if runs and runs[-1][0] == where and runs[-1][2] == j:
                runs[-1] = (where, runs[-1][1], j + 1)
            else:
                runs.append((where, j, j + 1))
        mesh.route_cache[key] = runs
    return runs


def _incoming(sources: dict, runs, device) -> torch.Tensor:
    return torch.cat([sources[w][a:b].to(device) for w, a, b in runs])


def _migrate(parts: List[Population], mesh: IslandMesh, plan, gen: int
             ) -> None:
    """Ring migration in place on the shards' ``[I_s, Pi, H]`` new
    populations. Every shard's incoming rows of a ring are copied out
    before any is written, so a ring's migrants are the rows before its
    own landing (the reference's ``ppermute``); a later ring reads the
    population after the earlier rings' landings."""
    Pi = parts[0].delays.shape[1]
    for axis, kk, off, every in plan:
        if gen % every:
            continue
        dst = Pi - off - kk
        if mesh.distributed and axis == 0:  # the ring crosses processes
            mine = torch.cat([torch.stack((p.delays[:, :kk],
                                           p.faults[:, :kk]), 1)
                              .to(mesh.device) for p in parts])
            sources = {"all": mesh.all_gather(mine).flatten(0, 1)}
            incoming = [_incoming(sources, _runs(mesh, axis, t, True),
                                  sh.device).unbind(1)
                        for t, sh in enumerate(mesh.shards)]
        else:
            src_d = {t: p.delays[:, :kk] for t, p in enumerate(parts)}
            src_f = {t: p.faults[:, :kk] for t, p in enumerate(parts)}
            incoming = []
            for t, sh in enumerate(mesh.shards):
                runs = _runs(mesh, axis, t, False)
                incoming.append((_incoming(src_d, runs, sh.device),
                                 _incoming(src_f, runs, sh.device)))
        for p, (inc_d, inc_f) in zip(parts, incoming):
            p.delays[:, dst:dst + kk].copy_(inc_d)
            p.faults[:, dst:dst + kk].copy_(inc_f)


def global_best(cands, mesh: IslandMesh):
    """``(fitness, delays, faults)`` of the best of the local candidates
    (one a shard, in island order) and, on a distributed mesh, of every
    process's: the first on ties, on the primary device."""
    fit, d, f = cands[0]
    if len(cands) > 1:
        dev = mesh.device
        fits = torch.stack([c[0].to(dev) for c in cands])
        j = fits.argmax()
        fit = fits[j]
        d = torch.stack([c[1].to(dev) for c in cands])[j]
        f = torch.stack([c[2].to(dev) for c in cands])[j]
    if mesh.distributed:
        H = d.shape[0]
        every = mesh.all_gather(torch.cat([fit.reshape(1), d, f]))
        row = every[every[:, 0].argmax()]
        fit, d, f = row[0], row[1:1 + H], row[1 + H:]
    return fit, d, f


def _prepare(traces: TraceArrays, coin, cfg: GAConfig) -> TraceArrays:
    if coin is None and cfg.max_fault > 0:
        raise ValueError(
            "fault search is enabled (max_fault > 0) but no fault coin "
            "was passed to the island step; build one with "
            "trace_encoding.fault_coin(seed, H)")
    if traces.hint_ids.dim() == 1:  # single trace -> batch of one
        traces = TraceArrays(*(None if x is None else x[None]
                               for x in traces))
    return normalize_fault_trace(traces, coin)


def replicate(mesh: IslandMesh, *tensors) -> dict:
    """``{device: tensors on it}`` for every shard's device (``None`` and
    :class:`TraceArrays` fields carried through); on the primary device
    the tensors themselves."""
    def to(x, dev):
        if x is None or not isinstance(x, (torch.Tensor, tuple)):
            return x
        if isinstance(x, tuple):
            return type(x)(*(to(y, dev) for y in x))
        return x.to(dev)

    return {sh.device: tuple(to(x, sh.device) for x in tensors)
            for sh in mesh.shards}


def _step(state: IslandState, seed: int, inputs: dict, cfg: GAConfig,
          weights: ScoreWeights, novelty_scale, mesh: IslandMesh, rings,
          draws, gens=None) -> Tuple[IslandState, torch.Tensor]:
    parts = _parts(state.pop)
    H = parts[0].delays.shape[1]
    Pi = parts[0].delays.shape[0] // mesh.shards[0].islands
    if isinstance(draws, GADraws):
        draws = [draws]
    new_parts, cands = [], []
    for k, (sh, p) in enumerate(zip(mesh.shards, parts)):
        traces, pairs, archive, failures, coin, bias = inputs[sh.device]
        with trace_range("nmz_score"):
            fitness, _ = score_population_multi(
                p.delays, traces, pairs, archive, failures, weights,
                faults=None if coin is None else p.faults, coin=coin,
                novelty_scale=novelty_scale)
        # the first island, then the first row; gathered on the device (a
        # 0-dim index tensor would be read back to the host)
        best_i = fitness.argmax().reshape(1)
        cands.append(tuple(x.index_select(0, best_i)[0]
                           for x in (fitness, p.delays, p.faults)))
        I = sh.islands
        with trace_range("nmz_mutate"):
            if draws is not None:
                shard_gens = None
            elif gens is not None:
                shard_gens = gens[k]
            else:
                shard_gens = [
                    generator_for(seed, state.gen, sh.device, mesh.coords(g))
                    for g in range(sh.start, sh.start + I)]
            new_parts.append(ga_generation(
                shard_gens, Population(p.delays.view(I, Pi, H),
                                       p.faults.view(I, Pi, H)),
                fitness.view(I, Pi), cfg, delay_bias=bias,
                draws=None if draws is None else draws[k]))
    with trace_range("nmz_migrate"):
        _migrate(new_parts, mesh, ring_plan(mesh, rings, Pi, cfg),
                 state.gen)
    with trace_range("nmz_select"):
        fit, best_d, best_f = global_best(cands, mesh)
        improved = fit > state.best_fitness
        best = (torch.where(improved, fit, state.best_fitness),
                torch.where(improved, best_d, state.best_delays),
                torch.where(improved, best_f, state.best_faults))
    return IslandState(
        pop=_join([Population(x.delays.reshape(-1, H),
                              x.faults.reshape(-1, H)) for x in new_parts]),
        gen=state.gen + 1,
        best_fitness=best[0], best_delays=best[1], best_faults=best[2],
    ), fit


def island_step(state: IslandState, seed: int, traces: TraceArrays,
                pairs: torch.Tensor, archive: torch.Tensor,
                failures: torch.Tensor, cfg: GAConfig,
                weights: ScoreWeights = ScoreWeights(),
                novelty_scale=None,
                mutation_bias: Optional[torch.Tensor] = None,
                draws=None,
                coin: Optional[torch.Tensor] = None,
                mesh: Optional[IslandMesh] = None,
                rings: Sequence[Tuple] = ()
                ) -> Tuple[IslandState, torch.Tensor]:
    """One generation over ``mesh`` (one island on the state's device
    without one): score -> island bests -> GA -> ring migration ->
    global best. ``rings`` are ``(axis, k)`` or ``(axis, k, every)``.
    Returns the new state and this generation's global best fitness (a
    device scalar; nothing here waits for the device). The inputs live
    on the primary device and are copied to other shards' devices. With
    the fault ``coin f32[H]`` the population's fault half is scored;
    ``cfg.max_fault > 0`` without one raises ``ValueError``, as in the
    reference (the fault half would evolve unscored). ``draws``: a
    :class:`GADraws` (one shard; ``[Pi, ...]`` or stacked ``[I, Pi,
    ...]``) or one stacked per shard, in place of the generators."""
    traces = _prepare(traces, coin, cfg)
    mesh = mesh if mesh is not None else one_island(state.best_fitness.device)
    inputs = replicate(mesh, traces, pairs, archive, failures, coin,
                       mutation_bias)
    return _step(state, seed, inputs, cfg, weights, novelty_scale, mesh,
                 rings, draws)


def fused_step(state: IslandState, generations: int, seed: int,
               traces: TraceArrays, pairs: torch.Tensor,
               archive: torch.Tensor, failures: torch.Tensor,
               cfg: GAConfig, weights: ScoreWeights = ScoreWeights(),
               novelty_scale=None,
               mutation_bias: Optional[torch.Tensor] = None,
               coin: Optional[torch.Tensor] = None,
               mesh: Optional[IslandMesh] = None,
               rings: Sequence[Tuple] = (),
               gens=None) -> Tuple[IslandState, torch.Tensor]:
    """``generations`` island steps in one call, with no host sync inside
    (the inputs are copied to the shards' devices once). Returns the
    state and ``fit_hist f32[generations]``, the global best fitness of
    each generation, left on the device for the caller to drain.
    ``gens[j][k]``: the generators of shard ``k``'s islands in generation
    ``j`` of the call, in place of fresh ones seeded by
    :func:`generator_for` (a captured chunk's own, set to
    :func:`chunk_seeds` before each replay)."""
    if generations < 1:
        raise ValueError(f"generations must be >= 1, got {generations}")
    traces = _prepare(traces, coin, cfg)
    mesh = mesh if mesh is not None else one_island(state.best_fitness.device)
    inputs = replicate(mesh, traces, pairs, archive, failures, coin,
                       mutation_bias)
    hist = []
    for j in range(generations):
        state, fit = _step(state, seed, inputs, cfg, weights, novelty_scale,
                           mesh, rings, None,
                           None if gens is None else gens[j])
        hist.append(fit)
    return state, torch.stack(hist)
