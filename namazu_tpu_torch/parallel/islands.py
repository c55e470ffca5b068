"""The island step on one card: the port of
``namazu_tpu/parallel/islands.py`` for a single island.

One generation scores the population, takes the island's best, evolves
one GA generation and updates the best-so-far. On one device the
reference's mesh has one island, so no migration runs and the global
best is the island's best; more islands, ring migration and several
cards are later slices of the port.

Bit-exactness contract, as in the reference: the random numbers of
generation ``gen`` come from a generator seeded from ``(seed, gen)``
(the counterpart of ``fold_in(base_key, gen)``), so G generations of
:func:`fused_step` equal G calls of :func:`island_step` bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from namazu_tpu_torch.device import DeviceLike, resolve_device
from namazu_tpu_torch.models.ga import (
    GAConfig,
    GADraws,
    Population,
    ga_generation,
    init_population,
)
from namazu_tpu_torch.ops.schedule import (
    ScoreWeights,
    TraceArrays,
    normalize_fault_trace,
    score_population_multi,
)

_MASK64 = (1 << 64) - 1


class IslandState(NamedTuple):
    pop: Population  # delays/faults f32[P, H]
    gen: int  # generations evolved so far (host counter)
    best_fitness: torch.Tensor  # f32 scalar
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


def generator_for(seed: int, gen: int,
                  device: DeviceLike = "cuda") -> torch.Generator:
    g = torch.Generator(device=resolve_device(device))
    g.manual_seed(generation_seed(seed, gen))
    return g


def init_island_state(seed: int, P: int, H: int, cfg: GAConfig,
                      device: DeviceLike = "cuda") -> IslandState:
    device = resolve_device(device)
    pop = init_population(generator_for(seed, -1, device), P, H, cfg)
    return IslandState(
        pop=pop,
        gen=0,
        best_fitness=torch.full((), float("-inf"), device=device),
        best_delays=torch.zeros((H,), device=device),
        best_faults=torch.zeros((H,), device=device),
    )


def island_step(state: IslandState, seed: int, traces: TraceArrays,
                pairs: torch.Tensor, archive: torch.Tensor,
                failures: torch.Tensor, cfg: GAConfig,
                weights: ScoreWeights = ScoreWeights(),
                novelty_scale=None,
                mutation_bias: Optional[torch.Tensor] = None,
                draws: Optional[GADraws] = None,
                coin: Optional[torch.Tensor] = None
                ) -> Tuple[IslandState, torch.Tensor]:
    """One generation: score -> island best -> GA -> best update.
    Returns the new state and this generation's best fitness (a device
    scalar; nothing here waits for the device). With the fault ``coin
    f32[H]`` the population's fault half is scored; ``cfg.max_fault > 0``
    without one raises ``ValueError``, as in the reference (the fault
    half would evolve unscored)."""
    if coin is None and cfg.max_fault > 0:
        raise ValueError(
            "fault search is enabled (max_fault > 0) but no fault coin "
            "was passed to the island step; build one with "
            "trace_encoding.fault_coin(seed, H)")
    if traces.hint_ids.dim() == 1:  # single trace -> batch of one
        traces = TraceArrays(*(None if x is None else x[None]
                               for x in traces))
    traces = normalize_fault_trace(traces, coin)
    pop = state.pop
    fitness, _ = score_population_multi(
        pop.delays, traces, pairs, archive, failures, weights,
        faults=None if coin is None else pop.faults, coin=coin,
        novelty_scale=novelty_scale)
    best_i = fitness.argmax()
    fit = fitness[best_i]
    gen = None if draws is not None else generator_for(
        seed, state.gen, pop.delays.device)
    new_pop = ga_generation(gen, pop, fitness, cfg,
                            delay_bias=mutation_bias, draws=draws)
    improved = fit > state.best_fitness
    return IslandState(
        pop=new_pop,
        gen=state.gen + 1,
        best_fitness=torch.where(improved, fit, state.best_fitness),
        best_delays=torch.where(improved, pop.delays[best_i],
                                state.best_delays),
        best_faults=torch.where(improved, pop.faults[best_i],
                                state.best_faults),
    ), fit


def fused_step(state: IslandState, generations: int, seed: int,
               traces: TraceArrays, pairs: torch.Tensor,
               archive: torch.Tensor, failures: torch.Tensor,
               cfg: GAConfig, weights: ScoreWeights = ScoreWeights(),
               novelty_scale=None,
               mutation_bias: Optional[torch.Tensor] = None,
               coin: Optional[torch.Tensor] = None
               ) -> Tuple[IslandState, torch.Tensor]:
    """``generations`` island steps in one call, with no host sync inside.
    Returns the state and ``fit_hist f32[generations]``, the best fitness
    of each generation, left on the device for the caller to drain."""
    if generations < 1:
        raise ValueError(f"generations must be >= 1, got {generations}")
    hist = []
    for _ in range(generations):
        state, fit = island_step(state, seed, traces, pairs, archive,
                                 failures, cfg, weights, novelty_scale,
                                 mutation_bias, coin=coin)
        hist.append(fit)
    return state, torch.stack(hist)
