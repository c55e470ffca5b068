"""Genetic algorithm over schedule genomes: the port of
``namazu_tpu/models/ga.py``.

One generation is tournament selection -> uniform crossover ->
gaussian mutation -> elitism. Its random numbers come either from a
``torch.Generator`` or, in the draws-in form, from a :class:`GADraws`
handed in, so a test can feed the reference's own ``jax.random`` draws
and compare populations exactly. ``bernoulli(p)`` is ``uniform < p`` on
both sides.

Genome layout: ``delays f32[P, H]`` in [0, max_delay], ``faults f32[P, H]``
in [0, max_fault].
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class GAConfig(NamedTuple):
    max_delay: float = 0.1  # seconds; genome delay range
    max_fault: float = 0.0  # per-hint fault probability cap (0 = off)
    tournament_size: int = 3
    crossover_rate: float = 0.6
    mutation_sigma: float = 0.01  # gaussian sigma on delays, seconds
    mutation_rate: float = 0.15  # per-gene mutation probability
    elite_frac: float = 0.0625  # top fraction copied through unchanged


class Population(NamedTuple):
    delays: torch.Tensor  # f32[P, H]
    faults: torch.Tensor  # f32[P, H]


class GADraws(NamedTuple):
    """Every random number one generation consumes."""

    cand_a: torch.Tensor  # int64[P, k] tournament candidates, parent a
    cand_b: torch.Tensor  # int64[P, k] tournament candidates, parent b
    xo_do: torch.Tensor  # f32[P, 1] crossover do-uniforms
    xo_mask: torch.Tensor  # f32[P, H] crossover mask-uniforms
    noise_d: torch.Tensor  # f32[P, H] standard normals, delay half
    mut_d: torch.Tensor  # f32[P, H] mutation uniforms, delay half
    noise_f: torch.Tensor  # f32[P, H] standard normals, fault half
    mut_f: torch.Tensor  # f32[P, H] mutation uniforms, fault half


def init_population(gen: torch.Generator, P: int, H: int,
                    cfg: GAConfig) -> Population:
    """A uniform population on the generator's device."""
    delays = torch.rand((P, H), generator=gen, device=gen.device)
    faults = torch.rand((P, H), generator=gen, device=gen.device)
    return Population(delays * cfg.max_delay, faults * cfg.max_fault)


def draw_generation(gen: torch.Generator, P: int, H: int,
                    cfg: GAConfig) -> GADraws:
    """One generation's draws from ``gen`` (on the generator's device)."""
    dev = gen.device
    k = cfg.tournament_size

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    return GADraws(
        cand_a=torch.randint(0, P, (P, k), generator=gen, device=dev),
        cand_b=torch.randint(0, P, (P, k), generator=gen, device=dev),
        xo_do=rand(P, 1), xo_mask=rand(P, H),
        noise_d=randn(P, H), mut_d=rand(P, H),
        noise_f=randn(P, H), mut_f=rand(P, H),
    )


def tournament_select(cand: torch.Tensor,
                      fitness: torch.Tensor) -> torch.Tensor:
    """Winners of size-k tournaments (candidates drawn with replacement):
    ``cand int64[n, k] -> int64[n]``; ties go to the first candidate."""
    win = fitness[cand].argmax(-1, keepdim=True)
    return cand.gather(-1, win).squeeze(-1)


def _uniform_crossover(do_u: torch.Tensor, mask_u: torch.Tensor,
                       a: torch.Tensor, b: torch.Tensor,
                       rate: float) -> torch.Tensor:
    child = torch.where(mask_u < 0.5, a, b)
    return torch.where(do_u < rate, child, a)


def _mutate(noise: torch.Tensor, mut_u: torch.Tensor, x: torch.Tensor,
            sigma: float, rate: float, lo: float, hi: float,
            rate_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``rate_scale`` (f32[H]) multiplies the per-gene mutation
    probability, clipped to [0, 1]; ``None`` and all-ones give the same
    result bit for bit (the threshold is the same f32 value)."""
    p = rate if rate_scale is None \
        else torch.clamp(rate * rate_scale, 0.0, 1.0)
    step = torch.where(mut_u < p, noise * sigma, 0.0)
    return torch.clamp(x + step, lo, hi)


def ga_generation(gen: Optional[torch.Generator], pop: Population,
                  fitness: torch.Tensor, cfg: GAConfig,
                  delay_bias: Optional[torch.Tensor] = None,
                  draws: Optional[GADraws] = None) -> Population:
    """Evolve one generation. Elites (top ``elite_frac`` by fitness, in
    ``topk`` order) survive unchanged in rows ``[0:n_elite)``; the rest
    are tournament offspring. As in the reference, the delay and fault
    halves share one crossover mask and do-flag, and ``delay_bias``
    scales the delay half's mutation rate only. Draws come from ``draws``
    when given, else from ``gen``."""
    P, H = pop.delays.shape
    n_elite = max(1, int(P * cfg.elite_frac))
    if draws is None:
        draws = draw_generation(gen, P, H, cfg)

    elite_idx = torch.topk(fitness, n_elite).indices
    pa = tournament_select(draws.cand_a, fitness)
    pb = tournament_select(draws.cand_b, fitness)
    child_d = _uniform_crossover(draws.xo_do, draws.xo_mask,
                                 pop.delays[pa], pop.delays[pb],
                                 cfg.crossover_rate)
    child_f = _uniform_crossover(draws.xo_do, draws.xo_mask,
                                 pop.faults[pa], pop.faults[pb],
                                 cfg.crossover_rate)
    child_d = _mutate(draws.noise_d, draws.mut_d, child_d,
                      cfg.mutation_sigma, cfg.mutation_rate,
                      0.0, cfg.max_delay, rate_scale=delay_bias)
    child_f = _mutate(draws.noise_f, draws.mut_f, child_f,
                      cfg.mutation_sigma * 0.5, cfg.mutation_rate,
                      0.0, cfg.max_fault)
    child_d[:n_elite] = pop.delays[elite_idx]
    child_f[:n_elite] = pop.faults[elite_idx]
    return Population(child_d, child_f)
