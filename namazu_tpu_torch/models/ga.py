"""Genetic algorithm over schedule genomes: the port of
``namazu_tpu/models/ga.py``.

One generation is tournament selection -> uniform crossover ->
gaussian mutation -> elitism, for one island or for a stack of islands
(a leading island axis, ``parallel/islands.py``). Its random numbers
come either from a ``torch.Generator`` (one an island) or, in the draws-in form, from a :class:`GADraws`
handed in, so a test can feed the reference's own ``jax.random`` draws
and compare populations exactly. ``bernoulli(p)`` is ``uniform < p`` on
both sides.

Genome layout: ``delays f32[P, H]`` in [0, max_delay], ``faults f32[P, H]``
in [0, max_fault].
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

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
    """Every random number one generation of one island consumes; the
    stacked form (:func:`draw_islands`) has a leading island axis."""

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


def draw_generation(gen: torch.Generator, P: int, H: int, cfg: GAConfig,
                    out: Optional[GADraws] = None) -> GADraws:
    """One island's draws for one generation from ``gen`` (on the
    generator's device), written into ``out`` when given (one island's
    rows of a stacked buffer)."""
    if out is None:
        out = _empty_draws((), P, H, cfg, gen.device)
    for x in (out.cand_a, out.cand_b):
        torch.randint(0, P, x.shape, generator=gen, out=x)
    for x, normal in ((out.xo_do, False), (out.xo_mask, False),
                      (out.noise_d, True), (out.mut_d, False),
                      (out.noise_f, True), (out.mut_f, False)):
        (torch.randn if normal else torch.rand)(x.shape, generator=gen,
                                                out=x)
    return out


def _empty_draws(lead: tuple, P: int, H: int, cfg: GAConfig,
                 device) -> GADraws:
    k = cfg.tournament_size

    def f32(*shape):
        return torch.empty(lead + shape, device=device)

    return GADraws(
        cand_a=torch.empty(lead + (P, k), dtype=torch.int64, device=device),
        cand_b=torch.empty(lead + (P, k), dtype=torch.int64, device=device),
        xo_do=f32(P, 1), xo_mask=f32(P, H), noise_d=f32(P, H),
        mut_d=f32(P, H), noise_f=f32(P, H), mut_f=f32(P, H))


def draw_islands(gens: Sequence[torch.Generator], P: int, H: int,
                 cfg: GAConfig) -> GADraws:
    """Stacked draws ``[I, ...]`` of I islands, island ``i`` drawn from
    ``gens[i]`` exactly as :func:`draw_generation` draws it alone (eight
    RNG launches an island)."""
    out = _empty_draws((len(gens),), P, H, cfg, gens[0].device)
    for i, g in enumerate(gens):
        draw_generation(g, P, H, cfg, out=GADraws(*(x[i] for x in out)))
    return out


def tournament_select(cand: torch.Tensor,
                      fitness: torch.Tensor) -> torch.Tensor:
    """Winners of size-k tournaments (candidates drawn with replacement):
    ``cand int64[.., n, k]`` indexing ``fitness [.., P]`` along its last
    axis -> ``int64[.., n]``; ties go to the first candidate."""
    f = fitness.gather(-1, cand.flatten(-2)).view(cand.shape)
    win = f.argmax(-1, keepdim=True)
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


def ga_generation(gen, pop: Population, fitness: torch.Tensor,
                  cfg: GAConfig, delay_bias: Optional[torch.Tensor] = None,
                  draws: Optional[GADraws] = None) -> Population:
    """Evolve one generation of one island (``pop [P, H]``, ``fitness
    [P]``) or of I islands at once (``[I, P, H]``, ``[I, P]``), each island
    on its own: elites (an island's top ``elite_frac`` by fitness, ties to
    the lower row as in ``lax.top_k``) survive unchanged in its rows
    ``[0:n_elite)``; the rest are tournament offspring of its own rows. As
    in the reference, the delay and fault halves share one crossover mask
    and do-flag, and ``delay_bias`` scales the delay half's mutation rate
    only. Draws come from ``draws`` (``[P, ...]`` or stacked ``[I, P,
    ...]``) when given, else from ``gen``: a generator, or one per
    island."""
    single = pop.delays.dim() == 2
    if single:
        pop = Population(pop.delays[None], pop.faults[None])
        fitness = fitness[None]
    I, P, H = pop.delays.shape
    n_elite = max(1, int(P * cfg.elite_frac))
    if draws is None:
        gens = [gen] if isinstance(gen, torch.Generator) else list(gen)
        draws = draw_islands(gens, P, H, cfg)
    elif draws.cand_a.dim() == 2:
        draws = GADraws(*(x[None] for x in draws))

    elite_idx = torch.sort(fitness, dim=-1, descending=True,
                           stable=True).indices[:, :n_elite]
    pa = tournament_select(draws.cand_a, fitness)
    pb = tournament_select(draws.cand_b, fitness)
    if I > 1:  # island-local rows -> rows of the flattened [I * P, H]
        base = torch.arange(0, I * P, P, device=fitness.device)[:, None]
        elite_idx, pa, pb = elite_idx + base, pa + base, pb + base
    delays, faults = pop.delays.reshape(I * P, H), pop.faults.reshape(I * P, H)

    def rows(x, idx):
        return x[idx.reshape(-1)].view(idx.shape + (H,))

    child_d = _uniform_crossover(draws.xo_do, draws.xo_mask,
                                 rows(delays, pa), rows(delays, pb),
                                 cfg.crossover_rate)
    child_f = _uniform_crossover(draws.xo_do, draws.xo_mask,
                                 rows(faults, pa), rows(faults, pb),
                                 cfg.crossover_rate)
    child_d = _mutate(draws.noise_d, draws.mut_d, child_d,
                      cfg.mutation_sigma, cfg.mutation_rate,
                      0.0, cfg.max_delay, rate_scale=delay_bias)
    child_f = _mutate(draws.noise_f, draws.mut_f, child_f,
                      cfg.mutation_sigma * 0.5, cfg.mutation_rate,
                      0.0, cfg.max_fault)
    child_d[:, :n_elite] = rows(delays, elite_idx)
    child_f[:, :n_elite] = rows(faults, elite_idx)
    if single:
        return Population(child_d[0], child_f[0])
    return Population(child_d, child_f)
