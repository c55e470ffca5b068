"""The port's GA (namazu_tpu_torch/models/ga.py) held to
namazu_tpu/models/ga.py.

JAX's threefry and torch's Philox cannot agree, so the draws are made by
``jax.random`` under the reference's key, following the splits of
``ga_generation`` (namazu_tpu/models/ga.py:98-111), and handed to the
port's draws-in form. Given the same draws, the populations must be equal
exactly: every step is a gather, a comparison, an f32 multiply, an add or
a clip.

One rounding differs by construction: XLA folds ``normal * sigma`` into
``erf_inv(u) * (sqrt(2) * sigma)``, one multiply by a folded constant, so
for a general sigma the reference's mutation step can sit one ulp from
``normal * sigma``. With a power-of-two sigma both products are exact and
the populations must be identical; at the default sigma they must agree
to one ulp of the delay range."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from namazu_tpu.models import ga as jga
from namazu_tpu_torch.models import ga as tga
from namazu_tpu_torch.parallel.islands import generator_for

P, H = 64, 32
SIGMA = 2.0 ** -6  # power of two: the reference's folded product is exact


def jax_draws(key, P, H, cfg) -> tga.GADraws:
    """The draws the reference's ga_generation consumes under ``key``."""
    ks = jax.random.split(key, 6)
    k = cfg.tournament_size
    km, kr = jax.random.split(ks[2])  # shared by both crossover halves
    kn_d, km_d = jax.random.split(ks[3])
    kn_f, km_f = jax.random.split(ks[4])

    def t(x):
        return torch.from_numpy(np.array(x))

    return tga.GADraws(
        cand_a=t(jax.random.randint(ks[0], (P, k), 0, P)).long(),
        cand_b=t(jax.random.randint(ks[1], (P, k), 0, P)).long(),
        xo_do=t(jax.random.uniform(kr, (P, 1))),
        xo_mask=t(jax.random.uniform(km, (P, H))),
        noise_d=t(jax.random.normal(kn_d, (P, H))),
        mut_d=t(jax.random.uniform(km_d, (P, H))),
        noise_f=t(jax.random.normal(kn_f, (P, H))),
        mut_f=t(jax.random.uniform(km_f, (P, H))),
    )


def make_case(seed, cfg):
    rng = np.random.RandomState(seed)
    delays = (rng.rand(P, H) * cfg.max_delay).astype(np.float32)
    faults = (rng.rand(P, H) * cfg.max_fault).astype(np.float32)
    fitness = rng.randn(P).astype(np.float32)
    return delays, faults, fitness


def bias_of(kind):
    if kind == "none":
        return None
    if kind == "ones":
        return np.ones((H,), np.float32)
    return (np.random.RandomState(9).rand(H) * 8).astype(np.float32)


@pytest.mark.parametrize("max_fault", [0.0, 0.3])
@pytest.mark.parametrize("bias", ["none", "ones", "random"])
def test_ga_generation_matches_reference_exactly(bias, max_fault):
    cfg = jga.GAConfig(max_delay=0.05, max_fault=max_fault,
                       mutation_sigma=SIGMA)
    delays, faults, fitness = make_case(1, cfg)
    key = jax.random.PRNGKey(7)
    b = bias_of(bias)
    want = jga.ga_generation(
        key, jga.Population(jnp.asarray(delays), jnp.asarray(faults)),
        jnp.asarray(fitness), cfg,
        delay_bias=None if b is None else jnp.asarray(b))
    got = tga.ga_generation(
        None, tga.Population(torch.from_numpy(delays),
                             torch.from_numpy(faults)),
        torch.from_numpy(fitness), tga.GAConfig(*cfg),
        delay_bias=None if b is None else torch.from_numpy(b),
        draws=jax_draws(key, P, H, cfg))
    assert np.array_equal(got.delays.numpy(), np.asarray(want.delays))
    assert np.array_equal(got.faults.numpy(), np.asarray(want.faults))


def test_default_sigma_matches_reference_to_one_ulp():
    cfg = jga.GAConfig(max_delay=0.05)
    delays, faults, fitness = make_case(4, cfg)
    key = jax.random.PRNGKey(8)
    want = jga.ga_generation(
        key, jga.Population(jnp.asarray(delays), jnp.asarray(faults)),
        jnp.asarray(fitness), cfg)
    got = tga.ga_generation(
        None, tga.Population(torch.from_numpy(delays),
                             torch.from_numpy(faults)),
        torch.from_numpy(fitness), tga.GAConfig(*cfg),
        draws=jax_draws(key, P, H, cfg))
    ulp = np.spacing(np.float32(cfg.max_delay))
    np.testing.assert_allclose(got.delays.numpy(), np.asarray(want.delays),
                               rtol=0, atol=ulp)


def test_all_ones_bias_equals_no_bias_bit_for_bit():
    cfg = tga.GAConfig(max_delay=0.05)
    delays, faults, fitness = make_case(2, cfg)
    pop = tga.Population(torch.from_numpy(delays), torch.from_numpy(faults))
    fit = torch.from_numpy(fitness)
    a = tga.ga_generation(generator_for(5, 3, "cpu"), pop, fit, cfg)
    b = tga.ga_generation(generator_for(5, 3, "cpu"), pop, fit, cfg,
                          delay_bias=torch.ones(H))
    assert torch.equal(a.delays, b.delays)
    assert torch.equal(a.faults, b.faults)


def test_elites_fill_leading_rows_in_topk_order():
    cfg = tga.GAConfig(max_delay=0.05)
    delays, faults, fitness = make_case(3, cfg)
    new = tga.ga_generation(
        generator_for(1, 0, "cpu"),
        tga.Population(torch.from_numpy(delays), torch.from_numpy(faults)),
        torch.from_numpy(fitness), cfg)
    n_elite = max(1, int(P * cfg.elite_frac))
    order = np.argsort(-fitness, kind="stable")[:n_elite]
    assert np.array_equal(new.delays[:n_elite].numpy(), delays[order])
    assert float(new.delays.min()) >= 0.0
    assert float(new.delays.max()) <= np.float32(cfg.max_delay)


def test_tournament_samples_with_replacement_and_picks_first_best():
    fitness = torch.tensor([0.0, 3.0, 1.0, 3.0])
    cand = torch.tensor([[2, 2, 2], [3, 1, 0], [1, 3, 2]])
    assert tga.tournament_select(cand, fitness).tolist() == [2, 3, 1]


def test_generator_draws_are_reproducible_per_generation():
    cfg = tga.GAConfig()
    a = tga.draw_generation(generator_for(11, 4, "cpu"), P, H, cfg)
    b = tga.draw_generation(generator_for(11, 4, "cpu"), P, H, cfg)
    c = tga.draw_generation(generator_for(11, 5, "cpu"), P, H, cfg)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a.noise_d, c.noise_d)
    assert a.cand_a.dtype == torch.int64 and int(a.cand_a.max()) < P


def test_init_population_ranges_and_fields():
    cfg = tga.GAConfig(max_delay=0.2)
    pop = tga.init_population(generator_for(0, -1, "cpu"), P, H, cfg)
    assert pop.delays.shape == (P, H) and pop.delays.dtype == torch.float32
    assert 0.0 <= float(pop.delays.min()) and float(pop.delays.max()) < 0.2
    assert float(pop.faults.abs().max()) == 0.0
    assert tga.GAConfig._fields == jga.GAConfig._fields
    assert tuple(tga.GAConfig()) == tuple(jga.GAConfig())
