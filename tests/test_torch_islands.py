"""The port's island model (namazu_tpu_torch/parallel/islands.py, mesh.py,
distributed.py and ScheduleSearch over a mesh) held to the reference's
(namazu_tpu/parallel/islands.py, distributed.py) on the CPU, where
tests/conftest.py gives JAX 8 virtual devices.

Each island's draws are made by ``jax.random`` under the key the
reference's island consumes, ``fold_in(fold_in(base, gen), coord)`` over
every mesh axis (``tests/test_torch_ga.py``'s ``jax_draws``), and fed to
the port stacked ``[I, Pi, ...]``, with a power-of-two mutation sigma:
populations must then be equal exactly, best fitness within rtol 1e-3 /
atol 1e-4, best tables exactly. Then the reference's own cases (marker
transport, the k clamp, the migration cadence), the port's contracts
(layout independence, one island = the one-island stream) and the search
end to end, checkpoints across the two packages included. Sizes are
small (H = K = 32, 8-32 genomes an island)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from namazu_tpu.models import ga as jga
from namazu_tpu.models import search as jsearch
from namazu_tpu.ops import schedule as jsched
from namazu_tpu.parallel import distributed as jdist
from namazu_tpu.parallel import islands as jisl
from namazu_tpu.parallel.mesh import make_mesh as jmake_mesh
from namazu_tpu_torch.models import ga as tga
from namazu_tpu_torch.models import search as tsearch
from namazu_tpu_torch.ops import schedule as tsched
from namazu_tpu_torch.ops import trace_encoding as tte
from namazu_tpu_torch.parallel import distributed as tdist
from namazu_tpu_torch.parallel import islands as tisl
from namazu_tpu_torch.parallel.mesh import make_mesh
from test_torch_ga import SIGMA, jax_draws
from test_torch_search import (
    jax_cfg,
    port_cfg,
    refs,
    seed_archives,
)

RTOL, ATOL = 1e-3, 1e-4
H = K = 32
CFG = tga.GAConfig(max_delay=0.05, mutation_sigma=SIGMA)


def inputs(seed=0):
    """Two reference traces, random archives (so fitness spreads) and
    both packages' arrays of them."""
    rng = np.random.RandomState(seed)
    encs = refs(tte)
    h, _, a, m, _ = tte.stack_traces(encs)
    pairs = tte.sample_pairs(K, H, seed)
    archive = rng.rand(16, K).astype(np.float32)
    failures = rng.rand(4, K).astype(np.float32)
    port = (tsched.TraceArrays(torch.from_numpy(h).long(),
                               torch.from_numpy(a), torch.from_numpy(m)),
            torch.from_numpy(pairs), torch.from_numpy(archive),
            torch.from_numpy(failures))
    ref = (jsched.TraceArrays(jnp.asarray(h), jnp.asarray(a),
                              jnp.asarray(m)),
           jnp.asarray(pairs), jnp.asarray(archive), jnp.asarray(failures))
    return port, ref


def port_state(jstate, mesh):
    """The reference's island state as the port's on ``mesh``."""
    pop = tga.Population(torch.from_numpy(np.array(jstate.pop.delays)),
                         torch.from_numpy(np.array(jstate.pop.faults)))
    return tisl.IslandState(
        pop=tisl.shard_population(pop, mesh), gen=int(jstate.gen),
        best_fitness=torch.tensor(float(jstate.best_fitness)),
        best_delays=torch.from_numpy(np.array(jstate.best_delays)),
        best_faults=torch.from_numpy(np.array(jstate.best_faults)))


def reference_draws(jmesh, base, gen, Pi):
    """Every island's draws of generation ``gen``, stacked in row-major
    island order: the key of island ``c`` folds ``gen`` then each of its
    coordinates into ``base``, as ``_make_local_step`` does."""
    sizes = tuple(jmesh.shape[a] for a in jmesh.axis_names)
    per = []
    for coords in np.ndindex(*sizes):
        key = jax.random.fold_in(base, gen)
        for c in coords:
            key = jax.random.fold_in(key, int(c))
        per.append(jax_draws(key, Pi, H, CFG))
    return tga.GADraws(*(torch.stack(xs) for xs in zip(*per)))


@pytest.mark.parametrize("kind", ["flat8", "hybrid2x4", "hybrid2x2"])
def test_island_steps_match_reference(kind):
    """One generation of the flat 8-island ring (``("i", 4, 1)``, P =
    128), or two of the hybrid meshes with ``hier_rings(2, 1,
    dcn_every=2)`` (P = 64 over 2 x 4 and 2 x 2 islands)."""
    port, ref = inputs()
    if kind == "flat8":
        jmesh, P, gens = jmake_mesh(8), 128, 1
        rings = (("i", 4, 1),)
        mesh = make_mesh(8, device="cpu")
    else:
        n = 8 if kind == "hybrid2x4" else 4
        jmesh = jdist.make_hybrid_mesh(n_hosts=2, devices=jax.devices()[:n])
        mesh = tdist.make_hybrid_mesh(n_hosts=2, devices=["cpu"] * n)
        P, gens = 64, 2
        rings = jdist.hier_rings(migrate_k=2, dcn_migrate_k=1, dcn_every=2)
    assert mesh.shape == dict(jmesh.shape)
    jcfg = jga.GAConfig(*CFG)
    step = jisl.make_multiaxis_island_step(jmesh, jcfg, jsched.ScoreWeights(),
                                           rings=rings)
    base = jax.random.PRNGKey(4)
    jstate = jisl.init_island_state(jax.random.PRNGKey(0), P, H, jcfg)
    state = port_state(jstate, mesh)
    Pi = P // mesh.n_islands
    for g in range(gens):
        jstate = step(jstate, base, *ref)
        state, fit = tisl.island_step(
            state, 0, *port, CFG, draws=reference_draws(jmesh, base, g, Pi),
            mesh=mesh, rings=rings)
        assert np.array_equal(state.pop.delays.numpy(),
                              np.asarray(jstate.pop.delays))
        assert np.array_equal(state.pop.faults.numpy(),
                              np.asarray(jstate.pop.faults))
        np.testing.assert_allclose(float(state.best_fitness),
                                   float(jstate.best_fitness), rtol=RTOL,
                                   atol=ATOL)
        assert np.array_equal(state.best_delays.numpy(),
                              np.asarray(jstate.best_delays))
    assert state.gen == int(jstate.gen) == gens


def test_marker_rides_the_host_ring_into_the_tail():
    """tests/test_distributed.py's marker case on the port: a 4 x 2 mesh,
    the chip ring off, dcn_migrate_k = 2, mutation and crossover off. The
    marker planted on island 0 arrives on island 2 = (h=1, i=0) in its
    tail rows, not its elite rows, and nowhere else."""
    mesh = tdist.make_hybrid_mesh(n_hosts=4, devices=["cpu"] * 8)
    cfg = CFG._replace(mutation_rate=0.0, crossover_rate=0.0)
    step = tdist.make_hier_island_step(mesh, cfg, migrate_k=0,
                                       dcn_migrate_k=2)
    (traces, pairs, archive, failures), _ = inputs()
    state = tisl.init_island_state(2, 256, H, cfg, mesh=mesh)
    marker = 0.0123
    state.pop.delays[:32] = marker
    state, _ = step(state, 3, traces, pairs, archive, failures)
    d = state.pop.delays.numpy()
    is_marker = np.all(np.abs(d - marker) < 1e-7, axis=1)
    assert is_marker[64:96].sum() == 2
    assert is_marker[94:96].all()
    assert not is_marker[64:66].any()
    assert is_marker[96:].sum() == 0


def test_migration_k_clamped_to_island_population():
    """migrate_k + dcn_migrate_k past an island's 8 rows clamp: the chip
    ring moves 7 (8 minus the one elite), the host ring nothing."""
    mesh = tdist.make_hybrid_mesh(n_hosts=2, devices=["cpu"] * 8)
    (traces, pairs, archive, failures), _ = inputs()
    assert tisl.ring_plan(mesh, tdist.hier_rings(8, 2), 8, CFG) == [
        (1, 7, 0, 1)]
    step = tdist.make_hier_island_step(mesh, CFG, migrate_k=8,
                                       dcn_migrate_k=2)
    state = tisl.init_island_state(0, 64, H, CFG, mesh=mesh)
    state, fit = step(state, 1, traces, pairs, archive, failures)
    assert np.isfinite(float(state.best_fitness))
    assert float(fit) == float(state.best_fitness)


def _run(mesh, rings, gens, fused=None, start_stepwise=0, P=64):
    (traces, pairs, archive, failures), _ = inputs()
    state = tisl.init_island_state(0, P, H, CFG, mesh=mesh)
    for _ in range(start_stepwise):
        state, _ = tisl.island_step(state, 1, traces, pairs, archive,
                                    failures, CFG, mesh=mesh, rings=rings)
    if fused:
        state, hist = tisl.fused_step(state, gens, 1, traces, pairs,
                                      archive, failures, CFG, mesh=mesh,
                                      rings=rings)
        return state, hist.tolist()
    hist = []
    for _ in range(gens):
        state, fit = tisl.island_step(state, 1, traces, pairs, archive,
                                      failures, CFG, mesh=mesh, rings=rings)
        hist.append(float(fit))
    return state, hist


def test_migration_cadence_skips_off_generations():
    """A ring with every = 2 migrates on gen 0 and skips gen 1: after two
    steps only the landing rows differ from an every-generation ring."""
    mesh = make_mesh(8, device="cpu")
    a, _ = _run(mesh, (("i", 2, 2),), 1)
    b, _ = _run(mesh, (("i", 2),), 1)
    assert torch.equal(a.pop.delays, b.pop.delays)
    a, _ = _run(mesh, (("i", 2, 2),), 2)
    b, _ = _run(mesh, (("i", 2),), 2)
    assert not torch.equal(a.pop.delays, b.pop.delays)
    x, y = a.pop.delays.view(8, 8, H), b.pop.delays.view(8, 8, H)
    assert torch.equal(x[:, :6], y[:, :6])


@pytest.mark.parametrize("start", [0, 1], ids=["even", "odd"])
def test_fused_equals_stepwise_under_cadence(start):
    """fused == stepwise with every = 2, from gen 0 and from an odd gen
    (one stepwise generation first): the cadence reads the counter before
    each step in both."""
    mesh = tdist.make_hybrid_mesh(n_hosts=2, devices=["cpu"] * 8)
    rings = tdist.hier_rings(2, 1, migrate_every=2, dcn_every=3)
    a, ha = _run(mesh, rings, 5, fused=True, start_stepwise=start)
    b, hb = _run(mesh, rings, 5, start_stepwise=start)
    assert a.gen == b.gen == 5 + start
    assert torch.equal(a.pop.delays, b.pop.delays)
    assert torch.equal(a.pop.faults, b.pop.faults)
    assert ha == hb
    assert torch.equal(a.best_delays, b.best_delays)


@pytest.mark.parametrize("kind", ["flat8", "hybrid2x4"])
def test_shard_layout_does_not_change_the_result(kind):
    """The same 8 islands as 1 shard of 8, 2 shards of 4 and 8 shards of
    1 give bit-identical populations, bests and histories."""
    if kind == "flat8":
        mesh, rings = make_mesh(8, device="cpu"), (("i", 3, 1),)
    else:
        mesh = tdist.make_hybrid_mesh(n_hosts=2, devices=["cpu"] * 8)
        rings = tdist.hier_rings(3, 2, dcn_every=2)
    outs = []
    for shard_size in (None, 4, 1):
        m = mesh if shard_size is None else mesh.reshard(shard_size)
        assert len(m.shards) == (1 if shard_size is None
                                 else 8 // shard_size)
        state, hist = _run(m, rings, 4, fused=True, P=128)
        pop = tisl.local_population(state.pop, m)
        outs.append((pop, hist, state.best_delays))
    for pop, hist, best in outs[1:]:
        assert torch.equal(pop.delays, outs[0][0].delays)
        assert torch.equal(pop.faults, outs[0][0].faults)
        assert hist == outs[0][1]
        assert torch.equal(best, outs[0][2])


def test_one_island_keeps_the_one_island_stream():
    """Coordinates all zero draw generation_seed(seed, gen)'s stream, and
    draw_generation draws it as the one-island GA always did: two
    randints, then rand, rand, randn, rand, randn, rand."""
    assert tisl.fold_coords(77, (0, 0)) == 77
    assert tisl.fold_coords(77, (0, 1)) != tisl.fold_coords(77, (1, 0))
    g = tisl.generator_for(5, 3, "cpu", coords=(0,))
    got = tga.draw_generation(g, 16, H, CFG)
    ref = tisl.generator_for(5, 3, "cpu")
    want = (torch.randint(0, 16, (16, 3), generator=ref),
            torch.randint(0, 16, (16, 3), generator=ref),
            torch.rand((16, 1), generator=ref),
            torch.rand((16, H), generator=ref),
            torch.randn((16, H), generator=ref),
            torch.rand((16, H), generator=ref),
            torch.randn((16, H), generator=ref),
            torch.rand((16, H), generator=ref))
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    # a one-island mesh and no mesh are one path
    (traces, pairs, archive, failures), _ = inputs()
    s0 = tisl.init_island_state(0, 32, H, CFG, "cpu")
    a, fa = tisl.fused_step(s0, 3, 1, traces, pairs, archive, failures, CFG)
    b, fb = tisl.fused_step(s0, 3, 1, traces, pairs, archive, failures, CFG,
                            mesh=make_mesh(1, device="cpu"),
                            rings=(("i", 8),))
    assert torch.equal(a.pop.delays, b.pop.delays)
    assert torch.equal(fa, fb)


# -- the search over a mesh ------------------------------------------------


def test_search_over_eight_islands_rescored_by_reference():
    s = tsearch.ScheduleSearch(port_cfg(population=60, migrate_k=2,
                                        fused_chunk=4),
                               n_devices=8, device="cpu")
    assert s.mesh.shape == {"i": 8} and s.population == 56
    assert s._rings == (("i", 2, 1),)
    seed_archives(s, tte)
    s.seed_population([np.full((H,), 0.04, np.float32)] * 8)
    rows = s._state.pop.delays.view(8, 7, H)[:, 0]
    assert torch.all(rows == 0.04)  # one table an island
    encs = refs(tte)
    first = s.run(encs, generations=5)
    best = s.run(encs, generations=5)
    assert best.fitness >= first.fitness and s.generations_run == 10
    h, _, a, m, _ = tte.stack_traces(refs(tte))
    want, _ = jsched.score_population_multi(
        jnp.asarray(best.delays[None]),
        jsched.TraceArrays(jnp.asarray(h), jnp.asarray(a), jnp.asarray(m)),
        jnp.asarray(s.pairs), jnp.asarray(s.archive),
        jnp.asarray(s.failures))
    np.testing.assert_allclose(best.fitness, float(want[0]), rtol=RTOL,
                               atol=ATOL)


def test_checkpoints_cross_packages_on_eight_islands(tmp_path):
    from namazu_tpu.ops import trace_encoding as jte

    js = jsearch.ScheduleSearch(jax_cfg(migrate_k=2), n_devices=8)
    seed_archives(js, jte)
    js.run(refs(jte), generations=3)
    path = str(tmp_path / "jax8.npz")
    js.save(path)
    s = tsearch.ScheduleSearch(port_cfg(migrate_k=2), n_devices=8,
                               device="cpu")
    s.load(path)
    assert np.array_equal(s._state.pop.delays.numpy(),
                          np.asarray(js._state.pop.delays))
    assert s._state.gen == 3 and s.best().fitness == js.best().fitness
    s.run(refs(tte), generations=2)
    back = str(tmp_path / "port8.npz")
    s.save(back)
    js2 = jsearch.ScheduleSearch(jax_cfg(migrate_k=2), n_devices=8)
    js2.load(back)
    assert np.array_equal(np.asarray(js2._state.pop.delays),
                          s._fetch_population()[0])
    assert int(js2._state.gen) == 5 and js2.generations_run == 5
    assert js2.best().fitness == s.best().fitness
    js2.run(refs(jte), generations=1)
    # and the port loads its own checkpoint on another layout of the
    # same islands
    two = tsearch.ScheduleSearch(port_cfg(migrate_k=2),
                                 mesh=make_mesh(8, device="cpu").reshard(4))
    two.load(back)
    assert torch.equal(tisl.local_population(two._state.pop, two.mesh)
                       .delays, s._state.pop.delays)


def test_population_that_does_not_fit_the_mesh_stays_fresh(tmp_path):
    one = tsearch.ScheduleSearch(port_cfg(population=60), device="cpu")
    seed_archives(one, tte)
    one.run(refs(tte), generations=2)
    path = str(tmp_path / "one.npz")
    one.save(path)
    eight = tsearch.ScheduleSearch(port_cfg(population=60), n_devices=8,
                                   device="cpu")
    fresh = eight._state.pop.delays.clone()
    eight.load(path)  # 60 rows do not fit 8 islands of 7
    assert torch.equal(eight._state.pop.delays, fresh)
    assert eight._state.gen == 2 and eight._failure_n == one._failure_n
    assert np.array_equal(eight.best().delays, one.best().delays)
    assert np.isfinite(eight.run(refs(tte), generations=2).fitness)
