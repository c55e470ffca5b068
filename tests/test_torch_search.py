"""The port's island step and ScheduleSearch (namazu_tpu_torch/parallel/
islands.py, models/search.py, convert.py) held to the reference's
ScheduleSearch on a one-device mesh, plus the port's own contracts: fused
equals stepwise bit for bit, checkpoints load both ways, the device rule
and the import rule.

Sizes are small (P=64, H=K=32). Deterministic math is held to rtol 1e-3 /
atol 1e-4; populations given the same draws must be equal exactly (with a
power-of-two mutation sigma, see tests/test_torch_ga.py)."""

import ast
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from namazu_tpu.models import ga as jga
from namazu_tpu.models import search as jsearch
from namazu_tpu.ops import schedule as jsched
from namazu_tpu.ops import trace_encoding as jte
from namazu_tpu.parallel.islands import make_multiaxis_island_step
from namazu_tpu_torch import convert, resolve_device
from namazu_tpu_torch.models import ga as tga
from namazu_tpu_torch.models import search as tsearch
from namazu_tpu_torch.ops import schedule as tsched
from namazu_tpu_torch.ops import trace_encoding as tte
from namazu_tpu_torch.parallel import islands as tisl
from test_torch_ga import SIGMA, jax_draws

RTOL, ATOL = 1e-3, 1e-4
H = K = 32
REPO = pathlib.Path(__file__).resolve().parents[1]


def jax_cfg(**kw):
    base = jsearch.SearchConfig(
        H=H, K=K, archive_size=16, failure_size=8, population=64, seed=3,
        ga=jga.GAConfig(max_delay=0.05, mutation_sigma=SIGMA))
    return base._replace(**kw)


def port_cfg(**kw):
    c = jax_cfg(**kw)
    return tsearch.SearchConfig(*c)._replace(
        ga=tga.GAConfig(*c.ga), weights=tsched.ScoreWeights(*c.weights))


def stream(te, n, seed):
    rng = np.random.RandomState(seed)
    return te.encode_event_stream(
        [f"10.0.0.{rng.randint(6)}->10.0.0.{rng.randint(6)}:m{rng.randint(3)}"
         for _ in range(n)],
        arrivals=sorted(rng.rand(n).tolist()), H=H)


def seed_archives(search, te):
    for i in range(6):
        search.add_executed_trace(stream(te, 40, 10 + i),
                                  reproduced=i == 2)
    search.add_failure_trace(stream(te, 50, 99))
    search.add_failure_trace(stream(te, 50, 98))


REFS = [(48, 0), (1100, 1)]  # the second trace scores blockwise


def refs(te):
    return [stream(te, n, s) for n, s in REFS]


def port_traces(encs):
    h, _, a, m, _ = tte.stack_traces(encs)
    return tsched.TraceArrays(torch.from_numpy(h).long(),
                              torch.from_numpy(a), torch.from_numpy(m))


def jax_arrays(js):
    return {
        "pop_delays": np.asarray(js._state.pop.delays),
        "pop_faults": np.asarray(js._state.pop.faults),
        "gen": np.asarray(js._state.gen),
        "best_fitness": np.asarray(js._state.best_fitness),
        "best_delays": np.asarray(js._state.best_delays),
        "best_faults": np.asarray(js._state.best_faults),
        "archive": js.archive, "failures": js.failures, "pairs": js.pairs,
        "archive_n": js._archive_n, "failure_n": js._failure_n,
    }


def test_encoding_matches_reference():
    a, b = stream(jte, 300, 5), stream(tte, 300, 5)
    for f in ("hint_ids", "entity_ids", "arrival", "mask"):
        assert np.array_equal(getattr(a, f), getattr(b, f))
    assert tte.HINT_SPACE == jte.HINT_SPACE
    assert np.array_equal(tte.sample_pairs(K, H, 4), jte.sample_pairs(K, H, 4))
    assert tte._auto_length(1100) == jte._auto_length(1100) == 1152
    for x, y in zip(tte.stack_traces([a, stream(tte, 20, 1)]),
                    jte.stack_traces([a, stream(jte, 20, 1)])):
        assert np.array_equal(x, y)


def test_one_island_generation_matches_reference():
    js = jsearch.ScheduleSearch(jax_cfg(), n_devices=1)
    seed_archives(js, jte)
    encs = refs(jte)
    # one generation of the reference's island step on a 1-device mesh
    _, trace, pairs, archive, failures = js._device_inputs(encs)
    step = make_multiaxis_island_step(js.mesh, js.cfg.ga, js.cfg.weights,
                                      rings=js._rings)
    want = step(js._state, js._key, trace, pairs, archive, failures, None,
                jnp.asarray(1.0, jnp.float32), None)
    # the key that generation consumes: fold_in(base, gen), then the
    # island's axis index (0 on one device)
    key = jax.random.fold_in(jax.random.fold_in(js._key, 0), 0)
    draws = jax_draws(key, 64, H, js.cfg.ga)

    conv = convert.state_from_jax(jax_arrays(js), "cpu")
    got, fit = tisl.island_step(
        conv.state, 0, port_traces(encs), torch.from_numpy(conv.pairs),
        torch.from_numpy(conv.archive), torch.from_numpy(conv.failures),
        tga.GAConfig(*js.cfg.ga), tsched.ScoreWeights(*js.cfg.weights),
        draws=draws)
    assert got.gen == int(want.gen) == 1
    assert np.array_equal(got.pop.delays.numpy(), np.asarray(want.pop.delays))
    assert np.array_equal(got.pop.faults.numpy(), np.asarray(want.pop.faults))
    np.testing.assert_allclose(float(got.best_fitness),
                               float(want.best_fitness), rtol=RTOL,
                               atol=ATOL)
    assert float(fit) == float(got.best_fitness)
    assert np.array_equal(got.best_delays.numpy(),
                          np.asarray(want.best_delays))


def test_fused_equals_stepwise_bit_for_bit_across_runs():
    fused = tsearch.ScheduleSearch(port_cfg(fused=True, fused_chunk=3),
                                   device="cpu")
    step = tsearch.ScheduleSearch(port_cfg(fused=False), device="cpu")
    for s in (fused, step):
        seed_archives(s, tte)
    encs = refs(tte)
    for gens in (5, 4):
        a = fused.run(encs, generations=gens)
        b = step.run(encs, generations=gens)
        assert a.fitness == b.fitness
        assert np.array_equal(a.delays, b.delays)
        assert fused.last_fit_curve == step.last_fit_curve
        assert len(fused.last_fit_curve) == gens
    assert torch.equal(fused._state.pop.delays, step._state.pop.delays)
    assert fused._state.gen == step._state.gen == 9
    assert fused.generations_run == 9


@pytest.mark.parametrize("chunk", [16, 4])
def test_a_failure_mid_chunk_keeps_the_last_round(monkeypatch, chunk):
    """The island step raising at generation 5 of a 16-generation round
    (inside one chunk of 16, or in the second chunk of 4) leaves the
    search as the last completed round left it: ``best()``, the state and
    ``generations_run``; the next round then gives what a search that
    never failed gives, bit for bit (the counterpart of the reference's
    ``_recover_state``)."""
    encs = refs(tte)
    searches = []
    for _ in range(2):
        s = tsearch.ScheduleSearch(port_cfg(fused_chunk=chunk),
                                   device="cpu")
        seed_archives(s, tte)
        s.run(encs, generations=16)
        searches.append(s)
    failing, clean = searches
    before, state = failing.best(), failing._state
    real, calls = tisl._step, []

    def step(*a, **kw):
        calls.append(1)
        if len(calls) == 5:
            raise RuntimeError("out of memory")
        return real(*a, **kw)

    monkeypatch.setattr(tisl, "_step", step)
    with pytest.raises(RuntimeError, match="out of memory"):
        failing.run(encs, generations=16)
    monkeypatch.setattr(tisl, "_step", real)
    after = failing.best()
    assert after.fitness == before.fitness
    assert np.array_equal(after.delays, before.delays)
    assert failing._state is state and failing._state.gen == 16
    assert failing.generations_run == 16
    a, b = failing.run(encs, generations=16), clean.run(encs,
                                                         generations=16)
    assert a.fitness == b.fitness and np.array_equal(a.delays, b.delays)
    assert torch.equal(failing._state.pop.delays, clean._state.pop.delays)
    assert failing.generations_run == 32


def test_search_end_to_end_rescored_by_reference():
    s = tsearch.ScheduleSearch(port_cfg(fused_chunk=4), device="cpu")
    seed_archives(s, tte)
    encs = refs(tte)
    first = s.run(encs, generations=6)
    best = s.run(encs, generations=6)
    assert np.isfinite(best.fitness) and best.fitness >= first.fitness
    assert best.delays.shape == (H,) and best.delays.dtype == np.float32
    assert s.last_run_seconds > 0 and s.generations_run == 12
    # the reported fitness is the reference scorer's fitness of the table
    h, _, a, m, _ = jte.stack_traces(refs(jte))
    want, _ = jsched.score_population_multi(
        jnp.asarray(best.delays[None]),
        jsched.TraceArrays(jnp.asarray(h), jnp.asarray(a), jnp.asarray(m)),
        jnp.asarray(s.pairs), jnp.asarray(s.archive),
        jnp.asarray(s.failures))
    np.testing.assert_allclose(best.fitness, float(want[0]), rtol=RTOL,
                               atol=ATOL)
    # and the port's archive features are the reference's
    js = jsearch.ScheduleSearch(jax_cfg(), n_devices=1)
    seed_archives(js, jte)
    np.testing.assert_allclose(s.archive, js.archive, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(s.failures, js.failures, rtol=RTOL,
                               atol=ATOL)
    assert s._failure_digests == js._failure_digests


def test_jax_checkpoint_loads_into_port(tmp_path):
    js = jsearch.ScheduleSearch(jax_cfg(), n_devices=1)
    seed_archives(js, jte)
    js.run(refs(jte), generations=3)
    path = str(tmp_path / "jax.npz")
    js.save(path)
    s = tsearch.ScheduleSearch(port_cfg(seed=0), device="cpu")
    s.load(path)
    assert np.array_equal(s._state.pop.delays.numpy(),
                          np.asarray(js._state.pop.delays))
    assert s._state.gen == 3 and s.generations_run == 3
    assert float(s._state.best_fitness) == float(js._state.best_fitness)
    assert np.array_equal(s.best().delays, js.best().delays)
    assert np.array_equal(s.archive, js.archive)
    assert np.array_equal(s.failures, js.failures)
    assert np.array_equal(s.pairs, js.pairs)
    assert s._seed == 3  # the key data of PRNGKey(3)
    assert s.distinct_failure_signatures() == 2
    assert torch.equal(s._dev_archive, torch.from_numpy(js.archive))
    s.run(refs(tte), generations=2)  # and the loaded state evolves
    assert s._state.gen == 5


def test_port_checkpoint_loads_into_reference(tmp_path):
    s = tsearch.ScheduleSearch(port_cfg(), device="cpu")
    seed_archives(s, tte)
    best = s.run(refs(tte), generations=4)
    path = str(tmp_path / "port.npz")
    s.save(path)
    js = jsearch.ScheduleSearch(jax_cfg(seed=0), n_devices=1)
    js.load(path)
    assert np.array_equal(np.asarray(js._state.pop.delays),
                          s._state.pop.delays.numpy())
    assert int(js._state.gen) == 4 and js.generations_run == 4
    assert js.best().fitness == best.fitness
    assert np.array_equal(js.best().delays, best.delays)
    assert np.array_equal(np.asarray(jax.random.key_data(js._key)),
                          [0, 3])
    assert js.distinct_failure_signatures() == 2
    js.run(refs(jte), generations=1)
    assert js.best().fitness >= best.fitness
    # the policy's raw-npz install (no search built) takes the table too
    from namazu_tpu.policy.tpu import TPUSearchPolicy

    pol = TPUSearchPolicy()
    pol.H = H
    assert pol._install_from_checkpoint(path)
    np.testing.assert_array_equal(np.asarray(pol._delays, np.float32),
                                  best.delays)


def test_ring_writes_and_failure_dedupe():
    s = tsearch.ScheduleSearch(port_cfg(archive_size=4), device="cpu")
    for i in range(6):
        s.add_executed_trace(stream(tte, 30, i))
    assert s._archive_n == 6
    assert torch.equal(s._dev_archive, torch.from_numpy(s.archive))
    f = stream(tte, 30, 50)
    s.add_failure_trace(f)
    s.add_failure_trace(f)  # the same signature spends no slot
    assert s._failure_n == 1
    assert tsearch.trace_digest(f) in s._failure_digest_set
    assert torch.equal(s._dev_failures, torch.from_numpy(s.failures))


def test_resident_traces_append_and_rebuild():
    s = tsearch.ScheduleSearch(port_cfg(), device="cpu")
    a, b, c = (stream(tte, 40, i) for i in range(3))
    s.run([a, b], generations=1)
    assert s._traces.rebuilds == 1
    s.run([b, c], generations=1)
    assert (s._traces.rebuilds, s._traces.appends) == (1, 1)
    view = s._traces.view([c, b])
    h, _, arr, m, _ = tte.stack_traces([c, b])
    assert np.array_equal(view.hint_ids.numpy(), h)
    assert np.array_equal(view.arrival.numpy(), arr)
    assert np.array_equal(view.mask.numpy(), m)
    s.run([stream(tte, 300, 7)], generations=1)  # longer rows: rebuild
    assert s._traces.rebuilds == 2


@pytest.mark.parametrize("what", ["device_trace_dir", "guidance"])
def test_search_params_build_guidance_and_device_trace(what, tmp_path):
    """The port's ``build_search`` (the sidecar's and the policy's build)
    wires what the reference sidecar's ``build_search_from_params`` does:
    the guidance map (before any checkpoint load) and the device-trace
    directory, whose first fused run writes one trace and later runs
    none."""
    from namazu_tpu.sidecar import build_search_from_params as jbuild
    from namazu_tpu_torch.policy.tpu import \
        build_search as build_search_from_params

    params = {"H": H, "K": K, "population": 64, "fused_chunk": 2}
    if what == "guidance":
        params.update(guidance=True, guidance_width=512, guidance_window=8)
        s, js = build_search_from_params(params, device="cpu"), \
            jbuild(params)
        for x in (s, js):
            assert (x.guidance.H, x.guidance.width, x.guidance.window) == \
                (H, 512, 8)
            assert x.guidance_feats.shape == (512, 20)
        return
    out = tmp_path / "dt"
    s = build_search_from_params(dict(params, device_trace_dir=str(out)),
                                 device="cpu")
    assert s.cfg.device_trace_dir == str(out)
    s.run(refs(tte), generations=3)
    traces = list((out / "device_trace").iterdir())
    assert len(traces) == 1 and traces[0].stat().st_size > 0
    s.run(refs(tte), generations=3)  # one capture a search
    assert len(list((out / "device_trace").iterdir())) == 1


def test_config_and_weights_match_reference():
    assert tsearch.SearchConfig._fields == jsearch.SearchConfig._fields
    for mode in ("delay", "reorder"):
        assert tuple(tsearch.make_score_weights(mode, tau=0.01)) == \
            tuple(jsearch.make_score_weights(mode, tau=0.01))


def test_cuda_is_the_default_device_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsearch.ScheduleSearch(port_cfg())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.state_from_jax({}, "cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_reference_package():
    """The package and chip_smoke.py import neither JAX nor the
    reference, nor either shim (the two files that import the
    reference)."""
    files = sorted((REPO / "namazu_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        for name in _imports(f):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "namazu_tpu", "flax",
                                "optax", "namazu_tpu_torch_policy",
                                "namazu_tpu_torch_sidecar"), \
                f"{f}: imports {name}"


def test_the_policy_shim_imports_no_jax():
    roots = {name.split(".")[0]
             for name in _imports(REPO / "namazu_tpu_torch_policy.py")}
    assert {"namazu_tpu", "namazu_tpu_torch"} <= roots
    assert not roots & {"jax", "jaxlib", "flax", "optax"}


def test_the_sidecar_shim_imports_no_jax():
    roots = {name.split(".")[0]
             for name in _imports(REPO / "namazu_tpu_torch_sidecar.py")}
    assert {"namazu_tpu", "namazu_tpu_torch"} <= roots
    assert not roots & {"jax", "jaxlib", "flax", "optax",
                        "namazu_tpu_torch_policy"}


# -- surrogate re-rank and the pair refit ----------------------------------


def label_archive(search, te, positives=4):
    """8 executed runs, ``positives`` of them reproducing, and 2 failures."""
    for i in range(8):
        search.add_executed_trace(stream(te, 40, 20 + i),
                                  reproduced=i < positives)
    search.add_failure_trace(stream(te, 50, 99))
    search.add_failure_trace(stream(te, 50, 98))


def test_surrogate_pick_matches_reference_from_carried_state(tmp_path):
    js = jsearch.ScheduleSearch(jax_cfg(surrogate_topk=8), n_devices=1)
    label_archive(js, jte)
    js.run(refs(jte), generations=3)
    path = str(tmp_path / "j.npz")
    js.save(path)
    s = tsearch.ScheduleSearch(port_cfg(surrogate_topk=8), device="cpu")
    s.load(path)

    encs, trace, pairs, archive, failures = js._device_inputs(refs(jte))
    nov = jnp.asarray(js.novelty_scale(), jnp.float32)
    fitness, _ = jsched.score_population_multi(
        jnp.asarray(np.asarray(js._state.pop.delays)), trace, pairs,
        archive, failures,
        js.cfg.weights, novelty_scale=nov)
    want_top = np.asarray(jnp.argsort(-fitness)[:8])
    inputs = s._device_inputs(refs(tte))
    top, got_fit, _ = s._rerank_candidates(*inputs, s.novelty_scale())
    assert np.array_equal(top.numpy(), want_top)
    np.testing.assert_allclose(got_fit.numpy(), np.asarray(fitness),
                               rtol=RTOL, atol=ATOL)

    want = js._surrogate_pick(trace, pairs, archive, failures, nov,
                              encs=encs)
    got = s._surrogate_pick(*inputs, s.novelty_scale())
    assert want is not None and got is not None
    assert np.array_equal(got.delays, want.delays)  # the same winner
    np.testing.assert_allclose(got.fitness, want.fitness, rtol=RTOL,
                               atol=ATOL)


def test_run_returns_the_surrogate_pick_with_one_extra_rescore():
    from namazu_tpu_torch.ops import pair_distance as pd

    s = tsearch.ScheduleSearch(port_cfg(surrogate_topk=8), device="cpu")
    label_archive(s, tte)
    calls = []
    real = pd.min_sq_distance_pair_reference

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    pd.min_sq_distance_pair_reference = counting
    try:
        got = s.run(refs(tte), generations=5)
    finally:
        pd.min_sq_distance_pair_reference = real
    assert len(calls) == 5 + 1  # one per generation, one for the re-rank
    assert s._surrogate is not None and s.last_rerank_seconds > 0
    rows, _ = s._fetch_population()
    assert any(np.array_equal(r, got.delays) for r in rows)
    assert got.fitness <= s.best().fitness


@pytest.mark.parametrize("positives", [2, 3, 5, 6])
def test_min_class_examples_gates_the_surrogate(positives):
    assert tsearch.ScheduleSearch.MIN_CLASS_EXAMPLES == \
        jsearch.ScheduleSearch.MIN_CLASS_EXAMPLES == 3
    s = tsearch.ScheduleSearch(port_cfg(surrogate_topk=4), device="cpu")
    label_archive(s, tte, positives)
    best = s.run(refs(tte), generations=2)
    trains = min(positives, 8 - positives) >= 3
    assert (s._surrogate is not None) == trains
    if not trains:
        assert best.fitness == s.best().fitness
        assert np.array_equal(best.delays, s.best().delays)
    js = jsearch.ScheduleSearch(jax_cfg(surrogate_topk=4), n_devices=1)
    label_archive(js, jte, positives)
    assert (js._train_surrogate() is not None) == trains


def test_set_occupied_buckets_clears_archives_and_best():
    s = tsearch.ScheduleSearch(port_cfg(), device="cpu")
    js = jsearch.ScheduleSearch(jax_cfg(), n_devices=1)
    seed_archives(s, tte)
    seed_archives(js, jte)
    s.run(refs(tte), generations=2)
    assert np.isfinite(s.best().fitness)
    occupied = [1, 5, 9, 30]
    for search in (s, js):
        search.set_occupied_buckets(occupied)
    assert np.array_equal(s.pairs, js.pairs)
    assert np.array_equal(s.pairs, tte.informative_pairs(occupied, K, H, 3))
    assert s._archive_n == s._failure_n == 0
    assert np.all(s.archive == 0.5) and np.all(s.failures == 0.5)
    assert not s.archive_labels.any()
    assert s._failure_digests == js._failure_digests == [""] * 8
    assert s.distinct_failure_signatures() == 0
    assert torch.equal(s._dev_archive, torch.from_numpy(s.archive))
    assert torch.equal(s._dev_failures, torch.from_numpy(s.failures))
    assert torch.equal(s._dev_pairs, torch.from_numpy(s.pairs).long())
    assert float(s._state.best_fitness) == float("-inf")
    # the same buckets again: pairs unchanged, archives kept
    s.add_executed_trace(stream(tte, 30, 3))
    s.set_occupied_buckets(occupied)
    assert s._archive_n == 1
