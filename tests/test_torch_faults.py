"""The fault half of the genome in the port (namazu_tpu_torch/ops/
schedule.py drop_mask/apply_faults/fault_cost, ops/trace_encoding.py
fault_coin, the coin through parallel/islands.py and models/search.py)
held to namazu_tpu on the same inputs, made with numpy from a seed: the
scorer cases of tests/test_fault_scoring.py, at P=64, H=K=32, L=300
(dense) and L=1500 (blockwise).

Tolerances: the coin, drop masks and drop counts must be equal exactly;
features and fitness within rtol 1e-3 / atol 1e-4; populations given the
same draws exactly (a power-of-two mutation sigma, see
tests/test_torch_ga.py); fused equals stepwise bit for bit."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from namazu_tpu.models import ga as jga
from namazu_tpu.models import search as jsearch
from namazu_tpu.ops import schedule as js
from namazu_tpu.ops import trace_encoding as jte
from namazu_tpu.parallel.islands import make_multiaxis_island_step
from namazu_tpu_torch import convert
from namazu_tpu_torch.models import ga as tga
from namazu_tpu_torch.models import search as tsearch
from namazu_tpu_torch.ops import schedule as ts
from namazu_tpu_torch.ops import trace_encoding as tte
from namazu_tpu_torch.parallel import islands as tisl
from test_torch_ga import SIGMA, jax_draws

RTOL, ATOL = 1e-3, 1e-4
P, H, K, T = 64, 32, 32, 3
LENGTHS = {"dense": 300, "blockwise": 1500}
MAX_FAULT = 0.3


def make_case(L, seed=0, faultable=True):
    """Traces [T, L] with ragged masks and (optionally) a faultable flag
    that is False for about a quarter of the events, a population with a
    fault half in [0, MAX_FAULT], and the reference's coin."""
    rng = np.random.RandomState(seed)
    hint = rng.randint(0, H, size=(T, L)).astype(np.int32)
    arrival = np.sort(rng.rand(T, L).astype(np.float32) * 0.5, axis=1)
    mask = np.zeros((T, L), bool)
    for t in range(T):
        mask[t, : L - 17 * t] = True
    flt = rng.rand(T, L) > 0.25 if faultable else None
    delays = (rng.rand(P, H) * 0.05).astype(np.float32)
    faults = (rng.rand(P, H) * MAX_FAULT).astype(np.float32)
    faults[0] = 0.0  # a genome that drops nothing
    faults[1] = 1.0  # one that drops every faultable event
    pairs = tte.sample_pairs(K, H, seed)
    archive = rng.rand(16, K).astype(np.float32)
    failures = rng.rand(4, K).astype(np.float32)
    coin = jte.fault_coin(seed, H)
    return dict(hint=hint, arrival=arrival, mask=mask, flt=flt,
                delays=delays, faults=faults, pairs=pairs, archive=archive,
                failures=failures, coin=coin)


def jtrace(c, t=None):
    sel = (lambda a: a) if t is None else (lambda a: a[t])
    return js.TraceArrays(
        jnp.asarray(sel(c["hint"])), jnp.asarray(sel(c["arrival"])),
        jnp.asarray(sel(c["mask"])),
        None if c["flt"] is None else jnp.asarray(sel(c["flt"])))


def ttrace(c, t=None):
    sel = (lambda a: a) if t is None else (lambda a: a[t])
    return ts.TraceArrays(
        torch.from_numpy(sel(c["hint"])).long(),
        torch.from_numpy(sel(c["arrival"])),
        torch.from_numpy(sel(c["mask"])),
        None if c["flt"] is None else torch.from_numpy(sel(c["flt"])))


def t_(x):
    return torch.from_numpy(np.asarray(x))


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def jax_genome_features(c, w: js.ScoreWeights, faults=True):
    """The reference's per-genome, per-trace features and drop counts,
    vmapped to ``[T, P, K]`` and ``[T, P]``."""
    pairs = jnp.asarray(c["pairs"])
    coin = jnp.asarray(c["coin"]) if faults else None

    def per_trace(tr):
        return jax.vmap(lambda d, f: js._genome_features(
            d, tr, pairs, w.tau, w.order_mode, w.order_gap, w.order_window,
            faults=f if faults else None, coin=coin))(
                jnp.asarray(c["delays"]), jnp.asarray(c["faults"]))

    return jax.vmap(per_trace)(jtrace(c))


def port_genome_features(c, w: ts.ScoreWeights, faults=True):
    return ts._genome_features(
        t_(c["delays"]), ttrace(c), t_(c["pairs"]), w.tau, w.order_mode,
        w.order_gap, w.order_window,
        faults=t_(c["faults"]) if faults else None,
        coin=t_(c["coin"]) if faults else None)


# -- the coin ------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3, 12345])
@pytest.mark.parametrize("h", [1, 32, 256])
def test_fault_coin_equals_reference(seed, h):
    got = tte.fault_coin(seed, h)
    want = jte.fault_coin(seed, h)
    assert got.dtype == np.float32 and got.shape == (h,)
    assert np.array_equal(got, want)
    assert ((got >= 0) & (got < 1)).all()


def test_policy_drop_decision_is_the_scorers():
    """The reference policy's replay decision with the port's coin is the
    port's drop mask."""
    from namazu_tpu.policy.tpu import TPUSearchPolicy

    pol = TPUSearchPolicy()
    pol.seed, pol.H, pol.max_fault = 3, H, 1.0
    coin = tte.fault_coin(3, H)
    faults = np.where(np.arange(H) % 2 == 0, coin + 0.01, coin - 0.01)
    faults = np.clip(faults, 0.0, 1.0).astype(np.float32)
    pol.install_table(np.zeros(H), faults=faults)
    hints = [f"10.0.0.{i % 7}->10.0.0.{i % 5}:m{i}" for i in range(80)]
    enc = tte.encode_event_stream(hints, H=H)
    trace = ts.TraceArrays(t_(enc.hint_ids).long(), t_(enc.arrival),
                           t_(enc.mask))
    dropped = ts.drop_mask(t_(faults), t_(coin), trace).numpy()
    want = [pol._fault_for(h) for h in hints]
    assert dropped[: len(hints)].tolist() == want
    assert any(want) and not all(want)


# -- drop masks ----------------------------------------------------------


@pytest.mark.parametrize("faultable", [True, False])
def test_drop_mask_equals_reference(faultable):
    c = make_case(300, seed=1, faultable=faultable)
    got = ts.drop_mask(t_(c["faults"]), t_(c["coin"]), ttrace(c)).numpy()
    assert got.shape == (P, T, 300)
    want = jax.vmap(lambda f: jax.vmap(lambda tr: js.drop_mask(
        f, jnp.asarray(c["coin"]), tr))(jtrace(c)))(
            jnp.asarray(c["faults"]))
    assert np.array_equal(got, np.asarray(want))
    assert not got[0].any()  # faults of 0 never drop
    live = c["mask"] if c["flt"] is None else c["mask"] & c["flt"]
    assert np.array_equal(got[1], np.broadcast_to(live, got[1].shape))
    assert not got[:, ~c["mask"]].any()  # padding never drops
    eff = ts.apply_faults(ttrace(c), t_(c["faults"]), t_(c["coin"]))
    assert np.array_equal(eff.mask.numpy(), c["mask"] & ~got)


def test_drop_mask_respects_faultable_flag():
    trace = ts.TraceArrays(torch.zeros(4, dtype=torch.long),
                           torch.arange(4, dtype=torch.float32) * 1e-3,
                           torch.ones(4, dtype=torch.bool),
                           faultable=torch.tensor([True, False, True, False]))
    faults, coin = torch.ones(H), torch.zeros(H)
    assert ts.drop_mask(faults, coin, trace).tolist() == \
        [True, False, True, False]
    eff = ts.apply_faults(trace, faults, coin)
    assert eff.mask.tolist() == [False, True, False, True]


def test_blockwise_drop_respects_faultable():
    n = 2048  # > LONG_TRACE_THRESHOLD
    arrival = np.arange(n, dtype=np.float32) * 1e-3
    flt = np.zeros((n,), bool)
    flt[0] = True  # only the first event may drop
    trace = ts.TraceArrays(torch.zeros(n, dtype=torch.long), t_(arrival),
                           torch.ones(n, dtype=torch.bool), t_(flt))
    first, ndrop = ts.first_occurrence_blockwise(
        torch.zeros(1, H), trace, faults=torch.ones(1, H),
        coin=torch.zeros(H))
    want_first, want_ndrop = js.first_occurrence_blockwise(
        jnp.zeros(H), jnp.zeros(n, jnp.int32), jnp.asarray(arrival),
        jnp.ones(n, bool), faults=jnp.ones(H), coin=jnp.zeros(H),
        faultable=jnp.asarray(flt))
    assert int(ndrop[0]) == int(want_ndrop) == 1
    assert float(first[0, 0]) == float(want_first[0]) == arrival[1]


@pytest.mark.parametrize("faultable", [True, False])
@pytest.mark.parametrize("kind", sorted(LENGTHS))
def test_features_and_drop_counts_match_reference(kind, faultable):
    c = make_case(LENGTHS[kind], seed=2, faultable=faultable)
    w = js.ScoreWeights()
    want_f, want_n = jax_genome_features(c, w)
    got_f, got_n = port_genome_features(c, ts.ScoreWeights(*w))
    assert got_f.shape == (P, T, K) and got_n.shape == (P, T)
    close(got_f.numpy(), np.swapaxes(np.asarray(want_f), 0, 1))
    assert np.array_equal(got_n.numpy(), np.asarray(want_n).T)
    assert got_n[0].sum() == 0 and (got_n[1] > 0).all()


def test_dense_and_blockwise_drop_alike():
    """Both paths of the port give the same first occurrences and drop
    counts for one long trace (the dense path is forced on it)."""
    c = make_case(1500, seed=3)
    tr = ttrace(c)
    first_b, n_b = ts.first_occurrence_blockwise(
        t_(c["delays"]), tr, faults=t_(c["faults"]), coin=t_(c["coin"]))
    eff = ts.apply_faults(tr, t_(c["faults"]), t_(c["coin"]))
    first_d = ts.first_occurrence(ts.release_times(t_(c["delays"]), eff),
                                  eff, H)
    assert torch.equal(first_b, first_d)
    assert torch.equal(n_b, tr.mask.sum(-1) - eff.mask.sum(-1))


# -- fitness -------------------------------------------------------------


def stream(n=48, n_hints=16, skip_hint=None, te=tte):
    """Periodic hint stream; optionally without one hint's events."""
    hints, arrivals, t = [], [], 0.0
    for i in range(n):
        h = f"hint{i % n_hints}"
        t += 0.001
        if skip_hint is not None and h == skip_hint:
            continue
        hints.append(h)
        arrivals.append(t)
    return te.encode_event_stream(hints, arrivals=arrivals, L=64, H=H)


def enc_trace(enc):
    return ts.TraceArrays(t_(enc.hint_ids).long(), t_(enc.arrival),
                          t_(enc.mask))


def test_fault_cost_penalizes_drop_everything():
    trace = enc_trace(stream())
    pairs = t_(tte.sample_pairs(K, H, 0))
    w = ts.ScoreWeights(novelty=0.0, bug=0.0, delay_cost=0.0,
                        fault_cost=1.0)
    faults = torch.stack([torch.zeros(H), torch.ones(H)])
    fit, _ = ts.score_population(torch.zeros(2, H), trace, pairs,
                                 torch.full((4, K), 0.5),
                                 torch.full((2, K), 0.5), w, faults=faults,
                                 coin=t_(tte.fault_coin(0, H)))
    assert float(fit[0]) == pytest.approx(0.0, abs=1e-6)
    assert float(fit[1]) == pytest.approx(-1.0, abs=1e-5)


def test_dropping_a_bucket_matches_the_trace_without_it():
    full, skipped = stream(), stream(skip_hint="hint3")
    pairs = t_(tte.sample_pairs(K, H, 0))
    coin = tte.fault_coin(0, H)
    bucket = tte.hint_bucket("hint3", H)
    faults = np.zeros(H, np.float32)
    faults[bucket] = coin[bucket] + 1e-3
    f_drop = ts.schedule_features(torch.zeros(H), enc_trace(full), pairs,
                                  0.005, faults=t_(faults), coin=t_(coin))
    f_skip = ts.trace_features(enc_trace(skipped), pairs, 0.005, H)
    np.testing.assert_allclose(f_drop.numpy(), f_skip.numpy(), atol=1e-5)
    f_plain = ts.trace_features(enc_trace(full), pairs, 0.005, H)
    assert not np.allclose(f_drop.numpy(), f_plain.numpy())


@pytest.mark.parametrize("kind", sorted(LENGTHS))
def test_no_fault_args_is_todays_result_bit_for_bit(kind, monkeypatch):
    """Without a fault half no drop work runs; with a coin of ones (no
    bucket ever drops) the fitness is the same to the bit."""
    c = make_case(LENGTHS[kind], seed=4, faultable=False)
    args = (t_(c["delays"]), ttrace(c), t_(c["pairs"]), t_(c["archive"]),
            t_(c["failures"]))
    fit_ones, feats_ones = ts.score_population_multi(
        *args, faults=t_(c["faults"]), coin=torch.ones(H))

    def no_drops(*a, **kw):
        raise AssertionError("drop work without a fault half")

    monkeypatch.setattr(ts, "drop_mask", no_drops)
    fit, feats = ts.score_population_multi(*args)
    assert torch.equal(fit, fit_ones) and torch.equal(feats, feats_ones)


@pytest.mark.parametrize("kind", sorted(LENGTHS))
def test_score_population_with_faults_matches(kind):
    c = make_case(LENGTHS[kind], seed=5)
    w = js.ScoreWeights(fault_cost=0.5)
    want_fit, want_feats = js.score_population(
        jnp.asarray(c["delays"]), jtrace(c, 0), jnp.asarray(c["pairs"]),
        jnp.asarray(c["archive"]), jnp.asarray(c["failures"]), w,
        faults=jnp.asarray(c["faults"]), coin=jnp.asarray(c["coin"]))
    got_fit, got_feats = ts.score_population(
        t_(c["delays"]), ttrace(c, 0), t_(c["pairs"]), t_(c["archive"]),
        t_(c["failures"]), ts.ScoreWeights(*w), faults=t_(c["faults"]),
        coin=t_(c["coin"]))
    close(got_feats.numpy(), want_feats)
    close(got_fit.numpy(), want_fit)


@pytest.mark.parametrize("kind", sorted(LENGTHS))
def test_score_population_multi_with_faults_matches(kind):
    c = make_case(LENGTHS[kind], seed=6)
    w = js.ScoreWeights(novelty=0.7, bug=1.3, fault_cost=0.5)
    want_fit, want_feats = js.score_population_multi(
        jnp.asarray(c["delays"]), jtrace(c), jnp.asarray(c["pairs"]),
        jnp.asarray(c["archive"]), jnp.asarray(c["failures"]), w,
        faults=jnp.asarray(c["faults"]), coin=jnp.asarray(c["coin"]),
        novelty_scale=jnp.asarray(0.5, jnp.float32))
    got_fit, got_feats = ts.score_population_multi(
        t_(c["delays"]), ttrace(c), t_(c["pairs"]), t_(c["archive"]),
        t_(c["failures"]), ts.ScoreWeights(*w), faults=t_(c["faults"]),
        coin=t_(c["coin"]), novelty_scale=0.5)
    assert got_fit.shape == (P,) and got_feats.shape == (P, T, K)
    close(got_feats.numpy(), want_feats)
    close(got_fit.numpy(), want_fit)
    top = np.argsort(-got_fit.numpy(), kind="stable")[:8]
    assert np.array_equal(top, np.argsort(-np.asarray(want_fit),
                                          kind="stable")[:8])


def test_dropping_genome_matches_the_failure_on_every_trace():
    full, skipped = stream(), stream(skip_hint="hint3")
    h, _, a, m, _ = tte.stack_traces([full, full])
    traces = ts.TraceArrays(t_(h).long(), t_(a), t_(m))
    pairs = t_(tte.sample_pairs(K, H, 0))
    coin = tte.fault_coin(0, H)
    bucket = tte.hint_bucket("hint3", H)
    target = ts.trace_features(enc_trace(skipped), pairs, 0.005, H)[None]
    faults = np.zeros((2, H), np.float32)
    faults[1, bucket] = coin[bucket] + 1e-3
    w = ts.ScoreWeights(novelty=0.0, bug=1.0, delay_cost=0.0,
                        fault_cost=0.0)
    fit, feats = ts.score_population_multi(
        torch.zeros(2, H), traces, pairs, torch.full((1, K), 0.5), target,
        w, faults=t_(faults), coin=t_(coin))
    assert feats.shape == (2, 2, K)
    assert float(fit[1]) > float(fit[0]) + 0.005
    assert float(fit[1]) == pytest.approx(0.0, abs=1e-4)


# -- the island step and the search --------------------------------------


def jax_cfg(**kw):
    base = jsearch.SearchConfig(
        H=H, K=K, archive_size=16, failure_size=8, population=64, seed=3,
        ga=jga.GAConfig(max_delay=0.05, max_fault=MAX_FAULT,
                        mutation_sigma=SIGMA))
    return base._replace(**kw)


def port_cfg(**kw):
    c = jax_cfg(**kw)
    return tsearch.SearchConfig(*c)._replace(
        ga=tga.GAConfig(*c.ga), weights=ts.ScoreWeights(*c.weights))


def event_stream(te, n, seed, proc_every=4):
    """Encoded stream whose every ``proc_every``-th event is of a class
    that carries no fault."""
    rng = np.random.RandomState(seed)
    enc = te.encode_event_stream(
        [f"10.0.0.{rng.randint(6)}->10.0.0.{rng.randint(6)}:m{rng.randint(3)}"
         for _ in range(n)],
        arrivals=sorted(rng.rand(n).tolist()), H=H)
    enc.faultable[: n][np.arange(n) % proc_every == proc_every - 1] = False
    return enc


REFS = [(48, 0), (1100, 1)]  # the second trace scores blockwise


def refs(te):
    return [event_stream(te, n, s) for n, s in REFS]


def seed_archives(search, te):
    for i in range(6):
        search.add_executed_trace(event_stream(te, 40, 10 + i),
                                  reproduced=i == 2)
    search.add_failure_trace(event_stream(te, 50, 99))
    search.add_failure_trace(event_stream(te, 50, 98))


def jax_state_arrays(jsrch):
    st = jsrch._state
    return {
        "pop_delays": np.asarray(st.pop.delays),
        "pop_faults": np.asarray(st.pop.faults), "gen": np.asarray(st.gen),
        "best_fitness": np.asarray(st.best_fitness),
        "best_delays": np.asarray(st.best_delays),
        "best_faults": np.asarray(st.best_faults),
        "archive": jsrch.archive, "failures": jsrch.failures,
        "pairs": jsrch.pairs, "archive_n": jsrch._archive_n,
        "failure_n": jsrch._failure_n,
    }


def test_one_island_generation_with_faults_matches_reference():
    jsrch = jsearch.ScheduleSearch(jax_cfg(), n_devices=1)
    seed_archives(jsrch, jte)
    encs = refs(jte)
    _, trace, pairs, archive, failures = jsrch._device_inputs(encs)
    assert trace.faultable is not None
    step = make_multiaxis_island_step(jsrch.mesh, jsrch.cfg.ga,
                                      jsrch.cfg.weights, rings=jsrch._rings)
    coin = jnp.asarray(jsrch._coin)
    want = step(jsrch._state, jsrch._key, trace, pairs, archive, failures,
                coin, jnp.asarray(1.0, jnp.float32), None)
    key = jax.random.fold_in(jax.random.fold_in(jsrch._key, 0), 0)
    draws = jax_draws(key, 64, H, jsrch.cfg.ga)

    conv = convert.state_from_jax(jax_state_arrays(jsrch), "cpu")
    h, _, a, m, fb = tte.stack_traces(encs)
    got, fit = tisl.island_step(
        conv.state, 0, ts.TraceArrays(t_(h).long(), t_(a), t_(m), t_(fb)),
        t_(conv.pairs), t_(conv.archive), t_(conv.failures),
        tga.GAConfig(*jsrch.cfg.ga), ts.ScoreWeights(*jsrch.cfg.weights),
        draws=draws, coin=t_(jsrch._coin))
    assert np.array_equal(got.pop.delays.numpy(), np.asarray(want.pop.delays))
    assert np.array_equal(got.pop.faults.numpy(), np.asarray(want.pop.faults))
    close(float(got.best_fitness), float(want.best_fitness))
    assert np.array_equal(got.best_faults.numpy(),
                          np.asarray(want.best_faults))


def test_island_step_without_a_coin_raises():
    state = tisl.init_island_state(0, 8, H, tga.GAConfig(max_fault=0.1),
                                   "cpu")
    c = make_case(300)
    with pytest.raises(ValueError, match="fault coin"):
        tisl.island_step(state, 0, ttrace(c), t_(c["pairs"]),
                         t_(c["archive"]), t_(c["failures"]),
                         tga.GAConfig(max_fault=0.1))


def test_fused_equals_stepwise_with_a_coin_bit_for_bit():
    fused = tsearch.ScheduleSearch(port_cfg(fused=True, fused_chunk=3),
                                   device="cpu")
    step = tsearch.ScheduleSearch(port_cfg(fused=False), device="cpu")
    assert fused._coin is not None
    assert np.array_equal(fused._coin, jte.fault_coin(3, H))
    for s in (fused, step):
        seed_archives(s, tte)
    for gens in (5, 4):
        a = fused.run(refs(tte), generations=gens)
        b = step.run(refs(tte), generations=gens)
        assert a.fitness == b.fitness
        assert np.array_equal(a.delays, b.delays)
        assert np.array_equal(a.faults, b.faults)
        assert fused.last_fit_curve == step.last_fit_curve
    assert torch.equal(fused._state.pop.faults, step._state.pop.faults)
    assert fused._state.gen == step._state.gen == 9


def test_fault_search_end_to_end_rescored_by_reference():
    s = tsearch.ScheduleSearch(port_cfg(fused_chunk=4), device="cpu")
    seed_archives(s, tte)
    traces = s._device_inputs(refs(tte))[0]
    assert traces.faultable is not None and not traces.faultable.all()
    first = s.run(refs(tte), generations=6)
    best = s.run(refs(tte), generations=6)
    assert best.fitness >= first.fitness
    assert (best.faults >= 0).all() and (best.faults <= MAX_FAULT).all()
    assert best.faults.any()
    h, _, a, m, fb = jte.stack_traces(refs(jte))
    want, _ = js.score_population_multi(
        jnp.asarray(best.delays[None]),
        js.TraceArrays(jnp.asarray(h), jnp.asarray(a), jnp.asarray(m),
                       jnp.asarray(fb)),
        jnp.asarray(s.pairs), jnp.asarray(s.archive),
        jnp.asarray(s.failures), js.ScoreWeights(),
        faults=jnp.asarray(best.faults[None]),
        coin=jnp.asarray(jte.fault_coin(3, H)))
    close(best.fitness, float(want[0]))


def test_fault_search_without_a_fault_half_keeps_no_coin():
    s = tsearch.ScheduleSearch(port_cfg()._replace(
        ga=tga.GAConfig(max_delay=0.05)), device="cpu")
    assert s._coin is None and s._dev_coin is None
    assert s._device_inputs(refs(tte))[0].faultable is None


def test_fault_checkpoints_load_both_ways(tmp_path):
    jsrch = jsearch.ScheduleSearch(jax_cfg(), n_devices=1)
    seed_archives(jsrch, jte)
    jsrch.run(refs(jte), generations=3)
    path = str(tmp_path / "jax.npz")
    jsrch.save(path)
    s = tsearch.ScheduleSearch(port_cfg(seed=0), device="cpu")
    s.load(path)
    assert np.array_equal(s._state.pop.faults.numpy(),
                          np.asarray(jsrch._state.pop.faults))
    assert np.array_equal(s.best().faults, jsrch.best().faults)
    s.run(refs(tte), generations=2)
    back = str(tmp_path / "port.npz")
    s.save(back)
    j2 = jsearch.ScheduleSearch(jax_cfg(seed=0), n_devices=1)
    j2.load(back)
    assert np.array_equal(np.asarray(j2._state.pop.faults),
                          s._state.pop.faults.numpy())
    assert j2.best().fitness == s.best().fitness
    assert np.array_equal(j2.best().faults, s.best().faults)
    assert j2.generations_run == 5
