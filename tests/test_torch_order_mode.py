"""Order mode (permutation genomes, BASELINE config 3) in the port
(namazu_tpu_torch/ops/schedule.py order_ranks/order_release_times and the
order-mode dispatch of _genome_features) held to namazu_tpu on the same
inputs, made with numpy from a seed: the scorer cases of
tests/test_order_mode.py at P=64, H=K=32, L=300 and L=1500 (order mode
scores dense at every length).

The reference's order_release_times takes one [L] trace and is vmapped;
the port's takes ``prio [.., H]`` against ``[.., T, L]`` traces, so the
reference case test_order_release_rejects_batched_trace has no
counterpart here.

Tolerances: ranks (the sorted order and the rank within a window) must be
equal exactly; release times, features and fitness within rtol 1e-3 /
atol 1e-4; populations given the same draws exactly. Windows are held to
the reference as ``jax.jit`` compiles it (``floor(arrival / window)``
becomes a product with the f32 reciprocal), the form a campaign scores;
eager JAX divides and can disagree within an ulp of a window edge."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from namazu_tpu.models import ga as jga
from namazu_tpu.models import search as jsearch
from namazu_tpu.ops import schedule as js
from namazu_tpu.ops import trace_encoding as jte
from namazu_tpu_torch.models import ga as tga
from namazu_tpu_torch.models import search as tsearch
from namazu_tpu_torch.ops import schedule as ts
from namazu_tpu_torch.ops import trace_encoding as tte
from test_torch_faults import (
    close,
    jax_genome_features,
    jtrace,
    make_case,
    port_genome_features,
    t_,
    ttrace,
)
from test_torch_ga import SIGMA, jax_draws

P, H, K, T = 64, 32, 32, 3
LENGTHS = {"short": 300, "long": 1500}
GAP, WINDOW = 0.002, 0.05
ORDER_W = js.ScoreWeights(order_mode=True, order_gap=GAP,
                          order_window=WINDOW, tau=GAP * 0.5,
                          delay_cost=0.0)


def tied_case(L, seed=0, window=WINDOW):
    """A case with heavy ties: priorities pile up at exactly 0 and
    max_delay (as GA priorities do), arrivals repeat in runs, and some
    arrivals sit exactly on window edges."""
    c = make_case(L, seed)
    rng = np.random.RandomState(seed + 100)
    d = c["delays"]
    d[rng.rand(*d.shape) < 0.3] = 0.0
    d[rng.rand(*d.shape) < 0.2] = np.float32(0.05)
    d[2] = -0.0  # a genome of negative zeros ties with +0.0
    a = c["arrival"]
    a[:, 1::3] = a[:, 0:-1:3][:, : a[:, 1::3].shape[1]]  # exact ties
    edges = (np.arange(10, dtype=np.float32) * np.float32(window))
    a[:, 5:15] = edges
    c["arrival"] = np.sort(a, axis=1)
    return c


def jax_order_release(prio, trace, gap=GAP, window=WINDOW):
    return js.order_release_times(jnp.asarray(prio), trace, gap, window)


def jit_windows(arrival, window):
    """The reference's window expression as ``jax.jit`` compiles it."""
    return np.asarray(jax.jit(
        lambda a: jnp.floor(a / window).astype(jnp.int32))(
            jnp.asarray(arrival)))


def ref_ranks(prio, hint, arrival, mask, window):
    """The reference's sort order and rank within a window for one genome
    against one trace, from ``jnp.lexsort`` on its own keys."""
    if window > 0:
        win = jit_windows(arrival, window)
    else:
        win = np.zeros(arrival.shape, np.int32)
    win = np.where(mask, win, np.iinfo(np.int32).max)
    key = np.where(mask, prio[hint], np.inf).astype(np.float32)
    order = np.asarray(jnp.lexsort((jnp.asarray(arrival), jnp.asarray(key),
                                    jnp.asarray(win))))
    t = np.asarray(jax.jit(lambda p, h, a, m: js.order_release_times(
        p, js.TraceArrays(h, a, m), GAP, window))(
            jnp.asarray(prio), jnp.asarray(hint), jnp.asarray(arrival),
            jnp.asarray(mask)))
    base = (win.astype(np.float32) + np.float32(1.0)) * np.float32(window)
    within = np.rint((t - base) / np.float32(GAP)).astype(np.int64)
    return order, np.where(mask, within, -1)


# -- the reference's scorer cases ----------------------------------------


def trace_of(hints, arrivals, L=32, Hs=16):
    enc = tte.encode_event_stream(hints, arrivals=arrivals, L=L, H=Hs)
    return (ts.TraceArrays(t_(enc.hint_ids).long(), t_(enc.arrival),
                           t_(enc.mask)),
            js.TraceArrays(jnp.asarray(enc.hint_ids),
                           jnp.asarray(enc.arrival), jnp.asarray(enc.mask)),
            enc)


def test_order_release_inverts_arrival_order():
    tt, jt, enc = trace_of(["a", "b"], [0.0, 10.0])
    prio = np.zeros(16, np.float32)
    prio[enc.hint_ids[0]], prio[enc.hint_ids[1]] = 1.0, 0.0
    got = ts.order_release_times(t_(prio), tt, gap=0.001).numpy()
    want = np.asarray(js.order_release_times(jnp.asarray(prio), jt,
                                             gap=0.001))
    assert np.array_equal(got, want)
    assert got[1] == 0.0 and got[0] == pytest.approx(0.001)
    assert got[2] == ts.BIG


def test_order_release_ties_break_by_arrival_then_index():
    # equal priorities everywhere; arrivals 0.0, 1.0, 1.0, 1.0, 2.0: the
    # three exact ties keep their index order
    tt, jt, _ = trace_of(["a", "b", "a", "c", "a"],
                         [0.0, 1.0, 1.0, 1.0, 2.0])
    prio = np.zeros(16, np.float32)
    order, within, _ = ts.order_ranks(t_(prio), tt)
    assert order[:5].tolist() == [0, 1, 2, 3, 4]
    assert within[:5].tolist() == [0, 1, 2, 3, 4]
    got = ts.order_release_times(t_(prio), tt, gap=0.5).numpy()
    want = np.asarray(js.order_release_times(jnp.asarray(prio), jt,
                                             gap=0.5))
    assert np.array_equal(got, want)
    np.testing.assert_allclose(got[:5], [0.0, 0.5, 1.0, 1.5, 2.0])


def test_windowed_order_only_permutes_co_pending_events():
    tt, jt, enc = trace_of(["a", "b", "c"], [0.01, 0.02, 5.0])
    prio = np.zeros(16, np.float32)
    ha, hb, hc = enc.hint_ids[:3]
    prio[ha], prio[hb], prio[hc] = 2.0, 1.0, 0.0
    got = ts.order_release_times(t_(prio), tt, gap=0.001,
                                 window=0.1).numpy()
    want = np.asarray(js.order_release_times(jnp.asarray(prio), jt,
                                             gap=0.001, window=0.1))
    assert np.array_equal(got, want)
    assert got[1] < got[0] < got[2]
    assert got[1] == pytest.approx(0.1)


def test_order_features_distinguish_permutations():
    tt, jt, _ = trace_of(["a", "b", "c", "a"], [0.0, 0.001, 0.002, 0.003])
    pairs = t_(tte.sample_pairs(32, 16, 0))
    ident = torch.linspace(0.0, 1.0, 16)
    f1 = ts.schedule_features(ident, tt, pairs, 0.0005, order_mode=True,
                              order_gap=0.001)
    f2 = ts.schedule_features(1.0 - ident, tt, pairs, 0.0005,
                              order_mode=True, order_gap=0.001)
    assert not torch.allclose(f1, f2)
    want = js.schedule_features(jnp.asarray(ident.numpy()), jt,
                                jnp.asarray(pairs.numpy()), 0.0005,
                                order_mode=True, order_gap=0.001)
    close(f1.numpy(), want)


# -- ranks and release times on a population ------------------------------


@pytest.mark.parametrize("window", [0.0, WINDOW])
@pytest.mark.parametrize("kind", sorted(LENGTHS))
def test_ranks_equal_reference_exactly(kind, window):
    c = tied_case(LENGTHS[kind], seed=7, window=window or WINDOW)
    order, within, _ = ts.order_ranks(t_(c["delays"]), ttrace(c), window)
    assert order.shape == within.shape == (P, T, LENGTHS[kind])
    for p in (0, 1, 2, 5, 63):
        for t in range(T):
            want_o, want_w = ref_ranks(c["delays"][p], c["hint"][t],
                                       c["arrival"][t], c["mask"][t],
                                       window)
            assert np.array_equal(order[p, t].numpy(), want_o)
            m = c["mask"][t]
            assert np.array_equal(within[p, t].numpy()[m], want_w[m])


@pytest.mark.parametrize("window", [0.0, WINDOW])
def test_release_times_match_reference(window):
    c = tied_case(300, seed=8)
    got = ts.order_release_times(t_(c["delays"]), ttrace(c), GAP,
                                 window).numpy()
    want = jax.vmap(lambda d: jax.vmap(lambda tr: js.order_release_times(
        d, tr, GAP, window))(jtrace(c)))(jnp.asarray(c["delays"]))
    close(got, want)
    assert (got[:, ~c["mask"]] == ts.BIG).all()


def edge_arrivals(window, n=4000):
    """Arrivals at k * window (k * 0.05 at the default) and one f32 ulp
    either side, sorted."""
    base = (np.arange(n, dtype=np.float64) * window).astype(np.float32)
    a = np.concatenate([base, np.nextafter(base, np.float32(np.inf)),
                        np.nextafter(base, np.float32(-np.inf))])
    return np.sort(a[a >= 0]).astype(np.float32)


@pytest.mark.parametrize("window", [WINDOW, 0.03, 0.007])
def test_window_edges_follow_the_jitted_reference(window):
    """C2: at window edges the port's windows equal the jitted
    reference's exactly (where eager division would disagree), so its
    ranks within a window do too, and its release times match the jitted
    order_release_times."""
    arr = edge_arrivals(window)
    rng = np.random.RandomState(3)
    hint = rng.randint(0, 16, arr.size).astype(np.int32)
    mask = np.ones(arr.size, bool)
    prio = rng.rand(16).astype(np.float32)
    trace = ts.TraceArrays(t_(hint).long(), t_(arr), t_(mask))
    order, within, win = ts.order_ranks(t_(prio), trace, window)
    want_win = jit_windows(arr, window)
    eager = np.asarray(jnp.floor(jnp.asarray(arr) / window).astype(jnp.int32))
    assert (eager != want_win).any()  # the edges the two forms split
    assert np.array_equal(win.numpy(), want_win)
    want_o, want_w = ref_ranks(prio, hint, arr, mask, window)
    assert np.array_equal(order.numpy(), want_o)
    assert np.array_equal(within.numpy(), want_w)
    got = ts.order_release_times(t_(prio), trace, GAP, window).numpy()
    want = jax.jit(lambda p, h, a, m: js.order_release_times(
        p, js.TraceArrays(h, a, m), GAP, window))(
            jnp.asarray(prio), jnp.asarray(hint), jnp.asarray(arr),
            jnp.asarray(mask))
    close(got, want)


def test_negative_zero_priority_ties_with_zero():
    c = tied_case(300, seed=9)
    prio = np.zeros((2, H), np.float32)
    prio[1] = -0.0
    order, within, _ = ts.order_ranks(t_(prio), ttrace(c), WINDOW)
    assert torch.equal(order[0], order[1])
    assert torch.equal(within[0], within[1])


def test_row_slices_give_the_same_features(monkeypatch):
    c = tied_case(300, seed=10)
    w = ts.ScoreWeights(*ORDER_W)
    whole, n_whole = port_genome_features(c, w)
    monkeypatch.setattr(ts, "ORDER_CHUNK_ELEMS", 7 * T * 300)
    sliced, n_sliced = port_genome_features(c, w)
    assert torch.equal(whole, sliced) and torch.equal(n_whole, n_sliced)


@pytest.mark.parametrize("faults", [False, True])
@pytest.mark.parametrize("kind", sorted(LENGTHS))
def test_order_features_match_reference(kind, faults):
    """Order mode scores dense at every length; with a fault half the
    drops happen before the permutation."""
    c = tied_case(LENGTHS[kind], seed=11)
    want_f, want_n = jax_genome_features(c, ORDER_W, faults=faults)
    got_f, got_n = port_genome_features(c, ts.ScoreWeights(*ORDER_W),
                                        faults=faults)
    close(got_f.numpy(), np.swapaxes(np.asarray(want_f), 0, 1))
    if faults:
        assert np.array_equal(got_n.numpy(), np.asarray(want_n).T)
    else:
        assert got_n is None


# -- population scoring and a GA generation -------------------------------


@pytest.mark.parametrize("faults", [False, True])
def test_order_mode_population_scoring_and_ga_generation(faults):
    c = tied_case(300, seed=12)
    kw_j = {}
    kw_t = {}
    if faults:
        kw_j = dict(faults=jnp.asarray(c["faults"]),
                    coin=jnp.asarray(c["coin"]))
        kw_t = dict(faults=t_(c["faults"]), coin=t_(c["coin"]))
    want_fit, want_feats = js.score_population_multi(
        jnp.asarray(c["delays"]), jtrace(c), jnp.asarray(c["pairs"]),
        jnp.asarray(c["archive"]), jnp.asarray(c["failures"]), ORDER_W,
        **kw_j)
    got_fit, got_feats = ts.score_population_multi(
        t_(c["delays"]), ttrace(c), t_(c["pairs"]), t_(c["archive"]),
        t_(c["failures"]), ts.ScoreWeights(*ORDER_W), **kw_t)
    close(got_feats.numpy(), want_feats)
    close(got_fit.numpy(), want_fit)
    assert float(got_feats.std(0).max()) > 0.0  # genome-sensitive
    # one GA generation from each side's fitness, given JAX's draws
    cfg = jga.GAConfig(max_delay=0.05, max_fault=0.3, mutation_sigma=SIGMA)
    key = jax.random.PRNGKey(4)
    want = jga.ga_generation(
        key, jga.Population(jnp.asarray(c["delays"]),
                            jnp.asarray(c["faults"])), want_fit, cfg)
    got = tga.ga_generation(
        None, tga.Population(t_(c["delays"]), t_(c["faults"])), got_fit,
        tga.GAConfig(*cfg), draws=jax_draws(key, P, H, cfg))
    assert np.array_equal(got.delays.numpy(), np.asarray(want.delays))
    assert np.array_equal(got.faults.numpy(), np.asarray(want.faults))


def test_single_trace_population_scoring_matches():
    c = tied_case(300, seed=13)
    want_fit, want_feats = js.score_population(
        jnp.asarray(c["delays"]), jtrace(c, 1), jnp.asarray(c["pairs"]),
        jnp.asarray(c["archive"]), jnp.asarray(c["failures"]), ORDER_W)
    got_fit, got_feats = ts.score_population(
        t_(c["delays"]), ttrace(c, 1), t_(c["pairs"]), t_(c["archive"]),
        t_(c["failures"]), ts.ScoreWeights(*ORDER_W))
    close(got_feats.numpy(), want_feats)
    close(got_fit.numpy(), want_fit)


# -- the search in order mode ---------------------------------------------


def order_cfg(max_fault=0.0, **kw):
    c = jsearch.SearchConfig(
        H=H, K=K, archive_size=16, failure_size=8, population=64, seed=3,
        ga=jga.GAConfig(max_delay=0.05, max_fault=max_fault,
                        mutation_sigma=SIGMA),
        weights=jsearch.make_score_weights("reorder", reorder_gap=GAP,
                                           reorder_window=WINDOW))
    c = c._replace(**kw)
    return c, tsearch.SearchConfig(*c)._replace(
        ga=tga.GAConfig(*c.ga), weights=ts.ScoreWeights(*c.weights))


def streams(te, n, seed):
    rng = np.random.RandomState(seed)
    return te.encode_event_stream(
        [f"10.0.0.{rng.randint(6)}->10.0.0.{rng.randint(6)}:m{rng.randint(3)}"
         for _ in range(n)],
        arrivals=sorted((rng.rand(n) * 0.3).tolist()), H=H, L=1536)


@pytest.mark.parametrize("max_fault", [0.0, 0.3])
def test_order_search_fused_equals_stepwise_and_rescores(max_fault):
    _, fused_cfg = order_cfg(max_fault, fused=True, fused_chunk=3)
    _, step_cfg = order_cfg(max_fault, fused=False)
    fused = tsearch.ScheduleSearch(fused_cfg, device="cpu")
    step = tsearch.ScheduleSearch(step_cfg, device="cpu")
    assert fused.cfg.weights.order_mode
    refs = [streams(tte, 300, 1), streams(tte, 1200, 2)]
    for s in (fused, step):
        for i in range(4):
            s.add_executed_trace(streams(tte, 100, 10 + i))
        s.add_failure_trace(streams(tte, 100, 20))
    for gens in (4, 3):
        a = fused.run(refs, generations=gens)
        b = step.run(refs, generations=gens)
        assert a.fitness == b.fitness and np.array_equal(a.delays, b.delays)
        assert np.array_equal(a.faults, b.faults)
    h, _, arr, m, fb = jte.stack_traces(
        [streams(jte, 300, 1), streams(jte, 1200, 2)])
    want, _ = js.score_population_multi(
        jnp.asarray(a.delays[None]),
        js.TraceArrays(jnp.asarray(h), jnp.asarray(arr), jnp.asarray(m),
                       jnp.asarray(fb)),
        jnp.asarray(fused.pairs), jnp.asarray(fused.archive),
        jnp.asarray(fused.failures), order_cfg()[0].weights,
        faults=jnp.asarray(a.faults[None]) if max_fault else None,
        coin=jnp.asarray(jte.fault_coin(3, H)) if max_fault else None)
    close(a.fitness, float(want[0]))
