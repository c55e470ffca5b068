"""The port's MCTS backend (namazu_tpu_torch/models/mcts.py and
MCTSSearch in models/search.py) held to namazu_tpu's, in two parts, since
the scorer agrees only within tolerance and a near tie in UCT could flip
a selection:

1. the tree logic: both packages' rollouts are replaced by the same
   deterministic function of the pinned levels (the reference's through
   ``monkeypatch`` of ``namazu_tpu.models.mcts._make_rollout``); the
   trees (parent, action, depth, children, visits, value sums) and the
   best tables must then be equal exactly;
2. one rollout: given the same draws, made by ``jax.random`` under the
   reference's split, its mean, best fitness and best tables must agree
   within rtol 1e-3 / atol 1e-4.

Then the cases of tests/test_mcts.py that hold for one card, and
checkpoints across the two packages. Sizes are small (H=32, K=64, one
trace of 48 events)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from namazu_tpu.models import ga as jga
from namazu_tpu.models import mcts as jmcts
from namazu_tpu.models import search as jsearch
from namazu_tpu.ops import schedule as js
from namazu_tpu.ops import trace_encoding as jte
from namazu_tpu_torch.models import ga as tga
from namazu_tpu_torch.models import mcts as tmcts
from namazu_tpu_torch.models import search as tsearch
from namazu_tpu_torch.ops import pair_distance as pd
from namazu_tpu_torch.ops import schedule as ts
from namazu_tpu_torch.ops import trace_encoding as tte

RTOL, ATOL = 1e-3, 1e-4
H, L, K = 32, 64, 64
CFG = tmcts.MCTSConfig(tree_depth=6, n_levels=4, simulations=48,
                       rollouts=16, max_delay=0.05)
SHALLOW = tmcts.MCTSConfig(tree_depth=2, n_levels=3, simulations=20,
                           rollouts=8, max_delay=0.05)


def jcfg(cfg):
    return jmcts.MCTSConfig(*cfg)


def toy(n=48, n_hints=12, seed=0, cfg=CFG):
    """One trace of a periodic hint stream, both packages' arrays."""
    enc = tte.encode_event_stream(
        [f"hint{i % n_hints}" for i in range(n)],
        arrivals=[i * 0.001 for i in range(n)], L=L, H=H)
    pairs = tte.sample_pairs(K, H, seed)
    counts = np.bincount(enc.hint_ids[enc.mask], minlength=H)
    order = np.argsort(-counts)[: cfg.tree_depth].astype(np.int32)
    port = (ts.TraceArrays(torch.from_numpy(enc.hint_ids[None]).long(),
                           torch.from_numpy(enc.arrival[None]),
                           torch.from_numpy(enc.mask[None])),
            torch.from_numpy(pairs), torch.full((16, K), 0.5),
            torch.full((4, K), 0.5), order)
    ref = (js.TraceArrays(jnp.asarray(enc.hint_ids[None]),
                          jnp.asarray(enc.arrival[None]),
                          jnp.asarray(enc.mask[None])),
           jnp.asarray(pairs), jnp.full((16, K), 0.5, jnp.float32),
           jnp.full((4, K), 0.5, jnp.float32), jnp.asarray(order))
    return enc, port, ref


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


# -- part 1: the tree under a shared deterministic rollout ---------------


def _values(levels, depth, xp):
    """Over the last axis, so the port's lockstep rollout can take a
    batch of trees' levels ``[I, depth]``."""
    on = levels >= 0
    d = xp.arange(depth)
    v = xp.where(on, ((levels + 2) * (d + 3)) % 7, 0)
    mean = v.sum(-1) / 16.0
    bonus = (xp.where(on, levels, 0).sum(-1) % 3) / 8.0
    return on, mean, bonus


def jax_rollout_factory(trace, pairs, archive, failure_feats, hint_order,
                        level_values, H, cfg, weights, coin=None,
                        seeds=None):
    def rollout(key, levels):
        on, mean, bonus = _values(levels, cfg.tree_depth, jnp)
        mean = mean.astype(jnp.float32)
        d = jnp.zeros((H,), jnp.float32).at[: cfg.tree_depth].set(
            jnp.where(on, levels, 0).astype(jnp.float32) / 8.0)
        return mean, mean + bonus.astype(jnp.float32), d, -d
    return rollout


def port_rollout_factory(trace, pairs, archive, failure_feats, hint_order,
                         values, H, cfg, weights, coin=None, seeds=None,
                         tree_seeds=(0,)):
    def rollout(sim, levels, draws=None):
        lv = torch.from_numpy(levels.astype(np.int64))  # [I, depth]
        on, mean, bonus = _values(lv, cfg.tree_depth, torch)
        mean = mean.float()
        d = torch.zeros((lv.shape[0], H))
        d[:, : cfg.tree_depth] = torch.where(on, lv, 0).float() / 8.0
        return mean, mean + bonus.float(), d, -d
    return rollout


@pytest.mark.parametrize("cfg", [CFG, SHALLOW], ids=["deep", "shallow"])
def test_tree_equals_reference_under_a_shared_rollout(cfg, monkeypatch):
    _, port, ref = toy(cfg=cfg)
    monkeypatch.setattr(jmcts, "_make_rollout", jax_rollout_factory)
    monkeypatch.setattr(tmcts, "_make_rollout", port_rollout_factory)
    captured = {}
    fori_loop = jax.lax.fori_loop

    def spy(lower, upper, body, init):
        out = fori_loop(lower, upper, body, init)
        captured["carry"] = out
        return out

    monkeypatch.setattr(jax.lax, "fori_loop", spy)
    want = jmcts.mcts_search(jax.random.PRNGKey(0), *ref, H, jcfg(cfg))
    got = tmcts.mcts_search(0, *port, H, cfg)
    wt = captured["carry"].tree
    gt = got.tree
    assert gt.n_nodes == int(wt.n_nodes)
    for f in ("parent", "action", "depth", "children", "visit",
              "value_sum"):
        assert np.array_equal(getattr(gt, f), np.asarray(getattr(wt, f))), f
    assert np.array_equal(got.tree_visits, np.asarray(want.tree_visits))
    assert np.array_equal(got.root_child_visits,
                          np.asarray(want.root_child_visits))
    assert float(got.best_fitness) == float(want.best_fitness)
    assert np.array_equal(got.best_delays.numpy(),
                          np.asarray(want.best_delays))
    assert np.array_equal(got.best_faults.numpy(),
                          np.asarray(want.best_faults))
    if cfg is SHALLOW:  # leaves at maximum depth took no expansion
        assert gt.n_nodes <= 1 + 3 + 9 < cfg.simulations + 1
        assert gt.visit[0] == cfg.simulations


def test_ucb_scores_match_reference(monkeypatch):
    """The port's f32 UCT scores against the reference's on a grown tree,
    for every expanded node."""
    _, port, ref = toy()
    monkeypatch.setattr(tmcts, "_make_rollout", port_rollout_factory)
    tree = tmcts.mcts_search(0, *port, H, CFG).tree
    jtree = jmcts.Tree(*(jnp.asarray(a) for a in tree[:-1]),
                       n_nodes=jnp.asarray(tree.n_nodes, jnp.int32))
    for vmin, vmax in ((0.25, 1.5), (np.inf, -np.inf), (0.5, 0.5)):
        for node in range(tree.n_nodes):
            got = tmcts._ucb_scores(tree, node, np.float32(vmin),
                                    np.float32(vmax), CFG.c_uct)
            want = np.asarray(jmcts._ucb_scores(
                jtree, jnp.int32(node), jnp.float32(vmin),
                jnp.float32(vmax), CFG.c_uct))
            assert np.array_equal(np.isinf(got), np.isinf(want))
            close(got[np.isfinite(got)], want[np.isfinite(want)])


# -- part 2: one rollout, given the reference's draws ---------------------


@pytest.mark.parametrize("kind", ["plain", "seeded", "faults"])
def test_one_rollout_matches_reference(kind):
    cfg = CFG._replace(max_fault=0.3 if kind == "faults" else 0.0)
    _, port, ref = toy(cfg=cfg)
    coin = tte.fault_coin(5, H) if kind == "faults" else None
    seeds = (np.random.RandomState(1).rand(16, H) * 0.05).astype(np.float32) \
        if kind == "seeded" else None
    levels = np.array([2, 0, 3, -1, -1, -1], np.int32)
    values = tmcts.level_values(cfg)
    want_roll = jmcts._make_rollout(
        *ref[:4], ref[4], jnp.asarray(values), H, jcfg(cfg),
        js.ScoreWeights(), coin=None if coin is None else jnp.asarray(coin),
        seeds=None if seeds is None else jnp.asarray(seeds))
    key = jax.random.PRNGKey(11)
    want = want_roll(key, jnp.asarray(levels))
    kd, kf, ks = jax.random.split(key, 3)
    n_seeded = tmcts.n_seeded_rows(cfg, 0 if seeds is None else 16)
    draws = tmcts.RolloutDraws(  # one tree: a leading axis of 1
        delays=torch.from_numpy(np.array(jax.random.uniform(
            kd, (1, cfg.rollouts, H), jnp.float32, 0.0, cfg.max_delay))),
        faults=torch.from_numpy(np.array(jax.random.uniform(
            kf, (1, cfg.rollouts, H), jnp.float32, 0.0, cfg.max_fault))),
        noise=torch.from_numpy(np.array(jax.random.normal(
            ks, (1, n_seeded, H)))))
    got_roll = tmcts._make_rollout(
        *port[:4], port[4], values, H, cfg, ts.ScoreWeights(),
        coin=None if coin is None else torch.from_numpy(coin),
        seeds=None if seeds is None else torch.from_numpy(seeds))
    got = [x[0] for x in got_roll(0, levels[None], draws=draws)]
    assert n_seeded == (8 if kind == "seeded" else 0)
    for g, w in zip(got, want):
        close(g.numpy(), w)
    pinned = port[4][levels >= 0]
    assert np.array_equal(got[2].numpy()[pinned], values[levels[:3]])
    if kind == "faults":
        assert float(got[3].max()) > 0.0


def test_level_values_round_as_the_reference():
    for D, m in ((8, 0.1), (4, 0.05), (3, 0.05), (5, 0.3), (1, 0.1),
                 (16, 0.1), (24, 0.1), (32, 0.37)):
        cfg = tmcts.MCTSConfig(n_levels=D, max_delay=m)
        want = np.asarray(jnp.linspace(0.0, m, D).astype(jnp.float32))
        assert np.array_equal(tmcts.level_values(cfg), want)


# -- the reference's cases ------------------------------------------------


def run_search(seed, cfg=CFG, failures=None):
    _, port, _ = toy(cfg=cfg)
    if failures is not None:
        port = port[:3] + (failures,) + port[4:]
    return tmcts.mcts_search(seed, *port, H, cfg)


def test_search_runs_is_bounded_and_deterministic():
    a, b, c = run_search(7), run_search(7), run_search(8)
    assert np.isfinite(float(a.best_fitness))
    d = a.best_delays.numpy()
    assert d.shape == (H,) and (d >= 0).all()
    assert (d <= CFG.max_delay + 1e-6).all()
    assert float(a.best_faults.abs().max()) == 0.0  # delay-only config
    assert float(a.best_fitness) == float(b.best_fitness)
    assert torch.equal(a.best_delays, b.best_delays)
    assert not torch.equal(a.best_delays, c.best_delays)


def test_tree_invariants():
    res = run_search(1)
    v = res.tree_visits
    assert v[0] == CFG.simulations
    assert (v <= v[0]).all()
    assert res.root_child_visits.sum() == CFG.simulations
    t = res.tree
    kids = t.children[: t.n_nodes]
    for n in range(1, t.n_nodes):
        assert kids[t.parent[n], t.action[n]] == n
        assert t.depth[n] == t.depth[t.parent[n]] + 1
    assert t.n_nodes == CFG.simulations + 1  # one node per simulation


def test_one_b1_launch_per_simulation(monkeypatch):
    calls = []
    real = pd.min_sq_distance_pair_reference

    def counting(*a, **kw):
        calls.append(a[0].shape[0])
        return real(*a, **kw)

    monkeypatch.setattr(pd, "min_sq_distance_pair_reference", counting)
    run_search(2)
    assert calls == [CFG.rollouts] * CFG.simulations  # N = R * T rows


def test_mcts_finds_bug_affine_schedule():
    _, port, _ = toy()
    trace, pairs, archive, _, order = port
    target = torch.zeros(H)
    target[torch.from_numpy(order).long()] = CFG.max_delay
    tr = ts.TraceArrays(*(x[0] for x in trace[:3]))
    failures = ts.schedule_features(target, tr, pairs, 0.005)[None].repeat(
        4, 1)
    res = tmcts.mcts_search(3, *port[:3], failures, order, H, CFG)
    rand = torch.rand((256, H), generator=torch.Generator().manual_seed(4))
    rand_fit, _ = ts.score_population_multi(rand * CFG.max_delay, trace,
                                            pairs, archive, failures)
    assert float(res.best_fitness) > float(rand_fit.mean())


def test_seeded_rollouts_reach_demonstration_quality():
    _, port, _ = toy()
    trace, pairs, archive, _, order = port
    target = np.zeros((H,), np.float32)
    hot = order[:2]
    target[hot] = CFG.max_delay
    tr = ts.TraceArrays(*(x[0] for x in trace[:3]))
    failures = ts.schedule_features(torch.from_numpy(target), tr, pairs,
                                    0.005)[None].repeat(4, 1)
    unseeded = tmcts.mcts_search(9, *port[:3], failures, order, H, CFG)
    seeded = tmcts.mcts_search(9, *port[:3], failures, order, H, CFG,
                               seeds=torch.from_numpy(target)[None])
    assert float(seeded.best_fitness) >= \
        float(unseeded.best_fitness) * (1 - 1e-3)
    assert seeded.best_delays.numpy()[hot].min() > 0.0


def test_fault_search_needs_a_coin():
    _, port, _ = toy()
    with pytest.raises(ValueError, match="fault coin"):
        tmcts.mcts_search(0, *port, H, CFG._replace(max_fault=0.1))


def test_init_tree_shapes():
    t = tmcts.init_tree(CFG)
    assert t.children.shape == (CFG.simulations + 1, CFG.n_levels)
    assert t.n_nodes == 1 and (t.children == tmcts.NO_CHILD).all()
    assert tmcts.MCTSConfig._fields == jmcts.MCTSConfig._fields
    assert tuple(tmcts.MCTSConfig()) == tuple(jmcts.MCTSConfig())


# -- the driver -------------------------------------------------------------


def search_cfg(te_ga=tga, max_fault=0.0, H_=H, seed=5):
    return tsearch.SearchConfig(H=H_, L=L, K=K, archive_size=16,
                                failure_size=4, seed=seed,
                                ga=tga.GAConfig(max_delay=0.05,
                                                max_fault=max_fault))


def jsearch_cfg(max_fault=0.0, seed=5):
    return jsearch.SearchConfig(H=H, L=L, K=K, archive_size=16,
                                failure_size=4, seed=seed,
                                ga=jga.GAConfig(max_delay=0.05,
                                                max_fault=max_fault))


def toy_encoded(te, n=40, n_hints=10):
    return te.encode_event_stream(
        [f"hint{i % n_hints}" for i in range(n)],
        arrivals=[i * 0.001 for i in range(n)], L=L, H=H)


def test_driver_monotonic_and_checkpoint_continues_the_stream(tmp_path):
    enc = toy_encoded(tte)
    s = tsearch.MCTSSearch(search_cfg(), mcts_cfg=CFG, device="cpu")
    s.add_executed_trace(enc)
    s.add_failure_trace(enc)
    best1 = s.run(enc, generations=64)
    best2 = s.run([enc, enc], generations=128)  # two searches
    assert best2.fitness >= best1.fitness
    assert s.generations_run == 3 * CFG.simulations
    assert s.last_run_seconds > 0
    path = str(tmp_path / "mcts.npz")
    s.save(path)
    with np.load(path) as z:
        assert str(z["backend"]) == "mcts"
        assert z["key"].dtype == np.uint32 and z["key"].shape == (2,)
    s2 = tsearch.MCTSSearch(search_cfg(), mcts_cfg=CFG, device="cpu")
    s2.load(path)
    assert s2.best().fitness == best2.fitness
    assert np.array_equal(s2.best().delays, best2.delays)
    assert s2.generations_run == s.generations_run
    # the loaded key continues the stream: both draw the same next search
    a, b = s.run(enc, generations=64), s2.run(enc, generations=64)
    assert a.fitness == b.fitness and np.array_equal(a.delays, b.delays)
    assert a.fitness >= best2.fitness


def test_hint_order_prefers_frequent_buckets():
    enc = toy_encoded(tte, n=40, n_hints=4)
    s = tsearch.MCTSSearch(search_cfg(), mcts_cfg=CFG, device="cpu")
    order = s._hint_order([enc])
    assert order.shape == (CFG.tree_depth,)
    counts = np.bincount(enc.hint_ids[enc.mask], minlength=H)
    hot = set(np.nonzero(counts)[0].tolist())
    assert set(order[: len(hot)].tolist()) == hot
    js_ = jsearch.MCTSSearch(jsearch_cfg(), mcts_cfg=jcfg(CFG), n_devices=1)
    want = js_._hint_order([toy_encoded(jte, n=40, n_hints=4)])
    assert np.array_equal(order, want)  # the reference's buckets, ties too


@pytest.mark.parametrize("seed", range(6))
def test_hint_order_breaks_ties_as_the_reference(seed):
    """Counts with many ties inside and at the tree-depth cut: the port
    pins exactly the reference's buckets, in its order."""
    rng = np.random.RandomState(seed)
    hints = [f"h{rng.randint(24)}" for _ in range(rng.randint(8, 60))]
    cfg = tmcts.MCTSConfig(tree_depth=12, n_levels=3, simulations=8,
                           rollouts=4, max_delay=0.05)
    s = tsearch.MCTSSearch(search_cfg(), mcts_cfg=cfg, device="cpu")
    js_ = jsearch.MCTSSearch(jsearch_cfg(), mcts_cfg=jcfg(cfg), n_devices=1)
    encs = [tte.encode_event_stream(hints[i::2], H=H) for i in range(2)]
    jencs = [jte.encode_event_stream(hints[i::2], H=H) for i in range(2)]
    counts = sum(np.bincount(e.hint_ids[e.mask], minlength=H) for e in encs)
    assert len(set(counts.tolist())) < H  # ties exist
    assert np.array_equal(s._hint_order(encs), js_._hint_order(jencs))


def test_tree_depth_clamped_to_hint_buckets():
    cfg = search_cfg(H_=8)
    s = tsearch.MCTSSearch(cfg, mcts_cfg=tmcts.MCTSConfig(
        tree_depth=24, n_levels=3, simulations=8, rollouts=4,
        max_delay=0.05), device="cpu")
    assert s.mcts_cfg.tree_depth == 8
    enc = tte.encode_event_stream(["a", "b", "c", "a"],
                                  arrivals=[0.0, 0.001, 0.002, 0.003],
                                  L=L, H=8)
    assert np.isfinite(s.run(enc, generations=1).fitness)


def test_seed_population_tiles_to_sixteen_rows():
    enc = toy_encoded(tte)
    s = tsearch.MCTSSearch(search_cfg(), mcts_cfg=CFG, device="cpu")
    demo = np.full((H,), 0.01, np.float32)
    s.seed_population([demo, demo * 2, demo * 9])  # 0.09 clips to 0.05
    assert s._seed_tables.shape == (tsearch.MCTSSearch.SEED_ROWS, H)
    assert np.allclose(s._seed_tables[2::3], 0.05)
    s.add_executed_trace(enc, reproduced=True)
    s.add_failure_trace(enc)
    assert np.isfinite(s.run([enc], generations=64).fitness)


def test_checkpoint_backend_mismatch_rejected(tmp_path):
    s = tsearch.MCTSSearch(search_cfg(), mcts_cfg=CFG, device="cpu")
    path = str(tmp_path / "ck.npz")
    s.save(path)
    ga = tsearch.ScheduleSearch(search_cfg(), device="cpu")
    with pytest.raises(ValueError, match="mcts"):
        ga.load(path)
    ga.save(path)
    with pytest.raises(ValueError, match="ga"):
        tsearch.MCTSSearch(search_cfg(), mcts_cfg=CFG,
                           device="cpu").load(path)


@pytest.mark.parametrize("max_fault", [0.0, 0.2])
def test_checkpoints_load_in_both_packages(tmp_path, max_fault):
    cfg = CFG._replace(max_fault=max_fault)
    j = jsearch.MCTSSearch(jsearch_cfg(max_fault), mcts_cfg=jcfg(cfg),
                           n_devices=1)
    j.add_executed_trace(toy_encoded(jte))
    j.add_failure_trace(toy_encoded(jte, n_hints=7))
    jbest = j.run(toy_encoded(jte), generations=64)
    path = str(tmp_path / "jax.npz")
    j.save(path)
    s = tsearch.MCTSSearch(search_cfg(max_fault=max_fault), mcts_cfg=cfg,
                           device="cpu")
    s.load(path)
    assert s.best().fitness == pytest.approx(jbest.fitness, rel=0, abs=0)
    assert np.array_equal(s.best().delays, jbest.delays)
    assert np.array_equal(s.best().faults, jbest.faults)
    assert np.array_equal(s.archive, j.archive)
    assert s.generations_run == j.generations_run == CFG.simulations
    pbest = s.run(toy_encoded(tte), generations=64)
    assert pbest.fitness >= jbest.fitness
    back = str(tmp_path / "port.npz")
    s.save(back)
    j2 = jsearch.MCTSSearch(jsearch_cfg(max_fault), mcts_cfg=jcfg(cfg),
                            n_devices=1)
    j2.load(back)
    assert j2.best().fitness == s.best().fitness
    assert np.array_equal(j2.best().delays, s.best().delays)
    assert np.array_equal(j2.best().faults, s.best().faults)
    assert j2.generations_run == 2 * CFG.simulations
    assert j2.run(toy_encoded(jte), generations=64).fitness >= pbest.fitness


def test_fault_mcts_rescored_by_reference():
    """With max_fault > 0 the rollouts score their fault tables through
    the coin, so the returned faults are the scored ones."""
    cfg = CFG._replace(max_fault=0.3)
    s = tsearch.MCTSSearch(search_cfg(max_fault=0.3), mcts_cfg=cfg,
                           device="cpu")
    enc = toy_encoded(tte)
    s.add_executed_trace(enc)
    s.add_failure_trace(toy_encoded(tte, n_hints=7))
    best = s.run(enc, generations=64)
    assert best.faults.any() and (best.faults <= 0.3).all()
    want, _ = js.score_population_multi(
        jnp.asarray(best.delays[None]),
        js.TraceArrays(jnp.asarray(enc.hint_ids[None]),
                       jnp.asarray(enc.arrival[None]),
                       jnp.asarray(enc.mask[None]),
                       jnp.asarray(enc.faultable[None])),
        jnp.asarray(s.pairs), jnp.asarray(s.archive),
        jnp.asarray(s.failures), js.ScoreWeights(),
        faults=jnp.asarray(best.faults[None]),
        coin=jnp.asarray(jte.fault_coin(5, H)))
    close(best.fitness, float(want[0]))


# -- root-parallel trees ----------------------------------------------------


def seeded_rollout_factory(*args, tree_seeds=(0,), **kw):
    """The shared rollout shifted by each tree's seed, so trees of
    different seeds grow differently."""
    base = port_rollout_factory(*args, tree_seeds=tree_seeds, **kw)
    shift = torch.tensor([(s % 5) / 64.0 for s in tree_seeds])

    def rollout(sim, levels, draws=None):
        mean, fit, d, f = base(sim, levels)
        return mean + shift, fit + shift, d + shift[:, None], f
    return rollout


def test_parallel_trees_match_reference_under_a_shared_rollout(monkeypatch):
    """4 trees on make_mesh(4) against the reference's make_parallel_mcts
    on 4 devices, both packages' rollouts replaced by the shared one: the
    gathered best is the same."""
    from namazu_tpu.parallel.mesh import make_mesh as jmake_mesh
    from namazu_tpu_torch.parallel.mesh import make_mesh

    _, port, ref = toy()
    monkeypatch.setattr(jmcts, "_make_rollout", jax_rollout_factory)
    monkeypatch.setattr(tmcts, "_make_rollout", port_rollout_factory)
    want = jmcts.make_parallel_mcts(jmake_mesh(4), H, jcfg(CFG))(
        jax.random.PRNGKey(0), *ref)
    got = tmcts.parallel_mcts(0, make_mesh(4, device="cpu"), *port, H, CFG)
    assert float(got[0]) == float(want[0])
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))


@pytest.mark.parametrize("rollouts", ["shared", "scored"])
def test_lockstep_trees_equal_sequential_searches(rollouts, monkeypatch):
    """Four trees advanced in lockstep grow exactly as four searches of
    their seeds alone: under a seed-dependent shared rollout, and with
    the real scored rollouts."""
    if rollouts == "shared":
        monkeypatch.setattr(tmcts, "_make_rollout", seeded_rollout_factory)
    _, port, _ = toy()
    seeds = [3, 11, 12, 40]
    lock = tmcts.mcts_search_trees(seeds, *port, H, CFG)
    assert len({float(r.best_fitness) for r in lock}) > 1
    for seed, got in zip(seeds, lock):
        want = tmcts.mcts_search(seed, *port, H, CFG)
        for f in ("parent", "action", "depth", "children", "visit",
                  "value_sum"):
            assert np.array_equal(getattr(got.tree, f),
                                  getattr(want.tree, f)), f
        assert float(got.best_fitness) == float(want.best_fitness)
        assert torch.equal(got.best_delays, want.best_delays)


def test_trees_share_one_b1_launch_per_simulation(monkeypatch):
    calls = []
    real = pd.min_sq_distance_pair_reference

    def counting(*a, **kw):
        calls.append(a[0].shape[0])
        return real(*a, **kw)

    monkeypatch.setattr(pd, "min_sq_distance_pair_reference", counting)
    _, port, _ = toy()
    tmcts.mcts_search_trees([0, 1, 2], *port, H, CFG)
    assert calls == [3 * CFG.rollouts] * CFG.simulations


def test_driver_on_four_trees_and_a_hybrid_mesh(tmp_path):
    """MCTSSearch over make_mesh(4) and over a 2 x 2 hybrid mesh on the
    CPU: a tree is seeded from its coordinates, the (0, 0) tree from the
    search seed, so the one-tree search's best is one of the candidates
    and the gathered best is at least it."""
    from namazu_tpu_torch.parallel import distributed as tdist

    enc = toy_encoded(tte)
    one = tsearch.MCTSSearch(search_cfg(), mcts_cfg=CFG, device="cpu")
    four = tsearch.MCTSSearch(search_cfg(), mcts_cfg=CFG, n_devices=4,
                              device="cpu")
    hyb = tsearch.MCTSSearch(
        search_cfg(), mcts_cfg=CFG,
        mesh=tdist.make_hybrid_mesh(n_hosts=2, devices=["cpu"] * 4))
    assert four.mesh.shape == {"i": 4} and hyb.mesh.shape == {"h": 2, "i": 2}
    for s in (one, four, hyb):
        s.add_executed_trace(enc)
        s.add_failure_trace(toy_encoded(tte, n_hints=7))
    b1, b4, bh = (s.run(enc, generations=64) for s in (one, four, hyb))
    assert b4.fitness >= b1.fitness and bh.fitness >= b1.fitness
    assert four.generations_run == CFG.simulations
    path = str(tmp_path / "four.npz")
    four.save(path)
    back = tsearch.MCTSSearch(search_cfg(), mcts_cfg=CFG, device="cpu")
    back.load(path)
    assert back.best().fitness == b4.fitness
