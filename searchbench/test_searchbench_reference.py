"""The plain reference against the port, on the CPU at tiny sizes."""

import numpy as np
import pytest
import torch

from namazu_tpu_torch.ops import schedule as sched
from searchbench import tiny
from searchbench.reference import score


def _inputs(seed, H=32, K=24, L=300, T=3, G=5):
    rng = np.random.default_rng(seed)
    refs = []
    for _ in range(T):
        b = rng.integers(0, H, L)
        a = np.cumsum(rng.exponential(1e-3, L)).astype(np.float32)
        refs.append((b, a))
    pairs = score.sample_pairs(K, H, seed)
    archive = rng.random((40, K)).astype(np.float32)
    failures = rng.random((8, K)).astype(np.float32)
    tables = (rng.random((G, H)) * 0.1).astype(np.float32)
    return refs, pairs, archive, failures, tables


@pytest.mark.parametrize("mode", ["delay", "reorder"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scorer_matches_the_port(mode, seed):
    H = 32
    refs, pairs, archive, failures, tables = _inputs(seed, H)
    sp = {"release_mode": mode}
    w = score.weights_of(sp)
    want = score.fitness(tables, refs, pairs, archive, failures, w, H)
    from namazu_tpu_torch.models.search import make_score_weights

    weights = make_score_weights(release_mode=mode)
    traces = sched.TraceArrays(
        torch.from_numpy(np.stack([b for b, _ in refs])),
        torch.from_numpy(np.stack([a for _, a in refs])),
        torch.ones((len(refs), refs[0][0].shape[0]), dtype=torch.bool))
    got, _ = sched.score_population_multi(
        torch.from_numpy(tables), traces, torch.from_numpy(pairs),
        torch.from_numpy(archive), torch.from_numpy(failures), weights)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("base", ["zk2212-delay", "zk2212-reorder"])
def test_answers_match_the_reference(tmp_path, base):
    out = tiny.tiny_run(tiny.tiny_checkout(tmp_path, base))
    assert out["judged"]["judged"] >= 6
    assert out["judged"]["bad"] == 0
    assert out["checks"]["fitness_gap"]["value"] < 1e-4
    assert out["judged"]["searched"] >= 1
    assert out["checks"]["missed_gap"]["value"] < 1e-4
    assert out["checks"]["unchanged_share"]["value"] < 0.1
    assert out["result"]["correct"] is True


def test_seed_rows():
    from searchbench.reference.campaign import seed_rows

    rows = set(seed_rows(4096))
    for n in range(1, 17):
        assert {i * (4096 // n) for i in range(n)} <= rows
    assert len(rows) < 120


def test_the_search_check_reads_the_populations():
    from searchbench.reference.campaign import (Campaign, check_search,
                                                seed_rows)
    from searchbench.reference.encode import Reader

    H, K, P = 32, 24, 64
    rng = np.random.default_rng(5)
    camp = Campaign(Reader(H), {"H": H, "K": K}, {})
    pairs = score.sample_pairs(K, H, 0)
    refs = [(rng.integers(0, H, 50),
             np.cumsum(rng.random(50) * 0.1).astype(np.float32))]
    from searchbench.reference.campaign import State

    state = State(pairs, rng.random((8, K)), rng.random((4, K)), refs,
                  False, 1)
    start = (rng.random((P, H)) * 0.1).astype(np.float32)
    fit = camp.fitness(state, start)
    fit[seed_rows(P)] = -np.inf
    order = np.argsort(-fit)
    end = (rng.random((P, H)) * 0.1).astype(np.float32)
    end[:4] = start[order[:4]]
    curve = [float(fit.max())] * 3
    c = check_search(camp, state, start, end, curve)
    assert c.best_gap < 1e-5 and c.missed < 1e-5
    assert c.unchanged == 4 / P
    c = check_search(camp, state, start, end, [float(fit[order[1]])] * 3)
    assert c.missed > 0


def test_retiring_campaigns_match_the_reference(tmp_path):
    out = tiny.tiny_run(tiny.tiny_checkout(tmp_path, traffic=tiny.TINY_CI))
    assert out["judged"]["judged"] >= 8
    assert out["result"]["correct"] is True
