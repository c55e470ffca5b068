"""namazu_tpu_torch on the card: the pair-distance kernel (B1) and the
single-archive kernel (B2) against their plain versions (the split grid
at small N and the bench's N with whole ranks masked and int32
occupancies read on the card included), rows equal bit for bit across
grids, one CUDA kernel a B1 call under torch.profiler, the plan's
shared-memory model against the library's, the wrapper's input checks, a
small search that must launch B1 once per generation
and once more per surrogate re-rank, the fault and order-mode scorer on
the card against the CPU (ranks and drop counts exactly), and an MCTS
search that launches B1 once per simulation, and phases 9-10 in small (8
islands on the card launching B1 once a generation, layout independence
on the card, 8 lockstep MCTS trees with one launch and one sync a
simulation), a campaign of the ``torch_search`` policy through the
CLI (``namazu_tpu_torch_policy.py``) searching on the card, that
policy's ingest at full width timed against the port's, and the observed
sidecar's server (``namazu_tpu_torch_sidecar.py``) reporting a search
on the card to the reference's metrics, and the driver entry's scorer
(``namazu_tpu_torch/entry.py``) launching B1 once and agreeing with
its plain version on the CPU. Every test
needs a CUDA card and skips without one; on a machine with a card run

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

(``--noconftest`` skips tests/conftest.py, which sets JAX up; these tests
import no JAX.) Tolerance: rtol 1e-3 / atol 1e-4 (f32 sums in another
order), TF32 off. Where distances cancel to 0 (duplicate rows) the f32
plain version is itself ~1.5e-4 from exact, so those cases hold the
kernels to the plain version run in float64."""

import json
import os
import socket
import sys

import numpy as np
import pytest
import torch

from namazu_tpu_torch.models.search import ScheduleSearch, SearchConfig
from namazu_tpu_torch.ops import pair_distance as pd
from namazu_tpu_torch.ops import schedule as sched
from namazu_tpu_torch.ops import trace_encoding as te
from namazu_tpu_torch.parallel import graphs as tgraphs

pytestmark = pytest.mark.cuda

RTOL, ATOL = 1e-3, 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("N,A,F,K,an,fn", [
    (33, 7, 5, 64, None, None),
    (300, 100, 7, 128, 50, 0),
    (1000, 513, 65, 256, 513, 1),
])
def test_kernel_matches_plain_version(card, N, A, F, K, an, fn):
    g = torch.Generator(device=card).manual_seed(N)
    feats, archive, failures = (torch.rand((n, K), generator=g,
                                           device=card) for n in (N, A, F))
    got = pd.min_sq_distance_pair(feats, archive, failures, an, fn)
    want = pd.min_sq_distance_pair_reference(feats, archive, failures, an,
                                             fn)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("N,A,K,valid_n", [
    (33, 7, 64, None),
    (33, 7, 64, 0),
    (300, 100, 128, 50),
    (16384, 512, 256, 300),
])
def test_single_kernel_matches_plain_version(card, N, A, K, valid_n):
    g = torch.Generator(device=card).manual_seed(N + 1)
    feats, archive = (torch.rand((n, K), generator=g, device=card)
                      for n in (N, A))
    before = pd.SINGLE_LAUNCHES
    got = pd.min_sq_distance(feats, archive, valid_n)
    want = pd.min_sq_distance_reference(feats, archive, valid_n)
    torch.cuda.synchronize()
    assert pd.SINGLE_LAUNCHES == before + 1
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def near_binary(g, n, K, card):
    return torch.sigmoid(8 * torch.randn((n, K), generator=g, device=card))


def copies(g, feats, n, jitter):
    rows = feats[torch.randint(0, feats.shape[0], (n,), generator=g,
                               device=feats.device)].clone()
    if jitter:
        rows += jitter * (2 * torch.randint(0, 2, rows.shape, generator=g,
                                            device=feats.device) - 1)
    return rows


@pytest.mark.parametrize("jitter", [0.0, 1e-3])
def test_kernels_on_duplicate_rows_match_plain_version_in_f64(card, jitter):
    """Near-binary features against archive rows copied from them (d2 = 0)
    or moved by +-1e-3, at the main path's shape."""
    g = torch.Generator(device=card).manual_seed(7 + int(jitter * 1e4))
    feats = near_binary(g, 16384, 256, card)
    archive, failures = copies(g, feats, 512, jitter), copies(g, feats, 64,
                                                              1e-3 - jitter)
    got = pd.min_sq_distance_pair(feats, archive, failures)
    want = pd.min_sq_distance_pair_reference(feats.double(),
                                             archive.double(),
                                             failures.double())
    single = pd.min_sq_distance(feats, archive)
    torch.cuda.synchronize()
    for x, y in zip(got + (single,), want + want[:1]):
        torch.testing.assert_close(x, y.float(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("N,A,F,K,an,fn", [
    (16384 + 37, 512, 1, 100, None, None),  # ragged N, K % 32 != 0, F = 1
    (4096 + 5, 200, 9, 512, 150, 9),  # one consumer warpgroup
])
def test_kernels_at_ragged_widths(card, N, A, F, K, an, fn):
    g = torch.Generator(device=card).manual_seed(K)
    feats, archive, failures = (torch.rand((n, K), generator=g,
                                           device=card) for n in (N, A, F))
    got = pd.min_sq_distance_pair(feats, archive, failures, an, fn)
    single = pd.min_sq_distance(feats, archive, an)
    want = pd.min_sq_distance_pair_reference(feats, archive, failures, an,
                                             fn)
    torch.cuda.synchronize()
    for x, y in zip(got + (single,), want + want[:1]):
        torch.testing.assert_close(x, y, rtol=RTOL, atol=ATOL)


def rand_rows(card, seed, K, *rows):
    g = torch.Generator(device=card).manual_seed(seed)
    return tuple(torch.rand((n, K), generator=g, device=card) for n in rows)


def int32(card, n):
    return torch.tensor(n, dtype=torch.int32, device=card)


@pytest.mark.parametrize("A,F", [(512, 64), (513, 65), (1, 1), (1024, 64)])
@pytest.mark.parametrize("N", [1, 63, 64, 65, 129, 256, 2048, 8192])
def test_split_grid_matches_plain_version(card, N, A, F):
    """The grid plan's split (several ranks of a cluster over the column
    tiles) at small N and the bench's N, with occupancies that mask whole
    ranks (archive_n = 1, failure_n = 0) and read from the card."""
    feats, archive, failures = rand_rows(card, N + A, 256, N, A, F)
    for an, fn in ((None, None), (1, 0), (int32(card, min(300, A)),
                                          int32(card, min(17, F)))):
        got = pd.min_sq_distance_pair(feats, archive, failures, an, fn)
        want = pd.min_sq_distance_pair_reference(feats, archive, failures,
                                                 an, fn)
        single = pd.min_sq_distance(feats, archive, an)
        torch.cuda.synchronize()
        for x, y in zip(got + (single,), want + want[:1]):
            torch.testing.assert_close(x, y, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("occ", [(None, None), (300, 17)])
def test_rows_agree_bitwise_across_grids(card, occ):
    """Rows [:64] alone (a split grid) and inside the main shape's launch
    (unsplit): each tile's minima are computed alike and min is exact."""
    feats, archive, failures = rand_rows(card, 12, 256, 16384, 512, 64)
    assert pd.card_plan(card, 64, 512, 64, 256).split > 1
    assert pd.card_plan(card, 16384, 512, 64, 256).split == 1
    full = pd.min_sq_distance_pair(feats, archive, failures, *occ)
    part = pd.min_sq_distance_pair(feats[:64], archive, failures, *occ)
    for x, y in zip(full, part):
        assert torch.equal(x[:64], y)


@pytest.mark.parametrize("N,A", [(16384, 512), (8192, 1024), (2048, 512),
                                 (256, 512), (64, 512)])
def test_one_kernel_a_call(card, N, A):
    """A B1 call with no occupancies or int32 ones on the card launches
    the kernel and nothing else."""
    feats, archive, failures = rand_rows(card, 3, 256, N, A, 64)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for occ in ((None, None), (int32(card, 300), int32(card, 17))):
        pd.min_sq_distance_pair(feats, archive, failures, *occ)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            pd.min_sq_distance_pair(feats, archive, failures, *occ)
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        assert sum(e.count for e in kernels) == 1, [e.key for e in kernels]


def test_plan_matches_the_library(card):
    """The plan's shared-memory model gives the library's widest K, a
    cluster of the most ranks fits the card, and the plan at phase 10's
    8 trees (2048 rows) runs in one wave of the clusters the card holds."""
    widest = max(k for k in range(4, 1025, 4)
                 if pd._smem_bytes(-(-k // pd.BK), 1) <= pd.SMEM_LIMIT)
    assert pd._kernels()[3] == widest
    assert pd.max_active_clusters(256, 2, pd.MAX_SPLIT) >= 1
    plan = pd.card_plan(card, 2048, 512, 64, 256)
    assert plan.waves == 1 and plan.row_tiles <= pd.max_active_clusters(
        256, plan.consumers, plan.split)


def test_kernels_on_the_search_s_own_feature_rows(card):
    rng = np.random.RandomState(2)

    def enc(n):
        return te.encode_event_stream(
            [f"h{rng.randint(40)}" for _ in range(n)],
            arrivals=np.sort(rng.rand(n)).tolist(), H=64)

    s = ScheduleSearch(SearchConfig(H=64, K=64, population=256,
                                    archive_size=32, failure_size=8),
                       device=card)
    for i in range(6):
        s.add_executed_trace(enc(200), reproduced=i == 0)
    s.add_failure_trace(enc(200))
    traces, pairs, archive, failures = s._device_inputs([enc(300),
                                                         enc(1200)])
    feats, _ = sched._genome_features(s._state.pop.delays, traces, pairs,
                                      s.cfg.weights.tau)
    feats = feats.reshape(-1, feats.shape[-1]).contiguous()
    for occ in ((None, None), (s._archive_n, s._failure_n)):
        got = pd.min_sq_distance_pair(feats, archive, failures, *occ)
        want = pd.min_sq_distance_pair_reference(feats, archive, failures,
                                                 *occ)
        torch.cuda.synchronize()
        for x, y in zip(got, want):
            torch.testing.assert_close(x, y, rtol=RTOL, atol=ATOL)


def test_wrapper_refuses_what_the_kernel_does_not_take(card):
    feats = torch.rand((16, 32), device=card)
    rows = torch.rand((8, 32), device=card)
    with pytest.raises(ValueError, match="float32"):
        pd.min_sq_distance_pair(feats.double(), rows.double(), rows.double())
    with pytest.raises(ValueError, match="contiguous"):
        pd.min_sq_distance_pair(feats, rows.t().contiguous().t(), rows)
    with pytest.raises(ValueError, match="multiple of 4"):
        pd.min_sq_distance_pair(feats[:, :30].contiguous(),
                                rows[:, :30].contiguous(),
                                rows[:, :30].contiguous())
    wide = torch.rand((16, 644), device=card)
    with pytest.raises(ValueError, match="exceeds 640"):
        pd.min_sq_distance(wide, wide[:8].contiguous())


def test_small_search_launches_once_per_generation(card):
    rng = np.random.RandomState(0)

    def enc(n):
        return te.encode_event_stream(
            [f"h{rng.randint(40)}" for _ in range(n)],
            arrivals=np.sort(rng.rand(n)).tolist(), H=64)

    s = ScheduleSearch(SearchConfig(H=64, K=64, population=256,
                                    archive_size=32, failure_size=8,
                                    fused_chunk=4), device=card)
    for _ in range(5):
        s.add_executed_trace(enc(200))
    s.add_failure_trace(enc(200))
    before = pd.LAUNCHES
    best = s.run([enc(300), enc(1200)], generations=10)
    assert pd.LAUNCHES - before == 10
    assert np.isfinite(best.fitness)
    # again: the chunks of 4 now replay their captured graph, whose
    # replays count the B1 launch of each generation
    replays = s.graph_replays
    s.run([enc(300), enc(1200)], generations=10)
    assert pd.LAUNCHES - before == 20 and s.graph_replays >= replays + 2


def test_small_search_with_surrogate_launches_once_more(card):
    rng = np.random.RandomState(1)

    def enc(n):
        return te.encode_event_stream(
            [f"h{rng.randint(40)}" for _ in range(n)],
            arrivals=np.sort(rng.rand(n)).tolist(), H=64)

    s = ScheduleSearch(SearchConfig(H=64, K=64, population=256,
                                    archive_size=32, failure_size=8,
                                    fused_chunk=4, surrogate_topk=16),
                       device=card)
    for i in range(8):
        s.add_executed_trace(enc(200), reproduced=i % 2 == 0)
    s.add_failure_trace(enc(200))
    before = pd.LAUNCHES
    best = s.run([enc(300), enc(1200)], generations=10)
    assert pd.LAUNCHES - before == 11
    assert s._surrogate is not None and np.isfinite(best.fitness)


GRAPH_MODES = ("delay", "order", "faults", "islands")


def graph_search(card, mode, fused=True, seed=0, **over):
    """A small search of each kind whose chunks replay as CUDA graphs
    (delay mode, order mode, a fault half, 8 islands on the card) and its
    reference traces; the same ``seed`` builds the same search, ``over``
    sets other fields of its ``SearchConfig``."""
    from namazu_tpu_torch.models.ga import GAConfig
    from namazu_tpu_torch.models.search import make_score_weights
    from namazu_tpu_torch.parallel.mesh import make_island_mesh

    rng = np.random.RandomState(seed)

    def enc(n):
        return te.encode_event_stream(
            [f"h{rng.randint(40)}" for _ in range(n)],
            arrivals=np.sort(rng.rand(n) * 0.2).tolist(), H=64)

    cfg = SearchConfig(
        H=64, K=64, population=512 if mode == "islands" else 256,
        archive_size=32, failure_size=8, fused=fused, fused_chunk=16,
        seed=seed, ga=GAConfig(max_fault=0.1 if mode == "faults" else 0.0),
        weights=make_score_weights("reorder" if mode == "order"
                                   else "delay"), **over)
    s = ScheduleSearch(cfg, device=card, mesh=(
        make_island_mesh(8, device=card) if mode == "islands" else None))
    for i in range(5):
        s.add_executed_trace(enc(200), reproduced=i == 2)
    s.add_failure_trace(enc(200))
    return s, [enc(300), enc(1200 if mode == "delay" else 400)]


def assert_same_search(a, b):
    for x, y in zip(a._state, b._state):
        if torch.is_tensor(x):
            assert torch.equal(x, y)
        elif isinstance(x, int):
            assert x == y
        else:
            assert all(torch.equal(u, v) for u, v in zip(x, y))
    assert a.last_fit_curve == b.last_fit_curve
    assert a.generations_run == b.generations_run


@pytest.mark.parametrize("mode", GRAPH_MODES)
def test_replayed_chunks_equal_the_stepwise_search(card, mode):
    """Runs of 40 generations (chunks of 16, 16 and 8: two graphs), three
    times: the chunks run eagerly (a key the card has not run), are
    captured, then replay, and the populations, best-so-far and fitness
    curves equal the stepwise search's bit for bit throughout, with one
    B1 launch counted a generation."""
    graphed, refs = graph_search(card, mode)
    stepwise, _ = graph_search(card, mode, fused=False)
    before = pd.LAUNCHES
    for _ in range(3):
        a = graphed.run(refs, generations=40)
        launched = pd.LAUNCHES
        b = stepwise.run(refs, generations=40)
        assert a.fitness == b.fitness and np.array_equal(a.delays, b.delays)
        assert_same_search(graphed, stepwise)
        assert len(graphed.last_fit_curve) == 40
    assert launched - before == 40 + 40 + 40 + 40 + 40  # the last run's own
    assert graphed.graph_captures == 2 and graphed.graph_replays >= 5
    assert graphed.graph_evictions == 0 and not graphed._graphs.broken
    assert stepwise._graphs.captures == 0  # the stepwise loop never replays


def test_a_failure_in_a_replayed_chunk_keeps_the_last_run(card,
                                                          monkeypatch):
    """A run that fails after its second chunk's graph was replayed leaves
    the state the last completed run left, in memory no replay writes;
    the next run gives what a search that never failed gives."""
    failing, refs = graph_search(card, "delay")
    clean, _ = graph_search(card, "delay")
    for _ in range(2):
        for s in (failing, clean):
            s.run(refs, generations=32)
    state, best, gens = failing._state, failing.best(), failing.generations_run
    saved = [x.clone() for x in (*state.pop, state.best_fitness,
                                 state.best_delays)]
    real, calls = tgraphs.ChunkGraphs._replay, []

    def replay_then_fail(*a, **k):
        out = real(*a, **k)
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("the card went away")
        return out

    monkeypatch.setattr(tgraphs.ChunkGraphs, "_replay", replay_then_fail)
    with pytest.raises(RuntimeError, match="the card went away"):
        failing.run(refs, generations=32)
    monkeypatch.setattr(tgraphs.ChunkGraphs, "_replay", real)
    torch.cuda.synchronize()
    assert failing._state is state and failing.generations_run == gens
    assert all(torch.equal(x, y) for x, y in zip(
        saved, (*state.pop, state.best_fitness, state.best_delays)))
    after = failing.best()
    assert after.fitness == best.fitness
    assert np.array_equal(after.delays, best.delays)
    a, b = failing.run(refs, generations=32), clean.run(refs, generations=32)
    assert a.fitness == b.fitness and np.array_equal(a.delays, b.delays)
    assert_same_search(failing, clean)
    assert failing.graph_replays >= 2 + 2 + 2


def test_a_capture_beside_seven_evolving_searches(card):
    """8 searches on 8 threads: the 8th captures its graphs while the
    other 7 replay theirs and read results back (``.cpu()``, event and
    stream waits); each ends equal to its twin run alone."""
    import threading

    built = [graph_search(card, "delay", seed=k) for k in range(8)]
    twins = [graph_search(card, "delay", seed=k) for k in range(8)]
    for s, refs in built[:7]:
        s.run(refs, generations=32)  # captured before the threads start
    start, errors = threading.Barrier(8), []

    def work(k):
        s, refs = built[k]
        try:
            start.wait()
            for _ in range(3):
                s.run(refs, generations=32)
                s._state.pop.delays[:2].cpu()
        except Exception as e:  # noqa: BLE001 (reported below)
            errors.append(e)

    threads = [threading.Thread(target=work, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not any(t.is_alive() for t in threads) and not errors
    assert built[7][0].graph_captures >= 1
    assert not any(s._graphs.broken for s, _ in built)
    for k, ((s, _), (twin, refs)) in enumerate(zip(built, twins)):
        for _ in range(3 + (k < 7)):
            twin.run(refs, generations=32)
        assert_same_search(s, twin)
    # searches that are gone leave their graphs to the next visit
    import gc

    dev = twins[0][0]._graphs._dev
    gone = {s._graphs._token for s, _ in built}
    built.clear()
    del s
    gc.collect()
    twins[0][0].run(twins[0][1], generations=32)
    assert not gone & {token for token, _ in dev.graphs}


def test_captures_and_releases_beside_replays_do_not_hang(card):
    """8 searches on 8 threads under a graph budget that holds 2 of their
    graphs: every run captures, releases other searches' graphs and
    replays beside the others' captures, replays and reads, for many
    rounds. Nothing hangs (a stack dump ends the process after 5 minutes),
    nothing breaks, and each search ends equal to its twin run alone."""
    import faulthandler
    import threading

    built = [graph_search(card, "delay", seed=k) for k in range(8)]
    twins = [graph_search(card, "delay", seed=k) for k in range(8)]
    for s, refs in built:
        s.run(refs, generations=32)  # the device's first run of the key
    dev = built[0][0]._graphs._dev
    built[0][0].run(built[0][1], generations=32)
    one = max(g.bytes for (t, _), g in dev.graphs.items()
              if t == built[0][0]._graphs._token)
    old, dev.budget = dev.budget, dev.pool_bytes + int(2.5 * one)
    start, errors, rounds = threading.Barrier(8), [], 12

    def work(k):
        s, refs = built[k]
        try:
            start.wait()
            for _ in range(rounds):
                s.run(refs, generations=32)
                s._state.pop.delays[:2].cpu()
        except Exception as e:  # noqa: BLE001 (reported below)
            errors.append(e)

    faulthandler.dump_traceback_later(300, exit=True)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        faulthandler.cancel_dump_traceback_later()
        dev.budget = old
    assert not errors
    assert not any(s._graphs.broken for s, _ in built)
    assert sum(s.graph_evictions for s, _ in built) >= 16
    assert sum(s.graph_captures for s, _ in built) >= 8 + 8
    for k, ((s, _), (twin, refs)) in enumerate(zip(built, twins)):
        for _ in range(1 + rounds + (k == 0)):
            twin.run(refs, generations=32)
        assert_same_search(s, twin)


def test_a_new_novelty_scale_is_no_new_graph(card):
    """With ``min_failure_signatures`` set, the novelty weight's scale
    falls with every new failure signature (1, 1/2, 1/3, then the floor):
    the graphs read it as an input, so one graph a chunk length serves
    every run, bit for bit equal to the stepwise search."""
    over = dict(min_failure_signatures=1, novelty_floor=0.25)
    graphed, refs = graph_search(card, "delay", **over)
    stepwise, _ = graph_search(card, "delay", fused=False, **over)
    rng = np.random.RandomState(7)
    scales = []
    for r in range(5):
        fail = te.encode_event_stream(
            [f"h{rng.randint(40)}" for _ in range(200)],
            arrivals=np.sort(rng.rand(200) * 0.2).tolist(), H=64)
        for s in (graphed, stepwise):
            if r:
                s.add_failure_trace(fail)
            s.run(refs, generations=40)
        scales.append(graphed.novelty_scale())
        assert_same_search(graphed, stepwise)
    assert scales == [1.0, 0.5, 1 / 3, 0.25, 0.25]
    assert graphed.graph_captures == 2  # chunks of 16 and of 8
    assert (graphed.graph_captures + graphed.graph_replays
            + graphed.graph_fallbacks) == 5 * 3
    assert graphed.graph_replays >= 11 and not graphed._graphs.broken


def test_chunks_replay_under_the_programs_profiler(card, tmp_path):
    """8 searches evolve on 8 threads while the main thread starts and
    stops ``torch.profiler`` (CPU and CUDA) 12 times through
    :func:`graphs.start_profiler` and :func:`graphs.stop_profiler`: the
    chunks replay under it, the last capture holds the graphs' B1 kernels,
    and every stop completes (a graph launch in flight at a plain stop
    hangs it; a stack dump ends the process after 5 minutes). Under a
    profiler started plainly, chunks run eagerly."""
    import faulthandler
    import threading
    import time

    built = [graph_search(card, "delay", seed=k) for k in range(8)]
    for s, refs in built:
        for _ in range(2):
            s.run(refs, generations=32)
    before = [(s.graph_replays, s.graph_fallbacks) for s, _ in built]
    stop, errors = threading.Event(), []

    def work(k):
        s, refs = built[k]
        try:
            while not stop.is_set():
                s.run(refs, generations=32)
                s._state.pop.delays[:2].cpu()
        except Exception as e:  # noqa: BLE001 (reported below)
            errors.append(e)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    faulthandler.dump_traceback_later(300, exit=True)
    threads = [threading.Thread(target=work, args=(k,)) for k in range(8)]
    try:
        for t in threads:
            t.start()
        for _ in range(12):
            prof = torch.profiler.profile(activities=acts)
            tgraphs.start_profiler(prof, card)
            time.sleep(0.15)
            tgraphs.stop_profiler(prof, card)
    finally:
        stop.set()
        for t in threads:
            t.join()
        faulthandler.cancel_dump_traceback_later()
    assert not errors
    assert all(s.graph_replays > r and s.graph_fallbacks == f
               for (s, _), (r, f) in zip(built, before))
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    with open(tmp_path / "trace.json") as f:
        kernels = [e.get("name", "") for e in json.load(f)["traceEvents"]
                   if e.get("cat") == "kernel"]
    assert any("min_sq_kernel" in k for k in kernels)
    s, refs = built[0]
    replays, fallbacks = s.graph_replays, s.graph_fallbacks
    with torch.profiler.profile(activities=acts):
        s.run(refs, generations=32)
    assert (s.graph_replays, s.graph_fallbacks) == (replays, fallbacks + 2)


def test_a_failed_capture_runs_eagerly_from_then_on(card, monkeypatch,
                                                    caplog):
    """A host sync inside the island step breaks its capture: the search
    warns once, runs every later chunk eagerly, still equals the
    stepwise search, and the card's default generator draws again."""
    import gc
    import logging

    from namazu_tpu_torch.parallel import islands as tisl

    real = tisl.global_best

    def reads_back(cands, mesh):
        float(cands[0][0])  # a host read: a sync, refused in a capture
        return real(cands, mesh)

    monkeypatch.setattr(tisl, "global_best", reads_back)
    graphed, refs = graph_search(card, "delay")
    stepwise, _ = graph_search(card, "delay", fused=False)
    with caplog.at_level(logging.WARNING, "namazu_tpu_torch.graphs"):
        for _ in range(2):
            graphed.run(refs, generations=32)
            stepwise.run(refs, generations=32)
            assert_same_search(graphed, stepwise)
    assert graphed._graphs.broken and graphed.graph_captures == 0
    assert graphed.graph_fallbacks == 4 and graphed.graph_replays == 0
    assert sum("capture" in r.getMessage() for r in caplog.records) == 1
    torch.rand(4, device=card).sum().item()
    del graphed
    gc.collect()
    torch.cuda.synchronize()


def tied_scoring_case(seed=0, P=64, H=32, K=32, T=3, L=600):
    """Priorities piled at 0 and max, repeated arrivals, a ragged mask, a
    faultable flag and a fault half; CPU tensors."""
    rng = np.random.RandomState(seed)
    hint = torch.from_numpy(rng.randint(0, H, (T, L))).long()
    arr = np.sort(rng.rand(T, L).astype(np.float32) * 0.3, axis=1)
    arr[:, 1::2] = arr[:, ::2][:, : arr[:, 1::2].shape[1]]
    mask = np.zeros((T, L), bool)
    for t in range(T):
        mask[t, : L - 31 * t] = True
    prio = (rng.rand(P, H) * 0.05).astype(np.float32)
    prio[rng.rand(P, H) < 0.3] = 0.0
    prio[rng.rand(P, H) < 0.2] = np.float32(0.05)
    trace = sched.TraceArrays(hint, torch.from_numpy(arr),
                              torch.from_numpy(mask),
                              torch.from_numpy(rng.rand(T, L) > 0.3))
    return (torch.from_numpy(prio),
            torch.from_numpy((rng.rand(P, H) * 0.3).astype(np.float32)),
            torch.from_numpy(te.fault_coin(seed, H)), trace,
            torch.from_numpy(te.sample_pairs(K, H, seed)))


def to(x, dev):
    return type(x)(*(None if v is None else v.to(dev) for v in x)) \
        if isinstance(x, tuple) else x.to(dev)


def test_order_ranks_and_drops_on_the_card_equal_the_cpu(card):
    prio, faults, coin, trace, _ = tied_scoring_case()
    for window in (0.0, 0.05):
        got = sched.order_ranks(prio.to(card), to(trace, card), window)
        want = sched.order_ranks(prio, trace, window)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
    got = sched.drop_mask(faults.to(card), coin.to(card), to(trace, card))
    assert torch.equal(got.cpu(), sched.drop_mask(faults, coin, trace))


@pytest.mark.parametrize("order_mode", [False, True])
def test_fault_and_order_features_on_the_card_match_the_cpu(card,
                                                            order_mode):
    prio, faults, coin, trace, pairs = tied_scoring_case(seed=1)
    args = (0.001, order_mode, 0.002, 0.05)
    got, gn = sched._genome_features(prio.to(card), to(trace, card),
                                     pairs.to(card), *args,
                                     faults=faults.to(card),
                                     coin=coin.to(card))
    want, wn = sched._genome_features(prio, trace, pairs, *args,
                                      faults=faults, coin=coin)
    torch.testing.assert_close(got.cpu(), want, rtol=RTOL, atol=ATOL)
    assert torch.equal(gn.cpu(), wn)


def test_mcts_search_launches_once_per_simulation(card):
    from namazu_tpu_torch.models.mcts import MCTSConfig, mcts_search

    _, _, _, trace, pairs = tied_scoring_case(seed=2)
    cfg = MCTSConfig(tree_depth=6, n_levels=4, simulations=24, rollouts=16,
                     max_delay=0.05)
    archive = torch.rand((16, 32), device=card)
    failures = torch.rand((4, 32), device=card)
    pd.LAUNCHES = 0
    res = mcts_search(3, to(trace, card), pairs.to(card), archive,
                      failures, np.arange(6), 32, cfg)
    torch.cuda.synchronize()
    assert pd.LAUNCHES == cfg.simulations
    assert res.tree_visits[0] == cfg.simulations
    assert np.isfinite(float(res.best_fitness))


def island_case(card, P=512, H=64):
    rng = np.random.RandomState(3)

    def enc(n):
        return te.encode_event_stream(
            [f"h{rng.randint(40)}" for _ in range(n)],
            arrivals=np.sort(rng.rand(n)).tolist(), H=H)

    from namazu_tpu_torch.parallel.mesh import make_island_mesh

    s = ScheduleSearch(SearchConfig(H=H, K=64, population=P,
                                    archive_size=32, failure_size=8,
                                    fused_chunk=4, migrate_k=4),
                       mesh=make_island_mesh(8, device=card))
    for _ in range(5):
        s.add_executed_trace(enc(200))
    s.add_failure_trace(enc(200))
    return s, [enc(300), enc(1200)]


def test_eight_islands_on_the_card_launch_once_per_generation(card):
    """Phase 9 in small: 8 islands in one shard launch B1 once a
    generation, and 2 shards of 4 on the card give the same populations
    as 1 shard of 8, bit for bit."""
    from namazu_tpu_torch.parallel import islands as tisl

    s, refs = island_case(card)
    before = pd.LAUNCHES
    best = s.run(refs, generations=6)
    assert pd.LAUNCHES - before == 6 and np.isfinite(best.fitness)
    traces, pairs, archive, failures = s._device_inputs(refs)
    two = s.mesh.reshard(4)
    args = (s._seed, traces, pairs, archive, failures, s.cfg.ga,
            s.cfg.weights)
    before = pd.LAUNCHES
    a, ha = tisl.fused_step(s._state, 5, *args, mesh=s.mesh, rings=s._rings)
    b, hb = tisl.fused_step(
        s._state._replace(pop=tisl.shard_population(s._state.pop, two)), 5,
        *args, mesh=two, rings=s._rings)
    assert pd.LAUNCHES - before == 5 + 2 * 5
    assert torch.equal(a.pop.delays,
                       tisl.local_population(b.pop, two).delays)
    assert torch.equal(ha, hb)


def test_eight_trees_on_the_card_share_a_launch_and_a_sync(card):
    """Phase 10 in small: 8 lockstep trees launch B1 once a simulation
    and synchronise once a simulation."""
    import warnings

    from namazu_tpu_torch.models.mcts import MCTSConfig, mcts_search_trees

    _, _, _, trace, pairs = tied_scoring_case(seed=4)
    cfg = MCTSConfig(tree_depth=6, n_levels=4, simulations=12, rollouts=16,
                     max_delay=0.05)
    archive = torch.rand((16, 32), device=card)
    failures = torch.rand((4, 32), device=card)
    trace, pairs = to(trace, card), pairs.to(card)
    torch.cuda.synchronize()
    pd.LAUNCHES = 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = mcts_search_trees(list(range(8)), trace, pairs, archive,
                                    failures, np.arange(6), 32, cfg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("called a synchronizing CUDA operation" in str(w.message)
                for w in caught)
    assert pd.LAUNCHES == cfg.simulations
    assert syncs == cfg.simulations
    assert len(res) == 8 and all(r.tree_visits[0] == cfg.simulations
                                 for r in res)


# -- the torch_search policy's campaign ------------------------------------

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEND = """
import sys
from namazu_tpu.inspector.transceiver import new_transceiver
from namazu_tpu.signal import PacketEvent

ts = {e: new_transceiver(sys.argv[1], e) for e in "abc"}
for t in ts.values():
    t.start()
for i in range(24):
    e = "abc"[i % 3]
    ev = PacketEvent.create(e, e, "peer", hint=f"{e}:{i % 4}")
    ts[e].send_event(ev).get(timeout=30)
for t in ts.values():
    t.shutdown()
"""
#: tests/test_tpu_policy.py's sizes
POLICY_PARAMS = {"max_interval": 30, "generations": 6, "population": 128,
                 "hint_buckets": 32, "trace_length": 64,
                 "feature_pairs": 32, "seed": 11,
                 "checkpoint": "search.npz"}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def campaign(tmp_path, platform: str) -> None:
    """``init``, two runs recorded under ``random`` (24 packet events
    each, sent through the REST wire by the run script), then two
    ``run``s with ``explore_policy = "torch_search"`` loaded through
    ``policy_plugins`` on ``platform``: the first evolves and
    checkpoints, the second installs that checkpoint's schedule before
    its own search. Imports no JAX."""
    from namazu_tpu.cli import cli_main
    from namazu_tpu.storage import load_storage

    port = _free_port()
    materials = tmp_path / "materials"
    materials.mkdir()
    (materials / "send.py").write_text(SEND)
    (materials / "run.sh").write_text(
        f"#!/bin/sh\nexport PYTHONPATH=\"{REPO}\"\n"
        f"{sys.executable} \"$NMZ_MATERIALS_DIR/send.py\" "
        f"http://127.0.0.1:{port} && touch \"$NMZ_WORKING_DIR/ok\"\n")
    (materials / "validate.sh").write_text(
        "#!/bin/sh\ntest -f \"$NMZ_WORKING_DIR/ok\"\n")
    head = (f"rest_port = {port}\n"
            'run = "sh $NMZ_MATERIALS_DIR/run.sh"\n'
            'validate = "sh $NMZ_MATERIALS_DIR/validate.sh"\n')
    config = tmp_path / "config.toml"
    config.write_text(head + 'explore_policy = "random"\n'
                      "[explore_policy_param]\nmax_interval = 5\n")
    storage = tmp_path / "storage"
    assert cli_main(["init", str(config), str(materials), str(storage)]) == 0
    for _ in range(2):
        assert cli_main(["run", str(storage)]) == 0
    knobs = dict(POLICY_PARAMS, platform=platform)
    (storage / "config.toml").write_text(
        head + 'explore_policy = "torch_search"\n'
        'policy_plugins = ["namazu_tpu_torch_policy"]\n'
        "[explore_policy_param]\n"
        + "".join(f"{k} = {json.dumps(v)}\n" for k, v in knobs.items()))
    for _ in range(2):
        assert cli_main(["run", str(storage)]) == 0
    st = load_storage(str(storage))
    assert st.nr_stored_histories() == 4
    assert all(st.is_successful(i) and len(st.get_stored_history(i)) == 24
               for i in range(4))
    with np.load(storage / "search.npz") as z:
        assert int(z["generations_run"]) == 12
    # one process ran every run: keep each run's own tagged lines
    logs = ["".join(line for line in open(storage / f"{i:08x}" / "nmz.log")
                    if f"[{i:08x}]" in line) for i in (2, 3)]
    assert "installed searched schedule" in logs[0]
    assert "installed checkpointed schedule" not in logs[0]
    assert logs[1].index("installed checkpointed schedule") < \
        logs[1].index("installed searched schedule")


def test_torch_search_campaign_searches_on_the_card(card, tmp_path):
    """The campaign with ``platform`` unset: both searches run on the
    card, B1 launching once a generation (6 each; two successful runs
    leave the surrogate untrained, so no re-rank launch)."""
    before = pd.LAUNCHES
    campaign(tmp_path, "")
    assert pd.LAUNCHES - before == 2 * POLICY_PARAMS["generations"]


def test_policy_ingest_at_full_width_on_the_card(card, tmp_path):
    """The ``torch_search`` policy's own ingest (the reference's storage
    reader, the shim's adapter to ``ActionRecord``s, the port's ingest)
    over chip_smoke.py's phase-5 history at full width (48 runs of 2000
    events, the policy's defaults: population 4096, H = K = 256), in
    turns with the port's ingest over the port's reader of the same
    directory: both return the same references and fill the archives
    alike. Prints each ingest's seconds (run with ``-s``)."""
    import time

    import chip_smoke
    from namazu_tpu.policy import create_policy
    from namazu_tpu.policy.plugins import load_policy_plugins
    from namazu_tpu.storage import load_storage
    from namazu_tpu.utils.config import Config
    from namazu_tpu_torch.history import load_storage as port_storage
    from namazu_tpu_torch.models.ingest import ingest_history
    from namazu_tpu_torch.policy.tpu import ingest_params

    history = chip_smoke.write_history(str(tmp_path / "history"))
    load_policy_plugins(Config({"policy_plugins":
                                ["namazu_tpu_torch_policy"]}))
    pol = create_policy("torch_search")
    pol.load_config(Config({"explore_policy_param": {}}))
    pol.set_history_storage(load_storage(history))
    ip = ingest_params(pol._ingest_params()._asdict())

    def port():
        search = pol._build_search()
        t0 = time.perf_counter()
        refs = ingest_history(search, port_storage(history), ip)
        return time.perf_counter() - t0, search, refs

    def policy():
        search = pol._build_search()
        t0 = time.perf_counter()
        refs = pol._ingest_history(search)
        return time.perf_counter() - t0, search, refs

    seconds, last = {"port": [], "policy": []}, {}
    for name, fn in (("port", port), ("policy", policy),
                     ("policy", policy), ("port", port)):
        secs, *last[name] = fn()
        seconds[name].append(secs)
    (ps, prefs), (qs, qrefs) = last["port"], last["policy"]
    assert len(prefs) == len(qrefs) == 4
    for x, y in zip(prefs, qrefs):
        for name in ("hint_ids", "entity_ids", "arrival", "mask",
                     "faultable"):
            assert np.array_equal(getattr(x, name), getattr(y, name))
    assert ps._archive_n == qs._archive_n > 0
    assert np.array_equal(ps.archive, qs.archive)
    assert np.array_equal(ps.failures, qs.failures)
    print(f"\ningest at full width, {torch.cuda.get_device_name(0)}: "
          f"port reader {seconds['port']} s, policy (reference reader + "
          f"adapter) {seconds['policy']} s")


def test_shim_sidecar_on_the_card_reports_its_search(card, tmp_path):
    """The observed sidecar's server (``namazu_tpu_torch_sidecar.py``)
    on the card serves one search over a small history; its ``metrics``
    op then shows the search's phases and one search request, and B1
    launched once a generation (and once a re-rank)."""
    import chip_smoke
    import namazu_tpu_torch_sidecar as shim
    from namazu_tpu.obs import federation, metrics
    from namazu_tpu_torch import wire

    storage = chip_smoke.write_history(str(tmp_path / "h"), runs=12,
                                       failures=4, events=200)
    req = {"op": "search", "key": storage, "storage": storage,
           "search_params": dict(chip_smoke.POLICY_SEARCH_PARAMS, H=32,
                                 K=32, population=128, fused_chunk=3),
           "ingest_params": dict(chip_smoke.POLICY_INGEST_PARAMS, H=32),
           "generations": 6, "checkpoint": ""}
    metrics.configure(True)
    metrics.reset()
    federation.reset()
    srv = shim.build_server("127.0.0.1", 0, "cuda")
    srv.start()
    before = pd.LAUNCHES
    try:
        addr = f"127.0.0.1:{srv.port}"
        resp = wire.request(addr, req)
        launches = pd.LAUNCHES - before
        fams = wire.request(addr, {"op": "metrics"})["metrics"]["metrics"]
        search = srv.service.search_for(storage)
    finally:
        srv.shutdown()
        federation.reset()
        metrics.reset()
    assert resp["ok"] is True and resp["generations_run"] == 6
    assert search.device.type == "cuda"
    assert launches == 6 + (search._surrogate is not None)
    assert chip_smoke.sample(fams, "nmz_sidecar_requests_total", ok="true",
                             op="search") == 1
    phases = {p: chip_smoke.sample(fams, "nmz_search_phase_seconds",
                                   phase=p)
              for p in ("encode", "evolve", "host_io", "surrogate")}
    assert phases == {"encode": 1, "evolve": 1, "host_io": 2,
                      "surrogate": 1}


def test_entry_on_the_card_matches_the_cpu(card):
    from namazu_tpu_torch import entry

    fn, args = entry.entry("cuda")
    assert all(a.device.type == "cuda" for a in args)
    before = pd.LAUNCHES
    got = fn(*args).cpu()
    assert pd.LAUNCHES - before == 1
    cpu_fn, cpu_args = entry.entry("cpu")
    for a, b in zip(args, cpu_args):
        assert torch.equal(a.cpu(), b)  # the same inputs on both
    want = cpu_fn(*cpu_args)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
