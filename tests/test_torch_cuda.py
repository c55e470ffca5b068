"""namazu_tpu_torch on the card: the pair-distance kernel (B1) and the
single-archive kernel (B2) against their plain versions, the wrapper's
input checks, a small search that must launch B1 once per generation
and once more per surrogate re-rank, the fault and order-mode scorer on
the card against the CPU (ranks and drop counts exactly), and an MCTS
search that launches B1 once per simulation, and phases 9-10 in small (8
islands on the card launching B1 once a generation, layout independence
on the card, 8 lockstep MCTS trees with one launch and one sync a
simulation), a campaign of the ``torch_search`` policy through the
CLI (``namazu_tpu_torch_policy.py``) searching on the card, that
policy's ingest at full width timed against the port's, and the observed
sidecar's server (``namazu_tpu_torch_sidecar.py``) reporting a search
on the card to the reference's metrics. Every test
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
