"""The port's search sidecar (namazu_tpu_torch/sidecar.py, wire.py) on the
CPU: the framed wire with keep-alive, the reference's response shapes,
every knob of the policy's request served (causality guidance, the
device trace, the failure pool, the knowledge service it hosts itself),
checkpoints shared with the reference's in-process search, and the
reference ``tpu_search`` policy installing the port's table through
``sidecar = "host:port"``, for the GA in delay mode, with the fault half
(``max_fault > 0``), in order mode (``release_mode = "reorder"``), for
the MCTS backend and with each of those knobs.

Sizes are small (P=64, H=K=32, runs of 240 events). Tables and fitness
crossing the wire are compared exactly (JSON carries f32 values as
doubles, and the policy installs what it reads)."""

import socket
import struct
import subprocess
import sys
import itertools
import threading
import time

import numpy as np
import pytest
import torch

from namazu_tpu.models.search import ScheduleSearch as JSearch
from namazu_tpu.sidecar import build_search_from_params as jbuild
from namazu_tpu.storage import load_storage as jload
from namazu_tpu.utils.config import Config
from namazu_tpu_torch import wire
from namazu_tpu_torch.sidecar import SidecarServer, request
from test_torch_ingest import SpanSink, write_storage

SEARCH_PARAMS = {
    "H": 32, "K": 32, "population": 64, "migrate_k": 2, "seed": 5,
    "max_interval": 0.05, "fused_chunk": 3,
}
INGEST_PARAMS = {"H": 32, "max_interval": 0.05}
CKPT_KEYS = {"backend", "hint_space", "pairs", "archive", "archive_labels",
             "archive_n", "failures", "failure_n", "failure_digests", "key",
             "generations_run", "pop_delays", "pop_faults", "gen",
             "best_fitness", "best_delays", "best_faults"}


@pytest.fixture
def history(tmp_path):
    return write_storage(tmp_path / "st", quarantine=False)


@pytest.fixture
def server():
    s = SidecarServer(port=0, device="cpu")
    s.start()
    yield s
    s.shutdown()


def addr(server):
    return f"127.0.0.1:{server.port}"


def search_req(history, ckpt="", **params):
    return {
        "op": "search", "key": history.dir, "storage": history.dir,
        "search_params": dict(SEARCH_PARAMS, **params),
        "ingest_params": INGEST_PARAMS, "generations": 4,
        "checkpoint": ckpt,
    }


def test_ping(server):
    assert request(addr(server), {"op": "ping"}) == {"ok": True,
                                                     "searches": 0}


def test_keep_alive_connection_serves_two_searches(server, history,
                                                   tmp_path):
    ckpt = str(tmp_path / "side.npz")
    with socket.create_connection(("127.0.0.1", server.port)) as s:
        wire.write_frame(s, {"op": "ping"})
        assert wire.read_frame(s)["ok"]
        wire.write_frame(s, search_req(history, ckpt))
        r1 = wire.read_frame(s)
        wire.write_frame(s, search_req(history, ckpt))
        r2 = wire.read_frame(s)
    assert set(r1) == {"ok", "fitness", "delays", "faults",
                       "generations_run"}
    assert r1["ok"] and r2["ok"]
    assert (r1["generations_run"], r2["generations_run"]) == (4, 8)
    assert len(r2["delays"]) == len(r2["faults"]) == 32
    assert np.isfinite(r2["fitness"])
    search = server.service.search_for(history.dir)
    assert search.device == torch.device("cpu")
    # every request re-feeds the history, so the second sees 4 labeled
    # failures (2 per ingest): the surrogate trains and picks from the
    # current population, possibly below the best seen
    assert search._surrogate is not None
    table = np.asarray(r2["delays"], np.float32)
    assert any(np.array_equal(table, row)
               for row in search._state.pop.delays.numpy())
    assert r2["fitness"] <= search.best().fitness
    with np.load(ckpt) as z:
        assert CKPT_KEYS <= set(z.files)
        assert int(z["generations_run"]) == 8
    assert request(addr(server), {"op": "ping"})["searches"] == 1


@pytest.mark.parametrize("backend, ticks", [("ga", False), ("mcts", False),
                                            ("ga", True)])
def test_a_search_names_its_ingest_and_save_and_splits_its_evolve(
        history, tmp_path, monkeypatch, backend, ticks):
    """One request's phases on a recording sink, all on the thread that
    serves it: ``ingest`` with the ingest's sections inside it, then the
    search's, then ``save``; each phase spans the seconds its timing
    counts. The timings split the ingest's reads from its encoding and
    the evolve's waits on the card from the searching thread's CPU,
    each inside the section that holds it, also where the thread's CPU
    clock reads ahead of the wall (``ticks``: a second a read, as a
    clock that moves in coarse ticks may)."""
    extra = ({} if backend == "ga" else dict(
        search_backend="mcts", mcts_simulations=8, mcts_tree_depth=4,
        mcts_levels=3, mcts_rollouts=8))
    if ticks:
        ahead, cpu = itertools.count(), time.thread_time
        monkeypatch.setattr(time, "thread_time",
                            lambda: cpu() + next(ahead))
    sink = SpanSink()
    srv = SidecarServer(port=0, device="cpu", telemetry=sink)
    srv.start()
    try:
        resp = request(addr(srv), search_req(
            history, str(tmp_path / "c.npz"), **extra))
    finally:
        srv.shutdown()
    assert resp["ok"] is True
    threads = {tid for _, tid, _, _ in sink.spans}
    assert len(threads) == 1 and threading.get_ident() not in threads
    span = {}
    for phase, _, t0, t1 in sink.spans:
        assert phase not in span or phase in ("host_io", "ingest_knowledge")
        span.setdefault(phase, (t0, t1))
    ingest, save = span["ingest"], span["save"]
    for phase in ("ingest_read_encode", "ingest_archive"):
        assert ingest[0] <= span[phase][0] <= span[phase][1] <= ingest[1]
    assert span["ingest_read_encode"][1] <= span["ingest_archive"][0]
    searched = [s for p, s in span.items()
                if p not in ("save", "ingest") and not p.startswith("ingest_")]
    assert (backend == "mcts") == (not searched)
    assert all(ingest[1] <= t0 <= t1 <= save[0] for t0, t1 in searched)
    assert save[1] >= save[0] >= ingest[1]
    tm = srv.service.timings[history.dir]
    for k in ("ingest_read", "ingest_encode", "evolve_wait", "evolve_cpu"):
        assert tm[k] >= 0.0
    assert tm["ingest_read"] + tm["ingest_encode"] <= tm["ingest_read_encode"]
    assert tm["evolve_wait"] + tm["evolve_cpu"] <= tm["run"]
    assert tm["evolve_cpu"] > 0.0
    assert tm["evolve_capture"] == 0.0  # no CUDA graphs on the CPU
    for phase, key in (("ingest", "ingest"), ("save", "save"),
                       ("ingest_read_encode", "ingest_read_encode"),
                       ("ingest_archive", "ingest_archive")):
        assert span[phase][1] - span[phase][0] >= tm[key] > 0.0


def test_unknown_op_bad_storage_and_bad_frames(server):
    a = addr(server)
    assert request(a, {"op": "nope"}) == {"ok": False,
                                          "error": "unknown op 'nope'"}
    assert not request(a, {"op": "pool_pull"})["ok"]  # knowledge op
    bad = {"op": "search", "key": "k", "storage": "/nonexistent-st",
           "search_params": SEARCH_PARAMS, "ingest_params": INGEST_PARAMS,
           "generations": 1, "checkpoint": ""}
    resp = request(a, bad)
    assert not resp["ok"] and resp["error"].startswith("storage:")
    with socket.create_connection(("127.0.0.1", server.port)) as s:
        wire.write_frame(s, ["not", "an", "object"])
        assert wire.read_frame(s)["ok"] is False
        body = b"\x00\x01"
        s.sendall(struct.pack("<I", len(body) | wire.BINARY_FRAME_FLAG)
                  + body)
        resp = wire.read_frame(s)
        assert resp["ok"] is False and "binary" in resp["error"]
        s.sendall(struct.pack("<I", 3) + b"{x]")
        assert wire.read_frame(s)["ok"] is False
        wire.write_frame(s, {"op": "ping"})  # the stream stayed in sync
        assert wire.read_frame(s)["ok"] is True


def test_no_history_answer(server, tmp_path):
    from namazu_tpu.storage import new_storage

    st = new_storage("naive", str(tmp_path / "empty"))
    st.create()
    req = search_req(st)
    assert request(addr(server), req) == {"ok": True, "no_history": True,
                                          "generations_run": 0}


@pytest.mark.parametrize("where,knob", [
    ("search", "guidance"),
    ("search", "device_trace_dir"),
    ("ingest", "failure_pool"),
    ("ingest", "knowledge"),
    ("ingest", "guidance"),
])
def test_policy_knobs_are_served(history, tmp_path, where, knob):
    """Each knob alone in a request is served by a sidecar that hosts its
    own knowledge service (the knowledge address is itself); then the
    reference policy with the knob on installs the table the port
    returned."""
    from namazu_tpu_torch.knowledge import KnowledgeService

    srv = SidecarServer(port=0, device="cpu", knowledge=KnowledgeService(
        str(tmp_path / "kpool"), device="cpu"))
    srv.start()
    try:
        value = {"guidance": True,
                 "device_trace_dir": str(tmp_path / "dt"),
                 "failure_pool": str(tmp_path / "pool"),
                 "knowledge": addr(srv)}[knob]
        req = search_req(history)
        if where == "search":
            req["search_params"] = dict(req["search_params"],
                                        **{knob: value})
        else:
            req["ingest_params"] = dict(
                INGEST_PARAMS, knowledge_tenant="t", **{knob: value})
        resp = request(addr(srv), req)
        assert resp["ok"] is True and resp["generations_run"] == 4
        search = srv.service.search_for(history.dir)
        if knob == "guidance":
            assert search.guidance is not None
            assert (search.guidance.runs_observed > 0) == (where == "ingest")
        elif knob == "device_trace_dir":
            assert len(list((tmp_path / "dt" / "device_trace").iterdir())) \
                == 1
        elif knob == "failure_pool":
            assert len(list((tmp_path / "pool").glob("*.npz"))) == 2
        else:
            stats = request(addr(srv), {"op": "stats"})
            assert stats["pool_size"] == 2 and "t" in stats["tenants"]
            # nothing pooled yet to warm-start from: its own failures
            # were pushed first and are excluded from its pull; a first
            # ingest reads every run with a result from its files
            assert srv.service.ingest_counts[history.dir] == {
                "warmstart_archive": 0, "runs_read": 7, "runs_cached": 0}
        assert "ingest_read_encode" in srv.service.timings[history.dir]
        policy_knob = {knob: value if knob != "knowledge" else addr(srv)}
        run_policy(srv, history, **policy_knob)
    finally:
        srv.shutdown()


def test_several_devices_are_served_on_the_cpu(server, history):
    """devices = 4 on the CPU: four islands of 16 in one shard, and the
    reference policy installs the table the island search computed."""
    pol, port = run_policy(server, history, devices=4)
    assert port.mesh.shape == {"i": 4} and port.population == 64
    assert port._rings == (("i", 2, 1),)
    assert port.generations_run == 4


def test_more_devices_than_cards_answer_not_ok(server, history,
                                               monkeypatch):
    """A card count the machine lacks is refused with the mesh's error,
    never served by a smaller mesh or the CPU."""
    from namazu_tpu_torch.parallel import mesh as tmesh
    from namazu_tpu_torch.sidecar import SearchService

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    service = SearchService(device="cuda")
    resp = service.handle(search_req(history, devices=2))
    assert resp == {"ok": False, "error": "search_params: requested 2 "
                                          "devices, have 1"}
    assert service.search_for(history.dir) is None
    with pytest.raises(ValueError, match="requested 3 devices, have 1"):
        tmesh.make_mesh(3)


def test_checkpoints_interchange_with_reference_search(server, history,
                                                       tmp_path):
    """A port sidecar checkpoint loads into the reference's in-process
    search; the reference evolves and saves; the port's next request
    reloads the newer checkpoint and runs its generations on top."""
    from namazu_tpu.models.ingest import IngestParams, ingest_history

    ckpt = str(tmp_path / "x.npz")
    r1 = request(addr(server), search_req(history, ckpt))
    assert r1["ok"] and r1["generations_run"] == 4
    local = jbuild(SEARCH_PARAMS)
    assert isinstance(local, JSearch)
    local.load(ckpt)
    assert local.generations_run == 4
    assert np.array_equal(local.best().delays,
                          np.asarray(r1["delays"], np.float32))
    refs = ingest_history(local, jload(history.dir),
                          IngestParams(**INGEST_PARAMS))
    local.run(refs, generations=6)
    local.save(ckpt)
    r2 = request(addr(server), search_req(history, ckpt))
    assert r2["ok"] and r2["generations_run"] == 10 + 4


def test_reference_policy_installs_the_port_table(server, history):
    """tpu_search with sidecar=<the port's sidecar> installs the table the
    port computed and never builds a search of its own."""
    from namazu_tpu.policy import create_policy

    pol = create_policy("tpu_search")
    pol.load_config(Config({
        "explore_policy": "tpu_search",
        "explore_policy_param": {
            "seed": 5, "max_interval": 50, "hint_buckets": 32,
            "feature_pairs": 32, "population": 64, "generations": 4,
            "migrate_k": 2, "fused_chunk": 3,
            "sidecar": addr(server), "checkpoint": "side_pol.npz",
        },
    }))
    installs = []
    real = pol._install_tables

    def spy(delays, faults, source):
        installs.append(source)
        real(delays, faults, source)

    pol._install_tables = spy
    pol.set_history_storage(jload(history.dir))
    pol.start()
    try:
        assert pol.wait_for_search(timeout=120)
    finally:
        pol.shutdown()
    assert installs == ["sidecar"]
    assert pol._search is None  # the heavy path never ran in-process
    port = server.service.search_for(history.dir)
    assert port is not None and port.generations_run == 4
    assert np.array_equal(np.asarray(pol._delays, np.float32),
                          port.best().delays)


def run_policy(server, history, **params):
    """A reference tpu_search policy pointed at the port's sidecar runs
    one search request; returns the policy and the port's search."""
    from namazu_tpu.policy import create_policy

    pol = create_policy("tpu_search")
    pol.load_config(Config({
        "explore_policy": "tpu_search",
        "explore_policy_param": dict({
            "seed": 5, "max_interval": 50, "hint_buckets": 32,
            "feature_pairs": 32, "population": 64, "generations": 4,
            "migrate_k": 2, "fused_chunk": 3,
            "sidecar": addr(server), "checkpoint": "side_pol.npz",
        }, **params),
    }))
    installs, answers = [], []
    real, handle = pol._install_tables, server.service.handle

    def spy(delays, faults, source):
        installs.append(source)
        real(delays, faults, source)

    def answered(req):
        resp = handle(req)
        if req.get("op") == "search":
            answers.append(resp)
        return resp

    pol._install_tables = spy
    server.service.handle = answered
    pol.set_history_storage(jload(history.dir))
    pol.start()
    try:
        assert pol.wait_for_search(timeout=120)
    finally:
        pol.shutdown()
        server.service.handle = handle
    assert installs == ["sidecar"]
    assert pol._search is None
    port = server.service.search_for(history.dir)
    assert port is not None
    assert np.array_equal(np.asarray(pol._delays, np.float32),
                          np.asarray(answers[-1]["delays"], np.float32))
    if port.guidance is None:  # an unguided pick is the best seen here
        assert np.array_equal(np.asarray(pol._delays, np.float32),
                              port.best().delays)
    return pol, port


def test_policy_replays_the_port_fault_table(server, history):
    """max_fault > 0: the policy installs the port's evolved fault table,
    and its replay decision drops exactly the buckets where the coin lies
    below the table."""
    from namazu_tpu_torch.ops import trace_encoding as tte

    pol, port = run_policy(server, history, max_fault=0.3)
    assert port.cfg.ga.max_fault == 0.3 and port._coin is not None
    faults = port.best().faults
    assert faults.any() and (faults <= np.float32(0.3)).all()
    assert np.array_equal(np.asarray(pol._faults, np.float32), faults)
    coin = tte.fault_coin(5, 32)
    hints = [f"10.0.0.{i % 13}->10.0.0.{i % 11}:m{i % 5}"
             for i in range(400)]
    buckets = {tte.hint_bucket(h, 32) for h in hints}
    assert len(buckets) == 32
    want = [bool(coin[tte.hint_bucket(h, 32)]
                 < faults[tte.hint_bucket(h, 32)]) for h in hints]
    assert [pol._fault_for(h) for h in hints] == want
    assert any(want) and not all(want)


def test_policy_installs_the_port_order_mode_table(server, history):
    pol, port = run_policy(server, history, release_mode="reorder",
                           reorder_window=50, reorder_gap=2)
    w = port.cfg.weights
    assert w.order_mode and (w.order_window, w.order_gap) == (0.05, 0.002)
    assert port.generations_run == 4


def test_policy_installs_the_port_mcts_table(server, history):
    from namazu_tpu_torch.models.search import MCTSSearch

    pol, port = run_policy(server, history, search_backend="mcts",
                           mcts_simulations=8, mcts_tree_depth=4,
                           mcts_levels=3, mcts_rollouts=8)
    assert isinstance(port, MCTSSearch)
    assert port.generations_run == 8  # one search of 8 simulations
    assert np.isfinite(port.best().fitness)


def test_cuda_is_the_default_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SidecarServer(port=0)


def test_module_entry_point_parses_its_options():
    out = subprocess.run(
        [sys.executable, "-m", "namazu_tpu_torch.sidecar", "--help"],
        capture_output=True, text=True, timeout=120, check=True)
    assert "--listen" in out.stdout and "--device" in out.stdout


def test_chip_smoke_carries_the_policy_defaults(tmp_path):
    """chip_smoke.py's sidecar phase sends what a default tpu_search
    policy sends (its fingerprint-derived scenario aside), and rehearses
    on the CPU at a tiny size."""
    import chip_smoke
    from namazu_tpu.policy.tpu import TPUSearchPolicy

    pol = TPUSearchPolicy()
    assert chip_smoke.POLICY_SEARCH_PARAMS == pol._search_params()
    want = pol._ingest_params()._asdict()
    got = dict(chip_smoke.POLICY_INGEST_PARAMS)
    for k in ("knowledge_tenant", "knowledge_scenario"):
        want.pop(k), got.pop(k)
    assert got == want
    sp = dict(chip_smoke.POLICY_SEARCH_PARAMS, H=32, K=32, population=64,
              fused_chunk=3)
    ip = dict(chip_smoke.POLICY_INGEST_PARAMS, H=32)
    launches = chip_smoke.drive_sidecar_path(
        "cpu", str(tmp_path), generations=3, search_params=sp,
        ingest_params=ip, runs=12, failures=4, events=200)
    assert launches == {"min_sq_pair": 0, "min_sq": 0}


def test_chip_smoke_rehearses_the_fault_order_and_mcts_paths(tmp_path):
    """chip_smoke.py's phases 6-8 at a tiny size on the CPU: each path's
    two requests answer, re-score on the CPU to the returned fitness and
    launch no kernel."""
    import chip_smoke

    sp = dict(chip_smoke.POLICY_SEARCH_PARAMS, H=32, K=32, population=64,
              fused_chunk=3, mcts_simulations=12, mcts_tree_depth=6,
              mcts_rollouts=8)
    ip = dict(chip_smoke.POLICY_INGEST_PARAMS, H=32, order_mode_max_l=512)
    launches, numbers = chip_smoke.drive_extra_paths(
        "cpu", str(tmp_path), generations=64, search_params=sp,
        ingest_params=ip, runs=12, failures=4, events=200)
    assert sorted(launches) == ["sidecar_faults", "sidecar_mcts",
                                "sidecar_order"]
    assert all(n == {"min_sq_pair": 0, "min_sq": 0}
               for n in launches.values())
    assert numbers == {}  # device timings are taken on the card only


def test_chip_smoke_rehearses_the_island_paths(tmp_path):
    """chip_smoke.py's phases 9-10 at a tiny size on the CPU: the island
    searches with faults and in delay mode (marker, fused == stepwise and
    layout contracts included), the hybrid mesh's host-ring cadence, 8
    lockstep MCTS trees and a one-process gloo world, launching no
    kernel."""
    import chip_smoke

    sp = dict(chip_smoke.POLICY_SEARCH_PARAMS, H=32, K=32, population=128,
              fused_chunk=3, mcts_simulations=6, mcts_tree_depth=6,
              mcts_rollouts=8)
    ip = dict(chip_smoke.POLICY_INGEST_PARAMS, H=32)
    hist = dict(runs=12, failures=4, events=200)
    delay = chip_smoke.write_history(str(tmp_path / "d"), **hist)
    mixed = chip_smoke.write_history(str(tmp_path / "m"), proc_every=4,
                                     **hist)
    launches, numbers = chip_smoke.drive_island_paths(
        "cpu", delay, mixed, generations=6, search_params=sp,
        ingest_params=ip)
    assert sorted(launches) == ["hybrid", "islands_delay",
                                "islands_faults", "mcts_trees"]
    assert all(n == {"min_sq_pair": 0, "min_sq": 0}
               for n in launches.values())
    assert not torch.distributed.is_initialized()
    assert "generation" not in numbers["islands_faults"]  # card only


def test_chip_smoke_rehearses_the_knowledge_path(tmp_path):
    """chip_smoke.py's knowledge and guidance phase at a tiny size on the
    CPU: one sidecar hosting its knowledge service, two campaigns of one
    scenario with every knob on (B warm-starting from A's signatures and
    coverage, its re-rank answered by the trained shared surrogate), a
    device trace written once, launching no kernel."""
    import chip_smoke

    sp = dict(chip_smoke.POLICY_SEARCH_PARAMS, H=32, K=32, population=64,
              fused_chunk=3)
    ip = dict(chip_smoke.POLICY_INGEST_PARAMS, H=32)
    launches, numbers = chip_smoke.drive_knowledge_path(
        "cpu", str(tmp_path), generations=3, search_params=sp,
        ingest_params=ip, runs=12, failures=4, events=200)
    assert launches == {"knowledge_a": {"min_sq_pair": 0, "min_sq": 0},
                        "knowledge_b": {"min_sq_pair": 0, "min_sq": 0}}
    assert [len(numbers[c]) for c in ("knowledge_a", "knowledge_b")] \
        == [2, 2]
    assert all("ingest_knowledge" in n for n in numbers["knowledge_b"])
    assert len(list((tmp_path / "trace" / "device_trace").iterdir())) == 1


def test_chip_smoke_rehearses_the_policy_path(tmp_path):
    """chip_smoke.py's phase 12 at a tiny size on the CPU: two searches
    of the policy's search half, each on its own thread, over one
    history, the second resuming from the first's checkpoint and
    installing its best first; the sink sees the phases and calls the
    reference's search makes, the device trace holds the island step's ranges once a
    generation, ``dcn_hosts = 2`` is refused inside a one-process gloo
    world, and no kernel launches."""
    import chip_smoke

    sp = dict(chip_smoke.POLICY_SEARCH_PARAMS, H=32, K=32, population=128,
              fused_chunk=3)
    ip = dict(chip_smoke.POLICY_INGEST_PARAMS, H=32)
    storage = chip_smoke.write_history(str(tmp_path / "h"), runs=12,
                                       failures=4, events=200)
    launches, numbers = chip_smoke.drive_policy_path(
        "cpu", str(tmp_path / "p"), storage, generations=5,
        search_params=sp, ingest_params=ip)
    assert launches == {"min_sq_pair": 0, "min_sq": 0}
    assert len(numbers["calls"]) == 2
    assert {k: v[0] for k, v in numbers["device_trace"].items()} == {
        r: 5 for r in chip_smoke.NMZ_RANGES}
    assert not torch.distributed.is_initialized()


def test_chip_smoke_rehearses_the_chaos_path(tmp_path):
    """chip_smoke.py's phase 14 at a tiny size on the CPU: campaign A's
    two requests under the fault schedule answer ok and re-score to
    their fitness, every point fires, the client's counts agree with the
    fires, the restarted service serves the highest acknowledged table,
    the pool fscks clean, and no kernel launches."""
    import chip_smoke
    from namazu_tpu_torch import chaos

    sp = dict(chip_smoke.POLICY_SEARCH_PARAMS, H=32, K=32, population=64,
              fused_chunk=3)
    ip = dict(chip_smoke.POLICY_INGEST_PARAMS, H=32)
    storage = chip_smoke.write_history(str(tmp_path / "h"), runs=12,
                                       failures=4, events=200)
    launches, numbers = chip_smoke.drive_chaos_path(
        "cpu", str(tmp_path / "c"), storage, generations=3,
        search_params=sp, ingest_params=ip)
    assert launches == {"min_sq_pair": 0, "min_sq": 0}
    assert chaos.decide("storage.tear") is None  # cleared
    assert sorted({p for p, _ in numbers["fires"]}) == [
        "knowledge.eof", "knowledge.outage", "storage.fsync",
        "storage.tear"]
    assert numbers["counts"]["retries"] == 2
    assert len(numbers["acked"]) == 1 and len(numbers["torn"]) == 1
    assert numbers["torn"][0].startswith("coverage.json.")


def test_chip_smoke_rehearses_the_entry_path(capsys):
    """chip_smoke.py's phase 15 on the CPU: the entry's scorer against
    itself and both dry runs, launching no kernel."""
    import chip_smoke

    launches, numbers = chip_smoke.drive_entry_path("cpu")
    assert set(launches) == {"entry", "dryrun_multichip",
                             "dryrun_multichip_fused"}
    assert all(n == {"min_sq_pair": 0, "min_sq": 0}
               for n in launches.values())
    assert numbers["entry_max_abs_err"] == 0.0
    assert numbers["dryrun_multichip_fused"]["ok"] is True
    out = capsys.readouterr().out
    assert out.count("dryrun_multichip OK") == 2
    assert "dryrun_multichip_fused OK" in out
