"""The port's multi-process form (namazu_tpu_torch/parallel/distributed.py)
on the CPU with gloo: ``initialize_from_env``'s no-op, the hybrid mesh's
shape and refusals, and a search over a ``2 x 2`` hybrid mesh run by two
processes (one host row each) against the same mesh in one process with
virtual hosts, bit for bit; the same for the policy's build
(``policy/tpu.py`` with ``dcn_hosts = 2``, ``torch.distributed`` started
from the environment) over an ingested history, with its refusals.

No JAX here: the spawned workers import this module, and nothing of the
reference. Each worker joins within a timeout that fails the test."""

import multiprocessing
import os
import socket

import numpy as np
import pytest
import torch

from namazu_tpu_torch.models.ga import GAConfig
from namazu_tpu_torch.models.ingest import ingest_history
from namazu_tpu_torch.models.search import ScheduleSearch, SearchConfig
from namazu_tpu_torch.history import load_storage
from namazu_tpu_torch.ops import trace_encoding as te
from namazu_tpu_torch.parallel import distributed as tdist
from namazu_tpu_torch.policy import tpu as tpol

H = K = 32
JOIN_TIMEOUT_S = 60


def test_initialize_from_env_is_a_noop_without_env(monkeypatch):
    for var in ("NMZ_TPU_COORDINATOR", "NMZ_TPU_NUM_PROCESSES",
                "NMZ_TPU_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert tdist.initialize_from_env(device="cpu") is False
    assert not torch.distributed.is_initialized()


def test_hybrid_mesh_shape_and_refusals():
    mesh = tdist.make_hybrid_mesh(n_hosts=2, devices=["cpu"] * 8)
    assert mesh.shape == {"h": 2, "i": 4}
    assert not mesh.distributed and len(mesh.shards) == 1
    assert tdist.make_hybrid_mesh(n_hosts=4, devices=["cpu"] * 8).shape == {
        "h": 4, "i": 2}
    with pytest.raises(ValueError, match="do not divide into 3 hosts"):
        tdist.make_hybrid_mesh(n_hosts=3, devices=["cpu"] * 8)
    assert tdist.hier_rings(8, 2, 1, 4) == (("i", 8, 1), ("h", 2, 4))


def search(mesh):
    """The search both forms run: 2 x 2 islands of 8 genomes, chip ring
    of 2, host ring of 1 every second generation, inputs from a seed."""
    cfg = SearchConfig(H=H, K=K, archive_size=16, failure_size=4,
                       population=32, migrate_k=2, dcn_migrate_every=2,
                       fused_chunk=3, seed=7, ga=GAConfig(max_delay=0.05))
    s = ScheduleSearch(cfg, mesh=mesh)
    rng = np.random.RandomState(3)

    def enc(n):
        return te.encode_event_stream(
            [f"10.0.0.{rng.randint(6)}->10.0.0.{rng.randint(6)}:m"
             f"{rng.randint(3)}" for _ in range(n)],
            arrivals=sorted(rng.rand(n).tolist()), H=H)

    for i in range(4):
        s.add_executed_trace(enc(40), reproduced=i == 1)
    s.add_failure_trace(enc(50))
    refs = [enc(48), enc(60)]
    s.seed_population([np.full((H,), 0.03, np.float32)])
    best = s.run(refs, generations=4)
    delays, faults = s._fetch_population()
    return best, delays, faults, s.last_fit_curve


def _worker(rank, port, out_dir):
    torch.set_num_threads(1)
    try:
        assert tdist.initialize_from_env(f"127.0.0.1:{port}", 2, rank,
                                         device="cpu")
        assert tdist.initialize_from_env(device="cpu")  # idempotent
        mesh = tdist.make_hybrid_mesh(devices=["cpu"] * 2)
        assert mesh.shape == {"h": 2, "i": 2} and mesh.distributed
        assert mesh.first_island == 2 * rank
        with pytest.raises(ValueError, match="multiple of the process"):
            tdist.make_hybrid_mesh(n_hosts=1, devices=["cpu"] * 2)
        best, delays, faults, curve = search(mesh)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), delays=delays,
                 faults=faults, best_d=best.delays, best_f=best.faults,
                 fit=np.float32(best.fitness),
                 curve=np.asarray(curve, np.float32))
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_processes_equal_one_process_with_virtual_hosts(tmp_path):
    torch.set_num_threads(1)
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(r, port, str(tmp_path)))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_TIMEOUT_S)
        alive = [p.pid for p in procs if p.is_alive()]
        assert not alive, f"workers {alive} did not finish in time"
        assert [p.exitcode for p in procs] == [0, 0]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    best, delays, faults, curve = search(
        tdist.make_hybrid_mesh(n_hosts=2, devices=["cpu"] * 4))
    for r in range(2):
        with np.load(tmp_path / f"rank{r}.npz") as z:
            assert np.array_equal(z["delays"], delays)
            assert np.array_equal(z["faults"], faults)
            assert np.array_equal(z["best_d"], best.delays)
            assert np.array_equal(z["best_f"], best.faults)
            assert float(z["fit"]) == np.float32(best.fitness)
            assert np.array_equal(z["curve"],
                                  np.asarray(curve, np.float32))


# the policy's knobs at a small size: 4 islands over 2 hosts
POLICY = {"H": H, "K": K, "population": 64, "migrate_k": 2,
          "dcn_migrate_every": 2, "fused_chunk": 3, "seed": 9,
          "max_interval": 0.05, "devices": 4}
INGEST = {"H": H, "max_interval": 0.05}
ENV = ("NMZ_TPU_COORDINATOR", "NMZ_TPU_NUM_PROCESSES", "NMZ_TPU_PROCESS_ID")


def policy_search(storage):
    """The policy's build with ``dcn_hosts = 2`` fed an ingested history
    (successes only: seeding the population is a no-op across
    processes, as in the reference)."""
    s = tpol.build_search(POLICY, "cpu", dcn_hosts=2)
    refs = ingest_history(s, load_storage(storage),
                          tpol.ingest_params(INGEST))
    best = s.run(refs, generations=4)
    delays, faults = s._fetch_population()
    return s, best, delays, faults


def _policy_worker(rank, port, storage, out_dir):
    torch.set_num_threads(1)
    os.environ.update(zip(ENV, (f"127.0.0.1:{port}", "2", str(rank))))
    try:
        s, best, delays, faults = policy_search(storage)
        assert s.mesh.distributed and s.mesh.shape == {"h": 2, "i": 2}
        with pytest.raises(ValueError) as e:
            tpol.build_search(dict(POLICY, devices=3), "cpu", dcn_hosts=2)
        assert str(e.value) == \
            "devices=3 must divide evenly across 2 processes"
        if rank == 1:  # this process has one card
            tpol._cards = lambda device, wanted: 1
        with pytest.raises(ValueError) as e:
            tpol.build_search(POLICY, "cpu", dcn_hosts=2)
        assert str(e.value) == ("devices=4 needs 2 chips per process but "
                                "some have fewer: {1: 1}")
        np.savez(os.path.join(out_dir, f"policy{rank}.npz"), delays=delays,
                 faults=faults, best_d=best.delays,
                 fit=np.float32(best.fitness))
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def test_policy_build_over_two_processes_equals_one_process(tmp_path,
                                                           monkeypatch):
    import chip_smoke

    storage = chip_smoke.write_history(str(tmp_path / "st"), runs=4,
                                       successes=4, events=60)
    torch.set_num_threads(1)
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_policy_worker,
                         args=(r, port, storage, str(tmp_path)))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_TIMEOUT_S)
        alive = [p.pid for p in procs if p.is_alive()]
        assert not alive, f"workers {alive} did not finish in time"
        assert [p.exitcode for p in procs] == [0, 0]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    s, best, delays, faults = policy_search(storage)
    assert not s.mesh.distributed and s.mesh.shape == {"h": 2, "i": 2}
    for r in range(2):
        with np.load(tmp_path / f"policy{r}.npz") as z:
            assert np.array_equal(z["delays"], delays)
            assert np.array_equal(z["faults"], faults)
            assert np.array_equal(z["best_d"], best.delays)
            assert float(z["fit"]) == np.float32(best.fitness)
