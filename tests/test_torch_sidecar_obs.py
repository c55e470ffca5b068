"""The port's sidecar in the reference's observability plane, on the CPU:
``namazu_tpu_torch_sidecar.py`` (the port's ``nmz-tpu sidecar``) and the
telemetry seam of the package's sidecar, searches, ingest and knowledge
service and client (``namazu_tpu_torch/obs.py``).

* Parity: one request sequence against the reference's
  ``namazu_tpu.sidecar.SidecarServer`` (JAX on the CPU) and the shim's
  server records the same (family, labels) series and the same
  deterministic counts in the reference's registry.
* The framed obs ops answer with the reference sidecar's keys, and the
  reference's own ``tcp://`` readers (``tools top --url``, ``tools
  profdiff``) read a port sidecar.
* The shim's relay pushes as job ``sidecar`` to a reference
  ``TelemetryServer``; the shim refuses a platform it does not serve and
  a missing card; a closed knowledge service leaves no gauge refresh.

Sizes are small: H = K = 16, population 64, 4 generations in chunks of
3, a naive storage of 6 runs of 240 events (2 failures). Counts are
compared exactly; timings are not compared."""

import contextlib
import inspect
import json
import os
import socket
import subprocess
import sys
import time

import pytest
import torch

from namazu_tpu.obs import federation, metrics, profiling
from namazu_tpu_torch import obs as tobs
from namazu_tpu_torch import wire
from namazu_tpu_torch.knowledge import KnowledgeService

import namazu_tpu_torch_sidecar as shim
from test_torch_ingest import write_storage

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.dirname(os.path.abspath(__file__))

SEARCH_PARAMS = {"H": 16, "K": 16, "population": 64, "migrate_k": 2,
                 "seed": 5, "max_interval": 0.05, "fused_chunk": 3,
                 "guidance": True}
GENERATIONS = 4
#: the families whose counts a sequence must reproduce exactly
COUNTED = ("nmz_sidecar_requests_total", "nmz_search_generations_total",
           "nmz_knowledge_", "nmz_search_phase_seconds")
#: the keys of the reference sidecar's answers to the obs ops
OBS_KEYS = {"metrics": {"ok", "metrics"}, "fleet": {"ok", "fleet"},
            "fleet_prom": {"ok", "text"}, "profile": {"ok", "profile"},
            "profile_collapsed": {"ok", "text"},
            "telemetry": {"ok", "last_seq"},
            "telemetry_replay": {"ok", "duplicate", "last_seq"}}


@contextlib.contextmanager
def fresh_plane():
    """An empty reference registry and federation wiring, restored
    empty afterwards (both are process-global)."""
    metrics.configure(True)
    metrics.reset()
    federation.reset()
    profiling.reset()
    try:
        yield
    finally:
        profiling.reset()
        federation.reset()
        metrics.reset()


def series() -> dict:
    """``{(family, labels): value}`` of the reference's registry; a
    histogram's value is its count."""
    out = {}
    for fam in metrics.registry().to_jsonable()["metrics"]:
        for s in fam["samples"]:
            v = s["value"]
            out[(fam["name"], tuple(sorted(s["labels"].items())))] = (
                v["count"] if isinstance(v, dict) else v)
    return out


def start_server(kind: str, tmp, pool: bool):
    """A started sidecar of ``kind`` ("reference": the JAX package's,
    "port": the shim's on the CPU), hosting a knowledge service over a
    pool under ``tmp`` when ``pool``."""
    pool_dir = str(tmp / f"{kind}-pool") if pool else ""
    if kind == "port":
        srv = shim.build_server("127.0.0.1", 0, "cpu", pool_dir)
    else:
        from namazu_tpu.knowledge import KnowledgeService as JKnowledge
        from namazu_tpu.sidecar import SidecarServer as JServer

        srv = JServer("127.0.0.1", 0, knowledge=JKnowledge(pool_dir)
                      if pool else None)
    srv.start()
    return srv


def srv_addr(srv) -> str:
    return f"127.0.0.1:{srv.port}"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def search_req(storage, addr, ckpt):
    return {
        "op": "search", "key": storage, "storage": storage,
        "search_params": SEARCH_PARAMS,
        "ingest_params": {"H": 16, "max_interval": 0.05, "guidance": True,
                          "knowledge": addr, "knowledge_tenant": "t",
                          "knowledge_scenario": "s"},
        "generations": GENERATIONS, "checkpoint": ckpt,
    }


def request_sequence(kind: str, storage: str, tmp) -> list:
    """``ping``, two searches (guidance and the knowledge client on,
    against the server's own pool), ``stats``, ``pool_pull`` and an
    unknown op on one keep-alive connection, then a knowledge op on a
    server without a pool. Returns the answers' ``ok``s."""
    srv = start_server(kind, tmp, pool=True)
    bare = start_server(kind, tmp, pool=False)
    addr = srv_addr(srv)
    reqs = [{"op": "ping"},
            search_req(storage, addr, str(tmp / f"{kind}.npz")),
            search_req(storage, addr, str(tmp / f"{kind}.npz")),
            {"op": "stats"}, {"op": "pool_pull", "H": 16}, {"op": "nope"}]
    oks = []
    try:
        with socket.create_connection(("127.0.0.1", srv.port)) as s:
            for req in reqs:
                wire.write_frame(s, req)
                oks.append(wire.read_frame(s)["ok"])
        oks.append(wire.request(srv_addr(bare),
                                {"op": "pool_pull", "H": 16})["ok"])
    finally:
        srv.shutdown()
        bare.shutdown()
    return oks


def parity(storage: str, tmp) -> dict:
    """Each kind's answers and series after :func:`request_sequence`,
    each from an empty registry."""
    import pathlib

    out = {}
    for kind in ("reference", "port"):
        with fresh_plane():
            oks = request_sequence(kind, storage, pathlib.Path(tmp))
            out[kind] = {"oks": oks, "series": sorted(
                [name, list(map(list, labels)), value]
                for (name, labels), value in series().items())}
    return out


PARITY = """
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
sys.path[:0] = [REPO, TESTS]
from test_torch_sidecar_obs import parity
print(json.dumps(parity(STORAGE, TMP)))
"""


@pytest.fixture
def history(tmp_path):
    return write_storage(tmp_path / "st", quarantine=False, unstamped=False)


def test_sidecar_records_the_reference_series_and_counts(tmp_path, history):
    """One request sequence against the reference's sidecar and the
    shim's: the same answers, the same (family, labels) series, and the
    same counts of requests, generations, knowledge round trips,
    warm-start installs and search phases. In a fresh interpreter: the
    registry is process-global, and a thread another test left behind
    could write into it."""
    script = (f"REPO = {REPO!r}\nTESTS = {TESTS!r}\n"
              f"STORAGE = {history.dir!r}\nTMP = {str(tmp_path)!r}\n"
              + PARITY)
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    ref, port = ({(n, tuple(map(tuple, labels))): v
                  for n, labels, v in got[kind]["series"]}
                 for kind in ("reference", "port"))
    assert got["reference"]["oks"] == got["port"]["oks"] == [
        True, True, True, True, True, False, False]
    assert set(port) == set(ref)
    counted = {k for k in ref if k[0].startswith(COUNTED)}
    assert {k: port[k] for k in counted} == {k: ref[k] for k in counted}
    assert port[("nmz_sidecar_requests_total",
                 (("ok", "true"), ("op", "search")))] == 2
    assert port[("nmz_search_generations_total",
                 (("backend", "ga"),))] == 2 * GENERATIONS
    assert {k[1] for k in counted
            if k[0] == "nmz_search_phase_seconds"} >= {
        (("phase", p),) for p in ("encode", "evolve", "host_io",
                                  "surrogate")}
    assert any(k[0] == "nmz_knowledge_warmstart_installs_total"
               for k in counted)


TELEMETRY_DOC = {"schema": federation.SCHEMA, "job": "probe",
                 "instance": "probe@test", "seq": 1, "interval_s": 2.0,
                 "families": []}
OBS_REQUESTS = {
    "metrics": [{"op": "metrics"}], "fleet": [{"op": "fleet"}],
    "fleet_prom": [{"op": "fleet", "format": "prom"}],
    "profile": [{"op": "profile"}],
    "profile_collapsed": [{"op": "profile", "format": "collapsed"}],
    "telemetry": [{"op": "telemetry", "doc": TELEMETRY_DOC}],
    "telemetry_replay": [{"op": "telemetry", "doc": TELEMETRY_DOC}] * 2,
}


@pytest.mark.parametrize("name", sorted(OBS_REQUESTS))
def test_obs_ops_answer_with_the_reference_keys(tmp_path, name):
    """Each framed obs op, asked of the reference's sidecar and of the
    shim's with the profiler running, answers with the same keys (the
    last answer of a pushed doc replayed: ``duplicate``)."""
    keys = {}
    for kind in ("reference", "port"):
        with fresh_plane():
            profiling.ensure_profiler("sidecar")
            srv = start_server(kind, tmp_path, pool=False)
            try:
                for req in OBS_REQUESTS[name]:
                    resp = wire.request(srv_addr(srv), req)
            finally:
                srv.shutdown()
        assert resp["ok"] is True, resp
        keys[kind] = set(resp)
    assert keys["port"] == keys["reference"] == OBS_KEYS[name]


@pytest.mark.parametrize("tool", ["metrics", "top", "profdiff"])
def test_reference_readers_reach_a_port_sidecar(tmp_path, history, capsys,
                                                tool):
    """``nmz-tpu tools metrics --url``, ``tools top --url`` and ``tools
    profdiff`` read the shim's sidecar over ``tcp://``: its metrics after
    a search, its fleet (the relay's job ``sidecar``), its profile."""
    from namazu_tpu.cli import cli_main

    with fresh_plane():
        profiling.ensure_profiler("sidecar")
        srv = start_server("port", tmp_path, pool=True)
        try:
            federation.ensure_self_relay("sidecar")
            url = f"tcp://127.0.0.1:{srv.port}"
            wire.request(srv_addr(srv), search_req(
                history.dir, srv_addr(srv), str(tmp_path / "s.npz")))
            capsys.readouterr()
            argv = {"metrics": ["tools", "metrics", "--url", url],
                    "top": ["tools", "top", "--url", url, "--json"],
                    "profdiff": ["tools", "profdiff", url, url,
                                 "--format", "json"]}[tool]
            if tool == "top":
                federation.self_relay().flush()
            assert cli_main(argv) in (0, None)
            out = capsys.readouterr().out
        finally:
            srv.shutdown()
    if tool == "metrics":
        fams = {f["name"]: f["samples"] for f in json.loads(out)["metrics"]}
        assert {"labels": {"ok": "true", "op": "search"}, "value": 1.0} \
            in fams["nmz_sidecar_requests_total"]
        assert "nmz_search_phase_seconds" in fams
    elif tool == "top":
        jobs = [row["job"] for row in json.loads(out)["instances"]]
        assert jobs == ["sidecar"]
    else:
        assert "frames" in json.loads(out)


BLOCK_JAX = """
import importlib.abc, runpy, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax"):
            print(f"blocked import of {name}", file=sys.stderr)
            raise ImportError(f"{name} is blocked")
        return None

sys.meta_path.insert(0, Block())
sys.argv = ARGV
runpy.run_path("namazu_tpu_torch_sidecar.py", run_name="__main__")
"""


def test_relay_pushes_as_job_sidecar_with_jax_blocked(tmp_path, history):
    """The shim as its own process on the CPU, ``--telemetry-url
    uds://...`` at a reference ``TelemetryServer``: it answers ping,
    serves a search without trying to import JAX (which is blocked), and
    shows in that aggregator's fleet as job ``sidecar``, its pushes
    counting the search."""
    agg = federation.FleetAggregator()
    sock = str(tmp_path / "collector.sock")
    collector = federation.TelemetryServer(sock, agg)
    collector.start()
    port = _free_port()
    argv = ["namazu_tpu_torch_sidecar.py", "--platform", "cpu",
            "--listen", f"127.0.0.1:{port}",
            "--telemetry-url", f"uds://{sock}"]
    child = subprocess.Popen(
        [sys.executable, "-c", f"ARGV = {argv!r}\n" + BLOCK_JAX],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 120
        jobs, pong = [], None
        while time.monotonic() < deadline and child.poll() is None:
            try:
                pong = pong or wire.request(f"127.0.0.1:{port}",
                                            {"op": "ping"}, timeout=5)
            except OSError:
                pass
            jobs = [r["job"] for r in agg.payload()["instances"]]
            if pong and jobs:
                break
            time.sleep(0.2)
        assert child.poll() is None, child.communicate()[1][-3000:]
        assert pong == {"ok": True, "searches": 0}
        assert jobs == ["sidecar"]
        addr = f"127.0.0.1:{port}"
        assert wire.request(addr, search_req(history.dir, "", ""))["ok"]
        federation_counts = None
        while time.monotonic() < deadline and not federation_counts:
            federation_counts = [
                s for s in agg.prometheus().splitlines()
                if s.startswith("nmz_sidecar_requests_total")
                and 'op="search"' in s]
            time.sleep(0.2)
        assert federation_counts, agg.prometheus()[-3000:]
    finally:
        child.terminate()
        _, err = child.communicate(timeout=30)
        collector.shutdown()
    assert "blocked import" not in err, err[-3000:]


@pytest.mark.parametrize("platform,card,error", [
    ("tpu", True, ValueError),
    ("tpu", False, ValueError),
    ("", False, RuntimeError),
    ("gpu", False, RuntimeError),
])
def test_the_shim_refuses_what_it_does_not_serve(monkeypatch, platform,
                                                 card, error):
    """``--platform tpu`` raises, and without a card so does the card's
    default: no quiet move to the CPU (the relay test serves ``cpu``)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: card)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: int(card))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(error):
        shim.main(["--platform", platform, "--listen", "127.0.0.1:0"])


@pytest.mark.parametrize("op", ["telemetry", "fleet", "metrics",
                                "profile"])
def test_the_package_sidecar_answers_obs_ops_unknown(op):
    """``python -m namazu_tpu_torch.sidecar`` has no sink and no hook:
    the obs ops are unknown ops there, as its ``--help`` says."""
    from namazu_tpu_torch.sidecar import SidecarServer

    srv = SidecarServer(port=0, device="cpu")
    srv.start()
    try:
        assert wire.request(srv_addr(srv), {"op": op}) == {
            "ok": False, "error": f"unknown op {op!r}"}
    finally:
        srv.shutdown()
    out = subprocess.run(
        [sys.executable, "-m", "namazu_tpu_torch.sidecar", "--help"],
        cwd=REPO, capture_output=True, text=True, timeout=120, check=True)
    assert "'unknown op'" in out.stdout


def knowledge_round(kind: str, tmp) -> dict:
    """A knowledge service of ``kind`` handed labeled examples enough
    to fit once and a dossier, and a client of ``kind`` against a closed
    port pushing, pulling and asking for a dossier; the series that
    leaves in an empty registry."""
    import numpy as np

    if kind == "port":
        from namazu_tpu_torch.knowledge import KnowledgeClient

        svc = KnowledgeService(str(tmp / "port-pool"), device="cpu",
                               telemetry=shim.SINK)
        sink = {"telemetry": shim.SINK}
    else:
        from namazu_tpu.knowledge import KnowledgeClient
        from namazu_tpu.knowledge import KnowledgeService as JKnowledge

        svc = JKnowledge(str(tmp / "reference-pool"))
        sink = {}
    rng = np.random.RandomState(0)
    examples = [{"digest": f"d{i}", "label": float(i % 2),
                 "feats": rng.rand(8).tolist()} for i in range(8)]
    with fresh_plane():
        pushed = svc.handle({"op": "pool_push", "tenant": "t",
                             "scenario": "s", "pairs_fp": "fp",
                             "examples": examples})
        svc.handle({"op": "triage_push", "tenant": "t",
                    "dossier": {"signature": "sig", "minimal_flips": 1}})
        svc.close()
        client = KnowledgeClient(f"127.0.0.1:{_free_port()}", tenant="t",
                                 scenario="s", timeout=2.0, **sink)
        for _ in range(2):
            client.push(entries=[{"x": 1}])
            client.pull(16)
            client.triage_pull("sig")
        client.close()
        return {"trained": pushed["trained"], "series": series()}


def test_knowledge_client_and_service_report_as_the_reference(tmp_path):
    """The knowledge service's fit rounds, gauges and fan-in, and the
    client's outage, failed pushes, pulls and dossier pulls, leave the
    reference's series and counts."""
    got = {kind: knowledge_round(kind, tmp_path)
           for kind in ("reference", "port")}
    ref, port = got["reference"]["series"], got["port"]["series"]
    assert got["reference"]["trained"] is got["port"]["trained"] is True
    assert set(port) == set(ref)
    counted = {k for k in ref if k[0].endswith("_total")}
    assert {k: port[k] for k in counted} == {k: ref[k] for k in counted}
    assert port[("nmz_knowledge_surrogate_train_rounds_total", ())] == 1
    assert port[("nmz_knowledge_outages_total", ())] == 1
    assert port[("nmz_knowledge_pushes_total", (("ok", "false"),))] == 2
    assert port[("nmz_triage_dossier_pulls_total",
                 (("ok", "false"),))] == 2


def test_closing_the_knowledge_service_unregisters_its_gauges(tmp_path):
    """The service's gauge refresh runs with every collector pass while
    it is open, and not after ``close()``."""
    with fresh_plane():
        svc = KnowledgeService(str(tmp_path / "pool"), device="cpu",
                               telemetry=shim.SINK)
        federation.run_collectors()
        assert ("nmz_knowledge_pool_entries", ()) in series()
        svc.close()
        metrics.reset()
        federation.run_collectors()
        assert not [k for k in series() if k[0].startswith("nmz_knowledge")]


def test_the_sink_carries_the_reference_calls():
    """Every call of the port's sink is a reference call of the same
    parameters: ``namazu_tpu.obs``'s, the collector calls
    ``obs.federation``'s, the stamp calls ``obs.context``'s (the shim's
    sink makes those only while the plane is on, so they are wrapped;
    ``tests/test_torch_causality.py`` holds what they do). The sink's
    ``search_phase`` is wrapped too: the next test holds what it
    forwards."""
    from namazu_tpu import obs

    calls = [n for n, _ in inspect.getmembers(tobs.Telemetry,
                                               inspect.isfunction)
             if not n.startswith("_")]
    assert len(calls) == 21
    for name in calls:
        port = getattr(tobs.Telemetry, name)
        if name in ("wire_stamp", "observe_wire"):
            ref = getattr(obs.context, name)
            assert (len(inspect.signature(port).parameters) - 1
                    == len(inspect.signature(ref).parameters)), name
            assert callable(getattr(shim.SINK, name))
            continue
        ref = getattr(obs if hasattr(obs, name) else federation, name)
        assert (list(inspect.signature(port).parameters)[1:]
                == list(inspect.signature(ref).parameters)), name
        if name == "search_phase":
            assert (list(inspect.signature(shim.SINK.search_phase).parameters)
                    == list(inspect.signature(ref).parameters))
            continue
        assert getattr(shim.SINK, name) is ref


def test_the_sink_keeps_the_port_phases_off_the_plane():
    """The shim's sink records the reference's search phases on the
    reference's plane, and not the phases only the port opens (the
    sidecar's ``ingest`` and ``save``, the ingest's sections): the plane
    keeps the series the reference's sidecar reports."""
    reference = ("encode", "evolve", "host_io", "surrogate", "extract",
                 "install")
    port = ("ingest", "save", "ingest_read_encode", "ingest_pool_io",
            "ingest_knowledge", "ingest_guidance_observe", "ingest_archive")
    with fresh_plane():
        for phase in reference + port:
            with shim.SINK.search_phase(phase):
                pass
        got = {dict(k[1])["phase"]: v for k, v in series().items()
               if k[0] == "nmz_search_phase_seconds"}
    assert got == {phase: 1 for phase in reference}


def test_chip_smoke_rehearses_the_shim_path(tmp_path):
    """chip_smoke.py's phase 13 at a tiny size on the CPU: the shim as a
    child process with a pool and a push target, two searches and a
    ``stats`` op over its wire, the ``metrics``, ``fleet`` and
    ``profile`` checks, the relay's doc counting both searches, then
    warm requests in turns with the package's sidecar as a second
    child."""
    import chip_smoke

    sp = dict(chip_smoke.POLICY_SEARCH_PARAMS, H=32, K=32, population=64,
              fused_chunk=3)
    ip = dict(chip_smoke.POLICY_INGEST_PARAMS, H=32)
    storage = chip_smoke.write_history(str(tmp_path / "h"), runs=12,
                                       failures=4, events=1000)
    numbers = chip_smoke.drive_shim_path(
        "cpu", str(tmp_path / "shim"), storage, generations=5,
        search_params=sp, ingest_params=ip)
    assert numbers["trace_nmz_score"] == [5, 0]  # no kernel on the CPU
    assert numbers["generations"] == 10
    assert numbers["profile"]["ingest"] > 0
    assert numbers["push_after_s"] <= 3 * chip_smoke.RELAY_INTERVAL_S
    assert [len(numbers["turns"][k]) for k in ("shim", "package")] == [3, 3]
