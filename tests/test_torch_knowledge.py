"""The port's knowledge plane (namazu_tpu_torch/knowledge/: the client and
the service its sidecar hosts with --pool-dir) held to namazu_tpu/knowledge
both ways over the wire: the port's client against the reference's
service and the reference's client against the port's, with the
reference's response shapes; state one package's service writes is read
by the other's; an outage gives one warning and a cooldown, and a
restarted service recovers without duplicates; the shared surrogate,
started from the same weights and fed the same examples, predicts what
the reference's predicts.

Inputs are made with numpy from a seed. Entries, digests, tables, bits
and fingerprints are equal exactly; predictions within rtol 1e-3 / atol
1e-4."""

import logging
import time

import numpy as np
import pytest

from namazu_tpu.knowledge import client as jclient
from namazu_tpu.knowledge import service as jservice
from namazu_tpu.models import failure_pool as jfp
from namazu_tpu.ops import trace_encoding as jte
from namazu_tpu.sidecar import SidecarServer as JSidecar
from namazu_tpu_torch import convert
from namazu_tpu_torch.knowledge import client as tclient
from namazu_tpu_torch.knowledge import service as tservice
from namazu_tpu_torch.models import failure_pool as tfp
from namazu_tpu_torch.models.surrogate import RewardSurrogate as TSur
from namazu_tpu_torch.ops import trace_encoding as tte
from namazu_tpu_torch.sidecar import SidecarServer as TSidecar
from namazu_tpu_torch.sidecar import request
from test_torch_failure_pool import H, views

RTOL, ATOL = 1e-3, 1e-4
SCEN = "scenario-k"
PKG = {"reference": (jclient, jservice, jfp, jte),
       "port": (tclient, tservice, tfp, tte)}


def start(which, pool, port=0):
    """A sidecar of package ``which`` hosting its knowledge service."""
    if which == "port":
        svc = tservice.KnowledgeService(pool, device="cpu")
        srv = TSidecar(port=port, device="cpu", knowledge=svc)
    else:
        svc = jservice.KnowledgeService(pool)
        srv = JSidecar(port=port, knowledge=svc)
    srv.start()
    return srv, svc


@pytest.fixture(params=[("port", "reference"), ("reference", "port")],
                ids=["port-client", "port-service"])
def pairing(request, tmp_path):
    """``(client module, te, fp, server, service, address)`` with the
    client of one package and the service of the other."""
    client_pkg, service_pkg = request.param
    srv, svc = start(service_pkg, str(tmp_path / "pool"))
    cl, _, fp, te = PKG[client_pkg]
    yield cl, te, fp, srv, svc, f"127.0.0.1:{srv.port}"
    srv.shutdown()


def entry(fp, te, seed):
    return fp.entry_to_jsonable(*views(te, seed), H)


def test_push_pull_exclude_and_dedupe(pairing):
    cl, te, fp, _, svc, addr = pairing
    c = cl.KnowledgeClient(addr, tenant="t1", scenario=SCEN, cooldown_s=0)
    r = c.push(entries=[entry(fp, te, s) for s in range(4)])
    assert (r["ok"], r["accepted"], r["duplicates"], r["rejected"]) == \
        (True, 4, 0, 0)
    assert r["pool_size"] == 4 and r["v"] == 3
    r = c.push(entries=[entry(fp, te, 0)])
    assert (r["accepted"], r["duplicates"]) == (0, 1)
    digests = [fp.trace_digest(views(te, s)[0]) for s in range(4)]
    entries, table = c.pull(H, exclude=digests[:1])
    assert table is None
    assert sorted(e.digest for e in entries) == sorted(digests[1:])
    for e in entries:
        s = digests.index(e.digest)
        realized, arrival, seed = views(te, s)
        m = realized.mask
        assert np.array_equal(e.realized.hint_ids, realized.hint_ids[m])
        assert np.array_equal(e.arrival.arrival, arrival.arrival[m])
        assert (e.seed is None) == (seed is None)
    assert c.pull(2 * H)[0] == []  # another bucket count
    bad = dict(entry(fp, te, 5), hint_space="elsewhere")
    assert c.push(entries=[bad])["rejected"] == 1


def test_scenario_table_and_coverage_spaces(pairing):
    cl, _, _, _, _, addr = pairing
    c = cl.KnowledgeClient(addr, tenant="t1", scenario=SCEN, cooldown_s=0)
    for d, f in ((0.01, 1.0), (0.02, 3.0), (0.03, 2.0)):
        c.push(best={"delays": [d] * H, "fitness": f, "H": H})
    t = c.scenario_table(H)
    assert t["fitness"] == 3.0 and np.allclose(t["delays"], 0.02)
    assert c.scenario_table(2 * H) is None
    c.push(coverage={"H": H, "w": 512, "win": 16, "bits": [1, 5, 9]})
    c.push(coverage={"H": H, "w": 512, "win": 16, "bits": [5, 300]})
    c.push(coverage={"H": H, "w": 1024, "win": 16, "bits": [7]})
    c.push(coverage={"H": H, "w": 512, "win": 16, "bits": [600]})  # bad
    assert c.pull_coverage(H, 512, 16) == [1, 5, 9, 300]
    assert c.pull_coverage(H, 1024, 16) == [7]
    assert c.pull_coverage(H, 512, 8) == []
    entries, table, bits = c.pull(H, coverage_space={"H": H, "w": 512,
                                                     "win": 16})
    assert entries == [] and table["fitness"] == 3.0
    assert bits == [1, 5, 9, 300]
    other = cl.KnowledgeClient(addr, tenant="t2", scenario="other",
                               cooldown_s=0)
    assert other.scenario_table(H) is None
    assert other.pull_coverage(H, 512, 16) == []


def test_triage_and_stats(pairing):
    cl, _, _, _, _, addr = pairing
    c = cl.KnowledgeClient(addr, tenant="t1", scenario=SCEN, cooldown_s=0)
    d1 = {"signature": "sig-a", "validated": False, "minimal_flips": 2}
    d2 = {"signature": "sig-a", "validated": True, "minimal_flips": 3}
    d3 = {"signature": "sig-a", "validated": True, "minimal_flips": 4}
    assert c.triage_push(d1)["accepted"] is True
    assert c.triage_push(d2)["accepted"] is True
    r = c.triage_push(d3)
    assert r["accepted"] is False and r["dossier_count"] == 1
    assert c.triage_pull("sig-a") == d2
    assert c.triage_pull("sig-b") is None
    assert c.triage_push({"no": "signature"}) is None
    c2 = cl.KnowledgeClient(addr, tenant="t2", scenario=SCEN, cooldown_s=0)
    c2.pull(H)
    st = c.stats()
    assert st["tenant_count"] == 2 and set(st["tenants"]) == {"t1", "t2"}
    assert st["tenants"]["t1"]["pushes"] == 3
    assert st["triage"] == {"dossiers": 1, "pulls": 2, "hits": 1,
                            "signatures": ["sig-a"]}
    assert set(st) >= {"ok", "pool_dir", "pool_size", "tenant_count",
                       "tenants", "scenario_count", "scenarios", "pushes",
                       "pulls", "dedupe_hits", "triage", "coverage",
                       "surrogate", "v"}


def test_pairs_fingerprint_and_wire_version_equal_the_reference():
    rng = np.random.RandomState(2)
    for shape in ((32, 2), (256, 2), (0, 2)):
        pairs = rng.randint(0, 64, shape).astype(np.int32)
        assert tclient.pairs_fingerprint(pairs) == \
            jclient.pairs_fingerprint(pairs)
    assert tclient.WIRE_VERSION == jclient.WIRE_VERSION
    assert tservice.KnowledgeService.OPS == jservice.KnowledgeService.OPS


def examples_of(seed, n=12, width=20):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        label = float(i % 2)
        feats = rng.rand(width).astype(np.float32) * 0.5 + 0.5 * label
        out.append({"digest": f"d{seed}-{i}", "feats": feats.tolist(),
                    "label": label})
    return out


def test_shared_surrogate_predicts_and_walls_by_space(pairing):
    cl, _, _, _, _, addr = pairing
    c = cl.KnowledgeClient(addr, tenant="t1", scenario=SCEN, cooldown_s=0)
    thin = examples_of(0, n=4)
    assert c.push(examples=thin, pairs_fp="fp1")["trained"] is False
    assert c.predict(np.zeros((2, 20)), pairs_fp="fp1") is None
    r = c.push(examples=examples_of(1), pairs_fp="fp1")
    assert r["trained"] is True
    x = np.random.RandomState(5).rand(3, 20).astype(np.float32)
    probs = c.predict(x, pairs_fp="fp1")
    assert probs.shape == (3,) and ((probs >= 0) & (probs <= 1)).all()
    assert c.predict(x, pairs_fp="fp2") is None  # another pair sample
    assert c.predict(x[:, :10], pairs_fp="fp1") is None  # another width
    other = cl.KnowledgeClient(addr, tenant="t1", scenario="other",
                               cooldown_s=0)
    assert other.predict(x, pairs_fp="fp1") is None  # another scenario


def test_service_surrogates_agree_from_the_same_weights(tmp_path,
                                                        monkeypatch):
    """Both services start their store's model from the same weights (the
    reference's flax init, carried into the port) and fit the same
    examples: the trained flag, the walling and the predictions agree."""
    from jax.flatten_util import ravel_pytree

    from namazu_tpu.models.surrogate import RewardSurrogate as JSur

    W = 20
    made = {}

    def jfactory(K):
        made["ref"] = JSur(K=K, seed=11)
        return made["ref"]

    def tfactory(K, device):
        vec, _ = ravel_pytree(JSur(K=K, seed=11).state.params)
        s = TSur(K=K, device=device)
        s.load_state_dict(convert.surrogate_state_from_flat(
            np.asarray(vec), K))
        return s

    monkeypatch.setattr(jservice, "_surrogate_or_none", jfactory)
    monkeypatch.setattr(tservice, "new_surrogate", tfactory)
    js = jservice.KnowledgeService(str(tmp_path / "j"))
    ts = tservice.KnowledgeService(str(tmp_path / "t"), device="cpu")
    x = np.random.RandomState(6).rand(5, W).astype(np.float32)
    for seed in (3, 4):  # two fit rounds
        push = {"op": "pool_push", "tenant": "t", "scenario": SCEN,
                "pairs_fp": "fp", "examples": examples_of(seed, width=W)}
        assert js.handle(dict(push))["trained"] is \
            ts.handle(dict(push))["trained"] is True
    pred = {"op": "surrogate_predict", "tenant": "t", "scenario": SCEN,
            "pairs_fp": "fp", "feats": x.tolist()}
    rj, rt = js.handle(dict(pred)), ts.handle(dict(pred))
    assert rj["trained"] is rt["trained"] is True
    assert rj["train_rounds"] == rt["train_rounds"] == 2
    np.testing.assert_allclose(rt["probs"], rj["probs"], rtol=RTOL,
                               atol=ATOL)
    assert set(rt) == set(rj)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_service_state_is_read_by_the_other_package(tmp_path, writer):
    """Pool entries, scenario tables, coverage, dossiers and example
    stores written by one package's service are served by the other's
    after a restart on the same directory."""
    pool = str(tmp_path / "pool")
    reader = "port" if writer == "reference" else "reference"
    _, svc_mod, fp, te = PKG[writer]
    w = (svc_mod.KnowledgeService(pool, device="cpu") if writer == "port"
         else svc_mod.KnowledgeService(pool))
    base = {"tenant": "t", "scenario": SCEN}
    w.handle(dict(base, op="pool_push",
                  entries=[entry(fp, te, s) for s in range(3)],
                  best={"delays": [0.01] * H, "fitness": 2.5, "H": H},
                  coverage={"H": H, "w": 256, "win": 16, "bits": [3, 4]},
                  pairs_fp="fp", examples=examples_of(8)))
    w.handle(dict(base, op="triage_push",
                  dossier={"signature": "s1", "validated": True}))
    w.close()
    _, rmod, _, _ = PKG[reader]
    r = (rmod.KnowledgeService(pool, device="cpu") if reader == "port"
         else rmod.KnowledgeService(pool))
    pulled = r.handle(dict(base, op="pool_pull", H=H,
                           coverage_space={"H": H, "w": 256, "win": 16}))
    assert len(pulled["entries"]) == 3 and pulled["pool_size"] == 3
    assert pulled["scenario_table"]["fitness"] == 2.5
    assert pulled["coverage"]["bits"] == [3, 4]
    assert r.handle(dict(base, op="triage_pull", signature="s1"))[
        "dossier"]["validated"] is True
    # the recovered example store retrains lazily: this answer says
    # untrained, the next one is served by the refitted model
    pred = dict(base, op="surrogate_predict", pairs_fp="fp",
                feats=[[0.5] * 20])
    assert r.handle(dict(pred))["trained"] is False
    assert r.handle(dict(pred))["trained"] is True
    assert r.handle(dict(base, op="stats"))["surrogate"]["examples"] == 12


def test_outage_warns_once_cools_down_and_recovers(tmp_path, caplog):
    """A dead service: None, one warning, then None at once while cooling
    down; a service restarted on the same port and pool is picked up and
    the re-pushed backlog dedupes."""
    pool = str(tmp_path / "pool")
    srv, _ = start("port", pool)
    port = srv.port
    c = tclient.KnowledgeClient(f"127.0.0.1:{port}", tenant="t",
                                scenario=SCEN, cooldown_s=0.2)
    assert c.push(entries=[entry(tfp, tte, 0)])["accepted"] == 1
    srv.shutdown()
    with caplog.at_level(logging.WARNING, "namazu_tpu_torch"):
        assert c.pull(H) is None
        assert not c.available()
        assert c.push(entries=[entry(tfp, tte, 1)]) is None  # cooling
        assert c.predict(np.zeros((1, 4))) is None
    warnings = [r for r in caplog.records if "degrading" in r.getMessage()]
    assert len(warnings) == 1
    assert c.counts["outages"] == 1
    srv2, _ = start("port", pool, port=port)
    try:
        time.sleep(0.25)
        r = c.push(entries=[entry(tfp, tte, 0), entry(tfp, tte, 1)])
        assert (r["duplicates"], r["accepted"]) == (1, 1)
        assert tfp.pool_size(pool) == 2
    finally:
        c.close()
        srv2.shutdown()


def test_knowledge_ops_are_refused_without_a_pool_dir():
    srv = TSidecar(port=0, device="cpu")
    srv.start()
    try:
        addr = f"127.0.0.1:{srv.port}"
        assert request(addr, {"op": "ping"}) == {"ok": True, "searches": 0}
        for op in tservice.KnowledgeService.OPS:
            resp = request(addr, {"op": op})
            assert resp["ok"] is False and "pool-dir" in resp["error"]
        c = tclient.KnowledgeClient(addr, cooldown_s=60)
        assert c.stats() is None and not c.available()  # cools down
    finally:
        srv.shutdown()


def test_ping_advertises_the_hosted_service(tmp_path):
    srv, _ = start("port", str(tmp_path / "pool"))
    try:
        resp = request(f"127.0.0.1:{srv.port}", {"op": "ping"})
        assert resp == {"ok": True, "searches": 0, "knowledge": True,
                        "knowledge_v": 3}
    finally:
        srv.shutdown()
