"""The port's chaos seams (namazu_tpu_torch/chaos.py, consulted by its
knowledge client and its atomic writes) held to the reference's
(namazu_tpu.chaos.decide in namazu_tpu/knowledge/client.py and
namazu_tpu/utils/atomic.py) under the reference's own FaultPlan.

The op sequence of the reference's knowledge scenario
(namazu_tpu/chaos/harness.py::_scenario_knowledge: six pushes through
mid-stream EOFs, a hard outage, a restart on the same port and pool, a
closing pull with the plan cleared) is replayed twice under one plan
spec and seed: against the reference's sidecar, service and client, and
against the port's with the reference's ``chaos.decide`` handed in as
the shims hand it in. Both must consult the plan in the same number and
order: the plan fires on a hash of (seed, point, consult index), so one
consult more or less faults other writes. Fired counts, the answers'
None pattern, the pulled table and the harness's three invariants are
equal exactly."""

import os
import time

import numpy as np
import pytest

from namazu_tpu import chaos as jchaos
from namazu_tpu.chaos.plan import FaultPlan
from namazu_tpu.chaos.scenarios import SCENARIOS
from namazu_tpu.knowledge import client as jclient
from namazu_tpu.knowledge import service as jservice
from namazu_tpu.models import failure_pool as jfp
from namazu_tpu.sidecar import SidecarServer as JSidecar
from namazu_tpu.utils import atomic as jatomic
from namazu_tpu_torch import chaos as seams
from namazu_tpu_torch.knowledge import client as tclient
from namazu_tpu_torch.knowledge import service as tservice
from namazu_tpu_torch.models import failure_pool as tfp
from namazu_tpu_torch.ops import trace_encoding as tte
from namazu_tpu_torch.sidecar import SidecarServer as TSidecar
from namazu_tpu_torch.utils import atomic as tatomic
from test_torch_failure_pool import H as POOL_H
from test_torch_failure_pool import views

SPECS = ("knowledge_outage", "storage_torn", "storage_fsync")
# seed 3 fires knowledge.eof on both attempts of the first push (an
# outage); every case fires at least once
SEEDS = (1234, 2, 3, 11)
H = 8  # the harness's table width
# the harness's cooldown is 0.3 s (ridden out by 0.4 s sleeps); here 1 s,
# so that a pause of the test process under load cannot move a push
# across the cooldown's end in one replay and not in the other
COOLDOWN_S, RIDE_OUT_S = 1.0, 1.2


@pytest.fixture(autouse=True)
def no_plan():
    jchaos.clear()
    seams.clear_decider()
    yield
    jchaos.clear()
    seams.clear_decider()


def start(which, pool, port=0):
    if which == "port":
        srv = TSidecar(port=port, device="cpu",
                       knowledge=tservice.KnowledgeService(pool,
                                                           device="cpu"))
    else:
        srv = JSidecar(port=port, knowledge=jservice.KnowledgeService(pool))
    srv.start()
    return srv


def replay(which, faults, seed, workdir):
    """The harness's knowledge scenario against package ``which``: the
    plan's report, every answer's None pattern, the pulled table and the
    invariants' verdicts."""
    client_mod = tclient if which == "port" else jclient
    pool_fsck = tfp.pool_fsck if which == "port" else jfp.pool_fsck
    pool = os.path.join(workdir, which, "pool")
    plan = jchaos.install(FaultPlan(seed, faults))
    if which == "port":
        seams.set_decider(jchaos.decide)
    answers, errors, acked_max = [], [], -1.0

    def push(fitness):
        try:
            resp = client.push(best={"delays": [float(fitness)] * H,
                                     "fitness": float(fitness), "H": H})
        except Exception as e:  # the cardinal rule: never raises
            errors.append(f"push {fitness} raised: {e}")
            resp = None
        answers.append(resp is not None)
        return resp

    srv = start(which, pool)
    port = srv.port
    client = client_mod.KnowledgeClient(f"127.0.0.1:{port}", tenant="chaos",
                                        scenario="knowledge", timeout=5.0,
                                        cooldown_s=COOLDOWN_S)
    try:
        for i in range(6):
            if push(i) is not None:
                acked_max = max(acked_max, float(i))
        pre_crash_max = acked_max
        srv.shutdown()
        if push(99) is not None:
            errors.append("push during outage claimed success")
        srv = start(which, pool, port)
        time.sleep(RIDE_OUT_S)  # ride out the cooldown
        if push(1) is None:
            time.sleep(RIDE_OUT_S)
            if push(1) is None:
                errors.append("client never recovered after restart")
        jchaos.clear()
        pulled = client.pull(H)
        client.close()
    finally:
        srv.shutdown()
        jchaos.clear()
    table = pulled[1] if pulled else None
    final = float(table["fitness"]) if table else None
    fsck = pool_fsck(pool)
    invariants = {
        "never_raises": not errors,
        "state_survives_restart": (final is not None
                                   and final == max(pre_crash_max, 1.0)),
        "fsck_clean": (not fsck["tmp_artifacts"]
                       and not fsck["unreadable_entries"]),
    }
    return {"fired": plan.report()["fired"], "answers": answers,
            "pulled": None if table is None else
            (np.asarray(table["delays"]).tolist(), table["fitness"]),
            "invariants": invariants,
            "state_files": sorted(n.endswith(".tmp") for n in os.listdir(
                os.path.join(pool, "_state")))}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("spec", SPECS)
def test_knowledge_scenario_matches_the_reference(spec, seed, tmp_path):
    faults = SCENARIOS[spec]["faults"]
    want = replay("reference", faults, seed, str(tmp_path))
    got = replay("port", faults, seed, str(tmp_path))
    assert sum(want["fired"].values()) > 0, want
    assert got == want


@pytest.mark.parametrize("point", ["storage.tear", "storage.fsync",
                                   "storage.rename"])
def test_atomic_write_leaves_the_directory_as_the_reference(point,
                                                            tmp_path):
    def after_fault(which, write):
        d = tmp_path / which
        d.mkdir()
        dest = d / "state.json"
        dest.write_bytes(b"old content")
        plan = jchaos.install(FaultPlan(0, {point: {"at": [0]}}))
        with pytest.raises(OSError, match="chaos"):
            write(str(dest), b"0123456789 new content")
        jchaos.clear()
        assert plan.fired(point) == 1
        tmps = [p for p in d.iterdir() if p.name.endswith(".tmp")]
        return (dest.read_bytes(), len(tmps),
                [p.read_bytes() for p in tmps])

    want = after_fault("reference", jatomic.atomic_write)
    seams.set_decider(jchaos.decide)
    got = after_fault("port", tatomic.atomic_write)
    assert got == want
    assert want[0] == b"old content"
    assert want[1] == (1 if point == "storage.tear" else 0)


def test_no_decider_leaves_every_seam_a_noop(tmp_path):
    assert seams.decide("storage.tear") is None
    dest = tmp_path / "x.json"
    tatomic.atomic_write_json(str(dest), {"a": 1})
    assert dest.read_text() == '{"a": 1}'
    assert os.listdir(tmp_path) == ["x.json"]


def test_the_failure_pool_never_consults_the_seam(tmp_path):
    consulted = []

    def refuse(point):
        consulted.append(point)
        raise AssertionError(f"the pool consulted {point}")

    seams.set_decider(refuse)
    realized, arrival, table = views(tte, 5)
    digest = tfp.pool_add(str(tmp_path), realized, arrival, table, POOL_H)
    assert consulted == []
    assert tfp.pool_fsck(str(tmp_path))["entries"] == 1
    assert [e.digest for e in tfp.pool_load(str(tmp_path), POOL_H)] \
        == [digest]
    # the knowledge service's own state writes do consult it
    with pytest.raises(AssertionError, match="storage.tear"):
        tatomic.atomic_write(str(tmp_path / "state.json"), b"{}")


def test_both_shims_hand_the_reference_plan_to_the_seams():
    """The sidecar shim's ``build_server`` and the ``torch_search``
    policy's search build set the reference's ``chaos.decide`` as the
    port's decider: a plan installed afterwards fires in the port."""
    import namazu_tpu_torch_sidecar as sidecar_shim
    from test_torch_policy import params, torch_policy

    for hand_in in (lambda: sidecar_shim.build_server("127.0.0.1", 0, "cpu"),
                    lambda: torch_policy(params())._build_search()):
        seams.clear_decider()
        hand_in()
        assert seams.decide("knowledge.outage") is None  # no plan yet
        plan = jchaos.install(FaultPlan(0, {"knowledge.outage": {"at": [0]}}))
        assert seams.decide("knowledge.outage") == {
            "point": "knowledge.outage", "index": 0}
        assert plan.fired("knowledge.outage") == 1
        jchaos.clear()
