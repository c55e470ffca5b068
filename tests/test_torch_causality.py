"""Causality stamps and the JAX import of the port's shims, on the CPU.

* The framed server: a ping stamped ``{"lc": 1000}`` sent to the
  reference's ``SidecarServer`` and to the port's sidecar behind the
  shim (``namazu_tpu_torch_sidecar.build_server``) is answered with a
  stamp of ``lc`` 1002, and the process's Lamport clock reads 1002 (the
  request merged, then one tick for the answer).
* The knowledge client: the port's, handed the shim's sink, stamps its
  ``pool_pull`` frame as the reference's does and merges the answer's
  stamp.
* With the default sink (``namazu_tpu_torch.obs.NULL``) the frames on
  the wire are the ones sent before stamps, byte for byte.
* A ``torch_search`` policy's search phase imports no JAX; a
  ``tpu_search`` one in a process that lists the plugin keeps the
  reference's ``jax.profiler`` annotation.
"""

import json
import os
import socket
import subprocess
import sys

import pytest

from namazu_tpu.knowledge.client import KnowledgeClient as JClient
from namazu_tpu.obs import context
from namazu_tpu_torch import wire
from namazu_tpu_torch.knowledge import KnowledgeService
from namazu_tpu_torch.knowledge.client import KnowledgeClient
from namazu_tpu_torch.models.failure_pool import MAX_LOAD
from namazu_tpu_torch.sidecar import SidecarServer

import namazu_tpu_torch_sidecar as shim
from test_torch_sidecar_obs import fresh_plane, srv_addr, start_server

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAMPED_PING = {"op": "ping", "ctx": {"lc": 1000, "o": "x@y"}}
#: the pull(8) frame of a client of tenant "t", scenario "s", unstamped
PULL_FRAME = [("op", "pool_pull"), ("H", 8), ("exclude", []),
              ("max_entries", MAX_LOAD), ("v", 3), ("tenant", "t"),
              ("scenario", "s")]


def raw_answer(addr: str, req: dict) -> bytes:
    """The body bytes of the answer to ``req`` on a fresh connection."""
    host, _, port = addr.rpartition(":")
    with socket.create_connection((host, int(port)), timeout=60) as s:
        wire.write_frame(s, req)
        binary, body = wire.read_frame_raw(s)
    assert not binary
    return body


@pytest.mark.parametrize("kind", ["reference", "port"])
def test_a_stamped_ping_is_merged_and_answered_with_a_stamp(tmp_path, kind):
    with fresh_plane():
        context.reset()
        srv = start_server(kind, tmp_path, pool=True)
        try:
            resp = json.loads(raw_answer(srv_addr(srv), STAMPED_PING))
        finally:
            srv.shutdown()
        assert resp["ok"] is True
        assert resp["ctx"] == {"lc": 1002, "o": context.origin()}
        assert context.clock().value() == 1002


def test_the_port_server_with_the_default_sink_answers_as_before():
    srv = SidecarServer(port=0, device="cpu")
    srv.start()
    try:
        addr = srv_addr(srv)
        assert raw_answer(addr, STAMPED_PING) == raw_answer(addr,
                                                            {"op": "ping"})
    finally:
        srv.shutdown()


def recording_service(tmp_path, telemetry):
    """The port's knowledge service behind the port's framed server with
    ``telemetry`` as its sink, recording every request frame it reads."""
    service = KnowledgeService(str(tmp_path / "pool"), device="cpu")
    frames = []

    def handler(req):
        frames.append(req)
        return service.handle(req)

    srv = wire.FramedServer(handler, telemetry=telemetry)
    srv.bind_tcp("127.0.0.1", 0)
    srv.start()
    return srv, frames


def test_the_knowledge_client_stamps_as_the_reference_does(tmp_path):
    with fresh_plane():
        context.reset()
        srv, frames = recording_service(tmp_path, shim.SINK)
        try:
            addr = srv_addr(srv)
            clients = [JClient(addr, tenant="t", scenario="s"),
                       KnowledgeClient(addr, tenant="t", scenario="s",
                                       telemetry=shim.SINK)]
            ticks = []
            for client in clients:
                before = context.clock().value()
                assert client.pull(8) == ([], None)
                ticks.append(context.clock().value() - before)
                client.close()
        finally:
            srv.shutdown()
    ref, port = frames
    # the client ticks to stamp, the server merges and ticks to answer,
    # the client merges the answer: four ticks a round trip
    assert ticks == [4, 4]
    assert port["ctx"] == {"lc": ref["ctx"]["lc"] + 4, "o": context.origin()}
    assert list(ref) == list(port) == [k for k, _ in PULL_FRAME] + ["ctx"]
    assert [(k, port[k]) for k in list(port)[:-1]] == PULL_FRAME


def test_the_knowledge_client_with_the_default_sink_sends_as_before(
        tmp_path):
    with fresh_plane():
        context.reset()
        srv, frames = recording_service(tmp_path, shim.SINK)
        try:
            client = KnowledgeClient(srv_addr(srv), tenant="t", scenario="s")
            assert client.pull(8) == ([], None)
            client.close()
        finally:
            srv.shutdown()
        # no stamp sent, so none answered and none merged
        assert context.clock().value() == 0
    assert list(frames[0].items()) == PULL_FRAME


def test_the_shim_sink_stamps_only_while_the_plane_is_on():
    from namazu_tpu.obs import metrics

    with fresh_plane():
        context.reset()
        metrics.configure(False)
        try:
            assert shim.SINK.wire_stamp() is None
            shim.SINK.observe_wire({"lc": 50})
            assert context.clock().value() == 0
        finally:
            metrics.configure(True)
        shim.SINK.observe_wire({"lc": 50})
        assert shim.SINK.wire_stamp() == {"lc": 52, "o": context.origin()}


SEARCH_PHASE = """
import sys
import namazu_tpu_torch_policy
from namazu_tpu import obs
from namazu_tpu.obs import spans
from namazu_tpu.policy import create_policy
from namazu_tpu.utils.config import Config

pol = create_policy(sys.argv[1])
pol.load_config(Config({"explore_policy_param": {"platform": "cpu"}}))
obs.configure(True)
with obs.search_phase("ingest"):
    pass
print(spans._trace_annotation_cls is False, "jax" in sys.modules)
"""


@pytest.mark.parametrize("policy,annotation_off,jax_imported", [
    ("torch_search", True, False),
    ("tpu_search", False, True),
])
def test_a_torch_search_phase_imports_no_jax(policy, annotation_off,
                                             jax_imported):
    # a fresh interpreter in which JAX is importable; ``-c`` puts the
    # working directory, the repository root, on its path
    out = subprocess.run([sys.executable, "-c", SEARCH_PHASE, policy],
                         cwd=REPO, env=dict(os.environ, JAX_PLATFORMS="cpu"),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split()[-2:] == [str(annotation_off),
                                       str(jax_imported)]
