"""``nmz-tpu sidecar`` on the PyTorch/CUDA port: the port's search sidecar
(``namazu_tpu_torch/sidecar.py``) as a member of the reference's
observability plane.

Run it from the repository root with the reference CLI's flags::

    python namazu_tpu_torch_sidecar.py --listen 127.0.0.1:10990 \\
        [--platform cpu] [--pool-dir DIR [--state-dir DIR]] \\
        [--telemetry-url tcp://host:port | uds:///path | http://host:port]

Over ``python -m namazu_tpu_torch.sidecar`` this adds what the
reference's ``serve_sidecar`` (``namazu_tpu/sidecar.py``) runs:

* the sidecar, its searches, their ingest and the hosted knowledge
  service and clients report to the reference's metrics registry
  (``namazu_tpu.obs``), under the reference's metric names and labels;
* the framed wire answers the observability ops ``telemetry``,
  ``fleet``, ``metrics`` and ``profile``
  (``namazu_tpu.obs.federation.handle_obs_op``), so ``nmz-tpu tools top
  --url tcp://host:port`` and ``tools profdiff`` read a port sidecar;
* the telemetry relay runs as job ``sidecar``, pushing every 2 s to
  ``--telemetry-url`` (default ``$NMZ_TELEMETRY_URL``), so the sidecar
  shows in a campaign's ``/fleet`` view;
* the continuous sampling profiler (``namazu_tpu.obs.profiling``, 10 ms)
  serves the ``profile`` op;
* the port's chaos seams (``namazu_tpu_torch/chaos.py``: the knowledge
  clients' ``knowledge.eof`` and ``knowledge.outage``, the knowledge
  service's ``storage.*`` writes) consult the reference's
  ``chaos.decide``, so a plan installed in this process
  (``namazu_tpu.chaos.install``) fires in them. Like the reference's
  ``nmz-tpu sidecar``, this one installs no plan from ``NMZ_CHAOS``.

``--platform`` names the device as the ``torch_search`` policy's
``platform`` knob does: ``""``, ``"gpu"`` or ``"cuda"`` (the default) is
the card and ``"cpu"`` the CPU; any other platform (``"tpu"`` included)
raises ``ValueError``, and the card without CUDA raises
``RuntimeError``.

This file and ``namazu_tpu_torch_policy.py`` are the port's only files
that import ``namazu_tpu``; neither imports JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import os
import sys
import threading

from namazu_tpu import chaos, obs
from namazu_tpu.obs import federation, profiling, spans
from namazu_tpu_torch import chaos as seams
from namazu_tpu_torch.device import DeviceLike
from namazu_tpu_torch.knowledge import KnowledgeService
from namazu_tpu_torch.policy.tpu import policy_device
from namazu_tpu_torch.sidecar import SidecarServer

log = logging.getLogger("namazu_tpu_torch.sidecar")


class ObsSink:
    """The reference's ``obs`` as the port's telemetry sink
    (``namazu_tpu_torch/obs.py``): every call goes to ``namazu_tpu.obs``,
    the collector calls, which that module does not carry, to
    ``obs.federation``, and the causality stamps to ``obs.context``
    while the reference's plane is on (``obs.metrics.enabled()``), as
    its framed server and knowledge client stamp. The phases only the
    port opens (``PORT_PHASES``, and the ingest's ``ingest_<section>``)
    stay off the plane, which keeps the series the reference reports.
    The ``torch_search`` policy shim hands in the same sink."""

    #: the sidecar's phases around its ingest and its checkpoint's save
    PORT_PHASES = ("ingest", "save")

    register_collector = staticmethod(federation.register_collector)
    unregister_collector = staticmethod(federation.unregister_collector)

    @staticmethod
    def search_phase(phase: str):
        if phase in ObsSink.PORT_PHASES or phase.startswith("ingest_"):
            return contextlib.nullcontext()
        return obs.search_phase(phase)

    @staticmethod
    def wire_stamp():
        return obs.context.wire_stamp() if obs.metrics.enabled() else None

    @staticmethod
    def observe_wire(ctx) -> None:
        if obs.metrics.enabled():
            obs.context.observe_wire(ctx)

    def __getattr__(self, name: str):
        return getattr(obs, name)


#: the sink this sidecar hands to the port
SINK = ObsSink()


def build_server(host: str, port: int, device: DeviceLike,
                 pool_dir: str = "", state_dir: str = "") -> SidecarServer:
    """The port's sidecar reporting to the reference's plane and
    answering its observability ops, with the knowledge service over
    ``pool_dir`` when one is given, and the port's chaos seams consulting
    the reference's plan; not started."""
    seams.set_decider(chaos.decide)
    knowledge = None
    if pool_dir:
        knowledge = KnowledgeService(pool_dir, state_dir=state_dir,
                                     device=device, telemetry=SINK)
        log.info("knowledge service enabled: pool %s", knowledge.pool_dir)
    return SidecarServer(host, port, device=device, knowledge=knowledge,
                         telemetry=SINK, obs_ops=federation.handle_obs_op)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python namazu_tpu_torch_sidecar.py",
        description="persistent search sidecar on the port, observed "
                    "(nmz-tpu sidecar)")
    ap.add_argument("--listen", default="127.0.0.1:10990",
                    help="host:port to serve on (default 127.0.0.1:10990)")
    ap.add_argument("--platform", default="",
                    help="device: empty, gpu or cuda = the card (the "
                         "default), cpu = the CPU")
    ap.add_argument("--pool-dir", default="",
                    help="global failure-pool directory: enables the "
                         "multi-tenant knowledge service; empty = search "
                         "ops only")
    ap.add_argument("--state-dir", default="",
                    help="knowledge-service state directory (default "
                         "<pool-dir>/_state)")
    ap.add_argument("--telemetry-url", default="",
                    help="push this process's metrics to a fleet "
                         "aggregator: http://host:port, uds:///path or "
                         "tcp://host:port. Defaults to $NMZ_TELEMETRY_URL")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s "
                               "%(message)s")
    device = policy_device(args.platform)
    # the reference's phase timer annotates jax.profiler when JAX is
    # importable; in the port's process the nmz:<phase> ranges do that,
    # so take its documented no-JAX fallback and never import JAX
    spans._trace_annotation_cls = False
    host, _, port = args.listen.rpartition(":")
    server = build_server(host or "127.0.0.1", int(port), device,
                          args.pool_dir, args.state_dir)
    server.start()
    federation.ensure_self_relay(
        "sidecar", push_url=(args.telemetry_url
                             or os.environ.get("NMZ_TELEMETRY_URL", "")))
    profiling.ensure_profiler("sidecar")
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
