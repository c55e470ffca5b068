"""Persistent search sidecar on the card: the port's counterpart of
``namazu_tpu/sidecar.py`` and ``namazu_tpu/cli/sidecar_cmd.py``.

The ``tpu_search`` policy of ``namazu_tpu``, configured with
``sidecar = "host:port"`` and a ``checkpoint``, sends its search request
over the framed JSON wire (``wire.py``) at the end of each run. This
process answers it with the port: it reads the experiment's storage
directory (``history.py``), runs the same ingest (``models/ingest.py``),
evolves on the card (``models/search.py``: the GA, with the fault half
and order mode, or the MCTS backend, built by ``policy/tpu.py`` as the
in-process ``torch_search`` policy builds it), saves the checkpoint in the
reference's keys and returns the table the policy installs. One search
is kept per experiment key, so a campaign's later requests are warm, and
so is one run cache (``models/ingest.py::RunCache``): a later request
reads and encodes only the runs stored or changed since the last.

Ops, with the reference's response shapes:

* ``{"op": "ping"}`` -> ``{"ok": true, "searches": N}``, plus
  ``"knowledge": true, "knowledge_v": 3`` when the knowledge service is
  hosted
* ``{"op": "search", "key", "storage", "search_params",
  "ingest_params", "generations", "checkpoint"}`` ->
  ``{"ok": true, "fitness", "delays", "faults", "generations_run"}``, or
  ``{"ok": true, "no_history": true, "generations_run"}``
* the knowledge ops (``pool_push``, ``pool_pull``, ``surrogate_predict``,
  ``stats``, ``triage_push``, ``triage_pull``) go to the hosted
  knowledge service (``knowledge/service.py``) when the sidecar was
  started with ``--pool-dir``, and are refused otherwise;
* the observability ops (``telemetry``, ``fleet``, ``metrics``,
  ``profile``) go to the ``obs_ops`` hook, asked before any other op;
  without one they are unknown ops.

The server, its search service and the searches it builds report to a
telemetry sink (``obs.py``; records nothing by default): each request by
op and outcome, as the reference's sidecar counts them, and the
searches' phases and rounds. ``namazu_tpu_torch_sidecar.py`` at the
repository root is the port's ``nmz-tpu sidecar``: it hands in the
reference's observability plane as the sink and the hook, and starts
its telemetry relay and sampling profiler.

Every knob of the policy's request is served: the fault half, order
mode, the MCTS backend, ``devices = N`` (N islands, one on each of the
first N cards, or N islands on the CPU; more cards than the machine has
answers ``ok: false`` with the mesh's error, never a smaller mesh),
causality guidance, the failure pool, the knowledge service (which may
be this sidecar itself: each connection has its own thread) and the
one-shot device trace. Run it with

    python -m namazu_tpu_torch.sidecar --listen 127.0.0.1:10990 \
        [--pool-dir DIR] [--device cpu]

or, observed, with ``python namazu_tpu_torch_sidecar.py`` (the same
flags as ``nmz-tpu sidecar``).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import threading
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from namazu_tpu_torch.device import DeviceLike, resolve_device
from namazu_tpu_torch.history import load_storage
from namazu_tpu_torch.knowledge import (
    KNOWLEDGE_OPS,
    KnowledgeService,
    shared_client,
)
from namazu_tpu_torch.models.ingest import (
    IngestParams,
    RunCache,
    ingest_history,
)
from namazu_tpu_torch.models.search import SearchBase
from namazu_tpu_torch.obs import NULL, Telemetry, search_phase
from namazu_tpu_torch.policy.tpu import (
    build_search,
    ingest_params,
    wire_remote_surrogate,
)
from namazu_tpu_torch.wire import FramedServer, request  # noqa: F401

log = logging.getLogger("namazu_tpu_torch.sidecar")


class Refused(Exception):
    """A search request the service answers with ``ok: false``."""


class SearchService:
    """One live search per experiment key, on one device."""

    def __init__(self, device: DeviceLike = "cuda",
                 telemetry: Telemetry = NULL):
        self.device = resolve_device(device)
        #: the sink of the requests and of every search built here
        self.telemetry = telemetry
        # key -> (params fingerprint, search)
        self._searches: Dict[str, Tuple[str, SearchBase]] = {}
        self._lock = threading.Lock()
        # one lock per key across ingest + evolve + save: a second request
        # for the same storage queues behind the one in flight
        self._key_locks: Dict[str, threading.Lock] = {}
        #: key -> seconds of the last search request's phases: ingest
        #: and its sections (ingest_read_encode, ingest_pool_io,
        #: ingest_guidance_observe, ingest_knowledge: the knowledge round
        #: trips, ingest_archive), of ingest_read_encode the storage's
        #: reads (ingest_read) and the runs' encoding (ingest_encode), run
        #: (evolve), of run the waits on the card (evolve_wait), the
        #: searching thread's CPU outside them (evolve_cpu) and the
        #: seconds capturing CUDA graphs (evolve_capture), rerank
        #: (surrogate train, candidate guidance and re-rank), save. The
        #: search phases ``ingest``, ``ingest_<section>`` and ``save``
        #: span the same sections on the telemetry sink.
        self.timings: Dict[str, Dict[str, float]] = {}
        #: key -> the last ingest's counts (runs_read: runs read from
        #: their files, runs_cached: runs taken from the key's run cache,
        #: warmstart_archive, warmstart_coverage, coverage_bits,
        #: one_sided)
        self.ingest_counts: Dict[str, Dict[str, int]] = {}
        # key -> its storage's runs as the last ingest read them, used
        # under the key's lock
        self._run_caches: Dict[str, RunCache] = {}

    def handle(self, req: dict) -> dict:
        op = req.get("op")
        if op == "ping":
            resp = {"ok": True, "searches": len(self._searches)}
        elif op == "search":
            try:
                resp = self._search(req)
            except Refused as e:
                resp = {"ok": False, "error": str(e)}
        else:
            resp = {"ok": False, "error": f"unknown op {op!r}"}
        self.telemetry.sidecar_request(str(op), bool(resp.get("ok")))
        return resp

    def search_for(self, key: str) -> Optional[SearchBase]:
        with self._lock:
            cached = self._searches.get(key)
        return None if cached is None else cached[1]

    def _get_search(self, key: str, params: dict, checkpoint: str):
        fp = json.dumps(params, sort_keys=True)
        with self._lock:
            cached = self._searches.get(key)
        if cached is not None and cached[0] == fp:
            search = cached[1]
            self._maybe_reload(search, checkpoint)
            return search
        try:
            search = build_search(params, self.device)
        except ValueError as e:  # e.g. more devices than cards
            raise Refused(f"search_params: {e}") from e
        search.telemetry = self.telemetry
        if checkpoint and os.path.exists(checkpoint):
            try:
                search.load(checkpoint)
                log.info("loaded checkpoint %s (gen %d)", checkpoint,
                         search.generations_run)
            except Exception:
                log.exception("checkpoint %s not loadable; fresh search",
                              checkpoint)
        with self._lock:
            self._searches[key] = (fp, search)
        return search

    def _maybe_reload(self, search: SearchBase, checkpoint: str) -> None:
        """Reload a cached search whose checkpoint on disk is ahead of it
        (the policy's in-process fallback ran and saved between two
        requests); serving the stale state would overwrite that work."""
        if not checkpoint or not os.path.exists(checkpoint):
            return
        try:
            with np.load(checkpoint) as z:
                disk_gen = (int(z["generations_run"])
                            if "generations_run" in z else -1)
        except Exception:
            return  # unreadable: keep the live state
        if disk_gen > search.generations_run:
            try:
                search.load(checkpoint)
                log.info("reloaded checkpoint %s: disk at gen %d",
                         checkpoint, disk_gen)
            except Exception:
                log.exception("newer checkpoint %s not loadable; keeping "
                              "the cached state", checkpoint)

    def _key_lock(self, key: str) -> threading.Lock:
        with self._lock:
            return self._key_locks.setdefault(key, threading.Lock())

    def _search(self, req: dict) -> dict:
        key = str(req.get("key") or req.get("storage") or "default")
        params = req.get("search_params") or {}
        ip = ingest_params(req.get("ingest_params") or {})
        with self._key_lock(key):
            return self._search_locked(key, req, params, ip)

    def _search_locked(self, key: str, req: dict, params: dict,
                       ip: IngestParams) -> dict:
        checkpoint = str(req.get("checkpoint") or "")
        search = self._get_search(key, params, checkpoint)
        storage_dir = req.get("storage")
        try:
            storage = load_storage(storage_dir) if storage_dir else None
        except Exception as e:
            return {"ok": False, "error": f"storage: {e}"}
        if ip.knowledge:
            # the candidate re-rank may consult the shared surrogate while
            # the local one is too thin, possibly over this sidecar's own
            # loopback (each connection has its own handler thread)
            wire_remote_surrogate(search, shared_client(
                ip.knowledge, tenant=ip.knowledge_tenant,
                scenario=ip.knowledge_scenario, telemetry=self.telemetry))
        stats: Dict[str, float] = {}
        with search_phase(self.telemetry, "ingest"):
            t0 = time.perf_counter()
            references = ingest_history(
                search, storage, ip, stats=stats,
                cache=self._run_caches.setdefault(key, RunCache()))
            t1 = time.perf_counter()
        self.ingest_counts[key] = {k: v for k, v in stats.items()
                                   if isinstance(v, int)}
        if not references:
            return {"ok": True, "no_history": True,
                    "generations_run": search.generations_run}
        best = search.run(references,
                          generations=int(req.get("generations", 64)))
        save = 0.0
        if checkpoint:
            with search_phase(self.telemetry, "save"):
                t2 = time.perf_counter()
                try:
                    search.save(checkpoint)
                except Exception:
                    log.exception("could not save checkpoint %s",
                                  checkpoint)
                save = time.perf_counter() - t2
        self.timings[key] = dict(
            {f"ingest_{k}": v for k, v in stats.items()
             if isinstance(v, float)},
            ingest=t1 - t0, run=search.last_run_seconds,
            evolve_wait=search.last_wait_seconds,
            evolve_cpu=search.last_cpu_seconds,
            evolve_capture=search.last_capture_seconds,
            rerank=search.last_rerank_seconds, save=save)
        return {
            "ok": True,
            "fitness": float(best.fitness),
            "delays": [float(x) for x in best.delays],
            "faults": [float(x) for x in best.faults],
            "generations_run": search.generations_run,
        }


class SidecarServer:
    """The search service, and the knowledge service when one is given,
    behind a keep-alive framed server. ``obs_ops(req)`` answers the
    observability ops: asked first, its answer other than ``None`` is
    returned as it is and not counted."""

    def __init__(self, host: str = "127.0.0.1", port: int = 10990,
                 device: DeviceLike = "cuda",
                 knowledge: Optional[KnowledgeService] = None,
                 telemetry: Telemetry = NULL,
                 obs_ops: Optional[Callable[[dict], Optional[dict]]] = None):
        self.service = SearchService(device, telemetry)
        self.knowledge = knowledge
        self.telemetry = telemetry
        self.obs_ops = obs_ops
        self._host, self._port = host, port
        self._srv: Optional[FramedServer] = None

    @property
    def port(self) -> int:
        assert self._srv is not None, "start the server first"
        return self._srv.port

    def start(self) -> None:
        srv = FramedServer(self._dispatch, name="sidecar",
                           telemetry=self.telemetry)
        srv.bind_tcp(self._host, self._port)
        srv.start()
        self._srv = srv
        log.info("search sidecar on %s:%d (%s)", self._host, self.port,
                 self.service.device)

    def shutdown(self) -> None:
        srv, self._srv = self._srv, None
        if srv is not None:
            srv.shutdown()
        if self.knowledge is not None:
            self.knowledge.close()

    def _dispatch(self, req: dict) -> dict:
        """Knowledge ops to the hosted service (an explicit refusal
        without one, so clients tell "no knowledge here" from a dead
        host), everything else to the search service; ``ping`` advertises
        the knowledge service only when one is hosted."""
        if self.obs_ops is not None:
            resp = self.obs_ops(req)
            if resp is not None:
                return resp
        op = req.get("op")
        if op in KNOWLEDGE_OPS:
            if self.knowledge is None:
                resp = {"ok": False,
                        "error": "knowledge service not configured "
                                 "(start the sidecar with --pool-dir)"}
            else:
                resp = self.knowledge.handle(req)
            self.telemetry.sidecar_request(str(op), bool(resp.get("ok")))
            return resp
        resp = self.service.handle(req)
        if op == "ping" and self.knowledge is not None:
            resp["knowledge"] = True
            resp["knowledge_v"] = self.knowledge.VERSION
        return resp


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m namazu_tpu_torch.sidecar",
        description="persistent search sidecar on the card",
        epilog="This entry records no telemetry and answers the "
               "observability ops (telemetry, fleet, metrics, profile) "
               "'unknown op'; namazu_tpu_torch_sidecar.py serves them, "
               "with the telemetry relay and the sampling profiler.")
    ap.add_argument("--listen", default="127.0.0.1:10990",
                    help="host:port to serve on (default 127.0.0.1:10990)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device of the search and of the knowledge "
                         "service's surrogates (default cuda)")
    ap.add_argument("--pool-dir", default="",
                    help="host the knowledge service over this failure "
                         "pool directory (default: not hosted)")
    ap.add_argument("--state-dir", default="",
                    help="the knowledge service's state directory "
                         "(default <pool-dir>/_state)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s "
                               "%(message)s")
    host, _, port = args.listen.rpartition(":")
    knowledge = None
    if args.pool_dir:
        knowledge = KnowledgeService(args.pool_dir,
                                     state_dir=args.state_dir,
                                     device=args.device)
        log.info("knowledge service enabled: pool %s", knowledge.pool_dir)
    server = SidecarServer(host or "127.0.0.1", int(port),
                           device=args.device, knowledge=knowledge)
    server.start()
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
