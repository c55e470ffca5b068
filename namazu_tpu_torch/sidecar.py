"""Persistent search sidecar on the card: the port's counterpart of
``namazu_tpu/sidecar.py`` and ``namazu_tpu/cli/sidecar_cmd.py``.

The ``tpu_search`` policy of ``namazu_tpu``, configured with
``sidecar = "host:port"`` and a ``checkpoint``, sends its search request
over the framed JSON wire (``wire.py``) at the end of each run. This
process answers it with the port: it reads the experiment's storage
directory (``history.py``), runs the same ingest (``models/ingest.py``),
evolves on the card (``models/search.py``: the GA, with the fault half
and order mode, or the MCTS backend), saves the checkpoint in the
reference's keys and returns the table the policy installs. One search
is kept per experiment key, so a campaign's later requests are warm.

Ops, with the reference's response shapes:

* ``{"op": "ping"}`` -> ``{"ok": true, "searches": N}``
* ``{"op": "search", "key", "storage", "search_params",
  "ingest_params", "generations", "checkpoint"}`` ->
  ``{"ok": true, "fitness", "delays", "faults", "generations_run"}``, or
  ``{"ok": true, "no_history": true, "generations_run"}``
* the knowledge ops are answered ``ok: false``, as a reference sidecar
  started without ``--pool-dir`` answers them.

``devices = N`` runs the search over N islands, one on each of the
first N cards (on ``--device cpu``, N islands on the CPU); more cards
than the machine has answers ``ok: false`` with the mesh's error, never
a smaller mesh. Params the port cannot honour (causality guidance, a
device-trace directory, the failure pool, the knowledge service) are
refused with ``{"ok": false, "error": "namazu_tpu_torch: <what> is not
ported yet"}``; the policy then falls back to its own in-process search.
Run it with

    python -m namazu_tpu_torch.sidecar --listen 127.0.0.1:10990

(``--device cpu`` without a card).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np

from namazu_tpu_torch.device import DeviceLike, resolve_device
from namazu_tpu_torch.history import load_storage
from namazu_tpu_torch.models.ga import GAConfig
from namazu_tpu_torch.models.ingest import (
    IngestParams,
    ingest_history,
    unported,
)
from namazu_tpu_torch.models.mcts import MCTSConfig
from namazu_tpu_torch.models.search import (
    MCTSSearch,
    ScheduleSearch,
    SearchConfig,
    SearchBase,
    make_score_weights,
)
from namazu_tpu_torch.parallel.mesh import IslandMesh
from namazu_tpu_torch.wire import FramedServer, request  # noqa: F401

log = logging.getLogger("namazu_tpu_torch.sidecar")

#: the reference sidecar's knowledge-plane ops (served with --pool-dir)
KNOWLEDGE_OPS = ("pool_push", "pool_pull", "surrogate_predict", "stats",
                 "triage_push", "triage_pull")


class Refused(Exception):
    """A search request the service answers with ``ok: false``."""


class Unported(Refused, NotImplementedError):
    def __init__(self, what: str):
        super().__init__(f"namazu_tpu_torch: {what} is not ported yet")


def _unported_search_params(p: dict) -> Optional[str]:
    if p.get("guidance"):
        return "causality guidance (guidance)"
    if p.get("device_trace_dir"):
        return "the device-trace capture (device_trace_dir)"
    return None


def build_search_from_params(p: dict, device: DeviceLike = "cuda",
                             mesh: Optional[IslandMesh] = None
                             ) -> SearchBase:
    """A search from the policy's flat params dict (the reference
    policy's ``_search_params``), with the reference sidecar's defaults:
    the GA, or with ``search_backend = "mcts"`` the MCTS backend, over
    ``mesh`` or ``devices`` islands (``make_mesh(devices)`` on
    ``device``; one by default); raises :class:`Unported` for a knob the
    port cannot honour and ``ValueError`` for more cards than there
    are."""
    what = _unported_search_params(p)
    if what is not None:
        raise Unported(what)
    weights = make_score_weights(
        release_mode=p.get("release_mode", "delay"),
        w_novelty=p.get("w_novelty", 1.0),
        w_bug=p.get("w_bug", 1.0),
        w_delay_cost=p.get("w_delay_cost", 0.01),
        w_fault_cost=p.get("w_fault_cost", 0.05),
        tau=p.get("tau", 0.005),
        reorder_gap=p.get("reorder_gap", 0.002),
        reorder_window=p.get("reorder_window", 0.05),
    )
    cfg = SearchConfig(
        H=p.get("H", 256), L=p.get("L", 0), K=p.get("K", 256),
        population=p.get("population", 4096),
        migrate_k=p.get("migrate_k", 8),
        seed=p.get("seed", 0),
        ga=GAConfig(max_delay=p.get("max_interval", 0.1),
                    max_fault=p.get("max_fault", 0.0)),
        weights=weights,
        surrogate_topk=p.get("surrogate_topk", 16),
        min_failure_signatures=p.get("min_failure_signatures", 0),
        novelty_floor=p.get("novelty_floor", 0.25),
        guidance_bonus=p.get("guidance_bonus", 0.5),
        fused=bool(p.get("fused", True)),
        fused_chunk=int(p.get("fused_chunk", 16)),
        migrate_every=int(p.get("migrate_every", 1)),
        dcn_migrate_every=int(p.get("dcn_migrate_every", 1)),
    )
    n_devices = p.get("devices")
    if p.get("search_backend", "ga") == "mcts":
        mcts_cfg = MCTSConfig(
            tree_depth=p.get("mcts_tree_depth", 24),
            n_levels=p.get("mcts_levels", 8),
            simulations=p.get("mcts_simulations", 256),
            rollouts=p.get("mcts_rollouts", 64),
            max_delay=p.get("max_interval", 0.1),
            max_fault=p.get("max_fault", 0.0),
        )
        return MCTSSearch(cfg, mcts_cfg=mcts_cfg, mesh=mesh,
                          n_devices=n_devices, device=device)
    return ScheduleSearch(cfg, mesh=mesh, n_devices=n_devices,
                          device=device)


class SearchService:
    """One live search per experiment key, on one device."""

    def __init__(self, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        # key -> (params fingerprint, search)
        self._searches: Dict[str, Tuple[str, SearchBase]] = {}
        self._lock = threading.Lock()
        # one lock per key across ingest + evolve + save: a second request
        # for the same storage queues behind the one in flight
        self._key_locks: Dict[str, threading.Lock] = {}
        #: key -> seconds of the last search request's phases: ingest,
        #: run (evolve), rerank (surrogate train + re-rank), save
        self.timings: Dict[str, Dict[str, float]] = {}

    def handle(self, req: dict) -> dict:
        op = req.get("op")
        if op == "ping":
            return {"ok": True, "searches": len(self._searches)}
        if op == "search":
            try:
                return self._search(req)
            except Refused as e:
                return {"ok": False, "error": str(e)}
        if op in KNOWLEDGE_OPS:
            return {"ok": False,
                    "error": "knowledge service not configured "
                             "(namazu_tpu_torch serves search ops only)"}
        return {"ok": False, "error": f"unknown op {op!r}"}

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
            search = build_search_from_params(params, self.device)
        except ValueError as e:  # e.g. more devices than cards
            raise Refused(f"search_params: {e}") from e
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
        ip = IngestParams(**{k: v for k, v in
                             (req.get("ingest_params") or {}).items()
                             if k in IngestParams._fields})
        what = unported(ip)  # search params: build_search_from_params
        if what is not None:
            raise Unported(what)
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
        t0 = time.perf_counter()
        references = ingest_history(search, storage, ip)
        t1 = time.perf_counter()
        if not references:
            return {"ok": True, "no_history": True,
                    "generations_run": search.generations_run}
        best = search.run(references,
                          generations=int(req.get("generations", 64)))
        t2 = time.perf_counter()
        if checkpoint:
            try:
                search.save(checkpoint)
            except Exception:
                log.exception("could not save checkpoint %s", checkpoint)
        self.timings[key] = {
            "ingest": t1 - t0, "run": search.last_run_seconds,
            "rerank": search.last_rerank_seconds,
            "save": time.perf_counter() - t2,
        }
        return {
            "ok": True,
            "fitness": float(best.fitness),
            "delays": [float(x) for x in best.delays],
            "faults": [float(x) for x in best.faults],
            "generations_run": search.generations_run,
        }


class SidecarServer:
    """The search service behind a keep-alive framed server."""

    def __init__(self, host: str = "127.0.0.1", port: int = 10990,
                 device: DeviceLike = "cuda"):
        self.service = SearchService(device)
        self._host, self._port = host, port
        self._srv: Optional[FramedServer] = None

    @property
    def port(self) -> int:
        assert self._srv is not None, "start the server first"
        return self._srv.port

    def start(self) -> None:
        srv = FramedServer(self.service.handle, name="sidecar")
        srv.bind_tcp(self._host, self._port)
        srv.start()
        self._srv = srv
        log.info("search sidecar on %s:%d (%s)", self._host, self.port,
                 self.service.device)

    def shutdown(self) -> None:
        srv, self._srv = self._srv, None
        if srv is not None:
            srv.shutdown()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m namazu_tpu_torch.sidecar",
        description="persistent search sidecar on the card")
    ap.add_argument("--listen", default="127.0.0.1:10990",
                    help="host:port to serve on (default 127.0.0.1:10990)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device of the search (default cuda)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s "
                               "%(message)s")
    host, _, port = args.listen.rpartition(":")
    server = SidecarServer(host or "127.0.0.1", int(port),
                           device=args.device)
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
