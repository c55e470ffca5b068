"""Campaign-side knowledge client: the port's own copy of
``namazu_tpu/knowledge/client.py``, over the port's framed wire.

A knowledge outage never fails a campaign: every op returns ``None``
instead of raising when the service is unreachable, hung or refuses the
op, and callers read ``None`` as "search locally". The first failure
logs one warning and opens a cooldown during which every op returns
``None`` at once; the next op after it probes again, so a restarted
service is picked up, and the content-keyed pool dedupes the re-pushed
backlog. This contract covers the remote service only: nothing here
touches a device, so no device or kernel error can be hidden by it.

Transport: one keep-alive connection, with one transparent retry on a
fresh socket when an established one breaks (a service restarted
between two runs); a refused connection or a timeout opens the cooldown
at once.

What a client sees is counted in its ``counts``: ops sent and answered,
outages, retries on a fresh socket, entries pushed, deduplicated and
pulled, and predictions asked and served by a trained model. It also
reports to its telemetry sink (``namazu_tpu_torch/obs.py``) where the
reference's client reports to ``obs``: each push, pull, outage and
dossier pull; each op frame carries the sink's causality stamp
(``ctx``; none from the default sink) and the answer's stamp is merged
back. It consults the chaos seam (``namazu_tpu_torch/chaos.py``)
where the reference's client consults its plan: ``knowledge.eof`` after
each request frame is written (the socket is dropped, as by a service
dying mid-reply, and the retry runs) and ``knowledge.outage`` before
each round trip (as if the port were closed: the cooldown opens).
"""

from __future__ import annotations

import hashlib
import logging
import socket
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from namazu_tpu_torch import chaos
from namazu_tpu_torch.models.failure_pool import (
    MAX_LOAD,
    entries_to_pool_entries,
)
from namazu_tpu_torch.obs import NULL, Telemetry
from namazu_tpu_torch.wire import read_frame, write_frame

log = logging.getLogger("namazu_tpu_torch.knowledge.client")

#: knowledge wire version (the reference's): v2 added the
#: relation-coverage fields, v3 the triage dossier ops
WIRE_VERSION = 3

def pairs_fingerprint(pairs) -> str:
    """Content fingerprint of a search's precedence-pair sample: surrogate
    features compare only between searches with the same pairs, so it
    scopes the service's example stores."""
    a = np.ascontiguousarray(np.asarray(pairs))
    h = hashlib.sha256()
    h.update(str(a.shape).encode())
    h.update(a.tobytes())
    return h.hexdigest()[:16]


class KnowledgeClient:
    #: seconds an outage silences the client before the next probe
    COOLDOWN_S = 30.0

    def __init__(self, addr: str, tenant: str = "", scenario: str = "",
                 timeout: float = 15.0,
                 cooldown_s: float = COOLDOWN_S,
                 telemetry: Telemetry = NULL) -> None:
        host, _, port = addr.rpartition(":")
        self._host = host or "127.0.0.1"
        self._port = int(port)
        self.addr = addr
        self.tenant = tenant or "anon"
        self.scenario = scenario
        self.timeout = timeout
        self.cooldown_s = cooldown_s
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()
        self._down_until = 0.0
        self._warned = False
        #: what this client has seen, by name (see the module docstring)
        self.counts: Dict[str, int] = {}
        self._counts_lock = threading.Lock()
        self.telemetry = telemetry

    def _count(self, name: str, n: int = 1) -> None:
        with self._counts_lock:
            self.counts[name] = self.counts.get(name, 0) + int(n)

    # -- transport --------------------------------------------------------

    def _connect(self) -> socket.socket:
        s = socket.create_connection((self._host, self._port),
                                     timeout=self.timeout)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return s

    def _close_sock(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def close(self) -> None:
        with self._lock:
            self._close_sock()

    def _roundtrip(self, req: dict) -> dict:
        """One request/response on the keep-alive connection. A broken
        established socket gets one retry on a fresh one; a refused
        connection or a timeout raises at once. Caller holds the lock."""
        for attempt in (0, 1):
            if self._sock is None:
                self._sock = self._connect()
            try:
                write_frame(self._sock, req)
                if chaos.decide("knowledge.eof") is not None:
                    self._close_sock()
                    raise ConnectionResetError("chaos: mid-stream EOF")
                resp = read_frame(self._sock)
                if resp is None:
                    raise ConnectionError("connection closed mid-reply")
                return resp
            except (socket.timeout, TimeoutError) as e:
                self._close_sock()
                raise ConnectionError(f"timeout: {e}") from e
            except (OSError, ValueError) as e:
                self._close_sock()
                if attempt:
                    raise ConnectionError(str(e)) from e
                self._count("retries")
        raise AssertionError("unreachable")

    def _request(self, req: dict) -> Optional[dict]:
        """Send one op; ``None`` = degraded (an outage, or the service
        refused the op). Never raises."""
        req = dict(req, v=WIRE_VERSION, tenant=self.tenant,
                   scenario=req.get("scenario", self.scenario))
        stamp = self.telemetry.wire_stamp()
        if stamp is not None:
            # the service merges our clock and answers a stamp of its
            # own, merged below
            req.setdefault("ctx", stamp)
        with self._lock:
            if time.monotonic() < self._down_until:
                return None
            self._count("requests")
            if chaos.decide("knowledge.outage") is not None:
                self._mark_outage("chaos: injected outage")
                return None
            try:
                resp = self._roundtrip(req)
            except Exception as e:
                self._mark_outage(f"unreachable ({e})")
                return None
            if not resp.get("ok"):
                # a refused op (no --pool-dir, an older service) is as
                # dead as a closed port: cool down instead of re-asking
                self._mark_outage(resp.get("error", "request refused"))
                return None
            self._down_until = 0.0
            self._warned = False
            self._count("answered")
            self.telemetry.observe_wire(resp.get("ctx"))
            return resp

    def _mark_outage(self, why: str) -> None:
        self._down_until = time.monotonic() + self.cooldown_s
        self._close_sock()
        self._count("outages")
        self.telemetry.knowledge_outage()
        if not self._warned:
            self._warned = True
            log.warning("knowledge service %s %s; degrading to local-only "
                        "search (re-probing in %.0fs; an outage never fails "
                        "a campaign)", self.addr, why, self.cooldown_s)
        else:
            log.debug("knowledge service %s still down: %s", self.addr, why)

    def available(self) -> bool:
        """Whether the client is out of its cooldown (no wire traffic)."""
        return time.monotonic() >= self._down_until

    # -- ops --------------------------------------------------------------

    def push(self, entries: Sequence[dict] = (),
             best: Optional[dict] = None,
             examples: Sequence[dict] = (),
             pairs_fp: str = "",
             coverage: Optional[dict] = None) -> Optional[dict]:
        """Send failure signatures, a best table, labeled surrogate
        examples and/or a relation-coverage signature; the response, or
        ``None`` when degraded."""
        if not entries and best is None and not examples \
                and coverage is None:
            return {"ok": True, "accepted": 0, "duplicates": 0}
        req: Dict = {"op": "pool_push", "entries": list(entries)}
        if best is not None:
            req["best"] = best
        if coverage is not None:
            req["coverage"] = coverage
        if examples:
            req["examples"] = list(examples)
            req["pairs_fp"] = pairs_fp
        resp = self._request(req)
        if resp is not None:
            self._count("pushed_entries", resp.get("accepted", 0))
            self._count("push_duplicates", resp.get("duplicates", 0))
        self.telemetry.knowledge_push(
            resp is not None, accepted=(resp or {}).get("accepted", 0),
            duplicates=(resp or {}).get("duplicates", 0))
        return resp

    def pull(self, H: int, exclude: Sequence[str] = (),
             max_entries: int = MAX_LOAD,
             coverage_space: Optional[dict] = None
             ) -> Optional[Tuple]:
        """Warm-start material, ``(pool entries, scenario table)``, or
        ``None`` when degraded (``([], None)`` is a healthy, empty
        service). With ``coverage_space`` (``{"H", "w", "win"}``) the same
        round trip fetches the scenario's pooled coverage bits of exactly
        that space as a third element (``[]`` when none)."""
        req = {"op": "pool_pull", "H": int(H), "exclude": list(exclude),
               "max_entries": int(max_entries)}
        if coverage_space is not None:
            req["coverage_space"] = dict(coverage_space)
        resp = self._request(req)
        if resp is None:
            self.telemetry.knowledge_pull(False)
            return None
        entries = entries_to_pool_entries(resp.get("entries") or [], H)
        self._count("pulled_entries", len(entries))
        self.telemetry.knowledge_pull(True)
        table = resp.get("scenario_table")
        if table is not None:
            try:
                delays = np.asarray(table["delays"], np.float32)
                if delays.shape != (int(H),):
                    table = None
                else:
                    table = {"delays": delays,
                             "fitness": float(table["fitness"])}
            except (KeyError, TypeError, ValueError):
                table = None
        if coverage_space is None:
            return entries, table
        cov = resp.get("coverage")
        bits: List[int] = []
        if isinstance(cov, dict):
            try:
                bits = [int(b) for b in cov.get("bits", [])]
            except (TypeError, ValueError):
                bits = []
        return entries, table, bits

    def scenario_table(self, H: int) -> Optional[dict]:
        """The scenario's best delay table (a pull with no entries)."""
        pulled = self.pull(H, max_entries=0)
        return pulled[1] if pulled is not None else None

    def pull_coverage(self, H: int, width: int,
                      window: int) -> Optional[List[int]]:
        """The scenario's pooled coverage bits of exactly this (H, width,
        window) space; ``None`` when degraded, ``[]`` when none pooled."""
        pulled = self.pull(0, max_entries=0,
                           coverage_space={"H": int(H), "w": int(width),
                                           "win": int(window)})
        return pulled[2] if pulled is not None else None

    def predict(self, feats: np.ndarray,
                pairs_fp: str = "") -> Optional[np.ndarray]:
        """The shared surrogate's P(reproduce) per feature vector; ``None``
        when degraded or when no model of this feature space has trained
        (the caller keeps its own pick)."""
        feats = np.asarray(feats, np.float32)
        resp = self._request({
            "op": "surrogate_predict", "pairs_fp": pairs_fp,
            "feats": [[float(x) for x in row] for row in feats],
        })
        self._count("predicts")
        if resp is None or not resp.get("trained"):
            return None
        probs = np.asarray(resp.get("probs") or [], np.float32)
        if probs.shape != (feats.shape[0],):
            return None
        self._count("predicts_trained")
        return probs

    def triage_push(self, dossier: dict) -> Optional[dict]:
        """Attach one minimized-reproducer dossier to its failure
        signature; the response, or ``None`` when degraded."""
        if not isinstance(dossier, dict) or not dossier.get("signature"):
            return None
        return self._request({"op": "triage_push", "dossier": dossier})

    def triage_pull(self, signature: str) -> Optional[dict]:
        """The dossier pooled for one failure signature; ``None`` when
        degraded or when none is pooled."""
        resp = self._request({"op": "triage_pull",
                              "signature": str(signature)})
        self.telemetry.triage_dossier_pull(
            resp is not None and resp.get("dossier") is not None)
        return resp.get("dossier") if resp is not None else None

    def stats(self) -> Optional[dict]:
        return self._request({"op": "stats"})


# -- per-process shared clients -------------------------------------------

_clients: Dict[Tuple[str, str, str], KnowledgeClient] = {}
_clients_lock = threading.Lock()


def shared_client(addr: str, tenant: str = "", scenario: str = "",
                  telemetry: Telemetry = NULL) -> KnowledgeClient:
    """One client per (addr, tenant, scenario) per process, so ingest and
    the remote surrogate share a connection and an outage cooldown; it
    reports to the sink of the call that created it."""
    key = (addr, tenant or "anon", scenario)
    with _clients_lock:
        client = _clients.get(key)
        if client is None:
            client = _clients[key] = KnowledgeClient(
                addr, tenant=key[1], scenario=scenario,
                telemetry=telemetry)
        return client
