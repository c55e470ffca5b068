"""A fleet of campaigns, each a closed loop against the search sidecar.

A campaign stands for one ``tpu_search`` experiment whose policy has
``sidecar = "host:port"``: it has an experiment key, a naive storage and
a checkpoint path, and one keep-alive connection to the sidecar. It
repeats: wait its think time (the system under test's run), append the
run that just ended to its storage (a rename of a run written ahead, and
``next_run`` raised), send the search request the policy sends at its
defaults and wait for the answer. A request is timed from when it was
due, the end of the think time.

The traffic mix (``traffic/<mix>.json``) says how many campaigns run at
once (``campaigns``, one slot each), how many runs each starts with
(``stored_runs``), how many searches a campaign makes before it retires
and a fresh one takes its slot (``searches_per_campaign``; 0 = never),
the mean think time (``think_mean_s``), how
many runs each campaign has written ahead (``staged_runs``) and how
many campaigns a slot has ready (``campaigns_per_slot``), and how many
distinct histories the campaigns draw from (``distinct_histories``; 0 =
each its own; campaigns that share one hold hard links to its files).

Think times are uniform over 0.5 to 1.5 times the mean, stratified into
as many equal strata as there are slots: a seeded permutation gives each
slot a first stratum, and each slot then steps to the next stratum
(cyclically) at each think, so at every step the slots together think
once in each stratum; and the slots start at evenly spaced shares of
their first think time, in an order drawn from the seed. So every seed
offers the same load, in another order.

Right after each answer the campaign's thread keeps what the judgement
reads of the search behind it: the best fitness of each generation the
search just ran (``fit_curve``), and, for the requests drawn for the
check of the search (a share ``CHECK_SHARE`` of each campaign's, drawn
from the seed) and the requests just before them, the checkpoint the
service saved, as a hard link (the service replaces the file at the
next save, so the link keeps this one).
"""

from __future__ import annotations

import json
import os
import socket
import struct
import threading
import time
from typing import List, NamedTuple

import numpy as np

from searchbench import history

REQUEST_TIMEOUT_S = 300.0
#: the share of a campaign's requests whose search is checked
CHECK_SHARE = 0.25


class Client:
    """The policy's side of the framed JSON wire (a 4-byte little-endian
    length, then UTF-8 JSON) on one keep-alive connection."""

    def __init__(self, port: int):
        self.sock = socket.create_connection(("127.0.0.1", port),
                                             timeout=REQUEST_TIMEOUT_S)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def call(self, req: dict) -> dict:
        body = json.dumps(req).encode()
        self.sock.sendall(struct.pack("<I", len(body)) + body)
        (n,) = struct.unpack("<I", self._read(4))
        return json.loads(self._read(n))

    def _read(self, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("the sidecar closed the connection")
            buf += chunk
        return bytes(buf)

    def close(self) -> None:
        self.sock.close()


class Campaign(NamedTuple):
    id: int
    storage: str
    ahead: str
    checkpoint: str
    stored: int


def write_histories(work: str, hist: dict, seed: int, n_hist: int,
                    runs: int) -> List[str]:
    """``n_hist`` histories of ``runs`` runs each, under ``work``."""
    dirs = []
    for k in range(n_hist):
        d = os.path.join(work, "histories", f"h{k}")
        os.makedirs(d)
        for r in range(runs):
            history.write_run(os.path.join(d, f"{r:08x}"), hist, seed, k, r)
        dirs.append(d)
    return dirs


def link_campaign(work: str, cid: int, source: str, stored: int,
                  staged: int) -> Campaign:
    """Campaign ``cid``: a storage of the first ``stored`` runs of the
    history ``source`` and the next ``staged`` written ahead, as hard
    links to its files."""
    root = os.path.join(work, f"c{cid}")
    storage = os.path.join(root, "storage")
    ahead = os.path.join(root, "staged")
    for r in range(stored + staged):
        run = os.path.join(storage if r < stored else ahead, f"{r:08x}")
        os.makedirs(run)
        for name in ("trace.json", "result.json"):
            os.link(os.path.join(source, f"{r:08x}", name),
                    os.path.join(run, name))
    os.makedirs(storage, exist_ok=True)
    os.makedirs(ahead, exist_ok=True)
    history.write_next_run(storage, stored)
    return Campaign(cid, storage, ahead, os.path.join(root, "search.npz"),
                    stored)


class Fleet:
    """The campaigns of one run: written in set-up, warmed, then driven
    over the window by one thread a slot. ``records`` holds one dict a
    request, in the order the answers came."""

    def __init__(self, config: dict, traffic: dict, seed: int, work: str,
                 service):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.work, self.service = work, service
        self.hist = config["history"]
        self.slots = int(traffic["campaigns"])
        self.retire = int(traffic.get("searches_per_campaign", 0))
        per_slot = int(traffic.get("campaigns_per_slot", 1))
        stored = int(traffic["stored_runs"])
        staged = int(traffic["staged_runs"])
        n_camp = self.slots * per_slot
        distinct = int(traffic.get("distinct_histories", 0)) or n_camp
        sources = write_histories(work, self.hist, seed, distinct,
                                  stored + staged)
        self.queues: List[List[Campaign]] = [[] for _ in range(self.slots)]
        for cid in range(n_camp):
            c = link_campaign(work, cid, sources[cid % distinct], stored,
                              staged)
            self.queues[cid % self.slots].append(c)
        # the warm campaigns: the starting ones, or, where campaigns
        # retire (each search of a fresh campaign is part of the mix),
        # one more a slot that the window never sends
        if self.retire:
            self.warm_set = [link_campaign(work, n_camp + s, sources[s %
                                           distinct], stored, staged)
                             for s in range(self.slots)]
        else:
            self.warm_set = [q[0] for q in self.queues]
        self.records: List[dict] = []
        self.exhausted = 0
        self._lock = threading.Lock()

    # -- requests ----------------------------------------------------------

    def request_of(self, c: Campaign) -> dict:
        return {
            "op": "search", "key": c.storage, "storage": c.storage,
            "search_params": self.config["search_params"],
            "ingest_params": self.config["ingest_params"],
            "generations": int(self.config["generations"]),
            "checkpoint": c.checkpoint,
        }

    def checked(self, c: Campaign, index: int) -> bool:
        """Whether the search of campaign ``c``'s request ``index`` (0 =
        its first) is checked: drawn from the seed, never the first."""
        draw = np.random.default_rng([self.seed, 0xC4EC, c.id, index])
        return index > 0 and draw.random() < CHECK_SHARE

    def _send(self, client: Client, c: Campaign, runs: int, index: int,
              due: float, warm: bool) -> dict:
        sent = time.perf_counter()
        try:
            resp = client.call(self.request_of(c))
        except (OSError, ValueError, ConnectionError) as e:
            resp = {"ok": False, "error": f"no answer: {e!r}"}
        reply = time.perf_counter()
        search = self.service.search_for(c.storage)
        kept = None
        if self.checked(c, index) or self.checked(c, index + 1):
            kept = os.path.join(os.path.dirname(c.checkpoint),
                                f"kept-{index}.npz")
            try:
                os.link(c.checkpoint, kept)
            except OSError:
                kept = None
        rec = {
            "campaign": c.id, "key": c.storage, "runs": runs,
            "index": index, "checked": self.checked(c, index),
            "failures": sum(history.is_failure(self.hist, r)
                            for r in range(runs)),
            "due": due, "sent": sent, "reply": reply, "warm": warm,
            "ok": bool(resp.get("ok")) and "fitness" in resp,
            "answer": resp,
            "timings": dict(self.service.timings.get(c.storage, {})),
            "fit_curve": (None if search is None
                          else list(getattr(search, "last_fit_curve", []))),
            "checkpoint": kept,
        }
        with self._lock:
            self.records.append(rec)
        return rec

    def warm_up(self, port: int) -> List[dict]:
        """One request for each warm campaign, one after another (at
        once they would only wait on each other); returns their
        records."""
        out = []
        for c in self.warm_set:
            client = Client(port)
            try:
                out.append(self._send(client, c, c.stored, 0,
                                      time.perf_counter(), warm=True))
            finally:
                client.close()
        return out

    # -- the window --------------------------------------------------------

    def start(self, port: int, t_start: float, t_end: float) -> list:
        """Drive every slot, each on its own thread, from ``t_start``:
        requests due before ``t_end`` are sent, and a slot then waits for
        its last answer. Returns the threads."""
        threads = [threading.Thread(target=self._slot,
                                    args=(s, port, t_start, t_end),
                                    daemon=True)
                   for s in range(self.slots)]
        for t in threads:
            t.start()
        return threads

    @staticmethod
    def join(threads: list, deadline: float) -> bool:
        """Wait for the slots until ``deadline``; False when one has not
        ended by then."""
        for t in threads:
            t.join(max(0.0, deadline - time.perf_counter()))
        return not any(t.is_alive() for t in threads)

    def _slot(self, slot: int, port: int, t_start: float,
              t_end: float) -> None:
        mean = float(self.traffic["think_mean_s"])
        n = self.slots
        strata = mean * (0.5 + (np.arange(n) + 0.5) / n)
        step = [int(np.random.default_rng([self.seed, 0x7117]).permutation(
            n)[slot])]
        start = np.random.default_rng([self.seed, 0x57A7]).permutation(
            n)[slot]

        def think() -> float:
            step[0] += 1
            return float(strata[step[0] % n])

        queue = list(self.queues[slot])
        if self.retire == 0:
            queue = queue[:1]
        c = queue.pop(0)
        client = Client(port)
        runs, searches = c.stored, 0
        # a long-lived campaign's first request of the window follows its
        # warm one
        index = 0 if self.retire else 1
        due = t_start + (start + 0.5) / self.slots * think()
        try:
            while True:
                time.sleep(max(0.0, due - time.perf_counter()))
                if due >= t_end:
                    return
                if history.append_run(c.storage, c.ahead, runs):
                    runs += 1
                else:
                    with self._lock:
                        self.exhausted += 1
                rec = self._send(client, c, runs, index, due, warm=False)
                searches += 1
                index += 1
                if self.retire and searches >= self.retire:
                    client.close()
                    if not queue:
                        with self._lock:
                            self.exhausted += 1
                        return
                    c = queue.pop(0)
                    client = Client(port)
                    runs, searches, index = c.stored, 0, 0
                due = rec["reply"] + think()
        finally:
            client.close()
