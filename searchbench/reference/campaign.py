"""A campaign's search state, worked out again from its storage, and the
judgement of the answers the search service gave it.

Each search request re-reads the campaign's storage. The reading fixes
the feature pairs (over the buckets that occur in any visible run; when
they change, both archives and the best-so-far start over), appends
every visible run's realized-view features, labeled with its outcome, to
the archive ring (``archive_size`` rows, neutral 0.5 rows until written;
it is not emptied between requests), appends each failure whose content
(bucket and entity sequence) it has not seen to the failure ring
(``failure_size`` rows), and takes the newest ``max_reference_traces``
runs that passed (the failures when none passed) as the references, in
their arrival view.

An answer's table is scored against the state of its own request when
the service re-ranks (once each outcome holds at least three labeled
archive rows); otherwise the service returns its best-so-far, scored
against the state of some request since the last start-over, and the
nearest of those is taken.

The search itself is checked from two checkpoints of a campaign, the one
saved after the request before (the population the search starts from)
and the one saved after the request (the population it ends with), and
the best fitness of each generation it ran (``check_search``). A
generation scores every genome, and its best genomes (the elite, in
order) pass unchanged into the next population; the request's seed
genomes (the newest failures' tables, at most ``MAX_SEEDS``) replace
evenly spaced rows before the first generation. So, against the
request's state: the first generation's best is at least the fitness of
every row of the starting population that no seed genome replaced; the
first row of the final population is the last generation's best, with
its fitness; and the final population holds few rows of the starting
one.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, NamedTuple, Optional

import numpy as np

from searchbench.reference import score
from searchbench.reference.encode import Reader, Run, visible_runs

#: labeled runs each outcome needs before the service re-ranks
MIN_CLASS_EXAMPLES = 3
#: the most seed genomes a request writes into the population
MAX_SEEDS = 16


class State(NamedTuple):
    pairs: np.ndarray
    archive: np.ndarray  # f64[archive_size, K]
    failures: np.ndarray  # f64[failure_size, K]
    refs: list  # [(buckets, arrival)]
    reranks: bool  # the service re-ranks with its surrogate
    epoch: int  # start-overs so far


class Campaign:
    """The reference's copy of one campaign's search state."""

    def __init__(self, reader: Reader, search_params: dict,
                 ingest_params: dict, archive_size: int = 512,
                 failure_size: int = 64):
        sp, ip = search_params, ingest_params
        self.reader = reader
        self.H, self.K = int(sp.get("H", 256)), int(sp.get("K", 256))
        self.seed = int(sp.get("seed", 0))
        self.w = score.weights_of(sp)
        self.rerank = int(sp.get("surrogate_topk", 16)) > 0
        self.max_refs = int(ip.get("max_reference_traces", 4))
        if int(ip.get("L", 0)) > 0:
            self.cap: Optional[int] = int(ip["L"])
        elif ip.get("release_mode", "delay") == "reorder":
            self.cap = int(ip.get("order_mode_max_l", 4096))
        else:
            self.cap = None
        self.runs: Dict[int, Run] = {}
        self.pairs: Optional[np.ndarray] = None
        self.archive = np.full((archive_size, self.K), 0.5)
        self.labels = np.zeros(archive_size)
        self.archive_n = 0
        self.failures = np.full((failure_size, self.K), 0.5)
        self.failure_n = 0
        self.digests: List[str] = [""] * failure_size
        self.epoch = 0
        self._feats: Dict[int, np.ndarray] = {}

    def _run(self, storage: str, i: int) -> Optional[Run]:
        if i not in self.runs:
            self.runs[i] = self.reader.run(storage, i, self.cap)
        return self.runs[i]

    def _features(self, i: int) -> np.ndarray:
        if i not in self._feats:
            r = self.runs[i]
            self._feats[i] = score.run_features(
                r.buckets, r.realized, self.pairs, self.w, self.H)
        return self._feats[i]

    @staticmethod
    def _digest(r: Run) -> str:
        h = hashlib.sha256()
        h.update(r.buckets.astype(np.int32).tobytes())
        h.update(r.entities.astype(np.int32).tobytes())
        return h.hexdigest()

    def ingest(self, storage: str, next_run: int) -> State:
        """The state after the service read ``storage`` holding
        ``next_run`` runs."""
        runs = [(i, r) for i in visible_runs(storage, next_run)
                if (r := self._run(storage, i)) is not None]
        occupied = {int(b) for _, r in runs for b in r.buckets}
        pairs = score.pairs_over(occupied, self.K, self.H, self.seed)
        if self.pairs is None or not np.array_equal(pairs, self.pairs):
            self.pairs = pairs
            self._feats = {}
            self.archive[:] = 0.5
            self.labels[:] = 0.0
            self.archive_n = 0
            self.failures[:] = 0.5
            self.failure_n = 0
            self.digests = [""] * len(self.digests)
            self.epoch += 1
        size, fsize = self.archive.shape[0], self.failures.shape[0]
        for i, r in runs:
            slot = self.archive_n % size
            self.archive[slot] = self._features(i)
            self.labels[slot] = 0.0 if r.ok else 1.0
            self.archive_n += 1
            if r.ok:
                continue
            dg = self._digest(r)
            if dg in self.digests:
                continue
            slot = self.failure_n % fsize
            self.failures[slot] = self._features(i)
            self.digests[slot] = dg
            self.failure_n += 1
        ok = [r for _, r in runs if r.ok]
        pool = ok if ok else [r for _, r in runs if not r.ok]
        refs = [(r.buckets, r.arrival) for r in pool[::-1][: self.max_refs]]
        labels = self.labels[: min(self.archive_n, size)]
        pos = int((labels > 0.5).sum())
        reranks = self.rerank and min(pos, len(labels) - pos) \
            >= MIN_CLASS_EXAMPLES
        return State(self.pairs.copy(), self.archive.copy(),
                     self.failures.copy(), refs, reranks, self.epoch)

    def fitness(self, state: State, tables: np.ndarray,
                precision: str = "f64") -> np.ndarray:
        return score.fitness(tables, state.refs, state.pairs, state.archive,
                             state.failures, self.w, self.H, precision)


def judge(campaign: Campaign, states: List[State], answer: dict,
          precision: str = "f64") -> float:
    """``|returned fitness - the reference's fitness of the returned
    table|`` for the answer to the last of ``states`` (one a request of
    this campaign, in order); with the best-so-far, the least such gap
    over the requests since the last start-over."""
    table = np.asarray(answer["delays"], np.float32)[None]
    now = states[-1]
    if now.reranks:
        cands = [now]
    else:
        cands = [s for s in states if s.epoch == now.epoch]
    return min(abs(float(answer["fitness"])
                   - float(campaign.fitness(s, table, precision)[0]))
               for s in cands)


def seed_rows(P: int, most: int = MAX_SEEDS) -> np.ndarray:
    """Every row a request's seed genomes may replace: with ``n`` seeds,
    rows ``i * (P // n)`` for ``i < n``, over every ``n`` up to
    ``most``."""
    rows = {min(i * max(1, P // n), P - 1)
            for n in range(1, most + 1) for i in range(n)}
    return np.array(sorted(rows), np.int64)


class SearchCheck(NamedTuple):
    best_gap: float  # |last generation's best - fitness of final row 0|
    missed: float  # most a starting row's fitness exceeds gen 1's best
    unchanged: float  # share of final rows found in the starting rows
    tables: np.ndarray  # the tables scored, for a control's reading
    fitness: np.ndarray  # the reference's fitness of them


def check_search(campaign: Campaign, state: State, start: np.ndarray,
                 end: np.ndarray, curve: List[float],
                 precision: str = "f64") -> SearchCheck:
    """The search of one request, against ``state``, from the starting
    and final populations ``start``, ``end`` (``f32[P, H]``) and the
    best fitness of each generation it ran, ``curve``."""
    P = start.shape[0]
    keep = np.ones(P, bool)
    keep[seed_rows(P)] = False
    tables = np.concatenate([end[:1], start[keep]])
    fit = campaign.fitness(state, tables, precision)
    best_gap = abs(float(curve[-1]) - float(fit[0]))
    missed = max(0.0, float(fit[1:].max()) - float(curve[0]))
    seen = {row.tobytes() for row in np.ascontiguousarray(start)}
    unchanged = sum(row.tobytes() in seen
                    for row in np.ascontiguousarray(end)) / end.shape[0]
    return SearchCheck(best_gap, missed, unchanged, tables, fit)
