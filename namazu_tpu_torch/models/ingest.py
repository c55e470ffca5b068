"""History ingest: stored experiment runs -> search state. The port of
``namazu_tpu/models/ingest.py``.

Every search request re-feeds the whole stored history: each run is
encoded in both time views (arrival-anchored = counterfactual reference,
release-anchored = archive embedding), the precedence pairs are refit to
the occupied hint buckets, recorded failures seed the population with
the delays they injected, and the archives fill with every run labeled
by its outcome. The returned references are the newest successful runs
(failures only when no success exists), or their ``envelope``.

Three knobs fold in memory beyond the storage, as in the reference:

* ``failure_pool``: the storage's failures are written to a shared pool
  directory (``models/failure_pool.py``), and other runs' pooled
  signatures enter the archives and the seeds;
* ``knowledge``: the same through the knowledge service (``host:port``),
  plus the scenario's pooled coverage bits, this campaign's bits pushed
  back and labeled examples for the shared surrogate; an outage degrades
  to the local path and never fails the ingest;
* ``guidance``: the search's relation-coverage map is rebuilt from every
  known run's realized order (pooled ones included) on each ingest.

A ``RunCache`` handed in keeps each run's reading and encoding between
ingests of one campaign: where the storage is the port's
``NaiveHistory``, whose ``run_tokens`` say which runs' files moved, an
ingest reads and encodes only the runs that are new or changed, and
takes every other run from the cache; everything after the read sees
the same runs in the same order. Other storages are read in full.

``stats``, when given, receives the seconds of the ingest's sections
(``read_encode``, ``pool_io``, ``knowledge``: the knowledge round
trips, ``guidance_observe``, ``archive``: the pairs' refit, the seed
genomes and every run's archive rows), of the two costs inside
``read_encode`` (``read``: the storage's scan, its stat tokens and the
``trace.json`` and ``result.json`` of every run read from its files;
``encode``: those runs' two views and failure seed) and its counts
(``runs_read``: runs read from their files; ``runs_cached``: runs taken
from the cache; ``warmstart_archive``: pooled
knowledge signatures new to the search; ``warmstart_coverage``: pooled
coverage bits new to the map; ``coverage_bits``, ``one_sided``). Each
section is also the search phase ``ingest_<section>`` on
``search.telemetry``, timed inside it. The warm-start counts and the
coverage map go to ``search.telemetry`` too (``knowledge_warmstart``,
``relation_coverage``), and so do the knowledge client's round trips,
as the reference's ingest reports them to ``obs``.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from namazu_tpu_torch.guidance import bucket_sequence_from_encoded
from namazu_tpu_torch.history import NaiveHistory
from namazu_tpu_torch.knowledge.client import (
    pairs_fingerprint,
    shared_client,
)
from namazu_tpu_torch.models.failure_pool import (
    entry_to_jsonable,
    pool_add,
    pool_load,
    trace_digest,
)
from namazu_tpu_torch.obs import search_phase
from namazu_tpu_torch.ops import trace_encoding as te

log = logging.getLogger("namazu_tpu_torch.ingest")

#: newest runs whose labeled features go to the shared surrogate per ingest
MAX_EXAMPLE_PUSH = 64
#: a run whose files changed less than this long before the wall clock
#: at the start of the read is read again on the next ingest, and cached
#: only once it is older: a filesystem's timestamps may be coarser than
#: one write (git's "racily clean" rule)
RACY_NS = 1_000_000_000
#: the wall clock of that rule, in nanoseconds
wall_ns = time.time_ns


class IngestParams(NamedTuple):
    H: int = te.DEFAULT_H
    L: int = 0  # explicit trace-length cap; 0 = policy defaults
    release_mode: str = "delay"  # "delay" | "reorder"
    reference_mode: str = "recent"  # "recent" | "envelope"
    max_interval: float = 0.1  # seed-table clip (seconds)
    max_reference_traces: int = 4
    max_seed_genomes: int = 16
    order_mode_max_l: int = 4096  # encode cap in reorder mode
    failure_pool: str = ""  # shared pool directory ("" = off)
    knowledge: str = ""  # knowledge service "host:port" ("" = off)
    knowledge_tenant: str = ""
    knowledge_scenario: str = ""
    guidance: bool = False  # rebuild the relation-coverage map
    guidance_width: int = 0  # 0 = the guidance defaults
    guidance_window: int = 0


def failure_seed(trace, H: int, max_interval: float):
    """Per-bucket delay table replaying a failure's injected delays: for
    the first released event of each bucket, ``release - arrival`` is the
    delay the recording policy injected, clipped to ``[0,
    max_interval]``. None when no event recorded both times."""
    seed = np.zeros((H,), np.float32)
    seen = set()
    got = False
    for a in trace:
        arr, rel = a.event_arrived, a.triggered_time
        if not arr or not rel:
            continue
        b = te.hint_bucket(te.action_hint(a), H)
        if b in seen:
            continue
        seen.add(b)
        seed[b] = min(max(rel - arr, 0.0), max_interval)
        got = True
    return seed if got else None


def _encode_cap(p: IngestParams) -> Optional[int]:
    if p.L > 0:
        return p.L
    if p.release_mode == "reorder":
        return p.order_mode_max_l
    return None  # delay mode scores long traces blockwise


class _Run(NamedTuple):
    """One run as the ingest read it: its hint-space stamp, verdict, and,
    in this build's hint space, its two views and failure seed."""

    stamp: str
    ok: bool
    enc: Optional[te.EncodedTrace] = None
    enc_rt: Optional[te.EncodedTrace] = None
    seed: Optional[np.ndarray] = None


def _read(read, i: int, lap: Dict[str, float]):
    """``(trace, ok, stamp)`` of run ``i`` from ``read(i)``, which gives
    its trace, verdict and metadata and raises for a run that cannot be
    read; the seconds add into ``lap["read"]``."""
    t0 = time.perf_counter()
    try:
        trace, ok, meta = read(i)
        return trace, ok, (meta or {}).get("hint_space", "content-v1")
    finally:
        lap["read"] += time.perf_counter() - t0


def _encode(trace, ok: bool, stamp: str, p: IngestParams,
            cap: Optional[int], lap: Dict[str, float]) -> _Run:
    """A read run's ``_Run``, encoded in this build's hint space only;
    the seconds add into ``lap["encode"]``."""
    if stamp != te.HINT_SPACE:
        return _Run(stamp, ok)
    t0 = time.perf_counter()
    enc, enc_rt = te.encode_trace_views(trace, L=cap, H=p.H)
    seed = None if ok else failure_seed(trace, p.H, p.max_interval)
    lap["encode"] += time.perf_counter() - t0
    return _Run(stamp, ok, enc, enc_rt, seed)


class RunCache:
    """One campaign's stored runs as ingests read and encoded them, kept
    between ingests by the caller (the sidecar keeps one a key, used
    under the key's lock). A run is taken from the cache while its stat
    token is the one it was read under; it is cached only when no time
    in that token lies within ``RACY_NS`` of the wall clock at the
    read's start, so a change the token cannot see (a rewrite inside one
    timestamp tick) is read the next time. Runs that raise are never
    cached. The cache holds only the runs of the storage's last scan, and
    starts empty when the storage's path or an input of the encoding
    (its cap, ``H``, ``max_interval``) changes."""

    def __init__(self):
        self._inputs: Optional[tuple] = None
        self._runs: Dict[int, Tuple[tuple, _Run]] = {}

    def read(self, storage: NaiveHistory, tokens, p: IngestParams,
             cap: Optional[int], now_ns: int, lap: Dict[str, float],
             counts: Dict[str, int]) -> List[Tuple[int, _Run]]:
        """The readable runs of ``storage`` under ``tokens``
        (``run_tokens()`` taken at ``now_ns``) and their indices, in
        order: from the cache where a run's token is unchanged, else read
        and encoded."""
        inputs = (storage.dir, cap, p.H, p.max_interval)
        if inputs != self._inputs:
            self._inputs, self._runs = inputs, {}
        old, self._runs = self._runs, {}
        runs = []
        for i, token in enumerate(tokens):
            if token is None:  # no result: invisible
                continue
            hit = old.get(i)
            if hit is not None and hit[0] == token:
                self._runs[i] = hit
                runs.append((i, hit[1]))
                counts["runs_cached"] += 1
                continue
            try:
                read = _read(storage.read_run, i, lap)
            except Exception:
                continue
            counts["runs_read"] += 1
            run = _encode(*read, p, cap, lap)
            if max(t for st in token if st is not None
                   for t in st[2:]) < now_ns - RACY_NS:
                self._runs[i] = (token, run)
            runs.append((i, run))
        return runs


def _push_surrogate_examples(client, search, encoded) -> None:
    """Send ``(digest, features, reproduced?)`` of the newest runs to the
    shared surrogate, scoped by the final pairs' fingerprint (guided
    searches send ``[K | G]`` rows, which the service keeps apart by
    width). Best effort: a failure here is logged, never raised."""
    try:
        examples = []
        for enc, enc_rt, ok, _ in encoded[-MAX_EXAMPLE_PUSH:]:
            feats = search._feats_of(enc_rt)
            if search.guidance_feats is not None:
                feats = np.concatenate(
                    [feats, search._guidance_feats_of(enc_rt, enc)])
            examples.append({"digest": trace_digest(enc_rt),
                             "feats": [float(x) for x in feats],
                             "label": 0.0 if ok else 1.0})
        client.push(examples=examples,
                    pairs_fp=pairs_fingerprint(search.pairs))
    except Exception:
        log.exception("could not push surrogate examples")


class _Sections:
    """Seconds per section, added into ``stats``: each section is the
    search phase ``ingest_<section>`` on ``sink``, and is timed inside
    it, so the phase's span holds the seconds counted."""

    def __init__(self, stats: Optional[dict], sink):
        self.stats = stats if stats is not None else {}
        self.sink = sink

    @contextlib.contextmanager
    def __call__(self, section: str):
        with search_phase(self.sink, f"ingest_{section}"):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.stats[section] = (self.stats.get(section, 0.0)
                                       + time.perf_counter() - t0)


def ingest_history(search, storage, p: IngestParams,
                   stats: Optional[dict] = None,
                   cache: Optional[RunCache] = None) -> List:
    """Feed the stored runs (and, with the knobs, pooled knowledge) into
    ``search``'s archives and population; return the reference traces to
    evolve against ([] without history). Runs recorded in another hint
    space, quarantined runs and runs without a result are skipped.
    ``cache`` keeps the runs' readings between ingests of a
    ``NaiveHistory``; the result is the same with it or without."""
    if storage is None:
        return []
    if not isinstance(storage, NaiveHistory):
        cache = None  # no stat tokens: every run is read
    tel = search.telemetry
    section = _Sections(stats, tel)
    with section("read_encode"):
        lap = {"read": 0.0, "encode": 0.0}
        counts = {"runs_read": 0, "runs_cached": 0}
        t0 = time.perf_counter()
        try:
            if cache is not None:
                now_ns = wall_ns()
                tokens = storage.run_tokens()
            else:
                n = storage.nr_stored_histories()
        except Exception:
            log.exception("could not count stored runs")
            return []
        lap["read"] += time.perf_counter() - t0
        # the map is wired before any archive write, so fragments stay
        # slot-aligned, and rebuilt on every ingest (fresh), so a cached
        # search never observes the same history twice
        gmap = None
        if p.guidance:
            gmap = search.enable_guidance(p.guidance_width or None,
                                          p.guidance_window or None,
                                          fresh=True)
        cap = _encode_cap(p)
        if cache is not None:
            runs = cache.read(storage, tokens, p, cap, now_ns, lap, counts)
        else:
            def read(i):
                return (storage.get_stored_history(i),
                        storage.is_successful(i), storage.get_metadata(i))

            runs = []
            for i in range(n):
                try:
                    got = _read(read, i, lap)
                except Exception:
                    continue
                runs.append((i, _encode(*got, p, cap, lap)))
            counts["runs_read"] = len(runs)
        encoded = []
        skipped_unstamped = 0
        for i, run in runs:
            if run.stamp != te.HINT_SPACE:
                skipped_unstamped += 1
                continue
            if run.enc.truncated:
                log.warning("trace %d truncated: %d events beyond the L=%d "
                            "cap were dropped from scoring", i,
                            run.enc.truncated, cap)
            encoded.append((run.enc, run.enc_rt, run.ok, run.seed))
        section.stats.update(lap)
        section.stats.update(counts)
        if skipped_unstamped:
            log.warning("%d stored run(s) recorded in another hint space "
                        "were excluded from search ingest (this build: %s)",
                        skipped_unstamped, te.HINT_SPACE)
    # the failure pool and the knowledge service: own failures go up
    # first, then the others' signatures (never our own) come down
    pooled = []
    client = None
    if p.knowledge:
        client = shared_client(p.knowledge, tenant=p.knowledge_tenant,
                               scenario=p.knowledge_scenario, telemetry=tel)
    if p.failure_pool or client is not None:
        own = set()
        push_entries = []
        with section("pool_io"):
            for enc, enc_rt, ok, seed in encoded:
                if ok:
                    continue
                try:
                    own.add(trace_digest(enc_rt))
                    if p.failure_pool:
                        pool_add(p.failure_pool, enc_rt, enc, seed, p.H)
                    if client is not None:
                        push_entries.append(
                            entry_to_jsonable(enc_rt, enc, seed, p.H))
                except Exception:
                    log.exception("could not pool failure signature")
            if p.failure_pool:
                pooled = pool_load(p.failure_pool, p.H, exclude=own)
        if client is not None:
            with section("knowledge"):
                client.push(entries=push_entries)  # None on an outage
                have = own | {e.digest for e in pooled}
                # the fleet's coverage bits ride the same round trip
                space = (None if gmap is None else
                         {"H": gmap.H, "w": gmap.width, "win": gmap.window})
                remote = client.pull(p.H, exclude=have,
                                     coverage_space=space)
                if remote is not None:
                    r_entries = remote[0]
                    fresh = sum(1 for e in r_entries
                                if not search.has_failure_signature(
                                    e.digest))
                    section.stats["warmstart_archive"] = fresh
                    tel.knowledge_warmstart("archive", fresh)
                    pooled = pooled + r_entries
                    if gmap is not None:
                        merged = gmap.merge_bits(remote[2])
                        section.stats["warmstart_coverage"] = merged
                        tel.knowledge_warmstart("coverage", merged)
        if pooled:
            log.info("folding %d pooled failure signature(s) into the "
                     "search (pool %s%s)", len(pooled),
                     p.failure_pool or "-",
                     f", knowledge {p.knowledge}" if p.knowledge else "")
    if gmap is not None:
        # every known run's realized order, pooled ones too and before
        # the dedupe skip below (a restored search may hold a signature
        # this fresh map has never seen)
        with section("guidance_observe"):
            for e in pooled:
                gmap.observe(bucket_sequence_from_encoded(e.realized))
            for _, enc_rt, _, _ in encoded:
                gmap.observe(bucket_sequence_from_encoded(enc_rt))
    with section("archive"):
        # refit the pairs BEFORE embedding anything: a change clears the
        # archives, and the loops below refill them in full
        search.set_occupied_buckets(sorted(
            {int(b) for enc, _, _, _ in encoded
             for b in enc.hint_ids[enc.mask]}
            | {int(b) for e in pooled
               for b in e.realized.hint_ids[e.realized.mask]}))
        # most recent failures first, then the pooled ones (newest first)
        seeds = [s for _, _, ok, s in encoded if not ok and s is not None]
        seeds = seeds[::-1] + [e.seed for e in pooled if e.seed is not None]
        if seeds:
            search.seed_population(seeds[: p.max_seed_genomes])
        for e in pooled:
            # pooled signatures go in first, once each: the failure
            # archive is a ring, and the storage's own failures must
            # survive a full pool
            if search.has_failure_signature(e.digest):
                continue
            search.add_executed_trace(e.realized, reproduced=True,
                                      arrival=e.arrival)
            search.add_failure_trace(e.realized)
        failures, successes = [], []
        for enc, enc_rt, ok, _ in encoded:
            search.add_executed_trace(enc_rt, reproduced=not ok,
                                      arrival=enc)
            if not ok:
                search.add_failure_trace(enc_rt)
                failures.append(enc)
            else:
                successes.append(enc)
    if gmap is not None:
        section.stats["coverage_bits"] = gmap.covered()
        section.stats["one_sided"] = gmap.one_sided_count()
        tel.relation_coverage(p.knowledge_scenario or "local",
                              section.stats["coverage_bits"], gmap.width,
                              section.stats["one_sided"])
    if client is not None:
        with section("knowledge"):
            if gmap is not None:
                # publish this campaign's frontier for the next cold
                # campaign
                client.push(coverage={"H": gmap.H, "w": gmap.width,
                                      "win": gmap.window,
                                      "bits": gmap.bits_list()})
            if encoded:
                _push_surrogate_examples(client, search, encoded)
    if p.reference_mode == "envelope" and successes:
        return [te.envelope_trace(successes)]
    pool = successes if successes else failures
    if not pool and pooled:
        # a storage with no runs of its own evolves against the pooled
        # signatures' arrivals
        pool = [e.arrival for e in reversed(pooled)]
    return pool[::-1][: p.max_reference_traces]
