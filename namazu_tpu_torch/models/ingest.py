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

``stats``, when given, receives the seconds of the ingest's sections
(``read_encode``, ``pool_io``, ``guidance_observe``, ``knowledge``: the
knowledge round trips) and its counts (``warmstart_archive``: pooled
knowledge signatures new to the search; ``warmstart_coverage``: pooled
coverage bits new to the map; ``coverage_bits``, ``one_sided``).
"""

from __future__ import annotations

import logging
import time
from typing import List, NamedTuple, Optional

import numpy as np

from namazu_tpu_torch.guidance import bucket_sequence_from_encoded
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
from namazu_tpu_torch.ops import trace_encoding as te

log = logging.getLogger("namazu_tpu_torch.ingest")

#: newest runs whose labeled features go to the shared surrogate per ingest
MAX_EXAMPLE_PUSH = 64


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


class _Clock:
    """Seconds per section, added into ``stats``."""

    def __init__(self, stats: Optional[dict]):
        self.stats = stats if stats is not None else {}
        self.t = time.perf_counter()

    def lap(self, section: str) -> None:
        now = time.perf_counter()
        self.stats[section] = self.stats.get(section, 0.0) + now - self.t
        self.t = now


def ingest_history(search, storage, p: IngestParams,
                   stats: Optional[dict] = None) -> List:
    """Feed the stored runs (and, with the knobs, pooled knowledge) into
    ``search``'s archives and population; return the reference traces to
    evolve against ([] without history). Runs recorded in another hint
    space, quarantined runs and runs without a result are skipped."""
    if storage is None:
        return []
    try:
        n = storage.nr_stored_histories()
    except Exception:
        log.exception("could not count stored runs")
        return []
    clock = _Clock(stats)
    # the map is wired before any archive write, so fragments stay
    # slot-aligned, and rebuilt on every ingest (fresh), so a cached
    # search never observes the same history twice
    gmap = None
    if p.guidance:
        gmap = search.enable_guidance(p.guidance_width or None,
                                      p.guidance_window or None,
                                      fresh=True)
    encoded = []
    skipped_unstamped = 0
    for i in range(n):
        try:
            trace = storage.get_stored_history(i)
            ok = storage.is_successful(i)
            stamp = ((storage.get_metadata(i) or {})
                     .get("hint_space", "content-v1"))
        except Exception:
            continue
        if stamp != te.HINT_SPACE:
            skipped_unstamped += 1
            continue
        if p.L > 0:
            cap: Optional[int] = p.L
        elif p.release_mode == "reorder":
            cap = p.order_mode_max_l
        else:
            cap = None  # delay mode scores long traces blockwise
        enc, enc_rt = te.encode_trace_views(trace, L=cap, H=p.H)
        if enc.truncated:
            log.warning("trace %d truncated: %d events beyond the L=%d "
                        "cap were dropped from scoring", i, enc.truncated,
                        cap)
        seed = None if ok else failure_seed(trace, p.H, p.max_interval)
        encoded.append((enc, enc_rt, ok, seed))
    if skipped_unstamped:
        log.warning("%d stored run(s) recorded in another hint space were "
                    "excluded from search ingest (this build: %s)",
                    skipped_unstamped, te.HINT_SPACE)
    clock.lap("read_encode")
    # the failure pool and the knowledge service: own failures go up
    # first, then the others' signatures (never our own) come down
    pooled = []
    client = None
    if p.knowledge:
        client = shared_client(p.knowledge, tenant=p.knowledge_tenant,
                               scenario=p.knowledge_scenario)
    if p.failure_pool or client is not None:
        own = set()
        push_entries = []
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
        clock.lap("pool_io")
        if client is not None:
            client.push(entries=push_entries)  # None on an outage: fine
            have = own | {e.digest for e in pooled}
            # the fleet's coverage bits ride the same round trip
            space = (None if gmap is None else
                     {"H": gmap.H, "w": gmap.width, "win": gmap.window})
            remote = client.pull(p.H, exclude=have, coverage_space=space)
            if remote is not None:
                r_entries = remote[0]
                fresh = sum(1 for e in r_entries
                            if not search.has_failure_signature(e.digest))
                clock.stats["warmstart_archive"] = fresh
                pooled = pooled + r_entries
                if gmap is not None:
                    clock.stats["warmstart_coverage"] = \
                        gmap.merge_bits(remote[2])
            clock.lap("knowledge")
        if pooled:
            log.info("folding %d pooled failure signature(s) into the "
                     "search (pool %s%s)", len(pooled),
                     p.failure_pool or "-",
                     f", knowledge {p.knowledge}" if p.knowledge else "")
    # refit the pairs BEFORE embedding anything: a change clears the
    # archives, and the loops below refill them in full
    search.set_occupied_buckets(sorted(
        {int(b) for enc, _, _, _ in encoded for b in enc.hint_ids[enc.mask]}
        | {int(b) for e in pooled
           for b in e.realized.hint_ids[e.realized.mask]}))
    # most recent failures first, then the pooled ones (newest first)
    seeds = [s for _, _, ok, s in encoded if not ok and s is not None]
    seeds = seeds[::-1] + [e.seed for e in pooled if e.seed is not None]
    if seeds:
        search.seed_population(seeds[: p.max_seed_genomes])
    if gmap is not None:
        # every known run's realized order, pooled ones too and before
        # the dedupe skip below (a restored search may hold a signature
        # this fresh map has never seen)
        for e in pooled:
            gmap.observe(bucket_sequence_from_encoded(e.realized))
        for _, enc_rt, _, _ in encoded:
            gmap.observe(bucket_sequence_from_encoded(enc_rt))
        clock.lap("guidance_observe")
    for e in pooled:
        # pooled signatures go in first, once each: the failure archive is
        # a ring, and the storage's own failures must survive a full pool
        if search.has_failure_signature(e.digest):
            continue
        search.add_executed_trace(e.realized, reproduced=True,
                                  arrival=e.arrival)
        search.add_failure_trace(e.realized)
    failures, successes = [], []
    for enc, enc_rt, ok, _ in encoded:
        search.add_executed_trace(enc_rt, reproduced=not ok, arrival=enc)
        if not ok:
            search.add_failure_trace(enc_rt)
            failures.append(enc)
        else:
            successes.append(enc)
    clock.lap("archive")
    if gmap is not None:
        clock.stats["coverage_bits"] = gmap.covered()
        clock.stats["one_sided"] = gmap.one_sided_count()
        if client is not None:
            # publish this campaign's frontier for the next cold campaign
            client.push(coverage={"H": gmap.H, "w": gmap.width,
                                  "win": gmap.window,
                                  "bits": gmap.bits_list()})
    if client is not None and encoded:
        _push_surrogate_examples(client, search, encoded)
    if client is not None:
        clock.lap("knowledge")
    if p.reference_mode == "envelope" and successes:
        return [te.envelope_trace(successes)]
    pool = successes if successes else failures
    if not pool and pooled:
        # a storage with no runs of its own evolves against the pooled
        # signatures' arrivals
        pool = [e.arrival for e in reversed(pooled)]
    return pool[::-1][: p.max_reference_traces]
