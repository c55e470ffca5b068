"""History ingest: stored experiment runs -> search state. The port of
``namazu_tpu/models/ingest.py``.

Every search request re-feeds the whole stored history: each run is
encoded in both time views (arrival-anchored = counterfactual reference,
release-anchored = archive embedding), the precedence pairs are refit to
the occupied hint buckets, recorded failures seed the population with
the delays they injected, and the archives fill with every run labeled
by its outcome. The returned references are the newest successful runs
(failures only when no success exists), or their ``envelope``.

The failure pool, the knowledge service and causality guidance are not
ported yet: a request that enables one raises ``NotImplementedError``.
"""

from __future__ import annotations

import logging
from typing import List, NamedTuple, Optional

import numpy as np

from namazu_tpu_torch.ops import trace_encoding as te

log = logging.getLogger("namazu_tpu_torch.ingest")


class IngestParams(NamedTuple):
    H: int = te.DEFAULT_H
    L: int = 0  # explicit trace-length cap; 0 = policy defaults
    release_mode: str = "delay"  # "delay" | "reorder"
    reference_mode: str = "recent"  # "recent" | "envelope"
    max_interval: float = 0.1  # seed-table clip (seconds)
    max_reference_traces: int = 4
    max_seed_genomes: int = 16
    order_mode_max_l: int = 4096  # encode cap in reorder mode
    failure_pool: str = ""  # not ported: non-empty raises
    knowledge: str = ""  # not ported: non-empty raises
    knowledge_tenant: str = ""
    knowledge_scenario: str = ""
    guidance: bool = False  # not ported: True raises
    guidance_width: int = 0
    guidance_window: int = 0


def unported(p: IngestParams) -> Optional[str]:
    """What in ``p`` the port cannot honour yet, or None."""
    if p.failure_pool:
        return "the failure pool (failure_pool)"
    if p.knowledge:
        return "the knowledge service (knowledge)"
    if p.guidance:
        return "causality guidance (guidance)"
    return None


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


def ingest_history(search, storage, p: IngestParams) -> List:
    """Feed the stored runs into ``search``'s archives and population;
    return the reference traces to evolve against ([] without history).
    Runs recorded in another hint space, quarantined runs and runs
    without a result are skipped."""
    what = unported(p)
    if what is not None:
        raise NotImplementedError(
            f"namazu_tpu_torch: {what} is not ported yet")
    if storage is None:
        return []
    try:
        n = storage.nr_stored_histories()
    except Exception:
        log.exception("could not count stored runs")
        return []
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
    # refit the pairs BEFORE embedding anything: a change clears the
    # archives, and the loop below refills them in full
    search.set_occupied_buckets(sorted(
        {int(b) for enc, _, _, _ in encoded for b in enc.hint_ids[enc.mask]}))
    # most recent failures first: the freshest demonstrations win slots
    seeds = [s for _, _, ok, s in encoded if not ok and s is not None]
    if seeds:
        search.seed_population(seeds[::-1][: p.max_seed_genomes])
    failures, successes = [], []
    for enc, enc_rt, ok, _ in encoded:
        search.add_executed_trace(enc_rt, reproduced=not ok, arrival=enc)
        if not ok:
            search.add_failure_trace(enc_rt)
            failures.append(enc)
        else:
            successes.append(enc)
    if p.reference_mode == "envelope" and successes:
        return [te.envelope_trace(successes)]
    pool = successes if successes else failures
    return pool[::-1][: p.max_reference_traces]
