"""Relation-coverage signatures: which orderings did a run exercise?
The port's own copy of ``namazu_tpu/guidance/signature.py`` (numpy
only; every function returns what the reference's returns on the same
input).

A ``trace_digest`` counts one opaque hash per realized interleaving, so
two runs that differ in one ordering relation count as two digests. This
module counts the unit the fuzzer controls instead: **ordering
relations** between occurrence-indexed hint buckets.

An event's relation identity is its hint bucket, ``fnv64a(replay hint) %
H`` (the unit the delay table indexes and the precedence pairs sample),
made unique by occurrence index: the k-th event of bucket ``b`` is
``b#k``. The same space is derived from flight-recorder record docs, from
stored traces and from encoded traces, whose ``hint_ids`` are buckets;
the last is what lets the search predict the relations a candidate table
would exercise by simulating its release order.

A relation is the directed pair "``x`` dispatched before ``y``" for
events within :data:`DEFAULT_WINDOW` dispatch positions of each other.
Each relation hashes into one bit of a fixed-width bitmap, so signatures
vectorize, pool by OR (the knowledge service) and compare in O(width).
Every function here is a pure function of its inputs.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from namazu_tpu_torch.ops.trace_encoding import action_hint, fnv64a

__all__ = [
    "DEFAULT_WIDTH", "DEFAULT_WINDOW", "SCAN_CAP", "GUIDANCE_DIMS",
    "hint_bucket", "bucket_sequence_from_docs",
    "bucket_sequence_from_trace", "bucket_sequence_from_encoded",
    "occurrence_index", "relation_pairs", "pair_bit", "signature_bits",
    "reverse_signature_bits",
    "dag_shape_features",
]

#: bitmap width (bits) of a relation signature. 4096 bits = 512 bytes
#: per campaign on the wire; at the DEFAULT_WINDOW pair density a run of
#: a few hundred events sets a few thousand candidate bits, so the map
#: saturates from genuine diversity, not from birthday collisions.
DEFAULT_WIDTH = 4096

#: relation window: ordered pairs are collected between events within
#: this many DISPATCH positions of each other. Far-apart relations are
#: transitively implied by the chain of nearby ones, and the per-run
#: pair count stays O(n * window) instead of O(n^2).
DEFAULT_WINDOW = 16

#: dispatch-order scan cap per run: past it the tail is dropped from the
#: signature, so a derivation stays bounded.
SCAN_CAP = 512

#: dimensionality of the DAG-shape feature fragment appended to the
#: surrogate's precedence features when guidance is on: a
#: (GUIDANCE_DIMS - 4)-bucket fold of the relation bitmap plus four
#: shape scalars (see :func:`dag_shape_features`).
GUIDANCE_DIMS = 20


def hint_bucket(hint: str, H: int) -> int:
    """The relation identity of a hint: the delay table's index, as the
    trace encoder computes it."""
    return int(fnv64a(hint.encode()) % H)


# -- bucket-sequence adapters (one canonical space, three sources) ---------

def bucket_sequence_from_docs(record_docs: Iterable[dict],
                              H: int) -> np.ndarray:
    """Dispatch-ordered hint buckets from flight-recorder record docs
    (the NDJSON shape — a live RunTrace snapshot, a ``GET /traces``
    body, or a dump file). Pure function of the docs: ordering comes
    from the recorded ``dispatched`` stamps, identity from the recorded
    hint (falling back to ``class:entity``, the ``failure_seed``
    convention for hint-less events)."""
    rows = []
    for doc in record_docs:
        t = doc.get("t") or {}
        if doc.get("kind") or "dispatched" not in t:
            continue  # search-plane entries / never-dispatched events
        hint = doc.get("hint") or (
            f"{doc.get('event_class') or 'event'}:"
            f"{doc.get('entity') or ''}")
        rows.append((t["dispatched"], hint_bucket(hint, H)))
    rows.sort(key=lambda r: r[0])
    return np.asarray([b for _, b in rows], np.int32)


def bucket_sequence_from_trace(trace, H: int) -> np.ndarray:
    """Dispatch-ordered hint buckets from a stored trace's actions
    (``history.ActionRecord``; ``triggered_time`` is the realized release
    stamp)."""
    rows = []
    for a in trace:
        tt = a.triggered_time
        if not tt:
            continue
        rows.append((tt, hint_bucket(action_hint(a), H)))
    rows.sort(key=lambda r: r[0])
    return np.asarray([b for _, b in rows], np.int32)


def bucket_sequence_from_encoded(enc,
                                 times: Optional[np.ndarray] = None
                                 ) -> np.ndarray:
    """Dispatch-ordered hint buckets from an encoded trace. ``times``
    overrides the encoding's own time vector — THE candidate-simulation
    hook: pass ``arrival + delays[hint_ids]`` and the returned sequence
    is the order a candidate delay table would realize against these
    arrivals (delay mode's exact release rule), so its predicted
    relation coverage is one :func:`signature_bits` call away."""
    m = enc.mask
    buckets = enc.hint_ids[m]
    t = (enc.arrival[m] if times is None else np.asarray(times)[m])
    order = np.argsort(t, kind="stable")
    return np.asarray(buckets[order], np.int32)


# -- the signature ---------------------------------------------------------

def occurrence_index(buckets: Sequence[int]) -> np.ndarray:
    """Per-position occurrence index: ``occ[i]`` = how many earlier
    positions hold the same bucket (the k-th event of bucket ``b`` is
    identity ``b#k``). Vectorized — grouped by a stable sort."""
    seq = np.asarray(buckets, np.int64)
    n = len(seq)
    occ = np.zeros((n,), np.int64)
    if n == 0:
        return occ
    order = np.argsort(seq, kind="stable")
    srt = seq[order]
    grp_start = np.r_[0, np.flatnonzero(np.diff(srt)) + 1]
    starts = np.repeat(grp_start, np.diff(np.r_[grp_start, n]))
    occ[order] = np.arange(n) - starts
    return occ


#: splitmix64 finalizer constants — a fixed, dependency-free integer
#: mix so the bit assignment is pure arithmetic (vectorizes over whole
#: candidate populations) and stable across processes/builds
_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)
_KEY_STRIDE = np.uint64(1_000_003)


def _mix64(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.uint64)
    with np.errstate(over="ignore"):
        x = (x ^ (x >> np.uint64(30))) * _MIX1
        x = (x ^ (x >> np.uint64(27))) * _MIX2
        return x ^ (x >> np.uint64(31))


def _pair_keys(buckets: Sequence[int], window: int, cap: int):
    """``(bx, ox, by, oy, gaps)`` column arrays of every directed
    in-window relation of a dispatch order (x strictly before y,
    within ``window`` positions); ``gaps`` is each pair's positional
    distance — emitted here, where the block layout is defined, so no
    caller has to re-derive it from the emission order.

    SAME-bucket pairs are excluded: occurrence indices are assigned in
    dispatch order, so "b#k before b#k+1" holds by construction in
    every run — a tautology that carries no ordering information, can
    never flip, and would permanently inflate the one-sided frontier
    (and the mutation bias aimed at it) with unreachable relations."""
    seq = np.asarray(buckets, np.int64)[:cap]
    occ = occurrence_index(seq)
    cols = ([], [], [], [], [])
    n = len(seq)
    for d in range(1, min(window, n - 1) + 1 if n > 1 else 1):
        keep = seq[:-d] != seq[d:]
        cols[0].append(seq[:-d][keep])
        cols[1].append(occ[:-d][keep])
        cols[2].append(seq[d:][keep])
        cols[3].append(occ[d:][keep])
        cols[4].append(np.full((int(keep.sum()),), d, np.int64))
    if not cols[0]:
        empty = np.zeros((0,), np.int64)
        return empty, empty, empty, empty, empty
    return tuple(np.concatenate(c) for c in cols)


def _keys_to_bits(bx, ox, by, oy, width: int) -> np.ndarray:
    with np.errstate(over="ignore"):
        key = bx.astype(np.uint64)
        for part in (ox, by, oy):
            key = key * _KEY_STRIDE + part.astype(np.uint64)
    return (_mix64(key) % np.uint64(width)).astype(np.int64)


def relation_pairs(buckets: Sequence[int],
                   window: int = DEFAULT_WINDOW,
                   cap: int = SCAN_CAP
                   ) -> List[Tuple[int, int, int, int]]:
    """The directed relations a dispatch order exercises, as python
    tuples ``(bucket_x, occ_x, bucket_y, occ_y)`` — the identity-
    bearing form the CoverageMap's pair table keys on. Repeated
    buckets occurrence-disambiguate against OTHER buckets' events;
    same-bucket pairs are excluded as tautologies (``_pair_keys``)."""
    bx, ox, by, oy, _gaps = _pair_keys(buckets, window, cap)
    return [(int(a), int(b), int(c), int(d))
            for a, b, c, d in zip(bx, ox, by, oy)]


def pair_bit(bx: int, ox: int, by: int, oy: int,
             width: int = DEFAULT_WIDTH) -> int:
    """The bitmap bit of one directed relation. Direction is encoded in
    the key ordering, so "x before y" and "y before x" land on (almost
    surely) different bits — a flip COVERS new ground."""
    return int(_keys_to_bits(*(np.asarray([v], np.int64)
                               for v in (bx, ox, by, oy)),
                             width)[0])


def signature_bits(buckets: Sequence[int],
                   width: int = DEFAULT_WIDTH,
                   window: int = DEFAULT_WINDOW,
                   cap: int = SCAN_CAP) -> np.ndarray:
    """One run's relation-coverage signature as sorted unique bit
    indices (int64). ``np.zeros(width, bool)`` with these set is the
    bitmap form; the sparse form is what travels the knowledge wire.
    Fully vectorized — cheap enough to run per CANDIDATE inside the
    guided pick, not just per executed run."""
    bx, ox, by, oy, _gaps = _pair_keys(buckets, window, cap)
    if not len(bx):
        return np.zeros((0,), np.int64)
    return np.unique(_keys_to_bits(bx, ox, by, oy, width))


def reverse_signature_bits(buckets: Sequence[int],
                           width: int = DEFAULT_WIDTH,
                           window: int = DEFAULT_WINDOW,
                           cap: int = SCAN_CAP) -> np.ndarray:
    """The bits a run's relations would cover FLIPPED — each observed
    "x before y" hashed as "y before x". The difference
    ``reverse_bits - covered_bits`` across a campaign is its open
    frontier in bit space: orderings whose one direction was exercised
    while the other never was, i.e. exactly where relation coverage
    can still grow after digest novelty reads saturated."""
    bx, ox, by, oy, _gaps = _pair_keys(buckets, window, cap)
    if not len(bx):
        return np.zeros((0,), np.int64)
    return np.unique(_keys_to_bits(by, oy, bx, ox, width))


# -- DAG-shape features (the surrogate's extension) ------------------------

def dag_shape_features(buckets_program: np.ndarray,
                       times_program: np.ndarray,
                       times_dispatch: np.ndarray,
                       width: int = DEFAULT_WIDTH,
                       dims: int = GUIDANCE_DIMS) -> np.ndarray:
    """A ``dims``-float summary of a run's happens-before SHAPE, the
    fragment appended to the surrogate's precedence features when
    guidance is on (``models/search.py`` ``_guidance_feats_of``):

    * ``dims - 4`` values — the relation bitmap folded into that many
      buckets (bit count per fold, normalized by total relations): a
      coarse "which ordering regions did this run touch";
    * 4 shape scalars — program/dispatch edge-crossing density (the
      fraction of adjacent program-order pairs inverted in dispatch
      order — how hard the schedule reordered the testee), mean
      normalized displacement between the two orders, distinct-bucket
      density, and relation-bit density.

    All inputs are masked 1-D arrays over the same events; program and
    dispatch orders are derived from their respective time vectors.
    Pure and deterministic, like everything in this module.
    """
    n = len(buckets_program)
    out = np.zeros((dims,), np.float32)
    if n == 0 or dims <= 4:
        return out
    buckets = np.asarray(buckets_program)
    order_p = np.argsort(np.asarray(times_program), kind="stable")
    order_d = np.argsort(np.asarray(times_dispatch), kind="stable")
    rank_d = np.empty((n,), np.int64)
    rank_d[order_d] = np.arange(n)
    # dispatch ranks walked in program order: crossings and
    # displacement of the realized order against the testee's own
    prog_ranks = rank_d[order_p]
    seq = buckets[order_d]
    bits = signature_bits(seq, width=width)
    fold = dims - 4
    if len(bits):
        counts = np.bincount(bits % fold, minlength=fold)
        out[:fold] = counts / float(len(bits))
    if n > 1:
        out[fold] = float((np.diff(prog_ranks) < 0).sum()) / (n - 1)
        out[fold + 1] = float(
            np.abs(prog_ranks - np.arange(n)).mean()) / (n - 1)
    out[fold + 2] = len(np.unique(buckets)) / float(n)
    out[fold + 3] = min(1.0, len(bits) / float(max(1, n)))
    return out
