"""Per-campaign relation-coverage accounting, the guidance frontier: the
port's own copy of ``namazu_tpu/guidance/coverage.py`` (numpy only).

A :class:`CoverageMap` folds every executed run's relation signature
(``guidance/signature.py``) into one campaign-wide view and answers the
guided search's three questions:

* novelty: did this run first-cover a relation, or flip a one-sided
  one? (:meth:`observe` returns the delta);
* prediction: how much uncovered ground would a candidate order reach?
  (:meth:`predicted_gain`, the guided pick's bonus);
* direction: which buckets take part in one-sided relations, where
  mutation should concentrate? (:meth:`mutation_bias`, a per-bucket
  mutation-rate multiplier, and :meth:`one_sided`, the ranked frontier).

Two representations of one truth: a fixed-width bitmap (vectorized
novelty, OR-pooling through the knowledge service) and a bounded table
of directed pairs (one-sidedness, flip scores, bucket attribution). The
table is capped; overflow is counted (``pair_overflow``).

Thread-safe: the search observes while a knowledge push reads.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from namazu_tpu_torch.guidance.signature import (
    DEFAULT_WIDTH,
    DEFAULT_WINDOW,
    SCAN_CAP,
    _keys_to_bits,
    _pair_keys,
    signature_bits,
)

__all__ = ["CoverageDelta", "CoverageMap", "MAX_PAIRS"]

#: directed pairs remembered with full identity (the bitmap keeps
#: covering past this; only the *nameable* frontier is bounded)
MAX_PAIRS = 16384


class CoverageDelta(NamedTuple):
    """What one observed run added to the campaign's frontier."""
    new_bits: int  # bitmap bits first set by this run
    first_covered: int  # directed pairs seen for the first time
    flipped: int  # pairs whose REVERSE was known but this direction new
    interesting: bool  # new_bits > 0 or flipped > 0 (the novelty rule)


class CoverageMap:
    """The per-campaign relation-coverage frontier (module docstring)."""

    def __init__(self, H: int, width: int = DEFAULT_WIDTH,
                 window: int = DEFAULT_WINDOW,
                 max_pairs: int = MAX_PAIRS) -> None:
        self.H = int(H)
        self.width = int(width)
        self.window = int(window)
        self.max_pairs = int(max_pairs)
        self._lock = threading.Lock()
        self._bits = np.zeros((self.width,), bool)
        #: directed (bx, ox, by, oy) -> times seen
        self._pairs: Dict[Tuple[int, int, int, int], int] = {}
        #: directed pair -> min positional gap ever observed (a nearby
        #: pair is cheap to flip with a small delay; the flip-score
        #: denominator)
        self._gap: Dict[Tuple[int, int, int, int], int] = {}
        self.pair_overflow = 0
        self.runs_observed = 0
        #: cumulative covered-bit curve, one point per observed run
        self.curve: List[int] = []

    # -- feeding -----------------------------------------------------------

    def observe(self, buckets: Sequence[int]) -> CoverageDelta:
        """Fold one EXECUTED run's dispatch order into the map. ONE
        vectorized pair derivation feeds both the bitmap and the pair
        table (this runs per stored run on every ingest — a second
        interpreted window walk would double the dominant cost)."""
        seq = np.asarray(buckets, np.int64)[:SCAN_CAP]
        bx, ox, by, oy, gaps = _pair_keys(seq, self.window, SCAN_CAP)
        n = len(seq)
        if len(bx):
            bits = np.unique(_keys_to_bits(bx, ox, by, oy, self.width))
            # group repeated pairs OUTSIDE the lock: the dict fold then
            # touches each DISTINCT pair once (count + min gap come in
            # aggregated), so the interpreted per-occurrence walk —
            # the dominant ingest cost on hint-repetitive workloads —
            # collapses to the run's unique-pair count
            # collision-free composite: occurrences < SCAN_CAP+1 by
            # construction, buckets < 2^20 for any realistic H, and
            # the full key stays < 2^64
            comp = (((bx.astype(np.uint64) * np.uint64(SCAN_CAP + 1)
                      + ox.astype(np.uint64))
                     * np.uint64(2 ** 20) + by.astype(np.uint64))
                    * np.uint64(SCAN_CAP + 1) + oy.astype(np.uint64))
            _, first_idx, inverse, counts = np.unique(
                comp, return_index=True, return_inverse=True,
                return_counts=True)
            min_gaps = np.full((len(first_idx),), n + 1, np.int64)
            np.minimum.at(min_gaps, inverse, gaps)
        else:
            bits = np.zeros((0,), np.int64)
            first_idx = counts = min_gaps = np.zeros((0,), np.int64)
        with self._lock:
            new_bits = first = flipped = 0
            if len(bits):
                new_bits = int((~self._bits[bits]).sum())
                self._bits[bits] = True
            for k in range(len(first_idx)):
                i = int(first_idx[k])
                key = (int(bx[i]), int(ox[i]), int(by[i]), int(oy[i]))
                gap = int(min_gaps[k])
                count = int(counts[k])
                seen = self._pairs.get(key)
                if seen is None:
                    if len(self._pairs) < self.max_pairs:
                        self._pairs[key] = count
                        first += 1
                        self._gap[key] = gap
                        if (key[2], key[3],
                                key[0], key[1]) in self._pairs:
                            flipped += 1
                    else:
                        self.pair_overflow += count
                else:
                    self._pairs[key] = seen + count
                    if gap < self._gap.get(key, self.window + 1):
                        self._gap[key] = gap
            self.runs_observed += 1
            covered = int(self._bits.sum())
            self.curve.append(covered)
        return CoverageDelta(new_bits=new_bits, first_covered=first,
                             flipped=flipped,
                             interesting=new_bits > 0 or flipped > 0)

    def merge_bits(self, bit_indices: Sequence[int]) -> int:
        """OR fleet coverage into this map (knowledge warm-start:
        relations the FLEET already exercised are not this campaign's
        frontier). Returns how many bits were new locally. Pair
        identities don't travel the wire — merged bits dampen the
        novelty bonus but cannot (and need not) name relations."""
        with self._lock:
            fresh = 0
            for b in bit_indices:
                b = int(b)
                if 0 <= b < self.width and not self._bits[b]:
                    self._bits[b] = True
                    fresh += 1
            return fresh

    # -- reading -----------------------------------------------------------

    def covered(self) -> int:
        with self._lock:
            return int(self._bits.sum())

    def occupancy(self) -> float:
        return self.covered() / float(self.width)

    def bits_list(self) -> List[int]:
        """Sparse wire form (knowledge push)."""
        with self._lock:
            return [int(i) for i in np.flatnonzero(self._bits)]

    def predicted_gain(self, buckets: Sequence[int]) -> float:
        """Fraction of a candidate order's relations that are currently
        UNCOVERED — the coverage-guided fitness bonus in [0, 1]. 0 for
        an empty candidate (nothing predicted, nothing rewarded)."""
        bits = signature_bits(buckets, self.width, self.window)
        if not len(bits):
            return 0.0
        with self._lock:
            new = int((~self._bits[bits]).sum())
        return new / float(len(bits))

    def one_sided(self, top: Optional[int] = None) -> List[Dict[str, Any]]:
        """The nameable frontier: directed relations whose REVERSE was
        never observed, ranked by predicted flip score — count-weighted
        proximity (a pair dispatched 2 positions apart flips with a
        small delay nudge; one 30 positions apart realistically
        doesn't)."""
        with self._lock:
            rows = []
            for (bx, ox, by, oy), count in self._pairs.items():
                if (by, oy, bx, ox) in self._pairs:
                    continue  # both directions covered
                gap = self._gap.get((bx, ox, by, oy), self.window)
                score = count / float(1 + gap)
                rows.append({
                    "first": f"b{bx}#{ox}", "then": f"b{by}#{oy}",
                    "buckets": [bx, by],
                    "count": count, "min_gap": gap,
                    "flip_score": round(score, 4),
                })
        rows.sort(key=lambda r: (-r["flip_score"],
                                 r["first"], r["then"]))
        return rows if top is None else rows[:top]

    def one_sided_count(self) -> int:
        with self._lock:
            return sum(1 for (bx, ox, by, oy) in self._pairs
                       if (by, oy, bx, ox) not in self._pairs)

    def mutation_bias(self, max_boost: float = 4.0) -> np.ndarray:
        """Per-bucket mutation-rate multiplier f32[H] (>= 1 everywhere):
        buckets participating in one-sided relations get boosted in
        proportion to their summed flip scores, normalized so the
        hottest bucket mutates ``max_boost`` times as often. A map with
        no one-sided relations (or no observations) returns all-ones —
        guidance-off-equivalent mutation. Accumulated straight off the
        pair table (this runs every search round; the formatted
        ``one_sided`` rows are for humans)."""
        weight = np.zeros((self.H,), np.float64)
        with self._lock:
            for (bx, ox, by, oy), count in self._pairs.items():
                if (by, oy, bx, ox) in self._pairs:
                    continue
                gap = self._gap.get((bx, ox, by, oy), self.window)
                score = count / float(1 + gap)
                for b in (bx, by):
                    if 0 <= b < self.H:
                        weight[b] += score
        peak = weight.max()
        if peak <= 0:
            return np.ones((self.H,), np.float32)
        bias = 1.0 + (max_boost - 1.0) * (weight / peak)
        return np.asarray(bias, np.float32)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            covered = int(self._bits.sum())
            return {
                "H": self.H,
                "width": self.width,
                "window": self.window,
                "covered_bits": covered,
                "occupancy": round(covered / float(self.width), 4),
                "directed_pairs": len(self._pairs),
                "pair_overflow": self.pair_overflow,
                "runs_observed": self.runs_observed,
                "curve": list(self.curve[-64:]),
            }
