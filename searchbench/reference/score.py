"""The plain scorer: a schedule table's fitness against recorded runs.

Written from the search plane's stated arithmetic with NumPy alone; the
arithmetic the configuration states in float32 (event times, the time
differences and the window index) is float32 here, the distances are
float64.

A table ``d f32[H]`` holds a value per hint bucket. In delay mode an
event of bucket ``b`` is released at ``arrival + d[b]``. In order mode
(``release_mode = "reorder"``) the table holds priorities: events batch
into arrival windows of ``window`` seconds (the window of an event is
``floor(arrival * f32(1 / window))``), and each window releases its
events ``gap`` seconds apart from its end, in the order of (priority of
their bucket, arrival, position). The first release of each bucket
(``1e9`` where the bucket is absent) gives the features over ``K``
bucket pairs ``(u, v)``: ``sigmoid(clip((first[v] - first[u]) / tau,
-30, 30))``. Against ``T`` reference runs, with the archive of executed
runs and the failure archive (rows of features), the fitness is the
mean over the runs of the least squared distance to the archive, minus
that mean to the failures, minus ``delay_cost`` times the table's mean.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np

BIG = np.float32(1e9)


class Weights(NamedTuple):
    tau: float
    delay_cost: float
    order: bool = False
    gap: float = 0.0
    window: float = 0.0


def weights_of(search_params: dict) -> Weights:
    """The scorer's weights of a request's search parameters."""
    if search_params.get("release_mode", "delay") == "reorder":
        gap = max(float(search_params.get("reorder_gap", 0.002)), 1e-4)
        return Weights(tau=gap * 0.5, delay_cost=0.0, order=True, gap=gap,
                       window=max(float(search_params.get(
                           "reorder_window", 0.05)), 0.0))
    return Weights(tau=float(search_params.get("tau", 0.005)),
                   delay_cost=float(search_params.get("w_delay_cost", 0.01)))


def sample_pairs(K: int, H: int, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    u = rng.randint(0, H, size=K)
    v = rng.randint(0, H - 1, size=K)
    v = np.where(v >= u, v + 1, v)
    return np.stack([u, v], axis=1).astype(np.int64)


def pairs_over(occupied: Sequence[int], K: int, H: int,
               seed: int) -> np.ndarray:
    """``K`` ordered bucket pairs: every ordered pair of the occupied
    buckets (ascending), or a seeded choice of ``K`` of them kept in that
    order; filled up with seeded uniform pairs when there are fewer."""
    occ = sorted(set(int(b) for b in occupied))
    pairs = [(u, v) for u in occ for v in occ if u != v]
    if len(pairs) >= K:
        pick = np.random.RandomState(seed).choice(len(pairs), size=K,
                                                  replace=False)
        return np.array([pairs[i] for i in sorted(pick)], np.int64)
    fill = sample_pairs(K - len(pairs), H, seed)
    if not pairs:
        return fill
    return np.concatenate([np.array(pairs, np.int64), fill])


def _first(times: np.ndarray, buckets: np.ndarray, H: int) -> np.ndarray:
    """``[G, H]`` first release a bucket of ``times [G, L]``."""
    first = np.full((times.shape[0], H), BIG, np.float32)
    rows = np.repeat(np.arange(times.shape[0]), times.shape[1])
    np.minimum.at(first, (rows, np.tile(buckets, times.shape[0])),
                  times.ravel())
    return first


def order_times(prio: np.ndarray, buckets: np.ndarray, arrival: np.ndarray,
                w: Weights) -> np.ndarray:
    """``[G, L]`` release times of ``G`` priority tables under windowed
    reordering."""
    L = buckets.shape[0]
    if w.window > 0:
        inv = np.float32(1.0) / np.float32(w.window)
        win = np.floor(arrival * inv).astype(np.int64)
    else:
        win = np.zeros(L, np.int64)
    out = np.empty((prio.shape[0], L), np.float32)
    pos = np.arange(L)
    for g in range(prio.shape[0]):
        p = prio[g][buckets]
        rank = np.lexsort((pos, arrival, p, win))  # last key sorts first
        w_sorted = win[rank]
        starts = np.flatnonzero(np.r_[True, w_sorted[1:] != w_sorted[:-1]])
        seg = np.repeat(starts, np.diff(np.r_[starts, L]))
        within = np.empty(L, np.int64)
        within[rank] = pos - seg
        out[g] = ((win.astype(np.float32) + np.float32(1.0))
                  * np.float32(w.window)
                  + within.astype(np.float32) * np.float32(w.gap))
    return out


def features(tables: np.ndarray, buckets: np.ndarray, arrival: np.ndarray,
             pairs: np.ndarray, w: Weights, H: int,
             order: Optional[bool] = None) -> np.ndarray:
    """``[G, K]`` float64 features of ``G`` tables against one run (in
    the weights' mode unless ``order`` says otherwise)."""
    tables = np.asarray(tables, np.float32).reshape(-1, H)
    if w.order if order is None else order:
        t = order_times(tables, buckets, arrival, w)
    else:
        t = arrival[None, :] + tables[:, buckets]
    first = _first(t.astype(np.float32), buckets, H)
    z = (first[:, pairs[:, 1]] - first[:, pairs[:, 0]]) / np.float32(w.tau)
    z = np.clip(z, -30.0, 30.0).astype(np.float64)
    return 1.0 / (1.0 + np.exp(-z))


def run_features(buckets: np.ndarray, times: np.ndarray, pairs: np.ndarray,
                 w: Weights, H: int) -> np.ndarray:
    """``[K]`` features of a run as recorded (no delay added)."""
    return features(np.zeros((1, H), np.float32), buckets, times, pairs, w,
                    H, order=False)[0]


def tf32(x: np.ndarray) -> np.ndarray:
    """``x`` rounded to TF32 (10 mantissa bits, to nearest, ties away)."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = ((b + 0x1000) & 0xFFFFE000).astype(np.uint32)
    return b.view(np.float32)


def min_sq(feats: np.ndarray, rows: np.ndarray,
           precision: str = "f64") -> np.ndarray:
    """``[G]`` least squared distance of each feature row to ``rows``:
    in float64 (``|f|^2 + |r|^2 - 2 f.r``, float64 leaves it exact to
    far below the float32 the search computes in), or (``"tf32"``) with
    the cross term of TF32 inputs, summed in float32, as a TF32 matrix
    product gives it."""
    if precision == "f64":
        f = np.asarray(feats, np.float64)
        r = np.asarray(rows, np.float64)
        d = (f * f).sum(-1)[:, None] + (r * r).sum(-1)[None] - 2.0 * (f @ r.T)
        return np.maximum(d, 0.0).min(-1)
    f = np.asarray(feats, np.float32)
    r = np.asarray(rows, np.float32)
    cross = (tf32(f) @ tf32(r).T).astype(np.float32)
    f2 = (f * f).sum(-1, keepdims=True)
    r2 = (r * r).sum(-1)[None]
    return np.maximum(f2 + r2 - np.float32(2.0) * cross, 0.0).min(-1)


def fitness(tables: np.ndarray, refs: Sequence[tuple], pairs: np.ndarray,
            archive: np.ndarray, failures: np.ndarray, w: Weights, H: int,
            precision: str = "f64") -> np.ndarray:
    """``[G]`` fitness of ``G`` tables against the reference runs
    ``refs`` (``(buckets, arrival)`` each)."""
    tables = np.asarray(tables, np.float32).reshape(-1, H)
    nov = np.zeros(tables.shape[0])
    bug = np.zeros(tables.shape[0])
    for buckets, arrival in refs:
        f = features(tables, buckets, arrival, pairs, w, H)
        nov += min_sq(f, archive, precision)
        bug += min_sq(f, failures, precision)
    T = len(refs)
    return (nov / T - bug / T
            - w.delay_cost * tables.astype(np.float64).mean(-1))
