"""Schedule scoring, the search plane's inner loop: the port of
``namazu_tpu/ops/schedule.py``.

A schedule genome is a per-hint-bucket delay table ``delays f32[H]`` and
a fault-probability table ``faults f32[H]``. Against a recorded trace,
the counterfactual release times are ``t[e] = arrival[e] +
delays[hint_ids[e]]`` in delay mode; in order mode the table holds
priorities and :func:`order_release_times` permutes the events within
arrival windows. With a fault half, event ``e`` of bucket ``h`` is
dropped iff ``coin[h] < faults[h]`` and its class can carry a fault.
Scoring a population ``[P, H]``:

1. with faults, the drop mask removes events and counts them;
2. first-occurrence time per hint bucket (scatter-min), ``f32[.., H]``;
3. precedence features over K bucket pairs,
   ``sigmoid(clip((first[v] - first[u]) / tau, -30, 30))``;
4. novelty = min squared distance to the archive of executed runs and
   bug distance = min squared distance to the failure archive, both from
   one pass of the pair-distance kernel (``ops/pair_distance.py``);
5. fitness = w_novelty * novelty - w_bug * bug - w_delay_cost *
   mean(delays) - fault_cost * dropped / live events.

The JAX ``vmap`` over genomes and traces is written out as batch
dimensions: the release times of P genomes against T traces of L events
are one ``[P, T, L]`` gather, and a fault drop mask is ``[P, T, L]`` too.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from namazu_tpu_torch.ops import pair_distance
from namazu_tpu_torch.ops.pair_distance import (  # noqa: F401 (MASK_BIG)
    MASK_BIG,
    Occupancy,
    min_sq_distance_pair,
)

BIG = 1e9  # "never happens" release time

# delay-mode traces longer than this are scored blockwise, in chunks of
# LONG_TRACE_CHUNK events, so no [P, T, L] intermediate is ever built.
# Order mode always scores dense: a windowed permutation sorts the whole
# trace at once.
LONG_TRACE_THRESHOLD = 1024
LONG_TRACE_CHUNK = 512

# order mode sorts int64 keys of [P, T, L] events; populations whose
# P * T * L exceeds this are scored in slices of genome rows, which keeps
# the peak at a few GB (PERF.md records it at [4096, 4, 4096])
ORDER_CHUNK_ELEMS = 1 << 25

_INT32_MAX = 2**31 - 1


class TraceArrays(NamedTuple):
    """One trace ``[L]`` or a stack of traces ``[T, L]`` on the device.
    ``faultable`` marks events whose class can carry a fault; ``None``
    treats every event as faultable."""

    hint_ids: torch.Tensor  # int[.., L]
    arrival: torch.Tensor  # float32[.., L]
    mask: torch.Tensor  # bool[.., L]
    faultable: Optional[torch.Tensor] = None  # bool[.., L]


class ScoreWeights(NamedTuple):
    novelty: float = 1.0
    bug: float = 1.0
    delay_cost: float = 0.01
    tau: float = 0.005  # precedence smoothing, seconds
    fault_cost: float = 0.05  # per dropped event, as a share of live ones
    order_mode: bool = False  # the table holds priorities, not delays
    order_gap: float = 0.001  # seconds between consecutive releases
    order_window: float = 0.0  # reorder-window size; 0 = whole trace


def normalize_fault_trace(trace: TraceArrays,
                          coin: Optional[torch.Tensor]) -> TraceArrays:
    """The faultable-flag contract at scoring entry points: without a
    fault coin the flag is never read, so it is dropped; with a coin and
    no flag, every event is faultable."""
    if coin is None:
        return trace._replace(faultable=None)
    if trace.faultable is None:
        return trace._replace(faultable=torch.ones_like(trace.mask))
    return trace


def release_times(delays: torch.Tensor, trace: TraceArrays) -> torch.Tensor:
    """``t = arrival + delays[hint_ids]`` (masked -> BIG). ``delays
    [.., H]`` against a trace ``[.., L]`` gives ``[.., *trace dims, L]``."""
    t = trace.arrival + delays[..., trace.hint_ids.long()]
    return torch.where(trace.mask, t, BIG)


def drop_mask(faults: torch.Tensor, coin: torch.Tensor,
              trace: TraceArrays) -> torch.Tensor:
    """Events the fault table removes from the counterfactual: ``faults
    [.., H]`` against a trace ``[.., L]`` gives bool ``[.., *trace dims,
    L]``. Event ``e`` drops iff it is live, ``coin[h] < faults[h]`` for
    its bucket ``h`` (the policy's own replay decision) and, where the
    trace carries the flag, its class can carry a fault."""
    below = coin < faults  # [.., H]
    d = trace.mask & below[..., trace.hint_ids.long()]
    if trace.faultable is not None:
        d = d & trace.faultable
    return d


def apply_faults(trace: TraceArrays, faults: Optional[torch.Tensor],
                 coin: Optional[torch.Tensor]) -> TraceArrays:
    """The trace with fault-dropped events masked out (the trace itself
    without a fault half); the mask takes the genomes' batch shape."""
    if faults is None:
        return trace
    dropped = drop_mask(faults, coin, trace)
    return TraceArrays(trace.hint_ids, trace.arrival,
                       trace.mask & ~dropped, trace.faultable)


def _drop_count(trace: TraceArrays, eff: TraceArrays,
                faults: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Dropped events per genome and trace, ``[.., *trace dims]``; None
    without a fault half."""
    if faults is None:
        return None
    return trace.mask.sum(-1) - eff.mask.sum(-1)


def _sortable_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 in ``[0, 2**32)`` ordered as the f32 values ``x`` are, with
    -0.0 equal to 0.0 as the reference's sort compares them (``x + 0.0``
    turns -0.0 into +0.0 under IEEE rounding)."""
    b = (x + 0.0).view(torch.int32).long()
    # negative floats order backwards in their bits: flip them all;
    # non-negative ones go above every negative one
    return torch.where(b < 0, ~b, b + 2**31)


def order_ranks(prio: torch.Tensor, trace: TraceArrays, window: float = 0.0
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(order, within, win)`` of the windowed permutation, each
    ``[.., *trace dims, L]``: ``order`` lists event indices by rank,
    ``within`` is each event's rank inside its arrival window, ``win`` its
    window (``INT32_MAX`` where masked).

    Events rank by window, then priority ``prio[hint]``, then arrival,
    remaining ties in index order, as ``jnp.lexsort`` ranks them in the
    reference. Torch has no lexsort: each trace is stable-sorted by
    arrival once (arrival does not depend on the genome), then each
    genome row is stable-sorted on one int64 key, the window in the high
    32 bits and the priority's order-preserving bits in the low 32.

    The window is ``floor(arrival * (1 / window))`` with the reciprocal
    rounded to f32 first: the reference's ``floor(arrival / window)`` as
    XLA compiles it under ``jit`` (a division by a constant becomes a
    product with its f32 reciprocal), which is what a campaign scores.
    Eager JAX divides, and within an ulp of a window edge the two can
    disagree."""
    hint = trace.hint_ids.long()
    L = hint.shape[-1]
    if window > 0:
        inv = float(torch.tensor(1.0) / torch.tensor(window))  # f32
        win = torch.floor(trace.arrival * inv).to(torch.int32)
    else:
        win = torch.zeros(hint.shape, dtype=torch.int32, device=hint.device)
    win = torch.where(trace.mask, win, _INT32_MAX)
    key = torch.where(trace.mask, prio[..., hint], float("inf"))
    k64 = win.long() * 2**32 + _sortable_bits(key)
    by_arrival = torch.sort(trace.arrival + 0.0, dim=-1,
                            stable=True).indices.expand(k64.shape)
    skey, pos = torch.sort(k64.gather(-1, by_arrival), dim=-1, stable=True)
    order = by_arrival.gather(-1, pos)
    # rank inside the window, in sorted order: position minus the start
    # of the event's window segment (the cummax of segment starts)
    sw = skey >> 32
    idx = torch.arange(L, device=hint.device)
    is_start = torch.ones(sw.shape, dtype=torch.bool, device=hint.device)
    is_start[..., 1:] = sw[..., 1:] != sw[..., :-1]
    seg_start = torch.cummax(torch.where(is_start, idx, 0), dim=-1).values
    within = torch.empty_like(order).scatter_(-1, order, idx - seg_start)
    return order, within, win


def order_release_times(prio: torch.Tensor, trace: TraceArrays,
                        gap: float, window: float = 0.0) -> torch.Tensor:
    """Counterfactual release times under windowed permutation, what the
    policy's reorder buffer (``release_mode = "reorder"``) realizes:
    events batch into arrival windows of ``window`` seconds, and each
    batch is released in ``(prio[hint], arrival)`` order, ``gap`` seconds
    apart, from the window's end. ``window = 0`` is one global window.
    ``prio [.., H]`` against a trace ``[.., L]`` gives ``[.., *trace
    dims, L]``; masked events stay BIG."""
    _, within, win = order_ranks(prio, trace, window)
    t = (win.float() + 1.0) * window + within.float() * gap
    return torch.where(trace.mask, t, BIG)


def first_occurrence(t: torch.Tensor, trace: TraceArrays,
                     H: int) -> torch.Tensor:
    """Earliest release time per hint bucket, BIG where absent:
    ``t [.., L] -> [.., H]``."""
    src = torch.where(trace.mask, t, BIG)
    idx = trace.hint_ids.long().expand(t.shape)
    first = torch.full(t.shape[:-1] + (H,), BIG, dtype=t.dtype,
                       device=t.device)
    return first.scatter_reduce_(-1, idx, src, "amin", include_self=True)


def first_occurrence_blockwise(delays: torch.Tensor, trace: TraceArrays,
                               chunk: int = LONG_TRACE_CHUNK,
                               faults: Optional[torch.Tensor] = None,
                               coin: Optional[torch.Tensor] = None
                               ) -> Tuple[torch.Tensor,
                                          Optional[torch.Tensor]]:
    """``(first [P, *trace dims, H], dropped [P, *trace dims])`` of
    genomes ``delays [P, H]`` over an arbitrarily long trace, a chunk of
    events at a time. min is associative, so the running ``[.., H]``
    minimum is the carry and the peak buffer is one ``[P, T, chunk]``
    block. Fault drops go per chunk through :func:`drop_mask`'s rule;
    ``dropped`` is None without a fault half."""
    H = delays.shape[-1]
    L = trace.hint_ids.shape[-1]
    lead = delays.shape[:-1] + trace.hint_ids.shape[:-1]
    first = torch.full(lead + (H,), BIG, dtype=delays.dtype,
                       device=delays.device)
    hint = trace.hint_ids.long()
    ndrop = None
    if faults is not None:
        below = coin < faults  # [P, H]
        ndrop = torch.zeros(lead, dtype=torch.int64, device=delays.device)
    for s in range(0, L, chunk):
        h = hint[..., s:s + chunk]
        m = trace.mask[..., s:s + chunk]
        if faults is not None:
            drop = m & below[..., h]
            if trace.faultable is not None:
                drop = drop & trace.faultable[..., s:s + chunk]
            m = m & ~drop
            ndrop += drop.sum(-1)
        t = torch.where(m, trace.arrival[..., s:s + chunk] + delays[..., h],
                        BIG)
        first.scatter_reduce_(-1, h.expand(t.shape), t, "amin",
                              include_self=True)
    return first, ndrop


def precedence_features(first: torch.Tensor, pairs: torch.Tensor,
                        tau: float) -> torch.Tensor:
    """``feat[k] = sigmoid((first[v_k] - first[u_k]) / tau)`` in (0,1)."""
    pairs = pairs.long()
    du = first[..., pairs[:, 0]]
    dv = first[..., pairs[:, 1]]
    # clip so BIG-vs-finite saturates instead of overflowing
    return torch.sigmoid(torch.clamp((dv - du) / tau, -30.0, 30.0))


def _order_first_rows(prio, trace, H, gap, window, faults, coin):
    eff = apply_faults(trace, faults, coin)
    t = order_release_times(prio, eff, gap, window)
    return first_occurrence(t, eff, H), _drop_count(trace, eff, faults)


def _order_first(prio, trace, H, gap, window, faults, coin):
    """Order-mode first occurrences (and drops) of genomes ``prio [P,
    H]``, in slices of rows that keep each slice's ``rows * T * L`` at
    most ORDER_CHUNK_ELEMS."""
    rows = max(1, ORDER_CHUNK_ELEMS // trace.hint_ids.numel())
    if prio.dim() == 1 or rows >= prio.shape[0]:
        return _order_first_rows(prio, trace, H, gap, window, faults, coin)
    parts = [_order_first_rows(
        prio[s:s + rows], trace, H, gap, window,
        None if faults is None else faults[s:s + rows], coin)
        for s in range(0, prio.shape[0], rows)]
    first = torch.cat([f for f, _ in parts])
    return first, None if faults is None else torch.cat(
        [n for _, n in parts])


def _genome_features(delays: torch.Tensor, trace: TraceArrays,
                     pairs: torch.Tensor, tau: float,
                     order_mode: bool = False, order_gap: float = 0.001,
                     order_window: float = 0.0,
                     faults: Optional[torch.Tensor] = None,
                     coin: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(features [.., *trace dims, K], dropped [.., *trace dims])`` of
    genomes ``delays [.., H]``; ``dropped`` is None without a fault half.
    Delay-mode traces longer than LONG_TRACE_THRESHOLD take the blockwise
    path; order mode always scores dense."""
    H = delays.shape[-1]
    if not order_mode and trace.hint_ids.shape[-1] > LONG_TRACE_THRESHOLD:
        first, ndrop = first_occurrence_blockwise(delays, trace,
                                                  faults=faults, coin=coin)
    elif order_mode:
        first, ndrop = _order_first(delays, trace, H, order_gap,
                                    order_window, faults, coin)
    else:
        eff = apply_faults(trace, faults, coin)
        first = first_occurrence(release_times(delays, eff), eff, H)
        ndrop = _drop_count(trace, eff, faults)
    return precedence_features(first, pairs, tau), ndrop


def schedule_features(delays: torch.Tensor, trace: TraceArrays,
                      pairs: torch.Tensor, tau: float,
                      order_mode: bool = False, order_gap: float = 0.001,
                      order_window: float = 0.0,
                      faults: Optional[torch.Tensor] = None,
                      coin: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Features of genomes ``delays [.., H]`` (and their fault tables)."""
    return _genome_features(delays, trace, pairs, tau, order_mode,
                            order_gap, order_window, faults, coin)[0]


def trace_features(trace: TraceArrays, pairs: torch.Tensor, tau: float,
                   H: int) -> torch.Tensor:
    """Feature vector of a trace as recorded (zero extra delay): embeds
    executed runs, failures included, into the same space."""
    zero = torch.zeros((H,), dtype=torch.float32,
                       device=trace.arrival.device)
    return schedule_features(zero, trace, pairs, tau)


def min_sq_distance(feats: torch.Tensor, archive: torch.Tensor,
                    valid_n: Occupancy = None) -> torch.Tensor:
    """``min_a |f_p - a|^2`` for ``feats [P, K]``, ``archive [A, K]`` ->
    ``[P]``, rows at or past ``valid_n`` masked with MASK_BIG. CUDA tensors
    launch the single-archive kernel (B2), CPU tensors its plain version."""
    return pair_distance.min_sq_distance(feats, archive, valid_n)


def _min_sq_distance_best(feats: torch.Tensor, archive: torch.Tensor,
                          valid_n: Occupancy = None) -> torch.Tensor:
    """The reference's dispatch point for the fused-min kernel: here the
    same function as :func:`min_sq_distance` (the kernel on the card, the
    plain version on the CPU)."""
    return min_sq_distance(feats, archive, valid_n)


def _min_sq_pair_best(feats: torch.Tensor, archive: torch.Tensor,
                      failures: torch.Tensor,
                      archive_n: Occupancy = None,
                      failure_n: Occupancy = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(novelty d2 [N], bug d2 [N])`` against both archives in one pass of
    the pair-distance kernel. An occupancy of zero yields a neutral 0.0
    distance: an empty ring carries no information."""
    nov, bug = min_sq_distance_pair(feats, archive, failures,
                                    archive_n=archive_n,
                                    failure_n=failure_n)
    return _neutral_if_empty(nov, archive_n), _neutral_if_empty(bug, failure_n)


def _neutral_if_empty(d2: torch.Tensor, n: Occupancy) -> torch.Tensor:
    if n is None:
        return d2
    if isinstance(n, torch.Tensor):  # stays on the device: no host sync
        return torch.where(n.to(d2.device) > 0, d2, 0.0)
    return d2 if n > 0 else torch.zeros_like(d2)


def _fitness(delays, novelty, bug, weights: ScoreWeights, novelty_scale,
             fault_pen=None):
    w_nov = (weights.novelty if novelty_scale is None
             else weights.novelty * novelty_scale)
    fit = (w_nov * novelty + weights.bug * bug
           - weights.delay_cost * delays.mean(-1))
    return fit if fault_pen is None else fit - fault_pen


def _features_of(delays, traces, pairs, weights: ScoreWeights, faults, coin):
    return _genome_features(delays, traces, pairs, weights.tau,
                            weights.order_mode, weights.order_gap,
                            weights.order_window, faults, coin)


def score_population(
    delays: torch.Tensor,  # [P, H]
    trace: TraceArrays,  # one trace [L]
    pairs: torch.Tensor,  # [K, 2]
    archive: torch.Tensor,  # [A, K]
    failure_feats: torch.Tensor,  # [F, K]
    weights: ScoreWeights = ScoreWeights(),
    faults: Optional[torch.Tensor] = None,  # [P, H]
    coin: Optional[torch.Tensor] = None,  # [H]
    novelty_scale=None,
    archive_n: Occupancy = None,
    failure_n: Occupancy = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fitness ``f32[P]`` and features ``f32[P, K]`` of a population
    against one trace. With ``faults`` and ``coin`` the genome's fault
    half drops events before first occurrence, and ``fault_cost`` per
    dropped event (as a share of the live ones) keeps "drop everything"
    from being the novelty optimum. ``archive_n``/``failure_n`` mask rows
    past a ring's occupancy; the search passes ``None`` (unoccupied slots
    are neutral 0.5 feature points, as in the reference)."""
    feats, ndrop = _features_of(delays, trace, pairs, weights, faults, coin)
    nov_d2, bug_d2 = _min_sq_pair_best(feats, archive, failure_feats,
                                       archive_n, failure_n)
    pen = None
    if faults is not None:
        live = trace.mask.sum().clamp_min(1)
        pen = weights.fault_cost * ndrop / live
    return _fitness(delays, nov_d2, -bug_d2, weights, novelty_scale,
                    pen), feats


def score_population_multi(
    delays: torch.Tensor,  # [P, H]
    traces: TraceArrays,  # [T, L]
    pairs: torch.Tensor,  # [K, 2]
    archive: torch.Tensor,  # [A, K]
    failure_feats: torch.Tensor,  # [F, K]
    weights: ScoreWeights = ScoreWeights(),
    faults: Optional[torch.Tensor] = None,  # [P, H]
    coin: Optional[torch.Tensor] = None,  # [H]
    novelty_scale=None,
    archive_n: Occupancy = None,
    failure_n: Occupancy = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fitness aggregated over T recorded traces: novelty, bug distance
    and the drop share are averaged over the traces. Returns ``(fitness
    f32[P], feats f32[P, T, K])``; the ``P*T`` feature rows go through one
    launch of the pair-distance kernel."""
    feats, ndrop = _features_of(delays, traces, pairs, weights, faults,
                                coin)
    P, T, K = feats.shape
    nov_d2, bug_d2 = _min_sq_pair_best(feats.reshape(P * T, K), archive,
                                       failure_feats, archive_n, failure_n)
    novelty = nov_d2.reshape(P, T).mean(1)
    bug = -bug_d2.reshape(P, T).mean(1)
    pen = None
    if faults is not None:
        frac = ndrop / traces.mask.sum(-1).clamp_min(1)  # [P, T]
        pen = weights.fault_cost * frac.mean(1)
    return _fitness(delays, novelty, bug, weights, novelty_scale,
                    pen), feats
