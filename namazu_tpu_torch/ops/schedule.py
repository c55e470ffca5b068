"""Schedule scoring, the search plane's inner loop: the port of
``namazu_tpu/ops/schedule.py`` for delay mode without faults.

A schedule genome is a per-hint-bucket delay table ``delays f32[H]``.
Against a recorded trace, the counterfactual release times are
``t[e] = arrival[e] + delays[hint_ids[e]]``. Scoring a population
``[P, H]``:

1. first-occurrence time per hint bucket (scatter-min), ``f32[.., H]``;
2. precedence features over K bucket pairs,
   ``sigmoid(clip((first[v] - first[u]) / tau, -30, 30))``;
3. novelty = min squared distance to the archive of executed runs and
   bug distance = min squared distance to the failure archive, both from
   one pass of the pair-distance kernel (``ops/pair_distance.py``);
4. fitness = w_novelty * novelty - w_bug * bug - w_delay_cost * mean(delays).

The JAX ``vmap`` over genomes and traces is written out as batch
dimensions: the release times of P genomes against T traces of L events
are one ``[P, T, L]`` gather. Order mode and the fault half of the genome
are later slices of the port and raise ``NotImplementedError``.
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
# LONG_TRACE_CHUNK events, so no [P, T, L] intermediate is ever built
LONG_TRACE_THRESHOLD = 1024
LONG_TRACE_CHUNK = 512


class TraceArrays(NamedTuple):
    """One trace ``[L]`` or a stack of traces ``[T, L]`` on the device.
    ``faultable`` is carried for field parity and unused in delay mode."""

    hint_ids: torch.Tensor  # int[.., L]
    arrival: torch.Tensor  # float32[.., L]
    mask: torch.Tensor  # bool[.., L]
    faultable: Optional[torch.Tensor] = None


class ScoreWeights(NamedTuple):
    novelty: float = 1.0
    bug: float = 1.0
    delay_cost: float = 0.01
    tau: float = 0.005  # precedence smoothing, seconds
    fault_cost: float = 0.05
    order_mode: bool = False
    order_gap: float = 0.001
    order_window: float = 0.0


def _require_delay_mode(weights: ScoreWeights, faults=None,
                        coin=None) -> None:
    if weights.order_mode:
        raise NotImplementedError(
            "namazu_tpu_torch scores delay mode only; order mode is a "
            "later slice of the port")
    if faults is not None or coin is not None:
        raise NotImplementedError(
            "namazu_tpu_torch scores genomes without faults; the fault "
            "half is a later slice of the port")


def release_times(delays: torch.Tensor, trace: TraceArrays) -> torch.Tensor:
    """``t = arrival + delays[hint_ids]`` (masked -> BIG). ``delays
    [.., H]`` against a trace ``[.., L]`` gives ``[.., *trace dims, L]``."""
    t = trace.arrival + delays[..., trace.hint_ids.long()]
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
                               chunk: int = LONG_TRACE_CHUNK
                               ) -> torch.Tensor:
    """First-occurrence times ``[P, *trace dims, H]`` of genomes ``delays
    [P, H]`` over an arbitrarily long trace, a chunk of events at a time.
    min is associative, so the running ``[.., H]`` minimum is the carry and
    the peak buffer is one ``[P, T, chunk]`` block."""
    H = delays.shape[-1]
    L = trace.hint_ids.shape[-1]
    lead = delays.shape[:-1] + trace.hint_ids.shape[:-1]
    first = torch.full(lead + (H,), BIG, dtype=delays.dtype,
                       device=delays.device)
    hint = trace.hint_ids.long()
    for s in range(0, L, chunk):
        h = hint[..., s:s + chunk]
        t = torch.where(trace.mask[..., s:s + chunk],
                        trace.arrival[..., s:s + chunk] + delays[..., h],
                        BIG)
        first.scatter_reduce_(-1, h.expand(t.shape), t, "amin",
                              include_self=True)
    return first


def precedence_features(first: torch.Tensor, pairs: torch.Tensor,
                        tau: float) -> torch.Tensor:
    """``feat[k] = sigmoid((first[v_k] - first[u_k]) / tau)`` in (0,1)."""
    pairs = pairs.long()
    du = first[..., pairs[:, 0]]
    dv = first[..., pairs[:, 1]]
    # clip so BIG-vs-finite saturates instead of overflowing
    return torch.sigmoid(torch.clamp((dv - du) / tau, -30.0, 30.0))


def _genome_features(delays: torch.Tensor, trace: TraceArrays,
                     pairs: torch.Tensor, tau: float) -> torch.Tensor:
    """Features ``[.., *trace dims, K]`` of genomes ``delays [.., H]``.
    Traces longer than LONG_TRACE_THRESHOLD take the blockwise path."""
    H = delays.shape[-1]
    if trace.hint_ids.shape[-1] > LONG_TRACE_THRESHOLD:
        first = first_occurrence_blockwise(delays, trace)
    else:
        first = first_occurrence(release_times(delays, trace), trace, H)
    return precedence_features(first, pairs, tau)


def trace_features(trace: TraceArrays, pairs: torch.Tensor, tau: float,
                   H: int) -> torch.Tensor:
    """Feature vector of a trace as recorded (zero extra delay): embeds
    executed runs, failures included, into the same space."""
    zero = torch.zeros((H,), dtype=torch.float32,
                       device=trace.arrival.device)
    return _genome_features(zero, trace, pairs, tau)


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


def _fitness(delays, novelty, bug, weights: ScoreWeights, novelty_scale):
    w_nov = (weights.novelty if novelty_scale is None
             else weights.novelty * novelty_scale)
    return (w_nov * novelty + weights.bug * bug
            - weights.delay_cost * delays.mean(-1))


def score_population(
    delays: torch.Tensor,  # [P, H]
    trace: TraceArrays,  # one trace [L]
    pairs: torch.Tensor,  # [K, 2]
    archive: torch.Tensor,  # [A, K]
    failure_feats: torch.Tensor,  # [F, K]
    weights: ScoreWeights = ScoreWeights(),
    faults: Optional[torch.Tensor] = None,
    coin: Optional[torch.Tensor] = None,
    novelty_scale=None,
    archive_n: Occupancy = None,
    failure_n: Occupancy = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fitness ``f32[P]`` and features ``f32[P, K]`` of a population
    against one trace. ``archive_n``/``failure_n`` mask rows past a ring's
    occupancy; the search passes ``None`` (unoccupied slots are neutral
    0.5 feature points, as in the reference)."""
    _require_delay_mode(weights, faults, coin)
    feats = _genome_features(delays, trace, pairs, weights.tau)
    nov_d2, bug_d2 = _min_sq_pair_best(feats, archive, failure_feats,
                                       archive_n, failure_n)
    return _fitness(delays, nov_d2, -bug_d2, weights, novelty_scale), feats


def score_population_multi(
    delays: torch.Tensor,  # [P, H]
    traces: TraceArrays,  # [T, L]
    pairs: torch.Tensor,  # [K, 2]
    archive: torch.Tensor,  # [A, K]
    failure_feats: torch.Tensor,  # [F, K]
    weights: ScoreWeights = ScoreWeights(),
    faults: Optional[torch.Tensor] = None,
    coin: Optional[torch.Tensor] = None,
    novelty_scale=None,
    archive_n: Occupancy = None,
    failure_n: Occupancy = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fitness aggregated over T recorded traces: novelty and bug
    distance are averaged over the traces. Returns ``(fitness f32[P],
    feats f32[P, T, K])``; the ``P*T`` feature rows go through one launch
    of the pair-distance kernel."""
    _require_delay_mode(weights, faults, coin)
    feats = _genome_features(delays, traces, pairs, weights.tau)
    P, T, K = feats.shape
    nov_d2, bug_d2 = _min_sq_pair_best(feats.reshape(P * T, K), archive,
                                       failure_feats, archive_n, failure_n)
    novelty = nov_d2.reshape(P, T).mean(1)
    bug = -bug_d2.reshape(P, T).mean(1)
    return _fitness(delays, novelty, bug, weights, novelty_scale), feats
