"""Benchmark of the port's search plane on one card: interleavings scored
per second, the counterpart of ``bench.py``'s two device paths.

Run from the repository root::

    python -m namazu_tpu_torch.bench                   # the scorer bench
    python -m namazu_tpu_torch.bench --fused           # the generation loop
    python -m namazu_tpu_torch.bench --fused --smoke   # tiny sizes, no history
    python -m namazu_tpu_torch.bench --device cpu      # the CPU, on request

Each prints ONE JSON line, with ``bench.py``'s keys, the ``platform``
(``cuda`` or ``cpu``) and the ``card`` (its name and power limit as
``nvidia-smi`` gives them; ``null`` on the CPU).

* The scorer bench (``bench.py::main``): :func:`score_chain` chains 50
  passes of ``ops/schedule.py::score_population`` over 8192 genomes
  against one 240-event trace (H = L = K = 256, archive 1024, 64
  failures), each pass perturbing the population by its own fitness as
  the reference's ``fori_loop`` does. Before timing, a 64-genome slice
  of the first pass's fitness on the device is held to the same slice
  scored on the CPU by the plain versions (rtol 1e-3 / atol 1e-4); a
  mismatch raises. One warm-up, then the best of 5 chains, each ending
  in a device sync. ``vs_baseline`` is its rate over the single-thread
  numpy scorer's (:func:`numpy_score`, 64 genomes, best of 5, the BLAS
  pool pinned to one thread by ``threadpoolctl`` where it is installed).
* The fused bench (``bench.py::fused_main``): ``parallel/islands.py``'s
  ``fused_step`` over 50 generations on one island against 50
  ``island_step`` calls, back to back with the garbage collector off, at
  the same sizes (``--smoke``: P 256, H 64, L 128, K 64, archive 64, 16
  failures, 8 generations, 2 repetitions). Both are Python loops with no
  sync inside, so ``vs_unfused`` near 1.0 is what the port measures, not
  a fault.

A completed round that is not ``--smoke`` appends one record to the
port's own history, ``BENCH_HISTORY_TORCH.jsonl`` at the repository root
(or ``--history``, or ``$NMZ_TORCH_BENCH_HISTORY``); ``--gate`` holds
it to the best of the last 20 records of the same platform and metric
and exits 1 on a drop past ``--gate-threshold`` percent, by the
reference's rule (:func:`gate_record`).

What stays in ``bench.py`` only: the ``--pipeline``, ``--campaign`` and
edge modes, pure control plane that touches no device; and what only a
TPU has: the device probe and the CPU re-exec, the r05 criterion and
the last-good chip figure. No figure of ``bench.py`` or of a
``BENCH_*.json`` is the card's: those are a TPU's. A missing card raises
``RuntimeError``; nothing falls back to the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import gc
import json
import os
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from namazu_tpu_torch.device import DeviceLike, resolve_device
from namazu_tpu_torch.entry import synthetic_trace
from namazu_tpu_torch.models.ga import GAConfig, Population, init_population
from namazu_tpu_torch.ops import trace_encoding as te
from namazu_tpu_torch.ops.schedule import (
    ScoreWeights,
    TraceArrays,
    score_population,
)
from namazu_tpu_torch.parallel.islands import (
    fused_step,
    init_island_state,
    island_step,
    one_island,
    ring_plan,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCORER_METRIC = "interleavings_scored_per_sec_per_chip"
# --gate: allowed percent drop below the best of the last
# GATE_BASELINE_WINDOW same-platform, same-metric records
GATE_DEFAULT_PCT = 30.0
GATE_BASELINE_WINDOW = 20
RTOL, ATOL = 1e-3, 1e-4  # the device's fitness against the CPU's
CHECK_GENOMES = 64  # genomes held to the CPU, and scored by numpy
BASELINE_REPS = 5
WEIGHTS = ScoreWeights()
GA = GAConfig(max_delay=0.1)
RINGS = (("i", 8),)  # the reference's ring; one island plans no migration
FUSED_SEED = 1  # the reference's PRNGKey(1) for the generations


class Sizes(NamedTuple):
    P: int  # genomes
    H: int  # hint buckets
    L: int  # trace length
    K: int  # precedence pairs
    A: int  # archive rows
    F: int  # failure rows
    iters: int  # scoring passes (scorer) or generations (fused) a figure
    reps: int  # timed figures; the best is reported


#: ``bench.py``'s production sizes, for both benches
PRODUCTION = Sizes(8192, 256, 256, 256, 1024, 64, 50, 5)
#: ``bench.py --fused --smoke``
SMOKE = Sizes(256, 64, 128, 64, 64, 16, 8, 2)


class Inputs(NamedTuple):
    trace: TraceArrays
    pairs: torch.Tensor  # i32[K, 2]
    archive: torch.Tensor  # f32[A, K]
    failures: torch.Tensor  # f32[F, K]
    pop: Population  # the scorer's genomes, f32[P, H] each half


def bench_inputs(P: int, H: int, L: int, K: int, A: int, F: int,
                 device: DeviceLike = "cuda") -> Inputs:
    """``bench.py``'s inputs on ``device``: ``min(240, L - 16)`` events
    ``hint:{i % 96}`` one a millisecond, ``sample_pairs(K, H, 0)``, the
    archive and failures from numpy's ``RandomState(0)`` and ``(1)``,
    and a population drawn with ``GAConfig(max_delay=0.1)`` from a
    generator on the device seeded 0."""
    dev = resolve_device(device)
    trace = synthetic_trace(min(240, L - 16), 96, L, H, dev)
    pairs = torch.from_numpy(te.sample_pairs(K, H, 0)).to(dev)
    archive = torch.from_numpy(
        np.random.RandomState(0).rand(A, K).astype(np.float32)).to(dev)
    failures = torch.from_numpy(
        np.random.RandomState(1).rand(F, K).astype(np.float32)).to(dev)
    pop = init_population(torch.Generator(device=dev).manual_seed(0), P, H,
                          GA)
    return Inputs(trace, pairs, archive, failures, pop)


def score_chain(delays: torch.Tensor, inputs: Inputs,
                passes: int) -> torch.Tensor:
    """``passes`` scoring passes, each perturbing the genomes by their own
    fitness (``d + 1e-9 * fit``, what GA mutation does), as the
    reference's ``fori_loop``; nothing here waits for the device."""
    d = delays
    for _ in range(passes):
        fit, _ = score_population(d, inputs.trace, inputs.pairs,
                                  inputs.archive, inputs.failures, WEIGHTS)
        d = d + 1e-9 * fit[:, None]
    return d


def numpy_score(delays, hint_ids, arrival, mask, pairs, archive, failures,
                tau=0.005):
    """The single-thread numpy scorer of one genome batch, ``bench.py``'s
    baseline (a copy of ``bench.py::numpy_score``)."""
    P, H = delays.shape
    BIG = 1e9
    t = arrival[None, :] + delays[:, hint_ids]  # [P, L]
    t = np.where(mask[None, :], t, BIG)
    first = np.full((P, H), BIG, np.float32)
    for p in range(P):  # scatter-min, the honest scalar way
        np.minimum.at(first[p], hint_ids, t[p])
    du = first[:, pairs[:, 0]]
    dv = first[:, pairs[:, 1]]
    z = np.clip((dv - du) / tau, -30, 30)
    feats = 1.0 / (1.0 + np.exp(-z))
    d2a = ((feats[:, None, :] - archive[None]) ** 2).sum(-1).min(1)
    d2f = ((feats[:, None, :] - failures[None]) ** 2).sum(-1).min(1)
    return d2a - d2f - 0.01 * delays.mean(-1)


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _device_keys(dev: torch.device) -> dict:
    return {"platform": dev.type,
            "card": card_line() if dev.type == "cuda" else None}


def check_against_cpu(inputs: Inputs, n: int = CHECK_GENOMES) -> float:
    """Score the population once on its device and hold the first ``n``
    genomes' fitness to the same genomes scored on the CPU by the plain
    versions; returns the max abs error, raises ``RuntimeError`` past
    rtol/atol."""
    fit, _ = score_population(inputs.pop.delays, inputs.trace, inputs.pairs,
                              inputs.archive, inputs.failures, WEIGHTS)
    got = fit[:n].cpu()
    tr = inputs.trace
    want, _ = score_population(
        inputs.pop.delays[:n].cpu(),
        TraceArrays(tr.hint_ids.cpu(), tr.arrival.cpu(), tr.mask.cpu()),
        inputs.pairs.cpu(), inputs.archive.cpu(), inputs.failures.cpu(),
        WEIGHTS)
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
        raise RuntimeError(
            f"the scorer on {fit.device} differs from the CPU's plain "
            f"versions by {err} (rtol {RTOL}, atol {ATOL})")
    return err


def _blas_pinned():
    """One BLAS thread for the numpy baseline; without ``threadpoolctl``
    the baseline runs unpinned (and noisier), as in the reference."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        print("# threadpoolctl is not installed: the numpy baseline's "
              "BLAS pool is not pinned to one thread", file=sys.stderr)
        return contextlib.nullcontext()
    return threadpool_limits(limits=1)


def numpy_baseline_rate(inputs: Inputs, n: int = CHECK_GENOMES) -> float:
    """Genomes a second of :func:`numpy_score` on ``n`` genomes, best of
    BASELINE_REPS after one warm call."""
    tr = inputs.trace
    args = tuple(x.cpu().numpy() for x in (
        inputs.pop.delays[:n], tr.hint_ids, tr.arrival, tr.mask,
        inputs.pairs, inputs.archive, inputs.failures))
    with _blas_pinned():
        numpy_score(*args)
        best = float("inf")
        for _ in range(BASELINE_REPS):
            t0 = time.perf_counter()
            numpy_score(*args)
            best = min(best, time.perf_counter() - t0)
    return n / best


def run_scorer_bench(device: DeviceLike = "cuda",
                     sizes: Sizes = PRODUCTION) -> dict:
    """The scorer bench: schedules scored a second by :func:`score_chain`
    (``iters`` passes a chain, best of ``reps`` after one warm-up), held
    first to the CPU on a slice, and its rate over the numpy baseline's.
    On the card: 1 + (reps + 1) * iters launches of B1."""
    dev = resolve_device(device)
    inputs = bench_inputs(*sizes[:6], dev)
    err = check_against_cpu(inputs)
    delays = inputs.pop.delays
    score_chain(delays, inputs, sizes.iters)
    _sync(dev)
    best = float("inf")
    for _ in range(sizes.reps):
        t0 = time.perf_counter()
        score_chain(delays, inputs, sizes.iters)
        _sync(dev)
        best = min(best, time.perf_counter() - t0)
    rate = sizes.P * sizes.iters / best
    return {
        "metric": SCORER_METRIC,
        "value": round(rate, 1),
        "unit": "schedules/s",
        "vs_baseline": round(rate / numpy_baseline_rate(inputs), 2),
        **_device_keys(dev),
        "check_max_abs_err": err,
    }


def run_fused_bench(device: DeviceLike = "cuda",
                    sizes: Sizes = PRODUCTION) -> dict:
    """The fused bench: schedules a second of ``fused_step`` over
    ``iters`` generations (best of ``reps`` after one warm-up) against
    ``iters`` ``island_step`` calls (best of ``reps`` after one warm
    step), on one island, with the garbage collector off. On the card:
    (reps + 1) * iters + 1 + reps * iters launches of B1."""
    dev = resolve_device(device)
    P, H = sizes.P, sizes.H
    inputs = bench_inputs(*sizes[:6], dev)
    args = (FUSED_SEED, inputs.trace, inputs.pairs, inputs.archive,
            inputs.failures, GA)
    mesh = one_island(dev)
    if ring_plan(mesh, RINGS, P, GA):
        raise RuntimeError(f"the ring {RINGS} plans a migration on one "
                           "island")
    kw = {"mesh": mesh, "rings": RINGS}
    gc.disable()
    try:
        state = init_island_state(0, P, H, GA, mesh=mesh)
        state, _ = fused_step(state, sizes.iters, *args, **kw)
        _sync(dev)
        best_fused = float("inf")
        for _ in range(sizes.reps):
            t0 = time.perf_counter()
            state, _ = fused_step(state, sizes.iters, *args, **kw)
            _sync(dev)
            best_fused = min(best_fused, time.perf_counter() - t0)

        warm, _ = island_step(init_island_state(0, P, H, GA, mesh=mesh),
                              *args, **kw)
        _sync(dev)
        best_unfused = float("inf")
        for _ in range(sizes.reps):
            s = warm
            t0 = time.perf_counter()
            for _ in range(sizes.iters):
                s, _ = island_step(s, *args, **kw)
            _sync(dev)
            best_unfused = min(best_unfused, time.perf_counter() - t0)
    finally:
        gc.enable()
    fused_rate = P * sizes.iters / best_fused
    unfused_rate = P * sizes.iters / best_unfused
    return {
        "metric": SCORER_METRIC,
        "value": round(fused_rate, 1),
        "unit": "schedules/s",
        "fused": True,
        "generations_per_dispatch": sizes.iters,
        "population": P,
        "unfused_schedules_per_sec": round(unfused_rate, 1),
        "vs_unfused": round(fused_rate / unfused_rate, 2),
        **_device_keys(dev),
        "scorer_source": "fused",
        "smoke": sizes == SMOKE,
    }


# -- history and the regression gate (copies of bench.py's) ----------------


def default_history_path() -> str:
    return os.environ.get("NMZ_TORCH_BENCH_HISTORY") or os.path.join(
        ROOT, "BENCH_HISTORY_TORCH.jsonl")


def load_history(path: str) -> list:
    """All parseable history records, oldest first (bad lines skipped:
    an interrupted append must not brick every later gate)."""
    records = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict):
                    records.append(rec)
    except OSError:
        pass
    return records


def append_history(record: dict, path: str) -> None:
    with open(path, "a") as f:
        f.write(json.dumps(record, sort_keys=True) + "\n")


def _record_metric(rec: dict) -> str:
    return rec.get("metric") or SCORER_METRIC


def _record_value(rec: dict):
    """The gated figure of a record: ``value``, else the scorer records'
    ``schedules_per_sec``."""
    v = rec.get("value")
    if v is None:
        v = rec.get("schedules_per_sec")
    try:
        return float(v) if v is not None else None
    except (TypeError, ValueError):
        return None


#: records that differ in one of these never baseline each other
#: (``bench.py``'s list: a fused figure never gates an unfused one, nor
#: one pipeline configuration another)
CONFIG_KEYS = ("n_events", "n_entities", "batch_max", "flush_window",
               "poll_linger", "gc_disabled", "telemetry", "codec",
               "edge_shards", "edge_events", "runs", "fused", "profile",
               "virtual_clock", "delay_scale")


def gate_record(current: dict, history: list,
                threshold_pct: float = GATE_DEFAULT_PCT,
                window: int = GATE_BASELINE_WINDOW):
    """``(ok, reasons, baseline)``: ``current`` against the best of the
    last ``window`` history records of its platform, metric, transport
    mode and configuration. A regression is the figure (or, where both
    records carry one, ``coverage``) more than ``threshold_pct`` percent
    below that best; with no such record the gate passes."""
    metric = _record_metric(current)

    def _mode(rec):
        return rec.get("transport_mode") or rec.get("mode")

    same = [h for h in history
            if h.get("platform") == current.get("platform")
            and _record_metric(h) == metric
            and _mode(h) == _mode(current)
            and all(h.get(k) == current.get(k) for k in CONFIG_KEYS)
            and _record_value(h)][-window:]
    reasons = []
    baseline = {}
    if not same:
        return True, [f"no {current.get('platform')!r} history to gate "
                      "against; pass"], baseline
    frac = threshold_pct / 100.0
    label = "schedules/s" if metric == SCORER_METRIC else metric
    key = "schedules_per_sec" if metric == SCORER_METRIC else "value"
    base_rate = max(_record_value(h) for h in same)
    baseline[key] = base_rate
    cur_rate = _record_value(current) or 0.0
    if cur_rate < base_rate * (1.0 - frac):
        reasons.append(
            f"{label} regression: {cur_rate:.1f} is "
            f"{100.0 * (1.0 - cur_rate / base_rate):.1f}% below the "
            f"recent best {base_rate:.1f} (threshold {threshold_pct:g}%)")
    covs = [float(h["coverage"]) for h in same
            if h.get("coverage") is not None]
    if covs and current.get("coverage") is not None:
        base_cov = max(covs)
        baseline["coverage"] = base_cov
        cur_cov = float(current["coverage"])
        if cur_cov < base_cov * (1.0 - frac):
            reasons.append(
                f"coverage regression: {cur_cov:.4f} is "
                f"{100.0 * (1.0 - cur_cov / base_cov):.1f}% below the "
                f"recent best {base_cov:.4f} "
                f"(threshold {threshold_pct:g}%)")
    return (not reasons), reasons, baseline


def _code_revision() -> str:
    """Short git revision of the checkout ("" outside a git checkout)."""
    try:
        out = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                             cwd=ROOT, timeout=10, capture_output=True,
                             text=True)
        return out.stdout.strip() if out.returncode == 0 else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def history_record(out: dict) -> dict:
    """The history record of a bench's JSON line."""
    record = {
        "timestamp": datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="seconds"),
        "revision": _code_revision(),
        "metric": out["metric"],
        "schedules_per_sec": out["value"],
        "unit": out["unit"],
        "platform": out["platform"],
        "card": out["card"],
    }
    for k in ("fused", "vs_unfused", "vs_baseline", "coverage"):
        if k in out:
            record[k] = out[k]
    return record


def publish(out: dict, history: str, gate: bool = False,
            threshold_pct: float = GATE_DEFAULT_PCT) -> int:
    """Append ``out``'s record to ``history`` (nothing for a smoke run),
    gate it against the records before it when asked, print the JSON
    line; returns the exit code (1: the gate failed)."""
    if out.get("smoke"):
        print(json.dumps(out))
        return 0
    prior = load_history(history)
    record = history_record(out)
    try:
        append_history(record, history)
    except OSError as e:  # the JSON line must still come out
        print(f"# could not append bench history: {e}", file=sys.stderr)
    if not gate:
        print(json.dumps(out))
        return 0
    ok, reasons, baseline = gate_record(record, prior,
                                        threshold_pct=threshold_pct)
    out["gate"] = {"ok": ok, "threshold_pct": threshold_pct,
                   "baseline": baseline, "reasons": reasons}
    print(json.dumps(out))
    if ok:
        return 0
    for reason in reasons:
        print(f"# GATE FAILED: {reason}", file=sys.stderr)
    return 1


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m namazu_tpu_torch.bench",
        description="the port's scorer benchmark on one card (one JSON "
                    "line)")
    ap.add_argument("--fused", action="store_true",
                    help="time the generation loop (fused_step) against "
                         "per-generation island_step calls")
    ap.add_argument("--smoke", action="store_true",
                    help="with --fused: tiny sizes, no history append")
    ap.add_argument("--gate", action="store_true",
                    help="exit 1 when the figure falls more than "
                         "--gate-threshold percent below the recent best "
                         "of the same platform in the history")
    ap.add_argument("--gate-threshold", type=float,
                    default=GATE_DEFAULT_PCT, metavar="PCT",
                    help=f"allowed percent drop (default "
                         f"{GATE_DEFAULT_PCT:g})")
    ap.add_argument("--history", default=None,
                    help="bench-history JSONL path (default "
                         "BENCH_HISTORY_TORCH.jsonl at the repository "
                         "root; env NMZ_TORCH_BENCH_HISTORY)")
    ap.add_argument("--coverage", type=float, default=None,
                    help="an exploration-coverage figure folded into the "
                         "scorer's record and gated beside it")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    if args.fused:
        out = run_fused_bench(dev, SMOKE if args.smoke else PRODUCTION)
    else:
        out = run_scorer_bench(dev, PRODUCTION)
        if args.coverage is not None:
            out["coverage"] = args.coverage
    return publish(out, args.history or default_history_path(), args.gate,
                   args.gate_threshold)


if __name__ == "__main__":
    sys.exit(main())
