#!/usr/bin/env python3
"""On-card smoke test of namazu_tpu_torch, the PyTorch/CUDA port of the
search plane. Needs one CUDA card (an H100 for the sm_90a kernels) and
nvcc; run from the repository root:

    python3 chip_smoke.py

Phases, each of which fails the script on any error:

1. card: the card's name and power limit, torch and CUDA versions, and
   the build of every kernel under namazu_tpu_torch/csrc/ (nvcc output
   with ptxas's register report included);
2. kernels: each kernel against its plain PyTorch version on the card at
   the main path's shape and at ragged shapes and occupancies, with its
   time, the plain version's time, a library call's time and the bound;
3. main path: ScheduleSearch on the card at the tpu_search policy's
   production sizes (population 4096, H = K = 256, archive 512,
   failures 64, chunks of 16 generations) against 4 reference traces of
   2000 events, run twice for 64 generations; the pair-distance kernel
   must launch once per generation, and the best table re-scored on the
   CPU by the plain versions must give the reported fitness;
4. where a generation's time goes: each layer timed alone, and one chunk
   of generations traced by torch.profiler for the device's busy share.

The last lines are the card line, a JSON line with every kernel's
numbers, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

RTOL, ATOL = 1e-3, 1e-4
# published H100 SXM peaks: HBM bandwidth and non-tensor f32 rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
MAIN_SHAPE = (16384, 512, 64, 256)  # N = P*T, A, F, K on the main path
POPULATION, H, K, TRACES, EVENTS, GENERATIONS = 4096, 256, 256, 4, 2000, 64


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


# -- phase 2: kernels against their plain versions --------------------------


def pair_inputs(N, A, F, K, seed, device):
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.rand((n, K), generator=g, device=device)
                 for n in (N, A, F))


def pair_bound_ms(N, A, F, K):
    nbytes = 4 * (N * K + (A + F) * K + 2 * N)
    flops = 2 * N * (A + F) * K
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def check_pair_kernel(device) -> dict:
    import torch

    from namazu_tpu_torch.ops import pair_distance as pd

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cases = [
        (MAIN_SHAPE, None, None),
        (MAIN_SHAPE, 300, 0),
        (MAIN_SHAPE, 0, 17),
        ((33, 7, 5, 64), None, None),
        ((33, 7, 5, 64), 3, 0),
        ((300, 100, 7, 128), 100, 7),
        ((300, 100, 7, 128), 50, 1),
    ]
    max_err = 0.0
    for i, ((N, A, F, Kc), an, fn) in enumerate(cases):
        feats, archive, failures = pair_inputs(N, A, F, Kc, 100 + i, device)
        got = pd.min_sq_distance_pair(feats, archive, failures,
                                      archive_n=an, failure_n=fn)
        want = pd.min_sq_distance_pair_reference(feats, archive, failures,
                                                 archive_n=an, failure_n=fn)
        torch.cuda.synchronize()
        for g, w, name in zip(got, want, ("nov", "bug")):
            check(g.shape == (N,) and bool(torch.isfinite(g).all()),
                  f"pair kernel {name} at {(N, A, F, Kc)}: bad output")
            live = w < 1e30  # rows whose min is masked stay at 3.4e38
            check(bool(torch.equal(live, g < 1e30)),
                  f"pair kernel {name} at {(N, A, F, Kc)} occ {(an, fn)}: "
                  "masked rows differ")
            ok = torch.allclose(g[live], w[live], rtol=RTOL, atol=ATOL)
            err = float((g[live] - w[live]).abs().max()) if live.any() \
                else 0.0
            max_err = max(max_err, err)
            check(ok, f"pair kernel {name} at {(N, A, F, Kc)} occ "
                      f"{(an, fn)}: max abs err {err}")
        print(f"  pair kernel {(N, A, F, Kc)} occ {(an, fn)}: within "
              f"rtol {RTOL} atol {ATOL} of the plain version")

    N, A, F, Kc = MAIN_SHAPE
    feats, archive, failures = pair_inputs(N, A, F, Kc, 7, device)
    kernel_ms = cuda_time_ms(
        lambda: pd.min_sq_distance_pair(feats, archive, failures))
    plain_ms = cuda_time_ms(
        lambda: pd.min_sq_distance_pair_reference(feats, archive, failures))
    library_ms = cuda_time_ms(lambda: (
        torch.cdist(feats, archive).square().amin(1),
        torch.cdist(feats, failures).square().amin(1)))
    bound_ms, bound_by = pair_bound_ms(N, A, F, Kc)
    torch.cuda.synchronize()
    print(f"  pair kernel at {MAIN_SHAPE}: kernel_ms {kernel_ms:.5f} "
          f"plain_ms {plain_ms:.5f} library_ms {library_ms:.5f} "
          f"bound_us {bound_ms * 1e3:.3f} ({bound_by}) "
          f"max_abs_err {max_err:.3e}")
    return {
        "name": "min_sq_pair",
        "route": "cuda",
        "source": "namazu_tpu_torch/csrc/min_sq_pair.cu",
        "replaces": "namazu_tpu/ops/pallas_score.py:157",
        "launches": None,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }


# -- phase 3: the main path -------------------------------------------------


def synthetic_stream(rng, n_events: int, n_flows: int = 150,
                     jitter: float = 0.0):
    """A seeded stream of packet-like events over ``n_flows`` flows of a
    13-node cluster, Zipf-skewed, with ~1 ms inter-arrivals; ``jitter``
    adds per-event release noise (an executed run's realized view)."""
    nodes = 13
    flows = [(s, d) for s in range(nodes) for d in range(nodes)
             if s != d][:n_flows]
    weights = 1.0 / (1.0 + rng.permutation(len(flows)))
    weights /= weights.sum()
    idx = rng.choice(len(flows), size=n_events, p=weights)
    kinds = rng.randint(0, 4, size=n_events)
    hints = [f"10.0.0.{flows[i][0]}->10.0.0.{flows[i][1]}:msg{k}"
             for i, k in zip(idx, kinds)]
    arrivals = rng.exponential(1e-3, size=n_events).cumsum()
    if jitter:
        arrivals = arrivals + rng.rand(n_events) * jitter
    return hints, arrivals.tolist()


def build_search(device, population=POPULATION, events=EVENTS,
                 n_traces=TRACES, n_executed=100, n_failures=3, seed=0,
                 H=H, K=K):
    import numpy as np

    from namazu_tpu_torch.models.search import ScheduleSearch, SearchConfig
    from namazu_tpu_torch.ops import trace_encoding as te

    cfg = SearchConfig(H=H, K=K, population=population, archive_size=512,
                       failure_size=64, fused_chunk=16, seed=seed)
    search = ScheduleSearch(cfg, device=device)
    rng = np.random.RandomState(seed)

    def enc(jitter=0.0):
        hints, arr = synthetic_stream(rng, events, jitter=jitter)
        return te.encode_event_stream(hints, arr, H=H)

    refs = [enc() for _ in range(n_traces)]
    for i in range(n_executed):
        search.add_executed_trace(enc(jitter=0.02), reproduced=i % 25 == 0)
    for _ in range(n_failures):
        search.add_failure_trace(enc(jitter=0.05))
    return search, refs


def rescore_on_cpu(search, refs, delays):
    import numpy as np
    import torch

    from namazu_tpu_torch.ops import schedule as sched
    from namazu_tpu_torch.ops import trace_encoding as te

    h, _, a, m, _ = te.stack_traces(refs)
    traces = sched.TraceArrays(torch.from_numpy(h).long(),
                               torch.from_numpy(a), torch.from_numpy(m))
    fit, _ = sched.score_population_multi(
        torch.from_numpy(np.asarray(delays)[None]), traces,
        torch.from_numpy(search.pairs), torch.from_numpy(search.archive),
        torch.from_numpy(search.failures), search.cfg.weights,
        novelty_scale=search.novelty_scale())
    return float(fit[0])


def drive_main_path(device, generations=GENERATIONS, **sizes):
    """Two ``run()`` calls of the search; returns the kernel launches they
    made, the search and its reference traces."""
    from namazu_tpu_torch.ops import pair_distance as pd

    t0 = time.perf_counter()
    search, refs = build_search(device, **sizes)
    setup_s = time.perf_counter() - t0
    L = refs[0].hint_ids.shape[0]
    print(f"  setup {setup_s:.2f} s: {len(refs)} reference traces of "
          f"L={L}, archive {search._archive_n}, failures "
          f"{search._failure_n}")
    if device != "cpu":
        import torch

        torch.cuda.synchronize()
    pd.LAUNCHES = 0  # count only the main path's launches
    bests = []
    for r in range(2):
        best = search.run(refs, generations=generations)
        secs = search.last_run_seconds
        bests.append(best)
        print(f"  run {r}: best fitness {best.fitness:.6f}, {secs:.4f} s, "
              f"{generations / secs:.2f} generations/s, "
              f"{search.population * generations / secs:.1f} schedules/s")
        check(len(search.last_fit_curve) == generations,
              "fitness history has the wrong length")
    launches = pd.LAUNCHES
    b0, b1 = bests
    if device != "cpu":
        check(launches == 2 * generations,
              f"pair kernel launched {launches} times on the main path, "
              f"expected {2 * generations}")
    check(math.isfinite(b0.fitness) and math.isfinite(b1.fitness),
          "best fitness is not finite")
    check(b1.fitness >= b0.fitness, "best fitness fell between runs")
    check(b1.delays.shape == (search.cfg.H,), "best table has wrong shape")
    rescored = rescore_on_cpu(search, refs, b1.delays)
    check(math.isclose(rescored, b1.fitness, rel_tol=RTOL, abs_tol=ATOL),
          f"re-scored fitness {rescored} != reported {b1.fitness}")
    print(f"  best table re-scored on the CPU: {rescored:.6f} "
          f"(reported {b1.fitness:.6f})")
    return launches, search, refs


def profile_generation(search, refs) -> dict:
    """Where a generation's time goes at the main path's sizes: each
    layer timed alone by CUDA events, and one 16-generation chunk traced
    by torch.profiler for the device's busy share."""
    import torch

    from namazu_tpu_torch.models.ga import ga_generation
    from namazu_tpu_torch.ops import schedule as sched
    from namazu_tpu_torch.ops.pair_distance import min_sq_distance_pair
    from namazu_tpu_torch.parallel.islands import fused_step, generator_for

    traces, pairs, archive, failures = search._device_inputs(refs)
    cfg, st = search.cfg, search._state
    feats = sched._genome_features(st.pop.delays, traces, pairs,
                                   cfg.weights.tau)
    flat = feats.reshape(-1, feats.shape[-1])
    fitness, _ = sched.score_population_multi(
        st.pop.delays, traces, pairs, archive, failures, cfg.weights)
    gen = generator_for(search._seed, st.gen, search.device)
    out = {
        "feature_step_ms": cuda_time_ms(lambda: sched._genome_features(
            st.pop.delays, traces, pairs, cfg.weights.tau), iters=20),
        "pair_kernel_ms": cuda_time_ms(
            lambda: min_sq_distance_pair(flat, archive, failures), iters=20),
        "ga_ms": cuda_time_ms(lambda: ga_generation(
            gen, st.pop, fitness, cfg.ga), iters=20),
    }
    chunk = cfg.fused_chunk
    step = (lambda: fused_step(search._state, chunk, search._seed, traces,
                               pairs, archive, failures, cfg.ga,
                               cfg.weights))
    step()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    out["generation_wall_ms"] = wall_ms / chunk
    out["generation_device_ms"] = busy_ms / chunk
    out["device_busy_share"] = busy_ms / wall_ms if busy_ms else None
    out["launches_per_generation"] = sum(e.count for e in kernels) / chunk
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    out["top_kernels_ms_per_generation"] = {
        e.key[:80]: e.self_device_time_total / 1e3 / chunk for e in top}
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from namazu_tpu_torch.ops import _build

    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}, device "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    built = _build.build()
    print(f"built kernels {sorted(built)} in "
          f"{time.perf_counter() - t0:.2f} s")
    for name in sorted(built):
        log = _build.build_log(name).strip()
        if log:
            print(f"  nvcc {name}: {log}")

    print("phase: kernels against their plain versions")
    pair = check_pair_kernel("cuda")

    print("phase: main path")
    pair["launches"], search, refs = drive_main_path("cuda")
    torch.cuda.synchronize()

    print("phase: where a generation's time goes")
    breakdown = profile_generation(search, refs)
    print(json.dumps({"breakdown": breakdown}))
    torch.cuda.synchronize()

    print(card)
    print(json.dumps({"kernels": [pair]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
